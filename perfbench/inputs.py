"""The inputs of one model, made from a configuration file and a seed.

A configuration (``perfbench/configs/<name>.json``) states a confined
flow model on a DIS grid: its sizes, properties, boundaries, time
discretisation and solver closures.  Everything here is made once per run
and handed alike to the program and to the plain reference: the random
hydraulic conductivity field is drawn from the seed (a traffic file's
ensemble member) with a ``torch.Generator`` on the run's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# bytes of one value in the precision a configuration states
ELEMENT_SIZE = {"float64": 8, "float32": 4}


@dataclasses.dataclass
class FlowInputs:
    shape: tuple
    delr: np.ndarray
    delc: np.ndarray
    top_surface: float
    botm: np.ndarray          # (nlay,) layer bottoms
    top: np.ndarray           # per cell
    bot: np.ndarray
    k: torch.Tensor           # per cell, on the run's device (K33 = K)
    ss: float
    sy: float
    strt: float
    chd_node: np.ndarray
    chd_head: np.ndarray
    wel_node: np.ndarray
    wel_q: np.ndarray
    wel_from_period: int
    schedule: list            # [(kper, kstp, delt, steady)], 1-based

    @property
    def nodes(self) -> int:
        return int(np.prod(self.shape))


def schedule(tdis, steady):
    """The steps of ``tdis`` (rows of perlen, nstp, tsmult), as MODFLOW 6's
    TDIS makes them: the first step of a period is perlen (tsmult - 1) /
    (tsmult**nstp - 1), and each next one tsmult times the last."""
    out = []
    for kper, ((perlen, nstp, tsmult), iss) in enumerate(
            zip(tdis, steady), start=1):
        nstp = int(nstp)
        if tsmult == 1.0:
            dts = [perlen / nstp] * nstp
        else:
            dt0 = perlen * (tsmult - 1.0) / (tsmult ** nstp - 1.0)
            dts = [dt0 * tsmult ** i for i in range(nstp)]
        out += [(kper, kstp, float(dt), bool(iss))
                for kstp, dt in enumerate(dts, start=1)]
    return out


def flow_inputs(cfg, seed, device) -> FlowInputs:
    shape = (cfg["nlay"], cfg["nrow"], cfg["ncol"])
    nlay, nrow, ncol = shape
    ncpl = nrow * ncol
    if cfg.get("icelltype", 0) != 0:
        raise ValueError("only confined cells (icelltype 0) are supported")
    botm = np.atleast_1d(np.asarray(cfg["botm"], dtype=np.float64))
    if botm.size != nlay:
        raise ValueError("botm needs one bottom per layer")
    tops = np.concatenate([[cfg["top"]], botm[:-1]])
    kspec = cfg["k"]
    if kspec["distribution"] != "lognormal":
        raise ValueError("only a lognormal K is supported")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    k = torch.exp(kspec["mean"] + kspec["sigma"] * torch.randn(
        nlay * ncpl, generator=gen, dtype=torch.float64, device=device))
    chd = cfg["chd"]
    rows = np.arange(nrow)
    lay = (chd["layer"] - 1) * ncpl
    chd_node = np.concatenate([lay + rows * ncol,
                               lay + rows * ncol + ncol - 1])
    chd_head = np.concatenate([np.full(nrow, chd["west"]),
                               np.full(nrow, chd["east"])], dtype=np.float64)
    wel = cfg["wel"]
    wel_node = np.array([(wel["layer"] - 1) * ncpl + wel["row"] * ncol
                         + wel["col"]])
    return FlowInputs(
        shape=shape, delr=np.full(ncol, cfg["length"] / ncol),
        delc=np.full(nrow, cfg["length"] / nrow),
        top_surface=float(cfg["top"]), botm=botm,
        top=np.repeat(tops, ncpl).astype(np.float64),
        bot=np.repeat(botm, ncpl).astype(np.float64), k=k,
        ss=float(cfg["ss"]), sy=float(cfg.get("sy", 0.0)),
        strt=float(cfg["strt"]), chd_node=chd_node, chd_head=chd_head,
        wel_node=wel_node, wel_q=np.array([float(wel["q"])]),
        wel_from_period=int(wel.get("from_period", 1)),
        schedule=schedule(cfg["tdis"], cfg["steady"]))
