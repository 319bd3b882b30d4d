"""The inputs of a variable-density cross-section, made from a
configuration file and one case of its inflow.

A section configuration (``perfbench/configs/gwt-henry-*.json``) states a
vertical DIS section one row wide: its extent, the layers and columns it is
cut into, K, porosity, molecular diffusion, BUY's linear equation of
state, a fresh inflow spread evenly over the layers of the first column
(WEL with an SSM concentration), the sea as constant heads on the last
column (CHD with an SSM concentration), the starting head and
concentration, TDIS and the closures.  A grid with ``nrow`` > 1 is that
many copies of the section side by side, each ``width`` wide and each with
the whole inflow.  Everything here is made once per run on the host and
handed alike to the program and to the plain reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .inputs import schedule as tdis_schedule


@dataclasses.dataclass
class SectionInputs:
    case: str
    shape: tuple
    delr: np.ndarray          # (ncol,) column widths
    delc: np.ndarray          # (nrow,) row widths
    top_surface: float
    botm: np.ndarray          # (nlay,) layer bottoms
    top: np.ndarray           # per cell
    bot: np.ndarray
    k: float                  # isotropic, confined
    strt: float               # starting head
    conc_strt: float          # starting concentration
    porosity: float
    diffc: float              # molecular diffusion coefficient
    buy: dict                 # denseref, drhodc, crhoref, iform
    chd_node: np.ndarray
    chd_head: np.ndarray
    chd_conc: float           # SSM concentration of CHD inflow
    wel_node: np.ndarray
    wel_q: np.ndarray         # into the aquifer
    wel_conc: float           # SSM concentration of the inflow
    schedule: list            # [(kper, kstp, delt, steady)], 1-based

    @property
    def nodes(self) -> int:
        return int(np.prod(self.shape))


def layer_bottoms(cfg):
    """The layers' bottoms: a list as it is, or the section's bottom (a
    scalar) cut into ``nlay`` layers of equal thickness."""
    nlay = int(cfg["nlay"])
    botm = np.asarray(cfg["botm"], dtype=np.float64)
    if botm.ndim == 0:
        dz = (float(cfg["top"]) - float(botm)) / nlay
        botm = float(cfg["top"]) - dz * np.arange(1, nlay + 1)
    tops = np.concatenate([[cfg["top"]], botm[:-1]])
    if botm.size != nlay or not np.all(tops > botm):
        raise ValueError("the layers need nlay bottoms, each below its top")
    return botm


def section_inputs(cfg, case) -> SectionInputs:
    shape = (int(cfg["nlay"]), int(cfg["nrow"]), int(cfg["ncol"]))
    nlay, nrow, ncol = shape
    ncpl = nrow * ncol
    if cfg.get("icelltype", 0) != 0:
        raise ValueError("only confined cells (icelltype 0) are supported")
    if cfg.get("advection", "upstream") != "upstream":
        raise ValueError("only upstream advection is supported")
    botm = layer_bottoms(cfg)
    tops = np.concatenate([[cfg["top"]], botm[:-1]])
    lay = np.arange(nlay)[:, None] * ncpl
    rows = np.arange(nrow)[None, :] * ncol
    first = (lay + rows).reshape(-1)
    wel, chd = cfg["wel"], cfg["chd"]
    return SectionInputs(
        case=str(case), shape=shape,
        delr=np.full(ncol, float(cfg["length"]) / ncol),
        delc=np.full(nrow, float(cfg["width"])),
        top_surface=float(cfg["top"]), botm=botm,
        top=np.repeat(tops, ncpl).astype(np.float64),
        bot=np.repeat(botm, ncpl).astype(np.float64),
        k=float(cfg["k"]), strt=float(cfg["strt"]),
        conc_strt=float(cfg["conc_strt"]), porosity=float(cfg["porosity"]),
        diffc=float(cfg["diffc"]), buy=dict(cfg["buy"]),
        chd_node=first + ncol - 1,
        chd_head=np.full(first.size, float(chd["head"])),
        chd_conc=float(chd["conc"]),
        wel_node=first,
        wel_q=np.full(first.size, float(wel["inflow"][case]) / nlay),
        wel_conc=float(wel["conc"]),
        schedule=tdis_schedule(cfg["tdis"], cfg["steady"]))
