"""Building a GWE model from Python, and the coupled GWF→GWE step.

Port of modflow6_tpu/models/gwe/builder.py (``build_gwe``, ``make_cnd``,
``CoupledGwfGwe``).  ``device=None`` is the CUDA device; pass ``"cpu"``
to build on the CPU.  A nonzero latent heat of vaporization raises: the
reference stores it and never uses it (ROADMAP Queue C).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import resolve_device
from ..discretization import DisGrid
from ..gwf import npf as npf_mod
from ..gwt.builder import SCHEMES, CoupledGwfGwt, _entries, _full
from ..gwt.model import CncData, SrcData
from . import cnd as cnd_mod
from . import est as est_mod
from .model import GweModel


def build_gwe(
    name,
    grid,
    *,
    porosity=0.3,
    strt=0.0,                    # initial temperature
    scheme="upstream",           # upstream | central | tvd
    rhow=1000.0,                 # water density
    cpw=4184.0,                  # water heat capacity
    rhos=2650.0,                 # solid density
    cps=800.0,                   # solid heat capacity
    latheatvap=0.0,
    decay=None,                  # (idcysrc, rate_water, rate_solid) or None
    cnd=None,                    # dict(alh=, ath1=, ktw=, kts=, ...)
    ctp=None,                    # [(node, temperature)]
    esl=None,                    # [(node, energy rate)]
    ssm_spec=None,               # GWF package name → source temperature
    device=None,
) -> GweModel:
    if latheatvap:
        raise NotImplementedError(
            "a nonzero LATENT_HEAT_VAPORIZATION (the reference stores it "
            "and never uses it)")
    device = resolve_device(device)
    # a DIS grid's edge list with its fixed slots, without the grid shape:
    # the transport multiplies through the ELL gather
    topo = (grid.build_edge_topology() if isinstance(grid, DisGrid)
            else grid.build_topology())
    dtopo = dataclasses.replace(npf_mod.DeviceTopology.from_host(topo, device),
                                grid_shape=None)
    N = grid.nodes

    idcy, idcysrc = est_mod.DECAY_OFF, 0
    dw = ds = _full(0.0, N, device)
    if decay is not None:
        idcy = est_mod.DECAY_ZERO_ORDER
        idcysrc, rate_w, rate_s = decay
        dw = _full(rate_w, N, device)
        ds = _full(rate_s, N, device)

    def f64(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    model = GweModel(
        name=name, grid=grid, topo=topo, dtopo=dtopo,
        strt=_full(strt, N, device),
        ibound0=torch.as_tensor(
            (grid.idomain.reshape(-1) > 0).astype(np.int32), device=device),
        est_opts=est_mod.EstOptions(idcy=idcy, idcysrc=int(idcysrc),
                                    rhow=float(rhow), cpw=float(cpw),
                                    latheatvap=float(latheatvap)),
        est_arrays=est_mod.EstArrays(
            porosity=_full(porosity, N, device), cps=_full(cps, N, device),
            rhos=_full(rhos, N, device), decay_water=dw, decay_solid=ds),
        iadvwt=SCHEMES[scheme],
        ctp=_entries(ctp, CncData, device),
        esl=_entries(esl, SrcData, device),
        ssm_spec=ssm_spec,
        top=f64(grid.top), bot=f64(grid.bot), area=f64(grid.area))
    if cnd is not None:
        model.cnd = make_cnd(N, cnd, device=device)
    return model


def make_cnd(N, cnd: dict, device=None) -> cnd_mod.CndData:
    """CND griddata with the reference's defaults (gwe-cnd.f90 read_data:
    alv ← alh, ath2 ← ath1, atv ← 0)."""
    device = resolve_device(device)
    idisp = int(any(k in cnd for k in ("alh", "alv", "ath1", "ath2", "atv")))
    alh = _full(cnd.get("alh", 0.0), N, device)
    ath1 = _full(cnd.get("ath1", 0.0), N, device)
    return cnd_mod.CndData(
        alh=alh,
        alv=_full(cnd["alv"], N, device) if "alv" in cnd else alh,
        ath1=ath1,
        ath2=_full(cnd["ath2"], N, device) if "ath2" in cnd else ath1,
        atv=_full(cnd.get("atv", 0.0), N, device),
        ktw=_full(cnd.get("ktw", 0.0), N, device),
        kts=_full(cnd.get("kts", 0.0), N, device),
        idisp=idisp, iktw=int("ktw" in cnd), ikts=int("kts" in cnd))


class CoupledGwfGwe(CoupledGwfGwt):
    """Sequential flow→energy stepping: CoupledGwfGwt's orchestration (a
    GweModel has the transport model's interface; reference exg-gwfgwe)."""

    def __init__(self, gwf_model, gwe_model, gwf_settings=None,
                 gwe_settings=None):
        super().__init__(gwf_model, gwe_model, gwf_settings, gwe_settings)
