"""Building a GWT model from Python, and the coupled GWF→GWT step.

Port of modflow6_tpu/models/gwt/builder.py (``build_gwt``, ``make_dsp``,
``CoupledGwfGwt``).  ``device=None`` is the CUDA device; pass ``"cpu"`` to
build on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import resolve_device
from ...solution.ims import ImsSettings, NumericalSolution
from ..discretization import DisGrid
from ..gwf import builder as gwf_builder
from ..gwf import npf as npf_mod
from . import adv as adv_mod
from . import dsp as dsp_mod
from . import mst as mst_mod
from .fmi import from_gwf_step
from .ist import make_ist
from .model import CncData, GwtModel, SrcData

SCHEMES = {"upstream": adv_mod.UPSTREAM, "central": adv_mod.CENTRAL,
           "tvd": adv_mod.TVD}


def _full(val, n, device):
    return gwf_builder._full(val, n, torch.float64, device)


def _entries(entries, cls, device):
    """[(node, value)] → a CncData or SrcData on ``device`` (None when
    there are none)."""
    if entries is None or len(entries) == 0:
        return None
    arr = np.asarray(entries, np.float64).reshape(-1, 2)
    return cls(torch.as_tensor(arr[:, 0].astype(np.int64), device=device),
               torch.as_tensor(arr[:, 1], device=device),
               torch.ones(arr.shape[0], dtype=torch.bool, device=device))


def build_gwt(
    name,
    grid,
    *,
    porosity=0.3,
    strt=0.0,
    scheme="upstream",           # upstream | central | tvd
    decay=None,                  # (idcy, rate) or None
    sorption=None,               # dict(isrb=..., bulk_density, distcoef, sp2)
    cnc=None,                    # [(node, conc)]
    src=None,                    # [(node, mass rate)]
    ssm_spec=None,               # GWF package name → source concentration
    dsp=None,                    # dict(alh=..., ath1=..., diffc=...)
    ist=None,                    # dict(thetaim, zetaim, ...) immobile domain
    eqnsclfac=1.0,
    device=None,
) -> GwtModel:
    device = resolve_device(device)
    # a DIS grid's edge list with its fixed slots, without the grid shape:
    # the transport multiplies through the ELL gather
    topo = (grid.build_edge_topology() if isinstance(grid, DisGrid)
            else grid.build_topology())
    dtopo = dataclasses.replace(npf_mod.DeviceTopology.from_host(topo, device),
                                grid_shape=None)
    N = grid.nodes

    idcy, decay_arr = 0, _full(0.0, N, device)
    if decay is not None:
        idcy, rate = decay
        decay_arr = _full(rate, N, device)
    isrb = 0
    bd = kd = sp2 = _full(0.0, N, device)
    if sorption is not None:
        isrb = int(sorption.get("isrb", mst_mod.SORPTION_LINEAR))
        bd = _full(sorption.get("bulk_density", 0.0), N, device)
        kd = _full(sorption.get("distcoef", 0.0), N, device)
        sp2 = _full(sorption.get("sp2", 0.0), N, device)

    model = GwtModel(
        name=name, grid=grid, topo=topo, dtopo=dtopo,
        strt=_full(strt, N, device),
        ibound0=torch.as_tensor(
            (grid.idomain.reshape(-1) > 0).astype(np.int32), device=device),
        mst_opts=mst_mod.MstOptions(idcy=int(idcy), isrb=isrb),
        mst_arrays=mst_mod.MstArrays(
            porosity=_full(porosity, N, device), decay=decay_arr,
            decay_sorbed=decay_arr, bulk_density=bd, distcoef=kd, sp2=sp2),
        iadvwt=SCHEMES[scheme], eqnsclfac=eqnsclfac,
        cnc=_entries(cnc, CncData, device),
        src=_entries(src, SrcData, device),
        ssm_spec=ssm_spec,
        top=torch.as_tensor(np.asarray(grid.top, np.float64), device=device),
        bot=torch.as_tensor(np.asarray(grid.bot, np.float64), device=device),
        area=torch.as_tensor(np.asarray(grid.area, np.float64),
                             device=device))
    if dsp is not None:
        model.dsp = make_dsp(N, dsp, device=device)
    if ist is not None:
        model.ist = make_ist(N, device=device, **ist)
        model.cim = torch.zeros(N, dtype=torch.float64, device=device)
    return model


def make_dsp(N, dsp: dict, device=None) -> dsp_mod.DspData:
    """DSP griddata with the reference's defaults (gwt-dsp.f90
    source_griddata: alv ← alh, ath2 ← ath1, atv ← 0)."""
    device = resolve_device(device)
    idisp = int(any(k in dsp for k in ("alh", "alv", "ath1", "ath2", "atv")))
    idiffc = int("diffc" in dsp)
    alh = _full(dsp.get("alh", 0.0), N, device)
    ath1 = _full(dsp.get("ath1", 0.0), N, device)
    return dsp_mod.DspData(
        alh=alh,
        alv=_full(dsp["alv"], N, device) if "alv" in dsp else alh,
        ath1=ath1,
        ath2=_full(dsp["ath2"], N, device) if "ath2" in dsp else ath1,
        atv=_full(dsp.get("atv", 0.0), N, device),
        diffc=_full(dsp.get("diffc", 0.0), N, device),
        idisp=idisp, idiffc=idiffc)


# the transport solution's settings when none are given (the reference's
# Simulation and CoupledGwfGwt defaults)
DEFAULT_GWT_SETTINGS = dict(outer_dvclose=1e-8, inner_dvclose=1e-10,
                            inner_rclose=1e-9, inner_maximum=1000,
                            outer_maximum=50, linear_acceleration="bicgstab")


class CoupledGwfGwt:
    """Sequential flow→transport stepping (the solution-group pattern: GWF
    solved first, FMI hands its flows to GWT within the same time step)."""

    def __init__(self, gwf_model, gwt_model, gwf_settings=None,
                 gwt_settings=None):
        self.gwf = gwf_model
        self.gwt = gwt_model
        self.gwf_sol = NumericalSolution(
            gwf_model, gwf_settings or ImsSettings(
                outer_dvclose=1e-8, inner_dvclose=1e-10, inner_rclose=1e-9,
                inner_maximum=1000, outer_maximum=100))
        self.gwt_sol = NumericalSolution(
            gwt_model, gwt_settings or ImsSettings(**DEFAULT_GWT_SETTINGS))

    def step(self, head_old, conc_old, delt, kstp=1, iss_flow=False):
        head, finfo, aux = self.gwf_sol.solve_timestep(
            head_old, delt, kstp=kstp, iss=iss_flow)
        fields = from_gwf_step(self.gwf, head, head_old, aux["ibound"],
                               aux["cond"], delt, iss_flow,
                               ssm_spec=self.gwt.ssm_spec, gwt=self.gwt)
        self.gwt.set_flows(fields)
        conc, tinfo, _ = self.gwt_sol.solve_timestep(
            conc_old, delt, kstp=kstp, iss=False, pkgs=fields)
        return head, conc, finfo, tinfo
