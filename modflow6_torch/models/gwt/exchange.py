"""GWT-GWT exchange: several transport models over one merged flow model.

Port of modflow6_tpu/models/gwt/exchange.py (reference exg-gwtgwt.f90):
the member transport models merge into one ``GwtModel`` over the merged
GWF model's topology (``gwf.exchange.merge_gwf_models``), so the exchange
edges are ordinary edges: upstream weighting and dispersion act across
the interface, and the merged flow model's FMI fields line up edge for
edge.  As in the reference, this is reachable from Python only: the deck
loader refuses several GWT models.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import dsp as dsp_mod
from . import mst as mst_mod
from .model import CncData, GwtModel, SrcData


def _cat(get, models):
    return torch.cat([get(m).reshape(-1) for m in models])


def _cat_entries(cls, datas, offsets):
    """One CNC or SRC data object over the members', nodes shifted."""
    live = [(d, int(off)) for d, off in zip(datas, offsets) if d is not None]
    if not live:
        return None
    out = {}
    for f in dataclasses.fields(cls):
        parts = [getattr(d, f.name) for d, _ in live]
        if f.name == "node":
            parts = [p + off for p, (_, off) in zip(parts, live)]
        out[f.name] = torch.cat(parts)
    return cls(**out)


def _same_spec(a, b):
    a, b = a or {}, b or {}
    return a.keys() == b.keys() and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def merge_gwt_models(models, gwf_merged) -> GwtModel:
    """The union of the GWT ``models`` over the merged GWF composite of the
    same member order (its grid's ``offsets`` give the numbering)."""
    offsets = list(np.asarray(gwf_merged.grid.offsets))
    m0 = models[0]
    if any(m.iadvwt != m0.iadvwt for m in models):
        raise ValueError("exchange requires a consistent ADV scheme")
    if any((m.dsp is None) != (m0.dsp is None) for m in models):
        raise ValueError("exchange requires consistent DSP usage")
    # what the reference's merge drops without a word raises here
    if any(m.ist is not None for m in models):
        raise NotImplementedError(
            "IST in a merged transport model (the reference's merge drops "
            "the immobile domain)")
    if any(not _same_spec(m.ssm_spec, m0.ssm_spec) for m in models):
        raise NotImplementedError(
            "members with different SSM source concentrations (the "
            "reference's merge keeps the first member's)")

    dsp = None
    if m0.dsp is not None:
        dsp = dsp_mod.DspData(
            **{f: _cat(lambda m, f=f: getattr(m.dsp, f), models)
               for f in ("alh", "alv", "ath1", "ath2", "atv", "diffc")},
            idisp=max(m.dsp.idisp for m in models),
            idiffc=max(m.dsp.idiffc for m in models))

    grid = gwf_merged.grid
    device = gwf_merged.device

    def host(a):
        return torch.as_tensor(np.asarray(a, np.float64).reshape(-1),
                               device=device)

    return GwtModel(
        name="+".join(m.name for m in models),
        grid=grid, topo=gwf_merged.topo,
        dtopo=dataclasses.replace(gwf_merged.dtopo, grid_shape=None),
        strt=_cat(lambda m: m.strt, models),
        ibound0=_cat(lambda m: m.ibound0, models),
        mst_opts=m0.mst_opts,
        mst_arrays=mst_mod.MstArrays(**{
            f.name: _cat(lambda m, f=f: getattr(m.mst_arrays, f.name),
                         models)
            for f in dataclasses.fields(mst_mod.MstArrays)}),
        iadvwt=m0.iadvwt, eqnsclfac=m0.eqnsclfac, dsp=dsp,
        cnc=_cat_entries(CncData, [m.cnc for m in models], offsets),
        src=_cat_entries(SrcData, [m.src for m in models], offsets),
        ssm_spec=m0.ssm_spec,
        top=host(grid.top), bot=host(grid.bot), area=host(grid.area))
