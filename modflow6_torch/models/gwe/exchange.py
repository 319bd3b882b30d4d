"""GWE-GWE exchange: several heat-transport models over one merged flow
model.

Port of modflow6_tpu/models/gwe/exchange.py (reference exg-gwegwe.f90):
the members merge into one ``GweModel`` over the merged GWF model's
topology (``gwf.exchange.merge_gwf_models``), so the exchange edges are
ordinary edges, advective and conductive, as in ``gwt.exchange``.  What
the reference's merge drops raises here: members whose SSM source
temperatures differ (it keeps the first member's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gwt.exchange import _cat, _cat_entries, _same_spec
from ..gwt.model import CncData, SrcData
from . import cnd as cnd_mod
from . import est as est_mod
from .model import GweModel


def merge_gwe_models(models, gwf_merged) -> GweModel:
    """The union of the GWE ``models`` over the merged GWF composite of the
    same member order (its grid's ``offsets`` give the numbering)."""
    offsets = list(np.asarray(gwf_merged.grid.offsets))
    m0 = models[0]
    if any(m.iadvwt != m0.iadvwt for m in models):
        raise ValueError("exchange requires a consistent ADV scheme")
    if any((m.cnd is None) != (m0.cnd is None) for m in models):
        raise ValueError("exchange requires consistent CND usage")
    if any(m.est_opts != m0.est_opts for m in models):
        raise ValueError("exchange requires identical EST options "
                         "(rhow/cpw/decay mode)")
    if any(not _same_spec(m.ssm_spec, m0.ssm_spec) for m in models):
        raise NotImplementedError(
            "members with different SSM source temperatures (the "
            "reference's merge keeps the first member's)")

    cnd = None
    if m0.cnd is not None:
        cnd = cnd_mod.CndData(
            **{f: _cat(lambda m, f=f: getattr(m.cnd, f), models)
               for f in ("alh", "alv", "ath1", "ath2", "atv", "ktw", "kts")},
            idisp=max(m.cnd.idisp for m in models),
            iktw=max(m.cnd.iktw for m in models),
            ikts=max(m.cnd.ikts for m in models))

    grid = gwf_merged.grid
    device = gwf_merged.device

    def host(a):
        return torch.as_tensor(np.asarray(a, np.float64).reshape(-1),
                               device=device)

    return GweModel(
        name="+".join(m.name for m in models),
        grid=grid, topo=gwf_merged.topo,
        dtopo=dataclasses.replace(gwf_merged.dtopo, grid_shape=None),
        strt=_cat(lambda m: m.strt, models),
        ibound0=_cat(lambda m: m.ibound0, models),
        est_opts=m0.est_opts,
        est_arrays=est_mod.EstArrays(**{
            f.name: _cat(lambda m, f=f: getattr(m.est_arrays, f.name),
                         models)
            for f in dataclasses.fields(est_mod.EstArrays)}),
        iadvwt=m0.iadvwt, cnd=cnd,
        ctp=_cat_entries(CncData, [m.ctp for m in models], offsets),
        esl=_cat_entries(SrcData, [m.esl for m in models], offsets),
        ssm_spec=m0.ssm_spec,
        top=host(grid.top), bot=host(grid.bot), area=host(grid.area))
