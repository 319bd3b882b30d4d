"""CSUB delay interbeds: vertical consolidation sub-columns.

Port of modflow6_tpu/models/gwf/csub_delay.py (``DelayData``,
``DelayState``, ``thomas``, ``_stress``, ``_ssk``, ``solve_columns``,
``cell_terms``, ``compaction``, ``build_delay``; reference gwf-csub.f90
csub_delay_calc_stress:5799-5867, csub_delay_calc_ssksske:5879-5972,
csub_delay_assemble_fc:6017-6140, csub_delay_sln:5649-5730,
csub_delay_fc, csub_delay_calc_comp).

All delay interbeds solve at once: the column state is a dense
[n_interbeds, ndelaycells] tensor.  The Thomas solve is 2 x ndelaycells
batched steps over the beds (the reference's two ``lax.scan`` sweeps), and
the stress iteration runs until the largest head change of the batch is
at most ``dclose``: the host reads that change once per iteration, so the
loop exits at the reference's ``while_loop`` iteration.  Saturated-column
assumption (dsn = 1), as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...constants import DONE, DZERO
from ...ops.scatter import AddPlan


@dataclasses.dataclass(frozen=True)
class DelayData:
    """Static delay-interbed data (storages already converted like the
    no-delay interbeds)."""

    node: torch.Tensor      # i64[B] host cell
    kv: torch.Tensor        # f64[B] vertical K of the interbed
    rci: torch.Tensor       # f64[B] recompression (elastic) storage
    ci: torch.Tensor        # f64[B] compression (inelastic) storage
    theta: torch.Tensor     # f64[B] porosity
    rnb: torch.Tensor       # f64[B] equivalent-interbed count
    dzini: torch.Tensor     # f64[B] cell size = thick / ncells
    z: torch.Tensor         # f64[B, ND] node-center elevations, top first
    ielastic: torch.Tensor  # bool[B]
    ncells: int = 9
    plan: AddPlan = None    # per-cell sums over the beds of a cell

    @property
    def nbeds(self) -> int:
        return self.node.shape[0]


@dataclasses.dataclass(frozen=True)
class DelayState:
    h0: torch.Tensor    # f64[B, ND] heads at start of step
    es0: torch.Tensor   # f64[B, ND] effective stress at start of step
    pcs: torch.Tensor   # f64[B, ND] preconsolidation stress per node


def thomas(dl, dd, du, b):
    """Batched Thomas tridiagonal solve (ims_misc_thomas role).

    dl/dd/du/b: f64[B, N] (dl[:,0], du[:,-1] ignored): a forward and a
    backward sweep along the column axis, batched over the beds."""
    cp = dp = torch.zeros(dd.shape[0], dtype=dd.dtype, device=dd.device)
    cps, dps = [], []
    for i in range(dd.shape[1]):
        a = dl[:, i]
        m = dd[:, i] - a * cp
        cp = du[:, i] / m
        dp = (b[:, i] - a * dp) / m
        cps.append(cp)
        dps.append(dp)
    x = torch.zeros_like(cp)
    xs = [None] * len(cps)
    for i in reversed(range(len(cps))):
        x = dps[i] - cps[i] * x
        xs[i] = x
    return torch.stack(xs, dim=1)


def _hbar(h, bot):
    return torch.maximum(h, bot)


def _stress(dd: DelayData, h, hcell, gs_cell, top_c, bot_c, sgm, sgs):
    """(geo, es) per delay node (csub_delay_calc_stress).

    gs_cell/top_c/bot_c/sgm/sgs: f64[B] host-cell values; h f64[B, ND];
    hcell f64[B]."""
    dzh = 0.5 * dd.dzini[:, None]
    top_ib = dd.z[:, 0] + dd.dzini * 0.5
    hbc = _hbar(hcell, bot_c)
    sadd_top = torch.where(hcell < top_ib,
                           (top_ib - hbc) * sgm + (hbc - bot_c) * sgs,
                           (top_ib - bot_c) * sgs)
    sigma0 = gs_cell - sadd_top
    topn = dd.z + dzh
    botn = dd.z - dzh
    hb = _hbar(h, botn)
    sadd = torch.where(h < topn,
                       (topn - hb) * sgm[:, None] + (hb - botn) * sgs[:, None],
                       (topn - botn) * sgs[:, None])
    geo = sigma0[:, None] + torch.cumsum(sadd, dim=1)
    es = geo - (hb - botn)
    return geo, es


def _ssk(dd: DelayData, es, pcs, sgs, head_based):
    """(ssk, sske) per node (csub_delay_calc_ssksske): effective-stress
    factor f = 1/((1+e)·adjes) with the current stress (ieslag off), the
    inelastic switch on the node preconsolidation stress."""
    if head_based:
        f = torch.ones_like(es)
    else:
        dzh = 0.5 * dd.dzini[:, None]
        zbot = dd.z - dzh
        # znode at the node's own saturated center (confined columns:
        # znode = z, the reference's dbrelz recentring coincides)
        znode = dd.z
        adjes = es - (znode - zbot) * (sgs[:, None] - DONE)
        void = dd.theta / (DONE - dd.theta)
        denom = adjes * (DONE + void[:, None])
        f = torch.where(denom != DZERO,
                        DONE / torch.where(denom != DZERO, denom, DONE),
                        DZERO)
    sske = f * dd.rci[:, None]
    convert = (es > pcs) & ~dd.ielastic[:, None]
    ssk = torch.where(convert, f * dd.ci[:, None], sske)
    return ssk, sske


def solve_columns(dd: DelayData, st: DelayState, hcell, gs_cell, top_c,
                  bot_c, sgm, sgs, delt, head_based,
                  dclose=1e-10, itmax=100):
    """Solve every delay column to convergence at the given host-cell
    heads (csub_delay_sln for the whole batch).  Returns (h, geo, es)."""
    smult = (dd.dzini / delt)[:, None]
    c = (dd.kv / dd.dzini)[:, None]
    dzh = 0.5 * dd.dzini[:, None]
    botn = dd.z - dzh
    dl = c.expand(dd.nbeds, dd.ncells)

    def body(h):
        geo, es = _stress(dd, h, hcell, gs_cell, top_c, bot_c, sgm, sgs)
        ssk, sske = _ssk(dd, es, st.pcs, sgs, head_based)
        hb = _hbar(h, botn)
        # tridiagonal system (csub_delay_assemble_fc, saturated dsn=1)
        aii = -2.0 * dl - smult * ssk
        aii[:, 0] += -c[:, 0]
        aii[:, -1] += -c[:, 0]
        r_el = -smult * (ssk * (geo + botn) - sske * st.es0)
        r_in = -smult * (ssk * (geo + botn - st.pcs)
                         + sske * (st.pcs - st.es0))
        r = torch.where(dd.ielastic[:, None], r_el, r_in)
        r = r + smult * ssk * (h - hb)    # hbar storage correction
        r[:, 0] += -2.0 * c[:, 0] * hcell
        r[:, -1] += -2.0 * c[:, 0] * hcell
        h_new = thomas(dl, aii, dl, r)
        return h_new, (h_new - h).abs().max()

    # the first solve, then the reference's while_loop from it = 1: one
    # host read of the largest change per iteration
    h, _ = body(st.h0)
    if dd.nbeds:
        it = 1
        while it < itmax:
            h, dh = body(h)
            it += 1
            if not float(dh) > dclose:
                break
    geo, es = _stress(dd, h, hcell, gs_cell, top_c, bot_c, sgm, sgs)
    return h, geo, es


def cell_terms(dd: DelayData, h, area):
    """(hcof, rhs) per bed from the end-node conductances (csub_delay_fc ×
    area·rnb, csub_interbed_fc sign); ``plan`` sums them per cell."""
    c2 = 2.0 * dd.kv / dd.dzini
    f = area[dd.node] * dd.rnb
    hcof = -(c2 + c2) * f
    rhs = -c2 * (h[:, 0] + h[:, -1]) * f
    return hcof, rhs


def compaction(dd: DelayData, st: DelayState, es, sgs, head_based):
    """Compaction increment per interbed (csub_delay_calc_comp, dsn=1),
    already scaled by rnb."""
    ssk, sske = _ssk(dd, es, st.pcs, sgs, head_based)
    v_el = ssk * (es - st.es0)
    v_in = ssk * (es - st.pcs) + sske * (st.pcs - st.es0)
    v = torch.where(dd.ielastic[:, None], v_el, v_in) * dd.dzini[:, None]
    return v.sum(dim=1) * dd.rnb


def build_delay(interbeds, grid, strt, ncells=9, device=None):
    """``interbeds``: list of dicts (node, thick, kv, sske_cr, ssv_cc,
    theta, rnb=1, head=strt) — the PACKAGEDATA columns for idelay beds.
    Columns are centered in their host cell.  Returns (DelayData, initial
    heads h0[B, ND]) on ``device``."""
    top = np.asarray(grid.top).reshape(-1)
    bot = np.asarray(grid.bot).reshape(-1)
    node = np.asarray([int(b["node"]) for b in interbeds], np.int64)
    thick = np.asarray([b["thick"] for b in interbeds], np.float64)
    dzini = thick / ncells
    strt = np.broadcast_to(np.asarray(strt, np.float64).reshape(-1),
                           top.shape)
    # column center, then the node centers from the top down
    zc = 0.5 * (top[node] + bot[node])
    ztop = zc + 0.5 * thick - 0.5 * dzini
    z = ztop[:, None] - np.arange(ncells)[None, :] * dzini[:, None]
    h0 = np.repeat(np.asarray([float(b.get("head", strt[n]))
                               for b, n in zip(interbeds, node)])[:, None],
                   ncells, axis=1)

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    dd = DelayData(
        node=t(node, torch.int64),
        kv=t([b["kv"] for b in interbeds]),
        rci=t([b["sske_cr"] for b in interbeds]),
        ci=t([b["ssv_cc"] for b in interbeds]),
        theta=t([b.get("theta", 0.3) for b in interbeds]),
        rnb=t([b.get("rnb", 1.0) for b in interbeds]),
        dzini=t(dzini), z=t(z),
        ielastic=t([b["sske_cr"] == b["ssv_cc"] for b in interbeds],
                   torch.bool),
        ncells=int(ncells),
        plan=AddPlan.build(node, device, top.size))
    return dd, t(h0)
