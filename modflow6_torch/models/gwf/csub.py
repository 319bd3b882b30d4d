"""CSUB: skeletal compaction and subsidence.

Port of modflow6_tpu/models/gwf/csub.py (``CsubData``, ``CsubState``,
``calc_stress``, ``assemble_csub``, ``advance_state``, ``_share``,
``make_csub``; reference gwf-csub.f90): geostatic stress accumulated down
the columns (csub_cg_calc_stress:3918-4041), coarse-grained elastic
storage (csub_cg_fc:4694-4748), no-delay interbeds with elastic/inelastic
switching on the preconsolidation stress (csub_nodelay_fc:4156-4252), the
HEAD_BASED option, the specific-storage input with its initial-stress
conversion (gwf-csub.f90:4420-4485), and delay interbeds (csub_delay.py).

Interbeds that share a cell add their terms to one row: those sums go
through an ``AddPlan`` over the interbeds' cells (no atomics), in the
interbeds' order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...constants import DONE, DZERO
from ...ops.scatter import AddPlan
from . import csub_delay as cd

DLOG10ES = 0.4342942


@dataclasses.dataclass(frozen=True)
class CsubData:
    """Static package data (after initial-stress storage conversion)."""

    sgm: torch.Tensor         # moist specific gravity per cell
    sgs: torch.Tensor         # saturated specific gravity per cell
    cg_ske_cr: torch.Tensor   # coarse elastic storage (converted)
    cg_theta: torch.Tensor    # coarse porosity
    cg_thickini: torch.Tensor  # coarse-grained thickness per cell
    ib_node: torch.Tensor     # i64[NB] interbed host cell
    ib_thick: torch.Tensor    # interbed thickness
    ib_rci: torch.Tensor      # recompression (elastic) index (converted)
    ib_ci: torch.Tensor       # compression (inelastic) index (converted)
    ib_theta: torch.Tensor
    ib_ielastic: torch.Tensor  # bool[NB] elastic-only interbed
    sig0: torch.Tensor        # user overburden addition per cell
    delay: Optional[cd.DelayData] = None   # idelay>0 interbeds
    # optional explicit "cell above" index chain (i64[N], -1 = top):
    # replaces the layer-major reshape+cumsum (calc_stress)
    up: Optional[torch.Tensor] = None
    head_based: bool = False
    nlay: int = 1
    ncpl: int = 1
    ib_plan: AddPlan = None   # per-cell sums over the no-delay interbeds


@dataclasses.dataclass(frozen=True)
class CsubState:
    es0: torch.Tensor         # effective stress at start of step, per cell
    pcs: torch.Tensor         # preconsolidation stress per interbed
    comp: torch.Tensor        # cumulative interbed compaction
    cg_comp: torch.Tensor     # cumulative coarse compaction
    db: Optional[cd.DelayState] = None   # delay columns
    db_comp: Optional[torch.Tensor] = None  # f64[B] cumulative delay-bed compaction


def _hbar(h, bot):
    """Corrected head clamped at the cell bottom (sQuadratic0sp)."""
    return torch.maximum(h, bot)


def _znode(top, bot, hbar):
    """Node elevation for stress adjustment (csub_calc_znode)."""
    z = torch.where(hbar < top, 0.5 * (hbar + bot), 0.5 * (top + bot))
    return torch.minimum(torch.maximum(z, bot), top)


def calc_stress(csub: CsubData, top, bot, head, ibound):
    """(gs, es) per cell (csub_cg_calc_stress)."""
    thick = top - bot
    h = torch.where(ibound != 0, head, bot)
    hb = _hbar(h, bot)
    gs_cell = torch.where(
        h < top,
        (top - hb) * csub.sgm + (hb - bot) * csub.sgs,
        thick * csub.sgs) + csub.sig0
    if csub.up is None:
        # overlying-cell accumulation: cumsum down the layer axis
        # (DIS/DISV layer-major ordering)
        gs = torch.cumsum(gs_cell.reshape(csub.nlay, csub.ncpl),
                          dim=0).reshape(-1)
    elif csub.nlay > 1:
        # explicit up-chain gather: nlay-1 sweeps converge the ancestor sum
        up = csub.up
        upc = torch.clamp(up, min=0)
        gs = gs_cell
        for _ in range(csub.nlay - 1):
            gs = gs_cell + torch.where(up >= 0, gs[upc], DZERO)
    else:
        gs = gs_cell
    es = gs - (hb - bot)
    return gs, es


def _sfact(csub, theta, es_adj):
    """f = 1/((1+e)·adjes) (csub_calc_sfacts); 1 for head-based."""
    if csub.head_based:
        return torch.ones_like(es_adj)
    void = theta / (DONE - theta)
    denom = es_adj * (DONE + void)
    return torch.where(denom != 0.0,
                       DONE / torch.where(denom != 0.0, denom, DONE), DZERO)


def _sat(icelltype, top, bot, h):
    conv = icelltype != 0
    s = torch.clamp((h - bot) / torch.where(top > bot, top - bot, DONE),
                    0.0, 1.0)
    return torch.where(conv, s, 1.0)


def _delay_columns(csub, state, head, gs, top, bot, delt):
    dd = csub.delay
    dn = dd.node
    return cd.solve_columns(dd, state.db, head[dn], gs[dn], top[dn], bot[dn],
                            csub.sgm[dn], csub.sgs[dn], delt,
                            csub.head_based)


def assemble_csub(csub: CsubData, state: CsubState, top, bot, area,
                  icelltype, head, head_old, ibound, delt):
    """(diag_add, rhs_add) from coarse + no-delay interbed storage and the
    delay interbeds' cell coupling."""
    tled = DONE / delt
    hb = _hbar(head, bot)
    gs, es = calc_stress(csub, top, bot, head, ibound)
    act = ibound > 0
    snnew = _sat(icelltype, top, bot, head)
    snold = _sat(icelltype, top, bot, head_old)

    # ---- coarse-grained elastic storage (csub_cg_fc)
    zn = _znode(top, bot, hb)
    es_adj = es - (zn - bot) * (csub.sgs - DONE)
    sske = _sfact(csub, csub.cg_theta, es_adj) * csub.cg_ske_cr
    rho1 = sske * area * csub.cg_thickini * tled
    hcof = -rho1 * snnew
    rhs = (rho1 * snold * state.es0
           - rho1 * snnew * (gs + bot)
           - rho1 * snnew * (head - hb))
    diag_add = torch.where(act, hcof, DZERO)
    rhs_add = torch.where(act, rhs, DZERO)

    # ---- no-delay interbeds (csub_nodelay_fc), summed into host cells
    if csub.ib_node.shape[0] > 0:
        nb = csub.ib_node
        hbn = hb[nb]
        zn_i = _znode(top[nb], bot[nb], hbn)
        es_adj_i = es[nb] - (zn_i - bot[nb]) * (csub.sgs[nb] - DONE)
        f = _sfact(csub, csub.ib_theta, es_adj_i)
        sto_fac = tled * snnew[nb] * csub.ib_thick * f
        sto_fac0 = tled * snold[nb] * csub.ib_thick * f
        r1 = csub.ib_rci * sto_fac0
        r2e = csub.ib_rci * sto_fac
        inelastic = (es[nb] > state.pcs) & ~csub.ib_ielastic
        r2 = torch.where(inelastic, csub.ib_ci * sto_fac, r2e)
        rcorr = r2 * (head[nb] - hbn)
        rhs_el = r1 * state.es0[nb] - r2 * (gs[nb] + bot[nb]) - rcorr
        rhs_in = (-r2 * (gs[nb] + bot[nb]) + state.pcs * (r2 - r1)
                  + r1 * state.es0[nb] - rcorr)
        rhs_ib = torch.where(csub.ib_ielastic, rhs_el, rhs_in)
        a = area[nb]
        actn = ibound[nb] > 0
        diag_add = csub.ib_plan.add(diag_add,
                                    torch.where(actn, -r2 * a, DZERO))
        rhs_add = csub.ib_plan.add(rhs_add,
                                   torch.where(actn, rhs_ib * a, DZERO))

    # ---- delay interbeds: solve the consolidation columns at the current
    # iterate, couple the two end conductances into the cell row
    # (csub_delay_sln + csub_interbed_fc delay branch)
    if csub.delay is not None and state.db is not None:
        dd = csub.delay
        h_db, _, _ = _delay_columns(csub, state, head, gs, top, bot, delt)
        hcof_d, rhs_d = cd.cell_terms(dd, h_db, area)
        actd = ibound[dd.node] > 0
        diag_add = dd.plan.add(diag_add, torch.where(actd, hcof_d, DZERO))
        rhs_add = dd.plan.add(rhs_add, torch.where(actd, rhs_d, DZERO))
    return diag_add, rhs_add


def _coarse_only(csub: CsubData) -> CsubData:
    """The package without its interbeds (the coarse-grained part)."""
    f64 = dict(dtype=csub.sgm.dtype, device=csub.sgm.device)
    empty = torch.zeros(0, **f64)
    return dataclasses.replace(
        csub, ib_node=torch.zeros(0, dtype=torch.int64, device=empty.device),
        ib_thick=empty, ib_rci=empty, ib_ci=empty, ib_theta=empty,
        ib_ielastic=torch.zeros(0, dtype=torch.bool, device=empty.device),
        delay=None, ib_plan=AddPlan((), csub.sgm.shape[0]))


def advance_state(csub: CsubData, state: CsubState, top, bot, area,
                  icelltype, head, head_old, ibound, delt) -> CsubState:
    """End-of-step updates: es0 ← es, pcs ← max(pcs, es), compaction
    accumulated from the storage release (csub_cg_update / csub_nodelay
    update role: compaction volume = water squeezed out)."""
    diag_c, rhs_c = assemble_csub(csub, state, top, bot, area, icelltype,
                                  head, head_old, ibound, delt)
    # per-cell storage release rate (positive = water released into the
    # model = compaction), boundary-flow convention q = hcof·h − rhs
    q_cell = diag_c * head - rhs_c
    gs, es = calc_stress(csub, top, bot, head, ibound)
    diag_cg, rhs_cg = assemble_csub(_coarse_only(csub), state, top, bot,
                                    area, icelltype, head, head_old, ibound,
                                    delt)
    q_cg = diag_cg * head - rhs_cg

    # delay interbeds: advance column state and accumulate compaction
    db_new, db_comp = state.db, state.db_comp
    q_delay = torch.zeros_like(q_cell)
    if csub.delay is not None and state.db is not None:
        dd = csub.delay
        dn = dd.node
        h_db, _, es_db = _delay_columns(csub, state, head, gs, top, bot,
                                        delt)
        hcof_d, rhs_d = cd.cell_terms(dd, h_db, area)
        q_delay = dd.plan.add(q_delay, hcof_d * head[dn] - rhs_d)
        db_comp = db_comp + cd.compaction(dd, state.db, es_db, csub.sgs[dn],
                                          csub.head_based)
        db_new = cd.DelayState(h0=h_db, es0=es_db,
                               pcs=torch.maximum(state.db.pcs, es_db))

    dcomp_cell = (q_cell - q_cg - q_delay) * delt / area  # no-delay beds
    dcg = q_cg * delt / area
    # distribute cell interbed compaction to interbeds by their share of
    # the release (exact with one interbed per cell; several interbeds of
    # a cell share in proportion to r2·thick)
    comp = state.comp + dcomp_cell[csub.ib_node] * _share(csub, state, es)
    return CsubState(es0=es, pcs=torch.maximum(state.pcs, es[csub.ib_node]),
                     comp=comp, cg_comp=state.cg_comp + dcg,
                     db=db_new, db_comp=db_comp)


def _share(csub, state, es):
    if csub.ib_node.shape[0] == 0:
        return torch.zeros(0, dtype=es.dtype, device=es.device)
    w = csub.ib_thick * torch.where(
        (es[csub.ib_node] > state.pcs) & ~csub.ib_ielastic,
        csub.ib_ci, csub.ib_rci)
    tot = csub.ib_plan.sum(w)[csub.ib_node]
    return w / torch.where(tot > 0, tot, DONE)


def from_arrays(data: dict, state: dict, *, head_based, nlay, ncpl,
                ncells=9, device=None):
    """(CsubData, CsubState) on ``device`` from host arrays: ``data`` holds
    the fields of the reference's CsubData (``delay`` as a dict of the
    DelayData fields or None; ``up`` optional), ``state`` those of its
    CsubState (``db`` as a dict of the DelayState fields or None)."""
    def t(v):
        v = np.asarray(v)
        dtype = (torch.bool if v.dtype.kind == "b" else torch.int64
                 if v.dtype.kind in "iu" else torch.float64)
        return torch.as_tensor(v, dtype=dtype, device=device)

    fields = {f.name for f in dataclasses.fields(CsubData)} - {
        "delay", "up", "head_based", "nlay", "ncpl", "ib_plan"}
    delay = data.get("delay")
    if delay is not None:
        node = np.asarray(delay["node"], np.int64)
        delay = cd.DelayData(
            **{key: t(value) for key, value in delay.items()},
            ncells=int(ncells), plan=AddPlan.build(node, device,
                                                   nlay * ncpl))
    ib_node = np.asarray(data["ib_node"], np.int64)
    csub = CsubData(**{key: t(data[key]) for key in fields}, delay=delay,
                    up=None if data.get("up") is None else t(data["up"]),
                    head_based=bool(head_based), nlay=int(nlay),
                    ncpl=int(ncpl),
                    ib_plan=AddPlan.build(ib_node, device, nlay * ncpl))
    db = state.get("db")
    st = CsubState(**{key: t(state[key]) for key in
                      ("es0", "pcs", "comp", "cg_comp")},
                   db=None if db is None else cd.DelayState(
                       **{key: t(value) for key, value in db.items()}),
                   db_comp=None if state.get("db_comp") is None
                   else t(state["db_comp"]))
    return csub, st


def make_csub(grid, *, sgm=1.7, sgs=2.0, cg_ske_cr=1e-5, cg_theta=0.2,
              cg_thick_frac=1.0, interbeds=(), sig0=0.0, head_based=False,
              strt=None, icelltype=None, istoragec=True,
              pcs_offset=0.0, delay_interbeds=(), ndelaycells=9,
              device=None):
    """Build CsubData + initial CsubState on ``device``.

    interbeds: (node, thick, sske_or_cr, ssv_or_cc, theta[, pcs_abs]);
    with istoragec the storages are converted at initial stress in the
    effective-stress case (gwf-csub.f90:4420-4485); without it the values
    are compression indices scaled by 0.4342942 (dlog10es).
    ``pcs_offset``: initial preconsolidation stress offset above the
    initial effective stress (relative spec, ispecified_pcs=0).
    ``delay_interbeds``: list of dicts (node, thick, kv, sske_cr, ssv_cc,
    theta, rnb) — idelay>0 beds solved as vertical consolidation columns
    of ``ndelaycells`` nodes (csub_delay.py).
    """
    N = grid.nodes
    shp = grid.shape
    nlay = shp[0] if len(shp) > 1 else 1
    ncpl = N // nlay
    f64 = dict(dtype=torch.float64, device=device)

    def full(v):
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
        return torch.as_tensor(np.broadcast_to(np.asarray(v, np.float64),
                                               (N,)).copy(), **f64)

    top = torch.as_tensor(np.asarray(grid.top).reshape(-1), **f64)
    bot = torch.as_tensor(np.asarray(grid.bot).reshape(-1), **f64)

    ib = np.asarray(interbeds, np.float64).reshape(-1, max(
        len(interbeds[0]) if len(interbeds) else 5, 5))
    nb = ib.shape[0]
    ib_node = ib[:, 0].astype(np.int64)
    csub = CsubData(
        sgm=full(sgm), sgs=full(sgs), cg_ske_cr=full(cg_ske_cr),
        cg_theta=full(cg_theta),
        cg_thickini=(top - bot) * full(cg_thick_frac),
        ib_node=torch.as_tensor(ib_node, dtype=torch.int64, device=device),
        ib_thick=torch.as_tensor(ib[:, 1].copy(), **f64),
        ib_rci=torch.as_tensor(ib[:, 2].copy(), **f64),
        ib_ci=torch.as_tensor(ib[:, 3].copy(), **f64),
        ib_theta=torch.as_tensor(ib[:, 4].copy(), **f64),
        ib_ielastic=torch.as_tensor(ib[:, 2] == ib[:, 3], dtype=torch.bool,
                                    device=device),
        sig0=full(sig0), head_based=bool(head_based),
        nlay=int(nlay), ncpl=int(ncpl),
        ib_plan=AddPlan.build(ib_node, device, N))

    # initial stresses at strt
    h0 = full(strt) if strt is not None else top
    ibound = torch.ones(N, dtype=torch.int32, device=device)
    gs0, es0 = calc_stress(csub, top, bot, h0, ibound)

    # storage conversion (specific-storage input, effective-stress mode)
    if not head_based:
        if istoragec:
            hb0 = _hbar(h0, bot)
            zn = _znode(top, bot, hb0)
            adj = es0 - (zn - bot) * (csub.sgs - DONE)
            void = csub.cg_theta / (DONE - csub.cg_theta)
            csub = dataclasses.replace(
                csub, cg_ske_cr=csub.cg_ske_cr * adj * (DONE + void))
            if nb:
                adj_i = adj[csub.ib_node]
                void_i = csub.ib_theta / (DONE - csub.ib_theta)
                fact = adj_i * (DONE + void_i)
                csub = dataclasses.replace(
                    csub, ib_rci=csub.ib_rci * fact,
                    ib_ci=csub.ib_ci * fact)
        else:
            csub = dataclasses.replace(
                csub, cg_ske_cr=csub.cg_ske_cr * DLOG10ES,
                ib_rci=csub.ib_rci * DLOG10ES,
                ib_ci=csub.ib_ci * DLOG10ES)

    pcs = es0[csub.ib_node] + pcs_offset if nb \
        else torch.zeros(0, **f64)

    db_state = None
    db_comp = None
    if delay_interbeds:
        dd, h0_db = cd.build_delay(delay_interbeds, grid, h0.cpu().numpy(),
                                   ncells=ndelaycells, device=device)
        # storage conversion at initial stress, as for no-delay interbeds
        if not head_based:
            if istoragec:
                hb0 = _hbar(h0, bot)
                zn = _znode(top, bot, hb0)
                adj = (es0 - (zn - bot) * (csub.sgs - DONE))[dd.node]
                void_d = dd.theta / (DONE - dd.theta)
                fact = adj * (DONE + void_d)
                dd = dataclasses.replace(dd, rci=dd.rci * fact,
                                         ci=dd.ci * fact)
            else:
                dd = dataclasses.replace(dd, rci=dd.rci * DLOG10ES,
                                         ci=dd.ci * DLOG10ES)
        csub = dataclasses.replace(csub, delay=dd)
        # initial column stresses at the initial heads
        dn = dd.node
        _, es0_d = cd._stress(dd, h0_db, h0[dn], gs0[dn], top[dn], bot[dn],
                              csub.sgm[dn], csub.sgs[dn])
        db_state = cd.DelayState(h0=h0_db, es0=es0_d,
                                 pcs=es0_d + pcs_offset)
        db_comp = torch.zeros(dd.nbeds, **f64)

    state = CsubState(es0=es0, pcs=pcs, comp=torch.zeros(nb, **f64),
                      cg_comp=torch.zeros(N, **f64), db=db_state,
                      db_comp=db_comp)
    return csub, state
