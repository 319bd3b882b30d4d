"""ADV: advection with upstream, central or TVD weighting.

Port of modflow6_tpu/models/gwt/adv.py (reference tsp-adv.f90: adv_fc /
adv_weight :193-229, 504-539, advtvd / advqtvd :236-325, adv_dt
:128-187).  Vectorized over the edge list (n < m); both matrix rows of a
connection are filled in one pass.  The reference's central weighting
reads (cl1, cl2) from the symmetric arrays for both rows of a horizontal
connection, so both rows get the same omega there; that quirk is kept.

Per-cell sums of per-edge terms (the diagonal, the TVD correction, the
Courant flow totals) go through the ELL slots (``npf._row_sum``); the
off-diagonal terms are indexed stores, since each edge owns its two slots.
"""

from __future__ import annotations

import torch

from ...constants import C3D_VERTICAL, DHALF, DONE, DPREC, DTWO, DZERO
from ..gwf.npf import _row_sum

UPSTREAM = 0
CENTRAL = 1
TVD = 2


def _weights(dtopo, iadvwt, q_nm, top, bot):
    """Per-edge omega for row n and row m (reference adv_weight)."""
    n, m = dtopo.edge_n, dtopo.edge_m
    if iadvwt == CENTRAL:
        is_vert = dtopo.ihc == C3D_VERTICAL
        thk_n = DHALF * (top[n] - bot[n])
        thk_m = DHALF * (top[m] - bot[m])
        # horizontal: cl2/(cl1+cl2) for both rows (the reference's quirk);
        # vertical: the two half thicknesses, swapped per row
        om_h = dtopo.cl2 / (dtopo.cl1 + dtopo.cl2)
        om_n = torch.where(is_vert, thk_m / (thk_n + thk_m), om_h)
        om_m = torch.where(is_vert, thk_n / (thk_n + thk_m), om_h)
        return om_n, om_m
    # upstream (also the implicit part of TVD)
    om_n = (~(q_nm > DZERO)).to(q_nm.dtype)
    om_m = (~(-q_nm > DZERO)).to(q_nm.dtype)
    return om_n, om_m


def assemble(dtopo, iadvwt, fields, ibound, top, bot, eqnsclfac=1.0):
    """adv_fc matrix terms → (diag[N], off[N, K]) to add into the system."""
    N, K = dtopo.nodes, dtopo.max_degree
    n, m = dtopo.edge_n, dtopo.edge_m
    act = (ibound[n] != 0) & (ibound[m] != 0)
    q_nm = torch.where(act, fields.q_edge * eqnsclfac, DZERO)
    om_n, om_m = _weights(dtopo, iadvwt, q_nm, top, bot)
    q_mn = -q_nm
    diag = _row_sum(dtopo, q_nm * om_n, q_mn * om_m)
    off = torch.zeros(N * K, dtype=q_nm.dtype, device=q_nm.device)
    off[dtopo.slot_nm] = q_nm * (DONE - om_n)
    off[dtopo.slot_mn] = q_mn * (DONE - om_m)
    return diag, off.view(N, K)


def second_upstream(dtopo, fields, ibound):
    """Per cell, the neighbour with the largest inflow into it (the
    second-upstream cell of the edges that leave it): (i2up_all[N],
    el2_all[N], has2[N]).  ``torch.argmax`` takes the first of tied
    slots, as ``jnp.argmax`` does, and the slots are in the reference's
    order."""
    N, K = dtopo.nodes, dtopo.max_degree
    n, m = dtopo.edge_n, dtopo.edge_m
    q = fields.q_edge
    inflow = torch.zeros(N * K, dtype=q.dtype, device=q.device)
    inflow[dtopo.slot_nm] = torch.where(ibound[m] != 0, q, DZERO)
    inflow[dtopo.slot_mn] = torch.where(ibound[n] != 0, -q, DZERO)
    el = torch.zeros(N * K, dtype=q.dtype, device=q.device)
    el[dtopo.slot_nm] = dtopo.cl1 + dtopo.cl2
    el[dtopo.slot_mn] = dtopo.cl1 + dtopo.cl2
    inflow, el = inflow.view(N, K), el.view(N, K)
    best = torch.argmax(inflow, dim=1, keepdim=True)
    qmax = inflow.gather(1, best).squeeze(1)
    i2up_all = dtopo.nbr.gather(1, best).squeeze(1)
    el2_all = el.gather(1, best).squeeze(1)
    return i2up_all, el2_all, qmax > DZERO


def tvd_rhs(dtopo, fields, ibound, cnew, eqnsclfac=1.0):
    """TVD limiter rhs correction (advtvd, tsp-adv.f90:236-264) at the
    concentration iterate ``cnew``."""
    n, m = dtopo.edge_n, dtopo.edge_m
    i2up_all, el2_all, has2 = second_upstream(dtopo, fields, ibound)

    q = fields.q_edge
    ups_is_m = q > DZERO                     # positive into n: m upstream
    iup = torch.where(ups_is_m, m, n)
    idn = torch.where(ups_is_m, n, m)
    elupdn = dtopo.cl1 + dtopo.cl2
    i2up = i2up_all[iup]
    el2 = el2_all[iup]
    valid = has2[iup] & (ibound[n] != 0) & (ibound[m] != 0)

    c_up, c_dn = cnew[iup], cnew[idn]
    cdiff = (c_dn - c_up).abs()
    denom = torch.where(cdiff > DPREC, c_dn - c_up, DONE)
    smooth = torch.where(
        cdiff > DPREC,
        (c_up - cnew[i2up]) / torch.where(el2 != 0, el2, DONE)
        * elupdn / denom,
        DZERO)
    alim = DTWO * smooth / (DONE + smooth)
    qtvd = torch.where(valid & (smooth > DZERO),
                       DHALF * alim * q * (c_dn - c_up) * eqnsclfac, DZERO)
    # rhs(n) -= qtvd ; rhs(m) += qtvd
    return _row_sum(dtopo, -qtvd, qtvd)


def adv_dtmax(dtopo, fields, ibound, porosity, area, top, bot,
              ats_percel=1.0):
    """Courant limit of the ATS step (reference adv_dt,
    tsp-adv.f90:128-187): per active cell with flow, dt = V·sat·θ /
    max(Σ inflow, Σ outflow), the minimum over cells (inf without flow)
    times ``ats_percel``; a 0-d tensor."""
    n, m = dtopo.edge_n, dtopo.edge_m
    act_edge = (ibound[n] != 0) & (ibound[m] != 0)
    q = torch.where(act_edge, fields.q_edge, DZERO)
    qin, qout = q.clamp(min=DZERO), (-q).clamp(min=DZERO)
    pos = _row_sum(dtopo, qin, qout)
    neg = _row_sum(dtopo, qout, qin)
    flowmax = torch.maximum(pos, neg)
    vol = area * (top - bot) * fields.sat * porosity
    act = (ibound != 0) & (flowmax > 1e-300)
    dt = torch.where(act, vol / torch.where(flowmax > 0, flowmax, DONE),
                     torch.inf)
    return dt.min() * ats_percel
