"""BUY: buoyancy (variable-density flow).

Port of modflow6_tpu/models/gwf/buy.py (``BuyData``, ``make_buy``,
``calcdens``, ``assemble_buy``, ``edge_flow_correction``; reference
src/Model/GroundWaterFlow/gwf-buy.f90): density from concentration(s) by
the linear equation of state (calcdens:81-98) and per-connection buoyancy
terms added to the flow system:

- iform 0: the equivalent-freshwater-head rhs-only term (calcbuy:1102-1180);
- iform 1: hydraulic-head formulation with the h terms lagged to the rhs
  (calchhterms:1184-1273, HHFORMULATION_RHS), symmetric matrix;
- iform 2 (the default): hydraulic-head formulation on the lhs, an
  asymmetric matrix (BiCGSTAB).

Two forms of the same terms.  The edge form (``assemble_buy``,
``edge_flow_correction``) walks the edge list of a full ``DeviceTopology``
as the reference does; its per-cell sums go through the ELL slots
(``npf._row_sum``).  The plane form (``assemble_buy_planes``,
``flow_correction_planes``) writes them on the three structured planes of
a DIS model on the structured path, whose conductances live there
(``npf_structured.structured_conductance``): per plane, n is the
lower-numbered cell of each face (west, north, above), wt = cl1/(cl1+cl2)
is delr[j]/(delr[j]+delr[j+1]) across a column face, delc[i]/(delc[i] +
delc[i+1]) across a row face and the upper cell's half thickness over the
two half thicknesses across a layer face, and the per-cell sums become
adds into shifted slices, in the fixed order x, y, z.
"""

from __future__ import annotations

import dataclasses

import torch

from ...constants import DONE, DZERO
from .npf import _PLANES, _row_sum


@dataclasses.dataclass(frozen=True)
class BuyData:
    """Linear equation-of-state coefficients (one or more species).

    dense = denseref + Σ_i drhodc[i]·(conc_i − crhoref[i])
    """

    denseref: float
    drhodc: tuple            # per species
    crhoref: tuple
    iform: int = 2


def make_buy(denseref=1000.0, drhodc=0.7, crhoref=0.0, iform=2) -> BuyData:
    drhodc = tuple(float(v) for v in torch.atleast_1d(
        torch.as_tensor(drhodc, dtype=torch.float64)).tolist())
    crhoref = torch.broadcast_to(
        torch.as_tensor(crhoref, dtype=torch.float64), (len(drhodc),))
    return BuyData(float(denseref), drhodc,
                   tuple(float(v) for v in crhoref.tolist()),
                   iform=int(iform))


def calcdens(buy: BuyData, conc):
    """ρ(c) linear EOS (reference calcdens, gwf-buy.f90:81-98).

    ``conc``: f64[N] (single species) or f64[nspecies, N]."""
    c = torch.atleast_2d(conc)
    terms = torch.stack([drho * (c[i] - cref) for i, (drho, cref) in
                         enumerate(zip(buy.drhodc, buy.crhoref))])
    return buy.denseref + terms.sum(dim=0)


def _terms(buy, wt, dn, dm, en, em, cond, hn, hm):
    """The per-connection pieces of calchhterms: (amat, drho, elev_nm,
    elev_mn, hphi) with ``cond`` already masked to active pairs."""
    rhon = dn / buy.denseref
    rhom = dm / buy.denseref
    drho = rhom - rhon
    rhoterm = wt * rhon + (DONE - wt) * rhom
    amat = cond * (rhoterm - DONE)   # amatnn = amatnm, both directions
    elev_nm = (DONE - wt) * en + wt * em          # direction (n,m)
    elev_mn = (DONE - (DONE - wt)) * em + (DONE - wt) * en  # direction (m,n)
    hphi = (DONE - wt) * hn + wt * hm
    return amat, drho, elev_nm, elev_mn, hphi


def _pair_terms(buy, wt, dn, dm, en, em, cond, hn, hm):
    """Per connection: the adds to (diag n, diag m, off(n,m), off(m,n),
    rhs n, rhs m) of the buy_fc double loop (gwf-buy.f90:811-847)."""
    if buy.iform == 0:
        avgdense = wt * dn + (DONE - wt) * dm
        b = cond * (avgdense - buy.denseref) / buy.denseref * (em - en)
        return None, None, None, None, -b, b
    amat, drho, elev_nm, elev_mn, hphi = _terms(buy, wt, dn, dm, en, em,
                                                cond, hn, hm)
    rhsterm_nm = -cond * drho * elev_nm
    rhsterm_mn = cond * drho * elev_mn
    diag_n = diag_m = -amat
    off_nm = off_mn = amat
    if buy.iform == 1:
        # lag h to the rhs: hphi is the same in both directions
        rhsterm_nm = rhsterm_nm + cond * hphi * drho
        rhsterm_mn = rhsterm_mn - cond * hphi * drho
    else:
        # iform 2: lhs corrections (asymmetric matrix)
        diag_n = diag_n + cond * (DONE - wt) * drho
        off_nm = off_nm + cond * wt * drho
        diag_m = diag_m - cond * wt * drho
        off_mn = off_mn - cond * (DONE - wt) * drho
    return diag_n, diag_m, off_nm, off_mn, -rhsterm_nm, -rhsterm_mn


def _correction(buy, wt, dn, dm, en, em, cond, hn, hm):
    """ΔQ per connection, positive into n (buy_cq)."""
    if buy.iform == 0:
        avgdense = wt * dn + (DONE - wt) * dm
        return cond * (avgdense - buy.denseref) / buy.denseref * (em - en)
    amat, drho, elev_nm, _, hphi = _terms(buy, wt, dn, dm, en, em, cond, hn,
                                          hm)
    return amat * (hm - hn) + cond * drho * (hphi - elev_nm)


def _edge_inputs(dtopo, dense, cond, sat, top, bot, ibound, head):
    n, m = dtopo.edge_n, dtopo.edge_m
    act = (ibound[n] != 0) & (ibound[m] != 0)
    cond = torch.where(act, cond, DZERO)
    clsum = dtopo.cl1 + dtopo.cl2
    wt = dtopo.cl1 / torch.where(clsum > 0, clsum, DONE)
    # saturated-midpoint elevations (ireadelev=0 path; buy_ad)
    elev = bot + 0.5 * sat * (top - bot)
    return wt, dense[n], dense[m], elev[n], elev[m], cond, head[n], head[m]


def assemble_buy(dtopo, buy: BuyData, dense, cond, sat, top, bot, ibound,
                 head, diag, off, rhs):
    """Add buoyancy terms to the assembled system on the edge list (buy_fc
    role).  ``cond``: per-edge conductance (npf.edge_conductance);
    ``dense``: per-cell density; ``head``: the current iterate."""
    d_n, d_m, o_nm, o_mn, r_n, r_m = _pair_terms(
        buy, *_edge_inputs(dtopo, dense, cond, sat, top, bot, ibound, head))
    rhs = rhs + _row_sum(dtopo, r_n, r_m)
    if d_n is None:
        return diag, off, rhs
    N, K = off.shape
    diag = diag + _row_sum(dtopo, d_n, d_m)
    off = off.reshape(-1).clone()
    off[dtopo.slot_nm] += o_nm
    off[dtopo.slot_mn] += o_mn
    return diag, off.view(N, K), rhs


def edge_flow_correction(dtopo, buy: BuyData, dense, cond, sat, top, bot,
                         ibound, head):
    """ΔQ per edge (positive into cell n): the buy_cq flowja correction
    (gwf-buy.f90 buy_cq).

    iform 0:   ΔQ = cond·(ρ̄−ρref)/ρref·(elev_m − elev_n)
    iform 1/2: ΔQ = cond·(rhoterm−1)·(h_m − h_n) + cond·Δρ'·(hphi − elev_nm)
    """
    return _correction(buy, *_edge_inputs(dtopo, dense, cond, sat, top, bot,
                                          ibound, head))


def _plane_inputs(shape, delr, delc, dense, cond3, sat, top, bot, ibound,
                  exists, head):
    """Per plane (x, y, z): the arguments of ``_pair_terms``, and the
    plane's slices and slots."""
    elev = (bot + 0.5 * sat * (top - bot)).reshape(shape)
    t3, b3 = top.reshape(shape), bot.reshape(shape)
    act = ((ibound != 0) & (exists != 0)).reshape(shape)
    d3, h3 = dense.reshape(shape), head.reshape(shape)
    half = 0.5 * (t3 - b3)
    weights = (
        (0.5 * delr[:-1] / (0.5 * delr[:-1] + 0.5 * delr[1:]))[None, None, :],
        (0.5 * delc[:-1] / (0.5 * delc[:-1] + 0.5 * delc[1:]))[None, :, None],
        None)
    for (ns, ms, slot_nm, slot_mn, _), cond, w in zip(_PLANES, cond3,
                                                      weights):
        if w is None:
            clsum = half[ns] + half[ms]
            w = half[ns] / torch.where(clsum > 0, clsum, DONE)
        c = torch.where(act[ns] & act[ms], cond, DZERO)
        yield (ns, ms, slot_nm, slot_mn), (w, d3[ns], d3[ms], elev[ns],
                                           elev[ms], c, h3[ns], h3[ms])


def assemble_buy_planes(shape, delr, delc, buy: BuyData, dense, cond3, sat,
                        top, bot, ibound, exists, head, diag, off, rhs):
    """The buoyancy terms of :func:`assemble_buy` on the structured planes;
    ``cond3``: (cond_x, cond_y, cond_z) at the current head; ``exists``
    ([N], non-zero where idomain != 0) masks faces without a connection."""
    diag3 = diag.reshape(shape).clone()
    rhs3 = rhs.reshape(shape).clone()
    c = off.reshape(shape + (6,)).clone()
    for (ns, ms, slot_nm, slot_mn), args in _plane_inputs(
            shape, delr, delc, dense, cond3, sat, top, bot, ibound, exists,
            head):
        d_n, d_m, o_nm, o_mn, r_n, r_m = _pair_terms(buy, *args)
        rhs3[ns] += r_n
        rhs3[ms] += r_m
        if d_n is None:
            continue
        diag3[ns] += d_n
        diag3[ms] += d_m
        c[ns + (slot_nm,)] += o_nm
        c[ms + (slot_mn,)] += o_mn
    return diag3.reshape(-1), c.reshape(-1, 6), rhs3.reshape(-1)


def flow_correction_planes(shape, delr, delc, buy: BuyData, dense, cond3,
                           sat, top, bot, ibound, exists, head):
    """ΔQ of :func:`edge_flow_correction` on the three planes (positive
    into the lower-numbered cell of each face)."""
    return tuple(_correction(buy, *args) for _, args in _plane_inputs(
        shape, delr, delc, dense, cond3, sat, top, bot, ibound, exists,
        head))
