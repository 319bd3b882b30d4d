"""Stress packages: CHD, WEL (with AUTO_FLOW_REDUCE), RCH, DRN, RIV, GHB
and EVT (one segment or several).

Port of modflow6_tpu/models/gwf/bnd.py (reference BoundaryPackage.f90
bnd_cf + bnd_fc, gwf-chd.f90, gwf-wel.f90, gwf-rch.f90, gwf-drn.f90
drn_cf :340-373 + get_drain_factor :534-574, gwf-riv.f90:270-299,
gwf-ghb.f90:245-265, gwf-evt.f90 evt_cf).  Entries are padded to a fixed
``maxbound`` with ``mask=False``.  Node indices are int64 tensors, as
advanced indexing takes them.

``scatter_terms`` adds each entry's terms at its node through the data
object's ``add_plan`` (``ops/scatter.py:AddPlan``), which sums the entries
that share a node (two wells in one cell, a repeated cellid) in entry
order, the reference's ``.at[node].add`` order, with no atomics: the sums
are the same on every run, on the card and on the CPU.  The plan is built
from the nodes on the host at its first use, once per data object: a
period's data, not an assembly.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional

import torch

from ...constants import DONE, DZERO
from ...ops.scatter import AddPlan
from ...ops.smoothing import (quadratic_saturation, sq_saturation,
                              sq_saturation_derivative)


class _Entries:
    """What the per-entry data classes share: ``node`` and ``mask``."""

    @cached_property
    def add_plan(self) -> AddPlan:
        """The plan of ``out[node[i]] += v[i]`` over the entries with
        ``mask``, in entry order (``AddPlan.add`` only)."""
        sel = torch.nonzero(self.mask).squeeze(1)
        return AddPlan.build(self.node[sel], self.node.device, 0,
                             sources=sel)


@dataclasses.dataclass(frozen=True)
class ChdData:
    node: torch.Tensor   # i64[B]
    head: torch.Tensor   # f64[B]
    mask: torch.Tensor   # bool[B]


@dataclasses.dataclass(frozen=True)
class WelData(_Entries):
    node: torch.Tensor
    q: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RchData(_Entries):
    node: torch.Tensor
    recharge: torch.Tensor  # flux per unit area
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DrnData(_Entries):
    node: torch.Tensor
    elev: torch.Tensor
    cond: torch.Tensor
    ddrn: torch.Tensor  # drainage depth (0 unless AUXDEPTHNAME)
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RivData(_Entries):
    node: torch.Tensor
    stage: torch.Tensor
    cond: torch.Tensor
    rbot: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GhbData(_Entries):
    node: torch.Tensor
    bhead: torch.Tensor
    cond: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EvtData(_Entries):
    node: torch.Tensor
    surface: torch.Tensor
    rate: torch.Tensor
    depth: torch.Tensor
    mask: torch.Tensor
    # segmented ET (NSEG>1, gwf-evt.f90 evt_cf segloop): per-entry interior
    # breakpoints as depth fractions (pxdp, ascending) and rate proportions
    # (petm); None → single linear segment
    pxdp: Optional[torch.Tensor] = None   # f64[B, nseg-1]
    petm: Optional[torch.Tensor] = None   # f64[B, nseg-1]


def apply_chd(ibound, head, chd: ChdData):
    """CHD rp/ad: mark cells constant-head (ibound=-1) and pin their heads."""
    ib = ibound.clone()
    ib[chd.node] = torch.where(chd.mask, -1, ibound[chd.node])
    h = head.clone()
    h[chd.node] = torch.where(chd.mask, chd.head, head[chd.node])
    return ib, h


def _flowred_top(wel: WelData, top, bot, flowred: float):
    """(tp, bt) of the AUTO_FLOW_REDUCE interval at each well's cell: the
    lowest ``flowred`` fraction of the cell thickness."""
    bt = bot[wel.node]
    return bt + flowred * (top[wel.node] - bt), bt


def wel_terms(wel: WelData, head, ibound, icelltype, top, bot,
              iflowred: int = 0, flowred: float = 0.0):
    """WEL hcof/rhs with optional AUTO_FLOW_REDUCE Newton smoothing
    (wel_cf, gwf-wel.f90:296-332)."""
    act = wel.mask & (ibound[wel.node] > 0)
    q = wel.q
    if iflowred:
        tp, bt = _flowred_top(wel, top, bot, flowred)
        qmult = sq_saturation(tp, bt, head[wel.node])
        q = torch.where((icelltype[wel.node] != 0) & (q < DZERO), q * qmult,
                        q)
    hcof = torch.zeros_like(q)
    rhs = torch.where(act, -q, DZERO)
    return hcof, rhs


def wel_newton(wel: WelData, head, ibound, icelltype, top, bot,
               iflowred: int, flowred: float):
    """WEL Newton terms (hcof_add, rhs_add) for AUTO_FLOW_REDUCE (wel_fn,
    gwf-wel.f90:378-424)."""
    act = wel.mask & (ibound[wel.node] > 0)
    tp, bt = _flowred_top(wel, top, bot, flowred)
    drterm = sq_saturation_derivative(tp, bt, head[wel.node]) * wel.q
    use = (act & (icelltype[wel.node] != 0) & (wel.q < DZERO) if iflowred
           else torch.zeros_like(act))
    hcof = torch.where(use, drterm, DZERO)
    rhs = torch.where(use, drterm * head[wel.node], DZERO)
    return hcof, rhs


def rch_terms(rch: RchData, ibound, area):
    act = rch.mask & (ibound[rch.node] > 0)
    hcof = torch.zeros_like(rch.recharge)
    rhs = torch.where(act, -rch.recharge * area[rch.node], DZERO)
    return hcof, rhs


def drn_terms(drn: DrnData, head, ibound, icubic_scaling: int = 0):
    act = drn.mask & (ibound[drn.node] > 0)
    x = head[drn.node]
    drnbot = drn.elev
    drntop = drn.elev + drn.ddrn
    has_depth = drn.ddrn != DZERO
    if icubic_scaling:
        fact_smooth = sq_saturation(drntop, drnbot, x, c1=-1.0, c2=2.0)
    else:
        fact_smooth = quadratic_saturation(drntop, drnbot, x, 0.0)
    fact_step = torch.where(x <= drnbot, DZERO, DONE)
    fact = torch.where(has_depth, fact_smooth, fact_step)
    hcof = torch.where(act, -fact * drn.cond, DZERO)
    rhs = torch.where(act, -fact * drn.cond * drnbot, DZERO)
    return hcof, rhs


def riv_terms(riv: RivData, head, ibound):
    act = riv.mask & (ibound[riv.node] > 0)
    below = head[riv.node] <= riv.rbot
    hcof = torch.where(act & ~below, -riv.cond, DZERO)
    rhs = torch.where(
        act,
        torch.where(below, -riv.cond * (riv.stage - riv.rbot),
                    -riv.cond * riv.stage),
        DZERO)
    return hcof, rhs


def ghb_terms(ghb: GhbData, ibound):
    act = ghb.mask & (ibound[ghb.node] > 0)
    hcof = torch.where(act, -ghb.cond, DZERO)
    rhs = torch.where(act, -ghb.cond * ghb.bhead, DZERO)
    return hcof, rhs


def evt_terms(evt: EvtData, head, ibound, area):
    """EVT: linear or segmented ET-vs-depth (reference gwf-evt.f90 evt_cf).

    Single segment: full rate above the ET surface, linear to zero at
    surface − depth.  Segmented (pxdp/petm present): piecewise-linear rate
    proportion between breakpoints, per the evt_cf segloop:
      thcof = −(petm1−petm2)·c/((pxdp2−pxdp1)·x)
      trhs  = thcof·(s − pxdp1·x) + petm1·c
    """
    act = evt.mask & (ibound[evt.node] > 0)
    h = head[evt.node]
    s = evt.surface
    c = evt.rate * area[evt.node]          # max ET volume rate (positive)
    x = torch.where(evt.depth != 0, evt.depth, DONE)
    above = h >= s
    d = s - h
    below_ext = d >= x

    if evt.pxdp is None:
        thcof = -c / x
        trhs = c - c * s / x
    else:
        ones = torch.ones_like(evt.pxdp[:, :1])
        zeros = torch.zeros_like(ones)
        px = torch.cat([zeros, evt.pxdp, ones], dim=1)
        pe = torch.cat([ones, evt.petm, zeros], dim=1)
        dfrac = (d / x)[:, None]
        idx = torch.sum(dfrac > px[:, 1:-1], dim=1)  # segment index [0, nseg)

        def take(a, i):
            return torch.gather(a, 1, i[:, None])[:, 0]

        pxdp1 = take(px, idx)
        pxdp2 = take(px, idx + 1)
        petm1 = take(pe, idx)
        petm2 = take(pe, idx + 1)
        seg = torch.where(pxdp2 - pxdp1 > 0, pxdp2 - pxdp1, DONE)
        thcof = -(petm1 - petm2) * c / (seg * x)
        trhs = thcof * (s - pxdp1 * x) + petm1 * c

    mid = act & ~above & ~below_ext
    hcof = torch.where(mid, thcof, DZERO)
    rhs = torch.where(mid, trhs, torch.where(act & above, c, DZERO))
    return hcof, rhs


def scatter_terms(diag, rhs_vec, data, hcof, rhs):
    """bnd_fc: add per-entry hcof→diag, rhs→rhs at each entry's node, over
    the entries of ``data`` with ``mask`` (the others add zeros in the
    reference)."""
    plan = data.add_plan
    return plan.add(diag, hcof), plan.add(rhs_vec, rhs)


def bound_flows(node, mask, hcof, rhs, head, ibound):
    """Per-entry flow rate q = hcof*h - rhs (reference bnd_cq)."""
    q = hcof * head[node] - rhs
    return torch.where(mask & (ibound[node] > 0), q, DZERO)
