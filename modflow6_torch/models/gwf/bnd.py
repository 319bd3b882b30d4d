"""Stress packages of the slice: CHD, WEL (with AUTO_FLOW_REDUCE), RCH.

Port of modflow6_tpu/models/gwf/bnd.py:111-246 (reference
BoundaryPackage.f90 bnd_cf + bnd_fc, gwf-chd.f90, gwf-wel.f90,
gwf-rch.f90).  Entries are padded to a fixed ``maxbound`` with
``mask=False``.  Node indices are int64 tensors, as ``index_add_`` and
advanced indexing take them.

``scatter_terms`` adds with ``index_add``.  On CUDA that uses atomics, so
entries that share a node are summed in an order that varies from run to
run; the difference is at the 1e-15 level.
"""

from __future__ import annotations

import dataclasses

import torch

from ...constants import DZERO
from ...ops.smoothing import sq_saturation, sq_saturation_derivative


@dataclasses.dataclass(frozen=True)
class ChdData:
    node: torch.Tensor   # i64[B]
    head: torch.Tensor   # f64[B]
    mask: torch.Tensor   # bool[B]


@dataclasses.dataclass(frozen=True)
class WelData:
    node: torch.Tensor
    q: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RchData:
    node: torch.Tensor
    recharge: torch.Tensor  # flux per unit area
    mask: torch.Tensor


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


def scatter_terms(diag, rhs_vec, node, mask, hcof, rhs):
    """bnd_fc: add per-entry hcof→diag, rhs→rhs at each entry's node."""
    diag = diag.index_add(0, node, torch.where(mask, hcof, DZERO))
    rhs_vec = rhs_vec.index_add(0, node, torch.where(mask, rhs, DZERO))
    return diag, rhs_vec


def bound_flows(node, mask, hcof, rhs, head, ibound):
    """Per-entry flow rate q = hcof*h - rhs (reference bnd_cq)."""
    q = hcof * head[node] - rhs
    return torch.where(mask & (ibound[node] > 0), q, DZERO)
