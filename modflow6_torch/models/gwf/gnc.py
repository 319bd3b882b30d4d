"""GNC: ghost-node correction for non-CVFD-compliant grids.

Port of modflow6_tpu/models/gwf/gnc.py (``GncData``, ``build_gnc``,
``gnc_rhs_terms``, ``deltaQgnc``; reference src/Exchange/GhostNode.f90):
the head driving the two-point flux across a refinement interface is
interpolated from contributing cells j with weights α, and the flux
correction per connection (n, m) is ΔQ = cond · Σ_j α_j (h_n − h_j)
(deltaQgnc:449-486), applied in the explicit form of gnc_fc:280-324:
rhs(n) −= ΔQ, rhs(m) += ΔQ, re-evaluated at each outer iteration.

Contributors are a dense [G, J] table (α = 0 padding).  Several entries
can share a row or a connection: their sums go through ``AddPlan``s built
with the table (no atomics), in the reference's order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import resolve_device
from ...constants import DZERO
from ...ops.scatter import AddPlan


@dataclasses.dataclass(frozen=True)
class GncData:
    edge_idx: torch.Tensor   # i64[G] index into the topology edge arrays
    n: torch.Tensor          # i64[G] noden (the ghosted side)
    m: torch.Tensor          # i64[G] nodem
    jcells: torch.Tensor     # i64[G, J] contributing cells (self-padded)
    alphas: torch.Tensor     # f64[G, J] interpolation weights (0 = pad)
    rhs_plan: AddPlan = None   # -ΔQ into rows n, then +ΔQ into rows m
    flow_plan: AddPlan = None  # -ΔQ into the flows of the connections


def build_gnc(topo, entries, device=None):
    """``entries``: list of (noden, nodem, [(cellj, alpha), ...]) in model
    node numbers (the GNCDATA block role).  ``device=None`` is the CUDA
    device."""
    device = resolve_device(device)
    en = np.asarray(topo.edge_n, np.int64)
    em = np.asarray(topo.edge_m, np.int64)
    key = en * topo.nodes + em
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    G = len(entries)
    J = max(len(e[2]) for e in entries)
    eidx = np.zeros(G, np.int64)
    nn = np.zeros(G, np.int64)
    mm = np.zeros(G, np.int64)
    jc = np.zeros((G, J), np.int64)
    al = np.zeros((G, J))
    for i, (n, m, contribs) in enumerate(entries):
        lo, hi = min(int(n), int(m)), max(int(n), int(m))
        # the last edge of the pair, as the reference's dict lookup keeps
        at = int(np.searchsorted(sorted_key, lo * topo.nodes + hi,
                                 side="right")) - 1
        if at < 0 or sorted_key[at] != lo * topo.nodes + hi:
            raise ValueError(f"GNC cells {n},{m} are not connected")
        eidx[i] = order[at]
        nn[i], mm[i] = int(n), int(m)
        jc[i, :] = int(n)            # α=0 self padding
        for jj, (cj, a) in enumerate(contribs):
            jc[i, jj] = int(cj)
            al[i, jj] = float(a)

    return from_arrays(dict(edge_idx=eidx, n=nn, m=mm, jcells=jc,
                            alphas=al), topo.nodes, en.size, device)


def from_arrays(arrays: dict, nodes, nedges, device) -> GncData:
    """GncData on ``device`` from the host arrays of the reference's
    GncData fields, with the plans of its sums."""
    a = {key: np.asarray(arrays[key]) for key in
         ("edge_idx", "n", "m", "jcells", "alphas")}
    return GncData(
        **{key: torch.as_tensor(value, dtype=torch.float64
                                if key == "alphas" else torch.int64,
                                device=device)
           for key, value in a.items()},
        rhs_plan=AddPlan.build(np.concatenate([a["n"], a["m"]]), device,
                               nodes),
        flow_plan=AddPlan.build(a["edge_idx"], device, nedges))


def gnc_rhs_terms(gnc: GncData, cond_edges, head, ibound):
    """ΔQ per entry at the current iterate; the caller adds −ΔQ to the rows
    n and +ΔQ to the rows m (``rhs_plan``)."""
    cond = cond_edges[gnc.edge_idx]
    act = (ibound[gnc.n] != 0) & (ibound[gnc.m] != 0)
    a_act = torch.where(ibound[gnc.jcells] != 0, gnc.alphas, DZERO)
    rterm = (a_act * (head[gnc.n][:, None] - head[gnc.jcells])).sum(dim=1)
    return torch.where(act, cond * rterm, DZERO)


def deltaQgnc(gnc: GncData, cond_edges, head, ibound):
    """ΔQ per gnc entry (deltaQgnc role) for budget/flowja corrections."""
    return gnc_rhs_terms(gnc, cond_edges, head, ibound)


def add_rhs(gnc: GncData, rhs, rterm):
    """rhs(n) −= ΔQ, rhs(m) += ΔQ (gnc_fc explicit form)."""
    return gnc.rhs_plan.add(rhs, torch.cat([-rterm, rterm]))
