"""XT3D: the full-tensor flux approximation, in full-matrix and RHS modes,
with its Newton form.

Port of modflow6_tpu/models/gwf/xt3d.py (``Xt3dData``, ``cell_centers``,
``_tensor``, ``build_xt3d``, ``_abwts``, ``_abhats``, ``_areas``,
``xt3d_chats``, ``_fill``, ``assemble``, ``_areas_newton``,
``assemble_newton``, ``edge_flows``; reference Xt3dAlgorithm.f90:47-490,
Xt3dInterface.f90:371-494, 693-793, 1211-1378, 1522-1611).

Every per-connection quantity is an [E] or [E, K] tensor aligned with the
depth-1 ELL table; the coefficients of one outer iteration (rotation
matrices, omega weights, the 2x2 solves, the sigma products) are batched
elementwise work over all interfaces at once.  Full mode (``ixt3d=1``)
widens the stencil to depth 2: the assembled off-diagonal block is
[N, Ktot] over the extended neighbour table ``nbr_ext``, which the product
and the Dirichlet fixup use; RHS mode (``ixt3d=2``) keeps the depth-1
stencil and moves the perpendicular-gradient terms to the right-hand side.

Host build: the reference fills the extended table with Python loops over
edges x K.  Here it is array code with the same result: the candidate
(row, column) pairs in the reference's visiting order (edge, slot, n-side
before m-side), the depth-1 neighbours filtered out, the first appearance
of each pair kept (``np.unique``) and ranked within its row.

Sums: the reference adds per-interface terms into per-cell and per-entry
arrays with ``.at[...].add``, whose indices repeat.  Here the per-cell sums
go through the depth-1 ELL slots (``npf._row_sum``), the bhat terms on a
row's depth-1 columns through a [N*K, K] buffer indexed by the half-edge's
slot and summed over the slots, and the cross terms (a neighbour's
neighbours, which several interfaces reach) through an ``AddPlan`` built
with the table: no atomics, the same sums on every run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...ops.scatter import AddPlan
from ...ops.smoothing import quadratic_saturation_derivative
from ..discretization import DisGrid, DisvGrid
from .npf import _row_sum

_TINY = 1e-300


@dataclasses.dataclass(frozen=True)
class Xt3dData:
    """Static XT3D geometry and tensors on the model's device; the index
    tensors are int64."""

    nbr: torch.Tensor       # [N, K] depth-1 neighbour table (self-padded)
    valid0: torch.Tensor    # bool[N, K] structural validity
    vc: torch.Tensor        # f64[N, K, 3] unit connection vectors (cell→nbr)
    vn: torch.Tensor        # f64[N, K, 3] unit face normals (cell→nbr)
    dl: torch.Tensor        # f64[N, K] connection length, cell side
    dln: torch.Tensor       # f64[N, K] connection length, neighbour side
    allhc: torch.Tensor     # bool[N] all connections horizontal
    ck: torch.Tensor        # f64[N, 3, 3] conductivity tensors
    top: torch.Tensor       # f64[N]
    bot: torch.Tensor       # f64[N]
    edge_n: torch.Tensor    # [E]
    edge_m: torch.Tensor    # [E]
    k_nm: torch.Tensor      # [E] slot of m in n's neighbour list
    k_mn: torch.Tensor      # [E] slot of n in m's neighbour list
    ihc_e: torch.Tensor     # i32[E]
    hwva_e: torch.Tensor    # f64[E]
    pos_n_jm: torch.Tensor  # [E, K] flat (N*Ktot) slot of col nbr[m,k] in row n
    pos_m_in: torch.Tensor  # [E, K] flat slot of col nbr[n,k] in row m
    nbr_ext: torch.Tensor   # [N, Ktot] extended (depth-2) neighbour table
    slot_nm: torch.Tensor   # [E] flat (N*K) depth-1 slot of (n, m)
    slot_mn: torch.Tensor   # [E] flat depth-1 slot of (m, n)
    cross_plan: Optional[AddPlan] = None   # full mode: the cross terms
    ixt3d: int = 1          # 1=full matrix, 2=rhs-only
    vcthresh: float = 0.0

    @property
    def nodes(self) -> int:
        return self.nbr.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr.shape[1]

    @property
    def table_bytes(self) -> int:
        """Bytes of the extended table, the cross positions and the plan."""
        size = sum(t.numel() * t.element_size()
                   for t in (self.nbr_ext, self.pos_n_jm, self.pos_m_in))
        return size + (self.cross_plan.nbytes if self.cross_plan else 0)


# --------------------------------------------------------------- host build

def cell_centers(grid):
    """(x, y, z) cell centers; y decreases with row index so that the
    reference's 'back' (i2<i1) direction is +y (Dis.f90:1150-1156)."""
    top = np.asarray(grid.top, np.float64)
    bot = np.asarray(grid.bot, np.float64)
    z = 0.5 * (top + bot)
    if isinstance(grid, DisGrid):
        delr = np.asarray(grid.delr, np.float64)
        delc = np.asarray(grid.delc, np.float64)
        xcol = np.cumsum(delr) - 0.5 * delr
        yrow = -(np.cumsum(delc) - 0.5 * delc)
        nlay, nrow, ncol = grid.shape
        x = np.tile(xcol[None, None, :], (nlay, nrow, 1)).reshape(-1)
        y = np.tile(yrow[None, :, None], (nlay, 1, ncol)).reshape(-1)
        return x, y, z
    if isinstance(grid, DisvGrid):
        x = np.tile(np.asarray(grid.xc, np.float64), grid.nlay)
        y = np.tile(np.asarray(grid.yc, np.float64), grid.nlay)
        return x, y, z
    # DISU: user-supplied centers required
    if getattr(grid, "xc", None) is not None:
        return (np.asarray(grid.xc, np.float64),
                np.asarray(grid.yc, np.float64), z)
    raise ValueError("XT3D on DISU requires cell center coordinates")


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _tensor(n, k11, k22, k33, angle1, angle2, angle3):
    """Per-cell rotated conductivity tensors (xt3d_fillrmatck,
    Xt3dInterface.f90:1577-1611; angles in degrees as in the npf input)."""
    def full(v):
        return np.broadcast_to(np.asarray(_host(v), np.float64), (n,))

    a1 = np.deg2rad(full(angle1))
    a2 = np.deg2rad(full(angle2))
    a3 = np.deg2rad(full(angle3))
    s1, c1 = np.sin(a1), np.cos(a1)
    s2, c2 = np.sin(a2), np.cos(a2)
    s3, c3 = np.sin(a3), np.cos(a3)
    r = np.zeros((n, 3, 3))
    r[:, 0, 0] = c1 * c2
    r[:, 0, 1] = c1 * s2 * s3 - s1 * c3
    r[:, 0, 2] = -c1 * s2 * c3 - s1 * s3
    r[:, 1, 0] = s1 * c2
    r[:, 1, 1] = s1 * s2 * s3 + c1 * c3
    r[:, 1, 2] = -s1 * s2 * c3 + c1 * s3
    r[:, 2, 0] = s2
    r[:, 2, 1] = -c2 * s3
    r[:, 2, 2] = c2 * c3
    kd = np.zeros((n, 3, 3))
    kd[:, 0, 0] = full(k11)
    kd[:, 1, 1] = full(k22)
    kd[:, 2, 2] = full(k33)
    return np.einsum("nij,njk,nlk->nil", r, kd, r)


def _group_starts(sorted_vals):
    """For rows of sorted values [R, C]: whether each entry starts a run of
    equal values, and the column where its run starts."""
    starts = torch.ones_like(sorted_vals, dtype=torch.bool)
    starts[:, 1:] = sorted_vals[:, 1:] != sorted_vals[:, :-1]
    col = torch.arange(sorted_vals.shape[1], device=sorted_vals.device)
    return starts, torch.cummax(torch.where(starts, col, 0), dim=1).values


def _scatter_rows(order, values):
    """out[r, order[r, c]] = values[r, c]: the inverse of a row sort."""
    return torch.empty_like(values).scatter_(1, order, values)


def extended_table(nbr, edge_n, edge_m, slot_nm, slot_mn, device=None,
                   ktot_min=0):
    """(nbr_ext [N, Ktot], pos_n_jm [E, K], pos_m_in [E, K], rank_n_jm,
    rank_m_in), int64 tensors on ``device``, of full mode, equal to the
    reference's loops (xt3d.py:199-240): for each edge (n, m) and slot s,
    column nbr[m, s] joins row n and column nbr[n, s] joins row m unless it
    is padding, the other cell, or a depth-1 neighbour of the row; a row's
    new columns take the slots K, K+1, ... in the order of their first
    appearance; the positions are flat (row * Ktot + slot), N * Ktot where
    the column is padding or the other cell.  ``rank_*`` count, for each
    position, the entries before it that reach the same position, in the
    order -chat1j into pos_n_jm then -chati0 into pos_m_in, edge by edge
    and slot by slot (the reference's scatter order): the rounds of the
    cross-term plan.  ``ktot_min`` widens the table to at least that
    many slots, the padding pointing at the row itself (the sharded
    runners give every shard one width).

    Row by row, as the reference visits a row: the candidates of row r
    arrive in the order of the edges of r (by edge number), each edge
    bringing the K neighbours of its other cell; so the candidates are an
    [N, K*K] table, deduplicated and ranked with sorts along its short
    rows, with no sort over all candidates.  On the card this takes a
    second at millions of cells."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=device)

    nbr, en, em = t(nbr), t(edge_n), t(edge_m)
    slot_nm, slot_mn = t(slot_nm), t(slot_mn)
    N, K = nbr.shape
    E = en.shape[0]
    own = torch.arange(N, device=nbr.device)[:, None]
    arange_e = torch.arange(E, device=nbr.device)
    # the edge of each slot, and the row's slots in edge order
    edge_of = torch.full((N * K,), E, dtype=torch.int64, device=nbr.device)
    edge_of[slot_nm] = arange_e
    edge_of[slot_mn] = arange_e
    edge_sorted, by_edge = torch.sort(edge_of.view(N, K), dim=1, stable=True)
    del edge_of
    inv = _scatter_rows(by_edge, torch.arange(
        K, device=nbr.device).expand(N, K).contiguous())
    other = nbr.gather(1, by_edge)                                # [N, K]
    # candidates [N, K (half-edge in edge order), K (slot s)]
    cand = nbr[other]
    valid = ((edge_sorted < E)[:, :, None] & (cand != other[:, :, None])
             & (cand != own[:, :, None])).view(N, K * K)
    cand = cand.view(N, K * K)
    del other
    # depth-1 columns: the slot of the column in the row's own list
    eq = (cand[:, :, None] == nbr[:, None, :]) & valid[:, :, None]
    in1 = eq.any(dim=2)
    slot = torch.where(in1, eq.to(torch.uint8).argmax(dim=2), 0)
    del eq
    # new columns: rank of first appearance within the row
    new = valid & ~in1
    del in1
    srt, order = torch.sort(torch.where(new, cand, N), dim=1, stable=True)
    starts, gstart = _group_starts(srt)
    starts &= srt < N
    first = _scatter_rows(order, starts)
    rank = (first.cumsum(dim=1) - 1).gather(1, order.gather(1, gstart))
    rank = _scatter_rows(order, rank)
    del srt, order, starts, gstart
    k2 = int(first.sum(dim=1).max()) if N else 0
    ktot = max(K + k2, int(ktot_min))
    nbr_ext = own.repeat(1, ktot)
    nbr_ext[:, :K] = nbr
    rows, cols = torch.nonzero(first, as_tuple=True)
    nbr_ext[rows, K + rank[rows, cols]] = cand[rows, cols]
    del first, rows, cols, cand
    slot = torch.where(new, K + rank, slot)
    del rank, new
    pos = torch.where(valid, own * ktot + slot, N * ktot)
    del slot

    # the plan's ranks: within each (row, position), in source order
    # (n-side sources e*K+s before m-side sources (E+e)*K+s)
    e_sorted = edge_sorted.clamp(max=E - 1)
    m_side = (own != en[e_sorted]).to(torch.int64) * E
    src = ((m_side + edge_sorted)[:, :, None] * K
           + torch.arange(K, device=nbr.device)).view(N, K * K)
    del e_sorted, m_side, edge_sorted
    key = torch.where(valid, (pos - own * ktot) * (2 * E * K) + src,
                      torch.iinfo(torch.int64).max)
    del src, valid
    _, order = torch.sort(key, dim=1, stable=True)
    del key
    _, gstart = _group_starts(pos.gather(1, order))
    crank = _scatter_rows(order, torch.arange(
        K * K, device=nbr.device) - gstart)
    del order, gstart
    pos, crank = pos.view(N, K, K), crank.view(N, K, K)
    jn = inv[en, slot_nm - en * K]
    jm = inv[em, slot_mn - em * K]
    return (nbr_ext, pos[en, jn], pos[em, jm], crank[en, jn],
            crank[em, jm])


def build_xt3d(grid, topo, k11, k22, k33, angle1=0.0, angle2=0.0,
               angle3=0.0, ixt3d=1, device=None, ktot_min=0) -> Xt3dData:
    """Host-side geometry/tensor preparation (xt3d_df + xt3d_load roles).
    ``device``: where the tensors go.  ``ktot_min``: the least width of
    the extended table in full mode (see ``extended_table``)."""
    N = topo.nodes
    E = topo.nedges
    K = topo.max_degree
    en = topo.edge_n.astype(np.int64)
    em = topo.edge_m.astype(np.int64)
    slot_nm = topo.slot_nm.astype(np.int64)
    slot_mn = topo.slot_mn.astype(np.int64)
    k_nm = slot_nm - en * K
    k_mn = slot_mn - em * K
    x, y, z = cell_centers(grid)
    top = np.asarray(grid.top, np.float64)
    bot = np.asarray(grid.bot, np.float64)

    ihc = np.asarray(topo.ihc)
    horiz = ihc != 0
    dx = np.where(horiz, x[em] - x[en], 0.0)
    dy = np.where(horiz, y[em] - y[en], 0.0)
    dz = z[em] - z[en]
    # connection vector n→m at full saturation (connection_vector,
    # Dis.f90:1094-1160 with satn=satm=1)
    conlen_h = np.sqrt(dx * dx + dy * dy + dz * dz)
    conlen = np.where(horiz, conlen_h, np.abs(dz))
    conlen = np.where(conlen > 0.0, conlen, 1.0)
    vcx = np.where(horiz, dx / conlen, 0.0)
    vcy = np.where(horiz, dy / conlen, 0.0)
    vcz = np.where(horiz, dz / conlen, np.sign(dz))
    vc_e = np.stack([vcx, vcy, vcz], axis=1)
    # face normal n→m (connection_normal): horizontal from ANGLDEGX,
    # vertical ±z
    ang = np.asarray(topo.anglex)
    vn_e = np.stack([np.where(horiz, np.cos(ang), 0.0),
                     np.where(horiz, np.sin(ang), 0.0),
                     np.where(horiz, 0.0, np.sign(dz))], axis=1)
    clsum = np.asarray(topo.cl1) + np.asarray(topo.cl2)
    clsum = np.where(clsum > 0.0, clsum, 1.0)
    dl_n = conlen * np.asarray(topo.cl1) / clsum
    dl_m = conlen * np.asarray(topo.cl2) / clsum

    nbr = np.asarray(topo.nbr, np.int64)
    valid0 = nbr != np.arange(N, dtype=np.int64)[:, None]
    vc = np.zeros((N, K, 3))
    vn = np.zeros((N, K, 3))
    dl = np.ones((N, K))
    dln = np.ones((N, K))
    vc[en, k_nm] = vc_e
    vc[em, k_mn] = -vc_e
    vn[en, k_nm] = vn_e
    vn[em, k_mn] = -vn_e
    dl[en, k_nm] = dl_n
    dln[en, k_nm] = dl_m
    dl[em, k_mn] = dl_m
    dln[em, k_mn] = dl_n
    allhc = np.ones(N, bool)
    vert = ~horiz
    allhc[en[vert]] = False
    allhc[em[vert]] = False

    ck = _tensor(N, k11, k22, k33, angle1, angle2, angle3)

    ranks = None
    if ixt3d == 1:
        nbr_ext, pos_n_jm, pos_m_in, *ranks = extended_table(
            nbr, en, em, slot_nm, slot_mn, device, ktot_min)
    else:
        nbr_ext = nbr
        pos_n_jm = np.full((E, K), N * K, np.int64)
        pos_m_in = np.full((E, K), N * K, np.int64)
    return from_arrays(dict(
        nbr=nbr, valid0=valid0, vc=vc, vn=vn, dl=dl, dln=dln, allhc=allhc,
        ck=ck, top=top, bot=bot, edge_n=en, edge_m=em, k_nm=k_nm, k_mn=k_mn,
        ihc_e=ihc, hwva_e=np.asarray(topo.hwva), pos_n_jm=pos_n_jm,
        pos_m_in=pos_m_in, nbr_ext=nbr_ext), ixt3d, device, ranks=ranks)


_FIELDS = ("nbr", "valid0", "vc", "vn", "dl", "dln", "allhc", "ck", "top",
           "bot", "edge_n", "edge_m", "k_nm", "k_mn", "ihc_e", "hwva_e",
           "pos_n_jm", "pos_m_in", "nbr_ext")


def from_arrays(arrays: dict, ixt3d, device, vcthresh=0.0,
                ranks=None) -> Xt3dData:
    """Xt3dData on ``device`` from the host arrays of its fields (those of
    the reference's Xt3dData, ``_FIELDS``), with the depth-1 slots and, in
    full mode, the plan of the cross terms: -chat1j[e, s] into
    pos_n_jm[e, s], then -chati0[e, s] into pos_m_in[e, s], in that order
    (modflow6_tpu xt3d.py:412-415).  The arrays may be numpy arrays or
    tensors.  ``ranks``: the plan's rounds as ``extended_table`` gives them;
    found by a sort when not given."""
    fields = {}
    for key in _FIELDS:
        value = arrays[key]
        kind = (value.dtype.is_floating_point and "f" or value.dtype
                == torch.bool and "b" or "i") \
            if isinstance(value, torch.Tensor) else np.asarray(value).dtype.kind
        dtype = (torch.float64 if kind == "f" else torch.bool if kind == "b"
                 else torch.int32 if key == "ihc_e" else torch.int64)
        fields[key] = torch.as_tensor(np.asarray(value) if not isinstance(
            value, torch.Tensor) else value, dtype=dtype,
            device=device).contiguous()
    N, K = fields["nbr"].shape
    cross_plan = None
    if ixt3d == 1:
        size = N * fields["nbr_ext"].shape[1]
        pos = torch.cat([fields["pos_n_jm"].reshape(-1),
                         fields["pos_m_in"].reshape(-1)])
        keep = torch.nonzero(pos < size).squeeze(1)
        cross_plan = AddPlan.build(
            pos[keep], device, size, sources=keep,
            rank=None if ranks is None else torch.cat(
                [r.reshape(-1) for r in ranks]).to(keep.device)[keep])
    slots = {key: cells * K + fields[k]
             for key, cells, k in (("slot_nm", fields["edge_n"], "k_nm"),
                                   ("slot_mn", fields["edge_m"], "k_mn"))}
    return Xt3dData(**fields, **slots, cross_plan=cross_plan,
                    ixt3d=int(ixt3d), vcthresh=float(vcthresh))


# ------------------------------------------------------------ device math

def _dot3(a, b):
    """Σ_c a[..., c] b[..., c] over the last axis of length 3."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _abwts(vccde, nde1, valid, dl, dln, dl01, vcthresh):
    """Vectorized abwts (Xt3dAlgorithm.f90:389-490): omega/b/a weights for
    the perpendicular direction nde1 (1='d', 2='e')."""
    nde2 = 3 - nde1
    comp = vccde[..., nde1]
    acomp = comp.abs()
    vcmx = torch.where(valid, acomp, 0.0).amax(dim=1)
    dlm = 0.5 * (dl + dln)
    cosang = vccde[..., 0]
    d01 = dl01[:, None]
    dl4wt = torch.sqrt(torch.clamp(
        dlm * dlm + d01 * d01 - 2.0 * dlm * d01 * cosang, min=0.0))
    omwt = torch.where(valid, acomp * dl4wt, 0.0)
    dsum = omwt.sum(dim=1) * (1.0 + 1e-10)
    omwt = torch.where(valid, (dsum[:, None] - omwt) * acomp, 0.0)
    bd = omwt * torch.sign(comp)
    dsum2 = (omwt * acomp).sum(dim=1)
    bd = bd / torch.clamp(dsum2, min=_TINY)[:, None]
    acd = (bd * vccde[..., 0]).sum(dim=1)
    aed = (bd * vccde[..., nde2]).sum(dim=1)
    if vcthresh > 0.0:
        fatten = torch.where(vcmx < vcthresh, vcmx / vcthresh, 1.0)
        acd, aed, bd = acd * fatten, aed * fatten, bd * fatten[:, None]
    return acd, torch.ones_like(acd), aed, bd


def _abhats(vc, vn01, dl, dln, ck, valid, il01_oh, allhc, ar, dl01,
            vcthresh):
    """Vectorized abhats (Xt3dAlgorithm.f90:127-265) for one side of every
    interface at once.  Shapes: vc [E,K,3], vn01 [E,3], ck [E,3,3]."""
    vcc = (vc * il01_oh[..., None]).sum(dim=1)                      # [E,3]
    cmp = _dot3(vc, vcc[:, None, :])                                 # [E,K]
    acmp = torch.where(valid, cmp.abs(), 2.0)
    iml = torch.argmin(acmp, dim=1, keepdim=True)
    acmpmn = torch.gather(acmp, 1, iml)[:, 0]
    found = acmpmn < (1.0 - 1e-10)
    cmpmn = torch.gather(cmp, 1, iml)[:, 0]
    vcmax = torch.gather(vc, 1, iml[:, :, None].expand(-1, 1, 3))[:, 0, :]
    dnm = torch.sqrt(torch.clamp(1.0 - cmpmn * cmpmn, min=_TINY))
    vcd = (vcmax - cmpmn[:, None] * vcc) / dnm[:, None]
    vce = torch.linalg.cross(vcc, vcd, dim=-1)
    rmat = torch.stack([vcc, vcd, vce], dim=-1)                      # [E,3,3]
    # vccde[e,k,d] = Σ_c vc[e,k,c] rmat[e,c,d]
    vccde = torch.stack([_dot3(vc, rmat[:, None, :, dd]) for dd in range(3)],
                        dim=-1)
    acd, add, aed, bd = _abwts(vccde, 1, valid, dl, dln, dl01, vcthresh)
    iscomp = (valid & (vccde[..., 2].abs() > 1e-10)).any(dim=1)
    ace0, aee0, ade0, be0 = _abwts(vccde, 2, valid, dl, dln, dl01, vcthresh)
    del vccde
    use_e = (~allhc) & iscomp
    ace = torch.where(use_e, ace0, 0.0)
    aee = torch.where(use_e, aee0, 1.0)
    ade = torch.where(use_e, ade0, 0.0)
    be = torch.where(use_e[:, None], be0, 0.0)
    determ = add * aee - ade * aed
    oodet = 1.0 / torch.where(determ.abs() > _TINY, determ, 1.0)
    alphad = (acd * aee - ace * aed) * oodet
    alphae = (ace * add - acd * ade) * oodet
    betad = (bd * aee[:, None] - be * aed[:, None]) * oodet[:, None]
    betae = (be * add[:, None] - bd * ade[:, None]) * oodet[:, None]
    # vnck[e,d] = Σ_c vn01[e,c] ck[e,c,d]; sigma[e,d] = Σ_c vnck[e,c] rmat
    vnck = torch.stack([_dot3(vn01, ck[:, :, dd]) for dd in range(3)], dim=-1)
    sigma = torch.stack([_dot3(vnck, rmat[:, :, dd]) for dd in range(3)],
                        dim=-1)
    ahat_f = (sigma[:, 0] - sigma[:, 1] * alphad
              - sigma[:, 2] * alphae) / dl01
    bhat_f = torch.where(valid,
                         (sigma[:, 1, None] * betad
                          + sigma[:, 2, None] * betae)
                         / torch.clamp(dl + dln, min=_TINY), 0.0)
    sigma1_nf = _dot3(vnck, vcc)
    ahat = torch.where(found, ahat_f, sigma1_nf / dl01)
    bhat = torch.where(found[:, None], bhat_f, 0.0)
    return ahat * ar, bhat * ar[:, None]


def _sill(d: Xt3dData, thkn, thkm):
    """Staggered connections: the thicknesses cut to the shared sill."""
    n, m = d.edge_n, d.edge_m
    stag = d.ihc_e == 2
    sill_top = torch.minimum(d.top[n], d.top[m])
    sill_bot = torch.maximum(d.bot[n], d.bot[m])
    tpn = d.bot[n] + thkn
    tpm = d.bot[m] + thkm
    thkn = torch.where(
        stag, torch.clamp(torch.minimum(tpn, sill_top) - sill_bot, min=0.0),
        thkn)
    thkm = torch.where(
        stag, torch.clamp(torch.minimum(tpm, sill_top) - sill_bot, min=0.0),
        thkm)
    return thkn, thkm


def _areas(d: Xt3dData, sat):
    """Interfacial areas, non-Newton branch (xt3d_areas,
    Xt3dInterface.f90:1300-1378)."""
    n, m = d.edge_n, d.edge_m
    thksatn, thksatm = _sill(d, sat[n] * (d.top[n] - d.bot[n]),
                             sat[m] * (d.top[m] - d.bot[m]))
    vert = d.ihc_e == 0
    ar01 = torch.where(vert, d.hwva_e, d.hwva_e * thksatn)
    ar10 = torch.where(vert, d.hwva_e, d.hwva_e * thksatm)
    return ar01, ar10


def xt3d_chats(d: Xt3dData, ibound, sat, areas=None):
    """chat01 [E], chati0 [E,K], chat1j [E,K] (qconds,
    Xt3dAlgorithm.f90:47-123) for every interface at once.
    ``areas``: optional (ar01, ar10) override (Newton unit-area pass)."""
    K = d.max_degree
    n, m = d.edge_n, d.edge_m
    act = ibound != 0
    ar01, ar10 = _areas(d, sat) if areas is None else areas
    oh = torch.arange(K, device=n.device)[None, :]
    oh_n = oh == d.k_nm[:, None]
    oh_m = oh == d.k_mn[:, None]

    def side(cell, oh_c, ar, k_slot):
        valid = d.valid0[cell] & act[d.nbr[cell]] & ~oh_c
        dl_c = d.dl[cell]
        dl01 = torch.gather(dl_c, 1, k_slot[:, None])[:, 0]
        vn01 = d.vn[cell, k_slot]
        return _abhats(d.vc[cell], vn01, dl_c, d.dln[cell], d.ck[cell],
                       valid, oh_c, d.allhc[cell], ar, dl01, d.vcthresh)

    ahat0, bhat0 = side(n, oh_n, ar01, d.k_nm)
    ahat1, bhat1 = side(m, oh_m, ar10, d.k_mn)
    denom = ahat0 + ahat1
    wght1 = torch.where(denom.abs() > 1e-40, ahat0 / denom, 1.0)
    wght0 = 1.0 - wght1
    live = (act[n] & act[m] & (ar01 > 0.0)).to(ahat0.dtype)
    chat01 = wght1 * ahat1 * live
    chati0 = wght0[:, None] * bhat0 * live[:, None]
    chat1j = wght1[:, None] * bhat1 * live[:, None]
    return chat01, chati0, chat1j


def _neighbour_terms(d: Xt3dData, head, chati0, chat1j):
    """(qn, qm): the bhat terms of each side times the head differences
    to that side's neighbours."""
    n, m = d.edge_n, d.edge_m
    qn = (chati0 * (head[d.nbr[n]] - head[n][:, None])).sum(dim=1)
    qm = (chat1j * (head[d.nbr[m]] - head[m][:, None])).sum(dim=1)
    return qn, qm


def _fill(d: Xt3dData, head, chat01, chati0, chat1j):
    """Matrix/rhs fill from interface coefficients (the xt3d_amat* /
    xt3d_rhs family, modflow6_tpu xt3d.py:390-425); shared by the Picard
    and Newton assemblies.  Returns (diag, off flat [N*Ktot], rhs)."""
    N, K = d.nodes, d.max_degree
    ktot = d.nbr_ext.shape[1]
    dtype, device = chat01.dtype, chat01.device
    if d.ixt3d == 1:
        s0 = chati0.sum(dim=1)
        s1 = chat1j.sum(dim=1)
        diag = _row_sum(d, -chat01 - s0, -chat01 - s1)
        rhs = torch.zeros(N, dtype=dtype, device=device)
        # depth-1 columns: the interface's own coefficient at its slot,
        # then the bhat terms of every half-edge of the row at its
        # neighbours' slots (reference lines 405-411)
        own = torch.zeros(N * K, dtype=dtype, device=device)
        own[d.slot_nm] = chat01 + s1
        own[d.slot_mn] = chat01 + s0
        bh = torch.zeros((N * K, K), dtype=dtype, device=device)
        bh[d.slot_nm] = chati0
        bh[d.slot_mn] = chat1j
        depth1 = own.view(N, K) + bh.view(N, K, K).sum(dim=1)
        del own, bh
        off = torch.zeros((N, ktot), dtype=dtype, device=device)
        off[:, :K] = depth1
        # the cross terms through the neighbours' neighbours (412-415)
        cross = -torch.cat([chat1j.reshape(-1), chati0.reshape(-1)])
        off = d.cross_plan.add(off.view(-1), cross)
        return diag, off, rhs
    off = torch.zeros(N * K, dtype=dtype, device=device)
    off[d.slot_nm] = chat01
    off[d.slot_mn] = chat01
    diag = _row_sum(d, -chat01, -chat01)
    # xt3d_rhs: move perpendicular terms to the right-hand side
    t_n, t_m = _neighbour_terms(d, head, chati0, chat1j)
    rhs = _row_sum(d, -t_n + t_m, t_n - t_m)
    return diag, off, rhs


def assemble(d: Xt3dData, head, ibound, sat):
    """(diag, off, rhs) XT3D contributions (xt3d_fc assembly).

    Full mode returns off over the extended table [N, K+K2]; RHS mode over
    the depth-1 table with the neighbour terms moved to rhs."""
    chat01, chati0, chat1j = xt3d_chats(d, ibound, sat)
    diag, off, rhs = _fill(d, head, chat01, chati0, chat1j)
    return diag, off.view(d.nodes, -1), rhs


def _areas_newton(d: Xt3dData, sat, head):
    """Newton-branch interfacial areas (xt3d_areas inewton path,
    Xt3dInterface.f90:1318-1351): mean full-saturation thickness area,
    then upstream-saturation scaling; ar10 = ar01."""
    n, m = d.edge_n, d.edge_m
    thkn, thkm = _sill(d, d.top[n] - d.bot[n], d.top[m] - d.bot[m])
    vert = d.ihc_e == 0
    ar_full = torch.where(vert, d.hwva_e, d.hwva_e * 0.5 * (thkn + thkm))
    sat_up = torch.where(head[m] < head[n], sat[n], sat[m])
    ar_act = torch.where(vert, ar_full, ar_full * sat_up)
    return ar_full, ar_act


def assemble_newton(d: Xt3dData, head, ibound, sat, icelltype,
                    add_fn: bool = True):
    """Newton XT3D system (xt3d_fc inewton branch + xt3d_fn,
    Xt3dInterface.f90:440-470 + 693-793).

    Coefficients are computed at unit interface area, the saturated flow
    qsat = q(unit)·area(full saturation) is saved per connection, the
    matrix fill uses area(full)·sat(upstream), and the Newton terms add
    qsat·∂sat/∂h(upstream) on the upstream column with the matching rhs
    shift.  ``add_fn=False`` gives the residual-consistent system
    without the Jacobian terms (sln_buildsystem inewton=0 role)."""
    N = d.nodes
    n, m = d.edge_n, d.edge_m
    ar_full, ar_act = _areas_newton(d, sat, head)
    ones = torch.ones_like(ar_full)
    chat01u, chati0u, chat1ju = xt3d_chats(d, ibound, sat,
                                           areas=(ones, ones))
    hn, hm = head[n], head[m]
    qn, qm = _neighbour_terms(d, head, chati0u, chat1ju)
    qsat = (chat01u * (hm - hn) + qn - qm) * ar_full
    chat01 = chat01u * ar_act
    chati0 = chati0u * ar_act[:, None]
    chat1j = chat1ju * ar_act[:, None]
    diag, off, rhs = _fill(d, head, chat01, chati0, chat1j)
    if add_fn:
        up_is_n = hm < hn
        up = torch.where(up_is_n, n, m)
        stag = d.ihc_e == 2
        topup = torch.where(stag, torch.minimum(d.top[n], d.top[m]),
                            d.top[up])
        botup = torch.where(stag, torch.maximum(d.bot[n], d.bot[m]),
                            d.bot[up])
        hup = head[up]
        derv = quadratic_saturation_derivative(topup, botup, hup)
        skip = (icelltype[up] == 0) & (d.ixt3d == 1)
        act = (ibound[n] != 0) & (ibound[m] != 0) & ~skip
        term = torch.where(act, qsat * derv, 0.0)
        ktot = d.nbr_ext.shape[1]
        # (n, m) and (m, n) entries are one per interface: plain stores
        flat_nm = n * ktot + d.k_nm
        flat_mn = m * ktot + d.k_mn
        off[flat_mn] += torch.where(up_is_n, -term, 0.0)
        off[flat_nm] += torch.where(up_is_n, 0.0, term)
        diag = diag + _row_sum(d, torch.where(up_is_n, term, 0.0),
                               torch.where(up_is_n, 0.0, -term))
        rhs = rhs + _row_sum(d, term * hup, -term * hup)
    return diag, off.view(N, -1), rhs


def edge_flows(d: Xt3dData, head, ibound, sat, newton=False):
    """Per-edge flow q_nm (positive into n) for budget/flowja output
    (xt3d_flowja; the same expression as the Newton qnm in
    xt3d_fc:455-465).  ``newton`` switches to the upstream-saturation
    area convention so budgets match the Newton system."""
    n, m = d.edge_n, d.edge_m
    if newton:
        _, ar_act = _areas_newton(d, sat, head)
        chat01, chati0, chat1j = xt3d_chats(d, ibound, sat,
                                            areas=(ar_act, ar_act))
    else:
        chat01, chati0, chat1j = xt3d_chats(d, ibound, sat)
    qn, qm = _neighbour_terms(d, head, chati0, chat1j)
    return chat01 * (head[m] - head[n]) + qn - qm
