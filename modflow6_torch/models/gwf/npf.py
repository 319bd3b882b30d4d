"""NPF: node-property-flow options, arrays, saturation, the conductances
and their assembly, the Newton terms, the Newton under-relaxation and the
wetting/drying sweep.

Port of modflow6_tpu/models/gwf/npf.py (reference gwf-npf.f90 npf_cf /
thksat / calc_initial_sat, calc_condsat :1950, hy_eff :2280, npf_fc
:474-574, npf_fn :578-698, npf_nur :705-741, npf_cq :745-771,
sgwf_npf_wetdry + rewet_check; hyeff HGeoUtil.f90:29-108).

Two forms live here.  The general form (``edge_hy``, ``compute_condsat``,
``edge_conductance``, ``assemble``, ``newton_terms_edges``,
``wetdry_update_edges``, ``flowja``) walks the edge list of a full
``DeviceTopology`` as the reference does, for DISV and DISU grids and for a
DIS grid with rotated anisotropy.  The plane form (``newton_terms``,
``wetdry_update``; the conductances are in ``npf_structured``) writes the
same per-connection terms on the three structured planes (x, y, z faces)
with sliced fields, for a DIS model on the structured path, whose
``DeviceTopology`` is the bare grid shape and holds no edge table.

Index tensors (``edge_n``, ``edge_m``, ``nbr``, ``slot_nm``, ``slot_mn``)
are int64 on the device: ``x[nbr]`` takes int32 too, indexed stores and
``scatter_`` do not.  ``nbr`` is [N, K] contiguous.

The reference adds per-edge terms to per-cell arrays with
``.at[n].add``, whose indices repeat.  ``index_add_`` on CUDA would do that
with atomics, in an order that changes from run to run.  Here every such
sum goes through the ELL table instead (``_row_sum``): each (row, slot)
entry belongs to one edge, so plain indexed stores fill an [N*K] buffer and
a sum over K gives the per-cell value, in the same order every run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...constants import (C3D_STAGGERED, C3D_VERTICAL, DHDRY, DONE, DZERO)
from ...ops import conductance as condops
from ...ops.smoothing import (quadratic_saturation,
                              quadratic_saturation_derivative)

_ALL = slice(None)
# per plane: (n-side slices, m-side slices, slot of (n,m) in row n, slot of
# (m,n) in row m, vertical?) with slots [E, W, N, S, U, D]; n is the
# lower-numbered cell of each connection (west / north / above of m)
_PLANES = (
    ((_ALL, _ALL, slice(None, -1)), (_ALL, _ALL, slice(1, None)), 0, 1, False),
    ((_ALL, slice(None, -1), _ALL), (_ALL, slice(1, None), _ALL), 3, 2, False),
    ((slice(None, -1), _ALL, _ALL), (slice(1, None), _ALL, _ALL), 5, 4, True),
)


@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """Connection topology on the model's device (see
    discretization.Topology).  A model on the structured path holds the
    grid shape alone: the 7-point stencil reads no edge table, and at
    millions of cells the tables are hundreds of megabytes."""

    grid_shape: tuple = None  # (nlay, nrow, ncol) → the stencil kernel
    edge_n: Optional[torch.Tensor] = None   # i64[E]
    edge_m: Optional[torch.Tensor] = None   # i64[E]
    ihc: Optional[torch.Tensor] = None      # i32[E]
    cl1: Optional[torch.Tensor] = None      # f64[E]
    cl2: Optional[torch.Tensor] = None      # f64[E]
    hwva: Optional[torch.Tensor] = None     # f64[E]
    anglex: Optional[torch.Tensor] = None   # f64[E]
    nbr: Optional[torch.Tensor] = None      # i64[N, K]
    slot_nm: Optional[torch.Tensor] = None  # i64[E] flat ELL slot of (n,m)
    slot_mn: Optional[torch.Tensor] = None  # i64[E] flat ELL slot of (m,n)

    @property
    def nodes(self) -> int:
        if self.nbr is not None:
            return self.nbr.shape[0]
        nlay, nrow, ncol = self.grid_shape
        return nlay * nrow * ncol

    @property
    def max_degree(self) -> int:
        return 6 if self.nbr is None else self.nbr.shape[1]

    @staticmethod
    def from_host(topo, device) -> "DeviceTopology":
        """The edge tables of a host ``Topology`` (or of a mapping of its
        arrays) as tensors on ``device``."""
        get = topo.get if isinstance(topo, dict) else (
            lambda key, default=None: getattr(topo, key, default))

        def tensor(key, dtype):
            return torch.as_tensor(get(key), device=device).to(dtype)

        return DeviceTopology(
            edge_n=tensor("edge_n", torch.int64),
            edge_m=tensor("edge_m", torch.int64),
            ihc=tensor("ihc", torch.int32),
            cl1=tensor("cl1", torch.float64),
            cl2=tensor("cl2", torch.float64),
            hwva=tensor("hwva", torch.float64),
            anglex=tensor("anglex", torch.float64),
            nbr=tensor("nbr", torch.int64).contiguous(),
            slot_nm=tensor("slot_nm", torch.int64),
            slot_mn=tensor("slot_mn", torch.int64),
            grid_shape=(None if get("grid_shape") is None
                        else tuple(int(v) for v in get("grid_shape"))))


def _row_sum(dtopo: DeviceTopology, val_n, val_m, fill=0.0, reduce="sum"):
    """Per-cell reduction of per-edge values over each cell's connections:
    ``val_n`` belongs to the row of edge_n, ``val_m`` to the row of edge_m.
    The values are stored at the edges' ELL slots, which are unique, and
    reduced over K: the reference's ``.at[n].add`` (``.at[n].max``) with
    no atomics."""
    N, K = dtopo.nodes, dtopo.max_degree
    buf = torch.full((N * K,), fill, dtype=val_n.dtype, device=val_n.device)
    buf[dtopo.slot_nm] = val_n
    buf[dtopo.slot_mn] = val_m
    buf = buf.view(N, K)
    return buf.sum(dim=1) if reduce == "sum" else buf.amax(dim=1)


@dataclasses.dataclass(frozen=True)
class NpfOptions:
    """Static NPF formulation flags (the reference package's fields)."""

    icellavg: int = 0       # CCOND_* averaging method
    inewton: int = 0        # Newton-Raphson formulation
    ivarcv: int = 0         # VARIABLECV
    idewatcv: int = 0       # VARIABLECV DEWATERED
    iperched: int = 0       # PERCHED
    ik22: bool = False      # K22 provided
    ik33: bool = False      # K33 provided
    iangle1: bool = False
    iangle2: bool = False
    iangle3: bool = False
    thickstrt: bool = False
    satomega: float = 0.0   # set to 1e-6 when Newton


@dataclasses.dataclass(frozen=True)
class NpfArrays:
    """Per-cell NPF properties and the per-edge saturated conductance
    (tensors on the model's device).  A model on the structured path has
    no angles and keeps its saturated conductance on the planes
    (``GwfModel.condsat3``)."""

    icelltype: torch.Tensor  # i32[N]
    k11: torch.Tensor        # f64[N]
    k22: torch.Tensor        # f64[N]
    k33: torch.Tensor        # f64[N]
    top: torch.Tensor        # f64[N]
    bot: torch.Tensor        # f64[N]
    angle1: Optional[torch.Tensor] = None   # f64[N] radians
    angle2: Optional[torch.Tensor] = None   # f64[N]
    angle3: Optional[torch.Tensor] = None   # f64[N]
    condsat: Optional[torch.Tensor] = None  # f64[E]


def _hyeff(k11, k22, k33, ang1, ang2, ang3, vg1, vg2, vg3, iavgmeth=0):
    """Effective K along a unit direction on the conductivity ellipsoid
    (reference HGeoUtil.f90 hyeff)."""
    s1, c1 = torch.sin(ang1), torch.cos(ang1)
    s2, c2 = torch.sin(ang2), torch.cos(ang2)
    s3, c3 = torch.sin(ang3), torch.cos(ang3)
    # rows of the rotation matrix applied to vg → ellipse-local components
    ve1 = c1 * c2 * vg1 + s1 * c2 * vg2 + s2 * vg3
    ve2 = ((c1 * s2 * s3 - s1 * c3) * vg1 + (s1 * s2 * s3 + c1 * c3) * vg2
           + (-c2 * s3) * vg3)
    ve3 = ((-c1 * s2 * c3 - s1 * s3) * vg1 + (-s1 * s2 * c3 + c1 * s3) * vg2
           + (c2 * c3) * vg3)
    if iavgmeth == 0:
        dnum = torch.ones_like(ve1)
        d1, d2, d3 = ve1**2, ve2**2, ve3**2
        nz1, nz2, nz3 = ve1 != DZERO, ve2 != DZERO, ve3 != DZERO
        f1 = torch.where(nz1, k11, DONE)
        f2 = torch.where(nz2, k22, DONE)
        f3 = torch.where(nz3, k33, DONE)
        dnum = dnum * f1
        d2 = d2 * f1
        d3 = d3 * f1
        dnum = dnum * f2
        d1 = d1 * f2
        d3 = d3 * f2
        dnum = dnum * f3
        d1 = d1 * f3
        d2 = d2 * f3
        denom = d1 + d2 + d3
        return torch.where(denom > DZERO,
                           dnum / torch.where(denom > 0, denom, DONE), DZERO)
    return ve1**2 * k11 + ve2**2 * k22 + ve3**2 * k33


def edge_hy(dtopo: DeviceTopology, opts: NpfOptions, arrays: NpfArrays):
    """Per-edge effective hydraulic conductivity (hkn, hkm) for both cells.

    Matches hy_eff (gwf-npf.f90:2280): plain k11 (horizontal) / k33
    (vertical) unless anisotropy options require ellipsoid projection.
    """
    is_vert = dtopo.ihc == C3D_VERTICAL

    def one_side(idx):
        k11, k22, k33 = arrays.k11[idx], arrays.k22[idx], arrays.k33[idx]
        zero = torch.zeros_like(k11)
        one = torch.ones_like(k11)
        hy_v = k33
        hy_h = k11
        if opts.iangle2:
            a1 = arrays.angle1[idx] if opts.iangle1 else zero
            a2 = arrays.angle2[idx]
            a3 = arrays.angle3[idx] if opts.iangle3 else zero
            hy_v = _hyeff(k11, k22, k33, a1, a2, a3, zero, zero, one)
        if opts.ik22:
            vg1 = torch.cos(dtopo.anglex)
            vg2 = torch.sin(dtopo.anglex)
            a1 = arrays.angle1[idx] if opts.iangle1 else zero
            a2 = arrays.angle2[idx] if opts.iangle2 else zero
            a3 = arrays.angle3[idx] if opts.iangle3 else zero
            hy_h = _hyeff(k11, k22, k33, a1, a2, a3, vg1, vg2, zero)
        return torch.where(is_vert, hy_v, hy_h)

    return one_side(dtopo.edge_n), one_side(dtopo.edge_m)


def initial_sat(opts: NpfOptions, arrays: NpfArrays, strt, ibound):
    """Saturation used for condsat precompute: 1, or strt-based with THICKSTRT
    for confined-by-thickstrt cells (reference calc_initial_sat)."""
    ones = torch.ones_like(arrays.top)
    if not opts.thickstrt:
        return ones
    use_strt = (ibound != 0) & (arrays.icelltype < 0)
    return torch.where(
        use_strt, quadratic_saturation(arrays.top, arrays.bot, strt, 0.0),
        ones)


def compute_saturation(opts: NpfOptions, arrays: NpfArrays, head, ibound):
    """npf_cf: per-cell wetted fraction for convertible cells
    (reference gwf-npf.f90:444-471 + thksat :775-794)."""
    top, bot = arrays.top, arrays.bot
    if opts.inewton:
        sat = quadratic_saturation(top, bot, head, opts.satomega)
    else:
        thick = torch.where(top != bot, top - bot, DONE)
        sat = torch.where(head >= top, DONE, (head - bot) / thick)
    sat = torch.where(ibound == 0, DZERO, sat)
    return torch.where(arrays.icelltype != 0, sat, DONE)


def compute_condsat(dtopo: DeviceTopology, opts: NpfOptions, arrays: NpfArrays,
                    sat0):
    """Saturated conductance per edge (reference calc_condsat
    gwf-npf.f90:1950).  ``sat0`` is the initial saturation from
    :func:`initial_sat`."""
    n, m = dtopo.edge_n, dtopo.edge_m
    hkn, hkm = edge_hy(dtopo, opts, arrays)
    topn, topm = arrays.top[n], arrays.top[m]
    botn, botm = arrays.bot[n], arrays.bot[m]
    satn, satm = sat0[n], sat0[m]
    is_vert = dtopo.ihc == C3D_VERTICAL

    # vertical: vcond at full (initial) saturation
    bovk1 = satn * (topn - botn) * 0.5 / torch.where(hkn != 0, hkn, DONE)
    bovk2 = satm * (topm - botm) * 0.5 / torch.where(hkm != 0, hkm, DONE)
    denom = bovk1 + bovk2
    csat_v = torch.where(denom != DZERO,
                         dtopo.hwva / torch.where(denom != 0, denom, DONE),
                         DZERO)

    # horizontal: condmean at initial saturation (staggered-aware)
    is_stag = dtopo.ihc == C3D_STAGGERED
    thksatn = torch.where(
        is_stag, condops.staggered_thkfrac(topn, botn, satn, topm, botm),
        satn * (topn - botn))
    thksatm = torch.where(
        is_stag, condops.staggered_thkfrac(topm, botm, satm, topn, botn),
        satm * (topm - botm))
    csat_h = condops.condmean(hkn, hkm, thksatn, thksatm, dtopo.cl1,
                              dtopo.cl2, dtopo.hwva, opts.icellavg)
    return torch.where(is_vert, csat_v, csat_h)


def edge_conductance(dtopo: DeviceTopology, opts: NpfOptions,
                     arrays: NpfArrays, head, ibound, sat):
    """Per-edge conductance (the body of npf_fc's connection loop)."""
    n, m = dtopo.edge_n, dtopo.edge_m
    hkn, hkm = edge_hy(dtopo, opts, arrays)
    hn, hm = head[n], head[m]
    ibdn, ibdm = ibound[n], ibound[m]
    ictn, ictm = arrays.icelltype[n], arrays.icelltype[m]
    topn, topm = arrays.top[n], arrays.top[m]
    botn, botm = arrays.bot[n], arrays.bot[m]
    satn, satm = sat[n], sat[m]

    cond_h = condops.hcond(
        ibdn, ibdm, ictn, ictm, opts.inewton, dtopo.ihc, opts.icellavg,
        arrays.condsat, hn, hm, satn, satm, hkn, hkm,
        topn, topm, botn, botm, dtopo.cl1, dtopo.cl2, dtopo.hwva)
    cond_v = condops.vcond(
        ibdn, ibdm, ictn, ictm, opts.ivarcv, opts.idewatcv,
        arrays.condsat, hn, hm, hkn, hkm, satn, satm,
        topn, topm, botn, botm, dtopo.hwva)
    return torch.where(dtopo.ihc == C3D_VERTICAL, cond_v, cond_h)


def assemble(dtopo: DeviceTopology, opts: NpfOptions, arrays: NpfArrays,
             head, ibound, sat):
    """npf_fc: conductances → (diag[N], off[N,K], rhs[N], cond[E]).

    The perched correction (iperched) moves the vertical term for
    dewatered underlying cells to the rhs, per gwf-npf.f90:520-545.
    """
    N, K = dtopo.nodes, dtopo.max_degree
    n, m = dtopo.edge_n, dtopo.edge_m
    cond = edge_conductance(dtopo, opts, arrays, head, ibound, sat)

    # symmetric fill: off(n,m)=off(m,n)=cond, diag -= cond at both ends
    off_edge_nm = cond
    diag_m = -cond
    if opts.iperched:
        perched = ((dtopo.ihc == C3D_VERTICAL) & (arrays.icelltype[m] != 0)
                   & (head[m] < arrays.top[m]))
        # a perched edge keeps (m,n) = +cond and the diagonal of n
        off_edge_nm = torch.where(perched, DZERO, cond)
        diag_m = torch.where(perched, DZERO, -cond)
        rhs_n = torch.where(perched, -cond * arrays.bot[n], DZERO)
        rhs = _row_sum(dtopo, rhs_n, -rhs_n)
    else:
        rhs = torch.zeros(N, dtype=cond.dtype, device=cond.device)

    off = torch.zeros(N * K, dtype=cond.dtype, device=cond.device)
    off[dtopo.slot_nm] = off_edge_nm
    off[dtopo.slot_mn] = cond
    diag = _row_sum(dtopo, -cond, diag_m)
    return diag, off.view(N, K), rhs, cond


def flowja(dtopo: DeviceTopology, cond, head):
    """npf_cq: inter-cell flow for each half-edge, positive into cell n
    (reference gwf-npf.f90:745-771: qnm = cond*(hm-hn))."""
    return cond * (head[dtopo.edge_m] - head[dtopo.edge_n])


def newton_terms_edges(dtopo: DeviceTopology, opts: NpfOptions,
                       arrays: NpfArrays, head, ibound, diag, off, rhs):
    """npf_fn on the edge list: add the Newton saturation-derivative terms
    (gwf-npf.f90:578-698; modflow6_tpu/models/gwf/npf.py:298-339)."""
    n, m = dtopo.edge_n, dtopo.edge_m
    hn, hm = head[n], head[m]
    is_vert_constcv = (dtopo.ihc == C3D_VERTICAL) & (opts.ivarcv == 0)

    ups_is_n = hm < hn
    iups = torch.where(ups_is_n, n, m)
    h_up = torch.where(ups_is_n, hn, hm)
    h_dn = torch.where(ups_is_n, hm, hn)
    ict_up = arrays.icelltype[iups]

    is_stag = dtopo.ihc == C3D_STAGGERED
    topup = torch.where(is_stag,
                        torch.minimum(arrays.top[n], arrays.top[m]),
                        arrays.top[iups])
    botup = torch.where(is_stag,
                        torch.maximum(arrays.bot[n], arrays.bot[m]),
                        arrays.bot[iups])

    consterm = -arrays.condsat * (h_up - h_dn)
    derv = quadratic_saturation_derivative(topup, botup, h_up, opts.satomega)
    active = (ict_up != 0) & ~is_vert_constcv
    term = torch.where(active, consterm * derv, DZERO)
    term = torch.where(ups_is_n, term, -term)

    # rhs: += term * h_up on row n, -= on row m
    rhs_add = torch.where(active, term * h_up, DZERO)
    rhs = rhs + _row_sum(dtopo, rhs_add, -rhs_add)
    # iups == n: diag[n] += term ; off(m,n) += -term  (only if ibound[m] > 0)
    # iups == m: off(n,m) += term (if ibound[n] > 0) ; diag[m] += -term
    diag = diag + _row_sum(
        dtopo, torch.where(active & ups_is_n, term, DZERO),
        torch.where(active & ~ups_is_n, -term, DZERO))
    N, K = dtopo.nodes, dtopo.max_degree
    off_add = torch.zeros(N * K, dtype=off.dtype, device=off.device)
    off_add[dtopo.slot_mn] = torch.where(
        active & ups_is_n & (ibound[m] > 0), -term, DZERO)
    off_add[dtopo.slot_nm] = torch.where(
        active & ~ups_is_n & (ibound[n] > 0), term, DZERO)
    return diag, off + off_add.view(N, K), rhs


def newton_terms(dtopo: DeviceTopology, opts: NpfOptions, arrays: NpfArrays,
                 head, ibound, diag, off, rhs, condsat3, exists):
    """npf_fn: add Newton saturation-derivative terms (gwf-npf.f90:578-698).

    Port of the reference's edge form (modflow6_tpu/models/gwf/npf.py
    298-339) on planes.  Per plane, with n the lower-numbered and m the
    higher-numbered cell of each face: the upstream choice and the
    derivative term are reference lines 301-323; the two rhs adds are lines
    326-327 (rows n and m); the diagonal adds lines 333-334; the
    off-diagonal adds lines 335-338 go to slot (m,n) of row m (W, N or U)
    where n is upstream and to slot (n,m) of row n (E, S or D) where m is.
    The x plane covers the reference's edges with direction 0, the y plane
    direction 1, the z plane the vertical edges (``ihc == 0``), which add
    nothing unless VARIABLECV is set (line 303).  A structured grid has no
    vertically staggered connections, so lines 313-315 have no counterpart.
    ``exists`` ([N], non-zero where the cell has connections: idomain != 0)
    masks the
    faces for which the reference has no edge; ``condsat3`` is the
    saturated conductance on the planes.  A cell gets at most six terms,
    added in the fixed order x, y, z.
    """
    shape = dtopo.grid_shape
    h3 = head.reshape(shape)
    ib3 = ibound.reshape(shape)
    ex3 = (exists != 0).reshape(shape)
    ict3 = arrays.icelltype.reshape(shape)
    t3 = arrays.top.reshape(shape)
    b3 = arrays.bot.reshape(shape)
    diag3 = diag.reshape(shape).clone()
    rhs3 = rhs.reshape(shape).clone()
    c = off.reshape(shape + (6,)).clone()
    for (ns, ms, slot_nm, slot_mn, vertical), cond in zip(_PLANES, condsat3):
        if vertical and opts.ivarcv == 0:
            continue
        hn, hm = h3[ns], h3[ms]
        ups_is_n = hm < hn
        h_up = torch.where(ups_is_n, hn, hm)
        h_dn = torch.where(ups_is_n, hm, hn)
        ict_up = torch.where(ups_is_n, ict3[ns], ict3[ms])
        topup = torch.where(ups_is_n, t3[ns], t3[ms])
        botup = torch.where(ups_is_n, b3[ns], b3[ms])
        consterm = -cond * (h_up - h_dn)
        derv = quadratic_saturation_derivative(topup, botup, h_up,
                                               opts.satomega)
        active = (ict_up != 0) & ex3[ns] & ex3[ms]
        term = torch.where(active, consterm * derv, DZERO)
        term = torch.where(ups_is_n, term, -term)

        rhs_add = torch.where(active, term * h_up, DZERO)
        rhs3[ns] += rhs_add
        rhs3[ms] -= rhs_add
        diag3[ns] += torch.where(active & ups_is_n, term, DZERO)
        diag3[ms] += torch.where(active & ~ups_is_n, -term, DZERO)
        c[ms + (slot_mn,)] += torch.where(
            active & ups_is_n & (ib3[ms] > 0), -term, DZERO)
        c[ns + (slot_nm,)] += torch.where(
            active & ~ups_is_n & (ib3[ns] > 0), term, DZERO)
    return diag3.reshape(-1), c.reshape(-1, 6), rhs3.reshape(-1)


def under_relax(arrays: NpfArrays, ibound, x, xtemp, dx, bot_nur):
    """npf_nur: pull heads that dropped below cell bottoms back toward the
    bottom (gwf-npf.f90:705-741).  Returns (x, dx, applied_any, dxmax), the
    last two as 0-d tensors."""
    applies = (ibound >= 1) & (arrays.icelltype > 0) & (x < bot_nur)
    xx = xtemp * (1.0 - 0.9) + bot_nur * 0.9
    dxx = torch.where(applies, x - xx, DZERO)
    x = torch.where(applies, xx, x)
    dx = torch.where(applies, DZERO, dx)
    dxmax = dxx.take(torch.argmax(dxx.abs()))
    return x, dx, applies.any(), dxmax


# ----------------------------------------------------------- wetting/drying

def wetdry_update(dtopo, arrays, wetdry, exists, ibound, head, kiter,
                  iwetit=1, ihdwet=0, wetfct=1.0):
    """One wetting/drying sweep (sgwf_npf_wetdry + rewet_check).

    On the structured planes, for all cells at once:
    - rewetting (every ``iwetit`` outer iterations; ``kiter`` is a host
      int): a dry wettable cell (ibound 0, WETDRY ≠ 0) rewets when the
      cell BELOW it or, if WETDRY > 0, a horizontally adjacent cell is
      active with head ≥ bot + |WETDRY|; the rewetted head is
      bot + WETFCT·(hm − bot) (IHDWET=0, eq. 3a) or bot + WETFCT·|WETDRY|
      (eq. 3b), with hm the highest triggering neighbour head;
    - drying: active convertible cells with min(h, top) − bot ≤ 0 go
      inactive at head = DHDRY.

    Port of the reference's edge form (modflow6_tpu/models/gwf/npf.py
    363-409): per plane, ``cn`` (lines 389-390) is the lower-numbered cell
    rewetted by the higher one, ``cm`` (392-393) the reverse, which the z
    plane leaves out (the upper cell never wets the one below); the
    scatter-max of lines 394-396 becomes a running maximum over the
    planes.  ``exists`` ([N], non-zero where idomain != 0) masks faces without a
    connection.  Returns (ibound, head, changed), ``changed`` a 0-d bool
    tensor.
    """
    shape = dtopo.grid_shape
    bot, top = arrays.bot, arrays.top
    awd = wetdry.abs()
    h3 = head.reshape(shape)
    ib3 = ibound.reshape(shape)
    ex3 = (exists != 0).reshape(shape)
    wd3 = wetdry.reshape(shape)
    turnon3 = (bot + awd).reshape(shape)
    ninf = float("-inf")

    if kiter % iwetit == 0:
        hm_max = torch.full(shape, ninf, dtype=head.dtype, device=head.device)
        for ns, ms, _, _, vert in _PLANES:
            conn = ex3[ns] & ex3[ms]
            # n rewetted by m (below for vertical, or horizontal with wd>0)
            cn = (conn & (ib3[ns] == 0) & (wd3[ns] != 0.0) & (ib3[ms] > 0)
                  & (h3[ms] >= turnon3[ns]))
            if not vert:
                cn = cn & (wd3[ns] > 0.0)
            hm_max[ns] = torch.maximum(
                hm_max[ns], torch.where(cn, h3[ms], ninf))
            if vert:
                continue
            # m rewetted by n (horizontal only: n is ABOVE m on vertical
            # faces)
            cm = (conn & (ib3[ms] == 0) & (wd3[ms] != 0.0) & (ib3[ns] > 0)
                  & (h3[ns] >= turnon3[ms]) & (wd3[ms] > 0.0))
            hm_max[ms] = torch.maximum(
                hm_max[ms], torch.where(cm, h3[ns], ninf))
        hm_max = hm_max.reshape(-1)
        rewet = torch.isfinite(hm_max)
        h_wet = (bot + wetfct * (hm_max - bot) if ihdwet == 0
                 else bot + wetfct * awd)
        head = torch.where(rewet, h_wet, head)
        ibound = torch.where(rewet, 1, ibound)
        any_rewet = rewet.any()
    else:
        any_rewet = torch.zeros((), dtype=torch.bool, device=head.device)

    # drying (freshly rewetted heads sit above bot, so they survive)
    thick = torch.minimum(head, top) - bot
    dry = (ibound > 0) & (arrays.icelltype != 0) & (thick <= 0.0)
    head = torch.where(dry, DHDRY, head)
    ibound = torch.where(dry, 0, ibound)
    return ibound, head, any_rewet | dry.any()


def wetdry_update_edges(dtopo, arrays, wetdry, ibound, head, kiter,
                        iwetit=1, ihdwet=0, wetfct=1.0):
    """The wetting/drying sweep of :func:`wetdry_update` on the edge list
    (modflow6_tpu/models/gwf/npf.py:363-409): ``cn`` is the lower-numbered
    cell of an edge rewetted by the higher one (the cell below on a
    vertical edge), ``cm`` the reverse, horizontal edges only; the highest
    triggering neighbour head of a cell is a maximum over its ELL slots.
    Returns (ibound, head, changed), ``changed`` a 0-d bool tensor."""
    n, m = dtopo.edge_n, dtopo.edge_m
    bot, top = arrays.bot, arrays.top
    awd = wetdry.abs()
    ninf = float("-inf")

    if kiter % iwetit == 0:
        turnon = bot + awd
        vert = dtopo.ihc == C3D_VERTICAL    # edge (n, m): m is the deeper
        wdn, wdm = wetdry[n], wetdry[m]
        cn = ((ibound[n] == 0) & (wdn != 0.0) & (ibound[m] > 0)
              & (head[m] >= turnon[n]) & (vert | (wdn > 0.0)))
        cm = ((ibound[m] == 0) & (wdm != 0.0) & (ibound[n] > 0)
              & (head[n] >= turnon[m]) & (~vert & (wdm > 0.0)))
        hm_max = _row_sum(dtopo, torch.where(cn, head[m], ninf),
                          torch.where(cm, head[n], ninf), fill=ninf,
                          reduce="max")
        rewet = torch.isfinite(hm_max)
        h_wet = (bot + wetfct * (hm_max - bot) if ihdwet == 0
                 else bot + wetfct * awd)
        head = torch.where(rewet, h_wet, head)
        ibound = torch.where(rewet, 1, ibound)
        any_rewet = rewet.any()
    else:
        any_rewet = torch.zeros((), dtype=torch.bool, device=head.device)

    # drying (freshly rewetted heads sit above bot, so they survive)
    thick = torch.minimum(head, top) - bot
    dry = (ibound > 0) & (arrays.icelltype != 0) & (thick <= 0.0)
    head = torch.where(dry, DHDRY, head)
    ibound = torch.where(dry, 0, ibound)
    return ibound, head, any_rewet | dry.any()
