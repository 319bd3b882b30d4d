"""NPF: node-property-flow options, arrays, saturation, the Newton terms,
the Newton under-relaxation and the wetting/drying sweep.

Port of the parts of modflow6_tpu/models/gwf/npf.py that the structured
slice runs (reference gwf-npf.f90 npf_cf / thksat / calc_initial_sat,
npf_fn :578-698, npf_nur :705-741, sgwf_npf_wetdry + rewet_check).  The
reference walks an edge list and scatters with ``.at[].add``; this package
keeps no edge list on the device.  ``newton_terms`` and ``wetdry_update``
write the same per-connection terms on the three structured planes (x, y,
z faces) with sliced fields, as ``npf_structured`` does for the
conductances.  The edge-based ``compute_condsat`` and ``assemble`` belong
to the unstructured slice and are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ...constants import DHDRY, DONE, DZERO
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
    """Structured-only topology: the 7-point stencil needs only the shape."""

    grid_shape: tuple  # (nlay, nrow, ncol)

    @property
    def nodes(self) -> int:
        nlay, nrow, ncol = self.grid_shape
        return nlay * nrow * ncol


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
    """Per-cell NPF properties (tensors on the model's device)."""

    icelltype: torch.Tensor  # i32[N]
    k11: torch.Tensor        # f64[N]
    k22: torch.Tensor        # f64[N]
    k33: torch.Tensor        # f64[N]
    top: torch.Tensor        # f64[N]
    bot: torch.Tensor        # f64[N]


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
