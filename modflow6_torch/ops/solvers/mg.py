"""Geometric multigrid V-cycle preconditioner for structured DIS systems.

Port of modflow6_tpu/ops/solvers/mg.py.  It plays the iteration-count-
cutting role of the reference program's ILU(0)/ILUT factorizations
(ImsLinearBase.f90:928-1042) with dense reshapes, pools and shifts on the
(nlay, nrow, ncol) stencil coefficient fields: no triangular solves and no
gathers.

Design (aggregation MG, cf. Notay's AGMG family):

- hierarchy: 2×2 aggregation in the (row, col) plane (semi-coarsening: the
  layer axis is kept, since nlay is small and vertical coupling stiff).
  A one-row cross-section with more than two layers, (nlay, 1, ncol), is
  viewed as (1, nlay, ncol), its up/down slots in the north/south places:
  the same memory, so the aggregation runs over (layer, column) and every
  level's product is the same stencil launch.  Every other grid is
  coarsened as before;
- transfer: piecewise-constant prolongation P (aggregate broadcast),
  restriction R = Pᵀ (aggregate sum), so the Galerkin coarse operator RAP
  of a 7-point stencil is again a 7-point stencil, computed exactly by
  pooling the fine coefficient fields;
- smoother: fixed-window Chebyshev on the Jacobi-scaled operator.  The CVFD
  matrix is an M-matrix (plus +1 identity rows), so Gershgorin gives
  λ(D⁻¹A) ⊆ [0, 2] on every level and no eigenvalue estimation is needed;
- coarsest level: a higher-order Chebyshev sweep.

The V-cycle is a fixed symmetric polynomial in A per level, hence a valid
CG preconditioner.

Every level's product y = A x goes through ``ops.stencil.bind_stencil7``,
bound once per level when the hierarchy is built: on CUDA tensors each
product of each level, fine or coarse, is one launch of the stencil kernel
(which takes any shape in float32 and float64), on CPU tensors the plain
version.  The reference's shape gate and its fallback to shifted
multiplies on levels that do not tile have no counterpart here.  An
application reads nothing on the host.  Each application is an
``mg_apply`` span, and each hierarchy built adds its levels to the
``mg_levels`` count and one to ``mg_builds`` (``utils.profiler``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...utils.profiler import count, span
from .. import stencil
from ..stencil import bind_stencil7

# fixed Chebyshev smoothing window for Jacobi-scaled CVFD stencils:
# Gershgorin bound λmax ≤ 2 (M-matrix rows) with margin; smooth the upper
# part of the spectrum, leave the low modes to the coarse grid
_LMAX = 2.05
_SMOOTH_LO = _LMAX / 4.0
_COARSE_LO = _LMAX / 64.0

# the slots [E, W, N, S, U, D] of a (1, nlay, ncol) view of a one-row
# section, taken from its own slots: up and down become north and south
_SECTION_SLOTS = [0, 1, 4, 5, 2, 3]


def section_view(shape):
    """The (1, nlay, ncol) view that MG coarsens a one-row section with
    more than two layers in, else None."""
    nlay, nrow, ncol = shape
    return (1, nlay, ncol) if nrow == 1 and nlay > 2 else None


def _matvec3(diag3, c, x3):
    """y = A x on dense stencil fields by six shifted multiply-adds: the
    plain version of a level's product.  Slot order [E, W, N, S, U, D]."""
    shape = tuple(diag3.shape)
    return stencil.spmv_structured(
        shape, diag3.reshape(-1), c.reshape(-1, 6),
        x3.reshape(-1)).reshape(shape)


def _level_matvec(diag3, c):
    """Per-level y = A x on [nlay, nrow, ncol] fields, bound once: the
    stencil kernel on CUDA tensors, the plain version on CPU tensors."""
    shape = tuple(diag3.shape)
    matvec = bind_stencil7(shape, diag3.reshape(-1).contiguous(),
                           c.reshape(-1, 6).contiguous())
    return lambda x3: matvec(x3.reshape(-1)).reshape(shape)


def _chebyshev_coefs(order, lo, hi):
    """(theta, [(c_d, c_r)]) of the Chebyshev recurrence on [lo, hi]."""
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta
    rho = 1.0 / sigma
    coefs = []
    for _ in range(order - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        coefs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new
    return theta, coefs


def _chebyshev(mv, inv, r3, z0, order, lo, hi):
    """z ≈ A⁻¹ r by Chebyshev iteration from initial guess z0 (None: zero)
    on the Jacobi-scaled operator with spectrum window [lo, hi]; ``inv`` is
    1/diag with 1 where the diagonal is zero."""
    theta, coefs = _chebyshev_coefs(order, lo, hi)
    if z0 is None:
        d = (inv * r3) / theta
        z = d
    else:
        d = (inv * (r3 - mv(z0))) / theta
        z = z0 + d
    for c_d, c_r in coefs:
        resid = inv * (r3 - mv(z))
        d = c_d * d + c_r * resid
        z = z + d
    return z


def _pad_even(a):
    """Zero-pad rows/cols of [nlay, nrow, ncol(, 6)] to even sizes."""
    nrow, ncol = a.shape[1:3]
    pr, pc = nrow % 2, ncol % 2
    if pr == 0 and pc == 0:
        return a
    # F.pad lists (before, after) pairs from the last axis backwards
    pad = (0, 0) * (a.ndim - 3) + (0, pc, 0, pr)
    return F.pad(a, pad)


def _coarsen(diag3, c):
    """Galerkin RAP for piecewise-constant 2×2 (row, col) aggregation.

    Coarse stencil entries are pooled sums of fine entries; the coarse
    diagonal additionally absorbs the intra-aggregate couplings.  Exact
    for general (including asymmetric Newton) stencils.
    """
    diag3 = _pad_even(diag3)
    c = _pad_even(c)
    nlay, nrow, ncol = diag3.shape
    nr, nc = nrow // 2, ncol // 2

    def pool(a):  # sum over each 2x2 aggregate
        return a.reshape(nlay, nr, 2, nc, 2).sum(dim=(2, 4))

    def split(a):  # [nlay, nr, 2, nc, 2]
        return a.reshape(nlay, nr, 2, nc, 2)

    cE, cW, cN, cS, cU, cD = (c[..., i] for i in range(6))
    # cross-aggregate couplings: east edges live on the right fine column
    # of the aggregate, west on the left, south on the bottom fine row, …
    cE_c = split(cE)[:, :, :, :, 1].sum(dim=2)
    cW_c = split(cW)[:, :, :, :, 0].sum(dim=2)
    cN_c = split(cN)[:, :, 0, :, :].sum(dim=3)
    cS_c = split(cS)[:, :, 1, :, :].sum(dim=3)
    cU_c = pool(cU)
    cD_c = pool(cD)
    # diagonal: pooled fine diagonals + intra-aggregate couplings
    intra = (split(cE)[:, :, :, :, 0].sum(dim=2)
             + split(cW)[:, :, :, :, 1].sum(dim=2)
             + split(cS)[:, :, 0, :, :].sum(dim=3)
             + split(cN)[:, :, 1, :, :].sum(dim=3))
    diag_c = pool(diag3) + intra
    # aggregates made purely of padding have a zero diagonal: decouple.
    # (In float32 the threshold rounds to zero and the test is never true;
    # such a diagonal stays zero and the smoother's safe inverse covers it.)
    diag_c = torch.where(diag_c.abs() < 1e-300, -1.0, diag_c)
    c_c = torch.stack([cE_c, cW_c, cN_c, cS_c, cU_c, cD_c], dim=-1)
    return diag_c, c_c


def _restrict(r3):
    r3 = _pad_even(r3)
    nlay, nrow, ncol = r3.shape
    return r3.reshape(nlay, nrow // 2, 2, ncol // 2, 2).sum(dim=(2, 4))


def _prolong(z_c, fine_shape):
    nlay, nrow, ncol = fine_shape
    z = z_c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return z[:, :nrow, :ncol]


def make_mg_preconditioner(shape, diag, off, *, nsmooth=2, coarse_size=512,
                           coarse_order=16, max_levels=12, overcorrect=1.8):
    """Build apply(r) -> z ≈ A⁻¹ r for the structured system (diag, off).

    ``off`` is the flat [N, 6] slot array of ops.system; ``shape`` the
    (nlay, nrow, ncol) grid, which a one-row section replaces by its
    ``section_view``.  The hierarchy is rebuilt from the current
    coefficients on every call (each outer iteration): pure pooling.
    ``apply.levels`` holds (diag3, c, matvec, inv) per level, finest first.
    """
    view = section_view(shape)
    if view is not None:
        shape = view
        off = off.reshape(-1, 6)[:, _SECTION_SLOTS]
    nlay, nrow, ncol = shape
    levels = []
    diag3 = diag.reshape(shape)
    c = off.reshape(nlay, nrow, ncol, 6)
    while True:
        inv = 1.0 / torch.where(diag3 != 0.0, diag3, 1.0)
        levels.append((diag3, c, _level_matvec(diag3, c), inv))
        nl, nr_, nc_ = diag3.shape
        if (nr_ * nc_ * nl <= coarse_size or min(nr_, nc_) <= 2
                or len(levels) >= max_levels):
            break
        diag3, c = _coarsen(diag3, c)

    def vcycle(level, r3):
        diag3, _, mv, inv = levels[level]
        if level == len(levels) - 1:
            return _chebyshev(mv, inv, r3, None, coarse_order, _COARSE_LO,
                              _LMAX)
        z = _chebyshev(mv, inv, r3, None, nsmooth, _SMOOTH_LO, _LMAX)
        resid = r3 - mv(z)
        zc = vcycle(level + 1, _restrict(resid))
        # over-correction compensates the energy deficit of
        # piecewise-constant prolongation (standard for aggregation MG,
        # cf. Notay AGMG)
        z = z + overcorrect * _prolong(zc, diag3.shape)
        return _chebyshev(mv, inv, r3, z, nsmooth, _SMOOTH_LO, _LMAX)

    def apply(r):
        with span("mg_apply"):
            return vcycle(0, r.reshape(shape)).reshape(-1)

    count("mg_levels", len(levels))
    count("mg_builds")
    apply.levels = levels
    return apply
