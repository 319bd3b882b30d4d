"""Preconditioners for the Krylov solvers.

Port of modflow6_tpu/ops/solvers/precond.py.  The reference program
preconditions with ILU(0)/ILUT (ImsLinearBase.f90:928-1042), whose
triangular solves are sequential; this package, like the JAX one, uses
preconditioners made of matvecs and elementwise work:

- ``jacobi``: M = diag(A);
- ``neumann``: truncated Neumann series on the Jacobi-scaled matrix,
  M⁻¹ ≈ (I + N + … + Nᵖ) D⁻¹ with N = I - D⁻¹A; p matvecs per application;
- ``chebyshev``: Chebyshev polynomial of degree ``order`` on D⁻¹A, with the
  spectral upper bound λmax estimated by power iteration when the
  preconditioner is built and λmin = λmax / eig_ratio; ``order - 1``
  matvecs per application.

``matvec`` is the A·v of the Krylov loop (``ops.system.make_matvec``): on
CUDA tensors every product here is a launch of the stencil kernel.  No
function reads a value on the host: λmax and the recurrence scalars that
depend on it stay 0-d tensors on the matrix's device.  The geometric
multigrid preconditioner lives in ``ops.solvers.mg``.

Sign note: the CVFD matrix follows the MODFLOW convention (negative
diagonals on active rows, +1 identity rows on Dirichlet/inactive cells), so
D⁻¹A has a positive spectrum on both blocks and the polynomials need no
sign handling.
"""

from __future__ import annotations

import torch


def _inverse_diagonal(diag):
    """1/diag, with 1 where the diagonal is zero (identity there)."""
    return 1.0 / torch.where(diag != 0.0, diag, 1.0)


def jacobi_precondition(diag):
    """Return apply(r) -> D^{-1} r. Safe for zero diagonals (identity there).
    ``apply.jacobi_inv`` is D^{-1}, which marks the Jacobi apply for
    krylov.cg's fused path."""
    inv = _inverse_diagonal(diag)

    def apply(r):
        return inv * r

    apply.jacobi_inv = inv
    return apply


def neumann_precondition(matvec, diag, order=2):
    """Truncated Neumann polynomial preconditioner.

    z = (I + N + N^2 + ... + N^order) D^{-1} r,  N = I - D^{-1} A:
    ``order`` Jacobi-iteration refinements of D^{-1} r.
    """
    inv = _inverse_diagonal(diag)

    def apply(r):
        z = inv * r
        acc = z
        for _ in range(order):
            # N z = z - D^{-1} A z
            z = z - inv * matvec(z)
            acc = acc + z
        return acc

    return apply


def power_start_vector(n, dtype, device):
    """The deterministic start vector of the power iteration, normalised:
    alternating 1 / -0.6 times (1 + 0.1 cos(i)), with content in many
    modes.  ``cos`` is taken in ``dtype`` as the reference takes it."""
    sign = torch.full((n,), -0.6, dtype=dtype, device=device)
    sign[::2] = 1.0
    v0 = sign * (1.0 + 0.1 * torch.cos(
        torch.arange(n, dtype=dtype, device=device)))
    return v0 / torch.sqrt(torch.sum(v0 * v0))


def estimate_lambda_max(matvec, diag, iters=10, v0=None):
    """Largest eigenvalue of D⁻¹A by ``iters`` steps of power iteration, as
    a 0-d tensor; the 1.05 safety factor absorbs the remaining estimation
    error (Chebyshev tolerates an overestimate of λmax, not an
    underestimate).  ``v0`` replaces the start vector (the tests use it to
    show what the start vector's rounding does in float32)."""
    inv = _inverse_diagonal(diag)
    v = (power_start_vector(diag.shape[0], diag.dtype, diag.device)
         if v0 is None else v0)
    for _ in range(iters):
        w = inv * matvec(v)
        v = w / torch.sqrt(torch.sum(w * w)).clamp(min=1e-300)
    w = inv * matvec(v)
    lmax = torch.sum(v * w) / torch.sum(v * v).clamp(min=1e-300)
    return lmax.clamp(min=1e-30) * 1.05


def chebyshev_precondition(matvec, diag, order=4, eig_ratio=30.0,
                           power_iters=10):
    """Chebyshev polynomial preconditioner on the Jacobi-scaled operator.

    z = q(Â) D⁻¹ r with Â = D⁻¹A and q the degree-``order`` Chebyshev
    approximation of 1/λ on [λmax/eig_ratio, λmax]: the three-term
    recurrence (Saad, Iterative Methods §12.3).  SPD for SPD A, so valid
    inside CG.
    """
    inv = _inverse_diagonal(diag)
    lmax = estimate_lambda_max(matvec, diag, iters=power_iters)
    lmin = lmax / eig_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    # the recurrence scalars do not depend on r: make them once
    rho = 1.0 / sigma
    coefs = []
    for _ in range(order - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        coefs.append((rho_new * rho, 2.0 * rho_new / delta))
        rho = rho_new

    def apply(r):
        rs = inv * r
        d = rs / theta
        z = d
        for c_d, c_r in coefs:
            resid = rs - inv * matvec(z)
            d = c_d * d + c_r * resid
            z = z + d
        return z

    return apply


def make_preconditioner(kind, matvec, diag, **kw):
    if kind in ("jacobi", "diag"):
        return jacobi_precondition(diag)
    if kind == "neumann":
        return neumann_precondition(matvec, diag, order=kw.get("order", 2))
    if kind == "chebyshev":
        return chebyshev_precondition(
            matvec, diag, order=kw.get("order", 4),
            eig_ratio=kw.get("eig_ratio", 30.0),
            power_iters=kw.get("power_iters", 10))
    if kind == "none":
        return lambda r: r
    raise ValueError(f"unknown preconditioner {kind!r}")
