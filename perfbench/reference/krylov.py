"""Jacobi-preconditioned CG with the exit rules of MODFLOW 6's IMS
(ImsLinearBase.f90: ims_base_cg, ims_base_testcnvg with ICNVGOPT 0), and
the Picard outer loop of NumericalSolution.f90 without under-relaxation,
written out in plain PyTorch.

An inner solve stops when the update's largest change is within
``dvclose`` and the residual's largest entry within ``rclose``, when rho
stagnates to within 100 machine epsilons, or at ``itmax`` iterations.  An
outer iteration assembles the system at the iterate, applies the
Dirichlet fixup, solves from the iterate and is converged when the largest
change over active cells is within ``outer_dvclose``.
"""

from __future__ import annotations

import torch


def signed_absmax(v):
    """The entry of largest magnitude, with its sign."""
    return v.take(torch.argmax(v.abs()))


def _same(a, b):
    rtol = 100.0 * torch.finfo(a.dtype).eps
    return (a == b) | ((a - b).abs() <= rtol * torch.maximum(a.abs(),
                                                             b.abs()))


def _nudge(x):
    """x plus the float64 machine epsilon with x's sign (the reference's
    guard against a zero denominator)."""
    eps = torch.full_like(x, 2.220446049250313e-16)
    return x + torch.where(x >= 0.0, eps, -eps)


def _converged(dvmax, rmax, dvclose, rclose):
    return ((dvmax.abs() <= dvclose) & (rmax.abs() <= rclose)) | (rmax == 0.0)


def jacobi(diag):
    inv = 1.0 / torch.where(diag != 0.0, diag, 1.0)
    return lambda r: inv * r


def cg(matvec, b, x, precond, itmax, dvclose, rclose):
    """Returns (x, iterations, converged)."""
    d = b - matvec(x)
    p = torch.zeros_like(b)
    rho0 = torch.zeros((), dtype=b.dtype, device=b.device)
    conv = torch.zeros((), dtype=torch.bool, device=b.device)
    it = 0
    while it < itmax:
        z = precond(d)
        rho = torch.sum(d * z)
        beta = 0.0 if it == 0 else rho / torch.where(rho0 != 0.0, rho0, 1.0)
        p = z + beta * p
        q = matvec(p)
        alpha = rho / _nudge(torch.sum(p * q))
        tv = alpha * p
        x = x + tv
        d = d - alpha * q
        conv = _converged(signed_absmax(tv), signed_absmax(d), dvclose,
                          rclose)
        it += 1
        if bool(conv | _same(rho, rho0) | (rho == 0.0)):
            break
        rho0 = rho
    return x, it, bool(conv)


def picard(system, x, active, ims):
    """The outer loop of one time step.  ``system(x)`` returns the fixed-up
    (matvec, diag, rhs) at the iterate ``x``; ``ims`` holds the
    closures.  Returns (x, outer, inner, converged)."""
    if (ims.get("preconditioner", "jacobi"), ims["linear_acceleration"]) \
            != ("jacobi", "cg"):
        raise ValueError("the reference follows CG with Jacobi only")
    inner = 0
    for outer in range(1, ims["outer_maximum"] + 1):
        matvec, diag, rhs = system(x)
        xnew, its, _ = cg(matvec, rhs, x, jacobi(diag),
                              ims["inner_maximum"], ims["inner_dvclose"],
                              ims["inner_rclose"])
        inner += its
        dxmax = signed_absmax(torch.where(active, xnew - x, 0.0))
        x = xnew
        if bool(dxmax.abs() <= ims["outer_dvclose"]):
            return x, outer, inner, True
    return x, ims["outer_maximum"], inner, False
