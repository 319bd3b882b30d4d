"""Krylov accelerators: preconditioned CG, BiCGSTAB and mixed-precision
refinement.

Port of modflow6_tpu/ops/solvers/krylov.py (reference ImsLinearBase.f90
ims_base_cg, ims_base_bcgs, ims_base_testcnvg, ims_base_epfact).  The
exit semantics are the reference's, so iteration counts agree: the iterate
update's signed infinity norm against DVCLOSE, the residual norm against
RCLOSE per ICNVGOPT, and stagnation of rho to within 100 machine epsilons.

The JAX version runs each loop as one ``lax.while_loop`` on the device.
Here the loop is a Python ``while`` whose scalars (rho, alpha, the norms,
the exit flag) stay 0-d device tensors; the host reads the exit flag once
per iteration, which is one device synchronisation per iteration.  That
read goes through ``utils.profiler.exit_flag``, which counts it and adds
the host's wait to the solve's ``krylov`` span (``krylov_solve``); under
a ``torch.profiler`` each iteration is an ``mf6::krylov_iter`` range.
``trace=True`` keeps each iteration's (dvmax, rmax, l2norm) on the device
and returns them stacked, without a further host read per iteration.
``dot`` and ``absmax`` are injectable, as in the reference: the sharded
runners (``parallel/``) pass the owned-row partial sums and maxima combined
over the shards, so one loop serves one device and P shards.  The
reference's ``max_passes`` knob is left out (``MAX_PASSES``).

``cg`` on CUDA tensors with a bound ``stencil7`` product, the Jacobi
preconditioner, the default ``dot`` and ``absmax``, no trace and
``north == 0`` runs each iteration as four hand-written kernels
(``pcg_jacobi.solve``); ``bicgstab`` with the same but the ELL gather
product (``matvec.ell``, under ``bicgstab_ell.MAX_SLOTS`` slots a row)
runs each iteration as six, bitwise the plain loop
(``bicgstab_ell.solve``).  ``_fused_operands`` decides from what it is
given; everything else runs the plain loops below, which are also the
kernels' oracles.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ...constants import DPREC
from ...utils.profiler import exit_flag, iteration_ranges, krylov_solve
from . import bicgstab_ell, pcg_jacobi

# f32 passes of refined_solve before it gives up (the reference's default)
MAX_PASSES = 8


def vector_dot(a, b):
    """Dot product, ``sum(a*b)`` as in the reference package."""
    return torch.sum(a * b)


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: int                 # number of inner iterations performed
    converged: torch.Tensor    # 0-d bool
    dvmax: torch.Tensor        # signed max dependent-variable change of last iter
    rmax: torch.Tensor         # signed max residual of last iter
    l2norm: torch.Tensor       # residual L2 norm of last iter
    # (dvmax[iters], rmax[iters], l2norm[iters]) when traced
    trace: tuple = None


def _signed_absmax(v):
    """The entry of largest magnitude, with its sign; the first on ties."""
    return v.take(torch.argmax(v.abs()))


def _is_close(a, b, rtol=None):
    if rtol is None:
        # 100 machine epsilons of the working dtype
        rtol = 100.0 * torch.finfo(a.dtype).eps
    return (a == b) | ((a - b).abs() <= rtol * torch.maximum(a.abs(),
                                                             b.abs()))


def _sign_dprec(x):
    eps = torch.full_like(x, DPREC)
    return torch.where(x >= 0.0, eps, -eps)


def _test_cnvg(icnvgopt, iiter0, dvmax, rcnvg, l2norm0, epfact, dvclose,
               rclose):
    """IMS convergence test; returns icnvg in {-1, 0, 1} as a 0-d tensor.

    ``iiter0`` is the 0-based inner iteration index (a host int).
    """
    advclose = dvmax.abs() <= dvclose
    if icnvgopt == 0:
        return torch.where(advclose & (rcnvg.abs() <= rclose), 1, 0)
    if icnvgopt == 1:
        hit = advclose & (rcnvg.abs() <= rclose)
        return torch.where(hit, 1 if iiter0 == 0 else -1, 0)
    if icnvgopt == 2:
        return torch.where(
            advclose | (rcnvg <= rclose), 1,
            torch.where(rcnvg <= l2norm0 * epfact, -1, 0))
    if icnvgopt == 3:
        return torch.where(advclose, 1,
                           torch.where(rcnvg <= l2norm0 * rclose, -1, 0))
    if icnvgopt == 4:
        return torch.where(
            advclose & (rcnvg <= rclose), 1,
            torch.where(rcnvg <= l2norm0 * epfact, -1, 0))
    raise ValueError(f"unknown icnvgopt {icnvgopt}")


def epfact(icnvgopt: int, kstp: int) -> float:
    """Residual-criterion relaxation factor (reference ims_base_epfact)."""
    if icnvgopt == 2:
        return 0.01 if kstp == 1 else 0.10
    if icnvgopt == 4:
        return 1.0e-4
    return 1.0


def _fused_operands(matvec, precond, b, dot, absmax, trace, north,
                    product="stencil7"):
    """(system, inv) where a loop can run as fused Jacobi kernels: the
    product that ``matvec`` marks with the attribute ``product`` (for
    ``cg`` a bound stencil7, ``matvec.stencil7``; for ``bicgstab`` the ELL
    gather, ``matvec.ell``), the Jacobi apply (``precond.jacobi_inv``), the
    default ``dot`` and ``absmax``, no trace, ``north == 0`` and CUDA
    tensors.  Else None: the plain loop runs."""
    system = getattr(matvec, product, None)
    inv = getattr(precond, "jacobi_inv", None)
    if (system is None or inv is None or dot is not vector_dot
            or absmax is not _signed_absmax or trace or north != 0
            or b.device.type != "cuda"):
        return None
    return system, inv


@krylov_solve
def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    precond: Callable,
    *,
    itmax: int,
    dvclose: float,
    rclose: float,
    icnvgopt: int = 0,
    north: int = 0,
    l2norm0=0.0,
    epfact_val=1.0,
    dot: Callable = vector_dot,
    absmax: Callable = _signed_absmax,
    trace: bool = False,
) -> KrylovResult:
    """Preconditioned conjugate gradient, IMS semantics.

    ``trace=True`` records (dvmax, rmax, l2norm) per inner iteration
    (CSV_INNER_OUTPUT role)."""
    fused = _fused_operands(matvec, precond, b, dot, absmax, trace, north)
    if fused is not None:
        return KrylovResult(*pcg_jacobi.solve(
            *fused, b, x0, itmax=itmax, dvclose=dvclose, rclose=rclose,
            icnvgopt=icnvgopt, l2norm0=l2norm0, epfact_val=epfact_val))
    x = x0
    d = b - matvec(x0)
    p = torch.zeros_like(b)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    rho0, dvmax, rmax, l2norm = zero, zero, zero, zero
    icnvg = torch.zeros((), dtype=torch.int64, device=b.device)
    rows = [] if trace else None
    iiter = 0
    done = False
    ranges = iteration_ranges()
    while not done and iiter < itmax:
        if ranges:
            ranges.begin()
        z = precond(d)
        rho = dot(d, z)
        beta = zero if iiter == 0 else rho / torch.where(rho0 != 0.0, rho0,
                                                         1.0)
        p = z + beta * p
        q = matvec(p)
        denom = dot(p, q)
        denom = denom + _sign_dprec(denom)
        alpha = rho / denom
        tv = alpha * p
        x = x + tv
        dvmax = absmax(tv)
        d = d - alpha * q
        rmax = absmax(d)
        l2norm = torch.sqrt(dot(d, d))
        rcnvg = l2norm if icnvgopt in (2, 3, 4) else rmax
        icnvg = _test_cnvg(icnvgopt, iiter, dvmax, rcnvg, l2norm0,
                           epfact_val, dvclose, rclose)
        icnvg = torch.where(rcnvg == 0.0, 1, icnvg)
        stagnant = _is_close(rho, rho0)
        if trace:
            rows.append(torch.stack((dvmax, rmax, l2norm)))
        done = exit_flag((icnvg != 0) | stagnant | (rho == 0.0))
        if north > 0 and (iiter + 2) % north == 0 and not done:
            d = b - matvec(x)
        rho0 = rho
        iiter += 1
        if ranges:
            ranges.end()
    return KrylovResult(x, iiter, icnvg == 1, dvmax, rmax, l2norm,
                        _stack_trace(rows, b))


def _stack_trace(rows, b):
    """Per-iteration (dvmax, rmax, l2norm) rows → three [iters] tensors."""
    if rows is None:
        return None
    if not rows:
        empty = torch.zeros(0, dtype=b.dtype, device=b.device)
        return empty, empty, empty
    return tuple(torch.stack(rows).unbind(dim=1))


@krylov_solve
def bicgstab(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    precond: Callable,
    *,
    itmax: int,
    dvclose: float,
    rclose: float,
    icnvgopt: int = 0,
    north: int = 0,
    l2norm0=0.0,
    epfact_val=1.0,
    dot: Callable = vector_dot,
    absmax: Callable = _signed_absmax,
    trace: bool = False,
) -> KrylovResult:
    """Preconditioned BiCGSTAB, IMS semantics (for systems that are not
    symmetric); two matvecs per iteration."""
    fused = _fused_operands(matvec, precond, b, dot, absmax, trace, north,
                            product="ell")
    # fused = ((nbr, diag, off), inv); the kernels add rows of fewer than
    # MAX_SLOTS slots as the plain product does
    if fused is not None and fused[0][0].shape[1] < bicgstab_ell.MAX_SLOTS:
        return KrylovResult(*bicgstab_ell.solve(
            *fused, b, x0, itmax=itmax, dvclose=dvclose, rclose=rclose,
            icnvgopt=icnvgopt, l2norm0=l2norm0, epfact_val=epfact_val))
    x = x0
    d = b - matvec(x0)
    dhat = d
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    rho0, alpha0, omega0 = zero, zero, zero
    dvmax, rmax, l2norm = zero, zero, zero
    icnvg = torch.zeros((), dtype=torch.int64, device=b.device)
    rows = [] if trace else None
    iiter = 0
    done = False
    ranges = iteration_ranges()
    while not done and iiter < itmax:
        if ranges:
            ranges.begin()
        rho = dot(dhat, d)
        if iiter == 0:
            p = d
        else:
            beta = ((rho / torch.where(rho0 != 0.0, rho0, 1.0))
                    * (alpha0 / torch.where(omega0 != 0.0, omega0, 1.0)))
            p = d + beta * (p - omega0 * v)
        phat = precond(p)
        v = matvec(phat)
        denom = dot(dhat, v)
        denom = denom + _sign_dprec(denom)
        alpha = rho / denom
        q = d - alpha * v
        qhat = precond(q)
        t = matvec(qhat)
        numer = dot(t, q)
        denom2 = dot(t, t)
        denom2 = denom2 + _sign_dprec(denom2)
        omega = numer / denom2
        tv = alpha * phat + omega * qhat
        x = x + tv
        dvmax = absmax(tv)
        d = q - omega * t
        rmax = absmax(d)
        l2norm = torch.sqrt(dot(d, d))
        rcnvg = l2norm if icnvgopt in (2, 3, 4) else rmax
        icnvg = _test_cnvg(icnvgopt, iiter, dvmax, rcnvg, l2norm0,
                           epfact_val, dvclose, rclose)
        icnvg = torch.where(rcnvg == 0.0, 1, icnvg)
        if trace:
            rows.append(torch.stack((dvmax, rmax, l2norm)))
        stagnant = (_is_close(rho, rho0) | _is_close(alpha, alpha0)
                    | _is_close(omega, omega0))
        done = exit_flag((icnvg != 0) | stagnant | (rho * omega == 0.0))
        if north > 0 and (iiter + 2) % north == 0 and not done:
            d = b - matvec(x)
        rho0, alpha0, omega0 = rho, alpha, omega
        iiter += 1
        if ranges:
            ranges.end()
    return KrylovResult(x, iiter, icnvg == 1, dvmax, rmax, l2norm,
                        _stack_trace(rows, b))


@krylov_solve
def refined_solve(
    matvec64: Callable,
    matvec32: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    precond32: Callable,
    *,
    itmax: int,
    dvclose: float,
    rclose: float,
    icnvgopt: int = 0,
    north: int = 0,
    l2norm0=0.0,
    epfact_val=1.0,
    solver: Callable = cg,
    dot: Callable = vector_dot,
    absmax: Callable = _signed_absmax,
) -> KrylovResult:
    """Mixed-precision linear solve: f32 Krylov + f64 iterative refinement.

        r = b - A x                (f64)
        repeat:  solve A d = r in f32 (Krylov, stagnation-guarded)
                 x += d; r = b - A x   (f64)
        until IMS convergence criteria hold in f64

    Each f32 pass (``solver``: ``cg`` or ``bicgstab``) only contracts its
    own residual by 1e-5 (icnvgopt=3) before handing back to the f64
    refinement; at most ``MAX_PASSES`` passes run.  The result reports
    IMS-semantics convergence measured in f64, so the outer loop behaves
    as on the f64 path.  ``dot``/``absmax`` serve both precisions.
    """
    f32 = torch.float32
    f64 = b.dtype

    def f64_norms(r):
        return absmax(r), torch.sqrt(dot(r, r))

    x = x0
    r = b - matvec64(x0)
    rmax, l2 = f64_norms(r)
    dvmax = torch.zeros((), dtype=f64, device=b.device)
    icnvg = torch.zeros((), dtype=torch.int64, device=b.device)
    iters = 0
    npass = 0
    done = False
    while not done and npass < MAX_PASSES and iters < itmax:
        r32 = r.to(f32)
        l2r0 = torch.sqrt(dot(r32, r32))
        res = solver(matvec32, r32, torch.zeros_like(r32), precond32,
                 itmax=itmax, dvclose=dvclose, rclose=1.0e-5, icnvgopt=3,
                 north=north, l2norm0=l2r0, epfact_val=1.0, dot=dot,
                 absmax=absmax)
        d = res.x.to(f64)
        x = x + d
        r = b - matvec64(x)
        dvmax = absmax(d)
        rmax, l2 = f64_norms(r)
        rcnvg = l2 if icnvgopt in (2, 3, 4) else rmax
        icnvg = _test_cnvg(icnvgopt, 0, dvmax, rcnvg, l2norm0, epfact_val,
                           dvclose, rclose)
        # a pass that produced no correction cannot make progress (f32 floor)
        done = exit_flag((icnvg != 0) | (dvmax == 0.0))
        iters += res.iters
        npass += 1
    return KrylovResult(x, iters, icnvg == 1, dvmax, rmax, l2)
