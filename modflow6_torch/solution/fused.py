"""Fused time step: the Picard outer loop around the Krylov inner loop.

Port of modflow6_tpu/solution/fused.py:24 ``make_fused_step`` and :160
``make_fused_run``.  The JAX version is one jitted device program; here the
outer and inner loops are Python loops over device tensors, and the host
reads each loop's exit flag once per iteration.

Covered: CG or BiCGSTAB in ``f64`` or ``mixed`` precision with every
preconditioner, the hoisted assembly of a linear model and the
per-iteration assembly of a nonlinear one, pseudo-transient continuation
and the Newton under-relaxation, and ``under_relaxation`` "none" or
"simple" (the reference's fused step reads no other scheme; here the
others raise).  The PTC state (ptcdel and the last residual norm) is
carried as 0-d tensors and never read on the host.
"""

from __future__ import annotations

import torch

from ..constants import DZERO
from ..models.gwf import npf as npf_mod
from ..ops.solvers.krylov import bicgstab, cg, epfact, refined_solve
from ..ops.system import make_matvec
from .ims import ImsSettings, _make_precond, fix_system, ptc_terms
from .ims import use_ptc as ptc_applies


def make_fused_step(model, settings: ImsSettings, iss: bool, kper: int = 1):
    """Returns step(head_old, delt, kstp) -> (head, outer_iters, inner_iters,
    converged)."""
    s = settings
    if s.linear_acceleration not in ("cg", "bicgstab"):
        raise ValueError(
            f"unknown linear_acceleration {s.linear_acceleration!r}")
    if s.under_relaxation not in ("none", "simple"):
        raise NotImplementedError(
            f"under_relaxation={s.under_relaxation!r} in the fused step "
            "(the reference's fused step has none/simple only)")
    if s.precision not in ("f64", "mixed"):
        raise ValueError(f"unknown precision {s.precision!r}")
    if model.wetdry is not None:
        raise NotImplementedError(
            "rewetting in the fused step (the reference's fused step has no "
            "wetting/drying sweep; use NumericalSolution)")
    dtopo = model.system_topo
    use_cg = s.linear_acceleration == "cg"
    solver = cg if use_cg else bicgstab
    use_ptc = ptc_applies(model, s, bool(iss), kper)
    # a linear model's system is constant within the time step: assemble,
    # fix up and precondition it once per step
    hoist = model.is_linear and not use_ptc

    def build_system(head, head_old, ibound, delt):
        diag, off, rhs = model.assemble(head, head_old, ibound, delt, iss)
        active = torch.sign(ibound)
        diag, off, rhs = fix_system(model, active, diag, off, rhs, head,
                                    symmetric=use_cg)
        return diag, off, rhs, active

    def make_solvers(diag, off):
        matvec = make_matvec(dtopo, diag, off)
        if s.precision == "mixed":
            diag32 = diag.to(torch.float32)
            off32 = off.to(torch.float32)
            matvec32 = make_matvec(dtopo, diag32, off32)
            precond32 = _make_precond(s, model, dtopo, matvec32, diag32,
                                      off32)
            return matvec, matvec32, precond32
        precond = _make_precond(s, model, dtopo, matvec, diag, off)
        return matvec, None, precond

    def step(head_old, delt, kstp):
        ibound, head = model.boundary_state(head_old)
        head_old_adj = head
        if hoist:
            system = build_system(head, head_old_adj, ibound, delt)
            solvers = make_solvers(system[0], system[1])

        kiter = 0
        inner_tot = 0
        converged = False
        ptc_state = None
        while not converged and kiter < s.outer_maximum:
            if not hoist:
                system = build_system(head, head_old_adj, ibound, delt)
                if use_ptc:
                    diag, off, rhs, active = system
                    diag, rhs, *ptc_state = ptc_terms(
                        model, s, diag, off, rhs, head, active, delt,
                        ptc_state)
                    system = diag, off, rhs, active
                solvers = make_solvers(system[0], system[1])
            diag, off, rhs, active = system
            matvec, matvec32, precond = solvers
            r0 = rhs - matvec(head)
            l2norm0 = torch.sqrt(torch.sum(r0 * r0))
            kw = dict(itmax=s.inner_maximum, dvclose=s.inner_dvclose,
                      rclose=s.inner_rclose, icnvgopt=s.icnvgopt,
                      north=s.north, l2norm0=l2norm0,
                      epfact_val=epfact(s.icnvgopt, kstp))
            if s.precision == "mixed":
                res = refined_solve(matvec, matvec32, rhs, head, precond,
                                    solver=solver, **kw)
            else:
                res = solver(matvec, rhs, head, precond, **kw)
            x = res.x
            dxmax = torch.where(active > 0, x - head, DZERO).abs().max()
            conv = dxmax <= s.outer_dvclose
            if s.under_relaxation == "simple":
                x = torch.where(conv | (active <= 0), x,
                                head + s.gamma * (x - head))
            if model.inewton and model.inewtonur:
                dxold = torch.where(active > 0, x - head, DZERO)
                x_nur = npf_mod.under_relax(
                    model.npf_arrays, ibound, x, head, dxold,
                    model.npf_arrays.bot)[0]
                x = torch.where(conv, x, x_nur)
            head = x
            kiter += 1
            inner_tot += res.iters
            converged = bool(conv)
        return head, kiter, inner_tot, converged

    return step


def make_fused_run(model, settings: ImsSettings, iss: bool, nsteps: int):
    """Multi-step run: ``run(head0, delts)`` -> (head, kiters, inners,
    convs), the last three as lists with one entry per step."""
    step = make_fused_step(model, settings, iss)

    def run(head0, delts):
        delts = [float(dt) for dt in delts]
        if len(delts) != nsteps:
            raise ValueError(f"expected {nsteps} step lengths, got "
                             f"{len(delts)}")
        head = head0
        kiters, inners, convs = [], [], []
        for kstp, delt in enumerate(delts, 1):
            head, kiter, inner, conv = step(head, delt, kstp)
            kiters.append(kiter)
            inners.append(inner)
            convs.append(conv)
        return head, kiters, inners, convs

    return run
