"""IMS-equivalent numerical solution: the Picard outer loop around the
Krylov solvers, with per-iteration diagnostics.

Port of modflow6_tpu/solution/ims.py (reference
src/Solution/NumericalSolution.f90: solve :1482-1837, sln_ls :2404-2475,
sln_underrelax :2989-3114, sln_backtracking :2680-2776, complexity presets
sln_setouter :2623-2671): ``ImsSettings``, ``SolveInfo`` and
``NumericalSolution`` for a model on the structured or the general path
(``fix_system`` picks the Dirichlet fixup; the solver reads the model's
``system_topo``, XT3D's extended table in its full mode), with pseudo-transient
continuation (sln_ls :2484-2569 + gwf_ptc gwf.f90:625-687), the Newton
under-relaxation with its convergence rescue (npf_nur +
sln_nur_has_converged) and the wetting/drying sweep before each outer
iteration (npf_cf).

The reference runs each outer iteration as one jitted device computation
and reads ``converged``, ``inner`` and ``dxmax`` on the host once per outer
iteration.  Here each outer iteration is a sequence of PyTorch calls on the
model's device; the host reads the Krylov loop's exit flag once per inner
iteration (see ops.solvers.krylov) and ``(converged, dxmax)`` once per
outer iteration.  The matvec is bound to the assembled system once per
outer iteration and precision (``make_matvec``), not per product.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..constants import DONE, DZERO
from ..models.gwf import npf as npf_mod
from ..ops.solvers.krylov import (_is_close, _signed_absmax, bicgstab, cg,
                                  epfact, refined_solve)
from ..ops.solvers.mg import make_mg_preconditioner
from ..ops.solvers.precond import make_preconditioner
from ..ops.system import (apply_dirichlet, apply_dirichlet_structured,
                          make_matvec)


@dataclasses.dataclass
class ImsSettings:
    """IMS nonlinear+linear settings (reference ims8 input)."""

    outer_dvclose: float = 1e-3
    outer_maximum: int = 25
    under_relaxation: str = "none"       # none|simple|cooley|dbd
    gamma: float = 1.0
    theta: float = 1.0
    akappa: float = 0.0
    amomentum: float = 0.0
    backtracking_number: int = 0
    backtracking_tolerance: float = 0.0
    backtracking_reduction_factor: float = 0.0
    backtracking_residual_limit: float = 0.0
    inner_maximum: int = 50
    inner_dvclose: float = 1e-3
    inner_rclose: float = 0.1
    icnvgopt: int = 0                    # rclose option
    linear_acceleration: str = "cg"      # cg|bicgstab
    relaxation_factor: float = 0.0       # MILU(0) relax in the reference —
    # meaningless without ILU; the deck loader warns when it is set
    preconditioner: str = "jacobi"       # jacobi|neumann|chebyshev|mg|none
    preconditioner_order: int = 2
    north: int = 0                       # reorthogonalization frequency
    no_ptc: object = False               # False | "first" | "all"/True
    ptcexp: float = 1.0
    ptcdel0: float = 0.0
    precision: str = "f64"               # f64 | mixed (f32 Krylov + f64
    # iterative refinement; see ops.solvers.krylov.refined_solve)
    csv_inner_path: str = None           # CSV_INNER_OUTPUT FILEOUT: write
    # one row per inner iteration (dvmax/rmax/l2norm traces)

    @staticmethod
    def from_complexity(complexity: str = "simple") -> "ImsSettings":
        c = complexity.strip().lower()
        if c == "simple":
            return ImsSettings()
        if c == "moderate":
            return ImsSettings(
                outer_dvclose=1e-2, outer_maximum=50, under_relaxation="dbd",
                theta=0.9, akappa=1e-4, gamma=0.0, amomentum=0.0,
                inner_maximum=100, inner_dvclose=1e-2, inner_rclose=0.1,
                linear_acceleration="bicgstab")
        if c == "complex":
            return ImsSettings(
                outer_dvclose=1e-1, outer_maximum=100, under_relaxation="dbd",
                theta=0.8, akappa=1e-4, gamma=0.0, amomentum=0.0,
                backtracking_number=20, backtracking_tolerance=1.05,
                backtracking_reduction_factor=0.1,
                backtracking_residual_limit=0.002,
                inner_maximum=500, inner_dvclose=1e-1, inner_rclose=0.1,
                linear_acceleration="bicgstab")
        raise ValueError(f"unknown complexity {complexity!r}")


def fix_system(model, active, diag, off, rhs, x, symmetric):
    """The Dirichlet fixup before the linear solve, by the model's path:
    on shifted dense fields for a structured model, through the neighbour
    table otherwise (modflow6_tpu/solution/ims.py:166-173)."""
    if model.use_structured:
        return apply_dirichlet_structured(model.dtopo.grid_shape, active,
                                          diag, off, rhs, x,
                                          symmetric=symmetric)
    return apply_dirichlet(model.system_topo.nbr, active, diag, off, rhs, x,
                           symmetric=symmetric)


def _make_precond(s, model, dtopo, matvec, diag, off):
    """Preconditioner factory shared by the diagnostic and fused paths.
    ``mg`` needs the structured stencil form: a model that is not on the
    structured path (a general grid, or a DIS grid with rotated
    anisotropy) gets Chebyshev instead, as in the reference; everything
    else goes through ops.solvers.precond.make_preconditioner, Chebyshev
    with at least order 4."""
    if s.preconditioner == "mg" and model.use_structured:
        return make_mg_preconditioner(dtopo.grid_shape, diag, off)
    kind = "chebyshev" if s.preconditioner == "mg" else s.preconditioner
    return make_preconditioner(kind, matvec, diag,
                               order=max(s.preconditioner_order,
                                         4 if kind == "chebyshev" else 0))


def use_ptc(model, s, iss, kper=1) -> bool:
    """PTC applies to Newton models in steady-state periods (gwf_ptcchk,
    gwf.f90:601-617), gated by the IMS NO_PTC option (sln_ls,
    NumericalSolution.f90:2484-2497)."""
    if not (iss and model.inewton):
        return False
    if s.no_ptc in (True, "all"):
        return False
    return not (s.no_ptc == "first" and kper == 1)


def ptc_terms(model, s, diag, off, rhs, head, active, delt, prev):
    """The PTC update shared by ``NumericalSolution._apply_ptc`` and the
    fused step: (diag', rhs', ptcdel, l2norm).  ``prev`` is None at the
    first outer iteration of a step, else the carried (ptcdel, l2norm) of
    the iteration before, as 0-d tensors."""
    matvec = make_matvec(model.system_topo, diag, off)
    resid = torch.where(active > 0, matvec(head) - rhs, DZERO)
    l2norm = torch.sqrt(torch.sum(resid * resid))
    a = model.npf_arrays
    vol = model.area * (a.top - a.bot)
    vol = torch.where(vol > DZERO, vol, DONE)
    ptcf = torch.where(active > 0, resid.abs() / vol, DZERO).max()
    ptcf = torch.where(ptcf == DZERO, DONE / (delt * 10.0), ptcf)
    if prev is None:
        ptcdel = (torch.full_like(ptcf, s.ptcdel0) if s.ptcdel0 > 0
                  else DONE / ptcf)
        iptc_on = torch.ones_like(ptcf, dtype=torch.bool)
    else:
        ptcdel_prev, l2norm0 = prev
        iptc_on = ~_is_close(l2norm, l2norm0)
        # a zero residual norm gives inf here, which the where discards
        ptcdel = torch.where(
            l2norm > DZERO, ptcdel_prev * (l2norm0 / l2norm) ** s.ptcexp,
            DZERO)
    ptcval = torch.where(ptcdel > DZERO, DONE / ptcdel, DONE)
    add = torch.where((active > 0) & iptc_on, ptcval, DZERO)
    return diag - add, rhs - add * head, ptcdel, l2norm


class SolveInfo(NamedTuple):
    converged: bool
    outer_iterations: int
    inner_iterations: int
    dvmax_outer: float
    dvmax_history: list
    # [(kiter, n_inner, dvmax[], rmax[], l2norm[])] per outer iteration
    # when csv_inner_path is set (CSV_INNER_OUTPUT role)
    inner_traces: object = None


class NumericalSolution:
    """Drives one GWF model through a time step."""

    def __init__(self, model, settings: ImsSettings):
        s = settings
        if s.linear_acceleration not in ("cg", "bicgstab"):
            raise ValueError(
                f"unknown linear_acceleration {s.linear_acceleration!r}")
        if s.under_relaxation not in ("none", "simple", "cooley", "dbd"):
            raise ValueError(
                f"unknown under_relaxation {s.under_relaxation!r}")
        if s.precision not in ("f64", "mixed"):
            raise ValueError(f"unknown precision {s.precision!r}")
        if s.preconditioner not in ("jacobi", "diag", "neumann", "chebyshev",
                                    "mg", "none"):
            raise ValueError(f"unknown preconditioner {s.preconditioner!r}")
        if s.precision == "mixed" and s.csv_inner_path is not None:
            raise NotImplementedError(
                "CSV_INNER_OUTPUT traces the f64 Krylov loop; it is not "
                "available with precision='mixed'")
        self.model = model
        self.s = settings

    # ------------------------------------------------------- one outer it

    def _use_ptc(self, iss, kper=1) -> bool:
        return use_ptc(self.model, self.s, bool(iss), kper)

    def _outer_iter(self, head, head_old, ibound, delt, kstp, ur_state,
                    pkgs, iss: bool, kiter_is_first: bool,
                    use_ptc: bool = False):
        """Assemble + fix up + linear solve + convergence bookkeeping.

        Returns (x, converged, dxmax, inner, ur_state); ``converged`` and
        ``dxmax`` are 0-d tensors."""
        s = self.s
        model = self.model
        dtopo = model.system_topo

        diag, off, rhs = model.assemble(head, head_old, ibound, delt, iss,
                                        pkgs)
        xtemp = head
        active = torch.sign(ibound)
        diag, off, rhs = fix_system(
            model, active, diag, off, rhs, head,
            symmetric=(s.linear_acceleration == "cg"))

        if use_ptc:
            diag, rhs, ur_state = self._apply_ptc(
                diag, off, rhs, head, active, delt, ur_state, kiter_is_first)

        matvec = make_matvec(dtopo, diag, off)
        r0 = rhs - matvec(head)
        l2norm0 = torch.sqrt(torch.sum(r0 * r0))
        solver = cg if s.linear_acceleration == "cg" else bicgstab
        kw = dict(itmax=s.inner_maximum, dvclose=s.inner_dvclose,
                  rclose=s.inner_rclose, icnvgopt=s.icnvgopt, north=s.north,
                  l2norm0=l2norm0, epfact_val=epfact(s.icnvgopt, kstp))
        if s.precision == "mixed":
            diag32 = diag.to(torch.float32)
            off32 = off.to(torch.float32)
            matvec32 = make_matvec(dtopo, diag32, off32)
            precond32 = _make_precond(s, model, dtopo, matvec32, diag32,
                                      off32)
            res = refined_solve(matvec, matvec32, rhs, head, precond32,
                                solver=solver, **kw)
        else:
            precond = _make_precond(s, model, dtopo, matvec, diag, off)
            res = solver(matvec, rhs, head, precond,
                         trace=s.csv_inner_path is not None, **kw)
        x = res.x

        # outer convergence: max dependent-variable change over active cells
        dx = torch.where(active > 0, x - xtemp, DZERO)
        dxmax = _signed_absmax(dx)
        converged = dxmax.abs() <= s.outer_dvclose

        # under-relaxation (only applied when not converged)
        x_ur, ur_state_new = self._under_relax(x, xtemp, active, dxmax,
                                               ur_state, kiter_is_first)
        x = torch.where(converged, x, x_ur)

        # Newton under-relaxation on the model (npf_nur): only with the
        # NEWTON UNDER_RELAXATION option (gwf.f90 gwf_nur gates on
        # this%inewtonur)
        if model.inewton and model.inewtonur:
            if getattr(model, "n_grid", x.shape[0]) != x.shape[0]:
                raise NotImplementedError(
                    "Newton under-relaxation of an augmented model (rows "
                    "beyond the grid's, n_grid) is not ported")
            dxold = torch.where(active > 0, x - xtemp, DZERO)
            x_nur, dx_nur, applied, _ = npf_mod.under_relax(
                model.npf_arrays, ibound, x, xtemp, dxold,
                model.npf_arrays.bot)
            x = torch.where(converged, x, x_nur)
            # NUR convergence rescue (sln_nur_has_converged,
            # NumericalSolution.f90): BOTH the max change at unrelaxed
            # cells AND the post-NUR recomputed dxmax must be <= dvclose
            dxold_max = dx_nur.abs().max()
            hncg = torch.where(active > 0, x_nur - xtemp, DZERO).abs().max()
            nur_conv = (applied & (dxold_max <= s.outer_dvclose)
                        & (hncg <= s.outer_dvclose))
            converged = converged | (~converged & nur_conv)

        if res.trace is not None:
            ur_state_new = {**ur_state_new, "inner_trace": res.trace}
        return x, converged, dxmax, res.iters, ur_state_new

    # ------------------------------------------------------------- ptc

    def _apply_ptc(self, diag, off, rhs, head, active, delt, ur_state,
                   kiter_is_first):
        """Pseudo-transient continuation diagonal terms.

        gwf_ptc (gwf.f90:625-687) computes the reciprocal pseudo-time step
        ptcf = max |resid|/V over active cells (V = cell volume at full
        saturation); sln_ls (NumericalSolution.f90:2499-2569) turns it into
        ptcdel with the (l2norm0/l2norm)**ptcexp update and subtracts
        1/ptcdel from active diagonals (the matrix is negative definite, so
        this strengthens the diagonal) with the matching rhs shift.
        ``ptcdel``, the last residual norm and the on/off flag stay 0-d
        tensors: nothing is read on the host.
        """
        diag, rhs, ptcdel, l2norm = ptc_terms(
            self.model, self.s, diag, off, rhs, head, active, delt,
            None if kiter_is_first else (ur_state["ptcdel"],
                                         ur_state["ptc_l2norm0"]))
        return diag, rhs, {**ur_state, "ptcdel": ptcdel,
                           "ptc_l2norm0": l2norm}

    # ----------------------------------------------------- backtracking

    def _residual_l2(self, head, head_old, ibound, delt, iss, pkgs):
        """‖A·x − b‖₂ over active rows of the *raw* assembled system
        (sln_l2norm + sln_calc_residual, NumericalSolution.f90:2845-2872;
        backtracking rebuilds without the Newton terms,
        sln_backtracking:2699)."""
        model = self.model
        diag, off, rhs = model.assemble(head, head_old, ibound, delt, iss,
                                        pkgs, newton=False)
        matvec = make_matvec(model.system_topo, diag, off)
        r = torch.where(ibound > 0, matvec(head) - rhs, DZERO)
        return torch.sqrt(torch.sum(r * r))

    def _backtrack(self, head, head_prev, head_old, ibound, delt, res_prev,
                   pkgs, iss: bool, kiter_is_first: bool):
        """One backtracking pass before an outer iteration
        (sln_backtracking, NumericalSolution.f90:2680-2776).

        Returns (head', res_prev').  At the first outer iteration only the
        reference residual is recorded.  Otherwise, while the new residual
        exceeds res_prev*btol, the iterate is pulled back toward the
        previous outer iterate by breduc, up to numtrack times, stopping
        early when the remaining step is below dvclose
        (get_backtracking_flag:2800-2826) or the residual drops below
        res_lim.  The host reads two flags per backtracking pass.
        """
        s = self.s

        def l2(x):
            return self._residual_l2(x, head_old, ibound, delt, iss, pkgs)

        if kiter_is_first:
            return head, l2(head)

        active = ibound > 0
        x = head
        res_new = l2(head)
        done = bool(res_new <= res_prev * s.backtracking_tolerance)
        nb = 0
        while not done and nb < s.backtracking_number:
            dxmax = torch.where(active, x - head_prev, DZERO).abs().max()
            # dependent-variable change already below dvclose → stop
            stop_small = bool(s.backtracking_reduction_factor * dxmax
                              < s.outer_dvclose)
            if stop_small:
                break
            x = torch.where(
                active,
                head_prev + s.backtracking_reduction_factor * (x - head_prev),
                x)
            res_new = l2(x)
            done = bool((res_new < res_prev * s.backtracking_tolerance)
                        | (res_new < s.backtracking_residual_limit))
            nb += 1
        return x, res_new

    # ------------------------------------------------------ under-relax

    def _under_relax(self, x, xtemp, active, dxmax, ur_state, kiter_is_first):
        s = self.s
        mode = s.under_relaxation
        if mode == "none":
            return x, ur_state
        delx = torch.where(active > 0, x - xtemp, DZERO)
        if mode == "simple":
            xnew = torch.where(active > 0, xtemp + s.gamma * delx, x)
            return xnew, ur_state
        if mode == "cooley":
            bigch = dxmax
            if kiter_is_first:
                relax = torch.ones_like(dxmax)
                bigchold = bigch
            else:
                es = bigch / (ur_state["bigchold"] * ur_state["relaxold"])
                aes = es.abs()
                relax = torch.where(es < -DONE, 0.5 / aes,
                                    (3.0 + es) / (3.0 + aes))
                bigchold = ((DONE - s.gamma) * bigch
                            + s.gamma * ur_state["bigchold"])
            xnew = torch.where((active > 0) & (relax < DONE),
                               xtemp + relax * delx, x)
            return xnew, {**ur_state, "relaxold": relax, "bigchold": bigchold}
        if mode == "dbd":
            if kiter_is_first:
                wsave = torch.ones_like(x)
                hchold = torch.full_like(x, 1e-20)
                deold = torch.zeros_like(x)
            else:
                wsave = ur_state["wsave"]
                hchold = ur_state["hchold"]
                deold = ur_state["deold"]
            ww = torch.where(deold * delx < DZERO, s.theta * wsave,
                             wsave + s.akappa)
            ww = torch.clamp(ww, max=DONE)
            if kiter_is_first:
                hchold_new = delx
            else:
                hchold_new = (DONE - s.gamma) * delx + s.gamma * hchold
            kiter = ur_state["kiter"]
            amom = s.amomentum if kiter > 4 else DZERO
            delx_adj = delx * ww + amom * hchold_new
            xnew = torch.where(active > 0, xtemp + delx_adj, x)
            return xnew, {**ur_state, "wsave": ww, "hchold": hchold_new,
                          "deold": delx, "kiter": kiter + 1}
        raise ValueError(f"unknown under_relaxation {mode!r}")

    def _init_ur_state(self, head):
        """Start-of-step under-relaxation state; ``kiter`` is a host int,
        the rest 0-d or [N] tensors like ``head``."""
        def scalar(v):
            return torch.full((), v, dtype=head.dtype, device=head.device)
        return dict(relaxold=scalar(1.0), bigchold=scalar(1e-20),
                    wsave=torch.ones_like(head),
                    hchold=torch.full_like(head, 1e-20),
                    deold=torch.zeros_like(head), kiter=1)

    # ----------------------------------------------------------- ca

    def solve_timestep(self, head_old, delt, kstp=1, iss=False, pkgs=None,
                       kper=1, ibound_in=None):
        """One time step: Picard loop to convergence (sln_ca).

        Returns (head, SolveInfo, aux) where aux carries (ibound, cond) for
        the output phase; ``cond`` is the conductance on the structured
        planes or per edge (see GwfModel.edge_conductances).  ``ibound_in`` carries the
        dry/wet cell status across steps when NPF rewetting is active (pass
        the previous step's aux["ibound"]).  With rewetting the host reads
        one more flag per outer iteration: whether the sweep changed a cell.
        """
        s = self.s
        model = self.model
        if pkgs is None:
            pkgs = model.packages
        ibound, head = model.boundary_state(head_old, pkgs)
        wetdry = model.wetdry
        if ibound_in is not None:
            # keep cells that dried in earlier steps dry (but let CHD
            # repinning from boundary_state win)
            ibound = torch.where((ibound_in == 0) & (ibound > 0), 0, ibound)
        if wetdry is not None:
            # hold = bot at dry wettable cells so rewetted storage terms
            # reference the cell bottom (gwf-npf.f90:395-400 irestore)
            head = torch.where((ibound == 0) & (wetdry != 0.0),
                               model.npf_arrays.bot, head)
            wetfct, iwetit, ihdwet = model.rewet_opts
        head_old_adj = head  # CHD cells pinned in old head too (model_ad)
        ur_state = self._init_ur_state(head)
        use_bt = s.backtracking_number > 0
        iss = bool(iss)
        use_ptc = self._use_ptc(iss, kper)
        delt = float(delt)
        kstp = int(kstp)

        total_inner = 0
        dv_hist = []
        inner_traces = []
        converged = False
        kiter = 0
        res_prev = torch.zeros((), dtype=head.dtype, device=head.device)
        head_prev = head
        for kiter in range(1, s.outer_maximum + 1):
            wd_changed = None
            if wetdry is not None:
                # npf_cf wetting/drying sweep before formulate
                kw = dict(iwetit=iwetit, ihdwet=ihdwet, wetfct=wetfct)
                if model.use_structured:
                    ibound, head, wd_changed = npf_mod.wetdry_update(
                        model.dtopo, model.npf_arrays, wetdry,
                        model.ibound0, ibound, head, kiter, **kw)
                else:
                    ibound, head, wd_changed = npf_mod.wetdry_update_edges(
                        model.dtopo, model.npf_arrays, wetdry, ibound, head,
                        kiter, **kw)
            if use_bt:
                head, res_prev = self._backtrack(
                    head, head_prev, head_old_adj, ibound, delt, res_prev,
                    pkgs, iss=iss, kiter_is_first=(kiter == 1))
            head_prev = head
            head, conv, dxmax, inner, ur_state = self._outer_iter(
                head, head_old_adj, ibound, delt, kstp, ur_state, pkgs,
                iss=iss, kiter_is_first=(kiter == 1), use_ptc=use_ptc)
            total_inner += inner
            # the one host read of the outer iteration
            flags = [conv.to(dxmax.dtype), dxmax]
            if wd_changed is not None:
                flags.append(wd_changed.to(dxmax.dtype))
            conv, dxmax, *changed = torch.stack(flags).tolist()
            dv_hist.append(dxmax)
            if s.csv_inner_path and "inner_trace" in ur_state:
                inner_traces.append(
                    (kiter, inner) + tuple(t.cpu().numpy() for t in
                                           ur_state["inner_trace"]))
            if conv and not any(changed):
                converged = True
                break
        info = SolveInfo(converged, kiter, total_inner,
                         dv_hist[-1] if dv_hist else 0.0, dv_hist,
                         inner_traces if s.csv_inner_path else None)
        cond = model.edge_conductances(head, ibound, pkgs)
        return head, info, dict(ibound=ibound, cond=cond)
