"""Parity of the port's ``NumericalSolution`` (the per-outer-iteration
Picard loop of the deck path) and ``bicgstab`` with the reference.

Tolerances:

- ``solve_timestep`` in ``f64`` with CG: equal outer and inner counts,
  heads within atol 1e-10 (PyTorch and XLA sum the dot products in other
  orders; see tests/test_torch_solve.py), ``dvmax_history`` within rtol
  1e-8; equal to the port's fused step at 1e-12 with the same outer count
  (the reference's own bar, tests/test_fused.py:34-47); ``mixed`` against
  ``f64`` at 1e-7 (tests/test_fused.py:67-86).
  ``dvmax_history`` is a difference of two head iterates of size ~20,
  which agree between the packages only as the heads do, so it also gets
  atol 1e-11.
- under-relaxation and backtracking on an unconfined model: equal outer
  and inner counts, ``dvmax_history`` within rtol 1e-8 (atol 1e-11), heads
  within 1e-9.
- ``bicgstab`` on one structured system with a skew part: equal counts and
  x within 1e-10 of the reference, jitted or run op by op.
- the outer loop with BiCGSTAB on the unconfined model: equal outer
  counts and heads within 1e-7, but not equal inner counts against the
  jitted reference: BiCGSTAB turns the rounding of the dot products (their
  sum order, XLA's fused multiply-adds) into a few iterations more or
  less.  With the reference run op by op and its sums taken in PyTorch's
  order the inner counts are equal and the heads agree at 1e-10
  (``test_bicgstab_outer_loop_counts_at_one_sum_order``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fused import tight
from test_torch_parity import build_both, convertible_args, fused_model_args
from modflow6_tpu.ops import system as jsystem
from modflow6_tpu.ops.solvers import krylov as jkrylov
from modflow6_tpu.ops.solvers.precond import \
    jacobi_precondition as jax_jacobi
from modflow6_tpu.ops.system import spmv_structured as jax_spmv_structured
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxNumericalSolution
from modflow6_torch.models.gwf.npf import DeviceTopology
from modflow6_torch.ops.solvers import krylov as tkrylov
from modflow6_torch.ops.solvers.precond import jacobi_precondition
from modflow6_torch.ops.system import make_matvec
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.fused import make_fused_step
from modflow6_torch.solution.ims import NumericalSolution, SolveInfo

ATOL = 1e-10


def _port_settings(settings):
    return ImsSettings(**vars(settings))


def _march(solution, head, delts, as_numpy):
    """Steps of solve_timestep → [(head, SolveInfo)]."""
    out = []
    for kstp, delt in enumerate(delts, 1):
        head, info, aux = solution.solve_timestep(head, delt, kstp=kstp,
                                                  iss=False)
        out.append((as_numpy(head), info))
    return out


def _march_both(args, settings, delts):
    ref, port = build_both(args)
    want = _march(JaxNumericalSolution(ref, settings), jnp.asarray(ref.strt),
                  delts, np.asarray)
    got = _march(NumericalSolution(port, _port_settings(settings)),
                 port.strt, delts, lambda h: h.numpy())
    return want, got


def _assert_same_march(want, got, head_atol, inner=True, dv_atol=1e-11):
    for (wh, wi), (gh, gi) in zip(want, got):
        assert isinstance(gi, SolveInfo)
        assert gi.converged and wi.converged
        assert gi.outer_iterations == wi.outer_iterations
        if inner:
            assert gi.inner_iterations == wi.inner_iterations
        np.testing.assert_allclose(gi.dvmax_history, wi.dvmax_history,
                                   rtol=1e-8, atol=dv_atol)
        assert gi.dvmax_outer == gi.dvmax_history[-1]
        np.testing.assert_allclose(gh, wh, rtol=0, atol=head_atol)


def test_solve_timestep_matches_reference_f64():
    want, got = _march_both(fused_model_args(), tight(), [1.0, 2.0])
    _assert_same_march(want, got, ATOL)
    assert got[0][1].inner_iterations > 10


def test_solve_timestep_equals_fused_step():
    """The Python-loop step and the fused step of the port: heads at 1e-12
    with the same outer count."""
    port = build_both(fused_model_args())[1]
    settings = _port_settings(tight())
    head, info, aux = NumericalSolution(port, settings).solve_timestep(
        port.strt, 1.0, kstp=1, iss=False)
    fhead, kiter, inner, conv = make_fused_step(port, settings, iss=False)(
        port.strt, 1.0, 1)
    assert conv and info.converged
    assert (kiter, inner) == (info.outer_iterations, info.inner_iterations)
    np.testing.assert_allclose(head.numpy(), fhead.numpy(), rtol=0,
                               atol=1e-12)
    assert aux["ibound"].dtype == torch.int32
    assert [tuple(c.shape) for c in aux["cond"]] == [(1, 12, 9), (1, 11, 10),
                                                     (0, 12, 10)]


def test_solve_timestep_mixed_matches_f64():
    port = build_both(fused_model_args())[1]
    settings = _port_settings(tight())
    h64, i64, _ = NumericalSolution(port, settings).solve_timestep(
        port.strt, 1.0, iss=False)
    h_mixed, i_mixed, _ = NumericalSolution(
        port, dataclasses.replace(settings, precision="mixed")
    ).solve_timestep(port.strt, 1.0, iss=False)
    assert i64.converged and i_mixed.converged
    assert h_mixed.dtype == torch.float64
    np.testing.assert_allclose(h_mixed.numpy(), h64.numpy(), rtol=0,
                               atol=1e-7)


def test_solve_timestep_mixed_matches_reference_mixed():
    settings = dataclasses.replace(tight(), precision="mixed")
    want, got = _march_both(fused_model_args(), settings, [1.0])
    assert got[0][1].converged and want[0][1].converged
    assert got[0][1].outer_iterations == want[0][1].outer_iterations
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=0, atol=1e-7)


UNCONFINED = dict(outer_dvclose=1e-7, outer_maximum=200, inner_dvclose=1e-10,
                  inner_rclose=1e-9, inner_maximum=500)


@pytest.mark.parametrize("kw", [
    dict(under_relaxation="none"),
    dict(under_relaxation="simple", gamma=0.7),
    dict(under_relaxation="cooley", gamma=0.3),
    dict(under_relaxation="dbd", theta=0.8, akappa=1e-3, gamma=0.1,
         amomentum=0.05),
    dict(under_relaxation="simple", gamma=0.9, backtracking_number=5,
         backtracking_tolerance=1.01, backtracking_reduction_factor=0.5,
         backtracking_residual_limit=1e-3),
    dict(under_relaxation="none", backtracking_number=2,
         backtracking_tolerance=5e-3, backtracking_reduction_factor=0.5,
         backtracking_residual_limit=1e-9),
], ids=["none", "simple", "cooley", "dbd", "backtrack", "backtrack-hard"])
def test_under_relaxation_and_backtracking_match_reference(kw):
    """An unconfined model (icelltype=1, no Newton): the system depends on
    the head iterate, so the outer loop takes several iterations and the
    under-relaxation state carries across them."""
    settings = JaxImsSettings(**UNCONFINED, **kw)
    want, got = _march_both(convertible_args(), settings, [5.0])
    # the hard backtracking case really pulls the iterate back: without
    # backtracking the step takes 5 outer iterations
    assert want[0][1].outer_iterations > (
        20 if kw.get("backtracking_number") == 2 else 2)
    _assert_same_march(want, got, 1e-9)


@pytest.mark.parametrize("case", ["cooley-oscillating", "cooley-steady",
                                  "dbd-early", "dbd-momentum", "simple"])
def test_under_relax_step_matches_reference(case):
    """One call of ``_under_relax`` on random iterates and a carried state,
    on both sides of each scheme's branches: Cooley with the change
    reversing sign by more than the last one (es < -1) and not, DBD before
    and after the momentum term sets in (kiter > 4), with cells whose
    change reversed and cells whose change kept its sign."""
    rng = np.random.default_rng(8)
    n = 40
    xtemp = rng.normal(20.0, 1.0, n)
    x = xtemp + rng.normal(0.0, 0.5, n)
    active = rng.integers(-1, 2, n)
    mode = case.split("-")[0]
    settings = dict(under_relaxation=mode, gamma=0.3, theta=0.7,
                    akappa=0.05, amomentum=0.2)
    dxmax = {"cooley-oscillating": -0.9, "cooley-steady": 0.4}.get(case, 0.5)
    state = dict(relaxold=0.8, bigchold=0.6,
                 wsave=rng.uniform(0.3, 1.0, n), hchold=rng.normal(0, 0.1, n),
                 deold=rng.normal(0.0, 0.5, n),
                 kiter=7 if case == "dbd-momentum" else 2)
    ref, port = build_both(fused_model_args())
    want_x, want_state = JaxNumericalSolution(
        ref, JaxImsSettings(**settings))._under_relax(
        jnp.asarray(x), jnp.asarray(xtemp), jnp.asarray(active),
        jnp.asarray(dxmax),
        {k: jnp.asarray(v) for k, v in state.items()}, False)

    def tensor(v):
        return torch.as_tensor(v, dtype=torch.float64)

    got_x, got_state = NumericalSolution(
        port, ImsSettings(**settings))._under_relax(
        tensor(x), tensor(xtemp), torch.as_tensor(active), tensor(dxmax),
        {k: v if k == "kiter" else tensor(v) for k, v in state.items()},
        False)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-14)
    assert got_state.keys() == want_state.keys()
    for key, w in want_state.items():
        np.testing.assert_allclose(np.asarray(got_state[key], np.float64),
                                   np.asarray(w), rtol=1e-14, err_msg=key)


BICGSTAB_OUTER = dict(outer_dvclose=1e-5, outer_maximum=100,
                      inner_dvclose=1e-8, inner_rclose=1e-7,
                      inner_maximum=500, under_relaxation="dbd", theta=0.8,
                      akappa=1e-3, gamma=0.1, amomentum=0.05,
                      linear_acceleration="bicgstab")


def test_bicgstab_outer_loop_matches_reference():
    settings = JaxImsSettings(**BICGSTAB_OUTER)
    want, got = _march_both(convertible_args(), settings, [5.0])
    print("inner counts: reference", want[0][1].inner_iterations, "port",
          got[0][1].inner_iterations)
    # each outer iterate is an inner solve closed at inner_dvclose 1e-8
    _assert_same_march(want, got, 1e-7, inner=False, dv_atol=1e-7)


def _torch_order_dot(a, b):
    """The reference's dot product with its sum taken by torch.sum, so
    both packages reduce in one order."""
    return jnp.asarray(torch.sum(torch.from_numpy(np.array(a * b))).numpy())


def test_bicgstab_outer_loop_counts_at_one_sum_order(monkeypatch):
    """The cause of the inner-count difference above: with the reference
    run op by op (no fused multiply-adds) and its dot products summed as
    PyTorch sums them, the BiCGSTAB outer loop has equal outer and inner
    counts and heads within 1e-10.  The reference keeps its own structured
    product here: the other tests at one sum order swap the port's plain
    product into it (``stencil_in_torch``) to run faster."""
    monkeypatch.setitem(jkrylov.bicgstab.__kwdefaults__, "dot",
                        _torch_order_dot)
    assert jsystem.spmv_structured is jax_spmv_structured
    settings = JaxImsSettings(**BICGSTAB_OUTER)
    with jax.disable_jit():
        want, got = _march_both(convertible_args(), settings, [5.0])
    _assert_same_march(want, got, ATOL)


@pytest.mark.parametrize("level", ["simple", "moderate", "complex"])
def test_from_complexity_matches_reference(level):
    assert vars(ImsSettings.from_complexity(level)) == vars(
        JaxImsSettings.from_complexity(level))
    assert vars(ImsSettings()) == vars(JaxImsSettings())


@pytest.mark.parametrize("kw", [dict(linear_acceleration="gmres"),
                                dict(under_relaxation="line"),
                                dict(precision="bf16"),
                                dict(preconditioner="ilu"),
                                dict(precision="mixed",
                                     csv_inner_path="inner.csv")])
def test_numerical_solution_raises_outside_the_slice(kw):
    port = build_both(fused_model_args())[1]
    with pytest.raises((NotImplementedError, ValueError)):
        NumericalSolution(port, ImsSettings(**kw)).solve_timestep(
            port.strt, 1.0, iss=False)
    with pytest.raises(ValueError):
        ImsSettings.from_complexity("extreme")


def test_inner_trace_matches_reference(tmp_path):
    """CSV_INNER_OUTPUT: the per-inner-iteration (dvmax, rmax, l2norm) rows
    of each outer iteration."""
    settings = dataclasses.replace(tight(),
                                   csv_inner_path=str(tmp_path / "i.csv"))
    want, got = _march_both(fused_model_args(), settings, [1.0])
    wt, gt = want[0][1].inner_traces, got[0][1].inner_traces
    assert len(gt) == len(wt) == got[0][1].outer_iterations
    for (wk, wn, *wrows), (gk, gn, *grows) in zip(wt, gt):
        assert (gk, gn) == (wk, wn)
        for w, g in zip(wrows, grows):
            assert g.shape == (gn,)
            np.testing.assert_allclose(g, w[:wn], rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------- bicgstab

# diagonal surplus over the off-diagonal row sum: the system the parity
# test solves, and one twenty times closer to singular
EASY, HARD = (0.3, 0.6), (0.01, 0.1)


def _skew_system(margin=EASY, seed=3, shape=(2, 14, 11)):
    """A structured system that is not symmetric: a diagonally dominant
    negative-definite 7-point matrix (as the assembly gives) plus a skew
    part on every connection; numpy arrays for both packages."""
    rng = np.random.default_rng(seed)
    nlay, nrow, ncol = shape
    n = nlay * nrow * ncol
    c = rng.uniform(0.5, 2.0, shape + (6,))
    # slots [E, W, N, S, U, D]: make the pairs symmetric, then add the skew
    c[:, :, 1:, 1] = c[:, :, :-1, 0]
    c[:, 1:, :, 2] = c[:, :-1, :, 3]
    c[1:, :, :, 4] = c[:-1, :, :, 5]
    c[:, :, -1, 0] = c[:, :, 0, 1] = 0.0
    c[:, 0, :, 2] = c[:, -1, :, 3] = 0.0
    c[0, :, :, 4] = c[-1, :, :, 5] = 0.0
    diag = -(c.sum(axis=-1) + rng.uniform(*margin, shape))
    skew = rng.uniform(-0.3, 0.3, shape + (3,))
    c[:, :, :-1, 0] += skew[:, :, :-1, 0]
    c[:, :, 1:, 1] -= skew[:, :, :-1, 0]
    c[:, :-1, :, 3] += skew[:, :-1, :, 1]
    c[:, 1:, :, 2] -= skew[:, :-1, :, 1]
    c[:-1, :, :, 5] += skew[:-1, :, :, 2]
    c[1:, :, :, 4] -= skew[:-1, :, :, 2]
    return (shape, diag.reshape(n), c.reshape(n, 6), rng.normal(0, 1.0, n),
            rng.normal(0, 1.0, n))


BICGSTAB_KW = dict(itmax=500, dvclose=1e-10, rclose=1e-9)


def _bicgstab_both(icnvgopt, jit, trace=False, margin=EASY,
                   dot=jkrylov.vector_dot):
    shape, diag, off, b, x0 = _skew_system(margin)
    jd, jo, jb, jx = (jnp.asarray(v) for v in (diag, off, b, x0))

    def jmv(x):
        return jax_spmv_structured(shape, jd, jo, x)

    def solve():
        return jkrylov.bicgstab(jmv, jb, jx, jax_jacobi(jd),
                                icnvgopt=icnvgopt, l2norm0=1.0,
                                epfact_val=jkrylov.epfact(icnvgopt, 1),
                                trace=trace, dot=dot, **BICGSTAB_KW)

    if jit:
        want = jax.jit(solve)()
    else:
        with jax.disable_jit():
            want = solve()
    td, to, tb, tx = (torch.as_tensor(v, dtype=torch.float64)
                      for v in (diag, off, b, x0))
    got = tkrylov.bicgstab(make_matvec(DeviceTopology(shape), td, to), tb, tx,
                           jacobi_precondition(td), icnvgopt=icnvgopt,
                           l2norm0=1.0,
                           epfact_val=tkrylov.epfact(icnvgopt, 1),
                           trace=trace, **BICGSTAB_KW)
    return want, got


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("icnvgopt", [0, 1, 2, 3, 4])
def test_bicgstab_matches_reference(icnvgopt, jit):
    want, got = _bicgstab_both(icnvgopt, jit)
    assert bool(got.converged) == bool(want.converged)
    assert got.iters == int(want.iters) > 5
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=ATOL)


def test_bicgstab_counts_follow_the_sum_order_near_singular():
    """On the system twenty times closer to singular BiCGSTAB needs more
    iterations than the reference's own count is stable for: the reference
    jitted and run op by op differ from each other (203 and 63 iterations
    where this was written) and from the port (84).  That is rounding, not
    the algorithm: run op by op with its dot products summed as PyTorch sums
    them, the reference has the port's count and its x within 1e-10."""
    jitted, got = _bicgstab_both(0, jit=True, margin=HARD)
    eager, _ = _bicgstab_both(0, jit=False, margin=HARD)
    same_order, _ = _bicgstab_both(0, jit=False, margin=HARD,
                                   dot=_torch_order_dot)
    print("iterations: reference jitted", int(jitted.iters), "op by op",
          int(eager.iters), "op by op in torch's sum order",
          int(same_order.iters), "port", got.iters)
    assert bool(got.converged) and bool(same_order.converged)
    assert got.iters == int(same_order.iters)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(same_order.x),
                               rtol=0, atol=ATOL)


def test_bicgstab_solves_the_skew_system():
    """The system is not symmetric, and x solves it."""
    shape, diag, off, b, x0 = _skew_system()
    c = off.reshape(shape + (6,))
    assert np.abs(c[:, :, :-1, 0] - c[:, :, 1:, 1]).max() > 0.1
    _, got = _bicgstab_both(0, jit=True)
    td, to = (torch.as_tensor(v, dtype=torch.float64) for v in (diag, off))
    r = torch.as_tensor(b) - make_matvec(DeviceTopology(shape), td, to)(got.x)
    assert float(r.abs().max()) <= 1e-8


def test_bicgstab_trace_rows():
    want, got = _bicgstab_both(0, jit=True, trace=True)
    n = got.iters
    assert len(got.trace) == 3
    for w, g in zip(want.trace, got.trace):
        assert g.shape == (n,)
        # the rows fall to the closure criteria (1e-10); the iterates of
        # the two packages agree to ~1e-11 there
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:n], rtol=1e-6,
                                   atol=1e-10)
    assert float(got.trace[0][-1]) == float(got.dvmax)


def test_dirichlet_fixup_without_symmetry_matches_reference():
    """BiCGSTAB's branch of the pre-solve fixup (symmetric=False) leaves the
    couplings to constant-head columns in the matrix."""
    from test_torch_parity import flagship_args
    from modflow6_tpu.ops.system import \
        apply_dirichlet_structured as jax_fixup
    from modflow6_torch.ops.system import apply_dirichlet_structured
    ref, port = build_both(flagship_args(2, 8, 7))
    ib, h = ref.boundary_state(jnp.asarray(ref.strt))
    diag, off, rhs = ref.assemble(h, h, ib, 1.0, False)
    act = jnp.where(ib > 0, 1, jnp.where(ib < 0, -1, 0))
    want = jax_fixup(ref.dtopo.grid_shape, act, diag, off, rhs, h,
                     symmetric=False)
    ib, h = port.boundary_state(port.strt)
    diag, off, rhs = port.assemble(h, h, ib, 1.0, False)
    got = apply_dirichlet_structured(port.dtopo.grid_shape, torch.sign(ib),
                                     diag, off, rhs, h, symmetric=False)
    sym = apply_dirichlet_structured(port.dtopo.grid_shape, torch.sign(ib),
                                     diag, off, rhs, h)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=0)
    assert not torch.equal(got[1], sym[1])
