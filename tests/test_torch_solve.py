"""Parity of the port's Krylov solvers and fused time step with the
reference, and the port's isolation from JAX.

Tolerances:

- ``cg`` on one assembled system, and the fused run in ``f64``: equal
  iteration counts, heads within atol 1e-10.  PyTorch and
  XLA sum the dot products in different orders, so the iterates differ at
  rounding level and the differences grow over the iterations; 1e-10 is
  well above that and well below every closure criterion used here.
- ``refined_solve`` (mixed precision): equal counts, x within atol 2e-9,
  the spread that the order of the float32 sums alone gives (see
  ``test_refined_solve_spread_is_sum_order``); with that order made the
  same in both packages, equal counts and x within 1e-10
  (``test_refined_solve_matches_reference_at_one_sum_order``).
- the port's ``mixed`` run against the reference's ``f64`` run: atol
  1e-7, the bar of tests/test_fused.py:67-79.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship
from test_fused import make_model, tight
from test_torch_parity import (build_both, convert, convertible_args,
                               flagship_args, fused_model_args)
from modflow6_tpu.ops.solvers import krylov as jkrylov
from modflow6_tpu.ops.solvers.precond import \
    jacobi_precondition as jax_jacobi
from modflow6_tpu.ops.system import apply_dirichlet_structured as jax_fixup
from modflow6_tpu.ops.system import make_matvec as jax_make_matvec
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution.fused import make_fused_run as jax_fused_run
from modflow6_tpu.solution.fused import make_fused_step as jax_fused_step
from modflow6_torch.ops import stencil
from modflow6_torch.ops.solvers import krylov as tkrylov
from modflow6_torch.ops.solvers.precond import jacobi_precondition
from modflow6_torch.ops.system import apply_dirichlet_structured
from modflow6_torch.ops.system import make_matvec
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.fused import make_fused_run, make_fused_step

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-10


def _port_settings(settings):
    """The port's ImsSettings with the fields of a reference ImsSettings."""
    return ImsSettings(**vars(settings))


def _systems(seed=0):
    """One assembled, fixed-up flagship system in both packages, with a
    start vector away from the solution."""
    ref, port = build_both(flagship_args(2, 24, 20))
    rng = np.random.default_rng(seed)
    h0 = 40.0 + rng.normal(0.0, 1.0, ref.nodes)

    ib, h = ref.boundary_state(jnp.asarray(h0))
    diag, off, rhs = ref.assemble(h, h, ib, 1.0, False)
    act = jnp.where(ib > 0, 1, jnp.where(ib < 0, -1, 0))
    jsys = jax_fixup(ref.dtopo.grid_shape, act, diag, off, rhs, h) + (h,)

    ib, h = port.boundary_state(torch.as_tensor(h0, dtype=torch.float64))
    diag, off, rhs = port.assemble(h, h, ib, 1.0, False)
    tsys = apply_dirichlet_structured(port.dtopo.grid_shape, torch.sign(ib),
                                      diag, off, rhs, h) + (h,)
    return ref, port, jsys, tsys


SOLVE_KW = dict(itmax=2000, dvclose=1e-10, rclose=1e-9)


@pytest.mark.parametrize("icnvgopt", [0, 1, 2, 3, 4])
def test_cg_matches_reference(icnvgopt):
    ref, port, (jd, jo, jr, jh), (td, to, tr, th) = _systems()
    jmv = jax_make_matvec(ref.dtopo, jd, jo)
    tmv = make_matvec(port.dtopo, td, to)
    jr0 = jr - jmv(jh)
    tr0 = tr - tmv(th)
    want = jax.jit(lambda: jkrylov.cg(
        jmv, jr, jh, jax_jacobi(jd), icnvgopt=icnvgopt,
        l2norm0=jnp.sqrt(jnp.sum(jr0 * jr0)),
        epfact_val=jkrylov.epfact(icnvgopt, 1), **SOLVE_KW))()
    got = tkrylov.cg(tmv, tr, th, jacobi_precondition(td), icnvgopt=icnvgopt,
                     l2norm0=torch.sqrt(torch.sum(tr0 * tr0)),
                     epfact_val=tkrylov.epfact(icnvgopt, 1), **SOLVE_KW)
    assert got.iters == int(want.iters)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=ATOL)


def _refined_both(icnvgopt, jit, dot=jkrylov.vector_dot):
    """refined_solve on one system in both packages: the reference jitted
    or run op by op (``jax.disable_jit``: no fusion, so no contracted
    multiply-adds), with ``dot`` as its reduction."""
    ref, port, (jd, jo, jr, jh), (td, to, tr, th) = _systems()
    jmv = jax_make_matvec(ref.dtopo, jd, jo)
    jd32, jo32 = jd.astype(jnp.float32), jo.astype(jnp.float32)
    jmv32 = jax_make_matvec(ref.dtopo, jd32, jo32)
    tmv = make_matvec(port.dtopo, td, to)
    td32, to32 = td.to(torch.float32), to.to(torch.float32)
    tmv32 = make_matvec(port.dtopo, td32, to32)
    kw = dict(itmax=400, dvclose=1e-9, rclose=1e-4, icnvgopt=icnvgopt,
              l2norm0=1.0)

    def solve():
        return jkrylov.refined_solve(
            jkrylov.cg, jmv, jmv32, jr, jh, jax_jacobi(jd32), dot=dot,
            epfact_val=jkrylov.epfact(icnvgopt, 1), **kw)

    if jit:
        want = jax.jit(solve)()
    else:
        with jax.disable_jit():
            want = solve()
    got = tkrylov.refined_solve(tmv, tmv32, tr, th,
                                jacobi_precondition(td32),
                                epfact_val=tkrylov.epfact(icnvgopt, 1), **kw)
    return want, got


# spread of x between two runs of refined_solve that differ only in the
# order of their float32 sums (see test_refined_solve_spread_is_sum_order)
MIXED_X_ATOL = 2e-9


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("icnvgopt", [0, 2])
def test_refined_solve_matches_reference(icnvgopt, jit):
    """Mixed precision: equal inner-iteration counts and x within
    MIXED_X_ATOL of the reference, jitted or run op by op.  x is not held to
    1e-10: its f32 passes sum their dot products in another order than
    XLA's, and in f32 that moves x by ~1e-9 on this system (shown by the
    next test), well inside the solve's own error (~8e-9 from the exact
    solution at dvclose 1e-9)."""
    want, got = _refined_both(icnvgopt, jit)
    assert bool(got.converged) and bool(want.converged)
    assert got.iters == int(want.iters)
    assert got.x.dtype == torch.float64
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=MIXED_X_ATOL)


@pytest.mark.parametrize("icnvgopt", [0, 2])
def test_refined_solve_spread_is_sum_order(icnvgopt):
    """The cause of the port's x spread in mixed precision: the reference
    run op by op with its f32 dot products summed in reverse order (the
    same arithmetic, other rounding) moves x further from itself than the
    port is from it, and beyond 1e-10."""
    want, got = _refined_both(icnvgopt, jit=False)
    other, _ = _refined_both(icnvgopt, jit=False,
                             dot=lambda a, b: jnp.sum((a * b)[::-1]))
    port_spread = np.abs(got.x.numpy() - np.asarray(want.x)).max()
    order_spread = np.abs(np.asarray(other.x) - np.asarray(want.x)).max()
    assert bool(other.converged)
    assert 1e-10 < order_spread <= MIXED_X_ATOL
    assert port_spread <= order_spread


def _torch_order_dot(a, b):
    """The reference's dot product with its sum taken by torch.sum, so
    both packages reduce in one order."""
    return jnp.asarray(torch.sum(torch.from_numpy(np.array(a * b))).numpy())


@pytest.mark.parametrize("icnvgopt", [0, 2])
def test_refined_solve_matches_reference_at_one_sum_order(icnvgopt):
    """With the sum order taken out (the reference run op by op, its
    reductions summed as torch sums them), the port's mixed-precision solve
    meets the f64 bar: equal counts and x within 1e-10."""
    want, got = _refined_both(icnvgopt, jit=False, dot=_torch_order_dot)
    assert bool(got.converged) and bool(want.converged)
    assert got.iters == int(want.iters)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=ATOL)


def test_solver_helpers_match_reference():
    v = np.array([3.0, -7.0, 7.0, 1.0, -7.0])
    assert float(tkrylov._signed_absmax(torch.as_tensor(v))) == float(
        jkrylov._signed_absmax(jnp.asarray(v))) == -7.0
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.float64, jnp.float64)):
        eps = float(jnp.finfo(jdt).eps)
        for a, b in ((1.0, 1.0 + 50 * eps), (1.0, 1.0 + 200 * eps),
                     (0.0, 0.0), (-2.0, 2.0)):
            assert bool(tkrylov._is_close(torch.tensor(a, dtype=dtype),
                                          torch.tensor(b, dtype=dtype))) == \
                bool(jkrylov._is_close(jnp.asarray(a, jdt),
                                       jnp.asarray(b, jdt)))
        for x in (0.0, -1e-30, 3.0):
            assert float(tkrylov._sign_dprec(torch.tensor(x, dtype=dtype))) \
                == float(jkrylov._sign_dprec(jnp.asarray(x, jdt)))
    for icnvgopt in range(5):
        for kstp in (1, 2):
            assert tkrylov.epfact(icnvgopt, kstp) == float(
                jkrylov.epfact(icnvgopt, jnp.asarray(kstp)))


def _run_both(ref, port, settings, delts):
    jrun = jax.jit(jax_fused_run(ref, settings, iss=False,
                                 nsteps=len(delts)))
    jh, jk, ji, jc = jrun(jnp.asarray(ref.strt), jnp.asarray(delts))
    trun = make_fused_run(port, _port_settings(settings), iss=False,
                          nsteps=len(delts))
    th, tk, ti, tc = trun(port.strt, delts)
    return (np.asarray(jh), list(np.asarray(jk)), list(np.asarray(ji)),
            list(np.asarray(jc))), (th.numpy(), tk, ti, tc)


@pytest.mark.parametrize("route", ["build_gwf", "from_reference"])
@pytest.mark.parametrize("name", ["fused", "convertible"])
def test_fused_run_matches_reference_f64(name, route):
    """The slice: three fused steps at the tests/test_fused.py:14-18
    settings, hoisted (linear) and per-iteration (convertible) assembly."""
    if name == "fused":
        ref, args = make_model(), fused_model_args()
    else:
        args = convertible_args()
        ref = build_both(args)[0]
    port = build_both(args)[1] if route == "build_gwf" else convert(ref)
    want, got = _run_both(ref, port, tight(), [1.0, 1.5, 2.25])
    assert all(want[3]) and all(got[3])
    assert got[1] == want[1] and got[2] == want[2]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)


def test_fused_run_simple_under_relaxation_matches_reference():
    args = convertible_args()
    ref, port = build_both(args)
    settings = tight(under_relaxation="simple", gamma=0.8)
    want, got = _run_both(ref, port, settings, [1.0, 2.0])
    assert all(want[3]) and all(got[3])
    assert got[1] == want[1] and got[2] == want[2]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)


def test_mixed_precision_matches_reference_f64():
    """tests/test_fused.py:67-79 across the packages: the port's mixed
    run against the reference's f64 run."""
    model = make_model()
    port = convert(model)
    delts = [1.0, 2.0, 4.0]
    jrun = jax.jit(jax_fused_run(model, tight(), iss=False, nsteps=3))
    h64, _, _, c64 = jrun(jnp.asarray(model.strt), jnp.asarray(delts))
    run = make_fused_run(port, _port_settings(tight(precision="mixed")),
                         iss=False, nsteps=3)
    hmx, _, _, cmx = run(port.strt, delts)
    assert bool(c64.all()) and all(cmx)
    np.testing.assert_allclose(hmx.numpy(), np.asarray(h64), rtol=0,
                               atol=1e-7)


def test_flagship_entry_step_matches_reference():
    """One fused step at the settings of __graft_entry__.entry(), the
    check chip_smoke.py makes between the card and the CPU."""
    ref = _flagship(2, 64, 64)
    port = convert(ref)
    settings = JaxImsSettings(outer_dvclose=1e-6, outer_maximum=50,
                              inner_dvclose=1e-8, inner_rclose=1e-6,
                              inner_maximum=300)
    jh, jk, ji, jc = jax.jit(jax_fused_step(ref, settings, iss=False))(
        jnp.asarray(ref.strt), jnp.asarray(1.0), jnp.asarray(1, jnp.int32))
    th, tk, ti, tc = make_fused_step(port, _port_settings(settings),
                                     iss=False)(port.strt, 1.0, 1)
    assert bool(jc) and tc
    assert (tk, ti) == (int(jk), int(ji))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("kw", [dict(linear_acceleration="gmres"),
                                dict(under_relaxation="dbd"),
                                dict(preconditioner="ilu"),
                                dict(precision="bf16")])
def test_fused_step_raises_outside_the_slice(kw):
    port = convert(make_model())
    with pytest.raises((NotImplementedError, ValueError)):
        make_fused_step(port, ImsSettings(**kw), iss=False)(port.strt, 1.0, 1)


def test_cpu_run_launches_no_kernel():
    port = build_both(fused_model_args())[1]
    stencil.stencil7.launches = 0
    make_fused_run(port, _port_settings(tight()), iss=False,
                   nsteps=1)(port.strt, [1.0])
    assert stencil.stencil7.launches == 0


def _python(*args, **env):
    """Run the interpreter in the repository root with extra environment."""
    return subprocess.run([sys.executable, *args], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO), **env),
                          capture_output=True, text=True, timeout=300)


def test_port_runs_without_jax():
    """Every modflow6_torch module imports, and a small step runs on the
    CPU, in an interpreter where JAX cannot be imported."""
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["modflow6_tpu"] = None
import numpy as np
import modflow6_torch
names = [m.name for m in pkgutil.walk_packages(modflow6_torch.__path__,
                                               "modflow6_torch.")]
assert {"modflow6_torch.bench", "modflow6_torch.entry",
        "modflow6_torch.tools.iteration_study",
        "modflow6_torch.tools.halo_study"} <= set(names)
for name in names:
    importlib.import_module(name)
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.fused import make_fused_step
g = DisGrid.create(2, 6, 5, 10.0, 10.0, 20.0,
                   np.array([10.0, 0.0])[:, None, None] * np.ones((2, 6, 5)))
m = build_gwf("nojax", g, k=2.0, strt=15.0, storage={"ss": 1e-5},
              chd=[(0, 16.0), (59, 14.0)], wel=[(32, -1.0)], device="cpu")
h, kiter, inner, conv = make_fused_step(
    m, ImsSettings(outer_dvclose=1e-8, inner_dvclose=1e-10,
                   inner_rclose=1e-9, inner_maximum=500), iss=False)(
    m.strt, 1.0, 1)
assert conv and inner > 0, (kiter, inner)
assert not [k for k, v in sys.modules.items()
            if v is not None and k.split(".")[0] in ("jax", "modflow6_tpu")]
print("modules", len(names))
"""
    proc = _python("-c", code)
    assert proc.returncode == 0, proc.stderr
    assert "modules" in proc.stdout


def test_chip_smoke_fails_without_cuda():
    """chip_smoke.py has no CPU fallback: where CUDA is absent it exits
    non-zero and prints no result line."""
    proc = _python("chip_smoke.py", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA" in proc.stderr
