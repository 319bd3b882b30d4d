"""Parity of the port's preconditioners (Neumann, Chebyshev with its power
iteration, geometric multigrid) with the reference, on the CPU.

Inputs are numpy arrays made from a seed and given to both packages.

Tolerances:

- one application ``apply(r)`` and ``estimate_lambda_max`` in float64:
  rtol 1e-12 of the largest entry (the same operations in the same order;
  only the order of the power iteration's sums and of the pooling sums
  differs).  In float32: 2e-5 of the largest entry, the bar of the stencil
  product itself (tests/test_fused.py:113), for one application; for
  ``estimate_lambda_max`` rtol 1e-5 (ten normalised products, each rounded
  to 6e-8).
- ``_coarsen``/``_restrict``/``_prolong``: rtol 1e-14 in float64 (sums of
  four numbers in another order), 1e-6 in float32.
- whole solves with CG in float64: equal outer and inner counts, heads
  within 1e-10 (the bar of tests/test_torch_ims.py), on the models where
  the reference's own counts are stable.  On the flagship model (lognormal
  K, the last outer iteration solving to rounding) the inner counts
  differ by a few from the jitted reference, with Jacobi as with any other
  preconditioner (the reference jitted and run op by op differ from each
  other there); the heads are held to 1e-10 all the same, and
  ``test_flagship_counts_follow_the_sum_order`` shows the cause: with the
  reference's dot products summed in PyTorch's order the counts are equal.
  The dense 1-D system needs more CG iterations than it has unknowns; its
  counts are held to 2%.  BiCGSTAB and ``mixed``:
  heads to the closure criterion, equal outer counts (see
  tests/test_torch_ims.py on BiCGSTAB and sum order).
- float32 and the power iteration's start vector: XLA's and PyTorch's
  float32 ``cos`` of large arguments differ in the last bits, so at sizes
  where ``arange(n)`` reaches large arguments λmax may differ in the last
  digits.  ``test_lambda_max_f32_follows_the_start_vector`` shows that the
  start vector is the whole of the difference: given the reference's start
  vector, the port's estimate agrees to 1e-6.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_robustness import _laplacian_system
from test_torch_ims import (_assert_same_march, _port_settings,
                            _torch_order_dot)
from test_torch_parity import (build_both, convertible_args, flagship_args,
                               fused_model_args)
from modflow6_tpu.ops.solvers import cg as jax_cg
from modflow6_tpu.ops.solvers import krylov as jkrylov
from modflow6_tpu.ops.solvers import mg as jmg
from modflow6_tpu.ops.solvers import precond as jprecond
from modflow6_tpu.ops.system import spmv_structured as jax_spmv_structured
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxNumericalSolution
from modflow6_tpu.solution.fused import make_fused_step as jax_fused_step
from modflow6_tpu.solution.ims import _make_precond as jax_make_precond
from modflow6_torch.models.gwf.npf import DeviceTopology
from modflow6_torch.ops import stencil
from modflow6_torch.ops.solvers import krylov as tkrylov
from modflow6_torch.ops.solvers import mg as tmg
from modflow6_torch.ops.solvers import precond as tprecond
from modflow6_torch.ops.system import make_matvec
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.fused import make_fused_step
from modflow6_torch.solution.ims import NumericalSolution, _make_precond

TORCH = {"f64": torch.float64, "f32": torch.float32}
NUMPY = {"f64": np.float64, "f32": np.float32}
# one application against the reference, relative to the largest entry
APPLY_RTOL = {"f64": 1e-12, "f32": 2e-5}


def _system(shape, seed, dtype="f64"):
    """A symmetric negative-definite 7-point system as the assembly gives
    it: (shape, diag, off, r) as numpy arrays in ``dtype``."""
    rng = np.random.default_rng(seed)
    nlay, nrow, ncol = shape
    n = nlay * nrow * ncol
    c = np.zeros(shape + (6,))
    cx = np.exp(rng.normal(0.0, 1.0, (nlay, nrow, ncol - 1)))
    cy = np.exp(rng.normal(0.0, 1.0, (nlay, nrow - 1, ncol)))
    cz = np.exp(rng.normal(-1.0, 0.5, (max(nlay - 1, 0), nrow, ncol)))
    c[:, :, :-1, 0] = cx
    c[:, :, 1:, 1] = cx
    c[:, 1:, :, 2] = cy
    c[:, :-1, :, 3] = cy
    c[1:, :, :, 4] = cz
    c[:-1, :, :, 5] = cz
    diag = -(c.sum(axis=-1) + rng.uniform(0.0, 0.05, shape))
    # a few identity rows, as the Dirichlet fixup leaves them
    fixed = rng.random(shape) < 0.05
    diag[fixed] = 1.0
    c[fixed] = 0.0
    r = rng.normal(0.0, 1.0, n)
    t = NUMPY[dtype]
    return shape, diag.reshape(n).astype(t), c.reshape(n, 6).astype(t), \
        r.astype(t)


def _both_matvecs(shape, diag, off):
    jd, jo = jnp.asarray(diag), jnp.asarray(off)
    td, to = torch.as_tensor(diag), torch.as_tensor(off)
    return ((lambda x: jax_spmv_structured(shape, jd, jo, x)), jd, jo,
            make_matvec(DeviceTopology(shape), td, to), td, to)


def _assert_close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


# ------------------------------------------------- single applications

@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kind,kw", [
    ("jacobi", {}), ("neumann", {}), ("neumann", dict(order=4)),
    ("chebyshev", {}), ("chebyshev", dict(order=6, eig_ratio=10.0,
                                          power_iters=5)), ("none", {})],
    ids=["jacobi", "neumann2", "neumann4", "chebyshev4", "chebyshev6",
         "none"])
def test_make_preconditioner_apply_matches_reference(kind, kw, dtype):
    shape, diag, off, r = _system((2, 13, 11), 1, dtype)
    jmv, jd, _, tmv, td, _ = _both_matvecs(shape, diag, off)
    want = jprecond.make_preconditioner(kind, jmv, jd, **kw)(jnp.asarray(r))
    got = tprecond.make_preconditioner(kind, tmv, td, **kw)(
        torch.as_tensor(r))
    _assert_close(got, want, APPLY_RTOL[dtype])


def test_make_preconditioner_names():
    shape, diag, off, r = _system((1, 4, 5), 2)
    tmv, td = _both_matvecs(shape, diag, off)[3:5]
    same = tprecond.make_preconditioner("diag", tmv, td)(torch.as_tensor(r))
    assert torch.equal(same, tprecond.jacobi_precondition(td)(
        torch.as_tensor(r)))
    with pytest.raises(ValueError, match="ilu"):
        tprecond.make_preconditioner("ilu", tmv, td)
    # mg is not one of make_preconditioner's kinds, here as in the reference
    with pytest.raises(ValueError, match="mg"):
        tprecond.make_preconditioner("mg", tmv, td)
    with pytest.raises(ValueError, match="mg"):
        jprecond.make_preconditioner("mg", None, jnp.asarray(diag))


@pytest.mark.parametrize("dtype,rtol", [("f64", 1e-12), ("f32", 1e-5)])
@pytest.mark.parametrize("iters", [0, 3, 10])
def test_estimate_lambda_max_matches_reference(iters, dtype, rtol):
    shape, diag, off, _ = _system((2, 13, 11), 3, dtype)
    jmv, jd, _, tmv, td, _ = _both_matvecs(shape, diag, off)
    want = jprecond.estimate_lambda_max(jmv, jd, iters=iters)
    got = tprecond.estimate_lambda_max(tmv, td, iters=iters)
    assert got.shape == () and got.dtype == TORCH[dtype]
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)


def test_lambda_max_estimate():
    """tests/test_robustness.py:32 through both packages: a dense 1-D
    system, 30 power iterations; a slight overestimate of the true bound."""
    a = _laplacian_system(128, np.random.default_rng(5))
    d = np.diag(a)
    want = float(jprecond.estimate_lambda_max(
        lambda v: jnp.asarray(a) @ v, jnp.asarray(d), iters=30))
    ta = torch.as_tensor(a)
    got = float(tprecond.estimate_lambda_max(
        lambda v: ta @ v, torch.as_tensor(d.copy()), iters=30))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    true = np.max(np.abs(np.linalg.eigvals(np.diag(1.0 / d) @ a)))
    assert true * 0.95 <= got <= true * 1.3


def test_lambda_max_f32_follows_the_start_vector():
    """The stated float32 exception: the start vector takes ``cos`` of
    0..n-1 in float32, where XLA and PyTorch differ in the last bits at
    large arguments.  Given the reference's start vector the port's
    estimate agrees with the reference's to 1e-6; with its own start vector
    it is held to 1e-4, which moves no Chebyshev window visibly (the 1.05
    safety factor is 500 times that)."""
    shape = (1, 300, 400)      # arguments up to 1.2e5
    _, diag, off, _ = _system(shape, 4, "f32")
    jmv, jd, _, tmv, td, _ = _both_matvecs(shape, diag, off)
    n = diag.shape[0]
    v0_ref = jnp.where(jnp.arange(n) % 2 == 0, 1.0, -0.6) * (
        1.0 + 0.1 * jnp.cos(jnp.arange(n, dtype=jnp.float32)))
    v0_ref = np.asarray(v0_ref / jnp.sqrt(jnp.sum(v0_ref * v0_ref)))
    v0_port = tprecond.power_start_vector(n, torch.float32, "cpu").numpy()
    assert v0_ref.dtype == v0_port.dtype == np.float32
    print("start vectors differ in", int((v0_ref != v0_port).sum()), "of", n,
          "entries, by at most", float(np.abs(v0_ref - v0_port).max()))
    np.testing.assert_allclose(v0_port, v0_ref, rtol=0, atol=1e-9)
    want = float(jprecond.estimate_lambda_max(jmv, jd, iters=10))
    given = float(tprecond.estimate_lambda_max(
        tmv, td, iters=10, v0=torch.as_tensor(v0_ref)))
    own = float(tprecond.estimate_lambda_max(tmv, td, iters=10))
    print("lambda_max: reference", want, "port on the reference's start "
          "vector", given, "port", own)
    np.testing.assert_allclose(given, want, rtol=1e-6)
    np.testing.assert_allclose(own, want, rtol=1e-4)


# ------------------------------------------------------------ multigrid

MG_SHAPES = [(1, 16, 24), (3, 21, 17), (2, 7, 9), (1, 5, 4)]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape", MG_SHAPES, ids=str)
def test_coarsen_restrict_prolong_match_reference(shape, dtype):
    """Even and odd sizes: the padding path, the Galerkin pooling and both
    transfers, down the whole hierarchy."""
    _, diag, off, r = _system(shape, 5, dtype)
    rtol = 1e-14 if dtype == "f64" else 1e-6
    jd3, jc = jnp.asarray(diag).reshape(shape), jnp.asarray(off).reshape(
        shape + (6,))
    td3, tc = torch.as_tensor(diag).reshape(shape), torch.as_tensor(
        off).reshape(shape + (6,))
    jr3, tr3 = jnp.asarray(r).reshape(shape), torch.as_tensor(r).reshape(
        shape)
    levels = 0
    while min(td3.shape[1:]) > 2:
        fine = tuple(td3.shape)
        _assert_close(tmg._pad_even(tc), jmg._pad_even(jc), rtol)
        jd3, jc = jmg._coarsen(jd3, jc)
        td3, tc = tmg._coarsen(td3, tc)
        assert tuple(td3.shape) == jd3.shape == (
            fine[0], (fine[1] + 1) // 2, (fine[2] + 1) // 2)
        _assert_close(td3, jd3, rtol)
        _assert_close(tc, jc, rtol)
        jr3, tr3 = jmg._restrict(jr3), tmg._restrict(tr3)
        _assert_close(tr3, jr3, rtol)
        got = tmg._prolong(tr3, fine)
        assert tuple(got.shape) == fine
        _assert_close(got, jmg._prolong(jr3, fine), rtol)
        levels += 1
    assert levels >= 1


def test_coarsen_keeps_zero_diagonal_of_padding_in_f32():
    """An aggregate made only of padding (odd size, inactive border) has a
    zero diagonal.  In float64 ``_coarsen`` sets it to -1; in float32 the
    1e-300 threshold rounds to zero, the diagonal stays zero in both
    packages, and the smoother's safe inverse covers it."""
    shape = (1, 3, 3)
    for dtype, expect in (("f64", -1.0), ("f32", 0.0)):
        diag = np.full(shape, -4.0, NUMPY[dtype])
        c = np.zeros(shape + (6,), NUMPY[dtype])
        diag[0, 2, 2] = 0.0     # the corner aggregate: one cell + padding
        td3, _ = tmg._coarsen(torch.as_tensor(diag), torch.as_tensor(c))
        jd3, _ = jmg._coarsen(jnp.asarray(diag), jnp.asarray(c))
        assert float(td3[0, 1, 1]) == float(jd3[0, 1, 1]) == expect


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("shape,kw", [
    ((1, 48, 48), {}), ((3, 21, 17), {}), ((2, 37, 45), {}),
    ((1, 48, 48), dict(nsmooth=3, coarse_size=64, coarse_order=8,
                       max_levels=3, overcorrect=1.5))],
    ids=["48x48", "3x21x17", "2x37x45", "keywords"])
def test_mg_apply_matches_reference(shape, kw, dtype):
    _, diag, off, r = _system(shape, 6, dtype)
    want = jmg.make_mg_preconditioner(shape, jnp.asarray(diag),
                                      jnp.asarray(off), **kw)(jnp.asarray(r))
    apply = tmg.make_mg_preconditioner(shape, torch.as_tensor(diag),
                                       torch.as_tensor(off), **kw)
    _assert_close(apply(torch.as_tensor(r)), want, APPLY_RTOL[dtype])
    if kw:
        assert len(apply.levels) == 3
    # the hierarchy ends as the reference's ends
    nl, nr, nc = apply.levels[-1][0].shape
    assert nl * nr * nc <= kw.get("coarse_size", 512) or min(nr, nc) <= 2 \
        or len(apply.levels) == kw.get("max_levels", 12)


def test_mg_level_products_go_through_the_bound_stencil(monkeypatch):
    """Every level's product is ``bind_stencil7`` bound once when the
    hierarchy is built: one binding per level and none per application."""
    shape, diag, off, r = _system((2, 37, 45), 7)
    bound = []
    real = stencil.bind_stencil7

    def counting(shape, diag, off):
        bound.append(tuple(shape))
        return real(shape, diag, off)

    monkeypatch.setattr(tmg, "bind_stencil7", counting)
    apply = tmg.make_mg_preconditioner(shape, torch.as_tensor(diag),
                                       torch.as_tensor(off))
    assert bound == [(2, 37, 45), (2, 19, 23), (2, 10, 12)]
    apply(torch.as_tensor(r))
    apply(torch.as_tensor(r))
    assert len(bound) == len(apply.levels) == 3


def test_level_matvec_is_the_plain_product_on_the_cpu():
    shape, diag, off, r = _system((3, 5, 7), 8)
    d3 = torch.as_tensor(diag).reshape(shape)
    c = torch.as_tensor(off).reshape(shape + (6,))
    x3 = torch.as_tensor(r).reshape(shape)
    want = jmg._matvec3(jnp.asarray(diag).reshape(shape),
                        jnp.asarray(off).reshape(shape + (6,)),
                        jnp.asarray(r).reshape(shape))
    _assert_close(tmg._matvec3(d3, c, x3), want, 1e-14)
    assert torch.equal(tmg._level_matvec(d3, c)(x3), tmg._matvec3(d3, c, x3))


# -------------------------------------------------- _make_precond rules

def test_make_precond_rules_match_reference():
    """``mg`` needs the structured form and falls to Chebyshev without it;
    Chebyshev runs at order max(preconditioner_order, 4); the other kinds
    take preconditioner_order as it is."""
    shape, diag, off, r = _system((1, 12, 10), 9)
    jmv, jd, jo, tmv, td, to = _both_matvecs(shape, diag, off)
    ref, port = build_both(flagship_args(1, 12, 10))
    tr = torch.as_tensor(r)
    for kw in (dict(preconditioner="mg"), dict(preconditioner="chebyshev"),
               dict(preconditioner="chebyshev", preconditioner_order=6),
               dict(preconditioner="neumann", preconditioner_order=3),
               dict(preconditioner="jacobi"), dict(preconditioner="none")):
        want = jax_make_precond(JaxImsSettings(**kw), ref, ref.dtopo, jmv, jd,
                                jo)(jnp.asarray(r))
        got = _make_precond(ImsSettings(**kw), port, port.dtopo, tmv, td, to)(
            tr)
        _assert_close(got, want, 1e-12)
    # a topology without a grid shape (the general path, not ported): mg
    # becomes Chebyshev of order 4, as modflow6_tpu/solution/ims.py:103
    unstructured = dataclasses.replace(port.dtopo, grid_shape=None)
    got = _make_precond(ImsSettings(preconditioner="mg"), port, unstructured,
                        tmv, td, to)(tr)
    cheb = tprecond.chebyshev_precondition(tmv, td, order=4)(tr)
    assert torch.equal(got, cheb)
    with pytest.raises(ValueError, match="ilu"):
        NumericalSolution(port, ImsSettings(preconditioner="ilu"))


# ------------------------------------------------------- whole solves

def test_chebyshev_cuts_iterations():
    """tests/test_robustness.py:43 through both packages: CG on a dense
    1-D system with Jacobi and with degree-4 Chebyshev."""
    rng = np.random.default_rng(6)
    n = 256
    a = _laplacian_system(n, rng)
    b = rng.normal(size=n)
    kw = dict(itmax=2000, dvclose=1e-9, rclose=1e-8)
    ja, ta = jnp.asarray(a), torch.as_tensor(a)
    jd, td = jnp.asarray(np.diag(a)), torch.as_tensor(np.diag(a).copy())
    jmv, tmv = (lambda v: ja @ v), (lambda v: ta @ v)

    want = jax_cg(jmv, jnp.asarray(b), jnp.zeros(n),
                  jprecond.chebyshev_precondition(jmv, jd, order=4), **kw)
    got = tkrylov.cg(tmv, torch.as_tensor(b),
                     torch.zeros(n, dtype=torch.float64),
                     tprecond.chebyshev_precondition(tmv, td, order=4), **kw)
    jac = tkrylov.cg(tmv, torch.as_tensor(b),
                     torch.zeros(n, dtype=torch.float64),
                     tprecond.jacobi_precondition(td), **kw)
    assert bool(got.converged) and bool(want.converged)
    # the solve takes more iterations than the system has unknowns (283
    # and 285 of 256 where this was written): the counts are rounding's
    print("dense 1-D inner counts: reference", int(want.iters), "port",
          got.iters, "port with Jacobi", jac.iters)
    assert abs(got.iters - int(want.iters)) <= 0.02 * int(want.iters)
    assert got.iters < jac.iters / 2
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(a, b),
                               atol=1e-6)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=1e-6)


def _chebyshev_1d_args():
    """tests/test_robustness.py:62 test_chebyshev_in_simulation."""
    ncol = 40
    rng = np.random.default_rng(7)
    grid = dict(nlay=1, nrow=1, ncol=ncol, delr=10.0, delc=10.0, top=10.0,
                botm=np.zeros((1, 1, ncol)))
    kw = dict(k=np.exp(rng.normal(0.0, 1.0, ncol)), strt=5.0,
              chd=[(0, 10.0), (ncol - 1, 0.0)])
    return (grid, kw), dict(outer_dvclose=1e-8, inner_dvclose=1e-9,
                            inner_rclose=1e-8, inner_maximum=400)


def _mg_2d_args():
    """tests/test_robustness.py:186 test_mg_preconditioner_2d."""
    nrow = ncol = 48
    rng = np.random.default_rng(9)
    grid = dict(nlay=1, nrow=nrow, ncol=ncol, delr=10.0, delc=10.0, top=10.0,
                botm=np.zeros((1, nrow, ncol)))
    kw = dict(k=np.exp(rng.normal(0.0, 1.0, nrow * ncol)), strt=8.0,
              chd=[(i * ncol, 12.0) for i in range(nrow)]
              + [(i * ncol + ncol - 1, 2.0) for i in range(nrow)],
              wel=[(nrow // 2 * ncol + ncol // 2, -80.0)])
    return (grid, kw), dict(outer_dvclose=1e-7, inner_dvclose=1e-9,
                            inner_rclose=1e-8, inner_maximum=3000)


def _mg_3d_args():
    """tests/test_robustness.py:214 test_mg_odd_sizes_and_3d."""
    nlay, nrow, ncol = 3, 21, 17
    ncpl = nrow * ncol
    grid = dict(nlay=nlay, nrow=nrow, ncol=ncol, delr=10.0, delc=10.0,
                top=30.0, botm=np.linspace(20.0, -10.0, nlay)[:, None, None]
                * np.ones((nlay, nrow, ncol)))
    kw = dict(k=5.0, strt=25.0,
              chd=[(lay * ncpl + i * ncol, 28.0)
                   for lay in range(nlay) for i in range(nrow)]
              + [(lay * ncpl + i * ncol + ncol - 1, 22.0)
                 for lay in range(nlay) for i in range(nrow)])
    return (grid, kw), dict(outer_dvclose=1e-7, inner_dvclose=1e-9,
                            inner_rclose=1e-8, inner_maximum=500)


SCENARIOS = {"chebyshev-1d": (_chebyshev_1d_args, "chebyshev"),
             "mg-2d": (_mg_2d_args, "mg"), "mg-3d-odd": (_mg_3d_args, "mg")}


def _steady(solution, strt, as_numpy):
    head, info, _ = solution.solve_timestep(strt, 1.0, iss=True)
    return [(as_numpy(head), info)]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_preconditioned_steady_solve_matches_reference(name):
    """The three preconditioner scenarios of tests/test_robustness.py
    through both packages in float64 with CG: equal counts, heads 1e-10;
    and against the port's Jacobi solve as the reference's tests hold it."""
    make_args, pc = SCENARIOS[name]
    args, base = make_args()
    ref, port = build_both(args)
    settings = JaxImsSettings(**base, preconditioner=pc,
                              preconditioner_order=4)
    want = _steady(JaxNumericalSolution(ref, settings), jnp.asarray(ref.strt),
                   np.asarray)
    got = _steady(NumericalSolution(port, _port_settings(settings)),
                  port.strt, lambda h: h.numpy())
    _assert_same_march(want, got, 1e-10)
    jac = _steady(NumericalSolution(port, ImsSettings(**base)), port.strt,
                  lambda h: h.numpy())
    assert jac[0][1].converged
    np.testing.assert_allclose(got[0][0], jac[0][0], atol=1e-5)
    if name == "mg-2d":
        assert got[0][1].inner_iterations < jac[0][1].inner_iterations / 5
    if name == "mg-3d-odd":
        h3 = got[0][0].reshape(3, 21, 17)
        np.testing.assert_allclose(
            h3[:, 10], np.broadcast_to(np.linspace(28.0, 22.0, 17), (3, 17)),
            atol=1e-5)


def _march(solution, head, as_numpy, delts=(1.0, 3.0)):
    out = []
    for kstp, delt in enumerate(delts, 1):
        head, info, _ = solution.solve_timestep(head, delt, kstp=kstp,
                                                iss=False)
        out.append((as_numpy(head), info))
    return out


@pytest.mark.parametrize("pc", ["chebyshev", "mg"])
def test_flagship_counts_follow_the_sum_order(pc, monkeypatch):
    """One transient step of the flagship model (two layers, lognormal K,
    whose last outer iteration solves to rounding): against the jitted
    reference heads within 1e-10 and equal outer counts, but the inner
    counts differ by a few, with Jacobi as with the other preconditioners
    (432 and 433 where this was written).  That is the order of CG's sums:
    with the reference run op by op and its dot products summed as PyTorch
    sums them, the inner counts are equal and the heads agree at 1e-12."""
    ref, port = build_both(flagship_args(2, 12, 10))
    settings = JaxImsSettings(outer_dvclose=1e-8, outer_maximum=100,
                              inner_dvclose=1e-10, inner_rclose=1e-9,
                              inner_maximum=2000, preconditioner=pc,
                              preconditioner_order=3)
    jitted = _march(JaxNumericalSolution(ref, settings),
                    jnp.asarray(ref.strt), np.asarray, delts=(3.0,))
    got = _march(NumericalSolution(port, _port_settings(settings)),
                 port.strt, lambda h: h.numpy(), delts=(3.0,))
    _assert_same_march(jitted, got, 1e-10, inner=False)
    monkeypatch.setitem(jkrylov.cg.__kwdefaults__, "dot", _torch_order_dot)
    with jax.disable_jit():
        same_order = _march(JaxNumericalSolution(ref, settings),
                            jnp.asarray(ref.strt), np.asarray, delts=(3.0,))
    print(pc, "inner counts: reference jitted", jitted[0][1].inner_iterations,
          "op by op in torch's sum order", same_order[0][1].inner_iterations,
          "port", got[0][1].inner_iterations)
    _assert_same_march(same_order, got, 1e-12)


@pytest.mark.parametrize("pc", ["neumann", "chebyshev", "mg"])
def test_transient_march_matches_reference(pc):
    """Two transient steps of the 12x10 model of tests/test_fused.py with
    each preconditioner, CG, float64, through ``NumericalSolution``: equal
    counts, heads 1e-10; and the port's fused step equals its
    ``NumericalSolution`` at 1e-12 with the same counts."""
    ref, port = build_both(fused_model_args())
    settings = JaxImsSettings(outer_dvclose=1e-8, outer_maximum=100,
                              inner_dvclose=1e-10, inner_rclose=1e-9,
                              inner_maximum=2000, preconditioner=pc,
                              preconditioner_order=3)
    want = _march(JaxNumericalSolution(ref, settings), jnp.asarray(ref.strt),
                  np.asarray)
    got = _march(NumericalSolution(port, _port_settings(settings)),
                 port.strt, lambda h: h.numpy())
    _assert_same_march(want, got, 1e-10)
    fh, kiter, inner, conv = make_fused_step(
        port, _port_settings(settings), iss=False)(port.strt, 1.0, 1)
    assert conv and (kiter, inner) == (got[0][1].outer_iterations,
                                       got[0][1].inner_iterations)
    np.testing.assert_allclose(fh.numpy(), got[0][0], rtol=0, atol=1e-12)


@pytest.mark.parametrize("pc", ["chebyshev", "mg"])
@pytest.mark.parametrize("acc,precision", [("cg", "mixed"),
                                           ("bicgstab", "f64"),
                                           ("bicgstab", "mixed")])
def test_fused_step_with_each_solver_and_precision(acc, precision, pc):
    """The fused step with BiCGSTAB and in ``mixed`` precision (the float32
    preconditioner, odd sizes in float32 for ``mg``) against the
    reference's fused step: converged, equal outer counts, heads within
    1e-7 (the ``mixed`` bar of tests/test_fused.py:79; the inner solves
    close at 1e-10)."""
    ref, port = build_both(flagship_args(2, 21, 17))
    settings = JaxImsSettings(outer_dvclose=1e-8, outer_maximum=100,
                              inner_dvclose=1e-10, inner_rclose=1e-9,
                              inner_maximum=2000, preconditioner=pc,
                              linear_acceleration=acc, precision=precision)
    jh, jk, ji, jc = jax.jit(jax_fused_step(ref, settings, iss=False))(
        jnp.asarray(ref.strt), jnp.asarray(2.0), jnp.asarray(1, jnp.int32))
    th, tk, ti, tc = make_fused_step(port, _port_settings(settings),
                                     iss=False)(port.strt, 2.0, 1)
    print(acc, precision, pc, "inner: reference", int(ji), "port", ti)
    assert bool(jc) and tc and tk == int(jk)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-7)
    # the preconditioner cuts the Jacobi count of the same solve
    _, _, ti_jac, _ = make_fused_step(
        port, dataclasses.replace(_port_settings(settings),
                                  preconditioner="jacobi"),
        iss=False)(port.strt, 2.0, 1)
    assert ti < ti_jac


def test_nonlinear_model_rebuilds_the_hierarchy_each_outer_iteration():
    """On an unconfined model the system changes with the iterate, so the
    preconditioner is built per outer iteration: counts and heads as the
    reference's with ``mg`` and CG."""
    settings = JaxImsSettings(outer_dvclose=1e-7, outer_maximum=200,
                              inner_dvclose=1e-10, inner_rclose=1e-9,
                              inner_maximum=500, preconditioner="mg")
    ref, port = build_both(convertible_args())
    jh, ji, _ = JaxNumericalSolution(ref, settings).solve_timestep(
        jnp.asarray(ref.strt), 5.0, iss=False)
    th, ti, _ = NumericalSolution(port, _port_settings(settings)
                                  ).solve_timestep(port.strt, 5.0, iss=False)
    _assert_same_march([(np.asarray(jh), ji)], [(th.numpy(), ti)], 1e-9)
    assert ti.outer_iterations > 2 and not port.is_linear


# --------------------------------------------------------------- loader

def test_loader_maps_ilu_settings_to_chebyshev(tmp_path):
    """PRECONDITIONER_LEVELS / PRECONDITIONER_DROP_TOLERANCE become
    Chebyshev of order 4 with the reference's warning, NO_PTC is read, and
    the settings equal the reference loader's."""
    from modflow6_tpu.utils.mf6io.loader import load_ims as ref_load_ims
    from modflow6_torch.utils.mf6io.loader import load_ims
    for i, (line, no_ptc) in enumerate([
            ("PRECONDITIONER_LEVELS 3", ""),
            ("PRECONDITIONER_DROP_TOLERANCE 1e-3", "NO_PTC FIRST"),
            ("PRECONDITIONER_LEVELS 3\n  PRECONDITIONER_DROP_TOLERANCE 1e-3",
             "NO_PTC ALL"), ("", "NO_PTC")]):
        path = tmp_path / f"{i}.ims"
        path.write_text(f"BEGIN OPTIONS\n  {no_ptc}\nEND OPTIONS\n"
                        "BEGIN NONLINEAR\n  OUTER_DVCLOSE 1e-6\n"
                        "END NONLINEAR\nBEGIN LINEAR\n  INNER_MAXIMUM 50\n"
                        f"  {line}\n  LINEAR_ACCELERATION BICGSTAB\n"
                        "END LINEAR\n")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = load_ims(str(path))
            want = ref_load_ims(str(path))
        assert vars(got) == vars(want)
        if line:
            assert (got.preconditioner, got.preconditioner_order) == (
                "chebyshev", 4)
            assert sum("Chebyshev" in str(w.message) for w in caught) == 2
        else:
            assert got.preconditioner == "jacobi" and not caught
        assert got.no_ptc == {"": False, "NO_PTC FIRST": "first"}.get(
            no_ptc, "all")
