"""The fused Jacobi-CG path of ``krylov.cg`` (ops/solvers/pcg_jacobi.py) on
the CPU: which loop ``cg`` chooses, the kernels' plain versions, composed
in the kernels' order, against ``cg``'s plain loop, and the benchmark's
reader of the ``pcg_jacobi`` launches (perfbench/metrics/fused_cg_share.py).

The plain versions keep one partial for each sum, so they add in the plain
loop's order: iterates, counts and the last iteration's norms are held
bitwise.  The kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.ops.solvers import krylov, pcg_jacobi
from modflow6_torch.ops.solvers.mg import make_mg_preconditioner
from modflow6_torch.ops.solvers.precond import (jacobi_precondition,
                                                make_preconditioner)
from modflow6_torch.ops.stencil import bind_stencil7
from modflow6_torch.ops.system import apply_dirichlet_structured, spmv
from modflow6_torch.utils import profiler
from test_torch_tracing import _sim, _steps

REPO = Path(__file__).resolve().parents[1]

KW = dict(itmax=500, dvclose=1e-10, rclose=1e-6)


def system(nlay, dtype=torch.float64, seed=3, nrow=9, ncol=11):
    """A fixed-up confined system of ``nlay`` layers of ``nrow`` x ``ncol``
    cells (at least 9 x 11) with CHD on the west column, a well, inactive
    cells and lognormal K, and a start vector away from its solution, on
    the CPU: (shape, diag, off, rhs, h0).  In float32 it is the system of
    ``refined_solve``'s passes: the residual from zero.  The cells are
    cubes of 100 m and K varies by a factor of about 3 (one standard
    deviation), so CG's march is stable under a change of the sums' order:
    the plain loop with its dot products summed in reverse, pairwise or in
    chunks gives the same counts, for every ICNVGOPT, and x within 1e-15
    (float64) or 3e-7 (float32) of max|x|."""
    rng = np.random.default_rng(seed)
    idomain = np.ones((nlay, nrow, ncol), np.int32)
    idomain[0, 4, 5] = idomain[-1, 0, 7] = idomain[0, 8, 10] = 0
    grid = DisGrid.create(nlay, nrow, ncol, 100.0, 100.0, 0.0,
                          -100.0 * np.arange(1, nlay + 1)[:, None, None]
                          * np.ones((nlay, nrow, ncol)), idomain=idomain)
    k = np.exp(rng.normal(1.0, 0.5, grid.nodes))
    model = build_gwf("m", grid, k=k, k33=k, strt=30.0,
                      storage={"ss": 1e-4, "sy": 0.0, "iconvert": 0},
                      chd=[(r * ncol, 35.0) for r in range(nrow)],
                      wel=[(5 * ncol + 8, -300.0)], device="cpu")
    h0 = torch.as_tensor(30.0 + rng.normal(0.0, 1.0, grid.nodes),
                         dtype=torch.float64)
    ib, h = model.boundary_state(h0)
    diag, off, rhs = model.assemble(h, h, ib, 1.0, False)
    shape = model.dtopo.grid_shape
    diag, off, rhs = apply_dirichlet_structured(shape, torch.sign(ib), diag,
                                                off, rhs, h)
    if dtype == torch.float32:
        r = rhs - bind_stencil7(shape, diag, off)(h)
        return (shape, diag.to(dtype), off.to(dtype), r.to(dtype),
                torch.zeros_like(r, dtype=dtype))
    return shape, diag, off, rhs, h


def _solves(nlay, dtype, icnvgopt, kstp=1):
    shape, diag, off, b, x0 = system(nlay, dtype)
    matvec = bind_stencil7(shape, diag, off)
    precond = jacobi_precondition(diag)
    r0 = b - matvec(x0)
    kw = dict(KW, icnvgopt=icnvgopt, l2norm0=torch.sqrt(torch.sum(r0 * r0)),
              epfact_val=krylov.epfact(icnvgopt, kstp))
    if icnvgopt == 3:
        kw["rclose"] = 1e-5
    plain = krylov.cg(matvec, b, x0, precond, **kw)
    fused = pcg_jacobi.solve(matvec.stencil7, precond.jacobi_inv, b, x0,
                             ops=pcg_jacobi.Plain, **kw)
    return plain, krylov.KrylovResult(*fused)


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(a, b) and bool(
        (torch.signbit(a) == torch.signbit(b)).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("icnvgopt", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("nlay", [1, 2])
def test_plain_versions_in_fused_order_are_cg_bitwise(nlay, icnvgopt,
                                                      dtype):
    plain, fused = _solves(nlay, dtype, icnvgopt)
    assert plain.iters > 3
    assert fused.iters == plain.iters
    assert bool(fused.converged) == bool(plain.converged)
    for name in ("x", "dvmax", "rmax", "l2norm"):
        assert _same(getattr(fused, name), getattr(plain, name)), name


@pytest.mark.parametrize("icnvgopt,kstp,itmax", [
    (1, 1, 1),        # ICNVGOPT 1 on the first iteration: icnvg = +1
    (2, 2, 500),      # epfact 0.10 after the first step
    (0, 1, 0)])       # no iteration
def test_plain_versions_at_the_edges(icnvgopt, kstp, itmax):
    shape, diag, off, b, x0 = system(2)
    matvec = bind_stencil7(shape, diag, off)
    precond = jacobi_precondition(diag)
    kw = dict(KW, itmax=itmax, icnvgopt=icnvgopt, l2norm0=1e3,
              epfact_val=krylov.epfact(icnvgopt, kstp), dvclose=1.0,
              rclose=1e4)
    plain = krylov.cg(matvec, b, x0, precond, **kw)
    fused = krylov.KrylovResult(*pcg_jacobi.solve(
        matvec.stencil7, precond.jacobi_inv, b, x0, ops=pcg_jacobi.Plain,
        **kw))
    assert fused.iters == plain.iters
    assert bool(fused.converged) == bool(plain.converged)
    for name in ("x", "dvmax", "rmax", "l2norm"):
        assert _same(getattr(fused, name), getattr(plain, name)), name


def test_absmax_of_parts_takes_the_lowest_cell_on_ties():
    vals = torch.tensor([2.0, -3.0, 3.0, 1.0], dtype=torch.float64)
    idx = torch.tensor([0, 9, 4, 2])
    assert float(pcg_jacobi._absmax_of_parts(vals, idx)) == 3.0
    vals[0] = float("nan")
    assert torch.isnan(pcg_jacobi._absmax_of_parts(vals, idx))


def _fused_args(**change):
    """Arguments of ``_fused_operands`` that choose the fused path, a CUDA
    device standing in for the tensors' (the dispatch reads only
    ``b.device``), with ``change`` applied."""
    shape, diag, off, b, _ = system(1)
    args = dict(matvec=bind_stencil7(shape, diag, off),
                precond=jacobi_precondition(diag),
                b=types.SimpleNamespace(device=torch.device("cuda", 0)),
                dot=krylov.vector_dot, absmax=krylov._signed_absmax,
                trace=False, north=0)
    args.update(change)
    return args, (shape, diag, off, b)


def test_dispatch_chooses_the_fused_path_where_it_can():
    args, (shape, diag, off, _) = _fused_args()
    (got_shape, got_diag, got_off), inv = krylov._fused_operands(**args)
    assert got_shape == tuple(shape)
    assert got_diag is diag and got_off is off
    assert inv is args["precond"].jacobi_inv


@pytest.mark.parametrize("case", [
    "cpu tensors", "neumann", "chebyshev", "mg", "no preconditioner",
    "injected dot", "injected absmax", "trace", "north", "ell matvec"])
def test_dispatch_chooses_the_plain_loop(case):
    args, (shape, diag, off, b) = _fused_args()
    n = diag.numel()
    change = {
        "cpu tensors": dict(b=b),
        "neumann": dict(precond=make_preconditioner(
            "neumann", args["matvec"], diag)),
        "chebyshev": dict(precond=make_preconditioner(
            "chebyshev", args["matvec"], diag)),
        "mg": dict(precond=make_mg_preconditioner(shape, diag, off)),
        "no preconditioner": dict(precond=make_preconditioner(
            "none", args["matvec"], diag)),
        "injected dot": dict(dot=lambda u, v: torch.sum(u * v)),
        "injected absmax": dict(absmax=lambda v: v.take(
            torch.argmax(v.abs()))),
        "trace": dict(trace=True),
        "north": dict(north=5),
        "ell matvec": dict(matvec=lambda v: spmv(
            torch.zeros(n, 6, dtype=torch.int64), diag, off, v)),
    }[case]
    args.update(change)
    assert krylov._fused_operands(**args) is None


def test_cg_on_cpu_tensors_runs_the_plain_loop(monkeypatch):
    """On the CPU the fused loop is never entered: ``cg`` gives the plain
    loop's result, and the library is neither built nor loaded."""
    def refuse(*args, **kwargs):
        raise AssertionError("the fused path ran on CPU tensors")
    monkeypatch.setattr(pcg_jacobi, "solve", refuse)
    monkeypatch.setattr(pcg_jacobi, "_load", refuse)
    shape, diag, off, b, x0 = system(2)
    res = krylov.cg(bind_stencil7(shape, diag, off), b, x0,
                    jacobi_precondition(diag), **KW)
    assert res.iters > 3 and bool(res.converged)


def _reader(name):
    path = REPO / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fused_cg_share_reader_on_step_records():
    """The benchmark's ``fused_cg_share`` on records of CPU steps (the
    plain loop: 0), on records that ran fused (four ``pcg_jacobi``
    launches an iteration: 1), and on records without the launch counter
    (nothing)."""
    sim = _sim()
    recs = _steps(sim, n=3)
    assert all("pcg_jacobi" not in r.counters["launches"] for r in recs)
    read = _reader("fused_cg_share").read
    assert read(dict(steps=[(0.1, True, r) for r in recs])) == 0.0
    for r in recs:
        r.counters["launches"]["pcg_jacobi"] = 4 * r.inner
    assert read(dict(steps=[(0.1, True, r) for r in recs])) == 1.0
    for r in recs:
        del r.counters["launches"]
    assert read(dict(steps=[(0.1, True, r) for r in recs])) is None


def test_pcg_launches_are_taken_with_the_step_counters():
    """The reader's source: ``launches["pcg_jacobi"]`` reaches a step's
    counters as its growth since the last ``take``, as ``stencil7``'s
    does."""
    profiler.take()
    profiler.launches["pcg_jacobi"] += 12
    assert profiler.take()[1]["launches"] == {"pcg_jacobi": 12}
    assert "pcg_jacobi" not in profiler.take()[1]["launches"]
