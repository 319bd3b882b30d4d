"""The fused Jacobi-BiCGSTAB path of ``krylov.bicgstab`` on the ELL system
(ops/solvers/bicgstab_ell.py) on the CPU: the kernels' plain versions,
composed in the kernels' order, against ``bicgstab``'s plain loop; which
loop ``bicgstab`` chooses; and the benchmark's reader of the
``bicgstab_ell`` launches (perfbench/metrics/fused_bicgstab_share.py).

The plain versions keep one partial for each sum, so they add in the plain
loop's order: iterates, counts and the last iteration's norms are held
bitwise.  The kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""

import dataclasses
import functools
import importlib.util
import json
import types
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from modflow6_torch.models.discretization import DisGrid, DisvGrid
from modflow6_torch.models.gwf import npf
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.ops.solvers import bicgstab_ell, krylov
from modflow6_torch.ops.solvers.mg import make_mg_preconditioner
from modflow6_torch.ops.solvers.precond import (jacobi_precondition,
                                                make_preconditioner)
from modflow6_torch.ops.stencil import bind_stencil7
from modflow6_torch.ops.system import make_matvec
from modflow6_torch.solution import ims
from modflow6_torch.solution.ims import fix_system
from modflow6_torch.utils import profiler

REPO = Path(__file__).resolve().parents[1]

KW = dict(itmax=500, dvclose=1e-10, rclose=1e-6)


def _flow_system(model, seed):
    """``model``'s fixed-up BiCGSTAB system at a start away from its
    solution: (ell, rhs, h0) on the CPU, ``ell = (nbr, diag, off)``."""
    rng = np.random.default_rng(seed)
    h0 = torch.as_tensor(30.0 + rng.normal(0.0, 1.0, model.nodes),
                         dtype=torch.float64)
    ib, h = model.boundary_state(h0)
    diag, off, rhs = model.assemble(h, h, ib, 1.0, False)
    diag, off, rhs = fix_system(model, torch.sign(ib), diag, off, rhs, h,
                                symmetric=False)
    matvec = make_matvec(model.system_topo, diag, off)
    return matvec.ell, rhs, h


def dis_edge_list():
    """A 2 x 9 x 11 DIS model with CHD on the west column, a well, three
    inactive cells and lognormal K, assembled over its edge list (the
    general path: no grid shape)."""
    nlay, nrow, ncol = 2, 9, 11
    rng = np.random.default_rng(3)
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
    topo = model.grid.build_edge_topology()
    dtopo = dataclasses.replace(npf.DeviceTopology.from_host(topo, "cpu"),
                                grid_shape=None)
    general = dataclasses.replace(model, dtopo=dtopo, topo=topo)
    general.finalize_setup()
    assert not general.use_structured
    return _flow_system(general, 5)


def disv_quads():
    """A one-layer DISV grid of 10 x 12 square cells (K = 4: the border
    cells' slots padded) with CHD on the west column, a well and an
    inactive cell."""
    nrow, ncol, d = 10, 12, 50.0
    xs, ys = np.arange(ncol + 1) * d, (nrow - np.arange(nrow + 1)) * d
    vx, vy = np.meshgrid(xs, ys)
    verts = np.stack([vx.ravel(), vy.ravel()], axis=1)
    cell2d = []
    for i in range(nrow):
        for j in range(ncol):
            v0 = i * (ncol + 1) + j
            cell2d.append(((j + 0.5) * d, (nrow - i - 0.5) * d,
                           [v0, v0 + 1, v0 + ncol + 2, v0 + ncol + 1]))
    idomain = np.ones((1, nrow * ncol), np.int32)
    idomain[0, 3 * ncol + 4] = 0
    grid = DisvGrid.create(1, nrow * ncol, verts, cell2d, 0.0,
                           np.full((1, nrow * ncol), -50.0), idomain)
    k = np.exp(np.random.default_rng(4).normal(1.0, 0.5, nrow * ncol))
    model = build_gwf("v", grid, k=k, strt=30.0,
                      storage={"ss": 1e-4, "sy": 0.0, "iconvert": 0},
                      chd=[(r * ncol, 35.0) for r in range(nrow)],
                      wel=[(6 * ncol + 9, -200.0)], device="cpu")
    assert model.system_topo.nbr.shape[1] == 4
    return _flow_system(model, 6)


def henry_transport(nlay=24, ncol=48):
    """The Henry section's first transport system (upstream advection,
    diffusion, SSM, BUY's flows) on an nlay x 1 x ncol grid, as the
    transport solution hands it to BiCGSTAB: (ell, rhs, c0)."""
    from perfbench.drivers.coupled import Cell
    cfg = json.loads((REPO / "perfbench" / "configs"
                      / "gwt-henry-1024x1x2048.json").read_text())
    cfg.update(nlay=nlay, ncol=ncol)
    traffic = json.loads((REPO / "perfbench" / "traffic"
                          / "henry-buy-mg-replay.json").read_text())
    traffic["steps"] = [1, 1]
    cell = Cell(cfg, traffic, 2**31 + 11, torch.device("cpu"))
    cell.build()
    calls = []
    plain = ims.bicgstab

    def record(matvec, b, x0, precond, **kw):
        if hasattr(matvec, "ell") and not calls:
            calls.append((matvec.ell, b.clone(), x0.clone()))
        return plain(matvec, b, x0, precond, **kw)

    with mock.patch.object(ims, "bicgstab", record):
        cell.start_replay()
        cell.step(0, keep=False)
    return calls[0]


SYSTEMS = {"dis edge list": dis_edge_list, "disv k4": disv_quads,
           "henry transport": henry_transport}


@functools.lru_cache(maxsize=None)
def system(name, dtype=torch.float64):
    """One of ``SYSTEMS``; in float32 it is the system of
    ``refined_solve``'s passes: the residual from zero."""
    (nbr, diag, off), b, x0 = SYSTEMS[name]()
    if dtype == torch.float32:
        r = b - make_matvec(npf.DeviceTopology(nbr=nbr), diag, off)(x0)
        return ((nbr, diag.to(dtype), off.to(dtype)), r.to(dtype),
                torch.zeros_like(r, dtype=dtype))
    return (nbr, diag, off), b, x0


def _solves(name, dtype, icnvgopt, kstp=1, **change):
    ell, b, x0 = system(name, dtype)
    matvec = make_matvec(npf.DeviceTopology(nbr=ell[0]), *ell[1:])
    precond = jacobi_precondition(ell[1])
    r0 = b - matvec(x0)
    kw = dict(KW, icnvgopt=icnvgopt, l2norm0=torch.sqrt(torch.sum(r0 * r0)),
              epfact_val=krylov.epfact(icnvgopt, kstp))
    if icnvgopt == 3:
        kw["rclose"] = 1e-5
    kw.update(change)
    plain = krylov.bicgstab(matvec, b, x0, precond, **kw)
    fused = bicgstab_ell.solve(matvec.ell, precond.jacobi_inv, b, x0,
                               ops=bicgstab_ell.Plain, **kw)
    return plain, krylov.KrylovResult(*fused)


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(a, b) and bool(
        (torch.signbit(a) == torch.signbit(b)).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("icnvgopt", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_plain_versions_in_fused_order_are_bicgstab_bitwise(name, icnvgopt,
                                                            dtype):
    plain, fused = _solves(name, dtype, icnvgopt)
    # ICNVGOPT 2's relative exit (epfact 0.01) ends the henry solve at 3
    assert plain.iters >= 3
    assert fused.iters == plain.iters
    assert bool(fused.converged) == bool(plain.converged)
    for field in ("x", "dvmax", "rmax", "l2norm"):
        assert _same(getattr(fused, field), getattr(plain, field)), field


@pytest.mark.parametrize("icnvgopt,kstp,itmax", [
    (1, 1, 1),        # ICNVGOPT 1 on the first iteration: icnvg = +1
    (2, 2, 500),      # epfact 0.10 after the first step
    (0, 1, 0)])       # no iteration
def test_plain_versions_at_the_edges(icnvgopt, kstp, itmax):
    plain, fused = _solves("dis edge list", torch.float64, icnvgopt, kstp,
                           itmax=itmax, l2norm0=1e3, dvclose=1.0, rclose=1e4)
    assert fused.iters == plain.iters == min(itmax, 1)
    assert bool(fused.converged) == bool(plain.converged)
    for field in ("x", "dvmax", "rmax", "l2norm"):
        assert _same(getattr(fused, field), getattr(plain, field)), field


def test_the_transport_system_is_not_symmetric():
    """The henry system is what BiCGSTAB is for: upstream advection makes
    its matrix asymmetric."""
    import scipy.sparse as sp
    (nbr, diag, off), _, _ = system("henry transport")
    n, k = nbr.shape
    a = sp.coo_matrix((off.reshape(-1).numpy(),
                       (np.repeat(np.arange(n), k), nbr.reshape(-1).numpy())),
                      shape=(n, n)).tocsr()
    assert abs(a - a.T).max() > 1e-3 * abs(a).max()


def _fused_args(**change):
    """Arguments of ``_fused_operands`` that choose the fused BiCGSTAB
    path, a CUDA device standing in for the tensors' (the dispatch reads
    only ``b.device``), with ``change`` applied."""
    ell, b, _ = system("dis edge list")
    matvec = make_matvec(npf.DeviceTopology(nbr=ell[0]), *ell[1:])
    args = dict(matvec=matvec, precond=jacobi_precondition(ell[1]),
                b=types.SimpleNamespace(device=torch.device("cuda", 0)),
                dot=krylov.vector_dot, absmax=krylov._signed_absmax,
                trace=False, north=0, product="ell")
    args.update(change)
    return args, (ell, b)


def test_dispatch_chooses_the_fused_path_where_it_can():
    args, (ell, _) = _fused_args()
    (nbr, diag, off), inv = krylov._fused_operands(**args)
    assert nbr is ell[0] and diag is ell[1] and off is ell[2]
    assert inv is args["precond"].jacobi_inv
    # the ELL product is not a stencil7: cg keeps its plain loop on it
    assert krylov._fused_operands(**dict(args, product="stencil7")) is None


@pytest.mark.parametrize("case", [
    "cpu tensors", "mg", "chebyshev", "neumann", "stencil7 matvec",
    "injected dot", "injected absmax", "trace", "north"])
def test_dispatch_chooses_the_plain_loop(case):
    args, ((nbr, diag, off), b) = _fused_args()
    from test_torch_pcg_jacobi import system as structured
    shape, sdiag, soff, _, _ = structured(1)
    change = {
        "cpu tensors": dict(b=b),
        "mg": dict(precond=make_mg_preconditioner(shape, sdiag, soff)),
        "chebyshev": dict(precond=make_preconditioner(
            "chebyshev", args["matvec"], diag)),
        "neumann": dict(precond=make_preconditioner(
            "neumann", args["matvec"], diag)),
        "stencil7 matvec": dict(matvec=bind_stencil7(shape, sdiag, soff),
                                precond=jacobi_precondition(sdiag)),
        "injected dot": dict(dot=lambda u, v: torch.sum(u * v)),
        "injected absmax": dict(absmax=lambda v: v.take(
            torch.argmax(v.abs()))),
        "trace": dict(trace=True),
        "north": dict(north=5),
    }[case]
    args.update(change)
    assert krylov._fused_operands(**args) is None


def test_bicgstab_on_cpu_tensors_runs_the_plain_loop(monkeypatch):
    """On the CPU the fused loop is never entered: ``bicgstab`` gives the
    plain loop's result, and the library is neither built nor loaded."""
    def refuse(*args, **kwargs):
        raise AssertionError("the fused path ran on CPU tensors")
    monkeypatch.setattr(bicgstab_ell, "solve", refuse)
    monkeypatch.setattr(bicgstab_ell, "_load", refuse)
    monkeypatch.setattr(bicgstab_ell, "build", refuse)
    ell, b, x0 = system("disv k4")
    matvec = make_matvec(npf.DeviceTopology(nbr=ell[0]), *ell[1:])
    res = krylov.bicgstab(matvec, b, x0, jacobi_precondition(ell[1]), **KW)
    assert res.iters > 3 and bool(res.converged)


def test_index_table_is_int32_where_it_fits():
    nbr = torch.arange(12).reshape(4, 3)
    assert bicgstab_ell.index_table(nbr).dtype == torch.int32
    assert torch.equal(bicgstab_ell.index_table(nbr).long(), nbr)
    big = types.SimpleNamespace(dtype=torch.int64, numel=lambda: 2**31)
    assert bicgstab_ell.index_table(big) is big


def _reader(name):
    path = REPO / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Rec:
    def __init__(self, counters):
        self.counters = counters


def test_fused_bicgstab_share_reader_on_step_records():
    """The benchmark's ``fused_bicgstab_share``: the ``bicgstab_ell``
    launches (six an iteration) over the transport's inner iterations;
    nothing where the records hold no launch counter."""
    read = _reader("fused_bicgstab_share").read
    recs = [_Rec({"launches": {"stencil7": 9}, "transport_inner": 40}),
            _Rec({"launches": {}, "transport_inner": 10})]
    steps = [(0.1, True, r) for r in recs]
    assert read(dict(steps=steps)) == 0.0
    recs[0].counters["launches"]["bicgstab_ell"] = 6 * 40
    recs[1].counters["launches"]["bicgstab_ell"] = 6 * 10
    assert read(dict(steps=steps)) == 1.0
    recs[1].counters["launches"]["bicgstab_ell"] = 0
    assert read(dict(steps=steps)) == 0.8
    assert read(dict(steps=[(0.1, True, _Rec({"transport_inner": 3}))])) \
        is None


def test_bicgstab_launches_are_taken_with_the_step_counters():
    """The reader's source: ``launches["bicgstab_ell"]`` reaches a step's
    counters as its growth since the last ``take``."""
    profiler.take()
    profiler.launches["bicgstab_ell"] += 18
    assert profiler.take()[1]["launches"] == {"bicgstab_ell": 18}
    assert "bicgstab_ell" not in profiler.take()[1]["launches"]
