"""GPU smoke run of modflow6_torch: builds the CUDA stencil kernel, checks
it against its plain PyTorch version (at the bench shape, at odd shapes and
at every level shape of the multigrid hierarchy), checks the fused
transient solve on the card against the CPU and a direct solve, runs the
bench configuration (4x1024x1024 cells, 3 steps) in ``mixed`` and ``f64``
through the fused run with the Jacobi, Chebyshev and multigrid
preconditioners, runs the same model as an MF6 input deck through the deck
path (the command-line entry, the loader, ``Simulation`` and the output
files) in ``f64`` and ``mixed`` and once with PRECONDITIONER_LEVELS,
holding it against the fused run, runs the bench grid made unconfined as a
NEWTON UNDER_RELAXATION deck, holds small Newton, PTC and rewetting
models on the card against the CPU, and drives the general (edge list +
ELL gather) path: the bench model on a DISV grid of square cells against
the structured run, a brick-pattern DISV grid of the same size with DRN,
RIV, GHB and EVT through ``Simulation``, a one-layer brick grid of a
million cells as a written DISV6 deck, the bench grid with rotated
anisotropy (edge-list assembly feeding the stencil kernel), and small DISV
and DISU models with the four packages and a barrier against the CPU; and
the property packages (``properties``): the bench model in XT3D's full mode
against the structured run (the gather product over the extended table),
XT3D with rotated anisotropy in full and RHS mode through ``Simulation``,
the bench model with CSUB interbeds (delay beds among them) and TVK/TVS
over two periods, BUY and VSC with a seawater wedge, and small XT3D, GNC,
CSUB, BUY/VSC and TVK/TVS twins on the card against the CPU; and the
advanced packages (``advanced``): the bench model with 1024 multi-layer
wells, 256 lakes and a 4160-reach stream network through ``Simulation``
twice (bitwise equal, no stencil launch: the augmented table has no grid
shape), the same model as a MAW6/LAK6/SFR6 deck with a second period
through the command-line entry, the gather product at the table's width,
and small MAW, LAK, SFR and repeated-sum twins on the card against the
CPU; and the coupling (``coupling``): UZF columns on every top cell of the
bench grid through ``Simulation`` twice (bitwise equal, the structured
solve through the stencil kernel) and as a UZF6 deck with a second period
through the command-line entry, about 320 movers on the advanced phase's
model twice (bitwise equal) and as an MVR6 deck, and the bench grid split
into two models joined by GWF6-GWF6 exchanges, merged and run over the
gather against the single model, and as a two-model deck through the
command-line entry; with small UZF, mover-chain and exchange-mover twins
on the card against the CPU in the ``small`` phase; and the utilities
(``utilities``): the bench grid as a deck whose wells, east CHD column and
recharge follow TS6 series and a TAS6 time-array series, with 4096 head
and drawdown observations, flow observations and a NetCDF export, through
the command-line entry against an in-memory model whose step values this
script computes, its observations against the .hds and .cbc files and a
zone budget of its .cbc; the same deck with period 1 stepping adaptively
(ATS) with retries, twice and replayed as fixed steps; and a million-cell
MODFLOW-2005 deck converted by mf5to6 and run against the same model
built in memory.

Usage: python3 chip_smoke.py            (one CUDA device; exits non-zero
                                         without one, and on any failed
                                         check)
       python3 chip_smoke.py --profile [--preconditioner jacobi|chebyshev|mg]
                             [--grid dis|disv]
                                        (instead: where the time of the
                                         bench configuration's first step
                                         goes, by op, under torch.profiler;
                                         ``--grid disv`` profiles the
                                         general path)

Output of the smoke run, in order: the device, the kernel build,
kernel-vs-plain checks with times, the small-model checks, the bench
runs, the preconditioner runs, the deck runs, the Newton runs, the
general-path runs, the property-package runs, the advanced-package runs,
the coupling runs, the utilities runs, one JSON line
``{"kernels": [...]}``, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: CUDA is not available; this script runs only on "
             "a CUDA device")

from modflow6_torch import cuda_device                       # noqa: E402
from modflow6_torch.__main__ import main as cli_main         # noqa: E402
from modflow6_torch.models.discretization import (DisGrid,   # noqa: E402
                                                  DisuGrid, DisvGrid)
from modflow6_torch.models.gwf import advanced               # noqa: E402
from modflow6_torch.models.gwf.advanced import (             # noqa: E402
    AugmentedGwfModel, build_lak, build_maw, build_sfr)
from modflow6_torch.models.gwf.builder import (              # noqa: E402
    build_gwf, chd_data, rch_data, wel_data)
from modflow6_torch.models.gwf.gnc import build_gnc          # noqa: E402
from modflow6_torch.models.gwf.model import PackageData      # noqa: E402
from modflow6_torch.models.simulation import Simulation      # noqa: E402
from modflow6_torch.ops import stencil                       # noqa: E402
from modflow6_torch.ops.solvers.mg import make_mg_preconditioner  # noqa: E402
from modflow6_torch.ops.solvers.precond import (             # noqa: E402
    chebyshev_precondition)
from modflow6_torch.ops.system import (                      # noqa: E402
    apply_dirichlet, apply_dirichlet_structured, make_matvec, spmv,
    to_scipy_csr)
from modflow6_torch.solution import ImsSettings              # noqa: E402
from modflow6_torch.solution.fused import (make_fused_run,   # noqa: E402
                                           make_fused_step)
from modflow6_torch.solution.ims import (NumericalSolution,  # noqa: E402
                                          fix_system)
from modflow6_torch.utils.binary import read_head_file       # noqa: E402
from modflow6_torch.timing.tdis import StressPeriod, Tdis     # noqa: E402
from modflow6_torch.utils.mf6io import load_simulation       # noqa: E402
from modflow6_torch.utils.oc import OutputControl            # noqa: E402

BENCH_SHAPE = (4, 1024, 1024)
KERNEL_SHAPES = (BENCH_SHAPE, (3, 37, 45), (1, 5, 129))
# the coarse levels of the multigrid hierarchy of the bench shape (2x2
# aggregation in rows and columns down to at most 512 cells), and of an odd
# shape, whose levels are padded to even sizes before they are pooled
BENCH_COARSE_SHAPES = tuple((4, n, n) for n in (512, 256, 128, 64, 32, 16, 8))
MG_LEVEL_SHAPES = BENCH_COARSE_SHAPES + ((3, 19, 23), (3, 10, 12))
# heads of two solves of one model closed at outer_dvclose (another
# preconditioner, another precision): they agree to that criterion, not to
# rounding
CLOSURE_FACTOR = 10.0
# heads of the same step on the card and on the CPU: the same float64
# operations, summed in another order by the reductions
CARD_CPU_ATOL = 1e-10
# heads of an iterative solve against a direct solve of the same system
# (tests/test_regression_decks.py:423-424)
DIRECT_ATOL = 2e-5
# the entry-point settings of the reference (__graft_entry__.entry)
ENTRY = dict(outer_dvclose=1e-6, outer_maximum=50, inner_dvclose=1e-8,
             inner_rclose=1e-6, inner_maximum=300)
# the tight settings of tests/test_fused.py:14-18
TIGHT = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-10,
             inner_rclose=1e-9, inner_maximum=2000)
# bench.py:50-52
BENCH = dict(outer_dvclose=1e-5, outer_maximum=50, inner_dvclose=1e-7,
             inner_rclose=1e-5, inner_maximum=400)
SLOTS = ((2, +1), (2, -1), (1, -1), (1, +1), (0, -1), (0, +1))
# heads of the deck path against the fused run of the same model: the
# reference's fused-vs-loop bar is 1e-12 on a 12x10 model
# (tests/test_fused.py:34-47); at 4M cells and ~1500 inner iterations a
# step the two paths are held to the card-vs-CPU bar
DECK_FUSED_ATOL = 1e-10
# the card's published memory rate (H100 SXM data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
# heads of the bench model on a DISV grid of square cells against the
# structured run: the same conductances (the two systems' products agree to
# SYSTEM_RTOL) and the same CG march with the products and per-row sums
# added in another order: the bar of the deck path against the fused run
GENERAL_STRUCTURED_ATOL = DECK_FUSED_ATOL
SYSTEM_RTOL = 1e-12
# volume budget of a full-width run: percent discrepancy below this
BUDGET_PERCENT = 0.01


def flagship_kfield(nlay, nrow, ncol):
    rng = np.random.default_rng(75)
    return np.exp(rng.normal(0.0, 1.0, size=nlay * nrow * ncol))


def flagship(nlay, nrow, ncol, device):
    """The model of bench.py and __graft_entry__._flagship, on ``device``."""
    return build_gwf("flagship", flagship_grid(nlay, nrow, ncol),
                     device=device, **flagship_args(nlay, nrow, ncol))


def mg_products(levels):
    """Stencil products of one multigrid application on a hierarchy of
    ``levels`` levels: 4 on each level but the coarsest (pre-smoother from a
    zero guess 1, residual 1, post-smoother 2) and 15 on the coarsest
    (Chebyshev of order 16 from a zero guess)."""
    return 4 * (levels - 1) + 15


def back_to_back_ms(fn, launches=100, runs=7, warmup=10):
    """Time of one call of fn on the card as the solve sees it: one CUDA
    event pair round ``launches`` calls issued back to back, the elapsed
    time over the count, the median of ``runs`` such runs.  At the bench
    shape the operands (151 MB in float32, 302 MB in float64) exceed the
    50 MB L2 cache, so every launch finds them cold, as in the solve.  At a
    small shape the host issues launches more slowly than the card runs
    them, and this is the host's time per launch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def median_ms(fn, reps=30, warmup=5):
    """Median time of one call of fn with one CUDA event pair round each
    call and a synchronisation after it.  The card is idle when the first
    event is recorded, so the interval includes the host's work before the
    launch: a host-inclusive figure, kept beside ``back_to_back_ms``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stencil_bound_ms(shape, dtype):
    """The least time the card could take for one product: x, diag, the six
    coefficient planes and y, each of N values, read or written once, over
    the card's memory rate.  (The 13 N operations are far below that.)"""
    n = shape[0] * shape[1] * shape[2]
    nbytes = 9 * n * torch.empty((), dtype=dtype).element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3


def stencil_inputs(shape, dtype, device, seed, zero_borders=True):
    nlay, nrow, ncol = shape
    n = nlay * nrow * ncol
    gen = torch.Generator(device=device).manual_seed(seed)
    diag = torch.randn(n, dtype=dtype, device=device, generator=gen) - 7.0
    c = torch.rand(nlay, nrow, ncol, 6, dtype=dtype, device=device,
                   generator=gen)
    if zero_borders:
        c[:, :, -1, 0] = 0
        c[:, :, 0, 1] = 0
        c[:, 0, :, 2] = 0
        c[:, -1, :, 3] = 0
        c[0, :, :, 4] = 0
        c[-1, :, :, 5] = 0
    x = torch.randn(n, dtype=dtype, device=device, generator=gen)
    return diag, c.reshape(n, 6), x


def check_kernel(device):
    """Kernel vs plain version: f64 within 1e-12*max|y|, f32 within 2e-5
    (tests/test_fused.py:89-113), at the bench shape, at odd shapes and at
    every level shape of the multigrid hierarchy.  Returns the largest
    error and the times at the bench shape."""
    worst = 0.0
    times = {}
    cases = [(s, dt, True) for s in KERNEL_SHAPES + MG_LEVEL_SHAPES
             for dt in (torch.float64, torch.float32)]
    cases += [((3, 37, 45), dt, False) for dt in (torch.float64,
                                                  torch.float32)]
    for seed, (shape, dtype, zero_borders) in enumerate(cases):
        diag, off, x = stencil_inputs(shape, dtype, device, seed,
                                      zero_borders)
        y = stencil.stencil7(shape, diag, off, x)
        y_plain = stencil.spmv_structured(shape, diag, off, x)
        torch.cuda.synchronize()
        err = float((y - y_plain).abs().max())
        scale = float(y_plain.abs().max())
        bar = 1e-12 * scale if dtype == torch.float64 else 2e-5
        name = "f64" if dtype == torch.float64 else "f32"
        # the kernel as the solve calls it: bound once, launched back to back
        matvec = stencil.bind_stencil7(shape, diag, off)
        ms = back_to_back_ms(lambda: matvec(x))
        # 200 repeats at the shape the main path gives the kernel
        reps = 200 if shape == BENCH_SHAPE else 30
        one_call_ms = median_ms(
            lambda: stencil.stencil7(shape, diag, off, x), reps)
        plain_ms = back_to_back_ms(
            lambda: stencil.spmv_structured(shape, diag, off, x),
            launches=10, runs=5, warmup=2)
        bound_ms = stencil_bound_ms(shape, dtype)
        print(f"kernel {name} shape={shape} borders="
              f"{'zero' if zero_borders else 'nonzero'} max_abs_err={err!r} "
              f"bar={bar!r} ms={ms!r} (100 launches per event pair) "
              f"one_call_ms={one_call_ms!r} (one launch per event pair, "
              f"host-inclusive, reps={reps}) plain_ms={plain_ms!r} "
              f"bound_ms={bound_ms!r} bound_share={bound_ms / ms!r}")
        if not err <= bar:
            raise AssertionError(f"stencil7 disagrees with the plain "
                                 f"version: {err} > {bar}")
        worst = max(worst, err)
        if shape == BENCH_SHAPE:
            times[name] = (ms, plain_ms, one_call_ms)
    return worst, times


def direct_solution(model):
    """spsolve of the step's assembled, fixed-up system (built on the CPU)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    ib, h = model.boundary_state(model.strt)
    diag, off, rhs = model.assemble(h, h, ib, 1.0, False)
    diag, off, rhs = apply_dirichlet_structured(
        model.dtopo.grid_shape, torch.sign(ib), diag, off, rhs, h)
    shape = model.dtopo.grid_shape
    n = model.nodes
    idx = np.arange(n).reshape(shape)
    rows, cols, vals = [np.arange(n)], [np.arange(n)], [diag.numpy()]
    off = off.numpy()
    for slot, (axis, d) in enumerate(SLOTS):
        nbr = np.full(shape, -1)
        src, dst = [slice(None)] * 3, [slice(None)] * 3
        src[axis] = slice(1, None) if d > 0 else slice(None, -1)
        dst[axis] = slice(None, -1) if d > 0 else slice(1, None)
        nbr[tuple(dst)] = idx[tuple(src)]
        nbr = nbr.reshape(-1)
        keep = nbr >= 0
        rows.append(np.arange(n)[keep])
        cols.append(nbr[keep])
        vals.append(off[keep, slot])
    a = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    return spla.spsolve(a, rhs.numpy())


def check_small_model(device):
    """The fused step on the card vs on the CPU, and vs a direct solve."""
    cpu = flagship(2, 64, 64, "cpu")
    gpu = flagship(2, 64, 64, device)
    settings = ImsSettings(**ENTRY)
    h_cpu, k_cpu, i_cpu, c_cpu = make_fused_step(cpu, settings, False)(
        cpu.strt, 1.0, 1)
    h_gpu, k_gpu, i_gpu, c_gpu = make_fused_step(gpu, settings, False)(
        gpu.strt, 1.0, 1)
    err = float((h_gpu.cpu() - h_cpu).abs().max())
    print(f"flagship(2,64,64) entry settings: card outer={k_gpu} "
          f"inner={i_gpu} converged={c_gpu}; cpu outer={k_cpu} "
          f"inner={i_cpu} converged={c_cpu}; max|dh|={err!r} "
          f"bar={CARD_CPU_ATOL!r}")
    if not (c_gpu and c_cpu and (k_gpu, i_gpu) == (k_cpu, i_cpu)
            and err <= CARD_CPU_ATOL):
        raise AssertionError("the card's step disagrees with the CPU's")

    settings = ImsSettings(**TIGHT)
    h_gpu, k_gpu, i_gpu, c_gpu = make_fused_step(gpu, settings, False)(
        gpu.strt, 1.0, 1)
    h_direct = direct_solution(cpu)
    err = float(np.abs(h_gpu.cpu().numpy() - h_direct).max())
    print(f"flagship(2,64,64) tight settings: card outer={k_gpu} "
          f"inner={i_gpu} converged={c_gpu}; max|h - spsolve|={err!r} "
          f"bar={DIRECT_ATOL!r}")
    if not (c_gpu and err <= DIRECT_ATOL):
        raise AssertionError("the card's step disagrees with spsolve")


@contextlib.contextmanager
def counted_run():
    """Counts of one run of a main path: the kernel's launches (set to 0 on
    entry) and the calls of the kernel's plain version on a CUDA tensor,
    which no path on the card may make."""
    counts = {"plain_on_cuda": 0}
    plain = stencil.spmv_structured

    def counting_plain(shape, diag, off, x):
        counts["plain_on_cuda"] += x.is_cuda
        return plain(shape, diag, off, x)

    stencil.spmv_structured = counting_plain
    stencil.stencil7.launches = 0
    try:
        yield counts
    finally:
        stencil.spmv_structured = plain
    counts["launches"] = stencil.stencil7.launches


def run_bench(device, precision, preconditioner="jacobi", jacobi=None):
    """bench.py's configuration through the port: a warm-up run, then a
    timed run whose kernel launches are counted.  With another
    preconditioner than Jacobi the run is held against the Jacobi ``f64``
    run of this call, ``jacobi`` = (heads, inner_total of the same
    precision): heads within 10 x outer_dvclose, fewer inner iterations,
    and at least the launches that the inner count implies."""
    model = flagship(*BENCH_SHAPE, device)
    run = make_fused_run(
        model, ImsSettings(**BENCH, precision=precision,
                           preconditioner=preconditioner),
        iss=False, nsteps=3)
    delts = [5.0, 5.0, 5.0]
    run(model.strt, delts)
    torch.cuda.synchronize()
    with counted_run() as counts:
        t0 = time.perf_counter()
        head, kiters, inners, convs = run(model.strt, delts)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    launches = counts["launches"]
    inner_total = sum(inners)
    cells = model.nodes
    rate = cells * inner_total / elapsed
    finite = bool(torch.isfinite(head).all())
    print(f"bench precision={precision} preconditioner={preconditioner} "
          f"cells={cells} steps=3 "
          f"inner_total={inner_total} inners={inners} outers={kiters} "
          f"converged={all(convs)} elapsed_s={elapsed!r} "
          f"ims_cell_iters_per_s={rate!r} stencil7_launches={launches} "
          f"plain_on_cuda={counts['plain_on_cuda']}")
    if not (all(convs) and finite and head.shape == (cells,)):
        raise AssertionError(f"bench run ({precision}, {preconditioner}) "
                             f"failed: converged={convs} finite={finite}")
    if counts["plain_on_cuda"]:
        raise AssertionError("the fused run ran the plain stencil on a CUDA "
                             "tensor")
    # stencil products per inner iteration: CG's own, plus the
    # preconditioner's (Chebyshev of order 4: 3; multigrid: mg_products)
    per_inner = {"jacobi": 1, "chebyshev": 4,
                 "mg": 1 + mg_products(1 + len(BENCH_COARSE_SHAPES))
                 }[preconditioner]
    if launches < per_inner * inner_total:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{inner_total} inner iterations of "
                             f"{per_inner} products each")
    if jacobi is not None:
        jacobi_head, jacobi_inner = jacobi
        err = float((head - jacobi_head).abs().max())
        bar = CLOSURE_FACTOR * BENCH["outer_dvclose"]
        print(f"bench precision={precision} preconditioner={preconditioner} "
              f"vs jacobi f64: max|dh|={err!r} bar={bar!r} "
              f"inner_total={inner_total} jacobi_inner_total={jacobi_inner} "
              f"launches_per_inner={launches / inner_total!r} "
              f"(at least {per_inner})")
        if not err <= bar:
            raise AssertionError(f"heads with {preconditioner} differ from "
                                 "the Jacobi run's")
        if not inner_total < jacobi_inner:
            raise AssertionError(f"{preconditioner} took {inner_total} inner "
                                 f"iterations, Jacobi {jacobi_inner}")
    return launches, head, kiters, inners, elapsed


def measure_preconditioner_apply(device):
    """One application of each preconditioner on the bench model's first
    system, in float64 and float32: the kernel launches it makes, and its
    time with the applications issued back to back (CUDA events; the host
    issues several hundred small launches per multigrid application, so
    this is host time where the card waits)."""
    model = flagship(*BENCH_SHAPE, device)
    ib, h = model.boundary_state(model.strt)
    diag, off, rhs = model.assemble(h, h, ib, 5.0, False)
    diag, off, rhs = apply_dirichlet_structured(
        model.dtopo.grid_shape, torch.sign(ib), diag, off, rhs, h)
    for dtype, name in ((torch.float64, "f64"), (torch.float32, "f32")):
        d, o, r = diag.to(dtype), off.to(dtype), rhs.to(dtype)
        matvec = make_matvec(model.dtopo, d, o)
        mg = make_mg_preconditioner(model.dtopo.grid_shape, d, o)
        for kind, apply in (("chebyshev", chebyshev_precondition(
                matvec, d, order=4)), ("mg", mg)):
            stencil.stencil7.launches = 0
            z = apply(r)
            torch.cuda.synchronize()
            launches = stencil.stencil7.launches
            ms = back_to_back_ms(lambda: apply(r), launches=10, runs=5,
                                 warmup=2)
            extra = (f" levels={[tuple(lv[0].shape) for lv in mg.levels]}"
                     if kind == "mg" else "")
            print(f"precond apply {kind} {name}: stencil7_launches={launches} "
                  f"ms_per_apply={ms!r} finite="
                  f"{bool(torch.isfinite(z).all())}{extra}")
            want = 3 if kind == "chebyshev" else mg_products(len(mg.levels))
            if launches != want or not bool(torch.isfinite(z).all()):
                raise AssertionError(f"{kind} apply made {launches} launches, "
                                     f"expected {want}")
        shapes = tuple(tuple(lv[0].shape) for lv in mg.levels)
        if shapes != (BENCH_SHAPE,) + BENCH_COARSE_SHAPES:
            raise AssertionError(f"multigrid levels {shapes}")


def check_small_preconditioned(device):
    """flagship(2,64,64) with the multigrid and Chebyshev preconditioners
    in ``f64`` on the card and on the CPU: equal counts, heads within
    1e-10."""
    cpu = flagship(2, 64, 64, "cpu")
    gpu = flagship(2, 64, 64, device)
    for pc in ("mg", "chebyshev"):
        settings = ImsSettings(**ENTRY, preconditioner=pc)
        h_cpu, k_cpu, i_cpu, c_cpu = make_fused_step(cpu, settings, False)(
            cpu.strt, 1.0, 1)
        with counted_run() as counts:
            h_gpu, k_gpu, i_gpu, c_gpu = make_fused_step(
                gpu, settings, False)(gpu.strt, 1.0, 1)
        err = float((h_gpu.cpu() - h_cpu).abs().max())
        print(f"flagship(2,64,64) preconditioner={pc} f64: card outer={k_gpu} "
              f"inner={i_gpu} converged={c_gpu}; cpu outer={k_cpu} "
              f"inner={i_cpu} converged={c_cpu}; max|dh|={err!r} "
              f"bar={CARD_CPU_ATOL!r} stencil7_launches={counts['launches']} "
              f"plain_on_cuda={counts['plain_on_cuda']}")
        if not (c_gpu and c_cpu and (k_gpu, i_gpu) == (k_cpu, i_cpu)
                and err <= CARD_CPU_ATOL and counts["launches"] > i_gpu
                and not counts["plain_on_cuda"]):
            raise AssertionError(f"the card's step with {pc} disagrees with "
                                 "the CPU's")


# ------------------------------------------------------------ deck path

def _write(ws, name, text):
    with open(os.path.join(ws, name), "w") as f:
        f.write(text)


def write_deck(ws, *, name, shape, delr, top, botm, kfield, strt, icelltype,
               ss, sy, sto_periods, chd, wel_period, wel, tdis, ims, acc,
               rcha=None, oc_last=False, newton=None, linear_extra="",
               extra_packages=(), oc_extra="", wel_options=""):
    """Write an MF6 input deck for one DIS GWF model into ``ws``.

    ``kfield`` goes into an OPEN/CLOSE (BINARY) array file (a 52-byte
    header, then float64 values) that NPF reads for K; ``botm`` is one
    elevation per layer; ``chd`` and ``wel`` are 1-based (k, i, j, value)
    rows, CHD given in period 1, WEL from ``wel_period``; ``tdis`` is
    [(perlen, nstp, tsmult)]; ``sto_periods`` one keyword per period;
    ``rcha`` a constant READASARRAYS recharge; ``oc_last`` saves heads and
    budget at the last step of each period; ``newton`` is the name file's
    NEWTON option line; ``linear_extra`` a further line of the IMS LINEAR
    block; ``extra_packages`` further name-file lines (their files written
    by the caller); ``oc_extra`` further lines of the OC PERIOD 1 block;
    ``wel_options`` lines of the WEL OPTIONS block (no WEL file without
    ``wel`` rows)."""
    nlay, nrow, ncol = shape
    packages = ["DIS6 m.dis", "IC6 m.ic", "NPF6 m.npf", "STO6 m.sto",
                "CHD6 m.chd"] + (["WEL6 m.wel"] if wel else [])
    _write(ws, "mfsim.nam", f"""BEGIN TIMING
  TDIS6 sim.tdis
END TIMING
BEGIN MODELS
  GWF6 m.nam {name}
END MODELS
BEGIN SOLUTIONGROUP 1
  IMS6 sim.ims {name}
END SOLUTIONGROUP
""")
    periods = "\n".join(f"  {p!r} {n} {m!r}" for p, n, m in tdis)
    _write(ws, "sim.tdis", f"""BEGIN DIMENSIONS
  NPER {len(tdis)}
END DIMENSIONS
BEGIN PERIODDATA
{periods}
END PERIODDATA
""")
    _write(ws, "sim.ims", f"""BEGIN NONLINEAR
  OUTER_DVCLOSE {ims['outer_dvclose']!r}
  OUTER_MAXIMUM {ims['outer_maximum']}
END NONLINEAR
BEGIN LINEAR
  INNER_MAXIMUM {ims['inner_maximum']}
  INNER_DVCLOSE {ims['inner_dvclose']!r}
  INNER_RCLOSE {ims['inner_rclose']!r}
  LINEAR_ACCELERATION {acc}
  {linear_extra}
END LINEAR
""")
    botm_lines = "\n".join(f"    CONSTANT {b!r}" for b in botm)
    _write(ws, "m.dis", f"""BEGIN DIMENSIONS
  NLAY {nlay}
  NROW {nrow}
  NCOL {ncol}
END DIMENSIONS
BEGIN GRIDDATA
  DELR
    CONSTANT {delr!r}
  DELC
    CONSTANT {delr!r}
  TOP
    CONSTANT {top!r}
  BOTM LAYERED
{botm_lines}
END GRIDDATA
""")
    _write(ws, "m.ic", f"BEGIN GRIDDATA\n  STRT\n    CONSTANT {strt!r}\n"
           "END GRIDDATA\n")
    with open(os.path.join(ws, "k.bin"), "wb") as f:
        f.write(struct.pack("<iidd16siii", 1, 1, 1.0, 1.0,
                            b"K".rjust(16), ncol, nrow, 1))
        np.asarray(kfield, "<f8").tofile(f)
    _write(ws, "m.npf", f"""BEGIN GRIDDATA
  ICELLTYPE
    CONSTANT {icelltype}
  K
    OPEN/CLOSE k.bin (BINARY)
END GRIDDATA
""")
    sto = "\n".join(f"BEGIN PERIOD {i}\n  {kw}\nEND PERIOD"
                    for i, kw in enumerate(sto_periods, 1))
    _write(ws, "m.sto", f"""BEGIN GRIDDATA
  ICONVERT
    CONSTANT {icelltype}
  SS
    CONSTANT {ss!r}
  SY
    CONSTANT {sy!r}
END GRIDDATA
{sto}
""")
    chd_lines = "\n".join(f"  {k} {i} {j} {v!r}" for k, i, j, v in chd)
    _write(ws, "m.chd", f"""BEGIN DIMENSIONS
  MAXBOUND {len(chd)}
END DIMENSIONS
BEGIN PERIOD 1
{chd_lines}
END PERIOD
""")
    wel_lines = "\n".join(f"  {k} {i} {j} {v!r}" for k, i, j, v in wel)
    _write(ws, "m.wel", f"""BEGIN OPTIONS
{wel_options}END OPTIONS
BEGIN DIMENSIONS
  MAXBOUND {len(wel)}
END DIMENSIONS
BEGIN PERIOD {wel_period}
{wel_lines}
END PERIOD
""")
    if rcha is not None:
        packages.append("RCH6 m.rcha")
        _write(ws, "m.rcha", f"""BEGIN OPTIONS
  READASARRAYS
END OPTIONS
BEGIN PERIOD 1
  RECHARGE
    CONSTANT {rcha!r}
END PERIOD
""")
    if oc_last:
        packages.append("OC6 m.oc")
        _write(ws, "m.oc", """BEGIN OPTIONS
  HEAD FILEOUT m.hds
  BUDGET FILEOUT m.cbc
END OPTIONS
BEGIN PERIOD 1
  SAVE HEAD LAST
  SAVE BUDGET LAST
""" + oc_extra + """END PERIOD
""")
    packages += list(extra_packages)
    options = f"BEGIN OPTIONS\n  {newton}\nEND OPTIONS\n" if newton else ""
    _write(ws, "m.nam", options + "BEGIN PACKAGES\n"
           + "".join(f"  {line}\n" for line in packages) + "END PACKAGES\n")


def write_flagship_deck(ws, nlay, nrow, ncol, unconfined=False,
                        linear_extra="", **deck):
    """``flagship(nlay, nrow, ncol)`` as a deck: one period of three steps
    of 5.0, bench.py's IMS settings with CG, heads and budget saved at the
    last step.  ``unconfined``: the same grid, K field and stresses with
    every cell convertible (ICELLTYPE 1, ICONVERT 1, SY 0.1; the water
    table lies in layer 1), NEWTON UNDER_RELAXATION and BICGSTAB.  ``deck``
    overrides ``write_deck``'s other arguments (``tdis``, ``acc``,
    ``extra_packages``, ``oc_extra``)."""
    args = dict(
        name="FLAGSHIP", shape=(nlay, nrow, ncol), delr=10.0, top=50.0,
        botm=[float(b) for b in np.linspace(0.0, -50.0, nlay)],
        kfield=flagship_kfield(nlay, nrow, ncol), strt=40.0,
        icelltype=1 if unconfined else 0,
        ss=1e-5, sy=0.1 if unconfined else 0.0, sto_periods=["TRANSIENT"],
        chd=[(1, i + 1, 1, 45.0) for i in range(nrow)]
        + [(1, i + 1, ncol, 35.0) for i in range(nrow)],
        wel_period=1, wel=[(1, nrow // 2 + 1, ncol // 2 + 1, -500.0)],
        rcha=1e-4, tdis=[(15.0, 3, 1.0)], ims=BENCH,
        acc="BICGSTAB" if unconfined else "CG", oc_last=True,
        newton="NEWTON UNDER_RELAXATION" if unconfined else None,
        linear_extra=linear_extra)
    args.update(deck)
    write_deck(ws, **args)


def write_npf01b_deck(ws, n=21):
    """The confined npf01 deck of tests/test_regression_decks.py:286 (case
    b) on an n x n grid: three periods (steady, ten transient steps with
    tsmult 1.5, steady), CHD on both columns, a well from period 2."""
    np.random.seed(9001)
    hk = np.random.lognormal(5.0, 1.23, (n, n))
    nc = (n - 1) // 2 + 1
    write_deck(
        ws, name="NPF01", shape=(1, n, n), delr=20000.0 / n, top=0.0,
        botm=[-100.0], kfield=hk, strt=40.0, icelltype=0, ss=1e-4, sy=0.0,
        sto_periods=["STEADY-STATE", "TRANSIENT", "STEADY-STATE"],
        chd=[row for i in range(n)
             for row in ((1, i + 1, 1, 48.0), (1, i + 1, n, 40.0))],
        wel_period=2, wel=[(1, nc + 1, nc + 1, -1000.0)],
        tdis=[(1.0, 1, 1.0), (1000.0, 10, 1.5), (1.0, 1, 1.0)],
        ims=dict(outer_dvclose=1e-6, outer_maximum=100, inner_maximum=300,
                 inner_dvclose=1e-6, inner_rclose=0.01), acc="CG")


def check_deck_records(label, sim, counts, load_s, run_s):
    """Print and check what every deck run must show; returns the records."""
    recs = sim.records
    inner_total = sum(r.inner for r in recs)
    solve = [r.solve_seconds for r in recs]
    output = [r.output_seconds for r in recs]
    disc = sim.budget.percent_discrepancy()
    print(f"deck {label} cells={sim.model.nodes} steps={len(recs)} "
          f"inner_total={inner_total} inners={[r.inner for r in recs]} "
          f"outers={[r.outer for r in recs]} "
          f"converged={all(r.converged for r in recs)} load_s={load_s!r} "
          f"run_s={run_s!r} grb_s={sim.grb_seconds!r} "
          f"solve_s_per_step={solve!r} "
          f"output_s_per_step={output!r} "
          f"ims_cell_iters_per_s={sim.model.nodes * inner_total / sum(solve)!r} "
          f"stencil7_launches={counts['launches']} "
          f"plain_on_cuda={counts['plain_on_cuda']} "
          f"budget_percent_discrepancy={disc!r}")
    if not all(r.converged for r in recs):
        raise AssertionError(f"deck run ({label}): a step did not converge")
    if counts["launches"] < inner_total:
        raise AssertionError(f"{counts['launches']} kernel launches for "
                             f"{inner_total} inner iterations")
    if counts["plain_on_cuda"]:
        raise AssertionError("the deck path ran the plain stencil on a CUDA "
                             "tensor")
    if not (np.isfinite(disc) and abs(disc) < 1.0):
        raise AssertionError(f"budget percent discrepancy {disc}")
    return recs


def check_hds(path, head, ibound0, shape, kstp, kper):
    """The heads file read back equals ``head`` where ibound != 0."""
    layers = read_head_file(path)
    if [(r["kstp"], r["kper"], r["ilay"]) for r in layers] != [
            (kstp, kper, k + 1) for k in range(shape[0])]:
        raise AssertionError(f"{path}: unexpected records")
    saved = np.stack([r["data"] for r in layers]).reshape(-1)
    active = ibound0 != 0
    if not np.array_equal(saved[active], head[active]):
        raise AssertionError(f"{path}: heads differ from the run's")


def listing_counts(path):
    """[(outer, inner)] per step from a listing file's iteration summary."""
    text = open(path).read()
    outers = re.findall(r"^ (\d+) CALLS TO NUMERICAL SOLUTION", text, re.M)
    inners = re.findall(r"^ (\d+) TOTAL ITERATIONS", text, re.M)
    return [(int(o), int(i)) for o, i in zip(outers, inners)]


def run_deck_bench(device, fused_head, fused_counts):
    """The bench model as a deck at full width: in ``f64`` through the
    command-line entry and through ``load_simulation``, in ``mixed`` through
    ``load_simulation`` with the solution rebuilt; the ``f64`` runs held
    against the fused ``f64`` run.  Returns the launches of the three."""
    nlay, nrow, ncol = BENCH_SHAPE
    launches = 0
    with tempfile.TemporaryDirectory() as ws:
        t0 = time.perf_counter()
        write_flagship_deck(ws, nlay, nrow, ncol)
        print(f"deck written in {time.perf_counter() - t0:.2f} s: "
              f"{sorted(os.listdir(ws))}")

        # the command-line entry, as a user runs it
        lst = os.path.join(ws, "cli.lst")
        out = io.StringIO()
        with counted_run() as counts, contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            code = cli_main([ws, "--lst", lst])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
        launches += counts["launches"]
        cli_counts = listing_counts(lst)
        print(f"deck f64 cli exit={code} wall_s={cli_s!r} "
              f"counts={cli_counts} stencil7_launches={counts['launches']} "
              f"plain_on_cuda={counts['plain_on_cuda']} "
              f"stdout={out.getvalue().strip()!r}")
        if code != 0 or "Normal termination of simulation" not in \
                out.getvalue():
            raise AssertionError("the command-line run did not end normally")
        if cli_counts != fused_counts:
            raise AssertionError(f"deck counts {cli_counts} differ from the "
                                 f"fused run's {fused_counts}")
        if counts["plain_on_cuda"] or counts["launches"] < sum(
                i for _, i in cli_counts):
            raise AssertionError("the command-line run did not go through "
                                 "the kernel")
        fused = fused_head.cpu().numpy()
        ibound0 = np.ones(fused.size, np.int32)
        hds = os.path.join(ws, "m.hds")
        cli_head = np.stack([r["data"] for r in read_head_file(hds)]
                            ).reshape(-1)
        err = float(np.abs(cli_head - fused).max())
        sizes = {f: os.path.getsize(os.path.join(ws, f))
                 for f in ("m.hds", "m.cbc", "m.grb", "cli.lst")}
        print(f"deck f64 cli .hds vs fused f64: max|dh|={err!r} "
              f"bar={DECK_FUSED_ATOL!r} file_bytes={sizes}")
        if not err <= DECK_FUSED_ATOL:
            raise AssertionError("the deck's saved heads differ from the "
                                 "fused run's")

        for precision in ("f64", "mixed"):
            t0 = time.perf_counter()
            sim = load_simulation(ws)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            if str(sim.model.device) != str(device):
                raise AssertionError(f"the model is on {sim.model.device}")
            if precision == "mixed":
                # the loader never sets precision: rebuild the solution on
                # the changed settings, as the reference rebuilds it
                sim.solution = NumericalSolution(
                    sim.model, dataclasses.replace(sim.solution.s,
                                                   precision="mixed"))
            with counted_run() as counts:
                t0 = time.perf_counter()
                sim.run()
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
            launches += counts["launches"]
            recs = check_deck_records(precision, sim, counts, load_s, run_s)
            check_hds(hds, recs[-1].head, ibound0, BENCH_SHAPE, 3, 1)
            err = float(np.abs(recs[-1].head - fused).max())
            # mixed and f64 are two solves closed at outer_dvclose: they
            # agree to that criterion, not to rounding
            bar = (DECK_FUSED_ATOL if precision == "f64"
                   else 10.0 * BENCH["outer_dvclose"])
            print(f"deck {precision} vs fused f64: max|dh|={err!r} "
                  f"bar={bar!r}")
            if not err <= bar:
                raise AssertionError(f"deck heads ({precision}) differ from "
                                     "the fused run's")
            if precision == "f64" and [(r.outer, r.inner) for r in recs] \
                    != fused_counts:
                raise AssertionError("deck counts differ from the fused "
                                     "run's")
    return launches


def run_deck_preconditioned(device, jacobi_head, jacobi_inner):
    """The bench model as a deck whose IMS file sets PRECONDITIONER_LEVELS
    (the reference program's ILU setting, which the loader maps to the
    Chebyshev preconditioner of order 4), in ``f64`` through
    ``load_simulation``: held against the fused Jacobi ``f64`` run."""
    nlay, nrow, ncol = BENCH_SHAPE
    with tempfile.TemporaryDirectory() as ws:
        write_flagship_deck(ws, nlay, nrow, ncol,
                            linear_extra="PRECONDITIONER_LEVELS 1")
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sim = load_simulation(ws)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        s = sim.solution.s
        if (s.preconditioner, s.preconditioner_order) != ("chebyshev", 4) \
                or not any("Chebyshev" in str(w.message) for w in caught):
            raise AssertionError("PRECONDITIONER_LEVELS did not load as the "
                                 "Chebyshev preconditioner with a warning")
        with counted_run() as counts:
            t0 = time.perf_counter()
            sim.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        recs = check_deck_records("f64 PRECONDITIONER_LEVELS", sim, counts,
                                  load_s, run_s)
    inner_total = sum(r.inner for r in recs)
    err = float(np.abs(recs[-1].head - jacobi_head.cpu().numpy()).max())
    bar = CLOSURE_FACTOR * BENCH["outer_dvclose"]
    print(f"deck f64 PRECONDITIONER_LEVELS (chebyshev) vs fused jacobi f64: "
          f"max|dh|={err!r} bar={bar!r} inner_total={inner_total} "
          f"jacobi_inner_total={jacobi_inner}")
    if not (err <= bar and inner_total < jacobi_inner
            and counts["launches"] >= 4 * inner_total):
        raise AssertionError("the PRECONDITIONER_LEVELS deck run failed its "
                             "checks")
    return counts["launches"]


def run_newton_deck(device, preconditioner):
    """The bench grid made unconfined (see write_flagship_deck) as a NEWTON
    UNDER_RELAXATION deck with BICGSTAB, three transient steps of 5.0 in
    ``f64`` through ``load_simulation``.  A deck can choose Jacobi or (by
    PRECONDITIONER_LEVELS) Chebyshev; ``mg`` is set on the loaded settings,
    as a program that builds its ``ImsSettings`` itself would."""
    nlay, nrow, ncol = BENCH_SHAPE
    with tempfile.TemporaryDirectory() as ws:
        write_flagship_deck(
            ws, nlay, nrow, ncol, unconfined=True,
            linear_extra=("PRECONDITIONER_LEVELS 1"
                          if preconditioner == "chebyshev" else ""))
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sim = load_simulation(ws)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if preconditioner == "mg":
            sim.solution = NumericalSolution(
                sim.model, dataclasses.replace(sim.solution.s,
                                               preconditioner="mg"))
        s, m = sim.solution.s, sim.model
        if not (m.inewton and m.inewtonur and s.preconditioner
                == preconditioner and s.linear_acceleration == "bicgstab"
                and not m.is_linear):
            raise AssertionError("the unconfined deck did not load as a "
                                 "Newton model")
        with counted_run() as counts:
            t0 = time.perf_counter()
            sim.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
        recs = check_deck_records(f"newton f64 {preconditioner}", sim, counts,
                                  load_s, run_s)
    head = recs[-1].head
    layer1 = head[:nrow * ncol]
    finite = bool(np.isfinite(head).all())
    print(f"deck newton f64 {preconditioner}: layer-1 head min="
          f"{float(layer1.min())!r} max={float(layer1.max())!r} (bottom 0.0, "
          f"top 50.0) finite={finite} "
          f"outers_per_step={[r.outer for r in recs]}")
    if not (finite and 0.0 < layer1.min() and layer1.max() < 50.0):
        raise AssertionError("the water table left layer 1")
    return counts["launches"]


def _row_grid(ncol, delr, top):
    return DisGrid.create(1, 1, ncol, delr, delr, top, np.zeros((1, 1, ncol)))


def check_small_newton(device):
    """Newton, PTC and rewetting at a small size on the card against the
    CPU: a steady Newton row with PTC on through ``NumericalSolution`` and
    through the fused step (the scenario of the reference's
    test_fused_matches_ims_with_ptc), and the two-layer rewetting scenario
    (test_npf_rewetting_two_layer): equal outer counts, the same wet cells,
    inner counts within 25%, and heads within 10 x outer_dvclose.  These
    bars are not the equal counts and 1e-10 of the CG models.  BiCGSTAB
    turns the order of a sum into other inner counts (the card and the CPU
    reduce in different orders; tests/test_torch_ims.py and
    tests/test_torch_newton.py show the same between XLA's order and
    PyTorch's, with equal counts at one order), and it leaves each of these
    small, stiff systems at the accuracy its inner closure allows:
    tightening that closure moves the CPU's own heads by 8e-10
    (test_small_newton_heads_are_set_by_the_inner_closure)."""
    newton = dict(outer_dvclose=1e-9, outer_maximum=150, inner_dvclose=1e-11,
                  inner_rclose=1e-10, inner_maximum=300,
                  linear_acceleration="bicgstab")
    rewet = dict(outer_dvclose=1e-8, outer_maximum=300, inner_dvclose=1e-10,
                 inner_rclose=1e-9, inner_maximum=500,
                 linear_acceleration="bicgstab", under_relaxation="dbd",
                 theta=0.9, akappa=1e-4, gamma=0.0, amomentum=0.0)
    nlay, ncol = 2, 9
    botm = np.zeros((nlay, 1, ncol))
    botm[0] = 10.0
    wetdry = np.zeros(nlay * ncol)
    wetdry[:ncol] = 1.0

    def models(dev):
        return (
            build_gwf("ptc", _row_grid(15, 20.0, 30.0), k=2.0, strt=25.0,
                      icelltype=1, newton=True, chd=[(0, 28.0), (14, 8.0)],
                      device=dev),
            build_gwf("rewet", DisGrid.create(nlay, 1, ncol, 10.0, 10.0, 20.0,
                                              botm),
                      k=5.0, k33=5.0, strt=5.0, icelltype=1,
                      chd=[(ncol, 18.0), (2 * ncol - 1, 12.0)],
                      rewetting=dict(wetdry=wetdry, wetfct=1.0, iwetit=1,
                                     ihdwet=0), device=dev))

    def solve(dev):
        ptc, rew = models(dev)
        out = {}
        sol = NumericalSolution(ptc, ImsSettings(**newton))
        if not sol._use_ptc(True, 2):
            raise AssertionError("PTC is off on the steady Newton model")
        h, info, _ = sol.solve_timestep(ptc.strt, 1.0, iss=True, kper=2)
        out["newton ptc ims"] = (h.cpu(), info.outer_iterations,
                                 info.inner_iterations, info.converged, None)
        h, k, i, c = make_fused_step(ptc, ImsSettings(**newton), iss=True,
                                     kper=2)(ptc.strt, 1.0, 1)
        out["newton ptc fused"] = (h.cpu(), k, i, c, None)
        h, info, aux = NumericalSolution(rew, ImsSettings(**rewet)
                                         ).solve_timestep(rew.strt, 1.0,
                                                          iss=True)
        out["rewetting"] = (h.cpu(), info.outer_iterations,
                            info.inner_iterations, info.converged,
                            aux["ibound"].cpu())
        return out

    cpu = solve("cpu")
    with counted_run() as counts:
        card = solve(device)
    for name, (h, k, i, c, ib) in card.items():
        h0, k0, i0, c0, ib0 = cpu[name]
        err = float((h - h0).abs().max())
        same_cells = ib is None or bool((ib == ib0).all())
        bar = CLOSURE_FACTOR * (rewet if name == "rewetting"
                                else newton)["outer_dvclose"]
        print(f"small {name}: card outer={k} inner={i} converged={c}; cpu "
              f"outer={k0} inner={i0} converged={c0}; max|dh|={err!r} "
              f"bar={bar!r} same_wet_cells={same_cells}")
        if not (c and c0 and k == k0 and abs(i - i0) <= 0.25 * i0
                and same_cells and err <= bar):
            raise AssertionError(f"{name}: the card disagrees with the CPU")
    ims, fused = card["newton ptc ims"], card["newton ptc fused"]
    if ims[1:3] != fused[1:3] or float((ims[0] - fused[0]).abs().max()) \
            > 1e-12:
        raise AssertionError("the fused step with PTC disagrees with "
                             "NumericalSolution on the card")
    if int((card["rewetting"][4][:ncol] > 0).sum()) == 0:
        raise AssertionError("no upper-layer cell rewetted")
    print(f"small newton/ptc/rewetting: stencil7_launches="
          f"{counts['launches']} plain_on_cuda={counts['plain_on_cuda']}")
    if counts["plain_on_cuda"] or not counts["launches"]:
        raise AssertionError("the small Newton models did not go through "
                             "the kernel on the card")


def check_small_deck(device):
    """npf01b at 21x21 on the card and on the CPU: equal counts, heads
    within 1e-10."""
    runs = {}
    with tempfile.TemporaryDirectory() as ws:
        write_npf01b_deck(ws, 21)
        for name, dev in (("card", None), ("cpu", "cpu")):
            with counted_run() as counts:
                sim = load_simulation(ws, device=dev)
                runs[name] = sim.run()
            if name == "card" and (counts["plain_on_cuda"]
                                   or not counts["launches"]):
                raise AssertionError("the small deck did not go through the "
                                     "kernel on the card")
    card, cpu = runs["card"], runs["cpu"]
    err = max(float(np.abs(a.head - b.head).max())
              for a, b in zip(card, cpu))
    same = ([(r.outer, r.inner, r.converged) for r in card]
            == [(r.outer, r.inner, r.converged) for r in cpu])
    print(f"deck npf01b 21x21: card counts="
          f"{[(r.outer, r.inner) for r in card]} cpu equal={same} "
          f"converged={all(r.converged for r in card)} max|dh|={err!r} "
          f"bar={CARD_CPU_ATOL!r}")
    if not (same and len(card) == 12 and all(r.converged for r in card)
            and err <= CARD_CPU_ATOL):
        raise AssertionError("the small deck on the card disagrees with "
                             "the CPU")


# ---------------------------------------------------------- general path

def quad_disv(nlay, nrow, ncol, d, top, botm):
    """nrow x ncol square cells of side ``d`` per layer as a DISV grid,
    cell (i, j) at number i*ncol + j as in a DIS grid, rings clockwise."""
    xs, ys = np.arange(ncol + 1) * d, (nrow - np.arange(nrow + 1)) * d
    vx, vy = np.meshgrid(xs, ys)
    i, j = np.divmod(np.arange(nrow * ncol), ncol)
    v0 = i * (ncol + 1) + j
    javert = np.stack([v0, v0 + 1, v0 + ncol + 2, v0 + ncol + 1],
                      axis=1).reshape(-1)
    return DisvGrid.from_arrays(
        nlay, np.stack([vx.ravel(), vy.ravel()], axis=1), (j + 0.5) * d,
        (nrow - i - 0.5) * d, np.arange(nrow * ncol + 1) * 4, javert, top,
        botm)


def brick_disv(nlay, nrow, ncol, d, top, botm, idomain=None):
    """The same cells with every other row offset by half a cell: six
    horizontal neighbours, which a DIS grid cannot hold.  Each ring holds
    the midpoints of its top and bottom sides, where the corners of the
    rows above and below lie."""
    nx = 2 * ncol + 2
    xs, ys = np.arange(nx) * d / 2, (nrow - np.arange(nrow + 1)) * d
    vx, vy = np.meshgrid(xs, ys)
    i, j = np.divmod(np.arange(nrow * ncol), ncol)
    c0 = 2 * j + i % 2
    t, b = i * nx + c0, (i + 1) * nx + c0
    javert = np.stack([t, t + 1, t + 2, b + 2, b + 1, b], axis=1).reshape(-1)
    return DisvGrid.from_arrays(
        nlay, np.stack([vx.ravel(), vy.ravel()], axis=1), (c0 / 2 + 0.5) * d,
        (nrow - i - 0.5) * d, np.arange(nrow * ncol + 1) * 6, javert, top,
        botm, idomain)


def disu_of(grid, stagger_every=5):
    """The connections of a DISV grid as a DISU grid, every
    ``stagger_every``-th horizontal one made vertically staggered."""
    t = grid.build_topology()
    ia, ja, pnm, pmn = t.csr
    ihc = np.zeros(ja.size, np.int64)
    cl12, hwva, ang = (np.zeros(ja.size) for _ in range(3))
    e_ihc = t.ihc.copy()
    e_ihc[np.nonzero(e_ihc == 1)[0][::stagger_every]] = 2
    for pos, cl, dang in ((pnm, t.cl1, 0.0), (pmn, t.cl2, 180.0)):
        ihc[pos] = e_ihc
        cl12[pos] = cl
        hwva[pos] = t.hwva
        ang[pos] = np.rad2deg(t.anglex) + dang
    return DisuGrid.create(grid.top, grid.bot, grid.area, np.diff(ia), ja,
                           ihc, cl12, hwva, ang,
                           (grid.idomain.reshape(-1) > 0).astype(np.int32))


def flagship_stresses(nrow, ncol):
    """CHD, WEL and RCH of ``flagship`` by cell number in layer 1."""
    return dict(
        chd=[(i * ncol, 45.0) for i in range(nrow)]
        + [(i * ncol + ncol - 1, 35.0) for i in range(nrow)],
        wel=[((nrow // 2) * ncol + ncol // 2, -500.0)],
        rch=[(n, 1e-4) for n in range(nrow * ncol)])


def flagship_botm(nlay, ncpl):
    return np.linspace(0.0, -50.0, nlay)[:, None] * np.ones((nlay, ncpl))


def ell_bound_ms(n, k, index_bytes=8):
    """The least time the card could take for one gather product: diag, x
    and y of n float64 values, the n x k coefficients and the n x k
    neighbour numbers, each read or written once, over the card's memory
    rate.  (The gathered x[nbr] are reads of x again, mostly from cache,
    and the 2 k n operations are far below the memory time.)"""
    nbytes = n * (3 * 8 + k * (8 + index_bytes))
    return nbytes / HBM_BYTES_PER_S * 1e3


def first_system(model, delt=5.0):
    """The model's first assembled and fixed-up system and its start."""
    ib, h = model.boundary_state(model.strt)
    diag, off, rhs = model.assemble(h, h, ib, delt, False)
    diag, off, rhs = fix_system(model, torch.sign(ib), diag, off, rhs, h,
                                symmetric=True)
    return diag, off, rhs, h


def run_disv_oracle(device, dis_head, dis_counts):
    """The bench model on a DISV grid of 1024 x 1024 square cells a layer
    through ``build_gwf`` and the fused run in ``f64`` with Jacobi CG, held
    against the structured run of this call (``dis_head``, ``dis_counts``):
    the first systems' products agree to rounding, the heads to 1e-10.
    Prints the host's build times, the device memory, and the
    gather product's time beside its bound and the stencil kernel's."""
    nlay, nrow, ncol = BENCH_SHAPE
    ncpl = nrow * ncol
    t0 = time.perf_counter()
    grid = quad_disv(nlay, nrow, ncol, 10.0, 50.0, flagship_botm(nlay, ncpl))
    area_ok = bool((grid.area == 100.0).all())
    t1 = time.perf_counter()
    topo = grid.build_topology()
    k = topo.max_degree          # builds the ELL table
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = flagship_disv(device)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    d = model.dtopo
    print(f"disv grid: cells={grid.nodes} edges={topo.nedges} K={k} "
          f"grid_s={t1 - t0!r} topology_s={t2 - t1!r} build_gwf_s={t3 - t2!r} "
          f"(build_gwf builds the topology again) areas_exact={area_ok} "
          f"nbr_bytes={d.nbr.numel() * d.nbr.element_size()} "
          f"off_bytes={grid.nodes * k * 8} "
          f"edge_table_bytes={sum(t.numel() * t.element_size() for t in (d.edge_n, d.edge_m, d.ihc, d.cl1, d.cl2, d.hwva, d.anglex, d.slot_nm, d.slot_mn))} "
          f"model_bytes={torch.cuda.memory_allocated() - base}")
    if model.use_structured or d.grid_shape is not None \
            or k != 4 + min(2, nlay - 1) or not area_ok:
        raise AssertionError("the DISV model is not on the general path")

    # the two first systems: the same matrix and right-hand side
    dis = flagship(*BENCH_SHAPE, device)
    gd, go, gr, gh = first_system(model)
    sd, so, sr, _ = first_system(dis)
    gen = torch.Generator(device=device).manual_seed(4)
    x = torch.randn(grid.nodes, dtype=torch.float64, device=device,
                    generator=gen)
    mv_general = make_matvec(model.dtopo, gd, go)
    mv_stencil = make_matvec(dis.dtopo, sd, so)
    y, ys = mv_general(x), mv_stencil(x)
    err = float((y - ys).abs().max() / ys.abs().max())
    err_rhs = float((gr - sr).abs().max() / sr.abs().max())
    print(f"disv vs dis first system: max|A_disv x - A_dis x|/max|A x|="
          f"{err!r} max|rhs diff|/max|rhs|={err_rhs!r} bar={SYSTEM_RTOL!r}")
    if not (err <= SYSTEM_RTOL and err_rhs <= SYSTEM_RTOL):
        raise AssertionError("the DISV system differs from the DIS system")
    ell_ms = back_to_back_ms(lambda: mv_general(x))
    st_ms = back_to_back_ms(lambda: mv_stencil(x))
    bound = ell_bound_ms(grid.nodes, k)
    print(f"ell product f64 cells={grid.nodes} K={k}: ms={ell_ms!r} (100 "
          f"products per event pair) bound_ms={bound!r} bound_by=bytes "
          f"bound_share={bound / ell_ms!r} stencil7_ms_same_system={st_ms!r} "
          f"stencil7_bound_ms={stencil_bound_ms(BENCH_SHAPE, torch.float64)!r}")
    del dis, gd, go, gr, gh, sd, so, sr, mv_general, mv_stencil, y, ys

    run = make_fused_run(model, ImsSettings(**BENCH), iss=False, nsteps=3)
    delts = [5.0, 5.0, 5.0]
    run(model.strt, delts)
    torch.cuda.synchronize()
    with counted_run() as counts:
        t0 = time.perf_counter()
        head, kiters, inners, convs = run(model.strt, delts)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    again = run(model.strt, delts)[0]
    inner_total = sum(inners)
    err = float((head - dis_head).abs().max())
    finite = bool(torch.isfinite(head).all())
    bitwise = bool(torch.equal(head, again))
    print(f"disv bench precision=f64 preconditioner=jacobi cells="
          f"{grid.nodes} steps=3 inner_total={inner_total} inners={inners} "
          f"outers={kiters} converged={all(convs)} elapsed_s={elapsed!r} "
          f"ms_per_inner={elapsed / inner_total * 1e3!r} "
          f"ims_cell_iters_per_s={grid.nodes * inner_total / elapsed!r} "
          f"structured_counts={dis_counts} stencil7_launches="
          f"{counts['launches']} max|h - h_structured|={err!r} "
          f"bar={GENERAL_STRUCTURED_ATOL!r} two_runs_bitwise_equal={bitwise} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    if not (all(convs) and finite and bitwise
            and err <= GENERAL_STRUCTURED_ATOL):
        raise AssertionError("the DISV run failed its checks")
    if counts["launches"] or counts["plain_on_cuda"]:
        raise AssertionError("the DISV run went through the stencil")


def brick_model_args(nlay, nrow, ncol, evt_rows=None):
    """K and the stresses of the bench model from the same seed, with CHD
    on the first column only, GHB on the last, drains along the first row,
    a river along the middle row and evapotranspiration over layer 1 (or
    over the rows ``evt_rows`` of it)."""
    s = flagship_stresses(nrow, ncol)
    mid = nrow // 2
    evt_rows = range(nrow) if evt_rows is None else evt_rows
    return dict(
        k=flagship_kfield(nlay, nrow, ncol), strt=40.0,
        storage={"ss": 1e-5, "iconvert": 0},
        chd=[(i * ncol, 45.0) for i in range(1, nrow)], wel=s["wel"],
        rch=s["rch"],
        ghb=[(i * ncol + ncol - 1, 35.0, 50.0) for i in range(1, nrow)],
        drn=[(j, 38.0, 20.0) for j in range(ncol)],
        riv=[(mid * ncol + j, 41.0, 30.0, 39.0) for j in range(1, ncol - 1)
             if j != ncol // 2],
        evt=[(i * ncol + j, 45.0, 1e-4, 10.0) for i in evt_rows
             for j in range(ncol)])


def write_brick_deck(ws, grid, args):
    """A one-layer brick DISV grid and the stresses of ``brick_model_args``
    as an MF6 input deck: DISV6 with its VERTICES and CELL2D blocks as
    text, K as a binary file, recharge READASARRAYS, the other packages as
    lists with (layer, cell) ids; one transient period of three steps of
    5.0, the bench's IMS settings with CG, heads and budget saved at the
    last step."""
    _write(ws, "mfsim.nam", """BEGIN TIMING
  TDIS6 sim.tdis
END TIMING
BEGIN MODELS
  GWF6 m.nam BRICK
END MODELS
BEGIN SOLUTIONGROUP 1
  IMS6 sim.ims BRICK
END SOLUTIONGROUP
""")
    _write(ws, "sim.tdis", "BEGIN DIMENSIONS\n  NPER 1\nEND DIMENSIONS\n"
           "BEGIN PERIODDATA\n  15.0 3 1.0\nEND PERIODDATA\n")
    _write(ws, "sim.ims", f"""BEGIN NONLINEAR
  OUTER_DVCLOSE {BENCH['outer_dvclose']!r}
  OUTER_MAXIMUM {BENCH['outer_maximum']}
END NONLINEAR
BEGIN LINEAR
  INNER_MAXIMUM {BENCH['inner_maximum']}
  INNER_DVCLOSE {BENCH['inner_dvclose']!r}
  INNER_RCLOSE {BENCH['inner_rclose']!r}
  LINEAR_ACCELERATION CG
END LINEAR
""")
    _write(ws, "m.nam", "BEGIN PACKAGES\n" + "".join(
        f"  {line}\n" for line in (
            "DISV6 m.disv", "IC6 m.ic", "NPF6 m.npf", "STO6 m.sto",
            "CHD6 m.chd", "WEL6 m.wel", "DRN6 m.drn", "RIV6 m.riv",
            "GHB6 m.ghb", "EVT6 m.evt", "RCH6 m.rcha", "OC6 m.oc"))
           + "END PACKAGES\n")
    rings = (grid.javert.reshape(grid.ncpl, 6) + 1).tolist()
    with open(os.path.join(ws, "m.disv"), "w") as f:
        f.write(f"BEGIN DIMENSIONS\n  NLAY 1\n  NCPL {grid.ncpl}\n"
                f"  NVERT {len(grid.vertices)}\nEND DIMENSIONS\n"
                "BEGIN GRIDDATA\n  TOP\n    CONSTANT 50.0\n  BOTM\n"
                "    CONSTANT 0.0\nEND GRIDDATA\nBEGIN VERTICES\n")
        f.write("\n".join(f"  {i} {x!r} {y!r}" for i, (x, y) in enumerate(
            grid.vertices.tolist(), 1)))
        f.write("\nEND VERTICES\nBEGIN CELL2D\n")
        f.write("\n".join(
            f"  {i} {xc!r} {yc!r} 6 " + " ".join(map(str, ring))
            for i, (xc, yc, ring) in enumerate(
                zip(grid.xc.tolist(), grid.yc.tolist(), rings), 1)))
        f.write("\nEND CELL2D\n")
    _write(ws, "m.ic", "BEGIN GRIDDATA\n  STRT\n    CONSTANT 40.0\n"
           "END GRIDDATA\n")
    with open(os.path.join(ws, "k.bin"), "wb") as f:
        f.write(struct.pack("<iidd16siii", 1, 1, 1.0, 1.0, b"K".rjust(16),
                            grid.ncpl, 1, 1))
        np.asarray(args["k"], "<f8").tofile(f)
    _write(ws, "m.npf", "BEGIN GRIDDATA\n  ICELLTYPE\n    CONSTANT 0\n  K\n"
           "    OPEN/CLOSE k.bin (BINARY)\nEND GRIDDATA\n")
    _write(ws, "m.sto", "BEGIN GRIDDATA\n  ICONVERT\n    CONSTANT 0\n  SS\n"
           "    CONSTANT 1e-05\n  SY\n    CONSTANT 0.0\nEND GRIDDATA\n"
           "BEGIN PERIOD 1\n  TRANSIENT\nEND PERIOD\n")
    for pkg in ("chd", "wel", "drn", "riv", "ghb", "evt"):
        rows = "\n".join("  1 " + " ".join(
            str(v + 1) if col == 0 else repr(float(v))
            for col, v in enumerate(row)) for row in args[pkg])
        _write(ws, f"m.{pkg}", f"BEGIN DIMENSIONS\n  MAXBOUND "
               f"{len(args[pkg])}\nEND DIMENSIONS\nBEGIN PERIOD 1\n{rows}\n"
               "END PERIOD\n")
    _write(ws, "m.rcha", "BEGIN OPTIONS\n  READASARRAYS\nEND OPTIONS\n"
           "BEGIN PERIOD 1\n  RECHARGE\n    CONSTANT 0.0001\nEND PERIOD\n")
    _write(ws, "m.oc", "BEGIN OPTIONS\n  HEAD FILEOUT m.hds\n"
           "  BUDGET FILEOUT m.cbc\nEND OPTIONS\nBEGIN PERIOD 1\n"
           "  SAVE HEAD LAST\n  SAVE BUDGET LAST\nEND PERIOD\n")


def run_brick_deck(device):
    """A brick-pattern DISV grid of 1024 x 1024 cells in one layer with the
    seven packages as a written DISV6 deck through the command-line entry,
    held against the same model built in memory and run through
    ``Simulation``: equal counts, heads within 1e-10."""
    nrow, ncol = BENCH_SHAPE[1:]
    grid = brick_disv(1, nrow, ncol, 10.0, 50.0, np.zeros((1, nrow * ncol)))
    args = brick_model_args(1, nrow, ncol,
                            evt_rows=range(nrow // 4, min(nrow, nrow // 4 + 64)))
    with tempfile.TemporaryDirectory() as ws:
        t0 = time.perf_counter()
        write_brick_deck(ws, grid, args)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sim = load_simulation(ws)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same_grid = (np.array_equal(sim.model.grid.javert, grid.javert)
                     and np.array_equal(sim.model.grid.vertices,
                                        grid.vertices))
        del sim
        lst = os.path.join(ws, "cli.lst")
        out = io.StringIO()
        with counted_run() as counts, contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            code = cli_main([ws, "--lst", lst])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
        cli_counts = listing_counts(lst)
        saved = np.stack([r["data"] for r in read_head_file(
            os.path.join(ws, "m.hds"))]).reshape(-1)
        sizes = {f: os.path.getsize(os.path.join(ws, f))
                 for f in ("m.disv", "m.evt", "m.hds", "m.cbc", "m.grb")}
    model = build_gwf("brick", grid, device=device, **args)
    twin = Simulation(Tdis((StressPeriod(15.0, 3, 1.0),)), model,
                      ImsSettings(**BENCH))
    recs = twin.run()
    err = float(np.abs(saved - recs[-1].head).max())
    twin_counts = [(r.outer, r.inner) for r in recs]
    print(f"brick deck cells={grid.nodes} write_s={write_s!r} "
          f"load_s={load_s!r} (one load_simulation before the run) "
          f"cli exit={code} wall_s={cli_s!r} counts={cli_counts} "
          f"in_memory_counts={twin_counts} "
          f"converged={all(r.converged for r in recs)} "
          f"stencil7_launches={counts['launches']} "
          f"max|h_deck - h_in_memory|={err!r} bar={DECK_FUSED_ATOL!r} "
          f"grid_arrays_equal={same_grid} file_bytes={sizes} "
          f"stdout={out.getvalue().strip()!r}")
    if code != 0 or "Normal termination of simulation" not in out.getvalue():
        raise AssertionError("the brick deck did not end normally")
    if not (same_grid and cli_counts == twin_counts
            and all(r.converged for r in recs) and err <= DECK_FUSED_ATOL
            and not counts["launches"]):
        raise AssertionError("the brick deck run differs from the model "
                             "built in memory")


def run_brick(device):
    """The bench extent as a brick-pattern DISV grid (K = 8) with DRN, RIV,
    GHB and EVT beside CHD, WEL and RCH, built in memory and run through
    ``Simulation`` (three transient steps of 5.0, CG; heads, budget and
    grid files written): every step converged, the budget closed, the
    heads file read back, and a second run bitwise equal."""
    nlay, nrow, ncol = BENCH_SHAPE
    ncpl = nrow * ncol
    t0 = time.perf_counter()
    grid = brick_disv(nlay, nrow, ncol, 10.0, 50.0, flagship_botm(nlay, ncpl))
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_gwf("brick", grid, device=device,
                      **brick_model_args(nlay, nrow, ncol))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    k = model.dtopo.max_degree
    print(f"brick grid: cells={grid.nodes} edges={model.topo.nedges} K={k} "
          f"grid_s={t1 - t0!r} build_gwf_s={t2 - t1!r} "
          f"is_linear={model.is_linear} "
          f"degree_histogram={model.topo.degree_histogram().tolist()}")
    if model.use_structured or k != 6 + min(2, nlay - 1) \
            or model.is_linear:
        raise AssertionError("the brick model is not what it should be")
    oc = OutputControl({1: {("SAVE", "HEAD"): ("LAST",),
                            ("SAVE", "BUDGET"): ("LAST",)}})
    heads = []
    with tempfile.TemporaryDirectory() as ws:
        for attempt in range(2):
            files = attempt == 0
            sim = Simulation(
                Tdis((StressPeriod(15.0, 3, 1.0),)), model,
                ImsSettings(**BENCH), oc=oc,
                hds_path=os.path.join(ws, "brick.hds") if files else None,
                cbc_path=os.path.join(ws, "brick.cbc") if files else None)
            with counted_run() as counts:
                t0 = time.perf_counter()
                recs = sim.run()
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
            heads.append(recs[-1].head)
            if not files:
                continue
            inner_total = sum(r.inner for r in recs)
            solve = sum(r.solve_seconds for r in recs)
            disc = sim.budget.percent_discrepancy()
            terms = {t.name: (t.rate_in, t.rate_out)
                     for t in sim.budget.terms.values()}
            sizes = {f: os.path.getsize(os.path.join(ws, f))
                     for f in sorted(os.listdir(ws))}
            print(f"brick simulation cells={grid.nodes} steps={len(recs)} "
                  f"inner_total={inner_total} "
                  f"inners={[r.inner for r in recs]} "
                  f"outers={[r.outer for r in recs]} "
                  f"converged={all(r.converged for r in recs)} run_s={run_s!r} "
                  f"grb_s={sim.grb_seconds!r} solve_s={solve!r} "
                  f"output_s={sum(r.output_seconds for r in recs)!r} "
                  f"ms_per_inner={solve / inner_total * 1e3!r} "
                  f"stencil7_launches={counts['launches']} "
                  f"budget_percent_discrepancy={disc!r} bar={BUDGET_PERCENT!r} "
                  f"budget_in_out={terms} file_bytes={sizes} "
                  f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
            if not all(r.converged for r in recs):
                raise AssertionError("brick run: a step did not converge")
            if not (np.isfinite(recs[-1].head).all() and np.isfinite(disc)
                    and abs(disc) < BUDGET_PERCENT):
                raise AssertionError(f"brick run: budget discrepancy {disc}")
            if set(terms) != {"STO-SS", "STO-SY", "WEL", "RCH", "DRN", "RIV",
                              "GHB", "EVT", "CHD"} or not all(
                    terms[p][0] + terms[p][1] > 0
                    for p in ("DRN", "RIV", "GHB", "EVT")):
                raise AssertionError(f"brick run: budget terms {terms}")
            if counts["launches"] or "brick.grb" not in sizes:
                raise AssertionError("brick run: stencil launches or no grid "
                                     "file")
            layers = read_head_file(os.path.join(ws, "brick.hds"))
            saved = np.stack([r["data"] for r in layers]).reshape(-1)
            if [(r["kstp"], r["ilay"], r["data"].shape) for r in layers] != [
                    (3, kk + 1, (1, ncpl)) for kk in range(nlay)] \
                    or not np.array_equal(saved, recs[-1].head):
                raise AssertionError("brick run: the heads file differs from "
                                     "the run's heads")
    bitwise = bool(np.array_equal(heads[0], heads[1]))
    print(f"brick simulation: two runs bitwise equal={bitwise}")
    if not bitwise:
        raise AssertionError("two brick runs on the card differ")


def rotated_args(nlay, nrow, ncol):
    """``flagship``'s arguments with K22 = 0.1 K and an ellipse rotated by
    an angle (``angle1``, radians as the two-point scheme reads it) that
    varies from cell to cell."""
    rng = np.random.default_rng(76)
    args = flagship_args(nlay, nrow, ncol)
    return dict(args, k22=0.1 * args["k"],
                angle1=rng.uniform(0.0, np.pi / 2, args["k"].size))


def rotated_model(nlay, nrow, ncol, device):
    """``flagship`` with rotated anisotropy: a DIS model off the structured
    path."""
    return build_gwf("rotated", flagship_grid(nlay, nrow, ncol),
                     device=device, **rotated_args(nlay, nrow, ncol))


def run_rotated(device):
    """The stencil kernel's caller off the structured path: the bench grid
    with rotated anisotropy assembles over the edge list, fixes its rows
    through the gather, and multiplies through ``stencil7``.  Chebyshev CG
    in ``f64`` at full width, and a 3 x 37 x 45 twin on the card against the
    CPU.  Returns the launches of the full-width run."""
    settings = ImsSettings(**BENCH, preconditioner="chebyshev")
    (hc, kc, ic, cc), (hg, kg, ig, cg_) = (
        make_fused_run(m, settings, False, 3)(m.strt, [5.0] * 3)
        for m in (rotated_model(3, 37, 45, dev) for dev in ("cpu", device)))
    err = float((hg.cpu() - hc).abs().max())
    print(f"rotated(3,37,45) chebyshev f64: card outers={kg} inners={ig} "
          f"converged={all(cg_)}; cpu outers={kc} inners={ic}; "
          f"max|dh|={err!r} bar={CARD_CPU_ATOL!r}")
    if not (all(cg_) and all(cc) and (kg, ig) == (kc, ic)
            and err <= CARD_CPU_ATOL):
        raise AssertionError("the rotated model on the card disagrees with "
                             "the CPU")

    t0 = time.perf_counter()
    model = rotated_model(*BENCH_SHAPE, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if model.use_structured or model.dtopo.grid_shape != BENCH_SHAPE \
            or model.dtopo.max_degree != 6:
        raise AssertionError("the rotated model is not on the general path "
                             "with its grid shape")
    run = make_fused_run(model, settings, iss=False, nsteps=3)
    with counted_run() as counts:
        t0 = time.perf_counter()
        head, kiters, inners, convs = run(model.strt, [5.0] * 3)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    inner_total = sum(inners)
    finite = bool(torch.isfinite(head).all())
    print(f"rotated bench precision=f64 preconditioner=chebyshev cells="
          f"{model.nodes} edges={model.dtopo.edge_n.shape[0]} steps=3 "
          f"build_gwf_s={build_s!r} inner_total={inner_total} "
          f"inners={inners} outers={kiters} converged={all(convs)} "
          f"elapsed_s={elapsed!r} (first run, no warm-up) "
          f"ms_per_inner={elapsed / inner_total * 1e3!r} "
          f"stencil7_launches={counts['launches']} "
          f"plain_on_cuda={counts['plain_on_cuda']} head_min="
          f"{float(head.min())!r} head_max={float(head.max())!r}")
    if not (all(convs) and finite) or counts["plain_on_cuda"] \
            or counts["launches"] < 4 * inner_total:
        raise AssertionError("the rotated run failed its checks")
    return counts["launches"]


def picard_direct(model, delt, steps):
    """The model's steps on the CPU with a direct solve of each outer
    iteration's system (the matrix from ``to_scipy_csr``), iterated until
    the heads stand still."""
    import scipy.sparse.linalg as spla
    head = model.strt
    for _ in range(steps):
        ib, h = model.boundary_state(head)
        h_old = h
        for _ in range(50):
            diag, off, rhs = model.assemble(h, h_old, ib, delt, False)
            diag, off, rhs = apply_dirichlet(model.dtopo.nbr, torch.sign(ib),
                                             diag, off, rhs, h)
            new = torch.as_tensor(spla.spsolve(
                to_scipy_csr(model.dtopo, diag, off).tocsc(), rhs.numpy()))
            done = float((new - h).abs().max()) < 1e-10
            h = new
            if done:
                break
        head = h
    return head


def check_small_general(device):
    """A 2 x 24 x 24 brick DISV model and its DISU twin (staggered
    connections among them) with DRN, RIV, GHB, EVT and one barrier, CG:
    the card against the CPU (equal counts, 1e-10) and against direct
    solves of the same steps."""
    nlay, nrow, ncol = 2, 24, 24
    ncpl = nrow * ncol
    # cell bottoms that differ, so that staggered connections overlap less
    # than the cells' thickness
    botm = flagship_botm(nlay, ncpl) + np.random.default_rng(3).uniform(
        0.0, 5.0, (nlay, ncpl))
    brick = brick_disv(nlay, nrow, ncol, 10.0, 50.0, botm)
    args = brick_model_args(nlay, nrow, ncol)
    args["hfb"] = [(5 * ncol + 7, 5 * ncol + 8, 1e-3)]
    settings = ImsSettings(**ENTRY)
    for name, grid in (("disv", brick), ("disu", disu_of(brick))):
        cpu = build_gwf(name, grid, device="cpu", **args)
        gpu = build_gwf(name, grid, device=device, **args)
        hc, kc, ic, cc = make_fused_run(cpu, settings, False, 2)(
            cpu.strt, [5.0, 5.0])
        with counted_run() as counts:
            hg, kg, ig, cg_ = make_fused_run(gpu, settings, False, 2)(
                gpu.strt, [5.0, 5.0])
        err = float((hg.cpu() - hc).abs().max())
        direct = float((hg.cpu() - picard_direct(cpu, 5.0, 2)).abs().max())
        print(f"small general {name} brick(2,24,24) K={gpu.dtopo.max_degree} "
              f"packages+hfb: card outers={kg} inners={ig} "
              f"converged={all(cg_)}; cpu outers={kc} inners={ic}; "
              f"max|dh|={err!r} bar={CARD_CPU_ATOL!r} "
              f"max|h - direct|={direct!r} bar={DIRECT_ATOL!r} "
              f"stencil7_launches={counts['launches']}")
        if not (all(cg_) and all(cc) and (kg, ig) == (kc, ic)
                and err <= CARD_CPU_ATOL and direct <= DIRECT_ATOL
                and not counts["launches"]):
            raise AssertionError(f"small general model {name}: the card "
                                 "disagrees with the CPU or the direct solve")


# ------------------------------------------------------ properties phase

def totals(recs, seconds=None):
    """(inner_total, outers, inners, ms per inner iteration) of records."""
    inner = sum(r.inner for r in recs)
    seconds = sum(r.solve_seconds for r in recs) if seconds is None \
        else seconds
    return (inner, [r.outer for r in recs], [r.inner for r in recs],
            seconds / max(inner, 1) * 1e3)


def run_xt3d_bench(device, dis_head):
    """(a) The bench model in XT3D's full mode, without angles, through the
    fused run with BiCGSTAB (3 steps of 5.0).  On an orthogonal grid with
    cell-wise isotropic K XT3D reduces to the two-point scheme
    (tests/test_xt3d.py:40-58): its heads lie within CLOSURE_FACTOR x
    outer_dvclose of the structured run's (``dis_head``).  The system lives
    on the extended neighbour table, so no product goes through the stencil
    kernel.  Prints Ktot, the tables' bytes, the host build, the gather
    product at width Ktot beside its bound, and the run."""
    nlay, nrow, ncol = BENCH_SHAPE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_gwf("xt3d", flagship_grid(*BENCH_SHAPE), xt3d=1,
                      device=device, **flagship_args(*BENCH_SHAPE))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    d = model.xt3d
    ktot = d.nbr_ext.shape[1]
    print(f"xt3d bench grid: cells={model.nodes} edges={d.edge_n.shape[0]} "
          f"K={d.max_degree} Ktot={ktot} build_gwf_s={build_s!r} "
          f"extended_table_bytes={d.table_bytes} "
          f"cross_plan_rounds={len(d.cross_plan.rounds)} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    if model.use_structured or model.system_topo.nbr.shape[1] != ktot \
            or ktot != 23 or model.dtopo.grid_shape is not None:
        raise AssertionError("the XT3D model is not on the extended table")
    diag, off, rhs, h = first_system(model)
    mv = make_matvec(model.system_topo, diag, off)
    ms = back_to_back_ms(lambda: mv(h))
    bound = ell_bound_ms(model.nodes, ktot)
    print(f"ell product f64 cells={model.nodes} K={ktot}: ms={ms!r} (100 "
          f"products per event pair) bound_ms={bound!r} bound_by=bytes "
          f"bound_share={bound / ms!r}")
    del diag, off, rhs, h, mv
    settings = ImsSettings(**BENCH, linear_acceleration="bicgstab")
    run = make_fused_run(model, settings, iss=False, nsteps=3)
    torch.cuda.reset_peak_memory_stats()
    with counted_run() as counts:
        t0 = time.perf_counter()
        head, kiters, inners, convs = run(model.strt, [5.0] * 3)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    inner_total = sum(inners)
    err = float((head - dis_head).abs().max())
    bar = CLOSURE_FACTOR * BENCH["outer_dvclose"]
    print(f"xt3d bench full mode bicgstab f64 cells={model.nodes} steps=3 "
          f"inner_total={inner_total} inners={inners} outers={kiters} "
          f"converged={all(convs)} elapsed_s={elapsed!r} "
          f"ms_per_inner={elapsed / inner_total * 1e3!r} "
          f"stencil7_launches={counts['launches']} "
          f"max|h - h_structured|={err!r} bar={bar!r} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    if not (all(convs) and bool(torch.isfinite(head).all()) and err <= bar):
        raise AssertionError("the XT3D bench run failed its checks")
    if counts["launches"] or counts["plain_on_cuda"]:
        raise AssertionError("the XT3D run went through the stencil")


def flagship_grid(nlay, nrow, ncol):
    return DisGrid.create(nlay, nrow, ncol, delr=10.0, delc=10.0, top=50.0,
                          botm=flagship_botm(nlay, nrow * ncol).reshape(
                              nlay, nrow, ncol))


def flagship_args(nlay, nrow, ncol):
    """The keyword arguments of ``flagship`` but the grid and the device."""
    return dict(k=flagship_kfield(nlay, nrow, ncol), strt=40.0,
                storage={"ss": 1e-5, "iconvert": 0},
                **flagship_stresses(nrow, ncol))


def simulate(model, periods, settings, period_data=None, tvk=None,
             tvs=None):
    """A Simulation of ``model`` over ``periods`` [(perlen, nstp, tsmult)],
    run once with the kernel's launches counted; returns (simulation,
    records, seconds, counts)."""
    sim = Simulation(Tdis(tuple(StressPeriod(*p) for p in periods)), model,
                     settings)
    sim.period_data.update(period_data or {})
    sim.tvk, sim.tvs = tvk or {}, tvs or {}
    with counted_run() as counts:
        t0 = time.perf_counter()
        recs = sim.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return sim, recs, seconds, counts


def check_budget(label, sim, recs):
    disc = sim.budget.percent_discrepancy()
    if not (all(r.converged for r in recs) and np.isfinite(disc)
            and abs(disc) < BUDGET_PERCENT
            and all(np.isfinite(r.head).all() for r in recs)):
        raise AssertionError(f"{label}: not converged or budget "
                             f"discrepancy {disc}")
    return disc


def run_xt3d_rotated(device):
    """(b) XT3D on the field of ``rotated_model`` (K22 = 0.1 K, the ellipse
    rotated cell by cell; XT3D reads the angles in degrees), one transient
    step through ``Simulation`` in full mode, twice, and in RHS mode: the
    budget closes and the two full-mode runs are bitwise equal."""
    args = rotated_args(*BENCH_SHAPE)
    args["angle1"] = np.rad2deg(args["angle1"])
    settings = ImsSettings(**BENCH, linear_acceleration="bicgstab")
    for mode in (1, 2):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_gwf(f"xt3d{mode}", flagship_grid(*BENCH_SHAPE),
                          xt3d=mode, device=device, **args)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        heads = []
        for attempt in range(2 if mode == 1 else 1):
            sim, recs, seconds, counts = simulate(model, [(5.0, 1, 1.0)],
                                                  settings)
            disc = check_budget(f"xt3d rotated mode {mode}", sim, recs)
            heads.append(recs[-1].head)
            inner, outers, inners, ms = totals(recs)
            print(f"xt3d rotated mode={mode} "
                  f"({'full' if mode == 1 else 'rhs'}) cells={model.nodes} "
                  f"Ktot={model.system_topo.nbr.shape[1]} "
                  f"build_gwf_s={build_s!r} run={attempt} steps=1 "
                  f"inner_total={inner} outers={outers} run_s={seconds!r} "
                  f"ms_per_inner={ms!r} stencil7_launches="
                  f"{counts['launches']} budget_percent_discrepancy={disc!r} "
                  f"bar={BUDGET_PERCENT!r} "
                  f"head_min={float(recs[-1].head.min())!r} "
                  f"head_max={float(recs[-1].head.max())!r} "
                  f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
            if counts["launches"] or counts["plain_on_cuda"]:
                raise AssertionError("the XT3D run went through the stencil")
        if mode == 1:
            bitwise = bool(np.array_equal(heads[0], heads[1]))
            print(f"xt3d rotated full mode: two runs bitwise equal={bitwise}")
            if not bitwise:
                raise AssertionError("two XT3D runs on the card differ")
        del model, sim


def run_csub_tv(device):
    """(c) The bench model through ``Simulation`` over two periods of one
    step with CSUB no-delay interbeds in every cell of layers 2-4, delay
    interbeds in 1 of 16 cells of layer 3, TVK halving K on a block in
    period 2 and TVS doubling SS there: every step converged, the budget
    closed, the compaction finite and not decreasing, and the products
    through the stencil kernel.  Returns the launches."""
    nlay, nrow, ncol = BENCH_SHAPE
    ncpl = nrow * ncol
    cells = np.arange(ncpl, 4 * ncpl)
    layer3 = np.arange(2 * ncpl, 3 * ncpl)
    delay = layer3[(layer3 % 4 == 0) & ((layer3 // ncol) % 4 == 0)]
    csub_kw = dict(
        sgm=1.7, sgs=2.0, cg_ske_cr=1e-6, cg_theta=0.2, pcs_offset=0.0,
        interbeds=np.stack([cells, np.full(cells.size, 2.0),
                            np.full(cells.size, 1e-5),
                            np.full(cells.size, 1e-4),
                            np.full(cells.size, 0.3)], axis=1),
        delay_interbeds=[dict(node=int(n), thick=4.0, kv=1e-3, sske_cr=1e-5,
                              ssv_cc=1e-4, theta=0.3) for n in delay])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_gwf("csub", flagship_grid(*BENCH_SHAPE), device=device,
                      csub=csub_kw, **flagship_args(*BENCH_SHAPE))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    block = np.arange(nlay * ncpl).reshape(nlay, nrow, ncol)[
        :, nrow // 4:3 * nrow // 4, ncol // 4:3 * ncol // 4].reshape(-1)
    kfield = flagship_kfield(*BENCH_SHAPE)
    tvk = {2: [(int(n), "K", float(kfield[n]) * 0.5) for n in block]}
    tvs = {2: [(int(n), "SS", 2e-5) for n in block]}
    print(f"csub/tvk/tvs model: cells={model.nodes} "
          f"interbeds={model.csub.ib_node.shape[0]} delay_beds="
          f"{model.csub.delay.nbeds} ndelaycells={model.csub.delay.ncells} "
          f"tvk_block_cells={block.size} build_gwf_s={build_s!r} "
          f"is_linear={model.is_linear}")
    compaction = []
    sim = Simulation(Tdis((StressPeriod(5.0, 1, 1.0),) * 2), model,
                     ImsSettings(**BENCH))
    sim.tvk, sim.tvs = tvk, tvs
    do_step = sim.do_step

    def step_and_read_compaction(*args, **kwargs):
        head = do_step(*args, **kwargs)
        st = sim.csub_state
        compaction.append((float(st.comp.sum()), float(st.db_comp.sum()),
                           float(st.cg_comp.sum())))
        return head

    # Simulation.run drives the steps; the compaction is read after each
    sim.do_step = step_and_read_compaction
    with counted_run() as counts:
        t0 = time.perf_counter()
        recs = sim.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    disc = check_budget("csub/tvk/tvs", sim, recs)
    inner, outers, inners, ms = totals(recs)
    terms = {t.name: (t.rate_in, t.rate_out)
             for t in sim.budget.terms.values()}
    print(f"csub/tvk/tvs simulation cells={model.nodes} periods=2 "
          f"inner_total={inner} inners={inners} outers={outers} "
          f"run_s={seconds!r} ms_per_inner={ms!r} "
          f"stencil7_launches={counts['launches']} "
          f"budget_percent_discrepancy={disc!r} bar={BUDGET_PERCENT!r} "
          f"compaction(interbeds, delay beds, coarse) per step={compaction} "
          f"budget_in_out={terms} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    # the interbeds' compaction (no-delay and delay beds) accrues; the
    # coarse-grained skeleton expands elastically where heads rise
    total = [c[0] + c[1] for c in compaction]
    if not (np.isfinite(compaction).all() and total[0] > 0
            and all(b >= a for a, b in zip(total, total[1:]))
            and sim.model.npf_arrays.k11[int(block[0])] == 0.5 * kfield[
                int(block[0])]):
        raise AssertionError("csub/tvk/tvs run: compaction or TVK failed")
    if not counts["launches"] or counts["plain_on_cuda"] or "CSUB" not in terms:
        raise AssertionError("csub/tvk/tvs run: no stencil launch or no CSUB "
                             "term")
    return counts["launches"]


def wedge(nlay, nrow, ncol):
    """A seawater wedge: 35 at the sea side (the last columns), fresh (0)
    inland, the interface leaning landward with depth."""
    j = np.arange(ncol)[None, None, :] / ncol
    k = np.arange(nlay)[:, None, None] / max(nlay - 1, 1)
    conc = 35.0 * np.clip((j - 0.7 + 0.2 * k) * 8.0, 0.0, 1.0)
    return np.broadcast_to(conc, (nlay, nrow, ncol)).reshape(-1)


def run_buy_vsc(device):
    """(d) BUY and VSC on the bench grid with a fixed concentration,
    through ``NumericalSolution``: with a uniform concentration equal to
    crhoref every BUY term vanishes and the heads equal the plain run's bit
    for bit; with a seawater wedge (0-35) and VSC, one transient step
    through ``Simulation`` (``buy_conc`` in ``period_data``) converges and
    its budget closes.  Returns the launches of the three runs."""
    settings = ImsSettings(**BENCH, linear_acceleration="bicgstab")
    args = flagship_args(*BENCH_SHAPE)
    n = int(np.prod(BENCH_SHAPE))
    launches = 0
    heads = {}
    for name, buy in (("plain", None), ("buy uniform crhoref",
                                        dict(crhoref=35.0))):
        model = build_gwf(name, flagship_grid(*BENCH_SHAPE), buy=buy,
                          device=device, **args)
        pkgs = dataclasses.replace(model.packages, buy_conc=torch.full(
            (n,), 35.0, dtype=torch.float64, device=device))
        torch.cuda.reset_peak_memory_stats()
        with counted_run() as counts:
            t0 = time.perf_counter()
            h, info, _ = NumericalSolution(model, settings).solve_timestep(
                model.strt, 5.0, iss=False, pkgs=pkgs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        heads[name] = h
        launches += counts["launches"]
        print(f"buy {name}: cells={n} structured={model.use_structured} "
              f"outer={info.outer_iterations} inner={info.inner_iterations} "
              f"converged={info.converged} solve_s={seconds!r} ms_per_inner="
              f"{seconds / info.inner_iterations * 1e3!r} "
              f"stencil7_launches={counts['launches']} "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
        if not (info.converged and counts["launches"]
                and model.use_structured and not counts["plain_on_cuda"]):
            raise AssertionError(f"buy {name}: not converged or not through "
                                 "the stencil")
    bitwise = bool(torch.equal(heads["plain"], heads["buy uniform crhoref"]))
    print(f"buy uniform crhoref vs plain: heads bitwise equal={bitwise}")
    if not bitwise:
        raise AssertionError("BUY with conc = crhoref changed the heads")
    del heads
    torch.cuda.reset_peak_memory_stats()
    model = build_gwf("buy vsc wedge", flagship_grid(*BENCH_SHAPE),
                      buy=dict(denseref=1000.0, drhodc=0.7, crhoref=0.0),
                      vsc=dict(viscref=1.0, dviscdc=0.01),
                      device=device, **args)
    conc = torch.as_tensor(wedge(*BENCH_SHAPE), device=device)
    pkgs = dataclasses.replace(model.packages, buy_conc=conc)
    sim, recs, seconds, counts = simulate(model, [(5.0, 1, 1.0)], settings,
                                          period_data={1: pkgs})
    disc = check_budget("buy vsc wedge", sim, recs)
    inner, outers, inners, ms = totals(recs)
    print(f"buy+vsc wedge (conc 0-35): cells={n} structured="
          f"{model.use_structured} grid_shape={model.dtopo.grid_shape} "
          f"inner_total={inner} outers={outers} run_s={seconds!r} "
          f"ms_per_inner={ms!r} stencil7_launches={counts['launches']} "
          f"budget_percent_discrepancy={disc!r} bar={BUDGET_PERCENT!r} "
          f"head_min={float(recs[-1].head.min())!r} "
          f"head_max={float(recs[-1].head.max())!r} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    if not counts["launches"] or counts["plain_on_cuda"]:
        raise AssertionError("the BUY/VSC run went past the stencil kernel")
    return launches + counts["launches"]


def small_property_models(dev):
    """(name, model, settings, how, conc) of the small twins: ``how`` is
    "ims" (one steady NumericalSolution step, with ``conc`` as the BUY/VSC
    concentration) or the periods [(perlen, nstp, tsmult)] of a
    Simulation."""
    # BiCGSTAB at an inner closure these small systems reach without
    # stalling near rounding (where the card's and the CPU's sum orders
    # would decide the counts)
    bic = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-10,
               inner_rclose=1e-7, inner_maximum=600,
               linear_acceleration="bicgstab")
    # CG at closures that double precision reaches (ROADMAP Queue C: near
    # rounding the order of a sum decides the count)
    cg = dict(ENTRY)
    rng = np.random.default_rng(2)
    g = DisGrid.create(1, 8, 10, 10.0, 10.0, 20.0, np.zeros((1, 8, 10)))
    xkw = dict(k=np.exp(rng.normal(0, 0.5, 80)),
               k22=np.exp(rng.normal(0, 0.5, 80)) * 0.5, angle1=30.0,
               strt=15.0, chd=[(i * 10, 16.0) for i in range(8)]
               + [(i * 10 + 9, 12.0) for i in range(8)],
               wel=[(45, -20.0)], device=dev)
    out = [("xt3d full", build_gwf("x1", g, xt3d=1, **xkw), bic, "ims",
            None),
           ("xt3d rhs", build_gwf("x2", g, xt3d=2, **xkw), bic, "ims", None),
           ("xt3d newton", build_gwf("xn", g, xt3d=1, newton=True,
                                     icelltype=1, **xkw), bic, "ims", None)]
    # GNC across a refinement interface: two coarse cells beside 2x2 fine
    # cells, the ghost node weighted toward the other coarse cell
    conns = {0: [1, 2], 1: [0, 4], 2: [0, 3, 4], 3: [2, 5], 4: [1, 2, 5],
             5: [3, 4]}
    cl = {(0, 1): 1.0, (0, 2): 1.0, (1, 0): 1.0, (1, 4): 1.0, (2, 0): 0.5,
          (2, 3): 0.5, (2, 4): 0.5, (3, 2): 0.5, (3, 5): 0.5, (4, 1): 0.5,
          (4, 2): 0.5, (4, 5): 0.5, (5, 3): 0.5, (5, 4): 0.5}
    iac, ja, ihc, cl12, hwva = [], [], [], [], []
    for n_ in range(6):
        iac.append(1 + len(conns[n_]))
        ja += [n_] + conns[n_]
        ihc += [0] + [1] * len(conns[n_])
        cl12 += [0.0] + [cl[(n_, m_)] for m_ in conns[n_]]
        hwva += [0.0] + [2.0 if {n_, m_} == {0, 1} else 1.0
                         for m_ in conns[n_]]
    gu = DisuGrid.create(np.ones(6), np.zeros(6),
                         np.array([4.0, 4.0, 1.0, 1.0, 1.0, 1.0]), iac, ja,
                         ihc, cl12, hwva)
    gnc_model = build_gwf("gnc", gu, k=1.0, strt=3.0,
                          chd=[(0, 1.0), (1, 2.0), (3, 5.0), (5, 6.0)],
                          device=dev)
    gnc_model.gnc = build_gnc(gnc_model.topo, [(0, 2, [(1, 0.25)]),
                                               (1, 4, [(0, 0.25)])],
                              device=dev)
    out.append(("gnc", gnc_model, cg, "ims", None))
    # CSUB with delay beds, three layers, two transient steps
    g3 = DisGrid.create(3, 3, 4, 10.0, 10.0, 30.0,
                        np.array([20.0, 10.0, 0.0])[:, None, None]
                        * np.ones((3, 3, 4)))
    out.append(("csub delay beds", build_gwf(
        "cs", g3, k=5.0, strt=25.0, storage={"ss": 1e-5, "iconvert": 0},
        chd=[(0, 25.0)], wel=[(23, -3.0)], device=dev,
        csub=dict(interbeds=[(17, 3.0, 1e-4, 1e-2, 0.3),
                             (17, 2.0, 2e-4, 2e-2, 0.3)], pcs_offset=0.5,
                  ndelaycells=7,
                  delay_interbeds=[dict(node=21, thick=4.0, kv=0.01,
                                        sske_cr=1e-4, ssv_cc=1e-3,
                                        theta=0.3)])),
        cg, [(2.0, 2, 1.0)], None))
    out.append(("buy vsc", build_gwf(
        "bv", g3, k=5.0, strt=25.0, chd=[(0, 25.0)], wel=[(23, -3.0)],
        device=dev, buy=dict(denseref=1000.0, drhodc=0.7),
        vsc=dict(viscref=1.0, dviscdc=0.01)), bic, "ims",
        torch.as_tensor(wedge(3, 3, 4), device=dev)))
    tv_model = build_gwf("tv", DisGrid.create(1, 1, 9, 10.0, 10.0, 10.0,
                                              np.zeros((1, 1, 9))),
                         k=4.0, strt=5.0, chd=[(0, 8.0)], wel=[(8, -16.0)],
                         storage={"ss": 1e-3, "iconvert": 0}, device=dev)
    out.append(("tvk tvs", tv_model, cg, [(1.0, 1, 1.0), (1.0, 1, 1.0)],
                None))
    return out


def check_small_properties(device):
    """(e) Small twins on the card against the CPU: XT3D full, RHS and
    Newton, GNC, CSUB with delay beds, BUY with VSC, TVK/TVS.  CG models:
    equal counts and heads within 1e-10; BiCGSTAB models: the bars of
    ROADMAP Queue C (equal outer counts, inner counts within 25%, heads
    within 10 x outer_dvclose)."""
    def run(dev):
        out = {}
        for name, model, s, how, conc in small_property_models(dev):
            if how == "ims":
                pkgs = dataclasses.replace(model.packages, buy_conc=conc)
                h, info, _ = NumericalSolution(model, ImsSettings(
                    **s)).solve_timestep(model.strt, 1.0, iss=True,
                                         pkgs=pkgs)
                out[name] = (h.cpu(), [info.outer_iterations],
                             [info.inner_iterations], info.converged, s)
                continue
            sim = Simulation(Tdis(tuple(StressPeriod(*p) for p in how)),
                             model, ImsSettings(**s))
            if name == "tvk tvs":
                sim.tvk = {2: [(j, "K", 2.0) for j in range(9)]}
                sim.tvs = {2: [(j, "SS", 1e-5) for j in range(9)]}
            recs = sim.run()
            out[name] = (torch.as_tensor(recs[-1].head),
                         [r.outer for r in recs], [r.inner for r in recs],
                         all(r.converged for r in recs), s)
        return out

    cpu = run("cpu")
    card = run(device)
    for name, (h, k, i, c, s) in card.items():
        h0, k0, i0, c0, _ = cpu[name]
        err = float((h - h0).abs().max())
        bicgstab = s.get("linear_acceleration") == "bicgstab"
        bar = CLOSURE_FACTOR * s["outer_dvclose"] if bicgstab \
            else CARD_CPU_ATOL
        ok = c and c0 and k == k0 and err <= bar and (
            all(abs(a - b) <= 0.25 * b for a, b in zip(i, i0)) if bicgstab
            else i == i0)
        print(f"small {name}: card outers={k} inners={i} converged={c}; cpu "
              f"outers={k0} inners={i0}; max|dh|={err!r} bar={bar!r} "
              f"({'bicgstab' if bicgstab else 'cg'})")
        if not ok:
            raise AssertionError(f"small {name}: the card disagrees with the "
                                 "CPU")


def run_properties(device, dis_head):
    """The properties phase at 4x1024x1024: (a) XT3D on the bench model,
    (b) XT3D with rotated anisotropy in both modes, (c) CSUB with delay
    beds and TVK/TVS through Simulation, (d) BUY and VSC, (e) small twins
    on the card against the CPU.  Returns the launches of (c) and (d)."""
    run_xt3d_bench(device, dis_head)
    run_xt3d_rotated(device)
    launches = run_csub_tv(device)
    launches += run_buy_vsc(device)
    check_small_properties(device)
    return launches


# ------------------------------------------------------- advanced phase

def advanced_layout(nlay, nrow, ncol):
    """Where the MAW, LAK and SFR features of the ``advanced`` phase lie
    on the bench grid, by (row, column) of layer 1: a well every 32 cells
    from (16, 16), screened in every layer; a lake on the 3 x 3 patch round
    every 64th cell from (40, 40); two tributaries down whole columns, a
    main stem of twice their length down one column and up the next, and a
    side channel of nrow / 16 reaches fed by a diversion.  No cell holds
    two features."""
    wells = [(i, j) for i in range(16, nrow, 32) for j in range(16, ncol, 32)]
    lakes = [(i, j) for i in range(40, nrow, 64) for j in range(40, ncol, 64)]
    col = {name: ncol * c // 1024 for name, c in
           (("a", 300), ("b", 724), ("main", 500), ("side", 900))}
    trib_a = [(i, col["a"]) for i in range(nrow)]
    trib_b = [(i, col["b"]) for i in range(nrow)]
    main = [(i, col["main"]) for i in range(nrow)] + \
        [(i, col["main"] + 1) for i in reversed(range(nrow))]
    side = [(i, col["side"]) for i in range(nrow // 16)]
    cells = [(0, i, j) for i, j in trib_a + trib_b + main + side]
    cells += [(k, i, j) for i, j in wells for k in range(nlay)]
    cells += [(0, i + di, j + dj) for i, j in lakes for di in (-1, 0, 1)
              for dj in (-1, 0, 1)]
    if len(set(cells)) != len(cells):
        raise AssertionError("two features share a cell")
    return wells, lakes, trib_a + trib_b + main + side, len(trib_a), \
        len(main), len(side)


def advanced_features(grid, kfield):
    """(MAW, LAK, SFR) descriptions of the ``advanced`` phase, each a list
    of per-feature records that ``advanced_specs`` turns into the
    in-memory specs and ``write_advanced_files`` into MAW6/LAK6/SFR6/TAB6
    files; period 2 halves the wells' rates and raises the tributaries'
    inflow (pumping harder would draw the RATE_SCALING wells into their
    ramp, where Picard iterates jump across it: tests/test_advanced.py:311
    damps that case with DBD)."""
    nlay, nrow, ncol = grid.shape
    ncpl = nrow * ncol
    top, bot = grid.top, grid.bot
    wells, lakes, path, ntrib, nmain, nside = advanced_layout(nlay, nrow,
                                                              ncol)
    maw = []
    for w, (i, j) in enumerate(wells):
        conns = []
        for k in range(nlay):
            n = k * ncpl + i * ncol + j
            conns.append((n, float(top[n]), float(bot[n])))
        rec = dict(cell=(i, j), conns=conns, thiem=w % 2 == 1,
                   rate=-20.0, rate2=-10.0)
        if w % 8 in (0, 4):
            rec["head_limit"] = 36.0
        if w % 8 == 2:
            rec["rate_scaling"] = (30.0, 5.0)
        if w % 8 == 4:
            rec["shut_off"] = (0.5, 1.0)
        maw.append(rec)
    table = [(38.0 + z, 900.0 * z + 50.0 * z * z, 900.0 + 100.0 * z)
             for z in np.linspace(0.0, 6.0, 13).tolist()]
    lak = []
    for lk, (i, j) in enumerate(lakes):
        cells = [i * ncol + j + di * ncol + dj for di in (-1, 0, 1)
                 for dj in (-1, 0, 1)]
        lak.append(dict(cells=cells, strt=40.5, bedleak=0.01, belev=39.5,
                        table=table if lk % 2 == 0 else None,
                        rain=0.002, evap=0.001))
    outlets = []
    for lk in range(0, len(lakes) - 1, 2):
        outlets.append(dict(lake=lk, to=lk + 1, type="weir", invert=40.6,
                            width=1.0, rough=0.03, slope=1e-3))
        outlets.append(dict(lake=lk + 1, to=-1, type="manning",
                            invert=40.2, width=2.0, rough=0.03, slope=1e-3))
    xfrac = [0.0, 0.1, 0.25, 0.4, 0.6, 0.75, 0.9, 1.0]
    height = [3.0, 1.5, 0.5, 0.0, 0.0, 0.5, 1.5, 3.0]
    manfrac = [1.0, 1.2, 1.0, 1.0, 1.0, 1.0, 1.2, 1.0]
    sfr = []
    main0, side0 = 2 * ntrib, 2 * ntrib + nmain
    div_reach = main0 + nmain // 2
    for r, (i, j) in enumerate(path):
        # beds that fall 2 m along each tributary and along the main stem,
        # from above the initial heads (losing) to below them (gaining)
        if r < ntrib:
            strtop = 40.5 - 2.0 * r / ntrib
        elif r < main0:
            strtop = 40.3 - 2.0 * (r - ntrib) / ntrib
        elif r < side0:
            strtop = 38.3 - 2.0 * (r - main0) / nmain
        else:
            strtop = 38.3 - 2.0 * (div_reach - main0) / nmain - 0.1 \
                - 0.5 * (r - side0) / nside
        down = r + 1
        if r in (ntrib - 1, main0 - 1):
            down = main0
        if r in (side0 - 1, side0 + nside - 1):
            down = None
        rec = dict(node=i * ncol + j, strtop=strtop, down=down,
                   inflow=5.0 if r in (0, ntrib) else 0.0,
                   inflow2=6.0 if r in (0, ntrib) else 0.0)
        if main0 + 100 <= r < main0 + 100 + nside:
            rec["xsection"] = (xfrac, height, manfrac)
        if r == div_reach:
            rec["diversion"] = (side0, "upto", 2.0)
        sfr.append(rec)
    return maw, (lak, outlets), sfr


SFR_REACH = dict(rlen=10.0, rwid=5.0, rgrd=1e-3, rbth=1.0, rhk=0.1,
                 man=0.03)


def advanced_specs(features, grid, kfield):
    """The in-memory specs of build_maw, build_lak and build_sfr for
    ``advanced_features``, built as MF6 defines the deck's records (the
    loader's conventions: SFR strt = rtp + 0.1, lake area the sum of its
    vertical connections' cell areas, rainfall and evaporation rates times
    that area)."""
    maw, (lak, outlets), sfr = features
    area = grid.area
    wells = []
    for rec in maw:
        conns = []
        for n, ctop, cbot in rec["conns"]:
            conns.append((n, dict(condeqn="THIEM", scrn_top=ctop,
                                  scrn_bot=cbot, hk_skin=1.0,
                                  radius_skin=0.2) if rec["thiem"]
                          else 50.0))
        w = dict(radius=0.1, bottom=-50.0, strt=40.0, rate=rec["rate"],
                 connections=conns)
        if "head_limit" in rec:
            w["head_limit"] = rec["head_limit"]
        if "rate_scaling" in rec:
            w["pumpelev"], w["reduction_length"] = rec["rate_scaling"]
        if "shut_off" in rec:
            w["shut_off"] = rec["shut_off"]
        wells.append(w)
    lakes = []
    for rec in lak:
        sa = 0.0
        conns = []
        for n in rec["cells"]:
            conns.append((n, rec["bedleak"] * area[n], rec["belev"],
                          rec["belev"], 0))
            sa += area[n]
        spec = dict(strt=rec["strt"], surf_area=sa, connections=conns,
                    rainfall=rec["rain"] * sa, evap=rec["evap"] * sa)
        if rec["table"] is not None:
            spec["table"] = [tuple(row) for row in rec["table"]]
        lakes.append(spec)
    p = SFR_REACH
    reaches = [dict(node=rec["node"], strtop=rec["strtop"], width=p["rwid"],
                    rough=p["man"], slope=p["rgrd"], length=p["rlen"],
                    cond=p["rhk"] * p["rwid"] * p["rlen"] / p["rbth"],
                    strt=rec["strtop"] + 0.1, inflow=rec["inflow"],
                    upstream=[], diversions=[]) for rec in sfr]
    for u, rec in enumerate(sfr):
        if rec["down"] is not None:
            reaches[rec["down"]]["upstream"].append((u, 1.0))
        if "xsection" in rec:
            xf, ht, mf = rec["xsection"]
            reaches[u]["xsection"] = (np.asarray(xf), np.asarray(ht),
                                      np.asarray(mf[:-1]))
        if "diversion" in rec:
            to, rule, flow = rec["diversion"]
            reaches[u]["diversions"].append(dict(to=to, cprior=rule,
                                                 flow=flow))
    return (build_maw(wells, grid, k11=kfield),
            build_lak(lakes, outlets), build_sfr(reaches))


def write_advanced_files(ws, features, grid):
    """MAW6, LAK6 (with TAB6 tables), SFR6 (with its cross sections' TAB6
    files) of ``advanced_features``; PERIOD 2 changes the wells' rates and
    the tributaries' inflow.  Returns the name-file lines."""
    maw, (lak, outlets), sfr = features
    _, nrow, ncol = grid.shape
    ncpl = nrow * ncol

    def cellid(n):
        k, rest = divmod(n, ncpl)
        i, j = divmod(rest, ncol)
        return f"{k + 1} {i + 1} {j + 1}"

    nconn = len(maw[0]["conns"])
    pdata, cdata, per1, per2 = [], [], [], []
    for w, rec in enumerate(maw, 1):
        pdata.append(f"  {w} 0.1 -50.0 40.0 "
                     f"{'THIEM' if rec['thiem'] else 'SPECIFIED'} {nconn}")
        for c, (n, ctop, cbot) in enumerate(rec["conns"], 1):
            hk = "1.0 0.2" if rec["thiem"] else "50.0 0.0"
            cdata.append(f"  {w} {c} {cellid(n)} {ctop!r} {cbot!r} {hk}")
        per1.append(f"  {w} RATE {rec['rate']!r}")
        per2.append(f"  {w} RATE {rec['rate2']!r}")
        if "head_limit" in rec:
            per1.append(f"  {w} HEAD_LIMIT {rec['head_limit']!r}")
        if "rate_scaling" in rec:
            per1.append(f"  {w} RATE_SCALING {rec['rate_scaling'][0]!r} "
                        f"{rec['rate_scaling'][1]!r}")
        if "shut_off" in rec:
            per1.append(f"  {w} SHUT_OFF {rec['shut_off'][0]!r} "
                        f"{rec['shut_off'][1]!r}")
    _write(ws, "m.maw", f"""BEGIN DIMENSIONS
  NMAWWELLS {len(maw)}
END DIMENSIONS
BEGIN PACKAGEDATA
""" + "\n".join(pdata) + "\nEND PACKAGEDATA\nBEGIN CONNECTIONDATA\n"
           + "\n".join(cdata) + "\nEND CONNECTIONDATA\nBEGIN PERIOD 1\n"
           + "\n".join(per1) + "\nEND PERIOD\nBEGIN PERIOD 2\n"
           + "\n".join(per2) + "\nEND PERIOD\n")

    tables = [lk for lk, rec in enumerate(lak) if rec["table"] is not None]
    lines = [f"BEGIN DIMENSIONS\n  NLAKES {len(lak)}\n  NOUTLETS "
             f"{len(outlets)}\n  NTABLES {len(tables)}\nEND DIMENSIONS",
             "BEGIN PACKAGEDATA"]
    lines += [f"  {lk} {rec['strt']!r} {len(rec['cells'])}"
              for lk, rec in enumerate(lak, 1)]
    lines.append("END PACKAGEDATA\nBEGIN CONNECTIONDATA")
    for lk, rec in enumerate(lak, 1):
        for c, n in enumerate(rec["cells"], 1):
            lines.append(f"  {lk} {c} {cellid(n)} VERTICAL "
                         f"{rec['bedleak']!r} {rec['belev']!r} "
                         f"{rec['belev']!r} 0.0 0.0")
    lines.append("END CONNECTIONDATA\nBEGIN TABLES")
    for lk in tables:
        lines.append(f"  {lk + 1} TAB6 FILEIN lake{lk + 1}.tab")
        _write(ws, f"lake{lk + 1}.tab", "BEGIN DIMENSIONS\n  NROW "
               f"{len(lak[lk]['table'])}\n  NCOL 3\nEND DIMENSIONS\n"
               "BEGIN TABLE\n" + "".join(
                   f"  {s!r} {v!r} {a!r}\n" for s, v, a in lak[lk]["table"])
               + "END TABLE\n")
    lines.append("END TABLES\nBEGIN OUTLETS")
    for o, rec in enumerate(outlets, 1):
        lines.append(f"  {o} {rec['lake'] + 1} {rec['to'] + 1} "
                     f"{rec['type'].upper()} {rec['invert']!r} "
                     f"{rec['width']!r} {rec['rough']!r} {rec['slope']!r}")
    lines.append("END OUTLETS\nBEGIN PERIOD 1")
    for lk, rec in enumerate(lak, 1):
        lines.append(f"  {lk} RAINFALL {rec['rain']!r}")
        lines.append(f"  {lk} EVAPORATION {rec['evap']!r}")
    lines.append("END PERIOD")
    _write(ws, "m.lak", "\n".join(lines) + "\n")

    p = SFR_REACH
    ups = {r: [] for r in range(len(sfr))}
    for u, rec in enumerate(sfr):
        if rec["down"] is not None:
            ups[rec["down"]].append(u)
    lines = [f"BEGIN DIMENSIONS\n  NREACHES {len(sfr)}\nEND DIMENSIONS",
             "BEGIN PACKAGEDATA"]
    for r, rec in enumerate(sfr):
        ncon = len(ups[r]) + (rec["down"] is not None)
        lines.append(f"  {r + 1} {cellid(rec['node'])} {p['rlen']!r} "
                     f"{p['rwid']!r} {p['rgrd']!r} {rec['strtop']!r} "
                     f"{p['rbth']!r} {p['rhk']!r} {p['man']!r} {ncon} 1.0 "
                     f"{int('diversion' in rec)}")
    lines.append("END PACKAGEDATA\nBEGIN CONNECTIONDATA")
    for r, rec in enumerate(sfr):
        conn = [str(u + 1) for u in ups[r]]
        if rec["down"] is not None:
            conn.append(str(-(rec["down"] + 1)))
        lines.append(f"  {r + 1} " + " ".join(conn))
    lines.append("END CONNECTIONDATA\nBEGIN CROSSSECTIONS")
    for r, rec in enumerate(sfr):
        if "xsection" in rec:
            lines.append(f"  {r + 1} TAB6 FILEIN xs{r + 1}.tab")
            rows = list(zip(*rec["xsection"]))
            _write(ws, f"xs{r + 1}.tab", "BEGIN DIMENSIONS\n  NROW "
                   f"{len(rows)}\n  NCOL 3\nEND DIMENSIONS\nBEGIN TABLE\n"
                   + "".join(f"  {a!r} {b!r} {c!r}\n" for a, b, c in rows)
                   + "END TABLE\n")
    lines.append("END CROSSSECTIONS\nBEGIN DIVERSIONS")
    per1, per2 = [], []
    for r, rec in enumerate(sfr):
        if "diversion" in rec:
            to, rule, flow = rec["diversion"]
            lines.append(f"  {r + 1} 1 {to + 1} {rule.upper()}")
            per1.append(f"  {r + 1} DIVERSION 1 {flow!r}")
        if rec["inflow"]:
            per1.append(f"  {r + 1} INFLOW {rec['inflow']!r}")
            per2.append(f"  {r + 1} INFLOW {rec['inflow2']!r}")
    lines.append("END DIVERSIONS\nBEGIN PERIOD 1")
    lines += per1
    lines.append("END PERIOD\nBEGIN PERIOD 2")
    lines += per2
    lines.append("END PERIOD")
    _write(ws, "m.sfr", "\n".join(lines) + "\n")
    return ["MAW6 m.maw", "LAK6 m.lak", "SFR6 m.sfr"]


def advanced_model(device, shape):
    """The bench model with the features of ``advanced_features`` as an
    ``AugmentedGwfModel`` on ``device``.  Returns (model, seconds of
    ``_build_ext_table``, seconds of the whole build)."""
    grid, kfield = flagship_grid(*shape), flagship_kfield(*shape)
    t0 = time.perf_counter()
    base = build_gwf("flagship", grid, device=device, **flagship_args(*shape))
    features = advanced_features(grid, kfield)
    maw, lak, sfr = advanced_specs(features, grid, kfield)
    table_s = []
    build_table = advanced._build_ext_table

    def timed(*args):
        t = time.perf_counter()
        out = build_table(*args)
        table_s.append(time.perf_counter() - t)
        return out

    advanced._build_ext_table = timed
    try:
        model = AugmentedGwfModel(base, maw=maw, lak=lak, sfr=sfr)
    finally:
        advanced._build_ext_table = build_table
    if device != "cpu":
        torch.cuda.synchronize()
    return model, table_s[0], time.perf_counter() - t0


def feature_balances(model, x, x_old, delt):
    """The largest relative imbalance of any lake and of any reach at the
    step from x_old to x: the sum of a feature's terms (rain, evaporation,
    withdrawal, the aquifer exchange, outlet flows out and in, storage; a
    reach's external terms, routed and diverted inflow, outflow and
    exchange) over the sum of their sizes."""
    bud = {k: v.cpu().numpy() for k, v in model.advanced_budget(
        x, x_old, delt, False).items()}
    lak = model.lak
    L = lak.nlakes
    terms = [bud["LAK-RAIN"], bud["LAK-EVAP"], bud["LAK-WDRL"], bud["LAK-STO"]]
    gwf = np.zeros(L)
    np.add.at(gwf, lak.conn_lake.cpu().numpy(), -bud["LAK-GWF"])
    out_src, out_dst = np.zeros(L), np.zeros(L)
    np.add.at(out_src, np.asarray(lak.out_lake), bud["LAK-OUT"])
    dst = np.asarray(lak.out_to)
    np.add.at(out_dst, dst[dst >= 0], -bud["LAK-OUT"][dst >= 0])
    terms += [gwf, out_src, out_dst]
    lake = _relative(terms)
    sfr = model.sfr
    stage = x[model._sfr_offset:model._sfr_offset + sfr.nreaches]
    q, _ = sfr._manning(stage)
    q_route, div_in = sfr.routing(q)
    routed = (q_route[sfr.upstream] * sfr.frac).sum(dim=1).cpu().numpy()
    terms = [bud["SFR-EXT"], routed, div_in.cpu().numpy(), bud["SFR-OUT"],
             -bud["SFR-GWF"]]
    return float(lake.max()), float(_relative(terms).max())


def _relative(terms):
    """|Σ terms| / Σ |terms| per feature, over the features whose Σ |terms|
    exceeds 1e-6 of the largest one's (a dry reach carries flows at the
    rounding level, which no balance can hold)."""
    size = sum(np.abs(t) for t in terms)
    return np.divide(np.abs(sum(terms)), size, out=np.zeros_like(size),
                     where=size > 1e-6 * size.max())


def advanced_settings():
    return ImsSettings(**BENCH, linear_acceleration="bicgstab")


def run_advanced_memory(device, shape=BENCH_SHAPE):
    """(a) The bench model with 1024 wells, 256 lakes and 4160 reaches
    through ``Simulation`` (3 transient steps of 5.0, BiCGSTAB, Jacobi,
    ``f64``); (b) the same run again, bitwise equal; (d) the gather product
    at width Ktot.  Returns (records of (a), the stencil7 launches of (a)
    and (b))."""
    torch.cuda.reset_peak_memory_stats()
    model, table_s, build_s = advanced_model(device, shape)
    N, R, ktot = model.n_grid, model.n_extra, model.Ktot
    nbr_bytes = model.dtopo.nbr.numel() * model.dtopo.nbr.element_size()
    print(f"advanced model: cells={N} feature_rows={R} (wells="
          f"{model.maw.nwells} lakes={model.lak.nlakes} outlets="
          f"{len(model.lak.out_type)} reaches={model.sfr.nreaches}) "
          f"rows={N + R} Kb={model.Kb} Ktot={ktot} table_bytes={nbr_bytes} "
          f"off_bytes={(N + R) * ktot * 8} build_ext_table_s={table_s!r} "
          f"build_s={build_s!r} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    if model.use_structured or model.dtopo.grid_shape is not None:
        raise AssertionError("the augmented model has a grid shape")
    maw0 = model.maw
    runs, launches = [], 0
    for label in ("a", "b"):
        model.maw = maw0
        torch.cuda.reset_peak_memory_stats()
        sim, recs, seconds, counts = simulate(model, [(15.0, 3, 1.0)],
                                              advanced_settings())
        disc = check_budget(f"advanced ({label})", sim, recs)
        inner, outers, inners, ms = totals(recs, seconds)
        x = torch.as_tensor(recs[-1].head, device=device)
        x_old = torch.as_tensor(recs[-2].head, device=device)
        lake, reach = feature_balances(model, x, x_old, 5.0)
        table = recs[-1].budget_table.splitlines()
        terms = {line.split()[0]: line.split()[1:3] for line in table
                 if line.split()[:1] in (["MAW"], ["LAK"], ["SFR"])}
        print(f"advanced ({label}) Simulation bicgstab f64 rows={N + R} "
              f"steps=3 inner_total={inner} outers={outers} inners={inners} "
              f"converged={all(r.converged for r in recs)} seconds={seconds!r} "
              f"ms_per_inner={ms!r} stencil7_launches={counts['launches']} "
              f"budget_percent_discrepancy={disc!r} "
              f"feature_rates_in_out={terms} "
              f"max_lake_imbalance={lake!r} max_reach_imbalance={reach!r} "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
        launches += counts["launches"]
        if counts["launches"] or counts["plain_on_cuda"]:
            raise AssertionError("the augmented run went through the "
                                 "stencil")
        if not all(np.isfinite(r.head).all() and r.head.shape == (N + R,)
                   for r in recs):
            raise AssertionError("the augmented run's heads")
        runs.append(recs)
    same = all(np.array_equal(p.head, q.head) for p, q in zip(*runs))
    counts_same = [(r.outer, r.inner) for r in runs[0]] == [
        (r.outer, r.inner) for r in runs[1]]
    print(f"advanced (b) vs (a): heads and feature rows bitwise equal="
          f"{same} counts equal={counts_same}")
    if not (same and counts_same):
        raise AssertionError("two card runs of the augmented model differ")
    model.maw = maw0
    diag, off, rhs, h = first_system(model)
    mv = make_matvec(model.system_topo, diag, off)
    ms = back_to_back_ms(lambda: mv(h))
    plain = back_to_back_ms(lambda: spmv(model.dtopo.nbr, diag, off, h))
    bound = ell_bound_ms(N + R, ktot)
    print(f"ell product f64 rows={N + R} K={ktot}: ms={ms!r} (100 products "
          f"per event pair; spmv called directly: {plain!r}) "
          f"bound_ms={bound!r} bound_by=bytes bound_share={bound / ms!r}")
    return runs[0], launches


def run_advanced_deck(device, memory_recs, shape=BENCH_SHAPE):
    """(c) The model of (a) written as a deck (MAW6, LAK6 with TAB6 tables,
    SFR6 with cross-section TAB6 files), with a PERIOD 2 block of one step
    that changes the wells' rates and the tributaries' inflow, run through
    the command-line entry: period 1 has (a)'s counts and heads within
    DECK_FUSED_ATOL, period 2 converges with its budget closed.  Returns
    the run's stencil7 launches."""
    from modflow6_torch.utils.mf6io import loader as loader_mod
    nlay, nrow, ncol = shape
    grid = flagship_grid(*shape)
    with tempfile.TemporaryDirectory() as ws:
        t0 = time.perf_counter()
        files = write_advanced_files(ws, advanced_features(
            grid, flagship_kfield(*shape)), grid)
        write_flagship_deck(ws, nlay, nrow, ncol, acc="BICGSTAB",
                            tdis=[(15.0, 3, 1.0), (5.0, 1, 1.0)],
                            extra_packages=files,
                            oc_extra="  PRINT BUDGET ALL\n")
        print(f"advanced deck written in {time.perf_counter() - t0:.2f} s: "
              f"{len(os.listdir(ws))} files")
        builds = []
        augmented = loader_mod._augmented

        def timed(*args):
            t = time.perf_counter()
            model = augmented(*args)
            torch.cuda.synchronize()
            builds.append(time.perf_counter() - t)
            return model

        loader_mod._augmented = timed
        lst = os.path.join(ws, "cli.lst")
        out = io.StringIO()
        try:
            with counted_run() as counts, contextlib.redirect_stdout(out):
                t0 = time.perf_counter()
                code = cli_main([ws, "--lst", lst])
                torch.cuda.synchronize()
                cli_s = time.perf_counter() - t0
        finally:
            loader_mod._augmented = augmented
        cli_counts = listing_counts(lst)
        discs = [float(v) for v in re.findall(
            r"PERCENT DISCREPANCY:\s*(\S+)", open(lst).read())]
        layers = read_head_file(os.path.join(ws, "m.hds"))
        saved = {}
        for rec in layers:
            saved.setdefault((rec["kper"], rec["kstp"]), []).append(
                rec["data"])
        N = nlay * nrow * ncol
        err = float(np.abs(np.stack(saved[(1, 3)]).reshape(-1)
                           - memory_recs[-1].head[:N]).max())
        want = [(r.outer, r.inner) for r in memory_recs]
        print(f"advanced (c) deck cli exit={code} wall_s={cli_s!r} "
              f"counts={cli_counts} (a)={want} "
              f"build_s={builds[0]!r} period2_rebuild_s={builds[1:]!r} "
              f"budget_percent_discrepancy_per_step={discs} "
              f"max|h_period1 - h_(a)|={err!r} bar={DECK_FUSED_ATOL!r} "
              f"stencil7_launches={counts['launches']} "
              f"saved={sorted(saved)} "
              f"stdout={out.getvalue().strip()!r}")
        if code != 0 or "Normal termination of simulation" not in \
                out.getvalue():
            raise AssertionError("the advanced deck did not end normally")
        if cli_counts[:3] != want or len(cli_counts) != 4:
            raise AssertionError("the deck's period-1 counts differ from "
                                 "(a)'s")
        if not (err <= DECK_FUSED_ATOL and len(builds) == 2
                and len(discs) == 4 and abs(discs[-1]) < BUDGET_PERCENT):
            raise AssertionError("the advanced deck failed its checks")
        if counts["launches"] or counts["plain_on_cuda"]:
            raise AssertionError("the advanced deck went through the "
                                 "stencil")
    return counts["launches"]


def small_advanced_models(dev):
    """(name, model, settings, steps) of the small augmented twins:
    ``steps`` [(delt, iss)] of NumericalSolution, or "sim" for a
    Simulation over three periods with a falling and rising boundary."""
    bic = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-10,
               inner_rclose=1e-7, inner_maximum=600,
               linear_acceleration="bicgstab")
    cg = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-10,
              inner_rclose=1e-9, inner_maximum=600)
    g = DisGrid.create(1, 1, 6, 100.0, 100.0, 50.0, np.zeros((1, 1, 6)))
    chd = dict(chd=[(0, 40.0), (5, 40.0)])
    out = []

    def aug(name, base_kw, settings, steps, maw=None, lak=None, sfr=None,
            grid=g):
        base = build_gwf(name, grid, device=dev, **base_kw)
        out.append((name, AugmentedGwfModel(
            base, maw=None if maw is None else build_maw(maw, grid),
            lak=None if lak is None else build_lak(*lak),
            sfr=None if sfr is None else build_sfr(sfr)), settings, steps))

    base = dict(k=10.0, strt=40.0, **chd)
    # the rate-scaling ramp needs damping (tests/test_advanced.py:311)
    dbd = dict(bic, under_relaxation="dbd", theta=0.7, akappa=1e-3,
               gamma=0.0, amomentum=0.0)
    aug("maw limits", base, dbd, [(1.0, True)], maw=[
        dict(radius=0.25, strt=40.0, rate=-500.0, head_limit=35.0,
             connections=[(1, 25.0)]),
        dict(radius=0.25, strt=40.0, rate=-300.0, pumpelev=30.0,
             reduction_length=8.0, connections=[(3, 25.0)]),
        dict(radius=0.25, strt=45.0, rate=0.0, connections=[(4, 25.0)],
             flowing=dict(elev=39.0, cond=5.0, rlen=0.5))])
    aug("maw shut-off", dict(k=20.0, strt=30.0, chd=[(0, 30.0), (5, 30.0)],
                             storage={"ss": 1e-5, "iconvert": 0}), bic,
        "sim", maw=[dict(radius=0.3, strt=30.0, rate=-100.0,
                         head_limit=25.0, shut_off=(40.0, 60.0),
                         connections=[(2, 10.0)])])
    table = [(30.0 + z, 1e4 * z + 500.0 * z * z, 1e4 + 1000.0 * z)
             for z in np.linspace(0.0, 6.0, 13)]
    aug("lak table cascade", dict(base, k=5.0), bic, [(2e4, False)] * 3,
        lak=([dict(strt=32.2, bottom=30.0, surf_area=5e3, rainfall=3.0,
                   table=table, connections=[(1, 1e-3, 30.0)]),
              dict(strt=25.3, bottom=24.0, surf_area=5e3,
                   connections=[(2, 1e-3, 24.0),
                                (3, 40.0, 28.0, 36.0, 1)])],
             [dict(lake=0, to=1, type="weir", invert=32.0, width=3.0),
              dict(lake=1, to=-1, type="manning", invert=25.0, width=2.0,
                   rough=0.03, slope=1e-3)]))
    common = dict(cond=0.5, width=3.0, rough=0.03, slope=1e-3, length=100.0)
    aug("sfr diversions", dict(base, k=5.0), bic, [(1e4, False)] * 3, sfr=[
        dict(node=1, strtop=41.0, strt=41.4, inflow=6.0, diversions=[
            dict(to=2, cprior="upto", flow=1.0),
            dict(to=3, cprior="fraction", flow=0.2),
            dict(to=4, cprior="threshold", flow=0.5),
            dict(to=5, cprior="excess", flow=2.0)], **common),
        dict(node=2, strtop=40.9, strt=41.2, upstream=[(0, 1.0)],
             xsection=([0.0, 0.2, 0.5, 0.8, 1.0], [2.0, 0.5, 0.0, 0.5, 2.0]),
             **common),
        dict(node=3, strtop=40.8, strt=41.1, **common),
        dict(node=4, strtop=40.8, strt=41.1, **common),
        dict(node=5, strtop=40.8, strt=41.1, **common),
        dict(node=0, strtop=40.8, strt=41.1, upstream=[(1, 1.0), (2, 1.0)],
             **common)])
    g2 = DisGrid.create(1, 8, 10, 10.0, 10.0, 20.0, np.zeros((1, 8, 10)))
    aug("newton maw nur", dict(k=5.0, strt=15.0, icelltype=1,
                               newton="under_relaxation",
                               chd=[(i * 10, 16.0) for i in range(8)]),
        dict(bic, outer_maximum=300, inner_maximum=2000), [(1.0, True)],
        maw=[dict(radius=0.3, strt=15.0, rate=-40.0,
                  connections=[(36, 80.0)])], grid=g2)
    return out


def c1_twin(dev):
    """Two wells in one cell and a river cellid given twice, beside two
    MAW wells screened in one cell: every repeated sum in one model."""
    g = DisGrid.create(2, 4, 5, 10.0, 10.0, 20.0,
                       np.stack([np.full((4, 5), 10.0), np.zeros((4, 5))]))
    base = build_gwf("c1", g, k=2.0, strt=15.0, device=dev,
                     storage={"ss": 1e-5, "iconvert": 0},
                     chd=[(0, 16.0), (19, 14.0)],
                     wel=[(7, -1.5), (7, -2.25), (12, 0.5), (7, -0.125)],
                     riv=[(13, 15.5, 0.7, 14.0), (13, 15.25, 0.3, 14.0)])
    maw = build_maw([dict(radius=0.2, strt=15.0, rate=-3.0,
                          connections=[(8, 2.0), (28, 1.5)]),
                     dict(radius=0.2, strt=15.0, rate=-1.0,
                          connections=[(8, 1.0)])], g)
    return AugmentedGwfModel(base, maw=maw)


def check_small_advanced(device):
    """(e) Small augmented twins on the card against the CPU: MAW with
    HEAD_LIMIT, RATE_SCALING, a flowing well and SHUT_OFF; a LAK table with
    a weir cascade and a horizontal connection; SFR's four diversion rules
    and an n-point section; Newton with MAW and the under-relaxation
    (BiCGSTAB: the bars of ROADMAP Queue C, equal outer counts and heads
    within 10 x outer_dvclose).  And the C1 twin (CG): two runs on the card
    bitwise equal, equal counts on the CPU and heads within 1e-12 there."""
    def run(dev):
        out = {}
        for name, model, s, steps in small_advanced_models(dev):
            if steps == "sim":
                periods = [(50.0, 3, 1.0)] * 3
                sim = Simulation(Tdis(tuple(StressPeriod(*p)
                                            for p in periods)),
                                 model, ImsSettings(**s))
                for kper, h in ((2, 27.0), (3, 32.0)):
                    sim.period_data[kper] = PackageData(chd=chd_data(
                        [(0, h), (5, h)], device=dev))
                recs = sim.run()
                out[name] = (torch.as_tensor(recs[-1].head),
                             [r.outer for r in recs],
                             all(r.converged for r in recs), s)
                continue
            sol = NumericalSolution(model, ImsSettings(**s))
            x, outers, conv = model.strt, [], True
            for kstp, (delt, iss) in enumerate(steps, 1):
                x, info, _ = sol.solve_timestep(x, delt, kstp=kstp, iss=iss)
                outers.append(info.outer_iterations)
                conv = conv and info.converged
            out[name] = (x.cpu(), outers, conv, s)
        return out

    cpu, card = run("cpu"), run(device)
    for name, (h, k, c, s) in card.items():
        h0, k0, c0, _ = cpu[name]
        err = float((h - h0).abs().max())
        bar = CLOSURE_FACTOR * s["outer_dvclose"]
        print(f"small {name}: card outers={k} converged={c}; cpu outers={k0}"
              f" converged={c0}; max|dx|={err!r} bar={bar!r} (bicgstab)")
        if not (c and c0 and k == k0 and err <= bar):
            raise AssertionError(f"small {name}: the card disagrees with "
                                 "the CPU")
    settings = ImsSettings(**dict(TIGHT, inner_maximum=600))
    out = []
    for dev in ("cpu", device, device):
        model = c1_twin(dev)
        sim = Simulation(Tdis((StressPeriod(2.0, 2, 1.0),)), model,
                         settings)
        recs = sim.run()
        out.append(([(r.outer, r.inner) for r in recs], recs[-1].head,
                    all(r.converged for r in recs)))
    (kc, hc, cc), (k1, h1, c1), (k2, h2, c2) = out
    err = float(np.abs(h1 - hc).max())
    print(f"small c1 twin (two wells in one cell, a repeated river cellid, "
          f"two MAW wells in one cell; cg): card counts={k1} cpu counts={kc}"
          f" card runs bitwise equal={np.array_equal(h1, h2)} "
          f"max|dx| card-cpu={err!r} bar=1e-12")
    if not (cc and c1 and c2 and k1 == kc == k2 and np.array_equal(h1, h2)
            and err <= 1e-12):
        raise AssertionError("the C1 twin failed its checks")


def run_advanced(device, shape=BENCH_SHAPE):
    """The advanced phase: (a)-(b) and (d) at 4x1024x1024, (c) the deck,
    (e) the small twins.  Returns the stencil7 launches of (a)-(c), which
    must be none: an augmented model has no grid shape."""
    recs, launches = run_advanced_memory(device, shape)
    launches += run_advanced_deck(device, recs, shape)
    check_small_advanced(device)
    return launches


# ----------------------------------------------------------------- coupling

def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device):
    return (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)


# the UZF columns of the coupling phase: one per top cell, land surface
# (LANDFLAG) at the top less SURFDEP, the cell's bottom the layer-1 bottom
UZF_SURFDEP = 1.0
UZF_FLAGS = dict(nz=20, ietflag=1, iseepflag=1, igwetflag=1)


def uzf_columns(shape):
    """Column arrays of ``make_uzf`` for every top cell of the bench grid:
    vks lognormal from the seed, clipped to [0.01, 1.0] (its largest value
    sets the sub-step count: vks·eps/(θs−θr)·delt/dz·1.05 ≈ 25 at 1.0),
    finf 1e-4, pet 2e-4, extinction 12 m below land surface."""
    nlay, nrow, ncol = shape
    n = nrow * ncol
    rng = np.random.default_rng(2031)
    grid = flagship_grid(*shape)
    return dict(
        node=np.arange(n), vks=np.clip(rng.lognormal(np.log(0.02), 1.0, n),
                                       0.01, 1.0),
        thtr=np.full(n, 0.05), thts=np.full(n, 0.35), thti=np.full(n, 0.15),
        eps=np.full(n, 3.5), celtop=grid.top[:n] - UZF_SURFDEP,
        celbot=grid.bot[:n], surfdep=np.full(n, UZF_SURFDEP),
        area=grid.area[:n], finf=np.full(n, 1e-4), pet=np.full(n, 2e-4),
        extdp=np.full(n, 12.0), extwc=np.full(n, 0.05))


# the water table under the UZF columns needs a specific yield: in the
# confined bench model (storage ss·b ≈ 7e-4) the march's uz_rise release
# (θ − θr per metre of water-table rise) raises the head more than the rise
# that released it, and the package-convergence passes diverge (on the CPU
# at 4 x 128 x 128: 50 outer iterations a step, a 26 % budget error);
# with SY 0.2 each pass gives back half the rise before
UZF_STORAGE = dict(ss=1e-5, sy=0.2, iconvert=1)


def uzf_base(device, shape):
    """The bench model with convertible cells (ICELLTYPE 1, SY 0.2) and
    without its recharge, which the UZF columns replace."""
    args = flagship_args(*shape)
    del args["rch"]
    args.update(icelltype=1, storage=UZF_STORAGE)
    return build_gwf("uzf", flagship_grid(*shape), device=device, **args)


def counted_solves(sim):
    """[(outer, inner)] of every solve of ``sim`` from now on (a step's
    uzf_cc re-solves among them; a record keeps only the accepted one)."""
    out = []
    solve = sim.solution.solve_timestep

    def counted(*args, **kwargs):
        result = solve(*args, **kwargs)
        out.append((result[1].outer_iterations, result[1].inner_iterations))
        return result

    sim.solution.solve_timestep = counted
    return out


@contextlib.contextmanager
def timed_advances(device):
    """Wall seconds (device work finished) and sub-steps of every UZF
    march in the block."""
    from modflow6_torch.models.gwf import uzf as uzf_mod
    out = []
    advance = uzf_mod.advance

    def timed(*args, **kwargs):
        sync(device)
        t = time.perf_counter()
        res = advance(*args, **kwargs)
        sync(device)
        out.append((time.perf_counter() - t, res.nsub))
        return res

    uzf_mod.advance = timed
    try:
        yield out
    finally:
        uzf_mod.advance = advance


def budget_terms(table, names):
    """{name: (rate in, rate out)} of a budget table's rows."""
    out = {}
    for line in table.splitlines():
        words = line.split()
        if words and words[0] in names:
            out[words[0]] = tuple(words[1:3])
    return out


def run_uzf_memory(device, shape):
    """(u1) UZF on every top cell of the bench grid through ``Simulation``
    (3 steps of 5.0, CG with Jacobi, ``f64``); (u2) the same run again,
    bitwise equal.  Returns ((u1)'s records, the stencil7 launches of both
    runs)."""
    from modflow6_torch.models.gwf import uzf as uzf_mod
    runs, launches = [], 0
    for label in ("u1", "u2"):
        reset_peak(device)
        t0 = time.perf_counter()
        model = uzf_base(device, shape)
        columns = uzf_mod.make_uzf(uzf_columns(shape), device=device,
                                   **UZF_FLAGS)
        sync(device)
        build_s = time.perf_counter() - t0
        sim = Simulation(Tdis((StressPeriod(15.0, 3, 1.0),)), model,
                         ImsSettings(**BENCH))
        sim.uzf = columns
        solves = counted_solves(sim)
        with timed_advances(device) as marches, \
                counted_run() as counts:
            t0 = time.perf_counter()
            recs = sim.run()
            sync(device)
            seconds = time.perf_counter() - t0
        disc = check_budget(f"coupling ({label})", sim, recs)
        inner = sum(i for _, i in solves)
        outers = [r.outer for r in recs]
        inners = [r.inner for r in recs]
        ms = seconds / inner * 1e3
        terms = budget_terms(recs[-1].budget_table,
                             ("UZF-GWRCH", "UZF-GWD", "UZF-GWET", "CHD",
                              "WEL"))
        print(f"coupling ({label}) uzf Simulation cg f64 cells="
              f"{model.nodes} columns={columns.node.shape[0]} nz="
              f"{columns.nz} steps=3 solves={len(solves)} "
              f"inner_total_all_solves={inner} outer_total_all_solves="
              f"{sum(o for o, _ in solves)} per_solve_outer_inner={solves} "
              f"accepted_outers={outers} accepted_inners={inners} "
              f"uzf_cc_resolves="
              f"{[r.uzf_resolves for r in recs]} marches={len(marches)} "
              f"nsub={sorted({n for _, n in marches})} "
              f"ms_per_advance={[s * 1e3 for s, _ in marches]!r} "
              f"seconds={seconds!r} ms_per_inner={ms!r} "
              f"build_s={build_s!r} stencil7_launches={counts['launches']} "
              f"plain_on_cuda={counts['plain_on_cuda']} "
              f"budget_percent_discrepancy={disc!r} "
              f"last_step_rates_in_out={terms} "
              f"max_memory_allocated={peak_bytes(device)}")
        if counts["launches"] < inner or counts["plain_on_cuda"]:
            raise AssertionError("the UZF run did not multiply through the "
                                 "stencil kernel")
        if "UZF-GWRCH" not in terms or "UZF-GWET" not in terms:
            raise AssertionError("the UZF budget terms are missing")
        launches += counts["launches"]
        runs.append(recs)
    same = all(np.array_equal(p.head, q.head) for p, q in zip(*runs))
    counts_same = [(r.outer, r.inner, r.uzf_resolves) for r in runs[0]] == \
        [(r.outer, r.inner, r.uzf_resolves) for r in runs[1]]
    print(f"coupling (u2) vs (u1): heads bitwise equal={same} counts "
          f"equal={counts_same}")
    if not (same and counts_same):
        raise AssertionError("two card runs of the UZF model differ")
    return runs[0], launches


def write_uzf_file(ws, columns, periods, ncol):
    """The UZF6 file of ``uzf_columns`` on a grid of ``ncol`` columns
    (LANDFLAG 1 on every column) with one PERIOD block per entry of
    ``periods``, each a FINF multiplier."""
    nrow_ncol = columns["node"].shape[0]
    ids = np.arange(1, nrow_ncol + 1)
    with open(os.path.join(ws, "m.uzf"), "w") as f:
        f.write("BEGIN OPTIONS\n  SIMULATE_ET\n  LINEAR_GWET\n"
                "  SIMULATE_GWSEEP\nEND OPTIONS\nBEGIN DIMENSIONS\n"
                f"  NUZFCELLS {nrow_ncol}\nEND DIMENSIONS\n"
                "BEGIN PACKAGEDATA\n")
        f.writelines(
            f"  {u} 1 {i} {j} 1 0 {UZF_SURFDEP!r} {v!r} 0.05 0.35 0.15 "
            "3.5\n" for u, i, j, v in zip(
                ids, columns["node"] // ncol + 1, columns["node"] % ncol + 1,
                columns["vks"].tolist()))
        f.write("END PACKAGEDATA\n")
        for kper, factor in enumerate(periods, 1):
            f.write(f"BEGIN PERIOD {kper}\n")
            f.writelines(f"  {u} {1e-4 * factor!r} 2e-4 12.0 0.05\n"
                         for u in ids.tolist())
            f.write("END PERIOD\n")
    return ["UZF6 m.uzf"]


def run_uzf_deck(device, memory_recs, shape):
    """(u3) The model of (u1) written as a deck (UZF6 with a second period
    of one step at twice the infiltration) through the command-line entry:
    period 1 has (u1)'s counts and heads within DECK_FUSED_ATOL.  Returns
    the run's stencil7 launches."""
    from modflow6_torch.utils import mf6io
    from modflow6_torch.utils.mf6io import loader as loader_mod
    nlay, nrow, ncol = shape
    with tempfile.TemporaryDirectory() as ws:
        t0 = time.perf_counter()
        files = write_uzf_file(ws, uzf_columns(shape), [1.0, 2.0], ncol)
        write_flagship_deck(ws, nlay, nrow, ncol, rcha=None, icelltype=1,
                            sy=UZF_STORAGE["sy"],
                            tdis=[(15.0, 3, 1.0), (5.0, 1, 1.0)],
                            extra_packages=files,
                            oc_extra="  PRINT BUDGET ALL\n")
        write_s = time.perf_counter() - t0
        loads, builds = [], []
        load = mf6io.load_simulation
        build = loader_mod._build_uzf

        def timed_load(*args, **kwargs):
            t = time.perf_counter()
            sim = load(*args, **kwargs)
            sync(device)
            loads.append(time.perf_counter() - t)
            return sim

        def timed_build(*args):
            t = time.perf_counter()
            out = build(*args)
            sync(device)
            builds.append(time.perf_counter() - t)
            return out

        mf6io.load_simulation = timed_load
        loader_mod._build_uzf = timed_build
        lst = os.path.join(ws, "cli.lst")
        out = io.StringIO()
        try:
            with counted_run() as counts, contextlib.redirect_stdout(out):
                t0 = time.perf_counter()
                code = cli_main([ws, "--lst", lst]
                                + ([] if torch.device(device).type == "cuda"
                                   else ["--device", "cpu"]))
                sync(device)
                cli_s = time.perf_counter() - t0
        finally:
            mf6io.load_simulation = load
            loader_mod._build_uzf = build
        cli_counts = listing_counts(lst)
        discs = [float(v) for v in re.findall(
            r"PERCENT DISCREPANCY:\s*(\S+)", open(lst).read())]
        layers = read_head_file(os.path.join(ws, "m.hds"))
        saved = {}
        for rec in layers:
            saved.setdefault((rec["kper"], rec["kstp"]), []).append(
                rec["data"])
        err = float(np.abs(np.stack(saved[(1, 3)]).reshape(-1)
                           - memory_recs[-1].head).max())
        want = [(r.outer, r.inner) for r in memory_recs]
        print(f"coupling (u3) uzf deck cli exit={code} written_s={write_s!r}"
              f" wall_s={cli_s!r} load_s={loads!r} uzf_build_s={builds[:1]!r}"
              f" period2_rebuild_s={builds[1:]!r} counts={cli_counts} "
              f"(u1)={want} budget_percent_discrepancy_per_step={discs} "
              f"max|h_period1 - h_(u1)|={err!r} bar={DECK_FUSED_ATOL!r} "
              f"stencil7_launches={counts['launches']} "
              f"stdout={out.getvalue().strip()!r}")
        if code != 0 or "Normal termination" not in out.getvalue():
            raise AssertionError("the UZF deck did not end normally")
        if cli_counts[:3] != want or len(cli_counts) != 4:
            raise AssertionError("the UZF deck's period-1 counts differ "
                                 "from (u1)'s")
        if not (err <= DECK_FUSED_ATOL and len(builds) == 2
                and len(discs) == 4 and max(map(abs, discs)) < BUDGET_PERCENT):
            raise AssertionError("the UZF deck failed its checks")
        if counts["launches"] == 0 or counts["plain_on_cuda"]:
            raise AssertionError("the UZF deck did not multiply through the "
                                 "stencil kernel")
    return counts["launches"]


def coupling_movers(shape):
    """The movers of the (m) runs on ``advanced_features``'s layout (about
    320 at full width), as build_mvr dicts and as MVR6 records: extracting
    wells into lakes (FACTOR 0.5), the Manning outlets into reaches along
    the tributaries (UPTO), side-channel reaches into lakes (THRESHOLD),
    the bench well into reach 0 (FACTOR 1.0), and the main stem's last
    reach into lake 0 (EXCESS) and then lake 1 (UPTO): one provider entry
    with two movers."""
    nlay, nrow, ncol = shape
    wells, lakes, path, ntrib, nmain, nside = advanced_layout(*shape)
    main0, side0 = 2 * ntrib, 2 * ntrib + nmain
    L = len(lakes)
    movers = []

    def add(provider, iprov, receiver, ircv, rule, value):
        movers.append(dict(provider=provider, iprov=iprov,
                           receiver=receiver, ircv=ircv, mvrtype=rule,
                           value=value))

    step = max(len(wells) // (L // 2), 1)
    for j in range(L // 2):
        add("maw", j * step, "lak", 2 * j, "factor", 0.5)
    for j in range(L // 2):
        add("lak", 2 * j + 1, "sfr", (j * 2 * ntrib) // (L // 2), "upto",
            0.2)
    for j in range(nside):
        add("sfr", side0 + j, "lak", (2 * j + 1) % L, "threshold", 0.05)
    add("wel", 0, "sfr", 0, "factor", 1.0)
    add("sfr", side0 - 1, "lak", 0, "excess", 1.0)
    add("sfr", side0 - 1, "lak", 1, "upto", 0.5)
    names = dict(maw="MAW-1", lak="LAK-1", sfr="SFR-1", wel="WEL-1")
    records = [f"  {names[m['provider']]} {m['iprov'] + 1} "
               f"{names[m['receiver']]} {m['ircv'] + 1} "
               f"{m['mvrtype'].upper()} {m['value']!r}" for m in movers]
    return movers, records


def mvr_model(device, shape):
    """``advanced_model``'s model with the movers of ``coupling_movers``."""
    grid, kfield = flagship_grid(*shape), flagship_kfield(*shape)
    base = build_gwf("flagship", grid, device=device, **flagship_args(*shape))
    maw, lak, sfr = advanced_specs(advanced_features(grid, kfield), grid,
                                   kfield)
    movers, _ = coupling_movers(shape)
    return AugmentedGwfModel(base, maw=maw, lak=lak, sfr=sfr, mvr=movers)


def mover_totals(model, x, x_old, delt):
    """(Σ qto, Σ qfrom, the movers' budget terms summed) at x."""
    ib, _ = model.boundary_state(x)
    _, qto, qfrom = model.eval_movers(x, ib)
    bud = model.advanced_budget(x, x_old, delt, False)
    terms = {k: float(v.sum()) for k, v in bud.items() if "MVR" in k}
    return (float(sum(v.sum() for v in qto.values())),
            float(sum(v.sum() for v in qfrom.values())), terms)


def eager_chain(mvr, avail, recv_sizes):
    """The reference's mover chain as it reads, one mover at a time (a
    gather, the rule, three indexed adds), run eagerly: the comparison for
    the rounds of ``mvr.run_movers``."""
    from modflow6_torch.constants import DZERO
    qa = {k: v.clone() for k, v in avail.items()}
    qto = {k: torch.zeros_like(v) for k, v in avail.items()}
    qfrom = {k: avail[next(iter(avail))].new_zeros(n)
             for k, n in recv_sizes.items()}
    qps = []
    for i in range(mvr.nmovers):
        pk, pi = mvr.prov_pkg[i], mvr.prov_id[i]
        rk, ri = mvr.recv_pkg[i], mvr.recv_id[i]
        a, ta, v = qa[pk][pi], avail[pk][pi], mvr.value[i]
        typ = mvr.mvrtype[i]
        if typ == "factor":
            qr = torch.minimum(torch.where(ta > DZERO, ta * v, DZERO), a)
        elif typ == "excess":
            qr = torch.clamp(a - v, min=DZERO)
        elif typ == "threshold":
            qr = torch.where(v > a, DZERO, v)
        else:
            qr = torch.minimum(a, v)
        qr = torch.clamp(qr, min=DZERO)
        qa[pk][pi] -= qr
        qto[pk][pi] += qr
        if rk in qfrom:
            qfrom[rk][ri] += qr
        qps.append(qr)
    return torch.stack(qps), qto, qfrom


def time_mover_chain(model, x):
    """ms of one evaluation of the mover chain on the card in rounds
    (``run_movers``) and one mover at a time (``eager_chain``), at the
    availabilities of x, and whether the two agree bitwise."""
    from modflow6_torch.models.gwf import mvr as mvr_mod
    ib, _ = model.boundary_state(x)
    avail = model.available_water(x, ib)
    sizes = model._recv_sizes()
    rounds = mvr_mod.run_movers(model.mvr, avail, sizes)
    eager = eager_chain(model.mvr, avail, sizes)
    same = torch.equal(rounds[0], eager[0]) and all(
        torch.equal(r[k], e[k]) for r, e in zip(rounds[1:], eager[1:])
        for k in r)
    ms = back_to_back_ms(lambda: mvr_mod.run_movers(model.mvr, avail,
                                                    sizes), launches=20,
                         runs=5, warmup=3)
    eager_ms = back_to_back_ms(lambda: eager_chain(model.mvr, avail, sizes),
                               launches=2, runs=3, warmup=1)
    return ms, eager_ms, same


def run_mvr_memory(device, shape):
    """(m1) The advanced phase's model with about 320 movers through
    ``Simulation`` (3 steps of 5.0, BiCGSTAB with Jacobi, ``f64``); (m2)
    the same run again, bitwise equal; neither launches stencil7.  Returns
    (m1)'s records."""
    runs = []
    for label in ("m1", "m2"):
        reset_peak(device)
        t0 = time.perf_counter()
        model = mvr_model(device, shape)
        sync(device)
        build_s = time.perf_counter() - t0
        sim, recs, seconds, counts = simulate(model, [(15.0, 3, 1.0)],
                                              advanced_settings())
        disc = check_budget(f"coupling ({label})", sim, recs)
        inner, outers, inners, ms = totals(recs, seconds)
        x = torch.as_tensor(recs[-1].head, device=device)
        x_old = torch.as_tensor(recs[-2].head, device=device)
        qto, qfrom, terms = mover_totals(model, x, x_old, 5.0)
        rel = abs(qto - qfrom) / max(abs(qto), 1e-300)
        table = budget_terms(recs[-1].budget_table,
                             ("WEL", "WEL-TO-MVR", "MAW", "LAK", "SFR"))
        print(f"coupling ({label}) mvr Simulation bicgstab f64 rows="
              f"{model.nodes} movers={model.mvr.nmovers} rounds="
              f"{len(model.mvr.rounds)} steps=3 inner_total={inner} "
              f"outers={outers} inners={inners} seconds={seconds!r} "
              f"ms_per_inner={ms!r} build_s={build_s!r} "
              f"stencil7_launches={counts['launches']} "
              f"budget_percent_discrepancy={disc!r} model_rates_in_out="
              f"{table} mover_terms={terms} sum_qto={qto!r} "
              f"sum_qfrom={qfrom!r} relative={rel!r} "
              f"max_memory_allocated={peak_bytes(device)}")
        if counts["launches"] or counts["plain_on_cuda"]:
            raise AssertionError("the mover run went through the stencil")
        if not rel <= 1e-12 or "WEL-TO-MVR" not in table:
            raise AssertionError("the movers' totals disagree")
        runs.append(recs)
    same = all(np.array_equal(p.head, q.head) for p, q in zip(*runs))
    counts_same = [(r.outer, r.inner) for r in runs[0]] == [
        (r.outer, r.inner) for r in runs[1]]
    print(f"coupling (m2) vs (m1): heads and feature rows bitwise equal="
          f"{same} counts equal={counts_same}")
    if not (same and counts_same):
        raise AssertionError("two card runs of the mover model differ")
    if torch.device(device).type == "cuda":
        ms, eager_ms, same = time_mover_chain(model, x)
        print(f"coupling (m) mover chain, {model.mvr.nmovers} movers: "
              f"rounds ms={ms!r} one mover at a time ms={eager_ms!r} "
              f"bitwise equal={same}")
        if not same:
            raise AssertionError("the rounds disagree with the mover-by-"
                                 "mover chain")
    return runs[0]


def run_mvr_deck(device, memory_recs, shape):
    """(m3) The model of (m1) written as a deck (MAW6, LAK6, SFR6 and
    MVR6, the MOVER option on WEL, MAW, LAK and SFR) through
    ``load_simulation`` and ``Simulation``: heads within DECK_FUSED_ATOL
    of (m1)'s."""
    nlay, nrow, ncol = shape
    grid = flagship_grid(*shape)
    _, records = coupling_movers(shape)
    with tempfile.TemporaryDirectory() as ws:
        files = write_advanced_files(ws, advanced_features(
            grid, flagship_kfield(*shape)), grid)
        for name in ("m.maw", "m.lak", "m.sfr"):
            path = os.path.join(ws, name)
            text = open(path).read()
            _write(ws, name, "BEGIN OPTIONS\n  MOVER\nEND OPTIONS\n" + text)
        _write(ws, "m.mvr", "BEGIN DIMENSIONS\n  MAXMVR "
               f"{len(records)}\n  MAXPACKAGES 4\nEND DIMENSIONS\n"
               "BEGIN PACKAGES\n  WEL-1\n  MAW-1\n  LAK-1\n  SFR-1\n"
               "END PACKAGES\nBEGIN PERIOD 1\n" + "\n".join(records)
               + "\nEND PERIOD\n")
        write_flagship_deck(ws, nlay, nrow, ncol, acc="BICGSTAB",
                            tdis=[(15.0, 3, 1.0)], wel_options="  MOVER\n",
                            extra_packages=files + ["MVR6 m.mvr"])
        t0 = time.perf_counter()
        sim = load_simulation(ws, device=device)
        sync(device)
        load_s = time.perf_counter() - t0
        with counted_run() as counts:
            t0 = time.perf_counter()
            recs = sim.run()
            sync(device)
            run_s = time.perf_counter() - t0
    err = max(float(np.abs(g.head - w.head).max())
              for g, w in zip(recs, memory_recs))
    counts_equal = [(r.outer, r.inner) for r in recs] == [
        (r.outer, r.inner) for r in memory_recs]
    print(f"coupling (m3) mvr deck load_s={load_s!r} run_s={run_s!r} "
          f"movers={sim.model.mvr.nmovers} outers={[r.outer for r in recs]} "
          f"inners={[r.inner for r in recs]} counts equal to (m1)="
          f"{counts_equal} max|x - x_(m1)|={err!r} bar={DECK_FUSED_ATOL!r} "
          f"budget_percent_discrepancy={sim.budget.percent_discrepancy()!r}"
          f" stencil7_launches={counts['launches']}")
    if not (all(r.converged for r in recs) and err <= DECK_FUSED_ATOL):
        raise AssertionError("the mover deck failed its checks")
    if counts["launches"]:
        raise AssertionError("the mover deck went through the stencil")


def two_model_args(shape):
    """(west, east) build_gwf arguments of the bench model split down the
    middle column, each 4 x nrow x ncol/2, and the exchange arrays: one
    pair per layer and row joining west column ncol/2 to east column 1
    (ihc 1, cl1 = cl2 = 5, hwva 10), the bench connection across that
    face."""
    nlay, nrow, ncol = shape
    half = ncol // 2
    k = flagship_kfield(*shape).reshape(nlay, nrow, ncol)
    st = flagship_stresses(nrow, ncol)
    common = dict(strt=40.0, storage={"ss": 1e-5, "iconvert": 0})
    west = dict(k=k[:, :, :half].reshape(-1), **common,
                chd=[(i * half, 45.0) for i in range(nrow)],
                rch=[(n, 1e-4) for n in range(nrow * half)])
    well = st["wel"][0][0]
    east = dict(k=k[:, :, half:].reshape(-1), **common,
                chd=[(i * half + half - 1, 35.0) for i in range(nrow)],
                wel=[((well // ncol) * half + well % ncol - half, -500.0)],
                rch=[(n, 1e-4) for n in range(nrow * half)])
    lay, row = np.divmod(np.arange(nlay * nrow), nrow)
    base = lay * nrow * half + row * half
    pairs = dict(node1=base + half - 1, node2=base, ihc=np.ones_like(base),
                 cl1=np.full(base.size, 5.0), cl2=np.full(base.size, 5.0),
                 hwva=np.full(base.size, 10.0),
                 angldegx=np.zeros(base.size))
    return west, east, pairs


def merged_order(shape):
    """For each node of the single bench model, its row in the merged
    (west, east) model."""
    nlay, nrow, ncol = shape
    half = ncol // 2
    k, i, j = np.unravel_index(np.arange(nlay * nrow * ncol),
                               (nlay, nrow, ncol))
    west = (k * nrow + i) * half + j
    east = nlay * nrow * half + (k * nrow + i) * half + j - half
    return np.where(j < half, west, east)


def run_two_models(device, shape):
    """(x1) The bench grid as west and east models joined by GWF6-GWF6
    pairs, merged and run over the gather through ``Simulation`` (CG with
    Jacobi, ``f64``) against the single structured model's run: equal
    outer counts, heads within 1e-6, no stencil7 launch in the merged run.
    Returns (x1)'s records."""
    from modflow6_torch.models.gwf import exchange
    half = shape[2] // 2
    reset_peak(device)
    single = flagship(*shape, device)
    settings = ImsSettings(**BENCH)
    _, srecs, sseconds, scounts = simulate(single, [(15.0, 3, 1.0)],
                                           settings)
    single_peak = peak_bytes(device)
    del single
    west, east, pairs = two_model_args(shape)
    reset_peak(device)
    t0 = time.perf_counter()
    grid = flagship_grid(shape[0], shape[1], half)
    members = [build_gwf(name, grid, device=device, **kw)
               for name, kw in (("west", west), ("east", east))]
    merged = exchange.merge_gwf_models(
        members, [exchange.GwfGwfExchange(0, 1, pairs)])
    sync(device)
    merge_s = time.perf_counter() - t0
    sim, recs, seconds, counts = simulate(merged, [(15.0, 3, 1.0)],
                                          settings)
    disc = check_budget("coupling (x1)", sim, recs)
    order = merged_order(shape)
    err = max(float(np.abs(r.head[order] - s.head).max())
              for r, s in zip(recs, srecs))
    inner, outers, inners, ms = totals(recs, seconds)
    s_inner, s_outers, s_inners, s_ms = totals(srecs, sseconds)
    print(f"coupling (x1) two models merged: cells={merged.nodes} "
          f"edges={merged.topo.nedges} pairs={pairs['node1'].size} "
          f"K={merged.dtopo.max_degree} merge_s={merge_s!r} cg f64 "
          f"inner_total={inner} outers={outers} inners={inners} "
          f"seconds={seconds!r} ms_per_inner={ms!r} "
          f"stencil7_launches={counts['launches']} budget_percent_"
          f"discrepancy={disc!r}; single structured model: inner_total="
          f"{s_inner} outers={s_outers} inners={s_inners} seconds="
          f"{sseconds!r} ms_per_inner={s_ms!r} stencil7_launches="
          f"{scounts['launches']} max_memory_allocated={single_peak}; "
          f"max|h_merged - h_single|={err!r} bar=1e-06 "
          f"max_memory_allocated={peak_bytes(device)}")
    if counts["launches"] or counts["plain_on_cuda"]:
        raise AssertionError("the merged run went through the stencil")
    if outers != s_outers or not err <= 1e-6:
        raise AssertionError("the merged run disagrees with the single "
                             "model's")
    return recs


def write_two_model_deck(ws, shape):
    """The (x1) models as a deck: west/ and east/ each a bench-model deck
    of half the width (K from the bench field, RCHA 1e-4, CHD on the outer
    column, the well in the east), mfsim.nam with both models, the
    GWF6-GWF6 exchange file and one IMS solution; the merged heads go to
    west/m.hds."""
    nlay, nrow, ncol = shape
    half = ncol // 2
    west, east, pairs = two_model_args(shape)
    well = east["wel"][0][0]
    for name, kw, chd_col in (("west", west, 1), ("east", east, half)):
        sub = os.path.join(ws, name)
        os.makedirs(sub)
        write_flagship_deck(
            sub, nlay, nrow, half, name=name.upper(),
            kfield=kw["k"], chd=[(1, i + 1, chd_col, kw["chd"][0][1])
                                 for i in range(nrow)],
            wel=[(1, (well % (nrow * half)) // half + 1, well % half + 1,
                  -500.0)] if name == "east" else [],
            oc_last=name == "west")
    _write(ws, "mfsim.nam", """BEGIN TIMING
  TDIS6 sim.tdis
END TIMING
BEGIN MODELS
  GWF6 west/m.nam WEST
  GWF6 east/m.nam EAST
END MODELS
BEGIN EXCHANGES
  GWF6-GWF6 we.exg WEST EAST
END EXCHANGES
BEGIN SOLUTIONGROUP 1
  IMS6 west/sim.ims WEST EAST
END SOLUTIONGROUP
""")
    _write(ws, "sim.tdis", open(os.path.join(ws, "west", "sim.tdis")).read())
    lay, rest = np.divmod(pairs["node1"], nrow * half)
    row = rest // half
    lines = "".join(f"  {k + 1} {i + 1} {half} {k + 1} {i + 1} 1 1 5.0 5.0 "
                    "10.0\n" for k, i in zip(lay.tolist(), row.tolist()))
    _write(ws, "we.exg", f"BEGIN DIMENSIONS\n  NEXG {lay.size}\n"
           f"END DIMENSIONS\nBEGIN EXCHANGEDATA\n{lines}END EXCHANGEDATA\n")


def run_two_model_deck(device, memory_recs, shape):
    """(x2) The two-model deck through the command-line entry: equal
    counts and the merged heads within DECK_FUSED_ATOL of (x1)'s."""
    with tempfile.TemporaryDirectory() as ws:
        write_two_model_deck(ws, shape)
        lst = os.path.join(ws, "cli.lst")
        out = io.StringIO()
        with counted_run() as counts, contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            code = cli_main([ws, "--lst", lst]
                            + ([] if torch.device(device).type == "cuda"
                               else ["--device", "cpu"]))
            sync(device)
            cli_s = time.perf_counter() - t0
        cli_counts = listing_counts(lst)
        heads = read_head_file(os.path.join(ws, "west", "m.hds"))
        grb = [f for f in os.listdir(os.path.join(ws, "west"))
               if f.endswith(".grb")]
    want = [(r.outer, r.inner) for r in memory_recs]
    err = float(np.abs(heads[-1]["data"].reshape(-1)
                       - memory_recs[-1].head).max()) if heads else np.inf
    print(f"coupling (x2) two-model deck cli exit={code} wall_s={cli_s!r} "
          f"counts={cli_counts} (x1)={want} heads_records="
          f"{[(r['kper'], r['kstp'], r['data'].shape) for r in heads]} "
          f"grb_files={grb} max|h - h_(x1)|={err!r} "
          f"bar={DECK_FUSED_ATOL!r} stencil7_launches={counts['launches']} "
          f"stdout={out.getvalue().strip()!r}")
    if code != 0 or cli_counts != want or not err <= DECK_FUSED_ATOL \
            or grb or counts["launches"]:
        raise AssertionError("the two-model deck failed its checks")


def small_coupling_models(dev):
    """(name, run) of the small coupling twins: ``run()`` returns (x on
    the CPU, [(outer, inner)], converged, settings)."""
    from modflow6_torch.models.gwf import exchange, uzf as uzf_mod
    tight = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-10,
                 inner_rclose=1e-9, inner_maximum=600)
    bic = dict(tight, outer_maximum=200, inner_maximum=500,
               linear_acceleration="bicgstab")

    def uzf_twin():
        # a 1 x 3 x 5 model mounded near land surface: seepage and
        # groundwater ET active under the columns
        g = DisGrid.create(1, 3, 5, 10.0, 10.0, 12.0, np.zeros((1, 3, 5)))
        model = build_gwf("uzf", g, k=0.05, strt=10.5, device=dev,
                          storage={"ss": 1e-4, "iconvert": 0},
                          chd=[(0, 10.0), (10, 9.5)])
        sim = Simulation(Tdis((StressPeriod(20.0, 4, 1.2),)), model,
                         ImsSettings(**tight))
        rng = np.random.default_rng(3)
        sim.uzf = uzf_mod.make_uzf(dict(
            node=np.arange(1, 15), vks=rng.uniform(0.05, 0.5, 14),
            thtr=np.full(14, 0.05), thts=np.full(14, 0.35),
            thti=np.full(14, 0.12), eps=np.full(14, 3.5),
            celtop=np.full(14, 11.0), celbot=np.zeros(14),
            surfdep=np.full(14, 0.5), area=np.full(14, 100.0),
            finf=rng.uniform(0.01, 0.05, 14), pet=np.full(14, 0.01),
            extdp=np.full(14, 3.0), extwc=np.full(14, 0.06)), nz=10,
            device=dev, ietflag=1, iseepflag=1, igwetflag=1)
        recs = sim.run()
        return (torch.as_tensor(recs[-1].head),
                [(r.outer, r.inner, r.uzf_resolves) for r in recs],
                all(r.converged for r in recs), tight)

    def chain_twin():
        # tests/test_mvr.py:100: SFR's last reach into a lake, the lake's
        # specified outlet into a well
        g = DisGrid.create(1, 1, 8, 100.0, 100.0, 50.0, np.zeros((1, 1, 8)))
        base = build_gwf("m", g, k=5.0, strt=30.0, device=dev,
                         chd=[(0, 30.0), (7, 30.0)], drn=[(3, 35.0, 2.0)])
        reaches = [dict(node=r + 2, cond=0.0, strtop=40.0 + 0.1 * (4 - r),
                        width=3.0, rough=0.03, slope=1e-3, length=100.0,
                        strt=40.3 + 0.1 * (4 - r),
                        inflow=2.0 if r == 0 else 0.0,
                        upstream=[(r - 1, 1.0)] if r > 0 else [])
                   for r in range(4)]
        model = AugmentedGwfModel(
            base, maw=build_maw([dict(radius=0.2, strt=30.0, rate=0.0,
                                      connections=[(6, 10.0)])], g),
            lak=build_lak([dict(strt=20.0, surf_area=1e4, bottom=15.0,
                                connections=[(5, 1e-6, 18.0)])],
                          [dict(lake=0, to=-1, type="specified",
                                rate=0.8)]),
            sfr=build_sfr(reaches),
            mvr=[dict(provider="sfr", iprov=3, receiver="lak", ircv=0,
                      mvrtype="factor", value=1.0),
                 dict(provider="lak", iprov=0, receiver="maw", ircv=0,
                      mvrtype="factor", value=1.0)])
        return solve_steps(model, bic, 20, 2e4)

    def exchange_twin():
        # tests/test_exchange_mvr.py:64: A's terminal reach moved across
        # the exchange into B's first reach
        g = DisGrid.create(1, 1, 4, 100.0, 100.0, 50.0, np.zeros((1, 1, 4)))
        members = [build_gwf(n, g, k=1e-8, strt=30.0, device=dev,
                             chd=[(0, 30.0)]) for n in ("a", "b")]
        merged = exchange.merge_gwf_models(members, [
            exchange.GwfGwfExchange(0, 1, [exchange.ExchangePair(
                3, 0, ihc=1, cl1=50.0, cl2=50.0, hwva=100.0)])])
        reach = dict(cond=0.0, width=3.0, rough=0.03, slope=1e-3,
                     length=100.0)
        reaches = []
        for m, off in enumerate(merged.grid.offsets):
            r0 = 2 * m
            reaches += [dict(node=int(off) + 1, strtop=40.0, strt=40.1,
                             inflow=2.0 if m == 0 else 0.0, **reach),
                        dict(node=int(off) + 2, strtop=39.9, strt=40.0,
                             upstream=[(r0, 1.0)], **reach)]
        model = AugmentedGwfModel(merged, sfr=build_sfr(reaches), mvr=[
            dict(provider="sfr", iprov=1, receiver="sfr", ircv=2,
                 mvrtype="factor", value=1.0)])
        return solve_steps(model, bic, 10, 2e3)

    def solve_steps(model, s, steps, delt):
        sol = NumericalSolution(model, ImsSettings(**s))
        x, counts, conv = model.strt, [], True
        for kstp in range(1, steps + 1):
            x, info, _ = sol.solve_timestep(x, delt, kstp=kstp, iss=False)
            counts.append((info.outer_iterations,))
            conv = conv and info.converged
        return x.cpu(), counts, conv, s

    return [("uzf seepage and gw et", uzf_twin),
            ("sfr-lak-maw mover chain", chain_twin),
            ("two-model exchange mover", exchange_twin)]


def check_small_coupling(device, names=None):
    """Small coupling twins on the card against the CPU: a UZF column model
    with seepage and groundwater ET (CG: equal outer and inner counts and
    uzf_cc passes, heads within CARD_CPU_ATOL), the reference's SFR→LAK→MAW
    mover chain and a two-model SFR→SFR exchange mover (BiCGSTAB: equal
    outer counts, heads within 10 × outer_dvclose)."""
    cpu = dict(small_coupling_models("cpu"))
    for name, run in small_coupling_models(device):
        if names is not None and name not in names:
            continue
        h, k, c, s = run()
        h0, k0, c0, _ = cpu[name]()
        err = float((h - h0).abs().max())
        cg = s.get("linear_acceleration", "cg") == "cg"
        bar = CARD_CPU_ATOL if cg else CLOSURE_FACTOR * s["outer_dvclose"]
        print(f"small {name}: card counts={k} converged={c}; cpu counts={k0}"
              f" converged={c0}; max|dx|={err!r} bar={bar!r}")
        if not (c and c0 and k == k0 and err <= bar):
            raise AssertionError(f"small {name}: the card disagrees with "
                                 "the CPU")


def run_coupling(device, shape=BENCH_SHAPE):
    """The coupling phase: (u1)-(u3) UZF, (m1)-(m3) MVR, (x1)-(x2) two
    models, at ``shape`` (the small twins run in the small phase).
    Returns the stencil7
    launches of the UZF runs, which must be some: the UZF model keeps its
    grid shape."""
    recs, launches = run_uzf_memory(device, shape)
    launches += run_uzf_deck(device, recs, shape)
    run_mvr_deck(device, run_mvr_memory(device, shape), shape)
    run_two_model_deck(device, run_two_models(device, shape), shape)
    if not launches:
        raise AssertionError("the UZF runs launched no stencil7 kernel")
    return launches


# ------------------------------------------------------------ utilities

# the utilities deck: two periods of three steps whose ends fall between
# the series' knots (UTIL_KNOTS), so that the step averages integrate
# across knots
UTIL_PERIODS = ((10.0, 3, 1.5), (10.0, 3, 0.7))
UTIL_KNOTS = (0.0, 3.3, 7.7, 12.1, 16.5, 21.0)
UTIL_TAS_TIMES = (0.0, 8.8, 21.0)
UTIL_METHODS = ("stepwise", "linear", "linearend")
UTIL_OBS_CELLS = 4096       # HEAD and DRAWDOWN observations
UTIL_ZONES = 8              # 4 quadrants x 2 layer pairs


def util_series():
    """The eight well series (names, methods, SFACs and values at
    UTIL_KNOTS, the values before SFAC) and the east CHD column's LINEAR
    series, as the TS6 file states them."""
    rng = np.random.default_rng(808)
    names = [f"q{n}" for n in range(8)] + ["east"]
    methods = [UTIL_METHODS[n % 3] for n in range(8)] + ["linear"]
    sfacs = [1.5 if n == 5 else 1.0 for n in range(8)] + [1.0]
    values = np.concatenate([
        rng.uniform(-900.0, -100.0, (8, len(UTIL_KNOTS))),
        np.array([[35.0, 34.0, 36.5, 33.0, 35.5, 34.5]])])
    return names, methods, sfacs, values


def util_layout(shape):
    """Node numbers of the utilities deck's stresses and observations:
    the wells on a lattice in layer 3 (32 x 32 at full width), the west
    and east CHD columns, the observed cells of HEAD and DRAWDOWN, and the
    cells and wells of the flow observations."""
    nlay, nrow, ncol = shape
    side = min(32, nrow // 2, ncol // 2)
    rows = (np.arange(side) * nrow) // side + nrow // (2 * side)
    cols = (np.arange(side) * ncol) // side + ncol // (2 * side)
    k = min(2, nlay - 1)
    wells = (k * nrow * ncol + rows[:, None] * ncol + cols[None, :]).reshape(-1)
    west = np.arange(nrow) * ncol
    east = west + ncol - 1
    rng = np.random.default_rng(809)
    nobs = min(UTIL_OBS_CELLS, nlay * nrow * ncol // 4)
    obs = rng.choice(nlay * nrow * ncol, nobs, replace=False)
    step = max(1, nrow // 16)
    return dict(wells=wells, west=west, east=east, obs=obs,
                obs_wells=np.arange(0, wells.size, 16),
                obs_chd=np.concatenate([west[::step], east[::step]]),
                obs_rch=rng.choice(nrow * ncol, 32, replace=False))


def util_tas_arrays(shape):
    """The three recharge arrays of the TAS6 file, one per TIME block."""
    _, nrow, ncol = shape
    rng = np.random.default_rng(810)
    base = rng.uniform(0.0, 2e-4, nrow * ncol)
    return np.stack([base * f for f in (0.5, 1.5, 0.8)])


def _cellid(node, shape):
    _, nrow, ncol = shape
    k, rest = divmod(int(node), nrow * ncol)
    i, j = divmod(rest, ncol)
    return f"{k + 1} {i + 1} {j + 1}"


def write_utilities_deck(ws, shape):
    """The bench deck with the series, the time-array recharge, the
    observations and the NetCDF export (``write_flagship_deck`` writes the
    grid, K, IC, STO, IMS and OC files).  Returns the layout."""
    nlay, nrow, ncol = shape
    lay = util_layout(shape)
    names, methods, sfacs, values = util_series()
    write_flagship_deck(
        ws, nlay, nrow, ncol, tdis=list(UTIL_PERIODS),
        sto_periods=["TRANSIENT"], chd=[], wel=[], rcha=None,
        extra_packages=("CHD6 util.chd", "WEL6 util.wel", "RCH6 util.rcha",
                        "OBS6 util.obs"),
        oc_extra="  SAVE HEAD ALL\n")
    # heads at every step (for the observations and NetCDF), budgets at
    # each period's last step
    oc = open(os.path.join(ws, "m.oc")).read().replace(
        "  SAVE HEAD LAST\n", "")
    _write(ws, "m.oc", oc)
    nam = open(os.path.join(ws, "m.nam")).read()
    nam = nam.replace("  CHD6 m.chd\n", "")
    _write(ws, "m.nam", "BEGIN OPTIONS\n  NETCDF_STRUCTURED FILEOUT util.nc\n"
           "END OPTIONS\n" + nam)
    rows = "\n".join(f"  {k} " + " ".join(repr(float(v)) for v in vals)
                     for k, vals in zip(UTIL_KNOTS, values.T))
    _write(ws, "util.ts", "BEGIN ATTRIBUTES\n"
           f"  NAMES {' '.join(names)}\n  METHODS {' '.join(methods)}\n"
           f"  SFACS {' '.join(repr(s) for s in sfacs)}\nEND ATTRIBUTES\n"
           f"BEGIN TIMESERIES\n{rows}\nEND TIMESERIES\n")
    chd = [f"  {_cellid(n, shape)} 45.0" for n in lay["west"]] + [
        f"  {_cellid(n, shape)} east" for n in lay["east"]]
    _write(ws, "util.chd", "BEGIN OPTIONS\n  TS6 FILEIN util.ts\nEND OPTIONS\n"
           f"BEGIN DIMENSIONS\n  MAXBOUND {len(chd)}\nEND DIMENSIONS\n"
           "BEGIN PERIOD 1\n" + "\n".join(chd) + "\nEND PERIOD\n")
    wel = [f"  {_cellid(n, shape)} q{w % 8} w{w}"
           for w, n in enumerate(lay["wells"])]
    _write(ws, "util.wel", "BEGIN OPTIONS\n  BOUNDNAMES\n  TS6 FILEIN util.ts\n"
           f"END OPTIONS\nBEGIN DIMENSIONS\n  MAXBOUND {len(wel)}\n"
           "END DIMENSIONS\nBEGIN PERIOD 1\n" + "\n".join(wel)
           + "\nEND PERIOD\n")
    blocks = []
    for t, arr in zip(UTIL_TAS_TIMES, util_tas_arrays(shape)):
        fname = f"rch_{len(blocks)}.bin"
        with open(os.path.join(ws, fname), "wb") as f:
            f.write(struct.pack("<iidd16siii", 1, 1, 1.0, 1.0,
                                b"RECHARGE".rjust(16), ncol, nrow, 1))
            np.asarray(arr, "<f8").tofile(f)
        blocks.append(f"BEGIN TIME {t!r}\n  OPEN/CLOSE {fname} (BINARY)\n"
                      "END TIME\n")
    _write(ws, "util.tas", "BEGIN ATTRIBUTES\n  NAME rts\n  METHOD LINEAR\n"
           "END ATTRIBUTES\n" + "".join(blocks))
    _write(ws, "util.rcha", "BEGIN OPTIONS\n  READASARRAYS\n"
           "  TAS6 FILEIN util.tas\nEND OPTIONS\nBEGIN PERIOD 1\n"
           "  RECHARGE TIMEARRAYSERIES rts\nEND PERIOD\n")
    half = lay["obs"].size // 2
    heads = [f"  h{n} HEAD {_cellid(n, shape)}" for n in lay["obs"][:half]]
    heads += [f"  d{n} DRAWDOWN {_cellid(n, shape)}"
              for n in lay["obs"][half:]]
    flows = [f"  qw{w} WEL w{w}" for w in lay["obs_wells"]]
    flows += [f"  qc{n} CHD {_cellid(n, shape)}" for n in lay["obs_chd"]]
    flows += [f"  qr{n} RCH {_cellid(n, shape)}" for n in lay["obs_rch"]]
    _write(ws, "util.obs", "BEGIN CONTINUOUS FILEOUT heads.csv\n"
           + "\n".join(heads) + "\nEND CONTINUOUS\n"
           "BEGIN CONTINUOUS FILEOUT flows.csv\n" + "\n".join(flows)
           + "\nEND CONTINUOUS\n")
    return lay


def np_series_average(times, values, method, t0, t1):
    """A series' value for the step [t0, t1] in numpy, written apart from
    modflow6_torch/utils/timeseries.py: the exact average of the stepwise
    or piecewise-linear function (clamped at its ends), or its end value
    (LINEAREND)."""
    times = np.asarray(times, np.float64)
    if method == "linearend":
        return float(np.interp(t1, times, values))
    pts = np.concatenate([[t0], times[(times > t0) & (times < t1)], [t1]])
    if method == "stepwise":
        idx = np.clip(np.searchsorted(times, pts[:-1], "right") - 1, 0, None)
        return float(np.sum(values[idx] * np.diff(pts)) / (t1 - t0))
    v = np.interp(pts, times, values)
    return float(np.sum(0.5 * (v[:-1] + v[1:]) * np.diff(pts)) / (t1 - t0))


def np_array_average(times, arrays, t0, t1):
    """The LINEAR time-array series' step average, cell by cell."""
    times = np.asarray(times, np.float64)
    pts = np.concatenate([[t0], times[(times > t0) & (times < t1)], [t1]])
    i = np.clip(np.searchsorted(times, pts, "right"), 1, times.size - 1)
    w = np.clip((pts - times[i - 1]) / (times[i] - times[i - 1]), 0.0, 1.0)
    at = (1.0 - w)[:, None] * arrays[i - 1] + w[:, None] * arrays[i]
    return (0.5 * (at[:-1] + at[1:]) * np.diff(pts)[:, None]).sum(0) \
        / (t1 - t0)


def util_in_memory(device, shape, lay, settings):
    """The utilities deck as an in-memory model whose per-step CHD, WEL
    and RCH values this script computes with numpy: one single-step period
    per step of the deck, each with its PackageData."""
    nlay, nrow, ncol = shape
    names, methods, sfacs, values = util_series()
    arrays = util_tas_arrays(shape)
    model = build_gwf("UTIL", flagship_grid(nlay, nrow, ncol), device=device,
                      k=flagship_kfield(nlay, nrow, ncol), strt=40.0,
                      storage={"ss": 1e-5, "iconvert": 0})
    steps = list(Tdis(tuple(StressPeriod(*p) for p in UTIL_PERIODS)).walk())
    period_data, t0 = {}, 0.0
    ncpl = nrow * ncol
    for k, (_, _, delt, _, totim) in enumerate(steps, start=1):
        avg = [np_series_average(UTIL_KNOTS, values[n] * sfacs[n],
                                 methods[n], t0, t0 + delt)
               for n in range(len(names))]
        period_data[k] = PackageData(
            chd=chd_data([(n, 45.0) for n in lay["west"]]
                         + [(n, avg[8]) for n in lay["east"]], device=device),
            wel=wel_data([(n, avg[w % 8]) for w, n in
                          enumerate(lay["wells"])], device=device),
            rch=rch_data(np.column_stack([np.arange(ncpl), np_array_average(
                UTIL_TAS_TIMES, arrays, t0, t0 + delt)]), device=device))
        t0 = totim
    sim = Simulation(Tdis(tuple(StressPeriod(s[2], 1, 1.0) for s in steps)),
                     model, settings, transient=[True] * len(steps))
    sim.period_data.update(period_data)
    return sim


def netcdf3_record_limit(shape):
    """How many heads records of ``shape`` one classic NetCDF-3 file
    holds, and what scipy's writer does one past it: it packs a
    variable's byte size as a signed 32-bit int, so nt records of N
    float64 values fit while nt * N * 8 < 2**31."""
    import scipy
    from scipy.io import netcdf_file
    rec = int(np.prod(shape)) * 8
    nt = (2**31 - 1) // rec
    f = netcdf_file(io.BytesIO(), "w")
    f._pack_int(nt * rec)
    try:
        f._pack_int((nt + 1) * rec)
        past = "packs a wrapped size"
    except OverflowError as err:
        past = f"raises OverflowError ({err})"
    return nt, rec, f"{past} (scipy {scipy.__version__}, numpy " \
        f"{np.__version__})"


def _csv_rows(path):
    lines = open(path).read().splitlines()
    return lines[0].split(",")[1:], [line.split(",") for line in lines[1:]]


@contextlib.contextmanager
def captured_loads(device):
    """The Simulations that ``load_simulation`` returns (the command-line
    entry's among them) and the seconds each load took."""
    from modflow6_torch.utils import mf6io
    load = mf6io.load_simulation
    loads = []

    def timed(*args, **kwargs):
        t = time.perf_counter()
        sim = load(*args, **kwargs)
        sync(device)
        loads.append((sim, time.perf_counter() - t))
        return sim

    mf6io.load_simulation = timed
    try:
        yield loads
    finally:
        mf6io.load_simulation = load


def run_utilities_deck(device, shape):
    """(a) The series-driven, observed deck through the command-line
    entry, held against an in-memory model with the script's own step
    values; the observation CSV files against the .hds and .cbc files,
    the NetCDF file against the .hds file, and a zone budget of the .cbc.
    Returns (launches, workspace) ."""
    from modflow6_torch.utils.netcdf import read_netcdf_structured
    from modflow6_torch.utils.zonebudget import (ZoneBudget, read_cbc_step,
                                                 zonebudget_from_cbc)
    from modflow6_torch.utils.binary import read_budget_file
    nlay, nrow, ncol = shape
    ws = tempfile.mkdtemp(prefix="util_")
    t0 = time.perf_counter()
    lay = write_utilities_deck(ws, shape)
    write_s = time.perf_counter() - t0
    lst = os.path.join(ws, "cli.lst")
    out = io.StringIO()
    with captured_loads(device) as loads, counted_run() as counts, \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        code = cli_main([ws, "--lst", lst]
                        + ([] if torch.device(device).type == "cuda"
                           else ["--device", "cpu"]))
        sync(device)
        cli_s = time.perf_counter() - t0
    launches = counts["launches"]
    sim, load_s = loads[0]
    recs = sim.records
    print(f"utilities (a) deck cli exit={code} cells={sim.model.nodes} "
          f"wells={lay['wells'].size} obs={UTIL_OBS_CELLS} written_s={write_s!r} "
          f"wall_s={cli_s!r} load_s={load_s!r} "
          f"counts={[(r.outer, r.inner) for r in recs]} "
          f"solve_s={[r.solve_seconds for r in recs]!r} "
          f"output_s={[r.output_seconds for r in recs]!r} "
          f"stencil7_launches={launches} "
          f"plain_on_cuda={counts['plain_on_cuda']} "
          f"budget_percent_discrepancy={sim.budget.percent_discrepancy()!r} "
          f"stdout={out.getvalue().strip()!r}")
    if code != 0 or "Normal termination" not in out.getvalue() \
            or len(recs) != 6 or not all(r.converged for r in recs):
        raise AssertionError("the utilities deck did not end normally")
    if launches < sum(r.inner for r in recs) or counts["plain_on_cuda"]:
        raise AssertionError("the utilities deck did not multiply through "
                             "the stencil kernel")

    # the in-memory twin with the script's own step values
    twin = util_in_memory(device, shape, lay, sim.solution.s)
    with counted_run() as tcounts:
        t0 = time.perf_counter()
        trecs = twin.run()
        sync(device)
        twin_s = time.perf_counter() - t0
    launches += tcounts["launches"]
    err = max(float(np.abs(a.head - b.head).max())
              for a, b in zip(recs, trecs))
    print(f"utilities (a) in-memory twin counts="
          f"{[(r.outer, r.inner) for r in trecs]} run_s={twin_s!r} "
          f"max|h_deck - h_twin|={err!r} bar={DECK_FUSED_ATOL!r} "
          f"stencil7_launches={tcounts['launches']}")
    if [(r.outer, r.inner) for r in recs] != [(r.outer, r.inner)
                                              for r in trecs] \
            or not err <= DECK_FUSED_ATOL:
        raise AssertionError("the series deck differs from the in-memory "
                             "model with the script's step values")

    # the observations against the heads and budget files
    t0 = time.perf_counter()
    hds = read_head_file(os.path.join(ws, "m.hds"))
    saved = {}
    for rec in hds:
        saved.setdefault((rec["kper"], rec["kstp"]), []).append(rec["data"])
    keys = sorted(saved)
    heads = np.stack([np.stack(saved[key]).reshape(-1) for key in keys])
    names, rows = _csv_rows(os.path.join(ws, "heads.csv"))
    half = lay["obs"].size // 2
    digits = 10
    want = [[f"{t:.{digits}g}"] for t in (r.totim for r in recs)]
    for s, row in enumerate(want):
        h = heads[s, lay["obs"]]
        row += [f"{v:.{digits}g}" for v in h[:half]]
        row += [f"{40.0 - v:.{digits}g}" for v in h[half:]]
    if len(keys) != 6 or rows != want:
        raise AssertionError("the head observations differ from the .hds")
    cbc = os.path.join(ws, "m.cbc")
    names, rows = _csv_rows(os.path.join(ws, "flows.csv"))
    checked = 0
    for rec in read_budget_file(cbc):
        if rec["imeth"] != 6 or rec["text"] not in ("WEL", "CHD", "RCH"):
            continue
        step = [(r.kper, r.kstp) for r in recs].index((rec["kper"],
                                                        rec["kstp"]))
        nodes, _, q, _ = rec["data"]
        if rec["text"] == "WEL":
            got = rows[step][1:1 + lay["obs_wells"].size]
            vals = q[lay["obs_wells"]]
        else:
            at = {int(n): float(v) for n, v in zip(nodes, q)}
            cells = lay["obs_chd"] if rec["text"] == "CHD" else lay["obs_rch"]
            start = 1 + lay["obs_wells"].size + (
                0 if rec["text"] == "CHD" else lay["obs_chd"].size)
            got = rows[step][start:start + cells.size]
            vals = [at[int(n)] for n in cells]
        if got != [f"{v:.{digits}g}" for v in vals]:
            raise AssertionError(f"the {rec['text']} flow observations "
                                 "differ from the .cbc")
        checked += 1
    times, nc = read_netcdf_structured(os.path.join(ws, "util.nc"))
    if checked != 6 or not np.array_equal(nc.reshape(6, -1), heads) \
            or not np.array_equal(times, [r.totim for r in recs]):
        raise AssertionError("the NetCDF file or the flow observations "
                             "differ from the .hds and .cbc")
    check_s = time.perf_counter() - t0

    # a zone budget of the last step: 4 quadrants x 2 layer pairs
    k, i, j = np.meshgrid(np.arange(nlay), np.arange(nrow), np.arange(ncol),
                          indexing="ij")
    zones = (1 + (i >= nrow // 2) * 2 + (j >= ncol // 2)
             + 4 * (k >= nlay // 2)).reshape(-1)
    topo = sim.model.topo
    t0 = time.perf_counter()
    table = zonebudget_from_cbc(topo, zones, cbc, 3, 2)
    zb_s = time.perf_counter() - t0
    discs = [float(line.split()[-1]) for line in table.splitlines()
             if "PERCENT DISCREPANCY" in line]
    _, flows = read_cbc_step(topo, cbc, 3, 2)
    worst = 0.0
    for name, (zin, zout) in ZoneBudget(topo, zones).package_totals(
            flows).items():
        term = sim.budget.terms[name]
        scale = max(term.rate_in + term.rate_out, 1e-300)
        worst = max(worst, abs(zin.sum() - term.rate_in) / scale,
                    abs(zout.sum() - term.rate_out) / scale)
    print(f"utilities (a) observations, NetCDF and .cbc checked in "
          f"{check_s!r} s; zonebudget_from_cbc over {UTIL_ZONES} zones "
          f"in {zb_s!r} s, percent discrepancy per zone {discs}, zones' "
          f"boundary totals vs the model budget: max relative "
          f"difference {worst!r} (bar 1e-9) "
          f"file_bytes={ {f: os.path.getsize(os.path.join(ws, f)) for f in ('m.hds', 'm.cbc', 'util.nc', 'heads.csv', 'flows.csv')} }")
    if len(discs) != UTIL_ZONES or not worst <= 1e-9 \
            or not all(np.isfinite(discs)):
        raise AssertionError("the zone budget differs from the model's")
    nt, rec, past = netcdf3_record_limit(shape)
    print(f"utilities (a) NetCDF-3 classic: a heads record is {rec} bytes, "
          f"one file holds at most {nt} records, all kept in host memory "
          f"until close; one more {past}")
    return launches, ws


def run_utilities_ats(device, ws):
    """(b) The deck of (a) through ``load_simulation`` without its output
    files, period 1 stepping adaptively from a first step of the whole
    period with an outer maximum one below that step's count, run twice,
    and replayed as fixed steps of the accepted length.  Returns the
    launches."""
    from modflow6_torch.timing.ats import AtsPeriod
    from modflow6_torch.utils.mf6io import load_simulation as load
    nam = os.path.join(ws, "m.nam")
    text = open(nam).read()
    for line in ("  NETCDF_STRUCTURED FILEOUT util.nc\n", "  OBS6 util.obs\n",
                 "  OC6 m.oc\n"):
        text = text.replace(line, "")
    _write(ws, "m.nam", text)
    perlen = UTIL_PERIODS[0][0]
    launches, runs, outer_maximum = 0, [], None
    for attempt in ("ats", "ats", "replay"):
        sim = load(ws, device=None if torch.device(device).type == "cuda"
                   else device)
        if outer_maximum is None:
            # a probe of the whole period as one step, which commits
            # nothing: the same Simulation runs below
            _, info, _ = sim.solve_step(sim.model.strt, 1, 1, perlen)
            outer_maximum = info.outer_iterations - 1
            print(f"utilities (b) probe: a step of {perlen} takes "
                  f"{info.outer_iterations} outer iterations; "
                  f"outer_maximum={outer_maximum}")
            if outer_maximum < 2:
                raise AssertionError("no outer maximum makes a step fail")
        sim.solution = NumericalSolution(sim.model, dataclasses.replace(
            sim.solution.s, outer_maximum=outer_maximum))
        if attempt == "ats":
            sim.ats[1] = AtsPeriod(dt0=perlen, dtmin=perlen / 64,
                                   dtmax=perlen, dtadj=1.0, dtfailadj=4.0)
        else:
            steps = runs[0][0]
            sim.tdis = Tdis((StressPeriod(perlen, len(steps), 1.0),)
                            + sim.tdis.periods[1:])
        with counted_run() as counts:
            t0 = time.perf_counter()
            recs = sim.run()
            sync(device)
            run_s = time.perf_counter() - t0
        launches += counts["launches"]
        delts = np.diff([0.0] + [r.totim for r in recs]).tolist()
        p1 = [r for r in recs if r.kper == 1]
        runs.append((delts[:len(p1)], recs))
        print(f"utilities (b) {attempt} steps={len(recs)} "
              f"period1_delts={delts[:len(p1)]!r} "
              f"retries={[r.retries for r in recs]} "
              f"counts={[(r.outer, r.inner) for r in recs]} run_s={run_s!r} "
              f"stencil7_launches={counts['launches']}")
        if not all(r.converged for r in recs):
            raise AssertionError(f"(b) {attempt}: a step did not converge")
    (d1, r1), (d2, r2), (d3, r3) = runs
    covered = abs(sum(d1) - perlen)
    retries = sum(r.retries for r in r1)
    same = all(np.array_equal(a.head, b.head) for a, b in zip(r1, r2)) \
        and [(r.outer, r.inner, r.retries) for r in r1] == [
            (r.outer, r.inner, r.retries) for r in r2] and d1 == d2
    err = max(float(np.abs(a.head - b.head).max()) for a, b in zip(r1, r3))
    print(f"utilities (b) ats: period 1 covered to {covered!r}, retries="
          f"{retries}, two runs bitwise equal={same}, replay counts equal="
          f"{[(r.outer, r.inner) for r in r1] == [(r.outer, r.inner) for r in r3]} "
          f"max|h_ats - h_replay|={err!r} bar={DECK_FUSED_ATOL!r}")
    if not (covered <= 1e-12 and retries > 0 and same
            and len(set(d1)) == 1 and len(r1) == len(r3)
            and [(r.outer, r.inner) for r in r1] == [(r.outer, r.inner)
                                                     for r in r3]
            and err <= DECK_FUSED_ATOL):
        raise AssertionError("(b) the ATS runs failed their checks")
    return launches


def write_mf2005_deck(ws, shape):
    """The bench grid's top layer as a MODFLOW-2005 deck: LPF with HK as
    one OPEN/CLOSE text array, IBOUND < 0 on the west column (an
    OPEN/CLOSE text array too), CONSTANT elsewhere, four wells and a
    constant recharge, one transient step of 5 days.  Returns (hk, wells,
    ibound)."""
    _, nrow, ncol = shape
    hk = flagship_kfield(*shape)[:nrow * ncol].reshape(nrow, ncol)
    np.savetxt(os.path.join(ws, "hk.txt"), hk)
    ibound = np.ones((nrow, ncol), int)
    ibound[:, 0] = -1
    np.savetxt(os.path.join(ws, "ibound.txt"), ibound, fmt="%d")
    wells = [(nrow // 4, ncol // 4, -300.0), (nrow // 4, 3 * ncol // 4, -200.0),
             (3 * nrow // 4, ncol // 2, -400.0), (nrow // 2, ncol - 2, -100.0)]
    files = {
        "m.nam": "LIST 7 m.lst\nDIS 11 m.dis\nBAS6 12 m.bas\nLPF 13 m.lpf\n"
                 "WEL 14 m.wel\nRCH 15 m.rch\n",
        "m.dis": f"1 {nrow} {ncol} 1 4 2\n0\nCONSTANT 10.0\nCONSTANT 10.0\n"
                 "CONSTANT 50.0\nCONSTANT 0.0\n5.0 1 1.0 TR\n",
        "m.bas": "FREE\nOPEN/CLOSE ibound.txt 1\n999.0\nCONSTANT 40.0\n",
        "m.lpf": "0 1e30 0\n0\n0\n1.0\n0\n0\nOPEN/CLOSE hk.txt 1.0\n"
                 "CONSTANT 1.0\nCONSTANT 1e-5\n",
        "m.wel": f"{len(wells)} 0\n{len(wells)}\n" + "".join(
            f"1 {i + 1} {j + 1} {q!r}\n" for i, j, q in wells),
        "m.rch": "1 0\n1\nCONSTANT 1e-4\n"}
    for name, text in files.items():
        _write(ws, name, text)
    return hk, wells, ibound


def run_utilities_mf5to6(device, shape):
    """(c) A million-cell MODFLOW-2005 deck converted with ``python -m
    modflow6_torch.utils.mf5to6`` and run through the command-line entry,
    against the same model built in memory.  Returns the launches."""
    _, nrow, ncol = shape
    with tempfile.TemporaryDirectory() as root:
        src, out = os.path.join(root, "mf5"), os.path.join(root, "mf6")
        os.makedirs(src)
        t0 = time.perf_counter()
        hk, wells, ibound = write_mf2005_deck(src, shape)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "modflow6_torch.utils.mf5to6",
             os.path.join(src, "m.nam"), out], capture_output=True, text=True,
            timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
        convert_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"mf5to6 failed: {proc.stderr}")
        lst = os.path.join(out, "cli.lst")
        cli_out = io.StringIO()
        with captured_loads(device) as loads, counted_run() as counts, \
                contextlib.redirect_stdout(cli_out):
            t0 = time.perf_counter()
            code = cli_main([out, "--lst", lst]
                            + ([] if torch.device(device).type == "cuda"
                               else ["--device", "cpu"]))
            sync(device)
            cli_s = time.perf_counter() - t0
        sim, load_s = loads[0]
        recs = sim.records
        sizes = {f: os.path.getsize(os.path.join(out, f))
                 for f in sorted(os.listdir(out))}
    # the same model in memory: K as the converter writes it (8 digits)
    k = np.array([float(f"{v:.8g}") for v in hk.reshape(-1)])
    grid = DisGrid.create(1, nrow, ncol, 10.0, 10.0, 50.0,
                          np.zeros((1, nrow, ncol)))
    model = build_gwf(
        "MF5", grid, device=device, k=k, k33=1.0, strt=40.0,
        storage={"ss": 1e-5, "sy": 0.15, "iconvert": 0},
        chd=[(i * ncol, 40.0) for i in range(nrow)],
        wel=[(i * ncol + j, q) for i, j, q in wells],
        rch=[(n, 1e-4) for n in range(nrow * ncol)])
    settings = dataclasses.replace(
        ImsSettings.from_complexity("SIMPLE"), outer_dvclose=1e-6,
        outer_maximum=100, inner_maximum=300, inner_dvclose=1e-8,
        inner_rclose=1e-6, linear_acceleration="bicgstab")
    twin = Simulation(Tdis((StressPeriod(5.0, 1, 1.0),)), model, settings)
    with counted_run() as tcounts:
        t0 = time.perf_counter()
        trecs = twin.run()
        sync(device)
        twin_s = time.perf_counter() - t0
    err = float(np.abs(recs[0].head - trecs[0].head).max())
    print(f"utilities (c) mf5to6 cells={nrow * ncol} written_s={write_s!r} "
          f"convert_s={convert_s!r} cli exit={code} wall_s={cli_s!r} "
          f"load_s={load_s!r} solve_s={recs[0].solve_seconds!r} "
          f"counts={[(r.outer, r.inner) for r in recs]} twin counts="
          f"{[(r.outer, r.inner) for r in trecs]} twin_run_s={twin_s!r} "
          f"max|h_deck - h_twin|={err!r} bar={DECK_FUSED_ATOL!r} "
          f"settings_equal={vars(sim.solution.s) == vars(settings)} "
          f"stencil7_launches={counts['launches']}+{tcounts['launches']} "
          f"files={sizes} converter={proc.stdout.strip()!r} "
          f"stdout={cli_out.getvalue().strip()!r}")
    if code != 0 or not recs[0].converged \
            or [(r.outer, r.inner) for r in recs] != [(r.outer, r.inner)
                                                      for r in trecs] \
            or not err <= DECK_FUSED_ATOL \
            or vars(sim.solution.s) != vars(settings):
        raise AssertionError("(c) the converted deck differs from the "
                             "in-memory model")
    return counts["launches"] + tcounts["launches"]


def run_utilities(device, shape=BENCH_SHAPE):
    """The utilities phase: (a) the series-driven, observed deck, (b) ATS
    with retries on it, (c) mf5to6 on the grid's top layer.  Returns the
    stencil7 launches, which must be some: every model here keeps its
    grid shape."""
    t0 = time.perf_counter()
    launches, ws = run_utilities_deck(device, shape)
    try:
        launches += run_utilities_ats(device, ws)
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    launches += run_utilities_mf5to6(device, (1,) + tuple(shape[1:]))
    print(f"utilities phase in {time.perf_counter() - t0!r} s, "
          f"stencil7_launches={launches}")
    if not launches:
        raise AssertionError("the utilities runs launched no stencil7 "
                             "kernel")
    return launches


def _device_us(evt, self_time=True):
    """Device time of a profiler row in microseconds (the attribute's name
    changed across PyTorch versions)."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_time
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return getattr(evt, name)
    raise AttributeError(f"profiler row has none of {names}")


def host_us_per_call(fn, calls=2000):
    """Host time of one call of fn, launches queued without a sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def flagship_disv(device):
    """The bench model on a DISV grid of square cells (the general path)."""
    nlay, nrow, ncol = BENCH_SHAPE
    grid = quad_disv(nlay, nrow, ncol, 10.0, 50.0,
                     flagship_botm(nlay, nrow * ncol))
    return build_gwf("disv", grid, k=flagship_kfield(*BENCH_SHAPE),
                     strt=40.0, storage={"ss": 1e-5, "iconvert": 0},
                     device=device, **flagship_stresses(nrow, ncol))


def profile_bench(device, preconditioner="jacobi", grid="dis"):
    """The bench configuration's first step in each precision with the given
    preconditioner, on the DIS grid (structured path) or on the DISV grid
    of square cells (general path): its wall time without the profiler,
    then its device time by op under torch.profiler; and the host time per
    call of the matvec wrapper against a torch.mul of two elements."""
    from torch.profiler import ProfilerActivity, profile
    from modflow6_torch.models.gwf.npf import DeviceTopology
    model = (flagship(*BENCH_SHAPE, device) if grid == "dis"
             else flagship_disv(device))
    for precision in ("f64", "mixed"):
        step = make_fused_step(
            model, ImsSettings(**BENCH, precision=precision,
                               preconditioner=preconditioner), iss=False)
        step(model.strt, 5.0, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, kiter, inner, conv = step(model.strt, 5.0, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(model.strt, 5.0, 1)
            torch.cuda.synchronize()
        rows = prof.key_averages()
        kernels = [r for r in rows if r.device_type.name == "CUDA"]
        device_us = sum(_device_us(r) for r in kernels)
        print(f"profile grid={grid} precision={precision} "
              f"preconditioner={preconditioner} outer={kiter} inner={inner} "
              f"converged={conv} step_wall_s={wall!r} "
              f"ms_per_inner={wall / inner * 1e3!r} "
              f"device_s={device_us / 1e6!r} "
              f"busy_share={device_us / 1e6 / wall!r}")
        ops = [r for r in rows if r.device_type.name == "CPU"
               and _device_us(r) > 0]
        ops += [r for r in kernels if "stencil7" in r.key]
        for r in sorted(ops, key=_device_us, reverse=True)[:12]:
            name = "stencil7 kernel" if "stencil7" in r.key else r.key
            print(f"  {name}: device_ms={_device_us(r) / 1e3!r} "
                  f"share={_device_us(r) / device_us!r} calls={r.count}")
    shape = (1, 2, 2)
    a = torch.ones(2, dtype=torch.float64, device=device)
    diag, off, x = stencil_inputs(shape, torch.float64, device, 0)
    matvec = make_matvec(DeviceTopology(shape), diag, off)
    mul_us = host_us_per_call(lambda: a * a)
    bound_us = host_us_per_call(lambda: matvec(x))
    once_us = host_us_per_call(
        lambda: stencil.stencil7(shape, diag, off, x))
    print(f"host_us_per_call shape={shape} torch.mul={mul_us!r} "
          f"make_matvec={bound_us!r} stencil7={once_us!r}")


PHASES = ("kernel", "small", "bench", "precond", "deck", "newton",
          "unstructured", "properties", "advanced", "coupling", "utilities")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile the bench configuration's first step "
                             "instead of the smoke run")
    parser.add_argument("--preconditioner", default="jacobi",
                        choices=["jacobi", "chebyshev", "mg"],
                        help="the preconditioner of the profiled step")
    parser.add_argument("--grid", default="dis", choices=["dis", "disv"],
                        help="the grid of the profiled step: the DIS bench "
                             "grid or the same cells as a DISV grid")
    parser.add_argument("--newton-preconditioner", default="chebyshev",
                        choices=["jacobi", "chebyshev", "mg"],
                        help="the preconditioner of the unconfined Newton "
                             "deck at full width")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated phases to run (default: all, "
                             f"which the result lines need): {PHASES}")
    args = parser.parse_args()
    phases = args.phases.split(",")
    if set(phases) - set(PHASES):
        parser.error(f"unknown phase in {phases}")
    device = cuda_device()
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip())

    t0 = time.perf_counter()
    lib_path, log = stencil.build()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.strip().splitlines():
        print(f"  nvcc: {line}")
    if args.profile:
        profile_bench(device, args.preconditioner, args.grid)
        return

    launches = {}
    if "kernel" in phases:
        worst, times = check_kernel(device)
    if "small" in phases:
        check_small_model(device)
        check_small_preconditioned(device)
        check_small_deck(device)
        check_small_newton(device)
        check_small_general(device)
        check_small_coupling(device)
    if "bench" in phases:
        launches["fused"], _, _, mixed_inners, _ = run_bench(device, "mixed")
        f64_launches, fused_head, kiters, inners, _ = run_bench(device, "f64")
        launches["fused"] += f64_launches
    if "precond" in phases:
        measure_preconditioner_apply(device)
        jacobi_inner = {"f64": sum(inners), "mixed": sum(mixed_inners)}
        launches["preconditioned"] = sum(
            run_bench(device, precision, pc,
                      jacobi=(fused_head, jacobi_inner[precision]))[0]
            for pc in ("chebyshev", "mg") for precision in ("mixed", "f64"))
    if "deck" in phases:
        launches["deck"] = run_deck_bench(device, fused_head,
                                          list(zip(kiters, inners)))
        launches["deck"] += run_deck_preconditioned(device, fused_head,
                                                    sum(inners))
    if "newton" in phases:
        launches["newton"] = run_newton_deck(device,
                                             args.newton_preconditioner)
    if ("unstructured" in phases or "properties" in phases) \
            and "bench" not in phases:
        _, fused_head, kiters, inners, _ = run_bench(device, "f64")
    if "unstructured" in phases:
        run_disv_oracle(device, fused_head, list(zip(kiters, inners)))
        run_brick(device)
        run_brick_deck(device)
        launches["general"] = run_rotated(device)
    if "properties" in phases:
        launches["properties"] = run_properties(device, fused_head)
    if "advanced" in phases:
        advanced_launches = run_advanced(device)
    if "coupling" in phases:
        launches["coupling"] = run_coupling(device)
    if "utilities" in phases:
        launches["utilities"] = run_utilities(device)
    if set(phases) != set(PHASES):
        print(f"phases {phases} passed; the result lines need all phases")
        return
    if not all(launches.values()):
        raise AssertionError(f"a main path launched no stencil7 kernel: "
                             f"{launches}")

    ms, plain_ms, one_call_ms = times["f64"]
    ms32, plain_ms32, one_call_ms32 = times["f32"]
    print(json.dumps({"kernels": [{
        "name": "stencil7", "route": "cuda",
        "source": "modflow6_torch/csrc/stencil7.cu",
        "replaces": "modflow6_tpu/ops/pallas_stencil.py:29",
        "launches": sum(launches.values()),
        "launches_fused_path": launches["fused"],
        "launches_preconditioned_fused_path": launches["preconditioned"],
        "launches_deck_path": launches["deck"],
        "launches_newton_deck_path": launches["newton"],
        "launches_general_assembly_path": launches["general"],
        "launches_properties_path": launches["properties"],
        "launches_advanced_path": advanced_launches,
        "launches_coupling_path": launches["coupling"],
        "launches_utilities_path": launches["utilities"],
        "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": stencil_bound_ms(BENCH_SHAPE, torch.float64),
        "bound_by": "bytes", "library_ms": None,
        "ms_one_call_host_inclusive": one_call_ms,
        "ms_f32": ms32, "plain_ms_f32": plain_ms32,
        "bound_ms_f32": stencil_bound_ms(BENCH_SHAPE, torch.float32),
        "ms_f32_one_call_host_inclusive": one_call_ms32}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
