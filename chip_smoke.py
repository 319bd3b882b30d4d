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
CSUB, BUY/VSC and TVK/TVS twins on the card against the CPU.

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
general-path runs, the property-package runs, one JSON line
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
from modflow6_torch.models.gwf.builder import build_gwf      # noqa: E402
from modflow6_torch.models.gwf.gnc import build_gnc          # noqa: E402
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
               rcha=None, oc_last=False, newton=None, linear_extra=""):
    """Write an MF6 input deck for one DIS GWF model into ``ws``.

    ``kfield`` goes into an OPEN/CLOSE (BINARY) array file (a 52-byte
    header, then float64 values) that NPF reads for K; ``botm`` is one
    elevation per layer; ``chd`` and ``wel`` are 1-based (k, i, j, value)
    rows, CHD given in period 1, WEL from ``wel_period``; ``tdis`` is
    [(perlen, nstp, tsmult)]; ``sto_periods`` one keyword per period;
    ``rcha`` a constant READASARRAYS recharge; ``oc_last`` saves heads and
    budget at the last step of each period; ``newton`` is the name file's
    NEWTON option line; ``linear_extra`` a further line of the IMS LINEAR
    block."""
    nlay, nrow, ncol = shape
    packages = ["DIS6 m.dis", "IC6 m.ic", "NPF6 m.npf", "STO6 m.sto",
                "CHD6 m.chd", "WEL6 m.wel"]
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
    _write(ws, "m.wel", f"""BEGIN DIMENSIONS
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
END PERIOD
""")
    options = f"BEGIN OPTIONS\n  {newton}\nEND OPTIONS\n" if newton else ""
    _write(ws, "m.nam", options + "BEGIN PACKAGES\n"
           + "".join(f"  {line}\n" for line in packages) + "END PACKAGES\n")


def write_flagship_deck(ws, nlay, nrow, ncol, unconfined=False,
                        linear_extra=""):
    """``flagship(nlay, nrow, ncol)`` as a deck: one period of three steps
    of 5.0, bench.py's IMS settings with CG, heads and budget saved at the
    last step.  ``unconfined``: the same grid, K field and stresses with
    every cell convertible (ICELLTYPE 1, ICONVERT 1, SY 0.1; the water
    table lies in layer 1), NEWTON UNDER_RELAXATION and BICGSTAB."""
    write_deck(
        ws, name="FLAGSHIP", shape=(nlay, nrow, ncol), delr=10.0, top=50.0,
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
          "unstructured", "properties")


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
