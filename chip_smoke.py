"""GPU smoke run of modflow6_torch: builds the CUDA stencil kernel, checks
it against its plain PyTorch version (at the bench shape, at odd shapes and
at every level shape of the multigrid hierarchy) and times one CSR product
of the same system (cuSPARSE through ``torch.mv``) as its yardstick, builds
the fused Jacobi-CG kernels and checks each against its plain version
(``pcg``: direction, product with dot, update, finish, in f64 and f32) and
times them at the bench shape and at 1x2048x2048, builds the fused
Jacobi-BiCGSTAB kernels on the ELL system and checks each against its plain
version (``bicgstab``: direction, the two products with their dots,
half-step, update, finish, in f64 and f32) and times them at 1024x1x2048
(the Henry cell's section) and at the bench shape, checks
the fused transient solve on the card against the CPU and a direct solve,
runs the bench configuration (4x1024x1024 cells, 3 steps) in ``mixed``
and ``f64`` through ``modflow6_torch.bench``'s build and timed run (the
``mixed`` run then the scipy baseline and the benchmark's JSON line) and
through the fused run with the Chebyshev and multigrid preconditioners,
runs the same model as an MF6 input deck through the deck
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
once (no stencil launch: the augmented table has no grid shape; the apt
phase repeats these features, with movers, and holds the repeat bitwise),
the same model as a MAW6/LAK6/SFR6 deck with a second period
through the command-line entry, the gather product at the table's width,
and small MAW, LAK, SFR and repeated-sum twins on the card against the
CPU; and the coupling (``coupling``): UZF columns on every top cell of the
bench grid through ``Simulation``, and its first step again (bitwise
equal, the structured solve through the stencil kernel), and as a UZF6
deck with a second period through the command-line entry, about 320
movers on the advanced phase's model once (the apt phase's (a1) runs it
and its first step again, bitwise, and its (a2) as
an MVR6 deck with transport), and the bench grid split
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
built in memory; and the transport (``transport``): a contaminant plume
(TVD, dispersion, decay, sorption, a constant-concentration block, mass
sources, recharge at a concentration) on the bench model over a 5-d and a
yearly period through ``Simulation``, and its first step again (bitwise
equal; the flow through the stencil kernel, the transport through the ELL
gather), its first step as a GWF6 + GWT6 deck through the command-line
entry against the repeat (bitwise), and
the seawater wedge with BUY and VSC reading the transport's concentration
with MXITER 3, twice, against MXITER 1; with small transport twins
(schemes, sorption, IST, SRC/CNC, ATS_PERCEL, two merged models) on the
card against the CPU in the ``small`` phase; and the advanced-package
transport (``apt``): the coupling phase's mover model (1024 wells, 256
lakes, 4160 reaches, 323 movers) with the plume's GWT model and a
concentration row per feature (SFT inflow at 1.0 on the headwater
reaches, LKT rain at 0.0, MWT on the pumping wells) through
``Simulation``, and its first step again (bitwise equal), that step as a
GWF6 + GWT6 deck with LKT6/SFT6/MWT6/MVT6 through the command-line entry
(its .ucn bitwise equal to the repeat's), and UZT on the coupling phase's
million UZF columns
(no model here has a grid shape: no stencil7 launch); and heat (``gwe``):
the bench model with a GWE model (TVD, EST, CND, CTP at 80 °C, ESL,
recharge at 25 °C) over the plume's steps, and its first step again
(bitwise equal; its flow through the stencil kernel), that step as a
GWF6 + GWE6 deck through the command-line entry (bitwise), and the mover
model with LKE/SFE/MWE rows once; with
small APT and GWE twins on the card against the CPU in the ``small``
phase; and surface water (``swf``): an overland raster of 1,048,576 cells
(OLF on DIS2D) through ``SwfSimulation`` and as an OLF6 deck through the
command-line entry (its STAGE file bitwise equal to the in-memory run), a
16,383-reach channel network with n-point sections over the bench aquifer
through ``CoupledSwfGwf`` (the aquifer's solves through the stencil
kernel), and the network alone in memory and as a CHF6 deck (bitwise);
and particles (``prt``): 1,048,576 particle slots on the bench model
through ``Simulation`` with a ``PrtDriver`` twice (bitwise) and as a GWF6 +
PRT6 deck (its track file bitwise equal), and 524,288 slots on the brick
DISV grid by the ternary method (its first step twice, bitwise); with small
SWF and PRT twins on the card against the CPU in the ``small`` phase; and
the sharded runners (``parallel``, four shards on the one card): the bench
configuration as row shards through ``ShardedSolution`` in ``f64`` and
``mixed`` (one stencil launch per shard and product, shard 0's product
bitwise equal to the plain one) against the bench runs' heads, the brick
DISV grid through ``partition_general`` against the unstructured phase's
heads, the advanced model's first step through the augmented split, and
the plume's first three steps through ``GeneralCoupledSolution``; and the
API (``api``): ``Mf6Api``'s XMI loop over the bench deck against the deck
run, a get_value/set_value round trip on the card, and the bench model
checkpointed after its first step and resumed in a fresh ``Simulation``
(bitwise); and the entry scripts (``entry``): ``entry()``'s step on the
card against the CPU, ``dryrun_multichip(4)`` (its row shards through the
stencil kernel; each run against its single-device solve),
``iteration_study``'s 75x75 rows against their CPU counts, and
``halo_study`` at 4x128x128 on four shards.  The deck phase's
command-line run takes ``-l summary``: its listing holds the profiler's
sections and the memory report.  The
value checks of the transport runs hold the grid rows and the wells',
lakes' and UZT columns' rows whose water balance closes to the sources'
range; a reach's flow has no storage where its transport has its volume,
so a reach that dries concentrates its mass (R19 in ROADMAP Queue C): the
reaches' values are reported, not bounded.

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

Output of the smoke run, in order: the device, the kernel builds,
kernel-vs-plain checks with times, the fused Jacobi-CG kernels' checks
with times, the small-model checks, the bench
runs, the preconditioner runs, the deck runs, the Newton runs, the
general-path runs, the property-package runs, the advanced-package runs,
the coupling runs, the utilities runs, the transport runs, the apt runs,
the gwe runs, the swf runs, the prt runs, the parallel runs, the api runs,
the entry runs, one JSON line
``{"kernels": [...]}``, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import collections
import contextlib
import dataclasses
import hashlib
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

from modflow6_torch import bench as bench_mod                # noqa: E402
from modflow6_torch import cuda_device                       # noqa: E402
from modflow6_torch import entry as entry_mod                # noqa: E402
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
from modflow6_torch.models.gwe.builder import build_gwe      # noqa: E402
from modflow6_torch.models.gwt.apt import AugmentedGwtModel  # noqa: E402
from modflow6_torch.models.gwt.builder import build_gwt      # noqa: E402
from modflow6_torch.models.simulation import Simulation      # noqa: E402
from modflow6_torch.ops import stencil                       # noqa: E402
from modflow6_torch.ops.solvers import bicgstab_ell, pcg_jacobi  # noqa: E402
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
from modflow6_torch.timing import ats as ats_mod              # noqa: E402
from modflow6_torch.timing.tdis import StressPeriod, Tdis     # noqa: E402
from modflow6_torch.utils.mf6io import load_simulation       # noqa: E402
from modflow6_torch.utils.oc import OutputControl            # noqa: E402
from modflow6_torch.utils import profiler                     # noqa: E402
from modflow6_torch.api import Mf6Api                        # noqa: E402
from modflow6_torch.bench import (BENCH, flagship,           # noqa: E402
                                  flagship_args, flagship_botm,
                                  flagship_grid, flagship_kfield,
                                  flagship_stresses)
from modflow6_torch.entry import ENTRY                       # noqa: E402
from modflow6_torch.tools import halo_study, iteration_study  # noqa: E402
from modflow6_torch.parallel import (ShardedSolution,        # noqa: E402
                                     partition_model)
from modflow6_torch.parallel.augmented import (              # noqa: E402
    ShardedAugmentedSolution, partition_augmented)
from modflow6_torch.parallel.general import (                # noqa: E402
    GeneralShardedSolution, partition_general)
from modflow6_torch.parallel.transport import (              # noqa: E402
    GeneralCoupledSolution, partition_coupled)
from modflow6_torch.utils.checkpoint import (                # noqa: E402
    resume_simulation, save_checkpoint)

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
# the tight settings of tests/test_fused.py:14-18
TIGHT = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-10,
             inner_rclose=1e-9, inner_maximum=2000)
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
            library_ms = library_csr(shape, diag, off, x, y, name)
            times[name] = (ms, plain_ms, one_call_ms, library_ms)
    return worst, times


# shapes at which the fused Jacobi-CG kernels are timed: the bench grid
# and the benchmark cell's one-layer grid
PCG_TIMED_SHAPES = (BENCH_SHAPE, (1, 2048, 2048))
# bytes a cell that each fused kernel moves in float64 (half in float32):
# direction reads inv, d, p and writes p; the product reads diag, the six
# coefficients and p and writes q; the update reads inv, p, q, x, d and
# writes x and d
PCG_BYTES_F64 = {"direction": 32, "product": 72, "update": 56}


def _pcg_state(shape, dtype, device, seed):
    """Inputs for one fused iteration: the system, D^-1, random x, d, p,
    and the kernels' and the plain versions' buffers holding the same
    scalars (rho0, rho)."""
    diag, off, x = stencil_inputs(shape, dtype, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    inv = 1.0 / diag
    system = (shape, diag, off)
    bufs = {}
    for name, ops in (("kernel", pcg_jacobi.Kernels),
                      ("plain", pcg_jacobi.Plain)):
        nparts = ops.nparts(diag.numel(), dtype, device)
        buf = pcg_jacobi.Buffers(system, x.clone(), torch.zeros_like(x), inv,
                                 nparts, torch.tensor(1e-3, device=device,
                                                      dtype=torch.float64))
        bufs[name] = buf
    d = torch.randn(x.shape, dtype=dtype, device=device, generator=gen)
    p = torch.randn(x.shape, dtype=dtype, device=device, generator=gen)
    for buf in bufs.values():
        buf.x.copy_(x)
        buf.d.copy_(d)
        buf.p.copy_(p)
        buf.s[pcg_jacobi.RHO0] = 3.0
        buf.s[pcg_jacobi.RHO] = 2.0
    ops = {name: cls(system, inv, bufs[name], 0, 1e-12, 1e-12)
           for name, cls in (("kernel", pcg_jacobi.Kernels),
                             ("plain", pcg_jacobi.Plain))}
    return system, inv, bufs, ops


def _sum_bar(terms, dtype):
    """How far two orders of one sum may differ: 1e-12 (float64) or 1e-4
    (float32) of the sum of the terms' magnitudes, far above the
    (log2 N + N / threads) u of either order."""
    return (1e-12 if dtype == torch.float64 else 1e-4) * float(terms)


def check_pcg(device):
    """The fused Jacobi-CG kernels against their plain versions, one by one
    from the same state: the vectors bitwise (the same products and sums,
    rounded alike), the reductions within ``_sum_bar`` of the plain sums,
    the maxima and their choice exactly.  Then the time of each kernel and
    of a whole iteration (the four back to back, no flag read) at
    ``PCG_TIMED_SHAPES``.  Returns the times by (shape, dtype)."""
    P = pcg_jacobi
    times = {}
    shapes = KERNEL_SHAPES + tuple(s for s in PCG_TIMED_SHAPES
                                   if s not in KERNEL_SHAPES)
    cases = [(s, dt) for s in shapes for dt in (torch.float64, torch.float32)]
    for seed, (shape, dtype) in enumerate(cases):
        system, inv, bufs, ops = _pcg_state(shape, dtype, device, 100 + seed)
        k, pl = bufs["kernel"], bufs["plain"]
        name = "f64" if dtype == torch.float64 else "f32"
        for first in (True, False):
            ops["kernel"].direction(first)
            ops["plain"].direction(first)
            if not torch.equal(k.p, pl.p):
                raise AssertionError(f"pcg direction (first={first}) "
                                     f"differs from its plain version at "
                                     f"{shape} {name}")
        before = profiler.launches["stencil7"]
        ops["kernel"].product()
        ops["plain"].product()
        if profiler.launches["stencil7"] != before + 1:
            raise AssertionError("the product was not counted as stencil7")
        y = stencil.stencil7(shape, system[1], system[2], k.p)
        pq_err = abs(float(k.parts[P.PQ].sum() - pl.parts[P.PQ, 0]))
        pq_bar = _sum_bar((k.p * k.q).abs().sum(), dtype)
        if not (torch.equal(k.q, pl.q) and torch.equal(k.q, y)
                and pq_err <= pq_bar):
            raise AssertionError(f"pcg product differs at {shape} {name}: "
                                 f"p.q off by {pq_err} (bar {pq_bar})")
        # the update from one p.q: the plain sum in the kernel's first
        # partial, zeros in the rest, so both take the same alpha
        k.parts[P.PQ].zero_()
        k.parts[P.PQ, 0] = pl.parts[P.PQ, 0]
        ops["kernel"].update()
        ops["plain"].update()
        dd_err = abs(float(k.parts[P.DD].sum() - pl.parts[P.DD, 0]))
        rd_err = abs(float(k.parts[P.RD].sum() - pl.parts[P.RD, 0]))
        dd_bar = _sum_bar((k.d * k.d).sum(), dtype)
        rd_bar = _sum_bar((k.d * (inv * k.d)).abs().sum(), dtype)
        maxima = [P._absmax_of_parts(k.parts[row], k.iparts[irow])
                  for row, irow in ((P.TV, P.TV_IDX), (P.D, P.D_IDX))]
        if not (torch.equal(k.x, pl.x) and torch.equal(k.d, pl.d)
                and torch.equal(maxima[0], pl.parts[P.TV, 0])
                and torch.equal(maxima[1], pl.parts[P.D, 0])
                and dd_err <= dd_bar and rd_err <= rd_bar):
            raise AssertionError(f"pcg update differs at {shape} {name}: "
                                 f"d.d off by {dd_err} (bar {dd_bar}), "
                                 f"rho by {rd_err} (bar {rd_bar})")
        # the finish from the kernel's partials, in both versions
        pl.parts, pl.iparts = k.parts.clone(), k.iparts.clone()
        ops["kernel"].finish(1)
        ops["plain"].finish(1)
        s_err = float((k.s - pl.s).abs().max())
        s_bar = _sum_bar(pl.s.abs().max(), dtype)
        if not (torch.equal(k.flags, pl.flags) and s_err <= s_bar
                and torch.equal(k.s[P.DVMAX:P.RMAX + 1],
                                pl.s[P.DVMAX:P.RMAX + 1])):
            raise AssertionError(f"pcg finish differs at {shape} {name}: "
                                 f"{k.s.tolist()} {k.flags.tolist()} vs "
                                 f"{pl.s.tolist()} {pl.flags.tolist()}")
        line = (f"pcg {name} shape={shape} nparts={k.parts.shape[1]} "
                f"checks passed: p, q, x, d bitwise; p.q err={pq_err!r} "
                f"d.d err={dd_err!r} rho err={rd_err!r}")
        if shape in PCG_TIMED_SHAPES:
            kops = ops["kernel"]
            k.s.fill_(1.0)      # beta = 1: p stays finite
            n = shape[0] * shape[1] * shape[2]
            es = torch.empty((), dtype=dtype).element_size() / 8
            row = {}
            for kname, fn in (("direction", lambda: kops.direction(False)),
                              ("product", kops.product),
                              ("update", kops.update),
                              ("finish", lambda: kops.finish(1))):
                ms = back_to_back_ms(fn)
                bound = (PCG_BYTES_F64[kname] * es * n / HBM_BYTES_PER_S
                         * 1e3 if kname in PCG_BYTES_F64 else None)
                row[kname] = (ms, bound)
                line += (f" {kname}_ms={ms!r}" + (
                    f" {kname}_bound_ms={bound!r} {kname}_share="
                    f"{bound / ms!r}" if bound else ""))

            def iteration():
                kops.direction(False)
                kops.product()
                kops.update()
                kops.finish(1)
            row["iteration"] = (back_to_back_ms(iteration), sum(
                b for _, b in row.values() if b))
            pops = ops["plain"]
            pl.s.fill_(1.0)

            def plain_iteration():
                pops.direction(False)
                pops.product()
                pops.update()
                pops.finish(1)
            plain_ms = back_to_back_ms(plain_iteration, launches=10,
                                       runs=5, warmup=2)
            line += (f" iteration_ms={row['iteration'][0]!r} "
                     f"iteration_bound_ms={row['iteration'][1]!r} "
                     f"plain_iteration_ms={plain_ms!r}")
            times[(shape, name)] = row
        print(line)
    return times



# shapes at which the fused Jacobi-BiCGSTAB kernels are timed: the Henry
# cell's section and the bench grid
BICG_TIMED_SHAPES = ((1024, 1, 2048), BENCH_SHAPE)
# widths of random ELL tables on which the products are held to spmv: every
# number of lanes of the products' row order (1 to 32)
BICG_WIDTHS = (1, 2, 3, 5, 7, 12, 18, 40, 127)


def bicg_bytes(step, k, es, ib):
    """Bytes a cell that a step of the fused Jacobi-BiCGSTAB iteration
    moves (its kernel and its sums), with K = k slots, values of es bytes
    and indices of ib: direction reads inv, d, p, v and writes p, phat;
    product_v reads diag, the slots' coefficients and indices, phat and
    dhat, writes v and w, and sums w; the half-step reads inv, d, v and
    writes q, qhat; product_t reads diag, the slots, qhat and q, writes t,
    w and w2, and sums both; the update reads phat, qhat, q, t, dhat and x,
    writes x, d, w and w2, and sums both."""
    return {"direction": 6 * es, "product_v": 6 * es + k * (es + ib),
            "half_step": 5 * es, "product_t": 8 * es + k * (es + ib),
            "update": 12 * es}.get(step)


def ell_inputs(shape, dtype, device, seed):
    """The random system of ``stencil_inputs`` as an ELL table: (nbr, diag,
    off, x), the slots [E, W, N, S, U, D], a slot without a neighbour
    pointing at its own row with coefficient 0."""
    diag, off, x = stencil_inputs(shape, dtype, device, seed)
    nlay, nrow, ncol = shape
    idx = torch.arange(diag.numel(), device=device)
    coords = ((idx // (nrow * ncol), nlay, nrow * ncol),
              (idx // ncol % nrow, nrow, ncol), (idx % ncol, ncol, 1))
    cols = []
    for axis, d in SLOTS:
        coord, size, step = coords[axis]
        inside = (coord + d >= 0) & (coord + d < size)
        cols.append(torch.where(inside, idx + d * step, idx))
    return torch.stack(cols, dim=1).contiguous(), diag, off, x


def _bicg_state(ell, x, dtype, device, seed):
    """The kernels' and the plain versions' buffers and steps for one
    fused iteration on the ELL system ``ell``, holding the same random
    vectors and scalars."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    inv = 1.0 / ell[1]
    n, k = ell[0].shape
    vecs = {name: torch.randn(x.shape, dtype=dtype, device=device,
                              generator=gen)
            for name in ("d", "dhat", "p", "v")}
    bufs, ops = {}, {}
    for name, cls in (("kernel", bicgstab_ell.Kernels),
                      ("plain", bicgstab_ell.Plain)):
        buf = bicgstab_ell.Buffers(
            ell, x.clone(), torch.zeros_like(x),
            cls.nparts(n, k, dtype, device),
            torch.tensor(1e-3, device=device, dtype=torch.float64))
        for vname, vec in vecs.items():
            getattr(buf, vname).copy_(vec)
        buf.x.copy_(x)
        buf.s[:6] = torch.tensor([3.0, 2.0, 0.5, 0.75, 0.25, 0.5])
        bufs[name] = buf
        ops[name] = cls(ell, inv, buf, 0, 1e-12, 1e-12)
    return bufs, ops


# each step of the fused iteration and the buffers it writes
BICG_STEPS = (("direction", ("p", "phat")), ("product_v", ("v", "w", "sums")),
              ("half_step", ("q", "qhat", "s")),
              ("product_t", ("t", "w", "w2", "sums")),
              ("update", ("x", "d", "w", "w2", "sums", "s")),
              ("finish", ("s", "flags")))


def _bicg_steps(bufs, ops, where):
    """Each step of the kernels and of the plain versions from the same
    state: every buffer it writes bitwise alike (the maxima by block
    combined as the finish combines them)."""
    k, pl = bufs["kernel"], bufs["plain"]
    B = bicgstab_ell
    for first in (True, False):
        for step, names in BICG_STEPS:
            for o in ops.values():
                fn = getattr(o, step)
                fn(first) if step == "direction" else (
                    fn(0) if step == "finish" else fn())
            same = [n for n in names
                    if torch.equal(getattr(k, n), getattr(pl, n))]
            if step == "update":
                same += ["maxima"] if all(torch.equal(
                    B._absmax_of_parts(k.parts[row], k.iparts[row]),
                    pl.parts[row, 0]) for row in (B.TV, B.D)) else []
                names = names + ("maxima",)
            if len(same) != len(names):
                raise AssertionError(
                    f"bicgstab {step} (first iteration: {first}) differs "
                    f"from its plain version {where}: "
                    f"{sorted(set(names) - set(same))}")


def check_bicgstab(device):
    """The fused Jacobi-BiCGSTAB kernels against their plain versions, step
    by step from the same state through two iterations: every buffer
    bitwise (the products add their slots in torch.sum's order; the dot
    products are torch.sum's), on 7-point systems and on random ELL tables
    of every width in ``BICG_WIDTHS``.  Then the time of each step (its
    kernel and its sums) and of a whole iteration (the six back to back,
    no flag read) at ``BICG_TIMED_SHAPES``, with their bounds at
    ``HBM_BYTES_PER_S``.  Returns the times by (shape, dtype)."""
    times = {}
    shapes = ((3, 37, 45), (1, 5, 129)) + BICG_TIMED_SHAPES
    cases = [(s, dt) for s in shapes for dt in (torch.float64, torch.float32)]
    for seed, (shape, dtype) in enumerate(cases):
        nbr, diag, off, x = ell_inputs(shape, dtype, device, 200 + seed)
        ell = (nbr, diag, off)
        name = "f64" if dtype == torch.float64 else "f32"
        bufs, ops = _bicg_state(ell, x, dtype, device, 200 + seed)
        _bicg_steps(bufs, ops, f"at {shape} {name}")
        kops = ops["kernel"]
        line = (f"bicgstab {name} shape={shape} nparts={kops.nparts} "
                f"index={kops.nbr.dtype} checks passed: every step "
                f"bitwise its plain version over two iterations")
        if shape in BICG_TIMED_SHAPES:
            k = bufs["kernel"]
            k.s.fill_(1.0)      # beta = alpha = omega = 1: bounded vectors
            n, nk = nbr.shape
            es = torch.empty((), dtype=dtype).element_size()
            ib = kops.nbr.element_size()
            row = {}
            for step, _ in BICG_STEPS:
                fn = getattr(kops, step)
                call = ((lambda fn=fn: fn(False)) if step == "direction"
                        else (lambda fn=fn: fn(1)) if step == "finish"
                        else fn)
                ms = back_to_back_ms(call)
                per_cell = bicg_bytes(step, nk, es, ib)
                bound = (per_cell * n / HBM_BYTES_PER_S * 1e3
                         if per_cell else None)
                row[step] = (ms, bound)
                line += (f" {step}_ms={ms!r}" + (
                    f" {step}_bound_ms={bound!r} {step}_share="
                    f"{bound / ms!r}" if bound else ""))

            def iteration(o):
                o.direction(False)
                o.product_v()
                o.half_step()
                o.product_t()
                o.update()
                o.finish(1)
            row["iteration"] = (back_to_back_ms(lambda: iteration(kops)),
                                sum(b for _, b in row.values() if b))
            bufs["plain"].s.copy_(k.s)
            plain_ms = back_to_back_ms(lambda: iteration(ops["plain"]),
                                       launches=10, runs=5, warmup=2)
            it_ms, it_bound = row["iteration"]
            line += (f" iteration_ms={it_ms!r} iteration_bound_ms="
                     f"{it_bound!r} iteration_share={it_bound / it_ms!r} "
                     f"plain_iteration_ms={plain_ms!r}")
            times[(shape, name)] = row
        print(line)
    for seed, width in enumerate(BICG_WIDTHS):
        for dtype in (torch.float64, torch.float32):
            n = 50_000
            gen = torch.Generator(device=device).manual_seed(300 + seed)
            nbr = torch.randint(0, n, (n, width), device=device,
                                generator=gen)
            off = torch.randn(n, width, dtype=dtype, device=device,
                              generator=gen) * torch.exp(4.0 * torch.randn(
                                  n, width, dtype=dtype, device=device,
                                  generator=gen))
            diag = torch.randn(n, dtype=dtype, device=device,
                               generator=gen) - 7.0
            x = torch.randn(n, dtype=dtype, device=device, generator=gen)
            bufs, ops = _bicg_state((nbr, diag, off), x, dtype, device,
                                    300 + seed)
            _bicg_steps(bufs, ops, f"at K = {width} {dtype}")
    print(f"bicgstab random ELL tables of widths {BICG_WIDTHS} in f64 and "
          "f32: every step bitwise its plain version over two iterations")
    return times

def csr_of_planes(shape, diag, off):
    """The 7-point system as one CSR tensor on the planes' device: int32
    row and column indices, each row's structural entries (its neighbours
    inside the grid) in ascending column order U, N, W, diagonal, E, S, D."""
    nlay, nrow, ncol = shape
    ncpl = nrow * ncol
    n = nlay * ncpl
    idx = torch.arange(n, device=diag.device)
    k, i, j = idx // ncpl, idx % ncpl // ncol, idx % ncol
    # (plane slot, column offset, neighbour inside the grid); the planes'
    # slots are [E, W, N, S, U, D]
    entries = ((4, -ncpl, k > 0), (2, -ncol, i > 0), (1, -1, j > 0),
               (None, 0, torch.ones_like(k, dtype=torch.bool)),
               (0, 1, j < ncol - 1), (3, ncol, i < nrow - 1),
               (5, ncpl, k < nlay - 1))
    vals = torch.stack([diag if slot is None else off[:, slot]
                        for slot, _, _ in entries], dim=1)
    cols = torch.stack([idx + d for _, d, _ in entries], dim=1)
    keep = torch.stack([inside for _, _, inside in entries], dim=1)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=diag.device)
    crow[1:] = keep.sum(dim=1).cumsum(0)
    return torch.sparse_csr_tensor(
        crow.to(torch.int32), cols[keep].to(torch.int32), vals[keep],
        size=(n, n), check_invariants=True)


def csr_bytes(a):
    """Bytes one CSR product y = A x must move: the values, the column and
    row indices, x and y, each read or written once."""
    es = a.values().element_size()
    n = a.shape[0]
    return (a.values().numel() * es + a.col_indices().numel() * 4
            + a.crow_indices().numel() * 4 + 2 * n * es)


def library_csr(shape, diag, off, x, y, name):
    """The library's yardstick for stencil7: one CSR product (cuSPARSE
    through torch.mv) of the same system, built from the same planes,
    timed as the kernel is.  It adds a row's 7 products in another order
    (and may fuse them), so it is held to ``y`` at rounding: per row
    within 2 x 7 x u x the sum of the terms' magnitudes (u the unit
    roundoff), the bound of two summation orders.  Returns its ms."""
    a = csr_of_planes(shape, diag, off)
    y_csr = torch.mv(a, x)
    magnitude = stencil.stencil7(shape, diag.abs(), off.abs(), x.abs())
    torch.cuda.synchronize()
    diff = (y_csr - y).abs()
    bound = 7.0 * torch.finfo(x.dtype).eps * magnitude
    err = float(diff.max())
    within = bool((diff <= bound).all())
    ms = back_to_back_ms(lambda: torch.mv(a, x))
    nbytes = csr_bytes(a)
    print(f"library csr {name} shape={shape} nnz={a.values().numel()} "
          f"bytes={nbytes} (stencil7: {9 * x.numel() * x.element_size()}) "
          f"max_abs_err vs stencil7={err!r} within the rounding bound="
          f"{within} bitwise={bool(torch.equal(y_csr, y))} ms={ms!r} "
          f"(100 launches per event pair) bytes_bound_ms="
          f"{nbytes / HBM_BYTES_PER_S * 1e3!r}")
    if not within:
        raise AssertionError("the CSR product disagrees with stencil7 "
                             "beyond rounding")
    return ms


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


# the phase that is running (set as each starts) and, by phase, the
# launches of its counted runs: the fused Jacobi-CG kernels
# (``pcg_jacobi``, four an iteration) and ``stencil7_kernel`` alone (the
# ``stencil7`` count less the fused products, which it also counts)
PATH_NOW = ["kernel"]
PATH_LAUNCHES = collections.defaultdict(collections.Counter)
# counted runs open now: a run inside another is tallied with the outer
_COUNTED_DEPTH = [0]


@contextlib.contextmanager
def counted_run(counts=None):
    """Counts of one run of a main path: the kernel's launches (from the
    program's counter, ``profiler.launches``; with the fused iterations'
    products), the fused Jacobi-CG kernels' launches, and the calls of the
    kernel's plain version on a CUDA tensor, which no path on the card may
    make; in ``counts`` when given, and added to the running phase's
    ``PATH_LAUNCHES``."""
    counts = {} if counts is None else counts
    counts["plain_on_cuda"] = 0
    plain = stencil.spmv_structured

    def counting_plain(shape, diag, off, x):
        counts["plain_on_cuda"] += x.is_cuda
        return plain(shape, diag, off, x)

    stencil.spmv_structured = counting_plain
    before = profiler.launches["stencil7"]
    fused_before = profiler.launches["pcg_jacobi"]
    bicg_before = profiler.launches["bicgstab_ell"]
    _COUNTED_DEPTH[0] += 1
    try:
        yield counts
    finally:
        stencil.spmv_structured = plain
        _COUNTED_DEPTH[0] -= 1
    counts["launches"] = profiler.launches["stencil7"] - before
    counts["pcg_jacobi"] = profiler.launches["pcg_jacobi"] - fused_before
    counts["bicgstab_ell"] = profiler.launches["bicgstab_ell"] - bicg_before
    if counts["pcg_jacobi"] % 4:
        raise AssertionError(f"{counts['pcg_jacobi']} fused Jacobi-CG "
                             "launches: not four an iteration")
    if counts["bicgstab_ell"] % bicgstab_ell.LAUNCHES:
        raise AssertionError(f"{counts['bicgstab_ell']} fused "
                             "Jacobi-BiCGSTAB launches: not six an "
                             "iteration")
    if not _COUNTED_DEPTH[0]:
        PATH_LAUNCHES[PATH_NOW[0]].update(
            pcg_jacobi=counts["pcg_jacobi"],
            bicgstab_ell=counts["bicgstab_ell"],
            stencil7_kernel=counts["launches"] - counts["pcg_jacobi"] // 4)


def run_bench(device, precision, preconditioner="jacobi", jacobi=None,
              warmup=True, baseline=False):
    """The port's benchmark (``modflow6_torch.bench``'s build and timed
    run): a warm-up run (unless ``warmup`` is false), then a timed run
    whose kernel launches are counted; with ``baseline``, then the scipy
    baseline on the same model and the benchmark's JSON line.  With
    another preconditioner than Jacobi the run is held against the Jacobi
    ``f64`` run of this call, ``jacobi`` = (heads, inner_total of the same
    precision): heads within 10 x outer_dvclose, fewer inner iterations,
    and at least the launches that the inner count implies."""
    model, settings = bench_mod.build(*BENCH_SHAPE, precision, device)
    settings = dataclasses.replace(settings, preconditioner=preconditioner)
    counts = {}
    head, kiters, inners, convs, elapsed = bench_mod.timed_run(
        model, settings, 3, warmup=warmup, around=counted_run(counts))
    launches = counts["launches"]
    inner_total = sum(inners)
    cells = model.nodes
    rate = cells * inner_total / elapsed
    finite = bool(torch.isfinite(head).all())
    print(f"bench precision={precision} preconditioner={preconditioner} "
          f"cells={cells} steps=3 "
          f"inner_total={inner_total} inners={inners} outers={kiters} "
          f"converged={all(convs)} warm={warmup} elapsed_s={elapsed!r} "
          f"ims_cell_iters_per_s={rate!r} stencil7_launches={launches} "
          f"plain_on_cuda={counts['plain_on_cuda']}")
    if baseline:
        t0 = time.perf_counter()
        # 20 iterations of the benchmark's 60 (the phases' time limit)
        base = bench_mod.scipy_baseline_rate(model, iters=20)
        print(f"bench scipy baseline (1 core, 20 Jacobi-CG iterations): "
              f"{base!r} cell-iter/s in {time.perf_counter() - t0!r} s "
              "with the host copy of the system; the bench line:")
        print(bench_mod.result_line(rate, rate / base))
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
            before = profiler.launches["stencil7"]
            z = apply(r)
            torch.cuda.synchronize()
            launches = profiler.launches["stencil7"] - before
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
    command-line entry (``-l summary``: the listing holds the profiler's
    sections and the memory report) and through ``load_simulation``, in
    ``mixed`` through ``load_simulation`` with the solution rebuilt; the
    ``f64`` runs held against the fused ``f64`` run.  Returns (the launches
    of the three, the ``f64`` loader run's heads each step, the CLI run's
    saved heads)."""
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
            code = cli_main([ws, "--lst", lst, "-l", "summary"])
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
        listing = open(lst).read()
        prof = listing[listing.index("Profiler timings"):].splitlines()
        mem = listing[listing.index("MEMORY USAGE"):].splitlines()
        print("deck f64 cli -l summary listing: "
              + " | ".join(line.strip() for line in prof[:9] + mem[:8]))
        if not ([line.split()[0] for line in prof[1:3]] == ["step", "solve"]
                and all("(n=3)" in line for line in prof[1:3])
                and any(line.startswith("NPF_ARRAYS") for line in mem)
                and mem[-1].startswith("TOTAL")):
            raise AssertionError("the listing lacks the profiler sections "
                                 "or the memory report")
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
            if precision == "f64":
                deck_heads = [r.head for r in recs]
    return launches, deck_heads, cli_head


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
        lst = os.path.join(ws, "cli.lst")
        out = io.StringIO()
        # the command-line entry's own load, timed and kept for the grid
        # check
        with captured_loads(device) as loads, counted_run() as counts, \
                contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            code = cli_main([ws, "--lst", lst])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
        sim, load_s = loads[0]
        same_grid = (np.array_equal(sim.model.grid.javert, grid.javert)
                     and np.array_equal(sim.model.grid.vertices,
                                        grid.vertices))
        del sim, loads
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
          f"load_s={load_s!r} (the command-line entry's load) "
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
    heads file read back, and its first step again bitwise equal.  Returns
    (the model, the final heads)."""
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
        # the repeat is the first step (the phases' time limit)
        for attempt, period in enumerate(((15.0, 3, 1.0), (5.0, 1, 1.0))):
            files = attempt == 0
            sim = Simulation(
                Tdis((StressPeriod(*period),)), model,
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
            first_head = recs[0].head
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
    bitwise = bool(np.array_equal(first_head, heads[1]))
    print(f"brick simulation: the repeat's first step bitwise equal to the "
          f"run's={bitwise}")
    if not bitwise:
        raise AssertionError("two brick runs on the card differ")
    return model, heads[0]


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
    q_route, div_in, _ = sfr.routing(q)
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
    ``f64``); (d) the gather product at width Ktot.  The bitwise repeat
    (b) is the apt phase's: its (a1) runs these features, with movers and
    their transport, and their first step again.  Returns (records of
    (a), the stencil7
    launches of (a))."""
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
    # one run: the apt phase's (a1) repeats this flow, with movers and
    # the transport, and holds its repeat bitwise
    for label in ("a",):
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
    SFR6 with cross-section TAB6 files), period 1 cut to (a)'s first step
    (the phases' time limit), with a PERIOD 2 block of one step that
    changes the wells' rates and the tributaries' inflow, run through the
    command-line entry: period 1 has (a)'s first-step counts and heads
    within DECK_FUSED_ATOL, period 2 converges with its budget closed.
    Returns the run's stencil7 launches."""
    from modflow6_torch.utils.mf6io import loader as loader_mod
    nlay, nrow, ncol = shape
    grid = flagship_grid(*shape)
    with tempfile.TemporaryDirectory() as ws:
        t0 = time.perf_counter()
        files = write_advanced_files(ws, advanced_features(
            grid, flagship_kfield(*shape)), grid)
        write_flagship_deck(ws, nlay, nrow, ncol, acc="BICGSTAB",
                            tdis=[(5.0, 1, 1.0), (5.0, 1, 1.0)],
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
        err = float(np.abs(np.stack(saved[(1, 1)]).reshape(-1)
                           - memory_recs[0].head[:N]).max())
        want = [(r.outer, r.inner) for r in memory_recs[:1]]
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
        if cli_counts[:1] != want or len(cli_counts) != 2:
            raise AssertionError("the deck's period-1 counts differ from "
                                 "(a)'s")
        if not (err <= DECK_FUSED_ATOL and len(builds) == 2
                and len(discs) == 2 and abs(discs[-1]) < BUDGET_PERCENT):
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
    (e) the small twins.  Returns (the stencil7 launches of (a)-(c), which
    must be none: an augmented model has no grid shape; (a)'s first-step
    heads)."""
    recs, launches = run_advanced_memory(device, shape)
    launches += run_advanced_deck(device, recs, shape)
    check_small_advanced(device)
    return launches, recs[0].head


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
    (3 steps of 5.0, CG with Jacobi, ``f64``); (u2) its first step again,
    bitwise equal (the phases' time limit).  Returns ((u1)'s records, the
    stencil7 launches of both runs)."""
    from modflow6_torch.models.gwf import uzf as uzf_mod
    runs, launches = [], 0
    for label, period in (("u1", (15.0, 3, 1.0)), ("u2", (5.0, 1, 1.0))):
        reset_peak(device)
        t0 = time.perf_counter()
        model = uzf_base(device, shape)
        columns = uzf_mod.make_uzf(uzf_columns(shape), device=device,
                                   **UZF_FLAGS)
        sync(device)
        build_s = time.perf_counter() - t0
        sim = Simulation(Tdis((StressPeriod(*period),)), model,
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
              f"{columns.nz} steps={len(recs)} solves={len(solves)} "
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
    first, repeat = runs[0][0], runs[1][0]
    same = len(runs[1]) == 1 and np.array_equal(first.head, repeat.head)
    counts_same = (first.outer, first.inner, first.uzf_resolves) == \
        (repeat.outer, repeat.inner, repeat.uzf_resolves)
    print(f"coupling (u2) vs (u1)'s first step: heads bitwise equal={same} "
          f"counts equal={counts_same}")
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
    ``Simulation`` (2 steps of 5.0, BiCGSTAB with Jacobi, ``f64``; the
    mover balance reads the second step against the first); it
    launches no stencil7.  The bitwise repeat (m2) is the apt phase's (a1),
    which runs this flow with its transport, and its first step again.
    Returns (m1)'s
    records."""
    runs = []
    # one run: the apt phase's (a1) repeats this flow with the transport
    # and holds its repeat bitwise
    for label in ("m1",):
        reset_peak(device)
        t0 = time.perf_counter()
        model = mvr_model(device, shape)
        sync(device)
        build_s = time.perf_counter() - t0
        sim, recs, seconds, counts = simulate(model, [(10.0, 2, 1.0)],
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
              f"{len(model.mvr.rounds)} steps={len(recs)} "
              f"inner_total={inner} "
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
    if torch.device(device).type == "cuda":
        ms, eager_ms, same = time_mover_chain(model, x)
        print(f"coupling (m) mover chain, {model.mvr.nmovers} movers: "
              f"rounds ms={ms!r} one mover at a time ms={eager_ms!r} "
              f"bitwise equal={same}")
        if not same:
            raise AssertionError("the rounds disagree with the mover-by-"
                                 "mover chain")
    return runs[0]


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
    """The coupling phase: (u1)-(u3) UZF, (m1) MVR, (x1)-(x2) two models,
    at ``shape`` (the small twins run in the small phase; (m2) and (m3),
    the mover run's repeat and its deck, are the apt phase's (a1) and
    (a2)).
    Returns the stencil7
    launches of the UZF runs, which must be some: the UZF model keeps its
    grid shape."""
    recs, launches = run_uzf_memory(device, shape)
    launches += run_uzf_deck(device, recs, shape)
    # (m3), the MVR6 deck, is the apt phase's (a2): the same mover deck
    # with its transport, held bitwise against (a1)
    run_mvr_memory(device, shape)
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
    files, period 1 alone (period 2 cut in depth for the phases' time),
    stepping adaptively from a first step of the whole period with an
    outer maximum one below that step's count, run twice, and replayed as
    fixed steps of the accepted length.  Returns the launches."""
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
        sim.tdis = Tdis(sim.tdis.periods[:1])
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
            sim.tdis = Tdis((StressPeriod(perlen, len(steps), 1.0),))
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


# ------------------------------------------------------------ transport

# (t1) the bench model over two periods: bench.py's three 5-d steps, then
# four steps of a year
PLUME_PERIODS = ((15.0, 3, 1.0), (1460.0, 4, 1.0))
# the flow: bench.py's closures, CG with Jacobi, room for the long steps
PLUME_FLOW = dict(BENCH, inner_maximum=2000)
# the transport: BiCGSTAB with Jacobi on the ELL gather
PLUME_TRANSPORT = dict(outer_dvclose=1e-5, outer_maximum=50,
                       inner_dvclose=1e-7, inner_rclose=1e-6,
                       inner_maximum=500, linear_acceleration="bicgstab")
PLUME_DSP = dict(alh=10.0, ath1=1.0, atv=0.1, diffc=8.64e-5)
PLUME_SORPTION = dict(isrb=1, bulk_density=1.6, distcoef=0.1)
PLUME_DECAY = 1e-4
PLUME_RCH_CONC = 0.01
PLUME_SRC = 0.1
CONC_SLACK = 1e-4           # the concentrations stay in [-1e-4, 1 + 1e-4]


def plume_layout(shape):
    """Layer-1 cells of the plume's sources on the bench grid: the CNC
    block (32 x 32 at 1024 x 1024) 256 columns east of the west CHD column
    in the rows of the well, the SRC block (16 x 16) in the north-east
    quarter; both scale with the grid."""
    _, nrow, ncol = shape
    side, src_side = max(ncol // 32, 2), max(ncol // 64, 1)
    r0 = nrow // 2 - side // 2
    c0 = ncol // 4
    cnc = [i * ncol + j for i in range(r0, r0 + side)
           for j in range(c0, c0 + side)]
    sr, sc = nrow // 4, 3 * ncol // 4
    src = [i * ncol + j for i in range(sr, sr + src_side)
           for j in range(sc, sc + src_side)]
    return cnc, src


def plume_transport(device, grid, shape):
    """(t1)'s contaminant plume on the bench grid ``grid``."""
    nlay, nrow, ncol = shape
    cnc, src = plume_layout(shape)
    return build_gwt(
        "plume", grid, porosity=0.3, strt=0.0, scheme="tvd",
        dsp=PLUME_DSP, decay=(1, PLUME_DECAY), sorption=PLUME_SORPTION,
        cnc=[(n, 1.0) for n in cnc], src=[(n, PLUME_SRC) for n in src],
        ssm_spec={"RCH": np.full(nrow * ncol, PLUME_RCH_CONC)},
        device=device)


def plume_models(device, shape):
    """(flow, transport) of (t1): ``flagship`` and its contaminant plume."""
    flow = flagship(*shape, device)
    return flow, plume_transport(device, flow.grid, shape)


def instrument_transport(sim, device):
    """Per step of ``sim``: the transport's assembly seconds, its BiCGSTAB
    seconds and iterations (each linear solve between two device
    synchronisations), its stencil7 launches, the flow's launches and the
    peak memory; and the last assembled transport system with the iterate
    it was built at."""
    from modflow6_torch.solution import ims as ims_mod
    gwt, sol = sim.gwt, sim.gwt_solution
    steps, last = [], {}
    assemble, solve = gwt.assemble, sol.solve_timestep
    do_step, bicgstab = sim.do_step, ims_mod.bicgstab

    def timed_bicgstab(*args, **kwargs):
        sync(device)
        t0 = time.perf_counter()
        res = bicgstab(*args, **kwargs)
        sync(device)
        steps[-1]["bicgstab_s"] += time.perf_counter() - t0
        steps[-1]["bicgstab_iterations"] += res.iters
        return res

    def timed_assemble(conc, conc_old, ibound, delt, iss, pkgs=None):
        sync(device)
        t0 = time.perf_counter()
        out = assemble(conc, conc_old, ibound, delt, iss, pkgs)
        sync(device)
        steps[-1]["assembly_s"] += time.perf_counter() - t0
        last.update(system=out, conc=conc, ibound=ibound)
        return out

    def counted_solve(*args, **kwargs):
        before = profiler.launches["stencil7"]
        steps[-1]["flow_launches"] = before - steps[-1]["flow_launches"]
        ims_mod.bicgstab = timed_bicgstab
        try:
            out = solve(*args, **kwargs)
        finally:
            ims_mod.bicgstab = bicgstab
        steps[-1]["transport_launches"] = (profiler.launches["stencil7"]
                                           - before)
        return out

    def step(*args, **kwargs):
        reset_peak(device)
        steps.append(dict(assembly_s=0.0, bicgstab_s=0.0,
                          bicgstab_iterations=0,
                          flow_launches=profiler.launches["stencil7"],
                          transport_launches=0))
        out = do_step(*args, **kwargs)
        steps[-1]["peak_bytes"] = peak_bytes(device)
        return out

    gwt.assemble, sol.solve_timestep, sim.do_step = (timed_assemble,
                                                     counted_solve, step)
    return steps, last


def final_system(sim, last):
    """The last transport system after the fixup at the iterate it was
    built at: (diag, off, rhs, ibound)."""
    diag, off, rhs = last["system"]
    ib = last["ibound"]
    return fix_system(sim.gwt, torch.sign(ib), diag, off, rhs, last["conc"],
                      symmetric=False) + (ib,)


def final_residual(sim, last):
    """max |b - A c| of the last transport system at the final
    concentration, in f64 through the ELL gather."""
    diag, off, rhs, ib = final_system(sim, last)
    r = rhs - spmv(sim.gwt.dtopo.nbr, diag, off, sim.conc)
    return float(torch.where(ib > 0, r, 0.0).abs().max())


def time_transport_gather(sim, last, ms_per_iteration, label="transport "
                          "(t1)"):
    """The ELL gather product of the last transport system (K = 6 on a DIS
    grid, Ktot with APT rows), 100 launches per CUDA event pair, beside its
    byte bound and its share of a BiCGSTAB iteration (two products;
    ``ms_per_iteration`` from the linear solves' own seconds)."""
    diag, off, _, _ = final_system(sim, last)
    nbr, x = sim.gwt.dtopo.nbr, sim.conc
    n, k = nbr.shape
    ms = back_to_back_ms(lambda: spmv(nbr, diag, off, x))
    bound = ell_bound_ms(n, k)
    print(f"{label} ell product K={k} rows={n} ms={ms!r} "
          f"bound_ms={bound!r} share_of_bound={bound / ms!r} "
          f"share_of_bicgstab_iteration={2 * ms / ms_per_iteration!r}")


def run_plume(device, shape, label, time_gather=False,
              periods=PLUME_PERIODS):
    """(t1) once: the flow and the plume through ``Simulation`` over
    ``periods``; with ``time_gather`` (on the card) also the transport's
    gather product."""
    flow, gwt = plume_models(device, shape)
    sim = Simulation(Tdis(tuple(StressPeriod(*p) for p in periods)),
                     flow, ImsSettings(**PLUME_FLOW), gwt=gwt,
                     gwt_settings=ImsSettings(**PLUME_TRANSPORT))
    steps, last = instrument_transport(sim, device)
    with counted_run() as counts:
        t0 = time.perf_counter()
        recs = sim.run()
        sync(device)
        seconds = time.perf_counter() - t0
    resid = final_residual(sim, last)
    cmin = min(float(c.min()) for c in sim.conc_records)
    cmax = max(float(c.max()) for c in sim.conc_records)
    for r, s in zip(recs, steps):
        print(f"transport (t1) {label} kper={r.kper} kstp={r.kstp} "
              f"flow outer={r.outer} inner={r.inner} transport "
              f"outer={r.transport_outer} inner={r.transport_inner} "
              f"fmi_s={r.fmi_seconds!r} assembly_s={s['assembly_s']!r} "
              f"solve_s={r.transport_seconds!r} "
              f"bicgstab_s={s['bicgstab_s']!r} ms_per_bicgstab_iteration="
              f"{s['bicgstab_s'] / max(s['bicgstab_iterations'], 1) * 1e3!r} "
              f"stencil7_flow={s['flow_launches']} "
              f"stencil7_transport={s['transport_launches']} "
              f"peak_bytes={s['peak_bytes']}")
    print(f"transport (t1) {label}: cells={flow.nodes} run_s={seconds!r} "
          f"conc_min={cmin!r} conc_max={cmax!r} final_residual={resid!r} "
          f"rclose={PLUME_TRANSPORT['inner_rclose']!r} "
          f"stencil7_launches={counts['launches']}")
    if not all(r.converged and r.transport_converged for r in recs):
        raise AssertionError(f"transport (t1) {label}: a step did not "
                             "converge")
    if not (-CONC_SLACK <= cmin and cmax <= 1.0 + CONC_SLACK
            and np.isfinite(cmin) and np.isfinite(cmax)):
        raise AssertionError(f"transport (t1) {label}: concentrations "
                             f"[{cmin}, {cmax}] outside [0, 1]")
    if not resid <= PLUME_TRANSPORT["inner_rclose"]:
        raise AssertionError(f"transport (t1) {label}: final residual "
                             f"{resid} above the closure")
    if any(s["transport_launches"] for s in steps) \
            or not all(s["flow_launches"] for s in steps) \
            or counts["plain_on_cuda"]:
        raise AssertionError(f"transport (t1) {label}: the flow must go "
                             "through stencil7, the transport must not")
    if time_gather:
        inner = sum(s["bicgstab_iterations"] for s in steps)
        solve = sum(s["bicgstab_s"] for s in steps)
        time_transport_gather(sim, last, solve / inner * 1e3)
    return sim, recs, counts["launches"]


def write_coupled_flow(ws, shape, model="GWT6", tname="PLUME",
                       aux="CONCENTRATION", value=None,
                       periods=PLUME_PERIODS, flow=PLUME_FLOW, acc="CG",
                       transport=None, **deck):
    """The flow deck of ``write_flagship_deck`` with the recharge as an
    RCH6 list carrying an ``aux`` column (OPEN/CLOSE) at ``value``, a
    ``model`` transport model named ``tname`` (t.nam, whose files the
    caller writes), a GWF6-``model`` exchange, and two solution groups
    (the flow's ``acc``, BICGSTAB for the transport at ``transport``'s
    closures); ``deck``: further ``write_deck`` arguments."""
    nlay, nrow, ncol = shape
    transport = transport or PLUME_TRANSPORT
    ims = {k: flow[k] for k in ("outer_dvclose", "outer_maximum",
                                "inner_maximum", "inner_dvclose",
                                "inner_rclose")}
    write_flagship_deck(ws, nlay, nrow, ncol, rcha=None, tdis=list(periods),
                        ims=ims, acc=acc, oc_last=False,
                        extra_packages=["RCH6 m.rch"]
                        + list(deck.pop("extra_packages", [])), **deck)
    ii, jj = np.divmod(np.arange(nrow * ncol), ncol)
    with open(os.path.join(ws, "rch.txt"), "w") as f:
        f.write("".join(f"1 {i + 1} {j + 1} 0.0001 {value!r}\n"
                        for i, j in zip(ii.tolist(), jj.tolist())))
    _write(ws, "m.rch", f"""BEGIN OPTIONS
  AUXILIARY {aux}
END OPTIONS
BEGIN DIMENSIONS
  MAXBOUND {nrow * ncol}
END DIMENSIONS
BEGIN PERIOD 1
  OPEN/CLOSE rch.txt
END PERIOD
""")
    _write(ws, "mfsim.nam", f"""BEGIN TIMING
  TDIS6 sim.tdis
END TIMING
BEGIN MODELS
  GWF6 m.nam FLAGSHIP
  {model} t.nam {tname}
END MODELS
BEGIN EXCHANGES
  GWF6-{model} ft.exg FLAGSHIP {tname}
END EXCHANGES
BEGIN SOLUTIONGROUP 1
  IMS6 sim.ims FLAGSHIP
END SOLUTIONGROUP
BEGIN SOLUTIONGROUP 2
  IMS6 t.ims {tname}
END SOLUTIONGROUP
""")
    t = transport
    _write(ws, "ft.exg", "BEGIN OPTIONS\nEND OPTIONS\n")
    _write(ws, "t.ims", f"""BEGIN NONLINEAR
  OUTER_DVCLOSE {t['outer_dvclose']!r}
  OUTER_MAXIMUM {t['outer_maximum']}
END NONLINEAR
BEGIN LINEAR
  INNER_MAXIMUM {t['inner_maximum']}
  INNER_DVCLOSE {t['inner_dvclose']!r}
  INNER_RCLOSE {t['inner_rclose']!r}
  LINEAR_ACCELERATION BICGSTAB
END LINEAR
""")
    shutil.copy(os.path.join(ws, "m.dis"), os.path.join(ws, "t.dis"))


def _block_file(ws, name, shape, nodes, value):
    """A CNC6/SRC6/CTP6/ESL6 file of one PERIOD 1 entry per layer-1 node."""
    ncol = shape[2]
    rows = "".join(f"  1 {n // ncol + 1} {n % ncol + 1} {value!r}\n"
                   for n in nodes)
    _write(ws, name, f"BEGIN DIMENSIONS\n  MAXBOUND {len(nodes)}\n"
           f"END DIMENSIONS\nBEGIN PERIOD 1\n{rows}END PERIOD\n")


def write_plume_deck(ws, shape, periods=PLUME_PERIODS, flow=PLUME_FLOW,
                     acc="CG", apt_files=(), **deck):
    """(t1) as a deck: ``write_coupled_flow`` with the recharge at its
    concentration, a GWT6 model with every (t1) package (DSP with
    XT3D_OFF), concentrations saved every step; ``apt_files``: further
    (name-file line, text) of the transport model (the APT files)."""
    write_coupled_flow(ws, shape, value=PLUME_RCH_CONC, periods=periods,
                       flow=flow, acc=acc, **deck)
    _write(ws, "t.nam", "BEGIN PACKAGES\n" + "".join(
        f"  {line}\n" for line in (
            "DIS6 t.dis", "IC6 t.ic", "ADV6 t.adv", "DSP6 t.dsp",
            "MST6 t.mst", "SSM6 t.ssm", "CNC6 t.cnc", "SRC6 t.src",
            "OC6 t.oc") + tuple(line for line, _ in apt_files))
        + "END PACKAGES\n")
    for line, text in apt_files:
        _write(ws, line.split()[1], text)
    _write(ws, "t.ic", "BEGIN GRIDDATA\n  STRT\n    CONSTANT 0.0\n"
           "END GRIDDATA\n")
    _write(ws, "t.adv", "BEGIN OPTIONS\n  SCHEME TVD\nEND OPTIONS\n")
    d = PLUME_DSP
    _write(ws, "t.dsp", "BEGIN OPTIONS\n  XT3D_OFF\nEND OPTIONS\n"
           "BEGIN GRIDDATA\n" + "".join(
               f"  {k.upper()}\n    CONSTANT {v!r}\n" for k, v in d.items())
           + "END GRIDDATA\n")
    s = PLUME_SORPTION
    _write(ws, "t.mst", f"""BEGIN OPTIONS
  FIRST_ORDER_DECAY
  SORPTION LINEAR
END OPTIONS
BEGIN GRIDDATA
  POROSITY
    CONSTANT 0.3
  DECAY
    CONSTANT {PLUME_DECAY!r}
  BULK_DENSITY
    CONSTANT {s['bulk_density']!r}
  DISTCOEF
    CONSTANT {s['distcoef']!r}
END GRIDDATA
""")
    _write(ws, "t.ssm", "BEGIN SOURCES\n  RCH-1 AUX CONCENTRATION\n"
           "END SOURCES\n")
    cnc, src = plume_layout(shape)
    _block_file(ws, "t.cnc", shape, cnc, 1.0)
    _block_file(ws, "t.src", shape, src, PLUME_SRC)
    _write(ws, "t.oc", """BEGIN OPTIONS
  CONCENTRATION FILEOUT t.ucn
END OPTIONS
BEGIN PERIOD 1
  SAVE CONCENTRATION ALL
END PERIOD
""")


def run_plume_deck(device, shape, memory, periods=PLUME_PERIODS):
    """(t2) the (t1) deck over ``periods`` through the command-line entry:
    its .ucn records against ``memory``'s concentrations (an in-memory run
    over the same periods), its counts against its counts."""
    msim, mrecs = memory
    ws = tempfile.mkdtemp(prefix="plume_")
    try:
        t0 = time.perf_counter()
        write_plume_deck(ws, shape, periods=periods)
        write_s = time.perf_counter() - t0
        out = io.StringIO()
        with captured_loads(device) as loads, counted_run() as counts, \
                contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            code = cli_main([ws] + ([] if torch.device(device).type == "cuda"
                                    else ["--device", "cpu"]))
            sync(device)
            cli_s = time.perf_counter() - t0
        sim, load_s = loads[0]
        recs = sim.records
        ucn = read_head_file(os.path.join(ws, "t.ucn"))
        nlay = shape[0]
        concs = [np.concatenate([r["data"].reshape(-1) for r in
                                 ucn[i:i + nlay]])
                 for i in range(0, len(ucn), nlay)]
    finally:
        shutil.rmtree(ws, ignore_errors=True)
    counts_of = [(r.outer, r.inner, r.transport_outer, r.transport_inner)
                 for r in recs]
    want = [(r.outer, r.inner, r.transport_outer, r.transport_inner)
            for r in mrecs]
    bitwise = len(concs) == len(msim.conc_records) and all(
        np.array_equal(a, b) for a, b in zip(concs, msim.conc_records))
    err = max(float(np.abs(a - b).max())
              for a, b in zip(concs, msim.conc_records))
    print(f"transport (t2) plume deck cli exit={code} written_s={write_s!r} "
          f"wall_s={cli_s!r} load_s={load_s!r} counts={counts_of} "
          f"ucn_records={len(concs)} bitwise_equal_t1={bitwise} "
          f"max|c_deck - c_t1|={err!r} "
          f"stencil7_launches={counts['launches']} "
          f"stdout={out.getvalue().strip()!r}")
    if code != 0 or "Normal termination" not in out.getvalue() \
            or len(concs) != len(mrecs) or counts_of != want \
            or not err <= DECK_FUSED_ATOL or counts["plain_on_cuda"] \
            or not counts["launches"]:
        raise AssertionError("the plume deck differs from (t1)")
    return counts["launches"]


# (t3) the BUY/VSC wedge of the properties phase with its transport
WEDGE_PERIODS = ((10.0, 2, 1.0),)
WEDGE_MXITER = 3


def wedge_models(device, shape):
    flow = build_gwf("buy vsc wedge", flagship_grid(*shape),
                     buy=dict(denseref=1000.0, drhodc=0.7, crhoref=0.0),
                     vsc=dict(viscref=1.0, dviscdc=0.01), device=device,
                     **flagship_args(*shape))
    nlay, nrow, ncol = shape
    sea = [(k * nrow * ncol + i * ncol + ncol - 1, 35.0)
           for k in range(nlay) for i in range(nrow)]
    gwt = build_gwt("wedge", flow.grid, porosity=0.3,
                    strt=wedge(*shape), cnc=sea, device=device)
    return flow, gwt


def run_wedge(device, shape, mxiter, label, periods=WEDGE_PERIODS):
    """(t3) once over ``periods``: returns (simulation, records, flow
    self-consistency error, launches); a run of one step has no
    self-consistency re-solve, and its error is None."""
    flow, gwt = wedge_models(device, shape)
    settings = ImsSettings(**BENCH, linear_acceleration="bicgstab")
    sim = Simulation(Tdis(tuple(StressPeriod(*p) for p in periods)),
                     flow, settings, gwt=gwt,
                     gwt_settings=ImsSettings(**PLUME_TRANSPORT))
    sim.sgp_mxiter = mxiter
    with counted_run() as counts:
        t0 = time.perf_counter()
        recs = sim.run()
        sync(device)
        seconds = time.perf_counter() - t0
    err, resolved = None, True
    if len(recs) > 1:
        # the flow's self-consistency: the last step re-solved at the
        # final concentration
        pkgs = dataclasses.replace(flow.packages, buy_conc=sim.conc)
        h2, info, _ = sim.solution.solve_timestep(
            torch.as_tensor(recs[-2].head, device=device), recs[-1].totim
            - recs[-2].totim, kstp=len(recs), iss=False, pkgs=pkgs)
        err = float((h2.cpu() - torch.as_tensor(recs[-1].head)).abs().max())
        resolved = info.converged
    print(f"transport (t3) wedge {label} mxiter={mxiter}: "
          f"cells={flow.nodes} run_s={seconds!r} "
          f"counts={[(r.outer, r.inner) for r in recs]} "
          f"group_passes={[r.group_iterations for r in recs]} "
          f"transport={[(r.transport_outer, r.transport_inner) for r in recs]} "
          f"self_consistency={err!r} resolve_converged={resolved} "
          f"conc_max={float(sim.conc.max())!r} "
          f"stencil7_launches={counts['launches']}")
    if not (all(r.converged and r.transport_converged for r in recs)
            and resolved and counts["launches"]
            and not counts["plain_on_cuda"]):
        raise AssertionError(f"transport (t3) wedge {label} failed")
    return sim, recs, err, counts["launches"]


def small_transport_models(dev):
    """(name, run) of the small transport twins: ``run()`` returns (the
    final concentration on the CPU, [(flow outer, transport outer)],
    converged, transport settings)."""
    from modflow6_torch.models.gwt.exchange import merge_gwt_models
    from modflow6_torch.models.gwf import exchange
    trans = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-10,
                 inner_rclose=1e-9, inner_maximum=500,
                 linear_acceleration="bicgstab")
    flow_s = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-10,
                  inner_rclose=1e-9, inner_maximum=500)
    grid = dict(nlay=2, nrow=12, ncol=10, delr=10.0, delc=10.0, top=20.0,
                botm=np.stack([np.full((12, 10), 10.0),
                               np.zeros((12, 10))]))
    rng = np.random.default_rng(21)
    fkw = dict(k=np.exp(rng.normal(0.0, 0.5, 240)), strt=15.0,
               storage={"ss": 1e-4, "iconvert": 0},
               chd=[(i * 10, 16.0) for i in range(12)]
               + [(120 + i * 10 + 9, 14.0) for i in range(12)],
               wel=[(65, -20.0)], rch=[(n, 1e-3) for n in range(120)])

    def run(name, periods=((20.0, 4, 1.2),), ats=None, ats_percel=None,
            **tkw):
        g = DisGrid.create(**grid)
        sim = Simulation(
            Tdis(tuple(StressPeriod(*p) for p in periods)),
            build_gwf(name, g, device=dev, **fkw), ImsSettings(**flow_s),
            gwt=build_gwt(name, g, device=dev, porosity=0.3,
                          ssm_spec={"RCH": 0.5}, **tkw),
            gwt_settings=ImsSettings(**trans))
        if ats is not None:
            sim.ats = {1: ats}
            sim.ats_percel = ats_percel
        recs = sim.run()
        return (torch.as_tensor(sim.conc_records[-1]),
                [(r.outer, r.transport_outer, r.totim) for r in recs],
                all(r.converged and r.transport_converged for r in recs),
                trans)

    dsp = dict(alh=5.0, ath1=0.5, atv=0.05, diffc=1e-3)
    twins = [(f"{scheme} with dsp", lambda scheme=scheme: run(
        scheme, scheme=scheme, dsp=dsp, cnc=[(3, 1.0)]))
        for scheme in ("upstream", "central", "tvd")]
    twins += [
        ("freundlich, zero-order decay", lambda: run(
            "freundlich", cnc=[(3, 1.0)], decay=(2, 1e-3), sorption=dict(
                isrb=2, bulk_density=1.6, distcoef=0.2, sp2=0.7))),
        ("langmuir, zero-order decay", lambda: run(
            "langmuir", cnc=[(3, 1.0)], decay=(2, 1e-3), sorption=dict(
                isrb=3, bulk_density=1.6, distcoef=0.3, sp2=2.0))),
        ("ist", lambda: run("ist", cnc=[(3, 1.0)], ist=dict(
            thetaim=0.1, zetaim=0.05, volfrac=0.3, bulk_density=1.6,
            distcoef=0.2, isrb=1))),
        ("src and repeated cnc", lambda: run(
            "src", cnc=[(3, 0.4), (3, 1.0), (44, 0.5)],
            src=[(70, 0.05), (70, 0.02), (71, 0.01)])),
        ("ats_percel", lambda: run(
            "percel", periods=((40.0, 1, 1.0),), cnc=[(3, 1.0)],
            ats=ats_mod.AtsPeriod(dt0=1.0, dtmin=0.01, dtmax=20.0,
                                  dtadj=2.0, dtfailadj=5.0),
            ats_percel=0.5))]

    def merged():
        half = dict(grid, ncol=5, botm=grid["botm"][:, :, :5])
        g = DisGrid.create(**half)
        members = [build_gwf(n, g, k=2.0, strt=15.0, device=dev, chd=chd,
                             storage={"ss": 1e-4, "iconvert": 0})
                   for n, chd in (("w", [(i * 5, 16.0) for i in range(12)]),
                                  ("e", [(60 + i * 5 + 4, 14.0)
                                         for i in range(12)]))]
        pairs = [exchange.ExchangePair(k * 60 + i * 5 + 4, k * 60 + i * 5,
                                       ihc=1, cl1=5.0, cl2=5.0, hwva=10.0)
                 for k in range(2) for i in range(12)]
        fm = exchange.merge_gwf_models(members, [exchange.GwfGwfExchange(
            0, 1, pairs)])
        tm = merge_gwt_models([build_gwt("tw", g, cnc=[(3, 1.0)],
                                         device=dev, porosity=0.3),
                               build_gwt("te", g, device=dev,
                                         porosity=0.3)], fm)
        sim = Simulation(Tdis((StressPeriod(20.0, 4, 1.2),)), fm,
                         ImsSettings(**flow_s), gwt=tm,
                         gwt_settings=ImsSettings(**trans))
        recs = sim.run()
        return (torch.as_tensor(sim.conc_records[-1]),
                [(r.outer, r.transport_outer) for r in recs],
                all(r.converged and r.transport_converged for r in recs),
                trans)

    return twins + [("two merged gwt models", merged)]


def check_small_transport(device, names=None):
    """Small transport twins on the card against the CPU (upstream,
    central and TVD with DSP; Freundlich and Langmuir sorption with
    zero-order decay; IST; SRC and repeated CNC cells; ATS_PERCEL; two
    merged GWT models): equal outer counts (and ATS step times within
    1e-12), concentrations within 10 × outer_dvclose."""
    cpu = dict(small_transport_models("cpu"))
    for name, run in small_transport_models(device):
        if names is not None and name not in names:
            continue
        c, k, ok, s = run()
        c0, k0, ok0, _ = cpu[name]()
        err = float((c - c0).abs().max())
        bar = CLOSURE_FACTOR * s["outer_dvclose"]
        same = [row[:2] for row in k] == [row[:2] for row in k0] and all(
            abs(a[2] - b[2]) <= 1e-12 * max(abs(b[2]), 1.0)
            for a, b in zip(k, k0) if len(a) > 2)
        print(f"small transport {name}: card counts={k} converged={ok}; "
              f"cpu counts={k0} converged={ok0}; max|dc|={err!r} "
              f"bar={bar!r}")
        if not (ok and ok0 and same and len(k) == len(k0) and err <= bar):
            raise AssertionError(f"small transport {name}: the card "
                                 "disagrees with the CPU")


def run_transport(device, shape=BENCH_SHAPE):
    """The transport phase: (t1) the plume, and its first step again
    (bitwise), (t2) its deck over the first step through the command-line
    entry (bitwise against the repeat), (t3) the
    density-coupled wedge with MXITER twice (bitwise) and with MXITER 1.
    Returns (the stencil7 launches, which must be some: the flow models
    keep their grid shape; (t1)'s heads and concentrations of its first
    three steps)."""
    t0 = time.perf_counter()
    # the repeat is the first step, held bitwise (the phases' time limit)
    sims = [run_plume(device, shape, label, time_gather=i == 1
                      and torch.device(device).type == "cuda",
                      periods=periods)
            for i, label, periods in ((1, "run 1", PLUME_PERIODS),
                                      (2, "run 2 (first step)", FIRST_STEP))]
    (s1, r1, l1), (s2, r2, l2) = sims
    bitwise_first_step("transport (t1)", (s1, r1), (s2, r2))
    plume = ([r.head for r in r1[:3]], s1.conc_records[:3])
    del s1, r1, sims
    # the deck's depth cut to the first step too: held against the repeat
    launches = l1 + l2 + run_plume_deck(device, shape, (s2, r2),
                                        periods=FIRST_STEP)
    del s2
    # the repeat is the first step, held bitwise (the phases' time limit)
    wedges = [run_wedge(device, shape, WEDGE_MXITER, "run 1"),
              run_wedge(device, shape, WEDGE_MXITER, "run 2 (first step)",
                        periods=((WEDGE_PERIODS[0][0] / WEDGE_PERIODS[0][1],
                                  1, 1.0),))]
    (w1, wr1, e1, wl1), (w2, wr2, _, wl2) = wedges
    same = [(r.outer, r.inner, r.group_iterations) for r in wr1[:1]] == [
        (r.outer, r.inner, r.group_iterations) for r in wr2] and all(
        np.array_equal(a.head, b.head) for a, b in zip(wr1, wr2)) and all(
        np.array_equal(a, b) for a, b in zip(w1.conc_records,
                                             w2.conc_records))
    del wedges, w1, w2
    _, _, e_lagged, wl3 = run_wedge(device, shape, 1, "lagged")
    print(f"transport (t3) run 2 bitwise equal to run 1's first step={same} "
          f"self_consistency "
          f"mxiter={WEDGE_MXITER} {e1!r} against mxiter=1 {e_lagged!r}")
    if not (same and e1 < e_lagged):
        raise AssertionError("the wedge runs differ, or the group loop did "
                             "not make the flow more consistent")
    launches += wl1 + wl2 + wl3
    print(f"transport phase in {time.perf_counter() - t0!r} s, "
          f"stencil7_launches={launches}")
    if not launches:
        raise AssertionError("the transport runs launched no stencil7 "
                             "kernel")
    return launches, plume


def small_apt_models(dev):
    """(name, run) of the small APT and GWE twins (a 3 x 10 grid with a
    pumping well, a lake with an outlet, six reaches with a diversion,
    UZF columns, movers): ``run()`` returns (the final values on the CPU,
    [(flow outer, transport outer)], converged, transport settings)."""
    from modflow6_torch.models.gwe.exchange import merge_gwe_models
    from modflow6_torch.models.gwf import exchange
    from modflow6_torch.models.gwf import uzf as uzf_mod
    s = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-10,
             inner_rclose=1e-9, inner_maximum=500,
             linear_acceleration="bicgstab")
    heat_s = dict(s, inner_rclose=s["inner_rclose"] * 1000.0 * 4184.0)
    grid = dict(nlay=1, nrow=3, ncol=10, delr=100.0, delc=100.0, top=50.0,
                botm=np.zeros((1, 3, 10)))
    fkw = dict(k=5.0, strt=30.0, chd=[(i * 10, 30.0) for i in range(3)],
               storage={"ss": 1e-5, "sy": 0.2, "iconvert": 1},
               wel=[(26, -1.0)], rch=[(n, 1e-4) for n in range(30)])
    wells = [dict(radius=0.2, strt=30.0, rate=-2.0,
                  connections=[(7, 5.0), (8, 4.0)]),
             dict(radius=0.2, strt=30.0, rate=0.5, connections=[(28, 3.0)])]
    lakes = ([dict(strt=31.5, bottom=29.0, surf_area=1e4, rainfall=2.0,
                   evap=0.5, connections=[(5, 1e-3, 29.0), (6, 1e-3, 29.0)])],
             [dict(lake=0, to=-1, type="manning", invert=31.0, width=2.0,
                   rough=0.03, slope=1e-3)])
    reaches = [dict(node=11 + r, cond=0.5, strtop=29.5 - 0.1 * r, width=3.0,
                    rough=0.03, slope=1e-3, length=100.0,
                    strt=29.8 - 0.1 * r, inflow=2.0 if r == 0 else 0.0,
                    upstream=[(r - 1, 1.0)] if 0 < r < 5 else [],
                    diversions=[dict(to=5, cprior="fraction", flow=0.3)]
                    if r == 2 else []) for r in range(6)]
    cols = [dict(node=n, vks=0.3, thtr=0.05, thts=0.35, thti=0.1, eps=3.5,
                 celtop=49.0, celbot=0.0, surfdep=1.0, area=1e4, finf=1e-3,
                 pet=0.0, extdp=1.0, extwc=0.05) for n in (2, 3)]

    def run(name, kind="gwt", maw=False, lak=False, sfr=False, mvr=None,
            uzf=False, ext=None):
        g = DisGrid.create(**grid)
        flow = AugmentedGwfModel(
            build_gwf(name, g, device=dev, **fkw),
            maw=build_maw(wells, g) if maw else None,
            lak=build_lak(*lakes) if lak else None,
            sfr=build_sfr(reaches) if sfr else None, mvr=mvr)
        if kind == "gwt":
            base = build_gwt(name, g, porosity=0.3, device=dev,
                             ssm_spec={"RCH": 0.2})
        else:
            base = build_gwe(name, g, strt=10.0, device=dev,
                             cnd=dict(ktw=0.58, kts=2.5),
                             ssm_spec={"RCH": 20.0})
        columns = (uzf_mod.make_uzf(cols, nz=10, device=dev) if uzf
                   else None)
        gwt = AugmentedGwtModel(base, flow, uzf=columns)
        if kind == "gwe":
            gwt.strt_extra = torch.full((gwt.n_extra,), 10.0,
                                        dtype=torch.float64, device=dev)
        settings = s if kind == "gwt" else heat_s
        sim = Simulation(Tdis((StressPeriod(20.0, 4, 1.2),)), flow,
                         ImsSettings(**s), gwt=gwt,
                         gwt_settings=ImsSettings(**settings))
        sim.uzf = columns
        sim.apt_ext_conc = ext or {}
        recs = sim.run()
        return (torch.as_tensor(sim.conc_records[-1]),
                [(r.outer, r.transport_outer) for r in recs],
                all(r.converged and r.transport_converged for r in recs),
                settings)

    def gwe_packages():
        g = DisGrid.create(**grid)
        sim = Simulation(
            Tdis((StressPeriod(20.0, 4, 1.2),)),
            build_gwf("gwe", g, device=dev, **fkw), ImsSettings(**s),
            gwt=build_gwe("gwe", g, strt=10.0, scheme="tvd", device=dev,
                          cnd=dict(alh=10.0, ath1=1.0, ktw=0.58, kts=2.5),
                          ctp=[(3, 60.0), (3, 80.0)],
                          esl=[(17, 1e6), (17, 2e6)],
                          decay=(3, 1.0, 2.0), ssm_spec={"RCH": 20.0}),
            gwt_settings=ImsSettings(**heat_s), conc_text="TEMPERATURE")
        recs = sim.run()
        return (torch.as_tensor(sim.conc_records[-1]),
                [(r.outer, r.transport_outer) for r in recs],
                all(r.converged and r.transport_converged for r in recs),
                heat_s)

    def merged():
        half = dict(grid, ncol=5, botm=grid["botm"][:, :, :5])
        g = DisGrid.create(**half)
        members = [build_gwf(n, g, k=2.0, strt=15.0, device=dev, chd=chd,
                             storage={"ss": 1e-4, "iconvert": 0})
                   for n, chd in (("w", [(i * 5, 16.0) for i in range(3)]),
                                  ("e", [(i * 5 + 4, 14.0)
                                         for i in range(3)]))]
        pairs = [exchange.ExchangePair(i * 5 + 4, i * 5, ihc=1, cl1=50.0,
                                       cl2=50.0, hwva=100.0)
                 for i in range(3)]
        fm = exchange.merge_gwf_models(members, [exchange.GwfGwfExchange(
            0, 1, pairs)])
        kw = dict(strt=10.0, device=dev, cnd=dict(ktw=0.58, kts=2.5))
        tm = merge_gwe_models([build_gwe("ew", g, ctp=[(0, 40.0)], **kw),
                               build_gwe("ee", g, esl=[(7, 1e6)], **kw)], fm)
        sim = Simulation(Tdis((StressPeriod(20.0, 4, 1.2),)), fm,
                         ImsSettings(**s), gwt=tm,
                         gwt_settings=ImsSettings(**heat_s))
        recs = sim.run()
        return (torch.as_tensor(sim.conc_records[-1]),
                [(r.outer, r.transport_outer) for r in recs],
                all(r.converged and r.transport_converged for r in recs),
                heat_s)

    wel_mvr = [dict(provider="wel", iprov=0, receiver="sfr", ircv=1,
                    mvrtype="factor", value=0.5)]
    sfr_mvr = [dict(provider="sfr", iprov=4, receiver="lak", ircv=0,
                    mvrtype="factor", value=1.0)]
    twins = []
    for kind, t in (("gwt", dict(lak=0.5, sfr=1.0, maw=0.3, uzf=0.8)),
                    ("gwe", dict(lak=15.0, sfr=18.0, maw=12.0, uzf=20.0))):
        names = ("lkt", "sft with a diversion", "mwt", "uzt") \
            if kind == "gwt" else ("lke", "sfe with a diversion", "mwe",
                                   "uze")
        for name, feat in zip(names, ("lak", "sfr", "maw", "uzf")):
            twins.append((name, lambda kind=kind, feat=feat, t=t: run(
                feat, kind, ext={feat: t[feat]}, **{feat: True})))
    twins += [
        ("mvt from a wel provider", lambda: run(
            "mvtw", sfr=True, mvr=wel_mvr, ext={"sfr": 1.0})),
        ("mvt from a feature provider", lambda: run(
            "mvtf", lak=True, sfr=True, mvr=sfr_mvr,
            ext={"sfr": 1.0, "lak": 0.0})),
        ("gwe with each package", gwe_packages),
        ("merge_gwe_models", merged)]
    return twins


def check_small_apt(device, names=None):
    """Small APT and GWE twins on the card against the CPU (LKT, SFT with
    a diversion, MWT, UZT and their GWE analogs, MVT from a WEL provider
    and from a feature provider, GWE with each package, two merged GWE
    models): equal outer counts, values within 10 × outer_dvclose."""
    cpu = dict(small_apt_models("cpu"))
    for name, run in small_apt_models(device):
        if names is not None and name not in names:
            continue
        c, k, ok, s = run()
        c0, k0, ok0, _ = cpu[name]()
        err = float((c - c0).abs().max())
        bar = CLOSURE_FACTOR * s["outer_dvclose"]
        print(f"small apt/gwe {name}: card counts={k} converged={ok}; cpu "
              f"counts={k0} converged={ok0}; max|dc|={err!r} bar={bar!r}")
        if not (ok and ok0 and k == k0 and err <= bar):
            raise AssertionError(f"small apt/gwe {name}: the card disagrees "
                                 "with the CPU")


# ------------------------------------------------ the apt and gwe phases

# (a1)-(a3) and (e3): the advanced model's three 5-d steps
# two steps of 5 d (cut in depth for the phases' time limit)
APT_PERIODS = ((10.0, 2, 1.0),)
# (e1)-(e3): heat on the bench grid; TVD, EST, CND, CTP at 80 °C on the
# plume's CNC block, ESL on its SRC cells, recharge at 25 °C through SSM,
# starting at 10 °C; the west CHD column's inflow enters at 0 °C (SSM's
# default), so the sources' range is [0, 80]
HEAT_EST = dict(porosity=0.3, rhos=2650.0, cps=800.0)
HEAT_CND = dict(alh=10.0, ath1=1.0, atv=0.1, ktw=0.58, kts=2.5)
HEAT_CTP, HEAT_ESL, HEAT_RCH, HEAT_STRT = 80.0, 1.0e6, 25.0, 10.0
# the heat transport's closures: the plume's with inner_rclose scaled by
# rhow·cpw, the factor of every entry of an energy system, and an outer
# closure of 0.1 °C: on the long steps TVD's Picard iterates settle into a
# two-cycle whose amplitude grows with the grid and the step (at 1e-5 °C a
# CPU run of (e1) at 4 x 128 x 128 takes outer_maximum on every 365-d step)
HEAT_TRANSPORT = dict(PLUME_TRANSPORT, outer_dvclose=0.1,
                      inner_rclose=PLUME_TRANSPORT["inner_rclose"]
                      * 1000.0 * 4184.0)
# (e3)'s sources: SFE INFLOW 18 °C on the headwater reaches, LKE RAINFALL
# 15 °C
HEAT_SFE, HEAT_LKE = 18.0, 15.0


def heat_transport(device, grid, shape):
    """(e1)'s GWE model on the bench grid ``grid``."""
    nlay, nrow, ncol = shape
    ctp, esl = plume_layout(shape)
    return build_gwe(
        "heat", grid, strt=HEAT_STRT, scheme="tvd", cnd=HEAT_CND,
        ctp=[(n, HEAT_CTP) for n in ctp], esl=[(n, HEAT_ESL) for n in esl],
        ssm_spec={"RCH": np.full(nrow * ncol, HEAT_RCH)}, device=device,
        **HEAT_EST)


def apt_models(device, shape, kind="gwt"):
    """(flow, transport, sources) of (a1), or of (e3) with ``kind`` "gwe":
    ``mvr_model``'s features and movers with the plume's GWT model (or
    (e1)'s GWE model) and the features' rows; SFT INFLOW 1.0 (SFE 18 °C)
    on the headwater reaches, LKT RAINFALL 0.0 (LKE 15 °C), MWT (MWE) on
    the pumping wells, the GWE rows starting at 10 °C."""
    flow = mvr_model(device, shape)
    head = (flow.sfr.inflow > 0).to(torch.float64)
    if kind == "gwt":
        base = plume_transport(device, flow.grid, shape)
        ext = {"sfr": head, "lak": 0.0, "maw": 0.0}
    else:
        base = heat_transport(device, flow.grid, shape)
        ext = {"sfr": head * HEAT_SFE, "lak": HEAT_LKE, "maw": 0.0}
    gwt = AugmentedGwtModel(base, flow)
    if kind == "gwe":
        gwt.strt_extra = torch.full((gwt.n_extra,), HEAT_STRT,
                                    dtype=torch.float64, device=device)
    return flow, gwt, ext


def print_steps(label, recs, steps):
    for r, s in zip(recs, steps):
        print(f"{label} kper={r.kper} kstp={r.kstp} flow outer={r.outer} "
              f"inner={r.inner} transport outer={r.transport_outer} "
              f"inner={r.transport_inner} fmi_s={r.fmi_seconds!r} "
              f"extract_apt_flows_s={r.apt_seconds!r} "
              f"assembly_s={s['assembly_s']!r} "
              f"bicgstab_iterations={s['bicgstab_iterations']} "
              f"bicgstab_s={s['bicgstab_s']!r} ms_per_bicgstab_iteration="
              f"{s['bicgstab_s'] / max(s['bicgstab_iterations'], 1) * 1e3!r}"
              f" stencil7_flow={s['flow_launches']} "
              f"stencil7_transport={s['transport_launches']} "
              f"peak_bytes={s['peak_bytes']}")


def balanced_features(gwt, flows, delt, uzf_res=None):
    """(bool[feature rows], the largest relative imbalance): the feature
    rows whose water balance in the transport's terms closes (|in − out −
    Δstorage| within 1e-6 of their sum, and their water above 1e-9 of the
    largest feature's).  A UZT row's balance counts the column's
    evapotranspiration (``uzf_res.uzet`` × area, the step's march) as an
    outflow that takes no mass.  Only there is a feature's concentration bound to
    its sources' range: a lake's evaporation takes water and no mass (LKT's
    evapoconcentration), and a reach's flow equation has no storage where
    the transport's has the reach's volume, so a reach that dries within a
    step concentrates its mass into the water left (to 1e5-1e14 on the
    coupling phase's mover model at 4 x 128 x 128 on the CPU, as the
    reference's equations give), which its downstream reaches inherit
    (ROADMAP Queue C, R19);
    ``run_coupled`` leaves the reaches out of its check."""
    f = {k: getattr(flows, k).cpu().numpy() for k in (
        "v_new", "v_old", "out_q", "ext_q", "q_conn", "pair_q",
        "mvr_cell_q")}
    inflow = f["v_old"] / delt + f["ext_q"]
    outflow = f["v_new"] / delt + f["out_q"]
    conn = gwt.conn_feat.cpu().numpy()
    np.add.at(outflow, conn, np.maximum(f["q_conn"], 0.0))
    np.add.at(inflow, conn, np.maximum(-f["q_conn"], 0.0))
    np.add.at(inflow, gwt.pair_dst.cpu().numpy(), f["pair_q"])
    np.add.at(inflow, gwt.mvr_cell_dst.cpu().numpy(), f["mvr_cell_q"])
    if gwt.uzf is not None and uzf_res is not None:
        sl = slice(gwt._uzf_off, gwt._uzf_off + gwt.uzf.node.shape[0])
        outflow[sl] += (uzf_res.uzet * gwt.uzf.area).cpu().numpy()
    size = inflow + outflow
    imbalance = np.abs(inflow - outflow) / np.where(size > 0, size, 1.0)
    return ((imbalance <= 1e-6) & (size > 1e-9 * size.max(initial=0.0)),
            float(imbalance.max(initial=0.0)))


def run_coupled(label, sim, device, bounds, rclose, time_gather=False):
    """``sim`` once, instrumented: the per-step lines, the checks every
    transport run of the apt and gwe phases passes (every step converged,
    every value finite, the grid rows within ``bounds`` to 1e-4 and, with
    APT rows, the balanced well, lake and UZT rows (``balanced_features``)
    too, the reaches reported beside them, the
    last system's residual within ``rclose``, no plain stencil on the
    card), and with ``time_gather`` the transport's gather at its table
    width.  Returns (records, stencil7 launches of the flow, of the
    transport)."""
    steps, last = instrument_transport(sim, device)
    fields, marches = [], []
    solve = sim._solve_transport

    def keep(*args, **kwargs):
        out = solve(*args, **kwargs)
        fields.append(out.fields)
        march = kwargs.get("uzf_step")
        marches.append(None if march is None else march[0])
        return out

    sim._solve_transport = keep
    with counted_run() as counts:
        t0 = time.perf_counter()
        recs = sim.run()
        sync(device)
        seconds = time.perf_counter() - t0
    resid = final_residual(sim, last)
    gwt = sim.gwt
    n = gwt.grid.nodes
    checked, others, worst, rows_checked = [], [], 0.0, 0
    for c, f, u, r, p in zip(sim.conc_records, fields, marches, recs,
                             [None] + recs[:-1]):
        checked.append(c[:n])
        if isinstance(gwt, AugmentedGwtModel):
            ok, imb = balanced_features(gwt, f, r.totim - (p.totim if p
                                                            else 0.0), u)
            # the reaches inherit what a drying reach upstream concentrated
            sfr = getattr(gwt.gwf, "sfr", None)
            if sfr is not None:
                first = gwt.gwf._sfr_offset - n
                ok[first:first + sfr.nreaches] = False
            checked.append(c[n:][ok])
            others.append(c[n:][~ok])
            rows_checked += int(ok.sum())
            worst = max(worst, imb)
    lo = min(float(c.min(initial=np.inf)) for c in checked)
    hi = max(float(c.max(initial=-np.inf)) for c in checked)
    other = np.concatenate(others) if others else np.zeros(0)
    out = int(((other < bounds[0] - CONC_SLACK)
               | (other > bounds[1] + CONC_SLACK)).sum())
    nbr = gwt.dtopo.nbr
    print_steps(label, recs, steps)
    print(f"{label}: rows={gwt.nodes} feature_rows="
          f"{getattr(gwt, 'n_extra', 0)} Ktot={nbr.shape[1]} table_bytes="
          f"{nbr.numel() * nbr.element_size()} run_s={seconds!r} "
          f"checked min={lo!r} max={hi!r} bounds={bounds}; balanced "
          f"feature values checked (all steps)={rows_checked}, unbalanced "
          f"feature values (all steps)={other.size}, out of bounds={out}, "
          f"range=[{float(other.min(initial=0.0))!r}, "
          f"{float(other.max(initial=0.0))!r}], largest relative water "
          f"imbalance={worst!r}; final_residual={resid!r} "
          f"rclose={rclose!r} stencil7_launches={counts['launches']} "
          f"peak_bytes={max(s['peak_bytes'] for s in steps)}")
    if not all(r.converged and r.transport_converged for r in recs):
        raise AssertionError(f"{label}: a step did not converge")
    if not all(np.isfinite(c).all() for c in sim.conc_records):
        raise AssertionError(f"{label}: values not finite")
    if not (bounds[0] - CONC_SLACK <= lo and hi <= bounds[1] + CONC_SLACK):
        raise AssertionError(f"{label}: values [{lo}, {hi}] outside "
                             f"{bounds}")
    if not resid <= rclose:
        raise AssertionError(f"{label}: final residual {resid} above the "
                             "closure")
    if counts["plain_on_cuda"] or any(s["transport_launches"]
                                      for s in steps):
        raise AssertionError(f"{label}: the plain stencil on the card, or "
                             "a transport solve through the stencil")
    if time_gather and torch.device(device).type == "cuda":
        inner = sum(s["bicgstab_iterations"] for s in steps)
        solve = sum(s["bicgstab_s"] for s in steps)
        time_transport_gather(sim, last, solve / inner * 1e3, label)
    return recs, sum(s["flow_launches"] for s in steps), \
        sum(s["transport_launches"] for s in steps)


# a repeat cut to the first 5-d step of (t1), (a1) and (e1)
FIRST_STEP = ((5.0, 1, 1.0),)


def bitwise_first_step(label, full, first):
    """A repeat over ``FIRST_STEP`` against the full run's first step:
    counts, heads and transport values bitwise."""
    (sa, ra), (sb, rb) = full, first

    def key(r):
        return (r.outer, r.inner, r.transport_outer, r.transport_inner)

    same = (len(rb) == 1 and key(ra[0]) == key(rb[0])
            and np.array_equal(ra[0].head, rb[0].head)
            and np.array_equal(sa.conc_records[0], sb.conc_records[0]))
    print(f"{label} the repeat's first step bitwise equal to the run's="
          f"{same}")
    if not same:
        raise AssertionError(f"{label}: the repeat's first step differs")


def run_apt_memory(device, shape, label, time_gather=False,
                   periods=APT_PERIODS):
    """(a1) once: the mover model's flow and its APT transport through
    ``Simulation`` over ``periods``."""
    flow, gwt, ext = apt_models(device, shape)
    sim = Simulation(Tdis(tuple(StressPeriod(*p) for p in periods)),
                     flow, advanced_settings(), gwt=gwt,
                     gwt_settings=ImsSettings(**PLUME_TRANSPORT))
    sim.apt_ext_conc = ext
    recs, fl, tl = run_coupled(f"apt (a1) {label}", sim, device, (0.0, 1.0),
                               PLUME_TRANSPORT["inner_rclose"], time_gather)
    return sim, recs, fl + tl


def apt_files(shape):
    """(a2)'s transport files: SFT6 (INFLOW 1.0 on the headwater reaches),
    LKT6 (RAINFALL 0.0), MWT6 and MVT6."""
    wells, lakes, path, ntrib, nmain, nside = advanced_layout(*shape)
    R = len(path)
    sft = "BEGIN PACKAGEDATA\n" + "".join(
        f"  {r + 1} 0.0\n" for r in range(R)) + "END PACKAGEDATA\n" \
        "BEGIN PERIOD 1\n" + "".join(
            f"  {r + 1} INFLOW 1.0\n" for r in (0, ntrib)) + "END PERIOD\n"
    lkt = "BEGIN PACKAGEDATA\n" + "".join(
        f"  {k + 1} 0.0\n" for k in range(len(lakes))) + \
        "END PACKAGEDATA\nBEGIN PERIOD 1\n" + "".join(
            f"  {k + 1} RAINFALL 0.0\n" for k in range(len(lakes))) + \
        "END PERIOD\n"
    mwt = "BEGIN PACKAGEDATA\n" + "".join(
        f"  {w + 1} 0.0\n" for w in range(len(wells))) + "END PACKAGEDATA\n"
    return [("SFT6 t.sft", sft), ("LKT6 t.lkt", lkt), ("MWT6 t.mwt", mwt),
            ("MVT6 t.mvt", "BEGIN OPTIONS\nEND OPTIONS\n")]


def run_deck_cli(label, device, ws, memory, values_file, text):
    """A written deck through the command-line entry: its values file
    (.ucn) against the in-memory run's records bitwise, its counts equal.
    Returns the stencil7 launches."""
    msim, mrecs = memory
    out = io.StringIO()
    with captured_loads(device) as loads, counted_run() as counts, \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        code = cli_main([ws] + ([] if torch.device(device).type == "cuda"
                                else ["--device", "cpu"]))
        sync(device)
        cli_s = time.perf_counter() - t0
    sim, load_s = loads[0]
    recs = sim.records
    ucn = read_head_file(os.path.join(ws, values_file))
    n = msim.gwt.grid.nodes
    nlay = msim.gwt.grid.shape[0]
    vals = [np.concatenate([r["data"].reshape(-1) for r in ucn[i:i + nlay]])
            for i in range(0, len(ucn), nlay)]
    counts_of = [(r.outer, r.inner, r.transport_outer, r.transport_inner)
                 for r in recs]
    want = [(r.outer, r.inner, r.transport_outer, r.transport_inner)
            for r in mrecs]
    bitwise = len(vals) == len(msim.conc_records) and all(
        np.array_equal(a, b[:n]) for a, b in zip(vals, msim.conc_records))
    err = max(float(np.abs(a - b[:n]).max())
              for a, b in zip(vals, msim.conc_records))
    texts = {r["text"].strip() for r in ucn}
    print(f"{label} deck cli exit={code} wall_s={cli_s!r} load_s={load_s!r} "
          f"counts={counts_of} records={len(vals)} texts={sorted(texts)} "
          f"bitwise_equal_in_memory={bitwise} max|deck - memory|={err!r} "
          f"stencil7_launches={counts['launches']} "
          f"stdout={out.getvalue().strip()!r}")
    if code != 0 or "Normal termination" not in out.getvalue() \
            or counts_of != want or not bitwise or texts != {text} \
            or counts["plain_on_cuda"]:
        raise AssertionError(f"{label}: the deck differs from its in-memory "
                             "run")
    return counts["launches"]


def write_apt_deck(ws, shape, periods=APT_PERIODS):
    """(a2): (a1) as a deck over ``periods``: the mover deck of (m3)
    (MAW6, LAK6, SFR6, MVR6, the MOVER options) with the recharge as an
    RCH6 list at the plume's concentration, and the plume's GWT6 model with
    the APT files."""
    grid = flagship_grid(*shape)
    _, records = coupling_movers(shape)
    files = write_advanced_files(ws, advanced_features(
        grid, flagship_kfield(*shape)), grid)
    for name in ("m.maw", "m.lak", "m.sfr"):
        text = open(os.path.join(ws, name)).read()
        _write(ws, name, "BEGIN OPTIONS\n  MOVER\nEND OPTIONS\n" + text)
    _write(ws, "m.mvr", "BEGIN DIMENSIONS\n  MAXMVR "
           f"{len(records)}\n  MAXPACKAGES 4\nEND DIMENSIONS\n"
           "BEGIN PACKAGES\n  WEL-1\n  MAW-1\n  LAK-1\n  SFR-1\n"
           "END PACKAGES\nBEGIN PERIOD 1\n" + "\n".join(records)
           + "\nEND PERIOD\n")
    write_plume_deck(ws, shape, periods=periods,
                     flow=dict(BENCH), acc="BICGSTAB",
                     apt_files=apt_files(shape), wel_options="  MOVER\n",
                     extra_packages=files + ["MVR6 m.mvr"])


def run_uzt(device, shape):
    """(a3) UZT on the coupling phase's UZF columns (one per top cell)
    through ``Simulation``: an augmented flow model without features (the
    reference's Simulation runs UZT on an AugmentedGwfModel), the plume's
    GWT model with a row per column, the infiltration at 1.0."""
    from modflow6_torch.models.gwf import uzf as uzf_mod
    flow = AugmentedGwfModel(uzf_base(device, shape))
    uzf = uzf_mod.make_uzf(uzf_columns(shape), device=device, **UZF_FLAGS)
    base = plume_transport(device, flow.grid, shape)
    base.ssm_spec = None
    gwt = AugmentedGwtModel(base, flow, uzf=uzf)
    sim = Simulation(Tdis(tuple(StressPeriod(*p) for p in APT_PERIODS)),
                     flow, ImsSettings(**BENCH), gwt=gwt,
                     gwt_settings=ImsSettings(**PLUME_TRANSPORT))
    sim.uzf = uzf
    sim.apt_ext_conc = {"uzf": 1.0}
    recs, fl, tl = run_coupled("apt (a3) uzt", sim, device, (0.0, 1.0),
                               PLUME_TRANSPORT["inner_rclose"])
    print(f"apt (a3) uzt: columns={uzf.node.shape[0]} uzf_resolves="
          f"{[r.uzf_resolves for r in recs]}")
    return fl + tl


def run_apt(device, shape=BENCH_SHAPE):
    """The apt phase: (a1) the mover model with APT transport, and its
    first step again (bitwise), (a2) its deck over the first step through
    the command-line entry (bitwise against the repeat), (a3) UZT on
    the UZF columns.  Returns the stencil7 launches (none: no model here
    has a grid shape)."""
    t0 = time.perf_counter()
    # the repeat is the first step, held bitwise (the phases' time limit)
    runs = [run_apt_memory(device, shape, "run 1", time_gather=True),
            run_apt_memory(device, shape, "run 2 (first step)",
                           periods=FIRST_STEP)]
    bitwise_first_step("apt (a1)", runs[0][:2], runs[1][:2])
    launches = runs[0][2] + runs[1][2]
    del runs[0]
    # the deck's depth cut to the first step too: held against the repeat
    with tempfile.TemporaryDirectory() as ws:
        write_apt_deck(ws, shape, periods=FIRST_STEP)
        launches += run_deck_cli("apt (a2)", device, ws, runs[0][:2],
                                 "t.ucn", "CONCENTRATION")
    del runs
    launches += run_uzt(device, shape)
    print(f"apt phase in {time.perf_counter() - t0!r} s, "
          f"stencil7_launches={launches}")
    if launches:
        raise AssertionError("the apt runs launched stencil7")
    return launches


def run_heat_memory(device, shape, label, periods=PLUME_PERIODS):
    """(e1) once: the bench model and its heat transport through
    ``Simulation`` over (t1)'s steps (``periods``)."""
    flow = flagship(*shape, device)
    sim = Simulation(Tdis(tuple(StressPeriod(*p) for p in periods)),
                     flow, ImsSettings(**PLUME_FLOW),
                     gwt=heat_transport(device, flow.grid, shape),
                     gwt_settings=ImsSettings(**HEAT_TRANSPORT),
                     conc_text="TEMPERATURE")
    recs, fl, tl = run_coupled(f"gwe (e1) {label}", sim, device,
                               (0.0, HEAT_CTP),
                               HEAT_TRANSPORT["inner_rclose"])
    return sim, recs, fl + tl


def write_heat_deck(ws, shape, periods=PLUME_PERIODS):
    """(e2): (e1) as a GWF6 + GWE6 deck over ``periods``: the recharge as
    an RCH6 list with a TEMPERATURE column, ADV6 TVD, EST6, CND6
    (XT3D_OFF), SSM6, CTP6, ESL6, temperatures saved every step."""
    write_coupled_flow(ws, shape, model="GWE6", tname="HEAT",
                       aux="TEMPERATURE", value=HEAT_RCH,
                       transport=HEAT_TRANSPORT, periods=periods)
    _write(ws, "t.nam", "BEGIN PACKAGES\n" + "".join(
        f"  {line}\n" for line in (
            "DIS6 t.dis", "IC6 t.ic", "ADV6 t.adv", "EST6 t.est",
            "CND6 t.cnd", "SSM6 t.ssm", "CTP6 t.ctp", "ESL6 t.esl",
            "OC6 t.oc")) + "END PACKAGES\n")
    _write(ws, "t.ic", f"BEGIN GRIDDATA\n  STRT\n    CONSTANT {HEAT_STRT!r}"
           "\nEND GRIDDATA\n")
    _write(ws, "t.adv", "BEGIN OPTIONS\n  SCHEME TVD\nEND OPTIONS\n")
    e = HEAT_EST
    _write(ws, "t.est", f"""BEGIN GRIDDATA
  POROSITY
    CONSTANT {e['porosity']!r}
  DENSITY_SOLID
    CONSTANT {e['rhos']!r}
  HEAT_CAPACITY_SOLID
    CONSTANT {e['cps']!r}
END GRIDDATA
""")
    _write(ws, "t.cnd", "BEGIN OPTIONS\n  XT3D_OFF\nEND OPTIONS\n"
           "BEGIN GRIDDATA\n" + "".join(
               f"  {k.upper()}\n    CONSTANT {v!r}\n"
               for k, v in HEAT_CND.items()) + "END GRIDDATA\n")
    _write(ws, "t.ssm", "BEGIN SOURCES\n  RCH-1 AUX TEMPERATURE\n"
           "END SOURCES\n")
    ctp, esl = plume_layout(shape)
    _block_file(ws, "t.ctp", shape, ctp, HEAT_CTP)
    _block_file(ws, "t.esl", shape, esl, HEAT_ESL)
    _write(ws, "t.oc", """BEGIN OPTIONS
  TEMPERATURE FILEOUT t.ucn
END OPTIONS
BEGIN PERIOD 1
  SAVE TEMPERATURE ALL
END PERIOD
""")


def run_gwe(device, shape=BENCH_SHAPE):
    """The gwe phase: (e1) heat on the bench model, and its first step
    again (bitwise), (e2) over the first step
    its deck through the command-line entry, (e3) the mover model with a
    GWE base (LKE, SFE, MWE rows) once, over (a1)'s first step.  Returns the stencil7 launches,
    which must be some: (e1)'s flow keeps its grid shape."""
    t0 = time.perf_counter()
    # the repeat is the first step, held bitwise (the phases' time limit)
    runs = [run_heat_memory(device, shape, "run 1"),
            run_heat_memory(device, shape, "run 2 (first step)",
                            periods=FIRST_STEP)]
    bitwise_first_step("gwe (e1)", runs[0][:2], runs[1][:2])
    launches = runs[0][2] + runs[1][2]
    del runs[0]
    # the deck's depth cut to the first step too: held against the repeat
    with tempfile.TemporaryDirectory() as ws:
        write_heat_deck(ws, shape, periods=FIRST_STEP)
        launches += run_deck_cli("gwe (e2)", device, ws, runs[0][:2],
                                 "t.ucn", "TEMPERATURE")
    del runs
    flow, gwe, ext = apt_models(device, shape, kind="gwe")
    # (e3) takes (a1)'s first 5-d step (the phase's time limit)
    sim = Simulation(Tdis((StressPeriod(5.0, 1, 1.0),)),
                     flow, advanced_settings(), gwt=gwe,
                     gwt_settings=ImsSettings(**HEAT_TRANSPORT),
                     conc_text="TEMPERATURE")
    sim.apt_ext_conc = ext
    recs, fl, tl = run_coupled("gwe (e3) lke/sfe/mwe", sim, device,
                               (0.0, HEAT_CTP),
                               HEAT_TRANSPORT["inner_rclose"],
                               time_gather=True)
    del sim
    print(f"gwe phase in {time.perf_counter() - t0!r} s, "
          f"stencil7_launches={launches}")
    if not launches:
        raise AssertionError("the gwe runs launched no stencil7 kernel")
    return launches


# ---------------------------------------------- the swf and prt phases

# (s1)/(s2): overland flow on a raster of 10-m cells: a plane sloping 1e-3
# to the south with a microtopography of ±5 cm, Manning's n 0.03, rain of
# 1e-5 m/s on every cell, a ZDG outflow along the southern row, one
# transient step of 300 s from 1 cm of water, in seconds; upstream depth
# weighting (DFW6 without CENTRAL_IN_SPACE), which holds the puddles of
# the microtopography that central weighting drains below the land
OLF_SLOPE, OLF_N, OLF_RAIN, OLF_MICRO, OLF_DEPTH = 1e-3, 0.03, 1e-5, 0.05, 0.01
OLF_PERIODS = ((300.0, 1, 1.0),)
# the n-point section of every sixteenth reach of (s3)/(s4): a trapezoid,
# its stations fractions of the reach's width, rougher on the banks
CHF_SECTION = ([0.0, 0.25, 0.75, 1.0], [1.0, 0.0, 0.0, 1.0],
               [1.3, 1.0, 1.3])
# (s3)/(s4): a binary tree of 2**14 - 1 reaches of 100 m, in days (Manning
# in m³/s converted by DFW's TIME_CONVERSION), 0.1 m³/s into each
# headwater reach, two steps of one day
CHF_DEPTH, CHF_LENGTH, CHF_N, CHF_SLOPE = 14, 100.0, 0.035, 1e-2
CHF_TCONV = 1.0 / 86400.0
CHF_UNITCONV = 1.0 ** (1.0 / 3.0) / CHF_TCONV     # the loader's arithmetic
CHF_FLW, CHF_COND = 8640.0, 0.04                  # m³/d a headwater; m²/d
CHF_PERIODS = ((2.0, 2, 1.0),)
# (p1)-(p3): particle tracking over three steps of 5 d, porosity 0.3,
# releases at 0 and 5 d
PRT_PERIODS = ((15.0, 3, 1.0),)
PRT_PERIODS_FIRST = ((5.0, 1, 1.0),)
PRT_TIMES = (0.0, 5.0)
PRT_POROSITY = 0.3


def olf_land(nrow, ncol):
    """The raster's land surface, south (the last row) lowest: the plane
    and a microtopography of eight waves with random directions,
    wavelengths of 50–400 m and phases from a seed, scaled to ±5 cm."""
    rng = np.random.default_rng(31)
    y, x = np.meshgrid((np.arange(nrow) + 0.5) * 10.0,
                       (np.arange(ncol) + 0.5) * 10.0, indexing="ij")
    micro = np.zeros((nrow, ncol))
    for _ in range(8):
        ang, lam, phase = rng.uniform(0.0, np.pi), rng.uniform(50.0, 400.0), \
            rng.uniform(0.0, 2.0 * np.pi)
        micro += np.sin(2.0 * np.pi * (x * np.cos(ang) + y * np.sin(ang))
                        / lam + phase)
    plane = (nrow - 1 - np.arange(nrow))[:, None] * 10.0 * OLF_SLOPE
    return plane + OLF_MICRO * micro / np.abs(micro).max()


def olf_model(device, nrow, ncol):
    """(s1)'s OLF model on a DIS2D raster."""
    from modflow6_torch.models.swf.model import build_olf
    land = olf_land(nrow, ncol)
    grid = DisGrid.create(1, nrow, ncol, 10.0, 10.0, float(land.max()) + 1.0,
                          land[None])
    n = nrow * ncol
    south = (nrow - 1) * ncol + np.arange(ncol)
    return build_olf(
        "olf", grid, manningsn=OLF_N, strt=land.reshape(-1) + OLF_DEPTH,
        icentral=0,
        pcp=np.stack([np.arange(n), np.full(n, OLF_RAIN)], 1),
        zdg=np.stack([south, np.full(ncol, 10.0), np.full(ncol, OLF_SLOPE),
                      np.full(ncol, OLF_N)], 1), device=device)


def swf_volume(model, stage):
    """The water stored on the cells: area × the smoothed depth."""
    from modflow6_torch.models.swf.model import _squadratic
    d = stage - model.bot
    return model.area * d * _squadratic(d)


def run_olf(device, nrow, ncol, label, periods=OLF_PERIODS):
    """(s1) once: the raster through ``SwfSimulation`` over ``periods``;
    the volume change of each step against (PCP + ZDG)·Δt.  Returns
    (records, seconds)."""
    from modflow6_torch.models.swf.simulation import SwfSimulation
    model = olf_model(device, nrow, ncol)
    sim = SwfSimulation(Tdis(tuple(StressPeriod(*p) for p in periods)),
                        model, has_sto=True, sto_periods={1: True})
    steps = []
    solve = sim.solution.solve_timestep

    def counted(stage, delt, **kw):
        out = solve(stage, delt, **kw)
        ib = out[2]["ibound"]
        flows = model.boundary_budget(out[0], ib)
        steps.append((stage, out[0], delt, flows))
        return out

    sim.solution.solve_timestep = counted
    with counted_run() as counts:
        t0 = time.perf_counter()
        recs = sim.run()
        sync(device)
        seconds = time.perf_counter() - t0
    worst, low = 0.0, np.inf
    for old, new, delt, flows in steps:
        dv = float((swf_volume(model, new) - swf_volume(model, old)).sum())
        q = float(sum(v.sum() for v in flows.values())) * delt
        worst = max(worst, abs(dv - q) / abs(q))
        low = min(low, float((new - model.bot).min()))
    print(f"{label}: cells={model.nodes} steps={len(recs)} "
          f"outers={[r.outer for r in recs]} inners={[r.inner for r in recs]}"
          f" converged={all(r.converged for r in recs)} run_s={seconds!r} "
          f"largest |dV - (PCP + ZDG)dt| / |(PCP + ZDG)dt|={worst!r} "
          f"lowest depth={low!r} stencil7_launches={counts['launches']} "
          f"peak_bytes={peak_bytes(device)}")
    if not all(r.converged for r in recs):
        raise AssertionError(f"{label}: a step did not converge")
    if not worst <= 1e-6:
        raise AssertionError(f"{label}: the volume change misses the rain "
                             f"less the outflow by {worst}")
    if low < -1e-6:
        raise AssertionError(f"{label}: a stage {low} below the land")
    return recs, seconds


def write_olf_deck(ws, nrow, ncol):
    """(s1) as an OLF6 deck: DIS2D6 and IC6 arrays as binary files, DFW6
    (upstream weighting), STO6, a PCP6 list of a row per cell, ZDG6 along
    the southern row, OC6 saving every step's STAGE."""
    land = olf_land(nrow, ncol)
    for name, arr in (("land.bin", land), ("strt.bin",
                                           land + OLF_DEPTH)):
        with open(os.path.join(ws, name), "wb") as f:
            f.write(struct.pack("<iidd16siii", 1, 1, 1.0, 1.0,
                                b"ARRAY".rjust(16), ncol, nrow, 1))
            np.asarray(arr, "<f8").tofile(f)
    _write(ws, "mfsim.nam", "BEGIN TIMING\n  TDIS6 sim.tdis\nEND TIMING\n"
           "BEGIN MODELS\n  OLF6 olf.nam OLF\nEND MODELS\n"
           "BEGIN SOLUTIONGROUP 1\n  IMS6 sim.ims OLF\nEND SOLUTIONGROUP\n")
    _write(ws, "sim.tdis", f"BEGIN DIMENSIONS\n  NPER 1\nEND DIMENSIONS\n"
           f"BEGIN PERIODDATA\n  {OLF_PERIODS[0][0]!r} {OLF_PERIODS[0][1]} "
           "1.0\nEND PERIODDATA\n")
    _write(ws, "sim.ims", SWF_IMS)
    _write(ws, "olf.nam", "BEGIN PACKAGES\n  DIS2D6 olf.dis2d\n"
           "  DFW6 olf.dfw\n  IC6 olf.ic\n  STO6 olf.sto\n  PCP6 olf.pcp\n"
           "  ZDG6 olf.zdg\n  OC6 olf.oc\nEND PACKAGES\n")
    _write(ws, "olf.dis2d", f"BEGIN DIMENSIONS\n  NROW {nrow}\n  NCOL {ncol}"
           "\nEND DIMENSIONS\nBEGIN GRIDDATA\n  DELR\n    CONSTANT 10.0\n"
           "  DELC\n    CONSTANT 10.0\n  BOTTOM\n"
           "    OPEN/CLOSE land.bin (BINARY)\nEND GRIDDATA\n")
    _write(ws, "olf.dfw", "BEGIN GRIDDATA\n  MANNINGSN\n    CONSTANT "
           f"{OLF_N!r}\nEND GRIDDATA\n")
    _write(ws, "olf.ic", "BEGIN GRIDDATA\n  STRT\n"
           "    OPEN/CLOSE strt.bin (BINARY)\nEND GRIDDATA\n")
    _write(ws, "olf.sto", "BEGIN PERIOD 1\n  TRANSIENT\nEND PERIOD\n")
    # the records inline: the SWF stress packages read no OPEN/CLOSE
    ii, jj = np.divmod(np.arange(nrow * ncol), ncol)
    _write(ws, "olf.pcp", f"BEGIN DIMENSIONS\n  MAXBOUND {nrow * ncol}\n"
           "END DIMENSIONS\nBEGIN PERIOD 1\n" + "".join(
               f"  {i + 1} {j + 1} {OLF_RAIN!r}\n"
               for i, j in zip(ii.tolist(), jj.tolist())) + "END PERIOD\n")
    _write(ws, "olf.zdg", f"BEGIN DIMENSIONS\n  MAXBOUND {ncol}\n"
           "END DIMENSIONS\nBEGIN PERIOD 1\n" + "".join(
               f"  {nrow} {j + 1} 0 10.0 {OLF_SLOPE!r} {OLF_N!r}\n"
               for j in range(ncol)) + "END PERIOD\n")
    _write(ws, "olf.oc", "BEGIN OPTIONS\n  STAGE FILEOUT olf.stage\n"
           "END OPTIONS\nBEGIN PERIOD 1\n  SAVE STAGE ALL\nEND PERIOD\n")


# SwfSimulation's settings as an IMS6 file (the loader adds the DBD
# under-relaxation a CHF/OLF deck gets when its IMS names none)
SWF_IMS = """BEGIN NONLINEAR
  OUTER_DVCLOSE 1e-08
  OUTER_MAXIMUM 300
END NONLINEAR
BEGIN LINEAR
  INNER_MAXIMUM 500
  INNER_DVCLOSE 1e-10
  INNER_RCLOSE 1e-09
  LINEAR_ACCELERATION BICGSTAB
END LINEAR
"""


def run_swf_deck_cli(label, device, ws, records, stage_file):
    """A CHF6/OLF6 deck through the command-line entry: its STAGE records
    bitwise the in-memory run's, its settings ``SwfSimulation``'s."""
    from modflow6_torch.models.swf.simulation import default_settings
    out = io.StringIO()
    with captured_loads(device) as loads, counted_run() as counts, \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        code = cli_main([ws] + ([] if torch.device(device).type == "cuda"
                                else ["--device", "cpu"]))
        sync(device)
        cli_s = time.perf_counter() - t0
    sim, load_s = loads[0]
    saved = read_head_file(os.path.join(ws, stage_file))
    bitwise = len(saved) == len(records) and all(
        np.array_equal(r["data"].reshape(-1), rec.stage)
        for r, rec in zip(saved, records))
    texts = {r["text"].strip() for r in saved}
    same_settings = sim.settings == default_settings()
    print(f"{label} deck cli exit={code} wall_s={cli_s!r} load_s={load_s!r} "
          f"records={len(saved)} texts={sorted(texts)} "
          f"settings_equal={same_settings} bitwise_equal_in_memory={bitwise} "
          f"stencil7_launches={counts['launches']} "
          f"stdout={out.getvalue().strip()!r}")
    if code != 0 or "Normal termination" not in out.getvalue() \
            or not (bitwise and same_settings) or texts != {"STAGE"}:
        raise AssertionError(f"{label}: the deck differs from its in-memory "
                             "run")
    return load_s


def chf_tree(n_levels):
    """The reach network: reach 0 the outlet, reaches 2r+1 and 2r+2 the
    tributaries of reach r; returns (level per reach, the connected
    pairs (a < b): each reach with its tributaries, and the two
    tributaries of a junction with each other, as DISV1D6's shared end
    vertices connect them)."""
    n = 2 ** n_levels - 1
    level = np.floor(np.log2(np.arange(n) + 1.0)).astype(np.int64)
    parent = np.arange(1, n)
    up = (parent - 1) // 2
    pairs = [np.stack([up, parent], 1)]
    first = np.arange(1, n, 2)
    pairs.append(np.stack([first, first + 1], 1))
    return level, np.unique(np.concatenate(pairs), axis=0)


def chf_geometry(n_levels):
    """(level, pairs, width, bed, starting stage) of the network: the
    discharge doubles at each junction downstream and the width grows as
    its square root (2 m at the headwaters), the beds 1 m a level higher
    upstream (a slope of 1e-2: on a gentler one the depth's growth
    downstream outruns the bed's fall and reverses the stage's slope) above
    the aquifer's top (50 m), the start at each reach's normal depth for
    its rectangular section."""
    level, pairs = chf_tree(n_levels)
    up = n_levels - 1 - level
    width = 2.0 * 2.0 ** (up / 2.0)
    # the first tributary of each junction 5 cm above the second: two
    # reaches that meet at one vertex connect (DISV1D), and equal stages
    # across such a connection make its conductance singular (dh/ds → 0)
    bot = 50.5 + CHF_SLOPE * CHF_LENGTH * level \
        + 0.05 * (np.arange(level.size) % 2)
    q = CHF_FLW * 2.0 ** up / 86400.0
    depth = (q * CHF_N / (width * np.sqrt(CHF_SLOPE))) ** 0.6
    return level, pairs, width, bot, bot + depth


def chf_network(device, n_levels=CHF_DEPTH):
    """(s3)/(s4)'s channel network (``chf_geometry``): the trapezoid section
    on every sixteenth reach, FLW on the headwaters, a ZDG outlet; in
    days."""
    from modflow6_torch.models.swf.model import Disv1dGrid, build_chf
    level, pairs, width, bot, strt = chf_geometry(n_levels)
    n = level.size
    grid = Disv1dGrid(n, np.full(n, CHF_LENGTH), width, bot, pairs)
    heads = np.flatnonzero(level == n_levels - 1)
    return build_chf(
        "chf", grid, manningsn=CHF_N, strt=strt, unitconv=CHF_UNITCONV,
        icentral=0, flw=[(int(r), CHF_FLW) for r in heads],
        zdg=[(0, float(width[0]), CHF_SLOPE, CHF_N)],
        cxs_sections=[CHF_SECTION],
        idcxs=(np.arange(n) % 16 == 0).astype(np.int64), device=device)


def chf_links(n_levels, shape):
    """The aquifer's top cell under each reach's midpoint: each level in a
    band of rows down the domain, its reaches in as many lines across the
    band as a line of cells cannot hold them, so no two reaches share a
    cell."""
    _, nrow, ncol = shape
    level, _ = chf_tree(n_levels)
    i = np.arange(level.size) + 1 - 2 ** level
    across = np.minimum(2 ** level, ncol)
    lines = 2 ** level // across
    x = (i % across + 0.5) / across * ncol * 10.0
    y = (level + (i // across + 0.5) / lines) / n_levels * nrow * 10.0
    row = np.minimum((y // 10.0).astype(np.int64), nrow - 1)
    col = np.minimum((x // 10.0).astype(np.int64), ncol - 1)
    return row * ncol + col


def run_chf_coupled(device, shape, n_levels=CHF_DEPTH):
    """(s3): the network over the bench aquifer through ``CoupledSwfGwf``,
    two steps of a day; the water balance of the channels (FLW in, ZDG
    out, leakage to the aquifer, storage) at every step.  Returns the
    stencil7 launches."""
    from modflow6_torch.models.swf.exchange import (CoupledSwfGwf,
                                                    SwfGwfExchange)
    chf = chf_network(device, n_levels)
    gwf = flagship(*shape, device)
    links = chf_links(n_levels, shape)
    cpl = CoupledSwfGwf(chf, gwf, SwfGwfExchange(
        np.arange(chf.nodes), links, np.full(chf.nodes, CHF_COND)),
        gwf_settings=ImsSettings(**BENCH),
        dvclose=CLOSURE_FACTOR * BENCH["outer_dvclose"])
    solve = cpl.gwf_sol.solve_timestep
    gwf_counts = []

    def counted(*args, **kwargs):
        out = solve(*args, **kwargs)
        gwf_counts.append((out[1].outer_iterations, out[1].inner_iterations))
        return out

    cpl.gwf_sol.solve_timestep = counted
    stage, head = chf.strt, gwf.strt
    worst, passes, t_all = 0.0, [], 0.0
    q_in = CHF_FLW * float(chf.flw[1].numel())
    with counted_run() as counts:
        for k, (_, nstp, _) in enumerate(CHF_PERIODS):
            for kstp in range(1, nstp + 1):
                delt = CHF_PERIODS[0][0] / nstp
                t0 = time.perf_counter()
                new, head, info = cpl.step(stage, head, delt, kstp=kstp)
                sync(device)
                t_all += time.perf_counter() - t0
                q_out = -float(chf._zdg_q(new).sum())
                q_leak = float(info["q"].sum())
                dv = float((swf_volume(chf, new)
                            - swf_volume(chf, stage)).sum()) / delt
                worst = max(worst, abs(q_in - q_out - q_leak - dv) / q_in)
                passes.append(info["exg_iters"])
                print(f"swf (s3) step {kstp}: converged={info['converged']}"
                      f" picard_passes={info['exg_iters']} "
                      f"swf_counts={[c[:2] for c in info['counts']]} "
                      f"dmax={info['dmax']} "
                      f"q_in={q_in!r} q_out={q_out!r} q_leak={q_leak!r} "
                      f"dV/dt={dv!r}")
                if not info["converged"]:
                    raise AssertionError("swf (s3): a step did not converge")
                stage = new
    print(f"swf (s3) coupled: reaches={chf.nodes} aquifer={gwf.nodes} "
          f"links={links.size} distinct aquifer cells="
          f"{np.unique(links).size} run_s={t_all!r} passes={passes} "
          f"gwf_counts={gwf_counts} largest |in - out - leak - dV/dt|/in="
          f"{worst!r} stencil7_launches={counts['launches']} "
          f"peak_bytes={peak_bytes(device)}")
    if not worst <= 1e-4:
        raise AssertionError(f"swf (s3): the channels' balance misses by "
                             f"{worst}")
    if not counts["launches"] or counts["plain_on_cuda"]:
        raise AssertionError("swf (s3): the aquifer's solves launched no "
                             "stencil7 kernel")
    return counts["launches"]


def write_chf_deck(ws, n_levels=CHF_DEPTH):
    """(s4): the network alone as a CHF6 deck: DISV1D6 with a two-vertex
    polyline of 100 m per reach from its upstream vertex to its outlet's
    (the outlet's to vertex 1), DFW6 with TIME_CONVERSION and IDCXS, CXS6,
    FLW6 on the headwaters, ZDG6 at the outlet, STO6 and OC6."""
    level, _, width, bot, strt = chf_geometry(n_levels)
    n = level.size
    xy = np.zeros((n + 1, 2))
    xy[1] = (0.0, 100.0)
    for r in range(1, n):
        xy[r + 1] = xy[(r - 1) // 2 + 1] + ((60.0, 80.0) if r % 2
                                            else (-60.0, 80.0))
    verts = "".join(f"  {i + 1} {x!r} {y!r}\n"
                    for i, (x, y) in enumerate(xy.tolist()))
    cells = "".join(f"  {r + 1} 0.5 2 {r + 2} "
                    f"{1 if r == 0 else (r - 1) // 2 + 2}\n"
                    for r in range(n))
    _write(ws, "mfsim.nam", "BEGIN TIMING\n  TDIS6 sim.tdis\nEND TIMING\n"
           "BEGIN MODELS\n  CHF6 chf.nam CHF\nEND MODELS\n"
           "BEGIN SOLUTIONGROUP 1\n  IMS6 sim.ims CHF\nEND SOLUTIONGROUP\n")
    p = CHF_PERIODS[0]
    _write(ws, "sim.tdis", "BEGIN DIMENSIONS\n  NPER 1\nEND DIMENSIONS\n"
           f"BEGIN PERIODDATA\n  {p[0]!r} {p[1]} {p[2]!r}\nEND PERIODDATA\n")
    _write(ws, "sim.ims", SWF_IMS)
    _write(ws, "chf.nam", "BEGIN PACKAGES\n" + "".join(
        f"  {t}6 chf.{t.lower()}\n" for t in (
            "DISV1D", "DFW", "CXS", "IC", "STO", "FLW", "ZDG", "OC"))
        + "END PACKAGES\n")

    def arr(v):
        return "    INTERNAL\n      " + " ".join(repr(float(x)) for x in v)

    _write(ws, "chf.disv1d", f"BEGIN DIMENSIONS\n  NODES {n}\n  NVERT "
           f"{n + 1}\nEND DIMENSIONS\nBEGIN GRIDDATA\n  WIDTH\n{arr(width)}"
           f"\n  BOTTOM\n{arr(bot)}\nEND GRIDDATA\nBEGIN VERTICES\n{verts}"
           f"END VERTICES\nBEGIN CELL1D\n{cells}END CELL1D\n")
    idcxs = " ".join("1" if r % 16 == 0 else "0" for r in range(n))
    _write(ws, "chf.dfw", f"BEGIN OPTIONS\n  TIME_CONVERSION {CHF_TCONV!r}\n"
           f"END OPTIONS\nBEGIN GRIDDATA\n  MANNINGSN\n    CONSTANT "
           f"{CHF_N!r}\n  IDCXS\n    INTERNAL\n      {idcxs}\nEND GRIDDATA\n")
    st, ht, rf = CHF_SECTION
    rows = "".join(f"  {a!r} {b!r} {c!r}\n"
                   for a, b, c in zip(st, ht, list(rf) + [rf[-1]]))
    _write(ws, "chf.cxs", f"BEGIN DIMENSIONS\n  NSECTIONS 1\n  NPOINTS "
           f"{len(st)}\nEND DIMENSIONS\nBEGIN PACKAGEDATA\n  1 {len(st)}\n"
           f"END PACKAGEDATA\nBEGIN CROSSSECTIONDATA\n{rows}"
           "END CROSSSECTIONDATA\n")
    _write(ws, "chf.ic", f"BEGIN GRIDDATA\n  STRT\n{arr(strt)}\n"
           "END GRIDDATA\n")
    _write(ws, "chf.sto", "BEGIN PERIOD 1\n  TRANSIENT\nEND PERIOD\n")
    heads = np.flatnonzero(level == n_levels - 1)
    _write(ws, "chf.flw", f"BEGIN DIMENSIONS\n  MAXBOUND {heads.size}\n"
           "END DIMENSIONS\nBEGIN PERIOD 1\n" + "".join(
               f"  {r + 1} {CHF_FLW!r}\n" for r in heads.tolist())
           + "END PERIOD\n")
    _write(ws, "chf.zdg", "BEGIN DIMENSIONS\n  MAXBOUND 1\nEND DIMENSIONS\n"
           f"BEGIN PERIOD 1\n  1 0 {float(width[0])!r} {CHF_SLOPE!r} "
           f"{CHF_N!r}\n"
           "END PERIOD\n")
    _write(ws, "chf.oc", "BEGIN OPTIONS\n  STAGE FILEOUT chf.stage\n"
           "END OPTIONS\nBEGIN PERIOD 1\n  SAVE STAGE ALL\nEND PERIOD\n")


def run_swf(device, shape=BENCH_SHAPE, n_levels=CHF_DEPTH):
    """The swf phase: (s1) the overland raster; (s2) its OLF6 deck through
    the command-line entry, STAGE bitwise with (s1)'s (the repeat of
    (s1)); (s3) the
    channel network over the bench aquifer; (s4) the network alone in
    memory and as a CHF6 deck through the command-line entry, STAGE
    bitwise.  Returns the stencil7 launches (the aquifer's solves)."""
    from modflow6_torch.models.swf.simulation import SwfSimulation
    _, nrow, ncol = shape
    t_phase = time.perf_counter()
    reset_peak(device)
    # the deck's run (s2), bitwise equal to (s1), is (s1)'s repeat
    recs, _ = run_olf(device, nrow, ncol, "swf (s1) olf")
    with tempfile.TemporaryDirectory() as ws:
        t0 = time.perf_counter()
        write_olf_deck(ws, nrow, ncol)
        print(f"swf (s2) olf deck written in {time.perf_counter() - t0!r} s")
        run_swf_deck_cli("swf (s2) olf", device, ws, recs, "olf.stage")
    del recs
    launches = run_chf_coupled(device, shape, n_levels)
    chf = chf_network(device, n_levels)
    sim = SwfSimulation(Tdis(tuple(StressPeriod(*p) for p in CHF_PERIODS)),
                        chf, has_sto=True, sto_periods={1: True})
    t0 = time.perf_counter()
    recs = sim.run()
    sync(device)
    print(f"swf (s4) network alone in memory: reaches={chf.nodes} "
          f"cxs_reaches={int(chf.has_xs.sum())} run_s="
          f"{time.perf_counter() - t0!r} outers={[r.outer for r in recs]} "
          f"inners={[r.inner for r in recs]} "
          f"converged={all(r.converged for r in recs)}")
    if not all(r.converged for r in recs):
        raise AssertionError("swf (s4): a step did not converge")
    with tempfile.TemporaryDirectory() as ws:
        write_chf_deck(ws, n_levels)
        run_swf_deck_cli("swf (s4) chf", device, ws, recs, "chf.stage")
    print(f"swf phase: {time.perf_counter() - t_phase!r} s, stencil7 "
          f"launches={launches}")
    return launches


def file_digest(path):
    """SHA-256 of a file (the track files run to hundreds of megabytes)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def file_prefix_equal(longer, shorter):
    """Whether the file ``shorter`` is the first bytes of ``longer``."""
    size = os.path.getsize(shorter)
    with open(longer, "rb") as a, open(shorter, "rb") as b:
        while size:
            n = min(size, 1 << 24)
            if a.read(n) != b.read(n):
                return False
            size -= n
    return True


def prt_points(grid, every):
    """Release points at the centres of every ``every``-th cell of the top
    layer, halfway up the layer."""
    if hasattr(grid, "ncpl"):
        cells = np.arange(0, grid.ncpl, every)
        x, y = grid.xc[cells], grid.yc[cells]
        z = 0.5 * (grid.top_surf[cells] + grid.botm[0, cells])
    else:
        cells = np.arange(0, grid.nrow * grid.ncol, every)
        i, j = np.divmod(cells, grid.ncol)
        x = (j + 0.5) * grid.delr[0]
        y = (grid.nrow - i - 0.5) * grid.delc[0]
        z = 0.5 * (grid.top_surf.reshape(-1)[cells]
                   + grid.botm[0].reshape(-1)[cells])
    return np.asarray(x, float), np.asarray(y, float), np.asarray(z, float)


def run_prt_memory(device, model, points, track_path, label,
                   periods=PRT_PERIODS):
    """``model`` over ``periods`` through ``Simulation`` with a PrtDriver
    (releases at PRT_TIMES, a TRACK file).  Returns (records, driver,
    seconds, launches)."""
    from modflow6_torch.models.prt.model import PrtModel, ReleasePoints
    from modflow6_torch.models.prt.simulation import PrtDriver
    from modflow6_torch.models.prt.trackfile import ReleaseSchedule
    drv = PrtDriver(PrtModel("prt", model.grid, torch.full(
        (model.nodes,), PRT_POROSITY, dtype=torch.float64, device=device),
        ReleasePoints(*points)), model, ReleaseSchedule(times=PRT_TIMES),
        track_path=track_path)
    sim = Simulation(Tdis(tuple(StressPeriod(*p) for p in periods)),
                     model, ImsSettings(**BENCH))
    sim.prt_drivers.append(drv)
    track_s = []
    on_step = drv.on_step

    def timed(*args):
        sync(device)
        t = time.perf_counter()
        on_step(*args)
        sync(device)
        track_s.append(time.perf_counter() - t)

    drv.on_step = timed
    with counted_run() as counts:
        t0 = time.perf_counter()
        recs = sim.run()
        sim.finish()
        sync(device)
        seconds = time.perf_counter() - t0
    status = np.bincount(drv.status, minlength=6).tolist()
    print(f"{label}: cells={model.nodes} particles={drv.status.size} "
          f"flow inners={[r.inner for r in recs]} "
          f"converged={all(r.converged for r in recs)} run_s={seconds!r} "
          f"tracking_s={track_s} statuses(active, boundary, weak, timeout, "
          f"stoptime, stopzone)={status} largest transitions in a step="
          f"{int(drv.transitions.max())} stencil7_launches="
          f"{counts['launches']} peak_bytes={peak_bytes(device)}")
    if not all(r.converged for r in recs) or counts["plain_on_cuda"]:
        raise AssertionError(f"{label}: a flow step did not converge")
    return recs, drv, seconds, counts["launches"]


def check_particles(label, drv, grid, totim):
    """Every particle inside its cell's bounds (x, y in the cell's box, z
    between its bottom and top); travel times within the time since the
    release."""
    x, y, z = (v.cpu().numpy() for v in (drv.x, drv.y, drv.z))
    lay, row, col = (v.cpu().numpy() for v in (drv.lay, drv.row, drv.col))
    tol = 1e-9
    if hasattr(grid, "ncpl"):
        cell = row
        ring = grid.javert[grid.iavert[cell][:, None] + np.arange(
            int(np.diff(grid.iavert).max()))]
        vx, vy = grid.vertices[ring, 0], grid.vertices[ring, 1]
        inside = ((x >= vx.min(1) - tol) & (x <= vx.max(1) + tol)
                  & (y >= vy.min(1) - tol) & (y <= vy.max(1) + tol))
        top = np.concatenate([grid.top_surf[None], grid.botm[:-1]])[lay, cell]
        bot = grid.botm[lay, cell]
    else:
        xe = np.concatenate([[0.0], np.cumsum(grid.delr)])
        ye = grid.delc.sum() - np.concatenate([[0.0], np.cumsum(grid.delc)])
        inside = ((x >= xe[col] - tol) & (x <= xe[col + 1] + tol)
                  & (y >= ye[row + 1] - tol) & (y <= ye[row] + tol))
        node = (lay * grid.nrow + row) * grid.ncol + col
        top, bot = grid.top[node], grid.bot[node]
    inside &= (z >= bot - tol) & (z <= top + tol)
    rel = drv.released
    late = drv.ttrack > totim - drv.trelease + 1e-9
    print(f"{label}: particles inside their cells={int(inside.sum())} of "
          f"{inside.size}; released={int(rel.sum())}; travel times beyond "
          f"the time since release={int((late & rel).sum())}; largest "
          f"travel time={float(drv.ttrack.max())!r}")
    if not inside.all() or (late & rel).any() or not rel.all():
        raise AssertionError(f"{label}: a particle outside its cell, or a "
                             "travel time beyond its time")


def same_drivers(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("x", "y", "z", "lay", "row", "col")) and all(
        np.array_equal(getattr(a, k), getattr(b, k))
        for k in ("status", "ttrack", "transitions"))


def write_prt_deck(ws, shape, points):
    """(p2): the bench model as a deck (``write_flagship_deck`` with its
    recharge as an RCH6 list, as ``flagship`` holds it) with a PRT6 model:
    DIS6, MIP6, a PRP6 with a PACKAGEDATA row per release point and
    RELEASETIMES, TRACK FILEOUT; a GWF6-PRT6 exchange."""
    nlay, nrow, ncol = shape
    write_flagship_deck(ws, nlay, nrow, ncol, rcha=None,
                        tdis=list(PRT_PERIODS), oc_last=False,
                        extra_packages=["RCH6 m.rch"])
    ii, jj = np.divmod(np.arange(nrow * ncol), ncol)
    with open(os.path.join(ws, "rch.txt"), "w") as f:
        f.write("".join(f"1 {i + 1} {j + 1} 0.0001\n"
                        for i, j in zip(ii.tolist(), jj.tolist())))
    _write(ws, "m.rch", f"BEGIN DIMENSIONS\n  MAXBOUND {nrow * ncol}\n"
           "END DIMENSIONS\nBEGIN PERIOD 1\n  OPEN/CLOSE rch.txt\n"
           "END PERIOD\n")
    _write(ws, "mfsim.nam", "BEGIN TIMING\n  TDIS6 sim.tdis\nEND TIMING\n"
           "BEGIN MODELS\n  GWF6 m.nam FLAGSHIP\n  PRT6 prt.nam PRT\n"
           "END MODELS\nBEGIN EXCHANGES\n  GWF6-PRT6 fp.exg FLAGSHIP PRT\n"
           "END EXCHANGES\nBEGIN SOLUTIONGROUP 1\n  IMS6 sim.ims FLAGSHIP\n"
           "END SOLUTIONGROUP\n")
    shutil.copy(os.path.join(ws, "m.dis"), os.path.join(ws, "prt.dis"))
    _write(ws, "prt.nam", "BEGIN PACKAGES\n  DIS6 prt.dis\n  MIP6 prt.mip\n"
           "  PRP6 prt.prp\nEND PACKAGES\n")
    _write(ws, "prt.mip", f"BEGIN GRIDDATA\n  POROSITY\n    CONSTANT "
           f"{PRT_POROSITY!r}\nEND GRIDDATA\n")
    x, y, z = points
    col = (x // 10.0).astype(np.int64)
    row = nrow - 1 - (y // 10.0).astype(np.int64)
    # the rows inline: PRP6's PACKAGEDATA reads no OPEN/CLOSE
    rows = "".join(
        f"  {k + 1} 1 {r + 1} {c + 1} {a!r} {b!r} {d!r}\n"
        for k, (r, c, a, b, d) in enumerate(zip(
            row.tolist(), col.tolist(), x.tolist(), y.tolist(),
            z.tolist())))
    times = "".join(f"  {t!r}\n" for t in PRT_TIMES)
    _write(ws, "prt.prp", "BEGIN OPTIONS\n  TRACK FILEOUT prt.trk\n"
           f"END OPTIONS\nBEGIN DIMENSIONS\n  NRELEASEPTS {x.size}\n"
           f"  NRELEASETIMES {len(PRT_TIMES)}\nEND DIMENSIONS\n"
           f"BEGIN PACKAGEDATA\n{rows}END PACKAGEDATA\n"
           f"BEGIN RELEASETIMES\n{times}END RELEASETIMES\n")


def run_prt(device, shape=BENCH_SHAPE):
    """The prt phase: (p1) a particle swarm on the bench model, and its
    first step again, bitwise; (p2) its GWF6 + PRT6 deck through the
    command-line entry, the track file bitwise; (p3) the ternary method on
    the brick DISV grid, and its first step again, bitwise.  Returns the
    stencil7 launches."""
    nlay, nrow, ncol = shape
    t_phase = time.perf_counter()
    launches = 0
    with tempfile.TemporaryDirectory() as root:
        grid = flagship_grid(*shape)
        points = prt_points(grid, 2)
        # the repeat runs the first step (the time budget): its heads and
        # its track records bitwise those of the first run's first step
        runs = []
        for i, periods in enumerate((PRT_PERIODS, PRT_PERIODS_FIRST)):
            reset_peak(device)
            model = flagship(*shape, device)
            path = os.path.join(root, f"p1_{i}.trk")
            recs, drv, _, n = run_prt_memory(
                device, model, points, path, f"prt (p1) bench run {i + 1}",
                periods)
            launches += n
            runs.append((recs, drv, path))
            del model
        (r0, d0, p0), (r1, _, p1) = runs
        same = (np.array_equal(r0[0].head, r1[0].head)
                and file_prefix_equal(p0, p1))
        t0_ = file_digest(p0)
        print(f"prt (p1) the first step twice bitwise equal={same} "
              f"track_bytes={os.path.getsize(p0)}")
        if not same or not n:
            raise AssertionError("prt (p1): the two runs differ, or no "
                                 "stencil7 launch")
        check_particles("prt (p1)", d0, grid, sum(p[0] for p in PRT_PERIODS))
        del runs, r1
        ws = os.path.join(root, "deck")
        os.makedirs(ws)
        t0 = time.perf_counter()
        write_prt_deck(ws, shape, points)
        write_s = time.perf_counter() - t0
        out = io.StringIO()
        with captured_loads(device) as loads, counted_run() as counts, \
                contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            code = cli_main([ws] + ([] if torch.device(device).type == "cuda"
                                    else ["--device", "cpu"]))
            sync(device)
            cli_s = time.perf_counter() - t0
        load_s = loads[0][1]
        del loads
        bitwise = file_digest(os.path.join(ws, "prt.trk")) == t0_
        print(f"prt (p2) deck written in {write_s!r} s, cli exit={code} "
              f"wall_s={cli_s!r} load_s={load_s!r} track_bitwise_equal_(p1)"
              f"={bitwise} stencil7_launches={counts['launches']} "
              f"stdout={out.getvalue().strip()!r}")
        if code != 0 or not bitwise or not counts["launches"]:
            raise AssertionError("prt (p2): the deck's track file differs "
                                 "from (p1)'s")
        launches += counts["launches"]
    # (p3) the ternary method on the one-layer brick grid of a million cells
    ncpl = nrow * ncol
    grid = brick_disv(1, nrow, ncol, 10.0, 50.0, np.zeros((1, ncpl)))
    args = brick_model_args(1, nrow, ncol,
                            evt_rows=range(nrow // 4,
                                           min(nrow, nrow // 4 + 64)))
    points = prt_points(grid, 4)
    # the repeat runs the first step (the time budget): its heads and its
    # track records bitwise those of the first run's first step
    runs = []
    with tempfile.TemporaryDirectory() as root:
        for i, periods in enumerate((PRT_PERIODS, PRT_PERIODS_FIRST)):
            reset_peak(device)
            model = build_gwf("brick", grid, device=device, **args)
            path = os.path.join(root, f"p3_{i}.trk")
            recs, drv, _, n = run_prt_memory(
                device, model, points, path, f"prt (p3) brick run {i + 1}",
                periods)
            runs.append((recs, drv, path, n))
            del model
        (r0, d0, p0, n0), (r1, d1, p1, n1) = runs
        same = (np.array_equal(r0[0].head, r1[0].head)
                and file_prefix_equal(p0, p1))
    print(f"prt (p3) the first step twice bitwise equal={same} "
          f"stencil7_launches={n0 + n1}")
    if not same or n0 + n1:
        raise AssertionError("prt (p3): the two runs differ, or a stencil7 "
                             "launch on the gather path")
    check_particles("prt (p3)", d0, grid, sum(p[0] for p in PRT_PERIODS))
    print(f"prt phase: {time.perf_counter() - t_phase!r} s, stencil7 "
          f"launches={launches}")
    return launches


def small_swf_prt_models(dev):
    """[(name, run)] of the small SWF and PRT twins on ``dev``: run() →
    (values, counts, converged, closure)."""
    from modflow6_torch.models.discretization.disv2d import Disv2dGrid
    from modflow6_torch.models.swf.exchange import (CoupledSwfGwf,
                                                    SwfGwfExchange)
    from modflow6_torch.models.swf.model import (Disv1dGrid, build_chf,
                                                 build_olf)
    from modflow6_torch.models.swf.simulation import default_settings
    s = default_settings()

    def march(model, steps, delt):
        sol = NumericalSolution(model, s)
        stage, counts, ok = model.strt, [], True
        for k in range(steps):
            stage, info, _ = sol.solve_timestep(stage, delt, kstp=k + 1)
            counts.append(info.outer_iterations)
            ok &= info.converged
        return stage.cpu(), counts, ok, s.outer_dvclose

    def chf_cxs():
        n = 12
        bot = np.arange(n)[::-1] * 0.1
        return march(build_chf(
            "c", Disv1dGrid.chain(np.full(n, 100.0), 4.0, bot),
            manningsn=0.03, strt=bot + 1.4, icentral=0, flw=[(0, 1.5)],
            zdg=[(n - 1, 4.0, 1e-3, 0.03)], cxs_sections=[CHF_SECTION],
            idcxs=np.ones(n, np.int64), device=dev), 3, 300.0)

    def olf(kind):
        nr, nc, d = 4, 6, 10.0
        land = np.tile(np.arange(nc)[::-1] * 0.01 * d, (nr, 1))
        if kind == "dis2d":
            grid = DisGrid.create(1, nr, nc, d, d, float(land.max()) + 1.0,
                                  land[None])
        else:
            g = quad_disv(1, nr, nc, d, 1.0, np.zeros((1, nr * nc)))
            grid = Disv2dGrid.from_arrays(g.vertices, g.xc, g.yc, g.iavert,
                                          g.javert, land.reshape(-1))
        return march(build_olf(
            "o", grid, manningsn=0.05, strt=land.reshape(-1) + 0.05,
            pcp=[(i, 1e-4) for i in range(nr * nc)],
            flw=[(i * nc, 0.05) for i in range(nr)],
            chd=[(i * nc + nc - 1, land[0, -1] + 0.05) for i in range(nr)],
            device=dev), 1, 100.0)

    def exchange():
        n = 10
        bot = np.arange(n)[::-1] * 0.1 + 5.0
        chf = build_chf("c", Disv1dGrid.chain(np.full(n, 100.0), 5.0, bot),
                        manningsn=0.03, strt=bot + 0.3, flw=[(0, 2.0)],
                        zdg=[(n - 1, 5.0, 1e-3, 0.03)], device=dev)
        gwf = build_gwf("a", DisGrid.create(1, 3, n, 100.0, 100.0, 5.0,
                                            -20.0 * np.ones((1, 3, n))),
                        k=5.0, strt=0.0, device=dev,
                        chd=[(i * n, 0.0) for i in range(3)]
                        + [(i * n + n - 1, 0.0) for i in range(3)])
        cpl = CoupledSwfGwf(chf, gwf, SwfGwfExchange(
            np.arange(n), n + np.arange(n), np.full(n, 0.02)))
        stage, head, counts, ok = chf.strt, gwf.strt, [], True
        for k in range(2):
            stage, head, info = cpl.step(stage, head, 500.0, kstp=k + 1,
                                         iss_gwf=True)
            counts.append(info["exg_iters"])
            ok &= info["converged"]
        return torch.cat([stage, head]).cpu(), counts, ok, 1e-7

    def prt(kind):
        from modflow6_torch.models.prt import tracking_disv
        from modflow6_torch.models.prt.model import PrtModel, ReleasePoints
        nrow, ncol = 9, 11
        if kind == "dis":
            grid = flagship_grid(2, nrow, ncol)
        else:
            grid = brick_disv(2, nrow, ncol, 10.0, 50.0,
                              flagship_botm(2, nrow * ncol))
        model = build_gwf("p", grid, device=dev,
                          **flagship_args(2, nrow, ncol))
        head, info, aux = NumericalSolution(model, ImsSettings(**TIGHT)) \
            .solve_timestep(model.strt, 5.0)
        pts = prt_points(grid, 1)
        if kind == "dis":
            prt_m = PrtModel("p", grid, torch.full((grid.nodes,), 0.3,
                                                   dtype=torch.float64,
                                                   device=dev),
                             ReleasePoints(*pts))
            out = prt_m.make_step(model)(head, aux["ibound"], aux["cond"],
                                         *prt_m.initial_state(dev), 200.0)
        else:
            fan = tracking_disv.build_fan(grid, model.topo,
                                          np.full(grid.nodes, 0.3),
                                          device=dev)
            flux = tracking_disv.fan_fluxes(
                fan, model.edge_flows(head, aux["ibound"], aux["cond"]))
            from modflow6_torch.models.gwf import npf
            sat = npf.compute_saturation(model.npf_opts, model.npf_arrays,
                                         head, aux["ibound"]).reshape(2, -1)
            lay, cell, tri = tracking_disv.locate(fan, *pts)

            def t(a, dtype=torch.float64):
                return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

            out = tracking_disv.make_tracker_disv(fan)(
                t(pts[0]), t(pts[1]), t(pts[2]), t(lay, torch.int64),
                t(cell, torch.int64), t(tri, torch.int64), *flux, sat, 200.0)
        vals = torch.cat([out["x"], out["y"], out["z"], out["time"]]).cpu()
        return vals, out["status"].cpu().tolist(), info.converged, 1e-9

    return [("chf cxs", chf_cxs), ("olf dis2d", lambda: olf("dis2d")),
            ("olf disv2d", lambda: olf("disv2d")), ("swf-gwf", exchange),
            ("prt dis", lambda: prt("dis")), ("prt disv", lambda: prt("disv"))]


def check_small_swf_prt(device, names=None):
    """Small SWF and PRT twins on the card against the CPU: SWF stages
    within 10 × outer_dvclose, with equal outer counts (Picard passes)
    where the inner solves close before their cap (the CHF and exchange
    twins; the OLF twins' BiCGSTAB solves run to their 500-iteration cap,
    so their counts follow the last bits of the sums and the powers, as
    the Newton twins' do); PRT equal statuses, positions and times within
    1e-9 relative."""
    cpu = dict(small_swf_prt_models("cpu"))
    for name, run in small_swf_prt_models(device):
        if names is not None and name not in names:
            continue
        v, k, ok, bar = run()
        v0, k0, ok0, _ = cpu[name]()
        if name.startswith("prt"):
            err = float(((v - v0).abs() / v0.abs().clamp(min=1.0)).max())
        else:
            err = float((v - v0).abs().max())
            bar = CLOSURE_FACTOR * bar
        same = k == k0 or name.startswith("olf")
        print(f"small swf/prt {name}: card counts or statuses={k} "
              f"converged={ok}; cpu={k0} converged={ok0}; max diff={err!r} "
              f"bar={bar!r}")
        if not (ok and ok0 and same and err <= bar):
            raise AssertionError(f"small swf/prt {name}: the card disagrees "
                                 "with the CPU")


# ------------------------------------------------ the parallel and api phases

SHARDS = 4
# a sharded run against the single-device run of the same model and
# settings: the reference tests' bars (tests/test_parallel.py:45-165,
# tests/test_parallel_augmented.py, tests/test_parallel_transport.py),
# which hold at their tight closures and where the two marches take the
# same iterations, as (q1)'s f64 runs do.  Where the reductions' order
# moves a march by a few iterations ((q2)-(q4) at the bench closures), two
# solves closed at outer_dvclose agree to CLOSURE_FACTOR x outer_dvclose,
# the bar of this script's other pairs of solves; the lines print both.
# (q1) in mixed precision: the single-device run sums its float32 passes
# in the fused Jacobi-CG kernels' order, the shards in the plain loop's,
# and where that moves a step's count the two runs are held to
# outer_dvclose itself (the plain loop against the shards read 5.8e-7 at
# equal counts, the fused kernels 4.3e-6 at [1529, 1578, 1175] against
# [1529, 1513, 1208] inner iterations: 0.43 of it).
SHARDED_ATOL = {"f64": 1e-7, "mixed": 1e-6, "augmented": 5e-7,
                "transport": 1e-7}


def column_owner(nodes, ncpl, shards=None):
    """Column-aligned blocks of a layered grid: every layer of a block of
    ``ncpl // shards`` cells on one shard (contiguous node blocks would be
    whole layers, each shard's halo the layers above and below)."""
    shards = shards or SHARDS
    return np.tile(np.repeat(np.arange(shards), -(-ncpl // shards))[:ncpl],
                   nodes // ncpl)


def closure_check(label, err, ref_bar, settings):
    """The bar of a sharded run that may take other iterations than its
    single-device oracle: printed beside the reference test's bar."""
    bar = CLOSURE_FACTOR * settings["outer_dvclose"]
    print(f"{label}: max|d|={err!r} closure bar={bar!r} reference test "
          f"bar={ref_bar!r} met={err <= ref_bar}")
    if not (np.isfinite(err) and err <= bar):
        raise AssertionError(f"{label}: off the single-device run's")
# the API's heads against the deck's run (tests/test_api.py:43-44)
API_RTOL = 1e-12


def shard_b1_bitwise(ssol, delt):
    """Shard 0's first system of ``ssol`` through the kernel and through
    the plain version on the same tensors: (bitwise equal, max |dy|)."""
    lm = ssol.models[0]
    ib, h = lm.boundary_state(lm.strt)
    diag, off, rhs = lm.assemble(h, h, ib, delt, False)
    diag, off, _ = fix_system(lm, torch.sign(ib), diag, off, rhs, h,
                              symmetric=True, own=ssol.own.parts[0])
    x = h + torch.linspace(-1.0, 1.0, h.numel(), dtype=torch.float64,
                           device=h.device)
    y = make_matvec(lm.system_topo, diag, off)(x)
    y_plain = stencil.spmv_structured(lm.dtopo.grid_shape, diag, off, x)
    return bool(torch.equal(y, y_plain)), float((y - y_plain).abs().max())


def sharded_steps(label, solve, nsteps, device):
    """``solve(kstp)`` for kstp = 1..nsteps with the kernel's launches
    counted; returns (infos, seconds, counts, peak bytes)."""
    reset_peak(device)
    infos = []
    with counted_run() as counts:
        t0 = time.perf_counter()
        for kstp in range(1, nsteps + 1):
            infos.append(solve(kstp))
        sync(device)
        seconds = time.perf_counter() - t0
    if not all(i["converged"] for i in infos):
        raise AssertionError(f"{label}: a step did not converge: {infos}")
    if counts["plain_on_cuda"]:
        raise AssertionError(f"{label}: the plain stencil ran on the card")
    return infos, seconds, counts, peak_bytes(device)


def run_parallel_rows(device, precision, oracle):
    """(q1) the bench configuration (3 steps of 5.0, CG, Jacobi) as
    ``SHARDS`` row shards through ``ShardedSolution``, held against
    ``oracle`` = (heads, inner iterations by step), the bench phase's
    single-device run of ``precision``: to ``SHARDED_ATOL`` where the
    steps' counts are equal, else to outer_dvclose (above
    ``SHARDED_ATOL``); each product one stencil7 launch per shard, and
    shard 0's product bitwise equal to the plain one.  Returns the
    launches."""
    label = f"parallel (q1) rows {precision}"
    model = flagship(*BENCH_SHAPE, device)
    t0 = time.perf_counter()
    part = partition_model(model, SHARDS)
    t1 = time.perf_counter()
    ssol = ShardedSolution(part, ImsSettings(**BENCH, precision=precision),
                           devices=[device] * SHARDS)
    sync(device)
    t2 = time.perf_counter()
    state = {"h": ssol.scatter_heads(model.strt)}

    def solve(kstp):
        state["h"], info = ssol.solve_timestep(state["h"], 5.0, kstp=kstp,
                                               iss=False)
        return info

    infos, seconds, counts, peak = sharded_steps(label, solve, 3, device)
    head = ssol.gather_heads(state["h"])
    oracle, oracle_inners = oracle
    err = float(np.abs(head - oracle.cpu().numpy()).max())
    inners = [i["inner"] for i in infos]
    inner = sum(inners)
    launches = counts["launches"]
    same, b1_err = shard_b1_bitwise(ssol, 5.0)
    bar = (SHARDED_ATOL[precision] if inners == list(oracle_inners)
           else BENCH["outer_dvclose"])
    print(f"{label}: shards={SHARDS} local_grid={part.local_row_shape()} "
          f"outers={[i['outer'] for i in infos]} "
          f"inners={inners} single-device inners={list(oracle_inners)} "
          f"partition_s={t1 - t0!r} "
          f"setup_s={t2 - t1!r} run_s={seconds!r} "
          f"ms_per_inner={seconds / inner * 1e3!r} "
          f"max|dh| vs single-device={err!r} bar={bar!r} reference test "
          f"bar={SHARDED_ATOL[precision]!r} "
          f"stencil7_launches={launches} (at least {SHARDS} x {inner}) "
          f"shard0 b1 vs plain bitwise={same} max|dy|={b1_err!r} "
          f"peak_bytes={peak}")
    if not (np.isfinite(head).all() and err <= bar):
        raise AssertionError(f"{label}: heads off the single-device run's")
    if launches % SHARDS or launches < SHARDS * inner or not same:
        raise AssertionError(f"{label}: not one kernel launch per shard "
                             "and product, or the kernel differs from the "
                             "plain product")
    return launches


def run_parallel_general(device, model, oracle):
    """(q2) the unstructured phase's brick DISV model as ``SHARDS``
    column-aligned blocks through ``partition_general`` (3 steps of 5.0,
    CG), held
    against that phase's heads; the host partition's seconds.  No stencil
    launch: a shard of a DISV grid multiplies through the gather."""
    label = "parallel (q2) brick disv general"
    t0 = time.perf_counter()
    part = partition_general(model, SHARDS, owner=column_owner(
        model.nodes, model.grid.ncpl))
    t1 = time.perf_counter()
    gsol = GeneralShardedSolution(part, ImsSettings(**BENCH),
                                  devices=[device] * SHARDS)
    sync(device)
    t2 = time.perf_counter()
    state = {"h": gsol.scatter_heads(model.strt)}

    def solve(kstp):
        state["h"], info = gsol.solve_timestep(state["h"], 5.0, kstp=kstp,
                                               iss=False)
        return info

    infos, seconds, counts, peak = sharded_steps(label, solve, 3, device)
    head = gsol.gather_heads(state["h"])
    err = float(np.abs(head - oracle).max())
    halo = [int((~part.own[p]).sum()) for p in range(SHARDS)]
    print(f"{label}: cells={model.nodes} shards={SHARDS} "
          f"n_local={part.n_local} halo_and_pad_slots={halo} "
          f"host_partition_s={t1 - t0!r} setup_s={t2 - t1!r} "
          f"outers={[i['outer'] for i in infos]} "
          f"inners={[i['inner'] for i in infos]} run_s={seconds!r} "
          f"stencil7_launches={counts['launches']} peak_bytes={peak}")
    closure_check(f"{label} heads vs single-device", err,
                  SHARDED_ATOL["f64"], BENCH)
    if counts["launches"]:
        raise AssertionError(f"{label}: a gather model launched stencil7")


def run_parallel_augmented(device, oracle):
    """(q3) the advanced phase's model (1024 wells, 256 lakes, 4160
    reaches) as ``SHARDS`` shards, its first step (BiCGSTAB), held against
    that phase's first step."""
    label = "parallel (q3) augmented"
    model, _, build_s = advanced_model(device, BENCH_SHAPE)
    nlay, nrow, ncol = BENCH_SHAPE
    t0 = time.perf_counter()
    apart = partition_augmented(model, SHARDS, owner=column_owner(
        model.n_grid, nrow * ncol))
    t1 = time.perf_counter()
    asol = ShardedAugmentedSolution(apart, advanced_settings(),
                                    devices=[device] * SHARDS)
    sync(device)
    t2 = time.perf_counter()
    state = {"x": asol.scatter(model.strt)}

    def solve(kstp):
        state["x"], info = asol.solve_timestep(state["x"], 5.0, kstp=kstp,
                                               iss=False)
        return info

    infos, seconds, counts, peak = sharded_steps(label, solve, 1, device)
    x = asol.gather(state["x"])
    err = float(np.abs(x - oracle).max())
    owned = np.bincount(apart.owner_feat, minlength=SHARDS).tolist()
    print(f"{label}: rows={model.nodes} shards={SHARDS} "
          f"features_owned={owned} n_aug={apart.n_aug} "
          f"Ktot={asol.models[0].Ktot} build_s={build_s!r} "
          f"host_partition_s={t1 - t0!r} setup_s={t2 - t1!r} "
          f"outer={infos[0]['outer']} inner={infos[0]['inner']} "
          f"run_s={seconds!r} stencil7_launches={counts['launches']} "
          f"peak_bytes={peak}")
    closure_check(f"{label} values vs single-device", err,
                  SHARDED_ATOL["augmented"], BENCH)
    if counts["launches"]:
        raise AssertionError(f"{label}: an augmented model launched "
                             "stencil7")


def run_parallel_transport(device, plume):
    """(q4) the bench model with (t1)'s plume through
    ``GeneralCoupledSolution`` on ``SHARDS`` shards (halo depth 2: TVD and
    dispersion), its three 5-d steps, each step's heads and
    concentrations held against (t1)'s."""
    label = "parallel (q4) coupled transport"
    heads, concs = plume
    flow, gwt = plume_models(device, BENCH_SHAPE)
    nlay, nrow, ncol = BENCH_SHAPE
    t0 = time.perf_counter()
    part = partition_coupled(flow, gwt, SHARDS, owner=column_owner(
        flow.nodes, nrow * ncol))
    t1 = time.perf_counter()
    csol = GeneralCoupledSolution(
        part, gwt, ImsSettings(**PLUME_FLOW), ImsSettings(**PLUME_TRANSPORT),
        devices=[device] * SHARDS, ssm_spec={"RCH": PLUME_RCH_CONC})
    sync(device)
    t2 = time.perf_counter()
    state = {"h": csol.scatter(flow.strt), "c": csol.scatter(gwt.strt)}
    errs = []

    def solve(kstp):
        state["h"], state["c"], info = csol.solve_timestep(
            state["h"], state["c"], 5.0, kstp=kstp, iss=False)
        errs.append((float(np.abs(csol.gather(state["h"])
                                  - heads[kstp - 1]).max()),
                     float(np.abs(csol.gather(state["c"])
                                  - concs[kstp - 1]).max())))
        return info

    infos, seconds, counts, peak = sharded_steps(label, solve, 3, device)
    print(f"{label}: cells={flow.nodes} shards={SHARDS} "
          f"n_local={part.n_local} host_partition_s={t1 - t0!r} "
          f"setup_s={t2 - t1!r} outers={[i['outer'] for i in infos]} "
          f"inners={[i['inner'] for i in infos]} run_s={seconds!r} "
          f"max|dh|,max|dc| per step vs (t1)={errs} "
          f"stencil7_launches={counts['launches']} peak_bytes={peak}")
    closure_check(f"{label} heads vs (t1)", max(e for e, _ in errs),
                  SHARDED_ATOL["transport"], PLUME_FLOW)
    closure_check(f"{label} concentrations vs (t1)",
                  max(e for _, e in errs), SHARDED_ATOL["transport"],
                  PLUME_TRANSPORT)


def run_parallel(device, bench_heads, brick=None, advanced_first=None,
                 plume=None):
    """The parallel phase: (q1) the bench configuration as row shards in
    ``f64`` and ``mixed``, (q2) the brick DISV grid, (q3) the advanced
    model's first step, (q4) the plume; each held against the earlier
    phases' single-device runs (``bench_heads`` {precision: (heads, inner
    iterations by step)};
    ``brick`` (model, heads); ``advanced_first``; ``plume``), which it
    runs itself when those phases did not run.  Returns the stencil7
    launches of (q1)."""
    t0 = time.perf_counter()
    launches = sum(run_parallel_rows(device, precision, bench_heads[precision])
                   for precision in ("f64", "mixed"))
    if brick is None:
        with contextlib.redirect_stdout(io.StringIO()):
            brick = run_brick(device)
    run_parallel_general(device, *brick)
    del brick
    if advanced_first is None:
        # (a)'s first step: a one-step run of its model and settings
        advanced_first = simulate(advanced_model(device, BENCH_SHAPE)[0],
                                  [(5.0, 1, 1.0)],
                                  advanced_settings())[1][0].head
    run_parallel_augmented(device, advanced_first)
    if plume is None:
        with contextlib.redirect_stdout(io.StringIO()):
            sim, recs, _ = run_plume(device, BENCH_SHAPE, "oracle",
                                     periods=PLUME_PERIODS[:1])
        plume = ([r.head for r in recs], sim.conc_records)
    run_parallel_transport(device, plume)
    print(f"parallel phase in {time.perf_counter() - t0!r} s, "
          f"stencil7_launches={launches}")
    return launches


def run_api_xmi(device, deck_heads=None, deck_saved=None):
    """(i1) ``Mf6Api`` over the deck phase's bench deck by the XMI loop:
    each step's heads against the deck's ``load_simulation`` run
    (``deck_heads``) and the last against its command-line run's .hds
    (``deck_saved``; the deck run here, its .hds read back, when the deck
    phase did not run); a get_value/set_value round trip of K11 and the
    heads on the card.  Returns the stencil7 launches of the loop."""
    label = "api (i1) xmi"
    nlay, nrow, ncol = BENCH_SHAPE
    with tempfile.TemporaryDirectory() as ws:
        write_flagship_deck(ws, nlay, nrow, ncol)
        if deck_heads is None:
            sim = load_simulation(ws, device=device)
            deck_heads = [r.head for r in sim.run()]
        saved = deck_saved
        if saved is None:
            saved = np.stack([r["data"] for r in read_head_file(
                os.path.join(ws, "m.hds"))]).reshape(-1)
        t0 = time.perf_counter()
        api = Mf6Api().initialize(ws, device=device)
        init_s = time.perf_counter() - t0
        name = api._sim.model.name.upper()
        steps, inners = [], []
        with counted_run() as counts:
            t0 = time.perf_counter()
            while api.prepare_time_step():
                api.prepare_solve()
                if not api.solve():
                    raise AssertionError(f"{label}: a solve did not "
                                         "converge")
                api.finalize_solve()
                api.finalize_time_step()
                steps.append(api.get_value(f"{name}/X"))
                inners.append(api._solve_info.inner_iterations)
            sync(device)
            loop_s = time.perf_counter() - t0
        errs = [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(steps + steps[-1:], deck_heads + [saved])]
        bitwise = [bool(np.array_equal(a, b))
                   for a, b in zip(steps, deck_heads)]
        # the round trip: what get_value hands out, set_value stores back
        # on the card in the field's dtype, bit for bit
        model = api._sim.model
        k_before = model.npf_arrays.k11.clone()
        c_before = [c.clone() for c in model.condsat3]
        api.set_value(f"{name}/NPF/K11", api.get_value(f"{name}/NPF/K11"))
        k = model.npf_arrays.k11
        x = api.get_value(f"{name}/X")
        api.set_value(f"{name}/X", x)
        trip = (k.device == model.device and k.dtype == torch.float64
                and torch.equal(k, k_before)
                and all(torch.equal(a, b)
                        for a, b in zip(c_before, model.condsat3))
                and api._head.device == model.device
                and np.array_equal(api.get_value(f"{name}/X"), x))
        api.finalize()
        print(f"{label}: steps={len(steps)} init_s={init_s!r} "
              f"loop_s={loop_s!r} relative max|dh| per step vs the deck "
              f"run, and the last vs its .hds={errs} bar={API_RTOL!r} "
              f"bitwise={bitwise} last step vs .hds bitwise="
              f"{np.array_equal(steps[-1], saved)} "
              f"get/set round trip on the card={trip} "
              f"inners={inners} stencil7_launches={counts['launches']}")
    if len(steps) != 3 or not all(e <= API_RTOL for e in errs) or not trip:
        raise AssertionError(f"{label}: heads off the deck run's, or the "
                             "round trip changed a value")
    if counts["plain_on_cuda"] or counts["launches"] < sum(inners):
        raise AssertionError(f"{label}: the loop did not go through the "
                             "kernel")
    return counts["launches"]


def run_api_checkpoint(device):
    """(i2) the bench model through ``Simulation``: 3 steps of 5.0, then
    step 1, a checkpoint, and a fresh ``Simulation`` resumed from it for
    steps 2-3, bitwise equal to the uninterrupted run's."""
    label = "api (i2) checkpoint"

    def sim(periods):
        return Simulation(Tdis(periods), flagship(*BENCH_SHAPE, device),
                          ImsSettings(**BENCH))

    t0 = time.perf_counter()
    full = sim((StressPeriod(15.0, 3, 1.0),)).run()
    first = sim((StressPeriod(5.0, 1, 1.0),)).run()
    with tempfile.TemporaryDirectory() as ws:
        ck = os.path.join(ws, "ck.npz")
        t1 = time.perf_counter()
        save_checkpoint(ck, first[-1].head, kper=1, kstp=1, totim=5.0)
        save_s = time.perf_counter() - t1
        rest_sim = sim((StressPeriod(10.0, 2, 1.0),))
        snap = resume_simulation(rest_sim, ck)
        on_card = str(rest_sim.model.strt.device) == str(device)
        with counted_run() as counts:
            rest = rest_sim.run()
        size = os.path.getsize(ck)
    same = [bool(np.array_equal(a.head, b.head))
            for a, b in zip(rest, full[1:])]
    counts_same = [(a.outer, a.inner) for a in rest] == [
        (b.outer, b.inner) for b in full[1:]]
    print(f"{label}: steps 2-3 resumed bitwise={same} counts equal="
          f"{counts_same} snapshot_bytes={size} save_s={save_s!r} "
          f"totim={snap['totim']!r} heads on the card={on_card} "
          f"seconds={time.perf_counter() - t0!r} "
          f"stencil7_launches={counts['launches']}")
    if not (all(same) and len(same) == 2 and counts_same and on_card):
        raise AssertionError(f"{label}: the resumed run differs")
    return counts["launches"]


def run_api(device, deck_heads=None, deck_saved=None):
    """The api phase: (i1) and (i2).  Returns their stencil7 launches."""
    t0 = time.perf_counter()
    launches = (run_api_xmi(device, deck_heads, deck_saved)
                + run_api_checkpoint(device))
    print(f"api phase in {time.perf_counter() - t0!r} s, "
          f"stencil7_launches={launches}")
    return launches


# ---------------------------------------------------------- entry phase

# the dry run's sharded results against their single-device solves: the
# bars of tests/test_torch_parallel*.py (row shards in mixed precision,
# the general runner, the coupled transport, the augmented runner)
DRYRUN_ATOL = {"rows": SHARDED_ATOL["mixed"], "general": SHARDED_ATOL["f64"],
               "coupled": SHARDED_ATOL["transport"],
               "augmented": SHARDED_ATOL["augmented"]}
STUDY_SHAPE = (1, 75, 75)
HALO_ARGV = ["--nlay", "4", "--nrow", "128", "--ncol", "128", "--shards",
             str(SHARDS)]


def run_entry_step(device):
    """(n1) ``entry()``'s step on the card against the port's fused step
    on the CPU at the entry settings: heads within 1e-10."""
    fn, args = entry_mod.entry(device)
    with counted_run() as counts:
        head = fn(*args)
        sync(device)
    cpu = flagship(2, 64, 64, "cpu")
    h_cpu, k_cpu, i_cpu, c_cpu = make_fused_step(
        cpu, ImsSettings(**ENTRY), False)(cpu.strt, 1.0, 1)
    err = float((head.cpu() - h_cpu).abs().max())
    print(f"entry (n1) entry() step on the card: max|dh| vs the CPU step="
          f"{err!r} bar={CARD_CPU_ATOL!r} (cpu outer={k_cpu} inner={i_cpu} "
          f"converged={c_cpu}) example_args on "
          f"{[str(a.device) for a in args]} "
          f"stencil7_launches={counts['launches']}")
    if not (c_cpu and err <= CARD_CPU_ATOL and counts["launches"] >= i_cpu
            and not counts["plain_on_cuda"]):
        raise AssertionError("entry (n1): the card's step disagrees with "
                             "the CPU's, or missed the kernel")
    return counts["launches"]


def run_entry_dryrun(device):
    """(n2) ``dryrun_multichip(SHARDS)`` over the machine's cards (all its
    shards on the one card here): each run against its single-device solve
    on the card; the row shards' launches, one per shard and product."""
    t0 = time.perf_counter()
    with counted_run() as counts:
        runs = entry_mod.dryrun_multichip(SHARDS)
        sync(device)
    seconds = time.perf_counter() - t0
    errs = {}
    for name, run in runs.items():
        heads, conc = entry_mod.single_device(run)
        errs[name] = float(np.abs(run.heads - heads).max())
        if conc is not None:
            errs[f"{name} conc"] = float(np.abs(run.conc - conc).max())
    bars = {k: DRYRUN_ATOL[k.split()[0]] for k in errs}
    rows_inner = runs["rows"].info["inner"]
    print(f"entry (n2) dryrun_multichip({SHARDS}) in {seconds!r} s: "
          f"infos={ {k: r.info for k, r in runs.items()} } max|d| vs "
          f"single-device={errs} bars={bars} "
          f"stencil7_launches={counts['launches']} (at least {SHARDS} x "
          f"{rows_inner})")
    if not all(errs[k] <= bars[k] for k in errs):
        raise AssertionError("entry (n2): a sharded dry run is off its "
                             "single-device solve")
    if counts["launches"] < SHARDS * rows_inner or counts["plain_on_cuda"]:
        raise AssertionError("entry (n2): the row shards missed the kernel")
    return counts["launches"]


def run_entry_study(device):
    """(n3) ``iteration_study``'s 75x75 rows on the card, the f64 ones
    against the same cases on the CPU (equal inner counts); and its scipy
    row."""
    card = iteration_study.build(*STUDY_SHAPE, device=device)
    cpu = iteration_study.build(*STUDY_SHAPE, device="cpu")
    launches = 0
    for pc in ("jacobi", "chebyshev", "mg"):
        for prec in ("f64", "mixed"):
            with counted_run() as counts:
                r = iteration_study.card_case(card, pc, prec)
            want = (iteration_study.card_case(cpu, pc, prec)
                    if prec == "f64" else r)
            launches += counts["launches"]
            print(f"entry (n3) | 75x75 | {pc}-CG ({prec}) | {r['inner']} | "
                  f"{r['per_step'] * 1e3:.1f} ms | cpu inner="
                  f"{want['inner'] if prec == 'f64' else 'not run'} "
                  f"converged={r['conv']} stencil7_launches="
                  f"{counts['launches']}")
            if not (r["conv"] and want["conv"] and counts["launches"]
                    and not counts["plain_on_cuda"]):
                raise AssertionError(f"entry (n3): {pc} {prec} failed")
            if r["inner"] != want["inner"]:
                raise AssertionError(f"entry (n3): {pc} f64 took "
                                     f"{r['inner']} inner iterations on the "
                                     f"card, {want['inner']} on the CPU")
    r = iteration_study.scipy_ilu_case(card)
    print(f"entry (n3) | 75x75 | scipy ILU(0)-BiCGSTAB | {r['inner']} | "
          f"{r['wall'] * 1e3:.1f} ms (1 core) | converged={r['conv']}")
    if not r["conv"]:
        raise AssertionError("entry (n3): the scipy case did not converge")
    return launches


def run_entry_halo(device):
    """(n4) ``halo_study`` at 4 x 128 x 128 on SHARDS shards (all on the
    one card): its lines; the single-device solve's launches."""
    with counted_run() as counts:
        out = halo_study.main(HALO_ARGV)
    if not (out["sharded_inner"] > 1 and out["single_inner"] > 1
            and out["slots_ppermute"] > 0) or counts["plain_on_cuda"]:
        raise AssertionError("entry (n4): the halo study failed")
    print(f"entry (n4) halo_study stencil7_launches={counts['launches']}")
    return counts["launches"]


def run_entry(device):
    """The entry phase: the port's entry scripts, (n1)-(n4).  Returns
    their stencil7 launches."""
    t0 = time.perf_counter()
    launches = (run_entry_step(device) + run_entry_dryrun(device)
                + run_entry_study(device) + run_entry_halo(device))
    print(f"entry phase in {time.perf_counter() - t0!r} s, "
          f"stencil7_launches={launches}")
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


PHASES = ("kernel", "pcg", "bicgstab", "small", "bench", "precond", "deck", "newton",
          "unstructured", "properties", "advanced", "coupling", "utilities",
          "transport", "apt", "gwe", "swf", "prt", "parallel", "api",
          "entry")


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
    t0 = time.perf_counter()
    lib_path, log = pcg_jacobi.build()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.strip().splitlines():
        print(f"  nvcc: {line}")
    t0 = time.perf_counter()
    lib_path, log = bicgstab_ell.build()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in log.strip().splitlines():
        print(f"  nvcc: {line}")
    if args.profile:
        profile_bench(device, args.preconditioner, args.grid)
        return

    launches = {}
    # what the parallel and api phases hold their runs against
    brick = advanced_first = plume = deck_heads = deck_saved = None
    t_script = time.perf_counter()
    marks = []

    def mark(name):
        marks.append((name, time.perf_counter()))
        PATH_NOW[0] = name

    mark("kernel")
    if "kernel" in phases:
        worst, times = check_kernel(device)
    mark("pcg")
    if "pcg" in phases:
        pcg_times = check_pcg(device)
    mark("bicgstab")
    if "bicgstab" in phases:
        bicg_times = check_bicgstab(device)
    mark("small")
    if "small" in phases:
        t_small = time.perf_counter()
        check_small_model(device)
        check_small_preconditioned(device)
        check_small_deck(device)
        check_small_newton(device)
        check_small_general(device)
        check_small_coupling(device)
        check_small_transport(device)
        check_small_apt(device)
        t_swf = time.perf_counter()
        check_small_swf_prt(device)
        print(f"small phase in {time.perf_counter() - t_small!r} s (the "
              f"SWF and PRT twins {time.perf_counter() - t_swf!r} s)")
    mark("bench")
    if "bench" in phases:
        launches["fused"], mixed_head, _, mixed_inners, _ = run_bench(
            device, "mixed", baseline=True)
        # the f64 run without a warm-up (its seconds are printed, not held)
        f64_launches, fused_head, kiters, inners, _ = run_bench(
            device, "f64", warmup=False)
        launches["fused"] += f64_launches
    mark("precond")
    if "precond" in phases:
        measure_preconditioner_apply(device)
        jacobi_inner = {"f64": sum(inners), "mixed": sum(mixed_inners)}
        # no warm-up runs here: their elapsed seconds are printed, not
        # held to anything
        launches["preconditioned"] = sum(
            run_bench(device, precision, pc,
                      jacobi=(fused_head, jacobi_inner[precision]),
                      warmup=False)[0]
            for pc in ("chebyshev", "mg") for precision in ("mixed", "f64"))
    mark("deck")
    if "deck" in phases:
        launches["deck"], deck_heads, deck_saved = run_deck_bench(
            device, fused_head, list(zip(kiters, inners)))
        launches["deck"] += run_deck_preconditioned(device, fused_head,
                                                    sum(inners))
    mark("newton")
    if "newton" in phases:
        launches["newton"] = run_newton_deck(device,
                                             args.newton_preconditioner)
    if ("unstructured" in phases or "properties" in phases
            or "parallel" in phases) and "bench" not in phases:
        _, fused_head, kiters, inners, _ = run_bench(device, "f64")
    if "parallel" in phases and "bench" not in phases:
        _, mixed_head, _, mixed_inners, _ = run_bench(device, "mixed")
    mark("unstructured")
    if "unstructured" in phases:
        run_disv_oracle(device, fused_head, list(zip(kiters, inners)))
        brick = run_brick(device)
        run_brick_deck(device)
        launches["general"] = run_rotated(device)
    mark("properties")
    if "properties" in phases:
        launches["properties"] = run_properties(device, fused_head)
    mark("advanced")
    if "advanced" in phases:
        advanced_launches, advanced_first = run_advanced(device)
    mark("coupling")
    if "coupling" in phases:
        launches["coupling"] = run_coupling(device)
    mark("utilities")
    if "utilities" in phases:
        launches["utilities"] = run_utilities(device)
    mark("transport")
    if "transport" in phases:
        launches["transport"], plume = run_transport(device)
    mark("apt")
    if "apt" in phases:
        apt_launches = run_apt(device)
    mark("gwe")
    if "gwe" in phases:
        launches["gwe"] = run_gwe(device)
    mark("swf")
    if "swf" in phases:
        launches["swf"] = run_swf(device)
    mark("prt")
    if "prt" in phases:
        launches["prt"] = run_prt(device)
    mark("parallel")
    if "parallel" in phases:
        launches["parallel"] = run_parallel(
            device, {"f64": (fused_head, inners),
                     "mixed": (mixed_head, mixed_inners)}, brick,
            advanced_first, plume)
    del brick, plume
    mark("api")
    if "api" in phases:
        launches["api"] = run_api(device, deck_heads, deck_saved)
    mark("entry")
    if "entry" in phases:
        launches["entry"] = run_entry(device)
    mark("end")
    print(f"chip_smoke: phases {phases} in "
          f"{time.perf_counter() - t_script!r} s (the build before them); "
          "seconds from each phase's start to the next's (the oracle runs "
          "of a phase whose oracle phase was left out count to the phase "
          "before it): "
          f"{ {n: t1 - t0 for (n, t0), (_, t1) in zip(marks, marks[1:])} }")
    if set(phases) != set(PHASES):
        print(f"phases {phases} passed; the result lines need all phases")
        return
    if not all(launches.values()):
        raise AssertionError(f"a main path launched no stencil7 kernel: "
                             f"{launches}")
    fused_by_path = {name: PATH_LAUNCHES[name]["pcg_jacobi"]
                     for name in PHASES if name in PATH_LAUNCHES}
    bicg_by_path = {name: PATH_LAUNCHES[name]["bicgstab_ell"]
                    for name in PHASES if name in PATH_LAUNCHES}
    if not (fused_by_path.get("bench") and fused_by_path.get("deck")):
        raise AssertionError(f"the bench or deck path ran no fused Jacobi-CG "
                             f"iteration: {fused_by_path}")

    ms, plain_ms, one_call_ms, library_ms = times["f64"]
    ms32, plain_ms32, one_call_ms32, library_ms32 = times["f32"]
    print(json.dumps({"kernels": [{
        "name": "stencil7", "route": "cuda",
        "source": "modflow6_torch/csrc/stencil7.cu",
        "replaces": "modflow6_tpu/ops/pallas_stencil.py:29",
        "launches": sum(launches.values()) + advanced_launches
        + apt_launches,
        "launches_fused_path": launches["fused"],
        "launches_preconditioned_fused_path": launches["preconditioned"],
        "launches_deck_path": launches["deck"],
        "launches_newton_deck_path": launches["newton"],
        "launches_general_assembly_path": launches["general"],
        "launches_properties_path": launches["properties"],
        "launches_advanced_path": advanced_launches,
        "launches_coupling_path": launches["coupling"],
        "launches_utilities_path": launches["utilities"],
        "launches_transport_path": launches["transport"],
        "launches_apt_path": apt_launches,
        "launches_gwe_path": launches["gwe"],
        "launches_swf_path": launches["swf"],
        "launches_prt_path": launches["prt"],
        "launches_parallel_path": launches["parallel"],
        "launches_api_path": launches["api"],
        "launches_entry_path": launches["entry"],
        "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": stencil_bound_ms(BENCH_SHAPE, torch.float64),
        "bound_by": "bytes", "library_ms": library_ms,
        "library_ms_f32": library_ms32,
        "ms_one_call_host_inclusive": one_call_ms,
        "ms_f32": ms32, "plain_ms_f32": plain_ms32,
        "bound_ms_f32": stencil_bound_ms(BENCH_SHAPE, torch.float32),
        "ms_f32_one_call_host_inclusive": one_call_ms32,
        # the counted runs of each phase: stencil7_kernel alone, without
        # the fused iterations' products that the counts above include
        "launches_stencil7_kernel_by_phase": {
            name: PATH_LAUNCHES[name]["stencil7_kernel"]
            for name in PHASES if name in PATH_LAUNCHES}}, {
        "name": "pcg_jacobi", "route": "cuda",
        "source": "modflow6_torch/csrc/pcg_jacobi.cu", "replaces": None,
        # the counted runs of the main paths (not the pcg phase's checks
        # and timing loops), by phase; four an iteration
        "launches": sum(fused_by_path.values()),
        "launches_by_phase": fused_by_path,
        "ms_by_kernel": {f"{shape[0]}x{shape[1]}x{shape[2]} {name}": {
            k: ms for k, (ms, _) in row.items()}
            for (shape, name), row in pcg_times.items()},
        "bound_ms_by_kernel": {f"{shape[0]}x{shape[1]}x{shape[2]} {name}": {
            k: b for k, (_, b) in row.items()}
            for (shape, name), row in pcg_times.items()},
        "bound_by": "bytes"}, {
        "name": "bicgstab_ell", "route": "cuda",
        "source": "modflow6_torch/csrc/bicgstab_ell.cu", "replaces": None,
        # the counted runs of the main paths (not the bicgstab phase's
        # checks and timing loops), by phase; six an iteration
        "launches": sum(bicg_by_path.values()),
        "launches_by_phase": bicg_by_path,
        "ms_by_kernel": {f"{shape[0]}x{shape[1]}x{shape[2]} {name}": {
            k: ms for k, (ms, _) in row.items()}
            for (shape, name), row in bicg_times.items()},
        "bound_ms_by_kernel": {f"{shape[0]}x{shape[1]}x{shape[2]} {name}": {
            k: b for k, (_, b) in row.items()}
            for (shape, name), row in bicg_times.items()},
        "bound_by": "bytes"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
