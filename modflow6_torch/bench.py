"""Benchmark: grid-cell Krylov-iteration throughput of the fused implicit
solve, on the CUDA device (port of the repository's ``bench.py``).

Prints ONE JSON line on stdout:
  {"metric": "ims_cell_iters_per_s", "value": N, "unit": "cell-iter/s",
   "vs_baseline": R}

- value: grid cells x inner (Krylov) iterations per wall-clock second of
  the fused transient run (assembly, fixups, the preconditioned CG inner
  loop), timed after one warm-up run, with the device synchronised on
  both sides.
- vs_baseline: ratio against a single-core scipy CSR run of the same
  Jacobi-CG iteration on the same matrix (``scipy_baseline_rate``); 0.0
  with ``--skip-baseline``.

and one diagnostic line on stderr (cells, steps, inner_total, elapsed,
converged, the device's name).

Usage: python -m modflow6_torch.bench [--nlay N] [--nrow N] [--ncol N]
           [--steps N] [--precision f64|mixed] [--skip-baseline]
           [--device cuda|cpu]

The model (``flagship_grid``/``flagship_args``: seed 75, lognormal K, a
CHD column on each side, one well, recharge) is the one of the smoke run
and of ``entry._flagship``; ``build`` puts it on a device with the
benchmark's IMS settings (``BENCH``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .models.discretization import DisGrid
from .models.gwf.advanced import structured_nbr
from .models.gwf.builder import build_gwf
from .ops.system import apply_dirichlet, to_scipy_csr
from .solution import ImsSettings
from .solution.fused import make_fused_run

# the IMS settings of the benchmark run
BENCH = dict(outer_dvclose=1e-5, outer_maximum=50, inner_dvclose=1e-7,
             inner_rclose=1e-5, inner_maximum=400)
STEP_LENGTH = 5.0


def flagship_kfield(nlay, nrow, ncol):
    rng = np.random.default_rng(75)
    return np.exp(rng.normal(0.0, 1.0, size=nlay * nrow * ncol))


def flagship_botm(nlay, ncpl):
    return np.linspace(0.0, -50.0, nlay)[:, None] * np.ones((nlay, ncpl))


def flagship_stresses(nrow, ncol):
    """CHD, WEL and RCH of the flagship model by cell number in layer 1."""
    return dict(
        chd=[(i * ncol, 45.0) for i in range(nrow)]
        + [(i * ncol + ncol - 1, 35.0) for i in range(nrow)],
        wel=[((nrow // 2) * ncol + ncol // 2, -500.0)],
        rch=[(n, 1e-4) for n in range(nrow * ncol)])


def flagship_grid(nlay, nrow, ncol):
    return DisGrid.create(nlay, nrow, ncol, delr=10.0, delc=10.0, top=50.0,
                          botm=flagship_botm(nlay, nrow * ncol).reshape(
                              nlay, nrow, ncol))


def flagship_args(nlay, nrow, ncol):
    """The keyword arguments of ``build_gwf`` for the flagship model, but
    the grid and the device."""
    return dict(k=flagship_kfield(nlay, nrow, ncol), strt=40.0,
                storage={"ss": 1e-5, "iconvert": 0},
                **flagship_stresses(nrow, ncol))


def flagship(nlay, nrow, ncol, device=None):
    """The flagship model on ``device`` (the CUDA device by default)."""
    return build_gwf("flagship", flagship_grid(nlay, nrow, ncol),
                     device=resolve_device(device),
                     **flagship_args(nlay, nrow, ncol))


def build(nlay, nrow, ncol, precision="mixed", device=None):
    """(model, settings) of the benchmark run on ``device``."""
    model = flagship(nlay, nrow, ncol, device)
    return model, ImsSettings(**BENCH, precision=precision)


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_run(model, settings, steps, warmup=True, around=None):
    """The fused run of ``steps`` steps: one warm-up run (unless
    ``warmup`` is false), then one timed run inside the context manager
    ``around`` (when given), with the device synchronised on both sides.
    Returns (head, kiters, inners, convs, elapsed seconds)."""
    run = make_fused_run(model, settings, iss=False, nsteps=steps)
    delts = [STEP_LENGTH] * steps
    if warmup:
        run(model.strt, delts)
    synchronize(model.device)
    with around if around is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        head, kiters, inners, convs = run(model.strt, delts)
        synchronize(model.device)
        elapsed = time.perf_counter() - t0
    return head, kiters, inners, convs, elapsed


def host_system(model, delt=1.0):
    """The model's first assembled system with the Dirichlet fixup, built
    on the model's device and copied to the host: (scipy CSR matrix, rhs,
    start heads) as numpy."""
    ib, h = model.boundary_state(model.strt)
    diag, off, rhs = model.assemble(h, h, ib, delt, False)
    dtopo = model.system_topo
    if dtopo.nbr is None:
        # a structured model's planes, over its neighbour table
        dtopo = dataclasses.replace(dtopo, nbr=torch.as_tensor(
            structured_nbr(model.topo), device=model.device))
    diag, off, rhs = apply_dirichlet(dtopo.nbr, torch.sign(ib), diag, off,
                                     rhs, h)
    amat = to_scipy_csr(dtopo, diag, off).tocsr()
    return amat, rhs.cpu().numpy(), h.cpu().numpy()


def scipy_baseline_rate(model, iters=60):
    """Single-core Jacobi-CG iteration rate with scipy CSR (cells x
    iterations per second) on the model's first system."""
    amat, b, h = host_system(model)
    n = b.size
    minv = 1.0 / amat.diagonal()
    x = h.copy()
    r = b - amat @ x
    p = np.zeros_like(x)
    rho0 = 0.0
    t0 = time.perf_counter()
    for it in range(iters):
        z = minv * r
        rho = r @ z
        beta = 0.0 if it == 0 else rho / rho0
        p = z + beta * p
        q = amat @ p
        alpha = rho / (p @ q)
        x += alpha * p
        r -= alpha * q
        rho0 = rho
    dt = time.perf_counter() - t0
    return n * iters / dt


def result_line(rate, ratio):
    """The benchmark's JSON line."""
    return json.dumps({"metric": "ims_cell_iters_per_s", "value": rate,
                       "unit": "cell-iter/s", "vs_baseline": ratio})


def device_name(device):
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def main(argv=None):
    """Runs the benchmark and prints its lines; returns a dict with the
    run's head, kiters, inners, convs, inner_total, elapsed, rate and
    vs_baseline."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # default: the multi-million-cell DIS configuration (4.2M cells)
    ap.add_argument("--nlay", type=int, default=4)
    ap.add_argument("--nrow", type=int, default=1024)
    ap.add_argument("--ncol", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--precision", choices=["f64", "mixed"], default="mixed",
                    help="mixed = f32 Krylov inner loop + f64 iterative "
                    "refinement (final heads still satisfy the f64 IMS "
                    "convergence criteria)")
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="the device of the run (default: the CUDA device)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model, settings = build(args.nlay, args.nrow, args.ncol, args.precision,
                            device)
    head, kiters, inners, convs, elapsed = timed_run(model, settings,
                                                     args.steps)
    total_inner = sum(inners)
    rate = model.nodes * total_inner / elapsed
    ratio = 0.0
    if not args.skip_baseline:
        ratio = rate / scipy_baseline_rate(model)
    print(result_line(rate, ratio), flush=True)
    print(f"# cells={model.nodes} steps={args.steps} "
          f"inner_total={total_inner} elapsed={elapsed:.3f}s "
          f"converged={all(convs)} device={device_name(device)}",
          file=sys.stderr)
    return dict(head=head, kiters=kiters, inners=inners, convs=convs,
                inner_total=total_inner, elapsed=elapsed, rate=rate,
                vs_baseline=ratio)


if __name__ == "__main__":
    main()
