"""Time to solution per preconditioner and precision, against an
ILU(0)-preconditioned scipy BiCGSTAB on the same matrix (port of the
repository's ``tools/iteration_study.py``).

Measures the total inner (Krylov) iterations and the wall-clock seconds
per time step of the fused run on the flagship problem (lognormal K) at
75x75 and, with ``--big``, at the 4.2M-cell benchmark configuration, for
each preconditioner (jacobi / chebyshev / mg) on the device, and the
iterations of scipy's ILU(0)-BiCGSTAB on one core at 75x75 (a proxy for
the IMS ILU0 solver).  Compare elapsed seconds at equal heads: the
iteration counts of different preconditioners are not comparable work.

Usage: python -m modflow6_torch.tools.iteration_study [--big]
           [--device cuda|cpu]
Writes a markdown table to stdout.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from .. import resolve_device
from ..bench import (STEP_LENGTH, device_name, flagship, host_system,
                     synchronize)
from ..solution import ImsSettings
from ..solution.fused import make_fused_run


def build(nlay, nrow, ncol, device=None):
    """The study's model (the flagship model) on ``device``."""
    return flagship(nlay, nrow, ncol, device)


def card_case(model, precond, precision, steps=3):
    """The fused run with ``precond`` in ``precision``: a warm-up run, then
    a timed one.  Returns dict(inner, wall, per_step, conv)."""
    settings = ImsSettings(outer_dvclose=1e-5, outer_maximum=50,
                           inner_dvclose=1e-7, inner_rclose=1e-5,
                           inner_maximum=1000, precision=precision,
                           preconditioner=precond,
                           preconditioner_order=4)
    run = make_fused_run(model, settings, iss=False, nsteps=steps)
    delts = [STEP_LENGTH] * steps
    run(model.strt, delts)
    synchronize(model.device)
    t0 = time.perf_counter()
    head, kiters, inners, convs = run(model.strt, delts)
    synchronize(model.device)
    dt = time.perf_counter() - t0
    return dict(inner=sum(inners), wall=dt, per_step=dt / steps,
                conv=all(convs))


def scipy_ilu_case(model):
    """ILU(0)-preconditioned BiCGSTAB iterations on the model's first
    system (the host copy of the system built on its device)."""
    import scipy.sparse.linalg as spla

    amat, b, hh = host_system(model, STEP_LENGTH)
    amat = (-amat).tolil()
    b = -b
    # Dirichlet identity rows carry +1 diagonals in the CVFD convention;
    # after negation flip them back so -A is SPD
    dg = amat.diagonal()
    flip = np.flatnonzero(dg < 0)
    for i in flip:
        amat[i, i] = -dg[i]
        b[i] = -b[i]
    amat = amat.tocsc()
    ilu = spla.spilu(amat, fill_factor=1.0, drop_tol=0.0)   # ILU(0)-like
    M = spla.LinearOperator(amat.shape, ilu.solve)
    it = {"n": 0}

    def cb(xk):
        it["n"] += 1

    # spilu's factorization is unsymmetric (pivoting), so pair it with
    # BiCGSTAB, the reference solver's own asymmetric-path combination
    t0 = time.perf_counter()
    x, info = spla.bicgstab(amat.tocsr(), b, x0=hh, rtol=1e-8,
                            maxiter=2000, M=M, callback=cb)
    wall = time.perf_counter() - t0
    return dict(inner=it["n"], wall=wall, conv=info == 0)


def main(argv=None):
    """Prints the table; returns its rows as (config, solver, result)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--big", action="store_true",
                    help="include the 4.2M-cell config, in f64 and mixed")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="the device of the runs (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cases = [("75x75", (1, 75, 75))]
    if args.big:
        cases.append(("4.2M", (4, 1024, 1024)))
    rows = []
    print(f"device: {device_name(device)}")
    print("| config | solver | inner iters (3 steps) | wall/step |")
    print("|---|---|---|---|")
    for name, shape in cases:
        model = build(*shape, device=device)
        for pc in ("jacobi", "chebyshev", "mg"):
            for prec in ("f64", "mixed"):
                r = card_case(model, pc, prec)
                rows.append((name, f"{pc}-CG ({prec})", r))
                print(f"| {name} | {pc}-CG ({prec}) | {r['inner']} "
                      f"| {r['per_step']*1e3:.1f} ms |", flush=True)
        if shape[0] * shape[1] * shape[2] <= 400_000:
            r = scipy_ilu_case(model)
            rows.append((name, "scipy ILU(0)-BiCGSTAB", r))
            print(f"| {name} | scipy ILU(0)-BiCGSTAB (1 solve, rtol 1e-8) "
                  f"| {r['inner']} | {r['wall']*1e3:.1f} ms (1 core) |",
                  flush=True)
    return rows


if __name__ == "__main__":
    main()
