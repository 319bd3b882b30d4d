"""Share of the window's inner iterations that ran as the fused Jacobi-CG
kernels: the ``pcg_jacobi`` launches of the window's steps
(``StepRecord.counters["launches"]``, four an iteration) over their inner
iterations.  A program without those kernels, or records without the
launch counter, give nothing to read."""

import importlib.util

KERNELS = "modflow6_torch.ops.solvers.pcg_jacobi"
LAUNCHES_PER_ITERATION = 4


def read(ctx):
    if importlib.util.find_spec(KERNELS) is None:
        return None
    recs = [rec for _, _, rec in ctx["steps"]
            if "launches" in (getattr(rec, "counters", None) or {})]
    inner = sum(r.inner for r in recs)
    launched = sum(r.counters["launches"].get("pcg_jacobi", 0) for r in recs)
    return launched / LAUNCHES_PER_ITERATION / inner if inner else None
