"""Share of the window's transport inner iterations that ran as the fused
Jacobi-BiCGSTAB kernels on the ELL system: the ``bicgstab_ell`` launches of
the window's steps (``StepRecord.counters["launches"]``, six an iteration)
over their ``transport_inner`` counts.  A program without those kernels, or
records without the launch counter, give nothing to read."""

import importlib.util

KERNELS = "modflow6_torch.ops.solvers.bicgstab_ell"
LAUNCHES_PER_ITERATION = 6


def read(ctx):
    if importlib.util.find_spec(KERNELS) is None:
        return None
    recs = [rec for _, _, rec in ctx["steps"]
            if "launches" in (getattr(rec, "counters", None) or {})]
    inner = sum(r.counters.get("transport_inner", 0) for r in recs)
    launched = sum(r.counters["launches"].get("bicgstab_ell", 0)
                   for r in recs)
    return launched / LAUNCHES_PER_ITERATION / inner if inner else None
