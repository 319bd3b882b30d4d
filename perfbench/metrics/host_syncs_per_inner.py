"""Blocking device-to-host reads and explicit synchronisations of the
flow step per inner iteration: the ``host_syncs`` counter of the window's
steps (``StepRecord.counters``) over their inner iterations."""


def read(ctx):
    recs = [rec for _, _, rec in ctx["steps"]
            if "host_syncs" in (getattr(rec, "counters", None) or {})]
    inner = sum(r.inner for r in recs)
    return (sum(r.counters["host_syncs"] for r in recs) / inner
            if inner else None)
