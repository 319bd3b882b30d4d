"""The transport solution's inner iterations per step: the
``transport_inner`` count of the window's steps
(``StepRecord.counters``), their mean.  A program without the count gives
nothing to read."""


def read(ctx):
    recs = [rec for _, _, rec in ctx["steps"]
            if "transport_inner" in (getattr(rec, "counters", None) or {})]
    if not recs:
        return None
    return sum(r.counters["transport_inner"] for r in recs) / len(ctx["steps"])
