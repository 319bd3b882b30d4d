"""The flow solution's inner iterations per step (``StepRecord.inner``),
the mean over the window."""


def read(ctx):
    recs = [rec for _, _, rec in ctx["steps"]]
    return sum(r.inner for r in recs) / len(recs) if recs else None
