"""The flow solution's outer iterations per step (``StepRecord.outer``),
the mean over the window."""


def read(ctx):
    recs = [rec for _, _, rec in ctx["steps"]]
    return sum(r.outer for r in recs) / len(recs) if recs else None
