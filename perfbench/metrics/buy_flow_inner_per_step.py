"""The density-coupled flow solution's inner iterations per step
(``StepRecord.inner``, which counts the flow's alone), the mean over the
window."""


def read(ctx):
    recs = [rec for _, _, rec in ctx["steps"]]
    return sum(r.inner for r in recs) / len(recs) if recs else None
