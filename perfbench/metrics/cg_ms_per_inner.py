"""ms per CG iteration: the synchronised spans around every ``cg`` call of
the window over the iterations they ran."""

# the span this reader reads: every call of the CG solver that
# ``NumericalSolution`` makes through its module
SPANS = {"cg": ("modflow6_torch.solution.ims", "cg")}


def read(ctx):
    calls = ctx["spans"].get("cg", [])
    iters = sum(n for _, n in calls)
    return sum(s for s, _ in calls) / iters * 1e3 if iters else None
