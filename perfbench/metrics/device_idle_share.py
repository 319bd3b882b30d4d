"""The share of the profiled stretch of whole steps in which no operation
ran on the card: 1 - busy / window, from the ``torch.profiler`` trace."""


def read(ctx):
    prof = ctx["profile"]
    if not prof or prof["busy_s"] <= 0:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
