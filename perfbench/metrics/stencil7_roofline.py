"""``stencil7``'s share of its bandwidth bound, in %: the least time of one
product (``yardstick.stencil7_bytes`` over the card's HBM rate) over the
mean device time of the stencil7 kernels in the profiled stretch."""

from perfbench import yardstick


def read(ctx):
    prof = ctx["profile"]
    if not prof:
        return None
    runs = [v for k, v in prof["kernels"].items() if "stencil7" in k]
    count = sum(n for _, n in runs)
    if not count:
        return None
    mean_s = sum(s for s, _ in runs) / count
    bound = yardstick.bound_s(yardstick.stencil7_bytes(
        ctx["grid_shape"], ctx["element_size"]))
    return bound / mean_s * 100.0
