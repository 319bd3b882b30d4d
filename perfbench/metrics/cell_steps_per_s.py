"""Grid cells x converged time steps over the window's seconds (host
clock; the window ends at the return of its last step)."""


def read(ctx):
    done = sum(1 for _, ok, _ in ctx["steps"] if ok)
    return ctx["n_cells"] * done / ctx["window_s"]
