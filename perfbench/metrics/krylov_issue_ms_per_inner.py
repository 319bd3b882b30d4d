"""ms per Krylov iteration that the host spends in the solver other than
waiting on its exit flags: the window's ``krylov`` spans (``StepRecord
.spans``, the program's own host clock) less their ``wait_ns``, over
their iterations.  Records without spans (a program that keeps none) give
nothing to read."""


def read(ctx):
    spans = [s for _, _, rec in ctx["steps"]
             for s in getattr(rec, "spans", None) or ()
             if s.name == "krylov"]
    iters = sum(s.iters for s in spans)
    if not iters:
        return None
    return sum(s.end_ns - s.start_ns - s.wait_ns for s in spans) \
        / iters * 1e-6
