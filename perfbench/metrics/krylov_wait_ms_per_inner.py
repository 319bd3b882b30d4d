"""ms per Krylov iteration that the host spends blocked on the loop's
exit-flag reads: the ``wait_ns`` of the window's ``krylov`` spans
(``StepRecord.spans``) over their iterations."""


def read(ctx):
    spans = [s for _, _, rec in ctx["steps"]
             for s in getattr(rec, "spans", None) or ()
             if s.name == "krylov"]
    iters = sum(s.iters for s in spans)
    return sum(s.wait_ns for s in spans) / iters * 1e-6 if iters else None
