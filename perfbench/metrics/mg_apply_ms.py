"""ms per application of the flow's multigrid V-cycle: the mean of the
window's ``mg_apply`` spans (host time, no synchronisation; the Krylov
loop's exit-flag read keeps the host within an iteration of the card).
A program without the span gives nothing to read."""


def read(ctx):
    spans = [s for _, _, rec in ctx["steps"]
             for s in (getattr(rec, "spans", None) or [])
             if s.name == "mg_apply"]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) * 1e-6
