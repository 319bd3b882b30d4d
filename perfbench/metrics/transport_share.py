"""The share of the window's steps spent in their transport: the
``transport`` spans (FMI and the transport solve) over the ``step`` spans,
host clock.  A program whose transport opens no ``transport`` span gives
nothing to read."""


def read(ctx):
    spans = [s for _, _, rec in ctx["steps"]
             for s in (getattr(rec, "spans", None) or [])]
    step = sum(s.end_ns - s.start_ns for s in spans if s.name == "step")
    part = sum(s.end_ns - s.start_ns for s in spans
               if s.name == "transport")
    return part / step if step and part else None
