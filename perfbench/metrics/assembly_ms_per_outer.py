"""ms per outer iteration of the flow system's assembly (``assemble``
spans: the model's terms, the Dirichlet fixup and any PTC terms; host
time, no synchronisation), over the window's outer iterations."""


def read(ctx):
    recs = [rec for _, _, rec in ctx["steps"] if getattr(rec, "spans", None)]
    outer = sum(r.outer for r in recs)
    if not outer:
        return None
    return sum(s.end_ns - s.start_ns for r in recs for s in r.spans
               if s.name == "assemble") / outer * 1e-6
