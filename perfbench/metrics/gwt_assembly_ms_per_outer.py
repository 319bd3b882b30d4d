"""ms per outer iteration of the transport system's assembly: the
``assemble`` spans inside a ``transport`` span (ADV, DSP, MST, SSM and the
fixup; host time, no synchronisation) over the ``outer`` spans inside
one, over the window's steps.  A program whose transport opens no
``transport`` span gives nothing to read."""


def _inside_transport(rec):
    """The spans of ``rec`` that a ``transport`` span encloses."""
    spans = getattr(rec, "spans", None) or []
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        p = by_id.get(s.parent)
        while p is not None and p.name != "transport":
            p = by_id.get(p.parent)
        if p is not None:
            out.append(s)
    return out


def read(ctx):
    inside = [s for _, _, rec in ctx["steps"]
              for s in _inside_transport(rec)]
    outer = sum(1 for s in inside if s.name == "outer")
    if not outer:
        return None
    return sum(s.end_ns - s.start_ns for s in inside
               if s.name == "assemble") / outer * 1e-6
