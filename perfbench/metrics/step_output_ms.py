"""ms per step of ``do_step``'s own work after the flow solve: its
budget, record and host copy of the heads.  ``StepRecord.output_seconds``
spans everything after the flow solve, the transport step included, so the
transport's ``fmi_seconds``, ``apt_seconds`` and ``transport_seconds`` are
taken off; the mean over the window."""


def read(ctx):
    recs = [rec for _, _, rec in ctx["steps"]]
    if not recs:
        return None
    own = [r.output_seconds - r.fmi_seconds - r.apt_seconds
           - r.transport_seconds for r in recs]
    return sum(own) / len(own) * 1e3
