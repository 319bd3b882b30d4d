"""Levels of the flow's multigrid hierarchy: the ``mg_levels`` count over
the ``mg_builds`` count of the window's steps
(``StepRecord.counters``; one build an outer iteration).  A program
without those counts gives nothing to read."""


def read(ctx):
    recs = [rec for _, _, rec in ctx["steps"]
            if "mg_builds" in (getattr(rec, "counters", None) or {})]
    builds = sum(r.counters["mg_builds"] for r in recs)
    if not builds:
        return None
    return sum(r.counters.get("mg_levels", 0) for r in recs) / builds
