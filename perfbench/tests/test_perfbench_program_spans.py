"""The per-layer metrics that read the program's own spans and counters
(``StepRecord.spans`` and ``.counters``), at a small grid on the CPU."""

import pytest

from perfbench import run
from perfbench.tests.helpers import run_small

NAMES = ("krylov_issue_ms_per_inner", "krylov_wait_ms_per_inner",
         "host_syncs_per_inner", "assembly_ms_per_outer")


def _traced(workload):
    """A traced run and the records of its window's steps."""
    recs = []

    def keep_records(cell):
        step = cell.step

        def recorded(i, keep=True):
            ok, rec = step(i, keep)
            if keep:
                recs.append(rec)
            return ok, rec
        cell.step = recorded

    return run_small(workload, trace=True, wrap_cell=keep_records), recs


@pytest.mark.parametrize("workload", ["npf-jacobi-replay"])
def test_program_span_metrics(workload):
    res, recs = _traced(workload)
    assert res["correct"], res["compared"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in NAMES:
        assert got[name] > 0, name
    krylov = [s for r in recs for s in r.spans if s.name == "krylov"]
    iters = sum(s.iters for s in krylov)
    assert iters == sum(r.inner for r in recs) > 0
    total_ms = sum(s.end_ns - s.start_ns for s in krylov) * 1e-6
    issue_and_wait = (got["krylov_issue_ms_per_inner"]
                      + got["krylov_wait_ms_per_inner"]) * iters
    assert issue_and_wait == pytest.approx(total_ms, rel=1e-12)
    # one exit-flag read an inner iteration, one an outer, and do_step's
    # own few a step
    syncs = sum(r.counters["host_syncs"] for r in recs)
    outer = sum(r.outer for r in recs)
    assert iters + outer < syncs <= iters + outer + 4 * len(recs)
    assert got["host_syncs_per_inner"] == pytest.approx(syncs / iters,
                                                        rel=1e-12)


def test_metrics_read_nothing_without_spans():
    """A program that keeps no spans or counters: the readers give
    nothing, and do not raise."""
    bench = run.Bench()

    class Bare:
        outer, inner = 3, 40

    ctx = dict(steps=[(0.1, True, Bare())])
    for name in NAMES:
        assert bench.reader(name).read(ctx) is None, name
