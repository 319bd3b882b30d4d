"""The flow step's spans and counters (modflow6_torch/utils/profiler.py):
what lands on each ``StepRecord``, the ranges a ``torch.profiler`` sees,
and the listing built from the spans.

The model is npf01b's layout on a 24 x 24 grid (lognormal K, confined, CHD
48 and 40 on the west and east columns, a well of -1000 in the middle,
three transient steps), on the CPU.  Host reads are counted where the code
makes them, whatever the device, so the counts here are the card's.
"""

import numpy as np
import pytest
import torch

from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.simulation import Simulation
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.fused import make_fused_run
from modflow6_torch.timing.ats import AtsPeriod
from modflow6_torch.timing.tdis import StressPeriod, Tdis
from modflow6_torch.utils import profiler

N = 24
# do_step's own: the explicit synchronisation after the solve, the CHD
# flows' mask selection, the budget's sums and the copy of the heads
STEP_READS = 4


def _sim(accel="cg", precision="f64", **kw):
    grid = DisGrid.create(1, N, N, 20000.0 / N, 20000.0 / N, 0.0,
                          np.full((1, N, N), -100.0))
    k = np.exp(np.random.default_rng(9001).normal(5.0, 1.23, N * N))
    mid = (N - 1) // 2
    flow = build_gwf(
        "flow", grid, k=k, k33=k, strt=40.0,
        storage={"ss": 1e-4, "sy": 0.0, "iconvert": 0},
        chd=[(r * N, 48.0) for r in range(N)]
        + [(r * N + N - 1, 40.0) for r in range(N)],
        wel=[(mid * N + mid, -1000.0)], device="cpu")
    tdis = Tdis([StressPeriod(1000.0, 3, 1.5)])
    ims = ImsSettings(outer_dvclose=1e-6, outer_maximum=100,
                      inner_maximum=300, inner_dvclose=1e-6,
                      inner_rclose=0.01, linear_acceleration=accel,
                      precision=precision)
    return Simulation(tdis, flow, ims, transient=[True], **kw)


def _steps(sim, n=2):
    """Run ``n`` steps; the records of the steps after the first."""
    head, totim = sim.model.strt, 0.0
    for kstp, delt in enumerate(sim.tdis.periods[0].step_lengths()[:n], 1):
        totim += delt
        head = sim.do_step(head, 1, kstp, delt, totim, totim)
    return sim.records[1:]


@pytest.mark.parametrize("accel,precision", [
    ("cg", "f64"), ("bicgstab", "f64"), ("cg", "mixed")])
def test_host_syncs_of_a_step(accel, precision):
    profiler.take()
    (rec,) = _steps(_sim(accel, precision))
    krylov = [s for s in rec.spans if s.name == "krylov"]
    assert len(krylov) == rec.outer and rec.outer > 0
    assert sum(s.iters for s in krylov) == rec.inner > 0
    # one exit-flag read an inner iteration, and one a refinement pass
    reads = sum(s.reads for s in krylov)
    if precision == "f64":
        assert reads == rec.inner
    else:
        assert rec.outer <= reads - rec.inner <= 8 * rec.outer
    assert rec.counters["host_syncs"] == reads + rec.outer + STEP_READS
    assert rec.counters["explicit_syncs"] == 1
    assert rec.counters["launches"] == {}       # CPU tensors: no kernel


def test_spans_nest_in_the_step():
    (rec,) = _steps(_sim())
    by_id = {s.id: s for s in rec.spans}
    names = [s.name for s in rec.spans]
    assert names[:2] == ["step", "solve"] and names[-1] == "output"
    (step,) = [s for s in rec.spans if s.name == "step"]
    assert step.parent is None
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s is step:
            continue
        parent = by_id[s.parent]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    parents = {"solve": "step", "output": "step", "outer": "solve",
               "assemble": "outer", "precond": "outer", "krylov": "outer"}
    for s in rec.spans:
        if s is not step:
            assert by_id[s.parent].name == parents[s.name]
    outers = [s for s in rec.spans if s.name == "outer"]
    assert len(outers) == rec.outer
    for o in outers:
        inside = sorted(s.name for s in rec.spans if s.parent == o.id)
        assert inside == ["assemble", "krylov", "precond"]
    krylov = [s for s in rec.spans if s.name == "krylov"]
    assert all(0 < s.wait_ns <= s.end_ns - s.start_ns for s in krylov)
    # nothing is kept beyond the step
    assert profiler.take()[0] == []


def test_record_seconds_are_the_spans():
    (rec,) = _steps(_sim())
    (solve,) = [s for s in rec.spans if s.name == "solve"]
    (output,) = [s for s in rec.spans if s.name == "output"]
    assert rec.output_seconds == output.seconds > 0
    assert rec.solve_seconds == solve.seconds > 0


def test_profiler_sees_the_spans():
    from torch.profiler import ProfilerActivity, profile
    sim = _sim()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(sim, n=1)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    for name in ("step", "solve", "outer", "assemble", "precond", "krylov",
                 "output"):
        assert "mf6::" + name in names
    assert names.count("mf6::krylov_iter") == sim.records[0].inner > 0


def test_no_range_outside_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a range entered outside a profiler")
    monkeypatch.setattr(profiler, "_range", refuse)
    (rec,) = _steps(_sim())
    assert rec.inner > 0


def _listing_rows(lst):
    text = lst.read_text()
    body = text[text.index("Profiler timings"):text.index("Top hotspots")]
    return body.splitlines()[1:]


def _exact_syncs(rec):
    """``rec``'s host reads of a confined f64 CG step: one an inner, one
    an outer, and the step's own."""
    return rec.inner + rec.outer + STEP_READS


def test_a_record_holds_its_own_step_alone(tmp_path):
    # a solve outside any step leaves its spans and reads behind; the
    # next step's record and the listing take none of them
    sim = _sim(lst_path=str(tmp_path / "sim.lst"), profile="summary")
    make_fused_run(sim.model, sim.solution.s, iss=False,
                   nsteps=1)(sim.model.strt, [1.0])
    sim.run()
    first = sim.records[0]
    assert first.spans[0].name == "step" and first.spans[0].parent is None
    assert first.counters["host_syncs"] == _exact_syncs(first)
    assert first.counters["explicit_syncs"] == 1
    rows = _listing_rows(tmp_path / "sim.lst")
    assert [r.split()[0] for r in rows[:2]] == ["step", "solve"]
    assert rows[0].endswith("(n=3)") and rows[1].endswith("(n=3)")
    assert [r.split()[0] for r in rows if r[2] != " "] == ["step"]


def test_an_adaptive_step_holds_its_attempts(tmp_path):
    sim = _sim(lst_path=str(tmp_path / "sim.lst"), profile="summary")
    sim.ats[1] = AtsPeriod(dt0=400.0, dtmin=1.0, dtmax=1000.0)
    sim.run()
    assert len(sim.records) >= 2
    for rec in sim.records:
        roots = [s for s in rec.spans if s.parent is None]
        assert [s.name for s in roots] == ["step"]
        (step,) = roots
        solves = [s for s in rec.spans if s.name == "solve"]
        assert len(solves) == 2 and all(s.parent == step.id
                                        for s in solves)
        assert rec.solve_seconds == sum(s.seconds for s in solves) > 0
        # both solve spans end with a synchronisation
        assert rec.counters["explicit_syncs"] == 2
        assert rec.counters["host_syncs"] == _exact_syncs(rec) + 1
    rows = _listing_rows(tmp_path / "sim.lst")
    assert rows[0].split()[0] == "step"
    assert rows[0].endswith(f"(n={len(sim.records)})")


def test_listing_shows_the_spans(tmp_path):
    lst = tmp_path / "sim.lst"
    sim = _sim(lst_path=str(lst), profile="summary")
    sim.run()
    text = lst.read_text()
    body = text[text.index("Profiler timings"):text.index("Top hotspots")]
    rows = {line.split()[0]: line for line in body.splitlines()[1:]}
    for name in ("step", "solve", "outer", "assemble", "precond", "krylov",
                 "output"):
        assert name in rows
    assert rows["step"].endswith("(n=3)") and rows["output"].endswith("(n=3)")
    outer = sum(r.outer for r in sim.records)
    for name in ("outer", "assemble", "precond", "krylov"):
        assert rows[name].endswith(f"(n={outer})")
