"""The coupled cell ``henry-buy-mg-replay`` at a true small section (24
layers x 1 row x 48 columns) on the CPU: the source's schedule and values,
the same work on every seed, the control and the planted faults fail it,
the per-layer readers, and a program whose multigrid does not coarsen a
section stops the run before any solve."""

import pytest
import torch

from perfbench import run
from perfbench.control import with_mixed
from perfbench.inputs import schedule
from perfbench.section import section_inputs
from perfbench.tests.test_perfbench_cells import (_altered, _bad_start,
                                                  _unchanged)

WORKLOAD = "henry-buy-mg-replay"
NEW_READERS = ("mg_levels", "mg_apply_ms", "transport_inner_per_step",
               "gwt_assembly_ms_per_outer", "transport_share")


def _config(bench, nlay=24, ncol=48):
    cfg = bench.config(bench.workload(WORKLOAD)["config"])
    cfg.update(nlay=nlay, ncol=ncol)
    return cfg


def run_section(seed=2**31 + 77, trace=False, bench=None, **kw):
    bench = bench or run.Bench()
    return run.run_cell(bench, WORKLOAD, seed, 0.2, trace,
                        torch.device("cpu"), config=_config(bench), **kw)


def test_schedule_and_values_are_the_sources():
    """One period of 0.5 d in 500 steps; the cell replays steps 1-10 of
    0.001 d; the inflow of case a and b spread over the first column's
    layers, the sea on the last column."""
    bench = run.Bench()
    cfg = bench.config(bench.workload(WORKLOAD)["config"])
    steps = schedule(cfg["tdis"], cfg["steady"])
    assert len(steps) == 500 and all(s[3] for s in steps)
    assert steps[0] == (1, 1, 0.001, True)
    assert abs(sum(s[2] for s in steps) - 0.5) < 1e-12
    assert bench.traffic(WORKLOAD)["steps"] == [1, 10]
    small = _config(bench)
    for case, inflow in (("a", 5.7024), ("b", 2.851)):
        inp = section_inputs(small, case)
        assert inp.shape == (24, 1, 48)
        assert abs(inp.wel_q.sum() - inflow) < 1e-12
        assert list(inp.wel_node) == [k * 48 for k in range(24)]
        assert list(inp.chd_node) == [k * 48 + 47 for k in range(24)]
        assert inp.botm[-1] == 0.0 and inp.top[0] == 1.0


@pytest.mark.parametrize("trace", [False, True])
def test_section_runs_and_agrees(trace):
    res = run_section(trace=trace)
    assert res["correct"], res["compared"]
    assert res["attempted"] % 20 == 0 and res["failed"] == 0
    assert set(res["compared"]) == {"head_gap_m", "conc_gap",
                                    "start_residual"}
    got = {k: v["value"] for k, v in res["metrics"].items()}
    if not trace:
        assert set(got) == {"cell_steps_per_s", "setup_s"}
        return
    # 24 x 48 coarsens once, to 12 x 24
    assert got["mg_levels"] == 2.0
    assert got["mg_apply_ms"] > 0 and got["gwt_assembly_ms_per_outer"] > 0
    assert got["buy_flow_inner_per_step"] > 0
    assert got["transport_inner_per_step"] > 0
    assert 0 < got["transport_share"] < 1


@pytest.mark.parametrize("seed", [2**31 + 21, 2**33 + 5])
def test_work_is_the_same_for_every_seed(seed):
    ref = run_section()
    res = run_section(seed=seed)
    for r in (ref, res):
        assert len(r["work"]["replay_s"]) % 2 == 0
    assert res["work"]["inner"] == ref["work"]["inner"]
    assert res["work"]["outer"] == ref["work"]["outer"]


@pytest.mark.parametrize("fault", [None, _unchanged, _altered, _bad_start],
                         ids=["control", "unchanged", "altered", "bad_start"])
def test_control_and_faults_fail(fault):
    """The program's mixed-precision flow in the place of f64, and the
    planted faults of the generic cell tests."""
    if fault is None:
        res = run_section(bench=with_mixed(run.Bench()))
    else:
        res = run_section(wrap_cell=fault)
    assert not res["correct"], res["compared"]


def test_no_section_multigrid_no_run(monkeypatch):
    """A program whose multigrid builds one level on a one-row section
    (as before it viewed sections over layer and column) stops the run
    in set-up, before any solve."""
    from modflow6_torch.ops.solvers import mg
    from modflow6_torch.solution.ims import NumericalSolution
    monkeypatch.setattr(mg, "section_view", lambda shape: None)

    def refuse(*args, **kwargs):
        raise AssertionError("a solve ran")
    monkeypatch.setattr(NumericalSolution, "solve_timestep", refuse)
    with pytest.raises(SystemExit, match="1 level"):
        run_section()


def test_readers_read_nothing_without_spans():
    """Records without the program's spans and counts (a program from
    before them): the new readers give nothing, and do not raise."""
    bench = run.Bench()

    class Bare:
        outer, inner = 3, 40
        transport_outer, transport_inner = 2, 90

    ctx = dict(steps=[(0.1, True, Bare())])
    for name in NEW_READERS:
        assert bench.reader(name).read(ctx) is None, name
    assert bench.reader("buy_flow_inner_per_step").read(ctx) == 40
