"""Time series, time-array series and adaptive time stepping of the port
(modflow6_torch/utils/timeseries.py, timing/ats.py, the loader's TS6 and
TAS6 wiring and ``Simulation``'s step hooks and ATS loop) against the
reference (modflow6_tpu/utils/timeseries.py, timing/ats.py, its loader and
``Simulation``).

Tolerances:

- series and time-array series step values: bitwise (the same float64
  operations in the same order);
- decks with series through both loaders: with CG equal (outer, inner)
  counts per step and heads within 1e-10; with BiCGSTAB heads within 10 ×
  OUTER_DVCLOSE (its iteration counts follow the sum order: ROADMAP Queue
  C);
- the ATS scenarios of tests/test_ats.py: accepted step lengths bitwise,
  equal retry counts, heads within 1e-10;
- ATS with UZF columns: a replay of the accepted step lengths as fixed
  steps gives the same counts and bitwise the same heads and water
  contents.
"""

import numpy as np
import pytest
import torch

from test_advanced_decks import _sim_files, write
from test_mf6io_multi import build_split_deck
from test_obs_tas_decks import _base_deck
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.simulation import Simulation as JaxSimulation
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.timing import ats as ref_ats
from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
from modflow6_tpu.timing.tdis import Tdis as JaxTdis
from modflow6_tpu.utils import timeseries as ref_ts
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf import uzf
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.gwt.builder import build_gwt
from modflow6_torch.models.simulation import Simulation
from modflow6_torch.solution import ImsSettings
from modflow6_torch.timing import ats
from modflow6_torch.timing.tdis import StressPeriod, Tdis
from modflow6_torch.utils import timeseries as ts
from modflow6_torch.utils.mf6io import load_simulation

HEAD_ATOL = 1e-10


def load(ws):
    return load_simulation(str(ws), device="cpu")


def counts(recs):
    return [(r.outer, r.inner) for r in recs]


def assert_heads(got, want, atol=HEAD_ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.totim == w.totim
        np.testing.assert_allclose(g.head, np.asarray(w.head), rtol=0,
                                   atol=atol)


# ------------------------------------------------------------ step values

def _intervals(rng, times):
    """Steps before, across, between and after the knots, and empty ones."""
    lo, hi = times[0] - 2.0, times[-1] + 2.0
    out = [(float(a), float(b)) for a, b in
           np.sort(rng.uniform(lo, hi, (40, 2)), axis=1)]
    out += [(float(times[1]), float(times[3])), (5.0, 5.0), (7.0, 3.0),
            (float(times[0]), float(times[-1]))]
    return out


@pytest.mark.parametrize("method", ["stepwise", "linear", "linearend"])
def test_series_step_values_are_the_reference_bitwise(method):
    rng = np.random.default_rng(3)
    times = np.cumsum(rng.uniform(0.3, 2.0, 9))
    values = rng.normal(0.0, 5.0, 9)
    got = ts.TimeSeries.create("q", times, values, method)
    want = ref_ts.TimeSeries.create("q", times, values, method)
    for t0, t1 in _intervals(rng, times):
        assert got.step_value(t0, t1) == want.step_value(t0, t1)
        assert got.value_at(t1) == want.value_at(t1)


@pytest.mark.parametrize("method", ["stepwise", "linear"])
def test_time_array_step_values_are_the_reference_bitwise(method):
    rng = np.random.default_rng(4)
    times = np.cumsum(rng.uniform(0.3, 2.0, 6))
    arrays = rng.normal(1e-3, 1e-3, (6, 4, 5))
    got = ts.TimeArraySeries.create("r", times, arrays, method, sfac=1.7,
                                    device="cpu")
    want = ref_ts.TimeArraySeries.create("r", times, arrays, method,
                                         sfac=1.7)
    assert got.arrays.shape == (6, 20) and got.arrays.dtype == torch.float64
    for t0, t1 in _intervals(rng, times):
        np.testing.assert_array_equal(
            got.step_value(t0, t1).numpy(),
            np.asarray(want.step_value(t0, t1)).reshape(-1))
    with pytest.raises(ValueError, match="LINEAR or STEPWISE"):
        ts.TimeArraySeries.create("r", times, arrays, "linearend",
                                  device="cpu")


def test_time_array_series_runs_on_the_card_unless_asked():
    """Without a CUDA device and without device="cpu" a time-array series
    raises; it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.TimeArraySeries.create("r", [0.0, 1.0], np.ones((2, 3)))


def test_ts6_and_tas6_files_load_as_the_reference(tmp_path):
    write(str(tmp_path), "a.ts", """
BEGIN ATTRIBUTES
  NAMES one two three
  METHODS stepwise linear linearend
  SFACS 1.0 2.5 -1.0
END ATTRIBUTES
BEGIN TIMESERIES
  0.0 1.0 2.0 3.0
  1.5 4.0 5.0 6.0
  4.0 7.0 8.0 9.5
END TIMESERIES
""")
    write(str(tmp_path), "a.tas", """
BEGIN ATTRIBUTES
  NAME rts
  METHOD STEPWISE
  SFAC 2.0
END ATTRIBUTES
BEGIN TIME 0.0
  INTERNAL
    1.0 2.0 3.0 4.0 5.0 6.0
END TIME
BEGIN TIME 3.0
  CONSTANT 0.5
END TIME
""")
    got = ts.load_ts6(str(tmp_path / "a.ts"))
    want = ref_ts.load_ts6(str(tmp_path / "a.ts"))
    assert sorted(got) == sorted(want) == ["ONE", "THREE", "TWO"]
    for name in got:
        for field in ("name", "method"):
            assert getattr(got[name], field) == getattr(want[name], field)
        np.testing.assert_array_equal(got[name].times, want[name].times)
        np.testing.assert_array_equal(got[name].values, want[name].values)
    gtas = ts.load_tas(str(tmp_path / "a.tas"), (2, 3), str(tmp_path),
                       device="cpu")
    wtas = ref_ts.load_tas(str(tmp_path / "a.tas"), (2, 3), str(tmp_path))
    assert (gtas.name, gtas.method, gtas.sfac) == (wtas.name, wtas.method,
                                                   wtas.sfac)
    np.testing.assert_array_equal(gtas.times, wtas.times)
    np.testing.assert_array_equal(gtas.arrays.numpy(),
                                  wtas.arrays.reshape(2, -1))


# ------------------------------------------------------------ decks

def _ts6_well_deck(ws):
    """tests/test_timeseries.py::test_ts6_per_entry_binding's deck."""
    _sim_files(ws, "  WEL6 model.wel wel-1", nper=1, perlen="4.0 4 1.0")
    write(ws, "model.wel", """
BEGIN OPTIONS
  TS6 FILEIN model.ts
END OPTIONS
BEGIN DIMENSIONS
  MAXBOUND 1
END DIMENSIONS
BEGIN PERIOD 1
  1 1 4 pumprate
END PERIOD
""")
    write(ws, "model.ts", """
BEGIN ATTRIBUTES
  NAME pumprate
  METHOD STEPWISE
END ATTRIBUTES
BEGIN TIMESERIES
  0.0 -10.0
  2.0 -40.0
  4.0 -40.0
END TIMESERIES
""")


def test_ts6_per_entry_binding(tmp_path):
    """The reference test's deck (BiCGSTAB) through both loaders: the well
    follows the series, the heads agree, and the bound rate at the end is
    the late rate.  The binding keeps the entries, so the package's sum
    plan is built once."""
    ws = str(tmp_path)
    _ts6_well_deck(ws)
    sim, ref = load(ws), ref_load(ws)
    recs, jrecs = sim.run(), ref.run()
    assert all(r.converged for r in recs)
    assert [r.outer for r in recs] == [r.outer for r in jrecs]
    assert_heads(recs, jrecs, atol=10 * 1e-8)
    h = [r.head[3] for r in recs]
    assert h[-1] < h[0] - 0.01
    wel = sim.period_packages(1).wel
    assert float(wel.q[0]) == float(np.asarray(
        ref.period_packages(1).wel.q)[0]) == -40.0
    plan = wel.__dict__["add_plan"]
    sim.step_hooks[0](1, 5, 1.0)
    assert sim.period_packages(1).wel.__dict__["add_plan"] is plan


def _ts_deck(ws):
    """Series in CHD heads, WEL rates and DRN elevations and conductances
    over two periods (CG): period 2 redefines WEL with another series and
    keeps DRN's, with steps that cross the knots."""
    _base_deck(ws, nper=2, perlen="10.0 3 1.5", extra_pkgs="  WEL6 model.wel"
               "\n  DRN6 model.drn")
    write(ws, "model.chd", """
BEGIN OPTIONS
  TS6 FILEIN model.ts
END OPTIONS
BEGIN DIMENSIONS
  MAXBOUND 1
END DIMENSIONS
BEGIN PERIOD 1
  1 1 1 west
END PERIOD
""")
    write(ws, "model.wel", """
BEGIN OPTIONS
  BOUNDNAMES
  TS6 FILEIN model.ts
END OPTIONS
BEGIN DIMENSIONS
  MAXBOUND 2
END DIMENSIONS
BEGIN PERIOD 1
  1 1 3 pump w1
  1 1 4 -2.0 w2
END PERIOD
BEGIN PERIOD 2
  1 1 4 late
  1 1 3 -1.0
END PERIOD
""")
    write(ws, "model.drn", """
BEGIN OPTIONS
  TS6 FILEIN model.ts
END OPTIONS
BEGIN DIMENSIONS
  MAXBOUND 1
END DIMENSIONS
BEGIN PERIOD 1
  1 1 5 stage 40.0
END PERIOD
""")
    write(ws, "model.ts", """
BEGIN ATTRIBUTES
  NAMES west pump late stage
  METHODS linear stepwise linearend linear
  SFACS 1.0 2.0 1.0 1.0
END ATTRIBUTES
BEGIN TIMESERIES
  0.0 10.0 -3.0 -1.0 9.0
  4.0 12.0 -6.0 -4.0 9.5
  11.0 11.0 -2.0 -8.0 8.0
  30.0 9.0 -5.0 -2.0 9.0
END TIMESERIES
""")


def test_series_deck_matches_reference(tmp_path):
    """CHD, WEL and DRN values given as series names, a WEL redefinition in
    period 2, through both loaders: equal counts, heads within 1e-10, and
    the same bound values in every period's package data."""
    ws = str(tmp_path)
    _ts_deck(ws)
    sim, ref = load(ws), ref_load(ws)
    recs, jrecs = sim.run(), ref.run()
    assert all(r.converged for r in recs) and len(recs) == 6
    assert counts(recs) == counts(jrecs)
    assert_heads(recs, jrecs)
    for kper, pd in sim.period_data.items():
        want = ref.period_data[kper]
        for pkg, fields in (("chd", ("head",)), ("wel", ("q",)),
                            ("drn", ("elev", "cond"))):
            for field in fields:
                np.testing.assert_array_equal(
                    getattr(getattr(pd, pkg), field).numpy(),
                    np.asarray(getattr(getattr(want, pkg), field)))


# ------------------------------------------------------------ ATS

def _ats_sims(outer_maximum=60, unconfined=False, perlen=100.0):
    """tests/test_ats.py's make_sim through both packages; ``unconfined``:
    the same row convertible, with a steeper gradient, whose Picard
    iterations grow with the step length."""
    n = 15
    settings = dict(outer_dvclose=1e-8, inner_dvclose=1e-10,
                    inner_rclose=1e-9, inner_maximum=500,
                    outer_maximum=outer_maximum)
    kw = dict(k=2.0, strt=6.0, storage={"ss": 1e-3, "iconvert": 0},
              chd=[(0, 9.0), (n - 1, 5.0)])
    if unconfined:
        kw = dict(kw, icelltype=1, chd=[(0, 9.0), (n - 1, 1.0)],
                  storage={"ss": 1e-3, "sy": 0.1, "iconvert": 1})
    botm = np.zeros((1, 1, n))
    ref = JaxSimulation(
        JaxTdis([JaxPeriod(perlen=perlen, nstp=5, tsmult=1.0)]),
        jax_build_gwf("m", JaxDisGrid.create(1, 1, n, 10.0, 10.0, 10.0,
                                             botm), **kw),
        JaxImsSettings(**settings))
    sim = Simulation(
        Tdis([StressPeriod(perlen=perlen, nstp=5, tsmult=1.0)]),
        build_gwf("m", DisGrid.create(1, 1, n, 10.0, 10.0, 10.0, botm),
                  device="cpu", **kw),
        ImsSettings(**settings))
    return sim, ref


def _spy(sim):
    """Count a Simulation's solve attempts and record its accepted steps'
    lengths."""
    attempts, delts = [], []
    solve, do = sim.solve_step, sim.do_step

    def solve_step(head, kper, kstp, delt):
        attempts.append(delt)
        return solve(head, kper, kstp, delt)

    def do_step(head, kper, kstp, delt, *args, **kwargs):
        delts.append(delt)
        return do(head, kper, kstp, delt, *args, **kwargs)

    sim.solve_step, sim.do_step = solve_step, do_step
    return attempts, delts


ATS_SCENARIOS = {
    # test_ats_covers_period_exactly
    "growth": (60, dict(dt0=5.0, dtmin=0.5, dtmax=30.0, dtadj=2.0)),
    # test_ats_failed_step_retry
    "retry": (2, dict(dt0=100.0, dtmin=1e-3, dtmax=100.0, dtadj=1.0,
                      dtfailadj=10.0)),
    # test_ats_respects_dtmin_truncation
    "truncation": (60, dict(dt0=40.0, dtmin=1.0, dtmax=40.0, dtadj=1.0)),
    # the unconfined row: a step of 5 fails within 7 outers, one of 1.25
    # does not
    "unconfined-retry": (7, dict(dt0=5.0, dtmin=0.1, dtmax=5.0,
                                 dtadj=1.0, dtfailadj=4.0)),
}


@pytest.mark.parametrize("case", sorted(ATS_SCENARIOS))
def test_ats_scenarios_match_reference(case):
    """The three scenarios of tests/test_ats.py and an unconfined one with
    retries through both Simulations: the accepted step lengths bitwise
    equal, equal attempts and retries, equal counts, heads within 1e-10,
    the period covered."""
    outer_maximum, period = ATS_SCENARIOS[case]
    unconfined = case == "unconfined-retry"
    perlen = 5.0 if unconfined else 100.0
    sim, ref = _ats_sims(outer_maximum, unconfined, perlen)
    sim.ats[1] = ats.AtsPeriod(**period)
    ref.ats[1] = ref_ats.AtsPeriod(**period)
    (attempts, delts), (jattempts, jdelts) = _spy(sim), _spy(ref)
    recs, jrecs = sim.run(), ref.run()
    assert all(r.converged for r in recs)
    assert delts == jdelts and attempts == jattempts
    assert sum(r.retries for r in recs) == len(attempts) - len(delts)
    assert counts(recs) == counts(jrecs)
    assert_heads(recs, jrecs)
    np.testing.assert_allclose(recs[-1].totim, perlen, rtol=1e-12)
    if unconfined:
        assert recs[0].retries > 0
    if case == "truncation":
        np.testing.assert_allclose(delts, [40.0, 40.0, 20.0], rtol=1e-12)


def test_ats_functions_are_the_reference():
    a = ats.AtsPeriod(dt0=0.0, dtmin=0.5, dtmax=30.0, dtadj=2.0,
                      dtfailadj=3.0)
    r = ref_ats.AtsPeriod(dt0=0.0, dtmin=0.5, dtmax=30.0, dtadj=2.0,
                          dtfailadj=3.0)
    assert ats.initial_delt(a) == ref_ats.initial_delt(r) == 0.5
    for delt in (0.1, 0.7, 5.0, 29.0, 45.0):
        assert ats.fail_delt(delt, a) == ref_ats.fail_delt(delt, r)
        for outer in (1, 5, 10, 20, 29, 30):
            assert ats.next_delt(delt, a, outer, 30) == \
                ref_ats.next_delt(delt, r, outer, 30)


def _uzf_sim(periods):
    """A mound under two UZF columns (tests/test_uzf.py's seepage case
    widened) with a low outer maximum, so that long steps fail."""
    grid = DisGrid.create(1, 1, 5, 10.0, 10.0, 12.0, np.zeros((1, 1, 5)))
    model = build_gwf("u", grid, device="cpu", k=0.02, icelltype=1,
                      strt=[5.0, 9.0, 9.5, 9.8, 9.9],
                      storage={"ss": 1e-4, "sy": 0.1, "iconvert": 1},
                      chd=[(0, 5.0)])
    sim = Simulation(Tdis([StressPeriod(*p) for p in periods]), model,
                     ImsSettings(outer_dvclose=1e-8, inner_dvclose=1e-10,
                                 inner_rclose=1e-9, inner_maximum=500,
                                 outer_maximum=4))
    cols = {k: np.asarray(v, np.float64) for k, v in dict(
        node=[3, 4], vks=[0.5, 0.4], thtr=[0.05, 0.05], thts=[0.35, 0.3],
        thti=[0.05, 0.1], eps=[3.5, 4.0], celtop=[10.0, 10.0],
        celbot=[8.0, 8.0], surfdep=[0.2, 0.3], area=[100.0, 100.0],
        finf=[0.05, 0.08], pet=[0.0, 0.0], extdp=[1.0, 1.0],
        extwc=[0.1, 0.1]).items()}
    cols["node"] = cols["node"].astype(np.int64)
    sim.uzf = uzf.make_uzf(cols, device="cpu", nz=10, iseepflag=1)
    steps = []      # (delt, committed water content) of each step
    do = sim.do_step

    def do_step(head, kper, kstp, delt, *args, **kwargs):
        out = do(head, kper, kstp, delt, *args, **kwargs)
        steps.append((delt, sim.uzf_theta.clone()))
        return out

    sim.do_step = do_step
    return sim, steps


def test_ats_with_uzf_failed_attempts_leave_no_trace():
    """ATS over UZF columns with retries: the accepted step lengths,
    replayed as fixed steps of the same model, give the same counts and
    bitwise the same heads and water contents, so a failed attempt
    committed no column state."""
    sim, steps = _uzf_sim([(6.25, 1, 1.0)])
    sim.ats[1] = ats.AtsPeriod(dt0=6.25, dtmin=0.1, dtmax=6.25, dtadj=1.0,
                               dtfailadj=4.0)
    recs = sim.run()
    assert all(r.converged for r in recs)
    assert recs[0].retries > 0 and len(recs) == 4
    np.testing.assert_allclose(recs[-1].totim, 6.25, rtol=1e-12)
    replay, rsteps = _uzf_sim([(6.25, 1, 1.0)])
    head, pertim = replay.model.strt, 0.0
    for kstp, (delt, _) in enumerate(steps, start=1):
        pertim += delt
        head = replay.do_step(head, 1, kstp, delt, pertim, pertim)
    rrecs = replay.records
    assert counts(rrecs) == counts(recs)
    assert [r.uzf_resolves for r in rrecs] == [r.uzf_resolves for r in recs]
    for a, b in zip(recs, rrecs):
        np.testing.assert_array_equal(a.head, b.head)
    assert [d for d, _ in rsteps] == [d for d, _ in steps]
    for (_, a), (_, b) in zip(steps, rsteps):
        assert torch.equal(a, b)


def test_ats_percel_raises():
    """ADV ATS_PERCEL, which raised until the GWT transport was ported: an
    adaptive period's steps are cut to the transport's Courant step on the
    last flow fields (adv_dt); the accepted step lengths equal the
    reference's, and the limit binds."""
    from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
    from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
    from modflow6_tpu.models.gwt.builder import build_gwt as jax_build_gwt
    from modflow6_tpu.models.simulation import Simulation as JaxSimulation
    from modflow6_tpu.solution import ImsSettings as JaxImsSettings
    from modflow6_tpu.timing.ats import AtsPeriod as JaxAts
    from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
    from modflow6_tpu.timing.tdis import Tdis as JaxTdis
    n = 15
    grid = dict(nlay=1, nrow=1, ncol=n, delr=10.0, delc=10.0, top=10.0,
                botm=np.zeros((1, 1, n)))
    fkw = dict(k=20.0, strt=6.0, storage={"ss": 1e-3, "iconvert": 0},
               chd=[(0, 9.0), (n - 1, 5.0)])
    tkw = dict(porosity=0.3, strt=0.0, cnc=[(0, 1.0)])
    flow = dict(outer_dvclose=1e-8, inner_dvclose=1e-10, inner_rclose=1e-9,
                inner_maximum=500)
    trans = dict(outer_dvclose=1e-6, inner_dvclose=1e-8, inner_rclose=1e-6,
                 inner_maximum=500, linear_acceleration="bicgstab")
    ats_kw = dict(dt0=2.0, dtmin=0.01, dtmax=50.0, dtadj=2.0, dtfailadj=5.0)
    delts = {}
    for pkg in ("port", "ref"):
        if pkg == "port":
            sim = Simulation(
                Tdis((StressPeriod(30.0, 1, 1.0),)),
                build_gwf("m", DisGrid.create(**grid), device="cpu", **fkw),
                ImsSettings(**flow),
                gwt=build_gwt("t", DisGrid.create(**grid), device="cpu",
                              **tkw), gwt_settings=ImsSettings(**trans))
            sim.ats = {1: ats.AtsPeriod(**ats_kw)}
        else:
            sim = JaxSimulation(
                JaxTdis((JaxPeriod(30.0, 1, 1.0),)),
                jax_build_gwf("m", JaxDisGrid.create(**grid), **fkw),
                JaxImsSettings(**flow),
                gwt=jax_build_gwt("t", JaxDisGrid.create(**grid), **tkw),
                gwt_settings=JaxImsSettings(**trans))
            sim.ats = {1: JaxAts(**ats_kw)}
        sim.ats_percel = 0.5
        recs = sim.run()
        t = [0.0] + [r.totim for r in recs]
        delts[pkg] = np.diff(t)
    np.testing.assert_allclose(delts["port"], delts["ref"], rtol=1e-12)
    # the Courant limit, far below dtmax, sets the steps after the first
    assert len(delts["port"]) > 8
    assert delts["port"][1:-1].max() < 0.1 * ats_kw["dtmax"]


# ------------------------------------------------------------ R7, R8

def _two_well_files(ws):
    """Two WEL6 files: the second's rate is a series name (R7)."""
    _sim_files(ws, "  WEL6 a.wel wel-1\n  WEL6 b.wel wel-2", nper=1,
               perlen="4.0 2 1.0")
    write(ws, "a.wel", """
BEGIN DIMENSIONS
  MAXBOUND 1
END DIMENSIONS
BEGIN PERIOD 1
  1 1 3 -5.0
END PERIOD
""")
    write(ws, "b.wel", """
BEGIN OPTIONS
  TS6 FILEIN b.ts
END OPTIONS
BEGIN DIMENSIONS
  MAXBOUND 1
END DIMENSIONS
BEGIN PERIOD 1
  1 1 6 pump
END PERIOD
""")
    write(ws, "b.ts", """
BEGIN ATTRIBUTES
  NAME pump
  METHOD STEPWISE
END ATTRIBUTES
BEGIN TIMESERIES
  0.0 -20.0
  10.0 -20.0
END TIMESERIES
""")


def test_r7_series_in_a_second_file_is_refused(tmp_path):
    """R7: the reference binds the second file's series to its own row 0,
    which after the merge is the first file's well: that well takes the
    series' rate and the named well stays at 0.0.  The port refuses."""
    ws = str(tmp_path)
    _two_well_files(ws)
    ref = ref_load(ws)
    for hook in ref.step_hooks:
        hook(1, 1, 2.0)
    np.testing.assert_array_equal(np.asarray(ref.period_data[1].wel.q),
                                  [-20.0, 0.0])
    with pytest.raises(NotImplementedError, match="R7"):
        load(ws)


def test_r8_series_in_a_merged_model_is_refused(tmp_path):
    """R8: with several models the reference attaches no series binding,
    so the named CHD head stays at its 0.0 placeholder.  The port
    refuses."""
    ws = str(tmp_path)
    build_split_deck(ws, 3, 6)
    write(ws, "west.chd", """
BEGIN OPTIONS
  TS6 FILEIN west.ts
END OPTIONS
BEGIN DIMENSIONS
  MAXBOUND 3
END DIMENSIONS
BEGIN PERIOD 1
  1 1 1 10.0
  1 2 1 upstream
  1 3 1 10.0
END PERIOD
""")
    write(ws, "west.ts", """
BEGIN ATTRIBUTES
  NAME upstream
END ATTRIBUTES
BEGIN TIMESERIES
  0.0 12.0
  10.0 12.0
END TIMESERIES
""")
    ref = ref_load(ws)
    assert ref.step_hooks == []
    np.testing.assert_array_equal(np.asarray(ref.period_data[1].chd.head)[:3],
                                  [10.0, 0.0, 10.0])
    with pytest.raises(NotImplementedError, match="R8"):
        load(ws)
