"""PRT particle tracking in the port (modflow6_torch/models/prt: the track
file, Pollock on DIS, the ternary method on DISV, PrtModel, PrtDriver)
against the reference (modflow6_tpu/models/prt).

Bars: the cell flows and the fan's fluxes bitwise or within 1e-12; the
scenarios of tests/test_prt.py and tests/test_prt_disv.py at those tests'
own tolerances (rtol 1e-12 / 1e-10 / 1e-9), with statuses equal; a swarm
on a lognormal-K model against the reference's vmapped tracker (positions
and times within 1e-9 relative, statuses, cells and transition counts
equal); the batch loop equal to single-particle runs bitwise; the builders
(``build_fan``, ``locate``) equal to the reference's loops.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.discretization.disv import DisvGrid as JaxDisvGrid
from modflow6_tpu.models.gwf import npf as jnpf
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.prt import tracking as jtracking
from modflow6_tpu.models.prt import trackfile as jtf
from modflow6_tpu.models.prt.model import PrtModel as JaxPrtModel
from modflow6_tpu.models.prt.model import ReleasePoints as JaxPoints
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxSolution
from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
from modflow6_tpu.timing.tdis import Tdis as JaxTdis
from modflow6_torch.models.discretization import DisGrid, DisvGrid
from modflow6_torch.models.gwf import npf
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.prt import tracking
from modflow6_torch.models.prt import trackfile as tf
from modflow6_torch.models.prt.model import PrtModel, ReleasePoints
from modflow6_torch.models.prt.simulation import PrtDriver
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.ims import NumericalSolution
from modflow6_torch.timing.tdis import StressPeriod, Tdis

FLOW = dict(outer_dvclose=1e-10, outer_maximum=50, inner_dvclose=1e-12,
            inner_rclose=1e-10, inner_maximum=2000)


def _grids(kind, *args, **kw):
    if kind == "dis":
        return DisGrid.create(*args, **kw), JaxDisGrid.create(*args, **kw)
    return DisvGrid.create(*args, **kw), JaxDisvGrid.create(*args, **kw)


def flow_pair(grid_args, kind="dis", **model):
    """The same steady flow solved by both packages: (port model, head,
    aux), (reference model, head, aux)."""
    tg, jg = _grids(kind, *grid_args)
    tm = build_gwf("f", tg, device="cpu", **model)
    jm = jax_build_gwf("f", jg, **model)
    th, ti, ta = NumericalSolution(tm, ImsSettings(**FLOW)).solve_timestep(
        tm.strt, 1.0, iss=True)
    jh, ji, ja = JaxSolution(jm, JaxImsSettings(**FLOW)).solve_timestep(
        jm.strt, 1.0, iss=True)
    assert ti.converged and ji.converged
    return (tg, tm, th, ta), (jg, jm, jh, ja)


def uniform_x(ncol=20, nrow=1, q=0.5, k=10.0):
    """tests/test_prt.py:make_uniform_x's flow."""
    dh = q * (ncol - 1) / k
    chd = [(r * ncol, 10.0 + dh) for r in range(nrow)] \
        + [(r * ncol + ncol - 1, 10.0) for r in range(nrow)]
    return flow_pair((1, nrow, ncol, 1.0, 1.0, 1.0,
                      np.zeros((1, nrow, ncol))), k=k, strt=10.0, chd=chd)


def lognormal_pair(nlay=2, nrow=24, ncol=30, seed=5, **extra):
    """A lognormal-K model with a pumping well, recharge and CHD columns."""
    rng = np.random.default_rng(seed)
    k = np.exp(rng.normal(0.0, 0.8, nlay * nrow * ncol))
    chd = ([(r * ncol, 12.0) for r in range(nrow)]
           + [(r * ncol + ncol - 1, 10.0) for r in range(nrow)])
    botm = np.stack([np.full((nrow, ncol), -10.0 * (i + 1))
                     for i in range(nlay)])
    return flow_pair((nlay, nrow, ncol, 10.0, 10.0, 0.0, botm), k=k,
                     strt=11.0, chd=chd,
                     wel=[((nlay - 1) * nrow * ncol + (nrow // 2) * ncol
                           + ncol // 2, -30.0)],
                     rch=[(i, 1e-3) for i in range(nrow * ncol)], **extra)


@pytest.fixture(scope="module")
def uniform20():
    return uniform_x()


@pytest.fixture(scope="module")
def lognormal():
    return lognormal_pair(nrow=10, ncol=12)


def port_step(tm, th, ta, theta, pts, tmax):
    prt = PrtModel("p", tm.grid, np.full(tm.nodes, theta),
                   ReleasePoints(*(np.asarray(p, float) for p in pts)))
    return prt.make_step(tm)(th, ta["ibound"], ta["cond"],
                             *prt.initial_state("cpu"), tmax)


def ref_step(jg, jm, jh, ja, theta, pts, tmax):
    prt = JaxPrtModel("p", jg, np.full(jg.nodes, theta),
                      JaxPoints(*(np.asarray(p, float) for p in pts)))
    return prt.make_step(jm)(jh, ja["ibound"], ja["cond"],
                             *prt.initial_state(), tmax)


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ------------------------------------------------------------ cell flows

@pytest.mark.parametrize("case", ["lognormal", "general"])
def test_cell_flows_match_reference(case, lognormal):
    """The structured path's planes bitwise; the general path's ELL sums
    (a DIS grid with rotated anisotropy) within 1e-12."""
    port, ref = (lognormal if case == "lognormal" else lognormal_pair(
        nrow=8, ncol=9, angle1=np.full(2 * 8 * 9, 0.3)))
    tg, tm = port[:2]
    jg, jm, jh, ja = ref
    assert tm.use_structured == (case != "general")
    # the reference's heads through the port's conductances and flows
    th = torch.as_tensor(np.asarray(jh))
    ib = torch.as_tensor(np.asarray(ja["ibound"]))
    sat = npf.compute_saturation(tm.npf_opts, tm.npf_arrays, th, ib)
    got = tracking.build_cell_flows(tm, th, ib, tm.edge_conductances(th, ib),
                                    np.full(tg.nodes, 0.3), sat)
    q_edge = jnpf.flowja(jm.dtopo, ja["cond"], jh)
    jsat = jnpf.compute_saturation(jm.npf_opts, jm.npf_arrays, jh,
                                   ja["ibound"])
    want = jtracking.build_cell_flows(jm.topo, jg, q_edge,
                                      np.full(jg.nodes, 0.3), jsat)
    for name in ("qleft", "qright", "qfront", "qback", "qtop", "qbot",
                 "sat", "porosity"):
        w = np.asarray(getattr(want, name)).reshape(-1)
        g = _np(getattr(got, name))
        if case == "general":
            np.testing.assert_allclose(g, w, rtol=1e-12,
                                       atol=1e-12 * np.abs(w).max())
        else:
            np.testing.assert_array_equal(g, w)


# ----------------------------------------- the scenarios of test_prt.py

def test_uniform_flow_exact_position(uniform20):
    theta = 0.25
    (tg, tm, th, ta), ref = uniform20
    pts = ([2.5], [0.5], [0.5])
    out = port_step(tm, th, ta, theta, pts, 4.0)
    jout = ref_step(*ref, theta, pts, 4.0)
    v = 0.5 / theta
    np.testing.assert_allclose(_np(out["x"]), 2.5 + v * 4.0, rtol=1e-12)
    np.testing.assert_allclose(_np(out["y"]), 0.5, atol=1e-12)
    assert int(out["status"][0]) == int(jout["status"][0]) \
        == tracking.TERM_TIMEOUT
    np.testing.assert_allclose(_np(out["time"]), 4.0, rtol=1e-12)
    np.testing.assert_allclose(_np(out["x"]), _np(jout["x"]), rtol=1e-12)


def test_travel_time_to_boundary(uniform20):
    theta, ncol = 0.25, 20
    (tg, tm, th, ta), ref = uniform20
    pts = ([0.5], [0.5], [0.5])
    out = port_step(tm, th, ta, theta, pts, 1e9)
    jout = ref_step(*ref, theta, pts, 1e9)
    v = 0.5 / theta
    t_cell0 = np.log(2.0) / v
    np.testing.assert_allclose(_np(out["time"]), t_cell0 + (ncol - 2) / v,
                               rtol=1e-10)
    np.testing.assert_allclose(_np(out["time"]), _np(jout["time"]),
                               rtol=1e-10)
    assert int(out["status"][0]) == int(jout["status"][0]) \
        == tracking.TERM_WEAK
    assert int(out["transitions"][0]) == int(jout["transitions"][0])
    np.testing.assert_allclose(_np(out["x"]), ncol - 1, rtol=1e-12)


def test_swarm_many_particles_vectorized():
    theta = 0.3
    (tg, tm, th, ta), ref = uniform_x(ncol=40, nrow=5)
    rng = np.random.default_rng(7)
    x0 = rng.uniform(1.5, 5.0, 256)
    y0 = rng.uniform(0.1, 4.9, 256)
    pts = (x0, y0, np.full(256, 0.5))
    out = port_step(tm, th, ta, theta, pts, 3.0)
    jout = ref_step(*ref, theta, pts, 3.0)
    v = 0.5 / theta
    np.testing.assert_allclose(_np(out["x"]), x0 + v * 3.0, rtol=1e-9)
    np.testing.assert_allclose(_np(out["y"]), y0, atol=1e-9)
    np.testing.assert_array_equal(_np(out["status"]), _np(jout["status"]))
    np.testing.assert_allclose(_np(out["x"]), _np(jout["x"]), rtol=1e-12)


def _one_cell(qleft, qright, qfront, qback, delr):
    def f(v):
        return torch.full((1,), float(v), dtype=torch.float64)

    flows = tracking.CellFlows(
        qleft=f(qleft), qright=f(qright), qfront=f(qfront), qback=f(qback),
        qtop=f(0.0), qbot=f(0.0), porosity=f(1.0), sat=f(1.0),
        active_cell=torch.ones(1, dtype=torch.bool), shape=(1, 1, 1),
        delr=torch.tensor([delr], dtype=torch.float64),
        delc=torch.tensor([1.0], dtype=torch.float64))
    return tracking.make_tracker(flows, f(1.0), f(0.0))


def _jax_one_cell(qleft, qright, qfront, qback, delr):
    def f(v):
        return jnp.full((1, 1, 1), v)

    return jtracking.make_tracker(jtracking.CellFlows(
        qleft=f(qleft), qright=f(qright), qfront=f(qfront), qback=f(qback),
        qtop=f(0.0), qbot=f(0.0), porosity=f(1.0), sat=f(1.0),
        active_cell=jnp.ones((1, 1, 1), bool), shape=(1, 1, 1),
        delr=(delr,), delc=(1.0,)))


@pytest.mark.parametrize("case", ["linear", "weak sink"])
def test_one_cell_fields(case):
    """test_pollock_exit_time_linear_field and test_weak_sink_termination
    through both trackers."""
    faces = ((0.1, 0.4, 0.0, 0.0, 2.0) if case == "linear"
             else (0.2, -0.2, 0.1, -0.1, 1.0))
    x0 = 0.0 if case == "linear" else 0.3
    z = torch.zeros(1, dtype=torch.int64)
    out = _one_cell(*faces)(torch.tensor([x0], dtype=torch.float64),
                            torch.tensor([0.5], dtype=torch.float64),
                            torch.tensor([0.5], dtype=torch.float64),
                            z, z, z, 1e9)
    zi = jnp.array([0], jnp.int32)
    jout = _jax_one_cell(*faces)(jnp.array([x0]), jnp.array([0.5]),
                                 jnp.array([0.5]), zi, zi, zi,
                                 jnp.ones((1, 1, 1)), jnp.zeros((1, 1, 1)),
                                 1e9)
    assert int(out["status"][0]) == int(jout["status"][0])
    if case == "linear":
        np.testing.assert_allclose(_np(out["time"]), np.log(4.0) / 0.15,
                                   rtol=1e-12)
        assert int(out["status"][0]) == tracking.TERM_BOUNDARY
    else:
        assert int(out["status"][0]) == tracking.TERM_WEAK


def test_track_file_bytes_match_reference(tmp_path):
    """The binary and CSV track files byte for byte the reference's."""
    kw = dict(kper=1, kstp=2, irpt=np.array([1, 2]), ilay=np.array([1, 1]),
              icell=np.array([5, 9]), istatus=np.array([0, 1]),
              ireason=tf.REASON_TIMESTEP, trelease=np.array([0.0, 0.5]),
              t=np.array([3.5, 3.5]), x=np.array([1.25, 2.5]),
              y=np.array([0.5, 0.75]), z=np.array([0.5, 0.25]), name="pt")
    for csv in (False, True):
        paths = []
        for mod, tag in ((tf, "port"), (jtf, "ref")):
            path = str(tmp_path / f"{tag}{csv}.trk")
            w = mod.TrackFileWriter(path, csv=csv)
            w.write(**kw)
            w.close()
            paths.append(path)
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    rec = tf.read_track_file(str(tmp_path / "portFalse.trk"))
    assert rec.dtype == jtf.TRACK_DTYPE and rec["icell"].tolist() == [5, 9]


def test_release_schedule_matches_reference():
    periods = ((10.0, 5, 1.0), (10.0, 2, 1.0))
    tdis = Tdis(tuple(StressPeriod(*p) for p in periods))
    jtdis = JaxTdis(tuple(JaxPeriod(*p) for p in periods))
    for settings, times in (({1: [("first",)], 2: [("all",),
                                                   ("fraction", 0.5)]},
                             (3.25,)),
                            ({1: [("steps", [2, 4])]}, ()),
                            ({1: [("frequency", 2)]}, ()),
                            ({1: [("last",)]}, (1.0, 1.0))):
        got = tf.ReleaseSchedule(settings, times).release_times(tdis)
        want = jtf.ReleaseSchedule(settings, times).release_times(jtdis)
        np.testing.assert_array_equal(got, want)


def test_pass_to_bottom_dry_cell():
    nlay, ncol, k, q, theta = 2, 10, 10.0, 0.5, 0.25
    dh = q * (ncol - 1) / k
    botm = np.stack([np.full((1, ncol), 1.0), np.zeros((1, ncol))])
    port, ref = flow_pair((nlay, 1, ncol, 1.0, 1.0, 2.0, botm), k=k,
                          strt=0.5, icelltype=1, newton=True,
                          chd=[(ncol, 0.5 + dh), (2 * ncol - 1, 0.5)])
    pts = ([2.5], [0.5], [1.5])
    out = port_step(*port[1:], theta, pts, 2.0)
    jout = ref_step(*ref, theta, pts, 2.0)
    assert int(out["lay"][0]) == int(jout["lay"][0]) == 1
    v = q / theta / 0.5
    assert float(out["x"][0]) > 2.5 + 0.5 * v * 2.0 * 0.5
    np.testing.assert_allclose(_np(out["x"]), _np(jout["x"]), rtol=1e-9)
    assert int(out["status"][0]) == int(jout["status"][0])


# --------------------------------------------------- a swarm on lognormal K

def test_lognormal_swarm_matches_reference_vmapped_tracker(lognormal):
    """A few thousand particles over a lognormal-K field with a well:
    positions and times within 1e-9 relative of the reference's vmapped
    tracker, statuses, cells and transition counts equal; the masked batch
    loop equal to one run per particle, bitwise."""
    port, ref = lognormal
    tg = port[0]
    rng = np.random.default_rng(11)
    n = 2000
    xmax, ymax = 10.0 * tg.ncol, 10.0 * tg.nrow
    pts = (rng.uniform(0.0, xmax, n), rng.uniform(0.0, ymax, n),
           rng.uniform(-19.5, -0.5, n))
    out = port_step(*port[1:], 0.3, pts, 600.0)
    jout = ref_step(*ref, 0.3, pts, 600.0)
    for key in ("status", "lay", "row", "col", "transitions"):
        np.testing.assert_array_equal(_np(out[key]), _np(jout[key]),
                                      err_msg=key)
    for key in ("x", "y", "z", "time"):
        np.testing.assert_allclose(_np(out[key]), _np(jout[key]),
                                   rtol=1e-9, atol=1e-9, err_msg=key)
    assert len(set(_np(out["status"]).tolist())) > 1
    # the batch loop against single-particle runs
    sel = rng.choice(n, 12, replace=False)
    for p in sel:
        one = port_step(*port[1:], 0.3, tuple(v[p:p + 1] for v in pts),
                        600.0)
        for key in ("x", "y", "z", "time", "status", "transitions"):
            assert _np(one[key])[0] == _np(out[key])[p], key


def test_max_transitions_freezes_like_the_reference(uniform20):
    """A particle that reaches ``max_transitions`` stops there with status
    ACTIVE, the reference's lane condition."""
    (tg, tm, th, ta), (jg, jm, jh, ja) = uniform20
    sat = npf.compute_saturation(tm.npf_opts, tm.npf_arrays, th,
                                 ta["ibound"])
    flows = tracking.build_cell_flows(tm, th, ta["ibound"], ta["cond"],
                                      np.full(tg.nodes, 0.3), sat)
    top = torch.as_tensor(tg.top)
    bot = torch.as_tensor(tg.bot)
    track = tracking.make_tracker(flows, top, bot, max_transitions=5)
    f = torch.tensor([1.5, 15.5], dtype=torch.float64)
    h = torch.tensor([0.5, 0.5], dtype=torch.float64)
    z = torch.zeros(2, dtype=torch.int64)
    out = track(f, h, h, z, z, torch.tensor([1, 15]), 1e9)
    jflows = jtracking.build_cell_flows(
        jm.topo, jg, jnpf.flowja(jm.dtopo, ja["cond"], jh),
        np.full(jg.nodes, 0.3),
        jnpf.compute_saturation(jm.npf_opts, jm.npf_arrays, jh,
                                ja["ibound"]))
    zi = jnp.zeros(2, jnp.int32)
    jout = jtracking.make_tracker(jflows, max_transitions=5)(
        jnp.array([1.5, 15.5]), jnp.array([0.5, 0.5]),
        jnp.array([0.5, 0.5]), zi, zi, jnp.array([1, 15], jnp.int32),
        jnp.asarray(jg.top).reshape(jg.shape),
        jnp.asarray(jg.bot).reshape(jg.shape), 1e9)
    assert _np(out["transitions"]).tolist() == \
        _np(jout["transitions"]).tolist()
    assert _np(out["status"]).tolist() == _np(jout["status"]).tolist()
    assert int(out["transitions"][0]) == 5 and int(out["status"][0]) == 0
    np.testing.assert_allclose(_np(out["x"]), _np(jout["x"]), rtol=1e-12)


def test_driver_matches_reference_driver(tmp_path, lognormal):
    """PrtDriver over three steps of the reference's Simulation, with two
    release times and STOPTIME, against the reference's driver on the
    same heads: the live-slot gathering gives the reference's every-slot
    results; the track files' fields equal."""
    from modflow6_tpu.models.prt.simulation import PrtDriver as JaxDriver
    from modflow6_tpu.models.simulation import Simulation as JaxSimulation
    port, ref = lognormal
    tg, tm = port[:2]
    jg, jm = ref[:2]
    rng = np.random.default_rng(2)
    pts = (rng.uniform(5, 115, 60), rng.uniform(5, 95, 60),
           rng.uniform(-19, -1, 60))
    sched = dict(period_settings={1: [("first",)]}, times=(7.5,))
    drv = PrtDriver(PrtModel("p", tg, torch.full((tg.nodes,), 0.3),
                             ReleasePoints(*pts)), tm,
                    tf.ReleaseSchedule(**sched),
                    track_path=str(tmp_path / "port.trk"),
                    trackcsv_path=str(tmp_path / "port.csv"), stoptime=14.0)
    jdrv = JaxDriver(JaxPrtModel("p", jg, jnp.full(jg.nodes, 0.3),
                                 JaxPoints(*pts)), jm,
                     jtf.ReleaseSchedule(**sched),
                     track_path=str(tmp_path / "ref.trk"),
                     trackcsv_path=str(tmp_path / "ref.csv"), stoptime=14.0)
    jsim = JaxSimulation(JaxTdis((JaxPeriod(15.0, 3, 1.0),)), jm,
                         JaxImsSettings(**FLOW))
    jsim.prt_drivers.append(jdrv)
    jsim.run()
    tdis = Tdis((StressPeriod(15.0, 3, 1.0),))
    drv.begin(tdis)
    ib = torch.ones(tg.nodes, dtype=torch.int32)
    for rec, (kper, kstp, delt, _, totim) in zip(jsim.records, tdis.walk()):
        th = torch.as_tensor(np.array(rec.head).reshape(-1))
        drv.on_step(kper, kstp, delt, totim, th, ib,
                    tm.edge_conductances(th, ib))
    drv.finish()
    np.testing.assert_array_equal(drv.status, jdrv.status)
    np.testing.assert_array_equal(drv.released, jdrv.released)
    # three steps of tracks near a well: tests/test_gwe_prt_decks.py's
    # multi-step bar (1e-7)
    np.testing.assert_allclose(drv.ttrack, jdrv.ttrack, rtol=1e-7)
    for a, b in ((drv.x, jdrv.x), (drv.y, jdrv.y), (drv.z, jdrv.z)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-7)
    assert (drv.status == 4).any()          # STOPTIME ended some
    got = tf.read_track_file(str(tmp_path / "port.trk"))
    want = jtf.read_track_file(str(tmp_path / "ref.trk"))
    assert got.shape == want.shape
    for name in jtf.TRACK_DTYPE.names:
        if got.dtype[name].kind == "f":
            np.testing.assert_allclose(got[name], want[name], rtol=1e-7,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
    rows = open(tmp_path / "port.csv").read().splitlines()
    assert rows[0] == tf.TRACK_HEADER and len(rows) == len(got) + 1
