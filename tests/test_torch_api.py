"""The port's API and run-time utilities (modflow6_torch/api.py,
utils/checkpoint.py, utils/profiler.py, utils/memreport.py, the CLI's
-l/--level) against the reference (modflow6_tpu): the BMI/XMI tests of
tests/test_api.py (update against run, variable access, the XMI loop,
update_until, the profiler and outer CSV, the variable registry), the
checkpoint/resume of tests/test_outputs.py:151 (bit-exact, a snapshot of
either package loading in the other) and its memory report (:185).

Tolerances: the API's heads against ``Simulation.run``'s 1e-12 relative
(the reference test's bar; equal in practice); resumed runs bitwise; the
memory report's components those of the reference, with equal bytes
where the port's tensors have the reference's dtypes.
"""

import os

import numpy as np
import pytest
import torch

from test_mf6io_multi import build_split_deck
from modflow6_tpu.api import Mf6Api as RefApi
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.simulation import Simulation as RefSimulation
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
from modflow6_tpu.timing.tdis import Tdis as JaxTdis
from modflow6_tpu.utils import checkpoint as ref_ck
from modflow6_tpu.utils import memreport as ref_mem
from modflow6_torch.__main__ import main
from modflow6_torch.api import Mf6Api
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.simulation import Simulation
from modflow6_torch.solution import ImsSettings
from modflow6_torch.timing.tdis import StressPeriod, Tdis
from modflow6_torch.utils import checkpoint, memreport
from modflow6_torch.utils.profiler import Profiler

SETTINGS = dict(outer_dvclose=1e-8, inner_dvclose=1e-10, inner_rclose=1e-9,
                inner_maximum=500)


def _api_model(grid_cls, build, **dev):
    n = 12
    g = grid_cls.create(1, 1, n, 10.0, 10.0, 10.0, np.zeros((1, 1, n)))
    return build("model", g, k=5.0, strt=6.0,
                 storage={"ss": 1e-4, "iconvert": 0},
                 chd=[(0, 8.0), (n - 1, 5.0)], **dev)


def make_sim(**sim_kw):
    gwf = _api_model(DisGrid, build_gwf, device="cpu")
    tdis = Tdis([StressPeriod(perlen=40.0, nstp=4, tsmult=1.0)])
    return Simulation(tdis, gwf, ImsSettings(**SETTINGS), **sim_kw), gwf


def make_ref_sim(**sim_kw):
    gwf = _api_model(JaxDisGrid, jax_build_gwf)
    tdis = JaxTdis([JaxPeriod(perlen=40.0, nstp=4, tsmult=1.0)])
    return RefSimulation(tdis, gwf, JaxImsSettings(**SETTINGS), **sim_kw)


def test_bmi_update_matches_run():
    final_direct = make_sim()[0].run()[-1].head
    api = Mf6Api().initialize(make_sim()[0])
    nsteps = 0
    while api.update():
        nsteps += 1
    api.finalize()
    assert nsteps == 4
    np.testing.assert_allclose(api.get_value("MODEL/X"), final_direct,
                               rtol=1e-12)
    assert api.get_current_time() == api.get_end_time() == 40.0
    ref = RefApi().initialize(make_ref_sim())
    while ref.update():
        pass
    np.testing.assert_allclose(api.get_value("MODEL/X"),
                               ref.get_value("MODEL/X"), rtol=1e-12)


def test_bmi_var_access():
    sim, gwf = make_sim()
    api = Mf6Api().initialize(sim)
    addr = api.get_var_address("K11", "model", "NPF")
    assert addr == "MODEL/NPF/K11"
    np.testing.assert_allclose(api.get_value(addr), 5.0)
    # get_value is a copy: writing into it changes nothing
    api.get_value(addr)[:] = -1.0
    np.testing.assert_allclose(api.get_value(addr), 5.0)
    api.set_value(addr, np.full(gwf.nodes, 10.0))
    np.testing.assert_allclose(api.get_value(addr), 10.0)
    k = gwf.npf_arrays.k11
    assert k.dtype == torch.float64 and k.device.type == "cpu"
    # the conductances follow K: doubled everywhere, as a model built so
    doubled = build_gwf("model", gwf.grid, k=10.0, strt=6.0, device="cpu")
    for mine, theirs in zip(gwf.condsat3, doubled.condsat3):
        torch.testing.assert_close(mine, theirs, rtol=1e-15, atol=0.0)
    # a tensor in another dtype is stored in the field's dtype
    api.set_value("MODEL/WEL/Q" if gwf.wel is not None else "MODEL/CHD/HEAD",
                  torch.tensor([9, 4], dtype=torch.int32))
    assert gwf.chd.head.dtype == torch.float64
    np.testing.assert_allclose(api.get_value("MODEL/CHD/HEAD"), [9.0, 4.0])
    api.set_value("MODEL/X", 7.0)
    np.testing.assert_allclose(api.get_value("MODEL/X"), 7.0)
    assert api.get_grid_size() == 12
    assert api.get_grid_shape() == (1, 1, 12)
    with pytest.raises(KeyError):
        api.get_value("OTHER/X")


def test_xmi_fine_grained_loop():
    final_direct = make_sim()[0].run()[-1].head
    api = Mf6Api().initialize(make_sim()[0])
    assert api.get_subcomponent_count() == 1
    while api.prepare_time_step():
        api.prepare_solve()
        assert api.solve()
        api.finalize_solve()
        api.finalize_time_step()
    api.finalize()
    np.testing.assert_allclose(api.get_value("MODEL/X"), final_direct,
                               rtol=1e-12)
    assert api.get_current_time() == 40.0


def test_update_until():
    api = Mf6Api().initialize(make_sim()[0])
    api.update_until(20.0)
    assert api.get_current_time() == 20.0
    assert api.get_time_step() == 10.0
    api.update_until(1e9)
    assert api.get_current_time() == 40.0


def test_outer_csv_and_profiler(tmp_path):
    csv_path = tmp_path / "outer.csv"
    sim, _ = make_sim(outer_csv_path=str(csv_path),
                      lst_path=str(tmp_path / "sim.lst"), profile="detail")
    sim.run()
    lines = csv_path.read_text().strip().splitlines()
    assert lines[0].startswith("total_inner_iterations,totim")
    assert len(lines) > 4
    lst = (tmp_path / "sim.lst").read_text()
    assert "Profiler timings" in lst and "solve" in lst
    assert "(n=4)" in lst and "Top hotspots:" in lst
    assert "MEMORY USAGE" in lst


def test_profiler_sections():
    prof = Profiler()
    with prof.section("outer", block_on=torch.zeros(3)):
        with prof.section("inner"):
            pass
        with prof.section("inner"):
            pass
    h = prof.start("other")
    Profiler.stop(h)
    rep = prof.report("summary").splitlines()
    assert rep[0] == "Profiler timings (seconds):"
    assert rep[1].split()[0] == "outer" and rep[1].endswith("(n=1)")
    assert rep[2].startswith("    inner") and rep[2].endswith("(n=2)")
    assert rep[3].split()[0] == "other"


def test_get_var_names_registry():
    api = Mf6Api().initialize(make_sim()[0])
    names = api.get_var_names()
    addrs = [a for a, _, _ in names]
    assert any(a.endswith("/X") for a in addrs)
    assert any("/NPF/K11" in a for a in addrs)
    for a, shape, _ in names:
        if a.endswith("/IBOUND"):
            continue
        assert tuple(np.shape(api.get_value(a))) == shape
    ref = RefApi().initialize(make_ref_sim())
    ref_names = {a: (s, d) for a, s, d in ref.get_var_names()}
    # the same variables with the same shapes and dtypes, except node
    # indices, which the port holds as int64 (advanced indexing takes
    # them), and the per-edge and angle arrays, which a structured model of
    # the port does not hold
    assert set(ref_names) - {a for a, _, _ in names} == {
        f"MODEL/NPF/{f}" for f in ("ANGLE1", "ANGLE2", "ANGLE3", "CONDSAT")}
    for a, shape, dtype in names:
        assert ref_names[a][0] == shape, a
        if not a.endswith("/NODE"):
            assert ref_names[a][1] == dtype, a


def _outputs_sim(tmp_path, nper, tag):
    nrow, ncol = 6, 8
    g = DisGrid.create(1, nrow, ncol, 10.0, 10.0, 20.0,
                       np.zeros((1, nrow, ncol)))
    model = build_gwf(
        "outm", g, k=3.0, strt=8.0, storage={"ss": 1e-4, "iconvert": 0},
        chd=[(i * ncol, 10.0) for i in range(nrow)]
        + [(i * ncol + ncol - 1, 6.0) for i in range(nrow)],
        wel=[(3 * ncol + 4, -20.0)],
        rch=[(n, 5e-5) for n in range(nrow * ncol)], device="cpu")
    tdis = Tdis(tuple(StressPeriod(2.0, 2, 1.0) for _ in range(nper)))
    s = ImsSettings(outer_dvclose=1e-10, inner_dvclose=1e-12,
                    inner_rclose=1e-11, inner_maximum=500)
    ws = str(tmp_path)
    return Simulation(tdis, model, s, lst_path=os.path.join(ws, tag
                                                            + ".lst"))


def test_checkpoint_resume_bitexact(tmp_path):
    h_final = _outputs_sim(tmp_path, 2, "a").run()[-1].head
    recs1 = _outputs_sim(tmp_path, 1, "b").run()
    for writer, tag in ((checkpoint.save_checkpoint, "port"),
                        (ref_ck.save_checkpoint, "ref")):
        ck = os.path.join(str(tmp_path), f"ck_{tag}.npz")
        writer(ck, recs1[-1].head, kper=1, kstp=2, totim=2.0,
               extra={"note": np.arange(3)})
        snap = checkpoint.load_checkpoint(ck)
        ref_snap = ref_ck.load_checkpoint(ck)
        assert snap["totim"] == ref_snap["totim"] == 2.0
        assert snap["kper"] == 1 and snap["kstp"] == 2
        np.testing.assert_array_equal(snap["extra"]["note"], np.arange(3))
        sim2 = _outputs_sim(tmp_path, 1, "c" + tag)
        checkpoint.resume_simulation(sim2, ck)
        assert sim2.model.strt.dtype == torch.float64
        assert np.array_equal(sim2.run()[-1].head, h_final)
    # a tensor head round-trips losslessly
    ck = os.path.join(str(tmp_path), "ck_t.npz")
    checkpoint.save_checkpoint(ck, torch.as_tensor(recs1[-1].head),
                               conc=torch.ones(48))
    assert np.array_equal(ref_ck.load_checkpoint(ck)["head"],
                          recs1[-1].head)
    assert "conc" in ref_ck.load_checkpoint(ck)


def test_memory_report(tmp_path):
    sim = _outputs_sim(tmp_path, 1, "m")
    sim.run()
    lst = open(os.path.join(str(tmp_path), "m.lst")).read()
    assert "MEMORY USAGE" in lst and "NPF_ARRAYS" in lst
    nrow, ncol = 6, 8
    jg = JaxDisGrid.create(1, nrow, ncol, 10.0, 10.0, 20.0,
                           np.zeros((1, nrow, ncol)))
    jm = jax_build_gwf(
        "outm", jg, k=3.0, strt=8.0, storage={"ss": 1e-4, "iconvert": 0},
        chd=[(i * ncol, 10.0) for i in range(nrow)]
        + [(i * ncol + ncol - 1, 6.0) for i in range(nrow)],
        wel=[(3 * ncol + 4, -20.0)],
        rch=[(n, 5e-5) for n in range(nrow * ncol)])
    ref_rows = {line.split()[0] for line in
                ref_mem.memory_report(jm).splitlines()[3:]}
    rows = memreport.component_bytes(sim.model)
    # the port's structured model keeps no edge tables on the device
    assert set(rows) | {"TOTAL"} == ref_rows - {"DTOPO"}
    # cell arrays of one dtype count the same bytes
    seen = set()
    for name in ("strt", "ibound0"):
        assert rows[name.upper()] == ref_mem._nbytes(getattr(jm, name),
                                                     seen)


def test_cli_level_writes_profile(tmp_path, capsys):
    ws = str(tmp_path)
    build_split_deck(ws)
    lst = os.path.join(ws, "run.lst")
    assert main([ws, "--device", "cpu", "-l", "summary", "--lst", lst]) == 0
    assert "Normal termination" in capsys.readouterr().out
    text = open(lst).read()
    assert "Profiler timings" in text and "solve" in text
    assert "MEMORY USAGE (model arrays)" in text
    with pytest.raises(SystemExit):
        main([ws, "-l", "verbose"])
