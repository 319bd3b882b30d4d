"""Observations, NetCDF and zone budgets of the port
(modflow6_torch/utils/obs.py, netcdf.py, zonebudget.py, the loader's OBS6,
RCHA/TAS6 and NetCDF wiring and ``Simulation``'s obs and NetCDF branches)
against the reference, on the decks of tests/test_obs.py,
test_obs_flow.py, test_obs_tas_decks.py and test_netcdf.py through both
loaders.

Tolerances:

- CG decks: equal (outer, inner) counts per step and heads within 1e-10;
  BiCGSTAB decks: heads within 10 × OUTER_DVCLOSE (its counts follow the
  sum order: ROADMAP Queue C);
- observation CSV files: the same header and rows, values within 1e-10
  relative (the CHD flows sum the face flows in another order), or within
  the head bar on BiCGSTAB decks;
- NetCDF files: equal dimensions and attributes, variables within 1e-10
  (the head bar on BiCGSTAB decks);
- zone budgets: ``ZoneBudget.interzone`` and the table text bitwise, from
  the same flows and from a ``.cbc`` file that the port wrote.
"""

import os

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from test_obs_flow import _drn_deck
from test_obs_tas_decks import _base_deck, write
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.discretization.disv import DisvGrid as JaxDisvGrid
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.simulation import Simulation as JaxSimulation
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
from modflow6_tpu.timing.tdis import Tdis as JaxTdis
from modflow6_tpu.utils import netcdf as ref_netcdf
from modflow6_tpu.utils import obs as ref_obs
from modflow6_tpu.utils import zonebudget as ref_zb
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_tpu.utils.mf6io import schema as ref_schema
from modflow6_torch.models.discretization import DisGrid, DisvGrid
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.simulation import Simulation
from modflow6_torch.solution import ImsSettings
from modflow6_torch.timing.tdis import StressPeriod, Tdis
from modflow6_torch.utils import netcdf, obs, zonebudget
from modflow6_torch.utils.mf6io import load_simulation, schema

HEAD_ATOL = 1e-10
RTOL = 1e-10


def counts(recs):
    return [(r.outer, r.inner) for r in recs]


def read_csv(path):
    lines = open(path).read().splitlines()
    return lines[0], np.array([[float(v) for v in line.split(",")]
                               for line in lines[1:]])


def assert_same_csv(got, want, atol):
    ghead, gvals = read_csv(got)
    whead, wvals = read_csv(want)
    assert ghead == whead
    assert gvals.shape == wvals.shape and gvals.shape[0] > 0
    np.testing.assert_array_equal(gvals[:, 0], wvals[:, 0])
    np.testing.assert_allclose(gvals, wvals, rtol=RTOL, atol=atol)


def assert_same_netcdf(got, want, atol):
    fg, fw = netcdf_file(got, "r", mmap=False), netcdf_file(want, "r",
                                                              mmap=False)
    try:
        assert fg.dimensions == fw.dimensions
        assert fg._attributes == fw._attributes
        assert sorted(fg.variables) == sorted(fw.variables)
        for name, vw in fw.variables.items():
            vg = fg.variables[name]
            assert vg.dimensions == vw.dimensions
            assert vg.typecode() == vw.typecode()
            assert vg._attributes == vw._attributes
            np.testing.assert_allclose(np.asarray(vg.data),
                                       np.asarray(vw.data), rtol=0, atol=atol)
    finally:
        fg.close()
        fw.close()


# ------------------------------------------------------------ the decks
#
# The eight decks of the reference tests, merged into three so that each
# reference run (which compiles anew for every deck) serves several of
# them: "heads-tas-export" holds test_obs6_continuous_head_csv's OBS6 file
# (with CHD and RCH flows added), test_rcha_with_tas's recharge and
# test_netcdf_structured_export's export; "static-input" holds
# test_rcha_static_array's recharge and test_netcdf_griddata_input's
# arrays; "drn" holds test_drn_flow_obs_csv's and
# test_flow_obs_by_boundname's drains and observations and
# test_print_budget_oc_selection's OC file.

_NAM = """
BEGIN OPTIONS
  {option}
END OPTIONS
BEGIN PACKAGES
  DIS6 model.dis
  IC6 model.ic
  NPF6 model.npf
  STO6 model.sto
  CHD6 model.chd
  RCH6 model.rch
{extra}
END PACKAGES
"""


def _heads_tas_export(ws):
    _base_deck(ws)
    write(ws, "model.nam", _NAM.format(
        option="NETCDF_STRUCTURED FILEOUT model.nc",
        extra="  OBS6 model.obs\n  OC6 model.oc"))
    write(ws, "model.rch", """
BEGIN OPTIONS
  READASARRAYS
  TAS6 FILEIN model.tas
END OPTIONS
BEGIN PERIOD 1
  RECHARGE TIMEARRAYSERIES rts
END PERIOD
""")
    write(ws, "model.tas", """
BEGIN ATTRIBUTES
  NAME rts
  METHOD LINEAR
END ATTRIBUTES
BEGIN TIME 0.0
  CONSTANT 0.0
END TIME
BEGIN TIME 100.0
  CONSTANT 0.004
END TIME
""")
    write(ws, "model.obs", """
BEGIN OPTIONS
  DIGITS 12
END OPTIONS
BEGIN CONTINUOUS FILEOUT heads.csv
  h_end HEAD 1 1 5
  dd_mid DRAWDOWN 1 1 3
  q_chd CHD 1 1 1
  q_rch RCH 1 1 5
END CONTINUOUS
BEGIN CONTINUOUS FILEOUT second.csv
  h_first HEAD 1 1 1
END CONTINUOUS
""")
    write(ws, "model.oc", """
BEGIN OPTIONS
  HEAD FILEOUT model.hds
END OPTIONS
BEGIN PERIOD 1
  SAVE HEAD ALL
END PERIOD
""")


def _static_input(ws):
    _base_deck(ws)
    f = netcdf_file(os.path.join(ws, "in.nc"), "w")
    f.createDimension("ncol", 5)
    for name, values in (("npf_k", [1.0, 2.0, 4.0, 8.0, 16.0]),
                         ("ic_strt", [10.0, 10.5, 11.0, 11.5, 12.0])):
        v = f.createVariable(name, "d", ("ncol",))
        v[:] = np.asarray(values)
    f.close()
    write(ws, "model.nam", _NAM.format(option="NETCDF FILEIN in.nc",
                                       extra=""))
    write(ws, "model.rch", """
BEGIN OPTIONS
  READASARRAYS
END OPTIONS
BEGIN PERIOD 1
  RECHARGE
    INTERNAL
      0.0 0.001 0.002 0.003 0.004
END PERIOD
""")
    write(ws, "model.ic", """
BEGIN OPTIONS
END OPTIONS
BEGIN GRIDDATA
  STRT NETCDF
END GRIDDATA
""")
    write(ws, "model.npf", """
BEGIN OPTIONS
END OPTIONS
BEGIN GRIDDATA
  ICELLTYPE
    CONSTANT 0
  K NETCDF
END GRIDDATA
""")


def _drn(ws):
    _drn_deck(ws, """
BEGIN OPTIONS
  DIGITS 12
END OPTIONS
BEGIN CONTINUOUS FILEOUT flow.csv
  qdrn DRN 1 1 4
  h4 HEAD 1 1 4
END CONTINUOUS
BEGIN CONTINUOUS FILEOUT bn.csv
  qmain DRN maindrain
  qside DRN SIDEDRAIN
END CONTINUOUS
""", oc_text="""
BEGIN OPTIONS
END OPTIONS
BEGIN PERIOD 1
  PRINT BUDGET LAST
END PERIOD
""")
    write(ws, "model.drn", """
BEGIN OPTIONS
  BOUNDNAMES
END OPTIONS
BEGIN DIMENSIONS
  MAXBOUND 2
END DIMENSIONS
BEGIN PERIOD 1
  1 1 4 25.0 3.0 maindrain
  1 1 6 26.0 1.0 sidedrain
END PERIOD
""")


# name → (deck writer, BiCGSTAB deck, output files, budget tables)
DECKS = {"heads-tas-export": (_heads_tas_export, False,
                             ["heads.csv", "model.nc", "second.csv"], 0),
         "static-input": (_static_input, False, [], 4),
         "drn": (_drn, True, ["bn.csv", "flow.csv"], 2)}


@pytest.mark.parametrize("name", sorted(DECKS))
def test_obs_tas_netcdf_decks_match_reference(name, tmp_path):
    """Each deck through both loaders, in workspaces of their own: the
    counts and heads at the bars above, every observation CSV file, every
    NetCDF file, the listing's budget tables (OC PERIOD blocks without
    PRINT BUDGET print none; PRINT BUDGET LAST one a period) and the
    budget's cumulative terms."""
    build, bicgstab, files, tables = DECKS[name]
    runs = {}
    for pkg in ("port", "ref"):
        ws = str(tmp_path / pkg)
        os.makedirs(ws)
        build(ws)
        lst = os.path.join(ws, "model.lst")
        sim = (load_simulation(ws, lst_path=lst, device="cpu")
               if pkg == "port" else ref_load(ws, lst_path=lst))
        runs[pkg] = (ws, sim, sim.run())
    (ws, sim, recs), (jws, ref, jrecs) = runs["port"], runs["ref"]
    atol = 10 * 1e-8 if bicgstab else HEAD_ATOL
    assert all(r.converged for r in recs)
    assert [r.outer for r in recs] == [r.outer for r in jrecs]
    if not bicgstab:
        assert counts(recs) == counts(jrecs)
    for g, w in zip(recs, jrecs):
        assert g.totim == w.totim
        np.testing.assert_allclose(g.head, np.asarray(w.head), rtol=0,
                                   atol=atol)
    for d in (ws, jws):
        assert sorted(f for f in os.listdir(d) if f.endswith((".csv", ".nc"))
                      and f != "in.nc") == files
    for f in files:
        (assert_same_netcdf if f.endswith(".nc") else assert_same_csv)(
            os.path.join(ws, f), os.path.join(jws, f), atol)
    for d in (ws, jws):
        assert open(os.path.join(d, "model.lst")).read().count(
            "VOLUME BUDGET FOR ENTIRE MODEL") == tables
    assert sim.budget.terms.keys() == ref.budget.terms.keys()
    for key, term in sim.budget.terms.items():
        want = ref.budget.terms[key]
        scale = max(abs(want.cum_in), abs(want.cum_out), 1e-300)
        for field in ("cum_in", "cum_out"):
            assert abs(getattr(term, field) - getattr(want, field)) <= \
                1e-9 * scale
    if name == "static-input":
        np.testing.assert_array_equal(sim.model.npf_arrays.k11.numpy(),
                                      np.asarray(ref.model.npf_arrays.k11))
        np.testing.assert_array_equal(sim.model.strt.numpy(),
                                      np.asarray(ref.model.strt))
    if name == "heads-tas-export":
        # the linear ramp 0 → 0.004 over 100 d averages 0.002 over the
        # run, over the 4 cells that are not constant-head
        np.testing.assert_allclose(sim.budget.terms["RCH"].cum_in,
                                   0.002 * 100 * 4 * 1e4, rtol=1e-10)


def test_obs_manager_from_python_matches_reference(tmp_path):
    """tests/test_obs.py: an ObsManager handed to Simulation (CG): equal
    counts, heads within 1e-10, the CSV within 1e-10 relative."""
    n = 10
    kw = dict(k=4.0, strt=6.0, storage={"ss": 1e-4, "iconvert": 0},
              chd=[(0, 8.0), (n - 1, 5.0)], wel=[(4, -0.5)])
    botm = np.zeros((1, 1, n))
    paths = {pkg: str(tmp_path / f"{pkg}.csv") for pkg in ("port", "ref")}
    recs = Simulation(
        Tdis([StressPeriod(30.0, 3, 1.0)]),
        build_gwf("m", DisGrid.create(1, 1, n, 10.0, 10.0, 10.0, botm),
                  device="cpu", **kw), ImsSettings(),
        obs=obs.ObsManager([obs.ObsRecord("h3", "head", 3),
                            obs.ObsRecord("dd7", "drawdown", 7),
                            obs.ObsRecord("qw", "flow", 4, pkg="WEL"),
                            obs.ObsRecord("qc", "flow", 9, pkg="CHD")],
                           paths["port"])).run()
    jrecs = JaxSimulation(
        JaxTdis([JaxPeriod(30.0, 3, 1.0)]),
        jax_build_gwf("m", JaxDisGrid.create(1, 1, n, 10.0, 10.0, 10.0,
                                             botm), **kw),
        JaxImsSettings(),
        obs=ref_obs.ObsManager([ref_obs.ObsRecord("h3", "head", 3),
                                ref_obs.ObsRecord("dd7", "drawdown", 7),
                                ref_obs.ObsRecord("qw", "flow", 4,
                                                  pkg="WEL"),
                                ref_obs.ObsRecord("qc", "flow", 9,
                                                  pkg="CHD")],
                               paths["ref"])).run()
    assert counts(recs) == counts(jrecs)
    for g, w in zip(recs, jrecs):
        np.testing.assert_allclose(g.head, np.asarray(w.head), rtol=0,
                                   atol=HEAD_ATOL)
    assert_same_csv(paths["port"], paths["ref"], 1e-12)
    head, vals = read_csv(paths["port"])
    assert head == "time,h3,dd7,qw,qc"
    np.testing.assert_allclose(vals[:, 1], [r.head[3] for r in recs],
                               rtol=1e-9)
    np.testing.assert_allclose(vals[:, 3], -0.5)


def test_obs_group_reads_each_step_in_one_transfer(monkeypatch):
    """An ObsGroup gathers every file's values on the model's device and
    reads them to the host once per step."""
    group = obs.ObsGroup([
        obs.ObsManager([obs.ObsRecord("a", "head", 1),
                        obs.ObsRecord("b", "flow", 2, pkg="WEL")], "a.csv"),
        obs.ObsManager([obs.ObsRecord("c", "drawdown", 0),
                        obs.ObsRecord("d", "flow", pkg="WEL", row=1)],
                       "c.csv")])
    group.set_initial(torch.tensor([5.0, 6.0, 7.0], dtype=torch.float64))
    reads = []
    tolist = torch.Tensor.tolist

    def counted(self):
        reads.append(self.shape)
        return tolist(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    wel = (torch.tensor([2, 0, 2]), torch.tensor([-1.0, -2.0, -4.0],
                                                dtype=torch.float64))
    group.record(1.0, torch.tensor([4.0, 3.0, 2.0], dtype=torch.float64),
                 flows={"WEL": wel})
    assert reads == [(4,)]
    assert [m._rows for m in group.managers] == [
        [(1.0, [3.0, -5.0])], [(1.0, [1.0, -2.0])]]


def test_obs_kind_validates_against_depvar(tmp_path):
    ws = str(tmp_path)
    _drn_deck(ws, """
BEGIN CONTINUOUS FILEOUT bad.csv
  c1 CONCENTRATION 1 1 4
END CONTINUOUS
""")
    for loader in (ref_load, lambda w: load_simulation(w, device="cpu")):
        with pytest.raises(ValueError, match="dependent variable"):
            loader(ws)


@pytest.mark.parametrize("case", ["sfr-period-keyword", "griddata-name"])
def test_validate_catches_what_the_reference_catches(case, tmp_path):
    """test_obs_flow.py's validate-mode checks through both loaders."""
    from test_advanced_decks import _sim_files
    from test_advanced_decks import write as write_adv
    ws = str(tmp_path)
    if case == "sfr-period-keyword":
        _sim_files(ws, "  SFR6 model.sfr sfr-1", nper=1, perlen="10.0 1 1.0")
        write_adv(ws, "model.sfr", """
BEGIN DIMENSIONS
  NREACHES 1
END DIMENSIONS
BEGIN PACKAGEDATA
  1 1 1 3 100.0 3.0 1.0e-3 40.0 1.0 0.0 0.03 0 1.0 0
END PACKAGEDATA
BEGIN CONNECTIONDATA
  1
END CONNECTIONDATA
BEGIN PERIOD 1
  1 INFLOWX 1.0
END PERIOD
""")
        word = "INFLOWX"
    else:
        _sim_files(ws, "", nper=1, perlen="10.0 1 1.0")
        npf = open(os.path.join(ws, "model.npf")).read()
        write_adv(ws, "model.npf", npf.replace("ICELLTYPE", "ICELLTYPEX"))
        word = "ICELLTYPEX"
    for sch, loader in ((ref_schema, ref_load),
                        (schema, lambda w: load_simulation(w,
                                                           device="cpu"))):
        sch.set_strict(True)
        try:
            with pytest.raises(sch.UnknownKeywordError, match=word):
                loader(ws)
        finally:
            sch.set_strict(False)


# ------------------------------------------------------------ NetCDF

def _disv_grids(nrow=3, ncol=4):
    """A DISV grid of quads and triangles: each square of the lattice is
    one quad or two triangles."""
    verts = [(float(j), float(i)) for i in range(nrow + 1)
             for j in range(ncol + 1)]
    cells = []
    for i in range(nrow):
        for j in range(ncol):
            a = i * (ncol + 1) + j
            b, c, d = a + 1, a + ncol + 2, a + ncol + 1
            if (i + j) % 2:
                cells.append((j + 0.5, i + 0.5, [a, b, c, d]))
            else:
                cells += [(j + 0.7, i + 0.3, [a, b, c]),
                          (j + 0.3, i + 0.7, [a, c, d])]
    botm = np.asarray([np.full(len(cells), 1.0), np.zeros(len(cells))])
    args = (2, len(cells), np.asarray(verts), cells)
    return (DisvGrid.create(*args, top=2.0, botm=botm),
            JaxDisvGrid.create(*args, top=2.0, botm=botm))


def test_disv_mesh_export_matches_reference(tmp_path):
    """test_netcdf.py::test_disv_ugrid_mesh_export on a grid of quads and
    triangles: the face-node table as array code equals the reference's
    loop, and the two files hold the same dimensions, attributes and
    variables."""
    grid, jgrid = _disv_grids()
    ncpl = grid.ncpl
    conn = netcdf.face_nodes(grid)
    want = np.full((ncpl, 4), -1, np.int32)
    for c, cv in enumerate(jgrid.cell_verts):
        want[c, :len(cv)] = cv
    np.testing.assert_array_equal(conn, want)
    rng = np.random.default_rng(5)
    files = {}
    for name, exporter in (("port", netcdf.NetcdfExporter),
                           ("ref", ref_netcdf.NetcdfExporter)):
        files[name] = str(tmp_path / f"{name}.nc")
        ex = exporter(files[name], grid if name == "port" else jgrid)
        rng = np.random.default_rng(5)
        for t in (1.0, 2.5):
            ex.record(t, rng.normal(size=2 * ncpl))
        ex.close()
    assert_same_netcdf(files["port"], files["ref"], 0.0)
    times, _ = netcdf.read_netcdf_structured(files["port"], "time")
    np.testing.assert_array_equal(times, [1.0, 2.5])


# ------------------------------------------------------------ zone budget

def _grids(shape=(3, 7, 9)):
    nlay, nrow, ncol = shape
    botm = -np.arange(1.0, nlay + 1.0)[:, None, None] * np.ones(shape)
    idomain = np.ones(shape, np.int32)
    idomain[1, 2:4, 3:6] = 0
    args = (nlay, nrow, ncol, 10.0, 10.0, 0.0, botm, idomain)
    return DisGrid.create(*args), JaxDisGrid.create(*args)


def test_zone_budget_from_the_same_flows_is_the_reference():
    """interzone and the table text bitwise from the same edge and package
    flows; zone 0 excluded."""
    grid, jgrid = _grids()
    topo, jtopo = grid.build_topology(), jgrid.build_topology()
    rng = np.random.default_rng(6)
    zones = rng.integers(0, 5, grid.nodes)
    q = rng.normal(0.0, 1.0, topo.nedges)
    q[::7] = 0.0
    flows = {"WEL": (np.array([3, 40, 40, 100]),
                     np.array([-1.0, 0.5, -0.25, 2.0])),
             "CHD": (np.arange(0, grid.nodes, 11),
                     rng.normal(0.0, 1.0, len(range(0, grid.nodes, 11))))}
    zb, jzb = zonebudget.ZoneBudget(topo, zones), ref_zb.ZoneBudget(jtopo,
                                                                    zones)
    np.testing.assert_array_equal(zb.interzone(q), jzb.interzone(q))
    assert zb.table(q, flows) == jzb.table(q, flows)
    for name, (zin, zout) in zb.package_totals(flows).items():
        np.testing.assert_array_equal(zin, jzb.package_totals(flows)[name][0])


def test_zone_budget_from_the_port_cbc_is_the_reference(tmp_path):
    """zonebudget_from_cbc of both packages on a .cbc file that the port
    wrote (storage, CHD, WEL and RCH records): the same text; each zone's
    discrepancy is near zero and the zones' boundary totals are the
    model budget's."""
    ws = str(tmp_path)
    _base_deck(ws, extra_pkgs="  RCH6 model.rch\n  WEL6 model.wel\n"
               "  OC6 model.oc")
    write(ws, "model.rch", """
BEGIN DIMENSIONS
  MAXBOUND 2
END DIMENSIONS
BEGIN PERIOD 1
  1 1 4 0.002
  1 1 5 0.001
END PERIOD
""")
    write(ws, "model.wel", """
BEGIN DIMENSIONS
  MAXBOUND 1
END DIMENSIONS
BEGIN PERIOD 1
  1 1 3 -8.0
END PERIOD
""")
    write(ws, "model.oc", """
BEGIN OPTIONS
  BUDGET FILEOUT model.cbc
END OPTIONS
BEGIN PERIOD 1
  SAVE BUDGET ALL
END PERIOD
""")
    sim = load_simulation(ws, device="cpu")
    sim.run()
    zones = np.array([1, 1, 2, 2, 3])
    cbc = os.path.join(ws, "model.cbc")
    jtopo = JaxDisGrid.create(1, 1, 5, 100.0, 100.0, 50.0,
                              np.zeros((1, 1, 5))).build_topology()
    text = zonebudget.zonebudget_from_cbc(sim.model.topo, zones, cbc, 4, 1)
    assert text == ref_zb.zonebudget_from_cbc(jtopo, zones, cbc, 4, 1)
    assert text.count("PERCENT DISCREPANCY") == 3
    for line in text.splitlines():
        if "PERCENT DISCREPANCY" in line:
            assert abs(float(line.split()[-1])) < 1e-6
    _, flows = zonebudget.read_cbc_step(sim.model.topo, cbc, 4, 1)
    totals = zonebudget.ZoneBudget(sim.model.topo, zones).package_totals(
        flows)
    for name, (zin, zout) in totals.items():
        term = sim.budget.terms[name]
        np.testing.assert_allclose([zin.sum(), zout.sum()],
                                   [term.rate_in, term.rate_out], rtol=1e-12,
                                   atol=1e-12 * (term.rate_in + term.rate_out))
