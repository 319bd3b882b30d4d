"""The deck path of the port (loader, Simulation, output files, CLI) against
the reference on the same MF6 input decks.

Tolerances:

- loader: every array, option and period entry equal to the reference
  loader's, exactly.
- npf01b (confined, CG) at 21x21: per step equal (outer, inner) counts and
  heads within atol 1e-10 of the reference (sum order of the dot products);
  at 75x75, the port alone: every step within 2e-5 of scipy ``spsolve`` of
  the port's own assembled system and the final heads within 1e-3 of the
  golden file (the bars of tests/test_regression_decks.py:403-454).
- npf01a (unconfined, BiCGSTAB) at 21x21: all steps converged, equal outer
  counts, heads within 1e-6 of the reference, inner counts per step within
  10% (BiCGSTAB turns rounding into a few iterations more or less; the
  first step, run op by op in the reference with its sums in PyTorch's
  order, has equal counts and heads within 1e-10); final heads within
  1e-3 of the golden file at 75x75.
- output files: headers equal; heads atol 1e-10; budget records within
  1e-9 max|q| (storage records also 1e-12 capacity/delt: see there); the
  .grb files byte for byte; budget IN/OUT totals rtol 1e-9.
"""

import contextlib
import dataclasses
import os
import struct
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from test_regression_decks import GOLDEN, build_npf01, ims_text, write
from test_torch_parity import (csub_arrays, model_options,
                               stencil_in_torch)
from modflow6_tpu.ops.solvers import krylov as jkrylov
from modflow6_tpu.utils.binary import read_budget_file as ref_read_budget
from modflow6_tpu.utils.binary import read_head_file as ref_read_heads
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_tpu.utils.mf6io import schema as ref_schema
from modflow6_torch.convert import (augmented_state, simulation_from_reference,
                                    uzf_state)
from modflow6_torch.models.simulation import ConvergenceFailure
from modflow6_torch.ops.system import apply_dirichlet_structured
from modflow6_torch.utils.binary import read_budget_file, read_head_file
from modflow6_torch.utils.mf6io import load_simulation, schema
from modflow6_torch.utils.profiler import launches

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("chd", "wel", "rch", "drn", "riv", "ghb", "evt")


def load(ws, **kw):
    return load_simulation(str(ws), device="cpu", **kw)


# ------------------------------------------------------- reference state

def _pkg_fields(data):
    """{field: array} of a package data object of either package, in the
    order of its fields."""
    return {f.name: np.asarray(getattr(data, f.name))
            for f in dataclasses.fields(data)
            if getattr(data, f.name) is not None}


def simulation_state(sim):
    """What a loader produced, as numpy: the argument of
    ``simulation_from_reference``.  Works on either package's Simulation
    (``np.asarray`` reads JAX arrays and CPU tensors alike)."""
    m, g = getattr(sim.model, "base", sim.model), sim.model.grid
    a = m.npf_arrays
    arrays = dict(k11=a.k11, k22=a.k22, k33=a.k33, icelltype=a.icelltype,
                  top=a.top, bot=a.bot, strt=m.strt, ibound0=m.ibound0,
                  delr=m.delr, delc=m.delc, condsat_x=m.condsat3[0],
                  condsat_y=m.condsat3[1], condsat_z=m.condsat3[2])
    if m.sto_arrays is not None:
        s = m.sto_arrays
        arrays.update(sto_iconvert=s.iconvert, sto_ss=s.ss, sto_sy=s.sy)
    if m.wetdry is not None:
        arrays["wetdry"] = m.wetdry
    for pkg in PACKAGES:
        data = getattr(m, pkg)
        if data is not None:
            arrays.update({f"{pkg}_{key}": value
                           for key, value in _pkg_fields(data).items()})
    arrays.update(csub_arrays(m))
    if m is not sim.model:
        arrays.update(augmented_state(sim.model))
    return dict(
        name=m.name,
        grid=dict(nlay=g.nlay, nrow=g.nrow, ncol=g.ncol, delr=g.delr,
                  delc=g.delc, top=g.top_surf, botm=g.botm,
                  idomain=g.idomain, xorigin=g.xorigin, yorigin=g.yorigin,
                  angrot=g.angrot),
        arrays={k: np.asarray(v) for k, v in arrays.items()},
        npf_options=dataclasses.asdict(m.npf_opts),
        sto_options=None if m.sto_opts is None
        else dataclasses.asdict(m.sto_opts),
        model_options=model_options(m),
        tdis=[(p.perlen, p.nstp, p.tsmult) for p in sim.tdis.periods],
        transient=list(sim.transient), settings=vars(sim.solution.s),
        period_data={
            kper: {pkg: tuple(_pkg_fields(getattr(pd, pkg)).values())
                   for pkg in PACKAGES if getattr(pd, pkg) is not None}
            for kper, pd in sim.period_data.items()},
        oc=None if sim.oc is None else sim.oc.periods,
        fail_fast=sim.fail_fast, tvk=sim.tvk, tvs=sim.tvs,
        uzf=None if getattr(sim, "uzf", None) is None
        else uzf_state(sim.uzf))


def assert_same_state(got, want):
    """Exact equality of two simulation descriptions.  The condsat planes
    are computed, not loaded: they agree to rounding."""
    assert got.keys() == want.keys()
    for key in ("name", "npf_options", "sto_options", "model_options", "tdis",
                "transient", "oc", "fail_fast", "tvk", "tvs"):
        assert got[key] == want[key], key
    gs, ws = dict(got["settings"]), dict(want["settings"])
    for s in (gs, ws):
        if s["csv_inner_path"]:
            s["csv_inner_path"] = os.path.basename(s["csv_inner_path"])
    assert gs == ws
    for section in ("grid", "arrays"):
        assert got[section].keys() == want[section].keys(), section
        for key, value in got[section].items():
            if key.startswith("condsat"):
                np.testing.assert_allclose(value, want[section][key],
                                           rtol=1e-14, err_msg=key)
            else:
                np.testing.assert_array_equal(value, want[section][key],
                                              err_msg=key)
    assert (got["uzf"] is None) == (want["uzf"] is None)
    if got["uzf"] is not None:
        assert got["uzf"]["flags"] == want["uzf"]["flags"]
        for key, value in want["uzf"]["columns"].items():
            np.testing.assert_array_equal(got["uzf"]["columns"][key], value,
                                          err_msg=key)
    assert got["period_data"].keys() == want["period_data"].keys()
    for kper, pkgs in got["period_data"].items():
        assert pkgs.keys() == want["period_data"][kper].keys(), kper
        for pkg, arrays in pkgs.items():
            for g, w in zip(arrays, want["period_data"][kper][pkg]):
                np.testing.assert_array_equal(g, w, err_msg=f"{kper} {pkg}")


# ----------------------------------------------------------------- decks

def build_arrays_deck(ws, csv_inner=False):
    """A 2x6x5 transient deck that reads its arrays every way the slice
    supports: OPEN/CLOSE text with FACTOR, OPEN/CLOSE (BINARY), LAYERED,
    INTERNAL with repeat counts, inline CONSTANT, READASARRAYS recharge, an
    OPEN/CLOSE list file, an auxiliary column, and an OC file."""
    ws = str(ws)
    nlay, nrow, ncol = 2, 6, 5
    rng = np.random.default_rng(21)
    k = np.exp(rng.normal(1.0, 0.5, (nlay, nrow, ncol)))
    write(ws, "mfsim.nam", """
BEGIN OPTIONS
  CONTINUE
END OPTIONS
BEGIN TIMING
  TDIS6 sim.tdis
END TIMING
BEGIN MODELS
  GWF6 m.nam ARR
END MODELS
BEGIN EXCHANGES
END EXCHANGES
BEGIN SOLUTIONGROUP 1
  IMS6 sim.ims ARR
END SOLUTIONGROUP
""")
    write(ws, "sim.tdis", """
BEGIN OPTIONS
  TIME_UNITS DAYS
END OPTIONS
BEGIN DIMENSIONS
  NPER 2
END DIMENSIONS
BEGIN PERIODDATA
  1.0 1 1.0
  30.0 3 1.2
END PERIODDATA
""")
    csv = "  CSV_INNER_OUTPUT FILEOUT inner.csv\n" if csv_inner else ""
    write(ws, "sim.ims", f"""
BEGIN OPTIONS
  COMPLEXITY MODERATE
  NO_PTC FIRST
{csv}END OPTIONS
BEGIN NONLINEAR
  OUTER_DVCLOSE 1e-6
  OUTER_MAXIMUM 60
  UNDER_RELAXATION SIMPLE
  UNDER_RELAXATION_GAMMA 0.9
END NONLINEAR
BEGIN LINEAR
  INNER_MAXIMUM 400
  INNER_DVCLOSE 1e-8
  INNER_RCLOSE 1e-6 L2NORM_RCLOSE
  LINEAR_ACCELERATION CG
  NUMBER_ORTHOGONALIZATIONS 7
END LINEAR
""")
    write(ws, "m.nam", """
BEGIN OPTIONS
  SAVE_FLOWS
END OPTIONS
BEGIN PACKAGES
  DIS6 m.dis
  IC6 m.ic
  NPF6 m.npf
  STO6 m.sto
  CHD6 m.chd
  WEL6 m.wel
  RCH6 m.rcha
  OC6 m.oc
END PACKAGES
""")
    write(ws, "m.dis", f"""
BEGIN OPTIONS
  XORIGIN 100.0
  YORIGIN -50.0
  ANGROT 15.0
END OPTIONS
BEGIN DIMENSIONS
  NLAY {nlay}
  NROW {nrow}
  NCOL {ncol}
END DIMENSIONS
BEGIN GRIDDATA
  DELR CONSTANT 25.0
  DELC
    INTERNAL FACTOR 2.0
    3*10.0 3*12.5
  TOP
    CONSTANT 30.0
  BOTM LAYERED
    CONSTANT 10.0
    CONSTANT 0.0
  IDOMAIN LAYERED
    INTERNAL
    {' '.join(['1'] * 12)} 0 0 {' '.join(['1'] * 16)}
    CONSTANT 1
END GRIDDATA
""")
    write(ws, "m.ic",
          "BEGIN GRIDDATA\n  STRT\n    CONSTANT 24.0\nEND GRIDDATA\n")
    np.savetxt(os.path.join(ws, "k.txt"), k.reshape(nlay * nrow, ncol) / 3.0)
    with open(os.path.join(ws, "k33.bin"), "wb") as f:
        f.write(struct.pack("<iidd16siii", 1, 1, 1.0, 1.0, b"             K33",
                            ncol, nrow, 1))
        (0.1 * k).astype("<f8").tofile(f)
    write(ws, "m.npf", """
BEGIN OPTIONS
  SAVE_SPECIFIC_DISCHARGE
  ALTERNATIVE_CELL_AVERAGING LOGARITHMIC
  VARIABLECV DEWATERED
  PERCHED
  THICKSTRT
END OPTIONS
BEGIN GRIDDATA
  ICELLTYPE LAYERED
    CONSTANT 1
    CONSTANT -1
  K
    OPEN/CLOSE k.txt FACTOR 3.0
  K33
    OPEN/CLOSE k33.bin (BINARY)
END GRIDDATA
""")
    write(ws, "m.sto", """
BEGIN OPTIONS
  SS_CONFINED_ONLY
END OPTIONS
BEGIN GRIDDATA
  ICONVERT LAYERED
    CONSTANT 1
    CONSTANT 0
  SS
    CONSTANT 1e-5
  SY
    CONSTANT 0.12
END GRIDDATA
BEGIN PERIOD 1
  STEADY-STATE
END PERIOD
BEGIN PERIOD 2
  TRANSIENT
END PERIOD
""")
    write(ws, "chd1.txt", "\n".join(f"1 {i + 1} 1 26.0 {i}.5"
                                    for i in range(nrow)) + "\n")
    write(ws, "m.chd", f"""
BEGIN OPTIONS
  AUXILIARY CONC
  PRINT_FLOWS
END OPTIONS
BEGIN DIMENSIONS
  MAXBOUND {2 * nrow}
END DIMENSIONS
BEGIN PERIOD 1
  OPEN/CLOSE chd1.txt
END PERIOD
BEGIN PERIOD 2
{chr(10).join(f"  2 {i + 1} {ncol} 21.0 0.0" for i in range(nrow))}
{chr(10).join(f"  1 {i + 1} 1 25.0 1.0" for i in range(nrow))}
END PERIOD
""")
    write(ws, "m.wel", """
BEGIN DIMENSIONS
  MAXBOUND 2
END DIMENSIONS
BEGIN PERIOD 2
  2 3 3 -40.0
  1 5 4 -15.0
END PERIOD
""")
    write(ws, "m.rcha", """
BEGIN OPTIONS
  READASARRAYS
END OPTIONS
BEGIN PERIOD 1
  RECHARGE
    CONSTANT 2e-3
END PERIOD
""")
    write(ws, "m.oc", """
BEGIN OPTIONS
  HEAD FILEOUT arr.hds
  BUDGET FILEOUT arr.cbc
END OPTIONS
BEGIN PERIOD 1
  SAVE HEAD ALL
  PRINT BUDGET LAST
END PERIOD
BEGIN PERIOD 2
  SAVE HEAD STEPS 1 3
  SAVE BUDGET LAST
  PRINT HEAD FIRST
END PERIOD
""")
    return k


def _steps(recs):
    return [(r.kper, r.kstp, r.outer, r.inner, r.converged) for r in recs]


@pytest.fixture(scope="module")
def npf01b(tmp_path_factory):
    """npf01b at 21x21 run by both packages with heads, budget and listing
    files: (reference sim, port sim, reference dir, port dir)."""
    ws = tmp_path_factory.mktemp("npf01b")
    build_npf01(str(ws), "b", 21, 21)
    out = {}
    for name, loader in (("ref", ref_load), ("port", load)):
        d = ws / name
        d.mkdir()
        sim = loader(str(ws), hds_path=str(d / "o.hds"),
                     cbc_path=str(d / "o.cbc"), lst_path=str(d / "o.lst"))
        sim.run()
        out[name] = sim
    return out["ref"], out["port"], ws / "ref", ws / "port"


@pytest.fixture(scope="module")
def npf01a(tmp_path_factory):
    ws = tmp_path_factory.mktemp("npf01a")
    build_npf01(str(ws), "a", 21, 21)
    ref = ref_load(str(ws))
    ref.run()
    port = load(ws)
    port.run()
    return ref, port, ws


# ---------------------------------------------------------------- loader

@pytest.mark.parametrize("case", ["a", "b"])
def test_loader_matches_reference_npf01(case, tmp_path):
    build_npf01(str(tmp_path), case, 21, 21)
    want = simulation_state(ref_load(str(tmp_path)))
    got = simulation_state(load(tmp_path))
    assert_same_state(got, want)
    # WEL starts in period 2 with one masked row before; CHD persists
    assert sorted(got["period_data"]) == [1, 2]
    assert not got["arrays"]["wel_mask"].any()
    assert got["period_data"][2]["wel"][2].all()
    assert got["period_data"][2]["chd"][2].all()
    assert got["settings"]["linear_acceleration"] == (
        "bicgstab" if case == "a" else "cg")


def test_loader_matches_reference_array_deck(tmp_path):
    k = build_arrays_deck(tmp_path, csv_inner=True)
    ref = ref_load(str(tmp_path))
    port = load(tmp_path)
    got = simulation_state(port)
    assert_same_state(got, simulation_state(ref))
    np.testing.assert_allclose(got["arrays"]["k11"], k.reshape(-1),
                               rtol=1e-15)
    np.testing.assert_array_equal(got["arrays"]["k33"], 0.1 * k.reshape(-1))
    assert got["arrays"]["ibound0"].sum() == 58
    assert got["settings"]["icnvgopt"] == 0 and got["settings"]["north"] == 7
    assert got["settings"]["under_relaxation"] == "simple"
    assert got["transient"] == [False, True] and not got["fail_fast"]
    assert os.path.basename(port.hds_path) == "arr.hds"
    assert port.hds_path == ref.hds_path
    assert got["oc"][2][("SAVE", "HEAD")] == ("STEPS", [1, 3])
    assert got["arrays"]["rch_node"].tolist() == list(range(30))


def test_array_deck_run_matches_reference(tmp_path):
    """The whole deck path on the array deck: unconfined top layer, an
    idomain hole, period data that changes, OC selection."""
    refdir, portdir = tmp_path / "ref", tmp_path / "port"
    for d in (refdir, portdir):
        d.mkdir()
        build_arrays_deck(d, csv_inner=True)
    ref = ref_load(str(refdir), lst_path=str(refdir / "o.lst"))
    ref.run()
    port = load(portdir, lst_path=str(portdir / "o.lst"))
    port.run()
    assert _steps(port.records) == _steps(ref.records)
    assert all(r.converged for r in port.records)
    for g, w in zip(port.records, ref.records):
        np.testing.assert_allclose(g.head, w.head, rtol=0, atol=1e-10)
    _assert_same_output_files(refdir, portdir, "arr", port.model)
    # OC: heads saved at 1/1, 2/1 and 2/3, two layers each
    assert [(r["kper"], r["kstp"], r["ilay"])
            for r in read_head_file(portdir / "arr.hds")] == [
        (1, 1, 1), (1, 1, 2), (2, 1, 1), (2, 1, 2), (2, 3, 1), (2, 3, 2)]
    assert read_head_file(portdir / "arr.hds")[0]["data"][2, 2] == 1e30
    # the listing: one budget table (PRINT BUDGET LAST of period 1 is
    # replaced by period 2's block, which prints none) and one head print
    glst = (portdir / "o.lst").read_text()
    wlst = (refdir / "o.lst").read_text()
    assert glst.count("VOLUME BUDGET") == wlst.count("VOLUME BUDGET") == 1
    assert glst.count("HEAD IN LAYER") == wlst.count("HEAD IN LAYER") == 1
    # CSV_INNER_OUTPUT rows: one per inner iteration, same columns
    grow = (portdir / "inner.csv").read_text().splitlines()
    wrow = (refdir / "inner.csv").read_text().splitlines()
    assert grow[0] == wrow[0] and len(grow) == len(wrow)
    assert len(grow) == 1 + sum(r.inner for r in port.records)
    g = np.array([line.split(",") for line in grow[1:]], float)
    w = np.array([line.split(",") for line in wrow[1:]], float)
    np.testing.assert_array_equal(g[:, :5], w[:, :5])
    np.testing.assert_allclose(g[:, 5:], w[:, 5:], rtol=1e-5, atol=1e-10)


def _deck_with(tmp_path, edit):
    """The array deck with one file rewritten by ``edit(text) -> text``,
    and further files written where the edit names them."""
    build_arrays_deck(tmp_path)
    name, fn, *files = edit
    path = tmp_path / name
    path.write_text(fn(path.read_text()))
    for extra in files:
        for fname, text in extra.items():
            (tmp_path / fname).write_text(text)


def _list_file(maxbound, rows, dims=""):
    return (f"BEGIN DIMENSIONS\n  MAXBOUND {maxbound}\n{dims}END DIMENSIONS\n"
            "BEGIN PERIOD 1\n" + "".join(f"  {r}\n" for r in rows)
            + "END PERIOD\n")


def _add_package(line):
    return lambda t: t.replace("  OC6 m.oc\n", f"  OC6 m.oc\n  {line}\n")


def _add_option(line):
    return lambda t: t.replace("BEGIN OPTIONS\n", f"BEGIN OPTIONS\n  {line}\n",
                               1)


CSUB_FILE = """BEGIN OPTIONS
END OPTIONS
BEGIN DIMENSIONS
  NINTERBEDS 3
END DIMENSIONS
BEGIN GRIDDATA
  CG_SKE_CR
    CONSTANT 1.0e-5
  CG_THETA
    CONSTANT 0.2
  SGM
    CONSTANT 1.7
  SGS
    CONSTANT 2.0
END GRIDDATA
BEGIN PACKAGEDATA
  1 2 3 3 NODELAY 0.0 2.0 1.0 1.0e-2 1.0e-4 0.3 0.0 0.0
  2 2 3 3 NODELAY 0.0 1.0 1.0 2.0e-2 2.0e-4 0.3 0.0 0.0
  3 1 4 2 DELAY 0.0 2.0 1.0 1.0e-3 1.0e-4 0.3 0.01 25.0
END PACKAGEDATA
"""
BUY_FILE = """BEGIN OPTIONS
  DENSEREF 1000.0
END OPTIONS
BEGIN DIMENSIONS
  NRHOSPECIES 1
END DIMENSIONS
BEGIN PACKAGEDATA
  1 gwt salinity 0.7 0.0
END PACKAGEDATA
"""

# two wells that share a cell, a reach network with a diversion, a lake
# with a vertical and a horizontal connection, a table and an outlet
MAW_FILE = """BEGIN DIMENSIONS
  NMAWWELLS 2
END DIMENSIONS
BEGIN PACKAGEDATA
  1 0.25 0.0 25.0 SPECIFIED 2
  2 0.2 0.0 25.0 SPECIFIED 1
END PACKAGEDATA
BEGIN CONNECTIONDATA
  1 1 1 3 3 20.0 10.0 30.0 0.5
  1 2 2 3 3 20.0 10.0 30.0 0.5
  2 1 1 3 3 20.0 10.0 12.0 0.5
END CONNECTIONDATA
BEGIN PERIOD 1
  1 RATE -20.0
  2 RATE -5.0
  2 HEAD_LIMIT 15.0
END PERIOD
"""
SFR_FILE = """BEGIN DIMENSIONS
  NREACHES 3
END DIMENSIONS
BEGIN PACKAGEDATA
  1 1 1 1 100.0 3.0 1.0e-3 27.0 1.0 0.5 0.03 1 1.0 0
  2 1 2 1 100.0 3.0 1.0e-3 26.9 1.0 0.5 0.03 2 1.0 1
  3 1 3 1 100.0 3.0 1.0e-3 26.8 1.0 0.5 0.03 1 1.0 0
END PACKAGEDATA
BEGIN CONNECTIONDATA
  1 -2
  2 1 -3
  3 2
END CONNECTIONDATA
BEGIN DIVERSIONS
  2 1 3 UPTO
END DIVERSIONS
BEGIN PERIOD 1
  1 INFLOW 2.0
  2 DIVERSION 1 0.5
END PERIOD
"""
LAK_FILE = """BEGIN DIMENSIONS
  NLAKES 1
  NOUTLETS 1
  NTABLES 1
END DIMENSIONS
BEGIN PACKAGEDATA
  1 25.0 2
END PACKAGEDATA
BEGIN CONNECTIONDATA
  1 1 1 5 4 VERTICAL 0.1 20.0 30.0 0.0 0.0
  1 2 1 5 5 HORIZONTAL 0.1 12.0 20.0 50.0 10.0
END CONNECTIONDATA
BEGIN TABLES
  1 TAB6 FILEIN lak.tab
END TABLES
BEGIN OUTLETS
  1 1 0 MANNING 24.0 2.0 0.03 0.001
END OUTLETS
BEGIN PERIOD 1
  1 RAINFALL 0.001
  1 EVAPORATION 0.0005
END PERIOD
"""
UZF_FILE = """BEGIN OPTIONS
  SIMULATE_ET
END OPTIONS
BEGIN DIMENSIONS
  NUZFCELLS 2
END DIMENSIONS
BEGIN PACKAGEDATA
  1 1 2 2 1 0 0.5 0.3 0.05 0.35 0.1 3.5
  2 1 4 3 0 0 0.5 0.2 0.06 0.3 0.1 4.0
END PACKAGEDATA
BEGIN PERIOD 1
  1 2.0e-3 1.0e-3 2.0 0.08
  2 1.0e-3
END PERIOD
"""
MVR_FILE = """BEGIN DIMENSIONS
  MAXMVR 1
  MAXPACKAGES 2
END DIMENSIONS
BEGIN PERIOD 1
  WEL-1 1 SFR-1 1 UPTO 1.0
END PERIOD
"""
LAK_TABLE = """BEGIN DIMENSIONS
  NROW 3
  NCOL 3
END DIMENSIONS
BEGIN TABLE
  20.0 0.0 100.0
  25.0 600.0 140.0
  30.0 1400.0 180.0
END TABLE
"""


TS_FILE = """BEGIN ATTRIBUTES
  NAME pumping
  METHOD STEPWISE
END ATTRIBUTES
BEGIN TIMESERIES
  0.0 -40.0
  10.0 -20.0
  40.0 -20.0
END TIMESERIES
"""
TAS_FILE = """BEGIN ATTRIBUTES
  NAME rts
  METHOD LINEAR
END ATTRIBUTES
BEGIN TIME 0.0
  CONSTANT 0.0
END TIME
BEGIN TIME 31.0
  CONSTANT 4e-3
END TIME
"""
OBS_FILE = """BEGIN OPTIONS
  DIGITS 8
END OPTIONS
BEGIN CONTINUOUS FILEOUT arr.obs.csv
  h22 HEAD 1 2 2
END CONTINUOUS
"""


def _gwt(packages, files=None, model="GWT6"):
    """mfsim.nam with a transport model T on the array deck's grid, its
    name file listing ``packages`` beside DIS, IC, ADV and MST."""
    nam = ("BEGIN PACKAGES\n  DIS6 m.dis\n  IC6 t.ic\n  ADV6 t.adv\n"
           f"  MST6 t.mst\n  {packages}\nEND PACKAGES\n")
    return ("mfsim.nam", lambda t: t.replace(
        "  GWF6 m.nam ARR\n", f"  GWF6 m.nam ARR\n  {model} t.nam T\n"
    ).replace("BEGIN EXCHANGES\n",
              "BEGIN EXCHANGES\n  GWF6-GWT6 x.exg ARR T\n"),
        {"t.nam": nam, "t.ic": "BEGIN GRIDDATA\n  STRT\n    CONSTANT 0.0\n"
         "END GRIDDATA\n", "t.adv": "BEGIN OPTIONS\n  SCHEME UPSTREAM\n"
         "END OPTIONS\n", "t.mst": "BEGIN GRIDDATA\n  POROSITY\n"
         "    CONSTANT 0.2\nEND GRIDDATA\n", **(files or {})})


UNSUPPORTED = {
    "DRN6": ("m.nam", _add_package("DRN6 m.drn"), {"m.drn": _list_file(
        2, ["1 2 2 27.0 3.0", "2 4 3 9.5 1.5"])}),
    "RIV6": ("m.nam", _add_package("RIV6 m.riv"), {"m.riv": _list_file(
        2, ["1 3 2 27.5 2.0 26.0", "1 4 2 27.0 2.0 25.5"])}),
    "GHB6": ("m.nam", _add_package("GHB6 m.ghb"), {"m.ghb": _list_file(
        1, ["2 6 5 20.0 0.7"])}),
    "EVT6": ("m.nam", _add_package("EVT6 m.evt"), {"m.evt": _list_file(
        3, [f"1 {i} 3 29.0 1e-3 4.0 0.4 0.6" for i in (1, 2, 3)],
        dims="  NSEG 2\n")}),
    "MAW6": ("m.nam", _add_package("MAW6 m.maw"), {"m.maw": MAW_FILE}),
    "SFR6": ("m.nam", _add_package("SFR6 m.sfr"), {"m.sfr": SFR_FILE}),
    "LAK6": ("m.nam", _add_package("LAK6 m.lak"), {"m.lak": LAK_FILE,
                                                   "lak.tab": LAK_TABLE}),
    "UZF6": ("m.nam", _add_package("UZF6 m.uzf"), {"m.uzf": UZF_FILE}),
    "CSUB6": ("m.nam", _add_package("CSUB6 m.csub"), {"m.csub": CSUB_FILE}),
    "BUY6": ("m.nam", _add_package("BUY6 m.buy"), {"m.buy": BUY_FILE}),
    "HFB6": ("m.nam", _add_package("HFB6 m.hfb")),
    "MVR6": ("m.nam", _add_package("SFR6 m.sfr sfr-1\n  MVR6 m.mvr"),
             {"m.sfr": SFR_FILE, "m.mvr": MVR_FILE}),
    "OBS6": ("m.nam", _add_package("OBS6 m.obs"), {"m.obs": OBS_FILE}),
    "DISV6": ("m.nam", lambda t: t.replace("DIS6 m.dis", "DISV6 m.disv")),
    "DISU6": ("m.nam", lambda t: t.replace("DIS6 m.dis", "DISU6 m.disu")),
    "NEWTON": ("m.nam", _add_option("NEWTON")),
    "NETCDF_STRUCTURED": ("m.nam",
                          _add_option("NETCDF_STRUCTURED FILEOUT m.nc")),
    "REWET": ("m.npf", _add_option("REWET WETFCT 1.0 IWETIT 1 IHDWET 0")),
    "XT3D": ("m.npf", _add_option("XT3D")),
    "TVK6": ("m.npf", _add_option("TVK6 FILEIN m.tvk"), {"m.tvk": (
        "BEGIN PERIOD 2\n  1 2 2 K 3.5\n  2 3 4 K33 0.2\nEND PERIOD\n")}),
    "ANGLE1": ("m.npf", lambda t: t.replace(
        "  K33\n", "  ANGLE1\n    CONSTANT 30.0\n  K33\n")),
    "TVS6": ("m.sto", _add_option("TVS6 FILEIN m.tvs"), {"m.tvs": (
        "BEGIN PERIOD 2\n  1 1 1 SS 2e-4\n  2 6 5 SY 0.05\nEND PERIOD\n")}),
    "AUTO_FLOW_REDUCE": ("m.wel", lambda t: "BEGIN OPTIONS\n  "
                         "AUTO_FLOW_REDUCE 0.1\nEND OPTIONS\n" + t),
    "TS6": ("m.wel", lambda t: "BEGIN OPTIONS\n  TS6 FILEIN m.ts\n"
            "END OPTIONS\n" + t.replace("-40.0", "pumping"),
            {"m.ts": TS_FILE}),
    "TAS6": ("m.rcha", lambda t: t.replace(
        "  RECHARGE\n    CONSTANT 2e-3", "  RECHARGE TIMEARRAYSERIES rts"
    ).replace("  READASARRAYS\n", "  READASARRAYS\n  TAS6 FILEIN m.tas\n"),
             {"m.tas": TAS_FILE}),
    "option OBS6": ("m.wel", lambda t: "BEGIN OPTIONS\n  OBS6 FILEIN w.obs\n"
                    "END OPTIONS\n" + t, {"w.obs": OBS_FILE}),
    "option TS6": ("m.nam", _add_package("MAW6 m.maw"), {"m.maw": (
        "BEGIN OPTIONS\n  TS6 FILEIN m.ts\nEND OPTIONS\n" + MAW_FILE),
        "m.ts": TS_FILE}),
    "NETCDF_MESH2D": ("m.nam", _add_option("NETCDF_MESH2D FILEOUT m.nc")),
    "R7": ("m.nam", _add_package("WEL6 m2.wel"), {
        "m2.wel": "BEGIN OPTIONS\n  TS6 FILEIN m.ts\nEND OPTIONS\n"
        + _list_file(1, ["1 2 2 pumping"]), "m.ts": TS_FILE}),
    "R8": ("mfsim.nam", lambda t: t.replace(
        "  GWF6 m.nam ARR\n", "  GWF6 m.nam ARR\n  GWF6 m.nam ARR2\n").replace(
        "BEGIN EXCHANGES\n", "BEGIN EXCHANGES\n  GWF6-GWF6 x.exg ARR ARR2\n"),
        {"x.exg": "BEGIN DIMENSIONS\n  NEXG 1\nEND DIMENSIONS\n"
         "BEGIN EXCHANGEDATA\n  1 1 5 1 1 1 1 12.5 12.5 10.0\n"
         "END EXCHANGEDATA\n",
         "m.wel": "BEGIN OPTIONS\n  TS6 FILEIN m.ts\nEND OPTIONS\n"
         + _list_file(1, ["1 2 2 pumping"]), "m.ts": TS_FILE}),
    "PERIOD": ("m.rcha", lambda t: t + "BEGIN PERIOD 2\n  RECHARGE\n"
               "    CONSTANT 1e-3\nEND PERIOD\n"),
    "IRCH": ("m.rcha", lambda t: t.replace(
        "  RECHARGE\n", "  IRCH\n    CONSTANT 1\n  RECHARGE\n")),
    "PRECONDITIONER_LEVELS": ("sim.ims", lambda t: t.replace(
        "  INNER_MAXIMUM", "  PRECONDITIONER_LEVELS 3\n  INNER_MAXIMUM")),
    "PRECONDITIONER_DROP_TOLERANCE": ("sim.ims", lambda t: t.replace(
        "  INNER_MAXIMUM",
        "  PRECONDITIONER_DROP_TOLERANCE 1e-3\n  INNER_MAXIMUM")),
    "ATS6": ("sim.tdis", _add_option("ATS6 FILEIN sim.ats")),
    # a GWT6 model loads now (test_torch_gwt_decks.py), and a GWE6 one
    # (test_torch_gwe.py); these stay refused: MST6 in a GWE6 model, ...
    "GWE6": _gwt("", model="GWE6"),
    # an LKT6 file loads now (test_torch_apt.py); its TS6 option does not
    "LKT6": _gwt("LKT6 t.lkt", {"t.lkt": "BEGIN OPTIONS\n  TS6 FILEIN t.ts\n"
                                "END OPTIONS\nBEGIN PACKAGEDATA\n  1 0.0\n"
                                "END PACKAGEDATA\n"}),
    "IST6": _gwt("IST6 t.ist"),
    "AUXMIXED": _gwt("SSM6 t.ssm", {"t.ssm": "BEGIN SOURCES\n  WEL-1 "
                                    "AUXMIXED CONCENTRATION\nEND SOURCES\n"}),
    "XT3D_OFF": _gwt("DSP6 t.dsp", {"t.dsp": "BEGIN GRIDDATA\n  ALH\n"
                                    "    CONSTANT 1.0\nEND GRIDDATA\n"}),
    "more than one model": ("mfsim.nam", lambda t: t.replace(
        "  GWF6 m.nam ARR\n", "  GWF6 m.nam ARR\n  GWF6 m.nam ARR2\n")),
    "GWF6-GWF6": ("mfsim.nam", lambda t: t.replace(
        "BEGIN EXCHANGES\n", "BEGIN EXCHANGES\n  GWF6-GWF6 x.exg ARR ARR\n")),
}


# keywords that raised until a later slice ported them: they now load, with
# the same state as the reference's loader gives.  DISV6 and DISU6 load too,
# from a deck of their own (the array deck's cell ids are DIS ones).
PORTED = ("NEWTON", "REWET", "AUTO_FLOW_REDUCE", "PRECONDITIONER_LEVELS",
          "PRECONDITIONER_DROP_TOLERANCE", "DRN6", "RIV6", "GHB6", "EVT6",
          "CSUB6", "BUY6", "TVK6", "TVS6", "MAW6", "SFR6", "LAK6", "UZF6",
          "MVR6", "TS6", "TAS6", "OBS6", "NETCDF_STRUCTURED")
GENERAL_GRIDS = {"DISV6": "disv", "DISU6": "disu"}


@pytest.mark.parametrize("key", sorted(UNSUPPORTED))
def test_loader_raises_outside_the_slice(key, tmp_path):
    """Each unsupported package or keyword raises NotImplementedError that
    names it; none is skipped silently.  The keywords of ``PORTED`` load as
    the reference loads them."""
    if key in GENERAL_GRIDS:
        from test_torch_packages import write_general_deck
        write_general_deck(tmp_path, GENERAL_GRIDS[key])
        got, want = load(tmp_path), ref_load(str(tmp_path))
        assert type(got.model.grid).__name__ == type(want.model.grid).__name__
        assert not got.model.use_structured
        for name in ("edge_n", "edge_m", "cl1", "cl2", "hwva", "anglex"):
            np.testing.assert_array_equal(getattr(got.model.topo, name),
                                          getattr(want.model.topo, name))
        np.testing.assert_array_equal(got.model.drn.elev.numpy(),
                                      np.asarray(want.model.drn.elev))
        return
    _deck_with(tmp_path, UNSUPPORTED[key])
    if key in PORTED:
        with pytest.warns(UserWarning) if key.startswith("PRECOND") \
                else contextlib.nullcontext():
            sim = load(tmp_path)
            got = simulation_state(sim)
            want = simulation_state(ref_load(str(tmp_path)))
        assert_same_state(got, want)
        changed = {
            "NEWTON": got["model_options"]["inewton"],
            "REWET": "wetdry" in got["arrays"],
            "AUTO_FLOW_REDUCE": got["model_options"]["wel_iflowred"],
            "DRN6": "drn_elev" in got["arrays"],
            "RIV6": "riv_rbot" in got["arrays"],
            "GHB6": "ghb_bhead" in got["arrays"],
            "EVT6": "evt_petm" in got["arrays"],
            "CSUB6": "csub_delay_kv" in got["arrays"],
            "BUY6": got["model_options"]["buy"] is not None,
            "TVK6": bool(got["tvk"]),
            "TVS6": bool(got["tvs"]),
            "MAW6": "maw_rate" in got["arrays"],
            "SFR6": "sfr_divflow" in got["arrays"],
            "LAK6": "lak_tab_stage" in got["arrays"],
            "UZF6": got["uzf"] is not None,
            "MVR6": tuple(got["arrays"].get("mvr_prov_pkg", ())) == (
                "wel",),
            # the series binds per step: a placeholder until then
            "TS6": len(sim.step_hooks) == 1
            and got["period_data"][2]["wel"][1][0] == 0.0,
            "TAS6": len(sim.step_hooks) == 1,
            "OBS6": sim.obs is not None and [
                m.csv_path for m in sim.obs.managers] == [
                str(tmp_path / "arr.obs.csv")],
            "NETCDF_STRUCTURED": sim.nc is not None,
        }.get(key, got["settings"]["preconditioner"] == "chebyshev")
        assert changed
        return
    with pytest.raises(NotImplementedError, match=key):
        load(tmp_path)


def test_passthrough_idomain_raises(tmp_path):
    """A DIS file whose idomain < 0 cells connect layers 1 and 3 has no
    structured stencil.  It raised until the general path was ported; now
    it loads on that path, with the reference's topology."""
    from modflow6_tpu.utils.mf6io.loader import load_dis as ref_load_dis
    from modflow6_torch.utils.mf6io.loader import load_dis
    build_arrays_deck(tmp_path)
    path = tmp_path / "m.dis"
    text = path.read_text().replace("NLAY 2", "NLAY 3").replace(
        "    CONSTANT 10.0\n    CONSTANT 0.0",
        "    CONSTANT 20.0\n    CONSTANT 10.0\n    CONSTANT 0.0").replace(
        "    CONSTANT 1\nEND GRIDDATA",
        "    CONSTANT -1\n    CONSTANT 1\nEND GRIDDATA")
    path.write_text(text)
    grid = load_dis(str(path))
    assert grid.shape == (3, 6, 5)
    assert grid.grid_shape is None
    got, want = grid.build_topology(), ref_load_dis(str(path)).build_topology()
    assert want.grid_shape is None and got.grid_shape is None
    for name in ("edge_n", "edge_m", "ihc", "cl1", "cl2", "hwva", "nbr"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert (got.edge_m - got.edge_n == 60).any()     # layer 1 to layer 3


def test_load_simulation_runs_on_the_card_unless_asked(tmp_path):
    """Without a CUDA device and without device="cpu" the entry points
    raise; they do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    build_arrays_deck(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_simulation(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        simulation_from_reference({})
    from modflow6_torch.__main__ import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main([str(tmp_path)])


@pytest.mark.parametrize("component", sorted(
    ["sim-nam", "sim-tdis", "sln-ims", "gwf-nam", "gwf-dis", "gwf-ic",
     "gwf-npf", "gwf-sto", "gwf-chd", "gwf-wel", "gwf-rch", "gwf-rcha",
     "gwf-oc", "gwf-buy", "gwf-csub", "gwf-maw", "gwf-lak", "gwf-sfr",
     "utl-laktab", "utl-sfrtab", "gwf-uzf", "gwf-mvr", "exg-gwfgwf"]))
def test_schema_component_is_the_reference(component):
    assert schema.load_schema()[component] == ref_schema.load_schema()[
        component]


def test_schema_holds_only_the_loaded_components():
    assert len(schema.load_schema()) == 72


# ------------------------------------------------------------- deck runs

def test_npf01b_matches_reference(npf01b):
    ref, port, _, _ = npf01b
    assert _steps(port.records) == _steps(ref.records)
    assert len(port.records) == 12 and all(r.converged for r in port.records)
    for g, w in zip(port.records, ref.records):
        assert g.totim == w.totim
        np.testing.assert_allclose(g.head, w.head, rtol=0, atol=1e-10)


def test_npf01b_through_convert_matches_both(npf01b, tmp_path):
    """Loader and solver apart: the reference's loader → convert → the
    port's run equals the port's loader → the port's run, bitwise, and the
    reference's run at 1e-10."""
    ref, port, _, _ = npf01b
    state = simulation_state(ref)
    assert_same_state(simulation_state(port), state)
    conv = simulation_from_reference(state, device="cpu")
    recs = conv.run()
    assert _steps(recs) == _steps(port.records) == _steps(ref.records)
    for c, g, w in zip(recs, port.records, ref.records):
        np.testing.assert_array_equal(c.head, g.head)
        np.testing.assert_allclose(c.head, w.head, rtol=0, atol=1e-10)


def _port_matrix(model, diag, off):
    shape = model.dtopo.grid_shape
    n = model.nodes
    idx = np.arange(n).reshape(shape)
    rows, cols, vals = [np.arange(n)], [np.arange(n)], [diag.numpy()]
    off = off.numpy()
    slots = ((2, +1), (2, -1), (1, -1), (1, +1), (0, -1), (0, +1))
    for slot, (axis, d) in enumerate(slots):
        nbr = np.full(shape, -1)
        src, dst = [slice(None)] * 3, [slice(None)] * 3
        src[axis] = slice(1, None) if d > 0 else slice(None, -1)
        dst[axis] = slice(None, -1) if d > 0 else slice(1, None)
        nbr[tuple(dst)] = idx[tuple(src)]
        nbr = nbr.reshape(-1)
        keep = nbr >= 0
        rows.append(np.arange(n)[keep])
        cols.append(nbr[keep])
        vals.append(off[keep, slot])
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))),
                         shape=(n, n))


def test_npf01b_75x75_vs_direct_and_golden(tmp_path):
    """Confined case at full size through the port alone: every step is a
    linear solve, so scipy direct solves of the port's own assembled system
    are an exact oracle; then the pinned golden heads."""
    build_npf01(str(tmp_path), "b")
    sim = load(tmp_path)
    recs = sim.run()
    assert all(r.converged for r in recs)
    model = sim.model
    head = model.strt
    for rec, (kper, kstp, delt, _, _) in zip(recs, sim.tdis.walk()):
        pkgs = sim.period_packages(kper)
        iss = not sim.transient[kper - 1]
        ib, h = model.boundary_state(head, pkgs)
        diag, off, rhs = model.assemble(h, h, ib, delt, iss, pkgs)
        diag, off, rhs = apply_dirichlet_structured(
            model.dtopo.grid_shape, torch.sign(ib), diag, off, rhs, h)
        x = spla.spsolve(_port_matrix(model, diag, off).tocsc(), rhs.numpy())
        np.testing.assert_allclose(rec.head, x, atol=2e-5)
        head = torch.as_tensor(x, dtype=torch.float64)
    np.testing.assert_allclose(
        recs[-1].head, np.load(os.path.join(GOLDEN, "npf01b_final.npy")),
        atol=1e-3)


def test_npf01a_matches_reference(npf01a):
    ref, port, _ = npf01a
    assert len(port.records) == 12
    assert all(r.converged for r in port.records)
    print("npf01a 21x21 (outer, inner) per step: reference",
          [(r.outer, r.inner) for r in ref.records], "port",
          [(r.outer, r.inner) for r in port.records])
    for g, w in zip(port.records, ref.records):
        assert g.outer == w.outer
        assert abs(g.inner - w.inner) <= 0.1 * w.inner
        np.testing.assert_allclose(g.head, w.head, rtol=0, atol=1e-6)


def _torch_order_dot(a, b):
    """The reference's dot product with its sum taken by torch.sum."""
    return jnp.asarray(torch.sum(torch.from_numpy(np.array(a * b))).numpy())


def test_npf01a_first_step_counts_at_one_sum_order(npf01a, monkeypatch):
    """Why the inner counts of npf01a's first step differ (179 in the port,
    171 in the jitted reference where this was written): BiCGSTAB on the
    unconfined system amplifies the rounding of its dot products.  With the
    reference run op by op and its sums taken in PyTorch's order the step
    has the port's counts and its heads within 1e-10."""
    _, port, ws = npf01a
    monkeypatch.setitem(jkrylov.bicgstab.__kwdefaults__, "dot",
                        _torch_order_dot)
    stencil_in_torch(monkeypatch)
    ref = ref_load(str(ws))
    with jax.disable_jit():
        head, info, _ = ref.solve_step(jnp.asarray(ref.model.strt), 1, 1, 1.0)
    rec = port.records[0]
    assert (info.outer_iterations, info.inner_iterations) == (rec.outer,
                                                              rec.inner)
    np.testing.assert_allclose(rec.head, np.asarray(head), rtol=0, atol=1e-10)


def test_npf01a_75x75_golden(tmp_path):
    build_npf01(str(tmp_path), "a")
    recs = load(tmp_path).run()
    assert all(r.converged for r in recs)
    np.testing.assert_allclose(
        recs[-1].head, np.load(os.path.join(GOLDEN, "npf01a_final.npy")),
        atol=1e-3)


def test_deck_run_on_cpu_launches_no_kernel(tmp_path):
    build_npf01(str(tmp_path), "b", 9, 9)
    before = launches["stencil7"]
    recs = load(tmp_path).run()
    assert all(r.converged for r in recs)
    assert launches["stencil7"] == before


# ---------------------------------------------------------- output files

def _assert_same_output_files(refdir, portdir, stem, model):
    """The reference's readers read the port's files; every record equals
    the reference's run's.  ``model``: the port's, for its storage
    capacity."""
    sto = model.sto_arrays
    capacity = float((sto.area * (sto.ss * (sto.top - sto.bot) + sto.sy)
                      ).max())
    whds = ref_read_heads(str(refdir / f"{stem}.hds"))
    ghds = ref_read_heads(str(portdir / f"{stem}.hds"))
    assert len(ghds) == len(whds) > 0
    for g, w in zip(ghds, whds):
        for key in ("kstp", "kper", "pertim", "totim", "text", "ilay"):
            assert g[key] == w[key], key
        assert g["data"].shape == w["data"].shape
        np.testing.assert_allclose(g["data"], w["data"], rtol=0, atol=1e-10)
    wcbc = ref_read_budget(str(refdir / f"{stem}.cbc"))
    gcbc = ref_read_budget(str(portdir / f"{stem}.cbc"))
    assert [r["text"] for r in gcbc] == [r["text"] for r in wcbc]
    assert {"FLOW-JA-FACE", "STO-SS", "CHD", "WEL"} <= {r["text"]
                                                        for r in gcbc}
    for g, w in zip(gcbc, wcbc):
        for key in ("kstp", "kper", "text", "imeth", "delt", "pertim",
                    "totim"):
            assert g[key] == w[key], key
        if g["imeth"] == 1:
            assert g["data"].shape == w["data"].shape
            scale = np.abs(w["data"]).max()
            np.testing.assert_allclose(g["data"], w["data"], rtol=0,
                                       atol=1e-9 * scale)
        else:
            for key in ("modelname", "pakname", "model2name", "pak2name",
                        "auxtxt"):
                assert g[key] == w[key], key
            np.testing.assert_array_equal(g["data"][0], w["data"][0])
            np.testing.assert_array_equal(g["data"][1], w["data"][1])
            atol = 1e-9 * np.abs(w["data"][2]).max(initial=1e-30)
            if g["text"].startswith("STO-"):
                # a storage rate is capacity/delt times a head change, so
                # it carries the heads' spread times that factor whatever
                # its own size: heads that agree to 1e-12 (bar 1e-10)
                atol = max(atol, 1e-12 * capacity / g["delt"])
            np.testing.assert_allclose(g["data"][2], w["data"][2], rtol=0,
                                       atol=atol)
    assert (portdir / f"{stem}.grb").read_bytes() == (
        refdir / f"{stem}.grb").read_bytes()


def test_output_files_match_reference(npf01b):
    ref, port, refdir, portdir = npf01b
    _assert_same_output_files(refdir, portdir, "o", port.model)
    # the port's own readers give what the reference's give
    for mine, theirs in zip(read_head_file(portdir / "o.hds"),
                            ref_read_heads(str(portdir / "o.hds"))):
        assert mine.keys() == theirs.keys()
        np.testing.assert_array_equal(mine["data"], theirs["data"])
    for mine, theirs in zip(read_budget_file(portdir / "o.cbc"),
                            ref_read_budget(str(portdir / "o.cbc"))):
        assert mine.keys() == theirs.keys()
        if mine["imeth"] == 1:
            np.testing.assert_array_equal(mine["data"], theirs["data"])
        else:
            for a, b in zip(mine["data"][:3], theirs["data"][:3]):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype


def test_budget_table_matches_reference(npf01b):
    ref, port, refdir, portdir = npf01b
    assert list(port.budget.terms) == list(ref.budget.terms)
    for name, w in ref.budget.terms.items():
        g = port.budget.terms[name]
        # a term's IN or OUT is a sum of per-cell rates of either sign
        # around zero in a steady period: held to the size of the totals
        for field, scale in (("rate_in", 1.0), ("rate_out", 1.0),
                             ("cum_in", 1001.0), ("cum_out", 1001.0)):
            np.testing.assert_allclose(
                getattr(g, field), getattr(w, field), rtol=1e-9,
                atol=1e-12 * scale * ref.budget.total_in, err_msg=name)
    np.testing.assert_allclose(port.budget.total_in, ref.budget.total_in,
                               rtol=1e-9)
    np.testing.assert_allclose(port.budget.total_out, ref.budget.total_out,
                               rtol=1e-9)
    assert abs(port.budget.percent_discrepancy()) < 0.01
    glst = (portdir / "o.lst").read_text()
    wlst = (refdir / "o.lst").read_text()
    assert glst.count("VOLUME BUDGET") == wlst.count("VOLUME BUDGET") == 12
    # the first budget table: same title, terms and layout
    gtab = glst[glst.index("VOLUME BUDGET"):].splitlines()[:7]
    wtab = wlst[wlst.index("VOLUME BUDGET"):].splitlines()[:7]
    assert [line[:16] for line in gtab] == [line[:16] for line in wtab]
    # the port's listing also carries the iteration counts of each step
    rec = port.records[0]
    assert (f" {rec.outer} CALLS TO NUMERICAL SOLUTION IN TIME STEP 1 STRESS "
            f"PERIOD 1\n {rec.inner} TOTAL ITERATIONS\n") in glst


def test_edge_flows_match_reference(npf01a):
    """Face flows laid out in the reference's edge order, and their CSR
    expansion, on the unconfined model's final heads."""
    ref, port, _ = npf01a
    head = ref.records[-1].head
    pkgs = ref.period_packages(3)
    ib, h = ref.model.boundary_state(jnp.asarray(head), pkgs)
    want = np.asarray(ref.model.edge_flows(h, ib, pkgs=pkgs))
    tpk = port.period_packages(3)
    tib, th = port.model.boundary_state(
        torch.tensor(head, dtype=torch.float64), tpk)
    got = port.model.edge_flows(th, tib, pkgs=tpk).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    np.testing.assert_array_equal(port.model.topo.edge_n,
                                  ref.model.topo.edge_n)
    np.testing.assert_allclose(
        port.model.flowja_csr(th, tib, pkgs=tpk).numpy(),
        ref._flowja_csr(want), rtol=0, atol=1e-12 * scale)
    into = np.zeros(ref.model.nodes)
    np.add.at(into, ref.model.topo.edge_n, want)
    np.add.at(into, ref.model.topo.edge_m, -want)
    np.testing.assert_allclose(port.model.cell_inflow(th, tib).numpy(), into,
                               rtol=0, atol=1e-11 * scale)


def test_host_writers_match_reference(tmp_path):
    """The numpy copies of the budget table and the outer-iteration CSV give
    what the reference's give on the same input."""
    from modflow6_tpu.solution.ims import SolveInfo as RefSolveInfo
    from modflow6_tpu.utils.budget import Budget as RefBudget
    from modflow6_tpu.utils.csvout import OuterCsvWriter as RefOuterCsv
    from modflow6_torch.solution import SolveInfo
    from modflow6_torch.utils.budget import Budget
    from modflow6_torch.utils.csvout import OuterCsvWriter
    rng = np.random.default_rng(4)
    mine, theirs = Budget(), RefBudget()
    for delt in (1.0, 2.5):
        for name, n in (("WEL", 3), ("RCH", 40), ("CHD", 0)):
            rates = rng.normal(0.0, 5.0, n)
            mine.add_entries(name, rates, delt)
            theirs.add_entries(name, list(rates), delt)
    for name, w in theirs.terms.items():
        for field in ("rate_in", "rate_out", "cum_in", "cum_out"):
            np.testing.assert_allclose(getattr(mine.terms[name], field),
                                       getattr(w, field), rtol=1e-13)
    assert mine.table("T") == theirs.table("T")
    args = (True, 3, 41, 2e-9, [-1.5, 3e-4, 2e-9])
    for cls, info, name in ((OuterCsvWriter, SolveInfo(*args), "a.csv"),
                            (RefOuterCsv, RefSolveInfo(*args), "b.csv")):
        w = cls(str(tmp_path / name))
        w.write_step(1.0, 1, 1, info)
        w.write_step(3.5, 2, 4, info)
        w.close()
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()
    assert len((tmp_path / "a.csv").read_text().splitlines()) == 7


# ------------------------------------------------------------------- CLI

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "modflow6_torch", *map(str, args)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300)


def test_cli_runs_a_deck_on_the_cpu(tmp_path):
    build_npf01(str(tmp_path), "b", 21, 21)
    lst = tmp_path / "run.lst"
    proc = _cli(tmp_path, "--device", "cpu", "--lst", lst)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("Normal termination of simulation (")
    assert proc.stdout.rstrip().endswith("12 steps)")
    assert lst.read_text().count("VOLUME BUDGET") == 12


def test_cli_validate_loads_only(tmp_path):
    build_arrays_deck(tmp_path)
    proc = _cli(tmp_path, "-m", "validate", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ("mf6torch: model input validated "
                                   "(60 nodes, 2 periods)")
    assert not (tmp_path / "arr.grb").exists()
    # validate mode rejects a keyword that is not in the MF6 spec
    path = tmp_path / "m.npf"
    path.write_text(path.read_text().replace("  PERCHED\n",
                                             "  PERCHED\n  PERCHD\n"))
    proc = _cli(tmp_path, "-m", "validate", "--device", "cpu")
    assert proc.returncode != 0
    assert "PERCHD" in proc.stderr


def test_cli_version_and_default_device(tmp_path):
    proc = _cli("-v")
    assert proc.returncode == 0 and proc.stdout.startswith("modflow6-torch ")
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    build_npf01(str(tmp_path), "b", 9, 9)
    proc = _cli(tmp_path)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "Normal termination" not in proc.stdout


def _starve(tmp_path, continue_option):
    """npf01a with one outer iteration allowed: no step can converge."""
    build_npf01(str(tmp_path), "a", 9, 9)
    write(str(tmp_path), "sim.ims", ims_text("BICGSTAB", nouter=1))
    if continue_option:
        path = tmp_path / "mfsim.nam"
        path.write_text("BEGIN OPTIONS\n  CONTINUE\nEND OPTIONS\n"
                        + path.read_text())


def test_cli_nonconvergence_returns_1(tmp_path):
    _starve(tmp_path, continue_option=False)
    proc = _cli(tmp_path, "--device", "cpu", "--lst", tmp_path / "o.lst")
    assert proc.returncode == 1
    assert "Premature termination" in proc.stderr
    assert "Normal termination" not in proc.stdout
    assert "NONCONVERGENCE kper=1 kstp=1" in (tmp_path / "o.lst").read_text()
    with pytest.raises(ConvergenceFailure, match="kper=1 kstp=1"):
        load(tmp_path).run()


def test_cli_continue_runs_on(tmp_path):
    _starve(tmp_path, continue_option=True)
    proc = _cli(tmp_path, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "Normal termination of simulation" in proc.stdout
    assert "convergence failure occurred" in proc.stderr
    recs = load(tmp_path).run()
    assert len(recs) == 12 and not recs[0].converged
