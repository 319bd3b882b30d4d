"""GWF6 + PRT6 decks through the port's loader (``_load_prt_model`` and the
``Simulation`` hook) against the reference's: the three PRT cases of
tests/test_gwe_prt_decks.py, a deck with a GWF6-PRT6 exchange entry, TRACK
and TRACKCSV files and a PRP6 list of many release points, and the
refusals (R24–R31).

Bars: the tests' own (positions 1e-10 / 1e-7 / 1e-6, travel times 1e-12);
against the reference's run of the same deck (each package solving its
own flow, at closures near double precision), the track files' float
fields within 1e-9 relative (tests/test_prt.py's swarm bar), the integer
fields (statuses, cells, layers, reasons) and the CSV's layout equal.
"""

import os

import numpy as np
import pytest

from test_gwe_prt_decks import _common, _gwf_files, write
from modflow6_tpu.models.prt import trackfile as jtf
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.__main__ import main as cli_main
from modflow6_torch.models.prt import trackfile as tf
from modflow6_torch.models.prt.simulation import TERM_STOPTIME
from modflow6_torch.utils.mf6io import load_simulation

Q, K, THETA = 0.5, 10.0, 0.25


def prt_files(ws, prp, dis="part.dis", oc=""):
    write(ws, "part.nam", f"""
BEGIN OPTIONS
END OPTIONS
BEGIN PACKAGES
  {"DISV6" if dis.endswith("disv") else "DIS6"} {dis} dis
  MIP6 part.mip mip
  PRP6 part.prp prp
{oc}END PACKAGES
""")
    write(ws, "part.mip", f"""
BEGIN OPTIONS
END OPTIONS
BEGIN GRIDDATA
  POROSITY CONSTANT {THETA}
END GRIDDATA
""")
    write(ws, "part.prp", prp)


def uniform_deck(ws, ncol=20, perlen="4.0 1 1.0", prp=None):
    """tests/test_gwe_prt_decks.py:test_prt_deck_uniform_flow's deck."""
    _common(ws, "  GWF6 flow.nam m1\n  PRT6 part.nam p1", perlen=perlen)
    _gwf_files(ws, ncol=ncol, h_left=10.0 + Q * (ncol - 1) / K,
               h_right=10.0, k=K)
    write(ws, "part.dis", open(os.path.join(ws, "flow.dis")).read())
    prt_files(ws, prp or """
BEGIN OPTIONS
  TRACKCSV FILEOUT part.trk.csv
END OPTIONS
BEGIN DIMENSIONS
  NRELEASEPTS 1
  NRELEASETIMES 0
END DIMENSIONS
BEGIN PACKAGEDATA
  1 1 1 3 2.5 0.5 0.5
END PACKAGEDATA
BEGIN PERIOD 1
  FIRST
END PERIOD
""")


def stop_deck(ws):
    """test_prt_deck_release_times_and_stop's deck."""
    uniform_deck(ws, ncol=40, perlen="4.0 2 1.0", prp="""
BEGIN OPTIONS
  STOPTIME 3.5
END OPTIONS
BEGIN DIMENSIONS
  NRELEASEPTS 1
  NRELEASETIMES 1
END DIMENSIONS
BEGIN PACKAGEDATA
  1 1 1 3 2.5 0.5 0.5
END PACKAGEDATA
BEGIN RELEASETIMES
  1.0
END RELEASETIMES
""")


def disv_deck(ws):
    """test_prt_disv_deck_uniform_flow's deck."""
    _common(ws, "  GWF6 flow.nam m1\n  PRT6 part.nam p1", perlen="4.0 1 1.0")
    nrow, ncol = 3, 12
    dh = Q * (ncol - 1) / K
    w = ncol + 1
    verts = "\n".join(f"  {r * w + c + 1} {c}.0 {nrow - r}.0"
                      for r in range(nrow + 1) for c in range(ncol + 1))
    cells = "\n".join(
        f"  {r * ncol + c + 1} {c + 0.5} {nrow - r - 0.5} 4 "
        f"{r * w + c + 1} {r * w + c + 2} {(r + 1) * w + c + 2} "
        f"{(r + 1) * w + c + 1}" for r in range(nrow) for c in range(ncol))
    disv = f"""
BEGIN OPTIONS
END OPTIONS
BEGIN DIMENSIONS
  NCPL {nrow * ncol}
  NLAY 1
  NVERT {(nrow + 1) * (ncol + 1)}
END DIMENSIONS
BEGIN GRIDDATA
  TOP CONSTANT 1.0
  BOTM CONSTANT 0.0
END GRIDDATA
BEGIN VERTICES
{verts}
END VERTICES
BEGIN CELL2D
{cells}
END CELL2D
"""
    write(ws, "flow.disv", disv)
    write(ws, "part.disv", disv)
    write(ws, "flow.nam", "BEGIN PACKAGES\n  DISV6 flow.disv dis\n"
          "  IC6 flow.ic ic\n  NPF6 flow.npf npf\n  CHD6 flow.chd chd\n"
          "END PACKAGES\n")
    write(ws, "flow.ic", "BEGIN GRIDDATA\n  STRT CONSTANT 10.0\n"
          "END GRIDDATA\n")
    write(ws, "flow.npf", f"BEGIN GRIDDATA\n  ICELLTYPE CONSTANT 0\n"
          f"  K CONSTANT {K}\nEND GRIDDATA\n")
    rows = "\n".join([f"  1 {r * ncol + 1} {10.0 + dh}" for r in range(nrow)]
                     + [f"  1 {r * ncol + ncol} 10.0" for r in range(nrow)])
    write(ws, "flow.chd", f"BEGIN DIMENSIONS\n  MAXBOUND {2 * nrow}\n"
          f"END DIMENSIONS\nBEGIN PERIOD 1\n{rows}\nEND PERIOD\n")
    prt_files(ws, """
BEGIN DIMENSIONS
  NRELEASEPTS 1
  NRELEASETIMES 0
END DIMENSIONS
BEGIN PACKAGEDATA
  1 1 3 2.5 1.5 0.5
END PACKAGEDATA
BEGIN PERIOD 1
  FIRST
END PERIOD
""", dis="part.disv")


def swarm_deck(ws, options="  TRACK FILEOUT part.trk\n"
               "  TRACKCSV FILEOUT part.csv\n", oc=""):
    """A 2 × 6 × 30 model with a well, three steps, 180 release points at
    two release times and a GWF6-PRT6 exchange entry (which the reference
    never opens)."""
    nrow, ncol = 6, 30
    _common(ws, "  GWF6 flow.nam m1\n  PRT6 part.nam p1", perlen="9.0 3 1.0")
    text = open(os.path.join(ws, "mfsim.nam")).read().replace(
        "BEGIN EXCHANGES\nEND EXCHANGES",
        "BEGIN EXCHANGES\n  GWF6-PRT6 flow.gwfprt m1 p1\nEND EXCHANGES")
    write(ws, "mfsim.nam", text)
    # closures near double precision: both packages' heads agree to the
    # last bits, so the tracks can be held at the swarm test's 1e-9
    write(ws, "sim.ims", "BEGIN NONLINEAR\n  OUTER_DVCLOSE 1.0e-12\n"
          "  OUTER_MAXIMUM 50\nEND NONLINEAR\nBEGIN LINEAR\n"
          "  INNER_MAXIMUM 1000\n  INNER_DVCLOSE 1.0e-14\n"
          "  INNER_RCLOSE 1.0e-13\nEND LINEAR\n")
    write(ws, "flow.nam", "BEGIN PACKAGES\n  DIS6 flow.dis dis\n"
          "  IC6 flow.ic ic\n  NPF6 flow.npf npf\n  CHD6 flow.chd chd\n"
          "  WEL6 flow.wel wel\nEND PACKAGES\n")
    dis = f"""
BEGIN DIMENSIONS
  NLAY 2
  NROW {nrow}
  NCOL {ncol}
END DIMENSIONS
BEGIN GRIDDATA
  DELR CONSTANT 1.0
  DELC CONSTANT 1.0
  TOP CONSTANT 2.0
  BOTM LAYERED
    CONSTANT 1.0
    CONSTANT 0.0
END GRIDDATA
"""
    write(ws, "flow.dis", dis)
    write(ws, "part.dis", dis)
    write(ws, "flow.ic", "BEGIN GRIDDATA\n  STRT CONSTANT 10.0\n"
          "END GRIDDATA\n")
    rng = np.random.default_rng(4)
    kvals = " ".join(f"{v:.6f}" for v in np.exp(rng.normal(
        2.0, 0.5, 2 * nrow * ncol)))
    write(ws, "flow.npf", "BEGIN GRIDDATA\n  ICELLTYPE CONSTANT 0\n"
          f"  K\n    INTERNAL\n      {kvals}\nEND GRIDDATA\n")
    rows = [f"{lay} {r + 1} 1 12.0" for lay in (1, 2) for r in range(nrow)] \
        + [f"{lay} {r + 1} {ncol} 10.0" for lay in (1, 2)
           for r in range(nrow)]
    write(ws, "flow.chd", f"BEGIN DIMENSIONS\n  MAXBOUND {len(rows)}\n"
          "END DIMENSIONS\nBEGIN PERIOD 1\n"
          + "\n".join(f"  {r}" for r in rows) + "\nEND PERIOD\n")
    write(ws, "flow.wel", "BEGIN DIMENSIONS\n  MAXBOUND 1\nEND DIMENSIONS\n"
          f"BEGIN PERIOD 1\n  2 {nrow // 2} {ncol // 2} -3.0\nEND PERIOD\n")
    n = 180
    x = rng.uniform(1.0, ncol - 1.0, n).tolist()
    y = rng.uniform(0.05, nrow - 0.05, n).tolist()
    z = rng.uniform(0.05, 0.95, n).tolist()
    pkg = "\n".join(
        f"  {i + 1} 1 {int(nrow - y[i]) + 1} {int(x[i]) + 1} {x[i]!r} "
        f"{y[i]!r} {z[i]!r}" for i in range(n))
    prt_files(ws, f"""
BEGIN OPTIONS
{options}  LOCAL_Z
END OPTIONS
BEGIN DIMENSIONS
  NRELEASEPTS {n}
  NRELEASETIMES 1
END DIMENSIONS
BEGIN PACKAGEDATA
{pkg}
END PACKAGEDATA
BEGIN RELEASETIMES
  4.5
END RELEASETIMES
BEGIN PERIOD 1
  FIRST
END PERIOD
""", oc=oc)


def run_both(ws):
    port = load_simulation(ws, device="cpu")
    port.run()
    ref = ref_load(ws)
    ref.run()
    return port.prt_drivers[0], ref.prt_drivers[0]


def test_prt_deck_uniform_flow(tmp_path):
    ws = str(tmp_path)
    uniform_deck(ws)
    drv, jdrv = run_both(ws)
    v = Q / THETA
    np.testing.assert_allclose(drv.x.numpy(), 2.5 + v * 4.0, rtol=1e-10)
    np.testing.assert_allclose(drv.y.numpy(), 0.5, atol=1e-12)
    np.testing.assert_allclose(drv.ttrack, 4.0, rtol=1e-12)
    lines = open(os.path.join(ws, "part.trk.csv")).read().splitlines()
    assert lines[0] == tf.TRACK_HEADER and len(lines) >= 2
    np.testing.assert_allclose(float(lines[-1].split(",")[12]),
                               2.5 + v * 4.0, rtol=1e-10)
    np.testing.assert_array_equal(drv.status, jdrv.status)


def test_prt_deck_release_times_and_stop(tmp_path):
    ws = str(tmp_path)
    stop_deck(ws)
    drv, jdrv = run_both(ws)
    np.testing.assert_allclose(drv.trelease, [1.0])
    np.testing.assert_allclose(drv.x.numpy(), 2.5 + Q / THETA * 2.5,
                               rtol=1e-7)
    assert int(drv.status[0]) == int(jdrv.status[0]) == TERM_STOPTIME


def test_prt_disv_deck_uniform_flow(tmp_path):
    ws = str(tmp_path)
    disv_deck(ws)
    drv, jdrv = run_both(ws)
    assert drv.is_disv
    np.testing.assert_allclose(drv.x.numpy(), 2.5 + Q / THETA * 4.0,
                               rtol=1e-6)
    np.testing.assert_allclose(drv.y.numpy(), 1.5, atol=1e-9)
    np.testing.assert_allclose(drv.x.numpy(), np.asarray(jdrv.x), rtol=1e-9)


def test_swarm_deck_and_track_files_match_reference(tmp_path):
    """180 points, two release times, LOCAL_Z, a well and three steps, with
    TRACK and TRACKCSV files, through the CLI and the reference's loader:
    the records' fields equal (floats within 1e-9 relative)."""
    ws = str(tmp_path)
    swarm_deck(ws)
    assert cli_main([ws, "--device", "cpu"]) == 0
    got = tf.read_track_file(os.path.join(ws, "part.trk"))
    csv = open(os.path.join(ws, "part.csv")).read().splitlines()
    ref = ref_load(ws)
    ref.run()
    want = jtf.read_track_file(os.path.join(ws, "part.trk"))
    jcsv = open(os.path.join(ws, "part.csv")).read().splitlines()
    assert got.shape == want.shape and len(got) == 180 + 2 * 360
    for name in jtf.TRACK_DTYPE.names:
        if got.dtype[name].kind == "f":
            np.testing.assert_allclose(got[name], want[name], rtol=1e-9,
                                       atol=1e-12, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
    assert len(csv) == len(jcsv) and csv[0] == jcsv[0]
    for a, b in zip(csv[1:], jcsv[1:]):
        fa, fb = a.split(","), b.split(",")
        assert fa[:10] == fb[:10]
        np.testing.assert_allclose([float(v) for v in fa[10:15]],
                                   [float(v) for v in fb[10:15]], rtol=1e-9,
                                   atol=1e-12)
    assert len(set(got["istatus"].tolist())) > 1


REFUSED = {name: f"  {name} {value}\n" for name, value in (
    ("STOPTRAVELTIME", "2.0"), ("EXTEND_TRACKING", ""), ("DRAPE", ""),
    ("STOP_AT_WEAK_SINK", ""), ("DRY_TRACKING_METHOD", "STAY"),
    ("RELEASE_TIME_FREQUENCY", "1.0"), ("EXIT_SOLVE_TOLERANCE", "1e-6"))}
RNUMBERS = dict(zip(REFUSED, ("R24", "R25", "R26", "R27", "R28", "R29",
                              "R30")))


@pytest.mark.parametrize("option", list(REFUSED))
def test_prp_options_the_reference_reads_past_are_refused(option, tmp_path):
    """R24–R30: each option changes the tracks in MODFLOW 6; the
    reference's loader reads it past and loads."""
    ws = str(tmp_path)
    swarm_deck(ws, options=REFUSED[option])
    assert ref_load(ws).prt_drivers
    with pytest.raises(NotImplementedError, match=RNUMBERS[option]):
        load_simulation(ws, device="cpu")


def test_prt_oc_and_multi_model_refusals(tmp_path):
    """R31: a PRT OC6 file's track options, which the reference's loader
    never reads; as the reference: PRT6 beside several GWF6 models."""
    ws = str(tmp_path)
    swarm_deck(ws, oc="  OC6 part.oc oc\n")
    write(ws, "part.oc", "BEGIN OPTIONS\n  TRACK FILEOUT oc.trk\n"
          "  TRACK_TIMESTEP\nEND OPTIONS\n")
    assert ref_load(ws).prt_drivers
    with pytest.raises(NotImplementedError, match="R31"):
        load_simulation(ws, device="cpu")
    ws2 = str(tmp_path / "two")
    os.makedirs(ws2)
    uniform_deck(ws2)
    text = open(os.path.join(ws2, "mfsim.nam")).read().replace(
        "  GWF6 flow.nam m1\n", "  GWF6 flow.nam m1\n  GWF6 flow.nam m2\n")
    write(ws2, "mfsim.nam", text.replace(
        "BEGIN EXCHANGES\nEND EXCHANGES",
        "BEGIN EXCHANGES\n  GWF6-GWF6 none.exg m1 m2\nEND EXCHANGES"))
    with pytest.raises(NotImplementedError, match="PRT6 beside several"):
        load_simulation(ws2, device="cpu")
