"""CHF6/OLF6 decks through the port's loader (modflow6_torch/utils/mf6io/
swf_loader.py) against the reference's (modflow6_tpu/utils/mf6io/
swf_loader.py): the three decks of tests/test_swf_decks.py, a branching
DISV1D network and a DISV2D raster, the DISV1D reach builder against the
reference's loops, the CLI, and the refusals.

Bars: the loaded models equal (arrays bitwise); the runs within 10 ×
outer_dvclose of the reference's at every step, every step converged; the
STAGE files' records alike.  The decks run the first 6 of their 60
steps; tests/test_torch_swf.py holds the port to the steady-state oracle.
"""

import os

import numpy as np
import pytest
import torch

from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_tpu.utils.mf6io import swf_loader as jswf_loader
from modflow6_torch.__main__ import main as cli_main
from modflow6_torch.utils.binary import read_head_file
from modflow6_torch.utils.mf6io import load_simulation
from modflow6_torch.utils.mf6io import swf_loader

STAGE_BAR = 1e-7     # 10 × the decks' OUTER_DVCLOSE


def write(ws, name, text):
    with open(os.path.join(ws, name), "w") as f:
        f.write(text + "\n")


def sim_files(ws, mtype, mfile, perioddata="1200.0 6 1.0", models=None):
    """tests/test_swf_decks.py:_sim_files with its TDIS cut to the first 6
    of its 200-s steps."""
    write(ws, "mfsim.nam", f"""
BEGIN OPTIONS
END OPTIONS
BEGIN TIMING
  TDIS6 sim.tdis
END TIMING
BEGIN MODELS
  {models or f"{mtype} {mfile} chan"}
END MODELS
BEGIN SOLUTIONGROUP 1
  IMS6 sim.ims chan
END SOLUTIONGROUP
""")
    write(ws, "sim.tdis", f"""
BEGIN OPTIONS
END OPTIONS
BEGIN DIMENSIONS
  NPER 1
END DIMENSIONS
BEGIN PERIODDATA
  {perioddata}
END PERIODDATA
""")
    write(ws, "sim.ims", """
BEGIN OPTIONS
END OPTIONS
BEGIN NONLINEAR
  OUTER_DVCLOSE 1.0e-8
  OUTER_MAXIMUM 300
END NONLINEAR
BEGIN LINEAR
  INNER_MAXIMUM 500
  INNER_DVCLOSE 1.0e-10
  INNER_RCLOSE 1.0e-9
  LINEAR_ACCELERATION BICGSTAB
END LINEAR
""")


def disv1d(ws, name, nreach, dx, width_line, bot_lines, cells=None,
           nvert=None, verts=None, idomain=""):
    verts = verts or "\n".join(f"  {i + 1} {i * dx} 0.0"
                               for i in range(nreach + 1))
    cells = cells or "\n".join(f"  {i + 1} 0.5 2 {i + 1} {i + 2}"
                               for i in range(nreach))
    write(ws, name, f"""
BEGIN OPTIONS
END OPTIONS
BEGIN DIMENSIONS
  NODES {nreach}
  NVERT {nvert or nreach + 1}
END DIMENSIONS
BEGIN GRIDDATA
  WIDTH
{width_line}
  BOTTOM
{bot_lines}{idomain}
END GRIDDATA
BEGIN VERTICES
{verts}
END VERTICES
BEGIN CELL1D
{cells}
END CELL1D
""")


def list_file(ws, name, rows, options=""):
    write(ws, name, f"""
BEGIN OPTIONS
{options}END OPTIONS
BEGIN DIMENSIONS
  MAXBOUND {len(rows)}
END DIMENSIONS
BEGIN PERIOD 1
""" + "\n".join(f"  {r}" for r in rows) + """
END PERIOD
""")


def chf_normal_depth_deck(ws, dfw_options="  CENTRAL_IN_SPACE\n", flw_opts=""):
    """tests/test_swf_decks.py:test_chf_deck_normal_depth's deck."""
    nreach, dx, width, s0, nman, qin = 20, 100.0, 5.0, 1e-3, 0.03, 2.0
    bot = np.arange(nreach)[::-1] * dx * s0
    dn = (qin * nman / (width * np.sqrt(s0))) ** 0.6
    sim_files(ws, "CHF6", "chan.nam")
    write(ws, "chan.nam", """
BEGIN OPTIONS
END OPTIONS
BEGIN PACKAGES
  DISV1D6 chan.disv1d
  DFW6 chan.dfw
  STO6 chan.sto
  IC6 chan.ic
  FLW6 chan.flw
  ZDG6 chan.zdg
  OC6 chan.oc
END PACKAGES
""")
    disv1d(ws, "chan.disv1d", nreach, dx, f"    CONSTANT {width}",
           "    INTERNAL\n      " + " ".join(str(b) for b in bot))
    write(ws, "chan.dfw", f"""
BEGIN OPTIONS
{dfw_options}END OPTIONS
BEGIN GRIDDATA
  MANNINGSN
    CONSTANT {nman}
  IDCXS
    CONSTANT 0
END GRIDDATA
""")
    write(ws, "chan.sto", "BEGIN OPTIONS\nEND OPTIONS\nBEGIN PERIOD 1\n"
          "  TRANSIENT\nEND PERIOD\n")
    write(ws, "chan.ic", "BEGIN OPTIONS\nEND OPTIONS\nBEGIN GRIDDATA\n"
          "  STRT\n    INTERNAL\n      "
          + " ".join(f"{s:.8f}" for s in bot + 0.5 * dn) + "\nEND GRIDDATA\n")
    list_file(ws, "chan.flw", [f"1 {qin}"], flw_opts)
    list_file(ws, "chan.zdg", [f"{nreach} 0 {width} {s0} {nman}"])
    write(ws, "chan.oc", """
BEGIN OPTIONS
  STAGE FILEOUT chan.stage
END OPTIONS
BEGIN PERIOD 1
  SAVE STAGE LAST
END PERIOD
""")
    return bot, dn


def olf_plane_deck(ws):
    """tests/test_swf_decks.py:test_olf_deck_plane's deck."""
    nrow, ncol, dx, s0, nman = 4, 8, 10.0, 1e-3, 0.05
    surf = (np.arange(ncol)[::-1] * dx * s0)[None, :] * np.ones((nrow, 1))
    sim_files(ws, "OLF6", "plane.nam")
    write(ws, "plane.nam", """
BEGIN OPTIONS
END OPTIONS
BEGIN PACKAGES
  DIS2D6 plane.dis2d
  DFW6 plane.dfw
  STO6 plane.sto
  IC6 plane.ic
  FLW6 plane.flw
  ZDG6 plane.zdg
END PACKAGES
""")

    def rows(add):
        return "\n".join("      " + " ".join(f"{v + add:.6f}" for v in row)
                         for row in surf)

    write(ws, "plane.dis2d", f"""
BEGIN OPTIONS
END OPTIONS
BEGIN DIMENSIONS
  NROW {nrow}
  NCOL {ncol}
END DIMENSIONS
BEGIN GRIDDATA
  DELR
    CONSTANT {dx}
  DELC
    CONSTANT {dx}
  BOTTOM
    INTERNAL
{rows(0.0)}
END GRIDDATA
""")
    write(ws, "plane.dfw", f"""
BEGIN OPTIONS
  CENTRAL_IN_SPACE
END OPTIONS
BEGIN GRIDDATA
  MANNINGSN
    CONSTANT {nman}
  IDCXS
    CONSTANT 0
END GRIDDATA
""")
    write(ws, "plane.sto", "BEGIN OPTIONS\nEND OPTIONS\nBEGIN PERIOD 1\n"
          "  TRANSIENT\nEND PERIOD\n")
    write(ws, "plane.ic", "BEGIN OPTIONS\nEND OPTIONS\nBEGIN GRIDDATA\n"
          f"  STRT\n    INTERNAL\n{rows(0.02)}\nEND GRIDDATA\n")
    list_file(ws, "plane.flw", [f"{r + 1} {c + 1} 0.02" for r in range(nrow)
                                for c in range(ncol - 1)])
    list_file(ws, "plane.zdg", [f"{r + 1} {ncol} 0 {dx} {s0} {nman}"
                                for r in range(nrow)])
    return nrow * (ncol - 1) * 0.02


def chf_pcp_deck(ws):
    """tests/test_swf_decks.py:test_chf_deck_pcp_evp_cdb's deck."""
    nreach, dx, width = 8, 100.0, 5.0
    sim_files(ws, "CHF6", "chan.nam")
    write(ws, "chan.nam", """
BEGIN OPTIONS
END OPTIONS
BEGIN PACKAGES
  DISV1D6 chan.disv1d
  DFW6 chan.dfw
  STO6 chan.sto
  IC6 chan.ic
  PCP6 chan.pcp
  EVP6 chan.evp
  CDB6 chan.cdb
END PACKAGES
""")
    disv1d(ws, "chan.disv1d", nreach, dx, f"    CONSTANT {width}",
           "    CONSTANT 0.0")
    write(ws, "chan.dfw", "BEGIN OPTIONS\nEND OPTIONS\nBEGIN GRIDDATA\n"
          "  MANNINGSN\n    CONSTANT 0.03\nEND GRIDDATA\n")
    write(ws, "chan.sto", "BEGIN OPTIONS\nEND OPTIONS\n")
    write(ws, "chan.ic", "BEGIN GRIDDATA\n  STRT\n    CONSTANT 0.3\n"
          "END GRIDDATA\n")
    list_file(ws, "chan.pcp", [f"{i + 1} 1.0e-4" for i in range(nreach)])
    list_file(ws, "chan.evp", [f"{i + 1} 2.0e-5" for i in range(nreach)])
    list_file(ws, "chan.cdb", [f"{nreach} 0 {width}"])


def tree_deck(ws, depth=4):
    """A binary-tree channel network as DISV1D6 (every reach a two-vertex
    polyline from its upstream to its downstream end), with CXS6 sections
    on some reaches, FLW6 on the headwaters, a ZDG6 outlet and CHD6 on one
    reach."""
    n = 2 ** depth - 1
    rng = np.random.default_rng(8)
    # vertex 1 the outlet's downstream end; reach r runs from vertex r + 2
    # to its parent's upstream vertex (the outlet's to vertex 1)
    xy = np.zeros((n + 1, 2))
    for r in range(n):
        parent_v = 0 if r == 0 else (r - 1) // 2 + 1
        xy[r + 1] = xy[parent_v] + (100.0 * (1 + (r % 2)), 60.0 * (1 - 2 * (
            (r + 1) % 2)))
    verts = "\n".join(f"  {i + 1} {float(x)!r} {float(y)!r}"
                      for i, (x, y) in enumerate(xy))
    cells = "\n".join(f"  {r + 1} 0.5 2 {r + 2} "
                      f"{1 if r == 0 else (r - 1) // 2 + 2}" for r in range(n))
    bot = 0.2 * np.floor(np.log2(np.arange(n) + 1.0)) + rng.uniform(0, 0.05, n)
    sim_files(ws, "CHF6", "tree.nam", perioddata="3000.0 3 1.0")
    write(ws, "tree.nam", """
BEGIN PACKAGES
  DISV1D6 tree.disv1d
  DFW6 tree.dfw
  CXS6 tree.cxs
  STO6 tree.sto
  IC6 tree.ic
  FLW6 tree.flw
  ZDG6 tree.zdg
  CHD6 tree.chd
  OC6 tree.oc
END PACKAGES
""")
    disv1d(ws, "tree.disv1d", n, 0.0, "    INTERNAL\n      " + " ".join(
        f"{w:.3f}" for w in rng.uniform(3.0, 8.0, n)),
        "    INTERNAL\n      " + " ".join(repr(float(b)) for b in bot),
        cells=cells, nvert=n + 1, verts=verts)
    idcxs = " ".join(str(v) for v in (np.arange(n) % 3))
    write(ws, "tree.dfw", "BEGIN OPTIONS\nEND OPTIONS\nBEGIN GRIDDATA\n"
          "  MANNINGSN\n    CONSTANT 0.035\n  IDCXS\n    INTERNAL\n      "
          f"{idcxs}\nEND GRIDDATA\n")
    write(ws, "tree.cxs", """
BEGIN DIMENSIONS
  NSECTIONS 2
  NPOINTS 7
END DIMENSIONS
BEGIN PACKAGEDATA
  1 3
  2 4
END PACKAGEDATA
BEGIN CROSSSECTIONDATA
  0.0 2.0
  0.5 0.0
  1.0 2.0
  0.0 1.0 1.0
  0.0 0.0 1.2
  1.0 0.0 1.0
  1.0 1.0
END CROSSSECTIONDATA
""")
    write(ws, "tree.sto", "BEGIN PERIOD 1\n  TRANSIENT\nEND PERIOD\n")
    write(ws, "tree.ic", "BEGIN GRIDDATA\n  STRT\n    INTERNAL\n      "
          + " ".join(repr(float(b) + 0.4) for b in bot) + "\nEND GRIDDATA\n")
    heads = range(n // 2, n)
    list_file(ws, "tree.flw", [f"{r + 1} 0.25" for r in heads])
    list_file(ws, "tree.zdg", [f"1 0 6.0 1e-3 0.035"])
    list_file(ws, "tree.chd", [f"{n // 2} {float(bot[n // 2 - 1]) + 0.5!r}"])
    write(ws, "tree.oc", "BEGIN OPTIONS\n  STAGE FILEOUT tree.stage\n"
          "END OPTIONS\nBEGIN PERIOD 1\n  SAVE STAGE ALL\nEND PERIOD\n")


def disv2d_deck(ws, nrow=3, ncol=5):
    """An OLF6 DISV2D6 raster of quads with rain and a CHD edge."""
    sim_files(ws, "OLF6", "m.nam", perioddata="600.0 3 1.0")
    write(ws, "m.nam", "BEGIN PACKAGES\n  DISV2D6 m.disv2d\n  DFW6 m.dfw\n"
          "  STO6 m.sto\n  IC6 m.ic\n  PCP6 m.pcp\n  CHD6 m.chd\n"
          "END PACKAGES\n")
    w = ncol + 1
    verts = "\n".join(f"  {r * w + c + 1} {c * 10.0} {(nrow - r) * 10.0}"
                      for r in range(nrow + 1) for c in range(ncol + 1))
    cells = "\n".join(
        f"  {r * ncol + c + 1} {c * 10.0 + 5} {(nrow - r) * 10.0 - 5} 5 "
        f"{r * w + c + 1} {r * w + c + 2} {(r + 1) * w + c + 2} "
        f"{(r + 1) * w + c + 1} {r * w + c + 1}"
        for r in range(nrow) for c in range(ncol))
    bottom = " ".join(f"{0.01 * (ncol - c):.3f}" for r in range(nrow)
                      for c in range(ncol))
    write(ws, "m.disv2d", f"""
BEGIN DIMENSIONS
  NODES {nrow * ncol}
  NVERT {(nrow + 1) * (ncol + 1)}
END DIMENSIONS
BEGIN GRIDDATA
  BOTTOM
    INTERNAL
      {bottom}
END GRIDDATA
BEGIN VERTICES
{verts}
END VERTICES
BEGIN CELL2D
{cells}
END CELL2D
""")
    write(ws, "m.dfw", "BEGIN GRIDDATA\n  MANNINGSN\n    CONSTANT 0.04\n"
          "END GRIDDATA\n")
    write(ws, "m.sto", "BEGIN PERIOD 1\n  TRANSIENT\nEND PERIOD\n")
    write(ws, "m.ic", "BEGIN GRIDDATA\n  STRT\n    INTERNAL\n      "
          + " ".join(f"{0.01 * (ncol - c) + 0.02:.3f}" for r in range(nrow)
                     for c in range(ncol)) + "\nEND GRIDDATA\n")
    list_file(ws, "m.pcp", [f"{i + 1} 1e-4" for i in range(nrow * ncol)])
    list_file(ws, "m.chd", [f"{r * ncol + ncol} 0.03" for r in range(nrow)])


DECKS = {"normal_depth": chf_normal_depth_deck, "olf_plane": olf_plane_deck,
         "pcp_evp_cdb": chf_pcp_deck, "disv2d": disv2d_deck}


def _same_model(port, ref):
    for name in ("bot", "manningsn", "strt", "ibound0"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(port.grid.area).reshape(-1),
                                  np.asarray(ref.grid.area).reshape(-1))
    for key in ("flw", "chd", "zdg", "pcp", "evp", "cdb"):
        a, b = getattr(port, key), getattr(ref, key)
        assert (a is None) == (b is None), key
        for u, v in zip(a or (), b or ()):
            np.testing.assert_array_equal(u.numpy(), np.asarray(v),
                                          err_msg=key)
    for name in ("edge_n", "edge_m", "cl1", "cl2", "hwva", "nbr",
                 "slot_nm", "slot_mn"):
        np.testing.assert_array_equal(
            getattr(port.dtopo, name).numpy(),
            np.asarray(getattr(ref.dtopo, name)), err_msg=name)
    for name in ("xs_station", "xs_height", "xs_rf", "xs_rect", "has_xs"):
        a, b = getattr(port, name), getattr(ref, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (port.unitconv, port.icentral) == (ref.unitconv, ref.icentral)


@pytest.mark.parametrize("name", list(DECKS))
def test_deck_matches_reference(name, tmp_path):
    ws = str(tmp_path)
    DECKS[name](ws)
    port = load_simulation(ws, device="cpu")
    ref = ref_load(ws)
    _same_model(port.model, ref.model)
    assert port.settings == type(port.settings)(**{
        f: getattr(ref.settings, f) for f in vars(ref.settings)})
    recs = port.run()
    stage_file = port.hds_path
    port_stage = read_head_file(stage_file) if os.path.exists(stage_file) \
        else []
    jrecs = ref.run()
    ref_stage = read_head_file(stage_file) if port_stage else []
    assert all(r.converged for r in recs) and all(r.converged for r in jrecs)
    for a, b in zip(recs, jrecs):
        np.testing.assert_allclose(a.stage, b.stage, rtol=0, atol=STAGE_BAR)
    assert len(port_stage) == len(ref_stage)
    for a, b in zip(port_stage, ref_stage):
        assert (a["text"], a["kstp"], a["kper"]) == (b["text"], b["kstp"],
                                                     b["kper"])
        np.testing.assert_allclose(a["data"], b["data"], atol=STAGE_BAR)
    if name == "normal_depth":
        assert len(port_stage) == 1 and port_stage[0]["text"] == "STAGE"
        assert abs(port.budget.percent_discrepancy()) < 0.01
    if name == "pcp_evp_cdb":
        ib, st = port.model.boundary_state(torch.as_tensor(recs[-1].stage))
        bud = port.model.boundary_budget(st, ib)
        assert set(bud) == {"PCP", "EVP", "CDB"}


def test_r32_cxs_deck_runs_as_the_reference_model_in_memory(tmp_path):
    """R32: the reference's loader hands its section table one roughness
    fraction per station where it takes one per segment, so every CXS6
    deck fails there; the port loads the fraction of each segment's first
    station (SwfCxsUtils).  The branching network with CXS6 sections then
    runs as the reference's model built in memory from the same sections,
    within 10 × outer_dvclose at every step."""
    from modflow6_tpu.models.swf import build_chf as jax_chf
    from modflow6_tpu.models.swf.simulation import SwfSimulation as JaxSim
    ws = str(tmp_path)
    tree_deck(ws)
    with pytest.raises(ValueError, match="broadcast"):
        ref_load(ws)
    port = load_simulation(ws, device="cpu")
    m = port.model
    sections = swf_loader._load_cxs(os.path.join(ws, "tree.cxs"))
    assert [len(s[2]) for s in sections] == [2, 3]
    grid = jswf_loader._load_disv1d(os.path.join(ws, "tree.disv1d"), ws)[0]
    idcxs = np.arange(m.nodes) % 3

    def entries(t):
        return [tuple(float(c[i]) for c in t[:-1]) for i in range(len(t[0]))]

    jm = jax_chf("tree", grid, manningsn=0.035, strt=m.strt.numpy(),
                 icentral=0, flw=entries(m.flw), zdg=entries(m.zdg),
                 chd=entries(m.chd),
                 cxs_sections=sections, idcxs=idcxs)
    ref = JaxSim(port.tdis, jm, sto_periods=port.sto_periods, has_sto=True)
    _same_model(m, jm)
    recs, jrecs = port.run(), ref.run()
    assert all(r.converged for r in recs) and all(r.converged for r in jrecs)
    for a, b in zip(recs, jrecs):
        np.testing.assert_allclose(a.stage, b.stage, rtol=0, atol=STAGE_BAR)
    assert len(read_head_file(os.path.join(ws, "tree.stage"))) == 3


def test_disv1d_reaches_equal_the_reference_loops(tmp_path):
    """The DISV1D lengths and shared-end-vertex pairs as array code, on a
    branching network with polylines of several vertices and a reach whose
    ends share a vertex, against the reference loader's loops."""
    ws = str(tmp_path)
    verts = {1: (0.0, 0.0), 2: (10.0, 0.0), 3: (10.0, 7.5), 4: (20.0, 1.0),
             5: (31.0, 4.0), 6: (5.0, -9.0), 7: (12.5, -3.0), 8: (3.0, 3.0)}
    cells = [(0, [2, 1]), (1, [3, 2]), (2, [4, 5, 3]), (3, [6, 7, 8, 2]),
             (4, [5, 4, 5]), (5, [7, 6])]
    text = "\n".join(f"  {k} {x!r} {y!r}" for k, (x, y) in verts.items())
    cell_text = "\n".join(f"  {ic + 1} 0.5 {len(ch)} "
                          + " ".join(str(v) for v in ch) for ic, ch in cells)
    disv1d(ws, "g.disv1d", 6, 0.0, "    CONSTANT 2.0", "    CONSTANT 0.0",
           cells=cell_text, nvert=8, verts=text)
    grid = swf_loader._load_disv1d(os.path.join(ws, "g.disv1d"), ws)
    jgrid, _ = jswf_loader._load_disv1d(os.path.join(ws, "g.disv1d"), ws)
    np.testing.assert_array_equal(grid.length, jgrid.length)
    assert grid.pairs.tolist() == [list(p) for p in jgrid.pairs]


def test_cli_runs_a_chf_deck(tmp_path, capsys):
    ws = str(tmp_path)
    chf_pcp_deck(ws)
    assert cli_main([ws, "--device", "cpu"]) == 0
    assert "Normal termination of simulation" in capsys.readouterr().out
    assert os.path.exists(os.path.join(ws, "chan.stage"))


REFUSED = {
    "R20 DEV_SWR_CONDUCTANCE": (dict(dfw_options="  DEV_SWR_CONDUCTANCE\n"),
                                "DEV_SWR_CONDUCTANCE"),
    "R21 OBS6": (dict(flw_opts="  OBS6 FILEIN chan.obs\n"), "OBS6"),
    "R22 TS6": (dict(flw_opts="  TS6 FILEIN chan.ts\n"), "TS6"),
    "R22 AUXMULTNAME": (dict(flw_opts="  AUXILIARY mult\n"
                             "  AUXMULTNAME mult\n"), "AUXMULTNAME"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_swf_input_the_reference_reads_past_is_refused(case, tmp_path):
    """Each refused option loads in the reference, which runs without it."""
    ws = str(tmp_path)
    kw, what = REFUSED[case]
    chf_normal_depth_deck(ws, **kw)
    ref_load(ws)
    with pytest.raises(NotImplementedError, match=what):
        load_simulation(ws, device="cpu")


def test_swf_refusals_as_the_reference(tmp_path):
    """R23 (a DISV1D IDOMAIN of 0, which the reference reads and drops),
    and as the reference: a later PERIOD block, CHF beside GWF."""
    ws = str(tmp_path)
    chf_pcp_deck(ws)
    text = open(os.path.join(ws, "chan.disv1d")).read().replace(
        "END GRIDDATA", "  IDOMAIN\n    INTERNAL\n      1 1 1 0 1 1 1 1\n"
        "END GRIDDATA")
    write(ws, "chan.disv1d", text)
    assert ref_load(ws).model.nodes == 8
    with pytest.raises(NotImplementedError, match="R23"):
        load_simulation(ws, device="cpu")
    chf_pcp_deck(ws)
    with open(os.path.join(ws, "chan.pcp"), "a") as f:
        f.write("BEGIN PERIOD 2\n  1 0.0\nEND PERIOD\n")
    for load in (ref_load, lambda w: load_simulation(w, device="cpu")):
        with pytest.raises(NotImplementedError, match="PERIOD blocks beyond"):
            load(ws)
    chf_pcp_deck(ws)
    sim_files(ws, "CHF6", "chan.nam",
              models="CHF6 chan.nam chan\n  GWF6 flow.nam flow")
    with pytest.raises(NotImplementedError):
        ref_load(ws)
    with pytest.raises(NotImplementedError, match="CHF6/OLF6 beside"):
        load_simulation(ws, device="cpu")
