"""The port's MODFLOW-2005 converter (modflow6_torch/utils/mf5to6.py)
against the reference's (modflow6_tpu/utils/mf5to6.py) on the four decks
of tests/test_mf5to6.py: both write the same workspace byte for byte, and
the converted deck runs in the port as in the reference.

Tolerances: every written file equal byte for byte; the converted decks
solve with BiCGSTAB (the converter's IMS file), so the heads agree within
10 × OUTER_DVCLOSE = 1e-5 with equal outer counts (the inner counts follow
the sum order: ROADMAP Queue C).
"""

import os
import runpy
import sys

import numpy as np
import pytest

from test_mf5to6 import _mf2005_deck, write
from modflow6_tpu.utils import mf5to6 as ref_mf5to6
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.utils import mf5to6
from modflow6_torch.utils.mf6io import load_simulation

HEAD_ATOL = 10 * 1e-6


def _upw(ws):
    """test_mf5to6.py::test_mf5to6_transient_upw."""
    write(ws, "m.nam", "DIS 11 m.dis\nBAS6 12 m.bas\nUPW 13 m.upw")
    write(ws, "m.dis", "1 1 6 1 4 2\n0\nCONSTANT 50.0\nCONSTANT 50.0\n"
          "CONSTANT 20.0\nCONSTANT 0.0\n30.0 3 1.0 TR")
    write(ws, "m.bas", "FREE\nINTERNAL 1\n -1 1 1 1 1 1\n999.0\n"
          "CONSTANT 10.0")
    write(ws, "m.upw", "0 1e30 0\n1\n0\n1.0\n0\n0\nCONSTANT 8.0\n"
          "CONSTANT 8.0\nCONSTANT 1.0e-5\nCONSTANT 0.2")


_LPF = "0 1e30 0\n0\n0\n1.0\n0\n0\nCONSTANT 5.0\nCONSTANT 5.0"


def _riv_drn_ghb_evt(ws):
    """test_mf5to6.py::test_mf5to6_riv_drn_ghb_evt."""
    write(ws, "m.nam", "LIST 7 m.lst\nDIS 11 m.dis\nBAS6 12 m.bas\n"
          "LPF 13 m.lpf\nDRN 14 m.drn\nRIV 15 m.riv\nGHB 16 m.ghb\n"
          "EVT 17 m.evt")
    write(ws, "m.dis", "1 1 8 1 4 2\n0\nCONSTANT 100.0\nCONSTANT 100.0\n"
          "CONSTANT 50.0\nCONSTANT 0.0\n10.0 1 1.0 SS")
    write(ws, "m.bas", "FREE\nINTERNAL 1\n -1 1 1 1 1 1 1 1\n999.0\n"
          "CONSTANT 30.0")
    write(ws, "m.lpf", _LPF)
    write(ws, "m.drn", "1 0\n1\n1 1 3 25.0 4.0")
    write(ws, "m.riv", "1 0\n1\n1 1 5 31.0 6.0 28.0")
    write(ws, "m.ghb", "1 0\n1\n1 1 7 32.0 2.0")
    write(ws, "m.evt", "1 0\n0 0 0\nCONSTANT 50.0\nCONSTANT 1.0e-5\n"
          "CONSTANT 40.0")


def _sfr2(ws):
    """test_mf5to6.py::test_mf5to6_sfr2_basic."""
    write(ws, "m.nam", "LIST 7 m.lst\nDIS 11 m.dis\nBAS6 12 m.bas\n"
          "LPF 13 m.lpf\nSFR 14 m.sfr")
    write(ws, "m.dis", "1 1 6 1 4 2\n0\nCONSTANT 100.0\nCONSTANT 100.0\n"
          "CONSTANT 50.0\nCONSTANT 0.0\n10.0 1 1.0 SS")
    write(ws, "m.bas", "FREE\nINTERNAL 1\n -1 1 1 1 1 -1\n999.0\n"
          "CONSTANT 30.0")
    write(ws, "m.lpf", _LPF)
    write(ws, "m.sfr", """
-3 1 0 0 86400.0 1e-4 0 0 1
1 1 2 1 1 100.0 40.0 1.0e-3 1.0 0.0
1 1 3 1 2 100.0 39.9 1.0e-3 1.0 0.0
1 1 4 1 3 100.0 39.8 1.0e-3 1.0 0.0
1
1 1 0 0 2.0 0.0 0.0 0.0 0.03
3.0
3.0
""")


DECKS = {"steady-wel": _mf2005_deck, "transient-upw": _upw,
         "riv-drn-ghb-evt": _riv_drn_ghb_evt, "sfr2": _sfr2}


@pytest.mark.parametrize("name", sorted(DECKS))
def test_converted_workspace_is_the_reference_and_runs(name, tmp_path):
    src = tmp_path / "mf5"
    src.mkdir()
    DECKS[name](str(src))
    nam = str(src / "m.nam")
    out, jout = str(tmp_path / "port"), str(tmp_path / "ref")
    assert mf5to6.main([nam, out]) == 0
    ref_mf5to6.convert(nam, jout)
    files = sorted(os.listdir(jout))
    assert sorted(os.listdir(out)) == files and "mfsim.nam" in files
    for f in files:
        with open(os.path.join(out, f), "rb") as g, \
                open(os.path.join(jout, f), "rb") as w:
            assert g.read() == w.read(), f
    sim, ref = load_simulation(out, device="cpu"), ref_load(jout)
    recs, jrecs = sim.run(), ref.run()
    assert all(r.converged for r in recs)
    assert [r.outer for r in recs] == [r.outer for r in jrecs]
    for g, w in zip(recs, jrecs):
        assert g.totim == w.totim
        np.testing.assert_allclose(g.head, np.asarray(w.head), rtol=0,
                                   atol=HEAD_ATOL)
    if name == "steady-wel":
        h = recs[-1].head
        np.testing.assert_allclose(h[[0, -1]], [10.0, 2.0])
        assert h[4] < np.linspace(10.0, 2.0, 10)[4]
        assert abs(sim.budget.percent_discrepancy()) < 1e-6


def test_converter_runs_as_a_module(tmp_path, monkeypatch, capsys):
    """``python -m modflow6_torch.utils.mf5to6 <nam> <outdir>`` (run as
    ``-m`` runs it, through ``runpy``) writes the workspace and exits 0; a
    wrong argument count prints the usage and returns 2."""
    src = tmp_path / "mf5"
    src.mkdir()
    _mf2005_deck(str(src))
    out = tmp_path / "mf6"
    monkeypatch.setattr(sys, "argv", ["mf5to6", str(src / "m.nam"),
                                      str(out)])
    with pytest.raises(SystemExit) as exit_info:
        runpy.run_module("modflow6_torch.utils.mf5to6", run_name="__main__",
                         alter_sys=True)
    assert exit_info.value.code == 0
    assert "wrote MF6 workspace" in capsys.readouterr().out
    assert (out / "mfsim.nam").exists() and (out / "mf5.chd").exists()
    assert mf5to6.main([str(src / "m.nam")]) == 2
    assert "usage: python -m modflow6_torch.utils.mf5to6" in \
        capsys.readouterr().err
