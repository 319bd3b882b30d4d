"""MAW6, LAK6 (with TAB6 tables) and SFR6 decks through the port's loader
and ``Simulation`` against the reference's: the decks of
tests/test_advanced_transient.py (later PERIOD blocks rebuild the
augmented model), test_advanced_decks.py::test_lak_maw_deck_with_table and
the MAW model of test_newton_advanced.py, with the reference's fault R2
(its period rebuild drops K11/K22), SFR's CROSSSECTIONS block and the
options the port refuses.

Tolerances: heads and feature rows within 10 × the deck's OUTER_DVCLOSE
(1e-7 for 1e-8) of the reference's at every step (BiCGSTAB, whose counts
follow the sum order: ROADMAP Queue C); budgets below 0.01 %; the loaded
states equal (``test_torch_deck.assert_same_state``); a deck with
CROSSSECTIONS and the same reaches built in memory: bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_advanced_decks import _sim_files, write
from test_torch_deck import assert_same_state, simulation_state
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf import advanced as jadv
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxSolution
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.convert import simulation_from_reference
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf.advanced import (AugmentedGwfModel, build_maw,
                                                build_sfr)
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.ims import NumericalSolution
from modflow6_torch.utils.mf6io import load_simulation

DECK_ATOL = 10 * 1e-8     # the decks' OUTER_DVCLOSE 1e-8
N_GRID = 8                # the decks' 1 x 1 x 8 grid


def load(ws):
    return load_simulation(str(ws), device="cpu")


def run_both(ws, budget=True):
    """Both loaders and runs on one deck; every step converged, heads equal
    to DECK_ATOL, the budget closed (``budget``: a deck whose aquifer has
    flows).  Returns (port sim, reference sim)."""
    sim, ref = load(ws), ref_load(str(ws))
    recs, jrecs = sim.run(), ref.run()
    assert len(recs) == len(jrecs)
    assert all(r.converged for r in recs) and all(r.converged for r in jrecs)
    for got, want in zip(recs, jrecs):
        np.testing.assert_allclose(got.head, want.head, rtol=0,
                                   atol=DECK_ATOL)
    if budget:
        assert abs(sim.budget.percent_discrepancy()) < 0.01
    return sim, ref


SFR_DECK = """
BEGIN OPTIONS
END OPTIONS
BEGIN DIMENSIONS
  NREACHES 2
END DIMENSIONS
BEGIN PACKAGEDATA
  1 1 1 3 100.0 3.0 1.0e-3 40.0 1.0 0.0 0.03 1 1.0 0
  2 1 1 4 100.0 3.0 1.0e-3 39.9 1.0 0.0 0.03 1 1.0 0
END PACKAGEDATA
BEGIN CONNECTIONDATA
  1 -2
  2 1
END CONNECTIONDATA
BEGIN PERIOD 1
  1 INFLOW 1.0
END PERIOD
BEGIN PERIOD 2
  1 INFLOW 5.0
END PERIOD
"""

MAW_DECK = """
BEGIN OPTIONS
END OPTIONS
BEGIN DIMENSIONS
  NMAWWELLS 1
END DIMENSIONS
BEGIN PACKAGEDATA
  1 0.25 0.0 29.0 {eqn} 1
END PACKAGEDATA
BEGIN CONNECTIONDATA
  1 1 1 1 5 50.0 0.0 50.0 0.0
END CONNECTIONDATA
BEGIN PERIOD 1
  1 RATE -10.0
{extra}END PERIOD
BEGIN PERIOD 2
  1 RATE -80.0
END PERIOD
"""


def test_sfr_inflow_changes_per_period(tmp_path):
    """tests/test_advanced_transient.py:12: the period-2 rebuild applies
    the new inflow, and the terminal reach carries it."""
    _sim_files(str(tmp_path), "  SFR6 model.sfr sfr-1", nper=2,
               perlen="50000.0 10 1.0")
    write(str(tmp_path), "model.sfr", SFR_DECK)
    # rhk = 0 and the CHD heads at strt: the aquifer has no flow, and its
    # budget is rounding
    sim, ref = run_both(tmp_path, budget=False)
    np.testing.assert_array_equal(sim.model.sfr.inflow.numpy(), [5.0, 0.0])
    x, info, _ = sim.solution.solve_timestep(sim.model.strt, delt=5e4,
                                             kstp=1, iss=False)
    assert info.converged
    q_man, _ = sim.model.sfr._manning(x[N_GRID:])
    np.testing.assert_allclose(float(q_man[1]), 5.0, rtol=0.01)


def test_maw_rate_changes_per_period(tmp_path):
    """tests/test_advanced_transient.py:58: higher pumping in period 2
    draws the aquifer down further."""
    _sim_files(str(tmp_path), "  MAW6 model.maw maw-1", nper=2,
               perlen="1000.0 10 1.0")
    write(str(tmp_path), "model.maw", MAW_DECK.format(eqn="SPECIFIED",
                                                      extra=""))
    sim, _ = run_both(tmp_path)
    np.testing.assert_array_equal(sim.model.maw.rate.numpy(), [-80.0])
    assert sim.records[-1].head[4] < sim.records[9].head[4] - 0.05


def test_r2_period_rebuild_keeps_k_and_restarts_shut_off(tmp_path):
    """R2: the reference's period rebuild calls build_maw without K11/K22,
    so a THIEM well with a PERIOD 2 block fails there; the port's rebuild
    passes them and runs, the period-2 conductance the period-1 one.  Like
    the reference's, the rebuild starts SHUT_OFF flags open: with a
    SPECIFIED well and SHUT_OFF both packages run the deck alike."""
    _sim_files(str(tmp_path), "  MAW6 model.maw maw-1", nper=2,
               perlen="1000.0 4 1.0")
    write(str(tmp_path), "model.maw", MAW_DECK.format(eqn="THIEM",
                                                      extra=""))
    with pytest.raises((TypeError, IndexError, ValueError)):
        ref_load(str(tmp_path)).run()
    sim = load(tmp_path)
    cond1 = sim.model.maw.cond.clone()
    recs = sim.run()
    assert all(r.converged for r in recs) and len(recs) == 8
    assert torch.equal(sim.model.maw.cond, cond1)
    np.testing.assert_array_equal(sim.model.maw.rate.numpy(), [-80.0])
    write(str(tmp_path), "model.maw", MAW_DECK.format(
        eqn="SPECIFIED", extra="  1 HEAD_LIMIT 28.5\n"
        "  1 SHUT_OFF 100.0 200.0\n"))
    # the well shuts at the end of each period: the last step's rates are
    # rounding, so its budget is not held
    sim, _ = run_both(tmp_path, budget=False)
    # shut by the end of period 1 (the well row back at the aquifer's
    # head), pumping again in the first step after the rebuild
    well = [rec.head[N_GRID] for rec in sim.records]
    assert well[3] > 29.99 and well[4] < 28.6


def _lak_maw_deck(ws):
    """The deck of tests/test_advanced_decks.py:202: LAK6 with a TAB6
    table and a weir outlet, MAW6 with HEAD_LIMIT."""
    ws = str(ws)
    _sim_files(ws, "  LAK6 model.lak lak-1\n  MAW6 model.maw maw-1", nper=1,
               perlen="200000.0 40 1.0")
    write(ws, "model.lak", """
BEGIN OPTIONS
END OPTIONS
BEGIN DIMENSIONS
  NLAKES 1
  NOUTLETS 1
  NTABLES 1
END DIMENSIONS
BEGIN PACKAGEDATA
  1 32.5 1
END PACKAGEDATA
BEGIN CONNECTIONDATA
  1 1 1 1 3 VERTICAL 0.0000001 30.0 50.0 100.0 100.0
END CONNECTIONDATA
BEGIN TABLES
  1 TAB6 FILEIN lake1.tab
END TABLES
BEGIN OUTLETS
  1 1 0 WEIR 32.0 2.0 0.03 0.001
END OUTLETS
BEGIN PERIOD 1
  1 RAINFALL 0.0005
END PERIOD
""")
    rows = "\n".join(f"  {30.0 + z} {1.0e4 * z + 500.0 * z * z} "
                     f"{1.0e4 + 1000.0 * z}"
                     for z in np.linspace(0.0, 6.0, 13))
    write(ws, "lake1.tab", f"""
BEGIN DIMENSIONS
  NROW 13
  NCOL 3
END DIMENSIONS
BEGIN TABLE
{rows}
END TABLE
""")
    write(ws, "model.maw", """
BEGIN OPTIONS
END OPTIONS
BEGIN DIMENSIONS
  NMAWWELLS 1
END DIMENSIONS
BEGIN PACKAGEDATA
  1 0.25 0.0 30.0 SPECIFIED 1
END PACKAGEDATA
BEGIN CONNECTIONDATA
  1 1 1 1 6 50.0 0.0 25.0 0.25
END CONNECTIONDATA
BEGIN PERIOD 1
  1 RATE -200.0
  1 HEAD_LIMIT 27.0
END PERIOD
""")


def test_lak_maw_deck_with_table(tmp_path):
    """tests/test_advanced_decks.py:202, with its HEAD_LIMIT check read on
    the well's row N + 0 (rows are MAW, then LAK; the reference test reads
    row N + 1, the lake: R5).  Loader and solver apart: the reference's
    loaded state equals the port's, and run by the port through
    ``simulation_from_reference`` gives the port loader's heads."""
    _lak_maw_deck(tmp_path)
    state = simulation_state(load(tmp_path))
    assert_same_state(state, simulation_state(ref_load(str(tmp_path))))
    sim, ref = run_both(tmp_path)
    assert sim.model.lak.tab_stage is not None
    assert sim.model.lak.out_type == ("weir",)
    for model in (sim.model, ref.model):
        assert (model._maw_offset, model._lak_offset) == (N_GRID,
                                                          N_GRID + 1)
    x, info, _ = sim.solution.solve_timestep(sim.model.strt, delt=2e5,
                                             kstp=1, iss=False)
    xj, infoj, _ = ref.solution.solve_timestep(jnp.asarray(ref.model.strt),
                                               delt=2e5, kstp=1, iss=False)
    assert info.converged and infoj.converged
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=DECK_ATOL)
    hw = float(x[N_GRID])
    assert hw >= 27.0 - 1e-6
    np.testing.assert_allclose(hw, 27.0, atol=1e-6)   # the limit binds
    converted = simulation_from_reference(
        simulation_state(ref_load(str(tmp_path))), device="cpu")
    for got, want in zip(converted.run(), sim.records):
        np.testing.assert_array_equal(got.head, want.head)


@pytest.mark.parametrize("newton", [True, "under_relaxation"])
def test_newton_with_maw_converges_and_matches_picard(newton):
    """tests/test_newton_advanced.py:74, and with the Newton
    under-relaxation (grid rows only): both packages converge to the same
    heads, within 0.05 of the Picard twin, the well drawn below its cell."""
    def grid():
        return dict(nlay=1, nrow=8, ncol=10, delr=10.0, delc=10.0,
                    top=20.0, botm=np.zeros((1, 8, 10)))

    def make(newton_opt):
        kw = dict(k=5.0, strt=15.0, icelltype=1, newton=newton_opt,
                  chd=[(i * 10, 16.0) for i in range(8)])
        wells = [dict(radius=0.3, strt=15.0, rate=-40.0,
                      connections=[(3 * 10 + 6, 80.0)])]
        jg, tg = JaxDisGrid.create(**grid()), DisGrid.create(**grid())
        return (jadv.AugmentedGwfModel(jax_build_gwf("n", jg, **kw),
                                       maw=jadv.build_maw(wells, jg)),
                AugmentedGwfModel(build_gwf("n", tg, device="cpu", **kw),
                                  maw=build_maw(wells, tg)))

    settings = dict(outer_dvclose=1e-8, outer_maximum=300,
                    inner_dvclose=1e-10, inner_rclose=1e-9,
                    inner_maximum=2000, linear_acceleration="bicgstab")
    heads = []
    for opt in (newton, False):
        jm, tm = make(opt)
        assert tm.inewton == int(bool(opt))
        assert tm.inewtonur == int(opt == "under_relaxation")
        xj, infoj, _ = JaxSolution(jm, JaxImsSettings(**settings)) \
            .solve_timestep(jnp.asarray(jm.strt), 1.0, iss=True)
        xt, infot, _ = NumericalSolution(tm, ImsSettings(**settings)) \
            .solve_timestep(tm.strt, 1.0, iss=True)
        assert infoj.converged and infot.converged
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj),
                                   atol=DECK_ATOL)
        heads.append(xt.numpy())
    np.testing.assert_allclose(heads[0], heads[1], atol=0.05)
    assert heads[0][-1] < heads[0][3 * 10 + 6]


def test_sfr_cross_sections_block_is_read(tmp_path):
    """CROSSSECTIONS (rno TAB6 FILEIN) gives the reach the n-point section
    that build_sfr's ``xsection`` gives it in memory (the reference's
    loader reads past the block)."""
    _sim_files(str(tmp_path), "  SFR6 model.sfr sfr-1", nper=1,
               perlen="50000.0 4 1.0")
    write(str(tmp_path), "model.sfr", SFR_DECK.split("BEGIN PERIOD 2")[0]
          .replace("BEGIN PERIOD 1", "BEGIN CROSSSECTIONS\n"
                   "  2 TAB6 FILEIN xs2.tab\nEND CROSSSECTIONS\n"
                   "BEGIN PERIOD 1"))
    table = [(0.0, 2.0, 1.0), (0.25, 0.5, 1.5), (0.5, 0.0, 1.5),
             (0.75, 0.5, 1.0), (1.0, 2.0, 1.0)]
    write(str(tmp_path), "xs2.tab", "BEGIN DIMENSIONS\n  NROW 5\n  NCOL 3\n"
          "END DIMENSIONS\nBEGIN TABLE\n" + "".join(
              f"  {a} {b} {c}\n" for a, b, c in table) + "END TABLE\n")
    sim = load(tmp_path)
    base = sim.model.base
    common = dict(width=3.0, slope=1e-3, length=100.0, rough=0.03,
                  cond=0.0)
    reaches = [dict(node=2, strtop=40.0, strt=40.1, inflow=1.0, **common),
               dict(node=3, strtop=39.9, strt=40.0, upstream=[(0, 1.0)],
                    xsection=([r[0] for r in table], [r[1] for r in table],
                              [r[2] for r in table[:-1]]), **common)]
    mem = AugmentedGwfModel(base, sfr=build_sfr(reaches))
    for name in ("xs_station", "xs_height", "xs_rf", "xs_rect", "strt",
                 "cond", "upstream", "frac"):
        assert torch.equal(getattr(sim.model.sfr, name),
                           getattr(mem.sfr, name)), name
    assert bool(sim.model.sfr.xs_rect[0]) and not bool(
        sim.model.sfr.xs_rect[1])
    recs = sim.run()
    assert all(r.converged for r in recs)


@pytest.mark.parametrize("case", ["maw-option", "sfr-storage",
                                  "sfr-status", "uzf", "mvr"])
def test_unported_advanced_input_raises_by_name(case, tmp_path):
    """Options and settings that would change the flows and that no
    loader implements raise NotImplementedError naming them (the
    reference reads past them): UZF6's UNSAT_ETAE, and MODELNAMES in a
    model's MVR6 (records of an exchange's mover, which the reference
    would misread)."""
    pkgs = {"maw-option": "  MAW6 model.maw maw-1",
            "uzf": "  UZF6 model.uzf uzf",
            "mvr": "  SFR6 model.sfr sfr-1\n  MVR6 model.mvr mvr"}
    write(str(tmp_path), "model.uzf", "BEGIN OPTIONS\n  UNSAT_ETAE\n"
          "END OPTIONS\nBEGIN PACKAGEDATA\n"
          "  1 1 1 2 1 0 0.5 0.3 0.05 0.35 0.1 3.5\nEND PACKAGEDATA\n")
    write(str(tmp_path), "model.mvr", "BEGIN OPTIONS\n  MODELNAMES\n"
          "END OPTIONS\nBEGIN PERIOD 1\n  M1 SFR-1 1 M1 SFR-1 2 UPTO 1.0\n"
          "END PERIOD\n")
    _sim_files(str(tmp_path), pkgs.get(case, "  SFR6 model.sfr sfr-1"))
    write(str(tmp_path), "model.maw", MAW_DECK.format(
        eqn="SPECIFIED", extra="").replace(
        "BEGIN OPTIONS\n", "BEGIN OPTIONS\n  LENGTH_CONVERSION 3.28\n"))
    sfr = SFR_DECK.split("BEGIN PERIOD 2")[0]
    if case == "sfr-storage":
        sfr = sfr.replace("BEGIN OPTIONS\n", "BEGIN OPTIONS\n  STORAGE\n")
    elif case == "sfr-status":
        sfr = sfr.replace("1 INFLOW 1.0", "2 STATUS INACTIVE")
    write(str(tmp_path), "model.sfr", sfr)
    match = {"maw-option": "LENGTH_CONVERSION", "sfr-storage": "STORAGE",
             "sfr-status": "STATUS INACTIVE", "uzf": "UNSAT_ETAE",
             "mvr": "MODELNAMES"}[case]
    with pytest.raises(NotImplementedError, match=match):
        load(tmp_path)
