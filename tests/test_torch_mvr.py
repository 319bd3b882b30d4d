"""MVR of the port (modflow6_torch/models/gwf/mvr.py and the movers of
``AugmentedGwfModel``) against the reference (modflow6_tpu/models/gwf/mvr.py
and its augmented model): the mover chain on seeded availabilities, the
rounds it is evaluated in, the scenarios of tests/test_mvr.py through both
packages, the movers' budget terms through ``Simulation``, MVR6 decks
through both loaders, and the errors both raise.

Tolerances:

- ``run_movers``: bitwise (the rules use min, max, comparisons, one
  product and subtractions; the sums into providers and receivers follow
  the reference's mover order);
- assembled systems and budget terms with movers: 1e-12 of the largest
  entry; heads and feature rows of a solve: 1e-8, ten times the tests'
  ``outer_dvclose`` (the bars of tests/test_torch_advanced.py); decks: 10
  × the deck's OUTER_DVCLOSE (tests/test_torch_advanced_decks.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from test_advanced_decks import _sim_files, write
from test_torch_advanced import (HEAD_ATOL, SETTINGS, assert_same_system,
                                 close, x_of)
from test_torch_advanced_decks import N_GRID, run_both
from test_torch_deck import assert_same_state, simulation_state
from test_torch_parity import reference_arrays
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf import advanced as jadv
from modflow6_tpu.models.gwf import mvr as jmvr
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.simulation import Simulation as JaxSimulation
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxSolution
from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
from modflow6_tpu.timing.tdis import Tdis as JaxTdis
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.convert import augmented_state, from_reference
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf import mvr
from modflow6_torch.models.gwf.advanced import (AugmentedGwfModel, build_lak,
                                                build_maw, build_sfr)
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.simulation import Simulation
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.ims import NumericalSolution
from modflow6_torch.timing.tdis import StressPeriod, Tdis
from modflow6_torch.utils.mf6io import load_simulation

SIZES = {"sfr": 4, "lak": 2, "maw": 2}


def run_pair(movers, avail, sizes=SIZES):
    """run_movers of both packages on the same movers and availabilities;
    the outputs must be bitwise equal.  Returns the port's."""
    got = mvr.run_movers(mvr.build_mvr(movers, device="cpu"),
                         {k: x_of(v) for k, v in avail.items()}, sizes)
    want = jmvr.run_movers(jmvr.build_mvr(movers),
                           {k: jnp.asarray(v, jnp.float64)
                            for k, v in avail.items()}, sizes)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(g[key].numpy(),
                                          np.asarray(w[key]), err_msg=key)
    return got


def mover(provider, iprov, receiver, ircv, mvrtype, value):
    return dict(provider=provider, iprov=iprov, receiver=receiver,
                ircv=ircv, mvrtype=mvrtype, value=value)


# ---------------------------------------------------------- the chain

def test_mvr_rules():
    """tests/test_mvr.py::test_mvr_rules: the four qrcalc rules."""
    avail = {"drn": [10.0, 4.0]}
    for (iprov, typ, value), want in (
            ((0, "factor", 0.25), 2.5), ((0, "excess", 7.0), 3.0),
            ((1, "excess", 7.0), 0.0), ((0, "threshold", 6.0), 6.0),
            ((1, "threshold", 6.0), 0.0), ((1, "upto", 6.0), 4.0)):
        qp, _, _ = run_pair([mover("drn", iprov, "sfr", 0, typ, value)],
                            avail)
        np.testing.assert_allclose(qp.numpy(), [want])


def test_mvr_sequential_consumption():
    """tests/test_mvr.py: movers on one entry consume it in order; FACTOR
    takes its share of the total, capped by what remains."""
    movers = [mover("drn", 0, "sfr", 0, "upto", 6.0),
              mover("drn", 0, "lak", 0, "upto", 6.0),
              mover("drn", 0, "maw", 0, "factor", 0.5)]
    qp, qto, qfrom = run_pair(movers, {"drn": [10.0]})
    np.testing.assert_allclose(qp.numpy(), [6.0, 4.0, 0.0])
    np.testing.assert_allclose(qto["drn"].numpy(), [10.0])
    np.testing.assert_allclose(qfrom["lak"].numpy(), [4.0, 0.0])


@pytest.mark.parametrize("seed", range(4))
def test_run_movers_bitwise_on_seeded_chains(seed):
    """Seeded chains over every provider kind and rule, many movers per
    provider entry and per receiver entry, a receiver outside
    ``recv_sizes`` (its water is dropped, as in the reference)."""
    rng = np.random.default_rng(seed)
    avail = {"wel": rng.uniform(0, 5, 6), "drn": rng.uniform(0, 5, 3),
             "ghb": np.zeros(2), "sfr": rng.uniform(0, 5, 7),
             "lak": rng.uniform(0, 5, 2), "maw": rng.uniform(0, 1, 4)}
    sizes = {"sfr": 7, "lak": 3, "maw": 4}
    movers = []
    for _ in range(60):
        p = str(rng.choice(list(avail)))
        r = str(rng.choice(list(sizes) + ["uzf"]))
        movers.append(mover(
            p, int(rng.integers(len(avail[p]))), r,
            int(rng.integers(sizes.get(r, 1))), str(rng.choice(mvr.RULES)),
            float(rng.uniform(0, 1) if rng.random() < 0.5
                  else rng.uniform(0, 4))))
    run_pair(movers, avail, sizes)


def test_rounds_group_movers_by_provider_entry():
    """A mover's round is its rank among the movers on its provider entry;
    each round holds an entry once, in mover order."""
    movers = [mover("drn", 0, "sfr", 0, "upto", 1.0),
              mover("sfr", 2, "lak", 0, "factor", 0.5),
              mover("drn", 0, "lak", 1, "excess", 1.0),
              mover("drn", 1, "sfr", 1, "upto", 1.0),
              mover("sfr", 2, "maw", 0, "threshold", 1.0),
              mover("drn", 0, "maw", 1, "factor", 0.2)]
    data = mvr.build_mvr(movers, device="cpu")
    assert [r.tolist() for r in data.rounds] == [[0, 1, 3], [2, 4], [5]]
    assert mvr.build_mvr([], device="cpu").rounds == ()
    qp, qto, qfrom = mvr.run_movers(
        mvr.build_mvr([], device="cpu"), {"drn": x_of([1.0])}, {"sfr": 2})
    assert qp.shape == (0,) and qto["drn"].tolist() == [0.0]
    assert qfrom["sfr"].tolist() == [0.0, 0.0]


def test_mover_errors_raise_by_name():
    """build_mvr's unknown provider, receiver and rule (the reference's
    errors), and, in the port alone, an entry out of range, which the
    reference's ``.at[]`` would drop."""
    for bad, what in ((dict(provider="chd"), "provider"),
                      (dict(receiver="wel"), "receiver"),
                      (dict(mvrtype="all"), "type")):
        m = dict(mover("drn", 0, "sfr", 0, "upto", 1.0), **bad)
        with pytest.raises(ValueError, match=what):
            mvr.build_mvr([m], device="cpu")
        with pytest.raises(ValueError, match=what):
            jmvr.build_mvr([m])
    data = mvr.build_mvr([mover("drn", 3, "sfr", 0, "upto", 1.0)],
                         device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        mvr.run_movers(data, {"drn": x_of([1.0])}, {"sfr": 1})


# ----------------------------------------- tests/test_mvr.py scenarios

def _chain_base(drn):
    """tests/test_mvr.py:_chain_model's 1 x 8 aquifer held by CHD."""
    grid = dict(nlay=1, nrow=1, ncol=8, delr=100.0, delc=100.0, top=50.0,
                botm=np.zeros((1, 1, 8)))
    return grid, dict(k=5.0, strt=30.0, chd=[(0, 30.0), (7, 30.0)],
                      drn=[drn])


def _reaches(nreach, qin):
    return [dict(node=r + 2, cond=0.0, strtop=40.0 + 0.1 * (nreach - r),
                 width=3.0, rough=0.03, slope=1e-3, length=100.0,
                 strt=40.3 + 0.1 * (nreach - r),
                 inflow=qin if r == 0 else 0.0,
                 upstream=[(r - 1, 1.0)] if r > 0 else [])
            for r in range(nreach)]


def both(grid, base_kw, movers, maw=None, lak=None, sfr=None):
    """(reference, port) augmented models with movers."""
    jg, tg = JaxDisGrid.create(**grid), DisGrid.create(**grid)
    jb = jax_build_gwf("ref", jg, **base_kw)
    tb = build_gwf("port", tg, device="cpu", **base_kw)
    jm = jadv.AugmentedGwfModel(
        jb, maw=None if maw is None else jadv.build_maw(maw, jg),
        lak=None if lak is None else jadv.build_lak(*lak),
        sfr=None if sfr is None else jadv.build_sfr(sfr), mvr=movers)
    tm = AugmentedGwfModel(
        tb, maw=None if maw is None else build_maw(maw, tg),
        lak=None if lak is None else build_lak(*lak),
        sfr=None if sfr is None else build_sfr(sfr), mvr=movers)
    return jm, tm


def assert_same_budgets(jm, tm, x, x_old, delt):
    """advanced_budget, boundary_budget and mvr_budget of both at x."""
    xj, xt = jnp.asarray(x), x_of(x)
    got = tm.advanced_budget(xt, x_of(x_old), delt, False)
    want = jm.advanced_budget(xj, jnp.asarray(x_old), delt, False)
    assert got.keys() == want.keys()
    for key in want:
        close(got[key], want[key])
    ibt, _ = tm.boundary_state(xt)
    ibj, _ = jm.boundary_state(xj)
    got = tm.boundary_budget(xt, ibt)
    want = jm.boundary_budget(xj, ibj)
    for key in want:
        if want[key] is not None:
            close(got[key], want[key])
    for g, w in zip(tm.mvr_budget(xt), jm.mvr_budget(xj)):
        assert g[:4] == w[:4]
        assert float(g[4]) == float(w[4])


def solve(jm, tm, steps, delt):
    """Both packages through ``steps`` transient steps; heads within
    HEAD_ATOL at the end.  Returns the port's x."""
    jsol = JaxSolution(jm, JaxImsSettings(**dict(SETTINGS,
                                                 outer_maximum=200)))
    tsol = NumericalSolution(tm, ImsSettings(**dict(SETTINGS,
                                                    outer_maximum=200)))
    xj, xt = jnp.asarray(jm.strt), tm.strt
    for k in range(steps):
        xj, ij, _ = jsol.solve_timestep(xj, delt, kstp=k + 1, iss=False)
        xt, it, _ = tsol.solve_timestep(xt, delt, kstp=k + 1, iss=False)
        assert ij.converged and it.converged
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=HEAD_ATOL)
    return xt


def test_mvr_sfr_to_lak_to_maw_chain():
    """tests/test_mvr.py:100: SFR's terminal outflow into a lake, the
    lake's specified outlet into a well: the systems at a perturbed
    iterate, the solves, the budget terms and the reference test's
    balances."""
    grid, kw = _chain_base((3, 35.0, 2.0))
    lakes = [dict(strt=20.0, surf_area=1e4, bottom=15.0,
                  connections=[(5, 1e-6, 18.0)])]
    outlets = [dict(lake=0, to=-1, type="specified", rate=0.8)]
    wells = [dict(radius=0.2, strt=30.0, rate=0.0, connections=[(6, 10.0)])]
    movers = [mover("sfr", 3, "lak", 0, "factor", 1.0),
              mover("lak", 0, "maw", 0, "factor", 1.0)]
    jm, tm = both(grid, kw, movers, maw=wells, lak=(lakes, outlets),
                  sfr=_reaches(4, 2.0))
    x0 = np.asarray(jm.strt) + np.random.default_rng(0).normal(
        0.0, 0.2, jm.nodes)
    for iss in (False, True):
        assert_same_system(jm, tm, x0, x0 + 0.05, delt=2e4, iss=iss)
    x = solve(jm, tm, 30, 2e4)
    assert_same_budgets(jm, tm, x.numpy(), x.numpy(), 2e4)
    ib, _ = tm.boundary_state(x)
    qp, _, _ = tm.eval_movers(x, ib)
    np.testing.assert_allclose(qp.numpy(), [2.0, 0.8], rtol=1e-6)
    bud = tm.advanced_budget(x, x, 2e4, False)
    np.testing.assert_allclose(float(bud["LAK-FROM-MVR"].sum()), 2.0,
                               rtol=1e-6)
    np.testing.assert_allclose(float(bud["MAW-FROM-MVR"].sum()), 0.8,
                               rtol=1e-6)
    np.testing.assert_allclose(float(bud["SFR-OUT"][-1]), 0.0, atol=1e-9)


def test_mvr_drn_to_sfr_mass_balance():
    """tests/test_mvr.py:152: a discharging drain feeds the stream; the
    provider's own rate shrinks by the moved slice (DRN-TO-MVR)."""
    grid, kw = _chain_base((3, 25.0, 4.0))
    reaches = [dict(node=2, cond=0.0, strtop=40.0, width=3.0, rough=0.03,
                    slope=1e-3, length=100.0, strt=40.2, inflow=1.0),
               dict(node=3, cond=0.0, strtop=39.9, width=3.0, rough=0.03,
                    slope=1e-3, length=100.0, strt=40.1,
                    upstream=[(0, 1.0)])]
    jm, tm = both(grid, kw, [mover("drn", 0, "sfr", 1, "factor", 1.0)],
                  sfr=reaches)
    x = solve(jm, tm, 20, 5e4)
    assert_same_budgets(jm, tm, x.numpy(), x.numpy(), 5e4)
    qdrn = 4.0 * (float(x[3]) - 25.0)
    assert qdrn > 0.1
    ib, _ = tm.boundary_state(x)
    np.testing.assert_allclose(float(tm.boundary_budget(x, ib)["DRN"].sum()),
                               0.0, atol=1e-12)
    bud = tm.advanced_budget(x, x, 5e4, False)
    np.testing.assert_allclose(-float(bud["SFR-OUT"][1]), 1.0 + qdrn,
                               rtol=1e-6)


def test_mover_presence_is_checked():
    """tests/test_mvr.py::test_mvr_validation: a provider or receiver the
    model lacks raises ValueError in both, UZF among them (the augmented
    model carries no UZF columns in either package)."""
    grid = dict(nlay=1, nrow=1, ncol=4, delr=100.0, delc=100.0, top=50.0,
                botm=np.zeros((1, 1, 4)))
    kw = dict(k=5.0, strt=30.0, chd=[(0, 30.0)])
    reach = [dict(node=1, cond=0.0, strtop=40.0, width=3.0, rough=0.03,
                  slope=1e-3, length=100.0, strt=40.2, inflow=1.0)]
    jb = jax_build_gwf("ref", JaxDisGrid.create(**grid), **kw)
    tb = build_gwf("port", DisGrid.create(**grid), device="cpu", **kw)
    for m, what in ((mover("drn", 0, "sfr", 0, "factor", 1.0), "provider"),
                    (mover("uzf", 0, "sfr", 0, "factor", 1.0), "provider"),
                    (mover("sfr", 0, "uzf", 0, "factor", 1.0), "receiver"),
                    (mover("sfr", 0, "lak", 0, "factor", 1.0), "receiver")):
        with pytest.raises(ValueError, match=f"{what}.*not present"):
            jadv.AugmentedGwfModel(jb, sfr=jadv.build_sfr(reach), mvr=[m])
        with pytest.raises(ValueError, match=f"{what}.*not present"):
            AugmentedGwfModel(tb, sfr=build_sfr(reach), mvr=[m])


def test_convert_carries_the_movers():
    """from_reference with the reference model's mvr_ fields builds the
    same movers and the same system."""
    grid, kw = _chain_base((3, 25.0, 4.0))
    movers = [mover("drn", 0, "sfr", 1, "upto", 0.5),
              mover("sfr", 0, "sfr", 1, "excess", 0.1)]
    jm, tm = both(grid, kw, movers, sfr=_reaches(2, 1.0))
    arrays, kwargs = reference_arrays(jm.base)
    arrays.update({f"drn_{k}": np.asarray(getattr(jm.base.drn, k))
                   for k in ("node", "elev", "cond", "ddrn", "mask")})
    arrays.update(augmented_state(jm))
    assert arrays["mvr_prov_pkg"] == ("drn", "sfr")
    cm = from_reference(arrays, device="cpu", grid=DisGrid.create(**grid),
                        **kwargs)
    assert cm.mvr.prov_id == tm.mvr.prov_id
    assert cm.mvr.mvrtype == tm.mvr.mvrtype
    x = np.asarray(jm.strt) + 0.3
    assert_same_system(jm, cm, x)


def test_simulation_budget_has_the_movers():
    """A WEL provider moved into a lake through ``Simulation``: the budget
    table carries WEL (reduced by the moved water) and WEL-TO-MVR, as the
    reference's does; heads within HEAD_ATOL at every step."""
    grid, kw = _chain_base((3, 25.0, 4.0))
    kw = dict(kw, wel=[(4, -3.0), (2, -1.0)],
              storage={"ss": 1e-5, "iconvert": 0})
    lakes = [dict(strt=31.0, surf_area=1e4, bottom=15.0,
                  connections=[(5, 1e-3, 18.0)])]
    movers = [mover("wel", 0, "lak", 0, "factor", 0.5),
              mover("wel", 0, "lak", 0, "upto", 1.0),
              mover("drn", 0, "lak", 0, "threshold", 0.5)]
    jm, tm = both(grid, kw, movers, lak=(lakes, []))
    periods = [(10.0, 3, 1.0)]
    s = dict(SETTINGS, outer_maximum=200)
    jsim = JaxSimulation(JaxTdis(tuple(JaxPeriod(*p) for p in periods)), jm,
                         JaxImsSettings(**s))
    tsim = Simulation(Tdis(tuple(StressPeriod(*p) for p in periods)), tm,
                      ImsSettings(**s))
    jrecs, trecs = jsim.run(), tsim.run()
    for g, w in zip(trecs, jrecs):
        assert g.converged and w.converged
        np.testing.assert_allclose(g.head, w.head, rtol=0, atol=HEAD_ATOL)
    assert list(tsim.budget.terms) == list(jsim.budget.terms)
    assert "WEL-TO-MVR" in tsim.budget.terms
    for name, w in jsim.budget.terms.items():
        g = tsim.budget.terms[name]
        for field in ("rate_in", "rate_out"):
            np.testing.assert_allclose(getattr(g, field), getattr(w, field),
                                       rtol=1e-9, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(tsim.budget.terms["WEL-TO-MVR"].rate_out, 2.5,
                               rtol=1e-12)


# ----------------------------------------------------------------- decks

MVR_DECK = """BEGIN OPTIONS
END OPTIONS
BEGIN DIMENSIONS
  MAXMVR 2
  MAXPACKAGES 3
END DIMENSIONS
BEGIN PACKAGES
  DRN-1
  SFR-1
  WEL-1
END PACKAGES
BEGIN PERIOD 1
  DRN-1 1 SFR-1 2 FACTOR 1.0
  WEL-1 1 SFR-1 1 UPTO 0.5
END PERIOD
{period2}"""


def write_mvr_deck(ws, period2="", wel_opts="  MOVER\n"):
    """tests/test_advanced_decks.py::test_sfr_mvr_deck (DRN discharge
    moved into an SFR chain) with a WEL provider, the list packages'
    MOVER option, and an optional later MVR6 PERIOD block."""
    _sim_files(ws, "  DRN6 model.drn drn-1\n  WEL6 model.wel\n"
               "  SFR6 model.sfr sfr-1\n  MVR6 model.mvr mvr", nper=2,
               perlen="25000.0 5 1.0")
    write(ws, "model.drn", "BEGIN OPTIONS\n  MOVER\nEND OPTIONS\n"
          "BEGIN DIMENSIONS\n  MAXBOUND 1\nEND DIMENSIONS\n"
          "BEGIN PERIOD 1\n  1 1 4 25.0 4.0\nEND PERIOD\n")
    write(ws, "model.wel", f"BEGIN OPTIONS\n{wel_opts}END OPTIONS\n"
          "BEGIN DIMENSIONS\n  MAXBOUND 1\nEND DIMENSIONS\n"
          "BEGIN PERIOD 1\n  1 1 6 -2.0\nEND PERIOD\n")
    write(ws, "model.sfr", """BEGIN OPTIONS
  MOVER
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
""")
    write(ws, "model.mvr", MVR_DECK.format(period2=period2))


def test_mvr_deck_matches_reference(tmp_path):
    """The MVR6 deck through both loaders: the same loaded state (movers
    among it), heads within DECK_ATOL at every step, the budgets' mover
    terms; a PERIOD 2 block replaces the movers at the period's start."""
    ws = str(tmp_path)
    write_mvr_deck(ws, period2="BEGIN PERIOD 2\n"
                   "  DRN-1 1 SFR-1 2 EXCESS 0.5\nEND PERIOD\n")
    assert_same_state(simulation_state(load_simulation(ws, device="cpu")),
                      simulation_state(ref_load(ws)))
    sim, ref = run_both(tmp_path)
    assert sim.model.mvr.mvrtype == ("excess",)
    assert ref.model.mvr.mvrtype == ("excess",)
    for name, w in ref.budget.terms.items():
        np.testing.assert_allclose(sim.budget.terms[name].cum_out,
                                   w.cum_out, rtol=1e-7, atol=1e-9,
                                   err_msg=name)
    assert "DRN-TO-MVR" in sim.budget.terms
    x, info, _ = sim.solution.solve_timestep(sim.model.strt, delt=5e4,
                                             kstp=1, iss=False)
    assert info.converged
    ib, _ = sim.model.boundary_state(x)
    qp, _, _ = sim.model.eval_movers(x, ib)
    qdrn = 4.0 * (float(x[3]) - 25.0)
    np.testing.assert_allclose(float(qp[0]), max(qdrn - 0.5, 0.0),
                               rtol=1e-9)
    q_man, _ = sim.model.sfr._manning(x[N_GRID:])
    assert float(q_man[1]) > 1.0


@pytest.mark.parametrize("case", ["modelnames", "second-instance"])
def test_mvr_deck_refusals(case, tmp_path):
    """The port refuses by name where the reference would misread: a
    model's MVR6 with MODELNAMES (records of an exchange's mover), and a
    mover on the second of two packages of one type (the loader merges
    their entries, so its entry numbers would name another package's)."""
    ws = str(tmp_path)
    write_mvr_deck(ws)
    if case == "modelnames":
        text = MVR_DECK.format(period2="").replace(
            "BEGIN OPTIONS\n", "BEGIN OPTIONS\n  MODELNAMES\n")
        write(ws, "model.mvr", text)
        match = "MODELNAMES"
    else:
        nam = (tmp_path / "model.nam").read_text().replace(
            "  WEL6 model.wel\n", "  WEL6 model.wel\n  WEL6 model2.wel\n")
        (tmp_path / "model.nam").write_text(nam)
        write(ws, "model2.wel", (tmp_path / "model.wel").read_text())
        write(ws, "model.mvr", MVR_DECK.format(period2="").replace(
            "WEL-1", "WEL-2"))
        match = "WEL-2"
    with pytest.raises(NotImplementedError, match=match):
        load_simulation(ws, device="cpu")
