"""UZF of the port (modflow6_torch/models/gwf/uzf.py, the UZF loop of
``Simulation``, UZF6 in the loader) against the reference
(modflow6_tpu/models/gwf/uzf.py and its ``Simulation`` and loader): the
column march and the head-dependent terms on the same seeded inputs, the
scenarios of tests/test_uzf.py through both packages, a UZF6 deck with a
second period through both loaders, the loader's column arrays against the
reference's per-column loop, and the options the port refuses.

Tolerances:

- ``advance`` (theta, rch, rej, uzet, gwpet, wc) and ``uzf_matrix_terms``:
  relative 1e-12 with ``nsub`` equal.  The march is not bitwise: XLA's and
  PyTorch's f64 ``pow`` differ in the last bit on some arguments (shown by
  ``test_pow_differs_in_the_last_bit``), and XLA's compiled sub-step may
  contract a product and a sum into one rounding; with the reference's
  ``pow`` in the port's flux and the reference run op by op, the march is
  bitwise (``test_march_is_bitwise_with_the_reference_pow``);
- ``Simulation`` with UZF: equal outer counts, equal solves per step (the
  uzf_cc passes), heads within 1e-10, budget terms within 1e-9;
- the loader's columns: equal arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_advanced_decks import _sim_files, write
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf import uzf as juzf
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.simulation import Simulation as JaxSimulation
from modflow6_tpu.ops import smoothing as jsmooth
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
from modflow6_tpu.timing.tdis import Tdis as JaxTdis
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.convert import simulation_from_reference, uzf_state
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf import uzf
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.simulation import Simulation
from modflow6_torch.ops.smoothing import s_cubic_linear
from modflow6_torch.solution import ImsSettings
from modflow6_torch.timing.tdis import StressPeriod, Tdis
from modflow6_torch.utils.mf6io import load_simulation

RTOL = 1e-12
HEAD_ATOL = 1e-10
FIELDS = ("theta", "rch", "rej", "uzet", "gwpet", "wc", "finf_top")


def t(a):
    return torch.tensor(np.asarray(a, np.float64))


def close(got, want, rtol=RTOL, scale=0.0):
    """Within ``rtol`` of the reference, and of its largest entry (or of
    ``scale``, the size of the operands a difference cancels)."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=rtol * max(np.abs(want).max(), scale, 1e-300))


def columns(seed, C, flooded=0):
    """Seeded columns over nodes 0..C-1 of a cell 0..10 m high, the last
    ``flooded`` of them under a head above land surface."""
    rng = np.random.default_rng(seed)
    cols = dict(node=np.arange(C), vks=rng.uniform(0.05, 1.0, C),
                thtr=rng.uniform(0.03, 0.08, C), thts=rng.uniform(0.3, 0.4, C),
                eps=rng.uniform(3.0, 4.5, C), celtop=np.full(C, 10.0),
                celbot=np.zeros(C), surfdep=rng.uniform(0.2, 1.0, C),
                area=rng.uniform(50.0, 150.0, C),
                finf=rng.uniform(0.0, 0.6, C), pet=rng.uniform(0.0, 0.05, C),
                extdp=rng.uniform(1.0, 4.0, C), extwc=rng.uniform(0.08, 0.12, C))
    cols["thti"] = cols["thtr"] + rng.uniform(0.0, 0.2, C)
    head = rng.uniform(1.0, 9.5, C)
    head[C - flooded:] = 10.0 + rng.uniform(-0.1, 0.8, flooded)
    return cols, head, rng.uniform(0.0, 9.0, C)


def entries(cols):
    return [{k: (int(v[i]) if k == "node" else float(v[i]))
             for k, v in cols.items()} for i in range(len(cols["node"]))]


def both(cols, **flags):
    return (juzf.make_uzf(entries(cols), **flags),
            uzf.make_uzf(cols, device="cpu", **flags))


def assert_same_result(got, want, cols):
    """``cols``: the port's columns; gwpet = pet − uzet cancels to zero
    where the profile meets the demand, so it is held to pet's size."""
    assert got.nsub > 0
    pet = float(cols.pet.max())
    for name in FIELDS:
        close(getattr(got, name), getattr(want, name),
              scale=pet if name == "gwpet" else 0.0)
    np.testing.assert_array_equal(got.sat_col.numpy(),
                                  np.asarray(want.sat_col))
    np.testing.assert_array_equal(got.watab.numpy(), np.asarray(want.watab))


# ------------------------------------------------------------ the march

@pytest.mark.parametrize("case", ["decoupled", "coupled", "et-seep"])
def test_advance_matches_reference(case):
    """One march from seeded columns: decoupled (no head), at a head with
    the uz_rise release, and with unsaturated ET and a flooded column."""
    flags = dict(nz=20)
    if case == "et-seep":
        flags.update(ietflag=1, iseepflag=1, igwetflag=1)
    cols, head, wold = columns(7, 40, flooded=4 if case == "et-seep" else 0)
    ju, tu = both(cols, **flags)
    kw_j, kw_t = {}, {}
    if case != "decoupled":
        kw_j = dict(head=jnp.asarray(head), watab_old=jnp.asarray(wold))
        kw_t = dict(head=t(head), watab_old=t(wold))
    theta_j, theta_t = juzf.initial_theta(ju), uzf.initial_theta(tu)
    for delt in (0.7, 2.5):
        want = juzf.advance(ju, theta_j, delt, **kw_j)
        got = uzf.advance(tu, theta_t, delt, **kw_t)
        assert_same_result(got, want, tu)
        want_nsub = int(np.ceil(float(jnp.max(
            ju.vks * ju.eps / (ju.thts - ju.thtr) * delt
            / ((ju.celtop - ju.celbot) / ju.nz))) * 1.05)) + 1
        assert got.nsub == want_nsub
        theta_j, theta_t = want.theta, got.theta


def test_uzf_matrix_terms_match_reference():
    """hcof, rhs and the budget parts at iterates below, inside and above
    the surface band, flooded columns among them."""
    cols, head, wold = columns(3, 30, flooded=6)
    flags = dict(ietflag=1, iseepflag=1, igwetflag=1)
    ju, tu = both(cols, **flags)
    res_j = juzf.advance(ju, juzf.initial_theta(ju), 1.5,
                         head=jnp.asarray(head), watab_old=jnp.asarray(wold))
    res_t = uzf.advance(tu, uzf.initial_theta(tu), 1.5, head=t(head),
                        watab_old=t(wold))
    sj, st = juzf.make_step(ju, res_j), uzf.make_step(tu, res_t)
    ib = np.ones(30, np.int32)
    ib[2] = 0
    for dh in (-0.5, 0.0, 0.35):
        h = head + dh
        want = juzf.uzf_matrix_terms(sj, jnp.asarray(h), jnp.asarray(ib))
        got = uzf.uzf_matrix_terms(st, t(h), torch.tensor(ib))
        close(got[0], want[0])
        close(got[1], want[1])
        assert got[2].keys() == want[2].keys()
        for key in want[2]:
            close(got[2][key], want[2][key])


def test_s_cubic_linear_matches_reference():
    x = np.linspace(-0.5, 1.5, 41)
    for srange in (0.2, 1.0, 0.0):
        want = jsmooth.s_cubic_linear(jnp.asarray(x), jnp.asarray(srange))
        got = s_cubic_linear(t(x), t(srange))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pow_differs_in_the_last_bit():
    """The cause of the 1e-12 bar: XLA's and PyTorch's f64 ``pow`` differ
    by one ulp on some of the march's arguments (srel in [0, 1], eps 3-4.5)."""
    rng = np.random.default_rng(11)
    srel, eps = rng.uniform(0.0, 1.0, 20000), rng.uniform(3.0, 4.5, 20000)
    want = np.asarray(jnp.asarray(srel) ** jnp.asarray(eps))
    got = (t(srel) ** t(eps)).numpy()
    rel = np.abs(got - want) / want
    assert (got != want).any()
    assert rel.max() <= 2.3e-16


def test_march_is_bitwise_with_the_reference_pow(monkeypatch):
    """With the reference's ``pow`` in the port's flux and the reference
    run op by op (its compiled scan body may fuse a multiply-add), the
    march (no ET, whose sums follow each library's reduction order) is
    bitwise."""
    def flux(u, theta):
        srel = torch.clamp((theta - u.thtr[:, None])
                           / (u.thts - u.thtr)[:, None], 0.0, 1.0)
        p = jnp.asarray(srel.numpy()) ** jnp.asarray(u.eps[:, None].numpy())
        return u.vks[:, None] * torch.tensor(np.asarray(p))

    monkeypatch.setattr(uzf, "_flux", flux)
    cols, head, _ = columns(5, 25)
    ju, tu = both(cols)
    with jax.disable_jit():
        want = juzf.advance(ju, juzf.initial_theta(ju), 1.3,
                            head=jnp.asarray(head))
    got = uzf.advance(tu, uzf.initial_theta(tu), 1.3, head=t(head))
    for name in ("theta", "rch", "rej"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_make_uzf_forms_equal_reference():
    """Dict entries, legacy 9-tuples and column arrays give the
    reference's arrays; the columns carry their plan into every step."""
    cols, _, _ = columns(2, 6)
    legacy = [(0, 1.0, 0.05, 0.35, 0.05, 3.5, 10.0, 1.0, 0.25),
              (3, 0.5, 0.06, 0.3, 0.1, 4.0, 5.0, 2.0, 0.1)]
    for ent in (entries(cols), legacy,
                [dict(node=1, vks=1.0, thtr=0.05, thts=0.35, thti=0.1,
                      eps=3.5)]):
        want = juzf.make_uzf(ent, nz=12, ietflag=1)
        got = uzf.make_uzf(ent, nz=12, ietflag=1, device="cpu")
        for name in uzf.COLUMN_FIELDS:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        assert (got.nz, got.ietflag) == (want.nz, want.ietflag)
    tu = uzf.make_uzf(cols, device="cpu")
    res = uzf.advance(tu, uzf.initial_theta(tu), 1.0)
    assert uzf.make_step(tu, res).add_plan is tu.add_plan


# ------------------------------------------- tests/test_uzf.py twins

def _column_runs(case):
    """(make_uzf args, steps of (delt, kwargs)) of the single-column
    scenarios of tests/test_uzf.py."""
    if case == "wetting-front":
        return ([(0, 1.0, 0.05, 0.35, 0.05, 3.5, 10.0, 1.0, 0.25)],
                dict(nz=120), [(0.8, {})] * 15)
    if case == "rejected":
        return ([(0, 1.0, 0.05, 0.35, 0.05, 3.5, 5.0, 1.0, 2.5)],
                dict(nz=30), [(1.0, {})])
    if case == "uz-rise":
        col = dict(node=0, vks=1.0, thtr=0.05, thts=0.35, thti=0.20,
                   eps=3.5, celtop=10.0, celbot=0.0, area=1.0, finf=0.0)
        return ([col], dict(nz=100),
                [(0.5, dict(head=[6.0], watab_old=[2.0]))])
    col = dict(node=0, vks=1e-9, thtr=0.05, thts=0.35, thti=0.30, eps=3.5,
               celtop=4.0, celbot=0.0, area=1.0, finf=0.0, pet=0.05,
               extdp=2.0, extwc=0.10)
    return [col], dict(nz=40, ietflag=1), [(1.0, dict(nsub=1))] * 12


@pytest.mark.parametrize("case", ["wetting-front", "rejected", "uz-rise",
                                  "unsat-et"])
def test_column_scenarios_match_reference(case):
    """tests/test_uzf.py's single-column marches: every step of the port
    within 1e-12 of the reference's, and the reference test's own checks
    on the port's results."""
    ent, flags, steps = _column_runs(case)
    ju = juzf.make_uzf(ent, **flags)
    tu = uzf.make_uzf(ent, device="cpu", **flags)
    th_j, th_t = juzf.initial_theta(ju), uzf.initial_theta(tu)
    rch, uzet = [], []
    for delt, kw in steps:
        kj = {k: (jnp.asarray(v) if k != "nsub" else v)
              for k, v in kw.items()}
        kt = {k: (t(v) if k != "nsub" else v) for k, v in kw.items()}
        want = juzf.advance(ju, th_j, delt, **kj)
        got = uzf.advance(tu, th_t, delt, **kt)
        assert_same_result(got, want, tu)
        th_j, th_t = want.theta, got.theta
        rch.append(float(got.rch[0]))
        uzet.append(float(got.uzet[0]) * delt)
    if case == "wetting-front":
        thetaf = 0.05 + 0.3 * (0.25 / 1.0) ** (1.0 / 3.5)
        t_star = 10.0 * (thetaf - 0.05) / 0.25
        times = 0.8 * np.arange(1, 16)
        assert max(r for r, tt in zip(rch, times) if tt < 0.8 * t_star) \
            < 0.02 * 0.25
    elif case == "rejected":
        np.testing.assert_allclose(float(got.rej[0]), 1.5, rtol=1e-6)
    elif case == "uz-rise":
        assert rch[0] * 0.5 >= 0.15 * 4.0 - 1e-8
    else:
        zc = 4.0 - (np.arange(40) + 0.5) * 0.1
        np.testing.assert_allclose(th_t.numpy()[0][zc > 2.0], 0.10,
                                   atol=1e-5)


def _count_solves(sim):
    """Wrap a Simulation's solution so that the solves per step count."""
    calls = []
    solve = sim.solution.solve_timestep

    def counted(*args, **kwargs):
        calls.append(args[1] if len(args) > 1 else kwargs["delt"])
        return solve(*args, **kwargs)

    sim.solution.solve_timestep = counted
    return calls


def _coupled(case):
    """(grid, build_gwf kwargs, tdis, column, flags, settings) of the two
    coupled scenarios of tests/test_uzf.py."""
    settings = dict(outer_dvclose=1e-8, inner_dvclose=1e-10,
                    inner_rclose=1e-9, inner_maximum=500)
    if case == "recharge":
        grid = dict(nlay=1, nrow=3, ncol=5, delr=10.0, delc=10.0, top=20.0,
                    botm=np.zeros((1, 3, 5)))
        kw = dict(k=5.0, strt=5.0, storage={"ss": 1e-3, "iconvert": 0},
                  chd=[(i * 5, 5.0) for i in range(3)])
        col = dict(node=9, vks=1.0, thtr=0.05, thts=0.35, thti=0.05,
                   eps=3.5, celtop=20.0, celbot=18.0, area=100.0, finf=0.3)
        # tests/test_uzf.py:180 runs 8 steps over 40 days at nz = 40; the
        # front arrives after 1.4 days, and the twin stops at 20
        return grid, kw, [(20.0, 4, 1.0)], col, dict(nz=20), settings
    # tests/test_uzf.py:202 mounds the head from 5 to land surface over
    # 40 steps at nz = 30; the twin starts the mound near the surface and
    # runs 5 steps at nz = 10
    grid = dict(nlay=1, nrow=1, ncol=5, delr=10.0, delc=10.0, top=12.0,
                botm=np.zeros((1, 1, 5)))
    kw = dict(k=0.02, strt=[5.0, 9.0, 9.5, 9.8, 9.9],
              storage={"ss": 1e-4, "iconvert": 0}, chd=[(0, 5.0)])
    col = dict(node=4, vks=0.5, thtr=0.05, thts=0.35, thti=0.05, eps=3.5,
               celtop=10.0, celbot=8.0, surfdep=0.2, area=100.0, finf=0.05)
    return (grid, kw, [(100.0, 5, 1.05)], col,
            dict(nz=10, iseepflag=1), dict(settings, outer_maximum=100))


@pytest.mark.parametrize("case", ["recharge", "seepage"])
def test_simulation_with_uzf_matches_reference(case):
    """tests/test_uzf.py's coupled runs (a column recharging a mound; a
    mound capped at land surface by the seepage drain) through both
    Simulations: equal outer counts and uzf_cc solves per step, heads
    within 1e-10, the budget terms (UZF-GWRCH, UZF-GWD among them) within
    1e-9, and the reference test's checks on the port."""
    grid, kw, periods, col, flags, settings = _coupled(case)
    jsim = JaxSimulation(
        JaxTdis(tuple(JaxPeriod(*p) for p in periods)),
        jax_build_gwf("uz", JaxDisGrid.create(**grid), **kw),
        JaxImsSettings(**settings))
    tsim = Simulation(Tdis(tuple(StressPeriod(*p) for p in periods)),
                      build_gwf("uz", DisGrid.create(**grid), device="cpu",
                                **kw), ImsSettings(**settings))
    jsim.uzf = juzf.make_uzf([col], **flags)
    tsim.uzf = uzf.make_uzf([col], device="cpu", **flags)
    jcalls, tcalls = _count_solves(jsim), _count_solves(tsim)
    jrecs, trecs = jsim.run(), tsim.run()
    assert all(r.converged for r in trecs)
    assert [r.outer for r in trecs] == [r.outer for r in jrecs]
    assert tcalls == jcalls
    assert sum(r.uzf_resolves for r in trecs) == len(tcalls) - len(trecs)
    for g, w in zip(trecs, jrecs):
        np.testing.assert_allclose(g.head, w.head, rtol=0, atol=HEAD_ATOL)
    assert list(tsim.budget.terms) == list(jsim.budget.terms)
    scale = jsim.budget.total_in
    for name, w in jsim.budget.terms.items():
        g = tsim.budget.terms[name]
        for field in ("rate_in", "rate_out", "cum_in", "cum_out"):
            np.testing.assert_allclose(getattr(g, field), getattr(w, field),
                                       rtol=1e-9, atol=1e-12 * scale,
                                       err_msg=name)
    if case == "recharge":
        assert abs(tsim.budget.percent_discrepancy()) < 1e-4
        assert trecs[-1].head[col["node"]] > 5.05
    else:
        assert 10.0 - 0.05 < trecs[-1].head[4] < 10.0 + 0.25
        assert abs(tsim.budget.percent_discrepancy()) < 0.01


# ----------------------------------------------------------------- decks

UZF_DECK = """BEGIN OPTIONS
  SIMULATE_ET
  LINEAR_GWET
  SIMULATE_GWSEEP
{options}END OPTIONS
BEGIN DIMENSIONS
  NUZFCELLS {n}
END DIMENSIONS
BEGIN PACKAGEDATA
{pdata}
END PACKAGEDATA
BEGIN PERIOD 1
{per1}
END PERIOD
BEGIN PERIOD 2
{per2}
END PERIOD
"""


def write_uzf_deck(ws, options=""):
    """The 1 x 1 x 8 deck of tests/test_advanced_decks.py (CHD at both
    ends) with a UZF column on cells 2-7 (land surface at the cell top,
    LANDFLAG on the odd ones), ET and seepage, and a PERIOD 2 block that
    doubles FINF on four of them; two periods of 2 steps."""
    _sim_files(ws, "  UZF6 model.uzf uzf-1\n  OC6 model.oc oc", nper=2,
               perlen="400.0 2 1.0")
    rng = np.random.default_rng(9)
    cells = range(2, 8)
    pdata = "\n".join(
        f"  {u + 1} 1 1 {c} {u % 2} 0 {0.3 + 0.1 * u!r} "
        f"{rng.uniform(0.05, 0.5)!r} 0.05 0.35 {0.08 + 0.01 * u!r} 3.5"
        for u, c in enumerate(cells))
    finf = rng.uniform(1e-3, 4e-3, len(cells)).tolist()
    per1 = "\n".join(f"  {u + 1} {finf[u]!r} 2e-3 6.0 0.07"
                     for u in range(len(cells)))
    per2 = "\n".join(f"  {u + 1} {2 * finf[u]!r}" for u in range(4))
    write(ws, "model.uzf", UZF_DECK.format(options=options, n=len(cells),
                                           pdata=pdata, per1=per1,
                                           per2=per2))
    write(ws, "model.oc", "BEGIN OPTIONS\n  HEAD FILEOUT model.hds\n"
          "  BUDGET FILEOUT model.cbc\nEND OPTIONS\nBEGIN PERIOD 1\n"
          "  SAVE HEAD ALL\n  SAVE BUDGET ALL\nEND PERIOD\n")


def test_uzf_deck_matches_reference(tmp_path):
    """A UZF6 deck with a second period through both loaders: the
    loader's column arrays equal the reference's per-column loop, heads
    within 1e-10 with equal counts at every step, the budgets and the
    .cbc's UZF records the reference's; the state carried by
    ``simulation_from_reference`` runs to the port's heads bitwise."""
    ws = str(tmp_path)
    write_uzf_deck(ws)
    cbc = str(tmp_path / "port.cbc")
    sim = load_simulation(ws, device="cpu", cbc_path=cbc,
                          hds_path=str(tmp_path / "port.hds"))
    ref = ref_load(ws)
    want = uzf_state(ref.uzf)
    got = uzf_state(sim.uzf)
    assert got["flags"] == want["flags"]
    for key, value in want["columns"].items():
        np.testing.assert_array_equal(got["columns"][key], value,
                                      err_msg=key)
    from test_torch_deck import simulation_state
    state = simulation_state(sim)
    state["uzf"] = got
    conv = simulation_from_reference(state, device="cpu")
    recs, jrecs = sim.run(), ref.run()
    assert len(recs) == 4 and all(r.converged for r in recs)
    assert [(r.outer, r.inner) for r in recs] == \
        [(r.outer, r.inner) for r in jrecs]
    for g, w in zip(recs, jrecs):
        np.testing.assert_allclose(g.head, w.head, rtol=0, atol=HEAD_ATOL)
    np.testing.assert_array_equal(sim.uzf.finf.numpy(),
                                  np.asarray(ref.uzf.finf))
    assert abs(sim.budget.percent_discrepancy()) < 0.01
    for name, w in ref.budget.terms.items():
        np.testing.assert_allclose(sim.budget.terms[name].cum_in, w.cum_in,
                                   rtol=1e-9, atol=1e-12, err_msg=name)
        np.testing.assert_allclose(sim.budget.terms[name].cum_out,
                                   w.cum_out, rtol=1e-9, atol=1e-12,
                                   err_msg=name)
    from modflow6_tpu.utils.binary import read_budget_file
    got = [r for r in read_budget_file(cbc) if r["text"].startswith("UZF")]
    want = [r for r in read_budget_file(f"{ws}/model.cbc")
            if r["text"].startswith("UZF")]
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert {"UZF-GWRCH", "UZF-GWD", "UZF-GWET"} <= {r["text"] for r in got}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["data"][0], w["data"][0])
        close(g["data"][2], w["data"][2], rtol=1e-9)
    crecs = conv.run()
    for c, g in zip(crecs, recs[:2]):
        np.testing.assert_array_equal(c.head, g.head)


@pytest.mark.parametrize("option", ["SQUARE_GWET", "UNSAT_ETAE"])
def test_uzf_options_the_reference_runs_otherwise_raise(option, tmp_path):
    """SQUARE_GWET runs as LINEAR_GWET in the reference and UNSAT_ETAE is
    read past there: the port refuses both by name."""
    write_uzf_deck(str(tmp_path), options=f"  {option}\n")
    with pytest.raises(NotImplementedError, match=option):
        load_simulation(str(tmp_path), device="cpu")
