"""Advanced-package transport in the port (modflow6_torch/models/gwt/apt.py:
LKT, SFT, MWT, UZT and MVT rows on the augmented transport system, their
GWE analogs, ``extract_apt_flows``, ``CoupledAugmented``; the APT files
of the deck loader; ``Simulation`` with APT rows) against the reference
(modflow6_tpu/models/gwt/apt.py).

Bars: the extended table and its slots, the pair edges and the order of
``_pairs`` equal; ``extract_apt_flows``, the assembled systems and
``feature_budget`` within 1e-12 relative (bitwise on this CPU); coupled
runs against the reference: equal flow and transport outer counts,
concentrations within 10 × outer_dvclose, at closures double precision
reaches (BiCGSTAB's inner counts follow the sum order, ROADMAP Queue C).
The scenarios of tests/test_apt.py hold the port to their own oracles; the
reference runs each scenario's first steps (its full runs take minutes).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_advanced_decks import write
from test_torch_gwt_decks import _edit
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwe.builder import build_gwe as jax_build_gwe
from modflow6_tpu.models.gwf import advanced as jadv
from modflow6_tpu.models.gwf import uzf as juzf
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.gwt import apt as japt
from modflow6_tpu.models.gwt.builder import build_gwt as jax_build_gwt
from modflow6_tpu.models.gwt.fmi import from_gwf_step as jax_from_gwf_step
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwe.builder import build_gwe
from modflow6_torch.models.gwf import uzf as tuzf
from modflow6_torch.models.gwf.advanced import (AugmentedGwfModel, build_lak,
                                                build_maw, build_sfr)
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.gwt.apt import (AugmentedGwtModel,
                                           CoupledAugmented,
                                           extract_apt_flows)
from modflow6_torch.models.gwt.builder import build_gwt
from modflow6_torch.models.gwt.fmi import from_gwf_step
from modflow6_torch.models.simulation import Simulation
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.ims import NumericalSolution
from modflow6_torch.timing.tdis import StressPeriod, Tdis
from modflow6_torch.utils.binary import read_head_file
from modflow6_torch.utils.mf6io import load_simulation

# closures double precision reaches; outer counts compared there
REACH = dict(outer_dvclose=1e-6, outer_maximum=50, inner_dvclose=1e-8,
             inner_rclose=1e-6, inner_maximum=500,
             linear_acceleration="bicgstab")
FLOW = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-10,
            inner_rclose=1e-9, inner_maximum=1000,
            linear_acceleration="bicgstab")
SLOTS = ("slot_cf", "slot_fc", "slot_pair", "pair_dst", "slot_mvr_cell",
         "mvr_cell_dst", "conn_cell", "conn_feat")
FLOWS = ("q_conn", "v_new", "v_old", "ext_q", "ext_conc", "out_q", "pair_q",
         "mvr_cell_q", "mvr_cell_node")


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(initial=0),
                                               1e-300))


def grids(**kw):
    return JaxDisGrid.create(**kw), DisGrid.create(**kw)


def row(n):
    """tests/test_apt.py:_grid: one row of n 100-m cells, 50 m thick."""
    return dict(nlay=1, nrow=1, ncol=n, delr=100.0, delc=100.0, top=50.0,
                botm=np.zeros((1, 1, n)))


# ------------------------------------- a model with every kind of edge

NET = dict(nlay=1, nrow=4, ncol=8, delr=100.0, delc=100.0, top=50.0,
           botm=np.zeros((1, 4, 8)))
NET_FLOW = dict(k=1.0, strt=30.0, storage={"ss": 1e-5, "iconvert": 0},
                chd=[(0, 30.0), (31, 30.0)], wel=[(9, -2.0), (20, -1.0)])
WELLS = [dict(radius=0.2, strt=30.0, rate=-3.0,
              connections=[(10, 5.0), (18, 4.0)]),
         dict(radius=0.2, strt=30.0, rate=1.0, connections=[(13, 3.0)])]
LAKES = [dict(strt=32.3, bottom=30.0, surf_area=1e3, rainfall=2.0, evap=0.5,
              withdrawal=0.1, connections=[(17, 1e-3, 30.0),
                                           (25, 1e-3, 30.0)]),
         dict(strt=31.5, bottom=29.0, surf_area=2e3,
              connections=[(27, 1e-3, 29.0)])]
OUTLETS = [dict(lake=0, to=1, type="manning", invert=32.0, width=2.0,
                rough=0.03, slope=1e-3),
           dict(lake=1, to=-1, type="specified", rate=0.5)]
REACHES = [dict(node=1 + r, cond=0.5, strtop=40.0 - 0.1 * r, width=3.0,
                rough=0.03, slope=1e-3, length=100.0,
                strt=40.4 - 0.1 * r, inflow=2.0 if r == 0 else 0.0,
                upstream=[(r - 1, 1.0)] if r > 0 else [],
                diversions=[dict(to=4, cprior="fraction", flow=0.3)]
                if r == 1 else [])
           for r in range(5)]
MOVERS = [dict(provider="wel", iprov=0, receiver="sfr", ircv=2,
               mvrtype="factor", value=0.5),
          dict(provider="sfr", iprov=4, receiver="lak", ircv=0,
               mvrtype="factor", value=1.0),
          dict(provider="lak", iprov=1, receiver="maw", ircv=1,
               mvrtype="upto", value=0.2)]
COLUMNS = [dict(node=n, vks=1.0, thtr=0.05, thts=0.35, thti=0.1, eps=3.5,
                celtop=50.0, celbot=40.0, area=1e4, finf=0.01)
           for n in (3, 5, 30)]
EXT = {"sfr": 1.0, "lak": 0.5, "maw": 0.25, "uzf": 0.75}


def net(base="gwt", uzt=False):
    """(reference, port) augmented flow and transport models of NET: two
    wells (one of two connections, one injecting), two lakes joined by an
    outlet, five reaches with a diversion, movers from a WEL entry, a
    reach and a lake outlet; with ``uzt`` three UZF columns."""
    jg, tg = grids(**NET)
    jm = jadv.AugmentedGwfModel(
        jax_build_gwf("f", jg, **NET_FLOW), maw=jadv.build_maw(WELLS, jg),
        lak=jadv.build_lak(LAKES, OUTLETS), sfr=jadv.build_sfr(REACHES),
        mvr=MOVERS)
    tm = AugmentedGwfModel(
        build_gwf("f", tg, device="cpu", **NET_FLOW),
        maw=build_maw(WELLS, tg), lak=build_lak(LAKES, OUTLETS),
        sfr=build_sfr(REACHES), mvr=MOVERS)
    if base == "gwt":
        kw = dict(porosity=0.3, strt=0.1, scheme="tvd", ssm_spec={"WEL": 0.0})
        jb, tb = (jax_build_gwt("t", jg, **kw),
                  build_gwt("t", tg, device="cpu", **kw))
    else:
        kw = dict(porosity=0.3, strt=10.0, scheme="tvd",
                  cnd=dict(alh=1.0, ath1=0.1, ktw=0.58, kts=2.5))
        jb, tb = (jax_build_gwe("e", jg, **kw),
                  build_gwe("e", tg, device="cpu", **kw))
    ju = tu = None
    if uzt:
        ju = juzf.make_uzf(COLUMNS, nz=10)
        tu = tuzf.make_uzf(COLUMNS, nz=10, device="cpu")
    return (jm, japt.AugmentedGwtModel(jb, jm, uzf=ju),
            tm, AugmentedGwtModel(tb, tm, uzf=tu))


@pytest.mark.parametrize("uzt", [False, True])
def test_ext_table_and_pairs_equal_the_reference(uzt):
    """The array-code build gives the reference loops' table, slots, pair
    edges and ``_pairs`` order (lake outlet, routing pairs, the
    diversion, the two feature movers; the WEL mover as a cell edge)."""
    _, ja, _, ta = net(uzt=uzt)
    assert ta.Ktot == ja.Ktot and ta.Kb == ja.Kb
    assert ta.n_extra == ja.n_extra == 9 + 3 * uzt
    np.testing.assert_array_equal(ta.dtopo.nbr.numpy(),
                                  np.asarray(ja.dtopo.nbr))
    for key in SLOTS:
        np.testing.assert_array_equal(getattr(ta, key).numpy(),
                                      np.asarray(getattr(ja, key)), key)
    assert ta._pairs == ja._pairs
    assert [k for k, _ in ta._pairs] == ["lak_out"] + ["sfr_route"] * 4 + [
        "sfr_div", "mvr", "mvr"]
    assert ta._mvr_cell == ja._mvr_cell == [0]


def _flows_both(ja, jm, ta, tm, x, x_old, delt, uzt):
    """(reference, port) AptFlows of one flow state; with UZT rows, one
    march of the columns from their initial water content."""
    N = tm.n_grid
    ib = torch.ones(N, dtype=torch.int32)
    ft = from_gwf_step(tm.base, x[:N], x_old[:N], ib, None, delt, False,
                       ssm_spec=ta.base.ssm_spec, gwt=ta.base)
    fj = jax_from_gwf_step(jm.base, jnp.asarray(x[:N].numpy()),
                           jnp.asarray(x_old[:N].numpy()), jnp.asarray(
                               ib.numpy()), None, delt, False,
                           ssm_spec=ja.base.ssm_spec)
    ukw_t, ukw_j = {}, {}
    if uzt:
        th0 = tuzf.initial_theta(ta.uzf)
        res = tuzf.advance(ta.uzf, th0, delt, head=x[:N],
                           watab_old=tuzf.watab_of(ta.uzf, x[:N]))
        ukw_t = dict(uzf_res=res, uzf_theta_old=th0)
        ukw_j = dict(uzf_res=juzf.UzfResult(**{
            k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
                else v) for k, v in vars(res).items()
            if k in juzf.UzfResult.__dataclass_fields__}),
            uzf_theta_old=jnp.asarray(th0.numpy()))
    flt = extract_apt_flows(ta, x, x_old, ft, delt, False, ext_conc=EXT,
                            **ukw_t)
    flj = japt.extract_apt_flows(ja, jnp.asarray(x.numpy()),
                                 jnp.asarray(x_old.numpy()), fj, delt, False,
                                 ext_conc=EXT, **ukw_j)
    return flj, flt


@pytest.mark.parametrize("base,uzt", [("gwt", False), ("gwt", True),
                                      ("gwe", False)])
def test_flows_system_and_budget_match_the_reference(base, uzt):
    """At a solved flow step: ``extract_apt_flows``, the augmented system
    at a random iterate (TVD; with GWE's eqnsclfac and CND) and
    ``feature_budget``, within 1e-12 relative."""
    jm, ja, tm, ta = net(base, uzt)
    delt = 100.0
    x, info, _ = NumericalSolution(tm, ImsSettings(**FLOW)).solve_timestep(
        tm.strt, delt, iss=False)
    assert info.converged
    flj, flt = _flows_both(ja, jm, ta, tm, x, tm.strt, delt, uzt)
    for key in FLOWS:
        close(getattr(flt, key), getattr(flj, key))
    rng = np.random.default_rng(3)
    c = (rng.random(ta.nodes) + 1.0) * (20.0 if base == "gwe" else 1.0)
    ibj, cj = ja.boundary_state(jnp.asarray(c))
    ibt, ct = ta.boundary_state(torch.tensor(c))
    for got, want in zip(
            ta.assemble(ct, torch.tensor(c) * 0.9, ibt, delt, False, flt),
            ja.assemble(cj, jnp.asarray(c) * 0.9, ibj, delt, False, flj)):
        close(got.reshape(np.asarray(want).shape), want)
    bt = ta.feature_budget(ct, torch.tensor(c) * 0.9, delt, flt)
    bj = ja.feature_budget(cj, jnp.asarray(c) * 0.9, delt, flj)
    assert bt.keys() == bj.keys()
    for key in bj:
        close(bt[key], bj[key])


def test_coupled_runs_match_the_reference():
    """NET with UZT rows through both packages' CoupledAugmented, three
    steps: equal outer counts, concentrations within 10 × outer_dvclose;
    the feature concentrations stay within the sources' range."""
    jm, ja, tm, ta = net("gwt", uzt=True)
    js = JaxImsSettings(**REACH)
    cj = japt.CoupledAugmented(jm, ja, gwf_settings=JaxImsSettings(**FLOW),
                               gwt_settings=js, ext_conc=EXT)
    ct = CoupledAugmented(tm, ta, gwf_settings=ImsSettings(**FLOW),
                          gwt_settings=ImsSettings(**REACH), ext_conc=EXT)
    xfj, xcj, xft, xct = jm.strt, ja.strt, tm.strt, ta.strt
    for k in range(3):
        xfj, xcj, fij, tij, _ = cj.step(xfj, xcj, 200.0, kstp=k + 1)
        xft, xct, fit, tit, _ = ct.step(xft, xct, 200.0, kstp=k + 1)
        assert fit.converged and tit.converged
        assert (fit.outer_iterations, tit.outer_iterations) == (
            fij.outer_iterations, tij.outer_iterations)
        np.testing.assert_allclose(xct.numpy(), np.asarray(xcj), rtol=0,
                                   atol=10 * REACH["outer_dvclose"])
    assert float(xct.min()) >= -1e-9 and float(xct.max()) <= 1.0 + 1e-9


# ----------------------------------------------- tests/test_apt.py twins

def couple(gwf, gwt, ext_conc, steps, delt, start=None):
    """The port's CoupledAugmented over ``steps`` steps (every step
    converged); returns (flow x, transport x, the last AptFlows).  The
    lake and mover scenarios take 25 steps ten times the reference test's
    (the same 5e5 time units, some 2,000 residence times of the lake)."""
    cpl = CoupledAugmented(gwf, gwt, ext_conc=ext_conc)
    xf, xc = gwf.strt, gwt.strt if start is None else start
    for k in range(steps):
        xf, xc, fi, ti, flows = cpl.step(xf, xc, delt=delt, kstp=k + 1)
        assert fi.converged and ti.converged
    return xf, xc, flows


def _stream(n=6):
    g = DisGrid.create(**row(n))
    base = build_gwf("f", g, k=1e-8, strt=30.0, chd=[(0, 30.0), (5, 30.0)],
                     device="cpu")
    reaches = [dict(node=1 + r, cond=0.0, strtop=40.0 - 0.1 * r, width=3.0,
                    rough=0.03, slope=1e-3, length=100.0,
                    strt=40.4 - 0.1 * r, inflow=2.0 if r == 0 else 0.0,
                    upstream=[(r - 1, 1.0)] if r > 0 else [])
               for r in range(3)]
    return g, AugmentedGwfModel(base, sfr=build_sfr(reaches))


def test_sft_stream_flushes_to_inflow_conc():
    """tests/test_apt.py:19: a stream fed at 1 flushes to 1; the inflow's
    mass leaves through the last reach."""
    g, gwf = _stream()
    gwt = AugmentedGwtModel(build_gwt("t", g, porosity=0.3, device="cpu"),
                            gwf)
    _, xc, flows = couple(gwf, gwt, {"sfr": 1.0}, 120, 500.0)
    np.testing.assert_allclose(xc[g.nodes:].numpy(), 1.0, rtol=1e-6)
    bud = gwt.feature_budget(xc, xc, 500.0, flows)
    np.testing.assert_allclose(float(bud["APT-IN"].sum()),
                               -float(bud["APT-OUT"][-1]), rtol=1e-6)


def _rain_lake(rain, evap, strt):
    g = DisGrid.create(**row(3))
    base = build_gwf("f", g, k=1e-8, strt=30.0, chd=[(0, 30.0)],
                     device="cpu")
    lak = build_lak([dict(strt=32.3, bottom=30.0, surf_area=1e3,
                          rainfall=rain, evap=evap,
                          connections=[(1, 1e-10, 30.0)])],
                    outlets=[dict(lake=0, to=-1, type="manning",
                                  invert=32.0, width=2.0, rough=0.03,
                                  slope=1e-3)])
    return g, AugmentedGwfModel(base, lak=lak)


def test_lkt_evapoconcentration():
    """tests/test_apt.py:49: evaporation takes water, not mass: the lake
    settles at c_rain · rain / (rain − evap)."""
    g, gwf = _rain_lake(10.0, 4.0, 0.0)
    gwt = AugmentedGwtModel(build_gwt("t", g, porosity=0.3, device="cpu"),
                            gwf)
    _, xc, _ = couple(gwf, gwt, {"lak": 0.5}, 25, 2e4)
    np.testing.assert_allclose(float(xc[g.nodes]), 0.5 * 10.0 / 6.0,
                               rtol=1e-4)


def test_mwt_pumped_well_reaches_aquifer_conc():
    """tests/test_apt.py:75: a pumping well takes the concentration of
    the water it draws."""
    g = DisGrid.create(**row(3))
    base = build_gwf("f", g, k=10.0, strt=40.0, device="cpu",
                     chd=[(0, 40.0), (1, 40.0), (2, 40.0)])
    gwf = AugmentedGwfModel(base, maw=build_maw(
        [dict(radius=0.2, strt=40.0, rate=-50.0, connections=[(1, 25.0)])],
        g))
    gwt = AugmentedGwtModel(build_gwt(
        "t", g, porosity=0.3, strt=0.8, cnc=[(0, 0.8), (1, 0.8), (2, 0.8)],
        device="cpu"), gwf)
    _, xc, _ = couple(gwf, gwt, {}, 80, 50.0)
    np.testing.assert_allclose(float(xc[g.nodes]), 0.8, rtol=1e-6)


def test_mvt_mover_carries_mass_stream_to_lake():
    """tests/test_apt.py:96: a mover from a reach into a lake carries the
    reach's concentration; the lake settles at it."""
    g = DisGrid.create(**row(8))
    # K 1.0 in the place of 1e-8: the lake's bed (1e-10) and the reach
    # (cond 0) keep the features apart from the aquifer as there, and
    # BiCGSTAB needs a hundredth of the iterations
    base = build_gwf("f", g, k=1.0, strt=30.0, chd=[(0, 30.0)],
                     device="cpu")
    gwf = AugmentedGwfModel(
        base, lak=build_lak([dict(strt=25.4, bottom=25.0, surf_area=1e3,
                                  connections=[(3, 1e-10, 25.0)])],
                            [dict(lake=0, to=-1, type="manning", invert=25.3,
                                  width=2.0, rough=0.03, slope=1e-3)]),
        sfr=build_sfr([dict(node=1, cond=0.0, strtop=40.0, width=3.0,
                            rough=0.03, slope=1e-3, length=100.0, strt=40.3,
                            inflow=2.0)]),
        mvr=[dict(provider="sfr", iprov=0, receiver="lak", ircv=0,
                  mvrtype="factor", value=1.0)])
    gwt = AugmentedGwtModel(build_gwt("t", g, porosity=0.3, device="cpu"),
                            gwf)
    _, xc, _ = couple(gwf, gwt, {"sfr": 2.5}, 25, 2e4)
    c_lak, c_sfr = xc[g.nodes:].tolist()
    np.testing.assert_allclose(c_sfr, 2.5, rtol=1e-6)
    np.testing.assert_allclose(c_lak, 2.5, rtol=1e-4)


def test_gwe_feature_energy_scaling():
    """tests/test_apt.py:126: eqnsclfac = ρw·cw scales the feature
    equations; the reach reaches its inflow's temperature."""
    g, gwf = _stream()
    gwf = AugmentedGwfModel(gwf.base, sfr=build_sfr([dict(
        node=1, cond=0.0, strtop=40.0, width=3.0, rough=0.03, slope=1e-3,
        length=100.0, strt=40.3, inflow=2.0)]))
    gwt = AugmentedGwtModel(build_gwt("t", g, porosity=0.3, strt=5.0,
                                      eqnsclfac=4.184e6, device="cpu"), gwf)
    _, xc, _ = couple(gwf, gwt, {"sfr": 18.0}, 100, 500.0,
                      start=gwt.strt + 5.0)
    np.testing.assert_allclose(float(xc[g.nodes]), 18.0, rtol=1e-6)


def _column(base_gwe):
    """tests/test_apt.py:146's column, with nz 10 in the place of 40 (a
    quarter of the march's sub-steps); the runs below step a tenth of the
    reference test's 6,000 time units, which the column's flush (a
    residence time near 9) still takes to its steady state."""
    g = DisGrid.create(**row(3))
    base = build_gwf("f", g, k=10.0, strt=30.0, device="cpu",
                     chd=[(0, 30.0), (1, 30.0), (2, 30.0)],
                     storage={"ss": 1e-5, "sy": 0.2, "iconvert": 1})
    uzf = tuzf.make_uzf(
        [dict(node=1, vks=1.0, thtr=0.05, thts=0.35, thti=0.05, eps=3.5,
              celtop=45.0, celbot=40.0, area=100.0, finf=0.2)], nz=10,
        device="cpu")
    gwf = AugmentedGwfModel(base)
    tb = (build_gwe("e", g, porosity=0.3, strt=5.0, device="cpu")
          if base_gwe else build_gwt("t", g, porosity=0.3, device="cpu"))
    return g, gwf, AugmentedGwtModel(tb, gwf, uzf=uzf)


def test_uzt_column_delivers_mass_to_aquifer():
    """tests/test_apt.py:146: infiltration at 1 flushes the column to 1;
    at steady state the inflow's mass reaches the aquifer."""
    g, gwf, gwt = _column(False)
    assert gwt.n_extra == 1
    _, xc, flows = couple(gwf, gwt, {"uzf": 1.0}, 30, 20.0)
    np.testing.assert_allclose(float(xc[g.nodes]), 1.0, rtol=1e-4)
    bud = gwt.feature_budget(xc, xc, 20.0, flows)
    m_in, m_gwf = float(bud["APT-IN"][0]), float(bud["APT-GWF"][0])
    assert m_in > 0
    np.testing.assert_allclose(m_in, -m_gwf, rtol=1e-3)


def test_uze_column_temperature():
    """tests/test_apt.py:179: the same rows on a GWE base carry energy."""
    g, gwf, gwe = _column(True)
    _, xt, _ = couple(gwf, gwe, {"uzf": 25.0}, 30, 20.0,
                      start=torch.full((gwe.nodes,), 5.0,
                                       dtype=torch.float64))
    np.testing.assert_allclose(float(xt[g.nodes]), 25.0, rtol=1e-4)


def test_lke_rain_fed_lake_temperature():
    """tests/test_apt.py:205: a rain-fed lake settles at the rain's
    temperature on a GWE base."""
    g, gwf = _rain_lake(10.0, 0.0, 0.0)
    gwe = AugmentedGwtModel(build_gwe("e", g, porosity=0.3, strt=4.0,
                                      device="cpu"), gwf)
    _, xt, _ = couple(gwf, gwe, {"lak": 18.0}, 25, 2e4,
                      start=torch.full((gwe.nodes,), 4.0,
                                       dtype=torch.float64))
    np.testing.assert_allclose(float(xt[g.nodes]), 18.0, rtol=1e-4)


# ----------------------------------------------------------- Simulation

def test_apt_through_simulation_matches_coupled_augmented():
    """``Simulation`` with APT rows takes the steps of CoupledAugmented:
    the same concentrations, bitwise, and the grid rows in its file."""
    g, gwf = _stream()
    kw = dict(porosity=0.3, device="cpu")
    sim = Simulation(Tdis((StressPeriod(1500.0, 3, 1.0),)), gwf,
                     ImsSettings(**FLOW),
                     gwt=AugmentedGwtModel(build_gwt("t", g, **kw), gwf))
    sim.apt_ext_conc = {"sfr": 1.0}
    recs = sim.run()
    assert all(r.converged and r.transport_converged for r in recs)
    gwt = AugmentedGwtModel(build_gwt("t", g, **kw), gwf)
    cpl = CoupledAugmented(gwf, gwt, gwf_settings=ImsSettings(**FLOW),
                           ext_conc={"sfr": 1.0})
    xf, xc = gwf.strt, gwt.strt
    for k, conc in enumerate(sim.conc_records):
        xf, xc, _, _, _ = cpl.step(xf, xc, 500.0, kstp=k + 1)
        np.testing.assert_array_equal(conc, xc.numpy())


@pytest.mark.parametrize("case", ["mxiter with buy and apt rows",
                                  "uzt rows without uzf columns"])
def test_simulation_refuses_what_apt_rows_do_not_run(case):
    """MXITER > 1 with BUY and APT rows (the reference's solution group
    runs such a model once a step) and UZT rows without the flow's UZF
    columns raise (tests/test_torch_gwt.py holds the refusals of a plain
    GWT model beside feature rows or UZF columns)."""
    g, gwf = _stream()
    tdis = Tdis((StressPeriod(1.0, 1, 1.0),))
    if case == "mxiter with buy and apt rows":
        base = build_gwf("f", g, k=1e-8, strt=30.0, device="cpu",
                         chd=[(0, 30.0)], buy=dict(denseref=1000.0,
                                                   drhodc=0.7))
        gwf = AugmentedGwfModel(base, sfr=build_sfr([dict(
            node=1, cond=0.0, strtop=40.0, width=3.0, strt=40.3,
            inflow=1.0)]))
        sim = Simulation(tdis, gwf, ImsSettings(**FLOW),
                         gwt=AugmentedGwtModel(build_gwt("t", g,
                                                         device="cpu"), gwf))
        sim.sgp_mxiter = 3
        with pytest.raises(NotImplementedError, match="MXITER"):
            sim.run()
        return
    _, _, gwt = _column(False)
    sim = Simulation(tdis, gwt.gwf, ImsSettings(**FLOW), gwt=gwt)
    with pytest.raises(ValueError, match="UZF columns"):
        sim.run()


def test_ist_with_apt_rows_is_refused():
    g, gwf = _stream()
    with pytest.raises(NotImplementedError, match="IST with APT"):
        AugmentedGwtModel(build_gwt("t", g, device="cpu", ist=dict(
            thetaim=0.1, zetaim=0.05)), gwf)


# ---------------------------------------------------------------- decks

def sft_deck(ws):
    """tests/test_apt_decks.py:12's deck (a three-reach stream fed at 1)."""
    import test_apt_decks as decks

    class Written(Exception):
        pass

    def stop(*args, **kwargs):
        raise Written()

    real, decks.load_simulation = decks.load_simulation, stop
    try:
        with pytest.raises(Written):
            decks.test_sft_deck_stream_flushes_to_inflow_conc(ws)
    finally:
        decks.load_simulation = real


def test_sft_deck_stream_flushes_to_inflow_conc(tmp_path):
    """tests/test_apt_decks.py:12 through the port's loader: an
    AugmentedGwtModel whose stream flushes to 1, with the reference
    loader's starting concentrations and sources (the runs of both
    loaders are compared on ``apt_deck``)."""
    sft_deck(tmp_path)
    sim = load_simulation(str(tmp_path), device="cpu")
    ref = ref_load(str(tmp_path))
    assert isinstance(sim.gwt, AugmentedGwtModel)
    np.testing.assert_array_equal(sim.gwt.strt.numpy(),
                                  np.asarray(ref.gwt.strt))
    assert sim.apt_ext_conc.keys() == ref.apt_ext_conc.keys() == {"sfr"}
    np.testing.assert_array_equal(sim.apt_ext_conc["sfr"].numpy(),
                                  np.asarray(ref.apt_ext_conc["sfr"]))
    recs = sim.run()
    assert all(r.converged and r.transport_converged for r in recs)
    np.testing.assert_allclose(sim.conc.numpy()[6:], 1.0, rtol=1e-4)


FLOW_FILES = {
    "model.wel": "BEGIN OPTIONS\n  MOVER\nEND OPTIONS\nBEGIN DIMENSIONS\n"
    "  MAXBOUND 1\nEND DIMENSIONS\nBEGIN PERIOD 1\n  1 1 6 -2.0\n"
    "END PERIOD\n",
    "model.sfr": """BEGIN OPTIONS
  MOVER
END OPTIONS
BEGIN DIMENSIONS
  NREACHES 3
END DIMENSIONS
BEGIN PACKAGEDATA
  1 1 1 3 100.0 3.0 1.0e-3 40.0 1.0 0.0 0.03 1 1.0 0
  2 1 1 4 100.0 3.0 1.0e-3 39.9 1.0 0.0 0.03 2 1.0 0
  3 1 1 5 100.0 3.0 1.0e-3 39.8 1.0 0.0 0.03 1 1.0 0
END PACKAGEDATA
BEGIN CONNECTIONDATA
  1 -2
  2 1 -3
  3 2
END CONNECTIONDATA
BEGIN PERIOD 1
  1 INFLOW 1.0
END PERIOD
""",
    "model.lak": """BEGIN OPTIONS
  MOVER
END OPTIONS
BEGIN DIMENSIONS
  NLAKES 1
  NOUTLETS 1
END DIMENSIONS
BEGIN PACKAGEDATA
  1 32.5 1
END PACKAGEDATA
BEGIN CONNECTIONDATA
  1 1 1 1 2 VERTICAL 0.0000001 30.0 50.0 100.0 100.0
END CONNECTIONDATA
BEGIN OUTLETS
  1 1 0 WEIR 32.0 2.0 0.03 0.001
END OUTLETS
BEGIN PERIOD 1
  1 RAINFALL 0.0005
END PERIOD
""",
    "model.maw": """BEGIN DIMENSIONS
  NMAWWELLS 1
END DIMENSIONS
BEGIN PACKAGEDATA
  1 0.25 0.0 30.0 SPECIFIED 1
END PACKAGEDATA
BEGIN CONNECTIONDATA
  1 1 1 1 7 50.0 0.0 25.0 0.25
END CONNECTIONDATA
BEGIN PERIOD 1
  1 RATE -2.0
END PERIOD
""",
    "model.uzf": """BEGIN DIMENSIONS
  NUZFCELLS 2
END DIMENSIONS
BEGIN PACKAGEDATA
  1 1 1 4 1 0 0.5 0.3 0.05 0.35 0.1 3.5
  2 1 1 6 1 0 0.5 0.3 0.05 0.35 0.1 3.5
END PACKAGEDATA
BEGIN PERIOD 1
  1 2.0e-3 0.0 1.0 0.05
  2 3.0e-3 0.0 1.0 0.05
END PERIOD
""",
    "model.mvr": """BEGIN DIMENSIONS
  MAXMVR 2
  MAXPACKAGES 3
END DIMENSIONS
BEGIN PACKAGES
  WEL-1
  SFR-1
  LAK-1
END PACKAGES
BEGIN PERIOD 1
  WEL-1 1 SFR-1 1 UPTO 0.5
  LAK-1 1 SFR-1 2 FACTOR 1.0
END PERIOD
""",
}
# the APT files of each transport model type: (name-file line, text)
APT_FILES = {
    "GWT6": [("SFT6 t.sft sft-1", "BEGIN OPTIONS\n  FLOW_PACKAGE_NAME sfr-1\n"
              "END OPTIONS\nBEGIN PACKAGEDATA\n  1 0.0\n  2 0.0\n  3 0.0\n"
              "END PACKAGEDATA\nBEGIN PERIOD 1\n  1 INFLOW 1.0\n"
              "END PERIOD\n"),
             ("LKT6 t.lkt", "BEGIN PACKAGEDATA\n  1 0.2\nEND PACKAGEDATA\n"
              "BEGIN PERIOD 1\n  1 RAINFALL 0.5\n  1 STATUS ACTIVE\n"
              "END PERIOD\n"),
             ("MWT6 t.mwt", "BEGIN PACKAGEDATA\n  1 0.0\nEND PACKAGEDATA\n"),
             ("UZT6 t.uzt", "BEGIN PACKAGEDATA\n  1 0.0\n  2 0.1\n"
              "END PACKAGEDATA\n"),
             ("MVT6 t.mvt", "BEGIN OPTIONS\nEND OPTIONS\n")],
    "GWE6": [("SFE6 t.sfe sfe-1", "BEGIN PACKAGEDATA\n  1 10.0 0.0 1.0\n"
              "  2 10.0 0.0 1.0\n  3 10.0 0.0 1.0\nEND PACKAGEDATA\n"
              "BEGIN PERIOD 1\n  1 INFLOW 18.0\nEND PERIOD\n"),
             ("LKE6 t.lke", "BEGIN PACKAGEDATA\n  1 12.0 0.0 1.0\n"
              "END PACKAGEDATA\nBEGIN PERIOD 1\n  1 RAINFALL 15.0\n"
              "END PERIOD\n"),
             ("MWE6 t.mwe", "BEGIN PACKAGEDATA\n  1 10.0 0.0 1.0\n"
              "END PACKAGEDATA\n"),
             ("UZE6 t.uze", "BEGIN PACKAGEDATA\n  1 10.0\n  2 10.0\n"
              "END PACKAGEDATA\n"),
             ("MVE6 t.mve", "BEGIN OPTIONS\nEND OPTIONS\n")]}
# the rest of each transport model: (name-file lines, files)
TRANSPORT_FILES = {
    "GWT6": ("  ADV6 t.adv\n  MST6 t.mst\n", {
        "t.adv": "BEGIN OPTIONS\n  SCHEME UPSTREAM\nEND OPTIONS\n",
        "t.mst": "BEGIN GRIDDATA\n  POROSITY\n    CONSTANT 0.3\n"
        "END GRIDDATA\n",
        "t.ic": "BEGIN GRIDDATA\n  STRT\n    CONSTANT 0.0\nEND GRIDDATA\n",
        "t.oc": "BEGIN OPTIONS\n  CONCENTRATION FILEOUT t.ucn\nEND OPTIONS\n"}),
    "GWE6": ("  ADV6 t.adv\n  EST6 t.est\n  CND6 t.cnd\n", {
        "t.adv": "BEGIN OPTIONS\n  SCHEME UPSTREAM\nEND OPTIONS\n",
        "t.est": "BEGIN GRIDDATA\n  POROSITY\n    CONSTANT 0.3\n"
        "  DENSITY_SOLID\n    CONSTANT 2650.0\n  HEAT_CAPACITY_SOLID\n"
        "    CONSTANT 800.0\nEND GRIDDATA\n",
        "t.cnd": "BEGIN OPTIONS\n  XT3D_OFF\nEND OPTIONS\nBEGIN GRIDDATA\n"
        "  ALH\n    CONSTANT 1.0\n  KTW\n    CONSTANT 0.58\n  KTS\n"
        "    CONSTANT 2.5\nEND GRIDDATA\n",
        "t.ic": "BEGIN GRIDDATA\n  STRT\n    CONSTANT 10.0\nEND GRIDDATA\n",
        "t.oc": "BEGIN OPTIONS\n  TEMPERATURE FILEOUT t.ucn\nEND OPTIONS\n"}),
}


def apt_deck(ws, model="GWT6", nstp=3):
    """tests/test_advanced_decks.py's eight-cell transient flow (CHD at
    both ends) with a WEL entry and a lake outlet moving water into a
    three-reach stream (MVR6), a pumping well and two UZF columns; beside
    it a GWT6 model (or GWE6, ``model``) with an APT file of every type
    and an OC6 that writes t.ucn."""
    from test_advanced_decks import _sim_files
    ws = str(ws)
    _sim_files(ws, "  WEL6 model.wel\n  SFR6 model.sfr sfr-1\n"
               "  LAK6 model.lak lak-1\n  MAW6 model.maw maw-1\n"
               "  UZF6 model.uzf uzf-1\n  MVR6 model.mvr",
               perlen=f"{100.0 * nstp} {nstp} 1.0")
    for name, text in FLOW_FILES.items():
        write(ws, name, text)
    _edit("mfsim.nam", lambda t: t.replace(
        "  GWF6 model.nam m1", f"  GWF6 model.nam m1\n  {model} t.nam t1")
        .replace("BEGIN EXCHANGES", f"BEGIN EXCHANGES\n  GWF6-{model} x.exg "
                 "m1 t1").replace("IMS6 sim.ims m1", "IMS6 sim.ims m1 t1"))(ws)
    lines, files = TRANSPORT_FILES[model]
    apt = "".join(f"  {line}\n" for line, _ in APT_FILES[model])
    write(ws, "t.nam", "BEGIN PACKAGES\n  DIS6 model.dis\n  IC6 t.ic\n"
          + lines + apt + "  OC6 t.oc\nEND PACKAGES\n")
    for name, text in files.items():
        write(ws, name, text)
    for line, text in APT_FILES[model]:
        write(ws, line.split()[1], text)


def test_apt_deck_of_every_package_type_matches_the_reference(tmp_path):
    """LKT6, SFT6, MWT6, UZT6 and MVT6 beside MAW6, LAK6, SFR6, UZF6 and
    MVR6: both loaders give the same rows, starting concentrations and
    sources; the runs have equal outer counts and concentrations within
    10 × outer_dvclose, and the .ucn file holds the grid rows."""
    apt_deck(tmp_path)
    port, ref = (load_simulation(str(tmp_path), device="cpu"),
                 ref_load(str(tmp_path)))
    assert port.gwt.n_extra == ref.gwt.n_extra == 1 + 1 + 3 + 2
    np.testing.assert_array_equal(port.gwt.strt.numpy(),
                                  np.asarray(ref.gwt.strt))
    for key in SLOTS:
        np.testing.assert_array_equal(getattr(port.gwt, key).numpy(),
                                      np.asarray(getattr(ref.gwt, key)), key)
    assert port.gwt._pairs == ref.gwt._pairs
    assert sorted(port.apt_ext_conc) == sorted(ref.apt_ext_conc) == [
        "lak", "maw", "sfr", "uzf"]
    for key, value in ref.apt_ext_conc.items():
        np.testing.assert_array_equal(port.apt_ext_conc[key].numpy(),
                                      np.asarray(value))
    got = port.run()
    ucn = read_head_file(os.path.join(str(tmp_path), "t.ucn"))
    assert len(ucn) == 3 and ucn[-1]["text"] == "CONCENTRATION"
    np.testing.assert_array_equal(ucn[-1]["data"].reshape(-1),
                                  port.conc_records[-1][:8])
    want = ref.run()
    assert all(r.converged and r.transport_converged for r in got)
    assert [r.outer for r in got] == [r.outer for r in want]
    for a, b in zip(port.conc_records, ref.conc_records):
        np.testing.assert_allclose(a, b, rtol=0, atol=10 * 1e-8)


def _lkt(text):
    """An edit of apt_deck's LKT6 file."""
    return lambda ws: _edit("t.lkt", text)(ws)


# key → (edit of apt_deck, the port's error and what it names, what the
# reference does)
APT_REFUSALS = {
    "R14 two source values": (_lkt(lambda t: t.replace(
        "  1 STATUS ACTIVE", "  1 RUNOFF 0.7")), NotImplementedError,
        "RAINFALL 0.5 and RUNOFF 0.7", "loads"),
    "R15 STATUS CONSTANT": (_lkt(lambda t: t.replace(
        "STATUS ACTIVE", "STATUS CONSTANT")), NotImplementedError,
        "STATUS CONSTANT", "loads"),
    "R15 CONCENTRATION": (_lkt(lambda t: t.replace(
        "  1 STATUS ACTIVE", "  1 CONCENTRATION 0.3")), NotImplementedError,
        "setting CONCENTRATION", "loads"),
    "TS6": (_lkt(lambda t: "BEGIN OPTIONS\n  TS6 FILEIN t.ts\nEND OPTIONS\n"
                 + t), NotImplementedError, "LKT6.*TS6", "loads"),
    "PACKAGEDATA short of a lake": (_lkt(lambda t: t.replace("  1 0.2\n",
                                                             "")),
                                    ValueError, "LKT6", "raises"),
    "UZT6 without UZF6": (lambda ws: _edit("model.nam", lambda t: t.replace(
        "  UZF6 model.uzf uzf-1\n", ""))(ws), ValueError, "UZT6", "raises"),
    "later PERIOD blocks": (lambda ws: _edit("model.maw", lambda t: t + (
        "BEGIN PERIOD 2\n  1 RATE -0.2\nEND PERIOD\n"))(ws),
        NotImplementedError, "later PERIOD blocks", "loads"),
}


@pytest.mark.parametrize("key", sorted(APT_REFUSALS))
def test_apt_refusals(tmp_path, key):
    """Where the reference reads past or runs another way, the port raises
    by name (R14: two different source values of one feature, the last
    winning there; R15: a STATUS other than ACTIVE, read past there, and a
    CONCENTRATION setting, run there as a source concentration; TS6 in an
    APT file; later PERIOD blocks of the flow's features beside APT, whose
    transport keeps the first period's features there); where the
    reference refuses, so does the port (PACKAGEDATA short of a lake, UZT6
    without UZF6)."""
    apt_deck(tmp_path)
    if key == "later PERIOD blocks":
        _edit("sim.tdis", lambda t: t.replace("NPER 1", "NPER 2").replace(
            "300.0 3 1.0", "300.0 3 1.0\n  100.0 1 1.0"))(tmp_path)
    edit, error, names, ref_does = APT_REFUSALS[key]
    edit(tmp_path)
    with pytest.raises(error, match=names):
        load_simulation(str(tmp_path), device="cpu")
    if ref_does == "loads":
        ref_load(str(tmp_path))
    else:
        with pytest.raises(Exception):
            ref_load(str(tmp_path))
