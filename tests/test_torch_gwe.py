"""GWE heat transport in the port (modflow6_torch/models/gwe: EST, CND, the
GweModel with ADV, CTP, ESL and SSM, build_gwe, CoupledGwfGwe,
merge_gwe_models; the GWE6 deck loader with LKE6/SFE6/MWE6/UZE6) against
the reference (modflow6_tpu/models/gwe).

Bars: assembled systems within 1e-12 relative (eqnsclfac = ρw·cpw puts
their entries six orders of magnitude above GWT's, so the bar is
relative); CND's conductances within 1e-12 relative (its trigonometry
differs from XLA's in the last bit, as DSP's does); runs against the
reference: equal outer counts, temperatures within 10 × outer_dvclose.
The scenarios of tests/test_gwe.py and tests/test_gwe_prt_decks.py:118
hold the port to their own oracles.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_apt import apt_deck, close
from test_torch_gwt_decks import _edit
from test_advanced_decks import write
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwe import cnd as jcnd
from modflow6_tpu.models.gwe.builder import CoupledGwfGwe as JaxCoupled
from modflow6_tpu.models.gwe.builder import build_gwe as jax_build_gwe
from modflow6_tpu.models.gwe.exchange import merge_gwe_models as jax_merge_gwe
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.gwf.exchange import ExchangePair as JaxPair
from modflow6_tpu.models.gwf.exchange import GwfGwfExchange as JaxExchange
from modflow6_tpu.models.gwf.exchange import merge_gwf_models as jax_merge
from modflow6_tpu.models.gwt.fmi import from_gwf_step as jax_from_gwf_step
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxSolution
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.convert import gwe_from_reference
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwe import cnd, est
from modflow6_torch.models.gwe.builder import CoupledGwfGwe, build_gwe
from modflow6_torch.models.gwe.exchange import merge_gwe_models
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.gwf.exchange import (ExchangePair, GwfGwfExchange,
                                                merge_gwf_models)
from modflow6_torch.models.gwt.fmi import from_gwf_step
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.ims import NumericalSolution
from modflow6_torch.utils.binary import read_head_file
from modflow6_torch.utils.mf6io import load_simulation

# tests/test_gwe.py:tight()
TIGHT = dict(outer_dvclose=1e-10, outer_maximum=50, inner_dvclose=1e-12,
             inner_rclose=1e-10, inner_maximum=3000,
             linear_acceleration="bicgstab")
FLOW = dict(outer_dvclose=1e-9, outer_maximum=50, inner_dvclose=1e-11,
            inner_rclose=1e-10, inner_maximum=500)
# tests/test_gwe.py's properties
THETA, RHOW, CPW, RHOS, CPS = 0.25, 1000.0, 4000.0, 2600.0, 900.0
# tight() with its residual closure scaled by ρw·cw, the factor of every
# entry of an energy system: at 1e-10 the residual of the port's BiCGSTAB
# cannot close, and each outer runs to inner_maximum (the same
# temperatures at a fiftieth of the time)
GWE_TIGHT = dict(TIGHT, inner_rclose=TIGHT["inner_rclose"] * RHOW * CPW)
BULK_CAP = THETA * RHOW * CPW + (1 - THETA) * RHOS * CPS
PROPS = dict(porosity=THETA, rhow=RHOW, cpw=CPW, rhos=RHOS, cps=CPS)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# ---------------------------------------------------- systems and CND

GRID = dict(nlay=2, nrow=3, ncol=10, delr=10.0, delc=10.0, top=10.0,
            botm=np.stack([np.full((3, 10), 5.0), np.zeros((3, 10))]))
FLOW_KW = dict(k=5.0, strt=5.0, storage={"ss": 1e-4, "iconvert": 0},
               chd=[(9, 5.0)], rch=[(j, 1e-3) for j in range(30)],
               wel=[(35, -0.5)])
HEAT = dict(PROPS, strt=10.0, cnd=dict(alh=10.0, ath1=1.0, atv=0.1,
                                       ktw=0.58, kts=2.5),
            ctp=[(3, 80.0), (3, 70.0)], esl=[(12, 5.0), (12, 2.0)],
            ssm_spec={"RCH": 25.0}, decay=(est.DECAY_BOTH, 1.0, 2.0))


@pytest.fixture(scope="module")
def heat():
    """One transient flow step of GRID solved by the port, and FMI's
    fields of it in both packages."""
    jg, tg = JaxDisGrid.create(**GRID), DisGrid.create(**GRID)
    jf = jax_build_gwf("f", jg, **FLOW_KW)
    tf = build_gwf("f", tg, device="cpu", **FLOW_KW)
    h, info, aux = NumericalSolution(tf, ImsSettings(**FLOW)).solve_timestep(
        tf.strt, 1.0, iss=False)
    assert info.converged
    fj = jax_from_gwf_step(jf, jnp.asarray(h.numpy()),
                           jnp.asarray(tf.strt.numpy()),
                           jnp.asarray(aux["ibound"].numpy()), None, 1.0,
                           False, ssm_spec=HEAT["ssm_spec"])
    return jg, tg, fj, (h, tf.strt, aux["ibound"], tf)


def both_gwe(heat, **kw):
    jg, tg, _, (h, h0, ib, tf) = heat
    jm = jax_build_gwe("e", jg, **kw)
    tm = build_gwe("e", tg, device="cpu", **kw)
    ft = from_gwf_step(tf, h, h0, ib, None, 1.0, False,
                       ssm_spec=kw.get("ssm_spec"), gwt=tm)
    return jm, tm, ft


@pytest.mark.parametrize("scheme", ["upstream", "central", "tvd"])
def test_gwe_system_matches_reference(heat, scheme):
    """The system at a random temperature iterate: ADV, CND with
    dispersion, EST storage and both decays, SSM, two CTP entries on one
    cell (the last wins) and two ESL entries on one cell (summed in entry
    order)."""
    jm, tm, ft = both_gwe(heat, scheme=scheme, **HEAT)
    fj = heat[2]
    temp = 10.0 + 20.0 * np.random.default_rng(4).random(tm.nodes)
    ibj, cj = jm.boundary_state(jnp.asarray(temp))
    ibt, ct = tm.boundary_state(t64(temp))
    np.testing.assert_array_equal(ibt.numpy(), np.asarray(ibj))
    assert float(ct[3]) == float(cj[3]) == 70.0
    for got, want in zip(tm.assemble(ct, t64(temp) * 0.9, ibt, 2.0, False,
                                     ft),
                         jm.assemble(cj, jnp.asarray(temp) * 0.9, ibj, 2.0,
                                     False, fj)):
        close(got.reshape(np.asarray(want).shape), want)
    assert tm.is_linear == (scheme != "tvd")


def test_cnd_conductances_match_reference(heat):
    jm, tm, ft = both_gwe(heat, **HEAT)
    ib = torch.ones(tm.nodes, dtype=torch.int32)
    got = cnd.edge_conductance(tm.dtopo, tm.cnd, tm.est_arrays.porosity,
                               tm.eqnsclfac, ft, ib, tm.top, tm.bot)
    want = jcnd.edge_conductance(jm.dtopo, jm.cnd, jm.est_arrays.porosity,
                                 jm.eqnsclfac, heat[2],
                                 jnp.asarray(ib.numpy()), jm.top, jm.bot)
    assert float(got.abs().max()) > 0
    close(got, want)


def gwe_reference_arrays(model):
    """(arrays, options) of gwe_from_reference for a reference GweModel."""
    arrays = {k: np.asarray(getattr(model.dtopo, k)) for k in (
        "edge_n", "edge_m", "ihc", "cl1", "cl2", "hwva", "anglex", "nbr",
        "slot_nm", "slot_mn")}
    arrays.update(strt=model.strt, ibound0=model.ibound0, top=model.top,
                  bot=model.bot, area=model.area)
    for k in ("porosity", "cps", "rhos", "decay_water", "decay_solid"):
        arrays["est_" + k] = getattr(model.est_arrays, k)
    o = model.est_opts
    options = dict(iadvwt=model.iadvwt, ssm_spec=model.ssm_spec, cnd=None,
                   est=dict(idcy=o.idcy, idcysrc=o.idcysrc, rhow=o.rhow,
                            cpw=o.cpw, latheatvap=o.latheatvap))
    if model.cnd is not None:
        for k in ("alh", "alv", "ath1", "ath2", "atv", "ktw", "kts"):
            arrays["cnd_" + k] = getattr(model.cnd, k)
        options["cnd"] = dict(idisp=model.cnd.idisp, iktw=model.cnd.iktw,
                              ikts=model.cnd.ikts)
    for pkg, value in (("ctp", "conc"), ("esl", "q")):
        data = getattr(model, pkg)
        if data is not None:
            for f in ("node", value, "mask"):
                arrays[f"{pkg}_{f}"] = getattr(data, f)
    return {k: np.asarray(v) for k, v in arrays.items()}, options


def test_gwe_from_reference_equals_the_port_built_model(heat):
    """A reference GweModel's arrays → gwe_from_reference: the port's
    build_gwe's system, bit for bit."""
    jm, tm, ft = both_gwe(heat, scheme="tvd", **HEAT)
    arrays, options = gwe_reference_arrays(jm)
    conv = gwe_from_reference(arrays, options=options, device="cpu",
                              grid=DisGrid.create(**GRID))
    temp = t64(10.0 + np.arange(tm.nodes) % 7)
    systems = []
    for model in (tm, conv):
        ib, tb = model.boundary_state(temp)
        systems.append((ib, *model.assemble(tb, temp, ib, 3.0, False, ft)))
    for g, w in zip(*systems):
        assert torch.equal(g, w)


# ------------------------------------------- tests/test_gwe.py twins

def fields_of(g, gwf, delt=1.0):
    """A steady flow step's FlowFields (tests/test_gwe.py:flow_fields)."""
    head, info, aux = NumericalSolution(gwf, ImsSettings(
        **dict(TIGHT, linear_acceleration="cg"))).solve_timestep(
        gwf.strt, delt, iss=True)
    assert info.converged
    return from_gwf_step(gwf, head, head, aux["ibound"], aux["cond"], delt,
                         True, ssm_spec={})


def run_energy(g, fields, strt, delt, nsteps, settings=GWE_TIGHT, **kw):
    gwe = build_gwe("e", g, strt=strt, device="cpu", **kw)
    sol = NumericalSolution(gwe, ImsSettings(**settings))
    temp, outers = gwe.strt, []
    for _ in range(nsteps):
        temp, info, _ = sol.solve_timestep(temp, delt, iss=False,
                                           pkgs=fields)
        assert info.converged
        outers.append(info.outer_iterations)
    return temp.numpy(), outers


def moments(c, x):
    m0 = c.sum()
    mu = (c * x).sum() / m0
    return m0, mu, (c * (x - mu) ** 2).sum() / m0


def test_gwe_conduction_variance():
    """tests/test_gwe.py:235: still water, a pulse spreads with the
    thermal diffusivity ktbulk / bulk heat capacity."""
    ncol = 101
    g = DisGrid.create(1, 1, ncol, 1.0, 1.0, 1.0, np.zeros((1, 1, ncol)))
    fields = fields_of(g, build_gwf("f", g, k=1.0, strt=0.5, device="cpu"))
    ktw, kts = 0.6, 3.0
    alpha = (THETA * ktw + (1 - THETA) * kts) / BULK_CAP
    strt = np.zeros(ncol)
    strt[ncol // 2] = 1.0
    t, _ = run_energy(g, fields, strt, 5e4, 10, scheme="central",
                      cnd={"ktw": ktw, "kts": kts}, **PROPS)
    _, mu, var = moments(t, np.arange(ncol, dtype=float))
    np.testing.assert_allclose(mu, ncol // 2, atol=1e-6)
    np.testing.assert_allclose(var, 2 * alpha * 5e4 * 10, rtol=1e-4)


def test_gwe_thermal_retardation():
    """tests/test_gwe.py:259: the front moves at v / R with
    R = bulk heat capacity / θ·ρw·cw."""
    ncol, q, k = 201, 0.5, 10.0
    g = DisGrid.create(1, 1, ncol, 1.0, 1.0, 1.0, np.zeros((1, 1, ncol)))
    dh = q * (ncol - 1) / k
    fields = fields_of(g, build_gwf("f", g, k=k, strt=10.0, device="cpu",
                                    chd=[(0, 10.0 + dh), (ncol - 1, 10.0)]))
    strt = np.zeros(ncol)
    strt[30] = 1.0
    t, _ = run_energy(g, fields, strt, 2.0, 30, scheme="central", **PROPS)
    _, mu, _ = moments(t, np.arange(ncol, dtype=float))
    retard = BULK_CAP / (THETA * RHOW * CPW)
    np.testing.assert_allclose(mu - 30.0, q / THETA * 60.0 / retard,
                               rtol=0.02)


def test_gwe_zero_order_decay_closed_cell():
    """tests/test_gwe.py:284: a closed cell cools at rate·θ / bulk heat
    capacity; the reference's run of the same cell takes the same outer
    counts and lands within 10 × outer_dvclose."""
    kw = dict(decay=(est.DECAY_WATER, 2.0e5, 0.0), **PROPS)
    g = DisGrid.create(1, 1, 1, 1.0, 1.0, 1.0, np.zeros((1, 1, 1)))
    fields = fields_of(g, build_gwf("f", g, k=1.0, strt=0.5, device="cpu"))
    t, outers = run_energy(g, fields, np.array([20.0]), 10.0, 8,
                           settings=TIGHT, **kw)
    np.testing.assert_allclose(t[0], 20.0 - 2.0e5 * THETA / BULK_CAP * 80.0,
                               rtol=1e-10)
    jg = JaxDisGrid.create(1, 1, 1, 1.0, 1.0, 1.0, np.zeros((1, 1, 1)))
    jfields = jax_from_gwf_step(
        jax_build_gwf("f", jg, k=1.0, strt=0.5), jnp.asarray([0.5]),
        jnp.asarray([0.5]), jnp.asarray([1], jnp.int32), None, 1.0, True,
        ssm_spec={})
    jm = jax_build_gwe("e", jg, strt=np.array([20.0]), **kw)
    sol = JaxSolution(jm, JaxImsSettings(**TIGHT))
    temp = jnp.asarray(jm.strt)
    for k in range(8):
        temp, info, _ = sol.solve_timestep(temp, 10.0, iss=False,
                                           pkgs=jfields)
        assert info.outer_iterations == outers[k]
    np.testing.assert_allclose(t, np.asarray(temp), rtol=0,
                               atol=10 * TIGHT["outer_dvclose"])


def test_gwe_coupled_ssm_recharge_temperature():
    """tests/test_gwe.py:300: warm recharge warms the aquifer toward, and
    never past, its temperature; the reference's CoupledGwfGwe takes the
    same outer counts and temperatures within 10 × outer_dvclose."""
    n = 10
    gkw = dict(nlay=1, nrow=1, ncol=n, delr=10.0, delc=10.0, top=10.0,
               botm=np.zeros((1, 1, n)))
    fkw = dict(k=5.0, strt=5.0, storage={"ss": 1e-4, "iconvert": 0},
               chd=[(n - 1, 5.0)], rch=[(j, 1e-3) for j in range(n)])
    ekw = dict(strt=10.0, scheme="upstream", ssm_spec={"RCH": 25.0},
               **PROPS)
    runs = []
    for pkg in ("port", "ref"):
        if pkg == "port":
            g = DisGrid.create(**gkw)
            cpl = CoupledGwfGwe(build_gwf("f", g, device="cpu", **fkw),
                                build_gwe("e", g, device="cpu", **ekw))
        else:
            g = JaxDisGrid.create(**gkw)
            cpl = JaxCoupled(jax_build_gwf("f", g, **fkw),
                             jax_build_gwe("e", g, **ekw))
        head, temp, outers = cpl.gwf.strt, cpl.gwt.strt, []
        for kstp in range(1, 6):
            head, temp, fi, ti = cpl.step(head, temp, 50.0, kstp)
            assert fi.converged and ti.converged
            outers.append((fi.outer_iterations, ti.outer_iterations))
        runs.append((outers, np.asarray(temp)))
    (outers, t), (ref_outers, ref_t) = runs
    assert np.all(t > 10.0) and np.all(t <= 25.0 + 1e-6)
    assert outers == ref_outers
    np.testing.assert_allclose(t, ref_t, rtol=0, atol=10 * 1e-8)


# ---------------------------------------------------------- merged GWE

def test_merged_gwe_models_match_the_reference():
    """Two GWE members over two exchanged halves (CTP in one, ESL in the
    other): the merged system equals the reference's merge; differing SSM
    temperatures, which the reference's merge drops, raise."""
    half = 5
    gh = dict(nlay=1, nrow=1, ncol=half, delr=10.0, delc=1.0, top=1.0,
              botm=np.zeros((1, 1, half)))
    fkw = dict(k=2.0, strt=5.0, storage={"ss": 0.0, "iconvert": 0})
    ekw = dict(PROPS, strt=10.0, cnd=dict(ktw=0.6, kts=2.0))
    models = {}
    for pkg in ("port", "ref"):
        if pkg == "port":
            grid, gwf, gwe, merge, merge_e, pair, exg = (
                DisGrid, lambda *a, **k: build_gwf(*a, device="cpu", **k),
                lambda *a, **k: build_gwe(*a, device="cpu", **k),
                merge_gwf_models, merge_gwe_models, ExchangePair,
                GwfGwfExchange)
        else:
            grid, gwf, gwe, merge, merge_e, pair, exg = (
                JaxDisGrid, jax_build_gwf, jax_build_gwe, jax_merge,
                jax_merge_gwe, JaxPair, JaxExchange)
        g = grid.create(**gh)
        fm = merge([gwf("w", g, chd=[(0, 6.0)], **fkw),
                    gwf("e", g, chd=[(half - 1, 4.0)], **fkw)],
                   [exg(0, 1, [pair(half - 1, 0, ihc=1, cl1=5.0, cl2=5.0,
                                    hwva=1.0)])])
        models[pkg] = (fm, merge_e([gwe("ew", g, ctp=[(0, 40.0)], **ekw),
                                    gwe("ee", g, esl=[(2, 3.0)], **ekw)],
                                   fm))
    (tf, tm), (jf, jm) = models["port"], models["ref"]
    h, _, aux = NumericalSolution(tf, ImsSettings(**FLOW)).solve_timestep(
        tf.strt, 1.0, iss=True)
    ft = from_gwf_step(tf, h, h, aux["ibound"], None, 1.0, True, gwt=tm)
    fj = jax_from_gwf_step(jf, jnp.asarray(h.numpy()), jnp.asarray(
        h.numpy()), jnp.asarray(aux["ibound"].numpy()), None, 1.0, True)
    temp = 10.0 + np.arange(2 * half, dtype=float)
    ibj, cj = jm.boundary_state(jnp.asarray(temp))
    ibt, ct = tm.boundary_state(t64(temp))
    for got, want in zip(tm.assemble(ct, t64(temp), ibt, 1.0, False, ft),
                         jm.assemble(cj, jnp.asarray(temp), ibj, 1.0, False,
                                     fj)):
        close(got.reshape(np.asarray(want).shape), want)
    g = DisGrid.create(**gh)
    with pytest.raises(NotImplementedError, match="SSM source temperatures"):
        merge_gwe_models([build_gwe("a", g, device="cpu",
                                    ssm_spec={"RCH": 1.0}),
                          build_gwe("b", g, device="cpu")], tf)


# ---------------------------------------------------------------- decks

def gwe_deck(ws):
    """tests/test_gwe_prt_decks.py:118's deck (conduction between two CTP
    cells) with XT3D_OFF in CND6: MODFLOW 6 runs XT3D without it, the
    reference the two-point form."""
    import test_gwe_prt_decks as decks

    class Written(Exception):
        pass

    def stop(*args, **kwargs):
        raise Written()

    real, decks.load_simulation = decks.load_simulation, stop
    try:
        with pytest.raises(Written):
            decks.test_gwe_deck_conduction_linear(ws)
    finally:
        decks.load_simulation = real
    _edit("heat.cnd", lambda t: t.replace("BEGIN OPTIONS",
                                          "BEGIN OPTIONS\n  XT3D_OFF"))(ws)


def assert_same_model(port, ref):
    """The arrays and options of two GweModels, the topology aside."""
    got, want = gwe_reference_arrays(port), gwe_reference_arrays(ref)
    assert got[1] == want[1]
    assert got[0].keys() == want[0].keys()
    for key, value in want[0].items():
        if key not in ("nbr", "slot_nm", "slot_mn"):
            np.testing.assert_array_equal(got[0][key], value, err_msg=key)


def test_gwe_deck_conduction_linear(tmp_path):
    """tests/test_gwe_prt_decks.py:118 through the port's loader: the
    reference loader's model, a linear profile, and a TEMPERATURE file."""
    gwe_deck(tmp_path)
    sim = load_simulation(str(tmp_path), device="cpu")
    assert_same_model(sim.gwt, ref_load(str(tmp_path)).gwt)
    recs = sim.run()
    assert all(r.converged and r.transport_converged for r in recs)
    expect = np.linspace(100.0, 0.0, 11)
    np.testing.assert_allclose(sim.conc.numpy(), expect, atol=0.05)
    tem = read_head_file(os.path.join(str(tmp_path), "heat.tem"))
    assert len(tem) == 20 and tem[-1]["text"].strip() == "TEMPERATURE"
    np.testing.assert_array_equal(tem[-1]["data"].reshape(-1),
                                  sim.conc_records[-1])


def test_gwe_apt_deck_of_every_package_type_matches_the_reference(
        tmp_path):
    """LKE6, SFE6, MWE6, UZE6 and MVE6 beside MAW6, LAK6, SFR6, UZF6 and
    MVR6 (with EST6 and CND6): both loaders give the same model, rows and
    sources; the runs have equal outer counts and temperatures within
    10 × outer_dvclose; the TEMPERATURE file holds the grid rows."""
    apt_deck(tmp_path, model="GWE6")
    port, ref = (load_simulation(str(tmp_path), device="cpu"),
                 ref_load(str(tmp_path)))
    assert_same_model(port.gwt.base, ref.gwt.base)
    np.testing.assert_array_equal(port.gwt.strt.numpy(),
                                  np.asarray(ref.gwt.strt))
    assert port.gwt._pairs == ref.gwt._pairs
    for key, value in ref.apt_ext_conc.items():
        np.testing.assert_array_equal(port.apt_ext_conc[key].numpy(),
                                      np.asarray(value))
    got = port.run()
    tem = read_head_file(os.path.join(str(tmp_path), "t.ucn"))
    assert len(tem) == 3 and tem[-1]["text"].strip() == "TEMPERATURE"
    np.testing.assert_array_equal(tem[-1]["data"].reshape(-1),
                                  port.conc_records[-1][:8])
    want = ref.run()
    assert all(r.converged and r.transport_converged for r in got)
    assert [r.outer for r in got] == [r.outer for r in want]
    for a, b in zip(port.conc_records, ref.conc_records):
        np.testing.assert_allclose(a, b, rtol=0, atol=10 * 1e-8)
    # the sources' range: the infiltration at 0 (UZE sets none), the rain
    # at 15, the stream's inflow at 18
    assert -1e-4 <= min(c.min() for c in port.conc_records)
    assert max(c.max() for c in port.conc_records) <= 18.0 + 1e-4


def _heat(name, fn):
    return lambda ws: _edit(name, fn)(ws)


# key → (edit of gwe_deck, what the port's error names, what the
# reference does)
GWE_REFUSALS = {
    "R16 LATENT_HEAT_VAPORIZATION": (_heat("heat.est", lambda t: t.replace(
        "BEGIN OPTIONS", "BEGIN OPTIONS\n  LATENT_HEAT_VAPORIZATION 2.4e6")),
        "LATENT_HEAT_VAPORIZATION", "loads"),
    "R17 CTP6 PERIOD 2": (lambda ws: (_edit("sim.tdis", lambda t: t.replace(
        "NPER 1", "NPER 2").replace("  2000.0 20 1.2",
                                    "  2000.0 20 1.2\n  10.0 1 1.0"))(ws),
        _heat("heat.ctp", lambda t: t + "BEGIN PERIOD 2\n  1 1 1 50.0\n"
              "END PERIOD\n")(ws)), "PERIOD 2 of CTP6", "loads"),
    "R17 ESL6 PERIOD 2": (lambda ws: (_edit("sim.tdis", lambda t: t.replace(
        "NPER 1", "NPER 2").replace("  2000.0 20 1.2",
                                    "  2000.0 20 1.2\n  10.0 1 1.0"))(ws),
        _edit("heat.nam", lambda t: t.replace(
            "END PACKAGES", "  ESL6 heat.esl esl\nEND PACKAGES"))(ws),
        write(str(ws), "heat.esl", "BEGIN DIMENSIONS\n  MAXBOUND 1\n"
              "END DIMENSIONS\nBEGIN PERIOD 1\n  1 1 5 1.0\nEND PERIOD\n"
              "BEGIN PERIOD 2\n  1 1 5 2.0\nEND PERIOD\n")),
        "PERIOD 2 of ESL6", "loads"),
    "XT3D_OFF": (_heat("heat.cnd", lambda t: t.replace("  XT3D_OFF\n", "")),
                 "CND6 without XT3D_OFF", "loads"),
    "MST6 in a GWE6 model": (lambda ws: (_edit("heat.nam", lambda t: t.replace(
        "END PACKAGES", "  MST6 heat.mst\nEND PACKAGES"))(ws), write(
        str(ws), "heat.mst", "BEGIN GRIDDATA\n  POROSITY\n    CONSTANT 0.3\n"
        "END GRIDDATA\n")), "MST6 in a GWE6 model", "loads"),
    "BUY6 beside a GWE6 model": (lambda ws: (_edit("flow.nam", lambda t:
                                                   t.replace(
        "END PACKAGES", "  BUY6 flow.buy\nEND PACKAGES"))(ws), write(
        str(ws), "flow.buy", "BEGIN DIMENSIONS\n  NRHOSPECIES 1\n"
        "END DIMENSIONS\nBEGIN PACKAGEDATA\n  1 e1 TEMPERATURE -0.3 10.0\n"
        "END PACKAGEDATA\n")), "BUY6 or VSC6 beside a GWE6 model", "loads"),
}


@pytest.mark.parametrize("key", sorted(GWE_REFUSALS))
def test_gwe_refusals(tmp_path, key):
    """Where the reference reads past or runs another way, the port raises
    by name: R16 a nonzero latent heat of vaporization (stored and never
    used there), R17 a later PERIOD block of CTP6 or ESL6 (period 1 only
    there), CND6 without XT3D_OFF (the two-point form there), a GWT
    package in a GWE6 name file (read past there), BUY6 beside a GWE6
    model (the temperature read as a concentration there)."""
    gwe_deck(tmp_path)
    edit, names, ref_does = GWE_REFUSALS[key]
    edit(tmp_path)
    with pytest.raises(NotImplementedError, match=names):
        load_simulation(str(tmp_path), device="cpu")
    if ref_does == "loads":
        assert ref_load(str(tmp_path)).gwt is not None


def test_lke_ktf_is_refused(tmp_path):
    """A nonzero KTF of LKE6 (the feature-aquifer conduction, which the
    reference's load_apt reads past) raises by name; the reference loads
    the deck."""
    apt_deck(tmp_path, model="GWE6")
    _edit("t.lke", lambda t: t.replace("  1 12.0 0.0 1.0",
                                       "  1 12.0 0.5 1.0"))(tmp_path)
    with pytest.raises(NotImplementedError, match="LKE6.*KTF"):
        load_simulation(str(tmp_path), device="cpu")
    assert ref_load(str(tmp_path)).gwt is not None
