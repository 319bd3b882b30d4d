"""Parity of the port's nonlinear solve with the reference on the CPU: the
Newton terms of NPF, STO and WEL, the Newton under-relaxation,
pseudo-transient continuation, backtracking on a Newton model, and
wetting/drying, through ``NumericalSolution``, the fused step, the
``Simulation`` and the deck path.

Inputs are made with numpy from a seed and given to both packages.

Tolerances:

- pointwise functions and one sweep of ``wetdry_update``/``under_relax``:
  rtol 1e-13 or exact (the same float64 operations in the same order).
- assembled systems with Newton terms: rtol 1e-12 of the largest entry.
  The reference scatters edge terms with ``.at[].add``; the port adds at
  most six terms per cell in the order x, y, z: rounding only.
- whole solves.  Every scenario here uses BiCGSTAB, which turns the last
  bits of a sum into other iteration counts: the reference jitted and the
  reference run op by op differ from each other (backtracking scenario:
  1346 and 1087 inner iterations; Newton under-relaxation: 23 and 16
  outer iterations, where this was written).  So against the jitted
  reference the heads are held to ten times the outer closure criterion
  (two solves closed at ``outer_dvclose`` agree to that, not to rounding)
  and counts are not compared; and the cause is shown scenario by
  scenario: with the reference run op by op and its sums taken in
  PyTorch's order (``reference_in_torch_sum_order``), the port has the
  reference's outer and inner counts exactly and heads within 1e-10
  (bitwise where this was written).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_regression_decks import ims_text, write
from test_torch_parity import (build_both, convert, convertible_args,
                               jax_system, model_options,
                               reference_in_torch_sum_order, torch_system)
from modflow6_tpu.models.gwf import bnd as jbnd
from modflow6_tpu.models.gwf import npf as jnpf
from modflow6_tpu.models.gwf import sto as jsto
from modflow6_tpu.models.simulation import Simulation as JaxSimulation
from modflow6_tpu.ops import smoothing as jsmooth
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxNumericalSolution
from modflow6_tpu.solution.fused import make_fused_step as jax_fused_step
from modflow6_tpu.timing import StressPeriod as JaxStressPeriod
from modflow6_tpu.timing import Tdis as JaxTdis
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.__main__ import main as cli_main
from modflow6_torch.models.gwf import bnd as tbnd
from modflow6_torch.models.gwf import npf as tnpf
from modflow6_torch.models.gwf import sto as tsto
from modflow6_torch.models.simulation import Simulation
from modflow6_torch.ops import smoothing as tsmooth
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.fused import make_fused_step
from modflow6_torch.solution.ims import NumericalSolution
from modflow6_torch.timing.tdis import StressPeriod, Tdis
from modflow6_torch.utils.mf6io import load_simulation

BICGSTAB = dict(linear_acceleration="bicgstab")


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _assert_rel(got, want, rtol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0, err_msg=what,
        atol=rtol * max(float(np.abs(want).max()), 1e-300))


# ------------------------------------------------------------ pointwise

def test_sq_saturation_derivative_matches_reference():
    rng = np.random.default_rng(0)
    top = rng.uniform(5.0, 10.0, 200)
    bot = top - rng.uniform(0.0, 4.0, 200)
    bot[:5] = top[:5]                      # zero thickness
    x = rng.uniform(0.0, 12.0, 200)
    for fn in ("sq_saturation_derivative", "quadratic_saturation_derivative"):
        want = getattr(jsmooth, fn)(jnp.asarray(top), jnp.asarray(bot),
                                    jnp.asarray(x))
        got = getattr(tsmooth, fn)(_t(top), _t(bot), _t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


def _newton_model(**extra):
    grid, kw = convertible_args()
    return build_both((grid, {**kw, "newton": True, **extra}))


@pytest.mark.parametrize("ivarcv", [0, 1], ids=["constcv", "variablecv"])
def test_newton_terms_on_planes_match_the_edge_form(ivarcv):
    """``npf.newton_terms`` alone: the reference's edge form and the port's
    plane form add the same terms to a random system, on a grid with idomain
    holes (faces without a connection add nothing) and heads on both sides
    of every face."""
    ref, port = _newton_model(ivarcv=ivarcv)
    rng = np.random.default_rng(1)
    n = ref.nodes
    head = rng.uniform(8.0, 32.0, n)
    ib = np.asarray(ref.ibound0).copy()
    ib[rng.random(n) < 0.1] = -1          # some constant heads
    ib[np.asarray(ref.ibound0) == 0] = 0
    ib[rng.random(n) < 0.05] = 0          # some dry cells
    diag, rhs = rng.normal(-5.0, 1.0, n), rng.normal(0.0, 1.0, n)
    off = rng.uniform(0.0, 1.0, (n, 6))
    want = jnpf.newton_terms(ref.dtopo, ref.npf_opts, ref.npf_arrays,
                             jnp.asarray(head), jnp.asarray(ib, jnp.int32),
                             jnp.asarray(diag), jnp.asarray(off),
                             jnp.asarray(rhs))
    got = tnpf.newton_terms(port.dtopo, port.npf_opts, port.npf_arrays,
                            _t(head), _t(ib, torch.int32), _t(diag), _t(off),
                            _t(rhs), port.condsat3, port.ibound0)
    changed = 0
    for g, w, before, what in zip(got, want, (diag, off, rhs),
                                  ("diag", "off", "rhs")):
        _assert_rel(g, w, 1e-12, what)
        changed += int((np.asarray(w) != before).sum())
    assert changed > 100
    # the vertical faces add terms only with VARIABLECV
    c = got[1].numpy().reshape(ref.dtopo.grid_shape + (6,))
    c0 = off.reshape(c.shape)
    assert (c[..., 4:] != c0[..., 4:]).any() == bool(ivarcv)


@pytest.mark.parametrize("extra", [
    dict(), dict(ivarcv=1), dict(ivarcv=1, idewatcv=1, iperched=1),
    dict(newton="under_relaxation", icellavg=2),
    dict(wel_auto_flow_reduce=0.3)],
    ids=["newton", "variablecv", "dewatered-perched", "nur-amtlmk",
         "flowreduce"])
@pytest.mark.parametrize("symmetric", [True, False], ids=["cg", "bicgstab"])
def test_newton_assembly_matches_reference(extra, symmetric):
    """``GwfModel.assemble`` with its Newton terms (NPF, STO, WEL) and
    without them (``newton=False``, the backtracking rebuild), after either
    Dirichlet fixup, from ``build_gwf`` and from ``from_reference``."""
    ref, port = _newton_model(**extra)
    rng = np.random.default_rng(2)
    h = rng.uniform(8.0, 32.0, ref.nodes)
    h_old = h + rng.normal(0.0, 1.0, ref.nodes)
    assert model_options(port) == model_options(ref)
    assert dataclasses.asdict(port.npf_opts) == dataclasses.asdict(
        ref.npf_opts)
    assert dataclasses.asdict(port.sto_opts) == dataclasses.asdict(
        ref.sto_opts)
    assert port.npf_opts.satomega == port.sto_opts.satomega == 1e-6
    for newton in (True, False):
        want = jax_system(ref, h, h_old, 3.0, symmetric=symmetric,
                          newton=newton)
        for model in (port, convert(ref)):
            got = torch_system(model, h, h_old, 3.0, symmetric=symmetric,
                               newton=newton)
            for w, g, what in zip(want, got, ("diag", "off", "rhs")):
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=1e-12 * np.abs(w).max(), err_msg=what)
    with_terms = torch_system(port, h, h_old, 3.0, symmetric=False)
    without = torch_system(port, h, h_old, 3.0, symmetric=False,
                           newton=False)
    assert all((a != b).any() for a, b in zip(with_terms, without))


def test_sto_and_wel_newton_terms_match_reference():
    ref, port = _newton_model(wel_auto_flow_reduce=0.4,
                              wel=[(9 * 11 + 4 * 11 + 5, -150.0), (3, -20.0),
                                   (40, 15.0)])
    rng = np.random.default_rng(3)
    h = rng.uniform(-2.0, 34.0, ref.nodes)
    ib = np.asarray(ref.ibound0)
    for iconf_ss, iorig_ss in ((0, 0), (0, 1), (1, 0)):
        jo = dataclasses.replace(ref.sto_opts, iconf_ss=iconf_ss,
                                 iorig_ss=iorig_ss)
        to = dataclasses.replace(port.sto_opts, iconf_ss=iconf_ss,
                                 iorig_ss=iorig_ss)
        want = jsto.newton_terms(jo, ref.sto_arrays, jnp.asarray(h),
                                 jnp.asarray(ib), 2.5)
        got = tsto.newton_terms(to, port.sto_arrays, _t(h),
                                _t(ib, torch.int32), 2.5)
        for g, w in zip(got, want):
            _assert_rel(g, w, 1e-13)
        assert np.abs(np.asarray(want[0])).max() > 0 or iconf_ss
    a, ta = ref.npf_arrays, port.npf_arrays
    for iflowred in (1, 0):
        jargs = (jnp.asarray(h), jnp.asarray(ib), a.icelltype, a.top, a.bot,
                 iflowred, 0.4)
        targs = (_t(h), _t(ib, torch.int32), ta.icelltype, ta.top, ta.bot,
                 iflowred, 0.4)
        for jf, tf in ((jbnd.wel_terms, tbnd.wel_terms),
                       (jbnd.wel_newton, tbnd.wel_newton)):
            for g, w in zip(tf(port.wel, *targs), jf(ref.wel, *jargs)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-13)


def test_under_relax_matches_reference():
    ref, port = _newton_model()
    rng = np.random.default_rng(4)
    n = ref.nodes
    bot = np.asarray(ref.npf_arrays.bot)
    xtemp = bot + rng.uniform(0.5, 5.0, n)
    x = bot + rng.uniform(-3.0, 5.0, n)           # some below the bottom
    ib = rng.integers(-1, 2, n)
    dx = x - xtemp
    want = jnpf.under_relax(ref.npf_arrays, jnp.asarray(ib), jnp.asarray(x),
                            jnp.asarray(xtemp), jnp.asarray(dx),
                            ref.npf_arrays.bot)
    got = tnpf.under_relax(port.npf_arrays, _t(ib, torch.int32), _t(x),
                           _t(xtemp), _t(dx), port.npf_arrays.bot)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[2]) and got[3].shape == ()


@pytest.mark.parametrize("kiter,iwetit,ihdwet,wetfct", [
    (1, 1, 0, 1.0), (2, 2, 1, 0.5), (3, 2, 0, 0.7), (4, 1, 1, 1.0)])
def test_wetdry_update_matches_reference(kiter, iwetit, ihdwet, wetfct):
    """One sweep on a random state of a three-layer grid with idomain
    holes: cells that rewet from below, from the side (WETDRY > 0 only),
    cells that dry, and sweeps that iwetit skips."""
    rng = np.random.default_rng(5)
    nlay, nrow, ncol = 3, 7, 8
    idomain = np.ones((nlay, nrow, ncol), np.int32)
    idomain[0, 2:4, 3:5] = 0
    idomain[1, 5, 1] = 0
    botm = np.stack([np.full((nrow, ncol), b) for b in (20.0, 10.0, 0.0)])
    grid = dict(nlay=nlay, nrow=nrow, ncol=ncol, delr=10.0, delc=10.0,
                top=30.0, botm=botm, idomain=idomain)
    n = nlay * nrow * ncol
    wetdry = rng.choice([-1.5, 0.0, 0.5, 2.0], n)
    wetdry[idomain.reshape(-1) == 0] = 2.0
    ref, port = build_both((grid, dict(
        k=1.0, icelltype=rng.integers(0, 2, n), strt=15.0,
        rewetting=dict(wetdry=wetdry, wetfct=wetfct, iwetit=iwetit,
                       ihdwet=ihdwet))))
    assert port.rewet_opts == ref.rewet_opts == (wetfct, iwetit, ihdwet)
    np.testing.assert_array_equal(port.wetdry.numpy(), np.asarray(ref.wetdry))
    ib = rng.integers(-1, 2, n)
    # cells outside the grid's domain with a dry status and WETDRY set: the
    # reference has no edge that could rewet them
    ib[idomain.reshape(-1) == 0] = 0
    head = rng.uniform(0.0, 32.0, n)
    # ... and each has an active eastern neighbour whose head would wet it
    node = np.arange(n).reshape(nlay, nrow, ncol)
    wetdry_holes = node[idomain == 0]
    assert (wetdry[wetdry_holes] == 2.0).all()
    for east in (node[0, 2:4, 5], node[1, 5, 2:3]):
        ib[east] = 1
        head[east] = 31.9
    want = jnpf.wetdry_update(ref.dtopo, ref.npf_arrays, ref.wetdry,
                              jnp.asarray(ib, jnp.int32), jnp.asarray(head),
                              jnp.asarray(kiter, jnp.int32), iwetit=iwetit,
                              ihdwet=ihdwet, wetfct=wetfct)
    got = tnpf.wetdry_update(port.dtopo, port.npf_arrays, port.wetdry,
                             port.ibound0, _t(ib, torch.int32), _t(head),
                             kiter, iwetit=iwetit, ihdwet=ihdwet,
                             wetfct=wetfct)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-15)
    assert bool(got[2]) == bool(want[2])
    rewet = (ib == 0) & (got[0].numpy() > 0)
    assert rewet.any() == (kiter % iwetit == 0)
    assert not rewet[idomain.reshape(-1) == 0].any()
    assert ((ib > 0) & (got[0].numpy() == 0)).any()


def test_is_linear_follows_the_reference_rules():
    grid, kw = convertible_args()
    confined = {**kw, "icelltype": 0, "storage": {"ss": 1e-5, "iconvert": 0}}
    cases = [({}, True), (dict(newton=True), False),
             (dict(wel_auto_flow_reduce=0.1), False),
             (dict(icelltype=1), False)]
    for extra, linear in cases:
        ref, port = build_both((grid, {**confined, **extra}))
        assert port.is_linear == ref.is_linear == linear, extra
    # rewetting changes ibound between outer iterations: never hoisted
    port = build_both((grid, {**confined, "rewetting": {"wetdry": 1.0}}))[1]
    assert not port.is_linear


# ------------------------------------------------------- whole solves

def _row(ncol, delr, top, delc=None):
    return dict(nlay=1, nrow=1, ncol=ncol, delr=delr, delc=delc or delr,
                top=top, botm=np.zeros((1, 1, ncol)))


def _ptc_scenario(no_ptc=False):
    """tests/test_robustness.py:82 test_ptc_steady_newton_converges."""
    ncol = 30
    args = (_row(ncol, 50.0, 50.0),
            dict(k=5.0, strt=45.0, icelltype=1, newton=True,
                 chd=[(0, 45.0), (ncol - 1, 12.0)]))
    return args, dict(outer_dvclose=1e-8, outer_maximum=200,
                      inner_dvclose=1e-10, inner_rclose=1e-9,
                      inner_maximum=200, no_ptc=no_ptc, **BICGSTAB)


def _backtracking_scenario():
    """tests/test_robustness.py:130 test_backtracking_path_converges."""
    ncol = 25
    rng = np.random.default_rng(8)
    args = (_row(ncol, 10.0, 20.0),
            dict(k=np.exp(rng.normal(0.0, 1.5, ncol)), strt=15.0,
                 icelltype=1, newton=True, chd=[(0, 18.0), (ncol - 1, 6.0)],
                 rch=[(i, 1e-3) for i in range(ncol)]))
    return args, dict(outer_dvclose=1e-8, outer_maximum=300,
                      inner_dvclose=1e-10, inner_rclose=1e-9,
                      inner_maximum=300, backtracking_number=10,
                      backtracking_tolerance=1.05,
                      backtracking_reduction_factor=0.5,
                      backtracking_residual_limit=0.002, **BICGSTAB)


def _dupuit_scenario(**extra):
    """tests/test_gwf_steady.py:95 test_unconfined_newton_dupuit."""
    ncol = 41
    args = (_row(ncol, 400.0 / ncol, 30.0, 1.0),
            dict(k=2.0, strt=20.0, icelltype=1, newton=True,
                 chd=[(0, 20.0), (ncol - 1, 10.0)], **extra))
    return args, dict(outer_dvclose=1e-8, outer_maximum=200,
                      inner_dvclose=1e-9, inner_rclose=1e-8,
                      inner_maximum=600, **BICGSTAB)


def _nur_scenario():
    """The Dupuit row drawn down to 1.0 at one end with a well that
    AUTO_FLOW_REDUCE throttles, under NEWTON UNDER_RELAXATION: heads fall
    below cell bottoms on the way, so npf_nur and its convergence rescue
    run."""
    args, s = _dupuit_scenario()
    grid, kw = args
    return (grid, {**kw, "newton": "under_relaxation",
                   "chd": [(0, 20.0), (40, 1.0)], "wel": [(20, -3.0)],
                   "wel_auto_flow_reduce": 0.1}), s


def _rewet_scenario():
    """tests/test_robustness.py:246 test_npf_rewetting_two_layer: the upper
    layer starts dry and rewets from below and from the side."""
    nlay, ncol = 2, 9
    botm = np.zeros((nlay, 1, ncol))
    botm[0] = 10.0
    wetdry = np.zeros(nlay * ncol)
    wetdry[:ncol] = 1.0
    args = (dict(nlay=nlay, nrow=1, ncol=ncol, delr=10.0, delc=10.0,
                 top=20.0, botm=botm),
            dict(k=5.0, k33=5.0, strt=5.0, icelltype=1,
                 chd=[(ncol, 18.0), (2 * ncol - 1, 12.0)],
                 rewetting=dict(wetdry=wetdry, wetfct=1.0, iwetit=1,
                                ihdwet=0)))
    return args, dict(outer_dvclose=1e-8, outer_maximum=300,
                      inner_dvclose=1e-10, inner_rclose=1e-9,
                      inner_maximum=500, under_relaxation="dbd", theta=0.9,
                      akappa=1e-4, gamma=0.0, amomentum=0.0, **BICGSTAB)


SCENARIOS = {
    "ptc": _ptc_scenario, "no-ptc": lambda: _ptc_scenario("all"),
    "backtracking": _backtracking_scenario, "dupuit": _dupuit_scenario,
    "newton-under-relaxation": _nur_scenario, "rewetting": _rewet_scenario}


def _solve(solution, strt, **kw):
    head, info, aux = solution.solve_timestep(strt, 1.0, iss=True, **kw)
    return np.asarray(head), info, np.asarray(aux["ibound"])


@pytest.fixture(scope="module")
def port_runs():
    """Each scenario through the port once: (head, info, ibound)."""
    out = {}
    for name, make in SCENARIOS.items():
        args, s = make()
        port = build_both(args)[1]
        head, info, aux = NumericalSolution(port, ImsSettings(**s)
                                            ).solve_timestep(port.strt, 1.0,
                                                             iss=True)
        out[name] = head.numpy(), info, aux["ibound"].numpy()
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jitted_reference(name, port_runs):
    """Against the reference as its own tests run it: both converge, the
    same cells are wet, heads within ten times the outer closure."""
    args, s = SCENARIOS[name]()
    ref = build_both(args)[0]
    want, winfo, wib = _solve(JaxNumericalSolution(ref, JaxImsSettings(**s)),
                              jnp.asarray(ref.strt))
    got, ginfo, gib = port_runs[name]
    print(name, "reference (outer, inner)", (winfo.outer_iterations,
                                             winfo.inner_iterations),
          "port", (ginfo.outer_iterations, ginfo.inner_iterations))
    assert winfo.converged and ginfo.converged
    np.testing.assert_array_equal(gib, wib)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=10 * s["outer_dvclose"])


@pytest.mark.parametrize("name", ["backtracking", "newton-under-relaxation",
                                  "ptc", "rewetting"])
def test_scenario_counts_at_one_sum_order(name, port_runs, monkeypatch):
    """The cause of the count differences against the jitted reference:
    with the reference run op by op and its sums in PyTorch's order the
    port takes the reference's outer and inner counts and its heads are
    within 1e-10."""
    args, s = SCENARIOS[name]()
    ref = build_both(args)[0]
    reference_in_torch_sum_order(monkeypatch)
    with jax.disable_jit():
        want, winfo, wib = _solve(
            JaxNumericalSolution(ref, JaxImsSettings(**s)),
            jnp.asarray(ref.strt))
    got, ginfo, gib = port_runs[name]
    assert winfo.converged and ginfo.converged
    assert (ginfo.outer_iterations, ginfo.inner_iterations) == (
        winfo.outer_iterations, winfo.inner_iterations)
    np.testing.assert_array_equal(gib, wib)
    np.testing.assert_allclose(ginfo.dvmax_history, winfo.dvmax_history,
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_scenarios_exercise_what_they_name(port_runs):
    """The scenarios' own checks from the reference's tests, on the port's
    heads."""
    ptc, info, _ = port_runs["ptc"]
    off = port_runs["no-ptc"][0]
    np.testing.assert_allclose(ptc, off, atol=1e-5)
    h2 = ptc ** 2                 # Dupuit parabola between the CHDs
    np.testing.assert_allclose(h2[1:-1], np.linspace(h2[0], h2[-1], 30)[1:-1],
                               rtol=4e-2)
    args, s = _backtracking_scenario()
    plain = build_both(args)[1]
    h0, info0, _ = NumericalSolution(plain, ImsSettings(**{
        **s, "backtracking_number": 0})).solve_timestep(plain.strt, 1.0,
                                                        iss=True)
    assert info0.converged
    np.testing.assert_allclose(port_runs["backtracking"][0], h0.numpy(),
                               atol=1e-5)
    xc = (np.arange(41) + 0.5) * 400.0 / 41
    dupuit = np.sqrt(20.0**2 + (10.0**2 - 20.0**2) * (xc - xc[0])
                     / (xc[-1] - xc[0]))
    np.testing.assert_allclose(port_runs["dupuit"][0], dupuit, rtol=2e-3)


def test_ptc_gate_follows_no_ptc_and_the_period():
    """tests/test_robustness.py:119 on both packages."""
    grid = _row(4, 1.0, 1.0)
    ref, port = build_both((grid, dict(k=1.0, strt=0.5, icelltype=1,
                                       newton=True,
                                       chd=[(0, 1.0), (3, 0.2)])))
    for no_ptc in (False, "first", "all", True):
        jsol = JaxNumericalSolution(ref, JaxImsSettings(no_ptc=no_ptc,
                                                        **BICGSTAB))
        tsol = NumericalSolution(port, ImsSettings(no_ptc=no_ptc, **BICGSTAB))
        for iss in (True, False):
            for kper in (1, 2):
                assert tsol._use_ptc(iss, kper=kper) == jsol._use_ptc(
                    iss, kper=kper)
    first = NumericalSolution(port, ImsSettings(no_ptc="first", **BICGSTAB))
    assert not first._use_ptc(True, kper=1) and first._use_ptc(True, kper=2)
    confined = build_both((grid, dict(k=1.0, strt=0.5,
                                      chd=[(0, 1.0), (3, 0.2)])))[1]
    assert not NumericalSolution(confined, ImsSettings())._use_ptc(True, 2)


def test_ptc_changes_the_path_not_the_answer(port_runs):
    """PTC is really applied: the outer history of the steady Newton solve
    differs with NO_PTC; ptcdel0 and ptcexp are read."""
    assert port_runs["ptc"][1].dvmax_history != \
        port_runs["no-ptc"][1].dvmax_history
    args, s = _ptc_scenario()
    ref, port = build_both(args)
    s = {**s, "ptcdel0": 0.5, "ptcexp": 1.5}
    want, winfo, _ = _solve(JaxNumericalSolution(ref, JaxImsSettings(**s)),
                            jnp.asarray(ref.strt))
    got, ginfo, _ = _solve(NumericalSolution(port, ImsSettings(**s)),
                           port.strt)
    assert ginfo.converged and winfo.converged
    assert ginfo.dvmax_history != port_runs["ptc"][1].dvmax_history
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(ginfo.dvmax_history[:3],
                               winfo.dvmax_history[:3], rtol=1e-6)


def test_fused_matches_ims_with_ptc(monkeypatch):
    """tests/test_robustness.py:162: the fused step and ``NumericalSolution``
    on a steady Newton problem where PTC is on in both (kper=2), in the
    port (equal counts, heads 1e-12) and against the reference's fused step
    in PyTorch's sum order (equal counts, heads 1e-10)."""
    ncol = 15
    args = (_row(ncol, 20.0, 30.0),
            dict(k=2.0, strt=25.0, icelltype=1, newton=True,
                 chd=[(0, 28.0), (ncol - 1, 8.0)]))
    s = dict(outer_dvclose=1e-9, outer_maximum=150, inner_dvclose=1e-11,
             inner_rclose=1e-10, inner_maximum=300, **BICGSTAB)
    ref, port = build_both(args)
    sol = NumericalSolution(port, ImsSettings(**s))
    h_ims, info, _ = sol.solve_timestep(port.strt, 1.0, iss=True, kper=2)
    assert info.converged and sol._use_ptc(True, 2)
    h_fused, kiter, inner, conv = make_fused_step(
        port, ImsSettings(**s), iss=True, kper=2)(port.strt, 1.0, 1)
    assert conv and (kiter, inner) == (info.outer_iterations,
                                       info.inner_iterations)
    np.testing.assert_allclose(h_fused.numpy(), h_ims.numpy(), rtol=0,
                               atol=1e-12)
    # NO_PTC FIRST turns it off in period 1: another path, the same heads
    h_off, k_off, _, c_off = make_fused_step(
        port, ImsSettings(**s, no_ptc="first"), iss=True, kper=1)(
        port.strt, 1.0, 1)
    assert c_off
    np.testing.assert_allclose(h_off.numpy(), h_ims.numpy(), atol=1e-7)
    jit_h, _, _, jit_c = jax.jit(jax_fused_step(
        ref, JaxImsSettings(**s), iss=True, kper=2))(
        jnp.asarray(ref.strt), jnp.asarray(1.0), jnp.asarray(1, jnp.int32))
    assert bool(jit_c)
    np.testing.assert_allclose(h_fused.numpy(), np.asarray(jit_h), atol=1e-7)
    reference_in_torch_sum_order(monkeypatch)
    with jax.disable_jit():
        wh, wk, wi, wc = jax_fused_step(ref, JaxImsSettings(**s), iss=True,
                                        kper=2)(
            jnp.asarray(ref.strt), jnp.asarray(1.0),
            jnp.asarray(1, jnp.int32))
    assert bool(wc) and (kiter, inner) == (int(wk), int(wi))
    np.testing.assert_allclose(h_fused.numpy(), np.asarray(wh), rtol=0,
                               atol=1e-10)


def test_small_newton_heads_are_set_by_the_inner_closure():
    """Why the card-against-CPU check of the small BiCGSTAB models
    (chip_smoke.py check_small_newton) holds heads to 10 x outer_dvclose and
    not to 1e-10: on the 15-cell steady Newton row with PTC, tightening the
    inner closure from (1e-11, 1e-10) to (1e-12, 1e-12) moves the CPU's own
    converged heads by more than 1e-10 (8e-10 where this was written;
    BiCGSTAB then runs into INNER_MAXIMUM).  Two runs that differ only in
    the order of their sums (card and CPU: 5e-10 on an H100, with equal
    counts) cannot agree more closely than the solve determines its
    answer."""
    port = build_both((_row(15, 20.0, 30.0),
                       dict(k=2.0, strt=25.0, icelltype=1, newton=True,
                            chd=[(0, 28.0), (14, 8.0)])))[1]
    heads = []
    for dvclose, rclose in ((1e-11, 1e-10), (1e-12, 1e-12)):
        s = ImsSettings(outer_dvclose=1e-9, outer_maximum=150,
                        inner_dvclose=dvclose, inner_rclose=rclose,
                        inner_maximum=300, **BICGSTAB)
        h, info, _ = NumericalSolution(port, s).solve_timestep(
            port.strt, 1.0, iss=True, kper=2)
        assert info.converged
        heads.append(h)
    moved = float((heads[0] - heads[1]).abs().max())
    print("heads moved by", moved)
    assert 1e-10 < moved < 1e-8


def test_fused_step_newton_under_relaxation_matches_ims():
    """The fused step's Newton under-relaxation lines against
    ``NumericalSolution`` on the drawn-down row, without PTC (transient
    with no storage package behaves as steady): same heads at closure."""
    args, s = _nur_scenario()
    port = build_both(args)[1]
    s = {**s, "no_ptc": "all"}
    h_ims, info, _ = NumericalSolution(port, ImsSettings(**s)).solve_timestep(
        port.strt, 1.0, iss=True)
    h_fused, kiter, _, conv = make_fused_step(port, ImsSettings(**s),
                                              iss=True)(port.strt, 1.0, 1)
    assert info.converged and conv
    np.testing.assert_allclose(h_fused.numpy(), h_ims.numpy(), rtol=0,
                               atol=1e-6)
    assert float(h_ims.min()) >= 0.0


def test_rewetting_two_layer(port_runs):
    """The reference's own checks of the rewetting scenario on the port's
    run, and the dry status carried into a second step (``ibound_in``)."""
    ncol = 9
    args, s = _rewet_scenario()
    grid, kw = args
    oracle = build_both((grid, {**{k: v for k, v in kw.items()
                                   if k != "rewetting"}, "newton": True}))[1]
    so = dict(outer_dvclose=1e-8, outer_maximum=200, inner_dvclose=1e-10,
              inner_rclose=1e-9, inner_maximum=500, **BICGSTAB)
    hN, infoN, _ = NumericalSolution(oracle, ImsSettings(**so)
                                     ).solve_timestep(oracle.strt, 1.0,
                                                      iss=True)
    assert infoN.converged
    hN = hN.numpy()
    hR, infoR, ib = port_runs["rewetting"]
    assert (ib[:ncol] > 0).any(), "no upper-layer cell rewetted"
    wt = hN[ncol:]
    for j in range(ncol):
        if wt[j] > 11.5:
            assert ib[j] > 0, f"col {j} should have rewetted"
        if wt[j] < 10.5:
            assert ib[j] == 0, f"col {j} should be dry"
    act = ib > 0
    np.testing.assert_allclose(hR[act], hN[act], atol=0.05)

    ref, port = build_both(args)
    sol = NumericalSolution(port, ImsSettings(**s))
    # carry a dry cell into the next step: it stays dry until it rewets
    ib_in = ib.copy()
    ib_in[0] = 0
    h2, info2, aux2 = sol.solve_timestep(_t(hR), 1.0, iss=True,
                                         ibound_in=_t(ib_in, torch.int32))
    jh2, jinfo2, jaux2 = JaxNumericalSolution(
        ref, JaxImsSettings(**s)).solve_timestep(
        jnp.asarray(hR), 1.0, iss=True, ibound_in=jnp.asarray(ib_in))
    assert info2.converged and jinfo2.converged
    np.testing.assert_array_equal(aux2["ibound"].numpy(),
                                  np.asarray(jaux2["ibound"]))
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(h2.numpy()[act], hN[act], atol=0.05)


def test_unconfined_sy_mass_balance():
    """tests/test_gwf_transient.py:75 through both packages' Simulation: a
    closed unconfined Newton bucket with recharge and convertible storage
    (sto_fn); the water table rises by recharge*t/sy, and the budget
    closes."""
    grid = dict(nlay=1, nrow=1, ncol=1, delr=100.0, delc=100.0, top=50.0,
                botm=np.zeros((1, 1, 1)))
    kw = dict(k=1.0, strt=10.0, icelltype=1, newton=True,
              storage={"ss": 0.0, "sy": 0.2, "iconvert": 1}, rch=[(0, 0.01)])
    s = dict(outer_dvclose=1e-10, outer_maximum=200, inner_dvclose=1e-12,
             inner_rclose=1e-10, inner_maximum=100, **BICGSTAB)
    ref, port = build_both((grid, kw))
    jsim = JaxSimulation(JaxTdis((JaxStressPeriod(100.0, 20, 1.0),)), ref,
                         JaxImsSettings(**s), transient=[True])
    want = jsim.run()
    sim = Simulation(Tdis((StressPeriod(100.0, 20, 1.0),)), port,
                     ImsSettings(**s), transient=[True])
    got = sim.run()
    assert all(r.converged for r in got) and len(got) == 20
    assert [r.outer for r in got] == [r.outer for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.head, w.head, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[-1].head[0], 10.0 + 0.01 * 100.0 / 0.2,
                               rtol=1e-6)
    assert abs(sim.budget.percent_discrepancy()) < 1e-6
    np.testing.assert_allclose(sim.budget.percent_discrepancy(),
                               jsim.budget.percent_discrepancy(), atol=1e-9)


# ------------------------------------------------------------ deck path

def build_newton01(ws, newton="NEWTON", extra_npf="", wel=False):
    """The deck of tests/test_regression_decks.py:191 test_newton01_analytic
    (2-layer unconfined Newton column, layer-2 CHD at 7 under a dry layer 1
    with recharge 1.0), with an optional AUTO_FLOW_REDUCE well."""
    write(ws, "mfsim.nam", """
BEGIN TIMING
  TDIS6 sim.tdis
END TIMING
BEGIN MODELS
  GWF6 m.nam NEWTON01
END MODELS
BEGIN SOLUTIONGROUP 1
  IMS6 sim.ims NEWTON01
END SOLUTIONGROUP
""")
    write(ws, "sim.tdis", """
BEGIN DIMENSIONS
  NPER 1
END DIMENSIONS
BEGIN PERIODDATA
  1.0 1 1.0
END PERIODDATA
""")
    write(ws, "sim.ims", ims_text("BICGSTAB", hclose=1e-9, rclose=1e-9))
    wel_line = "  WEL6 m.wel wel\n" if wel else ""
    write(ws, "m.nam", f"""
BEGIN OPTIONS
  {newton}
END OPTIONS
BEGIN PACKAGES
  DIS6 m.dis dis
  IC6 m.ic ic
  NPF6 m.npf npf
  CHD6 m.chd chd
  RCH6 m.rch rch
{wel_line}END PACKAGES
""")
    write(ws, "m.dis", """
BEGIN DIMENSIONS
  NLAY 2
  NROW 3
  NCOL 3
END DIMENSIONS
BEGIN GRIDDATA
  DELR
    CONSTANT 1.0
  DELC
    CONSTANT 1.0
  TOP
    CONSTANT 20.0
  BOTM LAYERED
    CONSTANT 10.0
    CONSTANT 0.0
END GRIDDATA
""")
    write(ws, "m.ic",
          "BEGIN GRIDDATA\n  STRT\n    CONSTANT 7.0\nEND GRIDDATA\n")
    write(ws, "m.npf", f"""
{extra_npf}
BEGIN GRIDDATA
  ICELLTYPE
    CONSTANT 1
  K
    CONSTANT 10.0
END GRIDDATA
""")
    chd_lines = "\n".join(f"  2 {i + 1} {j + 1} 7.0"
                          for i in range(3) for j in range(3))
    write(ws, "m.chd", f"""
BEGIN DIMENSIONS
  MAXBOUND 9
END DIMENSIONS
BEGIN PERIOD 1
{chd_lines}
END PERIOD
""")
    rch_lines = "\n".join(f"  1 {i + 1} {j + 1} 1.0"
                          for i in range(3) for j in range(3))
    write(ws, "m.rch", f"""
BEGIN DIMENSIONS
  MAXBOUND 9
END DIMENSIONS
BEGIN PERIOD 1
{rch_lines}
END PERIOD
""")
    if wel:
        write(ws, "m.wel", """
BEGIN OPTIONS
  AUTO_FLOW_REDUCE 0.2
END OPTIONS
BEGIN DIMENSIONS
  MAXBOUND 1
END DIMENSIONS
BEGIN PERIOD 1
  1 2 2 -5.0
END PERIOD
""")


def test_newton01_analytic(tmp_path, capsys):
    """The newton01 deck through the port's command-line entry on the CPU
    and through its loader: H(layer 1) = 8, H(layer 2) = 7, as the
    reference program's test asserts, and the reference's heads."""
    ws = str(tmp_path)
    build_newton01(ws)
    assert cli_main([ws, "--device", "cpu", "--lst",
                     str(tmp_path / "run.lst")]) == 0
    assert "Normal termination of simulation" in capsys.readouterr().out
    assert "CALLS TO NUMERICAL SOLUTION" in (tmp_path / "run.lst").read_text()
    sim = load_simulation(ws, device="cpu")
    assert sim.model.inewton == 1 and sim.model.inewtonur == 0
    recs = sim.run()
    assert all(r.converged for r in recs)
    h = recs[-1].head.reshape(2, 3, 3)
    np.testing.assert_allclose(h[1], 7.0, atol=1e-6)
    np.testing.assert_allclose(h[0], 8.0, atol=1e-6)
    want = ref_load(ws).run()
    assert want[-1].converged
    np.testing.assert_allclose(recs[-1].head, want[-1].head, rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("case", ["under-relaxation", "flow-reduce", "rewet"])
def test_loader_reads_the_nonlinear_options(case, tmp_path):
    """NEWTON UNDER_RELAXATION, WEL AUTO_FLOW_REDUCE and NPF REWET with
    WETDRY load as in the reference, and the deck runs to the reference's
    heads."""
    ws = str(tmp_path)
    rewet = """BEGIN OPTIONS
  REWET WETFCT 0.9 IWETIT 2 IHDWET 1
END OPTIONS"""
    build_newton01(
        ws, newton={"under-relaxation": "NEWTON UNDER_RELAXATION",
                    "flow-reduce": "NEWTON", "rewet": ""}[case],
        extra_npf=rewet if case == "rewet" else "", wel=case == "flow-reduce")
    if case == "rewet":
        npf = (tmp_path / "m.npf").read_text().replace(
            "END GRIDDATA", "  WETDRY LAYERED\n    CONSTANT 0.5\n"
            "    CONSTANT 0.0\nEND GRIDDATA")
        (tmp_path / "m.npf").write_text(npf)
    ref, port = ref_load(ws), load_simulation(ws, device="cpu")
    assert model_options(port.model) == model_options(ref.model)
    expected = {
        "under-relaxation": dict(inewton=1, inewtonur=1),
        "flow-reduce": dict(inewton=1, wel_iflowred=1, wel_flowred=0.2),
        "rewet": dict(inewton=0, rewet_opts=(0.9, 2, 1))}[case]
    assert expected.items() <= model_options(port.model).items()
    if case == "rewet":
        np.testing.assert_array_equal(port.model.wetdry.numpy(),
                                      np.asarray(ref.model.wetdry))
        assert port.model.wetdry.numpy()[:9].tolist() == [0.5] * 9
    else:
        assert port.model.wetdry is None and ref.model.wetdry is None
    want, got = ref.run(), port.run()
    assert got[-1].converged and want[-1].converged
    np.testing.assert_allclose(got[-1].head, want[-1].head, rtol=0,
                               atol=1e-7)


# ------------------------------------------- what still names its absence

def test_remaining_gaps_name_what_is_missing(tmp_path):
    """The XT3D deck option (which the reference's loader reads past), XT3D
    Newton with barriers, barriers in a deck, and rewetting in the fused
    step raise and say what is missing.  XT3D Newton itself is ported
    (tests/test_torch_xt3d.py), and so is the Newton under-relaxation of
    an augmented model, on its grid rows: the NUR scenario with a MAW well
    that exchanges nothing solves to the plain scenario's heads."""
    from modflow6_torch.models.discretization import DisGrid
    from modflow6_torch.models.gwf.builder import build_gwf
    grid = DisGrid.create(**_row(5, 1.0, 2.0))
    assert build_gwf("x", grid, newton=True, xt3d=1, icelltype=1,
                     device="cpu").xt3d is not None
    with pytest.raises(NotImplementedError, match="HFB with XT3D"):
        build_gwf("x", grid, newton=True, xt3d=1, icelltype=1,
                  hfb=[(0, 1, 1e-3)], device="cpu")
    ws = str(tmp_path)
    build_newton01(ws, extra_npf="BEGIN OPTIONS\n  XT3D\nEND OPTIONS")
    with pytest.raises(NotImplementedError, match="XT3D"):
        load_simulation(ws, device="cpu")
    nam = (tmp_path / "m.nam").read_text()
    (tmp_path / "m.nam").write_text(nam.replace(
        "END PACKAGES", "  HFB6 m.hfb\nEND PACKAGES"))
    assert "HFB6" in (tmp_path / "m.nam").read_text()
    with pytest.raises(NotImplementedError, match="HFB6"):
        load_simulation(ws, device="cpu")

    from modflow6_torch.models.gwf.advanced import (AugmentedGwfModel,
                                                    build_maw)
    args, s = _nur_scenario()
    port = build_both(args)[1]
    plain, info, _ = NumericalSolution(port, ImsSettings(**s)) \
        .solve_timestep(port.strt, 1.0, iss=True)
    aug = AugmentedGwfModel(port, maw=build_maw(
        [dict(radius=0.1, strt=5.0, connections=[(3, 0.0)])], port.grid))
    head, ainfo, _ = NumericalSolution(aug, ImsSettings(**s)) \
        .solve_timestep(aug.strt, 1.0, iss=True)
    assert info.converged and ainfo.converged
    np.testing.assert_allclose(head[:port.nodes].numpy(), plain.numpy(),
                               rtol=0, atol=10 * s["outer_dvclose"])

    args, s = _rewet_scenario()
    port = build_both(args)[1]
    with pytest.raises(NotImplementedError, match="rewetting"):
        make_fused_step(port, ImsSettings(**{**s, "under_relaxation":
                                             "none"}), iss=True)
