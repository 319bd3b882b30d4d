"""GNC, BUY, VSC, CSUB (with delay interbeds) and TVK/TVS of the port
against the reference.

Tolerances:

- assembled systems, per-edge flows, CSUB's state advance: 1e-12 of the
  largest entry (the same float64 terms, summed in another order);
- GNC: the linear field through a refinement interface to 5e-9, the plain
  two-point error above 1e-3 (tests/test_gnc.py);
- BUY: the static density equilibrium to 1e-9, no concentration equal to
  the freshwater run to 1e-9; VSC: heads and flows of the K/2 model to 1e-9
  (tests/test_buy.py); BUY on the structured planes against the
  reference's edge form: 1e-12;
- CSUB (tests/test_csub.py): elastic compaction rtol 1e-6, the inelastic
  switch rtol 1e-4, budget discrepancy below 1e-3 %, Terzaghi's curve to
  0.03 (0.01 at the end), the delay-bed ratchet rtol 0.02 / 0.05; a CSUB6
  deck with a delay bed: budget below 0.01 % (tests/test_advanced_decks.py:
  284); CG runs: equal counts and heads within 1e-10 of the reference;
- TVK/TVS (tests/test_gwf_transient.py:168-211): the doubled gradient
  rtol 1e-8, the faster storage response; heads within 1e-10 of the
  reference with equal counts;
- ``convert.from_reference`` of each package: the port's own system to
  rounding (1e-13).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_regression_decks import write
from test_torch_parity import csub_arrays, model_options
from test_torch_unstructured import both_grids
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.discretization.disu import DisuGrid as JaxDisuGrid
from modflow6_tpu.models.gwf import csub as jcsub
from modflow6_tpu.models.gwf import gnc as jgnc
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.gwf.builder import chd_data as jax_chd_data
from modflow6_tpu.models.gwf.model import PackageData as JaxPackageData
from modflow6_tpu.models.simulation import Simulation as JaxSimulation
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxSolution
from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
from modflow6_tpu.timing.tdis import Tdis as JaxTdis
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.convert import from_reference
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.discretization.disu import DisuGrid
from modflow6_torch.models.gwf import buy as buy_mod
from modflow6_torch.models.gwf import csub
from modflow6_torch.models.gwf.builder import build_gwf, chd_data
from modflow6_torch.models.gwf.gnc import build_gnc
from modflow6_torch.models.gwf.model import PackageData
from modflow6_torch.models.gwt.builder import build_gwt
from modflow6_torch.models.simulation import Simulation
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.ims import NumericalSolution
from modflow6_torch.timing.tdis import StressPeriod, Tdis
from modflow6_torch.utils.mf6io import load_simulation

# tests/test_buy.py:26-29, tests/test_csub.py:24-27, tests/test_gnc.py:87-89
TIGHT = dict(outer_dvclose=1e-10, outer_maximum=200, inner_dvclose=1e-12,
             inner_rclose=1e-11, inner_maximum=2000)


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def both_dis(grid, **kw):
    return (jax_build_gwf("ref", JaxDisGrid.create(**grid), **kw),
            build_gwf("port", DisGrid.create(**grid), device="cpu", **kw))


def systems(ref, port, head, pj=None, pt=None, delt=1.0, iss=False,
            head_old=None):
    """Both packages' (diag, off, rhs) at ``head`` (CHD applied)."""
    head_old = head if head_old is None else head_old
    ibj, hj = ref.boundary_state(jnp.asarray(head), pj)
    ibt, ht = port.boundary_state(torch.tensor(head), pt)
    return (port.assemble(ht, torch.tensor(head_old), ibt, delt, iss, pt),
            ref.assemble(hj, jnp.asarray(head_old), ibj, delt, iss, pj))


def assert_same_system(ref, port, head, **kw):
    got, want = systems(ref, port, head, **kw)
    for g, w, name in zip(got, want, ("diag", "off", "rhs")):
        assert g.shape == np.asarray(w).shape, name
        close(g, w)


def solve(model, settings, pkgs=None, reference=False, iss=True, delt=1.0):
    if reference:
        h, info, _ = JaxSolution(model, JaxImsSettings(**settings)) \
            .solve_timestep(model.strt, delt, iss=iss, pkgs=pkgs)
        return np.asarray(h), info
    h, info, _ = NumericalSolution(model, ImsSettings(**settings)) \
        .solve_timestep(model.strt, delt, iss=iss, pkgs=pkgs)
    return h.numpy(), info


# ------------------------------------------------------------------- GNC

def lgr_grid_args():
    """tests/test_gnc.py:21-71: 3 coarse 2x2 cells beside 6x3 fine 1x1
    cells, one layer, as DISU arrays; plus the cell centers and the
    interface connections."""
    centers = [(1.0, 2.0 * i + 1.0, 4.0) for i in range(3)]
    centers += [(2.5 + c, r + 0.5, 1.0) for r in range(6) for c in range(3)]

    def fid(r, c):
        return 3 + r * 3 + c

    edges = [(i, i + 1, 1, 1.0, 1.0, 2.0) for i in range(2)]
    for r in range(6):
        for c in range(3):
            if c + 1 < 3:
                edges.append((fid(r, c), fid(r, c + 1), 1, 0.5, 0.5, 1.0))
            if r + 1 < 6:
                edges.append((fid(r, c), fid(r + 1, c), 1, 0.5, 0.5, 1.0))
    iface = []
    for i in range(3):
        for dr in (0, 1):
            f = fid(2 * i + dr, 0)
            edges.append((i, f, 1, 1.0, 0.5, 1.0))
            iface.append((i, f, dr))
    N = len(centers)
    adj = [[] for _ in range(N)]
    for n, m, ihc, c1, c2, hw in edges:
        adj[n].append((m, ihc, c1, hw))
        adj[m].append((n, ihc, c2, hw))
    iac, ja, ihc_l, cl12, hwva = [], [], [], [], []
    for n in range(N):
        iac.append(1 + len(adj[n]))
        ja.append(n)
        ihc_l.append(0)
        cl12.append(0.0)
        hwva.append(0.0)
        for m, ih, cl, hw in adj[n]:
            ja.append(m)
            ihc_l.append(ih)
            cl12.append(cl)
            hwva.append(hw)
    grid = dict(top=np.ones(N), bot=np.zeros(N),
                area=np.asarray([c[2] for c in centers]), iac=iac, ja=ja,
                ihc=ihc_l, cl12=cl12, hwva=hwva)
    return grid, centers, iface


def gnc_entries(iface):
    """The ghost node at each fine cell's y: weight 0.25 toward the coarse
    neighbour above or below (tests/test_gnc.py:101-105)."""
    entries = []
    for i, f, dr in iface:
        j = i - 1 if dr == 0 else i + 1
        entries.append((i, f, [(j, 0.25)] if 0 <= j < 3 else [(i, 0.0)]))
    return entries


def gnc_models(with_gnc):
    grid, centers, iface = lgr_grid_args()
    field = np.asarray([x + 0.5 * y for x, y, _ in centers])
    free = {3 + 2 * 3 + 0, 3 + 3 * 3 + 0, 3 + 2 * 3 + 1, 3 + 3 * 3 + 1}
    kw = dict(k=1.0, strt=float(field.mean()),
              chd=[(n, float(field[n])) for n in range(len(centers))
                   if n not in free])
    ref = jax_build_gwf("lgr", JaxDisuGrid.create(**grid), **kw)
    port = build_gwf("lgr", DisuGrid.create(**grid), device="cpu", **kw)
    if with_gnc:
        ref.gnc = jgnc.build_gnc(ref.topo, gnc_entries(iface))
        port.gnc = build_gnc(port.topo, gnc_entries(iface), device="cpu")
    return ref, port, field, sorted(free)


def test_gnc_lgr_matches_linear_field():
    """tests/test_gnc.py:97-110: with GNC the composite grid gives the
    linear field to 5e-9, without it the interface error exceeds 1e-3; the
    port's heads equal the reference's within 5e-9."""
    settings = dict(TIGHT, outer_maximum=100, inner_maximum=500,
                    linear_acceleration="bicgstab")
    err = {}
    for with_gnc in (True, False):
        ref, port, field, free = gnc_models(with_gnc)
        h, info = solve(port, settings)
        assert info.converged
        err[with_gnc] = np.abs(h - field)[free].max()
        if with_gnc:
            want, info = solve(ref, settings, reference=True)
            assert info.converged
            np.testing.assert_allclose(h, want, atol=5e-9)
    assert err[False] > 1e-3
    assert err[True] < 5e-9 and err[True] < err[False] / 1e4


def test_gnc_system_and_flows_match_reference():
    """The explicit GNC terms in the rhs and the flowja correction at a
    random head: two entries share each coarse cell's row, so their sums go
    through the plan's rounds."""
    ref, port, _, _ = gnc_models(True)
    assert len(port.gnc.rhs_plan.rounds) > 1
    head = np.random.default_rng(4).uniform(0.0, 8.0, port.nodes)
    assert_same_system(ref, port, head)
    ibj, _ = ref.boundary_state(jnp.asarray(head))
    ibt, _ = port.boundary_state(torch.tensor(head))
    close(port.edge_flows(torch.tensor(head), ibt),
          ref.edge_flows(jnp.asarray(head), ibj))
    assert not port.is_linear


def test_gnc_outside_the_general_path_raises():
    """The reference's assembly adds GNC on the general two-point path
    only; the port raises where it would skip it, and for cells that are
    not connected."""
    grid = dict(nlay=1, nrow=3, ncol=4, delr=1.0, delc=1.0, top=1.0,
                botm=np.zeros((1, 3, 4)))
    port = build_gwf("s", DisGrid.create(**grid), k=1.0, strt=0.5,
                     chd=[(0, 1.0)], device="cpu")
    port.gnc = build_gnc(port.topo, [(0, 1, [(4, 0.25)])], device="cpu")
    ib, h = port.boundary_state(port.strt)
    with pytest.raises(NotImplementedError, match="GNC"):
        port.assemble(h, h, ib, 1.0, True)
    with pytest.raises(ValueError, match="not connected"):
        build_gnc(port.topo, [(0, 5, [(4, 0.25)])], device="cpu")


def test_convert_carries_gnc():
    ref, port, _, _ = gnc_models(True)
    arrays, kw = reference_general_state(ref)
    arrays.update({f"gnc_{f.name}": np.asarray(getattr(ref.gnc, f.name))
                   for f in dataclasses.fields(ref.gnc)})
    conv = from_reference(arrays, device="cpu", grid=port.grid, **kw)
    assert_same_port_system(conv, port)


# ------------------------------------------------------------ BUY and VSC

@pytest.mark.parametrize("iform", [1, 2])
def test_static_density_equilibrium(iform):
    """tests/test_buy.py:32-60: salt below fresh water, the bottom head at
    the closed-form equilibrium (1e-9), port and reference."""
    denseref, drhodc, conc_bot = 1000.0, 0.7, 35.0
    grid = dict(nlay=2, nrow=1, ncol=1, delr=10.0, delc=10.0, top=20.0,
                botm=np.array([10.0, 0.0])[:, None, None] * np.ones((2, 1, 1)))
    ref, port = both_dis(grid, k=1.0, strt=0.0, chd=[(0, 0.0)],
                         buy=dict(denseref=denseref, drhodc=drhodc,
                                  crhoref=0.0, iform=iform))
    assert port.use_structured and not port.is_linear
    conc = np.asarray([0.0, conc_bot])
    settings = dict(TIGHT, linear_acceleration="bicgstab")
    head, info = solve(port, settings, dataclasses.replace(
        port.packages, buy_conc=torch.tensor(conc)))
    want, winfo = solve(ref, settings, dataclasses.replace(
        ref.packages, buy_conc=jnp.asarray(conc)), reference=True)
    assert info.converged and winfo.converged
    rho_m = (denseref + drhodc * conc_bot) / denseref
    wt = 0.5
    rhoterm = wt + (1 - wt) * rho_m
    drho = rho_m - 1.0
    hm = -drho * (-10.0) / (rhoterm + drho * wt)
    np.testing.assert_allclose(head[1], hm, atol=1e-9)
    np.testing.assert_allclose(head, want, atol=1e-9)


def test_buy_deactivates_without_conc():
    """tests/test_buy.py:63-76: without a concentration BUY adds nothing."""
    grid = dict(nlay=1, nrow=1, ncol=5, delr=10.0, delc=10.0, top=10.0,
                botm=np.zeros((1, 1, 5)))
    kw = dict(k=2.0, strt=5.0, chd=[(0, 6.0), (4, 4.0)])
    plain = build_gwf("p", DisGrid.create(**grid), device="cpu", **kw)
    withbuy = build_gwf("b", DisGrid.create(**grid), device="cpu",
                        buy=dict(denseref=1000.0, drhodc=0.7), **kw)
    h1, i1 = solve(plain, dict(TIGHT, linear_acceleration="cg"))
    h2, i2 = solve(withbuy, dict(TIGHT, linear_acceleration="bicgstab"))
    assert i1.converged and i2.converged
    np.testing.assert_allclose(h2, h1, atol=1e-9)


def buy_case(iform, vsc=False, general=False):
    """A two-layer unconfined model with a hole, CHD, a seawater wedge of
    concentration and a random head: BUY (and VSC) on the planes of the
    structured path, or over the edge list of a DISV grid."""
    rng = np.random.default_rng(iform + 10 * vsc)
    kw = dict(icelltype=1, strt=8.0, chd=[(0, 9.0), (3, 9.5)],
              buy=dict(denseref=1000.0, drhodc=[0.7], crhoref=[2.0],
                       iform=iform))
    if vsc:
        kw["vsc"] = dict(viscref=1.0, dviscdc=0.02, cviscref=0.0)
    if general:
        ref_grid, port_grid = both_grids("brick")
        n = port_grid.nodes
        kw["k"] = np.exp(rng.normal(0, 0.5, n))
        ref = jax_build_gwf("ref", ref_grid, **kw)
        port = build_gwf("port", port_grid, device="cpu", **kw)
    else:
        grid = dict(nlay=2, nrow=5, ncol=6, delr=np.linspace(8, 12, 6),
                    delc=np.linspace(9, 11, 5), top=10.0,
                    botm=np.stack([np.full((5, 6), 6.0), np.zeros((5, 6))]),
                    idomain=np.ones((2, 5, 6), np.int32))
        grid["idomain"][0, 2, 2] = 0
        n = 60
        kw["k"] = np.exp(rng.normal(0, 0.5, n))
        ref, port = both_dis(grid, **kw)
    conc = np.clip(35.0 * np.linspace(-0.3, 1.2, n), 0.0, 35.0)
    head = rng.uniform(5.0, 11.0, n)
    pj = dataclasses.replace(ref.packages, buy_conc=jnp.asarray(conc))
    pt = dataclasses.replace(port.packages, buy_conc=torch.tensor(conc))
    return ref, port, head, pj, pt


@pytest.mark.parametrize("iform", [0, 1, 2])
def test_buy_on_planes_matches_reference_edge_form(iform):
    """BUY on the structured planes of the port against the reference's
    edge form (buy.py:63-125): the system and the corrected flows."""
    ref, port, head, pj, pt = buy_case(iform)
    assert port.use_structured and not ref.use_structured is False
    assert_same_system(ref, port, head, pj=pj, pt=pt)
    ibj, hj = ref.boundary_state(jnp.asarray(head), pj)
    ibt, ht = port.boundary_state(torch.tensor(head), pt)
    close(port.edge_flows(ht, ibt, pkgs=pt), ref.edge_flows(hj, ibj, pkgs=pj))


@pytest.mark.parametrize("iform,vsc", [(2, False), (1, True), (2, True)])
def test_buy_and_vsc_on_the_edge_list_match_reference(iform, vsc):
    """BUY over the edge list of a DISV grid, with and without VSC (whose
    K scaling rebuilds condsat at every assembly): system and flows."""
    ref, port, head, pj, pt = buy_case(iform, vsc=vsc, general=True)
    assert not port.use_structured
    assert_same_system(ref, port, head, pj=pj, pt=pt)
    ibj, hj = ref.boundary_state(jnp.asarray(head), pj)
    ibt, ht = port.boundary_state(torch.tensor(head), pt)
    close(port.edge_flows(ht, ibt, pkgs=pt), ref.edge_flows(hj, ibj, pkgs=pj))


def test_vsc_scales_conductance():
    """tests/test_buy.py:125-147: visc(c) = 2·viscref halves K, the heads
    and flows equal the K/2 model's (1e-9); VSC leaves the structured path
    but keeps the grid shape, so its products go through the stencil."""
    grid = dict(nlay=1, nrow=1, ncol=6, delr=10.0, delc=10.0, top=10.0,
                botm=np.zeros((1, 1, 6)))
    kw = dict(strt=5.0, chd=[(0, 6.0), (5, 4.0)])
    base = build_gwf("vref", DisGrid.create(**grid), k=1.0, device="cpu",
                     **kw)
    model = build_gwf("v", DisGrid.create(**grid), k=2.0, device="cpu",
                      vsc=dict(viscref=1.0, dviscdc=0.1, cviscref=0.0), **kw)
    assert not model.use_structured and model.dtopo.grid_shape == (1, 1, 6)
    pkgs = dataclasses.replace(model.packages,
                               buy_conc=torch.full((6,), 10.0,
                                                   dtype=torch.float64))
    h1, i1, a1 = NumericalSolution(base, ImsSettings(
        **TIGHT, linear_acceleration="cg")).solve_timestep(base.strt, 1.0,
                                                           iss=True)
    h2, i2, a2 = NumericalSolution(model, ImsSettings(
        **TIGHT, linear_acceleration="bicgstab")).solve_timestep(
            model.strt, 1.0, iss=True, pkgs=pkgs)
    assert i1.converged and i2.converged
    np.testing.assert_allclose(h2.numpy(), h1.numpy(), atol=1e-9)
    q1 = base.edge_flows(h1, a1["ibound"]).numpy()
    q2 = model.edge_flows(h2, a2["ibound"], pkgs=pkgs).numpy()
    np.testing.assert_allclose(q2, q1, atol=1e-9)
    with pytest.raises(NotImplementedError, match="HFB"):
        build_gwf("h", DisGrid.create(**grid), device="cpu",
                  vsc=dict(viscref=1.0), hfb=[(0, 1, 1e-3)])


def test_buy_and_vsc_simulation_matches_reference():
    """BUY and VSC with a concentration set through ``period_data`` (the
    reference's Simulation reads ``buy_conc`` from it when no transport
    model runs) over two transient steps: heads, and the budget closed and
    equal to the reference's."""
    _, _, _, pj, pt = buy_case(2, vsc=True)
    grid = dict(nlay=2, nrow=5, ncol=6, delr=10.0, delc=10.0, top=10.0,
                botm=np.stack([np.full((5, 6), 6.0), np.zeros((5, 6))]))
    kw = dict(k=5.0, strt=9.0, chd=[(i * 6, 9.0) for i in range(5)],
              wel=[(40, -2.0)], storage={"ss": 1e-4, "iconvert": 0},
              buy=dict(denseref=1000.0, drhodc=0.7, crhoref=0.0),
              vsc=dict(viscref=1.0, dviscdc=0.02))
    ref, port = both_dis(grid, **kw)
    settings = dict(TIGHT, linear_acceleration="bicgstab")
    jsim = JaxSimulation(JaxTdis((JaxPeriod(2.0, 2, 1.0),)), ref,
                         JaxImsSettings(**settings))
    sim = Simulation(Tdis((StressPeriod(2.0, 2, 1.0),)), port,
                     ImsSettings(**settings))
    jsim.period_data[1] = dataclasses.replace(ref.packages,
                                              buy_conc=pj.buy_conc)
    sim.period_data[1] = dataclasses.replace(port.packages,
                                             buy_conc=pt.buy_conc)
    recs = sim.run()
    for a, b in zip(recs, jsim.run()):
        assert a.converged and b.converged
        np.testing.assert_allclose(a.head, b.head, atol=1e-8)
    assert abs(sim.budget.percent_discrepancy()) < 1e-6
    for name, term in jsim.budget.terms.items():
        np.testing.assert_allclose(
            [sim.budget.terms[name].rate_in, sim.budget.terms[name].rate_out],
            [term.rate_in, term.rate_out], rtol=1e-7, atol=1e-9)
    # a transport model in its place: its concentration reaches BUY and
    # VSC through buy_conc, so the first step (at the transport's initial
    # concentration, the same field) has the same heads, bit for bit
    gwt = build_gwt("t", DisGrid.create(**grid), porosity=0.3,
                    strt=pt.buy_conc.numpy(), device="cpu")
    gsim = Simulation(Tdis((StressPeriod(2.0, 2, 1.0),)), port,
                      ImsSettings(**settings), gwt=gwt,
                      gwt_settings=ImsSettings(**settings))
    grecs = gsim.run()
    assert all(r.converged and r.transport_converged for r in grecs)
    np.testing.assert_array_equal(grecs[0].head, recs[0].head)
    assert not np.array_equal(gsim.conc_records[0], pt.buy_conc.numpy())


def test_buy_uniform_crhoref_equals_plain_run_bitwise():
    """A uniform concentration equal to crhoref makes every BUY term zero:
    the heads equal the freshwater model's bit for bit."""
    grid = dict(nlay=2, nrow=4, ncol=5, delr=10.0, delc=10.0, top=10.0,
                botm=np.stack([np.full((4, 5), 6.0), np.zeros((4, 5))]))
    kw = dict(k=3.0, strt=9.0, chd=[(0, 9.0), (19, 8.0)], wel=[(27, -1.0)])
    plain = build_gwf("p", DisGrid.create(**grid), device="cpu", **kw)
    salt = build_gwf("s", DisGrid.create(**grid), device="cpu",
                     buy=dict(crhoref=35.0), **kw)
    pkgs = dataclasses.replace(salt.packages, buy_conc=torch.full(
        (40,), 35.0, dtype=torch.float64))
    settings = dict(TIGHT, linear_acceleration="bicgstab")
    h1, _ = solve(plain, settings)
    h2, _ = solve(salt, settings, pkgs)
    assert np.array_equal(h1, h2)


def test_convert_carries_buy_and_vsc():
    ref, port, head, pj, pt = buy_case(2, vsc=True, general=True)
    arrays, kw = reference_general_state(ref)
    conv = from_reference(arrays, device="cpu", grid=port.grid, **kw)
    assert conv.buy == port.buy and conv.vsc == port.vsc
    assert_same_port_system(conv, port, pt)


# ------------------------------------------------------------------ CSUB

CSUB_GRID = dict(nlay=3, nrow=3, ncol=4, delr=10.0, delc=10.0, top=30.0,
                 botm=np.array([20.0, 10.0, 0.0])[:, None, None]
                 * np.ones((3, 3, 4)))


def csub_case(head_based=False):
    """Effective-stress CSUB on three layers: coarse storage everywhere,
    two no-delay interbeds in one cell (their sums share a row), one in
    another, and two delay interbeds."""
    csub_kw = dict(
        sgm=1.7, sgs=2.0, cg_ske_cr=1e-5, cg_theta=0.2, head_based=head_based,
        interbeds=[(17, 3.0, 1e-4, 1e-2, 0.3), (17, 2.0, 2e-4, 2e-2, 0.3),
                   (30, 2.0, 1e-4, 1e-4, 0.3)],
        pcs_offset=0.5, ndelaycells=7,
        delay_interbeds=[dict(node=21, thick=4.0, kv=0.01, sske_cr=1e-4,
                              ssv_cc=1e-3, theta=0.3),
                         dict(node=21, thick=2.0, kv=0.02, sske_cr=1e-4,
                              ssv_cc=1e-4, theta=0.3, rnb=2.0)])
    return both_dis(CSUB_GRID, k=5.0, strt=25.0, icelltype=1,
                    storage={"ss": 1e-5, "sy": 0.1, "iconvert": 1},
                    chd=[(0, 25.0)], wel=[(23, -3.0)], csub=csub_kw)


def test_csub_system_and_state_advance_match_reference():
    """assemble_csub (coarse, no-delay and delay beds) and advance_state
    (es0, pcs, compactions, the delay columns' heads and stresses) at a
    drawn-down head."""
    ref, port = csub_case()
    head = 25.0 - np.random.default_rng(5).uniform(0.0, 4.0, port.nodes)
    pj = dataclasses.replace(ref.packages, csub_state=ref.csub_state0)
    pt = dataclasses.replace(port.packages, csub_state=port.csub_state0)
    assert_same_system(ref, port, head, pj=pj, pt=pt, delt=2.0,
                       head_old=np.full(port.nodes, 25.0))
    a, ja = port.npf_arrays, ref.npf_arrays
    ib = torch.ones(port.nodes, dtype=torch.int32)
    got = csub.advance_state(port.csub, port.csub_state0, a.top, a.bot,
                             port.area, a.icelltype, torch.tensor(head),
                             port.strt, ib, 2.0)
    want = jcsub.advance_state(ref.csub, ref.csub_state0, ja.top, ja.bot,
                               jnp.asarray(ref.grid.area), ja.icelltype,
                               jnp.asarray(head), jnp.asarray(ref.strt),
                               jnp.ones(port.nodes, jnp.int32), 2.0)
    for name in ("es0", "pcs", "comp", "cg_comp", "db_comp"):
        close(getattr(got, name), getattr(want, name))
    for name in ("h0", "es0", "pcs"):
        close(getattr(got.db, name), getattr(want.db, name))
    assert float(got.comp.sum()) > 0 and float(got.db_comp.abs().min()) > 0


def test_csub_stress_fields_match_reference():
    """tests/test_csub.py:104-125: geostatic stress grows down the column
    and falls with head, equal to the reference's calc_stress."""
    ref, port = csub_case()
    ib = torch.ones(port.nodes, dtype=torch.int32)
    for h in (25.0, 28.0):
        got = csub.calc_stress(port.csub, port.npf_arrays.top,
                               port.npf_arrays.bot,
                               torch.full((port.nodes,), h, dtype=torch.float64),
                               ib)
        want = jcsub.calc_stress(ref.csub, ref.npf_arrays.top,
                                 ref.npf_arrays.bot, jnp.full(port.nodes, h),
                                 jnp.ones(port.nodes, jnp.int32))
        for g, w in zip(got, want):
            close(g, w)
    gs = got[0].reshape(3, 12)
    assert bool((gs[2] > gs[1]).all() and (gs[1] > gs[0]).all())


def drawdown_sims(dh, nper, sske=1e-4, ssv=1e-2, thick=5.0, pcs_offset=0.0,
                  h0=50.0):
    """tests/test_csub.py:30-48 in both packages: a 1x1x2 confined model,
    cell 0 held by CHD and drawn down dh per period, one head-based no-delay
    interbed in cell 1."""
    grid = dict(nlay=1, nrow=1, ncol=2, delr=10.0, delc=10.0, top=20.0,
                botm=np.zeros((1, 1, 2)))
    kw = dict(k=1e4, strt=h0, storage={"ss": 0.0, "iconvert": 0},
              chd=[(0, h0)],
              csub=dict(sgm=1.7, sgs=2.0, cg_ske_cr=0.0, cg_theta=0.2,
                        interbeds=[(1, thick, sske, ssv, 0.3)],
                        head_based=True, pcs_offset=pcs_offset))
    ref, port = both_dis(grid, **kw)
    periods = [(1.0, 1, 1.0)] * nper
    jsim = JaxSimulation(JaxTdis(tuple(JaxPeriod(*p) for p in periods)), ref,
                         JaxImsSettings(**TIGHT))
    sim = Simulation(Tdis(tuple(StressPeriod(*p) for p in periods)), port,
                     ImsSettings(**TIGHT))
    for kp in range(2, nper + 1):
        jsim.period_data[kp] = JaxPackageData(
            chd=jax_chd_data([(0, h0 - dh * (kp - 1))]))
        sim.period_data[kp] = PackageData(
            chd=chd_data([(0, h0 - dh * (kp - 1))], device="cpu"))
    return jsim, sim


def test_elastic_compaction_headbased():
    """tests/test_csub.py:51-60: compaction = Sske·b·Δh (rtol 1e-6); every
    step's heads and counts equal the reference's (CG)."""
    jsim, sim = drawdown_sims(2.0, 4, pcs_offset=1e6)
    recs, jrecs = sim.run(), jsim.run()
    for a, b in zip(recs, jrecs):
        assert a.converged and (a.outer, a.inner) == (b.outer, b.inner)
        np.testing.assert_allclose(a.head, b.head, atol=1e-10)
    np.testing.assert_allclose(recs[-1].head[1], 44.0, atol=1e-6)
    np.testing.assert_allclose(float(sim.csub_state.comp[0]),
                               1e-4 * 5.0 * 6.0, rtol=1e-6)


def test_inelastic_switch_headbased():
    """tests/test_csub.py:63-82: elastic until the preconsolidation stress,
    virgin after (rtol 1e-4); pcs advances to the largest stress."""
    jsim, sim = drawdown_sims(2.0, 5, pcs_offset=3.0)
    recs = sim.run()
    assert all(r.converged for r in recs)
    expected = 1e-4 * 5.0 * 3.0 + 1e-2 * 5.0 * 5.0
    np.testing.assert_allclose(float(sim.csub_state.comp[0]), expected,
                               rtol=1e-4)
    np.testing.assert_allclose(float(sim.csub_state.pcs[0]),
                               float(sim.csub_state.es0[1]), rtol=1e-12)


def test_csub_budget_closes():
    """tests/test_csub.py:85-101: transient pumping with CSUB release in a
    cell with two interbeds, budget discrepancy below 1e-3 %; the CSUB
    budget term and the compaction equal the reference's."""
    grid = dict(nlay=1, nrow=3, ncol=5, delr=10.0, delc=10.0, top=20.0,
                botm=np.zeros((1, 3, 5)))
    kw = dict(k=5.0, strt=30.0, storage={"ss": 1e-5, "iconvert": 0},
              chd=[(i * 5, 30.0) for i in range(3)], wel=[(7, -5.0)],
              csub=dict(sgm=1.7, sgs=2.0, cg_ske_cr=1e-5, cg_theta=0.2,
                        interbeds=[(7, 3.0, 1e-4, 1e-2, 0.3),
                                   (7, 2.0, 1e-4, 1e-2, 0.3),
                                   (8, 2.0, 1e-4, 1e-2, 0.3)],
                        head_based=True, pcs_offset=0.5))
    ref, port = both_dis(grid, **kw)
    sim = Simulation(Tdis((StressPeriod(10.0, 5, 1.2),)), port,
                     ImsSettings(**TIGHT))
    jsim = JaxSimulation(JaxTdis((JaxPeriod(10.0, 5, 1.2),)), ref,
                         JaxImsSettings(**TIGHT))
    for a, b in zip(sim.run(), jsim.run()):
        assert a.converged and (a.outer, a.inner) == (b.outer, b.inner)
        np.testing.assert_allclose(a.head, b.head, atol=1e-10)
    assert abs(sim.budget.percent_discrepancy()) < 1e-3
    t, w = sim.budget.terms["CSUB"], jsim.budget.terms["CSUB"]
    np.testing.assert_allclose([t.cum_in, t.cum_out], [w.cum_in, w.cum_out],
                               rtol=1e-9)
    close(sim.csub_state.comp, jsim.csub_state.comp, rtol=1e-9)
    assert float(sim.csub_state.comp.sum()) > 0


def delay_model(chd_head, h0=50.0, b=5.0, kv=0.01, sske=1e-3, ssv=1e-3,
                ncells=19):
    grid = DisGrid.create(1, 1, 2, 10.0, 10.0, 20.0, np.zeros((1, 1, 2)))
    return build_gwf(
        "d", grid, k=1e5, strt=h0, storage={"ss": 0.0, "iconvert": 0},
        chd=[(0, chd_head)], device="cpu",
        csub=dict(sgm=1.7, sgs=2.0, cg_ske_cr=0.0, cg_theta=0.2,
                  head_based=True, pcs_offset=0.0,
                  delay_interbeds=[dict(node=1, thick=b, kv=kv, sske_cr=sske,
                                        ssv_cc=ssv, theta=0.3)],
                  ndelaycells=ncells))


def delay_drive(model, nstep, delt, state=None, head=None):
    """tests/test_csub.py:128-152: march with the CSUB state advanced after
    each step; returns the delay-bed compaction after each step.  The
    inner residual closure is 1e-6, not tight()'s 1e-11: the rounding of
    this two-cell system (conductance 1e5) leaves a residual near 1e-9, so
    at 1e-11 CG runs to inner_maximum at every outer iteration; the bars
    of these tests (0.01 and more) do not depend on it."""
    sol = NumericalSolution(model, ImsSettings(**dict(TIGHT,
                                                      inner_rclose=1e-6)))
    state = model.csub_state0 if state is None else state
    head = model.strt if head is None else head
    a = model.npf_arrays
    hist = []
    for k in range(nstep):
        pkgs = dataclasses.replace(model.packages, csub_state=state)
        head_old = head
        head, info, _ = sol.solve_timestep(head, delt, kstp=k + 1, iss=False,
                                           pkgs=pkgs)
        assert info.converged
        ib, _ = model.boundary_state(head)
        state = csub.advance_state(model.csub, state, a.top, a.bot,
                                   model.area, a.icelltype, head, head_old,
                                   ib, delt)
        hist.append(float(state.db_comp[0]))
    return np.asarray(hist), state, head


def test_delay_interbed_terzaghi():
    """tests/test_csub.py:163-196: the delay column's consolidation curve
    against Terzaghi's series (0.03; 0.01 at the end, U > 0.9)."""
    h0, dh, b, kv, ss = 50.0, 2.0, 5.0, 0.01, 1e-3
    hist, _, _ = delay_drive(delay_model(h0 - dh), 120, 0.005)
    m = np.arange(50)
    M = np.pi * (2 * m + 1) / 2.0
    t = 0.005 * np.arange(1, 121)
    U = 1.0 - np.sum(2.0 / M**2 * np.exp(
        -M[None, :]**2 * (kv / ss * t / (b / 2.0)**2)[:, None]), axis=1)
    ratio = hist / (ss * b * dh)
    np.testing.assert_allclose(ratio[5:], U[5:], atol=0.03)
    np.testing.assert_allclose(ratio[-1], U[-1], atol=0.01)
    assert ratio[-1] > 0.9


def test_delay_interbed_inelastic_ratchet():
    """tests/test_csub.py:199-246: drawdown compacts at the virgin rate
    (rtol 0.02); full recovery rebounds only the elastic share (rtol
    0.05)."""
    h0, dh, b, kv, sske, ssv = 50.0, 3.0, 4.0, 0.02, 1e-4, 1e-2
    kw = dict(b=b, kv=kv, sske=sske, ssv=ssv)
    hist, state, head = delay_drive(delay_model(h0 - dh, **kw), 120, 0.04)
    np.testing.assert_allclose(hist[-1], ssv * b * dh, rtol=0.02)
    hist2, _, _ = delay_drive(delay_model(h0, **kw), 80, 0.02, state, head)
    np.testing.assert_allclose(hist[-1] - hist2[-1], sske * b * dh,
                               rtol=0.05)
    assert hist2[-1] > 0.9 * hist[-1]


def test_convert_carries_csub_and_its_state():
    ref, port = csub_case()
    arrays, kw = reference_general_state(ref, structured=True)
    arrays.update(csub_arrays(ref))
    conv = from_reference(arrays, device="cpu", grid=port.grid, **kw)
    pkgs = dataclasses.replace(port.packages, csub_state=port.csub_state0)
    cpk = dataclasses.replace(conv.packages, csub_state=conv.csub_state0)
    ib, h = port.boundary_state(port.strt - 2.0)
    for g, w in zip(conv.assemble(h, port.strt, ib, 1.0, False, cpk),
                    port.assemble(h, port.strt, ib, 1.0, False, pkgs)):
        close(g, w, rtol=1e-13)


CSUB_DECK = """BEGIN OPTIONS
  HEAD_BASED
END OPTIONS
BEGIN DIMENSIONS
  NINTERBEDS 2
END DIMENSIONS
BEGIN GRIDDATA
  CG_SKE_CR
    CONSTANT 0.0
  CG_THETA
    CONSTANT 0.2
  SGM
    CONSTANT 1.7
  SGS
    CONSTANT 2.0
END GRIDDATA
BEGIN PACKAGEDATA
  1 1 1 4 NODELAY 0.0 3.0 1.0 1.0e-2 1.0e-4 0.3 0.0 0.0
  2 1 1 5 DELAY 0.0 4.0 1.0 1.0e-3 1.0e-3 0.3 0.01 30.0
END PACKAGEDATA
"""


def test_csub_delay_deck(tmp_path):
    """tests/test_advanced_decks.py:284-327: a CSUB6 deck with a DELAY
    interbed loads as the reference loads it and runs with the budget
    below 0.01 %; heads and counts equal the reference's run."""
    from test_advanced_decks import _sim_files
    ws = str(tmp_path)
    _sim_files(ws, "  WEL6 model.wel wel-1\n  CSUB6 model.csub csub",
               nper=1, perlen="10.0 10 1.0")
    write(ws, "model.wel", "BEGIN DIMENSIONS\n  MAXBOUND 1\nEND DIMENSIONS\n"
          "BEGIN PERIOD 1\n  1 1 5 -20.0\nEND PERIOD\n")
    write(ws, "model.csub", CSUB_DECK)
    sim, jsim = load_simulation(ws, device="cpu"), ref_load(ws)
    assert sim.model.csub.delay.nbeds == 1
    assert sim.model.csub.ib_node.shape[0] == 1
    for key, value in csub_arrays(jsim.model).items():
        np.testing.assert_array_equal(csub_arrays(sim.model)[key], value,
                                      err_msg=key)
    assert model_options(sim.model) == model_options(jsim.model)
    for a, b in zip(sim.run(), jsim.run()):
        assert a.converged and b.converged
        assert a.outer == b.outer
        np.testing.assert_allclose(a.head, b.head, atol=1e-8)
    assert abs(sim.budget.percent_discrepancy()) < 0.01


# --------------------------------------------------------------- TVK/TVS

def test_tvk_changes_conductivity_between_periods():
    """tests/test_gwf_transient.py:168-188: halving K in period 2 doubles
    the head drop (rtol 1e-8); the structured model's planes are rebuilt,
    its heads equal the reference's with equal counts."""
    ncol = 9
    grid = dict(nlay=1, nrow=1, ncol=ncol, delr=10.0, delc=10.0, top=10.0,
                botm=np.zeros((1, 1, ncol)))
    ref, port = both_dis(grid, k=4.0, strt=5.0, chd=[(0, 8.0)],
                         wel=[(ncol - 1, -16.0)])
    s = dict(outer_dvclose=1e-9, inner_dvclose=1e-11, inner_rclose=1e-10,
             inner_maximum=500)
    changes = {2: [(j, "K", 2.0) for j in range(ncol)]}
    sim = Simulation(Tdis((StressPeriod(1.0, 1, 1.0),) * 2), port,
                     ImsSettings(**s), transient=[False, False])
    jsim = JaxSimulation(JaxTdis((JaxPeriod(1.0, 1, 1.0),) * 2), ref,
                         JaxImsSettings(**s), transient=[False, False])
    sim.tvk = jsim.tvk = changes
    recs, jrecs = sim.run(), jsim.run()
    for a, b in zip(recs, jrecs):
        assert a.converged and (a.outer, a.inner) == (b.outer, b.inner)
        np.testing.assert_allclose(a.head, b.head, atol=1e-10)
    h1, h2 = recs[0].head, recs[1].head
    np.testing.assert_allclose(h2[0] - h2[-1], 2 * (h1[0] - h1[-1]),
                               rtol=1e-8)
    assert port.use_structured
    np.testing.assert_allclose(port.condsat3[0].numpy(),
                               np.asarray(ref.condsat3[0]), rtol=1e-14)


def test_tvs_changes_storage_between_periods():
    """tests/test_gwf_transient.py:191-211: a smaller SS in period 2 speeds
    the transient response; the changed run equals the reference's."""
    ncol = 9
    grid = dict(nlay=1, nrow=1, ncol=ncol, delr=10.0, delc=10.0, top=10.0,
                botm=np.zeros((1, 1, ncol)))
    kw = dict(k=4.0, strt=5.0, storage={"ss": 1e-2, "iconvert": 0},
              chd=[(0, 8.0)])
    s = dict(outer_dvclose=1e-9, inner_dvclose=1e-11, inner_rclose=1e-10,
             inner_maximum=500)
    tdis = Tdis((StressPeriod(0.1, 1, 1.0), StressPeriod(0.1, 1, 1.0)))
    base = Simulation(tdis, build_gwf("b", DisGrid.create(**grid),
                                      device="cpu", **kw), ImsSettings(**s))
    recs0 = base.run()
    ref, port = both_dis(grid, **kw)
    sim = Simulation(tdis, port, ImsSettings(**s))
    jsim = JaxSimulation(JaxTdis((JaxPeriod(0.1, 1, 1.0),) * 2), ref,
                         JaxImsSettings(**s))
    sim.tvs = jsim.tvs = {2: [(j, "SS", 1e-5) for j in range(ncol)]}
    recs = sim.run()
    for a, b in zip(recs, jsim.run()):
        assert (a.outer, a.inner) == (b.outer, b.inner)
        np.testing.assert_allclose(a.head, b.head, atol=1e-10)
    assert recs[1].head[-1] > recs0[1].head[-1] + 0.1


def test_tv_deck_runs_as_the_reference(tmp_path):
    """A deck whose NPF and STO files name TVK6 and TVS6 subpackages: the
    loaded changes and the run equal the reference's (heads 1e-10, equal
    counts), and simulation_from_reference carries them."""
    from test_torch_deck import (_add_option, _deck_with, simulation_state)
    from modflow6_torch.convert import simulation_from_reference
    edits = [("m.npf", _add_option("TVK6 FILEIN m.tvk"), {"m.tvk": (
        "BEGIN PERIOD 2\n  1 2 2 K 3.5\n  2 3 4 K33 0.2\nEND PERIOD\n")}),
        ("m.sto", _add_option("TVS6 FILEIN m.tvs"), {"m.tvs": (
            "BEGIN PERIOD 2\n  1 1 1 SS 2e-4\n  2 6 5 SS 0.05\n"
            "END PERIOD\n")})]
    _deck_with(tmp_path, edits[0])
    name, fn, files = edits[1]
    path = tmp_path / name
    path.write_text(fn(path.read_text()))
    (tmp_path / "m.tvs").write_text(files["m.tvs"])
    sim, jsim = load_simulation(str(tmp_path), device="cpu"), \
        ref_load(str(tmp_path))
    assert sim.tvk == jsim.tvk and sim.tvs == jsim.tvs and sim.tvk
    conv = simulation_from_reference(simulation_state(jsim), device="cpu")
    assert conv.tvk == jsim.tvk and conv.tvs == jsim.tvs
    for a, b, c in zip(sim.run(), jsim.run(), conv.run()):
        assert a.converged and (a.outer, a.inner) == (b.outer, b.inner)
        np.testing.assert_allclose(a.head, b.head, atol=1e-10)
        np.testing.assert_array_equal(a.head, c.head)


# ---------------------------------------------------------- shared helpers

def reference_general_state(ref, structured=False):
    """(arrays, keyword arguments) of from_reference for a reference model,
    with the edge topology (or the structured planes)."""
    a, d = ref.npf_arrays, ref.dtopo
    arrays = dict(k11=a.k11, k22=a.k22, k33=a.k33, icelltype=a.icelltype,
                  top=a.top, bot=a.bot, strt=ref.strt, ibound0=ref.ibound0)
    if structured:
        arrays.update(delr=ref.delr, delc=ref.delc,
                      condsat_x=ref.condsat3[0], condsat_y=ref.condsat3[1],
                      condsat_z=ref.condsat3[2])
    else:
        arrays.update(area=ref.grid.area, angle1=a.angle1, angle2=a.angle2,
                      angle3=a.angle3, condsat=a.condsat, edge_n=d.edge_n,
                      edge_m=d.edge_m, ihc=d.ihc, cl1=d.cl1, cl2=d.cl2,
                      hwva=d.hwva, anglex=d.anglex, nbr=d.nbr,
                      slot_nm=ref.topo.slot_nm, slot_mn=ref.topo.slot_mn)
    if ref.sto_arrays is not None:
        s = ref.sto_arrays
        arrays.update(sto_iconvert=s.iconvert, sto_ss=s.ss, sto_sy=s.sy)
    for pkg, value in (("chd", "head"), ("wel", "q")):
        data = getattr(ref, pkg)
        if data is not None:
            arrays.update({f"{pkg}_node": data.node, f"{pkg}_mask": data.mask,
                           f"{pkg}_{value}": getattr(data, value)})
    kw = dict(grid_shape=d.grid_shape,
              npf_options=dataclasses.asdict(ref.npf_opts),
              sto_options=None if ref.sto_opts is None
              else dataclasses.asdict(ref.sto_opts),
              model_options=model_options(ref))
    return {k: np.asarray(v) for k, v in arrays.items()}, kw


def assert_same_port_system(conv, port, pkgs=None):
    ib, h = port.boundary_state(port.strt - 1.0)
    cp = pkgs if pkgs is None else dataclasses.replace(
        conv.packages, buy_conc=pkgs.buy_conc)
    for g, w in zip(conv.assemble(h, h, ib, 1.0, True, cp),
                    port.assemble(h, h, ib, 1.0, True, pkgs)):
        close(g, w, rtol=1e-13)


def test_sto_integratechanges_is_refused_by_name():
    """G2: the port refuses ``StoOptions.integratechanges`` by name.  The
    reference's flag is inert: no caller passes ``oldss``/``oldsy``, so its
    storage terms with the flag set equal those without it."""
    from modflow6_tpu.models.gwf import sto as jsto
    grid = dict(nlay=1, nrow=3, ncol=4, delr=10.0, delc=10.0, top=10.0,
                botm=np.zeros((1, 3, 4)))
    kw = dict(k=1.0, strt=5.0, chd=[(0, 5.0)], icelltype=1,
              storage={"ss": 1e-5, "sy": 0.2, "iconvert": 1})
    model = build_gwf("m", DisGrid.create(**grid), device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="TVS storage integration"):
        dataclasses.replace(model, sto_opts=dataclasses.replace(
            model.sto_opts, integratechanges=1))
    jm = jax_build_gwf("m", JaxDisGrid.create(**grid), **kw)
    head = jnp.linspace(4.0, 6.0, 12)
    ib = jnp.ones(12, jnp.int32)
    args = (jm.sto_arrays, head, head - 0.5, ib, 2.0)
    plain = jsto.assemble(jm.sto_opts, *args)
    flagged = jsto.assemble(dataclasses.replace(jm.sto_opts,
                                                integratechanges=1), *args)
    for a, b in zip(plain, flagged):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
