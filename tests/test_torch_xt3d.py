"""XT3D of the port (full and RHS modes, the Newton form) against the
reference.

Tolerances:

- the host tables of ``build_xt3d`` (the extended neighbour table, the
  cross positions, every geometry array): equal;
- the assembled system at a random head, each mode with and without
  Newton: 1e-12 of the largest entry (the same float64 terms, summed in
  another order);
- solves, the bars of tests/test_xt3d.py and tests/test_newton_advanced.py:
  on an orthogonal grid XT3D equals the two-point scheme to 1e-7; linear
  patches to 1e-6 (flux rtol 1e-8); RHS mode equals full mode to 1e-6;
  continuity at interior cells to 1e-7; confined Newton equals Picard to
  1e-7, unconfined within 0.05; and the port's heads within the same bars
  of the reference's (BiCGSTAB counts follow the sum order and are not
  compared);
- CHD flows and budget of an XT3D model through ``Simulation``: 1e-9 of
  the largest flow, budget totals rtol 1e-9.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.discretization import DisvGrid as JaxDisvGrid
from modflow6_tpu.models.gwf import xt3d as jxt3d
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.simulation import Simulation as JaxSimulation
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxSolution
from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
from modflow6_tpu.timing.tdis import Tdis as JaxTdis
from modflow6_torch.convert import from_reference
from modflow6_torch.models.discretization import DisGrid, DisvGrid
from modflow6_torch.models.gwf import xt3d
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.simulation import Simulation
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.ims import NumericalSolution
from modflow6_torch.timing.tdis import StressPeriod, Tdis

# tests/test_xt3d.py:18-21 and tests/test_newton_advanced.py:13-17
XT3D = dict(outer_dvclose=1e-9, outer_maximum=60, inner_dvclose=1e-11,
            inner_rclose=1e-10, inner_maximum=600,
            linear_acceleration="bicgstab")
NEWTON = dict(outer_dvclose=1e-8, outer_maximum=300, inner_dvclose=1e-10,
              inner_rclose=1e-9, inner_maximum=2000,
              linear_acceleration="bicgstab")


def boundary_nodes(nrow, ncol):
    return sorted({i * ncol for i in range(nrow)}
                  | {i * ncol + ncol - 1 for i in range(nrow)}
                  | set(range(ncol)) | {(nrow - 1) * ncol + j
                                         for j in range(ncol)})


def skewed_disv_args(nrow, ncol, dx=10.0, dy=10.0, skew=0.35):
    """tests/test_xt3d.py:115-132: a parallelogram grid."""
    verts = [(j * dx + skew * i * dx, -i * dy) for i in range(nrow + 1)
             for j in range(ncol + 1)]
    cell2d = []
    for i in range(nrow):
        for j in range(ncol):
            v00 = i * (ncol + 1) + j
            ids = [v00, v00 + 1, v00 + ncol + 2, v00 + ncol + 1]
            cell2d.append((sum(verts[v][0] for v in ids) / 4.0,
                           sum(verts[v][1] for v in ids) / 4.0, ids))
    return dict(nlay=1, ncpl=nrow * ncol, vertices=np.array(verts),
                cell2d=cell2d, top=10.0, botm=np.zeros((1, nrow * ncol)))


def row_args(nrow, ncol, nlay=1, delr=10.0, delc=10.0):
    botm = np.linspace(10.0 * (nlay - 1) / nlay, 0.0, nlay) if nlay > 1 \
        else np.zeros(1)
    return dict(nlay=nlay, nrow=nrow, ncol=ncol, delr=delr, delc=delc,
                top=10.0, botm=botm[:, None, None] * np.ones((nlay, nrow,
                                                              ncol)))


def linear_field(x, y, a, b):
    return 100.0 + a * x + b * y


def both(grid_kind, grid, kw):
    jg, tg = ((JaxDisGrid, DisGrid) if grid_kind == "dis"
              else (JaxDisvGrid, DisvGrid))
    return (jax_build_gwf("ref", jg.create(**grid), **kw),
            build_gwf("port", tg.create(**grid), device="cpu", **kw))


def patch_kw(grid_kind, grid, a, b, **kw):
    """CHD at the linear field on the boundary of a one-layer grid."""
    cls = DisGrid if grid_kind == "dis" else DisvGrid
    x, y, _ = xt3d.cell_centers(cls.create(**grid))
    h = linear_field(x, y, a, b)
    nrow = grid.get("nrow", int(np.sqrt(grid.get("ncpl", 1))))
    ncol = grid.get("ncol", nrow)
    chd = [(n, float(h[n])) for n in boundary_nodes(nrow, ncol)]
    return dict(strt=100.0, chd=chd, **kw), h


def solve(model, settings, reference=False):
    if reference:
        h, info, _ = JaxSolution(model, JaxImsSettings(**settings)) \
            .solve_timestep(model.strt, 1.0, iss=True)
        return np.asarray(h), info
    h, info, _ = NumericalSolution(model, ImsSettings(**settings)) \
        .solve_timestep(model.strt, 1.0, iss=True)
    return h.numpy(), info


# ------------------------------------------------------------ host tables

TABLE_CASES = {
    "dis-3layers": ("dis", row_args(5, 6, nlay=3), dict(k=2.0, k22=0.5,
                                                         angle1=30.0)),
    "disv-skewed": ("disv", skewed_disv_args(5, 4), dict(k=3.0)),
    "dis-rhs": ("dis", row_args(4, 5, nlay=2), dict(k=1.0, angle2=10.0)),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_build_xt3d_tables_equal_reference(case):
    """Every array of the port's XT3D data equals the reference's, the
    extended table and the cross positions among them (array code in
    place of the reference's loops over edges x K)."""
    kind, grid, kw = TABLE_CASES[case]
    mode = 2 if case.endswith("rhs") else 1
    ref, port = both(kind, grid, dict(kw, strt=5.0, xt3d=mode))
    for name in jxt3d.Xt3dData.__dataclass_fields__:
        want = getattr(ref.xt3d, name)
        if isinstance(want, (int, float)):
            assert getattr(port.xt3d, name) == want, name
            continue
        np.testing.assert_array_equal(getattr(port.xt3d, name).numpy(),
                                      np.asarray(want), err_msg=name)
    if mode == 1:
        assert port.xt3d.nbr_ext.shape[1] > port.xt3d.max_degree
        assert port.system_topo.nbr is port.xt3d.nbr_ext
    assert port.dtopo.nbr.shape[1] == port.xt3d.max_degree


@pytest.mark.parametrize("mode,newton", [(1, False), (2, False), (1, True),
                                         (2, True)])
def test_xt3d_system_matches_reference(mode, newton):
    """(diag, off, rhs) at a random head of a two-layer unconfined model with
    rotated anisotropy, a hole in idomain and a CHD column."""
    rng = np.random.default_rng(7)
    grid = row_args(6, 7, nlay=2)
    grid["idomain"] = np.ones((2, 6, 7), np.int32)
    grid["idomain"][0, 2, 3] = 0
    n = 2 * 6 * 7
    kw = dict(k=np.exp(rng.normal(0, 0.5, n)),
              k22=np.exp(rng.normal(0, 0.5, n)) * 0.5,
              angle1=rng.uniform(0, 60, n), icelltype=1, strt=6.0,
              newton=newton, xt3d=mode, chd=[(i * 7, 8.0) for i in range(6)],
              storage={"ss": 1e-4, "sy": 0.1, "iconvert": 1})
    ref, port = both("dis", grid, kw)
    head = 3.0 + 6.0 * rng.random(n)
    ibj, hj = ref.boundary_state(jnp.asarray(head))
    ibt, ht = port.boundary_state(torch.tensor(head))
    got = port.assemble(ht, ht - 0.1, ibt, 2.0, False)
    want = ref.assemble(hj, hj - 0.1, ibj, 2.0, False)
    for g, w, name in zip(got, want, ("diag", "off", "rhs")):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max(), err_msg=name)
    if newton:
        # the backtracking rebuild without the Jacobian terms
        g = port.assemble(ht, ht, ibt, 2.0, False, newton=False)[0]
        w = np.asarray(ref.assemble(hj, hj, ibj, 2.0, False, newton=False)[0])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max())


# ----------------------------------------------------------------- solves

def test_xt3d_matches_standard_on_orthogonal_grid():
    """tests/test_xt3d.py:40-58: axis-aligned K on a rectangular grid,
    XT3D reduces to the harmonic-mean two-point scheme (1e-7), and the
    port's XT3D heads agree with the reference's to the same bar."""
    nrow, ncol = 12, 15
    grid = dict(nlay=1, nrow=nrow, ncol=ncol, delr=10.0, delc=8.0, top=10.0,
                botm=np.zeros((1, nrow, ncol)))
    k = np.exp(np.random.default_rng(11).normal(0.0, 1.0, nrow * ncol))
    chd = [(i * ncol, 10.0) for i in range(nrow)] + \
          [(i * ncol + ncol - 1, 2.0) for i in range(nrow)]
    heads = {}
    for mode in (0, 1):
        ref, port = both("dis", grid, dict(k=k, strt=5.0, chd=chd,
                                           xt3d=mode))
        heads[mode], info = solve(port, XT3D)
        assert info.converged
        assert port.use_structured == (mode == 0)
    np.testing.assert_allclose(heads[1], heads[0], atol=1e-7)
    want, info = solve(ref, XT3D, reference=True)
    assert info.converged
    np.testing.assert_allclose(heads[1], want, atol=1e-7)


@pytest.fixture(scope="module")
def patch_runs():
    """tests/test_xt3d.py:61-112: a linear field with rotated anisotropy
    on 12x12 in full mode and on 10x10 in both modes, port and reference."""
    out = {}
    for name, n, a, b, kw, modes in (
            ("rotated", 12, 0.03, -0.02, dict(k=10.0, k22=1.0, angle1=30.0),
             (1,)),
            ("rhs", 10, 0.02, 0.01, dict(k=5.0, k22=0.5, angle1=-25.0),
             (1, 2))):
        grid = dict(nlay=1, nrow=n, ncol=n, delr=10.0, delc=10.0, top=10.0,
                    botm=np.zeros((1, n, n)))
        kw, field = patch_kw("dis", grid, a, b, **kw)
        for mode in modes:
            ref, port = both("dis", grid, dict(kw, xt3d=mode))
            out[name, mode] = (ref, port, field, solve(port, XT3D),
                               solve(ref, XT3D, reference=True))
    return out


def test_xt3d_patch_rotated_anisotropy(patch_runs):
    """The linear field to 1e-6 and the exact full-tensor flux through an
    interior eastward face to rtol 1e-8 (tests/test_xt3d.py:61-93)."""
    ref, port, field, (h, info), (h_ref, info_ref) = patch_runs["rotated", 1]
    assert info.converged and info_ref.converged
    np.testing.assert_allclose(h, field, atol=1e-6)
    np.testing.assert_allclose(h, h_ref, atol=1e-6)
    ibound, _ = port.boundary_state(port.strt)
    q = port.edge_flows(torch.tensor(field), ibound).numpy()
    q_ref = np.asarray(ref.edge_flows(jnp.asarray(field),
                                      ref.boundary_state(ref.strt)[0]))
    np.testing.assert_allclose(q, q_ref, rtol=1e-8,
                               atol=1e-12 * np.abs(q_ref).max())
    th = np.deg2rad(30.0)
    kxx = 10.0 * np.cos(th) ** 2 + 1.0 * np.sin(th) ** 2
    kxy = (10.0 - 1.0) * np.sin(th) * np.cos(th)
    qx_exact = -(kxx * 0.03 + kxy * (-0.02)) * 10.0 * 10.0
    en, em = port.topo.edge_n, port.topo.edge_m
    mid = 6 * 12 + 6
    e = int(np.where((en == mid) & (em == mid + 1))[0][0])
    np.testing.assert_allclose(-q[e], qx_exact, rtol=1e-8)


def test_xt3d_rhs_mode_matches_full(patch_runs):
    """tests/test_xt3d.py:96-112: RHS mode equals full mode and the linear
    field to 1e-6, in the port and against the reference."""
    (_, _, field, (h1, i1), (r1, _)), (_, port2, _, (h2, i2), (r2, _)) = (
        patch_runs["rhs", 1], patch_runs["rhs", 2])
    assert i1.converged and i2.converged
    assert port2.system_topo is port2.dtopo
    np.testing.assert_allclose(h2, h1, atol=1e-6)
    np.testing.assert_allclose(h1, field, atol=1e-6)
    np.testing.assert_allclose(h1, r1, atol=1e-6)
    np.testing.assert_allclose(h2, r2, atol=1e-6)


def test_xt3d_patch_on_skewed_disv():
    """tests/test_xt3d.py:135-144: the linear field on a parallelogram DISV
    grid to 1e-6."""
    grid = skewed_disv_args(8, 8)
    kw, field = patch_kw("disv", grid, 0.01, 0.02, k=3.0, xt3d=1)
    port = build_gwf("p", DisvGrid.create(**grid), device="cpu", **kw)
    h, info = solve(port, XT3D)
    assert info.converged
    np.testing.assert_allclose(h, field, atol=1e-6)


@pytest.fixture(scope="module")
def budget_runs():
    """tests/test_xt3d.py:147-169 as a two-step transient Simulation run
    by both packages: 9x9, anisotropic K rotated by 20 degrees, CHD on two
    sides."""
    n = 9
    grid = dict(nlay=1, nrow=n, ncol=n, delr=10.0, delc=10.0, top=10.0,
                botm=np.zeros((1, n, n)))
    chd = [(i * n, 10.0) for i in range(n)] + \
          [(i * n + n - 1, 4.0) for i in range(n)]
    kw = dict(k=2.0, k22=0.4, angle1=20.0, strt=7.0, chd=chd, xt3d=1,
              storage={"ss": 1e-3, "iconvert": 0})
    ref, port = both("dis", grid, kw)
    runs = []
    for sim in (JaxSimulation(JaxTdis((JaxPeriod(2.0, 2, 1.0),)), ref,
                              JaxImsSettings(**XT3D)),
                Simulation(Tdis((StressPeriod(2.0, 2, 1.0),)), port,
                           ImsSettings(**XT3D))):
        recs = sim.run()
        assert all(r.converged for r in recs)
        runs.append(sim)
    return ref, port, chd, runs


def test_xt3d_budget_closure(budget_runs):
    """Continuity at interior cells to 1e-7 (tests/test_xt3d.py:147-169)
    from the per-cell sums of the multi-point flows, which go through the
    depth-1 ELL slots while the system lives on the extended table."""
    ref, port, chd, (jsim, sim) = budget_runs
    h = torch.tensor(sim.records[-1].head)
    ibound, _ = port.boundary_state(port.strt)
    into = port.cell_inflow(h, ibound).numpy()
    chd_nodes = {n for n, _ in chd}
    interior = [n for n in range(port.nodes) if n not in chd_nodes]
    storage = sim._storage_rates(h, torch.tensor(sim.records[-2].head),
                                 ibound, 1.0)[0].numpy()
    assert np.abs(into[interior] + storage[interior]).max() < 1e-7
    assert port.dtopo.max_degree == 6        # DIS: fixed stencil slots
    assert port.system_topo.max_degree > 6


def test_xt3d_chd_flows_and_budget_match_reference(budget_runs):
    """The CHD flows (the per-cell sums of the edge flows at the CHD cells)
    and the budget of the run equal the reference's: 1e-9 of the largest
    flow, totals rtol 1e-9."""
    ref, port, chd, (jsim, sim) = budget_runs
    for a, b in zip(sim.records, jsim.records):
        np.testing.assert_allclose(a.head, b.head, atol=1e-9)
    h = sim.records[-1].head
    q_ref = np.asarray(ref.edge_flows(jnp.asarray(h),
                                      ref.boundary_state(ref.strt)[0]))
    into = np.zeros(port.nodes)
    np.add.at(into, ref.topo.edge_n, q_ref)
    np.add.at(into, ref.topo.edge_m, -q_ref)
    ibound, _ = port.boundary_state(port.strt)
    got = port.cell_inflow(torch.tensor(h), ibound).numpy()
    np.testing.assert_allclose(got, into, atol=1e-9 * np.abs(q_ref).max())
    nodes = [n for n, _ in chd]
    assert np.abs(into[nodes]).max() > 1.0
    for name, term in jsim.budget.terms.items():
        mine = sim.budget.terms[name]
        np.testing.assert_allclose(
            [mine.rate_in, mine.rate_out, mine.cum_in, mine.cum_out],
            [term.rate_in, term.rate_out, term.cum_in, term.cum_out],
            rtol=1e-9, atol=1e-9 * max(term.rate_in, term.rate_out, 1.0))
    assert set(sim.budget.terms) == set(jsim.budget.terms)
    assert abs(sim.budget.percent_discrepancy()) < 1e-6


# ------------------------------------------------------------------ Newton

def newton_kw(newton, icelltype):
    """tests/test_newton_advanced.py:25-36."""
    rng = np.random.default_rng(2)
    n = 80
    return dict(k=np.exp(rng.normal(0, 0.5, size=n)),
                k22=np.exp(rng.normal(0, 0.5, size=n)) * 0.5,
                angle1=np.full(n, 30.0), strt=15.0, icelltype=icelltype,
                newton=newton, xt3d=True,
                chd=[(i * 10, 16.0) for i in range(8)]
                + [(i * 10 + 9, 12.0) for i in range(8)],
                wel=[(4 * 10 + 5, -20.0)])


NEWTON_GRID = dict(nlay=1, nrow=8, ncol=10, delr=10.0, delc=10.0, top=20.0,
                   botm=np.zeros((1, 8, 10)))


def test_xt3d_newton_confined_matches_picard_exactly():
    """tests/test_newton_advanced.py:39-52: confined cells, the Newton
    system reduces to the Picard one (1e-7), port and reference."""
    heads = {}
    for newton in (False, True):
        ref, port = both("dis", NEWTON_GRID, newton_kw(newton, 0))
        heads[newton], info = solve(port, NEWTON)
        assert info.converged
    np.testing.assert_allclose(heads[True], heads[False], atol=1e-7)
    want, info = solve(ref, NEWTON, reference=True)
    assert info.converged
    np.testing.assert_allclose(heads[True], want, atol=1e-7)


def test_xt3d_newton_unconfined_converges():
    """tests/test_newton_advanced.py:55-70: unconfined XT3D Newton
    converges with the water table inside the cells and lies within 0.05 of
    the Picard form; its heads equal the reference's within 10 x
    outer_dvclose (BiCGSTAB, Queue C)."""
    ref, port = both("dis", NEWTON_GRID, newton_kw(True, 1))
    h_new, info = solve(port, NEWTON)
    assert info.converged
    assert h_new.max() < 20.0
    h_pic, info = solve(build_gwf("p", DisGrid.create(**NEWTON_GRID),
                                  device="cpu", **newton_kw(False, 1)),
                        NEWTON)
    assert info.converged
    np.testing.assert_allclose(h_new, h_pic, atol=0.05)
    want, info = solve(ref, NEWTON, reference=True)
    assert info.converged
    np.testing.assert_allclose(h_new, want,
                               atol=10 * NEWTON["outer_dvclose"])


# --------------------------------------------------------- state and gaps

def reference_xt3d_arrays(ref):
    """The from_reference arguments of a reference XT3D model."""
    a, d = ref.npf_arrays, ref.dtopo
    nbr = np.asarray(ref.xt3d.nbr)
    arrays = dict(k11=a.k11, k22=a.k22, k33=a.k33, icelltype=a.icelltype,
                  top=a.top, bot=a.bot, strt=ref.strt, ibound0=ref.ibound0,
                  area=ref.grid.area, angle1=a.angle1, angle2=a.angle2,
                  angle3=a.angle3, condsat=a.condsat, edge_n=d.edge_n,
                  edge_m=d.edge_m, ihc=d.ihc, cl1=d.cl1, cl2=d.cl2,
                  hwva=d.hwva, anglex=d.anglex, nbr=nbr,
                  slot_nm=ref.topo.slot_nm, slot_mn=ref.topo.slot_mn)
    for pkg, value in (("chd", "head"), ("wel", "q")):
        data = getattr(ref, pkg)
        if data is not None:
            arrays.update({f"{pkg}_node": data.node, f"{pkg}_mask": data.mask,
                           f"{pkg}_{value}": getattr(data, value)})
    for name in jxt3d.Xt3dData.__dataclass_fields__:
        value = getattr(ref.xt3d, name)
        if not isinstance(value, (int, float)):
            arrays[f"xt3d_{name}"] = value
    options = dict(inewton=int(ref.inewton), inewtonur=int(ref.inewtonur),
                   wel_iflowred=0, wel_flowred=0.0, ixt3d=ref.ixt3d)
    return {k: np.asarray(v) for k, v in arrays.items()}, options


@pytest.mark.parametrize("mode", [1, 2])
def test_convert_carries_the_xt3d_state(mode):
    """from_reference builds the port's XT3D model from the reference's
    arrays: the same system as the port's own build_gwf, to rounding."""
    ref, port = both("dis", NEWTON_GRID, dict(newton_kw(True, 1), xt3d=mode))
    arrays, options = reference_xt3d_arrays(ref)
    conv = from_reference(arrays, grid_shape=None, device="cpu",
                          npf_options=dataclasses.asdict(ref.npf_opts),
                          model_options=options,
                          grid=DisGrid.create(**NEWTON_GRID))
    assert conv.system_topo.nbr.shape == port.system_topo.nbr.shape
    ib, h = port.boundary_state(port.strt - 3.0)
    for g, w in zip(conv.assemble(h, h, ib, 1.0, True),
                    port.assemble(h, h, ib, 1.0, True)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-13,
                                   atol=1e-13 * w.abs().max().item())


def test_buy_with_xt3d_is_refused():
    """The reference computes BUY's conductances from the two-point condsat
    (npf.edge_conductance), which its XT3D setup never fills: the terms of
    a confined model vanish in both modes, and in full mode they would be
    written through depth-1 slots (buy.py:100-104) into the Ktot-wide
    table.  The port refuses BUY with XT3D."""
    grid = dict(nlay=2, nrow=3, ncol=4, delr=10.0, delc=10.0, top=20.0,
                botm=np.array([10.0, 0.0])[:, None, None] * np.ones((2, 3, 4)))
    conc = np.linspace(0.0, 35.0, 24)
    buy = dict(denseref=1000.0, drhodc=0.7, crhoref=0.0, iform=2)
    for mode in (0, 2, 1):
        ref, port = both("dis", grid, dict(k=1.0, strt=15.0, xt3d=mode,
                                           chd=[(0, 15.0)], buy=buy))
        ibj, hj = ref.boundary_state(jnp.asarray(ref.strt))
        pj = dataclasses.replace(ref.packages, buy_conc=jnp.asarray(conc))
        with_buy = ref.assemble(hj, hj, ibj, 1.0, True, pj)
        without = ref.assemble(hj, hj, ibj, 1.0, True)
        change = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                     for a, b in zip(with_buy, without))
        assert (change > 0.0) == (mode == 0), mode
        if mode:
            ibt, ht = port.boundary_state(port.strt)
            pt = dataclasses.replace(port.packages,
                                     buy_conc=torch.tensor(conc))
            with pytest.raises(NotImplementedError, match="BUY"):
                port.assemble(ht, ht, ibt, 1.0, True, pt)


def test_xt3d_combinations_that_raise():
    """As in the reference: HFB with XT3D (model.py:107), VSC with XT3D
    (:127; the reference's setup returns before that test, the port
    raises) and TVK with XT3D (simulation.py:146) raise."""
    grid = DisGrid.create(**NEWTON_GRID)
    with pytest.raises(NotImplementedError, match="HFB"):
        build_gwf("h", grid, xt3d=1, hfb=[(0, 1, 1e-3)], device="cpu")
    with pytest.raises(NotImplementedError, match="VSC"):
        build_gwf("v", grid, xt3d=2, vsc=dict(viscref=1.0), device="cpu")
    model = build_gwf("t", grid, xt3d=1, k=1.0, strt=1.0, chd=[(0, 1.0)],
                      device="cpu")
    sim = Simulation(Tdis((StressPeriod(1.0, 1, 1.0),) * 2), model,
                     ImsSettings(**XT3D), transient=[False, False])
    sim.tvk = {2: [(3, "K", 2.0)]}
    with pytest.raises(NotImplementedError, match="TVK"):
        sim.run()


def test_deck_xt3d_option_is_refused_where_the_reference_reads_past_it(
        tmp_path):
    """The reference's loader reads no XT3D option: a deck that sets it runs
    the two-point scheme there.  The port's loader refuses the option by
    name rather than run another scheme than the deck asks for (ROADMAP
    Queue C); XT3D reaches a model through ``build_gwf(xt3d=)``."""
    from test_torch_deck import UNSUPPORTED, _deck_with
    from modflow6_tpu.utils.mf6io import load_simulation as ref_load
    from modflow6_torch.utils.mf6io import load_simulation
    _deck_with(tmp_path, UNSUPPORTED["XT3D"])
    assert "XT3D" in (tmp_path / "m.npf").read_text()
    ref = ref_load(str(tmp_path))
    assert ref.model.ixt3d == 0 and ref.model.xt3d is None
    with pytest.raises(NotImplementedError, match="XT3D"):
        load_simulation(str(tmp_path), device="cpu")
