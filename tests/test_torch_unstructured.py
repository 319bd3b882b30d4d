"""The general (edge-list + ELL gather) GWF path of the port against the
reference: DISV and DISU grids, a DIS grid with rotated anisotropy, and a
DIS grid forced through the general path.

Tolerances:

- grids and topology (edge arrays, ELL table, CSR pattern, top/bot/area):
  equal to the reference's, exactly;
- ``_hyeff``, ``edge_hy``, ``compute_condsat``, ``edge_conductance``,
  ``assemble``, the edge Newton terms, ``thksatnm`` and the staggered
  ``hcond``: rtol 1e-12 (atol 1e-12 of the largest entry); the edge
  wetting/drying sweep: the same cells, heads at 1e-12;
- ``spmv`` and ``apply_dirichlet``: 1e-12 of the largest entry;
- a DIS model through the general path against the structured path:
  ``(diag, off, rhs)`` at 1e-12, heads at 1e-10;
- HFB: condsat equal to the reference's at rtol 1e-14;
- whole CG solves: equal (outer, inner) counts and heads at 1e-10, and
  heads within 2e-5 of a direct solve of the port's own system; the
  Newton DISV solve (BiCGSTAB): heads within 10 x outer_dvclose.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch
from scipy.spatial import Delaunay

from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.discretization.disu import DisuGrid as JaxDisuGrid
from modflow6_tpu.models.discretization.disv import DisvGrid as JaxDisvGrid
from modflow6_tpu.models.gwf import npf as jnpf
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.ops import conductance as jcond
from modflow6_tpu.ops import system as jsystem
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution.fused import make_fused_run as jax_make_fused_run
from modflow6_tpu.solution.ims import NumericalSolution as JaxSolution
from modflow6_torch.models.discretization import (DisGrid, DisuGrid, DisvGrid,
                                                  Topology)
from modflow6_torch.models.gwf import npf
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.ops import conductance as tcond
from modflow6_torch.ops import system
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.fused import make_fused_run
from modflow6_torch.solution.ims import NumericalSolution
from modflow6_torch.utils.profiler import launches

TOPO_FIELDS = ("edge_n", "edge_m", "ihc", "cl1", "cl2", "hwva", "direction",
               "anglex", "nbr", "slot_nm", "slot_mn")
# closures that double precision reaches with room to spare: at the TIGHT
# ones CG stalls near rounding on these small stiff systems, and the order
# of a sum decides how many hundred iterations it stalls for
ENTRY = dict(outer_dvclose=1e-6, outer_maximum=50, inner_dvclose=1e-8,
             inner_rclose=1e-6, inner_maximum=300)
TIGHT = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-10,
             inner_rclose=1e-9, inner_maximum=2000)


# ---------------------------------------------------------------- meshes

def quad_mesh(nrow, ncol, d=10.0):
    """(vertices, cell2d) of nrow x ncol square cells, rings clockwise."""
    xs, ys = np.arange(ncol + 1) * d, (nrow - np.arange(nrow + 1)) * d
    vx, vy = np.meshgrid(xs, ys)
    verts = np.stack([vx.ravel(), vy.ravel()], axis=1)
    cell2d = []
    for i in range(nrow):
        for j in range(ncol):
            v0 = i * (ncol + 1) + j
            cell2d.append(((j + 0.5) * d, (nrow - i - 0.5) * d,
                           [v0, v0 + 1, v0 + ncol + 2, v0 + ncol + 1]))
    return verts, cell2d


def brick_mesh(nrow, ncol, d=10.0):
    """Every other row offset by half a cell: six horizontal neighbours.
    Each cell's ring holds the midpoints of its top and bottom sides, where
    the corners of the rows above and below lie."""
    nx = 2 * ncol + 2
    xs, ys = np.arange(nx) * d / 2, (nrow - np.arange(nrow + 1)) * d
    vx, vy = np.meshgrid(xs, ys)
    verts = np.stack([vx.ravel(), vy.ravel()], axis=1)
    cell2d = []
    for i in range(nrow):
        for j in range(ncol):
            c0 = 2 * j + i % 2
            t, b = i * nx + c0, (i + 1) * nx + c0
            cell2d.append(((c0 / 2 + 0.5) * d, (nrow - i - 0.5) * d,
                           [t, t + 1, t + 2, b + 2, b + 1, b]))
    return verts, cell2d


def delaunay_mesh(npoints=150, seed=3):
    """A seeded random triangulation: cells with three to five neighbours
    in no order a structured grid has."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 100.0, size=(npoints, 2))
    cell2d = [(pts[s, 0].mean(), pts[s, 1].mean(), list(s))
              for s in Delaunay(pts).simplices]
    return pts, cell2d


def disv_args(mesh, nlay=2, seed=0, holes=False):
    """Keyword arguments of ``DisvGrid.create`` for a mesh."""
    verts, cell2d = mesh
    ncpl = len(cell2d)
    rng = np.random.default_rng(seed)
    botm = (np.linspace(0.0, -30.0, nlay)[:, None]
            + rng.uniform(0.0, 2.0, (nlay, ncpl)))
    idomain = np.ones((nlay, ncpl), np.int32)
    if holes:
        idomain[0, rng.choice(ncpl, ncpl // 10, replace=False)] = 0
        if nlay > 2:
            # vertical pass-through cells, and inactive cells below some
            idomain[1, rng.choice(ncpl, ncpl // 6, replace=False)] = -1
            idomain[2, rng.choice(ncpl, ncpl // 10, replace=False)] = 0
    return dict(nlay=nlay, ncpl=ncpl, vertices=verts, cell2d=cell2d,
                top=25.0, botm=botm, idomain=idomain)


def disu_args(disv_kwargs, stagger_every=5):
    """Keyword arguments of ``DisuGrid.create`` holding the connections of a
    DISV grid, every ``stagger_every``-th horizontal one made staggered
    (ihc 2)."""
    g = JaxDisvGrid.create(**disv_kwargs)
    t = g.build_topology()
    ia, ja, pnm, pmn = t.csr
    ihc = np.zeros(ja.size, np.int64)
    cl12, hwva, ang = (np.zeros(ja.size) for _ in range(3))
    e_ihc = t.ihc.copy()
    horiz = np.nonzero(e_ihc == 1)[0]
    e_ihc[horiz[::stagger_every]] = 2
    for pos, cl, dang in ((pnm, t.cl1, 0.0), (pmn, t.cl2, 180.0)):
        ihc[pos] = e_ihc
        cl12[pos] = cl
        hwva[pos] = t.hwva
        ang[pos] = np.rad2deg(t.anglex) + dang
    idomain = (g.idomain.reshape(-1) > 0).astype(np.int32)
    return dict(top=g.top, bot=g.bot, area=g.area, iac=np.diff(ia), ja=ja,
                ihc=ihc, cl12=cl12, hwva=hwva, angldegx=ang, idomain=idomain)


MESHES = {
    "quad": lambda: disv_args(quad_mesh(6, 5), nlay=2),
    "brick": lambda: disv_args(brick_mesh(6, 5), nlay=2, seed=1),
    "delaunay": lambda: disv_args(delaunay_mesh(), nlay=2, seed=2),
    "passthrough": lambda: disv_args(delaunay_mesh(90, 7), nlay=4, seed=3,
                                     holes=True),
}


def both_grids(name):
    """(reference grid, port grid) of a named mesh; ``disu`` holds the
    brick mesh's connections with staggered ones among them."""
    if name == "disu":
        kw = disu_args(MESHES["brick"]())
        return JaxDisuGrid.create(**kw), DisuGrid.create(**kw)
    kw = MESHES[name]()
    return JaxDisvGrid.create(**kw), DisvGrid.create(**kw)


GRIDS = tuple(MESHES) + ("disu",)


def assert_same_topology(got, want):
    assert got.nodes == want.nodes and got.max_degree == want.max_degree
    assert got.grid_shape == want.grid_shape
    for name in TOPO_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for g, w in zip(got.csr, want.csr):
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------- grids

@pytest.mark.parametrize("name", GRIDS)
def test_grid_geometry_equals_reference(name):
    ref, port = both_grids(name)
    assert port.shape == ref.shape and port.nodes == ref.nodes
    for prop in ("top", "bot", "area", "idomain"):
        np.testing.assert_array_equal(getattr(port, prop), getattr(ref, prop),
                                      err_msg=prop)


@pytest.mark.parametrize("name", GRIDS)
def test_topology_equals_reference(name):
    ref, port = both_grids(name)
    want, got = ref.build_topology(), port.build_topology()
    assert isinstance(got, Topology)
    assert_same_topology(got, want)
    if name == "passthrough":
        # some connection skips a layer
        ncpl = ref.ncpl
        assert (want.edge_m // ncpl - want.edge_n // ncpl > 1).any()
    if name == "disu":
        assert (want.ihc == 2).any()


def test_vectorised_builders_match_the_reference_loops():
    """The port finds shared edges by sorting vertex-pair keys, assigns the
    greedy ELL slots by a per-node running count and pairs the DISU
    connections by a sorted lookup; the reference loops over cells and
    edges.  On a random polygon mesh of a few hundred cells, with holes and
    pass-through cells, every array is the same."""
    kw = disv_args(delaunay_mesh(220, 11), nlay=3, seed=5, holes=True)
    ref, port = JaxDisvGrid.create(**kw), DisvGrid.create(**kw)
    np.testing.assert_array_equal(port.area, ref.area)
    assert_same_topology(port.build_topology(), ref.build_topology())
    ukw = disu_args(kw, stagger_every=3)
    assert_same_topology(DisuGrid.create(**ukw).build_topology(),
                         JaxDisuGrid.create(**ukw).build_topology())
    for a, b in zip(port.cell_verts, ref.cell_verts):
        np.testing.assert_array_equal(a, b)


def test_disv_from_arrays_equals_create():
    kw = MESHES["brick"]()
    a = DisvGrid.create(**kw)
    b = DisvGrid.from_arrays(kw["nlay"], kw["vertices"], a.xc, a.yc, a.iavert,
                             a.javert, kw["top"], kw["botm"], kw["idomain"])
    assert_same_topology(b.build_topology(), a.build_topology())
    # six horizontal neighbours and one vertical in a two-layer grid
    assert a.build_topology().max_degree == 7


def test_disu_missing_reciprocal_raises():
    kw = disu_args(MESHES["quad"]())
    ja = kw["ja"].copy()
    row1 = int(kw["iac"][0])            # row 1 starts after row 0
    m = int(ja[1])                      # first neighbour of cell 0
    start = int(np.cumsum(kw["iac"])[m - 1])
    row = ja[start:start + int(kw["iac"][m])]
    row[row == 0] = m                   # row m no longer names cell 0
    assert row1 > 1
    with pytest.raises(ValueError, match="no entry in row"):
        DisuGrid.create(**{**kw, "ja": ja})


DIS_ARGS = dict(nlay=3, nrow=5, ncol=7, delr=np.linspace(8.0, 14.0, 7),
                delc=np.linspace(9.0, 12.0, 5), top=30.0,
                botm=np.array([20.0, 8.0, 0.0])[:, None, None]
                * np.ones((3, 5, 7)))


@pytest.mark.parametrize("case", ["full", "holes", "layer-skipping"])
def test_dis_edge_topology_equals_reference(case):
    """``DisGrid.build_edge_topology`` is the reference's ``build_topology``;
    a grid with layer-skipping pass-through cells has no grid shape and its
    ``build_topology`` gives the same general layout."""
    idomain = np.ones((3, 5, 7), np.int32)
    if case != "full":
        idomain[0, 1, 2] = 0
        idomain[2, 3, 3] = 0
    if case == "layer-skipping":
        idomain[1, 2, 4] = -1
    kw = {**DIS_ARGS, "idomain": idomain}
    ref, port = JaxDisGrid.create(**kw), DisGrid.create(**kw)
    want = ref.build_topology()
    assert_same_topology(port.build_edge_topology(), want)
    assert port.grid_shape == want.grid_shape
    if case == "layer-skipping":
        assert want.grid_shape is None
        assert_same_topology(port.build_topology(), want)
    else:
        # the structured layout gives the same edges and CSR pattern
        fast = port.build_topology()
        np.testing.assert_array_equal(fast.edge_n, want.edge_n)
        np.testing.assert_array_equal(fast.edge_m, want.edge_m)
        for g, w in zip(fast.csr, want.csr):
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ NPF pieces

def _close(got, want, rtol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def npf_models(name, seed=0, **kw):
    """One model built by both packages on a named grid with random
    anisotropic K and angles, convertible cells and heads around the cell
    tops."""
    ref_grid, port_grid = both_grids(name)
    n = ref_grid.nodes
    rng = np.random.default_rng(seed)
    args = dict(k=np.exp(rng.normal(0.0, 0.7, n)),
                k22=np.exp(rng.normal(-0.5, 0.5, n)),
                k33=np.exp(rng.normal(-2.0, 0.5, n)),
                angle1=rng.uniform(0.1, 1.2, n),
                angle2=rng.uniform(0.05, 0.3, n),
                angle3=rng.uniform(0.05, 0.3, n),
                icelltype=rng.integers(0, 2, n), strt=20.0)
    args.update(kw)
    ref = jax_build_gwf("ref", ref_grid, **args)
    port = build_gwf("port", port_grid, device="cpu", **args)
    top, bot = np.asarray(ref_grid.top), np.asarray(ref_grid.bot)
    head = bot + rng.uniform(-0.2, 1.3, n) * (top - bot)
    return ref, port, head


def test_hyeff_matches_reference():
    rng = np.random.default_rng(4)
    n = 400
    a = {k: rng.uniform(0.1, 5.0, n) for k in ("k11", "k22", "k33")}
    ang = [rng.uniform(-1.5, 1.5, n) for _ in range(3)]
    vg = rng.normal(size=(3, n))
    vg /= np.linalg.norm(vg, axis=0)
    vg[0, :40] = 0.0                      # exact zeros take the other branch
    ang[0][:40] = ang[1][:40] = ang[2][:40] = 0.0
    for method in (0, 1):
        want = jnpf._hyeff(*(jnp.asarray(v) for v in (*a.values(), *ang, *vg)),
                           iavgmeth=method)
        got = npf._hyeff(*(torch.as_tensor(v)
                           for v in (*a.values(), *ang, *vg)),
                         iavgmeth=method)
        _close(got, want)


@pytest.mark.parametrize("name", ["delaunay", "disu"])
@pytest.mark.parametrize("angles", ["all", "k22-only", "angle2-only", "none"])
def test_edge_hy_and_condsat_match_reference(name, angles):
    kw = {"all": {},
          "k22-only": dict(angle1=0.0, angle2=0.0, angle3=0.0),
          "angle2-only": dict(k22=None, angle1=0.0, angle3=0.0),
          "none": dict(k22=None, angle1=0.0, angle2=0.0, angle3=0.0)}[angles]
    ref, port, _ = npf_models(name, thickstrt=True, **kw)
    assert not port.use_structured and not ref.use_structured
    for g, w in zip(npf.edge_hy(port.dtopo, port.npf_opts, port.npf_arrays),
                    jnpf.edge_hy(ref.dtopo, ref.npf_opts, ref.npf_arrays)):
        _close(g, w)
    _close(port.npf_arrays.condsat, ref.npf_arrays.condsat)


@pytest.mark.parametrize("icellavg", [0, 1, 2, 3])
@pytest.mark.parametrize("iperched", [0, 1])
@pytest.mark.parametrize("name", ["passthrough", "disu"])
def test_edge_assembly_matches_reference(name, iperched, icellavg):
    ref, port, head = npf_models(name, seed=icellavg, icellavg=icellavg,
                                 iperched=iperched, ivarcv=1, idewatcv=iperched)
    ibj, hj = ref.boundary_state(jnp.asarray(head))
    ibt, ht = port.boundary_state(torch.as_tensor(head))
    satj = jnpf.compute_saturation(ref.npf_opts, ref.npf_arrays, hj, ibj)
    satt = npf.compute_saturation(port.npf_opts, port.npf_arrays, ht, ibt)
    want = jnpf.assemble(ref.dtopo, ref.npf_opts, ref.npf_arrays, hj, ibj,
                         satj)
    got = npf.assemble(port.dtopo, port.npf_opts, port.npf_arrays, ht, ibt,
                       satt)
    for g, w in zip(got, want):
        _close(g, w)
    _close(npf.flowja(port.dtopo, got[3], ht),
           jnpf.flowja(ref.dtopo, want[3], hj))
    if iperched:
        assert np.abs(np.asarray(want[2])).max() > 0


@pytest.mark.parametrize("name", ["brick", "disu"])
@pytest.mark.parametrize("ivarcv", [0, 1])
def test_edge_newton_terms_match_reference(name, ivarcv):
    ref, port, head = npf_models(name, seed=3, newton=True, ivarcv=ivarcv)
    ibj, hj = ref.boundary_state(jnp.asarray(head))
    ibt, ht = port.boundary_state(torch.as_tensor(head))
    rng = np.random.default_rng(8)
    n, k = ref.nodes, ref.dtopo.max_degree
    diag, off, rhs = rng.normal(size=n), rng.normal(size=(n, k)), \
        rng.normal(size=n)
    want = jnpf.newton_terms(ref.dtopo, ref.npf_opts, ref.npf_arrays, hj, ibj,
                             *(jnp.asarray(v) for v in (diag, off, rhs)))
    got = npf.newton_terms_edges(
        port.dtopo, port.npf_opts, port.npf_arrays, ht, ibt,
        *(torch.as_tensor(v) for v in (diag, off, rhs)))
    for g, w, base in zip(got, want, (diag, off, rhs)):
        _close(g, w)
        assert np.abs(np.asarray(w) - base).max() > 0


@pytest.mark.parametrize("name", ["brick", "passthrough", "disu"])
@pytest.mark.parametrize("ihdwet", [0, 1])
def test_edge_wetdry_update_matches_reference(name, ihdwet):
    ref, port, head = npf_models(name, seed=6, icelltype=1)
    rng = np.random.default_rng(9)
    n = ref.nodes
    wetdry = rng.choice([-0.5, 0.0, 0.3, 1.0], n)
    ibound = np.asarray(ref.ibound0) * rng.integers(0, 2, n)
    args = dict(iwetit=1, ihdwet=ihdwet, wetfct=0.8)
    for kiter in (1, 2):
        want = jnpf.wetdry_update(
            ref.dtopo, ref.npf_arrays, jnp.asarray(wetdry),
            jnp.asarray(ibound, jnp.int32), jnp.asarray(head), kiter,
            **{**args, "iwetit": kiter})
        got = npf.wetdry_update_edges(
            port.dtopo, port.npf_arrays, torch.as_tensor(wetdry),
            torch.as_tensor(ibound, dtype=torch.int32), torch.as_tensor(head),
            kiter, **{**args, "iwetit": kiter})
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        _close(got[1], want[1])
        assert bool(got[2]) == bool(want[2])
    assert (np.asarray(want[0]) > ibound).any()       # some cell rewetted


def test_staggered_hcond_and_thksatnm_match_reference():
    """The ``ihc == 2`` branches, which only a DISU grid reaches."""
    rng = np.random.default_rng(12)
    n = 500
    f = dict(hn=rng.uniform(0, 12, n), hm=rng.uniform(0, 12, n),
             satn=rng.uniform(0, 1, n), satm=rng.uniform(0, 1, n),
             hkn=rng.uniform(0.1, 3, n), hkm=rng.uniform(0.1, 3, n),
             topn=rng.uniform(8, 12, n), topm=rng.uniform(6, 11, n),
             botn=rng.uniform(0, 4, n), botm=rng.uniform(1, 5, n),
             cln=rng.uniform(1, 5, n), clm=rng.uniform(1, 5, n),
             fawidth=rng.uniform(1, 9, n), condsat=rng.uniform(0.1, 4, n))
    i = dict(ibdn=rng.integers(0, 2, n), ibdm=rng.integers(0, 2, n),
             ictn=rng.integers(0, 2, n), ictm=rng.integers(0, 2, n),
             ihc=rng.choice([1, 2], n))
    j = {k: jnp.asarray(v) for k, v in {**f, **i}.items()}
    t = {k: torch.as_tensor(v) for k, v in {**f, **i}.items()}
    for iupstream in (0, 1):
        for icellavg in (0, 1, 2, 3):
            want = jcond.hcond(iupstream=iupstream, icellavg=icellavg, **j)
            got = tcond.hcond(iupstream=iupstream, icellavg=icellavg, **t)
            _close(got, want)
        names = ("ibdn", "ibdm", "ictn", "ictm", "ihc", "hn", "hm", "satn",
                 "satm", "topn", "topm", "botn", "botm")
        want = jcond.thksatnm(iupstream=iupstream, **{k: j[k] for k in names})
        got = tcond.thksatnm(iupstream=iupstream, **{k: t[k] for k in names})
        _close(got, want)


# ------------------------------------------------------- the ELL system

def _random_system(topo, seed, symmetric=False):
    rng = np.random.default_rng(seed)
    n, k = topo.nodes, topo.max_degree
    off = np.zeros(n * k)
    vals = rng.uniform(0.1, 2.0, topo.nedges)
    off[topo.slot_nm] = vals
    off[topo.slot_mn] = vals if symmetric else rng.uniform(0.1, 2.0,
                                                           topo.nedges)
    diag = -off.reshape(n, k).sum(axis=1) - rng.uniform(0.1, 1.0, n)
    return diag, off.reshape(n, k), rng.normal(size=n), rng.normal(size=n)


@pytest.mark.parametrize("name", GRIDS)
def test_spmv_matches_reference_and_scipy(name):
    topo = both_grids(name)[1].build_topology()
    diag, off, x, b = _random_system(topo, 2)
    nbr = torch.as_tensor(topo.nbr, dtype=torch.int64)
    got = system.spmv(nbr, *(torch.as_tensor(v) for v in (diag, off, x)))
    want = jsystem.spmv(*(jnp.asarray(v) for v in (topo.nbr, diag, off, x)))
    _close(got, want)
    _close(got, system.to_scipy_csr(topo, diag, off) @ x)
    dtopo = npf.DeviceTopology.from_host(topo, "cpu")
    assert dtopo.nbr.is_contiguous() and dtopo.nbr.dtype == torch.int64
    assert torch.equal(system.make_matvec(dtopo, torch.as_tensor(diag),
                                          torch.as_tensor(off))(
                                              torch.as_tensor(x)), got)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("name", ["delaunay", "passthrough", "disu"])
def test_apply_dirichlet_matches_reference(name, symmetric):
    topo = both_grids(name)[1].build_topology()
    diag, off, rhs, x = _random_system(topo, 3, symmetric=True)
    rng = np.random.default_rng(4)
    active = rng.choice([-1, 0, 1, 1, 1], topo.nodes)
    diag[rng.choice(topo.nodes, 5, replace=False)] = 0.0    # tiny diagonals
    want = jsystem.apply_dirichlet(
        jnp.asarray(topo.nbr), jnp.asarray(active),
        *(jnp.asarray(v) for v in (diag, off, rhs, x)), symmetric=symmetric)
    got = system.apply_dirichlet(
        torch.as_tensor(topo.nbr, dtype=torch.int64),
        torch.as_tensor(active), *(torch.as_tensor(v)
                                   for v in (diag, off, rhs, x)),
        symmetric=symmetric)
    for g, w in zip(got, want):
        _close(g, w)
    if symmetric:
        a = system.to_scipy_csr(topo, *got[:2])
        assert abs(a - a.T).max() == 0.0


# ------------------------------------- a DIS model on the general path

def _flagship_args(nlay=2, nrow=9, ncol=8):
    rng = np.random.default_rng(75)
    grid = dict(nlay=nlay, nrow=nrow, ncol=ncol, delr=10.0, delc=10.0,
                top=50.0, botm=np.linspace(0.0, -50.0, nlay)[:, None, None]
                * np.ones((nlay, nrow, ncol)))
    kw = dict(k=np.exp(rng.normal(0.0, 1.0, nlay * nrow * ncol)), strt=40.0,
              storage={"ss": 1e-5, "iconvert": 0},
              chd=[(i * ncol, 45.0) for i in range(nrow)]
              + [(i * ncol + ncol - 1, 35.0) for i in range(nrow)],
              wel=[((nrow // 2) * ncol + ncol // 2, -500.0)],
              rch=[(n, 1e-4) for n in range(nrow * ncol)])
    return grid, kw


def force_general(model, keep_grid_shape=False):
    """A structured DIS model of the port rebuilt on the general path: the
    full edge topology, without the grid shape unless asked to keep it."""
    topo = model.grid.build_edge_topology()
    dtopo = npf.DeviceTopology.from_host(topo, "cpu")
    zero = torch.zeros_like(model.strt)
    opts = dataclasses.replace(model.npf_opts, iangle1=int(keep_grid_shape))
    if not keep_grid_shape:
        dtopo = dataclasses.replace(dtopo, grid_shape=None)
    general = dataclasses.replace(
        model, dtopo=dtopo, topo=topo, npf_opts=opts,
        npf_arrays=dataclasses.replace(model.npf_arrays, angle1=zero,
                                       angle2=zero, angle3=zero))
    general.finalize_setup()
    assert not general.use_structured
    return general


@pytest.mark.parametrize("keep_grid_shape", [False, True])
@pytest.mark.parametrize("icelltype", [0, 1])
def test_dis_model_through_the_general_path_equals_the_structured(
        icelltype, keep_grid_shape):
    grid, kw = _flagship_args()
    kw = {**kw, "icelltype": icelltype, "k33": 0.1}
    a = build_gwf("s", DisGrid.create(**grid), device="cpu", **kw)
    b = force_general(a, keep_grid_shape)
    assert a.use_structured
    rng = np.random.default_rng(1)
    head = torch.as_tensor(40.0 + rng.normal(0, 3.0, a.nodes))
    ib, h = a.boundary_state(head)
    sa = a.assemble(h, h, ib, 5.0, False)
    sb = b.assemble(h, h, ib, 5.0, False)
    for g, w in zip(sb, sa):
        _close(g, w)
    s = ImsSettings(**ENTRY)
    ha, ka, ia, ca = make_fused_run(a, s, False, 2)(a.strt, [5.0, 5.0])
    before = launches["stencil7"]
    hb, kb, ib_, cb = make_fused_run(b, s, False, 2)(b.strt, [5.0, 5.0])
    assert all(ca) and all(cb) and ka == kb
    np.testing.assert_allclose(hb.numpy(), ha.numpy(), rtol=0, atol=1e-10)
    assert launches["stencil7"] == before   # CPU tensors: no kernel
    # flows of the output phase, in the same layouts
    cond_a, cond_b = (m.edge_conductances(ha, ib) for m in (a, b))
    for fn in ("edge_flows", "flowja_csr", "cell_inflow"):
        _close(getattr(b, fn)(ha, ib, cond_b), getattr(a, fn)(ha, ib, cond_a),
               rtol=1e-11)


# -------------------------------------------------------------- barriers

@pytest.mark.parametrize("hydchr", [1e-3, -0.25])
@pytest.mark.parametrize("kind", ["dis", "dis-angles", "disv", "disu"])
def test_hfb_condsat_equals_reference(kind, hydchr):
    if kind.startswith("dis-") or kind == "dis":
        grid, kw = _flagship_args()
        gj, gt = JaxDisGrid.create(**grid), DisGrid.create(**grid)
        kw = dict(k=kw["k"], k33=0.3, strt=40.0)
        if kind == "dis-angles":
            kw.update(k22=0.5 * kw["k"], angle1=0.4)
        topo = gj.build_topology()
    else:
        gj, gt = both_grids("brick" if kind == "disv" else "disu")
        kw = dict(k=np.exp(np.random.default_rng(2).normal(0, 1, gj.nodes)),
                  strt=20.0)
        topo = gj.build_topology()
    pick = np.nonzero(topo.ihc != 0)[0][::7][:6]
    hfb = [(int(topo.edge_m[e]), int(topo.edge_n[e]), hydchr) for e in pick]
    hfb.append(hfb[0])                    # one barrier given twice compounds
    ref = jax_build_gwf("r", gj, hfb=hfb, **kw)
    port = build_gwf("p", gt, hfb=hfb, device="cpu", **kw)
    plain = jax_build_gwf("r0", gj, **kw)
    if port.use_structured:
        # the planes hold the reference's per-edge condsat, each edge at
        # the face of its lower-numbered cell.  (The reference's own
        # planes index a barrier by the node number of that cell, which is
        # the face's position only in the first row of the first layer.)
        want = np.asarray(ref.npf_arrays.condsat)
        nlay, nrow, ncol = gt.shape
        k, rem = np.divmod(topo.edge_n, nrow * ncol)
        i, j = np.divmod(rem, ncol)
        changed = 0
        for axis, (g, g0) in enumerate(zip(port.condsat3, plain.condsat3)):
            sel = topo.direction == axis
            np.testing.assert_allclose(
                g.numpy()[k[sel], i[sel], j[sel]], want[sel], rtol=1e-14)
            changed += int((g.numpy() != np.asarray(g0)).sum())
    else:
        np.testing.assert_allclose(port.npf_arrays.condsat.numpy(),
                                   np.asarray(ref.npf_arrays.condsat),
                                   rtol=1e-14)
        changed = int((np.asarray(ref.npf_arrays.condsat)
                       != np.asarray(plain.npf_arrays.condsat)).sum())
    assert changed == len(pick)
    with pytest.raises(ValueError, match="not connected"):
        build_gwf("p", gt, hfb=[(0, gt.nodes - 1, 1.0)], device="cpu", **kw)


# ----------------------------------------------------------- whole solves

def _solve_both(ref, port, settings, nsteps=2, delt=5.0, iss=False):
    js = JaxImsSettings(**settings)
    ts = ImsSettings(**settings)
    want = jax_make_fused_run(ref, js, iss, nsteps)(
        jnp.asarray(ref.strt), jnp.full(nsteps, delt))
    got = make_fused_run(port, ts, iss, nsteps)(port.strt, [delt] * nsteps)
    return want, got


@pytest.mark.parametrize("precond", ["jacobi", "mg"])
@pytest.mark.parametrize("name", ["quad", "brick", "passthrough", "disu",
                                  "dis-angles"])
def test_general_path_cg_solve_matches_reference(name, precond):
    """Transient confined CG solves: equal counts, heads at 1e-10.  ``mg``
    on a model off the structured path is Chebyshev of order 4 in both
    packages."""
    rng = np.random.default_rng(13)
    if name == "dis-angles":
        grid, kw = _flagship_args()
        gj, gt = JaxDisGrid.create(**grid), DisGrid.create(**grid)
        n = gj.nodes
        kw = {**kw, "k22": 0.1 * kw["k"], "angle1": rng.uniform(0, 1.5, n)}
    else:
        gj, gt = both_grids(name)
        n = gj.nodes
        ncpl = n // (gj.shape[0] if len(gj.shape) > 1 else 2)
        kw = dict(k=np.exp(rng.normal(0.0, 1.0, n)), k33=0.1, strt=20.0,
                  storage={"ss": 1e-5, "iconvert": 0},
                  chd=[(c, 24.0) for c in range(0, 4)]
                  + [(ncpl - 1 - c, 18.0) for c in range(0, 4)],
                  wel=[(ncpl // 2, -30.0)],
                  rch=[(c, 1e-4) for c in range(ncpl)])
    ref = jax_build_gwf("r", gj, **kw)
    port = build_gwf("p", gt, device="cpu", **kw)
    assert not port.use_structured and not ref.use_structured
    assert port.is_linear and ref.is_linear
    want, got = _solve_both(ref, port, {**ENTRY, "preconditioner": precond})
    head, kiters, inners, convs = got
    assert all(convs) and bool(np.asarray(want[3]).all())
    assert kiters == np.asarray(want[1]).tolist()
    assert inners == np.asarray(want[2]).tolist()
    np.testing.assert_allclose(head.numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-10)
    # and within 2e-5 of a direct solve of the port's own last system
    ib, h = port.boundary_state(port.strt)
    for _ in range(2):
        diag, off, rhs = port.assemble(h, h, ib, 5.0, False)
        diag, off, rhs = system.apply_dirichlet(port.dtopo.nbr,
                                                torch.sign(ib), diag, off,
                                                rhs, h)
        h = torch.as_tensor(spla.spsolve(
            system.to_scipy_csr(port.dtopo, diag, off).tocsc(), rhs.numpy()))
    np.testing.assert_allclose(head.numpy(), h.numpy(), rtol=0, atol=2e-5)


def test_newton_disv_solve_matches_reference():
    """A steady unconfined Newton solve on the brick grid with BiCGSTAB
    through ``NumericalSolution``: both converge, heads within
    10 x outer_dvclose."""
    gj, gt = both_grids("brick")
    n, ncpl = gj.nodes, gj.ncpl
    rng = np.random.default_rng(17)
    kw = dict(k=np.exp(rng.normal(0.0, 0.5, n)), k33=0.5, strt=22.0,
              icelltype=1, newton="under_relaxation",
              chd=[(c, 24.0) for c in range(3)]
              + [(ncpl - 1 - c, 5.0) for c in range(3)],
              rch=[(c, 5e-4) for c in range(ncpl)])
    s = dict(outer_dvclose=1e-7, outer_maximum=200, inner_dvclose=1e-9,
             inner_rclose=1e-8, inner_maximum=300,
             linear_acceleration="bicgstab")
    ref = jax_build_gwf("r", gj, **kw)
    port = build_gwf("p", gt, device="cpu", **kw)
    hj, ij, _ = JaxSolution(ref, JaxImsSettings(**s)).solve_timestep(
        jnp.asarray(ref.strt), 1.0, iss=True)
    ht, it, aux = NumericalSolution(port, ImsSettings(**s)).solve_timestep(
        port.strt, 1.0, iss=True)
    assert ij.converged and it.converged
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=1e-6)
    assert aux["cond"].shape == (port.dtopo.edge_n.shape[0],)
    # the water table lies below the top of layer 1 somewhere: the Newton
    # terms were at work
    assert (ht[:ncpl] < port.npf_arrays.top[:ncpl]).any()


def test_rewetting_on_the_general_path_matches_reference():
    """The two-layer rewetting scenario on a quad DISV grid through
    ``NumericalSolution``: the same wet cells, heads within
    10 x outer_dvclose."""
    verts, cell2d = quad_mesh(1, 9)
    botm = np.zeros((2, 9))
    botm[0] = 10.0
    kwg = dict(nlay=2, ncpl=9, vertices=verts, cell2d=cell2d, top=20.0,
               botm=botm)
    wetdry = np.zeros(18)
    wetdry[:9] = 1.0
    kw = dict(k=5.0, k33=5.0, strt=5.0, icelltype=1,
              chd=[(9, 18.0), (17, 12.0)],
              rewetting=dict(wetdry=wetdry, wetfct=1.0, iwetit=1, ihdwet=0))
    s = dict(outer_dvclose=1e-8, outer_maximum=300, inner_dvclose=1e-10,
             inner_rclose=1e-9, inner_maximum=500,
             linear_acceleration="bicgstab", under_relaxation="dbd",
             theta=0.9, akappa=1e-4, gamma=0.0, amomentum=0.0)
    ref = jax_build_gwf("r", JaxDisvGrid.create(**kwg), **kw)
    port = build_gwf("p", DisvGrid.create(**kwg), device="cpu", **kw)
    hj, ij, auxj = JaxSolution(ref, JaxImsSettings(**s)).solve_timestep(
        jnp.asarray(ref.strt), 1.0, iss=True)
    ht, it, auxt = NumericalSolution(port, ImsSettings(**s)).solve_timestep(
        port.strt, 1.0, iss=True)
    assert ij.converged and it.converged
    np.testing.assert_array_equal(auxt["ibound"].numpy(),
                                  np.asarray(auxj["ibound"]))
    assert int((auxt["ibound"][:9] > 0).sum()) > 0
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=1e-7)


def test_two_runs_of_a_general_model_are_bitwise_equal():
    gt = both_grids("brick")[1]
    n, ncpl = gt.nodes, gt.ncpl
    rng = np.random.default_rng(2)
    port = build_gwf("p", gt, device="cpu", k=np.exp(rng.normal(0, 1, n)),
                     strt=20.0, icelltype=1, chd=[(0, 24.0), (ncpl - 1, 18.0)],
                     storage={"ss": 1e-5, "sy": 0.1, "iconvert": 1})
    run = make_fused_run(port, ImsSettings(**TIGHT), False, 2)
    a, b = run(port.strt, [5.0, 5.0]), run(port.strt, [5.0, 5.0])
    assert torch.equal(a[0], b[0]) and a[1:] == b[1:]
