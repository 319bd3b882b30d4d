"""The general (gather-based) sharded runner of the port
(modflow6_torch/parallel/general.py) against the reference
(modflow6_tpu/parallel/general.py): the partition tables (local nodes,
ownership, halo maps and shift rounds, remapped boundary lists, XT3D's
equal-width tables), the sharded solves of tests/test_parallel.py:170-278
(DIS, DISV, XT3D, a two-model composite, transient Newton), the HPC6 deck
of tests/test_mf6io_multi.py:492-530, and the solver hooks that the
sharded runners inject (``dot``/``absmax``, ``own``, ``ktot_min``), whose
defaults change no number.

The reference's general runner compiles once, in a module fixture (the
DISV case); every case holds the port's sharded heads against the port's
single-device run.  Tolerances, the reference tests' bars: heads 1e-7;
tables equal; the hooks' defaults bitwise.
"""

import os

import numpy as np
import pytest
import torch

from test_mf6io_multi import build_split_deck
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.discretization import DisvGrid as JaxDisvGrid
from modflow6_tpu.models.gwf import exchange as jexg
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.parallel import general as ref_general
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.models.discretization import DisGrid, DisvGrid
from modflow6_torch.models.gwf import exchange
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.gwf.xt3d import build_xt3d
from modflow6_torch.ops.solvers import krylov
from modflow6_torch.ops.system import (apply_dirichlet,
                                       apply_dirichlet_structured,
                                       make_matvec)
from modflow6_torch.parallel.general import (GeneralShardedSolution,
                                             owner_from_partitions,
                                             partition_general)
from modflow6_torch.solution import ImsSettings, NumericalSolution
from modflow6_torch.utils.mf6io import load_simulation

TIGHT = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-10,
             inner_rclose=1e-9, inner_maximum=2000)
BICG = dict(TIGHT, linear_acceleration="bicgstab")


def _solve_both(model, nshards, iss=True, delt=1.0, nstep=1, settings=None,
                owner=None):
    s = settings or ImsSettings(**TIGHT)
    sol = NumericalSolution(model, s)
    head = model.strt
    for k in range(nstep):
        head, info, _ = sol.solve_timestep(head, delt=delt, kstp=k + 1,
                                           iss=iss)
        assert info.converged
    gsol = GeneralShardedSolution(
        partition_general(model, nshards, owner=owner), s, devices="cpu")
    hs = gsol.scatter_heads(model.strt)
    for k in range(nstep):
        hs, sinfo = gsol.solve_timestep(hs, delt=delt, kstp=k + 1, iss=iss)
        assert sinfo["converged"]
    return head.numpy(), gsol.gather_heads(hs)


def _dis_kw(nrow=12, ncol=10, seed=3, transient=False, newton=False):
    kw = dict(
        k=np.exp(np.random.default_rng(seed).normal(0, 0.8,
                                                    size=nrow * ncol)),
        strt=8.0,
        chd=[(i * ncol, 10.0) for i in range(nrow)]
        + [(i * ncol + ncol - 1, 6.0) for i in range(nrow)],
        wel=[(nrow // 2 * ncol + ncol // 2, -40.0)],
        rch=[(n, 1e-4) for n in range(nrow * ncol)])
    if transient:
        kw["storage"] = {"ss": 1e-4, "iconvert": 0}
    if newton:
        kw.update(k=3.0, icelltype=1, newton=True)
    return kw


def _dis(cls, nrow=12, ncol=10):
    return cls.create(1, nrow, ncol, delr=10.0, delc=10.0, top=20.0,
                      botm=np.zeros((1, nrow, ncol)))


def _disv(cls, nr=6, nc=6):
    verts = [(j * 10.0, -i * 10.0) for i in range(nr + 1)
             for j in range(nc + 1)]
    cells = []
    for i in range(nr):
        for j in range(nc):
            v0 = i * (nc + 1) + j
            ids = [v0, v0 + 1, v0 + nc + 2, v0 + nc + 1]
            cells.append((sum(verts[v][0] for v in ids) / 4.0,
                          sum(verts[v][1] for v in ids) / 4.0, ids))
    return cls.create(2, nr * nc, np.asarray(verts), cells, top=20.0,
                      botm=np.stack([10.0 * np.ones(nr * nc),
                                     np.zeros(nr * nc)]))


def _disv_kw(nr=6, nc=6):
    rng = np.random.default_rng(5)
    return dict(k=np.exp(rng.normal(0, 0.6, size=2 * nr * nc)), strt=8.0,
                chd=[(i * nc, 10.0) for i in range(nr)]
                + [(i * nc + nc - 1, 6.0) for i in range(nr)],
                wel=[(nr * nc + 14, -20.0)])


def _xt3d_kw(nrow=10, ncol=8):
    rng = np.random.default_rng(11)
    return dict(k=np.exp(rng.normal(0, 0.5, size=nrow * ncol)),
                k22=np.exp(rng.normal(0, 0.5, size=nrow * ncol)),
                angle1=30.0, xt3d=1, strt=8.0,
                chd=[(i * ncol, 10.0) for i in range(nrow)]
                + [(i * ncol + ncol - 1, 6.0) for i in range(nrow)])


@pytest.fixture(scope="module")
def reference_disv():
    """The reference's general sharded DISV solve, P = 3 (one compile)."""
    model = jax_build_gwf("dv", _disv(JaxDisvGrid), **_disv_kw())
    s = JaxImsSettings(**TIGHT)
    part = ref_general.partition_general(model, 3)
    gsol = ref_general.GeneralShardedSolution(part, s)
    hs, info = gsol.solve_timestep(
        gsol.scatter_heads(np.asarray(model.strt)), delt=1.0, iss=True)
    assert info["converged"]
    return gsol.gather_heads(hs)


def test_general_sharded_disv_matches_reference(reference_disv):
    model = build_gwf("dv", _disv(DisvGrid), device="cpu", **_disv_kw())
    single, shd = _solve_both(model, 3)
    np.testing.assert_allclose(shd, reference_disv, atol=1e-7)
    np.testing.assert_allclose(shd, single, atol=1e-7)


def _tables_equal(part, ref):
    assert part.n_local == ref.n_local
    np.testing.assert_array_equal(part.local2global, ref.local2global)
    np.testing.assert_array_equal(part.own, np.asarray(ref.own))
    np.testing.assert_array_equal(part.send_idx, np.asarray(ref.send_idx))
    np.testing.assert_array_equal(part.recv_idx, np.asarray(ref.recv_idx))
    assert part.halo_perms == ref.halo_perms
    for mine, theirs in zip(part.halo_send + part.halo_recv,
                            ref.halo_send + ref.halo_recv):
        np.testing.assert_array_equal(mine, np.asarray(theirs))
    for p, (loc, g2l, eids) in enumerate(part.locals_info):
        rloc, _, reids = ref.locals_info[p]
        np.testing.assert_array_equal(loc, rloc)
        np.testing.assert_array_equal(eids, reids)
        np.testing.assert_array_equal(
            part.topos[p].edge_n, np.asarray(ref.dtopo_base.edge_n)[p])
        np.testing.assert_array_equal(
            part.topos[p].nbr, np.asarray(ref.dtopo_base.nbr)[p])
    for name, pkg in part.pkgs.items():
        r = ref.pkgs[name]
        if pkg is None:
            assert r is None
            continue
        mask = np.asarray(r.mask)
        for p in range(part.nshards):
            np.testing.assert_array_equal(pkg[p]["node"],
                                          np.asarray(r.node)[p][mask[p]])


@pytest.mark.parametrize("case", ["disv", "composite", "owner"])
def test_partition_tables_match_reference(case):
    if case == "disv":
        ref = ref_general.partition_general(
            jax_build_gwf("dv", _disv(JaxDisvGrid), **_disv_kw()), 3)
        part = partition_general(
            build_gwf("dv", _disv(DisvGrid), device="cpu", **_disv_kw()), 3)
    elif case == "composite":
        ref = ref_general.partition_general(_composite(jexg, JaxDisGrid,
                                                       jax_build_gwf), 4)
        part = partition_general(_composite(exchange, DisGrid, build_gwf,
                                            device="cpu"), 4)
    else:
        # an owner vector with a halo on both sides, and extra halo cells
        owner = np.tile(np.repeat([0, 1, 2, 1, 0], 2), 12)
        extra = {0: np.asarray([55, 3, 55, 119]), 2: np.asarray([0])}
        ref = ref_general.partition_general(
            jax_build_gwf("d", _dis(JaxDisGrid), **_dis_kw()), 3,
            owner=owner, extra_halo={p: set(v.tolist())
                                     for p, v in extra.items()})
        part = partition_general(
            build_gwf("d", _dis(DisGrid), device="cpu", **_dis_kw()), 3,
            owner=owner, extra_halo=extra)
    _tables_equal(part, ref)


def test_general_sharded_dis_matches_single():
    model = build_gwf("d", _dis(DisGrid), device="cpu", **_dis_kw())
    single, shd = _solve_both(model, 4)
    np.testing.assert_allclose(shd, single, atol=1e-7)


def test_general_sharded_xt3d_matches_single():
    """XT3D full mode with depth-2 halos; the shards' extended tables at
    one width equal the reference's."""
    kw = _xt3d_kw()
    model = build_gwf("xt", _dis(DisGrid, 10, 8), device="cpu", **kw)
    single, shd = _solve_both(model, 3, settings=ImsSettings(**BICG))
    np.testing.assert_allclose(shd, single, atol=1e-7)
    ref = ref_general.partition_general(
        jax_build_gwf("xt", _dis(JaxDisGrid, 10, 8), **kw), 3)
    gsol = GeneralShardedSolution(partition_general(model, 3),
                                  ImsSettings(**BICG), devices="cpu")
    for p, lm in enumerate(gsol.models):
        np.testing.assert_array_equal(lm.xt3d.nbr_ext.numpy(),
                                      np.asarray(ref.xt3d.nbr_ext)[p])
        np.testing.assert_array_equal(lm.system_topo.nbr.numpy(),
                                      np.asarray(ref.dtopo.nbr)[p])


def _composite(exg, grid_cls, build, **dev):
    ncol, nrow = 8, 8
    g = grid_cls.create(1, nrow, ncol, 10.0, 10.0, 20.0,
                        np.zeros((1, nrow, ncol)))
    west = build("w", g, k=2.0, strt=8.0,
                 chd=[(i * ncol, 10.0) for i in range(nrow)], **dev)
    east = build("e", g, k=4.0, strt=8.0,
                 chd=[(i * ncol + ncol - 1, 6.0) for i in range(nrow)],
                 wel=[(3 * ncol + 2, -15.0)], **dev)
    pairs = [exg.ExchangePair(i * ncol + ncol - 1, i * ncol, ihc=1, cl1=5.0,
                              cl2=5.0, hwva=10.0) for i in range(nrow)]
    return exg.merge_gwf_models([west, east],
                                [exg.GwfGwfExchange(0, 1, pairs)])


def test_general_sharded_two_model_composite():
    """Two models merged, the shard boundary across their exchange."""
    single, shd = _solve_both(_composite(exchange, DisGrid, build_gwf,
                                         device="cpu"), 4)
    np.testing.assert_allclose(shd, single, atol=1e-7)


def test_general_sharded_transient_newton():
    model = build_gwf("n", _dis(DisGrid), device="cpu",
                      **_dis_kw(transient=True, newton=True))
    s = ImsSettings(**dict(BICG, outer_maximum=200))
    single, shd = _solve_both(model, 4, iss=False, delt=0.5, nstep=3,
                              settings=s)
    np.testing.assert_allclose(shd, single, atol=1e-7)


def _hpc_deck(ws):
    build_split_deck(ws)
    nam = open(os.path.join(ws, "mfsim.nam")).read()
    with open(os.path.join(ws, "mfsim.nam"), "w") as f:
        f.write("BEGIN OPTIONS\n  HPC6 FILEIN sim.hpc\nEND OPTIONS\n" + nam)
    with open(os.path.join(ws, "sim.hpc"), "w") as f:
        f.write("BEGIN OPTIONS\nEND OPTIONS\nBEGIN PARTITIONS\n  WEST 0\n"
                "  EAST 1\nEND PARTITIONS\n")


def test_hpc_partitions_spec(tmp_path):
    """HPC6 FILEIN PARTITIONS loads as the reference's, and its owner
    vector drives a two-shard solve equal to the single-device one."""
    ws = str(tmp_path)
    _hpc_deck(ws)
    sim = load_simulation(ws, device="cpu")
    ref = ref_load(ws)
    assert sim.hpc_partitions == ref.hpc_partitions == {"WEST": 0,
                                                        "EAST": 1}
    assert sim.model_offsets == ref.model_offsets
    assert sim.model_sizes == ref.model_sizes
    owner = owner_from_partitions(sim.hpc_partitions, sim.model_offsets,
                                  sim.model_sizes, sim.model.nodes)
    np.testing.assert_array_equal(owner, ref_general.owner_from_partitions(
        ref.hpc_partitions, ref.model_offsets, ref.model_sizes,
        ref.model.nodes))
    assert set(np.unique(owner)) == {0, 1}
    s = ImsSettings(**dict(TIGHT, inner_maximum=1000))
    single, shd = _solve_both(sim.model, 2, settings=s, owner=owner)
    np.testing.assert_allclose(shd, single, atol=1e-7)


def test_hpc_refusals(tmp_path):
    """An HPC6 record without FILEIN, an option of the HPC6 file, and a
    rank beyond the shards raise by name (the reference reads past)."""
    ws = str(tmp_path)
    _hpc_deck(ws)
    path = os.path.join(ws, "sim.hpc")
    text = open(path).read()
    with open(path, "w") as f:
        f.write(text.replace("BEGIN OPTIONS\n",
                             "BEGIN OPTIONS\n  PRINT_TABLE\n"))
    with pytest.raises(NotImplementedError, match="PRINT_TABLE"):
        load_simulation(ws, device="cpu")
    with open(path, "w") as f:
        f.write(text.replace("EAST 1", "EAST 3"))
    sim = load_simulation(ws, device="cpu")
    owner = owner_from_partitions(sim.hpc_partitions, sim.model_offsets,
                                  sim.model_sizes, sim.model.nodes)
    with pytest.raises(ValueError, match="beyond the shards"):
        partition_general(sim.model, 2, owner=owner)


def test_solver_hooks_defaults_bitwise():
    """The injectable reductions, ``own`` and ``ktot_min`` change nothing
    at their defaults, bit for bit."""
    model = build_gwf("d", _dis(DisGrid), device="cpu", **_dis_kw())
    ib, head = model.boundary_state(model.strt)
    diag, off, rhs = model.assemble(head, head, ib, 1.0, True)
    active = torch.sign(ib)
    shape = model.dtopo.grid_shape
    own = torch.ones_like(ib, dtype=torch.bool)
    for sym in (True, False):
        a = apply_dirichlet_structured(shape, active, diag, off, rhs, head,
                                       symmetric=sym)
        b = apply_dirichlet_structured(shape, active, diag, off, rhs, head,
                                       symmetric=sym, own=own)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    d, o, r = apply_dirichlet_structured(shape, active, diag, off, rhs, head)
    mv = make_matvec(model.dtopo, d, o)
    pre = lambda v: v / d  # noqa: E731
    kw = dict(itmax=300, dvclose=1e-10, rclose=1e-9)
    for solver in (krylov.cg, krylov.bicgstab):
        a = solver(mv, r, head, pre, **kw)
        b = solver(mv, r, head, pre, dot=krylov.vector_dot,
                   absmax=krylov._signed_absmax, **kw)
        assert torch.equal(a.x, b.x) and a.iters == b.iters
    mv32 = lambda v: mv(v.double()).float()  # noqa: E731
    a = krylov.refined_solve(mv, mv32, r, head, lambda v: v / d.float(),
                             **kw)
    b = krylov.refined_solve(mv, mv32, r, head, lambda v: v / d.float(),
                             dot=krylov.vector_dot,
                             absmax=krylov._signed_absmax, **kw)
    assert torch.equal(a.x, b.x) and a.iters == b.iters
    # the general fixup's own mask, and XT3D's widened table
    gm = build_gwf("dv", _disv(DisvGrid), device="cpu", **_disv_kw())
    ib, head = gm.boundary_state(gm.strt)
    diag, off, rhs = gm.assemble(head, head, ib, 1.0, True)
    a = apply_dirichlet(gm.dtopo.nbr, torch.sign(ib), diag, off, rhs, head)
    b = apply_dirichlet(gm.dtopo.nbr, torch.sign(ib), diag, off, rhs, head,
                        own=torch.ones_like(ib, dtype=torch.bool))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    xm = build_gwf("xt", _dis(DisGrid, 10, 8), device="cpu", **_xt3d_kw())
    a = xm.npf_arrays
    wide = build_xt3d(xm.grid, xm.topo, a.k11, a.k22, a.k33, a.angle1,
                      ixt3d=1, device="cpu",
                      ktot_min=xm.xt3d.nbr_ext.shape[1] + 3)
    k = xm.xt3d.nbr_ext.shape[1]
    assert torch.equal(wide.nbr_ext[:, :k], xm.xt3d.nbr_ext)
    assert torch.equal(wide.nbr_ext[:, k:],
                       torch.arange(80)[:, None].expand(80, 3))
