"""The row-sharded runner of the port (modflow6_torch/parallel/partition.py
and sharded.py) against the reference (modflow6_tpu/parallel): the
partition tables, the sharded solves of tests/test_parallel.py:45-165
(P = 2 and 4, steady, transient, every boundary package with HFB, mixed
precision, Newton) and what both refuse.

The reference's sharded runner (a shard_map over 8 fake CPU devices) is
costly to compile, so it runs once, in a module fixture, and the port's
sharded heads are held against it there; every case holds the port's
sharded heads against the port's single-device run (which the earlier
parity tests hold against the reference).

Tolerances, the reference tests' bars: heads 1e-7, mixed precision 1e-6,
Newton 2e-6; the partition tables: equal arrays.
"""

import numpy as np
import pytest
import torch

from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.parallel import partition_model as ref_partition
from modflow6_tpu.parallel.sharded import ShardedSolution as RefSharded
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.parallel import ShardedSolution, partition_model
from modflow6_torch.solution import ImsSettings, NumericalSolution

TIGHT = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-10,
             inner_rclose=1e-9, inner_maximum=2000)
NEWTON = dict(TIGHT, outer_maximum=200, linear_acceleration="bicgstab")


def _model_kw(nrow=16, ncol=12, kfield=None, transient=False,
              newton=False):
    kw = dict(
        k=kfield if kfield is not None else 3.0, strt=8.0,
        chd=[(i * ncol, 10.0) for i in range(nrow)]
        + [(i * ncol + ncol - 1, 6.0) for i in range(nrow)],
        wel=[(nrow // 2 * ncol + ncol // 2, -40.0)],
        rch=[(n, 1e-4) for n in range(nrow * ncol)])
    if transient:
        kw["storage"] = {"ss": 1e-4, "iconvert": 0}
    if newton:
        kw.update(icelltype=1, newton=True)
    return kw


def _bnd_kw(nrow=16, ncol=12):
    rng = np.random.default_rng(11)
    return dict(
        k=np.exp(rng.normal(0, 0.5, size=nrow * ncol)), strt=8.0,
        storage={"ss": 1e-4, "iconvert": 0},
        chd=[(i * ncol, 10.0) for i in range(nrow)],
        wel=[(5 * ncol + 4, -30.0)],
        rch=[(n, 5e-5) for n in range(nrow * ncol)],
        drn=[(3 * ncol + 7, 7.5, 2.0), (9 * ncol + 2, 7.0, 1.5)],
        riv=[(i * ncol + ncol - 1, 6.5, 4.0, 5.0) for i in range(nrow)],
        ghb=[(12 * ncol + 6, 9.0, 0.8)],
        evt=[(n, 20.0, 1e-5, 15.0) for n in range(nrow * ncol)],
        hfb=[(6 * ncol + 3, 7 * ncol + 3, 1e-6)])


def _grid(cls, nrow=16, ncol=12):
    return cls.create(1, nrow, ncol, delr=10.0, delc=10.0, top=20.0,
                      botm=np.zeros((1, nrow, ncol)))


def _port(kw, nrow=16, ncol=12):
    return build_gwf("par", _grid(DisGrid, nrow, ncol), device="cpu", **kw)


def _single(model, settings, steps, iss):
    sol = NumericalSolution(model, settings)
    head = model.strt
    for kstp, delt in enumerate(steps, start=1):
        head, info, _ = sol.solve_timestep(head, delt=delt, kstp=kstp,
                                           iss=iss)
        assert info.converged
    return head.numpy()


def _sharded(model, nshards, settings, steps, iss):
    ssol = ShardedSolution(partition_model(model, nshards), settings,
                           devices="cpu")
    hs = ssol.scatter_heads(model.strt)
    for kstp, delt in enumerate(steps, start=1):
        hs, info = ssol.solve_timestep(hs, delt=delt, kstp=kstp, iss=iss)
        assert info["converged"]
    return ssol.gather_heads(hs)


def _kfield():
    return np.exp(np.random.default_rng(7).normal(0, 0.8, size=16 * 12))


@pytest.fixture(scope="module")
def reference_sharded():
    """The reference's row-sharded steady solve, P = 4 (one compile)."""
    model = jax_build_gwf("par", _grid(JaxDisGrid),
                          **_model_kw(kfield=_kfield()))
    ssol = RefSharded(ref_partition(model, 4), JaxImsSettings(**TIGHT))
    hs, info = ssol.solve_timestep(ssol.scatter_heads(
        np.asarray(model.strt)), delt=1.0, iss=True)
    assert info["converged"]
    return ssol.gather_heads(hs)


def test_sharded_matches_reference_sharded(reference_sharded):
    model = _port(_model_kw(kfield=_kfield()))
    shd = _sharded(model, 4, ImsSettings(**TIGHT), [1.0], True)
    np.testing.assert_allclose(shd, reference_sharded, atol=1e-7)


@pytest.mark.parametrize("nshards", [2, 4])
def test_partition_tables_match_reference(nshards):
    kw = _bnd_kw()
    ref = ref_partition(jax_build_gwf("b", _grid(JaxDisGrid), **kw),
                        nshards)
    part = partition_model(_port(kw), nshards)
    np.testing.assert_array_equal(part.own_mask, ref.own_mask)
    for f, v in part.npf_arrays.items():
        if v is not None:
            np.testing.assert_array_equal(
                v, np.asarray(getattr(ref.npf_arrays, f)), err_msg=f)
    for f, v in part.sto_arrays.items():
        np.testing.assert_array_equal(
            v, np.asarray(getattr(ref.sto_arrays, f)), err_msg=f)
    for name in ("ibound0", "strt", "area"):
        np.testing.assert_array_equal(getattr(part, name),
                                      np.asarray(getattr(ref, name)))
    for mine, theirs in zip(part.condsat3, ref.condsat3):
        np.testing.assert_allclose(mine, np.asarray(theirs), rtol=1e-14)
    for name, fields in (("chd", ["head"]), ("wel", ["q"]),
                         ("rch", ["recharge"]), ("drn", ["elev", "cond"]),
                         ("riv", ["stage", "cond", "rbot"]),
                         ("ghb", ["bhead", "cond"]),
                         ("evt", ["surface", "rate", "depth"])):
        r = getattr(ref, name)
        mask = np.asarray(r.mask)
        for p in range(nshards):
            mine = part.pkgs[name][p]
            np.testing.assert_array_equal(
                mine["node"], np.asarray(r.node)[p][mask[p]])
            for f in fields:
                np.testing.assert_array_equal(
                    mine[f], np.asarray(getattr(r, f))[p][mask[p]])


@pytest.mark.parametrize("nshards", [2, 4])
def test_sharded_steady_matches_single(nshards):
    model = _port(_model_kw(kfield=_kfield()))
    s = ImsSettings(**TIGHT)
    np.testing.assert_allclose(_sharded(model, nshards, s, [1.0], True),
                               _single(model, s, [1.0], True), atol=1e-7)


def test_sharded_transient_matches_single():
    model = _port(_model_kw(transient=True))
    s = ImsSettings(**TIGHT)
    steps = [0.5, 1.0, 2.0]
    np.testing.assert_allclose(_sharded(model, 4, s, steps, False),
                               _single(model, s, steps, False), atol=1e-7)


def test_sharded_all_bnd_packages_match():
    """DRN/RIV/GHB/EVT and HFB through the sliced planes."""
    model = _port(_bnd_kw())
    s = ImsSettings(**TIGHT)
    steps = [0.5, 2.0]
    np.testing.assert_allclose(_sharded(model, 4, s, steps, False),
                               _single(model, s, steps, False), atol=1e-7)


@pytest.mark.parametrize("preconditioner", ["jacobi", "mg"])
def test_sharded_mixed_precision_matches(preconditioner):
    """f32 Krylov + f64 refinement over the shards against the f64
    single-device solve; per shard MG becomes Chebyshev."""
    model = _port(_model_kw(kfield=np.exp(np.random.default_rng(3).normal(
        0, 0.8, size=16 * 12))))
    mixed = ImsSettings(**TIGHT, precision="mixed",
                        preconditioner=preconditioner)
    np.testing.assert_allclose(
        _sharded(model, 4, mixed, [1.0], True),
        _single(model, ImsSettings(**TIGHT), [1.0], True), atol=1e-6)


def test_sharded_newton_matches_single():
    model = _port(_model_kw(newton=True))
    s = ImsSettings(**NEWTON)
    np.testing.assert_allclose(_sharded(model, 2, s, [1.0], True),
                               _single(model, s, [1.0], True), atol=2e-6)


def test_halo_rows_follow_their_owners():
    """After an exchange each shard's halo rows hold the neighbours' owned
    rows, and rows outside the domain are zero."""
    model = _port(_model_kw())
    ssol = ShardedSolution(partition_model(model, 4), ImsSettings(**TIGHT),
                           devices=["cpu"] * 4)
    glob = torch.arange(16 * 12, dtype=torch.float64)
    hs = ssol._halo_exchange(ssol.scatter_heads(glob) * 0.0
                             + ssol.scatter_heads(glob))
    x = np.stack([t.numpy() for t in hs.parts]).reshape(4, 1, 6, 12)
    np.testing.assert_array_equal(x[0, 0, 0], 0.0)
    np.testing.assert_array_equal(x[-1, 0, -1], 0.0)
    g = glob.numpy().reshape(16, 12)
    for p in range(1, 4):
        np.testing.assert_array_equal(x[p, 0, 0], g[4 * p - 1])
        np.testing.assert_array_equal(x[p - 1, 0, -1], g[4 * p])


def test_partition_rejects_unsupported():
    """What the row runner does not carry fails loudly, by name."""
    g = _grid(DisGrid, 8, 6)
    with pytest.raises(NotImplementedError, match="XT3D"):
        partition_model(build_gwf("x", g, k=1.0, strt=8.0, xt3d=1,
                                  chd=[(0, 10.0), (47, 6.0)], device="cpu"),
                        2)
    with pytest.raises(NotImplementedError, match="BUY"):
        partition_model(build_gwf("b", g, k=1.0, strt=8.0,
                                  buy=dict(drhodc=0.7),
                                  chd=[(0, 10.0), (47, 6.0)], device="cpu"),
                        2)
    with pytest.raises(NotImplementedError, match="rewetting"):
        partition_model(build_gwf("w", g, k=1.0, strt=8.0, icelltype=1,
                                  rewetting=dict(wetdry=0.5),
                                  chd=[(0, 10.0), (47, 6.0)], device="cpu"),
                        2)
    model = build_gwf("m", g, k=1.0, strt=8.0, chd=[(0, 10.0), (47, 6.0)],
                      device="cpu")
    with pytest.raises(NotImplementedError, match="UNDER_RELAXATION"):
        ShardedSolution(partition_model(model, 2),
                        ImsSettings(under_relaxation="dbd"), devices="cpu")
    with pytest.raises(ValueError, match="divide"):
        partition_model(build_gwf("m", _grid(DisGrid, 9, 6), k=1.0,
                                  strt=8.0, device="cpu"), 2)
