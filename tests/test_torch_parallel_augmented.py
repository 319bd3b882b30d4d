"""The sharded augmented runner of the port
(modflow6_torch/parallel/augmented.py) against the reference
(modflow6_tpu/parallel/augmented.py, tests/test_parallel_augmented.py):
MAW, LAK and SFR rows owned by their host cells' shards, the feature
tables on every shard at one width.

The model and settings are the reference test's.  Its BiCGSTAB solves
take thousands of inner iterations a step (on one device too), so the
port runs the reference test's two-shard step here, and the four-shard
split (for the first of the reference's three steps) in
test_torch_parallel_augmented4.py; the reference's runner compiles once,
in a module fixture.  Tolerances, the reference test's
bar: 5e-7 against the reference's sharded result and the port's
single-device run; the partition tables: equal.
"""

import numpy as np
import pytest

from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf import advanced as jadv
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.parallel import augmented as ref_aug
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf import advanced
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.parallel.augmented import (ShardedAugmentedSolution,
                                               partition_augmented)
from modflow6_torch.solution import ImsSettings, NumericalSolution

TIGHT = dict(outer_dvclose=1e-9, outer_maximum=200, inner_dvclose=1e-11,
             inner_rclose=1e-10, inner_maximum=2000,
             linear_acceleration="bicgstab")


def _aug_model(adv, grid_cls, build, seed, nrow=10, ncol=12, **dev):
    rng = np.random.default_rng(seed)
    g = grid_cls.create(1, nrow, ncol, 10.0, 10.0, 20.0,
                        np.zeros((1, nrow, ncol)))
    base = build(
        "a", g, k=np.exp(rng.normal(0, 0.5, size=nrow * ncol)), strt=12.0,
        storage={"ss": 1e-4, "iconvert": 0},
        chd=[(i * ncol, 14.0) for i in range(nrow)]
        + [(i * ncol + ncol - 1, 10.0) for i in range(nrow)], **dev)
    maw = adv.build_maw([dict(radius=0.25, strt=12.0, rate=-30.0,
                              connections=[(2 * ncol + 2, 50.0)])], g)
    lakes = [dict(strt=13.2, bottom=12.4, surf_area=400.0, rainfall=8.0,
                  connections=[(4 * ncol + 5, 30.0, 12.4),
                               (4 * ncol + 6, 30.0, 12.4)]),
             dict(strt=12.8, bottom=12.2, surf_area=300.0,
                  connections=[(7 * ncol + 8, 25.0, 12.2)])]
    outlets = [dict(lake=0, to=1, type="weir", invert=13.0, width=2.0,
                    rough=0.03, slope=1e-3)]
    reaches = [dict(node=8 * ncol + j, cond=5.0, strtop=12.5 - 0.02 * j,
                    width=3.0, rough=0.03, slope=1e-3, length=10.0,
                    strt=12.8 - 0.02 * j, inflow=3.0 if j == 1 else 0.0,
                    upstream=[(j - 2, 1.0)] if j > 1 else [])
               for j in range(1, ncol - 1)]
    return adv.AugmentedGwfModel(base, maw=maw,
                                 lak=adv.build_lak(lakes, outlets),
                                 sfr=adv.build_sfr(reaches))


def _port(seed):
    return _aug_model(advanced, DisGrid, build_gwf, seed, device="cpu")


def _ref(seed):
    return _aug_model(jadv, JaxDisGrid, jax_build_gwf, seed)


@pytest.fixture(scope="module")
def reference_two_shards():
    """The reference's sharded step of its two-shard test (one compile)."""
    aug = _ref(8)
    asol = ref_aug.ShardedAugmentedSolution(
        ref_aug.partition_augmented(aug, 2), JaxImsSettings(**TIGHT))
    xs, info = asol.solve_timestep(asol.scatter(np.asarray(aug.strt)),
                                   50.0, iss=False)
    assert info["converged"]
    return asol.gather(xs)


def _run(aug, nshards, delt):
    s = ImsSettings(**TIGHT)
    x, info, _ = NumericalSolution(aug, s).solve_timestep(aug.strt, delt,
                                                          iss=False)
    assert info.converged
    asol = ShardedAugmentedSolution(partition_augmented(aug, nshards), s,
                                    devices="cpu")
    xs, sinfo = asol.solve_timestep(asol.scatter(aug.strt), delt,
                                    iss=False)
    assert sinfo["converged"]
    return x.numpy(), asol.gather(xs)


def test_sharded_augmented_two_shards(reference_two_shards):
    single, shd = _run(_port(8), 2, 50.0)
    np.testing.assert_allclose(shd, single, atol=5e-7)
    np.testing.assert_allclose(shd, reference_two_shards, atol=5e-7)


@pytest.mark.parametrize("nshards", [2, 4])
def test_augmented_tables_match_reference(nshards):
    """Feature ownership, the owned rows, the halo rounds over the
    augmented rows and the shards' table width equal the reference's."""
    ref = ref_aug.partition_augmented(_ref(4), nshards)
    apart = partition_augmented(_port(4), nshards)
    np.testing.assert_array_equal(apart.owner_feat, ref.owner_feat)
    assert apart.n_aug == ref.n_aug
    np.testing.assert_array_equal(apart.own, np.asarray(ref.own))
    np.testing.assert_array_equal(apart.part.local2global,
                                  ref.part.local2global)
    assert apart.halo_perms == ref.halo_perms
    for mine, theirs in zip(apart.halo_send + apart.halo_recv,
                            ref.halo_send + ref.halo_recv):
        np.testing.assert_array_equal(mine, np.asarray(theirs))
    asol = ShardedAugmentedSolution(apart, ImsSettings(**TIGHT),
                                    devices="cpu")
    for p, lm in enumerate(asol.models):
        np.testing.assert_array_equal(lm.dtopo.nbr.numpy(),
                                      np.asarray(ref.nbr)[p])


def test_augmented_refuses_movers():
    aug = _port(4)
    aug.mvr = object()
    with pytest.raises(NotImplementedError, match="MVR"):
        partition_augmented(aug, 2)
