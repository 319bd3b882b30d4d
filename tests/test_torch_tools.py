"""The port's studies (modflow6_torch/tools/) against the reference's
``tools/iteration_study.py`` and ``tools/halo_study.py``.  (That they, and
``bench`` and ``entry``, import without JAX is held by
tests/test_torch_solve.py::test_port_runs_without_jax, which imports every
module of the package where JAX cannot be imported.)

Tolerances: the iteration counts equal (f64 runs, whose reductions differ
only at rounding; scipy's ILU(0)-BiCGSTAB on systems equal to 1e-12); the
halo structure equal.
"""

import jax
import numpy as np
import pytest

import tools.iteration_study as ref_study
from test_torch_parity import flagship_args
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.parallel.general import \
    partition_general as ref_partition_general
from modflow6_torch.bench import flagship
from modflow6_torch.parallel.general import partition_general
from modflow6_torch.tools import halo_study, iteration_study

SHAPE = (1, 25, 25)


def reference_flagship(name, shape):
    """The model of the reference's ``tools/iteration_study.build`` (and
    ``halo_study``), built from its arguments: ``build`` also points JAX's
    persistent compilation cache at a fixed directory."""
    grid, kw = flagship_args(*shape)
    return jax_build_gwf(name, JaxDisGrid.create(**grid), **kw)


@pytest.fixture(scope="module")
def models():
    return (reference_flagship("study", SHAPE),
            iteration_study.build(*SHAPE, device="cpu"))


@pytest.mark.parametrize("precond", ["jacobi", "mg"])
def test_card_case_counts_match_reference(models, precond):
    ref, port = models
    want = ref_study.tpu_case(ref, precond, "f64")
    got = iteration_study.card_case(port, precond, "f64")
    assert want["conv"] and got["conv"]
    assert got["inner"] == want["inner"]


def test_scipy_ilu_case_matches_reference(models, monkeypatch):
    ref, port = models
    # the reference's assembly jitted (op by op it takes seconds here)
    monkeypatch.setattr(ref, "assemble",
                        jax.jit(ref.assemble, static_argnums=(3, 4)))
    want = ref_study.scipy_ilu_case(ref)
    got = iteration_study.scipy_ilu_case(port)
    assert want["conv"] and got["conv"]
    assert got["inner"] == want["inner"]


def test_halo_structure_matches_reference():
    """1 x 32 x 32 on 4 shards: the shift rounds and their slots, and the
    all-pairs volume of ``send_idx``, as the reference's partition has
    them (the reference's halo_study prints the same numbers)."""
    ref = ref_partition_general(reference_flagship("halo", (1, 32, 32)),
                                4)
    part = partition_general(flagship(1, 32, 32, "cpu"), 4)
    got = halo_study.halo_structure(part)
    assert got == halo_study.halo_structure(ref)
    assert got["shifts"] == len(ref.halo_send) > 0
    assert got["slots_allpairs"] == 3 * int(np.shape(ref.send_idx)[2])
    assert part.recv_idx.shape == np.shape(ref.recv_idx)
