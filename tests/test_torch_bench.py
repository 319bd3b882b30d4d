"""The port's benchmark entry (modflow6_torch/bench.py) against the
reference's ``bench.py``: the output line, the fused run's counts and
heads, and the scipy baseline's matrix.

The reference's model and settings are those of ``bench.build``
(bench.py:26-53), built here from their arguments: ``bench.build`` also
points JAX's persistent compilation cache at a fixed directory.

Tolerances: in ``f64`` equal inner counts and heads within 1e-10 (the
f64 bar of tests/test_torch_solve.py); in ``mixed`` equal counts and heads
within 5e-8 (see the test); the baseline's CSR matrix, rhs and start
within 1e-12 of the largest entry.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import flagship_args, reference_in_torch_sum_order
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.ops.system import apply_dirichlet as jax_apply_dirichlet
from modflow6_tpu.ops.system import to_scipy_csr as jax_to_scipy_csr
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution.fused import make_fused_run as jax_fused_run
from modflow6_torch import bench

SHAPE = (1, 24, 24)
STEPS = 2
ARGV = ["--device", "cpu", "--nlay", "1", "--nrow", "24", "--ncol", "24",
        "--steps", str(STEPS)]
# the IMS settings of bench.py:50-52
REFERENCE_SETTINGS = dict(outer_dvclose=1e-5, outer_maximum=50,
                          inner_dvclose=1e-7, inner_rclose=1e-5,
                          inner_maximum=400)
# the mixed run's bar on the heads.  Readings on the CPU: the port
# against the reference op by op in the port's sum order is 1.10e-8 at
# 1 x 24 x 24, and 1.21e-8, 2.36e-8, 6.61e-9, 4.38e-8 at 1 x 20 x 20,
# 1 x 28 x 28, 2 x 16 x 16, 1 x 32 x 32; the same run in float32
# throughout (the reference built and run with x64 off) is 7.87e-5 from
# it at 1 x 24 x 24 and does not converge.
MIXED_ATOL = 5e-8


@pytest.fixture(scope="module")
def reference():
    """The reference's bench model (one build: the precisions differ only
    in the settings)."""
    grid, kw = flagship_args(*SHAPE)
    return jax_build_gwf("bench", JaxDisGrid.create(**grid), **kw)


def _reference_run(reference, precision, monkeypatch=None):
    """The reference's run, jitted; with ``monkeypatch``, op by op with its
    sums taken in the port's order."""
    model = reference
    settings = JaxImsSettings(**REFERENCE_SETTINGS, precision=precision)
    run = jax_fused_run(model, settings, iss=False, nsteps=STEPS)
    args = (jnp.asarray(model.strt), jnp.asarray(np.full(STEPS, 5.0)))
    if monkeypatch is None:
        head, _, inners, convs = jax.jit(run)(*args)
    else:
        reference_in_torch_sum_order(monkeypatch)
        with jax.disable_jit():
            head, _, inners, convs = run(*args)
    assert bool(np.asarray(convs).all())
    return np.asarray(head), [int(i) for i in np.asarray(inners)]


def _port_main(capsys, *extra):
    out = bench.main(ARGV + list(extra))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "ims_cell_iters_per_s"
    assert line["unit"] == "cell-iter/s"
    assert all(out["convs"]) and out["inner_total"] == sum(out["inners"])
    return out, line


def test_bench_run_matches_reference_f64(capsys, reference):
    out, line = _port_main(capsys, "--precision", "f64")
    assert line["value"] > 0 and line["vs_baseline"] > 0
    head, inners = _reference_run(reference, "f64")
    assert out["inners"] == inners
    np.testing.assert_allclose(out["head"].numpy(), head, rtol=0,
                               atol=1e-10)


def test_bench_run_matches_reference_mixed(capsys, monkeypatch, reference):
    """At the bench closures (inner_dvclose 1e-7) the order of the float32
    sums alone moves the reference's own counts (jitted: 131 inner
    iterations in step 1; op by op in the port's sum order: 129) and its
    heads by ~1e-8.  So the port is held to the reference run op by op in
    its sum order: equal counts, and heads within ``MIXED_ATOL``, set from
    the readings listed there: above the port's on every shape tried,
    below the float32 control's by three orders, and below the 1e-7
    mixed-against-f64 bar of tests/test_fused.py:67-79."""
    out, line = _port_main(capsys, "--precision", "mixed")
    assert line["value"] > 0 and line["vs_baseline"] > 0
    head, inners = _reference_run(reference, "mixed", monkeypatch)
    assert out["inners"] == inners
    np.testing.assert_allclose(out["head"].numpy(), head, rtol=0,
                               atol=MIXED_ATOL)


def test_skip_baseline_prints_zero(capsys):
    _, line = _port_main(capsys, "--skip-baseline")
    assert line["vs_baseline"] == 0.0


def test_baseline_matrix_matches_reference(reference):
    """The first system that the baseline iterates on: the reference's
    (bench.py:70-77, jitted as there) against the port's host copy."""
    model = reference

    def prep(head):
        ib, h = model.boundary_state(head)
        diag, off, rhs = model.assemble(h, h, ib, 1.0, False)
        active = jnp.where(ib > 0, 1, jnp.where(ib < 0, -1, 0))
        return (*jax_apply_dirichlet(model.dtopo.nbr, active, diag, off,
                                     rhs, h), h)

    diag, off, rhs, h = jax.jit(prep)(jnp.asarray(np.asarray(model.strt)))
    want = jax_to_scipy_csr(model.topo, np.asarray(diag),
                            np.asarray(off)).tocsr()
    amat, b, x = bench.host_system(bench.build(*SHAPE, device="cpu")[0])
    assert amat.shape == want.shape
    scale = abs(want).max()
    assert abs(amat - want).max() <= 1e-12 * scale
    np.testing.assert_allclose(b, np.asarray(rhs), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(rhs)).max())
    np.testing.assert_array_equal(x, np.asarray(h))
