"""``fused_cg_share``: the program's ``pcg_jacobi`` launches (four an
iteration) over the window's inner iterations, at a small grid on the CPU
(where ``cg`` runs its plain loop, so the share reads 0)."""

import pytest

from perfbench import run
from perfbench.tests.helpers import run_small


class _Rec:
    outer, inner = 3, 40

    def __init__(self, counters):
        self.counters = counters


@pytest.mark.parametrize("workload", ["npf-jacobi-replay"])
def test_fused_cg_share_on_the_cpu(workload):
    res = run_small(workload, trace=True)
    assert res["correct"], res["compared"]
    assert res["metrics"]["fused_cg_share"]["value"] == 0.0


def test_fused_cg_share_reads_the_counter():
    reader = run.Bench().reader("fused_cg_share")
    steps = [(0.1, True, _Rec(dict(launches={"pcg_jacobi": 160,
                                              "stencil7": 41}))),
             (0.1, True, _Rec(dict(launches={"pcg_jacobi": 80})))]
    assert reader.read(dict(steps=steps)) == 0.75
    # records without the launch counter: nothing to read, and no error
    assert reader.read(dict(steps=[(0.1, True, _Rec({}))])) is None


def test_fused_cg_share_without_the_kernels(monkeypatch):
    """A program that has no fused Jacobi-CG kernels (the module is not
    there) gives nothing to read, whatever its records hold."""
    reader = run.Bench().reader("fused_cg_share")
    monkeypatch.setattr(reader, "KERNELS", "modflow6_torch.no_such_module")
    steps = [(0.1, True, _Rec(dict(launches={"stencil7": 40})))]
    assert reader.read(dict(steps=steps)) is None
