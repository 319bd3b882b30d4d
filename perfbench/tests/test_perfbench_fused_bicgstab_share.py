"""``fused_bicgstab_share``: the program's ``bicgstab_ell`` launches (six
an iteration) over the window's transport inner iterations (the
``transport_inner`` count)."""

from perfbench import run


class _Rec:
    outer, inner = 3, 40

    def __init__(self, counters):
        self.counters = counters


def test_fused_bicgstab_share_reads_the_counter():
    reader = run.Bench().reader("fused_bicgstab_share")
    steps = [(0.1, True, _Rec(dict(launches={"bicgstab_ell": 240},
                                   transport_inner=50))),
             (0.1, True, _Rec(dict(launches={"stencil7": 80},
                                   transport_inner=30)))]
    assert reader.read(dict(steps=steps)) == 0.5
    # records without the launch counter: nothing to read, and no error
    assert reader.read(dict(steps=[(0.1, True, _Rec({}))])) is None
    # launches but no transport: nothing to read
    steps = [(0.1, True, _Rec(dict(launches={"stencil7": 80})))]
    assert reader.read(dict(steps=steps)) is None


def test_fused_bicgstab_share_without_the_kernels(monkeypatch):
    """A program that has no fused Jacobi-BiCGSTAB kernels (the module is
    not there) gives nothing to read, whatever its records hold."""
    reader = run.Bench().reader("fused_bicgstab_share")
    monkeypatch.setattr(reader, "KERNELS", "modflow6_torch.no_such_module")
    steps = [(0.1, True, _Rec(dict(launches={"bicgstab_ell": 60},
                                   transport_inner=10)))]
    assert reader.read(dict(steps=steps)) is None


def test_the_cell_lists_the_share():
    bench = run.Bench()
    names = [m["name"] for m in bench.metrics("henry-buy-mg-replay", True)]
    assert "fused_bicgstab_share" in names
    assert "fused_bicgstab_share" not in [
        m["name"] for m in bench.metrics("npf-jacobi-replay", True)]
