"""The byte count of the roofline, against values worked out by hand."""

from perfbench import yardstick


def test_stencil7_bytes():
    # 1 x 2048 x 2048 cells, f64: x, y, diag and the east and south planes
    assert yardstick.stencil7_bytes((1, 2048, 2048), 8) == 167_772_160
    # 4 x 1024 x 1024 cells, f64: the down plane besides
    assert yardstick.stencil7_bytes((4, 1024, 1024), 8) == 201_326_592
    # one row of 10 cells, f32: x, y, diag and the east plane
    assert yardstick.stencil7_bytes((1, 1, 10), 4) == 160


def test_bound_seconds():
    assert abs(yardstick.bound_s(3.35e12) - 1.0) < 1e-15
    # the stencil bound at the benchmark's size: 50.08 us
    assert abs(yardstick.bound_s(167_772_160) - 5.008124e-05) < 1e-10
