"""The yardstick: the card's peaks and the least bytes a kernel has to move.

Bytes count each input read once and each output written once, at the
least layout the operation needs, so that a later kernel with a leaner
layout still reads under 100 % of its bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB: HBM3 bandwidth from the data sheet, bytes/s
HBM_BYTES_PER_S = 3.35e12


def stencil7_bytes(shape, element_size):
    """One symmetric 7-point product y = A x on an (nlay, nrow, ncol) grid:
    x, y, the diagonal and one face plane (east, south, down) for each axis
    along which cells have neighbours, each of one value a cell."""
    n = shape[0] * shape[1] * shape[2]
    faces = sum(1 for d in shape if d > 1)
    return (3 + faces) * n * element_size


def bound_s(nbytes):
    """The least time the card could take to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S
