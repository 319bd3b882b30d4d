"""The assembled structured system: 7-point SpMV and the Dirichlet fixups.

Port of the structured parts of modflow6_tpu/ops/system.py
(``spmv_structured``, ``make_matvec``, ``apply_dirichlet_structured``).
The ELL ``spmv``, ``apply_dirichlet`` and ``residual`` belong to the
unstructured slice and are not ported yet.
"""

from __future__ import annotations

import torch

from .stencil import bind_stencil7, shifted, spmv_structured

__all__ = ["apply_dirichlet_structured", "make_matvec", "spmv_structured"]

# (axis, offset) of the neighbour in each slot [E, W, N, S, U, D]
_SLOTS = ((2, +1), (2, -1), (1, -1), (1, +1), (0, -1), (0, +1))


def make_matvec(dtopo, diag, off):
    """A·v for the structured system: the stencil kernel on CUDA tensors,
    the plain version on CPU tensors (see ops.stencil.bind_stencil7)."""
    return bind_stencil7(dtopo.grid_shape, diag, off)


def apply_dirichlet_structured(shape, active, diag, off, rhs, x,
                               symmetric=True):
    """Row/column fixups before the linear solve (reference sln_ls
    NumericalSolution.f90:2404-2475):

    - active rows with a tiny diagonal get diag=-1 and rhs -= x;
    - inactive / Dirichlet rows (active <= 0) become identity rows with
      rhs = x;
    - with ``symmetric`` (the CG path), coefficients coupling an active
      row to a Dirichlet column move to the rhs and are zeroed, so the
      matrix stays symmetric; BiCGSTAB leaves them in the matrix, where
      the identity row of the Dirichlet cell gives the same solution.
    """
    row_active = active > 0

    tiny = row_active & (diag.abs() < 1.0e-15)
    diag = torch.where(tiny, -1.0, diag)
    rhs = torch.where(tiny, rhs - x, rhs)

    diag = torch.where(row_active, diag, 1.0)
    off = torch.where(row_active[:, None], off, 0.0)
    rhs = torch.where(row_active, rhs, x)
    if not symmetric:
        return diag, off, rhs

    nlay, nrow, ncol = shape
    act3 = row_active.reshape(shape)
    x3 = x.reshape(shape)
    c = off.reshape(nlay, nrow, ncol, 6).clone()
    moves = []
    for slot, (axis, d) in enumerate(_SLOTS):
        move = act3 & ~shifted(act3, axis, d, True)
        xn = shifted(x3, axis, d, 0.0)
        moves.append(torch.where(move, c[..., slot] * xn, 0.0))
        c[..., slot] = torch.where(move, 0.0, c[..., slot])
    rhs = rhs - sum(moves).reshape(-1)
    return diag, c.reshape(-1, 6), rhs
