"""The assembled linear system: (diag[N], off[N, K]) over a static
neighbour table, its products and the Dirichlet fixups.

Port of modflow6_tpu/ops/system.py: ``spmv`` (the ELL gather product),
``spmv_structured`` (in ops.stencil), ``make_matvec``, ``to_scipy_csr``,
``apply_dirichlet`` and ``apply_dirichlet_structured`` (with ``own``, the
sharded runners' owned-row mask).  Padded ELL slots point
at their own row and must carry coefficient 0.

The gather product is plain PyTorch in the reference's XLA code too and
has no kernel: the same code runs on the card and on the CPU.  The
structured product goes through the stencil kernel on a CUDA tensor (see
ops.stencil.bind_stencil7).
"""

from __future__ import annotations

import numpy as np
import torch

from .stencil import bind_stencil7, shifted, spmv_structured

__all__ = ["apply_dirichlet", "apply_dirichlet_structured", "make_matvec",
           "spmv", "spmv_structured", "to_scipy_csr"]

# (axis, offset) of the neighbour in each slot [E, W, N, S, U, D]
_SLOTS = ((2, +1), (2, -1), (1, -1), (1, +1), (0, -1), (0, +1))


def spmv(nbr, diag, off, x):
    """y = A @ x for the ELL matrix (equivalent role: SPARSKIT amux):
    K gathers and multiply-adds per row."""
    return diag * x + torch.sum(off * x[nbr], dim=1)


def make_matvec(dtopo, diag, off):
    """A·v for the topology.  With a grid shape (a DIS grid, whichever way
    it was assembled): the stencil kernel on CUDA tensors, the plain
    version on CPU tensors (see ops.stencil.bind_stencil7).  Without one:
    the gather product over the neighbour table, which carries its system
    as ``matvec.ell = (nbr, diag, off)``."""
    if dtopo.grid_shape is not None:
        return bind_stencil7(dtopo.grid_shape, diag, off)
    nbr = dtopo.nbr

    def matvec(v):
        return spmv(nbr, diag, off, v)

    # the system, which marks the product for krylov.bicgstab's fused path
    matvec.ell = (nbr, diag, off)
    return matvec


def to_scipy_csr(topo, diag, off):
    """Export to scipy CSR (host, tests/debug only); ``topo`` is the host
    Topology or the DeviceTopology."""
    import scipy.sparse as sp

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    nbr = host(topo.nbr)
    N, K = nbr.shape
    rows = np.repeat(np.arange(N), K)
    mat = sp.coo_matrix((host(off).reshape(-1), (rows, nbr.reshape(-1))),
                        shape=(N, N)).tocsr()
    return mat + sp.diags(host(diag))


def apply_dirichlet(nbr, active, diag, off, rhs, x, symmetric=True,
                    own=None):
    """Row/column fixups before the linear solve over the neighbour table
    (reference sln_ls NumericalSolution.f90:2404-2475); see
    :func:`apply_dirichlet_structured` for the rules and ``own``.  With
    ``symmetric`` the coefficients that couple an active row to a Dirichlet
    column are found by gathering the neighbours' activity."""
    is_active = active > 0
    row_active = is_active if own is None else is_active & own

    tiny = row_active & (diag.abs() < 1.0e-15)
    diag = torch.where(tiny, -1.0, diag)
    rhs = torch.where(tiny, rhs - x, rhs)

    diag = torch.where(row_active, diag, 1.0)
    off = torch.where(row_active[:, None], off, 0.0)
    rhs = torch.where(row_active, rhs, x)

    if symmetric:
        move = row_active[:, None] & ~is_active[nbr]
        rhs = rhs - torch.sum(torch.where(move, off * x[nbr], 0.0), dim=1)
        off = torch.where(move, 0.0, off)
    return diag, off, rhs


def apply_dirichlet_structured(shape, active, diag, off, rhs, x,
                               symmetric=True, own=None):
    """Row/column fixups before the linear solve (reference sln_ls
    NumericalSolution.f90:2404-2475):

    - active rows with a tiny diagonal get diag=-1 and rhs -= x;
    - inactive / Dirichlet rows (active <= 0) become identity rows with
      rhs = x;
    - with ``symmetric`` (the CG path), coefficients coupling an active
      row to a Dirichlet column move to the rhs and are zeroed, so the
      matrix stays symmetric; BiCGSTAB leaves them in the matrix, where
      the identity row of the Dirichlet cell gives the same solution;
    - ``own`` (the sharded runners): rows outside the shard's owned block
      (its halo copies) become identity rows too, since their equations
      live on the neighbouring shard, while their columns stay, as their
      values arrive by the halo exchange before each product (the
      reference's interface-model mask, Connections.f90:28).
    """
    is_active = active > 0
    row_active = is_active if own is None else is_active & own

    tiny = row_active & (diag.abs() < 1.0e-15)
    diag = torch.where(tiny, -1.0, diag)
    rhs = torch.where(tiny, rhs - x, rhs)

    diag = torch.where(row_active, diag, 1.0)
    off = torch.where(row_active[:, None], off, 0.0)
    rhs = torch.where(row_active, rhs, x)
    if not symmetric:
        return diag, off, rhs

    nlay, nrow, ncol = shape
    row3 = row_active.reshape(shape)
    act3 = is_active.reshape(shape)
    x3 = x.reshape(shape)
    c = off.reshape(nlay, nrow, ncol, 6).clone()
    moves = []
    for slot, (axis, d) in enumerate(_SLOTS):
        move = row3 & ~shifted(act3, axis, d, True)
        xn = shifted(x3, axis, d, 0.0)
        moves.append(torch.where(move, c[..., slot] * xn, 0.0))
        c[..., slot] = torch.where(move, 0.0, c[..., slot])
    rhs = rhs - sum(moves).reshape(-1)
    return diag, c.reshape(-1, 6), rhs
