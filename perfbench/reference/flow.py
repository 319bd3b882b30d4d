"""Confined groundwater flow on a DIS grid in plain PyTorch: NPF with
harmonic-mean conductances between cell centres, STO (specific storage of
confined cells), CHD and WEL, the IMS fixup of constant-head rows and
columns, and the Picard and CG solves of ``krylov``.

Arrays are dense (nlay, nrow, ncol) planes.  The matrix of a step is its
diagonal and six coefficient planes, in the order east, west, north,
south, up, down; a coefficient across the grid's border is 0.  Written
from MODFLOW 6's documented equations (gwf-npf.f90 calc_condsat and
npf_fc, gwf-sto.f90 sto_fc, NumericalSolution.f90 sln_ls), independent of
the program it checks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import krylov

# neighbour value in each slot: (axis, offset)
SLOTS = ((2, 1), (2, -1), (1, -1), (1, 1), (0, -1), (0, 1))


def shift(a, axis, d, fill=0.0):
    """The value of each cell's neighbour at offset ``d`` along ``axis``;
    ``fill`` beyond the border."""
    out = torch.full_like(a, fill)
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    if d == 1:
        src[axis], dst[axis] = slice(1, None), slice(None, -1)
    else:
        src[axis], dst[axis] = slice(None, -1), slice(1, None)
    out[tuple(dst)] = a[tuple(src)]
    return out


def matvec_planes(diag, coef):
    """x -> A x for the diagonal and the six coefficient planes."""
    def apply(x):
        y = diag * x
        for c, (axis, d) in zip(coef, SLOTS):
            y = y + c * shift(x, axis, d)
        return y
    return apply


def faces_to_slots(fx, fy, fz):
    """The six coefficient planes [E, W, N, S, U, D] of a symmetric
    coupling given on the x, y and z faces."""
    return (F.pad(fx, (0, 1)), F.pad(fx, (1, 0)),
            F.pad(fy, (0, 0, 1, 0)), F.pad(fy, (0, 0, 0, 1)),
            F.pad(fz, (0, 0, 0, 0, 1, 0)), F.pad(fz, (0, 0, 0, 0, 0, 1)))


class ConfinedFlow:
    """The flow model of a configuration's inputs (``inputs.FlowInputs``)
    on ``device`` in ``dtype``."""

    def __init__(self, inp, device, dtype=torch.float64):
        self.shape = shape = inp.shape
        self.dtype, self.device = dtype, device

        def plane(a):
            a = torch.as_tensor(a, dtype=torch.float64,
                                device=device).to(dtype)
            return a.expand(shape) if a.dim() == 0 else a.reshape(shape)

        self.top, self.bot = plane(inp.top), plane(inp.bot)
        self.thick = self.top - self.bot
        delr = torch.as_tensor(inp.delr, device=device).to(dtype)
        delc = torch.as_tensor(inp.delc, device=device).to(dtype)
        self.delr, self.delc = delr, delc
        self.area = (delc[:, None] * delr[None, :])[None].expand(shape)
        k = plane(inp.k)
        t = k * self.thick
        # harmonic mean of the two half-cell transmissivities over the
        # distance between the centres (MODFLOW 6's CONDUCTANCE default)
        hx = 0.5 * delr
        t1, t2 = t[:, :, :-1], t[:, :, 1:]
        self.cx = torch.where(
            t1 * t2 > 0, delc[None, :, None] * t1 * t2
            / (t1 * hx[None, None, 1:] + t2 * hx[None, None, :-1]), 0.0)
        hy = 0.5 * delc
        t1, t2 = t[:, :-1, :], t[:, 1:, :]
        self.cy = torch.where(
            t1 * t2 > 0, delr[None, None, :] * t1 * t2
            / (t1 * hy[None, 1:, None] + t2 * hy[None, :-1, None]), 0.0)
        bovk = self.thick * 0.5 / k
        self.cz = self.area[:-1] / (bovk[:-1] + bovk[1:])
        self.ss = plane(inp.ss)
        n = self.top.numel()
        self.fixed = torch.zeros(n, dtype=torch.bool, device=device)
        self.fixed[torch.as_tensor(inp.chd_node, device=device)] = True
        self.fixed = self.fixed.reshape(shape)
        self.chd_node = torch.as_tensor(inp.chd_node, device=device)
        self.chd_head = torch.as_tensor(inp.chd_head, device=device).to(dtype)
        # the well as a fixed rate into its cell (positive in), from its
        # first period on
        q = torch.zeros(n, dtype=dtype, device=device)
        q.index_add_(0, torch.as_tensor(inp.wel_node, device=device),
                     torch.as_tensor(inp.wel_q, device=device).to(dtype))
        self.q_wel = q.reshape(shape)
        self.wel_from_period = inp.wel_from_period

    def pin(self, h):
        """The heads with the constant-head cells at their values."""
        h = h.reshape(-1).clone()
        h[self.chd_node] = self.chd_head
        return h.reshape(self.shape)

    def raw_system(self, h_old, delt, kper):
        """(diag, six planes, rhs) of a step of period ``kper`` before the
        fixup; a steady step when ``delt`` is None."""
        cE, cW, cN, cS, cU, cD = faces_to_slots(self.cx, self.cy, self.cz)
        diag = -(cE + cW + cS + cN) - cD - cU
        rhs = torch.zeros_like(diag)
        if delt is not None:
            rho = self.ss * self.thick * self.area * (1.0 / delt)
            diag = diag - rho
            rhs = rhs - rho * h_old
        if kper >= self.wel_from_period:
            rhs = rhs - self.q_wel
        return diag, (cE, cW, cN, cS, cU, cD), rhs

    def system(self, h_old, delt, kper, x):
        """The fixed-up system at the iterate ``x``: constant-head rows
        become identity rows, and their columns move to the right-hand
        side of the active rows, which keeps the matrix symmetric."""
        diag, coef, rhs = self.raw_system(h_old, delt, kper)
        act = ~self.fixed
        diag = torch.where(act, diag, 1.0)
        rhs = torch.where(act, rhs, x)
        out = []
        for c, (axis, d) in zip(coef, SLOTS):
            move = act & shift(self.fixed, axis, d, False)
            rhs = rhs - torch.where(move, c * shift(x, axis, d), 0.0)
            out.append(torch.where(act & ~move, c, 0.0))
        flat = [t.reshape(-1) for t in (diag, rhs)]
        mv = matvec_planes(diag, out)
        return (lambda v: mv(v.reshape(self.shape)).reshape(-1)), flat[0], \
            flat[1]

    def step(self, h_old, delt, kper, ims):
        """One time step of period ``kper`` (steady when ``delt`` is None)
        from the heads ``h_old``: (heads, outer, inner, converged)."""
        h0 = self.pin(h_old)
        act = (~self.fixed).reshape(-1)

        def system(x):
            return self.system(h0, delt, kper, x.reshape(self.shape))
        x, outer, inner, conv = krylov.picard(system, h0.reshape(-1), act,
                                              ims)
        return x.reshape(self.shape), outer, inner, conv

    def residual(self, h, kper):
        """max |b - A h| of a steady step of period ``kper`` over the cells
        that are not constant-head, in the units of a flow rate (L^3/T)."""
        diag, coef, rhs = self.raw_system(None, None, kper)
        r = rhs - matvec_planes(diag, coef)(h)
        return float(torch.where(self.fixed, 0.0, r).abs().max())
