"""Jacobi-preconditioned CG on the structured 7-point system as four
hand-written CUDA kernels an inner iteration, their plain PyTorch versions,
and the host loop around either.

``krylov.cg`` runs ``solve`` where it can observe that the iteration is
this one: its product is a bound ``stencil7`` (``matvec.stencil7``), its
preconditioner the Jacobi apply (``precond.jacobi_inv``), its ``dot`` and
``absmax`` the defaults, no trace, no periodic residual refresh, CUDA
tensors.  An iteration is then four launches of ``csrc/pcg_jacobi.cu``
(see there) and one exit-flag read, against ~60 launches of the plain loop:

1. ``direction``: p = inv*d + beta*p, beta = rho/rho0 (0 at first);
2. ``product``: q = A p, bitwise ``stencil7``'s product, and the
   partial sums of p.q (counted in ``launches["stencil7"]`` too);
3. ``update``: alpha = rho/(p.q + sign*DPREC); x += alpha*p, d -= alpha*q;
   the partial signed absolute maxima of alpha*p and d, and the partial
   sums of d.d and of the next rho = d.(inv*d);
4. ``finish``: the partials summed; dvmax, rmax, l2norm, IMS's convergence
   test, the rcnvg == 0 rule, rho's stagnation; the exit flag.

The plain versions (``direction``, ``product``, ``update``, ``finish``)
work in place on the same buffers, with one partial for each sum, so
composed in this order (``solve(..., ops=Plain)``) they reproduce the
plain loop of ``krylov.cg`` bitwise; the kernels differ from them only in
the order of the sums.  They are the kernels' oracle; a CPU run of ``cg``
runs the plain loop and never builds or loads the library, which is
compiled with nvcc for sm_90a at first use (``stencil.compile_library``)
and bound with ctypes.  There is no fallback from the kernels to PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ...constants import DPREC
from ...utils.profiler import exit_flag, iteration_ranges, launches
from ..stencil import _check, compile_library, spmv_structured, stencil7

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "pcg_jacobi.cu"
THREADS = 256          # a block's threads (kThreads in the source)

# scalar slots of ``Buffers.s``, rows of ``.parts`` and ``.iparts``
# (the enums of csrc/pcg_jacobi.cu)
RHO0, RHO, DVMAX, RMAX, L2 = range(5)
PQ, DD, RD, TV, D = range(5)
TV_IDX, D_IDX = range(2)

_lib = None


def build() -> tuple[Path, str]:
    """Compile the kernels' library if this source has not been built yet;
    (library path, compiler output)."""
    return compile_library(SOURCE, "libpcg_jacobi")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        ptr, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_double)
        for sfx in ("f32", "f64"):
            for name, args in (
                    ("max_blocks", [i32, ptr]),
                    ("direction", [ptr] * 4 + [i32, i64, i32, ptr]),
                    ("product", [ptr] * 5 + [i32] * 4 + [ptr]),
                    ("update", [ptr] * 8 + [i64, i32, ptr]),
                    ("finish", [ptr, ptr, i32, ptr, ptr, ptr, f64, f64, i32,
                                i32, ptr])):
                fn = getattr(lib, f"pcg_{name}_{sfx}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
        lib.pcg_error_string.argtypes = [i32]
        lib.pcg_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err):
    if err != 0:
        raise RuntimeError("pcg_jacobi launch failed: "
                           + _load().pcg_error_string(err).decode())


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int, sfx: str) -> int:
    """Blocks of the three grid kernels that the card holds at once."""
    out = ctypes.c_int(0)
    _raise_on(getattr(_load(), f"pcg_max_blocks_{sfx}")(device_index,
                                                        ctypes.byref(out)))
    return out.value


class Buffers:
    """A solve's vectors, partials and scalars, allocated once per solve:
    x (a copy of x0, updated in place), the residual d = b - A x0, the
    direction p (zeros), the product q, ``parts[row, block]`` (sums and
    signed maxima by block), ``iparts`` (the maxima's indices), the scalars
    ``s`` (rho0, rho, dvmax, rmax, l2norm), ``flags`` (exit flag, icnvg)
    and ``lim``, the relative limit of the convergence test in float64."""

    def __init__(self, system, b, x0, inv, nparts, lim):
        dtype, device = b.dtype, b.device
        self.x = x0.clone()
        self.d = b - stencil7(*system, x0)
        self.p = torch.zeros_like(b)
        self.q = torch.empty_like(b)
        self.parts = torch.zeros((5, nparts), dtype=dtype, device=device)
        self.iparts = torch.zeros((2, nparts), dtype=torch.int64,
                                  device=device)
        self.s = torch.zeros(5, dtype=dtype, device=device)
        self.s[RHO] = torch.sum(self.d * (inv * self.d))
        self.flags = torch.zeros(2, dtype=torch.int32, device=device)
        self.lim = lim


def _limit(l2norm0, factor, dtype, device):
    """``l2norm0 * factor`` as the plain loop's test compares it, in
    float64: a tensor's product in its own dtype (compared in the wider of
    it and the working dtype), a number's rounded to the working dtype.
    float64 holds either exactly."""
    if isinstance(l2norm0, torch.Tensor):
        lim = l2norm0 * factor
    else:
        lim = torch.tensor(l2norm0 * factor, dtype=dtype)
    return lim.to(device=device, dtype=torch.float64).reshape(())


# ------------------------------------------------------- plain versions


def direction(inv, d, p, s, first):
    """p = inv*d + beta*p, beta = rho / rho0 (rho0 = 1 where it is 0), or
    0 on the first iteration."""
    if first:
        beta = torch.zeros_like(s[RHO])
    else:
        beta = s[RHO] / torch.where(s[RHO0] != 0.0, s[RHO0], 1.0)
    p.copy_(inv * d + beta * p)


def product(shape, diag, off, p, q, parts):
    """q = A p (``stencil.spmv_structured``) and p.q in the one partial."""
    q.copy_(spmv_structured(shape, diag, off, p))
    parts[PQ, 0] = torch.sum(p * q)


def update(inv, p, q, x, d, parts, iparts, s):
    """alpha = rho / (p.q + sign*DPREC); x += alpha*p; d -= alpha*q; the
    signed absolute maxima of alpha*p and d with their indices, d.d and
    the next rho = d.(inv*d), in the one partial."""
    pq = parts[PQ].sum()
    eps = torch.full_like(pq, DPREC)
    alpha = s[RHO] / (pq + torch.where(pq >= 0.0, eps, -eps))
    tv = alpha * p
    x.add_(tv)
    d.sub_(alpha * q)
    for row, irow, v in ((TV, TV_IDX, tv), (D, D_IDX, d)):
        i = torch.argmax(v.abs())
        parts[row, 0] = v[i]
        iparts[irow, 0] = i
    parts[DD, 0] = torch.sum(d * d)
    parts[RD, 0] = torch.sum(d * (inv * d))


def _absmax_of_parts(vals, idx):
    """The partial maximum that ``torch.argmax(v.abs())`` over all cells
    would pick: NaN first, then the largest magnitude, then the lowest
    cell index."""
    a = vals.abs()
    nan = torch.isnan(a)
    top = torch.where(nan.any(), nan, a == a.max())
    last = torch.iinfo(idx.dtype).max
    return vals[torch.argmin(torch.where(top, idx, last))]


def inner_test(dvmax, rmax, l2, lim, dvclose, rclose, icnvgopt, iiter0):
    """IMS's inner convergence test (``krylov._test_cnvg``) with the
    rcnvg == 0 rule, on the iteration's dvmax, rmax and l2norm, against
    ``lim`` (``_limit``): icnvg in {-1, 0, 1} as a 0-d int32 tensor."""
    rcnvg = l2 if icnvgopt in (2, 3, 4) else rmax
    advclose = dvmax.abs() <= dvclose
    rclosed = (rcnvg.abs() if icnvgopt in (0, 1) else rcnvg) <= rclose
    under_lim = rcnvg.to(torch.float64) <= lim
    one = torch.ones((), dtype=torch.int32, device=dvmax.device)
    if icnvgopt in (0, 1):
        hit = one if icnvgopt == 0 or iiter0 == 0 else -one
        icnvg = torch.where(advclose & rclosed, hit, 0)
    elif icnvgopt == 3:
        icnvg = torch.where(advclose, one, torch.where(under_lim, -one, 0))
    else:
        closed = advclose | rclosed if icnvgopt == 2 else advclose & rclosed
        icnvg = torch.where(closed, one, torch.where(under_lim, -one, 0))
    return torch.where(rcnvg == 0.0, one, icnvg)


def stagnant(a, a0):
    """``krylov._is_close(a, a0)``: equal, or within 100 machine epsilons
    of the larger magnitude."""
    rtol = 100.0 * torch.finfo(a.dtype).eps
    return (a == a0) | ((a - a0).abs() <= rtol * torch.maximum(a.abs(),
                                                               a0.abs()))


def finish(parts, iparts, s, flags, lim, dvclose, rclose, icnvgopt, iiter0):
    """Sum the partials; dvmax, rmax, l2norm, IMS's inner convergence test
    (``inner_test``) and the stagnation of rho into ``flags`` (exit,
    icnvg); rho0 <- rho <- the next rho in ``s``."""
    dvmax = _absmax_of_parts(parts[TV], iparts[TV_IDX])
    rmax = _absmax_of_parts(parts[D], iparts[D_IDX])
    l2 = torch.sqrt(parts[DD].sum())
    icnvg = inner_test(dvmax, rmax, l2, lim, dvclose, rclose, icnvgopt,
                       iiter0)
    rho, rho0 = s[RHO].clone(), s[RHO0].clone()
    flags[0] = (icnvg != 0) | stagnant(rho, rho0) | (rho == 0.0)
    flags[1] = icnvg
    s[RHO0] = rho
    s[RHO] = parts[RD].sum()
    s[DVMAX], s[RMAX], s[L2] = dvmax, rmax, l2


class Plain:
    """The plain versions on one solve's buffers (one partial a sum)."""

    @staticmethod
    def nparts(n, dtype, device):
        return 1

    def __init__(self, system, inv, buf, icnvgopt, dvclose, rclose):
        self.system, self.inv, self.buf = system, inv, buf
        self.test = (dvclose, rclose, icnvgopt)

    def direction(self, first):
        b = self.buf
        direction(self.inv, b.d, b.p, b.s, first)

    def product(self):
        b = self.buf
        product(*self.system, b.p, b.q, b.parts)

    def update(self):
        b = self.buf
        update(self.inv, b.p, b.q, b.x, b.d, b.parts, b.iparts, b.s)

    def finish(self, iiter0):
        b = self.buf
        dvclose, rclose, icnvgopt = self.test
        finish(b.parts, b.iparts, b.s, b.flags, b.lim, dvclose, rclose,
               icnvgopt, iiter0)


# ------------------------------------------------------------- kernels


def _sfx(dtype):
    return "f64" if dtype == torch.float64 else "f32"


class Kernels:
    """The four kernels of csrc/pcg_jacobi.cu on one solve's buffers, on
    the current stream; each launch is checked and counted
    (``launches["pcg_jacobi"]``, the product also as ``stencil7``)."""

    @staticmethod
    def nparts(n, dtype, device):
        """One partial a block of the fixed grid: every block resident at
        once, at most one a ``THREADS`` cells."""
        return max(1, min(-(-n // THREADS),
                          _max_blocks(device.index, _sfx(dtype))))

    def __init__(self, system, inv, buf, icnvgopt, dvclose, rclose):
        (self.nlay, self.nrow, self.ncol), diag, off = system
        lib = _load()
        sfx = _sfx(inv.dtype)
        self._direction = getattr(lib, f"pcg_direction_{sfx}")
        self._product = getattr(lib, f"pcg_product_{sfx}")
        self._update = getattr(lib, f"pcg_update_{sfx}")
        self._finish = getattr(lib, f"pcg_finish_{sfx}")
        self.stream = torch.cuda.current_stream(inv.device).cuda_stream
        self.n, self.nparts = inv.numel(), buf.parts.shape[1]
        self.diag, self.off, self.inv = (diag.data_ptr(), off.data_ptr(),
                                         inv.data_ptr())
        self.x, self.d, self.p, self.q = (buf.x.data_ptr(), buf.d.data_ptr(),
                                          buf.p.data_ptr(), buf.q.data_ptr())
        self.parts, self.iparts = buf.parts.data_ptr(), buf.iparts.data_ptr()
        self.s, self.flags = buf.s.data_ptr(), buf.flags.data_ptr()
        self.lim = buf.lim.data_ptr()
        self.test = (float(dvclose), float(rclose), int(icnvgopt))

    def direction(self, first):
        _raise_on(self._direction(self.inv, self.d, self.p, self.s,
                                  int(first), self.n, self.nparts,
                                  self.stream))
        launches["pcg_jacobi"] += 1

    def product(self):
        _raise_on(self._product(self.diag, self.off, self.p, self.q,
                                self.parts, self.nlay, self.nrow, self.ncol,
                                self.nparts, self.stream))
        launches["pcg_jacobi"] += 1
        launches["stencil7"] += 1

    def update(self):
        _raise_on(self._update(self.inv, self.p, self.q, self.x, self.d,
                               self.parts, self.iparts, self.s, self.n,
                               self.nparts, self.stream))
        launches["pcg_jacobi"] += 1

    def finish(self, iiter0):
        dvclose, rclose, icnvgopt = self.test
        _raise_on(self._finish(self.parts, self.iparts, self.nparts, self.s,
                               self.flags, self.lim, dvclose, rclose,
                               icnvgopt, iiter0, self.stream))
        launches["pcg_jacobi"] += 1


def _check_operands(system, inv, b, x0):
    """Device, dtype, shape and layout checks of a solve on the card."""
    shape, diag, off = system
    _check(shape, diag, off)
    device = diag.device
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"the system is on {device}, not on the current "
                         "CUDA device")
    for name, t in (("inv", inv), ("b", b), ("x0", x0)):
        if t.device != device or t.dtype != diag.dtype:
            raise ValueError(f"{name} ({t.dtype} on {t.device}) does not "
                             f"match the system ({diag.dtype} on {device})")
        if tuple(t.shape) != (diag.numel(),) or not t.is_contiguous():
            raise ValueError(f"{name} has shape {tuple(t.shape)} or is not "
                             f"contiguous; expected [{diag.numel()}]")


def solve(system, inv, b, x0, *, itmax, dvclose, rclose, icnvgopt=0,
          l2norm0=0.0, epfact_val=1.0, ops=Kernels):
    """Jacobi-preconditioned CG of ``system = ((nlay, nrow, ncol), diag,
    off)`` with D^-1 = ``inv``, IMS semantics, as ``krylov.cg`` with those
    operands; ``ops`` runs the iteration (``Kernels``, or ``Plain``).
    Returns (x, iters, converged, dvmax, rmax, l2norm)."""
    if icnvgopt not in (0, 1, 2, 3, 4):
        raise ValueError(f"unknown icnvgopt {icnvgopt}")
    if ops is Kernels:
        _check_operands(system, inv, b, x0)
    factor = rclose if icnvgopt == 3 else epfact_val
    buf = Buffers(system, b, x0, inv,
                  ops.nparts(inv.numel(), inv.dtype, inv.device),
                  _limit(l2norm0, factor, b.dtype, b.device))
    k = ops(system, inv, buf, icnvgopt, dvclose, rclose)
    flag = buf.flags[0]
    iiter = 0
    done = False
    ranges = iteration_ranges()
    while not done and iiter < itmax:
        if ranges:
            ranges.begin()
        k.direction(iiter == 0)
        k.product()
        k.update()
        k.finish(iiter)
        done = exit_flag(flag)
        iiter += 1
        if ranges:
            ranges.end()
    return (buf.x, iiter, buf.flags[1] == 1, buf.s[DVMAX], buf.s[RMAX],
            buf.s[L2])
