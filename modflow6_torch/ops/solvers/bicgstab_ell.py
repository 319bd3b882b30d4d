"""Jacobi-preconditioned BiCGSTAB on the ELL system as six hand-written
CUDA kernels an inner iteration around its five dot products, their plain
PyTorch versions, and the host loop around either.

``krylov.bicgstab`` runs ``solve`` where it can observe that the iteration
is this one: its product is the ELL gather (``matvec.ell``, which
``ops.system.make_matvec`` sets on a topology without a grid shape) over
fewer than ``MAX_SLOTS`` slots a row, its preconditioner the Jacobi apply
(``precond.jacobi_inv``), its ``dot`` and ``absmax`` the defaults, no
trace, no periodic residual refresh, CUDA tensors.  An iteration is then
six launches of ``csrc/bicgstab_ell.cu`` (see there), five ``torch.sum``
calls and one exit-flag read, against ~80 launches of the plain loop:

1. ``direction``: beta = (rho/rho0)(alpha0/omega0) (guarded as the plain
   loop guards it); p = d + beta (p - omega0 v), or p = d at first;
   phat = inv p;
2. ``product_v``: v = A phat; dhat.v;
3. ``half_step``: alpha = rho/(dhat.v + sign DPREC); q = d - alpha v,
   qhat = inv q;
4. ``product_t``: t = A qhat; t.q and t.t;
5. ``update``: omega = t.q/(t.t + sign DPREC); tv = alpha phat + omega qhat,
   x += tv, d = q - omega t; d.d and the next rho = dhat.d; the signed
   absolute maxima of tv and d by block;
6. ``finish``: the maxima combined; dvmax, rmax, l2norm, IMS's convergence
   test, the rcnvg == 0 rule, the stagnation of rho, alpha and omega, the
   rho omega == 0 rule; the exit flag.

Each dot product is ``torch.sum`` of a vector that the step writes (``w``,
``w2``), and the products add their slots in ``torch.sum(dim=1)``'s order,
so the kernels give the plain loop's iterates bit for bit: the transport
that runs them closes its inner solves at ``inner_rclose``, inside which
another order of the sums would move its concentrations by up to ~1e-4.
The plain versions work in place on the same buffers; composed in this
order (``solve(..., ops=Plain)``) they reproduce ``krylov.bicgstab`` bitwise
and are the kernels' oracle.  A CPU run of ``bicgstab`` runs the plain loop
and never builds or loads the library, which is compiled with nvcc for
sm_90a at first use (``stencil.compile_library``) and bound with ctypes.
The products index the neighbour table as int32 where N K < 2**31 (a copy
made once a solve), else as it is.  There is no fallback from the kernels
to PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ...constants import DPREC
from ...utils.profiler import exit_flag, iteration_ranges, launches
from ..stencil import compile_library
from ..system import spmv
from .pcg_jacobi import _absmax_of_parts, _limit, inner_test, stagnant

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "bicgstab_ell.cu"
THREADS = 256          # a block's threads (kThreads in the source)
LAUNCHES = 6           # launches an iteration
# slots a row below which torch.sum(dim=1) adds a row as the products do
# (ell_row_sum in the source)
MAX_SLOTS = 128

# scalar slots of ``Buffers.s``, of the dot products ``.sums`` and rows of
# the maxima ``.parts`` and ``.iparts`` (the enums of csrc/bicgstab_ell.cu)
RHO0, RHO, ALPHA0, ALPHA, OMEGA0, OMEGA, DVMAX, RMAX, L2 = range(9)
DV, TQ, TT, DD, RD = range(5)
TV, D = range(2)

_lib = None


def build() -> tuple[Path, str]:
    """Compile the kernels' library if this source has not been built yet;
    (library path, compiler output)."""
    return compile_library(SOURCE, "libbicgstab_ell")


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        ptr, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_double)
        for sfx in ("f32", "f64"):
            for name, args in (
                    ("max_blocks", [i32, i32, ptr]),
                    ("direction", [ptr] * 6 + [i32, i64, i32, ptr]),
                    ("product_i32", [ptr] * 8 + [i64, i32, i32, i32, ptr]),
                    ("product_i64", [ptr] * 8 + [i64, i32, i32, i32, ptr]),
                    ("half", [ptr] * 7 + [i64, i32, ptr]),
                    ("update", [ptr] * 13 + [i64, i32, ptr]),
                    ("finish", [ptr, ptr, ptr, i32, ptr, ptr, ptr, f64, f64,
                                i32, i32, ptr])):
                fn = getattr(lib, f"bicgstab_{name}_{sfx}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
        lib.bicgstab_error_string.argtypes = [i32]
        lib.bicgstab_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err):
    if err != 0:
        raise RuntimeError("bicgstab_ell launch failed: "
                           + _load().bicgstab_error_string(err).decode())


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int, sfx: str, k: int) -> int:
    """Blocks of the grid kernels that the card holds at once."""
    out = ctypes.c_int(0)
    _raise_on(getattr(_load(), f"bicgstab_max_blocks_{sfx}")(
        device_index, k, ctypes.byref(out)))
    return out.value


class Buffers:
    """A solve's vectors, sums and scalars, allocated once per solve: x (a
    copy of x0, updated in place), the residual d = b - A x0, its copy
    dhat, the directions p and v (zeros), phat, q, qhat, t, the summands
    w and w2, the dot products ``sums`` (dhat.v, t.q, t.t, d.d, dhat.d),
    ``parts[row, block]`` (the signed maxima of tv and d by block) with
    their indices ``iparts``, the scalars ``s`` (rho0, rho, alpha0, alpha,
    omega0, omega, dvmax, rmax, l2norm), ``flags`` (exit flag, icnvg) and
    ``lim``, the relative limit of the convergence test in float64."""

    def __init__(self, ell, b, x0, nparts, lim):
        nbr, diag, off = ell
        dtype, device = b.dtype, b.device
        self.x = x0.contiguous().clone()
        self.d = (b - spmv(nbr, diag, off, x0)).contiguous()
        self.dhat = self.d.clone()
        self.p = torch.zeros_like(self.d)
        self.v = torch.zeros_like(self.d)
        self.phat, self.q, self.qhat, self.t, self.w, self.w2 = (
            torch.empty_like(self.d) for _ in range(6))
        self.sums = torch.zeros(5, dtype=dtype, device=device)
        self.parts = torch.zeros((2, nparts), dtype=dtype, device=device)
        self.iparts = torch.zeros((2, nparts), dtype=torch.int64,
                                  device=device)
        self.s = torch.zeros(9, dtype=dtype, device=device)
        self.s[RHO] = torch.sum(self.dhat * self.d)
        self.flags = torch.zeros(2, dtype=torch.int32, device=device)
        self.lim = lim

    def sum_into(self, slot, w):
        """``sums[slot] = torch.sum(w)``, the plain loop's sum."""
        torch.sum(w, 0, out=self.sums[slot])


def _plus_sign_dprec(x):
    """``x + krylov._sign_dprec(x)``."""
    eps = torch.full_like(x, DPREC)
    return x + torch.where(x >= 0.0, eps, -eps)


# ------------------------------------------------------- plain versions


def direction(inv, d, p, v, phat, s, first):
    """p = d + beta*(p - omega0*v), beta = (rho/rho0)*(alpha0/omega0) with
    1 for a zero rho0 or omega0, or p = d on the first iteration; then
    phat = inv*p."""
    if first:
        p.copy_(d)
    else:
        rho0, omega0 = s[RHO0], s[OMEGA0]
        beta = ((s[RHO] / torch.where(rho0 != 0.0, rho0, 1.0))
                * (s[ALPHA0] / torch.where(omega0 != 0.0, omega0, 1.0)))
        p.copy_(d + beta * (p - omega0 * v))
    phat.copy_(inv * p)


def product_v(ell, phat, v, dhat, w):
    """v = A phat (``ops.system.spmv``); w = dhat*v."""
    v.copy_(spmv(*ell, phat))
    torch.mul(dhat, v, out=w)


def half_step(inv, d, v, q, qhat, sums, s):
    """alpha = rho / (dhat.v + sign*DPREC); q = d - alpha*v;
    qhat = inv*q."""
    alpha = s[RHO] / _plus_sign_dprec(sums[DV])
    s[ALPHA] = alpha
    q.copy_(d - alpha * v)
    qhat.copy_(inv * q)


def product_t(ell, qhat, t, q, w, w2):
    """t = A qhat; w = t*q, w2 = t*t."""
    t.copy_(spmv(*ell, qhat))
    torch.mul(t, q, out=w)
    torch.mul(t, t, out=w2)


def update(phat, qhat, q, t, dhat, x, d, w, w2, sums, parts, iparts, s):
    """omega = t.q / (t.t + sign*DPREC); tv = alpha*phat + omega*qhat;
    x += tv; d = q - omega*t; w = d*d, w2 = dhat*d; the signed absolute
    maxima of tv and d with their indices, in the one partial."""
    omega = sums[TQ] / _plus_sign_dprec(sums[TT])
    s[OMEGA] = omega
    tv = s[ALPHA] * phat + omega * qhat
    x.add_(tv)
    d.copy_(q - omega * t)
    torch.mul(d, d, out=w)
    torch.mul(dhat, d, out=w2)
    for row, vec in ((TV, tv), (D, d)):
        i = torch.argmax(vec.abs())
        parts[row, 0] = vec[i]
        iparts[row, 0] = i


def finish(sums, parts, iparts, s, flags, lim, dvclose, rclose, icnvgopt,
           iiter0):
    """The maxima combined; dvmax, rmax, l2norm = sqrt(d.d), IMS's inner
    convergence test (``krylov._test_cnvg``), the rcnvg == 0 rule, the
    stagnation of rho, alpha and omega and the rho*omega == 0 rule into
    ``flags`` (exit, icnvg); then rho0, alpha0, omega0 <- rho, alpha, omega
    and rho <- dhat.d in ``s``."""
    dvmax = _absmax_of_parts(parts[TV], iparts[TV])
    rmax = _absmax_of_parts(parts[D], iparts[D])
    l2 = torch.sqrt(sums[DD])
    icnvg = inner_test(dvmax, rmax, l2, lim, dvclose, rclose, icnvgopt,
                       iiter0)
    now = s[[RHO, ALPHA, OMEGA]]
    rho, alpha, omega = now
    stuck = (stagnant(rho, s[RHO0]) | stagnant(alpha, s[ALPHA0])
             | stagnant(omega, s[OMEGA0]))
    flags[0] = (icnvg != 0) | stuck | (rho * omega == 0.0)
    flags[1] = icnvg
    s[[RHO0, ALPHA0, OMEGA0]] = now
    s[RHO] = sums[RD]
    s[DVMAX], s[RMAX], s[L2] = dvmax, rmax, l2


class Plain:
    """The plain versions on one solve's buffers (one partial for the
    maxima)."""

    @staticmethod
    def nparts(n, k, dtype, device):
        return 1

    def __init__(self, ell, inv, buf, icnvgopt, dvclose, rclose):
        self.ell, self.inv, self.buf = ell, inv, buf
        self.test = (dvclose, rclose, icnvgopt)

    def direction(self, first):
        b = self.buf
        direction(self.inv, b.d, b.p, b.v, b.phat, b.s, first)

    def product_v(self):
        b = self.buf
        product_v(self.ell, b.phat, b.v, b.dhat, b.w)
        b.sum_into(DV, b.w)

    def half_step(self):
        b = self.buf
        half_step(self.inv, b.d, b.v, b.q, b.qhat, b.sums, b.s)

    def product_t(self):
        b = self.buf
        product_t(self.ell, b.qhat, b.t, b.q, b.w, b.w2)
        b.sum_into(TQ, b.w)
        b.sum_into(TT, b.w2)

    def update(self):
        b = self.buf
        update(b.phat, b.qhat, b.q, b.t, b.dhat, b.x, b.d, b.w, b.w2,
               b.sums, b.parts, b.iparts, b.s)
        b.sum_into(DD, b.w)
        b.sum_into(RD, b.w2)

    def finish(self, iiter0):
        b = self.buf
        dvclose, rclose, icnvgopt = self.test
        finish(b.sums, b.parts, b.iparts, b.s, b.flags, b.lim, dvclose,
               rclose, icnvgopt, iiter0)


# ------------------------------------------------------------- kernels


def _sfx(dtype):
    return "f64" if dtype == torch.float64 else "f32"


def index_table(nbr):
    """The neighbour table as the products index it: int32 where every
    flat slot index fits (N K < 2**31), else as it is."""
    if nbr.dtype != torch.int32 and nbr.numel() < 2**31:
        return nbr.to(torch.int32)
    return nbr


class Kernels:
    """The six kernels of csrc/bicgstab_ell.cu on one solve's buffers, on
    the current stream, with the dot products' ``torch.sum``s; each launch
    is checked and counted (``launches["bicgstab_ell"]``)."""

    @staticmethod
    def nparts(n, k, dtype, device):
        """One partial a block of the fixed grid: every block resident at
        once, at most one a ``THREADS`` cells."""
        return max(1, min(-(-n // THREADS),
                          _max_blocks(device.index, _sfx(dtype), k)))

    def __init__(self, ell, inv, buf, icnvgopt, dvclose, rclose):
        nbr, diag, off = ell
        lib = _load()
        sfx = _sfx(inv.dtype)
        # held, so that the memory behind the pointers below outlives them
        self.nbr = index_table(nbr)
        isfx = "i32" if self.nbr.dtype == torch.int32 else "i64"
        self._direction = getattr(lib, f"bicgstab_direction_{sfx}")
        self._product = getattr(lib, f"bicgstab_product_{isfx}_{sfx}")
        self._half = getattr(lib, f"bicgstab_half_{sfx}")
        self._update = getattr(lib, f"bicgstab_update_{sfx}")
        self._finish = getattr(lib, f"bicgstab_finish_{sfx}")
        self.stream = torch.cuda.current_stream(inv.device).cuda_stream
        self.buf = buf
        self.n, self.k = nbr.shape
        self.nparts = buf.parts.shape[1]
        self.ptrs = {name: t.data_ptr() for name, t in (
            ("nbr", self.nbr), ("diag", diag), ("off", off), ("inv", inv),
            *((name, getattr(buf, name)) for name in (
                "x", "d", "dhat", "p", "v", "phat", "q", "qhat", "t", "w",
                "w2", "sums", "parts", "iparts", "s", "flags", "lim")))}
        self.test = (float(dvclose), float(rclose), int(icnvgopt))

    def _launched(self, err):
        _raise_on(err)
        launches["bicgstab_ell"] += 1

    def direction(self, first):
        a = self.ptrs
        self._launched(self._direction(
            a["inv"], a["d"], a["p"], a["v"], a["phat"], a["s"], int(first),
            self.n, self.nparts, self.stream))

    def _gather(self, x, y, u, two):
        a = self.ptrs
        self._launched(self._product(
            a["nbr"], a["diag"], a["off"], a[x], a[y], a[u], a["w"],
            a["w2"], self.n, self.k, two, self.nparts, self.stream))

    def product_v(self):
        self._gather("phat", "v", "dhat", 0)
        self.buf.sum_into(DV, self.buf.w)

    def half_step(self):
        a = self.ptrs
        self._launched(self._half(
            a["inv"], a["d"], a["v"], a["q"], a["qhat"], a["sums"], a["s"],
            self.n, self.nparts, self.stream))

    def product_t(self):
        b = self.buf
        self._gather("qhat", "t", "q", 1)
        b.sum_into(TQ, b.w)
        b.sum_into(TT, b.w2)

    def update(self):
        a, b = self.ptrs, self.buf
        self._launched(self._update(
            a["phat"], a["qhat"], a["q"], a["t"], a["dhat"], a["x"], a["d"],
            a["w"], a["w2"], a["sums"], a["parts"], a["iparts"], a["s"],
            self.n, self.nparts, self.stream))
        b.sum_into(DD, b.w)
        b.sum_into(RD, b.w2)

    def finish(self, iiter0):
        a = self.ptrs
        dvclose, rclose, icnvgopt = self.test
        self._launched(self._finish(
            a["sums"], a["parts"], a["iparts"], self.nparts, a["s"],
            a["flags"], a["lim"], dvclose, rclose, icnvgopt, iiter0,
            self.stream))


def _check_operands(ell, inv, b, x0):
    """Device, dtype, shape and layout checks of a solve on the card."""
    nbr, diag, off = ell
    device, dtype = diag.device, diag.dtype
    if device.type != "cuda" or device.index != torch.cuda.current_device():
        raise ValueError(f"the system is on {device}, not on the current "
                         "CUDA device")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"bicgstab_ell takes float32 or float64, not "
                         f"{dtype}")
    if (nbr.dim() != 2 or nbr.dtype not in (torch.int32, torch.int64)
            or nbr.shape[1] >= MAX_SLOTS):
        raise ValueError(f"nbr ({nbr.dtype}{tuple(nbr.shape)}) is not an "
                         f"[N, K] integer table with K < {MAX_SLOTS}")
    n, k = nbr.shape
    for name, t, want in (("nbr", nbr, (n, k)), ("diag", diag, (n,)),
                          ("off", off, (n, k)), ("inv", inv, (n,)),
                          ("b", b, (n,)), ("x0", x0, (n,))):
        if t.device != device or (name != "nbr" and t.dtype != dtype):
            raise ValueError(f"{name} ({t.dtype} on {t.device}) does not "
                             f"match the system ({dtype} on {device})")
        if tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"{name} has shape {tuple(t.shape)} or is not "
                             f"contiguous; expected {list(want)}")


def solve(ell, inv, b, x0, *, itmax, dvclose, rclose, icnvgopt=0,
          l2norm0=0.0, epfact_val=1.0, ops=Kernels):
    """Jacobi-preconditioned BiCGSTAB of ``ell = (nbr, diag, off)`` with
    D^-1 = ``inv``, IMS semantics, as ``krylov.bicgstab`` with those
    operands; ``ops`` runs the iteration (``Kernels``, or ``Plain``).
    Returns (x, iters, converged, dvmax, rmax, l2norm)."""
    if icnvgopt not in (0, 1, 2, 3, 4):
        raise ValueError(f"unknown icnvgopt {icnvgopt}")
    if ops is Kernels:
        _check_operands(ell, inv, b, x0)
    factor = rclose if icnvgopt == 3 else epfact_val
    n, k = ell[0].shape
    buf = Buffers(ell, b, x0, ops.nparts(n, k, inv.dtype, inv.device),
                  _limit(l2norm0, factor, b.dtype, b.device))
    k = ops(ell, inv, buf, icnvgopt, dvclose, rclose)
    flag = buf.flags[0]
    iiter = 0
    done = False
    ranges = iteration_ranges()
    while not done and iiter < itmax:
        if ranges:
            ranges.begin()
        k.direction(iiter == 0)
        k.product_v()
        k.half_step()
        k.product_t()
        k.update()
        k.finish(iiter)
        done = exit_flag(flag)
        iiter += 1
        if ranges:
            ranges.end()
    return (buf.x, iiter, buf.flags[1] == 1, buf.s[DVMAX], buf.s[RMAX],
            buf.s[L2])
