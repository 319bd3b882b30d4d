"""Sharded numerical solution: the Picard + Krylov time step over P shards
of a row-partitioned model, driven by one controller.

Port of modflow6_tpu/parallel/sharded.py (the role of the reference's
parallel run, SURVEY §2.8/§3.3).  The reference runs the step as one
``shard_map`` program over a device mesh; its inputs and outputs are
stacked [P, n_local] arrays.  Here one process drives the P shards in
shard order, each shard's tensors on its device:

  reference                               here
  ---------                               ----
  model-per-rank + interface models       row-slab shards + halo rows
  ``lax.ppermute`` halo exchange          copies between the shards'
    (VirtualDataManager.synchronize)        tensors (``.to(device)``)
  ``lax.psum`` dots in the Krylov loop    the shards' masked partial sums,
    (PETSc KSP global reductions)           added in shard order
  ``lax.pmax`` on masked |dx|             the shards' masked maxima
  per-shard Jacobi/Neumann/Chebyshev      the same, per shard

A vector over the shards is a ``ShardVec``: P tensors, one per shard, on
which arithmetic and torch functions map shard by shard (a plain tensor
beside one is taken as the same value on every shard).  So the Krylov
solvers and the preconditioners of ``ops.solvers`` run unchanged on
ShardVecs, with the reductions injected as ``dot``/``absmax``, as the
reference injects its collectives; every loop reads one combined exit flag
a pass.  Each shard's product is its local model's ``make_matvec``: on a
DIS slab one launch of the stencil kernel per shard and product.

``implicit_local_solve`` is the per-shard Picard + Krylov loop that the
row, general, augmented and transport runners share.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..constants import DZERO
from ..ops.solvers.krylov import bicgstab, cg, epfact, refined_solve
from ..ops.solvers.precond import make_preconditioner
from ..ops.system import make_matvec
from ..solution.ims import ImsSettings, fix_system
from .partition import PACKAGE_FIELDS, RowPartition, host, refuse_unsharded


# ------------------------------------------------------------ shard vectors

def _part(obj, p, device):
    """Shard ``p``'s view of an argument: a ShardVec's p-th tensor, a plain
    tensor moved to the shard's device, containers element by element."""
    if isinstance(obj, ShardVec):
        return obj.parts[p]
    if isinstance(obj, torch.Tensor):
        return obj if obj.device == device else obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_part(x, p, device) for x in obj)
    if isinstance(obj, dict):
        return {k: _part(v, p, device) for k, v in obj.items()}
    return obj


def _shardvecs(objs, out):
    """The ShardVecs among ``objs`` (nested containers), into ``out``."""
    for obj in objs:
        if isinstance(obj, ShardVec):
            out.append(obj)
        elif isinstance(obj, (list, tuple)):
            _shardvecs(obj, out)
        elif isinstance(obj, dict):
            _shardvecs(obj.values(), out)
    return out


def _wrap(results):
    first = results[0]
    if isinstance(first, torch.Tensor):
        return ShardVec(results)
    if isinstance(first, tuple):
        return tuple(_wrap([r[i] for r in results])
                     for i in range(len(first)))
    return results


def _unstack(obj):
    """A stacked ShardVec's [P, ...] tensor in place of it (containers
    element by element); plain values as they are."""
    if isinstance(obj, ShardVec):
        return obj.stack
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unstack(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _unstack(v) for k, v in obj.items()}
    return obj


# functions that act element by element (broadcasting a [n] or 0-d
# operand over the shards), so that they apply to stacked shards at once
_ELEMENTWISE = {
    torch.where, torch.zeros_like, torch.ones_like, torch.full_like,
    torch.abs, torch.sqrt, torch.sign, torch.maximum, torch.minimum,
    torch.clamp, torch.Tensor.to, torch.Tensor.abs, torch.Tensor.clamp,
    torch.Tensor.__mul__, torch.Tensor.__rmul__, torch.Tensor.__add__,
    torch.Tensor.__radd__, torch.Tensor.__sub__, torch.Tensor.__rsub__,
    torch.Tensor.__truediv__, torch.Tensor.__rtruediv__,
    torch.Tensor.__and__, torch.Tensor.__or__, torch.Tensor.__invert__,
    torch.Tensor.__gt__, torch.Tensor.__ge__, torch.Tensor.__lt__,
    torch.Tensor.__le__, torch.Tensor.__eq__, torch.Tensor.__ne__,
    torch.Tensor.__neg__, torch.Tensor.mul, torch.Tensor.add,
    torch.Tensor.sub, torch.Tensor.div, torch.mul, torch.add, torch.sub,
    torch.div}


def _stackable(args, kwargs, vecs):
    """True when every ShardVec operand is stacked on one device and every
    plain tensor operand is a 0-d value or one shard's shape there."""
    if any(v.stack is None for v in vecs):
        return False
    dev, shape = vecs[0].stack.device, vecs[0].shape
    if any(v.stack.device != dev or v.shape != shape for v in vecs):
        return False
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor) and (
                a.device != dev or (a.dim() and a.shape != shape)):
            return False
    return True


def shard_map(fn, *args, **kwargs):
    """``fn`` applied shard by shard: ShardVec arguments give their p-th
    tensor, plain tensors go to shard p's device; tensor results come back
    as ShardVecs (tuples of them)."""
    ref = _shardvecs((args, kwargs), [])[0]
    return _wrap([fn(*_part(args, p, dev), **_part(kwargs, p, dev))
                  for p, dev in enumerate(ref.devices)])


def on_device(device):
    """The context in which a shard's kernels launch: its CUDA device made
    current (the stencil kernel launches on the current device)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _binary(op):
    def method(self, other):
        if self.stack is not None:
            if isinstance(other, ShardVec):
                if other.stack is not None and other.shape == self.shape:
                    return ShardVec.stacked(op(self.stack, other.stack))
            elif not isinstance(other, torch.Tensor) or (
                    other.device == self.stack.device
                    and (not other.dim() or other.shape == self.shape)):
                return ShardVec.stacked(op(self.stack, other))
        return ShardVec([op(a, b) for a, b in _operands(self, other)])
    return method


def _rbinary(op):
    return _binary(lambda a, b: op(b, a))


def _operands(self, other):
    """(shard tensor, operand) pairs of a binary operation."""
    if isinstance(other, ShardVec):
        return zip(self.parts, other.parts)
    if isinstance(other, torch.Tensor):
        return ((a, other if other.device == a.device
                 else other.to(a.device)) for a in self.parts)
    return ((a, other) for a in self.parts)


class ShardVec:
    """P tensors, one per shard, each on its shard's device: a vector over
    the shards.  Arithmetic, comparisons, tensor methods and torch
    functions map shard by shard; a plain tensor or number beside a
    ShardVec is the same value on every shard (the reference's replicated
    ``P()`` operands).

    Shards on one device may be held stacked, one [P, ...] tensor (the
    reference's layout), whose rows are the shards' tensors: element-wise
    work then runs on the stack in one call."""

    __slots__ = ("_parts", "stack")

    def __init__(self, parts):
        parts = list(parts)
        self.stack = None
        self._parts = parts
        dev = parts[0].device
        if all(t.device == dev and t.shape == parts[0].shape
               for t in parts) and parts[0].dim():
            self.stack = torch.stack(parts)
            self._parts = None

    @classmethod
    def stacked(cls, stack):
        out = cls.__new__(cls)
        out.stack = stack
        out._parts = None
        return out

    @property
    def parts(self):
        if self._parts is None:
            self._parts = list(self.stack.unbind(0))
        return self._parts

    @property
    def devices(self):
        if self.stack is not None:
            return [self.stack.device] * self.stack.shape[0]
        return [t.device for t in self._parts]

    @property
    def dtype(self):
        return (self.stack if self.stack is not None
                else self._parts[0]).dtype

    @property
    def device(self):
        """The first shard's device, where the reductions' results live."""
        return self.devices[0]

    @property
    def shape(self):
        """One shard's shape (every shard has the same)."""
        if self.stack is not None:
            return self.stack.shape[1:]
        return self._parts[0].shape

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        vecs = _shardvecs((args, kwargs), [])
        if func in _ELEMENTWISE and _stackable(args, kwargs, vecs):
            return ShardVec.stacked(func(*_unstack(args),
                                         **_unstack(kwargs)))
        return shard_map(func, *args, **kwargs)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        method = getattr(torch.Tensor, name)   # AttributeError otherwise

        def call(*args, **kwargs):
            return ShardVec.__torch_function__(
                method, (), (self,) + args, kwargs)
        return call

    __add__ = _binary(lambda a, b: a + b)
    __radd__ = _rbinary(lambda a, b: a + b)
    __sub__ = _binary(lambda a, b: a - b)
    __rsub__ = _rbinary(lambda a, b: a - b)
    __mul__ = _binary(lambda a, b: a * b)
    __rmul__ = _rbinary(lambda a, b: a * b)
    __truediv__ = _binary(lambda a, b: a / b)
    __rtruediv__ = _rbinary(lambda a, b: a / b)
    __ne__ = _binary(lambda a, b: a != b)
    __lt__ = _binary(lambda a, b: a < b)
    __gt__ = _binary(lambda a, b: a > b)

    def __neg__(self):
        if self.stack is not None:
            return ShardVec.stacked(-self.stack)
        return ShardVec([-a for a in self.parts])


def as_shards(v, devices):
    """``v`` as a ShardVec: a ShardVec as it is, a plain tensor replicated
    onto every shard (the reference's replicated values)."""
    if isinstance(v, ShardVec):
        return v
    return ShardVec([v.to(d) for d in devices])


def stack_to_shards(stacked, devices, dtype=torch.float64):
    """A [P, n] array or tensor (the reference's stacked layout) → a
    ShardVec of its rows on the shards' devices."""
    if not isinstance(stacked, torch.Tensor):
        stacked = np.asarray(stacked)
    return ShardVec([torch.as_tensor(stacked[p], dtype=dtype, device=d)
                     for p, d in enumerate(devices)])


def shards_to_stack(v) -> np.ndarray:
    """A ShardVec → the [P, n] host array of the reference's layout."""
    return np.stack([t.detach().cpu().numpy() for t in v.parts])


def owned_reductions(own):
    """(dot, absmax) over the owned rows of every shard (``own``: a ShardVec
    of bool masks): each shard's masked partial, combined in shard order on
    the first shard's device (the reference's masked psum / pmax)."""
    dev0 = own.device

    def dot(a, b):
        if own.stack is not None and a.stack is not None \
                and b.stack is not None:
            partials = torch.where(own.stack, a.stack * b.stack,
                                   DZERO).sum(dim=1)
            # the running sum in shard order; its last entry is the total
            return partials.cumsum(0)[-1]
        total = None
        for m, x, y in zip(own.parts, a.parts, b.parts):
            part = torch.sum(torch.where(m, x * y, DZERO))
            part = part if part.device == dev0 else part.to(dev0)
            total = part if total is None else total + part
        return total

    def absmax(v):
        if own.stack is not None and v.stack is not None:
            return torch.where(own.stack, v.stack, DZERO).abs().amax()
        out = None
        for m, x in zip(own.parts, v.parts):
            part = torch.max(torch.abs(torch.where(m, x, DZERO)))
            part = part if part.device == dev0 else part.to(dev0)
            out = part if out is None else torch.maximum(out, part)
        return out

    return dot, absmax


def resolve_devices(devices, nshards):
    """P devices: ``None`` is the CUDA device repeated (raising when there
    is none), one device is repeated, a sequence is taken as it is."""
    if devices is None or isinstance(devices, (str, torch.device)):
        return [resolve_device(devices)] * nshards
    devices = [torch.device(d) for d in devices]
    if len(devices) != nshards:
        raise ValueError(f"{len(devices)} devices for {nshards} shards")
    return devices


# --------------------------------------------------------- the shared loop

def _shard_precond_kind(kind: str) -> str:
    """Geometric MG is a whole-grid structured method; per shard it
    degrades to Chebyshev (the substitution ims._make_precond makes for
    unstructured models)."""
    return "chebyshev" if kind == "mg" else kind


def _shard_precond_order(s) -> int:
    kind = _shard_precond_kind(s.preconditioner)
    return max(s.preconditioner_order, 4 if kind == "chebyshev" else 0)


def check_settings(s: ImsSettings, what: str):
    """The IMS options that the sharded loop does not run, refused by name
    (the reference's loop reads past them)."""
    if s.under_relaxation != "none":
        raise NotImplementedError(
            f"{what} does not run UNDER_RELAXATION {s.under_relaxation}")
    if s.backtracking_number:
        raise NotImplementedError(f"{what} does not run BACKTRACKING")
    if s.csv_inner_path is not None:
        raise NotImplementedError(f"{what} does not write CSV_INNER_OUTPUT")


def implicit_local_solve(lms, head, head_old, ibound, delt, iss, s, use_cg,
                         halo, dot, absmax, kstp, own, pkgs=None):
    """The per-shard Picard + Krylov loop shared by the flow and transport
    runners (the NumericalSolution.solve role run shard-local, with the
    reductions over the shards injected as ``dot``/``absmax``).

    ``lms``: the shards' local models; ``head``, ``head_old``, ``ibound``,
    ``own``: ShardVecs; ``halo``: ShardVec → ShardVec with the halo slots
    refreshed; ``pkgs``: per-shard package data or None.  Returns (head,
    kiter, converged, inner iterations), one exit flag read a pass."""
    solver = cg if use_cg else bicgstab
    devices = head.devices
    # shards stacked on one device with gather products multiply at once
    nbr_stack = None
    if head.stack is not None and all(
            lm.system_topo.grid_shape is None for lm in lms):
        nbr_stack = torch.stack([lm.system_topo.nbr for lm in lms])
    kiter, inner_tot, converged = 0, 0, False
    while not converged and kiter < s.outer_maximum:
        head = halo(head)
        parts = []
        for p, (lm, dev) in enumerate(zip(lms, devices)):
            with on_device(dev):
                args = (head.parts[p], head_old.parts[p], ibound.parts[p],
                        delt, iss)
                parts.append(lm.assemble(*args) if pkgs is None
                             else lm.assemble(*args, pkgs=pkgs[p]))
        diag, off, rhs = _wrap(parts)
        active = torch.where(ibound > 0, 1, torch.where(ibound < 0, -1, 0))
        diag, off, rhs = _wrap([
            fix_system(lm, active.parts[p], diag.parts[p], off.parts[p],
                       rhs.parts[p], head.parts[p], symmetric=use_cg,
                       own=own.parts[p])
            for p, lm in enumerate(lms)])

        def bind(d, o):
            if d.stack is not None and nbr_stack is not None:
                return _stacked_gather_matvec(nbr_stack, d.stack, o.stack,
                                              halo, devices)
            mvs = [make_matvec(lm.system_topo, d.parts[p], o.parts[p])
                   for p, lm in enumerate(lms)]

            def matvec(v):
                v = halo(as_shards(v, devices))
                out = []
                for mv, x, dev in zip(mvs, v.parts, devices):
                    with on_device(dev):
                        out.append(mv(x))
                return ShardVec(out)
            return matvec

        matvec = bind(diag, off)
        r0 = rhs - matvec(head)
        l2norm0 = torch.sqrt(dot(r0, r0))
        kw = dict(itmax=s.inner_maximum, dvclose=s.inner_dvclose,
                  rclose=s.inner_rclose, icnvgopt=s.icnvgopt,
                  north=s.north, l2norm0=l2norm0,
                  epfact_val=epfact(s.icnvgopt, kstp), dot=dot,
                  absmax=absmax)
        kind = _shard_precond_kind(s.preconditioner)
        order = _shard_precond_order(s)
        if s.precision == "mixed":
            diag32 = diag.to(torch.float32)
            matvec32 = bind(diag32, off.to(torch.float32))
            pre32 = make_preconditioner(kind, matvec32, diag32, order=order)
            res = refined_solve(matvec, matvec32, rhs, head, pre32,
                                solver=solver, **kw)
        else:
            pre = make_preconditioner(kind, matvec, diag, order=order)
            res = solver(matvec, rhs, head, pre, **kw)
        x = halo(res.x)
        dxmax = absmax(torch.where(active > 0, x - head, DZERO))
        converged = bool(dxmax <= s.outer_dvclose)
        head = x
        kiter += 1
        inner_tot += res.iters
    return head, kiter, converged, inner_tot


def _stacked_gather_matvec(nbr, diag, off, halo, devices):
    """A·v for shards stacked on one device whose products are the gather
    product (no grid shape): ``ops.system.spmv`` of every shard in one
    batched call over the [P, n, K] tables."""
    P, n, K = nbr.shape
    flat = (nbr + torch.arange(P, device=nbr.device)[:, None, None] * n
            ).reshape(-1)
    off = off.reshape(P, n, K)

    def matvec(v):
        x = halo(as_shards(v, devices)).stack
        xn = x.reshape(-1)[flat].view(P, n, K)
        return ShardVec.stacked(diag * x + torch.sum(off * xn, dim=2))
    return matvec


# ------------------------------------------------------- the row runner

def local_package(data, entries, device):
    """A list package's data class over one shard's entries (``entries``:
    host arrays with local nodes), every entry live."""
    fields = {}
    for f in dataclasses.fields(data):
        ref = getattr(data, f.name)
        if f.name == "mask":
            fields[f.name] = torch.ones(len(entries["node"]),
                                        dtype=torch.bool, device=device)
        elif f.name in entries:
            fields[f.name] = torch.as_tensor(entries[f.name],
                                             dtype=ref.dtype, device=device)
        else:
            fields[f.name] = ref
    return type(data)(**fields)


def _row_local_model(part: RowPartition, p, device):
    """Shard ``p``'s local GwfModel on ``device``: the global model with its
    arrays swapped for the shard's slab."""
    from ..models.gwf import npf as npf_mod

    model = part.model
    g = part.grid_local
    f64 = torch.float64

    def t(stacked, ref):
        return torch.as_tensor(stacked[p], dtype=ref.dtype, device=device)

    na = model.npf_arrays
    arrays = dataclasses.replace(na, condsat=None, **{
        f: t(v, getattr(na, f)) for f, v in part.npf_arrays.items()
        if v is not None})
    sto_arrays = None
    if part.sto_arrays is not None:
        sa = model.sto_arrays
        sto_arrays = dataclasses.replace(
            sa, top=arrays.top, bot=arrays.bot, **{
                f: t(v, getattr(sa, f)) for f, v in part.sto_arrays.items()})
    structured = model.use_structured
    dtopo = (npf_mod.DeviceTopology(grid_shape=part.local_row_shape())
             if structured
             else npf_mod.DeviceTopology.from_host(part.topo_local, device))
    pkgs = {name: None if part.pkgs[name] is None else local_package(
        getattr(model, name), part.pkgs[name][p], device)
        for name, _ in PACKAGE_FIELDS}
    lm = dataclasses.replace(
        model, grid=g, topo=part.topo_local, dtopo=dtopo, npf_arrays=arrays,
        strt=t(part.strt, model.strt), ibound0=t(part.ibound0,
                                                 model.ibound0),
        area=t(part.area, model.area), sto_arrays=sto_arrays, hfb=None,
        delr=torch.as_tensor(g.delr, dtype=f64, device=device)
        if structured else None,
        delc=torch.as_tensor(g.delc, dtype=f64, device=device)
        if structured else None,
        condsat3=None if part.condsat3 is None else tuple(
            torch.as_tensor(c[p], dtype=f64, device=device)
            for c in part.condsat3),
        xt3d=None, system_dtopo=None, **pkgs)
    if part.condsat3 is None:
        lm.finalize_setup()       # the edge path: per-edge condsat
    return lm


class ShardedSolution:
    """Solves time steps of a row-partitioned GWF model over P shards.

    ``devices``: the shards' devices (see ``resolve_devices``); the CUDA
    device, repeated, by default."""

    def __init__(self, part: RowPartition, settings: ImsSettings,
                 devices=None):
        check_settings(settings, "the sharded solve")
        refuse_unsharded(part.model, "the sharded solve")
        self.part = part
        self.s = settings
        self.devices = resolve_devices(devices, part.nshards)
        self.models = [_row_local_model(part, p, d)
                       for p, d in enumerate(self.devices)]
        self.own = ShardVec([torch.as_tensor(part.own_mask, device=d)
                             for d in self.devices])
        self.dot, self.absmax = owned_reductions(self.own)
        g = part.grid_local
        self._lshape = (g.nlay, g.nrow, g.ncol)

    # ---------------------------------------------------------------- halo

    def _halo_exchange(self, x):
        """The two halo rows from the owning neighbours: my last owned row
        → the next shard's north halo (row 0), my first owned row → the
        previous shard's south halo (row -1); rows outside the domain get
        zeros, as the reference's ppermute leaves them."""
        nlay, nrl2, ncol = self._lshape
        if x.stack is not None:
            # all shards on one device: the copies as two strided stores
            x4 = x.stack.view(-1, nlay, nrl2, ncol)
            out = x4.clone()
            out[1:, :, 0, :] = x4[:-1, :, -2, :]
            out[:-1, :, -1, :] = x4[1:, :, 1, :]
            out[0, :, 0, :] = 0.0
            out[-1, :, -1, :] = 0.0
            return ShardVec.stacked(out.view(x.stack.shape))
        x3 = [t.view(nlay, nrl2, ncol) for t in x.parts]
        P = len(x3)
        out = []
        for p, (a, dev) in enumerate(zip(x3, self.devices)):
            with on_device(dev):
                north = (x3[p - 1][:, -2:-1, :].to(dev) if p > 0
                         else torch.zeros_like(a[:, :1, :]))
                south = (x3[p + 1][:, 1:2, :].to(dev) if p < P - 1
                         else torch.zeros_like(a[:, :1, :]))
                out.append(torch.cat([north, a[:, 1:-1, :], south], dim=1)
                           .reshape(-1))
        return ShardVec(out)

    # ------------------------------------------------------------ driving

    def solve_timestep(self, head_stacked, delt, kstp=1, iss=False):
        """One time step.  ``head_stacked``: the [P, N_local] heads with
        their halo rows (a ShardVec, or a stacked array or tensor).  Returns
        (heads as a ShardVec, dict(outer, converged, inner))."""
        head = (head_stacked if isinstance(head_stacked, ShardVec)
                else stack_to_shards(head_stacked, self.devices))
        lms = self.models
        # CHD rp/ad on every shard (owned and halo copies)
        ib, head = _wrap([lm.boundary_state(h)
                          for lm, h in zip(lms, head.parts)])
        head = self._halo_exchange(head)
        head, kiter, converged, inner = implicit_local_solve(
            lms, head, head, ib, delt, bool(iss), self.s,
            self.s.linear_acceleration == "cg", self._halo_exchange,
            self.dot, self.absmax, kstp, self.own)
        return head, dict(outer=kiter, converged=converged, inner=inner)

    # ------------------------------------------------ layout conversions

    def scatter_heads(self, head_global):
        """Global flat head → a ShardVec of the shards' slabs with their
        halo rows (zeros outside the domain)."""
        part = self.part
        nlay, nrl2, ncol = self._lshape
        nrl = part.nrow_local
        nrow = nrl * part.nshards
        h3 = host(head_global).reshape(nlay, nrow, ncol)
        out = np.zeros((part.nshards, nlay, nrl2, ncol))
        for p in range(part.nshards):
            r0, r1 = p * nrl - 1, (p + 1) * nrl + 1
            s0, s1 = max(r0, 0), min(r1, nrow)
            out[p][:, s0 - r0:s1 - r0, :] = h3[:, s0:s1, :]
        return stack_to_shards(out.reshape(part.nshards, -1), self.devices)

    def gather_heads(self, head_stacked):
        """The shards' heads → the global flat head (owned rows only), as
        a numpy array."""
        part = self.part
        nlay, nrl2, ncol = self._lshape
        hs = (shards_to_stack(head_stacked)
              if isinstance(head_stacked, ShardVec) else host(head_stacked)
              ).reshape(part.nshards, nlay, nrl2, ncol)
        return np.concatenate([hs[p][:, 1:-1, :]
                               for p in range(part.nshards)],
                              axis=1).reshape(-1)
