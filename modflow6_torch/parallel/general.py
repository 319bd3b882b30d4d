"""General (gather-based) domain decomposition: any grid, any stencil.

Port of modflow6_tpu/parallel/general.py (the role of the reference's
interface-model machinery for any model and grid,
SpatialModelConnection.f90:37-66 + GridConnection.f90:31-80): each shard
owns a contiguous block of global nodes (or the nodes of an owner vector)
plus a halo ring of depth 1, or 2 for full XT3D (the reference's
stencil-depth expansion), and runs the single-device edge-list assembly on
its local model: the global GwfModel with its tensors swapped for the
shard's slices.  So every package that the general assembly supports (NPF
with Newton and rotated anisotropy, XT3D, STO, HFB-modified conductances,
the list packages, BUY/VSC, CSUB without delay beds) runs sharded by
construction.  DIS, DISV and DISU models work, and models merged by
``merge_gwf_models`` (their exchange edges are edges here, and the halo
crosses them like any other).

The halo is refreshed by shift rounds (the MpiRouter.route_* role): shard
pairs are grouped by their ring shift d = (q - p) mod P, as in the
reference's ``build_shift_maps``, and each round copies, for each pair of
the shift, the sender's values (an ``index_select`` of its owned slots)
into the receiver's halo slots (an indexed store), the rounds in the
reference's order.  The Krylov reductions are the owned-row partials of
``sharded.owned_reductions``.

The partition is host numpy; its tables equal the reference's
(``local2global``, ``own``, the halo maps, the remapped boundary lists).
Shards keep the reference's common padded size ``n_local`` (pad nodes
inactive, pad edges between pad-node pairs), while each shard's boundary
lists hold its own entries only, unpadded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.discretization.topology import Topology
from ..models.gwf import npf as npf_mod
from ..ops.scatter import AddPlan
from ..solution.ims import ImsSettings
from .partition import PACKAGE_FIELDS, entry_fields, host, refuse_unsharded
from .sharded import (ShardVec, check_settings, implicit_local_solve,
                      local_package, owned_reductions, resolve_devices,
                      shards_to_stack, stack_to_shards)

__all__ = ["GeneralPartition", "GeneralShardedSolution",
           "build_shift_maps", "halo_exchange_shifts",
           "implicit_local_solve", "owner_from_partitions",
           "partition_general"]


class _CenterShim:
    """Grid stand-in for a shard's XT3D build (the cell-center path of
    ``xt3d.cell_centers``)."""

    def __init__(self, xc, yc, top, bot):
        self.xc, self.yc, self.top, self.bot = xc, yc, top, bot


@dataclasses.dataclass
class GeneralPartition:
    """Host-side description of a node-block split with halos."""

    nshards: int
    n_local: int                 # padded local size (incl. the pad nodes)
    local2global: np.ndarray     # i64[P, n_local] (-1 = pad)
    own: np.ndarray              # bool[P, n_local]
    topos: list                  # per shard: its local host Topology
    npf_arrays: dict             # NPF field → [P, n_local] (None: absent)
    condsat: np.ndarray          # [P, Emax] per-edge saturated conductance
    sto_arrays: dict             # STO field → [P, n_local], or None
    ibound0: np.ndarray          # i32[P, n_local]
    strt: np.ndarray
    area: np.ndarray
    pkgs: dict                   # name → per shard {field: entries} or None
    send_idx: np.ndarray         # i64[P, P, S] local indices to send
    recv_idx: np.ndarray         # i64[P, P, S] local indices to fill
    model: object                # the global (template) GwfModel
    # per shard (loc, g2l, eids): the local nodes in global numbers, the
    # global → local map (-1 = not local), the global edges kept
    locals_info: list = None
    g2l_list: list = None
    # XT3D: per shard the center shim and the host arrays of its build
    xt3d_inputs: list = None
    # CSUB: per shard the local interbed selection and node slices
    ib_sel: list = None
    csub_parts: list = None
    # the halo shift rounds (build_shift_maps) and their pairs
    halo_perms: tuple = ()
    halo_send: tuple = ()
    halo_recv: tuple = ()
    halo_pairs: dict = None


def remap_bound(data, g2l_list):
    """A global boundary list on every shard that holds its cells (owned or
    halo), in entry order: per shard {field: entries} with local nodes.
    Nothing is padded (the reference pads each list to one length on an
    inactive pad node)."""
    if data is None:
        return None
    cols = entry_fields(data)
    node_g, mask_g = cols.pop("node"), cols.pop("mask")
    out = []
    for g2l in g2l_list:
        sel = g2l[node_g]
        keep = (sel >= 0) & mask_g
        out.append(dict(node=sel[keep], **{f: v[keep]
                                           for f, v in cols.items()}))
    return out


def owner_from_partitions(partitions, model_offsets, model_sizes, N):
    """Owner vector from an HPC6 PARTITIONS spec: every cell of a model
    goes to its rank (utl-hpc.dfn mname/mrank; the reference's
    DistributedSim explicit load balance)."""
    owner = np.zeros(N, np.int64)
    for mname, rank in partitions.items():
        off = model_offsets[mname.upper()]
        owner[off:off + model_sizes[mname.upper()]] = rank
    return owner


def build_shift_maps(pairs, nshards, dump):
    """Halo maps grouped by ring shift (MpiRouter.f90:627 update_senders):
    each distinct shift d = (q - p) mod P is one round, sized by its
    largest pair.  ``pairs``: {(p, q): (send_local_idx, recv_local_idx)}.
    Returns (perms, sends, recvs): per round the (p, q) pairs of the shift
    and [P, S_d] index arrays, sends padded with 0 and receives with
    ``dump``, as the reference's."""
    by_shift = {}
    for (p, q), (si, ri) in pairs.items():
        by_shift.setdefault((q - p) % nshards, {})[p] = (si, ri)
    perms, sends, recvs = [], [], []
    for d in sorted(by_shift):
        entries = by_shift[d]
        S_d = max(len(si) for si, _ in entries.values())
        send_d = np.zeros((nshards, S_d), np.int64)
        recv_d = np.full((nshards, S_d), dump, np.int64)
        for p, (si, ri) in entries.items():
            q = (p + d) % nshards
            send_d[p, :len(si)] = si
            recv_d[q, :len(ri)] = ri
        perms.append(tuple((p, (p + d) % nshards) for p in range(nshards)))
        sends.append(send_d)
        recvs.append(recv_d)
    return tuple(perms), tuple(sends), tuple(recvs)


@dataclasses.dataclass
class HaloRounds:
    """The rounds of ``build_shift_maps`` as device index tensors, each
    pair's own entries only: ``rounds`` [[(p, q, send on p's device, recv on
    q's device)] per round], in the reference's round order; and, for
    shards stacked on one device, every round's sends and receives as flat
    positions into the [P, n] stack (``flat_send``, ``flat_recv``)."""

    rounds: list
    flat_send: torch.Tensor = None
    flat_recv: torch.Tensor = None


def shift_rounds(pairs, nshards, devices, n):
    """The ``HaloRounds`` of ``pairs`` for shards of ``n`` slots."""
    by_shift = {}
    for (p, q), (si, ri) in pairs.items():
        by_shift.setdefault((q - p) % nshards, []).append((p, q, si, ri))
    rounds, fs, fr = [], [], []
    for d in sorted(by_shift):
        rounds.append([
            (p, q, torch.as_tensor(si, dtype=torch.int64, device=devices[p]),
             torch.as_tensor(ri, dtype=torch.int64, device=devices[q]))
            for p, q, si, ri in sorted(by_shift[d])])
        for p, q, si, ri in sorted(by_shift[d]):
            fs.append(p * n + np.asarray(si, np.int64))
            fr.append(q * n + np.asarray(ri, np.int64))
    out = HaloRounds(rounds)
    if len(set(devices)) == 1 and fs:
        out.flat_send = torch.as_tensor(np.concatenate(fs), device=devices[0])
        out.flat_recv = torch.as_tensor(np.concatenate(fr), device=devices[0])
    return out


def halo_exchange_shifts(x, halo):
    """The halo slots of every shard refreshed from their owners, round by
    round (``HaloRounds``): the receiver's halo slots take the sender's
    values.  Returns a new ShardVec; ``x`` is left as it is.  A sender
    sends owned slots only, which no round writes, so for shards stacked on
    one device all rounds are one gather and one indexed store."""
    if x.stack is not None and halo.flat_send is not None:
        out = x.stack.clone()
        flat = out.view(-1)
        flat[halo.flat_recv] = x.stack.reshape(-1)[halo.flat_send]
        return ShardVec.stacked(out)
    if x.stack is not None and not halo.rounds:
        return x
    out = list(x.parts)
    fresh = [False] * len(out)
    for pairs in halo.rounds:
        bufs = [(q, r_idx, out[p].index_select(0, s_idx))
                for p, q, s_idx, r_idx in pairs]
        for q, r_idx, buf in bufs:
            if not fresh[q]:
                out[q] = out[q].clone()
                fresh[q] = True
            out[q][r_idx] = buf.to(out[q].device)
    return ShardVec(out)


def _default_owner(model, nshards):
    N = model.nodes
    if model.csub is not None:
        # column-aligned split: every cell of a column shares a shard, so
        # the owned up-chains are complete
        ncpl = model.csub.ncpl
        cb = np.linspace(0, ncpl, nshards + 1).astype(np.int64)
        col_owner = np.repeat(np.arange(nshards), np.diff(cb))
        return np.tile(col_owner, N // ncpl)
    bounds = np.linspace(0, N, nshards + 1).astype(np.int64)
    return np.repeat(np.arange(nshards, dtype=np.int64), np.diff(bounds))


def global_edges(model):
    """(host edge Topology, per-edge saturated conductance) of the global
    model: a structured DIS model's planes read per edge (cx for x edges,
    cy for y, cz for z, at the edge's lower cell, the HFB changes with
    them)."""
    na = model.npf_arrays
    if not model.use_structured:
        topo = model.topo
        cs = (np.zeros(topo.nedges) if na.condsat is None
              else host(na.condsat))
        return topo, cs
    topo = model.grid.build_edge_topology()
    shape = model.dtopo.grid_shape
    k, i, j = np.unravel_index(np.asarray(topo.edge_n, np.int64), shape)
    planes = [host(c) for c in model.condsat3]
    d = np.asarray(topo.direction)
    cs = np.zeros(topo.nedges)
    for axis in range(3):
        sel = d == axis
        cs[sel] = planes[axis][k[sel], i[sel], j[sel]]
    return topo, cs


def partition_general(model, nshards, owner=None, depth=None,
                      extra_halo=None):
    """Split any GwfModel into ``nshards`` node blocks with halos.

    ``owner``: optional i64[N] shard of each node (default: contiguous
    equal blocks, the reference's set_load_balance_default role,
    DistributedSim.f90:297; column-aligned with CSUB).  ``depth``: halo
    depth override (transport layered on the same split needs 2 for the
    dispersion and TVD stencils).  ``extra_halo``: {shard: global nodes}
    that a layered model (feature rows) also needs local.

    BUY/VSC ride along (species-scalar data; the coupling concentration
    passes per solve as ``solve_timestep(conc=...)``).  CSUB no-delay
    interbeds go to the shards of their host cells; the geostatic load
    sums through an up-chain gather, which needs column-aligned ownership
    (the reference's horizontal load balancing)."""
    if model.csub is not None and model.csub.delay is not None:
        raise NotImplementedError(
            "general sharding does not distribute DELAY interbeds yet")
    refuse_unsharded(model, "general sharding")
    N = model.nodes
    if depth is None:
        depth = 2 if model.ixt3d == 1 else 1
    has_csub = model.csub is not None
    if owner is None:
        owner = _default_owner(model, nshards)
    else:
        owner = np.asarray(owner, np.int64)
        if owner.shape != (N,) or owner.min() < 0 \
                or owner.max() >= nshards:
            raise ValueError(
                f"the owner vector must give each of the {N} nodes a shard "
                f"in 0..{nshards - 1} (an HPC6 rank beyond the shards)")
        if has_csub:
            o2 = owner.reshape(-1, model.csub.ncpl)
            if not (o2 == o2[0]).all():
                raise ValueError(
                    "CSUB sharding requires column-aligned ownership "
                    "(same shard for every layer of a column)")
    topo, condsat_g = global_edges(model)
    en = np.asarray(topo.edge_n, np.int64)
    em = np.asarray(topo.edge_m, np.int64)

    local_sets = []
    for p in range(nshards):
        owned = np.flatnonzero(owner == p)
        # ring expansion over the edge lists
        inring = np.zeros(N, bool)
        inring[owned] = True
        halo_parts = []
        for _ in range(depth):
            new = np.zeros(N, bool)
            sel = inring[en] & ~inring[em]
            new[em[sel]] = True
            sel = inring[em] & ~inring[en]
            new[en[sel]] = True
            nxt = np.flatnonzero(new)
            halo_parts.append(nxt)
            inring[nxt] = True
        if extra_halo and p in extra_halo:
            extra = np.setdiff1d(np.asarray(extra_halo[p], np.int64),
                                 np.flatnonzero(inring))
            if len(extra):
                halo_parts.append(extra)
                inring[extra] = True
        halo = (np.concatenate(halo_parts) if halo_parts
                else np.zeros(0, np.int64))
        local_sets.append((owned, halo))

    K_pad = topo.max_degree
    locals_info, g2l_list = [], []
    Emax, Emin = 0, None
    for owned, halo in local_sets:
        loc = np.concatenate([owned, halo])
        g2l = np.full(N, -1, np.int64)
        g2l[loc] = np.arange(len(loc))
        g2l_list.append(g2l)
        eids = np.flatnonzero((g2l[en] >= 0) & (g2l[em] >= 0))
        Emax = max(Emax, len(eids))
        Emin = len(eids) if Emin is None else min(Emin, len(eids))
        locals_info.append((loc, g2l, eids))

    # pad edges join dedicated inactive pad-node pairs, at most K_pad edges
    # per pair, so the ELL width stays the global maximum degree
    npad_max = Emax - Emin
    n_pad_nodes = max(2, 2 * int(np.ceil(npad_max / max(K_pad, 1))))
    n_local = max(len(o) + len(h) for o, h in local_sets) + n_pad_nodes
    pad_base = n_local - n_pad_nodes

    l2g = np.full((nshards, n_local), -1, np.int64)
    own = np.zeros((nshards, n_local), bool)
    for p, (owned, _) in enumerate(local_sets):
        loc = locals_info[p][0]
        l2g[p, :len(loc)] = loc
        own[p, :len(owned)] = True

    def slice_nodes(arr, fill=0.0):
        g = host(arr).reshape(-1)
        out = np.full((nshards, n_local), fill, g.dtype)
        for p, (loc, _, _) in enumerate(locals_info):
            out[p, :len(loc)] = g[loc]
        return out

    topos = []
    cs = np.zeros((nshards, Emax))
    for p, (loc, g2l, eids) in enumerate(locals_info):
        npad = Emax - len(eids)
        ipair = np.arange(npad) // max(K_pad, 1)
        topos.append(Topology(
            nodes=n_local,
            edge_n=np.concatenate([g2l[en[eids]],
                                   pad_base + 2 * ipair]).astype(np.int32),
            edge_m=np.concatenate([g2l[em[eids]],
                                   pad_base + 2 * ipair + 1]).astype(
                                       np.int32),
            ihc=np.concatenate([np.asarray(topo.ihc)[eids],
                                np.ones(npad, np.int64)]).astype(np.int32),
            cl1=np.concatenate([np.asarray(topo.cl1)[eids], np.ones(npad)]),
            cl2=np.concatenate([np.asarray(topo.cl2)[eids], np.ones(npad)]),
            hwva=np.concatenate([np.asarray(topo.hwva)[eids],
                                 np.zeros(npad)]),
            direction=np.full(Emax, -1, np.int32),
            anglex=np.concatenate([np.asarray(topo.anglex)[eids],
                                   np.zeros(npad)]),
            grid_shape=None, pad_degree=K_pad))
        cs[p, :len(eids)] = condsat_g[eids]

    na = model.npf_arrays
    fills = dict(k11=1.0, k22=1.0, k33=1.0, top=1.0)
    npf_s = {f: (None if getattr(na, f) is None
                 else slice_nodes(getattr(na, f), fills.get(f, 0.0)))
             for f in ("icelltype", "k11", "k22", "k33", "angle1", "angle2",
                       "angle3", "top", "bot")}
    sto_s = None
    if model.sto_arrays is not None:
        sa = model.sto_arrays
        sto_s = {f: slice_nodes(getattr(sa, f), fill)
                 for f, fill in (("iconvert", 0), ("ss", 0.0), ("sy", 0.0),
                                 ("top", 1.0), ("bot", 0.0), ("area", 1.0))}
    ib_s = slice_nodes(model.ibound0)
    strt_s = slice_nodes(model.strt)
    area_s = slice_nodes(model.area, 1.0)

    xt3d_inputs = None
    if model.ixt3d:
        from ..models.gwf.xt3d import cell_centers
        xc, yc, _ = cell_centers(model.grid)
        xs, ys = slice_nodes(xc), slice_nodes(yc)
        xt3d_inputs = [_CenterShim(xs[p], ys[p], npf_s["top"][p],
                                   npf_s["bot"][p])
                       for p in range(nshards)]

    ib_sel = csub_parts = None
    if has_csub:
        c = model.csub
        ncpl = c.ncpl
        ibn = host(c.ib_node)
        ib_sel, csub_parts = [], []
        node_fields = dict(sgm=0.0, sgs=0.0, cg_ske_cr=0.0, cg_theta=0.2,
                           cg_thickini=0.0, sig0=0.0)
        sliced = {f: slice_nodes(getattr(c, f), fill)
                  for f, fill in node_fields.items()}
        for p, (loc, g2l, _) in enumerate(locals_info):
            sel = np.flatnonzero(g2l[ibn] >= 0)
            ib_sel.append(sel)
            # the up-chain in local numbers (-1: top of the column)
            up = np.full(n_local, -1, np.int64)
            ug = loc - ncpl
            has_up = ug >= 0
            up[:len(loc)][has_up] = g2l[ug[has_up]]
            csub_parts.append(dict(up=up, sel=sel, loc_nodes=g2l[ibn[sel]],
                                   **{f: v[p] for f, v in sliced.items()}))

    # halo maps: shard q needs its halo nodes from their owners
    pairs = {}
    for q, (_, halo_q) in enumerate(local_sets):
        if not len(halo_q):
            continue
        hp = owner[halo_q]
        for p in np.unique(hp):
            gl = halo_q[hp == p]
            pairs[(int(p), q)] = (g2l_list[int(p)][gl], g2l_list[q][gl])
    S = max((len(v[0]) for v in pairs.values()), default=1)
    send = np.zeros((nshards, nshards, S), np.int64)
    recv = np.full((nshards, nshards, S), n_local, np.int64)
    for (p, q), (si, ri) in pairs.items():
        send[p, q, :len(si)] = si
        recv[q, p, :len(ri)] = ri
    halo_perms, halo_send, halo_recv = build_shift_maps(pairs, nshards,
                                                        n_local)

    return GeneralPartition(
        nshards=nshards, n_local=n_local, local2global=l2g, own=own,
        topos=topos, npf_arrays=npf_s, condsat=cs, sto_arrays=sto_s,
        ibound0=ib_s, strt=strt_s, area=area_s,
        pkgs={name: remap_bound(getattr(model, name), g2l_list)
              for name, _ in PACKAGE_FIELDS},
        send_idx=send, recv_idx=recv, model=model, locals_info=locals_info,
        g2l_list=g2l_list, xt3d_inputs=xt3d_inputs, ib_sel=ib_sel,
        csub_parts=csub_parts, halo_perms=halo_perms, halo_send=halo_send,
        halo_recv=halo_recv, halo_pairs=pairs)


def _local_csub(c, cp, n_local, device):
    """A shard's CsubData: node fields sliced, its interbeds selected, the
    local up-chain and the interbeds' sum plan."""
    sel = torch.as_tensor(cp["sel"], dtype=torch.int64, device=c.ib_node.device)

    def bed(name):
        v = getattr(c, name)
        return v.index_select(0, sel).to(device)

    node = torch.as_tensor(cp["loc_nodes"], dtype=torch.int64, device=device)
    return dataclasses.replace(
        c, ib_node=node, ib_thick=bed("ib_thick"), ib_rci=bed("ib_rci"),
        ib_ci=bed("ib_ci"), ib_theta=bed("ib_theta"),
        ib_ielastic=bed("ib_ielastic"),
        up=torch.as_tensor(cp["up"], dtype=torch.int64, device=device),
        ib_plan=AddPlan.build(cp["loc_nodes"], device, n_local),
        **{f: torch.as_tensor(cp[f], dtype=getattr(c, f).dtype,
                              device=device)
           for f in ("sgm", "sgs", "cg_ske_cr", "cg_theta", "cg_thickini",
                     "sig0")})


def build_local_models(part: GeneralPartition, devices):
    """The shards' local GwfModels: the global model with its tensors
    swapped for each shard's slices, on the shard's device.  XT3D builds
    each shard's tables, then rebuilds the narrower ones at the widest
    table's width (``ktot_min``), as the reference does."""
    model = part.model
    na = model.npf_arrays
    out = []
    for p, dev in enumerate(devices):
        def t(stacked, ref):
            return torch.as_tensor(stacked[p], dtype=ref.dtype, device=dev)

        arrays = dataclasses.replace(na, **{
            f: (None if v is None else t(v, getattr(na, f)))
            for f, v in part.npf_arrays.items()},
            condsat=torch.as_tensor(part.condsat[p], dtype=torch.float64,
                                    device=dev))
        sto_arrays = None
        if part.sto_arrays is not None:
            sa = model.sto_arrays
            sto_arrays = dataclasses.replace(sa, **{
                f: t(v, getattr(sa, f)) for f, v in part.sto_arrays.items()})
        pkgs = {name: None if part.pkgs[name] is None else local_package(
            getattr(model, name), part.pkgs[name][p], dev)
            for name, _ in PACKAGE_FIELDS}
        csub = None
        if part.csub_parts is not None:
            csub = _local_csub(model.csub, part.csub_parts[p], part.n_local,
                               dev)
        lt = part.topos[p]
        lm = dataclasses.replace(
            model, grid=None if part.xt3d_inputs is None
            else part.xt3d_inputs[p], topo=lt,
            dtopo=npf_mod.DeviceTopology.from_host(lt, dev),
            npf_arrays=arrays, sto_arrays=sto_arrays,
            strt=t(part.strt, model.strt),
            ibound0=t(part.ibound0, model.ibound0),
            area=t(part.area, model.area), delr=None, delc=None, hfb=None,
            condsat3=None, xt3d=None, system_dtopo=None, csub=csub,
            csub_state0=None, **pkgs)
        out.append(lm)
    if model.ixt3d:
        _build_local_xt3d(out, model)
    return out


def _build_local_xt3d(lms, model):
    from ..models.gwf.xt3d import build_xt3d

    o = model.npf_opts

    def build(lm, ktot_min):
        a = lm.npf_arrays
        return build_xt3d(lm.grid, lm.topo, a.k11, a.k22, a.k33,
                          a.angle1 if o.iangle1 else 0.0,
                          a.angle2 if o.iangle2 else 0.0,
                          a.angle3 if o.iangle3 else 0.0,
                          ixt3d=model.ixt3d, device=lm.device,
                          ktot_min=ktot_min)

    built = [build(lm, 0) for lm in lms]
    kmax = max(x.nbr_ext.shape[1] for x in built)
    for lm, xd in zip(lms, built):
        if xd.nbr_ext.shape[1] != kmax:
            xd = build(lm, kmax)
        lm.xt3d = xd
        if model.ixt3d == 1:
            # the solver's stencil is the extended table
            lm.system_dtopo = dataclasses.replace(lm.dtopo, nbr=xd.nbr_ext)


class GeneralShardedSolution:
    """Solves time steps of a generally partitioned model over P shards,
    each running the full single-device assembly on its local model.
    ``devices``: as for ``sharded.ShardedSolution``."""

    def __init__(self, part: GeneralPartition, settings: ImsSettings,
                 devices=None):
        check_settings(settings, "the general sharded solve")
        self.part = part
        self.s = settings
        self.devices = resolve_devices(devices, part.nshards)
        self.models = build_local_models(part, self.devices)
        self.own = stack_to_shards(part.own, self.devices, torch.bool)
        self.dot, self.absmax = owned_reductions(self.own)
        self.rounds = shift_rounds(part.halo_pairs, part.nshards,
                                   self.devices, part.n_local)

    def halo(self, v):
        return halo_exchange_shifts(v, self.rounds)

    def solve_timestep(self, head_stacked, delt, kstp=1, iss=False,
                       conc=None, csub_state=None):
        """One time step.  ``conc``: the shards' concentrations for BUY/VSC
        (``scatter_heads`` of the global field); ``csub_state``: the
        shards' CsubStates (``scatter_csub_state``)."""
        head = self.to_shards(head_stacked)
        lms = self.models
        pkgs = None
        if conc is not None or csub_state is not None:
            conc = None if conc is None else self.to_shards(conc)
            pkgs = [dataclasses.replace(
                lm.packages,
                csub_state=None if csub_state is None else csub_state[p],
                buy_conc=None if conc is None else conc.parts[p])
                for p, lm in enumerate(lms)]
        ib, head = _boundary(lms, head)
        head = self.halo(head)
        head, kiter, converged, inner = implicit_local_solve(
            lms, head, head, ib, delt, bool(iss), self.s,
            self.s.linear_acceleration == "cg", self.halo, self.dot,
            self.absmax, kstp, self.own, pkgs=pkgs)
        return head, dict(outer=kiter, converged=converged, inner=inner)

    def to_shards(self, v, dtype=torch.float64):
        return v if isinstance(v, ShardVec) else stack_to_shards(
            v, self.devices, dtype)

    def scatter_csub_state(self, state):
        """The global CsubState → the shards' states: es0/cg_comp sliced per
        node, pcs/comp selected per local interbed."""
        part = self.part
        out = []
        for p, (dev, sel) in enumerate(zip(self.devices, part.ib_sel)):
            loc = part.local2global[p]
            keep = loc >= 0

            def nodes(a):
                g = host(a)
                v = np.zeros(part.n_local)
                v[keep] = g[loc[keep]]
                return torch.as_tensor(v, dtype=a.dtype, device=dev)

            def beds(a):
                return torch.as_tensor(host(a)[sel], dtype=a.dtype,
                                       device=dev)

            out.append(dataclasses.replace(
                state, es0=nodes(state.es0), cg_comp=nodes(state.cg_comp),
                pcs=beds(state.pcs), comp=beds(state.comp)))
        return out

    def scatter_heads(self, head_global):
        return stack_to_shards(scatter_nodes(self.part, head_global),
                               self.devices)

    def gather_heads(self, head_stacked):
        return gather_nodes(self.part, head_stacked)


def _boundary(lms, x):
    """Each shard's boundary state (CHD or CNC cells) → (ibound, x)."""
    parts = [lm.boundary_state(v) for lm, v in zip(lms, x.parts)]
    return (ShardVec([ib for ib, _ in parts]),
            ShardVec([v for _, v in parts]))


def scatter_nodes(part, vec_global):
    """Global node values → the stacked [P, n_local] layout (zeros in the
    pad slots)."""
    g = host(vec_global).reshape(-1)
    out = np.zeros((part.nshards, part.n_local))
    for p in range(part.nshards):
        loc = part.local2global[p]
        sel = loc >= 0
        out[p, sel] = g[loc[sel]]
    return out


def gather_nodes(part, stacked):
    """The shards' owned values → the global node vector (numpy)."""
    hs = (shards_to_stack(stacked) if isinstance(stacked, ShardVec)
          else host(stacked))
    out = np.zeros(part.model.nodes)
    for p in range(part.nshards):
        sel = part.own[p]
        out[part.local2global[p][sel]] = hs[p][sel]
    return out
