"""Sharded augmented models: MAW/LAK/SFR feature rows on the general
partition.

Port of modflow6_tpu/parallel/augmented.py (the role of distributing the
reference's advanced packages with their models: each MPI rank owns its
models' packages, and the feature-cell coefficients at a boundary ride the
interface-model matrix, SpatialModelConnection.f90).  Each feature row is
OWNED by the shard that owns its host cell (a well's or a lake's first
connection cell, a reach's cell).  Feature data is small (R ≪ N), so every
shard builds the full feature tables over its local cells; the rows of
features it does not own are identity rows under the owned-row mask, and
their values arrive by the halo exchange.  The owner's rows are exact:
its halo is widened to hold every connection cell of its features
(``partition_general(extra_halo=)``); on other shards a connection cell
that is not local maps to a pad node, in turn, as in the reference.

A shard's rows are [n_local cell slots | R feature rows], the feature rows
at their global index on every shard, so the feature halo is a plain
broadcast from the owner with one local index on both sides.  The shards'
tables are built at one width (``ktot_min``), as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.gwf.advanced import AugmentedGwfModel
from ..solution.ims import ImsSettings
from .general import (GeneralPartition, _boundary, build_local_models,
                      build_shift_maps, halo_exchange_shifts,
                      partition_general, shift_rounds)
from .sharded import (ShardVec, check_settings, implicit_local_solve,
                      owned_reductions, resolve_devices, shards_to_stack,
                      stack_to_shards)

# the cell fields of each feature kind's host spec, and (rows, owners)
_CELLS = {"maw": ("conn_node", "nwells", "conn_well"),
          "lak": ("conn_node", "nlakes", "conn_lake"),
          "sfr": ("node", "nreaches", None)}


def feature_cells(specs):
    """(feature of each connection, connection cell, host cell of each
    feature) over the features in row order MAW, LAK, SFR: a well's or a
    lake's host is its first connection cell, a reach's its cell."""
    feats, cells, hosts = [], [], []
    base = 0
    for kind in ("maw", "lak", "sfr"):
        spec = specs.get(kind)
        if spec is None:
            continue
        cell_key, n_key, owner_key = _CELLS[kind]
        cn = np.asarray(spec[cell_key], np.int64)
        n = int(spec[n_key])
        fo = (np.arange(n) if owner_key is None
              else np.asarray(spec[owner_key], np.int64))
        first = np.full(n, -1, np.int64)
        first[fo[::-1]] = np.arange(len(fo))[::-1]
        if (first < 0).any():
            raise ValueError(f"a {kind.upper()} feature has no connection")
        feats.append(base + fo)
        cells.append(cn)
        hosts.append(cn[first])
        base += n
    cat = (np.concatenate if feats else lambda _: np.zeros(0, np.int64))
    return cat(feats), cat(cells), cat(hosts)


@dataclasses.dataclass
class AugmentedPartition:
    part: GeneralPartition          # the cell partition (widened halos)
    own: np.ndarray                 # bool[P, n_aug]
    halo_perms: tuple               # the shift rounds over the aug rows
    halo_send: tuple                # [P, S_d] per shift
    halo_recv: tuple
    halo_pairs: dict
    owner_feat: np.ndarray          # i64[R]
    n_aug: int
    aug: object                     # the global AugmentedGwfModel
    specs: list                     # per shard: the host specs, local cells


def _local_specs(aug, part, p):
    """Shard ``p``'s host specs: connection cells in local numbers, the
    ones not local on the pad nodes in turn (the reference's counter)."""
    loc, g2l, _ = part.locals_info[p]
    nl = len(loc)
    npad = part.n_local - nl
    counter = 0
    out = {}
    for kind in ("maw", "lak", "sfr"):
        spec = aug.specs[kind]
        if spec is None:
            out[kind] = None
            continue
        key = _CELLS[kind][0]
        cells = np.asarray(spec[key], np.int64)
        li = g2l[cells]
        miss = li < 0
        nmiss = int(miss.sum())
        li[miss] = nl + (counter + np.arange(nmiss)) % max(npad, 1)
        counter += nmiss
        out[kind] = {**spec, key: li}
    return out


def partition_augmented(aug: AugmentedGwfModel, nshards, owner=None):
    """Split an augmented model: cells by blocks, each feature to its host
    cell's shard, the feature tables on every shard."""
    if aug.mvr is not None:
        raise NotImplementedError(
            "sharded augmented models do not distribute MVR yet")
    base = aug.base
    N = base.nodes
    if owner is None:
        bounds = np.linspace(0, N, nshards + 1).astype(np.int64)
        owner = np.repeat(np.arange(nshards, dtype=np.int64),
                          np.diff(bounds))
    else:
        owner = np.asarray(owner, np.int64)

    conn_feat, conn_cell, hosts = feature_cells(aug.specs)
    R = aug.n_extra
    if len(hosts) != R:
        raise ValueError("the feature table does not match the model rows")
    owner_feat = owner[hosts]
    conn_owner = owner_feat[conn_feat]
    extra_halo = {p: conn_cell[conn_owner == p] for p in range(nshards)}

    part = partition_general(base, nshards, owner=owner,
                             extra_halo=extra_halo)
    n_local = part.n_local
    n_aug = n_local + R

    own = np.zeros((nshards, n_aug), bool)
    own[:, :n_local] = part.own
    own[owner_feat, n_local + np.arange(R)] = True

    # halo maps over the aug rows: the cell pairs, then each feature
    # broadcast from its owner to every other shard
    pairs = {pq: (s.copy(), r.copy()) for pq, (s, r) in
             part.halo_pairs.items()}
    for p in range(nshards):
        rows = n_local + np.flatnonzero(owner_feat == p)
        if not len(rows):
            continue
        for q in range(nshards):
            if q == p:
                continue
            s, r = pairs.get((p, q), (np.zeros(0, np.int64),
                                      np.zeros(0, np.int64)))
            pairs[(p, q)] = (np.concatenate([s, rows]),
                             np.concatenate([r, rows]))
    perms, sends, recvs = build_shift_maps(pairs, nshards, n_aug)
    return AugmentedPartition(
        part=part, own=own, halo_perms=perms, halo_send=sends,
        halo_recv=recvs, halo_pairs=pairs, owner_feat=owner_feat,
        n_aug=n_aug, aug=aug,
        specs=[_local_specs(aug, part, p) for p in range(nshards)])


class ShardedAugmentedSolution:
    """Solves time steps of a sharded augmented model over P shards;
    ``devices`` as for ``sharded.ShardedSolution``."""

    def __init__(self, apart: AugmentedPartition, settings: ImsSettings,
                 devices=None):
        check_settings(settings, "the sharded augmented solve")
        self.apart = apart
        self.s = settings
        part = apart.part
        self.devices = resolve_devices(devices, part.nshards)
        bases = build_local_models(part, self.devices)

        def build(p, ktot_min):
            return AugmentedGwfModel(bases[p], ktot_min=ktot_min,
                                     **apart.specs[p])

        models = [build(p, 0) for p in range(part.nshards)]
        kmax = max(m.Ktot for m in models)
        self.models = [m if m.Ktot == kmax else build(p, kmax)
                       for p, m in enumerate(models)]
        self.own = stack_to_shards(apart.own, self.devices, torch.bool)
        self.dot, self.absmax = owned_reductions(self.own)
        self.rounds = shift_rounds(apart.halo_pairs, part.nshards,
                                   self.devices, apart.n_aug)

    def halo(self, v):
        return halo_exchange_shifts(v, self.rounds)

    def solve_timestep(self, x_stacked, delt, kstp=1, iss=False):
        x = (x_stacked if isinstance(x_stacked, ShardVec)
             else stack_to_shards(x_stacked, self.devices))
        lms = self.models
        ib, x = _boundary(lms, x)
        x = self.halo(x)
        x, kiter, converged, inner = implicit_local_solve(
            lms, x, x, ib, delt, bool(iss), self.s,
            self.s.linear_acceleration == "cg", self.halo, self.dot,
            self.absmax, kstp, self.own)
        return x, dict(outer=kiter, converged=converged, inner=inner)

    def scatter(self, x_global):
        """Global augmented vector [N + R] → a ShardVec of [n_aug] rows."""
        ap = self.apart
        part = ap.part
        N = part.model.nodes
        g = np.asarray(x_global.detach().cpu() if isinstance(
            x_global, torch.Tensor) else x_global).reshape(-1)
        out = np.zeros((part.nshards, ap.n_aug))
        for p in range(part.nshards):
            loc = part.local2global[p]
            sel = loc >= 0
            out[p, :part.n_local][sel] = g[loc[sel]]
            out[p, part.n_local:] = g[N:]
        return stack_to_shards(out, self.devices)

    def gather(self, x_stacked):
        """The shards' owned rows → the global [N + R] vector (numpy)."""
        ap = self.apart
        part = ap.part
        N = part.model.nodes
        xs = (shards_to_stack(x_stacked) if isinstance(x_stacked, ShardVec)
              else np.asarray(x_stacked))
        out = np.zeros(N + ap.n_aug - part.n_local)
        for p in range(part.nshards):
            sel = part.own[p]
            out[part.local2global[p][sel]] = xs[p, :part.n_local][sel]
        out[N:] = xs[ap.owner_feat, part.n_local + np.arange(len(
            ap.owner_feat))]
        return out
