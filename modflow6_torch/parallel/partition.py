"""Row-wise domain decomposition of a DIS model into shards.

Port of modflow6_tpu/parallel/partition.py (the role of the reference's
distributed runtime, src/Distributed/: where the reference gives each MPI
rank a model and mirrors its neighbours' data through virtual-data
containers and interface models, one DIS grid is split here into P row
slabs, each extended by one halo row on either side).  Each shard runs the
single-device assembly on its local (nlay, nrow_local + 2, ncol) grid; the
halo rows play the role of the reference's interface-model mirror cells
(GridConnection.f90): their values are copied from the owning shards
before every assembly and product, and their matrix rows are identity rows
(cf. connectionMask, Connections.f90:28).

Everything here is host numpy: the per-shard planes are stacked [P,
N_local] arrays as in the reference; each boundary list is remapped to
every shard whose slab (owned rows or halo rows) holds its cells, one list
per shard with its own length.  Nothing is padded, so no padded entry can
land on a real node (the reference pads to one length with node 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.discretization import DisGrid

# the list packages and their value fields, in the reference's order
PACKAGE_FIELDS = (("chd", ("head",)), ("wel", ("q",)),
                  ("rch", ("recharge",)), ("drn", ("elev", "cond", "ddrn")),
                  ("riv", ("stage", "cond", "rbot")),
                  ("ghb", ("bhead", "cond")),
                  ("evt", ("surface", "rate", "depth")))


def host(a):
    """A tensor (or array) as a numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def entry_fields(data):
    """The per-entry host arrays of a list package's data, ``node`` and
    ``mask`` among them (EVT's segment tables too)."""
    out = {}
    for f in dataclasses.fields(data):
        v = getattr(data, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = host(v)
    return out


@dataclasses.dataclass
class RowPartition:
    """Host-side description of the P-way row split."""

    nshards: int
    nrow_local: int          # owned rows per shard
    grid_local: DisGrid      # the (nlay, nrow_local+2, ncol) halo-extended grid
    topo_local: object       # its host topology (shared by all shards)
    own_mask: np.ndarray     # bool[N_local] rows owned by the shard (no halo)
    # stacked per-shard arrays, leading axis = shard:
    npf_arrays: dict         # NPF field → [P, N_local] (None where absent)
    sto_arrays: dict         # STO field → [P, N_local], or None
    ibound0: np.ndarray      # i32[P, N_local]
    strt: np.ndarray         # [P, N_local]
    area: np.ndarray         # [P, N_local]
    # package name → per shard {field: entries} (with ``node`` local), or
    # None when the model has no such package
    pkgs: dict
    # (cx, cy, cz) stacked [P, ...] saturated conductances sliced from the
    # global model's planes (they carry its HFB changes); None on the
    # edge path (rotated anisotropy), which rebuilds them per shard
    condsat3: tuple
    model: object            # the global model (options, flags)

    @property
    def n_local(self) -> int:
        return int(self.own_mask.shape[0])

    def local_row_shape(self):
        g = self.grid_local
        return (g.nlay, g.nrow, g.ncol)


def _slice_rows(arr3, r0, r1, nrow):
    """Slice rows [r0, r1) with zero padding outside [0, nrow)."""
    nlay, _, ncol = arr3.shape
    out = np.zeros((nlay, r1 - r0, ncol), arr3.dtype)
    s0, s1 = max(r0, 0), min(r1, nrow)
    out[:, s0 - r0:s1 - r0, :] = arr3[:, s0:s1, :]
    return out


def refuse_unsharded(model, what):
    """The model features that no sharded runner distributes, refused by
    name (the reference's runners read past them)."""
    for attr, name in (("gnc", "GNC"), ("wetdry", "rewetting (WETDRY)")):
        if getattr(model, attr, None) is not None:
            raise NotImplementedError(f"{what} does not distribute {name}")
    if getattr(model, "inewtonur", 0):
        raise NotImplementedError(
            f"{what} does not run the Newton UNDER_RELAXATION option")


def partition_model(model, nshards: int) -> RowPartition:
    """Split a DIS GwfModel into row shards.

    Covers the single-device structured path: NPF (Newton, HFB through the
    sliced planes, rotated anisotropy on the edge path), STO and the list
    packages CHD/WEL/RCH/DRN/RIV/GHB/EVT.  What the sharded assembly does
    not carry raises here by name rather than dropping physics."""
    grid = model.grid
    if type(model).__name__ != "GwfModel":
        raise NotImplementedError(
            f"row sharding supports a plain GwfModel only, got "
            f"{type(model).__name__} (MAW/LAK/SFR rows: "
            f"parallel.augmented.partition_augmented)")
    if not isinstance(grid, DisGrid):
        raise NotImplementedError(
            "row sharding needs a DIS grid; use "
            "parallel.general.partition_general")
    if model.ixt3d:
        raise NotImplementedError(
            "row sharding does not support XT3D; use "
            "parallel.general.partition_general (depth-2 halos)")
    for attr, name in (("buy", "BUY"), ("vsc", "VSC"), ("csub", "CSUB")):
        if getattr(model, attr) is not None:
            raise NotImplementedError(
                f"row sharding does not carry {name}; use "
                f"parallel.general.partition_general")
    refuse_unsharded(model, "row sharding")
    if model.hfb and model.condsat3 is None:
        raise NotImplementedError(
            "sharded HFB requires the structured condsat path (DIS grid "
            "without rotated anisotropy angles)")
    nlay, nrow, ncol = grid.shape
    if nrow % nshards:
        raise ValueError("nrow must divide evenly across shards")
    if not np.allclose(grid.delc, grid.delc[0]):
        raise NotImplementedError(
            "row partitioning requires uniform delc (one local topology "
            "shared by the shards)")
    nrl = nrow // nshards

    # the local halo-extended grid: its structure is shared by the shards,
    # their geometry (top/bot) goes into the per-shard arrays
    grid_local = DisGrid.create(
        nlay, nrl + 2, ncol, grid.delr,
        np.concatenate([[grid.delc[0]], grid.delc[:nrl + 1]]),
        np.zeros((nrl + 2, ncol)), np.zeros((nlay, nrl + 2, ncol)))
    topo_local = (grid_local.build_topology() if model.use_structured
                  else grid_local.build_edge_topology())

    own = np.zeros((nlay, nrl + 2, ncol), bool)
    own[:, 1:-1, :] = True
    own_mask = own.reshape(-1)

    def stack_field(global_flat, fill=0.0):
        g3 = host(global_flat).reshape(nlay, nrow, ncol)
        parts = []
        for p in range(nshards):
            loc = _slice_rows(g3, p * nrl - 1, (p + 1) * nrl + 1, nrow)
            if fill != 0.0:
                # the fill of halo rows outside the global domain
                if p == 0:
                    loc[:, 0, :] = fill
                if p == nshards - 1:
                    loc[:, -1, :] = fill
            parts.append(loc.reshape(-1))
        return np.stack(parts)

    na = model.npf_arrays
    npf_stacked = {}
    for f in ("icelltype", "k11", "k22", "k33", "angle1", "angle2",
              "angle3", "bot"):
        v = getattr(na, f)
        npf_stacked[f] = None if v is None else stack_field(v)
    npf_stacked["top"] = stack_field(na.top, fill=1.0)

    sto_stacked = None
    if model.sto_arrays is not None:
        sa = model.sto_arrays
        sto_stacked = {f: stack_field(getattr(sa, f))
                       for f in ("iconvert", "ss", "sy", "area")}

    # halo rows outside the global domain stay inactive (0 fill)
    ibound0 = stack_field(model.ibound0)
    strt = stack_field(model.strt)
    area = stack_field(model.area)

    def remap_bound(data):
        """A global boundary list on every shard whose slab (owned + halo
        rows) holds its cells, in entry order."""
        if data is None:
            return None
        cols = entry_fields(data)
        node_g, mask_g = cols.pop("node"), cols.pop("mask")
        kk, ii, jj = np.unravel_index(node_g, (nlay, nrow, ncol))
        per_shard = []
        for p in range(nshards):
            r0 = p * nrl - 1
            sel = (ii >= r0) & (ii < (p + 1) * nrl + 1) & mask_g
            loc = (kk[sel] * (nrl + 2) + ii[sel] - r0) * ncol + jj[sel]
            per_shard.append(dict(node=loc.astype(np.int64),
                                  **{f: v[sel] for f, v in cols.items()}))
        return per_shard

    pkgs = {name: remap_bound(getattr(model, name))
            for name, _ in PACKAGE_FIELDS}

    # slices of the global planes (they carry the HFB changes).  cx
    # (nlay, nrow, ncol-1) and cz (nlay-1, nrow, ncol) slice on cell rows
    # like any field; cy (nlay, nrow-1, ncol) on row edges: local edge i
    # joins local rows (i, i+1), global edge r0 + i, so the slice is
    # [r0, r0 + nrl + 1) over the nrow-1 edges
    condsat3 = None
    if model.condsat3 is not None:
        cx_g, cy_g, cz_g = (host(c) for c in model.condsat3)

        def stack_rows(arr3, r1_of):
            return np.stack([_slice_rows(arr3, p * nrl - 1, r1_of(p),
                                         arr3.shape[1])
                             for p in range(nshards)])

        condsat3 = (stack_rows(cx_g, lambda p: (p + 1) * nrl + 1),
                    stack_rows(cy_g, lambda p: p * nrl + nrl),
                    stack_rows(cz_g, lambda p: (p + 1) * nrl + 1))

    return RowPartition(
        nshards=nshards, nrow_local=nrl, grid_local=grid_local,
        topo_local=topo_local, own_mask=own_mask,
        npf_arrays=npf_stacked, sto_arrays=sto_stacked,
        ibound0=ibound0, strt=strt, area=area, pkgs=pkgs,
        condsat3=condsat3, model=model)
