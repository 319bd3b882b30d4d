"""DIS: structured (nlay, nrow, ncol) discretization, host numpy.

A numpy copy of ``modflow6_tpu`` DisGrid
(modflow6_tpu/models/discretization/dis.py).  The structured solve needs
only the grid shape; ``build_topology`` gives the connection layout that
the output files use (``topology.DisTopology``, which makes no edge list),
``build_edge_topology`` the reference's edge list with its geometry
(``topology.Topology``), which a DIS model on the general path assembles
through: one with rotated anisotropy, or one whose idomain < 0 passthrough
cells connect non-adjacent layers, which has no 7-point stencil
(``grid_shape`` is None then).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .topology import DisTopology, Topology


@dataclasses.dataclass(frozen=True)
class DisGrid:
    """Structured grid. All geometry arrays are host numpy, float64."""

    nlay: int
    nrow: int
    ncol: int
    delr: np.ndarray    # f64[ncol] column widths (along x)
    delc: np.ndarray    # f64[nrow] row widths (along y)
    top_surf: np.ndarray  # f64[nrow, ncol] top of model (layer 1 top)
    botm: np.ndarray    # f64[nlay, nrow, ncol] bottom of each layer
    idomain: np.ndarray  # int32[nlay, nrow, ncol] 0=inactive, >0 active, <0 passthrough
    xorigin: float = 0.0
    yorigin: float = 0.0
    angrot: float = 0.0

    @staticmethod
    def create(nlay, nrow, ncol, delr, delc, top, botm, idomain=None,
               xorigin=0.0, yorigin=0.0, angrot=0.0) -> "DisGrid":
        delr = np.broadcast_to(np.asarray(delr, np.float64), (ncol,)).copy()
        delc = np.broadcast_to(np.asarray(delc, np.float64), (nrow,)).copy()
        top = np.broadcast_to(np.asarray(top, np.float64), (nrow, ncol)).copy()
        botm = np.broadcast_to(np.asarray(botm, np.float64), (nlay, nrow, ncol)).copy()
        if idomain is None:
            idomain = np.ones((nlay, nrow, ncol), np.int32)
        else:
            idomain = np.broadcast_to(
                np.asarray(idomain, np.int32), (nlay, nrow, ncol)).copy()
        return DisGrid(nlay, nrow, ncol, delr, delc, top, botm, idomain,
                       float(xorigin), float(yorigin), float(angrot))

    @property
    def shape(self):
        return (self.nlay, self.nrow, self.ncol)

    @property
    def nodes(self) -> int:
        return self.nlay * self.nrow * self.ncol

    def node_number(self, k, i, j):
        """0-based node number from 0-based (layer, row, col)."""
        return (np.asarray(k) * self.nrow + np.asarray(i)) * self.ncol + np.asarray(j)

    def build_topology(self):
        """The connection layout in the reference's edge and CSR order: the
        7-point ``DisTopology`` of a structured grid, else the general
        ``Topology``."""
        shape = self.grid_shape
        if shape is None:
            return self.build_edge_topology()
        return DisTopology(shape, DisTopology.connections(self.idomain))

    def build_edge_topology(self) -> Topology:
        """The 7-point-stencil edge list with its geometry.

        Connections are only created between cells that both have
        idomain != 0; vertical passthrough cells (idomain < 0) connect the
        active cells above and below them.
        """
        nlay, nrow, ncol = self.nlay, self.nrow, self.ncol
        act = self.idomain != 0
        node = np.arange(self.nodes, dtype=np.int64).reshape(nlay, nrow, ncol)
        top3 = self.top.reshape(self.shape)
        bot3 = self.botm

        e_n, e_m, ihc, cl1, cl2, hwva, direction, anglex = (
            [] for _ in range(8))

        def add(nn, mm, ihc_v, c1, c2, w, d, ang):
            e_n.append(nn.ravel())
            e_m.append(mm.ravel())
            k = nn.size
            ihc.append(np.full(k, ihc_v, np.int32))
            cl1.append(np.asarray(c1, np.float64).ravel())
            cl2.append(np.asarray(c2, np.float64).ravel())
            hwva.append(np.asarray(w, np.float64).ravel())
            direction.append(np.full(k, d, np.int32))
            anglex.append(np.full(k, ang, np.float64))

        # x-direction (west→east): the n→m normal points +x (angle 0)
        if ncol > 1:
            shp = (nlay, nrow, ncol - 1)
            mask = act[:, :, :-1] & act[:, :, 1:]
            add(node[:, :, :-1][mask], node[:, :, 1:][mask], 1,
                np.broadcast_to(0.5 * self.delr[:-1], shp)[mask],
                np.broadcast_to(0.5 * self.delr[1:], shp)[mask],
                np.broadcast_to(self.delc[None, :, None], shp)[mask],
                0, 0.0)
        # y-direction (north→south): the n→m normal points -y (270°)
        if nrow > 1:
            shp = (nlay, nrow - 1, ncol)
            mask = act[:, :-1, :] & act[:, 1:, :]
            add(node[:, :-1, :][mask], node[:, 1:, :][mask], 1,
                np.broadcast_to(0.5 * self.delc[:-1, None], shp)[mask],
                np.broadcast_to(0.5 * self.delc[1:, None], shp)[mask],
                np.broadcast_to(self.delr[None, None, :], shp)[mask],
                1, 1.5 * np.pi)
        # z-direction (top→bottom), skipping idomain<0 passthrough layers
        # by connecting to the next active cell below
        structured_ok = True
        if nlay > 1:
            area2 = np.outer(self.delc, self.delr)
            for k in range(nlay - 1):
                tgt = np.full((nrow, ncol), -1, np.int64)
                remaining = act[k].copy()
                for kk in range(k + 1, nlay):
                    hit = remaining & (self.idomain[kk] > 0)
                    tgt[hit] = kk
                    remaining = remaining & ~hit & (self.idomain[kk] < 0)
                    if not remaining.any():
                        break
                mask = (self.idomain[k] > 0) & (tgt >= 0)
                if not mask.any():
                    continue
                ii, jj = np.nonzero(mask)
                kk_tgt = tgt[ii, jj]
                if (kk_tgt != k + 1).any():
                    structured_ok = False
                thick_n = top3[k, ii, jj] - bot3[k, ii, jj]
                thick_m = top3[kk_tgt, ii, jj] - bot3[kk_tgt, ii, jj]
                add(node[k, ii, jj], node[kk_tgt, ii, jj], 0, 0.5 * thick_n,
                    0.5 * thick_m, area2[ii, jj], 2, 0.0)

        if not e_n:
            empty_i = np.zeros(0, np.int32)
            empty_f = np.zeros(0, np.float64)
            return Topology(self.nodes, empty_i, empty_i, empty_i.copy(),
                            empty_f, empty_f.copy(), empty_f.copy(),
                            empty_i.copy(), empty_f.copy())
        edge_n = np.concatenate(e_n)
        edge_m = np.concatenate(e_m)
        order = np.lexsort((edge_m, edge_n))
        return Topology(
            nodes=self.nodes,
            edge_n=edge_n[order].astype(np.int32),
            edge_m=edge_m[order].astype(np.int32),
            ihc=np.concatenate(ihc)[order],
            cl1=np.concatenate(cl1)[order],
            cl2=np.concatenate(cl2)[order],
            hwva=np.concatenate(hwva)[order],
            direction=np.concatenate(direction)[order],
            anglex=np.concatenate(anglex)[order],
            grid_shape=self.shape if structured_ok else None)

    @property
    def top(self) -> np.ndarray:
        """f64[nodes] top elevation of every cell (layer k top = layer k-1 bottom)."""
        tops = np.concatenate([self.top_surf[None], self.botm[:-1]], axis=0)
        return tops.reshape(-1)

    @property
    def bot(self) -> np.ndarray:
        """f64[nodes] bottom elevation of every cell."""
        return self.botm.reshape(-1)

    @property
    def area(self) -> np.ndarray:
        """f64[nodes] horizontal cell area."""
        cell_area = np.outer(self.delc, self.delr)
        return np.tile(cell_area.reshape(-1), self.nlay)

    @property
    def grid_shape(self):
        """(nlay, nrow, ncol) for the 7-point stencil path, or None.

        The reference's DIS topology connects an active cell through
        idomain < 0 passthrough layers to the next active cell below
        (modflow6_tpu/models/discretization/dis.py:138-157); such a
        connection skips a layer and has no structured stencil slot, so the
        grid goes the general path.
        """
        idom = self.idomain
        for k in range(self.nlay - 1):
            # cells of layer k whose vertical neighbour is a passthrough
            # cell with an active cell somewhere below it
            remaining = (idom[k] > 0) & (idom[k + 1] < 0)
            for kk in range(k + 2, self.nlay):
                if not remaining.any():
                    break
                if (remaining & (idom[kk] > 0)).any():
                    return None
                remaining = remaining & (idom[kk] < 0)
        return self.shape
