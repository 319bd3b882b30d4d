"""Connection layout of a DIS grid: the edge order and the CSR pattern the
output files use.

A numpy counterpart of modflow6_tpu/models/discretization/topology.py
(``Topology.edge_n``/``edge_m``/``csr``) and of the edge list that
``DisGrid.build_topology`` makes (dis.py:91-180), for structured grids
only.  The solve needs none of it: the 7-point stencil works on dense
planes.  The budget file and the binary grid file do: FLOW-JA-FACE is one
value per CSR entry (diagonal first in each row, then ascending columns),
and the reference's per-edge arrays are over the symmetric half, sorted by
(n, m) with n < m.

On a structured grid the neighbours of cell n in ascending column order
are always [up, north, west, east, south, down] =
[n-ncpl, n-ncol, n-1, n+1, n+ncol, n+ncpl], so the whole layout follows
from one bool[N, 6] table of which of those connections exist; no edge
list is sorted and no per-edge loop runs.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

# CSR slot order of the six neighbours (ascending column), and for each the
# slot of the same connection seen from the other cell
UP, NORTH, WEST, EAST, SOUTH, DOWN = range(6)
_LOWER_SLOTS = (EAST, SOUTH, DOWN)      # neighbours m > n, ascending
_MIRROR = {EAST: WEST, SOUTH: NORTH, DOWN: UP}


@dataclasses.dataclass(frozen=True)
class DisTopology:
    """Static connection layout over the cells of a structured grid."""

    grid_shape: tuple       # (nlay, nrow, ncol)
    conn: np.ndarray        # bool[N, 6], slots [U, N, W, E, S, D]

    @staticmethod
    def connections(idomain) -> np.ndarray:
        """The ``conn`` table as the reference makes its connections:
        horizontal ones between cells that both have idomain != 0, vertical
        ones between vertically adjacent active cells (a grid whose
        idomain < 0 cells connect non-adjacent layers is not structured;
        ``DisGrid.grid_shape`` refuses it)."""
        idomain = np.asarray(idomain)
        nlay, nrow, ncol = idomain.shape
        exists = idomain != 0
        active = idomain > 0
        conn = np.zeros((nlay, nrow, ncol, 6), bool)
        x = exists[:, :, :-1] & exists[:, :, 1:]
        conn[:, :, :-1, EAST] = x
        conn[:, :, 1:, WEST] = x
        y = exists[:, :-1, :] & exists[:, 1:, :]
        conn[:, :-1, :, SOUTH] = y
        conn[:, 1:, :, NORTH] = y
        z = active[:-1] & active[1:]
        conn[:-1, :, :, DOWN] = z
        conn[1:, :, :, UP] = z
        return conn.reshape(-1, 6)

    @property
    def nodes(self) -> int:
        return int(self.conn.shape[0])

    @cached_property
    def _neighbour(self) -> np.ndarray:
        """int64[N, 6] neighbour node of each slot (meaningless where
        ``conn`` is False)."""
        _, nrow, ncol = self.grid_shape
        ncpl = nrow * ncol
        n = np.arange(self.nodes, dtype=np.int64)[:, None]
        return n + np.array([-ncpl, -ncol, -1, 1, ncol, ncpl], np.int64)

    @cached_property
    def row_mask(self) -> np.ndarray:
        """bool[N, 7]: the CSR entries of each row among [diagonal, U, N, W,
        E, S, D]; ``values[row_mask]`` lays a [N, 7] table out as CSR."""
        return np.concatenate([np.ones((self.nodes, 1), bool), self.conn],
                              axis=1)

    @cached_property
    def edge_mask(self) -> np.ndarray:
        """bool[N, 3]: the half-edges (n, m), n < m, among [E, S, D];
        ``values[edge_mask]`` lays a [N, 3] table out in edge order."""
        return np.ascontiguousarray(self.conn[:, _LOWER_SLOTS])

    @cached_property
    def edge_n(self) -> np.ndarray:
        """int32[E] lower-numbered cell of each connection, sorted by (n, m)."""
        n = np.arange(self.nodes, dtype=np.int32)[:, None]
        return np.broadcast_to(n, (self.nodes, 3))[self.edge_mask]

    @cached_property
    def edge_m(self) -> np.ndarray:
        """int32[E] higher-numbered cell of each connection."""
        return self._neighbour[:, _LOWER_SLOTS][self.edge_mask].astype(
            np.int32)

    @property
    def nedges(self) -> int:
        return int(self.edge_n.shape[0])

    @cached_property
    def csr(self):
        """Full CSR pattern (diagonal first per row, then ascending columns),
        the reference's ia/ja layout (Connections.f90).

        Returns (ia, ja, edge_pos_nm, edge_pos_mn) where the edge_pos arrays
        give, for each half-edge, the position of (n,m) and (m,n) in ja.
        """
        mask = self.row_mask
        ia = np.zeros(self.nodes + 1, np.int64)
        ia[1:] = np.cumsum(mask.sum(axis=1))
        cols = np.concatenate(
            [np.arange(self.nodes, dtype=np.int64)[:, None], self._neighbour],
            axis=1)
        ja = cols[mask]
        # position in ja of every [N, 7] table entry that is a CSR entry
        pos = (np.cumsum(mask.reshape(-1)) - 1).reshape(self.nodes, 7)
        n, m = self.edge_n.astype(np.int64), self.edge_m.astype(np.int64)
        slot = np.broadcast_to(np.array(_LOWER_SLOTS), (self.nodes, 3))[
            self.edge_mask]
        mirror = np.array([_MIRROR.get(s, 0) for s in range(6)])[slot]
        return ia, ja, pos[n, 1 + slot], pos[m, 1 + mirror]
