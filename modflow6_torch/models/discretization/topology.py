"""Grid connection topology, host numpy.

``Topology`` is the general class, a numpy copy of
modflow6_tpu/models/discretization/topology.py:28-172: per-connection
geometry arrays over the symmetric half of the adjacency (each connection
once, n < m), the ELL packing (``nbr`` [N, K] neighbour table with the
edge→slot maps ``slot_nm``/``slot_mn``) that the general assembly and the
gather product use, and the full CSR pattern of the output files.  Every
array equals the reference's; the greedy slot assignment, a loop over the
edges there, is a per-node running count here.

``DisTopology`` is the connection layout of a structured DIS grid alone:
the edge order and the CSR pattern the output files use.  The structured
solve needs none of it: the 7-point stencil works on dense planes.  The
budget file and the binary grid file do: FLOW-JA-FACE is one value per CSR
entry (diagonal first in each row, then ascending columns), and the
reference's per-edge arrays are over the symmetric half, sorted by (n, m)
with n < m.

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

from ...ops.scatter import running_count

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


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static connection topology over ``nodes`` cells.

    Edge arrays are over the symmetric half (each connection appears once,
    with ``n < m``); DIS and DISV grids sort them by (n, m), a DISU grid
    keeps the order of its connection rows.
    """

    nodes: int
    edge_n: np.ndarray  # int32[E] lower-numbered cell of each connection
    edge_m: np.ndarray  # int32[E] higher-numbered cell
    ihc: np.ndarray     # int32[E] 0=vertical 1=horizontal 2=staggered
    cl1: np.ndarray     # f64[E] distance from n's center to shared face
    cl2: np.ndarray     # f64[E] distance from m's center to shared face
    hwva: np.ndarray    # f64[E] face width (horizontal) or flow area (vertical)
    direction: np.ndarray  # int32[E] 0=x 1=y 2=z (axis hint; -1 if unstructured)
    anglex: np.ndarray  # f64[E] angle of n→m normal in x-y plane (radians)
    # DIS grids: fixed slot semantics [0=E, 1=W, 2=N, 3=S, 4=U, 5=D], so the
    # assembled ELL matrix reshapes to the stencil's coefficient planes.
    # None → greedy slot assignment (general grids).
    grid_shape: tuple = None  # (nlay, nrow, ncol) when structured
    pad_degree: int = 0       # minimum ELL width

    @property
    def nedges(self) -> int:
        return int(self.edge_n.shape[0])

    @property
    def structured(self) -> bool:
        return self.grid_shape is not None

    @cached_property
    def _ell(self):
        """The ELL neighbour table and the edge→slot maps."""
        n_arr, m_arr = self.edge_n, self.edge_m
        N = self.nodes
        n64, m64 = n_arr.astype(np.int64), m_arr.astype(np.int64)
        if self.structured:
            # n is always the lower-numbered cell: west / north / above of m
            K = 6
            slot_of_n = np.where(self.direction == 0, 0,
                                 np.where(self.direction == 1, 3, 5))
            slot_of_m = np.where(self.direction == 0, 1,
                                 np.where(self.direction == 1, 2, 4))
        else:
            degree = np.bincount(n64, minlength=N) + np.bincount(m64,
                                                                 minlength=N)
            K = max(int(degree.max(initial=0)), 1, int(self.pad_degree))
            # slots in edge order: the slot of an edge in a cell's row is
            # the count of that cell's appearances in earlier edges
            rank = running_count(
                np.stack([n64, m64], axis=1).reshape(-1))
            slot_of_n, slot_of_m = rank[0::2], rank[1::2]
        slot_nm = (n64 * K + slot_of_n).astype(np.int32)
        slot_mn = (m64 * K + slot_of_m).astype(np.int32)
        nbr = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, K))
        nbr.reshape(-1)[slot_nm] = m_arr
        nbr.reshape(-1)[slot_mn] = n_arr
        return K, nbr, slot_nm, slot_mn

    @property
    def max_degree(self) -> int:
        return self._ell[0]

    @property
    def nbr(self) -> np.ndarray:
        """int32[N, K] neighbour table; padded slots point at the row itself."""
        return self._ell[1]

    @property
    def slot_nm(self) -> np.ndarray:
        """int32[E] flat index (into N*K) of the (n-row, m-col) entry."""
        return self._ell[2]

    @property
    def slot_mn(self) -> np.ndarray:
        """int32[E] flat index (into N*K) of the (m-row, n-col) entry."""
        return self._ell[3]

    @cached_property
    def csr(self):
        """Full CSR pattern (diagonal first per row, then ascending columns),
        the reference's ia/ja layout (Connections.f90).

        Returns (ia, ja, edge_pos_nm, edge_pos_mn) where the edge_pos arrays
        give, for each half-edge, the position of (n,m) and (m,n) in ja.
        """
        N, E = self.nodes, self.nedges
        n_arr, m_arr = self.edge_n, self.edge_m
        degree = (np.bincount(n_arr, minlength=N)
                  + np.bincount(m_arr, minlength=N)).astype(np.int64)
        ia = np.zeros(N + 1, dtype=np.int64)
        ia[1:] = np.cumsum(degree + 1)  # +1 for the diagonal entry
        ja = np.empty(int(ia[-1]), dtype=np.int64)
        ja[ia[:-1]] = np.arange(N)
        rows = np.concatenate([n_arr, m_arr])
        cols = np.concatenate([m_arr, n_arr])
        edge_ids = np.concatenate([np.arange(E), np.arange(E)])
        is_nm = np.concatenate([np.ones(E, bool), np.zeros(E, bool)])
        order = np.lexsort((cols, rows))
        rows, cols, edge_ids, is_nm = (rows[order], cols[order],
                                       edge_ids[order], is_nm[order])
        # rows are sorted, so searchsorted gives each row group's start
        pos = ia[rows] + 1 + (np.arange(rows.size)
                              - np.searchsorted(rows, rows, side="left"))
        ja[pos] = cols
        edge_pos_nm = np.empty(E, dtype=np.int64)
        edge_pos_mn = np.empty(E, dtype=np.int64)
        edge_pos_nm[edge_ids[is_nm]] = pos[is_nm]
        edge_pos_mn[edge_ids[~is_nm]] = pos[~is_nm]
        return ia, ja, edge_pos_nm, edge_pos_mn

    def degree_histogram(self) -> np.ndarray:
        deg = (np.bincount(self.edge_n, minlength=self.nodes)
               + np.bincount(self.edge_m, minlength=self.nodes))
        return np.bincount(deg)
