"""DIS: structured (nlay, nrow, ncol) discretization, host numpy.

A numpy copy of the geometry half of ``modflow6_tpu`` DisGrid
(modflow6_tpu/models/discretization/dis.py:24-87).  The structured solve
needs only the grid shape; ``build_topology`` gives the connection layout
that the output files use (see ``topology.DisTopology``).  A grid whose
idomain < 0 passthrough cells connect non-adjacent layers is not
structured and raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .topology import DisTopology


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

    def build_topology(self) -> DisTopology:
        """The 7-point connection layout in the reference's edge and CSR
        order; raises for a grid that is not structured."""
        shape = self.grid_shape     # raises unless structured
        conn = DisTopology.connections(self.idomain)
        return DisTopology(shape, conn)

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
        """(nlay, nrow, ncol) for the 7-point stencil path.

        The reference's DIS topology connects an active cell through
        idomain < 0 passthrough layers to the next active cell below
        (modflow6_tpu/models/discretization/dis.py:138-157); such a
        connection skips a layer and has no structured stencil slot.
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
                    raise NotImplementedError(
                        "idomain < 0 passthrough cells connect non-adjacent "
                        "layers; only the structured 7-point stencil is "
                        "ported")
                remaining = remaining & (idom[kk] < 0)
        return self.shape
