"""DISV2D: a 2-D vertex grid for overland flow (Disv2d.f90,
olf-disv2d.dfn), host numpy.

A copy of modflow6_tpu/models/discretization/disv2d.py over the port's
``DisvGrid``: a one-layer polygonal mesh whose bottom is the land surface;
its horizontal topology is a one-layer DISV grid's, so the grid wraps one
and gives the SWF model its surface (nodes, area, bot, build_topology)."""

from __future__ import annotations

import dataclasses

import numpy as np

from .disv import DisvGrid


@dataclasses.dataclass(frozen=True)
class Disv2dGrid:
    """Polygonal 2-D surface grid (the Disv2d.f90 role)."""

    base: DisvGrid         # one-layer DISV carrying the topology

    @staticmethod
    def create(nvert_xy, cell2d, bottom, idomain=None):
        """``nvert_xy``: f64[nvert, 2] vertices; ``cell2d`` rows
        (xc, yc, [vertex ids 0-based]); ``bottom``: land surface."""
        ncpl = len(cell2d)
        bottom = np.broadcast_to(np.asarray(bottom, np.float64),
                                 (ncpl,)).copy()
        return Disv2dGrid(DisvGrid.create(1, ncpl, nvert_xy, cell2d,
                                          top=bottom + 1e30,
                                          botm=bottom[None, :],
                                          idomain=idomain))

    @staticmethod
    def from_arrays(vertices, xc, yc, iavert, javert, bottom, idomain=None):
        """The same grid from the cell rings as one flat vertex list
        (``DisvGrid.from_arrays``)."""
        bottom = np.broadcast_to(np.asarray(bottom, np.float64),
                                 (np.asarray(xc).shape[0],)).copy()
        return Disv2dGrid(DisvGrid.from_arrays(
            1, vertices, xc, yc, iavert, javert, top=bottom + 1e30,
            botm=bottom[None, :], idomain=idomain))

    @property
    def nodes(self):
        return self.base.ncpl

    @property
    def ncpl(self):
        return self.base.ncpl

    @property
    def shape(self):
        return (self.base.ncpl,)

    @property
    def idomain(self):
        return np.asarray(self.base.idomain).reshape(-1)

    @property
    def area(self):
        return np.asarray(self.base.area).reshape(-1)

    @property
    def bot(self):
        return np.asarray(self.base.bot).reshape(-1)

    @property
    def top(self):
        return self.bot + 1e30     # unbounded stage

    def build_topology(self):
        return self.base.build_topology()
