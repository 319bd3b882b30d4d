"""DISV: layered vertex (polygon) discretization, host numpy.

A numpy counterpart of modflow6_tpu/models/discretization/disv.py
(reference src/Model/Discretization/Disv.f90): ncpl polygon cells per layer
× nlay layers.  Horizontal connections are discovered from shared polygon
edges; connection lengths are the distances from each cell center to the
midpoint of the shared edge, and hwva is the shared edge length.

The reference walks the cells and their edges in Python loops; a grid of a
million cells a layer needs array code.  The cell rings are kept as one
flat vertex list with offsets (``iavert``/``javert``), shared edges are
found by sorting the (lower vertex, higher vertex) keys of all ring
segments, and the areas are computed once and cached.  Every array equals
the reference's, element for element.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from ...ops.scatter import running_count
from .topology import Topology


@dataclasses.dataclass(frozen=True)
class DisvGrid:
    nlay: int
    ncpl: int
    vertices: np.ndarray   # f64[nvert, 2]
    iavert: np.ndarray     # int64[ncpl + 1] offsets into javert
    javert: np.ndarray     # int64[...] vertex ids of every cell's open ring
    xc: np.ndarray         # f64[ncpl] cell center x
    yc: np.ndarray         # f64[ncpl] cell center y
    top_surf: np.ndarray   # f64[ncpl]
    botm: np.ndarray       # f64[nlay, ncpl]
    idomain: np.ndarray    # int32[nlay, ncpl]

    @staticmethod
    def create(nlay, ncpl, vertices, cell2d, top, botm, idomain=None):
        """``cell2d`` rows: (xc, yc, [vertex ids 0-based])."""
        xc = np.array([c[0] for c in cell2d], np.float64)
        yc = np.array([c[1] for c in cell2d], np.float64)
        rings = [np.asarray(c[2], np.int64) for c in cell2d]
        iavert = np.zeros(ncpl + 1, np.int64)
        iavert[1:] = np.cumsum([r.size for r in rings])
        javert = (np.concatenate(rings) if rings else np.zeros(0, np.int64))
        return DisvGrid.from_arrays(nlay, vertices, xc, yc, iavert, javert,
                                    top, botm, idomain)

    @staticmethod
    def from_arrays(nlay, vertices, xc, yc, iavert, javert, top, botm,
                    idomain=None):
        """The same grid from the cell rings as one flat list: cell c has
        the vertices ``javert[iavert[c]:iavert[c + 1]]`` (an open ring)."""
        xc = np.asarray(xc, np.float64)
        ncpl = xc.shape[0]
        top = np.broadcast_to(np.asarray(top, np.float64), (ncpl,)).copy()
        botm = np.broadcast_to(np.asarray(botm, np.float64),
                               (nlay, ncpl)).copy()
        if idomain is None:
            idomain = np.ones((nlay, ncpl), np.int32)
        else:
            idomain = np.broadcast_to(np.asarray(idomain, np.int32),
                                      (nlay, ncpl)).copy()
        return DisvGrid(nlay, ncpl, np.asarray(vertices, np.float64),
                        np.asarray(iavert, np.int64),
                        np.asarray(javert, np.int64), xc,
                        np.asarray(yc, np.float64), top, botm, idomain)

    @property
    def cell_verts(self) -> list:
        """One int array of vertex ids per cell, as the reference keeps
        them."""
        return np.split(self.javert, self.iavert[1:-1])

    @property
    def shape(self):
        return (self.nlay, self.ncpl)

    @property
    def nodes(self):
        return self.nlay * self.ncpl

    @property
    def top(self) -> np.ndarray:
        tops = np.concatenate([self.top_surf[None], self.botm[:-1]], axis=0)
        return tops.reshape(-1)

    @property
    def bot(self) -> np.ndarray:
        return self.botm.reshape(-1)

    @cached_property
    def _ring(self):
        """(cell, next) per ring position: the cell it belongs to and the
        position of the ring's next vertex."""
        nv = np.diff(self.iavert)
        cell = np.repeat(np.arange(self.ncpl, dtype=np.int64), nv)
        pos = np.arange(self.javert.size, dtype=np.int64)
        nxt = pos + 1
        last = self.iavert[1:][nv > 0] - 1
        nxt[last] = self.iavert[:-1][nv > 0]
        return cell, nxt

    @cached_property
    def _cell_area(self) -> np.ndarray:
        """f64[ncpl] shoelace areas.  The reference takes two dot products
        per cell; cells with the same vertex count go through one batched
        product, which calls the same dot routine once per cell."""
        areas = np.empty(self.ncpl, np.float64)
        nv = np.diff(self.iavert)
        _, nxt = self._ring
        vx, vy = self.vertices[:, 0], self.vertices[:, 1]
        for count in np.unique(nv):
            cells = np.nonzero(nv == count)[0]
            pos = self.iavert[cells][:, None] + np.arange(count)[None, :]
            x = np.ascontiguousarray(vx[self.javert[pos]])
            y = np.ascontiguousarray(vy[self.javert[pos]])
            xn = np.ascontiguousarray(vx[self.javert[nxt[pos]]])
            yn = np.ascontiguousarray(vy[self.javert[nxt[pos]]])
            xy = np.matmul(x[:, None, :], yn[:, :, None])[:, 0, 0]
            yx = np.matmul(y[:, None, :], xn[:, :, None])[:, 0, 0]
            areas[cells] = 0.5 * np.abs(xy - yx)
        return areas

    @property
    def area(self) -> np.ndarray:
        return np.tile(self._cell_area, self.nlay)

    def _shared_edges(self):
        """(lo, hi, cl_lo, cl_hi, length, angle) of the horizontal
        connections of one layer, in the order the reference finds them:
        a ring segment whose vertex pair was seen once before closes a
        connection between the two cells."""
        cell, nxt = self._ring
        a, b = self.javert, self.javert[nxt]
        vmin, vmax = np.minimum(a, b), np.maximum(a, b)
        key = vmin * np.int64(self.vertices.shape[0]) + vmax
        # the k-th segment with a given key closes a connection with the
        # (k-1)-th when k is odd (the second, the fourth, ...)
        rank = running_count(key)
        order = np.argsort(key, kind="stable")
        prev = np.empty_like(order)
        prev[order[1:]] = order[:-1]
        second = np.nonzero(rank % 2 == 1)[0]      # ascending ring position
        first = prev[second]
        c0, c = cell[first], cell[second]
        pa, pb = self.vertices[vmin[second]], self.vertices[vmax[second]]
        mid = 0.5 * (pa + pb)
        length = np.hypot(pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1])
        cl_0 = np.hypot(self.xc[c0] - mid[:, 0], self.yc[c0] - mid[:, 1])
        cl_c = np.hypot(self.xc[c] - mid[:, 0], self.yc[c] - mid[:, 1])
        swap = ~(c0 < c)
        lo, hi = np.where(swap, c, c0), np.where(swap, c0, c)
        cl_lo, cl_hi = np.where(swap, cl_c, cl_0), np.where(swap, cl_0, cl_c)
        ang = np.arctan2(self.yc[hi] - self.yc[lo], self.xc[hi] - self.xc[lo])
        return lo, hi, cl_lo, cl_hi, length, ang

    def build_topology(self) -> Topology:
        nlay, ncpl = self.nlay, self.ncpl
        act = self.idomain != 0
        lo, hi, cl_lo, cl_hi, length, ang = self._shared_edges()

        # horizontal connections in every layer, layer by layer
        keep = act[:, lo] & act[:, hi]                  # [nlay, H]
        kk, hh = np.nonzero(keep)
        off = kk.astype(np.int64) * ncpl
        e_n, e_m = [off + lo[hh]], [off + hi[hh]]
        ihc = [np.ones(hh.size, np.int32)]
        cl1, cl2, hwva = [cl_lo[hh]], [cl_hi[hh]], [length[hh]]
        direction = [np.full(hh.size, -1, np.int32)]
        anglex = [ang[hh]]

        # vertical connections: an active cell connects to the first cell
        # below it that is not a passthrough cell, if that one is active
        areas = self._cell_area
        top_full = self.top.reshape(nlay, ncpl)
        below = np.full((nlay, ncpl), nlay, np.int64)
        for k in range(nlay - 2, -1, -1):
            below[k] = np.where(self.idomain[k + 1] < 0, below[k + 1], k + 1)
        cols = np.arange(ncpl)
        for k in range(nlay - 1):
            tgt = below[k]
            ok = (self.idomain[k] > 0) & (tgt < nlay)
            ok[ok] = self.idomain[tgt[ok], cols[ok]] > 0
            c = cols[ok]
            t = tgt[ok]
            e_n.append(k * ncpl + c)
            e_m.append(t * ncpl + c)
            ihc.append(np.zeros(c.size, np.int32))
            cl1.append(0.5 * (top_full[k, c] - self.botm[k, c]))
            cl2.append(0.5 * (top_full[t, c] - self.botm[t, c]))
            hwva.append(areas[c])
            direction.append(np.full(c.size, 2, np.int32))
            anglex.append(np.zeros(c.size))

        edge_n = np.concatenate(e_n).astype(np.int64)
        edge_m = np.concatenate(e_m).astype(np.int64)
        order = np.lexsort((edge_m, edge_n))
        return Topology(
            nodes=self.nodes,
            edge_n=edge_n[order].astype(np.int32),
            edge_m=edge_m[order].astype(np.int32),
            ihc=np.concatenate(ihc)[order],
            cl1=np.concatenate(cl1).astype(np.float64)[order],
            cl2=np.concatenate(cl2).astype(np.float64)[order],
            hwva=np.concatenate(hwva).astype(np.float64)[order],
            direction=np.concatenate(direction)[order],
            anglex=np.concatenate(anglex).astype(np.float64)[order])
