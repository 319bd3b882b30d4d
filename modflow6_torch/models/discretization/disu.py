"""DISU: fully unstructured discretization, host numpy.

A numpy counterpart of modflow6_tpu/models/discretization/disu.py
(reference src/Model/Discretization/Disu.f90): the user supplies the
connectivity (iac/ja) and per-connection geometry (ihc/cl12/hwva/angldegx)
directly.  The reference walks the rows in a Python loop; here the
symmetric half and each connection's reciprocal entry are found with array
code, and give the same edge arrays in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .topology import Topology


@dataclasses.dataclass(frozen=True)
class DisuGrid:
    nodes: int
    top: np.ndarray   # f64[nodes]
    bot: np.ndarray   # f64[nodes]
    area: np.ndarray  # f64[nodes]
    idomain: np.ndarray  # int32[nodes]
    _topology: Topology

    @staticmethod
    def create(top, bot, area, iac, ja, ihc, cl12, hwva, angldegx=None,
               idomain=None):
        """Build from MF6 DISU CONNECTIONDATA arrays.

        ``ja`` is 0-based here, with each row listing the cell itself first
        (the MF6 file is 1-based; the loader normalizes before calling
        this).  ``cl12``/``hwva``/``ihc``/``angldegx`` are parallel to
        ``ja``.  The edges keep the order of the rows: by cell n, then by
        the position of m > n in n's row.
        """
        top = np.asarray(top, np.float64)
        nodes = top.shape[0]
        bot = np.asarray(bot, np.float64)
        area = np.asarray(area, np.float64)
        iac = np.asarray(iac, np.int64)
        ja = np.asarray(ja, np.int64)
        ihc = np.asarray(ihc, np.int64)
        cl12 = np.asarray(cl12, np.float64)
        hwva = np.asarray(hwva, np.float64)
        angldegx = (np.zeros_like(cl12) if angldegx is None
                    else np.asarray(angldegx, np.float64))
        if idomain is None:
            idomain = np.ones(nodes, np.int32)
        ia = np.zeros(nodes + 1, np.int64)
        ia[1:] = np.cumsum(iac)

        row = np.repeat(np.arange(nodes, dtype=np.int64), iac)
        offdiag = np.ones(ja.size, bool)
        offdiag[ia[:-1][iac > 0]] = False
        pos = np.nonzero(offdiag & (ja > row))[0]   # the symmetric half
        n, m = row[pos], ja[pos]
        # the reciprocal entry (row m, column n): the first one in row m
        cand = np.nonzero(offdiag)[0]
        cand_key = row[cand] * nodes + ja[cand]
        order = np.argsort(cand_key, kind="stable")
        sorted_key = cand_key[order]
        want = m * nodes + n
        at = np.searchsorted(sorted_key, want, side="left")
        found = at < sorted_key.size
        found[found] = sorted_key[at[found]] == want[found]
        if not found.all():
            e = int(np.nonzero(~found)[0][0])
            raise ValueError(f"DISU connection {int(n[e])}->{int(m[e])} has "
                             f"no entry in row {int(m[e])}")
        rpos = cand[order[at]]
        topo = Topology(
            nodes=nodes,
            edge_n=n.astype(np.int32),
            edge_m=m.astype(np.int32),
            ihc=ihc[pos].astype(np.int32),
            cl1=cl12[pos],
            cl2=cl12[rpos],
            hwva=hwva[pos],
            direction=np.full(pos.size, -1, np.int32),
            anglex=np.deg2rad(angldegx[pos]),
        )
        return DisuGrid(nodes, top, bot, area, np.asarray(idomain, np.int32),
                        topo)

    @property
    def shape(self):
        return (self.nodes,)

    def build_topology(self) -> Topology:
        return self._topology
