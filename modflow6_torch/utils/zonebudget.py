"""Zone budget post-processor.

A numpy copy of modflow6_tpu/utils/zonebudget.py (reference zbud6
companion program, utils/zonebudget/src/zbud6.f90): aggregate
cell-by-cell flows by user-assigned integer zones — inter-zone exchange
flows from the FLOW-JA-FACE array plus per-zone boundary-package and
storage totals — and print a zone-budget table with in/out/percent-
discrepancy columns, from a step's flows in memory or from a ``.cbc``
file, over the port's ``Topology`` and ``utils/binary.py``.

``interzone`` sums the crossing edges with one ``np.add.at`` in edge
order where the reference loops over them in Python: the same sums, bit
for bit, in a fraction of the time at millions of edges.
"""

from __future__ import annotations

import numpy as np


class ZoneBudget:
    """Aggregate one time step's flows by zone.

    zones: int array [nodes]; zone 0 is excluded (like zbud6).
    """

    def __init__(self, topo, zones):
        self.topo = topo
        self.zones = np.asarray(zones, np.int64).reshape(-1)
        self.nzones = int(self.zones.max(initial=0))

    def interzone(self, q_edge):
        """Zone-to-zone flow matrix F[z1, z2] = total flow z1 → z2
        (1-based zones; index 0 row/col unused)."""
        q = np.asarray(q_edge)
        zn = self.zones[self.topo.edge_n]
        zm = self.zones[self.topo.edge_m]
        nz = self.nzones + 1
        F = np.zeros((nz, nz))
        # q_edge is positive into n (flowja convention): flow m→n = q; a
        # negative q is flow n→m of -q
        sel = zn != zm
        zn, zm, q = zn[sel], zm[sel], q[sel]
        fwd = q >= 0
        np.add.at(F, (np.where(fwd, zm, zn), np.where(fwd, zn, zm)),
                  np.where(fwd, q, -q))
        return F

    def package_totals(self, flows_by_package):
        """Per-zone in/out totals of each boundary package.

        flows_by_package: {name: (nodes, q)} with q positive into the model.
        Returns {name: (zin[nz+1], zout[nz+1])}.
        """
        out = {}
        for name, (nodes, q) in flows_by_package.items():
            nodes = np.asarray(nodes)
            q = np.asarray(q)
            zin = np.zeros(self.nzones + 1)
            zout = np.zeros(self.nzones + 1)
            z = self.zones[nodes]
            np.add.at(zin, z, np.where(q > 0, q, 0.0))
            np.add.at(zout, z, np.where(q < 0, -q, 0.0))
            out[name] = (zin, zout)
        return out

    def table(self, q_edge, flows_by_package=None) -> str:
        """Formatted zone-budget table (zbud6 listing role)."""
        F = self.interzone(q_edge)
        pk = self.package_totals(flows_by_package or {})
        lines = []
        for z in range(1, self.nzones + 1):
            lines.append(f"ZONE {z}")
            tin = tout = 0.0
            for name, (zin, zout) in pk.items():
                lines.append(f"  {name:<16s} IN {zin[z]:15.6e}   "
                             f"OUT {zout[z]:15.6e}")
                tin += zin[z]
                tout += zout[z]
            for z2 in range(1, self.nzones + 1):
                if z2 == z:
                    continue
                fin, fout = F[z2, z], F[z, z2]
                if fin or fout:
                    lines.append(f"  FROM ZONE {z2:<6d} IN {fin:15.6e}   "
                                 f"OUT {fout:15.6e}")
                    tin += fin
                    tout += fout
            denom = 0.5 * (tin + tout)
            pdiff = 100.0 * (tin - tout) / denom if denom > 0 else 0.0
            lines.append(f"  TOTAL            IN {tin:15.6e}   "
                         f"OUT {tout:15.6e}   PERCENT DISCREPANCY "
                         f"{pdiff:10.4f}")
            lines.append("")
        return "\n".join(lines)


def read_cbc_step(topo, cbc_path, kstp, kper):
    """Extract one step's (q_edge, flows_by_package) from a .cbc file (the
    ubdsv1/ubdsv06 records the reference's BudgetFileReader.f90 reads).

    q_edge is taken from the FLOW-JA-FACE full-CSR record at the
    topology's (n, m) positions; imeth=6 records become {pakname: (nodes,
    q)}, storage (STO-*) records among them.
    """
    from .binary import read_budget_file

    q_edge = None
    flows = {}
    pos_nm = topo.csr[2]
    for rec in read_budget_file(cbc_path):
        if rec["kstp"] != kstp or rec["kper"] != kper:
            continue
        if rec["text"] == "FLOW-JA-FACE" and rec["imeth"] == 1:
            q_edge = rec["data"][pos_nm]
        elif rec["imeth"] == 6:
            id1, _, q, _ = rec["data"]
            flows[rec["text"]] = (id1, q)
    if q_edge is None:
        raise ValueError(f"no FLOW-JA-FACE record for kstp={kstp} "
                         f"kper={kper} in {cbc_path}")
    return q_edge, flows


def zonebudget_from_cbc(topo, zones, cbc_path, kstp, kper) -> str:
    """zbud6 role: zone-budget table straight from a run's .cbc file."""
    zb = ZoneBudget(topo, zones)
    q_edge, flows = read_cbc_step(topo, cbc_path, kstp, kper)
    return zb.table(q_edge, flows)
