"""Binary grid (.grb) file writer for DIS grids.

A numpy copy of ``write_grb_dis`` from modflow6_tpu/utils/grb.py; the DISV
and DISU writers wait for the unstructured slice.

Format parity target: the reference's stream-unformatted writer
(src/Model/Discretization/Dis.f90 write_grb:547-659 for GRID DIS;
DiscretizationBase.f90:926-943 drives it): four 50-char header lines,
NTXT 100-char variable-definition lines, then the raw arrays.  Readable
by FloPy's MfGrdFile.
"""

from __future__ import annotations

import numpy as np


def _hdr50(s: str) -> bytes:
    b = s.ljust(49)[:49] + "\n"
    return b.encode()


def _txt100(s: str) -> bytes:
    b = s.ljust(99)[:99] + "\n"
    return b.encode()


def write_grb_dis(path, grid, icelltype=None):
    """Write a GRID DIS .grb for a DisGrid (1-based IA/JA CSR incl.
    diagonal, like the reference's iausr/jausr)."""
    topo = grid.build_topology()
    ia, ja, _, _ = topo.csr
    nodes = grid.nodes
    nlay, nrow, ncol = grid.shape
    nja = int(ia[-1])
    if icelltype is None:
        icelltype = np.zeros(nodes, np.int32)
    defs = [
        ("NCELLS", "INTEGER", 0, nodes),
        ("NLAY", "INTEGER", 0, nlay),
        ("NROW", "INTEGER", 0, nrow),
        ("NCOL", "INTEGER", 0, ncol),
        ("NJA", "INTEGER", 0, nja),
        ("XORIGIN", "DOUBLE", 0, float(getattr(grid, "xorigin", 0.0))),
        ("YORIGIN", "DOUBLE", 0, float(getattr(grid, "yorigin", 0.0))),
        ("ANGROT", "DOUBLE", 0, float(getattr(grid, "angrot", 0.0))),
        ("DELR", "DOUBLE", 1, ncol),
        ("DELC", "DOUBLE", 1, nrow),
        ("TOP", "DOUBLE", 1, nrow * ncol),
        ("BOTM", "DOUBLE", 1, nodes),
        ("IA", "INTEGER", 1, nodes + 1),
        ("JA", "INTEGER", 1, nja),
        ("IDOMAIN", "INTEGER", 1, nodes),
        ("ICELLTYPE", "INTEGER", 1, nodes),
    ]
    with open(path, "wb") as f:
        f.write(_hdr50("GRID DIS"))
        f.write(_hdr50("VERSION 1"))
        f.write(_hdr50(f"NTXT {len(defs)}"))
        f.write(_hdr50("LENTXT 100"))
        for name, typ, ndim, val in defs:
            if ndim == 0:
                f.write(_txt100(f"{name} {typ} NDIM 0 # {val}"))
            else:
                f.write(_txt100(f"{name} {typ} NDIM 1 {val}"))
        i4 = lambda v: np.asarray(v, "<i4").tobytes()      # noqa: E731
        f8 = lambda v: np.asarray(v, "<f8").tobytes()      # noqa: E731
        f.write(i4(nodes) + i4(nlay) + i4(nrow) + i4(ncol) + i4(nja))
        f.write(f8(getattr(grid, "xorigin", 0.0)))
        f.write(f8(getattr(grid, "yorigin", 0.0)))
        f.write(f8(getattr(grid, "angrot", 0.0)))
        f.write(f8(grid.delr) + f8(grid.delc))
        top2d = np.asarray(grid.top).reshape(nlay, nrow * ncol)[0]
        f.write(f8(top2d))
        f.write(f8(np.asarray(grid.bot).reshape(-1)))
        f.write(i4(np.asarray(ia) + 1))
        f.write(i4(np.asarray(ja) + 1))
        f.write(i4(np.asarray(grid.idomain).reshape(-1)))
        f.write(i4(np.asarray(icelltype).reshape(-1)))
