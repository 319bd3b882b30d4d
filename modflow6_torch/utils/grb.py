"""Binary grid (.grb) file writers for DIS, DISV and DISU grids.

A numpy copy of modflow6_tpu/utils/grb.py.  Each writer takes the grid's
connection layout as ``topo`` when the caller has built it already.

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


def write_grb_dis(path, grid, icelltype=None, topo=None):
    """Write a GRID DIS .grb for a DisGrid (1-based IA/JA CSR incl.
    diagonal, like the reference's iausr/jausr)."""
    ia, ja, _, _ = (topo or grid.build_topology()).csr
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


def _write_header(f, kind, defs):
    f.write(_hdr50(f"GRID {kind}"))
    f.write(_hdr50("VERSION 1"))
    f.write(_hdr50(f"NTXT {len(defs)}"))
    f.write(_hdr50("LENTXT 100"))
    for name, typ, ndim, val in defs:
        if ndim == 0:
            f.write(_txt100(f"{name} {typ} NDIM 0 # {val}"))
        elif ndim == 2:
            f.write(_txt100(f"{name} {typ} NDIM 2 2 {val}"))
        else:
            f.write(_txt100(f"{name} {typ} NDIM 1 {val}"))


def _i4(v) -> bytes:
    return np.asarray(v, "<i4").tobytes()


def _f8(v) -> bytes:
    return np.asarray(v, "<f8").tobytes()


def write_grb_disv(path, grid, icelltype=None, topo=None):
    """Write a GRID DISV .grb (Disv.f90 write_grb:716-840 field list:
    NCELLS NLAY NCPL NVERT NJAVERT NJA origins TOP BOTM VERTICES CELLX
    CELLY IAVERT JAVERT IA JA IDOMAIN ICELLTYPE)."""
    ia, ja, _, _ = (topo or grid.build_topology()).csr
    nodes = grid.nodes
    nlay, ncpl = grid.nlay, grid.ncpl
    nja = int(ia[-1])
    verts = np.asarray(grid.vertices, float)
    nvert = verts.shape[0]
    # the reference program closes each vertex loop: a ring that does not
    # end on its first vertex gets it appended
    first = grid.javert[grid.iavert[:-1]]
    last = grid.javert[grid.iavert[1:] - 1]
    nv = np.diff(grid.iavert) + (first != last)
    iavert = np.zeros(ncpl + 1, np.int64)
    iavert[1:] = np.cumsum(nv)
    javert = np.empty(int(iavert[-1]), np.int64)
    shift = np.repeat(iavert[:-1] - grid.iavert[:-1], np.diff(grid.iavert))
    javert[np.arange(grid.javert.size) + shift] = grid.javert
    javert[iavert[1:][first != last] - 1] = first[first != last]
    if icelltype is None:
        icelltype = np.zeros(nodes, np.int32)
    defs = [
        ("NCELLS", "INTEGER", 0, nodes),
        ("NLAY", "INTEGER", 0, nlay),
        ("NCPL", "INTEGER", 0, ncpl),
        ("NVERT", "INTEGER", 0, nvert),
        ("NJAVERT", "INTEGER", 0, javert.size),
        ("NJA", "INTEGER", 0, nja),
        ("XORIGIN", "DOUBLE", 0, 0.0),
        ("YORIGIN", "DOUBLE", 0, 0.0),
        ("ANGROT", "DOUBLE", 0, 0.0),
        ("TOP", "DOUBLE", 1, ncpl),
        ("BOTM", "DOUBLE", 1, nodes),
        ("VERTICES", "DOUBLE", 2, nvert),
        ("CELLX", "DOUBLE", 1, ncpl),
        ("CELLY", "DOUBLE", 1, ncpl),
        ("IAVERT", "INTEGER", 1, ncpl + 1),
        ("JAVERT", "INTEGER", 1, javert.size),
        ("IA", "INTEGER", 1, nodes + 1),
        ("JA", "INTEGER", 1, nja),
        ("IDOMAIN", "INTEGER", 1, nodes),
        ("ICELLTYPE", "INTEGER", 1, nodes),
    ]
    with open(path, "wb") as f:
        _write_header(f, "DISV", defs)
        f.write(_i4(nodes) + _i4(nlay) + _i4(ncpl) + _i4(nvert)
                + _i4(javert.size) + _i4(nja))
        f.write(_f8(0.0) + _f8(0.0) + _f8(0.0))
        f.write(_f8(grid.top_surf))
        f.write(_f8(grid.botm.reshape(-1)))
        f.write(_f8(verts.reshape(-1)))                   # (x,y) pairs
        f.write(_f8(grid.xc) + _f8(grid.yc))
        f.write(_i4(iavert + 1))
        f.write(_i4(javert + 1))
        f.write(_i4(np.asarray(ia) + 1))
        f.write(_i4(np.asarray(ja) + 1))
        f.write(_i4(np.asarray(grid.idomain).reshape(-1)))
        f.write(_i4(np.asarray(icelltype).reshape(-1)))


def write_grb_disu(path, grid, icelltype=None, topo=None):
    """Write a GRID DISU .grb (Disu.f90 write_grb minimal field list:
    NODES NJA origins TOP BOT IA JA ICELLTYPE; vertex geometry omitted
    like a DISU model without VERTICES blocks)."""
    ia, ja, _, _ = (topo or grid.build_topology()).csr
    nodes = grid.nodes
    nja = int(ia[-1])
    if icelltype is None:
        icelltype = np.zeros(nodes, np.int32)
    defs = [
        ("NODES", "INTEGER", 0, nodes),
        ("NJA", "INTEGER", 0, nja),
        ("XORIGIN", "DOUBLE", 0, 0.0),
        ("YORIGIN", "DOUBLE", 0, 0.0),
        ("ANGROT", "DOUBLE", 0, 0.0),
        ("TOP", "DOUBLE", 1, nodes),
        ("BOT", "DOUBLE", 1, nodes),
        ("IA", "INTEGER", 1, nodes + 1),
        ("JA", "INTEGER", 1, nja),
        ("ICELLTYPE", "INTEGER", 1, nodes),
    ]
    with open(path, "wb") as f:
        _write_header(f, "DISU", defs)
        f.write(_i4(nodes) + _i4(nja))
        f.write(_f8(0.0) + _f8(0.0) + _f8(0.0))
        f.write(_f8(np.asarray(grid.top).reshape(-1)))
        f.write(_f8(np.asarray(grid.bot).reshape(-1)))
        f.write(_i4(np.asarray(ia) + 1))
        f.write(_i4(np.asarray(ja) + 1))
        f.write(_i4(np.asarray(icelltype).reshape(-1)))
