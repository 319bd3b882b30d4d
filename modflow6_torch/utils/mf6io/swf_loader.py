"""Deck loading for the SWF model family: CHF6 (channel) and OLF6
(overland) model files and their packages.

Port of modflow6_tpu/utils/mf6io/swf_loader.py (the chf-*/olf-* dfn specs:
DISV1D6 with VERTICES and CELL1D polylines, DIS2D6, DISV2D6, DFW6 with
MANNINGSN/IDCXS and CENTRAL_IN_SPACE, CXS6, STO6, IC6, FLW6, CHD6, ZDG6,
PCP6, EVP6, CDB6, OC6).  The DISV1D reach lengths and the reach pairs that
share an end vertex, loops over the reaches and the vertices in the
reference, are array code whose arrays equal the loops'.

Refused by name where the reference reads past input that changes the
results (ROADMAP Queue C): DFW6 ``DEV_SWR_CONDUCTANCE`` (R20), a package's
OBS6 file (R21), ``TS6`` and ``AUXMULTNAME`` in the stress packages (R22),
a DISV1D6 ``IDOMAIN`` that removes a reach (R23).  A later PERIOD block of
a stress package, and ZDG6 or CDB6 with a CXS section, raise as in the
reference.  CXS6 loads here, where the reference's loader fails (R32).
"""

from __future__ import annotations

import os

import numpy as np

from ...models.discretization import DisGrid
from ...models.discretization.disv2d import Disv2dGrid
from ...models.swf.model import Disv1dGrid, build_chf, build_olf
from . import schema
from .advanced_loader import _only_first_period, _period_blocks
from .arrays import read_grid_array
from .reader import BlockFile, uniform_table


def _refuse(opts, keys, path, why):
    for key in keys:
        if key in opts:
            raise NotImplementedError(f"{path}: option {key} is not ported "
                                      f"({why})")


def _options(bf, component, path):
    opts = bf.options()
    schema.check_options(component, opts, path)
    _refuse(opts, ("OBS6",), path, "R21: the reference reads the package's "
            "OBS6 file past")
    return opts


def disv1d_reaches(verts, cells, n):
    """Reach lengths and connected reach pairs of a DISV1D grid.

    ``verts``: {vertex id: (x, y)}; ``cells``: (ic 0-based, [vertex ids])
    per CELL1D record; ``n`` reaches.  A reach's length is its polyline's,
    summed segment by segment as the reference does; reaches that share an
    end vertex (first or last of their polylines) are connected.  Returns (length per
    reach, int64[E, 2] pairs (a < b) sorted), the reference's loops
    (swf_loader.py:40-72) as array code."""
    ids = np.array(sorted(verts), np.int64)
    xy = np.array([verts[i] for i in ids], np.float64).reshape(-1, 2)
    ic = np.array([c for c, _ in cells], np.int64)
    nv = np.array([len(ch) for _, ch in cells], np.int64)
    flat = np.array([v for _, ch in cells for v in ch], np.int64)
    pos = np.searchsorted(ids, flat)
    if flat.size and ((pos >= ids.size) | (ids[np.minimum(
            pos, ids.size - 1)] != flat)).any():
        raise KeyError("a CELL1D vertex is not in VERTICES")
    pts = xy[pos]
    start = np.cumsum(nv) - nv
    seg = np.ones(flat.size, bool)
    seg[(start + nv - 1)[nv > 0]] = False
    d = pts[1:] - pts[:-1]
    seg_len = (d[:, 0] ** 2 + d[:, 1] ** 2) ** 0.5
    # the segments of each reach, summed in order from 0 (Python's sum)
    length = np.zeros(n)
    lens = np.zeros(len(cells))
    k = np.arange(flat.size - 1)
    owner = np.repeat(np.arange(len(cells)), nv)[:-1] if flat.size else k
    keep = seg[:-1]
    k, owner = k[keep], owner[keep]
    rank = k - start[owner]
    for r in range(int(rank.max()) + 1 if rank.size else 0):
        sel = rank == r
        lens[owner[sel]] += seg_len[k[sel]]
    length[ic] = lens
    # reaches sharing an end vertex, in the order the reference collects
    # them: (v0, v1) of each CELL1D record in turn
    ends = np.stack([flat[start], flat[start + nv - 1]], 1).reshape(-1)
    cell = np.repeat(ic, 2)
    order = np.argsort(ends, kind="stable")
    ends, cell = ends[order], cell[order]
    pairs = []
    for off in range(1, int(np.bincount(np.unique(
            ends, return_inverse=True)[1]).max(initial=1))):
        same = ends[off:] == ends[:-off]
        a, b = cell[:-off][same], cell[off:][same]
        pairs.append(np.stack([np.minimum(a, b), np.maximum(a, b)], 1))
    pairs = (np.concatenate(pairs) if pairs
             else np.zeros((0, 2), np.int64))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    pairs = (np.unique(pairs, axis=0) if pairs.size
             else np.zeros((0, 2), np.int64))
    return length, pairs


def _load_disv1d(path, base_dir):
    """DISV1D6 → Disv1dGrid, with reach lengths from the CELL1D polylines
    and the connections from shared end vertices."""
    bf = BlockFile(path)
    schema.check_options("swf-disv1d", bf.options(), path)
    n = int(bf.dimensions()["NODES"])
    width = read_grid_array(bf, "GRIDDATA", "WIDTH", (n,), base_dir)
    bottom = read_grid_array(bf, "GRIDDATA", "BOTTOM", (n,), base_dir)
    idom = read_grid_array(bf, "GRIDDATA", "IDOMAIN", (n,), base_dir,
                           dtype=np.int64, default=1)
    if (np.asarray(idom) <= 0).any():
        raise NotImplementedError(
            f"{path}: IDOMAIN that removes a reach is not ported (R23: the "
            "reference reads the array and runs every reach)")
    verts = {}
    vb = bf.get("VERTICES")
    if vb is not None:
        for toks in vb.lines:
            verts[int(toks[0])] = (float(toks[1]), float(toks[2]))
    cb = bf.get("CELL1D")
    if cb is None:
        raise ValueError(f"{path}: DISV1D needs a CELL1D block")
    cells = [(int(toks[0]) - 1,
              [int(t) for t in toks[3:3 + int(toks[2])]])
             for toks in cb.lines]
    length, pairs = disv1d_reaches(verts, cells, n)
    return Disv1dGrid(n, length, np.asarray(width, np.float64),
                      np.asarray(bottom, np.float64), pairs)


def _load_dis2d(path, base_dir):
    """DIS2D6 → DisGrid (nlay=1, botm = land surface) for OLF."""
    bf = BlockFile(path)
    schema.check_options("swf-dis2d", bf.options(), path)
    dims = bf.dimensions()
    nrow, ncol = int(dims["NROW"]), int(dims["NCOL"])
    delr = read_grid_array(bf, "GRIDDATA", "DELR", (ncol,), base_dir)
    delc = read_grid_array(bf, "GRIDDATA", "DELC", (nrow,), base_dir)
    botm = read_grid_array(bf, "GRIDDATA", "BOTTOM", (nrow, ncol), base_dir)
    idom = read_grid_array(bf, "GRIDDATA", "IDOMAIN", (nrow, ncol),
                           base_dir, dtype=np.int64, default=1)
    top = float(np.max(botm)) + 1.0     # nominal; OLF uses botm as land
    return DisGrid.create(1, nrow, ncol, delr, delc, top, botm[None, :, :],
                          idomain=np.asarray(idom, np.int64)[None, :, :])


def _load_disv2d(path, base_dir):
    """DISV2D6 (olf-disv2d.dfn, Disv2d.f90): NODES/NVERT, GRIDDATA
    bottom/idomain, VERTICES, CELL2D."""
    from .loader import cell2d_block, vertices_block

    bf = BlockFile(path)
    schema.check_options("olf-disv2d", bf.options(), path)
    d = bf.dimensions()
    nodes, nvert = d["NODES"], d["NVERT"]
    verts = vertices_block(bf.get("VERTICES"), nvert)
    xc, yc, iavert, javert = cell2d_block(bf.get("CELL2D"), nodes)
    bottom = read_grid_array(bf, "GRIDDATA", "BOTTOM", (nodes,), base_dir)
    idom = read_grid_array(bf, "GRIDDATA", "IDOMAIN", (nodes,), base_dir,
                           dtype=np.int64, default=1)
    return Disv2dGrid.from_arrays(verts, xc, yc, iavert, javert,
                                  bottom.reshape(-1),
                                  idomain=idom.reshape(1, -1))


def _load_cxs(path):
    """CXS6 → the sections of ``build_chf(cxs_sections=)``, in id order:
    (xfraction, height, manfraction) with one roughness fraction per
    segment, the one at the segment's first station (SwfCxsUtils'
    composite conveyance).  The reference passes one per station, which
    its section table cannot take: it fails on every CXS6 deck (R32)."""
    bf = BlockFile(path)
    schema.check_options("swf-cxs", bf.options(), path)
    counts, order = {}, []
    for toks in bf.get("PACKAGEDATA").lines:
        idcxs = int(toks[0])
        counts[idcxs] = int(toks[1])
        order.append(idcxs)
    rows = [(float(t[0]), float(t[1]), float(t[2]) if len(t) > 2 else 1.0)
            for t in bf.get("CROSSSECTIONDATA").lines]
    sections, pos = {}, 0
    for idcxs in order:
        chunk = rows[pos:pos + counts[idcxs]]
        pos += counts[idcxs]
        xf, h, mf = (np.asarray([r[j] for r in chunk]) for j in range(3))
        sections[idcxs] = (xf, h, mf[:-1])
    return [sections[i] for i in sorted(sections)]


def _cellid(toks, start, grid_kind, ncol):
    if grid_kind in ("disv1d", "disv2d"):
        return int(toks[start]) - 1, 1
    row, col = int(toks[start]) - 1, int(toks[start + 1]) - 1
    return row * ncol + col, 2


def _stress_columns(records, grid_kind, ncol, ncols, skip):
    """PERIOD 1 records of one width as columns: ([(node, values...)], any
    nonzero IDCXS), as ``_stress_rows``' loop reads them, or None."""
    table = uniform_table(records)
    nt = 1 if grid_kind in ("disv1d", "disv2d") else 2
    if table is None or table[1] < nt + skip + ncols:
        return None
    toks, w = table
    try:
        cid = [np.array(list(map(int, toks[j::w])), np.int64) - 1
               for j in range(nt)]
        idcxs = [list(map(int, toks[nt::w]))] if skip else []
        vals = [list(map(float, toks[nt + skip + j::w]))
                for j in range(ncols)]
    except ValueError:
        return None
    node = cid[0] if nt == 1 else cid[0] * ncol + cid[1]
    return (list(zip(node.tolist(), *vals)),
            bool(idcxs and any(idcxs[0])))


def _stress_rows(path, component, what, grid_kind, ncol, ncols, skip=0):
    """PERIOD 1 of a stress package: (node, values...) per record; the
    ``skip`` fields after the cellid (ZDG's and CDB's IDCXS) must be 0."""
    bf = BlockFile(path)
    opts = _options(bf, component, path)
    _refuse(opts, ("TS6", "AUXMULTNAME"), path,
            "R22: the reference reads it past")
    # the later PERIOD blocks raise; of several PERIOD 1 blocks the last
    # counts (the reference's dict of blocks)
    blocks = {int(b.index): b for b in bf.get_all("PERIOD")}
    _only_first_period(blocks, what)
    fast = None if 1 not in blocks else _stress_columns(
        blocks[1].raw, grid_kind, ncol, ncols, skip)
    if fast is not None:
        if skip and fast[1]:
            raise NotImplementedError(
                f"{what} with a CXS section (idcxs>0) not supported yet")
        return fast[0]
    rows = []
    for toks in (blocks[1].lines if 1 in blocks else []):
        node, nt = _cellid(toks, 0, grid_kind, ncol)
        if skip and int(toks[nt]) != 0:
            raise NotImplementedError(
                f"{what} with a CXS section (idcxs>0) not supported yet")
        rows.append((node, *(float(toks[nt + skip + j])
                             for j in range(ncols))))
    return rows


def load_swf_model(ws, mfname, mname, mtype, device=None):
    """One CHF6/OLF6 model file → dict(model, grid, grid_kind, oc,
    sto_periods, has_sto, hds_path, name)."""
    path = os.path.join(ws, mfname)
    base_dir = os.path.dirname(path)
    nam = BlockFile(path)
    schema.check_options("chf-nam" if mtype == "CHF6" else "olf-nam",
                         nam.options(), path)
    pkg_files = {}
    for toks in nam.get("PACKAGES").lines:
        pkg_files.setdefault(toks[0].upper(), []).append(
            os.path.join(base_dir, toks[1]))

    ncol = None
    if "DISV1D6" in pkg_files:
        grid = _load_disv1d(pkg_files["DISV1D6"][0], base_dir)
        grid_kind = "disv1d"
    elif "DIS2D6" in pkg_files:
        grid = _load_dis2d(pkg_files["DIS2D6"][0], base_dir)
        grid_kind = "dis2d"
        ncol = grid.shape[2]
    elif "DISV2D6" in pkg_files:
        grid = _load_disv2d(pkg_files["DISV2D6"][0], base_dir)
        grid_kind = "disv2d"
    else:
        raise NotImplementedError(
            f"{mname}: SWF needs DISV1D6, DIS2D6, or DISV2D6 (got "
            f"{sorted(pkg_files)})")
    n = grid.nodes
    shp = (n,) if grid_kind in ("disv1d", "disv2d") else grid.shape[1:]

    # DFW (required): roughness, cross-section ids, spatial weighting
    dfw_path = pkg_files["DFW6"][0]
    dfw = BlockFile(dfw_path)
    dfw_opts = _options(dfw, "swf-dfw", dfw_path)
    _refuse(dfw_opts, ("DEV_SWR_CONDUCTANCE",), dfw_path,
            "R20: the reference reads it past")
    manningsn = read_grid_array(dfw, "GRIDDATA", "MANNINGSN", shp,
                                base_dir).reshape(-1)
    idcxs = read_grid_array(dfw, "GRIDDATA", "IDCXS", shp, base_dir,
                            dtype=np.int64, default=0)
    icentral = int("CENTRAL_IN_SPACE" in dfw_opts)
    # Manning unit conversion (swf-dfw.f90 unitconv): lconv^(1/3)/tconv
    lconv = float(dfw_opts.get("LENGTH_CONVERSION", 1.0) or 1.0)
    tconv = float(dfw_opts.get("TIME_CONVERSION", 1.0) or 1.0)
    unitconv = (lconv ** (1.0 / 3.0) / tconv
                if (lconv != 1.0 or tconv != 1.0) else 1.0)

    strt = None
    if "IC6" in pkg_files:
        ic = BlockFile(pkg_files["IC6"][0])
        schema.check_options("swf-ic", ic.options(), pkg_files["IC6"][0])
        strt = read_grid_array(ic, "GRIDDATA", "STRT", shp,
                               base_dir).reshape(-1)

    cxs_sections = (_load_cxs(pkg_files["CXS6"][0]) if "CXS6" in pkg_files
                    else None)

    # stress packages (first-period data)
    stress = {}
    for ftype, what, ncols, skip in (("FLW6", "FLW", 1, 0),
                                     ("CHD6", "CHD", 1, 0),
                                     ("ZDG6", "ZDG", 3, 1),
                                     ("PCP6", "PCP", 1, 0),
                                     ("EVP6", "EVP", 1, 0),
                                     ("CDB6", "CDB", 1, 1)):
        if ftype in pkg_files:
            stress[what.lower()] = _stress_rows(
                pkg_files[ftype][0], "swf-" + what.lower(), what, grid_kind,
                ncol, ncols, skip)

    # STO: per-period steady-state/transient flags
    sto_periods = {}
    has_sto = "STO6" in pkg_files
    if has_sto:
        bf = BlockFile(pkg_files["STO6"][0])
        schema.check_options("swf-sto", bf.options(), pkg_files["STO6"][0])
        for kper, lines in _period_blocks(bf).items():
            for toks in lines:
                sto_periods[kper] = toks[0].upper() != "STEADY-STATE"

    oc = None
    hds_path = os.path.join(ws, f"{mname.lower()}.stage")
    if "OC6" in pkg_files:
        from .loader import load_oc
        dv, _, oc = load_oc(pkg_files["OC6"][0], base_dir,
                            component="swf-oc")
        if dv:
            hds_path = dv

    build = build_chf if mtype == "CHF6" else build_olf
    kw = {}
    if cxs_sections is not None:
        kw["cxs_sections"] = cxs_sections
        kw["idcxs"] = np.asarray(idcxs).reshape(-1)
    model = build(mname.lower(), grid, manningsn=manningsn, strt=strt,
                  unitconv=unitconv, icentral=icentral, device=device,
                  **stress, **kw)
    return dict(model=model, grid=grid, grid_kind=grid_kind, oc=oc,
                sto_periods=sto_periods, has_sto=has_sto,
                hds_path=hds_path, name=mname)
