"""Load an MF6 simulation from an mfsim.nam workspace.

Port of the parts of modflow6_tpu/utils/mf6io/loader.py that the ported
GWF slices need (reference IDM load + SimulationCreate,
src/Utilities/Idm/IdmLoad.f90, src/SimulationCreate.f90:200-729):
``load_tdis``, ``load_ims``, ``load_dis``, ``load_disv``, ``load_disu``,
``load_oc``, the list-package reader, the GWF model loader and
``load_simulation`` for one GWF6 model on a DIS, DISV or DISU grid with the
packages DIS6/DISV6/DISU6, IC6, NPF6, STO6, CHD6, WEL6, DRN6, RIV6, GHB6,
EVT6 (with NSEG segments), RCH6 (list or READASARRAYS), BUY6, CSUB6 (no-delay
and delay interbeds, the first period's settings; the reference's
``advanced_loader.load_csub``) and OC6, with MF6's stress-period
persistence; the GWF
name-file option NEWTON [UNDER_RELAXATION], NPF REWET (WETFCT, IWETIT,
IHDWET) with the WETDRY array, the NPF TVK6 and STO TVS6 subpackages (to
``Simulation.tvk``/``tvs``), WEL AUTO_FLOW_REDUCE, and the IMS options
NO_PTC and PRECONDITIONER_LEVELS/PRECONDITIONER_DROP_TOLERANCE (the
reference program's ILU settings, mapped to a Chebyshev preconditioner of
order 4 with a warning).

Everything else a deck can ask for raises ``NotImplementedError`` naming
the package or keyword: other model types, several models, exchanges,
XT3D (which the reference's loader reads past, running the two-point
scheme), TS6/TAS6 series, HFB6 and the advanced packages, OBS6,
NetCDF, ATS6 and HPC6.  The reference's loader reads neither the NPF
ANGLE1/2/3 arrays nor the DRN AUXDEPTHNAME option (rotated anisotropy,
like HFB, reaches a model only through ``build_gwf``); this one raises on
them by name rather than run without them.
Keywords that only select listing or output
detail and that the reference's loader reads past (PRINT_INPUT,
PRINT_FLOWS, SAVE_FLOWS, SAVE_SPECIFIC_DISCHARGE, ...) are read past here
too.

Parsing happens on the host in numpy; ``device`` says where the model's
tensors go: ``None`` is the CUDA device, ``"cpu"`` the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch

from ... import resolve_device
from ...models.discretization import DisGrid, DisuGrid, DisvGrid
from ...models.gwf import bnd, builder
from ...models.gwf.buy import make_buy
from ...models.gwf.csub import make_csub
from ...models.gwf.model import PackageData
from ...models.simulation import Simulation
from ...solution.ims import ImsSettings
from ...timing.tdis import StressPeriod, Tdis
from ..oc import OutputControl, parse_spec
from . import schema
from .arrays import read_grid_array
from .reader import BlockFile

# package types of a GWF name file that the slice covers
_SUPPORTED_PACKAGES = ("DIS6", "DISV6", "DISU6", "IC6", "NPF6", "STO6", "CHD6",
                       "WEL6", "DRN6", "RIV6", "GHB6", "EVT6", "RCH6", "BUY6",
                       "CSUB6", "OC6")
# options of a list package that would change its flows and are not ported
_UNPORTED_LIST_OPTIONS = ("TS6", "OBS6", "MOVER", "AUXMULTNAME",
                          "AUXDEPTHNAME", "SURF_RATE_SPECIFIED")


def _f(tok):
    return float(tok)


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported")


def _refuse(opts, keys, source):
    """Raise for the first option of ``keys`` that the file sets."""
    for key in keys:
        if key in opts:
            raise _not_ported(f"{source}: option {key}")


def load_tdis(path):
    bf = BlockFile(path)
    dims = bf.dimensions()
    nper = dims.get("NPER", 1)
    b = bf.get("PERIODDATA")
    periods = []
    for toks in b.lines[:nper]:
        periods.append(StressPeriod(float(toks[0]), int(toks[1]),
                                    float(toks[2])))
    opts = bf.options()
    schema.check_options("sim-tdis", opts, path)
    _refuse(opts, ("ATS6",), path)
    return Tdis(tuple(periods),
                time_units=str(opts.get("TIME_UNITS", "UNKNOWN")),
                start_date_time=str(opts.get("START_DATE_TIME", "")))


def load_ims(path) -> ImsSettings:
    bf = BlockFile(path)
    opts = bf.options()
    schema.check_options("sln-ims", opts, path)
    complexity = opts.get("COMPLEXITY", "SIMPLE")
    if isinstance(complexity, bool):
        complexity = "SIMPLE"
    s = ImsSettings.from_complexity(str(complexity))
    v = opts.get("CSV_INNER_OUTPUT")
    if isinstance(v, list) and v[0].upper() == "FILEOUT":
        s.csv_inner_path = os.path.join(os.path.dirname(path), v[1])

    nl = bf.get("NONLINEAR")
    if nl is not None:
        kv = {t[0].upper(): t[1:] for t in nl.lines}
        if "OUTER_DVCLOSE" in kv:
            s.outer_dvclose = _f(kv["OUTER_DVCLOSE"][0])
        if "OUTER_HCLOSE" in kv:  # deprecated alias
            s.outer_dvclose = _f(kv["OUTER_HCLOSE"][0])
        if "OUTER_MAXIMUM" in kv:
            s.outer_maximum = int(kv["OUTER_MAXIMUM"][0])
        if "UNDER_RELAXATION" in kv:
            ur = kv["UNDER_RELAXATION"][0].upper()
            s.under_relaxation = {"NONE": "none", "SIMPLE": "simple",
                                  "COOLEY": "cooley", "DBD": "dbd"}[ur]
        if "UNDER_RELAXATION_GAMMA" in kv:
            s.gamma = _f(kv["UNDER_RELAXATION_GAMMA"][0])
        if "UNDER_RELAXATION_THETA" in kv:
            s.theta = _f(kv["UNDER_RELAXATION_THETA"][0])
        if "UNDER_RELAXATION_KAPPA" in kv:
            s.akappa = _f(kv["UNDER_RELAXATION_KAPPA"][0])
        if "UNDER_RELAXATION_MOMENTUM" in kv:
            s.amomentum = _f(kv["UNDER_RELAXATION_MOMENTUM"][0])
        if "BACKTRACKING_NUMBER" in kv:
            s.backtracking_number = int(kv["BACKTRACKING_NUMBER"][0])
        if "BACKTRACKING_TOLERANCE" in kv:
            s.backtracking_tolerance = _f(kv["BACKTRACKING_TOLERANCE"][0])
        if "BACKTRACKING_REDUCTION_FACTOR" in kv:
            s.backtracking_reduction_factor = _f(
                kv["BACKTRACKING_REDUCTION_FACTOR"][0])
        if "BACKTRACKING_RESIDUAL_LIMIT" in kv:
            s.backtracking_residual_limit = _f(
                kv["BACKTRACKING_RESIDUAL_LIMIT"][0])

    lin = bf.get("LINEAR")
    if lin is not None:
        kv = {t[0].upper(): t[1:] for t in lin.lines}
        if "INNER_MAXIMUM" in kv:
            s.inner_maximum = int(kv["INNER_MAXIMUM"][0])
        if "INNER_DVCLOSE" in kv:
            s.inner_dvclose = _f(kv["INNER_DVCLOSE"][0])
        if "INNER_HCLOSE" in kv:
            s.inner_dvclose = _f(kv["INNER_HCLOSE"][0])
        if "INNER_RCLOSE" in kv:
            s.inner_rclose = _f(kv["INNER_RCLOSE"][0])
            if len(kv["INNER_RCLOSE"]) > 1:
                opt = kv["INNER_RCLOSE"][1].upper()
                s.icnvgopt = {"STRICT": 1, "L2NORM_RHS": 2,
                              "RELATIVE_RCLOSE": 3,
                              "L2NORM_RELATIVE_RCLOSE": 4}.get(opt, 0)
        if "LINEAR_ACCELERATION" in kv:
            acc = kv["LINEAR_ACCELERATION"][0].upper()
            s.linear_acceleration = "cg" if acc == "CG" else "bicgstab"
        if "RELAXATION_FACTOR" in kv:
            s.relaxation_factor = _f(kv["RELAXATION_FACTOR"][0])
            if s.relaxation_factor != 0.0:
                # the reference program uses this as the MILU(0)/MILUT relax
                # of its ILU factorization (ImsLinearBase.f90 ims_base_pcu);
                # this package preconditions with Jacobi or Chebyshev
                # polynomials, where no such knob exists
                warnings.warn(
                    "IMS RELAXATION_FACTOR applies to an ILU preconditioner; "
                    "this package preconditions with Jacobi or polynomials "
                    "and ignores it "
                    "(iteration counts may differ, results do not)",
                    stacklevel=2)
        if "NUMBER_ORTHOGONALIZATIONS" in kv:
            s.north = int(kv["NUMBER_ORTHOGONALIZATIONS"][0])
        if "PRECONDITIONER_LEVELS" in kv or \
                "PRECONDITIONER_DROP_TOLERANCE" in kv:
            warnings.warn(
                "IMS PRECONDITIONER_LEVELS/DROP_TOLERANCE configure the "
                "reference program's ILUT; this package maps them to a "
                "Chebyshev polynomial preconditioner of matching cost",
                stacklevel=2)
            s.preconditioner = "chebyshev"
            s.preconditioner_order = 4

    # NO_PTC lives in the OPTIONS block (sln-ims.dfn:134-156)
    no_ptc = opts.get("NO_PTC")
    if no_ptc is not None:
        val = str(no_ptc).upper()
        s.no_ptc = "first" if val == "FIRST" else "all"
    return s


def load_dis(path) -> DisGrid:
    bf = BlockFile(path)
    base = os.path.dirname(path)
    d = bf.dimensions()
    nlay, nrow, ncol = d["NLAY"], d["NROW"], d["NCOL"]
    delr = read_grid_array(bf, "GRIDDATA", "DELR", (ncol,), base)
    delc = read_grid_array(bf, "GRIDDATA", "DELC", (nrow,), base)
    top = read_grid_array(bf, "GRIDDATA", "TOP", (nrow, ncol), base)
    botm = read_grid_array(bf, "GRIDDATA", "BOTM", (nlay, nrow, ncol), base)
    idomain = read_grid_array(bf, "GRIDDATA", "IDOMAIN", (nlay, nrow, ncol),
                              base, dtype=np.int64, default=1)
    opts = bf.options()
    schema.check_options("gwf-dis", opts, path)
    schema.check_griddata("gwf-dis", bf, path)
    return DisGrid.create(nlay, nrow, ncol, delr, delc, top, botm, idomain,
                          xorigin=float(opts.get("XORIGIN", 0.0)),
                          yorigin=float(opts.get("YORIGIN", 0.0)),
                          angrot=float(opts.get("ANGROT", 0.0)))


def load_disv(path) -> DisvGrid:
    """DISV grid file (reference src/Model/Discretization/Disv.f90 +
    gwf-disv.dfn): DIMENSIONS NCPL/NLAY/NVERT, VERTICES, CELL2D blocks."""
    bf = BlockFile(path)
    base = os.path.dirname(path)
    d = bf.dimensions()
    nlay, ncpl, nvert = d["NLAY"], d["NCPL"], d["NVERT"]
    verts = np.zeros((nvert, 2))
    for toks in bf.get("VERTICES").lines:
        verts[int(toks[0]) - 1] = (float(toks[1]), float(toks[2]))
    cell2d = [None] * ncpl
    for toks in bf.get("CELL2D").lines:
        ncvert = int(toks[3])
        ivs = [int(t) - 1 for t in toks[4:4 + ncvert]]
        # MF6 lists cell vertices clockwise with an optional closing
        # duplicate; DisvGrid wants an open ring
        if len(ivs) > 1 and ivs[0] == ivs[-1]:
            ivs = ivs[:-1]
        cell2d[int(toks[0]) - 1] = (float(toks[1]), float(toks[2]), ivs)
    top = read_grid_array(bf, "GRIDDATA", "TOP", (ncpl,), base)
    botm = read_grid_array(bf, "GRIDDATA", "BOTM", (nlay, ncpl), base)
    idomain = read_grid_array(bf, "GRIDDATA", "IDOMAIN", (nlay, ncpl),
                              base, dtype=np.int64, default=1)
    return DisvGrid.create(nlay, ncpl, verts, cell2d, top, botm, idomain)


def load_disu(path) -> DisuGrid:
    """DISU grid file (Disu.f90 + gwf-disu.dfn): NODES/NJA dimensions,
    GRIDDATA top/bot/area, CONNECTIONDATA iac/ja/ihc/cl12/hwva/angldegx."""
    bf = BlockFile(path)
    base = os.path.dirname(path)
    d = bf.dimensions()
    nodes, nja = d["NODES"], d["NJA"]
    top = read_grid_array(bf, "GRIDDATA", "TOP", (nodes,), base)
    bot = read_grid_array(bf, "GRIDDATA", "BOT", (nodes,), base)
    area = read_grid_array(bf, "GRIDDATA", "AREA", (nodes,), base)
    idomain = read_grid_array(bf, "GRIDDATA", "IDOMAIN", (nodes,), base,
                              dtype=np.int64, default=1)

    def conn(name, dtype=np.float64):
        return read_grid_array(bf, "CONNECTIONDATA", name,
                               (nodes,) if name == "IAC" else (nja,), base,
                               dtype=dtype)

    # MF6 ja is 1-based with each row led by the cell number itself
    return DisuGrid.create(top, bot, area, conn("IAC", np.int64),
                           np.abs(conn("JA", np.int64)) - 1,
                           conn("IHC", np.int64), conn("CL12"), conn("HWVA"),
                           conn("ANGLDEGX"), idomain)


def _load_grid(pkg_files):
    """Dispatch the discretization package (DIS6/DISV6/DISU6)."""
    if "DIS6" in pkg_files:
        return load_dis(pkg_files["DIS6"][0])
    if "DISV6" in pkg_files:
        return load_disv(pkg_files["DISV6"][0])
    if "DISU6" in pkg_files:
        return load_disu(pkg_files["DISU6"][0])
    raise ValueError("model requires a DIS6, DISV6, or DISU6 package")


def load_oc(path, mdir, component="gwf-oc"):
    """OC file → (hds_path, cbc_path, OutputControl with PERIOD blocks)."""
    bf = BlockFile(path)
    opts = bf.options()
    schema.check_options(component, opts, path)

    def _fileout(key):
        v = opts.get(key)
        if isinstance(v, list) and v[0].upper() == "FILEOUT":
            return os.path.join(mdir, v[1])
        return None

    oc = OutputControl()
    for b in bf.get_all("PERIOD"):
        actions = {}
        for toks in b.lines:
            verb = toks[0].upper()
            what = toks[1].upper()
            if verb in ("SAVE", "PRINT"):
                actions[(verb, what)] = parse_spec(toks[2:])
        oc.set_period(b.index, actions)
    return _fileout("HEAD"), _fileout("BUDGET"), oc


def _cellid_to_node(toks, grid, start=0):
    """Parse a cellid (1-based: layer row column, layer cell, or node) →
    0-based node; returns (node, ntok)."""
    if isinstance(grid, DisGrid):
        k, i, j = (int(toks[start]) - 1, int(toks[start + 1]) - 1,
                   int(toks[start + 2]) - 1)
        return int(grid.node_number(k, i, j)), 3
    if isinstance(grid, DisvGrid):
        k, c = int(toks[start]) - 1, int(toks[start + 1]) - 1
        return k * grid.ncpl + c, 2
    return int(toks[start]) - 1, 1


def _load_period_lists(path, grid, ncols, component=None):
    """Read a list-based stress package file.

    Returns (options, dimensions, {kper: [(node, v1, v2, ...)]}).  Columns
    after the ``ncols`` values (auxiliary variables, boundnames) do not
    enter the flow model and are read past.  A value given as a time-series
    name raises: the TS6 series are not ported.
    """
    bf = BlockFile(path)
    opts = bf.options()
    if component:
        schema.check_options(component, opts, path)
    _refuse(opts, _UNPORTED_LIST_OPTIONS, path)
    dims = bf.dimensions()
    periods = {}
    for b in bf.get_all("PERIOD"):
        entries = []
        for toks in bf.expand_open_close(b):
            node, ntok = _cellid_to_node(toks, grid)
            vals = []
            for col in range(ncols):
                t = toks[ntok + col]
                try:
                    vals.append(float(t))
                except ValueError:
                    raise _not_ported(
                        f"{path}: time-series value {t!r} (TS6)") from None
            entries.append((node, *vals))
        periods[b.index] = entries
    return opts, dims, periods


_LIST_PACKAGES = {
    "CHD6": ("chd", 1, builder.chd_data),
    "WEL6": ("wel", 1, builder.wel_data),
    "DRN6": ("drn", 2, builder.drn_data),
    "RIV6": ("riv", 3, builder.riv_data),
    "GHB6": ("ghb", 2, builder.ghb_data),
    "RCH6": ("rch", 1, builder.rch_data),
    "EVT6": ("evt", 3, builder.evt_data),
}


def _load_tv(bfopts, key, mdir, grid):
    """TVK6/TVS6 FILEIN subpackage → {kper: [(node, PROP, value)]}
    (gwf-tvk.f90 / gwf-tvs.f90 period blocks)."""
    v = bfopts.get(key)
    if not (isinstance(v, list) and v[0].upper() == "FILEIN"):
        return {}
    tv_bf = BlockFile(os.path.join(mdir, v[1]))
    out = {}
    for b in tv_bf.get_all("PERIOD"):
        entries = []
        for toks in tv_bf.expand_open_close(b):
            node, ntok = _cellid_to_node(toks, grid)
            entries.append((node, toks[ntok].upper(), float(toks[ntok + 1])))
        out[b.index] = entries
    return out


def _load_buy(path):
    """BUY6 file → make_buy keyword arguments: DENSEREF and the per-species
    PACKAGEDATA (irhospec modelname auxspeciesname drhodc crhoref)."""
    bf = BlockFile(path)
    bopts = bf.options()
    schema.check_options("gwf-buy", bopts, path)
    drho, cref = [], []
    pd = bf.get("PACKAGEDATA")
    if pd is not None:
        for toks in pd.lines:
            drho.append(float(toks[3]))
            cref.append(float(toks[4]))
    return dict(denseref=float(bopts.get("DENSEREF", 1000.0)),
                drhodc=drho or [0.7], crhoref=cref or [0.0],
                iform=1 if "HHFORMULATION_RHS" in bopts else 2)


def _load_csub(path, grid, shp, base_dir):
    """CSUB6 file → make_csub keyword arguments (gwf-csub.dfn blocks; the
    reference's advanced_loader.load_csub): the coarse-grained GRIDDATA and
    the PACKAGEDATA interbeds, NODELAY or DELAY.  Settings of a PERIOD
    block after the first raise, as in the reference."""
    bf = BlockFile(path)
    opts = bf.options()
    schema.check_options("gwf-csub", opts, path)
    kw = dict(head_based="HEAD_BASED" in opts)
    dims = bf.dimensions()
    for key, name, default in (("cg_ske_cr", "CG_SKE_CR", 1e-5),
                               ("cg_theta", "CG_THETA", 0.2),
                               ("sgm", "SGM", 1.7), ("sgs", "SGS", 2.0)):
        kw[key] = np.asarray(read_grid_array(
            bf, "GRIDDATA", name, shp, base_dir, default=default)).reshape(-1)
    interbeds, delay = [], []
    pb = bf.get("PACKAGEDATA")
    if pb is not None and dims.get("NINTERBEDS", 0):
        for toks in pb.lines:
            node, nt = _cellid_to_node(toks, grid, start=1)
            c = 1 + nt
            # cdelay pcs0 thick_frac rnb ssv_cc sse_cr theta kv h0
            thick = float(toks[c + 2])
            rnb = float(toks[c + 3])
            ssv = float(toks[c + 4])
            sse = float(toks[c + 5])
            theta = float(toks[c + 6])
            if toks[c].upper() == "DELAY":
                delay.append(dict(node=node, thick=thick, rnb=rnb,
                                  kv=float(toks[c + 7]), sske_cr=sse,
                                  ssv_cc=ssv, theta=theta))
            else:
                interbeds.append((node, thick, sse, ssv, theta))
    kw["interbeds"] = interbeds
    kw["delay_interbeds"] = delay
    late = [b.index for b in bf.get_all("PERIOD") if b.index > 1]
    if late:
        raise NotImplementedError(
            f"CSUB: PERIOD blocks beyond the first stress period "
            f"(kper={late}) are not supported by the deck loader yet")
    return kw


def _load_rcha(path, shp, mdir, device):
    """Array-based recharge (gwf-rcha.dfn READASARRAYS): one RECHARGE array
    over the top layer, read from the first PERIOD block, as the reference's
    loader reads it."""
    rch_bf = BlockFile(path)
    ropts = rch_bf.options()
    schema.check_options("gwf-rcha", ropts, path)
    _refuse(ropts, ("TAS6", "OBS6", "MOVER", "AUXMULTNAME"), path)
    blocks = rch_bf.get_all("PERIOD")
    pb = rch_bf.get("PERIOD", 1)
    if pb is None or not pb.lines:
        raise _not_ported(f"{path}: RCHA without a PERIOD 1 block")
    if len(blocks) > 1:
        raise _not_ported(f"{path}: RCHA with more than one PERIOD block")
    head_toks = pb.lines[0]
    if head_toks[0].upper() != "RECHARGE":
        raise _not_ported(f"{path}: RCHA period variable {head_toks[0]}")
    if len(head_toks) > 1 and head_toks[1].upper() == "TIMEARRAYSERIES":
        raise _not_ported(f"{path}: TIMEARRAYSERIES (TAS6)")
    rcha = np.asarray(read_grid_array(rch_bf, "PERIOD", "RECHARGE",
                                      shp[1:] if len(shp) > 1 else shp,
                                      mdir), np.float64).reshape(-1)
    return bnd.RchData(
        torch.arange(rcha.size, dtype=torch.int64, device=device),
        torch.as_tensor(rcha, dtype=torch.float64, device=device),
        torch.ones(rcha.size, dtype=torch.bool, device=device))


def _load_gwf_model(ws, mfname, mname, device):
    """Load one GWF model nam file + packages → a bundle dict."""
    mnam = BlockFile(os.path.join(ws, mfname))
    mdir = os.path.dirname(os.path.join(ws, mfname))
    mopts = mnam.options()
    schema.check_options("gwf-nam", mopts, mfname)
    _refuse(mopts, ("NETCDF_STRUCTURED", "NETCDF_MESH2D", "NETCDF"), mfname)
    newton = False
    if "NEWTON" in mopts:
        v = mopts["NEWTON"]
        vals = ([str(x).upper() for x in (v if isinstance(v, list) else [v])]
                if v is not True else [])
        newton = "under_relaxation" if "UNDER_RELAXATION" in vals else True

    pkg_files = {}
    for toks in mnam.get("PACKAGES").lines:
        ftype = toks[0].upper()
        if ftype not in _SUPPORTED_PACKAGES:
            raise _not_ported(f"{mfname}: package {ftype}")
        pkg_files.setdefault(ftype, []).append(os.path.join(mdir, toks[1]))
    for ftype in ("IC6", "NPF6"):
        if ftype not in pkg_files:
            raise ValueError(f"{mfname}: model requires a {ftype} package")

    grid = _load_grid(pkg_files)
    shp = grid.shape
    base = mdir

    ic_bf = BlockFile(pkg_files["IC6"][0])
    strt = read_grid_array(ic_bf, "GRIDDATA", "STRT", shp, base, default=0.0)

    npf_path = pkg_files["NPF6"][0]
    npf_bf = BlockFile(npf_path)
    nopts = npf_bf.options()
    schema.check_options("gwf-npf", nopts, npf_path)
    schema.check_griddata("gwf-npf", npf_bf, npf_path)
    _refuse(nopts, ("XT3D",), npf_path)
    gd = npf_bf.get("GRIDDATA")
    for name in schema.griddata_names(gd.lines if gd is not None else []):
        if name in ("ANGLE1", "ANGLE2", "ANGLE3"):
            raise _not_ported(f"{npf_path}: griddata {name}")
    rewetting = None
    if "REWET" in nopts:
        # REWET WETFCT <f> IWETIT <i> IHDWET <i> record (gwf-npf.dfn)
        v = nopts["REWET"]
        toks = [str(t).upper() for t in (v if isinstance(v, list) else [])]
        kv = {toks[i]: toks[i + 1] for i in range(0, len(toks) - 1, 2)}
        wetdry_arr = read_grid_array(npf_bf, "GRIDDATA", "WETDRY", shp, base,
                                     default=0.0)
        rewetting = dict(wetdry=np.asarray(wetdry_arr).reshape(-1),
                         wetfct=float(kv.get("WETFCT", 1.0)),
                         iwetit=int(kv.get("IWETIT", 1)),
                         ihdwet=int(kv.get("IHDWET", 0)))
    icellavg = 0
    if "ALTERNATIVE_CELL_AVERAGING" in nopts:
        v = str(nopts["ALTERNATIVE_CELL_AVERAGING"]).upper()
        schema.check_valid_value("gwf-npf", "options",
                                 "ALTERNATIVE_CELL_AVERAGING", v, npf_path)
        icellavg = {"LOGARITHMIC": 1, "AMT-LMK": 2, "AMT-HMK": 3}[v]
    icelltype = read_grid_array(npf_bf, "GRIDDATA", "ICELLTYPE", shp, base,
                                dtype=np.int64, default=0)
    k = read_grid_array(npf_bf, "GRIDDATA", "K", shp, base, default=1.0)
    k22 = read_grid_array(npf_bf, "GRIDDATA", "K22", shp, base)
    k33 = read_grid_array(npf_bf, "GRIDDATA", "K33", shp, base)
    if k33 is not None and "K33OVERK" in nopts:
        k33 = k33 * k
    if k22 is not None and "K22OVERK" in nopts:
        k22 = k22 * k

    tvk = _load_tv(nopts, "TVK6", mdir, grid)

    storage = None
    sto_periods = {}
    tvs = {}
    if "STO6" in pkg_files:
        sto_path = pkg_files["STO6"][0]
        sto_bf = BlockFile(sto_path)
        sopts = sto_bf.options()
        schema.check_options("gwf-sto", sopts, sto_path)
        schema.check_griddata("gwf-sto", sto_bf, sto_path)
        storage = dict(
            iconvert=read_grid_array(sto_bf, "GRIDDATA", "ICONVERT", shp,
                                     base, dtype=np.int64, default=0).reshape(-1),
            ss=read_grid_array(sto_bf, "GRIDDATA", "SS", shp, base,
                               default=0.0).reshape(-1),
            sy=read_grid_array(sto_bf, "GRIDDATA", "SY", shp, base,
                               default=0.0).reshape(-1),
            istor_coef=1 if "STORAGECOEFFICIENT" in sopts else 0,
            iconf_ss=1 if "SS_CONFINED_ONLY" in sopts else 0)
        for b in sto_bf.get_all("PERIOD"):
            kw = b.lines[0][0].upper() if b.lines else "TRANSIENT"
            sto_periods[b.index] = (kw == "TRANSIENT")
        tvs = _load_tv(sopts, "TVS6", mdir, grid)

    # --- array-based recharge (gwf-rcha.dfn READASARRAYS)
    rcha = None
    if "RCH6" in pkg_files and \
            "READASARRAYS" in BlockFile(pkg_files["RCH6"][0]).options():
        if len(pkg_files["RCH6"]) > 1:
            raise _not_ported(f"{mfname}: several RCH6 packages with "
                              "READASARRAYS")
        rcha = _load_rcha(pkg_files["RCH6"][0], shp, mdir, device)
        del pkg_files["RCH6"]

    # --- stress packages with period data
    pkg_periods = {}   # attr -> {kper: entries}
    pkg_opts = {}      # attr -> options of the package's (last) file
    for ftype, (attr, ncols, _) in _LIST_PACKAGES.items():
        if ftype not in pkg_files:
            continue
        all_periods = {}
        for path in pkg_files[ftype]:   # multiple instances merge
            if ftype == "EVT6":
                # segmented ET: extra pxdp/petm columns (gwf-evt.dfn NSEG)
                nseg = BlockFile(path).dimensions().get("NSEG", 1)
                ncols = 3 + 2 * (nseg - 1)
            pkg_opts[attr], _, periods = _load_period_lists(
                path, grid, ncols, component="gwf-" + ftype[:-1].lower())
            for kper, entries in periods.items():
                all_periods.setdefault(kper, []).extend(entries)
        pkg_periods[attr] = all_periods

    # maxbound across periods per package (static shapes)
    first_pkgs = {}
    maxbound = {}
    mkmap = {a: f for a, _, f in _LIST_PACKAGES.values()}
    for attr, periods in pkg_periods.items():
        mb = max((len(v) for v in periods.values()), default=1)
        maxbound[attr] = mb
        # period-1 state: empty (all-masked) unless the package defines
        # PERIOD 1 — later periods activate via period_data
        first_pkgs[attr] = mkmap[attr](periods.get(1, []), maxbound=mb,
                                       device=device)

    wel_afr = None
    if "AUTO_FLOW_REDUCE" in pkg_opts.get("wel", {}):
        wel_afr = float(pkg_opts["wel"]["AUTO_FLOW_REDUCE"])

    model = builder.build_gwf(
        mname, grid,
        icelltype=icelltype.reshape(-1), k=k.reshape(-1),
        k22=k22.reshape(-1) if k22 is not None else None,
        k33=k33.reshape(-1) if k33 is not None else None,
        strt=strt.reshape(-1), newton=newton,
        icellavg=icellavg,
        ivarcv=1 if "VARIABLECV" in nopts else 0,
        idewatcv=1 if (isinstance(nopts.get("VARIABLECV"), (list, str))
                       and "DEWATERED" in str(nopts["VARIABLECV"]).upper())
        else 0,
        iperched=1 if "PERCHED" in nopts else 0,
        thickstrt="THICKSTRT" in nopts,
        storage=storage, wel_auto_flow_reduce=wel_afr, rewetting=rewetting,
        device=device)

    # attach first-period package data
    for attr, data in first_pkgs.items():
        setattr(model, attr, data)
    if rcha is not None:
        model.rch = rcha
        # carry the array recharge through the period-data persistence
        first_pkgs["rch"] = rcha

    # --- BUY buoyancy package (gwf-buy.dfn)
    if "BUY6" in pkg_files:
        model.buy = make_buy(**_load_buy(pkg_files["BUY6"][0]))
    # --- CSUB compaction and subsidence (gwf-csub.dfn)
    if "CSUB6" in pkg_files:
        model.csub, model.csub_state0 = make_csub(
            grid, strt=model.strt, device=device,
            **_load_csub(pkg_files["CSUB6"][0], grid, shp, base))

    # --- OC output files + period selection
    hds_path = cbc_path = oc = None
    if "OC6" in pkg_files:
        hds_path, cbc_path, oc = load_oc(pkg_files["OC6"][0], mdir)

    return dict(name=mname, model=model, grid=grid, storage=storage,
                sto_periods=sto_periods, pkg_periods=pkg_periods,
                maxbound=maxbound, first_pkgs=first_pkgs,
                hds_path=hds_path, cbc_path=cbc_path, oc=oc, tvk=tvk,
                tvs=tvs)


def _transient_flags(tdis, storage, sto_periods):
    """Per-period steady/transient flags with MF6 persistence (initial
    default steady if STO absent, first STO period setting otherwise)."""
    transient = []
    cur = storage is not None
    if sto_periods:
        cur = sto_periods.get(min(sto_periods), cur)
    for kper in range(1, tdis.nper + 1):
        if kper in sto_periods:
            cur = sto_periods[kper]
        transient.append(cur)
    return transient


def _attach_period_data(simulation, pkg_periods, maxbound, first_pkgs,
                        device):
    """Fill simulation.period_data with MF6 persistence semantics."""
    all_kpers = sorted({kp for periods in pkg_periods.values()
                        for kp in periods})
    if not all_kpers:
        return
    mkmap = {a: f for a, _, f in _LIST_PACKAGES.values()}
    current = dict(first_pkgs)
    for kper in all_kpers:
        for attr, periods in pkg_periods.items():
            if kper in periods:
                current[attr] = mkmap[attr](periods[kper],
                                            maxbound=maxbound[attr],
                                            device=device)
        simulation.period_data[kper] = PackageData(
            **{a: current.get(a)
               for a in (f.name for f in dataclasses.fields(PackageData))})


def load_simulation(workspace, hds_path=None, cbc_path=None, lst_path=None,
                    device=None):
    """Load mfsim.nam and everything it references → Simulation.

    Supported: one GWF6 model with one IMS solution (see the
    module docstring).  ``device=None`` puts the model on the CUDA device
    and raises when there is none; pass ``"cpu"`` to run on the CPU.
    """
    device = resolve_device(device)
    ws = os.path.abspath(workspace)
    sim = BlockFile(os.path.join(ws, "mfsim.nam"))
    sopts = sim.options()
    _refuse(sopts, ("HPC6",), "mfsim.nam")

    # timing
    timing = sim.get("TIMING")
    tdis = load_tdis(os.path.join(ws, timing.lines[0][1]))

    # models
    models_blk = sim.get("MODELS")
    if models_blk is None or not models_blk.lines:
        raise ValueError("mfsim.nam names no model")
    entries = []
    for i, toks in enumerate(models_blk.lines):
        mtype = toks[0].upper()
        mname = toks[2].upper() if len(toks) > 2 else f"MODEL{i + 1}"
        if mtype != "GWF6":
            raise _not_ported(f"mfsim.nam: model type {mtype}")
        entries.append((toks[1], mname))
    if len(entries) > 1:
        raise _not_ported("mfsim.nam: more than one model")
    exg_blk = sim.get("EXCHANGES")
    if exg_blk is not None and exg_blk.lines:
        raise _not_ported(f"mfsim.nam: exchange {exg_blk.lines[0][0].upper()}")

    # solution groups → the model's IMS settings
    settings = None
    for sg in sim.get_all("SOLUTIONGROUP"):
        for toks in sg.lines:
            if toks[0].upper() == "IMS6" and settings is None:
                settings = load_ims(os.path.join(ws, toks[1]))
    if settings is None:
        settings = ImsSettings()

    mfname, mname = entries[0]
    bundle = _load_gwf_model(ws, mfname, mname, device)
    # Newton Jacobians are asymmetric: CG diverges there (the reference
    # program requires BICGSTAB for asymmetric systems); upgrade with a
    # warning
    if bundle["model"].inewton and settings.linear_acceleration == "cg":
        warnings.warn("deck requests CG but the system is asymmetric "
                      "(Newton); using BICGSTAB", stacklevel=2)
        settings = dataclasses.replace(settings,
                                       linear_acceleration="bicgstab")
    transient = _transient_flags(tdis, bundle["storage"],
                                 bundle["sto_periods"])
    simulation = Simulation(
        tdis, bundle["model"], settings, transient=transient,
        hds_path=hds_path or bundle["hds_path"],
        cbc_path=cbc_path or bundle["cbc_path"],
        lst_path=lst_path, oc=bundle["oc"])
    # reference failure semantics: abort on nonconvergence unless the
    # simulation CONTINUE option is set (sim-nam continue keyword)
    simulation.fail_fast = "CONTINUE" not in sopts
    simulation.tvk = bundle["tvk"]
    simulation.tvs = bundle["tvs"]
    _attach_period_data(simulation, bundle["pkg_periods"],
                        bundle["maxbound"], bundle["first_pkgs"], device)
    return simulation
