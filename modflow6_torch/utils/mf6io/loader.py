"""Load an MF6 simulation from an mfsim.nam workspace.

Port of the parts of modflow6_tpu/utils/mf6io/loader.py that the ported
GWF slices need (reference IDM load + SimulationCreate,
src/Utilities/Idm/IdmLoad.f90, src/SimulationCreate.f90:200-729):
``load_tdis``, ``load_ims``, ``load_dis``, ``load_disv``, ``load_disu``,
``load_oc``, the list-package reader, ``load_exchange_gwfgwf``, the GWF
model loader and ``load_simulation`` for one GWF6 model, or several joined
by GWF6-GWF6 exchanges (merged into one model, with the exchanges' MVR6
movers), on DIS, DISV or DISU grids, with the
packages DIS6/DISV6/DISU6, IC6, NPF6, STO6, CHD6, WEL6, DRN6, RIV6, GHB6,
EVT6 (with NSEG segments), RCH6 (list or READASARRAYS), BUY6, CSUB6 (no-delay
and delay interbeds, the first period's settings; the reference's
``advanced_loader.load_csub``), MAW6, LAK6 (with TAB6 tables), SFR6, UZF6
and MVR6 (``advanced_loader``; their later PERIOD blocks rebuild the
augmented model or the UZF columns at each such period's start, as the
reference's ``_attach_advanced_periods`` does) and OC6, with MF6's
stress-period persistence; the list packages' MOVER option, BOUNDNAMES
and values given as the names of TS6 time series (bound per step through
``Simulation.step_hooks``); RCHA's TIMEARRAYSERIES over a TAS6 file; the
model's OBS6 files (continuous HEAD, DRAWDOWN and boundary-flow
observations, flows by cellid or boundname); the GWF name-file options
NETCDF_STRUCTURED FILEOUT (``Simulation``'s NetCDF export) and NETCDF
FILEIN (griddata records tagged NETCDF) and NEWTON
[UNDER_RELAXATION], NPF REWET (WETFCT, IWETIT,
IHDWET) with the WETDRY array, the NPF TVK6 and STO TVS6 subpackages (to
``Simulation.tvk``/``tvs``), WEL AUTO_FLOW_REDUCE, and the IMS options
NO_PTC and PRECONDITIONER_LEVELS/PRECONDITIONER_DROP_TOLERANCE (the
reference program's ILU settings, mapped to a Chebyshev preconditioner of
order 4 with a warning).

Everything else a deck can ask for raises ``NotImplementedError`` naming
the package or keyword: other model types and exchange types, several
models with no exchange, XT3D (which the reference's loader reads past,
running the two-point scheme), HFB6, ATS6 in TDIS (read past there too:
adaptive steps reach a ``Simulation`` only through ``Simulation.ats``),
NETCDF_MESH2D and a list package's own OBS6 option (both read past
there), TS6 values in MAW6, LAK6 and SFR6, and HPC6; and where the
reference refuses: UZF or CSUB in a merged model,
TVK/TVS with several models, standard-package mover providers outside the
first model, later PERIOD blocks of an exchange's MVR6.  Beyond the
reference, these raise by name too: later PERIOD blocks of MAW6, LAK6,
SFR6 or MVR6 in a merged model (the reference would rebuild the first
model's features alone), a GWF6-GWF6 exchange of a model with itself, a
mover on the second of several packages of one type, and the UZF6
options SQUARE_GWET and UNSAT_ETAE; a time-series value in the second or
later file of a package type (R7: the reference binds it to an entry of
the first file) and an observation of a boundname given there; TS6
values (R8: the reference leaves them at 0.0), TAS6, OBS6 or NetCDF
export in a merged model.  The reference's loader reads neither the NPF
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
from ...models.gwf.advanced import (AugmentedGwfModel, build_lak, build_maw,
                                    build_sfr)
from ...models.gwf.buy import make_buy
from ...models.gwf.csub import make_csub
from ...models.gwf.exchange import (GwfGwfExchange, _concat_pkg,
                                    merge_gwf_models)
from ...models.gwf.model import PackageData
from ...models.gwf.uzf import make_uzf
from ...models.simulation import Simulation
from ...solution.ims import ImsSettings, NumericalSolution
from ...timing.tdis import StressPeriod, Tdis
from ..obs import ObsGroup, load_obs6
from ..oc import OutputControl, parse_spec
from ..timeseries import bind_array_series, load_tas, load_ts6
from . import advanced_loader as adv_ld
from . import schema
from .arrays import read_grid_array
from .reader import BlockFile

# package types of a GWF name file that the slice covers
_SUPPORTED_PACKAGES = ("DIS6", "DISV6", "DISU6", "IC6", "NPF6", "STO6", "CHD6",
                       "WEL6", "DRN6", "RIV6", "GHB6", "EVT6", "RCH6", "BUY6",
                       "CSUB6", "MAW6", "LAK6", "SFR6", "UZF6", "MVR6", "OC6",
                       "OBS6")
# options of a list package that would change its flows or outputs and are
# not ported (the reference reads past the package's own OBS6 file)
_UNPORTED_LIST_OPTIONS = ("OBS6", "AUXMULTNAME", "AUXDEPTHNAME",
                          "SURF_RATE_SPECIFIED")
# list-package value-column field names per attr (TS6 per-entry binding)
_TS_FIELDS = dict(chd=["head"], wel=["q"], drn=["elev", "cond"],
                  riv=["stage", "cond", "rbot"], ghb=["bhead", "cond"],
                  rch=["recharge"], evt=["surface", "rate", "depth"])
# the package types a mover can name, by kind (gwf-mvr.f90)
_MOVER_KINDS = {"WEL6": "wel", "DRN6": "drn", "RIV6": "riv", "GHB6": "ghb",
                "MAW6": "maw", "LAK6": "lak", "SFR6": "sfr", "UZF6": "uzf"}


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

    Returns (options, dimensions, {kper: [(node, v1, v2, ...)]}, ts_refs,
    {kper: [BOUNDNAME or None]}) where ``ts_refs`` lists (kper, row, col,
    SERIESNAME) for values given as time-series names (utl-ts per-entry
    bindings; the TS6 FILEIN option supplies the series), with 0.0 in the
    entry until the series binds.  Auxiliary columns do not enter the flow
    model and are read past.
    """
    bf = BlockFile(path)
    opts = bf.options()
    if component:
        schema.check_options(component, opts, path)
    _refuse(opts, _UNPORTED_LIST_OPTIONS, path)
    dims = bf.dimensions()
    aux = opts.get("AUXILIARY")
    naux = len(aux) if isinstance(aux, list) else int(bool(aux))
    has_bnames = "BOUNDNAMES" in opts
    periods, bnames, ts_refs = {}, {}, []
    for b in bf.get_all("PERIOD"):
        entries, names = [], []
        for row, toks in enumerate(bf.expand_open_close(b)):
            node, ntok = _cellid_to_node(toks, grid)
            vals = []
            for col in range(ncols):
                t = toks[ntok + col]
                try:
                    vals.append(float(t))
                except ValueError:
                    ts_refs.append((b.index, row, col, t.upper()))
                    vals.append(0.0)
            entries.append((node, *vals))
            at = ntok + ncols + naux
            names.append(toks[at].upper() if has_bnames and len(toks) > at
                         else None)
        periods[b.index] = entries
        bnames[b.index] = names
    return opts, dims, periods, ts_refs, bnames


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
    loader reads it, or given as a TIMEARRAYSERIES of the TAS6 file
    (utl-tas.dfn).  Returns (RchData, TimeArraySeries or None); with a
    series the recharge is 0.0 until the series binds."""
    rch_bf = BlockFile(path)
    ropts = rch_bf.options()
    schema.check_options("gwf-rcha", ropts, path)
    _refuse(ropts, ("OBS6", "AUXMULTNAME"), path)
    blocks = rch_bf.get_all("PERIOD")
    pb = rch_bf.get("PERIOD", 1)
    if pb is None or not pb.lines:
        raise _not_ported(f"{path}: RCHA without a PERIOD 1 block")
    if len(blocks) > 1:
        raise _not_ported(f"{path}: RCHA with more than one PERIOD block")
    head_toks = pb.lines[0]
    if head_toks[0].upper() != "RECHARGE":
        raise _not_ported(f"{path}: RCHA period variable {head_toks[0]}")
    shp2 = shp[1:] if len(shp) > 1 else shp
    tas = None
    if len(head_toks) > 2 and head_toks[1].upper() == "TIMEARRAYSERIES":
        v = ropts.get("TAS6")
        if not (isinstance(v, list) and v[0].upper() == "FILEIN"):
            raise ValueError(f"{path}: TIMEARRAYSERIES without TAS6 FILEIN")
        tas = load_tas(os.path.join(mdir, v[1]), shp2, mdir, device=device)
        rcha = np.zeros(int(np.prod(shp2)))
    else:
        rcha = np.asarray(read_grid_array(rch_bf, "PERIOD", "RECHARGE", shp2,
                                          mdir), np.float64).reshape(-1)
    return bnd.RchData(
        torch.arange(rcha.size, dtype=torch.int64, device=device),
        torch.as_tensor(rcha, dtype=torch.float64, device=device),
        torch.ones(rcha.size, dtype=torch.bool, device=device)), tas


def _load_gwf_model(ws, mfname, mname, device):
    """Load one GWF model nam file + packages → a bundle dict."""
    mnam = BlockFile(os.path.join(ws, mfname))
    mdir = os.path.dirname(os.path.join(ws, mfname))
    mopts = mnam.options()
    schema.check_options("gwf-nam", mopts, mfname)
    _refuse(mopts, ("NETCDF_MESH2D",), mfname)
    # NetCDF export and input records (gwf-nam nc_structured/nc_filerecord)
    nc_out = nc_in = None
    v = mopts.get("NETCDF_STRUCTURED")
    if isinstance(v, list) and v[0].upper() == "FILEOUT":
        nc_out = os.path.join(mdir, v[1])
    v = mopts.get("NETCDF")
    if isinstance(v, list) and v[0].upper() == "FILEIN":
        nc_in = os.path.join(mdir, v[1])
    newton = False
    if "NEWTON" in mopts:
        v = mopts["NEWTON"]
        vals = ([str(x).upper() for x in (v if isinstance(v, list) else [v])]
                if v is not True else [])
        newton = "under_relaxation" if "UNDER_RELAXATION" in vals else True

    pkg_files = {}
    # package name → mover kind, as the reference names them (FTYPE,
    # FTYPE-n, the given name); None for the second and later packages
    # of one type, which the loader merges into one entry list
    pkg_name_kind = {}
    for toks in mnam.get("PACKAGES").lines:
        ftype = toks[0].upper()
        if ftype not in _SUPPORTED_PACKAGES:
            raise _not_ported(f"{mfname}: package {ftype}")
        pkg_files.setdefault(ftype, []).append(os.path.join(mdir, toks[1]))
        if ftype in _MOVER_KINDS:
            n_inst = len(pkg_files[ftype])
            kind = _MOVER_KINDS[ftype] if n_inst == 1 else None
            names = [f"{ftype[:-1]}-{n_inst}"] + (
                [toks[2].upper()] if len(toks) > 2 else [])
            if n_inst == 1:
                names.append(ftype[:-1])
            else:
                pkg_name_kind[ftype[:-1]] = None
            for name in names:
                pkg_name_kind[name] = kind
    for ftype in ("IC6", "NPF6"):
        if ftype not in pkg_files:
            raise ValueError(f"{mfname}: model requires a {ftype} package")

    grid = _load_grid(pkg_files)
    shp = grid.shape
    base = mdir

    ic_bf = BlockFile(pkg_files["IC6"][0])
    strt = read_grid_array(ic_bf, "GRIDDATA", "STRT", shp, base, default=0.0,
                           nc=(nc_in, "ic") if nc_in else None)

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
    nc_npf = (nc_in, "npf") if nc_in else None
    icelltype = read_grid_array(npf_bf, "GRIDDATA", "ICELLTYPE", shp, base,
                                dtype=np.int64, default=0, nc=nc_npf)
    k = read_grid_array(npf_bf, "GRIDDATA", "K", shp, base, default=1.0,
                        nc=nc_npf)
    k22 = read_grid_array(npf_bf, "GRIDDATA", "K22", shp, base, nc=nc_npf)
    k33 = read_grid_array(npf_bf, "GRIDDATA", "K33", shp, base, nc=nc_npf)
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
    rcha = tas = None
    if "RCH6" in pkg_files and \
            "READASARRAYS" in BlockFile(pkg_files["RCH6"][0]).options():
        if len(pkg_files["RCH6"]) > 1:
            raise _not_ported(f"{mfname}: several RCH6 packages with "
                              "READASARRAYS")
        rcha, tas = _load_rcha(pkg_files["RCH6"][0], shp, mdir, device)
        del pkg_files["RCH6"]

    # --- stress packages with period data
    pkg_periods = {}   # attr -> {kper: entries}
    pkg_opts = {}      # attr -> options of the package's (last) file
    ts_bindings = []   # (attr, kper, row, col, TimeSeries)
    bname_rows = {}    # BOUNDNAME -> (PKG, row) for observation IDs
    late_bnames = set()     # boundnames of a type's second or later file
    for ftype, (attr, ncols, _) in _LIST_PACKAGES.items():
        if ftype not in pkg_files:
            continue
        all_periods = {}
        for ifile, path in enumerate(pkg_files[ftype]):
            # several files of one type merge their entries
            if ftype == "EVT6":
                # segmented ET: extra pxdp/petm columns (gwf-evt.dfn NSEG)
                nseg = BlockFile(path).dimensions().get("NSEG", 1)
                ncols = 3 + 2 * (nseg - 1)
            pkg_opts[attr], _, periods, ts_refs, bnames = _load_period_lists(
                path, grid, ncols, component="gwf-" + ftype[:-1].lower())
            for row, name in enumerate(bnames.get(1, [])):
                if name and ifile:
                    late_bnames.add(name)
                elif name:
                    bname_rows[name] = (attr.upper(), row)
            if ts_refs:
                ts_bindings += _ts_bindings(path, pkg_opts[attr], attr,
                                            ts_refs, ifile, mdir)
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

    # --- MAW, LAK and SFR: the augmented model (gwf-maw/lak/sfr.dfn); the
    # PERIOD blocks of later periods wait for _attach_advanced_periods
    def cellid(toks, start):
        return _cellid_to_node(toks, grid, start=start)

    adv, adv_periods = {}, {}
    uzf_entries = movers = None
    for ftype, name in (("MAW6", "maw"), ("LAK6", "lak"), ("SFR6", "sfr"),
                        ("UZF6", "uzf"), ("MVR6", "mvr")):
        if ftype not in pkg_files:
            continue
        if len(pkg_files[ftype]) > 1:
            raise _not_ported(f"{mfname}: several {ftype} packages")
        path = pkg_files[ftype][0]
        if name == "maw":
            adv[name], periods = adv_ld.load_maw(path, grid, cellid)
        elif name == "lak":
            adv[name], periods = adv_ld.load_lak(path, grid, cellid, mdir)
        elif name == "sfr":
            adv[name], periods = adv_ld.load_sfr(path, grid, cellid, mdir)
        elif name == "uzf":
            cols, flags, periods = adv_ld.load_uzf(path, grid)
            uzf_entries = (cols, flags)
        else:
            movers, periods = adv_ld.load_mvr(path, pkg_name_kind)
        for kper, lines in periods.items():
            adv_periods.setdefault(kper, {})[name] = lines
    base_model = model
    if adv or movers:
        model = _augmented(base_model, adv, grid, movers)

    # --- OC output files + period selection
    hds_path = cbc_path = oc = None
    if "OC6" in pkg_files:
        hds_path, cbc_path, oc = load_oc(pkg_files["OC6"][0], mdir)

    # --- OBS6 continuous observations (utl-obs.dfn files)
    obs = None
    if "OBS6" in pkg_files:
        obs = ObsGroup([m for path in pkg_files["OBS6"]
                        for m in load_obs6(path, cellid, mdir,
                                           bname_rows=bname_rows,
                                           late_bnames=late_bnames).managers])

    return dict(name=mname, model=model, base_model=base_model, grid=grid,
                adv_specs=dict(adv, movers=movers, mvr_kinds=pkg_name_kind),
                uzf_entries=uzf_entries, adv_periods=adv_periods,
                storage=storage,
                sto_periods=sto_periods, pkg_periods=pkg_periods,
                maxbound=maxbound, first_pkgs=first_pkgs,
                hds_path=hds_path, cbc_path=cbc_path, oc=oc, tvk=tvk,
                tvs=tvs, ts_bindings=ts_bindings, tas=tas, obs=obs,
                nc_out=nc_out)


def _ts_bindings(path, opts, attr, ts_refs, ifile, mdir):
    """The (attr, kper, row, col, TimeSeries) bindings of a list file's
    values given as series names, from its TS6 FILEIN file."""
    if ifile:
        # R7: the reference binds the file's own row, but the files' entries
        # are merged, so the series would set an entry of the first file
        raise _not_ported(
            f"{path}: a time-series value (TS6) in the second or later "
            f"{attr.upper()}6 file of a model (R7: the reference binds it "
            "to an entry of the first file)")
    v = opts.get("TS6")
    if not (isinstance(v, list) and v[0].upper() == "FILEIN"):
        raise ValueError(f"{path}: time-series value names need a TS6 "
                         "FILEIN option")
    series = load_ts6(os.path.join(mdir, v[1]))
    out = []
    for kper, row, col, name in ts_refs:
        if name not in series:
            raise ValueError(f"{path}: unknown time series {name}")
        if col >= len(_TS_FIELDS[attr]):
            raise _not_ported(f"{path}: a time-series value (TS6) in "
                              f"column {col + 1} of {attr.upper()}6")
        out.append((attr, kper, row, col, series[name]))
    return out


def _augmented(base, specs, grid, movers=None):
    """The augmented model of ``base``, the feature specs and the movers;
    THIEM-type MAW conductances from the base's K11/K22."""
    a = base.npf_arrays
    return AugmentedGwfModel(
        base,
        maw=build_maw(specs["maw"], grid, k11=a.k11, k22=a.k22)
        if specs.get("maw") else None,
        lak=build_lak(*specs["lak"]) if specs.get("lak") else None,
        sfr=build_sfr(specs["sfr"]) if specs.get("sfr") else None,
        mvr=movers)


def _build_uzf(bundle, device):
    """UZF columns from the loaded column arrays (gwf-uzf.f90 node
    geometry: a LANDFLAG column measures from land surface minus surfdep),
    the reference's ``_build_uzf`` as array code."""
    cols, flags = bundle["uzf_entries"]
    grid = bundle["grid"]
    node = cols["node"]
    celtop = np.asarray(grid.top).reshape(-1)[node] - np.where(
        cols["landflag"] != 0, cols["surfdep"], 0.0)
    return make_uzf(dict(
        node=node, vks=cols["vks"], thtr=cols["thtr"], thts=cols["thts"],
        thti=cols["thti"], eps=cols["eps"], celtop=celtop,
        celbot=np.asarray(grid.bot).reshape(-1)[node],
        surfdep=cols["surfdep"],
        area=np.asarray(grid.area).reshape(-1)[node], finf=cols["finf"],
        pet=cols["pet"], extdp=cols["extdp"], extwc=cols["extwc"]),
        device=device, **flags)


def _attach_advanced_periods(simulation, bundle, device):
    """The advanced packages' later PERIOD blocks (the reference's
    loader.py:744-794): at each such period's start the settings are
    applied to the specs, which persist (an MVR6 block replaces the
    movers), and the augmented model is rebuilt on the same base, with
    the same rows; a UZF6 block rebuilds the columns, whose water content
    carries on.  Unlike the reference's rebuild, this one passes K11/K22
    to ``build_maw`` as the first build does, so a THIEM-type well runs;
    like it, the rebuild starts every MAW SHUT_OFF flag open."""
    specs, periods = bundle["adv_specs"], bundle["adv_periods"]
    apply = dict(maw=adv_ld.apply_maw_period,
                 lak=lambda spec, lines: adv_ld.apply_lak_period(*spec,
                                                                 lines),
                 sfr=adv_ld.apply_sfr_period)

    def hook(kper):
        changes = periods.get(kper)
        if not changes:
            return
        for name, lines in changes.items():
            if name == "mvr":
                specs["movers"] = adv_ld.parse_mvr_period(
                    lines, specs["mvr_kinds"])
            elif name == "uzf":
                adv_ld.apply_uzf_period(bundle["uzf_entries"][0], lines)
                simulation.uzf = _build_uzf(bundle, device)
            else:
                apply[name](specs[name], lines)
        if changes.keys() - {"uzf"}:
            simulation.model = _augmented(simulation.model.base, specs,
                                          bundle["grid"], specs["movers"])
            simulation.solution = NumericalSolution(simulation.model,
                                                    simulation.solution.s)

    simulation.period_hooks.append(hook)


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


def load_exchange_gwfgwf(path, grid1, grid2):
    """GWF6-GWF6 exchange file → (pairs, mvr file or None): ``pairs`` maps
    the ``ExchangePair`` fields to arrays (reference exg-gwfgwf.f90 and
    DisConnExchange.f90 exchangedata; the MVR6 FILEIN option is the
    exchange mover, GwfExchangeMover.f90).  Options that would change the
    exchange's flows and that the merged model cannot honour raise by
    name; the reference reads past them."""
    bf = BlockFile(path)
    opts = bf.options()
    schema.check_options("exg-gwfgwf", opts, path)
    _refuse(opts, ("GNC6", "XT3D", "VARIABLECV", "OBS6",
                   "DEV_INTERFACEMODEL_ON"), path)
    if str(opts.get("CELL_AVERAGING", "HARMONIC")).upper() != "HARMONIC":
        raise _not_ported(f"{path}: option CELL_AVERAGING "
                          f"{opts['CELL_AVERAGING']}")
    mvr_path = None
    v = opts.get("MVR6")
    if isinstance(v, list) and v[0].upper() == "FILEIN":
        mvr_path = os.path.join(os.path.dirname(path), v[1])
    aux = opts.get("AUXILIARY")
    aux_names = [str(a).upper() for a in
                 (aux if isinstance(aux, list) else [aux])] if aux else []
    lines = bf.expand_open_close(bf.get("EXCHANGEDATA"))
    n1, nt1 = adv_ld.cellid_nodes(lines, 0, grid1, path)
    n2, nt2 = adv_ld.cellid_nodes(lines, nt1, grid2, path)
    c = nt1 + nt2
    pairs = dict(node1=n1, node2=n2,
                 ihc=adv_ld.record_column(lines, c, path, int),
                 cl1=adv_ld.record_column(lines, c + 1, path),
                 cl2=adv_ld.record_column(lines, c + 2, path),
                 hwva=adv_ld.record_column(lines, c + 3, path),
                 angldegx=(adv_ld.record_column(
                     lines, c + 4 + aux_names.index("ANGLDEGX"), path)
                     if "ANGLDEGX" in aux_names else np.zeros(len(lines))))
    return pairs, mvr_path


def _merge_augmented(bundles, exchanges, exg_mvr_files):
    """Several models with their MAW, LAK and SFR features and movers (the
    reference's ``_merge_augmented``): the union model carries every
    model's feature rows, numbered model after model, so an exchange mover
    is an ordinary mover over the combined feature numbering."""
    base = merge_gwf_models([b["base_model"] for b in bundles], exchanges)
    offsets = base.grid.offsets
    wells, lakes, outlets, reaches = [], [], [], []
    koff = []   # per model: first well, lake, outlet and reach
    for b, off in zip(bundles, offsets):
        specs = b["adv_specs"]
        koff.append(dict(maw=len(wells), lak=len(lakes),
                         lak_out=len(outlets), sfr=len(reaches)))
        for w in specs.get("maw") or []:
            wells.append(dict(w, connections=[(int(n) + off, *rest) for
                                              n, *rest in w["connections"]]))
        if specs.get("lak"):
            lk0 = koff[-1]["lak"]
            for lk in specs["lak"][0]:
                lakes.append(dict(lk, connections=[
                    (int(c[0]) + off, *c[1:]) for c in lk["connections"]]))
            for o in specs["lak"][1]:
                o = dict(o, lake=o["lake"] + lk0)
                if o.get("to", -1) >= 0:
                    o["to"] += lk0
                outlets.append(o)
        r0 = koff[-1]["sfr"]
        for r in specs.get("sfr") or []:
            reaches.append(dict(
                r, node=int(r["node"]) + off,
                upstream=[(u + r0, f) for u, f in r.get("upstream", [])],
                diversions=[dict(d, to=d["to"] + r0)
                            for d in r.get("diversions", [])]))

    def shift(mv, pm, rm):
        pk, rk = mv["provider"], mv["receiver"]
        if pk in ("wel", "drn", "riv", "ghb") and pm != 0:
            raise NotImplementedError(
                "standard-package mover providers outside the first model "
                "of a merged model are not ported (entry offsets are "
                "period-dependent)")
        if pk == "lak":
            mv["iprov"] += koff[pm]["lak_out"]
        elif pk in koff[pm]:
            mv["iprov"] += koff[pm][pk]
        if rk in koff[rm]:
            mv["ircv"] += koff[rm][rk]
        return mv

    movers = []
    for mi, b in enumerate(bundles):
        for mv in b["adv_specs"].get("movers") or []:
            movers.append(shift(dict(mv), mi, mi))
    name_idx = {b["name"].upper(): i for i, b in enumerate(bundles)}

    def kind_of(mname, pname):
        kind = bundles[name_idx[mname]]["adv_specs"]["mvr_kinds"][pname]
        if kind is None:
            raise NotImplementedError(
                f"MVR6: a mover on {pname}, one of several packages of its "
                "type, is not ported")
        return kind

    for path in exg_mvr_files:
        for mv in adv_ld.load_exchange_mvr(path, kind_of):
            pm = name_idx[mv.pop("prov_model")]
            rm = name_idx[mv.pop("recv_model")]
            movers.append(shift(mv, pm, rm))
    return _augmented(base, dict(maw=wells, lak=(lakes, outlets)
                                 if lakes else None, sfr=reaches),
                      base.grid, movers or None)


def _merge_period_data(simulation, bundles, offsets, device):
    """Several models: each model's period data with MF6 persistence,
    concatenated with node indices shifted into the merged numbering (the
    reference's ``_merge_period_data``)."""
    all_kpers = sorted({kp for b in bundles
                        for periods in b["pkg_periods"].values()
                        for kp in periods})
    mkmap = {a: f for a, _, f in _LIST_PACKAGES.values()}
    current = [dict(b["first_pkgs"]) for b in bundles]
    for kper in all_kpers:
        for mi, b in enumerate(bundles):
            for attr, periods in b["pkg_periods"].items():
                if kper in periods:
                    current[mi][attr] = mkmap[attr](
                        periods[kper], maxbound=b["maxbound"][attr],
                        device=device)
        merged = {}
        for attr in mkmap:
            datas = [cur.get(attr) for cur in current]
            live = [d for d in datas if d is not None]
            if live:
                merged[attr] = _concat_pkg(type(live[0]), datas, offsets)
        simulation.period_data[kper] = PackageData(**merged)


def load_simulation(workspace, hds_path=None, cbc_path=None, lst_path=None,
                    device=None):
    """Load mfsim.nam and everything it references → Simulation.

    Supported: GWF6 models, one or several joined by GWF6-GWF6 exchanges,
    with one IMS solution (see the module docstring).  ``device=None``
    puts the model on the CUDA device and raises when there is none; pass
    ``"cpu"`` to run on the CPU.
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
    names = [mname for _, mname in entries]
    exchange_entries = []
    exg_blk = sim.get("EXCHANGES")
    for toks in (exg_blk.lines if exg_blk is not None else []):
        etype, m1, m2 = toks[0].upper(), toks[2].upper(), toks[3].upper()
        if etype != "GWF6-GWF6":
            raise _not_ported(f"mfsim.nam: exchange {etype}")
        if m1 == m2:
            raise _not_ported(f"mfsim.nam: exchange GWF6-GWF6 of model {m1} "
                              "with itself")
        for m in (m1, m2):
            if m not in names:
                raise ValueError(f"mfsim.nam: exchange names model {m}, "
                                 "which MODELS does not list")
        exchange_entries.append((toks[1], names.index(m1), names.index(m2)))
    if len(entries) > 1 and not exchange_entries:
        raise _not_ported("mfsim.nam: more than one model without a "
                          "GWF6-GWF6 exchange (separate solutions)")

    # solution groups → the model's IMS settings
    settings = None
    for sg in sim.get_all("SOLUTIONGROUP"):
        for toks in sg.lines:
            if toks[0].upper() == "IMS6" and settings is None:
                settings = load_ims(os.path.join(ws, toks[1]))
    if settings is None:
        settings = ImsSettings()

    bundles = [_load_gwf_model(ws, mfname, mname, device)
               for mfname, mname in entries]
    if len(bundles) == 1:
        bundle = bundles[0]
        model = bundle["model"]
    else:
        model = _merged_model(ws, bundles, exchange_entries)
        bundle = bundles[0]
    # SFR routing, the LAK cascade and Newton Jacobians are asymmetric: CG
    # diverges there (the reference program requires BICGSTAB for
    # asymmetric systems); upgrade with a warning
    if any(b["base_model"].inewton or b["adv_specs"].get("sfr")
           or b["adv_specs"].get("lak") for b in bundles) \
            and settings.linear_acceleration == "cg":
        warnings.warn("deck requests CG but the system is asymmetric "
                      "(SFR/LAK/Newton); using BICGSTAB", stacklevel=2)
        settings = dataclasses.replace(settings,
                                       linear_acceleration="bicgstab")
    transient = _transient_flags(tdis, bundle["storage"],
                                 bundle["sto_periods"])
    simulation = Simulation(
        tdis, model, settings, transient=transient,
        hds_path=hds_path or bundle["hds_path"],
        cbc_path=cbc_path or bundle["cbc_path"],
        lst_path=lst_path, oc=bundle["oc"], obs=bundle["obs"],
        nc_path=bundle["nc_out"])
    # reference failure semantics: abort on nonconvergence unless the
    # simulation CONTINUE option is set (sim-nam continue keyword)
    simulation.fail_fast = "CONTINUE" not in sopts
    if len(bundles) > 1:
        _merge_period_data(simulation, bundles, model.grid.offsets, device)
        return simulation
    simulation.tvk = bundle["tvk"]
    simulation.tvs = bundle["tvs"]
    if bundle["tas"] is not None:
        _attach_tas(simulation, bundle["tas"])
    if bundle["uzf_entries"] is not None:
        simulation.uzf = _build_uzf(bundle, device)
    if bundle["adv_periods"]:
        _attach_advanced_periods(simulation, bundle, device)
    if bundle["ts_bindings"]:
        _attach_ts_bindings(simulation, bundle)
    _attach_period_data(simulation, bundle["pkg_periods"],
                        bundle["maxbound"], bundle["first_pkgs"], device)
    return simulation


def _attach_tas(simulation, tas):
    """RCHA driven by a time-array series (TasManager ad role): before
    every solve attempt and step snapshot the recharge array is the
    series' step average, in the model's and every period's package data
    (the reference's loader.py:1603-1627); the entries, and so their sum
    plan, stay the same."""
    def set_rch(arr):
        base = getattr(simulation.model, "base", simulation.model)
        base.rch = bnd.with_values(base.rch, recharge=arr)
        for k, pd in simulation.period_data.items():
            simulation.period_data[k] = dataclasses.replace(pd, rch=base.rch)

    bind_array_series(simulation, tas, set_rch)


def _attach_ts_bindings(simulation, bundle):
    """Per-step TS6 value refresh (TsManager ad role, the reference's
    ``_attach_ts_bindings``): entries whose deck value was a series NAME
    get the step-averaged series value before every solve attempt and
    step snapshot, in the period data from the binding's period up to the
    package's next PERIOD block.  A step evaluates each series once and
    writes each (package, field) with one host-to-device copy and one
    indexed store at distinct rows; the entries stay the same tensors, so
    the package's sum plan carries over."""
    pkg_periods = bundle["pkg_periods"]
    # attr -> bkper -> field -> ([rows], [series]); a binding holds from
    # its period up to the package's next PERIOD block
    groups = {}
    for attr, bkper, row, col, series in bundle["ts_bindings"]:
        rows, sers = groups.setdefault(attr, {}).setdefault(
            bkper, {}).setdefault(_TS_FIELDS[attr][col], ([], []))
        rows.append(row)
        sers.append(series)
    rows_on_device = {}

    def hook(kper, kstp, delt):
        t0 = simulation.records[-1].totim if simulation.records else 0.0
        values = {}     # id(series) -> the step's value

        def value(series):
            if id(series) not in values:
                values[id(series)] = series.step_value(t0, t0 + delt)
            return values[id(series)]

        for attr, by_period in groups.items():
            bkper = max((k for k in pkg_periods[attr] if k <= kper),
                        default=None)
            if bkper not in by_period:
                continue
            pd = simulation.period_data[bkper]
            old = getattr(pd, attr)
            fields = {}
            for field, (rows, sers) in by_period[bkper].items():
                vals = [value(s) for s in sers]
                key = (attr, bkper, field)
                if key not in rows_on_device:
                    rows_on_device[key] = torch.as_tensor(
                        rows, dtype=torch.int64, device=old.node.device)
                arr = getattr(old, field).clone()
                arr[rows_on_device[key]] = torch.tensor(
                    vals, dtype=torch.float64).to(arr.device)
                fields[field] = arr
            new = bnd.with_values(old, **fields)
            for k, pd_k in simulation.period_data.items():
                if getattr(pd_k, attr) is old:
                    simulation.period_data[k] = dataclasses.replace(
                        pd_k, **{attr: new})

    simulation.step_hooks.append(hook)


def _merged_model(ws, bundles, exchange_entries):
    """Several loaded models and their GWF6-GWF6 exchanges → one merged
    model (an augmented one when a model has features or movers, or an
    exchange has an MVR6 file).  What the reference refuses raises by
    name, and so do later PERIOD blocks of the features, the movers and
    UZF, which the reference would apply to the first model alone."""
    for b in bundles:
        if b["ts_bindings"]:
            # R8: the reference binds the series of one model only; the
            # named values of a merged model stay at the 0.0 placeholder
            raise _not_ported(
                f"{b['name']}: time-series values (TS6) in a merged "
                "(multi-model) simulation (R8: the reference leaves them "
                "at 0.0)")
        for key, what in (("tas", "TIMEARRAYSERIES (TAS6)"),
                          ("obs", "OBS6"), ("nc_out", "NETCDF_STRUCTURED")):
            if b[key] is not None:
                raise _not_ported(f"{b['name']}: {what} in a merged "
                                  "(multi-model) simulation")
        if b["uzf_entries"] is not None:
            raise _not_ported("UZF in a merged (multi-model) simulation")
        if b["base_model"].csub is not None:
            raise _not_ported("CSUB in a merged (multi-model) simulation")
        if b["tvk"] or b["tvs"]:
            raise _not_ported("TVK/TVS with several models")
        if b["adv_periods"]:
            late = sorted({name.upper() for changes in
                           b["adv_periods"].values() for name in changes})
            raise _not_ported(
                f"{b['name']}: later PERIOD blocks of {', '.join(late)} in "
                "a merged (multi-model) simulation")
    exchanges, exg_mvr_files = [], []
    for efile, i1, i2 in exchange_entries:
        pairs, mvr_path = load_exchange_gwfgwf(
            os.path.join(ws, efile), bundles[i1]["grid"],
            bundles[i2]["grid"])
        exchanges.append(GwfGwfExchange(i1, i2, pairs))
        if mvr_path:
            exg_mvr_files.append(mvr_path)
    if exg_mvr_files or any(
            b["adv_specs"].get(k) for b in bundles
            for k in ("maw", "lak", "sfr", "movers")):
        return _merge_augmented(bundles, exchanges, exg_mvr_files)
    return merge_gwf_models([b["model"] for b in bundles], exchanges)
