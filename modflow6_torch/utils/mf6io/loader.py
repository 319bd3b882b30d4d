"""Load an MF6 simulation from an mfsim.nam workspace.

Port of the parts of modflow6_tpu/utils/mf6io/loader.py that the ported
GWF slices need (reference IDM load + SimulationCreate,
src/Utilities/Idm/IdmLoad.f90, src/SimulationCreate.f90:200-729):
``load_tdis``, ``load_ims``, ``load_dis``, ``load_disv``, ``load_disu``,
``load_oc``, the list-package reader, ``load_exchange_gwfgwf``, the GWF
GWT and GWE model loaders and ``load_simulation`` for one GWF6 model, or
several joined by GWF6-GWF6 exchanges (merged into one model, with the
exchanges' MVR6 movers), or one GWF6 model and one GWT6 or GWE6 model
joined by a GWF6-GWT6 or GWF6-GWE6 exchange (whose file, as in the
reference, is not read), each
with the IMS that its solution group names it in and the group's MXITER,
on DIS, DISV or DISU grids, with the
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
order 4 with a warning).  A GWT6 model reads DIS6/DISV6/DISU6, IC6,
ADV6 (SCHEME), DSP6 (with XT3D_OFF), MST6 (decay, and linear, Freundlich
or Langmuir sorption: R10 in ROADMAP Queue C), SSM6 (AUX sources, from
the flow list package's period-1 auxiliary column), CNC6 and SRC6 (period
1), OC6 (its CONCENTRATION file) and the APT files LKT6, SFT6, MWT6 and
UZT6 (``advanced_loader.load_apt``: the features' starting concentrations
and one source concentration each; an ``AugmentedGwtModel`` over the
augmented flow model, the UZT rows over its UZF columns); MVT6 needs no
input (the flow model's movers carry mass into the features' rows, and
the reference has no branch for it).  A GWE6 model reads DIS6/DISV6/DISU6,
IC6, ADV6, EST6 (with ZERO_ORDER_DECAY_WATER/SOLID), CND6 (with XT3D_OFF),
SSM6, CTP6 and ESL6 (period 1), OC6 (its TEMPERATURE file) and LKE6, SFE6,
MWE6, UZE6 (MVE6 as MVT6).

Everything else a deck can ask for raises ``NotImplementedError`` naming
the package or keyword: other model types and exchange types, several
models with no exchange, XT3D (which the reference's loader reads past,
running the two-point scheme), HFB6, in a GWT6 model: later PERIOD blocks
of CNC6 or SRC6, SSM aux values that change after period 1, SSM srctype
AUXMIXED (run as AUX there), IST6 (which it has no branch for), ADV6
ATS_PERCEL, DSP6 without XT3D_OFF and MST6 DECAY_SORBED (all read past or
run another way there); in an APT file TS6, OBS6 and
FLOW_PACKAGE_AUXILIARY_NAME, a STATUS other than ACTIVE, CONCENTRATION or
TEMPERATURE settings, two different source values of one feature (the
reference keeps the last) and a nonzero KTF of LKE6/SFE6/MWE6; in a GWE6
model GWT package types, a nonzero LATENT_HEAT_VAPORIZATION, CND6 without
XT3D_OFF, later PERIOD blocks of CTP6 or ESL6, BUY6 or VSC6 beside it;
APT files beside later PERIOD blocks of the flow model's features;
ATS6 in TDIS (read past there too: adaptive steps reach a ``Simulation``
only through ``Simulation.ats``),
NETCDF_MESH2D and a list package's own OBS6 option (both read past
there), TS6 values in MAW6, LAK6 and SFR6, an HPC6 record without
FILEIN and an option in the HPC6 file; and where the
reference refuses: several GWT6 or GWE6 models, GWT6 or GWE6 beside
several GWF6 models, an APT file beside a flow model without its feature
or, for UZT6/UZE6, without UZF6 (``ValueError``), UZF or CSUB in a
merged model,
TVK/TVS with several models, standard-package mover providers outside the
first model, later PERIOD blocks of an exchange's MVR6.  Beyond the
reference, these raise by name too: GWT6 or GWE6 beside UZF6 without
UZT6 (the reference's FMI drops the UZF flows), later PERIOD blocks of
MAW6, LAK6,
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
from .reader import (BlockFile, split_records, tokenize_line,
                     uniform_table)

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


def _load_hpc(ws, sopts):
    """mfsim.nam's HPC6 FILEIN record → {MODEL: rank} of its PARTITIONS
    block (utl-hpc.dfn; the reference's explicit model → rank load
    balance, DistributedSim.f90), or None without one."""
    v = sopts.get("HPC6")
    if v is None:
        return None
    if not (isinstance(v, list) and len(v) == 2
            and v[0].upper() == "FILEIN"):
        raise _not_ported("mfsim.nam: HPC6 without FILEIN <file>")
    hbf = BlockFile(os.path.join(ws, v[1]))
    for key in hbf.options():
        raise _not_ported(f"{v[1]}: option {key}")
    pb = hbf.get("PARTITIONS")
    if pb is None:
        return None
    return {t[0].upper(): int(t[1]) for t in pb.lines}


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
    verts = vertices_block(bf.get("VERTICES"), nvert)
    rings = cell2d_block(bf.get("CELL2D"), ncpl)
    top = read_grid_array(bf, "GRIDDATA", "TOP", (ncpl,), base)
    botm = read_grid_array(bf, "GRIDDATA", "BOTM", (nlay, ncpl), base)
    idomain = read_grid_array(bf, "GRIDDATA", "IDOMAIN", (nlay, ncpl),
                              base, dtype=np.int64, default=1)
    return DisvGrid.from_arrays(nlay, verts, *rings, top, botm, idomain)


def vertices_block(block, nvert):
    """VERTICES records (iv, x, y) → f64[nvert, 2].  Uniform records with
    distinct ids are read as columns; other blocks record by record, the
    later record of an id winning."""
    verts = np.zeros((nvert, 2))
    table = uniform_table(block.raw)
    if table is not None and table[1] >= 3:
        toks, w = table
        try:
            iv = np.array(list(map(int, toks[0::w])), np.int64) - 1
            x = list(map(float, toks[1::w]))
            y = list(map(float, toks[2::w]))
        except ValueError:
            iv = None
        if iv is not None and np.unique(iv).size == iv.size:
            verts[iv, 0] = x
            verts[iv, 1] = y
            return verts
    for toks in block.lines:
        verts[int(toks[0]) - 1] = (float(toks[1]), float(toks[2]))
    return verts


def cell2d_block(block, ncpl, first_vertex=4):
    """CELL2D records (icell, xc, yc, ncvert, vertex ids...) → (xc, yc,
    iavert, javert) of ``DisvGrid.from_arrays``: each cell's open ring,
    0-based, without the closing duplicate MF6 may list.  Cells listed
    once each in any order are read as arrays, grouped by vertex count;
    other blocks record by record."""
    got = _cell2d_arrays(block.raw, ncpl, first_vertex)
    if got is not None:
        return got
    cell2d = [None] * ncpl
    for toks in block.lines:
        ncvert = int(toks[first_vertex - 1])
        ivs = [int(t) - 1 for t in toks[first_vertex:first_vertex + ncvert]]
        # MF6 lists cell vertices clockwise with an optional closing
        # duplicate; DisvGrid wants an open ring
        if len(ivs) > 1 and ivs[0] == ivs[-1]:
            ivs = ivs[:-1]
        cell2d[int(toks[0]) - 1] = (float(toks[1]), float(toks[2]), ivs)
    xc = np.array([c[0] for c in cell2d], np.float64)
    yc = np.array([c[1] for c in cell2d], np.float64)
    rings = [np.asarray(c[2], np.int64) for c in cell2d]
    iavert = np.zeros(ncpl + 1, np.int64)
    iavert[1:] = np.cumsum([r.size for r in rings])
    javert = (np.concatenate(rings) if rings else np.zeros(0, np.int64))
    return xc, yc, iavert, javert


def _cell2d_arrays(raw, ncpl, first):
    table = uniform_table(raw)
    if table is not None and table[1] >= first:
        toks, w = table
        try:
            ncv = np.array(list(map(int, toks[first - 1::w])), np.int64)
        except ValueError:
            return None
        if (ncv == ncv[0]).all() and first + ncv[0] == w and ncv[0] >= 1:
            return _uniform_cell2d(toks, w, ncpl, first)
    split = split_records(raw)
    if split is None or len(raw) != ncpl:
        return None
    toks, counts = split
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    if (counts < first).any():
        return None
    tok = np.array(toks, dtype=object)
    try:
        icell = np.array(list(map(int, tok[start])), np.int64) - 1
        xc = np.array(list(map(float, tok[start + 1])), np.float64)
        yc = np.array(list(map(float, tok[start + 2])), np.float64)
        ncv = np.array(list(map(int, tok[start + first - 1])), np.int64)
    except ValueError:
        return None
    if (ncv < 1).any() or (counts < first + ncv).any() or not np.array_equal(
            np.sort(icell), np.arange(ncpl)):
        return None
    pos = (np.repeat(start + first - np.cumsum(ncv) + ncv, ncv)
           + np.arange(int(ncv.sum())))
    try:
        ivs = np.array(list(map(int, tok[pos])), np.int64) - 1
    except ValueError:
        return None
    # drop the closing duplicate of a ring that repeats its first vertex
    first_pos = np.cumsum(ncv) - ncv
    closed = (ncv > 1) & (ivs[first_pos] == ivs[np.maximum(
        first_pos + ncv - 1, 0)])
    keep = np.ones(ivs.size, bool)
    keep[(first_pos + ncv - 1)[closed]] = False
    nv = ncv - closed
    # rings in cell order
    order = np.argsort(icell, kind="stable")
    ring_cell = np.repeat(icell, nv)
    ivs = ivs[keep]
    javert = ivs[np.argsort(ring_cell, kind="stable")]
    iavert = np.zeros(ncpl + 1, np.int64)
    iavert[1:] = np.cumsum(nv[order])
    return xc[order], yc[order], iavert, javert


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
    # a transport model's CONCENTRATION or TEMPERATURE file, or an SWF
    # model's STAGE file, takes the place of HEAD's (tsp-oc, swf-oc)
    return (_fileout("HEAD") or _fileout("CONCENTRATION")
            or _fileout("TEMPERATURE") or _fileout("STAGE"),
            _fileout("BUDGET"), oc)


def _cellid_to_node(toks, grid, start=0):
    """Parse a cellid (1-based: layer row column, layer cell, or node) →
    0-based node; returns (node, ntok)."""
    if isinstance(grid, DisGrid):
        # grid.node_number's arithmetic on Python ints (a numpy call per
        # row was a third of a million-row list's parse)
        k, i, j = (int(toks[start]) - 1, int(toks[start + 1]) - 1,
                   int(toks[start + 2]) - 1)
        return (k * grid.nrow + i) * grid.ncol + j, 3
    if isinstance(grid, DisvGrid):
        k, c = int(toks[start]) - 1, int(toks[start + 1]) - 1
        return k * grid.ncpl + c, 2
    return int(toks[start]) - 1, 1


def _cellid_width(grid) -> int:
    return 3 if isinstance(grid, DisGrid) else (
        2 if isinstance(grid, DisvGrid) else 1)


def _list_columns(records, grid, ncols, aux_names, has_bnames):
    """A list block whose records all have the same number of tokens, read
    as columns: (entries, names, aux values) as ``list_rows`` gives them,
    or None for a block that ``list_rows`` must read (records of differing
    widths, quotes, a time-series name or too few columns).  The values go
    through Python's ``int`` and ``float``, as there."""
    table = uniform_table(records)
    if table is None:
        return None
    toks, w = table
    nt = _cellid_width(grid)
    naux = len(aux_names)
    if w < nt + ncols + naux:
        return None
    try:
        cid = [np.array(list(map(int, toks[j::w])), np.int64) - 1
               for j in range(nt)]
        vals = [list(map(float, toks[nt + c::w])) for c in range(ncols)]
        aux = {a: list(map(float, toks[nt + ncols + ia::w]))
               for ia, a in enumerate(aux_names)}
    except ValueError:
        return None
    if nt == 3:
        node = (cid[0] * grid.nrow + cid[1]) * grid.ncol + cid[2]
    elif nt == 2:
        node = cid[0] * grid.ncpl + cid[1]
    else:
        node = cid[0]
    at = nt + ncols + naux
    n = len(records)
    names = ([t.upper() for t in toks[at::w]] if has_bnames and w > at
             else [None] * n)
    return list(zip(node.tolist(), *vals)), names, aux


def _uniform_cell2d(toks, w, ncpl, first):
    """``_cell2d_arrays`` for records that all list ``w - first`` vertices
    and nothing after them: the columns are slices of the token list."""
    try:
        icell = np.array(list(map(int, toks[0::w])), np.int64) - 1
        xc = np.array(list(map(float, toks[1::w])), np.float64)
        yc = np.array(list(map(float, toks[2::w])), np.float64)
        ivs = np.stack([np.array(list(map(int, toks[j::w])), np.int64) - 1
                        for j in range(first, w)], axis=1)
    except ValueError:
        return None
    if icell.size != ncpl or not np.array_equal(np.sort(icell),
                                                np.arange(ncpl)):
        return None
    nv = np.full(ncpl, w - first, np.int64)
    closed = (w - first > 1) & (ivs[:, 0] == ivs[:, -1])
    nv -= closed
    keep = np.ones(ivs.shape, bool)
    keep[closed, -1] = False
    order = np.argsort(icell, kind="stable")
    javert = ivs[order][keep[order]]
    iavert = np.zeros(ncpl + 1, np.int64)
    iavert[1:] = np.cumsum(nv[order])
    return xc[order], yc[order], iavert, javert


def list_rows(records, grid, ncols, aux_names, has_bnames):
    """A list block's records one by one: (entries, names, aux values,
    series references (row, col, NAME)); a value that is no number is a
    time-series name, 0.0 until the series binds."""
    naux = len(aux_names)
    entries, names, refs = [], [], []
    auxvals = {a: [] for a in aux_names}
    for row, toks in enumerate(map(tokenize_line, records)):
        node, ntok = _cellid_to_node(toks, grid)
        vals = []
        for col in range(ncols):
            t = toks[ntok + col]
            try:
                vals.append(float(t))
            except ValueError:
                refs.append((row, col, t.upper()))
                vals.append(0.0)
        entries.append((node, *vals))
        for ia, a in enumerate(aux_names):
            auxvals[a].append(float(toks[ntok + ncols + ia]))
        at = ntok + ncols + naux
        names.append(toks[at].upper() if has_bnames and len(toks) > at
                     else None)
    return entries, names, auxvals, refs


def _load_period_lists(path, grid, ncols, component=None):
    """Read a list-based stress package file.

    Returns (options, dimensions, {kper: [(node, v1, v2, ...)]}, ts_refs,
    {kper: [BOUNDNAME or None]}, {kper: {AUXNAME: [values]}}) where
    ``ts_refs`` lists (kper, row, col, SERIESNAME) for values given as
    time-series names (utl-ts per-entry bindings; the TS6 FILEIN option
    supplies the series), with 0.0 in the entry until the series binds.
    The auxiliary columns do not enter the flow model; SSM reads them (the
    reference's ``pkg_aux`` form).
    """
    bf = BlockFile(path)
    opts = bf.options()
    if component:
        schema.check_options(component, opts, path)
    _refuse(opts, _UNPORTED_LIST_OPTIONS, path)
    dims = bf.dimensions()
    aux = opts.get("AUXILIARY")
    aux_names = [str(a).upper() for a in
                 (aux if isinstance(aux, list) else [aux] if aux else [])]
    has_bnames = "BOUNDNAMES" in opts
    periods, bnames, ts_refs, aux_periods = {}, {}, [], {}
    for b in bf.get_all("PERIOD"):
        records = bf.records(b)
        got = _list_columns(records, grid, ncols, aux_names, has_bnames)
        if got is None:
            *got, refs = list_rows(records, grid, ncols, aux_names,
                                   has_bnames)
            ts_refs.extend((b.index, *ref) for ref in refs)
        periods[b.index], bnames[b.index], aux_periods[b.index] = got
    return opts, dims, periods, ts_refs, bnames, aux_periods


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
    pkg_aux = {}       # attr -> {kper: {AUXNAME: [values]}}
    pkg_opts = {}      # attr -> options of the package's (last) file
    ts_bindings = []   # (attr, kper, row, col, TimeSeries)
    bname_rows = {}    # BOUNDNAME -> (PKG, row) for observation IDs
    late_bnames = set()     # boundnames of a type's second or later file
    for ftype, (attr, ncols, _) in _LIST_PACKAGES.items():
        if ftype not in pkg_files:
            continue
        all_periods, all_aux = {}, {}
        for ifile, path in enumerate(pkg_files[ftype]):
            # several files of one type merge their entries
            if ftype == "EVT6":
                # segmented ET: extra pxdp/petm columns (gwf-evt.dfn NSEG)
                nseg = BlockFile(path).dimensions().get("NSEG", 1)
                ncols = 3 + 2 * (nseg - 1)
            pkg_opts[attr], _, periods, ts_refs, bnames, auxp = \
                _load_period_lists(path, grid, ncols,
                                   component="gwf-" + ftype[:-1].lower())
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
            for kper, av in auxp.items():
                tgt = all_aux.setdefault(kper, {})
                for a, vals in av.items():
                    tgt.setdefault(a, []).extend(vals)
        pkg_periods[attr] = all_periods
        pkg_aux[attr] = all_aux

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
                pkg_aux=pkg_aux, maxbound=maxbound, first_pkgs=first_pkgs,
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


# package types of a GWT and of a GWE name file that the port covers; the
# movers' transport (MVT6, MVE6) needs no input of its own: the movers of
# the flow model carry mass whenever a transport model has APT rows, and
# the reference's loader has no branch for those files either
_GWT_PACKAGES = ("DIS6", "DISV6", "DISU6", "IC6", "ADV6", "DSP6", "MST6",
                 "SSM6", "CNC6", "SRC6", "OC6", "LKT6", "SFT6", "MWT6",
                 "UZT6", "MVT6")
_GWE_PACKAGES = ("DIS6", "DISV6", "DISU6", "IC6", "ADV6", "CND6", "EST6",
                 "SSM6", "CTP6", "ESL6", "OC6", "LKE6", "SFE6", "MWE6",
                 "UZE6", "MVE6")
# the name of each GWT package type outside the port, for its refusal
_GWT_UNPORTED = {"IST6": "IST6 (the immobile domain reaches a model only "
                         "through build_gwt(ist=...), as in the reference)"}
# the APT files of each model type: file type → (feature, component)
_APT_FILES = {"GWT6": {"LKT6": ("lak", "gwt-lkt"), "SFT6": ("sfr", "gwt-sft"),
                       "MWT6": ("maw", "gwt-mwt"), "UZT6": ("uzf", "gwt-uzt")},
              "GWE6": {"LKE6": ("lak", "gwe-lke"), "SFE6": ("sfr", "gwe-sfe"),
                       "MWE6": ("maw", "gwe-mwe"), "UZE6": ("uzf", "gwe-uze")}}
_SORPTION = {"LINEAR": 1, "FREUNDLICH": 2, "LANGMUIR": 3}


def _first_period_entries(path, grid, what):
    """The PERIOD 1 entries of a CNC6, SRC6, CTP6 or ESL6 file; a later
    PERIOD block raises (the reference uses period 1 only)."""
    _, _, periods, ts_refs, _, _ = _load_period_lists(path, grid, 1)
    late = sorted(k for k in periods if k != 1)
    if late:
        raise _not_ported(f"{path}: PERIOD {late[0]} of {what} (the "
                          "reference applies the PERIOD 1 block only)")
    if ts_refs:
        raise _not_ported(f"{path}: time-series values (TS6) in {what}")
    return periods.get(1, [])


def _transport_files(ws, mfname, mtype):
    """{file type: path} of a GWT or GWE name file; package types outside
    the port, or of the other transport model, raise by name."""
    mnam = BlockFile(os.path.join(ws, mfname))
    mdir = os.path.dirname(os.path.join(ws, mfname))
    known = _GWT_PACKAGES if mtype == "GWT6" else _GWE_PACKAGES
    pkg_files = {}
    for toks in mnam.get("PACKAGES").lines:
        ftype = toks[0].upper()
        if mtype == "GWT6" and ftype in _GWT_UNPORTED:
            raise _not_ported(f"{mfname}: package {_GWT_UNPORTED[ftype]}")
        if mtype == "GWE6" and (ftype in _GWT_UNPORTED or (
                ftype in _GWT_PACKAGES and ftype not in _GWE_PACKAGES)):
            # the reference's GWE loader reads past them
            raise _not_ported(f"{mfname}: package {ftype} in a GWE6 model "
                              "(a GWT package)")
        if ftype not in known:
            raise _not_ported(f"{mfname}: package {ftype}")
        if ftype in pkg_files:
            raise _not_ported(f"{mfname}: several {ftype} packages")
        pkg_files[ftype] = os.path.join(mdir, toks[1])
    if "IC6" not in pkg_files:
        raise ValueError(f"{mfname}: model requires an IC6 package")
    return mnam, mdir, pkg_files


def _adv_scheme(pkg_files, component):
    """ADV6's SCHEME (the reference reads SCHEME alone: ATS_PERCEL
    raises)."""
    if "ADV6" not in pkg_files:
        return "upstream"
    path = pkg_files["ADV6"]
    aopts = BlockFile(path).options()
    schema.check_options(component, aopts, path)
    _refuse(aopts, ("ATS_PERCEL",), path)
    if "SCHEME" in aopts:
        schema.check_valid_value(component, "options", "SCHEME",
                                 aopts["SCHEME"], path)
    return str(aopts.get("SCHEME", "upstream")).lower()


def _xt3d_off(path, opts, what):
    """The reference computes DSP's and CND's two-point form whatever the
    options say; MODFLOW 6 runs XT3D unless XT3D_OFF is given."""
    if "XT3D_OFF" not in opts:
        raise _not_ported(
            f"{path}: {what} without XT3D_OFF (its XT3D form; the "
            "reference computes the two-point form)")
    _refuse(opts, ("XT3D_RHS",), path)


def _ssm_sources(pkg_files):
    """SSM6's SOURCES records → [(pname, auxname)] (srctype AUX)."""
    if "SSM6" not in pkg_files:
        return []
    path = pkg_files["SSM6"]
    ssm_bf = BlockFile(path)
    if ssm_bf.get("FILEINPUT") is not None:
        raise _not_ported(f"{path}: FILEINPUT (SPC6 files)")
    out = []
    b = ssm_bf.get("SOURCES")
    for toks in (b.lines if b is not None else []):
        srctype = toks[1].upper()
        if srctype == "AUXMIXED":
            raise _not_ported(f"{path}: SSM srctype AUXMIXED (the "
                              "reference runs it as AUX)")
        if srctype != "AUX":
            raise _not_ported(f"{path}: SSM srctype {srctype}")
        out.append((toks[0].upper(), toks[2].upper()))
    return out


def _apt_specs(pkg_files, mtype):
    """{feature: load_apt's dict} of the model's APT files."""
    return {kind: dict(adv_ld.load_apt(pkg_files[ftype], component),
                       ftype=ftype)
            for ftype, (kind, component) in _APT_FILES[mtype].items()
            if ftype in pkg_files}


def _load_gwt_model(ws, mfname, mname, device):
    """One GWT model's name file and packages (IC, ADV, DSP, MST, SSM, CNC,
    SRC, OC, and the APT files LKT, SFT, MWT, UZT) → a bundle dict (the
    reference's _load_gwt_model, loader.py:1010-1116).  SSM's sources and
    the APT rows are resolved against the flow model in
    ``load_simulation``."""
    from ...models.gwt import builder as gwt_builder

    _, mdir, pkg_files = _transport_files(ws, mfname, "GWT6")
    grid = _load_grid({k: [v] for k, v in pkg_files.items()})
    shp = grid.shape

    strt = read_grid_array(BlockFile(pkg_files["IC6"]), "GRIDDATA", "STRT",
                           shp, mdir, default=0.0)
    scheme = _adv_scheme(pkg_files, "gwt-adv")

    dsp = None
    if "DSP6" in pkg_files:
        path = pkg_files["DSP6"]
        dsp_bf = BlockFile(path)
        _xt3d_off(path, dsp_bf.options(), "DSP6")
        dsp = {}
        for key in ("ALH", "ALV", "ATH1", "ATH2", "ATV", "DIFFC"):
            arr = read_grid_array(dsp_bf, "GRIDDATA", key, shp, mdir)
            if arr is not None:
                dsp[key.lower()] = arr.reshape(-1)

    porosity, decay, sorption = 0.3, None, None
    if "MST6" in pkg_files:
        path = pkg_files["MST6"]
        mst_bf = BlockFile(path)
        mopts = mst_bf.options()
        schema.check_options("gwt-mst", mopts, path)
        schema.check_griddata("gwt-mst", mst_bf, path)
        gd = mst_bf.get("GRIDDATA")
        if "DECAY_SORBED" in schema.griddata_names(
                gd.lines if gd is not None else []):
            # the reference decays the sorbed phase at DECAY
            raise _not_ported(f"{path}: griddata DECAY_SORBED")
        porosity = read_grid_array(mst_bf, "GRIDDATA", "POROSITY", shp, mdir,
                                   default=0.3).reshape(-1)
        decay_arr = read_grid_array(mst_bf, "GRIDDATA", "DECAY", shp, mdir)
        if decay_arr is not None:
            decay = (2 if "ZERO_ORDER_DECAY" in mopts else 1,
                     decay_arr.reshape(-1))
        sorb = mopts.get("SORPTION")
        if sorb:
            # R10: the reference's loader names constants that its mst
            # module lacks, so any SORPTION option fails there
            schema.check_valid_value("gwt-mst", "options", "SORPTION", sorb,
                                     path)
            sorption = dict(isrb=_SORPTION[str(sorb).upper()], **{
                key.lower(): read_grid_array(mst_bf, "GRIDDATA", key, shp,
                                             mdir, default=0.0).reshape(-1)
                for key in ("BULK_DENSITY", "DISTCOEF", "SP2")})

    cnc = src = None
    if "CNC6" in pkg_files:
        cnc = _first_period_entries(pkg_files["CNC6"], grid, "CNC6")
    if "SRC6" in pkg_files:
        src = _first_period_entries(pkg_files["SRC6"], grid, "SRC6")

    conc_path = oc = None
    if "OC6" in pkg_files:
        conc_path, _, oc = load_oc(pkg_files["OC6"], mdir,
                                   component="gwt-oc")

    model = gwt_builder.build_gwt(
        mname, grid, porosity=porosity, strt=strt.reshape(-1), scheme=scheme,
        decay=decay, sorption=sorption, cnc=cnc, src=src, dsp=dsp,
        device=device)
    return dict(name=mname, model=model, grid=grid,
                ssm_sources=_ssm_sources(pkg_files),
                apt=_apt_specs(pkg_files, "GWT6"), conc_path=conc_path,
                oc=oc)


def _load_gwe_model(ws, mfname, mname, device):
    """One GWE model's name file and packages (IC, ADV, CND, EST, SSM, CTP,
    ESL, OC, and the APT files LKE, SFE, MWE, UZE) → a bundle dict (the
    reference's _load_gwe_model, loader.py:1118-1235).  Beyond it, these
    raise by name where it reads past them or runs them another way: GWT
    package types in a GWE name file, a nonzero LATENT_HEAT_VAPORIZATION
    (stored and never used there), CND6 without XT3D_OFF, later PERIOD
    blocks of CTP6 and ESL6 (period 1 alone there)."""
    from ...models.gwe import builder as gwe_builder
    from ...models.gwe import est as est_mod

    mnam, mdir, pkg_files = _transport_files(ws, mfname, "GWE6")
    schema.check_options("gwe-nam", mnam.options(), mfname)
    grid = _load_grid({k: [v] for k, v in pkg_files.items()})
    shp = grid.shape

    strt = read_grid_array(BlockFile(pkg_files["IC6"]), "GRIDDATA", "STRT",
                           shp, mdir, default=0.0)
    scheme = _adv_scheme(pkg_files, "gwe-adv")

    kw, decay = dict(porosity=0.3), None
    if "EST6" in pkg_files:
        path = pkg_files["EST6"]
        est_bf = BlockFile(path)
        eopts = est_bf.options()
        schema.check_options("gwe-est", eopts, path)
        schema.check_griddata("gwe-est", est_bf, path)
        if float(eopts.get("LATENT_HEAT_VAPORIZATION", 0.0)):
            raise _not_ported(f"{path}: a nonzero LATENT_HEAT_VAPORIZATION "
                              "(the reference stores it and never uses it)")

        def grid_array(key, default):
            return read_grid_array(est_bf, "GRIDDATA", key, shp, mdir,
                                   default=default).reshape(-1)

        kw.update(porosity=grid_array("POROSITY", 0.3),
                  rhow=float(eopts.get("DENSITY_WATER", 1000.0)),
                  cpw=float(eopts.get("HEAT_CAPACITY_WATER", 4184.0)),
                  rhos=grid_array("DENSITY_SOLID", 2650.0),
                  cps=grid_array("HEAT_CAPACITY_SOLID", 800.0))
        dw = "ZERO_ORDER_DECAY_WATER" in eopts
        ds = "ZERO_ORDER_DECAY_SOLID" in eopts
        if dw or ds:
            decay = (est_mod.DECAY_BOTH if dw and ds
                     else est_mod.DECAY_WATER if dw else est_mod.DECAY_SOLID,
                     grid_array("DECAY_WATER", 0.0),
                     grid_array("DECAY_SOLID", 0.0))

    cnd = None
    if "CND6" in pkg_files:
        path = pkg_files["CND6"]
        cnd_bf = BlockFile(path)
        copts = cnd_bf.options()
        schema.check_options("gwe-cnd", copts, path)
        _xt3d_off(path, copts, "CND6")
        cnd = {}
        for key in ("ALH", "ALV", "ATH1", "ATH2", "ATV", "KTW", "KTS"):
            arr = read_grid_array(cnd_bf, "GRIDDATA", key, shp, mdir)
            if arr is not None:
                cnd[key.lower()] = arr.reshape(-1)

    ctp = esl = None
    if "CTP6" in pkg_files:
        ctp = _first_period_entries(pkg_files["CTP6"], grid, "CTP6")
    if "ESL6" in pkg_files:
        esl = _first_period_entries(pkg_files["ESL6"], grid, "ESL6")

    temp_path = oc = None
    if "OC6" in pkg_files:
        temp_path, _, oc = load_oc(pkg_files["OC6"], mdir,
                                   component="gwe-oc")

    model = gwe_builder.build_gwe(
        mname, grid, strt=strt.reshape(-1), scheme=scheme, decay=decay,
        cnd=cnd, ctp=ctp, esl=esl, device=device, **kw)
    return dict(name=mname, model=model, grid=grid,
                ssm_sources=_ssm_sources(pkg_files),
                apt=_apt_specs(pkg_files, "GWE6"), conc_path=temp_path,
                oc=oc)


def _apt_model(gwt, model, bundle, apt, device):
    """The transport model with the APT rows of ``apt`` (the reference's
    loader.py:1537-1566): an ``AugmentedGwtModel`` over the augmented flow
    model, with the features' starting concentrations, and the sources'
    concentrations per feature package.  An APT file beside a flow model
    without its feature, a UZT file without UZF (or, as in the reference,
    without MAW, LAK or SFR beside it), and PACKAGEDATA that does not list
    every feature raise."""
    from ...models.gwt.apt import AugmentedGwtModel

    first = next(iter(apt.values()))["ftype"]
    if not isinstance(model, AugmentedGwfModel):
        raise ValueError(
            f"{first}: APT transport packages (LKT/SFT/MWT/UZT and the GWE "
            "analogs) require the matching advanced packages in the GWF "
            "model")
    uzf = None
    if "uzf" in apt:
        if bundle["uzf_entries"] is None:
            raise ValueError(f"{apt['uzf']['ftype']} requires a GWF UZF "
                             "package")
        uzf = _build_uzf(bundle, device)
    for kind, spec in apt.items():
        if kind != "uzf" and getattr(model, kind) is None:
            raise ValueError(f"{spec['ftype']}: the flow model has no "
                             f"{kind.upper()}6 package")
    aug = AugmentedGwtModel(gwt, model, uzf=uzf)
    strt = np.zeros(aug.n_extra)
    ext = {}
    for kind, spec in apt.items():
        if kind == "uzf":
            off, count = aug._uzf_off, int(uzf.node.shape[0])
        else:
            off = getattr(model, f"_{kind}_offset") - model.n_grid
            count = getattr(getattr(model, kind), dict(
                maw="nwells", lak="nlakes", sfr="nreaches")[kind])
        if len(spec["strt"]) != count:
            raise ValueError(f"{spec['ftype']}: PACKAGEDATA lists "
                             f"{len(spec['strt'])} of {count} features")
        strt[off:off + count] = spec["strt"]
        ext[kind] = torch.as_tensor(spec["ext_conc"], dtype=torch.float64,
                                    device=device)
    aug.strt_extra = torch.as_tensor(strt, device=device)
    return aug, ext


def _ssm_spec(gwt_bundle, flow_bundle):
    """SSM AUX sources → {PKG: per-entry concentration}: the flow package's
    period-1 auxiliary column, padded to its maxbound (the reference's
    loader.py:1515-1534).  Values that change after period 1 raise: the
    reference keeps the period-1 column."""
    spec = {}
    for pname, auxname in gwt_bundle["ssm_sources"]:
        attr = pname[:3].lower()
        auxp = flow_bundle["pkg_aux"].get(attr, {})
        vals = auxp.get(1, {}).get(auxname)
        if vals is None:
            raise ValueError(
                f"SSM source {pname} references aux {auxname} but the "
                f"{attr.upper()} package has no such period-1 column")
        for kper, av in sorted(auxp.items()):
            if kper != 1 and av.get(auxname) != vals:
                raise _not_ported(
                    f"SSM source {pname}: {auxname} values that change in "
                    f"PERIOD {kper} (the reference keeps period 1's)")
        arr = np.zeros(flow_bundle["maxbound"][attr])
        arr[:len(vals)] = vals
        spec[attr.upper()] = arr
    return spec or None


# PRP6 options the reference's loader reads past that change the tracks
# (R24–R30 of ROADMAP Queue C)
_PRP_UNPORTED = {"STOPTRAVELTIME": "R24", "EXTEND_TRACKING": "R25",
                 "DRAPE": "R26", "STOP_AT_WEAK_SINK": "R27",
                 "DRY_TRACKING_METHOD": "R28",
                 "RELEASE_TIME_FREQUENCY": "R29",
                 "EXIT_SOLVE_TOLERANCE": "R30"}
# PRT OC6 options that select or write tracks, which the reference's
# loader never reads (R31)
_PRT_OC_UNPORTED = ("TRACK", "TRACKCSV", "TRACK_RELEASE", "TRACK_EXIT",
                    "TRACK_TIMESTEP", "TRACK_TERMINATE", "TRACK_WEAKSINK",
                    "TRACK_USERTIME")


def _prp_points(block, grid):
    """PRP PACKAGEDATA (irptno cellid xrpt yrpt zrpt ...) → (node, x, y,
    z) arrays: records of one width as columns, others one by one."""
    nt = _cellid_width(grid)
    table = uniform_table(block.raw)
    if table is not None and table[1] >= 1 + nt + 3:
        toks, w = table
        try:
            cid = [np.array(list(map(int, toks[1 + j::w])), np.int64) - 1
                   for j in range(nt)]
            xyz = [np.array(list(map(float, toks[1 + nt + j::w])))
                   for j in range(3)]
        except ValueError:
            xyz = None
        if xyz is not None:
            node = (((cid[0] * grid.nrow + cid[1]) * grid.ncol + cid[2])
                    if nt == 3 else cid[0] * grid.ncpl + cid[1] if nt == 2
                    else cid[0])
            return (node, *xyz)
    cells, xyz = [], []
    for toks in block.lines:
        node, n = _cellid_to_node(toks, grid, start=1)
        cells.append(node)
        xyz.append([float(toks[1 + n + j]) for j in range(3)])
    return (np.asarray(cells, np.int64),
            *np.asarray(xyz, np.float64).reshape(-1, 3).T)


def _load_prt_model(ws, mfname, mname, gwf_model, gwf_grid, device):
    """One PRT model name file (DIS/DISV, MIP, PRP, OC) → PrtDriver over
    the flow model ``gwf_model`` (the reference's loader.py:1236-1333).
    The PRT grid must have the flow grid's cells; the particles track on
    the flow model's grid, as there."""
    from ...models.prt.model import PrtModel, ReleasePoints
    from ...models.prt.simulation import PrtDriver
    from ...models.prt.trackfile import ReleaseSchedule

    mnam = BlockFile(os.path.join(ws, mfname))
    mdir = os.path.dirname(os.path.join(ws, mfname))
    schema.check_options("prt-nam", mnam.options(), mfname)
    pkg_files = {}
    for toks in mnam.get("PACKAGES").lines:
        pkg_files.setdefault(toks[0].upper(), []).append(
            os.path.join(mdir, toks[1]))

    grid = _load_grid(pkg_files)
    if grid.nodes != gwf_grid.nodes:
        raise ValueError("PRT grid does not match the GWF grid")
    shp = grid.shape
    porosity = np.full(grid.nodes, 0.3)
    izone = None
    if "MIP6" in pkg_files:
        mip = BlockFile(pkg_files["MIP6"][0])
        schema.check_options("prt-mip", mip.options(), pkg_files["MIP6"][0])
        porosity = read_grid_array(mip, "GRIDDATA", "POROSITY", shp, mdir,
                                   default=0.3).reshape(-1)
        iz = read_grid_array(mip, "GRIDDATA", "IZONE", shp, mdir,
                             dtype=np.int64)
        izone = iz.reshape(-1) if iz is not None else None
    if "OC6" in pkg_files:
        oc_path = pkg_files["OC6"][0]
        oc_opts = BlockFile(oc_path).options()
        schema.check_options("prt-oc", oc_opts, oc_path)
        _refuse(oc_opts, _PRT_OC_UNPORTED,
                f"{oc_path} (R31: the reference's loader reads no PRT OC6)")

    prp_path = pkg_files.get("PRP6", [None])[0]
    if prp_path is None:
        raise _not_ported("a PRT model without a PRP6 package")
    prp = BlockFile(prp_path)
    popts = prp.options()
    schema.check_options("prt-prp", popts, prp_path)
    for key, rn in _PRP_UNPORTED.items():
        _refuse(popts, (key,), f"{prp_path} ({rn}: the reference's loader "
                "reads it past)")

    def _fileout(key):
        v = popts.get(key)
        if isinstance(v, list) and v[0].upper() == "FILEOUT":
            return os.path.join(mdir, v[1])
        return None

    cells, xs, ys, zs = _prp_points(prp.get("PACKAGEDATA"), grid)
    if "LOCAL_Z" in popts:
        # zrpt is a [0, 1] fraction of the cell's thickness (prp local_z)
        gtop = np.asarray(gwf_grid.top).reshape(-1)[cells]
        gbot = np.asarray(gwf_grid.bot).reshape(-1)[cells]
        zs = gbot + zs * (gtop - gbot)

    rt_b = prp.get("RELEASETIMES")
    times = [float(t[0]) for t in rt_b.lines] if rt_b is not None else []
    period_settings = {}
    for b in prp.get_all("PERIOD"):
        settings = []
        for toks in b.lines:
            kw = toks[0].upper()
            if kw in ("ALL", "FIRST", "LAST"):
                settings.append((kw.lower(),))
            elif kw == "FREQUENCY":
                settings.append(("frequency", int(toks[1])))
            elif kw == "STEPS":
                settings.append(("steps", [int(t) for t in toks[1:]]))
            elif kw == "FRACTION":
                settings.append(("fraction", float(toks[1])))
            else:
                raise _not_ported(f"PRP release setting {kw}")
        period_settings[b.index] = settings

    prt = PrtModel(mname, gwf_grid,
                   torch.as_tensor(np.asarray(porosity, np.float64),
                                   device=device),
                   ReleasePoints(x=xs, y=ys, z=zs))
    stoptime = float(popts["STOPTIME"]) if "STOPTIME" in popts else np.inf
    return PrtDriver(
        model=prt, gwf_model=gwf_model,
        schedule=ReleaseSchedule(period_settings=period_settings,
                                 times=tuple(times)),
        track_path=_fileout("TRACK"), trackcsv_path=_fileout("TRACKCSV"),
        stoptime=stoptime,
        istopzone=int(popts.get("ISTOPZONE", 0) or 0), izone=izone)


def _load_swf_simulation(ws, sim, tdis, entry, device):
    """One CHF6/OLF6 model (and its IMS) → SwfSimulation."""
    from ...models.swf.simulation import SwfSimulation
    from .swf_loader import load_swf_model

    mtype, mfname, mname = entry
    bundle = load_swf_model(ws, mfname, mname, mtype, device=device)
    settings = None
    for sg in sim.get_all("SOLUTIONGROUP"):
        for toks in sg.lines:
            if toks[0].upper() == "IMS6":
                s = load_ims(os.path.join(ws, toks[1]))
                # SWF stages take the DBD under-relaxation defaults where
                # the deck's IMS leaves them unset (the reference's loader)
                if s.under_relaxation in (None, "none"):
                    s = dataclasses.replace(
                        s, under_relaxation="dbd", theta=0.9, akappa=1e-4,
                        gamma=0.0, amomentum=0.0, no_ptc=True)
                settings = s
    return SwfSimulation(tdis, bundle["model"], settings,
                         sto_periods=bundle["sto_periods"],
                         has_sto=bundle["has_sto"],
                         hds_path=bundle["hds_path"], oc=bundle["oc"])


def load_simulation(workspace, hds_path=None, cbc_path=None, lst_path=None,
                    device=None):
    """Load mfsim.nam and everything it references → Simulation.

    Supported: GWF6 models, one or several joined by GWF6-GWF6 exchanges,
    with one IMS solution, or one GWF6 model and one GWT6 model with a
    GWF6-GWT6 exchange and an IMS solution each (see the module
    docstring).  ``device=None`` puts the model on the CUDA device and
    raises when there is none; pass ``"cpu"`` to run on the CPU.
    """
    device = resolve_device(device)
    ws = os.path.abspath(workspace)
    sim = BlockFile(os.path.join(ws, "mfsim.nam"))
    sopts = sim.options()
    hpc_partitions = _load_hpc(ws, sopts)

    # timing
    timing = sim.get("TIMING")
    tdis = load_tdis(os.path.join(ws, timing.lines[0][1]))

    # models
    models_blk = sim.get("MODELS")
    if models_blk is None or not models_blk.lines:
        raise ValueError("mfsim.nam names no model")
    entries, gwt_entries, swf_entries, prt_entries = [], [], [], []
    for i, toks in enumerate(models_blk.lines):
        mtype = toks[0].upper()
        mname = toks[2].upper() if len(toks) > 2 else f"MODEL{i + 1}"
        if mtype not in ("GWF6", "GWT6", "GWE6", "CHF6", "OLF6", "PRT6"):
            raise _not_ported(f"mfsim.nam: model type {mtype}")
        if mtype == "GWF6":
            entries.append((toks[1], mname))
        elif mtype in ("CHF6", "OLF6"):
            swf_entries.append((mtype, toks[1], mname))
        elif mtype == "PRT6":
            prt_entries.append((toks[1], mname))
        else:
            gwt_entries.append((mtype, toks[1], mname))
    if swf_entries:
        if entries or gwt_entries or prt_entries or len(swf_entries) > 1:
            raise _not_ported(
                "mfsim.nam: CHF6/OLF6 beside another model (the reference "
                "loads one SWF model per simulation; couple SWF and GWF "
                "from Python through models.swf.exchange)")
        return _load_swf_simulation(ws, sim, tdis, swf_entries[0], device)
    if not entries:
        raise _not_ported("mfsim.nam: a model without a GWF6 model (flows "
                          "from FMI6 files)")
    ttypes = sorted({t for t, _, _ in gwt_entries})
    if len(gwt_entries) > 1:
        raise _not_ported(f"mfsim.nam: several {'/'.join(ttypes)} models "
                          "(the reference's loader refuses them too)")
    if gwt_entries and len(entries) > 1:
        raise _not_ported(f"mfsim.nam: {ttypes[0]} beside several GWF6 "
                          f"models (a GWF6-{ttypes[0]} exchange with a "
                          "merged flow model; the reference's loader "
                          "refuses it too)")
    if prt_entries and len(entries) > 1:
        raise _not_ported("mfsim.nam: PRT6 beside several GWF6 models (the "
                          "reference's loader refuses it too)")
    names = [mname for _, mname in entries]
    gwt_names = [mname for _, _, mname in gwt_entries]
    prt_names = [mname for _, mname in prt_entries]
    exchange_entries = []
    exg_blk = sim.get("EXCHANGES")
    for toks in (exg_blk.lines if exg_blk is not None else []):
        etype, m1, m2 = toks[0].upper(), toks[2].upper(), toks[3].upper()
        if (etype in ("GWF6-GWT6", "GWF6-GWE6") and m1 in names
                and m2 in gwt_names) or (etype == "GWF6-PRT6"
                                          and m1 in names
                                          and m2 in prt_names):
            continue        # the reference never opens its file
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

    # solution groups → each model's IMS settings (by the model names on
    # the IMS6 record; the first IMS serves a model that none names), and
    # the group Picard's MXITER
    by_model, first, mxiter = {}, None, 1
    for sg in sim.get_all("SOLUTIONGROUP"):
        for toks in sg.lines:
            if toks[0].upper() == "MXITER":
                mxiter = int(toks[1])
            if toks[0].upper() == "IMS6":
                ims = load_ims(os.path.join(ws, toks[1]))
                first = first or ims
                for name in toks[2:]:
                    by_model[name.upper()] = ims
    settings = by_model.get(names[0], first or ImsSettings())

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
    gwt_kwargs, apt_ext_conc = {}, {}
    if gwt_entries:
        ttype, mfname, mname = gwt_entries[0]
        load_model = _load_gwe_model if ttype == "GWE6" else _load_gwt_model
        gwt_bundle = load_model(ws, mfname, mname, device)
        apt = gwt_bundle["apt"]
        if bundle["uzf_entries"] is not None and "uzf" not in apt:
            raise _not_ported(f"{ttype} beside UZF without UZT (the "
                              "reference's FMI drops the UZF flows)")
        if gwt_bundle["grid"].nodes != bundle["grid"].nodes:
            raise ValueError(f"the {ttype} model's grid differs from the "
                             "GWF6 model's")
        if ttype == "GWE6" and (bundle["base_model"].buy is not None
                                or bundle["base_model"].vsc is not None):
            raise _not_ported("BUY6 or VSC6 beside a GWE6 model (the "
                              "reference reads the temperature as a "
                              "concentration)")
        if apt and any(k <= tdis.nper for k in bundle["adv_periods"]):
            raise _not_ported(
                f"later PERIOD blocks of MAW6, LAK6, SFR6, MVR6 or UZF6 "
                f"beside {ttype} APT files (the reference's transport keeps "
                "the first period's features)")
        gwt = gwt_bundle["model"]
        gwt.ssm_spec = _ssm_spec(gwt_bundle, bundle)
        if apt:
            gwt, apt_ext_conc = _apt_model(gwt, model, bundle, apt, device)
        gwt_kwargs = dict(gwt=gwt, gwt_settings=by_model.get(gwt_names[0]),
                          conc_path=gwt_bundle["conc_path"],
                          gwt_oc=gwt_bundle["oc"],
                          conc_text="TEMPERATURE" if ttype == "GWE6"
                          else "CONCENTRATION")
    simulation = Simulation(
        tdis, model, settings, transient=transient,
        hds_path=hds_path or bundle["hds_path"],
        cbc_path=cbc_path or bundle["cbc_path"],
        lst_path=lst_path, oc=bundle["oc"], obs=bundle["obs"],
        nc_path=bundle["nc_out"], **gwt_kwargs)
    simulation.sgp_mxiter = mxiter
    simulation.apt_ext_conc = apt_ext_conc
    # reference failure semantics: abort on nonconvergence unless the
    # simulation CONTINUE option is set (sim-nam continue keyword)
    simulation.fail_fast = "CONTINUE" not in sopts
    # the model → rank spec for the sharded runners (HPC6 PARTITIONS, the
    # owner vector of parallel.general.owner_from_partitions)
    simulation.hpc_partitions = hpc_partitions
    offsets = model.grid.offsets if len(bundles) > 1 else [0]
    simulation.model_offsets = {b["name"].upper(): int(off)
                                for b, off in zip(bundles, offsets)}
    simulation.model_sizes = {b["name"].upper(): b["grid"].nodes
                              for b in bundles}
    # PRT models track over the accepted flow steps (an augmented flow
    # model's base grid)
    for mfname, mname in prt_entries:
        gm = bundle["model"]
        simulation.prt_drivers.append(_load_prt_model(
            ws, mfname, mname, getattr(gm, "base", gm), bundle["grid"],
            device))
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
