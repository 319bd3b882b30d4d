"""Deck loading of the advanced stress packages MAW6, LAK6 (with its TAB6
tables), SFR6 and UZF6 of a GWF name file, of the MVR6 movers of a model
or of a GWF6-GWF6 exchange, and of the advanced transport files
(LKT6/SFT6/MWT6/UZT6 of a GWT name file, LKE6/SFE6/MWE6/UZE6 of a GWE
one).

A numpy copy of modflow6_tpu/utils/mf6io/advanced_loader.py
(``_period_blocks``, ``_only_first_period``, ``load_apt``, ``load_maw``/
``apply_maw_period``, ``load_lak``/``apply_lak_period``, ``load_sfr``/
``apply_sfr_period``, ``load_uzf``/``apply_uzf_period``,
``parse_mvr_period``, ``load_mvr``, ``load_exchange_mvr``): the
PACKAGEDATA / CONNECTIONDATA / OUTLETS / TABLES / DIVERSIONS / PERIOD
block formats of gwf-maw.f90, gwf-lak.f90, gwf-sfr.f90, gwf-uzf.f90 and
gwf-mvr.f90 as their dfn files specify them.  Each feature loader returns
the host spec of ``build_maw``/``build_lak``/``build_sfr`` or the column
arrays of ``make_uzf`` with the first period's settings applied, and the
PERIOD blocks of later periods, which the deck loader applies at each
period's start and then rebuilds the augmented model or the columns
(values persist until redefined, as in <pkg>_rp).  A model's MVR6 PERIOD
block replaces the whole mover set (mvr_rp).

UZF6 holds a record per column, a million at the sizes users run: its
blocks are read as column arrays (the reference builds a dict per column),
with the same values.

Beyond the reference: SFR's CROSSSECTIONS block (``rno TAB6 FILEIN
file``, the table's xfraction/height[/manfraction] rows) is read into the
reach's n-point section; the reference's loader reads past it.  Options
that would change the flows and that neither loader implements raise by
name (``UNPORTED_OPTIONS``), and so do the LAK and SFR period settings
STATUS other than ACTIVE and SFR's STAGE, where the reference reads past
them.
"""

from __future__ import annotations

import os

import numpy as np

from ...models.discretization import DisGrid, DisvGrid
from . import schema
from .reader import BlockFile, TokenTable, table_or_lines

# options of MAW6, LAK6 and SFR6 that change the flows and are not ported
UNPORTED_OPTIONS = {
    "gwf-maw": ("TS6", "LENGTH_CONVERSION", "TIME_CONVERSION",
                "UNIT_CONVERSION", "FLOW_CORRECTION", "SHUTDOWN_THETA",
                "SHUTDOWN_KAPPA", "MAW_FLOW_REDUCE_CSV"),
    "gwf-lak": ("TS6", "LENGTH_CONVERSION", "TIME_CONVERSION",
                "UNIT_CONVERSION", "SURFDEP"),
    "gwf-sfr": ("TS6", "LENGTH_CONVERSION", "TIME_CONVERSION",
                "UNIT_CONVERSION", "STORAGE"),
    # the reference runs SQUARE_GWET as LINEAR_GWET and reads past
    # UNSAT_ETAE (which would switch the unsaturated ET to the
    # capillary-pressure form)
    "gwf-uzf": ("TS6", "AUXMULTNAME", "OBS6", "UNSAT_ETAE", "SQUARE_GWET"),
    "gwf-mvr": (),
}


def _options(bf, component, path):
    opts = bf.options()
    schema.check_options(component, opts, path)
    for key in UNPORTED_OPTIONS[component]:
        if key in opts:
            raise NotImplementedError(f"{path}: option {key} is not ported")
    return opts


def _period_blocks(bf):
    """{kper: [token lists]} from all PERIOD blocks."""
    return {int(b.index): list(b.lines) for b in bf.get_all("PERIOD")}


def _only_first_period(periods, what):
    late = [k for k in periods if k > 1]
    if late:
        raise NotImplementedError(
            f"{what}: PERIOD blocks beyond the first stress period "
            f"(kper={late}) are not supported by the deck loader yet")
    return periods.get(1, [])


def apply_maw_period(wells, lines):
    """Apply one PERIOD block to the wells spec (gwf-maw.f90 maw_rp; values
    persist across periods until redefined)."""
    schema.check_block_keywords("gwf-maw", "period",
                                [t[1] for t in lines if len(t) > 1])
    for toks in lines:
        w = int(toks[0]) - 1
        key = toks[1].upper()
        if key == "RATE":
            wells[w]["rate"] = float(toks[2])
        elif key == "HEAD_LIMIT":
            v = toks[2]
            if v.upper() == "OFF":
                wells[w].pop("head_limit", None)
            else:
                wells[w]["head_limit"] = float(v)
        elif key == "STATUS":
            if toks[2].upper() == "INACTIVE":
                wells[w]["rate"] = 0.0
        elif key == "RATE_SCALING":
            wells[w]["pumpelev"] = float(toks[2])
            wells[w]["reduction_length"] = float(toks[3])
        elif key == "FLOWING_WELL":
            wells[w]["flowing"] = dict(elev=float(toks[2]),
                                       cond=float(toks[3]),
                                       rlen=float(toks[4]))
        elif key == "SHUT_OFF":
            wells[w]["shut_off"] = (float(toks[2]), float(toks[3]))
        else:
            raise NotImplementedError(f"MAW period setting {key}")


def load_maw(path, grid, cellid):
    """MAW6 file → (wells spec for build_maw, later PERIOD blocks)."""
    bf = BlockFile(path)
    _options(bf, "gwf-maw", path)
    pdata = {}
    for toks in bf.get("PACKAGEDATA").lines:
        w = int(toks[0]) - 1
        pdata[w] = dict(radius=float(toks[1]), bottom=float(toks[2]),
                        strt=float(toks[3]), condeqn=toks[4].upper(),
                        ngwfnodes=int(toks[5]), connections=[])
    for toks in bf.get("CONNECTIONDATA").lines:
        w = int(toks[0]) - 1
        node, nt = cellid(toks, start=2)
        # scrn_top scrn_bot hk_skin radius_skin follow the cellid
        eqn = pdata[w]["condeqn"]
        if eqn == "SPECIFIED":
            conn = (node, float(toks[2 + nt + 2]))
        else:
            conn = (node, dict(condeqn=eqn,
                               scrn_top=float(toks[2 + nt]),
                               scrn_bot=float(toks[2 + nt + 1]),
                               hk_skin=float(toks[2 + nt + 2]),
                               radius_skin=float(toks[2 + nt + 3])))
        pdata[w]["connections"].append(conn)
    periods = _period_blocks(bf)
    wells = [pdata[w] for w in sorted(pdata)]
    apply_maw_period(wells, periods.get(1, []))
    return wells, {k: v for k, v in periods.items() if k > 1}


def _table_rows(path, ncol):
    """The first ``ncol`` columns of a TAB6 file's TABLE rows."""
    rows = BlockFile(path).get("TABLE").lines
    return [tuple(float(t) for t in toks[:ncol]) for toks in rows]


def load_lak(path, grid, cellid, base_dir):
    """LAK6 file → ((lakes spec, outlets spec) for build_lak, later PERIOD
    blocks)."""
    bf = BlockFile(path)
    _options(bf, "gwf-lak", path)
    area = np.asarray(grid.area).reshape(-1)
    lakes = {}
    for toks in bf.get("PACKAGEDATA").lines:
        il = int(toks[0]) - 1
        lakes[il] = dict(strt=float(toks[1]), surf_area=0.0,
                         connections=[])
    for toks in bf.get("CONNECTIONDATA").lines:
        il = int(toks[0]) - 1
        node, nt = cellid(toks, start=2)
        claktype = toks[2 + nt].upper()
        bedleak = toks[2 + nt + 1]
        belev = float(toks[2 + nt + 2])
        telev = float(toks[2 + nt + 3])
        connwidth = float(toks[2 + nt + 5])
        connlen = float(toks[2 + nt + 4])
        if claktype == "VERTICAL":
            carea = area[node]
        else:  # HORIZONTAL / EMBEDDED: wetted area from length × width
            carea = connlen * connwidth
        leak = 0.0 if str(bedleak).upper() == "NONE" else float(bedleak)
        # HORIZONTAL (and EMBEDDED*, taken the same way) scale the
        # saturated conductance by the wetted fraction between belev and
        # telev at run time (lak_calculate_conn_conductance)
        ictype = 0 if claktype == "VERTICAL" else 1
        lakes[il]["connections"].append(
            (node, leak * carea, belev, telev, ictype))
        lakes[il]["surf_area"] += carea if claktype == "VERTICAL" else 0.0
    tab_b = bf.get("TABLES")
    if tab_b is not None:
        for toks in tab_b.lines:
            il = int(toks[0]) - 1
            if toks[1].upper() != "TAB6" or toks[2].upper() != "FILEIN":
                raise ValueError(f"{path}: TABLES row {toks} is not "
                                 "'lakeno TAB6 FILEIN file'")
            lakes[il]["table"] = _table_rows(os.path.join(base_dir,
                                                          toks[3]), 3)
    outlets = []
    out_b = bf.get("OUTLETS")
    if out_b is not None:
        for toks in out_b.lines:
            outlets.append(dict(
                lake=int(toks[1]) - 1,
                to=int(toks[2]) - 1,       # 0 → -1 external
                type=toks[3].lower(),
                invert=float(toks[4]), width=float(toks[5]),
                rough=float(toks[6]), slope=float(toks[7])))
    lakes_l = [lakes[i] for i in sorted(lakes)]
    periods = _period_blocks(bf)
    apply_lak_period(lakes_l, outlets, periods.get(1, []))
    return (lakes_l, outlets), {k: v for k, v in periods.items() if k > 1}


def apply_lak_period(lakes, outlets, lines):
    """Apply one PERIOD block to the lakes/outlets spec (gwf-lak.f90
    lak_rp laksetting keystrings)."""
    schema.check_block_keywords("gwf-lak", "period",
                                [t[1] for t in lines if len(t) > 1])
    for toks in lines:
        no = int(toks[0]) - 1
        key = toks[1].upper()
        if key == "RAINFALL":
            lakes[no]["rainfall"] = float(toks[2]) * lakes[no]["surf_area"]
        elif key == "EVAPORATION":
            lakes[no]["evap"] = float(toks[2]) * lakes[no]["surf_area"]
        elif key == "WITHDRAWAL":
            lakes[no]["withdrawal"] = float(toks[2])
        elif key == "RATE":
            outlets[no]["rate"] = float(toks[2])
            outlets[no]["type"] = "specified"
        elif key == "INVERT":
            outlets[no]["invert"] = float(toks[2])
        elif key == "STATUS" and toks[2].upper() == "ACTIVE":
            pass
        else:
            raise NotImplementedError(
                f"LAK period setting {' '.join(toks[1:3])}")


def load_sfr(path, grid, cellid, base_dir):
    """SFR6 file → (reaches spec for build_sfr, later PERIOD blocks)."""
    bf = BlockFile(path)
    _options(bf, "gwf-sfr", path)
    reaches = {}
    ustrf = {}
    for toks in bf.get("PACKAGEDATA").lines:
        r = int(toks[0]) - 1
        node, nt = cellid(toks, start=1)
        c = 1 + nt
        rlen, rwid, rgrd, rtp, rbth, rhk, man = (
            float(toks[c]), float(toks[c + 1]), float(toks[c + 2]),
            float(toks[c + 3]), float(toks[c + 4]), float(toks[c + 5]),
            float(toks[c + 6]))
        ustrf[r] = float(toks[c + 8])
        reaches[r] = dict(node=node, cond=rhk * rwid * rlen / max(rbth,
                                                                  1e-30),
                          strtop=rtp, width=rwid, rough=man, slope=rgrd,
                          length=rlen, strt=rtp + 0.1, upstream=[],
                          diversions=[])
    # downstream links: reach u lists -d for its downstream receivers;
    # receiver d gets fraction ustrf_d / Σ ustrf over u's receivers
    down = {r: [] for r in reaches}
    cb = bf.get("CONNECTIONDATA")
    if cb is not None:
        for toks in cb.lines:
            r = int(toks[0]) - 1
            for t in toks[1:]:
                ic = int(float(t))
                if ic < 0:
                    down[r].append(-ic - 1)
    for u, ds in down.items():
        tot = sum(ustrf[d] for d in ds)
        for d in ds:
            frac = ustrf[d] / tot if tot > 0 else 0.0
            reaches[d]["upstream"].append((u, frac))
    db = bf.get("DIVERSIONS")
    if db is not None:
        for toks in db.lines:
            r = int(toks[0]) - 1
            reaches[r]["diversions"].append(dict(
                to=int(toks[2]) - 1, cprior=toks[3].lower(), flow=0.0))
    xb = bf.get("CROSSSECTIONS")
    if xb is not None:
        for toks in xb.lines:
            r = int(toks[0]) - 1
            if toks[1].upper() != "TAB6" or toks[2].upper() != "FILEIN":
                raise ValueError(f"{path}: CROSSSECTIONS row {toks} is not "
                                 "'rno TAB6 FILEIN file'")
            rows = np.asarray(_table_rows(os.path.join(base_dir, toks[3]),
                                          3))
            section = (rows[:, 0], rows[:, 1])
            if rows.shape[1] > 2:
                section += (rows[:-1, 2],)
            reaches[r]["xsection"] = section
    reaches_l = [reaches[i] for i in sorted(reaches)]
    periods = _period_blocks(bf)
    apply_sfr_period(reaches_l, periods.get(1, []))
    return reaches_l, {k: v for k, v in periods.items() if k > 1}


def apply_sfr_period(reaches, lines):
    """Apply one PERIOD block to the reaches spec (gwf-sfr.f90 sfr_rp)."""
    schema.check_block_keywords("gwf-sfr", "period",
                                [t[1] for t in lines if len(t) > 1])
    for toks in lines:
        r = int(toks[0]) - 1
        key = toks[1].upper()
        if key == "INFLOW":
            reaches[r]["inflow"] = float(toks[2])
        elif key == "RAINFALL":
            reaches[r]["rainfall"] = float(toks[2]) \
                * reaches[r]["length"] * reaches[r]["width"]
        elif key == "EVAPORATION":
            reaches[r]["evap"] = float(toks[2]) \
                * reaches[r]["length"] * reaches[r]["width"]
        elif key == "RUNOFF":
            reaches[r]["runoff"] = float(toks[2])
        elif key == "DIVERSION":
            reaches[r]["diversions"][int(toks[2]) - 1]["flow"] = \
                float(toks[3])
        elif key == "MANNING":
            reaches[r]["rough"] = float(toks[2])
        elif key == "STATUS" and toks[2].upper() == "ACTIVE":
            pass
        else:
            raise NotImplementedError(
                f"SFR period setting {' '.join(toks[1:3])}")


# ------------------------------------------------------------------- UZF

def record_column(lines, c, path, kind=float):
    """Field ``c`` of every record as a float64 (or, ``kind=int``, int64)
    array; a time-series name where a number belongs raises by name."""
    vals = (lines.column(c) if isinstance(lines, TokenTable)
            else [t[c] for t in lines])
    try:
        return np.fromiter(map(kind, vals),
                           np.float64 if kind is float else np.int64,
                           len(lines))
    except ValueError:
        raise NotImplementedError(
            f"{path}: time-series value (TS6) is not ported") from None


def cellid_nodes(lines, start, grid, path):
    """0-based nodes of the 1-based cellids at field ``start``, and the
    number of fields a cellid takes."""
    def col(i):
        return record_column(lines, start + i, path, int) - 1

    if isinstance(grid, DisGrid):
        return (col(0) * grid.nrow + col(1)) * grid.ncol + col(2), 3
    if isinstance(grid, DisvGrid):
        return col(0) * grid.ncpl + col(1), 2
    return col(0), 1


def load_uzf(path, grid):
    """UZF6 file → (columns, flags, later PERIOD blocks): ``columns`` maps
    ``iuzno``, ``node``, ``landflag``, ``surfdep``, ``vks``, ``thtr``,
    ``thts``, ``thti``, ``eps``, ``finf``, ``pet``, ``extdp`` and
    ``extwc`` to arrays in ``iuzno`` order, the first period applied;
    ``flags`` the ``make_uzf`` flags."""
    bf = BlockFile(path)
    opts = _options(bf, "gwf-uzf", path)
    flags = dict(ietflag=int("SIMULATE_ET" in opts),
                 iseepflag=int("SIMULATE_GWSEEP" in opts),
                 igwetflag=int("LINEAR_GWET" in opts))
    # iuzno cellid landflag ivertcon surfdep vks thtr thts thti eps
    lines = table_or_lines(bf.get("PACKAGEDATA").raw)
    iuzno = record_column(lines, 0, path, int) - 1
    node, nt = cellid_nodes(lines, 1, grid, path)
    c = 1 + nt
    cols = dict(iuzno=iuzno, node=node,
                landflag=record_column(lines, c, path, int))
    for k, name in ((2, "surfdep"), (3, "vks"), (4, "thtr"), (5, "thts"),
                    (6, "thti"), (7, "eps")):
        cols[name] = record_column(lines, c + k, path)
    order = np.argsort(iuzno, kind="stable")
    cols = {k: v[order] for k, v in cols.items()}
    n = iuzno.shape[0]
    for name in ("finf", "pet", "extdp", "extwc"):
        cols[name] = np.zeros(n)
    periods = {int(b.index): table_or_lines(b.raw)
               for b in bf.get_all("PERIOD")}
    apply_uzf_period(cols, periods.get(1, []), path)
    return cols, flags, {k: v for k, v in periods.items() if k > 1}


def apply_uzf_period(cols, lines, path=""):
    """Apply one PERIOD block to the UZF columns (gwf-uzf.f90 uzf_rp):
    ``iuzno finf [pet extdp extwc ...]``; values persist until
    redefined."""
    if not len(lines):
        return
    if isinstance(lines, TokenTable):
        groups = [(min(lines.width, 5), lines)]
    else:
        width = np.minimum(np.fromiter((len(t) for t in lines), np.int64,
                                       len(lines)), 5)
        groups = [(w, [lines[i] for i in np.nonzero(width == w)[0]])
                  for w in np.unique(width)]
    for w, sub in groups:
        rows = np.searchsorted(cols["iuzno"], record_column(sub, 0, path, int) - 1)
        for k, name in enumerate(("finf", "pet", "extdp", "extwc")[:w - 1]):
            cols[name][rows] = record_column(sub, k + 1, path)


# ------------------------------------------------------------------- APT

# the PERIOD settings that give a feature's external inflow its source
# concentration (or temperature); the reference folds them into one value
_APT_SOURCES = ("RAINFALL", "RUNOFF", "INFLOW", "EXT-INFLOW")
# options of the APT files that change the results and are not ported
_APT_UNPORTED = ("TS6", "OBS6", "FLOW_PACKAGE_AUXILIARY_NAME")


def load_apt(path, component):
    """An APT transport file (gwt-lkt/sft/mwt/uzt and the GWE analogs
    gwe-lke/sfe/mwe/uze) → dict(strt=[per feature], ext_conc=[per
    feature]) (the reference's ``load_apt``).

    PACKAGEDATA gives each feature its starting concentration; the PERIOD
    1 block's RAINFALL, RUNOFF, INFLOW and EXT-INFLOW settings give the
    source concentration of its external inflows.  The augmented model
    carries one source concentration per feature, where the reference
    program tracks each source apart; the reference's loader lets the
    last setting win, so a feature whose settings differ raises here.
    STATUS ACTIVE is read past; another STATUS, and CONCENTRATION or
    TEMPERATURE (the value of a CONSTANT feature, which the reference runs
    as a source concentration), raise by name, as does a nonzero KTF of a
    GWE file (the feature–aquifer conduction, which the reference reads
    past).  Later PERIOD blocks raise, as in the reference."""
    src = f"{path} ({component.split('-')[1].upper()}6)"
    bf = BlockFile(path)
    opts = bf.options()
    schema.check_options(component, opts, path)
    for key in _APT_UNPORTED:
        if key in opts:
            raise NotImplementedError(f"{src}: option {key} is not ported")
    strt = {}
    for toks in bf.get("PACKAGEDATA").lines:
        strt[int(toks[0]) - 1] = float(toks[1])
        if component.startswith("gwe-") and len(toks) > 2 \
                and component != "gwe-uze" and float(toks[2]) != 0.0:
            raise NotImplementedError(
                f"{src}: PACKAGEDATA KTF {toks[2]} (the feature-aquifer "
                "conduction, which the reference reads past)")
    n = max(strt) + 1 if strt else 0
    ext = np.zeros(n)
    given = {}
    lines = _only_first_period(_period_blocks(bf), src)
    schema.check_block_keywords(component, "period",
                                [t[1] for t in lines if len(t) > 1], path)
    for toks in lines:
        f = int(toks[0]) - 1
        key = toks[1].upper()
        if not 0 <= f < n:
            raise ValueError(f"{src}: PERIOD names feature {f + 1}, which "
                             "PACKAGEDATA does not list")
        if key in _APT_SOURCES:
            value = float(toks[2])
            if f in given and given[f][1] != value:
                raise NotImplementedError(
                    f"{src}: feature {f + 1} has the source values "
                    f"{given[f][0]} {given[f][1]} and {key} {value} (one "
                    "source concentration per feature is ported; the "
                    "reference keeps the last)")
            given[f] = (key, value)
            ext[f] = value
        elif key == "STATUS":
            if toks[2].upper() != "ACTIVE":
                raise NotImplementedError(
                    f"{src}: STATUS {toks[2].upper()} (the reference "
                    "reads past it)")
        elif key in ("CONCENTRATION", "TEMPERATURE"):
            raise NotImplementedError(
                f"{src}: period setting {key} (a CONSTANT feature's value, "
                "which the reference runs as a source concentration)")
        else:
            raise NotImplementedError(f"{src}: period setting {key}")
    return dict(strt=np.asarray([strt.get(i, 0.0) for i in range(n)]),
                ext_conc=ext)


# ------------------------------------------------------------------- MVR

def parse_mvr_period(lines, name_to_kind):
    """One MVR PERIOD block → movers list (the block replaces the whole
    mover set, gwf-mvr.f90 mvr_rp).  ``name_to_kind``: package name
    (upper) → kind; a name the model does not have raises."""
    movers = []
    for toks in lines:
        p1, id1, p2, id2, typ, val = (toks[0].upper(), int(toks[1]) - 1,
                                      toks[2].upper(), int(toks[3]) - 1,
                                      toks[4].lower(), float(toks[5]))
        for name in (p1, p2):
            if name not in name_to_kind:
                raise ValueError(f"MVR6: package {name} is not in the model")
            if name_to_kind[name] is None:
                raise NotImplementedError(
                    f"MVR6: a mover on {name}, one of several packages of "
                    "its type, is not ported (the loader merges them into "
                    "one entry list)")
        movers.append(dict(provider=name_to_kind[p1], iprov=id1,
                           receiver=name_to_kind[p2], ircv=id2,
                           mvrtype=typ, value=val))
    return movers


def load_mvr(path, name_to_kind):
    """MVR6 file of a model → (movers list for build_mvr, later PERIOD
    blocks).  ``name_to_kind``: package name (upper) → kind string."""
    bf = BlockFile(path)
    opts = _options(bf, "gwf-mvr", path)
    if "MODELNAMES" in opts:
        raise NotImplementedError(
            f"{path}: option MODELNAMES in a model's MVR6 is not ported "
            "(it belongs to an exchange's mover)")
    periods = _period_blocks(bf)
    movers = parse_mvr_period(periods.get(1, []), name_to_kind)
    return movers, {k: v for k, v in periods.items() if k > 1}


def load_exchange_mvr(path, kind_of):
    """Exchange-scope MVR6 file (GwfExchangeMover.f90 role): MODELNAMES
    records ``mname1 pname1 id1 mname2 pname2 id2 mvrtype value``.
    ``kind_of``: callable (mname, pname) → package kind.  Returns movers
    with model-qualified ids: dict(provider, prov_model, iprov, receiver,
    recv_model, ircv, mvrtype, value)."""
    bf = BlockFile(path)
    _options(bf, "gwf-mvr", path)
    movers = []
    for toks in _only_first_period(_period_blocks(bf), "exchange MVR"):
        m1, p1, id1 = toks[0].upper(), toks[1].upper(), int(toks[2]) - 1
        m2, p2, id2 = toks[3].upper(), toks[4].upper(), int(toks[5]) - 1
        movers.append(dict(
            provider=kind_of(m1, p1), prov_model=m1, iprov=id1,
            receiver=kind_of(m2, p2), recv_model=m2, ircv=id2,
            mvrtype=toks[6].lower(), value=float(toks[7])))
    return movers
