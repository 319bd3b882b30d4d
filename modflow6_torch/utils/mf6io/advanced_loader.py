"""Deck loading of the advanced stress packages MAW6, LAK6 (with its TAB6
tables) and SFR6 of a GWF name file.

A numpy copy of modflow6_tpu/utils/mf6io/advanced_loader.py:28-268
(``_period_blocks``, ``load_maw``/``apply_maw_period``,
``load_lak``/``apply_lak_period``, ``load_sfr``/``apply_sfr_period``): the
PACKAGEDATA / CONNECTIONDATA / OUTLETS / TABLES / DIVERSIONS / PERIOD
block formats of gwf-maw.f90, gwf-lak.f90 and gwf-sfr.f90 as their dfn
files specify them.  Each loader returns the host spec of
``build_maw``/``build_lak``/``build_sfr`` with the first period's settings
applied, and the PERIOD blocks of later periods, which the deck loader
applies at each period's start and then rebuilds the augmented model
(values persist until redefined, as in <pkg>_rp).

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

from . import schema
from .reader import BlockFile

# options of MAW6, LAK6 and SFR6 that change the flows and are not ported
UNPORTED_OPTIONS = {
    "gwf-maw": ("TS6", "LENGTH_CONVERSION", "TIME_CONVERSION",
                "UNIT_CONVERSION", "FLOW_CORRECTION", "SHUTDOWN_THETA",
                "SHUTDOWN_KAPPA", "MAW_FLOW_REDUCE_CSV"),
    "gwf-lak": ("TS6", "LENGTH_CONVERSION", "TIME_CONVERSION",
                "UNIT_CONVERSION", "SURFDEP"),
    "gwf-sfr": ("TS6", "LENGTH_CONVERSION", "TIME_CONVERSION",
                "UNIT_CONVERSION", "STORAGE"),
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
