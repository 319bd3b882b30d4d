"""mf5to6: MODFLOW-2005 → MODFLOW 6 input converter.

A numpy copy of modflow6_tpu/utils/mf5to6.py, which writes the same files
byte for byte.  Behavioral parity target: the reference's standalone
converter (utils/mf5to6/) for its core conversion path — NAM + DIS + BAS6
+ LPF/UPW + WEL/DRN/RIV/GHB/CHD + RCH + EVT + basic SFR2 + stress periods
→ an MF6 workspace (mfsim.nam, TDIS, GWF nam, DIS6/IC6/NPF6/STO6/CHD6/
WEL6/DRN6/RIV6/GHB6/EVT6/RCH6/SFR6/IMS/OC).  MF2005 constant-head cells
(IBOUND<0) become CHD entries at the starting head, LAYTYP>0 becomes
ICELLTYPE 1 + NEWTON for UPW, and transient periods carry SS/SY from LPF.

Scope: free-format decks with U2DREL/U2DINT control records CONSTANT /
INTERNAL / OPEN/CLOSE; fixed-format relics raise with a clear message.

Run as ``python -m modflow6_torch.utils.mf5to6 <mf2005.nam> <outdir>``.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def _tokens(line):
    line = line.split("#")[0]
    return line.replace(",", " ").split()


def _read_lines(path):
    with open(path) as f:
        return [ln.rstrip("\n") for ln in f
                if _tokens(ln) and not ln.lstrip().startswith("#")]


def _read_array(lines, i, shape, base_dir, dtype=float):
    """U2DREL/U2DINT-lite: CONSTANT / INTERNAL / OPEN/CLOSE."""
    toks = _tokens(lines[i])
    kw = toks[0].upper()
    n = int(np.prod(shape))
    if kw == "CONSTANT":
        return np.full(shape, dtype(toks[1])), i + 1
    if kw == "INTERNAL":
        cnst = dtype(toks[1]) if len(toks) > 1 else dtype(1)
        vals = []
        j = i + 1
        while len(vals) < n:
            vals.extend(dtype(t) for t in _tokens(lines[j]))
            j += 1
        return np.asarray(vals[:n]).reshape(shape) * cnst, j
    if kw == "OPEN/CLOSE":
        arr = np.loadtxt(os.path.join(base_dir, toks[1]),
                         dtype=dtype).reshape(shape)
        cnst = dtype(toks[2]) if len(toks) > 2 else dtype(1)
        return arr * cnst, i + 1
    raise NotImplementedError(
        f"mf5to6: array control record {kw!r} (fixed-format U2DREL?) "
        "not supported — convert the deck to free format first")


def _parse_nam(path):
    base = os.path.dirname(os.path.abspath(path))
    files = {}
    for ln in _read_lines(path):
        toks = _tokens(ln)
        ftype = toks[0].upper()
        files.setdefault(ftype, []).append(os.path.join(base, toks[2]))
    return files, base


def _parse_dis(path, base):
    lines = _read_lines(path)
    toks = _tokens(lines[0])
    nlay, nrow, ncol, nper = (int(t) for t in toks[:4])
    i = 1
    # LAYCBD flags (quasi-3d confining beds unsupported)
    laycbd = []
    while len(laycbd) < nlay:
        laycbd.extend(int(t) for t in _tokens(lines[i]))
        i += 1
    if any(laycbd):
        raise NotImplementedError("mf5to6: quasi-3D confining beds "
                                  "(LAYCBD≠0) are not convertible")
    delr, i = _read_array(lines, i, (ncol,), base)
    delc, i = _read_array(lines, i, (nrow,), base)
    top, i = _read_array(lines, i, (nrow, ncol), base)
    botm = np.zeros((nlay, nrow, ncol))
    for k in range(nlay):
        botm[k], i = _read_array(lines, i, (nrow, ncol), base)
    periods = []
    for _ in range(nper):
        t = _tokens(lines[i])
        periods.append((float(t[0]), int(t[1]), float(t[2]),
                        t[3].upper() if len(t) > 3 else "TR"))
        i += 1
    return dict(nlay=nlay, nrow=nrow, ncol=ncol, nper=nper, delr=delr,
                delc=delc, top=top, botm=botm, periods=periods)


def _parse_bas(path, base, dis):
    lines = _read_lines(path)
    i = 0
    if _tokens(lines[0])[0].upper() in ("FREE", "XSECTION") or \
            "FREE" in [t.upper() for t in _tokens(lines[0])]:
        i = 1
    shp = (dis["nrow"], dis["ncol"])
    ibound = np.zeros((dis["nlay"],) + shp, int)
    for k in range(dis["nlay"]):
        ibound[k], i = _read_array(lines, i, shp, base, dtype=int)
    hnoflo = float(_tokens(lines[i])[0])
    i += 1
    strt = np.zeros((dis["nlay"],) + shp)
    for k in range(dis["nlay"]):
        strt[k], i = _read_array(lines, i, shp, base)
    return dict(ibound=ibound, hnoflo=hnoflo, strt=strt)


def _parse_lpf(path, base, dis, upw=False):
    lines = _read_lines(path)
    i = 1                                   # ILPFCB HDRY NPLPF [options]
    nlay = dis["nlay"]
    laytyp = []
    while len(laytyp) < nlay:
        laytyp.extend(int(t) for t in _tokens(lines[i]))
        i += 1
    i += 3                                  # LAYAVG, CHANI, LAYVKA rows
    laywet = []
    while len(laywet) < nlay:
        laywet.extend(int(t) for t in _tokens(lines[i]))
        i += 1
    if any(laywet):
        i += 1                              # WETFCT IWETIT IHDWET
    shp = (dis["nrow"], dis["ncol"])
    hk = np.zeros((nlay,) + shp)
    vka = np.zeros((nlay,) + shp)
    ss = np.full((nlay,) + shp, 1e-5)
    sy = np.full((nlay,) + shp, 0.15)
    transient = any(p[3] == "TR" for p in dis["periods"])
    for k in range(nlay):
        hk[k], i = _read_array(lines, i, shp, base)
        vka[k], i = _read_array(lines, i, shp, base)
        if transient:
            ss[k], i = _read_array(lines, i, shp, base)
            if laytyp[k] != 0:
                sy[k], i = _read_array(lines, i, shp, base)
        if any(laywet) and laytyp[k] != 0:
            i += 1                          # WETDRY array: skip control?
    return dict(laytyp=laytyp, hk=hk, vka=vka, ss=ss, sy=sy, upw=upw)


def _parse_list(path, ncols):
    """Shared MF2005 list-package reader (WEL/DRN/RIV/GHB/CHD layout:
    MXACT line, then per period ITMP and ITMP rows of k i j values;
    ITMP<0 repeats the previous period — the reference's ULSTRD role)."""
    lines = _read_lines(path)
    i = 1
    periods = {}
    kper = 0
    while i < len(lines):
        t = _tokens(lines[i])
        itmp = int(t[0])
        i += 1
        kper += 1
        if itmp < 0:
            if kper > 1 and (kper - 1) in periods:
                periods[kper] = periods[kper - 1]
            continue
        ent = []
        for _ in range(itmp):
            t = _tokens(lines[i])
            ent.append((int(t[0]), int(t[1]), int(t[2]),
                        *[float(v) for v in t[3:3 + ncols]]))
            i += 1
        periods[kper] = ent
    return periods


def _parse_wel(path, base, dis):
    return _parse_list(path, 1)


def _parse_evt(path, base, dis):
    """EVT package (NEVTOP=1/3): per period INSURF INEVTR INEXDP flags
    with SURF/EVTR/EXDP U2DREL arrays (negative flag reuses previous)."""
    lines = _read_lines(path)
    i = 1                                   # NEVTOP IEVTCB
    shp = (dis["nrow"], dis["ncol"])
    periods = {}
    kper = 0
    surf = evtr = exdp = None
    while i < len(lines):
        flags = [int(v) for v in _tokens(lines[i])[:3]]
        i += 1
        kper += 1
        if flags[0] >= 0:
            surf, i = _read_array(lines, i, shp, base)
        if flags[1] >= 0:
            evtr, i = _read_array(lines, i, shp, base)
        if flags[2] >= 0:
            exdp, i = _read_array(lines, i, shp, base)
        periods[kper] = (surf.copy(), evtr.copy(), exdp.copy())
    return periods


def _parse_rch(path, base, dis):
    lines = _read_lines(path)
    i = 1                                   # NRCHOP IRCHCB
    shp = (dis["nrow"], dis["ncol"])
    periods = {}
    kper = 0
    while i < len(lines):
        inrech = int(_tokens(lines[i])[0])
        i += 1
        kper += 1
        if inrech < 0:
            continue
        arr, i = _read_array(lines, i, shp, base)
        periods[kper] = arr
    return periods


def _parse_sfr2(path, base, dis):
    """Basic SFR2 reader (the converter's common path): dataset 1c
    (NSTRM NSS ...), ISFROPT=1 reach data (KRCH IRCH JRCH ISEG IREACH
    RCHLEN STRTOP SLOPE STRTHICK STRHC1), per-period dataset 6a segment
    records with ICALC=1 Manning rectangular channels (FLOW ROUGHCH +
    6b/6c WIDTH1/WIDTH2).  Covers the utils/mf5to6 SfrPackageWriter core
    case; exotic ICALC/ISFROPT variants raise."""
    lines = _read_lines(path)
    t = _tokens(lines[0])
    nstrm, nss = abs(int(t[0])), int(t[1])
    isfropt = 0
    if int(t[0]) < 0 and len(t) > 8:
        isfropt = int(t[8])
    if isfropt not in (0, 1):
        raise NotImplementedError(f"mf5to6: SFR2 ISFROPT={isfropt}")
    i = 1
    reaches = []
    for _ in range(nstrm):
        rt = _tokens(lines[i])
        r = dict(k=int(rt[0]), i=int(rt[1]), j=int(rt[2]),
                 iseg=int(rt[3]), ireach=int(rt[4]), rchlen=float(rt[5]))
        if isfropt == 1:
            r.update(strtop=float(rt[6]), slope=float(rt[7]),
                     strthick=float(rt[8]), strhc1=float(rt[9]))
        else:
            r.update(strtop=0.0, slope=1e-3, strthick=1.0, strhc1=0.0)
        reaches.append(r)
        i += 1
    # dataset 5 + 6a/6b/6c for period 1 (later periods: reuse)
    itmp = int(_tokens(lines[i])[0])
    i += 1
    segs = {}
    for _ in range(max(itmp, 0)):
        st = _tokens(lines[i])
        nseg, icalc, outseg = int(st[0]), int(st[1]), int(st[2])
        if icalc != 1:
            raise NotImplementedError(f"mf5to6: SFR2 ICALC={icalc}")
        iupseg = int(st[3])
        flow = float(st[4])
        rough = float(st[8]) if len(st) > 8 else 0.03
        i += 1
        width1 = float(_tokens(lines[i])[0])
        i += 1
        width2 = float(_tokens(lines[i])[0])
        i += 1
        segs[nseg] = dict(outseg=outseg, iupseg=iupseg, flow=flow,
                          rough=rough, width=0.5 * (width1 + width2))
    return reaches, segs


def _w(ws, name, text):
    with open(os.path.join(ws, name), "w") as f:
        f.write(text.strip("\n") + "\n")


def _arr_lines(a, fmt="{:.8g}"):
    a = np.asarray(a)
    if a.ndim == 1:
        a = a[None, :]
    # Python numbers format as numpy's do (np.float64 formats through
    # float.__format__), without a numpy scalar per value
    put = fmt.format
    return "\n".join("      " + " ".join(map(put, row))
                     for row in a.tolist())


def convert(nam_path, outdir, model_name="mf5"):
    """Convert one MODFLOW-2005 nam file into an MF6 workspace."""
    files, base = _parse_nam(nam_path)
    if "DIS" not in files:
        raise ValueError("mf5to6: the nam file lists no DIS package")
    dis = _parse_dis(files["DIS"][0], base)
    bas = _parse_bas(files["BAS6"][0], base, dis)
    if "LPF" in files:
        lpf = _parse_lpf(files["LPF"][0], base, dis)
    elif "UPW" in files:
        lpf = _parse_lpf(files["UPW"][0], base, dis, upw=True)
    else:
        raise NotImplementedError("mf5to6: needs LPF or UPW (BCF is not "
                                  "convertible yet)")
    wel = _parse_wel(files["WEL"][0], base, dis) if "WEL" in files else {}
    rch = _parse_rch(files["RCH"][0], base, dis) if "RCH" in files else {}
    drn = _parse_list(files["DRN"][0], 2) if "DRN" in files else {}
    riv = _parse_list(files["RIV"][0], 3) if "RIV" in files else {}
    ghb = _parse_list(files["GHB"][0], 2) if "GHB" in files else {}
    chd_list = _parse_list(files["CHD"][0], 2) if "CHD" in files else {}
    evt = _parse_evt(files["EVT"][0], base, dis) if "EVT" in files else {}
    sfr = _parse_sfr2(files["SFR"][0], base, dis) if "SFR" in files else None

    os.makedirs(outdir, exist_ok=True)
    m = model_name
    nlay, nrow, ncol = dis["nlay"], dis["nrow"], dis["ncol"]

    _w(outdir, "mfsim.nam", f"""
BEGIN OPTIONS
END OPTIONS
BEGIN TIMING
  TDIS6 {m}.tdis
END TIMING
BEGIN MODELS
  GWF6 {m}.nam {m}
END MODELS
BEGIN SOLUTIONGROUP 1
  IMS6 {m}.ims {m}
END SOLUTIONGROUP
""")
    pdata = "\n".join(f"  {p[0]} {p[1]} {p[2]}" for p in dis["periods"])
    _w(outdir, f"{m}.tdis", f"""
BEGIN OPTIONS
END OPTIONS
BEGIN DIMENSIONS
  NPER {dis['nper']}
END DIMENSIONS
BEGIN PERIODDATA
{pdata}
""" + "END PERIODDATA")
    newton = "\n  NEWTON" if lpf["upw"] else ""
    transient = any(p[3] == "TR" for p in dis["periods"])
    sto_line = f"  STO6 {m}.sto\n" if transient else ""
    wel_line = f"  WEL6 {m}.wel\n" if wel else ""
    rch_line = f"  RCH6 {m}.rch\n" if rch else ""
    for nm, data in (("drn", drn), ("riv", riv), ("ghb", ghb),
                     ("evt", evt)):
        if data:
            wel_line += f"  {nm.upper()}6 {m}.{nm}\n"
    if sfr is not None:
        wel_line += f"  SFR6 {m}.sfr\n"
    _w(outdir, f"{m}.nam", f"""
BEGIN OPTIONS{newton}
END OPTIONS
BEGIN PACKAGES
  DIS6 {m}.dis
  IC6 {m}.ic
  NPF6 {m}.npf
{sto_line}{wel_line}{rch_line}  CHD6 {m}.chd
  OC6 {m}.oc
END PACKAGES
""")
    # IDOMAIN from IBOUND==0; CHD from IBOUND<0 at STRT
    idom = (bas["ibound"] != 0).astype(int)
    botm_lines = "\n".join("    INTERNAL\n" + _arr_lines(dis["botm"][k])
                           for k in range(nlay))
    idom_lines = "\n".join("    INTERNAL\n"
                           + _arr_lines(idom[k], "{:d}")
                           for k in range(nlay))
    _w(outdir, f"{m}.dis", f"""
BEGIN OPTIONS
END OPTIONS
BEGIN DIMENSIONS
  NLAY {nlay}
  NROW {nrow}
  NCOL {ncol}
END DIMENSIONS
BEGIN GRIDDATA
  DELR
    INTERNAL
{_arr_lines(dis['delr'])}
  DELC
    INTERNAL
{_arr_lines(dis['delc'])}
  TOP
    INTERNAL
{_arr_lines(dis['top'])}
  BOTM LAYERED
{botm_lines}
  IDOMAIN LAYERED
{idom_lines}
END GRIDDATA
""")
    strt_lines = "\n".join("    INTERNAL\n" + _arr_lines(bas["strt"][k])
                           for k in range(nlay))
    _w(outdir, f"{m}.ic", f"""
BEGIN OPTIONS
END OPTIONS
BEGIN GRIDDATA
  STRT LAYERED
{strt_lines}
END GRIDDATA
""")
    ict = np.array([1 if lt != 0 else 0 for lt in lpf["laytyp"]])
    hk_lines = "\n".join("    INTERNAL\n" + _arr_lines(lpf["hk"][k])
                         for k in range(nlay))
    vk_lines = "\n".join("    INTERNAL\n" + _arr_lines(lpf["vka"][k])
                         for k in range(nlay))
    ict_lines = "\n".join(f"    CONSTANT {v}" for v in ict)
    _w(outdir, f"{m}.npf", f"""
BEGIN OPTIONS
END OPTIONS
BEGIN GRIDDATA
  ICELLTYPE LAYERED
{ict_lines}
  K LAYERED
{hk_lines}
  K33 LAYERED
{vk_lines}
END GRIDDATA
""")
    if transient:
        ss_lines = "\n".join("    INTERNAL\n" + _arr_lines(lpf["ss"][k])
                             for k in range(nlay))
        sy_lines = "\n".join("    INTERNAL\n" + _arr_lines(lpf["sy"][k])
                             for k in range(nlay))
        icv_lines = "\n".join(f"    CONSTANT {v}" for v in ict)
        per_blocks = "\n".join(
            f"BEGIN PERIOD {k + 1}\n  "
            + ("TRANSIENT" if p[3] == "TR" else "STEADY-STATE")
            + "\nEND PERIOD"
            for k, p in enumerate(dis["periods"]))
        _w(outdir, f"{m}.sto", f"""
BEGIN OPTIONS
END OPTIONS
BEGIN GRIDDATA
  ICONVERT LAYERED
{icv_lines}
  SS LAYERED
{ss_lines}
  SY LAYERED
{sy_lines}
END GRIDDATA
{per_blocks}
""")
    # CHD entries from IBOUND<0 (the converter's ChdObsWriter role) +
    # the CHD list package (shead used; MF6 has one head per entry)
    chd = [(k + 1, i + 1, j + 1, bas["strt"][k, i, j])
           for k, i, j in zip(*np.where(bas["ibound"] < 0))]
    chd_periods = {1: list(chd)}
    for kper, ent in chd_list.items():
        rows = chd_periods.setdefault(kper, list(chd))
        rows += [(k, i, j, shead) for k, i, j, shead, _ehead in ent]
    mxc = max(max((len(v) for v in chd_periods.values()), default=0), 1)
    blocks = []
    for kper in sorted(chd_periods):
        rows = "\n".join(f"  {k} {i} {j} {h}"
                          for k, i, j, h in chd_periods[kper])
        blocks.append(f"BEGIN PERIOD {kper}\n{rows}\nEND PERIOD")
    _w(outdir, f"{m}.chd", "BEGIN OPTIONS\nEND OPTIONS\n"
       f"BEGIN DIMENSIONS\n  MAXBOUND {mxc}\nEND DIMENSIONS\n"
       + "\n".join(blocks))
    for nm, data in (("drn", drn), ("riv", riv), ("ghb", ghb)):
        if not data:
            continue
        mx = max(len(v) for v in data.values())
        blocks = []
        for kper in sorted(data):
            rows = "\n".join(
                "  " + " ".join(str(v) for v in row)
                for row in data[kper])
            blocks.append(f"BEGIN PERIOD {kper}\n{rows}\nEND PERIOD")
        _w(outdir, f"{m}.{nm}", "BEGIN OPTIONS\nEND OPTIONS\n"
           f"BEGIN DIMENSIONS\n  MAXBOUND {mx}\nEND DIMENSIONS\n"
           + "\n".join(blocks))
    if evt:
        nrowc = dis["nrow"] * dis["ncol"]
        blocks = []
        for kper in sorted(evt):
            surf, evtr, exdp = evt[kper]
            rows = "\n".join(
                f"  1 {i + 1} {j + 1} {surf[i, j]} {evtr[i, j]} "
                f"{exdp[i, j]}"
                for i in range(dis["nrow"]) for j in range(dis["ncol"]))
            blocks.append(f"BEGIN PERIOD {kper}\n{rows}\nEND PERIOD")
        _w(outdir, f"{m}.evt", "BEGIN OPTIONS\nEND OPTIONS\n"
           f"BEGIN DIMENSIONS\n  MAXBOUND {nrowc}\nEND DIMENSIONS\n"
           + "\n".join(blocks))
    if wel:
        mx = max(len(v) for v in wel.values())
        blocks = []
        for kper in sorted(wel):
            rows = "\n".join(f"  {k} {i} {j} {q}"
                             for k, i, j, q in wel[kper])
            blocks.append(f"BEGIN PERIOD {kper}\n{rows}\nEND PERIOD")
        _w(outdir, f"{m}.wel", "BEGIN OPTIONS\nEND OPTIONS\n"
           f"BEGIN DIMENSIONS\n  MAXBOUND {mx}\nEND DIMENSIONS\n"
           + "\n".join(blocks))
    if rch:
        blocks = []
        for kper in sorted(rch):
            blocks.append(f"BEGIN PERIOD {kper}\n  RECHARGE\n    INTERNAL\n"
                          + _arr_lines(rch[kper]) + "\nEND PERIOD")
        _w(outdir, f"{m}.rch", "BEGIN OPTIONS\n  READASARRAYS\n"
           "END OPTIONS\n" + "\n".join(blocks))
    if sfr is not None:
        reaches, segs = sfr
        order = sorted(range(len(reaches)),
                       key=lambda r: (reaches[r]["iseg"],
                                      reaches[r]["ireach"]))
        rid = {idx: n + 1 for n, idx in enumerate(order)}
        seg_first = {}
        seg_last = {}
        for idx in order:
            r = reaches[idx]
            seg_first.setdefault(r["iseg"], rid[idx])
            seg_last[r["iseg"]] = rid[idx]
        pd, cd, per = [], [], []
        down_of = {}
        for idx in order:
            r = reaches[idx]
            n = rid[idx]
            seg = segs.get(r["iseg"], dict(rough=0.03, width=5.0,
                                           outseg=0, flow=0.0))
            # downstream link: next reach of the segment, else the
            # outseg's first reach
            if rid[idx] != seg_last[r["iseg"]]:
                down_of[n] = n + 1
            elif seg.get("outseg", 0) > 0:
                down_of[n] = seg_first[seg["outseg"]]
            pd.append(
                f"  {n} {r['k']} {r['i']} {r['j']} {r['rchlen']} "
                f"{seg['width']} {r['slope']} {r['strtop']} "
                f"{r['strthick']} {r['strhc1']} {seg['rough']} "
                f"NCON {1.0} 0")
        # connection counts + rows
        ups_of = {}
        for n, d in down_of.items():
            ups_of.setdefault(d, []).append(n)
        rows = []
        for idx in order:
            n = rid[idx]
            conns = [str(u) for u in ups_of.get(n, [])]
            if n in down_of:
                conns.append(str(-down_of[n]))
            rows.append("  " + " ".join([str(n)] + conns))
            pd[n - 1] = pd[n - 1].replace("NCON", str(len(conns)))
        for iseg, seg in segs.items():
            if seg.get("iupseg", 0) == 0 and seg.get("flow", 0.0) != 0.0:
                per.append(f"  {seg_first[iseg]} INFLOW {seg['flow']}")
        _w(outdir, f"{m}.sfr", "BEGIN OPTIONS\nEND OPTIONS\n"
           f"BEGIN DIMENSIONS\n  NREACHES {len(pd)}\nEND DIMENSIONS\n"
           "BEGIN PACKAGEDATA\n" + "\n".join(pd) + "\nEND PACKAGEDATA\n"
           "BEGIN CONNECTIONDATA\n" + "\n".join(rows)
           + "\nEND CONNECTIONDATA\n"
           "BEGIN PERIOD 1\n" + "\n".join(per) + "\nEND PERIOD")
    _w(outdir, f"{m}.oc", f"""
BEGIN OPTIONS
  HEAD FILEOUT {m}.hds
  BUDGET FILEOUT {m}.cbc
END OPTIONS
BEGIN PERIOD 1
  SAVE HEAD ALL
  SAVE BUDGET ALL
END PERIOD
""")
    _w(outdir, f"{m}.ims", """
BEGIN OPTIONS
END OPTIONS
BEGIN NONLINEAR
  OUTER_DVCLOSE 1.0e-6
  OUTER_MAXIMUM 100
END NONLINEAR
BEGIN LINEAR
  INNER_MAXIMUM 300
  INNER_DVCLOSE 1.0e-8
  INNER_RCLOSE 1.0e-6
  LINEAR_ACCELERATION BICGSTAB
END LINEAR
""")
    return outdir


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: python -m modflow6_torch.utils.mf5to6 "
              "<mf2005.nam> <outdir>", file=sys.stderr)
        return 2
    convert(argv[0], argv[1])
    print(f"mf5to6: wrote MF6 workspace to {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
