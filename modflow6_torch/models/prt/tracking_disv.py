"""Particle tracking on DISV polygonal-prism grids (the ternary method).

Port of modflow6_tpu/models/prt/tracking_disv.py (reference
MethodCellTernary, TernarySolveTrack.f90 and MethodDisv.f90): each polygon
is fanned into triangles from its centroid; the internal fluxes of the fan
keep every triangle in mass balance; within a triangle the velocity is the
lowest-order Raviart–Thomas field v(x) = c·x + d with a scalar c, so the
signed distance to each edge line moves like a Pollock axis and the exit
time through it has the closed form log1p(c·(−φ0)/ν0)/c.

``build_fan`` and ``locate``, loops over the cells, their sides, the
topology's edges and the particles in the reference, are array code whose
arrays equal the loops'.  ``locate`` tests each particle against the cells
whose bounding boxes hold it (a bucket grid over the mesh), and keeps the
first (cell, triangle) in the reference's search order.  The tracker is
one masked batch loop over the particles (``tracking.run_batch``), as on
DIS.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .tracking import ACTIVE, TERM_BOUNDARY, TERM_TIMEOUT, TERM_WEAK, run_batch

DINF = float("inf")
_EPS = 1e-30

__all__ = ["ACTIVE", "TERM_BOUNDARY", "TERM_TIMEOUT", "TERM_WEAK", "DisvFan",
           "build_fan", "fan_fluxes", "make_tracker_disv", "locate"]


@dataclasses.dataclass(frozen=True)
class DisvFan:
    """Triangle-fan geometry and edge bookkeeping of a DISV grid: the side
    arrays (ncpl, maxv) padded per side; ``edge3d`` maps (lay, cell, side)
    to the flow edge (−1 at boundaries and padding)."""

    px: torch.Tensor        # f64[ncpl, maxv] side start vertex x
    py: torch.Tensor
    qx: torch.Tensor        # f64[ncpl, maxv] side end vertex x
    qy: torch.Tensor
    cx: torch.Tensor        # f64[ncpl] centroid
    cy: torch.Tensor
    tri_area: torch.Tensor  # f64[ncpl, maxv]
    nact: torch.Tensor      # i64[ncpl] side count
    valid: torch.Tensor     # bool[ncpl, maxv]
    nbr_cell: torch.Tensor  # i64[ncpl, maxv] neighbour cell (−1 none)
    nbr_tri: torch.Tensor   # i64[ncpl, maxv] matching side in the neighbour
    edge3d: torch.Tensor    # i64[nlay, ncpl, maxv]
    edge_sign: torch.Tensor  # f64[nlay, ncpl, maxv] outflow = sign·q_nm
    cell_area: torch.Tensor  # f64[ncpl]
    topz: torch.Tensor      # f64[nlay, ncpl]
    botz: torch.Tensor
    porosity: torch.Tensor  # f64[nlay, ncpl]
    active_cell: torch.Tensor  # bool[nlay, ncpl]
    vedge_up: torch.Tensor  # i64[nlay, ncpl] edge toward the layer above
    vedge_dn: torch.Tensor  # i64[nlay, ncpl] edge toward the layer below
    vsign_up: torch.Tensor  # f64: outflow across the top = sign·q_nm
    vsign_dn: torch.Tensor
    ncpl: int = 0
    nlay: int = 0
    maxv: int = 0


def _rings(grid):
    """Each cell's vertex ring without a closing duplicate, turned
    counterclockwise, grouped by vertex count: [(cells, ids [n_k, k])]."""
    verts = np.asarray(grid.vertices, np.float64)
    iavert, javert = np.asarray(grid.iavert), np.asarray(grid.javert)
    nv = np.diff(iavert)
    last = javert[np.maximum(iavert[1:] - 1, 0)]
    closed = (nv > 1) & (javert[np.minimum(iavert[:-1], javert.size - 1)]
                         == last)
    nv = nv - closed
    groups = []
    for k in np.unique(nv):
        cells = np.nonzero(nv == k)[0]
        ring = javert[iavert[cells][:, None] + np.arange(k)]
        pts = verts[ring]
        area2 = np.sum(pts[:, :, 0] * np.roll(pts[:, :, 1], -1, axis=1)
                       - np.roll(pts[:, :, 0], -1, axis=1) * pts[:, :, 1],
                       axis=1)
        ring = np.where((area2 < 0)[:, None], ring[:, ::-1], ring)
        groups.append((cells, ring))
    return groups


def build_fan(grid, topo, porosity, device=None) -> DisvFan:
    """The fan of a DisvGrid and its Topology (host array code)."""
    ncpl, nlay = grid.ncpl, grid.nlay
    verts = np.asarray(grid.vertices, np.float64)
    groups = _rings(grid)
    maxv = int(max(r.shape[1] for _, r in groups))

    px = np.zeros((ncpl, maxv))
    py = np.zeros((ncpl, maxv))
    qx = np.ones((ncpl, maxv))   # nonzero padding avoids 0-length sides
    qy = np.zeros((ncpl, maxv))
    tri_area = np.full((ncpl, maxv), 1.0)
    valid = np.zeros((ncpl, maxv), bool)
    nact = np.zeros(ncpl, np.int64)
    cxa = np.zeros(ncpl)
    cya = np.zeros(ncpl)
    cell_area = np.zeros(ncpl)
    side_a = np.full((ncpl, maxv), -1, np.int64)
    side_b = np.full((ncpl, maxv), -1, np.int64)
    for cells, ring in groups:
        k = ring.shape[1]
        nact[cells] = k
        pts = verts[ring]
        x0, y0 = pts[:, :, 0], pts[:, :, 1]
        x1, y1 = np.roll(x0, -1, axis=1), np.roll(y0, -1, axis=1)
        cross = x0 * y1 - x1 * y0
        A = 0.5 * np.sum(cross, axis=1)
        cell_area[cells] = A
        cx = np.sum((x0 + x1) * cross, axis=1) / (6.0 * A)
        cy = np.sum((y0 + y1) * cross, axis=1) / (6.0 * A)
        cxa[cells], cya[cells] = cx, cy
        a, b = ring, np.roll(ring, -1, axis=1)
        ax, ay = verts[a, 0], verts[a, 1]
        bx, by = verts[b, 0], verts[b, 1]
        px[cells, :k], py[cells, :k] = ax, ay
        qx[cells, :k], qy[cells, :k] = bx, by
        tri_area[cells, :k] = 0.5 * np.abs(
            (bx - ax) * (cy[:, None] - ay) - (cx[:, None] - ax) * (by - ay))
        valid[cells, :k] = True
        side_a[cells, :k], side_b[cells, :k] = a, b

    # sides shared by exactly two (cell, side) entries are neighbours
    c_of, i_of = np.nonzero(valid)            # (cell, side) in loop order
    lo = np.minimum(side_a[c_of, i_of], side_b[c_of, i_of])
    hi = np.maximum(side_a[c_of, i_of], side_b[c_of, i_of])
    order = np.lexsort((hi, lo))
    lo, hi, c_s, i_s = lo[order], hi[order], c_of[order], i_of[order]
    new = np.ones(lo.size, bool)
    new[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    start = np.flatnonzero(new)
    count = np.diff(np.append(start, lo.size))
    two = start[count == 2]
    nbr_cell = np.full((ncpl, maxv), -1, np.int64)
    nbr_tri = np.full((ncpl, maxv), -1, np.int64)
    c1, i1, c2, i2 = c_s[two], i_s[two], c_s[two + 1], i_s[two + 1]
    nbr_cell[c1, i1], nbr_tri[c1, i1] = c2, i2
    nbr_cell[c2, i2], nbr_tri[c2, i2] = c1, i1

    # the topology's edges on the fan's sides and the vertical faces
    edge3d = np.full((nlay, ncpl, maxv), -1, np.int64)
    edge_sign = np.zeros((nlay, ncpl, maxv))
    vedge_up = np.full((nlay, ncpl), -1, np.int64)
    vedge_dn = np.full((nlay, ncpl), -1, np.int64)
    vsign_up = np.zeros((nlay, ncpl))
    vsign_dn = np.zeros((nlay, ncpl))
    en = np.asarray(topo.edge_n, np.int64)
    em = np.asarray(topo.edge_m, np.int64)
    ihc = np.asarray(topo.ihc)
    e_all = np.arange(en.shape[0], dtype=np.int64)
    ln, cn = np.divmod(en, ncpl)
    lm, cm = np.divmod(em, ncpl)
    # vertical: the upper cell's downward outflow is q_nm (+1), the lower
    # cell's upward outflow −q_nm (−1); a later edge of a face wins
    v = ihc == 0
    vedge_dn[ln[v], cn[v]] = e_all[v]
    vsign_dn[ln[v], cn[v]] = 1.0
    vedge_up[lm[v], cm[v]] = e_all[v]
    vsign_up[lm[v], cm[v]] = -1.0
    h = (ihc != 0) & (ln == lm)              # staggered edges are skipped
    e, ln, cn, cm = e_all[h], ln[h], cn[h], cm[h]
    match = ((nbr_cell[cn] == cm[:, None])
             & (np.arange(maxv)[None, :] < nact[cn][:, None]))
    found = match.any(axis=1)
    if not found.all():
        bad = np.flatnonzero(~found)[0]
        raise ValueError(f"DISV edge {en[h][bad]}-{em[h][bad]} has no "
                         "shared polygon side")
    i = np.argmax(match, axis=1)
    j = nbr_tri[cn, i]
    edge3d[ln, cn, i] = e
    edge_sign[ln, cn, i] = 1.0     # outflow n→m = q_nm
    edge3d[ln, cm, j] = e          # the same layer: ln == lm here
    edge_sign[ln, cm, j] = -1.0

    tops = np.concatenate([np.asarray(grid.top_surf)[None],
                           np.asarray(grid.botm)[:-1]], axis=0)

    def t(a):
        return torch.as_tensor(a, device=device)

    return DisvFan(
        px=t(px), py=t(py), qx=t(qx), qy=t(qy), cx=t(cxa), cy=t(cya),
        tri_area=t(tri_area), nact=t(nact), valid=t(valid),
        nbr_cell=t(nbr_cell), nbr_tri=t(nbr_tri), edge3d=t(edge3d),
        edge_sign=t(edge_sign), cell_area=t(cell_area),
        topz=t(tops), botz=t(np.asarray(grid.botm, np.float64)),
        porosity=t(np.asarray(porosity, np.float64).reshape(nlay, ncpl)),
        active_cell=t(np.asarray(grid.idomain).reshape(nlay, ncpl) > 0),
        vedge_up=t(vedge_up), vedge_dn=t(vedge_dn), vsign_up=t(vsign_up),
        vsign_dn=t(vsign_dn), ncpl=ncpl, nlay=nlay, maxv=maxv)


def fan_fluxes(fan: DisvFan, q_edge):
    """Per step: the outer sides' outflows, the vertical outflows per
    triangle and the fan's internal chain (the subcell mass balance).
    Returns (Qout, u, qzt, qzb), each [nlay, ncpl, maxv]; ``u[l, c, i]``
    is the flux from triangle i into triangle i+1."""
    q_nm = -q_edge      # q_edge is positive into edge_n
    qpad = torch.cat([q_nm, q_nm.new_zeros(1)])
    Qout = qpad[fan.edge3d] * fan.edge_sign
    Qout = torch.where(fan.valid[None], Qout, 0.0)
    qz_up = qpad[fan.vedge_up] * fan.vsign_up
    qz_dn = qpad[fan.vedge_dn] * fan.vsign_dn
    share = torch.where(fan.valid, fan.tri_area / fan.cell_area[:, None], 0.0)
    qzt = qz_up[:, :, None] * share[None]
    qzb = qz_dn[:, :, None] * share[None]
    # the residual divergence (sinks, sources, storage) enters the chain as
    # an area-share term, so it telescopes; the vertical faces do not:
    # the field's divergence c carries a sink, so strong sinks trap
    resid = Qout.sum(dim=2) + qz_up + qz_dn
    t_out = Qout + qzt + qzb - resid[:, :, None] * share[None]
    cums = torch.cumsum(torch.where(fan.valid[None], t_out, 0.0), dim=2)
    nact = torch.clamp(fan.nact, min=1).to(cums.dtype)
    mean = torch.where(fan.valid[None], cums, 0.0).sum(dim=2) / nact[None]
    u = -(cums - mean[:, :, None])
    return Qout, u, qzt, qzb


def _edge_exit(c, q, nux, nuy, bx, by, x, y, band):
    """Exit time through the line n·x = b from inside for the field
    v = c·x + d; a particle within ``band`` of the edge with the flow
    pointing out leaves at once.

    The rate of φ = n·x − b at the particle is ν0 = c·φ0 + q, with q the
    edge's outward flux (per unit thickness, over the porosity): the
    reference's n·(c·x + d) rewritten, since n·d = q − c·b for the RT0
    field.  This form is exact where the edge carries no flux (ν0 = c·φ0,
    so c·(−φ0)/ν0 = −1 and the edge is never reached); the reference's
    form leaves that tie to the rounding of its fused multiply-adds."""
    phi0 = nux * x + nuy * y - (nux * bx + nuy * by)
    nu0 = c * phi0 + q
    ok = (nu0 > 0) & (phi0 < band)
    lin = c.abs() * phi0.abs() < 1e-12 * (nu0.abs() + _EPS)
    c_safe = torch.where(c != 0, c, 1.0)
    nu_safe = torch.where(nu0 != 0, nu0, 1.0)
    rel = c * (-phi0) / nu_safe
    t = torch.where(lin, -phi0 / nu_safe,
                    torch.log1p(torch.clamp(rel, min=-1.0 + _EPS)) / c_safe)
    t = torch.where(phi0 >= 0, 0.0, t)
    return torch.where(ok & (rel > -1.0) & (t >= 0), t, DINF)


def make_tracker_disv(fan: DisvFan, max_transitions: int = 8192):
    """track(x, y, z, lay, cell, tri, Qout, u, qzt, qzb, sat, tmax) → the
    final state dict over the particle axis; ``sat`` [nlay, ncpl]."""
    nlay = fan.nlay

    def tracker(Qout, u, qzt, qzb, sat):
        def body(st):
            x, y, z = st["x"], st["y"], st["z"]
            lay, cell, tri, trem = st["lay"], st["cell"], st["tri"], st["trem"]
            k = fan.nact[cell]
            tri_n = (tri + 1) % k
            tri_p = (tri + k - 1) % k
            ztop = fan.topz[lay, cell]
            zbot = fan.botz[lay, cell]
            dz = torch.clamp(ztop - zbot, min=_EPS)
            theta = fan.porosity[lay, cell]
            satf = torch.clamp(sat[lay, cell], min=1e-8)
            hvol = dz * theta * satf           # horizontal flux→velocity
            A = fan.tri_area[cell, tri]

            # the triangle: P (side start), Q (side end), C (centroid)
            Px, Py = fan.px[cell, tri], fan.py[cell, tri]
            Qx, Qy = fan.qx[cell, tri], fan.qy[cell, tri]
            Cx, Cy = fan.cx[cell], fan.cy[cell]

            # outward fluxes per unit thickness: outer edge P→Q Qout,
            # internal Q→C u_i, internal C→P −u_{i−1}
            q1 = Qout[lay, cell, tri] / hvol
            q2 = u[lay, cell, tri] / hvol
            q3 = -u[lay, cell, tri_p] / hvol
            inv2A = 1.0 / (2.0 * A)
            # v(x) = [q1(x−C) + q2(x−P) + q3(x−Q)]·inv2A = c·x + d
            c = (q1 + q2 + q3) * inv2A
            dx_ = -(q1 * Cx + q2 * Px + q3 * Qx) * inv2A
            dy_ = -(q1 * Cy + q2 * Py + q3 * Qy) * inv2A

            # outward normals (CCW: the normal of a→b is (by−ay, ax−bx))
            n1x, n1y = Qy - Py, Px - Qx          # outer
            n2x, n2y = Cy - Qy, Qx - Cx          # internal → tri+1
            n3x, n3y = Py - Cy, Cx - Px          # internal → tri−1
            charlen = torch.sqrt(2.0 * A)
            b1 = 1e-9 * charlen * torch.hypot(n1x, n1y)
            b2 = 1e-9 * charlen * torch.hypot(n2x, n2y)
            b3 = 1e-9 * charlen * torch.hypot(n3x, n3y)
            t1 = _edge_exit(c, q1, n1x, n1y, Px, Py, x, y, b1)
            t2 = _edge_exit(c, q2, n2x, n2y, Qx, Qy, x, y, b2)
            t3 = _edge_exit(c, q3, n3x, n3y, Cx, Cy, x, y, b3)

            # vertical Pollock between the triangle's z faces
            az = A * theta
            vz1 = -qzb[lay, cell, tri] / az      # +z velocity at the bottom
            vz2 = qzt[lay, cell, tri] / az       # +z velocity at the top
            Az = (vz2 - vz1) / dz
            sz = z - zbot
            vzp = vz1 + Az * sz
            linz = Az.abs() * dz < 1e-12 * (vz1.abs() + vz2.abs() + _EPS)
            vz_safe = torch.where(vzp != 0, vzp, 1.0)
            Az_safe = torch.where(Az != 0, Az, 1.0)
            rel_hi = Az * (dz - sz) / vz_safe
            tz_hi = torch.where(
                linz, (dz - sz) / vz_safe,
                torch.log1p(torch.clamp(rel_hi, min=-1.0 + _EPS)) / Az_safe)
            tz_hi = torch.where((vzp > 0) & (vz2 > 0) & (rel_hi > -1.0)
                                & (tz_hi > 0), tz_hi, DINF)
            rel_lo = Az * (0.0 - sz) / vz_safe
            tz_lo = torch.where(
                linz, -sz / vz_safe,
                torch.log1p(torch.clamp(rel_lo, min=-1.0 + _EPS)) / Az_safe)
            tz_lo = torch.where((vzp < 0) & (vz1 < 0) & (rel_lo > -1.0)
                                & (tz_lo > 0), tz_lo, DINF)

            t_exit = torch.minimum(torch.minimum(t1, t2),
                                   torch.minimum(t3, torch.minimum(tz_hi,
                                                                   tz_lo)))
            no_exit = ~torch.isfinite(t_exit)
            dt = torch.where(no_exit, 0.0, torch.minimum(t_exit, trem))

            # x(t) = (x0 + d/c)e^{ct} − d/c, linear when c·dt is tiny
            linc = c.abs() * dt < 1e-12
            c_s = torch.where(c != 0, c, 1.0)
            em1 = torch.expm1(c * dt)
            x2 = torch.where(linc, x + (c * x + dx_) * dt,
                             x + (x + dx_ / c_s) * em1)
            y2 = torch.where(linc, y + (c * y + dy_) * dt,
                             y + (y + dy_ / c_s) * em1)
            sz2 = torch.minimum(torch.clamp(torch.where(
                linz, sz + vzp * dt,
                sz + vzp * torch.expm1(Az * dt) / Az_safe), min=0.0), dz)

            out_of_time = (trem <= t_exit) & ~no_exit
            hit = ~out_of_time & ~no_exit
            hit1 = (t_exit == t1) & hit
            hit2 = (t_exit == t2) & hit
            hit3 = (t_exit == t3) & hit
            hit_up = (t_exit == tz_hi) & hit
            hit_dn = (t_exit == tz_lo) & hit

            ncell = fan.nbr_cell[cell, tri]
            ntri = fan.nbr_tri[cell, tri]
            cross = hit1 & (ncell >= 0)
            cell2 = torch.where(cross, ncell, cell)
            tri2 = torch.where(cross, torch.clamp(ntri, min=0),
                               torch.where(hit2, tri_n,
                                           torch.where(hit3, tri_p, tri)))
            lay2 = lay + torch.where(hit_up, -1, 0) + torch.where(hit_dn, 1, 0)

            left = (hit1 & (ncell < 0)) | (lay2 < 0) | (lay2 >= nlay)
            lay2 = torch.clamp(lay2, 0, nlay - 1)
            inactive = ~fan.active_cell[lay2, cell2]
            status = torch.where(
                no_exit, TERM_WEAK,
                torch.where(out_of_time, TERM_TIMEOUT,
                            torch.where(left | inactive, TERM_BOUNDARY,
                                        ACTIVE)))
            return dict(x=x2, y=y2, z=zbot + sz2, lay=lay2, cell=cell2,
                        tri=tri2, trem=torch.clamp(trem - dt, min=0.0),
                        status=status, time=st["time"] + dt,
                        nhops=st["nhops"] + 1)
        return body

    def track(x, y, z, lay, cell, tri, Qout, u, qzt, qzb, sat, tmax):
        p, dev = x.shape[0], x.device
        state = dict(
            x=x.clone(), y=y.clone(), z=z.clone(), lay=lay.clone(),
            cell=cell.clone(), tri=tri.clone(),
            trem=torch.full((p,), float(tmax), dtype=torch.float64,
                            device=dev),
            status=torch.full((p,), ACTIVE, dtype=torch.int64, device=dev),
            time=torch.zeros(p, dtype=torch.float64, device=dev),
            nhops=torch.zeros(p, dtype=torch.int64, device=dev))
        out = run_batch(state, tracker(Qout, u, qzt, qzb, sat),
                        max_transitions)
        return dict(x=out["x"], y=out["y"], z=out["z"], lay=out["lay"],
                    cell=out["cell"], tri=out["tri"], status=out["status"],
                    time=out["time"], transitions=out["nhops"])

    return track


def locate(fan: DisvFan, x, y, z):
    """Release points → (lay, cell, tri), host numpy: the first (cell,
    triangle), in cell then side order, whose three signed areas are all
    at least −1e-12; then the first layer whose [bot, top] holds z (above
    the top: layer 0; below: the last)."""
    px, py = fan.px.cpu().numpy(), fan.py.cpu().numpy()
    qx, qy = fan.qx.cpu().numpy(), fan.qy.cpu().numpy()
    cx, cy = fan.cx.cpu().numpy(), fan.cy.cpu().numpy()
    val = fan.valid.cpu().numpy()
    topz, botz = fan.topz.cpu().numpy(), fan.botz.cpu().numpy()
    x, y, z = (np.asarray(v, np.float64).reshape(-1) for v in (x, y, z))
    ncpl, maxv = px.shape
    # each cell's bounding box, widened past the test's tolerance
    xs = np.where(val, px, np.nan)
    ys = np.where(val, py, np.nan)
    xmin, xmax = np.nanmin(xs, axis=1), np.nanmax(xs, axis=1)
    ymin, ymax = np.nanmin(ys, axis=1), np.nanmax(ys, axis=1)
    span = max(float(np.nanmax(xmax) - np.nanmin(xmin)),
               float(np.nanmax(ymax) - np.nanmin(ymin)), 1.0)
    pad = 1e-9 * span
    xmin, xmax, ymin, ymax = xmin - pad, xmax + pad, ymin - pad, ymax + pad
    # a bucket grid of about one cell per bucket
    nb = max(int(np.sqrt(ncpl)), 1)
    x0, y0 = float(xmin.min()), float(ymin.min())
    hx = (float(xmax.max()) - x0) / nb or 1.0
    hy = (float(ymax.max()) - y0) / nb or 1.0

    def bucket(v, v0, h):
        return np.clip(((v - v0) / h).astype(np.int64), 0, nb - 1)

    bx0, bx1 = bucket(xmin, x0, hx), bucket(xmax, x0, hx)
    by0, by1 = bucket(ymin, y0, hy), bucket(ymax, y0, hy)
    nbx, nby = bx1 - bx0 + 1, by1 - by0 + 1
    reps = nbx * nby
    cell_of = np.repeat(np.arange(ncpl), reps)
    k = np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps, reps)
    bxs = bx0[cell_of] + k % nbx[cell_of]
    bys = by0[cell_of] + k // nbx[cell_of]
    key = bys * nb + bxs
    order = np.lexsort((cell_of, key))
    key, cell_of = key[order], cell_of[order]
    start = np.searchsorted(key, np.arange(nb * nb + 1))

    pb = bucket(y, y0, hy) * nb + bucket(x, x0, hx)
    cnt = start[pb + 1] - start[pb]
    part = np.repeat(np.arange(x.size), cnt)
    j = np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    cand = cell_of[start[pb][part] + j]
    xp, yp = x[part][:, None], y[part][:, None]
    ax, ay = px[cand], py[cand]
    bx, by = qx[cand], qy[cand]
    ccx, ccy = cx[cand][:, None], cy[cand][:, None]
    s1 = (bx - ax) * (yp - ay) - (xp - ax) * (by - ay)
    s2 = (ccx - bx) * (yp - by) - (xp - bx) * (ccy - by)
    s3 = (ax - ccx) * (yp - ccy) - (xp - ccx) * (ay - ccy)
    ok = val[cand] & (s1 >= -1e-12) & (s2 >= -1e-12) & (s3 >= -1e-12)
    rank = np.where(ok, cand[:, None] * maxv + np.arange(maxv)[None, :],
                    np.iinfo(np.int64).max)
    best = np.full(x.size, np.iinfo(np.int64).max)
    has = cnt > 0
    if has.any():
        # ``part`` runs in particle order: one reduction per particle
        first = (np.cumsum(cnt) - cnt)[has]
        best[has] = np.minimum.reduceat(rank.min(axis=1), first)
    if (best == np.iinfo(np.int64).max).any():
        p = int(np.flatnonzero(best == np.iinfo(np.int64).max)[0])
        raise ValueError(f"release point {p} outside the grid")
    cells, tris = np.divmod(best, maxv)
    inside = (z[None, :] <= topz[:, cells]) & (z[None, :] >= botz[:, cells])
    lays = np.where(inside.any(axis=0), np.argmax(inside, axis=0),
                    np.where(z > topz[0, cells], 0, fan.nlay - 1))
    return (lays.astype(np.int32), cells.astype(np.int32),
            tris.astype(np.int32))
