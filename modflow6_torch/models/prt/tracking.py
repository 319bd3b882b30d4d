"""Pollock semi-analytic particle tracking on structured DIS grids.

Port of modflow6_tpu/models/prt/tracking.py (reference
MethodCellPollock.f90:19-27, MethodSubcellPollock.f90, orchestrated per
cell by MethodDis.f90).  Within a cell each face-normal velocity varies
linearly between its two faces, so the trajectory and the exit time have
closed forms:

    v(s)   = v1 + A*s,          A = (v2 - v1) / ds
    s(t)   = s + vp*(exp(A*t) - 1)/A
    t_exit = log1p(A*d/vp)/A    (d: distance to the face approached)

with the A→0 limits as straight-line motion.

The reference vmaps a per-particle ``lax.while_loop`` over cell
transitions; under ``vmap`` a finished lane keeps its state while the
others run on.  Here the swarm is one masked batch loop: each iteration
advances the particles still active (status ACTIVE and fewer than
``max_transitions`` transitions) by one transition and leaves the others
where they stopped; the host reads whether any particle is still active
once per iteration.  The face flows come from the GWF model's planes on
the structured path, or through the ELL slots (``npf._row_sum``) from its
edge flows on the general path: per cell the one edge of each direction
in which it is the lower-numbered cell, the reference's ``.at[n].add``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ...constants import DONE
from ..gwf import npf as npf_mod

DINF = float("inf")
_EPS = 1e-30

# termination status codes (the reference's istatus meanings)
ACTIVE = 0
TERM_BOUNDARY = 1   # left the grid or entered an inactive cell
TERM_WEAK = 2       # no exit face (weak sink or stagnation)
TERM_TIMEOUT = 3    # still tracking when the time budget ran out


@dataclasses.dataclass(frozen=True)
class CellFlows:
    """Per-cell face flows (positive in +x, +y (toward row 0) and +z (up))
    and cell properties on the (nlay, nrow, ncol) grid, flattened to
    [nlay·nrow·ncol]."""

    qleft: torch.Tensor    # across the west face (+x into the cell)
    qright: torch.Tensor   # across the east face (+x out of the cell)
    qfront: torch.Tensor   # across the south face (+y into the cell)
    qback: torch.Tensor    # across the north face (+y out of the cell)
    qtop: torch.Tensor     # across the top face (+z out of the cell)
    qbot: torch.Tensor     # across the bottom face (+z into the cell)
    porosity: torch.Tensor
    sat: torch.Tensor      # saturated thickness fraction
    active_cell: torch.Tensor
    shape: tuple
    delr: torch.Tensor     # f64[ncol]
    delc: torch.Tensor     # f64[nrow]


def _directional(gwf_model, head, ibound, cond):
    """(east, south, down) flows out of each cell across the face it
    shares with its higher-numbered neighbour, as [nlay, nrow, ncol]
    (zero where there is none)."""
    shape = gwf_model.grid.shape
    if gwf_model.use_structured:
        qx, qy, qz = gwf_model.face_flows(head, cond)
        # q_nm = −q (positive from n toward m); + 0.0 as the reference's
        # sum into zeros
        return (F.pad(-qx, (0, 1)) + 0.0, F.pad(-qy, (0, 0, 0, 1)) + 0.0,
                F.pad(-qz, (0, 0, 0, 0, 0, 1)) + 0.0)
    dtopo = gwf_model.dtopo
    q_nm = -npf_mod.flowja(dtopo, cond, head)
    d = torch.as_tensor(gwf_model.topo.direction, device=head.device)
    zero = torch.zeros_like(q_nm)
    return tuple(npf_mod._row_sum(dtopo, torch.where(d == k, q_nm, 0.0),
                                  zero).reshape(shape)
                 for k in range(3))


def build_cell_flows(gwf_model, head, ibound, cond, porosity, sat):
    """CellFlows of a DIS grid from a solved GWF step (the reference's
    ``build_cell_flows`` over ``npf.flowja``)."""
    grid = gwf_model.grid
    q_east, q_south, q_down = _directional(gwf_model, head, ibound, cond)
    dev = head.device
    return CellFlows(
        qleft=F.pad(q_east[:, :, :-1], (1, 0)).reshape(-1),
        qright=q_east.reshape(-1),
        # +y points toward row 0: the south face's +y flow is minus the
        # southward flow, the north face's the row above's
        qfront=(-q_south).reshape(-1),
        qback=F.pad(-q_south[:, :-1, :], (0, 0, 1, 0)).reshape(-1),
        qbot=(-q_down).reshape(-1),
        qtop=F.pad(-q_down[:-1], (0, 0, 0, 0, 1, 0)).reshape(-1),
        porosity=torch.as_tensor(porosity, dtype=torch.float64,
                                 device=dev).reshape(-1),
        sat=sat.reshape(-1),
        active_cell=torch.as_tensor(np.asarray(grid.idomain) > 0,
                                    device=dev).reshape(-1),
        shape=tuple(grid.shape),
        delr=torch.as_tensor(np.asarray(grid.delr, np.float64), device=dev),
        delc=torch.as_tensor(np.asarray(grid.delc, np.float64), device=dev))


def _axis_exit(vp, v1, v2, s, ds):
    """Exit time along one axis and its (A, linear) (Pollock's closed
    form): log1p(A·d/vp)/A, exact as A → 0 and free of cancellation when
    the flow is nearly uniform."""
    A = (v2 - v1) / ds
    lin = A.abs() * ds < 1e-12 * (v1.abs() + v2.abs() + _EPS)
    vp_safe = torch.where(vp != 0, vp, 1.0)
    A_safe = torch.where(A != 0, A, 1.0)

    pos_ok = (vp > 0) & (v2 > 0)
    rel_hi = A * (ds - s) / vp_safe
    t_hi = torch.where(
        lin, (ds - s) / vp_safe,
        torch.log1p(torch.clamp(rel_hi, min=-DONE + _EPS)) / A_safe)
    t_hi = torch.where(pos_ok & (rel_hi > -DONE), t_hi, DINF)

    neg_ok = (vp < 0) & (v1 < 0)
    rel_lo = A * (0.0 - s) / vp_safe
    t_lo = torch.where(
        lin, (0.0 - s) / vp_safe,
        torch.log1p(torch.clamp(rel_lo, min=-DONE + _EPS)) / A_safe)
    t_lo = torch.where(neg_ok & (rel_lo > -DONE), t_lo, DINF)

    t = torch.minimum(t_hi, t_lo)
    return torch.where(t > 0, t, DINF), A, lin


def _axis_advance(vp, v1, A, lin, s, dt):
    """Position after dt along one axis (expm1 keeps precision as A → 0)."""
    s_exp = s + vp * torch.expm1(A * dt) / torch.where(A != 0, A, 1.0)
    return torch.where(lin, s + vp * dt, s_exp)


def run_batch(state, body, max_transitions):
    """The masked batch loop: ``state`` a dict of [P] tensors with
    ``status`` and ``nhops``; ``body(sub_state)`` one transition of the
    particles given.  Particles stop where the reference's lanes stop:
    at a status other than ACTIVE or at ``max_transitions``.  One host
    read per iteration."""
    while True:
        live = (state["status"] == ACTIVE) & (state["nhops"]
                                              < max_transitions)
        idx = torch.nonzero(live).squeeze(1)
        if idx.numel() == 0:
            return state
        new = body({k: v[idx] for k, v in state.items()})
        for k, v in new.items():
            state[k][idx] = v


def make_tracker(flows: CellFlows, top3, bot3, max_transitions=4096):
    """track(x, y, z, lay, row, col, tmax) → dict of the final particle
    state, over the particle axis.  Coordinates: x along the columns
    (east +), y along the rows (north +, row 0 at the top edge), z the
    elevation.  ``top3``/``bot3``: f64 cell tops and bottoms, flat."""
    nlay, nrow, ncol = flows.shape
    delr, delc = flows.delr, flows.delc
    dev = delr.device
    # edges as running sums (np.cumsum adds in order)
    xedge = torch.as_tensor(np.concatenate(
        [[0.0], np.cumsum(delr.cpu().numpy())]), device=dev)
    delc_np = delc.cpu().numpy()
    yedge = torch.as_tensor(delc_np.sum() - np.concatenate(
        [[0.0], np.cumsum(delc_np)]), device=dev)

    def cell(lay, row, col):
        return (lay * nrow + row) * ncol + col

    def body(st):
        x, y, z = st["x"], st["y"], st["z"]
        lay, row, col = st["lay"], st["row"], st["col"]
        trem = st["trem"]
        dx = delr[col]
        dy = delc[row]
        c0 = cell(lay, row, col)
        zbot = bot3[c0]
        satf = flows.sat[c0]

        # pass-to-bottom: a dry cell drops the particle to the layer below
        # (MethodCellPassToBot.f90); a dry bottom-layer cell ends it
        dry = satf <= 1.0e-10
        at_bottom = lay >= nlay - 1
        drop = dry & ~at_bottom
        lay = torch.where(drop, lay + 1, lay)
        z = torch.where(drop, zbot, z)

        c = cell(lay, row, col)
        ztop = top3[c]
        zbot = bot3[c]
        dz = torch.clamp(ztop - zbot, min=_EPS)
        theta = flows.porosity[c]
        satf = torch.clamp(flows.sat[c], min=1.0e-10)

        # face areas (the saturated thickness scales the side faces)
        ax = dy * dz * satf
        ay = dx * dz * satf
        az = dx * dy

        vx1 = flows.qleft[c] / (ax * theta)
        vx2 = flows.qright[c] / (ax * theta)
        vy1 = flows.qfront[c] / (ay * theta)
        vy2 = flows.qback[c] / (ay * theta)
        vz1 = flows.qbot[c] / (az * theta)
        vz2 = flows.qtop[c] / (az * theta)

        sx = x - xedge[col]
        sy = y - yedge[row + 1]     # the cell spans [yedge[row+1], yedge[row]]
        sz = z - zbot

        vxp = vx1 + (vx2 - vx1) / dx * sx
        vyp = vy1 + (vy2 - vy1) / dy * sy
        vzp = vz1 + (vz2 - vz1) / dz * sz

        tx, Ax, linx = _axis_exit(vxp, vx1, vx2, sx, dx)
        ty, Ay, liny = _axis_exit(vyp, vy1, vy2, sy, dy)
        tz, Az, linz = _axis_exit(vzp, vz1, vz2, sz, dz)

        t_exit = torch.minimum(torch.minimum(tx, ty), tz)
        no_exit = ~torch.isfinite(t_exit)
        # a cell with no outflow face is a sink: the particle ends there
        dt = torch.where(no_exit, 0.0, torch.minimum(t_exit, trem))

        sx2 = torch.minimum(torch.clamp(
            _axis_advance(vxp, vx1, Ax, linx, sx, dt), min=0.0), dx)
        sy2 = torch.minimum(torch.clamp(
            _axis_advance(vyp, vy1, Ay, liny, sy, dt), min=0.0), dy)
        sz2 = torch.minimum(torch.clamp(
            _axis_advance(vzp, vz1, Az, linz, sz, dt), min=0.0), dz)

        out_of_time = (trem <= t_exit) & ~no_exit
        crossed = ~out_of_time & ~no_exit
        col2 = col + torch.where(crossed & (t_exit == tx),
                                 torch.where(vxp > 0, 1, -1), 0)
        row2 = row + torch.where(crossed & (t_exit == ty),
                                 torch.where(vyp > 0, -1, 1), 0)   # +y = row-1
        lay2 = lay + torch.where(crossed & (t_exit == tz),
                                 torch.where(vzp > 0, -1, 1), 0)   # +z = lay-1

        left_grid = ((col2 < 0) | (col2 >= ncol) | (row2 < 0)
                     | (row2 >= nrow) | (lay2 < 0) | (lay2 >= nlay))
        col2 = torch.clamp(col2, 0, ncol - 1)
        row2 = torch.clamp(row2, 0, nrow - 1)
        lay2 = torch.clamp(lay2, 0, nlay - 1)
        inactive = ~flows.active_cell[cell(lay2, row2, col2)]

        status = torch.where(
            no_exit, TERM_WEAK,
            torch.where(out_of_time, TERM_TIMEOUT,
                        torch.where(left_grid | inactive, TERM_BOUNDARY,
                                    ACTIVE)))
        status = torch.where(dry & at_bottom, TERM_BOUNDARY, status)
        return dict(x=xedge[col] + sx2, y=yedge[row + 1] + sy2,
                    z=zbot + sz2, lay=lay2, row=row2, col=col2,
                    trem=torch.clamp(trem - dt, min=0.0), status=status,
                    time=st["time"] + dt, nhops=st["nhops"] + 1)

    def track(x, y, z, lay, row, col, tmax):
        p = x.shape[0]
        state = dict(
            x=x.clone(), y=y.clone(), z=z.clone(), lay=lay.clone(),
            row=row.clone(), col=col.clone(),
            trem=torch.full((p,), float(tmax), dtype=torch.float64,
                            device=dev),
            status=torch.full((p,), ACTIVE, dtype=torch.int64, device=dev),
            time=torch.zeros(p, dtype=torch.float64, device=dev),
            nhops=torch.zeros(p, dtype=torch.int64, device=dev))
        out = run_batch(state, body, max_transitions)
        return dict(x=out["x"], y=out["y"], z=out["z"], lay=out["lay"],
                    row=out["row"], col=out["col"], status=out["status"],
                    time=out["time"], transitions=out["nhops"])

    return track
