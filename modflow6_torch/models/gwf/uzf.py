"""UZF: unsaturated-zone flow columns (kinematic wave) with water-table
coupling, unsaturated and groundwater ET, and groundwater seepage.

Port of modflow6_tpu/models/gwf/uzf.py (``UzfColumns``, ``make_uzf``,
``initial_theta``, ``watab_of``, ``UzfResult``, ``_flux``, ``advance``,
``UzfStep``, ``make_step``, ``uzf_matrix_terms``; reference gwf-uzf.f90,
UzfCellGroup.f90, UzfEtUtil.f90 behavioural cores).  The reference solves
the kinematic-wave equation

    ∂θ/∂t + ∂q(θ)/∂z = 0,     q(θ) = vks·((θ−θr)/(θs−θr))^eps,

with a first-order upwind finite-volume scheme over ``nz`` sub-cells per
column, all columns at once, in CFL-limited sub-steps; so does this one.
The reference's ``lax.scan`` over the sub-steps is a Python loop of
batched ``[C, nz]`` steps here (as ``csub_delay.py`` runs its Thomas
sweep); the sub-step count comes from one host read, as in the reference,
and the loop itself reads nothing back.

``make_uzf`` takes the reference's entries (dicts or legacy 9-tuples) or a
mapping of column arrays, the form the deck loader builds without a
Python object per column.  A column's terms enter the GWF system at its
node through an ``AddPlan`` built once with the columns and carried into
every ``UzfStep`` (the steps are rebuilt every time step and every
package-convergence pass).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from ... import resolve_device
from ...constants import DZERO
from ...ops.scatter import AddPlan
from ...ops.smoothing import s_cubic_linear, sq_saturation

# per-column fields of the reference's UzfColumns, in its order, with the
# defaults of a dict entry that leaves them out
COLUMN_FIELDS = ("node", "thtr", "thts", "thti", "eps", "vks", "celtop",
                 "celbot", "surfdep", "area", "finf", "pet", "extdp",
                 "extwc")
_DEFAULTS = dict(celtop=1.0, celbot=0.0, surfdep=1e-5, area=1.0, finf=0.0,
                 pet=0.0, extdp=0.0, extwc=0.0)


@dataclasses.dataclass(frozen=True)
class UzfColumns:
    """Static column parameters (uzf packagedata + period data)."""

    node: torch.Tensor     # i64[C] GWF cell hosting the column
    thtr: torch.Tensor     # residual water content
    thts: torch.Tensor     # saturated water content
    thti: torch.Tensor     # initial water content
    eps: torch.Tensor      # Brooks-Corey exponent
    vks: torch.Tensor      # vertical saturated K
    celtop: torch.Tensor   # land-surface elevation (dis top − surfdep)
    celbot: torch.Tensor   # cell bottom elevation
    surfdep: torch.Tensor  # surface-depression depth (smoothing range)
    area: torch.Tensor     # column plan-view area
    finf: torch.Tensor     # applied infiltration rate (period data)
    pet: torch.Tensor      # potential ET rate (period data)
    extdp: torch.Tensor    # ET extinction depth below land surface
    extwc: torch.Tensor    # ET extinction water content
    add_plan: AddPlan = None   # the columns' terms into their nodes
    nz: int = 20
    ietflag: int = 0       # SIMULATE_ET
    iseepflag: int = 0     # SIMULATE_GWSEEP
    igwetflag: int = 0     # LINEAR_GWET: residual PET from groundwater


def entry_columns(entries) -> dict:
    """The column arrays of the reference's ``make_uzf`` entries: dicts
    (missing optionals take the reference's defaults) or legacy 9-tuples
    (node, vks, thtr, thts, thti, eps, depth, area, finf), which place the
    column at [0, depth] decoupled from heads."""
    rows = []
    for e in entries:
        if isinstance(e, dict):
            rows.append([e.get(k, _DEFAULTS.get(k)) for k in COLUMN_FIELDS])
        else:
            node, vks, thtr, thts, thti, eps, depth, area, finf = e
            rows.append([node, thtr, thts, thti, eps, vks, depth, 0.0, 1e-5,
                         area, finf, 0.0, 0.0, 0.0])
    a = np.asarray(rows, np.float64).reshape(-1, len(COLUMN_FIELDS))
    return {k: a[:, i] for i, k in enumerate(COLUMN_FIELDS)}


def make_uzf(entries, nz=20, ietflag=0, iseepflag=0, igwetflag=0,
             device=None) -> UzfColumns:
    """Build UzfColumns on ``device`` (``None`` is the CUDA device) from
    the reference's entries (see ``entry_columns``) or from a mapping of
    column arrays keyed by ``COLUMN_FIELDS``."""
    device = resolve_device(device)
    cols = entries if isinstance(entries, Mapping) else \
        entry_columns(entries)
    # copies: the loader's column arrays change in place at a later period
    node = np.asarray(cols["node"]).astype(np.int64)
    kw = {k: torch.tensor(np.asarray(cols[k], np.float64), device=device)
          for k in COLUMN_FIELDS[1:]}
    return UzfColumns(
        node=torch.tensor(node, device=device), **kw,
        add_plan=AddPlan.build(node, device, 0), nz=int(nz),
        ietflag=int(ietflag), iseepflag=int(iseepflag),
        igwetflag=int(igwetflag))


def initial_theta(uzf: UzfColumns) -> torch.Tensor:
    return uzf.thti[:, None].expand(uzf.thti.shape[0], uzf.nz)


def watab_of(uzf: UzfColumns, head) -> torch.Tensor:
    """Water-table elevation per column (UzfCellGroup sethead)."""
    return torch.clamp(head[uzf.node], uzf.celbot, uzf.celtop)


@dataclasses.dataclass(frozen=True)
class UzfResult:
    """Outcome of one explicit column march: time-averaged rates per unit
    area (``rch``, ``rej``, ``uzet``), the residual PET left for
    groundwater ET (``gwpet``), the vks-limited applied infiltration for
    the head-dependent surface terms (``finf_top``), the columns whose
    unsaturated zone has vanished (``sat_col``), the mean unsaturated water
    content (``wc``), and the number of sub-steps the march took."""

    theta: torch.Tensor
    watab: torch.Tensor
    rch: torch.Tensor
    rej: torch.Tensor
    uzet: torch.Tensor
    gwpet: torch.Tensor
    finf_top: torch.Tensor
    sat_col: torch.Tensor
    wc: torch.Tensor
    nsub: int = 0


def _flux(uzf, theta):
    """q(θ) per sub-cell (UzfCellGroup rate function)."""
    srel = torch.clamp((theta - uzf.thtr[:, None])
                       / (uzf.thts - uzf.thtr)[:, None], 0.0, 1.0)
    return uzf.vks[:, None] * srel ** uzf.eps[:, None]


def advance(uzf: UzfColumns, theta, delt, head=None, watab_old=None,
            nsub=None) -> UzfResult:
    """March the columns through one GWF time step.

    ``head``: GWF heads (step-start iterate) fixing the water table for
    the march; None decouples the column (watab = celbot).
    ``watab_old``: previous step's water table for the uz_rise release.
    """
    C, nz = theta.shape
    f64 = theta.dtype
    depth = uzf.celtop - uzf.celbot
    dz = depth / nz
    if head is not None:
        watab = watab_of(uzf, head)
    else:
        watab = uzf.celbot
    kk = torch.arange(nz, dtype=f64, device=theta.device)
    zc = uzf.celtop[:, None] - (kk[None, :] + 0.5) * dz[:, None]
    # sub-cells below the water table are saturated
    sat = zc < watab[:, None]
    sat_col = sat[:, 0]          # the whole column is below the WT
    unsat = ~sat
    n_unsat = unsat.sum(dim=1)

    # uz_rise: water stored in the newly flooded zone becomes recharge
    rise = None
    if watab_old is not None:
        newly = sat & (zc >= torch.minimum(watab_old, watab)[:, None])
        rise = torch.where(newly, theta - uzf.thtr[:, None], 0.0).sum(
            dim=1) * dz
    # flooded cells carry θs while submerged; cells re-exposed by a
    # falling WT start saturated and drain kinematically
    thts_c = uzf.thts[:, None]
    thtr_c = uzf.thtr[:, None]
    theta = torch.where(sat, thts_c, theta)

    # surface rejection scale at the fixed step head (rejfinf sLinear)
    if head is not None:
        rej_scale = torch.clamp((uzf.celtop - head[uzf.node])
                                / torch.clamp(uzf.surfdep, min=1e-30),
                                0.0, 1.0)
        fin_want = uzf.finf * rej_scale
    else:
        fin_want = uzf.finf * 1.0

    # CFL: max wave speed dq/dθ = vks·eps/(θs−θr) at saturation; one read
    if nsub is None:
        vmax = uzf.vks * uzf.eps / (uzf.thts - uzf.thtr)
        nsub = int(np.ceil(float(torch.max(vmax * delt / dz)) * 1.05)) + 1
    dt = delt / nsub

    # ET weights: fraction of each sub-cell inside the extinction zone
    if uzf.ietflag:
        top_c = uzf.celtop[:, None]
        z_ext = uzf.celtop - uzf.extdp
        overlap = (torch.minimum(top_c - kk[None, :] * dz[:, None], top_c)
                   - torch.maximum(top_c - (kk[None, :] + 1) * dz[:, None],
                                   z_ext[:, None]))
        et_w = torch.clamp(overlap, min=0.0) \
            / torch.clamp(uzf.extdp, min=1e-30)[:, None]
        demand = uzf.pet[:, None] * et_w
        et_floor = torch.maximum(uzf.extwc, uzf.thtr)[:, None]
    dt_dz = dt / dz[:, None]
    fin_lim = torch.minimum(fin_want, uzf.vks)
    # recharge leaves at the water-table interface: the outflow of the
    # last unsaturated cell (or nothing for a flooded column)
    kw = torch.clamp(n_unsat - 1, 0, nz - 1)[:, None]

    rch = torch.zeros(C, dtype=f64, device=theta.device)
    rej = torch.zeros_like(rch)
    uzet = torch.zeros_like(rch)
    th = theta
    for _ in range(nsub):
        q = _flux(uzf, th)
        # surface inflow: rejection scale, vks limit, then capacity
        cap = (uzf.thts - th[:, 0]) * dz / dt + q[:, 0]
        fin_top = torch.minimum(fin_lim, cap)
        fin_top = torch.where(sat_col, DZERO, fin_top)
        # interface fluxes: strictly-downward kinematic wave → upwind
        # from above; f_in[:, k] = flux INTO sub-cell k
        f_in = torch.cat([fin_top[:, None], q[:, :-1]], dim=1)
        q_wt = torch.where(sat_col, DZERO, q.gather(1, kw)[:, 0])
        th_new = th + dt_dz * (f_in - q)
        if uzf.ietflag:
            # unsaturated ET limited by extwc (routewaves ietflag)
            avail = torch.clamp(th - et_floor, min=0.0) * dz[:, None] / dt
            et = torch.minimum(demand, avail) * unsat
            th_new = th_new - dt_dz * et
            uzet = uzet + et.sum(dim=1) * dt
        th_new = torch.clamp(th_new, thtr_c, thts_c)
        th = torch.where(sat, thts_c, th_new)
        rch = rch + q_wt * dt
        rej = rej + (uzf.finf - fin_top) * dt

    rch = rch / delt
    if rise is not None:
        rch = rch + rise / delt
    uzet_rate = uzet / delt
    return UzfResult(
        theta=th, watab=torch.broadcast_to(watab, (C,)), rch=rch,
        rej=rej / delt, uzet=uzet_rate,
        # residual PET for groundwater ET (setgwpet: gwpet = pet − uzet)
        gwpet=torch.clamp(uzf.pet - uzet_rate, min=0.0),
        finf_top=torch.minimum(uzf.finf, uzf.vks), sat_col=sat_col,
        wc=torch.where(unsat, th, 0.0).sum(dim=1)
        / torch.clamp(n_unsat, min=1), nsub=nsub)


@dataclasses.dataclass(frozen=True)
class UzfStep:
    """Per-step coupling data carried in PackageData (built from a
    UzfResult): everything the head-dependent matrix terms need, and the
    columns' plan (``bnd.scatter_terms`` reads ``add_plan``)."""

    node: torch.Tensor
    area: torch.Tensor
    vks: torch.Tensor
    celtop: torch.Tensor
    surfdep: torch.Tensor
    rch: torch.Tensor       # per-area recharge rate from the wave march
    gwpet: torch.Tensor     # residual PET per area
    extdp: torch.Tensor
    finf_top: torch.Tensor  # vks-limited applied infiltration
    sat_col: torch.Tensor   # bool[C] column fully saturated
    add_plan: AddPlan = None
    iseepflag: int = 0
    igwetflag: int = 0


def make_step(uzf: UzfColumns, res: UzfResult) -> UzfStep:
    return UzfStep(node=uzf.node, area=uzf.area, vks=uzf.vks,
                   celtop=uzf.celtop, surfdep=uzf.surfdep, rch=res.rch,
                   gwpet=res.gwpet, extdp=uzf.extdp,
                   finf_top=res.finf_top, sat_col=res.sat_col,
                   add_plan=uzf.add_plan, iseepflag=uzf.iseepflag,
                   igwetflag=uzf.igwetflag)


def uzf_matrix_terms(s: UzfStep, head, ibound):
    """Head-dependent (hcof, rhs) per column at the current iterate (the
    uzf_fc/uzf_solve per-iteration sweep, q = hcof·h − rhs).  Returns
    (hcof, rhs, parts) with parts the individual rates for budgets
    (positive into the aquifer)."""
    h = head[s.node]
    act = ibound[s.node] > 0

    # 1. recharge delivery from the wave march
    q_rch = torch.where(s.sat_col, DZERO, s.area * s.rch)

    # 2. flooded columns: infiltration becomes direct head-dependent
    #    recharge, linearly rejected over surfdep (rejfinf sLinear)
    F = s.area * s.finf_top
    x = s.celtop - h
    sd = torch.clamp(s.surfdep, min=1e-30)
    in_band = (x > DZERO) & (x < sd)
    scale = torch.clamp(x / sd, 0.0, 1.0)
    hcof2 = torch.where(s.sat_col & in_band, -F / sd, DZERO)
    rhs2 = torch.where(s.sat_col,
                       torch.where(in_band, -F * s.celtop / sd, -F * scale),
                       DZERO)
    q_inf = hcof2 * h - rhs2

    # 3. groundwater seepage to land surface (gwseep, iseepflag)
    hcof3 = torch.zeros_like(h)
    rhs3 = torch.zeros_like(h)
    if s.iseepflag:
        Q = s.area * s.vks
        y, _ = s_cubic_linear(h - s.celtop, sd)
        seep = y * Q * (h - s.celtop) / sd
        pos = seep > DZERO
        hcof3 = torch.where(pos, -y * Q / sd, DZERO)
        rhs3 = torch.where(pos, -y * Q * s.celtop / sd, DZERO)
    q_seep = hcof3 * h - rhs3

    # 4. groundwater ET from residual PET (simgwet/etfunc_lin linear
    #    decay between land surface and extinction depth)
    rhs4 = torch.zeros_like(h)
    if s.igwetflag:
        has = s.extdp > 1e-6
        fact = sq_saturation(s.celtop, s.celtop - s.extdp, h)
        rhs4 = torch.where(has, s.area * s.gwpet * fact, DZERO)
    q_gwet = -rhs4

    hcof = torch.where(act, hcof2 + hcof3, DZERO)
    rhs = torch.where(act, -q_rch + rhs2 + rhs3 + rhs4, DZERO)
    parts = {"UZF-GWRCH": torch.where(act, q_rch + q_inf, DZERO),
             "UZF-GWD": torch.where(act, q_seep, DZERO),
             "UZF-GWET": torch.where(act, q_gwet, DZERO)}
    return hcof, rhs, parts
