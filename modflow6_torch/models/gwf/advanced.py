"""Advanced stress packages with their own rows: MAW, LAK and SFR.

Port of modflow6_tpu/models/gwf/advanced.py (reference gwf-maw.f90,
gwf-lak.f90, gwf-sfr.f90 behavioural cores): ``AugTopo``,
``_build_ext_table``, ``MawData``/``build_maw``, ``LakData``/``build_lak``,
``SfrData``/``build_sfr`` and ``AugmentedGwfModel`` with MVR's movers
(``mvr=``, ``eval_movers``, ``mvr_budget``; the rules in ``mvr.py``): the
features' and the standard packages' available water goes through the
mover chain at every assembly and budget, the taken water (``qto``) leaves
the providers' routing and the delivered water (``qfrom``) enters the
receivers' rows, Picard-lagged as in the reference.

The solution vector is ``x = [head(N), feature rows(R)]``.  The base
model's neighbour table is widened with feature↔cell and feature↔feature
slots (built once on the host, as array code whose arrays equal the
reference's loops), and the base grid's assembly, structured or general,
is embedded unchanged in the first ``Kb`` slots of every grid row.  The
augmented table has no grid shape, so the solver multiplies through the
ELL gather product at width ``Ktot``, never through the stencil kernel.

Every sum into positions that repeat (two connections in one cell, the
connections of one well or lake, outlets that share a lake, two upstream
reaches of one reach) goes through an ``ops/scatter.py:AddPlan`` built
with the model, in the reference's source order; the stores into
coupling slots go to distinct slots, one per edge.  ``terms`` add into
the ``diag``, ``offf`` and ``rhs`` tensors that ``assemble`` creates, in
place.

Conventions follow the CVFD matrix (negative definite, A·x = b): a
feature↔cell exchange q = c·(dof − h) adds −c to both diagonals and +c to
the two coupling slots.

Where the port departs from the reference on purpose (ROADMAP Queue C):
``build_maw`` gives every well the storage area π r² (the reference
overwrites its per-well list with a cell area after a non-SPECIFIED
connection), and a base with CSUB, XT3D or rewetting raises here (the
reference drops CSUB silently and cannot build XT3D).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...constants import DPRECSQRT, DZERO
from ...ops import cxs
from ...ops.scatter import AddPlan, running_count
from ...ops.smoothing import (quadratic_saturation, sq_saturation,
                              sq_saturation_derivative)
from . import mvr as mvr_mod


@dataclasses.dataclass(frozen=True)
class AugTopo:
    """The device topology of the augmented (N+R)-row system: what the
    product, the Dirichlet fixup and the preconditioners read."""

    nbr: torch.Tensor        # i64[N+R, Ktot]
    grid_shape: tuple = None  # none: the product is the gather


def _build_ext_table(base_nbr, N, R, edges, ktot_min=0):
    """Extend the base neighbour table with feature rows.

    ``edges`` is an int[E, 2] array of (row_a, row_b) pairs over the
    combined index space (grid rows < N, feature rows N..N+R-1).  Returns
    (nbr_ext int64[N+R, Ktot], slot_ab int64[E], slot_ba int64[E]), the
    slots flat indices into the [N+R, Ktot] table.  The reference fills
    each row's slots after its ``Kb`` base slots in edge order; here the
    slot of an edge end is the number of earlier edge ends in the same row
    (``running_count`` over the interleaved (a, b) ends).  ``ktot_min``
    forces a least width (the sharded runners give every shard one)."""
    Kb = base_nbr.shape[1]
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    ends = edges.reshape(-1)
    first = np.where(ends < N, Kb, 0)
    slot = first + running_count(ends)
    deg = np.full(N + R, 0, np.int64)
    deg[:N] = Kb
    deg += np.bincount(ends, minlength=N + R)
    Ktot = max(int(deg.max(initial=Kb)), Kb, int(ktot_min))
    nbr = np.empty((N + R, Ktot), np.int64)
    nbr[:] = np.arange(N + R, dtype=np.int64)[:, None]
    nbr[:N, :Kb] = base_nbr
    flat = ends * Ktot + slot
    slot_ab, slot_ba = flat[0::2], flat[1::2]
    nbr.reshape(-1)[slot_ab] = edges[:, 1]
    nbr.reshape(-1)[slot_ba] = edges[:, 0]
    return nbr, slot_ab, slot_ba


def structured_nbr(topo) -> np.ndarray:
    """int64[N, 6] the neighbour table of a structured DIS model in the
    reference's [E, W, N, S, U, D] slot order, a cell's own index where a
    connection does not exist (the reference's ``Topology.nbr`` of a DIS
    grid, topology.py:72-83), from the host ``DisTopology``."""
    from ..discretization.topology import (DOWN, EAST, NORTH, SOUTH, UP,
                                           WEST)
    cols = [EAST, WEST, NORTH, SOUTH, UP, DOWN]
    n = np.arange(topo.nodes, dtype=np.int64)[:, None]
    if not topo.conn.any():
        # a grid without connections: the reference's topology of no
        # edges is a general one of width 1
        return n
    return np.where(topo.conn[:, cols], topo._neighbour[:, cols], n)


def _slice(n0, count):
    return slice(n0, n0 + count)


# ------------------------------------------------------------------- MAW

BIGHEAD = 1.0e20   # reference DEP20 sentinel: option not active


@dataclasses.dataclass(frozen=True)
class MawData:
    """Multi-aquifer well package (gwf-maw.f90 behavioural core): the
    SPECIFIED / THIEM / SKIN / CUMULATIVE / MEAN conductances (computed in
    ``build_maw``), wellbore storage, the pumping rate, HEAD_LIMIT (the
    undamped shutoff core of maw_calculate_wellq), RATE_SCALING,
    FLOWING_WELL and SHUT_OFF hysteresis advanced per time step
    (``advance_shutoff``).  ``N`` in the methods is the row of well 0."""

    conn_well: torch.Tensor   # i64[C] well index per connection
    conn_node: torch.Tensor   # i64[C] gwf node per connection
    cond: torch.Tensor        # f64[C] saturated connection conductance
    area: torch.Tensor        # f64[W] wellbore cross-sectional area
    bottom: torch.Tensor      # f64[W] well bottom elevation
    rate: torch.Tensor        # f64[W] pumping rate (negative = withdrawal)
    strt: torch.Tensor        # f64[W] initial well head
    slot_cw: torch.Tensor     # i64[C] flat slot of (cell row, well col)
    slot_wc: torch.Tensor     # i64[C] flat slot of (well row, cell col)
    active: torch.Tensor      # bool[W]
    node_plan: AddPlan        # sums over conn_node
    well_plan: AddPlan        # sums over conn_well (size W)
    head_limit: Optional[torch.Tensor] = None        # f64[W]; BIGHEAD = off
    pumpelev: Optional[torch.Tensor] = None          # f64[W]
    reduction_length: Optional[torch.Tensor] = None  # f64[W]; BIGHEAD = off
    fw_elev: Optional[torch.Tensor] = None           # f64[W]
    fw_cond: Optional[torch.Tensor] = None           # f64[W]; 0 = off
    fw_rlen: Optional[torch.Tensor] = None           # f64[W]
    shut_min: Optional[torch.Tensor] = None          # f64[W]; BIGHEAD = off
    shut_max: Optional[torch.Tensor] = None          # f64[W]
    shut: Optional[torch.Tensor] = None              # bool[W]
    nwells: int = 0
    storage: bool = True

    def advance_shutoff(self, x, N):
        """New shut flags from the accepted solution: shut when the
        head-limited |rate| drops below minrate; reopen when the potential
        |rate| exceeds maxrate (maw_calculate_wellq shutoff branch)."""
        if self.shut_min is None:
            return self.shut
        open_data = dataclasses.replace(self, shut=torch.zeros_like(
            self.shut))
        q_pot = open_data.rate_actual(x, N)
        on = self.shut_min != BIGHEAD
        shut_now = on & ~self.shut & (q_pot.abs() < self.shut_min)
        stay_shut = on & self.shut & ~(q_pot.abs() > self.shut_max)
        return shut_now | stay_shut

    def terms(self, x, x_old, N, delt, iss, diag, offf, rhs, qfrom=None):
        """Add the MAW equations into the augmented system (maw_fc);
        ``qfrom``: f64[W] mover inflow per well (the maw_fc mover block)."""
        W = self.nwells
        c = self.cond * self.active[self.conn_well]
        # gwf row: flux q = c (hw - h)
        self.node_plan.add_(diag, -c)
        offf[self.slot_cw] += c
        # well row: Σ c (h_k - hw) - A/Δt (hw - hw_old) + rate = 0
        wrow = _slice(N, W)
        self.well_plan.add_(diag[wrow], -c)
        offf[self.slot_wc] += c
        act = self.active
        if self.storage and not iss:
            sc = self.area / delt * act
            diag[wrow] += -sc
            rhs[wrow] += -sc * x_old[wrow]
        rate, drate = self.rate_actual_and_deriv(x, N)
        diag[wrow] += drate * act
        rhs[wrow] += (-rate + drate * x[wrow]) * act
        if self.fw_cond is not None:
            # flowing-well discharge, Newton-linearized on the well row
            qfw, dqfw = self.flowing_well_q(x, N)
            diag[wrow] += dqfw * act
            rhs[wrow] += (-qfw + dqfw * x[wrow]) * act
        if qfrom is not None:
            rhs[wrow] += -qfrom * act

    def rate_actual(self, x, N):
        """Simulated pumping rate per well at the current iterate
        (maw_calculate_wellq)."""
        return self.rate_actual_and_deriv(x, N)[0]

    def rate_actual_and_deriv(self, x, N):
        """(q, dq/dhw): the RATE_SCALING branch is head-dependent, so its
        derivative goes on the well-row diagonal."""
        q = self.rate
        if self.shut is not None:
            q = torch.where(self.shut, DZERO, q)
        dq = torch.zeros_like(self.rate)
        if self.reduction_length is not None:
            hw = x[_slice(N, self.nwells)]
            bt = self.pumpelev
            tp = bt + torch.where(self.reduction_length == BIGHEAD, 1.0,
                                  self.reduction_length)
            sat = sq_saturation(tp, bt, hw)
            dsat = sq_saturation_derivative(tp, bt, hw)
            on = self.reduction_length != BIGHEAD
            scale_ext = torch.where(on, sat, 1.0)
            scale_inj = torch.where(on, 1.0 - sat, 1.0)
            ext = q < DZERO
            q = torch.where(ext, q * scale_ext, q * scale_inj)
            dq = torch.where(on, torch.where(ext, self.rate * dsat,
                                             -self.rate * dsat), DZERO)
        if self.head_limit is not None:
            # the potential inflow from the aquifer with the well head
            # pinned at the limit; withdrawal is capped so hw cannot be
            # drawn below it (maw_calculate_qpot)
            w = self.conn_well
            qin = self.cond * (x[self.conn_node] - self.head_limit[w])
            qpot = self.well_plan.sum(qin)
            limited = -torch.clamp(qpot, min=torch.zeros_like(qpot),
                                   max=-self.rate)
            lim_on = (self.rate < DZERO) & (self.head_limit != BIGHEAD)
            q = torch.where(lim_on, limited, q)
            dq = torch.where(lim_on, DZERO, dq)
        if self.shut is not None:
            # SHUT_OFF: a shut well pumps nothing regardless of limits
            q = torch.where(self.shut, DZERO, q)
            dq = torch.where(self.shut, DZERO, dq)
        return q, dq

    def flowing_well_q(self, x, N):
        """(q, dq/dhw) per well for the flowing-well discharge
        q = −fwcond·sat(hw)·(hw − fwelev); sat ramps over fwrlen."""
        hw = x[_slice(N, self.nwells)]
        tp = self.fw_elev + torch.clamp(self.fw_rlen, min=1e-9)
        sat = sq_saturation(tp, self.fw_elev, hw)
        q = -self.fw_cond * sat * (hw - self.fw_elev)
        eps = DPRECSQRT * torch.clamp(hw.abs(), min=1.0)
        hw2 = hw + eps
        sat2 = sq_saturation(tp, self.fw_elev, hw2)
        q2 = -self.fw_cond * sat2 * (hw2 - self.fw_elev)
        return q, (q2 - q) / eps

    def available(self, x, N):
        """Water a mover could take: the actual withdrawal plus any
        flowing-well discharge (both positive out of the well)."""
        avail = torch.clamp(-self.rate_actual(x, N), min=DZERO)
        if self.fw_cond is not None:
            qfw, _ = self.flowing_well_q(x, N)
            avail = avail + torch.clamp(-qfw, min=DZERO)
        return avail * self.active

    def budget(self, x, x_old, N, delt, iss, qfrom=None):
        """Per-connection and per-well flows (maw_bd): the GWF exchange
        (positive into the aquifer), the rate, the flowing-well discharge,
        the wellbore storage and the mover inflow."""
        hw = x[N + self.conn_well]
        h = x[self.conn_node]
        act = self.active
        out = {"MAW-GWF": self.cond * act[self.conn_well] * (hw - h),
               "MAW-RATE": self.rate_actual(x, N) * act}
        if self.fw_cond is not None:
            out["MAW-FW"] = self.flowing_well_q(x, N)[0] * act
        if self.storage and not iss:
            wrow = _slice(N, self.nwells)
            out["MAW-STO"] = -self.area / delt * (x[wrow] - x_old[wrow]) \
                * act
        if qfrom is not None:
            out["MAW-FROM-MVR"] = qfrom * act
        return out


def build_maw(wells, grid, k11=None, k22=None):
    """Host spec of MAW wells (the reference's build_maw, gwf-maw.f90
    maw_calculate_satcond).  ``wells``: dicts with keys radius, bottom,
    strt, rate, connections = [(node, cond_or_spec) ...]: a number ≥ 0 is a
    SPECIFIED saturated conductance, < 0 requests THIEM with the screen the
    full cell, and a dict(condeqn=THIEM|SKIN|CUMULATIVE|MEAN, scrn_top,
    scrn_bot, hk_skin, radius_skin) evaluates equations 1-4 (T2pi =
    2π·thka·√(k11·k22), eradius = √(area/8π), the skin contrast, MEAN's
    midpoint perimeter).  Optional per-well keys: head_limit, pumpelev +
    reduction_length (RATE_SCALING), flowing=dict(elev, cond, rlen),
    shut_off=(minrate, maxrate).  ``k11``/``k22`` per cell (numpy or
    tensors).  Every well's storage area is π r² (the reference's R1 takes
    a cell's area after a non-SPECIFIED connection)."""
    conn_well, conn_node, conds = [], [], []
    area, bottomw, strtw, ratew = [], [], [], []
    hlim, pelev, rlen, fwe, fwc, fwr = [], [], [], [], [], []
    smin, smax = [], []
    top = np.asarray(grid.top)
    bot = np.asarray(grid.bot)
    cell_area = np.asarray(grid.area).reshape(-1)

    def host(a):
        return None if a is None else (a.cpu().numpy() if isinstance(
            a, torch.Tensor) else np.asarray(a))

    k11, k22 = host(k11), host(k22)
    for iw, wspec in enumerate(wells):
        r = float(wspec["radius"])
        area.append(np.pi * r * r)
        bottomw.append(float(wspec.get("bottom", 0.0)))
        strtw.append(float(wspec["strt"]))
        ratew.append(float(wspec.get("rate", 0.0)))
        hlim.append(float(wspec.get("head_limit", BIGHEAD)))
        pelev.append(float(wspec.get("pumpelev", 0.0)))
        rlen.append(float(wspec.get("reduction_length", BIGHEAD)))
        so = wspec.get("shut_off")
        smin.append(float(so[0]) if so else BIGHEAD)
        smax.append(float(so[1]) if so else BIGHEAD)
        fw = wspec.get("flowing")
        fwe.append(float(fw["elev"]) if fw else 0.0)
        fwc.append(float(fw["cond"]) if fw else 0.0)
        fwr.append(float(fw.get("rlen", 1.0)) if fw else 1.0)
        for node, cond in wspec["connections"]:
            node = int(node)
            conn_well.append(iw)
            conn_node.append(node)
            if not isinstance(cond, dict) and float(cond) >= 0:
                conds.append(float(cond))
                continue
            spec2 = cond if isinstance(cond, dict) \
                else dict(condeqn="THIEM")
            eqn = spec2["condeqn"].upper()
            kc11 = float(k11[node])
            kc22 = float(k22[node]) if k22 is not None else kc11
            sqrtk = np.sqrt(kc11 * kc22)
            thka = float(top[node] - bot[node])
            carea = float(cell_area[node])
            tthkw = float(spec2.get("scrn_top", top[node])
                          - spec2.get("scrn_bot", bot[node]))
            T2pi = 2.0 * np.pi * thka * sqrtk
            eradius = np.sqrt(carea / (8.0 * np.pi))
            lc1 = lc2 = 0.0
            if eqn in ("THIEM", "CUMULATIVE"):
                lc1 = np.log(eradius / r) / T2pi
            if eqn in ("SKIN", "CUMULATIVE"):
                hks = float(spec2["hk_skin"])
                srad = float(spec2["radius_skin"])
                tcontrast = (sqrtk * thka) / (hks * tthkw)
                lc2 = (tcontrast - 1.0) * np.log(srad / r) / T2pi
            if eqn == "MEAN":
                hks = float(spec2["hk_skin"])
                srad = float(spec2["radius_skin"])
                ravg = 0.5 * (r + srad)
                slen = srad - r
                conds.append(hks * 2.0 * np.pi * ravg * tthkw / slen)
            else:
                conds.append(1.0 / (lc1 + lc2))
    out = dict(conn_well=np.asarray(conn_well, np.int64),
               conn_node=np.asarray(conn_node, np.int64),
               cond=np.asarray(conds, np.float64),
               area=np.asarray(area), bottom=np.asarray(bottomw),
               strt=np.asarray(strtw), rate=np.asarray(ratew),
               nwells=len(wells))
    if any(h != BIGHEAD for h in hlim):
        out["head_limit"] = np.asarray(hlim)
    if any(v != BIGHEAD for v in rlen):
        out["pumpelev"] = np.asarray(pelev)
        out["reduction_length"] = np.asarray(rlen)
    if any(c != 0.0 for c in fwc):
        out["fw_elev"] = np.asarray(fwe)
        out["fw_cond"] = np.asarray(fwc)
        out["fw_rlen"] = np.asarray(fwr)
    if any(v != BIGHEAD for v in smin):
        out["shut_min"] = np.asarray(smin)
        out["shut_max"] = np.asarray(smax)
        out["shut"] = np.zeros(len(wells), bool)
    return out


# ------------------------------------------------------------------- LAK

GRAVITY = 9.80665    # DGRAVITY (SI); scaled by convlength/convtime opts
WEIR_CD = 0.61       # DCD, Constants.f90:133
_OUTLET_KINDS = ("specified", "manning", "weir")


def interp_rows(x, xp, fp):
    """``jnp.interp`` of each row: f64[L] at x[l] on the table (xp[l, :],
    fp[l, :]), with its semantics: the interval i = searchsorted(xp, x,
    side='right') clipped to [1, T-1], constant fp[0] below xp[0] and
    fp[-1] above xp[-1], and fp[i-1] where an interval has no width."""
    T = xp.shape[1]
    i = torch.searchsorted(xp, x[:, None].contiguous(), right=True)
    i = torch.clamp(i, 1, T - 1)
    x0, x1 = xp.gather(1, i - 1)[:, 0], xp.gather(1, i)[:, 0]
    f0, f1 = fp.gather(1, i - 1)[:, 0], fp.gather(1, i)[:, 0]
    df = f1 - f0
    dx = x1 - x0
    delta = x - x0
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(dx0, f0, f0 + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[:, 0], fp[:, 0], f)
    return torch.where(x > xp[:, -1], fp[:, -1], f)


@dataclasses.dataclass(frozen=True)
class LakData:
    """Lake package (gwf-lak.f90 behavioural core): the lakebed exchange
    with its free-drainage switch, HORIZONTAL connections scaled by the
    wetted fraction, storage from stage/volume/area TABLES or a constant
    area, rainfall/evaporation/withdrawal, SPECIFIED / MANNING / WEIR
    outlets with the downstream lake coupled in the Jacobian.  ``N`` in
    the methods is the row of lake 0."""

    conn_lake: torch.Tensor   # i64[C]
    conn_node: torch.Tensor   # i64[C]
    cond: torch.Tensor        # f64[C] bedleak × connection area
    belev: torch.Tensor       # f64[C] lakebed elevation at the connection
    surf_area: torch.Tensor   # f64[L]
    bottom: torch.Tensor      # f64[L]
    strt: torch.Tensor        # f64[L]
    rainfall: torch.Tensor    # f64[L] volumetric rate
    evap: torch.Tensor        # f64[L]
    withdrawal: torch.Tensor  # f64[L]
    out_invert: torch.Tensor  # f64[O]
    out_width: torch.Tensor   # f64[O]
    out_rough: torch.Tensor   # f64[O]
    out_slope: torch.Tensor   # f64[O]
    out_rate: torch.Tensor    # f64[O] (SPECIFIED outlets)
    out_src: torch.Tensor     # i64[O] source lake
    out_kind: torch.Tensor    # i64[O] index into _OUTLET_KINDS
    out_is_coupled: torch.Tensor    # bool[O] coupled in the Jacobian
    out_coupled: torch.Tensor       # i64[Oc] the coupled outlets
    out_coupled_slot: torch.Tensor  # i64[Oc] their (dst row, src row) slots
    slot_cl: torch.Tensor     # i64[C]
    slot_lc: torch.Tensor     # i64[C]
    active: torch.Tensor      # bool[L]
    node_plan: AddPlan        # sums over conn_node
    lake_plan: AddPlan        # sums over conn_lake
    src_plan: AddPlan         # the outlets' source terms into their lake
    out_plan: AddPlan         # the outlet terms into rhs rows, loop order
    tab_stage: Optional[torch.Tensor] = None    # f64[L, T]
    tab_volume: Optional[torch.Tensor] = None   # f64[L, T]
    tab_sarea: Optional[torch.Tensor] = None    # f64[L, T]
    conn_telev: Optional[torch.Tensor] = None   # f64[C] connection top
    conn_ihc: Optional[torch.Tensor] = None     # i64[C] 0 vertical, 1 hor.
    conn_conv: Optional[torch.Tensor] = None    # bool[C] convertible cell
    out_lake: tuple = ()      # source lake of each outlet (host)
    out_to: tuple = ()        # receiving lake (-1 external; host)
    out_type: tuple = ()      # "specified" | "manning" | "weir"
    out_slot: Optional[tuple] = None   # slot of (dst row, src row) or -1
    nlakes: int = 0
    noutlets: int = 0
    convfact: float = 1.0     # convlength·convtime² gravity conversion

    def conn_cond(self, s, h):
        """Effective connection conductance
        (lak_calculate_conn_conductance + lak_calculate_cond_head):
        HORIZONTAL connections to convertible cells scale the saturated
        conductance by the quadratic wetted saturation at
        vv = ½(min(stage, telev) + min(head, telev)); vertical ones use
        the full value where telev equals belev."""
        if self.conn_telev is None or self.conn_ihc is None:
            return self.cond
        topl = self.conn_telev
        botl = self.belev
        vv = 0.5 * (torch.minimum(s, topl) + torch.minimum(h, topl))
        sat = quadratic_saturation(topl, botl, vv)
        conv = (self.conn_conv if self.conn_conv is not None
                else torch.ones_like(sat, dtype=torch.bool))
        scale_h = torch.where(conv, sat, 1.0)
        thin = (topl - botl).abs() < 1e-10
        scale_v = torch.where(thin, 1.0, sat)
        return self.cond * torch.where(self.conn_ihc == 1, scale_h, scale_v)

    def sarea_of(self, s):
        """Lake surface area at stage (lak_calculate_sarea)."""
        if self.tab_stage is None:
            return self.surf_area
        return interp_rows(s, self.tab_stage, self.tab_sarea)

    def volume_of(self, s):
        """Lake volume at stage (lak_calculate_vol): table interpolation
        continued above the table top at the last surface area; without
        tables, the prism above the lake bottom."""
        if self.tab_stage is None:
            return self.surf_area * torch.clamp(s - self.bottom, min=0.0)
        v = interp_rows(s, self.tab_stage, self.tab_volume)
        return v + torch.clamp(s - self.tab_stage[:, -1], min=0.0) \
            * self.tab_sarea[:, -1]

    def outlet_flows(self, x, N):
        """(q, dq/ds_src) of every outlet at the current iterate
        (lak_calculate_outlet_outflow, each outlet by its kind)."""
        d = torch.clamp(x[N + self.out_src] - self.out_invert, min=0.0)
        positive = d > 0.0
        # weir: q = (2/3)·Cd·w·d·√(2·g·d)
        coef_w = (2.0 / 3.0) * WEIR_CD * self.out_width \
            * float(np.sqrt(2.0 * GRAVITY * self.convfact))
        q_w = coef_w * d ** 1.5
        dq_w = torch.where(positive, 1.5 * coef_w * torch.sqrt(d), 0.0)
        coef_m = self.out_width / self.out_rough * torch.sqrt(self.out_slope)
        q_m = coef_m * d ** (5.0 / 3.0)
        dq_m = torch.where(positive, coef_m * (5.0 / 3.0)
                           * d ** (2.0 / 3.0), 0.0)
        kind = self.out_kind
        q = torch.where(kind == 0, self.out_rate,
                        torch.where(kind == 2, q_w, q_m))
        dq = torch.where(kind == 0, 0.0, torch.where(kind == 2, dq_w, dq_m))
        return q, dq

    def outlet_flow(self, x, N, i):
        """(q, dq/ds_src) of outlet i."""
        q, dq = self.outlet_flows(x, N)
        return q[i], dq[i]

    def terms(self, x, x_old, N, delt, iss, diag, offf, rhs, qto_out=None,
              qfrom=None):
        """Add the LAK equations into the augmented system (lak_fc);
        ``qto_out``: f64[O] mover water taken per outlet (the receiving lake
        gets the rest), ``qfrom``: f64[L] mover inflow per lake."""
        L = self.nlakes
        lrow = _slice(N, L)
        lk = self.conn_lake
        node = self.conn_node
        s = x[N + lk]
        h = x[node]
        act_c = self.active[lk]
        # exchange q = c (s − h) when h > belev, else c (s − belev)
        # (lak_calculate_conn_exchange), switched on the current iterate
        coupled = h > self.belev
        c = self.conn_cond(s, h) * act_c
        c_h = torch.where(coupled, c, 0.0)
        self.node_plan.add_(diag, -c_h)
        offf[self.slot_cl] += c_h
        # free drainage: the cell receives the lagged flux c (s_k − belev)
        self.node_plan.add_(rhs, torch.where(coupled, 0.0,
                                             -c * (s - self.belev)))
        self.lake_plan.add_(diag[lrow], -c)
        offf[self.slot_lc] += c_h
        self.lake_plan.add_(rhs[lrow], torch.where(coupled, 0.0,
                                                   -c * self.belev))
        # storage: −(V(s) − V(s_old))/Δt, Newton-linearized with
        # dV/ds = sarea(s); constant-area lakes reduce to A/Δt (s − s_old)
        act = self.active
        s_l = x[lrow]
        if self.tab_stage is None:
            sc = (torch.zeros_like(self.surf_area) if iss
                  else self.surf_area / delt) * act
            diag[lrow] += -sc
            rhs[lrow] += -sc * x_old[lrow]
        else:
            sa_k = self.sarea_of(s_l)
            v_k = self.volume_of(s_l)
            v_old = self.volume_of(x_old[lrow])
            sc = (torch.zeros_like(sa_k) if iss else sa_k / delt) * act
            diag[lrow] += -sc
            rate = (torch.zeros_like(v_k) if iss
                    else ((v_k - v_old) / delt) * act)
            rhs[lrow] += rate - sc * s_l
        rhs[lrow] += -(self.rainfall - self.evap - self.withdrawal) * act
        if qfrom is not None:
            rhs[lrow] += -qfrom * act
        if not self.out_type:
            return
        # outlets, linearized at the current iterate: the source row loses
        # q(s) ⇒ −[q_k + dq·(s − s_k)], the receiving lake gains it
        # (coupled in the Jacobian through out_slot); every outlet's terms
        # go into the rhs rows in the reference's loop order
        q, dq = self.outlet_flows(x, N)
        s_src = x[N + self.out_src]
        self.src_plan.add_(diag[lrow], -dq)
        offf[self.out_coupled_slot] += dq[self.out_coupled]
        q_dst = q if qto_out is None else q - qto_out
        gain = torch.where(self.out_is_coupled, -q_dst + dq * s_src, -q_dst)
        self.out_plan.add_(rhs[lrow], torch.stack(
            [q - dq * s_src, gain], dim=1).reshape(-1))

    def available(self, x, N):
        """The outflow of every outlet (what a mover could take)."""
        return self.outlet_flows(x, N)[0]

    def budget(self, x, x_old, N, delt, iss, qto_out=None, qfrom=None):
        lk = self.conn_lake
        s = x[N + lk]
        h = x[self.conn_node]
        coupled = h > self.belev
        q = self.conn_cond(s, h) * self.active[lk] * torch.where(
            coupled, s - h, s - self.belev)
        act = self.active
        out = {"LAK-GWF": q,
               "LAK-RAIN": self.rainfall * act,
               "LAK-EVAP": -self.evap * act,
               "LAK-WDRL": -self.withdrawal * act}
        if self.out_type:
            q_out = self.available(x, N)
            if qto_out is not None:
                out["LAK-TO-MVR"] = -qto_out
                q_out = q_out - qto_out
            out["LAK-OUT"] = -q_out
        if qfrom is not None:
            out["LAK-FROM-MVR"] = qfrom * act
        if not iss:
            lrow = _slice(N, self.nlakes)
            out["LAK-STO"] = -(self.volume_of(x[lrow])
                               - self.volume_of(x_old[lrow])) / delt * act
        return out


def build_lak(lakes, outlets=None):
    """Host spec of lakes (the reference's build_lak).  ``lakes``: dicts
    (strt, bottom, surf_area, rainfall, evap, withdrawal,
    connections=[(node, bedleak·area, belev[, telev, ihc])], optional
    table=[(stage, volume, sarea), ...], the LAK TABLES block);
    ``outlets``: dicts (lake, to=-1, type specified|manning|weir, invert,
    width, rough, slope, rate)."""
    outlets = outlets or []
    tables = None
    if any("table" in s for s in lakes):
        T = max(max(len(s.get("table", [])) for s in lakes), 2)
        L = len(lakes)
        tstage = np.zeros((L, T))
        tvol = np.zeros((L, T))
        tsar = np.zeros((L, T))
        for il, s in enumerate(lakes):
            tab = s.get("table")
            if tab:
                rows = np.asarray(tab, np.float64)
                n = rows.shape[0]
                tstage[il, :n] = rows[:, 0]
                tvol[il, :n] = rows[:, 1]
                tsar[il, :n] = rows[:, 2]
                # pad: continue linearly above the table top
                for j in range(n, T):
                    tstage[il, j] = tstage[il, j - 1] + 1.0
                    tvol[il, j] = tvol[il, j - 1] + tsar[il, n - 1]
                    tsar[il, j] = tsar[il, n - 1]
            else:
                # a linear prism table from surf_area/bottom
                a = float(s["surf_area"])
                b = float(s.get("bottom", 0.0))
                tstage[il] = b + np.linspace(0.0, 1.0, T) * 1e4
                tvol[il] = (tstage[il] - b) * a
                tsar[il] = a
        tables = (tstage, tvol, tsar)
    conn_lake, conn_node, cond, belev = [], [], [], []
    telev, ihc = [], []
    for il, spec in enumerate(lakes):
        for conn in spec["connections"]:
            node, c, be = conn[0], conn[1], conn[2]
            conn_lake.append(il)
            conn_node.append(int(node))
            cond.append(float(c))
            belev.append(float(be))
            telev.append(float(conn[3] if len(conn) > 3 else be))
            ihc.append(int(conn[4] if len(conn) > 4 else 0))
    return dict(
        conn_lake=np.asarray(conn_lake, np.int64),
        conn_node=np.asarray(conn_node, np.int64),
        cond=np.asarray(cond), belev=np.asarray(belev),
        conn_telev=np.asarray(telev), conn_ihc=np.asarray(ihc, np.int64),
        surf_area=np.asarray([s["surf_area"] for s in lakes], np.float64),
        bottom=np.asarray([s.get("bottom", -1e30) for s in lakes],
                          np.float64),
        strt=np.asarray([s["strt"] for s in lakes], np.float64),
        rainfall=np.asarray([s.get("rainfall", 0.0) for s in lakes],
                            np.float64),
        evap=np.asarray([s.get("evap", 0.0) for s in lakes], np.float64),
        withdrawal=np.asarray([s.get("withdrawal", 0.0) for s in lakes],
                              np.float64),
        out_lake=tuple(int(o["lake"]) for o in outlets),
        out_to=tuple(int(o.get("to", -1)) for o in outlets),
        out_invert=np.asarray([o.get("invert", 0.0) for o in outlets],
                              np.float64),
        out_width=np.asarray([o.get("width", 1.0) for o in outlets],
                             np.float64),
        out_rough=np.asarray([o.get("rough", 0.03) for o in outlets],
                             np.float64),
        out_slope=np.asarray([o.get("slope", 1e-3) for o in outlets],
                             np.float64),
        out_rate=np.asarray([o.get("rate", 0.0) for o in outlets],
                            np.float64),
        out_type=tuple(o.get("type", "specified") for o in outlets),
        nlakes=len(lakes), noutlets=len(outlets),
        **({"tab_stage": tables[0], "tab_volume": tables[1],
            "tab_sarea": tables[2]} if tables is not None else {}))


# ------------------------------------------------------------------- SFR

_DIVERSION_RULES = ("fraction", "excess", "threshold", "upto")


@dataclasses.dataclass(frozen=True)
class SfrData:
    """Streamflow routing package (gwf-sfr.f90 behavioural core): Manning
    outflow (rectangular, or n-point cross sections through ops/cxs.py),
    upstream-fraction routing with the upstream coupling in the Jacobian
    (``up_pair_slot``; asymmetric, BiCGSTAB), diversions with the four
    cprior rules applied one after another, the streambed exchange with
    its free-drainage switch, rainfall/evaporation/runoff/inflow.  ``N``
    in the methods is the row of reach 0."""

    cond: torch.Tensor      # f64[R] bed conductance (k·w·L/thick)
    strtop: torch.Tensor    # f64[R] streambed top elevation
    width: torch.Tensor     # f64[R]
    rough: torch.Tensor     # f64[R]
    slope: torch.Tensor     # f64[R]
    length: torch.Tensor    # f64[R]
    upstream: torch.Tensor  # i64[R, U] upstream reach ids (self-padded)
    frac: torch.Tensor      # f64[R, U] fraction of upstream outflow
    inflow: torch.Tensor    # f64[R]
    rainfall: torch.Tensor  # f64[R] volumetric
    evap: torch.Tensor      # f64[R]
    runoff: torch.Tensor    # f64[R]
    node: torch.Tensor      # i64[R] gwf cell
    strt: torch.Tensor      # f64[R] initial stage
    slot_cr: torch.Tensor   # i64[R] (cell row, reach col) slot
    slot_rc: torch.Tensor   # i64[R] (reach row, cell col) slot
    active: torch.Tensor    # bool[R]
    up_pair_r: torch.Tensor     # i64[P] routing pair: downstream reach
    up_pair_u: torch.Tensor     # i64[P] routing pair: upstream reach
    up_pair_f: torch.Tensor     # f64[P] ustrf fraction
    up_pair_slot: torch.Tensor  # i64[P] slot of (r row, u col)
    node_plan: AddPlan          # sums over node
    pair_plan: AddPlan          # sums over up_pair_r
    divflow: Optional[torch.Tensor] = None     # f64[D]
    xs_station: Optional[torch.Tensor] = None  # f64[R, P]
    xs_height: Optional[torch.Tensor] = None   # f64[R, P]
    xs_rf: Optional[torch.Tensor] = None       # f64[R, P-1]
    xs_rect: Optional[torch.Tensor] = None     # bool[R]
    nreaches: int = 0
    div_src: tuple = ()   # diverting reach of each diversion
    div_to: tuple = ()    # receiving reach
    div_rule: tuple = ()  # cprior

    def _manning(self, stage):
        """(Q, dQ/dstage) of each reach.  With cross sections dQ is the
        reference's forward difference at eps = √DPREC·max(|d|, 1)."""
        d = torch.clamp(stage - self.strtop, min=0.0)
        if self.xs_station is not None:
            conv = cxs.conveyance(self.xs_station, self.xs_height,
                                  self.xs_rf, self.rough, d, self.xs_rect)
            q = conv * torch.sqrt(self.slope)
            eps = DPRECSQRT * torch.clamp(d.abs(), min=1.0)
            conv2 = cxs.conveyance(self.xs_station, self.xs_height,
                                   self.xs_rf, self.rough, d + eps,
                                   self.xs_rect)
            dq = (conv2 * torch.sqrt(self.slope) - q) / eps
            return q, torch.where(d > 0.0, dq, 0.0)
        coef = self.width / self.rough * torch.sqrt(self.slope)
        q = coef * d ** (5.0 / 3.0)
        dq = torch.where(d > 0.0, coef * (5.0 / 3.0) * d ** (2.0 / 3.0),
                         0.0)
        return q, dq

    def routing(self, q, qto=None):
        """Downstream-routable flow after the mover and the diversions: qd
        starts as the outflow less what the movers take (``qto``), then
        each diversion on a reach consumes from what the ones before it
        left, in declared order (sfr_calc_div).  Returns (qd[R], div_in[R],
        the inflow delivered to the diversions' receivers, div_q[D], the
        flow of each diversion)."""
        qd = q.clone() if qto is None else torch.clamp(q - qto, min=0.0)
        div_in = torch.zeros_like(q)
        div_q = []
        for i, (s, t, rule) in enumerate(zip(self.div_src, self.div_to,
                                             self.div_rule)):
            v = self.divflow[i]
            qs = qd[s]
            if rule == "fraction":
                vq = qs * v
            elif rule == "excess":
                vq = torch.clamp(qs - v, min=DZERO)
            elif rule == "threshold":
                vq = torch.where(qs < v, DZERO, v)
            else:  # upto
                vq = torch.minimum(v, qs)
            qd[s] -= vq
            div_in[t] += vq
            div_q.append(vq)
        return qd, div_in, (torch.stack(div_q) if div_q
                            else q.new_zeros(0))

    def available(self, x, N):
        """The downstream outflow of each reach at the current iterate."""
        q, _ = self._manning(x[_slice(N, self.nreaches)])
        return q * self.active

    def terms(self, x, x_old, N, delt, iss, diag, offf, rhs, qto=None,
              qfrom=None):
        """Add the SFR equations into the augmented system (sfr_fc);
        ``qto``: f64[R] mover water taken from each reach's outflow,
        ``qfrom``: f64[R] mover inflow per reach."""
        R = self.nreaches
        rrow = _slice(N, R)
        stage = x[rrow]
        h = x[self.node]
        act = self.active
        # gwf exchange q_gwf = c (stage − h), free drainage below the bed
        coupled = h > self.strtop
        c = self.cond * act
        c_h = torch.where(coupled, c, 0.0)
        self.node_plan.add_(diag, -c_h)
        offf[self.slot_cr] += c_h
        # free drainage: the cell receives the lagged flux
        # c (stage_k − strtop)
        self.node_plan.add_(rhs, torch.where(coupled, 0.0,
                                             -c * (stage - self.strtop)))
        diag[rrow] += -c
        offf[self.slot_rc] += c_h
        rhs[rrow] += torch.where(coupled, 0.0, -c * self.strtop)
        # outflow (Manning) linearized: continuity of reach r is
        # Qin + ext − Qout(s_r) − q_gwf = 0
        q, dq = self._manning(stage)
        diag[rrow] += -dq * act
        rhs[rrow] += (q - dq * stage) * act
        # upstream inflows Σ_u frac·Qout_u(s_u) at the current iterate
        q_route, div_in, _ = self.routing(q, qto)
        q_up = q_route[self.upstream] * self.frac
        rhs[rrow] += -q_up.sum(dim=1) * act
        # the upstream coupling in the Jacobian: reach r gains
        # t(s_u) = ustrf·qd(s_u); t' ≈ ustrf·(qd_k/q_k)·dq_u (the
        # diversion factor lagged, exact without diversions)
        if self.up_pair_r.shape[0] > 0:
            u = self.up_pair_u
            qu = q[u]
            factor = torch.where(qu > DZERO, q_route[u] / torch.where(
                qu > DZERO, qu, 1.0), DZERO)
            tprime = self.up_pair_f * factor * dq[u] \
                * act[self.up_pair_r] * act[u]
            offf[self.up_pair_slot] += tprime
            self.pair_plan.add_(rhs[rrow], tprime * stage[u])
        ext = (self.inflow + self.runoff + self.rainfall - self.evap) * act
        rhs[rrow] += -ext
        rhs[rrow] += -div_in * act
        if qfrom is not None:
            rhs[rrow] += -qfrom * act

    def budget(self, x, x_old, N, delt, iss, qto=None, qfrom=None):
        stage = x[_slice(N, self.nreaches)]
        h = x[self.node]
        coupled = h > self.strtop
        q_gwf = self.cond * self.active * torch.where(
            coupled, stage - h, stage - self.strtop)
        q_out, _ = self._manning(stage)
        q_out = q_out * self.active
        out = {"SFR-GWF": q_gwf,
               "SFR-EXT": (self.inflow + self.runoff + self.rainfall
                           - self.evap) * self.active}
        if qto is not None:
            out["SFR-TO-MVR"] = -qto
            q_out = torch.clamp(q_out - qto, min=0.0)
        out["SFR-OUT"] = -q_out
        if qfrom is not None:
            out["SFR-FROM-MVR"] = qfrom * self.active
        return out


def build_sfr(reaches):
    """Host spec of stream reaches (the reference's build_sfr).
    ``reaches``: dicts (node, cond, strtop, width, rough, slope, length,
    upstream=[(reach, frac)...], inflow, rainfall, evap, runoff, strt);
    optional keys: xsection=(stations as fractions of the width, heights[,
    rough_fracs]), diversions=[dict(to, cprior, flow) ...]."""
    R = len(reaches)
    U = max(max((len(r.get("upstream", [])) for r in reaches), default=0), 1)
    upstream = np.tile(np.arange(R, dtype=np.int64)[:, None], (1, U))
    frac = np.zeros((R, U))
    for i, r in enumerate(reaches):
        for u, (ur, f) in enumerate(r.get("upstream", [])):
            upstream[i, u] = ur
            frac[i, u] = f

    def g(k, d=0.0):
        return np.asarray([r.get(k, d) for r in reaches], np.float64)

    out = dict(
        cond=g("cond"), strtop=g("strtop"), width=g("width", 1.0),
        rough=g("rough", 0.03), slope=g("slope", 1e-3),
        length=g("length", 1.0), upstream=upstream, frac=frac,
        inflow=g("inflow"), rainfall=g("rainfall"), evap=g("evap"),
        runoff=g("runoff"),
        node=np.asarray([r["node"] for r in reaches], np.int64),
        strt=g("strt"), nreaches=R)
    if any("xsection" in r for r in reaches):
        secs = []
        for i, r in enumerate(reaches):
            xsec = r.get("xsection")
            if xsec is None:
                # rectangular default: two walls and the bed at the width
                w = float(out["width"][i])
                big = 1e6
                secs.append(([0.0, 0.0, w, w], [big, 0.0, 0.0, big], None))
            else:
                st = np.asarray(xsec[0], np.float64) * float(out["width"][i])
                secs.append((st, xsec[1],
                             xsec[2] if len(xsec) > 2 else None))
        st, ht, rf, rect = cxs.pack_sections(secs)
        out.update(xs_station=st, xs_height=ht, xs_rf=rf, xs_rect=rect)
    divs = []
    for i, r in enumerate(reaches):
        for dv in r.get("diversions", []):
            rule = str(dv["cprior"]).lower()
            if rule not in _DIVERSION_RULES:
                raise ValueError(f"unknown diversion rule {rule!r}")
            divs.append((i, int(dv["to"]), rule,
                         float(dv.get("flow", 0.0))))
    if divs:
        out.update(div_src=tuple(d[0] for d in divs),
                   div_to=tuple(d[1] for d in divs),
                   div_rule=tuple(d[2] for d in divs),
                   divflow=np.asarray([d[3] for d in divs]))
    return out


# -------------------------------------------------------------- augmented

def _tensors(spec, device):
    """The numpy arrays of a host spec as tensors on ``device``: integers
    int64, floats float64, bools bool; other values as they are."""
    out = {}
    for key, value in spec.items():
        if isinstance(value, np.ndarray):
            dtype = (torch.bool if value.dtype == bool
                     else torch.int64 if value.dtype.kind in "iu"
                     else torch.float64)
            value = torch.tensor(value, dtype=dtype, device=device)
        out[key] = value
    return out


class AugmentedGwfModel:
    """A GWF model and its MAW, LAK and SFR features as one (N+R)-row
    system: a drop-in model for ``NumericalSolution``, the fused step and
    ``Simulation`` (the reference's sln_connect + bnd_ac matrix
    expansion).  ``maw``, ``lak`` and ``sfr`` are the host specs of
    ``build_maw``, ``build_lak`` and ``build_sfr``; feature rows follow the
    grid rows in the order MAW, LAK, SFR.  ``mvr``: the movers of
    ``mvr.build_mvr`` (a list of dicts), whose providers and receivers
    must be present.  The model's tensors live on the base model's
    device."""

    # what the solvers read that the base model would answer otherwise
    wetdry = None
    csub = None
    csub_state0 = None
    is_linear = False
    use_structured = False

    def __init__(self, base, maw=None, lak=None, sfr=None, mvr=None,
                 ktot_min=0):
        if base.csub is not None:
            raise NotImplementedError(
                "CSUB with MAW, LAK or SFR is not ported (the reference's "
                "augmented model runs without CSUB)")
        if base.ixt3d:
            raise NotImplementedError(
                "XT3D with MAW, LAK or SFR is not ported (the reference "
                "cannot build it: its base table is Ktot wide)")
        if base.wetdry is not None:
            raise NotImplementedError(
                "rewetting with MAW, LAK or SFR is not ported")
        self.base = base
        # the host specs, for the sharded runner's per-shard builds
        self.specs = dict(maw=maw, lak=lak, sfr=sfr)
        device = base.device
        N = base.nodes
        offset = N
        pkg_edges = []
        specs = []
        for name, spec in (("maw", maw), ("lak", lak), ("sfr", sfr)):
            setattr(self, name, None)
            if spec is None:
                continue
            if name == "maw":
                rows, cells, owners = (spec["nwells"], spec["conn_node"],
                                       spec["conn_well"])
            elif name == "lak":
                rows, cells, owners = (spec["nlakes"], spec["conn_node"],
                                       spec["conn_lake"])
            else:
                rows, cells = spec["nreaches"], spec["node"]
                owners = np.arange(rows)
            specs.append((name, spec, offset, len(cells)))
            pkg_edges.append(np.stack([np.asarray(cells, np.int64),
                                       offset + np.asarray(owners,
                                                           np.int64)], 1))
            offset += rows
        self.n_grid = N
        self.n_extra = offset - N
        offs = {name: off for name, _, off, _ in specs}
        nconn = sum(len(e) for e in pkg_edges)
        # feature↔feature coupling edges after the connections: lake
        # outlets (dst, src) and SFR routing pairs (r, u)
        lak_out_edge = []
        if lak is not None:
            edge = nconn
            for src, dst in zip(lak["out_lake"], lak["out_to"]):
                if dst >= 0 and dst != src:
                    lak_out_edge.append(edge)
                    edge += 1
                    pkg_edges.append(np.asarray(
                        [[offs["lak"] + dst, offs["lak"] + src]], np.int64))
                else:
                    lak_out_edge.append(-1)
        sfr_pairs = None
        if sfr is not None:
            ups, fr = sfr["upstream"], sfr["frac"]
            rr = np.arange(sfr["nreaches"])[:, None]
            pr, pj = np.nonzero((fr != 0.0) & (ups != rr))
            sfr_pairs = (pr, ups[pr, pj], fr[pr, pj],
                         sum(len(e) for e in pkg_edges) + np.arange(
                             len(pr)))
            pkg_edges.append(np.stack([offs["sfr"] + pr,
                                       offs["sfr"] + ups[pr, pj]], 1))
        edges = (np.concatenate(pkg_edges) if pkg_edges
                 else np.zeros((0, 2), np.int64))
        if base.use_structured:
            base_nbr = structured_nbr(base._host_topo())
        else:
            base_nbr = base.dtopo.nbr.cpu().numpy()
        nbr_ext, slot_ab, slot_ba = _build_ext_table(
            base_nbr, N, self.n_extra, edges, ktot_min)
        self.Kb = base_nbr.shape[1]
        self.Ktot = nbr_ext.shape[1]
        self.dtopo = AugTopo(nbr=torch.as_tensor(nbr_ext, device=device))

        def t64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device)

        i = 0
        for name, spec, off, n_conn in specs:
            sab, sba = t64(slot_ab[i:i + n_conn]), t64(slot_ba[i:i + n_conn])
            i += n_conn
            if name == "maw":
                kw = _tensors(spec, device)
                data = MawData(
                    **kw, slot_cw=sab, slot_wc=sba,
                    active=torch.ones(spec["nwells"], dtype=torch.bool,
                                      device=device),
                    node_plan=AddPlan.build(kw["conn_node"], device, N),
                    well_plan=AddPlan.build(kw["conn_well"], device,
                                            spec["nwells"]))
            elif name == "lak":
                kw = _tensors(spec, device)
                if "conn_conv" not in kw:
                    ict = base.npf_arrays.icelltype
                    kw["conn_conv"] = ict[kw["conn_node"]] != 0
                data = LakData(
                    **kw, **self._outlet_fields(spec, lak_out_edge,
                                                slot_ab, device),
                    slot_cl=sab, slot_lc=sba,
                    active=torch.ones(spec["nlakes"], dtype=torch.bool,
                                      device=device),
                    node_plan=AddPlan.build(kw["conn_node"], device, N),
                    lake_plan=AddPlan.build(kw["conn_lake"], device,
                                            spec["nlakes"]))
            else:
                pr, pu, pf, pe = sfr_pairs
                kw = _tensors(spec, device)
                data = SfrData(
                    **kw, slot_cr=sab, slot_rc=sba,
                    active=torch.ones(spec["nreaches"], dtype=torch.bool,
                                      device=device),
                    up_pair_r=t64(pr), up_pair_u=t64(pu), up_pair_f=f64(pf),
                    up_pair_slot=t64(slot_ab[pe]),
                    node_plan=AddPlan.build(kw["node"], device, N),
                    pair_plan=AddPlan.build(pr, device, spec["nreaches"]))
            setattr(self, name, data)
            setattr(self, f"_{name}_offset", off)
        self.inewton = base.inewton
        self.inewtonur = base.inewtonur
        self.mvr = None
        if mvr:
            data = mvr_mod.build_mvr(mvr, device=device)
            base_pkgs = base.packages
            for pk in sorted(set(data.prov_pkg)):
                present = (getattr(base_pkgs, pk) is not None
                           if pk in ("wel", "drn", "riv", "ghb")
                           else getattr(self, pk, None) is not None)
                if not present:
                    raise ValueError(
                        f"mover provider {pk!r} not present in model")
            for rk in sorted(set(data.recv_pkg)):
                if getattr(self, rk, None) is None:
                    raise ValueError(
                        f"mover receiver {rk!r} not present in model")
            self.mvr = data

    @staticmethod
    def _outlet_fields(spec, out_edge, slot_ab, device):
        """The outlets' device fields: kinds, sources, the slots of the
        Jacobian-coupled ones, and the plans that add their terms in the
        reference's loop order (per outlet: the source lake's rhs, then the
        receiving lake's)."""
        src = np.asarray(spec["out_lake"], np.int64)
        dst = np.asarray(spec["out_to"], np.int64)
        O = len(spec["out_type"])
        for kind in spec["out_type"]:
            if kind not in _OUTLET_KINDS:
                raise ValueError(f"unknown lake outlet type {kind!r}")
        coupled = np.asarray([e >= 0 for e in out_edge], bool)
        targets = np.stack([src, dst], 1).reshape(-1)
        keep = np.stack([np.ones(O, bool), dst >= 0], 1).reshape(-1)
        out_slot = tuple(int(slot_ab[e]) if e >= 0 else -1 for e in out_edge)

        def t64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        return dict(
            out_src=t64(src),
            out_kind=t64([_OUTLET_KINDS.index(k) for k in spec["out_type"]]),
            out_is_coupled=torch.as_tensor(coupled, device=device),
            out_coupled=t64(np.nonzero(coupled)[0]),
            out_coupled_slot=t64([s for s in out_slot if s >= 0]),
            out_slot=out_slot or None,
            src_plan=AddPlan.build(src, device, spec["nlakes"]),
            out_plan=AddPlan.build(targets[keep], device, spec["nlakes"],
                                   sources=np.nonzero(keep)[0]))

    # ------------------------------------------------- model interface

    @property
    def nodes(self):
        return self.n_grid + self.n_extra

    @property
    def system_topo(self):
        return self.dtopo

    @property
    def device(self):
        return self.base.device

    @property
    def name(self):
        return self.base.name

    @property
    def grid(self):
        return self.base.grid

    @property
    def topo(self):
        return self.base.topo

    @property
    def area(self):
        return self.base.area

    @property
    def ixt3d(self):
        return 0

    @property
    def npf_arrays(self):
        return self.base.npf_arrays

    @property
    def sto_arrays(self):
        return self.base.sto_arrays

    @property
    def sto_opts(self):
        return self.base.sto_opts


    @property
    def strt(self):
        return torch.cat([self.base.strt] + [d.strt for _, d, _ in
                                             self.features()])

    @property
    def packages(self):
        return self.base.packages

    def boundary_state(self, x, pkgs=None):
        ibound, head = self.base.boundary_state(x[:self.n_grid], pkgs)
        ib_ext = torch.ones(self.n_extra, dtype=ibound.dtype,
                            device=ibound.device)
        return (torch.cat([ibound, ib_ext]),
                torch.cat([head, x[self.n_grid:]]))

    def assemble(self, x, x_old, ibound, delt, iss, pkgs=None,
                 newton: bool = True):
        N, Kb, Ktot = self.n_grid, self.Kb, self.Ktot
        diag_b, off_b, rhs_b = self.base.assemble(
            x[:N], x_old[:N], ibound[:N], delt, iss, pkgs, newton=newton)
        zeros = diag_b.new_zeros(self.n_extra)
        diag = torch.cat([diag_b, zeros])
        rhs = torch.cat([rhs_b, zeros])
        offf = diag_b.new_zeros((self.nodes, Ktot))
        # (the structured off of a grid without connections is six zero
        # columns, embedded in its one column)
        offf[:N, :Kb] = off_b.reshape(N, -1)[:, :Kb]
        offf = offf.reshape(-1)
        qto, qfrom = {}, {}
        if self.mvr is not None:
            _, qto, qfrom = self.eval_movers(x, ibound, pkgs)
        for name, data, off in self.features():
            data.terms(x, x_old, off, delt, iss, diag, offf, rhs,
                       **self._mover_args(name, qto, qfrom))
        return diag, offf.reshape(self.nodes, Ktot), rhs

    def features(self):
        """[(name, data, first row)] of the features present, in row
        order."""
        return [(name, d, getattr(self, f"_{name}_offset"))
                for name in ("maw", "lak", "sfr")
                if (d := getattr(self, name)) is not None]

    @staticmethod
    def _mover_args(name, qto, qfrom):
        """The mover keyword arguments of a feature's terms and budget."""
        out = {"qfrom": qfrom.get(name)}
        if name == "lak":
            out["qto_out"] = qto.get(name)
        elif name == "sfr":
            out["qto"] = qto.get(name)
        return out

    def edge_conductances(self, x, ibound, pkgs=None):
        return self.base.edge_conductances(x[:self.n_grid],
                                           ibound[:self.n_grid], pkgs)

    def edge_flows(self, x, ibound, cond=None, pkgs=None):
        return self.base.edge_flows(x[:self.n_grid], ibound[:self.n_grid],
                                    cond, pkgs)

    def flowja_csr(self, x, ibound, cond=None, pkgs=None):
        return self.base.flowja_csr(x[:self.n_grid], ibound[:self.n_grid],
                                    cond, pkgs)

    def cell_inflow(self, x, ibound, cond=None, pkgs=None):
        return self.base.cell_inflow(x[:self.n_grid], ibound[:self.n_grid],
                                     cond, pkgs)

    def boundary_budget(self, x, ibound, pkgs=None):
        out = self.base.boundary_budget(x[:self.n_grid],
                                        ibound[:self.n_grid], pkgs)
        if self.mvr is not None:
            # water a mover takes no longer leaves by the provider's own
            # fate: its reported rate shrinks by qto (the moved slice is
            # <PKG>-TO-MVR in advanced_budget)
            _, qto, _ = self.eval_movers(x, ibound, pkgs)
            for pk in ("wel", "drn", "riv", "ghb"):
                if pk in qto and out.get(pk.upper()) is not None:
                    out[pk.upper()] = out[pk.upper()] + qto[pk]
        return out

    def advanced_budget(self, x, x_old, delt, iss, pkgs=None):
        """{term: per-entry flows} of every feature package (maw_bd,
        lak_bd, sfr_bd), with the movers' -TO-MVR and -FROM-MVR terms."""
        qto, qfrom = {}, {}
        if self.mvr is not None:
            ib, _ = self.boundary_state(x, pkgs)
            _, qto, qfrom = self.eval_movers(x, ib, pkgs)
        out = {}
        for name, data, off in self.features():
            out.update(data.budget(x, x_old, off, delt, iss,
                                   **self._mover_args(name, qto, qfrom)))
        # standard-package providers: the moved slice is its own term
        # (BoundaryPackage.f90:670-684 relabeling)
        for pk in ("wel", "drn", "riv", "ghb"):
            if pk in qto:
                out[f"{pk.upper()}-TO-MVR"] = -qto[pk]
        return out

    # ---------------------------------------------------------- mover eval

    def _recv_sizes(self):
        sizes = {}
        if self.sfr is not None:
            sizes["sfr"] = self.sfr.nreaches
        if self.lak is not None:
            sizes["lak"] = self.lak.nlakes
        if self.maw is not None:
            sizes["maw"] = self.maw.nwells
        return sizes

    def available_water(self, x, ibound, pkgs=None):
        """{provider: f64[entries]} of the water a mover could take at
        the current iterate, the standard packages' and the features'."""
        N = self.n_grid
        p = pkgs if pkgs is not None else self.base.packages
        avail = mvr_mod.base_package_available(self.base, p, x[:N],
                                               ibound[:N])
        for name, data, off in self.features()[::-1]:
            avail[name] = data.available(x, off)
        return avail

    def eval_movers(self, x, ibound, pkgs=None):
        """Provider availabilities at the current iterate → the mover
        chain (gwf-mvr.f90 mvr_fc, Picard-lagged as in the reference).
        Returns (qp[M], qto: dict, qfrom: dict)."""
        return mvr_mod.run_movers(self.mvr,
                                  self.available_water(x, ibound, pkgs),
                                  self._recv_sizes())

    def mvr_budget(self, x, pkgs=None):
        """Per-mover moved rates (gwf-mvr.f90 budget role): a list of
        (provider, iprov, receiver, ircv, rate)."""
        if self.mvr is None:
            return []
        ib, _ = self.boundary_state(x, pkgs)
        qp, _, _ = self.eval_movers(x, ib, pkgs)
        m = self.mvr
        return [(m.prov_pkg[i], m.prov_id[i], m.recv_pkg[i], m.recv_id[i],
                 qp[i]) for i in range(m.nmovers)]
