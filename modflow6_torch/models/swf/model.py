"""SWF: surface-water flow models (diffusive wave), the CHF (channel,
DISV1D) and OLF (overland, DIS2D or DISV2D) model family.

Port of modflow6_tpu/models/swf/model.py (reference swf-dfw.f90 qcalc,
get_cond :707-790, get_cond_n :796-823 and the Newton fill by numerical
perturbation dfw_qnm_fc_nr :564-643; swf-sto.f90; FLW, ZDG (swf-zdg.f90),
PCP, EVP and CDB; chf.f90/olf.f90 over swf.f90).

The model drops the grid shape: the solver multiplies through the ELL
gather product and fixes rows through the table, on every grid (a DIS2D
raster keeps its fixed [E, W, N, S, U, D] slots).  The sums follow the
port's rules:
- the edge terms into the cells of each edge (the reference's
  ``.at[n].add`` / ``.at[m].add``) go through the ELL slots
  (``npf._row_sum``); the off-diagonal terms are stores into their slots;
- the package terms (FLW, the exchange's leakage, ZDG, PCP, EVP, CDB) go
  into their nodes through one ``AddPlan`` per node list, in entry order;
- the Newton fill's perturbation ``stage.at[node].add(eps)`` goes through
  the same plan, so a node listed k times is perturbed by the sum of its k
  steps, as in the reference;
- CHD's ``.at[node].set`` keeps, of several entries on one node, the last
  one (XLA's serial scatter on the CPU, which the tests check).

The host builders that the reference writes as loops (the reach pairs of
``Disv1dGrid.build_topology``, the per-node CXS assignment) are array code
whose arrays equal the loops'.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ... import resolve_device
from ...constants import DPREC, DZERO
from ...ops import cxs as cxs_mod
from ...ops.scatter import AddPlan
from ..discretization.topology import Topology
from ..gwf import npf as npf_mod

DEM10 = 1.0e-10
SMOOTH_RANGE = 1.0e-6
_SQRT_DPREC = math.sqrt(DPREC)


@dataclasses.dataclass(frozen=True)
class Disv1dGrid:
    """A 1-D network of reaches (the DISV1D role, Disv1d.f90): a length,
    width and bottom per reach, and the connected reach pairs."""

    nodes: int
    length: np.ndarray   # f64[n]
    width: np.ndarray    # f64[n]
    bot: np.ndarray      # f64[n] streambed elevation
    pairs: np.ndarray    # int64[E, 2] connected reaches

    def __post_init__(self):
        object.__setattr__(self, "pairs", np.asarray(
            self.pairs, np.int64).reshape(-1, 2))

    @staticmethod
    def chain(length, width, bot):
        length = np.asarray(length, np.float64)
        n = length.shape[0]
        width = np.broadcast_to(np.asarray(width, np.float64), (n,)).copy()
        bot = np.broadcast_to(np.asarray(bot, np.float64), (n,)).copy()
        i = np.arange(n - 1, dtype=np.int64)
        return Disv1dGrid(n, length, width, bot, np.stack([i, i + 1], 1))

    @property
    def shape(self):
        return (self.nodes,)

    @property
    def idomain(self):
        return np.ones(self.nodes, np.int32)

    @property
    def area(self):
        return self.length * self.width

    @property
    def top(self):
        return self.bot + 1e30   # unbounded stage

    def build_topology(self) -> Topology:
        a, b = self.pairs[:, 0], self.pairs[:, 1]
        n = np.minimum(a, b).astype(np.int32)
        m = np.maximum(a, b).astype(np.int32)
        ne = n.shape[0]
        return Topology(
            nodes=self.nodes, edge_n=n, edge_m=m,
            ihc=np.ones(ne, np.int32),
            cl1=0.5 * self.length[n], cl2=0.5 * self.length[m],
            # the flow width across the connection
            hwva=0.5 * (self.width[n] + self.width[m]),
            direction=np.full(ne, -1, np.int32), anglex=np.zeros(ne))


def _squadratic(x, rng=SMOOTH_RANGE):
    """Quadratic 0→1 smoothing of x over [0, rng] (sQuadratic)."""
    t = torch.clamp(x / rng, 0.0, 1.0)
    return t * (2.0 - t)


def _perturb(x):
    """Numerical-derivative step (MathUtil get_perturbation)."""
    return _SQRT_DPREC * torch.clamp(x.abs(), min=1.0)


@dataclasses.dataclass(frozen=True)
class SwfPackageData:
    """Stress data of one sweep.  ``lkg``: the SWF side of the SWF–GWF
    exchange, (node, bhead, cond): q into the reach is cond·(bhead −
    stage), infiltration smoothly shut off as the reach dries."""

    flw: object = None
    lkg: object = None


@dataclasses.dataclass
class SwfModel:
    """Diffusive-wave surface water model (the CHF/OLF engine).  Package
    tuples: flw (node, q, mask), chd (node, stage, mask), zdg (node, width,
    slope, rough, mask), pcp/evp (node, rate, mask), cdb (node, width,
    mask); nodes int64 on the model's device."""

    name: str
    grid: object                 # Disv1dGrid, DisGrid (nlay=1), Disv2dGrid
    topo: Topology
    dtopo: npf_mod.DeviceTopology
    bot: torch.Tensor            # f64[N] bed or land elevation
    manningsn: torch.Tensor      # f64[N]
    strt: torch.Tensor
    ibound0: torch.Tensor        # i32[N]
    area: torch.Tensor           # f64[N]
    unitconv: float = 1.0
    icentral: int = 1            # 1 central, 0 upstream depth weighting
    transient: bool = True
    flw: object = None
    chd: object = None
    zdg: object = None
    pcp: object = None
    evp: object = None
    cdb: object = None
    gravconv: float = 9.80665    # DGRAVITY·lengthconv·timeconv² (swf-cdb)
    inewton: int = 1
    xs_station: Optional[torch.Tensor] = None   # f64[N, P] (CXS)
    xs_height: Optional[torch.Tensor] = None
    xs_rf: Optional[torch.Tensor] = None        # f64[N, P-1]
    xs_rect: Optional[torch.Tensor] = None      # bool[N]
    has_xs: Optional[torch.Tensor] = None       # bool[N]

    def __post_init__(self):
        if self.dtopo.grid_shape is not None:
            raise ValueError("an SWF model multiplies through its ELL table: "
                             "its DeviceTopology has no grid shape")
        self._plans = {}
        self._chd_winners = None

    # the solver's surface: no structured path, no NPF (so no Newton
    # under-relaxation, rewetting or PTC volume), the edge table
    inewtonur = 0
    use_structured = False

    @property
    def nodes(self) -> int:
        return self.dtopo.nodes

    @property
    def device(self) -> torch.device:
        return self.strt.device

    @property
    def system_topo(self) -> npf_mod.DeviceTopology:
        return self.dtopo

    @property
    def is_linear(self) -> bool:
        return False

    @property
    def packages(self):
        return SwfPackageData(flw=self.flw)

    def plan(self, node) -> AddPlan:
        """The plan of ``out[node[i]] += v[i]`` in entry order, one per node
        tensor (kept while the tensor lives)."""
        got = self._plans.get(id(node))
        if got is None or got[0] is not node:
            got = (node, AddPlan.build(node, node.device, self.nodes))
            self._plans[id(node)] = got
        return got[1]

    def boundary_state(self, stage, pkgs=None):
        ibound = self.ibound0.clone()
        if self.chd is not None:
            node, val, mask = self.chd
            if self._chd_winners is None:
                # the last entry of each node sets it (an entry without
                # ``mask`` sets the node's own value back)
                rev = np.arange(node.shape[0])[::-1]
                _, first = np.unique(node.cpu().numpy()[rev],
                                     return_index=True)
                self._chd_winners = torch.as_tensor(
                    np.sort(rev[first]), dtype=torch.int64,
                    device=node.device)
            w = self._chd_winners
            nw, mw = node[w], mask[w]
            ibound[nw] = torch.where(mw, -1, ibound[nw])
            stage = stage.clone()
            stage[nw] = torch.where(mw, val[w], stage[nw])
        return ibound, stage

    # ----------------------------------------------------------- hydraulics

    def _conveyance(self, depth, width, rough):
        """Rectangular (wide-channel) conveyance a·r^(2/3)/rough, r = depth."""
        d = torch.clamp(depth, min=DZERO)
        return width * d * d ** (2.0 / 3.0) / rough

    def _conveyance_at(self, nodes, depth, width, rough):
        """An n-point section's conveyance (CXS) where the cell has one,
        the rectangular one elsewhere."""
        rect = self._conveyance(depth, width, rough)
        if self.xs_station is None:
            return rect
        cx = cxs_mod.conveyance(self.xs_station[nodes], self.xs_height[nodes],
                                self.xs_rf[nodes], rough,
                                torch.clamp(depth, min=DZERO),
                                self.xs_rect[nodes])
        return torch.where(self.has_xs[nodes], cx, rect)

    def _half_cond(self, nodes, depth, dx, width, dhds, rough):
        """get_cond_n: unitconv·conveyance/(dx·√dhds)."""
        dhds_sqr = torch.clamp(torch.sqrt(torch.clamp(dhds, min=DZERO)),
                               min=DEM10)
        return self.unitconv * self._conveyance_at(
            nodes, depth, width, rough) / dx / dhds_sqr

    def _edge_q(self, sn, sm):
        """Flow m→n per edge at the given end stages (qcalc)."""
        t = self.dtopo
        n, m = t.edge_n, t.edge_m
        length = t.cl1 + t.cl2
        depth_n = sn - self.bot[n]
        depth_m = sm - self.bot[m]
        dhds = (sm - sn).abs() / length
        if self.icentral == 0:
            up = torch.where(sn > sm, depth_n, depth_m)
            depth_n, depth_m = up, up
        depth_n = depth_n * _squadratic(depth_n)
        depth_m = depth_m * _squadratic(depth_m)
        cn = self._half_cond(n, depth_n, t.cl1, t.hwva, dhds,
                             self.manningsn[n])
        cm = self._half_cond(m, depth_m, t.cl2, t.hwva, dhds,
                             self.manningsn[m])
        cond = torch.where(cn + cm > DPREC, cn * cm / (cn + cm), DZERO)
        return cond * (sm - sn)

    def _zdg_q(self, stage):
        """ZDG outflow: q = −unitconv·conveyance(depth)·√S0."""
        node, width, slope, rough, mask = self.zdg
        depth = stage[node] - self.bot[node]
        depth = depth * _squadratic(depth)
        conv = self._conveyance(depth, width, rough)
        return torch.where(mask, -self.unitconv * conv * torch.sqrt(slope),
                           DZERO)

    def _q_lkg(self, lkg, st):
        node, bhead, lcond = lkg
        depth = st[node] - self.bot[node]
        f = _squadratic(depth, 1e-4)
        dh = bhead - st[node]
        return lcond * torch.where(dh < 0, f * dh, dh)

    def _q_evp(self, st):
        node, rate, _ = self.evp
        depth = st[node] - self.bot[node]
        return -rate * self.area[node] * _squadratic(depth, 1e-6)

    def _q_cdb(self, st):
        node, width_c, _ = self.cdb
        d = torch.clamp(st[node] - self.bot[node], min=DZERO)
        a = width_c * d
        val = self.gravconv * a * a * d
        return -torch.where(val > DPREC, torch.sqrt(val), DZERO)

    def _newton_fill(self, diag, rhs, stage, node, act, q_of):
        """A stage-dependent package term linearised by perturbing its
        nodes' stages: diag += dq/ds, rhs += −q + dq/ds·s at each node, in
        entry order."""
        plan = self.plan(node)
        q = q_of(stage)
        eps = _perturb(stage[node])
        qp = q_of(plan.add(stage, eps))
        dq = (qp - q) / eps
        diag = plan.add(diag, torch.where(act, dq, DZERO))
        rhs = plan.add(rhs, torch.where(act, -q + dq * stage[node], DZERO))
        return diag, rhs

    # ------------------------------------------------------------ assembly

    def assemble(self, stage, stage_old, ibound, delt, iss: bool,
                 pkgs=None, newton: bool = True):
        """The Newton system by edge-wise numerical perturbation
        (dfw_qnm_fc_nr), storage and the boundary packages: (diag[N],
        off[N, K], rhs[N])."""
        t = self.dtopo
        n, m = t.edge_n, t.edge_m
        N, K = self.nodes, t.max_degree
        act_e = (ibound[n] != 0) & (ibound[m] != 0)

        sn, sm = stage[n], stage[m]
        q0 = self._edge_q(sn, sm)
        en = _perturb(sn)
        em = _perturb(sm)
        dq_dn = (self._edge_q(sn + en, sm) - q0) / en
        dq_dm = (self._edge_q(sn, sm + em) - q0) / em
        q0 = torch.where(act_e, q0, DZERO)
        dq_dn = torch.where(act_e, dq_dn, DZERO)
        dq_dm = torch.where(act_e, dq_dm, DZERO)

        # row n: rhs −= q; amat(n,n) += dq/dsn; amat(n,m) += dq/dsm;
        # rhs += dq/dsn·sn + dq/dsm·sm (the Newton linearisation)
        diag = npf_mod._row_sum(t, dq_dn, -dq_dm)
        off = torch.zeros(N * K, dtype=stage.dtype, device=stage.device)
        off[t.slot_nm] = dq_dm
        off[t.slot_mn] = -dq_dn
        rhs = npf_mod._row_sum(t, -q0 + dq_dn * sn + dq_dm * sm,
                               q0 - dq_dm * sm - dq_dn * sn)

        # storage: A·(depth − depth_old)/delt leaves the cell
        if self.transient and not iss:
            dnew = stage - self.bot
            fnew = _squadratic(dnew)
            dold = stage_old - self.bot
            dold = dold * _squadratic(dold)
            eps = _perturb(stage)
            dpert = (stage + eps) - self.bot
            vterm = self.area / delt
            dvds = vterm * ((dpert * _squadratic(dpert) - dnew * fnew) / eps)
            q_sto = -vterm * (dnew * fnew - dold)
            act = ibound > 0
            diag = diag + torch.where(act, -dvds, DZERO)
            rhs = rhs + torch.where(act, -q_sto - dvds * stage, DZERO)

        flw = self.flw
        if pkgs is not None and pkgs.flw is not None:
            flw = pkgs.flw
        if flw is not None:
            node, qin, mask = flw
            act = mask & (ibound[node] > 0)
            rhs = self.plan(node).add(rhs, torch.where(act, -qin, DZERO))

        lkg = pkgs.lkg if pkgs is not None else None
        if lkg is not None:
            node = lkg[0]
            diag, rhs = self._newton_fill(
                diag, rhs, stage, node, ibound[node] > 0,
                lambda st: self._q_lkg(lkg, st))

        if self.zdg is not None:
            node, mask = self.zdg[0], self.zdg[4]
            diag, rhs = self._newton_fill(
                diag, rhs, stage, node, mask & (ibound[node] > 0),
                self._zdg_q)

        # PCP: rate × area, stage-independent (swf-pcp.f90)
        if self.pcp is not None:
            node, rate, mask = self.pcp
            act = mask & (ibound[node] > 0)
            rhs = self.plan(node).add(
                rhs, torch.where(act, -rate * self.area[node], DZERO))

        # EVP: −rate × area, smoothly shut off as the reach dries
        if self.evp is not None:
            node, mask = self.evp[0], self.evp[2]
            diag, rhs = self._newton_fill(
                diag, rhs, stage, node, mask & (ibound[node] > 0),
                self._q_evp)

        # CDB critical-depth outflow: q = −√(gravconv·a²·r) (swf-cdb.f90)
        if self.cdb is not None:
            node, mask = self.cdb[0], self.cdb[2]
            diag, rhs = self._newton_fill(
                diag, rhs, stage, node, mask & (ibound[node] > 0),
                self._q_cdb)

        return diag, off.view(N, K), rhs

    def edge_conductances(self, stage, ibound, pkgs=None):
        return torch.zeros_like(self.dtopo.cl1)

    def edge_flows(self, stage, ibound, cond=None, pkgs=None):
        """Per-edge flow, positive into edge_n (dfw_cq)."""
        t = self.dtopo
        q = self._edge_q(stage[t.edge_n], stage[t.edge_m])
        act = (ibound[t.edge_n] != 0) & (ibound[t.edge_m] != 0)
        return torch.where(act, q, DZERO)

    def cell_inflow(self, q_edge):
        """Per cell, the sum of the edge flows into it, through the ELL
        slots (the reference's host ``np.add.at`` over the edges)."""
        return npf_mod._row_sum(self.dtopo, q_edge, -q_edge)

    def boundary_budget(self, stage, ibound, pkgs=None):
        """Per-entry flows of each package, positive into the model."""
        out = {}
        if self.flw is not None:
            node, qin, mask = self.flw
            out["FLW"] = torch.where(mask & (ibound[node] > 0), qin, DZERO)
        lkg = pkgs.lkg if pkgs is not None else None
        if lkg is not None:
            node = lkg[0]
            out["LKG"] = torch.where(ibound[node] > 0,
                                     self._q_lkg(lkg, stage), DZERO)
        if self.zdg is not None:
            out["ZDG"] = self._zdg_q(stage)
        if self.pcp is not None:
            node, rate, mask = self.pcp
            out["PCP"] = torch.where(mask & (ibound[node] > 0),
                                     rate * self.area[node], DZERO)
        if self.evp is not None:
            node, _, mask = self.evp
            out["EVP"] = torch.where(mask & (ibound[node] > 0),
                                     self._q_evp(stage), DZERO)
        if self.cdb is not None:
            node, width_c, mask = self.cdb
            d = torch.clamp(stage[node] - self.bot[node], min=DZERO)
            val = self.gravconv * (width_c * d) ** 2 * d
            out["CDB"] = torch.where(
                mask & (ibound[node] > 0),
                -torch.where(val > DPREC, torch.sqrt(val), DZERO), DZERO)
        return out


def _pack(entries, ncols, device):
    if entries is None or len(entries) == 0:
        return None
    arr = np.asarray(entries, np.float64).reshape(-1, ncols + 1)
    node = torch.as_tensor(arr[:, 0].astype(np.int64), device=device)
    cols = [torch.as_tensor(arr[:, i + 1].copy(), dtype=torch.float64,
                            device=device) for i in range(ncols)]
    return (node, *cols, torch.ones(arr.shape[0], dtype=torch.bool,
                                    device=device))


def node_sections(cxs_sections, idcxs, width, nodes):
    """The per-node CXS table (the reference's loop over the nodes,
    swf/model.py:489-499, as array code): each node's section id (1-based;
    0 or out of range: none), its stations scaled by the node's width;
    nodes without one get ([0, 1], [0, 0]).  Returns (stations, heights,
    rough_frac, rect, has) equal to ``cxs.pack_sections`` of the
    per-node list."""
    width = np.broadcast_to(np.asarray(width, np.float64), (nodes,))
    isec = (np.full(nodes, -1, np.int64) if idcxs is None
            else np.asarray(idcxs, np.int64).reshape(-1) - 1)
    has = (isec >= 0) & (isec < len(cxs_sections))
    secs = [(np.asarray(s[0], np.float64), s[1],
             s[2] if len(s) > 2 else None) for s in cxs_sections]
    default = (np.array([0.0, 1.0]), np.array([0.0, 0.0]), None)
    used = np.unique(isec[has])
    lens = [len(secs[i][0]) for i in used] + ([2] if (~has).any() else [])
    st, ht, rf, _ = cxs_mod.pack_sections(secs + [default])
    P = max(max(lens), 4)
    st, ht, rf = st[:, :P], ht[:, :P], rf[:, :P - 1]
    npt = np.array([len(s[0]) for s in secs] + [2])
    row = np.where(has, isec, len(secs))
    st = st[row] * np.where(has, width, 1.0)[:, None]
    # the default section is not scaled: 1.0·x leaves x as it is
    n = npt[row]
    rect = (n == 4) & (st[:, 0] == st[:, 1]) & (st[:, 2] == st[:, 3])
    return st, ht[row], rf[row], rect, has


def build_chf(name, grid: Disv1dGrid, *, manningsn=0.035, strt=None,
              unitconv=1.0, icentral=1, flw=None, chd=None, zdg=None,
              pcp=None, evp=None, cdb=None, transient=True,
              cxs_sections=None, idcxs=None, device=None) -> SwfModel:
    """Channel-flow model (chf.f90) on a reach network.  ``cxs_sections``:
    (xfraction, height[, manfraction]) n-point sections; ``idcxs``: the
    1-based section of each reach (0: rectangular).  ``device=None`` is the
    CUDA device."""
    return _build_swf(name, grid, manningsn, strt, unitconv, icentral,
                      flw, chd, zdg, transient, cxs_sections, idcxs,
                      pcp=pcp, evp=evp, cdb=cdb, device=device)


def build_olf(name, grid, *, manningsn=0.035, strt=None, unitconv=1.0,
              icentral=1, flw=None, chd=None, zdg=None, pcp=None, evp=None,
              cdb=None, transient=True, cxs_sections=None, idcxs=None,
              device=None) -> SwfModel:
    """Overland-flow model (olf.f90) on a DIS raster (nlay=1) or a DISV2D
    mesh; the grid's bottom is the land surface."""
    return _build_swf(name, grid, manningsn, strt, unitconv, icentral,
                      flw, chd, zdg, transient, cxs_sections, idcxs,
                      pcp=pcp, evp=evp, cdb=cdb, device=device)


def _build_swf(name, grid, manningsn, strt, unitconv, icentral, flw, chd,
               zdg, transient, cxs_sections=None, idcxs=None, pcp=None,
               evp=None, cdb=None, device=None):
    device = resolve_device(device)
    topo = (grid.build_edge_topology() if hasattr(grid, "build_edge_topology")
            else grid.build_topology())
    # the gather path on every grid: the Jacobian is edge-assembled
    dtopo = dataclasses.replace(npf_mod.DeviceTopology.from_host(topo, device),
                                grid_shape=None)
    N = grid.nodes

    def full(v):
        return torch.as_tensor(np.broadcast_to(
            np.asarray(v, np.float64), (N,)).copy(), device=device)

    bot = full(np.asarray(grid.bot, np.float64).reshape(-1))
    xs = {}
    if cxs_sections:
        st, ht, rf, rect, has = node_sections(
            cxs_sections, idcxs, getattr(grid, "width", 1.0), N)
        xs = dict(xs_station=torch.as_tensor(st, device=device),
                  xs_height=torch.as_tensor(ht, device=device),
                  xs_rf=torch.as_tensor(rf, device=device),
                  xs_rect=torch.as_tensor(rect, device=device),
                  has_xs=torch.as_tensor(has, device=device))
    return SwfModel(
        name=name, grid=grid, topo=topo, dtopo=dtopo, bot=bot,
        manningsn=full(manningsn),
        strt=bot + 0.0 if strt is None else full(strt),
        ibound0=torch.as_tensor(
            (np.asarray(grid.idomain).reshape(-1) > 0).astype(np.int32),
            device=device),
        area=full(np.asarray(grid.area, np.float64).reshape(-1)),
        unitconv=unitconv, icentral=icentral, transient=transient,
        flw=_pack(flw, 1, device), chd=_pack(chd, 1, device),
        zdg=_pack(zdg, 3, device), pcp=_pack(pcp, 1, device),
        evp=_pack(evp, 1, device), cdb=_pack(cdb, 1, device), **xs)
