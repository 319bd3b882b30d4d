"""APT: advanced-package transport (LKT, SFT, MWT, UZT) and mover
transport (MVT); with a GWE base, their heat analogs (LKE, SFE, MWE, UZE,
MVE).

Port of modflow6_tpu/models/gwt/apt.py (``AptFlows``,
``AugmentedGwtModel``, ``extract_apt_flows``, ``CoupledAugmented``;
reference tsp-apt.f90, tsp-mvt.f90 and gwt-uzt.f90): every feature of the
matching ``AugmentedGwfModel`` (and every UZF column, with ``uzf``) gets a
concentration row after the grid rows, x = [conc(N), c_feat(R)].  A
feature row holds its storage d(V·c)/dt, the upstream-weighted exchange
with its cells at the flow model's connection flows, external inflows at
their source concentration, outflows at its own concentration, and the
feature→feature transfers (lake outlets, SFR routing and diversions,
movers between features); movers from a standard package's entry bring
the provider cell's concentration.  The flow is frozen within a transport
step, so every term is linear and enters the matrix directly.  A GWE base
scales them all by its eqnsclfac.

The edges are built once on the host as array code whose arrays equal the
reference's loops (``nbr_ext``, ``slot_cf``, ``slot_fc``, ``slot_pair``,
``pair_dst``, ``slot_mvr_cell``, ``mvr_cell_dst``, ``conn_cell``,
``conn_feat`` and the order of ``_pairs``), through the augmented flow
model's ``_build_ext_table``, which gives every edge end its own slot: the
coupling terms are stores to distinct slots.  The sums that repeat their
targets (a well's or a lake's connections into its row, the connections of
one cell, the outlets of one lake) go through ``AddPlan``s built with the
model, in connection (or outlet) order.  ``extract_apt_flows`` takes the
feature→feature flows from index arrays built with the model, in
``_pairs`` order: the routing pairs as one gather, each diversion's flow
from one pass of the SFR chain, the lake outlets and the movers as
gathers of the whole outlet and mover vectors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...constants import DZERO
from ...ops import cxs
from ...ops.scatter import AddPlan
from ..gwf.advanced import AugTopo, _build_ext_table


@dataclasses.dataclass(frozen=True)
class AptFlows:
    """The coupling data of one transport step.

    fields:   the grid's fmi.FlowFields
    q_conn:   f64[C] flow of each feature↔cell connection (positive into
              the aquifer), in the connection edges' order
    v_new, v_old: f64[R] feature volumes at the new and old time level
    ext_q:    f64[R] external inflow of each feature
    ext_conc: f64[R] source concentration of ext_q
    out_q:    f64[R] outflow leaving each feature at its own concentration
    pair_q:   f64[P] flow of each feature→feature edge (``_pairs`` order)
    mvr_cell_q: f64[M] flow moved from a standard package's entry into a
              feature, at the provider cell's concentration
    mvr_cell_node: the receiving feature row of each of those
    """

    fields: object
    q_conn: torch.Tensor
    v_new: torch.Tensor
    v_old: torch.Tensor
    ext_q: torch.Tensor
    ext_conc: torch.Tensor
    out_q: torch.Tensor
    pair_q: torch.Tensor
    mvr_cell_q: torch.Tensor
    mvr_cell_node: torch.Tensor


_FEATURES = ("maw", "lak", "sfr")


class AugmentedGwtModel:
    """A GWT (or GWE) model and the concentration rows of the MAW, LAK and
    SFR features of a matching ``AugmentedGwfModel``; ``uzf``: UZF columns
    (``uzf.UzfColumns``), one row each after the features (UZT: storage is
    the θ-volume, the accepted infiltration enters at its source
    concentration, the water-table recharge leaves to the cell).  A drop-in
    model for ``NumericalSolution`` and ``Simulation(gwt=)``; its tensors
    live on the base model's device."""

    use_structured = False
    inewton = 0
    packages = None
    ist = None

    def __init__(self, base, gwf_aug, uzf=None):
        if gwf_aug.n_grid != base.nodes:
            raise ValueError("transport and flow grids differ")
        if getattr(base, "ist", None) is not None:
            raise NotImplementedError(
                "IST with APT rows (the reference's APT step never updates "
                "the immobile domain)")
        self.base = base
        self.gwf = gwf_aug
        self.uzf = uzf
        device = base.device
        N = base.nodes
        self.n_grid = N
        n_uzf = int(uzf.node.shape[0]) if uzf is not None else 0
        self._uzf_off = gwf_aug.n_extra     # UZF rows after the features
        self.n_extra = gwf_aug.n_extra + n_uzf
        off = {name: getattr(gwf_aug, f"_{name}_offset", N) - N
               for name in _FEATURES}

        # connection edges (cell, feature row) in the flow model's order
        cells, feats = [], []
        for name in _FEATURES:
            d = getattr(gwf_aug, name)
            if d is None:
                continue
            if name == "maw":
                c, o = d.conn_node, d.conn_well
            elif name == "lak":
                c, o = d.conn_node, d.conn_lake
            else:
                c = d.node
                o = torch.arange(d.nreaches)
            cells.append(c.cpu().numpy())
            feats.append(off[name] + o.cpu().numpy())
        if uzf is not None:
            cells.append(uzf.node.cpu().numpy())
            feats.append(self._uzf_off + np.arange(n_uzf))
        conn_cell = np.concatenate(cells).astype(np.int64) if cells \
            else np.zeros(0, np.int64)
        conn_feat = np.concatenate(feats).astype(np.int64) if feats \
            else np.zeros(0, np.int64)

        # feature→feature edges (dst row, src row): lake outlets, SFR
        # routing pairs, SFR diversions, movers between features
        lak, sfr, mvr = gwf_aug.lak, gwf_aug.sfr, gwf_aug.mvr
        pairs = []             # (kind, dst rows, src rows, [info])
        lak_sel = pu = pf = np.zeros(0, np.int64)
        if lak is not None:
            src = np.asarray(lak.out_lake, np.int64).reshape(-1)
            dst = np.asarray(lak.out_to, np.int64).reshape(-1)
            lak_sel = np.nonzero((dst >= 0) & (dst != src))[0]
            pairs.append(("lak_out", off["lak"] + dst[lak_sel],
                          off["lak"] + src[lak_sel], lak_sel.tolist()))
        if sfr is not None:
            ups = sfr.upstream.cpu().numpy()
            fr = sfr.frac.cpu().numpy()
            rr = np.arange(sfr.nreaches)[:, None]
            pr, pj = np.nonzero((fr != 0.0) & (ups != rr))
            pu, pf = ups[pr, pj], fr[pr, pj]
            pairs.append(("sfr_route", off["sfr"] + pr, off["sfr"] + pu,
                          list(zip(pr.tolist(), pu.tolist(), pf.tolist()))))
            dsrc = np.asarray(sfr.div_src, np.int64).reshape(-1)
            dto = np.asarray(sfr.div_to, np.int64).reshape(-1)
            pairs.append(("sfr_div", off["sfr"] + dto, off["sfr"] + dsrc,
                          list(range(dsrc.size))))
        mvr_feat, mvr_cell, cell_edges = [], [], []
        if mvr is not None:
            fdst, fsrc = [], []
            for i in range(mvr.nmovers):
                pk, rk = mvr.prov_pkg[i], mvr.recv_pkg[i]
                if rk not in off or getattr(gwf_aug, rk) is None:
                    continue
                dst = off[rk] + mvr.recv_id[i]
                if pk in off:
                    # a feature provider's concentration; a lake's entry is
                    # its outlet, whose source lake provides
                    feat = (int(lak.out_lake[mvr.prov_id[i]]) if pk == "lak"
                            else mvr.prov_id[i])
                    mvr_feat.append(i)
                    fdst.append(dst)
                    fsrc.append(off[pk] + feat)
                else:
                    mvr_cell.append(i)
                    cell_edges.append((dst, pk, mvr.prov_id[i]))
            pairs.append(("mvr", np.asarray(fdst, np.int64),
                          np.asarray(fsrc, np.int64), mvr_feat))
        self._pairs = [(kind, info) for kind, _, _, infos in pairs
                       for info in infos]
        pair_dst = np.concatenate([d for _, d, _, _ in pairs]).astype(
            np.int64) if pairs else np.zeros(0, np.int64)
        pair_src = np.concatenate([s for _, _, s, _ in pairs]).astype(
            np.int64) if pairs else np.zeros(0, np.int64)
        # movers from a standard package's entry: its cell's concentration
        mvr_cell_dst = np.asarray([d for d, _, _ in cell_edges], np.int64)
        node_of = {}
        for _, pk, _ in cell_edges:
            if pk not in node_of:
                node_of[pk] = getattr(gwf_aug.base.packages, pk).node.cpu() \
                    .numpy()
        mvr_cell_src = np.asarray([node_of[pk][j] for _, pk, j in cell_edges],
                                  np.int64)
        self._mvr_feat, self._mvr_cell = mvr_feat, mvr_cell

        edges = np.concatenate([
            np.stack([conn_cell, N + conn_feat], 1),
            np.stack([N + pair_dst, N + pair_src], 1),
            np.stack([N + mvr_cell_dst, mvr_cell_src], 1)]).reshape(-1, 2)
        base_nbr = base.dtopo.nbr.cpu().numpy()
        nbr_ext, slot_ab, slot_ba = _build_ext_table(base_nbr, N,
                                                     self.n_extra, edges)
        self.dtopo = AugTopo(nbr=torch.as_tensor(nbr_ext, device=device))
        self.Kb = base_nbr.shape[1]
        self.Ktot = nbr_ext.shape[1]
        nc, npair = conn_cell.size, pair_dst.size

        def t64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        # connection slots: ab = (cell, feat), ba = (feat, cell)
        self.slot_cf = t64(slot_ab[:nc])
        self.slot_fc = t64(slot_ba[:nc])
        self.conn_feat = t64(conn_feat)
        self.conn_cell = t64(conn_cell)
        # pair slots: ab = (dst, src)
        self.slot_pair = t64(slot_ab[nc:nc + npair])
        self.pair_dst = t64(pair_dst)
        self.slot_mvr_cell = t64(slot_ab[nc + npair:])
        self.mvr_cell_dst = t64(mvr_cell_dst)
        # the repeated sums, in connection order: into the feature rows
        # (and the per-feature budget) and into the cells
        self.feat_plan = AddPlan.build(conn_feat, device, self.n_extra)
        self.cell_plan = AddPlan.build(conn_cell, device, N)
        # extract_apt_flows' gathers, in _pairs order
        self._lak_pairs = t64(lak_sel)
        self._route = (t64(pu), torch.as_tensor(pf, dtype=torch.float64,
                                                device=device))
        self._mvr_feat_idx = t64(mvr_feat)
        self._mvr_cell_idx = t64(mvr_cell)
        self.strt_extra: Optional[torch.Tensor] = None

    # ----------------------------------------------------- model surface

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
    def eqnsclfac(self):
        return self.base.eqnsclfac

    @property
    def is_linear(self):
        return self.base.is_linear

    @property
    def strt(self):
        extra = self.strt_extra
        if extra is None:
            extra = self.base.strt.new_zeros(self.n_extra)
        return torch.cat([self.base.strt, extra])

    def boundary_state(self, x, pkgs=None):
        ib, conc = self.base.boundary_state(x[:self.n_grid])
        return (torch.cat([ib, ib.new_ones(self.n_extra)]),
                torch.cat([conc, x[self.n_grid:]]))

    def assemble(self, x, x_old, ibound, delt, iss, pkgs: AptFlows = None,
                 newton: bool = True):
        """The augmented transport system at x; ``pkgs`` carries the
        step's ``AptFlows`` (tsp-apt.f90 apt_fc_expanded)."""
        N, Kb, Ktot, R = self.n_grid, self.Kb, self.Ktot, self.n_extra
        f = pkgs
        esf = self.eqnsclfac
        diag_b, off_b, rhs_b = self.base.assemble(
            x[:N], x_old[:N], ibound[:N], delt, iss, f.fields)
        zeros = diag_b.new_zeros(R)
        diag = torch.cat([diag_b, zeros])
        rhs = torch.cat([rhs_b, zeros])
        off = diag_b.new_zeros((self.nodes, Ktot))
        off[:N, :Kb] = off_b.reshape(N, Kb)
        off = off.view(-1)
        fdiag, frhs = diag[N:], rhs[N:]
        x_old_f = x_old[N:]

        # feature storage d(V·c)/dt
        if not iss:
            fdiag += -(f.v_new / delt * esf)
            frhs += -(f.v_old / delt * esf) * x_old_f

        # feature↔cell exchange, upstream weighted: q > 0 leaves the
        # feature at c_f into the cell, q < 0 enters the feature at the
        # cell's concentration; constant-concentration cells still
        # exchange (their rows are pinned by the fixup afterwards)
        q = f.q_conn * esf
        act = ibound[self.conn_cell] != 0
        qp = torch.where(act, torch.clamp(q, min=DZERO), DZERO)
        qm = torch.where(act, torch.clamp(-q, min=DZERO), DZERO)
        self.feat_plan.add_(fdiag, -qp)
        off[self.slot_fc] += qm
        self.cell_plan.add_(diag, -qm)
        off[self.slot_cf] += qp

        # external inflows at their source concentration; outflows at c_f
        fdiag += -f.out_q * esf
        frhs += -f.ext_q * f.ext_conc * esf

        # feature→feature transfers at the source feature's concentration,
        # and movers from a standard package at its cell's
        if self.slot_pair.shape[0] > 0:
            off[self.slot_pair] += f.pair_q * esf
        if self.slot_mvr_cell.shape[0] > 0:
            off[self.slot_mvr_cell] += f.mvr_cell_q * esf

        # a dead feature (no volume, no flow) keeps its old concentration
        dead = ((f.v_new + f.out_q + f.ext_q) * esf < 1e-30) \
            & (self.feat_plan.sum(qp + qm) < 1e-30)
        fdiag += torch.where(dead, -1.0, DZERO)
        frhs += torch.where(dead, -x_old_f, DZERO)
        return diag, off.view(self.nodes, Ktot), rhs

    def edge_conductances(self, x, ibound, pkgs=None):
        return self.base.edge_conductances(x[:self.n_grid],
                                           ibound[:self.n_grid])

    def feature_budget(self, x, x_old, delt, flows: AptFlows):
        """Per-feature mass (or energy) rates (apt_bd): storage, the
        exchange with the aquifer, external inflow, outflow."""
        N = self.n_grid
        esf = self.eqnsclfac
        cf = x[N:]
        q = flows.q_conn * esf
        qp = torch.clamp(q, min=DZERO)
        qm = torch.clamp(-q, min=DZERO)
        return {
            "APT-STO": -(flows.v_new * cf - flows.v_old * x_old[N:])
            / delt * esf,
            "APT-GWF": self.feat_plan.sum(-qp * cf[self.conn_feat]
                                          + qm * x[self.conn_cell]),
            "APT-IN": flows.ext_q * flows.ext_conc * esf,
            "APT-OUT": -flows.out_q * cf * esf,
        }


def extract_apt_flows(gwt_aug: AugmentedGwtModel, x_flow, x_flow_old,
                      fields, delt, iss, pkgs=None, ext_conc=None,
                      uzf_res=None, uzf_theta_old=None) -> AptFlows:
    """``AptFlows`` of a solved step of the matching AugmentedGwfModel
    (FMI's hand-off for the feature rows).

    ``ext_conc``: feature package name ("maw", "lak", "sfr", "uzf") →
    source concentration of its external inflows, a scalar or one value
    per feature.  ``uzf_res`` / ``uzf_theta_old``: the step's
    ``uzf.UzfResult`` and the step-start water contents, when the model
    has UZT rows."""
    gwf = gwt_aug.gwf
    N = gwf.n_grid
    R = gwt_aug.n_extra
    ext_conc = ext_conc or {}
    v_new = x_flow.new_zeros(R)
    v_old = x_flow.new_zeros(R)
    ext_q = x_flow.new_zeros(R)
    ext_c = x_flow.new_zeros(R)
    out_q = x_flow.new_zeros(R)
    qp_list = []

    qp_all, qto = None, {}
    if gwf.mvr is not None:
        ib, _ = gwf.boundary_state(x_flow, pkgs)
        qp_all, qto, _ = gwf.eval_movers(x_flow, ib, pkgs)

    def conc_of(name, n):
        return torch.as_tensor(ext_conc.get(name, 0.0), dtype=torch.float64,
                               device=x_flow.device).expand(n)

    if gwf.maw is not None:
        d = gwf.maw
        row = gwf._maw_offset
        sl = slice(row - N, row - N + d.nwells)
        hw = x_flow[row:row + d.nwells]
        hw0 = x_flow_old[row:row + d.nwells]
        qp_list.append(d.cond * d.active[d.conn_well]
                       * (hw[d.conn_well] - x_flow[d.conn_node]))
        v_new[sl] = d.area * torch.clamp(hw - d.bottom, min=1e-8)
        v_old[sl] = d.area * torch.clamp(hw0 - d.bottom, min=1e-8)
        # injection enters at the source concentration, pumping leaves
        # at the well's
        rate, _ = d.rate_actual_and_deriv(x_flow, row)
        ext_q[sl] += torch.clamp(rate, min=0.0)
        ext_c[sl] = conc_of("maw", d.nwells)
        out_q[sl] += torch.clamp(-rate, min=0.0)
        if d.fw_cond is not None:
            qfw, _ = d.flowing_well_q(x_flow, row)
            out_q[sl] += torch.clamp(-qfw, min=0.0)

    qo = None
    if gwf.lak is not None:
        d = gwf.lak
        row = gwf._lak_offset
        sl = slice(row - N, row - N + d.nlakes)
        s = x_flow[row:row + d.nlakes]
        s0 = x_flow_old[row:row + d.nlakes]
        h = x_flow[d.conn_node]
        sc = s[d.conn_lake]
        qp_list.append(d.conn_cond(sc, h) * d.active[d.conn_lake]
                       * torch.where(h > d.belev, sc - h, sc - d.belev))
        v_new[sl] = d.volume_of(s)
        v_old[sl] = d.volume_of(s0)
        ext_q[sl] += d.rainfall * d.active
        ext_c[sl] = conc_of("lak", d.nlakes)
        out_q[sl] += d.withdrawal * d.active
        # evaporation removes water, not mass: excluded
        if d.out_type:
            qo, _ = d.outlet_flows(x_flow, row)
            d.src_plan.add_(out_q[sl], qo)

    if gwf.sfr is not None:
        d = gwf.sfr
        row = gwf._sfr_offset
        sl = slice(row - N, row - N + d.nreaches)
        st = x_flow[row:row + d.nreaches]
        st0 = x_flow_old[row:row + d.nreaches]
        h = x_flow[d.node]
        qp_list.append(d.cond * d.active * torch.where(
            h > d.strtop, st - h, st - d.strtop))
        dnew = torch.clamp(st - d.strtop, min=0.0)
        dold = torch.clamp(st0 - d.strtop, min=0.0)
        if d.xs_station is not None:
            a_new = cxs.wetted_area(d.xs_station, d.xs_height, dnew)
            a_old = cxs.wetted_area(d.xs_station, d.xs_height, dold)
        else:
            a_new = d.width * dnew
            a_old = d.width * dold
        v_new[sl] = a_new * d.length
        v_old[sl] = a_old * d.length
        ext_q[sl] += (d.inflow + d.runoff + d.rainfall) * d.active
        ext_c[sl] = conc_of("sfr", d.nreaches)
        q_man, _ = d._manning(st)
        out_q[sl] += q_man * d.active

    if gwt_aug.uzf is not None:
        u = gwt_aug.uzf
        if uzf_res is None or uzf_theta_old is None:
            raise ValueError("UZT rows need uzf_res and uzf_theta_old")
        C = u.node.shape[0]
        sl = slice(gwt_aug._uzf_off, gwt_aug._uzf_off + C)
        dz = (u.celtop - u.celbot) / u.nz
        v_new[sl] = uzf_res.theta.sum(dim=1) * dz * u.area
        v_old[sl] = uzf_theta_old.sum(dim=1) * dz * u.area
        # the accepted infiltration enters at its source concentration;
        # the recharge leaves to the cell through the connection; ET
        # removes water, not mass
        ext_q[sl] += torch.clamp((u.finf - uzf_res.rej) * u.area, min=0.0)
        ext_c[sl] = conc_of("uzf", C)
        qp_list.append(uzf_res.rch * u.area)

    # feature→feature flows in _pairs order
    parts = []
    if gwf.lak is not None:
        q = qo if qo is not None else x_flow.new_zeros(0)
        if "lak" in qto:
            q = q - qto["lak"]
        parts.append(torch.clamp(q[gwt_aug._lak_pairs], min=0.0))
    if gwf.sfr is not None:
        d = gwf.sfr
        row = gwf._sfr_offset
        q_man, _ = d._manning(x_flow[row:row + d.nreaches])
        qd, _, div_q = d.routing(q_man * d.active, qto.get("sfr"))
        up, frac = gwt_aug._route
        parts += [frac * qd[up], div_q]
    if gwf.mvr is not None:
        parts.append(qp_all[gwt_aug._mvr_feat_idx])
    pair_q = torch.cat(parts) if parts else x_flow.new_zeros(0)
    mvr_cell_q = (qp_all[gwt_aug._mvr_cell_idx] if qp_all is not None
                  else x_flow.new_zeros(0))
    q_conn = torch.cat(qp_list) if qp_list else x_flow.new_zeros(0)
    return AptFlows(fields=fields, q_conn=q_conn, v_new=v_new, v_old=v_old,
                    ext_q=ext_q, ext_conc=ext_c, out_q=out_q, pair_q=pair_q,
                    mvr_cell_q=mvr_cell_q,
                    mvr_cell_node=gwt_aug.mvr_cell_dst)


class CoupledAugmented:
    """Sequential flow→transport stepping of an augmented flow model and
    its APT rows (CoupledGwfGwt's pattern with the feature rows; with UZT
    rows the columns march at the step-start head, as ``Simulation``'s
    first pass does)."""

    def __init__(self, gwf_aug, gwt_aug: AugmentedGwtModel,
                 gwf_settings=None, gwt_settings=None, ext_conc=None):
        from ...solution.ims import ImsSettings, NumericalSolution
        from .builder import DEFAULT_GWT_SETTINGS

        self.gwf = gwf_aug
        self.gwt = gwt_aug
        self.ext_conc = ext_conc or {}
        self._uzf_theta = None
        self._uzf_watab = None
        self.gwf_sol = NumericalSolution(gwf_aug, gwf_settings or ImsSettings(
            outer_dvclose=1e-8, inner_dvclose=1e-10, inner_rclose=1e-9,
            inner_maximum=1000, outer_maximum=100,
            linear_acceleration="bicgstab"))
        self.gwt_sol = NumericalSolution(gwt_aug, gwt_settings or ImsSettings(
            **DEFAULT_GWT_SETTINGS))

    def step(self, x_flow_old, x_conc_old, delt, kstp=1, iss_flow=False):
        from ..gwf import uzf as uzf_mod
        from .fmi import from_gwf_step

        N = self.gwf.n_grid
        head_old = x_flow_old[:N]
        pkgs = None
        uzf_res = None
        theta_old = self._uzf_theta
        if self.gwt.uzf is not None:
            u = self.gwt.uzf
            if theta_old is None:
                theta_old = uzf_mod.initial_theta(u)
            if self._uzf_watab is None:
                self._uzf_watab = uzf_mod.watab_of(u, head_old)
            uzf_res = uzf_mod.advance(u, theta_old, delt, head=head_old,
                                      watab_old=self._uzf_watab)
            pkgs = dataclasses.replace(self.gwf.base.packages,
                                       uzf=uzf_mod.make_step(u, uzf_res))
        x_flow, finfo, aux = self.gwf_sol.solve_timestep(
            x_flow_old, delt, kstp=kstp, iss=iss_flow, pkgs=pkgs)
        fields = from_gwf_step(self.gwf.base, x_flow[:N], head_old,
                               aux["ibound"][:N], None, delt, iss_flow,
                               ssm_spec=self.gwt.base.ssm_spec,
                               gwt=self.gwt.base)
        flows = extract_apt_flows(self.gwt, x_flow, x_flow_old, fields, delt,
                                  iss_flow, ext_conc=self.ext_conc,
                                  uzf_res=uzf_res, uzf_theta_old=theta_old)
        conc, tinfo, _ = self.gwt_sol.solve_timestep(
            x_conc_old, delt, kstp=kstp, iss=False, pkgs=flows)
        if uzf_res is not None:
            self._uzf_theta = uzf_res.theta
            self._uzf_watab = uzf_res.watab
        return x_flow, conc, finfo, tinfo, flows
