"""GWF model: DIS/DISV/DISU + NPF + STO + the stress packages composed into
the per-iteration system assembly, and the flows of the output phase.

Port of modflow6_tpu/models/gwf/model.py (``PackageData``,
``use_structured``, ``finalize_setup`` with the HFB barriers and XT3D,
``is_linear``, ``packages``, ``boundary_state``, ``assemble`` with its
Newton terms, XT3D (full, RHS and Newton forms), GNC, CSUB, BUY and VSC,
``edge_conductances``, ``edge_flows``, ``boundary_budget``).  The UZF and
advanced-package couplings (``PackageData.uzf``, the augmented models) are
outside the ported slices.

Two paths, chosen by ``use_structured`` as in the reference.  A DIS model
without rotated anisotropy, XT3D or VSC keeps no edge list on the device:
conductances, face flows and the BUY terms live on the three structured
planes (x, y, z; each one shorter than the grid along its direction),
``edge_flows`` lays the flows out in the reference's edge order,
``flowja_csr`` in the budget file's CSR order, and ``cell_inflow`` sums
them per cell.  Every other model (DISV, DISU, a DIS grid with angles, VSC
or layer-skipping passthrough cells) assembles over the edge list of its
full ``DeviceTopology`` into the ELL table; a DIS grid keeps its grid shape
there, so its products still go through the stencil kernel.  XT3D drops
the grid shape: in full mode its system lives on the extended (depth-2)
neighbour table, ``system_topo``, through which the solver multiplies and
fixes rows, while per-cell sums of per-edge terms keep the depth-1 table
of ``dtopo``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import bnd, buy as buy_mod, csub as csub_mod, npf, npf_structured, sto
from . import gnc as gnc_mod, vsc as vsc_mod, xt3d as xt3d_mod

# the list packages whose per-entry (hcof, rhs) are added at their nodes
# after WEL and RCH, in the reference's order
_HEAD_PACKAGES = ("drn", "riv", "ghb", "evt")


@dataclasses.dataclass(frozen=True)
class PackageData:
    """Stress-period package data bundle: what a period's PERIOD blocks
    set, with static shapes (``maxbound`` rows and a mask) across periods."""

    chd: Optional[bnd.ChdData] = None
    wel: Optional[bnd.WelData] = None
    rch: Optional[bnd.RchData] = None
    drn: Optional[bnd.DrnData] = None
    riv: Optional[bnd.RivData] = None
    ghb: Optional[bnd.GhbData] = None
    evt: Optional[bnd.EvtData] = None
    # lagged concentration(s) driving the BUY density terms and the VSC
    # viscosity (f64[N] or f64[nspecies, N])
    buy_conc: Optional[torch.Tensor] = None
    # CSUB state (csub.CsubState: es0/pcs/compaction), committed per step
    csub_state: object = None


@dataclasses.dataclass
class GwfModel:
    """Model container: static config plus tensors on one device."""

    name: str
    dtopo: npf.DeviceTopology
    npf_opts: npf.NpfOptions
    npf_arrays: npf.NpfArrays
    strt: torch.Tensor           # f64[N] initial head
    ibound0: torch.Tensor        # i32[N] base ibound from idomain
    area: torch.Tensor           # f64[N] horizontal cell area
    delr: Optional[torch.Tensor] = None     # f64[ncol] (structured path)
    delc: Optional[torch.Tensor] = None     # f64[nrow]
    sto_opts: Optional[sto.StoOptions] = None
    sto_arrays: Optional[sto.StoArrays] = None
    chd: Optional[bnd.ChdData] = None
    wel: Optional[bnd.WelData] = None
    rch: Optional[bnd.RchData] = None
    drn: Optional[bnd.DrnData] = None
    riv: Optional[bnd.RivData] = None
    ghb: Optional[bnd.GhbData] = None
    evt: Optional[bnd.EvtData] = None
    hfb: object = None           # [(n, m, hydchr)] horizontal-flow barriers
    condsat3: tuple = None       # (cx, cy, cz) saturated conductances
    grid: object = None          # host DisGrid / DisvGrid / DisuGrid
    topo: object = None          # host connection layout (edge order, CSR)
    inewton: int = 0
    inewtonur: int = 0           # NEWTON UNDER_RELAXATION option (gwf_nur
    # runs only when set, gwf.f90 gwf_nur: `this%inewtonur /= 0`)
    wel_iflowred: int = 0        # WEL AUTO_FLOW_REDUCE
    wel_flowred: float = 0.0
    wetdry: Optional[torch.Tensor] = None   # f64[N] WETDRY thresholds (REWET)
    rewet_opts: tuple = (1.0, 1, 0)         # (wetfct, iwetit, ihdwet)
    buy: Optional[buy_mod.BuyData] = None   # variable-density terms
    vsc: Optional[vsc_mod.VscData] = None   # viscosity K scaling
    csub: Optional[csub_mod.CsubData] = None    # compaction/subsidence
    csub_state0: Optional[csub_mod.CsubState] = None
    ixt3d: int = 0               # 0=off 1=full-tensor 2=rhs-only (npf XT3D)
    xt3d: Optional[xt3d_mod.Xt3dData] = None    # built in finalize_setup
    gnc: Optional[gnc_mod.GncData] = None   # ghost-node correction
    system_dtopo: Optional[npf.DeviceTopology] = None  # XT3D full mode

    def __post_init__(self):
        o = self.npf_opts
        if bool(self.inewton) != bool(o.inewton):
            raise ValueError("GwfModel.inewton and NpfOptions.inewton differ")
        if self.sto_opts is not None and self.sto_opts.integratechanges:
            raise NotImplementedError("TVS storage integration is not ported")
        if not self.use_structured and self.dtopo.nbr is None:
            raise ValueError("a model on the general path needs the edge "
                             "tables of a full DeviceTopology")
        self._layout = None

    @property
    def nodes(self) -> int:
        return self.dtopo.nodes

    @property
    def device(self) -> torch.device:
        return self.strt.device

    @property
    def use_structured(self) -> bool:
        """Gather-free dense assembly: DIS grids without rotated-anisotropy
        angles, XT3D or VSC (see npf_structured)."""
        o = self.npf_opts
        return (self.dtopo.grid_shape is not None and not self.ixt3d
                and self.vsc is None
                and not (o.iangle1 or o.iangle2 or o.iangle3))

    @property
    def system_topo(self) -> npf.DeviceTopology:
        """The topology of the assembled system, which the product, the
        Dirichlet fixup and the preconditioners read: the extended
        neighbour table under XT3D's full mode, else ``dtopo``."""
        return self.dtopo if self.system_dtopo is None else self.system_dtopo

    def finalize_setup(self):
        """Precompute condsat (reference npf_ar → calc_condsat), on the
        planes for the structured path and per edge for the general one,
        and put the HFB barriers into it; or, with XT3D, build its tables
        (the reference's finalize_setup:105-122)."""
        if self.ixt3d:
            if self.hfb:
                raise NotImplementedError("HFB with XT3D not yet implemented")
            if self.vsc is not None:
                raise NotImplementedError("VSC with XT3D not supported yet")
            a, o = self.npf_arrays, self.npf_opts
            self.xt3d = xt3d_mod.build_xt3d(
                self.grid, self._host_topo(), a.k11, a.k22, a.k33,
                a.angle1 if o.iangle1 else 0.0,
                a.angle2 if o.iangle2 else 0.0,
                a.angle3 if o.iangle3 else 0.0, ixt3d=self.ixt3d,
                device=self.device)
            # the grid shape goes: XT3D multiplies through the gather
            self.dtopo = dataclasses.replace(self.dtopo, grid_shape=None)
            if self.ixt3d == 1:
                # full mode widens the stencil to depth 2
                self.system_dtopo = dataclasses.replace(
                    self.dtopo, nbr=self.xt3d.nbr_ext)
            return
        if self.vsc is not None and self.hfb:
            raise NotImplementedError(
                "VSC rebuilds condsat per step, which would drop the HFB "
                "modifications — not supported together yet")
        a = self.npf_arrays
        sat0 = npf.initial_sat(self.npf_opts, a, self.strt, self.ibound0)
        if self.use_structured:
            self.condsat3 = npf_structured.structured_condsat(
                self.dtopo.grid_shape, self.delr, self.delc, self.npf_opts,
                a.icelltype, a.k11, a.k22, a.k33, a.top, a.bot, sat0)
            if self.hfb:
                self.condsat3 = self._apply_hfb_structured(self.condsat3)
            return
        condsat = npf.compute_condsat(self.dtopo, self.npf_opts, a, sat0)
        if self.hfb:
            condsat = self._apply_hfb(condsat)
        self.npf_arrays = dataclasses.replace(a, condsat=condsat)

    def _hfb_series(self, csat, n, m, hydchr, staggered, faw):
        """Reference HFB conductance math (gwf-hfb.f90 condsat_modify /
        hfb_fc:304-327): hydchr > 0 is a barrier hydraulic characteristic —
        series-combine csat with condhfb = hydchr*fawidth*faheight;
        hydchr < 0 is a direct conductance multiplier (cond = -csat*hydchr).
        Host floats: a model has a handful of barriers."""
        top = self.npf_arrays.top
        bot = self.npf_arrays.bot
        tn, tm, bn, bm = (float(top[n]), float(top[m]), float(bot[n]),
                          float(bot[m]))
        if staggered:
            fah = min(tn, tm) - max(bn, bm)
        else:
            fah = 0.5 * ((tn - bn) + (tm - bm))
        if hydchr > 0:
            condhfb = hydchr * faw * fah
            return csat * condhfb / (csat + condhfb)
        return -csat * hydchr

    def _apply_hfb(self, condsat):
        """The barriers in the per-edge condsat, applied in their order."""
        topo = self.topo
        key = (topo.edge_n.astype(np.int64) * topo.nodes
               + topo.edge_m.astype(np.int64))
        order = np.argsort(key, kind="stable")
        sorted_key = key[order]
        cs = condsat.cpu().numpy().copy()
        for n, m, hydchr in self.hfb:
            n, m = int(min(n, m)), int(max(n, m))
            at = int(np.searchsorted(sorted_key, n * topo.nodes + m,
                                     side="right")) - 1
            if at < 0 or sorted_key[at] != n * topo.nodes + m:
                raise ValueError(f"HFB cells {n},{m} are not connected")
            e = int(order[at])
            cs[e] = self._hfb_series(float(cs[e]), n, m, float(hydchr),
                                     topo.ihc[e] == 2, float(topo.hwva[e]))
        return torch.as_tensor(cs, dtype=condsat.dtype, device=condsat.device)

    def _apply_hfb_structured(self, condsat3):
        """The barriers in the dense (cx, cy, cz) structured arrays (slot
        (k,i,j) holds the conductance toward (k,i,j+1) etc.).  The face
        width is the reference's per-edge hwva: delc across a column face,
        delr across a row face, the cell area across a layer face."""
        nlay, nrow, ncol = self.dtopo.grid_shape
        ncpl = nrow * ncol
        delr = self.delr.cpu().numpy()
        delc = self.delc.cpu().numpy()
        exists = self.grid.idomain.reshape(-1) != 0 if self.grid is not None \
            else np.ones(self.nodes, bool)
        planes = [c.cpu().numpy().copy() for c in condsat3]
        for n, m, hydchr in self.hfb:
            n, m = int(min(n, m)), int(max(n, m))
            k, i, j = n // ncpl, (n % ncpl) // ncol, n % ncol
            if m == n + 1 and j + 1 < ncol:
                axis, faw = 0, float(delc[i])
            elif m == n + ncol and i + 1 < nrow:
                axis, faw = 1, float(delr[j])
            elif m == n + ncpl and m < self.nodes:
                axis, faw = 2, float(delc[i] * delr[j])
            else:
                raise ValueError(f"HFB cells {n},{m} are not connected")
            if not (exists[n] and exists[m]):
                raise ValueError(f"HFB cells {n},{m} are not connected")
            arr = planes[axis]
            arr[k, i, j] = self._hfb_series(float(arr[k, i, j]), n, m,
                                            float(hydchr), False, faw)
        return tuple(torch.as_tensor(c, dtype=torch.float64,
                                     device=self.device) for c in planes)

    @property
    def is_linear(self) -> bool:
        """True when the assembled system does not depend on the current
        head iterate: no Newton terms, no head-switched well, drain, river
        or evapotranspiration rates, no rewetting (which changes ibound
        between outer iterations), no XT3D, BUY, VSC or CSUB terms, no
        ghost-node correction (its explicit rhs terms follow the iterate),
        every cell confined and storage non-convertible.  The fused solver
        then assembles once per time step."""
        if self.inewton or self.ixt3d or self.wel_iflowred \
                or self.wetdry is not None:
            return False
        if self.buy is not None or self.vsc is not None \
                or self.csub is not None or self.gnc is not None:
            return False
        if self.drn is not None or self.riv is not None \
                or self.evt is not None:
            return False
        if bool(torch.any(self.npf_arrays.icelltype != 0)):
            return False
        if self.sto_arrays is not None and bool(
                torch.any(self.sto_arrays.iconvert != 0)):
            return False
        return True

    # ---------------------------------------------------------- stress rp

    @property
    def packages(self) -> PackageData:
        """Static package bundle (models built via builder.build_gwf)."""
        return PackageData(chd=self.chd, wel=self.wel, rch=self.rch,
                           drn=self.drn, riv=self.riv, ghb=self.ghb,
                           evt=self.evt)

    def boundary_state(self, head, pkgs: PackageData = None):
        """Apply CHD to (ibound, head) — the rp/ad phase of CHD."""
        if pkgs is None:
            pkgs = self.packages
        ibound = self.ibound0
        if pkgs.chd is not None:
            ibound, head = bnd.apply_chd(ibound, head, pkgs.chd)
        return ibound, head

    # ---------------------------------------------------------- assembly

    def _wel_terms(self, wel, head, ibound):
        a = self.npf_arrays
        return bnd.wel_terms(wel, head, ibound, a.icelltype, a.top, a.bot,
                             self.wel_iflowred, self.wel_flowred)

    def _head_package_terms(self, name, data, head, ibound):
        """(hcof, rhs) per entry of a DRN, RIV, GHB or EVT package."""
        if name == "drn":
            return bnd.drn_terms(data, head, ibound)
        if name == "riv":
            return bnd.riv_terms(data, head, ibound)
        if name == "ghb":
            return bnd.ghb_terms(data, ibound)
        return bnd.evt_terms(data, head, ibound, self.area)

    def _vsc_arrays(self, arrays, conc, ibound):
        """VSC: K scaled by viscref/viscosity and condsat rebuilt from it
        (update_k_with_vsc, the npf kchangeper path), at the lagged
        concentration field that BUY also reads."""
        vr = vsc_mod.viscosity_ratio(self.vsc, conc)
        arrays = dataclasses.replace(arrays, k11=arrays.k11 * vr,
                                     k22=arrays.k22 * vr,
                                     k33=arrays.k33 * vr)
        sat0 = npf.initial_sat(self.npf_opts, arrays, self.strt, ibound)
        return dataclasses.replace(arrays, condsat=npf.compute_condsat(
            self.dtopo, self.npf_opts, arrays, sat0))

    def assemble(self, head, head_old, ibound, delt, iss: bool,
                 pkgs: PackageData = None, newton: bool = True):
        """One full system build at the current head iterate → (diag, off,
        rhs).  ``newton=False`` rebuilds with standard conductance only (the
        backtracking pass, sln_buildsystem(kiter, inewton=0),
        NumericalSolution.f90:2699)."""
        if pkgs is None:
            pkgs = self.packages
        opts, arrays = self.npf_opts, self.npf_arrays
        conc = pkgs.buy_conc
        if self.vsc is not None and conc is not None:
            arrays = self._vsc_arrays(arrays, conc, ibound)
        sat = npf.compute_saturation(opts, arrays, head, ibound)
        if self.gnc is not None and (self.use_structured or self.ixt3d):
            raise NotImplementedError(
                "GNC on the structured path or with XT3D (the reference's "
                "assembly applies it on the general two-point path only)")
        if self.xt3d is not None:
            if self.inewton:
                # xt3d_fc inewton branch + xt3d_fn Jacobian terms
                diag, off, rhs = xt3d_mod.assemble_newton(
                    self.xt3d, head, ibound, sat, arrays.icelltype,
                    add_fn=newton)
            else:
                diag, off, rhs = xt3d_mod.assemble(self.xt3d, head, ibound,
                                                   sat)
        elif self.use_structured:
            diag, off, rhs = npf_structured.assemble_structured(
                self.dtopo.grid_shape, self.delr, self.delc, opts, arrays,
                head, ibound, sat, self.condsat3)
        else:
            diag, off, rhs, cond_e = npf.assemble(self.dtopo, opts, arrays,
                                                  head, ibound, sat)
            if self.gnc is not None:
                # ghost-node correction, explicit form (GhostNode.f90
                # gnc_fc else-branch): rhs(n) -= ΔQ, rhs(m) += ΔQ
                rhs = gnc_mod.add_rhs(self.gnc, rhs, gnc_mod.gnc_rhs_terms(
                    self.gnc, cond_e, head, ibound))

        if self.sto_arrays is not None and not iss:
            d_add, r_add = sto.assemble(self.sto_opts, self.sto_arrays,
                                        head, head_old, ibound, delt)
            diag = diag + d_add
            rhs = rhs + r_add

        if self.csub is not None and pkgs.csub_state is not None \
                and not iss:
            d_add, r_add = csub_mod.assemble_csub(
                self.csub, pkgs.csub_state, arrays.top, arrays.bot,
                self.area, arrays.icelltype, head, head_old, ibound, delt)
            diag = diag + d_add
            rhs = rhs + r_add

        if self.buy is not None and conc is not None:
            diag, off, rhs = self._buy_terms(arrays, conc, head, ibound, sat,
                                             diag, off, rhs)

        if pkgs.wel is not None:
            hcof, r = self._wel_terms(pkgs.wel, head, ibound)
            diag, rhs = bnd.scatter_terms(diag, rhs, pkgs.wel.node,
                                          pkgs.wel.mask, hcof, r)
        if pkgs.rch is not None:
            hcof, r = bnd.rch_terms(pkgs.rch, ibound, self.area)
            diag, rhs = bnd.scatter_terms(diag, rhs, pkgs.rch.node,
                                          pkgs.rch.mask, hcof, r)
        for name in _HEAD_PACKAGES:
            data = getattr(pkgs, name)
            if data is not None:
                hcof, r = self._head_package_terms(name, data, head, ibound)
                diag, rhs = bnd.scatter_terms(diag, rhs, data.node,
                                              data.mask, hcof, r)

        if self.inewton and newton:
            # (XT3D's Newton terms are part of its own assembly)
            if self.xt3d is None and self.use_structured:
                diag, off, rhs = npf.newton_terms(
                    self.dtopo, opts, arrays, head, ibound, diag, off, rhs,
                    self.condsat3, self.ibound0)
            elif self.xt3d is None:
                diag, off, rhs = npf.newton_terms_edges(
                    self.dtopo, opts, arrays, head, ibound, diag, off, rhs)
            if self.sto_arrays is not None and not iss:
                d_add, r_add = sto.newton_terms(self.sto_opts,
                                                self.sto_arrays, head,
                                                ibound, delt)
                diag = diag + d_add
                rhs = rhs + r_add
            if pkgs.wel is not None and self.wel_iflowred:
                hcof, r = bnd.wel_newton(pkgs.wel, head, ibound,
                                         arrays.icelltype, arrays.top,
                                         arrays.bot, self.wel_iflowred,
                                         self.wel_flowred)
                diag, rhs = bnd.scatter_terms(diag, rhs, pkgs.wel.node,
                                              pkgs.wel.mask, hcof, r)
        return diag, off, rhs

    def _buy_terms(self, arrays, conc, head, ibound, sat, diag, off, rhs):
        """BUY's terms (buy_fc) at the current conductances: on the planes
        for a structured model, over the edge list otherwise."""
        if self.ixt3d:
            raise NotImplementedError(
                "BUY with XT3D (the reference takes BUY's conductances from "
                "a two-point condsat that its XT3D setup leaves at zero, and "
                "in full mode writes them through depth-1 slots into the "
                "extended table)")
        dense = buy_mod.calcdens(self.buy, conc)
        if self.use_structured:
            shape = self.dtopo.grid_shape
            cond3 = npf_structured.structured_conductance(
                shape, self.delr, self.delc, self.npf_opts, arrays, head,
                ibound, sat, self.condsat3)
            return buy_mod.assemble_buy_planes(
                shape, self.delr, self.delc, self.buy, dense, cond3, sat,
                arrays.top, arrays.bot, ibound, self.ibound0, head, diag,
                off, rhs)
        cond_e = npf.edge_conductance(self.dtopo, self.npf_opts, arrays,
                                      head, ibound, sat)
        return buy_mod.assemble_buy(self.dtopo, self.buy, dense, cond_e, sat,
                                    arrays.top, arrays.bot, ibound, head,
                                    diag, off, rhs)

    # ------------------------------------------------- flows (output phase)

    def edge_conductances(self, head, ibound, pkgs=None):
        """Conductances for flowja/budget output (npf_cq inputs): the
        structured planes (cond_x, cond_y, cond_z) on the structured path,
        one value per edge on the general one (zeros under XT3D, whose
        flows are multi-point: see ``edge_flows``); with VSC at the
        viscosity-scaled K (vsc_cq); called once per time step, outside
        the iteration loop."""
        opts, arrays = self.npf_opts, self.npf_arrays
        conc = getattr(pkgs, "buy_conc", None)
        if self.vsc is not None and conc is not None:
            arrays = self._vsc_arrays(arrays, conc, ibound)
        if self.xt3d is not None:
            return torch.zeros(self.xt3d.edge_n.shape[0], dtype=head.dtype,
                               device=head.device)
        sat = npf.compute_saturation(opts, arrays, head, ibound)
        if not self.use_structured:
            return npf.edge_conductance(self.dtopo, opts, arrays, head,
                                        ibound, sat)
        return npf_structured.structured_conductance(
            self.dtopo.grid_shape, self.delr, self.delc, opts, arrays, head,
            ibound, sat, self.condsat3)

    def face_flows(self, head, cond, ibound=None, pkgs=None):
        """(qx, qy, qz) on the structured planes: q = cond·(h_m − h_n),
        positive into the lower-numbered cell n of each face (npf_cq,
        gwf-npf.f90:745-771), plus BUY's correction (buy_cq) when
        ``pkgs.buy_conc`` is given."""
        h3 = head.reshape(self.dtopo.grid_shape)
        out = []
        for c, key in zip(cond, ("x", "y", "z")):
            ns, ms = npf_structured._SLICES[key]
            out.append(c * (h3[ms] - h3[ns]))
        conc = getattr(pkgs, "buy_conc", None)
        if self.buy is not None and conc is not None:
            a = self.npf_arrays
            sat = npf.compute_saturation(self.npf_opts, a, head, ibound)
            dq = buy_mod.flow_correction_planes(
                self.dtopo.grid_shape, self.delr, self.delc, self.buy,
                buy_mod.calcdens(self.buy, conc), cond, sat, a.top, a.bot,
                ibound, self.ibound0, head)
            out = [q + d for q, d in zip(out, dq)]
        return tuple(out)

    def _neighbour_flows(self, head, ibound, cond, pkgs):
        """f64[N, 7]: zero, then the flow into each cell from its [U, N, W,
        E, S, D] neighbour — the budget file's row order."""
        if cond is None:
            cond = self.edge_conductances(head, ibound, pkgs)
        qx, qy, qz = self.face_flows(head, cond, ibound, pkgs)
        # F.pad lists (before, after) pairs from the last axis backwards
        cols = [torch.zeros_like(head).reshape(self.dtopo.grid_shape),
                -F.pad(qz, (0, 0, 0, 0, 1, 0)),     # up
                -F.pad(qy, (0, 0, 1, 0)),           # north
                -F.pad(qx, (1, 0)),                 # west
                F.pad(qx, (0, 1)),                  # east
                F.pad(qy, (0, 0, 0, 1)),            # south
                F.pad(qz, (0, 0, 0, 0, 0, 1))]      # down
        return torch.stack(cols, dim=-1).reshape(-1, 7)

    def _host_topo(self):
        if self.topo is None:
            raise ValueError("this model was built without its grid; "
                             "the edge and CSR layouts need idomain")
        return self.topo

    def _masks(self):
        """Structured path: the grid's CSR-row and edge masks as tensors on
        the device."""
        if self._layout is None:
            topo = self._host_topo()
            self._layout = (
                torch.as_tensor(topo.row_mask, device=self.device),
                torch.as_tensor(topo.edge_mask, device=self.device))
        return self._layout

    def _csr_positions(self):
        """General path: (nja, edge_pos_nm, edge_pos_mn) of the host
        topology's CSR pattern, the positions as int64 tensors on the
        device."""
        if self._layout is None:
            ia, _, pos_nm, pos_mn = self._host_topo().csr
            self._layout = (
                int(ia[-1]),
                torch.as_tensor(pos_nm, dtype=torch.int64, device=self.device),
                torch.as_tensor(pos_mn, dtype=torch.int64, device=self.device))
        return self._layout

    def edge_flows(self, head, ibound, cond=None, pkgs=None):
        """Per-edge flow q (positive into edge_n) in the reference's edge
        order, for flowja/budgets: the two-point flows, XT3D's multi-point
        expression (xt3d_flowja), the GNC correction (gnc_cq) and BUY's
        (buy_cq, when ``pkgs.buy_conc`` is given)."""
        if self.use_structured:
            q7 = self._neighbour_flows(head, ibound, cond, pkgs)
            return q7[:, 4:7][self._masks()[1]]
        if self.xt3d is not None:
            sat = npf.compute_saturation(self.npf_opts, self.npf_arrays,
                                         head, ibound)
            return xt3d_mod.edge_flows(self.xt3d, head, ibound, sat,
                                       newton=bool(self.inewton))
        if cond is None:
            cond = self.edge_conductances(head, ibound, pkgs)
        q = npf.flowja(self.dtopo, cond, head)
        if self.gnc is not None:
            # flow n→m gains ΔQ, so q (positive into n) loses it
            dq = gnc_mod.deltaQgnc(self.gnc, cond, head, ibound)
            q = self.gnc.flow_plan.add(q, -dq)
        conc = getattr(pkgs, "buy_conc", None)
        if self.buy is not None and conc is not None:
            a = self.npf_arrays
            sat = npf.compute_saturation(self.npf_opts, a, head, ibound)
            q = q + buy_mod.edge_flow_correction(
                self.dtopo, self.buy, buy_mod.calcdens(self.buy, conc), cond,
                sat, a.top, a.bot, ibound, head)
        return q

    def flowja_csr(self, head, ibound, cond=None, pkgs=None):
        """The full CSR flowja array (diagonal entries zero), the .cbc
        FLOW-JA-FACE layout."""
        if not self.use_structured:
            q = self.edge_flows(head, ibound, cond, pkgs)
            nja, pos_nm, pos_mn = self._csr_positions()
            flowja = torch.zeros(nja, dtype=q.dtype, device=q.device)
            flowja[pos_nm] = q           # flow into n from m
            flowja[pos_mn] = -q
            return flowja
        return self._neighbour_flows(head, ibound, cond, pkgs)[
            self._masks()[0]]

    def cell_inflow(self, head, ibound, cond=None, pkgs=None):
        """f64[N] net flow into each cell over its faces, summed in a fixed
        order (over the seven table columns, or over the ELL slots)."""
        if not self.use_structured:
            q = self.edge_flows(head, ibound, cond, pkgs)
            return npf._row_sum(self.dtopo, q, -q)
        return self._neighbour_flows(head, ibound, cond, pkgs).sum(dim=1)

    # ------------------------------------------------------------ budget

    def boundary_budget(self, head, ibound, pkgs: PackageData = None):
        """Per-package boundary flow rates for budget reporting.

        Returns dict name -> per-entry q (positive = into the aquifer);
        CHD maps to None: its flow is the residual of the face flows at
        the constant-head cells (see ``cell_inflow``).
        """
        if pkgs is None:
            pkgs = self.packages
        out = {}
        if pkgs.chd is not None:
            out["CHD"] = None
        if pkgs.wel is not None:
            hcof, r = self._wel_terms(pkgs.wel, head, ibound)
            out["WEL"] = bnd.bound_flows(pkgs.wel.node, pkgs.wel.mask, hcof,
                                         r, head, ibound)
        if pkgs.rch is not None:
            hcof, r = bnd.rch_terms(pkgs.rch, ibound, self.area)
            out["RCH"] = bnd.bound_flows(pkgs.rch.node, pkgs.rch.mask, hcof,
                                         r, head, ibound)
        for name in _HEAD_PACKAGES:
            data = getattr(pkgs, name)
            if data is not None:
                hcof, r = self._head_package_terms(name, data, head, ibound)
                out[name.upper()] = bnd.bound_flows(data.node, data.mask,
                                                    hcof, r, head, ibound)
        return out
