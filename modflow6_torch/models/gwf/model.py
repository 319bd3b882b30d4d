"""GWF model: DIS/DISV/DISU + NPF + STO + the stress packages composed into
the per-iteration system assembly, and the flows of the output phase.

Port of modflow6_tpu/models/gwf/model.py (``PackageData``,
``use_structured``, ``finalize_setup`` with the HFB barriers, ``is_linear``,
``packages``, ``boundary_state``, ``assemble`` with its Newton terms,
``edge_conductances``, ``edge_flows``, ``boundary_budget``).  Features
outside the ported slices (XT3D and its Newton form, BUY, VSC, CSUB, UZF,
GNC, TVS) are not fields of this class; options that would turn them on
raise ``NotImplementedError``.

Two paths, chosen by ``use_structured`` as in the reference.  A DIS model
without rotated anisotropy keeps no edge list on the device: conductances
and face flows live on the three structured planes (x, y, z; each one
shorter than the grid along its direction), ``edge_flows`` lays them out
in the reference's edge order, ``flowja_csr`` in the budget file's CSR
order, and ``cell_inflow`` sums them per cell.  Every other model (DISV,
DISU, a DIS grid with angles or with layer-skipping passthrough cells)
assembles over the edge list of its full ``DeviceTopology`` into the ELL
table; a DIS grid keeps its grid shape there, so its products still go
through the stencil kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import bnd, npf, npf_structured, sto

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
        angles (see npf_structured)."""
        o = self.npf_opts
        return (self.dtopo.grid_shape is not None
                and not (o.iangle1 or o.iangle2 or o.iangle3))

    def finalize_setup(self):
        """Precompute condsat (reference npf_ar → calc_condsat), on the
        planes for the structured path and per edge for the general one,
        and put the HFB barriers into it."""
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
        between outer iterations), every cell confined and storage
        non-convertible.  The fused solver then assembles once per time
        step."""
        if self.inewton or self.wel_iflowred or self.wetdry is not None:
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

    def assemble(self, head, head_old, ibound, delt, iss: bool,
                 pkgs: PackageData = None, newton: bool = True):
        """One full system build at the current head iterate → (diag, off,
        rhs).  ``newton=False`` rebuilds with standard conductance only (the
        backtracking pass, sln_buildsystem(kiter, inewton=0),
        NumericalSolution.f90:2699)."""
        if pkgs is None:
            pkgs = self.packages
        opts, arrays = self.npf_opts, self.npf_arrays
        sat = npf.compute_saturation(opts, arrays, head, ibound)
        if self.use_structured:
            diag, off, rhs = npf_structured.assemble_structured(
                self.dtopo.grid_shape, self.delr, self.delc, opts, arrays,
                head, ibound, sat, self.condsat3)
        else:
            diag, off, rhs, _ = npf.assemble(self.dtopo, opts, arrays, head,
                                             ibound, sat)

        if self.sto_arrays is not None and not iss:
            d_add, r_add = sto.assemble(self.sto_opts, self.sto_arrays,
                                        head, head_old, ibound, delt)
            diag = diag + d_add
            rhs = rhs + r_add

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
            if self.use_structured:
                diag, off, rhs = npf.newton_terms(
                    self.dtopo, opts, arrays, head, ibound, diag, off, rhs,
                    self.condsat3, self.ibound0)
            else:
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

    # ------------------------------------------------- flows (output phase)

    def edge_conductances(self, head, ibound, pkgs=None):
        """Conductances for flowja/budget output (npf_cq inputs): the
        structured planes (cond_x, cond_y, cond_z) on the structured path,
        one value per edge on the general one; called once per time step,
        outside the iteration loop."""
        opts, arrays = self.npf_opts, self.npf_arrays
        sat = npf.compute_saturation(opts, arrays, head, ibound)
        if not self.use_structured:
            return npf.edge_conductance(self.dtopo, opts, arrays, head,
                                        ibound, sat)
        return npf_structured.structured_conductance(
            self.dtopo.grid_shape, self.delr, self.delc, opts, arrays, head,
            ibound, sat, self.condsat3)

    def face_flows(self, head, cond):
        """(qx, qy, qz) on the structured planes: q = cond·(h_m − h_n),
        positive into the lower-numbered cell n of each face (npf_cq,
        gwf-npf.f90:745-771)."""
        h3 = head.reshape(self.dtopo.grid_shape)
        out = []
        for c, key in zip(cond, ("x", "y", "z")):
            ns, ms = npf_structured._SLICES[key]
            out.append(c * (h3[ms] - h3[ns]))
        return tuple(out)

    def _neighbour_flows(self, head, ibound, cond, pkgs):
        """f64[N, 7]: zero, then the flow into each cell from its [U, N, W,
        E, S, D] neighbour — the budget file's row order."""
        if cond is None:
            cond = self.edge_conductances(head, ibound, pkgs)
        qx, qy, qz = self.face_flows(head, cond)
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
        order, for flowja/budgets."""
        if not self.use_structured:
            if cond is None:
                cond = self.edge_conductances(head, ibound, pkgs)
            return npf.flowja(self.dtopo, cond, head)
        q7 = self._neighbour_flows(head, ibound, cond, pkgs)
        return q7[:, 4:7][self._masks()[1]]

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
