"""GWF model: DIS + NPF + STO + CHD/WEL/RCH composed into the per-iteration
structured system assembly, and the flows of the output phase.

Port of the structured branch of modflow6_tpu/models/gwf/model.py
(``PackageData``, ``finalize_setup``, ``is_linear``, ``packages``,
``boundary_state``, ``assemble`` with its Newton terms, ``edge_conductances``,
``edge_flows``, ``boundary_budget``; model.py:32-52, 94-145, 211-492).  The
port has only the structured 7-point path, so the reference's
``use_structured`` switch has no counterpart.  Features outside the slice
(XT3D and its Newton form, HFB, BUY, VSC, CSUB, DRN/RIV/GHB/EVT, UZF, GNC,
rotated anisotropy, TVS) are not fields of this class; options that would
turn them on raise ``NotImplementedError``.

The port keeps no edge list on the device.  Conductances and face flows
live on the three structured planes (x, y, z; each one shorter than the
grid along its direction); ``edge_flows`` lays them out in the reference's
edge order, ``flowja_csr`` in the budget file's CSR order, and
``cell_inflow`` sums them per cell, all on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from . import bnd, npf, npf_structured, sto


@dataclasses.dataclass(frozen=True)
class PackageData:
    """Stress-period package data bundle: what a period's PERIOD blocks
    set, with static shapes (``maxbound`` rows and a mask) across periods."""

    chd: Optional[bnd.ChdData] = None
    wel: Optional[bnd.WelData] = None
    rch: Optional[bnd.RchData] = None


@dataclasses.dataclass
class GwfModel:
    """Model container: static config plus tensors on one device."""

    name: str
    dtopo: npf.DeviceTopology
    npf_opts: npf.NpfOptions
    npf_arrays: npf.NpfArrays
    strt: torch.Tensor           # f64[N] initial head
    ibound0: torch.Tensor        # i32[N] base ibound from idomain
    delr: torch.Tensor           # f64[ncol]
    delc: torch.Tensor           # f64[nrow]
    area: torch.Tensor           # f64[N] horizontal cell area
    sto_opts: Optional[sto.StoOptions] = None
    sto_arrays: Optional[sto.StoArrays] = None
    chd: Optional[bnd.ChdData] = None
    wel: Optional[bnd.WelData] = None
    rch: Optional[bnd.RchData] = None
    condsat3: tuple = None       # (cx, cy, cz) saturated conductances
    grid: object = None          # host DisGrid (the output files need it)
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
        if o.iangle1 or o.iangle2 or o.iangle3:
            raise NotImplementedError("rotated anisotropy is not ported")
        if self.sto_opts is not None and self.sto_opts.integratechanges:
            raise NotImplementedError("TVS storage integration is not ported")
        self._layout = None
        self._topo = None

    @property
    def nodes(self) -> int:
        return self.dtopo.nodes

    @property
    def device(self) -> torch.device:
        return self.strt.device

    def finalize_setup(self):
        """Precompute the structured condsat (reference npf_ar → calc_condsat)."""
        a = self.npf_arrays
        sat0 = npf.initial_sat(self.npf_opts, a, self.strt, self.ibound0)
        self.condsat3 = npf_structured.structured_condsat(
            self.dtopo.grid_shape, self.delr, self.delc, self.npf_opts,
            a.icelltype, a.k11, a.k22, a.k33, a.top, a.bot, sat0)

    @property
    def is_linear(self) -> bool:
        """True when the assembled system does not depend on the current
        head iterate: no Newton terms, no head-switched well rates, no
        rewetting (which changes ibound between outer iterations), every
        cell confined and storage non-convertible.  The fused solver then
        assembles once per time step."""
        if self.inewton or self.wel_iflowred or self.wetdry is not None:
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
        return PackageData(chd=self.chd, wel=self.wel, rch=self.rch)

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
        diag, off, rhs = npf_structured.assemble_structured(
            self.dtopo.grid_shape, self.delr, self.delc, opts, arrays,
            head, ibound, sat, self.condsat3)

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

        if self.inewton and newton:
            diag, off, rhs = npf.newton_terms(
                self.dtopo, opts, arrays, head, ibound, diag, off, rhs,
                self.condsat3, self.ibound0)
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
        """Conductances for flowja/budget output (npf_cq inputs) as the
        structured planes (cond_x, cond_y, cond_z); called once per time
        step, outside the iteration loop."""
        opts, arrays = self.npf_opts, self.npf_arrays
        sat = npf.compute_saturation(opts, arrays, head, ibound)
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

    def _masks(self):
        """The grid's CSR-row and edge masks as tensors on the device."""
        if self._layout is None:
            if self.grid is None:
                raise ValueError("this model was built without its grid; "
                                 "the edge and CSR layouts need idomain")
            topo = self.topo
            self._layout = (
                torch.as_tensor(topo.row_mask, device=self.device),
                torch.as_tensor(topo.edge_mask, device=self.device))
        return self._layout

    @property
    def topo(self):
        """Host connection layout (edge order, CSR) of the model's grid."""
        if self._topo is None:
            self._topo = self.grid.build_topology()
        return self._topo

    def edge_flows(self, head, ibound, cond=None, pkgs=None):
        """Per-edge flow q (positive into edge_n) in the reference's edge
        order, for flowja/budgets."""
        q7 = self._neighbour_flows(head, ibound, cond, pkgs)
        return q7[:, 4:7][self._masks()[1]]

    def flowja_csr(self, head, ibound, cond=None, pkgs=None):
        """The full CSR flowja array (diagonal entries zero), the .cbc
        FLOW-JA-FACE layout."""
        return self._neighbour_flows(head, ibound, cond, pkgs)[
            self._masks()[0]]

    def cell_inflow(self, head, ibound, cond=None, pkgs=None):
        """f64[N] net flow into each cell over its faces."""
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
        return out
