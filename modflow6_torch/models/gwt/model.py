"""GWT model: solute transport on a GWF flow field.

Port of modflow6_tpu/models/gwt/model.py (``CncData``, ``SrcData``,
``GwtModel``; reference gwt.f90 with the packages ADV, DSP, MST, IST,
SSM, CNC and SRC on the FMI flow fields; ``eqnsclfac`` scales the terms as
GWE's heat transport will, tsp.f90:30-55).

The transport system lives on the edge list and its ELL table: a DIS grid
keeps its fixed [E, W, N, S, U, D] slots but no grid shape, so the solver
multiplies through the gather product (``ops/system.py:spmv``) and fixes
rows through the table.  ``assemble`` adds the terms in the reference's
order: ADV (and TVD's rhs), DSP, MST storage, decay, sorption and decay of
the sorbed phase, SSM, IST, SRC.  Sums into repeated cells go through
``AddPlan``s in entry order: SSM's over the flow fields' entries (built
once per entry layout and kept), SRC's over its entries (built once);
per-cell sums of per-edge terms go through the ELL slots.  CNC sets its
cells: of several entries on one cell the last one wins (JAX's
``.at[].set`` leaves that winner unspecified).

A ``GwtModel`` has no NPF: the solver reaches none of the flow model's
options (Newton, rewetting, PTC) with it, since its ``inewton`` is 0 and it
has no WETDRY array.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional

import numpy as np
import torch

from ...constants import DZERO
from ...ops.scatter import AddPlan
from ..gwf import npf as npf_mod
from ..gwf.bnd import _Entries
from . import adv as adv_mod
from . import dsp as dsp_mod
from . import ist as ist_mod
from . import mst as mst_mod
from .fmi import FlowFields


@dataclasses.dataclass(frozen=True)
class CncData:
    node: torch.Tensor   # i64[B]
    conc: torch.Tensor   # f64[B]
    mask: torch.Tensor   # bool[B]

    @cached_property
    def winners(self) -> torch.Tensor:
        """The entries that set their cell: the last entry with ``mask`` of
        each cell (one host read of the nodes, once)."""
        node = self.node.cpu().numpy()
        sel = np.nonzero(self.mask.cpu().numpy())[0]
        # the last occurrence of each node among the selected entries
        rev = sel[::-1]
        _, first = np.unique(node[rev], return_index=True)
        return torch.as_tensor(np.sort(rev[first]), dtype=torch.int64,
                               device=self.node.device)


@dataclasses.dataclass(frozen=True)
class SrcData(_Entries):
    node: torch.Tensor   # i64[B]
    q: torch.Tensor      # f64[B] mass loading rate
    mask: torch.Tensor   # bool[B]


class TransportModel:
    """What GwtModel and GWE's GweModel share: the device, the edge-list
    topology without a grid shape, the constant-value cells (CNC, CTP),
    SSM's terms with their sum plan, and the flow fields of the step."""

    def _init_transport(self):
        if self.dtopo.grid_shape is not None:
            raise ValueError("a transport model multiplies through its ELL "
                             "table: its DeviceTopology has no grid shape")
        self._fields = None
        self._ssm_plan = None
        # FMI's concatenated entry layout (fmi._layout)
        self.fmi_layout = None

    @property
    def nodes(self) -> int:
        return self.dtopo.nodes

    @property
    def device(self) -> torch.device:
        return self.strt.device

    @property
    def use_structured(self) -> bool:
        return False

    @property
    def system_topo(self) -> npf_mod.DeviceTopology:
        return self.dtopo

    @property
    def packages(self):
        return None

    def set_flows(self, fields: FlowFields):
        self._fields = fields

    def _constant(self, data: Optional[CncData], conc):
        """The cells of ``data`` (CNC or CTP) constant (ibound −1) at their
        value: of several entries on one cell the last one wins."""
        ibound = self.ibound0
        if data is None:
            return ibound, conc
        win = data.winners
        node = data.node[win]
        ibound = ibound.clone()
        ibound[node] = -1
        conc = conc.clone()
        conc[node] = data.conc[win]
        return ibound, conc

    def _ssm_sums(self, fields):
        """The plan of SSM's sums into the entries' cells, in entry order;
        one per entry layout (the flow fields of one layout share their
        ``bound_node`` tensor)."""
        if self._ssm_plan is None or self._ssm_plan[0] is not \
                fields.bound_node:
            self._ssm_plan = (fields.bound_node, AddPlan.build(
                fields.bound_node, fields.bound_node.device, self.nodes))
        return self._ssm_plan[1]

    def _ssm(self, fields, ibound, diag, rhs):
        """SSM (tsp-ssm.f90 ssm_fc): an inflow brings mass or energy at the
        source value (rhs), an outflow leaves at the cell's (diagonal)."""
        q = fields.bound_q * self.eqnsclfac
        node = fields.bound_node
        act = fields.bound_mask & (ibound[node] > 0)
        inflow = q >= DZERO
        plan = self._ssm_sums(fields)
        rhs = plan.add(rhs, torch.where(act & inflow,
                                        -q * fields.bound_conc, DZERO))
        diag = plan.add(diag, torch.where(act & ~inflow, q, DZERO))
        return diag, rhs

    def edge_conductances(self, conc, ibound, pkgs=None):
        """No conductance of the output phase: a transport step writes no
        face flows (the reference returns a zero placeholder)."""
        return None


@dataclasses.dataclass
class GwtModel(TransportModel):
    """Transport model container (the role of GwfModel for GWF)."""

    name: str
    grid: object
    topo: object                  # host Topology (edge order, ELL slots)
    dtopo: npf_mod.DeviceTopology  # on the device, without a grid shape
    strt: torch.Tensor            # f64[N] initial concentration
    ibound0: torch.Tensor         # i32[N]
    mst_opts: mst_mod.MstOptions
    mst_arrays: mst_mod.MstArrays
    iadvwt: int = adv_mod.UPSTREAM
    eqnsclfac: float = 1.0
    dsp: Optional[dsp_mod.DspData] = None
    cnc: Optional[CncData] = None
    src: Optional[SrcData] = None
    ssm_on: bool = True                 # SSM on the GWF boundary flows
    ssm_spec: Optional[dict] = None     # package name → source conc
    ist: Optional[ist_mod.IstData] = None   # immobile domain
    cim: Optional[torch.Tensor] = None  # immobile conc, advanced per step
    top: torch.Tensor = None
    bot: torch.Tensor = None
    area: torch.Tensor = None
    inewton: int = 0

    def __post_init__(self):
        self._init_transport()

    @property
    def is_linear(self) -> bool:
        """True when the assembled system does not depend on the
        concentration iterate: not with TVD (its rhs reads the iterate),
        Freundlich or Langmuir sorption, or zero-order decay (its rate is
        limited by the iterate)."""
        return (self.iadvwt != adv_mod.TVD
                and self.mst_opts.isrb not in (mst_mod.SORPTION_FREUND,
                                               mst_mod.SORPTION_LANG)
                and self.mst_opts.idcy != mst_mod.DECAY_ZERO_ORDER)

    def boundary_state(self, conc, pkgs=None):
        """CNC: its cells constant-concentration (ibound −1) at their
        concentration."""
        return self._constant(self.cnc, conc)

    def assemble(self, conc, conc_old, ibound, delt, iss: bool, pkgs=None):
        """The transport system at the concentration iterate → (diag[N],
        off[N, K], rhs[N]).  ``pkgs`` carries the step's FlowFields (the
        per-step coupling data, in the place of GWF's package data)."""
        fields = pkgs if pkgs is not None else self._fields
        top, bot, area = self.top, self.bot, self.area
        dtopo = self.dtopo

        # ADV
        diag, off = adv_mod.assemble(dtopo, self.iadvwt, fields, ibound, top,
                                     bot, self.eqnsclfac)
        rhs = torch.zeros_like(diag)
        if self.iadvwt == adv_mod.TVD:
            rhs = rhs + adv_mod.tvd_rhs(dtopo, fields, ibound, conc,
                                        self.eqnsclfac)

        # DSP: the per-step, velocity-dependent conductances in the
        # conductance-style fill of dsp_fc
        if self.dsp is not None:
            n, m = dtopo.edge_n, dtopo.edge_m
            dcond = dsp_mod.edge_conductance(
                dtopo, self.dsp, self.mst_arrays.porosity, fields, ibound,
                top, bot) * self.eqnsclfac
            act = (ibound[n] != 0) & (ibound[m] != 0)
            dcond = torch.where(act, dcond, DZERO)
            flat = off.view(-1)
            flat[dtopo.slot_nm] += dcond
            flat[dtopo.slot_mn] += dcond
            diag = diag + npf_mod._row_sum(dtopo, -dcond, -dcond)

        # MST storage
        hcof, rhs_coeff = mst_mod.storage_terms(self.mst_arrays, fields,
                                                ibound, top, bot, area, delt)
        diag = diag + hcof
        rhs = rhs + rhs_coeff * conc_old

        # decay
        opts, arrays = self.mst_opts, self.mst_arrays
        if opts.idcy != mst_mod.DECAY_OFF:
            hcof, r, _ = mst_mod.decay_terms(opts, arrays, fields, ibound,
                                             top, bot, area, conc_old, conc,
                                             delt, True, arrays.decay)
            diag = diag + hcof
            rhs = rhs + r

        # sorption, and decay of the sorbed phase
        if opts.isrb != mst_mod.SORPTION_OFF:
            hcof, r = mst_mod.sorption_terms(opts, arrays, fields, ibound,
                                             top, bot, area, conc_old, conc,
                                             delt)
            diag = diag + hcof
            rhs = rhs + r
            hcof, r = mst_mod.decay_sorbed_terms(opts, arrays, fields,
                                                 ibound, top, bot, area,
                                                 conc_old, conc, delt)
            diag = diag + hcof
            rhs = rhs + r

        # SSM
        if self.ssm_on:
            diag, rhs = self._ssm(fields, ibound, diag, rhs)

        # IST: the immobile-domain transfer (gwt-ist.f90 ist_fc) at the
        # step-start immobile concentration the flow fields carry
        if self.ist is not None and fields.cim is not None:
            hcof, r = ist_mod.ist_terms(self.ist, fields.sat, area, top, bot,
                                        ibound, conc_old, fields.cim, delt)
            diag = diag + hcof
            rhs = rhs + r

        # SRC mass loading
        if self.src is not None:
            src = self.src
            act = src.mask & (ibound[src.node] > 0)
            rhs = src.add_plan.add(rhs, torch.where(
                act, -src.q * self.eqnsclfac, DZERO))

        return diag, off, rhs
