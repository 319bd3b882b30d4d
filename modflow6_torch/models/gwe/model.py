"""GWE model: groundwater energy (heat) transport on a GWF flow field.

Port of modflow6_tpu/models/gwe/model.py (``GweModel``; reference
gwe.f90:33 with the packages ADV, shared with GWT and scaled by
eqnsclfac = rhow·cpw, CND (conduction and thermal dispersion), EST (energy
storage with the solid phase), CTP (constant temperature, CNC's analog),
ESL (energy source loading, SRC's analog) and SSM on the GWF boundary
flows).  It shares GWT's transport machinery (``gwt.model.TransportModel``):
the FMI flow fields, the edge list and ELL table without a grid shape (its
products go through the gather), SSM's sums through one ``AddPlan`` per
entry layout, and CTP's cells set by their last entry.  CND's per-cell
sums of per-edge terms go through the ELL slots, as DSP's do; ESL's sums
into repeated cells through its entries' plan.  ``assemble`` adds the
terms in the reference's order: ADV (and TVD's rhs), CND, EST storage,
EST decay, SSM, ESL.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...constants import DZERO
from ..gwf import npf as npf_mod
from ..gwt import adv as adv_mod
from ..gwt.model import CncData, SrcData, TransportModel
from . import cnd as cnd_mod
from . import est as est_mod


@dataclasses.dataclass
class GweModel(TransportModel):
    """Heat-transport model container (the interface of GwtModel)."""

    name: str
    grid: object
    topo: object
    dtopo: npf_mod.DeviceTopology
    strt: torch.Tensor            # f64[N] initial temperature
    ibound0: torch.Tensor         # i32[N]
    est_opts: est_mod.EstOptions
    est_arrays: est_mod.EstArrays
    iadvwt: int = adv_mod.UPSTREAM
    cnd: Optional[cnd_mod.CndData] = None
    ctp: Optional[CncData] = None   # constant temperature (gwe-ctp)
    esl: Optional[SrcData] = None   # energy source loading (gwe-esl)
    ssm_on: bool = True
    ssm_spec: Optional[dict] = None  # package name → source temperature
    top: torch.Tensor = None
    bot: torch.Tensor = None
    area: torch.Tensor = None
    inewton: int = 0

    # what the transport step of Simulation reads of a GWT model
    ist = None

    def __post_init__(self):
        self._init_transport()

    @property
    def eqnsclfac(self) -> float:
        return self.est_opts.eqnsclfac

    @property
    def is_linear(self) -> bool:
        """True unless TVD's rhs reads the temperature iterate (EST's
        zero-order decay does not: GWE's sink rate is not limited)."""
        return self.iadvwt != adv_mod.TVD

    def boundary_state(self, temp, pkgs=None):
        """CTP: its cells constant-temperature (ibound −1) at their
        temperature."""
        return self._constant(self.ctp, temp)

    def assemble(self, temp, temp_old, ibound, delt, iss: bool, pkgs=None):
        """The energy-transport system at the temperature iterate →
        (diag[N], off[N, K], rhs[N]); ``pkgs`` carries the step's
        FlowFields."""
        fields = pkgs if pkgs is not None else self._fields
        top, bot, area = self.top, self.bot, self.area
        dtopo = self.dtopo
        scl = self.eqnsclfac

        # ADV: the advective energy flux q·rhow·cpw·T
        diag, off = adv_mod.assemble(dtopo, self.iadvwt, fields, ibound, top,
                                     bot, scl)
        rhs = torch.zeros_like(diag)
        if self.iadvwt == adv_mod.TVD:
            rhs = rhs + adv_mod.tvd_rhs(dtopo, fields, ibound, temp, scl)

        # CND: the conductances are in energy units already (cnd_fc adds
        # them without eqnsclfac)
        if self.cnd is not None:
            n, m = dtopo.edge_n, dtopo.edge_m
            dcond = cnd_mod.edge_conductance(
                dtopo, self.cnd, self.est_arrays.porosity, scl, fields,
                ibound, top, bot)
            act = (ibound[n] != 0) & (ibound[m] != 0)
            dcond = torch.where(act, dcond, DZERO)
            flat = off.view(-1)
            flat[dtopo.slot_nm] += dcond
            flat[dtopo.slot_mn] += dcond
            diag = diag + npf_mod._row_sum(dtopo, -dcond, -dcond)

        # EST storage, aqueous and solid
        hcof, rhs_coeff = est_mod.storage_terms(self.est_opts,
                                                self.est_arrays, fields,
                                                ibound, top, bot, area, delt)
        diag = diag + hcof
        rhs = rhs + rhs_coeff * temp_old

        # EST zero-order energy decay
        if self.est_opts.idcy != est_mod.DECAY_OFF:
            rhs = rhs + est_mod.decay_terms(self.est_opts, self.est_arrays,
                                            fields, ibound, top, bot, area)

        # SSM: boundary flows carry energy at the source or cell
        # temperature
        if self.ssm_on:
            diag, rhs = self._ssm(fields, ibound, diag, rhs)

        # ESL: an energy loading rate (no eqnsclfac)
        if self.esl is not None:
            esl = self.esl
            act = esl.mask & (ibound[esl.node] > 0)
            rhs = esl.add_plan.add(rhs, torch.where(act, -esl.q, DZERO))

        return diag, off, rhs
