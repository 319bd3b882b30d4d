"""EST: energy storage and transfer (the GWE analog of GWT's MST).

Port of modflow6_tpu/models/gwe/est.py (reference gwe-est.f90:
est_fc_sto :202-244, the aqueous heat storage scaled by eqnsclfac =
rhow·cpw plus the solid phase's rhos·cps·(1 − porosity)·vcell;
est_fc_dcy_water :250-292 and est_fc_dcy_solid :298-341, zero-order
energy sinks).  GWE has no sorption: the solid takes part through its heat
capacity.  Every term is elementwise per cell.
"""

from __future__ import annotations

import dataclasses

import torch

from ...constants import DONE, DZERO

DECAY_OFF = 0
DECAY_ZERO_ORDER = 1

DECAY_WATER = 1
DECAY_SOLID = 2
DECAY_BOTH = 3


@dataclasses.dataclass(frozen=True)
class EstOptions:
    idcy: int = DECAY_OFF
    idcysrc: int = 0
    rhow: float = 1000.0
    cpw: float = 4184.0
    latheatvap: float = 0.0

    @property
    def eqnsclfac(self) -> float:
        return self.rhow * self.cpw


@dataclasses.dataclass(frozen=True)
class EstArrays:
    porosity: torch.Tensor     # θ
    cps: torch.Tensor          # solid heat capacity
    rhos: torch.Tensor         # solid density
    decay_water: torch.Tensor  # zero-order energy decay rate, aqueous
    decay_solid: torch.Tensor  # zero-order energy decay rate, solid


def storage_terms(opts: EstOptions, arrays: EstArrays, fields, ibound, top,
                  bot, area, delt):
    """est_fc_sto: (hcof[N], rhs_coeff[N]), the rhs term being
    rhs_coeff * told; the aqueous volumes follow the flow model's, with
    its storage-rate correction for the old volume."""
    tled = DONE / delt
    vcell = area * (top - bot)
    vnew = vcell * fields.sat * arrays.porosity
    vold = vnew + (fields.strg_ss + fields.strg_sy) * delt
    vsolid = vcell * (DONE - arrays.porosity)
    term = arrays.rhos * arrays.cps * vsolid
    act = ibound > 0
    return (torch.where(act, -(opts.eqnsclfac * vnew + term) * tled, DZERO),
            torch.where(act, -(opts.eqnsclfac * vold + term) * tled, DZERO))


def decay_terms(opts: EstOptions, arrays: EstArrays, fields, ibound, top,
                bot, area):
    """est_fc_dcy_water + est_fc_dcy_solid: the rhs[N] of the zero-order
    energy sinks (already energy rates: no eqnsclfac)."""
    vcell = area * (top - bot)
    act = ibound > 0
    rhs = torch.zeros_like(vcell)
    if opts.idcy == DECAY_ZERO_ORDER:
        if opts.idcysrc in (DECAY_WATER, DECAY_BOTH):
            rhs = rhs + torch.where(
                act, arrays.decay_water * vcell * fields.sat
                * arrays.porosity, DZERO)
        if opts.idcysrc in (DECAY_SOLID, DECAY_BOTH):
            rhs = rhs + torch.where(
                act, arrays.decay_solid * vcell * (DONE - arrays.porosity)
                * arrays.rhos, DZERO)
    return rhs
