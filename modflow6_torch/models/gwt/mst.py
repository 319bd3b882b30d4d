"""MST: mobile storage and transfer — storage, decay and sorption.

Port of modflow6_tpu/models/gwt/mst.py (reference gwt-mst.f90:
mst_fc_sto :215-255, mst_fc_dcy :261-313, mst_fc_srb / mst_srb_term
:319-446, mst_fc_dcy_srb :452-520, and the zero-order decay limit of
get_zero_order_decay).  Every term is elementwise per cell.
"""

from __future__ import annotations

import dataclasses

import torch

from ...constants import DHALF, DONE, DZERO

DECAY_OFF = 0
DECAY_FIRST_ORDER = 1
DECAY_ZERO_ORDER = 2

SORPTION_OFF = 0
SORPTION_LINEAR = 1
SORPTION_FREUND = 2
SORPTION_LANG = 3


@dataclasses.dataclass(frozen=True)
class MstOptions:
    idcy: int = DECAY_OFF
    isrb: int = SORPTION_OFF


@dataclasses.dataclass(frozen=True)
class MstArrays:
    porosity: torch.Tensor      # θ mobile
    decay: torch.Tensor
    decay_sorbed: torch.Tensor
    bulk_density: torch.Tensor
    distcoef: torch.Tensor
    sp2: torch.Tensor


def storage_terms(arrays, fields, ibound, top, bot, area, delt):
    """mst_fc_sto: (hcof[N], rhs_coeff[N]), the rhs term being
    rhs_coeff * cold."""
    tled = DONE / delt
    vnew = area * (top - bot) * fields.sat * arrays.porosity
    vold = vnew + (fields.strg_ss + fields.strg_sy) * delt
    act = ibound > 0
    return (torch.where(act, -vnew * tled, DZERO),
            torch.where(act, -vold * tled, DZERO))


def decay_terms(opts, arrays, fields, ibound, top, bot, area, cold, cnew,
                delt, kiter_is_first, decaylast):
    """mst_fc_dcy: (hcof, rhs, decaylast_new)."""
    vcell = area * (top - bot)
    sw = fields.sat
    act = ibound > 0
    if opts.idcy == DECAY_FIRST_ORDER:
        hcof = torch.where(act, -arrays.decay * vcell * sw * arrays.porosity,
                           DZERO)
        return hcof, torch.zeros_like(cold), decaylast
    if opts.idcy == DECAY_ZERO_ORDER:
        # the rate is limited so that decay cannot drive a concentration
        # negative (reference get_zero_order_decay)
        decay_rate = arrays.decay if kiter_is_first else decaylast
        cmid = DHALF * (cold + cnew)
        max_rate = cmid / delt * 2.0 if delt > 0 else arrays.decay
        rate = torch.minimum(decay_rate.clamp(min=DZERO),
                             max_rate.clamp(min=DZERO))
        rhs = torch.where(act, rate * vcell * sw * arrays.porosity, DZERO)
        return torch.zeros_like(cold), rhs, rate
    return torch.zeros_like(cold), torch.zeros_like(cold), decaylast


def sorption_terms(opts, arrays, fields, ibound, top, bot, area, cold, cnew,
                   delt):
    """mst_fc_srb: (hcof, rhs)."""
    tled = DONE / delt
    vcell = area * (top - bot)
    swnew = fields.sat
    swold = fields.sat_old
    act = ibound > 0
    rhob = arrays.bulk_density
    volfracm = DONE  # the mobile volume fraction (IST would reduce it)
    if opts.isrb == SORPTION_LINEAR:
        term = -volfracm * rhob * vcell * tled * arrays.distcoef
        hcof = term * swnew
        rhs = term * swold * cold
    else:
        cavg = DHALF * (cold + cnew)
        safe = cavg.clamp(min=1e-30)
        kd, sp2 = arrays.distcoef, arrays.sp2
        if opts.isrb == SORPTION_FREUND:
            cbarnew = kd * cnew.clamp(min=DZERO) ** sp2
            cbarold = kd * cold.clamp(min=DZERO) ** sp2
            derv = sp2 * kd * safe ** (sp2 - DONE)
        else:  # langmuir
            cbarnew = kd * sp2 * cnew / (DONE + kd * cnew)
            cbarold = kd * sp2 * cold / (DONE + kd * cold)
            derv = kd * sp2 / (DONE + kd * cavg) ** 2
        term = -volfracm * rhob * vcell * tled
        cbaravg = DHALF * (cbarold + cbarnew)
        swavg = DHALF * (swnew + swold)
        hcof = term * derv * swavg
        rhs = term * derv * swavg * cold - term * cbaravg * (swnew - swold)
    return torch.where(act, hcof, DZERO), torch.where(act, rhs, DZERO)


def decay_sorbed_terms(opts, arrays, fields, ibound, top, bot, area, cold,
                       cnew, delt):
    """mst_fc_dcy_srb (the first-order, linear-sorption case)."""
    if opts.idcy != DECAY_FIRST_ORDER or opts.isrb != SORPTION_LINEAR:
        return torch.zeros_like(cold), torch.zeros_like(cold)
    vcell = area * (top - bot)
    hcof = (-arrays.decay_sorbed * arrays.bulk_density * arrays.distcoef
            * fields.sat * vcell)
    return torch.where(ibound > 0, hcof, DZERO), torch.zeros_like(cold)
