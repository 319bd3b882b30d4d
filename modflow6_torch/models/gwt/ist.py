"""IST: immobile storage and transfer (dual-domain transport).

Port of modflow6_tpu/models/gwt/ist.py (reference gwt-ist.f90): the
immobile-domain balance is solved per cell in closed form given the mobile
concentration (get_ddterm), contributing

    hcof = ζ²V s/f − ζV s          rhs = −(ζV s/f)·[(T₁+T₃)·cim_old − γ…]

to the mobile equation (get_hcofrhs); the immobile concentration then
advances as cim_new = [(T₁+T₃)·cim_old + ζVs·c_new − γ…]/f (get_ddconc).
Linear, Freundlich and Langmuir immobile isotherms (through the effective
kd at the lagged immobile concentration) and first- or zero-order decay
in the immobile domain.  ``cim`` is state: ``Simulation`` advances it
after the accepted transport solve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ... import resolve_device
from ...constants import DZERO
from ..gwf.builder import _full


@dataclasses.dataclass(frozen=True)
class IstData:
    thetaim: torch.Tensor        # immobile-domain porosity
    zetaim: torch.Tensor         # mobile-immobile transfer rate
    volfrac: torch.Tensor        # immobile volume fraction (sorption)
    bulk_density: torch.Tensor
    distcoef: torch.Tensor       # linear Kd / Freundlich Kf / Langmuir Kl
    decay: torch.Tensor          # aqueous decay rate
    decay_sorbed: torch.Tensor
    sp2: Optional[torch.Tensor] = None   # Freundlich exponent / Langmuir sbar
    idcy: int = 0                # 0 off, 1 first-order, 2 zero-order
    isrb: int = 0                # 0 off, 1 linear, 2 Freundlich, 3 Langmuir


def make_ist(n, thetaim=0.0, zetaim=0.0, volfrac=0.0, bulk_density=0.0,
             distcoef=0.0, decay=0.0, decay_sorbed=None, sp2=1.0, idcy=0,
             isrb=0, device=None) -> IstData:
    if isrb not in (0, 1, 2, 3):
        raise ValueError("isrb must be 0 (off), 1 (linear), "
                         "2 (freundlich) or 3 (langmuir)")
    device = resolve_device(device)

    def full(v):
        return _full(v, n, torch.float64, device)

    return IstData(full(thetaim), full(zetaim), full(volfrac),
                   full(bulk_density), full(distcoef), full(decay),
                   full(decay_sorbed if decay_sorbed is not None else decay),
                   full(sp2), idcy=int(idcy), isrb=int(isrb))


def effective_kd(ist: IstData, cim):
    """Effective immobile distribution coefficient at the lagged immobile
    concentration (get_freundlich_kd / get_langmuir_kd, gwt-mst.f90)."""
    if ist.isrb == 0:
        return torch.zeros_like(ist.distcoef)
    if ist.isrb == 1:
        return ist.distcoef
    c = cim.clamp(min=DZERO)
    if ist.isrb == 2:      # Freundlich: cbar = Kf c^a
        return torch.where(c > DZERO, ist.distcoef * c ** (ist.sp2 - 1.0),
                           DZERO)
    # Langmuir: cbar = Kl sbar c / (1 + Kl c)
    return torch.where(c > DZERO,
                       ist.distcoef * ist.sp2 / (1.0 + ist.distcoef * c),
                       DZERO)


def _ddterms(ist: IstData, sat, area, top, bot, cim_old, delt):
    """The balance terms T1, T3, T7, T8, T9 and the denominator f
    (get_ddterm)."""
    tled = 1.0 / delt
    vcell = area * (top - bot)
    kd = effective_kd(ist, cim_old)
    vfrho = (ist.volfrac * ist.bulk_density if ist.isrb
             else torch.zeros_like(ist.volfrac))
    lam1 = ist.decay if ist.idcy == 1 else DZERO
    lam2 = ist.decay_sorbed if (ist.idcy == 1 and ist.isrb) else DZERO
    gam1 = ist.decay if ist.idcy == 2 else DZERO
    gam2 = ist.decay_sorbed if (ist.idcy == 2 and ist.isrb) else DZERO
    t1 = ist.thetaim * vcell * tled
    t3 = vfrho * vcell * kd * tled
    t5 = ist.thetaim * lam1 * vcell
    t6 = lam2 * vfrho * kd * vcell
    t7 = ist.thetaim * gam1 * vcell
    t8 = gam2 * vfrho * vcell
    t9 = vcell * sat * ist.zetaim
    f = t1 + t3 + t5 + t6 + t9
    return t1, t3, t7, t8, t9, f


def ist_terms(ist: IstData, sat, area, top, bot, ibound, conc_old, cim_old,
              delt):
    """(hcof, rhs) of the mobile equation (get_hcofrhs)."""
    t1, t3, t7, t8, t9, f = _ddterms(ist, sat, area, top, bot, cim_old,
                                     delt)
    fsafe = torch.where(f != 0.0, f, 1.0)
    hcof = t9 * t9 / fsafe - t9
    rhs = ((t1 + t3) * cim_old - t7 - t8) * t9 / fsafe
    act = ibound > 0
    return torch.where(act, hcof, DZERO), torch.where(act, -rhs, DZERO)


def ist_update(ist: IstData, sat, area, top, bot, ibound, conc_old,
               cim_old, conc_new, delt):
    """cim at the end of the step (get_ddconc)."""
    t1, t3, t7, t8, t9, f = _ddterms(ist, sat, area, top, bot, cim_old,
                                     delt)
    fsafe = torch.where(f != 0.0, f, 1.0)
    cim_new = ((t1 + t3) * cim_old + t9 * conc_new - t7 - t8) / fsafe
    return torch.where(ibound > 0, cim_new, cim_old)
