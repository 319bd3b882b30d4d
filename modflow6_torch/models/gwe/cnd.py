"""CND: thermal conduction and mechanical heat dispersion (the GWE analog
of DSP).

Port of modflow6_tpu/models/gwe/cnd.py (reference gwe-cnd.f90:
calcdispellipse :636-759 with d11 = αL·q·sat·eqnsclfac + ktbulk and
ktbulk = porosity·sat·ktw + (1 − porosity)·kts, so the tensor is in
energy-conductance units and cnd_fc adds it without a further eqnsclfac;
calcdispcoef, the connection conductance that DSP shares:
``dsp.edge_dispersion_conductance``).  Like DSP's, its trigonometry
(``arcsin``, ``cos``, ``arccos``, ``sqrt``) differs from XLA's in the last
bit, so its conductances agree with the reference's to 1e-12 relative.
"""

from __future__ import annotations

import dataclasses

import torch

from ...constants import DONE, DPI, DZERO
from ..gwt import dsp as dsp_mod


@dataclasses.dataclass(frozen=True)
class CndData:
    """CND griddata (gwe-cnd.f90 read_data)."""

    alh: torch.Tensor    # f64[N] longitudinal dispersivity, horizontal flow
    alv: torch.Tensor
    ath1: torch.Tensor
    ath2: torch.Tensor
    atv: torch.Tensor
    ktw: torch.Tensor    # f64[N] thermal conductivity of water
    kts: torch.Tensor    # f64[N] thermal conductivity of the solid
    idisp: int = 0
    iktw: int = 0
    ikts: int = 0


def thermal_ellipse(cnd: CndData, porosity, sat, eqnsclfac, qx, qy, qz,
                    active):
    """Per-cell thermal dispersion tensor diagonal and rotation angles
    (gwe-cnd.f90 calcdispellipse)."""
    qsq = qx * qx + qy * qy + qz * qz
    q = torch.where(qsq > DZERO, torch.sqrt(qsq), DZERO)
    safe_q = torch.where(q > 0, q, DONE)
    zero = torch.zeros_like(q)

    ktbulk = torch.zeros_like(porosity)
    if cnd.iktw:
        ktbulk = ktbulk + porosity * cnd.ktw * sat
    if cnd.ikts:
        ktbulk = ktbulk + (DONE - porosity) * cnd.kts

    if cnd.idisp:
        qzoq2 = torch.where(q > DZERO, (qz / safe_q) ** 2, DZERO)
        al = cnd.alh * (DONE - qzoq2) + cnd.alv * qzoq2
        at1 = cnd.ath1 * (DONE - qzoq2) + cnd.atv * qzoq2
        at2 = cnd.ath2 * (DONE - qzoq2) + cnd.atv * qzoq2
        al = torch.where(q > DZERO, al, DZERO)
        at1 = torch.where(q > DZERO, at1, DZERO)
        at2 = torch.where(q > DZERO, at2, DZERO)
    else:
        al = at1 = at2 = zero

    qsw = q * sat * eqnsclfac
    d11 = al * qsw + ktbulk
    d22 = at1 * qsw + ktbulk
    d33 = at2 * qsw + ktbulk

    if cnd.idisp:
        a2 = torch.arcsin(torch.where(q > DZERO, qz / safe_q, DZERO))
        den = q * torch.cos(a2)
        a = torch.where(den != DZERO,
                        qx / torch.where(den != 0, den, DONE), DZERO)
        ang1 = torch.where(a <= -DONE, DPI, torch.where(
            a >= DONE, DZERO, torch.arccos(a.clamp(-DONE, DONE))))
        ang2 = a2
    else:
        ang1 = ang2 = zero
    ang3 = zero

    def z(x):
        return torch.where(active, x, DZERO)
    return z(d11), z(d22), z(d33), z(ang1), z(ang2), z(ang3)


def edge_conductance(dtopo, cnd: CndData, porosity, eqnsclfac, fields,
                     ibound, top, bot):
    """The per-step conduction and thermal-dispersion conductance of each
    edge, in energy units."""
    active = (ibound != 0) & (fields.sat > DZERO)
    qx, qy, qz = dsp_mod.cell_spdis(dtopo, fields.q_edge, fields.sat, top,
                                    bot)
    d11, d22, d33, a1, a2, a3 = thermal_ellipse(
        cnd, porosity, fields.sat, eqnsclfac, qx, qy, qz, active)
    return dsp_mod.edge_dispersion_conductance(
        dtopo, d11, d22, d33, a1, a2, a3, fields.sat, top, bot, active)
