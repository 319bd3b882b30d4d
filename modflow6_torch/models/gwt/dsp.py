"""DSP: hydrodynamic dispersion, mechanical dispersion and molecular
diffusion, in the two-point form.

Port of modflow6_tpu/models/gwt/dsp.py (reference gwt-dsp.f90:
calcdispellipse :636-743, calcdispcoef :747-873, dsp_fc :254-295, the last
applied by ``GwtModel.assemble``).  The reference computes the two-point
form only (no XT3D); its specific discharge per cell is a component-wise
least-squares average of the face-normal fluxes, exact on orthogonal DIS
grids.

The per-cell sums of per-face terms in ``cell_spdis`` go through the ELL
slots (``npf._row_sum``).  ``cos``, ``sin``, ``sqrt``, ``arcsin`` and
``arccos`` may differ from XLA's in the last bit, so the conductances agree
with the reference's to rounding, not bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from ...constants import C3D_STAGGERED, C3D_VERTICAL, DHALF, DONE, DPI, DZERO
from ...ops.conductance import staggered_thkfrac
from ..gwf.npf import _hyeff, _row_sum


@dataclasses.dataclass(frozen=True)
class DspData:
    """DSP griddata (reference dsp_ar / read_data)."""

    alh: torch.Tensor    # f64[N] longitudinal dispersivity, horizontal flow
    alv: torch.Tensor    # f64[N] longitudinal, vertical flow (defaults alh)
    ath1: torch.Tensor   # f64[N] transverse horizontal 1
    ath2: torch.Tensor   # f64[N] transverse horizontal 2 (defaults ath1)
    atv: torch.Tensor    # f64[N] transverse vertical
    diffc: torch.Tensor  # f64[N] molecular diffusion coefficient
    idisp: int = 0       # mechanical dispersion active
    idiffc: int = 0      # molecular diffusion active


def cell_spdis(dtopo, q_edge, sat, top, bot):
    """Specific-discharge vector (qx, qy, qz) per cell from the edge flows:
    for each component i, q_i = Σ_f qhat_f n_i / Σ_f n_i² over the cell's
    faces, qhat_f the face-normal specific discharge (the reference's
    calc_spdis role, exact on face-orthogonal grids)."""
    n, m = dtopo.edge_n, dtopo.edge_m
    is_vert = dtopo.ihc == C3D_VERTICAL
    thksat = DHALF * (sat[n] * (top[n] - bot[n]) + sat[m] * (top[m] - bot[m]))
    area = torch.where(is_vert, dtopo.hwva, dtopo.hwva * thksat)
    qhat = -q_edge / torch.where(area > DZERO, area, DONE)
    qhat = torch.where(area > DZERO, qhat, DZERO)
    # unit normal n → m: horizontal from anglex; vertical is -z (m is the
    # deeper cell; z is positive upward)
    zero = torch.zeros_like(qhat)
    nx = torch.where(is_vert, zero, torch.cos(dtopo.anglex))
    ny = torch.where(is_vert, zero, torch.sin(dtopo.anglex))
    nz = torch.where(is_vert, -DONE, zero)

    out = []
    for ncomp in (nx, ny, nz):
        qn = qhat * ncomp
        w = ncomp * ncomp
        q_acc = _row_sum(dtopo, qn, qn)
        w_acc = _row_sum(dtopo, w, w)
        out.append(torch.where(
            w_acc > DZERO, q_acc / torch.where(w_acc > 0, w_acc, DONE),
            DZERO))
    return tuple(out)


def dispersion_ellipse(dsp: DspData, porosity, qx, qy, qz, active):
    """Per-cell dispersion tensor diagonal and rotation angles (reference
    calcdispellipse, gwt-dsp.f90:636-743)."""
    qsq = qx * qx + qy * qy + qz * qz
    q = torch.where(qsq > DZERO, torch.sqrt(qsq), DZERO)
    safe_q = torch.where(q > 0, q, DONE)
    zero = torch.zeros_like(q)

    dstar = dsp.diffc * porosity if dsp.idiffc else zero
    if dsp.idisp:
        qzoq2 = torch.where(q > DZERO, (qz / safe_q) ** 2, DZERO)
        al = dsp.alh * (DONE - qzoq2) + dsp.alv * qzoq2
        at1 = dsp.ath1 * (DONE - qzoq2) + dsp.atv * qzoq2
        at2 = dsp.ath2 * (DONE - qzoq2) + dsp.atv * qzoq2
        al = torch.where(q > DZERO, al, DZERO)
        at1 = torch.where(q > DZERO, at1, DZERO)
        at2 = torch.where(q > DZERO, at2, DZERO)
    else:
        al = at1 = at2 = zero

    d11 = al * q + dstar
    d22 = at1 * q + dstar
    d33 = at2 * q + dstar

    # rotation angles: the reference clamps acos to [0, pi], losing qy's
    # sign (gwt-dsp.f90:709-741); kept as it is
    if dsp.idisp:
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


def edge_dispersion_conductance(dtopo, d11, d22, d33, ang1, ang2, ang3,
                                sat, top, bot, active):
    """Per-edge dispersion conductance (reference calcdispcoef,
    gwt-dsp.f90:747-873): each cell's tensor projected on the connection
    normal (hyeff, arithmetic averaging), the two half-cell conductances
    combined harmonically with saturated areas."""
    n, m = dtopo.edge_n, dtopo.edge_m
    is_vert = dtopo.ihc == C3D_VERTICAL
    is_stag = dtopo.ihc == C3D_STAGGERED

    # connection normal (its sign does not matter under the squares)
    zero = torch.zeros_like(dtopo.cl1)
    vg1 = torch.where(is_vert, zero, torch.cos(dtopo.anglex))
    vg2 = torch.where(is_vert, zero, torch.sin(dtopo.anglex))
    vg3 = torch.where(is_vert, DONE, zero)

    dn = _hyeff(d11[n], d22[n], d33[n], ang1[n], ang2[n], ang3[n],
                vg1, vg2, vg3, iavgmeth=1)
    dm = _hyeff(d11[m], d22[m], d33[m], ang1[m], ang2[m], ang3[m],
                vg1, vg2, vg3, iavgmeth=1)

    topn, topm = top[n], top[m]
    botn, botm = bot[n], bot[m]
    satn, satm = sat[n], sat[m]

    # vertical: half-thickness path lengths; the area drops when either
    # side is dry or the lower one partially saturated (reference
    # :809-829; with n < m its "n > m" branch never runs)
    clnm_v = satn * (topn - botn) * DHALF
    clmn_v = satm * (topm - botm) * DHALF
    anm_v = torch.where((satn == DZERO) | (satm == DZERO) | (satm < DONE),
                        DZERO, dtopo.hwva)
    amn_v = anm_v

    # horizontal: saturated-thickness areas (staggered-aware)
    thksatn = torch.where(is_stag,
                          staggered_thkfrac(topn, botn, satn, topm, botm),
                          (topn - botn) * satn)
    thksatm = torch.where(is_stag,
                          staggered_thkfrac(topm, botm, satm, topn, botn),
                          (topm - botm) * satm)
    dry = (satn == DZERO) | (satm == DZERO)
    anm_h = torch.where(dry, DZERO, thksatn * dtopo.hwva)
    amn_h = torch.where(dry, DZERO, thksatm * dtopo.hwva)

    clnm = torch.where(is_vert, clnm_v, dtopo.cl1)
    clmn = torch.where(is_vert, clmn_v, dtopo.cl2)
    anm = torch.where(is_vert, anm_v, anm_h)
    amn = torch.where(is_vert, amn_v, amn_h)

    cn = torch.where(clnm > DZERO,
                     dn * anm / torch.where(clnm > 0, clnm, DONE), DZERO)
    cm = torch.where(clmn > DZERO,
                     dm * amn / torch.where(clmn > 0, clmn, DONE), DZERO)
    denom = cn + cm
    cond = torch.where(denom > DZERO,
                       cn * cm / torch.where(denom > 0, denom, DONE), DZERO)
    return torch.where(active[n] & active[m], cond, DZERO)


def edge_conductance(dtopo, dsp: DspData, porosity, fields, ibound, top,
                     bot):
    """The per-step dispersion conductance of each edge from the flow
    fields (the dsp_ad → calcdispellipse → calcdispcoef chain)."""
    active = (ibound != 0) & (fields.sat > DZERO)
    qx, qy, qz = cell_spdis(dtopo, fields.q_edge, fields.sat, top, bot)
    d11, d22, d33, a1, a2, a3 = dispersion_ellipse(dsp, porosity, qx, qy, qz,
                                                   active)
    return edge_dispersion_conductance(dtopo, d11, d22, d33, a1, a2, a3,
                                       fields.sat, top, bot, active)
