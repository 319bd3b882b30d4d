"""VSC: viscosity; scales hydraulic conductivity by viscref/viscosity of
the concentration or temperature.

Port of modflow6_tpu/models/gwf/vsc.py (``VscData``, ``make_vsc``,
``calc_visc``, ``viscosity_ratio``; reference gwf-vsc.f90 calc_visc:97-133
and update_k_with_vsc:824-845).  The model scales K inside its assembly
with the lagged concentration field and rebuilds the saturated
conductance from it, so no K state changes.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class VscData:
    viscref: float           # reference viscosity
    dviscdc: tuple           # per species: linear slope
    cviscref: tuple          # per species: reference conc/temperature
    ivisc: tuple = (1,)      # per species: 1=linear, 2=nonlinear temperature
    a2: float = 10.0         # nonlinear temperature-correction constants
    a3: float = 248.37       # (vsc-options defaults, gwf-vsc.dfn)
    a4: float = 133.15


def make_vsc(viscref=1.0, dviscdc=0.0, cviscref=0.0, ivisc=None,
             a2=10.0, a3=248.37, a4=133.15) -> VscData:
    dviscdc = tuple(float(v) for v in torch.atleast_1d(
        torch.as_tensor(dviscdc, dtype=torch.float64)).tolist())
    cviscref = torch.broadcast_to(
        torch.as_tensor(cviscref, dtype=torch.float64), (len(dviscdc),))
    if ivisc is None:
        ivisc = (1,) * len(dviscdc)
    return VscData(float(viscref), dviscdc,
                   tuple(float(v) for v in cviscref.tolist()),
                   ivisc=tuple(int(i) for i in ivisc),
                   a2=float(a2), a3=float(a3), a4=float(a4))


def calc_visc(vsc: VscData, conc):
    """Per-cell viscosity (calc_visc, gwf-vsc.f90:97-133).

    ``conc``: f64[N] or f64[nspecies, N]."""
    c = torch.atleast_2d(conc)
    visc = torch.full((c.shape[1],), vsc.viscref, dtype=c.dtype,
                      device=c.device)
    for i, kind in enumerate(vsc.ivisc):
        if kind == 1:
            visc = visc + vsc.dviscdc[i] * (c[i] - vsc.cviscref[i])
        else:
            expon = -vsc.a3 * ((c[i] - vsc.cviscref[i])
                               / ((c[i] + vsc.a4) * (vsc.cviscref[i]
                                                     + vsc.a4)))
            mu_t = vsc.viscref * vsc.a2 ** expon
            visc = (visc - vsc.viscref) + mu_t
    return visc


def viscosity_ratio(vsc: VscData, conc):
    """viscref / visc — the K multiplier (calc_q_visc role)."""
    visc = calc_visc(vsc, conc)
    return vsc.viscref / torch.where(visc != 0.0, visc, vsc.viscref)
