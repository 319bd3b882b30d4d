"""Inter-cell conductance math, elementwise on tensors.

Port of modflow6_tpu/ops/conductance.py:36-208 (reference
GwfConductanceUtils.f90).  ``icellavg``, ``iupstream``, ``ivarcv`` and
``idewatcv`` are static Python ints that select the expression.
"""

import torch

from ..constants import (
    C3D_STAGGERED,
    CCOND_AMTHMK,
    CCOND_AMTLMK,
    CCOND_HMEAN,
    CCOND_LMEAN,
    DHALF,
    DLNHIGH,
    DLNLOW,
    DONE,
    DZERO,
)


def logmean(d1, d2):
    """Logarithmic mean of two positive numbers, arithmetic near ratio 1."""
    safe_d1 = torch.where(d1 != DZERO, d1, DONE)
    drat = d2 / safe_d1
    use_log = (drat <= DLNLOW) | (drat >= DLNHIGH)
    safe_log = torch.log(torch.where(use_log & (drat > DZERO), drat, DONE))
    safe_log = torch.where(safe_log != DZERO, safe_log, DONE)
    return torch.where(use_log, (d2 - d1) / safe_log, DHALF * (d1 + d2))


def condmean(k1, k2, thick1, thick2, cl1, cl2, width, iavgmeth):
    """Mean conductance between two cells for the given averaging method."""
    t1 = k1 * thick1
    t2 = k2 * thick2
    if iavgmeth == CCOND_HMEAN:
        denom = t1 * cl2 + t2 * cl1
        safe = torch.where(denom != DZERO, denom, DONE)
        return torch.where(t1 * t2 > DZERO, width * t1 * t2 / safe, DZERO)
    elif iavgmeth == CCOND_LMEAN:
        tmean = torch.where(t1 * t2 > DZERO, logmean(t1, t2), DZERO)
        return tmean * width / (cl1 + cl2)
    elif iavgmeth == CCOND_AMTLMK:
        kmean = torch.where(k1 * k2 > DZERO, logmean(k1, k2), DZERO)
        return kmean * DHALF * (thick1 + thick2) * width / (cl1 + cl2)
    elif iavgmeth == CCOND_AMTHMK:
        denom = k1 * cl2 + k2 * cl1
        safe = torch.where(denom > DZERO, denom, DONE)
        kmean = torch.where(denom > DZERO, k1 * k2 / safe, DZERO)
        return kmean * DHALF * (thick1 + thick2) * width
    else:
        raise ValueError(f"unknown cell averaging method {iavgmeth}")


def staggered_thkfrac(top, bot, sat, topc, botc):
    """Wetted thickness of a cell limited to the overlap (sill) with its neighbor."""
    sill_top = torch.minimum(top, topc)
    sill_bot = torch.maximum(bot, botc)
    tp = bot + sat * (top - bot)
    return torch.clamp(torch.minimum(tp, sill_top) - sill_bot, min=DZERO)


def hcond(ibdn, ibdm, ictn, ictm, iupstream, ihc, icellavg, condsat,
          hn, hm, satn, satm, hkn, hkm, topn, topm, botn, botm,
          cln, clm, fawidth):
    """Horizontal conductance between connected cell pairs.

    ``iupstream`` and ``icellavg`` are static ints; ``ihc`` is an int or a
    tensor over connections; everything else is a tensor.
    """
    if iupstream == 1:
        sat_up = torch.where(hn > hm, satn, satm)
        cond_conv = sat_up * condsat
    else:
        def thick(top, bot, sat, topc, botc):
            flat = sat * (top - bot)
            if isinstance(ihc, int):
                # one connection type for every pair (the structured
                # planes): chosen on the host, with no flag copied to the
                # device, which would wait for it
                return (staggered_thkfrac(top, bot, sat, topc, botc)
                        if ihc == C3D_STAGGERED else flat)
            is_stag = torch.as_tensor(ihc == C3D_STAGGERED, device=sat.device)
            return torch.where(
                is_stag, staggered_thkfrac(top, bot, sat, topc, botc), flat)

        thksatn = thick(topn, botn, satn, topm, botm)
        thksatm = thick(topm, botm, satm, topn, botn)
        cond_conv = condmean(hkn, hkm, thksatn, thksatm, cln, clm, fawidth,
                             icellavg)

    both_nonconvertible = (ictn == 0) & (ictm == 0)
    cond = torch.where(both_nonconvertible, condsat, cond_conv)
    inactive = (ibdn == 0) | (ibdm == 0)
    return torch.where(inactive, DZERO, cond)


def vcond(ibdn, ibdm, ictn, ictm, ivarcv, idewatcv, condsat, hn, hm,
          vkn, vkm, satn, satm, topn, topm, botn, botm, flowarea):
    """Vertical conductance between vertically connected cell pairs.

    ``ivarcv``/``idewatcv`` are static ints (NPF VARIABLECV / DEWATERED).
    Cell n is the upper cell of each pair.
    """
    inactive = (ibdn == 0) | (ibdm == 0)
    if ivarcv == 0:
        return torch.where(inactive, DZERO, condsat)

    # variable-CV path: recompute from wetted thicknesses when not saturated
    if idewatcv == 0:
        # no dewatered correction: underlying cell treated as fully saturated
        n_is_upper = botn > botm
        satntmp = torch.where(n_is_upper, satn, DONE)
        satmtmp = torch.where(n_is_upper, DONE, satm)
    else:
        satntmp = satn
        satmtmp = satm
    bovk1 = satntmp * (topn - botn) * DHALF / vkn
    bovk2 = satmtmp * (topm - botm) * DHALF / vkm
    denom = bovk1 + bovk2
    safe = torch.where(denom != DZERO, denom, DONE)
    cond_recalc = torch.where(denom != DZERO, flowarea / safe, DZERO)

    both_nonconvertible = (ictn == 0) & (ictm == 0)
    fully_saturated = (hn >= topn) & (hm >= topm)
    cond = torch.where(both_nonconvertible | fully_saturated, condsat,
                       cond_recalc)
    return torch.where(inactive, DZERO, cond)


def thksatnm(ibdn, ibdm, ictn, ictm, iupstream, ihc, hn, hm, satn, satm,
             topn, topm, botn, botm):
    """Wetted interface thickness for a horizontal connection (for
    spdis/flows)."""
    is_stag = torch.as_tensor(ihc == C3D_STAGGERED, device=satn.device)

    # both non-convertible
    sill_top = torch.minimum(topn, topm)
    sill_bot = torch.maximum(botn, botm)
    thk_stag_conf = torch.clamp(sill_top - sill_bot, min=DZERO)
    thk_conf = torch.where(is_stag, thk_stag_conf,
                           DHALF * ((topn - botn) + (topm - botm)))

    if iupstream == 1:
        thk_conv = torch.where(hn > hm, satn * (topn - botn),
                               satm * (topm - botm))
    else:
        thksatn = torch.where(
            is_stag, staggered_thkfrac(topn, botn, satn, topm, botm),
            satn * (topn - botn))
        thksatm = torch.where(
            is_stag, staggered_thkfrac(topm, botm, satm, topn, botn),
            satm * (topm - botm))
        thk_conv = DHALF * (thksatn + thksatm)

    both_nonconvertible = (ictn == 0) & (ictm == 0)
    res = torch.where(both_nonconvertible, thk_conf, thk_conv)
    inactive = (ibdn == 0) | (ibdm == 0)
    return torch.where(inactive, DZERO, res)
