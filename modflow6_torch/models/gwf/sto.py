"""STO: storage package — transient diagonal/rhs terms.

Port of modflow6_tpu/models/gwf/sto.py: ``sto_fc`` (:47, reference
gwf-sto.f90:226-345) and the Newton terms ``sto_fn`` (:82, reference
gwf-sto.f90:353-440).
"""

from __future__ import annotations

import dataclasses

import torch

from ...constants import DONE, DZERO
from ...ops.smoothing import (quadratic_saturation,
                              quadratic_saturation_derivative)
from ...ops.storage import ss_capacity, ss_terms, sy_capacity, sy_terms


@dataclasses.dataclass(frozen=True)
class StoOptions:
    """Static STO flags (the reference package's fields)."""

    istor_coef: int = 0     # STORAGECOEFFICIENT option
    iconf_ss: int = 0       # SS_CONFINED_ONLY
    iorig_ss: int = 0       # ORIGINAL_SPECIFIC_STORAGE (dev)
    inewton: int = 0
    integratechanges: int = 0  # TVS integration (oldss/oldsy differ)
    satomega: float = 0.0


@dataclasses.dataclass(frozen=True)
class StoArrays:
    iconvert: torch.Tensor  # i32[N] convertible flag
    ss: torch.Tensor        # f64[N] specific storage (or storage coefficient)
    sy: torch.Tensor        # f64[N] specific yield
    top: torch.Tensor
    bot: torch.Tensor
    area: torch.Tensor


def assemble(opts: StoOptions, arrays: StoArrays, head, head_old, ibound,
             delt):
    """sto_fc: (diag_add[N], rhs_add[N]) for the current time step length."""
    tled = DONE / delt
    tp, bt = arrays.top, arrays.bot
    is_conv = arrays.iconvert != 0

    snold = torch.where(
        is_conv, quadratic_saturation(tp, bt, head_old, opts.satomega), DONE)
    snnew = torch.where(
        is_conv, quadratic_saturation(tp, bt, head, opts.satomega), DONE)

    sc1 = ss_capacity(opts.istor_coef, tp, bt, arrays.area, arrays.ss)
    rho1 = sc1 * tled
    aterm, rhsterm = ss_terms(arrays.iconvert, opts.iorig_ss, opts.iconf_ss,
                              tp, bt, rho1, rho1, snnew, snold, head,
                              head_old)

    sc2 = sy_capacity(arrays.area, arrays.sy)
    rho2 = sc2 * tled
    aterm2, rhsterm2 = sy_terms(tp, bt, rho2, rho2, snnew, snold)
    aterm = aterm + torch.where(is_conv, aterm2, DZERO)
    rhsterm = rhsterm + torch.where(is_conv, rhsterm2, DZERO)

    active = ibound >= 1
    return (torch.where(active, aterm, DZERO),
            torch.where(active, rhsterm, DZERO))


def newton_terms(opts: StoOptions, arrays: StoArrays, head, ibound, delt):
    """sto_fn: storage Newton terms (diag_add, rhs_add).

    Mirrors gwf-sto.f90:353-440: derivative of the SS (and SY when
    convertible) storage volume w.r.t. head for partially saturated cells.
    """
    tled = DONE / delt
    tp, bt = arrays.top, arrays.bot
    tthk = tp - bt
    h = head
    # sto_fn uses the default smoothing width, not satomega (gwf-sto.f90:398)
    snnew = quadratic_saturation(tp, bt, h)
    derv = quadratic_saturation_derivative(tp, bt, h)

    sc1 = ss_capacity(opts.istor_coef, tp, bt, arrays.area, arrays.ss)
    rho1 = sc1 * tled
    if opts.iconf_ss == 0:
        if opts.iorig_ss == 0:
            ss_drterm = -rho1 * derv * (h - bt) + rho1 * tthk * snnew * derv
        else:
            ss_drterm = -(rho1 * derv * h)
        ss_diag = ss_drterm
        ss_rhs = ss_drterm * h
    else:
        ss_diag = torch.zeros_like(h)
        ss_rhs = torch.zeros_like(h)

    sc2 = sy_capacity(arrays.area, arrays.sy)
    rho2 = sc2 * tled
    partially = (snnew < DONE) & (snnew > DZERO)
    sy_rterm = -rho2 * tthk * snnew
    sy_drterm = -rho2 * tthk * derv
    sy_diag = torch.where(partially, sy_drterm + rho2, DZERO)
    sy_rhs = torch.where(partially, -sy_rterm + sy_drterm * h + rho2 * bt,
                         DZERO)

    is_conv = (arrays.iconvert != 0) & (ibound > 0)
    diag_add = torch.where(is_conv, ss_diag + sy_diag, DZERO)
    rhs_add = torch.where(is_conv, ss_rhs + sy_rhs, DZERO)
    return diag_add, rhs_add
