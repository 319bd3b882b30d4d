"""Smooth saturation functions, elementwise on tensors.

Port of modflow6_tpu/ops/smoothing.py (reference SmoothingFunctions.f90):
the same ``where`` ladders, in the same order of operations, so results
agree with the reference to rounding.
"""

import torch

from ..constants import DEM6, DHALF, DONE, DPREC, DZERO


def quadratic_saturation(top, bot, x, eps=DEM6):
    """Quadratic-smoothed saturation in [0, 1] for head ``x`` in cell (top, bot).

    Linear ramp between bot and top with quadratic smoothing of width ``eps``
    (fraction of thickness) at both ends.
    """
    b = top - bot
    safe_b = torch.where(b > DZERO, b, DONE)
    br = torch.clamp((x - bot) / safe_b, DZERO, DONE)
    av = DONE / (DONE - eps)
    bri = DONE - br
    y = torch.where(
        br < eps,
        av * DHALF * (br * br) / eps,
        torch.where(
            br < (DONE - eps),
            av * br + DHALF * (DONE - av),
            torch.where(br < DONE, DONE - (av * DHALF * (bri * bri)) / eps,
                        DONE),
        ),
    )
    # degenerate zero-thickness cell: step function
    y_step = torch.where(x < bot, DZERO, DONE).to(y.dtype)
    return torch.where(b > DZERO, y, y_step)


def quadratic_saturation_derivative(top, bot, x, eps=DEM6):
    """d(quadratic_saturation)/dx."""
    b = top - bot
    safe_b = torch.where(b != DZERO, b, DONE)
    br = torch.clamp((x - bot) / safe_b, DZERO, DONE)
    av = DONE / (DONE - eps)
    bri = DONE - br
    y = torch.where(
        br < eps,
        av * br / eps,
        torch.where(
            br < (DONE - eps),
            av,
            torch.where(br < DONE, av * bri / eps, DZERO),
        ),
    )
    return y / safe_b


def sq_saturation(top, bot, x, c1=-2.0, c2=3.0):
    """Cubic S-curve saturation (reference sQSaturation): 0 at bot, 1 at top."""
    b = top - bot
    safe_b = torch.where(b != DZERO, b, DONE)
    s = torch.clamp((x - bot) / safe_b, DZERO, DONE)
    return c1 * s**3 + c2 * s**2


def sq_saturation_derivative(top, bot, x, c1=-6.0, c2=6.0):
    """Derivative of the cubic S-curve saturation."""
    b = top - bot
    safe_b = torch.where(b != DZERO, b, DONE)
    s = torch.clamp((x - bot) / safe_b, DZERO, DONE)
    return (c1 * s**2 + c2 * s) / safe_b


def s_cubic_linear(x, srange):
    """Cubic-to-linear smoothing: y=0, dy/dx=0 at x=0; y=1, dy/dx→1 at
    x=range.  Returns (y, dydx).  UZF's groundwater seepage uses it."""
    s = torch.clamp(srange, min=DPREC)
    xs = torch.clamp(x / s, min=DZERO)
    y = torch.where(xs < DONE, -(xs**3) + 2.0 * xs**2, DONE)
    dydx = torch.where(xs < DONE, -3.0 * xs**2 + 4.0 * xs, DZERO)
    y = torch.where(xs <= DZERO, DZERO, y)
    dydx = torch.where(xs <= DZERO, DZERO, dydx)
    return y, dydx
