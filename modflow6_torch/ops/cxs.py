"""N-point cross-section hydraulics (station/height tables).

Port of modflow6_tpu/ops/cxs.py (reference
src/Model/ModelUtilities/SwfCxsUtils.f90: ``get_wetted_station``,
``get_cross_section_areas``, ``get_wetted_perimeters`` and the composite
conveyance sum of ``get_composite_conveyance``):

    C(d) = Σ_seg a_seg / (rf_seg · rough) · (a_seg / p_seg)^(2/3)

so that Manning flow is Q = C(d)·√S.  SFR reaches with a cross section use
it now, the SWF/CHF CXS packages later.

All segments of all reaches are evaluated at once as dense [R, P-1]
tensors; ragged sections are padded by repeating the last station
(zero-length segments contribute nothing).  ``pack_sections`` is host
numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import DZERO

DTWOTHIRDS = 2.0 / 3.0


def segment_wetted(stations, heights, d):
    """Per-segment wetted (area, perimeter) at depth ``d``.

    stations/heights: f64[..., P]; d: f64[...] (broadcast against the
    leading dims).  Returns (area[..., P-1], perim[..., P-1]).
    """
    d = torch.as_tensor(d, dtype=stations.dtype,
                        device=stations.device)[..., None]
    x0, x1 = stations[..., :-1], stations[..., 1:]
    d0, d1 = heights[..., :-1], heights[..., 1:]
    dmin = torch.minimum(d0, d1)
    dmax = torch.maximum(d0, d1)
    dlen_full = d1 - d0
    slope = torch.where(dlen_full != 0.0, (x1 - x0)
                        / torch.where(dlen_full != 0.0, dlen_full, 1.0), 0.0)
    xt = x0 + slope * (d - d0)
    # wetted sub-segment endpoints (get_wetted_station)
    mid = (d > dmin) & (d < dmax)
    x0w = torch.where(d <= dmin, x0, torch.where(mid & (d0 > d1), xt, x0))
    x1w = torch.where(d <= dmin, x0, torch.where(mid & (d0 <= d1), xt, x1))
    xlen = x1w - x0w
    # area (get_cross_section_areas)
    a_above = torch.where(d > dmax, xlen * (d - dmax), DZERO)
    tri = torch.where(d < dmax, 0.5 * (d - dmin) * xlen,
                      0.5 * (dmax - dmin) * xlen)
    a_below = torch.where((dmax != dmin) & (d > dmin), tri, DZERO)
    area = torch.where(xlen > DZERO, a_above + a_below, DZERO)
    # perimeter (get_wetted_perimeters); vertical walls (xlen == 0) count
    dlen_wet = torch.where(d > dmax, dmax - dmin, d - dmin)
    dlen_wall = torch.where(d > dmin, torch.minimum(d, dmax) - dmin, DZERO)
    dlen = torch.where(xlen > DZERO, dlen_wet, dlen_wall)
    perim = torch.sqrt(xlen * xlen + dlen * dlen)
    return area, perim


def conveyance(stations, heights, rough_frac, rough, d, rect_mask=None):
    """Conveyance C(d).

    The composite sum over segments (get_composite_conveyance); sections
    flagged rectangular in ``rect_mask`` (4 points with two vertical
    walls, SwfCxsUtils is_rectangular) lump total area and perimeter into
    one Manning evaluation instead (get_rectangular_conveyance).

    stations/heights f64[..., P]; rough_frac f64[..., P-1] per-segment
    Manning's-n multipliers; rough f64[...] base roughness; d f64[...].
    """
    area, perim = segment_wetted(stations, heights, d)
    rough = torch.as_tensor(rough, dtype=stations.dtype,
                            device=stations.device)
    rc = rough_frac * rough[..., None]
    wet = perim > DZERO
    rh = torch.where(wet, area / torch.where(wet, perim, 1.0), DZERO)
    cn = torch.where(wet, area / rc * rh ** DTWOTHIRDS, DZERO)
    c_comp = cn.sum(dim=-1)
    if rect_mask is None:
        return c_comp
    a_tot = area.sum(dim=-1)
    p_tot = perim.sum(dim=-1)
    ravg = rough * rough_frac[..., 0]
    wet_tot = p_tot > DZERO
    c_rect = torch.where(
        wet_tot,
        a_tot / ravg * (a_tot / torch.where(wet_tot, p_tot, 1.0))
        ** DTWOTHIRDS, DZERO)
    return torch.where(torch.as_tensor(rect_mask, device=c_comp.device),
                       c_rect, c_comp)


def wetted_area(stations, heights, d):
    """Total wetted area A(d)."""
    area, _ = segment_wetted(stations, heights, d)
    return area.sum(dim=-1)


def pack_sections(sections):
    """Host: pad a list of (station, height, rough_frac) n-point sections
    to one dense table.  Returns (stations[R, P], heights[R, P],
    rough_frac[R, P-1], rect_mask[R]) numpy arrays; padding repeats the
    last station (zero-length dry segments)."""
    P = max(max(len(s[0]) for s in sections), 4)
    R = len(sections)
    st = np.zeros((R, P))
    ht = np.zeros((R, P))
    rf = np.ones((R, P - 1))
    rect = np.zeros(R, bool)
    for i, sec in enumerate(sections):
        x = np.asarray(sec[0], np.float64)
        h = np.asarray(sec[1], np.float64)
        n = x.shape[0]
        st[i, :n] = x
        st[i, n:] = x[-1]
        ht[i, :n] = h
        ht[i, n:] = h[-1]
        if len(sec) > 2 and sec[2] is not None:
            r = np.asarray(sec[2], np.float64)
            rf[i, :n - 1] = r
            rf[i, n - 1:] = r[-1]
        rect[i] = n == 4 and x[0] == x[1] and x[2] == x[3]
    return st, ht, rf, rect
