"""Structured (DIS) NPF assembly on dense (nlay, nrow, ncol) tensors.

Port of modflow6_tpu/models/gwf/npf_structured.py (reference gwf-npf.f90
npf_fc / calc_condsat): per-direction slices, no edge gathers.  Inactive
cells are handled by the ibound masks inside hcond/vcond, so a missing
edge assembles a zero coefficient.

Slot order: [E, W, N, S, U, D].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...constants import DZERO
from ...ops import conductance as condops

_ALL = slice(None)
# per-direction (n-side, m-side) index tuples
_SLICES = {
    "x": ((_ALL, _ALL, slice(None, -1)), (_ALL, _ALL, slice(1, None))),
    "y": ((_ALL, slice(None, -1), _ALL), (_ALL, slice(1, None), _ALL)),
    "z": ((slice(None, -1), _ALL, _ALL), (slice(1, None), _ALL, _ALL)),
}


def _geometry(delr, delc):
    """Per-direction (cl1, cl2, width) broadcastable tensors and cell area."""
    gx = (0.5 * delr[:-1][None, None, :], 0.5 * delr[1:][None, None, :],
          delc[None, :, None])
    gy = (0.5 * delc[:-1][None, :, None], 0.5 * delc[1:][None, :, None],
          delr[None, None, :])
    area = (delc[:, None] * delr[None, :])[None]
    return gx, gy, area


def structured_condsat(shape, delr, delc, opts, icelltype, k11, k22, k33,
                       top, bot, sat0):
    """Saturated conductances as three dense tensors (cx, cy, cz).

    cx[k,i,j] = condsat between (k,i,j) and (k,i,j+1); each is one shorter
    than the grid along its direction.  Mirrors calc_condsat
    (gwf-npf.f90:1950).
    """
    t3 = top.reshape(shape)
    b3 = bot.reshape(shape)
    s3 = sat0.reshape(shape)
    k11_3 = k11.reshape(shape)
    k22_3 = k22.reshape(shape)
    k33_3 = k33.reshape(shape)
    gx, gy, area = _geometry(delr, delc)

    def horiz(kfield, dir_key, geom):
        ns, ms = _SLICES[dir_key]
        cl1, cl2, width = geom
        thk_n = s3[ns] * (t3[ns] - b3[ns])
        thk_m = s3[ms] * (t3[ms] - b3[ms])
        return condops.condmean(kfield[ns], kfield[ms], thk_n, thk_m,
                                cl1, cl2, width, opts.icellavg)

    cx = horiz(k11_3, "x", gx)
    cy = horiz(k22_3 if opts.ik22 else k11_3, "y", gy)

    ns, ms = _SLICES["z"]
    kv_n, kv_m = k33_3[ns], k33_3[ms]
    bovk1 = s3[ns] * (t3[ns] - b3[ns]) * 0.5 / torch.where(kv_n != 0, kv_n,
                                                           1.0)
    bovk2 = s3[ms] * (t3[ms] - b3[ms]) * 0.5 / torch.where(kv_m != 0, kv_m,
                                                           1.0)
    denom = bovk1 + bovk2
    cz = torch.where(denom != DZERO,
                     area / torch.where(denom != 0, denom, 1.0), DZERO)
    return cx, cy, cz


def structured_conductance(shape, delr, delc, opts, arrays, head, ibound,
                           sat, condsat3):
    """Conductances at the current head on the three structured planes
    (cond_x, cond_y, cond_z): the body of npf_fc's connection loop, and the
    counterpart of the reference's per-edge ``npf.edge_conductance``.

    ``condsat3``: (cx, cy, cz) from structured_condsat.
    """
    t3 = arrays.top.reshape(shape)
    b3 = arrays.bot.reshape(shape)
    h3 = head.reshape(shape)
    ib3 = ibound.reshape(shape)
    s3 = sat.reshape(shape)
    ict3 = arrays.icelltype.reshape(shape)
    k11_3 = arrays.k11.reshape(shape)
    k22_3 = arrays.k22.reshape(shape)
    k33_3 = arrays.k33.reshape(shape)
    gx, gy, area = _geometry(delr, delc)
    cx0, cy0, cz0 = condsat3

    def horiz(kfield, dir_key, geom, cs):
        ns, ms = _SLICES[dir_key]
        cl1, cl2, width = geom
        return condops.hcond(
            ib3[ns], ib3[ms], ict3[ns], ict3[ms], opts.inewton,
            1, opts.icellavg, cs,
            h3[ns], h3[ms], s3[ns], s3[ms], kfield[ns], kfield[ms],
            t3[ns], t3[ms], b3[ns], b3[ms], cl1, cl2, width)

    cond_x = horiz(k11_3, "x", gx, cx0)
    cond_y = horiz(k22_3 if opts.ik22 else k11_3, "y", gy, cy0)

    ns, ms = _SLICES["z"]
    cond_z = condops.vcond(
        ib3[ns], ib3[ms], ict3[ns], ict3[ms], opts.ivarcv, opts.idewatcv,
        cz0, h3[ns], h3[ms], k33_3[ns], k33_3[ms], s3[ns], s3[ms],
        t3[ns], t3[ms], b3[ns], b3[ms], area)
    return cond_x, cond_y, cond_z


def assemble_structured(shape, delr, delc, opts, arrays, head, ibound, sat,
                        condsat3):
    """npf_fc on dense per-direction slices → (diag, off[N,6], rhs).

    ``condsat3``: (cx, cy, cz) from structured_condsat.
    """
    nlay, nrow, ncol = shape
    cond_x, cond_y, cond_z = structured_conductance(
        shape, delr, delc, opts, arrays, head, ibound, sat, condsat3)
    t3 = arrays.top.reshape(shape)
    b3 = arrays.bot.reshape(shape)
    h3 = head.reshape(shape)
    ict3 = arrays.icelltype.reshape(shape)
    ns, ms = _SLICES["z"]

    rhs3 = torch.zeros(shape, dtype=head.dtype, device=head.device)

    # perched correction (vertical only): move the term for dewatered
    # underlying cells to the rhs (gwf-npf.f90:520-545)
    if opts.iperched:
        perched = (ict3[ms] != 0) & (h3[ms] < t3[ms]) & (cond_z != DZERO)
        cz_nm = torch.where(perched, DZERO, cond_z)   # off(n,m) = D slot of n
        cz_mn = cond_z                                # off(m,n) = U slot of m
        diag_z_n = -cond_z
        diag_z_m = torch.where(perched, DZERO, -cond_z)
        rhs3[:-1] += torch.where(perched, -cond_z * b3[ns], DZERO)
        rhs3[1:] += torch.where(perched, cond_z * b3[ns], DZERO)
    else:
        cz_nm = cond_z
        cz_mn = cond_z
        diag_z_n = -cond_z
        diag_z_m = -cond_z

    # F.pad lists (before, after) pairs from the last axis backwards
    cE = F.pad(cond_x, (0, 1))
    cW = F.pad(cond_x, (1, 0))
    cS = F.pad(cond_y, (0, 0, 0, 1))
    cN = F.pad(cond_y, (0, 0, 1, 0))
    cD = F.pad(cz_nm, (0, 0, 0, 0, 0, 1))
    cU = F.pad(cz_mn, (0, 0, 0, 0, 1, 0))

    diag3 = (-(cE + cW + cS + cN) + F.pad(diag_z_n, (0, 0, 0, 0, 0, 1))
             + F.pad(diag_z_m, (0, 0, 0, 0, 1, 0)))
    off = torch.stack([cE, cW, cN, cS, cU, cD], dim=-1)

    N = nlay * nrow * ncol
    return diag3.reshape(-1), off.reshape(N, 6), rhs3.reshape(-1)
