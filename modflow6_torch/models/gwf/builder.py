"""Convenience builder: construct a GwfModel from plain arrays.

Port of modflow6_tpu/models/gwf/builder.py:93 ``build_gwf`` with the same
keyword arguments plus ``device``, and of the ``chd_data``/``wel_data``/
``rch_data`` makers (builder.py:23-52) that pad a stress period's entries
to a static ``maxbound``.  ``device=None`` is the CUDA device
(``modflow6_torch.cuda_device()``, which raises without one); the CPU is
used only when asked for.  ``newton`` is False, True or
"under_relaxation"; ``rewetting`` is dict(wetdry=f64[N], wetfct, iwetit,
ihdwet), the NPF REWET option; ``wel_auto_flow_reduce`` the WEL
AUTO_FLOW_REDUCE fraction.  Arguments that would turn on a feature outside
the structured slice raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import resolve_device
from . import bnd, npf, sto
from .model import GwfModel


def _is_off(value) -> bool:
    """None, False or 0: the value that leaves an optional feature off."""
    return value is None or (isinstance(value, (bool, int)) and not value)


def _full(val, n, dtype, device, np_dtype=np.float64):
    arr = np.broadcast_to(np.asarray(val, np_dtype), (n,))
    return torch.as_tensor(arr.copy(), dtype=dtype, device=device)


def _pack_bound(entries, device, maxbound=None):
    """(node, value) boundary entries → (node i64, value f64, mask) tensors,
    padded to ``maxbound`` rows (at least one) with ``mask=False``."""
    arr = np.asarray(entries, np.float64).reshape(-1, 2)
    b = arr.shape[0]
    mb = maxbound or max(b, 1)
    node = np.zeros(mb, np.int64)
    value = np.zeros(mb, np.float64)
    mask = np.zeros(mb, bool)
    node[:b] = arr[:, 0].astype(np.int64)
    value[:b] = arr[:, 1]
    mask[:b] = True
    return (torch.as_tensor(node, dtype=torch.int64, device=device),
            torch.as_tensor(value, dtype=torch.float64, device=device),
            torch.as_tensor(mask, dtype=torch.bool, device=device))


def chd_data(entries, maxbound=None, device=None):
    return bnd.ChdData(*_pack_bound(entries, resolve_device(device),
                                    maxbound))


def wel_data(entries, maxbound=None, device=None):
    return bnd.WelData(*_pack_bound(entries, resolve_device(device),
                                    maxbound))


def rch_data(entries, maxbound=None, device=None):
    return bnd.RchData(*_pack_bound(entries, resolve_device(device),
                                    maxbound))


def build_gwf(
    name,
    grid,
    *,
    icelltype=0,
    k=1.0,
    k22=None,
    k33=None,
    strt=0.0,
    newton=False,
    icellavg=0,
    ivarcv=0,
    idewatcv=0,
    iperched=0,
    thickstrt=False,
    storage=None,       # dict(ss=..., sy=..., iconvert=..., istor_coef=0)
    chd=None,           # list of (node, head)
    wel=None,           # list of (node, q)
    rch=None,           # list of (node, recharge)
    drn=None,
    riv=None,
    ghb=None,
    evt=None,
    wel_auto_flow_reduce=None,
    buy=None,
    csub=None,
    vsc=None,
    hfb=None,
    xt3d=0,
    angle1=0.0,
    angle2=0.0,
    angle3=0.0,
    rewetting=None,
    device=None,
) -> GwfModel:
    given = dict(drn=drn, riv=riv, ghb=ghb, evt=evt, buy=buy, csub=csub,
                 vsc=vsc, hfb=hfb, xt3d=xt3d)
    for key, value in given.items():
        if not _is_off(value):
            raise NotImplementedError(f"build_gwf({key}=...) is not ported")
    if any(np.any(np.asarray(a) != 0.0) for a in (angle1, angle2, angle3)):
        raise NotImplementedError("rotated anisotropy is not ported")

    device = resolve_device(device)
    f64 = torch.float64
    shape = grid.grid_shape
    N = grid.nodes

    ibound0 = torch.as_tensor((grid.idomain.reshape(-1) > 0).astype(np.int32),
                              dtype=torch.int32, device=device)
    # newton: False | True | "under_relaxation"
    newton_ur = (isinstance(newton, str)
                 and newton.lower() == "under_relaxation")
    newton = bool(newton)
    satomega = 1e-6 if newton else 0.0
    k11 = _full(k, N, f64, device)
    top = torch.as_tensor(grid.top, dtype=f64, device=device)
    bot = torch.as_tensor(grid.bot, dtype=f64, device=device)
    area = torch.as_tensor(grid.area, dtype=f64, device=device)
    opts = npf.NpfOptions(
        icellavg=icellavg, inewton=int(newton), ivarcv=ivarcv,
        idewatcv=idewatcv, iperched=iperched, ik22=k22 is not None,
        ik33=k33 is not None, thickstrt=thickstrt, satomega=satomega)
    arrays = npf.NpfArrays(
        icelltype=_full(icelltype, N, torch.int32, device, np.int32),
        k11=k11,
        k22=_full(k22, N, f64, device) if k22 is not None else k11,
        k33=_full(k33, N, f64, device) if k33 is not None else k11,
        top=top, bot=bot)

    sto_opts = sto_arrays = None
    if storage is not None:
        sto_opts = sto.StoOptions(
            istor_coef=int(storage.get("istor_coef", 0)),
            iconf_ss=int(storage.get("iconf_ss", 0)),
            inewton=int(newton), satomega=satomega)
        sto_arrays = sto.StoArrays(
            iconvert=_full(storage.get("iconvert", 0), N, torch.int32,
                           device, np.int32),
            ss=_full(storage.get("ss", 0.0), N, f64, device),
            sy=_full(storage.get("sy", 0.0), N, f64, device),
            top=top, bot=bot, area=area)

    model = GwfModel(
        name=name, grid=grid, dtopo=npf.DeviceTopology(shape),
        npf_opts=opts, npf_arrays=arrays,
        strt=_full(strt, N, f64, device), ibound0=ibound0,
        delr=torch.as_tensor(grid.delr, dtype=f64, device=device),
        delc=torch.as_tensor(grid.delc, dtype=f64, device=device),
        area=area, sto_opts=sto_opts, sto_arrays=sto_arrays,
        chd=bnd.ChdData(*_pack_bound(chd, device)) if chd else None,
        wel=bnd.WelData(*_pack_bound(wel, device)) if wel else None,
        rch=bnd.RchData(*_pack_bound(rch, device)) if rch else None,
        inewton=int(newton), inewtonur=int(newton_ur),
        wel_iflowred=int(wel_auto_flow_reduce is not None),
        wel_flowred=float(wel_auto_flow_reduce or 0.0),
        wetdry=None if rewetting is None else _full(rewetting["wetdry"], N,
                                                    f64, device),
        rewet_opts=(1.0, 1, 0) if rewetting is None else (
            float(rewetting.get("wetfct", 1.0)),
            int(rewetting.get("iwetit", 1)),
            int(rewetting.get("ihdwet", 0))))
    model.finalize_setup()
    return model
