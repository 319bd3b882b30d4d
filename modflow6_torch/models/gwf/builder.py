"""Convenience builder: construct a GwfModel from plain arrays.

Port of modflow6_tpu/models/gwf/builder.py:93 ``build_gwf`` with the same
keyword arguments plus ``device``, for a DisGrid, DisvGrid or DisuGrid,
and of the ``chd_data`` ... ``evt_data`` makers (builder.py:23-90) that pad
a stress period's entries to a static ``maxbound``.  ``device=None`` is the CUDA device
(``modflow6_torch.cuda_device()``, which raises without one); the CPU is
used only when asked for.  ``newton`` is False, True or
"under_relaxation"; ``rewetting`` is dict(wetdry=f64[N], wetfct, iwetit,
ihdwet), the NPF REWET option; ``wel_auto_flow_reduce`` the WEL
AUTO_FLOW_REDUCE fraction; ``hfb`` a list of (n, m, hydchr) barriers;
``angle1/2/3`` the rotated-anisotropy angles, passed on as the reference
passes them (radians in the two-point ``_hyeff``, degrees in XT3D's
tensors); ``xt3d`` 0, 1 (full matrix) or 2 (RHS mode); ``buy`` the keyword
arguments of ``buy.make_buy``, ``vsc`` those of ``vsc.make_vsc``, ``csub``
those of ``csub.make_csub`` (the initial state goes to
``model.csub_state0``).  A DIS grid without angles, XT3D or VSC takes the
structured path and gets no edge tables on the device; every other model
gets the full ``DeviceTopology``.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import resolve_device
from . import bnd, npf, sto
from .buy import make_buy
from .csub import make_csub
from .model import GwfModel
from .vsc import make_vsc


def _full(val, n, dtype, device, np_dtype=np.float64):
    arr = np.broadcast_to(np.asarray(val, np_dtype), (n,))
    return torch.as_tensor(arr.copy(), dtype=dtype, device=device)


def _pack_bound(entries, device, maxbound=None, nvalues=1):
    """(node, value, ...) boundary entries → (node i64, one f64 tensor per
    value column, mask) tensors, padded to ``maxbound`` rows (at least one)
    with ``mask=False``."""
    arr = np.asarray(entries, np.float64).reshape(-1, 1 + nvalues)
    b = arr.shape[0]
    mb = maxbound or max(b, 1)
    node = np.zeros(mb, np.int64)
    values = np.zeros((nvalues, mb), np.float64)
    mask = np.zeros(mb, bool)
    node[:b] = arr[:, 0].astype(np.int64)
    values[:, :b] = arr[:, 1:].T
    mask[:b] = True
    return (torch.as_tensor(node, dtype=torch.int64, device=device),
            *(torch.as_tensor(v.copy(), dtype=torch.float64, device=device)
              for v in values),
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


def drn_data(entries, maxbound=None, device=None):
    """entries: (node, elev, cond) or (node, elev, cond, ddrn)."""
    entries = [tuple(e) if len(e) == 4 else (*e, 0.0) for e in entries]
    return bnd.DrnData(*_pack_bound(entries, resolve_device(device),
                                    maxbound, nvalues=3))


def riv_data(entries, maxbound=None, device=None):
    """entries: (node, stage, cond, rbot)."""
    return bnd.RivData(*_pack_bound(entries, resolve_device(device),
                                    maxbound, nvalues=3))


def ghb_data(entries, maxbound=None, device=None):
    """entries: (node, bhead, cond)."""
    return bnd.GhbData(*_pack_bound(entries, resolve_device(device),
                                    maxbound, nvalues=2))


def evt_data(entries, maxbound=None, device=None):
    """entries: (node, surface, rate, depth[, pxdp*(nseg-1),
    petm*(nseg-1)])."""
    device = resolve_device(device)
    nextra = max((len(e) - 4 for e in entries), default=0)
    node, surface, rate, depth, mask = _pack_bound(
        [e[:4] for e in entries], device, maxbound, nvalues=3)
    pxdp = petm = None
    if nextra > 0:
        if nextra % 2:
            raise ValueError("segmented EVT needs pxdp+petm pairs")
        ns1 = nextra // 2
        seg = np.zeros((mask.shape[0], 2 * ns1))
        seg[:len(entries)] = np.asarray([e[4:4 + 2 * ns1] for e in entries],
                                        np.float64)
        pxdp = torch.as_tensor(seg[:, :ns1].copy(), dtype=torch.float64,
                               device=device)
        petm = torch.as_tensor(seg[:, ns1:].copy(), dtype=torch.float64,
                               device=device)
    return bnd.EvtData(node, surface, rate, depth, mask, pxdp, petm)


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
    device = resolve_device(device)
    f64 = torch.float64
    N = grid.nodes
    iangle = [int(np.any(np.asarray(a) != 0.0))
              for a in (angle1, angle2, angle3)]
    shape = getattr(grid, "grid_shape", None)
    if shape is not None and not (any(iangle) or xt3d or vsc is not None):
        # the structured path: the grid shape alone, no edge tables
        topo = grid.build_topology()
        dtopo = npf.DeviceTopology(grid_shape=shape)
    else:
        topo = (grid.build_edge_topology() if shape is not None
                else grid.build_topology())
        dtopo = npf.DeviceTopology.from_host(topo, device)

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
        ik33=k33 is not None, thickstrt=thickstrt, satomega=satomega,
        iangle1=iangle[0], iangle2=iangle[1], iangle3=iangle[2])
    general = dtopo.nbr is not None
    arrays = npf.NpfArrays(
        icelltype=_full(icelltype, N, torch.int32, device, np.int32),
        k11=k11,
        k22=_full(k22, N, f64, device) if k22 is not None else k11,
        k33=_full(k33, N, f64, device) if k33 is not None else k11,
        top=top, bot=bot,
        angle1=_full(angle1, N, f64, device) if general else None,
        angle2=_full(angle2, N, f64, device) if general else None,
        angle3=_full(angle3, N, f64, device) if general else None)

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

    structured = shape is not None and not general
    model = GwfModel(
        name=name, grid=grid, topo=topo, dtopo=dtopo,
        npf_opts=opts, npf_arrays=arrays,
        strt=_full(strt, N, f64, device), ibound0=ibound0,
        delr=torch.as_tensor(grid.delr, dtype=f64, device=device)
        if structured else None,
        delc=torch.as_tensor(grid.delc, dtype=f64, device=device)
        if structured else None,
        area=area, sto_opts=sto_opts, sto_arrays=sto_arrays,
        buy=None if buy is None else make_buy(**buy),
        vsc=None if vsc is None else make_vsc(**vsc), ixt3d=int(xt3d),
        chd=chd_data(chd, device=device) if chd else None,
        wel=wel_data(wel, device=device) if wel else None,
        rch=rch_data(rch, device=device) if rch else None,
        drn=drn_data(drn, device=device) if drn else None,
        riv=riv_data(riv, device=device) if riv else None,
        ghb=ghb_data(ghb, device=device) if ghb else None,
        evt=evt_data(evt, device=device) if evt else None,
        hfb=hfb,
        inewton=int(newton), inewtonur=int(newton_ur),
        wel_iflowred=int(wel_auto_flow_reduce is not None),
        wel_flowred=float(wel_auto_flow_reduce or 0.0),
        wetdry=None if rewetting is None else _full(rewetting["wetdry"], N,
                                                    f64, device),
        rewet_opts=(1.0, 1, 0) if rewetting is None else (
            float(rewetting.get("wetfct", 1.0)),
            int(rewetting.get("iwetit", 1)),
            int(rewetting.get("ihdwet", 0))))
    if csub is not None:
        model.csub, model.csub_state0 = make_csub(
            grid, strt=model.strt, device=device, **csub)
    model.finalize_setup()
    return model
