"""Build the port's GwfModel and Simulation from the reference's state.

``from_reference`` takes the arrays of a ``modflow6_tpu`` GwfModel as
numpy arrays (so this module needs no JAX) and puts them on a device.  The
parity tests build one model both ways: through the reference's
``build_gwf`` and this function, and through this package's
``build_gwf`` from the same arguments.  ``simulation_from_reference`` does
the same for what the reference's deck loader produced, so that loader
and solver can be compared separately: (reference loader → convert →
port's run), (port's loader → port's run) and (reference's run) must
agree.  ``device=None`` is the CUDA device.

Keys of ``arrays``:

- ``k11``, ``k22``, ``k33``, ``icelltype``, ``top``, ``bot``, ``strt``,
  ``ibound0``: per cell;
- a model on the structured path (``grid_shape`` given, no angle option):
  ``delr`` (ncol), ``delc`` (nrow), and ``condsat_x``, ``condsat_y``,
  ``condsat_z``, the reference's structured saturated conductances
  (``GwfModel.condsat3``);
- a model on the general path: the edge topology ``edge_n``, ``edge_m``,
  ``ihc``, ``cl1``, ``cl2``, ``hwva``, ``anglex``, ``nbr``, ``slot_nm``,
  ``slot_mn`` (``grid_shape`` stays the DIS shape of a DIS grid with
  angles), ``condsat`` per edge, ``angle1``, ``angle2``, ``angle3`` and
  ``area`` per cell;
- optional ``sto_iconvert``, ``sto_ss``, ``sto_sy`` (with ``sto_options``);
- optional packages: ``{pkg}_{field}`` for every field of the package's
  data class (``chd_node``, ``chd_head``, ``chd_mask``; ``drn_elev``,
  ``drn_cond``, ``drn_ddrn``; ``evt_pxdp``, ``evt_petm`` when segmented;
  ...);
- optional ``wetdry``: the REWET thresholds per cell;
- with XT3D (``model_options["ixt3d"]``): ``xt3d_{field}`` for every field
  of the reference's ``Xt3dData`` (a model with XT3D is on the general
  path, with its edge topology; its condsat is unused);
- with GNC: ``gnc_{field}`` for every field of the reference's ``GncData``;
- with CSUB: ``csub_{field}`` for the fields of the reference's
  ``CsubData``, ``csub_delay_{field}`` for its ``DelayData``, and
  ``csub_state_{field}`` / ``csub_delay_state_{field}`` for the initial
  ``CsubState`` and ``DelayState``.

``npf_options`` and ``sto_options`` hold the fields of the reference's
``NpfOptions`` and ``StoOptions`` (``inewton`` and ``satomega`` among
them); ``model_options`` the reference GwfModel's ``inewton``,
``inewtonur``, ``wel_iflowred``, ``wel_flowred``, ``rewet_opts``,
``hfb`` (whose barriers the given condsat already holds), ``ixt3d``,
``buy`` and ``vsc`` (the keyword arguments of ``make_buy`` and
``make_vsc``) and ``csub`` (``head_based``, ``nlay``, ``ncpl`` and the
delay beds' ``ncells``).  The preconditioner settings travel in
``state["settings"]`` (the fields of ``ImsSettings``).
"""

from __future__ import annotations

import dataclasses

import torch

from . import resolve_device
from .models.discretization import DisGrid, DisuGrid, DisvGrid
from .models.gwf import bnd, csub as csub_mod, gnc as gnc_mod, npf, sto
from .models.gwf import xt3d as xt3d_mod
from .models.gwf.buy import make_buy
from .models.gwf.vsc import make_vsc
from .models.gwf.model import GwfModel, PackageData
from .models.simulation import Simulation
from .solution.ims import ImsSettings
from .timing.tdis import StressPeriod, Tdis
from .utils.oc import OutputControl

_BOUNDS = dict(chd=bnd.ChdData, wel=bnd.WelData, rch=bnd.RchData,
               drn=bnd.DrnData, riv=bnd.RivData, ghb=bnd.GhbData,
               evt=bnd.EvtData)
_GRIDS = dict(dis=DisGrid, disv=DisvGrid, disu=DisuGrid)
_TOPOLOGY = ("edge_n", "edge_m", "ihc", "cl1", "cl2", "hwva", "anglex", "nbr",
             "slot_nm", "slot_mn")


def _package(cls, values: dict, device):
    """A package data object from {field: array}: ``node`` int64, ``mask``
    bool, every other field float64."""
    dtypes = dict(node=torch.int64, mask=torch.bool)
    return cls(**{
        key: torch.tensor(value, dtype=dtypes.get(key, torch.float64),
                          device=device)
        for key, value in values.items() if value is not None})


def from_reference(arrays: dict, *, grid_shape, npf_options: dict,
                   sto_options: dict = None, model_options: dict = None,
                   device=None, name: str = "converted",
                   grid=None) -> GwfModel:
    device = resolve_device(device)

    def tensor(key, dtype):
        return torch.tensor(arrays[key], dtype=dtype, device=device)

    def f64(key):
        return tensor(key, torch.float64)

    def i32(key):
        return tensor(key, torch.int32)

    top, bot = f64("top"), f64("bot")
    general = "nbr" in arrays
    if general:
        dtopo = npf.DeviceTopology.from_host(
            {**{key: arrays[key] for key in _TOPOLOGY},
             "grid_shape": grid_shape}, device)
        delr = delc = condsat3 = None
        area = f64("area")
        extra = dict(angle1=f64("angle1"), angle2=f64("angle2"),
                     angle3=f64("angle3"), condsat=f64("condsat"))
    else:
        dtopo = npf.DeviceTopology(grid_shape=tuple(grid_shape))
        delr, delc = f64("delr"), f64("delc")
        area = (delc[:, None] * delr[None, :]).reshape(-1).repeat(
            grid_shape[0])
        condsat3 = (f64("condsat_x"), f64("condsat_y"), f64("condsat_z"))
        extra = {}
    npf_arrays = npf.NpfArrays(icelltype=i32("icelltype"), k11=f64("k11"),
                               k22=f64("k22"), k33=f64("k33"), top=top,
                               bot=bot, **extra)
    sto_opts = sto_arrays = None
    if sto_options is not None:
        sto_opts = sto.StoOptions(**sto_options)
        sto_arrays = sto.StoArrays(iconvert=i32("sto_iconvert"),
                                   ss=f64("sto_ss"), sy=f64("sto_sy"),
                                   top=top, bot=bot, area=area)
    packages = {}
    for pkg, cls in _BOUNDS.items():
        if f"{pkg}_node" in arrays:
            packages[pkg] = _package(
                cls, {f.name: arrays.get(f"{pkg}_{f.name}")
                      for f in dataclasses.fields(cls)}, device)
    topo = None
    if grid is not None:
        # the same host layout as build_gwf gives the model
        topo = (grid.build_edge_topology()
                if general and isinstance(grid, DisGrid)
                else grid.build_topology())
    options = dict(model_options or {})
    extra = {}
    if options.get("buy") is not None:
        extra["buy"] = make_buy(**options.pop("buy"))
    if options.get("vsc") is not None:
        extra["vsc"] = make_vsc(**options.pop("vsc"))
    if options.get("csub") is not None:
        extra["csub"], extra["csub_state0"] = _csub(
            arrays, options.pop("csub"), device)
    if "gnc_n" in arrays:
        extra["gnc"] = gnc_mod.from_arrays(
            _prefixed(arrays, "gnc_"), len(arrays["strt"]),
            len(arrays["edge_n"]), device)
    ixt3d = int(options.get("ixt3d", 0))
    if ixt3d:
        extra["xt3d"] = xt3d_mod.from_arrays(_prefixed(arrays, "xt3d_"),
                                             ixt3d, device)
        dtopo = dataclasses.replace(dtopo, grid_shape=None)
        if ixt3d == 1:
            extra["system_dtopo"] = dataclasses.replace(
                dtopo, nbr=extra["xt3d"].nbr_ext)
    for key in ("buy", "vsc", "csub"):
        options.pop(key, None)
    return GwfModel(
        name=name, dtopo=dtopo, npf_opts=npf.NpfOptions(**npf_options),
        npf_arrays=npf_arrays, strt=f64("strt"), ibound0=i32("ibound0"),
        delr=delr, delc=delc, area=area, sto_opts=sto_opts,
        sto_arrays=sto_arrays, condsat3=condsat3, grid=grid, topo=topo,
        wetdry=f64("wetdry") if "wetdry" in arrays else None,
        **options, **extra, **packages)


def _prefixed(arrays: dict, prefix: str) -> dict:
    return {key[len(prefix):]: value for key, value in arrays.items()
            if key.startswith(prefix)}


def _csub(arrays, meta, device):
    """(CsubData, CsubState) from the ``csub_*`` arrays."""
    state = _prefixed(arrays, "csub_state_")
    db = _prefixed(arrays, "csub_delay_state_")
    delay = {key: value for key, value in
             _prefixed(arrays, "csub_delay_").items()
             if not key.startswith("state_")}
    data = {key: value for key, value in _prefixed(arrays, "csub_").items()
            if not key.startswith(("state_", "delay_"))}
    if db:
        state["db"] = db
    if delay:
        data["delay"] = delay
    return csub_mod.from_arrays(data, state, device=device, **meta)


def simulation_from_reference(state: dict, *, device=None, hds_path=None,
                              cbc_path=None, lst_path=None) -> Simulation:
    """The port's Simulation from a reference Simulation's state as numpy.

    Keys of ``state``:

    - ``name``; ``grid``: the keyword arguments of the grid class's
      ``create``; ``grid_class``: "dis" (the default), "disv" or "disu";
    - ``arrays``, ``npf_options``, ``sto_options``, ``model_options``: as
      ``from_reference`` takes them (``arrays`` holds the first period's packages);
    - ``tdis``: [(perlen, nstp, tsmult)]; ``transient``: one flag per period;
    - ``settings``: the fields of the reference's ``ImsSettings``;
    - ``period_data``: {kper: {package: the arrays of its data class's
      fields, in their order ((node, value, mask) for chd, wel and rch)}};
    - ``oc``: {kper: {(verb, what): spec}} or None; ``fail_fast``;
    - optional ``tvk``, ``tvs``: {kper: [(node, PROP, value)]}.
    """
    device = resolve_device(device)
    grid = _GRIDS[state.get("grid_class", "dis")].create(**state["grid"])
    model = from_reference(
        state["arrays"], grid_shape=getattr(grid, "grid_shape", None),
        npf_options=state["npf_options"], sto_options=state["sto_options"],
        model_options=state.get("model_options"), device=device, name=state["name"], grid=grid)
    tdis = Tdis(tuple(StressPeriod(float(p), int(n), float(m))
                      for p, n, m in state["tdis"]))
    oc = None if state["oc"] is None else OutputControl(state["oc"])
    sim = Simulation(tdis, model, ImsSettings(**state["settings"]),
                     transient=list(state["transient"]), hds_path=hds_path,
                     cbc_path=cbc_path, lst_path=lst_path, oc=oc)
    sim.fail_fast = bool(state["fail_fast"])
    sim.tvk = dict(state.get("tvk") or {})
    sim.tvs = dict(state.get("tvs") or {})
    for kper, pkgs in state["period_data"].items():
        sim.period_data[int(kper)] = PackageData(**{
            pkg: _package(_BOUNDS[pkg], dict(zip(
                (f.name for f in dataclasses.fields(_BOUNDS[pkg])), values)),
                device)
            for pkg, values in pkgs.items()})
    return sim
