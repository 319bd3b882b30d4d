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
  ``CsubState`` and ``DelayState``;
- with MAW, LAK or SFR rows: ``maw_{field}``, ``lak_{field}``,
  ``sfr_{field}`` for the fields of ``FEATURE_FIELDS`` (the reference's
  ``MawData``, ``LakData`` and ``SfrData``, ``augmented_state`` lists them
  for either package's model), and with movers ``mvr_{field}`` for the
  fields of the reference's ``MvrData``; ``from_reference`` then returns
  an ``AugmentedGwfModel`` on the base model, and raises where the slots
  it builds differ from the given ones;
- a merged model (several models joined by GWF6-GWF6 exchanges) is a
  model on the general path whose topology holds the exchange pairs as
  edges: its ``offsets`` (the first node of each member) make its grid a
  ``MergedGrid`` with the merged topology, for ``split_heads`` and the
  output files.

``gwt_from_reference`` does the same for a reference ``GwtModel``, and
``simulation_from_reference`` converts a simulation's transport model too
(its ``gwt`` entry).  Keys of its ``arrays``: ``strt``, ``ibound0``,
``top``, ``bot``, ``area`` per cell; the edge topology (the keys above,
the DIS grid's fixed slots among them); ``mst_{field}`` for the fields of
the reference's ``MstArrays``; optional ``dsp_{field}`` (``DspData``'s
arrays), ``ist_{field}`` (``IstData``'s) with ``cim``, and ``cnc_node``,
``cnc_conc``, ``cnc_mask``, ``src_node``, ``src_q``, ``src_mask``.  Its
``options``: ``iadvwt``, ``eqnsclfac``, ``idcy``, ``isrb``, ``ssm_spec``
(package name → concentration) and, with DSP or IST, ``dsp`` ({idisp,
idiffc}) and ``ist`` ({idcy, isrb}).  ``gwe_from_reference`` does the same
for a reference GweModel: the same cell and topology keys, ``est_{field}``
for the fields of ``EstArrays``, optional ``cnd_{field}`` (``CndData``'s
arrays) and ``ctp_node``, ``ctp_conc``, ``ctp_mask``, ``esl_node``,
``esl_q``, ``esl_mask``; its ``options``: ``iadvwt``, ``ssm_spec``, ``est``
(the fields of ``EstOptions``) and, with CND, ``cnd`` ({idisp, iktw,
ikts}).

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

import numpy as np
import torch

from . import resolve_device
from .models.discretization import DisGrid, DisuGrid, DisvGrid
from .models.gwf import bnd, csub as csub_mod, gnc as gnc_mod, npf, sto
from .models.gwf import xt3d as xt3d_mod
from .models.discretization.topology import Topology
from .models.gwf.advanced import AugmentedGwfModel
from .models.gwf.exchange import MergedGrid
from .models.gwf.uzf import COLUMN_FIELDS, make_uzf
from .models.gwf.buy import make_buy
from .models.gwf.vsc import make_vsc
from .models.gwf.model import GwfModel, PackageData
from .models.gwt import dsp as dsp_mod, ist as ist_mod, mst as mst_mod
from .models.gwt.apt import AugmentedGwtModel
from .models.gwt.model import CncData, GwtModel, SrcData
from .models.gwe import cnd as cnd_mod, est as est_mod
from .models.gwe.model import GweModel
from .models.simulation import Simulation
from .solution.ims import ImsSettings
from .timing.tdis import StressPeriod, Tdis
from .utils.oc import OutputControl

_BOUNDS = dict(chd=bnd.ChdData, wel=bnd.WelData, rch=bnd.RchData,
               drn=bnd.DrnData, riv=bnd.RivData, ghb=bnd.GhbData,
               evt=bnd.EvtData)
_GRIDS = dict(dis=DisGrid, disv=DisvGrid, disu=DisuGrid)
# the fields of the reference's MawData, LakData and SfrData; the ones of
# _DERIVED the augmented model builds itself
FEATURE_FIELDS = {
    "maw": ("conn_well", "conn_node", "cond", "area", "bottom", "rate",
            "strt", "slot_cw", "slot_wc", "active", "head_limit", "pumpelev",
            "reduction_length", "fw_elev", "fw_cond", "fw_rlen", "shut_min",
            "shut_max", "shut", "nwells", "storage"),
    "lak": ("conn_lake", "conn_node", "cond", "belev", "surf_area", "bottom",
            "strt", "rainfall", "evap", "withdrawal", "out_invert",
            "out_width", "out_rough", "out_slope", "out_rate", "slot_cl",
            "slot_lc", "active", "tab_stage", "tab_volume", "tab_sarea",
            "conn_telev", "conn_ihc", "conn_conv", "nlakes", "noutlets",
            "out_type", "out_lake", "out_to", "convfact", "out_slot"),
    "sfr": ("cond", "strtop", "width", "rough", "slope", "length",
            "upstream", "frac", "inflow", "rainfall", "evap", "runoff",
            "node", "strt", "slot_cr", "slot_rc", "active", "divflow",
            "xs_station", "xs_height", "xs_rf", "xs_rect", "up_pair_r",
            "up_pair_u", "up_pair_f", "up_pair_slot", "nreaches", "div_src",
            "div_to", "div_rule"),
    "mvr": ("value", "prov_pkg", "prov_id", "recv_pkg", "recv_id",
            "mvrtype"),
}
_DERIVED = ("slot_cw", "slot_wc", "slot_cl", "slot_lc", "slot_cr", "slot_rc",
            "active", "out_slot", "up_pair_r", "up_pair_u", "up_pair_f",
            "up_pair_slot")
# the reference pads a lake package without outlets to one dummy outlet
_OUTLET_FIELDS = ("out_invert", "out_width", "out_rough", "out_slope",
                  "out_rate", "out_lake", "out_to")
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
    model = GwfModel(
        name=name, dtopo=dtopo, npf_opts=npf.NpfOptions(**npf_options),
        npf_arrays=npf_arrays, strt=f64("strt"), ibound0=i32("ibound0"),
        delr=delr, delc=delc, area=area, sto_opts=sto_opts,
        sto_arrays=sto_arrays, condsat3=condsat3, grid=grid, topo=topo,
        wetdry=f64("wetdry") if "wetdry" in arrays else None,
        **options, **extra, **packages)
    if "offsets" in arrays:
        model.topo = Topology(**{key: arrays[key] for key in (
            "edge_n", "edge_m", "ihc", "cl1", "cl2", "hwva", "anglex")},
            nodes=len(arrays["strt"]),
            direction=np.full(len(arrays["edge_n"]), -1, np.int32))
        model.grid = MergedGrid(
            nodes=len(arrays["strt"]), area=np.asarray(arrays["area"]),
            top=np.asarray(arrays["top"]), bot=np.asarray(arrays["bot"]),
            idomain=np.asarray(arrays["ibound0"]),
            shape=(len(arrays["strt"]),),
            offsets=np.asarray(arrays["offsets"]))
    specs = {pkg: _prefixed(arrays, pkg + "_") for pkg in FEATURE_FIELDS
             if any(key.startswith(pkg + "_") for key in arrays)}
    return _augmented(model, specs) if specs else model


def gwt_from_reference(arrays: dict, *, options: dict, device=None,
                       name: str = "converted", grid=None) -> GwtModel:
    """The port's GwtModel from a reference GwtModel's arrays (see the
    module docstring); ``grid``, when given, is the host grid of the
    output files and of the host topology."""
    device = resolve_device(device)

    def f64(value):
        return torch.tensor(np.asarray(value), dtype=torch.float64,
                            device=device)

    dtopo = dataclasses.replace(npf.DeviceTopology.from_host(
        {key: arrays[key] for key in _TOPOLOGY}, device), grid_shape=None)
    mst = mst_mod.MstArrays(**{key: f64(value) for key, value in
                               _prefixed(arrays, "mst_").items()})
    extra = {}
    if options.get("dsp") is not None:
        extra["dsp"] = dsp_mod.DspData(
            **{key: f64(value) for key, value in
               _prefixed(arrays, "dsp_").items()}, **options["dsp"])
    if options.get("ist") is not None:
        extra["ist"] = ist_mod.IstData(
            **{key: f64(value) for key, value in
               _prefixed(arrays, "ist_").items()}, **options["ist"])
        extra["cim"] = f64(arrays["cim"])
    for pkg, cls in (("cnc", CncData), ("src", SrcData)):
        if f"{pkg}_node" in arrays:
            extra[pkg] = _package(cls, _prefixed(arrays, pkg + "_"), device)
    topo = None
    if grid is not None:
        topo = (grid.build_edge_topology() if isinstance(grid, DisGrid)
                else grid.build_topology())
    return GwtModel(
        name=name, grid=grid, topo=topo, dtopo=dtopo, strt=f64(arrays["strt"]),
        ibound0=torch.tensor(np.asarray(arrays["ibound0"]),
                             dtype=torch.int32, device=device),
        mst_opts=mst_mod.MstOptions(idcy=int(options["idcy"]),
                                    isrb=int(options["isrb"])),
        mst_arrays=mst, iadvwt=int(options["iadvwt"]),
        eqnsclfac=float(options.get("eqnsclfac", 1.0)),
        ssm_spec=options.get("ssm_spec"), top=f64(arrays["top"]),
        bot=f64(arrays["bot"]), area=f64(arrays["area"]), **extra)


def gwe_from_reference(arrays: dict, *, options: dict, device=None,
                       name: str = "converted", grid=None) -> GweModel:
    """The port's GweModel from a reference GweModel's arrays (see the
    module docstring); ``grid``, when given, is the host grid of the
    output files and of the host topology."""
    device = resolve_device(device)

    def f64(value):
        return torch.tensor(np.asarray(value), dtype=torch.float64,
                            device=device)

    dtopo = dataclasses.replace(npf.DeviceTopology.from_host(
        {key: arrays[key] for key in _TOPOLOGY}, device), grid_shape=None)
    extra = {}
    if options.get("cnd") is not None:
        extra["cnd"] = cnd_mod.CndData(
            **{key: f64(value) for key, value in
               _prefixed(arrays, "cnd_").items()}, **options["cnd"])
    for pkg, cls in (("ctp", CncData), ("esl", SrcData)):
        if f"{pkg}_node" in arrays:
            extra[pkg] = _package(cls, _prefixed(arrays, pkg + "_"), device)
    topo = None
    if grid is not None:
        topo = (grid.build_edge_topology() if isinstance(grid, DisGrid)
                else grid.build_topology())
    return GweModel(
        name=name, grid=grid, topo=topo, dtopo=dtopo, strt=f64(arrays["strt"]),
        ibound0=torch.tensor(np.asarray(arrays["ibound0"]),
                             dtype=torch.int32, device=device),
        est_opts=est_mod.EstOptions(**options["est"]),
        est_arrays=est_mod.EstArrays(**{
            key: f64(value) for key, value in
            _prefixed(arrays, "est_").items()}),
        iadvwt=int(options["iadvwt"]), ssm_spec=options.get("ssm_spec"),
        top=f64(arrays["top"]), bot=f64(arrays["bot"]),
        area=f64(arrays["area"]), **extra)


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return value if isinstance(value, (tuple, int, float, bool, str)) \
        else np.asarray(value)


def augmented_state(model) -> dict:
    """``{pkg_field: value}`` of the MAW, LAK and SFR data of either
    package's augmented model (numpy arrays, tuples and numbers), outlet
    fields cut to the lake package's outlets."""
    out = {}
    for pkg, fields in FEATURE_FIELDS.items():
        data = getattr(model, pkg, None)
        if data is None:
            continue
        for field in fields:
            value = getattr(data, field)
            if value is None:
                continue
            value = _host(value)
            if field in _OUTLET_FIELDS:
                value = value[:len(data.out_type)]
            out[f"{pkg}_{field}"] = value
    return out


# host values of the data classes that are not arrays
_META = dict(out_type=tuple, out_lake=tuple, out_to=tuple, div_src=tuple,
             div_to=tuple, div_rule=tuple, nwells=int, nlakes=int,
             noutlets=int, nreaches=int, storage=bool, convfact=float,
             prov_pkg=tuple, prov_id=tuple, recv_pkg=tuple, recv_id=tuple,
             mvrtype=tuple)


def _meta(key, value):
    if key not in _META:
        return value
    kind = _META[key]
    return kind(np.asarray(value).tolist()) if kind is tuple \
        else kind(np.asarray(value))


def _movers(spec):
    """The ``build_mvr`` movers of ``mvr_`` fields."""
    m = {key: _meta(key, value) for key, value in spec.items()}
    return [dict(provider=p, iprov=i, receiver=r, ircv=j, mvrtype=t,
                 value=float(v))
            for p, i, r, j, t, v in zip(m["prov_pkg"], m["prov_id"],
                                        m["recv_pkg"], m["recv_id"],
                                        m["mvrtype"], np.asarray(m["value"]))]


def _augmented(base, specs):
    """The augmented model of ``base`` from feature and mover fields; the
    fields that it derives must equal the given ones."""
    specs = dict(specs)
    movers = _movers(specs.pop("mvr")) if "mvr" in specs else None
    model = AugmentedGwfModel(base, mvr=movers, **{
        pkg: {key: _meta(key, value) for key, value in spec.items()
              if key not in _DERIVED}
        for pkg, spec in specs.items()})
    built = augmented_state(model)
    for pkg, spec in specs.items():
        for key in _DERIVED:
            if key in spec and not np.array_equal(
                    np.asarray(built[f"{pkg}_{key}"]), np.asarray(spec[key])):
                raise ValueError(f"{pkg}_{key} differs from the augmented "
                                 "table built on this base")
    return model


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
    - optional ``tvk``, ``tvs``: {kper: [(node, PROP, value)]};
    - optional ``uzf``: ``uzf_state`` of the reference's UZF columns;
    - optional ``gwt``: the transport model, {``name``, ``arrays``,
      ``options`` (as ``gwt_from_reference`` takes them, or
      ``gwe_from_reference`` with ``kind`` "gwe"), ``settings`` (the fields
      of its ``ImsSettings``, or None), ``oc``, ``conc_path``,
      ``conc_text``, ``sgp_mxiter``}, on the flow model's grid, and with
      APT rows ``apt``: {``strt_extra`` (the features' starting
      concentrations), ``ext_conc`` (feature package → the sources'
      concentrations), ``uzt`` (rows for the UZF columns)} over the
      augmented flow model.
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
    gwt_kwargs = {}
    t = state.get("gwt")
    uzf = None
    if state.get("uzf") is not None:
        u = state["uzf"]
        uzf = make_uzf(u["columns"], device=device, **u["flags"])
    if t is not None:
        convert = (gwe_from_reference if t.get("kind") == "gwe"
                   else gwt_from_reference)
        gwt = convert(t["arrays"], options=t["options"], device=device,
                      name=t["name"], grid=grid)
        apt = t.get("apt")
        if apt is not None:
            gwt = AugmentedGwtModel(gwt, model,
                                    uzf=uzf if apt.get("uzt") else None)
            gwt.strt_extra = torch.tensor(np.asarray(apt["strt_extra"]),
                                          dtype=torch.float64, device=device)
        gwt_kwargs = dict(
            gwt=gwt, gwt_settings=None if t["settings"] is None
            else ImsSettings(**t["settings"]),
            gwt_oc=None if t["oc"] is None else OutputControl(t["oc"]),
            conc_path=t.get("conc_path"),
            conc_text=t.get("conc_text", "CONCENTRATION"))
    sim = Simulation(tdis, model, ImsSettings(**state["settings"]),
                     transient=list(state["transient"]), hds_path=hds_path,
                     cbc_path=cbc_path, lst_path=lst_path, oc=oc,
                     **gwt_kwargs)
    if t is not None:
        sim.sgp_mxiter = int(t.get("sgp_mxiter", 1))
        if t.get("apt") is not None:
            sim.apt_ext_conc = {
                kind: torch.tensor(np.asarray(value), dtype=torch.float64,
                                   device=device)
                for kind, value in t["apt"]["ext_conc"].items()}
    sim.fail_fast = bool(state["fail_fast"])
    sim.tvk = dict(state.get("tvk") or {})
    sim.tvs = dict(state.get("tvs") or {})
    sim.uzf = uzf
    for kper, pkgs in state["period_data"].items():
        sim.period_data[int(kper)] = PackageData(**{
            pkg: _package(_BOUNDS[pkg], dict(zip(
                (f.name for f in dataclasses.fields(_BOUNDS[pkg])), values)),
                device)
            for pkg, values in pkgs.items()})
    return sim


def uzf_state(uzf) -> dict:
    """The ``uzf`` entry of ``simulation_from_reference``'s state from
    either package's UZF columns: {"columns": {field: array}, "flags":
    {nz, ietflag, iseepflag, igwetflag}}."""
    return dict(columns={k: np.asarray(_host(getattr(uzf, k)))
                         for k in COLUMN_FIELDS},
                flags={k: int(getattr(uzf, k)) for k in
                       ("nz", "ietflag", "iseepflag", "igwetflag")})
