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
- ``delr`` (ncol), ``delc`` (nrow);
- ``condsat_x``, ``condsat_y``, ``condsat_z``: the reference's structured
  saturated conductances (``GwfModel.condsat3``);
- optional ``sto_iconvert``, ``sto_ss``, ``sto_sy`` (with ``sto_options``);
- optional ``{chd,wel,rch}_node``, ``_mask`` and the value ``chd_head``,
  ``wel_q``, ``rch_recharge``;
- optional ``wetdry``: the REWET thresholds per cell.

``npf_options`` and ``sto_options`` hold the fields of the reference's
``NpfOptions`` and ``StoOptions`` (``inewton`` and ``satomega`` among
them); ``model_options`` the reference GwfModel's ``inewton``,
``inewtonur``, ``wel_iflowred``, ``wel_flowred`` and ``rewet_opts``.  The
preconditioner settings travel in ``state["settings"]`` (the fields of
``ImsSettings``).
"""

from __future__ import annotations

import torch

from . import resolve_device
from .models.discretization import DisGrid
from .models.gwf import bnd, npf, sto
from .models.gwf.model import GwfModel, PackageData
from .models.simulation import Simulation
from .solution.ims import ImsSettings
from .timing.tdis import StressPeriod, Tdis
from .utils.oc import OutputControl

_BOUNDS = (("chd", "head", bnd.ChdData), ("wel", "q", bnd.WelData),
           ("rch", "recharge", bnd.RchData))


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

    nlay = grid_shape[0]
    delr, delc = f64("delr"), f64("delc")
    area = (delc[:, None] * delr[None, :]).reshape(-1).repeat(nlay)
    top, bot = f64("top"), f64("bot")
    npf_arrays = npf.NpfArrays(icelltype=i32("icelltype"), k11=f64("k11"),
                               k22=f64("k22"), k33=f64("k33"), top=top,
                               bot=bot)
    sto_opts = sto_arrays = None
    if sto_options is not None:
        sto_opts = sto.StoOptions(**sto_options)
        sto_arrays = sto.StoArrays(iconvert=i32("sto_iconvert"),
                                   ss=f64("sto_ss"), sy=f64("sto_sy"),
                                   top=top, bot=bot, area=area)
    packages = {}
    for pkg, value, cls in _BOUNDS:
        if f"{pkg}_node" in arrays:
            packages[pkg] = cls(tensor(f"{pkg}_node", torch.int64),
                                f64(f"{pkg}_{value}"),
                                tensor(f"{pkg}_mask", torch.bool))
    return GwfModel(
        name=name, dtopo=npf.DeviceTopology(tuple(grid_shape)),
        npf_opts=npf.NpfOptions(**npf_options), npf_arrays=npf_arrays,
        strt=f64("strt"), ibound0=i32("ibound0"), delr=delr, delc=delc,
        area=area, sto_opts=sto_opts, sto_arrays=sto_arrays,
        condsat3=(f64("condsat_x"), f64("condsat_y"), f64("condsat_z")),
        grid=grid,
        wetdry=f64("wetdry") if "wetdry" in arrays else None,
        **(model_options or {}), **packages)


def simulation_from_reference(state: dict, *, device=None, hds_path=None,
                              cbc_path=None, lst_path=None) -> Simulation:
    """The port's Simulation from a reference Simulation's state as numpy.

    Keys of ``state``:

    - ``name``; ``grid``: the keyword arguments of ``DisGrid.create``;
    - ``arrays``, ``npf_options``, ``sto_options``, ``model_options``: as
      ``from_reference`` takes them (``arrays`` holds the first period's packages);
    - ``tdis``: [(perlen, nstp, tsmult)]; ``transient``: one flag per period;
    - ``settings``: the fields of the reference's ``ImsSettings``;
    - ``period_data``: {kper: {"chd"|"wel"|"rch": (node, value, mask)}};
    - ``oc``: {kper: {(verb, what): spec}} or None; ``fail_fast``.
    """
    device = resolve_device(device)
    grid = DisGrid.create(**state["grid"])
    model = from_reference(
        state["arrays"], grid_shape=grid.grid_shape,
        npf_options=state["npf_options"], sto_options=state["sto_options"],
        model_options=state.get("model_options"), device=device, name=state["name"], grid=grid)
    tdis = Tdis(tuple(StressPeriod(float(p), int(n), float(m))
                      for p, n, m in state["tdis"]))
    oc = None if state["oc"] is None else OutputControl(state["oc"])
    sim = Simulation(tdis, model, ImsSettings(**state["settings"]),
                     transient=list(state["transient"]), hds_path=hds_path,
                     cbc_path=cbc_path, lst_path=lst_path, oc=oc)
    sim.fail_fast = bool(state["fail_fast"])
    classes = {pkg: cls for pkg, _, cls in _BOUNDS}
    for kper, pkgs in state["period_data"].items():
        sim.period_data[int(kper)] = PackageData(**{
            pkg: classes[pkg](
                torch.tensor(node, dtype=torch.int64, device=device),
                torch.tensor(value, dtype=torch.float64, device=device),
                torch.tensor(mask, dtype=torch.bool, device=device))
            for pkg, (node, value, mask) in pkgs.items()})
    return sim
