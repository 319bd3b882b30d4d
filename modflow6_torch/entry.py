"""Entry points of the system (port of the repository's
``__graft_entry__.py``): ``entry()``, one fused time step of the flagship
model at the entry settings, and ``dryrun_multichip(n)``, one step of each
of the four sharded runners at tiny shapes over n shards.

Both run on the CUDA device unless the caller passes ``device="cpu"``.
The dry run puts its shards round-robin over the CUDA devices of the
machine (``torch.cuda.device_count()``), or all on ``device`` when one is
given; with one card, every shard runs on it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .bench import flagship
from .models.discretization import DisGrid
from .models.gwf.advanced import AugmentedGwfModel, build_maw, build_sfr
from .models.gwf.builder import build_gwf
from .models.gwf.exchange import (ExchangePair, GwfGwfExchange,
                                  merge_gwf_models)
from .models.gwt.builder import DEFAULT_GWT_SETTINGS, build_gwt
from .models.gwt.fmi import from_gwf_step
from .parallel import ShardedSolution, partition_model
from .parallel.augmented import ShardedAugmentedSolution, partition_augmented
from .parallel.general import GeneralShardedSolution, partition_general
from .parallel.transport import GeneralCoupledSolution, partition_coupled
from .solution import ImsSettings
from .solution.fused import make_fused_step
from .solution.ims import NumericalSolution

# the IMS settings of ``entry``
ENTRY = dict(outer_dvclose=1e-6, outer_maximum=50, inner_dvclose=1e-8,
             inner_rclose=1e-6, inner_maximum=300)
# the IMS settings of the dry run's flow solves (stacked mixed precision)
DRYRUN = dict(outer_dvclose=1e-6, outer_maximum=30, inner_dvclose=1e-8,
              inner_rclose=1e-6, inner_maximum=200, precision="mixed")
# the augmented run's: CG on its unsymmetric system diverges to NaN on one
# device and on the shards (ROADMAP Queue C, R38); BiCGSTAB, the solver of
# the augmented runner's own tests, closes it
DRYRUN_AUGMENTED = dict(DRYRUN, linear_acceleration="bicgstab")
DRYRUN_SSM = {"RCH": 0.25}


def _flagship(nlay=2, nrow=64, ncol=64, device=None):
    """Flagship model: transient lognormal-K DIS aquifer with CHD/WEL/RCH
    (the test_gwf_npf01_75x75-class configuration)."""
    return flagship(nlay, nrow, ncol, device)


def entry(device=None):
    """(fn, example_args): ``fn(head_old, delt, kstp)`` is one fused time
    step of the flagship model at the entry settings and returns the
    heads; ``example_args`` are tensors on the model's device."""
    model = _flagship(device=device)
    step = make_fused_step(model, ImsSettings(**ENTRY), iss=False)

    def fn(head_old, delt, kstp):
        head, _, _, _ = step(head_old, float(delt), int(kstp))
        return head

    dev = model.device
    example_args = (model.strt, torch.tensor(1.0, dtype=torch.float64,
                                             device=dev),
                    torch.tensor(1, dtype=torch.int32, device=dev))
    return fn, example_args


@dataclasses.dataclass
class DryRun:
    """One sharded step of the dry run: its global model, its flow
    settings, the step (``delt``, ``iss``), the gathered result and the
    runner's info; the coupled run adds its transport model and
    concentrations."""

    model: object
    settings: ImsSettings
    delt: float
    iss: bool
    heads: np.ndarray
    info: dict
    tmodel: object = None
    conc: np.ndarray = None


def shard_devices(n_devices, device=None):
    """The shards' devices: all on ``device`` when one is given, else
    round-robin over the machine's CUDA devices."""
    if device is not None:
        return [torch.device(device)] * n_devices
    resolve_device(None)
    count = torch.cuda.device_count()
    return [torch.device("cuda", p % count) for p in range(n_devices)]


def dryrun_models(n_devices, device):
    """The dry run's four global models on ``device``: the row-sharded
    flagship, the two-model GWF6-GWF6 composite, the coupled GWF and GWT
    models, and the augmented MAW + SFR model."""
    rows = _flagship(nlay=1, nrow=4 * n_devices, ncol=8, device=device)

    nrow, ncol = 2 * n_devices, 6
    g = DisGrid.create(1, nrow, ncol, 10.0, 10.0, 50.0,
                       np.zeros((1, nrow, ncol)))
    west = build_gwf("w", g, k=2.0, strt=40.0,
                     storage={"ss": 1e-5, "iconvert": 0},
                     chd=[(i * ncol, 45.0) for i in range(nrow)],
                     device=device)
    east = build_gwf("e", g, k=4.0, strt=40.0,
                     storage={"ss": 1e-5, "iconvert": 0},
                     chd=[(i * ncol + ncol - 1, 35.0) for i in range(nrow)],
                     wel=[(ncol + 1, -5.0)], device=device)
    pairs = [ExchangePair(i * ncol + ncol - 1, i * ncol, ihc=1, cl1=5.0,
                          cl2=5.0, hwva=10.0) for i in range(nrow)]
    merged = merge_gwf_models([west, east], [GwfGwfExchange(0, 1, pairs)])

    N = g.nodes
    gwf = build_gwf("cf", g, k=3.0, strt=8.0,
                    chd=[(i * ncol, 10.0) for i in range(nrow)]
                    + [(i * ncol + ncol - 1, 6.0) for i in range(nrow)],
                    rch=[(n, 1e-4) for n in range(N)], device=device)
    gwt = build_gwt("ct", g, porosity=0.3, strt=0.0, scheme="upstream",
                    cnc=[(i * ncol, 1.0) for i in range(nrow)],
                    dsp=dict(alh=np.full(N, 1.0), ath1=np.full(N, 0.1)),
                    device=device)

    abase = build_gwf("ab", g, k=3.0, strt=12.0,
                      storage={"ss": 1e-4, "iconvert": 0},
                      chd=[(i * ncol, 14.0) for i in range(nrow)],
                      device=device)
    maw = build_maw([dict(radius=0.25, strt=12.0, rate=-5.0,
                          connections=[(ncol + 2, 50.0)])], g)
    reaches = [dict(node=j, cond=2.0, strtop=12.5, width=3.0, rough=0.03,
                    slope=1e-3, length=10.0, strt=12.8,
                    inflow=1.0 if j == 1 else 0.0,
                    upstream=[(j - 2, 1.0)] if j > 1 else [])
               for j in range(1, ncol - 1)]
    aug = AugmentedGwfModel(abase, maw=maw, sfr=build_sfr(reaches))
    return rows, merged, (gwf, gwt), aug


def _converged(converged, what, info=None):
    if not converged:
        raise RuntimeError(f"{what} dry run failed to converge: {info}")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One step of each sharded runner over ``n_devices`` shards, at tiny
    shapes, with the flow in mixed precision:

    1. ``rows``: the flagship model as row shards (``ShardedSolution``);
    2. ``general``: a two-model GWF6-GWF6 composite on the general path
       (``merge_gwf_models`` + ``partition_general``);
    3. ``coupled``: a GWF → GWT step on the shared partition
       (``partition_coupled`` + ``GeneralCoupledSolution``);
    4. ``augmented``: a MAW + SFR model (``partition_augmented`` +
       ``ShardedAugmentedSolution``), solved by BiCGSTAB.

    Each run must converge.  Returns {name: DryRun}."""
    devices = shard_devices(n_devices, device)
    settings = ImsSettings(**DRYRUN)
    rows, merged, (gwf, gwt), aug = dryrun_models(n_devices, devices[0])
    runs = {}

    ssol = ShardedSolution(partition_model(rows, n_devices), settings,
                           devices=devices)
    hs, info = ssol.solve_timestep(ssol.scatter_heads(rows.strt), delt=1.0,
                                   kstp=1, iss=False)
    _converged(info["converged"], "sharded", info)
    runs["rows"] = DryRun(rows, settings, 1.0, False, ssol.gather_heads(hs),
                          info)

    gsol = GeneralShardedSolution(partition_general(merged, n_devices),
                                  settings, devices=devices)
    hs, info = gsol.solve_timestep(gsol.scatter_heads(merged.strt),
                                   delt=1.0, kstp=1, iss=False)
    _converged(info["converged"], "two-model sharded", info)
    runs["general"] = DryRun(merged, settings, 1.0, False,
                             gsol.gather_heads(hs), info)

    csol = GeneralCoupledSolution(partition_coupled(gwf, gwt, n_devices),
                                  gwt, settings, devices=devices,
                                  ssm_spec=DRYRUN_SSM)
    hs, cs, info = csol.solve_timestep(csol.scatter(gwf.strt),
                                       csol.scatter(gwt.strt), delt=10.0,
                                       kstp=1, iss=True)
    _converged(info["converged"], "coupled transport", info)
    runs["coupled"] = DryRun(gwf, settings, 10.0, True, csol.gather(hs), info,
                             tmodel=gwt, conc=csol.gather(cs))

    aug_settings = ImsSettings(**DRYRUN_AUGMENTED)
    asol = ShardedAugmentedSolution(partition_augmented(aug, n_devices),
                                    aug_settings, devices=devices)
    xs, info = asol.solve_timestep(asol.scatter(aug.strt), delt=5.0,
                                   kstp=1, iss=False)
    _converged(info["converged"], "augmented sharded", info)
    runs["augmented"] = DryRun(aug, aug_settings, 5.0, False,
                               asol.gather(xs), info)
    return runs


def single_device(run: DryRun):
    """The dry run's step on the global model's device, one solution for
    the whole model (flow, then the transport on its flows for the coupled
    run), for holding the sharded result: (heads, conc or None) as
    numpy."""
    model = run.model
    head, info, aux = NumericalSolution(model, run.settings).solve_timestep(
        model.strt, run.delt, kstp=1, iss=run.iss)
    _converged(info.converged, "single-device", info)
    if run.tmodel is None:
        return head.cpu().numpy(), None
    fields = from_gwf_step(model, head, model.strt, aux["ibound"], None,
                           run.delt, run.iss, ssm_spec=DRYRUN_SSM)
    conc, tinfo, _ = NumericalSolution(
        run.tmodel, ImsSettings(**DEFAULT_GWT_SETTINGS)).solve_timestep(
        run.tmodel.strt, run.delt, kstp=1, iss=False, pkgs=fields)
    _converged(tinfo.converged, "single-device transport", tinfo)
    return head.cpu().numpy(), conc.cpu().numpy()
