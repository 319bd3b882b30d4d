"""The port's entry points (modflow6_torch/entry.py) against the
reference's ``__graft_entry__.py``: ``entry()``'s fused step; the four
runs of ``dryrun_multichip`` on two shards against their single-device
solves; and those models, steps and settings against the reference's,
each model solved once on one device by both packages (the reference's
dry run, four sharded compiles, is not run here).

Tolerances: ``entry()`` against the reference's step, equal counts' bar
1e-10 (tests/test_torch_solve.py); the dry run's sharded results against
the single-device solves at the bars of tests/test_torch_parallel*.py:
row shards in mixed precision 1e-6, the general and coupled runners 1e-7
(heads and concentrations), the augmented runner 5e-7; the single-device
solves of the port's and the reference's models, both in f64, at the f64
bar 1e-10 (in mixed precision the order of the float32 sums alone sets
them up to 6.5e-9 apart).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf import advanced as jadv
from modflow6_tpu.models.gwf import exchange as jexg
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.gwt.builder import build_gwt as jax_build_gwt
from modflow6_tpu.models.gwt.fmi import from_gwf_step as jax_from_gwf_step
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution.ims import \
    NumericalSolution as JaxNumericalSolution
from modflow6_torch import entry
from modflow6_torch.solution import ImsSettings

DRYRUN_ATOL = {"rows": 1e-6, "general": 1e-7, "coupled": 1e-7,
               "augmented": 5e-7}
NAMES = ["rows", "general", "coupled", "augmented"]
ATOL = 1e-10
# the reference dry run's flow settings (__graft_entry__.py:71-73), its
# steps (delt, iss) and its transport's SSM (:86, :111, :131-133, :154)
REFERENCE_SETTINGS = dict(outer_dvclose=1e-6, outer_maximum=30,
                          inner_dvclose=1e-8, inner_rclose=1e-6,
                          inner_maximum=200, precision="mixed")
REFERENCE_STEPS = {"rows": (1.0, False), "general": (1.0, False),
                   "coupled": (10.0, True), "augmented": (5.0, False)}
REFERENCE_SSM = {"RCH": 0.25}
# the settings of the reference's coupled transport solution
# (parallel/transport.py:139-142 and models/gwt/builder.py:122-128)
REFERENCE_GWT_SETTINGS = dict(outer_dvclose=1e-8, inner_dvclose=1e-10,
                              inner_rclose=1e-9, inner_maximum=1000,
                              outer_maximum=50,
                              linear_acceleration="bicgstab")


def reference_models(n_devices):
    """The global models of the reference's dry run over ``n_devices``
    (__graft_entry__.py:83-151), built by the reference's builders with
    its arguments."""
    rows = ref_entry._flagship(nlay=1, nrow=4 * n_devices, ncol=8)
    nrow, ncol = 2 * n_devices, 6
    g = JaxDisGrid.create(1, nrow, ncol, 10.0, 10.0, 50.0,
                          np.zeros((1, nrow, ncol)))
    west = jax_build_gwf("w", g, k=2.0, strt=40.0,
                         storage={"ss": 1e-5, "iconvert": 0},
                         chd=[(i * ncol, 45.0) for i in range(nrow)])
    east = jax_build_gwf("e", g, k=4.0, strt=40.0,
                         storage={"ss": 1e-5, "iconvert": 0},
                         chd=[(i * ncol + ncol - 1, 35.0)
                              for i in range(nrow)],
                         wel=[(ncol + 1, -5.0)])
    pairs = [jexg.ExchangePair(i * ncol + ncol - 1, i * ncol, ihc=1,
                               cl1=5.0, cl2=5.0, hwva=10.0)
             for i in range(nrow)]
    merged = jexg.merge_gwf_models([west, east],
                                   [jexg.GwfGwfExchange(0, 1, pairs)])
    N = g.nodes
    gwf = jax_build_gwf("cf", g, k=3.0, strt=8.0,
                        chd=[(i * ncol, 10.0) for i in range(nrow)]
                        + [(i * ncol + ncol - 1, 6.0) for i in range(nrow)],
                        rch=[(n, 1e-4) for n in range(N)])
    gwt = jax_build_gwt("ct", g, porosity=0.3, strt=0.0, scheme="upstream",
                        cnc=[(i * ncol, 1.0) for i in range(nrow)],
                        dsp=dict(alh=np.full(N, 1.0), ath1=np.full(N, 0.1)))
    abase = jax_build_gwf("ab", g, k=3.0, strt=12.0,
                          storage={"ss": 1e-4, "iconvert": 0},
                          chd=[(i * ncol, 14.0) for i in range(nrow)])
    maw = jadv.build_maw([dict(radius=0.25, strt=12.0, rate=-5.0,
                               connections=[(ncol + 2, 50.0)])], g)
    reaches = [dict(node=j, cond=2.0, strtop=12.5, width=3.0, rough=0.03,
                    slope=1e-3, length=10.0, strt=12.8,
                    inflow=1.0 if j == 1 else 0.0,
                    upstream=[(j - 2, 1.0)] if j > 1 else [])
               for j in range(1, ncol - 1)]
    aug = jadv.AugmentedGwfModel(abase, maw=maw,
                                 sfr=jadv.build_sfr(reaches))
    return {"rows": (rows, None), "general": (merged, None),
            "coupled": (gwf, gwt), "augmented": (aug, None)}


def reference_single_device(model, tmodel, settings, delt, iss):
    """The reference's single-device step of a dry-run model (flow, then
    the transport on its flows): (heads, conc or None) as numpy."""
    head, info, aux = JaxNumericalSolution(model, settings).solve_timestep(
        np.asarray(model.strt), delt, kstp=1, iss=iss)
    assert info.converged
    if tmodel is None:
        return np.asarray(head), None
    fields = jax_from_gwf_step(model, head, np.asarray(model.strt),
                               aux["ibound"], None, delt, iss,
                               ssm_spec=REFERENCE_SSM)
    conc, tinfo, _ = JaxNumericalSolution(
        tmodel, JaxImsSettings(**REFERENCE_GWT_SETTINGS)).solve_timestep(
        np.asarray(tmodel.strt), delt, kstp=1, iss=False, pkgs=fields)
    assert tinfo.converged
    return np.asarray(head), np.asarray(conc)


def test_entry_step_matches_reference():
    ref_fn, ref_args = ref_entry.entry()
    want = np.asarray(jax.jit(ref_fn)(*ref_args))
    fn, args = entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    assert args[1].dtype == torch.float64 and args[2].dtype == torch.int32
    got = fn(*args)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def dryrun():
    return entry.dryrun_multichip(2, device="cpu")


@pytest.mark.parametrize("name", NAMES)
def test_dryrun_matches_single_device(dryrun, name):
    run = dryrun[name]
    assert run.info["converged"] and run.info["inner"] > 0
    assert np.isfinite(run.heads).all()
    heads, conc = entry.single_device(run)
    np.testing.assert_allclose(run.heads, heads, rtol=0,
                               atol=DRYRUN_ATOL[name])
    if name == "coupled":
        np.testing.assert_allclose(run.conc, conc, rtol=0,
                                   atol=DRYRUN_ATOL[name])
        assert conc.max() > 0.01           # the CNC column's front moved


@pytest.fixture(scope="module")
def reference():
    return reference_models(2)


@pytest.mark.parametrize("name", NAMES)
def test_dryrun_models_match_reference(dryrun, reference, name):
    """Each dry-run model, its step and its settings are the reference's:
    ``single_device`` on the port's model and the reference's
    ``NumericalSolution`` on the model that __graft_entry__.py builds, both
    in f64, give heads (and concentrations) within 1e-10.  The augmented
    run is solved by BiCGSTAB in both: the reference's dry run uses CG,
    which diverges on that system (ROADMAP Queue C, R38), so this
    configuration is the port's dry run's alone."""
    run = dryrun[name]
    kw = dict(REFERENCE_SETTINGS)
    if name == "augmented":
        kw["linear_acceleration"] = "bicgstab"
    assert run.settings == ImsSettings(**kw)
    assert (run.delt, run.iss) == REFERENCE_STEPS[name]
    assert entry.DRYRUN_SSM == REFERENCE_SSM
    kw["precision"] = "f64"
    model, tmodel = reference[name]
    want_h, want_c = reference_single_device(
        model, tmodel, JaxImsSettings(**kw), *REFERENCE_STEPS[name])
    got_h, got_c = entry.single_device(
        dataclasses.replace(run, settings=ImsSettings(**kw)))
    assert got_h.shape == want_h.shape
    np.testing.assert_allclose(got_h, want_h, rtol=0, atol=ATOL)
    if tmodel is not None:
        np.testing.assert_allclose(got_c, want_c, rtol=0, atol=ATOL)


def test_dryrun_shapes_are_the_reference_shapes(dryrun):
    """``__graft_entry__.py:75-158`` at n = 2: 8 x 8 row-sharded cells,
    two 4 x 6 models merged, one 4 x 6 coupled grid, and 24 cells with one
    well and four reaches."""
    assert dryrun["rows"].heads.shape == (64,)
    assert dryrun["general"].heads.shape == (48,)
    assert dryrun["coupled"].heads.shape == dryrun["coupled"].conc.shape \
        == (24,)
    assert dryrun["augmented"].heads.shape == (24 + 1 + 4,)


def test_shard_devices():
    assert entry.shard_devices(3, "cpu") == [torch.device("cpu")] * 3
