"""The sharded transport of the port (modflow6_torch/parallel/transport.py,
and BUY and CSUB on parallel/general.py) against the reference
(modflow6_tpu/parallel, tests/test_parallel_transport.py): GWF → GWT with
advection, dispersion, CNC and SSM on three shards; GWF → GWE with
conduction and CTP on four; BUY and CSUB no-delay interbeds on the general
runner; the density-coupled flow → transport sequence; and the sliced
transport arrays.

The reference's coupled runner compiles once, in a module fixture (the GWT
case); every case holds the port's sharded result against the port's
single-device sequence.  Tolerances, the reference tests' bars: heads and
concentrations 1e-7, GWE temperatures 1e-6; sliced arrays equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.gwt.builder import build_gwt as jax_build_gwt
from modflow6_tpu.parallel import transport as ref_transport
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwe.builder import build_gwe
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.gwf.buy import make_buy
from modflow6_torch.models.gwt.builder import build_gwt
from modflow6_torch.models.gwt.fmi import from_gwf_step
from modflow6_torch.parallel.general import (GeneralShardedSolution,
                                             partition_general)
from modflow6_torch.parallel.transport import (GeneralCoupledSolution,
                                               partition_coupled,
                                               partition_transport)
from modflow6_torch.solution import ImsSettings, NumericalSolution

FLOW = dict(outer_dvclose=1e-8, outer_maximum=100, inner_dvclose=1e-11,
            inner_rclose=1e-10, inner_maximum=2000)
TRANS = dict(FLOW, outer_maximum=50, linear_acceleration="bicgstab")
SSM = {"RCH": 0.25}


def _flow_kw(nrow=12, ncol=10, seed=3):
    rng = np.random.default_rng(seed)
    return dict(k=np.exp(rng.normal(0, 0.6, size=nrow * ncol)), strt=8.0,
                chd=[(i * ncol, 10.0) for i in range(nrow)]
                + [(i * ncol + ncol - 1, 6.0) for i in range(nrow)],
                rch=[(n, 2e-4) for n in range(nrow * ncol)])


def _grid(cls, nrow=12, ncol=10):
    return cls.create(1, nrow, ncol, delr=10.0, delc=10.0, top=20.0,
                      botm=np.zeros((1, nrow, ncol)))


def _gwt_kw(N=120, **extra):
    return dict(porosity=0.3, strt=0.0, scheme="upstream",
                cnc=[(i * 10, 1.0) for i in range(12)],
                dsp=dict(alh=np.full(N, 1.0), ath1=np.full(N, 0.1),
                         diffc=np.full(N, 1e-4)), **extra)


def _single_coupled(gwf, gwt, nstep, delt, ssm_spec=None, buy=False):
    """The single-device sequence, flow then transport each step."""
    sol_f = NumericalSolution(gwf, ImsSettings(**FLOW))
    sol_t = NumericalSolution(gwt, ImsSettings(**TRANS))
    head, conc = gwf.strt, gwt.strt
    for k in range(nstep):
        pk = (dataclasses.replace(gwf.packages, buy_conc=conc) if buy
              else None)
        head_new, info, aux = sol_f.solve_timestep(head, delt, kstp=k + 1,
                                                   iss=True, pkgs=pk)
        assert info.converged
        fields = from_gwf_step(gwf, head_new, head, aux["ibound"], None,
                               delt, True, pkgs=pk, ssm_spec=ssm_spec)
        conc, tinfo, _ = sol_t.solve_timestep(conc, delt, kstp=k + 1,
                                              iss=False, pkgs=fields)
        assert tinfo.converged
        head = head_new
    return head.numpy(), conc.numpy()


def _sharded_coupled(gwf, tmodel, nshards, nstep, delt, ssm_spec=None):
    csol = GeneralCoupledSolution(
        partition_coupled(gwf, tmodel, nshards), tmodel,
        ImsSettings(**FLOW), ImsSettings(**TRANS), devices="cpu",
        ssm_spec=ssm_spec)
    hs, cs = csol.scatter(gwf.strt), csol.scatter(tmodel.strt)
    for k in range(nstep):
        hs, cs, info = csol.solve_timestep(hs, cs, delt, kstp=k + 1,
                                           iss=True)
        assert info["converged"]
    return csol.gather(hs), csol.gather(cs)


@pytest.fixture(scope="module")
def reference_gwt():
    """The reference's sharded GWF → GWT run on three shards."""
    g = _grid(JaxDisGrid)
    gwf = jax_build_gwf("f", g, **_flow_kw())
    gwt = jax_build_gwt("t", g, **_gwt_kw())
    csol = ref_transport.GeneralCoupledSolution(
        ref_transport.partition_coupled(gwf, gwt, 3), gwt,
        JaxImsSettings(**FLOW), JaxImsSettings(**TRANS), ssm_spec=SSM)
    hs = csol.scatter(np.asarray(gwf.strt))
    cs = csol.scatter(np.asarray(gwt.strt))
    for k in range(3):
        hs, cs, info = csol.solve_timestep(hs, cs, 50.0, kstp=k + 1,
                                           iss=True)
        assert info["converged"]
    return csol.gather(hs), csol.gather(cs)


def test_coupled_gwt_sharded_matches(reference_gwt):
    g = _grid(DisGrid)
    gwf = build_gwf("f", g, device="cpu", **_flow_kw())
    ref_h, ref_c = _single_coupled(gwf, build_gwt("t", g, device="cpu",
                                                  **_gwt_kw()),
                                   3, 50.0, SSM)
    shd_h, shd_c = _sharded_coupled(gwf, build_gwt("t", g, device="cpu",
                                                   **_gwt_kw()),
                                    3, 3, 50.0, SSM)
    np.testing.assert_allclose(shd_h, ref_h, atol=1e-7)
    np.testing.assert_allclose(shd_c, ref_c, atol=1e-7)
    np.testing.assert_allclose(shd_h, reference_gwt[0], atol=1e-7)
    np.testing.assert_allclose(shd_c, reference_gwt[1], atol=1e-7)
    assert np.max(ref_c) > 0.01


def test_transport_partition_matches_reference():
    g, jg = _grid(DisGrid), _grid(JaxDisGrid)
    kw = _gwt_kw(src=[(55, 2.0), (7, 1.0)])
    part = partition_coupled(build_gwf("f", g, device="cpu", **_flow_kw()),
                             build_gwt("t", g, device="cpu", **kw), 3)
    tpart = partition_transport(part, build_gwt("t", g, device="cpu", **kw))
    jgwt = jax_build_gwt("t", jg, **kw)
    rpart = ref_transport.partition_coupled(
        jax_build_gwf("f", jg, **_flow_kw()), jgwt, 3)
    ref = ref_transport.partition_transport(rpart, jgwt)
    np.testing.assert_array_equal(part.local2global, rpart.local2global)
    for name in ("strt", "ibound0", "top", "bot", "area"):
        np.testing.assert_array_equal(getattr(tpart, name),
                                      np.asarray(getattr(ref, name)))
    for f, v in tpart.arrays.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref.arrays, f)))
    for f, v in tpart.disp.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref.disp, f)))
    for mine, theirs, field in ((tpart.cnc, ref.cnc, "conc"),
                                (tpart.src, ref.src, "q")):
        mask = np.asarray(theirs.mask)
        for p in range(3):
            np.testing.assert_array_equal(
                mine[p]["node"], np.asarray(theirs.node)[p][mask[p]])
            np.testing.assert_array_equal(
                mine[p][field], np.asarray(getattr(theirs, field))[p][mask[p]])


def test_coupled_gwe_sharded_matches_single():
    g = _grid(DisGrid)
    gwf = build_gwf("f", g, device="cpu", **_flow_kw(seed=11))

    def mk():
        return build_gwe("e", g, porosity=0.3, strt=5.0, scheme="upstream",
                         rhow=1000.0, cpw=4184.0, rhos=2650.0, cps=800.0,
                         ctp=[(i * 10, 25.0) for i in range(12)],
                         cnd=dict(alh=0.5, ath1=0.05, ktw=0.6, kts=2.0),
                         device="cpu")

    ref_h, ref_t = _single_coupled(gwf, mk(), 2, 100.0)
    shd_h, shd_t = _sharded_coupled(gwf, mk(), 4, 2, 100.0)
    np.testing.assert_allclose(shd_h, ref_h, atol=1e-7)
    np.testing.assert_allclose(shd_t, ref_t, atol=1e-6)
    assert np.max(ref_t) > 5.5


def test_sharded_buy_matches_single():
    """BUY on the general runner: the concentration passed per solve."""
    gwf = build_gwf("f", _grid(DisGrid), device="cpu", **_flow_kw(seed=5))
    gwf.buy = make_buy(denseref=1000.0, drhodc=[0.7], crhoref=[0.0])
    conc = np.linspace(0.0, 35.0, gwf.nodes)
    s = ImsSettings(**FLOW)
    pkgs = dataclasses.replace(gwf.packages, buy_conc=torch.as_tensor(conc))
    ref, info, _ = NumericalSolution(gwf, s).solve_timestep(
        gwf.strt, 20.0, iss=True, pkgs=pkgs)
    assert info.converged
    gsol = GeneralShardedSolution(partition_general(gwf, 3), s,
                                  devices="cpu")
    hs, sinfo = gsol.solve_timestep(gsol.scatter_heads(gwf.strt), 20.0,
                                    iss=True,
                                    conc=gsol.scatter_heads(conc))
    assert sinfo["converged"]
    np.testing.assert_allclose(gsol.gather_heads(hs), ref.numpy(),
                               atol=1e-7)


def test_sharded_csub_matches_single():
    """CSUB no-delay interbeds: column-aligned split, the up-chain load."""
    rng = np.random.default_rng(9)
    nlay, nrow, ncol = 2, 6, 8
    g = DisGrid.create(nlay, nrow, ncol, 10.0, 10.0, 20.0,
                       np.stack([10.0 * np.ones((nrow, ncol)),
                                 np.zeros((nrow, ncol))]))
    ncpl = nrow * ncol
    model = build_gwf(
        "cs", g, k=np.exp(rng.normal(0, 0.5, size=2 * ncpl)), strt=18.0,
        storage={"ss": 1e-5, "iconvert": 0},
        chd=[(i * ncol, 19.0) for i in range(nrow)],
        wel=[(ncpl + 20, -30.0)], device="cpu",
        csub=dict(sgm=1.7, sgs=2.0, cg_ske_cr=1e-5, cg_theta=0.2,
                  interbeds=[(ncpl + 10, 4.0, 1e-4, 1e-2, 0.3),
                             (5, 3.0, 2e-4, 5e-3, 0.25)]))
    state0 = model.csub_state0
    s = ImsSettings(**FLOW)
    pkgs = dataclasses.replace(model.packages, csub_state=state0)
    ref, info, _ = NumericalSolution(model, s).solve_timestep(
        model.strt, 5.0, iss=False, pkgs=pkgs)
    assert info.converged
    gsol = GeneralShardedSolution(partition_general(model, 4), s,
                                  devices="cpu")
    hs, sinfo = gsol.solve_timestep(
        gsol.scatter_heads(model.strt), 5.0, iss=False,
        csub_state=gsol.scatter_csub_state(state0))
    assert sinfo["converged"]
    np.testing.assert_allclose(gsol.gather_heads(hs), ref.numpy(),
                               atol=1e-7)


def test_coupled_buy_sharded_matches_single():
    """The lagged concentration feeds the sharded flow solve each step."""
    g = _grid(DisGrid)
    gwf = build_gwf("f", g, device="cpu", **_flow_kw(seed=21))
    gwf.buy = make_buy(denseref=1000.0, drhodc=[0.7], crhoref=[0.0])

    def mk():
        return build_gwt("t", g, porosity=0.3, strt=0.0, scheme="upstream",
                         cnc=[(i * 10, 20.0) for i in range(12)],
                         device="cpu")

    ref_h, ref_c = _single_coupled(gwf, mk(), 3, 40.0, buy=True)
    shd_h, shd_c = _sharded_coupled(gwf, mk(), 3, 3, 40.0)
    np.testing.assert_allclose(shd_h, ref_h, atol=1e-7)
    np.testing.assert_allclose(shd_c, ref_c, atol=1e-7)
    assert np.max(ref_c) > 1.0


def test_transport_refusals():
    g = _grid(DisGrid)
    gwf = build_gwf("f", g, device="cpu", **_flow_kw())
    gwt = build_gwt("t", g, device="cpu", **_gwt_kw())
    part = partition_coupled(gwf, gwt, 2)
    with pytest.raises(NotImplementedError, match="scalar"):
        GeneralCoupledSolution(part, gwt, ImsSettings(**FLOW),
                               devices="cpu",
                               ssm_spec={"RCH": np.ones(120)})
    gwt.ist = object()
    with pytest.raises(NotImplementedError, match="IST"):
        partition_transport(part, gwt)
