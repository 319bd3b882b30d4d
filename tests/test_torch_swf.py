"""SWF surface-water flow in the port (modflow6_torch/models/swf: CHF on
DISV1D reach networks, OLF on DIS2D and DISV2D, the SWF–GWF exchange,
SwfSimulation) against the reference (modflow6_tpu/models/swf).

Bars: the assembled systems (diag, off, rhs), ``edge_flows`` and
``boundary_budget`` within 1e-12 of their largest entry, with the port's
``pow`` and ``sqrt`` computed as XLA's are (``glibc_pow``): PyTorch's
vectorised ``pow`` and ``sqrt`` differ from them in the last bit, and the
Newton fill divides those bits by its perturbation (√ε), so with
PyTorch's own the systems agree to 1e-7, SFR's bar
(test_sfr_npoint_xsection_normal_depth);
the builders equal to the reference's loops; the scenarios of
tests/test_swf.py run through both packages with stages within
10 × outer_dvclose, and, with the reference run op by op with its sums in
PyTorch's order and one ``pow``, with equal outer and inner counts;
``CoupledSwfGwf`` with equal Picard passes.  The scenario runs are cut to
their first steps (the reference tests march 40–150 steps to a steady
state); the port alone marches the normal-depth channel to its steady
state and meets the reference test's oracle.
"""

import math

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_parity import reference_in_torch_sum_order

from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.discretization.disv2d import Disv2dGrid as JaxDisv2d
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.swf import Disv1dGrid as JaxDisv1d
from modflow6_tpu.models.swf import build_chf as jax_chf
from modflow6_tpu.models.swf import build_olf as jax_olf
from modflow6_tpu.models.swf.exchange import CoupledSwfGwf as JaxCoupled
from modflow6_tpu.models.swf.exchange import SwfGwfExchange as JaxExchange
from modflow6_tpu.models.swf.model import SwfPackageData as JaxPkgs
from modflow6_tpu.models.swf.simulation import SwfSimulation as JaxSwfSim
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxSolution
from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
from modflow6_tpu.timing.tdis import Tdis as JaxTdis
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.discretization.disv2d import Disv2dGrid
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.swf.exchange import CoupledSwfGwf, SwfGwfExchange
from modflow6_torch.models.swf.model import (Disv1dGrid, SwfPackageData,
                                             build_chf, build_olf)
from modflow6_torch.models.swf.simulation import SwfSimulation
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.ims import NumericalSolution
from modflow6_torch.timing.tdis import StressPeriod, Tdis
from modflow6_torch.utils.binary import read_head_file

# tests/test_swf.py:settings()
SETTINGS = dict(outer_dvclose=1e-8, outer_maximum=300, inner_dvclose=1e-10,
                inner_rclose=1e-9, inner_maximum=500,
                linear_acceleration="bicgstab", no_ptc=True,
                under_relaxation="dbd", theta=0.9, akappa=1e-4, gamma=0.0,
                amomentum=0.0)
STAGE_BAR = 10 * SETTINGS["outer_dvclose"]


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def glibc_pow(monkeypatch):
    """The port's float powers and square roots of f64 tensors on the CPU
    through the C library's ``pow`` and numpy's ``sqrt``, which XLA's CPU
    ``pow`` and ``sqrt`` equal (PyTorch's vectorised ones differ from
    them in the last bit)."""
    own_pow, own_sqrt = torch.Tensor.__pow__, torch.sqrt

    def pw(self, e):
        if isinstance(e, float) and self.dtype == torch.float64:
            return torch.as_tensor(np.vectorize(math.pow, otypes=[float])(
                self.numpy(), e))
        return own_pow(self, e)

    def sqrt(x):
        if x.dtype == torch.float64 and x.device.type == "cpu":
            return torch.as_tensor(np.sqrt(x.numpy()))
        return own_sqrt(x)

    monkeypatch.setattr(torch.Tensor, "__pow__", pw)
    monkeypatch.setattr(torch, "sqrt", sqrt)


def close(got, want, rel=1e-12):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-300))


def chain(nreach, dx, width, bot):
    return (Disv1dGrid.chain(np.full(nreach, dx), width, bot),
            JaxDisv1d.chain(np.full(nreach, dx), width, bot))


def both(kind, grids, **kw):
    """The same SWF model in both packages."""
    tg, jg = grids
    build, jbuild = (build_chf, jax_chf) if kind == "chf" \
        else (build_olf, jax_olf)
    return build("m", tg, device="cpu", **kw), jbuild("m", jg, **kw)


def tree_grid(depth, rng):
    """A binary tree of reaches (the headwaters the leaves, the outlet
    reach 0), pairs listed child-first in random order."""
    n = 2 ** depth - 1
    child = np.arange(1, n)
    pairs = np.stack([child, (child - 1) // 2], 1)[rng.permutation(n - 1)]
    length = rng.uniform(50.0, 150.0, n)
    width = rng.uniform(2.0, 8.0, n)
    bot = rng.uniform(0.0, 5.0, n)
    return (Disv1dGrid(n, length, width, bot, pairs),
            JaxDisv1d(n, length, width, bot,
                      [tuple(int(v) for v in p) for p in pairs]))


# ----------------------------------------------------------- builders

def test_topology_and_cxs_assignment_equal_the_reference_loops():
    rng = np.random.default_rng(3)
    tg, jg = tree_grid(5, rng)
    t, j = tg.build_topology(), jg.build_topology()
    for name in ("edge_n", "edge_m", "ihc", "cl1", "cl2", "hwva",
                 "direction", "anglex"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    np.testing.assert_array_equal(t.nbr, j.nbr)
    np.testing.assert_array_equal(t.slot_nm, j.slot_nm)
    sections = [([0.0, 0.5, 1.0], [2.0, 0.0, 2.0]),
                ([0.0, 0.0, 1.0, 1.0], [1.0, 0.0, 0.0, 1.0]),
                ([0.0, 0.2, 0.4, 0.6, 0.8, 1.0], [3.0, 1.0, 0.0, 0.2, 1.0,
                                                  3.0],
                 [1.0, 1.2, 0.8, 1.0, 1.5])]
    idcxs = rng.integers(0, 5, tg.nodes)          # 0 and 4: no section
    tm, jm = both("chf", (tg, jg), cxs_sections=sections, idcxs=idcxs)
    for name in ("xs_station", "xs_height", "xs_rf", "xs_rect", "has_xs"):
        np.testing.assert_array_equal(_np(getattr(tm, name)),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)


# ------------------------------------------------------------- systems

def _models(case):
    rng = np.random.default_rng(7)
    if case in ("chain", "upstream", "cxs", "lkg"):
        nreach = 12
        bot = np.arange(nreach)[::-1] * 0.1
        kw = dict(manningsn=0.03, strt=bot + 0.4, flw=[(0, 2.0)],
                  zdg=[(nreach - 1, 5.0, 1e-3, 0.03)])
        if case == "chain":
            kw.update(chd=[(5, bot[5] + 0.45)], evp=[(3, 1e-5)])
        if case == "upstream":
            kw.update(icentral=0)
        if case == "cxs":
            kw.update(icentral=0, cxs_sections=[
                ([0.0, 0.5, 1.0], [2.0, 0.0, 2.0]),
                ([0.0, 0.0, 1.0, 1.0], [1.0, 0.0, 0.0, 1.0])],
                idcxs=np.tile([1, 2, 0], 4))
        tm, jm = both("chf", chain(nreach, 100.0, 5.0, bot), **kw)
        n = nreach
    else:
        nrow, ncol = 5, 6
        surf = (np.arange(ncol)[::-1] * 0.01)[None, :] \
            + rng.uniform(-0.005, 0.005, (nrow, ncol))
        args = (1, nrow, ncol, 10.0, 10.0, surf.max() + 1.0,
                surf[None, :, :])
        n = nrow * ncol
        kw = dict(manningsn=0.05, strt=surf.reshape(-1) + 0.02,
                  pcp=[(i, 1e-5) for i in range(n)],
                  evp=[(i, 2e-6) for i in range(0, n, 3)],
                  zdg=[(r * ncol + ncol - 1, 10.0, 1e-3, 0.05)
                       for r in range(nrow)],
                  cdb=[(ncol - 1, 10.0)])
        if case == "dis2d":
            tm, jm = both("olf", (DisGrid.create(*args),
                                  JaxDisGrid.create(*args)), **kw)
        else:
            verts = np.array([(j * 10.0, -i * 10.0) for i in range(nrow + 1)
                              for j in range(ncol + 1)])
            cells = []
            for i in range(nrow):
                for j in range(ncol):
                    v0 = i * (ncol + 1) + j
                    ids = [v0, v0 + 1, v0 + ncol + 2, v0 + ncol + 1]
                    cells.append((verts[ids, 0].mean(), verts[ids, 1].mean(),
                                  ids))
            tm, jm = both("olf", (Disv2dGrid.create(verts, cells,
                                                    surf.reshape(-1)),
                                  JaxDisv2d.create(verts, cells,
                                                   surf.reshape(-1))), **kw)
    stage = np.asarray(jm.strt) + rng.uniform(-0.01, 0.05, n)
    return tm, jm, stage, rng


def test_pow_differs_in_the_last_bit(monkeypatch):
    """PyTorch's pow and sqrt against XLA's: last-bit differences, which
    the Newton fill's division by √ε lifts to 1e-7 relative in the
    systems; XLA's equal the C library's and numpy's."""
    x = np.random.default_rng(0).uniform(0.0, 2.0, 4000)
    ref = np.asarray(jnp.asarray(x) ** (2.0 / 3.0))
    assert (torch.as_tensor(x) ** (2.0 / 3.0)).numpy().tolist() != \
        ref.tolist()
    np.testing.assert_array_equal([math.pow(v, 2.0 / 3.0) for v in x], ref)
    np.testing.assert_array_equal(np.sqrt(x), np.asarray(jnp.sqrt(x)))
    assert (torch.sqrt(torch.as_tensor(x)).numpy() != np.sqrt(x)).any()
    tm, jm, stage, _ = _models("dis2d")
    ib = jnp.ones(stage.shape[0], jnp.int32)
    want = jm.assemble(jnp.asarray(stage), jnp.asarray(stage), ib, 60.0,
                       False)
    got = tm.assemble(torch.as_tensor(stage), torch.as_tensor(stage),
                      torch.ones(stage.shape[0], dtype=torch.int32), 60.0,
                      False)
    for g, w in zip(got, want):
        close(g, w, 1e-7)
    glibc_pow(monkeypatch)
    got = tm.assemble(torch.as_tensor(stage), torch.as_tensor(stage),
                      torch.ones(stage.shape[0], dtype=torch.int32), 60.0,
                      False)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("case", ["chain", "upstream", "cxs", "lkg", "dis2d",
                                  "disv2d"])
def test_system_flows_and_budget_match_reference(case, monkeypatch):
    glibc_pow(monkeypatch)
    tm, jm, stage, rng = _models(case)
    n = stage.shape[0]
    old = stage - rng.uniform(0.0, 0.02, n)
    tpk = jpk = None
    if case == "lkg":
        node = np.arange(0, n, 2)
        bhead = np.asarray(jm.bot)[node] + rng.uniform(-1.0, 1.0, node.size)
        cond = rng.uniform(0.01, 0.05, node.size)
        tpk = SwfPackageData(flw=tm.flw, lkg=(torch.as_tensor(node),
                                              torch.as_tensor(bhead),
                                              torch.as_tensor(cond)))
        jpk = JaxPkgs(flw=jm.flw, lkg=(jnp.asarray(node, jnp.int32),
                                       jnp.asarray(bhead), jnp.asarray(cond)))
    tib, tst = tm.boundary_state(torch.as_tensor(stage), tpk)
    jib, jst = jm.boundary_state(jnp.asarray(stage), jpk)
    np.testing.assert_array_equal(_np(tib), np.asarray(jib))
    np.testing.assert_array_equal(_np(tst), np.asarray(jst))
    got = tm.assemble(tst, torch.as_tensor(old), tib, 60.0, False, tpk)
    want = jm.assemble(jst, jnp.asarray(old), jib, 60.0, False, jpk)
    for g, w in zip(got, want):
        close(g, w)
    close(tm.edge_flows(tst, tib), jm.edge_flows(jst, jib))
    tb, jb = tm.boundary_budget(tst, tib, tpk), jm.boundary_budget(jst, jib,
                                                                   jpk)
    assert list(tb) == list(jb)
    for name in jb:
        close(tb[name], jb[name])


def test_repeated_nodes_perturb_and_set_as_the_reference():
    """A node listed k times: its Newton perturbation is the sum of its k
    steps (``stage.at[node].add(eps)``), so the system equals the
    reference's; of several CHD entries on a node the last one sets it, as
    XLA's serial scatter does."""
    nreach = 6
    bot = np.arange(nreach)[::-1] * 0.1
    kw = dict(manningsn=0.03, strt=bot + 0.3, flw=[(0, 1.0), (0, 0.5)],
              zdg=[(5, 4.0, 1e-3, 0.03), (5, 4.0, 1e-3, 0.03),
                   (4, 4.0, 2e-3, 0.03)],
              evp=[(2, 1e-5), (2, 3e-5), (2, 2e-5)],
              chd=[(3, bot[3] + 0.2), (3, bot[3] + 0.5)])
    tm, jm = both("chf", chain(nreach, 50.0, 4.0, bot), **kw)
    stage = np.asarray(jm.strt) + 0.05
    tib, tst = tm.boundary_state(torch.as_tensor(stage))
    jib, jst = jm.boundary_state(jnp.asarray(stage))
    assert float(tst[3]) == float(jst[3]) == bot[3] + 0.5
    np.testing.assert_array_equal(_np(tib), np.asarray(jib))
    # the plan adds each of node 5's two steps
    eps = float(np.sqrt(np.finfo(float).eps) * max(abs(float(tst[5])), 1.0))
    plan = tm.plan(tm.zdg[0])
    pert = plan.add(tst, torch.full((3,), eps, dtype=torch.float64))
    assert float(pert[5]) == float(tst[5]) + eps + eps
    got = tm.assemble(tst, tst, tib, 30.0, False)
    want = jm.assemble(jst, jst, jib, 30.0, False)
    for g, w in zip(got, want):
        close(g, w)
    # without the repeat, node 5's ZDG terms differ: the repeat matters
    single = dict(kw, zdg=[(5, 4.0, 1e-3, 0.03), (4, 4.0, 2e-3, 0.03)])
    tm1 = build_chf("m", chain(nreach, 50.0, 4.0, bot)[0], device="cpu",
                    **single)
    d1 = tm1.assemble(tst, tst, tib, 30.0, False)[0]
    assert float(d1[5]) != float(got[0][5])


# ----------------------------------------- the scenarios of test_swf.py

def march_both(tm, jm, nstep, delt, bar=STAGE_BAR):
    """``nstep`` steps of test_swf.py's march in both packages: stages
    within ``bar``; returns the stages and the (outer, inner) counts."""
    tsol = NumericalSolution(tm, ImsSettings(**SETTINGS))
    jsol = JaxSolution(jm, JaxImsSettings(**SETTINGS))
    ts, js = tm.strt, jnp.asarray(jm.strt)
    counts = []
    for k in range(nstep):
        ts, ti, _ = tsol.solve_timestep(ts, delt=delt, kstp=k + 1, iss=False)
        js, ji, _ = jsol.solve_timestep(js, delt=delt, kstp=k + 1, iss=False)
        assert ti.converged and ji.converged
        counts.append(((ti.outer_iterations, ti.inner_iterations),
                       (ji.outer_iterations, ji.inner_iterations)))
        np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=0, atol=bar)
    return ts, js, counts


def scenario(name):
    """(port model, reference model, steps, delt) of each scenario."""
    if name == "normal_depth":
        nreach, dx, width, s0, nman, qin = 20, 100.0, 5.0, 1e-3, 0.03, 2.0
        bot = np.arange(nreach)[::-1] * dx * s0
        dn = (qin * nman / (width * np.sqrt(s0))) ** 0.6
        return (*both("chf", chain(nreach, dx, width, bot), manningsn=nman,
                      strt=bot + 0.5 * dn, flw=[(0, qin)],
                      zdg=[(nreach - 1, width, s0, nman)]), 6, 200.0)
    if name == "backwater":
        nreach, dx, width, s0, nman, qin = 15, 50.0, 4.0, 2e-3, 0.03, 1.0
        bot = np.arange(nreach)[::-1] * dx * s0
        dn = (qin * nman / (width * np.sqrt(s0))) ** 0.6
        return (*both("chf", chain(nreach, dx, width, bot), manningsn=nman,
                      strt=bot + 2 * dn, flw=[(0, qin)],
                      chd=[(nreach - 1, bot[-1] + 4 * dn)]), 6, 50.0)
    if name == "olf_plane":
        nrow, ncol, dx, s0, nman = 6, 10, 10.0, 1e-3, 0.05
        surf = (np.arange(ncol)[::-1] * dx * s0)[None, :] * np.ones((nrow, 1))
        args = (1, nrow, ncol, dx, dx, surf.max() + 1.0, surf[None, :, :])
        return (*both("olf", (DisGrid.create(*args), JaxDisGrid.create(*args)),
                      manningsn=nman, strt=surf.reshape(-1) + 0.01,
                      flw=[(i * ncol + j, 0.002) for i in range(nrow)
                           for j in range(ncol - 1)],
                      zdg=[(i * ncol + ncol - 1, dx, s0, nman)
                           for i in range(nrow)]), 5, 50.0)
    if name == "volume":
        return (*both("chf", chain(5, 10.0, 2.0, np.zeros(5)),
                      manningsn=0.03, strt=np.full(5, 1e-6),
                      flw=[(2, 0.5)]), 10, 5.0)
    if name == "cxs":
        nreach, dx, s0, nman, qin = 12, 100.0, 1e-3, 0.03, 1.5
        bot = np.arange(nreach)[::-1] * dx * s0
        return (*both("chf", chain(nreach, dx, 4.0, bot), manningsn=nman,
                      strt=bot + 1.4, icentral=0, flw=[(0, qin)],
                      zdg=[(nreach - 1, 4.0, s0, nman)],
                      cxs_sections=[([0.0, 0.5, 1.0], [2.0, 0.0, 2.0])],
                      idcxs=np.ones(nreach, np.int64)), 6, 300.0)
    if name == "pcp_evp_cdb":
        nreach, dx, width = 10, 100.0, 5.0
        return (*both("chf", chain(nreach, dx, width, np.zeros(nreach)),
                      manningsn=0.03, strt=0.3,
                      pcp=[(i, 1e-4) for i in range(nreach)],
                      evp=[(i, 2e-5) for i in range(nreach)],
                      cdb=[(nreach - 1, width)]), 6, 500.0)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["volume"])
def test_scenario_counts_at_one_sum_order(name, monkeypatch):
    """The cause of outer counts that differ by one against the jitted
    reference: with the reference run op by op with its sums in PyTorch's
    order, and the port's ``pow`` the C library's, the port takes the
    reference's outer and inner counts, stages within 1e-10."""
    glibc_pow(monkeypatch)
    tm, jm, nstep, delt = scenario(name)
    reference_in_torch_sum_order(monkeypatch)
    with jax.disable_jit():
        *_, counts = march_both(tm, jm, 3, delt, bar=1e-10)
    for got, want in counts:
        assert got == want


def test_normal_depth_at_steady_state():
    """tests/test_swf.py:test_chf_normal_depth's oracle, the port alone
    over the reference test's 60 steps."""
    tm, _, _, _ = scenario("normal_depth")
    sol = NumericalSolution(tm, ImsSettings(**SETTINGS))
    stage = tm.strt
    for k in range(60):
        stage, info, _ = sol.solve_timestep(stage, delt=200.0, kstp=k + 1,
                                            iss=False)
        assert info.converged
    bot = _np(tm.bot)
    dn = (2.0 * 0.03 / (5.0 * np.sqrt(1e-3))) ** 0.6
    np.testing.assert_allclose(_np(stage)[3:-3] - bot[3:-3], dn, rtol=2e-2)
    np.testing.assert_allclose(-float(tm._zdg_q(stage).sum()), 2.0,
                               rtol=1e-6)


def test_olf_disv2d_matches_dis2d():
    """tests/test_swf.py:test_olf_disv2d_matches_dis2d in the port, and
    the DISV2D run against the reference's."""
    nr, nc, d = 4, 6, 10.0
    slope_bot = np.arange(nc)[::-1] * 0.01 * d
    bot2d = np.tile(slope_bot, (nr, 1))
    args = (1, nr, nc, d, d, float(bot2d.max()) + 1.0, bot2d[None])
    verts = np.array([(j * d, -i * d) for i in range(nr + 1)
                      for j in range(nc + 1)])
    cells = []
    for i in range(nr):
        for j in range(nc):
            v0 = i * (nc + 1) + j
            ids = [v0, v0 + 1, v0 + nc + 2, v0 + nc + 1]
            cells.append((verts[ids, 0].sum() / 4.0,
                          verts[ids, 1].sum() / 4.0, ids))
    kw = dict(manningsn=0.05, strt=bot2d.reshape(-1) + 0.05,
              flw=[(i * nc, 0.05) for i in range(nr)],
              chd=[(i * nc + nc - 1, slope_bot[-1] + 0.05)
                   for i in range(nr)])
    m1 = build_olf("a", DisGrid.create(*args), device="cpu", **kw)
    tm, jm = both("olf", (Disv2dGrid.create(verts, cells, bot2d.reshape(-1)),
                          JaxDisv2d.create(verts, cells, bot2d.reshape(-1))),
                  **kw)
    s2, _, _ = march_both(tm, jm, 2, 100.0)
    sol = NumericalSolution(m1, ImsSettings(**SETTINGS))
    s1 = m1.strt
    for k in range(2):
        s1, info, _ = sol.solve_timestep(s1, delt=100.0, kstp=k + 1,
                                         iss=False)
    np.testing.assert_allclose(_np(s2), _np(s1), atol=1e-8)


def test_boundary_budget_with_lkg():
    """tests/test_swf.py:test_swf_boundary_budget_with_lkg in the port."""
    nreach = 6
    bot = np.arange(nreach)[::-1] * 0.1 + 5.0
    tm = build_chf("c", Disv1dGrid.chain(np.full(nreach, 50.0), 4.0, bot),
                   manningsn=0.03, strt=bot + 0.5, flw=[(0, 1.0)],
                   zdg=[(nreach - 1, 4.0, 1e-3, 0.03)], device="cpu")
    ib, st = tm.boundary_state(tm.strt)
    node = torch.arange(nreach)
    cond = torch.full((nreach,), 0.02, dtype=torch.float64)
    for bhead in (torch.as_tensor(bot + 1.0), torch.as_tensor(bot - 1.0)):
        out = tm.boundary_budget(st, ib, SwfPackageData(
            flw=tm.flw, lkg=(node, bhead, cond)))
        assert set(out) == {"FLW", "ZDG", "LKG"}
        depth = st - tm.bot
        t = torch.clamp(depth / 1e-4, 0.0, 1.0)
        f = torch.where(bhead < st, t * (2.0 - t), 1.0)
        np.testing.assert_allclose(_np(out["LKG"]),
                                   _np(cond * f * (bhead - st)), rtol=1e-12)


# ------------------------------------------------------- the exchange

def test_coupled_exchange_matches_reference():
    """tests/test_swf.py:test_chf_gwf_exchange_mass_balance's losing
    stream: equal Picard passes and outer counts, stages and heads within
    10 × outer_dvclose, over its first steps; the exchange's wells sum
    through the appended WelData's plan."""
    nreach, dx, width, s0, nman, qin = 10, 100.0, 5.0, 1e-3, 0.03, 2.0
    bot = np.arange(nreach)[::-1] * dx * s0 + 5.0
    tc, jc = both("chf", chain(nreach, dx, width, bot), manningsn=nman,
                  strt=bot + 0.3, flw=[(0, qin)],
                  zdg=[(nreach - 1, width, s0, nman)])
    args = (1, 3, nreach, dx, dx, 5.0, -20.0 * np.ones((1, 3, nreach)))
    gkw = dict(k=5.0, strt=0.0,
               chd=[(i * nreach, 0.0) for i in range(3)]
               + [(i * nreach + nreach - 1, 0.0) for i in range(3)],
               wel=[(2 * nreach + 3, -0.1)])
    tg = build_gwf("aq", DisGrid.create(*args), device="cpu", **gkw)
    jg = jax_build_gwf("aq", JaxDisGrid.create(*args), **gkw)
    exg = dict(swf_node=np.arange(nreach), gwf_node=nreach + np.arange(nreach),
               cond=np.full(nreach, 0.02))
    tcpl = CoupledSwfGwf(tc, tg, SwfGwfExchange(**exg))
    jcpl = JaxCoupled(jc, jg, JaxExchange(**exg))
    ts, th = tc.strt, tg.strt
    js, jh = jnp.asarray(jc.strt), jnp.asarray(jg.strt)
    for k in range(2):
        ts, th, ti = tcpl.step(ts, th, delt=500.0, kstp=k + 1, iss_gwf=True)
        js, jh, ji = jcpl.step(js, jh, delt=500.0, kstp=k + 1, iss_gwf=True)
        assert ti["converged"] and ji["converged"]
        assert ti["exg_iters"] == ji["exg_iters"], k
        np.testing.assert_allclose(_np(ts), np.asarray(js), atol=STAGE_BAR)
        np.testing.assert_allclose(_np(th), np.asarray(jh), atol=STAGE_BAR)
        np.testing.assert_allclose(_np(ti["q"]), np.asarray(ji["q"]),
                                   atol=STAGE_BAR)
    assert float(ti["q"].sum()) > 0.01
    # the GWF sees its own well first, then one entry per linked cell
    assert tcpl._wel.node.tolist()[:2] == [2 * nreach + 3, nreach]


# ---------------------------------------------------- SwfSimulation

def test_swf_simulation_matches_reference(tmp_path):
    """SwfSimulation with CHD, STO and a STAGE file: the budget terms (the
    CHD flow through the ELL slots) within 1e-12 of the reference's host
    sums, the STAGE records within 10 × outer_dvclose."""
    nreach = 8
    bot = np.arange(nreach)[::-1] * 0.1
    kw = dict(manningsn=0.03, strt=bot + 0.3, flw=[(0, 1.0)],
              chd=[(nreach - 1, bot[-1] + 0.35)], pcp=[(2, 1e-4)])
    tm, jm = both("chf", chain(nreach, 50.0, 4.0, bot), **kw)
    periods = ((600.0, 3, 1.0), (300.0, 1, 1.0))
    tsim = SwfSimulation(Tdis(tuple(StressPeriod(*p) for p in periods)), tm,
                         has_sto=True, sto_periods={1: True, 2: False},
                         hds_path=str(tmp_path / "port.stage"))
    jsim = JaxSwfSim(JaxTdis(tuple(JaxPeriod(*p) for p in periods)), jm,
                     has_sto=True, sto_periods={1: True, 2: False},
                     hds_path=str(tmp_path / "ref.stage"))
    trec, jrec = tsim.run(), jsim.run()
    assert [r.converged for r in trec] == [r.converged for r in jrec]
    for a, b in zip(trec, jrec):
        np.testing.assert_allclose(a.stage, b.stage, atol=STAGE_BAR)
    assert list(tsim.budget.terms) == list(jsim.budget.terms)
    for name, t in jsim.budget.terms.items():
        g = tsim.budget.terms[name]
        for attr in ("rate_in", "rate_out", "cum_in", "cum_out"):
            np.testing.assert_allclose(getattr(g, attr), getattr(t, attr),
                                       rtol=1e-7, atol=1e-12, err_msg=name)
    got = read_head_file(str(tmp_path / "port.stage"))
    want = read_head_file(str(tmp_path / "ref.stage"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["text"] == w["text"] == "STAGE"
        assert (g["kstp"], g["kper"], g["totim"]) == \
            (w["kstp"], w["kper"], w["totim"])
        np.testing.assert_allclose(g["data"], w["data"], atol=STAGE_BAR)
    # the CHD flow of the last step through the ELL slots against the
    # reference's host sums on the same stage
    st = torch.as_tensor(jrec[-1].stage)
    ib, _ = tm.boundary_state(st)
    into = tm.cell_inflow(tm.edge_flows(st, ib))
    q = np.asarray(jm.edge_flows(jnp.asarray(jrec[-1].stage),
                                 jnp.asarray(_np(ib))))
    want_into = np.zeros(nreach)
    np.add.at(want_into, np.asarray(jm.topo.edge_n), q)
    np.add.at(want_into, np.asarray(jm.topo.edge_m), -q)
    close(into, want_into)
