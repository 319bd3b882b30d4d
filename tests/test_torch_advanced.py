"""MAW, LAK and SFR of the port (modflow6_torch/models/gwf/advanced.py)
against the reference (modflow6_tpu/models/gwf/advanced.py): the
scenarios of tests/test_advanced.py, each built by both packages from the
same inputs, solved by both, and held to that file's physical checks on
the port's results; the widened neighbour table against the reference's
loops; the assembled systems of an augmented DIS and DISV model;
``convert.from_reference``; the reference's faults R1, R3 and R4 (ROADMAP
Queue C).

Tolerances:

- assembled systems (diag, off, rhs) and budget terms: 1e-12 of the
  largest entry; 1e-7 for reaches with an n-point cross section, whose
  dQ/dstage is a forward difference at eps = √DPREC that divides the
  conveyance's last-bit difference (XLA's and PyTorch's pow) by 1.5e-8;
- the widened table and its slots: equal arrays; the table
  interpolation: bitwise against ``jnp.interp``;
- heads and feature rows of a solve: 1e-8, ten times the tests'
  ``outer_dvclose`` of 1e-9 (BiCGSTAB, whose inner counts follow the sum
  order: ROADMAP Queue C), every step converged in both packages;
- the fused step against ``NumericalSolution`` in the port: bitwise, with
  the same counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf import advanced as jadv
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.gwf.builder import chd_data as jax_chd_data
from modflow6_tpu.models.gwf.model import PackageData as JaxPackageData
from modflow6_tpu.models.simulation import Simulation as JaxSimulation
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxSolution
from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
from modflow6_tpu.timing.tdis import Tdis as JaxTdis
from modflow6_torch.convert import augmented_state, from_reference
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf import advanced
from modflow6_torch.models.gwf.advanced import (AugmentedGwfModel, build_lak,
                                                build_maw, build_sfr)
from modflow6_torch.models.gwf.builder import build_gwf, chd_data
from modflow6_torch.models.gwf.model import PackageData
from modflow6_torch.models.simulation import Simulation
from modflow6_torch.ops.smoothing import quadratic_saturation, sq_saturation
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.fused import make_fused_step
from modflow6_torch.solution.ims import NumericalSolution
from modflow6_torch.timing.tdis import StressPeriod, Tdis
from test_torch_parity import reference_arrays

# tests/test_advanced.py:15-21
SETTINGS = dict(outer_dvclose=1e-9, outer_maximum=100, inner_dvclose=1e-11,
                inner_rclose=1e-10, inner_maximum=500,
                linear_acceleration="bicgstab")
HEAD_ATOL = 10 * SETTINGS["outer_dvclose"]
SYSTEM_RTOL = 1e-12


def close(got, want, rtol=SYSTEM_RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def row_grid(ncol, delr, top, nrow=1, nlay=1, botm=None):
    return dict(nlay=nlay, nrow=nrow, ncol=ncol, delr=delr, delc=delr,
                top=top, botm=np.zeros((nlay, nrow, ncol)) if botm is None
                else botm)


def both(grid, base_kw, maw=None, lak=None, sfr=None, k11=None):
    """(reference, port) augmented models from the same inputs: ``maw``
    the wells of build_maw, ``lak`` (lakes, outlets), ``sfr`` the reaches."""
    jg, tg = JaxDisGrid.create(**grid), DisGrid.create(**grid)
    jbase = jax_build_gwf("ref", jg, **base_kw)
    tbase = build_gwf("port", tg, device="cpu", **base_kw)
    kk = dict(k11=k11, k22=k11) if k11 is not None else {}
    jm = jadv.AugmentedGwfModel(
        jbase, maw=None if maw is None else jadv.build_maw(maw, jg, **kk),
        lak=None if lak is None else jadv.build_lak(*lak),
        sfr=None if sfr is None else jadv.build_sfr(sfr))
    tm = AugmentedGwfModel(
        tbase, maw=None if maw is None else build_maw(maw, tg, **kk),
        lak=None if lak is None else build_lak(*lak),
        sfr=None if sfr is None else build_sfr(sfr))
    return jm, tm


def assert_same_system(jm, tm, x, x_old=None, delt=1.0, iss=False,
                       rtol=SYSTEM_RTOL):
    """The raw assembled (diag, off, rhs) of both at the iterate x."""
    x_old = x if x_old is None else x_old
    ibj, hj = jm.boundary_state(jnp.asarray(x))
    _, hoj = jm.boundary_state(jnp.asarray(x_old))
    ibt, ht = tm.boundary_state(torch.tensor(x))
    _, hot = tm.boundary_state(torch.tensor(x_old))
    for got, want in zip(tm.assemble(ht, hot, ibt, delt, iss),
                         jm.assemble(hj, hoj, ibj, jnp.asarray(delt), iss)):
        close(got, want, rtol)


def solve_both(jm, tm, steps=1, delt=1.0, iss=True, system_rtol=SYSTEM_RTOL,
               **kw):
    """Both packages through ``steps`` time steps of NumericalSolution;
    the system at the start and the heads at the end compared.  Returns
    the port's final x as numpy."""
    assert_same_system(jm, tm, np.asarray(jm.strt), delt=delt, iss=iss,
                       rtol=system_rtol)
    s = {**SETTINGS, **kw}
    jsol = JaxSolution(jm, JaxImsSettings(**s))
    tsol = NumericalSolution(tm, ImsSettings(**s))
    xj, xt = jnp.asarray(jm.strt), tm.strt
    for kstp in range(1, steps + 1):
        xj, infoj, _ = jsol.solve_timestep(xj, delt, kstp=kstp, iss=iss)
        xt, infot, _ = tsol.solve_timestep(xt, delt, kstp=kstp, iss=iss)
        assert infoj.converged and infot.converged, kstp
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=HEAD_ATOL)
    return xt.numpy()


def x_of(a):
    return torch.tensor(np.asarray(a, np.float64))


# ------------------------------------------- tests/test_advanced.py twins

def test_maw_single_cell_balance():
    """hw = h + rate / c at steady state."""
    grid = row_grid(3, 100.0, 50.0)
    c, rate = 25.0, -500.0
    jm, tm = both(grid, dict(k=10.0, strt=40.0, chd=[(0, 40.0), (2, 40.0)]),
                  maw=[dict(radius=0.25, strt=40.0, rate=rate,
                            connections=[(1, c)])])
    x = solve_both(jm, tm)
    np.testing.assert_allclose(x[3], x[1] + rate / c, rtol=1e-8)


def test_maw_multi_node_well_direct_solve():
    """One well screened in three layers: Σ c_i (hw − h_i) = rate, and
    more flow from the higher-conductance layer."""
    nlay, ncol = 3, 7
    grid = row_grid(ncol, 10.0, 30.0, nlay=nlay, botm=np.linspace(
        20.0, 0.0, nlay)[:, None, None] * np.ones((nlay, 1, ncol)))
    k = np.repeat([5.0, 1.0, 10.0], ncol)
    chd = [(lay * ncol, 25.0) for lay in range(nlay)] + \
          [(lay * ncol + ncol - 1, 25.0) for lay in range(nlay)]
    conds = [40.0, 15.0, 60.0]
    wnode = [lay * ncol + 3 for lay in range(nlay)]
    rate = -300.0
    jm, tm = both(grid, dict(k=k, k33=k, strt=25.0, chd=chd),
                  maw=[dict(radius=0.2, strt=25.0, rate=rate,
                            connections=list(zip(wnode, conds)))])
    x = solve_both(jm, tm)
    q = np.array([conds[i] * (x[nlay * ncol] - x[wnode[i]])
                  for i in range(nlay)])
    np.testing.assert_allclose(q.sum(), rate, rtol=1e-8)
    assert abs(q[2]) > abs(q[1])


def test_maw_transient_storage():
    """A closed cell and a well with storage: the volume pumped equals
    the aquifer's and the wellbore's storage change."""
    grid = row_grid(1, 50.0, 100.0)
    jm, tm = both(grid, dict(k=1.0, strt=90.0,
                             storage={"ss": 1e-4, "iconvert": 0}),
                  maw=[dict(radius=1.0, strt=90.0, rate=-40.0,
                            connections=[(0, 50.0)])])
    delt = 2.0
    x = solve_both(jm, tm, steps=5, delt=delt, iss=False)
    ss_vol = 1e-4 * 50.0 * 50.0 * 100.0 * (90.0 - x[0])
    well_vol = np.pi * 1.0 * (90.0 - x[1])
    np.testing.assert_allclose(ss_vol + well_vol, 40.0 * 5 * delt, rtol=1e-6)


def test_lak_equilibrium_stage():
    """Free drainage below the lakebed: s = belev + rain / c."""
    grid = row_grid(3, 100.0, 20.0)
    c, rain = 8.0, 24.0
    jm, tm = both(grid, dict(k=5.0, strt=10.0,
                             chd=[(0, 10.0), (1, 10.0), (2, 10.0)]),
                  lak=([dict(strt=11.0, surf_area=1.0e4, rainfall=rain,
                             connections=[(1, c, 15.0)])], None))
    x = solve_both(jm, tm)
    np.testing.assert_allclose(x[3], 15.0 + rain / c, rtol=1e-8)


def test_lak_coupled_exchange():
    """Aquifer above the lakebed: s = h − withdrawal / c."""
    grid = row_grid(3, 100.0, 20.0)
    c, wdrl = 10.0, 30.0
    jm, tm = both(grid, dict(k=5.0, strt=12.0,
                             chd=[(0, 12.0), (1, 12.0), (2, 12.0)]),
                  lak=([dict(strt=12.0, surf_area=1.0e4, withdrawal=wdrl,
                             connections=[(1, c, 5.0)])], None))
    x = solve_both(jm, tm)
    np.testing.assert_allclose(x[3], 12.0 - wdrl / c, rtol=1e-8)


def test_lak_manning_outlet():
    """rain = (w/n) d^{5/3} √S at steady state."""
    grid = row_grid(1, 10.0, 5.0)
    rain, w, n_man, slope, invert = 12.0, 3.0, 0.04, 0.002, 20.0
    jm, tm = both(grid, dict(k=1e-8, strt=1.0, chd=[(0, 1.0)]),
                  lak=([dict(strt=20.5, surf_area=500.0, rainfall=rain,
                             connections=[(0, 1e-12, 18.0)])],
                       [dict(lake=0, type="manning", invert=invert, width=w,
                             rough=n_man, slope=slope)]))
    x = solve_both(jm, tm)
    d_exact = (rain * n_man / (w * np.sqrt(slope))) ** 0.6
    np.testing.assert_allclose(x[1] - invert, d_exact, rtol=1e-6)


def test_sfr_normal_depth_chain():
    """Three reaches in series: each at its Manning normal depth."""
    grid = row_grid(3, 100.0, 10.0)
    qin, w, n_man, slope = 50.0, 4.0, 0.03, 1e-3
    reaches = [dict(node=i, cond=1e-12, strtop=5.0 - i * 0.1, width=w,
                    rough=n_man, slope=slope, length=100.0,
                    strt=5.5 - i * 0.1, inflow=qin if i == 0 else 0.0,
                    upstream=[(i - 1, 1.0)] if i > 0 else [])
               for i in range(3)]
    jm, tm = both(grid, dict(k=1e-10, strt=1.0,
                             chd=[(0, 1.0), (1, 1.0), (2, 1.0)]),
                  sfr=reaches)
    x = solve_both(jm, tm)
    d_exact = (qin * n_man / (w * np.sqrt(slope))) ** 0.6
    for i in range(3):
        np.testing.assert_allclose(x[3 + i] - (5.0 - i * 0.1), d_exact,
                                   rtol=1e-6)


def test_sfr_gwf_exchange_budget():
    """A losing reach: inflow = outflow + seepage, in both budgets."""
    grid = row_grid(5, 50.0, 20.0)
    qin = 100.0
    jm, tm = both(grid, dict(k=5.0, strt=10.0, chd=[(0, 10.0), (4, 10.0)]),
                  sfr=[dict(node=2, cond=20.0, strtop=12.0, width=5.0,
                            rough=0.03, slope=1e-3, length=50.0, strt=12.5,
                            inflow=qin)])
    x = solve_both(jm, tm)
    assert x[5] > 12.0 and x[2] > 10.0
    bud = tm.advanced_budget(x_of(x), x_of(x), 1.0, True)
    want = jm.advanced_budget(jnp.asarray(x), jnp.asarray(x), 1.0, True)
    assert bud.keys() == want.keys()
    for key in bud:
        close(bud[key], want[key])
    np.testing.assert_allclose(
        qin, -float(bud["SFR-OUT"].sum()) + float(bud["SFR-GWF"].sum()),
        rtol=1e-7)


def test_maw_head_limit_caps_withdrawal():
    """HEAD_LIMIT: the rate is capped at −125 and hw sits at the limit;
    without it the well draws down to 20."""
    grid = row_grid(3, 100.0, 50.0)
    base = dict(k=10.0, strt=40.0, chd=[(0, 40.0), (1, 40.0), (2, 40.0)])
    jm, tm = both(grid, base, maw=[dict(radius=0.25, strt=40.0, rate=-500.0,
                                        head_limit=35.0,
                                        connections=[(1, 25.0)])])
    x = solve_both(jm, tm)
    np.testing.assert_allclose(x[3], 35.0, atol=1e-7)
    rate = tm.maw.rate_actual(x_of(x), 3)
    close(rate, jm.maw.rate_actual(jnp.asarray(x), 3))
    np.testing.assert_allclose(float(rate[0]), -125.0, rtol=1e-7)
    jm2, tm2 = both(grid, base, maw=[dict(radius=0.25, strt=40.0,
                                          rate=-500.0,
                                          connections=[(1, 25.0)])])
    np.testing.assert_allclose(solve_both(jm2, tm2)[3], 20.0, atol=1e-7)


def test_maw_rate_scaling():
    """RATE_SCALING: c (h − hw) = 800·sat(hw) inside the ramp (DBD)."""
    grid = row_grid(3, 100.0, 50.0)
    jm, tm = both(grid, dict(k=10.0, strt=40.0,
                             chd=[(0, 40.0), (1, 40.0), (2, 40.0)]),
                  maw=[dict(radius=0.25, strt=40.0, rate=-800.0,
                            pumpelev=20.0, reduction_length=10.0,
                            connections=[(1, 25.0)])])
    x = solve_both(jm, tm, under_relaxation="dbd", theta=0.7, akappa=1e-3,
                   gamma=0.0, amomentum=0.0)
    hw = x[3]
    sat = float(sq_saturation(x_of(30.0), x_of(20.0), x_of(hw)))
    np.testing.assert_allclose(25.0 * (40.0 - hw), 800.0 * sat, rtol=1e-6)
    assert 20.0 < hw < 30.0


def test_maw_flowing_well():
    """FLOWING_WELL: the aquifer's inflow leaves as artesian discharge."""
    grid = row_grid(3, 100.0, 50.0)
    jm, tm = both(grid, dict(k=10.0, strt=45.0,
                             chd=[(0, 45.0), (1, 45.0), (2, 45.0)]),
                  maw=[dict(radius=0.25, strt=45.0, rate=0.0,
                            flowing=dict(elev=41.0, cond=5.0, rlen=0.5),
                            connections=[(1, 25.0)])])
    x = solve_both(jm, tm)
    assert 41.0 < x[3] < 45.0
    bud = tm.advanced_budget(x_of(x), x_of(x), 1.0, True)
    want = jm.advanced_budget(jnp.asarray(x), jnp.asarray(x), 1.0, True)
    for key in bud:
        close(bud[key], want[key])
    q_gwf, q_fw = float(bud["MAW-GWF"].sum()), float(bud["MAW-FW"].sum())
    np.testing.assert_allclose(-q_gwf, -q_fw, rtol=1e-8)
    assert q_fw < -0.1


def test_lak_table_storage_mass_balance():
    """V(s_n) − V(s_0) = inflow·t for a nonlinear stage/volume table."""
    grid = row_grid(3, 100.0, 50.0)
    table = [(20.0 + z, 100.0 * z + 10.0 * z * z, 100.0 + 20.0 * z)
             for z in np.linspace(0.0, 10.0, 11)]
    jm, tm = both(grid, dict(k=10.0, strt=40.0,
                             chd=[(0, 40.0), (1, 40.0), (2, 40.0)]),
                  lak=([dict(strt=21.0, bottom=20.0, surf_area=0.0,
                             rainfall=50.0, table=table,
                             connections=[(1, 1e-9, 20.0)])], None))
    x = solve_both(jm, tm, steps=5, delt=2.0, iss=False)
    v0 = float(tm.lak.volume_of(x_of([21.0]))[0])
    v_end = float(tm.lak.volume_of(x_of([x[3]]))[0])
    np.testing.assert_allclose(v_end - v0, 50.0 * 10.0, rtol=1e-8)
    np.testing.assert_allclose(float(tm.lak.sarea_of(x_of([x[3]]))[0]),
                               100.0 + 20.0 * (x[3] - 20.0), rtol=1e-9)


def test_lak_weir_outlet_steady():
    """(2/3)·0.61·w·√(2g)·d^1.5 = inflow after 80 long steps."""
    grid = row_grid(3, 100.0, 50.0)
    qin = 5.0
    jm, tm = both(grid, dict(k=10.0, strt=40.0,
                             chd=[(0, 40.0), (1, 40.0), (2, 40.0)]),
                  lak=([dict(strt=30.5, bottom=28.0, surf_area=1e4,
                             rainfall=qin, connections=[(1, 1e-9, 28.0)])],
                       [dict(lake=0, to=-1, type="weir", invert=30.0,
                             width=2.0)]))
    x = solve_both(jm, tm, steps=80, delt=5e3, iss=False)
    d = x[3] - 30.0
    q_weir = (2.0 / 3.0) * 0.61 * 2.0 * np.sqrt(2.0 * 9.80665) * d ** 1.5
    np.testing.assert_allclose(q_weir, qin, rtol=1e-6)


def test_lak_cascade_jacobian_coupled():
    """Upper Manning outlet into the lower lake (coupled in the
    Jacobian), lower weir out: both pass the inflow at steady state."""
    grid = row_grid(4, 100.0, 50.0)
    qin = 3.0
    jm, tm = both(grid, dict(k=10.0, strt=40.0,
                             chd=[(i, 40.0) for i in range(4)]),
                  lak=([dict(strt=32.2, bottom=30.0, surf_area=5e3,
                             rainfall=qin, connections=[(1, 1e-9, 30.0)]),
                        dict(strt=25.3, bottom=24.0, surf_area=5e3,
                             connections=[(2, 1e-9, 24.0)])],
                       [dict(lake=0, to=1, type="manning", invert=32.0,
                             width=3.0, rough=0.03, slope=1e-3),
                        dict(lake=1, to=-1, type="weir", invert=25.0,
                             width=2.0)]))
    assert tm.lak.out_slot == jm.lak.out_slot and tm.lak.out_slot[0] >= 0
    x = solve_both(jm, tm, steps=100, delt=2e4, iss=False)
    for i in range(2):
        np.testing.assert_allclose(float(tm.lak.outlet_flow(x_of(x), 4,
                                                            i)[0]),
                                   qin, rtol=1e-6)


def test_sfr_npoint_xsection_normal_depth():
    """A V-notch n-point section: C(d)·√S = Q in every reach."""
    from modflow6_torch.ops import cxs
    grid = row_grid(6, 100.0, 50.0)
    qin, s0, nman = 2.0, 1e-3, 0.03
    xsec = ([0.0, 0.5, 1.0], [2.0, 0.0, 2.0])
    reaches = [dict(node=1 + r, cond=0.0, strtop=40.0 - 0.1 * r, width=4.0,
                    rough=nman, slope=s0, length=100.0, strt=40.5 - 0.1 * r,
                    inflow=qin if r == 0 else 0.0, xsection=xsec,
                    upstream=[(r - 1, 1.0)] if r > 0 else [])
               for r in range(4)]
    jm, tm = both(grid, dict(k=10.0, strt=30.0, chd=[(0, 30.0), (5, 30.0)]),
                  sfr=reaches)
    # dQ of a cross section is a forward difference at eps = √DPREC: the
    # last-bit difference of XLA's and PyTorch's pow in the conveyance
    # (test_torch_cxs.py) is divided by eps ≈ 1.5e-8 in the Jacobian terms
    x = solve_both(jm, tm, steps=60, delt=1e4, iss=False, system_rtol=1e-7)
    d = x[6:] - np.asarray([40.0 - 0.1 * r for r in range(4)])
    assert (d > 0.01).all()
    conv = cxs.conveyance(x_of([[0.0, 2.0, 4.0]] * 4),
                          x_of([[2.0, 0.0, 2.0]] * 4), x_of(np.ones((4, 2))),
                          x_of(np.full(4, nman)), x_of(d))
    np.testing.assert_allclose(conv.numpy() * np.sqrt(s0), qin, rtol=1e-6)


def test_sfr_diversion_rules():
    """UPTO takes its flow off the top; the rest routes downstream."""
    grid = row_grid(6, 100.0, 50.0)
    qin = 3.0
    common = dict(cond=0.0, width=3.0, rough=0.03, slope=1e-3, length=100.0)
    reaches = [
        dict(node=1, strtop=40.0, strt=40.4, inflow=qin,
             diversions=[dict(to=2, cprior="upto", flow=1.0)], **common),
        dict(node=2, strtop=39.9, strt=40.3, upstream=[(0, 1.0)], **common),
        dict(node=3, strtop=39.9, strt=40.3, **common)]
    jm, tm = both(grid, dict(k=10.0, strt=30.0, chd=[(0, 30.0), (5, 30.0)]),
                  sfr=reaches)
    x = solve_both(jm, tm, steps=50, delt=1e4, iss=False)
    q, _ = tm.sfr._manning(x_of(x[6:]))
    np.testing.assert_allclose(q.numpy(), [qin, qin - 1.0, 1.0], rtol=1e-6)


def test_lak_horizontal_connection_wetted_scaling():
    """A HORIZONTAL connection's conductance is scaled by the quadratic
    wetted fraction at vv = ½(min(s, telev) + min(h, telev))."""
    grid = row_grid(4, 100.0, 50.0)
    belev, telev = 28.0, 36.0
    jm, tm = both(grid, dict(k=5.0, strt=30.0, icelltype=1,
                             chd=[(0, 30.0)]),
                  lak=([dict(strt=32.0, bottom=belev, surf_area=500.0,
                             rainfall=5.0,
                             connections=[(2, 40.0, belev, telev, 1)])],
                       None))
    s = x_of([32.0])
    h = x_of([0.0, 0.0, 31.0, 0.0])[tm.lak.conn_node]
    vv = 0.5 * (min(32.0, telev) + min(31.0, telev))
    sat = float(quadratic_saturation(x_of([telev]), x_of([belev]),
                                     x_of([vv]))[0])
    c_eff = tm.lak.conn_cond(s[tm.lak.conn_lake], h)
    close(c_eff, jm.lak.conn_cond(jnp.asarray([32.0])[jm.lak.conn_lake],
                                  jnp.asarray(h.numpy())))
    np.testing.assert_allclose(float(c_eff[0]), 40.0 * sat, rtol=1e-12)
    assert 0.1 < sat < 1.0
    solve_both(jm, tm, delt=100.0, iss=False)


def test_maw_shut_off_hysteresis():
    """SHUT_OFF: the head-limited well shuts in the low period and
    reopens above maxrate; the port's flags after each step are the
    reference's before the next, and its heads the reference's."""
    grid = row_grid(3, 100.0, 50.0)
    jm, tm = both(grid, dict(k=20.0, strt=30.0,
                             storage={"ss": 1e-5, "iconvert": 0},
                             chd=[(0, 30.0), (2, 30.0)]),
                  maw=[dict(radius=0.3, strt=30.0, rate=-100.0,
                            head_limit=25.0, shut_off=(40.0, 60.0),
                            connections=[(1, 10.0)])])
    periods = [(50.0, 3, 1.0)] * 3
    jsim = JaxSimulation(JaxTdis(tuple(JaxPeriod(*p) for p in periods)), jm,
                         JaxImsSettings(**SETTINGS))
    sim = Simulation(Tdis(tuple(StressPeriod(*p) for p in periods)), tm,
                     ImsSettings(**SETTINGS))
    for kper, h in ((2, 27.0), (3, 32.0)):
        jsim.period_data[kper] = JaxPackageData(
            chd=jax_chd_data([(0, h), (2, h)]))
        sim.period_data[kper] = PackageData(chd=chd_data([(0, h), (2, h)],
                                                         device="cpu"))
    ref_before = []
    jsim.step_hooks.append(lambda kper, kstp, delt: ref_before.append(
        bool(np.asarray(jsim.model.maw.shut)[0])))
    jrecs = jsim.run()
    head, after = sim.model.strt, []
    for kper, kstp, delt, pertim, totim in sim.tdis.walk():
        head = sim.do_step(head, kper, kstp, delt, pertim, totim)
        after.append(bool(sim.model.maw.shut[0]))
    assert all(r.converged for r in sim.records)
    # the reference's hooks run twice a step (do_step and solve_step)
    assert after[:-1] == ref_before[::2][1:]
    assert after[3:6] == [True] * 3 and not after[-1]
    for got, want in zip(sim.records, jrecs):
        np.testing.assert_allclose(got.head, want.head, atol=HEAD_ATOL)


def test_maw_condeqn_variants_match_reference_formulas():
    """THIEM/SKIN/CUMULATIVE/MEAN (maw_calculate_satcond eqs 1-4): the
    port's conductances equal the reference's and the closed forms."""
    grid = row_grid(3, 100.0, 10.0)
    jg, tg = JaxDisGrid.create(**grid), DisGrid.create(**grid)
    k11v, k22v = 8.0, 2.0
    r, srad, hks, thka = 0.25, 0.75, 0.5, 10.0
    sqrtk = np.sqrt(k11v * k22v)
    T2pi = 2 * np.pi * thka * sqrtk
    lc1 = np.log(np.sqrt(1e4 / (8 * np.pi)) / r) / T2pi
    lc2 = ((sqrtk * thka) / (hks * thka) - 1.0) * np.log(srad / r) / T2pi
    ravg, slen = 0.5 * (r + srad), srad - r
    closed = dict(THIEM=1.0 / lc1, SKIN=1.0 / lc2,
                  CUMULATIVE=1.0 / (lc1 + lc2),
                  MEAN=hks * 2 * np.pi * ravg * thka / slen)
    for eqn, want in closed.items():
        wells = [dict(radius=r, strt=5.0, connections=[(1, dict(
            condeqn=eqn, scrn_top=10.0, scrn_bot=0.0, hk_skin=hks,
            radius_skin=srad))])]
        got = build_maw(wells, tg, k11=np.full(3, k11v),
                        k22=torch.full((3,), k22v, dtype=torch.float64))
        ref = jadv.build_maw(wells, jg, k11=np.full(3, k11v),
                             k22=np.full(3, k22v))
        np.testing.assert_allclose(got["cond"], ref["cond"], rtol=1e-12)
        np.testing.assert_allclose(got["cond"][0], want, rtol=1e-12)


# -------------------------------------------------------- the wide table

def _grid_2x4x5():
    rng = np.random.default_rng(7)
    grid = dict(nlay=2, nrow=4, ncol=5, delr=100.0, delc=100.0, top=50.0,
                botm=np.stack([np.full((4, 5), 25.0), np.zeros((4, 5))]))
    kw = dict(k=np.exp(rng.normal(1.0, 0.5, 40)), strt=40.0,
              storage={"ss": 1e-5, "iconvert": 0}, chd=[(0, 45.0),
                                                        (19, 40.0)])
    return grid, kw


def _features():
    """Wells, lakes and reaches with repeated cells and rows: two wells in
    cell 7, a well in two layers, a lake with a table, a horizontal
    connection and three outlets (one coupled, one external, one back),
    reaches with a confluence, a cross section and a diversion."""
    wells = [dict(radius=0.25, strt=40.0, rate=-300.0, head_limit=30.0,
                  connections=[(7, 20.0), (27, 15.0)]),
             dict(radius=0.3, strt=40.0, rate=-50.0, connections=[(7, 10.0)],
                  pumpelev=20.0, reduction_length=5.0)]
    lakes = [dict(strt=42.0, surf_area=1e4, rainfall=5.0, evap=1.0,
                  connections=[(11, 2.0, 41.0), (12, 1.0, 39.0)]),
             dict(strt=41.0, surf_area=1e4,
                  connections=[(13, 3.0, 38.0), (14, 3.0, 30.0, 45.0, 1)],
                  table=[(30.0 + z, 1e4 * z, 1e4 + 10 * z)
                         for z in range(8)])]
    outlets = [dict(lake=0, to=1, type="weir", invert=41.5, width=2.0),
               dict(lake=1, to=-1, type="manning", invert=40.0, width=3.0,
                    rough=0.03, slope=1e-3),
               dict(lake=1, to=0, type="specified", rate=0.5)]
    reaches = [dict(node=2, cond=5.0, strtop=43.0, width=3.0, strt=43.3,
                    inflow=10.0, diversions=[dict(to=3, cprior="upto",
                                                  flow=2.0)]),
               dict(node=3, cond=5.0, strtop=42.0, width=3.0, strt=42.3,
                    upstream=[(0, 1.0)],
                    xsection=([0, 0.2, 0.5, 0.8, 1.0], [2, 0.5, 0, 0.5, 2])),
               dict(node=4, cond=5.0, strtop=41.0, width=3.0, strt=41.3,
                    upstream=[(1, 1.0), (3, 1.0)]),
               dict(node=9, cond=5.0, strtop=42.5, width=3.0, strt=42.6)]
    return wells, (lakes, outlets), reaches


def test_build_ext_table_equals_the_reference_loops():
    """Array code against the reference's loops, on edges with repeated
    pairs and rows, over a [N, 6] base table with self-padded slots."""
    rng = np.random.default_rng(1)
    N, R, Kb = 30, 7, 6
    base = np.tile(np.arange(N)[:, None], (1, Kb))
    base[:, :3] = rng.integers(0, N, (N, 3))
    edges = [(int(rng.integers(0, N)), N + int(rng.integers(0, R)))
             for _ in range(40)]
    edges += [(3, N), (3, N), (N + 1, N + 2), (N + 2, N + 1), (5, N + 6)]
    want = jadv._build_ext_table(base, N, R, edges)
    got = advanced._build_ext_table(base, N, R, np.asarray(edges))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[1] > Kb


@pytest.mark.parametrize("grid_kind", ["dis", "disv"])
def test_augmented_table_and_system_equal_the_reference(grid_kind):
    """The widened table (a DIS base: its [E, W, N, S, U, D] slots; a
    brick-pattern DISV base: its ELL table), the slots of every feature,
    the assembled system, steady and transient, the budget terms and the
    water each feature could give a mover."""
    from test_torch_unstructured import both_grids
    grid, kw = _grid_2x4x5()
    wells, lak, reaches = _features()
    if grid_kind == "dis":
        jg, tg = JaxDisGrid.create(**grid), DisGrid.create(**grid)
        jbase = jax_build_gwf("ref", jg, **kw)
        tbase = build_gwf("port", tg, device="cpu", **kw)
        assert tbase.use_structured
    else:
        jg, tg = both_grids("brick")
        kw["k"] = np.exp(np.random.default_rng(8).normal(1.0, 0.5,
                                                         tg.nodes))
        jbase = jax_build_gwf("ref", jg, **kw)
        tbase = build_gwf("port", tg, device="cpu", **kw)
        assert not tbase.use_structured
    jm = jadv.AugmentedGwfModel(jbase, maw=jadv.build_maw(wells, jg),
                                lak=jadv.build_lak(*lak),
                                sfr=jadv.build_sfr(reaches))
    tm = AugmentedGwfModel(tbase, maw=build_maw(wells, tg),
                           lak=build_lak(*lak), sfr=build_sfr(reaches))
    assert (tm.Ktot, tm.Kb, tm.n_extra) == (jm.Ktot, jm.Kb, jm.n_extra)
    np.testing.assert_array_equal(tm.dtopo.nbr.numpy(),
                                  np.asarray(jm.dtopo.nbr))
    got, want = augmented_state(tm), augmented_state(jm)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    rng = np.random.default_rng(2)
    x = np.asarray(jm.strt) + rng.normal(0.0, 0.5, jm.nodes)
    x_old = x + rng.normal(0.0, 0.1, jm.nodes)
    for iss in (False, True):
        assert_same_system(jm, tm, x, x_old, delt=2.0, iss=iss)
    bud = tm.advanced_budget(x_of(x), x_of(x_old), 2.0, False)
    ref = jm.advanced_budget(jnp.asarray(x), jnp.asarray(x_old), 2.0, False)
    assert bud.keys() == ref.keys()
    for key in bud:
        close(bud[key], ref[key])
    # what a mover could take from each feature (MVR waits for item 14b)
    for name in ("maw", "lak", "sfr"):
        off = getattr(tm, f"_{name}_offset")
        close(getattr(tm, name).available(x_of(x), off),
              getattr(jm, name).available(jnp.asarray(x), off))


def test_fused_step_equals_numerical_solution():
    """The fused step takes an augmented model: the same heads bit for bit
    and the same counts as NumericalSolution (both over the gather
    product), and the heads of the reference's solve."""
    grid, kw = _grid_2x4x5()
    wells, lak, reaches = _features()
    jm, tm = both(grid, kw, maw=wells, lak=lak, sfr=reaches)
    x = solve_both(jm, tm, delt=5.0, iss=False)
    s = ImsSettings(**SETTINGS)
    head, info, _ = NumericalSolution(tm, s).solve_timestep(tm.strt, 5.0)
    fhead, kiter, inner, conv = make_fused_step(tm, s, iss=False)(
        tm.strt, 5.0, 1)
    assert conv and (kiter, inner) == (info.outer_iterations,
                                       info.inner_iterations)
    assert torch.equal(fhead, head)
    np.testing.assert_array_equal(head.numpy(), x)


def test_convert_from_reference_builds_the_same_augmented_model():
    """from_reference with the reference model's maw_/lak_/sfr_ fields:
    the same table, slots and system; a slot that disagrees raises."""
    grid, kw = _grid_2x4x5()
    wells, lak, reaches = _features()
    jm, tm = both(grid, kw, maw=wells, lak=lak, sfr=reaches)
    arrays, kwargs = reference_arrays(jm.base)
    arrays.update(augmented_state(jm))
    cm = from_reference(arrays, device="cpu", grid=DisGrid.create(**grid),
                        **kwargs)
    assert isinstance(cm, AugmentedGwfModel)
    np.testing.assert_array_equal(cm.dtopo.nbr.numpy(), tm.dtopo.nbr.numpy())
    x = np.asarray(jm.strt) + 0.3
    assert_same_system(jm, cm, x, delt=3.0)
    bad = dict(arrays, maw_slot_cw=arrays["maw_slot_cw"] + 1)
    with pytest.raises(ValueError, match="maw_slot_cw"):
        from_reference(bad, device="cpu", grid=DisGrid.create(**grid),
                       **kwargs)


@pytest.mark.parametrize("stage", ["below", "knots", "between", "above",
                                   "padded"])
def test_table_interpolation_is_jnp_interp(stage):
    """``interp_rows`` against ``jax.vmap(jnp.interp)`` bitwise: clamped
    below the first and above the last stage, at the knots (the interval
    to the right), between them, on repeated stages and on padded rows."""
    import jax
    lakes = [dict(strt=0.0, surf_area=1.0, connections=[],
                  table=[(1.0, 0.0, 2.0), (2.0, 3.0, 4.0), (2.0, 5.0, 6.0),
                         (4.0, 9.0, 7.5)]),
             dict(strt=0.0, surf_area=1.0, connections=[],
                  table=[(-1.0, 0.0, 1.0), (0.5, 1.5, 3.0)]),
             dict(strt=0.0, surf_area=3.0, bottom=2.0, connections=[])]
    spec = build_lak(lakes)
    ref = jadv.build_lak(lakes)
    for key in ("tab_stage", "tab_volume", "tab_sarea"):
        np.testing.assert_array_equal(spec[key], ref[key])
    xp, fp = spec["tab_stage"], spec["tab_volume"]
    s = {"below": [0.5, -3.0, 1.0],
         "knots": [2.0, 0.5, float(xp[2, 1])],
         "between": [1.5, 0.1, float(xp[2, 1]) + 7.25],
         "above": [9.0, 4.0, 1e5],
         "padded": [float(xp[0, 3]) + 0.5, 1.0, 2.0]}[stage]
    s = np.asarray(s)
    got = advanced.interp_rows(x_of(s), x_of(xp), x_of(fp))
    want = jax.vmap(jnp.interp)(jnp.asarray(s), jnp.asarray(xp),
                                jnp.asarray(fp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------- the reference's faults, R1-R4

def test_r1_reference_thiem_well_takes_the_cell_area():
    """R1: the reference's build_maw overwrites its per-well ``area`` list
    with the last THIEM connection's cell area (advanced.py:320), so one
    THIEM well stores as a 100 × 100 cell; and a second well after it
    fails on the list's append.  The port keeps π r² for every well, with
    the same conductances."""
    grid = row_grid(3, 100.0, 10.0)
    jg, tg = JaxDisGrid.create(**grid), DisGrid.create(**grid)
    thiem = dict(radius=0.25, strt=5.0, connections=[(1, -1.0)])
    k = np.full(3, 4.0)
    ref = jadv.build_maw([thiem], jg, k11=k)
    got = build_maw([thiem], tg, k11=k)
    np.testing.assert_allclose(np.asarray(ref["area"]), 1e4)
    np.testing.assert_allclose(got["area"], [np.pi * 0.25 ** 2])
    np.testing.assert_allclose(got["cond"], ref["cond"], rtol=1e-12)
    spec = [thiem, dict(radius=0.5, strt=5.0, connections=[(2, 3.0)])]
    with pytest.raises(AttributeError, match="append"):
        jadv.build_maw(spec, jg, k11=k)
    np.testing.assert_allclose(build_maw(spec, tg, k11=k)["area"],
                               [np.pi * 0.25 ** 2, np.pi * 0.25])


def test_r3_r4_refused_with_features():
    """R3: CSUB beside a feature package runs without CSUB in the
    reference; R4: XT3D under an augmented model cannot be built there.
    The port raises by name for both, and for rewetting and TVK/TVS; the
    multigrid preconditioner runs as Chebyshev there, as in the
    reference.  MVR is ported: a mover whose receiver
    the model lacks raises the reference's ValueError, and a model
    without movers reports none."""
    grid = row_grid(4, 10.0, 10.0)
    maw = build_maw([dict(radius=0.2, strt=5.0, connections=[(1, 1.0)])],
                    DisGrid.create(**grid))
    base = dict(k=1.0, strt=5.0, chd=[(0, 5.0)],
                storage={"ss": 1e-5, "iconvert": 0})
    csub = dict(interbeds=[(1, 1.0, 1e-4, 1e-2, 0.3)], cg_ske_cr=1e-5,
                cg_theta=0.2)
    for extra, what in ((dict(csub=csub), "CSUB"), (dict(xt3d=1), "XT3D"),
                        (dict(icelltype=1, rewetting=dict(
                            wetdry=np.full(4, 0.1))), "rewetting")):
        model = build_gwf("m", DisGrid.create(**grid), device="cpu",
                          **base, **extra)
        with pytest.raises(NotImplementedError, match=what):
            AugmentedGwfModel(model, maw=maw)
    model = build_gwf("m", DisGrid.create(**grid), device="cpu", **base)
    with pytest.raises(ValueError, match="receiver 'sfr' not present"):
        AugmentedGwfModel(model, maw=maw, mvr=[dict(
            provider="maw", iprov=0, receiver="sfr", ircv=0,
            mvrtype="factor", value=1.0)])
    aug = AugmentedGwfModel(model, maw=maw)
    assert aug.mvr is None and aug.mvr_budget(aug.strt) == []
    # MG on an augmented model runs as Chebyshev (order >= 4), as the
    # reference's _make_precond gives any model off the structured path
    mg = dict(preconditioner="mg", outer_dvclose=1e-9, inner_dvclose=1e-11,
              inner_rclose=1e-10, inner_maximum=200)
    head, info, _ = NumericalSolution(aug, ImsSettings(**mg)) \
        .solve_timestep(aug.strt, 1.0)
    jaug0 = jadv.AugmentedGwfModel(
        jax_build_gwf("ref", JaxDisGrid.create(**grid), **base),
        maw=jadv.build_maw([dict(radius=0.2, strt=5.0,
                                 connections=[(1, 1.0)])],
                           JaxDisGrid.create(**grid)))
    jhead, jinfo, _ = JaxSolution(jaug0, JaxImsSettings(**mg)) \
        .solve_timestep(jaug0.strt, 1.0)
    assert info.converged and jinfo.converged
    assert info.outer_iterations == jinfo.outer_iterations
    np.testing.assert_allclose(head.numpy(), np.asarray(jhead), rtol=0,
                               atol=1e-8)
    sim = Simulation(Tdis((StressPeriod(1.0, 1, 1.0),)), aug, ImsSettings())
    sim.tvk = {1: [(1, "K", 2.0)]}
    with pytest.raises(NotImplementedError, match="TVK"):
        sim.run()
    # the reference runs the CSUB base without its CSUB terms (R3)
    jbase = jax_build_gwf("ref", JaxDisGrid.create(**grid), **base,
                          csub=csub)
    jaug = jadv.AugmentedGwfModel(jbase, maw=jadv.build_maw(
        [dict(radius=0.2, strt=5.0, connections=[(1, 1.0)])],
        JaxDisGrid.create(**grid)))
    assert getattr(jaug, "csub", None) is None


def test_two_wells_in_one_cell_sum_in_entry_order():
    """C1: WEL and RIV entries that share a node are summed by the data
    object's plan in entry order, bitwise what the CPU's index_add gives,
    with padded (masked) entries left out."""
    from modflow6_torch.models.gwf import bnd
    from modflow6_torch.models.gwf.builder import riv_data, wel_data
    rng = np.random.default_rng(4)
    wel = wel_data([(3, -1.5), (3, -2.25), (5, 7.0), (3, 1e-3)],
                   maxbound=7, device="cpu")
    riv = riv_data([(2, 5.0, 0.3, 1.0), (2, 5.5, 0.7, 1.0)], device="cpu")
    assert [len(r[0]) for r in wel.add_plan.rounds] == [2, 1, 1]
    d0 = torch.tensor(rng.normal(size=8))
    r0 = torch.tensor(rng.normal(size=8))
    for data in (wel, riv):
        hcof = torch.tensor(rng.normal(size=data.node.shape[0]))
        rhs = torch.tensor(rng.normal(size=data.node.shape[0]))
        got = bnd.scatter_terms(d0, r0, data, hcof, rhs)
        want = (d0.index_add(0, data.node, torch.where(data.mask, hcof, 0.0)),
                r0.index_add(0, data.node, torch.where(data.mask, rhs, 0.0)))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
