"""PRT's ternary method on DISV grids in the port
(modflow6_torch/models/prt/tracking_disv.py) against the reference
(modflow6_tpu/models/prt/tracking_disv.py): the fan and ``locate``
builders equal to the reference's loops, the scenarios of
tests/test_prt_disv.py, and the fan chain's mass balance.  The DIS and
driver tests are in test_torch_prt.py, whose helpers these use.

Bars: the fan's fluxes bitwise or within 1e-12; the scenarios at
tests/test_prt_disv.py's own tolerances, with statuses equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_prt import FLOW, _np, flow_pair, port_step
from modflow6_tpu.models.discretization.disv import DisvGrid as JaxDisvGrid
from modflow6_tpu.models.gwf import npf as jnpf
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.prt import tracking_disv as jtracking_disv
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxSolution
from modflow6_torch.models.discretization import DisvGrid
from modflow6_torch.models.gwf import npf
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.prt import tracking, tracking_disv
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.ims import NumericalSolution


# ------------------------------------------------------------ DISV fans

def rect_disv_args(nrow, ncol, d=1.0):
    """tests/test_prt_disv.py:rect_disv's arguments."""
    verts = [(c * d, (nrow - r) * d) for r in range(nrow + 1)
             for c in range(ncol + 1)]
    w = ncol + 1
    cell2d = [((c + 0.5) * d, (nrow - r - 0.5) * d,
               [r * w + c, r * w + c + 1, r * w + c + 1 + w, r * w + c + w])
              for r in range(nrow) for c in range(ncol)]
    return (1, nrow * ncol, np.asarray(verts, float), cell2d, 1.0,
            np.zeros((1, nrow * ncol)))


def brick_args(nrow, ncol, nlay=2, seed=3):
    """A brick-pattern mesh (hexagon-like cells of six vertices, clockwise
    and counterclockwise rings mixed) in ``nlay`` layers."""
    rng = np.random.default_rng(seed)
    verts, cells, index = [], [], {}

    def vid(x, y):
        if (x, y) not in index:
            index[(x, y)] = len(verts)
            verts.append((x, y))
        return index[(x, y)]

    for r in range(nrow):
        off = 0.5 * (r % 2)
        for c in range(ncol):
            x0, x1, y0, y1 = c + off, c + 1 + off, nrow - r - 1.0, nrow - r
            ring = [vid(x0, y1), vid(x0 + 0.5, y1), vid(x1, y1),
                    vid(x1, y0), vid(x0 + 0.5, y0), vid(x0, y0)]
            if rng.random() < 0.5:
                ring = ring[::-1]
            cells.append((x0 + 0.5, y0 + 0.5, ring))
    ncpl = len(cells)
    botm = np.stack([np.full(ncpl, -1.0 - i) for i in range(nlay)])
    return (nlay, ncpl, np.asarray(verts, float), cells, 0.0, botm)


def disv_pair(args, **model):
    tg, jg = DisvGrid.create(*args), JaxDisvGrid.create(*args)
    tm = build_gwf("f", tg, device="cpu", **model)
    jm = jax_build_gwf("f", jg, **model)
    th, ti, ta = NumericalSolution(tm, ImsSettings(**FLOW)).solve_timestep(
        tm.strt, 1.0, iss=True)
    jh, ji, ja = JaxSolution(jm, JaxImsSettings(**FLOW)).solve_timestep(
        jm.strt, 1.0, iss=True)
    assert ti.converged and ji.converged
    return (tg, tm, th, ta), (jg, jm, jh, ja)


def disv_runs(port, ref, theta, pts, tmax):
    (tg, tm, th, ta), (jg, jm, jh, ja) = port, ref
    fan = tracking_disv.build_fan(tg, tm.topo, np.full(tg.nodes, theta))
    q = tm.edge_flows(th, ta["ibound"], ta["cond"])
    flux = tracking_disv.fan_fluxes(fan, q)
    sat = npf.compute_saturation(tm.npf_opts, tm.npf_arrays, th,
                                 ta["ibound"]).reshape(tg.nlay, tg.ncpl)
    lay, cell, tri = tracking_disv.locate(fan, *pts)

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    out = tracking_disv.make_tracker_disv(fan)(
        t(pts[0]), t(pts[1]), t(pts[2]), t(lay, torch.int64),
        t(cell, torch.int64), t(tri, torch.int64), *flux, sat, tmax)
    jfan = jtracking_disv.build_fan(jg, jm.topo, np.full(jg.nodes, theta))
    jq = jm.edge_flows(jh, ja["ibound"], ja["cond"])
    jflux = jtracking_disv.fan_fluxes(jfan, jq)
    jsat = jnpf.compute_saturation(jm.npf_opts, jm.npf_arrays, jh,
                                   ja["ibound"]).reshape(jg.nlay, jg.ncpl)
    jl, jc, jt = jtracking_disv.locate(jfan, *pts)
    jout = jtracking_disv.make_tracker_disv(jfan)(
        *(jnp.asarray(np.asarray(p, float)) for p in pts), jnp.asarray(jl),
        jnp.asarray(jc), jnp.asarray(jt), *jflux, jsat, tmax)
    return (fan, flux, (lay, cell, tri), out), (jfan, jflux, (jl, jc, jt),
                                                jout)


RECT34 = dict(k=3.0, strt=10.0, wel=[(5, -0.7)],
              chd=[(r * 4, 11.0) for r in range(3)]
              + [(r * 4 + 3, 10.0) for r in range(3)])


@pytest.fixture(scope="module")
def rect34():
    """tests/test_prt_disv.py's mass-balance model."""
    return disv_pair(rect_disv_args(3, 4), **RECT34)


@pytest.mark.parametrize("mesh", ["rect", "brick"])
def test_fan_and_locate_equal_the_reference_loops(mesh, rect34):
    if mesh == "rect":
        port, ref = rect34
        rng = np.random.default_rng(0)
        pts = (np.concatenate([rng.uniform(0, 4, 40), [1.0, 2.0, 0.5]]),
               np.concatenate([rng.uniform(0, 3, 40), [1.0, 2.0, 0.5]]),
               np.concatenate([rng.uniform(0, 1, 40), [1.0, 0.0, 2.0]]))
    else:
        args = brick_args(6, 7)
        ncpl = args[1]
        model = dict(k=2.0, strt=10.0, wel=[(ncpl + 20, -0.5)],
                     chd=[(0, 11.0), (ncpl - 1, 10.0)])
        rng = np.random.default_rng(1)
        pts = (rng.uniform(0.6, 7.0, 50), rng.uniform(0.1, 5.9, 50),
               rng.uniform(-1.9, -0.1, 50))
        port, ref = disv_pair(args, **model)
    (fan, flux, loc, out), (jfan, jflux, jloc, jout) = disv_runs(
        port, ref, 0.3, pts, 50.0)
    for name in ("px", "py", "qx", "qy", "cx", "cy", "tri_area", "nact",
                 "valid", "nbr_cell", "nbr_tri", "edge3d", "edge_sign",
                 "cell_area", "topz", "botz", "porosity", "active_cell",
                 "vedge_up", "vedge_dn", "vsign_up", "vsign_dn"):
        np.testing.assert_array_equal(_np(getattr(fan, name)),
                                      np.asarray(getattr(jfan, name)),
                                      err_msg=name)
    for g, w in zip(loc, jloc):
        np.testing.assert_array_equal(g, np.asarray(w))
    for g, w in zip(flux, jflux):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-12,
                                   atol=1e-12 * np.abs(np.asarray(w)).max())
    for key in ("status", "lay", "cell", "tri", "transitions"):
        np.testing.assert_array_equal(_np(out[key]), _np(jout[key]),
                                      err_msg=key)
    for key in ("x", "y", "z", "time"):
        np.testing.assert_allclose(_np(out[key]), _np(jout[key]),
                                   rtol=1e-9, atol=1e-9, err_msg=key)


def test_disv_uniform_flow_straight_line():
    nrow, ncol, theta, q, k = 3, 20, 0.25, 0.5, 10.0
    dh = q * (ncol - 1) / k
    port, ref = disv_pair(rect_disv_args(nrow, ncol), k=k, strt=10.0,
                          chd=[(r * ncol, 10.0 + dh) for r in range(nrow)]
                          + [(r * ncol + ncol - 1, 10.0)
                             for r in range(nrow)])
    pts = (np.array([2.5, 3.3]), np.array([1.5, 0.7]), np.array([0.5, 0.5]))
    *_, out = disv_runs(port, ref, theta, pts, 4.0)[0]
    v = q / theta
    np.testing.assert_allclose(_np(out["x"]), [2.5 + v * 4, 3.3 + v * 4],
                               rtol=1e-9)
    np.testing.assert_allclose(_np(out["y"]), [1.5, 0.7], atol=1e-9)
    assert (_np(out["status"]) == tracking_disv.TERM_TIMEOUT).all()
    np.testing.assert_allclose(_np(out["time"]), 4.0, rtol=1e-12)


def test_disv_travel_time_matches_dis_pollock():
    n, theta = 11, 0.3
    chd = ([(i, 10.0) for i in range(n)]
           + [((n - 1) * n + i, 10.0) for i in range(n)]
           + [(r * n, 10.0) for r in range(1, n - 1)]
           + [(r * n + n - 1, 10.0) for r in range(1, n - 1)])
    well = (n // 2) * n + n // 2
    kw = dict(k=10.0, strt=10.0, chd=chd, wel=[(well, -3.0)])
    port_d, _ = flow_pair((1, n, n, 1.0, 1.0, 1.0, np.zeros((1, n, n))),
                          **kw)
    pts = ([2.3], [5.5], [0.5])
    out_d = port_step(*port_d[1:], theta, pts, 1e9)
    assert int(out_d["status"][0]) == tracking.TERM_WEAK
    port, ref = disv_pair(rect_disv_args(n, n), **kw)
    (_, _, _, out_v), (_, _, _, jout_v) = disv_runs(port, ref, theta, pts,
                                                    1e9)
    assert int(out_v["status"][0]) == int(jout_v["status"][0]) \
        == tracking_disv.TERM_WEAK
    np.testing.assert_allclose(float(out_v["time"][0]),
                               float(out_d["time"][0]), rtol=0.08)
    np.testing.assert_allclose(float(out_v["time"][0]),
                               float(jout_v["time"][0]), rtol=1e-9)
    assert int(out_v["cell"][0]) == well


def test_disv_internal_fan_chain_mass_balance(rect34):
    tg, tm, th, ta = rect34[0]
    fan = tracking_disv.build_fan(tg, tm.topo, np.full(tg.nodes, 0.3))
    Qout, u, qzt, qzb = tracking_disv.fan_fluxes(
        fan, tm.edge_flows(th, ta["ibound"], ta["cond"]))
    share = fan.tri_area / fan.cell_area[:, None]
    resid = Qout.sum(dim=2)
    bal = (Qout + qzt + qzb - resid[:, :, None] * share[None] + u
           - torch.roll(u, 1, dims=2))
    bal = torch.where(fan.valid[None], bal, 0.0)
    np.testing.assert_allclose(_np(bal), 0.0, atol=1e-12)


# ------------------------------------------------------ PrtDriver in runs
