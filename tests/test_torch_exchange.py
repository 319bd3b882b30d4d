"""Several GWF models joined by GWF6-GWF6 exchanges in the port
(modflow6_torch/models/gwf/exchange.py, ``concat_topologies``, the
loader's several models, exchanges and exchange movers) against the
reference (modflow6_tpu/models/gwf/exchange.py and its loader): the merged
topology and arrays, the solves of tests/test_exchange.py, the decks of
tests/test_mf6io_multi.py and tests/test_exchange_mvr.py through both
loaders, the merged model's output files, and what both refuse.

Tolerances: the merged topology, cell arrays and packages: equal arrays;
the merged model's condsat per edge against the reference's: 1e-14; heads
of CG solves within 1e-10 of the reference's, with equal counts; BiCGSTAB
decks within 10 × OUTER_DVCLOSE (ROADMAP Queue C).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from test_exchange_mvr import _model_files
from test_mf6io_multi import build_split_deck, write
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.discretization.topology import (
    concat_topologies as ref_concat)
from modflow6_tpu.models.gwf import exchange as jexg
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxSolution
from modflow6_tpu.utils.binary import read_head_file as ref_read_heads
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.convert import from_reference
from modflow6_torch.models.discretization import DisGrid, DisvGrid
from modflow6_torch.models.discretization.topology import concat_topologies
from modflow6_torch.models.gwf import exchange
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.ims import NumericalSolution
from modflow6_torch.utils.mf6io import load_simulation

HEAD_ATOL = 1e-10
# tests/test_exchange.py:17-20
SETTINGS = dict(outer_dvclose=1e-10, outer_maximum=60, inner_dvclose=1e-12,
                inner_rclose=1e-11, inner_maximum=2000)
TOPOLOGY = ("edge_n", "edge_m", "ihc", "cl1", "cl2", "hwva", "direction",
            "anglex", "nbr", "slot_nm", "slot_mn")


def half_grids(nrow, ncol, nlay=1):
    botm = np.zeros((nlay, nrow, ncol))
    for k in range(nlay):
        botm[k] = -5.0 * (k + 1)
    return dict(nlay=nlay, nrow=nrow, ncol=ncol, delr=10.0, delc=10.0,
                top=10.0, botm=botm)


def split_2d(nrow=8, ncol=12, nlay=2):
    """tests/test_exchange.py::test_two_model_2d_transient_matches_single
    (two layers here): west and east halves, CHD on the west column, a
    well and seeded K in the east, a pair per row and layer."""
    half = ncol // 2
    rng = np.random.default_rng(3)
    k = rng.lognormal(0.5, 0.4, (2, nlay * nrow * half))
    kw = dict(strt=6.0, storage={"ss": 1e-4, "iconvert": 0})
    west = dict(k=k[0], chd=[(r * half, 9.0) for r in range(nrow)], **kw)
    east = dict(k=k[1], wel=[(3 * half + 3, -40.0)], **kw)
    pairs = [jexg.ExchangePair(node1=lay * nrow * half + r * half + half - 1,
                               node2=lay * nrow * half + r * half, ihc=1,
                               cl1=5.0, cl2=5.0, hwva=10.0 if lay == 0
                               else 7.0)
             for lay in range(nlay) for r in range(nrow)]
    return half_grids(nrow, half, nlay), (west, east), pairs


def both_merged(grid, kws, pairs):
    """(reference, port) merged models of the members ``kws`` on ``grid``,
    joined 0-1 by ``pairs``."""
    jms = [jax_build_gwf(f"m{i}", JaxDisGrid.create(**grid), **kw)
           for i, kw in enumerate(kws)]
    tms = [build_gwf(f"m{i}", DisGrid.create(**grid), device="cpu", **kw)
           for i, kw in enumerate(kws)]
    tpairs = [exchange.ExchangePair(**vars(p)) for p in pairs]
    return (jexg.merge_gwf_models(jms, [jexg.GwfGwfExchange(0, 1, pairs)]),
            exchange.merge_gwf_models(
                tms, [exchange.GwfGwfExchange(0, 1, tpairs)]))


def test_concat_topologies_equals_reference():
    g1 = DisGrid.create(**half_grids(3, 4, 2))
    g2 = DisGrid.create(**half_grids(2, 5))
    jg1 = JaxDisGrid.create(**half_grids(3, 4, 2))
    jg2 = JaxDisGrid.create(**half_grids(2, 5))
    got = concat_topologies([g1.build_edge_topology(),
                             g2.build_edge_topology()], [0, 24])
    want = ref_concat([jg1.build_topology(), jg2.build_topology()], [0, 24])
    assert got.nodes == want.nodes
    for name in TOPOLOGY:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def test_merge_equals_reference():
    """The merged topology (member edges shifted, exchange edges appended
    and sorted), its ELL table, the cell arrays and the concatenated
    packages equal the reference's; condsat to rounding; split_heads."""
    grid, kws, pairs = split_2d()
    jm, tm = both_merged(grid, kws, pairs)
    assert tm.dtopo.grid_shape is None and not tm.use_structured
    for name in TOPOLOGY:
        np.testing.assert_array_equal(getattr(tm.topo, name),
                                      getattr(jm.topo, name), err_msg=name)
    np.testing.assert_array_equal(tm.grid.offsets, jm._offsets)
    for name in ("area", "top", "bot", "idomain"):
        np.testing.assert_array_equal(getattr(tm.grid, name),
                                      getattr(jm.grid, name), err_msg=name)
    for name in ("icelltype", "k11", "k22", "k33", "top", "bot"):
        np.testing.assert_array_equal(
            getattr(tm.npf_arrays, name).numpy(),
            np.asarray(getattr(jm.npf_arrays, name)), err_msg=name)
    np.testing.assert_allclose(tm.npf_arrays.condsat.numpy(),
                               np.asarray(jm.npf_arrays.condsat),
                               rtol=1e-14)
    for pkg in ("chd", "wel"):
        for f in ("node", "mask"):
            np.testing.assert_array_equal(
                getattr(getattr(tm, pkg), f).numpy(),
                np.asarray(getattr(getattr(jm, pkg), f)))
    h = np.arange(tm.nodes, dtype=float)
    for g, w in zip(exchange.split_heads(tm, h), jexg.split_heads(jm, h)):
        np.testing.assert_array_equal(g, w)


def test_two_model_1d_matches_single():
    """tests/test_exchange.py:23: the merged 1-D problem against the
    reference's merged run and the single model, in both packages."""
    ncol, half = 20, 10
    full = dict(nlay=1, nrow=1, ncol=ncol, delr=10.0, delc=10.0, top=10.0,
                botm=np.zeros((1, 1, ncol)))
    single = build_gwf("full", DisGrid.create(**full), device="cpu", k=4.0,
                       strt=6.0, chd=[(0, 9.0), (ncol - 1, 5.0)])
    h_full, info, _ = NumericalSolution(single, ImsSettings(
        **SETTINGS)).solve_timestep(single.strt, 1.0, iss=True)
    assert info.converged
    grid = dict(full, ncol=half, botm=np.zeros((1, 1, half)))
    kws = [dict(k=4.0, strt=6.0, chd=[(0, 9.0)]),
           dict(k=4.0, strt=6.0, chd=[(half - 1, 5.0)])]
    jm, tm = both_merged(grid, kws, [jexg.ExchangePair(
        half - 1, 0, ihc=1, cl1=5.0, cl2=5.0, hwva=10.0)])
    hj, ij, _ = JaxSolution(jm, JaxImsSettings(**SETTINGS)).solve_timestep(
        jnp.asarray(jm.strt), 1.0, iss=True)
    ht, it, _ = NumericalSolution(tm, ImsSettings(**SETTINGS)) \
        .solve_timestep(tm.strt, 1.0, iss=True)
    assert it.converged
    assert (it.outer_iterations, it.inner_iterations) == \
        (ij.outer_iterations, ij.inner_iterations)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                               atol=HEAD_ATOL)
    np.testing.assert_allclose(np.concatenate(exchange.split_heads(tm, ht)),
                               h_full.numpy(), rtol=1e-10)


def test_two_model_2d_transient_matches_reference():
    """The 2-D split with storage and a well, two layers with seeded K:
    four transient steps in both packages, equal counts, heads within
    1e-10; the reference's merged model converted to the port's runs to
    the same heads."""
    grid, kws, pairs = split_2d()
    jm, tm = both_merged(grid, kws, pairs)
    jsol = JaxSolution(jm, JaxImsSettings(**SETTINGS))
    tsol = NumericalSolution(tm, ImsSettings(**SETTINGS))
    hj, ht = jnp.asarray(jm.strt), tm.strt
    for kstp in range(1, 5):
        hj, ij, _ = jsol.solve_timestep(hj, 5.0, kstp=kstp, iss=False)
        ht, it, _ = tsol.solve_timestep(ht, 5.0, kstp=kstp, iss=False)
        assert it.converged
        assert (it.outer_iterations, it.inner_iterations) == \
            (ij.outer_iterations, ij.inner_iterations)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0,
                               atol=HEAD_ATOL)
    # the converted model: the reference's merged arrays on the general
    # path, its offsets making the grid a MergedGrid
    a = jm.npf_arrays
    t = jm.topo
    arrays = dict(k11=a.k11, k22=a.k22, k33=a.k33, icelltype=a.icelltype,
                  top=a.top, bot=a.bot, strt=jm.strt, ibound0=jm.ibound0,
                  area=jm.grid.area, angle1=a.angle1, angle2=a.angle2,
                  angle3=a.angle3, condsat=a.condsat, offsets=jm._offsets,
                  sto_iconvert=jm.sto_arrays.iconvert,
                  sto_ss=jm.sto_arrays.ss, sto_sy=jm.sto_arrays.sy,
                  **{f"chd_{f}": getattr(jm.chd, f) for f in
                     ("node", "head", "mask")},
                  **{f"wel_{f}": getattr(jm.wel, f) for f in
                     ("node", "q", "mask")},
                  **{k: getattr(t, k) for k in TOPOLOGY if k != "direction"})
    import dataclasses
    cm = from_reference({k: np.asarray(v) for k, v in arrays.items()},
                        grid_shape=None,
                        npf_options=dataclasses.asdict(jm.npf_opts),
                        sto_options=dataclasses.asdict(jm.sto_opts),
                        device="cpu")
    csol = NumericalSolution(cm, ImsSettings(**SETTINGS))
    hc = cm.strt
    for kstp in range(1, 5):
        hc, _, _ = csol.solve_timestep(hc, 5.0, kstp=kstp, iss=False)
    np.testing.assert_allclose(hc.numpy(), ht.numpy(), rtol=0,
                               atol=HEAD_ATOL)
    np.testing.assert_array_equal(cm.grid.offsets, tm.grid.offsets)


def test_merge_of_a_disv_and_a_dis_member():
    """Members on different grid types merge on the general path: a DISV
    member's own edge table and a DIS member's grid edges, as the
    reference merges them."""
    from modflow6_tpu.models.discretization.disv import DisvGrid as JDisvGrid
    verts = [(0.0, 20.0), (10.0, 20.0), (20.0, 20.0), (0.0, 10.0),
             (10.0, 10.0), (20.0, 10.0), (0.0, 0.0), (10.0, 0.0),
             (20.0, 0.0)]
    cells = [(5.0, 15.0, [0, 1, 4, 3]), (15.0, 15.0, [1, 2, 5, 4]),
             (5.0, 5.0, [3, 4, 7, 6]), (15.0, 5.0, [4, 5, 8, 7])]
    args = dict(nlay=1, ncpl=4, vertices=verts, cell2d=cells, top=10.0,
                botm=np.zeros((1, 4)))
    dis = dict(nlay=1, nrow=2, ncol=2, delr=10.0, delc=10.0, top=10.0,
               botm=np.zeros((1, 2, 2)))
    jms = [jax_build_gwf("v", JDisvGrid.create(**args), k=2.0, strt=5.0,
                         chd=[(0, 6.0)]),
           jax_build_gwf("d", JaxDisGrid.create(**dis), k=3.0, strt=5.0)]
    tms = [build_gwf("v", DisvGrid.create(**args), device="cpu", k=2.0,
                     strt=5.0, chd=[(0, 6.0)]),
           build_gwf("d", DisGrid.create(**dis), device="cpu", k=3.0,
                     strt=5.0)]
    pairs = [(1, 0), (3, 2)]
    jm = jexg.merge_gwf_models(jms, [jexg.GwfGwfExchange(0, 1, [
        jexg.ExchangePair(a, b, cl1=5.0, cl2=5.0, hwva=10.0)
        for a, b in pairs])])
    tm = exchange.merge_gwf_models(tms, [exchange.GwfGwfExchange(0, 1, [
        exchange.ExchangePair(a, b, cl1=5.0, cl2=5.0, hwva=10.0)
        for a, b in pairs])])
    for name in TOPOLOGY:
        np.testing.assert_array_equal(getattr(tm.topo, name),
                                      getattr(jm.topo, name), err_msg=name)
    np.testing.assert_allclose(tm.npf_arrays.condsat.numpy(),
                               np.asarray(jm.npf_arrays.condsat),
                               rtol=1e-14)


def test_merge_refusals():
    """Mismatched NPF options or Newton settings raise ValueError in both
    (tests/test_exchange.py::test_exchange_requires_matching_options);
    what the reference's merge drops without a word raises by name."""
    grid = dict(nlay=1, nrow=1, ncol=4, delr=10.0, delc=10.0, top=10.0,
                botm=np.zeros((1, 1, 4)))
    a = build_gwf("a", DisGrid.create(**grid), device="cpu", k=1.0, strt=1.0)
    pair = [exchange.GwfGwfExchange(0, 1, [exchange.ExchangePair(3, 0)])]
    for kw in (dict(newton=True, icelltype=1), dict(icellavg=1)):
        b = build_gwf("b", DisGrid.create(**grid), device="cpu", k=1.0,
                      strt=1.0, **kw)
        with pytest.raises(ValueError, match="matching"):
            exchange.merge_gwf_models([a, b], pair)
    for kw, what in ((dict(xt3d=1), "XT3D"),
                     (dict(hfb=[(0, 1, 1e-3)]), "HFB"),
                     (dict(icelltype=1, rewetting=dict(
                         wetdry=np.full(4, 0.1))), "rewetting"),
                     (dict(storage={"ss": 1e-5}), "STO")):
        b = build_gwf("b", DisGrid.create(**grid), device="cpu", k=1.0,
                      strt=1.0, **kw)
        with pytest.raises((NotImplementedError, ValueError), match=what):
            exchange.merge_gwf_models([a, b] if what != "XT3D" else [b, a],
                                      pair)


# ----------------------------------------------------------------- decks

def test_two_model_exchange_deck_matches_reference(tmp_path):
    """tests/test_mf6io_multi.py::test_two_model_exchange_matches_single
    through both loaders (CG): equal counts, heads within 1e-10 and of
    the unsplit model; the merged heads file holds the merged rows and no
    .grb is written (the reference's Simulation cannot write a merged
    model's heads file: its 1-D grid shape is not a layer array, so its
    solve is compared here); the budget closes."""
    ws = str(tmp_path)
    nrow, ncol = 6, 10
    build_split_deck(ws, nrow, ncol)
    write(ws, "west.oc", "BEGIN OPTIONS\n  HEAD FILEOUT merged.hds\n"
          "  BUDGET FILEOUT merged.cbc\nEND OPTIONS\nBEGIN PERIOD 1\n"
          "  SAVE HEAD ALL\n  SAVE BUDGET ALL\nEND PERIOD\n")
    nam = (tmp_path / "west.nam").read_text().replace(
        "  CHD6 west.chd chd", "  CHD6 west.chd chd\n  OC6 west.oc oc")
    (tmp_path / "west.nam").write_text(nam)
    sim = load_simulation(ws, device="cpu")
    ref = ref_load(ws)
    assert isinstance(sim.model.grid, exchange.MergedGrid)
    recs = sim.run()
    jrecs = ref.solution.solve_timestep(jnp.asarray(ref.model.strt), 1.0,
                                        iss=True)
    assert recs[0].converged
    assert (recs[0].outer, recs[0].inner) == (
        jrecs[1].outer_iterations, jrecs[1].inner_iterations)
    np.testing.assert_allclose(recs[0].head, np.asarray(jrecs[0]), rtol=0,
                               atol=HEAD_ATOL)
    half = ncol // 2
    h3 = np.concatenate([recs[0].head[:nrow * half].reshape(nrow, half),
                         recs[0].head[nrow * half:].reshape(nrow, half)],
                        axis=1)
    single = build_gwf("ref", DisGrid.create(1, nrow, ncol, 100.0, 100.0,
                                             0.0, -100.0 * np.ones(
                                                 (1, nrow, ncol))),
                       device="cpu", k=5.0, strt=7.0,
                       chd=[(i * ncol, 10.0) for i in range(nrow)]
                       + [(i * ncol + ncol - 1, 4.0) for i in range(nrow)])
    h_ref, _, _ = NumericalSolution(single, ImsSettings(
        outer_dvclose=1e-8, inner_dvclose=1e-10, inner_rclose=1e-8,
        inner_maximum=500)).solve_timestep(single.strt, 1.0, iss=True)
    np.testing.assert_allclose(h3.reshape(-1), h_ref.numpy(), atol=1e-7)
    heads = ref_read_heads(os.path.join(ws, "merged.hds"))
    assert len(heads) == 1 and heads[0]["data"].shape == (1, nrow * ncol)
    np.testing.assert_array_equal(heads[0]["data"][0], recs[0].head)
    assert not any(f.endswith(".grb") for f in os.listdir(ws))
    assert abs(sim.budget.percent_discrepancy()) < 1e-6


def write_exchange_mvr_deck(ws, exg_period2=False):
    """tests/test_exchange_mvr.py's two models, each with two reaches, the
    exchange's MVR6 moving A's terminal outflow into B's first reach."""
    write(ws, "mfsim.nam", """BEGIN TIMING
  TDIS6 sim.tdis
END TIMING
BEGIN MODELS
  GWF6 a.nam M1
  GWF6 b.nam M2
END MODELS
BEGIN EXCHANGES
  GWF6-GWF6 ab.exg M1 M2
END EXCHANGES
BEGIN SOLUTIONGROUP 1
  IMS6 sim.ims M1 M2
END SOLUTIONGROUP
""")
    write(ws, "sim.tdis", "BEGIN DIMENSIONS\n  NPER 1\nEND DIMENSIONS\n"
          "BEGIN PERIODDATA\n  20000.0 5 1.0\nEND PERIODDATA\n")
    write(ws, "sim.ims", """BEGIN NONLINEAR
  OUTER_DVCLOSE 1.0e-8
  OUTER_MAXIMUM 200
END NONLINEAR
BEGIN LINEAR
  INNER_MAXIMUM 500
  INNER_DVCLOSE 1.0e-10
  INNER_RCLOSE 1.0e-9
  LINEAR_ACCELERATION BICGSTAB
END LINEAR
""")
    _model_files(ws, "a", 30.0)
    _model_files(ws, "b", 30.0)
    write(ws, "ab.exg", "BEGIN OPTIONS\n  MVR6 FILEIN ab.mvr\nEND OPTIONS\n"
          "BEGIN DIMENSIONS\n  NEXG 1\nEND DIMENSIONS\nBEGIN EXCHANGEDATA\n"
          "  1 1 4 1 1 1 1 50.0 50.0 100.0\nEND EXCHANGEDATA\n")
    for tag, inflow in (("a", "  1 INFLOW 2.0\n"), ("b", "")):
        write(ws, f"{tag}.sfr", f"""BEGIN DIMENSIONS
  NREACHES 2
END DIMENSIONS
BEGIN PACKAGEDATA
  1 1 1 2 100.0 3.0 1.0e-3 40.0 1.0 0.0 0.03 1 1.0 0
  2 1 1 3 100.0 3.0 1.0e-3 39.9 1.0 0.0 0.03 1 1.0 0
END PACKAGEDATA
BEGIN CONNECTIONDATA
  1 -2
  2 1
END CONNECTIONDATA
BEGIN PERIOD 1
{inflow}END PERIOD
""")
    later = ("BEGIN PERIOD 2\n  M1 SFR-1 2 M2 SFR-1 1 UPTO 1.0\n"
             "END PERIOD\n") if exg_period2 else ""
    write(ws, "ab.mvr", """BEGIN OPTIONS
  MODELNAMES
END OPTIONS
BEGIN DIMENSIONS
  MAXMVR 1
  MAXPACKAGES 2
END DIMENSIONS
BEGIN PACKAGES
  M1 SFR-1
  M2 SFR-1
END PACKAGES
BEGIN PERIOD 1
  M1 SFR-1 2 M2 SFR-1 1 FACTOR 1.0
END PERIOD
""" + later)


def test_exchange_mover_deck_matches_reference(tmp_path):
    """tests/test_exchange_mvr.py: A's terminal outflow moved across the
    exchange into B's first reach, through both loaders: the merged
    features and movers equal, heads within 10 × OUTER_DVCLOSE at every
    step, B's terminal reach carrying the moved water."""
    ws = str(tmp_path)
    write_exchange_mvr_deck(ws)
    sim, ref = load_simulation(ws, device="cpu"), ref_load(ws)
    assert sim.model.sfr.nreaches == 4
    assert sim.model.mvr.prov_id == ref.model.mvr.prov_id == (1,)
    assert sim.model.mvr.recv_id == ref.model.mvr.recv_id == (2,)
    np.testing.assert_array_equal(sim.model.sfr.node.numpy(),
                                  np.asarray(ref.model.sfr.node))
    recs, jrecs = sim.run(), ref.run()
    for g, w in zip(recs, jrecs):
        assert g.converged and w.converged
        np.testing.assert_allclose(g.head, w.head, rtol=0, atol=1e-7)
    assert list(sim.budget.terms) == list(ref.budget.terms)
    for name, w in ref.budget.terms.items():
        for field in ("cum_in", "cum_out"):
            np.testing.assert_allclose(
                getattr(sim.budget.terms[name], field), getattr(w, field),
                rtol=1e-6, atol=1e-6, err_msg=name)
    x, info, _ = sim.solution.solve_timestep(sim.model.strt, 2e4,
                                             iss=False)
    assert info.converged
    q_man, _ = sim.model.sfr._manning(x[8:])
    np.testing.assert_allclose(float(q_man[3]), 2.0, rtol=1e-3)
    ib, _ = sim.model.boundary_state(x)
    qp, _, _ = sim.model.eval_movers(x, ib)
    np.testing.assert_allclose(float(qp[0]), float(q_man[1]), rtol=1e-9)


@pytest.mark.parametrize("case", ["no-exchange", "uzf", "csub", "tvk",
                                  "provider", "exchange-mvr-period",
                                  "sfr-period", "gwf6-gwt6"])
def test_multi_model_refusals(case, tmp_path):
    """What the reference refuses raises here by name (several models
    with no exchange, UZF or CSUB in a composite, TVK/TVS with several
    models, a standard-package provider outside the first model, later
    PERIOD blocks of an exchange's MVR6, a GWT6 model beside several GWF6
    models), and so do later PERIOD blocks of a member's features."""
    ws = str(tmp_path)
    write_exchange_mvr_deck(ws, exg_period2=case == "exchange-mvr-period")
    match = {"no-exchange": "more than one model", "uzf": "UZF",
             "csub": "CSUB", "tvk": "TVK", "provider": "first model",
             "exchange-mvr-period": "exchange MVR",
             "sfr-period": "SFR",
             "gwf6-gwt6": "GWT6 beside several GWF6 models"}[case]
    sim_nam = tmp_path / "mfsim.nam"
    if case == "no-exchange":
        sim_nam.write_text(sim_nam.read_text().replace(
            "  GWF6-GWF6 ab.exg M1 M2\n", ""))
    elif case == "gwf6-gwt6":
        # a transport model beside the two flow models: refused by name,
        # as the reference's loader refuses it
        sim_nam.write_text(sim_nam.read_text().replace(
            "  GWF6-GWF6 ab.exg M1 M2\n",
            "  GWF6-GWF6 ab.exg M1 M2\n  GWF6-GWT6 x.exg M1 T\n").replace(
            "END MODELS", "  GWT6 t.nam T\nEND MODELS"))
    elif case in ("uzf", "csub", "tvk"):
        files = {"uzf": ("UZF6 b.uzf", "b.uzf", """BEGIN DIMENSIONS
  NUZFCELLS 1
END DIMENSIONS
BEGIN PACKAGEDATA
  1 1 1 1 0 0 0.5 0.1 0.05 0.35 0.1 3.5
END PACKAGEDATA
"""), "csub": ("CSUB6 b.csub", "b.csub", """BEGIN DIMENSIONS
  NINTERBEDS 1
END DIMENSIONS
BEGIN PACKAGEDATA
  1 1 1 2 NODELAY 0.0 2.0 1.0 1.0e-2 1.0e-4 0.3 0.0 0.0
END PACKAGEDATA
"""),
                 "tvk": (None, "b.tvk",
                         "BEGIN PERIOD 1\n  1 1 2 K 2.0\nEND PERIOD\n")}
        line, name, text = files[case]
        write(ws, name, text)
        if line is None:
            npf = (tmp_path / "b.npf").read_text().replace(
                "BEGIN OPTIONS\n", "BEGIN OPTIONS\n  TVK6 FILEIN b.tvk\n")
            (tmp_path / "b.npf").write_text(npf)
        else:
            nam = (tmp_path / "b.nam").read_text().replace(
                "END PACKAGES", f"  {line}\nEND PACKAGES")
            (tmp_path / "b.nam").write_text(nam)
    elif case == "provider":
        write(ws, "b.wel", "BEGIN OPTIONS\n  MOVER\nEND OPTIONS\n"
              "BEGIN DIMENSIONS\n  MAXBOUND 1\nEND DIMENSIONS\n"
              "BEGIN PERIOD 1\n  1 1 3 -1.0\nEND PERIOD\n")
        write(ws, "b.mvr", "BEGIN DIMENSIONS\n  MAXMVR 1\n  MAXPACKAGES 2\n"
              "END DIMENSIONS\nBEGIN PERIOD 1\n  WEL-1 1 SFR-1 1 UPTO 0.5\n"
              "END PERIOD\n")
        nam = (tmp_path / "b.nam").read_text().replace(
            "END PACKAGES", "  WEL6 b.wel\n  MVR6 b.mvr\nEND PACKAGES")
        (tmp_path / "b.nam").write_text(nam)
    elif case == "sfr-period":
        sfr = (tmp_path / "a.sfr").read_text() + \
            "BEGIN PERIOD 2\n  1 INFLOW 3.0\nEND PERIOD\n"
        (tmp_path / "a.sfr").write_text(sfr)
    with pytest.raises(NotImplementedError, match=match):
        load_simulation(ws, device="cpu")
