"""DRN, RIV, GHB and EVT of the port against the reference: the per-entry
terms, the data makers, a model that holds all four on a general grid, and
DISV6/DISU6 input decks with them through both packages' command lines.

Tolerances:

- ``drn_terms``, ``riv_terms``, ``ghb_terms``, ``evt_terms`` (one segment
  and several) on random inputs that straddle every branch: rtol 1e-13;
- the data makers: every array equal;
- the assembled system of a model with the four packages: 1e-12 of the
  largest entry; its CG solve: equal (outer, inner) counts, heads at 1e-10;
  the boundary budget: 1e-9 of the largest flow;
- decks: loaded state equal; heads at 1e-10; ``.hds`` and ``.cbc`` read
  back and compared at 1e-10 and 1e-9 of the largest flow; ``.grb`` byte
  for byte; budget totals rtol 1e-9.
"""

import contextlib
import dataclasses
import io
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_regression_decks import write
from test_torch_parity import model_options
from test_torch_unstructured import (ENTRY, MESHES, both_grids, brick_mesh,
                                     disu_args, disv_args)
from modflow6_tpu.__main__ import main as ref_cli
from modflow6_tpu.models.gwf import bnd as jbnd
from modflow6_tpu.models.gwf import builder as jbuilder
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution.fused import make_fused_run as jax_make_fused_run
from modflow6_tpu.utils.binary import read_budget_file as ref_read_budget
from modflow6_tpu.utils.binary import read_head_file as ref_read_heads
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.__main__ import main as port_cli
from modflow6_torch.convert import from_reference
from modflow6_torch.models.gwf import bnd, builder
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.fused import make_fused_run
from modflow6_torch.utils.mf6io import load_simulation

PACKAGES = ("chd", "wel", "rch", "drn", "riv", "ghb", "evt")


def _fields(data):
    return {f.name: getattr(data, f.name) for f in dataclasses.fields(data)
            if getattr(data, f.name) is not None}


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


# -------------------------------------------------------- per-entry terms

def _entries(kind, rng, ncell, b):
    """Random entries of one package around heads in [0, 10], so that every
    branch is taken: heads above, inside and below each interval."""
    node = rng.integers(0, ncell, b)
    if kind.startswith("drn"):
        ddrn = rng.choice([0.0, 0.0, 1.5], b) if kind != "drn" \
            else np.zeros(b)
        return [(n, e, c, d) for n, e, c, d in zip(
            node, rng.uniform(2, 8, b), rng.uniform(0.1, 5, b), ddrn)]
    if kind == "riv":
        stage = rng.uniform(3, 9, b)
        return list(zip(node, stage, rng.uniform(0.1, 5, b),
                        stage - rng.uniform(0.5, 3, b)))
    if kind == "ghb":
        return list(zip(node, rng.uniform(0, 10, b), rng.uniform(0.1, 5, b)))
    base = list(zip(node, rng.uniform(4, 9, b), rng.uniform(1e-4, 1e-2, b),
                    rng.choice([0.0, 2.0, 5.0], b)))
    if kind == "evt":
        return base
    nseg1 = 2
    pxdp = np.sort(rng.uniform(0.1, 0.9, (b, nseg1)), axis=1)
    petm = np.sort(rng.uniform(0.1, 0.9, (b, nseg1)), axis=1)[:, ::-1]
    return [(*e, *px, *pe) for e, px, pe in zip(base, pxdp, petm)]


TERM_KINDS = ("drn", "drn-depth", "drn-cubic", "riv", "ghb", "evt",
              "evt-segmented")


@pytest.mark.parametrize("kind", TERM_KINDS)
def test_package_terms_match_reference(kind):
    rng = np.random.default_rng(TERM_KINDS.index(kind))
    ncell, b = 50, 300
    pkg = kind.split("-")[0]
    entries = _entries(kind, rng, ncell, b)
    jdata = getattr(jbuilder, f"{pkg}_data")(entries, maxbound=b + 7)
    tdata = getattr(builder, f"{pkg}_data")(entries, maxbound=b + 7,
                                            device="cpu")
    for key, value in _fields(jdata).items():
        got = getattr(tdata, key)
        assert got.dtype == {"node": torch.int64, "mask": torch.bool}.get(
            key, torch.float64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(value),
                                      err_msg=key)
    assert _fields(tdata).keys() == _fields(jdata).keys()
    head = rng.uniform(0, 10, ncell)
    ibound = rng.choice([-1, 0, 1, 1, 1], ncell)
    area = rng.uniform(50, 150, ncell)
    hj, ibj = jnp.asarray(head), jnp.asarray(ibound, jnp.int32)
    ht, ibt = torch.as_tensor(head), torch.as_tensor(ibound,
                                                     dtype=torch.int32)
    if pkg == "drn":
        cubic = int(kind == "drn-cubic")
        want = jbnd.drn_terms(jdata, hj, ibj, cubic)
        got = bnd.drn_terms(tdata, ht, ibt, cubic)
    elif pkg == "riv":
        want, got = jbnd.riv_terms(jdata, hj, ibj), bnd.riv_terms(tdata, ht,
                                                                  ibt)
    elif pkg == "ghb":
        want, got = jbnd.ghb_terms(jdata, ibj), bnd.ghb_terms(tdata, ibt)
    else:
        want = jbnd.evt_terms(jdata, hj, ibj, jnp.asarray(area))
        got = bnd.evt_terms(tdata, ht, ibt, torch.as_tensor(area))
    for g, w in zip(got, want):
        _close(g, w, 1e-13)
        assert np.abs(np.asarray(w)).max() > 0
    # the flows of the budget, and the scatter into the system
    _close(bnd.bound_flows(tdata.node, tdata.mask, *got, ht, ibt),
           jbnd.bound_flows(jdata.node, jdata.mask, *want, hj, ibj), 1e-13)
    d0, r0 = rng.normal(size=ncell), rng.normal(size=ncell)
    for g, w in zip(
            bnd.scatter_terms(torch.as_tensor(d0), torch.as_tensor(r0),
                              tdata.node, tdata.mask, *got),
            jbnd.scatter_terms(jnp.asarray(d0), jnp.asarray(r0), jdata.node,
                               jdata.mask, *want)):
        _close(g, w, 1e-12)


def test_evt_data_rejects_unpaired_segments():
    with pytest.raises(ValueError, match="pairs"):
        builder.evt_data([(0, 5.0, 1e-3, 2.0, 0.5)], device="cpu")


# ------------------------------------------- a model with all the packages

def package_args(grid, seed=0, segmented=False):
    """build_gwf arguments of a model on a layered grid (``grid.shape`` is
    (nlay, ncpl) or, for DISU, the brick mesh in two layers): CHD on one
    side, a well, recharge and EVT on layer 1, drains and a river in
    between, GHB on the far side."""
    n = grid.nodes
    ncpl = n // 2
    rng = np.random.default_rng(seed)
    cells = rng.permutation(ncpl)
    evt = [(c, 22.0, 2e-3, 4.0) for c in range(ncpl)]
    if segmented:
        evt = [(*e, 0.3, 0.7, 0.8, 0.2) for e in evt]
    return dict(
        k=np.exp(rng.normal(0.0, 0.7, n)), k33=0.2, strt=21.0, icelltype=1,
        storage={"ss": 1e-5, "sy": 0.1, "iconvert": 1},
        chd=[(int(c), 23.0) for c in cells[:3]],
        wel=[(int(cells[3]) + ncpl, -20.0)],
        rch=[(c, 3e-3) for c in range(ncpl)],
        drn=[(int(c), 19.5 + 0.1 * i, 2.0) for i, c in enumerate(cells[4:9])],
        riv=[(int(c), 21.5, 3.0, 20.0) for c in cells[9:14]],
        ghb=[(int(c), 18.0, 1.5) for c in cells[14:18]],
        evt=evt)


def packages_models(name, **kw):
    gj, gt = both_grids(name)
    args = package_args(gj, **kw)
    return (jbuilder.build_gwf("ref", gj, **args),
            builder.build_gwf("port", gt, device="cpu", **args))


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("name", ["brick", "disu"])
def test_model_with_the_four_packages_matches_reference(name, segmented):
    ref, port = packages_models(name, segmented=segmented)
    assert not port.is_linear and not ref.is_linear
    rng = np.random.default_rng(3)
    head = 21.0 + rng.normal(0.0, 1.5, ref.nodes)
    ibj, hj = ref.boundary_state(jnp.asarray(head))
    ibt, ht = port.boundary_state(torch.as_tensor(head))
    for g, w in zip(port.assemble(ht, ht, ibt, 2.0, False),
                    ref.assemble(hj, hj, ibj, 2.0, False)):
        _close(g, w, 1e-12)
    want = ref.boundary_budget(hj, ibj)
    got = port.boundary_budget(ht, ibt)
    assert list(got) == list(want) == ["CHD", "WEL", "RCH", "DRN", "RIV",
                                       "GHB", "EVT"]
    scale = max(np.abs(np.asarray(q)).max() for q in want.values()
                if q is not None)
    for key, q in want.items():
        if q is not None:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(q),
                                       rtol=0, atol=1e-9 * scale)
            assert np.abs(np.asarray(q)).max() > 0, key

    s = dict(ENTRY, linear_acceleration="cg")
    wj = jax_make_fused_run(ref, JaxImsSettings(**s), False, 2)(
        jnp.asarray(ref.strt), jnp.full(2, 2.0))
    wt = make_fused_run(port, ImsSettings(**s), False, 2)(port.strt,
                                                          [2.0, 2.0])
    assert all(wt[3]) and bool(np.asarray(wj[3]).all())
    assert wt[1] == np.asarray(wj[1]).tolist()
    assert wt[2] == np.asarray(wj[2]).tolist()
    np.testing.assert_allclose(wt[0].numpy(), np.asarray(wj[0]), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("pkg", ["drn", "riv", "ghb", "evt"])
def test_is_linear_follows_the_reference_per_package(pkg):
    """A confined model stays linear with GHB alone; a drain, a river or
    evapotranspiration switches with the head."""
    gj, gt = both_grids("quad")
    entry = dict(drn=[(1, 5.0, 1.0)], riv=[(1, 5.0, 1.0, 4.0)],
                 ghb=[(1, 5.0, 1.0)], evt=[(1, 5.0, 1e-3, 2.0)])[pkg]
    ref = jbuilder.build_gwf("r", gj, **{pkg: entry})
    port = builder.build_gwf("p", gt, device="cpu", **{pkg: entry})
    assert port.is_linear == ref.is_linear == (pkg == "ghb")


def reference_general_arrays(model):
    """(arrays, keyword arguments) of ``from_reference`` for a reference
    model on the general path."""
    a, t = model.npf_arrays, model.topo
    out = dict(k11=a.k11, k22=a.k22, k33=a.k33, icelltype=a.icelltype,
               top=a.top, bot=a.bot, strt=model.strt, ibound0=model.ibound0,
               angle1=a.angle1, angle2=a.angle2, angle3=a.angle3,
               condsat=a.condsat, area=model.grid.area,
               **{key: getattr(t, key) for key in (
                   "edge_n", "edge_m", "ihc", "cl1", "cl2", "hwva", "anglex",
                   "nbr", "slot_nm", "slot_mn")})
    if model.sto_arrays is not None:
        s = model.sto_arrays
        out.update(sto_iconvert=s.iconvert, sto_ss=s.ss, sto_sy=s.sy)
    for pkg in PACKAGES:
        data = getattr(model, pkg)
        if data is not None:
            out.update({f"{pkg}_{k}": v for k, v in _fields(data).items()})
    kwargs = dict(grid_shape=model.dtopo.grid_shape,
                  npf_options=dataclasses.asdict(model.npf_opts),
                  sto_options=None if model.sto_opts is None
                  else dataclasses.asdict(model.sto_opts),
                  model_options={**model_options(model), "hfb": model.hfb})
    return {k: np.asarray(v) for k, v in out.items()}, kwargs


@pytest.mark.parametrize("name", ["brick", "disu"])
def test_convert_carries_the_general_state(name):
    """``from_reference`` gives the port the reference's edge topology,
    condsat (with its barrier), angles and packages unchanged, and the
    converted model assembles what the built one does."""
    gj, gt = both_grids(name)
    args = package_args(gj, segmented=True)
    topo = gj.build_topology()
    e = int(np.nonzero(topo.ihc != 0)[0][3])
    args["hfb"] = [(int(topo.edge_n[e]), int(topo.edge_m[e]), 1e-2)]
    ref = jbuilder.build_gwf("ref", gj, **args)
    arrays, kwargs = reference_general_arrays(ref)
    conv = from_reference(arrays, device="cpu", grid=gt, **kwargs)
    built = builder.build_gwf("port", gt, device="cpu", **args)
    assert not conv.use_structured and conv.hfb == args["hfb"]
    for key in ("edge_n", "edge_m", "ihc", "cl1", "cl2", "hwva", "anglex",
                "nbr", "slot_nm", "slot_mn"):
        np.testing.assert_array_equal(getattr(conv.dtopo, key).numpy(),
                                      arrays[key], err_msg=key)
    for key in ("angle1", "angle2", "angle3", "condsat"):
        np.testing.assert_array_equal(
            getattr(conv.npf_arrays, key).numpy(), arrays[key], err_msg=key)
    for pkg in PACKAGES:
        for key, value in _fields(getattr(conv, pkg)).items():
            np.testing.assert_array_equal(value.numpy(),
                                          arrays[f"{pkg}_{key}"])
    ib, h = built.boundary_state(built.strt)
    for g, w in zip(conv.assemble(h, h, ib, 2.0, False),
                    built.assemble(h, h, ib, 2.0, False)):
        _close(g, w, 1e-12)


# ------------------------------------------------------------------ decks

def _list_block(rows):
    return "\n".join("  " + " ".join(repr(v) if isinstance(v, float)
                                     else str(v) for v in row)
                     for row in rows)


def write_general_deck(ws, kind, nseg=1):
    """A two-layer transient deck on the brick mesh as DISV6 or DISU6, with
    CHD, WEL, RCH, DRN, RIV, GHB and EVT (``nseg`` segments) in two stress
    periods, CG, and an OC file.  Returns the cellid maker."""
    ws = str(ws)
    dkw = disv_args(brick_mesh(5, 4), nlay=2, seed=1)
    ncpl = dkw["ncpl"]
    if kind == "disv":
        def cellid(node):
            return (node // ncpl + 1, node % ncpl + 1)
    else:
        def cellid(node):
            return (node + 1,)
    write(ws, "mfsim.nam", f"""
BEGIN TIMING
  TDIS6 sim.tdis
END TIMING
BEGIN MODELS
  GWF6 m.nam GEN
END MODELS
BEGIN SOLUTIONGROUP 1
  IMS6 sim.ims GEN
END SOLUTIONGROUP
""")
    write(ws, "sim.tdis", """
BEGIN DIMENSIONS
  NPER 2
END DIMENSIONS
BEGIN PERIODDATA
  1.0 1 1.0
  20.0 3 1.3
END PERIODDATA
""")
    write(ws, "sim.ims", """
BEGIN NONLINEAR
  OUTER_DVCLOSE 1e-6
  OUTER_MAXIMUM 100
END NONLINEAR
BEGIN LINEAR
  INNER_MAXIMUM 300
  INNER_DVCLOSE 1e-8
  INNER_RCLOSE 1e-6
  LINEAR_ACCELERATION CG
END LINEAR
""")
    dis = "DISV6 m.disv" if kind == "disv" else "DISU6 m.disu"
    write(ws, "m.nam", f"""
BEGIN PACKAGES
  {dis}
  IC6 m.ic
  NPF6 m.npf
  STO6 m.sto
  CHD6 m.chd
  WEL6 m.wel
  RCH6 m.rch
  DRN6 m.drn
  RIV6 m.riv
  GHB6 m.ghb
  EVT6 m.evt
  OC6 m.oc
END PACKAGES
""")
    if kind == "disv":
        verts, cell2d = dkw["vertices"], dkw["cell2d"]
        vlines = "\n".join(f"  {i + 1} {x!r} {y!r}"
                           for i, (x, y) in enumerate(verts.tolist()))
        # every other ring closed by its first vertex, as MF6 allows
        clines = "\n".join(
            f"  {i + 1} {xc!r} {yc!r} {len(vs) + i % 2} "
            + " ".join(str(v + 1) for v in (list(vs) + list(vs[:i % 2])))
            for i, (xc, yc, vs) in enumerate(cell2d))
        botm = "\n".join("    INTERNAL\n    "
                         + " ".join(repr(float(v)) for v in layer)
                         for layer in dkw["botm"])
        write(ws, "m.disv", f"""
BEGIN DIMENSIONS
  NLAY 2
  NCPL {ncpl}
  NVERT {len(verts)}
END DIMENSIONS
BEGIN GRIDDATA
  TOP
    CONSTANT 25.0
  BOTM LAYERED
{botm}
END GRIDDATA
BEGIN VERTICES
{vlines}
END VERTICES
BEGIN CELL2D
{clines}
END CELL2D
""")
    else:
        ukw = disu_args(dkw)

        def arr(name, values, fmt=repr):
            return (f"  {name}\n    INTERNAL\n    "
                    + " ".join(fmt(v) for v in values))
        n = ukw["top"].size
        ja = ukw["ja"] + 1
        write(ws, "m.disu", f"""
BEGIN DIMENSIONS
  NODES {n}
  NJA {ja.size}
END DIMENSIONS
BEGIN GRIDDATA
{arr("TOP", ukw["top"].tolist())}
{arr("BOT", ukw["bot"].tolist())}
{arr("AREA", ukw["area"].tolist())}
END GRIDDATA
BEGIN CONNECTIONDATA
{arr("IAC", ukw["iac"].tolist(), str)}
{arr("JA", ja.tolist(), str)}
{arr("IHC", ukw["ihc"].tolist(), str)}
{arr("CL12", ukw["cl12"].tolist())}
{arr("HWVA", ukw["hwva"].tolist())}
{arr("ANGLDEGX", ukw["angldegx"].tolist())}
END CONNECTIONDATA
""")
    rng = np.random.default_rng(4)
    n = 2 * ncpl
    kvals = " ".join(repr(float(v)) for v in np.exp(rng.normal(0, 0.7, n)))
    k22 = " ".join(repr(float(v)) for v in np.exp(rng.normal(-0.5, 0.3, n)))
    write(ws, "m.ic", "BEGIN GRIDDATA\n  STRT\n    CONSTANT 21.0\n"
          "END GRIDDATA\n")
    write(ws, "m.npf", f"""
BEGIN OPTIONS
  SAVE_FLOWS
END OPTIONS
BEGIN GRIDDATA
  ICELLTYPE
    CONSTANT 1
  K
    INTERNAL
    {kvals}
  K22
    INTERNAL
    {k22}
  K33
    CONSTANT 0.2
END GRIDDATA
""")
    write(ws, "m.sto", """
BEGIN GRIDDATA
  ICONVERT
    CONSTANT 1
  SS
    CONSTANT 1e-5
  SY
    CONSTANT 0.1
END GRIDDATA
BEGIN PERIOD 1
  STEADY-STATE
END PERIOD
BEGIN PERIOD 2
  TRANSIENT
END PERIOD
""")
    cells = rng.permutation(ncpl)

    def pkg(name, dims, periods, options=""):
        blocks = "\n".join(f"BEGIN PERIOD {kper}\n{_list_block(rows)}\n"
                           "END PERIOD" for kper, rows in periods.items())
        write(ws, name, f"{options}BEGIN DIMENSIONS\n{dims}\nEND DIMENSIONS\n"
              f"{blocks}\n")

    pkg("m.chd", "  MAXBOUND 3",
        {1: [(*cellid(int(c)), 23.0) for c in cells[:3]]})
    pkg("m.wel", "  MAXBOUND 1",
        {2: [(*cellid(int(cells[3]) + ncpl), -20.0)]})
    pkg("m.rch", f"  MAXBOUND {ncpl}",
        {1: [(*cellid(c), 3e-3) for c in range(ncpl)]})
    pkg("m.drn", "  MAXBOUND 5",
        {1: [(*cellid(int(c)), 19.5 + 0.1 * i, 2.0)
             for i, c in enumerate(cells[4:9])],
         2: [(*cellid(int(c)), 20.0, 1.0) for c in cells[4:7]]})
    pkg("m.riv", "  MAXBOUND 5",
        {1: [(*cellid(int(c)), 21.5, 3.0, 20.0) for c in cells[9:14]]},
        options="BEGIN OPTIONS\n  BOUNDNAMES\nEND OPTIONS\n")
    pkg("m.ghb", "  MAXBOUND 4",
        {1: [(*cellid(int(c)), 18.0, 1.5, 7.0) for c in cells[14:18]]},
        options="BEGIN OPTIONS\n  AUXILIARY CONC\nEND OPTIONS\n")
    seg = (0.3, 0.7, 0.8, 0.2) if nseg == 3 else ()
    pkg("m.evt", f"  MAXBOUND {ncpl}\n  NSEG {nseg}",
        {1: [(*cellid(c), 22.0, 2e-3, 4.0, *seg) for c in range(ncpl)]})
    write(ws, "m.oc", """
BEGIN OPTIONS
  HEAD FILEOUT gen.hds
  BUDGET FILEOUT gen.cbc
END OPTIONS
BEGIN PERIOD 1
  SAVE HEAD ALL
  SAVE BUDGET ALL
END PERIOD
""")
    return cellid


def _loaded_state(sim):
    """What a loader produced on a general grid, as numpy."""
    m = sim.model
    a = m.npf_arrays
    out = dict(k11=a.k11, k22=a.k22, k33=a.k33, icelltype=a.icelltype,
               top=a.top, bot=a.bot, strt=m.strt, ibound0=m.ibound0,
               condsat=a.condsat, edge_n=m.dtopo.edge_n, nbr=m.dtopo.nbr,
               anglex=m.dtopo.anglex, sto_sy=m.sto_arrays.sy)
    for kper, pd in {0: m.packages, **sim.period_data}.items():
        for pkg in PACKAGES:
            data = getattr(pd, pkg)
            if data is not None:
                out.update({f"{kper}_{pkg}_{k}": v
                            for k, v in _fields(data).items()})
    return ({k: np.asarray(v) for k, v in out.items()},
            dict(npf=dataclasses.asdict(m.npf_opts),
                 sto=dataclasses.asdict(m.sto_opts),
                 settings=vars(sim.solution.s), transient=sim.transient,
                 tdis=[(p.perlen, p.nstp, p.tsmult)
                       for p in sim.tdis.periods]))


@pytest.fixture(scope="module", params=["disv", "disu", "disv-nseg3"])
def general_deck(request, tmp_path_factory):
    """One deck run through both command lines, each in its own copy.  The
    reference cannot write the heads file of a DISU grid (it reshapes the
    heads to the one-element grid shape), so there it is loaded and run
    without that file; its budget and grid files are written all the
    same."""
    kind, _, seg = request.param.partition("-")
    dirs = {}
    for who, cli in (("ref", ref_cli), ("port", port_cli)):
        ws = tmp_path_factory.mktemp(f"{request.param}_{who}")
        write_general_deck(ws, kind, nseg=3 if seg else 1)
        dirs[who] = ws
        if who == "ref" and kind == "disu":
            sim = ref_load(str(ws))
            sim.hds.close()
            sim.hds = None
            assert all(r.converged for r in sim.run())
            continue
        out = io.StringIO()
        args = [str(ws), "--lst", str(ws / "run.lst")]
        with contextlib.redirect_stdout(out):
            code = cli(args + (["--device", "cpu"] if who == "port" else []))
        assert code == 0 and "Normal termination" in out.getvalue()
    return request.param, dirs["ref"], dirs["port"]


def _copies(general_deck, tmp_path):
    """Copies of the two workspaces: loading a deck opens its output files
    anew, and the fixture's are compared elsewhere."""
    _, refdir, portdir = general_deck
    return (shutil.copytree(refdir, tmp_path / "ref"),
            shutil.copytree(portdir, tmp_path / "port"))


def test_general_deck_loads_as_the_reference_loads_it(general_deck,
                                                      tmp_path):
    refdir, portdir = _copies(general_deck, tmp_path)
    ref = ref_load(str(refdir))
    port = load_simulation(str(portdir), device="cpu")
    assert type(port.model.grid).__name__ == type(ref.model.grid).__name__
    got, got_opts = _loaded_state(port)
    want, want_opts = _loaded_state(ref)
    assert got_opts == want_opts
    assert got.keys() == want.keys()
    for key, value in got.items():
        if key == "condsat":
            np.testing.assert_allclose(value, want[key], rtol=1e-13)
        else:
            np.testing.assert_array_equal(value, want[key], err_msg=key)
    assert port.model.npf_opts.ik22 and {"2_drn_elev", "0_evt_rate"} <= set(got)


def test_general_deck_output_files_match_reference(general_deck):
    param, refdir, portdir = general_deck
    ghds = ref_read_heads(str(portdir / "gen.hds"))
    # four steps, one record per layer (a DISU grid is one layer of
    # 1 x nodes, which the reference does not write)
    whds = ghds if param == "disu" else ref_read_heads(
        str(refdir / "gen.hds"))
    assert len(ghds) == len(whds) == (4 if param == "disu" else 8)
    assert ghds[0]["data"].shape == ((1, 40) if param == "disu" else (1, 20))
    for g, w in zip(ghds, whds):
        for key in ("kstp", "kper", "pertim", "totim", "text", "ilay"):
            assert g[key] == w[key], key
        assert g["data"].shape == w["data"].shape
        np.testing.assert_allclose(g["data"], w["data"], rtol=0, atol=1e-10)
    wcbc = ref_read_budget(str(refdir / "gen.cbc"))
    gcbc = ref_read_budget(str(portdir / "gen.cbc"))
    assert sorted(r["text"] for r in gcbc) == sorted(r["text"] for r in wcbc)
    assert {"FLOW-JA-FACE", "STO-SS", "STO-SY", "CHD", "WEL", "RCH", "DRN",
            "RIV", "GHB", "EVT"} <= {r["text"] for r in gcbc}
    by_key = {(r["kper"], r["kstp"], r["text"]): r for r in wcbc}
    scale = max(np.abs(r["data"] if r["imeth"] == 1
                       else r["data"][2]).max(initial=0.0) for r in wcbc)
    for g in gcbc:
        w = by_key[(g["kper"], g["kstp"], g["text"])]
        for key in ("imeth", "delt", "pertim", "totim"):
            assert g[key] == w[key], key
        if g["imeth"] == 1:
            np.testing.assert_allclose(g["data"], w["data"], rtol=0,
                                       atol=1e-9 * scale)
        else:
            np.testing.assert_array_equal(g["data"][0], w["data"][0])
            np.testing.assert_allclose(g["data"][2], w["data"][2], rtol=0,
                                       atol=1e-9 * scale)
    assert (portdir / "gen.grb").read_bytes() == (refdir
                                                  / "gen.grb").read_bytes()
    assert os.path.getsize(portdir / "gen.grb") > 1000


def test_general_deck_run_matches_reference(general_deck, tmp_path):
    """The records of ``Simulation.run`` of both loaders: equal counts,
    heads at 1e-10, budget totals at rtol 1e-9."""
    refdir, portdir = _copies(general_deck, tmp_path)
    ref, port = ref_load(str(refdir)), load_simulation(str(portdir),
                                                       device="cpu")
    ref.hds = ref.cbc = port.hds = port.cbc = None
    want, got = ref.run(), port.run()
    assert [(r.outer, r.inner, r.converged) for r in got] == [
        (r.outer, r.inner, r.converged) for r in want]
    assert len(got) == 4 and all(r.converged for r in got)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.head, w.head, rtol=0, atol=1e-10)
    assert port.budget.terms.keys() == ref.budget.terms.keys()
    assert {"DRN", "RIV", "GHB", "EVT"} <= port.budget.terms.keys()
    scale = max(t.cum_in + t.cum_out for t in ref.budget.terms.values())
    for name, w in ref.budget.terms.items():
        g = port.budget.terms[name]
        np.testing.assert_allclose(
            [g.rate_in, g.rate_out, g.cum_in, g.cum_out],
            [w.rate_in, w.rate_out, w.cum_in, w.cum_out], rtol=1e-9,
            atol=1e-12 * scale, err_msg=name)
    assert abs(port.budget.percent_discrepancy()) < 1e-3


@pytest.mark.parametrize("case", ["AUXDEPTHNAME", "SURF_RATE_SPECIFIED",
                                  "HFB6", "ANGLE1", "XT3D"])
def test_general_deck_raises_by_name(case, tmp_path):
    """What a general-grid deck can still ask for that is not ported."""
    write_general_deck(tmp_path, "disv")

    def edit(name, old, new):
        path = tmp_path / name
        text = path.read_text()
        assert old in text
        path.write_text(text.replace(old, new, 1))

    if case == "AUXDEPTHNAME":
        edit("m.drn", "BEGIN DIMENSIONS", "BEGIN OPTIONS\n  AUXILIARY DD\n"
             "  AUXDEPTHNAME DD\nEND OPTIONS\nBEGIN DIMENSIONS")
    elif case == "SURF_RATE_SPECIFIED":
        edit("m.evt", "BEGIN DIMENSIONS", "BEGIN OPTIONS\n"
             "  SURF_RATE_SPECIFIED\nEND OPTIONS\nBEGIN DIMENSIONS")
    elif case == "HFB6":
        edit("m.nam", "  OC6 m.oc", "  OC6 m.oc\n  HFB6 m.hfb")
    elif case == "ANGLE1":
        edit("m.npf", "  K33\n", "  ANGLE1\n    CONSTANT 30.0\n  K33\n")
    else:
        edit("m.npf", "  SAVE_FLOWS", "  SAVE_FLOWS\n  XT3D")
    with pytest.raises(NotImplementedError, match=case):
        load_simulation(str(tmp_path), device="cpu")


def test_mesh_helpers_are_the_documented_sizes():
    assert MESHES["brick"]()["ncpl"] == 30
    assert disv_args(brick_mesh(5, 4))["ncpl"] == 20


@pytest.mark.parametrize("line", [
    "  17 3.5e+01 -2.25 6 1 2 3 4 5 6",
    "\t1\t2  3   BOUND_A\t",
    "OPEN/CLOSE 'a file.txt' FACTOR 2.0",
    'HEAD FILEOUT "out dir/m.hds"',
    "path\\ with\\ escapes.txt 1",
    "it's unbalanced 3",
    "",
])
def test_tokenizer_gives_the_reference_tokens(line):
    """A record without quotes or backslashes is split on whitespace, as a
    DISV grid's millions of VERTICES and CELL2D records are; every record
    gives the tokens the reference's tokenizer gives."""
    from modflow6_tpu.utils.mf6io.reader import tokenize_line as ref_tokens
    from modflow6_torch.utils.mf6io.reader import tokenize_line
    assert tokenize_line(line) == ref_tokens(line)
