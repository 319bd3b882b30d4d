"""GWT decks in the port (the loader's GWT6 model, GWF6-GWT6 exchanges,
solution groups with MXITER, the concentration file, the CLI) and the
flow→transport coupling of ``Simulation`` (BUY's concentration, the group
Picard) against the reference.

Bars: adv01's three goldens at the reference's rtol 1e-5, atol 1e-6
(tests/test_regression_decks.py:177-186); the coupled deck of
tests/test_mf6io_multi.py:180 through both loaders with equal outer counts
and concentrations within 10 × outer_dvclose, and through
``simulation_from_reference`` bitwise equal to the port's loader; the
MXITER coupling of tests/test_buy.py:150 by its own measure, and the
group loop against the reference's own solutions driven in MODFLOW 6's
order at one sum order (equal passes and outer counts, heads within
1e-10, concentrations within 10 × outer_dvclose); ATS_PERCEL's step
lengths: tests/test_torch_timeseries.py.  Every refusal raises
``NotImplementedError`` naming what it refuses, beside what the reference
does with the same deck.
"""

import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from test_regression_decks import GOLDEN, build_adv01, ims_text, write
from test_torch_deck import simulation_state
from test_torch_gwt import gwt_reference_arrays
from modflow6_tpu.utils.mf6io import load_simulation as ref_load
from modflow6_torch.__main__ import main as cli_main
from modflow6_torch.convert import simulation_from_reference
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf.buy import make_buy
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.gwt.builder import build_gwt
from modflow6_torch.models.simulation import Simulation
from modflow6_torch.solution import ImsSettings
from modflow6_torch.timing.tdis import StressPeriod, Tdis
from modflow6_torch.utils.binary import read_head_file
from modflow6_torch.utils.mf6io import load_simulation


def load(ws):
    return load_simulation(str(ws), device="cpu")


@pytest.mark.parametrize("scheme", ["upstream", "central", "tvd"])
def test_adv01_golden(tmp_path, scheme):
    build_adv01(str(tmp_path), scheme)
    sim = load(tmp_path)
    recs = sim.run()
    assert all(r.converged and r.transport_converged for r in recs)
    conc = sim.conc_records[-1].reshape(-1)
    golden = np.load(os.path.join(GOLDEN, f"adv01_{scheme}.npy"))
    np.testing.assert_allclose(conc, golden, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------- the coupled deck

def coupled_deck(ws):
    """tests/test_mf6io_multi.py::test_gwf_gwt_coupled_deck's deck, as that
    test writes it (its own run is left out)."""
    import test_mf6io_multi as multi

    def stop(*args, **kwargs):
        raise _Written()

    # the test writes the deck, then loads it: stop at the load
    real, multi.load_simulation = multi.load_simulation, stop
    try:
        with pytest.raises(_Written):
            multi.test_gwf_gwt_coupled_deck(ws)
    finally:
        multi.load_simulation = real


class _Written(Exception):
    pass


@pytest.fixture(scope="module")
def coupled(tmp_path_factory):
    ws = tmp_path_factory.mktemp("coupled")
    coupled_deck(ws)
    ref = ref_load(str(ws))
    ref.run()
    port = load(ws)
    recs = port.run()
    return ws, ref, port, recs


def test_coupled_deck_matches_reference(coupled):
    ws, ref, port, recs = coupled
    assert port.gwt is not None and port.gwt_solution.s.linear_acceleration \
        == "bicgstab" and port.solution.s.linear_acceleration == "cg"
    assert all(r.converged and r.transport_converged for r in recs)
    assert [r.outer for r in recs] == [r.outer for r in ref.records]
    assert len(port.conc_records) == len(ref.conc_records) == 10
    for a, b in zip(port.conc_records, ref.conc_records):
        np.testing.assert_allclose(a, b, rtol=0, atol=10 * 1e-8)
    ucn = read_head_file(os.path.join(str(ws), "trans.ucn"))
    assert len(ucn) == 10 and ucn[-1]["text"] == "CONCENTRATION"
    for rec, conc in zip(ucn, port.conc_records):
        np.testing.assert_array_equal(rec["data"].reshape(-1), conc)
    conc = port.conc_records[-1]
    assert conc[0] > 0.99 and np.all(np.diff(conc) <= 1e-9)
    assert conc[-1] < 0.5 and conc[5] > 0.4


def transport_state(sim):
    """``simulation_state`` with the transport model's ``gwt`` entry."""
    state = simulation_state(sim)
    arrays, options = gwt_reference_arrays(sim.gwt)
    state["gwt"] = dict(name=sim.gwt.name, arrays=arrays, options=options,
                        settings=vars(sim.gwt_solution.s),
                        oc=None if sim.gwt_oc is None else sim.gwt_oc.periods,
                        sgp_mxiter=sim.sgp_mxiter)
    return state


def test_coupled_deck_through_convert_equals_the_port_loader(coupled):
    """Loader and solver apart: the reference's loader → convert → the
    port's run equals the port's loader → the port's run, bitwise."""
    ws, ref, port, recs = coupled
    state = transport_state(ref)
    conv = simulation_from_reference(state, device="cpu")
    crecs = conv.run()
    assert [(r.outer, r.inner, r.transport_outer, r.transport_inner)
            for r in crecs] == [(r.outer, r.inner, r.transport_outer,
                                 r.transport_inner) for r in recs]
    for a, b in zip(conv.conc_records, port.conc_records):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------- the coupling in Simulation

# tests/test_buy.py:150's model: a salt source at the west end of a
# 1 x 1 x 12 column, BUY at the transport's concentration
DENSITY_GRID = (1, 1, 12, 10.0, 10.0, 10.0, np.zeros((1, 1, 12)))
DENSITY_FLOW = dict(k=5.0, strt=8.0, storage={"ss": 1e-4, "iconvert": 0},
                    chd=[(0, 8.2), (11, 8.0)])
DENSITY_GWT = dict(porosity=0.3, strt=0.0, cnc=[(0, 30.0)])
DENSITY_IMS = dict(outer_dvclose=1e-10, outer_maximum=200,
                   inner_dvclose=1e-12, inner_rclose=1e-11,
                   inner_maximum=2000, linear_acceleration="bicgstab")
DENSITY_STEPS, DENSITY_DELT = 2, 50.0


def _density_run(mxiter, steps=DENSITY_STEPS):
    """The port's run of the model with SOLUTIONGROUP MXITER ``mxiter``."""
    g = DisGrid.create(*DENSITY_GRID)
    model = build_gwf("b", g, device="cpu", **DENSITY_FLOW)
    model.buy = make_buy(denseref=1000.0, drhodc=[0.7], crhoref=[0.0])
    gwt = build_gwt("t", g, device="cpu", **DENSITY_GWT)
    sim = Simulation(Tdis((StressPeriod(DENSITY_DELT * steps, steps, 1.0),)),
                     model, ImsSettings(**DENSITY_IMS), gwt=gwt)
    sim.sgp_mxiter = mxiter
    recs = sim.run()
    assert all(r.converged and r.transport_converged for r in recs)
    return sim, recs


@pytest.fixture(scope="module")
def density():
    """The port's runs at MXITER 1 and 10, and one step at MXITER 2."""
    return {1: _density_run(1), 10: _density_run(10),
            2: _density_run(2, steps=1)}


def _torch_order_dot(a, b):
    """The reference's dot product with its sum taken by torch.sum, on the
    host (jax.pure_callback), so that a jitted solve sums in the port's
    order."""
    import jax

    def host(a, b):
        return torch.sum(torch.from_numpy(np.asarray(a) * np.asarray(b))
                         ).numpy()
    return jax.pure_callback(host, jax.ShapeDtypeStruct((), a.dtype), a, b)


@pytest.fixture(scope="module")
def ref_density():
    """The reference's Simulation of the same model, its BiCGSTAB's dot
    products summed in the port's order (its solutions are jitted once,
    with that dot, and serve every reference run below)."""
    from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
    from modflow6_tpu.models.gwf.buy import make_buy as jax_make_buy
    from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
    from modflow6_tpu.models.gwt.builder import build_gwt as jax_build_gwt
    from modflow6_tpu.models.simulation import Simulation as JaxSimulation
    from modflow6_tpu.ops.solvers import krylov as jkrylov
    from modflow6_tpu.solution import ImsSettings as JaxImsSettings
    from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
    from modflow6_tpu.timing.tdis import Tdis as JaxTdis
    g = JaxDisGrid.create(*DENSITY_GRID)
    model = jax_build_gwf("b", g, **DENSITY_FLOW)
    model.buy = jax_make_buy(denseref=1000.0, drhodc=[0.7], crhoref=[0.0])
    gwt = jax_build_gwt("t", g, **DENSITY_GWT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jkrylov.bicgstab.__kwdefaults__, "dot", _torch_order_dot)
        yield JaxSimulation(
            JaxTdis((JaxPeriod(DENSITY_DELT * DENSITY_STEPS, DENSITY_STEPS,
                               1.0),)),
            model, JaxImsSettings(**DENSITY_IMS), gwt=gwt)


def reference_group_steps(jsim, mxiter, steps):
    """The reference's own pieces (its NumericalSolution for flow and
    transport, its from_gwf_step) driven in MODFLOW 6's sgp_ca order: per
    step the flow at the step-start concentration, then passes of the
    transport from the step-start concentration on the latest flow and
    the flow again at the new concentration, until two transport solutions
    differ by at most sgp_dclose or MXITER passes ran.  Returns per step
    (passes, flow outer, transport outer, head, conc)."""
    import jax.numpy as jnp
    from modflow6_tpu.models.gwt.fmi import from_gwf_step as jax_fmi
    model, gwt = jsim.model, jsim.gwt
    head, conc = jnp.asarray(model.strt), jnp.asarray(gwt.strt)
    out = []
    for kstp in range(1, steps + 1):
        base = jsim.period_packages(1)

        def flow(c):
            pkgs = dataclasses.replace(base, buy_conc=c)
            return pkgs, jsim.solution.solve_timestep(
                head, DENSITY_DELT, kstp=kstp, iss=False, pkgs=pkgs)

        pkgs, (h, finfo, aux) = flow(conc)
        prev, passes = None, 0
        while True:
            fields = jax_fmi(model, h, head, aux["ibound"], aux["cond"],
                             DENSITY_DELT, False, pkgs=pkgs,
                             ssm_spec=gwt.ssm_spec)
            gwt.set_flows(fields)
            c, tinfo, _ = jsim.gwt_solution.solve_timestep(
                conc, DENSITY_DELT, kstp=kstp, iss=False, pkgs=fields)
            passes += 1
            if passes == mxiter or (prev is not None and float(
                    jnp.max(jnp.abs(c - prev))) <= jsim.sgp_dclose):
                break
            prev = c
            pkgs, (h, finfo, aux) = flow(c)
        assert finfo.converged and tinfo.converged
        out.append((passes, finfo.outer_iterations, tinfo.outer_iterations,
                    np.asarray(h), np.asarray(c)))
        head, conc = h, c
    return out


def test_solution_group_mxiter_density_coupling(density):
    """SOLUTIONGROUP MXITER > 1: the flow re-solves at the new
    concentration until it settles; re-solving the last step's flow at the
    final concentration changes the heads far less than with the lagged
    coupling (tests/test_buy.py:150's measure, bar 0.3)."""
    errs = []
    for mxiter in (1, 10):
        sim, recs = density[mxiter]
        pkgs = dataclasses.replace(sim.model.packages, buy_conc=sim.conc)
        h2, info, _ = sim.solution.solve_timestep(
            torch.as_tensor(recs[-2].head), DENSITY_DELT,
            kstp=DENSITY_STEPS, iss=False, pkgs=pkgs)
        assert info.converged
        errs.append(float(np.abs(h2.numpy() - recs[-1].head).max()))
        assert float(sim.conc.max()) > 1.0
        if mxiter > 1:
            assert all(1 < r.group_iterations <= mxiter for r in recs)
    assert errs[1] < 0.3 * errs[0]


@pytest.mark.parametrize("mxiter,steps", [(2, 1), (10, 2)])
def test_solution_group_mxiter_matches_reference_pieces(density, ref_density,
                                                        mxiter, steps):
    """The port's MXITER loop against the reference's own solutions and
    FMI driven in sgp_ca order on the same inputs, at one sum order of the
    dot products (BiCGSTAB's counts follow it: ROADMAP Queue C): equal
    group passes and flow and transport outer counts per step (MXITER 2
    stops at the limit, 10 at sgp_dclose), heads within 1e-10,
    concentrations within 10 × the transport's outer_dvclose."""
    sim, recs = density[mxiter]
    ref = reference_group_steps(ref_density, mxiter, steps)
    assert [(r.group_iterations, r.outer, r.transport_outer)
            for r in recs[:steps]] == [s[:3] for s in ref]
    if mxiter == 2:
        assert ref[0][0] == 2
    else:
        assert all(1 < s[0] < mxiter for s in ref)
    bar = 10 * sim.gwt_solution.s.outer_dvclose
    for r, c, s in zip(recs, sim.conc_records, ref):
        np.testing.assert_allclose(r.head, s[3], rtol=0, atol=1e-10)
        np.testing.assert_allclose(c, s[4], rtol=0, atol=bar)


def test_r9_reference_group_passes_advance_the_transport_again(ref_density):
    """R9: the reference's Simulation solves each pass's transport from the
    previous pass's concentration, and the step's transport once more
    after the loop (simulation.py:286-304, 390-391), so one step advances
    the transport up to MXITER times: with MXITER 2 its first step's
    front lies further east than its own pieces driven in sgp_ca order
    (which the port matches: the test above)."""
    import jax.numpy as jnp
    from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
    from modflow6_tpu.timing.tdis import Tdis as JaxTdis
    jsim = ref_density
    jsim.tdis = JaxTdis((JaxPeriod(DENSITY_DELT, 1, 1.0),))
    jsim.conc, jsim.sgp_mxiter = jnp.asarray(jsim.gwt.strt), 2
    jsim.run()
    pieces = reference_group_steps(jsim, 2, 1)
    assert jsim.conc_records[0][3] > pieces[0][4][3] + 0.1


# ---------------------------------------------------------- refusals

NAM = """BEGIN OPTIONS
END OPTIONS
BEGIN PACKAGES
{}
END PACKAGES
"""


def small_gwt_deck(ws):
    """A 1 x 1 x 10 GWF + GWT deck with every ported GWT package: ADV,
    DSP (XT3D_OFF), MST, SSM on a WEL aux column, CNC, SRC and OC."""
    write(ws, "mfsim.nam", """BEGIN OPTIONS
END OPTIONS
BEGIN TIMING
  TDIS6 sim.tdis
END TIMING
BEGIN MODELS
  GWF6 flow.nam FLOW
  GWT6 trans.nam TRANS
END MODELS
BEGIN EXCHANGES
  GWF6-GWT6 ft.exg FLOW TRANS
END EXCHANGES
BEGIN SOLUTIONGROUP 1
  IMS6 flow.ims FLOW
  IMS6 trans.ims TRANS
END SOLUTIONGROUP
""")
    write(ws, "sim.tdis", "BEGIN DIMENSIONS\n  NPER 1\nEND DIMENSIONS\n"
          "BEGIN PERIODDATA\n  2.0 2 1.0\nEND PERIODDATA\n")
    write(ws, "flow.ims", ims_text(hclose=1e-8, rclose=1e-8))
    write(ws, "trans.ims", ims_text("BICGSTAB", hclose=1e-8, rclose=1e-8))
    write(ws, "ft.exg", "BEGIN OPTIONS\nEND OPTIONS\n")
    dis = ("BEGIN DIMENSIONS\n  NLAY 1\n  NROW 1\n  NCOL 10\nEND DIMENSIONS\n"
           "BEGIN GRIDDATA\n  DELR\n    CONSTANT 1.0\n  DELC\n    CONSTANT "
           "1.0\n  TOP\n    CONSTANT 1.0\n  BOTM\n    CONSTANT 0.0\n"
           "END GRIDDATA\n")
    write(ws, "flow.nam", NAM.format(
        "  DIS6 flow.dis\n  IC6 flow.ic\n  NPF6 flow.npf\n  CHD6 flow.chd "
        "chd-1\n  WEL6 flow.wel wel-1"))
    write(ws, "flow.dis", dis)
    write(ws, "flow.ic", "BEGIN GRIDDATA\n  STRT\n    CONSTANT 1.0\n"
          "END GRIDDATA\n")
    write(ws, "flow.npf", "BEGIN GRIDDATA\n  ICELLTYPE\n    CONSTANT 0\n"
          "  K\n    CONSTANT 1.0\nEND GRIDDATA\n")
    write(ws, "flow.chd", "BEGIN DIMENSIONS\n  MAXBOUND 1\nEND DIMENSIONS\n"
          "BEGIN PERIOD 1\n  1 1 10 0.0\nEND PERIOD\n")
    write(ws, "flow.wel", "BEGIN OPTIONS\n  AUXILIARY CONCENTRATION\n"
          "END OPTIONS\nBEGIN DIMENSIONS\n  MAXBOUND 1\nEND DIMENSIONS\n"
          "BEGIN PERIOD 1\n  1 1 1 1.0 1.0\nEND PERIOD\n")
    write(ws, "trans.nam", NAM.format(
        "  DIS6 trans.dis\n  IC6 trans.ic\n  ADV6 trans.adv\n  DSP6 trans.dsp"
        "\n  MST6 trans.mst\n  SSM6 trans.ssm\n  CNC6 trans.cnc\n"
        "  SRC6 trans.src\n  OC6 trans.oc"))
    write(ws, "trans.dis", dis)
    write(ws, "trans.ic", "BEGIN GRIDDATA\n  STRT\n    CONSTANT 0.0\n"
          "END GRIDDATA\n")
    write(ws, "trans.adv", "BEGIN OPTIONS\n  SCHEME TVD\nEND OPTIONS\n")
    write(ws, "trans.dsp", "BEGIN OPTIONS\n  XT3D_OFF\nEND OPTIONS\n"
          "BEGIN GRIDDATA\n  ALH\n    CONSTANT 0.5\n  DIFFC\n"
          "    CONSTANT 1e-3\nEND GRIDDATA\n")
    write(ws, "trans.mst", "BEGIN OPTIONS\n  FIRST_ORDER_DECAY\n"
          "END OPTIONS\nBEGIN GRIDDATA\n  POROSITY\n    CONSTANT 0.1\n"
          "  DECAY\n    CONSTANT 0.01\nEND GRIDDATA\n")
    write(ws, "trans.ssm", "BEGIN SOURCES\n  WEL-1 AUX CONCENTRATION\n"
          "END SOURCES\n")
    write(ws, "trans.cnc", "BEGIN DIMENSIONS\n  MAXBOUND 1\nEND DIMENSIONS\n"
          "BEGIN PERIOD 1\n  1 1 5 0.5\nEND PERIOD\n")
    write(ws, "trans.src", "BEGIN DIMENSIONS\n  MAXBOUND 2\nEND DIMENSIONS\n"
          "BEGIN PERIOD 1\n  1 1 7 0.01\n  1 1 7 0.02\nEND PERIOD\n")
    write(ws, "trans.oc", "BEGIN OPTIONS\n  CONCENTRATION FILEOUT trans.ucn\n"
          "END OPTIONS\n")


def _edit(name, fn):
    def apply(ws):
        path = os.path.join(ws, name)
        with open(path) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(fn(text))
    return apply


def _package(line, fname=None, text=""):
    def apply(ws):
        _edit("trans.nam", lambda t: t.replace(
            "END PACKAGES", f"  {line}\nEND PACKAGES"))(ws)
        if fname:
            write(ws, fname, text)
    return apply


_APT_TEXT = "BEGIN PACKAGEDATA\n  1 0.0\nEND PACKAGEDATA\n"
# key → (edit of the small deck, what the reference does with it[, the
# port's error when it is not NotImplementedError])
REFUSED = {
    "PERIOD 2 of CNC6": (_edit("trans.cnc", lambda t: t + (
        "BEGIN PERIOD 2\n  1 1 5 0.9\nEND PERIOD\n")), "loads"),
    "PERIOD 2 of SRC6": (_edit("trans.src", lambda t: t + (
        "BEGIN PERIOD 2\n  1 1 7 0.5\nEND PERIOD\n")), "loads"),
    "CONCENTRATION values that change in PERIOD 2": (
        lambda ws: (_edit("sim.tdis", lambda t: t.replace("NPER 1", "NPER 2")
                          .replace("  2.0 2 1.0", "  2.0 2 1.0\n  1.0 1 1.0"))
                    (ws), _edit("flow.wel", lambda t: t + (
                        "BEGIN PERIOD 2\n  1 1 1 1.0 0.3\nEND PERIOD\n"))(ws)),
        "loads"),
    "AUXMIXED": (_edit("trans.ssm", lambda t: t.replace(" AUX ",
                                                        " AUXMIXED ")),
                 "loads"),
    "IST6": (_package("IST6 trans.ist", "trans.ist",
                      "BEGIN GRIDDATA\n  POROSITY\n    CONSTANT 0.1\n"
                      "END GRIDDATA\n"), "loads"),
    "ATS_PERCEL": (_edit("trans.adv", lambda t: t.replace(
        "  SCHEME TVD", "  SCHEME TVD\n  ATS_PERCEL 0.5")), "loads"),
    "XT3D_OFF": (_edit("trans.dsp", lambda t: t.replace("  XT3D_OFF\n", "")),
                 "loads"),
    "DECAY_SORBED": (_edit("trans.mst", lambda t: t.replace(
        "END GRIDDATA", "  DECAY_SORBED\n    CONSTANT 0.5\nEND GRIDDATA")),
        "loads"),
    # an APT file beside a flow model without its feature: both refuse
    # (the port's ValueError names the file type)
    "LKT6": (_package("LKT6 trans.lkt", "trans.lkt", _APT_TEXT), "raises",
             ValueError),
    "SFT6": (_package("SFT6 trans.sft", "trans.sft", _APT_TEXT), "raises",
             ValueError),
    "MWT6": (_package("MWT6 trans.mwt", "trans.mwt", _APT_TEXT), "raises",
             ValueError),
    "UZT6": (_package("UZT6 trans.uzt", "trans.uzt", _APT_TEXT), "raises",
             ValueError),
    # a GWE6 model loads (test_torch_gwe.py); this one's GWT packages,
    # which the reference's GWE loader reads past, raise
    "GWE6": (_edit("mfsim.nam", lambda t: t.replace(
        "  GWT6 trans.nam TRANS", "  GWE6 trans.nam TRANS")), "loads"),
    "several GWT6 models": (_edit("mfsim.nam", lambda t: t.replace(
        "  GWT6 trans.nam TRANS", "  GWT6 trans.nam TRANS\n"
        "  GWT6 trans.nam TRANS2")), "raises"),
    "GWT6 beside several GWF6 models": (_edit("mfsim.nam", lambda t: t.replace(
        "  GWF6 flow.nam FLOW", "  GWF6 flow.nam FLOW\n  GWF6 flow.nam FLOW2")
        .replace("BEGIN EXCHANGES", "BEGIN EXCHANGES\n"
                 "  GWF6-GWF6 ff.exg FLOW FLOW2")), "raises"),
}


@pytest.mark.parametrize("key", sorted(REFUSED))
def test_gwt_refusals(tmp_path, key):
    """What the reference reads past or runs another way, and what it
    refuses too, raises here by name."""
    ws = str(tmp_path)
    small_gwt_deck(ws)
    edit, ref_does, *error = REFUSED[key]
    edit(ws)
    if key == "GWT6 beside several GWF6 models":
        write(ws, "ff.exg", "BEGIN DIMENSIONS\n  NEXG 1\nEND DIMENSIONS\n"
              "BEGIN EXCHANGEDATA\n  1 1 10 1 1 1 1 0.5 0.5 1.0\n"
              "END EXCHANGEDATA\n")
    with pytest.raises(error[0] if error else NotImplementedError,
                       match=key):
        load(ws)
    if ref_does == "loads":
        assert ref_load(ws).gwt is not None
    else:
        with pytest.raises(Exception):
            ref_load(ws)


def test_small_gwt_deck_loads_like_the_reference(tmp_path):
    """The unrefused deck: the same transport model from both loaders (TVD,
    DSP, first-order decay, the well's aux concentration, CNC, two SRC
    entries on one cell), the transport IMS by model name, and runs."""
    ws = str(tmp_path)
    small_gwt_deck(ws)
    port, ref = load(ws), ref_load(ws)
    got, want = (gwt_reference_arrays(s.gwt) for s in (port, ref))
    assert got[1].keys() == want[1].keys()
    for key in ("iadvwt", "idcy", "isrb", "dsp", "ist", "eqnsclfac"):
        assert got[1][key] == want[1][key], key
    np.testing.assert_array_equal(got[1]["ssm_spec"]["WEL"],
                                  want[1]["ssm_spec"]["WEL"])
    assert got[0].keys() == want[0].keys()
    for key, value in want[0].items():
        np.testing.assert_array_equal(got[0][key], value, err_msg=key)
    assert port.gwt_solution.s == ImsSettings(**{
        k: v for k, v in vars(ref.gwt_solution.s).items()
        if k in vars(port.gwt_solution.s)})
    recs = port.run()
    assert all(r.converged and r.transport_converged for r in recs)
    assert len(read_head_file(os.path.join(ws, "trans.ucn"))) == 2


def test_r10_sorption_loads_where_the_reference_fails(tmp_path):
    """R10: the reference's loader maps SORPTION through constants that its
    mst module does not define (loader.py:1062-1064), so any MST6 with a
    SORPTION option raises AttributeError there; the port loads it as
    build_gwt takes it."""
    ws = str(tmp_path)
    small_gwt_deck(ws)
    _edit("trans.mst", lambda t: t.replace(
        "  FIRST_ORDER_DECAY\n", "  FIRST_ORDER_DECAY\n  SORPTION LINEAR\n")
        .replace("END GRIDDATA", "  BULK_DENSITY\n    CONSTANT 1.6\n"
                 "  DISTCOEF\n    CONSTANT 0.1\nEND GRIDDATA"))(ws)
    with pytest.raises(AttributeError, match="SORPTION_FREUNDLICH"):
        ref_load(ws)
    sim = load(ws)
    a = sim.gwt.mst_arrays
    assert sim.gwt.mst_opts.isrb == 1
    assert a.bulk_density.tolist() == [1.6] * 10
    assert a.distcoef.tolist() == [0.1] * 10


def test_cli_writes_the_concentration_file_and_reports_failures(tmp_path):
    """``python -m modflow6_torch`` on a GWT deck: the .ucn file; a
    transport step that does not converge is reported in the listing and
    on standard error, and, as in the reference, does not end the run."""
    ws = str(tmp_path)
    small_gwt_deck(ws)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert cli_main([ws, "--device", "cpu"]) == 0
    assert "Normal termination" in out.getvalue() and not err.getvalue()
    assert len(read_head_file(os.path.join(ws, "trans.ucn"))) == 2
    write(ws, "trans.ims", ims_text("BICGSTAB", hclose=1e-12, rclose=1e-12,
                                    nouter=1))
    lst = os.path.join(ws, "run.lst")
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert cli_main([ws, "--device", "cpu", "--lst", lst]) == 0
    assert "Transport convergence failure occurred 2 time(s)" in \
        err.getvalue()
    with open(lst) as f:
        text = f.read()
    assert "*** GWT NONCONVERGENCE kper=1 kstp=1 ***" in text
