"""GWT solute transport in the port (modflow6_torch/models/gwt: FMI, ADV
with TVD, DSP, MST, IST, SSM, CNC, SRC, the builder, CoupledGwfGwt and
merge_gwt_models) against the reference (modflow6_tpu/models/gwt).

Bars: FMI's fields of one flow solution: q_edge bitwise, the CHD flows
1e-10 relative (a per-cell sum in another order), the other entries and
the storage rates to rounding; assembled transport systems 1e-12 relative;
DSP's per-edge conductances 1e-12 relative (XLA's cos, sin, arccos, arcsin
and sqrt differ from PyTorch's in the last bit:
``test_trig_differs_in_the_last_bit``).  Against the jitted reference,
transport runs have equal outer counts and concentrations within
10 × outer_dvclose, at closures double precision reaches (outer 1e-6,
inner 1e-8): the reference multiplies a DIS transport system through its
structured shifts and the port through the ELL gather, so BiCGSTAB's
inner counts follow the sum order (ROADMAP Queue C).  The scenarios of
tests/test_gwt.py, test_gwt_dsp.py and test_ist.py hold the port to their
own analytic oracles at their own closures, except where BiCGSTAB spends
its 2,000 iterations on a first outer that cannot meet tests/test_gwt.py's
tight() (the pure-diffusion column, the single model beside the merged
pair): there the outer closure 1e-6 meets the oracles' bars.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from test_torch_parity import build_both, flagship_args
from modflow6_tpu.models.discretization import DisGrid as JaxDisGrid
from modflow6_tpu.models.gwf.builder import build_gwf as jax_build_gwf
from modflow6_tpu.models.gwf.exchange import ExchangePair as JaxPair
from modflow6_tpu.models.gwf.exchange import GwfGwfExchange as JaxExchange
from modflow6_tpu.models.gwf.exchange import merge_gwf_models as jax_merge
from modflow6_tpu.models.gwt import adv as jadv
from modflow6_tpu.models.gwt import dsp as jdsp
from modflow6_tpu.models.gwt import ist as jist
from modflow6_tpu.models.gwt.builder import CoupledGwfGwt as JaxCoupled
from modflow6_tpu.models.gwt.builder import build_gwt as jax_build_gwt
from modflow6_tpu.models.gwt.exchange import merge_gwt_models as jax_merge_gwt
from modflow6_tpu.models.gwt.fmi import FlowFields as JaxFields
from modflow6_tpu.models.gwt.fmi import fields_from_files as jax_from_files
from modflow6_tpu.models.gwt.fmi import from_gwf_step as jax_from_gwf_step
from modflow6_tpu.solution import ImsSettings as JaxImsSettings
from modflow6_tpu.solution import NumericalSolution as JaxSolution
from modflow6_torch.convert import gwt_from_reference
from modflow6_torch.models.discretization import DisGrid
from modflow6_torch.models.gwf.builder import build_gwf
from modflow6_torch.models.gwf.exchange import (ExchangePair, GwfGwfExchange,
                                                merge_gwf_models)
from modflow6_torch.models.gwt import adv, dsp, ist, mst
from modflow6_torch.models.gwt.builder import (CoupledGwfGwt, build_gwt,
                                               make_dsp)
from modflow6_torch.models.gwt.exchange import merge_gwt_models
from modflow6_torch.models.gwt.fmi import (FlowFields, fields_from_files,
                                           from_gwf_step)
from modflow6_torch.models.simulation import Simulation
from modflow6_torch.ops.system import apply_dirichlet, to_scipy_csr
from modflow6_torch.solution import ImsSettings
from modflow6_torch.solution.ims import NumericalSolution
from modflow6_torch.timing.tdis import StressPeriod, Tdis

# closures double precision reaches: the outer counts of the two packages
# are compared there
REACH = dict(outer_dvclose=1e-6, outer_maximum=50, inner_dvclose=1e-8,
             inner_rclose=1e-6, inner_maximum=500,
             linear_acceleration="bicgstab")
# tests/test_gwt.py:tight()
TIGHT = dict(outer_dvclose=1e-10, outer_maximum=50, inner_dvclose=1e-12,
             inner_rclose=1e-10, inner_maximum=2000,
             linear_acceleration="bicgstab")
FLOW = dict(outer_dvclose=1e-9, outer_maximum=50, inner_dvclose=1e-10,
            inner_rclose=1e-9, inner_maximum=500)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, rtol=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


# ------------------------------------------------------------------ FMI

def ref_fields(model, head, head_old, ibound, delt, iss, **kw):
    """The reference's from_gwf_step of the port's flow solution, jitted
    (one XLA compile in the place of one per eager operation), for the
    scenarios that hold transport runs at 10 × outer_dvclose; the FMI
    tests hold the eager function's fields bit for bit (XLA's fused
    kernels may round q_edge in another last bit)."""
    return jax.jit(lambda h, ho, ib: jax_from_gwf_step(
        model, h, ho, ib, None, delt, iss, **kw))(
        *(jnp.asarray(t.numpy()) for t in (head, head_old, ibound)))


def flow_args():
    """tests/test_torch_parity.py's flagship model at 2 x 12 x 10: CHD
    columns, a well, recharge and storage; the recharge of a third of the
    cells doubled, so the flow is two-dimensional."""
    grid, kw = flagship_args(nlay=2, nrow=12, ncol=10)
    kw = dict(kw, rch=[(n, 2e-4 if n % 3 == 0 else 1e-4)
                       for n in range(120)])
    return grid, kw


SSM_SPEC = {"RCH": 0.5, "WEL": 0.0, "CHD": 0.0}


@pytest.fixture(scope="module")
def flow():
    """One transient flow step solved by the port; FMI's fields of that
    solution in both packages."""
    ref, port = build_both(flow_args())
    head, info, aux = NumericalSolution(port, ImsSettings(
        **FLOW)).solve_timestep(port.strt, 5.0, iss=False)
    assert info.converged
    ib = aux["ibound"]
    jf = jax_from_gwf_step(ref, jnp.asarray(head.numpy()),
                           jnp.asarray(port.strt.numpy()),
                           jnp.asarray(ib.numpy()), None, 5.0, False,
                           ssm_spec=SSM_SPEC)
    pf = from_gwf_step(port, head, port.strt, ib, None, 5.0, False,
                       ssm_spec=SSM_SPEC)
    return ref, port, jf, pf, head


def test_from_gwf_step_fields_match_reference(flow):
    _, port, jf, pf, _ = flow
    np.testing.assert_array_equal(pf.q_edge.numpy(), np.asarray(jf.q_edge))
    for name in ("sat", "sat_old", "strg_ss", "strg_sy"):
        close(getattr(pf, name).numpy(), getattr(jf, name), rtol=1e-14)
    np.testing.assert_array_equal(pf.bound_node.numpy(),
                                  np.asarray(jf.bound_node))
    np.testing.assert_array_equal(pf.bound_mask.numpy(),
                                  np.asarray(jf.bound_mask))
    np.testing.assert_array_equal(pf.bound_conc.numpy(),
                                  np.asarray(jf.bound_conc))
    nchd = port.chd.node.shape[0]
    q, want = pf.bound_q.numpy(), np.asarray(jf.bound_q)
    np.testing.assert_array_equal(q[:-nchd], want[:-nchd])
    close(q[-nchd:], want[-nchd:], rtol=1e-10)
    assert np.abs(want[-nchd:]).max() > 0 and np.abs(pf.strg_ss.numpy()).max()


def test_fields_keep_one_entry_layout(flow):
    """A second step of the same packages gives the same bound_node
    tensor: the transport model keeps FMI's entry layout, so its SSM sum
    plan is built once."""
    _, port, _, pf, head = flow
    gwt = build_gwt("t", DisGrid.create(**flow_args()[0]), device="cpu")

    def fields():
        return from_gwf_step(port, head, port.strt, port.ibound0, None,
                             5.0, False, gwt=gwt)

    first, again = fields(), fields()
    assert again.bound_node is first.bound_node
    assert again.bound_mask is first.bound_mask
    np.testing.assert_array_equal(first.bound_node.numpy(),
                                  pf.bound_node.numpy())


def test_fields_of_a_convertible_model_match_reference():
    """The same grid with its cells convertible (icelltype 1, storage with
    SY) and the water table in layer 1: the saturations and both storage
    rates from FMI."""
    grid, kw = flow_args()
    kw = dict(kw, icelltype=1, storage={"ss": 1e-5, "sy": 0.15,
                                        "iconvert": 1})
    ref, port = build_both((grid, kw))
    head, info, aux = NumericalSolution(port, ImsSettings(
        outer_dvclose=1e-6, inner_dvclose=1e-8, inner_rclose=1e-6,
        inner_maximum=300)).solve_timestep(port.strt, 5.0, iss=False)
    assert info.converged
    ib = aux["ibound"]
    jf = jax_from_gwf_step(ref, jnp.asarray(head.numpy()),
                           jnp.asarray(port.strt.numpy()),
                           jnp.asarray(ib.numpy()), None, 5.0, False)
    pf = from_gwf_step(port, head, port.strt, ib, None, 5.0, False)
    np.testing.assert_array_equal(pf.q_edge.numpy(), np.asarray(jf.q_edge))
    for name in ("sat", "sat_old", "strg_ss", "strg_sy"):
        close(getattr(pf, name).numpy(), getattr(jf, name), rtol=1e-13)
    assert np.abs(pf.strg_sy.numpy()).max() > 0
    assert (pf.sat.numpy() < 1).any()


# ------------------------------------------------------ assembled systems

SYSTEMS = {
    "upstream": dict(scheme="upstream"),
    "central+dsp": dict(scheme="central",
                        dsp=dict(alh=10.0, ath1=1.0, atv=0.1, diffc=1e-3)),
    "tvd+dsp+linear+decay+cnc+src": dict(
        scheme="tvd", dsp=dict(alh=5.0, ath1=0.5, diffc=1e-3),
        decay=(mst.DECAY_FIRST_ORDER, 1e-3),
        sorption=dict(isrb=mst.SORPTION_LINEAR, bulk_density=1.6,
                      distcoef=0.1),
        cnc=[(3, 1.0), (125, 0.7)], src=[(40, 0.2), (41, 0.1), (40, 0.3)]),
    "freundlich+zero-order": dict(
        scheme="upstream", decay=(mst.DECAY_ZERO_ORDER, 2e-3),
        sorption=dict(isrb=mst.SORPTION_FREUND, bulk_density=1.6,
                      distcoef=0.2, sp2=0.7)),
    "langmuir+decay": dict(
        scheme="upstream", decay=(mst.DECAY_FIRST_ORDER, 1e-3),
        sorption=dict(isrb=mst.SORPTION_LANG, bulk_density=1.6,
                      distcoef=0.3, sp2=2.0)),
    "ist": dict(scheme="upstream", ist=dict(
        thetaim=0.1, zetaim=0.05, volfrac=0.3, bulk_density=1.6,
        distcoef=0.2, decay=1e-3, idcy=1, isrb=1)),
}


def both_gwt(kw, grid=None, ssm_spec=SSM_SPEC):
    grid = grid or flow_args()[0]
    kw = dict(kw, porosity=0.3, ssm_spec=ssm_spec)
    return (jax_build_gwt("ref", JaxDisGrid.create(**grid), **kw),
            build_gwt("port", DisGrid.create(**grid), device="cpu", **kw))


def concentrations(n, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, n)


@pytest.mark.parametrize("case", sorted(SYSTEMS))
def test_transport_system_matches_reference(flow, case):
    """ADV's three schemes, DSP, MST's storage, decay and sorption, SSM,
    IST, CNC and SRC (repeated cells) assembled at the same iterate."""
    _, _, jf, pf, _ = flow
    jt, pt = both_gwt(SYSTEMS[case])
    n = pt.nodes
    c, c_old = concentrations(n, 1), concentrations(n, 2)
    if pt.ist is not None:
        cim = concentrations(n, 3)
        jf = dataclasses.replace(jf, cim=jnp.asarray(cim))
        pf = dataclasses.replace(pf, cim=t64(cim))
    jib, jc = jt.boundary_state(jnp.asarray(c))
    pib, pc = pt.boundary_state(t64(c))
    np.testing.assert_array_equal(pib.numpy(), np.asarray(jib))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    # jitted: one XLA compile in the place of one per eager operation
    want = jax.jit(lambda c, co, ib, f: jt.assemble(c, co, ib, 5.0, False,
                                                    f))(
        jc, jnp.asarray(c_old), jib, jf)
    got = pt.assemble(pc, t64(c_old), pib, 5.0, False, pf)
    for g, w in zip(got, want):
        close(g.numpy().reshape(np.shape(w)), w)


def test_cnc_repeated_cell_takes_the_last_entry():
    """Two CNC entries on one cell: the last sets it (JAX's .at[].set
    leaves the winner unspecified)."""
    g = DisGrid.create(1, 1, 4, 1.0, 1.0, 1.0, np.zeros((1, 1, 4)))
    model = build_gwt("t", g, cnc=[(1, 0.2), (2, 5.0), (1, 0.7)],
                      device="cpu")
    ib, c = model.boundary_state(torch.zeros(4, dtype=torch.float64))
    assert ib.tolist() == [1, -1, -1, 1]
    assert c.tolist() == [0.0, 0.7, 5.0, 0.0]


def test_src_repeated_cells_sum_in_entry_order():
    """SRC entries on one cell add in entry order (the reference's
    .at[].add order), through the model's sum plan."""
    g = DisGrid.create(1, 1, 3, 1.0, 1.0, 1.0, np.zeros((1, 1, 3)))
    rates = [0.1, 1e16, -1e16, 0.3]
    model = build_gwt("t", g, src=[(1, q) for q in rates], device="cpu")
    rhs = model.src.add_plan.add(torch.zeros(3, dtype=torch.float64),
                                 -model.src.q)
    want = 0.0
    for q in rates:
        want += -q
    assert rhs.tolist() == [0.0, want, 0.0]


# ---------------------------------------------------------------- TVD

def _diagonal_fields(n):
    """Flow from west to east and from north to south through every face
    of an n x n layer: every inner cell's west and north inflows tie."""
    g = DisGrid.create(1, n, n, 1.0, 1.0, 1.0, np.zeros((1, n, n)))
    topo = g.build_edge_topology()
    q = -np.ones(topo.nedges)          # positive into n: into the
    z = np.zeros(n * n)                # west / north cell
    return g, q, z


def test_tvd_tie_takes_the_first_slot_like_the_reference():
    n = 5
    g, q, z = _diagonal_fields(n)
    model = build_gwt("t", g, scheme="tvd", device="cpu")
    jg = JaxDisGrid.create(1, n, n, 1.0, 1.0, 1.0, np.zeros((1, n, n)))
    jt = jax_build_gwt("t", jg, scheme="tvd")
    pf = FlowFields(t64(q), t64(z + 1), t64(z + 1), t64(z), t64(z),
                    t64([0.0]), torch.zeros(1, dtype=torch.int64),
                    torch.zeros(1, dtype=torch.bool), t64([0.0]))
    jf = JaxFields(jnp.asarray(q), jnp.ones(n * n), jnp.ones(n * n),
                   jnp.zeros(n * n), jnp.zeros(n * n), jnp.zeros(1),
                   jnp.zeros(1, jnp.int32), jnp.zeros(1, bool), jnp.zeros(1))
    ib = torch.ones(n * n, dtype=torch.int32)
    i2up, el2, has2 = adv.second_upstream(model.dtopo, pf, ib)
    # the reference's own lines (adv.py:73-88)
    dt = jt.dtopo
    K = dt.max_degree
    inflow = jnp.zeros(n * n * K).at[dt.slot_nm].add(jnp.asarray(q)) \
        .at[dt.slot_mn].add(-jnp.asarray(q)).reshape(n * n, K)
    best = jnp.argmax(inflow, axis=1)
    want = np.asarray(dt.nbr[jnp.arange(n * n), best])
    np.testing.assert_array_equal(i2up.numpy(), want)
    # an inner cell ties west and north and takes the west neighbour
    inner = 2 * n + 2
    assert inflow[inner, 1] == inflow[inner, 2] == 1.0
    assert i2up[inner] == inner - 1
    c = concentrations(n * n, 4)
    got = adv.tvd_rhs(model.dtopo, pf, ib, t64(c))
    ref = jax.jit(lambda f, ib, c: jadv.tvd_rhs(dt, f, ib, c))(
        jf, jnp.ones(n * n, jnp.int32), jnp.asarray(c))
    close(got.numpy(), ref)
    assert np.abs(got.numpy()).max() > 0


# ---------------------------------------------------------------- DSP

def test_dsp_conductances_match_reference(flow):
    _, _, jf, pf, _ = flow
    d = dict(alh=10.0, alv=2.0, ath1=1.0, ath2=0.5, atv=0.1, diffc=1e-3)
    jt, pt = both_gwt(dict(dsp=d))
    got = dsp.edge_conductance(pt.dtopo, pt.dsp, pt.mst_arrays.porosity, pf,
                               pt.ibound0, pt.top, pt.bot)
    want = jdsp.edge_conductance(jt.dtopo, jt.dsp, jt.mst_arrays.porosity,
                                 jf, jt.ibound0, jt.top, jt.bot)
    close(got.numpy(), want)
    qs = dsp.cell_spdis(pt.dtopo, pf.q_edge, pf.sat, pt.top, pt.bot)
    for g, w in zip(qs, jdsp.cell_spdis(jt.dtopo, jf.q_edge, jf.sat, jt.top,
                                        jt.bot)):
        close(g.numpy(), w)


def test_trig_differs_in_the_last_bit():
    """Why DSP's conductances are held to 1e-12 and not bitwise: XLA's and
    PyTorch's float64 cos, sin, arccos, arcsin and sqrt round some
    arguments differently (by an ulp or so)."""
    x = np.random.default_rng(0).uniform(-1.0, 1.0, 20000)
    for name in ("cos", "sin", "arccos", "arcsin", "sqrt"):
        arg = np.abs(x) if name == "sqrt" else x
        want = np.asarray(getattr(jnp, name)(jnp.asarray(arg)))
        got = getattr(torch, name)(t64(arg)).numpy()
        assert (got != want).any(), name
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


# --------------------------------------------------------- MST and IST

def test_ist_terms_match_reference():
    """IST's effective kd (linear, Freundlich, Langmuir), its mobile-
    equation terms and the immobile update, with first- and zero-order
    decay."""
    n = 16
    rng = np.random.default_rng(5)
    sat, area = rng.uniform(0.5, 1.0, n), rng.uniform(50.0, 150.0, n)
    top, bot = np.full(n, 10.0), np.zeros(n)
    c_old, cim, c_new = (rng.uniform(0.0, 2.0, n) for _ in range(3))
    ib = np.ones(n, np.int32)
    ib[3] = 0
    for isrb, idcy in ((0, 0), (1, 1), (2, 2), (3, 1)):
        kw = dict(thetaim=0.1, zetaim=0.5, volfrac=0.3, bulk_density=1.6,
                  distcoef=0.6, decay=0.01, decay_sorbed=0.02, sp2=0.7,
                  idcy=idcy, isrb=isrb)
        pi, ji = ist.make_ist(n, device="cpu", **kw), jist.make_ist(n, **kw)
        close(ist.effective_kd(pi, t64(cim)).numpy(),
              jist.effective_kd(ji, jnp.asarray(cim)))
        args = [sat, area, top, bot]
        for g, w in zip(
                ist.ist_terms(pi, *map(t64, args), torch.as_tensor(ib),
                              t64(c_old), t64(cim), 2.0),
                jist.ist_terms(ji, *map(jnp.asarray, args), jnp.asarray(ib),
                               jnp.asarray(c_old), jnp.asarray(cim), 2.0)):
            close(g.numpy(), w)
        close(ist.ist_update(pi, *map(t64, args), torch.as_tensor(ib),
                             t64(c_old), t64(cim), t64(c_new), 2.0).numpy(),
              jist.ist_update(ji, *map(jnp.asarray, args), jnp.asarray(ib),
                              jnp.asarray(c_old), jnp.asarray(cim),
                              jnp.asarray(c_new), 2.0))


# ------------------------------------------- the reference's scenarios

def column(ncol=40, q=1.0, delr=10.0, device="cpu"):
    """tests/test_gwt.py:make_flow_column in both packages."""
    grid = dict(nlay=1, nrow=1, ncol=ncol, delr=delr, delc=1.0, top=1.0,
                botm=np.zeros((1, 1, ncol)))
    k = 10.0
    dh = q * (ncol - 1) * delr / k
    kw = dict(k=k, strt=10.0, chd=[(0, 10.0 + dh), (ncol - 1, 10.0)])
    return grid, kw


def steady_fields(grid, kw, ref=True):
    """The steady flow of (grid, kw) solved by the port, and FMI's fields
    of it in the reference (with ``ref``) and the port."""
    pm = build_gwf("f", DisGrid.create(**grid), device="cpu", **kw)
    head, info, aux = NumericalSolution(pm, ImsSettings(
        **FLOW)).solve_timestep(pm.strt, 1.0, iss=True)
    assert info.converged
    pf = from_gwf_step(pm, head, head, aux["ibound"], None, 1.0, True)
    if not ref:
        return None, pf
    jm = jax_build_gwf("f", JaxDisGrid.create(**grid), **kw)
    jf = ref_fields(jm, head, head, aux["ibound"], 1.0, True)
    return jf, pf


def run_both(grid, fields, kw, delt, nsteps, settings=REACH, ref=True,
             port=True):
    """The transport of ``kw`` on ``grid`` over ``nsteps`` steps in the
    port and the jitted reference (each where asked): ([outer], final
    conc) each."""
    jf, pf = fields
    out = []
    for which in ("port",) * port + ("ref",) * ref:
        if which == "port":
            model = build_gwt("t", DisGrid.create(**grid), device="cpu", **kw)
            sol = NumericalSolution(model, ImsSettings(**settings))
            conc, f = model.strt, pf
        else:
            model = jax_build_gwt("t", JaxDisGrid.create(**grid), **kw)
            sol = JaxSolution(model, JaxImsSettings(**settings))
            conc, f = jnp.asarray(model.strt), jf
        model.set_flows(f)
        outers = []
        for kstp in range(1, nsteps + 1):
            conc, info, _ = sol.solve_timestep(conc, delt, kstp=kstp,
                                               iss=False, pkgs=f)
            assert info.converged
            outers.append(info.outer_iterations)
        out.append((outers, np.asarray(conc)))
    return out


def assert_runs_agree(runs, settings=REACH):
    (po, pc), (ro, rc) = runs
    assert po == ro
    np.testing.assert_allclose(pc, rc, rtol=0,
                               atol=10 * settings["outer_dvclose"])


@pytest.fixture(scope="module")
def column60():
    """tests/test_gwt.py's flow column at 60 cells and its fields in both
    packages, shared by the advection, TVD and sorption scenarios."""
    grid, kw = column(ncol=60)
    return grid, steady_fields(grid, kw)


def test_advection_upstream_vs_direct_and_reference(column60):
    """tests/test_gwt.py::test_advection_upstream_vs_direct: every step
    against a scipy direct solve of the port's own system; the front is
    bounded and monotone; the jitted reference agrees."""
    grid, fields = column60
    tkw = dict(porosity=0.3, strt=0.0, scheme="upstream", cnc=[(0, 1.0)])
    gwt = build_gwt("t", DisGrid.create(**grid), device="cpu", **tkw)
    sol = NumericalSolution(gwt, ImsSettings(**TIGHT))
    pf = fields[1]
    conc, outers = gwt.strt, []
    for kstp in range(1, 6):
        conc_old = conc
        conc, info, _ = sol.solve_timestep(conc_old, 5.0, kstp=kstp,
                                           iss=False, pkgs=pf)
        assert info.converged
        outers.append(info.outer_iterations)
        ib, c0 = gwt.boundary_state(conc_old)
        d, o, r = gwt.assemble(c0, c0, ib, 5.0, False, pf)
        d, o, r = apply_dirichlet(gwt.dtopo.nbr, torch.sign(ib), d, o, r, c0,
                                  symmetric=False)
        x = spla.spsolve(to_scipy_csr(gwt.topo, d, o).tocsc(), r.numpy())
        np.testing.assert_allclose(conc.numpy(), x, atol=1e-9)
    c = conc.numpy()
    assert c[0] == 1.0
    assert np.all(c <= 1.0 + 1e-9) and np.all(c >= -1e-9)
    assert np.all(np.diff(c) <= 1e-9)
    (ref, ) = run_both(grid, fields, tkw, 5.0, 5, TIGHT, port=False)
    assert_runs_agree(((outers, c), ref), TIGHT)


def test_tvd_bounded_sharper_and_counts_like_the_reference(column60):
    """tests/test_gwt.py::test_tvd_bounded_and_sharper; TVD reads the
    iterate, so its system is rebuilt every outer iteration and the outer
    counts equal the reference's."""
    grid, fields = column60
    results = {}
    for scheme in ("upstream", "tvd"):
        tkw = dict(porosity=0.3, strt=0.0, scheme=scheme, cnc=[(0, 1.0)])
        runs = run_both(grid, fields, tkw, 3.0, 12, ref=scheme == "tvd")
        results[scheme] = runs[0][1]
    c_up, c_tvd = results["upstream"], results["tvd"]
    assert np.all(c_tvd <= 1.0 + 1e-6) and np.all(c_tvd >= -1e-6)
    assert np.max(np.abs(np.diff(c_tvd))) > np.max(np.abs(np.diff(c_up)))
    assert max(runs[0][0]) > 2           # Picard passes on the limiter
    assert_runs_agree(runs)
    assert not build_gwt("t", DisGrid.create(**grid), scheme="tvd",
                         device="cpu").is_linear


def test_decay_and_sorption_scenarios(column60):
    """tests/test_gwt.py: first-order decay in a closed cell (backward
    Euler, 1e-10) and linear sorption's retardation (front ratio R within
    20 %)."""
    g1 = dict(nlay=1, nrow=1, ncol=1, delr=1.0, delc=1.0, top=1.0,
              botm=np.zeros((1, 1, 1)))
    fields = steady_fields(g1, dict(k=1.0, strt=0.5), ref=False)
    lam = 0.05
    (_, c), = run_both(g1, fields, dict(porosity=0.4, strt=1.0, decay=(
        mst.DECAY_FIRST_ORDER, lam)), 0.5, 20, TIGHT, ref=False)
    np.testing.assert_allclose(c[0], 1.0 / (1.0 + lam * 0.5) ** 20,
                               rtol=1e-10)

    grid, fields = column60
    rhob, kd = 1.6, 0.1875

    def front(sorption):
        (_, c), = run_both(grid, fields, dict(
            porosity=0.3, strt=0.0, cnc=[(0, 1.0)], sorption=sorption),
            4.0, 10, ref=False)
        return float((c[1:] * np.arange(1, 60)).sum() / c[1:].sum())

    ratio = front(None) / front(dict(isrb=mst.SORPTION_LINEAR,
                                     bulk_density=rhob, distcoef=kd))
    np.testing.assert_allclose(ratio, 1 + rhob * kd / 0.3, rtol=0.2)


def test_coupled_gwf_gwt_ssm_matches_reference():
    """tests/test_gwt.py::test_coupled_gwf_gwt_ssm through CoupledGwfGwt in
    both packages: recharge at concentration 2 enters everywhere."""
    n = 12
    grid = dict(nlay=1, nrow=1, ncol=n, delr=10.0, delc=10.0, top=10.0,
                botm=np.zeros((1, 1, n)))
    fkw = dict(k=5.0, strt=5.0, storage={"ss": 1e-4, "iconvert": 0},
               chd=[(n - 1, 5.0)], rch=[(j, 1e-3) for j in range(n)])
    tkw = dict(porosity=0.3, strt=0.0, scheme="upstream",
               ssm_spec={"RCH": 2.0})
    flow_s = JaxImsSettings(**FLOW)
    jc = JaxCoupled(jax_build_gwf("f", JaxDisGrid.create(**grid), **fkw),
                    jax_build_gwt("t", JaxDisGrid.create(**grid), **tkw),
                    flow_s, JaxImsSettings(**REACH))
    pc = CoupledGwfGwt(
        build_gwf("f", DisGrid.create(**grid), device="cpu", **fkw),
        build_gwt("t", DisGrid.create(**grid), device="cpu", **tkw),
        ImsSettings(**FLOW), ImsSettings(**REACH))
    jh, jcn = jnp.asarray(jc.gwf.strt), jnp.asarray(jc.gwt.strt)
    ph, pcn = pc.gwf.strt, pc.gwt.strt
    for kstp in range(1, 6):
        jh, jcn, jfi, jti = jc.step(jh, jcn, 10.0, kstp)
        ph, pcn, pfi, pti = pc.step(ph, pcn, 10.0, kstp)
        assert pfi.converged and pti.converged
        assert pfi.outer_iterations == jfi.outer_iterations
        assert pti.outer_iterations == jti.outer_iterations
    c = pcn.numpy()
    assert np.all(c > 0) and np.all(c <= 2.0 + 1e-6)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), atol=1e-9)
    np.testing.assert_allclose(c, np.asarray(jcn), atol=10e-6)


def test_dsp_scenarios():
    """tests/test_gwt_dsp.py: the two-cell diffusion conductance (1.0), the
    pure-diffusion variance (2 D t, mass kept), the transverse mechanical
    spreading (2 α v t within 5 %), the defaults."""
    g2 = dict(nlay=1, nrow=1, ncol=2, delr=1.0, delc=1.0, top=1.0,
              botm=np.zeros((1, 1, 2)))
    _, pf = steady_fields(g2, dict(k=1.0, strt=0.5), ref=False)
    gwt = build_gwt("t", DisGrid.create(**g2), porosity=0.4,
                    dsp={"diffc": 2.5}, device="cpu")
    dc = dsp.edge_conductance(gwt.dtopo, gwt.dsp, gwt.mst_arrays.porosity,
                              pf, torch.ones(2, dtype=torch.int32), gwt.top,
                              gwt.bot)
    np.testing.assert_allclose(dc.numpy(), [1.0], rtol=1e-12)

    def moments(c, x):
        m0 = c.sum()
        mu = (c * x).sum() / m0
        return m0, mu, (c * (x - mu) ** 2).sum() / m0

    ncol = 101
    g = dict(nlay=1, nrow=1, ncol=ncol, delr=1.0, delc=1.0, top=1.0,
             botm=np.zeros((1, 1, ncol)))
    fields = steady_fields(g, dict(k=1.0, strt=0.5), ref=False)
    strt = np.zeros(ncol)
    strt[ncol // 2] = 1.0
    (_, c), = run_both(g, fields, dict(porosity=0.3, strt=strt,
                                       scheme="central",
                                       dsp={"diffc": 0.5}), 2.0, 10,
                       ref=False)
    m0, mu, var = moments(c, np.arange(ncol, dtype=float))
    np.testing.assert_allclose(m0, 1.0, rtol=1e-5)
    np.testing.assert_allclose(mu, ncol // 2, atol=1e-6)
    np.testing.assert_allclose(var, 2 * 0.5 * 2.0 * 10, rtol=1e-4)

    nrow, ncol, theta, q = 31, 41, 0.25, 0.5
    g = dict(nlay=1, nrow=nrow, ncol=ncol, delr=1.0, delc=1.0, top=1.0,
             botm=np.zeros((1, nrow, ncol)))
    dh = q * (ncol - 1) / 10.0
    fields = steady_fields(g, dict(
        k=10.0, strt=10.0, chd=[(r * ncol, 10.0 + dh) for r in range(nrow)]
        + [(r * ncol + ncol - 1, 10.0) for r in range(nrow)]), ref=False)
    strt = np.zeros((nrow, ncol))
    strt[nrow // 2, 8] = 1.0
    kw = dict(porosity=theta, strt=strt.ravel(), scheme="central")
    (_, c0), = run_both(g, fields, kw, 0.25, 24, ref=False)
    (_, c1), = run_both(g, fields, dict(kw, dsp={"alh": 0.2, "ath1": 0.1}),
                        0.25, 24, ref=False)
    y = np.repeat(np.arange(nrow, dtype=float), ncol)
    _, _, vary0 = moments(c0, y)
    m1, muy1, vary1 = moments(c1, y)
    v, t = q / theta, 0.25 * 24
    np.testing.assert_allclose(m1, 1.0, rtol=1e-5)
    np.testing.assert_allclose(muy1, nrow // 2, atol=1e-4)
    np.testing.assert_allclose(vary1 - vary0, 2 * 0.1 * v * t, rtol=0.05)

    d = make_dsp(4, {"alh": 1.0, "ath1": 0.3}, device="cpu")
    assert d.alv.tolist() == [1.0] * 4 and d.ath2.tolist() == [0.3] * 4
    assert d.atv.tolist() == [0.0] * 4 and (d.idisp, d.idiffc) == (1, 0)


def _no_flow(n, e, cim):
    z = torch.zeros
    return FlowFields(z(e, dtype=torch.float64),
                      torch.ones(n, dtype=torch.float64),
                      torch.ones(n, dtype=torch.float64),
                      z(n, dtype=torch.float64), z(n, dtype=torch.float64),
                      z(1, dtype=torch.float64), z(1, dtype=torch.int64),
                      z(1, dtype=torch.bool), z(1, dtype=torch.float64),
                      cim=cim)


def test_ist_scenarios():
    """tests/test_ist.py: the batch dual-domain exchange (θm c + θim cim
    kept to 1e-9 each step, equilibrium within 1e-4) and first-order decay
    in the immobile domain depleting the mass."""
    g = DisGrid.create(1, 1, 2, 1.0, 1.0, 1.0, np.zeros((1, 1, 2)))
    ib = torch.ones(2, dtype=torch.int32)
    for decay, steps in ((None, 60), (0.2, 20)):
        extra = {} if decay is None else dict(decay=decay, idcy=1)
        gwt = build_gwt("ist", g, porosity=0.25, strt=1.0, device="cpu",
                        ist=dict(thetaim=0.1, zetaim=0.3 if decay is None
                                 else 0.5, **extra))
        sol = NumericalSolution(gwt, ImsSettings(
            outer_dvclose=1e-10, inner_dvclose=1e-12, inner_rclose=1e-12,
            inner_maximum=200, linear_acceleration="bicgstab"))
        conc, cim, masses = gwt.strt, gwt.cim, []
        for _ in range(steps):
            fields = _no_flow(2, gwt.dtopo.edge_n.shape[0], cim)
            conc_new, info, _ = sol.solve_timestep(conc, 0.5, iss=False,
                                                   pkgs=fields)
            assert info.converged
            cim = ist.ist_update(gwt.ist, fields.sat, gwt.area, gwt.top,
                                 gwt.bot, ib, conc, cim, conc_new, 0.5)
            conc = conc_new
            total = 0.25 * conc.numpy() + 0.1 * cim.numpy()
            masses.append(float(total[0]))
            if decay is None:
                np.testing.assert_allclose(total, 0.25, rtol=1e-9)
        if decay is None:
            ceq = 0.25 / 0.35
            np.testing.assert_allclose(conc.numpy(), ceq, atol=1e-4)
            np.testing.assert_allclose(cim.numpy(), ceq, atol=1e-4)
        else:
            assert all(np.diff(masses) < 0) and masses[-1] < masses[0] * 0.9


def test_ist_through_simulation_matches_reference():
    """IST driven by Simulation in both packages: the immobile
    concentration is committed after each accepted transport solve."""
    from modflow6_tpu.models.simulation import Simulation as JaxSimulation
    from modflow6_tpu.timing.tdis import StressPeriod as JaxPeriod
    from modflow6_tpu.timing.tdis import Tdis as JaxTdis
    grid, kw = column(ncol=12)
    tkw = dict(porosity=0.3, strt=0.0, cnc=[(0, 1.0)],
               ist=dict(thetaim=0.1, zetaim=0.05))
    fkw = dict(kw, storage={"ss": 1e-5, "iconvert": 0})
    jsim = JaxSimulation(
        JaxTdis([JaxPeriod(perlen=20.0, nstp=4, tsmult=1.0)]),
        jax_build_gwf("f", JaxDisGrid.create(**grid), **fkw),
        JaxImsSettings(**FLOW),
        gwt=jax_build_gwt("t", JaxDisGrid.create(**grid), **tkw),
        gwt_settings=JaxImsSettings(**REACH))
    sim = Simulation(
        Tdis([StressPeriod(20.0, 4, 1.0)]),
        build_gwf("f", DisGrid.create(**grid), device="cpu", **fkw),
        ImsSettings(**FLOW),
        gwt=build_gwt("t", DisGrid.create(**grid), device="cpu", **tkw),
        gwt_settings=ImsSettings(**REACH))
    sim.run()
    jsim.run()
    for a, b in zip(sim.conc_records, jsim.conc_records):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(sim.gwt.cim.numpy(), np.asarray(jsim.gwt.cim),
                               atol=1e-5)
    assert sim.gwt.cim.numpy().max() > 1e-3


# ------------------------------------------------------ several models

def test_merged_gwt_models_match_single_and_reference():
    """tests/test_exchange.py:102: two GWT models over two exchanged GWF
    halves give the single model's transport (1e-8), and the reference's
    merged run (equal outer counts, 10 × outer_dvclose)."""
    ncol, half = 12, 6
    gh = dict(nlay=1, nrow=1, ncol=half, delr=10.0, delc=1.0, top=1.0,
              botm=np.zeros((1, 1, half)))
    gfull = dict(gh, ncol=ncol, botm=np.zeros((1, 1, ncol)))
    fkw = dict(k=2.0, strt=5.0, storage={"ss": 0.0, "iconvert": 0})
    tkw = dict(porosity=0.2, strt=0.0, scheme="upstream")
    out = {}
    for pkg in ("port", "ref"):
        if pkg == "port":
            grid, gwf, gwt, merge, merge_t, pair, exg, coupled, settings = (
                DisGrid, lambda *a, **k: build_gwf(*a, device="cpu", **k),
                lambda *a, **k: build_gwt(*a, device="cpu", **k),
                merge_gwf_models, merge_gwt_models, ExchangePair,
                GwfGwfExchange, CoupledGwfGwt, ImsSettings)
        else:
            grid, gwf, gwt, merge, merge_t, pair, exg, coupled, settings = (
                JaxDisGrid, jax_build_gwf, jax_build_gwt, jax_merge,
                jax_merge_gwt, JaxPair, JaxExchange, JaxCoupled,
                JaxImsSettings)
        g = grid.create(**gh)
        fm = merge([gwf("w", g, chd=[(0, 6.0)], **fkw),
                    gwf("e", g, chd=[(half - 1, 4.0)], **fkw)],
                   [exg(0, 1, [pair(half - 1, 0, ihc=1, cl1=5.0, cl2=5.0,
                                    hwva=1.0)])])
        tm = merge_t([gwt("tw", g, cnc=[(0, 1.0)], **tkw),
                      gwt("te", g, **tkw)], fm)
        cpl = coupled(fm, tm, settings(**FLOW), settings(**REACH))
        h, c, outers = fm.strt, tm.strt, []
        for k in range(4):
            h, c, fi, ti = cpl.step(h, c, delt=5.0, kstp=k + 1,
                                    iss_flow=True)
            assert fi.converged and ti.converged
            outers.append(ti.outer_iterations)
        out[pkg] = (outers, np.asarray(c))
    assert_runs_agree((out["port"], out["ref"]))
    single = CoupledGwfGwt(
        build_gwf("s", DisGrid.create(**gfull), chd=[(0, 6.0), (ncol - 1,
                                                               4.0)],
                  device="cpu", **fkw),
        build_gwt("ts", DisGrid.create(**gfull), cnc=[(0, 1.0)],
                  device="cpu", **tkw), ImsSettings(**FLOW),
        ImsSettings(**REACH))
    h, c = single.gwf.strt, single.gwt.strt
    for k in range(4):
        h, c, _, _ = single.step(h, c, delt=5.0, kstp=k + 1, iss_flow=True)
    np.testing.assert_allclose(out["port"][1], c.numpy(), atol=10e-6)


def test_merge_refuses_what_the_reference_drops():
    g = DisGrid.create(1, 1, 4, 10.0, 1.0, 1.0, np.zeros((1, 1, 4)))
    fm = merge_gwf_models(
        [build_gwf(n, g, k=1.0, strt=1.0, device="cpu") for n in "ab"],
        [GwfGwfExchange(0, 1, [ExchangePair(3, 0)])])
    plain = build_gwt("a", g, device="cpu")
    with pytest.raises(NotImplementedError, match="IST"):
        merge_gwt_models([plain, build_gwt("b", g, device="cpu", ist=dict(
            thetaim=0.1, zetaim=0.1))], fm)
    with pytest.raises(NotImplementedError, match="SSM"):
        merge_gwt_models([plain, build_gwt("b", g, device="cpu",
                                           ssm_spec={"RCH": 1.0})], fm)


# ------------------------------------------------ files and conversion

def test_fields_from_files_match_inline_and_reference(tmp_path):
    """tests/test_outputs.py:101: the transport from the .hds and .cbc of
    a flow run equals the inline coupled run (1e-9); the offline fields
    equal the reference's fields_from_files of the same files."""
    n = 12
    grid = dict(nlay=1, nrow=1, ncol=n, delr=10.0, delc=10.0, top=10.0,
                botm=np.zeros((1, 1, n)))
    fkw = dict(k=5.0, strt=5.0, storage={"ss": 1e-4, "iconvert": 0},
               chd=[(n - 1, 5.0)], wel=[(3, -0.05)],
               rch=[(j, 1e-3) for j in range(n)])
    tkw = dict(porosity=0.2, strt=0.0, scheme="upstream",
               ssm_spec={"WEL": 0.0, "RCH": 1.0})
    model = build_gwf("m", DisGrid.create(**grid), device="cpu", **fkw)
    sim = Simulation(Tdis([StressPeriod(4.0, 4, 1.0)]), model,
                     ImsSettings(**FLOW),
                     hds_path=str(tmp_path / "m.hds"),
                     cbc_path=str(tmp_path / "m.cbc"),
                     gwt=build_gwt("t", DisGrid.create(**grid), device="cpu",
                                   **tkw),
                     gwt_settings=ImsSettings(**TIGHT))
    sim.run()
    steps = fields_from_files(model, str(tmp_path / "m.hds"),
                              str(tmp_path / "m.cbc"), ssm_spec=tkw[
                                  "ssm_spec"])
    assert len(steps) == 4
    jm = jax_build_gwf("m", JaxDisGrid.create(**grid), **fkw)
    ref_steps = jax_from_files(jm, str(tmp_path / "m.hds"),
                               str(tmp_path / "m.cbc"),
                               ssm_spec=tkw["ssm_spec"])
    off = build_gwt("off", DisGrid.create(**grid), device="cpu", **tkw)
    sol = NumericalSolution(off, ImsSettings(**TIGHT))
    conc = off.strt
    for (kstp, kper, delt, f), (rk, rp, rd, rf) in zip(steps, ref_steps):
        assert (kstp, kper, delt) == (rk, rp, rd)
        for name in ("q_edge", "sat", "sat_old", "strg_ss", "strg_sy",
                     "bound_q", "bound_node", "bound_mask", "bound_conc"):
            np.testing.assert_array_equal(getattr(f, name).numpy(),
                                          np.asarray(getattr(rf, name)),
                                          err_msg=name)
        conc, info, _ = sol.solve_timestep(conc, delt, kstp=kstp, iss=False,
                                           pkgs=f)
        assert info.converged
    np.testing.assert_allclose(conc.numpy(), sim.conc_records[-1], atol=1e-9)


def gwt_reference_arrays(model):
    """(arrays, options) of gwt_from_reference for a reference GwtModel."""
    arrays = {k: np.asarray(getattr(model.topo, k)) for k in (
        "edge_n", "edge_m", "ihc", "cl1", "cl2", "hwva", "anglex", "nbr",
        "slot_nm", "slot_mn")}
    arrays.update(strt=model.strt, ibound0=model.ibound0, top=model.top,
                  bot=model.bot, area=model.area)
    for f in dataclasses.fields(model.mst_arrays):
        arrays["mst_" + f.name] = getattr(model.mst_arrays, f.name)
    options = dict(iadvwt=model.iadvwt, eqnsclfac=model.eqnsclfac,
                   idcy=model.mst_opts.idcy, isrb=model.mst_opts.isrb,
                   ssm_spec=model.ssm_spec, dsp=None, ist=None)
    if model.dsp is not None:
        for k in ("alh", "alv", "ath1", "ath2", "atv", "diffc"):
            arrays["dsp_" + k] = getattr(model.dsp, k)
        options["dsp"] = dict(idisp=model.dsp.idisp, idiffc=model.dsp.idiffc)
    if model.ist is not None:
        for k in ("thetaim", "zetaim", "volfrac", "bulk_density", "distcoef",
                  "decay", "decay_sorbed", "sp2"):
            arrays["ist_" + k] = getattr(model.ist, k)
        arrays["cim"] = model.cim
        options["ist"] = dict(idcy=model.ist.idcy, isrb=model.ist.isrb)
    for pkg, value in (("cnc", "conc"), ("src", "q")):
        data = getattr(model, pkg)
        if data is not None:
            for f in ("node", value, "mask"):
                arrays[f"{pkg}_{f}"] = getattr(data, f)
    return {k: np.asarray(v) for k, v in arrays.items()}, options


@pytest.mark.parametrize("case", ["tvd+dsp+linear+decay+cnc+src", "ist"])
def test_gwt_from_reference_equals_the_port_built_model(flow, case):
    """A reference GwtModel's arrays → gwt_from_reference: the same system,
    bit for bit, as the port's build_gwt of the same arguments."""
    _, _, _, pf, _ = flow
    jt, pt = both_gwt(SYSTEMS[case])
    arrays, options = gwt_reference_arrays(jt)
    conv = gwt_from_reference(arrays, options=options, device="cpu",
                              grid=DisGrid.create(**flow_args()[0]))
    c = t64(concentrations(pt.nodes, 6))
    if pt.ist is not None:
        pf = dataclasses.replace(pf, cim=t64(concentrations(pt.nodes, 7)))
    systems = []
    for model in (pt, conv):
        ib, cb = model.boundary_state(c)
        systems.append((ib, *model.assemble(cb, c, ib, 5.0, False, pf)))
    for g, w in zip(*systems):
        assert torch.equal(g, w)


def test_a_gwt_model_never_reaches_the_flow_options():
    """The solver reads Newton, PTC and rewetting options only where they
    are on; a GwtModel has none, and its topology no grid shape, so its
    products go through the gather and its fixup through the table."""
    g = DisGrid.create(1, 2, 3, 1.0, 1.0, 1.0, np.zeros((1, 2, 3)))
    model = build_gwt("t", g, device="cpu")
    assert not model.use_structured and model.inewton == 0
    assert model.dtopo.grid_shape is None
    assert not hasattr(model, "wetdry") and not hasattr(model, "npf_arrays")
    assert model.is_linear
    for kw in (dict(scheme="tvd"),
               dict(decay=(mst.DECAY_ZERO_ORDER, 1.0)),
               dict(sorption=dict(isrb=mst.SORPTION_FREUND)),
               dict(sorption=dict(isrb=mst.SORPTION_LANG))):
        assert not build_gwt("t", g, device="cpu", **kw).is_linear


@pytest.mark.parametrize("case", ["plain GWT beside MAW rows",
                                  "GWT beside UZF without UZT rows",
                                  "GWT with APT rows beside MAW rows"])
def test_gwt_beside_apt_flows_is_refused(case):
    """MAW, LAK, SFR or MVR rows and UZF columns carry their own transport
    (APT: MWT, LKT, SFT, MVT, UZT): a plain GWT model beside feature rows
    raises by name at construction, and beside UZF columns without UZT
    rows at the run's start (the reference's FMI drops the UZF flows);
    with APT rows (``AugmentedGwtModel``, tests/test_torch_apt.py) the
    same model runs."""
    from modflow6_torch.models.gwf.advanced import (AugmentedGwfModel,
                                                    build_maw)
    from modflow6_torch.models.gwf.uzf import make_uzf
    from modflow6_torch.models.gwt.apt import AugmentedGwtModel
    g = DisGrid.create(1, 1, 4, 10.0, 10.0, 10.0, np.zeros((1, 1, 4)))
    base = build_gwf("f", g, k=1.0, strt=5.0, chd=[(0, 5.0)], device="cpu")
    aug = AugmentedGwfModel(base, maw=build_maw(
        [dict(radius=0.1, strt=5.0, rate=0.0, connections=[(2, 1.0)])], g))
    tdis = Tdis([StressPeriod(1.0, 1, 1.0)])
    if case == "plain GWT beside MAW rows":
        with pytest.raises(NotImplementedError, match="MAW"):
            Simulation(tdis, aug, ImsSettings(**FLOW),
                       gwt=build_gwt("t", g, device="cpu"))
        return
    if case == "GWT with APT rows beside MAW rows":
        sim = Simulation(tdis, aug, ImsSettings(**FLOW), gwt=AugmentedGwtModel(
            build_gwt("t", g, device="cpu", cnc=[(0, 1.0)]), aug))
        recs = sim.run()
        assert recs[0].converged and recs[0].transport_converged
        assert sim.conc.shape == (5,)
        return
    sim = Simulation(tdis, base, ImsSettings(**FLOW),
                     gwt=build_gwt("t", g, device="cpu"))
    sim.uzf = make_uzf(dict(
        node=np.arange(2), vks=np.full(2, 0.1), thtr=np.full(2, 0.05),
        thts=np.full(2, 0.35), thti=np.full(2, 0.1), eps=np.full(2, 3.5),
        celtop=np.full(2, 10.0), celbot=np.zeros(2), surfdep=np.full(2, 0.5),
        area=np.full(2, 100.0), finf=np.full(2, 0.01), pet=np.zeros(2),
        extdp=np.full(2, 1.0), extwc=np.full(2, 0.06)), nz=5, device="cpu")
    with pytest.raises(NotImplementedError, match="UZF"):
        sim.run()
