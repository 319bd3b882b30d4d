"""The Henry seawater-intrusion section through ``Simulation.do_step`` on
the CPU: the flow with BUY, then the transport on its flows, held to the
plain reference ``perfbench/reference/henry.py`` at the source's own 40 x 1
x 80 grid (MODFLOW 6's ex-gwt-henry values, cases a and b); the multigrid
that coarsens a one-row section over (layer, column), and every other
grid's as it was; the transport's spans beside the output's.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from modflow6_torch.ops.solvers import krylov
from modflow6_torch.ops.solvers import mg as mg_mod
from modflow6_torch.ops.solvers.mg import make_mg_preconditioner
from modflow6_torch.ops.system import make_matvec
from modflow6_torch.solution.ims import fix_system
from modflow6_torch.utils import profiler
from perfbench.drivers.coupled import Cell, Member
from perfbench.reference.henry import HenrySection
from perfbench.section import section_inputs

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "perfbench" / "configs" / "gwt-henry-1024x1x2048.json"
TRAFFIC = ROOT / "perfbench" / "traffic" / "henry-buy-mg-replay.json"
LIMITS = ROOT / "perfbench" / "limits" / "henry-buy-mg-replay.json"
CPU = torch.device("cpu")


def _cell(nlay=40, ncol=80, steps=5):
    """The cell's driver on the source's grid, built (both cases' models
    and their start heads)."""
    cfg = json.loads(CONFIG.read_text())
    cfg.update(nlay=nlay, ncol=ncol)
    traffic = json.loads(TRAFFIC.read_text())
    traffic["steps"] = [1, steps]
    cell = Cell(cfg, traffic, 2**31 + 9, CPU)
    cell.build()
    return cell


@pytest.fixture(scope="module")
def cell():
    return _cell()


def _system(nlay, ncol):
    """Case a's fixed-up flow system at the starting heads and
    concentration, as the solver gets it, on an nlay x 1 x ncol section."""
    cfg = json.loads(CONFIG.read_text())
    cfg.update(nlay=nlay, ncol=ncol)
    cell = Cell(cfg, json.loads(TRAFFIC.read_text()), 1, CPU)
    member = Member(section_inputs(cfg, "a"))
    cell._build_member(member)
    member.sim.conc = member.conc0
    flow = member.sim.model
    pkgs = member.sim.step_packages(1)
    ibound, head = flow.boundary_state(member.start_head, pkgs)
    diag, off, rhs = flow.assemble(head, head, ibound, 1.0, True, pkgs)
    diag, off, rhs = fix_system(flow, torch.sign(ibound), diag, off, rhs,
                                head, symmetric=False)
    return flow, diag, off, rhs, head


@pytest.mark.parametrize("case", [0, 1], ids=["a", "b"])
def test_program_against_the_plain_reference(cell, case):
    """Five coupled steps of each case: heads and concentrations within
    the cell's limits of the reference's own march (bitwise here: the
    reference takes its sums in the program's order), the start heads'
    residual within its limit, every step converged."""
    limits = json.loads(LIMITS.read_text())
    member = cell.members[case]
    ref = HenrySection(member.inputs, CPU)
    h = member.start_head.clone()
    c = member.conc0
    assert ref.residual(h, c) <= limits["start_residual"]
    cell._start(member)
    for i in range(len(cell.schedule)):
        ok, rec = cell.step(i, keep=False)
        assert ok and rec.transport_inner > 0
        h, c, flow, trans = ref.step(h, c, cell.schedule[i][2], cell.ims,
                                     cell.gwt_ims)
        assert flow[2] and trans[2]
        assert (rec.outer, rec.inner) == flow[:2]
        assert (rec.transport_outer, rec.transport_inner) == trans[:2]
        assert float((torch.as_tensor(rec.head) - h).abs().max()) \
            <= limits["head_gap_m"]
        conc = member.sim.conc
        assert float((conc - c).abs().max()) <= limits["conc_gap"]
    # the fresh inflow has pushed salt back from the landward column
    assert float(conc.reshape(40, 80)[:, 0].max()) < 35.0


def test_section_mg_coarsens_layers_and_columns():
    """On a (128, 1, 256) section MG builds a hierarchy over (layer,
    column), and BiCGSTAB needs far fewer iterations with it than with the
    one level MG built there before (a single Chebyshev sweep)."""
    flow, diag, off, rhs, head = _system(128, 256)
    shape = flow.dtopo.grid_shape
    assert shape == (128, 1, 256)
    apply = make_mg_preconditioner(shape, diag, off)
    assert [tuple(d.shape) for d, *_ in apply.levels] == [
        (1, 128, 256), (1, 64, 128), (1, 32, 64), (1, 16, 32)]
    one = make_mg_preconditioner(shape, diag, off, max_levels=1)
    assert len(one.levels) == 1
    matvec = make_matvec(flow.system_topo, diag, off)
    counts = []
    for precond in (apply, one):
        res = krylov.bicgstab(matvec, rhs, head, precond, itmax=3000,
                              dvclose=1e-10, rclose=1e-6)
        assert bool(res.converged)
        counts.append(res.iters)
    assert counts[0] * 2 < counts[1], counts


def _previous_mg(shape, diag, off, r):
    """MG's application as it was built before sections had a view of
    their own: (row, column) aggregation on the grid's own shape."""
    nlay, nrow, ncol = shape
    levels = []
    d3, c = diag.reshape(shape), off.reshape(nlay, nrow, ncol, 6)
    while True:
        inv = 1.0 / torch.where(d3 != 0.0, d3, 1.0)
        levels.append((d3, mg_mod._level_matvec(d3, c), inv))
        nl, nr_, nc_ = d3.shape
        if nr_ * nc_ * nl <= 512 or min(nr_, nc_) <= 2 or len(levels) >= 12:
            break
        d3, c = mg_mod._coarsen(d3, c)

    def vcycle(level, r3):
        d3, mv, inv = levels[level]
        cheb = mg_mod._chebyshev
        if level == len(levels) - 1:
            return cheb(mv, inv, r3, None, 16, mg_mod._COARSE_LO,
                        mg_mod._LMAX)
        z = cheb(mv, inv, r3, None, 2, mg_mod._SMOOTH_LO, mg_mod._LMAX)
        zc = vcycle(level + 1, mg_mod._restrict(r3 - mv(z)))
        z = z + 1.8 * mg_mod._prolong(zc, d3.shape)
        return cheb(mv, inv, r3, z, 2, mg_mod._SMOOTH_LO, mg_mod._LMAX)

    return [tuple(d.shape) for d, _, _ in levels], \
        vcycle(0, r.reshape(shape)).reshape(-1)


@pytest.mark.parametrize("shape", [(1, 48, 48), (3, 21, 17), (2, 37, 45),
                                   (5, 3, 64), (2, 1, 96), (1, 1, 700)],
                         ids=str)
def test_mg_unchanged_off_sections(shape):
    """Every grid but a one-row section with more than two layers keeps
    its hierarchy and its application bit for bit."""
    rng = np.random.default_rng(11)
    n = int(np.prod(shape))
    off = torch.as_tensor(rng.random((n, 6)))
    diag = -(off.sum(dim=1) + 0.1)
    r = torch.as_tensor(rng.normal(size=n))
    want_shapes, want = _previous_mg(shape, diag, off, r)
    apply = make_mg_preconditioner(shape, diag, off)
    assert [tuple(d.shape) for d, *_ in apply.levels] == want_shapes
    assert torch.equal(apply(r), want)


def test_transport_has_its_own_spans(cell):
    """The transport runs in a ``transport`` span between the flow's
    ``solve`` and the ``output``, with ``fmi`` and the transport
    solution's ``outer`` spans inside it; the record's FMI and transport
    seconds are those spans', its counters carry the multigrid's levels
    and the transport's inner iterations, and the only explicit
    synchronisation of the step is the flow solve's."""
    member = cell.members[1]
    cell._start(member)
    cell.step(0, keep=False)
    ok, rec = cell.step(1, keep=False)
    assert ok
    by_id = {s.id: s for s in rec.spans}
    top = [s.name for s in rec.spans if s.parent is not None
           and by_id[s.parent].name == "step"]
    assert top == ["solve", "transport", "output"]
    (trans,) = [s for s in rec.spans if s.name == "transport"]
    (fmi,) = [s for s in rec.spans if s.name == "fmi"]
    assert fmi.parent == trans.id
    outers = [s for s in rec.spans if s.name == "outer"
              and s.parent == trans.id]
    assert len(outers) == rec.transport_outer > 0
    (output,) = [s for s in rec.spans if s.name == "output"]
    assert not [s for s in rec.spans if s.parent == output.id]
    assert rec.fmi_seconds == fmi.seconds
    assert rec.transport_seconds == trans.seconds - fmi.seconds
    assert rec.counters["transport_inner"] == rec.transport_inner
    assert rec.counters["mg_builds"] == rec.outer
    assert rec.counters["mg_levels"] == 3 * rec.outer
    applies = [s for s in rec.spans if s.name == "mg_apply"]
    assert len(applies) == 2 * rec.inner
    assert rec.counters["explicit_syncs"] == 1
    assert profiler.take()[0] == []
