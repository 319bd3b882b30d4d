"""Traffic ``coupled``: a variable-density cross-section (flow with BUY,
then solute transport on its flows, every step) driven through
``Simulation.do_step``, its first steps replayed from the same state over
an ensemble of the source's cases.

The configuration is a section (``perfbench/section.py``); the traffic's
``ensemble`` names its cases (the inflow of each), ``steps`` the first and
last step of the source's schedule that a replay runs, ``flow_ims`` and
``transport_ims`` the two solutions' accelerator, preconditioner and
precision over the configuration's closures (``ims``), and ``start`` the
solver settings of set-up's flow solve.  Set-up builds each case's flow
and transport models in memory and solves its flow at the starting
concentration to the heads its replays start from.  Before any solve it
builds the flow's multigrid hierarchy on the first case's assembled
system, and stops the run (non-zero, no result) when that has fewer than
two levels: a preconditioner without a coarse grid would take the cell
hours, not seconds.

A pass replays every case once, in an order drawn from ``--seed``, from
its start heads and the starting concentration; the work is the same for
every seed.  A step is counted as failed when its flow or its transport
did not converge.

Correctness compares a sample of the window's steps, drawn from the seed,
with ``perfbench.reference.henry``: each sampled step's heads and
concentrations against the reference's own march of its case from the
same start (``head_gap_m``, ``conc_gap``), and the start heads by
themselves, by the largest residual they leave in the reference's steady
flow at the starting concentration (``start_residual``, a flow rate).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..section import section_inputs
from .replay import Cell as ReplayCell
from .replay import Member as ReplayMember
from .replay import _gap


class Member(ReplayMember):
    """One case of the ensemble: its inputs, its simulation, the heads its
    replays start from and the starting concentration."""

    def __init__(self, inputs):
        super().__init__(inputs)
        self.conc0 = None


class Cell(ReplayCell):
    """One cell of coupled traffic on ``device``."""

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        self.gwt_ims = {**cfg["ims"], **traffic["transport_ims"]}

    # ---------------------------------------------------------- set-up

    def build(self):
        t = time.perf_counter()
        from modflow6_torch.models.simulation import Simulation  # noqa: F401
        t = self._lap("import_program", t)
        for case in self.traffic["ensemble"]:
            inp = section_inputs(self.cfg, case)
            t = self._lap("inputs", t)
            member = Member(inp)
            self._build_member(member, check_mg=not self.members)
            t = self._lap("build_model", t)
            self._solve_start(member)
            t = self._lap("start_solve", t)
            self.members.append(member)
        self.n_cells, self.grid_shape = inp.nodes, inp.shape
        first, last = self.traffic["steps"]
        self.schedule = inp.schedule[first - 1:last]

    def _build_member(self, member, check_mg=False):
        from modflow6_torch.models.discretization import DisGrid
        from modflow6_torch.models.gwf.builder import build_gwf
        from modflow6_torch.models.gwt.builder import build_gwt
        from modflow6_torch.models.simulation import Simulation
        from modflow6_torch.solution import ImsSettings
        from modflow6_torch.timing.tdis import StressPeriod, Tdis
        inp = member.inputs
        nlay, nrow, ncol = inp.shape
        grid = DisGrid.create(nlay, nrow, ncol, delr=inp.delr,
                              delc=inp.delc, top=inp.top_surface,
                              botm=inp.botm[:, None, None]
                              * np.ones((nlay, nrow, ncol)))
        flow = build_gwf(
            "flow", grid, k=inp.k, strt=inp.strt,
            chd=np.stack([inp.chd_node, inp.chd_head], 1).tolist(),
            wel=np.stack([inp.wel_node, inp.wel_q], 1).tolist(),
            buy=inp.buy, device=self.device)
        member.conc0 = torch.full((inp.nodes,), inp.conc_strt,
                                  dtype=torch.float64, device=self.device)
        if check_mg:
            self._check_mg(flow, member.conc0)
        trans = build_gwt(
            "trans", grid, porosity=inp.porosity, strt=inp.conc_strt,
            scheme="upstream", dsp={"diffc": inp.diffc},
            ssm_spec={"WEL": inp.wel_conc, "CHD": inp.chd_conc},
            device=self.device)
        cfg = self.cfg
        tdis = Tdis(tuple(StressPeriod(float(p), int(n), float(m))
                          for p, n, m in cfg["tdis"]))
        member.sim = Simulation(
            tdis, flow, ImsSettings(**self.ims),
            transient=[not s for s in cfg["steady"]], gwt=trans,
            gwt_settings=ImsSettings(**self.gwt_ims))
        member.start_head = flow.strt

    def _check_mg(self, flow, conc):
        """Stop the run unless the flow's multigrid coarsens this grid."""
        from modflow6_torch.ops.solvers.mg import make_mg_preconditioner
        from modflow6_torch.solution.ims import fix_system
        pkgs = dataclasses.replace(flow.packages, buy_conc=conc)
        ibound, head = flow.boundary_state(flow.strt, pkgs)
        diag, off, rhs = flow.assemble(head, head, ibound, 1.0, True, pkgs)
        diag, off, _ = fix_system(flow, torch.sign(ibound), diag, off, rhs,
                                  head, symmetric=False)
        shape = flow.dtopo.grid_shape
        levels = len(make_mg_preconditioner(shape, diag, off).levels)
        if levels < 2:
            raise SystemExit(
                f"perfbench: the flow's multigrid builds {levels} level(s) "
                f"on the {shape} grid; this cell needs a coarse grid")

    def _solve_start(self, member):
        """The flow at the starting concentration, steady, to the heads
        that every replay of the case starts from."""
        from modflow6_torch.solution import ImsSettings, NumericalSolution
        sim = member.sim
        kper, kstp, delt, _ = member.inputs.schedule[0]
        pre = NumericalSolution(sim.model, ImsSettings(
            **{**self.cfg["ims"], **self.traffic["start"]["ims"]}))
        sim.conc = member.conc0
        head, info, _ = pre.solve_timestep(
            member.start_head, delt, kstp=kstp, iss=True,
            pkgs=sim.step_packages(kper), kper=kper)
        if not info.converged:
            raise RuntimeError("the start's flow did not converge")
        member.start_head = head
        member.start_check = (kper, head.cpu().numpy())

    # ---------------------------------------------------------- stepping

    def _start(self, member):
        super()._start(member)
        member.sim.conc = member.conc0

    def step(self, i, keep=True):
        """Step ``i`` of the schedule; returns (converged, record)."""
        kper, kstp, delt, _ = self.schedule[i]
        if kstp == 1:
            self.pertim = 0.0
        self.pertim += delt
        self.totim += delt
        sim = self.member.sim
        head = sim.do_step(self.head, kper, kstp, delt, self.pertim,
                           self.totim)
        rec = sim.records.pop()
        conc = sim.conc_records.pop()
        self.head = head
        if keep:
            m = self.members.index(self.member)
            self.sample.offer(lambda: (m, i, rec.head, conc))
        return rec.converged and rec.transport_converged, rec

    # ---------------------------------------------------------- checking

    def check(self):
        """{name: value} of the numbers compared with the reference."""
        out = {"start_residual": max(self._start_residual(m)
                                     for m in self.members)}
        by_step = {}
        for m, i, head, conc in self.sample.items:
            by_step.setdefault(m, {}).setdefault(i, []).append((head, conc))
        gaps = [self._march_gaps(self.members[m], steps)
                for m, steps in sorted(by_step.items())]
        out["head_gap_m"] = max((g[0] for g in gaps), default=0.0)
        out["conc_gap"] = max((g[1] for g in gaps), default=0.0)
        return out

    def _reference(self, member):
        from ..reference.henry import HenrySection
        return HenrySection(member.inputs, self.device)

    def _start_residual(self, member):
        ref = self._reference(member)
        h = torch.as_tensor(member.start_check[1], device=self.device)
        conc = torch.full_like(h, member.inputs.conc_strt)
        r = ref.residual(h, conc)
        return r if np.isfinite(r) else float("inf")

    def _march_gaps(self, member, by_step):
        """The largest head and concentration gaps between the sampled
        steps ``by_step`` ({step: [(heads, conc)]}) of ``member`` and the
        reference's march from the same start."""
        ref = self._reference(member)
        dev = self.device
        h = torch.as_tensor(member.start_check[1], device=dev)
        c = torch.full_like(h, member.inputs.conc_strt)
        hgap = cgap = 0.0
        for i in range(max(by_step) + 1):
            delt = self.schedule[i][2]
            h, c, _, _ = ref.step(h, c, delt, self.ims, self.gwt_ims)
            for head, conc in by_step.get(i, []):
                hgap = max(hgap, _gap(torch.as_tensor(head, device=dev), h))
                cgap = max(cgap, _gap(torch.as_tensor(conc, device=dev), c))
        return hgap, cgap
