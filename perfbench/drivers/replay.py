"""Traffic ``replay``: the configuration's time steps of one simulation,
driven through ``Simulation.do_step`` and started again from the same
state whenever they end, over a fixed ensemble of K fields.

A marching simulation gets cheaper as it nears equilibrium; replaying one
schedule from one start state keeps the work of a window the same for
every version of the program.  The flow models are built in memory; nothing
is read from or written to files.

The work is the same for every seed.  The traffic file lists the
``ensemble``: the seeds of its members' K fields, each drawn on the card.
One pass replays every member once, in an order drawn from ``--seed``,
and the window runs whole passes.  (A K field drawn from ``--seed`` itself
would let the seed set the Krylov iteration count, and with it the rate.)

The traffic file also names the solver's accelerator, preconditioner and
precision (``flow_ims``, over the configuration's closures in ``ims``),
the warm-up steps, the size of the checked sample and the steps of the
profiled stretch.  With ``start``, set-up solves the configuration's
first ``periods`` (one steady step) of each member with the solver
settings ``ims`` (over the configuration's), and the replay is the steps
after them, from those heads.

Correctness compares what the timed steps produced, sampled from the seed
over the whole window, with ``perfbench.reference``: each sampled step's
heads against the reference's own march of its member from the same start
heads (``head_gap_m``, the largest difference).  The start heads of a
``start`` are the program's; they are checked by themselves, by the
largest residual they leave in the reference's own steady system of
their member (``start_residual``, a flow rate).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..inputs import flow_inputs


class Reservoir:
    """A uniform sample of at most ``size`` items of a stream of unknown
    length, drawn with the seed's generator."""

    def __init__(self, size, rng):
        self.size, self.rng = size, rng
        self.items, self.seen = [], 0

    def offer(self, item_fn):
        """Keep the next item with the right odds; ``item_fn`` makes it
        only when it is kept."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item_fn())
            return
        j = int(self.rng.integers(self.seen))
        if j < self.size:
            self.items[j] = item_fn()


class Member:
    """One K field of the ensemble: its inputs, its simulation and the
    heads its replays start from."""

    def __init__(self, inputs):
        self.inputs = inputs
        self.sim = None
        self.start_head = None
        self.start_check = None   # (period, heads) of a start's solve


class Cell:
    """One cell of replay traffic on ``device``."""

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.device = seed, device
        self.ims = {**cfg["ims"], **traffic["flow_ims"]}
        self.rng = np.random.default_rng([int(seed) % 2**63, 1])
        self.sample = Reservoir(int(traffic["check_sample"]), self.rng)
        self.members = []
        self.replays_per_pass = len(traffic["ensemble"])
        self.replays = 0
        self.parts = {}          # seconds of each part of the build

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _lap(self, part, t):
        """Add the seconds since ``t`` to ``part``; returns the clock."""
        self._sync()
        now = time.perf_counter()
        self.parts[part] = self.parts.get(part, 0.0) + now - t
        return now

    # ---------------------------------------------------------- set-up

    def build(self):
        t = time.perf_counter()
        from modflow6_torch.models.simulation import Simulation  # noqa: F401
        t = self._lap("import_program", t)
        for k_seed in self.traffic["ensemble"]:
            inp = flow_inputs(self.cfg, k_seed, self.device)
            t = self._lap("inputs", t)
            member = Member(inp)
            self._build_member(member)
            t = self._lap("build_model", t)
            if self.traffic.get("start"):
                self._solve_start(member)
                t = self._lap("start_solve", t)
            self.members.append(member)
        self.n_cells, self.grid_shape = inp.nodes, inp.shape
        self.schedule = inp.schedule[1:] if self.traffic.get("start") \
            else inp.schedule

    def _build_member(self, member):
        from modflow6_torch.models.discretization import DisGrid
        from modflow6_torch.models.gwf.builder import build_gwf
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
            "flow", grid, k=inp.k.cpu().numpy(), strt=inp.strt,
            storage={"ss": inp.ss, "sy": inp.sy, "iconvert": 0},
            chd=np.stack([inp.chd_node, inp.chd_head], 1).tolist(),
            wel=np.stack([inp.wel_node, inp.wel_q], 1).tolist(),
            device=self.device)
        cfg = self.cfg
        tdis = Tdis(tuple(StressPeriod(float(p), int(n), float(m))
                          for p, n, m in cfg["tdis"]))
        sim = member.sim = Simulation(
            tdis, flow, ImsSettings(**self.ims),
            transient=[not s for s in cfg["steady"]])
        if inp.wel_from_period > 1:
            # MODFLOW 6's PERIOD blocks: no well before its first period,
            # and the well kept from then on
            sim.period_data = {
                1: dataclasses.replace(flow.packages, wel=None),
                inp.wel_from_period: flow.packages}
        member.start_head = flow.strt

    def _solve_start(self, member):
        """Set-up solves the first periods; the replay is what follows."""
        from modflow6_torch.solution import ImsSettings, NumericalSolution
        start = self.traffic["start"]
        n = int(start["periods"])
        head_steps = [s for s in member.inputs.schedule if s[0] <= n]
        if len(head_steps) != 1 or not head_steps[0][3]:
            raise ValueError("a start is one steady step")
        kper, kstp, delt, _ = head_steps[0]
        sim = member.sim
        pre = NumericalSolution(sim.model, ImsSettings(
            **{**self.cfg["ims"], **start["ims"]}))
        head, info, _ = pre.solve_timestep(
            member.start_head, delt, kstp=kstp, iss=True,
            pkgs=sim.step_packages(kper), kper=kper)
        if not info.converged:
            raise RuntimeError("the start's steady step did not converge")
        member.start_head = head
        member.start_check = (kper, head.cpu().numpy())

    # ---------------------------------------------------------- stepping

    def warm_up(self):
        """Each member's first ``warmup_steps`` steps, outside the sample,
        with the solver settings ``warmup_ims`` over the window's where the
        traffic gives them (a few iterations run every kernel that a whole
        solve runs); the next replay counts as the first."""
        from modflow6_torch.solution import ImsSettings, NumericalSolution
        caps = self.traffic.get("warmup_ims")
        for member in self.members:
            sim = member.sim
            solution = sim.solution
            if caps:
                sim.solution = NumericalSolution(sim.model, ImsSettings(
                    **{**self.ims, **caps}))
            self._start(member)
            for i in range(int(self.traffic["warmup_steps"])):
                self.step(i, keep=False)
            sim.solution = solution
        self.replays = 0

    def start_replay(self):
        """The next member's replay: a new order at each pass."""
        m = self.replays_per_pass
        if self.replays % m == 0:
            self.order = self.rng.permutation(m)
        self._start(self.members[self.order[self.replays % m]])
        self.replays += 1

    def _start(self, member):
        self.member = member
        self.head = member.start_head
        self.pertim = self.totim = 0.0

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
        self.head = head
        if keep:
            m = self.members.index(self.member)
            self.sample.offer(lambda: (m, i, rec.head))
        return rec.converged, rec

    def free_program(self):
        """Drop the program's state before the reference runs."""
        for member in self.members:
            member.sim = member.start_head = None
        self.member = self.head = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- checking

    def check(self):
        """{name: value} of the numbers compared with the reference."""
        out = {}
        if self.traffic.get("start"):
            out["start_residual"] = max(
                self._start_residual(m) for m in self.members)
        by_step = {}
        for m, i, head in self.sample.items:
            by_step.setdefault(m, {}).setdefault(i, []).append(head)
        out["head_gap_m"] = max(
            (self._march_gap(self.members[m], steps)
             for m, steps in sorted(by_step.items())), default=0.0)
        return out

    def _start_residual(self, member):
        from ..reference.flow import ConfinedFlow
        flow = ConfinedFlow(member.inputs, self.device)
        kper, head = member.start_check
        h = torch.as_tensor(head, device=self.device).reshape(flow.shape)
        r = flow.residual(h, kper)
        return r if np.isfinite(r) else float("inf")

    def _march_gap(self, member, by_step):
        """The largest gap between the sampled heads ``by_step`` ({step:
        [heads]}) of ``member`` and the reference's march."""
        from ..reference.flow import ConfinedFlow
        dev = self.device
        flow = ConfinedFlow(member.inputs, dev)
        if member.start_check is not None:
            h = torch.as_tensor(member.start_check[1],
                                device=dev).reshape(flow.shape)
        else:
            h = torch.full(flow.shape, member.inputs.strt,
                           dtype=torch.float64, device=dev)
        gap = 0.0
        for i in range(max(by_step) + 1):
            kper, _, delt, steady = self.schedule[i]
            h, _, _, _ = flow.step(h, None if steady else delt, kper,
                                   self.ims)
            for head in by_step.get(i, []):
                prog = torch.as_tensor(head, device=dev).reshape(flow.shape)
                gap = max(gap, _gap(prog, h))
        return gap


def _gap(prog, ref):
    """The largest difference between the program's array and the
    reference's; infinite where either is not finite."""
    d = float((prog - ref).abs().max())
    return d if np.isfinite(d) else float("inf")
