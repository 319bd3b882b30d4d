"""Simulation: the create→define→time-loop→finalize core loop.

Port of modflow6_tpu/models/simulation.py for one GWF model (on a DIS,
DISV or DISU grid, alone or with MAW, LAK and SFR rows and MVR's movers as
an ``AugmentedGwfModel``, or several models merged by
``exchange.merge_gwf_models``) and one IMS solution (reference core loop
src/mf6core.f90: Mf6Initialize:70, Mf6PrepareTimestep:498,
Mf6DoTimestep:620, Mf6FinalizeTimestep:708): walk the TDIS periods and
steps, call the ``period_hooks`` and apply the TVK/TVS changes at each
period's start, call the ``step_hooks`` (time series, time-array series)
before every solve attempt and again before the step's package snapshot,
march the UZF columns (``uzf``) and solve each step with the numerical
solution, re-solving while the columns' recharge has not settled (the
reference's uzf_cc), advance the CSUB state, the UZF column state and the
MAW SHUT_OFF flags, compute flows and budgets (the MAW, LAK and SFR
exchanges with the aquifer, the movers' -TO-MVR terms and the UZF rates
among them), record the continuous observations (``obs``), and write the
heads, budget, grid, NetCDF (``nc_path``) and listing files.  Periods
listed in ``ats`` step adaptively (reference ats.f90 + mf6core.f90
retryloop): a failed attempt is solved again at a shorter step, and as
``solve_step`` commits no state and writes no output, it leaves no trace.
The files hold the grid rows of an augmented model; neither it nor a
merged model gets a ``.grb`` file, as in the reference, whose composites
have no single user grid; a merged model's heads file holds its rows in
the merged order as one 1 × nodes record per step.

A GWT model (``gwt``) steps after the flow in every time step (the
solution-group order, flow first): FMI builds its flow fields from the
accepted flow step, the transport system is solved from the step-start
concentration, IST's immobile concentration advances, and the step's
concentration is committed and written to the concentration file
(``conc_path``, saved per ``gwt_oc``).  BUY and VSC read that
concentration (``buy_conc``), lagged by a step; with ``sgp_mxiter`` > 1
the solution group iterates flow and transport within the step until the
concentration settles (the reference's SolutionGroup sgp_ca, with every
transport solve from the step-start concentration: R9 in ROADMAP Queue
C).  ``ats_percel`` limits an adaptive step to the transport's Courant
step (ADV ATS_PERCEL).  Without transport BUY and VSC see a concentration
only where ``period_data`` sets ``buy_conc``, as in the reference.
The transport model may be a GWE model (``gwe.model.GweModel``: heat,
its file a TEMPERATURE file) or carry APT rows
(``gwt.apt.AugmentedGwtModel`` over the augmented flow model: LKT, SFT,
MWT, UZT and MVT, or their GWE analogs): then FMI runs on the grid rows of
the base flow model, ``extract_apt_flows`` adds the features' flows (the
UZF march the step accepted feeds the UZT rows before its state is
committed), the sources' concentrations come from ``apt_ext_conc``, and
the concentration file holds the grid rows.  As in the reference, the
solution group's MXITER does not iterate a model with APT rows: with BUY
or VSC beside them it raises.

The output phase works on the model's device.  Face flows, their per-cell
sums (the CHD flows) and the storage rates are computed there from the
structured planes; each step the host reads the budget's IN/OUT sums in one
transfer, the observed values in one more, and the arrays of a record only
when that record is saved.  On the general path the same holds with the
per-edge flows in place of the planes.

Each ``do_step`` is a ``step`` span holding a ``solve`` span (the flow
solve up to the device's end of it), with a GWT model a ``transport``
span (FMI and the transport solve; see ``_solve_transport``), and an
``output`` span (everything after them: budget, record, the transport's
commit, files); the step's record carries its spans and counters
(``utils.profiler``), and the listing's profile is built from them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import DHNOFLO
from .discretization import DisGrid, DisuGrid, DisvGrid
from ..solution.ims import ImsSettings, NumericalSolution
from ..timing import ats as ats_mod
from ..timing.tdis import Tdis
from ..utils import grb
from ..utils.binary import BudgetFileWriter, HeadFileWriter
from ..utils.budget import Budget
from ..utils.csvout import OuterCsvWriter
from ..utils.memreport import memory_report
from ..utils.profiler import (Profiler, count, host_read, span,
                              synchronize, take)
from .gwf import csub as csub_mod
from .gwf import uzf as uzf_mod
from .gwt import adv as adv_mod
from .gwt import ist as ist_mod
from .gwt.apt import AugmentedGwtModel, extract_apt_flows
from .gwt.builder import DEFAULT_GWT_SETTINGS
from .gwt.fmi import from_gwf_step, storage_rates


class ConvergenceFailure(RuntimeError):
    """A time step did not converge and the simulation does not CONTINUE."""


@dataclasses.dataclass
class StepRecord:
    kper: int
    kstp: int
    totim: float
    head: np.ndarray
    converged: bool
    outer: int
    inner: int
    budget_table: Optional[str] = None
    solve_seconds: float = 0.0      # the step's solve spans (device done)
    output_seconds: float = 0.0     # its output span: budget, record, files
    uzf_resolves: int = 0           # uzf_cc re-solves of the step
    retries: int = 0                # ATS attempts that failed before it
    transport_converged: bool = True
    transport_outer: int = 0        # the step's transport solve
    transport_inner: int = 0
    fmi_seconds: float = 0.0        # the transport's flow fields
    apt_seconds: float = 0.0        # APT's feature flows
    transport_seconds: float = 0.0  # the committed transport solve
    group_iterations: int = 1       # solution-group passes (sgp_mxiter)
    # the spans closed since the last step's record, in the order they
    # opened, and the counters' growth (utils.profiler.take)
    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)


class _Transport(NamedTuple):
    """A transport solve of one time step, before it is committed."""
    fields: object          # FlowFields, or AptFlows with APT rows
    conc: torch.Tensor
    info: object
    fmi_seconds: float
    apt_seconds: float      # extract_apt_flows
    solve_seconds: float
    passes: int


class Simulation:
    """One flow model + one IMS solution + TDIS, and optionally one GWT
    model with its own IMS solution."""

    def __init__(self, tdis: Tdis, model, settings: ImsSettings,
                 transient=None, hds_path=None, cbc_path=None,
                 lst_path=None, outer_csv_path=None, oc=None, gwt=None,
                 obs=None, nc_path=None, gwt_settings=None, conc_path=None,
                 gwt_oc=None, conc_text="CONCENTRATION", profile=None):
        self.tdis = tdis
        self.model = model
        self.solution = NumericalSolution(model, settings)
        # the sequentially coupled GWT model (solution-group order: flow
        # first, FMI hands its flows to transport, SolutionGroup.f90:48)
        self.gwt = gwt
        self.gwt_oc = gwt_oc
        self.conc_text = conc_text
        self.conc = None
        self.conc_records: list = []
        self.gwt_solution = None
        self.conc_hds = None
        # APT: the source concentrations of the features' external
        # inflows, {"maw"|"lak"|"sfr"|"uzf": scalar or per feature}
        self.apt_ext_conc: dict = {}
        if gwt is not None:
            apt_rows = isinstance(gwt, AugmentedGwtModel)
            if hasattr(model, "n_extra") and not apt_rows:
                raise NotImplementedError(
                    "GWT over a flow model with MAW, LAK, SFR or MVR rows "
                    "without their transport (an AugmentedGwtModel: LKT, "
                    "SFT, MWT, MVT)")
            if apt_rows and gwt.gwf is not model:
                raise ValueError("the APT rows belong to another flow model")
            self.gwt_solution = NumericalSolution(
                gwt, gwt_settings or ImsSettings(**DEFAULT_GWT_SETTINGS))
            self.conc = gwt.strt
            if conc_path:
                self.conc_hds = HeadFileWriter(conc_path, text=conc_text)
        # solution-group Picard over flow and transport (mfsim.nam
        # SOLUTIONGROUP MXITER, SolutionGroup.f90 sgp_ca)
        self.sgp_mxiter = 1
        self.sgp_dclose = 1e-6
        # output control PERIOD selection (utils.oc.OutputControl); None →
        # save every step when the file paths are configured
        self.oc = oc
        # per-period steady/transient flags (reference STO iss per period)
        if transient is None:
            transient = [model.sto_arrays is not None] * tdis.nper
        self.transient = transient
        self.hds_path = hds_path
        self.hds = HeadFileWriter(hds_path) if hds_path else None
        # NETCDF_STRUCTURED FILEOUT export (utils.netcdf, NCModel role) of
        # the saved heads
        self.nc = None
        if nc_path:
            from ..utils.netcdf import NetcdfExporter
            self.nc = NetcdfExporter(nc_path, model.grid)
        self.cbc = BudgetFileWriter(cbc_path) if cbc_path else None
        self.lst_path = lst_path
        self.budget = Budget()
        self.records: list[StepRecord] = []
        self._lst_lines: list[str] = []
        self.outer_csv = OuterCsvWriter(outer_csv_path) \
            if outer_csv_path else None
        # profile: None (off) | "summary" | "detail" (sim-nam
        # PROFILE_OPTION, the CLI's -l/--level)
        self.profile_mode = profile
        self.prof = Profiler() if profile else None
        # optional per-period package data: {kper: PackageData}; data
        # persists across periods until redefined (MF6 PERIOD semantics)
        self.period_data: dict = {}
        # time-varying K / storage (TVK/TVS subpackages, gwf-tvk.f90 /
        # gwf-tvs.f90): {kper: [(node, PROP, value)]}; applied at period
        # start with condsat rebuilt
        self.tvk: dict = {}
        self.tvs: dict = {}
        # CSUB state (csub.CsubState), committed at step end
        self.csub_state = model.csub_state0
        # UZF unsaturated columns (uzf.UzfColumns) and their water-content
        # state, committed at step end; uzf_cc re-solves per step
        self.uzf = None
        self.uzf_theta = None
        self.uzf_watab = None
        self.uzf_maxiter = 3
        self._uzf_pending = None
        self._uzf_resolves = 0
        # f(kper) called once at each period's start, after the TVK/TVS
        # changes (the <pkg>_rp role: the advanced packages' PERIOD blocks)
        self.period_hooks = []
        # f(kper, kstp, delt) called before every solve attempt and before
        # the step's package snapshot (TsManager/TasManager ad role)
        self.step_hooks = []
        # adaptive time stepping: {kper: ats.AtsPeriod} (utl-ats perioddata)
        self.ats: dict = {}
        # ADV ATS_PERCEL (the transport's Courant limit on the ATS step)
        self.ats_percel = None
        # continuous observations (utils.obs.ObsManager or ObsGroup)
        self.obs = obs
        if obs is not None:
            obs.set_initial(model.strt)
        self._chd_entry_flows = None    # CHD flows of every entry (obs)
        self._inner_csv = None    # lazy CSV_INNER_OUTPUT writer
        # a failed time step aborts the run unless the simulation CONTINUE
        # option is set (the loader clears this flag then)
        self.fail_fast = False
        self.grb_seconds = 0.0    # host time of the binary grid file
        # PRT particle tracking over each accepted flow step
        # (prt.simulation.PrtDriver; the explicit solution's role)
        self.prt_drivers = []

    def _apply_time_varying(self, kper):
        """TVK/TVS period changes (the reference's _apply_time_varying):
        the K or SS/SY arrays changed on the host, condsat rebuilt on the
        planes or per edge (the kchangeper path in gwf-npf.f90), and a new
        solution bound to the new system."""
        kch = self.tvk.get(kper, [])
        sch = self.tvs.get(kper, [])
        if not kch and not sch:
            return
        model = self.model
        if model.ixt3d:
            raise NotImplementedError("TVK with XT3D not supported yet")
        if hasattr(model, "n_extra"):
            raise NotImplementedError(
                "TVK/TVS with MAW, LAK or SFR is not ported")

        def changed(arrays, fields, changes, key):
            host = {f: getattr(arrays, f).cpu().numpy().copy()
                    for f in fields}
            for node, prop, val in changes:
                host[key(prop)][node] = val
            return dataclasses.replace(arrays, **{
                f: torch.as_tensor(v, device=model.device)
                for f, v in host.items()})

        if kch:
            names = {"K": "k11", "K22": "k22", "K33": "k33"}
            model.npf_arrays = changed(model.npf_arrays, ("k11", "k22",
                                                          "k33"), kch,
                                       lambda p: names[p.upper()])
        if sch:
            model.sto_arrays = changed(model.sto_arrays, ("ss", "sy"), sch,
                                       str.lower)
        if kch:
            model.finalize_setup()
        self.solution = NumericalSolution(model, self.solution.s)

    def period_packages(self, kper):
        if not self.period_data:
            return self.model.packages
        best = None
        for k in sorted(self.period_data):
            if k <= kper:
                best = self.period_data[k]
        return best if best is not None else self.model.packages

    def step_packages(self, kper):
        """The period's packages with the step-start CSUB state and, with
        BUY or VSC beside a transport model, the step-start concentration
        (the flow sees the latest transport solution)."""
        pkgs = self.period_packages(kper)
        if self.model.csub is not None:
            pkgs = dataclasses.replace(pkgs, csub_state=self.csub_state)
        if self.conc is not None and self._density_coupled:
            pkgs = dataclasses.replace(
                pkgs, buy_conc=self.conc[:self.model.n_grid]
                if self._apt else self.conc)
        return pkgs

    @property
    def _apt(self) -> bool:
        """True when the transport model has APT rows."""
        return isinstance(self.gwt, AugmentedGwtModel)

    @property
    def _density_coupled(self) -> bool:
        flow = getattr(self.model, "base", self.model)
        return flow.buy is not None or flow.vsc is not None

    def _augment_uzf(self, pkgs, delt, head):
        """March the UZF columns from the committed state at ``head``
        (without committing it) and attach the head-dependent coupling
        data as ``pkgs.uzf`` (gwf-uzf.f90 uzf_fc/uzf_solve role)."""
        if self.uzf_theta is None:
            self.uzf_theta = uzf_mod.initial_theta(self.uzf)
        if self.uzf_watab is None:
            self.uzf_watab = uzf_mod.watab_of(self.uzf, head)
        res = uzf_mod.advance(self.uzf, self.uzf_theta, delt, head=head,
                              watab_old=self.uzf_watab)
        pkgs = dataclasses.replace(pkgs, uzf=uzf_mod.make_step(self.uzf,
                                                               res))
        self._uzf_pending = (res, pkgs)
        return pkgs

    def solve_step(self, head_old, kper, kstp, delt):
        """The solve phase only (Mf6DoTimestep body, no outputs).  With UZF
        columns, the package-convergence loop of the reference (gwf-uzf.f90
        uzf_cc role): the march used the step-start water table; re-march
        at the converged head and re-solve, at most ``uzf_maxiter`` times,
        until the largest change of a column's recharge is within
        max(1e-10, 1e-6 × the largest recharge), read in one transfer per
        pass."""
        iss = not self.transient[kper - 1]
        for hook in self.step_hooks:
            hook(kper, kstp, delt)
        pkgs = self.step_packages(kper)
        if self.uzf is not None:
            pkgs = self._augment_uzf(pkgs, delt, head_old)

        def solve(p):
            return self.solution.solve_timestep(
                head_old, delt, kstp=kstp, iss=iss, pkgs=p, kper=kper)

        solved = solve(pkgs)
        self._uzf_resolves = 0
        if self.uzf is None or self.uzf.node.shape[0] == 0:
            return solved
        area = self.uzf.area
        for _ in range(self.uzf_maxiter):
            res_prev = self._uzf_pending[0]
            res = uzf_mod.advance(self.uzf, self.uzf_theta, delt,
                                  head=solved[0], watab_old=self.uzf_watab)
            dmax, scale = host_read(torch.stack((
                ((res.rch - res_prev.rch).abs() * area).max(),
                (res.rch * area).abs().max())), torch.Tensor.tolist)
            if dmax <= max(1e-10, 1e-6 * (scale + 1e-30)):
                break
            pkgs = dataclasses.replace(pkgs, uzf=uzf_mod.make_step(
                self.uzf, res))
            self._uzf_pending = (res, pkgs)
            solved = solve(pkgs)
            self._uzf_resolves += 1
        return solved

    def _sync(self):
        synchronize(self.model.device)

    def do_step(self, head, kper, kstp, delt, pertim, totim,
                save_heads_every=1, solved=None):
        """Advance one time step (Mf6PrepareTimestep + Mf6DoTimestep +
        Mf6FinalizeTimestep for the single-solution case).  Returns the new
        head; appends the StepRecord and writes outputs.  ``solved``: the
        accepted attempt's ``solve_step`` result (the ATS path, which holds
        the step's span and ends its record), else the step is solved here.
        The record carries the step's spans and counters (``_end_step``)."""
        own = solved is None
        if own:
            take()      # what ran before the step is not the step's
        with span("step") if own else contextlib.nullcontext():
            model = self.model
            iss = not self.transient[kper - 1]
            head_old = head
            for hook in self.step_hooks:
                hook(kper, kstp, delt)
            pkgs = self.step_packages(kper)
            with span("solve"):
                if solved is None:
                    solved = self.solve_step(head_old, kper, kstp, delt)
                head, info, aux = solved
                ibound, cond = aux["ibound"], aux["cond"]
                uzf_step = None
                if self._uzf_pending is not None:
                    # commit the column state the accepted solve used;
                    # its packages (with the UZF terms) serve the budget
                    # and outputs, the march and its step-start state the
                    # UZT rows
                    res, pkgs = self._uzf_pending
                    uzf_step = (res, self.uzf_theta)
                    self.uzf_theta, self.uzf_watab = res.theta, res.watab
                    self._uzf_pending = None
                transport = None
                if (self.gwt is not None and self.sgp_mxiter > 1
                        and self._density_coupled and self.uzf is None
                        and model.csub is None):
                    head, info, aux, pkgs, transport = self._group_picard(
                        head, info, aux, head_old, pkgs, kstp, delt, iss)
                    ibound, cond = aux["ibound"], aux["cond"]
                if model.csub is not None:
                    # pkgs keeps the start-of-step state (for budgets);
                    # then the state advances: es0 ← es,
                    # pcs ← max(pcs, es), compaction +=
                    a = model.npf_arrays
                    self.csub_state = csub_mod.advance_state(
                        model.csub, self.csub_state, a.top, a.bot,
                        model.area, a.icelltype, head, head_old, ibound,
                        delt)
                maw = getattr(model, "maw", None)
                if maw is not None and maw.shut is not None:
                    # MAW SHUT_OFF hysteresis advances at the accepted
                    # solution (gwf-maw.f90 shutoffmin/max); one host read
                    # per step
                    new_shut = maw.advance_shutoff(head, model._maw_offset)
                    if host_read(torch.any(new_shut != maw.shut), bool):
                        model.maw = dataclasses.replace(maw, shut=new_shut)
                        self.solution = NumericalSolution(model,
                                                          self.solution.s)
                self._sync()
            if self.gwt is not None and transport is None:
                # ---- the sequentially coupled transport step (flow → FMI
                # → GWT) in its own span, after the flow's, before the
                # output
                transport = self._solve_transport(
                    head, head_old, aux, pkgs, kstp, delt, iss,
                    uzf_step=uzf_step)
            with span("output"):
                # ---- explicit PRT models track over the accepted step
                for drv in self.prt_drivers:
                    if not hasattr(drv, "x"):
                        drv.begin(self.tdis)
                    drv.on_step(kper, kstp, delt, totim, head, ibound, cond)
                if self.outer_csv:
                    self.outer_csv.write_step(totim, kper, kstp, info)
                if info.inner_traces:
                    # IMS CSV_INNER_OUTPUT: one row per inner iteration
                    if self._inner_csv is None:
                        self._inner_csv = open(
                            self.solution.s.csv_inner_path, "w")
                        self._inner_csv.write("totim,kper,kstp,kouter,"
                                              "kinner,dvmax,rmax,l2norm\n")
                    for kiter, n, dv, rm, l2 in info.inner_traces:
                        for i in range(n):
                            self._inner_csv.write(
                                f"{totim},{kper},{kstp},{kiter},{i + 1},"
                                f"{dv[i]:.10g},{rm[i]:.10g},{l2[i]:.10g}\n")
                    self._inner_csv.flush()

                # the iteration summary of the reference program's listing
                # (NumericalSolution.f90 sln_ot); modflow6_tpu's listing has
                # none
                self._lst_lines.append(
                    f" {info.outer_iterations} CALLS TO NUMERICAL SOLUTION IN "
                    f"TIME STEP {kstp} STRESS PERIOD {kper}")
                self._lst_lines.append(
                    f" {info.inner_iterations} TOTAL ITERATIONS")
                self._lst_lines.append("")

                # ---- budget (model_cq/model_bd phase)
                flows = self._accumulate_budget(head, head_old, ibound, cond,
                                                delt, iss, pkgs)
                table = self.budget.table(
                    f"VOLUME BUDGET FOR ENTIRE MODEL AT END OF TIME STEP "
                    f"{kstp}, STRESS PERIOD {kper}")
                # OC PRINT BUDGET selection; without OC PERIOD blocks every
                # step's table is kept in the listing
                nstp = self.tdis.periods[kper - 1].nstp
                has_oc = self.oc is not None and bool(self.oc.periods)
                print_budget = (self.oc.active("PRINT", "BUDGET", kper, kstp,
                                               nstp) if has_oc else True)
                if print_budget:
                    self._lst_lines.append(table)
                    self._lst_lines.append("")

                if self.obs is not None:
                    self.obs.record(totim, head,
                                    flows=self._obs_flows(flows, pkgs))

                head_np = host_read(head).numpy()
                rec = StepRecord(kper, kstp, totim, head_np, info.converged,
                                 info.outer_iterations,
                                 info.inner_iterations, table,
                                 uzf_resolves=self._uzf_resolves)
                self.records.append(rec)

                # ---- the transport step's commit and record
                if self.gwt is not None:
                    self._commit_transport(rec, transport, aux["ibound"],
                                           kper, kstp, delt)

                # ---- outputs (OC SAVE selection when PERIOD blocks are
                # present)
                save_head = (self.oc.active("SAVE", "HEAD", kper, kstp, nstp)
                             if has_oc else kstp % save_heads_every == 0)
                save_budget = (self.oc.active("SAVE", "BUDGET", kper, kstp,
                                              nstp) if has_oc else True)
                shape3d = self._shape3d()
                # the grid rows (an augmented model's feature rows follow
                # them)
                ng = getattr(model, "n_grid", model.nodes)
                if self.hds and save_head:
                    out = head_np[:ng].copy()
                    out[host_read(ibound[:ng]).numpy() == 0] = DHNOFLO
                    self.hds.write_step(kstp, kper, pertim, totim,
                                        out.reshape(shape3d))
                    if self.nc is not None:
                        self.nc.record(totim, out)
                if self.cbc and save_budget:
                    flowja = self._flowja_csr(head, ibound, cond, pkgs)
                    self.cbc.write_flowja(kstp, kper, flowja, shape3d, delt,
                                          pertim, totim)
                    self._write_boundary_cbc(flows, pkgs, kstp, kper, delt,
                                             pertim, totim)
                if has_oc and self.oc.active("PRINT", "HEAD", kper, kstp,
                                             nstp):
                    # OC PRINT HEAD: formatted layer arrays in the listing
                    self._lst_lines.append(self._format_array(
                        head_np[:ng].reshape(shape3d),
                        f"HEAD IN LAYER   AT END OF TIME STEP {kstp}, "
                        f"STRESS PERIOD {kper}"))
                if self.conc_hds is not None and (
                        self.gwt_oc.active("SAVE", self.conc_text, kper,
                                           kstp, nstp)
                        if self.gwt_oc is not None and self.gwt_oc.periods
                        else True):
                    # the grid rows (APT's feature rows follow them)
                    self.conc_hds.write_step(
                        kstp, kper, pertim, totim,
                        self.conc_records[-1][:self.gwt.grid.nodes].reshape(
                            _shape3d(self.gwt.grid)))
        if own:
            self._end_step(rec)
        return head

    def _end_step(self, rec):
        """Put the step's spans and counters on its record (its
        ``solve_seconds`` are its ``solve`` spans', its ``output_seconds``
        its ``output`` span's), fold them into the profile, and stop the
        run at a failed step unless it may go on."""
        rec.spans, rec.counters = take()
        rec.solve_seconds = sum(s.seconds for s in rec.spans
                                if s.name == "solve")
        rec.output_seconds = sum(s.seconds for s in rec.spans
                                 if s.name == "output")
        if self.prof is not None:
            self.prof.add(rec.spans)
        if not rec.converged:
            self._lst_lines.append(
                f"*** NONCONVERGENCE kper={rec.kper} kstp={rec.kstp} ***")
            if self.fail_fast:
                # reference default: a failed time step aborts the run
                # unless the simulation CONTINUE option is set
                # (Sim.f90:401-433 convergence bookkeeping + ustop)
                self.finish()
                raise ConvergenceFailure(
                    f"simulation failed to converge at kper={rec.kper} "
                    f"kstp={rec.kstp} (set the mfsim.nam CONTINUE option to "
                    "run on)")

    def _solve_transport(self, head, head_old, aux, pkgs, kstp, delt, iss,
                         passes=1, uzf_step=None):
        """FMI's fields of a flow solution (with IST's step-start immobile
        concentration) and the transport solved on them from the
        step-start concentration; commits nothing.  With APT rows, FMI
        runs on the grid rows of the base flow model and
        ``extract_apt_flows`` adds the features' flows (with UZT rows, from
        ``uzf_step``: the step's march and its step-start water content).
        A ``transport`` span holds an ``fmi`` span (with an ``apt`` span
        for the features' flows) and the transport solution's own
        ``outer`` spans; their host seconds, which wait for nothing, are
        the ``_Transport``'s, and its inner iterations go to the
        ``transport_inner`` count."""
        gwt = self.gwt
        with span("transport") as whole:
            apt = None
            with span("fmi") as fmi:
                if self._apt:
                    if gwt.gwf is not self.model:
                        raise NotImplementedError(
                            "APT rows over a flow model rebuilt at a later "
                            "period (the reference's transport keeps the "
                            "first period's features)")
                    N = gwt.n_grid
                    fields = from_gwf_step(
                        self.model.base, head[:N], head_old[:N],
                        aux["ibound"][:N], None, delt, iss, pkgs=pkgs,
                        ssm_spec=gwt.base.ssm_spec, gwt=gwt.base)
                    with span("apt") as apt:
                        res, theta_old = uzf_step if uzf_step is not None \
                            else (None, None)
                        fields = extract_apt_flows(
                            gwt, head, head_old, fields, delt, iss,
                            pkgs=pkgs, ext_conc=self.apt_ext_conc,
                            uzf_res=res, uzf_theta_old=theta_old)
                else:
                    fields = from_gwf_step(
                        self.model, head, head_old, aux["ibound"],
                        aux["cond"], delt, iss, pkgs=pkgs,
                        ssm_spec=gwt.ssm_spec, gwt=gwt)
                    if gwt.ist is not None:
                        fields = dataclasses.replace(fields, cim=gwt.cim)
                    gwt.set_flows(fields)
            conc, info, _ = self.gwt_solution.solve_timestep(
                self.conc, delt, kstp=kstp, iss=False, pkgs=fields)
        count("transport_inner", info.inner_iterations)
        apt_s = apt.seconds if apt is not None else 0.0
        return _Transport(fields, conc, info, fmi.seconds - apt_s, apt_s,
                          whole.seconds - fmi.seconds, passes)

    def _group_picard(self, head, info, aux, head_old, pkgs, kstp, delt,
                      iss):
        """The solution group's Picard passes (SolutionGroup.f90 sgp_ca
        with MXITER): the transport from the step-start concentration on
        the latest flow, then the flow again at the new concentration,
        until two transport solutions differ by at most ``sgp_dclose`` or
        ``sgp_mxiter`` passes ran; one host read a pass.  Returns the last
        flow solution, its packages and the transport solved on it."""
        transport = self._solve_transport(head, head_old, aux, pkgs, kstp,
                                          delt, iss)
        for passes in range(2, self.sgp_mxiter + 1):
            pkgs = dataclasses.replace(pkgs, buy_conc=transport.conc)
            head, info, aux = self.solution.solve_timestep(
                head_old, delt, kstp=kstp, iss=iss, pkgs=pkgs)
            prev = transport.conc
            transport = self._solve_transport(head, head_old, aux, pkgs,
                                              kstp, delt, iss, passes)
            if host_read((transport.conc - prev).abs().max(), float) <= \
                    self.sgp_dclose:
                break
        return head, info, aux, pkgs, transport

    def _commit_transport(self, rec, transport, ibound, kper, kstp, delt):
        """Commit the step's transport solution: IST's immobile
        concentration (at the flow's ibound, as the reference's update
        takes it), the concentration and the step's record."""
        gwt = self.gwt
        conc, info = transport.conc, transport.info
        if gwt.ist is not None:
            gwt.cim = ist_mod.ist_update(gwt.ist, transport.fields.sat,
                                         gwt.area, gwt.top, gwt.bot, ibound,
                                         self.conc, gwt.cim, conc, delt)
        self.conc = conc
        self.conc_records.append(host_read(conc).numpy())
        rec.fmi_seconds = transport.fmi_seconds
        rec.apt_seconds = transport.apt_seconds
        rec.transport_seconds = transport.solve_seconds
        rec.transport_converged = info.converged
        rec.transport_outer = info.outer_iterations
        rec.transport_inner = info.inner_iterations
        rec.group_iterations = transport.passes
        if not info.converged:
            kind = "GWE" if self.conc_text == "TEMPERATURE" else "GWT"
            self._lst_lines.append(
                f"*** {kind} NONCONVERGENCE kper={kper} kstp={kstp} ***")

    def _write_grb(self):
        """Write the binary grid file beside the heads output (the
        reference writes it at DIS initialization unless NOGRB); a
        composite (an augmented or a merged model) has no single user grid
        and gets none."""
        grid = self.model.grid
        if not self.hds_path or hasattr(self.model, "n_extra") \
                or not isinstance(grid, (DisGrid, DisvGrid, DisuGrid)):
            return
        path = str(self.hds_path)
        path = (path[:-4] if path.endswith(".hds") else path) + ".grb"
        write = (grb.write_grb_dis if isinstance(grid, DisGrid)
                 else grb.write_grb_disv if isinstance(grid, DisvGrid)
                 else grb.write_grb_disu)
        write(path, grid, self.model.npf_arrays.icelltype.cpu().numpy(),
              topo=self.model.topo)

    @staticmethod
    def _format_array(arr3d, title, per_line=10):
        """Formatted array print for the listing file (the reference's
        ulaprw fixed-format layer print, InputOutput.f90)."""
        lines = [title]
        nlay = arr3d.shape[0]
        for k in range(nlay):
            lines.append(f"  LAYER {k + 1}")
            for row in arr3d[k]:
                vals = np.asarray(row).reshape(-1)
                for i in range(0, vals.size, per_line):
                    lines.append("   " + " ".join(
                        f"{v:12.4f}" for v in vals[i:i + per_line]))
        return "\n".join(lines)

    def _obs_flows(self, flows, pkgs):
        """The boundary flows of every entry of each list package, masked
        entries at 0, for the flow observations: PKG → (nodes, q) (the
        reference's ``_obs_flows``, from the budget's own flows)."""
        out = {}
        for name, q in flows.items():
            data = getattr(pkgs, name.lower(), None)
            if name == "CHD":
                q = self._chd_entry_flows
            if data is not None and q is not None:
                out[name] = (data.node, q)
        return out

    def finish(self):
        """Close outputs and write the listing file (Mf6Finalize role)."""
        for drv in self.prt_drivers:
            drv.finish()
        if self.obs is not None:
            self.obs.close()
        if self.prof:
            self._lst_lines.append(self.prof.report(self.profile_mode))
        if self.lst_path:
            self._lst_lines.append(memory_report(self.model))
        if self.nc is not None:
            self.nc.close()
        if self.outer_csv:
            self.outer_csv.close()
        if self._inner_csv is not None:
            self._inner_csv.close()
            self._inner_csv = None
        if self.lst_path:
            with open(self.lst_path, "w") as f:
                f.write("\n".join(self._lst_lines))
        if self.hds:
            self.hds.close()
        if self.cbc:
            self.cbc.close()
        if self.conc_hds is not None:
            self.conc_hds.close()

    def run(self, save_heads_every=1, max_retries=10):
        """Time loop.  Periods listed in ``self.ats`` step adaptively
        (``_adaptive_period``); the others walk the fixed TDIS
        subdivision."""
        uzt = getattr(self.gwt, "uzf", None) is not None
        if self.gwt is not None and self.uzf is not None and not uzt:
            raise NotImplementedError(
                "GWT beside UZF without UZT rows (the reference's FMI drops "
                "the UZF flows)")
        if uzt and self.uzf is None:
            raise ValueError("UZT rows need the flow model's UZF columns "
                             "(Simulation.uzf)")
        if self._apt and self.sgp_mxiter > 1 and self._density_coupled:
            raise NotImplementedError(
                "MXITER > 1 with BUY or VSC and APT rows (the reference's "
                "solution group runs such a model once a step)")
        head = self.model.strt
        t0 = time.perf_counter()
        self._write_grb()
        self.grb_seconds = time.perf_counter() - t0
        totim = 0.0
        for kper, period in enumerate(self.tdis.periods, start=1):
            self._apply_time_varying(kper)
            for hook in self.period_hooks:
                hook(kper)
            if kper in self.ats:
                head, totim = self._adaptive_period(
                    head, kper, period, totim, save_heads_every, max_retries)
                continue
            pertim = 0.0
            for kstp, delt in enumerate(period.step_lengths(), start=1):
                pertim += delt
                totim += delt
                head = self.do_step(head, kper, kstp, float(delt),
                                    float(pertim), float(totim),
                                    save_heads_every)
        self.finish()
        return self.records

    def _adaptive_period(self, head, kper, period, totim, save_heads_every,
                         max_retries):
        """One period of adaptive steps (reference ats.f90 + mf6core.f90
        retryloop): each step starts at the last accepted step's length
        adjusted by its outer count, within [dtmin, dtmax] and cut at the
        period's end; a failed attempt is solved again at the step divided
        by dtfailadj, at most ``max_retries`` times and not below dtmin.
        Returns (head, totim) at the period's end."""
        a = self.ats[kper]
        delt = ats_mod.initial_delt(a)
        pertim, kstp = 0.0, 0
        while pertim < period.perlen - 1e-12:
            # the step's span holds its attempts
            take()      # what ran before the step is not the step's
            with span("step"):
                if self.gwt is not None and self.ats_percel \
                        and not hasattr(self.gwt, "mst_arrays"):
                    raise NotImplementedError(
                        "ATS_PERCEL with a GWE model or APT rows")
                if self.gwt is not None and self.ats_percel \
                        and self.gwt._fields is not None:
                    # the transport's Courant step on the last flow fields
                    # (model_dt / adv_dt role); one host read
                    g = self.gwt
                    dtadv = host_read(adv_mod.adv_dtmax(
                        g.dtopo, g._fields, g.ibound0, g.mst_arrays.porosity,
                        g.area, g.top, g.bot, self.ats_percel), float)
                    if np.isfinite(dtadv):
                        delt = min(delt, dtadv)
                delt = min(ats_mod.clamp(delt, a), period.perlen - pertim)
                kstp += 1
                with span("solve"):
                    solved = self.solve_step(head, kper, kstp, delt)
                    retries = 0
                    while (not solved[1].converged and a.dtfailadj > 1.0
                           and retries < max_retries and delt > a.dtmin):
                        delt = min(ats_mod.fail_delt(delt, a),
                                   period.perlen - pertim)
                        retries += 1
                        solved = self.solve_step(head, kper, kstp, delt)
                    self._sync()
                pertim += delt
                totim += delt
                head = self.do_step(head, kper, kstp, delt, pertim, totim,
                                    save_heads_every, solved=solved)
            rec = self.records[-1]
            rec.retries = retries
            self._end_step(rec)
            delt = ats_mod.next_delt(delt, a, solved[1].outer_iterations,
                                     self.solution.s.outer_maximum)
        return head, totim

    # ------------------------------------------------------------ helpers

    def _shape3d(self):
        return _shape3d(self.model.grid)

    def _flowja_csr(self, head, ibound, cond, pkgs):
        """The full CSR flowja array (diagonal entries zero) as numpy,
        matching the reference's .cbc FLOW-JA-FACE layout."""
        return host_read(self.model.flowja_csr(head, ibound, cond,
                                               pkgs)).numpy()

    def _accumulate_budget(self, head, head_old, ibound, cond, delt, iss,
                           pkgs=None):
        """Add this step's terms to the budget; returns the per-entry flows
        {name: tensor} that the budget file's list records hold."""
        model = self.model
        if pkgs is None:
            pkgs = model.packages
        flows = {}

        # CSUB storage release (at the start-of-step state in pkgs)
        if model.csub is not None and pkgs.csub_state is not None:
            a = model.npf_arrays
            d_c, r_c = csub_mod.assemble_csub(
                model.csub, pkgs.csub_state, a.top, a.bot, model.area,
                a.icelltype, head, head_old, ibound, delt)
            flows["CSUB"] = d_c * head - r_c

        # MAW, LAK and SFR: the exchange with the aquifer is this model's
        # budget entry (the features' own terms belong to the package
        # budgets, reference lak_bd/sfr_bd/maw_bd)
        ng = getattr(model, "n_grid", model.nodes)
        if ng != model.nodes:
            terms = model.advanced_budget(head, head_old, delt, iss, pkgs)
            for key in ("MAW", "LAK", "SFR"):
                if f"{key}-GWF" in terms:
                    flows[key] = terms[f"{key}-GWF"]
            # water a mover takes from a standard provider still leaves
            # the aquifer: its own <PKG>-TO-MVR term (the provider's rate
            # in boundary_budget is reduced by it)
            for key in ("WEL", "DRN", "RIV", "GHB"):
                if f"{key}-TO-MVR" in terms:
                    flows[f"{key}-TO-MVR"] = terms[f"{key}-TO-MVR"]

        # storage rates: into the cell, like sto_cq
        if model.sto_arrays is not None and not iss:
            flows["STO-SS"], flows["STO-SY"] = self._storage_rates(
                head[:ng], head_old[:ng], ibound[:ng], delt)

        # boundary packages; CHD: net flow from constant-head cells into the
        # model = -(sum of the face flows into the chd cell)
        for name, q in model.boundary_budget(head, ibound, pkgs).items():
            if q is None:
                into_cell = model.cell_inflow(head, ibound, cond, pkgs)
                chd = pkgs.chd
                self._chd_entry_flows = torch.where(
                    chd.mask, -into_cell[chd.node], 0.0)
                # a boolean mask's selection reads its count on the host
                q = host_read(self._chd_entry_flows, lambda f: f[chd.mask])
            flows[name] = q

        if flows:
            # one transfer for all the IN/OUT sums; the table lists CHD
            # after the other packages, as the reference's does
            names = sorted(flows, key=lambda name: name == "CHD")
            sums = host_read(torch.stack([
                torch.stack((flows[name].clamp(min=0.0).sum(),
                             -flows[name].clamp(max=0.0).sum()))
                for name in names]), torch.Tensor.tolist)
            for name, (rate_in, rate_out) in zip(names, sums):
                self.budget.add_rates(name, rate_in, rate_out, delt)
        return flows

    def _write_boundary_cbc(self, flows, pkgs, kstp, kper, delt, pertim,
                            totim):
        """One imeth=6 (ubdsv06, InputOutput.f90:981) list record per
        storage term and boundary package, so .cbc post-processing sees
        the storage and boundary flows and not just FLOW-JA-FACE."""
        model = self.model
        shape3d = self._shape3d()
        mname = model.name.upper()
        for name, q in flows.items():
            if name in ("CSUB", "MAW", "LAK", "SFR") \
                    or name.endswith("-TO-MVR"):
                continue        # the reference writes no record of these
            if name.startswith("STO-"):
                nodes = np.arange(q.shape[0])
                qv = host_read(q).numpy()
            elif name.startswith("UZF-"):
                nodes = host_read(pkgs.uzf.node).numpy()
                qv = host_read(q).numpy()
            else:
                data = getattr(pkgs, name.lower())
                mask = host_read(data.mask).numpy()
                nodes = host_read(data.node).numpy()[mask]
                # the CHD flows are already cut to the masked entries
                qv = host_read(q).numpy()
                qv = qv if name == "CHD" else qv[mask]
            self.cbc.write_list(kstp, kper, name, nodes, qv, shape3d, delt,
                                pertim, totim, mname, name)

    def _storage_rates(self, head, head_old, ibound, delt):
        """Per-cell SS and SY rates (reference sto_cq gwf-sto.f90)."""
        return storage_rates(self.model.sto_opts, self.model.sto_arrays,
                             head, head_old, ibound, delt)


def _shape3d(grid):
    """The (nlay, nrow, ncol) that the output records of ``grid`` state: a
    DISV grid is (nlay, 1, ncpl), a DISU or merged grid (1, 1, nodes)."""
    shp = grid.shape
    if len(shp) == 3:
        return shp
    if len(shp) == 2:
        return (shp[0], 1, shp[1])
    return (1, 1, shp[0])
