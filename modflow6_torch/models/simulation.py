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
the merged order as one 1 × nodes record per step.  The transport
coupling (``gwt``, which would hand the concentrations to BUY and VSC,
and ``ats_percel``, the advective ATS limit) and PRT are outside the
ported slice: ``gwt`` and ``ats_percel`` raise.  Without transport BUY and
VSC see a concentration only where ``period_data`` sets ``buy_conc``, as
in the reference.

The output phase works on the model's device.  Face flows, their per-cell
sums (the CHD flows) and the storage rates are computed there from the
structured planes; each step the host reads the budget's IN/OUT sums in one
transfer, the observed values in one more, and the arrays of a record only
when that record is saved.  On the general path the same holds with the
per-edge flows in place of the planes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..constants import DHNOFLO
from .discretization import DisGrid, DisuGrid, DisvGrid
from ..ops.smoothing import quadratic_saturation
from ..ops.storage import ss_capacity, ss_terms, sy_capacity
from ..solution.ims import ImsSettings, NumericalSolution
from ..timing import ats as ats_mod
from ..timing.tdis import Tdis
from ..utils import grb
from ..utils.binary import BudgetFileWriter, HeadFileWriter
from ..utils.budget import Budget
from ..utils.csvout import OuterCsvWriter
from .gwf import csub as csub_mod
from .gwf import uzf as uzf_mod


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
    solve_seconds: float = 0.0      # host clock, device work finished
    output_seconds: float = 0.0     # budget, record and file output
    uzf_resolves: int = 0           # uzf_cc re-solves of the step
    retries: int = 0                # ATS attempts that failed before it


class Simulation:
    """One flow model + one IMS solution + TDIS."""

    def __init__(self, tdis: Tdis, model, settings: ImsSettings,
                 transient=None, hds_path=None, cbc_path=None,
                 lst_path=None, outer_csv_path=None, oc=None, gwt=None,
                 obs=None, nc_path=None):
        if gwt is not None:
            raise NotImplementedError(
                "the GWT transport coupling (gwt=) is not ported")
        self.tdis = tdis
        self.model = model
        self.solution = NumericalSolution(model, settings)
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
        """The period's packages with the step-start CSUB state."""
        pkgs = self.period_packages(kper)
        if self.model.csub is not None:
            pkgs = dataclasses.replace(pkgs, csub_state=self.csub_state)
        return pkgs

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
            return self.solution.solve_timestep(head_old, delt, kstp=kstp,
                                                iss=iss, pkgs=p, kper=kper)

        solved = solve(pkgs)
        self._uzf_resolves = 0
        if self.uzf is None or self.uzf.node.shape[0] == 0:
            return solved
        area = self.uzf.area
        for _ in range(self.uzf_maxiter):
            res_prev = self._uzf_pending[0]
            res = uzf_mod.advance(self.uzf, self.uzf_theta, delt,
                                  head=solved[0], watab_old=self.uzf_watab)
            dmax, scale = torch.stack((
                ((res.rch - res_prev.rch).abs() * area).max(),
                (res.rch * area).abs().max())).tolist()
            if dmax <= max(1e-10, 1e-6 * (scale + 1e-30)):
                break
            pkgs = dataclasses.replace(pkgs, uzf=uzf_mod.make_step(
                self.uzf, res))
            self._uzf_pending = (res, pkgs)
            solved = solve(pkgs)
            self._uzf_resolves += 1
        return solved

    def _sync(self):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def do_step(self, head, kper, kstp, delt, pertim, totim,
                save_heads_every=1, solved=None):
        """Advance one time step (Mf6PrepareTimestep + Mf6DoTimestep +
        Mf6FinalizeTimestep for the single-solution case).  Returns the new
        head; appends the StepRecord and writes outputs.  ``solved``: the
        accepted attempt's ``solve_step`` result (the ATS path), else the
        step is solved here."""
        model = self.model
        iss = not self.transient[kper - 1]
        head_old = head
        for hook in self.step_hooks:
            hook(kper, kstp, delt)
        pkgs = self.step_packages(kper)
        t0 = time.perf_counter()
        if solved is None:
            solved = self.solve_step(head_old, kper, kstp, delt)
        head, info, aux = solved
        ibound, cond = aux["ibound"], aux["cond"]
        if self._uzf_pending is not None:
            # commit the column state the accepted solve used; its
            # packages (with the UZF terms) serve the budget and outputs
            res, pkgs = self._uzf_pending
            self.uzf_theta, self.uzf_watab = res.theta, res.watab
            self._uzf_pending = None
        if model.csub is not None:
            # pkgs keeps the start-of-step state (for budgets); then the
            # state advances: es0 ← es, pcs ← max(pcs, es), compaction +=
            a = model.npf_arrays
            self.csub_state = csub_mod.advance_state(
                model.csub, self.csub_state, a.top, a.bot, model.area,
                a.icelltype, head, head_old, ibound, delt)
        maw = getattr(model, "maw", None)
        if maw is not None and maw.shut is not None:
            # MAW SHUT_OFF hysteresis advances at the accepted solution
            # (gwf-maw.f90 shutoffmin/max); one host read per step
            new_shut = maw.advance_shutoff(head, model._maw_offset)
            if bool(torch.any(new_shut != maw.shut)):
                model.maw = dataclasses.replace(maw, shut=new_shut)
                self.solution = NumericalSolution(model, self.solution.s)
        self._sync()
        t1 = time.perf_counter()
        if self.outer_csv:
            self.outer_csv.write_step(totim, kper, kstp, info)
        if info.inner_traces:
            # IMS CSV_INNER_OUTPUT: one row per inner iteration
            if self._inner_csv is None:
                self._inner_csv = open(self.solution.s.csv_inner_path, "w")
                self._inner_csv.write(
                    "totim,kper,kstp,kouter,kinner,dvmax,rmax,l2norm\n")
            for kiter, n, dv, rm, l2 in info.inner_traces:
                for i in range(n):
                    self._inner_csv.write(
                        f"{totim},{kper},{kstp},{kiter},{i + 1},"
                        f"{dv[i]:.10g},{rm[i]:.10g},{l2[i]:.10g}\n")
            self._inner_csv.flush()

        # the iteration summary of the reference program's listing
        # (NumericalSolution.f90 sln_ot); modflow6_tpu's listing has none
        self._lst_lines.append(
            f" {info.outer_iterations} CALLS TO NUMERICAL SOLUTION IN TIME "
            f"STEP {kstp} STRESS PERIOD {kper}")
        self._lst_lines.append(f" {info.inner_iterations} TOTAL ITERATIONS")
        self._lst_lines.append("")

        # ---- budget (model_cq/model_bd phase)
        flows = self._accumulate_budget(head, head_old, ibound, cond, delt,
                                        iss, pkgs)
        table = self.budget.table(
            f"VOLUME BUDGET FOR ENTIRE MODEL AT END OF TIME STEP {kstp}, "
            f"STRESS PERIOD {kper}")
        # OC PRINT BUDGET selection; without OC PERIOD blocks every step's
        # table is kept in the listing
        nstp = self.tdis.periods[kper - 1].nstp
        has_oc = self.oc is not None and bool(self.oc.periods)
        print_budget = (self.oc.active("PRINT", "BUDGET", kper, kstp, nstp)
                        if has_oc else True)
        if print_budget:
            self._lst_lines.append(table)
            self._lst_lines.append("")

        if self.obs is not None:
            self.obs.record(totim, head, flows=self._obs_flows(flows, pkgs))

        head_np = head.cpu().numpy()
        rec = StepRecord(kper, kstp, totim, head_np, info.converged,
                         info.outer_iterations, info.inner_iterations, table,
                         uzf_resolves=self._uzf_resolves)
        self.records.append(rec)

        # ---- outputs (OC SAVE selection when PERIOD blocks are present)
        save_head = (self.oc.active("SAVE", "HEAD", kper, kstp, nstp)
                     if has_oc else kstp % save_heads_every == 0)
        save_budget = (self.oc.active("SAVE", "BUDGET", kper, kstp, nstp)
                       if has_oc else True)
        shape3d = self._shape3d()
        # the grid rows (an augmented model's feature rows follow them)
        ng = getattr(model, "n_grid", model.nodes)
        if self.hds and save_head:
            out = head_np[:ng].copy()
            out[ibound[:ng].cpu().numpy() == 0] = DHNOFLO
            self.hds.write_step(kstp, kper, pertim, totim,
                                out.reshape(shape3d))
            if self.nc is not None:
                self.nc.record(totim, out)
        if self.cbc and save_budget:
            flowja = self._flowja_csr(head, ibound, cond, pkgs)
            self.cbc.write_flowja(kstp, kper, flowja, shape3d, delt, pertim,
                                  totim)
            self._write_boundary_cbc(flows, pkgs, kstp, kper, delt, pertim,
                                     totim)
        if has_oc and self.oc.active("PRINT", "HEAD", kper, kstp, nstp):
            # OC PRINT HEAD: formatted layer arrays in the listing
            self._lst_lines.append(self._format_array(
                head_np[:ng].reshape(shape3d),
                f"HEAD IN LAYER   AT END OF TIME STEP {kstp}, "
                f"STRESS PERIOD {kper}"))
        rec.solve_seconds = t1 - t0
        rec.output_seconds = time.perf_counter() - t1
        if not info.converged:
            self._lst_lines.append(
                f"*** NONCONVERGENCE kper={kper} kstp={kstp} ***")
            if self.fail_fast:
                # reference default: a failed time step aborts the run
                # unless the simulation CONTINUE option is set
                # (Sim.f90:401-433 convergence bookkeeping + ustop)
                self.finish()
                raise ConvergenceFailure(
                    f"simulation failed to converge at kper={kper} "
                    f"kstp={kstp} (set the mfsim.nam CONTINUE option to "
                    "run on)")
        return head

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
        if self.obs is not None:
            self.obs.close()
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

    def run(self, save_heads_every=1, max_retries=10):
        """Time loop.  Periods listed in ``self.ats`` step adaptively
        (``_adaptive_period``); the others walk the fixed TDIS
        subdivision."""
        if self.ats_percel is not None:
            raise NotImplementedError(
                "ats_percel (the GWT advection's ATS_PERCEL limit) is not "
                "ported")
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
            delt = min(ats_mod.clamp(delt, a), period.perlen - pertim)
            kstp += 1
            t0 = time.perf_counter()
            solved = self.solve_step(head, kper, kstp, delt)
            retries = 0
            while (not solved[1].converged and a.dtfailadj > 1.0
                   and retries < max_retries and delt > a.dtmin):
                delt = min(ats_mod.fail_delt(delt, a), period.perlen - pertim)
                retries += 1
                solved = self.solve_step(head, kper, kstp, delt)
            self._sync()
            solve_seconds = time.perf_counter() - t0
            pertim += delt
            totim += delt
            head = self.do_step(head, kper, kstp, delt, pertim, totim,
                                save_heads_every, solved=solved)
            self.records[-1].retries = retries
            self.records[-1].solve_seconds += solve_seconds
            delt = ats_mod.next_delt(delt, a, solved[1].outer_iterations,
                                     self.solution.s.outer_maximum)
        return head, totim

    # ------------------------------------------------------------ helpers

    def _shape3d(self):
        """The (nlay, nrow, ncol) that the output records state: a DISV
        grid is (nlay, 1, ncpl), a DISU grid (1, 1, nodes)."""
        shp = self.model.grid.shape
        if len(shp) == 3:
            return shp
        if len(shp) == 2:
            return (shp[0], 1, shp[1])
        return (1, 1, shp[0])

    def _flowja_csr(self, head, ibound, cond, pkgs):
        """The full CSR flowja array (diagonal entries zero) as numpy,
        matching the reference's .cbc FLOW-JA-FACE layout."""
        return self.model.flowja_csr(head, ibound, cond, pkgs).cpu().numpy()

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
                q = self._chd_entry_flows[chd.mask]
            flows[name] = q

        if flows:
            # one transfer for all the IN/OUT sums; the table lists CHD
            # after the other packages, as the reference's does
            names = sorted(flows, key=lambda name: name == "CHD")
            sums = torch.stack([
                torch.stack((flows[name].clamp(min=0.0).sum(),
                             -flows[name].clamp(max=0.0).sum()))
                for name in names]).tolist()
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
                qv = q.cpu().numpy()
            elif name.startswith("UZF-"):
                nodes = pkgs.uzf.node.cpu().numpy()
                qv = q.cpu().numpy()
            else:
                data = getattr(pkgs, name.lower())
                mask = data.mask.cpu().numpy()
                nodes = data.node.cpu().numpy()[mask]
                # the CHD flows are already cut to the masked entries
                qv = q.cpu().numpy()
                qv = qv if name == "CHD" else qv[mask]
            self.cbc.write_list(kstp, kper, name, nodes, qv, shape3d, delt,
                                pertim, totim, mname, name)

    def _storage_rates(self, head, head_old, ibound, delt):
        """Per-cell SS and SY rates (reference sto_cq gwf-sto.f90)."""
        o, a = self.model.sto_opts, self.model.sto_arrays
        tled = 1.0 / delt
        tp, bt = a.top, a.bot
        is_conv = a.iconvert != 0
        snold = torch.where(is_conv, quadratic_saturation(tp, bt, head_old,
                                                          o.satomega), 1.0)
        snnew = torch.where(is_conv, quadratic_saturation(tp, bt, head,
                                                          o.satomega), 1.0)
        rho1 = ss_capacity(o.istor_coef, tp, bt, a.area, a.ss) * tled
        aterm, rhsterm = ss_terms(a.iconvert, o.iorig_ss, o.iconf_ss, tp, bt,
                                  rho1, rho1, snnew, snold, head, head_old)
        rate_ss = aterm * head - rhsterm
        rho2 = sy_capacity(a.area, a.sy) * tled
        tthk = tp - bt
        rate_sy = torch.where(is_conv,
                              rho2 * tthk * snold - rho2 * tthk * snnew, 0.0)
        act = ibound >= 1
        return (torch.where(act, rate_ss, 0.0),
                torch.where(act, rate_sy, 0.0))
