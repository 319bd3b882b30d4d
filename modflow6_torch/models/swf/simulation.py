"""SWF run loop: walks TDIS, solves each step with ``NumericalSolution``,
keeps the volumetric budget and writes the STAGE file.

Port of modflow6_tpu/models/swf/simulation.py (the reference's RunControl
and NumericalSolution for one CHF/OLF model, chf.f90/olf.f90 over
swf.f90).  The budget's flows stay on the device until one host read a
step; the CHD flow of each constant-stage entry is the negative of its
cell's edge inflow, summed through the ELL slots where the reference adds
the edges into the cells with a host ``np.add.at``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...solution.ims import ImsSettings, NumericalSolution
from ...utils.binary import HeadFileWriter
from ...utils.budget import Budget
from .model import _squadratic


def default_settings() -> ImsSettings:
    """The DBD settings of a CHF/OLF run (the reference's SWF defaults)."""
    return ImsSettings(
        outer_dvclose=1e-8, outer_maximum=300, inner_dvclose=1e-10,
        inner_rclose=1e-9, inner_maximum=500,
        linear_acceleration="bicgstab", no_ptc=True,
        under_relaxation="dbd", theta=0.9, akappa=1e-4, gamma=0.0,
        amomentum=0.0)


@dataclasses.dataclass
class SwfStepRecord:
    kper: int
    kstp: int
    totim: float
    stage: np.ndarray
    converged: bool
    outer: int = 0
    inner: int = 0


class SwfSimulation:
    """Single-model CHF/OLF run loop (a deck or Python)."""

    def __init__(self, tdis, model, settings: ImsSettings = None,
                 sto_periods=None, has_sto=False, hds_path=None, oc=None):
        self.tdis = tdis
        self.model = model
        self.settings = settings or default_settings()
        self.solution = NumericalSolution(model, self.settings)
        # per-period steady/transient flags (swf-sto PERIOD blocks);
        # without a STO6 package the model is steady (swf.f90)
        self.sto_periods = sto_periods or {}
        self.has_sto = has_sto
        self.hds_path = hds_path
        self.oc = oc
        self.budget = Budget()
        self.records = []

    def _iss(self, kper):
        if not self.has_sto:
            return True
        flag = None
        for k in sorted(self.sto_periods):
            if k <= kper:
                flag = self.sto_periods[k]
        return not flag if flag is not None else False

    def _volume(self, stage):
        d = stage - self.model.bot
        return self.model.area * d * _squadratic(d)

    def run(self):
        model = self.model
        stage = model.strt
        writer = HeadFileWriter(self.hds_path, text="STAGE") \
            if self.hds_path else None
        for kper, kstp, delt, pertim, totim in self.tdis.walk():
            iss = self._iss(kper)
            stage_old = stage
            stage, info, aux = self.solution.solve_timestep(
                stage, delt=delt, kstp=kstp, iss=iss)
            ibound = aux["ibound"]
            terms = dict(model.boundary_budget(stage, ibound))
            if model.chd is not None:
                node, _, mask = model.chd
                into = model.cell_inflow(model.edge_flows(stage, ibound))
                terms["CHD"] = -into[node[mask]]
            if not iss:
                dv = self._volume(stage) - self._volume(stage_old)
                terms["STO"] = -dv / delt
            # the step's one host read: the budget terms and the stage
            names = list(terms)
            sizes = [terms[k].numel() for k in names]
            flat = torch.cat([terms[k].reshape(-1) for k in names]
                             + [stage]).cpu().numpy()
            pos = 0
            for name, size in zip(names, sizes):
                self.budget.add_entries(name, flat[pos:pos + size], delt)
                pos += size
            stage_np = flat[pos:]
            save = True
            if self.oc is not None:
                nstp = self.tdis.periods[kper - 1].nstp
                save = self.oc.active("SAVE", "STAGE", kper, kstp, nstp) \
                    or self.oc.active("SAVE", "HEAD", kper, kstp, nstp)
            if writer is not None and save:
                writer.write_step(kstp, kper, pertim, totim,
                                  stage_np[None, None, :])
            self.records.append(SwfStepRecord(
                kper=kper, kstp=kstp, totim=totim, stage=stage_np,
                converged=bool(info.converged),
                outer=info.outer_iterations, inner=info.inner_iterations))
        if writer is not None:
            writer.close()
        return self.records
