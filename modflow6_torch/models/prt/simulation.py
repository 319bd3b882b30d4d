"""PRT driver: the particles' advance over each solved GWF step.

Port of modflow6_tpu/models/prt/simulation.py (``PrtDriver``; reference
prt.f90:62-85 prt_solve per time step, ExplicitSolution.f90:39, the PRP
release schedule prt-prp.f90 prp_rp and the track-file output
TrackControl.f90).  All particle slots (points × release times) live in
fixed tensors.  Each accepted flow step builds the cell flows once and
advances (a) the particles already live for the whole step and (b) each
release batch whose release time falls in the step for the rest of the
step, every horizon capped at STOPTIME.  The reference tracks every slot
and keeps the live ones' results; the port gathers the live slots,
tracks them alone and scatters their state back: each particle is
independent, so the results are the same.  The stop zones, STOPTIME and
the release horizons are host logic, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gwf import npf as npf_mod
from . import tracking
from .trackfile import (REASON_TERMINATE, REASON_TIMESTEP, ReleaseSchedule,
                        TrackFileWriter)

TERM_STOPTIME = 4
TERM_STOPZONE = 5


@dataclasses.dataclass
class PrtDriver:
    """The particle state across the simulation's time loop."""

    model: object                  # PrtModel
    gwf_model: object
    schedule: ReleaseSchedule
    track_path: str = None
    trackcsv_path: str = None
    stoptime: float = np.inf
    istopzone: int = 0
    izone: object = None           # i32[N] MIP zones (stop zones)

    def begin(self, tdis):
        self.release_times = self.schedule.release_times(tdis)
        npts = len(self.model.prp.x)
        nrel = max(len(self.release_times), 1)
        ntot = npts * nrel
        self.is_disv = hasattr(self.model.grid, "ncpl")
        dev = self.gwf_model.device
        self.device = dev
        if self.is_disv:
            from . import tracking_disv
            g = self.model.grid
            porosity = torch.as_tensor(self.model.porosity).cpu().numpy()
            self._fan = tracking_disv.build_fan(
                g, self.gwf_model.topo, porosity.reshape(-1), device=dev)
            lay, row, col = tracking_disv.locate(
                self._fan, np.asarray(self.model.prp.x, float),
                np.asarray(self.model.prp.y, float),
                np.asarray(self.model.prp.z, float))
            # (lay, cell, tri) ride the (lay, row, col) slots
        else:
            lay, row, col = self.model.locate()

        def tile(a, dtype):
            return torch.as_tensor(np.tile(np.asarray(a, dtype), nrel),
                                   device=dev)

        self.x = tile(self.model.prp.x, np.float64)
        self.y = tile(self.model.prp.y, np.float64)
        self.z = tile(self.model.prp.z, np.float64)
        self.lay = tile(lay, np.int64)
        self.row = tile(row, np.int64)
        self.col = tile(col, np.int64)
        rt = (np.repeat(np.asarray(self.release_times), npts)
              if len(self.release_times) else np.full(npts, np.inf))
        self.trelease = np.asarray(rt, float)
        self.released = np.zeros(ntot, bool)
        self.status = np.full(ntot, tracking.ACTIVE, np.int32)
        self.ttrack = np.zeros(ntot)                # travel time so far
        self.transitions = np.zeros(ntot, np.int64)  # in the last advance
        self.irpt = np.tile(np.arange(npts, dtype=np.int32), nrel)
        self.writer = TrackFileWriter(self.track_path) \
            if self.track_path else None
        self.csv_writer = TrackFileWriter(self.trackcsv_path, csv=True) \
            if self.trackcsv_path else None
        if self.is_disv:
            from . import tracking_disv
            self._track = tracking_disv.make_tracker_disv(self._fan)

    # ------------------------------------------------------------ kernel

    def _step_fn(self, head, ibound, cond):
        """The step's tracker over the flow of (head, ibound, cond):
        track(x, y, z, lay, row, col, tmax) → state dict with ``row`` and
        ``col`` (on DISV: the cell and the triangle)."""
        gwf = self.gwf_model
        if not self.is_disv:
            return self.model.tracker(gwf, head, ibound, cond)
        from . import tracking_disv
        g = self.model.grid
        Qout, u, qzt, qzb = tracking_disv.fan_fluxes(
            self._fan, gwf.edge_flows(head, ibound, cond))
        sat = npf_mod.compute_saturation(gwf.npf_opts, gwf.npf_arrays,
                                         head, ibound).reshape(g.nlay, g.ncpl)

        def track(x, y, z, lay, cell, tri, tmax):
            out = self._track(x, y, z, lay, cell, tri, Qout, u, qzt, qzb,
                              sat, tmax)
            return dict(out, row=out["cell"], col=out["tri"])

        return track

    # ------------------------------------------------------------- drive

    def on_step(self, kper, kstp, delt, totim, head, ibound, cond):
        """Advance the swarm across one accepted flow step (prt_solve)."""
        # an augmented flow model carries feature rows: track on the grid's
        ng = getattr(self.gwf_model, "n_grid", None) or self.gwf_model.nodes
        head = head[:ng]
        ibound = ibound[:ng]
        track = self._step_fn(head, ibound, cond)
        t0 = totim - delt
        rt = self.trelease
        # the particles live before the step over the whole step, then each
        # release time in (t0, totim] over the rest of it; STOPTIME caps
        # every horizon (tracking halts at that time exactly)
        horizons = [(None, float(min(delt, self.stoptime - t0)))]
        for t in np.unique(rt[(rt > t0 - 1e-12) & (rt <= totim + 1e-12)
                              & ~self.released]):
            horizons.append((float(t), float(min(totim, self.stoptime) - t)))
        for rel_t, tmax in horizons:
            if rel_t is None:
                live_np = self.released & (self.status == tracking.ACTIVE)
            else:
                live_np = np.abs(rt - rel_t) <= 1e-12
                self.released |= live_np
            if not live_np.any() or tmax <= 0:
                continue
            idx = torch.as_tensor(np.flatnonzero(live_np), device=self.device)
            out = track(self.x[idx], self.y[idx], self.z[idx],
                        self.lay[idx], self.row[idx], self.col[idx], tmax)
            for name in ("x", "y", "z", "lay", "row", "col"):
                getattr(self, name)[idx] = out[name]
            # one host read of the batch's status, time and transitions
            st, tt, hops = (v.cpu().numpy() for v in
                            (out["status"], out["time"], out["transitions"]))
            self.ttrack[live_np] += tt
            self.transitions[live_np] = hops
            # TERM_TIMEOUT within a step means still active next step
            self.status[live_np] = np.where(st == tracking.TERM_TIMEOUT,
                                            tracking.ACTIVE, st)
        # stop zones and STOPTIME (prp istopzone / stoptime)
        if self.istopzone and self.izone is not None:
            inzone = np.asarray(self.izone).reshape(-1)[self._node_of()] \
                == self.istopzone
            self.status = np.where(
                self.released & (self.status == tracking.ACTIVE) & inzone,
                TERM_STOPZONE, self.status)
        if np.isfinite(self.stoptime):
            self.status = np.where(
                self.released & (self.status == tracking.ACTIVE)
                & (self.ttrack + self.trelease >= self.stoptime - 1e-12),
                TERM_STOPTIME, self.status)
        self._write_records(kper, kstp)

    def _node_of(self):
        lay = self.lay.cpu().numpy()
        if self.is_disv:
            return lay * self.model.grid.ncpl + self.row.cpu().numpy()
        shp = self.model.grid.shape
        return (lay * shp[1] + self.row.cpu().numpy()) * shp[2] \
            + self.col.cpu().numpy()

    def _write_records(self, kper, kstp):
        """One record per released particle per step (TrackControl)."""
        sel = np.flatnonzero(self.released)
        if not len(sel) or (self.writer is None and self.csv_writer is None):
            return
        node = self._node_of()
        lay = self.lay.cpu().numpy()
        x, y, z = (v.cpu().numpy() for v in (self.x, self.y, self.z))
        reason = np.where(self.status[sel] == tracking.ACTIVE,
                          REASON_TIMESTEP, REASON_TERMINATE)
        for w in (self.writer, self.csv_writer):
            if w is not None:
                w.write(kper, kstp, self.irpt[sel] + 1, lay[sel] + 1,
                        node[sel] + 1, self.status[sel], reason,
                        self.trelease[sel],
                        self.ttrack[sel] + self.trelease[sel],
                        x[sel], y[sel], z[sel])

    def finish(self):
        for w in (self.writer, self.csv_writer):
            if w is not None:
                w.close()
