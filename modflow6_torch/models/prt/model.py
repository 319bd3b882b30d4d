"""PRT model: particle tracking on GWF flow fields.

Port of modflow6_tpu/models/prt/model.py (reference prt.f90:41 with its
explicit ``model_solve`` per step :62-85, the PRP release points
(prt-prp.f90) and MIP's porosity).  The tracking lives in ``tracking``
(Pollock on DIS) and ``tracking_disv`` (ternary on DISV); the driver in
``simulation``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gwf import npf as npf_mod
from . import tracking


@dataclasses.dataclass
class ReleasePoints:
    """PRP: release points in model coordinates (prt-prp.f90)."""

    x: np.ndarray
    y: np.ndarray
    z: np.ndarray


@dataclasses.dataclass
class PrtModel:
    """Particle-tracking model over a DIS or DISV grid."""

    name: str
    grid: object                 # DisGrid or DisvGrid
    porosity: object             # f64[N] (MIP)
    prp: ReleasePoints

    def locate(self):
        """Release coordinates → (lay, row, col) on a DIS grid (host)."""
        g = self.grid
        delr = np.asarray(g.delr, float)
        delc = np.asarray(g.delc, float)
        xedge = np.concatenate([[0.0], np.cumsum(delr)])
        ytot = delc.sum()
        yedge = ytot - np.concatenate([[0.0], np.cumsum(delc)])
        col = np.clip(np.searchsorted(xedge, self.prp.x, "right") - 1,
                      0, len(delr) - 1)
        # yedge decreases; row r spans [yedge[r+1], yedge[r])
        row = np.clip(len(delc) - np.searchsorted(yedge[::-1], self.prp.y,
                                                  "left"),
                      0, len(delc) - 1)
        bot3 = np.asarray(g.bot).reshape(g.shape)
        # the layer below every bottom above the point (the reference's
        # loop over the layers, the last one that holds wins)
        above = np.asarray(self.prp.z)[None, :] < bot3[:, row, col]
        lay = np.where(above.any(axis=0),
                       g.shape[0] - np.argmax(above[::-1], axis=0), 0)
        lay = np.clip(lay, 0, g.shape[0] - 1)
        return (lay.astype(np.int32), row.astype(np.int32),
                col.astype(np.int32))

    def tracker(self, gwf_model, head, ibound, cond):
        """The swarm's tracker over the flow of one solved step:
        track(x, y, z, lay, row, col, tmax) (``tracking.make_tracker``)."""
        if getattr(self, "_top", None) is None:
            dev = gwf_model.device
            self._top = torch.as_tensor(np.asarray(self.grid.top, np.float64),
                                        device=dev)
            self._bot = torch.as_tensor(np.asarray(self.grid.bot, np.float64),
                                        device=dev)
        sat = npf_mod.compute_saturation(gwf_model.npf_opts,
                                         gwf_model.npf_arrays, head, ibound)
        flows = tracking.build_cell_flows(gwf_model, head, ibound, cond,
                                          self.porosity, sat)
        return tracking.make_tracker(flows, self._top, self._bot)

    def make_step(self, gwf_model):
        """step(head, ibound, cond, x, y, z, lay, row, col, dt) → the new
        particle state dict (one swarm advance over a solved step)."""
        def step(head, ibound, cond, x, y, z, lay, row, col, dt):
            return self.tracker(gwf_model, head, ibound, cond)(
                x, y, z, lay, row, col, dt)

        return step

    def initial_state(self, device=None):
        lay, row, col = self.locate()

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device)

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        return (f64(self.prp.x), f64(self.prp.y), f64(self.prp.z), i64(lay),
                i64(row), i64(col))
