"""SWF–GWF exchange: leakage between surface water and an aquifer.

Port of modflow6_tpu/models/swf/exchange.py (reference exg-swfgwf.f90 and
the CHF-GWF / OLF-GWF types): per linked (surface cell, aquifer cell) pair
q = cond·(stage − head), positive into the aquifer, the surface cell's
infiltration smoothly shut off as it dries.  The two models are solved in
turn inside a Picard loop over the exchange (the solution-group MXITER
pattern, SolutionGroup.f90:48-106): each pass the SWF model sees the
leakage as a head-dependent term at the pass's aquifer heads, the GWF model
the pass's leakage as well entries appended to its own.  The appended
``WelData`` is made once, and each pass swaps its rates (``bnd.with_values``),
so its cached ``AddPlan`` sums the entries into their cells in entry order
on every pass.  The host reads the pass's largest change once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...solution.ims import ImsSettings, NumericalSolution
from ..gwf import bnd
from .model import SwfModel, SwfPackageData, _squadratic


@dataclasses.dataclass
class SwfGwfExchange:
    """Linked cell pairs (exg-swfgwf exchangedata)."""

    swf_node: np.ndarray   # i32[B]
    gwf_node: np.ndarray   # i32[B]
    cond: np.ndarray       # f64[B] = bedleak · cfact


class CoupledSwfGwf:
    """CHF/OLF and GWF stepped in turn with a Picard loop over the
    exchange."""

    def __init__(self, swf: SwfModel, gwf, exchange: SwfGwfExchange,
                 swf_settings=None, gwf_settings=None, mxiter=30,
                 dvclose=1e-7):
        self.swf = swf
        self.gwf = gwf
        self.exg = exchange
        self.mxiter = mxiter
        self.dvclose = dvclose
        self.swf_sol = NumericalSolution(swf, swf_settings or ImsSettings(
            outer_dvclose=1e-8, inner_dvclose=1e-10, inner_rclose=1e-9,
            inner_maximum=500, outer_maximum=100,
            linear_acceleration="bicgstab", no_ptc=True,
            under_relaxation="dbd", theta=0.9, akappa=1e-4))
        self.gwf_sol = NumericalSolution(gwf, gwf_settings or ImsSettings(
            outer_dvclose=1e-8, inner_dvclose=1e-10, inner_rclose=1e-9,
            inner_maximum=500, outer_maximum=100))
        dev = swf.device
        self._sn = torch.as_tensor(np.asarray(exchange.swf_node),
                                   dtype=torch.int64, device=dev)
        self._gn = torch.as_tensor(np.asarray(exchange.gwf_node),
                                   dtype=torch.int64, device=dev)
        self._c = torch.as_tensor(np.asarray(exchange.cond, np.float64),
                                  dtype=torch.float64, device=dev)
        # the GWF wells with the exchange's entries after them; the rates
        # are swapped each pass, the entries (and so the plan) stay
        ones = torch.ones_like(self._c, dtype=torch.bool)
        own = gwf.wel
        self._wel = bnd.WelData(self._gn, torch.zeros_like(self._c), ones) \
            if own is None else bnd.WelData(
                torch.cat([own.node, self._gn]),
                torch.cat([own.q, torch.zeros_like(self._c)]),
                torch.cat([own.mask, ones]))
        self._own_q = None if own is None else own.q

    def leakage(self, stage, head):
        """q per pair, positive into the aquifer, dry-cell smoothed."""
        depth = stage[self._sn] - self.swf.bot[self._sn]
        f = _squadratic(depth, 1e-4)
        dh = stage[self._sn] - head[self._gn]
        # infiltration shuts off as the surface cell dries; exfiltration
        # (head above stage) stays active
        return self._c * torch.where(dh > 0, f * dh, dh)

    def step(self, stage_old, head_old, delt, kstp=1, iss_gwf=False):
        """One coupled time step: Picard over the exchange flux.  Returns
        (stage, head, info): the pass count, each pass's solve counts
        (SWF outer, inner, GWF outer, inner) and largest change."""
        stage, head = stage_old, head_old
        base_flw = self.swf.flw
        counts, dmaxes = [], []
        for it in range(self.mxiter):
            # the SWF solve sees the leakage as a head-dependent term at
            # the pass's aquifer heads
            lkg = (self._sn, head[self._gn], self._c)
            stage_new, sinfo, _ = self.swf_sol.solve_timestep(
                stage_old, delt, kstp=kstp, iss=False,
                pkgs=SwfPackageData(flw=base_flw, lkg=lkg))
            q = self.leakage(stage_new, head)
            rates = q if self._own_q is None else torch.cat([self._own_q, q])
            pkgs = dataclasses.replace(self.gwf.packages,
                                       wel=bnd.with_values(self._wel,
                                                           q=rates))
            head_new, ginfo, _ = self.gwf_sol.solve_timestep(
                head_old, delt, kstp=kstp, iss=iss_gwf, pkgs=pkgs)
            counts.append((sinfo.outer_iterations, sinfo.inner_iterations,
                           ginfo.outer_iterations, ginfo.inner_iterations))
            dmax = float(torch.maximum((stage_new - stage).abs().max(),
                                       (head_new - head).abs().max()))
            dmaxes.append(dmax)
            stage, head = stage_new, head_new
            if sinfo.converged and ginfo.converged and dmax <= self.dvclose:
                return stage, head, dict(converged=True, exg_iters=it + 1,
                                         q=q, counts=counts, dmax=dmaxes)
        return stage, head, dict(converged=False, exg_iters=self.mxiter,
                                 q=self.leakage(stage, head), counts=counts,
                                 dmax=dmaxes)
