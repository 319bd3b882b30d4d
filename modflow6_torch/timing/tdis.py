"""TDIS: time discretization — stress periods and time steps.

A numpy copy of modflow6_tpu/timing/tdis.py.

Behavioral parity target: src/Timing/tdis.f90 (tdis_set_counters:90,
tdis_set_timestep:152): ``nper`` stress periods, each with length
``perlen``, ``nstp`` steps and multiplier ``tsmult``; the first step is
perlen*(tsmult-1)/(tsmult**nstp - 1) and subsequent steps multiply.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StressPeriod:
    perlen: float
    nstp: int
    tsmult: float = 1.0

    def step_lengths(self) -> np.ndarray:
        if self.nstp < 1:
            raise ValueError("nstp must be >= 1")
        if self.tsmult == 1.0:
            return np.full(self.nstp, self.perlen / self.nstp)
        dt0 = self.perlen * (self.tsmult - 1.0) / (self.tsmult**self.nstp - 1.0)
        return dt0 * self.tsmult ** np.arange(self.nstp)


@dataclasses.dataclass(frozen=True)
class Tdis:
    periods: tuple
    time_units: str = "UNKNOWN"
    start_date_time: str = ""

    @property
    def nper(self) -> int:
        return len(self.periods)

    def total_time(self) -> float:
        return float(sum(p.perlen for p in self.periods))

    def walk(self):
        """Yield (kper, kstp, delt, pertim, totim) 1-based like the reference."""
        totim = 0.0
        for kper, p in enumerate(self.periods, start=1):
            pertim = 0.0
            for kstp, delt in enumerate(p.step_lengths(), start=1):
                pertim += delt
                totim += delt
                yield kper, kstp, float(delt), float(pertim), float(totim)
