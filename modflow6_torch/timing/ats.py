"""ATS: adaptive time stepping.

A copy of modflow6_tpu/timing/ats.py.

Behavioral parity target: src/Timing/ats.f90 (ats_set_delt / ats_reset_delt
:44-104,60+) + the core time loop's failed-step retry loop
(mf6core.f90:620-693 Mf6DoTimestep retryloop + sim_step_retry): per-period
dt0/dtmin/dtmax bounds, growth by dtadj after well-converged steps, shrink
by dtadj when convergence was hard, shrink by dtfailadj and re-solve after
a failed step, truncation at the period end.

The adaptive loop is host-side control flow (``Simulation.run``); each
attempt is one more call of the same solve.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AtsPeriod:
    """Per-period ATS record (utl-ats.dfn perioddata)."""

    dt0: float         # initial step (0 → dtmin)
    dtmin: float
    dtmax: float
    dtadj: float = 2.0       # grow/shrink factor from convergence speed
    dtfailadj: float = 5.0   # shrink factor on failed step (0/1 → no retry)


def initial_delt(ats: AtsPeriod) -> float:
    return ats.dt0 if ats.dt0 > 0 else ats.dtmin


def next_delt(delt: float, ats: AtsPeriod, outer_iterations: int,
              outer_maximum: int) -> float:
    """Adjust delt from the last step's convergence effort
    (ats_submaximumtimestep semantics): fast convergence grows the step,
    struggling convergence shrinks it."""
    if ats.dtadj > 1.0:
        if outer_iterations <= max(outer_maximum // 3, 1):
            delt = delt * ats.dtadj
        elif outer_iterations >= max(2 * outer_maximum // 3, 2):
            delt = delt / ats.dtadj
    return clamp(delt, ats)


def fail_delt(delt: float, ats: AtsPeriod) -> float:
    """Shrink after a failed step (ats_reset_delt)."""
    if ats.dtfailadj > 1.0:
        delt = delt / ats.dtfailadj
    return max(delt, ats.dtmin)


def clamp(delt: float, ats: AtsPeriod) -> float:
    return min(max(delt, ats.dtmin), ats.dtmax)
