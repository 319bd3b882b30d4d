"""Volumetric budget accounting (per-step rates and cumulative volumes).

A numpy copy of modflow6_tpu/utils/budget.py (reference BudgetType
volumetric tables with IN/OUT columns and percent discrepancy,
src/Utilities/Budget.f90:83-142,178-311).  ``add_rates`` takes a term's
IN and OUT sums as they were reduced elsewhere (``Simulation`` sums
per-cell rates on the model's device); ``add_entries`` sums the
entries with numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BudgetTerm:
    name: str
    rate_in: float = 0.0
    rate_out: float = 0.0
    cum_in: float = 0.0
    cum_out: float = 0.0


class Budget:
    """Accumulates flow terms; rates are signed (positive = into the model)."""

    def __init__(self):
        self.terms: dict[str, BudgetTerm] = {}

    def add_rates(self, name, rate_in, rate_out, delt):
        """Set this step's IN and OUT rates of a term (both >= 0)."""
        t = self.terms.setdefault(name, BudgetTerm(name))
        # + 0.0 turns the -0.0 of an empty OUT sum into 0.0
        t.rate_in = float(rate_in) + 0.0
        t.rate_out = float(rate_out) + 0.0
        t.cum_in += t.rate_in * delt
        t.cum_out += t.rate_out * delt

    def add_entries(self, name, rates, delt):
        """rates: array of signed per-entry flows for this step."""
        rates = np.asarray(rates, np.float64).reshape(-1)
        self.add_rates(name, rates[rates > 0].sum(),
                       -rates[rates < 0].sum(), delt)

    @property
    def total_in(self):
        return sum(t.rate_in for t in self.terms.values())

    @property
    def total_out(self):
        return sum(t.rate_out for t in self.terms.values())

    def percent_discrepancy(self) -> float:
        tin, tout = self.total_in, self.total_out
        denom = 0.5 * (tin + tout)
        if denom == 0.0:
            return 0.0
        return 100.0 * (tin - tout) / denom

    def table(self, title="VOLUME BUDGET") -> str:
        lines = [title, "-" * len(title)]
        lines.append(f"{'TERM':<16}{'RATE IN':>16}{'RATE OUT':>16}"
                     f"{'CUM IN':>16}{'CUM OUT':>16}")
        for t in self.terms.values():
            lines.append(f"{t.name:<16}{t.rate_in:>16.6e}{t.rate_out:>16.6e}"
                         f"{t.cum_in:>16.6e}{t.cum_out:>16.6e}")
        lines.append(f"{'TOTAL':<16}{self.total_in:>16.6e}{self.total_out:>16.6e}")
        lines.append(f"PERCENT DISCREPANCY: {self.percent_discrepancy():>10.4f}")
        return "\n".join(lines)
