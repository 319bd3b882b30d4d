"""Convergence CSV diagnostics.

A copy of modflow6_tpu/utils/csvout.py.

Behavioral parity target: the OUTER_CSV / INNER_CSV exports of the
reference solution (NumericalSolution.f90:1334-1381 writeCSVHeader +
per-iteration rows): one row per outer iteration with the running
inner-iteration total and the max dependent-variable change.
"""

from __future__ import annotations

import csv


class OuterCsvWriter:
    """solver.outer.csv: one row per outer (Picard) iteration."""

    HEADER = ["total_inner_iterations", "totim", "kper", "kstp",
              "nouter", "dvmax"]

    def __init__(self, path):
        self._f = open(path, "w", newline="")
        self._w = csv.writer(self._f)
        self._w.writerow(self.HEADER)
        self._total_inner = 0

    def write_step(self, totim, kper, kstp, info):
        """Append the rows for one time step from a SolveInfo."""
        per_outer = (info.inner_iterations // max(info.outer_iterations, 1))
        for k, dv in enumerate(info.dvmax_history, start=1):
            self._total_inner += per_outer
            self._w.writerow([self._total_inner, totim, kper, kstp, k,
                              f"{dv:.6e}"])

    def close(self):
        self._f.close()
