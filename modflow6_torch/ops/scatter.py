"""Sums of values into positions that repeat, in a fixed order.

The reference adds per-entry terms to per-cell arrays with ``.at[idx].add``
whose indices repeat (several interbeds in one cell, several ghost-node
entries on one row, the XT3D cross terms that reach one column of a row
along two paths).  ``index_add_`` on CUDA would do that with atomics, in an
order that changes from run to run.  An ``AddPlan`` is built once from the
target indices: the values are split into rounds, the c-th round holding
the c-th occurrence (in source order) of each target, so every round
stores to distinct positions and the sum at each position is taken in
source order, the same on every run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def running_count(values) -> np.ndarray:
    """For each element, how many equal elements stand before it."""
    order = np.argsort(values, kind="stable")
    sorted_vals = values[order]
    idx = np.arange(values.size, dtype=np.int64)
    is_start = np.ones(values.size, bool)
    is_start[1:] = sorted_vals[1:] != sorted_vals[:-1]
    start = np.maximum.accumulate(np.where(is_start, idx, 0))
    rank = np.empty(values.size, np.int64)
    rank[order] = idx - start
    return rank


@dataclasses.dataclass(frozen=True)
class AddPlan:
    """``rounds``: [(target positions, source indices)] as int64 tensors;
    within a round the targets are distinct."""

    rounds: tuple
    size: int

    @staticmethod
    def build(targets, device, size, sources=None, rank=None) -> "AddPlan":
        """Plan of ``out[targets[i]] += values[sources[i]]`` for every i, in
        the order of i (``sources`` defaults to ``arange``).  ``rank``, when
        the caller knows it: for each i, how many earlier entries share its
        target.  The arrays may be numpy arrays or tensors."""
        def t(a):
            return torch.as_tensor(a, dtype=torch.int64, device=device) \
                .reshape(-1)

        targets = t(targets)
        sources = (torch.arange(targets.shape[0], device=targets.device)
                   if sources is None else t(sources))
        if rank is None:
            rank = running_count(targets.cpu().numpy())
        rank = t(rank)
        rounds = []
        for c in range(int(rank.max()) + 1 if rank.numel() else 0):
            sel = torch.nonzero(rank == c).squeeze(1)
            rounds.append((targets[sel], sources[sel]))
        return AddPlan(tuple(rounds), int(size))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for r in self.rounds
                   for t in r)

    def add(self, out, values):
        """``out`` plus the planned sums of ``values`` (a new tensor)."""
        return self.add_(out.clone(), values)

    def add_(self, out, values):
        """The planned sums of ``values`` added into ``out`` itself (a
        tensor, or a view of one, that the caller owns)."""
        for pos, src in self.rounds:
            out[pos] += values[src]
        return out

    def sum(self, values):
        """The planned sums of ``values`` into zeros of ``size``."""
        return self.add(torch.zeros(self.size, dtype=values.dtype,
                                    device=values.device), values)
