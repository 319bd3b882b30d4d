"""Hierarchical wall-time profiler.

Port of modflow6_tpu/utils/profiler.py (behavioural parity target:
ProfilerType, reference src/Utilities/Performance/Profiler.f90:14-66):
named nested sections with stable handles, a SUMMARY/DETAIL report
printed as an indented tree plus the top-3 hotspots.  CUDA work runs
asynchronously, so ``section(..., block_on=tensors)`` synchronizes the
device those tensors live on before it stops the clock (nothing on the
CPU): a section's seconds are then the card's, not the time it took to
queue the launches.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class _Section:
    title: str
    total: float = 0.0
    count: int = 0
    children: dict = field(default_factory=dict)


def _devices(obj, out):
    """The CUDA devices of the tensors (or devices) in ``obj``, nested in
    tuples, lists or dicts, into the set ``out``."""
    if isinstance(obj, (torch.Tensor, torch.device)):
        dev = obj if isinstance(obj, torch.device) else obj.device
        if dev.type == "cuda":
            out.add(dev)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _devices(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _devices(x, out)
    return out


def synchronize(obj):
    """Wait for the work queued on every CUDA device that a tensor of
    ``obj`` lives on."""
    for dev in _devices(obj, set()):
        torch.cuda.synchronize(dev)


class Profiler:
    """Nested named sections; the thread of execution defines the
    hierarchy."""

    def __init__(self):
        self.root = _Section("run")
        self._stack = [self.root]

    @contextmanager
    def section(self, title: str, block_on=None):
        parent = self._stack[-1]
        node = parent.children.get(title)
        if node is None:
            node = parent.children[title] = _Section(title)
        self._stack.append(node)
        t0 = time.perf_counter()
        try:
            yield node
        finally:
            if block_on is not None:
                synchronize(block_on)
            node.total += time.perf_counter() - t0
            node.count += 1
            self._stack.pop()

    def start(self, title: str):
        """Imperative start/stop pair (the reference's handle-based API)."""
        cm = self.section(title)
        cm.__enter__()
        return cm

    @staticmethod
    def stop(handle):
        handle.__exit__(None, None, None)

    # ------------------------------------------------------------- report

    def _walk(self, node, depth=0):
        for child in node.children.values():
            yield depth, child
            yield from self._walk(child, depth + 1)

    def report(self, mode: str = "summary") -> str:
        """Indented tree of section timings + top-3 hotspots (Profiler.f90
        print at finalize); both modes list every section, as in the
        reference."""
        lines = ["Profiler timings (seconds):"]
        flat = []
        for depth, sec in self._walk(self.root):
            lines.append(f"  {'  ' * depth}{sec.title:<40.40s} "
                         f"{sec.total:12.6f}  (n={sec.count})")
            flat.append(sec)
        top = sorted(flat, key=lambda s: -s.total)[:3]
        lines.append("Top hotspots:")
        for s in top:
            lines.append(f"  {s.title:<40.40s} {s.total:12.6f}")
        return "\n".join(lines)


# module-level profiler mirroring the reference's global g_prof
g_prof = Profiler()
