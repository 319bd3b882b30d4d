"""What a traced run reads besides the step records: synchronised spans
wrapped around the program's calls from outside (each metric reader
declares the spans it reads), and a ``torch.profiler`` trace of a stretch
of whole steps.

Spans wait for the device on both sides, so a traced run is slower than
an untraced one; the end-to-end metrics come from untraced runs only.
"""

from __future__ import annotations

import bisect
import collections
import importlib
import time

import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Seconds (and Krylov iterations) of each call to the wrapped
    functions, by name."""

    def __init__(self, device):
        self.device = device
        self.calls = collections.defaultdict(list)   # name -> [(s, iters)]
        self._undo = []

    def install(self, declared):
        """Wrap each function that ``declared`` names ({span name:
        (module, attribute)}, as a metric reader's ``SPANS`` gives it)."""
        for name, (module, attr) in declared.items():
            self.wrap(importlib.import_module(module), attr, name)

    def wrap(self, owner, attr, name):
        """Replace ``owner.attr`` by a timed wrapper until ``remove``."""
        fn = getattr(owner, attr)
        had_own = attr in getattr(owner, "__dict__", {})

        def timed(*args, **kwargs):
            _sync(self.device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(self.device)
            self.calls[name].append((time.perf_counter() - t0,
                                     getattr(out, "iters", 0)))
            return out

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn if had_own else None))

    def remove(self):
        for owner, attr, fn in reversed(self._undo):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        self._undo = []


def profile(run, device, with_host=False):
    """Run ``run()`` under ``torch.profiler`` and reduce its trace: the
    stretch's host seconds, the device's busy seconds (the union of its
    kernels, copies and fills), the device time and count of each kernel
    by name, and the idle time between device operations by what the host
    was doing in the middle of each gap (its innermost operation).  Only
    with ``with_host`` does the profiler record the host's operations, which
    slows the host and so lengthens the gaps: the busy share is read from
    a stretch without it."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    _sync(device)
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if with_host or not acts:
        acts.append(ProfilerActivity.CPU)
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        _sync(device)
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((start, start + dur, e.name()))
        elif dur > 0:
            host.append((start, start + dur, e.name()))
    dev.sort()
    host.sort()
    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    busy_ns = 0
    gaps = []
    end = None
    for s, e, name in dev:
        by_kernel[name][0] += (e - s) * 1e-9
        by_kernel[name][1] += 1
        if end is None:
            busy_ns += e - s
            end = e
        elif s > end:
            gaps.append((end, s))
            busy_ns += e - s
            end = e
        elif e > end:
            busy_ns += e - end
            end = e
    starts = [h[0] for h in host]
    idle = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "host python"
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name] += (g1 - g0) * 1e-9
    return dict(window_s=window_s, busy_s=busy_ns * 1e-9,
                kernels={k: tuple(v) for k, v in by_kernel.items()},
                idle=dict(idle))
