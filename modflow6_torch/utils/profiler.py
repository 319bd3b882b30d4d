"""Tracing of the flow step, and the hierarchical wall-time profiler.

Port of modflow6_tpu/utils/profiler.py (behavioural parity target:
ProfilerType, reference src/Utilities/Performance/Profiler.f90:14-66):
named nested sections with stable handles, a SUMMARY/DETAIL report
printed as an indented tree plus the top-3 hotspots.  CUDA work runs
asynchronously, so ``section(..., block_on=tensors)`` synchronizes the
device those tensors live on before it stops the clock (nothing on the
CPU): a section's seconds are then the card's, not the time it took to
queue the launches.

The port's code records what a step does, always, at a cost of a few
host clock reads:

- **Spans** (``span``): a name, start and end on the host clock
  (``time.perf_counter_ns``) and the enclosing span.  A span does not
  synchronize, so it is host time: the time to issue the work, plus any
  wait for the device inside it.  A ``krylov`` span also carries its
  iterations and the host's wait on the loop's exit flags (``exit_flag``).
- **Counters**: ``host_syncs``, every blocking device-to-host read
  (``host_read``) and explicit synchronisation (``synchronize``), of
  which ``explicit_syncs`` are the latter; ``launches``, the launches of
  the port's own kernels by name; and named counts (``count``): the
  levels of each multigrid hierarchy built (``mg_levels``, over
  ``mg_builds``) and the transport's inner iterations
  (``transport_inner``).
- ``take()`` hands over the spans closed since the last call and the
  counters' growth since then.  ``Simulation.do_step`` calls it once as
  a step starts, discarding what ran before (a solve outside any step,
  the set-up), and once as it ends, putting what it gets on the step's
  ``StepRecord``; so a record holds its own step's work alone, and
  nothing is kept beyond the current step.  At most ``MAX_SPANS`` closed
  spans wait for a ``take``.
- While a ``torch.profiler`` records, each span is also a host range
  named ``mf6::<name>``, and each Krylov iteration one ``mf6::krylov_iter``
  range (``iteration_ranges``), so the profiler's trace shares the spans'
  names.  Outside a profiler no range is entered.

``Profiler.add`` folds a step's spans into the listing's tree; a
``Profiler.section`` is a span folded in as it closes.
"""

from __future__ import annotations

import collections
import functools
import itertools
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

# closed spans kept until the next ``take``
MAX_SPANS = 1 << 16


@dataclass(slots=True)
class Span:
    id: int
    name: str
    parent: int | None       # id of the enclosing span
    start_ns: int
    end_ns: int = 0
    iters: int = 0           # Krylov iterations of a ``krylov`` span
    wait_ns: int = 0         # host blocked on its exit-flag reads
    reads: int = 0           # its exit-flag reads

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Counts:
    host_syncs = 0
    explicit_syncs = 0


_ids = itertools.count()
_open: list = []
_closed: collections.deque = collections.deque(maxlen=MAX_SPANS)
launches: collections.Counter = collections.Counter()
counts: collections.Counter = collections.Counter()
_taken = (0, 0, collections.Counter(), collections.Counter())


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


def _range(name):
    """A host range named ``name`` in a ``torch.profiler`` trace.  The
    ranges of ``torch.profiler.record_function`` are user annotations, which
    a trace with CUDA activity also lays over the device's timeline, where
    they cover its idle gaps; this one is a plain host operation."""
    return torch._C._profiler._RecordFunctionFast(name)


@contextmanager
def span(name: str):
    """Record the enclosed work as a span named ``name``."""
    sp = Span(next(_ids), name, _open[-1].id if _open else None,
              time.perf_counter_ns())
    rng = None
    if _profiling():
        rng = _range("mf6::" + name)
        rng.__enter__()
    _open.append(sp)
    try:
        yield sp
    finally:
        _open.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
        sp.end_ns = time.perf_counter_ns()
        _closed.append(sp)


def krylov_solve(solver):
    """Run the Krylov solver ``solver`` in a ``krylov`` span that carries
    its iterations.  The span opens inside the solver's call, so a wrapper
    around the call stays outside it; a solve inside another (the passes of
    ``refined_solve``) belongs to the enclosing span."""
    @functools.wraps(solver)
    def solve(*args, **kwargs):
        if _open and _open[-1].name == "krylov":
            return solver(*args, **kwargs)
        with span("krylov") as sp:
            res = solver(*args, **kwargs)
            sp.iters = res.iters
        return res
    return solve


def host_read(t, how=torch.Tensor.cpu):
    """``how(t)``, a read of the device tensor ``t`` on the host, counted
    in ``host_syncs``; ``how`` is the read (``bool``, ``Tensor.tolist``, a
    boolean mask's selection, ...), ``t.cpu()`` by default."""
    _Counts.host_syncs += 1
    return how(t)


def exit_flag(flag) -> bool:
    """``bool(flag)``: a Krylov loop's exit-flag read, through
    ``host_read``.  The host's wait goes to the enclosing ``krylov``
    span."""
    t0 = time.perf_counter_ns()
    done = host_read(flag, bool)
    if _open and _open[-1].name == "krylov":
        sp = _open[-1]
        sp.wait_ns += time.perf_counter_ns() - t0
        sp.reads += 1
    return done


class _Ranges:
    """One range per iteration, between ``begin`` and ``end``."""

    def __init__(self, name):
        self.name, self.rng = name, None

    def begin(self):
        self.rng = _range(self.name)
        self.rng.__enter__()

    def end(self):
        self.rng.__exit__(None, None, None)


def iteration_ranges():
    """``mf6::krylov_iter`` ranges for a Krylov loop's iterations while a
    ``torch.profiler`` records, else None."""
    return _Ranges("mf6::krylov_iter") if _profiling() else None


def count(name: str, n: int = 1):
    """Add ``n`` to the named count ``name``."""
    counts[name] += n


def take():
    """(spans, counters): the spans closed since the last call, in the
    order they opened, and the counters' growth since then
    (``host_syncs``, ``explicit_syncs``, ``launches`` by kernel, and each
    named count that grew, under its name)."""
    global _taken
    spans = sorted(_closed, key=lambda s: s.id)
    _closed.clear()
    syncs, explicit, seen, counted = _taken
    counters = dict(host_syncs=_Counts.host_syncs - syncs,
                    explicit_syncs=_Counts.explicit_syncs - explicit,
                    launches=dict(launches - seen), **(counts - counted))
    _taken = (_Counts.host_syncs, _Counts.explicit_syncs, launches.copy(),
              counts.copy())
    return spans, counters


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
    ``obj`` lives on; counted in ``host_syncs`` and ``explicit_syncs``."""
    _Counts.host_syncs += 1
    _Counts.explicit_syncs += 1
    for dev in _devices(obj, set()):
        torch.cuda.synchronize(dev)


class Profiler:
    """Nested named sections; the thread of execution defines the
    hierarchy."""

    def __init__(self):
        self.root = _Section("run")
        self._stack = [self.root]

    @staticmethod
    def _child(parent, title):
        node = parent.children.get(title)
        if node is None:
            node = parent.children[title] = _Section(title)
        return node

    @contextmanager
    def section(self, title: str, block_on=None):
        """Time the enclosed work as a span named ``title``, folded into
        the tree under the current section when it closes (``add``).
        ``block_on``: tensors whose devices are synchronized before the
        span closes, so that its seconds are the device's."""
        self._stack.append(self._child(self._stack[-1], title))
        try:
            with span(title) as sp:
                yield sp
                if block_on is not None:
                    synchronize(block_on)
        finally:
            self._stack.pop()
            self.add([sp])

    def start(self, title: str):
        """Imperative start/stop pair (the reference's handle-based API)."""
        cm = self.section(title)
        cm.__enter__()
        return cm

    @staticmethod
    def stop(handle):
        handle.__exit__(None, None, None)

    def add(self, spans):
        """Fold ``spans`` (as ``take`` orders them) into the tree: each
        under its enclosing span's section, or under the current section
        where that span is not among them."""
        at = {}
        for sp in spans:
            node = self._child(at.get(sp.parent, self._stack[-1]), sp.name)
            node.total += sp.seconds
            node.count += 1
            at[sp.id] = node

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
