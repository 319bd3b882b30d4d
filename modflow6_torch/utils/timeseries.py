"""Time series: STEPWISE / LINEAR / LINEAREND interpolation of stress data.

Port of modflow6_tpu/utils/timeseries.py (reference
src/Utilities/TimeSeries/TimeSeries.f90 and TimeArraySeries.f90): a named
series of (time, value) records with an interpolation method; the value
bound to a package entry for a time step is the series' time-average over
[t0, t1] (STEPWISE integrates the piecewise-constant function, LINEAR the
piecewise-linear one) or the value at the step end (LINEAREND), the
GetTimeSeriesValue/get_integrated_value semantics.

A ``TimeSeries`` is host numpy, as in the reference: its step value is
one scalar per binding.  A ``TimeArraySeries`` keeps its arrays as one
float64 tensor ``[nt, ncpl]`` on the model's device and forms a step's
array there, with the reference's operations in the reference's order,
so on the CPU its step values equal the reference's bit for bit.

``bind_series`` and ``bind_array_series`` register a step hook on a
``Simulation``: the setter receives the step's value before every solve
attempt and again before the step's package snapshot, so budgets and
outputs see the value the accepted solve used.  (The reference's
``bind_series`` wraps ``solve_step`` instead, so on its fixed-step path
the budget of a step sees the value of the step before.)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device

STEPWISE = 0
LINEAR = 1
LINEAREND = 2

_METHODS = {"stepwise": STEPWISE, "linear": LINEAR, "linearend": LINEAREND}


def _method(method):
    return _METHODS[method.lower()] if isinstance(method, str) else method


def _pieces(times, t0, t1):
    """The sub-intervals of [t0, t1] split at the knots inside it."""
    knots = times[(times > t0) & (times < t1)]
    pts = np.concatenate([[t0], knots, [t1]])
    return [(float(a), float(b)) for a, b in zip(pts[:-1], pts[1:])]


@dataclasses.dataclass(frozen=True)
class TimeSeries:
    name: str
    times: np.ndarray      # strictly increasing
    values: np.ndarray
    method: int = LINEAR

    @classmethod
    def create(cls, name, times, values, method="linear"):
        t = np.asarray(times, float)
        v = np.asarray(values, float)
        if np.any(np.diff(t) <= 0):
            raise ValueError("time series times must be increasing")
        return cls(name, t, v, _method(method))

    def value_at(self, t: float) -> float:
        """Pointwise value (clamped to the series range)."""
        t = min(max(t, self.times[0]), self.times[-1])
        if self.method == STEPWISE:
            i = np.searchsorted(self.times, t, "right") - 1
            return float(self.values[max(i, 0)])
        return float(np.interp(t, self.times, self.values))

    def step_value(self, t0: float, t1: float) -> float:
        """The value a package entry receives for the step [t0, t1]."""
        if self.method == LINEAREND:
            return self.value_at(t1)
        if t1 <= t0:
            return self.value_at(t1)
        return self._integral(t0, t1) / (t1 - t0)

    def _integral(self, t0: float, t1: float) -> float:
        """∫ value dt over [t0, t1] of the interpolated function."""
        total = 0.0
        for a, b in _pieces(self.times, t0, t1):
            if self.method == STEPWISE:
                total += self.value_at(a) * (b - a)
            else:
                total += 0.5 * (self.value_at(a) + self.value_at(b)) * (b - a)
        return total


@dataclasses.dataclass(frozen=True)
class TimeArraySeries:
    """TAS: a time series of whole arrays (utl-tas.dfn, reference
    TimeArraySeries.f90): the array bound to an array-package variable
    for a step is the time-average of the interpolated array over
    [t0, t1] (LINEAR) or of the piecewise-constant one (STEPWISE); SFAC
    scales the values.  ``arrays`` is f64[nt, ncpl] on one device."""

    name: str
    times: np.ndarray       # f64[nt], strictly increasing
    arrays: torch.Tensor    # f64[nt, ncpl]
    method: int = LINEAR
    sfac: float = 1.0

    @classmethod
    def create(cls, name, times, arrays, method="linear", sfac=1.0,
               device=None):
        """``arrays``: one array per time (any shape; kept flat).
        ``device=None`` is the CUDA device; pass ``"cpu"`` for the CPU."""
        t = np.asarray(times, float)
        a = np.asarray(arrays, np.float64)
        if np.any(np.diff(t) <= 0):
            raise ValueError("TAS times must be increasing")
        if a.shape[0] != t.shape[0]:
            raise ValueError("TAS needs one array per time")
        m = _method(method)
        if m == LINEAREND:
            raise ValueError("TAS supports LINEAR or STEPWISE")
        return cls(name, t, torch.as_tensor(
            a.reshape(t.shape[0], -1), dtype=torch.float64,
            device=resolve_device(device)), m, float(sfac))

    def value_at(self, t: float) -> torch.Tensor:
        t = min(max(t, self.times[0]), self.times[-1])
        if self.method == STEPWISE:
            i = max(np.searchsorted(self.times, t, "right") - 1, 0)
            return self.arrays[i] * self.sfac
        i = np.searchsorted(self.times, t, "right")
        i = min(max(i, 1), len(self.times) - 1)
        t0, t1 = self.times[i - 1], self.times[i]
        w = float((t - t0) / (t1 - t0))
        return ((1 - w) * self.arrays[i - 1] + w * self.arrays[i]) \
            * self.sfac

    def step_value(self, t0: float, t1: float) -> torch.Tensor:
        """Time-averaged array over the step (get_integrated_value)."""
        if t1 <= t0:
            return self.value_at(t1)
        total = torch.zeros_like(self.arrays[0])
        for a, b in _pieces(self.times, t0, t1):
            if self.method == STEPWISE:
                total = total + self.value_at(a) * (b - a)
            else:
                total = total + 0.5 * (self.value_at(a)
                                       + self.value_at(b)) * (b - a)
        return total / (t1 - t0)


def _last_totim(sim):
    """The end of the last accepted step (0 before the first)."""
    return sim.records[-1].totim if sim.records else 0.0


def bind_series(sim, ts: TimeSeries, setter):
    """Register per-step application of ``ts`` on a Simulation: before
    every solve attempt and before the step's package snapshot,
    ``setter(value)`` receives the series' value for the step (the
    TsManager ad role).  Returns the hook."""
    def hook(kper, kstp, delt):
        t0 = _last_totim(sim)
        setter(ts.step_value(t0, t0 + delt))

    sim.step_hooks.append(hook)
    return hook


def bind_array_series(sim, tas: TimeArraySeries, setter):
    """Per-step TAS application on a Simulation (TasManager ad role):
    ``setter(array)`` receives the step-averaged array (a tensor on the
    series' device) as ``bind_series`` describes.  Returns the hook."""
    def hook(kper, kstp, delt):
        t0 = _last_totim(sim)
        setter(tas.step_value(t0, t0 + delt))

    sim.step_hooks.append(hook)
    return hook


def load_tas(path, shape, base_dir=".", device=None):
    """Read a utl-tas TAS6 file → TimeArraySeries (ATTRIBUTES + one
    READARRAY per TIME block)."""
    from .mf6io.arrays import ArrayReader
    from .mf6io.reader import BlockFile

    bf = BlockFile(path)
    name, method, sfac = "tas", "linear", 1.0
    attrs = bf.get("ATTRIBUTES")
    if attrs is not None:
        for toks in attrs.lines:
            key = toks[0].upper()
            if key == "NAME":
                name = toks[1]
            elif key == "METHOD":
                method = toks[1].lower()
            elif key == "SFAC":
                sfac = float(toks[1])
    times, arrays = [], []
    n = int(np.prod(shape))
    for b in bf.get_all("TIME"):
        times.append(float(b.index))
        arr, _ = ArrayReader(base_dir).read(b.lines, 0, n)
        arrays.append(arr)
    return TimeArraySeries.create(name, times, arrays, method, sfac,
                                  device=device)


def load_ts6(path):
    """utl-ts TS6 file → {NAME: TimeSeries} (reference TimeSeries.f90 /
    utl-ts.dfn: ATTRIBUTES names/methods/sfacs + TIMESERIES rows)."""
    from .mf6io.reader import BlockFile

    bf = BlockFile(path)
    attrs = bf.get("ATTRIBUTES")
    names, methods, sfacs = [], [], []
    for toks in attrs.lines:
        kw = toks[0].upper()
        if kw in ("NAME", "NAMES"):
            names = list(toks[1:])
        elif kw in ("METHOD", "METHODS"):
            methods = [t.lower() for t in toks[1:]]
        elif kw in ("SFAC", "SFACS"):
            sfacs = [float(t) for t in toks[1:]]
    if not methods:
        methods = ["linear"]
    if len(methods) == 1:
        methods = methods * len(names)
    if not sfacs:
        sfacs = [1.0] * len(names)
    rows = [[float(v) for v in toks]
            for toks in bf.get("TIMESERIES").lines]
    arr = np.asarray(rows, float)
    return {nm.upper(): TimeSeries.create(nm, arr[:, 0],
                                          arr[:, i + 1] * sfacs[i],
                                          method=methods[i])
            for i, nm in enumerate(names)}
