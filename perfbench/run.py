"""The benchmark of ``modflow6_torch`` on one NVIDIA H100.

    python3 -m perfbench --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cells; each
cell's configuration, traffic, limits and metrics are files found by name:

- ``perfbench/configs/<file>``: the model's sizes (the file the cell's
  configuration entry names);
- ``perfbench/traffic/<traffic>.json``: the schedule, the solver settings
  and the ``driver`` (``perfbench/drivers/<driver>.py``) that runs them;
- ``perfbench/limits/<workload>.json``: the limit of each number that
  decides ``correct``;
- ``perfbench/metrics/<metric>.py``: a reader ``read(ctx)`` of each
  metric, which returns None where it finds nothing to read, and the
  synchronised spans it reads, ``SPANS = {name: (module, attribute)}``.

A run builds the models, warms up the cell's shapes, then replays the
traffic's schedule of steps for at least ``--seconds`` seconds of whole
passes (a pass is one replay of each of the driver's
``replays_per_pass`` members, in an order drawn from the seed).  ``--trace 0`` reports the cell's end-to-end metrics;
``--trace 1`` wraps the spans that the cell's per-layer readers declare
around the program's calls for the same window, then profiles a stretch
of whole steps, and reports the per-layer metrics.  Either way the
sampled outputs of the window are then compared with the plain reference
(``perfbench/reference``), and the last line of standard output is one
JSON object.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# top-level modules that a run of the port must not load
BANNED = ("jax", "jaxlib", "flax", "modflow6_tpu")


def process_age_s():
    """Seconds since this process started (from /proc where there is one,
    else since this module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()
# the process's age (seconds) at the steps of ``main`` before a run
MARKS = {}


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root=ROOT, files=HERE):
        self.spec = load_json(Path(root) / "BENCHMARK.json")
        self.root, self.files = Path(root), Path(files)

    def workload(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return load_json(self.files / "traffic" / f"{name}.json")

    def limits(self, workload):
        return load_json(self.files / "limits" / f"{workload}.json")

    def metrics(self, workload, trace):
        """The metric entries the cell reports with ``--trace 0`` (its
        end-to-end metrics) or ``--trace 1`` (its per-layer metrics)."""
        e2e = [m for m in self.spec["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        for m in self.spec["per_layer"]:
            if "workloads" not in m:
                raise SystemExit(f"per-layer metric {m['name']!r} lists no "
                                 "workloads in BENCHMARK.json")
        return [m for m in self.spec["per_layer"]
                if workload in m["workloads"]]

    def reader(self, metric):
        """The module of ``metric``'s reader: ``read(ctx)`` and, where it
        reads spans, ``SPANS``."""
        path = self.files / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench.metrics.{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def run_cell(bench, workload, seed, seconds, trace, device, config=None,
             wrap_cell=None):
    """One run of ``workload``; returns the result's dict.  ``config``
    replaces the configuration's file (the tests' small grids);
    ``wrap_cell(cell)`` may plant a fault in the built cell (the tests)."""
    import torch
    from . import probes
    from .inputs import ELEMENT_SIZE
    started = process_age_s()
    if device.type == "cuda":
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    cuda_init = process_age_s() - started
    w = bench.workload(workload)
    cfg = config if config is not None else bench.config(w["config"])
    traffic = bench.traffic(w["traffic"])
    readers = {m["name"]: (m, bench.reader(m["name"]))
               for m in bench.metrics(workload, trace)}
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    cell = driver.Cell(cfg, traffic, seed, device)
    cell.build()
    t_warm = time.perf_counter()
    cell.warm_up()
    if wrap_cell is not None:
        wrap_cell(cell)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # set-up: the process's age at main's steps and at this function's
    # start, then the seconds of each part after them
    parts = dict(**MARKS, run_cell_at=started, cuda_init=cuda_init,
                 **cell.parts, warm_up=time.perf_counter() - t_warm)
    setup_s = process_age_s()
    spans = probes.Spans(device)
    if trace:
        for _, mod in readers.values():
            spans.install(getattr(mod, "SPANS", {}))
    steps, replays = [], []
    per_pass = getattr(cell, "replays_per_pass", 1)
    t0 = t_prev = time.perf_counter()
    while True:
        cell.start_replay()
        t_replay = t_prev
        for i in range(len(cell.schedule)):
            ok, rec = cell.step(i)
            t = time.perf_counter()
            steps.append((t - t_prev, ok, rec))
            t_prev = t
        replays.append(t_prev - t_replay)
        if t_prev - t0 >= seconds and len(replays) % per_pass == 0:
            break
    window_s = t_prev - t0
    ctx = dict(workload=workload, n_cells=cell.n_cells,
               grid_shape=cell.grid_shape, setup_s=setup_s,
               window_s=window_s, steps=steps, spans=spans.calls,
               element_size=ELEMENT_SIZE[cfg["precision"]], profile=None)
    if trace:
        spans.remove()

        # the replay's steps [first, last), after its steps before them
        first, last = cell.traffic["profile_steps"]

        def before():
            cell.start_replay()
            for i in range(first):
                cell.step(i, keep=False)

        def stretch():
            for i in range(first, last):
                cell.step(i, keep=False)
        before()
        ctx["profile"] = probes.profile(stretch, device)
        before()
        ctx["host_profile"] = probes.profile(stretch, device,
                                             with_host=True)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    cell.free_program()
    values = {}
    for name, (m, mod) in readers.items():
        v = mod.read(ctx)
        if v is not None:
            values[name] = {"value": v, "unit": m["unit"]}
    t_check = time.perf_counter()
    compared = cell.check()
    check_s = time.perf_counter() - t_check
    limits = bench.limits(workload)
    correct = (set(compared) == set(limits) and len(steps) > 0
               and all(compared[k] <= limits[k] for k in limits))
    result = {
        "correct": bool(correct),
        "attempted": len(steps),
        "failed": sum(1 for _, ok, _ in steps if not ok),
        "metrics": values,
        "device": device_info(device, peak),
    }
    recs = [rec for _, _, rec in steps]
    # what the window did, for reading its spread: iterations per step,
    # the seconds of each replay, the first replay's steps (seconds,
    # outer, inner), and the parts of set-up
    result["work"] = {k: sum(getattr(r, k) for r in recs) / len(recs)
                      for k in ("outer", "inner")}
    result["work"]["replay_s"] = replays
    result["work"]["first_replay"] = [
        [wall, rec.outer, rec.inner]
        for wall, _, rec in steps[:len(cell.schedule)]]
    result["work"]["check_s"] = check_s
    result["setup_parts"] = parts
    if trace:
        prof = ctx["profile"]
        result["device"].update(busy_s=prof["busy_s"],
                                window_s=prof["window_s"])
        result["breakdown"] = breakdown(prof, ctx["host_profile"])
    result["compared"] = {k: {"value": v, "limit": limits.get(k)}
                          for k, v in compared.items()}
    return result


def device_info(device, peak):
    import torch
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def breakdown(prof, host_prof):
    """The ten device operations that took most time in the profiled
    stretch, and the idle time by what the host was doing, from the
    stretch profiled with the host's operations."""
    ops = sorted(((k, v[0]) for k, v in prof["kernels"].items()),
                 key=lambda kv: -kv[1])[:10]
    gaps = sorted(host_prof["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def main(argv=None):
    ap = argparse.ArgumentParser(description="modflow6_torch benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench()
    w = bench.workload(args.workload)
    import torch
    MARKS["torch_imported_at"] = process_age_s()
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    MARKS["devices_counted_at"] = process_age_s()
    if found < int(w["chips"]):
        print(f"perfbench: the cell needs {w['chips']} CUDA device(s); "
              f"{found} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), device)
    loaded = banned_modules()
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    print("set-up parts (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in result["setup_parts"].items()),
        file=sys.stderr)
    for k, c in result["compared"].items():
        print(f"compared {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
