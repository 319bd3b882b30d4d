"""A cell is added by adding files and an entry, editing none: a
throwaway traffic file, its limits and a copy of BENCHMARK.json with one
more workload, in a temporary directory."""

import json
import shutil
from pathlib import Path

import torch

from perfbench import run
from perfbench.tests.helpers import small

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent


def test_cell_added_from_files(tmp_path):
    before = {p: p.read_bytes() for p in PKG.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({
        "name": "npf-jacobi-cold", "config": "gwf-npf01b-1x2048x2048",
        "traffic": "cold", "chips": 1,
        "why": "a throwaway cell: no warm-up step, three steps checked"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    files = tmp_path / "perfbench"
    shutil.copytree(PKG / "metrics", files / "metrics")
    (files / "traffic").mkdir()
    (files / "limits").mkdir()
    traffic = json.loads((PKG / "traffic" / "npf-jacobi-replay.json")
                         .read_text())
    traffic.update(warmup_steps=0, check_sample=3)
    (files / "traffic" / "cold.json").write_text(json.dumps(traffic))
    (files / "limits" / "npf-jacobi-cold.json").write_text(
        (PKG / "limits" / "npf-jacobi-replay.json").read_text())
    bench = run.Bench(root=ROOT, files=files)
    bench.spec = spec
    cfg = small(bench.config("gwf-npf01b-1x2048x2048"))
    res = run.run_cell(bench, "npf-jacobi-cold", 2**31 + 3, 0.1, False,
                       torch.device("cpu"), config=cfg)
    assert res["correct"], res["compared"]
    assert res["attempted"] % 11 == 0
    assert set(res["metrics"]) == {"cell_steps_per_s", "setup_s"}
    after = {p: p.read_bytes() for p in PKG.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before
