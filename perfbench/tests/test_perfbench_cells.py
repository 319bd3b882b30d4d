"""Each cell at a small grid on the CPU, to the last line's keys, held
against the reference; the control and the planted faults fail it."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import run
from perfbench.control import with_mixed
from perfbench.tests.helpers import run_small, small

WORKLOADS = [w["name"] for w in run.Bench().spec["workloads"]]
ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_and_agrees(workload, trace):
    res = run_small(workload, trace=trace)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    names = {m["name"] for m in run.Bench().metrics(workload, trace)}
    # the CPU has no device trace: those metrics are left out, never 0
    got = set(res["metrics"])
    assert got <= names
    if not trace:
        assert got == names
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails(workload):
    """The program's mixed-precision path in the place of f64."""
    res = run_small(workload, bench=with_mixed(run.Bench()),
                    shape=(1, 32, 32))
    assert not res["correct"], res["compared"]


def _unchanged(cell):
    """Each step returns the state it was given."""
    for member in cell.members:
        sol = member.sim.solution

        def same(x_old, *args, _solve=sol.solve_timestep, **kwargs):
            x, info, aux = _solve(x_old, *args, **kwargs)
            return x_old, info, aux
        sol.solve_timestep = same


def _altered(cell):
    """One value of each step's answer altered where it is produced."""
    for member in cell.members:
        sol = member.sim.solution

        def altered(*args, _solve=sol.solve_timestep, **kwargs):
            x, info, aux = _solve(*args, **kwargs)
            x = x.clone()
            x[x.numel() // 3] += 1e-4
            return x, info, aux
        sol.solve_timestep = altered


def _bad_start(cell):
    """The heads that set-up's steady solve hands to the window, with one
    value altered, in one member of the ensemble."""
    member = cell.members[-1]
    head = member.start_head.clone()
    head[head.numel() // 3] += 1e-2
    member.start_head = head
    member.start_check = (member.start_check[0], head.cpu().numpy())


@pytest.mark.parametrize("fault", [_unchanged, _altered, _bad_start])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_fails(workload, fault):
    res = run_small(workload, wrap_cell=fault)
    assert not res["correct"], res["compared"]


def test_no_card_no_result(tmp_path):
    """Without CUDA the command exits non-zero and prints no result."""
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench", "--workload", WORKLOADS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert "correct" not in proc.stdout


def test_without_the_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and perfbench/, the command
    fails and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench", "--workload", WORKLOADS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "correct" not in proc.stdout


def test_inputs_follow_the_seed():
    from perfbench.inputs import flow_inputs
    cfg = small(run.Bench().config("gwf-npf01b-1x2048x2048"), 1, 8, 8)
    cpu = torch.device("cpu")
    a = flow_inputs(cfg, 2**31 + 5, cpu).k
    b = flow_inputs(cfg, 2**31 + 5, cpu).k
    c = flow_inputs(cfg, 2**31 + 6, cpu).k
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("seed", [2**31 + 21, 2**33 + 5])
def test_work_is_the_same_for_every_seed(seed):
    """Every seed replays the same ensemble in whole passes: the same mean
    iterations a step; the seed draws the order and the checked sample."""
    ref = run_small(WORKLOADS[0], seed=2**31 + 77)
    res = run_small(WORKLOADS[0], seed=seed)
    n = len(run.Bench().traffic(run.Bench().workload(WORKLOADS[0])
                                ["traffic"])["ensemble"])
    assert n >= 2
    for r in (ref, res):
        assert len(r["work"]["replay_s"]) % n == 0
    assert res["work"]["inner"] == ref["work"]["inner"]
    assert res["work"]["outer"] == ref["work"]["outer"]


def test_schedule_is_the_sources():
    """Steady 1 d, ten steps over 1000 d growing by 1.5, steady 1 d."""
    from perfbench.inputs import schedule
    cfg = run.Bench().config("gwf-npf01b-1x2048x2048")
    steps = schedule(cfg["tdis"], cfg["steady"])
    assert len(steps) == 12
    assert steps[0] == (1, 1, 1.0, True) and steps[-1] == (3, 1, 1.0, True)
    dt0 = 1000.0 * 0.5 / (1.5 ** 10 - 1.0)
    assert abs(steps[1][2] - dt0) < 1e-12 and steps[1][:2] == (2, 1)
    assert abs(sum(s[2] for s in steps[1:11]) - 1000.0) < 1e-9
    assert not any(s[3] for s in steps[1:11])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(workload, cuda_device):
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench", "--workload", workload,
         "--seed", str(2**31 + 11), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert np.isfinite(res["metrics"]["cell_steps_per_s"]["value"])
