"""Readings of the numbers that decide ``correct``, over many seeds in one
process: the program as the configuration states it, or its own
mixed-precision path (float32 Krylov solves with float64 refinement), the
control that has to come out not correct.

    python3 -m perfbench.control --workload <name> --seeds 1,2,3 \\
        [--mixed] [--seconds 1]

prints one JSON line per seed: the compared numbers and their limits.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def with_mixed(bench):
    """``bench`` with its traffic's flow solution in ``mixed``."""
    orig = bench.traffic

    def traffic(name):
        t = orig(name)
        t["flow_ims"]["precision"] = "mixed"
        return t
    bench.traffic = traffic
    return bench


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--mixed", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    bench = run.Bench()
    if args.mixed:
        with_mixed(bench)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.run_cell(bench, args.workload, seed, args.seconds, False,
                           device)
        print(json.dumps({"seed": seed, "mixed": args.mixed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "compared": res["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
