"""Small versions of the benchmark's configuration for CPU tests."""

import json

import torch

from perfbench import run


def small(cfg, nlay=1, nrow=24, ncol=24):
    """``cfg`` on an nlay x nrow x ncol grid over the same extent, with its
    well placed by the source's rule."""
    cfg = json.loads(json.dumps(cfg))
    cfg.update(nlay=nlay, nrow=nrow, ncol=ncol)
    cfg["botm"] = [cfg["botm"] * (i + 1) / nlay for i in range(nlay)] \
        if nlay > 1 else cfg["botm"]
    cfg["wel"].update(row=(nrow - 1) // 2 + 1, col=(ncol - 1) // 2 + 1)
    return cfg


def run_small(workload, seed=2**31 + 77, trace=False, bench=None,
              shape=(1, 24, 24), **kw):
    bench = bench or run.Bench()
    w = bench.workload(workload)
    cfg = small(bench.config(w["config"]), *shape)
    return run.run_cell(bench, workload, seed, 0.2, trace,
                        torch.device("cpu"), config=cfg, **kw)
