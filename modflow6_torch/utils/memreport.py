"""Memory usage report (reference mem_write_usage,
src/Utilities/Memory/MemoryManager.f90:31, the table printed at finalize).

Port of modflow6_tpu/utils/memreport.py: the reference tracks every
mem_allocate'd array by (name, path); here the inventory is the model's
tensor attributes and package data, summed by component.  A tensor counts
``numel() * element_size()`` bytes, a numpy array its ``nbytes``; every
object is counted once, by identity, where several components share it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the reference's components, in its order
COMPONENTS = ("dtopo", "npf_arrays", "sto_arrays", "condsat3", "strt",
              "ibound0", "chd", "wel", "rch", "drn", "riv", "ghb", "evt",
              "xt3d", "mst_arrays", "dsp")


def _nbytes(obj, seen):
    if obj is None or id(obj) in seen:
        return 0
    if isinstance(obj, torch.Tensor):
        seen.add(id(obj))
        return obj.numel() * obj.element_size()
    if isinstance(obj, np.ndarray):
        seen.add(id(obj))
        return int(obj.nbytes)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        seen.add(id(obj))
        return sum(_nbytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(x, seen) for x in obj)
    if isinstance(obj, dict):
        return sum(_nbytes(x, seen) for x in obj.values())
    return 0


def component_bytes(model) -> dict:
    """{COMPONENT: bytes} over the reference's components, the ones that
    hold no bytes left out."""
    seen = set()
    rows = {}
    for name in COMPONENTS:
        nb = _nbytes(getattr(model, name, None), seen)
        if nb:
            rows[name.upper()] = nb
    return rows


def memory_report(model) -> str:
    """Per-component memory table for a model (MEMORY USAGE role)."""
    rows = component_bytes(model)
    total = sum(rows.values())
    lines = ["", "MEMORY USAGE (model arrays)",
             f"{'COMPONENT':<16s} {'MBYTES':>12s}"]
    for name, nb in sorted(rows.items(), key=lambda r: -r[1]):
        lines.append(f"{name:<16s} {nb / 1e6:12.4f}")
    lines.append(f"{'TOTAL':<16s} {total / 1e6:12.4f}")
    return "\n".join(lines)
