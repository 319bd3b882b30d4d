"""Halo-exchange cost of the general partition (port of the repository's
``tools/halo_study.py``).

Measures, at bench-class scale:
  1. structural traffic: the halo shift rounds' slots per shard against
     the all-pairs volume of the partition's ``send_idx`` table;
  2. wall-clock: the sharded general-path solve against the single-device
     solve of the same model (same settings), per step and per inner
     iteration, over 3 repeats after a first solve.

Usage: python -m modflow6_torch.tools.halo_study [--nlay 4] [--nrow 512]
           [--ncol 512] [--shards 8] [--device cuda|cpu]

The shards go round-robin over the machine's CUDA devices (all on one card
where it has one), or all on ``--device``.  Prints the structure, the two
timings and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

from ..bench import device_name, flagship, synchronize
from ..entry import shard_devices
from ..parallel.general import GeneralShardedSolution, partition_general
from ..solution import ImsSettings, NumericalSolution

SETTINGS = dict(outer_dvclose=1e-5, outer_maximum=8, inner_dvclose=1e-7,
                inner_rclose=1e-5, inner_maximum=150, precision="mixed")
REPEATS = 3


def halo_structure(part):
    """The halo traffic of a ``GeneralPartition``: the shift rounds, the
    slots each round sends per shard, their total, and the slots per shard
    of the all-pairs exchange over ``send_idx`` ([P, P, S])."""
    P = part.nshards
    shift_slots = [int(s.shape[1]) for s in part.halo_send]
    S_pair = int(part.send_idx.shape[2])
    return dict(shifts=len(shift_slots), shift_slots=shift_slots,
                slots_ppermute=sum(shift_slots),
                slots_allpairs=(P - 1) * S_pair, S_pair=S_pair)


def _timed(solve, device):
    """Seconds per call of ``solve`` over REPEATS calls, and the last
    call's result."""
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        out = solve()
    synchronize(device)
    return (time.perf_counter() - t0) / REPEATS, out


def main(argv=None):
    """Prints the study; returns its JSON line's fields."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nlay", type=int, default=4)
    ap.add_argument("--nrow", type=int, default=512)
    ap.add_argument("--ncol", type=int, default=512)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="put every shard on this device (default: the "
                    "CUDA devices, round-robin)")
    args = ap.parse_args(argv)
    devices = shard_devices(args.shards, args.device)
    model = flagship(args.nlay, args.nrow, args.ncol, devices[0])
    N = model.nodes
    P = args.shards
    settings = ImsSettings(**SETTINGS)

    t0 = time.perf_counter()
    part = partition_general(model, P)
    t_part = time.perf_counter() - t0
    st = halo_structure(part)
    total = st["slots_ppermute"]
    print(f"partition: N={N} shards={P} n_local={part.n_local} "
          f"({t_part:.1f}s) devices={[str(d) for d in devices]} "
          f"({device_name(devices[0])})")
    print(f"halo shifts: {st['shifts']} rounds, per-shift slots "
          f"{st['shift_slots']}, total per-exchange slots/shard {total}")
    print(f"all-pairs volume: {P - 1} destinations x {st['S_pair']} slots = "
          f"{st['slots_allpairs']} slots/shard "
          f"({st['slots_allpairs'] / max(total, 1):.1f}x the shifts)")

    # ---- sharded timing
    gsol = GeneralShardedSolution(part, settings, devices=devices)
    hs = gsol.scatter_heads(model.strt)

    def sharded():
        return gsol.solve_timestep(hs, delt=1.0, kstp=1, iss=False)

    sharded()
    dt_sh, (_, info) = _timed(sharded, devices[0])
    it_sh = max(info["inner"], 1)
    print(f"sharded:   {dt_sh:.3f} s/step, {info} -> "
          f"{N * it_sh / dt_sh:.3e} cell-iter/s")

    # ---- single-device timing
    sol = NumericalSolution(model, settings)

    def single():
        return sol.solve_timestep(model.strt, 1.0, kstp=1, iss=False)

    single()
    dt_1, (_, sinfo, _) = _timed(single, devices[0])
    it_1 = max(sinfo.inner_iterations, 1)
    print(f"single:    {dt_1:.3f} s/step, inner={it_1} -> "
          f"{N * it_1 / dt_1:.3e} cell-iter/s")
    out = dict(
        N=N, shards=P, shifts=st["shifts"],
        slots_ppermute=total, slots_allpairs=st["slots_allpairs"],
        sharded_s_per_step=dt_sh, sharded_inner=it_sh,
        single_s_per_step=dt_1, single_inner=it_1,
        sharded_cell_iter_s=N * it_sh / dt_sh,
        single_cell_iter_s=N * it_1 / dt_1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
