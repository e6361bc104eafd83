#!/usr/bin/env python3
"""Time a TCI2 solve that reaches a high rank on the two device tiers that
can carry it, on one card: the whole-sweep engine up to its capacity limit,
and the engine capped at 256 so that the per-bond fused tier takes every
sweep past that rank.

    python3 tools/high_rank_ab.py [--nsites 20] [--maxbonddim 1000]
        [--solves 3] [--order engine,fused,fused,engine] [--out FILE]

The function is the benchmark's ``random_l20_d1000``: f(sigma) =
T[sum_i sigma_i 2^i], T drawn from default_rng(table_seed) uniform on
[-1, 1], at tolerance 1e-12 and the bond cap `maxbonddim`. Each entry of
`order` makes a new evaluator and runs `solves` solves on it (table seeds
0, 1, ...; start points from default_rng(seed)), the first of which
records the engine's graphs. For every solve it prints the host wall (to
``torch.cuda.synchronize()``), the iterations, ranks, the final link
dimensions, the engine's capacity, its captures, the bonds of the fused
tier, and the largest errors from the benchmark's reference at 1,024
nested pivot crosses (the benchmark's check) and at 1,024 grid points
(no low-rank truth there, so reported only); then the device's peak
memory. The card's name and
power limit go first; with --out the records go to FILE as JSON lines.
``--device cpu`` rehearses it at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nsites", type=int, default=20)
    ap.add_argument("--maxbonddim", type=int, default=1000)
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--order", default="engine,fused,fused,engine")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tcibench.core import load_module
    from tci_tpu_torch.models import tensorci2
    from tci_tpu_torch.ops import fused
    from tci_tpu_torch.parallel.batcheval import TorchBatchEvaluator

    ref = load_module(os.path.join(HERE, "tcibench", "reference",
                                   "random_l20_d1000.py"), "reference")
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    L, D = args.nsites, args.maxbonddim
    print(f"card: {card() if cuda else 'cpu'}", flush=True)
    records = []
    for run, tier in enumerate(args.order.split(",")):
        table = torch.zeros(2 ** L, dtype=torch.float64, device=device)
        place = 2 ** torch.arange(L, dtype=torch.int64, device=device)
        ev = TorchBatchEvaluator(lambda idx: table[(idx * place).sum(1)],
                                 [2] * L, device=device)
        engine = ev.device_sweep_engine
        if tier == "fused":
            engine.imax_cap = 256
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        for seed in range(args.solves):
            T = ref.table(seed, 2 ** L)
            table.copy_(torch.from_numpy(T))
            bonds0, cap0 = fused.FUSED_BONDS["bonds"], engine.captures
            if cuda:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            tci, ranks, errors = tensorci2.crossinterpolate2(
                np.float64, ev, [2] * L, tolerance=1e-12, maxbonddim=D,
                device=device, rng=np.random.default_rng(seed))
            if cuda:
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            cores = [c.detach().cpu().numpy() for c in tci.sitetensors()]
            Isets = [np.asarray(s, dtype=np.int64).reshape(len(s), b)
                     for b, s in enumerate(tci.Iset)]
            Jsets = [np.asarray(s, dtype=np.int64).reshape(len(s), L - b - 1)
                     for b, s in enumerate(tci.Jset)]
            rng = np.random.default_rng(seed)
            cross = ref.rel_err(cores, T, ref.crosses(Isets, Jsets, 1024,
                                                      rng), 2)
            grid = ref.grid_rel_err(cores, T, 1024, 2, rng)
            rec = {"run": run, "tier": tier, "seed": seed,
                   "wall_s": wall, "iterations": len(errors),
                   "ranks": ranks, "linkdims": tci.linkdims(),
                   "capacity": engine.Imax, "limit": engine.capacity_limit(),
                   "captures": engine.captures - cap0,
                   "fused_bonds": fused.FUSED_BONDS["bonds"] - bonds0,
                   "nglobalpivots": tci.stats["nglobalpivots"],
                   "pivot_cross_rel_err": cross, "grid_rel_err": grid}
            print(json.dumps(rec), flush=True)
            records.append(rec)
            del tci, cores
        if cuda:
            peak = torch.cuda.max_memory_allocated(device)
            print(json.dumps({"run": run, "tier": tier,
                              "memory_peak_bytes": peak}), flush=True)
            records.append({"run": run, "tier": tier,
                            "memory_peak_bytes": peak})
        del ev, engine, table
        if cuda:
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            for rec in records:
                fh.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
