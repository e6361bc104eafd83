#!/usr/bin/env python3
"""Paired wall-time comparison of two checkouts of tci_tpu_torch on config 1.

    python3 tools/config1_ab.py --parent DIR [--change DIR] [--pairs 10]
                                [--runs 10] [--out FILE] [--config {1,3,4}]
                                [--reuse-evaluator] [--no-fused]

Config 1 is BASELINE's 8-D Lorentzian on {0..9}^8 at tolerance 1e-8, run as
a user runs it: ``crossinterpolate2`` with a default ``TorchBatchEvaluator``
and ``rng=np.random.default_rng(0)``. ``--config 3`` runs BASELINE's quantics
TCI instead (cos(100 x) exp(-x) on a 2^40 grid, tolerance 1e-10), and
``--config 4`` its 10-D integral (``integrate(torch_native=True)``, GK15,
tolerance 1e-8, maxbonddim 64; its "errors" are the integral), both as
chip_smoke.py runs them; the parent must have the modules they need. Each
checkout runs in processes of its
own (the two packages share a name), in pairs whose order alternates:
parent then change, change then parent, and so on, so that a drift of the
host or the card falls on both sides alike. Each process builds its
checkout's kernel, runs config 1 once cold and then ``--runs`` times warm,
and reports the median warm wall; the change's processes also time the
fused tier (``enable_device_sweep=False``) in the same way, its runs
alternating with the default's, unless ``--no-fused`` is given (at config 4
the interleaved fused runs slow the default ones, which shows as a ratio
above 1 between two copies of one tree).

By default every run builds a new evaluator. With ``--reuse-evaluator`` a
process builds one evaluator a tier in its cold run and its warm runs reuse
it, so that an engine which keeps CUDA graphs only replays them (for config
4, ``integrate`` is given the same integrand every time and keeps the
evaluator itself; without the flag it gets a new function object a run). A
checkout that keeps nothing just runs as before.

Printed: one line a pair (both medians and their ratio), nvidia-smi's card
line, and a summary line: the median and range of the pair ratios, how many
pairs the change won, the two-sided sign-test p-value, and the quartiles of
each side's medians. Every run of both
sides must give the same ranks and errors within 1e-15 (config 4: the same
integral within 1e-6), or the script fails. ``--device cpu --dims 4,4,4,4,4`` rehearses it on a small problem.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fail(msg):
    print(f"config1_ab: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def worker(opts):
    """Runs in the checkout opts.worker: cold and warm walls of each tier,
    as one JSON line on stdout."""
    sys.path.insert(0, os.path.abspath(opts.worker))
    import numpy as np
    import torch

    import tci_tpu_torch

    pkg = os.path.dirname(os.path.abspath(tci_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(opts.worker):
        fail(f"imported tci_tpu_torch from {pkg}, not from {opts.worker}")
    dev = torch.device(opts.device)
    dims = [int(d) for d in opts.dims.split(",")]

    def fdev(idx):
        v = idx.to(torch.float64) + 1.0
        return 1.0 / (1.0 + (v * v).sum(dim=1))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    tol = 1e-8
    if opts.config == 3:
        dims, tol = [2] * 40, 1e-10
        qweights = torch.tensor([2.0 ** -(r + 1) for r in range(40)],
                                dtype=torch.float64, device=dev)

        def fdev(bits):
            x = (bits.to(torch.float64) * qweights).sum(dim=1)
            return torch.cos(100.0 * x) * torch.exp(-x)

    def f4(X):
        return 1000 * torch.cos(10 * (X ** 2).sum(dim=1)) * torch.exp(
            -X.sum(dim=1) ** 4 / 1000)

    kept = {}

    def solve(tier):
        kw = {"enable_device_sweep": False} if tier == "fused" else {}
        sync()
        t0 = time.perf_counter()
        if opts.config == 4:
            # a new function object is a new key of integrate's evaluator
            # cache, hence a new evaluator
            integrand = f4 if opts.reuse_evaluator else (lambda X: f4(X))
            val = tci_tpu_torch.integrate(
                np.float64, integrand, [-1.0] * 10, [1.0] * 10, GKorder=15,
                tolerance=1e-8, maxbonddim=64, torch_native=True,
                rng=np.random.default_rng(0), device=dev, **kw)
            ranks, errors = [], [val]
        else:
            f = kept.get(tier)
            if f is None:
                f = tci_tpu_torch.TorchBatchEvaluator(fdev, dims, device=dev,
                                                      **kw)
                if opts.reuse_evaluator:
                    kept[tier] = f
            _, ranks, errors = tci_tpu_torch.crossinterpolate2(
                np.float64, f, dims, tolerance=tol,
                rng=np.random.default_rng(0), device=dev)
        sync()
        return time.perf_counter() - t0, ranks, [float(e) for e in errors]

    tiers = opts.tiers.split(",")
    out = {}
    for tier in tiers:
        cold, ranks, errors = solve(tier)
        out[tier] = {"cold": cold, "warm": [], "ranks": ranks,
                     "errors": errors}
    for _ in range(opts.runs):
        for tier in tiers:
            wall, ranks, errors = solve(tier)
            if ranks != out[tier]["ranks"] or errors != out[tier]["errors"]:
                fail(f"{tier}: ranks {ranks} / errors {errors} changed "
                     f"between runs")
            out[tier]["warm"].append(wall)
    for tier in tiers:
        out[tier]["median"] = statistics.median(out[tier]["warm"])
    print(json.dumps(out), flush=True)


def run_side(opts, checkout, tiers):
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", checkout,
           "--runs", str(opts.runs), "--tiers", tiers, "--device",
           opts.device, "--dims", opts.dims, "--config", str(opts.config)]
    if opts.reuse_evaluator:
        cmd.append("--reuse-evaluator")
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=opts.side_timeout)
    if proc.returncode != 0:
        fail(f"{checkout}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def sign_test(wins, n):
    """Two-sided p-value of `wins` successes in n fair coin flips."""
    k = min(wins, n - wins)
    tail = sum(math.comb(n, i) for i in range(k + 1)) / 2 ** n
    return min(1.0, 2 * tail)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="checkout of the parent commit")
    parser.add_argument("--change", default=HERE,
                        help="checkout of the change (default: this one)")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--runs", type=int, default=10,
                        help="warm runs a process")
    parser.add_argument("--out", help="write all walls here as JSON")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dims", default=",".join(["10"] * 8))
    parser.add_argument("--config", type=int, choices=(1, 3, 4), default=1,
                        help="BASELINE config to run (default 1)")
    parser.add_argument("--reuse-evaluator", action="store_true",
                        help="warm runs reuse the cold run's evaluator")
    parser.add_argument("--no-fused", action="store_true",
                        help="do not time the change's fused tier")
    parser.add_argument("--side-timeout", type=float, default=300.0)
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    parser.add_argument("--tiers", default="default", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if opts.worker:
        return worker(opts)
    if not opts.parent:
        fail("--parent is required")
    if opts.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if smi.returncode != 0:
            fail(f"nvidia-smi failed: {smi.stderr.strip()}")
        card = smi.stdout.strip().splitlines()[0]
    else:
        card = "cpu"

    # config 4 compares integrals, which the tiers round differently
    atol = 1e-6 if opts.config == 4 else 1e-15
    pairs = []
    for i in range(opts.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        res = {}
        for side in order:
            res[side] = run_side(
                opts, opts.parent if side == "parent" else opts.change,
                "default" if side == "parent" or opts.no_fused
                else "default,fused")
        p, c = res["parent"]["default"], res["change"]["default"]
        for tier in res["change"]:
            t = res["change"][tier]
            if t["ranks"] != p["ranks"] or max(
                    abs(a - b) for a, b in zip(t["errors"], p["errors"])
            ) > atol or len(t["errors"]) != len(p["errors"]):
                fail(f"pair {i}: change {tier} gave ranks {t['ranks']}, "
                     f"errors {t['errors']}; parent {p['ranks']}, "
                     f"{p['errors']}")
        ratio = c["median"] / p["median"]
        pairs.append({"order": order, "parent": p, "change": c,
                      "fused": res["change"].get("fused"), "ratio": ratio})
        line = (f"[pair {i}] {order[0]} first: parent median "
                f"{p['median']:.4f} s (cold {p['cold']:.4f}), change "
                f"{c['median']:.4f} s (cold {c['cold']:.4f}), ratio "
                f"{ratio:.4f}")
        if not opts.no_fused:
            fused = res["change"]["fused"]["median"]
            line += (f"; change's fused tier {fused:.4f} s "
                     f"(ratio {fused / p['median']:.4f})")
        print(line, flush=True)

    def quartiles(side):
        """Quartiles (q1, median, q3) of one side's per-process medians."""
        meds = [q[side]["median"] for q in pairs]
        return (statistics.quantiles(meds, n=4) if len(meds) > 1
                else meds * 3)

    ratios = [q["ratio"] for q in pairs]
    wins = sum(r < 1.0 for r in ratios)
    summary = {
        "card": card, "pairs": len(pairs), "runs": opts.runs,
        "reuse_evaluator": opts.reuse_evaluator,
        "ratio_median": statistics.median(ratios),
        "ratio_min": min(ratios), "ratio_max": max(ratios),
        "change_wins": wins, "sign_test_p": sign_test(wins, len(ratios)),
        "parent_quartiles": quartiles("parent"),
        "change_quartiles": quartiles("change"),
    }
    if not opts.no_fused:
        fratios = [q["fused"]["median"] / q["parent"]["median"]
                   for q in pairs]
        summary.update({
            "fused_quartiles": quartiles("fused"),
            "fused_ratio_median": statistics.median(fratios),
            "fused_wins": sum(r < 1.0 for r in fratios)})
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w") as fh:
            json.dump({"summary": summary, "pairs": pairs}, fh, indent=1)
    print(card, flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
