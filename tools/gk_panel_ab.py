#!/usr/bin/env python3
"""Time the GK panel kernel against the chain of PyTorch operations it
replaces, on one card.

    python3 tools/gk_panel_ab.py [--out FILE] [--reps 10] [--rounds 2]

At each panel of PANELS (m rows of nl indices by n columns of nr, GK order
K; the first is the main path's 1024 x 1024 at N = 10, GK15) it times, with
CUDA events around the replay of a CUDA graph of `reps` calls
(``utils.device.graph_ms``), in the order kernel, chain, chain, kernel for
each round:

- ``kernel``: ``ops/gk_panel.gk_points_kernel``, one launch writing X and W;
- ``chain``: ``gk_points_plain`` on the card, the operations integrate's
  sampling ran before the kernel (the (m n, N) int64 index matrix by two
  broadcast copies, two gathers of the tables and the N - 1 multiplies of
  the weight columns);

and the same two with the benchmark's 10-D integrand on top (``panel``:
W · f(X) · 15^N, as the engine samples a Π panel). Both sides must agree
bit for bit. The byte bound: the index sets and the tables read once, X and
W written once, over 3.35 TB/s. The card's name and power limit go beside
the numbers; the table goes to stdout and, with --out, as JSON to FILE.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# (m, nl, n, nr, K)
PANELS = ((1024, 5, 1024, 5, 15), (1024, 1, 1024, 9, 15),
          (512, 5, 512, 5, 15), (64, 9, 15, 1, 15))
HBM_BYTES_PER_S = 3.35e12


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def bound_ms(m, nl, n, nr, K) -> float:
    N = nl + nr
    nbytes = 8 * (m * nl + n * nr + 2 * N * K + m * n * (N + 1))
    return nbytes / HBM_BYTES_PER_S * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tci_tpu_torch.ops import gk_panel
    from tci_tpu_torch.ops.kronrod import kronrod
    from tci_tpu_torch.utils.device import graph_ms

    if not torch.cuda.is_available():
        print("gk_panel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    omega = torch.tensor(10.0, dtype=torch.float64, device=dev)

    def f(X):
        return 1000.0 * torch.cos(omega * (X ** 2).sum(dim=1)) * torch.exp(
            -X.sum(dim=1) ** 4 / 1000.0)

    rows_out = []
    for m, nl, n, nr, K in PANELS:
        N = nl + nr
        x1, w1, _ = kronrod(K // 2)
        nodes = torch.from_numpy(np.tile(x1, (N, 1))).to(dev)
        weights = torch.from_numpy(np.tile(w1, (N, 1))).to(dev)
        rng = np.random.default_rng(m + n + nl)
        # prefixes of wider buffers, as the engine hands its sets over
        rows = torch.from_numpy(rng.integers(0, K, size=(m, N))).to(dev)
        cols = torch.from_numpy(rng.integers(0, K, size=(n, N))).to(dev)
        rows, cols = rows[:, :nl], cols[:, N - nr:]
        norm = float(K) ** N
        fns = {
            "kernel": lambda: gk_panel.gk_points_kernel(rows, cols, nodes,
                                                        weights),
            "chain": lambda: gk_panel.gk_points_plain(rows, cols, nodes,
                                                      weights),
        }
        for side in ("kernel", "chain"):
            fns[f"panel_{side}"] = (
                lambda g=fns[side]: (lambda X, W: W * f(X) * norm)(*g()))
        Xk, Wk = fns["kernel"]()
        Xp, Wp = fns["chain"]()
        same = bool(torch.equal(Xk, Xp) and torch.equal(Wk, Wp)
                    and torch.equal(fns["panel_kernel"](),
                                    fns["panel_chain"]()))
        del Xk, Wk, Xp, Wp
        times = {k: [] for k in fns}
        for _ in range(args.rounds):
            for kind in ("", "panel_"):
                for side in ("kernel", "chain", "chain", "kernel"):
                    times[kind + side].append(
                        graph_ms(fns[kind + side], args.reps))
        torch.cuda.empty_cache()
        b = bound_ms(m, nl, n, nr, K)
        row = {"m": m, "nl": nl, "n": n, "nr": nr, "K": K, "bitwise": same,
               "bound_ms": b, "ms": times,
               "kernel_over_bound": min(times["kernel"]) / b}
        rows_out.append(row)
        print(f"[gk_panel] {m}x{n} nl={nl} nr={nr} K={K}: kernel "
              f"{' / '.join(f'{t:.5f}' for t in times['kernel'])} ms, chain "
              f"{' / '.join(f'{t:.5f}' for t in times['chain'])} ms; with f: "
              f"{' / '.join(f'{t:.5f}' for t in times['panel_kernel'])} "
              f"against "
              f"{' / '.join(f'{t:.5f}' for t in times['panel_chain'])} ms; "
              f"bound {b:.5f} ms; bitwise {same}", flush=True)
    out = {"card": card(), "reps": args.reps, "panels": rows_out}
    print(f"[gk_panel] card: {out['card']}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0 if all(r["bitwise"] for r in rows_out) else 1


if __name__ == "__main__":
    sys.exit(main())
