#!/usr/bin/env python3
"""Time the rrLU kernel's grid mode of two trees on the same card.

    python3 tools/grid_ab.py --parent DIR [--out FILE]

DIR is an unpacked tree of another commit (``git archive <commit> | tar -x
-C DIR``, in a directory that .gitignore lists). For every panel of
``chip_smoke.GRID_PANELS`` (this tree's list), and for config 1's and
config 5's cluster-mode bond panels, the kernel of each tree is
timed in a process of its own, in the order parent, change, change, parent:
CUDA events around the replay of a CUDA graph of launches, the mode the
kernel reports, and k; the change's streamed panels also through its
builds that defer the write-back over 1, 2 and 4 pivots on every streamed
panel (DEFER_BUILDS). Both trees build their kernels from their own sources;
last, in each process, BASELINE config 4 under the default protocol on a
kept evaluator: the device busy time and wall of one replayed run. Then
the grid barrier alone, at the grid mode's launch shape: this
tree's (``lu_cuda.grid_barrier_ms``) and the parent's design
(``tools/grid_barrier_parent.cu``, built here with nvcc). The table goes to
stdout and, with --out, as JSON to FILE. Needs one CUDA device.

    python3 tools/grid_ab.py --time ROOT

runs one tree's timings and prints them as one JSON line (what the A/B
starts in each process).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_panels", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# builds of this tree's kernel for measurement (csrc/rrlu.cu's
# RRLU_GRID_DEFER): every streamed panel writes back every pass, every
# second, every fourth (the default build takes the depth from the panel's
# size against the L2, defer_depth)
DEFER_BUILDS = {f"depth {b}": (f"RRLU_GRID_DEFER={b}",) for b in (1, 2, 4)}


def graph_ms(call, reps):
    """Device time of one call(): CUDA events around the replay of a CUDA
    graph of `reps` calls, replayed once before."""
    import torch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            call()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / reps


def time_tree(root: str, variants: bool) -> dict:
    """Every GRID_PANELS entry through the rrLU kernel of the tree at
    `root`: {tag: {"ms", "mode", "k"}}; with `variants`, a streamed panel
    also through each of DEFER_BUILDS (whose result must equal the
    default build's)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from tci_tpu_torch.ops import lu_cuda
    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    out = {}
    default_lib = lu_cuda._lib
    # the grid panels, then two that must not move: config 1's and config
    # 5's bond panels (the cluster mode), as chip_smoke.py's [mode] rows
    # build them
    panels = [(spec, cs.grid_panel(spec, dev)) for spec in cs.GRID_PANELS]
    for tag, dtype, mp, m, n, k in (
            ("config 1 352^2 (cluster)", torch.float64, 352, 132, 132, 12),
            ("config 5 complex 512^2 (cluster)", torch.complex128, 512, 136,
             271, 19)):
        P = cs.main_panel(dtype, mp, m, n, 2 * k, mp, dev)
        panels.append(((tag,), (P, m, n, k, 1e-14, 0.0)))
    for spec, args in panels:
        res = lu_cuda.rrlu_call(*args, leftorthogonal=True, return_mode=True)
        mode, k = int(res[6]), int(res[3])
        reps = 3 if args[0].numel() * args[0].element_size() > (64 << 20) \
            else 10

        def call():
            lu_cuda.rrlu_call(*args, leftorthogonal=True)
        row = {"ms": graph_ms(call, reps),
               "mode": lu_cuda.PANEL_MODES[mode], "k": k}
        if variants and row["mode"] == "stream":
            for label, defines in DEFER_BUILDS.items():
                lib = default_lib(defines)
                lu_cuda._lib = lambda defines=(), lib=lib: lib
                try:
                    alt = lu_cuda.rrlu_call(*args, leftorthogonal=True)
                    if not all(torch.equal(a, r) or bool(
                            ((a == r) | (a.isnan() & r.isnan())).all())
                            for a, r in zip(alt, res[:6])):
                        sys.exit(f"grid_ab: the {label} build differs on "
                                 f"{spec[0]}")
                    row[label] = graph_ms(call, reps)
                finally:
                    lu_cuda._lib = default_lib
        out[spec[0]] = row
    out["config4 loop"] = config4_loop()
    return out


def config4_loop() -> dict:
    """BASELINE config 4 as chip_smoke.py's phase 4e runs it (the default
    protocol, the evaluator kept by integrand): the integral, and the
    device busy time (the union of the kernels, copies and memsets of a
    torch.profiler trace) and wall of one replayed run."""
    import tempfile
    import time

    import numpy as np
    import torch
    import tci_tpu_torch
    from torch.profiler import ProfilerActivity, profile

    def f4(X):
        return 1000 * torch.cos(10 * (X ** 2).sum(dim=1)) * torch.exp(
            -X.sum(dim=1) ** 4 / 1000)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = tci_tpu_torch.integrate(
            np.float64, f4, [-1.0] * 10, [1.0] * 10, GKorder=15,
            tolerance=1e-8, maxbonddim=64, pivotsearch="full",
            torch_native=True, rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        return val, time.perf_counter() - t0

    for _ in range(3):  # records the engine's graphs, then replays them
        val, wall = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"ms": busy / 1e3, "mode": "device busy", "k": None,
            "wall_s": wall, "integral": float(val)}


def barriers(iters: int = 20000) -> dict:
    """Device time of one grid barrier, in us: this tree's, and the
    parent's design at the same launch shape (blocks and threads)."""
    import torch
    sys.path.insert(0, HERE)
    from tci_tpu_torch.ops import _build, lu_cuda
    new_us = lu_cuda.grid_barrier_ms(0, iters) * 1e3
    G = lu_cuda.grid_blocks(0, 8)
    lib_path = os.path.join(_build.BUILD_DIR, "libgrid_barrier_parent.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(HERE, "tools", "grid_barrier_parent.cu")],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    fn = lib.grid_barrier_parent_launch
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for n in (1, iters):  # the first launch loads the kernel
        bar = torch.zeros((2,), dtype=torch.int32, device="cuda")
        start.record()
        rc = fn(G, lu_cuda.grid_threads(), n, bar.data_ptr(), stream)
        end.record()
        if rc != 0:
            raise RuntimeError(f"parent barrier launch failed: CUDA error "
                               f"{rc}")
    end.synchronize()
    return {"blocks": G, "threads": lu_cuda.grid_threads(), "new_us": new_us,
            "parent_us": start.elapsed_time(end) / iters * 1e3}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="unpacked tree of the parent")
    parser.add_argument("--out", help="write the results here as JSON")
    parser.add_argument("--time", metavar="ROOT",
                        help="time one tree and print its JSON line")
    parser.add_argument("--variants", action="store_true",
                        help="with --time: also the deferral builds")
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("grid_ab: no CUDA device")
    if opts.time:
        print(json.dumps(time_tree(opts.time, opts.variants)), flush=True)
        return
    if not opts.parent:
        parser.error("--parent DIR is required")
    runs = []
    for name in ("parent", "change", "change", "parent"):
        root = os.path.abspath(opts.parent) if name == "parent" else HERE
        cmd = [sys.executable, os.path.abspath(__file__), "--time", root]
        proc = subprocess.run(cmd + (["--variants"] if name == "change"
                                     else []),
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            sys.exit(f"grid_ab: the {name} run failed:\n{proc.stderr}")
        runs.append((name, json.loads(proc.stdout.strip().splitlines()[-1])))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"card": smi, "order": [n for n, _ in runs],
              "panels": {}, "barrier": barriers()}
    for tag in runs[0][1]:
        result["panels"][tag] = [dict(r[tag], tree=n) for n, r in runs]
        cells = " / ".join(f"{r[tag]['ms']:.4f} ({r[tag]['mode']})"
                           for _, r in runs)
        alts = "".join(
            f"; change, {label}: " + " / ".join(
                f"{r[tag][label]:.4f}" for n, r in runs if label in r[tag])
            for label in DEFER_BUILDS if label in runs[1][1][tag])
        print(f"[grid_ab] {tag} (k = {runs[1][1][tag]['k']}): "
              f"parent / change / change / parent ms: {cells}{alts}",
              flush=True)
    b = result["barrier"]
    print(f"[grid_ab] grid barrier alone ({b['blocks']} blocks of "
          f"{b['threads']} threads): {b['new_us']:.4f} us, the parent's "
          f"design {b['parent_us']:.4f} us; {smi}", flush=True)
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
