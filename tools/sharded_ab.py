#!/usr/bin/env python3
"""Time the sharded elimination's step kernel of two trees on the same card.

    python3 tools/sharded_ab.py --parent DIR [--out FILE]

DIR is an unpacked tree of another commit (``git archive <commit> | tar -x
-C DIR``, in a directory that .gitignore lists). Each tree runs in a
process of its own, in the order parent, change, change, parent, on a
one-rank NCCL mesh of the card, and builds its kernels from its own
sources. Each process times BASELINE config 2 (4096^2 f64, rank 256,
``chip_smoke.config2_matrix``): the step kernel alone, by CUDA events
around the call's launches queued back to back (the parent's first column
maxima and three kernels a step, pick, swap and update; this tree's first
candidate and one kernel a step, reading the slot it wrote, as one rank's
gather would give it back); this tree's kernel also with its write-back
deferred over each depth (``lu_sharded.DEFER``) on config 2 and on blocks
of its first 1024, 2048 and 3072 rows; the whole ``rrlu_panel_sharded``
call by events (median of 3) beside the one-device kernel; the call's
launches and collectives; and phase 4i's zip-up at L = 20, chi = 16 on
the mesh: its step-kernel launches and its warm wall (median of 3)
beside the device tier's. The table goes to stdout and, with --out, as JSON to FILE. Needs
one CUDA device.

    python3 tools/sharded_ab.py --time ROOT

runs one tree's timings and prints them as one JSON line (what the A/B
starts in each process).

    python3 tools/sharded_ab.py --depths [--out FILE]

runs only this tree's depth sweep, on config 2's blocks of width 4096 and
on narrower ones (NARROW_BLOCKS), each depth beside the one defer_depth
picks.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_inputs", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def events_ms(fn, reps=1):
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# blocks of config 2 of other widths (their first rows and columns) that
# the --depths sweep adds: 8, 16 and 32 MiB, below and near the L2
NARROW_BLOCKS = ((512, 2048), (1024, 2048), (2048, 2048), (512, 4096))


def depth_sweep(A, R: int, blocks) -> dict:
    """This tree's step kernel (first candidate and R steps on one rank)
    with the write-back deferred over each depth, on each (rows, cols)
    block of A's leading rows and columns: the faster of two runs by
    events, and the depth defer_depth picks."""
    import torch
    from tci_tpu_torch.ops import lu_sharded
    out = {}
    for rows, cols in blocks:
        for depth in range(1, lu_sharded.MAX_DEFER + 1):
            lu_sharded.DEFER = depth
            try:
                ts = []
                for _ in range(2):
                    st = lu_sharded._State(
                        A[:rows, :cols].contiguous(), 0, rows, rows, cols,
                        1e-10, 0.0, True, 1, R)
                    st.recv = st.send
                    ts.append(events_ms(lambda: _steps(st, R)))
            finally:
                lu_sharded.DEFER = None
            out[f"{rows}x{cols} depth {depth}"] = min(ts)
        out[f"{rows}x{cols} rule"] = lu_sharded.defer_depth(
            rows, cols, A.dtype, A.device)
    out["l2_bytes"] = torch.cuda.get_device_properties(
        A.device).L2_cache_size
    return out


def _steps(st, R: int) -> None:
    from tci_tpu_torch.ops import lu_sharded
    lu_sharded._launch(st, 0)
    for _ in range(R):
        lu_sharded._launch(st, 1)


def sweep_tree(root: str) -> dict:
    """The depth sweep alone, on config 2's blocks of width 4096 and on
    NARROW_BLOCKS."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    cs = _chip_smoke()
    A = cs.config2_matrix(torch.device("cuda", 0))
    N = A.shape[0]
    blocks = [*NARROW_BLOCKS, *((rows, N) for rows in (1024, 2048, 3072, N))]
    # the first sweep builds the kernels and brings the card to its
    # clocks (a first reading of the smallest block ran 1.3x slow)
    depth_sweep(A, 256, blocks)
    return depth_sweep(A, 256, blocks)


def time_tree(root: str) -> dict:
    """Config 2 and the mesh zip-up through the sharded elimination of the
    tree at `root`."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import torch.distributed as dist
    import tci_tpu_torch
    from tci_tpu_torch.ops import lu_cuda, lu_sharded
    from tci_tpu_torch.parallel.mesh import default_mesh
    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    mesh = default_mesh(1)
    three = len(lu_sharded.PHASES) == 4  # the three-kernel step
    A = cs.config2_matrix(dev)
    N, R = A.shape[0], 256
    out = {"design": "three kernels a step" if three else "one kernel a step"}

    def state():
        if three:
            return lu_sharded._State(A.clone(), 0, N, N, N, 1e-10, 0.0,
                                     True)
        st = lu_sharded._State(A.clone(), 0, N, N, N, 1e-10, 0.0, True, 1,
                               R)
        st.recv = st.send  # one rank: the gather gives the slot back
        return st

    def kernel_steps(st):
        if not three:
            return _steps(st, R)
        lu_sharded._launch(st, 0)
        for _ in range(R):
            for phase in (1, 2, 3):
                lu_sharded._launch(st, phase)

    kernel_steps(state())  # builds the kernels
    runs = []
    for _ in range(3):
        st = state()
        runs.append(events_ms(lambda: kernel_steps(st)))
        if int(st.ist[0]) != R:
            sys.exit(f"sharded_ab: {int(st.ist[0])} pivots, not {R}")
    out["kernel_ms"] = sorted(runs)[1]
    out["kernel_ms_all"] = runs
    if not three:
        out["depths"] = depth_sweep(A, R, ((rows, N) for rows in
                                           (1024, 2048, 3072, N)))
    for c in (lu_sharded.LAUNCHES, lu_sharded.COLLECTIVES):
        c.clear()
    res = lu_sharded.rrlu_panel_sharded(A, N, N, R, 1e-10, 0.0,
                                        leftorthogonal=True, mesh=mesh)
    one = lu_cuda.rrlu_call(A, N, N, R, 1e-10, 0.0, leftorthogonal=True)
    out["bitwise_one_device"] = all(
        torch.equal(x, y) for x, y in zip(res, one))
    out["launches"] = lu_sharded.LAUNCHES["lu_sharded_step"]
    out["collectives"] = dict(lu_sharded.COLLECTIVES)
    calls = [events_ms(lambda: lu_sharded.rrlu_panel_sharded(
        A, N, N, R, 1e-10, 0.0, leftorthogonal=True, mesh=mesh))
        for _ in range(3)]
    ones = [events_ms(lambda: lu_cuda.rrlu_call(
        A, N, N, R, 1e-10, 0.0, leftorthogonal=True)) for _ in range(3)]
    out.update(call_ms=sorted(calls)[1], call_ms_all=calls,
               one_device_ms=sorted(ones)[1], one_device_ms_all=ones)
    # the zip-up of phase 4i's operands on the mesh, warm
    a20, b20 = cs.mpo_operands(20, 16)
    TT = tci_tpu_torch.TensorTrain

    def zipup(m):
        return tci_tpu_torch.contract(
            TT(a20), TT(b20), algorithm="zipup", method="LU",
            tolerance=1e-10, torch_native=True, mesh=m)
    zipup(mesh)
    zipup(None)
    walls = {}
    for tag, m in (("mesh", mesh), ("one", None)):
        for _ in range(3):
            before = lu_sharded.LAUNCHES["lu_sharded_step"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            zipup(m)
            torch.cuda.synchronize()
            walls.setdefault(tag, []).append(time.perf_counter() - t0)
            if tag == "mesh":
                out["zipup_launches"] = lu_sharded.LAUNCHES[
                    "lu_sharded_step"] - before
    out.update(zipup_mesh_s=sorted(walls["mesh"])[1],
               zipup_mesh_s_all=walls["mesh"],
               zipup_one_s=sorted(walls["one"])[1],
               zipup_one_s_all=walls["one"])
    dist.destroy_process_group()
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="unpacked tree of the parent")
    parser.add_argument("--out", help="write the results here as JSON")
    parser.add_argument("--time", metavar="ROOT",
                        help="time one tree and print its JSON line")
    parser.add_argument("--depths", action="store_true",
                        help="only this tree's depth sweep")
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("sharded_ab: no CUDA device")
    if opts.depths:
        sweep = sweep_tree(HERE)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        for key, v in sweep.items():
            unit = " ms" if "depth" in key else ""
            print(f"[sharded_ab] {key}: {v}{unit}", flush=True)
        print(f"[sharded_ab] {smi}", flush=True)
        if opts.out:
            with open(opts.out, "w") as fh:
                json.dump({"card": smi, "depths": sweep}, fh, indent=1)
        return
    if opts.time:
        print(json.dumps(time_tree(opts.time)), flush=True)
        return
    if not opts.parent:
        parser.error("--parent DIR is required")
    runs = []
    for name in ("parent", "change", "change", "parent"):
        root = os.path.abspath(opts.parent) if name == "parent" else HERE
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time", root],
            capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            sys.exit(f"sharded_ab: the {name} run failed:\n{proc.stderr}")
        runs.append((name, json.loads(proc.stdout.strip().splitlines()[-1])))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"card": smi, "runs": [dict(r, tree=n) for n, r in runs]}
    for key in ("kernel_ms", "call_ms", "one_device_ms", "launches",
                "collectives", "bitwise_one_device", "zipup_launches",
                "zipup_mesh_s", "zipup_one_s"):
        cells = " / ".join(
            f"{r[key]:.4f}" if isinstance(r[key], float) else str(r[key])
            for _, r in runs)
        print(f"[sharded_ab] config 2 {key}: parent / change / change / "
              f"parent: {cells}", flush=True)
    for key, v in runs[1][1]["depths"].items():
        other = runs[2][1]["depths"][key]
        print(f"[sharded_ab] change, {key}: {v} / {other}"
              + (" ms" if "depth" in key else ""), flush=True)
    print(f"[sharded_ab] {smi}", flush=True)
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
