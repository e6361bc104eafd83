#!/usr/bin/env python3
"""Time the six batched-grid probe kernels of two trees on the same card.

    python3 tools/probe_ab.py --parent DIR [--out FILE]

DIR is an unpacked tree of another commit (``git archive <commit> | tar -x
-C DIR``, in a directory that .gitignore lists). Its
``tci_tpu_torch/csrc/probe_batched.cu`` is built here with this tree's nvcc
flags and launched through the C signature every version of it has, (s,
v, o, B, cols, n, stream); both trees' kernels must be bit for bit this
tree's plain versions. At B = 4 programs, the probe's own table and each
row length of ROWS (v1 and v2, which write no row, at 256 alone), each
probe is timed in the order parent, change, empty, empty at the parent's
launch shape, the same, empty, change, parent: ``chip_smoke.launch_times``,
the median of 100 launches in a torch.profiler trace and CUDA events around
the replay of a CUDA graph of 1,000 (two graph runs of one kernel that sit
at different levels are reported as not measured, not averaged). "empty"
is this tree's empty kernel at a launch shape (``probe_batched.floor_ms``'s
kernel). The table goes to stdout and, with --out, as JSON to FILE. Needs
one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# the row lengths the row probes are timed at (the probe's own is 256)
ROWS = (256, 1024, 4096, 16384)
B = 4
ORDER = ("parent", "change", "empty", "empty_parent_shape",
         "empty_parent_shape", "empty", "change", "parent")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_lib(parent: str) -> ctypes.CDLL:
    """The parent tree's probe library, built into this tree's build
    directory under a name that carries a hash of its source."""
    from tci_tpu_torch.ops import _build
    csrc = os.path.join(parent, "tci_tpu_torch", "csrc")
    src = os.path.join(csrc, "probe_batched.cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    path = _build.BUILD_DIR / f"libprobe_batched_parent_{digest}.so"
    if not path.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc,
                        "-o", str(path), src], check=True)
    lib = ctypes.CDLL(str(path))
    for name in ("v1", "v2", "v3", "v4", "v4b", "v4c"):
        fn = getattr(lib, f"probe_{name}_launch")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def parent_call(lib, name, n, s, dev):
    """Outputs of the parent's kernel `name`, as this tree's wrapper
    returns them: (o,) for v1 and v2, else (v, o)."""
    import torch
    dtype = torch.float32 if name == "v4b" else torch.int32
    o = torch.empty((B, 2), dtype=dtype, device=dev)
    v = (None if name in ("v1", "v2")
         else torch.empty((B, 1, n), dtype=dtype, device=dev))
    rc = getattr(lib, f"probe_{name}_launch")(
        None if s is None else s.data_ptr(),
        None if v is None else v.data_ptr(), o.data_ptr(), B,
        0 if s is None else s.shape[1], n,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the parent's {name} failed with CUDA error {rc}")
    return (o,) if v is None else (v, o)


def change_call(name, n, s, dev):
    from tci_tpu_torch.ops import probe_batched
    wrapper = probe_batched.PROBES[name][0]
    if name == "v1":
        return (wrapper(B, dev),)
    return (wrapper(s),) if name == "v2" else wrapper(s, n)


def plain_call(name, n, s, dev):
    from tci_tpu_torch.ops import probe_batched
    plain = probe_batched.PROBES[name][1]
    if name == "v1":
        return (plain(B, dev),)
    return (plain(s),) if name == "v2" else plain(s, n)


def bitwise(outs, refs) -> bool:
    import torch
    for o, r in zip(outs, refs):
        if o.dtype == torch.float32:
            o, r = o.view(torch.int32), r.view(torch.int32)
        if not torch.equal(o.cpu(), r.cpu()):
            return False
    return True


def time_probe(cs, lib, name, n, dev) -> dict:
    from tci_tpu_torch.ops import probe_batched
    s = None if name == "v1" else probe_batched.probe_table(name, B, dev)
    ref = plain_call(name, n, s.cpu() if s is not None else None, "cpu")
    for tree, call in (("parent", lambda: parent_call(lib, name, n, s, dev)),
                       ("change", lambda: change_call(name, n, s, dev))):
        if not bitwise(call(), ref):
            sys.exit(f"probe_ab: the {tree}'s {name} at n = {n} is not bit "
                     f"for bit the plain version")
    kernel = f"probe_{name}_kernel"
    # the parent's launch shape, from a trace of one launch
    first = cs.launch_times(lambda: parent_call(lib, name, n, s, dev),
                            kernel, 1, 1)
    parent_threads = json.loads(sorted(first["shapes"])[0][1])[0]
    threads = probe_batched.launch_shape(name, B, n)[1]
    versions = {
        "parent": (lambda: parent_call(lib, name, n, s, dev), kernel),
        "change": (lambda: change_call(name, n, s, dev), kernel),
        "empty": (lambda: probe_batched.empty_launch(B, threads, dev),
                  "probe_empty_kernel"),
        "empty_parent_shape": (
            lambda: probe_batched.empty_launch(B, parent_threads, dev),
            "probe_empty_kernel")}
    row = {"n": n, "threads": threads, "parent_threads": parent_threads,
           **{v: {"profiler_ms": [], "graph_ms": []} for v in versions}}
    for version in ORDER:
        fn, kname = versions[version]
        t = cs.launch_times(fn, kname, 100, 1000)
        if t["profiler_ms"] is not None:
            row[version]["profiler_ms"].append(t["profiler_ms"])
        row[version]["graph_ms"].append(t["graph_ms"])
    for version in versions:
        runs = row[version]
        runs["profiler_mean_ms"] = (sum(runs["profiler_ms"])
                                    / len(runs["profiler_ms"])
                                    if runs["profiler_ms"] else None)
        runs["graph_mean_ms"] = cs.same_level(runs["graph_ms"])
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True,
                        help="unpacked tree of the parent")
    parser.add_argument("--out", help="write the results here as JSON")
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("probe_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    cs = _chip_smoke()
    lib = parent_lib(os.path.abspath(opts.parent))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"card": smi, "B": B, "order": ORDER, "rows": []}

    def fmt(runs, level):
        txt = " / ".join(f"{x * 1e3:.4f}" for x in runs) or "none"
        if level and cs.same_level(runs) is None:
            txt += " (not measured: different levels)"
        return txt
    for name in ("v1", "v2", "v3", "v4", "v4b", "v4c"):
        for n in (ROWS[:1] if name in ("v1", "v2") else ROWS):
            row = time_probe(cs, lib, name, n, dev)
            row["name"] = name
            result["rows"].append(row)
            p, c = (row["parent"]["profiler_mean_ms"],
                    row["change"]["profiler_mean_ms"])
            diff = ("not measured" if p is None or c is None
                    else f"{(c - p) * 1e3:+.4f}")
            print(f"[probe_ab] {name} n={n} (change {B} x {row['threads']}, "
                  f"parent {B} x {row['parent_threads']}), us a launch in "
                  f"the order {' / '.join(ORDER)}: profiler change "
                  f"{fmt(row['change']['profiler_ms'], False)}, parent "
                  f"{fmt(row['parent']['profiler_ms'], False)}, empty "
                  f"{fmt(row['empty']['profiler_ms'], False)}, empty at the "
                  f"parent's shape "
                  f"{fmt(row['empty_parent_shape']['profiler_ms'], False)}; "
                  f"graph change {fmt(row['change']['graph_ms'], True)}, "
                  f"parent {fmt(row['parent']['graph_ms'], True)}, empty "
                  f"{fmt(row['empty']['graph_ms'], True)}, empty at the "
                  f"parent's shape "
                  f"{fmt(row['empty_parent_shape']['graph_ms'], True)}; "
                  f"change - parent by the profiler {diff}; {smi}",
                  flush=True)
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
