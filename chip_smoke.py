#!/usr/bin/env python3
"""Smoke run of tci_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py [--profile DIR]

Run from the repository root (the package must sit beside this script). It
needs one CUDA device and exits non-zero without one. Phases, one output
line or more each:

1. the device: torch's name for it, and nvidia-smi's name and power limit;
2. the build of the CUDA rrLU kernel (csrc/rrlu.cu) from the sources;
3. the kernel against its plain PyTorch version on the card, float64 and
   float32: Lorentzian panels at the main path's bucket sizes (8 ... 128,
   both orientations, padding, an abstol and a reltol stop; for each, the
   kernel's device time per launch from torch.profiler beside the mean of
   back-to-back wrapper calls, which includes host time, and the least time
   the card could take), the resident kernel's split (device time with the
   rank capped at 0, 1, 2, 4 and k: fixed and per-pivot cost, at 128^2 and
   16^2), four panels in one batched launch, ``rrlu`` at N = 1000 and 2000
   with numerical rank 100 (N = 2000 run 20 times against one plain
   result), the mode table
   (f64 buckets 128^2 ... 4096^2: which mode the kernel takes, its time and
   the plain version's), and the panels the one-block design could not
   take, 64 x 10000 (rank 40) and 4200^2 (rank 100). Pivot order, npivot and
   err must be identical and the LU buffer equal; both times are printed;
3b. BASELINE config 2: rrLU of a numpy-seeded 4096^2 f64 matrix
   U diag(exp(-j/16)) V of rank 256, maxrank 256, reltol 1e-10: kernel and
   plain version bitwise, reconstruction max|LU - A| / max|A| < 1e-8, both
   times and GFLOP/s counted as 2 r N^2 (benchmarks/bench_rrlu.py) and as
   2 sum_j (N - j)^2;
4. BASELINE config 1 (8-D Lorentzian on {0..9}^8, tolerance 1e-8) through
   ``crossinterpolate2`` with a ``TorchBatchEvaluator`` on the card: a cold
   and a warm run, checked against tci_tpu's recorded series, with every
   factorization launching the kernel and none taking the plain version;
   a third run counts the device-to-host synchronizations; a fourth passes
   a plain scalar f and no device argument, and must run on the card too
   (launches equal to rrLU calls, no plain call, the recorded series);
5. the kernel against the plain version on every panel config 1 factorized;
6. with ``--profile DIR`` only: the median of 10 warm config-1 walls, then
   one run under ``torch.profiler`` with a span around each layer of the
   main path (Π sampling, rrlu_raw, the CI-factor solves, sweep2site,
   fillsitetensors, the global search, the final sweep1site). The trace goes
   to DIR/config1_trace.json; the device's busy time and idle share over the
   run, the largest device items, the spans and the CUDA runtime calls are
   printed.

The second-to-last lines are nvidia-smi's card line and a JSON object with
the kernel's launches, error and times; the last line is the result object.
Any failure exits non-zero; nothing falls back to the CPU.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

# tci_tpu's host tier on a CPU, full precision (tests/test_torch_tensorci2.py)
RECORDED_RANKS = [12, 12, 12]
RECORDED_ERRORS = [8.648364589823703e-09, 4.396554474387151e-09,
                   4.396554474387151e-09]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile config 1 and write its trace here")
    opts = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "tci_tpu_torch")):
        fail(f"tci_tpu_torch not found beside {__file__}")
    sys.path.insert(0, here)
    import numpy as np

    import tci_tpu_torch
    from tci_tpu_torch.ops import _build, lu as lu_mod, lu_cuda, lu_kernel

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 1. device -----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch: {kind}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lu_cuda._lib()
    print(f"[build] rrlu.cu: {time.perf_counter() - t0:.3f} s "
          f"(nvcc {_build.BUILD_SECONDS['rrlu']:.3f} s)", flush=True)

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def kernel_device_ms(fn, reps):
        """Mean device time per launch of the rrLU kernel over `reps` calls
        of fn, from a torch.profiler trace (host time excluded); None when
        the trace holds no such kernel."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        durs = [e["dur"] for e in events if e.get("ph") == "X"
                and e.get("cat") == "kernel" and "rrlu" in e.get("name", "")]
        return sum(durs) / len(durs) / 1e3 if durs else None

    # NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3; 34 TFLOP/s f64 and
    # 67 TFLOP/s f32 outside the tensor cores (the rates of a 700 W card)
    HBM_BYTES_PER_S = 3.35e12
    PEAK_FLOP_PER_S = {8: 34e12, 4: 67e12}

    def bound_ms(mp, npd, m, n, k, elsize):
        """The least time the card could take for one elimination: each
        input byte read once and each output byte written once (the panel
        in; the LU buffer, both permutations, mags, k and err out) over the
        HBM rate, against the Schur updates this run's k needs,
        2 sum_{j<k} (m-1-j)(n-1-j) operations, over the peak rate."""
        nbytes = (2 * mp * npd * elsize + 8 * (mp + npd + 1)
                  + elsize * (min(mp, npd) + 1))
        ops = sum(2.0 * (m - 1 - j) * (n - 1 - j) for j in range(k))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FLOP_PER_S[elsize] * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                           "operations")

    def compare(tag, out, ref, scale):
        """Pivot order, npivot and err identical; returns max |LU diff|."""
        A_o, rp_o, cp_o, k_o, mags_o, err_o = out
        A_r, rp_r, cp_r, k_r, mags_r, err_r = ref
        if not (torch.equal(rp_o, rp_r) and torch.equal(cp_o, cp_r)
                and torch.equal(k_o, k_r)):
            fail(f"{tag}: pivot order or npivot differs "
                 f"(k {k_o.tolist()} vs {k_r.tolist()})")
        same_err = (err_o == err_r) | (err_o.isnan() & err_r.isnan())
        if not bool(same_err.all()) or not torch.equal(mags_o, mags_r):
            fail(f"{tag}: err or pivot magnitudes differ")
        diff = float((A_o - A_r).abs().max())
        if diff > 0.0:
            fail(f"{tag}: LU buffer differs by {diff:.3e} "
                 f"(bound: bitwise, scale {scale:.3e})")
        return diff

    # -- 3. kernel vs plain version ------------------------------------------
    def lorentzian(nI, nJ, seed, d=10):
        rng = np.random.default_rng(seed)
        left = rng.integers(0, d, size=(nI, 3))
        right = rng.integers(0, d, size=(nJ, 3))
        s = np.array([((p + 1.0) ** 2).sum() + (c + 1.0) ** 2
                      for p in left for c in range(d)])
        t = np.array([(c + 1.0) ** 2 + ((q + 1.0) ** 2).sum()
                      for c in range(d) for q in right])
        return 1.0 / (1.0 + s[:, None] + t[None, :])

    def padded(A, dtype):
        m, n = A.shape
        P = torch.zeros((lu_kernel.bucket(m), lu_kernel.bucket(n)),
                        dtype=dtype, device=dev)
        P[:m, :n] = torch.as_tensor(A, device=dev)
        return P

    max_err = 0.0
    main = {}
    # (rows of I, cols of J): panels of (10 nI) x (10 nJ), as the main path
    # builds them; a 5 x 6 panel for the 8 bucket
    shapes = [(None, None), (1, 1), (2, 3), (4, 4), (6, 8), (10, 12), (12, 12)]
    for dtype in (torch.float64, torch.float32):
        for nI, nJ in shapes:
            if nI is None:
                rng = np.random.default_rng(3)
                A = rng.standard_normal((5, 3)) @ rng.standard_normal((3, 6))
            else:
                A = lorentzian(nI, nJ, seed=10 * nI + nJ)
            m, n = A.shape
            P = padded(A, dtype)
            stops = [("abstol", 1e-14, 1e-8 * float(np.abs(A).max()))]
            if m >= 40:
                stops.append(("reltol", 1e-6, 0.0))
            for stop, reltol, abstol in stops:
                for leftorth in (True, False):
                    args = (P, m, n, min(m, n), reltol, abstol)
                    kw = {"leftorthogonal": leftorth}
                    out = lu_cuda.rrlu_call(*args, **kw)
                    ref = lu_kernel.rrlu_plain(*args, **kw)
                    tag = (f"{str(dtype)[6:]} {m}x{n} (bucket "
                           f"{P.shape[0]}x{P.shape[1]}) {stop} "
                           f"{'left' if leftorth else 'right'}")
                    max_err = max(max_err, compare(tag, out, ref, 1.0))
                    k = int(out[3])
                    ms = cuda_ms(lambda: lu_cuda.rrlu_call(*args, **kw), 20)
                    dms = kernel_device_ms(
                        lambda: lu_cuda.rrlu_call(*args, **kw), 20)
                    pms = cuda_ms(lambda: lu_kernel.rrlu_plain(*args, **kw), 5)
                    bms, bby = bound_ms(*P.shape, m, n, k, P.element_size())
                    dev_txt = ("not measured" if dms is None
                               else f"{dms:.4f} ms")
                    print(f"[kernel] {tag}: k={k} identical; kernel device "
                          f"time {dev_txt} a launch (profiler), wrapper call "
                          f"{ms:.4f} ms (events), plain {pms:.4f} ms, bound "
                          f"{bms:.6f} ms ({bby})", flush=True)
                    if (dtype == torch.float64 and (nI, nJ) == (12, 12)
                            and stop == "abstol" and leftorth):
                        main = {"ms": dms if dms is not None else ms,
                                "ms_from": ("profiler" if dms is not None
                                            else "cuda events"),
                                "wrapper_ms": ms, "plain_ms": pms,
                                "bound_ms": bms, "bound_by": bby}

    # the resident kernel's split: device time with the rank capped at 0
    # (launch, load, first pass, write-out) and at 1, 2, 4 and the panel's
    # own k pivots; the slope is the cost of a pivot
    for nI, nJ in ((12, 12), (1, 1)):
        A = lorentzian(nI, nJ, seed=10 * nI + nJ)
        m, n = A.shape
        P = padded(A, torch.float64)
        abstol = 1e-8 * float(np.abs(A).max())
        kfull = int(lu_cuda.rrlu_call(P, m, n, min(m, n), 1e-14, abstol,
                                      leftorthogonal=True)[3])
        times = {}
        for cap in sorted({0, 1, 2, 4, kfull}):
            times[cap] = kernel_device_ms(
                lambda: lu_cuda.rrlu_call(P, m, n, cap, 1e-14, abstol,
                                          leftorthogonal=True), 20)
        if any(t is None for t in times.values()):
            print(f"[split] {m}x{n}: device times not measured", flush=True)
            continue
        per_pivot = (times[kfull] - times[0]) / kfull * 1e3
        print(f"[split] f64 {m}x{n} (bucket {P.shape[0]}x{P.shape[1]}) "
              f"device time by rank cap: " + ", ".join(
                  f"{c}: {t * 1e3:.2f} us" for c, t in times.items())
              + f"; fixed {times[0] * 1e3:.2f} us, {per_pivot:.2f} us a "
              f"pivot", flush=True)

    # four panels in one launch, per-panel extents and tolerances
    for dtype in (torch.float64, torch.float32):
        Ab = torch.stack([padded(lorentzian(12, 12, seed=s), dtype)
                          for s in range(4)])
        mt = torch.tensor([120, 110, 120, 97], device=dev)
        nt = torch.tensor([120, 120, 100, 120], device=dev)
        mr = torch.tensor([120, 8, 100, 97], device=dev)
        rt = torch.tensor([1e-14, 0.0, 1e-6, 1e-14], device=dev)
        at = torch.tensor([1e-10, 0.0, 0.0, 0.0], device=dev)
        bargs = (Ab, mt, nt, mr, rt, at)
        out = lu_cuda.rrlu_batched(*bargs, leftorthogonal=True)
        ref = lu_kernel.rrlu_plain_batched(*bargs, leftorthogonal=True)
        max_err = max(max_err, compare(f"batched B=4 {dtype}", out, ref, 1.0))
        ms = cuda_ms(lambda: lu_cuda.rrlu_batched(*bargs, leftorthogonal=True),
                     20)
        dms = kernel_device_ms(
            lambda: lu_cuda.rrlu_batched(*bargs, leftorthogonal=True), 20)
        pms = cuda_ms(
            lambda: lu_kernel.rrlu_plain_batched(*bargs, leftorthogonal=True),
            3)
        dev_txt = "not measured" if dms is None else f"{dms:.4f} ms"
        bounds = [bound_ms(128, 128, int(mt[b]), int(nt[b]), int(out[3][b]),
                           Ab.element_size()) for b in range(4)]
        bms = max(sum(t for t, by in bounds if by == "bytes"),
                  sum(t for t, by in bounds if by == "operations"))
        print(f"[kernel] batched B=4 {str(dtype)[6:]} 128x128: k="
              f"{out[3].tolist()} identical; kernel device time {dev_txt} a "
              f"launch (profiler), wrapper call {ms:.4f} ms (events), "
              f"plain {pms:.4f} ms, bound {bms:.6f} ms", flush=True)

    # the reference's rrLU benchmark sizes: N = 1000, 2000, rank 100
    n2000 = {}
    for N in (1000, 2000):
        rng = np.random.default_rng(N)
        A = torch.as_tensor(rng.standard_normal((N, 100))
                            @ rng.standard_normal((100, N)), device=dev)
        P = padded(A, torch.float64)
        args = (P, N, N, N, 1e-12, 0.0)
        out = lu_cuda.rrlu_call(*args, leftorthogonal=True)
        ref = lu_kernel.rrlu_plain(*args, leftorthogonal=True)
        max_err = max(max_err, compare(f"rrlu N={N}", out, ref, 1.0))
        k = int(out[3])
        if k != 100:
            fail(f"rrlu N={N}: npivot {k}, expected 100")
        lu = tci_tpu_torch.rrlu(A, reltol=1e-12)
        rec = float((lu.left() @ lu.right() - A).abs().max())
        if lu.npivots() != 100 or not rec < 1e-8 * float(A.abs().max()):
            fail(f"rrlu N={N}: npivot {lu.npivots()}, reconstruction {rec}")
        ms = cuda_ms(lambda: tci_tpu_torch.rrlu(A, reltol=1e-12), 3)
        kms = cuda_ms(lambda: lu_cuda.rrlu_call(*args, leftorthogonal=True), 3)
        pms = cuda_ms(lambda: lu_kernel.rrlu_plain(*args, leftorthogonal=True),
                      3)
        flops = sum(2.0 * (N - j) * (N - j) for j in range(k))
        bms, bby = bound_ms(*P.shape, N, N, k, 8)
        print(f"[kernel] rrlu N={N} f64 rank {k} (bucket {P.shape[0]}): "
              f"identical; kernel {kms:.3f} ms ({flops / kms / 1e6:.3f} "
              f"GFLOP/s), plain {pms:.3f} ms, public rrlu {ms:.3f} ms, "
              f"bound {bms:.4f} ms ({bby}), |LU - A| {rec:.3e}", flush=True)
        if N == 2000:
            n2000 = {"n2000_ms": kms, "n2000_plain_ms": pms}
            # a stale cross-block read would show as a rare wrong pivot
            for rep in range(20):
                compare(f"rrlu N=2000 repeat {rep}",
                        lu_cuda.rrlu_call(*args, leftorthogonal=True), ref,
                        1.0)
            print("[kernel] rrlu N=2000: 20 more kernel runs, each identical "
                  "to the plain result", flush=True)

    # the mode each f64 bucket takes, and its time against the plain version
    lib = lu_cuda._lib()
    for N in (128, 160, 192, 256, 512, 1024, 2048, 4096):
        rank = min(100, N // 2)
        rng = np.random.default_rng(N)
        P = torch.as_tensor(rng.standard_normal((N, rank))
                            @ rng.standard_normal((rank, N)), device=dev)
        args = (P, N, N, N, 1e-12, 0.0)
        out = lu_cuda.rrlu_call(*args, leftorthogonal=True)
        ref = lu_kernel.rrlu_plain(*args, leftorthogonal=True)
        max_err = max(max_err, compare(f"mode table {N}^2", out, ref, 1.0))
        mode = ("multi-block" if lib.rrlu_scratch_bytes(N, N, 8) > 0
                else "resident")
        kms = cuda_ms(lambda: lu_cuda.rrlu_call(*args, leftorthogonal=True), 3)
        pms = cuda_ms(lambda: lu_kernel.rrlu_plain(*args, leftorthogonal=True),
                      3)
        print(f"[mode] f64 {N}x{N} rank {int(out[3])}: {mode}, kernel "
              f"{kms:.4f} ms, plain {pms:.4f} ms (identical)", flush=True)

    # panels whose vectors overflowed the one-block design's shared memory
    for m, n, rank in ((64, 10000, 40), (4200, 4200, 100)):
        rng = np.random.default_rng(m + n)
        A = torch.as_tensor(rng.standard_normal((m, rank))
                            @ rng.standard_normal((rank, n)), device=dev)
        P = padded(A, torch.float64)
        args = (P, m, n, min(m, n), 1e-12, 0.0)
        out = lu_cuda.rrlu_call(*args, leftorthogonal=True)
        ref = lu_kernel.rrlu_plain(*args, leftorthogonal=True)
        max_err = max(max_err, compare(f"rrlu {m}x{n}", out, ref, 1.0))
        lu = tci_tpu_torch.rrlu(A, reltol=1e-12)
        rec = float((lu.left() @ lu.right() - A).abs().max())
        if lu.npivots() != rank or not rec < 1e-8 * float(A.abs().max()):
            fail(f"rrlu {m}x{n}: npivot {lu.npivots()}, reconstruction {rec}")
        print(f"[kernel] rrlu {m}x{n} f64 (bucket {P.shape[0]}x{P.shape[1]})"
              f": k={int(out[3])} identical; public rrlu npivot "
              f"{lu.npivots()}, |LU - A| {rec:.3e}", flush=True)

    # -- 3b. BASELINE config 2 -------------------------------------------------
    N, R = 4096, 256
    rng = np.random.default_rng(4096)
    U = rng.standard_normal((N, R)) * np.exp(-np.arange(R) / 16.0)
    A = torch.as_tensor(U @ rng.standard_normal((R, N)), device=dev)
    args = (A, N, N, R, 1e-10, 0.0)
    out = lu_cuda.rrlu_call(*args, leftorthogonal=True)
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=True)
    max_err = max(max_err, compare("config 2", out, ref, 1.0))
    k = int(out[3])
    lu = tci_tpu_torch.rrlu(A, maxrank=R, reltol=1e-10)
    rel = float((lu.left() @ lu.right() - A).abs().max() / A.abs().max())
    if lu.npivots() != k or not rel < 1e-8:
        fail(f"config 2: npivot {lu.npivots()} (kernel {k}), "
             f"max|LU - A|/max|A| = {rel:.3e}")
    kms = cuda_ms(lambda: lu_cuda.rrlu_call(*args, leftorthogonal=True), 5)
    pms = cuda_ms(lambda: lu_kernel.rrlu_plain(*args, leftorthogonal=True), 2)
    flops_bench = 2.0 * k * N * N
    flops_exact = sum(2.0 * (N - j) * (N - j) for j in range(k))
    bms, bby = bound_ms(N, N, N, N, k, 8)
    print(f"[config2] rrLU {N}^2 f64 rank {k}: identical; kernel {kms:.3f} ms"
          f" ({flops_bench / kms / 1e6:.3f} GFLOP/s as 2rN^2, "
          f"{flops_exact / kms / 1e6:.3f} as 2 sum (N-j)^2), plain "
          f"{pms:.3f} ms ({flops_bench / pms / 1e6:.3f} / "
          f"{flops_exact / pms / 1e6:.3f}); bound {bms:.4f} ms ({bby}); "
          f"max|LU - A|/max|A| {rel:.3e}", flush=True)
    config2 = {"config2_ms": kms, "config2_plain_ms": pms}

    # -- 4. config 1 through the port -----------------------------------------
    def fdev(idx):
        v = idx.to(torch.float64) + 1.0
        return 1.0 / (1.0 + (v * v).sum(dim=1))

    localdims = [10] * 8
    panels = []
    rrlu_raw = lu_mod.rrlu_raw

    def recording_rrlu_raw(A, *args, **kwargs):
        panels.append((A, args))
        return rrlu_raw(A, *args, **kwargs)

    def solve_config1():
        bf = tci_tpu_torch.TorchBatchEvaluator(fdev, localdims, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tci, ranks, errors = tci_tpu_torch.crossinterpolate2(
            np.float64, bf, localdims, tolerance=1e-8,
            rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        return tci, ranks, errors, time.perf_counter() - t0, bf.nevals

    def run_config1(record=False, solve=solve_config1):
        panels.clear()
        lu_mod.rrlu_raw = recording_rrlu_raw
        try:
            tci, ranks, errors, wall, nevals = solve()
        finally:
            lu_mod.rrlu_raw = rrlu_raw
        ncalls = len(panels)
        if not record:
            panels.clear()
        return tci, ranks, errors, wall, nevals, ncalls

    tci, ranks, errors, cold, nevals, ncalls = run_config1(record=True)
    print(f"[config1] cold: {cold:.3f} s, ranks {ranks}, "
          f"{ncalls} rrLU calls", flush=True)
    captured = list(panels)
    panels.clear()

    lu_cuda.LAUNCHES.clear()
    lu_kernel.PLAIN_CALLS.clear()
    tci, ranks, errors, warm, nevals, ncalls = run_config1()
    launches = lu_cuda.LAUNCHES["rrlu"]
    plain_cuda = lu_kernel.PLAIN_CALLS["cuda"]

    x = (1, 2, 3, 4, 5, 4, 3, 2)
    v = np.asarray(x, dtype=float) + 1.0
    point_err = abs(tci(x) - 1.0 / (1.0 + v @ v))
    print(f"[config1] warm: {warm:.3f} s, nevals {nevals}, "
          f"{nevals / warm:.1f} evals/s, {ncalls} rrLU calls, "
          f"{launches} kernel launches, {plain_cuda} plain calls on CUDA",
          flush=True)
    print(f"[config1] ranks {ranks} (recorded CPU {RECORDED_RANKS}); "
          f"errors {[f'{e:.6e}' for e in errors]} (recorded CPU "
          f"{[f'{e:.6e}' for e in RECORDED_ERRORS]}); linkdims "
          f"{tci.linkdims()}; |t(x) - f(x)| = {point_err:.3e}", flush=True)
    if not errors[-1] < 1e-8:
        fail(f"config 1 did not converge: errors {errors}")
    if ranks[-1] != 12 or ranks != RECORDED_RANKS:
        fail(f"config 1 ranks {ranks}, recorded {RECORDED_RANKS}")
    if not np.allclose(errors, RECORDED_ERRORS, rtol=0, atol=1e-15):
        fail(f"config 1 errors {errors} differ from {RECORDED_ERRORS}")
    if not point_err < 1e-7:
        fail(f"config 1 pointwise error {point_err}")
    if ncalls == 0 or launches != ncalls:
        fail(f"{launches} kernel launches for {ncalls} rrLU calls")
    if plain_cuda != 0:
        fail(f"{plain_cuda} plain-version calls on CUDA tensors")
    if not all(t.device.type == "cuda" for t in tci.sitetensors()):
        fail("site tensors left the device")

    # device-to-host synchronizations, counted by torch's sync debug mode
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            *_, ncalls_sync = run_config1()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    nsync = sum("synchroniz" in str(w.message) for w in caught)
    print(f"[config1] device-to-host syncs: {nsync} in one run, "
          f"{ncalls_sync} rrLU calls ({nsync / ncalls_sync:.2f} per call)",
          flush=True)

    # a plain scalar f and no device argument: the port's default device is
    # the card, so the host-sampled panels are factorized there
    def fscalar(x):
        return 1.0 / (1.0 + sum((i + 1.0) ** 2 for i in x))

    def solve_config1_plain():
        t0 = time.perf_counter()
        tci, ranks, errors = tci_tpu_torch.crossinterpolate2(
            np.float64, fscalar, localdims, tolerance=1e-8,
            rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        return tci, ranks, errors, time.perf_counter() - t0, 0

    launches0 = lu_cuda.LAUNCHES["rrlu"]
    plain0 = sum(lu_kernel.PLAIN_CALLS.values())
    tci_p, ranks_p, errors_p, wall_p, _, ncalls_p = run_config1(
        solve=solve_config1_plain)
    launches_p = lu_cuda.LAUNCHES["rrlu"] - launches0
    plain_p = sum(lu_kernel.PLAIN_CALLS.values()) - plain0
    print(f"[config1] plain scalar f, no device argument: {wall_p:.3f} s on "
          f"{tci_p.device}, ranks {ranks_p}, {ncalls_p} rrLU calls, "
          f"{launches_p} kernel launches, {plain_p} plain calls", flush=True)
    if tci_p.device.type != "cuda":
        fail(f"config 1 with a plain f ran on {tci_p.device}")
    if ncalls_p == 0 or launches_p != ncalls_p or plain_p != 0:
        fail(f"config 1 with a plain f: {launches_p} kernel launches and "
             f"{plain_p} plain calls for {ncalls_p} rrLU calls")
    if ranks_p != RECORDED_RANKS or not np.allclose(
            errors_p, RECORDED_ERRORS, rtol=0, atol=1e-15):
        fail(f"config 1 with a plain f: ranks {ranks_p}, errors {errors_p}")

    # -- 5. kernel vs plain on config 1's own panels ---------------------------
    for i, (A, (maxrank, reltol, abstol, leftorth)) in enumerate(captured):
        m, n = A.shape
        P = padded(A, torch.float64)
        args = (P, m, n, min(maxrank, m, n), reltol, abstol)
        out = lu_cuda.rrlu_call(*args, leftorthogonal=leftorth)
        ref = lu_kernel.rrlu_plain(*args, leftorthogonal=leftorth)
        max_err = max(max_err, compare(f"config1 panel {i} {m}x{n}", out,
                                       ref, 1.0))
    print(f"[kernel] config 1's {len(captured)} panels: kernel and plain "
          f"version identical (max |LU diff| {max_err})", flush=True)

    # -- 6. profile of config 1 (--profile) -----------------------------------
    if opts.profile:
        profile_config1(opts.profile, solve_config1)

    if any(m == "jax" or m.startswith(("jax.", "tci_tpu."))
           or m == "tci_tpu" for m in sys.modules):
        fail("jax or tci_tpu was imported")

    print(smi_line, flush=True)
    # "ms" is the kernel's device time a launch on the main-path 128^2 f64
    # panel; no PyTorch call computes a complete-pivot rrLU
    # (torch.linalg.lu_factor pivots partially), so library_ms is null
    print(json.dumps({"kernels": [{
        "name": "rrlu_kernel",
        "route": "cuda",
        "source": "tci_tpu_torch/csrc/rrlu.cu",
        "replaces": "tci_tpu/ops/pallas_lu.py:133",
        "launches": launches,
        "max_abs_err": max_err,
        **main,
        "library_ms": None,
        **n2000,
        **config2,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def profile_config1(outdir, solve_config1):
    """Warm walls of config 1, then one run under torch.profiler with a span
    around each layer of the main path; prints the breakdown."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tci_tpu_torch.models import globalpivotfinder, tensorci2
    from tci_tpu_torch.ops import lu as lu_mod, luci

    walls = sorted(solve_config1()[3] for _ in range(10))
    print(f"[profile] config 1 warm wall: median "
          f"{(walls[4] + walls[5]) / 2:.4f} s of 10 runs "
          f"(range {walls[0]:.4f}-{walls[-1]:.4f} s)", flush=True)

    spans = [
        (tensorci2, "_batchevaluate_dispatch", "sample_panel"),
        (lu_mod, "rrlu_raw", "rrlu_raw"),
        (luci.MatrixLUCI, "colstimespivotinv", "ci_left"),
        (luci.MatrixLUCI, "pivotinvtimesrows", "ci_right"),
        (tensorci2.TensorCI2, "sweep2site", "sweep2site"),
        (tensorci2.TensorCI2, "fillsitetensors", "fillsitetensors"),
        (tensorci2.TensorCI2, "sweep1site", "sweep1site"),
        (globalpivotfinder.DefaultGlobalPivotFinder, "__call__",
         "globalsearch"),
    ]

    def spanned(fn, name):
        def wrapper(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapper

    saved = [(owner, attr, owner.__dict__[attr]) for owner, attr, _ in spans]
    for (owner, attr, name), (_, _, fn) in zip(spans, saved):
        setattr(owner, attr, spanned(fn, name))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("config1"):
                wall = solve_config1()[3]
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "config1_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]

    def by_name(cat):
        out = {}
        for e in events:
            if e.get("cat") == cat:
                n, t = out.get(e["name"], (0, 0.0))
                out[e["name"]] = (n + 1, t + e["dur"] / 1e3)
        return sorted(out.items(), key=lambda kv: -kv[1][1])

    top = next(e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == "config1")
    lo, hi = top["ts"], top["ts"] + top["dur"]
    window = top["dur"] / 1e3
    device = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                    for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, lo
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e3
    print(f"[profile] profiled wall {wall:.4f} s, span {window:.3f} ms; "
          f"device busy {busy:.3f} ms (kernels, copies, memsets), idle share "
          f"{1 - busy / window:.4f}", flush=True)
    for name, (n, ms) in by_name("kernel")[:6]:
        print(f"[profile] device: {name[:70]}: {ms:.3f} ms in {n}",
              flush=True)
    for name, (n, ms) in by_name("gpu_memcpy")[:2]:
        print(f"[profile] device: {name}: {ms:.3f} ms in {n}", flush=True)
    for name, (n, ms) in by_name("user_annotation"):
        if name != "config1":
            print(f"[profile] span {name}: {ms:.3f} ms in {n} (host, "
                  f"inclusive)", flush=True)
    for name, (n, ms) in by_name("cuda_runtime")[:6]:
        print(f"[profile] runtime {name}: {n} calls, {ms:.3f} ms host",
              flush=True)
    print(f"[profile] trace: {path}", flush=True)


if __name__ == "__main__":
    main()
