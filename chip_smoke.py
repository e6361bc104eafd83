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
   ``crossinterpolate2`` on the card, by each of the port's three tiers:
   the host tier (a plain scalar f and no device argument: panels sampled
   on the host, factorized on the card), the fused tier (a
   ``TorchBatchEvaluator`` with ``enable_device_sweep=False``: one fused
   update a bond) and the engine (the default ``TorchBatchEvaluator``: a
   whole sweep on the card, one fetch at its end). Each tier runs cold,
   warm and once more under torch's sync debug mode; each run is checked
   against tci_tpu's recorded series, with every elimination launching the
   kernel (launches equal to rrlu_raw calls plus the tiers' own rrLU
   calls), none taking the plain version, the fetches the tier should make,
   and the pivot sets of the host tier. Then one engine sweep with its fill
   runs under sync debug mode "error" (no synchronization, one fetch), and
   an engine that starts at a capacity of 4 has to grow;
5. the kernel against the plain version on every launch the cold runs of
   phase 4 made; its times on the engine's bond panel (Imax (d + 1)
   square, multi-block) and on the engine's fill (its P blocks in one
   batched launch); the bounds of the kernels still to be ported;
6. with ``--profile DIR`` only: for each tier, the median of 10 warm
   config-1 walls, then one run under ``torch.profiler`` with a span around
   each layer (Π sampling, rrlu_raw, the CI-factor solves, sweep2site,
   fillsitetensors, the global search, sweep1site, and the device tiers'
   sweeps, the host time that queues them, their fetches and the fused
   updates). The traces go to DIR/config1_<tier>_trace.json; the device's
   busy time and idle share over the run, the largest device items, the
   spans and the CUDA runtime calls are printed.

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

    def bound_parts(mp, npd, m, n, k, elsize):
        """The two lower bounds of one elimination, in ms: each input byte
        read once and each output byte written once (the panel in; the LU
        buffer, both permutations, mags, k and err out) over the HBM rate,
        and the Schur updates this run's k needs, 2 sum_{j<k} (m-1-j)(n-1-j)
        operations, over the peak rate."""
        nbytes = (2 * mp * npd * elsize + 8 * (mp + npd + 1)
                  + elsize * (min(mp, npd) + 1))
        ops = sum(2.0 * (m - 1 - j) * (n - 1 - j) for j in range(k))
        return (nbytes / HBM_BYTES_PER_S * 1e3,
                ops / PEAK_FLOP_PER_S[elsize] * 1e3)

    def bound_ms(mp, npd, m, n, k, elsize):
        """The least time the card could take for one elimination, the
        larger of bound_parts, and which of the two it is."""
        t_bytes, t_ops = bound_parts(mp, npd, m, n, k, elsize)
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
    host_panel = {}
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
                        host_panel = {
                            "host_panel": f"{P.shape[0]}x{P.shape[1]}",
                            "host_panel_ms": dms if dms is not None else ms,
                            "host_panel_ms_from": (
                                "profiler" if dms is not None
                                else "cuda events"),
                            "host_panel_wrapper_ms": ms,
                            "host_panel_plain_ms": pms,
                            "host_panel_bound_ms": bms,
                            "host_panel_bound_by": bby}

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

    # -- 4. config 1 through the port's three tiers ---------------------------
    from tci_tpu_torch.models.device_sweep import DeviceSweepEngine
    from tci_tpu_torch.utils.device import FETCHES

    def fdev(idx):
        v = idx.to(torch.float64) + 1.0
        return 1.0 / (1.0 + (v * v).sum(dim=1))

    def fscalar(x):
        return 1.0 / (1.0 + sum((i + 1.0) ** 2 for i in x))

    localdims = [10] * 8
    # host: a plain scalar f and no device argument (sampled on the host,
    # factorized on the card); fused: a TorchBatchEvaluator with the engine
    # off (one fused update a bond); engine: the default TorchBatchEvaluator
    # (one fetch a sweep)
    TIERS = ("host", "fused", "engine")

    def solve_config1(tier, imax=None):
        if tier == "host":
            f = fscalar
        else:
            f = tci_tpu_torch.TorchBatchEvaluator(
                fdev, localdims, enable_device_sweep=tier == "engine")
            if imax is not None:
                f._device_sweep_engine = DeviceSweepEngine(
                    f._values, localdims, imax=imax)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tci, ranks, errors = tci_tpu_torch.crossinterpolate2(
            np.float64, f, localdims, tolerance=1e-8,
            rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        return tci, ranks, errors, time.perf_counter() - t0, f

    def tier_calls(f):
        """rrLU launches the device tiers of evaluator f asked for."""
        parts = (getattr(f, "_" + a, None) for a in (
            "device_sweep_engine", "fused_updater", "fused_site_tensors"))
        return sum(p.rrlu_calls for p in parts if p is not None)

    # every launch of the kernel on a recorded run: its inputs, for phase 5
    launch_inputs = []
    raw_calls = [0]
    originals = (lu_mod.rrlu_raw, lu_cuda.rrlu_call, lu_cuda.rrlu_batched)

    def counting_rrlu_raw(*args, **kwargs):
        raw_calls[0] += 1
        return originals[0](*args, **kwargs)

    def clones(args):
        return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args)

    def run_config1(tier, record=False, imax=None):
        """One config-1 run with every count set to 0 just before it; the
        counts are read just after."""
        lu_cuda.LAUNCHES.clear()
        lu_kernel.PLAIN_CALLS.clear()
        FETCHES.clear()
        raw_calls[0] = 0
        lu_mod.rrlu_raw = counting_rrlu_raw
        if record:
            lu_cuda.rrlu_call = lambda *a, **k: (
                launch_inputs.append((tier, False, clones(a), k))
                or originals[1](*a, **k))
            lu_cuda.rrlu_batched = lambda *a, **k: (
                launch_inputs.append((tier, True, clones(a), k))
                or originals[2](*a, **k))
        try:
            tci, ranks, errors, wall, f = solve_config1(tier, imax)
        finally:
            lu_mod.rrlu_raw, lu_cuda.rrlu_call, lu_cuda.rrlu_batched = originals
        counts = {"launches": lu_cuda.LAUNCHES["rrlu"],
                  "plain_cuda": lu_kernel.PLAIN_CALLS["cuda"],
                  "rrlu_raw": raw_calls[0], "tier_calls": tier_calls(f),
                  "fetches": dict(FETCHES),
                  "nevals": getattr(f, "nevals", 0)}
        return tci, ranks, errors, wall, f, counts

    def check_config1(tag, tci, ranks, errors, counts):
        x = (1, 2, 3, 4, 5, 4, 3, 2)
        v = np.asarray(x, dtype=float) + 1.0
        point_err = abs(tci(x) - 1.0 / (1.0 + v @ v))
        if ranks != RECORDED_RANKS or not np.allclose(
                errors, RECORDED_ERRORS, rtol=0, atol=1e-15):
            fail(f"config 1 {tag}: ranks {ranks}, errors {errors}; recorded "
                 f"{RECORDED_RANKS}, {RECORDED_ERRORS}")
        if not point_err < 1e-7:
            fail(f"config 1 {tag}: pointwise error {point_err}")
        if tci.device.type != "cuda" or not all(
                t.device.type == "cuda" for t in tci.sitetensors()):
            fail(f"config 1 {tag}: ran on {tci.device} or its site tensors "
                 f"left the card")
        # every elimination launched the kernel: the host tier's through
        # rrlu_raw, the device tiers' through their own calls
        n = counts["rrlu_raw"] + counts["tier_calls"]
        if counts["launches"] == 0 or counts["launches"] != n:
            fail(f"config 1 {tag}: {counts['launches']} kernel launches for "
                 f"{counts['rrlu_raw']} rrlu_raw and {counts['tier_calls']} "
                 f"tier rrLU calls")
        if counts["plain_cuda"] != 0:
            fail(f"config 1 {tag}: {counts['plain_cuda']} plain-version calls "
                 f"on CUDA tensors")
        return point_err

    def count_syncs(tier):
        """Host waits of one run: the synchronizations torch's sync debug
        mode flags, and the device tiers' fetches (a wait on an event, which
        the debug mode does not see)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                *_, counts = run_config1(tier)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        flagged = sum("synchroniz" in str(w.message) for w in caught)
        return flagged, sum(counts["fetches"].values())

    results = {}
    for tier in TIERS:
        tci, ranks, errors, cold, f, counts = run_config1(tier, record=True)
        check_config1(f"{tier} cold", tci, ranks, errors, counts)
        tci, ranks, errors, warm, f, counts = run_config1(tier)
        point_err = check_config1(f"{tier} warm", tci, ranks, errors, counts)
        flagged, fetch_waits = count_syncs(tier)
        iters = len(ranks)
        bonds = 2 * iters * (len(localdims) - 1)
        if tier == "host" and (counts["tier_calls"] or counts["fetches"]):
            fail(f"config 1 host: device tiers ran ({counts})")
        if tier == "fused" and (
                counts["fetches"].get("fused_bond") != bonds
                or f.fused_updater.rrlu_calls != bonds
                or counts["fetches"].get("engine")):
            fail(f"config 1 fused: {counts['fetches']} fetches and "
                 f"{f.fused_updater.rrlu_calls} fused launches for {bonds} "
                 f"bond updates")
        if tier == "engine" and (
                counts["rrlu_raw"] or f._fused_updater is not None
                or counts["fetches"] != {"engine": 2 * iters + 1}
                or counts["tier_calls"] != f.device_sweep_engine.rrlu_calls):
            fail(f"config 1 engine: {counts} for {iters} iterations; the "
                 f"engine should fetch once a sweep and launch every rrLU")
        results[tier] = {"cold": cold, "warm": warm, **counts,
                         "flagged_syncs": flagged, "fetch_waits": fetch_waits,
                         "sets": (tci.Iset, tci.Jset)}
        print(f"[config1] {tier} tier: cold {cold:.4f} s, warm {warm:.4f} s, "
              f"ranks {ranks}, errors {[f'{e:.6e}' for e in errors]}, "
              f"|t(x) - f(x)| {point_err:.3e}; {counts['launches']} kernel "
              f"launches ({counts['rrlu_raw']} rrlu_raw, "
              f"{counts['tier_calls']} tier calls), {counts['plain_cuda']} "
              f"plain calls on CUDA, fetches {counts['fetches']}; host waits "
              f"in one run: {flagged} flagged syncs + {fetch_waits} fetches; "
              f"nevals {counts['nevals']}", flush=True)
    for tier in ("fused", "engine"):
        if results[tier]["sets"] != results["host"]["sets"]:
            fail(f"config 1: the {tier} tier's pivot sets differ from the "
                 f"host tier's")

    # the engine's sweep synchronizes nowhere but at its fetch
    bf = tci_tpu_torch.TorchBatchEvaluator(fdev, localdims)
    tci = tci_tpu_torch.TensorCI2.from_function(bf, localdims)
    engine = bf.device_sweep_engine
    empty = [[] for _ in localdims]
    engine.sweep2site(tci, True, 1e-14, 0.0, 2**62, empty, empty)
    torch.cuda.synchronize()
    fetches0 = FETCHES["engine"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.sweep2site(tci, False, 1e-14, 0.0, 2**62, empty, empty,
                          fill_sites=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if FETCHES["engine"] != fetches0 + 1:
        fail(f"engine sweep: {FETCHES['engine'] - fetches0} fetches")
    print("[config1] engine sweep2site with the fill under sync debug mode "
          "\"error\": no synchronization, 1 fetch", flush=True)

    # an engine that starts at a capacity of 4 has to grow to rank 12
    tci, ranks, errors, grow_wall, f, counts = run_config1("engine", imax=4)
    check_config1("engine from Imax 4", tci, ranks, errors, counts)
    if not f.device_sweep_engine.Imax > 4 or counts["rrlu_raw"]:
        fail(f"engine from Imax 4: Imax {f.device_sweep_engine.Imax}, "
             f"{counts['rrlu_raw']} rrlu_raw calls")
    print(f"[config1] engine from Imax 4: grew to Imax "
          f"{f.device_sweep_engine.Imax}, {grow_wall:.4f} s, "
          f"{counts['launches']} launches, fetches {counts['fetches']}",
          flush=True)

    # -- 5. kernel vs plain on every launch config 1 made ---------------------
    engine_panel = engine_fill = None
    for i, (tier, is_batched, args, kw) in enumerate(launch_inputs):
        kernel = originals[2] if is_batched else originals[1]
        plain = (lu_kernel.rrlu_plain_batched if is_batched
                 else lu_kernel.rrlu_plain)
        out, ref = kernel(*args, **kw), plain(*args, **kw)
        max_err = max(max_err, compare(
            f"config1 {tier} launch {i} {tuple(args[0].shape)}", out, ref,
            1.0))
        # for their times: the engine's first fill (its P blocks in one
        # launch) and its bond panel with the most pivots
        if tier == "engine":
            ks = out[3].tolist()
            if args[0].shape[0] > 1 and engine_fill is None:
                engine_fill = (args, kw, ks)
            elif args[0].shape[-1] > 128 and (
                    engine_panel is None or ks[0] > engine_panel[2][0]):
                engine_panel = (args, kw, ks)
    ntier = {t: sum(x[0] == t for x in launch_inputs) for t in TIERS}
    print(f"[kernel] config 1's launches ({ntier}): kernel and plain version "
          f"identical (max |LU diff| {max_err})", flush=True)
    if engine_panel is None or engine_fill is None:
        fail("config 1 engine: no bond panel above the resident limit or no "
             "batched fill among its launches")

    def time_engine_launch(name, rec):
        """Device, wrapper-call and plain times of one recorded engine
        launch, and its bound summed over its panels."""
        args, kw, ks = rec
        B, mp, npd = args[0].shape
        parts = [bound_parts(mp, npd, int(args[1][b]), int(args[2][b]),
                             ks[b], args[0].element_size()) for b in range(B)]
        t_bytes, t_ops = (sum(p[i] for p in parts) for i in (0, 1))
        res = {name: f"{B}x{mp}x{npd}",
               f"{name}_ms": kernel_device_ms(
                   lambda: originals[2](*args, **kw), 20),
               f"{name}_wrapper_ms": cuda_ms(
                   lambda: originals[2](*args, **kw), 20),
               f"{name}_plain_ms": cuda_ms(
                   lambda: lu_kernel.rrlu_plain_batched(*args, **kw), 3),
               f"{name}_bound_ms": max(t_bytes, t_ops),
               f"{name}_bound_by": ("bytes" if t_bytes >= t_ops
                                    else "operations")}
        mode = ("multi-block" if lu_cuda._lib().rrlu_scratch_bytes(
            mp, npd, args[0].element_size()) > 0 else "resident")
        print(f"[kernel] {name} {B} x {mp}x{npd} {str(args[0].dtype)[6:]} "
              f"(k={ks}, {mode}): kernel device time {res[name + '_ms']} ms "
              f"a launch (profiler), wrapper call "
              f"{res[name + '_wrapper_ms']:.4f} ms (events), plain "
              f"{res[name + '_plain_ms']:.4f} ms, bound "
              f"{res[name + '_bound_ms']:.6f} ms ({res[name + '_bound_by']})",
              flush=True)
        return res

    # the engine's bond panel, Imax (d + 1) square, and its fill's P blocks
    eng = {**time_engine_launch("engine_panel", engine_panel),
           **time_engine_launch("engine_fill", engine_fill)}

    # the least time of the TPU kernels still to be ported (ROADMAP B9, the
    # probes of benchmarks/probe_pallas_batched.py, B = 4, n = 256): each
    # input byte read once and each output byte written once over the HBM
    # rate; their arithmetic is a few integer operations
    b9_bytes = {"v1": 4 * 2 * 4, "v2": 4 * 3 * 4 + 4 * 2 * 4,
                "v3": 4 * 3 * 4 + 4 * 256 * 4 + 4 * 2 * 4,
                "v4": 4 * 3 * 4 + 4 * 256 * 4 + 4 * 2 * 4,
                "v4b": 4 * 2 * 4 + 4 * 256 * 4 + 4 * 2 * 4,
                "v4c": 4 * 3 * 4 + 4 * 256 * 4 + 4 * 2 * 4}
    print("[bound] B9 probes, to be ported: " + ", ".join(
        f"{name} {nb} B {nb / HBM_BYTES_PER_S * 1e3:.4g} ms"
        for name, nb in b9_bytes.items()), flush=True)

    # -- 6. profile of config 1 (--profile) -----------------------------------
    if opts.profile:
        for tier in TIERS:
            profile_config1(opts.profile, tier,
                            lambda t=tier: solve_config1(t)[3])

    if any(m == "jax" or m.startswith(("jax.", "tci_tpu."))
           or m == "tci_tpu" for m in sys.modules):
        fail("jax or tci_tpu was imported")

    print(smi_line, flush=True)
    # "launches", "ms", "plain_ms" and "bound_ms" are all the engine's, the
    # default path of a TorchBatchEvaluator: its launches in one config-1
    # run and the kernel's device time a launch on its bond panel; each
    # path's launches are beside them, and the host tier's 128^2 panel
    # under host_panel_*. No PyTorch call computes a complete-pivot rrLU
    # (torch.linalg.lu_factor pivots partially), so library_ms is null
    ms = eng["engine_panel_ms"]
    print(json.dumps({"kernels": [{
        "name": "rrlu_kernel",
        "route": "cuda",
        "source": "tci_tpu_torch/csrc/rrlu.cu",
        "replaces": "tci_tpu/ops/pallas_lu.py:133",
        "launches": results["engine"]["launches"],
        "launches_by_path": {t: results[t]["launches"] for t in TIERS},
        "max_abs_err": max_err,
        "ms": ms if ms is not None else eng["engine_panel_wrapper_ms"],
        "ms_from": "profiler" if ms is not None else "cuda events",
        "plain_ms": eng["engine_panel_plain_ms"],
        "bound_ms": eng["engine_panel_bound_ms"],
        "bound_by": eng["engine_panel_bound_by"],
        "library_ms": None,
        **host_panel,
        **eng,
        **n2000,
        **config2,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def profile_config1(outdir, tier, solve):
    """Warm walls of config 1 through one tier (`solve` runs it and returns
    its wall), then one run under torch.profiler with a span around each
    layer of the path; prints the breakdown."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tci_tpu_torch.models import device_sweep, globalpivotfinder, tensorci2
    from tci_tpu_torch.ops import fused, lu as lu_mod, luci

    walls = sorted(solve() for _ in range(10))
    print(f"[profile] {tier}: config 1 warm wall: median "
          f"{(walls[4] + walls[5]) / 2:.4f} s of 10 runs "
          f"(range {walls[0]:.4f}-{walls[-1]:.4f} s)", flush=True)

    engine = device_sweep.DeviceSweepEngine
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
        # the device tiers: the host time that queues a sweep's launches
        # (engine_*_queue) apart from the wait at its fetch
        (engine, "sweep2site", "engine_sweep2site"),
        (device_sweep, "_sweep", "engine_sweep_queue"),
        (device_sweep, "_fill", "engine_fill_queue"),
        (device_sweep, "_sweep1", "engine_sweep1site_queue"),
        (device_sweep, "fetch", "fetch"),
        (fused.FusedBondUpdater, "update", "fused_update"),
        (fused.FusedSiteTensors, "compute", "fused_site_tensor"),
        (fused, "fetch", "fetch"),
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
                wall = solve()
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"config1_{tier}_trace.json")
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
    print(f"[profile] {tier}: profiled wall {wall:.4f} s, span {window:.3f} ms; "
          f"device busy {busy:.3f} ms (kernels, copies, memsets), idle share "
          f"{1 - busy / window:.4f}", flush=True)
    for name, (n, ms) in by_name("kernel")[:6]:
        print(f"[profile] {tier}: device: {name[:70]}: {ms:.3f} ms in {n}",
              flush=True)
    for name, (n, ms) in by_name("gpu_memcpy")[:2]:
        print(f"[profile] {tier}: device: {name}: {ms:.3f} ms in {n}", flush=True)
    for name, (n, ms) in by_name("user_annotation"):
        if name != "config1":
            print(f"[profile] {tier}: span {name}: {ms:.3f} ms in {n} (host, "
                  f"inclusive)", flush=True)
    for name, (n, ms) in by_name("cuda_runtime")[:6]:
        print(f"[profile] {tier}: runtime {name}: {n} calls, {ms:.3f} ms host",
              flush=True)
    print(f"[profile] {tier}: trace: {path}", flush=True)


if __name__ == "__main__":
    main()
