#!/usr/bin/env python3
"""Smoke run of tci_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py [--profile DIR | --phases]

Run from the repository root (the package must sit beside this script). It
needs one CUDA device and exits non-zero without one. Phases, one output
line or more each:

1. the device: torch's name for it, and nvidia-smi's name and power limit;
2. the build of the CUDA kernels from the sources, csrc/rrlu.cu,
   csrc/probe_batched.cu and csrc/lu_sharded.cu, one nvcc process each,
   started together;
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
   (f64 buckets 128^2 ... 4096^2: which mode the kernel reports, its time
   and the plain version's; then the main path's panels at their true
   extents: config 1's 352^2 (132^2, k = 12), config 4's 512^2 (480^2, k
   = 32) and 1024^2 (960^2, k = 44), config 5's complex 512^2 (136 x 271,
   k = 19) and B = 4 complex 128^2: the mode and the cluster size, the
   device time a launch by kernel, the bound and the plain version's
   time), the cluster mode's split on config 1's panel (rank capped at 0,
   1, 2, 4, 12, 32, 64), and the panels the one-block design could not
   take, 64 x 10000 (rank 40) and 4200^2 (rank 100). Pivot order, npivot and
   err must be identical and the LU buffer equal; both times are printed;
3b. BASELINE config 2: rrLU of a numpy-seeded 4096^2 f64 matrix
   U diag(exp(-j/16)) V of rank 256, maxrank 256, reltol 1e-10: kernel and
   plain version bitwise, reconstruction max|LU - A| / max|A| < 1e-8, both
   times and GFLOP/s counted as 2 r N^2 (benchmarks/bench_rrlu.py) and as
   2 sum_j (N - j)^2;
3c. the batched-grid probes (ops/probe_batched.run_probes: the six probe
   kernels v1 ... v4c, then the single-panel and the batched rrLU entry
   points on 64 x 128 float32 panels), its JSON object on one line; each
   of the six kernels against its plain version on the card, exactly, at
   the probe's inputs and at a second set (B = 7, n = 1000, a seeded
   table with a loop limit of 0 in one row); each kernel's device time a
   launch, its plain version's time and its bound;
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
   and the pivot sets of the host tier. The cold run keeps the inputs of
   every launch for phase 5 and therefore queues its sweeps eagerly (a
   capture runs the wrappers without values); the warm run records the
   engine's sweeps into CUDA graphs and replays them, and a replay counts
   the launches its graph holds. Then one engine sweep with its fill, a
   replay of its graph, runs under sync debug mode "error" (no
   synchronization, one fetch), and an engine that starts at a capacity of
   4 has to grow;
4b. BASELINE config 3 (benchmarks/bench_quantics.py: quantics TCI of
   cos(100 x) exp(-x) on a 2^40 grid, 40 legs of dimension 2, tolerance
   1e-10) through ``crossinterpolate2`` with a default
   ``TorchBatchEvaluator``: the engine, whose 96^2 bond panels take the
   kernel's resident mode. Cold, warm, the median of 10 warm walls and one
   run whose device kernels are counted; rank 2, final error < 1e-10, the
   spot check of bench_quantics.py through the port's ``DiscretizedGrid``
   < 1e-9, every elimination on the engine, one fetch a sweep, no plain
   call;
4c. BASELINE config 4 (benchmarks/bench_integration.py: the 10-D integral
   of 1000 cos(10 sum x^2) exp(-(sum x)^4 / 1000) over [-1, 1]^10, GK15,
   tolerance 1e-8, maxbonddim 64) through ``integrate(torch_native=True)``:
   the engine at d = 15, bond panels of 512^2 at a capacity of 32 (cluster
   mode) and 1024^2 at 64 (grid mode). Cold, warm, median of 10, kernel
   count; the
   integral within 1e-3 of -5.4960415218049, the engine's capacities and
   whether it declined, no plain call; and once through
   ``integrate(vectorized=True)`` (host sampling, factorization on the
   card): the two integrals within 1e-6;
4d. the engine's sweeps as CUDA graphs that an evaluator keeps, for configs
   1, 3 and 4 at full width: five runs each with a new evaluator a run
   (graphs off, recorded at a key's first use, at its second); then one
   evaluator kept: the run that records, ten runs that only replay, ten
   with the graphs switched off. The replayed and the eager results must be
   identical bit for bit (index sets, ranks and error series, every site
   tensor; config 4: the integral, and the capacities [32, 64] with new
   evaluators), the site tensors of the first result unchanged by the later
   runs, every warm sweep a replay, no key declined, launches equal to the
   engine's rrLU calls, one fetch a sweep, no plain call. Printed: the walls
   (medians and ranges), captures, replays, one call's host wall, each
   program's capture time, the device items of one replay (profiler) with
   the rrLU kernel's time inside it, and the memory the graphs' pool holds.
   One program replayed with three (abstol, maxbonddim) pairs must give what
   the eager body gives for each;
4e. tci_tpu's default protocol, which ``optimize`` runs unless the engine's
   ``use_sweep_pair`` / ``use_optimize_loop`` are off (phases 4-4d switch
   them off, so that what they hold and time is the per-sweep protocol):
   the sweep pair with its in-program global search and the optimize loop,
   for configs 1, 3 and 4 at full width. The per-sweep result on a new
   evaluator, then the loop's on a new evaluator (it records the loop's
   step and the 1-site sweep) and ten runs on that kept evaluator, which
   only replay: each bit for bit the per-sweep one (ranks, error series,
   index sets and their history, site tensors; config 4: the integral, and
   the capacities [32, 64] with a new evaluator), no key declined, launches
   equal to the engine's rrLU calls, no plain call, the host finder never
   called. Printed: loop blocks, steps, status reads and fetches a run, the
   recording run's wall and launches, the median of the ten walls beside
   phase 4d's per-sweep median, the device busy time of one replayed run
   (profiler) and the idle share against that median, the graphs' pool,
   and for the loop step's program its device items, device time and the
   host time of its launch;
4f. the TT algebra, the caches and the floating-zone search, on config 1's
   converged train (rank 12, a new evaluator under the default protocol)
   and config 3's: ``estimatetrueerror(tt, f, nsearch=100)`` through the
   engine's floating-zone program (cold: it records the program; warm:
   median of 10 replayed searches; its sweeps = status reads, one fetch,
   captures, replays, the device busy time of a search) against the host
   lock-step search on the card from the same starts (best pivot identical,
   error within 1e-10 relative plus 1e-15 max|f|; each start whose result
   differs parted from the host search's at a tie within 1e-15 max|f|,
   found sweep by sweep and leg by leg), every returned error
   |f - tt| within 1e-9 relative plus 1e-15 max|f|, sorted, and the largest
   within 1e-15 max|f|
   of tci_tpu's on the CPU (``RECORDED_FZONE``); config 1 at maxbonddim 6,
   ``searchglobalpivots(nsearch=100)`` and ``addglobalpivots2sitesweep``
   on the engine and on the host tier: the same pivots, none left, the
   same grown index sets; ``compress`` by LU, CI and SVD at 1e-12 (linkdims
   no larger, values at 10^4 seeded points within 1e-10 max|tt|, one
   kernel launch per LU / CI ``factorize`` call, 2 (L - 1) of them, no
   plain call; the kernel's device time on the compressions' bond
   matrices), ``add`` (rank 24 stacked, 12 at 1e-12, 2 tt) and
   ``subtract`` (norm <= 1e-12 |tt|); ``fulltensor`` of config 1, 10^8
   values, against f on every grid point (< 1e-7) and its Frobenius norm
   against ``tt.norm()`` (1e-12 relative); ``TTCache`` over the TCI's own
   index sets against ``evaluate_batch`` (1e-13 max|tt|), and a
   ``CachedFunction`` around the scalar f through the host tier (the host
   tier's result; one cached value per distinct point). Each step's cold
   and warm walls are printed;
3d. (run after phase 4g, whose launch recorder it shares) BASELINE config
   2 by rook: ``rrlu(A, maxrank=256, reltol=1e-10, pivotsearch="rook",
   rng=default_rng(7))`` on 3b's matrix with precision "f64" and "mixed"
   (benchmarks/bench_rrlu.py): npivot 256 (3b's), max|LU - A| / max|A| <
   1e-8, every slab on the kernel (launches = eliminations, no plain call);
   a cold run (recorded for phase 5), the median of 10 warm walls and its
   GFLOP/s as 2 r N^2, the launches by host mode and shape; 3b's full
   pivoting through ``rrlu`` in the same call; ``rrlu_serving(defer=True)``
   over 4 matrices (one fetch each, at ``result()``); the completion's
   triangular solve against an inverse and a GEMM (``[complete]``);
4h. BASELINE config 1 by rook (benchmarks/bench_rook.py: tolerance 1e-8,
   rng=default_rng(3)) on each tier: the engine under the default protocol
   and the per-sweep one (``engine._rng`` seeded), the per-bond device tier
   (``enable_device_sweep=False``) and the host tier (a plain scalar f),
   cold (queued eagerly, recorded for phase 5, with its dead predicated
   steps counted) and warm: ranks and errors series tci_tpu's
   (``RECORDED_ROOK``; the per-bond tier: ranks, ROADMAP C-port-12), final
   error < 1e-8, bench_rook.py's pointwise check < 1e-7, no engine decline
   and no per-bond tier on the engine runs, the engine's samples
   tci_tpu's, no plain call; then the engine's default protocol on a kept
   evaluator: 10 replayed runs beside phase 4e's full-pivot median, samples
   a run rook against full, one profiled run's kernels and device busy
   time, and the loop step's graph (rrLU launches, device items and time);
4i. tensor-train contraction and the device compression, on
   examples/04_contraction_mpo.py's operands (default_rng(42), N(0, 1) /
   sqrt(chi) cores, legs (2, 2)): ``contract(algorithm="zipup" |
   "naive", method="LU", tolerance=1e-10, torch_native=True)`` at L = 20,
   chi = 16 (exact product bond 256: 19 and 38 rrLU launches of up to 1024
   x 256 and 256 x 1024, the cluster mode); ``compress(torch_native=True)``
   of config 1's train beside the host ``compress("LU")`` (2 (L - 1)
   launches each); ``contract(algorithm="TCI", torch_native=True,
   initialpivots=10)`` at chi = 8 on the engine, its host-side initial
   pivot search timed apart; complex128 zip-up and naive at L = 12, chi =
   8. Each cold (recorded for phase 5) and 10 warm: linkdims tci_tpu's
   (``RECORDED_CONTRACT``, ``RECORDED_COMPRESS``), values at 1,000 fused
   indices within 1e-8 max|exact| of numpy transfer matrices (compress:
   10^4 points within 1e-10 max|tt|), a launch a split and no plain call,
   one fetch a device-tier call, no engine decline; the kernel's device
   time on each path's largest panel beside its plain time and bound;
4j. TCI1, matrix CI / ACA and the conversions (``[tci1]`` lines): config 1
   by ``crossinterpolate1`` (a ``TorchBatchEvaluator`` and the scalar f,
   cold and warm) against ``tci_tpu``'s ranks and errors
   (``RECORDED_TCI1``); the reference notebook's random f (L = 20, d = 2,
   a table of 2^20 values from default_rng(0) on the card, tolerance
   1e-12, maxiter = D) at D = 20, 50, 100, 200, 500 and 1000, once each:
   walls, bond-iterations, fetches a bond-iteration, the fitted exponent;
   at D = 100 ``tci_tpu``'s pivot lists (sha256), ranks and errors
   (``RECORDED_RANDOM100``); at D = 1000 the full linkdims and f at 1,000
   pivot crosses within 1e-10; the conversions (config 1's train through
   ``tci2_from_tensortrain`` -> ``tci1_from_tci2`` -> ``tci2_from_tci1``,
   ``tci2_from_tensortrain`` of the D = 1000 train, ``aca_from_rrlu`` of
   config 2's rrLU; cold, recorded for phase 5, and warm): a kernel launch
   a ``MatrixLUCI``, no plain call, the kernel's time on the D = 1000
   train's 1024 x 1000, 2000 x 512 and 512 x 512 panels beside its plain
   time and bound; ``matrix_crossinterpolate`` and a greedy ``MatrixACA``
   on config 2's matrix to rank 256 within 1e-10 max|A|;
4k. the auxiliaries (``[aux]`` lines): (a) checkpoint and resume: config
   1 on the engine (default protocol) to 1e-4, ``save_tci2``, ``load_tci2``
   on the card, ``optimize`` to 1e-8 on the same evaluator (rng
   default_rng(0) both times): tci_tpu's resumed ranks and errors
   (``RECORDED_RESUME``, 1e-15), f at 1,000 seeded points within 1e-7,
   save -> load -> save bitwise, the median of 10 resume walls on a kept
   evaluator; config 5 (complex128, 1e-4 then 1e-7): the resumed integral
   within 1e-9 of the same coarse run continued without the checkpoint;
   (b) configs 1 and 5 through ``TorchBatchEvaluator.from_scalar`` (a
   vmapped scalar f) on the engine: the batched f's ranks, errors and
   samples, whether bit for bit, no key declined, the warm medians of 10
   side by side; (c) configs 1's and 5's trains through MPS tensors and
   the quimb layout (a stand-in with ``.arrays``) and back, phase 4i's MPO
   operand through MPO tensors: every core bitwise, ``evaluate_mps``
   within 1e-12 of the train at 1,000 points; (d) a seeded sweep of random
   panels through the rrLU kernel (f32, f64, complex128; 1 x 1 to past a
   cluster's capacity, so that every mode is hit; exactly rank-deficient
   panels, maxrank, reltol and abstol stops, padding, batched calls of B =
   1-8; about 30 s) against its plain version bit for bit: counts by type
   and mode; (e) each example of ``tci_tpu_torch/examples`` as a process
   of its own on the card: it prints ``ok``, its wall is printed. The cold
   runs of (a) and (b) queue eagerly and are recorded for phase 5;
4l. the multi-GPU layer (``[mesh]`` lines), with every count set to 0
   just before it and read just after: (a) a one-rank NCCL group on a
   file store in a temporary directory and its DeviceMesh; (b) BASELINE
   config 2 through ``rrlu_sharded`` on it: pivot order, npivot, err and
   the LU buffer bitwise the one-device kernel's in the same call, every
   launch of the step kernel (csrc/lu_sharded.cu) bitwise its plain
   version, the launches, collectives, stop-flag reads and dead steps,
   the call's time against the one-device kernel's, the step kernel's time
   alone, its bound and the plain version's time; (c) config 1 on the
   mesh under the default protocol (the all-gather inside the engine's
   graphs), cold and the median of 10 warm runs on a kept evaluator,
   beside the one-device run: ranks, errors and nevals bit for bit and
   tci_tpu's series; (d) config 4's ``integrate(torch_native=True,
   mesh=)``, bitwise the one-device integral; (e) phase 4i's zip-up at L =
   20, chi = 16 and config 1's train compressed on the mesh, bitwise the
   device tier's, every step-kernel launch checked; (f)
   ``tt_evaluate_sharded``, ``parallel.dryrun.run(1)`` and ex06 as a
   process; (g) two gloo ranks spawned on the one card running config 2's
   ``rrlu_sharded`` on half-height blocks (gloo all-reduces CUDA tensors
   through the host), bitwise the one-device kernel. Nothing runs on more
   than one GPU: the machine has one;
5. the kernel against the plain version on every launch the cold runs of
   phases 3d, 4, 4b, 4c, 4f, 4g, 4h, 4i, 4j and 4k made (rook: each slab shape's time,
   bound and plain time, and a dead step's); its times on the engines' bond panels (Imax
   (d + 1) square: 352^2 for config 1, 96^2 for config 3, 512^2 and 1024^2
   for config 4) and on config 1's fill (its P blocks in one batched
   launch);
6. with ``--profile DIR`` only: for config 1's host and fused tiers, and
   for the engine on configs 1, 3 and 4 on an evaluator that is kept, once
   replaying its graphs and once queuing eagerly (per-sweep protocol), and
   once replaying under the default protocol (the optimize loop; config 5
   too), the
   median of 10 warm walls, then one run under
   ``torch.profiler`` with a span around each layer (Π sampling, rrlu_raw,
   the CI-factor solves, sweep2site, fillsitetensors, the global search,
   sweep1site, and the device tiers' sweeps, a program's upload and run,
   the host time that queues an eager body, the fetches and the fused
   updates). The traces go to
   DIR/<run>_trace.json; the device's busy time and idle share over the
   run, the largest device items, the spans and the CUDA runtime calls are
   printed. Then phase 4j's random f once more at D = 1000 under the
   profiler (device activity only, no trace file): the device's busy time
   and idle share, kernels and fetches a bond-iteration, the largest
   device items.

``--phases`` runs nothing of the above but the build: it builds the rrLU
kernel once more with -DRRLU_PHASE_CLOCKS and prints, for the cluster
mode on configs 1, 4 and 5's bond panels, the SM cycles of each phase of
a CTA's work (``[phases]`` lines), then the card's line.

The second-to-last lines are nvidia-smi's card line and a JSON object with
every kernel's launches, error and times; the last line is the result object.
Any failure exits non-zero; nothing falls back to the CPU.
"""

import argparse
import gc
import hashlib
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

# tci_tpu's host tier on a CPU, full precision (tests/test_torch_tensorci2.py)
RECORDED_RANKS = [12, 12, 12]
RECORDED_ERRORS = [8.648364589823703e-09, 4.396554474387151e-09,
                   4.396554474387151e-09]

# tci_tpu's largest error of estimatetrueerror(tt, f, nsearch=100,
# rng=default_rng(0)) on the CPU, for config 1's train (at (5, 8, 2, 3, 3, 3,
# 6, 7)) and config 3's, each from tci_tpu's host tier with the same seed
RECORDED_FZONE = {"config1": 8.041161582081346e-10,
                  "config3": 8.95363869851673e-11}

# where each probe kernel's Pallas original starts in
# benchmarks/probe_pallas_batched.py
PROBE_LINES = {"v1": 47, "v2": 63, "v3": 81, "v4": 108, "v4b": 143,
               "v4c": 168}
# BASELINE config 4's integral (tests/test_integration.py)
CONFIG4_INTEGRAL = -5.4960415218049
# BASELINE config 5 (benchmarks/bench_feynman.py at N = 6, GK15, tolerance
# 1e-7, nsearchglobalpivot=10): tci_tpu's ranks series, linkdims and
# integral with its native-complex JaxBatchEvaluator on a CPU
CONFIG5_RANKS = [20, 14, 14, 14]
CONFIG5_LINKDIMS = [11, 13, 13, 13, 11]
CONFIG5_INTEGRAL = complex(-3.6613855919222135e-07, 2.3438439003099826e-06)
# BASELINE config 1 by rook (benchmarks/bench_rook.py: tolerance 1e-8,
# rng=default_rng(3)): tci_tpu's ranks and normalized errors series on a
# CPU, by tier: its engine under the default protocol ("loop") and the
# per-sweep one, both with engine._rng = default_rng(ROOK_ENGINE_SEED); the
# per-bond device tier ("fused", a JaxBatchEvaluator with the engine off);
# the host tier (a plain f, each bond's unseeded np.random.default_rng()
# seeded 100, 101, ... in call order). The host tier's last slabs are
# full-width, so it reports errors of 0, as tci_tpu's arrlu does. The
# per-bond tier's mixed-precision hunt reaches f32 noise on every bond,
# where tci_tpu's XLA rounds its Schur updates as fused multiply-adds and
# the port's kernel does not (ROADMAP C-port-12): its ranks are held to
# tci_tpu's, its errors only below the tolerance (the port's own series on
# a CPU, for comparison: ROOK_FUSED_PORT_CPU).
ROOK_ENGINE_SEED = 7
RECORDED_ROOK = {
    "loop": ([12, 12, 12], [7.464628007656804e-09, 4.3947705024251516e-09,
                            3.4479720682224794e-09]),
    "persweep": ([12, 12, 12], [7.464628007656804e-09,
                                4.3947705024251516e-09,
                                3.4479720682224794e-09]),
    "fused": ([12, 12, 12], [8.641446330961636e-09, 4.550498336257978e-09,
                             4.6149591864990894e-09]),
    "host": ([12, 12, 12], [0.0, 0.0, 0.0]),
}
# tci_tpu's samples of one config-1 rook run on the engine (both protocols)
RECORDED_ROOK_NEVALS = 1499313
ROOK_FUSED_PORT_CPU = [9.875491743545822e-09, 4.737983947981916e-09,
                       4.805100664102731e-09]
# phase 4i: tci_tpu's linkdims on a CPU for examples/04_contraction_mpo.py's
# operands (default_rng(42), legs (2, 2), tolerance 1e-10): zip-up and naive
# with jax_native=True at L = 20, chi = 16, and (complex_*) its (re, im) pair
# programs at L = 12, chi = 8; "TCI" (L = 20, chi = 8) is the product's
# exact ranks, min(4^n, 4^(L-n), 64), which tci_tpu's TCI was not run at
# this size on a CPU to record; and config 1's train compressed by
# compress_device at 1e-12
RECORDED_CONTRACT = {
    "zipup": [4, 16, 64] + [256] * 16,
    "naive": [4, 16, 64] + [256] * 13 + [64, 16, 4],
    "TCI": [4, 16] + [64] * 15 + [16, 4],
    "complex_zipup": [4, 16] + [64] * 9,
    "complex_naive": [4, 16] + [64] * 7 + [16, 4],
}
RECORDED_COMPRESS = [10, 12, 12, 12, 12, 12, 10]
# phase 4j: tci_tpu's crossinterpolate1 on a CPU. Config 1 (a plain scalar
# f, tolerance 1e-8): its ranks, normalized errors and linkdims. The
# reference notebook's random f (L = 20, d = 2, the table of 2^20
# uniform values on [-1, 1] from default_rng(0) looked up at
# sum_i sigma_i 2^i, tolerance 1e-12, maxiter = D) at D = 100: the sha256
# of its pivot lists (``pivot_digest``), its linkdims and its normalized
# errors (the ranks are 2 ... 100)
RECORDED_TCI1 = {
    "ranks": list(range(2, 14)),
    "errors": [
        0.09014423076923077, 0.017055168568467224, 0.005508312050368183,
        0.0019174480585510316, 0.00039917273375527154,
        6.851478376739689e-05, 2.8287547486967324e-05,
        2.0564525553645567e-06, 7.217604405702904e-07,
        1.1238586655054617e-07, 1.630523317340711e-08,
        4.522342590251166e-09],
    "linkdims": [10, 13, 13, 13, 13, 13, 10]}
# phase 4k (a): tci_tpu's config 1 resumed from its checkpoint, on a CPU: a
# JaxBatchEvaluator (its engine, default protocol) to tolerance 1e-4 with
# rng=default_rng(0), save_tci2, load_tci2, then optimize(f, tolerance=1e-8,
# rng=default_rng(0)) on the loaded object: its ranks and normalized errors
RECORDED_RESUME = {"ranks": [12, 12, 12],
                   "errors": [4.137521240320131e-09] * 3}
RECORDED_RANDOM100 = {
    "digest": ("e92d18d763f1feeb689bddcb346dd33b"
               "dd5e4e323bce82b478e4a9e6832fd9fd"),
    "linkdims": [2, 4, 8, 16, 32, 64] + [100] * 7 + [64, 32, 16, 8, 4, 2],
    "errors": [
        2.9922777463394716, 2.6229069481855185, 6.102626503826261,
        3.301441726503483, 3.002762005875192, 2.574544550920857,
        3.0128527436540744, 3.1315734295218296, 3.5686300895249268,
        3.009034789504231, 3.2931711793359715, 3.138927039961094,
        4.342292827007373, 4.623878575389225, 3.2972853274934617,
        3.6277186667945363, 3.7374101939845636, 4.360254101993475,
        4.371524778765975, 4.031729201937204, 4.127241744772615,
        3.7658343851987635, 5.161593714910839, 4.7935069847038365,
        5.041623951152127, 4.52089375455426, 4.632270961244834,
        3.873447646844354, 4.47979216290038, 4.198002100318495,
        4.322392752847635, 4.339079713815506, 5.3583421856764675,
        4.6084391655697186, 4.857726058792136, 5.380290353185926,
        4.642192299487151, 5.075865973133065, 4.7999392666786775,
        5.292623622656249, 4.536765908814284, 4.695069793467848,
        5.609744971905776, 4.985150893299772, 5.201170124597905,
        4.929729492979906, 5.654605141856713, 5.048580538381809,
        6.652054754011669, 5.235553010749866, 5.239484906230043,
        4.800711828106901, 5.856572154323269, 5.933717465091968,
        5.569352744796992, 6.1220617038517045, 6.090961345685612,
        6.303022292822201, 5.5811964415357505, 5.401492597243934,
        5.871290738975127, 5.812010820498179, 6.88004415614536,
        6.3504833577250315, 6.0430023251975715, 5.783503027208205,
        5.360278121483371, 8.680118952134446, 6.352852258459681,
        6.026072099200994, 6.816856016866159, 5.8411957599270945,
        6.015911870236721, 6.4566365146542495, 6.433641812210952,
        6.967322143972407, 6.352239231235693, 6.091798732846015,
        6.523754314476133, 7.01443525517652, 6.895557631369793,
        6.796112452399216, 5.858536881761068, 6.654012239366521,
        7.246384716006125, 6.1549440383713065, 7.073446053809968,
        6.243359805848743, 6.842724443182234, 7.360383907422525,
        6.7179004660645, 7.914724635933566, 8.093320849670457,
        7.241208571485706, 8.028267920940763, 7.334897232195648,
        6.609680671504698, 6.617901937252487, 6.50331334703237]}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main_panel(dtype, mp, m, n, rank, seed, dev):
    """An (mp, mp) panel on `dev`, zero but for a seeded (m, n) block of
    rank `rank` (complex: real and imaginary parts of that rank each)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, rank)) @ rng.standard_normal((rank, n))
    if dtype.is_complex:
        A = A + 1j * (rng.standard_normal((m, rank))
                      @ rng.standard_normal((rank, n)))
    P = torch.zeros((mp, mp), dtype=dtype, device=dev)
    P[:m, :n] = torch.as_tensor(A, device=dev)
    return P


def traced_kernels(fn, activities):
    """(name, microseconds) of every device kernel that fn() launched, from
    a torch.profiler trace of it."""
    import torch
    from torch.profiler import profile
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return [(e.get("name", ""), e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "kernel"]


# the cluster kernel's phases (kPhaseLoad ... kPhaseWrite in csrc/rrlu.cu);
# those of each pivot are printed a pivot
PHASES = ("setup+load", "first pass+publish", "barrier", "decision",
          "x/y", "pass", "publish", "flush+barrier", "write-out")
PER_PIVOT = {"barrier", "decision", "x/y", "pass", "publish"}


def run_phases(smi_line):
    """--phases: the cluster kernel built with -DRRLU_PHASE_CLOCKS, on
    config 1's, config 4's and config 5's bond panels at the [mode] rows'
    true extents and pivot counts: the SM cycles (clock64, thread 0 of each
    CTA) of each phase, the median of 10 launches, for CTA 0, the last CTA
    that holds rows and the largest over the CTAs; each launch bitwise its
    plain version. The instrumented cluster kernel's device time a launch
    (torch.profiler) sets the cycles against time."""
    import torch
    from torch.profiler import ProfilerActivity

    from tci_tpu_torch.ops import lu_cuda, lu_kernel
    dev = torch.device("cuda", 0)
    phased = lu_cuda._lib(("RRLU_PHASE_CLOCKS",))
    default_lib = lu_cuda._lib
    lu_cuda._lib = lambda: phased
    rows = {}
    try:
        for dtype, mp, m, n, k in ((torch.float64, 352, 132, 132, 12),
                                   (torch.float64, 512, 480, 480, 32),
                                   (torch.complex128, 512, 136, 271, 19)):
            P = main_panel(dtype, mp, m, n, 2 * k, mp, dev)
            C = lu_cuda.cluster_size(0, P.element_size())
            last = (m - 1) // -(-m // C)
            for lo in (True, False):
                args = (P, m, n, k, 1e-14, 0.0)
                ref = lu_kernel.rrlu_plain(*args, leftorthogonal=lo)
                runs = []
                for _ in range(10):
                    out = lu_cuda.rrlu_call(*args, leftorthogonal=lo,
                                            return_mode=True)
                    torch.cuda.synchronize()
                    if int(out[6]) != 1 or not all(
                            torch.equal(o, r) for o, r in zip(out, ref)):
                        fail(f"--phases {dtype} {mp}^2: not the cluster mode "
                             f"or not bitwise its plain version")
                    cyc = torch.zeros((16, len(PHASES)), dtype=torch.int64)
                    rc = phased.rrlu_phase_cycles_read(cyc.data_ptr())
                    if rc != 0:
                        fail(f"--phases: CUDA error {rc} reading the clocks")
                    runs.append(cyc[:C].to(torch.float64))
                cyc = torch.stack(runs).median(dim=0).values

                def launches():
                    for _ in range(20):
                        lu_cuda.rrlu_call(*args, leftorthogonal=lo)
                durs = [dur for name, dur in
                        traced_kernels(launches, [ProfilerActivity.CUDA])
                        if "rrlu_cluster_kernel" in name]
                if len(durs) != 20:
                    fail(f"--phases: {len(durs)} cluster kernels traced")
                ms = sum(durs) / 20 / 1e3

                def show(v):
                    return {p: round(float(c) / (k if p in PER_PIVOT else 1),
                                     1) for p, c in zip(PHASES, v)}
                tag = (f"{str(dtype)[6:]} {mp}^2 true {m}x{n} k={k} "
                       f"{'left' if lo else 'right'}")
                rows[tag] = {"C": C, "last_cta": last, "ms": ms,
                             "cta0": show(cyc[0]), "cta_last": show(cyc[last]),
                             "max": show(cyc.max(dim=0).values),
                             "cta0_total": float(cyc[0].sum())}
                print(f"[phases] {tag} (C = {C}; the instrumented cluster "
                      f"kernel {ms:.4f} ms a launch, profiler; CTA 0's "
                      f"phases sum to {float(cyc[0].sum()):.0f} cycles): "
                      f"cycles, those of "
                      f"each pivot a pivot: CTA 0 {rows[tag]['cta0']}; CTA "
                      f"{last} (the last with rows) {rows[tag]['cta_last']}; "
                      f"largest over the CTAs {rows[tag]['max']}", flush=True)
    finally:
        lu_cuda._lib = default_lib
    print(f"[phases] {json.dumps(rows)}", flush=True)
    print(smi_line, flush=True)


def mpo_operands(L, chi, seed=42):
    """Phase 4i's MPO operands (examples/04_contraction_mpo.py's: legs (2,
    2), default_rng(42)), as numpy cores."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def mpo():
        b = [1] + [chi] * (L - 1) + [1]
        return [rng.standard_normal((b[n], 2, 2, b[n + 1])) / np.sqrt(chi)
                for n in range(L)]
    return mpo(), mpo()


def config2_matrix(dev):
    """BASELINE config 2's matrix (benchmarks/bench_rrlu.py:96-133): 4096^2
    f64, U diag(exp(-j/16)) V of rank 256, from default_rng(4096)."""
    import numpy as np
    import torch
    N, R = 4096, 256
    rng = np.random.default_rng(4096)
    U = rng.standard_normal((N, R)) * np.exp(-np.arange(R) / 16.0)
    return torch.as_tensor(U @ rng.standard_normal((R, N)), device=dev)


def mesh_gloo_rank(rank, store, out):
    """Phase 4l (g): one of two gloo ranks on the one card, running config
    2's rrlu_sharded with the step kernel on half-height blocks, every
    launch checked against its plain version; the result goes to
    out/rank<r>.json."""
    import numpy as np
    import torch
    import torch.distributed as dist
    res = {}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=2)
        from tci_tpu_torch.ops import lu_kernel, lu_sharded
        from tci_tpu_torch.parallel.mesh import default_mesh
        mesh = default_mesh(2)
        A = config2_matrix(torch.device("cuda", 0))
        lu_sharded.CHECKS = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = lu_sharded.rrlu_sharded_raw(A, 256, 1e-10, 0.0, True, mesh=mesh)
        res["wall_s"] = time.perf_counter() - t0
        checks, lu_sharded.CHECKS = lu_sharded.CHECKS, None
        one = lu_kernel.rrlu_raw(A, 256, 1e-10, 0.0, True)
        res.update(
            k=s[3], same_order=bool(np.array_equal(s[1], one[1])
                                    and np.array_equal(s[2], one[2])
                                    and s[3] == one[3]),
            same_lu=bool(torch.equal(s[0], one[0])),
            launches=lu_sharded.LAUNCHES["lu_sharded_step"],
            checked=len(checks), all_equal=all(eq for _, eq, _ in checks),
            max_abs_err=max((e for _, _, e in checks), default=0.0),
            collectives=dict(lu_sharded.COLLECTIVES),
            backend=dist.get_backend(), mesh_size=mesh.size())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lu_sharded.rrlu_sharded_raw(A, 256, 1e-10, 0.0, True, mesh=mesh)
        res["warm_wall_s"] = time.perf_counter() - t0
        dist.destroy_process_group()
    except Exception:
        import traceback
        res["error"] = traceback.format_exc()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)


def run_mesh(here, smi_line):
    """Phase 4l: the multi-GPU layer on a one-rank NCCL mesh of the card
    (and two gloo ranks on it); returns the lu_sharded_step entry of the
    kernels JSON line. Every count is set to 0 just before the mesh path
    runs and read just after. The group goes when the phase ends or fails:
    a group left to the interpreter's exit, with CUDA graphs that hold its
    collectives, can hang it."""
    import torch.distributed as dist
    try:
        return _run_mesh(here, smi_line)
    finally:
        gc.collect()
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_mesh(here, smi_line):
    import numpy as np
    import torch
    import torch.distributed as dist
    import tci_tpu_torch
    from tci_tpu_torch.models import integration
    from tci_tpu_torch.models.tteval import (pad_cores, tt_evaluate_batched,
                                             tt_evaluate_sharded)
    from tci_tpu_torch.ops import lu_cuda, lu_kernel, lu_sharded
    from tci_tpu_torch.parallel import dryrun
    from tci_tpu_torch.parallel.mesh import default_mesh

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    HBM, PEAK64 = 3.35e12, 34e12  # H100 SXM data sheet (700 W)

    def say(msg):
        print(f"[mesh] {time.perf_counter() - t_phase:.1f} s {msg}",
              flush=True)

    def events_ms(fn, reps=1):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def med(xs):
        xs = sorted(xs)
        return (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2]) / 2

    # (a) a one-rank NCCL group on a file store in a temporary directory
    if dist.is_initialized():
        fail("4l: a process group exists before phase 4l")
    mesh = default_mesh(1)
    if dist.get_backend() != "nccl" or mesh.size() != 1:
        fail(f"4l (a): backend {dist.get_backend()}, {mesh.size()} ranks")
    say(f"4l (a): one-rank {dist.get_backend()} mesh {mesh} on "
          f"{torch.cuda.get_device_name(0)}")

    for counter in (lu_sharded.LAUNCHES, lu_sharded.COLLECTIVES,
                    lu_sharded.FLAG_READS, lu_sharded.PLAIN_CALLS,
                    lu_cuda.LAUNCHES):
        counter.clear()
    entry = {"launches_by_path": {}}
    all_checks = []

    def step_launches():
        return lu_sharded.LAUNCHES["lu_sharded_step"]

    # (b) config 2 through rrlu_sharded: cold with every launch checked
    A = config2_matrix(dev)
    N, R = A.shape[0], 256
    lu_sharded.CHECKS = []
    s = lu_sharded.rrlu_sharded_raw(A, R, 1e-10, 0.0, True, mesh=mesh)
    checks, lu_sharded.CHECKS = lu_sharded.CHECKS, None
    all_checks += checks
    entry["launches_by_path"]["4l_config2"] = step_launches()
    coll = dict(lu_sharded.COLLECTIVES)
    reads = lu_sharded.FLAG_READS["stop"]
    one = lu_kernel.rrlu_raw(A, R, 1e-10, 0.0, True)
    k = s[3]
    if not (k == one[3] == R and np.array_equal(s[1], one[1])
            and np.array_equal(s[2], one[2])):
        fail(f"4l (b): the sharded pivot order is not the one-device "
             f"kernel's (k {k} / {one[3]})")
    if not (torch.equal(s[0], one[0]) and np.array_equal(s[4], one[4])
            and s[5] == one[5]):
        fail("4l (b): the sharded LU buffer, pivots or err differ from the "
             "one-device kernel's")
    if (not checks or len(checks) != step_launches()
            or not all(eq for _, eq, _ in checks)):
        fail(f"4l (b): {sum(not eq for _, eq, _ in checks)} of {len(checks)} "
             f"checked step-kernel launches differ from the plain version "
             f"({step_launches()} launches)")
    steps = (step_launches() - 1) // 3
    # warm times, events around whole calls (host included: each step is
    # queued from the host), against the one-device kernel in the same call
    Ap = torch.zeros_like(A)
    Ap.copy_(A)
    t_mesh = [events_ms(lambda: lu_sharded.rrlu_panel_sharded(
        Ap, N, N, R, 1e-10, 0.0, leftorthogonal=True, mesh=mesh))
        for _ in range(3)]
    t_one = [events_ms(lambda: lu_cuda.rrlu_call(
        Ap, N, N, R, 1e-10, 0.0, leftorthogonal=True)) for _ in range(3)]
    # the step kernel alone: the call's 256 steps of the three kernels
    # queued back to back on one rank (no collective is needed on one rank)
    st = lu_sharded._State(Ap.clone(), 0, N, N, N, 1e-10, 0.0, True)

    def kernel_steps():
        lu_sharded._launch(st, 0)
        for _ in range(R):
            for phase in (1, 2, 3):
                lu_sharded._launch(st, phase)
    kernel_ms = events_ms(kernel_steps)
    if int(st.ist[0]) != R:
        fail(f"4l (b): the kernel-only steps took {int(st.ist[0])} pivots")
    st = lu_sharded._State(Ap.clone(), 0, N, N, N, 1e-10, 0.0, True)
    lu_sharded._launch(st, 0)
    pick_us = events_ms(lambda: lu_sharded._launch(st, 1), 50) * 1e3
    lu_sharded._launch(st, 2)
    update_us = events_ms(lambda: lu_sharded._launch(st, 3), 20) * 1e3
    # the plain version of a whole call on the card (its three phases in
    # torch operations), once
    phase_fn = lu_sharded._phase
    lu_sharded._phase = lu_sharded._plain
    try:
        plain_ms = events_ms(lambda: lu_sharded.rrlu_panel_sharded(
            Ap, N, N, R, 1e-10, 0.0, leftorthogonal=True, mesh=mesh))
    finally:
        lu_sharded._phase = phase_fn
    # the bound: the rank's live block read and written once a step, or
    # two operations an element of it, whichever is larger (f64, 8 bytes)
    live = [(N - j) * (N - j) for j in range(k)]
    t_bytes = sum(16.0 * e for e in live) / HBM * 1e3
    t_ops = sum(2.0 * (N - 1 - j) * (N - 1 - j) for j in range(k)) \
        / PEAK64 * 1e3
    bound = max(t_bytes, t_ops)
    entry.update(
        ms=kernel_ms, ms_from="cuda events around the call's 769 launches "
        "queued back to back", plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        steps=steps, collectives_per_step=3, collectives=coll,
        flag_reads=reads, dead_steps=steps - k,
        call_ms=med(t_mesh), call_ms_all=t_mesh,
        one_device_ms=med(t_one), one_device_ms_all=t_one,
        pick_us=pick_us, update_us_step0=update_us,
        step_us=kernel_ms / steps * 1e3 if steps else None)
    say(f"4l (b) config 2 rrlu_sharded (4096^2 f64, rank {k}, one "
          f"NCCL rank): pivot order, npivot, err and LU buffer bitwise the "
          f"one-device kernel's; {entry['launches_by_path']['4l_config2']} "
          f"step-kernel launches ({steps} steps x 3 + 1), every one bitwise "
          f"its plain version; collectives {json.dumps(coll)}, {reads} stop-"
          f"flag reads, {steps - k} dead steps; call (events, median of 3) "
          f"{entry['call_ms']:.3f} ms {[round(t, 3) for t in t_mesh]} against "
          f"the one-device kernel {entry['one_device_ms']:.3f} ms "
          f"{[round(t, 3) for t in t_one]}; the step kernel alone "
          f"{kernel_ms:.3f}"
          f" ms a call ({entry['step_us']:.2f} us a step; pick {pick_us:.2f} "
          f"us, update at step 0 {update_us:.2f} us); bound {bound:.4f} ms "
          f"({entry['bound_by']}; bytes {t_bytes:.4f}, operations "
          f"{t_ops:.4f}); plain version {plain_ms:.3f} ms")

    # (c) config 1 through crossinterpolate2 on the mesh, default protocol
    localdims = [10] * 8

    def fdev(idx):
        v = idx.to(torch.float64) + 1.0
        return 1.0 / (1.0 + (v * v).sum(dim=1))

    def solve1(f):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tci, ranks, errors = tci_tpu_torch.crossinterpolate2(
            np.float64, f, localdims, tolerance=1e-8,
            rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        return tci, ranks, errors, time.perf_counter() - t0

    runs = {}
    for tag, m in (("mesh", mesh), ("one", None)):
        f = tci_tpu_torch.TorchBatchEvaluator(fdev, localdims, mesh=m)
        cold = solve1(f)
        n_cold = f.nevals
        walls = []
        for _ in range(10):
            f.reset_nevals()
            walls.append(solve1(f)[3])
        eng = f.device_sweep_engine
        runs[tag] = dict(res=cold, nevals=n_cold, warm=walls, f=f,
                         captures=eng.captures, replays=eng.replays,
                         declined=dict(eng.declined))
    rm, ro = runs["mesh"], runs["one"]
    if rm["declined"] or not rm["captures"] or not rm["replays"]:
        fail(f"4l (c): the mesh engine declined {rm['declined']}, "
             f"{rm['captures']} captures, {rm['replays']} replays")
    if not (rm["res"][1] == ro["res"][1] == RECORDED_RANKS
            and rm["res"][2] == ro["res"][2]
            and rm["nevals"] == ro["nevals"]):
        fail(f"4l (c): mesh ranks {rm['res'][1]} errors {rm['res'][2]} "
             f"nevals {rm['nevals']} against one device {ro['res'][1]} "
             f"{ro['res'][2]} {ro['nevals']}")
    if not np.allclose(rm["res"][2], RECORDED_ERRORS, rtol=0, atol=1e-15):
        fail(f"4l (c): errors {rm['res'][2]} against tci_tpu's "
             f"{RECORDED_ERRORS}")
    entry["config1"] = {t: {"cold_s": r["res"][3], "warm_median_s":
                            med(r["warm"]), "warm_s": r["warm"],
                            "captures": r["captures"],
                            "nevals": r["nevals"]} for t, r in runs.items()}
    say(f"4l (c) config 1 on the mesh (default protocol, the "
          f"all-gather inside the engine's graphs: {rm['captures']} captures,"
          f" {rm['replays']} replays, none declined): ranks, errors and "
          f"nevals ({rm['nevals']}) bit for bit the one-device run's and "
          f"tci_tpu's series; cold {rm['res'][3]:.4f} s / one device "
          f"{ro['res'][3]:.4f} s; warm median of 10 {med(rm['warm']):.4f} s "
          f"/ one device {med(ro['warm']):.4f} s")

    # (d) config 4's integrate(torch_native=True) on the mesh
    def f4(X):
        return 1000 * torch.cos(10 * (X ** 2).sum(dim=1)) * torch.exp(
            -X.sum(dim=1) ** 4 / 1000)

    vals = {}
    for tag, m in (("mesh", mesh), ("one", None)):
        t0 = time.perf_counter()
        vals[tag] = tci_tpu_torch.integrate(
            np.float64, f4, [-1.0] * 10, [1.0] * 10, GKorder=15,
            tolerance=1e-8, maxbonddim=64, torch_native=True, mesh=m,
            rng=np.random.default_rng(0))
        vals[tag + "_s"] = time.perf_counter() - t0
    if (vals["mesh"] != vals["one"]
            or abs(vals["one"] - CONFIG4_INTEGRAL) > 1e-3):
        fail(f"4l (d): mesh integral {vals['mesh']!r}, one device "
             f"{vals['one']!r}, tci_tpu {CONFIG4_INTEGRAL}")
    entry["config4"] = vals
    say(f"4l (d) config 4 integrate on the mesh: {vals['mesh']!r}, "
          f"bitwise the one-device integral (tolerance: bitwise), "
          f"{abs(vals['one'] - CONFIG4_INTEGRAL):.3e} from tci_tpu's; "
          f"{vals['mesh_s']:.3f} s / one device {vals['one_s']:.3f} s (new "
          f"evaluators)")

    # (e) zip-up at L = 20, chi = 16 (phase 4i's operands) and config 1's
    # train compressed, on the mesh; every step-kernel launch checked
    a20, b20 = mpo_operands(20, 16)
    TT = tci_tpu_torch.TensorTrain

    def zipup(m):
        return tci_tpu_torch.contract(
            TT(a20), TT(b20), algorithm="zipup", method="LU",
            tolerance=1e-10, torch_native=True, mesh=m)

    def same_cores(a, b):
        return a.linkdims() == b.linkdims() and all(
            torch.equal(x, y) for x, y in zip(a.sitetensors(),
                                               b.sitetensors()))

    before = step_launches()
    lu_sharded.CHECKS = []
    zm = zipup(mesh)
    checks, lu_sharded.CHECKS = lu_sharded.CHECKS, None
    all_checks += checks
    entry["launches_by_path"]["4l_zipup"] = step_launches() - before
    z1 = zipup(None)
    if not same_cores(zm, z1) or zm.linkdims() != RECORDED_CONTRACT["zipup"]:
        fail(f"4l (e): mesh zip-up linkdims {zm.linkdims()}, not bitwise the "
             f"device tier's")
    if (len(checks) != entry["launches_by_path"]["4l_zipup"]
            or not all(eq for _, eq, _ in checks)):
        fail("4l (e): a zip-up step-kernel launch differs from its plain "
             "version or went unchecked")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zipup(mesh)
    torch.cuda.synchronize()
    zm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    zipup(None)
    torch.cuda.synchronize()
    z1_s = time.perf_counter() - t0
    tt1 = tci_tpu_torch.tensortrain(rm["res"][0])
    before = step_launches()
    lu_sharded.CHECKS = []
    cm = tt1.copy()
    cm.compress("LU", tolerance=1e-12, torch_native=True, mesh=mesh)
    checks, lu_sharded.CHECKS = lu_sharded.CHECKS, None
    all_checks += checks
    entry["launches_by_path"]["4l_compress"] = step_launches() - before
    c1 = tt1.copy()
    c1.compress("LU", tolerance=1e-12, torch_native=True)
    if not same_cores(cm, c1) or cm.linkdims() != RECORDED_COMPRESS:
        fail(f"4l (e): mesh compression linkdims {cm.linkdims()}, not bitwise "
             f"the device tier's")
    if (len(checks) != entry["launches_by_path"]["4l_compress"]
            or not all(eq for _, eq, _ in checks)):
        fail("4l (e): a compression step-kernel launch differs from its "
             "plain version or went unchecked")
    entry["zipup"] = {"mesh_s": zm_s, "one_s": z1_s,
                      "launches": entry["launches_by_path"]["4l_zipup"]}
    say(f"4l (e) zip-up L = 20, chi = 16 on the mesh: linkdims and "
          f"cores bitwise the device tier's ({zm.linkdims()[:4]} ...), "
          f"{entry['launches_by_path']['4l_zipup']} step-kernel launches "
          f"checked; warm {zm_s:.4f} s / one device {z1_s:.4f} s; config 1's "
          f"train compressed on the mesh: linkdims {cm.linkdims()}, cores "
          f"bitwise, {entry['launches_by_path']['4l_compress']} launches "
          f"checked")

    # (f) tt_evaluate_sharded, dryrun.run(1), ex06 as its own process
    cores = pad_cores(tt1.sitetensors())
    idx = torch.as_tensor(np.random.default_rng(7).integers(
        0, 10, (10**4, 8)), device=cores.device)
    if not torch.equal(tt_evaluate_sharded(cores, idx, mesh),
                       tt_evaluate_batched(cores, idx)):
        fail("4l (f): tt_evaluate_sharded differs from tt_evaluate_batched")
    t0 = time.perf_counter()
    line = dryrun.run(1)
    dry_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m",
             "tci_tpu_torch.examples.ex06_multichip_mesh"],
            cwd=here, capture_output=True, text=True, timeout=180)
    except subprocess.TimeoutExpired as e:
        fail(f"4l (f) ex06: no end in 180 s; stdout {str(e.stdout)[-2000:]!r}"
             f", stderr {str(e.stderr)[-2000:]!r}")
    ex06_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or lines[-1] != "ok":
        fail(f"4l (f) ex06: exit {proc.returncode}, stdout "
             f"{proc.stdout[-2000:]!r}, stderr {proc.stderr[-2000:]!r}")
    entry.update(dryrun_s=dry_s, ex06_s=ex06_s)
    say(f"4l (f) tt_evaluate_sharded at 10^4 points bitwise; "
          f"{line} ({dry_s:.3f} s); ex06 ok in {ex06_s:.3f} s (process "
          f"included): " + " | ".join(lines[:-1])[:300])

    # the counts of the mesh path, read just after it: the launches of its
    # runs (each checked), not of the timing runs between them
    launches = sum(entry["launches_by_path"].values())
    # the graphs that hold NCCL collectives go before the group
    integration._GK_EVAL_CACHE.pop(f4, None)
    del runs, rm, ro, f
    gc.collect()
    torch.cuda.synchronize()
    if launches == 0 or launches != len(all_checks):
        fail(f"4l: {launches} step-kernel launches on the mesh path, "
             f"{len(all_checks)} checked")
    entry.update(launches=launches, checked=len(all_checks),
                 max_abs_err=max(e for _, _, e in all_checks))
    dist.destroy_process_group()

    # (g) two gloo ranks on the one card (the card's torch lets gloo
    # all-reduce CUDA tensors): config 2 on half-height blocks
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=mesh_gloo_rank,
                         args=(r, os.path.join(tmp, "store"), tmp))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    ranks = []
    for r in range(2):
        path = os.path.join(tmp, f"rank{r}.json")
        if not os.path.exists(path):
            fail(f"4l (g): gloo rank {r} left no result")
        with open(path) as fh:
            ranks.append(json.load(fh))
    shutil.rmtree(tmp, ignore_errors=True)
    for r, res in enumerate(ranks):
        if "error" in res:
            fail(f"4l (g): gloo rank {r}: {res['error']}")
        if not (res["same_order"] and res["same_lu"] and res["all_equal"]
                and res["checked"] == res["launches"] > 0):
            fail(f"4l (g): gloo rank {r}: {res}")
    entry["gloo_two_ranks"] = ranks
    say(f"4l (g) two gloo ranks on one card, config 2 on 2048 x "
          f"4096 blocks: pivot order and LU buffer bitwise the one-device "
          f"kernel's on both ranks, {ranks[0]['launches']} launches a rank, "
          f"each bitwise its plain version; cold {ranks[0]['wall_s']:.3f} / "
          f"{ranks[1]['wall_s']:.3f} s, warm {ranks[0]['warm_wall_s']:.3f} / "
          f"{ranks[1]['warm_wall_s']:.3f} s (gloo's all-reduce of CUDA "
          f"tensors goes through the host)")
    entry["phase_s"] = time.perf_counter() - t_phase
    print(f"[mesh] 4l: {entry['phase_s']:.3f} s in all", flush=True)
    return {"name": "lu_sharded_step", "route": "cuda",
            "source": "tci_tpu_torch/csrc/lu_sharded.cu",
            "replaces": "tci_tpu/ops/lu_sharded.py:59",
            "launches": entry.pop("launches"),
            "max_abs_err": entry.pop("max_abs_err"),
            "ms": entry.pop("ms"), "plain_ms": entry.pop("plain_ms"),
            "bound_ms": entry.pop("bound_ms"),
            "bound_by": entry.pop("bound_by"), "library_ms": None,
            **entry}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="also profile configs 1, 3 and 4 and write their traces "
                        "here")
    parser.add_argument("--phases", action="store_true",
                        help="only time the phases of the rrLU kernel's "
                        "cluster mode (an instrumented build) and exit")
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
    from tci_tpu_torch.ops import (_build, lu as lu_mod, lu_cuda, lu_kernel,
                                   lu_sharded, probe_batched)

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
    _build.build(["rrlu", "probe_batched", "lu_sharded"])
    lu_cuda._lib()
    probe_batched._lib()
    lu_sharded._lib()
    print(f"[build] rrlu.cu, probe_batched.cu and lu_sharded.cu, in "
          f"parallel: {time.perf_counter() - t0:.3f} s (nvcc: rrlu "
          f"{_build.BUILD_SECONDS['rrlu']:.3f} s, probe_batched "
          f"{_build.BUILD_SECONDS['probe_batched']:.3f} s, lu_sharded "
          f"{_build.BUILD_SECONDS['lu_sharded']:.3f} s)", flush=True)
    if opts.phases:
        run_phases(smi_line)
        return
    # the rrLU kernel's cluster mode: CTAs a cluster for each element size
    # (16 where cudaOccupancyMaxActiveClusters can place one such cluster
    # at the largest shared memory a CTA may take, else 8)
    cluster_cfg = {"C": {str(dt)[6:]: lu_cuda.cluster_size(0, es)
                         for dt, es in ((torch.float32, 4),
                                        (torch.float64, 8),
                                        (torch.complex128, 16))}}
    print(f"[cluster] rrLU cluster mode: CTAs a cluster {cluster_cfg['C']} "
          f"(the rule: 16 where the card can schedule a 16-CTA cluster, "
          f"else 8)", flush=True)

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

    def graph_ms(fn, reps):
        """Device time of one fn() call: CUDA events around the replay of a
        CUDA graph that holds `reps` calls, so no host time lies between
        them (fn must be safe to record: every wrapper here is)."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def kernel_device_ms(fn, reps, match="rrlu", by_name=False):
        """Mean device time per launch of the kernels whose name holds
        `match` over `reps` calls of fn, from a torch.profiler trace (host
        time excluded); None when the trace holds no such kernel. An rrLU
        launch is a call of the wrapper (lu_cuda.LAUNCHES): where a call
        runs the cluster kernel and then the grid kernel, both count in its
        time. With by_name, also each kernel's share a launch, in us."""
        from torch.profiler import ProfilerActivity
        fn()
        torch.cuda.synchronize()

        def calls():
            for _ in range(reps):
                fn()
        before = lu_cuda.LAUNCHES["rrlu"]
        found = [(name, dur) for name, dur in
                 traced_kernels(calls, [ProfilerActivity.CUDA])
                 if match in name]
        durs = [dur for _, dur in found]
        nlaunch = (lu_cuda.LAUNCHES["rrlu"] - before if match == "rrlu"
                   else len(durs))
        ms = sum(durs) / nlaunch / 1e3 if durs and nlaunch else None
        if not by_name:
            return ms
        names = {}
        for name, dur in found:
            hit = re.search(r"rrlu_\w*kernel", name)
            key = hit.group(0) if hit else name
            names[key] = names.get(key, 0.0) + dur / max(nlaunch, 1)
        return ms, names

    # NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3; 34 TFLOP/s f64 and
    # 67 TFLOP/s f32 outside the tensor cores (the rates of a 700 W card);
    # a complex128 element (16 bytes) computes at the f64 rate
    HBM_BYTES_PER_S = 3.35e12
    PEAK_FLOP_PER_S = {16: 34e12, 8: 34e12, 4: 67e12}

    def bound_parts(mp, npd, m, n, k, elsize):
        """The two lower bounds of one elimination, in ms: each input byte
        read once and each output byte written once (the panel in; the LU
        buffer, both permutations, mags, k and err out) over the HBM rate,
        and the Schur updates this run's k needs, c sum_{j<k} (m-1-j)(n-1-j)
        real operations, over the peak rate: c = 2 for a real update (a
        multiply and a subtract), 8 for a complex one (four multiplies and
        two adds for the product, two subtracts). A complex panel's mags
        and err are real float64."""
        real = min(elsize, 8)
        nbytes = (2 * mp * npd * elsize + 8 * (mp + npd + 1)
                  + real * (min(mp, npd) + 1))
        c = 8.0 if elsize == 16 else 2.0
        ops = sum(c * (m - 1 - j) * (n - 1 - j) for j in range(k))
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

    # complex128: Lorentzian-times-phase panels at the bucket sizes (config
    # 1's panel shapes, each entry turned by a phase of its row and its
    # column, so the magnitudes keep the real panel's ties), both
    # orientations and both stops, each with the mode it takes (a complex
    # panel is resident up to 128 KB: 80^2 is, 96^2 is not); four 128^2
    # panels in one launch, a cluster each; N = 1000 of rank 100
    def lorentzian_phase(nI, nJ, seed):
        A = lorentzian(nI, nJ, seed)
        m, n = A.shape
        return A * np.exp(1j * (0.3 * np.arange(m)[:, None]
                                + 0.7 * np.arange(n)[None, :]))

    complex_panels = {}
    for nI, nJ in shapes:
        if nI is None:
            rng = np.random.default_rng(3)
            A = ((rng.standard_normal((5, 3)) + 1j * rng.standard_normal(
                (5, 3))) @ rng.standard_normal((3, 6)))
        else:
            A = lorentzian_phase(nI, nJ, seed=10 * nI + nJ)
        m, n = A.shape
        P = padded(A, torch.complex128)
        mode = lu_cuda.PANEL_MODES[int(lu_cuda.rrlu_call(
            P, m, n, 1, 0.0, 0.0, leftorthogonal=True,
            return_mode=True)[6])]
        stops = [("abstol", 1e-14, 1e-8 * float(np.abs(A).max()))]
        if m >= 40:
            stops.append(("reltol", 1e-6, 0.0))
        for stop, reltol, abstol in stops:
            for leftorth in (True, False):
                args = (P, m, n, min(m, n), reltol, abstol)
                kw = {"leftorthogonal": leftorth}
                out = lu_cuda.rrlu_call(*args, **kw)
                ref = lu_kernel.rrlu_plain(*args, **kw)
                tag = (f"complex128 {m}x{n} (bucket {P.shape[0]}x"
                       f"{P.shape[1]}, {mode}) {stop} "
                       f"{'left' if leftorth else 'right'}")
                max_err = max(max_err, compare(tag, out, ref, 1.0))
                k = int(out[3])
                ms = cuda_ms(lambda: lu_cuda.rrlu_call(*args, **kw), 20)
                dms = kernel_device_ms(
                    lambda: lu_cuda.rrlu_call(*args, **kw), 20)
                pms = cuda_ms(lambda: lu_kernel.rrlu_plain(*args, **kw), 5)
                bms, bby = bound_ms(*P.shape, m, n, k, 16)
                complex_panels[f"{P.shape[0]}x{P.shape[1]} {stop} "
                               f"{'left' if leftorth else 'right'}"] = {
                    "mode": mode, "k": k, "ms": dms, "wrapper_ms": ms,
                    "plain_ms": pms, "bound_ms": bms, "bound_by": bby}
                dev_txt = ("not measured" if dms is None
                           else f"{dms:.4f} ms")
                print(f"[kernel] {tag}: k={k} identical; kernel device "
                      f"time {dev_txt} a launch (profiler), wrapper call "
                      f"{ms:.4f} ms (events), plain {pms:.4f} ms, bound "
                      f"{bms:.6f} ms ({bby})", flush=True)
    Ab = torch.stack([padded(lorentzian_phase(12, 12, seed=s),
                             torch.complex128) for s in range(4)])
    bargs = (Ab, mt, nt, mr, rt, at)
    for leftorth in (True, False):
        out = lu_cuda.rrlu_batched(*bargs, leftorthogonal=leftorth)
        ref = lu_kernel.rrlu_plain_batched(*bargs, leftorthogonal=leftorth)
        max_err = max(max_err, compare(
            f"batched B=4 complex128 {'left' if leftorth else 'right'}",
            out, ref, 1.0))
    ms = cuda_ms(lambda: lu_cuda.rrlu_batched(*bargs, leftorthogonal=True),
                 20)
    dms = kernel_device_ms(
        lambda: lu_cuda.rrlu_batched(*bargs, leftorthogonal=True), 20)
    pms = cuda_ms(
        lambda: lu_kernel.rrlu_plain_batched(*bargs, leftorthogonal=True), 3)
    parts = [bound_parts(128, 128, int(mt[b]), int(nt[b]), int(out[3][b]),
                         16) for b in range(4)]
    t_b, t_o = (sum(p[i] for p in parts) for i in (0, 1))
    complex_panels["batched B=4 128x128"] = {
        "k": out[3].tolist(), "ms": dms, "wrapper_ms": ms, "plain_ms": pms,
        "bound_ms": max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations"}
    print(f"[kernel] batched B=4 complex128 128x128 (cluster): k="
          f"{out[3].tolist()} identical, both orientations; kernel device "
          f"time {'not measured' if dms is None else f'{dms:.4f} ms'} a "
          f"launch (profiler), wrapper call {ms:.4f} ms (events), plain "
          f"{pms:.4f} ms, bound {max(t_b, t_o):.6f} ms", flush=True)
    rng = np.random.default_rng(1000)

    def cgauss(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    A = torch.as_tensor(cgauss(1000, 100) @ cgauss(100, 1000), device=dev)
    P = padded(A, torch.complex128)
    args = (P, 1000, 1000, 1000, 1e-12, 0.0)
    out = lu_cuda.rrlu_call(*args, leftorthogonal=True)
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=True)
    max_err = max(max_err, compare("rrlu N=1000 complex128", out, ref, 1.0))
    k = int(out[3])
    lu = tci_tpu_torch.rrlu(A, reltol=1e-12)
    rec = float((lu.left() @ lu.right() - A).abs().max())
    if k != 100 or lu.npivots() != 100 or not rec < 1e-8 * float(
            A.abs().max()):
        fail(f"rrlu N=1000 complex128: npivot {k} / {lu.npivots()}, "
             f"reconstruction {rec}")
    kms = cuda_ms(lambda: lu_cuda.rrlu_call(*args, leftorthogonal=True), 3)
    pms = cuda_ms(lambda: lu_kernel.rrlu_plain(*args, leftorthogonal=True), 3)
    bms, bby = bound_ms(*P.shape, 1000, 1000, k, 16)
    complex_panels["N=1000 rank 100"] = {
        "k": k, "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": bby}
    print(f"[kernel] rrlu N=1000 complex128 rank {k} (bucket {P.shape[0]}): "
          f"identical; kernel {kms:.3f} ms (events), plain {pms:.3f} ms, "
          f"bound {bms:.4f} ms ({bby}), |LU - A| {rec:.3e}", flush=True)

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
        out = lu_cuda.rrlu_call(*args, leftorthogonal=True, return_mode=True)
        ref = lu_kernel.rrlu_plain(*args, leftorthogonal=True)
        max_err = max(max_err, compare(f"mode table {N}^2", out[:6], ref,
                                       1.0))
        mode = lu_cuda.PANEL_MODES[int(out[6])]
        kms = cuda_ms(lambda: lu_cuda.rrlu_call(*args, leftorthogonal=True), 3)
        pms = cuda_ms(lambda: lu_kernel.rrlu_plain(*args, leftorthogonal=True),
                      3)
        print(f"[mode] f64 {N}x{N} rank {int(out[3])}: {mode}, kernel "
              f"{kms:.4f} ms, plain {pms:.4f} ms (identical)", flush=True)

    # the main path's panels above the resident limit, at their true
    # extents and pivot counts (config 1's bond panel, config 4's at Imax 32
    # and 64, config 5's complex one; a batched fill-sized complex launch):
    # the mode the kernel reports, the cluster size, the device time a
    # launch and how the cluster and grid kernels share it, the bound, the
    # plain version's time
    mode_rows = []

    for dtype, mp, m, n, k, B in (
            (torch.float64, 352, 132, 132, 12, 1),
            (torch.float64, 512, 480, 480, 32, 1),
            (torch.complex128, 512, 136, 271, 19, 1),
            (torch.float64, 1024, 960, 960, 44, 1),
            (torch.complex128, 128, 120, 120, 30, 4)):
        A = torch.stack([main_panel(dtype, mp, m - b, n, 2 * k, mp + b, dev)
                         for b in range(B)])
        bargs = (A, torch.tensor([m - b for b in range(B)], device=dev),
                 n, k, 1e-14, 0.0)
        out = lu_cuda.rrlu_batched(*bargs, leftorthogonal=True,
                                   return_mode=True)
        ref = lu_kernel.rrlu_plain_batched(*bargs, leftorthogonal=True)
        tag = f"{str(dtype)[6:]} {B} x {mp}^2 true {m}x{n} k={k}"
        max_err = max(max_err, compare(f"[mode] {tag}", out[:6], ref, 1.0))
        modes = [lu_cuda.PANEL_MODES[v] for v in out[6].tolist()]
        C = cluster_cfg["C"][str(dtype)[6:]]
        dms, names = kernel_device_ms(
            lambda: lu_cuda.rrlu_batched(*bargs, leftorthogonal=True), 20,
            by_name=True)
        ms_from = "profiler"
        if dms is None:
            # the trace held no rrLU kernel (torch.profiler misses the
            # cluster kernel at times, PERF.md §7): time with events
            ms_from = "events around a CUDA graph of 20 launches"
            dms = graph_ms(
                lambda: lu_cuda.rrlu_batched(*bargs, leftorthogonal=True),
                20)
        pms = cuda_ms(
            lambda: lu_kernel.rrlu_plain_batched(*bargs, leftorthogonal=True),
            3)
        parts = [bound_parts(mp, mp, m - b, n, int(out[3][b]),
                             A.element_size()) for b in range(B)]
        t_b, t_o = (sum(p[i] for p in parts) for i in (0, 1))
        bms, bby = max(t_b, t_o), "bytes" if t_b >= t_o else "operations"
        row = {"shape": tag, "mode": modes, "C": C,
               "plan": lu_cuda.host_mode(0, mp, mp, dtype), "ms": dms,
               "ms_from": ms_from,
               "kernels_us": names, "bound_ms": bms, "bound_by": bby,
               "plain_ms": pms, "k": out[3].tolist()}
        mode_rows.append(row)
        print(f"[mode] {tag}: {modes} ({row['plan']} launch, C = {C}), "
              f"kernel device time {dms:.4f} ms a launch ({ms_from}; us by "
              f"kernel {json.dumps({k2: round(v, 3) for k2, v in names.items()})}), "
              f"bound {bms:.6f} ms ({bby}), plain {pms:.4f} ms, identical",
              flush=True)

    # the cluster mode's split on config 1's bond panel (352^2, 132^2 true,
    # full rank): device time with the rank capped at 0, 1, 2, 4, 12, 32, 64
    P = main_panel(torch.float64, 352, 132, 132, 132, 7, dev)
    ctimes = {}
    for cap in (0, 1, 2, 4, 12, 32, 64):
        ctimes[cap] = kernel_device_ms(
            lambda: lu_cuda.rrlu_call(P, 132, 132, cap, 0.0, 0.0,
                                      leftorthogonal=True), 20)
    split_from = "profiler"
    if any(t is None for t in ctimes.values()):
        # the trace held no cluster kernel (torch.profiler misses it at
        # times, PERF.md §7): time each cap with events instead
        split_from = "events around a CUDA graph of 20 launches"
        ctimes = {cap: graph_ms(
            lambda cap=cap: lu_cuda.rrlu_call(P, 132, 132, cap, 0.0, 0.0,
                                              leftorthogonal=True), 20)
                  for cap in ctimes}
    cluster_split = {"fixed_us": ctimes[0] * 1e3, "from": split_from,
                     "per_pivot_us": (ctimes[64] - ctimes[0]) / 64 * 1e3,
                     "by_cap_us": {c: t * 1e3 for c, t in ctimes.items()}}
    print(f"[split] cluster f64 132x132 (bucket 352x352) device time by "
          f"rank cap ({split_from}): " + ", ".join(f"{c}: {t * 1e3:.2f} us"
                                    for c, t in ctimes.items())
          + f"; fixed {cluster_split['fixed_us']:.2f} us, "
          f"{cluster_split['per_pivot_us']:.3f} us a pivot", flush=True)

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
    # phase 3d factorizes the same matrix by rook
    config2_A, config2_k = A, k

    # -- 3c. the batched-grid probes -------------------------------------------
    # the probe as its user runs it, with every count set to 0 just before
    probe_batched.LAUNCHES.clear()
    lu_cuda.LAUNCHES.clear()
    lu_kernel.PLAIN_CALLS.clear()
    probes_out = probe_batched.run_probes(dev)
    torch.cuda.synchronize()
    probe_launches = dict(probe_batched.LAUNCHES)
    probe_rrlu_launches = lu_cuda.LAUNCHES["rrlu"]
    print("[probes] " + json.dumps(probes_out), flush=True)
    expected = [[0, 1, 2, 3], [0, 6, 12, 18], [0, 3, 6, 9], [1, 3, 6, 10],
                [1.0, 3.0, 5.0, 7.0], [2, 3, 4, 5], 32, [32, 32, 32, 32]]
    if not all(step["ok"] for step in probes_out.values()) or [
            step["check"] for step in probes_out.values()] != expected:
        fail(f"run_probes: a step failed or printed other values than "
             f"{expected}")
    if (probe_launches != {name: 1 for name in probe_batched.NAMES}
            or probe_rrlu_launches != 2
            or lu_kernel.PLAIN_CALLS["cuda"] != 0):
        fail(f"run_probes: probe launches {probe_launches}, rrLU launches "
             f"{probe_rrlu_launches}, plain calls on CUDA "
             f"{lu_kernel.PLAIN_CALLS['cuda']}; expected 1 each, 2 and 0")

    def probe_call(fn, name, B, n, s):
        if name == "v1":
            return (fn(B, dev),)
        return (fn(s),) if name == "v2" else fn(s, n)

    probe_entries = []
    for name in probe_batched.NAMES:
        wrapper, plain = probe_batched.PROBES[name]
        err = 0.0
        for which in ("probe", "second"):
            B, n, s = probe_batched.check_inputs(name, which, dev)
            before = probe_batched.LAUNCHES[name]
            out = probe_call(wrapper, name, B, n, s)
            torch.cuda.synchronize()
            ref = probe_call(plain, name, B, n, s)
            if probe_batched.LAUNCHES[name] != before + 1:
                fail(f"probe {name}: the wrapper did not launch its kernel")
            for o, r in zip(out, ref):
                if o.shape != r.shape or o.dtype != r.dtype or (
                        o.device.type != "cuda"):
                    fail(f"probe {name} ({which}): output {tuple(o.shape)} "
                         f"{o.dtype} on {o.device}, plain {tuple(r.shape)} "
                         f"{r.dtype}")
                err = max(err, float((o.double() - r.double()).abs().max()))
                if not torch.equal(o, r):
                    fail(f"probe {name} ({which} inputs): kernel and plain "
                         f"version differ (bound: equal)")
        # times and bound at the probe's own inputs: every byte the
        # function needs read once (of the table only the columns it reads:
        # 0 and 2 for v2, 0 for the others) and every output byte written
        # once over the HBM rate,
        # against the loop trips and row stores this table asks for over
        # the card's 32-bit rate outside the tensor cores
        B, n, s = probe_batched.check_inputs(name, "probe", dev)
        outs = probe_call(wrapper, name, B, n, s)
        cols_read = {"v1": 0, "v2": 2}.get(name, 1)
        nbytes = sum(t.numel() * t.element_size() for t in outs) + (
            0 if s is None else B * cols_read * s.element_size())
        trips = (int(s[:, 0].clamp(min=0).sum())
                 if name in ("v4", "v4c") else 0)
        ops = {"v1": B, "v2": B, "v3": B * n, "v4": trips, "v4b": 2 * B,
               "v4c": trips * n}[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FLOP_PER_S[4] * 1e3
        dms = kernel_device_ms(
            lambda: probe_call(wrapper, name, B, n, s), 20,
            match=f"probe_{name}_kernel")
        wms = cuda_ms(lambda: probe_call(wrapper, name, B, n, s), 20)
        pms = cuda_ms(lambda: probe_call(plain, name, B, n, s), 5)
        line = PROBE_LINES[name]
        probe_entries.append({
            "name": f"probe_{name}_kernel", "route": "cuda",
            "source": "tci_tpu_torch/csrc/probe_batched.cu",
            "replaces": f"benchmarks/probe_pallas_batched.py:{line}",
            "launches": probe_launches[name], "max_abs_err": err,
            "ms": dms if dms is not None else wms,
            "ms_from": "profiler" if dms is not None else "cuda events",
            "wrapper_ms": wms, "plain_ms": pms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
        dev_txt = "not measured" if dms is None else f"{dms:.5f} ms"
        print(f"[probe] {name} (B={B}, n={n}): kernel equal to the plain "
              f"version at both input sets; kernel device time {dev_txt} a "
              f"launch (profiler), wrapper call {wms:.5f} ms (events), plain "
              f"{pms:.5f} ms", flush=True)
    print("[bound] probes: " + ", ".join(
        f"{e['name'][6:-7]} {e['bound_ms']:.4g} ms ({e['bound_by']})"
        for e in probe_entries), flush=True)

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

    def solve_config1(tier, imax=None, f=None, graphs=True, capture_at=None,
                      loop=False):
        """One run of config 1 through a tier: with a new evaluator, or on
        the evaluator `f` of an earlier run (which keeps its engine and the
        engine's CUDA graphs). graphs=False queues every sweep eagerly;
        capture_at sets the use of a key at which the engine records it;
        loop=True runs the engine's default protocol (phase 4e), False the
        per-sweep one."""
        if f is not None:
            set_graphs(f, graphs)
        elif tier == "host":
            f = fscalar
        else:
            f = tci_tpu_torch.TorchBatchEvaluator(
                fdev, localdims, enable_device_sweep=tier == "engine",
                cuda_graphs=graphs)
            if imax is not None:
                f._device_sweep_engine = DeviceSweepEngine(
                    f._values, localdims, imax=imax, cuda_graphs=graphs)
            if capture_at is not None:
                f.device_sweep_engine.capture_at = capture_at
        set_protocol(f, loop)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tci, ranks, errors = tci_tpu_torch.crossinterpolate2(
            np.float64, f, localdims, tolerance=1e-8,
            rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        return tci, ranks, errors, time.perf_counter() - t0, f

    def set_graphs(f, graphs):
        """Switch the engine of evaluator f between replaying its CUDA
        graphs and queuing its sweeps eagerly; the graphs are kept."""
        f.cuda_graphs = graphs
        if f._device_sweep_engine is not None:
            f._device_sweep_engine.cuda_graphs = graphs

    def set_protocol(f, loop):
        """The engine of evaluator f (if it has one) on tci_tpu's default
        protocol, the sweep pair and the optimize loop (loop=True, phase
        4e), or on the per-sweep one that phases 4-4d hold and time, as PR
        7 measured it."""
        engine = getattr(f, "device_sweep_engine", None)
        if engine is not None:
            engine.use_sweep_pair = engine.use_optimize_loop = loop

    def all_replayed(engine):
        """Every program of the engine was recorded at its capture_at-th
        use and replayed at that and every later use."""
        at = engine.capture_at
        progs = engine.programs()
        return (not engine.declined and engine.captures == sum(
            p["uses"] >= at for p in progs) and all(
                p["captured"] == (p["uses"] >= at)
                and p["replays"] == max(0, p["uses"] - at + 1)
                for p in progs) and engine.replays == sum(
                    p["replays"] for p in progs) > 0)

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

    def run_counted(tag, solve, record=False, f=None):
        """One run of a workload with every count set to 0 just before it;
        the counts are read just after. `solve` returns (..., wall, f); `f`
        is the evaluator when the run reuses one, whose own counts go on
        from where they stood. A recorded run (record=True: the inputs of
        every launch are kept for phase 5) must queue its sweeps eagerly: a
        capture runs the wrappers without values."""
        base_calls = tier_calls(f) if f is not None else 0
        base_nevals = getattr(f, "nevals", 0)
        lu_cuda.LAUNCHES.clear()
        probe_batched.LAUNCHES.clear()
        lu_kernel.PLAIN_CALLS.clear()
        FETCHES.clear()
        raw_calls[0] = 0
        lu_mod.rrlu_raw = counting_rrlu_raw
        if record:
            lu_cuda.rrlu_call = lambda *a, **k: (
                launch_inputs.append((tag, False, clones(a), k))
                or originals[1](*a, **k))
            lu_cuda.rrlu_batched = lambda *a, **k: (
                launch_inputs.append((tag, True, clones(a), k))
                or originals[2](*a, **k))
        try:
            res = solve()
        finally:
            lu_mod.rrlu_raw, lu_cuda.rrlu_call, lu_cuda.rrlu_batched = originals
        f = res[-1]
        engine = getattr(f, "_device_sweep_engine", None)
        if record and engine is not None and (engine.captures
                                              or engine.replays):
            fail(f"{tag}: a recorded run captured or replayed a graph")
        counts = {"launches": lu_cuda.LAUNCHES["rrlu"],
                  "plain_cuda": lu_kernel.PLAIN_CALLS["cuda"],
                  "rrlu_raw": raw_calls[0],
                  "tier_calls": tier_calls(f) - base_calls,
                  "fetches": dict(FETCHES),
                  "nevals": getattr(f, "nevals", 0) - base_nevals,
                  "declined": dict(engine.declined) if engine else {}}
        if counts["declined"]:
            fail(f"{tag}: the engine declined to capture "
                 f"{counts['declined']}")
        return res, counts

    def run_config1(tier, record=False, imax=None, f=None, graphs=True):
        (tci, ranks, errors, wall, f), counts = run_counted(
            tier, lambda: solve_config1(tier, imax, f,
                                        graphs and not record), record, f)
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
                or counts["tier_calls"] != f.device_sweep_engine.rrlu_calls
                or not all_replayed(f.device_sweep_engine)):
            fail(f"config 1 engine: {counts} for {iters} iterations, "
                 f"programs {f.device_sweep_engine.programs()}; the engine "
                 f"should fetch once a sweep, launch every rrLU, capture "
                 f"its three programs and replay every sweep")
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
    # each key once before: a key's first use records its graph, and the
    # end of a capture synchronizes; the sweep under the debug mode replays
    engine.sweep2site(tci, True, 1e-14, 0.0, 2**62, empty, empty)
    engine.sweep2site(tci, False, 1e-14, 0.0, 2**62, empty, empty,
                      fill_sites=True)
    engine.sweep2site(tci, True, 1e-14, 0.0, 2**62, empty, empty)
    torch.cuda.synchronize()
    fetches0, replays0 = FETCHES["engine"], engine.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.sweep2site(tci, False, 1e-14, 0.0, 2**62, empty, empty,
                          fill_sites=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if (FETCHES["engine"] != fetches0 + 1 or engine.captures != 2
            or engine.replays != replays0 + 1 or engine.declined):
        fail(f"engine sweep: {FETCHES['engine'] - fetches0} fetches, "
             f"{engine.captures} captures, {engine.replays - replays0} "
             f"replays, declined {engine.declined}")
    print("[config1] engine sweep2site with the fill, replayed from its "
          "CUDA graph under sync debug mode \"error\": no synchronization, "
          "1 fetch", flush=True)

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

    def median_warm(solve, n=10):
        """Median and range of n warm walls of solve() (its wall is the
        second to last item it returns)."""
        walls = sorted(solve()[-2] for _ in range(n))
        return (walls[(n - 1) // 2] + walls[n // 2]) / 2, walls[0], walls[-1]

    def count_kernels(solve):
        """One run under torch.profiler: (all device kernels, rrLU kernels)
        it launched, or (None, None) when the trace holds no kernel."""
        from torch.profiler import ProfilerActivity
        names = [name for name, _ in traced_kernels(
            solve, [ProfilerActivity.CPU, ProfilerActivity.CUDA])]
        if not names:
            return None, None
        return len(names), sum("rrlu" in n for n in names)

    def check_engine_run(tag, counts, f, sweeps):
        """Every elimination ran on the engine and launched the kernel, the
        engine fetched once a sweep, and nothing took the plain version."""
        if (counts["launches"] == 0 or counts["rrlu_raw"]
                or f._fused_updater is not None
                or f._fused_site_tensors is not None
                or counts["launches"] != counts["tier_calls"]):
            fail(f"{tag}: {counts}; the engine should launch every rrLU")
        if counts["plain_cuda"] != 0:
            fail(f"{tag}: {counts['plain_cuda']} plain-version calls on CUDA "
                 f"tensors")
        if sweeps is not None and counts["fetches"] != {"engine": sweeps}:
            fail(f"{tag}: fetches {counts['fetches']} for {sweeps} sweeps")

    # -- 4b. BASELINE config 3: quantics TCI on a 2^40 grid -------------------
    from tci_tpu_torch.utils.quantics import DiscretizedGrid

    R3 = 40
    dims3 = [2] * R3
    qweights = torch.tensor([2.0 ** -(r + 1) for r in range(R3)],
                            dtype=torch.float64, device=dev)

    def fquantics(bits):
        # x = sum_r bits_r 2^-(r+1): 40 distinct powers of two, exact in f64
        x = (bits.to(torch.float64) * qweights).sum(dim=1)
        return torch.cos(100.0 * x) * torch.exp(-x)

    def solve_config3(f=None, graphs=True, capture_at=None, loop=False):
        if f is not None:
            set_graphs(f, graphs)
        else:
            f = tci_tpu_torch.TorchBatchEvaluator(fquantics, dims3,
                                                  cuda_graphs=graphs)
            if capture_at is not None:
                f.device_sweep_engine.capture_at = capture_at
        set_protocol(f, loop)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tci, ranks, errors = tci_tpu_torch.crossinterpolate2(
            np.float64, f, dims3, tolerance=1e-10,
            rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        return tci, ranks, errors, time.perf_counter() - t0, f

    def check_config3(tag, tci, ranks, errors, counts, f, per_sweep=True):
        grid = DiscretizedGrid(R3, 0.0, 1.0)
        spot = 0.0
        for x in [0.1, 0.25, 0.5, 0.75, 0.9]:
            bits = grid.grididx_to_quantics([int(x * 2 ** R3)])
            xx = grid.quantics_to_origcoord(bits)[0]
            spot = max(spot, abs(tci(bits) - np.cos(100 * xx) * np.exp(-xx)))
        if tci.rank() != 2 or not errors[-1] < 1e-10 or not spot < 1e-9:
            fail(f"config 3 {tag}: rank {tci.rank()} (expected 2), ranks "
                 f"{ranks}, errors {errors}, spot-check error {spot}")
        if tci.device.type != "cuda":
            fail(f"config 3 {tag}: ran on {tci.device}")
        check_engine_run(f"config 3 {tag}", counts, f,
                         2 * len(ranks) + 1 if per_sweep else None)
        return spot

    res3, counts3 = run_counted(
        "config3", lambda: solve_config3(graphs=False), record=True)
    check_config3("cold", *res3[:3], counts3, res3[-1])
    cold3 = res3[3]
    (tci, ranks, errors, warm3, f), counts3 = run_counted(
        "config3", solve_config3)
    spot3 = check_config3("warm", tci, ranks, errors, counts3, f)
    med3 = median_warm(solve_config3)
    # counted on the kept evaluator, whose sweeps are all replays by then
    solve_config3(f=f)
    nk3 = count_kernels(lambda: solve_config3(f=f))
    print(f"[config3] quantics R={R3}: cold {cold3:.4f} s, warm {warm3:.4f} s,"
          f" median of 10 warm {med3[0]:.4f} s (range {med3[1]:.4f}-"
          f"{med3[2]:.4f}); rank {tci.rank()}, ranks {ranks}, errors "
          f"{[f'{e:.6e}' for e in errors]}, spot-check error {spot3:.3e}; "
          f"{counts3['launches']} rrLU kernel launches (all on the engine, "
          f"Imax {f.device_sweep_engine.Imax}), device kernels in one "
          f"replayed run: {nk3[1]} rrLU / {nk3[0]} all (profiler), "
          f"{counts3['plain_cuda']} plain calls on CUDA, fetches "
          f"{counts3['fetches']}, nevals {counts3['nevals']}", flush=True)

    # -- 4c. BASELINE config 4: 10-D integration over a GK15 grid --------------
    from tci_tpu_torch.models import device_sweep, integration

    def f4torch(X):
        return 1000 * torch.cos(10 * (X ** 2).sum(dim=1)) * torch.exp(
            -X.sum(dim=1) ** 4 / 1000)

    def f4numpy(X):
        return 1000 * np.cos(10 * np.sum(X ** 2, axis=1)) * np.exp(
            -np.sum(X, axis=1) ** 4 / 1000)

    def solve_config4(vectorized=False, fresh=True, graphs=True,
                      capture_at=None, loop=False):
        """integrate() as a user calls it; what it hands to and gets from
        TCI2, and the engine's capacity after each of its calls, are
        recorded on the way. integrate keeps its evaluator by integrand:
        fresh=True drops it first, so that the run builds a new one,
        fresh=False runs on the one the last run left. Returns (integral,
        tci, ranks, errors, capacities, declined, wall, evaluator)."""
        seen, sweeps = [], []
        tci2 = integration.crossinterpolate2
        entries = {name: getattr(device_sweep.DeviceSweepEngine, name)
                   for name in ("sweep2site", "sweep2site_pair",
                                "optimize_loop", "fillsitetensors",
                                "sweep1site")}
        if fresh:
            integration._GK_EVAL_CACHE.pop(f4torch, None)

        def recording_tci2(valuetype, F, localdims, **kwargs):
            if not vectorized:
                set_graphs(F, graphs)
                set_protocol(F, loop)
                if capture_at is not None:
                    F.device_sweep_engine.capture_at = capture_at
            out = tci2(valuetype, F, localdims, **kwargs)
            seen.append((F, *out))
            return out

        def recording(fn):
            def call(self, *args, **kwargs):
                res = fn(self, *args, **kwargs)
                sweeps.append((self.Imax, res is not None and res is not False))
                return res
            return call

        integration.crossinterpolate2 = recording_tci2
        for name, fn in entries.items():
            setattr(device_sweep.DeviceSweepEngine, name, recording(fn))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            val = tci_tpu_torch.integrate(
                np.float64, f4numpy if vectorized else f4torch, [-1.0] * 10,
                [1.0] * 10, GKorder=15, tolerance=1e-8, maxbonddim=64,
                pivotsearch="full", torch_native=not vectorized,
                vectorized=vectorized, rng=np.random.default_rng(0))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            integration.crossinterpolate2 = tci2
            for name, fn in entries.items():
                setattr(device_sweep.DeviceSweepEngine, name, fn)
        (F, tci, ranks, errors), = seen
        capacities = list(dict.fromkeys(c for c, _ in sweeps))
        declined = any(not done for _, done in sweeps)
        return val, tci, ranks, errors, capacities, declined, wall, F

    def check_config4(tag, val, tci, counts, f, declined):
        if not abs(val - CONFIG4_INTEGRAL) < 1e-3 or tci.rank() > 64:
            fail(f"config 4 {tag}: integral {val!r}, expected "
                 f"{CONFIG4_INTEGRAL} within 1e-3; rank {tci.rank()} (cap 64)")
        if tci.device.type != "cuda":
            fail(f"config 4 {tag}: ran on {tci.device}")
        if counts["plain_cuda"] != 0 or counts["launches"] == 0 or (
                counts["launches"]
                != counts["rrlu_raw"] + counts["tier_calls"]):
            fail(f"config 4 {tag}: {counts}; every elimination should launch "
                 f"the kernel and none take the plain version")
        if not declined:
            check_engine_run(f"config 4 {tag}", counts, f, None)

    res4, counts4 = run_counted(
        "config4", lambda: solve_config4(graphs=False), record=True)
    check_config4("cold", res4[0], res4[1], counts4, res4[-1], res4[5])
    cold4 = res4[6]
    (val4, tci, ranks, errors, caps4, declined4, warm4, f), counts4 = (
        run_counted("config4", solve_config4))
    check_config4("warm", val4, tci, counts4, f, declined4)
    med4 = median_warm(solve_config4)
    # counted on the kept evaluator, whose sweeps are all replays by then
    solve_config4(fresh=False)
    solve_config4(fresh=False)
    nk4 = count_kernels(lambda: solve_config4(fresh=False))
    print(f"[config4] integrate(torch_native=True), 10-D GK15: cold "
          f"{cold4:.4f} s, warm {warm4:.4f} s, median of 10 warm "
          f"{med4[0]:.4f} s (range {med4[1]:.4f}-{med4[2]:.4f}); integral "
          f"{val4!r}, |I - ref| {abs(val4 - CONFIG4_INTEGRAL):.3e}; ranks "
          f"{ranks}, final rank {tci.rank()}, errors "
          f"{[f'{e:.6e}' for e in errors]}; engine capacities {caps4}, "
          f"declined: {declined4}; {counts4['launches']} rrLU kernel "
          f"launches ({counts4['rrlu_raw']} rrlu_raw, "
          f"{counts4['tier_calls']} tier calls), device kernels in one "
          f"replayed run: {nk4[1]} rrLU / {nk4[0]} all (profiler), "
          f"{counts4['plain_cuda']} plain calls on CUDA, fetches "
          f"{counts4['fetches']}, nevals {counts4['nevals']}", flush=True)

    # the same integrand sampled on the host (one numpy call a panel) and
    # factorized on the card
    (valv, tciv, ranksv, _, _, _, wallv, fv), countsv = run_counted(
        "config4_vectorized", lambda: solve_config4(vectorized=True))
    if (not abs(valv - val4) < 1e-6 or countsv["plain_cuda"] != 0
            or countsv["launches"] != countsv["rrlu_raw"]
            or countsv["launches"] == 0):
        fail(f"config 4 vectorized: integral {valv!r} against {val4!r} "
             f"(bound 1e-6), counts {countsv}")
    print(f"[config4] integrate(vectorized=True), host sampling: {wallv:.4f} "
          f"s, integral {valv!r}, |I - I_torch_native| "
          f"{abs(valv - val4):.3e}, ranks {ranksv}, {countsv['launches']} "
          f"rrLU kernel launches, {countsv['plain_cuda']} plain calls on "
          f"CUDA", flush=True)

    # -- 4d. the engine's sweeps as CUDA graphs an evaluator keeps -------------
    # For configs 1, 3 and 4, at full width: (a) a new evaluator a run, with
    # the graphs off, recorded at a key's first use and at its second;
    # (b) one evaluator kept across runs: one run that records, then ten
    # that only replay, then ten with the graphs switched off; (c) the
    # replayed result against the eagerly queued one, bit for bit.
    fresh4 = (val4, tci, ranks, caps4)

    def timed_calls(log):
        """Patch the engine's three entry points to log (name, seconds,
        replayed?) of every call; returns the undo."""
        saved = {}
        for name in ("sweep2site", "fillsitetensors", "sweep1site"):
            saved[name] = fn = getattr(DeviceSweepEngine, name)

            def timed(self, *a, _fn=fn, _name=name, **k):
                r0, t0 = self.replays, time.perf_counter()
                out = _fn(self, *a, **k)
                log.append((_name, time.perf_counter() - t0,
                            self.replays > r0))
                return out
            setattr(DeviceSweepEngine, name, timed)

        def undo():
            for name, fn in saved.items():
                setattr(DeviceSweepEngine, name, fn)
        return undo

    def med(xs):
        xs = sorted(xs)
        return (xs[(len(xs) - 1) // 2] + xs[len(xs) // 2]) / 2

    def spread(xs):
        return f"{med(xs):.4f} s ({min(xs):.4f}-{max(xs):.4f})"

    def replay_trace(engine, keep=lambda key: True):
        """Per program of the engine (whose key `keep` accepts), one replay
        under torch.profiler: the
        device items (kernels, copies, memsets) the graph holds, and the
        rrLU kernels' durations by launch grid; and the host time of one
        replay's launch (cudaGraphLaunch), unprofiled."""
        from torch.profiler import ProfilerActivity, profile
        out = {}
        for key, prog in engine._sweeps.items():
            if not prog.captured or not keep(key):
                continue

            def once(prog=prog):
                prog._replay()
                lu_cuda.count_replay(prog.captured_launches)
            once()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            once()
            launch_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                once()
                torch.cuda.synchronize()
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.export_chrome_trace(path)
                with open(path) as fh:
                    events = json.load(fh)["traceEvents"]
            items = [e for e in events if e.get("ph") == "X" and e.get("cat")
                     in ("kernel", "gpu_memcpy", "gpu_memset")]
            rrlu = {}
            for e in items:
                if "rrlu" in e.get("name", ""):
                    grid = str(e.get("args", {}).get("grid"))
                    rrlu.setdefault(grid, []).append(e["dur"])
            out[key] = {"nodes": len(items), "launch_ms": launch_ms,
                        "device_ms": sum(e["dur"] for e in items) / 1e3,
                        "rrlu_us_by_grid": {
                            g: (len(d), sum(d) / len(d))
                            for g, d in rrlu.items()}}
        return out

    def print_program(tag, p, tr):
        print(f"[graphs] {tag}: program {p['key']}: {p['uses']} uses, "
              f"{p['replays']} replays, capture and instantiation "
              f"{p['capture_seconds'] * 1e3:.2f} ms, "
              f"{p['captured_launches']} rrLU launches, "
              f"{tr.get('nodes')} device items a replay taking "
              f"{tr.get('device_ms', float('nan')):.3f} ms on the device, "
              f"its launch {tr.get('launch_ms', float('nan')):.3f} ms of "
              f"host time; rrLU kernel (count, mean us) by grid: "
              f"{tr.get('rrlu_us_by_grid')}", flush=True)

    def same_tci(tag, a, b, what="graph and eager"):
        """Index sets, error series and every site tensor of two TensorCI2
        bit for bit."""
        if a.Iset != b.Iset or a.Jset != b.Jset:
            fail(f"{tag}: index sets differ between {what}")
        if (a.pivoterrors != b.pivoterrors
                or list(a.bonderrors) != list(b.bonderrors)
                or a.maxsamplevalue != b.maxsamplevalue):
            fail(f"{tag}: pivot errors, bond errors or max sample differ")
        for i, (x, y) in enumerate(zip(a.sitetensors(), b.sitetensors())):
            if x.shape != y.shape or not torch.equal(x, y):
                fail(f"{tag}: site tensor {i} differs between {what} "
                     f"(bound: bitwise)")

    def graphs_phase(tag, solve, key_of, sweeps_of):
        """`solve(f=None, graphs=True, capture_at=None)` runs the config
        (f: the evaluator to reuse) and returns (..., wall, f); key_of maps
        its result to what must be identical between runs; sweeps_of gives
        the fetches a run should make (or None)."""
        out = {}
        # (a) a new evaluator a run
        for name, kw in (("fresh_eager", {"graphs": False}),
                         ("fresh_capture_at_1", {"capture_at": 1}),
                         ("fresh_capture_at_2", {"capture_at": 2})):
            out[name] = [solve(**kw)[-2] for _ in range(5)]
        # (b) one evaluator kept: the run that records, then replays only
        log = []
        undo = timed_calls(log)
        try:
            res, counts = run_counted(tag, lambda: solve())
            f = res[-1]
            engine = f.device_sweep_engine
            check_engine_run(f"{tag} recording run", counts, f,
                             sweeps_of(res))
            if not all_replayed(engine):
                fail(f"{tag}: recording run: {engine.programs()}")
            out["recording_run"] = res[-2]
            first_key = key_of(res)
            first_tci = res[1] if tag == "config4" else res[0]
            held = [t.clone() for t in first_tci.sitetensors()]
            captures, del_log = engine.captures, len(log)
            walls, launches = [], None
            for _ in range(10):
                res, counts = run_counted(tag, lambda: solve(f=f), f=f)
                check_engine_run(f"{tag} replayed run", counts, f,
                                 sweeps_of(res))
                if key_of(res) != first_key:
                    fail(f"{tag}: a replayed run gave {key_of(res)}, the "
                         f"recording run {first_key}")
                walls.append(res[-2])
                launches = counts["launches"]
            if engine.captures != captures or not all(
                    p["captured"] for p in engine.programs()):
                fail(f"{tag}: warm runs on a kept evaluator captured again "
                     f"or ran a key eagerly: {engine.programs()}")
            if not all(replayed for _, _, replayed in log[del_log:]):
                fail(f"{tag}: a sweep call of a warm run was not a replay")
            out["kept_graphs"] = walls
            replay_calls = log[del_log:]
            replayed_tci = res[1] if tag == "config4" else res[0]
            # site tensors of the first result: untouched by 10 more runs
            for i, (t, h) in enumerate(zip(first_tci.sitetensors(), held)):
                if not torch.equal(t, h):
                    fail(f"{tag}: site tensor {i} of the first result "
                         f"changed under later calls on the same evaluator")
            same_tci(f"{tag} first against eleventh run", first_tci,
                     replayed_tci)
            pool = engine.graph_pool_bytes()
            trace = replay_trace(engine)
            # ... and with the graphs switched off, on the same evaluator
            n0 = len(log)
            walls = []
            for _ in range(10):
                res, counts = run_counted(
                    tag, lambda: solve(f=f, graphs=False), f=f)
                check_engine_run(f"{tag} eager run", counts, f,
                                 sweeps_of(res))
                walls.append(res[-2])
            out["kept_eager"] = walls
            eager_calls = log[n0:]
            if any(replayed for _, _, replayed in eager_calls):
                fail(f"{tag}: a run with the graphs off replayed one")
            if key_of(res) != first_key or counts["launches"] != launches:
                fail(f"{tag}: eager {key_of(res)}, {counts['launches']} "
                     f"launches; replayed {first_key}, {launches}")
            same_tci(f"{tag} graph against eager", replayed_tci,
                     res[1] if tag == "config4" else res[0])
            set_graphs(f, True)
        finally:
            undo()

        def call_ms(calls, name):
            xs = [t * 1e3 for n, t, _ in calls if n == name]
            return f"{med(xs):.3f}" if xs else "none"

        progs = engine.programs()
        pool_txt = ("not measured" if pool is None
                    else f"{pool / 2 ** 20:.1f} MiB")
        print(f"[graphs] {tag}: a new evaluator a run (5 runs each): eager "
              f"{spread(out['fresh_eager'])}, recorded at a key's first use "
              f"{spread(out['fresh_capture_at_1'])}, at its second "
              f"{spread(out['fresh_capture_at_2'])}", flush=True)
        print(f"[graphs] {tag}: one evaluator kept: the recording run "
              f"{out['recording_run']:.4f} s, then 10 replayed runs "
              f"{spread(out['kept_graphs'])}, then 10 with the graphs off "
              f"{spread(out['kept_eager'])}; graph and eager identical bit "
              f"for bit (index sets, error series, site tensors, "
              f"{first_key}); site tensors of the first result unchanged "
              f"after 10 more runs", flush=True)
        print(f"[graphs] {tag}: {engine.captures} captures, "
              f"{engine.replays} replays, declined {engine.declined}; "
              f"{launches} rrLU launches a replayed run; one call, host "
              f"wall with its fetch, median ms replayed / eager: sweep2site "
              f"{call_ms(replay_calls, 'sweep2site')} / "
              f"{call_ms(eager_calls, 'sweep2site')}, sweep1site "
              f"{call_ms(replay_calls, 'sweep1site')} / "
              f"{call_ms(eager_calls, 'sweep1site')}, fillsitetensors "
              f"{call_ms(replay_calls, 'fillsitetensors')} / "
              f"{call_ms(eager_calls, 'fillsitetensors')}; the graphs' "
              f"memory pool holds {pool_txt}", flush=True)
        for p in progs:
            tr = trace.get(p["key"], {})
            print_program(tag, p, tr)
        return {"fresh_eager_median": med(out["fresh_eager"]),
                "fresh_capture_at_1_median": med(out["fresh_capture_at_1"]),
                "fresh_capture_at_2_median": med(out["fresh_capture_at_2"]),
                "recording_run": out["recording_run"],
                "kept_graphs_median": med(out["kept_graphs"]),
                "kept_eager_median": med(out["kept_eager"]),
                "captures": engine.captures, "launches": launches,
                "pool_bytes": pool}

    graph_results = {
        "config1": graphs_phase(
            "config1",
            lambda f=None, graphs=True, capture_at=None: solve_config1(
                "engine", None, f, graphs, capture_at),
            lambda res: (res[1], res[2]),
            lambda res: 2 * len(res[1]) + 1),
        "config3": graphs_phase(
            "config3", solve_config3, lambda res: (res[1], res[2]),
            lambda res: 2 * len(res[1]) + 1),
        "config4": graphs_phase(
            "config4",
            lambda f=None, graphs=True, capture_at=None: solve_config4(
                fresh=f is None, graphs=graphs, capture_at=capture_at),
            # the integral, the ranks and the capacities [32, 64] of a
            # recording run; a kept engine stays at the capacity it grew to
            lambda res: (res[0], res[2]),
            lambda res: None),
    }
    if graph_results["config1"]["kept_graphs_median"] <= 0:
        fail("graphs phase: no wall measured")

    # one program, replayed with other tolerances and rank caps: what the
    # eagerly queued body gives for each
    seen = {}
    for graphs in (False, True):
        bf = tci_tpu_torch.TorchBatchEvaluator(fdev, localdims,
                                               cuda_graphs=graphs)
        tci = tci_tpu_torch.TensorCI2.from_function(bf, localdims)
        engine = bf.device_sweep_engine
        seen[graphs] = []
        for abstol, maxbond in ((1e-3, 2), (1e-12, 2 ** 62), (1e-6, 5)):
            tci.flushpivoterror()
            engine.sweep2site(tci, True, 1e-14, abstol, maxbond, empty, empty)
            seen[graphs].append((tci.Iset, tci.Jset, list(tci.pivoterrors)))
        if engine.captures != int(graphs) or engine.replays != 3 * graphs:
            fail(f"tolerance check: {engine.programs()}")
    ranks_seen = [max(len(s) for s in st[0]) for st in seen[True]]
    if seen[True] != seen[False] or ranks_seen[0] != 2 or ranks_seen[2] > 5:
        fail(f"one program replayed with three abstol / maxbonddim pairs "
             f"differs from the eager body (ranks {ranks_seen})")
    print(f"[graphs] one 2-site sweep program of config 1 replayed with "
          f"(abstol, maxbonddim) = (1e-3, 2), (1e-12, 2^62), (1e-6, 5): "
          f"ranks {ranks_seen}, index sets and pivot errors identical to "
          f"the eager body's each time", flush=True)
    # config 4 with a new evaluator: the run that recorded its graphs
    # (phase 4c's warm run) against the one that queued eagerly (its cold
    # run): the integral, the ranks, the capacities and the tensor train
    if (fresh4[0] != res4[0] or fresh4[2] != res4[2]
            or fresh4[3] != res4[4] or fresh4[3] != [32, 64]):
        fail(f"config 4: graphs gave integral {fresh4[0]!r}, ranks "
             f"{fresh4[2]}, capacities {fresh4[3]}; eager {res4[0]!r}, "
             f"{res4[2]}, {res4[4]}; expected equal, capacities [32, 64]")
    same_tci("config 4, new evaluators, graph against eager", fresh4[1],
             res4[1])
    print(f"[graphs] config4: new evaluators, graphs on against off: "
          f"integral {fresh4[0]!r}, ranks {fresh4[2]} and capacities "
          f"{fresh4[3]} equal, tensor train identical bit for bit",
          flush=True)

    # -- 4e. tci_tpu's default protocol: the sweep pair and the optimize loop --
    # For configs 1, 3 and 4, at full width: the per-sweep protocol's result
    # on a new evaluator (what phases 4-4d run), then the default protocol
    # on a new evaluator (the run that records the loop's step), then ten
    # runs on that kept evaluator that only replay; every result bit for bit
    # the per-sweep one, and the host finder never called.
    from tci_tpu_torch.models.globalpivotfinder import DefaultGlobalPivotFinder

    host_finder = DefaultGlobalPivotFinder.__call__
    finder_calls = [0]

    def counting_finder(self, *args, **kwargs):
        finder_calls[0] += 1
        return host_finder(self, *args, **kwargs)

    def device_busy_ms(solve):
        """Device busy time of one run of solve(), in ms: the union of the
        kernels, copies and memsets of a torch.profiler trace of it."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            solve()
            torch.cuda.synchronize()
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
        return busy / 1e3 if spans else None

    def loop_phase(tag, solve, key_of, tci_of, check):
        """`solve(f=None, loop=False)` runs the config (f: the evaluator to
        reuse) and returns (..., wall, f); key_of maps a result to what must
        be identical between the protocols, tci_of to its TensorCI2; check
        holds a loop run's result and counts."""
        ref = solve()
        DefaultGlobalPivotFinder.__call__ = counting_finder
        finder_calls[0] = 0
        try:
            res, counts = run_counted(f"{tag} loop", lambda: solve(loop=True))
            f = res[-1]
            engine = f.device_sweep_engine
            check(f"{tag} loop, recording run", res, counts)
            recording = (res[-2], counts["launches"])
            if key_of(res) != key_of(ref):
                fail(f"{tag}: the loop protocol's recording run gave "
                     f"{key_of(res)}, the per-sweep one {key_of(ref)}")
            same_tci(f"{tag} loop against per sweep", tci_of(res),
                     tci_of(ref), "the loop and the per-sweep protocol")
            if (tci_of(res).Iset_history != tci_of(ref).Iset_history
                    or tci_of(res).Jset_history != tci_of(ref).Jset_history):
                fail(f"{tag}: the set histories of the two protocols differ")
            if not engine.loop_blocks or any(
                    key[0] not in ("oloop", "sweep1")
                    for key in engine._sweeps):
                fail(f"{tag}: the loop protocol ran {list(engine._sweeps)}")
            blocks0, steps0 = engine.loop_blocks, engine.loop_steps
            walls = []
            for _ in range(10):
                res, counts = run_counted(tag, lambda: solve(f=f, loop=True),
                                          f=f)
                check(f"{tag} loop, replayed run", res, counts)
                if key_of(res) != key_of(ref):
                    fail(f"{tag}: a replayed loop run gave {key_of(res)}")
                walls.append(res[-2])
            same_tci(f"{tag} replayed loop against per sweep", tci_of(res),
                     tci_of(ref), "the loop and the per-sweep protocol")
        finally:
            DefaultGlobalPivotFinder.__call__ = host_finder
        if finder_calls[0]:
            fail(f"{tag}: the host finder ran {finder_calls[0]} times under "
                 f"the loop protocol")
        if engine.captures != sum(1 for p in engine.programs()
                                  if p["captured"]) or not all(
                p["captured"] for p in engine.programs()):
            fail(f"{tag}: loop programs {engine.programs()}")
        blocks = (engine.loop_blocks - blocks0) / 10
        steps = (engine.loop_steps - steps0) / 10
        busy = device_busy_ms(lambda: solve(f=f, loop=True))
        pool = engine.graph_pool_bytes()
        # the loop step's programs (phase 4d traced the 1-site sweep's key)
        trace = replay_trace(engine, lambda key: key[0] == "oloop")
        # the loop step's program that the replayed runs used
        step_key = max((p for p in engine.programs()
                        if p["key"][0] == "oloop"),
                       key=lambda p: p["uses"])["key"]
        wall = med(walls)
        idle = None if busy is None else 1 - busy / (wall * 1e3)
        per_sweep = graph_results[tag]["kept_graphs_median"]
        print(f"[loop] {tag}: identical to the per-sweep protocol bit for bit "
              f"({key_of(ref)}, index sets and their history, error series, "
              f"site tensors); a run: {blocks:g} loop blocks, {steps:g} "
              f"steps, {counts['fetches'].get('engine_status', 0)} status "
              f"reads, {counts['fetches'].get('engine', 0)} fetches, "
              f"{counts['launches']} rrLU launches, 0 host-finder calls; a "
              f"new evaluator's run (it records): {recording[0]:.4f} s, "
              f"{recording[1]} rrLU launches; one "
              f"evaluator kept: 10 replayed runs {spread(walls)} against "
              f"{per_sweep:.4f} s per sweep (phase 4d); device busy "
              f"{'not measured' if busy is None else f'{busy:.3f} ms'} "
              f"(profiler), idle share {'not measured' if idle is None else f'{idle:.4f}'}; "
              f"graphs' pool {pool / 2 ** 20:.1f} MiB", flush=True)
        for p in engine.programs():
            if p["key"] in trace:
                print_program(f"{tag} loop", p, trace[p["key"]])
        return {"kept_graphs_median": wall, "per_sweep_median": per_sweep,
                "blocks": blocks, "steps": steps,
                "status_reads": counts["fetches"].get("engine_status", 0),
                "fetches": counts["fetches"].get("engine", 0),
                "launches": counts["launches"], "device_busy_ms": busy,
                "recording_run": recording[0],
                "recording_run_launches": recording[1],
                "idle_share": idle, "pool_bytes": pool,
                "step": {name: trace[step_key][name] for name in (
                    "nodes", "device_ms", "launch_ms")}}

    def check_loop1(tag, res, counts):
        check_config1(tag, *res[:3], counts)
        check_engine_run(tag, counts, res[-1], None)

    def check_loop3(tag, res, counts):
        check_config3(tag, *res[:3], counts, res[-1], per_sweep=False)

    def check_loop4(tag, res, counts):
        check_config4(tag, res[0], res[1], counts, res[-1], res[5])

    loop_results = {
        "config1": loop_phase(
            "config1",
            lambda f=None, loop=False: solve_config1("engine", None, f,
                                                     loop=loop),
            lambda res: (res[1], res[2]), lambda res: res[0], check_loop1),
        "config3": loop_phase(
            "config3", lambda f=None, loop=False: solve_config3(f=f, loop=loop),
            lambda res: (res[1], res[2]), lambda res: res[0], check_loop3),
        "config4": loop_phase(
            "config4",
            lambda f=None, loop=False: solve_config4(fresh=f is None,
                                                     loop=loop),
            # the integral, the ranks and the error series; with a new
            # evaluator the capacities [32, 64] (a kept one stays at 64)
            lambda res: (res[0], res[2], res[3]), lambda res: res[1],
            check_loop4),
    }
    caps_loop = solve_config4(loop=True)[4]
    if caps_loop != [32, 64]:
        fail(f"config 4: the loop protocol's capacities {caps_loop}, "
             f"expected [32, 64]")

    # -- 4f. the TT algebra, the caches and the floating-zone search --------
    # On config 1's converged tensor train (an evaluator kept, the default
    # protocol) and config 3's: estimatetrueerror through the engine's
    # floating-zone program against the host lock-step search on the card;
    # global pivots on config 1 truncated at maxbonddim 6, the engine
    # against the host tier; compress (LU, CI, SVD), add and subtract;
    # fulltensor of config 1 (10^8 values) against f on every grid point;
    # TTCache and CachedFunction. The cold runs keep every kernel launch's
    # inputs for phase 5.
    from tci_tpu_torch.models import globalsearch, tensortrain as tt_mod
    from tci_tpu_torch.models.tteval import chi_bucket, max_bond

    def timed(fn):
        """fn()'s result and its wall, from a synchronized start to a
        synchronized end."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def tt_points(tt, n=10**4, seed=7):
        dims = [d[0] for d in tt.sitedims()]
        pts = np.random.default_rng(seed).integers(0, dims, (n, len(dims)))
        return pts, tt.evaluate_batch(pts)

    tt_entry = {}

    def parted_at_ties(engine, tt, f, starts, per_start, host, margin):
        """Each start where the program's (pivot, error) differs from the
        host lock-step search's: the two searches ran again for k = 1, 2,
        ... sweeps find the first sweep after which its pivots differ; from
        the pivot both held before it, leg by leg, |f - tt| on that leg's
        variants shows where the two chose differently, and the gap between
        their choices' errors there must be within `margin` (a tie, which
        rounding may break either way; where the host search had frozen the
        start, its choice is the coordinate it kept). A start whose pivots
        never part differs in its error alone, which must be within
        `margin` too. Returns (starts that differ, largest gap)."""
        differ = [s for s, (p, e) in enumerate(zip(*per_start))
                  if (tuple(p), e) != host[s]]
        if not differ:
            return 0, 0.0
        progs, hosts = [np.asarray(starts)], [np.asarray(starts)]
        while not (np.array_equal(progs[-1], per_start[0])
                   and [tuple(p) for p in hosts[-1].tolist()]
                   == [p for p, _ in host]):
            k = len(progs)
            if k > 100:
                fail("4f: the searches run again do not reach their results")
            progs.append(engine.floatingzone(tt.sitetensors(),
                                             np.asarray(starts), nsweeps=k)[0])
            hosts.append(np.asarray([p for p, _ in globalsearch
                                     ._floatingzone_batch(tt, f, starts,
                                                          nsweeps=k)]))
        worst = 0.0
        for s in differ:
            k = next((k for k in range(1, len(progs))
                      if not np.array_equal(progs[k][s], hosts[k][s])), None)
            if k is None:
                gap = abs(per_start[1][s] - host[s][1])
            else:
                cur, gap = hosts[k - 1][s].copy(), float("inf")
                for i, d in enumerate(tt.sitedims()):
                    rows = np.repeat(cur[None], d[0], axis=0)
                    rows[:, i] = np.arange(d[0])
                    e = (f.evaluate_many(rows)
                         - tt.evaluate_batch(rows)).abs().cpu().numpy()
                    pc, hc = progs[k][s][i], hosts[k][s][i]
                    if pc != hc:
                        gap = abs(float(e[pc] - e[hc]))
                        break
                    cur[i] = pc
            if gap > margin:
                fail(f"4f: start {s} parted from the host search at a gap "
                     f"{gap!r}, more than a tie ({margin:.3e})")
            worst = max(worst, float(gap))
        return len(differ), worst

    def fzone_phase(tag, tci, f, recorded, rounding=None):
        """estimatetrueerror(tt, f, nsearch=100, rng=default_rng(0)) on the
        engine (cold: the program's first use, which records it; warm: a
        replay) against the host lock-step search from the same starts;
        recorded: tci_tpu's largest error on the CPU for those starts (None:
        not recorded, not compared). Two evaluations of the train at a
        point may round apart (the program and the host search batch their
        products differently); the margin for that is 1e-15 max|f|, or,
        with `rounding`, the forward error bound of a train's evaluation:
        twice 4 L chi_b u (u = 2^-53; complex arithmetic's constant
        included) times the train evaluated with |cores|, at its largest
        over the starts, the results and 10^4 seeded points."""
        tt = tci_tpu_torch.tensortrain(tci)
        engine = f.device_sweep_engine
        dims = [d[0] for d in tt.sitedims()]
        rng = np.random.default_rng(0)
        starts = [tuple(int(rng.integers(0, d)) for d in dims)
                  for _ in range(100)]
        key = ("fzone", 100, chi_bucket(max_bond(tt.sitetensors())))

        def search():
            return tci_tpu_torch.estimatetrueerror(
                tt, f, nsearch=100, rng=np.random.default_rng(0))

        FETCHES.clear()
        captures0, nevals0 = engine.captures, f.nevals
        dev, cold = timed(search)
        reads, fetches = FETCHES["engine_status"], FETCHES["engine"]
        nevals = f.nevals - nevals0
        if key not in engine._sweeps or engine.captures != captures0 + 1:
            fail(f"{tag}: the floating-zone program {key} was not recorded "
                 f"({engine.programs()})")
        walls = [timed(search)[1] for _ in range(10)]
        again = search()
        prog = engine._sweeps[key]
        if again != dev or not prog.captured or engine.declined:
            fail(f"{tag}: a replayed search differs or the program "
                 f"declined ({engine.declined})")

        def host_search():
            out = globalsearch._floatingzone_batch(tt, f, starts)
            return sorted(dict.fromkeys(out), key=lambda pe: -pe[1])

        # the same program queued eagerly: what a one-off search pays with
        # no capture
        engine.cuda_graphs = False
        eager_walls = [timed(search)[1] for _ in range(3)]
        engine.cuda_graphs = True
        host, host_cold = timed(host_search)
        host_walls = [timed(host_search)[1] for _ in range(3)]
        (bp, be), (hp, he) = dev[0], host[0]
        # an error is the difference of f and tt values of up to max|f|:
        # the program and the host search batch the train's products
        # differently (S dmax rows a leg against the active starts' rows),
        # and cuBLAS may round them an ulp apart
        ms = tci.maxsamplevalue
        margin = 1e-15 * ms
        if rounding:
            abs_tt = tci_tpu_torch.TensorTrain(
                [c.abs() for c in tt.sitetensors()])
            pts = np.concatenate([np.asarray(starts), np.asarray(
                [p for p, _ in dev] + [p for p, _ in host]),
                tt_points(tt)[0]])
            margin = 2 * 4 * len(dims) * key[2] * 2.0 ** -53 * float(
                abs_tt.evaluate_batch(pts).max())
        if bp != hp or abs(be - he) > 1e-10 * he + margin:
            fail(f"{tag}: the program's best {bp} {be!r}, the host search's "
                 f"{hp} {he!r}")
        errs = [e for _, e in dev]
        if errs != sorted(errs, reverse=True):
            fail(f"{tag}: errors not sorted descending")
        piv = np.asarray([p for p, _ in dev])
        true = (f.evaluate_many(piv) - tt.evaluate_batch(piv)).abs().cpu()
        # |f - tt| recomputed through the train's own evaluation
        dev_err = (true - torch.tensor(errs)).abs()
        if bool((dev_err > 1e-9 * true + margin).any()):
            fail(f"{tag}: a returned error is not |f - tt| "
                 f"(max deviation {float(dev_err.max())})")
        rec_dev = None if recorded is None else abs(be - recorded)
        if rec_dev is not None and rec_dev > 1e-15 * ms:
            fail(f"{tag}: largest error {be!r}, tci_tpu's {recorded!r} "
                 f"(bound 1e-15 max|f| = {1e-15 * ms:.3e})")
        busy = device_busy_ms(search)
        tr = replay_trace(engine, keep=lambda k: k == key).get(key, {})
        print_program(f"{tag} fzone", [p for p in engine.programs()
                                       if p["key"] == key][0], tr)
        # per start, the program against the host search; each that
        # differs must have parted from it at a tie
        per_start = engine.floatingzone(tt.sitetensors(), np.asarray(starts))
        ndiffer, gap = parted_at_ties(
            engine, tt, f, starts, per_start,
            globalsearch._floatingzone_batch(tt, f, starts), margin)
        res = {"cold_s": cold, "warm_s": med(walls), "sweep_graph": tr,
               "eager_s": med(eager_walls),
               "host_cold_s": host_cold, "host_warm_s": med(host_walls),
               "sweeps": reads, "fetches": fetches,
               "capture_s": prog.capture_seconds, "nevals": nevals,
               "device_busy_ms": busy, "best": [list(bp), be],
               "recorded_abs_diff": rec_dev, "margin": margin,
               "differing_starts": ndiffer, "largest_tie_gap": gap}
        print(f"[fzone] {tag}: estimatetrueerror(nsearch=100) through the "
              f"engine's program {key}: cold {cold:.4f} s (records it, "
              f"capture {prog.capture_seconds * 1e3:.2f} ms), warm "
              f"{spread(walls)} (replays), queued eagerly "
              f"{spread(eager_walls)}; host lock-step search on the "
              f"card: cold {host_cold:.4f} s, warm {spread(host_walls)}; a "
              f"search: {reads} sweeps (status reads), {fetches} fetch, "
              f"nevals {nevals}; program uses {prog.uses}, replays "
              f"{prog.replays}, engine captures {engine.captures}; device "
              f"busy {'not measured' if busy is None else f'{busy:.3f} ms'} "
              f"a warm search (profiler); best {bp} error {be!r} (host "
              f"search {he!r}; {ndiffer} of 100 starts differ from it, each "
              f"parted at a tie, largest gap {gap:.3e}; margin "
              f"{margin:.3e}); "
              + (f"tci_tpu's on the CPU {recorded!r}, |diff| {rec_dev:.3e}; "
                 if recorded is not None else "")
              + f"{len(dev)} unique points, every error |f - tt| within "
              f"{float(dev_err.max()):.3e}", flush=True)
        return res

    tci1, ranks1, errors1, _, f1 = solve_config1("engine", loop=True)
    tci3, ranks3, errors3, _, f3 = solve_config3(loop=True)
    tt_entry["fzone"] = {
        "config1": fzone_phase("config1", tci1, f1, RECORDED_FZONE["config1"]),
        "config3": fzone_phase("config3", tci3, f3, RECORDED_FZONE["config3"])}

    # global pivots: config 1 truncated at rank 6, searched and inserted on
    # the engine and on the host tier (a plain f)
    def gp_solve(tier, f=None, graphs=True):
        if f is None:
            f = fscalar if tier == "host" else (
                tci_tpu_torch.TorchBatchEvaluator(fdev, localdims,
                                                  cuda_graphs=graphs))
        tci, _, _ = tci_tpu_torch.crossinterpolate2(
            np.float64, f, localdims, tolerance=1e-8, maxbonddim=6,
            rng=np.random.default_rng(0))
        rank0 = tci.rank()
        abstol = 1e-8 * tci.maxsamplevalue
        pivots, t_search = timed(lambda: tci_tpu_torch.searchglobalpivots(
            tci, f, abstol, nsearch=100, rng=np.random.default_rng(1)))
        nleft, t_add = timed(lambda: tci.addglobalpivots2sitesweep(
            f, pivots, tolerance=1e-8))
        return tci, rank0, pivots, nleft, t_search, t_add, t_search + t_add, f

    gp = {}
    for tier in ("engine", "host"):
        cold, counts = run_counted(f"4f globalpivots {tier}",
                                   lambda: gp_solve(tier, graphs=False),
                                   record=True)
        n = counts["rrlu_raw"] + counts["tier_calls"]
        if (counts["launches"] == 0 or counts["launches"] != n
                or counts["plain_cuda"] or cold[0].device != dev):
            fail(f"4f globalpivots {tier}: {counts}; every elimination should "
                 f"launch the kernel on the card")
        rec = (gp_solve(tier) if tier == "engine" else cold)
        kept = gp_solve(tier, f=rec[-1]) if tier == "engine" else gp_solve(
            tier)
        for run in (rec, kept):
            if (run[2] != cold[2] or run[3] != cold[3]
                    or run[0].Iset != cold[0].Iset):
                fail(f"4f globalpivots {tier}: a warm run differs")
        tci, rank0, pivots, nleft = cold[:4]
        if not pivots or nleft != 0 or not tci.rank() > rank0:
            fail(f"4f globalpivots {tier}: {len(pivots)} pivots found, "
                 f"{nleft} left after insertion, rank {rank0} -> "
                 f"{tci.rank()}")
        gp[tier] = {"tci": tci, "pivots": pivots, "launches":
                    counts["launches"], "cold": cold[4:6],
                    "warm": kept[4:6]}
        print(f"[globalpivots] {tier}: config 1 at maxbonddim 6 (rank "
              f"{rank0}): searchglobalpivots(nsearch=100) found "
              f"{len(pivots)} pivots, addglobalpivots2sitesweep left "
              f"{nleft}, rank {rank0} -> {tci.rank()}, linkdims "
              f"{tci.linkdims()}; search cold {cold[4]:.4f} s / warm "
              f"{kept[4]:.4f} s, insertion cold {cold[5]:.4f} s / warm "
              f"{kept[5]:.4f} s (cold: queued eagerly; warm: "
              f"{'an evaluator kept, replayed' if tier == 'engine' else 'again'}"
              f"); the run's {counts['launches']} rrLU launches "
              f"({counts['rrlu_raw']} rrlu_raw, {counts['tier_calls']} tier "
              f"calls), {counts['plain_cuda']} plain calls on CUDA",
              flush=True)
    if (gp["engine"]["pivots"] != gp["host"]["pivots"]
            or gp["engine"]["tci"].Iset != gp["host"]["tci"].Iset
            or gp["engine"]["tci"].Jset != gp["host"]["tci"].Jset):
        fail(f"4f globalpivots: the engine's pivots {gp['engine']['pivots']} "
             f"or index sets differ from the host tier's "
             f"{gp['host']['pivots']}")
    tt_entry["globalpivots"] = {t: {"pivots": len(g["pivots"]),
                                    "rank": g["tci"].rank(),
                                    "launches": g["launches"],
                                    "search_cold_s": g["cold"][0],
                                    "insert_cold_s": g["cold"][1],
                                    "search_warm_s": g["warm"][0],
                                    "insert_warm_s": g["warm"][1]}
                                for t, g in gp.items()}

    # compress, add, subtract on config 1's train
    tt1 = tci_tpu_torch.tensortrain(tci1)
    pts, vals1 = tt_points(tt1)
    scale1 = float(vals1.abs().max())
    fact_calls = [0]
    factorize = tt_mod.factorize

    def counting_factorize(*args, **kwargs):
        fact_calls[0] += 1
        return factorize(*args, **kwargs)

    tt_mod.factorize = counting_factorize
    compress = {}
    try:
        for method in ("LU", "CI", "SVD"):
            def solve(method=method):
                c = tt1.copy()
                fact_calls[0] = 0
                _, wall = timed(lambda: c.compress(method, tolerance=1e-12))
                return c, fact_calls[0], wall, None

            (c, calls, cold, _), counts = run_counted(
                f"4f compress {method}", solve, record=True)
            (_, _, warm, _), _ = run_counted(f"4f compress {method}", solve)
            diff = float((c.evaluate_batch(pts) - vals1).abs().max())
            want = calls if method != "SVD" else 0
            if (calls != 2 * (len(tt1) - 1) or counts["launches"] != want
                    or counts["rrlu_raw"] != want or counts["plain_cuda"]
                    or any(a > b for a, b in zip(c.linkdims(),
                                                 tt1.linkdims()))
                    or not diff <= 1e-10 * scale1):
                fail(f"4f compress {method}: {calls} factorize calls, "
                     f"{counts}, linkdims {c.linkdims()} (before "
                     f"{tt1.linkdims()}), max diff {diff} at 10^4 points")
            compress[method] = {"cold_s": cold, "warm_s": warm,
                                "factorize_calls": calls,
                                "launches": counts["launches"],
                                "max_diff": diff}
            print(f"[compress] {method}: config 1's train, tolerance 1e-12: "
                  f"linkdims {tt1.linkdims()} -> {c.linkdims()}, max |diff| "
                  f"{diff:.3e} at 10^4 points (bound 1e-10 max|tt| = "
                  f"{1e-10 * scale1:.3e}); {calls} factorize calls, "
                  f"{counts['launches']} rrLU launches, "
                  f"{counts['plain_cuda']} plain calls on CUDA; cold "
                  f"{cold:.4f} s, warm {warm:.4f} s", flush=True)
    finally:
        tt_mod.factorize = factorize
    # the kernel on the compressions' bond matrices: its device time a
    # launch over one LU compression's launches, and on the largest
    # recorded one (config 1: 120 x 12 in a 128 x 16 bucket) against the
    # plain version
    comp_ms = kernel_device_ms(
        lambda: tt1.copy().compress("LU", tolerance=1e-12), 3)
    _, _, args, kw = max((rec for rec in launch_inputs
                          if rec[0] == "4f compress LU"),
                         key=lambda rec: rec[2][0].numel())
    mp, npd = args[0].shape
    k_panel = int(originals[1](*args, **kw)[3])
    panel_ms = kernel_device_ms(lambda: originals[1](*args, **kw), 20)
    panel_plain = cuda_ms(lambda: lu_kernel.rrlu_plain(*args, **kw), 3)
    panel_bound, panel_by = bound_ms(*args[0].shape, int(args[1]),
                                     int(args[2]), k_panel,
                                     args[0].element_size())
    tt_entry["compress"] = {**compress, "rrlu_ms_mean": comp_ms,
                            "panel": f"{mp}x{npd} ({int(args[1])}x"
                                     f"{int(args[2])})",
                            "panel_k": k_panel, "panel_ms": panel_ms,
                            "panel_plain_ms": panel_plain,
                            "panel_bound_ms": panel_bound,
                            "panel_bound_by": panel_by}
    print(f"[compress] the rrLU kernel in an LU compression: "
          f"{'not measured' if comp_ms is None else f'{comp_ms:.5f} ms'} a "
          f"launch (profiler, mean of {compress['LU']['launches']} "
          f"launches); one {mp}x{npd} launch ({int(args[1])}x{int(args[2])}"
          f", k = {k_panel}): kernel {panel_ms} ms (profiler), plain "
          f"{panel_plain:.4f} ms, bound {panel_bound:.6f} ms ({panel_by})",
          flush=True)

    add0 = tci_tpu_torch.add(tt1, tt1)
    (add1, add_wall) = timed(lambda: tci_tpu_torch.add(tt1, tt1,
                                                       tolerance=1e-12))
    add_diff = float((add1.evaluate_batch(pts) - 2 * vals1).abs().max())
    sub, sub_wall = timed(lambda: tci_tpu_torch.subtract(tt1, tt1))
    n1, nsub = tt1.norm(), sub.norm()
    if (max(add0.linkdims()) != 2 * tt1.rank()
            or add1.linkdims() != tt1.linkdims()
            or not add_diff <= 2e-10 * scale1 or not nsub <= 1e-12 * n1):
        fail(f"4f add/subtract: add linkdims {add0.linkdims()} untruncated, "
             f"{add1.linkdims()} at 1e-12, max |add - 2 tt| {add_diff}, "
             f"|tt - tt| {nsub} against |tt| {n1}")
    tt_entry["add"] = {"rank_stacked": max(add0.linkdims()),
                       "rank": max(add1.linkdims()), "max_diff": add_diff,
                       "wall_s": add_wall, "subtract_norm": nsub,
                       "subtract_wall_s": sub_wall}
    print(f"[add] add(tt, tt): rank {max(add0.linkdims())} stacked (SVD at "
          f"tolerance 0 keeps it), {max(add1.linkdims())} at tolerance "
          f"1e-12 ({add_wall:.4f} s), max |add - 2 tt| {add_diff:.3e} at "
          f"10^4 points; |subtract(tt, tt)| {nsub:.3e} against |tt| "
          f"{n1:.6f} ({sub_wall:.4f} s)", flush=True)

    # fulltensor of config 1 against f on all 10^8 grid points
    full, full_cold = timed(lambda: tci_tpu_torch.fulltensor(tt1))
    del full
    full, full_warm = timed(lambda: tci_tpu_torch.fulltensor(tt1))
    L1 = len(localdims)
    s = torch.zeros((1,) * L1, dtype=torch.float64, device=dev)
    for ax, d in enumerate(localdims):
        sq = (torch.arange(d, dtype=torch.float64, device=dev) + 1.0) ** 2
        s = s + sq.reshape([d if a == ax else 1 for a in range(L1)])
    full_err = float((full - 1.0 / (1.0 + s)).abs().max())
    fro = float(torch.linalg.vector_norm(full))
    del s, full
    full_busy = device_busy_ms(lambda: tci_tpu_torch.fulltensor(tt1))
    if not full_err < 1e-7 or abs(n1 - fro) > 1e-12 * fro:
        fail(f"4f fulltensor: max |tt - f| {full_err} over the grid, "
             f"|tt| {n1!r} against the full tensor's {fro!r}")
    tt_entry["fulltensor"] = {"cold_s": full_cold, "warm_s": full_warm,
                              "device_busy_ms": full_busy,
                              "max_err": full_err,
                              "norm_rel_diff": abs(n1 - fro) / fro}
    print(f"[fulltensor] config 1: 10^8 float64 values (800 MB) on the card "
          f"in {full_cold:.4f} s cold, {full_warm:.4f} s warm, device busy "
          f"{'not measured' if full_busy is None else f'{full_busy:.3f} ms'} "
          f"(profiler); max |tt - f| "
          f"over every grid point {full_err:.3e}; tt.norm() {n1!r}, the full "
          f"tensor's Frobenius norm {fro!r} (relative diff "
          f"{abs(n1 - fro) / fro:.3e})", flush=True)

    # the caches
    cache = tci_tpu_torch.TTCache(tt1)
    cache_diff = 0.0
    for b in range(len(localdims)):
        panel_c = cache.batch_evaluate(tci1.Iset[b], tci1.Jset[b], 1)
        rows = [tuple(I) + (v,) + tuple(J) for I in tci1.Iset[b]
                for v in range(localdims[b]) for J in tci1.Jset[b]]
        ref_c = tt1.evaluate_batch(rows).reshape(panel_c.shape)
        cache_diff = max(cache_diff, float((panel_c - ref_c).abs().max()))
    if panel_c.device != dev or cache_diff > 1e-13 * scale1:
        fail(f"4f TTCache: max |cache - tt| {cache_diff}")
    seen = set()

    def fseen(x):
        seen.add(tuple(x))
        return fscalar(x)

    def cf_solve():
        cf = tci_tpu_torch.CachedFunction(fseen, localdims)
        seen.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tci, ranks, errors = tci_tpu_torch.crossinterpolate2(
            np.float64, cf, localdims, tolerance=1e-8,
            rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        return tci, ranks, errors, cf, time.perf_counter() - t0, None

    (tci_cf, ranks_cf, errors_cf, cf, cf_cold, _), counts_cf = run_counted(
        "4f cachedfunction", cf_solve, record=True)
    check_config1("4f cachedfunction", tci_cf, ranks_cf, errors_cf,
                  counts_cf)
    cf_warm = cf_solve()[-2]
    if ((tci_cf.Iset, tci_cf.Jset) != results["host"]["sets"]
            or cf.ncacheddata() != len(seen) or cf.device != dev):
        fail(f"4f CachedFunction: sets differ from the host tier's, or "
             f"{cf.ncacheddata()} cached for {len(seen)} distinct points")
    tt_entry["caches"] = {"ttcache_max_diff": cache_diff,
                          "cachedfunction_cold_s": cf_cold,
                          "cachedfunction_warm_s": cf_warm,
                          "cached": cf.ncacheddata(),
                          "launches": counts_cf["launches"]}
    print(f"[caches] TTCache(tt).batch_evaluate over the TCI's own (Iset, "
          f"Jset): max |diff| {cache_diff:.3e} against tt.evaluate_batch; "
          f"CachedFunction around config 1's scalar f, host tier: ranks "
          f"{ranks_cf}, errors {[f'{e:.6e}' for e in errors_cf]} (the host "
          f"tier's), {cf.ncacheddata()} cached = {len(seen)} distinct points "
          f"sampled, cold {cf_cold:.4f} s, warm {cf_warm:.4f} s, "
          f"{counts_cf['launches']} rrLU launches", flush=True)

    # -- 4g. BASELINE config 5: the complex Feynman-type integrand -----------
    # benchmarks/bench_feynman.py at full size: N = 6, GK15 on [0, 1],
    # tolerance 1e-7, nsearchglobalpivot=10, through crossinterpolate2
    # (np.complex128, ...) with a default TorchBatchEvaluator (the engine,
    # tci_tpu's default protocol) of the integrand in native complex. Cold
    # (recorded for phase 5: eager), warm (a new evaluator: records the
    # graphs), the median of 10 warm walls on a kept evaluator, one counted
    # run with its device busy time; once on the fused tier and once on the
    # host tier (its numpy twin); then, on its train, the floating-zone
    # program against the host search and compress (LU, CI, SVD).
    from tci_tpu_torch.ops.kronrod import kronrod

    x5, w5, _ = kronrod(15 // 2)
    nodes5, weights5 = (x5 + 1) / 2, w5 / 2
    norm5 = 15.0 ** 6
    dims5 = [len(x5)] * 6
    nodes5_d = torch.as_tensor(nodes5, device=dev)
    weights5_d = torch.as_tensor(weights5, device=dev)

    def f5torch(idx):
        t = nodes5_d[idx]
        damp = torch.exp(-((t[:, :, None] - t[:, None, :]) ** 2).sum((1, 2)))
        return torch.polar(weights5_d[idx].prod(1) * damp * norm5,
                           10.0 * t.sum(1))

    def f5numpy(idx):
        t = nodes5[idx]
        damp = np.exp(-np.sum((t[:, :, None] - t[:, None, :]) ** 2,
                              axis=(1, 2)))
        return (np.prod(weights5[idx], axis=1) * damp * norm5
                * np.exp(1j * 10.0 * np.sum(t, axis=1)))

    # the dense Gauss-Kronrod sum over all 15^6 grid points, with plain
    # torch on the card, 15^4 points a chunk: an independent reference
    tail5 = torch.stack(torch.meshgrid(
        *[torch.arange(15, device=dev)] * 4, indexing="ij"), -1).reshape(-1, 4)
    dense5 = torch.zeros((), dtype=torch.complex128, device=dev)
    for i, j in itertools.product(range(15), repeat=2):
        head = torch.tensor([i, j], device=dev).expand(tail5.shape[0], 2)
        dense5 += f5torch(torch.cat([head, tail5], 1)).sum()
    dense5 = complex(dense5) / norm5
    del tail5

    def solve_config5(tier="engine", f=None, graphs=True):
        if f is not None:
            set_graphs(f, graphs)
        elif tier == "host":
            f = tci_tpu_torch.VectorizedBatchEvaluator(
                f5numpy, dims5, dtype=np.complex128)
        else:
            f = tci_tpu_torch.TorchBatchEvaluator(
                f5torch, dims5, dtype=torch.complex128,
                enable_device_sweep=tier == "engine", cuda_graphs=graphs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tci, ranks, errors = tci_tpu_torch.crossinterpolate2(
            np.complex128, f, dims5, tolerance=1e-7, nsearchglobalpivot=10,
            rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        return tci, ranks, errors, time.perf_counter() - t0, f

    def check_config5(tag, tci, ranks, errors, counts, f, tier):
        integral = tci.sum() / norm5
        d_ref, d_dense = (abs(integral - CONFIG5_INTEGRAL),
                          abs(integral - dense5))
        if (ranks != CONFIG5_RANKS or not errors[-1] < 1e-7
                or tci.linkdims() != CONFIG5_LINKDIMS):
            fail(f"config 5 {tag}: ranks {ranks}, errors {errors}, linkdims "
                 f"{tci.linkdims()}; expected {CONFIG5_RANKS}, < 1e-7, "
                 f"{CONFIG5_LINKDIMS}")
        if not (d_ref < 1e-9 and d_dense < 1e-9):
            fail(f"config 5 {tag}: integral {integral!r}, |I - tci_tpu's| "
                 f"{d_ref:.3e}, |I - dense GK sum| {d_dense:.3e} (bound 1e-9)")
        if tci.device.type != "cuda" or not all(
                t.device.type == "cuda" and t.dtype == torch.complex128
                for t in tci.sitetensors()):
            fail(f"config 5 {tag}: ran on {tci.device} or its site tensors "
                 f"are not complex128 on the card")
        n = counts["rrlu_raw"] + counts["tier_calls"]
        if counts["launches"] == 0 or counts["launches"] != n or counts[
                "plain_cuda"]:
            fail(f"config 5 {tag}: {counts}; every elimination should launch "
                 f"the complex kernel and none take the plain version")
        if tier == "engine":
            check_engine_run(f"config 5 {tag}", counts, f, None)
        return integral, d_ref, d_dense

    DefaultGlobalPivotFinder.__call__ = counting_finder
    finder_calls[0] = 0
    try:
        res5, counts5c = run_counted(
            "config5", lambda: solve_config5(graphs=False), record=True)
        check_config5("cold", *res5[:3], counts5c, res5[-1], "engine")
        cold5 = res5[3]
        (tci5, ranks5, errors5, warm5, f5), counts5 = run_counted(
            "config5", solve_config5)
        int5, dref5, ddense5 = check_config5("warm", tci5, ranks5, errors5,
                                             counts5, f5, "engine")
        walls5 = [solve_config5(f=f5)[3] for _ in range(10)]
        res, counts5k = run_counted("config5", lambda: solve_config5(f=f5),
                                    f=f5)
        check_config5("kept", *res[:3], counts5k, f5, "engine")
        engine5 = f5.device_sweep_engine
        if not all_replayed(engine5) or not engine5.loop_blocks:
            fail(f"config 5: programs {engine5.programs()}, loop blocks "
                 f"{engine5.loop_blocks}; every warm run should replay the "
                 f"optimize loop's graphs")
    finally:
        DefaultGlobalPivotFinder.__call__ = host_finder
    if finder_calls[0]:
        fail(f"config 5: the host finder ran {finder_calls[0]} times on the "
             f"engine")
    busy5 = device_busy_ms(lambda: solve_config5(f=f5))
    med5 = med(walls5)
    idle5 = None if busy5 is None else 1 - busy5 / (med5 * 1e3)
    config5 = {"cold_s": cold5, "warm_s": warm5, "kept_median_s": med5,
               "kept_walls": walls5, "device_busy_ms": busy5,
               "idle_share": idle5, "launches": counts5k["launches"],
               "launches_cold": counts5c["launches"],
               "fetches": counts5k["fetches"], "nevals": counts5k["nevals"],
               "ranks": ranks5, "errors": errors5,
               "linkdims": tci5.linkdims(), "integral": [int5.real, int5.imag],
               "dense_gk_sum": [dense5.real, dense5.imag],
               "abs_diff_tci_tpu": dref5, "abs_diff_dense": ddense5,
               "imax": engine5.Imax}
    print(f"[config5] crossinterpolate2(np.complex128, TorchBatchEvaluator), "
          f"N = 6, GK15, tolerance 1e-7, the engine (default protocol): cold "
          f"{cold5:.4f} s (queued eagerly), warm {warm5:.4f} s (records), "
          f"one evaluator kept: 10 replayed runs {spread(walls5)}; ranks "
          f"{ranks5}, errors {[f'{e:.6e}' for e in errors5]}, linkdims "
          f"{tci5.linkdims()}; integral {int5!r}, |I - tci_tpu's| "
          f"{dref5:.3e}, |I - dense GK sum {dense5!r}| {ddense5:.3e}; "
          f"{counts5k['launches']} complex rrLU launches a run "
          f"({counts5c['launches']} cold), fetches {counts5k['fetches']}, "
          f"{counts5k['plain_cuda']} plain calls on CUDA, 0 host-finder "
          f"calls, Imax {engine5.Imax}, nevals {counts5k['nevals']}; device "
          f"busy {'not measured' if busy5 is None else f'{busy5:.3f} ms'} a "
          f"kept run (profiler), idle share "
          f"{'not measured' if idle5 is None else f'{idle5:.4f}'}",
          flush=True)
    for tier in ("fused", "host"):
        res, counts = run_counted(f"config5_{tier}",
                                  lambda: solve_config5(tier))
        val, dref, ddense = check_config5(tier, *res[:3], counts, res[-1],
                                          tier)
        if tier == "fused" and not counts["fetches"].get("fused_bond"):
            fail(f"config 5 fused: fetches {counts['fetches']}")
        if tier == "host" and (counts["tier_calls"] or counts["fetches"]):
            fail(f"config 5 host: device tiers ran ({counts})")
        config5[tier] = {"wall_s": res[3], "launches": counts["launches"],
                         "integral": [val.real, val.imag],
                         "abs_diff_engine": abs(val - int5)}
        print(f"[config5] {tier} tier: {res[3]:.4f} s, ranks {res[1]}, "
              f"integral {val!r}, |I - the engine's| {abs(val - int5):.3e}; "
              f"{counts['launches']} complex rrLU launches "
              f"({counts['rrlu_raw']} rrlu_raw, {counts['tier_calls']} tier "
              f"calls), {counts['plain_cuda']} plain calls on CUDA",
              flush=True)
    # the API after a run, on config 5's train
    tt_entry["fzone"]["config5"] = fzone_phase("config5", tci5, f5, None,
                                               rounding=True)
    tt5 = tci_tpu_torch.tensortrain(tci5)
    pts5, vals5 = tt_points(tt5)
    scale5 = float(vals5.abs().max())
    config5["compress"] = {}
    for method in ("LU", "CI", "SVD"):
        def solve(method=method):
            c = tt5.copy()
            _, wall = timed(lambda: c.compress(method, tolerance=1e-12))
            return c, wall, None

        (c, wall, _), counts = run_counted(f"4g compress {method}", solve,
                                           record=True)
        diff = float((c.evaluate_batch(pts5) - vals5).abs().max())
        want = 2 * (len(tt5) - 1) if method != "SVD" else 0
        if (counts["launches"] != want or counts["plain_cuda"]
                or c.sitetensors()[0].dtype != torch.complex128
                or any(a > b for a, b in zip(c.linkdims(), tt5.linkdims()))
                or not diff <= 1e-10 * scale5):
            fail(f"4g compress {method}: {counts}, linkdims {c.linkdims()} "
                 f"(before {tt5.linkdims()}), max diff {diff} at 10^4 "
                 f"points")
        config5["compress"][method] = {"wall_s": wall,
                                       "launches": counts["launches"],
                                       "max_diff": diff,
                                       "linkdims": c.linkdims()}
        print(f"[compress] {method}: config 5's complex train, tolerance "
              f"1e-12: linkdims {tt5.linkdims()} -> {c.linkdims()}, max "
              f"|diff| {diff:.3e} at 10^4 points (bound 1e-10 max|tt| = "
              f"{1e-10 * scale5:.3e}); {counts['launches']} complex rrLU "
              f"launches, cold {wall:.4f} s", flush=True)

    # -- 3d. BASELINE config 2 by rook ----------------------------------------
    # (after phase 4g: it records its launches for phase 5 as phase 4 does)
    A2, R2 = config2_A, 256
    N2 = A2.shape[0]
    amax2 = float(A2.abs().max())

    def rook2(precision, A=A2, seed=7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lu = tci_tpu_torch.rrlu(A, maxrank=R2, reltol=1e-10,
                                pivotsearch="rook", precision=precision,
                                rng=np.random.default_rng(seed))
        torch.cuda.synchronize()
        return lu, time.perf_counter() - t0, None

    def recon2(lu, A=A2):
        return float((lu.left() @ lu.right() - A).abs().max()) / amax2

    def full2():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lu = tci_tpu_torch.rrlu(A2, maxrank=R2, reltol=1e-10)
        torch.cuda.synchronize()
        return lu, time.perf_counter() - t0

    rook_entry = {"config2": {}}
    full_walls = [full2()[1] for _ in range(10)]
    for precision in ("f64", "mixed"):
        tag = f"config2_rook_{precision}"
        (lu, cold, _), counts = run_counted(tag, lambda: rook2(precision),
                                            record=True)
        recs = [r for r in launch_inputs if r[0] == tag]
        rel = recon2(lu)
        if (lu.npivot != R2 or lu.npivot != config2_k or not rel < 1e-8
                or counts["plain_cuda"] or counts["launches"] != len(recs)
                or lu.L.device.type != "cuda"):
            fail(f"3d config 2 rook {precision}: npivot {lu.npivot} (full "
                 f"pivoting: {config2_k}), max|LU - A|/max|A| {rel:.3e}, "
                 f"{counts['launches']} kernel launches for {len(recs)} "
                 f"eliminations, {counts['plain_cuda']} plain calls on CUDA")
        modes = {}
        for rec in recs:
            P = rec[2][0]
            key = (f"{lu_cuda.host_mode(0, *P.shape[1:], P.dtype)} "
                   f"{str(P.dtype)[6:]} {P.shape[1]}x{P.shape[2]}")
            modes[key] = modes.get(key, 0) + 1
        walls = [rook2(precision)[1] for _ in range(10)]
        wall = med(walls)
        rook_entry["config2"][precision] = {
            "cold_s": cold, "median_s": wall, "walls": walls,
            "gflops": 2.0 * R2 * N2 * N2 / wall / 1e9, "npivot": lu.npivot,
            "rel_recon": rel, "launches": counts["launches"],
            "launches_by_mode": modes, "fetches": counts["fetches"]}
        print(f"[config2-rook] rrlu({N2}^2 f64, maxrank {R2}, reltol 1e-10, "
              f"pivotsearch='rook', precision='{precision}'): npivot "
              f"{lu.npivot} (full pivoting {config2_k}), max|LU - A|/max|A| "
              f"{rel:.3e}; cold {cold:.4f} s, warm median of 10 "
              f"{spread(walls)} = {2.0 * R2 * N2 * N2 / wall / 1e9:.3f} "
              f"GFLOP/s as 2rN^2; {counts['launches']} kernel launches "
              f"(host mode, dtype, panel: {json.dumps(modes)}), "
              f"{counts['plain_cuda']} plain calls on CUDA, fetches "
              f"{counts['fetches']}", flush=True)
    # the mixed hunt with one stage (rrlu's rule asks for two at reltol
    # 1e-10, ROADMAP C-ref-1), to set the f32 hunt itself against the f64 one
    walls1 = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lu1 = tci_tpu_torch.rrlu(A2, maxrank=R2, reltol=1e-10,
                                 pivotsearch="rook", precision="mixed",
                                 hunt_stages=1,
                                 rng=np.random.default_rng(7))
        torch.cuda.synchronize()
        walls1.append(time.perf_counter() - t0)
    walls1 = walls1[1:]
    rel1 = recon2(lu1)
    if lu1.npivot != R2 or not rel1 < 1e-8:
        fail(f"3d config 2 rook mixed, one hunt stage: npivot {lu1.npivot}, "
             f"max|LU - A|/max|A| {rel1:.3e}")
    rook_entry["config2"]["mixed_one_stage"] = {
        "median_s": med(walls1), "walls": walls1, "rel_recon": rel1}
    print(f"[config2-rook] precision='mixed' with hunt_stages=1: warm median "
          f"of 10 {spread(walls1)}, max|LU - A|/max|A| {rel1:.3e}",
          flush=True)
    wfull = med(full_walls)
    rook_entry["config2"]["full"] = {
        "median_s": wfull, "walls": full_walls, "kernel_ms": kms,
        "gflops": 2.0 * config2_k * N2 * N2 / wfull / 1e9}
    print(f"[config2-rook] full pivoting, same matrix, same call: rrlu warm "
          f"median of 10 {spread(full_walls)} = "
          f"{2.0 * config2_k * N2 * N2 / wfull / 1e9:.3f} GFLOP/s as 2rN^2 "
          f"(the kernel alone {kms:.3f} ms, phase 3b)", flush=True)
    # the serving pattern: four factorizations queued, then collected
    mats = [A2, A2.roll(1, 1), A2.flip(0), A2.roll(7, 0)]
    for precision in ("f64", "mixed"):
        FETCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = [tci_tpu_torch.rrlu_serving(
            M, maxrank=R2, reltol=1e-10, precision=precision,
            rng=np.random.default_rng(20 + i), defer=True)
            for i, M in enumerate(mats)]
        queued = time.perf_counter() - t0
        before = FETCHES["rook"]
        served = [p.result() for p in pending]
        wall = time.perf_counter() - t0
        recs = [float((r.left() @ r.right() - M).abs().max()) / amax2
                for r, M in zip(served, mats)]
        if (before or FETCHES["rook"] != 4
                or any(r.npivots() != R2 for r in served)
                or not max(recs) < 1e-8):
            fail(f"3d rrlu_serving defer {precision}: fetches {before} "
                 f"before result(), {FETCHES['rook']} after; npivots "
                 f"{[r.npivots() for r in served]}, reconstruction {recs}")
        rook_entry["config2"][f"serving_{precision}"] = {
            "queued_s": queued, "wall_s": wall, "max_rel_recon": max(recs)}
        print(f"[config2-rook] rrlu_serving(defer=True, '{precision}') over "
              f"4 matrices: queued in {queued:.4f} s, all 4 results after "
              f"{wall:.4f} s (one fetch each at result()), npivot {R2}, "
              f"max|LU - A|/max|A| <= {max(recs):.3e}", flush=True)
    # the completion of the missing factor: a triangular solve against the
    # k x k pivot block, or its inverse and a GEMM (tci_tpu's form), on a
    # pivot block of the full-pivot factorization
    lu_full = full2()[0]
    Pblk = torch.triu(lu_full.U[:R2, :R2])
    Cblk = A2[R2:, :R2].contiguous()
    eye2 = torch.eye(R2, dtype=A2.dtype, device=dev)
    x_solve = torch.linalg.solve_triangular(Pblk, Cblk, upper=True,
                                            left=False)
    x_inv = Cblk @ torch.linalg.solve_triangular(Pblk, eye2, upper=True)
    t_solve = cuda_ms(lambda: torch.linalg.solve_triangular(
        Pblk, Cblk, upper=True, left=False), 20)
    t_inv = cuda_ms(lambda: Cblk @ torch.linalg.solve_triangular(
        Pblk, eye2, upper=True), 20)
    diff = float((x_solve - x_inv).abs().max() / x_solve.abs().max())
    rook_entry["complete"] = {"solve_ms": t_solve, "inverse_gemm_ms": t_inv,
                              "rel_diff": diff}
    print(f"[complete] L2 = C U^-1 with C {tuple(Cblk.shape)}, U {R2}^2 "
          f"upper (config 2's pivot block): solve_triangular {t_solve:.4f} "
          f"ms, inverse + GEMM {t_inv:.4f} ms (events, mean of 20); max "
          f"relative difference {diff:.3e}", flush=True)

    # -- 4h. BASELINE config 1 by rook ----------------------------------------
    rng_orig = np.random.default_rng

    def solve_rook1(tier, f=None, graphs=True):
        """Config 1 by rook through one tier (benchmarks/bench_rook.py):
        "loop" / "persweep", the engine under the default / per-sweep
        protocol (seeded by ROOK_ENGINE_SEED, on `f` when given: an
        evaluator that keeps its graphs); "fused", the per-bond device tier;
        "host", a plain scalar f (its bonds' unseeded default_rng() draws
        seeded in call order, as RECORDED_ROOK was made). Returns (tci,
        ranks, errors, per-bond warnings, wall, f)."""
        if tier == "host":
            f = fscalar
        elif f is None:
            f = tci_tpu_torch.TorchBatchEvaluator(
                fdev, localdims, enable_device_sweep=tier != "fused",
                cuda_graphs=graphs)
        else:
            set_graphs(f, graphs)
        if tier in ("loop", "persweep"):
            eng = f.device_sweep_engine
            eng._rng = rng_orig(ROOK_ENGINE_SEED)
            eng.use_sweep_pair = eng.use_optimize_loop = tier == "loop"
        if tier == "host":
            draws = itertools.count(100)
            np.random.default_rng = lambda seed=None: rng_orig(
                next(draws) if seed is None else seed)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                tci, ranks, errors = tci_tpu_torch.crossinterpolate2(
                    np.float64, f, localdims, tolerance=1e-8,
                    pivotsearch="rook", rng=rng_orig(3))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            np.random.default_rng = rng_orig
        tiered = [w for w in caught if "per-bond rook tier" in str(w.message)]
        return tci, ranks, errors, tiered, wall, f

    def check_rook1(tag, tier, res, counts):
        tci, ranks, errors, tiered, _, f = res
        x = (1, 2, 3, 4, 5, 4, 3, 2)
        v = np.asarray(x, dtype=float) + 1.0
        point_err = abs(tci(x) - 1.0 / (1.0 + v @ v))
        want_r, want_e = RECORDED_ROOK[tier]
        if tier == "fused":
            want_e = errors  # C-port-12: the ranks only (and the bounds below)
        if ranks != want_r or not np.allclose(errors, want_e, rtol=0,
                                              atol=1e-15):
            fail(f"4h {tag}: ranks {ranks}, errors {errors}; tci_tpu's "
                 f"{want_r}, {want_e}")
        if not errors[-1] < 1e-8 or not point_err < 1e-7:
            fail(f"4h {tag}: final error {errors[-1]}, pointwise error "
                 f"{point_err}")
        if counts["plain_cuda"] or counts["launches"] == 0:
            fail(f"4h {tag}: {counts['launches']} kernel launches, "
                 f"{counts['plain_cuda']} plain calls on CUDA")
        if not all(t.device.type == "cuda" for t in tci.sitetensors()):
            fail(f"4h {tag}: site tensors left the card")
        if tier in ("loop", "persweep"):
            engine = f.device_sweep_engine
            if (tiered or f._fused_updater is not None
                    or f._panel_sampler is not None or engine.declined
                    or counts["launches"] != counts["tier_calls"]):
                fail(f"4h {tag}: the engine declined or a per-bond tier ran "
                     f"({len(tiered)} warnings, declined {engine.declined}, "
                     f"{counts['launches']} launches for "
                     f"{counts['tier_calls']} engine calls)")
            if counts["nevals"] != RECORDED_ROOK_NEVALS:
                fail(f"4h {tag}: nevals {counts['nevals']}, tci_tpu's "
                     f"{RECORDED_ROOK_NEVALS}")
        if tier == "fused" and (not tiered or f._panel_sampler is None):
            fail(f"4h {tag}: the per-bond device tier did not run")
        return point_err

    rook1 = {}
    for tier in ("loop", "persweep", "fused", "host"):
        res, counts = run_counted(f"rook_{tier}",
                                  lambda: solve_rook1(tier, graphs=False),
                                  record=True)
        check_rook1(f"{tier} cold", tier, res, counts)
        cold, cold_counts = res[-2], counts
        recs = [r for r in launch_inputs if r[0] == f"rook_{tier}"]
        dead = sum(int((r[2][3] == 0).sum()) for r in recs if r[1])
        res, counts = run_counted(f"rook_{tier}", lambda: solve_rook1(tier))
        point = check_rook1(f"{tier} warm", tier, res, counts)
        rook1[tier] = {"cold_s": cold, "warm_s": res[-2],
                       "launches": counts["launches"],
                       "launches_cold": cold_counts["launches"],
                       "dead_launches_cold": dead,
                       "fetches": counts["fetches"],
                       "nevals": counts["nevals"], "ranks": res[1],
                       "errors": res[2], "point_err": point}
        print(f"[config1-rook] {tier}: cold {cold:.4f} s (queued eagerly, "
              f"{cold_counts['launches']} launches, {dead} of them dead "
              f"predicated steps), warm {res[-2]:.4f} s; ranks {res[1]}, "
              f"errors {[f'{e:.6e}' for e in res[2]]} (tci_tpu's "
              f"{[f'{e:.6e}' for e in RECORDED_ROOK[tier][1]]}"
              + ("; the port's on a CPU "
                 f"{[f'{e:.6e}' for e in ROOK_FUSED_PORT_CPU]}"
                 if tier == "fused" else "") + "), "
              f"|tt - f| at (1,2,3,4,5,4,3,2) {point:.3e}; {counts['launches']}"
              f" kernel launches, fetches {counts['fetches']}, nevals "
              f"{counts['nevals']}, {counts['plain_cuda']} plain calls on "
              f"CUDA", flush=True)
    # the engine's default protocol on a kept evaluator, beside the full
    # pivot loop's (phase 4e, this call)
    kept = solve_rook1("loop")[-1]  # a new evaluator: it records
    walls = []
    for _ in range(10):
        res, counts = run_counted("rook_loop kept",
                                  lambda: solve_rook1("loop", f=kept), f=kept)
        check_rook1("loop kept", "loop", res, counts)
        walls.append(res[-2])
    engine = kept.device_sweep_engine
    if not all_replayed(engine) or not engine.loop_blocks:
        fail(f"4h rook loop: programs {engine.programs()}; every kept run "
             f"should replay")
    full_med = loop_results["config1"]["kept_graphs_median"]
    _, full_counts = run_counted(
        "config1 full nevals", lambda: solve_config1("engine", loop=True))
    busy = device_busy_ms(lambda: solve_rook1("loop", f=kept))
    nk, nrrlu = count_kernels(lambda: solve_rook1("loop", f=kept))
    trace = replay_trace(engine, lambda key: key[0] == "oloop")
    step = max((p for p in engine.programs() if p["key"][0] == "oloop"),
               key=lambda p: p["uses"])
    st = trace[step["key"]]
    rook1["loop"].update({
        "kept_median_s": med(walls), "kept_walls": walls,
        "full_loop_kept_median_s": full_med,
        "full_nevals": full_counts["nevals"], "device_busy_ms": busy,
        "profiled_kernels": nk, "profiled_rrlu_kernels": nrrlu,
        "step": {"key": str(step["key"]),
                 "captured_launches": step["captured_launches"],
                 "nodes": st["nodes"], "device_ms": st["device_ms"],
                 "launch_ms": st["launch_ms"],
                 "rrlu_us_by_grid": st["rrlu_us_by_grid"]}})
    print(f"[config1-rook] engine, default protocol, one evaluator kept: 10 "
          f"replayed runs {spread(walls)} against full pivoting's "
          f"{full_med:.4f} s (phase 4e); nevals a run rook "
          f"{rook1['loop']['nevals']} / full {full_counts['nevals']}; one "
          f"profiled run: {nk} device kernels, {nrrlu} of them rrLU, device "
          f"busy {'not measured' if busy is None else f'{busy:.3f} ms'}; the "
          f"loop step's graph {step['key']}: {step['captured_launches']} "
          f"rrLU launches (5 predicated steps a bond), {st['nodes']} device "
          f"items, {st['device_ms']:.3f} ms on the device, launch "
          f"{st['launch_ms']:.3f} ms host; rrLU (count, mean us) by grid "
          f"{st['rrlu_us_by_grid']}", flush=True)
    rook_entry["config1"] = rook1

    # -- 4i. tensor-train contraction and the device compression ------------
    # examples/04_contraction_mpo.py's operands at sizes quantics users
    # contract: L = 20 sites of legs (2, 2), N(0, 1)/sqrt(chi) cores from
    # default_rng(42); (a) zip-up and (b) naive with torch_native=True at
    # chi = 16 (exact product bond 256: 1024 x 256 and 256 x 1024 panels,
    # the cluster mode), (c) compress(torch_native=True) of config 1's train
    # beside the host compress("LU"), (d) TCI on the engine at chi = 8
    # (exact rank 64), (e) complex128 zip-up and naive at L = 12, chi = 8.
    # Each: linkdims, values at 1,000 fused indices against transfer
    # matrices computed here with numpy, a kernel launch a split and no
    # plain call, one fetch a device-tier call; the cold run is recorded
    # for phase 5.
    from torch.profiler import ProfilerActivity

    from tci_tpu_torch.models import contraction as contraction_mod

    def memory_line():
        """Allocated and reserved device memory, and what of it the private
        pools of CUDA graphs hold, in GiB, from the allocator's snapshot."""
        private = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                      if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))
        return (torch.cuda.memory_allocated() / 2**30,
                torch.cuda.memory_reserved() / 2**30, private / 2**30)

    # the memory phases 4-4h leave: what their graphs' private pools hold,
    # those of engines still alive and the cached segments of pools whose
    # engines are gone (a capture that lacks memory gives those back and
    # records once more, DeviceSweepEngine._capture)
    memory = {"before_gib": memory_line()}
    print(f"[contract] before 4i: device memory allocated / reserved / in "
          f"private pools "
          f"{' / '.join(f'{x:.3f}' for x in memory['before_gib'])} GiB",
          flush=True)

    def contract_operands(L, chi, complex_=False):
        rng = np.random.default_rng(42)

        def mpo():
            b = [1] + [chi] * (L - 1) + [1]
            out = []
            for n in range(L):
                t = rng.standard_normal((b[n], 2, 2, b[n + 1]))
                if complex_:
                    t = t + 1j * rng.standard_normal(t.shape)
                out.append(t / np.sqrt(chi))
            return out
        return mpo(), mpo()

    def exact_product(a, b, idx):
        """The product at (n, L) fused indices (i * 2 + j), by numpy
        transfer matrices over the operands' numpy cores."""
        v = np.ones((len(idx), 1, 1))
        for n in range(len(a)):
            i, j = idx[:, n] // 2, idx[:, n] % 2
            An = a[n].transpose(1, 0, 2, 3)[i]  # (N, la, k, ra)
            Bn = b[n].transpose(2, 0, 1, 3)[j]  # (N, lb, k, rb)
            v = np.einsum("nab,nakc,nbkd->ncd", v, An, Bn)
        return v[:, 0, 0]

    def values_at(tt, idx):
        fused = tci_tpu_torch.TensorTrain(
            [t.reshape(t.shape[0], -1, t.shape[-1]) for t in tt])
        return fused.evaluate_batch(idx).cpu().numpy()

    made = []
    plain_evaluator = contraction_mod.TorchBatchEvaluator

    class KeptEvaluator(plain_evaluator):
        """The TorchBatchEvaluator that contract_TCI makes, kept for its
        counts; graphs=False (a recorded run) queues the engine's sweeps
        eagerly."""
        graphs = True

        def __init__(self, *args, **kwargs):
            kwargs["cuda_graphs"] = KeptEvaluator.graphs
            super().__init__(*args, **kwargs)
            made.append(self)

    contraction = {}

    def contraction_run(tag, solve, expect_launches, fetch_key, linkdims,
                        check_values):
        """Cold (recorded for phase 5) and 10 warm runs of solve(), which
        returns (tt, wall, evaluator or None); the counts of the cold run
        and of one warm run."""
        def counted(record):
            made.clear()
            KeptEvaluator.graphs = not record
            contraction_mod.TorchBatchEvaluator = KeptEvaluator
            try:
                (tt, wall, f), counts = run_counted(tag, solve, record)
            finally:
                contraction_mod.TorchBatchEvaluator = plain_evaluator
            return tt, wall, counts
        tt, cold, cold_counts = counted(True)
        walls, warm_counts = [], None
        for _ in range(10):
            tt, wall, warm_counts = counted(False)
            walls.append(wall)
        for name, c in (("cold", cold_counts), ("warm", warm_counts)):
            want = expect_launches(c)
            if (not c["launches"] or c["launches"] != want
                    or c["plain_cuda"] or (fetch_key and c["fetches"].get(
                        fetch_key) != 1)):
                fail(f"{tag} {name}: {c['launches']} launches for {want} "
                     f"splits, {c['plain_cuda']} plain calls on CUDA, "
                     f"fetches {c['fetches']}")
        if linkdims is not None and tt.linkdims() != linkdims:
            fail(f"{tag}: linkdims {tt.linkdims()}, recorded {linkdims}")
        err = check_values(tt)
        if tt[0].device.type != "cuda":
            fail(f"{tag}: the result left the card")
        res = {"cold_s": cold, "warm_median_s": med(walls),
               "warm_walls": walls, "launches": warm_counts["launches"],
               "nevals": warm_counts["nevals"],
               "launches_cold": cold_counts["launches"],
               "fetches": warm_counts["fetches"],
               "rrlu_raw": warm_counts["rrlu_raw"],
               "linkdims": tt.linkdims(), "max_rel_err": err}
        print(f"[contract] {tag}: cold {cold:.4f} s, warm {spread(walls)} "
              f"(median of 10); {res['launches']} rrLU launches "
              f"({res['rrlu_raw']} rrlu_raw), fetches {res['fetches']}, no "
              f"plain call; linkdims {tt.linkdims()}; max |tt - exact| "
              f"{err:.3e} of max |exact|", flush=True)
        contraction[tag] = res
        return res

    def product_check(a, b, tag, tol=1e-8, n=1000):
        idx = np.random.default_rng(11).integers(0, 4, (n, len(a)))
        want = exact_product(a, b, idx)

        def check(tt):
            got = values_at(tt, idx)
            err = float(np.abs(got - want).max() / np.abs(want).max())
            if not err <= tol:
                fail(f"{tag}: values at {n} fused indices {err:.3e} of "
                     f"max |exact| from the exact product (bound {tol})")
            return err
        return check

    def contract_solve(a, b, **kw):
        def solve():
            A = tci_tpu_torch.TensorTrain(a)
            B = tci_tpu_torch.TensorTrain(b)
            tt, wall = timed(lambda: tci_tpu_torch.contract(
                A, B, torch_native=True, **kw))
            return tt, wall, made[0] if made else None
        return solve

    a20, b20 = contract_operands(20, 16)
    for algorithm, splits in (("zipup", 19), ("naive", 38)):
        contraction_run(
            f"4i {algorithm}",
            contract_solve(a20, b20, algorithm=algorithm, method="LU",
                           tolerance=1e-10),
            lambda c, s=splits: s, "contract_" + algorithm,
            RECORDED_CONTRACT[algorithm],
            product_check(a20, b20, f"4i {algorithm}"))

    # (c) config 1's train (phase 4f's): the device compression beside the
    # host one, each 2 (L - 1) splits; values at 10^4 points within 1e-10
    # max|tt|
    def compress_solve(native):
        def solve():
            c = tt1.copy()
            _, wall = timed(lambda: c.compress("LU", tolerance=1e-12,
                                               torch_native=native))
            return c, wall, None
        return solve

    def compress_check(tt):
        err = float((tt.evaluate_batch(pts) - vals1).abs().max()) / scale1
        if not err <= 1e-10:
            fail(f"4i compress: max |diff| {err:.3e} of max|tt| at 10^4 "
                 f"points")
        return err

    ncomp = 2 * (len(tt1) - 1)
    contraction_run("4i compress device", compress_solve(True),
                    lambda c: ncomp, "compress", RECORDED_COMPRESS,
                    compress_check)
    contraction_run("4i compress host", compress_solve(False),
                    lambda c: ncomp, None, RECORDED_COMPRESS, compress_check)
    if contraction["4i compress host"]["rrlu_raw"] != ncomp:
        fail("4i compress host: not one rrlu_raw a split")

    # (d) TCI on the engine, the initial pivot search on the host timed
    # apart
    a8, b8 = contract_operands(20, 8)
    pivot_walls = []
    find_pivots = contraction_mod._findinitialpivots

    def timed_pivots(*args, **kwargs):
        out, wall = timed(lambda: find_pivots(*args, **kwargs))
        pivot_walls.append(wall)
        return out

    contraction_mod._findinitialpivots = timed_pivots
    try:
        res = contraction_run(
            "4i TCI",
            contract_solve(a8, b8, algorithm="TCI", tolerance=1e-10,
                           initialpivots=10, rng=np.random.default_rng(0)),
            lambda c: c["tier_calls"] + c["rrlu_raw"], None,
            RECORDED_CONTRACT["TCI"],
            product_check(a8, b8, "4i TCI"))
    finally:
        contraction_mod._findinitialpivots = find_pivots
    if res["fetches"].get("engine", 0) + res["fetches"].get(
            "engine_status", 0) == 0 or res["rrlu_raw"]:
        fail(f"4i TCI: did not run on the engine ({res})")
    res["initial_pivots_s"] = pivot_walls
    memory["after_tci_gib"] = memory_line()
    # the product function's device time a point, on a panel of the
    # engine's largest size (capacity 96: (96 x 5)^2 points), recorded in a
    # CUDA graph as the engine records it; times the samples of a run
    fprod, dims8, _, _ = contraction_mod.make_product_evaluator(
        tci_tpu_torch.TensorTrain(a8), tci_tpu_torch.TensorTrain(b8))
    npts = (96 * 5) ** 2
    idx = torch.as_tensor(np.random.default_rng(5).integers(
        0, 4, (npts, len(dims8))), device=dev)
    res["product_ms_per_point"] = graph_ms(lambda: fprod(idx), 3) / npts
    res["product_ms_per_run"] = res["product_ms_per_point"] * res["nevals"]
    print(f"[contract] 4i TCI: the product function on the card "
          f"{res['product_ms_per_point'] * 1e6:.3f} ns a point (a CUDA graph "
          f"of 3 calls on {npts} points, events), so "
          f"{res['product_ms_per_run']:.1f} ms for a run's {res['nevals']} "
          f"samples", flush=True)
    del fprod, idx
    print(f"[contract] 4i TCI: the initial pivot search (10 pivots, host, "
          f"one Contraction evaluation at a time) {med(pivot_walls[1:]):.4f} "
          f"s of each warm wall; device memory after the TCI runs allocated / "
          f"reserved / in private pools "
          f"{' / '.join(f'{x:.3f}' for x in memory['after_tci_gib'])} GiB",
          flush=True)

    # (e) complex128 at L = 12, chi = 8
    ac, bc = contract_operands(12, 8, complex_=True)
    for algorithm, splits in (("zipup", 11), ("naive", 22)):
        contraction_run(
            f"4i complex {algorithm}",
            contract_solve(ac, bc, algorithm=algorithm, method="LU",
                           tolerance=1e-10),
            lambda c, s=splits: s, "contract_" + algorithm,
            RECORDED_CONTRACT["complex_" + algorithm],
            product_check(ac, bc, f"4i complex {algorithm}"))

    # the kernel on each path's largest panels (one of each shape of the
    # largest size; naive's L->R and R->L passes give two), from the
    # recorded cold runs: device time a launch, plain version, bound
    largest = {}
    for tag, _, args, kw in launch_inputs:
        if tag in ("4i zipup", "4i naive", "4i compress device",
                   "4i complex zipup", "4i complex naive"):
            size = args[0].numel()
            if size > largest.get(tag, (0, {}))[0]:
                largest[tag] = (size, {})
            if size == largest[tag][0]:
                largest[tag][1].setdefault(tuple(args[0].shape), (args, kw))
    panel_times = {}

    def time_panel(tag, args, kw, into=panel_times, prefix="contract",
                   what="a largest panel"):
        P = args[0]
        k_panel = int(originals[1](*args, **kw)[3])

        def launches():
            for _ in range(10):
                originals[1](*args, **kw)
        durs = [dur for name, dur in traced_kernels(
            launches, [ProfilerActivity.CUDA]) if "rrlu" in name]
        ms_k = sum(durs) / 10 / 1e3 if durs else None
        ms_g = graph_ms(lambda: originals[1](*args, **kw), 10)
        ms_e = cuda_ms(lambda: originals[1](*args, **kw), 10)
        ms_p = cuda_ms(lambda: lu_kernel.rrlu_plain(*args, **kw), 2)
        bnd, by = bound_ms(*P.shape, int(args[1]), int(args[2]), k_panel,
                           P.element_size())
        mode = lu_cuda.PANEL_MODES[int(originals[1](
            *args, **kw, return_mode=True)[6])]
        shape = f"{P.shape[0]}x{P.shape[1]}"
        into[f"{tag} {shape}"] = {
            "panel": shape, "dtype": str(P.dtype)[6:], "k": k_panel,
            "mode": mode, "ms": ms_g, "profiler_ms": ms_k,
            "kernels_traced": len(durs), "wrapper_ms": ms_e,
            "plain_ms": ms_p, "bound_ms": bnd, "bound_by": by}
        print(f"[{prefix}] {tag}: {what}, {shape} "
              f"{str(P.dtype)[6:]} (k = {k_panel}, {mode}, true "
              f"{int(args[1])} x {int(args[2])}): kernel "
              f"{ms_g:.4f} ms a launch (events around a CUDA graph of 10 "
              f"launches), profiler "
              f"{'not measured' if ms_k is None else f'{ms_k:.4f} ms'} "
              f"({len(durs)} kernels traced in 10 calls), wrapper call "
              f"{ms_e:.4f} ms (events), plain {ms_p:.3f} ms, bound "
              f"{bnd:.6f} ms ({by})", flush=True)

    for tag, (_, shapes) in largest.items():
        for args, kw in shapes.values():
            time_panel(tag, args, kw)
    contraction["panels"] = panel_times
    contraction["memory"] = memory
    for tag in ("4i zipup 1024x256", "4i naive 1024x256",
                "4i naive 256x1024"):
        if panel_times.get(tag, {}).get("mode") != "cluster":
            fail(f"{tag}: not timed, or not in the cluster mode "
                 f"({panel_times.get(tag)})")

    # -- 4j. TCI1, matrix CI / ACA and the conversions ------------------------
    # (a) BASELINE config 1 by TCI1 (crossinterpolate1, tolerance 1e-8) with
    # a TorchBatchEvaluator and with the plain scalar f, each cold then
    # warm: tci_tpu's ranks and errors (RECORDED_TCI1), a pointwise error
    # below 1e-7. (b) The reference notebook's random f (L = 20, d = 2, the
    # 2^20-value table of default_rng(0) on the card, tolerance 1e-12,
    # maxiter = D) at D = 20 ... 1000, each once, smallest first: the walls
    # and the exponent of their power law in D; at D = 100 tci_tpu's pivot
    # lists, ranks and errors (RECORDED_RANDOM100); at D = 1000 the full
    # linkdims min(D, 2^(b+1), 2^(L-b-1)) and f at 1,000 seeded pivot
    # crosses I + J. (c) The conversions, cold (recorded for phase 5) then
    # warm, a kernel launch for each MatrixLUCI and no plain call: config
    # 1's TCI2 train (phase 4f's) through tci2_from_tensortrain ->
    # tci1_from_tci2 -> tci2_from_tci1; tci2_from_tensortrain of (b)'s D = 1000
    # train (1024 x 1000 and 2000 x 512 panels in the grid mode, 512 x 512
    # in the cluster mode); aca_from_rrlu of config 2's rrLU. (d)
    # matrix_crossinterpolate and a greedy MatrixACA on config 2's matrix,
    # each cold then warm, to rank 256. TCI1 itself runs no elimination: its
    # host reads are counted a bond-iteration (a bond whose ACA searched a
    # pivot) in FETCHES["tci1"].
    from tci_tpu_torch.models import conversion
    from tci_tpu_torch.ops import aca as aca_mod
    from tci_tpu_torch.ops.ci import argmax_colmajor

    tci1_entry = {}
    bond_iterations = [0]
    findnewpivot = aca_mod.MatrixACA.findnewpivot

    def counted_findnewpivot(self, *args, **kwargs):
        bond_iterations[0] += 1
        return findnewpivot(self, *args, **kwargs)

    def run_4j(tag, solve, record=False):
        """solve() once, with every count set to 0 just before it: (its
        result, the wall, the counts), the counts with the bond-iterations
        that searched a pivot (MatrixACA.findnewpivot calls)."""
        bond_iterations[0] = 0
        aca_mod.MatrixACA.findnewpivot = counted_findnewpivot
        try:
            (out, wall, _), counts = run_counted(
                tag, lambda: (*timed(solve), None), record)
        finally:
            aca_mod.MatrixACA.findnewpivot = findnewpivot
        counts["bond_iterations"] = bond_iterations[0]
        counts["fetches_tci1"] = counts["fetches"].get("tci1", 0)
        return out, wall, counts

    def per_bond_iteration(counts):
        n = counts["bond_iterations"]
        return counts["fetches_tci1"] / n if n else float("nan")

    def no_elimination(tag, counts):
        if counts["launches"] or counts["plain_cuda"]:
            fail(f"{tag}: TCI1 launched {counts['launches']} eliminations "
                 f"and {counts['plain_cuda']} plain calls")

    # (a)
    x1 = (1, 2, 3, 4, 5, 4, 3, 2)

    def tci1_config1(evaluator):
        f = (tci_tpu_torch.TorchBatchEvaluator(fdev, localdims)
             if evaluator == "torch" else fscalar)
        return tci_tpu_torch.crossinterpolate1(np.float64, f, localdims,
                                               tolerance=1e-8)

    config1_tci1 = {}
    for evaluator in ("torch", "scalar"):
        res = {}
        for run in ("cold", "warm"):
            tag = f"4j config1 {evaluator}"
            (t, ranks, errors), wall, counts = run_4j(
                tag, lambda: tci1_config1(evaluator))
            point = abs(t.evaluate(x1) - fscalar(x1))
            if (ranks != RECORDED_TCI1["ranks"] or not np.allclose(
                    errors, RECORDED_TCI1["errors"], rtol=0, atol=1e-15)
                    or t.linkdims() != RECORDED_TCI1["linkdims"]
                    or not point < 1e-7):
                fail(f"{tag} {run}: ranks {ranks}, errors {errors}, "
                     f"linkdims {t.linkdims()}, pointwise error {point}; "
                     f"recorded {RECORDED_TCI1}")
            if t.device.type != "cuda" or not all(
                    x.device.type == "cuda" for x in t.T + t.P + t.Pi):
                fail(f"{tag}: the state left the card")
            no_elimination(tag, counts)
            res[f"{run}_s"] = wall
            res[f"{run}_counts"] = counts
        res["pointwise_error"] = point
        res["max_error_diff"] = float(np.abs(
            np.asarray(errors) - RECORDED_TCI1["errors"]).max())
        config1_tci1[evaluator] = res
        c = res["warm_counts"]
        print(f"[tci1] 4j config1 by TCI1 ({evaluator} f): cold "
              f"{res['cold_s']:.4f} s, warm {res['warm_s']:.4f} s; ranks "
              f"{ranks[0]}..{ranks[-1]} as recorded, errors within "
              f"{res['max_error_diff']:.3e} of tci_tpu's (last "
              f"{errors[-1]:.6e}), linkdims {t.linkdims()}, pointwise error "
              f"{point:.3e}; {c['bond_iterations']} bond-iterations, "
              f"{c['fetches_tci1']} fetches "
              f"({per_bond_iteration(c):.3f} a bond-iteration), no rrLU "
              f"launch", flush=True)
    tci1_entry["config1"] = config1_tci1

    # (b)
    L20 = 20
    table20 = torch.as_tensor(
        np.random.default_rng(0).uniform(-1.0, 1.0, 2 ** L20), device=dev)
    w20 = torch.as_tensor(2 ** np.arange(L20), device=dev)

    def frandom(idx):
        # the key as a sum of products: CUDA has no int64 matmul
        return table20[(idx * w20).sum(1)]

    def pivot_digest(t):
        I = [[[int(v) for v in i] for i in s.fromint] for s in t.Iset]
        J = [[[int(v) for v in j] for j in s.fromint] for s in t.Jset]
        return hashlib.sha256(json.dumps([I, J]).encode()).hexdigest()

    def random_run(D):
        f = tci_tpu_torch.TorchBatchEvaluator(frandom, [2] * L20)
        return tci_tpu_torch.crossinterpolate1(
            np.float64, f, [2] * L20, tolerance=1e-12, maxiter=D), f

    sweep = {}
    for D in (20, 50, 100, 200, 500, 1000):
        tag = f"4j random D={D}"
        ((t, ranks, errors), f), wall, counts = run_4j(
            tag, lambda: random_run(D))
        want = [min(D, 2 ** (b + 1), 2 ** (L20 - b - 1))
                for b in range(L20 - 1)]
        if t.linkdims() != want:
            fail(f"{tag}: linkdims {t.linkdims()}, want {want}")
        no_elimination(tag, counts)
        entry = {"wall_s": wall, "iterations": len(ranks),
                 "bond_iterations": counts["bond_iterations"],
                 "fetches": counts["fetches_tci1"],
                 "fetches_per_bond_iteration": per_bond_iteration(counts),
                 "nevals": f.nevals}
        if D == 100:
            digest = pivot_digest(t)
            rel = float(np.max(np.abs(np.asarray(errors) - np.asarray(
                RECORDED_RANDOM100["errors"])) / np.abs(np.asarray(
                    RECORDED_RANDOM100["errors"]))))
            if (digest != RECORDED_RANDOM100["digest"]
                    or ranks != list(range(2, 101))
                    or t.linkdims() != RECORDED_RANDOM100["linkdims"]
                    or not rel <= 1e-12):
                fail(f"{tag}: pivot digest {digest}, ranks {ranks[:3]}..."
                     f"{ranks[-3:]}, errors {rel:.3e} relative from "
                     f"tci_tpu's; recorded {RECORDED_RANDOM100['digest']}")
            entry.update(pivot_digest=digest, max_error_rel_diff=rel)
            print(f"[tci1] {tag}: pivot lists tci_tpu's (sha256 "
                  f"{digest[:16]}...), ranks 2..100, errors within "
                  f"{rel:.3e} relative of tci_tpu's", flush=True)
        if D == 1000:
            t1000 = t
        sweep[D] = entry
        print(f"[tci1] {tag}: wall {wall:.4f} s, {len(ranks)} iterations, "
              f"linkdims max {max(t.linkdims())}, "
              f"{counts['bond_iterations']} bond-iterations, "
              f"{counts['fetches_tci1']} fetches "
              f"({per_bond_iteration(counts):.3f} a bond-iteration), "
              f"{f.nevals} samples, no rrLU launch", flush=True)
    Ds = np.asarray(sorted(sweep), dtype=float)
    walls_D = np.asarray([sweep[int(D)]["wall_s"] for D in Ds])
    fit_all = float(np.polyfit(np.log(Ds), np.log(walls_D), 1)[0])
    big = Ds >= 100
    fit_big = float(np.polyfit(np.log(Ds[big]), np.log(walls_D[big]), 1)[0])
    tci1_entry["random_f"] = {"L": L20, "by_D": sweep,
                              "exponent_all": fit_all,
                              "exponent_D_ge_100": fit_big}
    by_D = dict(zip(Ds.astype(int).tolist(), walls_D.tolist()))
    print(f"[tci1] 4j random f walls by D {by_D}: "
          f"wall ~ D^{fit_all:.3f} (least squares in log-log over all D), "
          f"D^{fit_big:.3f} over D >= 100; the reference notebook draws D^2 "
          f"and D^3 beside its sweep cost", flush=True)

    # f at 1,000 seeded pivot crosses of the D = 1000 train
    tt1000, wall_st = timed(lambda: tci_tpu_torch.tensortrain(t1000))
    rng = np.random.default_rng(1000)
    crosses = []
    for _ in range(1000):
        b = int(rng.integers(0, L20 - 1))
        I, J = t1000.Iset[b + 1].fromint, t1000.Jset[b].fromint
        crosses.append(I[int(rng.integers(len(I)))]
                       + J[int(rng.integers(len(J)))])
    cross_idx = torch.as_tensor(np.asarray(crosses), device=dev)
    cross_vals = frandom(cross_idx)
    cross_err = float((tt1000.evaluate_batch(cross_idx)
                       - cross_vals).abs().max())
    # max|f| = 1; at D = 200 on a CPU the error there is 3e-14
    if not cross_err <= 1e-10:
        fail(f"4j random D=1000: |tt - f| = {cross_err:.3e} at a pivot "
             f"cross (bound 1e-10)")
    sweep[1000].update(pivot_cross_max_err=cross_err,
                       sitetensors_s=wall_st)
    print(f"[tci1] 4j random D=1000: site tensors (T P^-1 by stacked QR on "
          f"the card) {wall_st:.4f} s; max |tt - f| at 1,000 pivot crosses "
          f"{cross_err:.3e} (bound 1e-10)", flush=True)

    # (c)
    luci_made = [0]
    luci_cls = conversion.MatrixLUCI

    class CountedLUCI(luci_cls):
        def __init__(self, *args, **kwargs):
            luci_made[0] += 1
            super().__init__(*args, **kwargs)

    conversions = {}

    def conversion_run(tag, solve, check, extra_launches=0):
        """Cold (recorded for phase 5) and warm runs of solve(): a kernel
        launch for each MatrixLUCI (and `extra_launches` rrlu calls), no
        plain call; check(result) returns the values' error."""
        res = {}
        conversion.MatrixLUCI = CountedLUCI
        try:
            for run in ("cold", "warm"):
                luci_made[0] = 0
                out, wall, counts = run_4j(tag, solve, record=run == "cold")
                want = luci_made[0] + extra_launches
                if (not counts["launches"] or counts["launches"] != want
                        or counts["plain_cuda"]):
                    fail(f"{tag} {run}: {counts['launches']} launches for "
                         f"{luci_made[0]} MatrixLUCI, {counts['plain_cuda']} "
                         f"plain calls on CUDA")
                res[f"{run}_s"] = wall
                res[f"{run}_counts"] = counts
        finally:
            conversion.MatrixLUCI = luci_cls
        res["luci"] = luci_made[0]
        res["launches"] = res["warm_counts"]["launches"]
        res["max_rel_err"] = check(out)
        conversions[tag] = res
        print(f"[tci1] {tag}: cold {res['cold_s']:.4f} s, warm "
              f"{res['warm_s']:.4f} s; {res['launches']} rrLU launches for "
              f"{res['luci']} MatrixLUCI, no plain call; values within "
              f"{res['max_rel_err']:.3e} (relative)", flush=True)
        return out

    fconv = tci_tpu_torch.TorchBatchEvaluator(fdev, localdims)

    def check_config1_conversion(out):
        t1, back, fromtt = out
        if not (t1.linkdims() == back.linkdims() == fromtt.linkdims()
                == tci1.linkdims()):
            fail(f"4j config1 conversions: linkdims {t1.linkdims()}, "
                 f"{back.linkdims()}, {fromtt.linkdims()}; the TCI2's "
                 f"{tci1.linkdims()}")
        err = 0.0
        for res in (back, fromtt):
            got = tci_tpu_torch.tensortrain(res).evaluate_batch(pts)
            err = max(err, float((got - vals1).abs().max()) / scale1)
            if res.sitetensors()[0].device.type != "cuda":
                fail("4j config1 conversions: the result left the card")
        if not err <= 1e-8:
            fail(f"4j config1 conversions: {err:.3e} of max|f| from the "
                 f"TCI2 at 10^4 points (bound 1e-8)")
        return err

    def convert_config1():
        # tci1_from_tci2 needs nested index sets (as in tci_tpu); the
        # TCI2's own need not be (non-strict nesting), so the TCI1 is built
        # from the nested sets of tci2_from_tensortrain
        fromtt = conversion.tci2_from_tensortrain(tt1)
        t1 = conversion.tci1_from_tci2(fromtt, fconv)
        return t1, conversion.tci2_from_tci1(t1), fromtt

    conversion_run("4j conversion config1", convert_config1,
                   check_config1_conversion)

    def check_d1000_conversion(tb):
        if tb.linkdims() != tt1000.linkdims():
            fail(f"4j conversion D=1000: linkdims {tb.linkdims()}, the "
                 f"train's {tt1000.linkdims()}")
        got = tci_tpu_torch.tensortrain(tb).evaluate_batch(cross_idx)
        err = float((got - cross_vals).abs().max())
        if not err <= 1e-8:
            fail(f"4j conversion D=1000: |f| differs by {err:.3e} at the "
                 f"pivot crosses (bound 1e-8)")
        return err

    conversion_run("4j conversion D=1000",
                   lambda: conversion.tci2_from_tensortrain(tt1000),
                   check_d1000_conversion)

    A2 = config2_A
    scale2 = float(A2.abs().max())

    def check_aca(aca):
        err = float((aca.matrix() - A2).abs().max()) / scale2
        if aca.rank() != config2_k or not err <= 1e-8:
            fail(f"4j aca_from_rrlu: rank {aca.rank()}, max|ACA - A| "
                 f"{err:.3e} of max|A| (bound 1e-8)")
        return err

    conversion_run(
        "4j aca_from_rrlu config2",
        lambda: conversion.aca_from_rrlu(tci_tpu_torch.rrlu(
            A2, maxrank=256, reltol=1e-10)),
        check_aca, extra_launches=1)

    # the kernel on the D = 1000 conversion's panels (the first of each
    # shape in the cold run, by true extents) and on config 1's largest
    conversion_panels = {}
    wanted = {(1024, 1000), (2000, 512), (512, 512)}
    timed_shapes = set()
    largest1 = None
    for tag, _, args, kw in launch_inputs:
        if tag == "4j conversion D=1000":
            ext = (int(args[1]), int(args[2]))
            if ext in wanted and ext not in timed_shapes:
                timed_shapes.add(ext)
                time_panel(tag, args, kw, into=conversion_panels,
                           prefix="tci1", what="a conversion panel")
        elif tag == "4j conversion config1":
            if largest1 is None or args[0].numel() > largest1[0][0].numel():
                largest1 = (args, kw)
    if timed_shapes != wanted:
        fail(f"4j conversion D=1000: panels {sorted(timed_shapes)}, want "
             f"{sorted(wanted)}")
    time_panel("4j conversion config1", *largest1, into=conversion_panels,
               prefix="tci1", what="its largest panel")
    tci1_entry["conversions"] = conversions
    tci1_entry["conversion_panels"] = conversion_panels

    # (d)
    def matrix_ci():
        return tci_tpu_torch.matrix_crossinterpolate(
            A2, tolerance=1e-10 * scale2, maxiter=300)

    def greedy_aca():
        r, c, _ = argmax_colmajor(A2.abs())
        aca = tci_tpu_torch.MatrixACA(A=A2, firstpivot=(r, c))
        while aca.rank() < 256:
            aca.addpivot(A2)
        return aca

    matrix_engines = {}
    for name, solve in (("matrix_crossinterpolate", matrix_ci),
                        ("MatrixACA", greedy_aca)):
        res = {}
        for run in ("cold", "warm"):
            out, wall, counts = run_4j(f"4j {name}", solve)
            err = float((out.matrix() - A2).abs().max()) / scale2
            if out.rank() != 256 or not err <= 1e-10:
                fail(f"4j {name} on config 2: rank {out.rank()}, max|M - A| "
                     f"{err:.3e} of max|A| (bound 1e-10)")
            no_elimination(f"4j {name}", counts)
            res[f"{run}_s"] = wall
            res["fetches"] = counts["fetches_tci1"]
        res["max_rel_err"] = err
        matrix_engines[name] = res
        print(f"[tci1] 4j {name} on config 2 (4096^2, rank 256): cold "
              f"{res['cold_s']:.4f} s, warm {res['warm_s']:.4f} s; rank 256, "
              f"max|M - A| {err:.3e} of max|A|; {res['fetches']} fetches",
              flush=True)
    tci1_entry["matrix_engines"] = matrix_engines

    def profile_random_f(D):
        """(b) once more at D under torch.profiler (device activity only):
        the device's busy time and idle share over the run's wall, kernel
        launches and fetches a bond-iteration, the largest device items."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        FETCHES.clear()
        bond_iterations[0] = 0
        aca_mod.MatrixACA.findnewpivot = counted_findnewpivot
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, wall = timed(lambda: random_run(D))
        finally:
            aca_mod.MatrixACA.findnewpivot = findnewpivot
        n_iter, fetches = bond_iterations[0], FETCHES["tci1"]
        spans, by_name = [], {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + (b - a) / 1e3)
        busy, end = 0.0, None
        for a, b in sorted(spans):
            if end is None or b > end:
                busy += b - (a if end is None else max(a, end))
                end = b
        busy /= 1e3
        kernels = sum(n for name, (n, _) in by_name.items()
                      if not name.startswith(("Memcpy", "Memset")))
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        prof_entry = {
            "wall_s": wall, "device_busy_ms": busy if spans else None,
            "idle_share": 1 - busy / (wall * 1e3) if spans else None,
            "bond_iterations": n_iter, "fetches": fetches,
            "kernels": kernels, "device_items": len(spans),
            "kernels_per_bond_iteration": kernels / n_iter,
            "fetches_per_bond_iteration": fetches / n_iter,
            "top": [(name, n, ms) for name, (n, ms) in top]}
        tci1_entry["random_f"][f"profile_D{D}"] = prof_entry
        if not spans:
            print(f"[profile] 4j random D={D}: the trace holds no device "
                  f"item: device time not measured", flush=True)
            return
        print(f"[profile] 4j random D={D}: profiled wall {wall:.4f} s; "
              f"device busy {busy:.3f} ms (kernels, copies, memsets), idle "
              f"share {prof_entry['idle_share']:.4f}; {n_iter} "
              f"bond-iterations, {kernels} kernels "
              f"({prof_entry['kernels_per_bond_iteration']:.2f} a "
              f"bond-iteration), {fetches} fetches "
              f"({prof_entry['fetches_per_bond_iteration']:.3f} a "
              f"bond-iteration)", flush=True)
        for name, n, ms in prof_entry["top"]:
            print(f"[profile] 4j random D={D}: device: {name[:70]}: "
                  f"{ms:.3f} ms in {n}", flush=True)

    # -- 4k. the auxiliaries: checkpoint, scalar f, interop, fuzz, examples ---
    # (a) config 1 on the engine under the default protocol to 1e-4, saved,
    # loaded on the card into a new object and resumed to 1e-8 on the same
    # evaluator (rng default_rng(0) both times): tci_tpu's resumed series
    # (RECORDED_RESUME), f at 1,000 seeded points within 1e-7, save -> load
    # -> save bitwise; config 5 in complex128 likewise (1e-4, then 1e-7):
    # the resumed integral within 1e-9 of the same coarse run continued
    # without the checkpoint. A cold run of each on a new evaluator queues
    # eagerly and is recorded for phase 5; the resume walls are the median
    # of 10 on a kept evaluator. (b) config 1 and config 5 through
    # TorchBatchEvaluator.from_scalar (a vmapped scalar f) on the engine:
    # the batched f's ranks, errors, samples and site tensors, no key
    # declined; the warm medians of 10 on kept evaluators side by side.
    # (c) config 1's and config 5's trains through MPS tensors and the
    # quimb layout and back, phase 4i's MPO operand through MPO tensors and
    # back: every core bitwise; evaluate_mps against the train at 1,000
    # seeded points within 1e-12 relative. (d) a seeded sweep of random
    # panels through the rrLU kernel against its plain version, bit for bit.
    # (e) each example of tci_tpu_torch/examples as a process of its own.
    def run_aux():
        """Phase 4k in a scope of its own (its names stay out of
        main's); returns its entry of the JSON line."""
        from tci_tpu_torch.interop import mps as mps_mod
        from tci_tpu_torch.utils import checkpoint as ckpt_mod

        t_aux = time.perf_counter()
        aux_entry = {}
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")

        def npz_bytes(path):
            with np.load(path, allow_pickle=False) as data:
                return {k: (data[k].dtype.str, data[k].shape,
                            data[k].tobytes()) for k in data.files}

        def save_load_save(tag, tci):
            """save -> load on the card -> save: the two files' arrays bitwise
            equal; (the loaded TCI, save wall, load wall, file bytes)."""
            a = os.path.join(ckpt_dir, f"{tag}_a.npz")
            b = os.path.join(ckpt_dir, f"{tag}_b.npz")
            before = FETCHES["checkpoint"]
            _, t_save = timed(lambda: ckpt_mod.save_tci2(a, tci))
            fetches = FETCHES["checkpoint"] - before
            loaded, t_load = timed(lambda: ckpt_mod.load_tci2(a))
            ckpt_mod.save_tci2(b, loaded)
            if npz_bytes(a) != npz_bytes(b):
                fail(f"4k {tag}: save -> load -> save changed the file's "
                     f"arrays")
            if (loaded.device.type != "cuda"
                    or loaded._maxsample_dev is not None
                    or not all(x.device.type == "cuda"
                               for x in loaded.sitetensors())):
                fail(f"4k {tag}: the loaded TCI is not on the card")
            if fetches != 1:
                fail(f"4k {tag}: the save made {fetches} fetches, want one of "
                     f"all the site tensors")
            return loaded, t_save, t_load, os.path.getsize(a)

        def resume_run(tag, ev, dims, valuetype, coarse_tol, fine_tol, **kw):
            """The coarse run on evaluator ev, save, load on the card, resume:
            (coarse TCI, resumed TCI, ranks, errors, file info, resume wall,
            ev)."""
            coarse, _, _ = tci_tpu_torch.crossinterpolate2(
                valuetype, ev, dims, tolerance=coarse_tol,
                rng=np.random.default_rng(0), **kw)
            loaded, t_save, t_load, nbytes = save_load_save(tag, coarse)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ranks, errors = loaded.optimize(ev, tolerance=fine_tol,
                                            rng=np.random.default_rng(0), **kw)
            torch.cuda.synchronize()
            return (coarse, loaded, ranks, errors,
                    {"save_s": t_save, "load_s": t_load, "file_bytes": nbytes},
                    time.perf_counter() - t0, ev)

        def new_evaluator(f, dims, dtype=torch.float64, graphs=True,
                          scalar=False):
            make = (tci_tpu_torch.TorchBatchEvaluator.from_scalar if scalar
                    else tci_tpu_torch.TorchBatchEvaluator)
            ev = make(f, dims, dtype=dtype, cuda_graphs=graphs)
            set_protocol(ev, True)
            return ev

        def check_engine_counts(tag, counts):
            if (counts["launches"] == 0 or counts["rrlu_raw"]
                    or counts["launches"] != counts["tier_calls"]
                    or counts["plain_cuda"]):
                fail(f"4k {tag}: {counts}; every elimination should launch "
                     f"the kernel on the engine and none take the plain "
                     f"version")

        # (a) config 1
        pts1 = np.random.default_rng(11).integers(0, 10, (1000, 8))
        f_pts1 = fdev(torch.as_tensor(pts1, device=dev))
        resume_entry = {}
        res, counts = run_counted("4k resume config1", lambda: resume_run(
            "config1", new_evaluator(fdev, localdims, graphs=False), localdims,
            np.float64, 1e-4, 1e-8), record=True)
        check_engine_counts("resume config 1 cold", counts)
        resume_entry["config1"] = {"launches_cold": counts["launches"]}
        kept1 = new_evaluator(fdev, localdims)
        res, counts = run_counted("4k resume config1", lambda: resume_run(
            "config1", kept1, localdims, np.float64, 1e-4, 1e-8))
        first_resume = res[5]
        walls = []
        for _ in range(10):
            res, counts = run_counted("4k resume config1", lambda: resume_run(
                "config1", kept1, localdims, np.float64, 1e-4, 1e-8), f=kept1)
            walls.append(res[5])
        check_engine_counts("resume config 1 kept", counts)
        coarse1, resumed1, ranks_r, errors_r, file1 = res[:5]
        point_err = float((resumed1.evaluate_batch(pts1) - f_pts1).abs().max())
        err_diff = max(abs(a - b) for a, b in zip(errors_r,
                                                  RECORDED_RESUME["errors"]))
        if (ranks_r != RECORDED_RESUME["ranks"] or not err_diff <= 1e-15
                or not point_err < 1e-7):
            fail(f"4k resume config 1: ranks {ranks_r}, errors {errors_r} "
                 f"(recorded {RECORDED_RESUME}), max |f - tt| at 1,000 points "
                 f"{point_err:.3e}")
        if kept1.device_sweep_engine.declined:
            fail(f"4k resume config 1: declined "
                 f"{kept1.device_sweep_engine.declined}")
        walls.sort()
        resume_entry["config1"].update({
            "coarse_linkdims": coarse1.linkdims(), "ranks": ranks_r,
            "errors": errors_r, "max_err_diff_tci_tpu": err_diff,
            "max_point_err": point_err, **file1,
            "resume_first_s": first_resume,
            "resume_kept_median_s": (walls[4] + walls[5]) / 2,
            "resume_kept_range_s": [walls[0], walls[-1]],
            "launches": counts["launches"],
            "replays": kept1.device_sweep_engine.replays})
        e1 = resume_entry["config1"]
        print(f"[aux] 4k resume config 1: coarse (1e-4) linkdims "
              f"{e1['coarse_linkdims']}, file {e1['file_bytes']} bytes (save "
              f"{e1['save_s']:.4f} s, load {e1['load_s']:.4f} s); resumed to "
              f"1e-8: ranks {ranks_r}, errors {errors_r} (tci_tpu's within "
              f"{err_diff:.3e}), max |f - tt| {point_err:.3e} at 1,000 "
              f"points; "
              f"resume wall first {first_resume:.4f} s, kept median of 10 "
              f"{e1['resume_kept_median_s']:.4f} s (range "
              f"{walls[0]:.4f}-{walls[-1]:.4f}); {counts['launches']} "
              f"launches "
              f"a coarse + resumed run ({e1['launches_cold']} cold); save -> "
              f"load -> save bitwise", flush=True)

        # (a) config 5, complex128
        kw5 = {"nsearchglobalpivot": 10}
        res, counts = run_counted("4k resume config5", lambda: resume_run(
            "config5", new_evaluator(f5torch, dims5, torch.complex128,
                                     graphs=False), dims5, np.complex128, 1e-4,
            1e-7, **kw5), record=True)
        check_engine_counts("resume config 5 cold", counts)
        kept5r = new_evaluator(f5torch, dims5, torch.complex128)
        res, counts = run_counted("4k resume config5", lambda: resume_run(
            "config5", kept5r, dims5, np.complex128, 1e-4, 1e-7, **kw5))
        coarse5, resumed5, ranks5r, errors5r, file5, wall5r = res[:6]
        # the same coarse run, continued without the checkpoint
        cont_ranks, _ = coarse5.optimize(kept5r, tolerance=1e-7,
                                         rng=np.random.default_rng(0), **kw5)
        int_resumed = resumed5.sum() / norm5
        int_cont = coarse5.sum() / norm5
        d_cont = abs(int_resumed - int_cont)
        if not d_cont <= 1e-9 or not errors5r[-1] < 1e-7:
            fail(f"4k resume config 5: integral {int_resumed!r} against "
                 f"{int_cont!r} continued without the checkpoint (|diff| "
                 f"{d_cont:.3e}, bound 1e-9), errors {errors5r}")
        if resumed5.dtype != torch.complex128:
            fail(f"4k resume config 5: resumed in {resumed5.dtype}")
        resume_entry["config5"] = {
            "ranks": ranks5r, "continued_ranks": cont_ranks,
            "errors": errors5r,
            "integral": [int_resumed.real, int_resumed.imag],
            "diff_continued": d_cont,
            "diff_uninterrupted_1e7_run": abs(int_resumed - CONFIG5_INTEGRAL),
            **file5, "resume_s": wall5r, "launches": counts["launches"]}
        print(f"[aux] 4k resume config 5 (complex128): ranks {ranks5r} "
              f"(continued without the checkpoint {cont_ranks}), final error "
              f"{errors5r[-1]:.3e}, integral {int_resumed!r}, |diff| to the "
              f"continued run {d_cont:.3e} (bound 1e-9), to tci_tpu's 1e-7 "
              f"run "
              f"{resume_entry['config5']['diff_uninterrupted_1e7_run']:.3e}; "
              f"file {file5['file_bytes']} bytes; resume wall {wall5r:.4f} s",
              flush=True)
        aux_entry["checkpoint"] = resume_entry

        # (b) the scalar f
        def fscalar_dev(v):
            v = v.to(torch.float64) + 1.0
            return 1.0 / (1.0 + (v * v).sum())

        def f5scalar(idx):
            t = nodes5_d[idx]
            damp = torch.exp(-((t[:, None] - t[None, :]) ** 2).sum())
            return torch.polar(weights5_d[idx].prod() * damp * norm5,
                               10.0 * t.sum())

        def scalar_run(ev, dims, valuetype, tol, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tci, ranks, errors = tci_tpu_torch.crossinterpolate2(
                valuetype, ev, dims, tolerance=tol,
                rng=np.random.default_rng(0), **kw)
            torch.cuda.synchronize()
            return tci, ranks, errors, time.perf_counter() - t0, ev

        scalar_entry, out_trains = {}, {}
        for cfg, fb, fs, dims, dt, vt, tol, kw in (
                ("config1", fdev, fscalar_dev, localdims, torch.float64,
                 np.float64, 1e-8, {}),
                ("config5", f5torch, f5scalar, dims5, torch.complex128,
                 np.complex128, 1e-7, kw5)):
            run_counted(f"4k scalar {cfg}", lambda: scalar_run(
                new_evaluator(fs, dims, dt, graphs=False, scalar=True), dims,
                vt, tol, **kw), record=True)
            out = {}
            for kind, f_, scalar in (("scalar", fs, True),
                                     ("batched", fb, False)):
                ev = new_evaluator(f_, dims, dt, scalar=scalar)
                res, counts = run_counted(
                    f"4k scalar {cfg}",
                    lambda: scalar_run(ev, dims, vt, tol, **kw))
                check_engine_counts(f"scalar f {cfg} {kind}", counts)
                walls = sorted(run_counted(
                    f"4k scalar {cfg}",
                    lambda: scalar_run(ev, dims, vt, tol, **kw),
                    f=ev)[0][3] for _ in range(10))
                out[kind] = (res, counts, (walls[4] + walls[5]) / 2,
                             ev.device_sweep_engine)
            (rs, cs, ms, es), (rb, cb, mb, eb) = out["scalar"], out["batched"]
            bitwise = (rs[1] == rb[1] and rs[2] == rb[2]
                       and rs[0].Iset == rb[0].Iset and all(
                           torch.equal(a, b) for a, b in zip(
                               rs[0].sitetensors(), rb[0].sitetensors())))
            if (rs[1] != rb[1] or cs["nevals"] != cb["nevals"] or es.declined
                    or not np.allclose(rs[2], rb[2], rtol=0, atol=1e-15)):
                fail(f"4k scalar f {cfg}: ranks {rs[1]} / {rb[1]}, errors "
                     f"{rs[2]} / {rb[2]}, nevals {cs['nevals']} / "
                     f"{cb['nevals']}, declined {es.declined}")
            out_trains[cfg] = rs[0]
            if cfg == "config1":
                check_config1("4k scalar f", rs[0], rs[1], rs[2], cs)
            else:
                check_config5("4k scalar f", rs[0], rs[1], rs[2], cs, rs[4],
                              "engine")
            scalar_entry[cfg] = {
                "ranks": rs[1], "errors": rs[2], "bitwise_batched": bitwise,
                "nevals": cs["nevals"], "declined": dict(es.declined),
                "captures": es.captures, "replays": es.replays,
                "kept_median_s": ms, "batched_kept_median_s": mb,
                "launches": cs["launches"]}
            print(f"[aux] 4k scalar f {cfg} (from_scalar, engine, default "
                  f"protocol): ranks {rs[1]}, final error {rs[2][-1]:.3e}, "
                  f"nevals {cs['nevals']} (batched {cb['nevals']}); bit for "
                  f"bit "
                  f"the batched f's (series, index sets, site tensors): "
                  f"{bitwise}; declined {dict(es.declined)}, {es.captures} "
                  f"captures, {es.replays} replays; warm median of 10 "
                  f"{ms:.4f} s, batched f {mb:.4f} s; {cs['launches']} "
                  f"launches "
                  f"a run", flush=True)
        aux_entry["scalar_f"] = scalar_entry

        # (c) interop
        class QuimbArrays:
            """quimb's MatrixProductState layout, (l, r, p) arrays."""

            def __init__(self, arrays):
                self.arrays = arrays

        interop_entry = {}
        op4i = tci_tpu_torch.TensorTrain(contract_operands(20, 16)[0])
        for name, tt, legs in (
                ("config1", tci_tpu_torch.tensortrain(out_trains["config1"]),
                 3),
                ("config5", tci_tpu_torch.tensortrain(out_trains["config5"]),
                 3),
                ("mpo_4i", op4i, 4)):
            cores = tt.sitetensors()
            t0 = time.perf_counter()
            if legs == 4:
                back = {"mpo": mps_mod.from_mpo_tensors(
                    mps_mod.to_mpo_tensors(tt))}
            else:
                raw = mps_mod.to_mps_tensors(tt)
                back = {"mps": mps_mod.from_mps_tensors(raw),
                        "quimb": mps_mod.from_quimb_mps(QuimbArrays(
                            mps_mod.to_quimb_arrays(tt)))}
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for kind, res in back.items():
                if not all(x.device.type == "cuda" and x.shape == y.shape
                           and torch.equal(x, y)
                           for x, y in zip(res.sitetensors(), cores)):
                    fail(f"4k interop {name} {kind}: the round trip changed a "
                         f"core")
            entry = {"round_trip_s": wall, "kinds": sorted(back)}
            if legs == 3:
                pts = np.random.default_rng(13).integers(
                    0, tt.sitedims()[0][0], (1000, len(tt)))
                want = tt.evaluate_batch(pts).cpu().numpy()
                t0 = time.perf_counter()
                got = np.array([mps_mod.evaluate_mps(raw, p) for p in pts])
                entry["evaluate_mps_s"] = time.perf_counter() - t0
                rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
                if not rel <= 1e-12:
                    fail(f"4k interop {name}: evaluate_mps differs from the "
                         f"train by {rel:.3e} of max|tt| (bound 1e-12)")
                entry["evaluate_mps_rel_err"] = rel
            interop_entry[name] = entry
            print(f"[aux] 4k interop {name}: "
                  f"{' and '.join(sorted(back))} round "
                  f"trip bitwise in {wall:.4f} s"
                  + (f"; evaluate_mps at 1,000 points within "
                     f"{entry['evaluate_mps_rel_err']:.3e} of max|tt| "
                     f"({entry['evaluate_mps_s']:.3f} s)"
                     if legs == 3 else ""),
                  flush=True)
        aux_entry["interop"] = interop_entry

        # (d) the kernel fuzz: random panels of each type through each mode
        fuzz_rng = np.random.default_rng(2024)
        fuzz_counts, fuzz_stops = {}, {}
        fuzz_launches = lu_cuda.LAUNCHES["rrlu"]
        # (m, n) ranges for each mode aimed at: resident panels of up to 128
        # (80 complex), cluster panels above them, and panels past a cluster's
        # shared memory (grid); the mode each launch took is read back
        aims = {"resident": ((1, 128), (1, 80)), "cluster": ((130, 420),
                                                            (100, 300)),
                "grid": ((1000, 1500), (1000, 1300))}
        fuzz_types = (torch.float32, torch.float64, torch.complex128)

        def fuzz_panel(m, n, r, dtype, decay):
            cplx = dtype.is_complex
            U = fuzz_rng.standard_normal((m, r))
            V = fuzz_rng.standard_normal((r, n))
            if cplx:
                U = U + 1j * fuzz_rng.standard_normal((m, r))
                V = V + 1j * fuzz_rng.standard_normal((r, n))
            if decay and r:
                U = U * 10.0 ** (-np.arange(r) / 2.0)
            return U @ V

        def fuzz_one(aim, dtype, first):
            real = dtype if not dtype.is_complex else torch.float64
            lo, hi = aims[aim][1 if dtype.is_complex else 0]
            B = int(fuzz_rng.integers(1, 9)) if fuzz_rng.random() < 0.4 else 0
            m = 1 if first else int(fuzz_rng.integers(lo, hi + 1))
            n = 1 if first else int(fuzz_rng.integers(lo, hi + 1))
            pad = str(fuzz_rng.choice(["bucket", "bucket+", "exact"],
                                      p=[0.55, 0.25, 0.2]))
            mp, npd = lu_kernel.bucket(m), lu_kernel.bucket(n)
            if pad == "bucket+":
                mp, npd = lu_kernel.bucket(mp + 1), lu_kernel.bucket(npd + 1)
            elif pad == "exact":
                # the true extents, widened by zero columns where the panel
                # would miss the 16-byte rule (as contraction_device._lu_split)
                es = torch.empty((), dtype=dtype).element_size()
                mp, npd = m, n
                while (mp * npd * es) % 16:
                    npd += 1
            panels, ms, ns, caps, rts, ats, kinds = [], [], [], [], [], [], []
            for _ in range(max(B, 1)):
                mb = m if not B else int(
                    fuzz_rng.integers(max(1, m // 2), m + 1))
                nb = n if not B else int(
                    fuzz_rng.integers(max(1, n // 2), n + 1))
                rmax = min(mb, nb, 48 if aim == "grid" else 128)
                r = int(fuzz_rng.integers(0, rmax + 1))
                stop = str(fuzz_rng.choice(["deficient", "maxrank", "reltol",
                                            "abstol"]))
                A = fuzz_panel(mb, nb, r, dtype, stop in ("reltol", "abstol"))
                P = np.zeros((mp, npd), dtype=A.dtype)
                P[:mb, :nb] = A
                panels.append(P)
                cap = min(mb, nb)
                rt = at = 0.0
                if stop == "maxrank":
                    cap = int(fuzz_rng.integers(0, max(r, 1) + 1))
                elif stop == "reltol":
                    rt = 1e-6
                elif stop == "abstol":
                    at = 1e-4 * float(np.abs(A).max()) if A.size else 0.0
                ms.append(mb), ns.append(nb), caps.append(cap)
                rts.append(rt), ats.append(at), kinds.append(stop)
            lo_ = bool(fuzz_rng.integers(0, 2))
            A_d = torch.as_tensor(np.stack(panels) if B else panels[0],
                                  device=dev).to(dtype)
            if B:
                args = (A_d, torch.tensor(ms), torch.tensor(ns),
                        torch.tensor(caps), torch.tensor(rts, dtype=real),
                        torch.tensor(ats, dtype=real))
                out = lu_cuda.rrlu_batched(*args, leftorthogonal=lo_,
                                           return_mode=True)
                ref = lu_kernel.rrlu_plain_batched(*args, leftorthogonal=lo_)
            else:
                args = (A_d, ms[0], ns[0], caps[0], rts[0], ats[0])
                out = lu_cuda.rrlu_call(*args, leftorthogonal=lo_,
                                        return_mode=True)
                ref = lu_kernel.rrlu_plain(*args, leftorthogonal=lo_)
            tag = (f"4k fuzz {str(dtype)[6:]} aim {aim} B={B} {m}x{n} in "
                   f"{mp}x{npd} ({pad}) stops {kinds}")
            compare(tag, out[:6], ref, 1.0)
            key = str(dtype)[6:]
            for v in out[6].reshape(-1).tolist():
                mode = lu_cuda.PANEL_MODES[v]
                fuzz_counts.setdefault(key, {}).setdefault(mode, 0)
                fuzz_counts[key][mode] += 1
            for s in kinds:
                fuzz_stops[s] = fuzz_stops.get(s, 0) + 1
            fuzz_stops["batched" if B else "single"] = fuzz_stops.get(
                "batched" if B else "single", 0) + 1

        t0 = time.perf_counter()
        rounds = 0
        while rounds < 40 and (rounds < 3 or time.perf_counter() - t0 < 30.0):
            for aim in aims:
                for dtype in fuzz_types:
                    fuzz_one(aim, dtype, rounds == 0 and aim == "resident")
            rounds += 1
        torch.cuda.synchronize()
        fuzz_wall = time.perf_counter() - t0
        fuzz_launches = lu_cuda.LAUNCHES["rrlu"] - fuzz_launches
        missing = [(t, mo) for t in fuzz_counts for mo in lu_cuda.PANEL_MODES
                   if not fuzz_counts[t].get(mo)]
        if missing or len(fuzz_counts) != 3:
            fail(f"4k fuzz: no panel of {missing} ({fuzz_counts})")
        aux_entry["kernel_fuzz"] = {"rounds": rounds, "wall_s": fuzz_wall,
                                    "launches": fuzz_launches,
                                    "panels_by_type_and_mode": fuzz_counts,
                                    "stops": fuzz_stops}
        print(f"[aux] 4k kernel fuzz: {rounds} rounds, {fuzz_launches} launches "
              f"in {fuzz_wall:.3f} s, every one bit for bit its plain version; "
              f"panels by type and mode {json.dumps(fuzz_counts)}; stops and "
              f"calls {json.dumps(fuzz_stops)}", flush=True)

        # (e) the examples, each a process of its own on the card
        examples_entry = {}
        for name in ("ex01_quickstart_lorentzian", "ex02_quantics_oscillatory",
                     "ex03_integration_10d", "ex04_contraction_mpo",
                     "ex05_complex_feynman", "ex07_checkpoint_resume"):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", f"tci_tpu_torch.examples.{name}"],
                cwd=here, capture_output=True, text=True, timeout=300)
            wall = time.perf_counter() - t0
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines or lines[-1] != "ok":
                fail(f"4k example {name}: exit {proc.returncode}, stdout "
                     f"{proc.stdout[-2000:]!r}, stderr {proc.stderr[-2000:]!r}")
            examples_entry[name] = wall
            print(f"[aux] 4k example {name}: ok in {wall:.3f} s (process "
                  f"included); " + " | ".join(lines[:-1])[:400], flush=True)
        aux_entry["examples_s"] = examples_entry
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        aux_entry["phase_s"] = time.perf_counter() - t_aux
        print(f"[aux] 4k: {aux_entry['phase_s']:.3f} s in all", flush=True)
        return aux_entry

    aux_entry = run_aux()

    # -- 4l. the multi-GPU layer on a one-rank NCCL mesh ----------------------
    mesh_entry = run_mesh(here, smi_line)

    # -- 5. kernel vs plain on every launch of the cold runs -------------------
    # for their times: config 1's first fill (its P blocks in one launch),
    # and of each engine run the square bond panel of each size with the most
    # pivots (among those, the largest true extents)
    fills = {}
    bond_panels = {}
    by_mode = {}  # tag -> {mode: panels}
    rook_slabs, dead_slabs = {}, {}
    for i, (tag, is_batched, args, kw) in enumerate(launch_inputs):
        kernel = originals[2] if is_batched else originals[1]
        plain = (lu_kernel.rrlu_plain_batched if is_batched
                 else lu_kernel.rrlu_plain)
        out, ref = kernel(*args, **kw, return_mode=True), plain(*args, **kw)
        for v in out[6].reshape(-1).tolist():
            mode = lu_cuda.PANEL_MODES[v]
            by_mode.setdefault(tag, {}).setdefault(mode, 0)
            by_mode[tag][mode] += 1
        out = out[:6]
        max_err = max(max_err, compare(
            f"{tag} launch {i} {tuple(args[0].shape)}", out, ref, 1.0))
        if tag in ("config2_rook_f64", "config2_rook_mixed", "rook_loop"):
            # each rook slab shape of phase 3d and of 4h's engine: its
            # launch with the most pivots, and a dead predicated step's
            P = args[0]
            key = ("config2" if tag.startswith("config2") else "config1",
                   str(P.dtype)[6:], f"{P.shape[1]}x{P.shape[2]}")
            ks = out[3].tolist()
            if key not in rook_slabs or ks[0] > rook_slabs[key][2][0]:
                rook_slabs[key] = (args, kw, ks)
            if int(args[3][0]) == 0 and key not in dead_slabs:
                dead_slabs[key] = (args, kw, ks)
        if tag in ("engine", "config3", "config4", "config5"):
            ks = out[3].tolist()
            B, mp, npd = args[0].shape
            if B > 1 and tag not in fills:
                fills[tag] = (args, kw, ks)
            elif B == 1 and mp == npd:
                # most pivots first, then the largest true extents
                rank = (ks[0], int(args[1][0]) * int(args[2][0]))
                if (tag, mp) not in bond_panels or (
                        rank > bond_panels[tag, mp][3]):
                    bond_panels[tag, mp] = (args, kw, ks, rank)
    ntag = {}
    for rec in launch_inputs:
        ntag[rec[0]] = ntag.get(rec[0], 0) + 1
    print(f"[kernel] every launch of the cold runs ({ntag}): kernel and plain "
          f"version identical (max |LU diff| {max_err}); panels by mode "
          f"{json.dumps(by_mode)}", flush=True)
    d1000 = by_mode.get("4j conversion D=1000", {})
    if not d1000.get("grid") or not d1000.get("cluster"):
        fail(f"4j conversion D=1000: panels by mode {d1000}, want both the "
             f"grid and the cluster mode")
    for tag in ("engine", "config4", "config5"):
        if by_mode.get(tag, {}).get("cluster", 0) == 0:
            fail(f"{tag}: no panel of its cold run took the cluster mode "
                 f"({by_mode.get(tag)})")
    for key in (("engine", 352), ("config3", 96), ("config4", 512),
                ("config5", 512)):
        if key not in bond_panels:
            fail(f"{key[0]}: no {key[1]}^2 bond panel among its launches "
                 f"({sorted(bond_panels)})")
    for tag in ("engine", "config5"):
        if tag not in fills:
            fail(f"{tag}: no batched fill among its launches")
    engine_fill = fills["engine"]
    ncomplex = sum(rec[2][0].is_complex() for rec in launch_inputs)
    print(f"[kernel] of them complex128: {ncomplex} launches (config 5's "
          f"cold runs and compressions), each identical to the plain "
          f"version", flush=True)

    def time_engine_launch(name, rec):
        """Device, wrapper-call and plain times of one recorded engine
        launch, and its bound summed over its panels."""
        args, kw, ks = rec[:3]
        B, mp, npd = args[0].shape
        parts = [bound_parts(mp, npd, int(args[1][b]), int(args[2][b]),
                             ks[b], args[0].element_size()) for b in range(B)]
        t_bytes, t_ops = (sum(p[i] for p in parts) for i in (0, 1))
        res = {name: f"{B}x{mp}x{npd}",
               f"{name}_k": ks,
               f"{name}_ms": kernel_device_ms(
                   lambda: originals[2](*args, **kw), 20),
               f"{name}_wrapper_ms": cuda_ms(
                   lambda: originals[2](*args, **kw), 20),
               f"{name}_plain_ms": cuda_ms(
                   lambda: lu_kernel.rrlu_plain_batched(*args, **kw), 3),
               f"{name}_bound_ms": max(t_bytes, t_ops),
               f"{name}_bound_by": ("bytes" if t_bytes >= t_ops
                                    else "operations")}
        modes = originals[2](*args, **kw, return_mode=True)[6].tolist()
        mode = "/".join(sorted({lu_cuda.PANEL_MODES[v] for v in modes}))
        res[f"{name}_mode"] = mode
        print(f"[kernel] {name} {B} x {mp}x{npd} {str(args[0].dtype)[6:]} "
              f"(k={ks}, true extents {args[1].tolist()} x "
              f"{args[2].tolist()}, {mode}): kernel device time "
              f"{res[name + '_ms']} ms "
              f"a launch (profiler), wrapper call "
              f"{res[name + '_wrapper_ms']:.4f} ms (events), plain "
              f"{res[name + '_plain_ms']:.4f} ms, bound "
              f"{res[name + '_bound_ms']:.6f} ms ({res[name + '_bound_by']})",
              flush=True)
        return res

    # the engines' bond panels, Imax (d + 1) square, and config 1's fill
    eng = {**time_engine_launch("engine_panel", bond_panels["engine", 352]),
           **time_engine_launch("engine_fill", engine_fill),
           **time_engine_launch("config3_panel", bond_panels["config3", 96]),
           **time_engine_launch("config4_panel_512",
                                bond_panels["config4", 512])}
    eng.update(time_engine_launch("config5_panel_512",
                                  bond_panels["config5", 512]))
    eng.update(time_engine_launch("config5_fill", fills["config5"]))
    for name in ("engine_panel", "config4_panel_512", "config5_panel_512"):
        if eng[f"{name}_mode"] != "cluster":
            fail(f"{name}: the kernel reported {eng[name + '_mode']}, not "
                 f"the cluster mode")
    # the rook slabs of phases 3d (config 2) and 4h (config 1), and a dead
    # predicated step (rank cap 0) of each shape that had one
    rook_slab_times = {}
    for (cfg, dt, shape), rec in sorted(rook_slabs.items()):
        name = f"rook_{cfg}_{dt}_{shape}"
        rook_slab_times[name] = time_engine_launch(name, rec)
        if (cfg, dt, shape) in dead_slabs:
            rook_slab_times[name + "_dead"] = time_engine_launch(
                name + "_dead", dead_slabs[cfg, dt, shape])
    for name in ("rook_config2_float64_4096x256",
                 "rook_config2_float64_256x4096",
                 "rook_config2_float32_4096x256",
                 "rook_config1_float64_352x32"):
        if name not in rook_slab_times:
            fail(f"phase 5: no {name} among the rook launches "
                 f"({sorted(rook_slab_times)})")
    rook_entry["slabs"] = rook_slab_times
    if ("config4", 1024) in bond_panels:
        eng.update(time_engine_launch("config4_panel_1024",
                                      bond_panels["config4", 1024]))
    else:
        print("[kernel] config 4 never reached a capacity of 64: no 1024^2 "
              "bond panel to time", flush=True)

    # -- 6. profiles (--profile) -----------------------------------------------
    if opts.profile:
        for tier in ("host", "fused"):
            profile_run(opts.profile, f"config1_{tier}",
                        lambda t=tier: solve_config1(t)[3])
        # the engine on an evaluator that is kept: every sweep a replay of
        # its graph, then the same sweeps queued eagerly (nothing is
        # recorded while the profiler runs)
        kept = solve_config1("engine")[-1]
        solve_config1("engine", f=kept)
        profile_run(opts.profile, "config1_engine_replayed",
                    lambda: solve_config1("engine", f=kept)[3])
        profile_run(opts.profile, "config1_engine_eager",
                    lambda: solve_config1("engine", f=kept, graphs=False)[3])
        kept3 = solve_config3()[-1]
        solve_config3(f=kept3)
        profile_run(opts.profile, "config3_replayed",
                    lambda: solve_config3(f=kept3)[-2])
        profile_run(opts.profile, "config3_eager",
                    lambda: solve_config3(f=kept3, graphs=False)[-2])
        solve_config4()
        solve_config4(fresh=False)
        solve_config4(fresh=False)
        profile_run(opts.profile, "config4_replayed",
                    lambda: solve_config4(fresh=False)[-2])
        profile_run(opts.profile, "config4_eager",
                    lambda: solve_config4(fresh=False, graphs=False)[-2])
        # the default protocol (phase 4e) on a kept evaluator, replayed
        kept = solve_config1("engine", loop=True)[-1]
        solve_config1("engine", f=kept, loop=True)
        profile_run(opts.profile, "config1_loop_replayed",
                    lambda: solve_config1("engine", f=kept, loop=True)[3])
        kept3 = solve_config3(loop=True)[-1]
        solve_config3(f=kept3, loop=True)
        profile_run(opts.profile, "config3_loop_replayed",
                    lambda: solve_config3(f=kept3, loop=True)[-2])
        solve_config4(loop=True)
        solve_config4(fresh=False, loop=True)
        profile_run(opts.profile, "config4_loop_replayed",
                    lambda: solve_config4(fresh=False, loop=True)[-2])
        kept5 = solve_config5()[-1]
        solve_config5(f=kept5)
        profile_run(opts.profile, "config5_loop_replayed",
                    lambda: solve_config5(f=kept5)[3])
        # TCI1 on the random f at D = 1000 (phase 4j (b))
        profile_random_f(1000)

    if any(m == "jax" or m.startswith(("jax.", "tci_tpu."))
           or m == "tci_tpu" for m in sys.modules):
        fail("jax or tci_tpu was imported")

    print(smi_line, flush=True)
    # The rrLU entry's "launches", "ms", "plain_ms" and "bound_ms" are all
    # config 1's engine's, the default path of a TorchBatchEvaluator: its
    # launches in one config-1 run under the default protocol (phase 4e,
    # the optimize loop) and the kernel's device time a launch on its bond
    # panel; each path's launches are beside them (the per-sweep protocol
    # under "engine", "config3" and "config4", the loop under "*_loop"; the
    # bond panels of configs 3 and 4 under config3_panel_* and
    # config4_panel_*), and the host tier's 128^2 panel under host_panel_*.
    # A probe entry's "launches" is its count in run_probes. No PyTorch call
    # computes a complete-pivot rrLU (torch.linalg.lu_factor pivots
    # partially) or a probe, so library_ms is null
    ms = eng["engine_panel_ms"]
    print(json.dumps({"kernels": [{
        "name": "rrlu_kernel",
        "route": "cuda",
        "source": "tci_tpu_torch/csrc/rrlu.cu",
        "replaces": "tci_tpu/ops/pallas_lu.py:133",
        "launches": loop_results["config1"]["launches"],
        "launches_by_path": {**{t: results[t]["launches"] for t in TIERS},
                             "config3": counts3["launches"],
                             "config4": counts4["launches"],
                             **{f"{c}_loop": r["launches"]
                                for c, r in loop_results.items()},
                             **{f"4f_compress_{m}": r["launches"]
                                for m, r in compress.items()},
                             **{f"4f_globalpivots_{t}": r["launches"]
                                for t, r in tt_entry["globalpivots"].items()},
                             "4f_cachedfunction": counts_cf["launches"],
                             "run_probes": probe_rrlu_launches,
                             "config5": config5["launches"],
                             "config5_cold": config5["launches_cold"],
                             **{f"config5_{t}": config5[t]["launches"]
                                for t in ("fused", "host")},
                             **{f"4g_compress_{m}": r["launches"]
                                for m, r in config5["compress"].items()},
                             **{f"3d_config2_rook_{p}": r["launches"]
                                for p, r in rook_entry["config2"].items()
                                if "launches" in r},
                             **{f"4h_config1_rook_{t}": r["launches"]
                                for t, r in rook_entry["config1"].items()},
                             **{t.replace(" ", "_"): r["launches"]
                                for t, r in contraction.items()
                                if t not in ("panels", "memory")},
                             **{t.replace(" ", "_"): r["launches"]
                                for t, r in conversions.items()},
                             **{f"4k_resume_{c}": r["launches"]
                                for c, r in aux_entry["checkpoint"].items()},
                             **{f"4k_scalar_{c}": r["launches"]
                                for c, r in aux_entry["scalar_f"].items()},
                             "4k_kernel_fuzz":
                                 aux_entry["kernel_fuzz"]["launches"]},
        "max_abs_err": max_err,
        "ms": ms if ms is not None else eng["engine_panel_wrapper_ms"],
        "ms_from": "profiler" if ms is not None else "cuda events",
        "plain_ms": eng["engine_panel_plain_ms"],
        "bound_ms": eng["engine_panel_bound_ms"],
        "bound_by": eng["engine_panel_bound_by"],
        "library_ms": None,
        "cuda_graphs": graph_results,
        "optimize_loop": loop_results,
        "tt_algebra": tt_entry,
        # the complex128 instantiation: phase 3's panels, config 5's run
        # and, under config5_panel_512_* / config5_fill_*, its bond panel
        # and its fill on the card
        "complex128": {"panels": complex_panels, "config5": config5},
        # the cluster mode: its configuration, its split on config
        # 1's panel, and the mode table at the main path's true extents
        "cluster_mode": {**cluster_cfg, "split": cluster_split,
                         "mode_rows": mode_rows},
        # rook pivoting: config 2 (phase 3d) and config 1 (phase 4h), and
        # each rook slab shape's times and bound (phase 5)
        "rook": rook_entry,
        # contraction and the device compression (phase 4i): each path's
        # walls, launches, fetches and linkdims, and the kernel on each
        # path's largest panel
        "contraction": contraction,
        # TCI1, matrix CI / ACA and the conversions (phase 4j): config 1 by
        # TCI1, the random-f sweep by D, the conversions' walls, launches
        # and the kernel on their panels, the matrix engines on config 2
        "tci1": tci1_entry,
        # the auxiliaries (phase 4k): checkpoint and resume, the scalar f,
        # interop, the kernel fuzz by type and mode, the examples' walls
        "aux": aux_entry,
        **host_panel,
        **eng,
        **n2000,
        **config2,
    }, *probe_entries, mesh_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def profile_run(outdir, tier, solve):
    """Warm walls of one workload (`tier` names it: config 1 through one
    tier, config 3, 4 or 5; `solve` runs it and returns its wall), then
    one run under torch.profiler with a span around each layer of the path;
    prints the breakdown."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tci_tpu_torch.models import device_sweep, globalpivotfinder, tensorci2
    from tci_tpu_torch.ops import fused, lu as lu_mod, luci

    walls = sorted(solve() for _ in range(10))
    print(f"[profile] {tier}: warm wall: median "
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
        # the default protocol: a block of the optimize loop (its steps'
        # runs and status reads within), and the sweep pair
        (tensorci2.TensorCI2, "_optimize_device_block",
         "optimize_device_block"),
        (engine, "optimize_loop", "engine_optimize_loop"),
        (engine, "sweep2site_pair", "engine_sweep2site_pair"),
        (device_sweep, "peek", "status_read"),
        (device_sweep, "_sweep", "engine_sweep_queue"),
        (device_sweep, "_fill", "engine_fill_queue"),
        (device_sweep, "_sweep1", "engine_sweep1site_queue"),
        # a program's upload (pack and one copy in) and its run: the host
        # time of one replay, or of the eager body with its queue spans
        (device_sweep._Program, "load", "engine_program_load"),
        (device_sweep._Program, "run", "engine_program_run"),
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
            with record_function("whole_run"):
                wall = solve()
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{tier}_trace.json")
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
               and e["name"] == "whole_run")
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
        if name != "whole_run":
            print(f"[profile] {tier}: span {name}: {ms:.3f} ms in {n} (host, "
                  f"inclusive)", flush=True)
    for name, (n, ms) in by_name("cuda_runtime")[:6]:
        print(f"[profile] {tier}: runtime {name}: {n} calls, {ms:.3f} ms host",
              flush=True)
    print(f"[profile] {tier}: trace: {path}", flush=True)


if __name__ == "__main__":
    main()
