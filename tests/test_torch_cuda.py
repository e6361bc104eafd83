"""tci_tpu_torch on a CUDA device: the rrLU kernel and the six batched-grid
probe kernels against their plain PyTorch versions on the card, and the main
path through the kernel: the host tier, the fused tier and the whole-sweep
engine, which syncs only at its fetch and replays its sweeps from CUDA
graphs (held bitwise against the same sweeps queued eagerly); ``integrate``
on the card; ``compress`` through the kernel, the engine's floating-zone
program against its eager body, and the caches' values on the card; the
GK panel kernel against its plain version, in a CUDA graph, its counters
under replay and a whole 10-D GK15 solve against the plain path.

Every test needs a CUDA device and skips without one: the CUDA kernel has
no CPU mode. This file imports neither jax nor tci_tpu, so it runs on a
machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: none. The kernel rounds like the plain version (no fused
multiply-add, round-to-nearest division and square root), so outputs are
compared for equality.
"""

import math

import numpy as np
import pytest
import torch

import _torch_fuzz as fz
import tci_tpu_torch
from tci_tpu_torch.ops import lu_cuda, lu_kernel, probe_batched

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _equal(a, b):
    return torch.equal(a, b) or bool((a.isnan() & b.isnan()).all())


def _same(a, b):
    """Equal, NaN where the other is NaN (a panel that holds NaN)."""
    return a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def _panel(seed, mp, npd, m, n, rank, dtype, device):
    rng = np.random.default_rng(seed)
    A = np.zeros((mp, npd))
    A[:m, :n] = rng.standard_normal((m, rank)) @ rng.standard_normal((rank, n))
    return torch.from_numpy(A).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("shape", [
    # (mp, np, m, n, rank): shared-memory resident panels ...
    (8, 8, 8, 5, 4), (128, 128, 120, 117, 30), (64, 16, 60, 10, 16),
    # ... and larger ones (cluster or grid mode), from just above the
    # resident limit up
    (176, 176, 170, 165, 40), (192, 192, 190, 185, 40),
    (256, 256, 250, 240, 50), (512, 256, 500, 250, 60),
    (1024, 1024, 1000, 990, 100), (64, 10240, 60, 10000, 40)])
def test_kernel_matches_plain(cuda, shape, leftorthogonal, dtype):
    mp, npd, m, n, rank = shape
    A = _panel(1, mp, npd, m, n, rank, dtype, cuda)
    args = (A, m, n, min(m, n), 1e-10, 0.0)
    out = lu_cuda.rrlu_call(*args, leftorthogonal=leftorthogonal)
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=leftorthogonal)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert _equal(o, r)


def _lorentzian(nI, nJ, seed, d=10):
    """A Π panel of config 1's shape, (d nI) x (d nJ), full of exact ties."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, d, size=(nI, 3))
    right = rng.integers(0, d, size=(nJ, 3))
    s = np.array([((p + 1.0) ** 2).sum() + (c + 1.0) ** 2
                  for p in left for c in range(d)])
    t = np.array([(c + 1.0) ** 2 + ((q + 1.0) ** 2).sum()
                  for c in range(d) for q in right])
    return 1.0 / (1.0 + s[:, None] + t[None, :])


def _bucketed(A, dtype, device):
    m, n = A.shape
    P = torch.zeros((lu_kernel.bucket(m), lu_kernel.bucket(n)), dtype=dtype,
                    device=device)
    P[:m, :n] = torch.as_tensor(A, device=device)
    return P


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("stop", ["abstol", "reltol"])
@pytest.mark.parametrize("blocks", [
    # (rows of I, cols of J) of a config-1 panel, (10 nI) x (10 nJ): buckets
    # 16^2 ... 128^2; None is a 5 x 6 rank-3 panel in the 8^2 bucket
    None, (1, 1), (2, 3), (4, 4), (6, 8), (10, 12), (12, 12)])
def test_resident_matches_plain(cuda, blocks, stop, leftorthogonal, dtype):
    """The shared-memory resident mode at the main path's panel shapes."""
    if blocks is None:
        rng = np.random.default_rng(3)
        A = rng.standard_normal((5, 3)) @ rng.standard_normal((3, 6))
    else:
        A = _lorentzian(*blocks, seed=10 * blocks[0] + blocks[1])
    m, n = A.shape
    P = _bucketed(A, dtype, cuda)
    reltol, abstol = ((1e-14, 1e-8 * float(np.abs(A).max()))
                      if stop == "abstol" else (1e-6, 0.0))
    args = (P, m, n, min(m, n), reltol, abstol)
    assert lu_cuda.host_mode(P.device.index, *P.shape, dtype) == "resident"
    out = lu_cuda.rrlu_call(*args, leftorthogonal=leftorthogonal)
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=leftorthogonal)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert _equal(o, r)


def test_resident_repeats_bitwise(cuda):
    """The 128^2 main-path panel, 20 runs against one plain result: a race
    between the kernel's phases would show as a rare wrong pivot."""
    A = _lorentzian(12, 12, seed=132)
    P = _bucketed(A, torch.float64, cuda)
    args = (P, 120, 120, 120, 1e-14, 1e-8 * float(np.abs(A).max()))
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=True)
    for _ in range(20):
        out = lu_cuda.rrlu_call(*args, leftorthogonal=True)
        for o, r in zip(out, ref):
            assert _equal(o, r)


def test_resident_misaligned_panel_raises(cuda):
    """The bulk copy needs a 16-byte aligned panel: a view 8 bytes into a
    buffer is refused before any launch."""
    buf = torch.zeros(8 * 8 + 1, dtype=torch.float64, device=cuda)
    P = buf[1:].view(8, 8)
    launches = lu_cuda.LAUNCHES["rrlu"]
    with pytest.raises(ValueError, match="16-byte"):
        lu_cuda.rrlu_call(P, 8, 8, 8, 0.0, 0.0, leftorthogonal=True)
    assert lu_cuda.LAUNCHES["rrlu"] == launches


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_resident_128_matches_plain(cuda, dtype):
    """Four 128^2 Π panels in one launch, per-panel extents, rank caps and
    tolerances (chip_smoke.py's batched case)."""
    A = torch.stack([_bucketed(_lorentzian(12, 12, seed=s), dtype, cuda)
                     for s in range(4)])
    mt = torch.tensor([120, 110, 120, 97], device=cuda)
    nt = torch.tensor([120, 120, 100, 120], device=cuda)
    mr = torch.tensor([120, 8, 100, 97], device=cuda)
    rt = torch.tensor([1e-14, 0.0, 1e-6, 1e-14], device=cuda)
    at = torch.tensor([1e-10, 0.0, 0.0, 0.0], device=cuda)
    for leftorthogonal in (True, False):
        out = lu_cuda.rrlu_batched(A, mt, nt, mr, rt, at,
                                   leftorthogonal=leftorthogonal)
        ref = lu_kernel.rrlu_plain_batched(A, mt, nt, mr, rt, at,
                                           leftorthogonal=leftorthogonal)
        for o, r in zip(out, ref):
            assert _equal(o, r)


def test_batched_kernel_matches_plain(cuda):
    A = torch.stack([_panel(s, 32, 24, 32, 24, 24, torch.float64, cuda)
                     for s in range(4)])
    mt = torch.tensor([32, 30, 32, 17], device=cuda)
    nt = torch.tensor([24, 24, 20, 24], device=cuda)
    mr = torch.tensor([24, 8, 24, 24], device=cuda)
    rt = torch.tensor([0.0, 0.0, 1e-3, 0.0], device=cuda)
    at = torch.zeros(4, device=cuda)
    out = lu_cuda.rrlu_batched(A, mt, nt, mr, rt, at, leftorthogonal=True)
    ref = lu_kernel.rrlu_plain_batched(A, mt, nt, mr, rt, at,
                                       leftorthogonal=True)
    for o, r in zip(out, ref):
        assert _equal(o, r)


def test_batched_multiblock_matches_plain(cuda):
    """Two 512 x 512 panels above the resident limit, each with its own
    extents, rank cap and tolerances: one cluster each, side by side."""
    A = torch.stack([_panel(5, 512, 512, 500, 480, 60, torch.float64, cuda),
                     _panel(6, 512, 512, 450, 512, 90, torch.float64, cuda)])
    mt = torch.tensor([500, 450], device=cuda)
    nt = torch.tensor([480, 512], device=cuda)
    mr = torch.tensor([480, 40], device=cuda)
    rt = torch.tensor([1e-10, 0.0], dtype=torch.float64, device=cuda)
    at = torch.tensor([0.0, 1e-3], dtype=torch.float64, device=cuda)
    for leftorthogonal in (True, False):
        out = lu_cuda.rrlu_batched(A, mt, nt, mr, rt, at,
                                   leftorthogonal=leftorthogonal)
        ref = lu_kernel.rrlu_plain_batched(A, mt, nt, mr, rt, at,
                                           leftorthogonal=leftorthogonal)
        assert out[3].tolist() == [60, 40]
        for o, r in zip(out, ref):
            assert _equal(o, r)


def test_batched_cluster_and_grid_matches_plain(cuda):
    """Three 1024 x 1024 f64 panels in one call whose true rows pick
    different modes: 960 and 900 rows fit no cluster (the grid mode), 200
    do (the cluster mode). The grid kernel skips the middle panel and
    eliminates the other two in turn, reusing its scratch and barrier."""
    A = torch.stack([_panel(s, 1024, 1024, m, 1000, 40, torch.float64, cuda)
                     for s, m in ((8, 960), (9, 200), (10, 900))])
    mt = torch.tensor([960, 200, 900], device=cuda)
    nt = torch.tensor([1000, 1000, 1000], device=cuda)
    mr = torch.tensor([40, 40, 30], device=cuda)
    rt = torch.tensor([1e-12, 1e-12, 0.0], dtype=torch.float64, device=cuda)
    at = torch.zeros(3, dtype=torch.float64, device=cuda)
    for leftorthogonal in (True, False):
        out = lu_cuda.rrlu_batched(A, mt, nt, mr, rt, at,
                                   leftorthogonal=leftorthogonal,
                                   return_mode=True)
        ref = lu_kernel.rrlu_plain_batched(A, mt, nt, mr, rt, at,
                                           leftorthogonal=leftorthogonal)
        assert out[6].tolist() == [2, 1, 2]
        assert out[3].tolist() == [40, 40, 30]
        for o, r in zip(out, ref):
            assert _equal(o, r)


def test_multiblock_repeats_bitwise(cuda):
    """N = 2000 in the grid mode (streamed), 20 runs against one plain
    result: a stale cross-block read would show as a rare wrong pivot."""
    A = _panel(2000, 2048, 2048, 2000, 2000, 100, torch.float64, cuda)
    args = (A, 2000, 2000, 2000, 1e-12, 0.0)
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=True)
    assert int(ref[3]) == 100
    for _ in range(20):
        out = lu_cuda.rrlu_call(*args, leftorthogonal=True, return_mode=True)
        assert int(out[6]) == 3
        for o, r in zip(out, ref):
            assert _equal(o, r)


# -- the grid mode: grid-resident (2) and streamed (3) panels ---------------


def _grid_edge(dtype, mp, npd):
    """The most true rows of an (mp, np) panel of `dtype` that the grid
    mode holds in the grid's shared memory (lu_cuda.grid_regime, a rule
    monotone in the rows), found by bisection."""
    dev = torch.cuda.current_device()
    lo, hi = 0, mp  # grid at lo, streamed at hi
    assert lu_cuda.grid_regime(dev, lo, mp, npd, dtype) == "grid"
    assert lu_cuda.grid_regime(dev, hi, mp, npd, dtype) == "stream"
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if lu_cuda.grid_regime(dev, mid, mp, npd, dtype) == "grid":
            lo = mid
        else:
            hi = mid
    return lo


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("side", ["under", "over"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex128])
def test_grid_capacity_edge_matches_plain(cuda, dtype, side,
                                          leftorthogonal):
    """Panels whose true rows just fit the grid's shared memory (the
    grid-resident regime, mode 2) and one row more (streamed, mode 3), in
    each type and orientation, bitwise the plain version; the rank cap (23)
    is no multiple of the streamed regime's deferral."""
    mp, npd = {torch.float32: (4096, 2048), torch.float64: (4096, 1024),
               torch.complex128: (2048, 1024)}[dtype]
    m = _grid_edge(dtype, mp, npd) + (side == "over")
    n = npd - 7
    if dtype.is_complex:
        A = _cpanel(m, mp, npd, m, n, 30, cuda)
    else:
        A = _panel(m, mp, npd, m, n, 30, dtype, cuda)
    args = (A, m, n, 23, 0.0, 0.0)
    out = lu_cuda.rrlu_call(*args, leftorthogonal=leftorthogonal,
                            return_mode=True)
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=leftorthogonal)
    torch.cuda.synchronize()
    assert int(out[6]) == (2 if side == "under" else 3)
    assert int(out[3]) == 23
    for o, r in zip(out, ref):
        assert _equal(o, r)


# (regime, stop) -> (panel, m, n, maxrank, reltol, abstol): a 1024^2 panel
# of 1000 true rows is grid-resident, a 2048^2 one of 2040 streamed
def _grid_stop_case(regime, stop, device):
    mp, m = (1024, 1000) if regime == "grid" else (2048, 2040)
    rng = np.random.default_rng(mp + len(stop))
    n = mp - 9 if stop != "no_column_left" else 40
    U = rng.standard_normal((m, 60))
    if stop in ("reltol", "abstol"):
        U = U * 10.0 ** (-np.arange(60) / 4.0)
    A = np.zeros((mp, mp))
    A[:m, :n] = U @ rng.standard_normal((60, n))
    P = torch.from_numpy(A).to(device)
    return {"maxrank": (P, m, n, 37, 0.0, 0.0),
            "reltol": (P, m, n, m, 1e-9, 0.0),
            "abstol": (P, m, n, m, 0.0, 1e-6),
            "no_column_left": (P, m, n, m, 0.0, 0.0)}[stop]


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("stop", ["maxrank", "reltol", "abstol",
                                  "no_column_left"])
@pytest.mark.parametrize("regime", ["grid", "stream"])
def test_grid_stops_match_plain(cuda, regime, stop, leftorthogonal):
    """Each stop rule in each grid regime, bitwise the plain version: a rank
    cap of 37 (the streamed regime then stops with updates still to write
    back), a reltol and an abstol stop on decaying panels, and 40 true
    columns of full rank, after which no valid column is left (err 0)."""
    args = _grid_stop_case(regime, stop, cuda)
    out = lu_cuda.rrlu_call(*args, leftorthogonal=leftorthogonal,
                            return_mode=True)
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=leftorthogonal)
    torch.cuda.synchronize()
    assert lu_cuda.PANEL_MODES[int(out[6])] == regime
    for o, r in zip(out, ref):
        assert _equal(o, r)
    if stop == "no_column_left":
        assert int(out[3]) == 40 and float(out[5]) == 0.0


def test_grid_batched_mixes_regimes(cuda):
    """Four 2048^2 f64 panels in one call whose true rows pick the
    streamed regime (2045, 2048 rows), the cluster mode (100) and the
    grid-resident regime (1000): one cluster launch and both grid
    instantiations, each taking its own panels in turn; per-panel rank caps
    and tolerances."""
    A = torch.stack([_panel(s, 2048, 2048, m, 2000, 40, torch.float64, cuda)
                     for s, m in ((1, 2045), (2, 100), (3, 1000),
                                  (4, 2048))])
    mt = torch.tensor([2045, 100, 1000, 2048], device=cuda)
    mr = torch.tensor([37, 20, 23, 9], device=cuda)
    rt = torch.tensor([1e-12, 0.0, 1e-12, 0.0], dtype=torch.float64,
                      device=cuda)
    at = torch.tensor([0.0, 1e-3, 0.0, 0.0], dtype=torch.float64,
                      device=cuda)
    for leftorthogonal in (True, False):
        out = lu_cuda.rrlu_batched(A, mt, 2000, mr, rt, at,
                                   leftorthogonal=leftorthogonal,
                                   return_mode=True)
        ref = lu_kernel.rrlu_plain_batched(A, mt, 2000, mr, rt, at,
                                           leftorthogonal=leftorthogonal)
        assert out[6].tolist() == [3, 1, 2, 3]
        for o, r in zip(out, ref):
            assert _equal(o, r)


@pytest.mark.parametrize("shape", ["960^2", "4096x256"])
def test_grid_repeats_bitwise(cuda, shape):
    """Config 4's 960^2 bond panel at capacity 64 (k = 44) and config 2's
    4096 x 256 rook slab (k = 256), both grid-resident, 20 runs each against
    one plain result: a stale cross-block read would show as a rare wrong
    pivot (N = 2000, streamed: test_multiblock_repeats_bitwise)."""
    if shape == "960^2":
        A = _panel(1024, 1024, 1024, 960, 960, 88, torch.float64, cuda)
        args = (A, 960, 960, 44, 1e-14, 0.0)
    else:
        A = _panel(256, 4096, 256, 4096, 256, 256, torch.float64, cuda)
        args = (A, 4096, 256, 256, 0.0, 0.0)
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=True)
    for _ in range(20):
        out = lu_cuda.rrlu_call(*args, leftorthogonal=True, return_mode=True)
        assert int(out[6]) == 2
        for o, r in zip(out, ref):
            assert _equal(o, r)


def test_grid_barrier_alone(cuda):
    """The grid mode's barrier alone: one block an SM, a finite time a
    barrier of under 50 us."""
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert lu_cuda.grid_blocks(dev, 8) == sms
    us = lu_cuda.grid_barrier_ms(dev, 1000) * 1e3
    assert 0.0 < us < 50.0


def test_multiblock_rrlu_is_one_launch(cuda):
    A = _panel(3, 1000, 1000, 1000, 1000, 50, torch.float64, cuda)
    launches = lu_cuda.LAUNCHES["rrlu"]
    plain = lu_kernel.PLAIN_CALLS["cuda"]
    lu = tci_tpu_torch.rrlu(A, reltol=1e-10)
    assert lu_cuda.LAUNCHES["rrlu"] == launches + 1
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    assert lu.npivots() == 50


@pytest.mark.parametrize("shape", [(64, 10000, 40), (4200, 4200, 100)])
def test_rrlu_large_panels_match_plain(cuda, shape):
    """Panels whose vectors overflowed the one-block mode's shared memory
    (ROADMAP C-port-3): the public rrlu returns the plain version's result."""
    m, n, rank = shape
    A = _panel(7, m, n, m, n, rank, torch.float64, cuda)
    lu = tci_tpu_torch.rrlu(A, reltol=1e-12)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lu_kernel, "rrlu_panel", lu_kernel.rrlu_plain)
        ref = tci_tpu_torch.rrlu(A, reltol=1e-12)
    assert lu.npivots() == ref.npivots() == rank
    assert np.array_equal(lu.rowpermutation, ref.rowpermutation)
    assert np.array_equal(lu.colpermutation, ref.colpermutation)
    assert torch.equal(lu.L, ref.L) and torch.equal(lu.U, ref.U)
    assert np.array_equal(lu.pivoterrors(), ref.pivoterrors())
    assert lu.lastpivoterror() == ref.lastpivoterror()


# The main path's panels above the resident limit, padded as its buckets pad
# them, with the true extents it gives them: config 1's bond panel (352^2,
# 132^2, k = 12), config 4's at Imax 32 (512^2, 480^2, k = 32) and at 64
# (1024^2, 960^2, k = 44), config 5's complex one (512^2, 136 x 271, k =
# 19). (dtype, mp, m, n, k) -> the mode the kernel reports: 1 cluster, 2
# grid (960 rows of 8 KB fit no cluster).
CLUSTER_SHAPES = {
    (torch.float64, 352, 132, 132, 12): 1,
    (torch.float64, 512, 480, 480, 32): 1,
    (torch.float64, 1024, 960, 960, 44): 2,
    (torch.float32, 352, 132, 132, 12): 1,
    (torch.float32, 512, 480, 480, 32): 1,
    (torch.float32, 1024, 960, 960, 44): 2,
    (torch.complex128, 512, 136, 271, 19): 1,
}


def _main_path_panel(dtype, mp, m, n, k, device, seed=0):
    if dtype.is_complex:
        return _cpanel(seed, mp, mp, m, n, 2 * k, device)
    return _panel(seed, mp, mp, m, n, 2 * k, dtype, device)


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("shape", list(CLUSTER_SHAPES),
                         ids=lambda s: f"{str(s[0])[6:]}-{s[1]}")
def test_cluster_mode_matches_plain(cuda, shape, leftorthogonal):
    """The cluster mode (and the grid mode where the true rows fit no
    cluster) at the main path's shapes, rank capped at its k."""
    dtype, mp, m, n, k = shape
    A = _main_path_panel(dtype, mp, m, n, k, cuda)
    args = (A, m, n, k, 1e-14, 0.0)
    out = lu_cuda.rrlu_call(*args, leftorthogonal=leftorthogonal,
                            return_mode=True)
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=leftorthogonal)
    torch.cuda.synchronize()
    assert int(out[3]) == k
    for o, r in zip(out, ref):
        assert _equal(o, r)


def _fits_cluster(m, mp, npd, C, elsize):
    """csrc/rrlu.cu's fits_cluster: a CTA's share of the m true rows (full
    padded width), y, x and the int state in one CTA's shared memory."""
    rows = -(-m // C)
    need = (rows * npd * elsize + (npd + rows) * elsize
            + (mp + 2 * npd + 2 * rows) * 4)
    return need <= 232448 - 2048


def test_cluster_mode_reports_mode(cuda):
    """The host's plan for each main-path shape and the mode the kernel
    reports. With 16-CTA clusters (the H100 SXM) the padded 352^2 and
    512^2 f64 / f32 panels fit a cluster (one launch); 1024^2, and config
    5's complex 512^2 (4 MB padded), may not (the cluster kernel, then the
    grid kernel), and their true extents pick one of the two on the device
    (CLUSTER_SHAPES); another cluster size is held to the rule itself."""
    dev = torch.cuda.current_device()
    for shape, mode in CLUSTER_SHAPES.items():
        dtype, mp, m, n, k = shape
        es = torch.empty((), dtype=dtype).element_size()
        C = lu_cuda.cluster_size(dev, es)
        assert C in (8, 16)
        plan = lu_cuda.host_mode(dev, mp, mp, dtype)
        assert plan == ("cluster" if _fits_cluster(mp, mp, mp, C, es)
                        else "cluster+grid"), shape
        if C == 16:
            assert plan == ("cluster" if mp < 1024 and not dtype.is_complex
                            else "cluster+grid"), shape
        else:
            mode = 1 if _fits_cluster(m, mp, mp, C, es) else 2
        A = _main_path_panel(dtype, mp, m, n, k, cuda)
        out = lu_cuda.rrlu_call(A, m, n, k, 1e-14, 0.0, leftorthogonal=True,
                                return_mode=True)
        assert int(out[6]) == mode, shape


def test_cluster_batched_complex_matches_plain(cuda):
    """Four complex 128^2 panels in one call, one cluster each, side by
    side, with per-panel extents, rank caps and tolerances."""
    A = torch.stack([_cpanel(s, 128, 128, 120 - s, 128, 30, cuda)
                     for s in range(4)])
    mt = torch.tensor([120, 119, 118, 117], device=cuda)
    nt = torch.tensor([128, 100, 128, 90], device=cuda)
    mr = torch.tensor([128, 5, 100, 90], device=cuda)
    rt = torch.tensor([1e-12, 0.0, 1e-3, 1e-14], dtype=torch.float64,
                      device=cuda)
    at = torch.tensor([0.0, 0.0, 0.0, 1e-2], dtype=torch.float64,
                      device=cuda)
    for leftorthogonal in (True, False):
        out = lu_cuda.rrlu_batched(A, mt, nt, mr, rt, at,
                                   leftorthogonal=leftorthogonal,
                                   return_mode=True)
        ref = lu_kernel.rrlu_plain_batched(A, mt, nt, mr, rt, at,
                                           leftorthogonal=leftorthogonal)
        for o, r in zip(out, ref):
            assert _equal(o, r)
        assert out[6].tolist() == [1, 1, 1, 1]


def test_cluster_repeats_bitwise(cuda):
    """Config 1's bond panel in the cluster mode, 20 runs against one plain
    result: a missing release / acquire between the CTAs would show as a
    rare wrong pivot."""
    A = _main_path_panel(torch.float64, 352, 132, 132, 12, cuda, seed=352)
    args = (A, 132, 132, 132, 1e-14, 0.0)
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=True)
    for _ in range(20):
        out = lu_cuda.rrlu_call(*args, leftorthogonal=True)
        for o, r in zip(out, ref):
            assert _equal(o, r)


def test_phase_clocks_build_matches_plain(cuda, monkeypatch):
    """The build with -DRRLU_PHASE_CLOCKS (chip_smoke.py --phases): its
    cluster kernel stays bitwise its plain version, and every CTA of the
    panel reports a positive cycle count for each of its nine phases."""
    phased = lu_cuda._lib(("RRLU_PHASE_CLOCKS",))
    monkeypatch.setattr(lu_cuda, "_lib", lambda: phased)
    A = _main_path_panel(torch.float64, 352, 132, 132, 12, cuda)
    args = (A, 132, 132, 12, 1e-14, 0.0)
    out = lu_cuda.rrlu_call(*args, leftorthogonal=False, return_mode=True)
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=False)
    torch.cuda.synchronize()
    cycles = torch.zeros((16, 9), dtype=torch.int64)
    assert phased.rrlu_phase_cycles_read(cycles.data_ptr()) == 0
    assert int(out[6]) == 1
    for o, r in zip(out, ref):
        assert _equal(o, r)
    C = lu_cuda.cluster_size(torch.cuda.current_device(), 8)
    assert bool((cycles[:C] > 0).all())


def _nan_matrix(case):
    """ROADMAP C-port-9's inputs; "padded_302" pads the first with 300
    zero rows and columns."""
    nan = float("nan")
    if case == "padded_302":
        return torch.nn.functional.pad(_nan_matrix("nan_upper_right"),
                                       (0, 300, 0, 300))
    return torch.tensor({"nan_upper_right": [[1.0, nan], [2.0, 3.0]],
                         "nan_upper_left": [[nan, 1.0], [2.0, 3.0]],
                         "all_nan": [[nan] * 3] * 3}[case],
                        dtype=torch.float64)


def _nan_panel(case, pad):
    A = _nan_matrix(case)
    P = torch.zeros((pad, pad), dtype=torch.float64)
    P[:A.shape[0], :A.shape[1]] = A
    return P


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("case", ["nan_upper_right", "nan_upper_left",
                                  "all_nan", "padded_302"])
def test_rrlu_nan_on_cuda_raises(cuda, case, leftorthogonal):
    """C-port-9 on the card: the four inputs as CUDA tensors raise the
    ValueError the CPU raises (tests/test_torch_lu.py holds that against
    tci_tpu)."""
    A = _nan_matrix(case)
    with pytest.raises(ValueError) as ref:
        tci_tpu_torch.rrlu(A, leftorthogonal=leftorthogonal)
    with pytest.raises(ValueError) as out:
        tci_tpu_torch.rrlu(A.to(cuda), leftorthogonal=leftorthogonal)
    assert str(out.value) == str(ref.value)


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("pad,mode", [(8, 0), (320, 1), (1152, 2),
                                      (2048, 3)])
@pytest.mark.parametrize("case", ["nan_upper_right", "nan_upper_left",
                                  "all_nan"])
def test_nan_panel_kernel_matches_plain(cuda, case, pad, mode,
                                        leftorthogonal):
    """The kernel follows the plain version's NaN rule in each mode (8^2
    resident, 320^2 cluster, 1152^2 with 1100 true rows grid-resident,
    2048^2 with 2040 streamed), bitwise with NaN where the plain version
    has NaN; k is never 0."""
    P = _nan_panel(case, pad)
    m = 2 if case != "all_nan" else 3
    m_true = {2: 1100, 3: 2040}.get(mode, m)
    args = (P.to(cuda), m_true, m_true, m_true, 1e-14, 0.0)
    out = lu_cuda.rrlu_call(*args, leftorthogonal=leftorthogonal,
                            return_mode=True)
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=leftorthogonal)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert _same(o, r)
    assert int(out[6]) == mode and int(out[3]) > 0
    assert bool(out[5].isnan())


def test_rrlu_on_cuda_launches_the_kernel(cuda):
    A = _panel(2, 300, 200, 300, 200, 40, torch.float64, cuda)
    launches = lu_cuda.LAUNCHES["rrlu"]
    plain = lu_kernel.PLAIN_CALLS["cuda"]
    lu = tci_tpu_torch.rrlu(A, reltol=1e-10)
    assert lu_cuda.LAUNCHES["rrlu"] == launches + 1
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    assert lu.npivots() == 40 and lu.L.device.type == "cuda"
    assert torch.allclose(lu.left() @ lu.right(), A, atol=1e-9)


def test_tci2_on_cuda_matches_cpu(cuda):
    def f(idx):
        v = idx.to(torch.float64) + 1.0
        return 1.0 / (1.0 + (v * v).sum(dim=1))

    dims = [10] * 4
    runs = []
    for dev in ("cpu", cuda):
        bf = tci_tpu_torch.TorchBatchEvaluator(f, dims, device=dev)
        runs.append(tci_tpu_torch.crossinterpolate2(
            np.float64, bf, dims, tolerance=1e-8,
            rng=np.random.default_rng(0), device=dev))
    (c, cranks, cerrs), (g, granks, gerrs) = runs
    assert granks == cranks and g.Iset == c.Iset and g.Jset == c.Jset
    np.testing.assert_allclose(gerrs, cerrs, rtol=0, atol=1e-15)
    assert all(t.device.type == "cuda" for t in g.sitetensors())


def _lorentz(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(dim=1))


@pytest.mark.parametrize("shape", [
    # (B, panel edge): the engine's fill blocks (resident), the host tier's
    # largest bucket, and config 1's engine bond panel Imax (d + 1) at
    # Imax = 32 (cluster); config 3's bond panel (d = 2: 96^2, resident)
    # and config 4's (d = 15: 512^2, cluster)
    (1, 32), (1, 128), (1, 352), (7, 32), (1, 96), (1, 512)])
def test_device_extents_match_plain(cuda, shape):
    """Extents, rank caps and tolerances given as device tensors: nothing is
    read back (sync debug mode "error" would raise), the kernel clamps an
    extent past the panel as the plain version does, and the two agree
    bitwise."""
    B, e = shape
    rng = np.random.default_rng(e + B)
    A = torch.zeros((B, e, e), dtype=torch.float64, device=cuda)
    for b, s in enumerate(rng.integers(0, 1000, B)):
        panel = _lorentzian(e // 10, e // 10, seed=int(s))
        A[b, :panel.shape[0], :panel.shape[1]] = torch.as_tensor(panel)
    m = torch.as_tensor(rng.integers(e // 2, e + 1, B), dtype=torch.int32,
                        device=cuda)
    m[0] = e + 5  # past the panel: clamped to e
    n = torch.as_tensor(rng.integers(e // 2, e + 1, B), dtype=torch.int32,
                        device=cuda)
    maxrank = torch.minimum(m, n)
    reltol = torch.full((B,), 1e-14, dtype=torch.float64, device=cuda)
    abstol = torch.full((B,), 1e-10, dtype=torch.float64, device=cuda)
    args = (A, m, n, maxrank, reltol, abstol)
    launches = lu_cuda.LAUNCHES["rrlu"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = lu_kernel.rrlu_panel_batched(*args, leftorthogonal=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert lu_cuda.LAUNCHES["rrlu"] == launches + 1
    ref = lu_kernel.rrlu_plain_batched(*args, leftorthogonal=True)
    for o, r in zip(out, ref):
        assert _equal(o, r)
    assert int(out[3].min()) > 0


@pytest.mark.parametrize("as_tensor", [False, True])
def test_host_extents_that_do_not_fit_raise(cuda, as_tensor):
    """Extents given on the host (ints, or tensors on the CPU) are still
    checked before a launch; only extents on the card are left to the
    kernel's clamp."""
    A = torch.zeros((2, 32, 32), dtype=torch.float64, device=cuda)
    m = torch.tensor([32, 33]) if as_tensor else 33
    launches = lu_cuda.LAUNCHES["rrlu"]
    with pytest.raises(ValueError, match="do not fit"):
        lu_cuda.rrlu_batched(A, m, 32, 32, 0.0, 0.0, leftorthogonal=True)
    with pytest.raises(ValueError, match="do not fit"):
        lu_cuda.rrlu_call(A[0], 32, -1, 32, 0.0, 0.0, leftorthogonal=True)
    assert lu_cuda.LAUNCHES["rrlu"] == launches


def test_engine_sweep_syncs_only_at_its_fetch(cuda):
    """One whole 2-site sweep and its fill at config 1's widths: torch's
    sync debug mode sees no synchronization, and the one host wait, the
    fetch at the end, is counted once."""
    from tci_tpu_torch.models import device_sweep

    dims = [10] * 8
    bf = tci_tpu_torch.TorchBatchEvaluator(_lorentz, dims, device=cuda)
    tci = tci_tpu_torch.TensorCI2.from_function(bf, dims, device=cuda)
    engine = bf.device_sweep_engine
    empty = [[] for _ in dims]
    # each key once before: its first use records the graph, and the
    # capture's end synchronizes; the sweep under the debug mode is a replay
    assert engine.sweep2site(tci, True, 1e-14, 0.0, 2**62, empty, empty)
    assert engine.sweep2site(tci, False, 1e-14, 0.0, 2**62, empty, empty,
                             fill_sites=True)
    assert engine.sweep2site(tci, True, 1e-14, 0.0, 2**62, empty, empty)
    torch.cuda.synchronize()
    assert engine.captures == 2 and not engine.declined
    replays = engine.replays
    fetches, launches = device_sweep.FETCHES["engine"], lu_cuda.LAUNCHES["rrlu"]
    plain = lu_kernel.PLAIN_CALLS["cuda"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert engine.sweep2site(tci, False, 1e-14, 0.0, 2**62, empty, empty,
                                 fill_sites=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert device_sweep.FETCHES["engine"] == fetches + 1
    assert engine.replays == replays + 1 and engine.captures == 2
    assert lu_cuda.LAUNCHES["rrlu"] == launches + len(dims)
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    assert engine.Imax == 32
    assert all(t.device.type == "cuda" for t in tci.sitetensors())


def test_config1_tiers_match_host_tier(cuda):
    """Config 1 on the card through the engine, the fused tier and the host
    tier: the same ranks and pivot sets, errors to 1e-15."""
    dims = [10] * 8

    def host_f(x):
        return 1.0 / (1.0 + sum((i + 1.0) ** 2 for i in x))

    runs = []
    for f in (host_f,
              tci_tpu_torch.TorchBatchEvaluator(_lorentz, dims, device=cuda),
              tci_tpu_torch.TorchBatchEvaluator(_lorentz, dims, device=cuda,
                                                enable_device_sweep=False)):
        plain = lu_kernel.PLAIN_CALLS["cuda"]
        runs.append(tci_tpu_torch.crossinterpolate2(
            np.float64, f, dims, tolerance=1e-8, rng=np.random.default_rng(0),
            device=cuda))
        assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    (h, hranks, herrs), *tiers = runs
    assert hranks == [12, 12, 12]
    for t, ranks, errs in tiers:
        assert ranks == hranks and t.Iset == h.Iset and t.Jset == h.Jset
        np.testing.assert_allclose(errs, herrs, rtol=0, atol=1e-15)
        assert all(s.device.type == "cuda" for s in t.sitetensors())


def test_default_device_tci2_with_plain_f_runs_the_kernel(cuda):
    """No device argument and a plain scalar f: the panels are sampled on
    the host and factorized on the card, every one by the kernel."""
    def f(x):
        return 1.0 / (1.0 + sum((i + 1.0) ** 2 for i in x))

    launches = lu_cuda.LAUNCHES["rrlu"]
    plain = sum(lu_kernel.PLAIN_CALLS.values())
    tci, ranks, errs = tci_tpu_torch.crossinterpolate2(
        np.float64, f, [10] * 4, tolerance=1e-8, rng=np.random.default_rng(0))
    assert tci.device.type == "cuda"
    assert lu_cuda.LAUNCHES["rrlu"] > launches
    assert sum(lu_kernel.PLAIN_CALLS.values()) == plain
    assert all(t.device.type == "cuda" for t in tci.sitetensors())
    assert errs[-1] < 1e-8


def _probe_args(name, B, n, s, device):
    return (B, device) if name == "v1" else (s,) if name == "v2" else (s, n)


def _probe_bitwise(out, ref):
    """Kernel outputs against the plain version's, bit for bit (a float32
    output compared as its int32 bits)."""
    if not isinstance(out, tuple):
        out, ref = (out,), (ref,)
    for o, r in zip(out, ref):
        assert o.device.type == "cuda" and o.dtype == r.dtype
        assert o.shape == r.shape
        if o.dtype == torch.float32:
            o, r = o.view(torch.int32), r.view(torch.int32)
        assert torch.equal(o, r)


@pytest.mark.parametrize("which", list(probe_batched.INPUT_SETS))
@pytest.mark.parametrize("name", probe_batched.NAMES)
def test_probe_kernel_matches_plain(cuda, name, which):
    """Each probe kernel against its plain version, bit for bit, at every
    input set (the probe's, the second, rows of 1, 3 and 257 columns, one
    and 300 programs, loop limits below 0, at 0 and at 10,000, sums that
    wrap, round and overflow); one launch a call."""
    B, n, s = probe_batched.check_inputs(name, which, cuda)
    wrapper, plain = probe_batched.PROBES[name]
    args = _probe_args(name, B, n, s, cuda)
    launches = probe_batched.LAUNCHES[name]
    out = wrapper(*args)
    torch.cuda.synchronize()
    assert probe_batched.LAUNCHES[name] == launches + 1
    _probe_bitwise(out, plain(*args))


@pytest.mark.parametrize("name", probe_batched.NAMES)
def test_probe_kernel_repeats_bitwise(cuda, name):
    """20 launches of each probe kernel at the probe's inputs and at the
    unaligned 257-column rows, every one bit for bit the plain version."""
    wrapper, plain = probe_batched.PROBES[name]
    for which in ("probe", "n257"):
        B, n, s = probe_batched.check_inputs(name, which, cuda)
        args = _probe_args(name, B, n, s, cuda)
        ref = plain(*args)
        launches = probe_batched.LAUNCHES[name]
        outs = [wrapper(*args) for _ in range(20)]
        torch.cuda.synchronize()
        assert probe_batched.LAUNCHES[name] == launches + 20
        for out in outs:
            _probe_bitwise(out, ref)


def test_probe_floor_counts_no_launch(cuda):
    """floor_ms at each probe's launch shape runs the empty kernel and
    counts no probe launch; it gives a device time (not held to a limit)."""
    launches = dict(probe_batched.LAUNCHES)
    for name in probe_batched.NAMES:
        B, n, _ = probe_batched.check_inputs(name, "probe", cuda)
        ms = probe_batched.floor_ms(*probe_batched.launch_shape(name, B, n),
                                    device=cuda, reps=50)
        assert math.isfinite(ms) and ms > 0
    assert dict(probe_batched.LAUNCHES) == launches


def test_run_probes_on_the_card(cuda):
    launches = dict(probe_batched.LAUNCHES)
    rrlu, plain = lu_cuda.LAUNCHES["rrlu"], lu_kernel.PLAIN_CALLS["cuda"]
    out = probe_batched.run_probes(cuda)
    assert out == probe_batched.run_probes("cpu")
    assert all(step["ok"] for step in out.values())
    for name in probe_batched.NAMES:
        assert probe_batched.LAUNCHES[name] == launches.get(name, 0) + 1
    assert lu_cuda.LAUNCHES["rrlu"] == rrlu + 2
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain


def test_integrate_torch_native_on_the_card(cuda):
    """tests/test_integration.py's polynomial case through
    integrate(torch_native=True) with no device argument: sampled and
    factorized on the card, within 1e-12 relative of the CPU run."""
    coefficients = [
        0.23637074801483304, 0.20661524945577847, 0.1850826417895819,
        0.8433788714289417, 0.5801482873508491, 0.20339438932656262,
        0.21593267492457668, 0.8052490409622802, 0.7189346124875339,
        0.9400806688257749, 0.355210845205325, 0.5251561513473092,
        0.6819965273401778, 0.9221987248861162, 0.04166444723413998]

    def f(X):
        y = torch.full_like(X, coefficients[-1])
        for c in coefficients[-2::-1]:
            y = y * X + c
        return y.prod(dim=1)

    n = 5
    exact = sum(c / (i + 1) for i, c in enumerate(coefficients)) ** n
    launches, plain = lu_cuda.LAUNCHES["rrlu"], lu_kernel.PLAIN_CALLS["cuda"]
    val = tci_tpu_torch.integrate(np.float64, f, [0.0] * n, [1.0] * n,
                                  torch_native=True,
                                  rng=np.random.default_rng(0))
    assert lu_cuda.LAUNCHES["rrlu"] > launches
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    ref = tci_tpu_torch.integrate(np.float64, f, [0.0] * n, [1.0] * n,
                                  torch_native=True, device="cpu",
                                  rng=np.random.default_rng(0))
    assert np.isclose(val, exact)
    assert abs(val - ref) <= 1e-12 * abs(ref)


def _quantics_f(R, device):
    w = torch.tensor([2.0 ** -(r + 1) for r in range(R)], dtype=torch.float64,
                     device=device)

    def f(bits):
        x = (bits.to(torch.float64) * w).sum(dim=1)
        return torch.cos(100.0 * x) * torch.exp(-x)

    return f


def _graph_problem(name, device):
    if name == "4^5":
        return [4] * 5, _lorentz, 1e-10
    return [2] * 12, _quantics_f(12, device), 1e-10


def _same_result(a, b):
    (ta, ranks_a, errs_a), (tb, ranks_b, errs_b) = a, b
    assert ranks_a == ranks_b and errs_a == errs_b
    assert ta.Iset == tb.Iset and ta.Jset == tb.Jset
    assert ta.pivoterrors == tb.pivoterrors
    assert ta.maxsamplevalue == tb.maxsamplevalue
    for x, y in zip(ta.sitetensors(), tb.sitetensors()):
        assert x.device.type == "cuda" and torch.equal(x, y)


@pytest.mark.parametrize("capture_at", [1, 2])
@pytest.mark.parametrize("problem", ["4^5", "R12"])
def test_graph_matches_eager_bitwise(cuda, problem, capture_at):
    """crossinterpolate2 with the engine's sweeps replayed from CUDA graphs
    against the same sweeps queued eagerly: index sets, ranks, error series
    and every site tensor bit for bit, on a fresh evaluator and again on the
    same one, where nothing is captured any more; every launch counted."""
    dims, f, tol = _graph_problem(problem, cuda)

    def solve(bf):
        calls = bf.device_sweep_engine.rrlu_calls
        launches = lu_cuda.LAUNCHES["rrlu"]
        plain = lu_kernel.PLAIN_CALLS["cuda"]
        out = tci_tpu_torch.crossinterpolate2(
            np.float64, bf, dims, tolerance=tol, device=cuda,
            rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        assert (lu_cuda.LAUNCHES["rrlu"] - launches
                == bf.device_sweep_engine.rrlu_calls - calls > 0)
        assert lu_kernel.PLAIN_CALLS["cuda"] == plain
        return out

    eager = tci_tpu_torch.TorchBatchEvaluator(f, dims, device=cuda,
                                              cuda_graphs=False)
    ref = solve(eager)
    assert eager.device_sweep_engine.captures == 0
    bf = tci_tpu_torch.TorchBatchEvaluator(f, dims, device=cuda)
    engine = bf.device_sweep_engine
    engine.capture_at = capture_at
    first = solve(bf)
    _same_result(first, ref)
    assert engine.captures > 0 and engine.replays > 0 and not engine.declined
    held = [t.clone() for t in first[0].sitetensors()]
    captures, replays = engine.captures, engine.replays
    second = solve(bf)
    _same_result(second, ref)
    if capture_at == 1:
        assert engine.captures == captures
        assert all(p["captured"] and p["replays"] == p["uses"]
                   for p in engine.programs())
    assert engine.replays > replays
    # the first result's site tensors are not the graphs' storage
    for t, h in zip(first[0].sitetensors(), held):
        assert torch.equal(t, h)
    assert engine.graph_pool_bytes() > 0


@pytest.mark.parametrize("N", [96, 160, 1024, 2048])
def test_captured_launch_replays_bitwise(cuda, N):
    """One call of the kernel recorded into a CUDA graph (96^2: the resident
    mode; 160^2: the cluster launch; 1024^2: the cluster launch and then the
    cooperative launch of the grid mode, in one graph; 2048^2: the cluster
    launch and both grid instantiations' cooperative launches) and replayed
    20 times against one plain result; the sizes are read from the device
    at each replay, so smaller true extents move the panel from the grid
    mode to the cluster mode (1024^2), or from the streamed regime to the
    grid-resident one and to the cluster mode (2048^2), within the same
    graph; a replay counts as a launch."""
    from tci_tpu_torch.utils.device import capture_graph

    A = _panel(N, N, N, N - 3, N - 5, 40, torch.float64, cuda)[None]
    m = torch.tensor([N - 3], dtype=torch.int32, device=cuda)
    n = torch.tensor([N - 5], dtype=torch.int32, device=cuda)
    cap = torch.tensor([N], dtype=torch.int32, device=cuda)
    rt = torch.tensor([1e-12], dtype=torch.float64, device=cuda)
    at = torch.tensor([0.0], dtype=torch.float64, device=cuda)
    lu_cuda.warm_up(torch.cuda.current_device(), torch.float64)
    expected = {96: ("resident", 0), 160: ("cluster", 1),
                1024: ("cluster+grid", 2), 2048: ("cluster+grid", 3)}[N]
    assert lu_cuda.host_mode(torch.cuda.current_device(), N, N,
                             torch.float64) == expected[0]
    ref = lu_kernel.rrlu_plain_batched(A, m, n, cap, rt, at,
                                       leftorthogonal=True)
    launches, captured = lu_cuda.LAUNCHES["rrlu"], lu_cuda.CAPTURED["rrlu"]
    graph, out = capture_graph(
        lambda: lu_cuda.rrlu_batched(A, m, n, cap, rt, at,
                                     leftorthogonal=True, return_mode=True),
        torch.cuda.graph_pool_handle(), torch.cuda.Stream(cuda))
    assert lu_cuda.CAPTURED["rrlu"] == captured + 1
    assert lu_cuda.LAUNCHES["rrlu"] == launches
    for _ in range(20):
        for o in out:
            o.fill_(3)
        graph.replay()
        lu_cuda.count_replay(1)
        torch.cuda.synchronize()
        for o, r in zip(out, ref):
            assert _equal(o, r)
        assert out[6].tolist() == [expected[1]]
    assert lu_cuda.LAUNCHES["rrlu"] == launches + 20
    cap.fill_(5)
    graph.replay()
    torch.cuda.synchronize()
    assert int(out[3][0]) == 5
    ref5 = lu_kernel.rrlu_plain_batched(A, m, n, cap, rt, at,
                                        leftorthogonal=True)
    for o, r in zip(out, ref5):
        assert _equal(o, r)
    # true rows that fit the grid's shared memory (2048^2: 1000 rows), and
    # a cluster (1024^2: 200, 2048^2: 100): the same graph, another kernel
    for rows, mode in {1024: ((200, 1),),
                       2048: ((1000, 2), (100, 1))}.get(N, ()):
        m.fill_(rows)
        graph.replay()
        torch.cuda.synchronize()
        ref_rows = lu_kernel.rrlu_plain_batched(A, m, n, cap, rt, at,
                                                leftorthogonal=True)
        for o, r in zip(out, ref_rows):
            assert _equal(o, r)
        assert out[6].tolist() == [mode]


def test_replayed_program_follows_abstol_and_maxbonddim(cuda):
    """One 2-site sweep program replayed with two abstol / maxbonddim pairs
    gives what the eager body gives for each: nothing is baked in."""
    dims = [10] * 6
    empty = [[] for _ in dims]
    states = {}
    for graphs in (False, True):
        bf = tci_tpu_torch.TorchBatchEvaluator(_lorentz, dims, device=cuda,
                                               cuda_graphs=graphs)
        tci = tci_tpu_torch.TensorCI2.from_function(bf, dims, device=cuda)
        engine = bf.device_sweep_engine
        seen = []
        for abstol, maxbonddim in ((1e-3, 2), (1e-12, 2 ** 62), (1e-6, 5)):
            tci.flushpivoterror()
            assert engine.sweep2site(tci, True, 1e-14, abstol, maxbonddim,
                                     empty, empty)
            seen.append(([list(s) for s in tci.Iset],
                         [list(s) for s in tci.Jset], list(tci.pivoterrors)))
        states[graphs] = seen
        assert engine.captures == int(graphs)
        assert engine.replays == (3 if graphs else 0)
    assert states[True] == states[False]
    assert max(len(s) for s in states[True][0][0]) == 2
    assert max(len(s) for s in states[True][1][0]) > 5


def test_failed_capture_runs_eagerly_on_the_card(cuda, capsys):
    """An f that reads a device value cannot be recorded: the capture
    fails, the engine runs that key eagerly on the card through the kernel,
    says so once, and keeps the reasons; the device stays usable."""
    dims = [4] * 5

    def f(idx):
        if torch.cuda.is_current_stream_capturing():
            idx.sum().item()
        return _lorentz(idx)

    def solve(bf):
        return tci_tpu_torch.crossinterpolate2(
            np.float64, bf, dims, tolerance=1e-10, device=cuda,
            rng=np.random.default_rng(0))

    ref = solve(tci_tpu_torch.TorchBatchEvaluator(_lorentz, dims, device=cuda,
                                                  cuda_graphs=False))
    bf = tci_tpu_torch.TorchBatchEvaluator(f, dims, device=cuda)
    launches, plain = lu_cuda.LAUNCHES["rrlu"], lu_kernel.PLAIN_CALLS["cuda"]
    out = solve(bf)
    torch.cuda.synchronize()
    engine = bf.device_sweep_engine
    _same_result(out, ref)
    assert engine.captures == 0 and engine.replays == 0
    assert set(engine.declined) == set(engine._sweeps)
    assert lu_cuda.LAUNCHES["rrlu"] - launches == engine.rrlu_calls > 0
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    assert capsys.readouterr().err.count("runs it eagerly") == 1
    # a capture still works afterwards
    good = tci_tpu_torch.TorchBatchEvaluator(_lorentz, dims, device=cuda)
    _same_result(solve(good), ref)
    assert good.device_sweep_engine.captures > 0
    assert not good.device_sweep_engine.declined


def test_integrate_reuses_its_graphs(cuda):
    """A second integrate(torch_native=True) on the same f only replays:
    no new capture, the same integral bit for bit."""
    from tci_tpu_torch.models import integration

    def f(X):
        return torch.cos(X.sum(dim=1)) * torch.exp(-(X ** 2).sum(dim=1))

    def run():
        return tci_tpu_torch.integrate(
            np.float64, f, [0.0] * 4, [1.0] * 4, GKorder=7, tolerance=1e-9,
            torch_native=True, rng=np.random.default_rng(0))

    first = run()
    F, = integration._GK_EVAL_CACHE[f].values()
    engine = F.device_sweep_engine
    captures, replays = engine.captures, engine.replays
    assert captures > 0 and not engine.declined
    assert run() == first
    assert engine.captures == captures and engine.replays == 2 * replays


def _protocol_run(f, dims, tol, device, pair, loop, graphs=True, bf=None):
    """crossinterpolate2 under one protocol of the engine (the default: the
    pair and the loop on), on a new evaluator or on `bf`, with the launches
    it made checked against the engine's rrLU calls."""
    if bf is None:
        bf = tci_tpu_torch.TorchBatchEvaluator(f, dims, device=device,
                                               cuda_graphs=graphs)
    engine = bf.device_sweep_engine
    engine.use_sweep_pair, engine.use_optimize_loop = pair, loop
    bf.reset_nevals()
    calls, launches = engine.rrlu_calls, lu_cuda.LAUNCHES["rrlu"]
    plain = lu_kernel.PLAIN_CALLS["cuda"]
    out = tci_tpu_torch.crossinterpolate2(
        np.float64, bf, dims, tolerance=tol, device=device,
        rng=np.random.default_rng(0))
    torch.cuda.synchronize()
    assert (lu_cuda.LAUNCHES["rrlu"] - launches
            == engine.rrlu_calls - calls > 0)
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    assert not engine.declined
    return out, bf


@pytest.mark.parametrize("problem", ["4^5", "R12"])
def test_loop_and_pair_match_per_sweep_protocol(cuda, problem):
    """crossinterpolate2 under the default protocol (optimize loop), the
    sweep pair alone and the per-sweep protocol on the card: index sets,
    their history, ranks, error series, every site tensor and the sample
    count bit for bit."""
    dims, f, tol = _graph_problem(problem, cuda)
    runs = [_protocol_run(f, dims, tol, cuda, pair, loop)
            for pair, loop in ((True, True), (True, False), (False, False))]
    (ref, ref_bf), others = runs[-1], runs[:-1]
    for out, bf in others:
        _same_result(out, ref)
        assert out[0].Iset_history == ref[0].Iset_history
        assert out[0].Jset_history == ref[0].Jset_history
        assert bf.nevals == ref_bf.nevals
    loop_engine = runs[0][1].device_sweep_engine
    assert loop_engine.loop_blocks >= 1
    assert {key[0] for key in loop_engine._sweeps} == {"oloop", "sweep1"}
    assert any(key[3] == "pair_full"
               for key in runs[1][1].device_sweep_engine._sweeps)


@pytest.mark.parametrize("pair_only", [False, True])
@pytest.mark.parametrize("problem", ["4^5", "R12"])
def test_pair_and_loop_graphs_match_eager(cuda, problem, pair_only):
    """The sweep pair's and the loop step's programs replayed from CUDA
    graphs against the same bodies queued eagerly, on a new evaluator (the
    first use records) and again on the same one (every use replays): bit
    for bit."""
    dims, f, tol = _graph_problem(problem, cuda)
    loop = not pair_only
    ref, _ = _protocol_run(f, dims, tol, cuda, True, loop, graphs=False)
    first, bf = _protocol_run(f, dims, tol, cuda, True, loop)
    _same_result(first, ref)
    engine = bf.device_sweep_engine
    captures, replays = engine.captures, engine.replays
    assert captures > 0 and replays > 0
    second, _ = _protocol_run(f, dims, tol, cuda, True, loop, bf=bf)
    _same_result(second, ref)
    assert engine.captures == captures and engine.replays == 2 * replays
    kind = "pair_full" if pair_only else "oloop"
    assert any(kind in key and p["captured"] and p["replays"] == p["uses"]
               for key, p in ((p["key"], p) for p in engine.programs()))


def test_loop_block_syncs_only_at_status_reads_and_fetch(cuda):
    """One block of the optimize loop at config 1's widths, its step
    replayed from a graph: torch's sync debug mode sees no synchronization;
    the host waits only at a status read a step and the block's one fetch
    (waits on events, counted in FETCHES)."""
    from tci_tpu_torch.models.globalpivotfinder import (
        DefaultGlobalPivotFinder)
    from tci_tpu_torch.utils.device import FETCHES

    dims = [10] * 8
    bf = tci_tpu_torch.TorchBatchEvaluator(_lorentz, dims, device=cuda)
    # records the loop's step (the end of a capture synchronizes)
    _protocol_run(_lorentz, dims, 1e-8, cuda, True, True, bf=bf)
    engine = bf.device_sweep_engine
    captures = engine.captures
    tci = tci_tpu_torch.TensorCI2.from_function(bf, dims, device=cuda)
    maxsample = tci.maxsamplevalue
    finder = DefaultGlobalPivotFinder()
    rng = np.random.default_rng(0)
    starts = np.asarray([finder.draw_starts(dims, rng) for _ in range(20)])
    empty = [[] for _ in dims]
    fetches, status = FETCHES["engine"], FETCHES["engine_status"]
    steps, launches = engine.loop_steps, lu_cuda.LAUNCHES["rrlu"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = engine.optimize_loop(
            tci, True, False, 1e-14, 1e-8, True, 2**62, empty, empty, False,
            starts, 10.0, [], [], [], 3, True, 20)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert res["code"] == 0 and res["k"] == engine.loop_steps - steps >= 3
    assert FETCHES["engine_status"] - status == res["k"]
    assert FETCHES["engine"] - fetches == 1
    assert engine.captures == captures
    assert (lu_cuda.LAUNCHES["rrlu"] - launches
            == res["k"] * (2 * (len(dims) - 1) + 1))
    assert float(res["ms"][0]) >= maxsample
    assert res["cores"].device.type == "cuda"


def _config_tt(dims, f, tol, device, maxbonddim=2**62):
    bf = tci_tpu_torch.TorchBatchEvaluator(f, dims, device=device)
    tci, _, _ = tci_tpu_torch.crossinterpolate2(
        np.float64, bf, dims, tolerance=tol, maxbonddim=maxbonddim,
        device=device, rng=np.random.default_rng(0))
    return tci, bf


@pytest.mark.parametrize("method", ["LU", "CI"])
def test_compress_launches_the_kernel_per_factorize(cuda, method, monkeypatch):
    """compress of a TT on the card: one kernel launch per factorize call,
    2 (L - 1) of them, none a plain call; the train keeps its values."""
    from tci_tpu_torch.models import tensortrain

    tci, _ = _config_tt([4] * 5, _lorentz, 1e-10, cuda)
    tt = tci_tpu_torch.tensortrain(tci)
    calls = [0]
    factorize = tensortrain.factorize

    def counting(*args, **kwargs):
        calls[0] += 1
        return factorize(*args, **kwargs)

    monkeypatch.setattr(tensortrain, "factorize", counting)
    launches = lu_cuda.LAUNCHES["rrlu"]
    plain = lu_kernel.PLAIN_CALLS["cuda"]
    c = tt.copy()
    c.compress(method, tolerance=1e-12)
    torch.cuda.synchronize()
    assert calls[0] == 2 * (len(tt) - 1)
    assert lu_cuda.LAUNCHES["rrlu"] - launches == calls[0]
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    assert all(a <= b for a, b in zip(c.linkdims(), tt.linkdims()))
    assert all(t.device.type == "cuda" for t in c.sitetensors())
    full, ref = tci_tpu_torch.fulltensor(c), tci_tpu_torch.fulltensor(tt)
    assert float((full - ref).abs().max()) <= 1e-10 * float(ref.abs().max())


@pytest.mark.parametrize("problem", ["4^5", "R12"])
def test_floatingzone_graph_matches_eager_bitwise(cuda, problem):
    """The floating-zone program replayed from its CUDA graph against its
    body queued eagerly, and against the host lock-step search on the card:
    pivots and errors bit for bit; one status read a sweep, one fetch."""
    from tci_tpu_torch.models.globalsearch import _floatingzone_batch
    from tci_tpu_torch.utils.device import FETCHES

    dims, f, tol = _graph_problem(problem, cuda)
    tci, bf = _config_tt(dims, f, tol, cuda, maxbonddim=3)
    tt = tci_tpu_torch.tensortrain(tci)
    starts = np.random.default_rng(1).integers(0, dims[0], (20, len(dims)))
    engine = bf.device_sweep_engine
    engine.cuda_graphs = False
    eager = engine.floatingzone(tt.sitetensors(), starts)
    engine.cuda_graphs = True
    captures = engine.captures
    reads, fetches = FETCHES["engine_status"], FETCHES["engine"]
    graph = engine.floatingzone(tt.sitetensors(), starts)
    again = engine.floatingzone(tt.sitetensors(), starts)
    key = [p for p in engine.programs() if p["key"][0] == "fzone"][0]
    assert engine.captures == captures + 1 and key["captured"]
    assert key["replays"] >= 2 and not engine.declined
    assert FETCHES["engine"] - fetches == 2
    assert FETCHES["engine_status"] - reads == key["replays"]
    for out in (graph, again):
        assert np.array_equal(out[0], eager[0])
        assert np.array_equal(out[1], eager[1])
    host = _floatingzone_batch(tt, bf, [tuple(p) for p in starts])
    assert [tuple(p) for p in eager[0].tolist()] == [p for p, _ in host]
    assert eager[1].tolist() == [e for _, e in host]


def test_caches_land_on_the_card(cuda):
    """TTCache of a TT on the card and CachedFunction with no device
    argument: their values are CUDA tensors, equal to the TT's / f's."""
    dims = [4] * 5
    tci, _ = _config_tt(dims, _lorentz, 1e-10, cuda)
    tt = tci_tpu_torch.tensortrain(tci)
    cache = tci_tpu_torch.TTCache(tt)
    for b in range(len(dims)):
        panel = cache.batch_evaluate(tci.Iset[b], tci.Jset[b], 1)
        assert panel.device.type == "cuda"
        rows = [tuple(I) + (s,) + tuple(J) for I in tci.Iset[b]
                for s in range(dims[b]) for J in tci.Jset[b]]
        ref = tt.evaluate_batch(rows).reshape(panel.shape)
        assert float((panel - ref).abs().max()) <= 1e-13 * float(
            ref.abs().max())
    numpy_cache = tci_tpu_torch.TTCache([t.cpu().numpy()
                                         for t in tt.sitetensors()])
    assert numpy_cache.device.type == "cuda"

    def g(x):
        v = np.asarray(x, dtype=float) + 1.0
        return 1.0 / (1.0 + v @ v)

    cf = tci_tpu_torch.CachedFunction(g, dims)
    assert cf.device.type == "cuda"
    panel = cf.batch_evaluate([(0, 1)], [(2, 3)], 1)
    assert panel.device.type == "cuda"
    assert torch.equal(panel.cpu().reshape(-1), torch.tensor(
        [g((0, 1, s, 2, 3)) for s in range(4)], dtype=torch.float64))
    out = tci_tpu_torch.estimatetrueerror([t.cpu().numpy()
                                           for t in tt.sitetensors()], g,
                                          nsearch=4,
                                          rng=np.random.default_rng(0))
    assert len(out) > 0


# -- complex128 (bitwise: the kernel and the plain version compute complex
#    products, Smith quotients and |z|^2 by the same formulas on the real
#    and imaginary parts)

def _cpanel(seed, mp, npd, m, n, rank, device):
    rng = np.random.default_rng(seed)

    def g(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    A = np.zeros((mp, npd), np.complex128)
    A[:m, :n] = g(m, rank) @ g(rank, n)
    return torch.from_numpy(A).to(device)


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("shape", [
    # (mp, np, m, n, rank): resident complex panels up to 128 KB ...
    (8, 8, 8, 5, 4), (32, 32, 30, 28, 12), (80, 80, 77, 80, 30),
    (128, 64, 120, 60, 25), (64, 16, 60, 10, 16),
    # ... larger from just above (96^2 complex is 144 KB): in a cluster up
    # to config 5's 512^2 bond panels, on the grid beyond
    (96, 96, 90, 96, 20), (128, 128, 120, 117, 30),
    (512, 512, 480, 500, 40), (1024, 1024, 1000, 990, 100)])
def test_complex_kernel_matches_plain(cuda, shape, leftorthogonal):
    mp, npd, m, n, rank = shape
    A = _cpanel(1, mp, npd, m, n, rank, cuda)
    resident = mp * npd * 16 <= 128 * 128 * 8
    assert (lu_cuda.host_mode(A.device.index, mp, npd, torch.complex128)
            == "resident") == resident
    for reltol, abstol in ((1e-10, 0.0), (1e-14, 1e-3)):
        args = (A, m, n, min(m, n), reltol, abstol)
        out = lu_cuda.rrlu_call(*args, leftorthogonal=leftorthogonal,
                                return_mode=True)
        ref = lu_kernel.rrlu_plain(*args, leftorthogonal=leftorthogonal)
        torch.cuda.synchronize()
        assert out[0].dtype == torch.complex128
        assert out[4].dtype == out[5].dtype == torch.float64
        for o, r in zip(out, ref):
            assert _equal(o, r)
        assert int(out[6]) == (0 if resident else 1 if mp < 512 else 2)


@pytest.mark.parametrize("size", [32, 512])
def test_complex_batched_matches_plain(cuda, size):
    """Four complex panels in one call (32^2: resident, the engine's fill
    blocks; 512^2: the grid mode, since 509 to 512 complex rows of 8 KB fit
    no cluster), per-panel extents, rank caps and tolerances on the
    card."""
    A = torch.stack([_cpanel(s, size, size, size - s, size, size // 4, cuda)
                     for s in range(4)])
    mt = torch.tensor([size, size - 1, size - 2, size - 3], device=cuda)
    nt = torch.tensor([size, size, size // 2, size], device=cuda)
    mr = torch.tensor([size, 3, size // 2, size - 3], device=cuda)
    rt = torch.tensor([1e-12, 0.0, 1e-3, 1e-14], dtype=torch.float64,
                      device=cuda)
    at = torch.tensor([0.0, 0.0, 0.0, 1e-2], dtype=torch.float64,
                      device=cuda)
    for leftorthogonal in (True, False):
        out = lu_cuda.rrlu_batched(A, mt, nt, mr, rt, at,
                                   leftorthogonal=leftorthogonal,
                                   return_mode=True)
        ref = lu_kernel.rrlu_plain_batched(A, mt, nt, mr, rt, at,
                                           leftorthogonal=leftorthogonal)
        for o, r in zip(out, ref):
            assert _equal(o, r)
        assert out[6].tolist() == [0 if size == 32 else 2] * 4


def test_rrlu_kernel_rejects_other_element_types(cuda):
    """An element size or dtype the kernel has no body for is refused, never
    launched as another type."""
    assert lu_cuda._lib().rrlu_scratch_bytes(256, 256, 2, 0) < 0
    assert lu_cuda._lib().rrlu_host_mode(256, 256, 2, 16) < 0
    for dtype in (torch.complex64, torch.float16):
        with pytest.raises(TypeError):
            lu_cuda.rrlu_call(torch.zeros((8, 8), dtype=dtype, device=cuda),
                              8, 8, 8, 0.0, 0.0, leftorthogonal=True)


def _feynman(N, GK, device):
    """BASELINE config 5's integrand (benchmarks/bench_feynman.py) on a
    GK grid over [0, 1]: a torch function of index rows on `device`, its
    numpy twin, the local dimensions and the normalization."""
    from tci_tpu_torch.ops.kronrod import kronrod

    x, w, _ = kronrod(GK // 2)
    nodes, weights = (x + 1) / 2, w / 2
    norm = float(GK) ** N
    nt = torch.as_tensor(nodes, device=device)
    wt = torch.as_tensor(weights, device=device)

    def ft(idx):
        t = nt[idx]
        damp = torch.exp(-((t[:, :, None] - t[:, None, :]) ** 2).sum((1, 2)))
        return torch.polar(wt[idx].prod(1) * damp * norm, 10.0 * t.sum(1))

    def fn(idx):
        t = nodes[idx]
        damp = np.exp(-np.sum((t[:, :, None] - t[:, None, :]) ** 2,
                              axis=(1, 2)))
        return (np.prod(weights[idx], axis=1) * damp * norm
                * np.exp(1j * 10.0 * np.sum(t, axis=1)))

    return ft, fn, [len(x)] * N, norm


def test_complex_engine_on_the_card_matches_host_tier(cuda):
    """Config 5's integrand at N = 4, GK7 on the engine (default protocol,
    graphs) and on the host tier (a numpy integrand), both on the card:
    ranks [12, 11, 11] on both, integrals within 1e-12, every elimination
    a complex launch of the kernel, no plain call."""
    ft, fn, dims, norm = _feynman(4, 7, cuda)
    launches, plain = lu_cuda.LAUNCHES["rrlu"], lu_kernel.PLAIN_CALLS["cuda"]
    bf = tci_tpu_torch.TorchBatchEvaluator(ft, dims, dtype=torch.complex128)
    runs = [tci_tpu_torch.crossinterpolate2(
        np.complex128, f, dims, tolerance=1e-7, nsearchglobalpivot=10,
        rng=np.random.default_rng(0))
        for f in (bf, tci_tpu_torch.VectorizedBatchEvaluator(
            fn, dims, dtype=np.complex128))]
    assert lu_cuda.LAUNCHES["rrlu"] > launches
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    engine = bf.device_sweep_engine
    assert engine.loop_blocks > 0 and not engine.declined
    (te, re_, ee), (th, rh, eh) = runs
    assert re_ == rh == [12, 11, 11]
    assert te.sitetensors()[0].dtype == torch.complex128
    assert abs(te.sum() - th.sum()) / norm <= 1e-12
    # the floating-zone program on the complex train: replayed against
    # its eager body, bit for bit
    tt = tci_tpu_torch.tensortrain(te)
    starts = np.random.default_rng(1).integers(0, dims[0], (20, len(dims)))
    engine.cuda_graphs = False
    eager = engine.floatingzone(tt.sitetensors(), starts)
    engine.cuda_graphs = True
    graph = engine.floatingzone(tt.sitetensors(), starts)
    graph = engine.floatingzone(tt.sitetensors(), starts)
    assert np.array_equal(graph[0], eager[0])
    assert np.array_equal(graph[1], eager[1])


# -- rook pivoting (ops/lu_device.py, the engine's rook sweeps) -------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [
    # (mp, np, m, n, rank): config 2's rook slabs (4096 x 256 column and
    # 256 x 4096 row slabs; the f32 hunt's too) and its 256^2 pivot block;
    # config 1's engine slabs (Icap x Imax and Imax x Jcap at Imax = 32)
    (4096, 256, 4096, 256, 256), (256, 4096, 256, 4096, 256),
    (256, 256, 256, 256, 256), (352, 32, 132, 32, 32),
    (32, 352, 32, 132, 32)])
def test_rook_slab_shapes_match_plain(cuda, shape, dtype):
    """The rook slab shapes of chip_smoke.py's phases 3d and 4h, with their
    extents on the card as the alternation hands them over: kernel and
    plain version bitwise."""
    mp, npd, m, n, rank = shape
    A = _panel(5, mp, npd, m, n, rank, dtype, cuda)
    ext = [torch.tensor([v], device=cuda) for v in (m, n, min(m, n))]
    args = (A[None], *ext, 1e-10, 0.0)
    out = lu_cuda.rrlu_batched(*args, leftorthogonal=True)
    ref = lu_kernel.rrlu_plain_batched(*args, leftorthogonal=True)
    for o, r in zip(out, ref):
        assert _equal(o, r)
    # a dead predicated step: the rank cap 0 leaves the panel unpivoted
    dead = lu_cuda.rrlu_batched(A[None], ext[0], ext[1],
                                torch.zeros(1, dtype=torch.int64,
                                            device=cuda),
                                1e-10, 0.0, leftorthogonal=True)
    assert int(dead[3][0]) == 0


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_rrlu_rook_on_the_card_matches_cpu(cuda, precision):
    """rrlu(pivotsearch="rook") on the card: every slab launches the kernel
    (none takes the plain version), one fetch of the record, and the same
    pivots, npivot and factors as on the CPU (bitwise: the kernel rounds as
    the plain version, the completion's products to 1e-12)."""
    from tci_tpu_torch.utils.device import FETCHES

    rng = np.random.default_rng(3)
    # rank 80 > maxrank 48: no hunt reaches its precision's noise, where
    # cuBLAS's and the CPU's rounding of the deflated residual would part
    A = (rng.standard_normal((300, 80)) * np.exp(-np.arange(80) / 8.0)) \
        @ rng.standard_normal((80, 240))
    kw = dict(maxrank=48, reltol=1e-12, pivotsearch="rook",
              precision=precision)
    launches = lu_cuda.LAUNCHES["rrlu"]
    plain = lu_kernel.PLAIN_CALLS["cuda"]
    FETCHES.clear()
    lu = tci_tpu_torch.rrlu(A, rng=np.random.default_rng(7), device=cuda,
                            **kw)
    assert lu.L.device.type == "cuda"
    stages = 2 if precision == "mixed" else 1
    # per alternation 5 steps and the final row slab; mixed: one f64 block
    # elimination a completion (hunt_stages of them)
    expect = stages * 6 + (stages if precision == "mixed" else 0)
    assert lu_cuda.LAUNCHES["rrlu"] - launches == expect
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    assert FETCHES["rook"] == 1
    ref = tci_tpu_torch.rrlu(A, rng=np.random.default_rng(7), device="cpu",
                             **kw)
    assert lu.npivot == ref.npivot == 48
    assert (lu.rowpermutation == ref.rowpermutation).all()
    assert (lu.colpermutation == ref.colpermutation).all()
    for x, y in ((lu.L, ref.L), (lu.U, ref.U)):
        assert float((x.cpu() - y).abs().max()) <= 1e-12 * float(
            y.abs().max())


def test_rook_engine_sweep_syncs_only_at_its_fetch(cuda):
    """One rook engine sweep with its fill at config 1's widths, replayed:
    no synchronization in sync debug mode "error", one fetch, 7 bonds of 5
    predicated slab launches and the fill's."""
    from tci_tpu_torch.models import device_sweep

    dims = [10] * 8
    bf = tci_tpu_torch.TorchBatchEvaluator(_lorentz, dims, device=cuda)
    tci = tci_tpu_torch.TensorCI2.from_function(bf, dims, device=cuda)
    engine = bf.device_sweep_engine
    engine._rng = np.random.default_rng(3)
    empty = [[] for _ in dims]
    for fwd, fill in ((True, False), (False, True), (True, False)):
        assert engine.sweep2site(tci, fwd, 1e-14, 0.0, 2**62, empty, empty,
                                 pivotsearch="rook", fill_sites=fill)
    torch.cuda.synchronize()
    assert engine.captures == 2 and not engine.declined
    fetches, launches = device_sweep.FETCHES["engine"], lu_cuda.LAUNCHES["rrlu"]
    plain = lu_kernel.PLAIN_CALLS["cuda"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert engine.sweep2site(tci, False, 1e-14, 0.0, 2**62, empty, empty,
                                 pivotsearch="rook", fill_sites=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert device_sweep.FETCHES["engine"] == fetches + 1
    assert lu_cuda.LAUNCHES["rrlu"] == launches + 5 * (len(dims) - 1) + 1
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    assert all(t.device.type == "cuda" for t in tci.sitetensors())


def _rook_loop_run(dims, cuda, graphs, bf=None):
    if bf is None:
        bf = tci_tpu_torch.TorchBatchEvaluator(_lorentz, dims, device=cuda,
                                               cuda_graphs=graphs)
    bf.device_sweep_engine._rng = np.random.default_rng(7)
    out = tci_tpu_torch.crossinterpolate2(
        np.float64, bf, dims, tolerance=1e-10, pivotsearch="rook",
        device=cuda, rng=np.random.default_rng(5))
    torch.cuda.synchronize()
    return out, bf


def test_rook_loop_graphs_match_eager(cuda):
    """The rook optimize loop (tci_tpu's default protocol) replayed from CUDA
    graphs against the same bodies queued eagerly, on a new evaluator and
    again on the same one: bit for bit, and the same sample count."""
    dims = [4] * 5
    ref, ref_bf = _rook_loop_run(dims, cuda, graphs=False)
    first, bf = _rook_loop_run(dims, cuda, graphs=True)
    _same_result(first, ref)
    assert bf.nevals == ref_bf.nevals
    engine = bf.device_sweep_engine
    captures, replays = engine.captures, engine.replays
    assert captures > 0 and replays > 0 and not engine.declined
    assert any("rook" in key for key in engine._sweeps)
    bf.reset_nevals()
    second, _ = _rook_loop_run(dims, cuda, graphs=True, bf=bf)
    _same_result(second, ref)
    assert engine.captures == captures and engine.replays == 2 * replays
    assert bf.nevals == ref_bf.nevals


# -- contraction and the device compression ------------------------------


def _contract_operands(L, chi, complex_=False, seed=42):
    """Two MPOs of L sites, legs (2, 2), N(0, 1)/sqrt(chi) cores, as numpy."""
    rng = np.random.default_rng(seed)

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


def _device_tier(kind, cores_a, cores_b, device):
    """One call of a device tier on trains on `device`: (result, the number
    of bond splits it makes, its FETCHES key)."""
    A = tci_tpu_torch.TensorTrain(cores_a, device=device)
    L = len(A)
    if kind == "compress":
        out = tci_tpu_torch.compress_device(A, "LU", tolerance=1e-10,
                                            maxbonddim=6)
        return out, 2 * (L - 1), "compress"
    B = tci_tpu_torch.TensorTrain(cores_b, device=device)
    out = tci_tpu_torch.contract(A, B, algorithm=kind, method="LU",
                                 tolerance=1e-10, torch_native=True)
    return out, (L - 1) * (2 if kind == "naive" else 1), "contract_" + kind


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("kind", ["zipup", "naive", "compress"])
def test_contract_device_tiers_on_the_card(cuda, kind, complex_):
    """zip-up, naive and the compression with torch_native=True on the
    card: one kernel launch a bond split, no plain call on CUDA, one fetch,
    and the same train as the call on the CPU (plain version) within
    1e-12."""
    from tci_tpu_torch.utils.device import FETCHES

    a, b = _contract_operands(6, 4, complex_)
    launches = lu_cuda.LAUNCHES["rrlu"]
    plain = lu_kernel.PLAIN_CALLS["cuda"]
    out, splits, key = _device_tier(kind, a, b, cuda)
    fetches = FETCHES[key]
    out, splits, key = _device_tier(kind, a, b, cuda)
    assert FETCHES[key] == fetches + 1
    assert lu_cuda.LAUNCHES["rrlu"] - launches == 2 * splits
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    assert all(t.device.type == "cuda" for t in out)
    ref, _, _ = _device_tier(kind, a, b, "cpu")
    assert out.linkdims() == ref.linkdims()
    full, want = tci_tpu_torch.fulltensor(out).cpu(), tci_tpu_torch.fulltensor(ref)
    assert float((full - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("kind", ["zipup", "naive", "compress"])
def test_contract_chain_syncs_only_at_its_fetch(cuda, kind):
    """The whole chain of a device tier queues without a synchronization:
    under torch's sync debug mode "error" from the call to its end (the one
    fetch waits on an event, which the mode does not see, and is counted)."""
    from tci_tpu_torch.utils.device import FETCHES

    a, b = _contract_operands(8, 8)
    _device_tier(kind, a, b, cuda)  # the kernel's build and first launches
    A = tci_tpu_torch.TensorTrain(a, device=cuda)
    B = tci_tpu_torch.TensorTrain(b, device=cuda)
    torch.cuda.synchronize()
    key = "compress" if kind == "compress" else "contract_" + kind
    fetches = FETCHES[key]
    torch.cuda.set_sync_debug_mode("error")
    try:
        if kind == "compress":
            out = tci_tpu_torch.compress_device(A, "LU", tolerance=1e-10)
        else:
            out = tci_tpu_torch.contract(A, B, algorithm=kind, method="LU",
                                         tolerance=1e-10, torch_native=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert FETCHES[key] == fetches + 1
    assert all(t.device.type == "cuda" for t in out)


def test_contract_tci_on_the_engine(cuda):
    """contract(algorithm="TCI", torch_native=True) on the card: TCI2 on the
    engine over the product evaluator, recorded into its CUDA graphs
    without a decline; the exact product's ranks and values."""
    import tci_tpu_torch.parallel.batcheval as batcheval

    a, b = _contract_operands(6, 2)
    made = []
    init = batcheval.TorchBatchEvaluator.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    batcheval.TorchBatchEvaluator.__init__ = keep
    try:
        A = tci_tpu_torch.TensorTrain(a, device=cuda)
        B = tci_tpu_torch.TensorTrain(b, device=cuda)
        plain = lu_kernel.PLAIN_CALLS["cuda"]
        out = tci_tpu_torch.contract(A, B, algorithm="TCI", tolerance=1e-10,
                                     torch_native=True,
                                     rng=np.random.default_rng(0))
    finally:
        batcheval.TorchBatchEvaluator.__init__ = init
    engine = made[0].device_sweep_engine
    assert engine.captures > 0 and not engine.declined
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    assert out.linkdims() == [4, 4, 4, 4, 4]
    exact = tci_tpu_torch.contract(A, B, algorithm="naive")
    full, want = tci_tpu_torch.fulltensor(out), tci_tpu_torch.fulltensor(exact)
    assert float((full - want).abs().max()) <= 1e-10 * float(want.abs().max())


def test_capture_out_of_memory_retries_in_a_new_pool(cuda, monkeypatch):
    """A capture that runs out of memory (the memory held by the cached
    segments of pools whose engines are gone, which the allocator cannot
    give back while a stream captures) releases the cache and records once
    more into a new pool: no key declined, the launches a graph holds
    counted once, and the result the eager one's bit for bit."""
    from tci_tpu_torch.models import device_sweep

    pools = []
    capture = device_sweep.capture_graph

    def short_of_memory_once(body, pool, stream):
        pools.append(pool)
        if len(pools) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (stand-in)")
        return capture(body, pool, stream)

    dims = [4] * 5
    ref, _ = _rook_loop_run(dims, cuda, graphs=False)
    _, clean = _rook_loop_run(dims, cuda, graphs=True)
    monkeypatch.setattr(device_sweep, "capture_graph", short_of_memory_once)
    out, bf = _rook_loop_run(dims, cuda, graphs=True)
    engine = bf.device_sweep_engine
    assert len(pools) > 2 and pools[0] is not pools[1]
    assert not engine.declined and engine.captures == len(pools) - 1
    _same_result(out, ref)
    launches = {p["key"]: p["captured_launches"]
                for p in clean.device_sweep_engine.programs()}
    assert {p["key"]: p["captured_launches"]
            for p in engine.programs()} == launches


# -- TCI1, matrix CI / ACA and the conversions ------------------------------

_TABLE = np.random.default_rng(0).uniform(-1.0, 1.0, 2 ** 20)


def _random_table_f(L, device):
    """The reference notebook's random f on `device`: the 2^20-value table
    looked up at sum_i sigma_i 2^i (a sum of products: no int64 matmul)."""
    table = torch.as_tensor(_TABLE, device=device)
    w = torch.as_tensor(2 ** np.arange(L), device=device)
    return tci_tpu_torch.TorchBatchEvaluator(
        lambda idx: table[(idx * w).sum(1)], [2] * L, device=device)


@pytest.mark.parametrize("evaluator", ["torch", "scalar"])
def test_tci1_on_the_card_matches_cpu(cuda, evaluator):
    """crossinterpolate1 on the card (no device argument) against the same
    call on the CPU: on the random f the same pivot sets and errors within
    1e-12 relative; on config 1's Lorentzian (exact ties, C-port-15) the
    same ranks, errors within 1e-15 absolute, pointwise error below 1e-7.
    Every array of the state stays on the card."""
    L, D = 12, 24
    if evaluator == "torch":
        out, ranks, errs = tci_tpu_torch.crossinterpolate1(
            np.float64, _random_table_f(L, cuda), [2] * L, tolerance=1e-12,
            maxiter=D)
        ref, rranks, rerrs = tci_tpu_torch.crossinterpolate1(
            np.float64, _random_table_f(L, "cpu"), [2] * L, tolerance=1e-12,
            maxiter=D, device="cpu")
        assert [s.fromint for s in out.Iset + out.Jset] == [
            s.fromint for s in ref.Iset + ref.Jset]
        np.testing.assert_allclose(errs, rerrs, rtol=1e-12, atol=0)
    else:
        def f(x):
            return 1.0 / (1.0 + sum((i + 1.0) ** 2 for i in x))
        out, ranks, errs = tci_tpu_torch.crossinterpolate1(
            np.float64, f, [10] * 8, tolerance=1e-8)
        ref, rranks, rerrs = tci_tpu_torch.crossinterpolate1(
            np.float64, f, [10] * 8, tolerance=1e-8, device="cpu")
        np.testing.assert_allclose(errs, rerrs, rtol=0, atol=1e-15)
        x = (1, 2, 3, 4, 5, 4, 3, 2)
        assert abs(out.evaluate(x) - f(x)) < 1e-7
    assert ranks == rranks and out.linkdims() == ref.linkdims()
    assert out.device.type == "cuda"
    for arrays in (out.T, out.P, out.Pi):
        assert all(t.device.type == "cuda" for t in arrays)
    assert all(a.u.device.type == "cuda" for a in out.aca)


@pytest.mark.parametrize("seed", range(3))
def test_matrixci_argmax_on_the_card_is_numpys_colmajor_rule(cuda, seed):
    """findnewpivot's argmax on the card: column-major, first occurrence,
    a NaN above every value (np.argmax's rule), with ties."""
    from tci_tpu_torch.ops.ci import argmax_colmajor

    rng = np.random.default_rng(seed)
    M = rng.integers(0, 4, (300, 70)).astype(float)
    if seed:
        M[rng.integers(0, 300, 2), rng.integers(0, 70, 2)] = np.nan
    flat = int(np.argmax(M.T.reshape(-1)))
    r, c, v = argmax_colmajor(torch.as_tensor(M, device=cuda))
    assert (r, c) == (flat % 300, flat // 300)
    assert np.isnan(v) if seed else v == 3.0
    ci = tci_tpu_torch.MatrixCI(nrows=300, ncols=70, device=cuda)
    (rr, cc), vv = ci.findnewpivot(M)
    assert (rr, cc) == (r, c)


def test_matrixci_and_aca_on_the_card_match_cpu(cuda):
    """matrix_crossinterpolate and greedy MatrixACA on a seeded rank-20
    matrix on the card against the CPU: the same pivots, reconstructions
    within 1e-10 max|A|."""
    from tci_tpu_torch.ops.ci import argmax_colmajor

    rng = np.random.default_rng(7)
    A = (rng.standard_normal((200, 20)) * np.exp(-np.arange(20) / 4.0)) @ (
        rng.standard_normal((20, 150)))
    kw = dict(tolerance=1e-12 * np.abs(A).max(), maxiter=30)
    out = tci_tpu_torch.matrix_crossinterpolate(A, **kw)
    ref = tci_tpu_torch.matrix_crossinterpolate(A, device="cpu", **kw)
    assert (out.rowindices, out.colindices) == (ref.rowindices,
                                                ref.colindices)
    assert out.pivotcols.device.type == "cuda"
    err = float((out.matrix().cpu() - torch.from_numpy(A)).abs().max())
    assert err <= 1e-10 * np.abs(A).max()

    acas = []
    for device in (cuda, "cpu"):
        At = torch.as_tensor(A, device=device)
        r, c, _ = argmax_colmajor(At.abs())
        aca = tci_tpu_torch.MatrixACA(A=At, firstpivot=(r, c))
        while aca.rank() < 20:
            aca.addpivot(At)
        acas.append(aca)
    assert acas[0].rowindices == acas[1].rowindices
    assert acas[0].colindices == acas[1].colindices
    err = float((acas[0].matrix().cpu() - torch.from_numpy(A)).abs().max())
    assert err <= 1e-10 * np.abs(A).max()


def test_conversion_on_the_card_matches_cpu(cuda):
    """tci1_from_tci2 -> tci2_from_tci1 and tci2_from_tensortrain on a TCI2
    of config 1's Lorentzian at five sites, on the card and on the CPU:
    the same linkdims, values within 1e-12 of each other and within 1e-8
    max|f| of the TCI2 they came from."""
    from tci_tpu_torch.models import conversion

    def f(x):
        return 1.0 / (1.0 + sum((i + 1.0) ** 2 for i in x))

    out = {}
    for device in (cuda, "cpu"):
        t2, _, _ = tci_tpu_torch.crossinterpolate2(
            np.float64, f, [10] * 5, tolerance=1e-10,
            rng=np.random.default_rng(0), device=device)
        t1 = conversion.tci1_from_tci2(t2, f)
        back = conversion.tci2_from_tci1(t1)
        fromtt = conversion.tci2_from_tensortrain(
            tci_tpu_torch.tensortrain(t2), tolerance=1e-12)
        out[str(device)] = (t2, t1, back, fromtt)
    pts = np.random.default_rng(3).integers(0, 10, (200, 5))
    vals = {}
    for key, (t2, t1, back, fromtt) in out.items():
        assert t1.linkdims() == back.linkdims() == t2.linkdims()
        assert fromtt.linkdims() == t2.linkdims()
        want = tci_tpu_torch.tensortrain(t2).evaluate_batch(pts).cpu()
        scale = float(want.abs().max())
        for res in (back, fromtt):
            got = tci_tpu_torch.tensortrain(res).evaluate_batch(pts).cpu()
            assert float((got - want).abs().max()) <= 1e-8 * scale
        vals[key] = tci_tpu_torch.tensortrain(back).evaluate_batch(pts).cpu()
    assert out[str(cuda)][2].linkdims() == out["cpu"][2].linkdims()
    assert all(t.device.type == "cuda" for t in out[str(cuda)][3])
    assert float((vals[str(cuda)] - vals["cpu"]).abs().max()) <= 1e-12


def test_conversion_tensortrain_launches_the_kernel_per_luci(cuda,
                                                            monkeypatch):
    """tci2_from_tensortrain of a train on the card: one rrLU kernel launch
    for each MatrixLUCI it builds, and no plain-version call on CUDA."""
    from tci_tpu_torch.models import conversion

    rng = np.random.default_rng(4)
    b = [1, 2, 4, 8, 4, 2, 1]  # the ranks random cores of legs 2 reach
    cores = [rng.standard_normal((b[n], 2, b[n + 1])) for n in range(6)]
    tt = tci_tpu_torch.TensorTrain(cores, device=cuda)
    made = []
    init = conversion.MatrixLUCI.__init__

    def counted(self, *args, **kwargs):
        made.append(args[0].device.type)
        init(self, *args, **kwargs)

    monkeypatch.setattr(conversion.MatrixLUCI, "__init__", counted)
    launches = lu_cuda.LAUNCHES["rrlu"]
    plain = lu_kernel.PLAIN_CALLS["cuda"]
    out = conversion.tci2_from_tensortrain(tt, tolerance=1e-12)
    assert made and set(made) == {"cuda"}
    assert lu_cuda.LAUNCHES["rrlu"] - launches == len(made)
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    assert out.linkdims() == tt.linkdims()


# -- the auxiliaries on the card: checkpoint, interop, from_scalar ------------

def _config1_scalar(v):
    v = v.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum())


def _config1_batched(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(1))


def test_from_scalar_records_into_the_engines_graphs(cuda):
    """A vmapped scalar f records into the engine's CUDA graphs like the
    batched f (no key declined, the second run only replays) and gives its
    ranks, errors, samples and site tensors bit for bit."""
    dims = [10] * 6
    out = {}
    for kind in ("scalar", "batched"):
        ev = (tci_tpu_torch.TorchBatchEvaluator.from_scalar(
            _config1_scalar, dims) if kind == "scalar" else
            tci_tpu_torch.TorchBatchEvaluator(_config1_batched, dims))
        for run in range(2):
            ev.reset_nevals()
            t, ranks, errors = tci_tpu_torch.crossinterpolate2(
                np.float64, ev, dims, tolerance=1e-8,
                rng=np.random.default_rng(0))
        engine = ev.device_sweep_engine
        assert not engine.declined and engine.replays > 0
        out[kind] = (t, ranks, errors, ev.nevals)
    (ts, rs, es, ns), (tb, rb, eb, nb) = out["scalar"], out["batched"]
    assert rs == rb and es == eb and ns == nb
    assert ts.Iset == tb.Iset and ts.Jset == tb.Jset
    for a, b in zip(ts.sitetensors(), tb.sitetensors()):
        assert torch.equal(a, b)


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """save -> load on the card -> save gives the same arrays bit for bit;
    the loaded TCI resumes on the engine of a kept evaluator, which only
    replays the graphs it recorded."""
    from tci_tpu_torch.utils import checkpoint
    from tci_tpu_torch.utils.device import FETCHES

    dims = [10] * 6
    ev = tci_tpu_torch.TorchBatchEvaluator(_config1_batched, dims)
    t, _, _ = tci_tpu_torch.crossinterpolate2(
        np.float64, ev, dims, tolerance=1e-4, rng=np.random.default_rng(0))
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    FETCHES.clear()
    checkpoint.save_tci2(a, t)
    assert FETCHES["checkpoint"] == 1
    loaded = checkpoint.load_tci2(a)
    assert loaded.device.type == "cuda" and loaded._maxsample_dev is None
    assert all(x.device.type == "cuda" for x in loaded.sitetensors())
    checkpoint.save_tci2(b, loaded)
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            assert fa[k].tobytes() == fb[k].tobytes(), k
    # resume twice from the file on one evaluator: the second only replays
    res = []
    for _ in range(2):
        r = checkpoint.load_tci2(a)
        ranks, errors = r.optimize(ev, tolerance=1e-8,
                                   rng=np.random.default_rng(0))
        res.append((ranks, errors, r.Iset, r.Jset))
    assert res[0] == res[1] and res[0][1][-1] < 1e-8
    assert not ev.device_sweep_engine.declined


def test_interop_round_trips_on_the_card(cuda):
    from tci_tpu_torch.interop import mps

    rng = np.random.default_rng(1)
    b = [1, 3, 4, 3, 1]
    cores = [rng.standard_normal((b[n], 2, b[n + 1]))
             + 1j * rng.standard_normal((b[n], 2, b[n + 1])) for n in range(4)]
    tt = tci_tpu_torch.TensorTrain(cores)
    arrays = mps.to_mps_tensors(tt)
    assert all(a.device.type == "cuda" for a in arrays)
    back = mps.from_mps_tensors(arrays)
    quimb = mps.from_quimb_mps(type("MPS", (), {
        "arrays": mps.to_quimb_arrays(tt)})())
    for res in (back, quimb):
        for x, y in zip(res.sitetensors(), tt.sitetensors()):
            assert x.device.type == "cuda" and torch.equal(x, y)
    pts = np.random.default_rng(2).integers(0, 2, (50, 4))
    want = tt.evaluate_batch(pts).cpu().numpy()
    for p, w in zip(pts, want):
        got = mps.evaluate_mps(arrays, p)
        assert abs(got - w) <= 1e-12 * abs(w)


# -- the device fuzz suite: the tiers on the card against the CPU -------------

def _on_both(run, case, device):
    """run(case) on the card and on the CPU; no plain-version call on a
    CUDA tensor on the way."""
    plain = lu_kernel.PLAIN_CALLS["cuda"]
    on_card = run(case, device)
    assert lu_kernel.PLAIN_CALLS["cuda"] == plain
    return on_card, run(case, "cpu")


def _fuzz(sweep):
    return range(fz.NTRIALS[sweep])


@pytest.mark.parametrize("trial", _fuzz("compress"))
def test_fuzz_compress_on_the_card(cuda, trial):
    case = fz.compress_case(trial)
    (h, hf, d, df), (hc, hfc, dc, dfc) = _on_both(fz.run_compress, case, cuda)
    scale = max(1.0, np.abs(hfc).max())
    assert h == d == hc == dc, case["cfg"]
    for x in (hf, df):
        assert np.allclose(x, hfc, rtol=0, atol=1e-8 * scale), case["cfg"]


@pytest.mark.parametrize("trial", _fuzz("contraction"))
def test_fuzz_contraction_on_the_card(cuda, trial):
    case = fz.contraction_case(trial)
    (h, hf, d, df), (hc, hfc, dc, dfc) = _on_both(fz.run_contraction, case,
                                                  cuda)
    scale = max(1.0, np.abs(hfc).max())
    assert h == hc and d == dc, case["cfg"]
    assert max(d) <= case["mbd"] and not np.any(np.isnan(df)), case["cfg"]
    assert np.allclose(hf, hfc, rtol=0, atol=1e-7 * scale), case["cfg"]
    assert np.allclose(df, dfc, rtol=0, atol=1e-7 * scale), case["cfg"]


@pytest.mark.parametrize("trial", _fuzz("rook"))
def test_fuzz_rook_on_the_card(cuda, trial):
    case = fz.rook_case(trial)
    launches = lu_cuda.LAUNCHES["rrlu"]
    (ld, ranks, errors, full, calls), cpu = _on_both(fz.run_rook, case, cuda)
    assert calls > 0 and lu_cuda.LAUNCHES["rrlu"] > launches, case["cfg"]
    exact = fz.rook_exact(case)
    scale = np.abs(exact).max()
    assert np.abs(full - exact).max() < 1e-7 * scale, case["cfg"]
    assert ld == cpu[0] and ranks == cpu[1], case["cfg"]
    assert np.allclose(errors, cpu[2], rtol=0, atol=1e-15), case["cfg"]


@pytest.mark.parametrize("trial", _fuzz("complex"))
def test_fuzz_complex_on_the_card(cuda, trial):
    case = fz.complex_case(trial)
    (el, ef, hl, hf), (elc, efc, hlc, hfc) = _on_both(fz.run_complex, case,
                                                      cuda)
    assert el == hl == elc == hlc, case["cfg"]
    for x in (ef, hf):
        assert np.allclose(x, hfc, rtol=0, atol=1e-8), case["cfg"]


@pytest.mark.parametrize("trial", _fuzz("conversion"))
def test_fuzz_conversion_on_the_card(cuda, trial):
    case = fz.conversion_case(trial)
    out, cpu = _on_both(fz.run_conversion, case, cuda)
    scale = np.abs(cpu["tci2"][1]).max()
    for name in out:
        assert out[name][0] == cpu[name][0] == cpu["tci2"][0], (
            case["cfg"], name)
        assert np.allclose(out[name][1], cpu[name][1], rtol=0,
                           atol=1e-8 * scale), (case["cfg"], name)


@pytest.mark.parametrize("trial", _fuzz("floatingzone"))
def test_fuzz_floatingzone_on_the_card(cuda, trial):
    case = fz.floatingzone_case(trial)
    (ld, dev, host), (ldc, devc, hostc) = _on_both(fz.run_floatingzone, case,
                                                   cuda)
    assert ld == ldc and len(dev) > 0, case["cfg"]
    errs = [e for _, e in dev]
    assert errs == sorted(errs, reverse=True), case["cfg"]
    best = max(host, key=lambda pe: pe[1])
    assert dev[0][0] == best[0], case["cfg"]
    assert np.isclose(dev[0][1], best[1], rtol=1e-9), case["cfg"]
    assert np.isclose(dev[0][1], devc[0][1], rtol=1e-9), case["cfg"]


@pytest.mark.parametrize("trial", _fuzz("tci1"))
def test_fuzz_tci1_on_the_card(cuda, trial):
    case = fz.tci1_case(trial)
    (ranks, errors, ld, full), cpu = _on_both(fz.run_tci1, case, cuda)
    exact = fz.tci1_exact(case)
    assert np.abs(full - exact).max() < 1e-8 * np.abs(exact).max()
    assert ranks == cpu[0] and ld == cpu[2], case["cfg"]
    assert np.allclose(errors, cpu[1], rtol=0, atol=1e-15), case["cfg"]


# -- the mesh (A14, B8): one-rank NCCL meshes on the card ---------------------


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL mesh of the card (a process group of this process
    alone, made by default_mesh)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    import gc

    import torch.distributed as dist
    from tci_tpu_torch.parallel.mesh import default_mesh
    yield default_mesh(1)
    # the engines' graphs that hold NCCL collectives go before the group
    gc.collect()
    dist.destroy_process_group()


def _sharded_panel(kind, dtype):
    """A 272 x 224 zero-padded panel of 250 x 210 true extents (a dead
    tail): "reltol" of rank 41, which stops by reltol with updates pending
    at depths 2, 3 and 4 (41 is a multiple of none), "maxrank" of full
    rank run to maxrank 45, "nan" of full rank with one NaN, picked at the
    first step, after which every live entry is NaN."""
    rng = np.random.default_rng(3)
    A = np.zeros((272, 224))
    if kind == "reltol":
        A[:250, :210] = rng.standard_normal((250, 41)) @ rng.standard_normal(
            (41, 210))
    else:
        A[:250, :210] = rng.standard_normal((250, 210))
    if kind == "nan":
        A[200, 100] = np.nan
    P = torch.from_numpy(A).to("cuda", dtype)
    if dtype.is_complex:
        P = P + 1j * P.flip(0)
    reltol = (1e-5 if dtype == torch.float32 else 1e-10) \
        if kind == "reltol" else 1e-14
    return P, 250, 210, 210 if kind == "reltol" else 45, reltol, 0.0


@pytest.mark.parametrize("kind", ["reltol", "maxrank", "nan"])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex128])
@pytest.mark.parametrize("leftorthogonal", [True, False])
def test_lu_sharded_step_kernel_matches_plain(nccl_mesh, leftorthogonal,
                                              dtype, depth, kind):
    """Every launch of the step kernel bitwise its plain version on copies
    of its inputs, with the write-back deferred over `depth` steps (the
    kernel's NP = 0 ... depth - 1 instantiations: 16-byte vectors of 4
    f32, 2 f64, 1 complex128), and the sharded elimination bitwise the
    one-device kernel's and the one-device plain version's (NaN where they
    have NaN): a stop by reltol with updates pending (the flush), a run to
    maxrank, and a NaN panel, in both orientations (right-orthogonal: the
    owner stores row pr)."""
    from tci_tpu_torch.ops import lu_sharded
    args = _sharded_panel(kind, dtype)
    before = lu_sharded.LAUNCHES["lu_sharded_step"]
    lu_sharded.CHECKS = []
    lu_sharded.DEFER = depth
    try:
        out = lu_sharded.rrlu_panel_sharded(*args, mesh=nccl_mesh,
                                            leftorthogonal=leftorthogonal)
        checks = lu_sharded.CHECKS
    finally:
        lu_sharded.CHECKS = None
        lu_sharded.DEFER = None
    torch.cuda.synchronize()
    assert len(checks) == lu_sharded.LAUNCHES["lu_sharded_step"] - before
    assert checks and all(eq for _, eq, _ in checks)
    k = int(out[3])
    if kind == "reltol":
        # stopped by the tolerance, with k % depth updates pending
        assert k == 41 and float(out[5]) > 0
    else:
        assert k == 45
    assert bool(out[5].isnan()) == (kind == "nan")
    kern = lu_cuda.rrlu_call(*args, leftorthogonal=leftorthogonal)
    plain = lu_kernel.rrlu_plain(*args, leftorthogonal=leftorthogonal)
    for o, r, p in zip(out, kern, plain):
        assert _same(o, r) and _same(o, p)
        if kind != "nan":
            assert torch.equal(o, r) and torch.equal(o, p)


def test_rrlu_sharded_on_nccl_matches_kernel(nccl_mesh):
    """rrlu_sharded_raw at N = 1000 (rank 100) on the card: the one-device
    rrlu_raw's pivot order and LU buffer bit for bit; one launch a step
    and one for the first candidate, each followed by one gather of the
    slots, no plain version on the card; the stop flag is read once every
    CHECK_EVERY steps."""
    from tci_tpu_torch.ops import lu_sharded
    rng = np.random.default_rng(5)
    A = torch.as_tensor(rng.standard_normal((1000, 100))
                        @ rng.standard_normal((100, 1000)), device="cuda")
    for c in (lu_sharded.LAUNCHES, lu_sharded.PLAIN_CALLS,
              lu_sharded.FLAG_READS, lu_sharded.COLLECTIVES):
        c.clear()
    s = lu_sharded.rrlu_sharded_raw(A, 400, 1e-10, 0.0, True,
                                    mesh=nccl_mesh)
    r = lu_kernel.rrlu_raw(A, 400, 1e-10, 0.0, True)
    assert s[3] == r[3] == 100
    assert np.array_equal(s[1], r[1]) and np.array_equal(s[2], r[2])
    assert torch.equal(s[0], r[0]) and np.array_equal(s[4], r[4])
    steps = lu_sharded.LAUNCHES["lu_sharded_step"] - 1
    assert lu_sharded.COLLECTIVES["gather"] == steps + 1
    every = lu_sharded.CHECK_EVERY
    assert 101 <= steps <= 101 + every - 1
    assert lu_sharded.FLAG_READS["stop"] == steps // every
    assert lu_sharded.PLAIN_CALLS["cuda"] == 0
    lu = tci_tpu_torch.rrlu(A, maxrank=400, reltol=1e-10, mesh=nccl_mesh)
    assert lu.npivot == 100 and lu.L.device.type == "cuda"


@pytest.mark.parametrize("depth,steps", [(1, 8), (4, 6), (4, 8)])
def test_lu_sharded_steps_replay_in_a_cuda_graph(nccl_mesh, depth, steps):
    """A CUDA graph of a block of steps (each a launch of the step kernel
    and the gather of the slots) replays bitwise the same steps queued
    eagerly, twice from the state it was captured from: the last block of
    each launch resets the kernel's counter, so the next launch and the
    next replay count anew. With the write-back deferred (depth 4) each
    launch's pending count is fixed at capture (the host's step count
    modulo the depth), so the state's step count is restored with its
    fields; a graph of a multiple of the depth also replays back to back,
    bitwise the eager steps of both replays."""
    from tci_tpu_torch.ops import lu_sharded
    rng = np.random.default_rng(11)
    N = 512
    A = torch.as_tensor(rng.standard_normal((N, N)), device="cuda")
    lu_sharded.DEFER = depth
    try:
        s0 = lu_sharded._State(A, 0, N, N, N, 1e-14, 0.0, True, 1, N)
    finally:
        lu_sharded.DEFER = None
    assert s0.depth == depth
    lu_sharded._launch(s0, 0)
    lu_sharded._gather(s0, nccl_mesh)

    def run(s, n=steps):
        for _ in range(n):
            lu_sharded._launch(s, 1)
            lu_sharded._gather(s, nccl_mesh)

    def restore(s):
        for f in lu_sharded._State.FIELDS:
            getattr(s, f).copy_(getattr(s0, f))
        s.steps = s0.steps

    def same(s, ref):
        assert int(s.scratch[:4].view(torch.int32)[0]) == 0
        for f in lu_sharded._State.FIELDS:
            assert torch.equal(lu_sharded._bits(getattr(s, f)),
                               lu_sharded._bits(getattr(ref, f))), f

    ref = s0.clone()
    run(ref)
    g = s0.clone()
    lu_sharded._launch(g, 1)  # its scratch and arguments, before capture
    restore(g)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run(g)
    for _ in range(2):
        restore(g)
        graph.replay()
        torch.cuda.synchronize()
        assert int(g.ist[0]) == steps
        same(g, ref)
    if steps % depth == 0:
        run(ref)
        restore(g)
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        assert int(g.ist[0]) == 2 * steps
        same(g, ref)


def test_engine_on_mesh_records_the_gather(nccl_mesh):
    """crossinterpolate2 on the mesh: the engine records its sweeps, the
    all-gather of the sharded sampling inside, declines none, and gives
    the one-device run's ranks, errors and samples bit for bit, cold and
    replayed."""
    def f(idx):
        v = idx.to(torch.float64) + 1.0
        return 1.0 / (1.0 + (v * v).sum(1))

    dims = [6] * 6
    out = {}
    for tag, mesh in (("mesh", nccl_mesh), ("one", None)):
        bf = tci_tpu_torch.TorchBatchEvaluator(f, dims, mesh=mesh)
        runs = []
        for _ in range(2):
            bf.reset_nevals()
            _, ranks, errors = tci_tpu_torch.crossinterpolate2(
                np.float64, bf, dims, tolerance=1e-9,
                rng=np.random.default_rng(0))
            runs.append((ranks, errors, bf.nevals))
        eng = bf.device_sweep_engine
        out[tag] = runs
        if mesh is not None:
            assert not eng.declined and eng.captures and eng.replays
    assert out["mesh"] == out["one"]


def test_contraction_on_mesh_matches_device_tier(nccl_mesh):
    """Zip-up, naive and the compression on the mesh: the device tier's
    cores bit for bit."""
    rng = np.random.default_rng(9)
    b = [1, 4, 4, 4, 4, 1]
    A, B = ([rng.standard_normal((b[n], 2, 2, b[n + 1])) for n in range(5)]
            for _ in range(2))
    TT = tci_tpu_torch.TensorTrain
    for algorithm in ("zipup", "naive"):
        kw = dict(algorithm=algorithm, method="LU", tolerance=1e-10,
                  torch_native=True)
        m = tci_tpu_torch.contract(TT(A), TT(B), mesh=nccl_mesh, **kw)
        o = tci_tpu_torch.contract(TT(A), TT(B), **kw)
        assert m.linkdims() == o.linkdims()
        assert all(torch.equal(x, y)
                   for x, y in zip(m.sitetensors(), o.sitetensors()))
    tm, to = TT(m.sitetensors()), TT(o.sitetensors())
    tm.compress("LU", tolerance=1e-8, torch_native=True, mesh=nccl_mesh)
    to.compress("LU", tolerance=1e-8, torch_native=True)
    assert all(torch.equal(x, y)
               for x, y in zip(tm.sitetensors(), to.sitetensors()))


# -- the kernel's work record (lu_cuda.work_record) -------------------------


def _bound_parts_work(mp, npd, m, n, k, elsize):
    """chip_smoke.py's bound_parts, as counts: c sum_{j<k} (m-1-j)(n-1-j)
    real operations (c = 2 real, 8 complex) and the bytes of the panel in
    and the LU buffer, the permutations, k, mags and err out."""
    real = min(elsize, 8)
    nbytes = (2 * mp * npd * elsize + 8 * (mp + npd + 1)
              + real * (min(mp, npd) + 1))
    c = 8 if elsize == 16 else 2
    return sum(c * (m - 1 - j) * (n - 1 - j) for j in range(k)), nbytes


def _work_panels(dtype, device):
    """One panel a mode, (A, m, n, k, mode): resident 64^2, cluster 512^2
    (136 x 271 true), grid-resident 1024^2 (960 rows), streamed (2045 rows
    of 2048^2, 4090 of 4096^2 in float32, whose 2048^2 panel the grid's
    shared memory holds). The rank cap is k, so each takes k pivots."""
    big = 4096 if dtype == torch.float32 else 2048
    shapes = ((64, 60, 50, 6, 0), (512, 136, 271, 19, 1),
              (1024, 960, 900, 12, 2), (big, big - 6, big - 40, 9, 3))
    out = []
    for mp, m, n, k, mode in shapes:
        if dtype.is_complex:
            A = _cpanel(mp + k, mp, mp, m, n, 2 * k, device)
        else:
            A = _panel(mp + k, mp, mp, m, n, 2 * k, dtype, device)
        out.append((A, m, n, k, mode))
    return out


def _expected_work(panels, times=1):
    exp = [0] * len(lu_cuda.WORK_FIELDS)
    for A, m, n, k, mode in panels:
        ops, nbytes = _bound_parts_work(*A.shape, m, n, k, A.element_size())
        exp[1 + mode] += times
        exp[5] += times * k
        exp[6] += times * ops
        exp[7] += times * nbytes
    return exp


@pytest.fixture
def work_flag(cuda):
    """The current device's work record with its flag set for the test,
    cleared after it."""
    rec = lu_cuda.work_record(torch.cuda.current_device())
    rec[0] = 1
    yield rec
    rec[0] = 0
    torch.cuda.synchronize()


def _delta(rec, before):
    torch.cuda.synchronize()
    d = (rec - before).tolist()
    d[0] = 0
    return d


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex128])
def test_work_record_counts_each_mode(work_flag, dtype):
    """With the flag set, each launch adds its panel's mode, rank,
    operations and bytes, as bound_parts counts them from the true extents;
    a batched launch adds each of its panels."""
    panels = _work_panels(dtype, work_flag.device)
    before = work_flag.clone()
    for A, m, n, k, mode in panels:
        out = lu_cuda.rrlu_call(A, m, n, k, 0.0, 0.0, leftorthogonal=True,
                                return_mode=True)
        assert int(out[6]) == mode and int(out[3]) == k
    assert _delta(work_flag, before) == _expected_work(panels)
    A, m, n, k, mode = panels[0]
    before = work_flag.clone()
    out = lu_cuda.rrlu_batched(torch.stack([A, A, A]), m, n, k, 0.0, 0.0,
                               leftorthogonal=False, return_mode=True)
    assert out[6].tolist() == [0] * 3
    assert _delta(work_flag, before) == _expected_work(panels[:1], 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex128])
def test_work_record_counts_replays(work_flag, dtype):
    """Launches of every mode recorded into one CUDA graph: each of three
    replays adds their work again (the graph holds the record's address),
    and their outputs are those of the eager launches."""
    from tci_tpu_torch.utils.device import capture_graph

    dev = work_flag.device
    panels = _work_panels(dtype, dev)
    lu_cuda.warm_up(dev.index, dtype)

    def body():
        return [lu_cuda.rrlu_call(A, m, n, k, 0.0, 0.0, leftorthogonal=True)
                for A, m, n, k, _ in panels]

    ref = body()
    before = work_flag.clone()
    graph, outs = capture_graph(body, torch.cuda.graph_pool_handle(),
                                torch.cuda.Stream(dev))
    assert _delta(work_flag, before) == [0] * len(lu_cuda.WORK_FIELDS)
    for _ in range(3):
        graph.replay()
    assert _delta(work_flag, before) == _expected_work(panels, 3)
    for out, r in zip(outs, ref):
        for o, x in zip(out, r):
            assert _equal(o, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex128])
def test_work_record_flag_clear_changes_nothing(cuda, dtype):
    """With the flag clear, launches of every mode leave the record as it
    was, and their outputs are bitwise the plain version's."""
    rec = lu_cuda.work_record(torch.cuda.current_device())
    torch.cuda.synchronize()
    assert int(rec[0]) == 0
    before = rec.clone()
    for A, m, n, k, mode in _work_panels(dtype, cuda):
        args = (A, m, n, k, 0.0, 0.0)
        out = lu_cuda.rrlu_call(*args, leftorthogonal=True, return_mode=True)
        ref = lu_kernel.rrlu_plain(*args, leftorthogonal=True)
        assert int(out[6]) == mode
        for o, r in zip(out, ref):
            assert _equal(o, r)
    torch.cuda.synchronize()
    assert torch.equal(rec, before)


def test_traced_solve_counts_its_rrlu_work(cuda):
    """On the card a solve sets the record's flag to whether a profiler
    records: the untraced solves of a kept evaluator add nothing, the
    traced one adds the work of its replayed launches, and the next
    untraced one clears the flag again."""
    from torch.profiler import ProfilerActivity, profile

    from tci_tpu_torch.utils import trace

    f = lambda idx: 1.0 / (1.0 + ((idx.to(torch.float64) + 1) ** 2).sum(1))
    bf = tci_tpu_torch.TorchBatchEvaluator(f, [10] * 8)

    def solve():
        return tci_tpu_torch.crossinterpolate2(
            np.float64, bf, [10] * 8, tolerance=1e-8,
            rng=np.random.default_rng(0))

    solve()
    before = trace.rrlu_work()
    solve()
    assert trace.rrlu_work() == before
    replays = bf.device_sweep_engine.replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        solve()
        torch.cuda.synchronize()
    assert bf.device_sweep_engine.replays > replays
    work = trace.rrlu_work()
    assert work["ops"] > before["ops"] and work["cluster"] > before["cluster"]
    assert work["bytes"] > before["bytes"]
    solve()
    torch.cuda.synchronize()
    assert trace.rrlu_work() == work
    assert int(lu_cuda.work_record(torch.cuda.current_device())[0]) == 0


def _gk_tables(N, order, device, degenerate=(), seed=0):
    """The (N, K) GK nodes and weights integrate builds on random bounds
    (a_n = b_n for n in `degenerate`)."""
    from tci_tpu_torch.ops.kronrod import kronrod
    rng = np.random.default_rng(seed)
    a = rng.uniform(-2.0, 0.0, N)
    b = rng.uniform(0.5, 2.0, N)
    for n in degenerate:
        b[n] = a[n]
    x1, w1, _ = kronrod(order // 2)
    nodes = (b[:, None] - a[:, None]) * (x1[None, :] + 1) / 2 + a[:, None]
    weights = (b[:, None] - a[:, None]) * w1[None, :] / 2
    return (torch.from_numpy(nodes).to(device),
            torch.from_numpy(weights).to(device))


def _gk_sets(rng, K, m, nl, n, nr, device):
    # prefixes of wider buffers, as the engine hands its sets over
    rows = torch.from_numpy(rng.integers(0, K, size=(m, nl + 3)))
    cols = torch.from_numpy(rng.integers(0, K, size=(n, nr + 1)))
    return rows.to(device)[:, :nl], cols.to(device)[:, :nr]


def _gk_same(rows, cols, nodes, weights):
    """The kernel bit for bit the plain version, and no index clamped."""
    from tci_tpu_torch.ops import gk_panel
    X, W = gk_panel.gk_points_kernel(rows, cols, nodes, weights)
    Xp, Wp = gk_panel.gk_points_plain(rows, cols, nodes, weights)
    torch.cuda.synchronize()
    return (torch.equal(X, Xp) and torch.equal(W, Wp)
            and not gk_panel.clamped(rows.device))


@pytest.mark.parametrize("order", [15, 31, 61])
@pytest.mark.parametrize("N", [1, 3, 10, 24])
def test_gk_panel_kernel_matches_plain(cuda, N, order):
    """The kernel's coordinates and weights bit for bit the plain version's,
    at every split nl of N, for panels with a ragged last tile, one point,
    and several tiles a row; and the empty column set (an index matrix)."""
    nodes, weights = _gk_tables(N, order, cuda, seed=N + order)
    rng = np.random.default_rng(N * order)
    for nl in range(N + 1):
        for m, n in ((7, 5), (1, 1), (33, 2000)):
            rows, cols = _gk_sets(rng, order, m, nl, n, N - nl, cuda)
            assert _gk_same(rows, cols, nodes, weights), (nl, m, n)
    idx = torch.from_numpy(rng.integers(0, order, size=(5000, N + 2)))
    idx = idx.to(cuda)
    assert _gk_same(idx[:, :N].contiguous(), None, nodes, weights)
    assert _gk_same(idx[:, :N], None, nodes, weights)


def test_gk_panel_kernel_main_path_panel(cuda):
    """The main path's 1024 x 1024 panel at N = 10, GK15, every split; and
    tables too large for shared memory (N = 64, GK61: read through the
    read-only cache)."""
    nodes, weights = _gk_tables(10, 15, cuda)
    rng = np.random.default_rng(7)
    for nl in range(1, 10):
        rows, cols = _gk_sets(rng, 15, 1024, nl, 1024, 10 - nl, cuda)
        assert _gk_same(rows, cols, nodes, weights), nl
    nodes, weights = _gk_tables(64, 61, cuda)
    for nl in (0, 1, 31, 64):
        rows, cols = _gk_sets(rng, 61, 40, nl, 300, 64 - nl, cuda)
        assert _gk_same(rows, cols, nodes, weights), nl


def test_gk_panel_kernel_degenerate_bounds(cuda):
    """A zero weight (a_n = b_n) gives an exact zero in W, as in the plain
    version, and so in the panel."""
    nodes, weights = _gk_tables(6, 15, cuda, degenerate=(0, 4))
    rows, cols = _gk_sets(np.random.default_rng(3), 15, 64, 3, 96, 3, cuda)
    from tci_tpu_torch.ops import gk_panel
    _, W = gk_panel.gk_points_kernel(rows, cols, nodes, weights)
    assert bool((W == 0).all())
    assert _gk_same(rows, cols, nodes, weights)


def test_gk_panel_kernel_flags_an_index_outside_the_table(cuda):
    """An index in [-K, 0) counts from the end of the table, as in the
    plain version; one outside [-K, K), for which the plain version raises,
    is clamped to the table and raises the flag, which ``clamped`` reads
    and clears. The flag stays clear for valid sets."""
    from tci_tpu_torch.ops import gk_panel
    nodes, weights = _gk_tables(6, 15, cuda)
    rng = np.random.default_rng(5)
    rows, cols = _gk_sets(rng, 15, 40, 2, 70, 4, cuda)
    assert not gk_panel.clamped(cuda)
    rows[3, 1], cols[5, 0] = -1, -15
    assert _gk_same(rows, cols, nodes, weights)
    for bad, near in ((15, 14), (-16, 0), (2 ** 40, 14), (-2 ** 40, 0)):
        r, c = rows.clone(), cols.clone()
        c[7, 2] = bad
        X, W = gk_panel.gk_points_kernel(r, c, nodes, weights)
        assert gk_panel.clamped(cuda), bad
        assert not gk_panel.clamped(cuda), bad
        c[7, 2] = near
        Xp, Wp = gk_panel.gk_points_plain(r, c, nodes, weights)
        assert torch.equal(X, Xp) and torch.equal(W, Wp), bad
    idx = torch.from_numpy(rng.integers(0, 15, size=(300, 6))).to(cuda)
    idx[17, 5] = 15
    gk_panel.gk_points_kernel(idx, None, nodes, weights)
    assert gk_panel.clamped(cuda)
    assert _gk_same(idx.clamp(max=14), None, nodes, weights)


def test_gk_panel_kernel_in_a_cuda_graph(cuda):
    """The weighted integrand's panel and matrix forms recorded into a CUDA
    graph replay bitwise the plain version, with omega changed in place
    between replays; the capture records its launches and points in
    CAPTURED, not in LAUNCHES."""
    from tci_tpu_torch.models.integration import _WeightedGK
    from tci_tpu_torch.ops import gk_panel
    nodes, weights = _gk_tables(10, 15, cuda)
    omega = torch.zeros((), dtype=torch.float64, device=cuda)

    def f(X):
        return torch.cos(omega * (X ** 2).sum(1)) * torch.exp(-X.sum(1) ** 4
                                                              / 1000)

    F = _WeightedGK(f, nodes.cpu().numpy(), weights.cpu().numpy(), 15.0 ** 10,
                    cuda)
    rng = np.random.default_rng(11)
    rows, cols = _gk_sets(rng, 15, 1024, 4, 1024, 6, cuda)
    idx = torch.from_numpy(rng.integers(0, 15, size=(3000, 10))).to(cuda)
    F._tci_panel(rows, cols)
    torch.cuda.synchronize()
    launches, captured = gk_panel.LAUNCHES.copy(), gk_panel.CAPTURED.copy()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_panel = F._tci_panel(rows, cols)
        out_matrix = F(idx)
    assert gk_panel.LAUNCHES == launches
    assert gk_panel.CAPTURED - captured == {"gk_panel": 2,
                                            "rows": 1024 * 1024 + 3000}
    for value in (9.5, 10.25):
        omega.fill_(value)
        graph.replay()
        X, W = gk_panel.gk_points_plain(rows, cols, nodes, weights)
        want_panel = W * f(X) * 15.0 ** 10
        X, W = gk_panel.gk_points_plain(idx, None, nodes, weights)
        want_matrix = W * f(X) * 15.0 ** 10
        torch.cuda.synchronize()
        assert torch.equal(out_panel, want_panel), value
        assert torch.equal(out_matrix, want_matrix), value


def _gk15_10d(omega, seen=None):
    """The benchmark's 10-D GK15 integrand; `seen` ((2,) int64 on the card)
    counts its calls and points on the device, replays included."""
    def f(X):
        if seen is not None:
            seen[0] += 1
            seen[1] += X.shape[0]
        return 1000.0 * torch.cos(omega * (X ** 2).sum(dim=1)) * torch.exp(
            -X.sum(dim=1) ** 4 / 1000.0)
    return f


def _gk15_10d_solve(f, monkeypatch):
    """integrate(f) as the benchmark's gk15_10d cell runs it; returns the
    integral and the TT's cores."""
    from tci_tpu_torch.models import integration
    out = []
    solve = integration.crossinterpolate2

    def recording(*args, **kwargs):
        out.append(solve(*args, **kwargs))
        return out[-1]

    monkeypatch.setattr(integration, "crossinterpolate2", recording)
    val = integration.integrate(
        np.float64, f, [-1.0] * 10, [1.0] * 10, GKorder=15, torch_native=True,
        tolerance=1e-8, maxbonddim=64, nsearchglobalpivot=10,
        rng=np.random.default_rng(0))
    monkeypatch.setattr(integration, "crossinterpolate2", solve)
    torch.cuda.synchronize()
    return val, [c.clone() for c in out[-1][0].sitetensors()]


def test_gk_panel_counts_every_point_under_replay(cuda, monkeypatch):
    """A 10-D GK15 solve on a kept integrand, recorded and then replayed:
    LAUNCHES["gk_panel"] and ROWS["gk_panel"] count every call of the
    integrand and every point it saw (counted on the device, inside the
    graphs), in the recording solve and in the replayed one."""
    from tci_tpu_torch.models import integration
    from tci_tpu_torch.ops import gk_panel
    omega = torch.tensor(10.0, dtype=torch.float64, device=cuda)
    seen = torch.zeros(2, dtype=torch.int64, device=cuda)
    f = _gk15_10d(omega, seen)
    for k in range(2):
        launches, rows = gk_panel.LAUNCHES["gk_panel"], gk_panel.ROWS["gk_panel"]
        seen.zero_()
        _gk15_10d_solve(f, monkeypatch)
        calls, points = seen.tolist()
        assert gk_panel.LAUNCHES["gk_panel"] - launches == calls > 0, k
        assert gk_panel.ROWS["gk_panel"] - rows == points, k
        omega.fill_(10.3)
    engine = next(iter(integration._GK_EVAL_CACHE[f].values())
                  ).device_sweep_engine
    assert engine.replays > 0 and not engine.declined


def test_gk15_10d_solve_is_bitwise_the_plain_path(cuda, monkeypatch):
    """One whole gk15_10d solve through the kernel and one through the plain
    version on the card (today's index matrix, gathers and product): the
    same integral and the same TT cores, bit for bit."""
    from tci_tpu_torch.ops import gk_panel
    omega = torch.tensor(10.0, dtype=torch.float64, device=cuda)
    launches = gk_panel.LAUNCHES["gk_panel"]
    val, cores = _gk15_10d_solve(_gk15_10d(omega), monkeypatch)
    assert gk_panel.LAUNCHES["gk_panel"] > launches
    assert not gk_panel.clamped(cuda)
    monkeypatch.setattr(gk_panel, "gk_points_kernel",
                        gk_panel.gk_points_plain)
    launches = gk_panel.LAUNCHES["gk_panel"]
    val_plain, cores_plain = _gk15_10d_solve(_gk15_10d(omega), monkeypatch)
    assert gk_panel.LAUNCHES["gk_panel"] == launches
    assert val == val_plain
    assert len(cores) == len(cores_plain) == 10
    for c, cp in zip(cores, cores_plain):
        assert torch.equal(c, cp)


def test_evaluator_without_gk_tables_launches_no_gk_kernel(cuda):
    """An evaluator whose f has no panel entry point (config 1's f, as the
    lorentz8d cell's) samples through the index matrix: recorded and
    replayed, its solves launch, capture and count nothing of the GK panel
    kernel."""
    from tci_tpu_torch.ops import gk_panel
    f = lambda idx: 1.0 / (1.0 + ((idx.to(torch.float64) + 1) ** 2).sum(1))
    bf = tci_tpu_torch.TorchBatchEvaluator(f, [10] * 8)
    before = (gk_panel.LAUNCHES.copy(), gk_panel.ROWS.copy(),
              gk_panel.CAPTURED.copy())
    for _ in range(2):
        tci_tpu_torch.crossinterpolate2(np.float64, bf, [10] * 8,
                                        tolerance=1e-8,
                                        rng=np.random.default_rng(0))
    torch.cuda.synchronize()
    assert bf.device_sweep_engine.replays > 0
    assert (gk_panel.LAUNCHES, gk_panel.ROWS, gk_panel.CAPTURED) == before
