"""tci_tpu_torch on a CUDA device: the rrLU kernel and the six batched-grid
probe kernels against their plain PyTorch versions on the card, and the main
path through the kernel: the host tier, the fused tier and the whole-sweep
engine, which syncs only at its fetch; ``integrate`` on the card.

Every test needs a CUDA device and skips without one: the CUDA kernel has
no CPU mode. This file imports neither jax nor tci_tpu, so it runs on a
machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: none. The kernel rounds like the plain version (no fused
multiply-add, round-to-nearest division and square root), so outputs are
compared for equality.
"""

import numpy as np
import pytest
import torch

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
    # ... and multi-block ones, from just above the resident limit up
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
    assert lu_cuda._scratch_bytes(P.device.index, *P.shape,
                                  P.element_size()) == 0  # resident
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
    """Two 512 x 512 panels above the resident limit take the grid in turn,
    each with its own extents, rank cap and tolerances."""
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


def test_multiblock_repeats_bitwise(cuda):
    """N = 2000 in the multi-block mode, 20 runs against one plain result:
    a stale cross-block read would show as a rare wrong pivot."""
    A = _panel(2000, 2048, 2048, 2000, 2000, 100, torch.float64, cuda)
    args = (A, 2000, 2000, 2000, 1e-12, 0.0)
    ref = lu_kernel.rrlu_plain(*args, leftorthogonal=True)
    assert int(ref[3]) == 100
    for _ in range(20):
        out = lu_cuda.rrlu_call(*args, leftorthogonal=True)
        for o, r in zip(out, ref):
            assert _equal(o, r)


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
    # Imax = 32 (multi-block); config 3's bond panel (d = 2: 96^2, resident)
    # and config 4's (d = 15: 512^2, multi-block)
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
    assert engine.sweep2site(tci, True, 1e-14, 0.0, 2**62, empty, empty)
    torch.cuda.synchronize()
    fetches, launches = device_sweep.FETCHES["engine"], lu_cuda.LAUNCHES["rrlu"]
    plain = lu_kernel.PLAIN_CALLS["cuda"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert engine.sweep2site(tci, False, 1e-14, 0.0, 2**62, empty, empty,
                                 fill_sites=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert device_sweep.FETCHES["engine"] == fetches + 1
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


@pytest.mark.parametrize("which", ["probe", "second"])
@pytest.mark.parametrize("name", probe_batched.NAMES)
def test_probe_kernel_matches_plain(cuda, name, which):
    """Each probe kernel against its plain version, for equality (int32, and
    float32 values the operations keep exact); one launch a call."""
    B, n, s = probe_batched.check_inputs(name, which, cuda)
    wrapper, plain = probe_batched.PROBES[name]
    args = (B, cuda) if name == "v1" else (s,) if name == "v2" else (s, n)
    launches = probe_batched.LAUNCHES[name]
    out, ref = wrapper(*args), plain(*args)
    torch.cuda.synchronize()
    assert probe_batched.LAUNCHES[name] == launches + 1
    if name in ("v1", "v2"):
        out, ref = (out,), (ref,)
    for o, r in zip(out, ref):
        assert o.device.type == "cuda" and o.dtype == r.dtype
        assert torch.equal(o, r)


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
