"""TCI2 at ranks above 256 on the port's own tiers, on the CPU.

The whole-sweep engine's capacity follows ``capacity_limit()`` (the panel
edge and the device's memory) in place of a fixed 256; above 256 it grows
by doubling. Held here: the engine at a capacity above 256 gives the
per-bond fused tier's ranks, errors and pivot sets on the same seed (a
random table, whose ranks are the unfoldings' full ranks or the cap);
sampling in chunks of rows gives the one-call panel bit for bit; the
limit and the growth; and the counters of the sampling layer and the
fused tier, with the span ``tci.fused.bond``. The per-bond tiers are also
held against ``tci_tpu``'s, which forms the same union of candidates, on
the same table and seed; and rook pivoting on the engine above 256 forms
that union too, as the per-bond rook tier does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tci_tpu
import tci_tpu_torch
from tci_tpu.parallel.batcheval import JaxBatchEvaluator
from tci_tpu_torch.models import device_sweep, integration, tensorci2
from tci_tpu_torch.models.device_sweep import DeviceSweepEngine
from tci_tpu_torch.ops import fused
from tci_tpu_torch.ops.fused import sample_panel
from tci_tpu_torch.parallel.batcheval import TorchBatchEvaluator

torch.set_num_threads(1)


def random_f(L, seed=0):
    """f(sigma) = T[sum_i sigma_i 2^i], T uniform on [-1, 1)."""
    T = torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, 2**L))
    place = 2 ** torch.arange(L, dtype=torch.int64)
    return lambda idx: T[(idx * place).sum(1)]


def random_f_jax(L, seed=0):
    """random_f for ``tci_tpu``: the same table, on one multi-index."""
    T = jnp.asarray(np.random.default_rng(seed).uniform(-1, 1, 2**L))
    place = 2 ** np.arange(L)
    return lambda idx: T[jnp.sum(idx * place)]


def lorentz(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(dim=1))


def _solve(f, dims, imax=None, imax_cap=None, **kwargs):
    ev = TorchBatchEvaluator(f, dims, device="cpu")
    if imax is not None or imax_cap is not None:
        ev._device_sweep_engine = DeviceSweepEngine(
            ev._values, dims, imax=imax or 32, imax_cap=imax_cap,
            device="cpu")
    bonds = fused.FUSED_BONDS["bonds"]
    tci, ranks, errors = tensorci2.crossinterpolate2(
        np.float64, ev, dims, device="cpu", rng=np.random.default_rng(3),
        **kwargs)
    return tci, ranks, errors, ev, fused.FUSED_BONDS["bonds"] - bonds


@pytest.mark.parametrize("maxbonddim", [64, 24])
def test_engine_above_256_matches_the_per_bond_tier(maxbonddim):
    # L = 10: full ranks 2 ... 32 ... 2; at 24 the middle bonds are cut
    dims = [2] * 10
    kw = {"tolerance": 1e-12, "maxbonddim": maxbonddim}
    high, hranks, herrs, hev, hbonds = _solve(random_f(10), dims, imax=288,
                                              **kw)
    low, lranks, lerrs, _, lbonds = _solve(random_f(10), dims, imax=2,
                                           imax_cap=2, **kw)
    assert hev.device_sweep_engine.Imax == 288 and hbonds == 0
    assert lbonds > 0
    assert hranks == lranks
    assert herrs == lerrs
    assert high.Iset == low.Iset and high.Jset == low.Jset
    assert high.linkdims() == low.linkdims() == [
        min(maxbonddim, 2 ** (b + 1), 2 ** (9 - b)) for b in range(9)]
    # tci_tpu's per-bond tier forms the same union (tensorci2.jl:842-843)
    ref, rranks, rerrs = tci_tpu.crossinterpolate2(
        np.float64, JaxBatchEvaluator(random_f_jax(10), dims,
                                      enable_device_sweep=False),
        dims, rng=np.random.default_rng(3), **kw)
    assert hranks == rranks
    assert high.Iset == ref.Iset and high.Jset == ref.Jset
    # the last pivots round apart by ~2e-16 relative in the two packages
    np.testing.assert_allclose(herrs, rerrs, rtol=1e-12, atol=0)


@pytest.mark.parametrize("maxbonddim", [64, 24])
def test_rook_above_256_forms_the_union(maxbonddim):
    # rook's candidates above QUANTUM_CAP are the union, as the per-bond
    # rook tier forms it (held to tci_tpu's by test_torch_rook_tci.py): a
    # bond saturated at full rank reports 0 (with the repeated history
    # candidates it reported ~3e-16 here). Each tier draws its own start
    # sets, so at the cap of 24, where those decide the pivots, the solves
    # meet at the end
    dims = [2] * 10
    kw = {"tolerance": 1e-12, "maxbonddim": maxbonddim,
          "pivotsearch": "rook"}
    high, hranks, herrs, hev, _ = _solve(random_f(10), dims, imax=288, **kw)
    assert hev.device_sweep_engine.Imax == 288
    assert any(k[-1] == "rook" for k in hev.device_sweep_engine._sweeps)
    with pytest.warns(RuntimeWarning, match="per-bond rook tier"):
        low, lranks, lerrs, _, _ = _solve(random_f(10), dims, imax=2,
                                          imax_cap=2, **kw)
    if maxbonddim == 64:
        assert hranks == lranks
        np.testing.assert_allclose(herrs, lerrs, rtol=1e-12, atol=0)
        assert herrs[-1] == 0.0
    assert hranks[-1] == lranks[-1]
    np.testing.assert_allclose(herrs[-1], lerrs[-1], rtol=1e-12, atol=0)
    assert high.linkdims() == low.linkdims() == [
        min(maxbonddim, 2 ** (b + 1), 2 ** (9 - b)) for b in range(9)]


def test_chunked_sampling_is_the_one_call_panel_bit_for_bit(monkeypatch):
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(rng.integers(0, 2, size=(37, 3)))
    cols = torch.from_numpy(rng.integers(0, 2, size=(29, 4)))
    batched = (torch.from_numpy(rng.integers(0, 2, size=(2, 37, 3))),
               torch.from_numpy(rng.integers(0, 2, size=(2, 29, 4))))
    whole = [sample_panel(f, r, c, torch.float64)
             for f in (lorentz, random_f(7))
             for r, c in ((rows, cols), batched)]
    before = fused.INDEX_BYTES["formed"]
    # 3 rows of 29 indices of 7 a chunk at most: 13 calls a panel
    monkeypatch.setattr(fused, "INDEX_CHUNK_BYTES", 3 * 29 * 7 * 8 * 2)
    calls = []

    def counting(f):
        def g(idx):
            calls.append(idx.shape[0])
            return f(idx)
        return g

    chunked = [sample_panel(counting(f), r, c, torch.float64)
               for f in (lorentz, random_f(7))
               for r, c in ((rows, cols), batched)]
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    assert max(calls) <= 3 * 29 * 2 and len(calls) > 4 * 2
    # every chunk's bytes are counted: 2 panels of 37 x 29 and 2 of 2 x 37
    # x 29, 7 indices of 8 bytes a point
    assert fused.INDEX_BYTES["formed"] - before == 2 * 3 * 37 * 29 * 7 * 8


def test_a_chunked_engine_gives_the_same_solve(monkeypatch):
    dims = [2] * 9
    kw = {"tolerance": 1e-12, "maxbonddim": 12}
    ref, rranks, rerrs, _, _ = _solve(random_f(9), dims, **kw)
    # the fill's and every panel's index matrix in chunks of a few rows
    monkeypatch.setattr(fused, "INDEX_CHUNK_BYTES", 4096)
    out, oranks, oerrs, _, _ = _solve(random_f(9), dims, **kw)
    assert oranks == rranks and oerrs == rerrs
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    for a, b in zip(out.sitetensors(), ref.sitetensors()):
        assert torch.equal(a, b)


def test_the_capacity_limit_follows_the_panel_edge_and_the_memory():
    engine = DeviceSweepEngine(lorentz, [2] * 20, device="cpu")
    # panel edge 4096 over d + 1
    assert engine.capacity_limit() == 1344
    assert DeviceSweepEngine(lorentz, [15] * 10,
                             device="cpu").capacity_limit() == 256
    assert DeviceSweepEngine(lorentz, [10] * 8,
                             device="cpu").capacity_limit() == 352
    # a device whose memory holds less: the largest program that fits
    engine._memory = 2 * device_sweep.program_bytes([2] * 20, 512, 8)
    assert engine.capacity_limit() == 512
    engine.imax_cap = 300
    assert engine.capacity_limit() == 300


def test_growth_keeps_the_quantum_below_256_and_doubles_above():
    engine = DeviceSweepEngine(lorentz, [2] * 20, imax=64, device="cpu")
    assert engine._grow(1000) and engine.Imax == 96
    engine.Imax = 256
    assert engine._grow(1000) and engine.Imax == 512
    # no further than the cap needs
    assert engine._grow(1000) and engine.Imax == 1024
    # to the limit where twice would pass it, then no more
    assert engine._grow(4000) and engine.Imax == 1344
    assert not engine._grow(4000)
    engine.Imax, engine.imax_cap = 256, 256
    assert not engine._grow(1000)


def test_index_bytes_count_replays_and_not_the_gk_panel(monkeypatch):
    dims = [2] * 6
    ev = TorchBatchEvaluator(random_f(6), dims, device="cpu")
    engine = ev.device_sweep_engine
    capturing = [False]
    monkeypatch.setattr(fused, "indexed", _indexed_on(lambda: capturing[0]))
    monkeypatch.setattr(device_sweep, "indexed", fused.indexed)

    def capture(body):
        # a graph's capture records the body's work and runs none of it (the
        # input records are put back); the work runs at each replay without
        # the host: what the body counts goes to "captured"
        saved = [(p, p._record.clone()) for p in engine._sweeps.values()]
        capturing[0] = True
        try:
            out = body()
        finally:
            capturing[0] = False
        for p, record in saved:
            p._record.copy_(record)

        def replay():
            capturing[0] = True
            try:
                for o, new in zip(out, body()):
                    if isinstance(o, torch.Tensor):
                        o.copy_(new)
            finally:
                capturing[0] = False
        return replay, out

    engine.cuda_graphs = True
    engine._capture = capture
    before = dict(fused.INDEX_BYTES)
    tci_tpu_torch.crossinterpolate2(np.float64, ev, dims, tolerance=1e-12,
                                    device="cpu",
                                    rng=np.random.default_rng(0))
    formed = fused.INDEX_BYTES["formed"] - before.get("formed", 0)
    captured = fused.INDEX_BYTES["captured"] - before.get("captured", 0)
    replays = sum(p.replays for p in engine._sweeps.values())
    assert replays > 0 and captured > 0
    # each replay reports what its capture recorded, nothing else counts
    assert formed == sum(p.replays * p.captured_index_bytes
                         for p in engine._sweeps.values())
    # the GK integrand's panels go through its panel entry: none formed for
    # them (its fill and search still form index matrices)
    rows = torch.zeros((5, 2), dtype=torch.int64)
    cols = torch.zeros((4, 1), dtype=torch.int64)

    def f(idx):
        raise AssertionError("an index matrix was formed")
    f._tci_panel = lambda r, c: torch.ones(r.shape[0] * c.shape[0],
                                           dtype=torch.float64)
    start = fused.INDEX_BYTES["formed"]
    assert sample_panel(f, rows, cols, torch.float64).shape == (5, 4)
    assert fused.INDEX_BYTES["formed"] == start


def _indexed_on(capturing):
    """``fused.indexed`` with the capture state of the stand-in graph."""
    def indexed(f, idx):
        nbytes = idx.numel() * idx.element_size()
        if capturing():
            fused.INDEX_BYTES["captured"] += nbytes
        else:
            fused.count_index_replay(nbytes)
        return f(idx)
    return indexed


def test_no_bond_goes_to_the_fused_tier_on_the_benchmarks_paths():
    before = fused.FUSED_BONDS["bonds"]
    ev = TorchBatchEvaluator(lorentz, [4] * 5, device="cpu")
    tci_tpu_torch.crossinterpolate2(np.float64, ev, [4] * 5,
                                    tolerance=1e-8, device="cpu",
                                    rng=np.random.default_rng(0))

    def f(X):
        return torch.cos(10.0 * (X ** 2).sum(1)) * torch.exp(
            -X.sum(1) ** 4 / 1000)
    integration.integrate(np.float64, f, [-1.0] * 3, [1.0] * 3,
                          GKorder=15, torch_native=True, tolerance=1e-8,
                          maxbonddim=64, device="cpu",
                          rng=np.random.default_rng(0))
    assert fused.FUSED_BONDS["bonds"] == before


def test_the_fused_tier_counts_its_bonds_in_spans():
    from torch.profiler import ProfilerActivity, profile
    from tci_tpu_torch.utils import trace
    dims = [2] * 6
    traced = trace.fused_bonds_traced()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, _, _, bonds = _solve(random_f(6), dims, imax=2, imax_cap=2,
                                   tolerance=1e-12)
    assert bonds > 0
    assert trace.fused_bonds_traced() - traced == bonds
    spans = [e for e in prof.events() if e.name == "tci.fused.bond"]
    assert len(spans) == bonds


def test_cut_panels_give_the_padded_panels_solve_bit_for_bit(monkeypatch):
    # at capacity 288 each panel is sampled only where its sets can hold
    # distinct rows; with every edge at its padded extent, the padded panels
    dims = [2] * 10
    kw = {"tolerance": 1e-12, "maxbonddim": 24}
    cut, cranks, cerrs, cev, _ = _solve(random_f(10, 1), dims, imax=288, **kw)
    monkeypatch.setattr(device_sweep._Layout, "edge",
                        lambda self, count, full: full)
    pad, pranks, perrs, pev, _ = _solve(random_f(10, 1), dims, imax=288, **kw)
    assert cranks == pranks and cerrs == perrs
    assert cut.Iset == pad.Iset and cut.Jset == pad.Jset
    for a, b in zip(cut.sitetensors(), pad.sitetensors()):
        assert torch.equal(a, b)
    # the cut engine counts the samples it took, far fewer
    assert cev.nevals < pev.nevals / 4


def test_the_union_by_keys_is_the_union_by_entries():
    # above 2^62 multi-indices of a side the keys give way to comparing
    # every entry; both find the same repeats
    dims, Imax = [3] * 8, 288
    lay = device_sweep._Layout(dims, Imax, torch.device("cpu"))
    rng = np.random.default_rng(4)
    L = len(dims)

    def sets():
        buf = torch.from_numpy(rng.integers(0, 3, size=(L, Imax, L)))
        return buf, torch.from_numpy(rng.integers(1, Imax, size=L))

    Iset, Ilen = sets()
    Jset, Jlen = sets()
    eI, eIlen = sets()
    eJ, eJlen = sets()
    # history rows that repeat the sets' rows
    eI[:, :40] = Iset[:, :40]
    eJ[:, :40] = torch.roll(Jset[:, :40], 1, -1)
    exlens = torch.stack([eIlen[1:], eJlen[:-1]], dim=1)[:, :, None]
    for b in range(L - 1):
        keyed = device_sweep._candidates(lay, Iset, Ilen, Jset, Jlen, eI, eJ,
                                         exlens, b, union=True)
        radix, lay.radix = lay.radix, {}
        plain = device_sweep._candidates(lay, Iset, Ilen, Jset, Jlen, eI, eJ,
                                         exlens, b, union=True)
        lay.radix = radix
        assert radix and all(torch.equal(x, y) for x, y in zip(keyed, plain))
        full = device_sweep._candidates(lay, Iset, Ilen, Jset, Jlen, eI, eJ,
                                        exlens, b)
        assert (keyed[2] <= full[2]).all()
