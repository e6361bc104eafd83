"""The port's device tiers of TCI2 (the whole-sweep engine,
tci_tpu_torch.models.device_sweep, and the per-bond fused tier) against
tci_tpu's, on the CPU.

Both packages run ``crossinterpolate2`` with their device evaluator
(``TorchBatchEvaluator(device="cpu")`` and ``JaxBatchEvaluator``) and the
same ``rng`` seed. Both engines run with ``use_sweep_pair`` and
``use_optimize_loop`` off: the per-sweep protocol, which
tests/test_torch_optimize_loop.py holds against the default one.

Tolerances: ranks, pivot sets and sample counts identical; errors to 1e-15
absolute (normalized), the rounding of the Schur updates
(tests/test_torch_tensorci2.py); the full tensors to rtol 1e-10.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tci_tpu
import tci_tpu_torch
from tci_tpu.models.device_sweep import DeviceSweepEngine as JaxEngine
from tci_tpu.parallel.batcheval import JaxBatchEvaluator
from tci_tpu_torch.models import device_sweep
from tci_tpu_torch.models.device_sweep import DeviceSweepEngine
from tci_tpu_torch.ops import lu_kernel

torch.set_num_threads(1)

ERR_ATOL = 1e-15


def lorentz_jax(idx):
    v = idx.astype(jnp.float64) + 1.0
    return 1.0 / (1.0 + jnp.sum(v * v))


def lorentz_torch(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(dim=1))


def _full(tci, dims):
    pts = np.asarray(list(itertools.product(*map(range, dims))))
    return tci_tpu_torch.TensorTrain(tci.sitetensors()).evaluate_batch(
        pts).numpy().reshape(dims)


# case: (dims, crossinterpolate2 arguments, engine on, engine imax, imax_cap)
CASES = {
    "engine": ([4] * 5, {"tolerance": 1e-10}, True, None, None),
    "fused": ([4] * 5, {"tolerance": 1e-10}, False, None, None),
    # local dimensions below dmax: the engine's padding slots at every bond
    "nonuniform": ([2, 5, 3, 4, 2], {"tolerance": 1e-10}, True, None, None),
    "maxbonddim3": ([4] * 5, {"tolerance": 1e-12, "maxbonddim": 3}, True,
                    None, None),
    # tests/test_device_sweep.py's truncation case, through the three
    # iterations before the global search meets a tie (ROADMAP C-port-5)
    "maxbonddim3_d6": ([6] * 4, {"tolerance": 1e-12, "maxbonddim": 3,
                                 "maxiter": 3}, True, None, None),
    # the capacity grows from 2 (tests/test_device_sweep.py) ...
    "growth": ([4] * 4, {"tolerance": 1e-12}, True, 2, 256),
    # ... or, capped at 2, the engine declines and the fused tier runs
    "decline": ([4] * 4, {"tolerance": 1e-12}, True, 2, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_crossinterpolate2_matches_tci_tpu(case):
    dims, kwargs, sweep, imax, imax_cap = CASES[case]
    bj = JaxBatchEvaluator(lorentz_jax, dims, enable_device_sweep=sweep)
    bt = tci_tpu_torch.TorchBatchEvaluator(lorentz_torch, dims, device="cpu",
                                           enable_device_sweep=sweep)
    if imax is not None:
        bj._device_sweep_engine = JaxEngine(lorentz_jax, dims, imax=imax,
                                            imax_cap=imax_cap)
        bt._device_sweep_engine = DeviceSweepEngine(
            bt._values, dims, imax=imax, imax_cap=imax_cap, device="cpu")
    if sweep:
        for b in (bj, bt):
            b.device_sweep_engine.use_sweep_pair = False
            b.device_sweep_engine.use_optimize_loop = False
    ref, rranks, rerrs = tci_tpu.crossinterpolate2(
        np.float64, bj, dims, rng=np.random.default_rng(0), **kwargs)
    out, oranks, oerrs = tci_tpu_torch.crossinterpolate2(
        np.float64, bt, dims, rng=np.random.default_rng(0), device="cpu",
        **kwargs)
    assert oranks == rranks
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    np.testing.assert_allclose(oerrs, rerrs, rtol=0, atol=ERR_ATOL)
    np.testing.assert_allclose(
        _full(out, dims), tci_tpu.fulltensor(tci_tpu.tensortrain(ref)),
        rtol=1e-10, atol=0)
    assert bt.nevals == bj.nevals
    engine = bt.device_sweep_engine
    if case.startswith("maxbonddim3"):
        assert out.linkdims() == [3] * (len(dims) - 1)
    if case == "growth":
        assert engine.Imax == bj.device_sweep_engine.Imax > 2
    if case == "decline":
        assert engine.Imax == 2 and engine.nevals == 0
    if case in ("fused", "decline"):
        assert bt.fused_updater.rrlu_calls > 0
    else:
        assert bt._fused_updater is None and engine.rrlu_calls > 0


def test_sweep_is_one_fetch():
    """One engine sweep, with or without the fill, ends in one fetch; its
    L-1 bond eliminations (and the fill's one batched elimination) are
    queued without any, and the fill alone fetches nothing."""
    dims = [4] * 5
    bf = tci_tpu_torch.TorchBatchEvaluator(lorentz_torch, dims, device="cpu")
    tci = tci_tpu_torch.TensorCI2.from_function(bf, dims, device="cpu")
    engine = bf.device_sweep_engine
    empty = [[] for _ in dims]
    for fwd, fill in ((True, False), (False, True)):
        fetches, calls = device_sweep.FETCHES["engine"], engine.rrlu_calls
        plain = lu_kernel.PLAIN_CALLS["cpu"]
        assert engine.sweep2site(tci, fwd, 1e-14, 0.0, 2**62, empty, empty,
                                 fill_sites=fill)
        assert device_sweep.FETCHES["engine"] == fetches + 1
        added = len(dims) - 1 + int(fill)
        assert engine.rrlu_calls == calls + added
        # on the CPU the batched fill runs the plain version once a block
        assert lu_kernel.PLAIN_CALLS["cpu"] - plain == (
            len(dims) - 1 + (len(dims) - 1 if fill else 0))
    assert tci.issitetensorsavailable()
    fetches = device_sweep.FETCHES["engine"]
    assert engine.fillsitetensors(tci)
    assert device_sweep.FETCHES["engine"] == fetches
    assert engine.sweep1site(tci, True, 1e-14, 0.0, 2**62)
    assert device_sweep.FETCHES["engine"] == fetches + 1


def test_engine_sweep_drops_site_tensors_of_a_per_bond_sweep():
    """sweep2site of two sweeps without the fill: the first needs capacity 6
    and runs per bond on the fused tier (which sets site tensors), the second
    fits the capacity of 4 and runs on the engine, which must leave every
    site tensor invalidated, as tci_tpu does (ROADMAP C-port-6)."""
    dims = [4] * 5
    w = np.array([1.0, 0.7, 0.4, 0.3, 0.2])
    pivots = [tuple(int(v) for v in p) for p in
              np.random.default_rng(1).integers(0, 4, size=(6, 5))]
    wj, wt = jnp.asarray(w), torch.from_numpy(w)

    def fj(idx):
        return 1.0 / (1.0 + jnp.sum(wj * (idx.astype(jnp.float64) + 1.0)) ** 2)

    def ft(idx):
        return 1.0 / (1.0 + ((idx.to(torch.float64) + 1.0) * wt).sum(1) ** 2)

    bj = JaxBatchEvaluator(fj, dims)
    bj._device_sweep_engine = JaxEngine(fj, dims, imax_cap=4)
    bj.device_sweep_engine.use_sweep_pair = False
    bt = tci_tpu_torch.TorchBatchEvaluator(ft, dims, device="cpu")
    bt._device_sweep_engine = DeviceSweepEngine(bt._values, dims, imax_cap=4,
                                                device="cpu")
    ref = tci_tpu.TensorCI2.from_function(bj, dims, pivots)
    out = tci_tpu_torch.TensorCI2.from_function(bt, dims, pivots,
                                                device="cpu")
    for tci, f in ((ref, bj), (out, bt)):
        tci.sweep2site(f, 2, abstol=1e-12, maxbonddim=2, strictlynested=True,
                       fillsitetensors=False)
    # the first sweep ran per bond, the second on the engine
    assert bt.fused_updater.rrlu_calls == len(dims) - 1
    assert bt.device_sweep_engine.rrlu_calls == len(dims) - 1
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    for b in range(len(dims)):
        assert tuple(ref._sitetensors[b].shape) == (0, 0, 0)
        assert tuple(out._sitetensors[b].shape) == (0, 0, 0)


def test_complex_tiers_are_not_ported():
    """(Named when the device tiers refused complex, ROADMAP A10.) A complex
    evaluator now runs on them: the engine's and the fused tier's result is
    the host tier's on the same complex f (ranks identical, the tensor
    trains to 1e-12 of max|f|), with the engine's and the fused tier's own
    eliminations."""
    dims = [3] * 4

    def g(idx):
        return (idx.sum(1) + 1.0j).to(torch.complex128)

    runs = []
    for f in (tci_tpu_torch.TorchBatchEvaluator(
                  g, dims, dtype=torch.complex128, device="cpu"),
              tci_tpu_torch.TorchBatchEvaluator(
                  g, dims, dtype=torch.complex128, device="cpu",
                  enable_device_sweep=False),
              lambda x: complex(sum(x) + 1.0j)):
        t, ranks, _ = tci_tpu_torch.crossinterpolate2(
            np.complex128, f, dims, device="cpu",
            rng=np.random.default_rng(0))
        runs.append((ranks, tci_tpu_torch.fulltensor(
            tci_tpu_torch.tensortrain(t)), f))
    (re, fe, bfe), (rf, ff, bff), (rh, fh, _) = runs
    assert re == rf == rh
    assert bfe.device_sweep_engine.rrlu_calls > 0
    assert bff.fused_updater.rrlu_calls > 0
    scale = float(fh.abs().max())
    for full in (fe, ff):
        assert full.dtype == torch.complex128
        assert float((full - fh).abs().max()) <= 1e-12 * scale


def test_engine_counts_repeated_history_candidates_c_ref_8():
    """C-ref-8: tci_tpu's engine counts a history candidate that repeats a
    kron candidate in a bond's extents, where the union the reference
    forms does not (tensorci2.jl:842-843). A bond whose rank reaches the
    union's size at the rank cap then reports its last pivot's magnitude as
    its error, where the per-bond tier reports 0. On a random table at L =
    10 and cap 32 (the middle bond's full rank) both packages agree tier by
    tier; the port's engine forms the union only above capacity 256
    (tests/test_torch_high_rank.py)."""
    dims = [2] * 10
    T = np.random.default_rng(0).uniform(-1, 1, 2**10)
    place = 2 ** np.arange(10)
    Tj, Tt = jnp.asarray(T), torch.from_numpy(T)

    def fj(idx):
        return Tj[jnp.sum(idx * place)]

    def ft(idx):
        return Tt[(idx * torch.from_numpy(place)).sum(1)]

    errors = {}
    for tier, sweep in (("engine", True), ("fused", False)):
        bj = JaxBatchEvaluator(fj, dims, enable_device_sweep=sweep)
        bt = tci_tpu_torch.TorchBatchEvaluator(ft, dims, device="cpu",
                                               enable_device_sweep=sweep)
        if sweep:
            for b in (bj, bt):
                b.device_sweep_engine.use_sweep_pair = False
                b.device_sweep_engine.use_optimize_loop = False
        _, rranks, rerrs = tci_tpu.crossinterpolate2(
            np.float64, bj, dims, tolerance=1e-12, maxbonddim=32,
            rng=np.random.default_rng(1))
        _, oranks, oerrs = tci_tpu_torch.crossinterpolate2(
            np.float64, bt, dims, tolerance=1e-12, maxbonddim=32,
            device="cpu", rng=np.random.default_rng(1))
        assert oranks == rranks
        # the last pivots are O(0.1) here: their Schur updates round apart
        # by ~3e-14 relative in the two packages
        np.testing.assert_allclose(oerrs, rerrs, rtol=1e-12, atol=ERR_ATOL)
        errors[tier] = oerrs
    assert errors["engine"][-1] > 0.01
    assert errors["fused"][-1] == 0.0
