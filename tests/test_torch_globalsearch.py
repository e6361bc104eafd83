"""The floating-zone search of tci_tpu_torch against tci_tpu's (the port on
device="cpu"): the host lock-step search ``_floatingzone_batch``, the
sequential ``_floatingzone``, ``estimatetrueerror`` on the host path, the
engine's floating-zone program, and the complex train that the program
declines.

Tolerances: the host searches' pivots identical and their errors within
1e-12 relative (|f - tt| is O(1) on these fixtures; the TT products round
at 1e-16). The engine's program against tci_tpu's engine, as tci_tpu's own
tests hold its engine (test_globalsearch.test_estimatetrueerror_device_tier):
best pivot identical, best error within 1e-10 relative, every (pivot,
error) within 1e-9 of |f - tt| recomputed, sorted descending; against the
port's host lock-step search from the same starts, which evaluates the TT
through the same function on the same padded cores: identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tci_tpu
import tci_tpu_torch
from tci_tpu.models.globalsearch import _floatingzone as jax_fz
from tci_tpu.models.globalsearch import _floatingzone_batch as jax_fzb
from tci_tpu.parallel.batcheval import JaxBatchEvaluator
from tci_tpu_torch.models.globalsearch import _floatingzone, _floatingzone_batch
from tci_tpu_torch.utils.device import FETCHES

from test_torch_engine_programs import emulate_graphs

torch.set_num_threads(1)


def _random_train(seed=0, L=8, d=3, chi=4):
    """test_globalsearch.test_floatingzone_batch_matches_sequential's train,
    f and starts."""
    rng = np.random.default_rng(seed)
    cores = [rng.standard_normal((1 if l == 0 else chi, d,
                                  1 if l == L - 1 else chi))
             for l in range(L)]
    initps = [tuple(int(rng.integers(0, d)) for _ in range(L))
              for _ in range(12)]
    return cores, initps


def _f(idx):
    return float(np.cos(np.sum(np.asarray(idx) ** 2)) + 0.1 * np.sum(idx))


def _same(out, ref, rtol=1e-12):
    assert len(out) == len(ref)
    for (p1, e1), (p2, e2) in zip(out, ref):
        assert p1 == p2
        assert abs(e1 - e2) <= rtol * abs(e2)


@pytest.mark.parametrize("tol,nsweeps", [(float("inf"), 2**62), (0.5, 100),
                                         (float("inf"), 1)])
def test_floatingzone_batch_and_sequential_match(tol, nsweeps):
    cores, initps = _random_train()
    ref_tt = tci_tpu.TensorTrain(cores)
    tt = tci_tpu_torch.TensorTrain(cores, device="cpu")
    ref = jax_fzb(ref_tt, _f, initps, earlystoptol=tol, nsweeps=nsweeps)
    out = _floatingzone_batch(tt, _f, initps, earlystoptol=tol,
                              nsweeps=nsweeps)
    _same(out, ref)
    cache = tci_tpu_torch.TTCache(tt)
    ref_cache = tci_tpu.TTCache(ref_tt)
    seq = [_floatingzone(cache, _f, initp=p, earlystoptol=tol,
                         nsweeps=nsweeps) for p in initps[:4]]
    ref_seq = [jax_fz(ref_cache, _f, initp=p, earlystoptol=tol,
                      nsweeps=nsweeps) for p in initps[:4]]
    _same(seq, ref_seq)
    _same(seq, out[:4])


def test_estimatetrueerror_host_path_matches():
    cores, _ = _random_train(seed=3, L=6, d=4, chi=3)
    ref = tci_tpu.estimatetrueerror(tci_tpu.TensorTrain(cores), _f,
                                    nsearch=20, rng=np.random.default_rng(5))
    out = tci_tpu_torch.estimatetrueerror(cores, _f, nsearch=20,
                                          rng=np.random.default_rng(5),
                                          device="cpu")
    _same(out, ref)
    errs = [e for _, e in out]
    assert errs == sorted(errs, reverse=True)
    with pytest.raises(ValueError, match="No search"):
        tci_tpu_torch.estimatetrueerror(cores, _f, nsearch=0, device="cpu")


def _fj(idx):
    v = idx.astype(jnp.float64) + 1.0
    return 1.0 / (1.0 + jnp.sum(v * v)) + 0.05 * jnp.cos(
        2.7 * jnp.prod(v) ** 0.5)


def _ft(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(1)) + 0.05 * torch.cos(
        2.7 * v.prod(1) ** 0.5)


@pytest.fixture(scope="module")
def engine_case():
    """test_globalsearch's device-tier fixture ([4]^5): tci_tpu's TT at
    maxbonddim 4 (through its engine), and twelve starts."""
    localdims = [4] * 5
    bf = JaxBatchEvaluator(_fj, localdims)
    t, _, _ = tci_tpu.crossinterpolate2(
        np.float64, bf, localdims, tolerance=1e-2, maxbonddim=4,
        rng=np.random.default_rng(0))
    starts = [tuple(int(x) for x in row)
              for row in np.random.default_rng(3).integers(0, 4, (12, 5))]
    return localdims, [np.asarray(c) for c in t.sitetensors()], starts, bf


def test_engine_floatingzone_matches_tci_tpu(engine_case):
    """The port's program against tci_tpu's on a random rank-3 train, where
    |f - tt| is O(1) at every point. (On a TCI's own train the single-
    coordinate variants of a pivot are interpolated exactly, their errors
    are rounding noise, and the first maximum among them follows each
    package's rounding: the two searches may then leave such a start in
    different directions.)"""
    localdims, _, starts, jbf = engine_case
    cores = _random_train(seed=8, L=5, d=4, chi=3)[0]
    ref = tci_tpu.estimatetrueerror(tci_tpu.TensorTrain(cores), jbf,
                                    initialpoints=starts)
    bf = tci_tpu_torch.TorchBatchEvaluator(_ft, localdims, device="cpu")
    tt = tci_tpu_torch.TensorTrain(cores, device="cpu")
    out = tci_tpu_torch.estimatetrueerror(tt, bf, initialpoints=starts)
    assert [p["key"] for p in bf.device_sweep_engine.programs()] == [
        ("fzone", 12, 8)]
    assert out[0][0] == ref[0][0]
    assert abs(out[0][1] - ref[0][1]) <= 1e-10 * ref[0][1]
    for p, e in out:
        true = abs(_ft(torch.tensor([p]))[0].item() - tt(p))
        assert abs(true - e) <= 1e-9 * true


@pytest.mark.parametrize("graphs", [True, False])
def test_engine_floatingzone_matches_host_search(engine_case, graphs):
    """On a TCI's train: the program against the port's host lock-step
    search from the same starts (identical: the same TT evaluation on the
    same padded cores), one fetch and a status read a sweep, self-consistent
    and sorted; held as a graph (``emulate_graphs``: recorded at its first
    use, replayed at every sweep) and eagerly."""
    localdims, cores, starts, _ = engine_case
    bf = tci_tpu_torch.TorchBatchEvaluator(_ft, localdims, device="cpu")
    engine = bf.device_sweep_engine
    if graphs:
        emulate_graphs(engine)
    tt = tci_tpu_torch.TensorTrain(cores, device="cpu")
    fetches, reads = FETCHES["engine"], FETCHES["engine_status"]
    out = tci_tpu_torch.estimatetrueerror(tt, bf, initialpoints=starts)
    (prog,) = engine.programs()
    assert prog["key"] == ("fzone", 12, 8)
    assert FETCHES["engine"] == fetches + 1
    assert FETCHES["engine_status"] - reads == prog["uses"] > 1
    assert prog["captured"] == graphs
    assert prog["replays"] == (prog["uses"] if graphs else 0)
    errs = [e for _, e in out]
    assert errs == sorted(errs, reverse=True)
    for p, e in out:
        true = abs(_ft(torch.tensor([p]))[0].item() - tt(p))
        assert abs(true - e) <= 1e-9 * true + 1e-13
    host = _floatingzone_batch(tt, bf, starts)
    pivots, maxerr = engine.floatingzone(tt.sitetensors(),
                                         np.asarray(starts))
    assert [tuple(p) for p in pivots.tolist()] == [p for p, _ in host]
    assert maxerr.tolist() == [e for _, e in host]
    # nevals: the starts, then every sweep's S L dmax variants
    sweeps = engine._sweeps[("fzone", 12, 8)].uses / 2
    assert sweeps == int(sweeps)
    assert engine.nevals == 2 * (12 + sweeps * 12 * 5 * 4)


def test_engine_floatingzone_stops_at_nsweeps(engine_case):
    localdims, cores, starts, _ = engine_case
    bf = tci_tpu_torch.TorchBatchEvaluator(_ft, localdims, device="cpu")
    tt = tci_tpu_torch.TensorTrain(cores, device="cpu")
    engine = bf.device_sweep_engine
    for tol, n in [(float("inf"), 1), (1e-3, 100)]:
        pivots, maxerr = engine.floatingzone(tt.sitetensors(),
                                             np.asarray(starts), nsweeps=n,
                                             earlystoptol=tol)
        host = _floatingzone_batch(tt, bf, starts, earlystoptol=tol,
                                   nsweeps=n)
        assert [tuple(p) for p in pivots.tolist()] == [p for p, _ in host]
        assert maxerr.tolist() == [e for _, e in host]


def test_engine_floatingzone_declines(engine_case):
    """Where tci_tpu's engine declines, the port's does, and
    estimatetrueerror answers through the host lock-step search; a complex
    train is searched in complex128 there."""
    localdims, cores, starts, _ = engine_case
    bf = tci_tpu_torch.TorchBatchEvaluator(_ft, localdims, device="cpu")
    engine = bf.device_sweep_engine
    tt_c = tci_tpu_torch.TensorTrain(
        [c.astype(np.complex128) * (1 + 0.1j) for c in cores], device="cpu")
    z = np.zeros((4, 5), dtype=np.int64)
    assert engine.floatingzone(tt_c.sitetensors(), z) is None
    short = tci_tpu_torch.TensorTrain(cores[:4], device="cpu")
    assert engine.floatingzone(short.sitetensors(), z[:, :4]) is None
    real = tci_tpu_torch.TensorTrain(cores, device="cpu").sitetensors()
    assert engine.floatingzone(real, z[:0]) is None
    assert engine.floatingzone(real, z, nsweeps=0) is None
    assert engine.programs() == []

    out = tci_tpu_torch.estimatetrueerror(tt_c, bf, initialpoints=starts)
    f_np = lambda p: float(_ft(torch.tensor([p]))[0])
    ref = tci_tpu.estimatetrueerror(
        tci_tpu.TensorTrain([c.astype(np.complex128) * (1 + 0.1j)
                             for c in cores]), f_np, initialpoints=starts)
    _same(out, ref)
    assert engine.programs() == []
