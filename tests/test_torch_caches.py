"""TTCache, CachedFunction and the batch adapters of tci_tpu_torch against
tci_tpu's, on the same data (the port on device="cpu").

Tolerances: TTCache values to 1e-13 relative (left / right environments
multiplied in another library) with the cache sizes identical;
CachedFunction keys, contents, miss counts and keytype_bits identical (its
values are f's own); the adapters' panels identical (f per point in both).
"""

import itertools

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu.parallel.batcheval import _batchevaluate_dispatch as jax_dispatch
from tci_tpu_torch.parallel.batcheval import _batchevaluate_dispatch

torch.set_num_threads(1)


def _cores(localdims, bonddims, seed=1234):
    rng = np.random.default_rng(seed)
    return [rng.random((bonddims[n], localdims[n], bonddims[n + 1]))
            for n in range(len(localdims))]


def _cache_sizes(c):
    return [len(d) for d in c.cacheleft], [len(d) for d in c.cacheright]


# -- TTCache ------------------------------------------------------------------


@pytest.mark.parametrize("sitedims", [None, [[2, 2]] * 4])
def test_ttcache_matches(sitedims):
    """test_cachedtensortrain's fixtures: evaluation at every point, batch
    evaluation with and without a projector, the same cache fill."""
    if sitedims is None:
        localdims, proj = [2, 3, 3, 2], [[1], [0]]
    else:
        localdims, proj = [4] * 4, [[1, 1], [0, 0]]
    cores = _cores(localdims, [1, 2, 3, 2, 1])
    ref = tci_tpu.TTCache(tci_tpu.TensorTrain(cores), sitedims)
    out = tci_tpu_torch.TTCache(
        tci_tpu_torch.TensorTrain(cores, device="cpu"), sitedims)
    for i in itertools.product(*[range(d) for d in localdims]):
        idx = list(i)
        if sitedims is not None:
            idx = [(v // 2, v % 2) for v in i]
        assert out(idx) == pytest.approx(float(ref(idx)), rel=1e-13)
        assert out.evaluate(idx, usecache=False) == pytest.approx(
            float(ref.evaluate(idx, usecache=False)), rel=1e-13)
    left, right = [(0,), (1,)], [(0,), (1,)]
    for kw in ({}, {"projector": proj}):
        a = out.batch_evaluate(left, right, 2, **kw)
        b = ref.batch_evaluate(left, right, 2, **kw)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-13, atol=0)
    assert _cache_sizes(out) == _cache_sizes(ref)


def test_ttcache_batch_evaluate_every_split():
    """test_tensortrain.test_batchevaluate2: every (left, center, right)
    split of the sites."""
    localdims = [2, 3, 3, 2]
    cores = _cores(localdims, [1, 2, 3, 2, 1])
    ref = tci_tpu.TTCache(cores)
    out = tci_tpu_torch.TTCache(cores, device="cpu")
    N = len(localdims)
    for nleft in range(N + 1):
        for nright in range(N + 1 - nleft):
            ncent = N - nleft - nright
            left = list(itertools.product(*[range(d)
                                            for d in localdims[:nleft]]))
            right = list(itertools.product(*[range(d) for d in
                                             localdims[N - nright:]]))
            a = out.batch_evaluate(left, right, ncent)
            b = ref.batch_evaluate(left, right, ncent)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-13, atol=0)
    assert _cache_sizes(out) == _cache_sizes(ref)


def test_ttcache_keeps_its_tensors_on_their_device():
    cores = [torch.from_numpy(c) for c in _cores([2, 3, 2], [1, 2, 2, 1])]
    c = tci_tpu_torch.TTCache(cores)  # tensors: no device argument needed
    assert c.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in c.sitetensors)
    assert c.batch_evaluate([(0,)], [(1,)], 1).device.type == "cpu"


# -- CachedFunction -------------------------------------------------------------


class _Counting:
    """f with a count of its calls (the cache's misses)."""

    def __init__(self, f):
        self.f, self.calls = f, 0

    def __call__(self, x):
        self.calls += 1
        return self.f(x)


def _pair(f, localdims, dtype=np.float64):
    fr, fo = _Counting(f), _Counting(f)
    return (fr, tci_tpu.CachedFunction(fr, localdims, dtype=dtype),
            fo, tci_tpu_torch.CachedFunction(fo, localdims, dtype=dtype,
                                             device="cpu"))


@pytest.mark.parametrize("T", [np.float64, np.complex128])
def test_cachedfunction_matches(T):
    """Single and batched calls with repeats: the same keys, contents,
    misses and key width."""
    localdims = [2, 3, 4, 2, 3]
    f = lambda x: T(sum((i + 1) * v for i, v in enumerate(x)))
    fr, ref, fo, out = _pair(f, localdims, T)
    for x in [(0, 1, 2, 1, 0), (1, 2, 3, 0, 2), (0, 1, 2, 1, 0)]:
        assert out(x) == ref(x)
    for Iset, Jset, nc in [([(0,), (1,)], [(1,), (2,)], 3),
                           ([(0, 1)], [(2, 1, 0)], 0),
                           ([(0, 1), (1, 2), (0, 1)], [(1, 2)], 1),
                           ([(0,), (1,)], [(1,), (2,)], 3)]:
        a = _batchevaluate_dispatch(T, out, localdims, Iset, Jset, nc)
        b = jax_dispatch(T, ref, localdims, Iset, Jset, nc)
        assert a.shape == b.shape
        assert np.array_equal(a.numpy(), b)
    assert fo.calls == fr.calls
    assert out.cache == ref.cache
    assert out.cachedata() == ref.cachedata()
    assert sorted(out.cachedindices()) == sorted(ref.cachedindices())
    assert out.keytype_bits == ref.keytype_bits
    for x in [(0, 1, 2, 1, 0), (1, 0, 0, 1, 2)]:
        assert out.encodecachekey(x) == ref.encodecachekey(x)
        assert out.decodecachekey(out.encodecachekey(x)) == x
        assert out.haskey(x) == ref.haskey(x) == (x in out)
    out.clearcache()
    assert out.ncacheddata() == 0


@pytest.mark.parametrize("L", [36, 70, 256])
def test_cachedfunction_wide_keys(L):
    """Keys stay Python ints past 2^63 (a quantics grid of R >= 64 legs):
    the same keys and key width as tci_tpu, through single and batched
    calls."""
    f = lambda x: float(sum(x)) + 0.5
    fr, ref, fo, out = _pair(f, [2] * L)
    high = tuple([1] * L)
    assert out._key(high) == ref._key(high) == 2**L - 1
    assert out.keytype_bits == ref.keytype_bits
    assert out(high) == ref(high)
    Iset = [tuple([1] * (L - 2)), tuple([0] * (L - 2))]
    Jset = [(1,), (0,)]
    a = out.batch_evaluate(Iset, Jset, 1)
    b = ref.batch_evaluate(Iset, Jset, 1)
    assert np.array_equal(a.numpy(), b)
    assert fo.calls == fr.calls
    assert out.cache == ref.cache
    assert all(isinstance(k, int) for k in out.cache)
    with pytest.raises(ValueError):
        out._key(tuple([0] * (2 * L)))


def test_cachedfunction_over_a_batch_evaluator():
    """f with evaluate_many (a TorchBatchEvaluator): its misses in one
    batched call, the values on the CachedFunction's device."""
    localdims = [3, 4, 3]

    def ftorch(idx):
        return (idx.to(torch.float64) * torch.tensor([1.0, 10.0, 100.0])
                ).sum(1)

    bf = tci_tpu_torch.TorchBatchEvaluator(ftorch, localdims, device="cpu")
    cf = tci_tpu_torch.CachedFunction(bf, localdims, device="cpu")
    panel = cf.batch_evaluate([(0,), (2,)], [(1,)], 1)
    assert panel.device.type == "cpu"
    expected = np.array([[[1 * i + 10 * j + 100 for j in range(4)]]
                         for i in (0, 2)]).reshape(2, 4, 1)
    assert np.array_equal(panel.numpy(), expected)
    assert bf.nevals == 8 and cf.ncacheddata() == 8
    cf.batch_evaluate([(0,), (2,)], [(1,)], 1)
    assert bf.nevals == 8


def test_cachedfunction_through_the_host_tier():
    """A CachedFunction around a scalar f through crossinterpolate2's host
    tier: the plain f's ranks and error series, and the cache holds every
    distinct point sampled."""
    dims = [4] * 5
    f = lambda x: 1.0 / (1.0 + sum((i + 1.0) ** 2 for i in x))
    seen = set()

    def g(x):
        seen.add(tuple(x))
        return f(x)

    cf = tci_tpu_torch.CachedFunction(g, dims, device="cpu")
    _, ranks, errs = tci_tpu_torch.crossinterpolate2(
        np.float64, cf, dims, tolerance=1e-8, rng=np.random.default_rng(0),
        device="cpu")
    _, pranks, perrs = tci_tpu_torch.crossinterpolate2(
        np.float64, f, dims, tolerance=1e-8, rng=np.random.default_rng(0),
        device="cpu")
    assert ranks == pranks and errs == perrs
    assert cf.ncacheddata() == len(seen)


# -- adapters ---------------------------------------------------------------------


@pytest.mark.parametrize("adapter", ["BatchEvaluatorAdapter",
                                     "makebatchevaluatable",
                                     "ThreadedBatchEvaluator"])
def test_adapters_match(adapter):
    localdims = [3, 2, 4, 2]
    f = lambda x: float(np.cos(sum((i + 1) * v for i, v in enumerate(x))))

    def make(pkg):
        if adapter == "makebatchevaluatable":
            return pkg.makebatchevaluatable(np.float64, f, localdims)
        if adapter == "ThreadedBatchEvaluator":
            return pkg.ThreadedBatchEvaluator(f, localdims, nthreads=4)
        return pkg.BatchEvaluatorAdapter(f, localdims)

    ref, out = make(tci_tpu), make(tci_tpu_torch)
    assert tci_tpu_torch.isbatchevaluable(out)
    assert out((1, 0, 3, 1)) == ref((1, 0, 3, 1))
    for Iset, Jset, nc in [([(0,), (2,)], [(1,), (0,)], 2),
                           ([(1, 1)], [(3, 0)], 0),
                           ([(0, 1, 2)], [()], 1),
                           ([], [(1,)], 2)]:
        a = out.batch_evaluate(Iset, Jset, nc)
        b = ref.batch_evaluate(Iset, Jset, nc)
        assert a.shape == b.shape
        assert np.array_equal(a.numpy(), b)
