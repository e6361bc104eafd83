"""Conversions of tci_tpu_torch against tci_tpu on the same inputs: the
cases of tests/test_conversion.py and
test_fuzz_device.py::test_fuzz_conversion_roundtrips through both packages
(the port on the CPU), and tci_tpu's TCI2 index sets carried into both
packages' tci1_from_tci2.

Tolerances: ranks, linkdims and index sets identical. Values as in the
reference's tests: np.isclose for evaluations, 1e-13 / 1e-12 absolute
for the TT <-> TCI2 round trip, 1e-9 max|f| (TT -> TCI2) and 1e-8 max|f|
(TCI2 -> TCI1 -> TCI2) for the fuzz round trips. The state carried across:
Π, T and P are the same samples, bit for bit; the ACA's u and v are built
by the same pivot sequence through products that round differently and
agree to 1e-12 relative to each array's largest entry, its pivots 1/α to
1e-14 max|Π| (the later pivots are residuals far below max|Π|, rounded at
its scale). The Lorentzian's symmetry under a permutation of its legs
makes exact ties in the LU sweeps of TT -> TCI2, so there the index sets
may differ between the packages and only their sizes are held.
"""

import itertools

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu.models import conversion as ref_conversion
from tci_tpu_torch.models import conversion
from tci_tpu_torch.parallel.batcheval import VectorizedBatchEvaluator

torch.set_num_threads(1)


def host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(a, b, rel=1e-12):
    a, b = host(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= rel * max(
        np.abs(b).max(initial=0.0), 1e-300)


A6 = np.array([
    [0.412779, 0.423091, 0.166912, 0.953768, 0.207438, 0.600653],
    [0.273203, 0.622319, 0.715224, 0.646002, 0.0508133, 0.482628],
    [0.562037, 0.0616797, 0.455742, 0.00227183, 0.411564, 0.345012],
    [0.537797, 0.955916, 0.656385, 0.463868, 0.449098, 0.146251],
    [0.245995, 0.77942, 0.389488, 0.714201, 0.416509, 0.00404971],
    [0.604805, 0.0745451, 0.228923, 0.881908, 0.0640686, 0.514265],
])


@pytest.mark.parametrize("leftorthogonal", [True, False])
def test_rrlu_to_aca(leftorthogonal):
    lu = tci_tpu_torch.rrlu(A6, maxrank=4, leftorthogonal=leftorthogonal,
                            device="cpu")
    ref = ref_conversion.aca_from_rrlu(tci_tpu.rrlu(
        A6, maxrank=4, leftorthogonal=leftorthogonal))
    aca = conversion.aca_from_rrlu(lu)
    assert aca.shape == (6, 6)
    assert aca.rowindices == ref.rowindices
    assert aca.colindices == ref.colindices
    close(aca.u, ref.u)
    close(aca.v, ref.v)
    close(aca.alpha, np.asarray(ref.alpha))
    close(aca.evaluate(), host(lu.left() @ lu.right()))


def complex_lorentz(v):
    return (1.0 + 2.0j) / (sum((x + 1) ** 2 for x in v) + 1)


def test_tci1_tci2_conversion():
    d, n = 3, 4
    t1 = tci_tpu_torch.TensorCI1([d] * n, dtype=np.complex128, device="cpu")
    t2 = conversion.tci2_from_tci1(t1)
    assert len(t2) == len(t1) and t2.sitedims() == t1.sitedims()
    assert t2.rank() == 0
    assert all(len(s) == 0 for s in t2.Iset + t2.Jset)

    rng = np.random.default_rng(1234)
    cache = {}
    frand = lambda v: cache.setdefault(  # noqa: E731
        tuple(v), complex(rng.random(), rng.random()))
    t1 = tci_tpu_torch.TensorCI1.from_function(frand, [d] * n, (1, 1, 2, 0),
                                               dtype=np.complex128,
                                               device="cpu")
    t2 = conversion.tci2_from_tci1(t1)
    assert t2.rank() == 1 and t2.linkdims() == t1.linkdims()

    kw = dict(tolerance=1e-6, pivottolerance=1e-8, maxiter=4,
              sweepstrategy="forward")
    t1, _, _ = tci_tpu_torch.crossinterpolate1(
        np.complex128, complex_lorentz, [d] * n, [0] * n, device="cpu", **kw)
    r1, _, _ = tci_tpu.crossinterpolate1(np.complex128, complex_lorentz,
                                         [d] * n, [0] * n, **kw)
    t2 = conversion.tci2_from_tci1(t1)
    t1b = conversion.tci1_from_tci2(t2, complex_lorentz)
    t2b = conversion.tci2_from_tci1(t1b)
    r2 = ref_conversion.tci2_from_tci1(r1)
    assert t1.linkdims() == r1.linkdims() == t2.linkdims() == r2.linkdims()
    assert t1b.linkdims() == t2b.linkdims() == t1.linkdims()
    assert t2.rank() == t1b.rank() == t2b.rank() == t1.rank()
    for v in itertools.product(*[range(d)] * n):
        assert np.isclose(t1.evaluate(v), t2.evaluate(v))
        assert np.isclose(t1.evaluate(v), t1b.evaluate(v))
        assert np.isclose(t2.evaluate(v), complex(r2.evaluate(v)))

    t2.optimize(complex_lorentz, tolerance=1e-12)
    assert t2.pivoterror() <= 1e-12 * t2.maxsamplevalue
    assert t2.rank() > t1.rank()
    for v in itertools.product(*[range(d)] * n):
        assert np.isclose(t2.evaluate(v), complex_lorentz(v))


def test_tt_tci2_conversion():
    f = complex_lorentz
    t, _, _ = tci_tpu_torch.crossinterpolate2(
        np.complex128, f, [4] * 4, tolerance=1e-14, maxbonddim=5,
        rng=np.random.default_rng(0), device="cpu")
    r, _, _ = tci_tpu.crossinterpolate2(
        np.complex128, f, [4] * 4, tolerance=1e-14, maxbonddim=5,
        rng=np.random.default_rng(0))
    tt = tci_tpu_torch.tensortrain(t)
    tb = conversion.tci2_from_tensortrain(tt, tolerance=1e-14)
    rb = ref_conversion.tci2_from_tensortrain(tci_tpu.tensortrain(r),
                                              tolerance=1e-14)
    assert tt.rank() == tb.rank() == 5
    assert tb.linkdims() == tt.linkdims() == t.linkdims() == rb.linkdims()
    assert tb.sitedims() == [[4]] * 4
    for v in itertools.product(*[range(4)] * 4):
        assert abs(tt(v) - t(v)) < 1e-13
        assert abs(tb(v) - t(v)) < 1e-12
    tb.optimize(f, tolerance=1e-14)
    for v in itertools.product(*[range(4)] * 4):
        assert abs(tb(v) - f(v)) < 1e-13


def test_fuzz_conversion_roundtrips():
    """test_fuzz_device.py::test_fuzz_conversion_roundtrips through the
    port, from the port's TCI2, with the reference's linkdims where
    tci_tpu's own round trips give them."""
    master = np.random.default_rng(818181)
    for trial in range(4):
        L = int(master.integers(3, 6))
        localdims = [int(master.integers(2, 5)) for _ in range(L)]
        complex_ = bool(master.integers(0, 2))
        c = master.standard_normal(L) * 0.5
        cfg = (trial, localdims, complex_)

        if complex_:
            def fpy(x, c=c):
                v = np.asarray(x, float) + 1.0
                return np.exp(1j * v.sum()) / (1.0 + np.sum((v - c) ** 2))
            vt = np.complex128
        else:
            def fpy(x, c=c):
                v = np.asarray(x, float)
                return 1.0 / (1.0 + np.sum((v - c) ** 2))
            vt = np.float64

        t2, _, _ = tci_tpu_torch.crossinterpolate2(
            vt, fpy, localdims, tolerance=1e-10,
            rng=np.random.default_rng(trial), device="cpu")
        ft = host(tci_tpu_torch.fulltensor(tci_tpu_torch.tensortrain(t2)))
        scale = np.abs(ft).max()

        tb = conversion.tci2_from_tensortrain(tci_tpu_torch.tensortrain(t2),
                                              tolerance=1e-12)
        assert tb.linkdims() == t2.linkdims(), cfg
        ftb = host(tci_tpu_torch.fulltensor(tci_tpu_torch.tensortrain(tb)))
        assert np.allclose(ftb, ft, atol=1e-9 * scale), cfg

        t1 = conversion.tci1_from_tci2(t2, fpy)
        t2b = conversion.tci2_from_tci1(t1)
        assert t1.linkdims() == t2.linkdims() == t2b.linkdims(), cfg
        ft2b = host(tci_tpu_torch.fulltensor(tci_tpu_torch.tensortrain(t2b)))
        assert np.allclose(ft2b, ft, atol=1e-8 * scale), cfg


def lorentzian_np(idx):
    v = np.asarray(idx, dtype=float) + 1.0
    return 1.0 / (1.0 + np.sum(v * v, axis=1))


def test_state_carried_across():
    """tci_tpu's TCI2 index sets (config 1 at four sites) go into both
    packages' tci1_from_tci2: Π, T, P, the ACA's u, v and α agree, and the
    two TCI1s convert back to TCI2s with the same site tensors."""
    from tci_tpu.parallel.batcheval import VectorizedBatchEvaluator as JaxVBE

    dims = [10] * 4
    r2, _, _ = tci_tpu.crossinterpolate2(
        np.float64, JaxVBE(lorentzian_np, dims), dims, tolerance=1e-8,
        rng=np.random.default_rng(0))
    scalar = lambda x: float(lorentzian_np(np.asarray([x]))[0])  # noqa: E731
    ref = ref_conversion.tci1_from_tci2(r2, scalar)
    port2 = tci_tpu_torch.TensorCI2.from_ijsets(
        VectorizedBatchEvaluator(lorentzian_np, dims), dims, r2.Iset,
        r2.Jset, device="cpu")
    port2.bonderrors = np.asarray(r2.bonderrors, dtype=float)
    out = conversion.tci1_from_tci2(port2, scalar)
    assert out.maxsamplevalue == pytest.approx(ref.maxsamplevalue, rel=1e-15)
    for p in range(len(dims) - 1):
        close(out.Pi[p], ref.Pi[p], rel=0.0)
        close(out.aca[p].u, ref.aca[p].u)
        close(out.aca[p].v, ref.aca[p].v)
        # the pivots 1/α: the later ones are residuals of order 1e-9 max|Π|
        # whose rounding is that of max|Π|
        np.testing.assert_allclose(
            1 / host(out.aca[p].alpha), 1 / np.asarray(ref.aca[p].alpha),
            rtol=0, atol=1e-14 * np.abs(ref.Pi[p]).max())
        assert out.aca[p].rowindices == ref.aca[p].rowindices
        assert out.aca[p].colindices == ref.aca[p].colindices
    for p in range(len(dims)):
        close(out.T[p], ref.T[p], rel=0.0)
        close(out.P[p], ref.P[p], rel=0.0)
    back = conversion.tci2_from_tci1(out)
    rback = ref_conversion.tci2_from_tci1(ref)
    for p, (a, b) in enumerate(zip(back.sitetensors(), rback.sitetensors())):
        # T · P^{-1}: the two solves differ by up to eps · cond(P) relative
        cond = np.linalg.cond(ref.P[p]) if p < len(dims) - 1 else 1.0
        close(a, b, rel=16 * np.finfo(float).eps * cond)


def test_tci1_from_tci2_needs_nested_sets_c_ref_5():
    """tci1_from_tci2 of a TCI2 whose index sets are not nested raises a
    KeyError in both packages (ROADMAP C-ref-5: a TCI2 kept with
    non-strict nesting, such as config 1's, is not convertible as it
    stands); here Iset[2] holds (1, 1) while Iset[1] lacks (1,)."""
    from tci_tpu.models.conversion import tci1_from_tci2 as ref_tci1

    dims = [2, 2, 2]
    f = lambda x: 1.0 + x[0] + 2 * x[1] + 4 * x[2]  # noqa: E731
    Iset = [[()], [(0,)], [(1, 1)]]
    Jset = [[(0, 0)], [(0,)], [()]]
    ref = tci_tpu.TensorCI2.from_ijsets(f, dims, Iset, Jset)
    port = tci_tpu_torch.TensorCI2.from_ijsets(f, dims, Iset, Jset,
                                               device="cpu")
    with pytest.raises(KeyError):
        ref_tci1(ref, f)
    with pytest.raises(KeyError):
        conversion.tci1_from_tci2(port, f)
