"""TCI1 of tci_tpu_torch against tci_tpu on the same functions: the cases of
tests/test_tensorci1.py and test_fuzz_device.py::test_fuzz_tci1_vs_oracle
through both packages (the port on the CPU), BASELINE config 1 by TCI1,
the reference notebook's random f at a small size, and the Kronecker
bookkeeping against tci_tpu's per-entry ``pos`` lookups.

Tolerances: ranks and linkdims identical. The errors series are normalized
local errors of the ACA, formed by products that the two packages round
differently (torch and numpy BLAS; a triangular solve in the port where
tci_tpu loops over the pivots), so they agree to 1e-15 absolute for config
1 (errors of order 1e-9 to 1e-1) and 1e-12 relative for the random f
(errors of order 1). On a function without exact ties (the random table,
the fuzz functions) the pivot sets are identical; on a function symmetric
under a permutation of its legs (the Lorentzians) exact ties in the local
error can break either way, so there only ranks, errors and values are
compared, and ``test_config1_parts_only_at_ties`` shows that the first
place where the two packages part is such a tie (ROADMAP C-port-15).
Values: TT evaluations within 1e-12 of each other and of f where the
reference's test asserts np.isclose.
"""

import hashlib
import itertools
import json
import warnings

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu_torch.models.tensorci1 import TensorCI1
from tci_tpu_torch.parallel.batcheval import TorchBatchEvaluator
from tci_tpu_torch.utils.device import FETCHES

torch.set_num_threads(1)

ERR_ATOL = 1e-15
ERR_RTOL = 1e-12

# tci_tpu.crossinterpolate1(np.float64, fscalar, [10] * 8, tolerance=1e-8)
# with fscalar(x) = 1 / (1 + sum((x_i + 1)^2)), on a CPU
CONFIG1_TCI1_RANKS = list(range(2, 14))
CONFIG1_TCI1_LAST_ERROR = 4.522342590251166e-09
CONFIG1_TCI1_LINKDIMS = [10, 13, 13, 13, 13, 13, 10]
# the random f at L = 12, D = 20 (tolerance 1e-12, maxiter 20): the sha256
# of tci_tpu's pivot lists (``digest``) and its linkdims
RANDOM12_DIGEST = (
    "1d1157c9ab9abf256d8cef0a0500cc8d28b31b272efa877ce756029e10eca458")
RANDOM12_LINKDIMS = [2, 4, 8, 16, 20, 20, 20, 16, 8, 4, 2]

TABLE = np.random.default_rng(0).uniform(-1.0, 1.0, 2 ** 20)


def fscalar(x):
    return 1.0 / (1.0 + sum((i + 1.0) ** 2 for i in x))


class RandomF:
    """The reference notebook's random f: a table of 2^20 uniform values on
    [-1, 1] looked up at sum_i sigma_i 2^i, evaluated in batches."""

    def __init__(self, L):
        self.w = 2 ** np.arange(L)

    def evaluate_many(self, idx):
        return TABLE[np.asarray(idx, np.int64) @ self.w]

    def evaluate_single(self, x):
        return float(self.evaluate_many(np.asarray([x]))[0])

    def __call__(self, x):
        return self.evaluate_single(x)


def digest(t):
    """sha256 of a TCI1's pivot lists (Iset and Jset of every site)."""
    I = [[[int(v) for v in i] for i in s.fromint] for s in t.Iset]
    J = [[[int(v) for v in j] for j in s.fromint] for s in t.Jset]
    return hashlib.sha256(json.dumps([I, J]).encode()).hexdigest()


def same_pivots(out, ref):
    for s, r in zip(out.Iset + out.Jset, ref.Iset + ref.Jset):
        assert s.fromint == [tuple(int(v) for v in x) for x in r.fromint]


def host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_trivial_mps():
    n = 5
    f = lambda v: 1.0  # noqa: E731

    t = TensorCI1([2] * n, device="cpu")
    for i in range(n):
        assert len(t.Iset[i]) == 0 and len(t.Jset[i]) == 0
        assert tuple(t.T[i].shape) == (0, 2, 0)
        assert tuple(t.P[i].shape) == (0, 0)
        assert len(t.PiIset[i]) == 0 and len(t.PiJset[i]) == 0
    assert np.all(t.pivoterrors == np.inf)

    t = TensorCI1.from_function(f, [2] * n, [0] * n, device="cpu")
    ref = tci_tpu.TensorCI1.from_function(f, [2] * n, [0] * n)
    for i in range(n):
        assert t.Iset[i].fromint == [tuple([0] * i)]
        assert t.Jset[i].fromint == [tuple([0] * (n - i - 1))]
        assert np.array_equal(host(t.T[i]), np.ones((1, 2, 1)))
        assert np.array_equal(host(t.P[i]), np.ones((1, 1)))
        assert t.PiIset[i].fromint == ref.PiIset[i].fromint
        assert t.PiJset[i].fromint == ref.PiJset[i].fromint
    for i in range(n - 1):
        assert np.array_equal(host(t.Pi[i]), np.ones((2, 2)))
    for i in range(n - 1):
        t.addpivot(i, f, 1e-8)
    assert t.linkdims() == [1] * (n - 1)
    for i in range(n - 1):
        assert np.array_equal(host(t.Pi[i]), np.ones((2, 2)))
        assert len(t.PiIset[i]) == 2 and len(t.PiJset[i]) == 2


@pytest.mark.parametrize("coeff,n,d,globalpivot", [
    (1.0, 5, 10, (1, 8, 9, 4, 6)), (1.0j, 4, 5, (1, 3, 4, 2))])
def test_lorentz_mps(coeff, n, d, globalpivot):
    """tests/test_tensorci1.py::test_lorentz_mps through both packages (the
    complex case on a smaller grid): the same linkdims at every step, the
    reference's linkdims on its own grid, errors and TT values. At
    tolerance 1e-12 the pivot errors sit at rounding level, where the two
    packages' rounding decides when a bond stops: there, as in the
    reference's test, only the bounds and values are held."""
    f = lambda v: coeff / (sum((x + 1) ** 2 for x in v) + 1)  # noqa: E731
    dtype = np.complex128 if isinstance(coeff, complex) else np.float64
    real = dtype == np.float64

    t = TensorCI1.from_function(f, [d] * n, [0] * n, dtype=dtype,
                                device="cpu")
    ref = tci_tpu.TensorCI1.from_function(f, [d] * n, [0] * n, dtype=dtype)
    for p in range(n - 1):
        t.addpivot(p, f, 1e-8)
        ref.addpivot(p, f, 1e-8)
    assert t.linkdims() == ref.linkdims() == [2] * (n - 1)
    for _ in range(2):
        t.addglobalpivot(f, globalpivot, 1e-12)
        ref.addglobalpivot(f, globalpivot, 1e-12)
        assert t.linkdims() == ref.linkdims()
        assert not real or t.linkdims() == [3] * (n - 1)
        assert t.evaluate(globalpivot) == pytest.approx(f(globalpivot),
                                                        abs=1e-12)
    for it in range(4, 9):
        for p in range(n - 1):
            t.addpivot(p, f, 1e-8)
            ref.addpivot(p, f, 1e-8)
        assert t.linkdims() == ref.linkdims()
        assert not real or t.linkdims() == [it] * (n - 1)

    out, oranks, oerrs = tci_tpu_torch.crossinterpolate1(
        dtype, f, [d] * n, [0] * n, tolerance=1e-8, maxiter=8,
        sweepstrategy="forward", device="cpu")
    r, rranks, rerrs = tci_tpu.crossinterpolate1(
        dtype, f, [d] * n, [0] * n, tolerance=1e-8, maxiter=8,
        sweepstrategy="forward")
    assert oranks == rranks and out.linkdims() == r.linkdims()
    assert not real or out.linkdims() == t.linkdims()
    np.testing.assert_allclose(oerrs, rerrs, rtol=0, atol=ERR_ATOL)

    extra = [(9, 7, 9, 3, 3), (4, 3, 7, 8, 2), (6, 6, 9, 4, 8),
             (6, 6, 9, 4, 8)] if real else [(4, 3, 4, 3), (1, 4, 0, 4)]
    for pivots in (extra, []):
        out, _, _ = tci_tpu_torch.crossinterpolate1(
            dtype, f, [d] * n, [0] * n, tolerance=1e-12, maxiter=200,
            additionalpivots=pivots, device="cpu")
        assert np.all(out.pivoterrors <= 1e-12) and out.rank() <= 200
    tt = tci_tpu_torch.tensortrain(out)
    for v in itertools.product(*[range(3)] * n):
        value = out.evaluate(list(v))
        assert value == pytest.approx(tt(v), abs=1e-12)
        assert value == pytest.approx(f(v), abs=1e-12)


def test_tci1_batches_pi_sampling():
    """One batched call a panel, row block or column block for an
    evaluator with evaluate_many, as in tci_tpu."""

    class CountingEvaluator:
        def __init__(self):
            self.ncalls = 0
            self.nentries = 0

        def evaluate_many(self, idx):
            self.ncalls += 1
            self.nentries += idx.shape[0]
            v = np.asarray(idx, float) + 1.0
            return 1.0 / (1.0 + np.sum(v * v, axis=1))

        def evaluate_single(self, v):
            return float(self.evaluate_many(np.asarray([v], np.int32))[0])

        def __call__(self, v):
            return self.evaluate_single(v)

    ev, ev_ref = CountingEvaluator(), CountingEvaluator()
    t, _, errors = tci_tpu_torch.crossinterpolate1(
        np.float64, ev, [4] * 5, tolerance=1e-10, device="cpu")
    tci_tpu.crossinterpolate1(np.float64, ev_ref, [4] * 5, tolerance=1e-10)
    assert errors[-1] < 1e-10
    assert ev.nentries > 10 * ev.ncalls, (ev.ncalls, ev.nentries)
    assert (ev.ncalls, ev.nentries) == (ev_ref.ncalls, ev_ref.nentries)


def lorentzian_torch(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(dim=1))


@pytest.mark.parametrize("evaluator", ["scalar", "torch"])
def test_config1_matches_tci_tpu(evaluator):
    """BASELINE config 1 by TCI1, through a plain scalar f and through a
    TorchBatchEvaluator: tci_tpu's ranks and errors (recorded and run
    here), its linkdims, and a pointwise error below 1e-7."""
    dims = [10] * 8
    f = fscalar if evaluator == "scalar" else TorchBatchEvaluator(
        lorentzian_torch, dims, device="cpu")
    FETCHES.clear()
    out, ranks, errors = tci_tpu_torch.crossinterpolate1(
        np.float64, f, dims, tolerance=1e-8, device="cpu")
    _, rranks, rerrors = tci_tpu.crossinterpolate1(np.float64, fscalar, dims,
                                                   tolerance=1e-8)
    assert ranks == rranks == CONFIG1_TCI1_RANKS
    np.testing.assert_allclose(errors, rerrors, rtol=0, atol=ERR_ATOL)
    assert errors[-1] == pytest.approx(CONFIG1_TCI1_LAST_ERROR, abs=ERR_ATOL)
    assert out.linkdims() == CONFIG1_TCI1_LINKDIMS
    x = (1, 2, 3, 4, 5, 4, 3, 2)
    assert abs(out.evaluate(x) - fscalar(x)) < 1e-7
    # host reads: two a pivot search with a candidate, a guard a pivot, one
    # a sweep for max |sample|, one a bond's first pivot
    assert 0 < FETCHES["tci1"] <= 3 * 7 * len(ranks) + len(ranks) + 7


def test_config1_parts_only_at_ties():
    """Config 1's f is symmetric under a permutation of its legs, so its Π
    matrices hold exactly tied local errors; the two packages round the
    ACA products differently and may break such a tie differently (their
    pivot sets differ, their ranks and errors do not). Step both through
    the same sweeps: where their candidates first differ, the port's
    candidate has, in tci_tpu's own state, the largest local error to
    within rounding (a tie)."""
    dims = [10] * 8
    out = TensorCI1.from_function(fscalar, dims, device="cpu")
    ref = tci_tpu.TensorCI1.from_function(fscalar, dims)
    for it in range(2, 14):
        bonds = range(7) if it % 2 == 1 else range(6, -1, -1)
        for p in bonds:
            if ref.aca[p].rank() < min(ref.Pi[p].shape):
                cand, err = out.aca[p].findnewpivot(out.Pi[p])
                rcand, rerr = ref.aca[p].findnewpivot(ref.Pi[p])
                if cand != rcand:
                    local = ref.aca[p].localerror(ref.Pi[p])
                    assert rerr == local.max()
                    assert abs(local[cand] - rerr) <= 1e-14 * rerr
                    return
            out.addpivot(p, fscalar, 1e-12)
            ref.addpivot(p, fscalar, 1e-12)
    pytest.fail("the two packages never parted")


def test_random_f_same_pivots():
    """The reference notebook's random f at L = 12, D = 20: tci_tpu's pivot
    sets (its recorded digest, and a run here), ranks and errors."""
    L, D = 12, 20
    out, ranks, errors = tci_tpu_torch.crossinterpolate1(
        np.float64, RandomF(L), [2] * L, tolerance=1e-12, maxiter=D,
        device="cpu")
    ref, rranks, rerrors = tci_tpu.crossinterpolate1(
        np.float64, RandomF(L), [2] * L, tolerance=1e-12, maxiter=D)
    assert digest(out) == digest(ref) == RANDOM12_DIGEST
    assert out.linkdims() == RANDOM12_LINKDIMS and ranks == rranks
    np.testing.assert_allclose(errors, rerrors, rtol=ERR_RTOL, atol=0)


def test_kronecker_bookkeeping_matches_pos_lists(monkeypatch):
    """The permutations TCI1 hands setrows / setcols, Π's index sets and the
    cross positions, derived in the port from the Kronecker order, equal
    tci_tpu's, which looks up every old entry with IndexSet.pos; with a
    global pivot among the updates."""
    from tci_tpu.ops.aca import MatrixACA as RefACA

    from tci_tpu_torch.ops.aca import MatrixACA

    logs = {"port": [], "ref": []}

    def recording(cls, name, log):
        original = getattr(cls, name)

        def wrapper(self, new, permutation):
            log.append((name, [int(x) for x in permutation]))
            return original(self, new, permutation)
        monkeypatch.setattr(cls, name, wrapper)

    for name in ("setrows", "setcols"):
        recording(MatrixACA, name, logs["port"])
        recording(RefACA, name, logs["ref"])

    L = 8
    f = RandomF(L)
    out = TensorCI1.from_function(f, [2] * L, device="cpu")
    ref = tci_tpu.TensorCI1.from_function(f, [2] * L)
    for it in range(2, 9):
        bonds = range(L - 1) if it % 2 else range(L - 2, -1, -1)
        for p in bonds:
            out.addpivot(p, f, 1e-12)
            ref.addpivot(p, f, 1e-12)
        if it == 4:
            out.addglobalpivot(f, (1, 0, 1, 1, 0, 1, 0, 1), 1e-12)
            ref.addglobalpivot(f, (1, 0, 1, 1, 0, 1, 0, 1), 1e-12)
    assert logs["port"] == logs["ref"] and len(logs["port"]) > 50
    same_pivots(out, ref)
    for p in range(L):
        assert out.PiIset[p].fromint == ref.PiIset[p].fromint
        assert out.PiJset[p].fromint == ref.PiJset[p].fromint
    for p in range(L - 1):
        cross, rcross = out.getcross(p), ref.getcross(p)
        assert cross.rowindices == rcross.rowindices
        assert cross.colindices == rcross.colindices
        for i in ref.Iset[p + 1].fromint:
            assert out.PiIset[p].pos(i) == ref.PiIset[p].pos(i)
        np.testing.assert_allclose(host(out.Pi[p]), ref.Pi[p], rtol=0, atol=0)


def test_state_carried_across():
    """tci_tpu's TCI1 site tensors, as numpy arrays, build a port
    TensorTrain that evaluates like tci_tpu's; the port's own TCI1 of the
    same f (identical pivots) has site tensors within 1e-12 of them."""
    L = 10
    ref, _, _ = tci_tpu.crossinterpolate1(np.float64, RandomF(L), [2] * L,
                                          tolerance=1e-12, maxiter=12)
    out, _, _ = tci_tpu_torch.crossinterpolate1(
        np.float64, RandomF(L), [2] * L, tolerance=1e-12, maxiter=12,
        device="cpu")
    same_pivots(out, ref)
    cores = ref.sitetensors()
    tt_ref = tci_tpu.TensorTrain(cores)
    tt_port = tci_tpu_torch.TensorTrain(cores, device="cpu")
    pts = np.random.default_rng(2).integers(0, 2, (256, L))
    np.testing.assert_allclose(host(tt_port.evaluate_batch(pts)),
                               tt_ref.evaluate_batch(pts), rtol=0, atol=1e-14)
    assert tt_port.linkdims() == tt_ref.linkdims()
    for a, b in zip(out.sitetensors(), cores):
        np.testing.assert_allclose(host(a), b, rtol=0,
                                   atol=1e-12 * np.abs(b).max())


def test_fuzz_tci1_vs_oracle():
    """test_fuzz_device.py::test_fuzz_tci1_vs_oracle through both
    packages: the enumerated tensor within 1e-8 max|f|, and the port's
    linkdims and pivot sets equal to tci_tpu's."""
    master = np.random.default_rng(101010)
    for trial in range(4):
        L = int(master.integers(3, 6))
        localdims = [int(master.integers(2, 5)) for _ in range(L)]
        complex_ = bool(master.integers(0, 2))
        strategy = ["forward", "backandforth"][int(master.integers(0, 2))]
        c = master.standard_normal(L) * 0.5
        cfg = (trial, localdims, complex_, strategy)

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

        kw = dict(tolerance=1e-10, maxiter=30, sweepstrategy=strategy)
        out, _, _ = tci_tpu_torch.crossinterpolate1(vt, fpy, localdims,
                                                    [0] * L, device="cpu",
                                                    **kw)
        ref, _, _ = tci_tpu.crossinterpolate1(vt, fpy, localdims, [0] * L,
                                              **kw)
        assert out.linkdims() == ref.linkdims(), cfg
        same_pivots(out, ref)
        ft = host(tci_tpu_torch.fulltensor(tci_tpu_torch.tensortrain(out)))
        grids = np.meshgrid(*[np.arange(dd) for dd in localdims],
                            indexing="ij")
        pts = np.stack([g.ravel() for g in grids], axis=1)
        exact = np.asarray([fpy(p) for p in pts]).reshape(ft.shape)
        assert np.abs(ft - exact).max() < 1e-8 * np.abs(exact).max(), cfg


def test_crossinterpolate1_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tci_tpu_torch.crossinterpolate1(np.float64, fscalar, [3] * 3)
    t, _, _ = tci_tpu_torch.crossinterpolate1(np.float64, fscalar, [3] * 3,
                                              device="cpu")
    assert t.T[0].device.type == "cpu"


def test_crossinterpolate_is_deprecated():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t, ranks, _ = tci_tpu_torch.crossinterpolate(
            np.float64, fscalar, [3] * 4, device="cpu")
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert ranks == tci_tpu.crossinterpolate1(np.float64, fscalar,
                                              [3] * 4)[1]
