"""Native complex128 through the port (tci_tpu_torch) against tci_tpu, on
the CPU: the plain rrLU elimination, MatrixLUCI and factorize, TCI2 on the
host tier, the fused tier and the engine, the global search and
``integrate``, each on the same numpy-seeded inputs in both packages.

Tolerances, and why none is bitwise: torch and jax round a complex product
or quotient differently (one of them may contract to a fused multiply-add,
and neither uses the kernel's formulas, which the port's plain version
writes out on the real and imaginary parts), so Schur updates differ in the
last bit. Hence:

- rrLU: pivot order and npivot identical; LU values, magnitudes and err to
  1e-13 of max|A|. The panels are seeded complex Gaussians (or products of
  them): their pivot candidates are continuous random numbers, so no two
  lie within that rounding of each other and the pivot order is decided
  far from a tie;
- MatrixLUCI / factorize: pivots identical, factors to 1e-12 of max|A|; SVD
  factors up to the phase of each singular pair, so their product and rank;
- TCI2: ranks series, linkdims and pivot sets identical, errors to 1e-12
  absolute (normalized) on the host tier; the config-5 integrand: ranks
  identical, final error to 1e-3 relative (an error near the 1e-9 floor of
  the normalized Schur residual), integral to 1e-12 absolute of tci_tpu's;
  against the dense Gauss-Kronrod sum, within the TCI's own error
  (errors[-1] max|sample| bounds |f - tt| at a sample, and the integral is
  their mean; 1.5e-11 of 1.0e-8 here). The port's own protocols (the
  optimize loop, the sweep pair off, both off) agree bit for bit.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tci_tpu
import tci_tpu_torch
from tci_tpu.ops.kronrod import kronrod
from tci_tpu.ops.lu_kernel import _rrlu_while
from tci_tpu.parallel.batcheval import JaxBatchEvaluator
from tci_tpu.parallel.batcheval import VectorizedBatchEvaluator as JaxVBE
from tci_tpu_torch.models import device_sweep, globalsearch
from tci_tpu_torch.models.globalpivotfinder import (
    DefaultGlobalPivotFinder, GlobalPivotSearchInput)
from tci_tpu_torch.ops import lu_kernel
from tci_tpu_torch.parallel.batcheval import (TorchBatchEvaluator,
                                              VectorizedBatchEvaluator)

torch.set_num_threads(1)

LU_RTOL = 1e-13


def cgauss(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _panel(case, seed, graded=False):
    """A seeded complex Gaussian of shape (m, n), of rank r unless r is
    None; graded: its columns scaled by 0.6^j, so that its pivots decay and
    a reltol stop falls inside it."""
    rng = np.random.default_rng(seed)
    m, n, r = case
    A = cgauss(rng, m, n) if r is None else cgauss(rng, m, r) @ cgauss(rng,
                                                                       r, n)
    return A * 0.6 ** np.arange(n) if graded else A


CASES = [(40, 30, None), (64, 64, None), (200, 150, 20)]


def _stop(A, stop):
    """(reltol, abstol): an abstol stop at 1e-10 max|A| (the full or the
    numerical rank), or a reltol stop at 1e-4 (on a graded panel, some
    pivots in)."""
    if stop == "abstol":
        return 1e-14, 1e-10 * float(np.abs(A).max())
    return 1e-4, 0.0


def _padded(A):
    m, n = A.shape
    P = np.zeros((lu_kernel.bucket(m), lu_kernel.bucket(n)), np.complex128)
    P[:m, :n] = A
    return P


def _close_lu(out, ref, scale):
    A_o, rp_o, cp_o, k_o, mags_o, err_o = out
    A_r, rp_r, cp_r, k_r, mags_r, err_r = ref
    k = int(k_r)
    assert int(k_o) == k
    # the pivots, in order; past k the permutations are bookkeeping of
    # unpivoted lines
    assert np.array_equal(rp_o[:k], rp_r[:k])
    assert np.array_equal(cp_o[:k], cp_r[:k])
    np.testing.assert_allclose(mags_o, mags_r, rtol=0, atol=LU_RTOL * scale)
    assert abs(float(err_o) - float(err_r)) <= LU_RTOL * scale
    np.testing.assert_allclose(A_o, A_r, rtol=0, atol=LU_RTOL * scale)


@pytest.mark.parametrize("stop", ["abstol", "reltol"])
@pytest.mark.parametrize("leftorth", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_rrlu_plain_matches_tci_tpu(case, leftorth, stop):
    """The plain complex elimination against tci_tpu's complex XLA loop
    (``_rrlu_while``, which tci_tpu runs for complex on the CPU) on the same
    padded panel, and the public rrlu against tci_tpu.rrlu."""
    A = _panel(case, seed=sum(case[:2]), graded=stop == "reltol")
    m, n = A.shape
    reltol, abstol = _stop(A, stop)
    P = _padded(A)
    scale = float(np.abs(A).max())
    ref = [np.asarray(x) for x in _rrlu_while(
        jnp.asarray(P), m, n, min(m, n), reltol, abstol,
        leftorthogonal=leftorth)]
    out = [x.numpy() for x in lu_kernel.rrlu_plain(
        torch.as_tensor(P), m, n, min(m, n), reltol, abstol,
        leftorthogonal=leftorth)]
    assert out[0].dtype == np.complex128 and out[4].dtype == np.float64
    _close_lu(out, ref, scale)
    if stop == "reltol":
        assert 0 < int(ref[3]) < min(m, n)
    lr = tci_tpu.rrlu(A, reltol=reltol, abstol=abstol,
                      leftorthogonal=leftorth)
    lo = tci_tpu_torch.rrlu(A, reltol=reltol, abstol=abstol,
                            leftorthogonal=leftorth, device="cpu")
    assert lo.npivots() == lr.npivots()
    assert np.array_equal(lo.rowindices(), lr.rowindices())
    assert np.array_equal(lo.colindices(), lr.colindices())
    assert lo.L.dtype == torch.complex128
    np.testing.assert_allclose(lo.left().numpy(), lr.left(), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(lo.right().numpy(), lr.right(), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(lo.diag(), lr.diag(), rtol=0,
                               atol=LU_RTOL * scale)
    assert abs(lo.lastpivoterror() - lr.lastpivoterror()) <= LU_RTOL * scale


def test_rrlu_plain_batched_matches_tci_tpu():
    """Four 64 x 64 complex panels in one call, with per-panel extents,
    rank caps and tolerances: each panel as tci_tpu's XLA loop gives it."""
    rng = np.random.default_rng(4)
    A = np.stack([_padded(cgauss(rng, 64, 64)) for _ in range(4)])
    A[2] *= 0.6 ** np.arange(64)  # graded: a reltol stop inside
    m = [64, 64, 50, 64]
    n = [64, 40, 64, 64]
    maxrank = [64, 8, 50, 64]
    for b in range(4):  # zero padding outside the true block, as rrlu_raw
        A[b, m[b]:, :] = 0
        A[b, :, n[b]:] = 0
    reltol = [1e-14, 0.0, 1e-4, 1e-14]
    abstol = [0.0, 0.0, 0.0, 1.0]
    out = [x.numpy() for x in lu_kernel.rrlu_plain_batched(
        torch.as_tensor(A), m, n, maxrank, reltol, abstol,
        leftorthogonal=True)]
    for b in range(4):
        ref = [np.asarray(x) for x in _rrlu_while(
            jnp.asarray(A[b]), m[b], n[b], maxrank[b], reltol[b], abstol[b],
            leftorthogonal=True)]
        _close_lu([x[b] for x in out], ref, float(np.abs(A[b]).max()))


def test_rrlu_promotes_complex64():
    """complex64 input is eliminated in complex128, as tci_tpu promotes it."""
    A = _panel((12, 10, None), seed=3).astype(np.complex64)
    lo = tci_tpu_torch.rrlu(A, device="cpu")
    lr = tci_tpu.rrlu(A)
    assert lo.L.dtype == torch.complex128 and lo.diag().dtype == np.complex128
    assert np.array_equal(lo.rowindices(), lr.rowindices())
    assert np.array_equal(lo.colindices(), lr.colindices())


@pytest.mark.parametrize("leftorth", [True, False])
def test_matrixluci_matches_tci_tpu(leftorth):
    A = _panel((60, 45, 9), seed=7)
    scale = float(np.abs(A).max())
    ref = tci_tpu.MatrixLUCI(A, reltol=1e-12, leftorthogonal=leftorth)
    out = tci_tpu_torch.MatrixLUCI(A, reltol=1e-12, leftorthogonal=leftorth,
                                   device="cpu")
    assert out.npivots() == ref.npivots() == 9
    assert np.array_equal(out.rowindices(), ref.rowindices())
    assert np.array_equal(out.colindices(), ref.colindices())
    for o, r in ((out.left(), ref.left()), (out.right(), ref.right())):
        assert o.dtype == torch.complex128
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose((out.left() @ out.right()).numpy(), A, rtol=0,
                               atol=1e-12 * scale)
    # the LU helpers on a complex square system: rrLU.solve, and the pivot
    # block solves of cols2Lmatrix / rows2Umatrix
    rng = np.random.default_rng(9)
    S, b = cgauss(rng, 12, 12), cgauss(rng, 12)
    x = tci_tpu_torch.rrlu(S, leftorthogonal=leftorth, device="cpu").solve(b)
    np.testing.assert_allclose(S @ x.numpy(), b, rtol=0, atol=1e-12)
    P, C = np.triu(S[:5, :5]) + 5 * np.eye(5), cgauss(rng, 7, 5)
    np.testing.assert_allclose(
        tci_tpu_torch.cols2Lmatrix(C, P, True, device="cpu").numpy(),
        np.asarray(tci_tpu.cols2Lmatrix(C, P, True)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tci_tpu_torch.rows2Umatrix(C.T, P.T, True, device="cpu").numpy(),
        np.asarray(tci_tpu.rows2Umatrix(C.T, P.T, True)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", ["LU", "CI", "SVD"])
def test_factorize_matches_tci_tpu(method):
    from tci_tpu.ops.factorize import factorize as jax_factorize

    A = _panel((30, 24, 6), seed=8)
    scale = float(np.abs(A).max())
    for lo in (True, False):
        lr, rr, kr = jax_factorize(A, method, 1e-12, leftorthogonal=lo)
        lt, rt, kt = tci_tpu_torch.factorize(A, method, 1e-12,
                                             leftorthogonal=lo, device="cpu")
        assert kt == kr == 6
        assert lt.dtype == rt.dtype == torch.complex128
        if method != "SVD":
            np.testing.assert_allclose(lt.numpy(), lr, rtol=0,
                                       atol=1e-12 * scale)
            np.testing.assert_allclose(rt.numpy(), rr, rtol=0,
                                       atol=1e-12 * scale)
        np.testing.assert_allclose((lt @ rt).numpy(), np.asarray(lr) @ rr,
                                   rtol=0, atol=1e-12 * scale)


# -- TCI2 on the host tier: the complex case of tests/test_tensorci2.py's
#    test_lorentz_mps (full pivoting) at n = 4

def test_lorentz_mps_complex_matches_tci_tpu():
    n, coeff = 4, 0.5 - 1.0j
    f = lambda v: coeff / (sum((x + 1) ** 2 for x in v) + 1)  # noqa: E731
    pkgs = (tci_tpu, tci_tpu_torch)
    kw = ({}, {"device": "cpu"})
    ts = [p.TensorCI2.from_function(f, [10] * n, dtype=np.complex128, **k)
          for p, k in zip(pkgs, kw)]
    for t in ts:
        for p in range(n - 1):
            t.updatepivots(p, f, True, reltol=1e-8, maxbonddim=2)
    assert ts[0].linkdims() == ts[1].linkdims() == [2] * (n - 1)
    for t in ts:
        t.addglobalpivots1sitesweep(f, [(1, 8, 9, 4)], reltol=1e-12)
    assert ts[0].linkdims() == ts[1].linkdims() == [3] * (n - 1)
    for it in range(4, 21):
        for t in ts:
            for p in range(n - 1):
                t.updatepivots(p, f, True, reltol=1e-8)
        assert ts[1].linkdims() == ts[0].linkdims()
    assert ts[1].Iset == ts[0].Iset and ts[1].Jset == ts[0].Jset
    assert ts[1].sitetensors()[0].dtype == torch.complex128

    for tol, maxiter, strategy in ((1e-8, 8, "forward"),
                                   (1e-12, 200, "backandforth")):
        (r, rr, re), (o, orr, oe) = [
            p.crossinterpolate2(np.complex128, f, [10] * n, [(0,) * n],
                                tolerance=tol, maxiter=maxiter,
                                sweepstrategy=strategy,
                                rng=np.random.default_rng(99), **k)
            for p, k in zip(pkgs, kw)]
        assert orr == rr
        assert o.linkdims() == r.linkdims()
        assert o.Iset == r.Iset and o.Jset == r.Jset
        np.testing.assert_allclose(oe, re, rtol=0, atol=1e-12)
        pts = [(1, 2, 3, 4), (9, 0, 5, 7), (0, 0, 0, 0)]
        for x in pts:
            assert abs(o(x) - r(x)) <= 1e-12 * abs(coeff)
        assert o.pivoterror() <= 2e-12 * o.maxsamplevalue or tol > 1e-12

    # the state carried into a new TCI: from_ijsets, and a train from
    # complex numpy cores
    t2 = tci_tpu_torch.TensorCI2.from_ijsets(
        f, [10] * n, o.Iset, o.Jset, dtype=np.complex128, device="cpu")
    t2.makecanonical(f)
    assert t2.linkdims() == o.linkdims()
    tt = tci_tpu_torch.TensorTrain([np.asarray(c) for c in
                                    tci_tpu.tensortrain(r).sitetensors()],
                                   device="cpu")
    assert tt.sitetensors()[0].dtype == torch.complex128
    assert abs(tt.sum() - tci_tpu.tensortrain(r).sum()) <= 1e-12 * abs(
        tt.sum())


def test_complex_train_algebra_matches_tci_tpu():
    """A complex train's norm (real), sum, add / subtract, fulltensor and
    compress (LU, CI, SVD) against tci_tpu's on the same numpy cores."""
    rng = np.random.default_rng(12)
    cores = [cgauss(rng, 1, 3, 4), cgauss(rng, 4, 3, 5), cgauss(rng, 5, 3, 2),
             cgauss(rng, 2, 3, 1)]
    out = tci_tpu_torch.TensorTrain(cores, device="cpu")
    ref = tci_tpu.TensorTrain(cores)
    full = np.asarray(tci_tpu.fulltensor(ref))
    scale = float(np.abs(full).max())
    assert isinstance(out.norm(), float)
    assert abs(out.norm() - ref.norm()) <= 1e-13 * ref.norm()
    assert abs(out.sum() - ref.sum()) <= 1e-13 * scale * full.size
    ofull = tci_tpu_torch.fulltensor(out)
    assert ofull.dtype == torch.complex128
    np.testing.assert_allclose(ofull.numpy(), full, rtol=0, atol=1e-13 * scale)
    two = tci_tpu_torch.add(out, out, tolerance=1e-12)
    np.testing.assert_allclose(tci_tpu_torch.fulltensor(two).numpy(),
                               2 * full, rtol=0, atol=1e-12 * scale)
    assert tci_tpu_torch.subtract(out, out).norm() <= 1e-12 * out.norm()
    for method in ("LU", "CI", "SVD"):
        c, r = out.copy(), tci_tpu.TensorTrain(cores)
        c.compress(method, tolerance=1e-12)
        r.compress(method, tolerance=1e-12)
        assert c.linkdims() == r.linkdims()
        np.testing.assert_allclose(tci_tpu_torch.fulltensor(c).numpy(), full,
                                   rtol=0, atol=1e-12 * scale)


def test_complex_rook_raises_naming_a9(monkeypatch):
    """(Named when rook raised, naming ROADMAP A9.) A complex rook bond
    update on the host tier now runs, at full precision in complex128, and
    picks tci_tpu's pivots; the host tier draws each bond's start set from
    a new unseeded generator in both packages, seeded here in call order
    (ROADMAP C-ref-4)."""
    f = lambda v: (1 + 1j) / (1 + sum(v))  # noqa: E731
    orig = np.random.default_rng
    outs = []
    for pkg, kw in ((tci_tpu, {}), (tci_tpu_torch, {"device": "cpu"})):
        draws = itertools.count(100)
        monkeypatch.setattr(np.random, "default_rng",
                            lambda seed=None: orig(next(draws) if seed is None
                                                   else seed))
        t = pkg.TensorCI2.from_function(f, [4] * 3, dtype=np.complex128,
                                        **kw)
        t.updatepivots(0, f, True, pivotsearch="rook")
        outs.append(t)
    ref, out = outs
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    assert out.sitetensors()[0].dtype == torch.complex128
    np.testing.assert_allclose(out.pivoterrors, ref.pivoterrors, rtol=1e-12,
                               atol=1e-15)


# -- BASELINE config 5's integrand (benchmarks/bench_feynman.py) at N = 4,
#    GK7: TCI2 on the engine, the fused tier and the host tier

N5, GK5, TOL5 = 4, 7, 1e-7
_nodes1d, _weights1d, _ = kronrod(GK5 // 2)
NODES5 = (_nodes1d + 1) / 2  # [0, 1]
WEIGHTS5 = _weights1d / 2
NORM5 = float(GK5) ** N5
DIMS5 = [len(_nodes1d)] * N5


def feynman_jax(idx):
    t = jnp.asarray(NODES5)[idx]
    w = jnp.prod(jnp.asarray(WEIGHTS5)[idx])
    damp = jnp.exp(-jnp.sum((t[:, None] - t[None, :]) ** 2))
    return w * damp * NORM5 * jnp.exp(1j * 10.0 * jnp.sum(t))


_NODES_T = torch.as_tensor(NODES5)
_WEIGHTS_T = torch.as_tensor(WEIGHTS5)


def feynman_torch(idx):
    t = _NODES_T[idx]
    w = _WEIGHTS_T[idx].prod(1)
    damp = torch.exp(-((t[:, :, None] - t[:, None, :]) ** 2).sum((1, 2)))
    return torch.polar(w * damp * NORM5, 10.0 * t.sum(1))


def feynman_numpy(idx):
    t = NODES5[idx]
    w = np.prod(WEIGHTS5[idx], axis=1)
    damp = np.exp(-np.sum((t[:, :, None] - t[:, None, :]) ** 2, axis=(1, 2)))
    return w * damp * NORM5 * np.exp(1j * 10.0 * np.sum(t, axis=1))


def _dense_gk_sum():
    idx = np.asarray(list(itertools.product(range(GK5), repeat=N5)))
    return complex(np.sum(feynman_numpy(idx))) / NORM5


def _solve5(f, **kw):
    return tci_tpu_torch.crossinterpolate2(
        np.complex128, f, DIMS5, tolerance=TOL5, nsearchglobalpivot=10,
        rng=np.random.default_rng(0), device="cpu", **kw)


@pytest.fixture(scope="module")
def config5_reference():
    bj = JaxBatchEvaluator(feynman_jax, DIMS5, dtype=np.complex128)
    t, ranks, errors = tci_tpu.crossinterpolate2(
        np.complex128, bj, DIMS5, tolerance=TOL5, nsearchglobalpivot=10,
        rng=np.random.default_rng(0))
    return {"ranks": ranks, "errors": errors, "linkdims": t.linkdims(),
            "integral": complex(t.sum()) / NORM5, "nevals": int(bj.nevals)}


def _set_protocol(bt, pair, loop):
    bt.device_sweep_engine.use_sweep_pair = pair
    bt.device_sweep_engine.use_optimize_loop = loop


def _same_tci_bitwise(a, b):
    assert a.Iset == b.Iset and a.Jset == b.Jset
    assert a.Iset_history == b.Iset_history
    assert a.Jset_history == b.Jset_history
    for x, y in zip(a.sitetensors(), b.sitetensors()):
        assert torch.equal(x, y)


def test_config5_engine_matches_tci_tpu(config5_reference):
    """The default TorchBatchEvaluator (the engine under tci_tpu's default
    protocol) against tci_tpu's native-complex JaxBatchEvaluator; then the
    port's per-sweep protocols bit for bit its default one."""
    ref = config5_reference
    dense = _dense_gk_sum()
    runs = {}
    for pair, loop in ((True, True), (True, False), (False, False)):
        bt = TorchBatchEvaluator(feynman_torch, DIMS5,
                                 dtype=torch.complex128, device="cpu")
        _set_protocol(bt, pair, loop)
        runs[pair, loop] = (*_solve5(bt), bt)
    t, ranks, errors, bt = runs[True, True]
    assert ranks == ref["ranks"] == [12, 11, 11]
    assert t.linkdims() == ref["linkdims"]
    assert abs(errors[-1] - ref["errors"][-1]) <= 1e-3 * ref["errors"][-1]
    assert bt.nevals == ref["nevals"]
    assert bt.device_sweep_engine.loop_blocks > 0
    assert bt._fused_updater is None
    integral = t.sum() / NORM5
    assert isinstance(integral, complex)
    assert abs(integral - ref["integral"]) <= 1e-12
    assert abs(integral - dense) <= errors[-1] * t.maxsamplevalue
    for key in ((True, False), (False, False)):
        o, oranks, oerrors, _ = runs[key]
        assert oranks == ranks and oerrors == errors
        _same_tci_bitwise(o, t)


def test_config5_fused_and_host_tiers(config5_reference):
    """The fused tier (engine off) and the host tier (a numpy integrand):
    config 5's ranks and integral."""
    ref = config5_reference
    bt = TorchBatchEvaluator(feynman_torch, DIMS5, dtype=torch.complex128,
                             device="cpu", enable_device_sweep=False)
    vb = VectorizedBatchEvaluator(feynman_numpy, DIMS5, dtype=np.complex128)
    for f in (bt, vb):
        t, ranks, errors = _solve5(f)
        assert ranks == ref["ranks"] == [12, 11, 11]
        assert t.linkdims() == ref["linkdims"]
        assert abs(errors[-1] - ref["errors"][-1]) <= 1e-3 * ref["errors"][-1]
        assert abs(t.sum() / NORM5 - ref["integral"]) <= 1e-12
    assert bt.fused_updater.rrlu_calls > 0
    # the host tier against tci_tpu's host tier on the same numpy
    # integrand. The integrand is symmetric under a permutation of its
    # legs, so pivot candidates tie exactly and rounding picks among them:
    # the pivot sets are not compared, the ranks and errors are
    r, rranks, rerrors = tci_tpu.crossinterpolate2(
        np.complex128, JaxVBE(feynman_numpy, DIMS5, dtype=np.complex128),
        DIMS5, tolerance=TOL5, nsearchglobalpivot=10,
        rng=np.random.default_rng(0))
    assert ranks == rranks and t.linkdims() == r.linkdims()
    np.testing.assert_allclose(errors, rerrors, rtol=1e-3, atol=0)


def test_config5_floatingzone_program_matches_host_search():
    """estimatetrueerror on config 5's complex train: the engine's
    floating-zone program (a complex field in its record) against the host
    lock-step search from the same starts: the same best pivot, and every
    start's result within rounding of the |f - tt| differences."""
    bt = TorchBatchEvaluator(feynman_torch, DIMS5, dtype=torch.complex128,
                             device="cpu")
    t, _, _ = _solve5(bt)
    tt = tci_tpu_torch.tensortrain(t)
    engine = bt.device_sweep_engine
    rng = np.random.default_rng(3)
    starts = [tuple(int(rng.integers(0, d)) for d in DIMS5)
              for _ in range(20)]
    dev = engine.floatingzone(tt.sitetensors(), np.asarray(starts))
    assert dev is not None
    key = ("fzone", 20, 16)
    assert key in engine._sweeps
    assert engine._sweeps[key].cores.dtype == torch.complex128
    host = globalsearch._floatingzone_batch(tt, bt, starts)
    pivots, maxerr = dev
    ms = t.maxsamplevalue
    for s, (p, e) in enumerate(host):
        assert abs(maxerr[s] - e) <= 1e-15 * ms
    best_dev = int(np.argmax(maxerr))
    best_host = max(range(len(host)), key=lambda s: host[s][1])
    assert best_dev == best_host
    assert tuple(pivots[best_dev]) == host[best_host][0]
    # estimatetrueerror through the program, against tci_tpu's on the
    # same train and starts
    out = tci_tpu_torch.estimatetrueerror(tt, bt, initialpoints=starts)
    ref = tci_tpu.estimatetrueerror(
        tci_tpu.TensorTrain([c.numpy() for c in tt.sitetensors()]),
        lambda x: complex(feynman_numpy(np.asarray([x]))[0]),
        initialpoints=starts)
    assert out[0][0] == tuple(ref[0][0])
    assert abs(out[0][1] - ref[0][1]) <= 1e-15 * ms


def test_global_pivot_finder_keeps_the_imaginary_part():
    """A plain complex f: the finder ranks candidates by |f - tt| of the
    complex values. Against the zero train, from the start (0, 0), the
    real part is largest at (1, 0) and |f| at (2, 0)."""
    vals = {(1, 0): 1.0 + 0.0j, (2, 0): 0.1 + 2.0j}
    f = lambda x: vals.get(tuple(x), 0.0j)  # noqa: E731
    zero = [np.zeros((1, 3, 1), np.complex128) for _ in range(2)]
    tt = tci_tpu_torch.TensorTrain(zero, device="cpu")
    inp = GlobalPivotSearchInput([3, 3], tt, 2.0, [[()], [(0,)]],
                                 [[(0,)], [()]])
    finder = DefaultGlobalPivotFinder(nsearch=1, maxnglobalpivot=1)
    out = finder(inp, f, 0.01, initial_points=[(0, 0)])
    assert out == [(2, 0)]
    from tci_tpu.models.globalpivotfinder import (
        DefaultGlobalPivotFinder as JaxFinder, GlobalPivotSearchInput as JIn)
    ref = JaxFinder(nsearch=1, maxnglobalpivot=1)(
        JIn([3, 3], tci_tpu.TensorTrain(zero), 2.0, [[()], [(0,)]],
            [[(0,)], [()]]), f, 0.01, initial_points=[(0, 0)])
    assert out == [tuple(p) for p in ref]


def test_integrate_complex_matches_tci_tpu():
    """integrate(np.complex128, ...) at N = 3, GK7: torch_native=True and
    vectorized=True against tci_tpu.integrate on the same integrand."""
    N = 3

    def fnp(X):
        return np.exp(1j * 10.0 * X.sum(axis=1)) / (1.0 + (X ** 2).sum(axis=1))

    def ftorch(X):
        return torch.polar(1.0 / (1.0 + (X ** 2).sum(dim=1)),
                           10.0 * X.sum(dim=1))

    kw = dict(GKorder=7, tolerance=1e-10)
    ref = tci_tpu.integrate(np.complex128, fnp, [0.0] * N, [1.0] * N,
                            vectorized=True, rng=np.random.default_rng(0),
                            **kw)
    outs = [tci_tpu_torch.integrate(
        np.complex128, f, [0.0] * N, [1.0] * N, device="cpu",
        rng=np.random.default_rng(0), **flag, **kw)
        for f, flag in ((ftorch, {"torch_native": True}),
                        (fnp, {"vectorized": True}))]
    for out in outs:
        assert isinstance(out, complex)
        assert abs(out - ref) <= 1e-12 * abs(ref)


def test_program_record_complex_field_is_aligned():
    """A complex field of a program's record starts on a 16-byte boundary
    whatever precedes it, and reads back what was loaded."""
    eng = device_sweep.DeviceSweepEngine(lambda i: i.sum(1), [3, 3],
                                         dtype=torch.complex128,
                                         device="cpu")
    prog = device_sweep._Program(eng, ("t",), 0, None, 0,
                                 [("a", (3,), "i"), ("z", (2, 2), "c")])
    assert prog._offset["z"] % 2 == 0
    z = np.asarray([[1 + 2j, -3j], [4.5, 0.25 - 1j]])
    prog.load(a=[1, 2, 3], z=z)
    assert np.array_equal(prog.z.numpy(), z)
    assert prog.a.tolist() == [1, 2, 3]
