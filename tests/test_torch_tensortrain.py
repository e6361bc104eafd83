"""The TT algebra and compression of tci_tpu_torch against tci_tpu's, on the
same numpy data (the port on device="cpu", its rrLU the plain version):
the LU helpers, factorize, compress, add / subtract, norm / norm2,
tt_reverse, reshape_sites, multiply / divide, fulltensor and TensorTrainFit.

Tolerances (relative to the largest entry compared): LU helpers 1e-13 with
the pivot order identical; factorize "LU" / "CI" 1e-13, "SVD" the same rank
and left @ right to 1e-12 (singular vectors differ in sign between LAPACK
builds); compress: linkdims identical and fulltensor 1e-12, and for a
well-conditioned train the "LU" / "CI" cores 1e-12; add / subtract and the norms 1e-13; reshapes,
reversal, scaling and fulltensor 1e-15 (the same products in another
library); TensorTrainFit's loss 1e-13 and its gradient (autograd against
jax.grad) 1e-12.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch

torch.set_num_threads(1)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    scale = max(np.max(np.abs(b)), 1e-300) if b.size else 1.0
    return float(np.max(np.abs(a - b)) / scale) if b.size else 0.0


def _random_tt(T, linkdims, localdims, seed=1234):
    rng = np.random.default_rng(seed)

    def randn(*shape):
        x = rng.standard_normal(shape)
        if T == np.complex128:
            x = x + 1j * rng.standard_normal(shape)
        return x.astype(T)

    return [randn(linkdims[n], localdims[n], linkdims[n + 1])
            for n in range(len(localdims))]


def _both(cores):
    return (tci_tpu.TensorTrain([c.copy() for c in cores]),
            tci_tpu_torch.TensorTrain(cores, device="cpu"))


def _lorentzian_tt():
    """tci_tpu's TT of a 5-site Lorentzian on [6]^5 (rank 4-6 bonds)."""
    f = lambda x: 1.0 / (1.0 + sum((i + 1.0) ** 2 for i in x))
    t, _, _ = tci_tpu.crossinterpolate2(np.float64, f, [6] * 5,
                                        tolerance=1e-10,
                                        rng=np.random.default_rng(0))
    return [np.asarray(c) for c in t.sitetensors()]


# -- LU helpers ------------------------------------------------------------


def _square_lu(seed=5, n=6):
    rng = np.random.default_rng(seed)
    return np.tril(rng.random((n, n))) @ np.triu(rng.random((n, n))) + np.eye(n)


@pytest.mark.parametrize("helper", ["cols2Lmatrix", "rows2Umatrix"])
def test_lu_helpers_match(helper):
    rng = np.random.default_rng(11)
    P = np.triu(rng.random((5, 5))) + np.eye(5)
    if helper == "rows2Umatrix":
        P = P.T.copy()
        X = rng.standard_normal((5, 7))
    else:
        X = rng.standard_normal((7, 5))
    ref = getattr(tci_tpu, helper)(X, P, True)
    out = getattr(tci_tpu_torch, helper)(X, P, True, device="cpu")
    assert _rel(out, ref) < 1e-13
    # tensors stay where they are, with no device argument
    outt = getattr(tci_tpu_torch, helper)(torch.from_numpy(X),
                                          torch.from_numpy(P), True)
    assert torch.equal(outt, out)


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_lu_solve_matches(rhs):
    A = _square_lu()
    b = np.random.default_rng(2).random((6,) if rhs == "vector" else (6, 3))
    lu_ref = tci_tpu.rrlu(A)
    lu = tci_tpu_torch.rrlu(A, device="cpu")
    assert np.array_equal(lu.rowpermutation, lu_ref.rowpermutation)
    assert np.array_equal(lu.colpermutation, lu_ref.colpermutation)
    ref = tci_tpu.lu_solve(lu_ref, b)
    assert _rel(tci_tpu_torch.lu_solve(lu, b), ref) < 1e-13
    assert _rel(lu.solve(b), lu_ref.solve(b)) < 1e-13
    with pytest.raises(ValueError, match="rank-deficient"):
        tci_tpu_torch.lu_solve(tci_tpu_torch.rrlu(A, maxrank=3,
                                                  device="cpu"), b)


# -- factorize -------------------------------------------------------------


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("normalizeerror", [True, False])
@pytest.mark.parametrize("method", ["LU", "CI", "SVD"])
def test_factorize_matches(method, normalizeerror, leftorthogonal):
    rng = np.random.default_rng(4)
    A = (rng.standard_normal((12, 5)) @ rng.standard_normal((5, 9))
         + 1e-6 * rng.standard_normal((12, 9)))
    tol = 1e-4 if normalizeerror else 1e-3
    kw = dict(tolerance=tol, maxbonddim=7, leftorthogonal=leftorthogonal,
              normalizeerror=normalizeerror)
    lref, rref, kref = tci_tpu.factorize(A, method, **kw)
    left, right, k = tci_tpu_torch.factorize(A, method, device="cpu", **kw)
    assert k == kref == 5
    if method == "SVD":
        assert _rel(left @ right, lref @ rref) < 1e-12
    else:
        assert _rel(left, lref) < 1e-13 and _rel(right, rref) < 1e-13


# -- compress --------------------------------------------------------------


def _tt_cases():
    return {
        "lorentzian": _lorentzian_tt(),
        # test_tensortrain.test_compress_svd's shape: rank-10 random cores
        "random": _random_tt(np.float64, [1] + [10] * 9 + [1], [2] * 10),
    }


@pytest.fixture(scope="module")
def tt_cases():
    return _tt_cases()


# The Lorentzian's bonds hold singular values down to ~1e-11, so its LU / CI
# cores are fixed only to eps * cond of their pivot blocks (~1e-10: the two
# eliminations round differently, ROADMAP C-port-1) while the train itself
# agrees to 1e-16; it is compared by linkdims and fulltensor, the
# well-conditioned random train core by core.
@pytest.mark.parametrize("method", ["LU", "CI", "SVD"])
@pytest.mark.parametrize("case", ["lorentzian", "random"])
@pytest.mark.parametrize("opts", [
    dict(tolerance=1e-12), dict(tolerance=1e-3), dict(maxbonddim=3),
    dict(tolerance=1e-4, normalizeerror=False)])
def test_compress_matches(tt_cases, case, method, opts):
    ref, out = _both(tt_cases[case])
    ref.compress(method, **opts)
    out.compress(method, **opts)
    assert out.linkdims() == ref.linkdims()
    assert _rel(tci_tpu_torch.fulltensor(out), tci_tpu.fulltensor(ref)) < 1e-12
    if method != "SVD" and case == "random":
        for a, b in zip(out.sitetensors(), ref.sitetensors()):
            assert _rel(a, b) < 1e-12


# C-port-10: a float32 train through each method. tci_tpu's LU and CI
# splits give float64 factors and numpy promotes the next core; the port's
# products promote likewise. SVD keeps float32 in both.
@pytest.mark.parametrize("method", ["LU", "CI", "SVD"])
def test_compress_float32_train(method):
    rng = np.random.default_rng(1)
    cores = [rng.standard_normal(s).astype(np.float32)
             for s in ((1, 3, 3), (3, 4, 5), (5, 2, 4), (4, 3, 1))]
    ref = tci_tpu.TensorTrain([c.copy() for c in cores])
    out = tci_tpu_torch.TensorTrain([c.copy() for c in cores], device="cpu")
    ref.compress(method, tolerance=1e-3, maxbonddim=3)
    out.compress(method, tolerance=1e-3, maxbonddim=3)
    assert out.linkdims() == ref.linkdims()
    dtypes = {str(np.asarray(t).dtype) for t in ref.sitetensors()}
    assert {str(t.dtype)[6:] for t in out.sitetensors()} == dtypes
    assert dtypes == ({"float32"} if method == "SVD" else {"float64"})
    assert _rel(tci_tpu_torch.fulltensor(out).double(),
                np.asarray(tci_tpu.fulltensor(ref), np.float64)) < 1e-5


def test_compress_options_not_ported():
    """mesh= is not ported (ROADMAP A14); torch_native=True is (the device
    compression, tests/test_torch_compress_device.py) and, as tci_tpu's
    jax_native=True, takes method "LU" only."""
    tt = tci_tpu_torch.TensorTrain(_random_tt(np.float64, [1, 2, 1], [3, 3]),
                                   device="cpu")
    with pytest.raises(ValueError, match="method='LU'"):
        tt.compress("SVD", torch_native=True)
    with pytest.raises(NotImplementedError, match="A14"):
        tt.compress("LU", mesh=object())
    with pytest.raises(NotImplementedError, match="A14"):
        tt.compress("LU", torch_native=True, mesh=object())


# -- add, subtract, norms --------------------------------------------------


@pytest.mark.parametrize("T", [np.float64, np.complex128])
def test_add_subtract_norm_match(T):
    dims, bonds = [2, 2, 2], [1, 2, 3, 1]
    a_ref, a = _both(_random_tt(T, bonds, dims, seed=1))
    b_ref, b = _both(_random_tt(T, bonds, dims, seed=2))
    pairs = [
        (tci_tpu_torch.add(a, b), tci_tpu.add(a_ref, b_ref)),
        (a + b, a_ref + b_ref),
        (a - b, a_ref - b_ref),
        (tci_tpu_torch.subtract(a, b, tolerance=1e-10),
         tci_tpu.subtract(a_ref, b_ref, tolerance=1e-10)),
        (tci_tpu_torch.add(a, b, factorlhs=2.0, factorrhs=-0.5,
                           maxbonddim=2),
         tci_tpu.add(a_ref, b_ref, factorlhs=2.0, factorrhs=-0.5,
                     maxbonddim=2)),
    ]
    for out, ref in pairs:
        assert out.linkdims() == ref.linkdims()
        assert _rel(tci_tpu_torch.fulltensor(out),
                    tci_tpu.fulltensor(ref)) < 1e-13
        assert tci_tpu_torch.norm2(out) == pytest.approx(
            tci_tpu.norm2(ref), rel=1e-13)
        assert tci_tpu_torch.norm(out) == pytest.approx(tci_tpu.norm(ref),
                                                        rel=1e-13)
    with pytest.raises(ValueError):
        tci_tpu_torch.add(a, tci_tpu_torch.TensorTrain(a.sitetensors()[:2]))


def test_norm_of_a_tci_matches():
    """AbstractTensorTrain's norms reach TensorCI2 too."""
    dims = [4] * 5
    f = lambda x: 1.0 / (1.0 + sum((i + 1.0) ** 2 for i in x))
    ref, _, _ = tci_tpu.crossinterpolate2(np.float64, f, dims,
                                          tolerance=1e-8,
                                          rng=np.random.default_rng(0))
    out, _, _ = tci_tpu_torch.crossinterpolate2(np.float64, f, dims,
                                                tolerance=1e-8,
                                                rng=np.random.default_rng(0),
                                                device="cpu")
    assert out.norm2() == pytest.approx(ref.norm2(), rel=1e-13)
    assert out.norm() == pytest.approx(ref.norm(), rel=1e-13)
    assert (out - out).norm() <= 1e-12 * out.norm()


# -- reshapes, reversal, scaling, fulltensor -------------------------------


@pytest.mark.parametrize("T", [np.float64, np.complex128])
def test_tt_transforms_match(T):
    ref, out = _both(_random_tt(T, [1, 2, 3, 1], [4, 4, 4]))
    checks = [
        (tci_tpu_torch.fulltensor(out), tci_tpu.fulltensor(ref)),
        (tci_tpu_torch.fulltensor(tci_tpu_torch.tt_reverse(out)),
         tci_tpu.fulltensor(tci_tpu.tt_reverse(ref))),
        (tci_tpu_torch.fulltensor(out.reshape_sites([[2, 2]] * 3)),
         tci_tpu.fulltensor(ref.reshape_sites([[2, 2]] * 3))),
        (tci_tpu_torch.fulltensor(1.6 * out), tci_tpu.fulltensor(1.6 * ref)),
        (tci_tpu_torch.fulltensor(out * 1.6 / 3.2),
         tci_tpu.fulltensor(ref * 1.6 / 3.2)),
        (tci_tpu_torch.fulltensor(out.multiply(2.5)),
         tci_tpu.fulltensor(ref.multiply(2.5))),
        (tci_tpu_torch.fulltensor(out.divide(4.0)),
         tci_tpu.fulltensor(ref.divide(4.0))),
        (tci_tpu_torch.fulltensor(out.astype(np.complex128)),
         tci_tpu.fulltensor(ref.astype(np.complex128))),
    ]
    for o, r in checks:
        assert _rel(o, r) < 1e-15
    assert tci_tpu_torch.tt_reverse(out).linkdims() == \
        tci_tpu.tt_reverse(ref).linkdims()
    assert tci_tpu_torch.sitedims(out) == tci_tpu.sitedims(ref)
    for i in itertools.product(range(4), range(4), range(4)):
        assert tci_tpu_torch.evaluate(out, i) == pytest.approx(
            complex(tci_tpu.evaluate(ref, i)), rel=1e-13, abs=1e-15)
    with pytest.raises(ValueError):
        out.reshape_sites([[2, 3]] * 3)
    copied = out.copy()
    copied.sitetensors()[0].zero_()
    assert _rel(tci_tpu_torch.fulltensor(out), tci_tpu.fulltensor(ref)) < 1e-15


def test_multileg_add_matches():
    """Cores with two site legs: addition and evaluation by tuple index."""
    rng = np.random.default_rng(9)
    cores = [rng.standard_normal((b0, 2, 2, b1))
             for b0, b1 in ((1, 2), (2, 3), (3, 1))]
    ref, out = _both(cores)
    ref2, out2 = ref + ref, out + out
    assert out2.linkdims() == ref2.linkdims()
    for v in itertools.product(range(2), repeat=3):
        vv = list(zip(v, v))
        assert out2(vv) == pytest.approx(float(ref2(vv)), rel=1e-13)
    assert _rel(tci_tpu_torch.fulltensor(out2),
                tci_tpu.fulltensor(ref2)) < 1e-13


# -- TensorTrainFit ----------------------------------------------------------


@pytest.mark.parametrize("T", [np.float64, np.complex128])
def test_ttfit_loss_and_gradient_match(T):
    cores = _random_tt(T, [1, 2, 3, 1], [2, 2, 2], seed=5)
    ref_tt, tt = _both(cores)
    rng = np.random.default_rng(6)
    indexsets = [(0, 0, 0), (1, 1, 1), (0, 1, 0), (1, 0, 1)]
    values = rng.standard_normal(4).astype(T)
    if T == np.complex128:
        values = values + 1j * rng.standard_normal(4)
    ref_fit = tci_tpu.TensorTrainFit(indexsets, values, ref_tt)
    fit = tci_tpu_torch.TensorTrainFit(indexsets, values, tt)
    x0 = ref_fit.flatten()
    assert _rel(fit.flatten(), x0) == 0.0
    x = x0 + 0.1 * rng.standard_normal(x0.shape)
    assert fit(x) == pytest.approx(ref_fit(x), rel=1e-13)

    complex_ = T == np.complex128
    packed = np.concatenate([x.real, x.imag]) if complex_ else x.real
    n = len(x)

    def jax_loss(p):
        z = p[:n] + 1j * p[n:] if complex_ else p
        return ref_fit.loss_jax(z).real

    def torch_loss(p):
        z = torch.complex(p[:n], p[n:]) if complex_ else p
        return fit.loss_torch(z)

    ref_val, ref_grad = jax.value_and_grad(jax_loss)(jnp.asarray(packed))
    p = torch.tensor(packed, requires_grad=True)
    val = torch_loss(p)
    val.backward()
    assert val.item() == pytest.approx(float(ref_val), rel=1e-13)
    assert val.item() == pytest.approx(ref_fit(x), rel=1e-13)
    assert _rel(p.grad, np.asarray(ref_grad)) < 1e-12
