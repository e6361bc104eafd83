"""The port's ``integrate`` (tci_tpu_torch.models.integration) against
tci_tpu's, on the CPU, on the same bounds and the same ``rng`` seed.

Tolerances: integrals to 1e-12 relative (the polynomial integrands have TT
rank 1, so each path sums the same products in another order); the
vectorized pair samples through one numpy function, so its ranks and pivot
sets are identical and its errors agree to 1e-15 absolute (the rounding of
the Schur updates, tests/test_torch_tensorci2.py); the port's torch_native
integrand equals its vectorized one bit for bit when the integrand itself
is written with exactly rounded operations.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tci_tpu
import tci_tpu_torch
from tci_tpu_torch.models import integration

torch.set_num_threads(1)

COEFFICIENTS = [
    0.23637074801483304, 0.20661524945577847, 0.1850826417895819,
    0.8433788714289417, 0.5801482873508491, 0.20339438932656262,
    0.21593267492457668, 0.8052490409622802, 0.7189346124875339,
    0.9400806688257749, 0.355210845205325, 0.5251561513473092,
    0.6819965273401778, 0.9221987248861162, 0.04166444723413998,
]
N = 5


def _horner(x):
    """The polynomial by Horner's rule: multiplies and adds only, so numpy
    and torch round it alike."""
    y = x * 0 + COEFFICIENTS[-1]
    for c in COEFFICIENTS[-2::-1]:
        y = y * x + c
    return y


def _product(X):
    """prod_n p(X[:, n]) from left to right, on a numpy matrix or a torch
    tensor."""
    y = _horner(X[:, 0])
    for n in range(1, X.shape[1]):
        y = y * _horner(X[:, n])
    return y


def _scalar(xs):
    return float(_product(np.asarray(xs, dtype=float)[None, :])[0])


def _polynomialintegral(x):
    return sum(c * x ** (i + 1) / (i + 1) for i, c in enumerate(COEFFICIENTS))


def _bounds(case):
    if case == "unit":
        return [0.0] * N, [1.0] * N
    rng = np.random.default_rng(1234)
    return list(rng.random(N)), list(rng.random(N))


class _Captured(Exception):
    pass


def _capture(monkeypatch, run=True):
    """Record the weighted integrands that integrate hands to TCI2; with
    run=False the call ends there, by raising _Captured."""
    seen = []
    original = integration.crossinterpolate2

    def recording(valuetype, F, localdims, **kwargs):
        seen.append(F)
        if not run:
            raise _Captured
        return original(valuetype, F, localdims, **kwargs)

    monkeypatch.setattr(integration, "crossinterpolate2", recording)
    return seen


# the port's path, and the tci_tpu path it is held against
PATHS = {
    "scalar": ({}, _scalar, {}, _scalar),
    "vectorized": ({"vectorized": True}, _product,
                   {"vectorized": True}, _product),
    "torch_native": ({"torch_native": True}, _product,
                     {"vectorized": True}, _product),
}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("case", ["unit", "random"])
def test_integrate_polynomials(case, path):
    a, b = _bounds(case)
    kw, f, refkw, reff = PATHS[path]
    exact = float(np.prod([_polynomialintegral(bi) - _polynomialintegral(ai)
                           for ai, bi in zip(a, b)]))
    ref = tci_tpu.integrate(np.float64, reff, a, b,
                            rng=np.random.default_rng(0), **refkw)
    val = tci_tpu_torch.integrate(np.float64, f, a, b, device="cpu",
                                  rng=np.random.default_rng(0), **kw)
    assert np.isclose(ref, exact)
    assert abs(val - ref) <= 1e-12 * abs(ref)


def _weighted(a, b, GKorder=15):
    """The weighted integrand of the vectorized path, written out: both
    packages sample through this one numpy function."""
    a, b = np.asarray(a), np.asarray(b)
    nodes1d, weights1d, _ = tci_tpu.kronrod(GKorder // 2)
    nodes = (b[:, None] - a[:, None]) * (nodes1d[None, :] + 1) / 2 + a[:, None]
    weights = (b[:, None] - a[:, None]) * weights1d[None, :] / 2
    dims = np.arange(len(a))

    def fvec(idx):
        X = nodes[dims[None, :], idx]
        W = np.prod(weights[dims[None, :], idx], axis=1)
        return W * _product(X) * float(GKorder) ** len(a)

    return fvec, [GKorder] * len(a)


@pytest.mark.parametrize("case", ["unit", "random"])
def test_vectorized_pair_has_identical_pivots(case):
    fvec, localdims = _weighted(*_bounds(case))
    kw = {"nsearchglobalpivot": 10}
    ref, rranks, rerrs = tci_tpu.crossinterpolate2(
        np.float64, tci_tpu.VectorizedBatchEvaluator(fvec, localdims),
        localdims, rng=np.random.default_rng(0), **kw)
    out, oranks, oerrs = tci_tpu_torch.crossinterpolate2(
        np.float64, tci_tpu_torch.VectorizedBatchEvaluator(fvec, localdims),
        localdims, rng=np.random.default_rng(0), device="cpu", **kw)
    assert oranks == rranks
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    np.testing.assert_allclose(oerrs, rerrs, rtol=0, atol=1e-15)
    assert abs(out.sum() - ref.sum()) <= 1e-12 * abs(ref.sum())


@pytest.mark.parametrize("case", ["unit", "random"])
def test_torch_native_samples_the_vectorized_bits(case, monkeypatch):
    """The weight of a grid point is the left-to-right product of its N
    weights, which is what numpy's prod computes: the two weighted
    integrands agree bitwise, so exact ties in a panel break alike."""
    a, b = _bounds(case)
    seen = _capture(monkeypatch, run=False)
    for kw in ({"vectorized": True}, {"torch_native": True}):
        with pytest.raises(_Captured):
            tci_tpu_torch.integrate(np.float64, _product, a, b, device="cpu",
                                    **kw)
    fvec, ftorch = seen
    idx = np.random.default_rng(5).integers(0, 15, size=(4000, N))
    host = np.asarray(fvec.fvec(idx))
    dev = ftorch.evaluate_many(idx).numpy()
    assert np.array_equal(host, dev)
    assert np.array_equal(host, _weighted(a, b)[0](idx))


def test_integrate_torch_native_matches_jax_native():
    """tests/test_integration.py::test_integrate_jax_native on both."""
    n = 3
    ref = tci_tpu.integrate(
        np.float64, lambda x: jnp.prod(x) + 1.0, [0.0] * n, [1.0] * n,
        jax_native=True, tolerance=1e-10, rng=np.random.default_rng(0))
    val = tci_tpu_torch.integrate(
        np.float64, lambda X: torch.prod(X, dim=1) + 1.0, [0.0] * n,
        [1.0] * n, torch_native=True, tolerance=1e-10, device="cpu",
        rng=np.random.default_rng(0))
    assert np.isclose(ref, 0.5**n + 1.0)
    # both sides converge to 1e-10: a float32 evaluation would not pass
    assert abs(val - ref) <= 1e-9 * abs(ref)


@pytest.mark.parametrize("sweep", [True, False])
def test_torch_native_runs_the_engine_unless_disabled(sweep, monkeypatch):
    seen = _capture(monkeypatch)
    val = tci_tpu_torch.integrate(
        np.float64, lambda X: torch.prod(X, dim=1) + 1.0, [0.0] * 3,
        [1.0] * 3, torch_native=True, enable_device_sweep=sweep,
        tolerance=1e-10, device="cpu", rng=np.random.default_rng(0))
    assert np.isclose(val, 0.5**3 + 1.0)
    (F,) = seen
    assert isinstance(F, tci_tpu_torch.TorchBatchEvaluator)
    assert F.device.type == "cpu" and F.localdims == [15] * 3
    if sweep:
        assert F.device_sweep_engine.rrlu_calls > 0
        assert F._fused_updater is None
    else:
        assert F.device_sweep_engine is None
        assert F.fused_updater.rrlu_calls > 0


def test_argument_errors():
    f = lambda X: X[:, 0]
    with pytest.raises(ValueError, match="must be odd"):
        tci_tpu_torch.integrate(np.float64, f, [0.0], [1.0], GKorder=14,
                                device="cpu")
    with pytest.raises(ValueError, match="same dimensionality"):
        tci_tpu_torch.integrate(np.float64, f, [0.0, 0.0], [1.0],
                                device="cpu")
    with pytest.raises(ValueError, match=r"shape \(B,\)"):
        tci_tpu_torch.integrate(np.float64, lambda X: X, [0.0] * 2,
                                [1.0] * 2, vectorized=True, device="cpu")
    # as in tci_tpu, a mesh shards the device sampling path only
    for kw in ({}, {"vectorized": True}):
        with pytest.raises(ValueError, match="torch_native=True"):
            tci_tpu_torch.integrate(np.float64, f, [0.0] * 2, [1.0] * 2,
                                    mesh=object(), device="cpu", **kw)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for kw in ({}, {"vectorized": True}, {"torch_native": True}):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tci_tpu_torch.integrate(np.float64, lambda X: X[:, 0] + 1.0,
                                    [0.0] * 2, [1.0] * 2, **kw)


@pytest.mark.parametrize("path", list(PATHS))
def test_degenerate_bound(path, monkeypatch):
    """a_n = b_n gives zero weights in dimension n: every sample is an
    exact zero (no NaN from the weight product), and TCI2 refuses the zero
    function as tci_tpu's does."""
    a, b = [0.0, 0.5, 0.0], [1.0, 0.5, 2.0]
    kw, f, refkw, reff = PATHS[path]
    seen = _capture(monkeypatch)
    with pytest.raises(ValueError, match="maxsamplevalue is zero"):
        tci_tpu.integrate(np.float64, reff, a, b, **refkw)
    with pytest.raises(ValueError, match="maxsamplevalue is zero"):
        tci_tpu_torch.integrate(np.float64, f, a, b, device="cpu", **kw)
    (F,) = seen
    idx = np.random.default_rng(2).integers(0, 15, size=(50, 3))
    if path == "scalar":
        vals = np.asarray([F(tuple(row)) for row in idx])
    else:
        vals = np.asarray(F.evaluate_many(idx) if path == "torch_native"
                          else F.fvec(idx))
    assert np.array_equal(vals, np.zeros(50))
