"""Contraction of tci_tpu_torch against tci_tpu's, on the same numpy data
(the port on device="cpu", its rrLU the plain version): the cases of
tests/test_contraction.py, each run through both packages, and the TCI
cases of tests/test_contraction_device.py: TCI with torch_native=True (the
port's engine over the product evaluator) against tci_tpu's jax_native
TCI. The TCI contractions draw their initial pivots from the same seeded
generator.

Tolerances: the dense matrices of the results within 1e-12 relative of
tci_tpu's and of the dense product (1e-10 for TCI, whose fit is exact to
its tolerance), linkdims identical; the contraction helper and the batch
evaluations 1e-13.
"""

import itertools

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu.models.contraction import _contract as _contract_ref
from tci_tpu_torch.models.contraction import _contract

torch.set_num_threads(1)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _tomat(tto) -> np.ndarray:
    """Dense matrix of a 4-leg TT (either package's); the row index fuses
    the upper legs in C order."""
    sd = tto.sitedims()
    d1 = [s[0] for s in sd]
    d2 = [s[1] for s in sd]
    mat = np.empty((int(np.prod(d1)), int(np.prod(d2))), dtype=complex)
    for i, inds1 in enumerate(itertools.product(*[range(d) for d in d1])):
        for j, inds2 in enumerate(itertools.product(*[range(d) for d in d2])):
            mat[i, j] = tto.evaluate(list(zip(inds1, inds2)))
    return mat


def _tovec(tt) -> np.ndarray:
    sd = tt.sitedims()
    d1 = [s[0] for s in sd]
    return np.array([tt.evaluate(list(i))
                     for i in itertools.product(*[range(d) for d in d1])])


def _crand(rng, *shape):
    return rng.random(shape) + 1j * rng.random(shape)


def _gen_tto_tto(seed=1234):
    rng = np.random.default_rng(seed)
    N, bd = 4, [1, 2, 3, 2, 1]
    d1, d2, d3 = [2] * N, [3] * N, [2] * N
    a = [_crand(rng, bd[n], d1[n], d2[n], bd[n + 1]) for n in range(N)]
    b = [_crand(rng, bd[n], d2[n], d3[n], bd[n + 1]) for n in range(N)]
    return N, a, b, d1, d3


def _gen_tto_tts(seed=1234):
    rng = np.random.default_rng(seed)
    N, bd = 4, [1, 2, 3, 2, 1]
    d1, d2 = [3] * N, [3] * N
    a = [_crand(rng, bd[n], d1[n], d2[n], bd[n + 1]) for n in range(N)]
    b = [_crand(rng, bd[n], d2[n], bd[n + 1]) for n in range(N)]
    return N, a, b, d1


def _both(cores):
    return (tci_tpu.TensorTrain([c.copy() for c in cores]),
            tci_tpu_torch.TensorTrain(cores, device="cpu"))


def test_contract_helper():
    rng = np.random.default_rng(1234)
    a = rng.random((2, 3, 4))
    b = rng.random((2, 5, 4))
    ab = _contract(torch.from_numpy(a), torch.from_numpy(b), (0, 2), (0, 2))
    assert _rel(ab, _contract_ref(a, b, (0, 2), (0, 2))) < 1e-13
    assert _rel(ab, np.einsum("iak,ibk->ab", a, b)) < 1e-13


def _double(x):
    return 2 * x


def _kwargs(algorithm):
    return {"rng": np.random.default_rng(3)} if algorithm == "TCI" else {}


@pytest.mark.parametrize("f", [None, _double])
@pytest.mark.parametrize("algorithm", ["TCI", "naive"])
def test_mpo_mpo_contraction(f, algorithm):
    N, a, b, d1, d3 = _gen_tto_tto()
    (ja, pa), (jb, pb) = _both(a), _both(b)
    if f is not None and algorithm == "naive":
        with pytest.raises(ValueError, match="elementwise"):
            tci_tpu_torch.contract(pa, pb, f=f, algorithm=algorithm)
        return
    ref = tci_tpu.contract(ja, jb, f=f, algorithm=algorithm,
                           **_kwargs(algorithm))
    out = tci_tpu_torch.contract(pa, pb, f=f, algorithm=algorithm,
                                 **_kwargs(algorithm))
    assert out.sitedims() == [[d1[i], d3[i]] for i in range(N)]
    assert out.linkdims() == ref.linkdims()
    assert all(t.device.type == "cpu" for t in out.sitetensors())
    exact = _tomat(ja) @ _tomat(jb)
    if f is not None:
        exact = f(exact)
    tol = 1e-10 if algorithm == "TCI" else 1e-12
    assert _rel(_tomat(out), exact) < tol
    assert _rel(_tomat(out), _tomat(ref)) < tol


def test_contraction_batchevaluate():
    N, a, b, d1, d3 = _gen_tto_tto()
    (ja, pa), (jb, pb) = _both(a), _both(b)
    ref = tci_tpu.Contraction(ja, jb)
    ab = tci_tpu_torch.Contraction(pa, pb)
    L, R = [(0,)], [(0,)]
    full = ab.batch_evaluate(L, R, 2)
    assert _rel(full, ref.batch_evaluate(L, R, 2)) < 1e-13
    fullm = full.reshape(1, 2, 2, 2, 2, 1)
    for proj, sl in (([[0, 0], [1, 0]], (slice(None),) * 3 + (0,)),
                     ([[0, 0], [1, 1]], (slice(None),) * 3 + (0, 0)),
                     ([[0, 1], [1, 0]], (slice(None),) * 2 + (0, 0))):
        res = ab.batch_evaluate(L, R, 2, projector=proj)
        assert _rel(res, ref.batch_evaluate(L, R, 2, projector=proj)) < 1e-13
        assert _rel(res.reshape(-1), fullm[sl].reshape(-1)) < 1e-13
    # a single evaluation through the environment caches, fused and unfused
    idx = [3, 1, 0, 2]
    assert abs(ab(idx) - ref(idx)) < 1e-13 * abs(ref(idx))
    assert ab([(1, 1), (0, 1), (0, 0), (1, 0)]) == ab(idx)


@pytest.mark.parametrize("f", [None, _double])
@pytest.mark.parametrize("algorithm", ["TCI", "naive"])
def test_mpo_mps_contraction(f, algorithm):
    N, a, b, d1 = _gen_tto_tts()
    (ja, pa), (jb, pb) = _both(a), _both(b)
    if f is not None and algorithm == "naive":
        with pytest.raises(ValueError, match="elementwise"):
            tci_tpu_torch.contract(pa, pb, f=f, algorithm=algorithm)
        with pytest.raises(ValueError, match="elementwise"):
            tci_tpu_torch.contract(pb, pa, f=f, algorithm=algorithm)
        return
    tol = 1e-10 if algorithm == "TCI" else 1e-12
    exact_ab = _tomat(ja) @ _tovec(jb)
    exact_ba = _tovec(jb) @ _tomat(ja)
    for x, y, exact, jx, jy in ((pa, pb, exact_ab, ja, jb),
                                (pb, pa, exact_ba, jb, ja)):
        out = tci_tpu_torch.contract(x, y, f=f, algorithm=algorithm,
                                     **_kwargs(algorithm))
        ref = tci_tpu.contract(jx, jy, f=f, algorithm=algorithm,
                               **_kwargs(algorithm))
        assert out.sitedims() == [[d1[i]] for i in range(N)]
        assert out.linkdims() == ref.linkdims()
        want = exact if f is None else f(exact)
        assert _rel(_tovec(out), want) < tol
        assert _rel(_tovec(out), _tovec(ref)) < tol


@pytest.mark.parametrize("method", ["SVD", "LU"])
def test_mpo_mpo_zipup(method):
    N, a, b, d1, d3 = _gen_tto_tto()
    (ja, pa), (jb, pb) = _both(a), _both(b)
    ref = tci_tpu.contract(ja, jb, algorithm="zipup", method=method)
    out = tci_tpu_torch.contract(pa, pb, algorithm="zipup", method=method)
    assert out.linkdims() == ref.linkdims()
    assert _rel(_tomat(out), _tomat(ja) @ _tomat(jb)) < 1e-12
    assert _rel(_tomat(out), _tomat(ref)) < 1e-12


@pytest.mark.parametrize("method", ["SVD", "LU"])
def test_mpo_mps_zipup(method):
    N, a, b, d1 = _gen_tto_tts()
    (ja, pa), (jb, pb) = _both(a), _both(b)
    ref = tci_tpu.contract(ja, jb, algorithm="zipup", method=method)
    out = tci_tpu_torch.contract(pa, pb, algorithm="zipup", method=method)
    assert out.linkdims() == ref.linkdims()
    assert _rel(_tovec(out), _tomat(ja) @ _tovec(jb)) < 1e-12
    assert _rel(_tovec(out), _tovec(ref)) < 1e-12


def test_contract_rejects():
    """Both operands MPS, an unknown algorithm, mesh= without
    torch_native=True (as in tci_tpu), and trains of other lengths."""
    N, a, b, d1 = _gen_tto_tts()
    _, pa = _both(a)
    _, pb = _both(b)
    with pytest.raises(ValueError, match="4-leg"):
        tci_tpu_torch.contract(pb, pb)
    with pytest.raises(ValueError, match="Unknown algorithm"):
        tci_tpu_torch.contract(pa, pb, algorithm="nope")
    for algorithm in ("TCI", "naive", "zipup"):
        with pytest.raises(ValueError, match="torch_native=True"):
            tci_tpu_torch.contract(pa, pb, algorithm=algorithm,
                                   mesh=object())
    short = tci_tpu_torch.TensorTrain(a[:3], device="cpu")
    with pytest.raises(ValueError, match="length"):
        tci_tpu_torch.contract(short, pa, algorithm="naive")



def test_contract_tci_search_draws_where_tci_tpu_does_c_ref_6(monkeypatch):
    """ROADMAP C-ref-6: contract_TCI spends its `rng` on the initial
    pivots and passes none to crossinterpolate2, so the global search
    draws from a new unseeded default_rng() (tci_tpu's
    models/contraction.py:338-391; the port does the same, and on a mesh
    seeds that draw from rank 0). With default_rng's no-argument calls
    seeded, each package gives one result, the two make their unseeded
    draws at the same calls, and their results agree to rounding (1e-15
    relative): the port draws for the search exactly where tci_tpu does."""
    rng = np.random.default_rng(3)
    L = 5
    ba = [1] + [3] * (L - 1) + [1]
    bb = [1] + [2] * (L - 1) + [1]
    a = [_crand(rng, ba[n], 2, 3, ba[n + 1]) for n in range(L)]
    b = [_crand(rng, bb[n], 3, 2, bb[n + 1]) for n in range(L)]
    default_rng, unseeded = np.random.default_rng, []

    def seeded(seed=None, *args, **kwargs):
        if seed is None:
            unseeded.append(len(unseeded))
            seed = 11
        return default_rng(seed, *args, **kwargs)

    monkeypatch.setattr(np.random, "default_rng", seeded)
    results = {}
    for name, (A, B) in (("tci_tpu", _both(a)[0:1] + _both(b)[0:1]),
                         ("port", _both(a)[1:] + _both(b)[1:])):
        runs = []
        for _ in range(3):
            unseeded.clear()
            tt = (tci_tpu if name == "tci_tpu" else tci_tpu_torch).contract(
                A, B, algorithm="TCI", maxbonddim=2, rng=default_rng(7))
            runs.append((_tomat(tt), len(unseeded)))
        assert all(_rel(m, runs[0][0]) == 0.0 and n == runs[0][1]
                   for m, n in runs)
        results[name] = runs[0]
    assert results["port"][1] == results["tci_tpu"][1] > 0
    assert _rel(results["port"][0], results["tci_tpu"][0]) < 1e-15

# -- TCI on the port's engine (tests/test_contraction_device.py's TCI cases) --


def _tci_operands(name):
    rng = np.random.default_rng(1234)
    bonds = [1, 4, 4, 4, 1]
    if name == "real":
        # low rank: each core a (χ d d 2) x (2 χ) product, exact rank <= 4
        ts = [[(rng.standard_normal((bonds[n], 2, 2, 2))
                @ rng.standard_normal((2, bonds[n + 1]))) / np.sqrt(2)
               for n in range(4)] for _ in range(2)]
    else:
        bonds = [1, 2, 2, 2, 1]
        ts = [[rng.standard_normal((bonds[n], 2, 2, bonds[n + 1]))
               + 1j * rng.standard_normal((bonds[n], 2, 2, bonds[n + 1]))
               for n in range(4)] for _ in range(2)]
    return _both(ts[0]), _both(ts[1])


@pytest.fixture(scope="module")
def tci_reference():
    """tci_tpu's jax_native TCI contractions (its engine; one XLA compile a
    problem), real and complex, each from its own seed."""
    out = {}
    for name, seed in (("real", 7), ("complex", 3)):
        (ja, _), (jb, _) = _tci_operands(name)
        out[name] = tci_tpu.contract(ja, jb, algorithm="TCI", tolerance=1e-10,
                                     jax_native=True,
                                     rng=np.random.default_rng(seed))
    return out


@pytest.mark.parametrize("name,seed", [("real", 7), ("complex", 3)])
def test_device_tci_contraction_matches(tci_reference, name, seed):
    """contract(algorithm="TCI", torch_native=True): TCI2 on the port's
    engine over the product evaluator; tci_tpu's linkdims, the dense
    product within 1e-10."""
    (ja, pa), (jb, pb) = _tci_operands(name)
    out = tci_tpu_torch.contract(pa, pb, algorithm="TCI", tolerance=1e-10,
                                 torch_native=True,
                                 rng=np.random.default_rng(seed))
    ref = tci_reference[name]
    assert out.linkdims() == ref.linkdims()
    exact = _tomat(ja) @ _tomat(jb)
    assert _rel(_tomat(out), exact) < 1e-10
    assert _rel(_tomat(ref), exact) < 1e-10


def test_device_tci_postmap():
    (ja, pa), (jb, pb) = _tci_operands("real")
    out = tci_tpu_torch.contract(pa, pb, algorithm="TCI", tolerance=1e-10,
                                 f=_double, torch_native=True,
                                 rng=np.random.default_rng(7))
    assert _rel(_tomat(out), 2 * (_tomat(ja) @ _tomat(jb))) < 1e-10
