"""TCI2 of tci_tpu_torch against tci_tpu on the same integrands and seeds
(the port runs its plain PyTorch elimination on the CPU).

Tolerances: ranks series and pivot sets identical. The errors series are
normalized magnitudes of first rejected pivots, formed by Schur updates
that round at ~1e-16 of max|f|; the two packages round those updates
differently (XLA on the CPU may fuse multiply and subtract), so errors agree
to 1e-15 absolute, not to a fixed number of digits. TT values agree to
1e-12; a site tensor Π1 · P^{-1} agrees to eps · cond(P) of its largest
entry, the rounding bound of the solve.
"""

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu.models.tensorci2 import filltensor
from tci_tpu.parallel.batcheval import VectorizedBatchEvaluator as JaxVBE
from tci_tpu_torch.parallel.batcheval import (
    TorchBatchEvaluator,
    VectorizedBatchEvaluator,
)

torch.set_num_threads(1)

ERR_ATOL = 1e-15

# Config 1 (BASELINE.md, README quickstart) through tci_tpu's host tier on a
# CPU, full precision, reproduced by
#   tci.crossinterpolate2(np.float64, VectorizedBatchEvaluator(fvec, [10]*8),
#                         [10]*8, tolerance=1e-8,
#                         rng=np.random.default_rng(0))
# with fvec(idx) = 1/(1+sum((idx+1)**2, axis=1)) and JAX on the CPU.
CONFIG1_RANKS = [12, 12, 12]
CONFIG1_ERRORS = [8.648364589823703e-09, 4.396554474387151e-09,
                  4.396554474387151e-09]
CONFIG1_LINKDIMS = [10, 12, 12, 12, 12, 12, 10]


def lorentzian_np(idx):
    v = np.asarray(idx, dtype=float) + 1.0
    return 1.0 / (1.0 + np.sum(v * v, axis=1))


def lorentzian_torch(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(dim=1))


def verify_f(x):
    return 1 / (1 + ((np.array(x) - 2.0) ** 2).sum())


def _drive(name, pkg):
    if name == "verify":
        return verify_f, [6] * 5
    vbe = JaxVBE if pkg is tci_tpu else VectorizedBatchEvaluator
    return vbe(lorentzian_np, [10] * 4), [10] * 4


def _points(dims, n=40, seed=1):
    rng = np.random.default_rng(seed)
    return [tuple(int(rng.integers(0, d)) for d in dims) for _ in range(n)]


@pytest.mark.parametrize("name", ["verify", "lorentzian4"])
def test_crossinterpolate2_matches_tci_tpu(name):
    f_ref, dims = _drive(name, tci_tpu)
    f_port, _ = _drive(name, tci_tpu_torch)
    ref, rranks, rerrs = tci_tpu.crossinterpolate2(
        np.float64, f_ref, dims, tolerance=1e-8, rng=np.random.default_rng(0))
    out, oranks, oerrs = tci_tpu_torch.crossinterpolate2(
        np.float64, f_port, dims, tolerance=1e-8, rng=np.random.default_rng(0),
        device="cpu")
    assert oranks == rranks
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    np.testing.assert_allclose(oerrs, rerrs, rtol=0, atol=ERR_ATOL)
    for p in _points(dims):
        assert out(p) == pytest.approx(float(ref(p)), abs=1e-12)
    assert out.sum() == pytest.approx(float(ref.sum()), abs=1e-10)


def test_state_carried_across():
    """A converged tci_tpu state handed to the port: one 2-site sweep on
    both gives the same pivot sets and site tensors, and the port's
    TensorTrain built from tci_tpu's site tensors evaluates like tci_tpu's."""
    dims = [10] * 4
    ref, _, _ = tci_tpu.crossinterpolate2(
        np.float64, JaxVBE(lorentzian_np, dims), dims, tolerance=1e-8,
        rng=np.random.default_rng(0))

    tt_ref = tci_tpu.TensorTrain(ref.sitetensors())
    tt_port = tci_tpu_torch.TensorTrain(ref.sitetensors(), device="cpu")
    pts = np.asarray(_points(dims, n=64, seed=5))
    np.testing.assert_allclose(tt_port.evaluate_batch(pts).numpy(),
                               tt_ref.evaluate_batch(pts), rtol=0, atol=1e-14)
    assert tt_port.linkdims() == tt_ref.linkdims()

    a = tci_tpu.TensorCI2.from_ijsets(JaxVBE(lorentzian_np, dims), dims,
                                      ref.Iset, ref.Jset)
    b = tci_tpu_torch.TensorCI2.from_ijsets(
        VectorizedBatchEvaluator(lorentzian_np, dims), dims, ref.Iset,
        ref.Jset, device="cpu")
    assert b.maxsamplevalue == a.maxsamplevalue
    abstol = 1e-8 * a.maxsamplevalue
    a.sweep2site(JaxVBE(lorentzian_np, dims), 1, abstol=abstol)
    b.sweep2site(VectorizedBatchEvaluator(lorentzian_np, dims), 1,
                 abstol=abstol)
    assert b.Iset == a.Iset and b.Jset == a.Jset
    for site, (tb, ta) in enumerate(zip(b.sitetensors(), a.sitetensors())):
        # T = Π1 · P^{-1}: the two solves (LAPACK builds of numpy and torch)
        # differ by up to eps · cond(P) relative; P's condition number is
        # ~4e8 at tolerance 1e-8. The last site holds raw samples.
        cond = 1.0
        if site < len(dims) - 1:
            P = filltensor(np.float64, JaxVBE(lorentzian_np, dims), dims,
                           a.Iset[site + 1], a.Jset[site], 0)
            cond = np.linalg.cond(P.reshape(len(a.Iset[site + 1]), -1))
        atol = np.finfo(np.float64).eps * cond * np.abs(ta).max()
        np.testing.assert_allclose(tb.numpy(), ta, rtol=0, atol=atol)
    np.testing.assert_allclose(b.bonderrors, a.bonderrors, rtol=0,
                               atol=ERR_ATOL * a.maxsamplevalue)


@pytest.mark.parametrize("evaluator", ["vectorized", "torch_cpu"])
def test_config1_recorded_series(evaluator):
    """Config 1 on the port alone, against tci_tpu's recorded series; the
    device evaluator (here on the CPU) takes the same trajectory."""
    dims = [10] * 8
    if evaluator == "vectorized":
        f = VectorizedBatchEvaluator(lorentzian_np, dims)
    else:
        f = TorchBatchEvaluator(lorentzian_torch, dims, device="cpu")
    tci, ranks, errors = tci_tpu_torch.crossinterpolate2(
        np.float64, f, dims, tolerance=1e-8, rng=np.random.default_rng(0),
        device="cpu")
    assert ranks == CONFIG1_RANKS
    np.testing.assert_allclose(errors, CONFIG1_ERRORS, rtol=0, atol=ERR_ATOL)
    assert tci.linkdims() == CONFIG1_LINKDIMS
    x = (1, 2, 3, 4, 5, 4, 3, 2)
    assert abs(tci(x) - lorentzian_np([x])[0]) < 1e-7
    if evaluator == "torch_cpu":
        assert f.nevals > 0
        assert all(t.device.type == "cpu" for t in tci.sitetensors())
