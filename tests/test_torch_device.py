"""Where tci_tpu_torch runs: its entry points take the current CUDA device
unless the caller asks for the CPU, and raise without one; a tensor handed
to rrlu stays where it is. On the CPU, with device="cpu", every kind of
integrand gives tci_tpu's TCI trajectory.

Tolerances: ranks series and pivot sets identical; errors to 1e-15
absolute, as in test_torch_tensorci2.py (the errors are normalized
magnitudes of near-noise pivots, and the two packages round the Schur
update differently, ROADMAP C-port-1).
"""

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu.parallel.batcheval import VectorizedBatchEvaluator as JaxVBE
from tci_tpu_torch.ops import lu_cuda, lu_kernel
from tci_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

DIMS = [10] * 4
ERR_ATOL = 1e-15


def lorentzian_np(idx):
    v = np.asarray(idx, dtype=float) + 1.0
    return 1.0 / (1.0 + np.sum(v * v, axis=1))


def lorentzian_torch(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(dim=1))


def lorentzian_scalar(x):
    return 1.0 / (1.0 + sum((i + 1.0) ** 2 for i in x))


@pytest.fixture
def no_card(monkeypatch):
    """A host without a CUDA device, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENTRY_POINTS = {
    "crossinterpolate2": lambda: tci_tpu_torch.crossinterpolate2(
        np.float64, lorentzian_scalar, DIMS, tolerance=1e-8),
    "TensorCI2": lambda: tci_tpu_torch.TensorCI2(DIMS),
    "TorchBatchEvaluator": lambda: tci_tpu_torch.TorchBatchEvaluator(
        lorentzian_torch, DIMS),
    "rrlu": lambda: tci_tpu_torch.rrlu(np.eye(4)),
    "MatrixLUCI": lambda: tci_tpu_torch.MatrixLUCI(np.eye(4)),
    "factorize": lambda: tci_tpu_torch.factorize(np.eye(4), "LU", 1e-12),
    "TensorTrain": lambda: tci_tpu_torch.TensorTrain(_cores()),
    "TTCache": lambda: tci_tpu_torch.TTCache(_cores()),
    "CachedFunction": lambda: tci_tpu_torch.CachedFunction(
        lorentzian_scalar, DIMS),
    "estimatetrueerror": lambda: tci_tpu_torch.estimatetrueerror(
        _cores(), lorentzian_scalar, nsearch=2),
}


def _cores():
    """The numpy cores of a rank-2 tensor train on DIMS."""
    rng = np.random.default_rng(3)
    bonds = [1, 2, 2, 2, 1]
    return [rng.standard_normal((bonds[i], d, bonds[i + 1]))
            for i, d in enumerate(DIMS)]


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_raises_without_a_card(no_card, name):
    plain = sum(lu_kernel.PLAIN_CALLS.values())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()
    assert sum(lu_kernel.PLAIN_CALLS.values()) == plain  # nothing ran


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device()


@pytest.fixture(scope="module")
def reference():
    return tci_tpu.crossinterpolate2(
        np.float64, JaxVBE(lorentzian_np, DIMS), DIMS, tolerance=1e-8,
        rng=np.random.default_rng(0))


@pytest.mark.parametrize("kind", ["plain", "vectorized", "torch"])
def test_cpu_run_matches_tci_tpu(reference, kind):
    f = {
        "plain": lambda: lorentzian_scalar,
        "vectorized": lambda: tci_tpu_torch.VectorizedBatchEvaluator(
            lorentzian_np, DIMS),
        "torch": lambda: tci_tpu_torch.TorchBatchEvaluator(
            lorentzian_torch, DIMS, device="cpu"),
    }[kind]()
    ref, rranks, rerrs = reference
    launches = lu_cuda.LAUNCHES["rrlu"]
    out, ranks, errs = tci_tpu_torch.crossinterpolate2(
        np.float64, f, DIMS, tolerance=1e-8, rng=np.random.default_rng(0),
        device="cpu")
    assert lu_cuda.LAUNCHES["rrlu"] == launches
    assert out.device == torch.device("cpu")
    assert ranks == rranks
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    np.testing.assert_allclose(errs, rerrs, rtol=0, atol=ERR_ATOL)
    assert all(t.device.type == "cpu" for t in out.sitetensors())


def test_tensortrain_from_numpy_needs_a_device(no_card):
    """numpy cores follow the device rule of rrlu (ROADMAP C-port-7): with
    no card a TensorTrain of numpy cores raises unless device="cpu" is
    given, instead of keeping CPU tensors that every later operation then
    runs on."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tci_tpu_torch.TensorTrain(_cores())
    tt = tci_tpu_torch.TensorTrain(_cores(), device="cpu")
    assert all(t.device.type == "cpu" for t in tt.sitetensors())
    # tensors stay where they are
    again = tci_tpu_torch.TensorTrain(tt.sitetensors())
    assert all(a is b for a, b in zip(again.sitetensors(), tt.sitetensors()))


@pytest.mark.parametrize("entry", ["rrlu", "MatrixLUCI"])
def test_cpu_tensor_stays_on_the_cpu(no_card, entry):
    """A tensor is the caller choosing its device: no device argument is
    needed, and the plain version runs where the tensor lies."""
    rng = np.random.default_rng(7)
    A = torch.from_numpy(rng.standard_normal((12, 4))
                         @ rng.standard_normal((4, 9)))
    plain = lu_kernel.PLAIN_CALLS["cpu"]
    out = getattr(tci_tpu_torch, entry)(A, reltol=1e-12)
    assert lu_kernel.PLAIN_CALLS["cpu"] == plain + 1
    assert out.npivots() == 4
    assert out.left().device.type == "cpu"
    np.testing.assert_allclose((out.left() @ out.right()).numpy(), A.numpy(),
                               rtol=0, atol=1e-12)
