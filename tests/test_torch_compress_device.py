"""The device compression of tci_tpu_torch (``compress_device``,
``TensorTrain.compress(torch_native=True)``) against tci_tpu's
``compress_device`` and the host ``compress("LU")`` of both packages, on the
same numpy trains: the cases of tests/test_compress_device.py. The port
runs on device="cpu", its rrLU the plain version; a complex train runs in
complex128, against tci_tpu's (re, im) pair program.

Tolerances: linkdims identical, fulltensor within 1e-12 relative of
tci_tpu's device and host results (the products around the splits round
apart in XLA and torch), and the original within the truncation's own
tolerance.
"""

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu.models.compress_device import compress_device as compress_ref
from tci_tpu_torch import compress_device
from tci_tpu_torch.models import contraction_device as pcd
from tci_tpu_torch.utils.device import FETCHES

torch.set_num_threads(1)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _lowrank(seed, L, chi, d, r, complex_=False):
    """Random TT of true bond rank r embedded in chi-sized bonds."""
    rng = np.random.default_rng(seed)
    bonds = [1] + [chi] * (L - 1) + [1]
    ts = []
    for n in range(L):
        u = rng.standard_normal((bonds[n], d, r))
        v = rng.standard_normal((r, bonds[n + 1]))
        if complex_:
            u = u + 1j * rng.standard_normal(u.shape)
            v = v + 1j * rng.standard_normal(v.shape)
        ts.append((u @ v) / np.sqrt(r))
    return ts


def _mpo_cores(seed):
    """4-leg (MPO) cores of rank 2 in bonds of 5: their middle legs are
    flattened generically."""
    rng = np.random.default_rng(seed)
    bonds = [1, 5, 5, 1]
    return [rng.standard_normal((bonds[n], 2, 3, 2))
            @ rng.standard_normal((2, bonds[n + 1])) for n in range(3)]


CASES = {
    # (cores, compress options, tolerance against the original)
    "matches_host": (lambda: _lowrank(1, 6, 8, 3, 2),
                     dict(tolerance=1e-10), 1e-8),
    "maxbonddim": (lambda: _lowrank(2, 5, 8, 3, 6),
                   dict(tolerance=0.0, maxbonddim=3), None),
    "abstol_rule": (lambda: _lowrank(3, 5, 6, 3, 2),
                    dict(tolerance=1e-8, normalizeerror=False), 1e-7),
    "complex": (lambda: _lowrank(4, 5, 6, 3, 2, complex_=True),
                dict(tolerance=1e-10), 1e-8),
    "mpo_cores": (lambda: _mpo_cores(5), dict(tolerance=1e-10), 1e-8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_device_matches(case):
    make, opts, tol0 = CASES[case]
    cores = make()
    ref = compress_ref(tci_tpu.TensorTrain([c.copy() for c in cores]), "LU",
                       **opts)
    host_ref = tci_tpu.TensorTrain([c.copy() for c in cores])
    host_ref.compress("LU", **opts)
    tt = tci_tpu_torch.TensorTrain(cores, device="cpu")
    fetches = FETCHES["compress"]
    out = compress_device(tt, "LU", **opts)
    assert FETCHES["compress"] == fetches + 1
    assert out.linkdims() == ref.linkdims() == host_ref.linkdims()
    assert [t.dim() for t in out] == [c.ndim for c in cores]
    assert out[0].dtype == tt[0].dtype
    full = tci_tpu_torch.fulltensor(out)
    assert _rel(full, tci_tpu.fulltensor(ref)) < 1e-12
    assert _rel(full, tci_tpu.fulltensor(host_ref)) < 1e-12
    # the input is left as it was
    assert all(np.array_equal(t.numpy(), c) for t, c in zip(tt, cores))
    if tol0 is not None:
        assert _rel(full, tci_tpu_torch.fulltensor(tt)) < tol0
    if case == "matches_host":
        assert max(out.linkdims()) <= 2 * 3  # genuinely truncated from 8
    if case == "maxbonddim":
        assert max(out.linkdims()) == 3


def test_compress_torch_native_kwarg():
    """TensorTrain.compress(torch_native=True) compresses in place through
    compress_device, as compress(jax_native=True) does in tci_tpu, and
    gives what the host compress("LU") gives."""
    cores = _lowrank(6, 4, 6, 3, 2)
    a = tci_tpu_torch.TensorTrain(cores, device="cpu")
    a.compress("LU", tolerance=1e-10)
    b = tci_tpu_torch.TensorTrain(cores, device="cpu")
    b.compress("LU", tolerance=1e-10, torch_native=True)
    ref = tci_tpu.TensorTrain([c.copy() for c in cores])
    ref.compress("LU", tolerance=1e-10, jax_native=True)
    assert a.linkdims() == b.linkdims() == ref.linkdims()
    fb = tci_tpu_torch.fulltensor(b)
    assert _rel(fb, tci_tpu_torch.fulltensor(a).numpy()) < 1e-12
    assert _rel(fb, tci_tpu.fulltensor(ref)) < 1e-12


def test_compress_device_rejects(monkeypatch):
    """SVD and CI stay with the host compression. A mesh is taken: every
    split goes to the mesh's split (``make_lu_split_sharded``, here a stand
    -in that runs the one-device split; the real one is held against this
    tier bitwise in tests/test_torch_contraction_mesh.py)."""
    tt = tci_tpu_torch.TensorTrain(_lowrank(7, 3, 4, 2, 2), device="cpu")
    for method in ("SVD", "CI"):
        with pytest.raises(ValueError, match="method='LU'"):
            compress_device(tt, method, tolerance=1e-10)
    mesh, calls = object(), []

    def split_on(m, *shape):
        calls.append(m)
        cap, lo = shape[2], shape[3]
        return lambda Cm, mt, nt, rt, at: pcd._lu_split(
            Cm, mt, nt, rt, at, cap=cap, leftorthogonal=lo)

    monkeypatch.setattr(pcd, "make_lu_split_sharded", split_on)
    out = compress_device(tt, "LU", tolerance=1e-10, mesh=mesh)
    ref = compress_device(tt, "LU", tolerance=1e-10)
    assert calls == [mesh] * 2 * (len(tt) - 1)
    assert out.linkdims() == ref.linkdims()
    assert all(torch.equal(a, b)
               for a, b in zip(out.sitetensors(), ref.sitetensors()))


def test_compress_device_single_site():
    """L = 1: owned copies, nothing split or fetched."""
    rng = np.random.default_rng(8)
    tt = tci_tpu_torch.TensorTrain([rng.standard_normal((1, 4, 1))],
                                   device="cpu")
    fetches = FETCHES["compress"]
    dev = compress_device(tt, "LU", tolerance=1e-10)
    assert FETCHES["compress"] == fetches
    assert torch.equal(dev[0], tt[0])
    assert dev[0].data_ptr() != tt[0].data_ptr()


def test_compress_device_float32_train():
    """A float32 train is split in float64 and comes back in float32, as
    tci_tpu's compress_device casts it."""
    cores = [c.astype(np.float32) for c in _lowrank(9, 4, 5, 3, 2)]
    ref = compress_ref(tci_tpu.TensorTrain([c.copy() for c in cores]), "LU",
                       tolerance=1e-6)
    out = compress_device(tci_tpu_torch.TensorTrain(cores, device="cpu"),
                          "LU", tolerance=1e-6)
    assert out.linkdims() == ref.linkdims()
    assert all(t.dtype == torch.float32 for t in out)
    assert _rel(tci_tpu_torch.fulltensor(out).double(),
                np.asarray(tci_tpu.fulltensor(ref), np.float64)) < 1e-6
