"""Checkpoints of tci_tpu_torch against tci_tpu's, on the CPU: a file written
by either package loads in the other, and a TCI2 restored from one file
resumes to tci_tpu's ranks and errors.

Tolerances: every array of a file bitwise equal after a load and a save in
the other package, the meta JSON equal; resumed ranks series and index sets
identical, errors within 1e-15 absolute (the two packages round the Schur
update differently, ROADMAP C-port-1).
"""

import json

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu.parallel.batcheval import VectorizedBatchEvaluator as JaxVBE
from tci_tpu.utils import checkpoint as ckpt_ref
from tci_tpu_torch.utils import checkpoint as ckpt
from tci_tpu_torch.utils.device import FETCHES

torch.set_num_threads(1)

DIMS = [10] * 5
ERR_ATOL = 1e-15


def lorentzian_np(idx):
    v = np.asarray(idx, dtype=float) + 1.0
    return 1.0 / (1.0 + np.sum(v * v, axis=1))


def lorentzian_torch(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(dim=1))


def feynman_np(idx):
    v = np.asarray(idx, dtype=float) + 1.0
    return np.exp(1j * v.sum(1)) / (1.0 + np.sum(v * v, axis=1))


def _npz(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


def _assert_same_file(a, b):
    """Same keys, dtypes, shapes and bits; meta as equal JSON."""
    fa, fb = _npz(a), _npz(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert fa[k].shape == fb[k].shape, k
        if k == "meta":
            assert json.loads(str(fa[k])) == json.loads(str(fb[k]))
        else:
            assert fa[k].tobytes() == fb[k].tobytes(), k


@pytest.fixture(scope="module", params=["float64", "complex128"])
def ref_tci(request):
    """tci_tpu's TCI2 of a real and a complex f at tolerance 1e-4."""
    if request.param == "float64":
        f, dt = lorentzian_np, np.float64
    else:
        f, dt = feynman_np, np.complex128
    t, _, _ = tci_tpu.crossinterpolate2(dt, JaxVBE(f, DIMS, dtype=dt), DIMS,
                                        tolerance=1e-4,
                                        rng=np.random.default_rng(0))
    return t


def test_tci_tpu_file_loads_in_the_port(ref_tci, tmp_path):
    a, b = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ckpt_ref.save_tci2(a, ref_tci)
    out = ckpt.load_tci2(a, device="cpu")
    assert out.device == torch.device("cpu")
    assert out.localdims == ref_tci.localdims
    assert out.Iset == ref_tci.Iset and out.Jset == ref_tci.Jset
    assert out.maxsamplevalue == ref_tci.maxsamplevalue
    assert out._maxsample_dev is None
    assert out.dtype == torch.from_numpy(
        np.zeros(0, dtype=ref_tci.dtype)).dtype
    for t, r in zip(out.sitetensors(), ref_tci.sitetensors()):
        assert t.device.type == "cpu"
        assert np.array_equal(t.numpy(), np.asarray(r))
    ckpt.save_tci2(b, out)
    _assert_same_file(a, b)


def test_port_file_loads_in_tci_tpu(ref_tci, tmp_path):
    a, b, c = (str(tmp_path / n) for n in ("ref.npz", "port.npz", "back.npz"))
    ckpt_ref.save_tci2(a, ref_tci)
    ckpt.save_tci2(b, ckpt.load_tci2(a, device="cpu"))
    back = ckpt_ref.load_tci2(b)
    assert back.Iset == ref_tci.Iset and back.Jset == ref_tci.Jset
    ckpt_ref.save_tci2(c, back)
    _assert_same_file(b, c)


def test_save_reads_the_device_maximum_and_plain_ints(tmp_path):
    """save_tci2 writes the resolved max |sample| (the part still on the
    device included) and Iset/Jset entries that are numpy integers."""
    t = tci_tpu_torch.TensorCI2(DIMS, device="cpu")
    t.addglobalpivots([tuple(np.int64(i) for i in (0, 1, 2, 3, 4))])
    t.Iset[1] = [(np.int64(0),)]
    t.maxsamplevalue = 0.5
    t.updatemaxsample(torch.tensor([-2.0, 1.0], dtype=torch.float64))
    assert t._maxsample_dev is not None
    path = str(tmp_path / "t.npz")
    ckpt.save_tci2(path, t)
    data = _npz(path)
    assert data["maxsamplevalue"] == 2.0
    assert json.loads(str(data["meta"]))["Iset"][1] == [[0]]
    assert data["localdims"].dtype == np.int64
    assert str(data["dtype"]) == "float64"


def test_save_fetches_once_for_all_site_tensors(tmp_path, monkeypatch):
    """Site tensors on a device other than the host come back in one fetch
    (checked here through a stand-in device type)."""
    t, _, _ = tci_tpu_torch.crossinterpolate2(
        np.float64, tci_tpu_torch.VectorizedBatchEvaluator(lorentzian_np,
                                                           DIMS),
        DIMS, tolerance=1e-4, rng=np.random.default_rng(0), device="cpu")
    cores = [c.clone() for c in t.sitetensors()]
    FETCHES.clear()
    arrays = ckpt._host_tensors(cores)
    assert FETCHES["checkpoint"] == 0  # CPU tensors are read in place
    for a, c in zip(arrays, cores):
        assert np.array_equal(a, c.numpy())

    class Dev:
        type = "cuda"

    class Wrapped:
        def __init__(self, c):
            self.c, self.device, self.dtype = c, Dev, c.dtype
            self.shape = c.shape

        def numel(self):
            return self.c.numel()

        def detach(self):
            return self.c

    monkeypatch.setattr(ckpt, "fetch", lambda flat, tier: (
        FETCHES.update([tier]) or flat.numpy()))
    arrays = ckpt._host_tensors([Wrapped(c) for c in cores])
    assert FETCHES["checkpoint"] == 1
    for a, c in zip(arrays, cores):
        assert np.array_equal(a, c.numpy())


def test_tensortrain_files_cross_load(tmp_path):
    rng = np.random.default_rng(5)
    cores = [rng.standard_normal((b1, 3, b2)) + 1j * rng.standard_normal(
        (b1, 3, b2)) for b1, b2 in ((1, 2), (2, 4), (4, 1))]
    a, b, c = (str(tmp_path / n) for n in ("ref.npz", "port.npz", "back.npz"))
    ckpt_ref.save_tensortrain(a, tci_tpu.TensorTrain(cores))
    tt = ckpt.load_tensortrain(a, device="cpu")
    assert all(t.device.type == "cpu" for t in tt.sitetensors())
    for t, r in zip(tt.sitetensors(), cores):
        assert np.array_equal(t.numpy(), r)
    ckpt.save_tensortrain(b, tt)
    _assert_same_file(a, b)
    ckpt_ref.save_tensortrain(c, ckpt_ref.load_tensortrain(b))
    _assert_same_file(b, c)


def test_load_needs_a_device(tmp_path, monkeypatch):
    path = str(tmp_path / "t.npz")
    ckpt_ref.save_tensortrain(path, tci_tpu.TensorTrain([np.ones((1, 2, 1))]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ckpt.load_tensortrain(path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ckpt.load_tci2(path)


@pytest.fixture(scope="module")
def resumed_ref(tmp_path_factory):
    """One file of tci_tpu's coarse run (tolerance 1e-4) and tci_tpu's run
    resumed from it to 1e-8."""
    path = str(tmp_path_factory.mktemp("resume") / "coarse.npz")
    f = JaxVBE(lorentzian_np, DIMS)
    t, _, _ = tci_tpu.crossinterpolate2(np.float64, f, DIMS, tolerance=1e-4,
                                        rng=np.random.default_rng(0))
    ckpt_ref.save_tci2(path, t)
    ref = ckpt_ref.load_tci2(path)
    ranks, errors = ref.optimize(f, tolerance=1e-8,
                                 rng=np.random.default_rng(0))
    return path, ref, ranks, errors


@pytest.mark.parametrize("tier", ["host", "engine"])
def test_resume_matches_tci_tpu(resumed_ref, tier):
    path, ref, rranks, rerrors = resumed_ref
    f = (tci_tpu_torch.VectorizedBatchEvaluator(lorentzian_np, DIMS)
         if tier == "host" else tci_tpu_torch.TorchBatchEvaluator(
             lorentzian_torch, DIMS, device="cpu"))
    out = ckpt.load_tci2(path, device="cpu")
    ranks, errors = out.optimize(f, tolerance=1e-8,
                                 rng=np.random.default_rng(0))
    if tier == "engine":
        assert f._device_sweep_engine.rrlu_calls > 0
        assert f._fused_updater is None
    assert ranks == rranks
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    np.testing.assert_allclose(errors, rerrors, rtol=0, atol=ERR_ATOL)
