"""MPS/MPO interop of tci_tpu_torch against tci_tpu's, on the CPU: every
function of ``interop.mps`` on the same numpy cores in both packages, the
quimb stand-ins (``.arrays`` and ``.arrays_l_r_p()``), the rank errors and
the ImportError without quimb.

Tolerances: layouts and arrays bitwise equal (the conversions only move
data); ``evaluate_mps`` within 1e-14 relative of tci_tpu's (a chain of
products that the two packages round apart).
"""

import itertools
import sys
import types

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu.interop import mps as ref
from tci_tpu_torch import interop
from tci_tpu_torch.interop import mps

torch.set_num_threads(1)

try:
    import quimb.tensor  # noqa: F401

    _HAS_QUIMB = True
except ImportError:
    _HAS_QUIMB = False


def _cores(complex_=False, legs=(2,), bonds=(1, 3, 4, 3, 1), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for b1, b2 in zip(bonds[:-1], bonds[1:]):
        t = rng.standard_normal((b1, *legs, b2))
        if complex_:
            t = t + 1j * rng.standard_normal(t.shape)
        out.append(t)
    return out


def _pair(cores):
    return (tci_tpu.TensorTrain(cores),
            tci_tpu_torch.TensorTrain(cores, device="cpu"))


def _same(port_arrays, ref_arrays):
    assert len(port_arrays) == len(ref_arrays)
    for p, r in zip(port_arrays, ref_arrays):
        assert isinstance(p, torch.Tensor)
        assert p.device.type == "cpu"
        assert tuple(p.shape) == np.shape(r)
        assert np.array_equal(p.numpy(), np.asarray(r))


def test_all_matches_tci_tpu():
    import tci_tpu.interop

    assert interop.__all__ == tci_tpu.interop.__all__
    for name in interop.__all__:
        assert callable(getattr(interop, name))


@pytest.mark.parametrize("complex_", [False, True])
def test_mps_roundtrip(complex_):
    cores = _cores(complex_)
    tr, tp = _pair(cores)
    arrays = mps.to_mps_tensors(tp)
    _same(arrays, ref.to_mps_tensors(tr))
    for a, c in zip(arrays, tp.sitetensors()):
        assert a.data_ptr() == c.data_ptr()  # views, nothing copied
    back = mps.from_mps_tensors(arrays)
    _same(back.sitetensors(), cores)
    # numpy arrays go to the device given
    back_np = mps.from_mps_tensors(ref.to_mps_tensors(tr), device="cpu")
    _same(back_np.sitetensors(), cores)
    for i in itertools.product(range(2), repeat=4):
        want = ref.evaluate_mps(ref.to_mps_tensors(tr), i)
        for got in (mps.evaluate_mps(arrays, i),
                    mps.evaluate_mps(ref.to_mps_tensors(tr), i,
                                     device="cpu")):
            assert isinstance(got, complex if complex_ else float)
            assert abs(got - want) <= 1e-14 * max(1.0, abs(want))
        assert abs(back.evaluate(i) - tr.evaluate(i)) <= 1e-14 * max(
            1.0, abs(tr.evaluate(i)))


def test_multileg_sites_flatten_as_tci_tpu():
    cores = _cores(legs=(2, 3), bonds=(1, 2, 1))
    tr, tp = _pair(cores)
    _same(mps.to_mps_tensors(tp), ref.to_mps_tensors(tr))


@pytest.mark.parametrize("complex_", [False, True])
def test_mpo_roundtrip(complex_):
    cores = _cores(complex_, legs=(2, 3), bonds=(1, 2, 3, 1))
    tr, tp = _pair(cores)
    arrays = mps.to_mpo_tensors(tp)
    _same(arrays, ref.to_mpo_tensors(tr))
    _same(mps.from_mpo_tensors(arrays).sitetensors(), cores)
    _same(mps.from_mpo_tensors(cores, device="cpu").sitetensors(),
          ref.from_mpo_tensors(cores).sitetensors())


def test_mpo_rank_errors():
    tr, tp = _pair(_cores())
    for module, tt in ((ref, tr), (mps, tp)):
        with pytest.raises(ValueError, match="4-leg tensor train"):
            module.to_mpo_tensors(tt)
    three = _cores()
    with pytest.raises(ValueError, match="4-leg tensors"):
        ref.from_mpo_tensors(three)
    with pytest.raises(ValueError, match="4-leg tensors"):
        mps.from_mpo_tensors(three, device="cpu")
    with pytest.raises(ValueError, match="4-leg tensors"):
        mps.from_mpo_tensors([torch.from_numpy(t) for t in three])


class _Arrays:
    """Stand-in for quimb's MatrixProductState: ``.arrays`` in (l, r, p)
    order, first site (r, p), last (l, p)."""

    def __init__(self, arrays):
        self.arrays = arrays


class _LRP:
    """Stand-in exposing only ``arrays_l_r_p()``: tensors with ``.data``."""

    def __init__(self, arrays):
        self._arrays = arrays

    def arrays_l_r_p(self):
        return [types.SimpleNamespace(data=a) for a in self._arrays]


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("standin", [_Arrays, _LRP])
def test_quimb_layout_roundtrip(complex_, standin):
    cores = _cores(complex_)
    tr, tp = _pair(cores)
    arrays = mps.to_quimb_arrays(tp)
    ref_arrays = ref.to_quimb_arrays(tr)
    _same(arrays, ref_arrays)
    assert [tuple(a.shape) for a in arrays] == [(3, 2), (3, 4, 2), (4, 3, 2),
                                                (3, 2)]
    back = mps.from_quimb_mps(standin(arrays))
    ref_back = ref.from_quimb_mps(standin(ref_arrays))
    _same(back.sitetensors(), cores)
    _same(back.sitetensors(), ref_back.sitetensors())
    # numpy arrays go to the device given
    back_np = mps.from_quimb_mps(standin(ref_arrays), device="cpu")
    _same(back_np.sitetensors(), cores)


def test_quimb_errors():
    if _HAS_QUIMB:
        pytest.skip("quimb is installed: the error path does not run")
    tp = tci_tpu_torch.TensorTrain([np.ones((1, 2, 1))] * 2, device="cpu")
    tr = tci_tpu.TensorTrain([np.ones((1, 2, 1))] * 2)
    with pytest.raises(ImportError) as got:
        mps.to_quimb_mps(tp)
    with pytest.raises(ImportError) as want:
        ref.to_quimb_mps(tr)
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError) as got:
        mps.from_quimb_mps(object())
    with pytest.raises(TypeError) as want:
        ref.from_quimb_mps(object())
    assert str(got.value) == str(want.value)


def test_to_quimb_mps_through_a_module_standin(monkeypatch):
    """The real ``to_quimb_mps`` body (import and constructor call) with a
    stand-in ``quimb.tensor`` that checks the ``shape="lrp"`` contract."""
    made = []

    class MPS:
        def __init__(self, arrays, shape="lrp"):
            assert shape == "lrp"
            arrays = list(arrays)
            assert arrays[0].ndim == arrays[-1].ndim == 2
            assert all(a.ndim == 3 for a in arrays[1:-1])
            self.arrays = arrays
            made.append(self)

    qt = types.ModuleType("quimb.tensor")
    qt.MatrixProductState = MPS
    q = types.ModuleType("quimb")
    q.tensor = qt
    monkeypatch.setitem(sys.modules, "quimb", q)
    monkeypatch.setitem(sys.modules, "quimb.tensor", qt)
    cores = _cores()
    _, tp = _pair(cores)
    back = mps.from_quimb_mps(mps.to_quimb_mps(tp))
    assert len(made) == 1
    _same(back.sitetensors(), cores)


def test_from_numpy_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cores = _cores()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mps.from_mps_tensors(cores)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mps.evaluate_mps(cores, (0, 0, 0, 0))
    # tensors stay where they lie
    tt = mps.from_mps_tensors([torch.from_numpy(c) for c in cores])
    assert all(t.device.type == "cpu" for t in tt.sitetensors())
