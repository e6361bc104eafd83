"""MPS/MPO interop (parity: ext/TCIITensorConversion/).

Counterpart of ``tci_tpu/interop/mps.py``. The reference converts
TensorTrain <-> ITensors.MPS/MPO (ttmpsconversion.jl:1-124) and evaluates an
MPS at index lists (mpsutil.jl:13-50). ITensors is a Julia package; the
Python ecosystem equivalent is quimb (optional: gated on availability). The
plain-array conversions below are the stable interchange format: a list of
(left, phys..., right) arrays, exactly the layout ITensors/quimb/TeNPy all
accept.

``to_*`` return tensors on the train's device (views of its cores where the
layout allows). ``from_*`` take numpy arrays or tensors and build a
``TensorTrain`` by its device rule: a numpy array goes to `device` (the
current CUDA device by default; without one it raises unless
``device="cpu"`` is given), a tensor stays where it lies.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..models.tensortrain import TensorTrain
from ..utils.device import resolve_device, to_device


def to_mps_tensors(tt: TensorTrain) -> List[torch.Tensor]:
    """Site tensors as (left, phys, right) tensors (MPS convention)."""
    return [t.reshape(t.shape[0], -1, t.shape[-1]) for t in tt.sitetensors()]


def from_mps_tensors(tensors: Sequence, device=None) -> TensorTrain:
    return TensorTrain(list(tensors), device=device)


def to_mpo_tensors(tt: TensorTrain) -> List[torch.Tensor]:
    """Site tensors as (left, up, down, right) tensors (MPO convention);
    requires a 4-leg tensor train."""
    for t in tt.sitetensors():
        if t.dim() != 4:
            raise ValueError("to_mpo_tensors requires a 4-leg tensor train.")
    return list(tt.sitetensors())


def from_mpo_tensors(tensors: Sequence, device=None) -> TensorTrain:
    tensors = list(tensors)
    for t in tensors:
        if t.ndim != 4:
            raise ValueError("from_mpo_tensors requires 4-leg tensors.")
    return TensorTrain(tensors, device=device)


def evaluate_mps(tensors: Sequence, indexset, device=None):
    """Evaluate an MPS given as raw (left, phys, right) arrays at one
    multi-index (parity: ext mpsutil.jl:13-50). The chain of products runs
    where the tensors lie (numpy arrays go to `device` first); one fetch
    returns the Python scalar."""
    v = None
    for t, i in zip(tensors, indexset):
        if not isinstance(t, torch.Tensor):
            t = to_device(np.asarray(t), resolve_device(device))
        mat = t[:, int(i), :]
        v = mat if v is None else v @ mat
    return v[0, 0].item()


def to_quimb_arrays(tt: TensorTrain) -> List[torch.Tensor]:
    """Site arrays in quimb's ``shape="lrp"`` MatrixProductState layout:
    first site (right, phys), middle sites (left, right, phys), last site
    (left, phys). This is the entire conversion; `to_quimb_mps` only hands
    the result to quimb's constructor. Inverse of `from_quimb_mps`."""
    arrays = []
    tensors = to_mps_tensors(tt)
    for i, t in enumerate(tensors):
        if i == 0:
            arrays.append(t[0, :, :].permute(1, 0))  # (right, phys)
        elif i == len(tensors) - 1:
            arrays.append(t[:, :, 0])  # (left, phys)
        else:
            arrays.append(t.permute(0, 2, 1))  # (left, right, phys)
    return arrays


def to_quimb_mps(tt: TensorTrain):
    """Convert to a quimb MatrixProductState (requires quimb installed)."""
    try:
        import quimb.tensor as qtn
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "quimb is not installed; use to_mps_tensors for raw arrays."
        ) from e
    return qtn.MatrixProductState(to_quimb_arrays(tt), shape="lrp")


def _as_tensor(a, device) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else to_device(
        np.asarray(a), resolve_device(device))


def from_quimb_mps(mps, device=None) -> TensorTrain:
    """Convert a quimb MatrixProductState back to a TensorTrain.

    Consumes any object exposing quimb's array layout (`arrays` in (l, r, p)
    order, or `arrays_l_r_p()`), so it does not itself require quimb."""
    if hasattr(mps, "arrays_l_r_p"):
        arrays = [_as_tensor(t.data, device) for t in mps.arrays_l_r_p()]
    elif hasattr(mps, "arrays"):
        arrays = [_as_tensor(a, device) for a in mps.arrays]
    else:
        raise TypeError(
            "from_quimb_mps expects a quimb MatrixProductState-like object "
            "with .arrays (l, r, p layout) or .arrays_l_r_p()."
        )
    out = []
    n = len(arrays)
    for i, a in enumerate(arrays):
        if i == 0:
            # (right, phys) -> (1, phys, right)
            out.append(a.permute(1, 0)[None, :, :])
        elif i == n - 1:
            # (left, phys) -> (left, phys, 1)
            out.append(a[:, :, None])
        else:
            # (left, right, phys) -> (left, phys, right)
            out.append(a.permute(0, 2, 1))
    return TensorTrain(out)
