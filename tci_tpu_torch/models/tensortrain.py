"""Tensor-train (TT/MPS) container.

Counterpart of ``tci_tpu/models/tensortrain.py`` (parity reference:
src/abstracttensortrain.jl and src/tensortrain.jl). Site tensors are
(χ_{k-1}, d, χ_k) tensors and may live on a CUDA device; evaluation is a
chain of matrix products (abstracttensortrain.jl:328-342) and `sum` the
factorized O(n d r^2) reduction (:428-441). Batched evaluation goes through
the padded-core ``torch.bmm`` loop of ``models/tteval.py``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..utils.device import to_device
from .tteval import pad_cores, tt_evaluate_batched


class AbstractTensorTrain:
    """Base class: anything holding a list of site tensors and evaluable as a
    function of one index per site."""

    def sitetensors(self) -> List[torch.Tensor]:
        return self._sitetensors

    def sitetensor(self, i: int) -> torch.Tensor:
        return self.sitetensors()[i]

    def __len__(self) -> int:
        return len(self.sitetensors())

    def __iter__(self):
        return iter(self.sitetensors())

    def __getitem__(self, i):
        return self.sitetensors()[i]

    def linkdims(self) -> List[int]:
        return [t.shape[0] for t in self.sitetensors()[1:]]

    def linkdim(self, i: int) -> int:
        return self.sitetensor(i + 1).shape[0]

    def sitedims(self) -> List[List[int]]:
        return [list(t.shape[1:-1]) for t in self.sitetensors()]

    def rank(self) -> int:
        ld = self.linkdims()
        return max(ld) if ld else 1

    def evaluate(self, indexset):
        """Evaluate at one multi-index (one int per site); a Python scalar."""
        tensors = self.sitetensors()
        if len(indexset) != len(tensors):
            raise ValueError(
                f"To evaluate a tt of length {len(tensors)}, provide "
                f"{len(tensors)} indices, got {len(indexset)}."
            )
        v = None
        for T, i in zip(tensors, indexset):
            mat = T[:, int(i), :]
            v = mat if v is None else v @ mat
        return v[0, 0].item()

    def __call__(self, indexset):
        return self.evaluate(indexset)

    def evaluate_batch(self, indices) -> torch.Tensor:
        """Evaluate at a whole (B, L) batch of multi-indices; a (B,) tensor
        on the cores' device."""
        tensors = self.sitetensors()
        device = tensors[0].device
        if isinstance(indices, torch.Tensor):
            indices = indices.to(device, torch.int64)
        else:
            indices = to_device(np.asarray(indices, dtype=np.int64), device)
        if indices.dim() != 2 or indices.shape[1] != len(tensors):
            raise ValueError("indices must have shape (B, L).")
        return tt_evaluate_batched(pad_cores(tensors), indices)

    def sum(self):
        """Σ over all grid points via per-site reductions
        (abstracttensortrain.jl:428-441); a Python scalar."""
        tensors = self.sitetensors()
        t0 = tensors[0]
        v = t0.reshape(t0.shape[0], -1, t0.shape[-1]).sum(dim=(0, 1))[None, :]
        for T in tensors[1:]:
            v = v @ T.reshape(T.shape[0], -1, T.shape[-1]).sum(dim=1)
        return v[0, 0].item()

    def __repr__(self):
        return f"{type(self).__name__} with rank {self.rank()}"


class TensorTrain(AbstractTensorTrain):
    """Concrete TT with bond-consistency validation (tensortrain.jl:58-79).
    Accepts tensors or numpy arrays (kept as CPU tensors)."""

    def __init__(self, sitetensors: Sequence):
        if isinstance(sitetensors, AbstractTensorTrain):
            sitetensors = sitetensors.sitetensors()
        tensors = [torch.as_tensor(t) for t in sitetensors]
        for i in range(len(tensors) - 1):
            if tensors[i].shape[-1] != tensors[i + 1].shape[0]:
                raise ValueError(
                    f"The tensors at {i} and {i + 1} must have consistent "
                    "dimensions for a tensor train."
                )
        self._sitetensors = tensors

    @classmethod
    def from_tci(cls, tci) -> "TensorTrain":
        return cls(tci.sitetensors())


def tensortrain(tci) -> TensorTrain:
    """Convert any AbstractTensorTrain to a plain TensorTrain."""
    return TensorTrain(tci.sitetensors())
