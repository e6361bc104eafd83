"""Batched tensor-train evaluation on padded cores.

Counterpart of ``tci_tpu/models/jaxeval.py``: ragged (χl, d, χr) cores are
zero-padded into one (L, χ, d, χ) tensor, and a batch of multi-indices is
evaluated as a loop over sites of batched (B, 1, χ) x (B, χ, χ) products
(``torch.bmm``) after gathering each sample's core slice.
"""

from __future__ import annotations

from typing import Sequence

import torch


def chi_bucket(chi: int) -> int:
    """The padded bond dimension of the floating-zone search: max(8, the
    next power of two >= chi), so that one program serves trains of similar
    rank (``tci_tpu``'s engine pads the same way)."""
    return max(8, 1 << (chi - 1).bit_length())


def max_bond(sitetensors: Sequence[torch.Tensor]) -> int:
    return max(max(t.shape[0], t.shape[-1]) for t in sitetensors)


def pad_cores(sitetensors: Sequence[torch.Tensor], dtype=None,
              chi: int = 0) -> torch.Tensor:
    """Stack ragged (χl, d, χr) cores into one (L, χ, d, χ) tensor on the
    cores' device, zero-padded to the max bond/site dimension (or to `chi`
    when that is larger). Boundary bonds embed at index 0."""
    first = sitetensors[0]
    dtype = first.dtype if dtype is None else dtype
    L = len(sitetensors)
    chi = max(chi, max_bond(sitetensors))
    d = max(t.shape[1] for t in sitetensors)
    out = torch.zeros((L, chi, d, chi), dtype=dtype, device=first.device)
    for l, t in enumerate(sitetensors):
        out[l, : t.shape[0], : t.shape[1], : t.shape[2]] = t
    return out


def tt_evaluate_batched(cores: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Evaluate a padded TT at a batch of multi-indices.

    Args:
      cores: (L, chi, d, chi) padded site tensors (boundaries embedded at 0).
      indices: (B, L) integer tensor on the cores' device.
    Returns:
      (B,) values.
    """
    L, chi, d, _ = cores.shape
    B = indices.shape[0]
    v = torch.zeros((B, 1, chi), dtype=cores.dtype, device=cores.device)
    v[:, 0, 0] = 1.0
    for l in range(L):
        mats = cores[l].permute(1, 0, 2)[indices[:, l]]  # (B, chi, chi)
        v = torch.bmm(v, mats)
    return v[:, 0, 0]
