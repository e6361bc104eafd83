"""Two-factor matrix splits used by TT compression.

Counterpart of ``tci_tpu/ops/factorize.py`` (parity reference:
src/tensortrain.jl:_factorize, :219-272). Methods: "LU" (the port's
``rrlu``, so a matrix on a CUDA device launches the rrLU kernel), "CI"
(``MatrixLUCI`` over the same elimination) and "SVD" (``torch.linalg.svd``
with the reference's rel/abs truncation rule). The factors stay on the
matrix's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.device import resolve_device, to_device
from ..utils.util import replacenothing
from .lu import rrlu
from .luci import MatrixLUCI

_INTMAX = 2**62


def svd_rank(S: np.ndarray, reltol: float, abstol: float,
             maxbonddim: int) -> int:
    """The number of singular values the reference keeps
    (tensortrain.jl:_factorize's SVD branch): the fewest whose dropped tail
    Σ s² is below abstol² and, relative to Σ s², below reltol², capped at
    maxbonddim."""
    # tail[n] = sum of squared singular values dropped when keeping n + 1
    tail = np.concatenate([np.cumsum((S**2)[::-1])[::-1][1:], [0.0]])
    total = float(np.sum(S**2))
    normalized = tail / total if total > 0 else tail
    first_abs = np.argmax(tail < abstol**2) if np.any(tail < abstol**2) else None
    first_rel = (np.argmax(normalized < reltol**2)
                 if np.any(normalized < reltol**2) else None)
    return int(min(replacenothing(first_abs, len(S) - 1) + 1,
                   replacenothing(first_rel, len(S) - 1) + 1,
                   maxbonddim))


def factorize(
    A,
    method: str,
    tolerance: float,
    maxbonddim: int = _INTMAX,
    leftorthogonal: bool = False,
    normalizeerror: bool = True,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Split A ≈ left · right, returning (left, right, rank).

    A numpy A is moved to `device` (the current CUDA device by default; a
    RuntimeError without one unless ``device="cpu"`` is given); a tensor
    stays where it lies. The SVD branch reads the singular values back to
    the host to pick the rank."""
    if not isinstance(A, torch.Tensor):
        A = to_device(np.asarray(A), resolve_device(device))
    reltol, abstol = 1e-14, 0.0
    if normalizeerror:
        reltol = tolerance
    else:
        abstol = tolerance

    if method == "LU":
        fact = rrlu(A, abstol=abstol, reltol=reltol, maxrank=maxbonddim,
                    leftorthogonal=leftorthogonal)
        return fact.left(), fact.right(), fact.npivots()
    if method == "CI":
        fact = MatrixLUCI(A, abstol=abstol, reltol=reltol, maxrank=maxbonddim,
                          leftorthogonal=leftorthogonal)
        return fact.left(), fact.right(), fact.npivots()
    if method == "SVD":
        U, S, Vh = torch.linalg.svd(A, full_matrices=False)
        trunci = svd_rank(S.cpu().numpy(), reltol, abstol, maxbonddim)
        Sk = S[:trunci].to(A.dtype)
        if leftorthogonal:
            return U[:, :trunci], Sk[:, None] * Vh[:trunci, :], trunci
        return U[:, :trunci] * Sk[None, :], Vh[:trunci, :], trunci
    raise ValueError(f"Unknown factorization method {method}.")
