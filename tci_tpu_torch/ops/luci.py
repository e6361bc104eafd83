"""rrLU exposed through the cross-interpolation (CI) interface.

Counterpart of ``tci_tpu/ops/luci.py`` (parity reference: src/matrixluci.jl).
left/right produce the CI factors used as TT site tensors; the pivot-inverse
products are triangular solves on the factors' device
(matrixluci.jl:194-241), never explicit inverses.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .lu import rrLU, rrlu, rrlu_from_function


class MatrixLUCI:
    """CI view of an rrLU: of a given factorization `lu`, of a matrix A
    (keyword arguments go to ``rrlu``), or of a function f with
    ``valuetype`` and ``matrixsize`` (``rrlu_from_function``: the full
    matrix, or rook pivoting with ``pivotsearch="rook"`` from the pivot
    continuations I0 and J0). A numpy A or a sampled function is factorized
    on `device` (the current CUDA device by default; without one this
    raises unless ``device="cpu"`` is given), a tensor A where it lies."""

    def __init__(self, A=None, *, lu: Optional[rrLU] = None, f=None,
                 valuetype=None, matrixsize: Optional[Tuple[int, int]] = None,
                 I0: Sequence[int] = (), J0: Sequence[int] = (),
                 pivotsearch: str = "full", usebatcheval: bool = False,
                 rng=None, device=None, **kwargs):
        if lu is not None:
            self.lu = lu
        elif A is not None:
            self.lu = rrlu(A, device=device, **kwargs)
        else:
            assert f is not None and matrixsize is not None
            self.lu = rrlu_from_function(
                valuetype, f, matrixsize, I0, J0, pivotsearch=pivotsearch,
                usebatcheval=usebatcheval, rng=rng, device=device, **kwargs)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.lu.shape

    def size(self, dim: Optional[int] = None):
        return self.lu.size(dim)

    def npivots(self) -> int:
        return self.lu.npivots()

    def rowindices(self) -> np.ndarray:
        return self.lu.rowindices()

    def colindices(self) -> np.ndarray:
        return self.lu.colindices()

    def colmatrix(self) -> torch.Tensor:
        """Pivot columns A[:, J] (matrixluci.jl:161-165)."""
        n = self.npivots()
        return self.lu.left() @ self.lu.right(permute=False)[:, :n]

    def rowmatrix(self) -> torch.Tensor:
        """Pivot rows A[I, :] (matrixluci.jl:175-177)."""
        n = self.npivots()
        return self.lu.left(permute=False)[:n, :] @ self.lu.right()

    def colstimespivotinv(self) -> torch.Tensor:
        """C · P^{-1}: the left CI factor, with identity rows at the pivots
        (matrixluci.jl:194-213)."""
        n = self.npivots()
        m = self.size(0)
        L = self.lu.left(permute=False)
        result = torch.zeros((m, n), dtype=L.dtype, device=L.device)
        result.diagonal().fill_(1.0)
        if n < m:
            # X · L[:n] = L[n:] with L[:n] lower triangular
            result[n:, :] = torch.linalg.solve_triangular(
                L[:n, :], L[n:, :], upper=False, left=False
            )
        out = torch.empty_like(result)
        out[self.lu._rowperm_dev, :] = result
        return out

    def pivotinvtimesrows(self) -> torch.Tensor:
        """P^{-1} · R: the right CI factor (matrixluci.jl:227-241)."""
        n = self.npivots()
        ncol = self.size(1)
        U = self.lu.right(permute=False)
        result = torch.zeros((n, ncol), dtype=U.dtype, device=U.device)
        result.diagonal().fill_(1.0)
        if n < ncol:
            result[:, n:] = torch.linalg.solve_triangular(
                U[:, :n], U[:, n:], upper=True
            )
        out = torch.empty_like(result)
        out[:, self.lu._colperm_dev] = result
        return out

    def left(self) -> torch.Tensor:
        if self.lu.leftorthogonal:
            return self.colstimespivotinv()
        return self.colmatrix()

    def right(self) -> torch.Tensor:
        if self.lu.leftorthogonal:
            return self.rowmatrix()
        return self.pivotinvtimesrows()

    def pivoterrors(self) -> np.ndarray:
        return self.lu.pivoterrors()

    def lastpivoterror(self) -> float:
        return self.lu.lastpivoterror()
