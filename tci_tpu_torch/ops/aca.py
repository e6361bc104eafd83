"""Adaptive cross approximation A ≈ Σ_k α_k u_k v_k^T (Kumar 2016).

Counterpart of ``tci_tpu/ops/aca.py`` (parity reference: src/matrixaca.jl):
the incremental u_k/v_k updates (:196-213, :249-265), the automatic pivot
choice from the last u/v (:323-335) and the permutation-aware
setcols/setrows updates (:426-487) that TCI1 uses. u (m × k), v (k × n)
and α (k) are tensors on one device. Each update is a fixed number of
tensor operations: the residual column and row are one matrix-vector
product each, and setcols/setrows one unit-triangular solve each, where
``tci_tpu`` loops over the pivots. The zero-pivot guards read the pivot
value back to the host (``FETCHES["tci1"]``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device, torch_dtype
from .ci import _select, argmax_colmajor, as_matrix, host_value, index_tensor


class MatrixACA:
    def __init__(
        self,
        *,
        A=None,
        firstpivot: Optional[Tuple[int, int]] = None,
        nrows: Optional[int] = None,
        ncols: Optional[int] = None,
        dtype=np.float64,
        device=None,
    ):
        if A is not None and firstpivot is not None:
            A = as_matrix(A, device)
            i, j = int(firstpivot[0]), int(firstpivot[1])
            if host_value(A[i, j]) == 0:
                raise ValueError(
                    "First ACA pivot value is exactly zero and cannot be "
                    "inverted (zero-pivot guard, cf. tensorci1.jl:182-184)."
                )
            self.rowindices = [i]
            self.colindices = [j]
            self.u = A[:, j:j + 1].clone()
            self.v = A[i:i + 1, :].clone()
            self.alpha = 1 / A[i, j].reshape(1)
        else:
            assert nrows is not None and ncols is not None
            dev = resolve_device(device)
            dt = torch_dtype(dtype)
            self.rowindices = []
            self.colindices = []
            self.u = torch.zeros((nrows, 0), dtype=dt, device=dev)
            self.v = torch.zeros((0, ncols), dtype=dt, device=dev)
            self.alpha = torch.zeros(0, dtype=dt, device=dev)

    @property
    def device(self) -> torch.device:
        return self.u.device

    def nrows(self) -> int:
        return self.u.shape[0]

    def ncols(self) -> int:
        return self.v.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows(), self.ncols())

    def npivots(self) -> int:
        return self.u.shape[1]

    def rank(self) -> int:
        return len(self.rowindices)

    def isempty(self) -> bool:
        return not self.colindices

    def availablerows(self):
        return np.setdiff1d(np.arange(self.nrows()),
                            np.asarray(self.rowindices, dtype=np.int64)
                            ).tolist()

    def availablecols(self):
        return np.setdiff1d(np.arange(self.ncols()),
                            np.asarray(self.colindices, dtype=np.int64)
                            ).tolist()

    def _pivots(self, n: int) -> torch.Tensor:
        """u[x_l, l] for l < n: the pivots of the first n committed
        columns."""
        rows = index_tensor(self.rowindices[:n], self.device)
        return self.u[:, :n].gather(0, rows[None, :])[0]

    # -- incremental updates (matrixaca.jl:196-283) ------------------------

    def residualcol(self, A, yk: int) -> torch.Tensor:
        """u_k(x) = A(x, y_k) - Σ_{l<k} [v_l(y_k)/u_l(x_l)] u_l(x), computed
        WITHOUT mutating the factorization — callers use it to vet a
        candidate pivot value before committing (an exactly-zero pivot is
        uninvertible; the reference guards zero pivots,
        tensorci1.jl:182-184)."""
        A = as_matrix(A, self.device)
        col = A[:, int(yk)].to(self.u.dtype)
        # over committed COLUMNS (u.shape[1], not len(rowindices)): the
        # global-pivot path adds the row before the column, so the two
        # counts differ by one there
        n = self.u.shape[1]
        if n == 0:
            return col.clone()
        return col - self.u @ (self.v[:n, int(yk)] / self._pivots(n))

    def _uk(self, A) -> torch.Tensor:
        return self.residualcol(A, self.colindices[-1])

    def _vk(self, A) -> torch.Tensor:
        """v_k(y) = A(x_k, y) - Σ_{l<k} [u_l(x_k)/u_l(x_l)] v_l(y)."""
        A = as_matrix(A, self.device)
        n = len(self.rowindices) - 1
        xk = self.rowindices[-1]
        row = A[xk, :].to(self.v.dtype)
        if n == 0:
            return row.clone()
        return row - (self.u[xk, :n] / self._pivots(n)) @ self.v[:n, :]

    def addpivotcol(self, A, yk: int) -> None:
        self.colindices.append(int(yk))
        self.u = torch.cat([self.u, self._uk(A)[:, None]], dim=1)

    def addpivotrow(self, A, xk: int) -> None:
        pivot = self.u[int(xk), -1]
        if host_value(pivot) == 0:
            raise ZeroDivisionError(
                f"ACA pivot value at row {xk} is exactly zero (residual "
                "column cancelled to working precision); refusing to invert "
                "it. Vet candidates with residualcol() before committing "
                "(zero-pivot guard, cf. tensorci1.jl:182-184)."
            )
        self.rowindices.append(int(xk))
        self.v = torch.cat([self.v, self._vk(A)[None, :]])
        self.alpha = torch.cat([self.alpha, 1 / pivot.reshape(1)])

    def addpivot(self, A, pivotindices=None) -> None:
        """Add a pivot; when unspecified, pick greedily from the last u/v
        vectors (matrixaca.jl:323-335): one fetch for each argmax."""
        A = as_matrix(A, self.device)
        if pivotindices is not None:
            self.addpivotcol(A, pivotindices[1])
            self.addpivotrow(A, pivotindices[0])
            return
        availcols = self.availablecols()
        c, _, _ = argmax_colmajor(
            _select(self.v[-1], 0, availcols).abs()[:, None])
        self.addpivotcol(A, availcols[c])
        availrows = self.availablerows()
        r, _, _ = argmax_colmajor(
            _select(self.u[:, -1], 0, availrows).abs()[:, None])
        self.addpivotrow(A, availrows[r])

    # -- evaluation --------------------------------------------------------

    def submatrix(self, rows=None, cols=None) -> torch.Tensor:
        if self.isempty():
            nr = self.nrows() if rows is None else len(rows)
            nc = self.ncols() if cols is None else len(cols)
            return self.u.new_zeros((nr, nc))
        r = self.rank()
        return _select(self.u[:, :r], 0, rows) @ (
            self.alpha[:r, None] * _select(self.v[:r], 1, cols))

    def matrix(self) -> torch.Tensor:
        return self.submatrix()

    def evaluate(self, i=None, j=None):
        if i is None:
            return self.submatrix()
        return torch.sum(self.u[i, :] * self.alpha * self.v[:, j]).item()

    def __getitem__(self, key):
        rows, cols = key
        if isinstance(rows, slice):
            rows = list(range(self.nrows()))[rows]
        if isinstance(cols, slice):
            cols = list(range(self.ncols()))[cols]
        if isinstance(rows, (int, np.integer)) and isinstance(
                cols, (int, np.integer)):
            return self.evaluate(rows, cols)
        if isinstance(rows, (int, np.integer)):
            return self.submatrix([rows], cols)[0, :]
        if isinstance(cols, (int, np.integer)):
            return self.submatrix(rows, [cols])[:, 0]
        return self.submatrix(rows, cols)

    def localerror(self, a, rows=None, cols=None) -> torch.Tensor:
        a = as_matrix(a, self.device)
        approx = self.submatrix(rows, cols)
        return (_select(_select(a, 0, rows), 1, cols) - approx).abs()

    def findnewpivot(self, a, rowindices=None, colindices=None):
        """Greedy argmax of |a - approx| over the available rows/cols, in
        tci_tpu's column-major first-occurrence order; one fetch."""
        a = as_matrix(a, self.device)
        if rowindices is None:
            rowindices = self.availablerows()
        if colindices is None:
            colindices = self.availablecols()
        if self.rank() == min(a.shape):
            raise ValueError(
                "Cannot find a new pivot: already full rank."
            )
        if len(rowindices) == 0 or len(colindices) == 0:
            raise ValueError("Cannot find a new pivot in an empty row/col set")
        r, c, value = argmax_colmajor(
            self.localerror(a, rowindices, colindices))
        return (rowindices[r], colindices[c]), value

    # -- permutation-aware updates (matrixaca.jl:426-487) -------------------

    def setcols(self, newpivotrows, permutation) -> None:
        """Update v after the column set was permuted/extended; permutation[j]
        is the new position of old column j. The new columns solve
        (I + M) v[:, new] = newpivotrows[:, new] with M strictly lower
        triangular, M[k, l] = u[x_k, l] α_l."""
        newpivotrows = as_matrix(newpivotrows, self.device)
        permutation = np.asarray(permutation, dtype=np.int64)
        self.colindices = permutation[
            np.asarray(self.colindices, dtype=np.int64)].tolist()
        K, n = newpivotrows.shape
        v = torch.empty((K, n), dtype=self.v.dtype, device=self.device)
        v[:, index_tensor(permutation, self.device)] = self.v
        newindices = np.setdiff1d(np.arange(n), permutation)
        if newindices.size:
            new = index_tensor(newindices, self.device)
            rows = index_tensor(self.rowindices[:K], self.device)
            ncol = min(self.u.shape[1], K)
            M = self.u.new_zeros((K, K))
            M[:, :ncol] = self.u[rows, :ncol] * self.alpha[None, :ncol]
            v[:, new] = torch.linalg.solve_triangular(
                M, newpivotrows[:, new].to(v.dtype), upper=False,
                unitriangular=True)
        self.v = v

    def setrows(self, newpivotcols, permutation) -> None:
        """Update u after the row set was permuted/extended. The new rows
        solve u[new, :] (I + C) = newpivotcols[new, :] with C strictly upper
        triangular, C[l, k] = v[l, y_k] α_l."""
        newpivotcols = as_matrix(newpivotcols, self.device)
        permutation = np.asarray(permutation, dtype=np.int64)
        self.rowindices = permutation[
            np.asarray(self.rowindices, dtype=np.int64)].tolist()
        m, K = newpivotcols.shape
        u = torch.empty((m, K), dtype=self.u.dtype, device=self.device)
        u[index_tensor(permutation, self.device), :] = self.u
        newindices = np.setdiff1d(np.arange(m), permutation)
        if newindices.size:
            new = index_tensor(newindices, self.device)
            cols = index_tensor(self.colindices[:K], self.device)
            nrow = min(self.v.shape[0], K)
            C = self.v.new_zeros((K, K))
            C[:nrow, :] = self.v[:nrow][:, cols] * self.alpha[:nrow, None]
            u[new, :] = torch.linalg.solve_triangular(
                C, newpivotcols[new, :].to(u.dtype), upper=True, left=False,
                unitriangular=True)
        self.u = u
