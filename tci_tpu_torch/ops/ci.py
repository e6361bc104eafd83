"""Matrix cross interpolation A ≈ A[:, J] · (A[I, J])^{-1} · A[I, :].

Counterpart of ``tci_tpu/ops/ci.py`` (parity reference:
src/abstractmatrixci.jl and src/matrixci.jl). The pivot columns and rows are
tensors on one device: a numpy matrix goes to `device` (the current CUDA
device by default; without one this raises unless ``device="cpu"`` is
given), a tensor stays where it lies. The QR-stabilized products
AtimesBinv/AinvtimesB (matrixci.jl:44-76) run on the operands' device. The
greedy pivot search reads one (position, value) pair back to the host a
call, counted in ``FETCHES["tci1"]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import fetch, resolve_device, to_device, torch_dtype

# the FETCHES key of the host reads of TCI1 and its matrix engines
TIER = "tci1"


def as_matrix(A, device=None) -> torch.Tensor:
    """A as a 2-D tensor: a tensor stays where it lies, a numpy array goes
    to ``resolve_device(device)``."""
    if isinstance(A, torch.Tensor):
        return A
    return to_device(np.atleast_2d(np.asarray(A)), resolve_device(device))


def index_tensor(indices, device: torch.device) -> torch.Tensor:
    """A host list of positions as an int64 tensor on `device`."""
    return to_device(np.asarray(indices, dtype=np.int64).reshape(-1), device)


def host_value(t: torch.Tensor):
    """One element of a device tensor on the host (one counted fetch)."""
    return fetch(t.reshape(1), TIER)[0]


def argmax_colmajor(metric: torch.Tensor) -> Tuple[int, int, float]:
    """First maximum of a 2-D metric in column-major order, as tci_tpu's
    ``submatrixargmax_colmajor`` takes it (a NaN ranks above every value,
    as in ``np.argmax``): (row, col, value), with one fetch of the position
    and the value."""
    flat = metric.T.reshape(-1)
    p = torch.argmax(flat)
    pair = torch.stack([p.to(torch.float64), flat[p].to(torch.float64)])
    p, value = fetch(pair, TIER)
    p = int(p)
    m = metric.shape[0]
    return p % m, p // m, float(value)


def AtimesBinv(A, B, device=None) -> torch.Tensor:
    """Numerically stable A · B^{-1} via a stacked thin QR
    (matrixci.jl:44-55), then a solve against QB, on the operands'
    device."""
    A = as_matrix(A, device)
    B = as_matrix(B, device)
    m, k = A.shape[0], B.shape[0]
    if k == 0:
        return A.new_zeros((m, 0))
    dtype = torch.promote_types(A.dtype, B.dtype)
    Q, _ = torch.linalg.qr(torch.cat([A.to(dtype), B.to(A.device, dtype)]),
                           mode="reduced")
    return torch.linalg.solve(Q[m:, :], Q[:m, :], left=False)


def AinvtimesB(A, B, device=None) -> torch.Tensor:
    """Numerically stable A^{-1} · B (matrixci.jl:73-76)."""
    A = as_matrix(A, device)
    B = as_matrix(B, device)
    return AtimesBinv(B.conj().T, A.conj().T).conj().T


def _select(t: torch.Tensor, dim: int, indices) -> torch.Tensor:
    """t restricted to `indices` along `dim` (None: all of it)."""
    if indices is None:
        return t
    return t.index_select(dim, index_tensor(indices, t.device))


class MatrixCI:
    """Cross interpolation storing pivot rows/columns (matrixci.jl:121-160).
    Row and column indices are host lists; pivot columns (m × k) and pivot
    rows (k × n) are tensors on one device."""

    def __init__(
        self,
        rowindices=None,
        colindices=None,
        pivotcols=None,
        pivotrows=None,
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
            i, j = firstpivot
            self.rowindices = [int(i)]
            self.colindices = [int(j)]
            self.pivotcols = A[:, int(j):int(j) + 1].clone()
            self.pivotrows = A[int(i):int(i) + 1, :].clone()
        elif pivotcols is not None:
            self.rowindices = [int(i) for i in rowindices]
            self.colindices = [int(j) for j in colindices]
            self.pivotcols = as_matrix(pivotcols, device)
            self.pivotrows = as_matrix(pivotrows, device).to(
                self.pivotcols.device)
        else:
            assert nrows is not None and ncols is not None
            dev = resolve_device(device)
            dt = torch_dtype(dtype)
            self.rowindices = []
            self.colindices = []
            self.pivotcols = torch.zeros((nrows, 0), dtype=dt, device=dev)
            self.pivotrows = torch.zeros((0, ncols), dtype=dt, device=dev)

    # -- accessors -------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.pivotcols.device

    def nrows(self) -> int:
        return self.pivotcols.shape[0]

    def ncols(self) -> int:
        return self.pivotrows.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows(), self.ncols())

    def rank(self) -> int:
        return len(self.rowindices)

    def npivots(self) -> int:
        return len(self.rowindices)

    def isempty(self) -> bool:
        return not self.colindices

    def firstpivotvalue(self):
        if self.isempty():
            return 1.0
        return self.pivotcols[self.rowindices[0], 0].item()

    def pivotmatrix(self) -> torch.Tensor:
        return _select(self.pivotcols, 0, self.rowindices)

    def leftmatrix(self) -> torch.Tensor:
        return AtimesBinv(self.pivotcols, self.pivotmatrix())

    def rightmatrix(self) -> torch.Tensor:
        return AinvtimesB(self.pivotmatrix(), self.pivotrows)

    def availablerows(self):
        return np.setdiff1d(np.arange(self.nrows()),
                            np.asarray(self.rowindices, dtype=np.int64)
                            ).tolist()

    def availablecols(self):
        return np.setdiff1d(np.arange(self.ncols()),
                            np.asarray(self.colindices, dtype=np.int64)
                            ).tolist()

    # -- evaluation ------------------------------------------------------

    def evaluate(self, i: int, j: int):
        if self.isempty():
            return 0.0
        return (self.leftmatrix()[i, :] @ self.pivotrows[:, j]).item()

    def submatrix(self, rows=None, cols=None) -> torch.Tensor:
        if self.isempty():
            nr = self.nrows() if rows is None else len(rows)
            nc = self.ncols() if cols is None else len(cols)
            return self.pivotcols.new_zeros((nr, nc))
        return _select(self.leftmatrix(), 0, rows) @ _select(
            self.pivotrows, 1, cols)

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

    def row(self, i: int, cols=None) -> torch.Tensor:
        return self.submatrix([i], cols)[0, :]

    def col(self, j: int, rows=None) -> torch.Tensor:
        return self.submatrix(rows, [j])[:, 0]

    def matrix(self) -> torch.Tensor:
        return self.leftmatrix() @ self.pivotrows

    def localerror(self, a, rows=None, cols=None) -> torch.Tensor:
        """Elementwise |a - approx| on the selected block
        (abstractmatrixci.jl:204-213)."""
        a = as_matrix(a, self.device)
        approx = self.submatrix(rows, cols)
        return (_select(_select(a, 0, rows), 1, cols) - approx).abs()

    def findnewpivot(self, a, rowindices=None, colindices=None):
        """Greedy argmax of |a - approx| over available rows/cols
        (abstractmatrixci.jl:250-281); one fetch."""
        a = as_matrix(a, self.device)
        if rowindices is None:
            rowindices = self.availablerows()
        if colindices is None:
            colindices = self.availablecols()
        if self.rank() == min(a.shape):
            raise ValueError(
                "Cannot find a new pivot for this MatrixCrossInterpolation, "
                "as it is already full rank."
            )
        if len(rowindices) == 0:
            raise ValueError("Cannot find a new pivot in an empty set of rows")
        if len(colindices) == 0:
            raise ValueError("Cannot find a new pivot in an empty set of cols")
        r, c, value = argmax_colmajor(
            self.localerror(a, rowindices, colindices))
        return (rowindices[r], colindices[c]), value

    # -- pivot insertion (matrixci.jl:430-542) ----------------------------

    def _check_shape(self, a) -> torch.Tensor:
        a = as_matrix(a, self.device)
        if tuple(a.shape) != self.shape:
            raise ValueError(
                f"Matrix size mismatch: {tuple(a.shape)} != {self.shape}.")
        return a

    def addpivotrow(self, a, rowindex: int) -> None:
        a = self._check_shape(a)
        if rowindex < 0 or rowindex >= self.nrows():
            raise IndexError(f"Row index {rowindex} out of bounds.")
        if rowindex in self.rowindices:
            raise ValueError(f"Cannot add row {rowindex}: it already has a pivot.")
        self.pivotrows = torch.cat(
            [self.pivotrows, a[int(rowindex)][None, :].to(self.pivotrows.dtype)])
        self.rowindices.append(int(rowindex))

    def addpivotcol(self, a, colindex: int) -> None:
        a = self._check_shape(a)
        if colindex < 0 or colindex >= self.ncols():
            raise IndexError(f"Col index {colindex} out of bounds.")
        if colindex in self.colindices:
            raise ValueError(f"Cannot add column {colindex}: it already has a pivot.")
        self.pivotcols = torch.cat(
            [self.pivotcols,
             a[:, int(colindex)][:, None].to(self.pivotcols.dtype)], dim=1)
        self.colindices.append(int(colindex))

    def addpivot(self, a, pivotindices=None) -> None:
        a = as_matrix(a, self.device)
        if pivotindices is None:
            pivotindices = self.findnewpivot(a)[0]
        i, j = pivotindices
        if tuple(a.shape) != self.shape:
            raise ValueError(
                f"Matrix size mismatch: {tuple(a.shape)} != {self.shape}.")
        if i < 0 or i >= self.nrows() or j < 0 or j >= self.ncols():
            raise IndexError(
                f"Pivot ({i}, {j}) out of bounds for a "
                f"{self.nrows()} x {self.ncols()} matrix."
            )
        if i in self.rowindices:
            raise ValueError(f"Row {i} already has a pivot.")
        if j in self.colindices:
            raise ValueError(f"Col {j} already has a pivot.")
        self.addpivotrow(a, i)
        self.addpivotcol(a, j)

    def isapprox(self, other: "MatrixCI") -> bool:
        return (
            self.colindices == other.colindices
            and self.rowindices == other.rowindices
            and torch.allclose(self.pivotcols, other.pivotcols.to(self.device))
            and torch.allclose(self.pivotrows, other.pivotrows.to(self.device))
        )


def matrix_crossinterpolate(
    a,
    tolerance: float = 1e-6,
    maxiter: int = 200,
    firstpivot: Optional[Tuple[int, int]] = None,
    device=None,
) -> MatrixCI:
    """Greedy full-matrix cross interpolation (matrixci.jl:580-604) on the
    matrix's device (a numpy matrix goes to `device`); one fetch a
    pivot."""
    a = as_matrix(a, device)
    if firstpivot is None:
        r, c, _ = argmax_colmajor(a.abs())
        firstpivot = (r, c)
    ci = MatrixCI(A=a, firstpivot=firstpivot)
    for _ in range(maxiter):
        r, c, err = argmax_colmajor((a - ci.matrix()).abs())
        if err < tolerance:
            return ci
        ci.addpivot(a, (r, c))
    return ci
