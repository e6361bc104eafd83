"""Rank-revealing LU with complete (full) and rook pivoting.

Counterpart of ``tci_tpu/ops/lu.py`` (parity reference: src/matrixlu.jl):
the factorization object, the adaptive rook search on an implicit matrix
(``arrlu``, matrixlu.jl:492-569), the factor completion
(cols2Lmatrix!/rows2Umatrix!, :627-674) and the triangular solves.
The elimination runs on the matrix's device (``lu_kernel.rrlu_raw``): a
numpy array goes to the current CUDA device unless the caller passes
``device="cpu"``, a tensor stays where it is. A CUDA panel runs the CUDA
kernel, a CPU panel the plain PyTorch version; the factors L and U stay on
the device as tensors, while permutations, npivot, the pivot diagonal and
the residual error are host values.

Indices are 0-based.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import numpy_dtype, resolve_device, to_device
from ..utils.util import pushrandomsubset
from .lu_kernel import rrlu_raw, submatrixargmax_colmajor

_INTMAX = 2**62


def submatrixargmax(
    A,
    rows=None,
    cols=None,
    f: Optional[Callable] = None,
    colmask: Optional[Callable] = None,
    rowmask: Optional[Callable] = None,
):
    """Position (r, c) maximizing f(A[r, c]) over the given row/col subsets.

    `rows`/`cols` may be index lists, slices, None (all), or a single int
    `startindex` passed as `rows` with cols=None meaning the trailing submatrix
    A[startindex:, startindex:]. First maximum in column-major order wins,
    matching matrixlu.jl:46-139.
    """
    A = A.cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)
    if f is None:
        f = lambda x: x.real if np.iscomplexobj(x) else x  # identity on reals

    if isinstance(rows, (int, np.integer)) and cols is None:
        start = int(rows)
        rows = list(range(start, A.shape[0]))
        cols = list(range(start, A.shape[1]))

    def convertarg(arg, size):
        if arg is None or arg == slice(None):
            return list(range(size))
        if isinstance(arg, (int, np.integer)):
            return [int(arg)]
        return list(arg)

    rows = convertarg(rows, A.shape[0])
    cols = convertarg(cols, A.shape[1])
    if len(rows) == 0:
        raise ValueError("rows must not be empty")
    if len(cols) == 0:
        raise ValueError("cols must not be empty")
    if not all(0 <= r < A.shape[0] for r in rows):
        raise ValueError("rows must be a subset of the row range of A")
    if not all(0 <= c < A.shape[1] for c in cols):
        raise ValueError("cols must be a subset of the column range of A")

    if rowmask is not None:
        rows = [r for r in rows if rowmask(r)]
    if colmask is not None:
        cols = [c for c in cols if colmask(c)]

    sub = A[np.ix_(rows, cols)]
    vals = np.vectorize(f)(sub) if sub.size else sub.real
    r, c = submatrixargmax_colmajor(vals)
    return rows[r], cols[c]


class rrLU:
    """Rank-revealing LU factorization P_r · A · P_c ≈ L · U.

    Fields mirror the reference struct (matrixlu.jl:200-231): row/col
    permutations (host int64), L (m × npivot) and U (npivot × n) as tensors
    on the matrix's device, the leftorthogonal flag, npivot and the residual
    `error` (magnitude of the first rejected pivot). `pivotdiag` is the host
    copy of the pivots (the LU diagonal), fetched with the permutations.
    """

    def __init__(
        self,
        rowpermutation,
        colpermutation,
        L: torch.Tensor,
        U: torch.Tensor,
        leftorthogonal: bool,
        npivot: int,
        error: float,
        pivotdiag: Optional[np.ndarray] = None,
    ):
        assert npivot == L.shape[1], "L must have npivot columns"
        assert npivot == U.shape[0], "U must have npivot rows"
        assert len(rowpermutation) == L.shape[0]
        assert len(colpermutation) == U.shape[1]
        self.rowpermutation = np.asarray(rowpermutation, dtype=np.int64)
        self.colpermutation = np.asarray(colpermutation, dtype=np.int64)
        self.L = torch.as_tensor(L)
        self.U = torch.as_tensor(U)
        self.leftorthogonal = bool(leftorthogonal)
        self.npivot = int(npivot)
        self.error = float(error)
        if pivotdiag is None:
            D = self.U if self.leftorthogonal else self.L
            pivotdiag = torch.diagonal(D[:npivot, :npivot]).cpu().numpy()
        self._diag = np.asarray(pivotdiag)
        # device copies of the permutations, for the scatters in left/right
        dev = self.L.device
        self._rowperm_dev = to_device(self.rowpermutation, dev)
        self._colperm_dev = to_device(self.colpermutation, dev)

    # -- accessors (matrixlu.jl:685-813) ---------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.L.shape[0], self.U.shape[1])

    def size(self, dim: Optional[int] = None):
        if dim is None:
            return self.shape
        return self.shape[dim]

    def left(self, permute: bool = True) -> torch.Tensor:
        if permute:
            out = torch.empty_like(self.L)
            out[self._rowperm_dev, :] = self.L
            return out
        return self.L

    def right(self, permute: bool = True) -> torch.Tensor:
        if permute:
            out = torch.empty_like(self.U)
            out[:, self._colperm_dev] = self.U
            return out
        return self.U

    def diag(self) -> np.ndarray:
        return self._diag.copy()

    def rowindices(self) -> np.ndarray:
        return self.rowpermutation[: self.npivot]

    def colindices(self) -> np.ndarray:
        return self.colpermutation[: self.npivot]

    def npivots(self) -> int:
        return self.npivot

    def pivoterrors(self) -> np.ndarray:
        return np.concatenate([np.abs(self.diag()), [self.error]])

    def lastpivoterror(self) -> float:
        return self.error

    def transpose(self) -> "rrLU":
        """LU factorization of A^T (matrixlu.jl:918-923)."""
        return rrLU(
            self.colpermutation,
            self.rowpermutation,
            self.U.T.contiguous(),
            self.L.T.contiguous(),
            not self.leftorthogonal,
            self.npivot,
            self.error,
            self._diag,
        )

    @property
    def T(self) -> "rrLU":
        return self.transpose()

    def solve(self, b) -> torch.Tensor:
        """Solve A x = b via the factorization; requires square full rank."""
        return lu_solve(self, b)

    def __repr__(self):
        return (
            f"rrLU(shape={self.shape}, npivot={self.npivot}, "
            f"error={self.error:.3e}, leftorthogonal={self.leftorthogonal})"
        )


def _finalize(
    LUmat: torch.Tensor,
    rowperm: np.ndarray,
    colperm: np.ndarray,
    npivot: int,
    err: float,
    leftorthogonal: bool,
    diag: np.ndarray,
    nan_in_factors: Tuple[bool, bool],
) -> rrLU:
    m, n = LUmat.shape
    k = npivot
    L = torch.tril(LUmat[:, :k])
    U = torch.triu(LUmat[:k, :])
    if nan_in_factors[0]:
        raise ValueError("lu.L contains NaNs")
    if nan_in_factors[1]:
        raise ValueError("lu.U contains NaNs")
    if leftorthogonal:
        L.diagonal().fill_(1.0)
    else:
        U.diagonal().fill_(1.0)
    if k >= min(m, n):
        err = 0.0
    return rrLU(rowperm, colperm, L, U, leftorthogonal, k, err, diag)


def rrlu(
    A,
    maxrank: int = _INTMAX,
    reltol: float = 1e-14,
    abstol: float = 0.0,
    leftorthogonal: bool = True,
    mesh=None,
    pivotsearch: str = "full",
    precision: str = "f64",
    numrookiter: int = 5,
    hunt_stages: Optional[int] = None,
    rng=None,
    device=None,
) -> rrLU:
    """Rank-revealing LU of a dense matrix (numpy array or tensor).

    A numpy array is uploaded to `device`: the current CUDA device by
    default, and a RuntimeError without one unless ``device="cpu"`` is
    given. A tensor stays where the caller put it (that is the caller
    choosing its device), unless `device` is given.

    pivotsearch="full": complete pivoting; the whole elimination is one
    launch of the CUDA kernel on a CUDA device and the plain PyTorch loop
    on the CPU. Stop rule and at-least-one-pivot semantics match
    matrixlu.jl:346-396. With ``mesh=`` (a ``parallel.mesh`` DeviceMesh;
    every rank calls with the same A) the elimination is row-sharded over
    the mesh's ranks (``ops/lu_sharded.rrlu_sharded_raw``), with the
    one-device pivot order bit for bit, on the mesh's devices.

    pivotsearch="rook": the reference's adaptive rook scheme (arrlu,
    matrixlu.jl:492-569) on the device-resident matrix
    (``lu_device.rrlu_rook_device_fused``): each slab elimination is one
    launch of the kernel. With precision="mixed" (float64 input) the pivot
    hunt runs in float32 and the factors are rebuilt in float64 from the
    pivot sets; ``hunt_stages`` (mixed only) defaults to 1, or 2 when
    reltol or abstol ask for more than float32's ~1e-7 resolution.
    Complex input runs at full precision. ``maxrank`` is also the slab
    width (capped at min(m, n)): pass the target rank.
    """
    if pivotsearch == "rook":
        if mesh is not None:
            raise ValueError(
                "pivotsearch='rook' is a single-device program; mesh= is "
                "only supported with pivotsearch='full'")
        from .lu_device import _as_matrix, rrlu_rook_device_fused

        A = _as_matrix(A, device)
        maxrank = int(min(maxrank, *A.shape))
        if hunt_stages is None:
            # one deflated re-hunt only when the requested resolution is
            # beyond one f32 hunt's (~1e-7 relative): reltol below 1e-6 or
            # abstol below 1e-6 max|A| (tci_tpu's rule, ROADMAP C-ref-1)
            if precision == "mixed" and A.dtype == torch.float64:
                scale = float(A.abs().max()) if A.numel() else 0.0
                deep = (0 < reltol < 1e-6) or (0 < abstol < 1e-6 * scale)
                hunt_stages = 2 if deep else 1
            else:
                hunt_stages = 1
        if A.is_complex():
            precision = "f64"  # complex runs the plain-precision path
            hunt_stages = 1
        return rrlu_rook_device_fused(
            A, maxrank=maxrank, reltol=reltol, abstol=abstol,
            leftorthogonal=leftorthogonal, numrookiter=numrookiter,
            rng=rng, precision=precision, hunt_stages=hunt_stages,
        ).to_rrlu()
    if pivotsearch != "full":
        raise ValueError(
            f"Unknown pivot search strategy {pivotsearch}. "
            "Choose between rook and full."
        )
    if mesh is not None:
        from .lu_sharded import rrlu_sharded_raw

        LUmat, rowperm, colperm, k, diag, err, nanflags = rrlu_sharded_raw(
            A, maxrank, reltol, abstol, leftorthogonal, mesh=mesh)
    else:
        LUmat, rowperm, colperm, k, diag, err, nanflags = rrlu_raw(
            A, maxrank, reltol, abstol, leftorthogonal, device=device)
    return _finalize(LUmat, rowperm, colperm, k, err, leftorthogonal,
                     diag, nanflags)


def _on(X, like: Optional[torch.Tensor], device) -> torch.Tensor:
    """X as a tensor: a tensor stays where it is, a numpy array goes to the
    device of `like` when given, else to ``resolve_device(device)``."""
    if isinstance(X, torch.Tensor):
        return X
    dev = like.device if like is not None else resolve_device(device)
    return to_device(np.asarray(X), dev)


def cols2Lmatrix(C, P, leftorthogonal: bool, device=None) -> torch.Tensor:
    """Transform sampled columns C into L-matrix rows: C <- C · P^{-1} with P
    upper-triangular (matrixlu.jl:627-647, as a triangular solve on P's
    device). Numpy input goes to `device` (the current CUDA device by
    default; ``device="cpu"`` for the CPU)."""
    P = _on(P, C if isinstance(C, torch.Tensor) else None, device)
    C = _on(C, P, device)
    if C.shape[1] != P.shape[1]:
        raise ValueError("C and P must have the same number of columns")
    if P.shape[0] != P.shape[1]:
        raise ValueError("P must be square")
    if P.shape[0] == 0:
        return C
    # X · P = C with P upper triangular
    return torch.linalg.solve_triangular(P, C, upper=True, left=False)


def rows2Umatrix(R, P, leftorthogonal: bool, device=None) -> torch.Tensor:
    """Transform sampled rows R into U-matrix columns: R <- P^{-1} · R with P
    lower-triangular (matrixlu.jl:654-674), on P's device."""
    P = _on(P, R if isinstance(R, torch.Tensor) else None, device)
    R = _on(R, P, device)
    if R.shape[0] != P.shape[0]:
        raise ValueError("R and P must have the same number of rows")
    if P.shape[0] != P.shape[1]:
        raise ValueError("P must be square")
    if P.shape[0] == 0:
        return R
    return torch.linalg.solve_triangular(P, R, upper=False)


def _host_values(v) -> np.ndarray:
    """Sampled values as a host array (a tensor is copied back)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def arrlu(
    valuetype,
    f: Callable[[Sequence[int], Sequence[int]], np.ndarray],
    matrixsize: Tuple[int, int],
    I0: Sequence[int] = (),
    J0: Sequence[int] = (),
    maxrank: int = _INTMAX,
    reltol: float = 1e-14,
    abstol: float = 0.0,
    leftorthogonal: bool = True,
    numrookiter: int = 5,
    usebatcheval: bool = False,
    rng: Optional[np.random.Generator] = None,
    device=None,
) -> rrLU:
    """Adaptive rank-revealing LU by rook pivoting on an implicit matrix.

    `f` gives matrix entries: elementwise f(i, j) by default, or batched
    f(rows, cols) -> |rows| x |cols| array when usebatcheval=True.
    Alternating row/column moves sample one full slab per move, factorize
    it with the complete-pivot elimination (``rrlu_raw`` on `device`: the
    kernel on the card, the plain version on the CPU) and iterate the pivot
    sets until they are self-consistent (matrixlu.jl:492-569). The missing
    factor side is then completed by triangular solves on the device
    (cols2Lmatrix/rows2Umatrix). The samples are taken on the host."""
    if rng is None:
        rng = np.random.default_rng()
    dev = resolve_device(device)
    valuetype = numpy_dtype(valuetype)
    m, n = matrixsize
    maxrank = min(maxrank, m, n)

    if usebatcheval:
        def _batchf(rows, cols):
            return _host_values(f(rows, cols))
    else:
        def _batchf(rows, cols):
            return np.array([[f(i, j) for j in cols] for i in rows],
                            dtype=valuetype).reshape(len(rows), len(cols))

    I0 = list(I0)
    J0 = list(J0)
    islowrank = False
    lu = None
    last_full_rows = False  # whether the last factorized slab spanned all rows
    rows_l = cols_l = None

    while True:
        if leftorthogonal:
            pushrandomsubset(J0, range(n), max(1, len(J0)), rng)
        else:
            pushrandomsubset(I0, range(m), max(1, len(I0)), rng)

        for rookiter in range(1, numrookiter + 1):
            colmove = (rookiter % 2 == 0) == leftorthogonal
            if colmove:
                rows_l, cols_l = list(I0), list(range(n))
                last_full_rows = False
            else:
                rows_l, cols_l = list(range(m)), list(J0)
                last_full_rows = True
            sub = _batchf(rows_l, cols_l)
            LUmat, rp, cp, k, diag, err, flags = rrlu_raw(
                sub, maxrank, reltol, abstol, leftorthogonal, device=dev)
            lu = _finalize(LUmat, rp, cp, k, err, leftorthogonal, diag,
                           flags)
            islowrank |= lu.npivot < min(sub.shape)
            newI = [rows_l[i] for i in lu.rowindices()]
            newJ = [cols_l[j] for j in lu.colindices()]
            if newI == I0 and newJ == J0:
                break
            I0, J0 = newI, newJ

        if islowrank or len(I0) >= maxrank:
            break

    assert lu is not None
    k = lu.npivot
    pivotblock_L = lu.L[:k, :k]
    pivotblock_U = lu.U[:k, :k]

    if last_full_rows:
        # L covers all rows already (in permuted order); complete U columns.
        rowpermutation = np.array(
            [rows_l[i] for i in lu.rowpermutation], dtype=np.int64)
        L = lu.L
        J0s = set(J0)
        J2 = [j for j in range(n) if j not in J0s]
        colpermutation = np.array(J0 + J2, dtype=np.int64)
        U = pivotblock_U
        if J2:
            U2 = rows2Umatrix(to_device(_batchf(I0, J2), dev), pivotblock_L,
                              leftorthogonal)
            U = torch.hstack([pivotblock_U, U2])
    else:
        # U covers all columns; complete L rows.
        colpermutation = np.array(
            [cols_l[j] for j in lu.colpermutation], dtype=np.int64)
        U = lu.U
        I0s = set(I0)
        I2 = [i for i in range(m) if i not in I0s]
        rowpermutation = np.array(I0 + I2, dtype=np.int64)
        L = pivotblock_L
        if I2:
            L2 = cols2Lmatrix(to_device(_batchf(I2, J0), dev), pivotblock_U,
                              leftorthogonal)
            L = torch.vstack([pivotblock_L, L2])

    return rrLU(rowpermutation, colpermutation, L, U, leftorthogonal, k,
                lu.error, lu.diag())


def rrlu_from_function(
    valuetype,
    f,
    matrixsize: Tuple[int, int],
    I0: Sequence[int] = (),
    J0: Sequence[int] = (),
    pivotsearch: str = "full",
    usebatcheval: bool = False,
    rng: Optional[np.random.Generator] = None,
    device=None,
    **kwargs,
) -> rrLU:
    """Function-based rrLU: sample the full matrix (full) or rook-pivot
    (rook), on `device` (the card by default). Parity: matrixlu.jl:593-611."""
    if pivotsearch == "rook":
        return arrlu(
            valuetype, f, matrixsize, I0, J0,
            usebatcheval=usebatcheval, rng=rng, device=device, **kwargs,
        )
    elif pivotsearch == "full":
        valuetype = numpy_dtype(valuetype)
        rows = list(range(matrixsize[0]))
        cols = list(range(matrixsize[1]))
        if usebatcheval:
            A = _host_values(f(rows, cols))
        else:
            A = np.array(
                [[f(i, j) for j in cols] for i in rows], dtype=valuetype
            ).reshape(matrixsize)
        return rrlu(A, device=device, **kwargs)
    raise ValueError(
        f"Unknown pivot search strategy {pivotsearch}. Choose between rook "
        "and full.")


def lu_solve(lu: rrLU, b) -> torch.Tensor:
    """Solve A x = b given the rrLU of A (square, full rank), on the
    factors' device (a numpy b is moved there).

    Parity: matrixlu.jl:839-905 (forward then backward substitution with the
    row/column permutations applied)."""
    if lu.shape[0] != lu.shape[1]:
        raise ValueError("Matrix must be square.")
    if lu.npivot != lu.shape[0]:
        raise ValueError("rank-deficient matrix is not supported!")
    b = _on(b, lu.L, None)
    dtype = torch.promote_types(lu.L.dtype, b.dtype)
    b = b.to(dtype)
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    b_perm = b[lu._rowperm_dev, :]
    y = torch.linalg.solve_triangular(lu.L.to(dtype), b_perm, upper=False)
    x_perm = torch.linalg.solve_triangular(lu.U.to(dtype), y, upper=True)
    x = torch.empty_like(x_perm)
    x[lu._colperm_dev, :] = x_perm
    return x[:, 0] if squeeze else x
