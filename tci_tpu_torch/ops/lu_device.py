"""Device-resident adaptive (rook) rank-revealing LU.

Counterpart of ``tci_tpu/ops/lu_device.py``. The reference's ``arrlu``
(src/matrixlu.jl:492-569) avoids complete pivoting's sweep over the whole
matrix at every pivot by factorizing alternating row and column slabs until
the pivot sets are self-consistent: its traffic is O(m r^2) instead of
O(m n r). Here the matrix lives on the device (the card unless the caller
asks for the CPU), and so do the slab gathers, the slab eliminations (the
rrLU kernel, ``csrc/rrlu.cu``, at extents held on the device; the plain
version on the CPU) and the completion of the missing factor side. The host
moves only pivot index lists.

``rrlu_rook_device_fused`` (exported as ``rrlu_serving``) queues the whole
alternation without reading a device value: ``tci_tpu`` traces it into one
XLA program with a ``while_loop``; here the loop is unrolled into
`numrookiter` predicated steps, each of which keeps the state it was given
once the sets agree (``torch.where(done, old, new)``) and eliminates its
slab with a rank cap of 0 then, so a dead step changes nothing and does no
pivot work. The one fetch comes at ``result()``.

``precision="mixed"`` hunts the pivots in float32 on the kernel's f32 path
and rebuilds the float64 factors from the pivot sets alone
(``_assemble_mixed``: a complete-pivot elimination of the k x k block on
the kernel, triangular inverses by blocked substitution and Neumann
doubling, two GEMMs), as ``tci_tpu`` does. Complex128 runs the plain
precision path in complex128.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import fetch, resolve_device, to_device
from ..utils.util import pushrandomsubset
from .lu import _finalize, rrLU
from .lu_kernel import bucket, rrlu_panel, rrlu_panel_batched

_INTMAX = 2**62


def _as_matrix(A, device) -> torch.Tensor:
    """A numpy array on `device` (the card by default), a tensor where it
    lies (or on `device` when given), in a dtype the kernel takes: float32
    and float64 stay, complex becomes complex128, anything else float64."""
    if not isinstance(A, torch.Tensor):
        A = to_device(np.asarray(A), resolve_device(device))
    elif device is not None:
        A = A.to(resolve_device(device))
    if A.is_complex():
        return A.to(torch.complex128)
    if A.dtype not in (torch.float32, torch.float64):
        return A.to(torch.float64)
    return A


def _elim(P, m, n, maxrank, reltol, abstol, leftorthogonal: bool):
    """One panel through the rrLU kernel (or, on the CPU, its plain
    version), with extents and rank cap as 0-d integer tensors on P's
    device and the tolerances as 0-d tensors or floats: nothing is read
    back. Returns the 6-tuple of ``lu_kernel.rrlu_plain``."""
    tol = [t.reshape(1) if isinstance(t, torch.Tensor) else t
           for t in (reltol, abstol)]
    out = rrlu_panel_batched(P[None].contiguous(), m.reshape(1),
                             n.reshape(1), maxrank.reshape(1), *tol,
                             leftorthogonal=leftorthogonal)
    return tuple(x[0] for x in out)


def _fit_to(x: torch.Tensor, size: int) -> torch.Tensor:
    """Pad (with zeros) or trim a 1-D tensor to `size` entries."""
    if x.shape[0] >= size:
        return x[:size]
    return torch.cat([x, x.new_zeros(size - x.shape[0])])


def _slab_lu(A, idx, k_true: int, maxrank: int, reltol: float,
             abstol: float, *, leftorthogonal: bool, rows_slab: bool):
    """Complete-pivot LU of the row slab A[idx, :] (rows_slab) or the column
    slab A[:, idx]; idx (a device tensor) is padded to a bucketed length,
    and its padded slots are masked to zero, which the elimination never
    selects."""
    valid = torch.arange(idx.shape[0], device=A.device) < k_true
    if rows_slab:
        slab = torch.where(valid[:, None], A.index_select(0, idx), 0)
        m_true, n_true = k_true, A.shape[1]
    else:
        slab = torch.where(valid[None, :], A.index_select(1, idx), 0)
        m_true, n_true = A.shape[0], k_true
    maxrank = min(maxrank, m_true, n_true)
    return rrlu_panel(slab.contiguous(), m_true, n_true, maxrank, reltol,
                      abstol, leftorthogonal=leftorthogonal)


def _complete_factor(A, sel_idx, other_idx, P, *, transpose_solve: bool):
    """The missing side of the factors (matrixlu.jl:627-674) on the device,
    as one triangular solve against the k x k pivot block P.

    transpose_solve=False: U2 = P^{-1} A[sel, other] with P lower triangular
    (rows2Umatrix); True: L2 = A[other, sel] P^{-1} with P upper triangular
    (cols2Lmatrix). ``tci_tpu`` inverts P on the host and makes one GEMM,
    because XLA's f64 triangular solve is slow on a TPU; on the card the
    solve is cuBLAS's ``trsm``, chosen by a measurement (PERF.md)."""
    if transpose_solve:
        C = A.index_select(0, other_idx).index_select(1, sel_idx)
        return torch.linalg.solve_triangular(P, C, upper=True, left=False)
    R = A.index_select(0, sel_idx).index_select(1, other_idx)
    return torch.linalg.solve_triangular(P, R, upper=False)


def _unit_diag(T: torch.Tensor) -> torch.Tensor:
    T = T.clone()
    T.diagonal().fill_(1.0)
    return T


class DeviceRRLU:
    """rrLU result whose factors stay on the device (the serving path: the
    factors feed further device work). left()/right() return the factors in
    natural row/column order as tensors; to_rrlu() gives the package's
    rrLU (pivot-order factors, host permutations)."""

    def __init__(self, L_nat, U_nat, rowpermutation, colpermutation,
                 npivot: int, error: float, leftorthogonal: bool,
                 nslabs: Optional[int] = None):
        self.L_nat = L_nat  # (m, k) on the device, natural row order
        self.U_nat = U_nat  # (k, n) on the device, natural column order
        self.rowpermutation = np.asarray(rowpermutation, dtype=np.int64)
        self.colpermutation = np.asarray(colpermutation, dtype=np.int64)
        self.npivot = int(npivot)
        self.error = float(error)
        self.leftorthogonal = bool(leftorthogonal)
        # the slab eliminations the alternation ran (None for the
        # host-driven loop)
        self.nslabs = None if nslabs is None else int(nslabs)

    def npivots(self) -> int:
        return self.npivot

    def left(self) -> torch.Tensor:
        return self.L_nat

    def right(self) -> torch.Tensor:
        return self.U_nat

    def rowindices(self) -> np.ndarray:
        return self.rowpermutation[: self.npivot]

    def colindices(self) -> np.ndarray:
        return self.colpermutation[: self.npivot]

    def to_rrlu(self) -> rrLU:
        """The factors in pivot order as the package's rrLU (they stay on
        the device)."""
        dev = self.L_nat.device
        L = self.L_nat[to_device(self.rowpermutation, dev), :]
        U = self.U_nat[:, to_device(self.colpermutation, dev)]
        return rrLU(self.rowpermutation, self.colpermutation, L, U,
                    self.leftorthogonal, self.npivot, self.error)


def _assemble_cols_branch(A, LUp, piv_cols, i2, inv_rowperm, inv_colperm,
                          k: int, unit_lower: bool):
    """The last slab spanned all columns: U is the slab's U (k x n) and L is
    completed over the remaining rows i2 by one triangular solve. Returns
    natural-order factors."""
    n = A.shape[1]
    U = torch.triu(LUp[:k, :n])
    if not unit_lower:
        U = _unit_diag(U)
    Lblk = torch.tril(LUp[:k, :k])
    if unit_lower:
        Lblk = _unit_diag(Lblk)
    L = Lblk
    if i2.shape[0]:
        L2 = _complete_factor(A, piv_cols, i2, U[:, :k],
                              transpose_solve=True)
        L = torch.cat([Lblk, L2], dim=0)
    return L[inv_rowperm, :], U[:, inv_colperm]


def _assemble_rows_branch(A, LUp, piv_rows, j2, inv_rowperm, inv_colperm,
                          k: int, unit_lower: bool):
    """The last slab spanned all rows: L is the slab's L (m x k) and U is
    completed over the remaining columns j2 by one triangular solve."""
    m = A.shape[0]
    L = torch.tril(LUp[:m, :k])
    if unit_lower:
        L = _unit_diag(L)
    Ublk = torch.triu(LUp[:k, :k])
    if not unit_lower:
        Ublk = _unit_diag(Ublk)
    U = Ublk
    if j2.shape[0]:
        U2 = _complete_factor(A, piv_rows, j2, L[:k, :],
                              transpose_solve=False)
        U = torch.cat([Ublk, U2], dim=1)
    return L[inv_rowperm, :], U[:, inv_colperm]


def _assemble_mixed(A, Ipad, Jpad, k, reltol, abstol, *, unit_lower: bool,
                    maxrank=None):
    """Completion of the rook factors in f64 from the pivot sets alone
    (``tci_tpu``'s ``_assemble_mixed_body``).

      B = A[I, J]           the k x k pivot block, gathered in f64, and its
                            complete-pivot elimination on the kernel (the
                            f32 hunt fixes the pivot sets; their order is
                            noise below f32 resolution, so the block is
                            re-pivoted, matrixlu.jl:566);
      Linv, Uinv            the triangular inverses of the re-pivoted
                            block by blocked substitution: the diagonal
                            b x b blocks by substitution, all at once, then
                            the off-diagonal part by Neumann doubling;
      L = A[:, J] Uinv,     U = Linv A[I, :], two GEMMs, with the exact
                            triangular blocks scattered into the pivot rows
                            and columns.

    Rank detection is the reference stop rule (matrixlu.jl:363) on the f64
    block's pivots. Ipad / Jpad are the pivot ids padded to the width Rb,
    k (and maxrank, the cap when the deflated hunt supplies more
    candidates than the rank) 0-d device tensors. Returns natural-order L
    (m, Rb) and U (Rb, n), zero past keff, keff, the first rejected pivot's
    magnitude, and the re-pivoted ids (Ire, Jre), whose first keff entries
    are the accepted pivots in elimination order."""
    m, n = A.shape
    Rb = Ipad.shape[0]
    dt, dev = A.dtype, A.device
    idx = torch.arange(Rb, device=dev)
    valid0 = idx < k
    Ig = torch.where(valid0, Ipad, 0)
    Jg = torch.where(valid0, Jpad, 0)
    eye = torch.eye(Rb, dtype=dt, device=dev)
    B0 = A.index_select(0, Ig).index_select(1, Jg)
    B0 = torch.where(valid0[:, None] & valid0[None, :], B0, 0)
    mr = k if maxrank is None else torch.minimum(k, maxrank)
    LUp, rp, cp, keff, _, rejerr = _elim(B0, k, k, mr, reltol, abstol,
                                         unit_lower)
    # the pivot ids in elimination (complete-pivot) order
    Ire = Ig[rp[:Rb]]
    Jre = Jg[cp[:Rb]]
    valid = idx < keff
    v2 = valid[:, None] & valid[None, :]

    # triangular factors of the re-pivoted block; identity in the dead
    # region, where the substitution recurrences are exact no-ops
    Lb = torch.tril(LUp[:Rb, :Rb])
    Ub = torch.triu(LUp[:Rb, :Rb])
    if unit_lower:
        Lb = Lb * (1 - eye) + eye
    else:
        Ub = Ub * (1 - eye) + eye
    Lb = torch.where(v2, Lb, eye)
    Ub = torch.where(v2, Ub, eye)

    # blocked substitution: the G diagonal b x b blocks of both triangles
    # in one b-step loop (L rows forward, U rows backward), then the
    # off-diagonal part by Neumann doubling: T = D (I + N) with N = D^-1 (T
    # - D) strictly block-triangular (N^G = 0), so T^-1 = (sum_{q<G} (-N)^q)
    # D^-1, built in ceil(log2 G) squarings
    b = 32 if Rb % 32 == 0 else (16 if Rb % 16 == 0 else 8)
    G = Rb // b
    gi = torch.arange(G, device=dev)
    bmask = (idx[:, None] // b) == (idx[None, :] // b)
    Ld = Lb.reshape(G, b, G, b)[gi, :, gi, :]
    Ud = Ub.reshape(G, b, G, b)[gi, :, gi, :]
    eb = torch.eye(b, dtype=dt, device=dev)
    ib = torch.arange(b, device=dev)
    Xl = torch.zeros((G, b, b), dtype=dt, device=dev)
    Xu = torch.zeros((G, b, b), dtype=dt, device=dev)
    for t in range(b):
        rl = torch.einsum("gj,gjk->gk", Ld[:, t, :] * (ib < t).to(dt), Xl)
        Xl[:, t, :] = (eb[t] - rl) / Ld[:, t, t][:, None]
        ju = b - 1 - t
        ru = torch.einsum("gj,gjk->gk", Ud[:, ju, :] * (ib > ju).to(dt), Xu)
        Xu[:, ju, :] = (eb[ju] - ru) / Ud[:, ju, ju][:, None]

    def block_diag(X):
        D = torch.zeros((G, b, G, b), dtype=dt, device=dev)
        D[gi, :, gi, :] = X
        return D.reshape(Rb, Rb)

    def neumann_inv(T, Dinv):
        N = Dinv @ torch.where(bmask, 0, T)
        X = -N
        P = eye + X
        for _ in range(max(0, (G - 1).bit_length() - 1)):
            X = X @ X
            P = P + P @ X
        return P @ Dinv

    DLinv, DUinv = block_diag(Xl), block_diag(Xu)
    Linv = neumann_inv(Lb, DLinv) if G > 1 else DLinv
    Uinv = neumann_inv(Ub, DUinv) if G > 1 else DUinv
    Linv = torch.where(v2, Linv, 0)
    Uinv = torch.where(v2, Uinv, 0)
    Lblk = torch.where(v2, Lb, 0)
    Ublk = torch.where(v2, Ub, 0)

    vf = valid.to(dt)
    IgR = torch.where(valid, Ire, 0)
    JgR = torch.where(valid, Jre, 0)
    L_nat = (A.index_select(1, JgR) * vf[None, :]) @ Uinv
    U_nat = Linv @ (A.index_select(0, IgR) * vf[:, None])
    # the exact triangular blocks into the pivot rows / columns; padded
    # slots go to an extra row / column that is cut off
    Iscat = torch.where(valid, Ire, m)
    Jscat = torch.where(valid, Jre, n)
    L_ext = torch.cat([L_nat, L_nat.new_zeros((1, Rb))])
    L_ext[Iscat] = Lblk
    U_ext = torch.cat([U_nat, U_nat.new_zeros((Rb, 1))], dim=1)
    U_ext[:, Jscat] = Ublk
    L_nat = L_ext[:m] * vf[None, :]
    U_nat = U_ext[:, :n] * vf[:, None]
    return L_nat, U_nat, keff, rejerr, Ire, Jre


def _alternation(A, I0, I0len, J0, J0len, maxrank, reltol, abstol, *,
                 Rb: int, numrookiter: int, leftorthogonal: bool):
    """The rook alternation on the device-resident (M, N) matrix A with slab
    width Rb (``tci_tpu``'s ``_make_rook_alternation``), then the final row
    slab's elimination. I0 / J0 are (Rb,) start sets, the lengths and
    maxrank 0-d integer tensors, all on A's device.

    ``tci_tpu``'s while loop becomes `numrookiter` predicated steps: a step
    after the sets agreed keeps every carried quantity and eliminates its
    slab with a rank cap of 0. The final row slab is the last step's when
    that step was a row move (its factors are that elimination), else one
    more elimination (a rank cap of 0 when it is not needed). Returns (LUp
    (Rb, N), rp, cp, kf, err_final, newI, newJ, nslabs), all on the
    device."""
    M, N = A.shape
    dev = A.device
    idx = torch.arange(Rb, device=dev)
    Mt = torch.tensor(M, device=dev)
    Nt = torch.tensor(N, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def slab_rows(I0_, I0len_, cap):
        valid = idx < I0len_
        slab = torch.where(valid[:, None], A.index_select(0, I0_), 0)
        smin = torch.minimum(I0len_, Nt)
        mr = torch.minimum(cap, smin)
        LUp, rp, cp, k, _, err = _elim(slab, I0len_, Nt, mr, reltol, abstol,
                                       leftorthogonal)
        newI = torch.where(valid, I0_[rp], 0)
        newJ = torch.where(valid, _fit_to(cp, Rb), 0)
        return newI, k, newJ, k, k, err, smin, LUp, rp, cp

    def slab_cols(J0_, J0len_, cap):
        valid = idx < J0len_
        slab = torch.where(valid[None, :], A.index_select(1, J0_), 0)
        smin = torch.minimum(Mt, J0len_)
        mr = torch.minimum(cap, smin)
        _, rp, cp, k, _, err = _elim(slab, Mt, J0len_, mr, reltol, abstol,
                                     leftorthogonal)
        newI = torch.where(valid, _fit_to(rp, Rb), 0)
        newJ = torch.where(valid, J0_[cp], 0)
        return newI, k, newJ, k, k, err, smin

    rdt = A.dtype.to_real()
    nan = torch.full((), float("nan"), dtype=rdt, device=dev)
    st = {"I0": I0, "I0len": I0len, "J0": J0, "J0len": J0len, "k": zero,
          "err": nan, "errw": nan, "smin": zero, "it": zero,
          "done": torch.zeros((), dtype=torch.bool, device=dev),
          "LUp": torch.zeros((Rb, N), dtype=A.dtype, device=dev),
          "rp": torch.zeros(Rb, dtype=torch.int64, device=dev),
          "cp": torch.zeros(N, dtype=torch.int64, device=dev),
          "rowok": torch.zeros((), dtype=torch.bool, device=dev)}
    for it in range(numrookiter):
        # matrixlu.jl's alternation: for leftorthogonal the first move
        # factorizes the column slab A[:, J0]
        rowmove = ((it + 1) % 2 == 0) == leftorthogonal
        live = ~st["done"]
        cap = torch.where(live, maxrank, 0)
        if rowmove:
            nI, nIl, nJ, nJl, k2, e2, sm, LUp2, rp2, cp2 = slab_rows(
                st["I0"], st["I0len"], cap)
        else:
            nI, nIl, nJ, nJl, k2, e2, sm = slab_cols(st["J0"], st["J0len"],
                                                     cap)
            LUp2, rp2, cp2 = st["LUp"], st["rp"], st["cp"]
        errw2 = torch.where(k2 < sm, e2, st["errw"])
        sameI = (nIl == st["I0len"]) & ((idx >= nIl) | (nI == st["I0"])).all()
        sameJ = (nJl == st["J0len"]) & ((idx >= nJl) | (nJ == st["J0"])).all()
        new = {"I0": nI, "I0len": nIl, "J0": nJ, "J0len": nJl, "k": k2,
               "err": e2, "errw": errw2, "smin": sm, "it": st["it"] + 1,
               "done": sameI & sameJ, "LUp": LUp2, "rp": rp2, "cp": cp2,
               "rowok": torch.full((), rowmove, device=dev)}
        st = {key: torch.where(live, new[key], st[key]) for key in st}

    # the final row slab on the final row set: the last executed move's
    # factors when it was a row move, else one more elimination
    rowok = st["rowok"]
    re = slab_rows(st["I0"], st["I0len"], torch.where(rowok, 0, maxrank))
    kept = (st["I0"], st["I0len"], st["J0"], st["J0len"], st["k"], st["err"],
            st["smin"], st["LUp"], st["rp"], st["cp"])
    newI, _, newJ, _, kf, ef, sminf, LUp, rp, cp = (
        torch.where(rowok, a, b) for a, b in zip(kept, re))
    errw = torch.where(kf < sminf, ef, st["errw"])
    err_final = torch.where(errw.isnan(), torch.where(kf >= sminf, 0.0, ef),
                            errw)
    nslabs = st["it"] + (~rowok).to(torch.int64)
    return LUp, rp, cp, kf, err_final, newI, newJ, nslabs


class _PendingRRLU:
    """Deferred handle from ``rrlu_rook_device_fused(defer=True)``: the
    factorization is queued on the device; ``result()`` fetches its record
    (where the host waits for the stream) and finishes the index
    bookkeeping, once."""

    def __init__(self, finish):
        self._finish = finish
        self._result: Optional[DeviceRRLU] = None

    def result(self) -> DeviceRRLU:
        if self._result is None:
            self._result = self._finish()
            self._finish = None
        return self._result


def _perm_from(sel: np.ndarray, size: int) -> np.ndarray:
    """`sel` followed by the other indices of range(size), ascending."""
    mask = np.ones(size, dtype=bool)
    mask[sel] = False
    return np.concatenate([sel, np.nonzero(mask)[0]])


def rrlu_rook_device_fused(
    A,
    maxrank: int,
    reltol: float = 1e-14,
    abstol: float = 0.0,
    leftorthogonal: bool = True,
    numrookiter: int = 5,
    rng: Optional[np.random.Generator] = None,
    precision: str = "f64",
    defer: bool = False,
    hunt_stages: int = 1,
    I0=(),
    J0=(),
    device=None,
):
    """Adaptive rook rrLU of a device-resident matrix, queued without a
    read of a device value (``tci_tpu``'s ``rrlu_rook_device_fused``).

    A numpy A goes to `device` (the card by default; ``device="cpu"`` for
    the CPU), a tensor stays where it lies. The start set has the full slab
    width: `maxrank` distinct columns (leftorthogonal) or rows, the caller's
    J0 (I0) first and random ones after, drawn on the host from `rng` as
    ``tci_tpu`` draws them. That collapses the reference's widen-and-retry
    loop (matrixlu.jl:512-548) into one round, so `maxrank` is also the
    slab width: callers with no real rank cap start near the expected rank
    and call again wider on a rank-capped result, as the TCI2 device tier
    does.

    precision="mixed" (float64 input): the slab eliminations run on a
    float32 copy (scaled by a power of two to keep it in range) and the
    float64 factors are rebuilt from the pivot sets (``_assemble_mixed``);
    `hunt_stages` > 1 adds deflated re-hunts of the rescaled f64 residual.
    Complex input runs the plain path in complex128. defer=True returns a
    ``_PendingRRLU`` whose ``result()`` makes the one fetch; otherwise a
    ``DeviceRRLU``. ``nslabs`` counts the slab eliminations that did work,
    as ``tci_tpu`` counts them."""
    if rng is None:
        rng = np.random.default_rng()
    A = _as_matrix(A, device)
    m, n = A.shape
    dev = A.device
    maxrank = int(min(maxrank, m, n))
    Rb = bucket(maxrank)
    if precision not in ("f64", "mixed"):
        raise ValueError(
            f"precision must be 'f64' or 'mixed', got {precision!r}")
    if precision == "mixed" and A.is_complex():
        raise ValueError(
            "precision='mixed' requires a real float64 matrix (complex "
            "inputs run at full precision; f32 inputs pass through the "
            "plain-precision path)")
    mixed = precision == "mixed" and A.dtype == torch.float64
    hunt_stages = int(hunt_stages)
    if hunt_stages < 1:
        raise ValueError("hunt_stages must be >= 1")
    if hunt_stages > 1 and not mixed:
        raise ValueError(
            "hunt_stages > 1 is the deflated f32 hunt: it requires "
            "precision='mixed' on an f64 matrix (the f64 path hunts at "
            "full precision already)")

    # the start sets: the caller's continuation (J0 for leftorthogonal,
    # whose first move eliminates the column slab A[:, J0] and replaces I0,
    # else I0) first, then random distinct indices up to the slab width;
    # one more random pair for each extra deflated hunt stage
    def widened_start(seed_idx, limit):
        seed = list(dict.fromkeys(int(i) for i in seed_idx))[:maxrank]
        if len(seed) < maxrank:
            pool = np.setdiff1d(np.arange(limit, dtype=np.int64),
                                np.asarray(seed, dtype=np.int64),
                                assume_unique=True)
            extra = rng.choice(pool, size=maxrank - len(seed), replace=False)
            seed = np.concatenate([np.asarray(seed, dtype=np.int64), extra])
        return np.asarray(seed, dtype=np.int64)

    nstage = hunt_stages if mixed else 1
    ipack = np.zeros((3 + 2 * nstage * Rb,), dtype=np.int64)
    ipack[2] = maxrank
    for s in range(nstage):
        if leftorthogonal:
            ipack[1] = maxrank  # J0len
            lo = 3 + (2 * s + 1) * Rb
            ipack[lo:lo + maxrank] = (
                widened_start(J0, n) if s == 0
                else rng.choice(n, size=maxrank, replace=False))
        else:
            ipack[0] = maxrank  # I0len
            lo = 3 + 2 * s * Rb
            ipack[lo:lo + maxrank] = (
                widened_start(I0, m) if s == 0
                else rng.choice(m, size=maxrank, replace=False))
    ip = to_device(ipack, dev)
    I0len, J0len, cap = ip[0], ip[1], ip[2]

    def starts(s):
        return ip[3 + 2 * s * Rb:3 + (2 * s + 1) * Rb], ip[
            3 + (2 * s + 1) * Rb:3 + (2 * s + 2) * Rb]

    f64 = torch.float64
    rt = torch.tensor(float(reltol), dtype=f64, device=dev)
    at = torch.tensor(float(abstol), dtype=f64, device=dev)
    kw = {"Rb": Rb, "numrookiter": numrookiter,
          "leftorthogonal": leftorthogonal}

    if mixed:
        # the dynamic-range guard: the whole computation runs on A scaled by
        # a power of two (exact in f64) that brings max|A| near 1, so the
        # f32 copy neither overflows nor flushes, with abstol in the scaled
        # units; the exponent is clamped to the normal f64 range
        smax0 = A.abs().amax()
        pos = smax0 > 0
        scale0 = torch.where(pos, torch.exp2(torch.clamp(torch.round(
            torch.log2(torch.where(pos, smax0, 1.0))), -1022.0, 1023.0)), 1.0)
        A64 = A / scale0
        at_s = at / scale0
        I0s, J0s = starts(0)
        LUp, rp, cp, kf, err, newI, newJ, nslabs = _alternation(
            A64.to(torch.float32), I0s, I0len, J0s, J0len, cap, rt, at_s,
            **kw)
        err = err.to(f64)

        def unscale(L_nat, U_nat):
            # the unit-diagonal factor is scale-free, the other carries it
            if leftorthogonal:
                return L_nat, U_nat * scale0
            return L_nat * scale0, U_nat

        C = Rb * hunt_stages  # the candidate capacity (factor width)
        if hunt_stages == 1:
            L_nat, U_nat, keff, rejerr, Ire, Jre = _assemble_mixed(
                A64, newI, _fit_to(cp, Rb), kf, rt, at_s,
                unit_lower=leftorthogonal)
            kcomb, errfin = kf, err
        else:
            jj = torch.arange(C, device=dev)
            Icomb = _fit_to(newI, C)
            Jcomb = _fit_to(_fit_to(cp, Rb), C)
            kcomb, errfin = kf, err
            for s in range(1, hunt_stages):
                # complete the pivots trusted so far in f64, deflate, mask
                # the covered rows and columns to exact zero, rescale the
                # residual to O(1) and hunt it again in f32
                L1, U1, keff1, _, Icomb, Jcomb = _assemble_mixed(
                    A64, Icomb, Jcomb, kcomb, rt, at_s,
                    unit_lower=leftorthogonal, maxrank=cap)
                Rres = A64 - L1 @ U1
                vmask = jj < keff1
                rowmask = torch.ones(m + 1, dtype=f64, device=dev)
                rowmask[torch.where(vmask, Icomb, m)] = 0.0
                colmask = torch.ones(n + 1, dtype=f64, device=dev)
                colmask[torch.where(vmask, Jcomb, n)] = 0.0
                Rres = Rres * rowmask[:m, None] * colmask[None, :n]
                smax = Rres.abs().amax()
                scale = torch.where(smax > 0, smax, 1.0)
                I0x, J0x = starts(s)
                _, _, cp2, kf2, err2, newI2, _, nslabs2 = _alternation(
                    (Rres / scale).to(torch.float32), I0x, I0len, J0x,
                    J0len, cap, rt, at_s / scale, **kw)
                # the stage's candidates right after the keff1 trusted ones
                i2e = _fit_to(newI2, C)
                j2e = _fit_to(_fit_to(cp2, Rb), C)
                tail = torch.clamp(jj - keff1, 0, C - 1)
                Icomb = torch.where(jj < keff1, Icomb, i2e[tail])
                Jcomb = torch.where(jj < keff1, Jcomb, j2e[tail])
                kcomb = torch.minimum(keff1 + kf2, torch.tensor(C, device=dev))
                nslabs = nslabs + nslabs2
                errfin = err2.to(f64) * scale
            L_nat, U_nat, keff, rejerr, Ire, Jre = _assemble_mixed(
                A64, Icomb, Jcomb, kcomb, rt, at_s,
                unit_lower=leftorthogonal, maxrank=cap)
        L_nat, U_nat = unscale(L_nat, U_nat)
        # one record for the host: scalars, then the pivot row and column
        # ids in the f64 completion's elimination order
        pack = torch.cat([
            torch.stack([keff.to(f64), rejerr.to(f64) * scale0,
                         kcomb.to(f64), errfin.to(f64) * scale0,
                         nslabs.to(f64)]),
            Ire.to(f64), Jre.to(f64)])

        def finish_mixed() -> DeviceRRLU:
            pk = fetch(pack, "rook")
            keff_h, kf_h = int(pk[0]), int(pk[2])
            err_h = float(pk[1]) if keff_h < kf_h else float(pk[3])
            k = keff_h
            rowperm = _perm_from(pk[5:5 + C].astype(np.int64)[:k], m)
            colperm = _perm_from(pk[5 + C:].astype(np.int64)[:k], n)
            err_fin = 0.0 if k >= min(m, n) else err_h
            Lk, Uk = L_nat, U_nat
            if k < C:  # trim the zero-padded factor columns / rows
                Lk, Uk = L_nat[:, :k], U_nat[:k, :]
            return DeviceRRLU(Lk, Uk, rowperm, colperm, k, err_fin,
                              leftorthogonal, nslabs=int(pk[4]))

        return _PendingRRLU(finish_mixed) if defer else finish_mixed()

    I0s, J0s = starts(0)
    LUp, rp, cp, kdev, errdev, I0f, J0f, nslabsdev = _alternation(
        A, I0s, I0len, J0s, J0len, cap, rt, at, **kw)
    pack = torch.cat([torch.stack([kdev.to(f64), errdev.to(f64),
                                   nslabsdev.to(f64)]),
                      cp[:n].to(f64), I0f.to(f64)])

    def finish_plain() -> DeviceRRLU:
        pk = fetch(pack, "rook")
        k, err, nslabs = int(pk[0]), float(pk[1]), int(pk[2])
        colperm = pk[3:3 + n].astype(np.int64)
        rowperm = _perm_from(pk[3 + n:3 + n + k].astype(np.int64), m)
        err_fin = 0.0 if k >= min(m, n) else err
        # the final slab was the row slab A[I0f, :], which spans all
        # columns: U is its U, L is completed over the other rows
        L_nat, U_nat = _assemble_cols_branch(
            A, LUp, to_device(colperm[:k], dev), to_device(rowperm[k:], dev),
            to_device(np.argsort(rowperm), dev),
            to_device(np.argsort(colperm), dev), k, leftorthogonal)
        return DeviceRRLU(L_nat, U_nat, rowperm, colperm, k, err_fin,
                          leftorthogonal, nslabs=nslabs)

    return _PendingRRLU(finish_plain) if defer else finish_plain()


def rrlu_rook_device(
    A,
    I0=(),
    J0=(),
    maxrank: int = _INTMAX,
    reltol: float = 1e-14,
    abstol: float = 0.0,
    leftorthogonal: bool = True,
    numrookiter: int = 5,
    rng: Optional[np.random.Generator] = None,
    materialize: str = "host",
    device=None,
):
    """Adaptive rook rrLU of a device-resident matrix, driven from the host
    (``tci_tpu``'s ``rrlu_rook_device``: ``arrlu``'s control flow,
    matrixlu.jl:492-569, with every O(m k) slab on the device and one fetch
    of its pivots a slab).

    materialize="host" returns the package's rrLU (pivot-order factors on
    the device, host permutations), "device" a ``DeviceRRLU``."""
    if materialize not in ("host", "device"):
        raise ValueError(
            f"materialize must be 'host' or 'device', got {materialize!r}")
    if rng is None:
        rng = np.random.default_rng()
    A = _as_matrix(A, device)
    dev = A.device
    m, n = A.shape
    maxrank = min(maxrank, m, n)

    I0 = [int(i) for i in I0]
    J0 = [int(j) for j in J0]
    islowrank = False
    out = None
    last_full_rows = False
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
                sel, mt, nt = rows_l, len(rows_l), n
            else:
                rows_l, cols_l = list(range(m)), list(J0)
                last_full_rows = True
                sel, mt, nt = cols_l, m, len(cols_l)
            idx = np.zeros(bucket(len(sel)), dtype=np.int64)
            idx[:len(sel)] = sel
            LUp, rp, cp, k, mags, err = _slab_lu(
                A, to_device(idx, dev), len(sel), maxrank, reltol, abstol,
                leftorthogonal=leftorthogonal, rows_slab=colmove)
            rec = fetch(torch.cat([rp[:mt].to(torch.float64),
                                   cp[:nt].to(torch.float64),
                                   k.to(torch.float64)[None],
                                   err.to(torch.float64)[None]]), "rook")
            rp_h = rec[:mt].astype(np.int64)
            cp_h = rec[mt:mt + nt].astype(np.int64)
            k, err = int(rec[-2]), float(rec[-1])
            islowrank |= k < min(mt, nt)
            newI = [rows_l[i] for i in rp_h[:k]]
            newJ = [cols_l[j] for j in cp_h[:k]]
            out = (LUp, rp_h, cp_h, k, err, rows_l, cols_l, mt, nt)
            if newI == I0 and newJ == J0:
                break
            I0, J0 = newI, newJ
        if islowrank or len(I0) >= maxrank:
            break

    assert out is not None
    LUp, rp, cp, k, err, rows_l, cols_l, mt, nt = out
    if last_full_rows:
        # L covers all rows (permuted); U is completed over the other columns
        rowperm = np.array([rows_l[i] for i in rp], dtype=np.int64)
        J0s = set(J0)
        colperm = np.array(J0 + [j for j in range(n) if j not in J0s],
                           dtype=np.int64)
    else:
        colperm = np.array([cols_l[j] for j in cp], dtype=np.int64)
        I0s = set(I0)
        rowperm = np.array(I0 + [i for i in range(m) if i not in I0s],
                           dtype=np.int64)

    def dev_idx(a):
        return to_device(np.asarray(a, dtype=np.int64), dev)

    if materialize == "device":
        err_fin = 0.0 if k >= min(mt, nt) else err
        inv = (dev_idx(np.argsort(rowperm)), dev_idx(np.argsort(colperm)))
        if last_full_rows:
            L_nat, U_nat = _assemble_rows_branch(
                A, LUp, dev_idx(rowperm[:k]), dev_idx(colperm[k:]), *inv, k,
                leftorthogonal)
        else:
            L_nat, U_nat = _assemble_cols_branch(
                A, LUp, dev_idx(colperm[:k]), dev_idx(rowperm[k:]), *inv, k,
                leftorthogonal)
        return DeviceRRLU(L_nat, U_nat, rowperm, colperm, k, err_fin,
                          leftorthogonal)

    # the factors of the last slab (the port's _finalize trims the
    # triangles), then the missing side
    LU = LUp[:mt, :nt]
    diag = torch.diagonal(LU)[:k].cpu().numpy()
    nan = torch.isnan(LU)
    r = min(mt, nt)
    flags = (bool(torch.tril(nan)[:, :r][:, :k].any()),
             bool(torch.triu(nan)[:r, :][:k].any()))
    lu_slab = _finalize(LU, rp, cp, k, err, leftorthogonal, diag, flags)
    if last_full_rows:
        L = lu_slab.L
        U = lu_slab.U[:k, :k]
        if len(colperm) > k:
            U2 = _complete_factor(A, dev_idx(rowperm[:k]),
                                  dev_idx(colperm[k:]), lu_slab.L[:k, :k],
                                  transpose_solve=False)
            U = torch.cat([U, U2], dim=1)
    else:
        U = lu_slab.U
        L = lu_slab.L[:k, :k]
        if len(rowperm) > k:
            L2 = _complete_factor(A, dev_idx(colperm[:k]),
                                  dev_idx(rowperm[k:]), lu_slab.U[:k, :k],
                                  transpose_solve=True)
            L = torch.cat([L, L2], dim=0)
    return rrLU(rowperm, colperm, L, U, leftorthogonal, k, lu_slab.error,
                lu_slab.diag())
