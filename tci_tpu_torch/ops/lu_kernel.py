"""Complete-pivot rank-revealing LU elimination on zero-padded panels.

Counterpart of ``tci_tpu/ops/lu_kernel.py``. The elimination itself is the
hand-written CUDA kernel ``csrc/rrlu.cu`` (wrapped by ``ops/lu_cuda.py``);
this module holds its plain PyTorch version (``rrlu_plain``), which runs
every panel that lies on the CPU and is what the kernel is checked against;
``rrlu_panel`` / ``rrlu_panel_batched``, the one place that picks the
kernel or the plain version by the panel's device; and the host-facing
``rrlu_raw`` that puts a matrix on its device (the card unless the caller
asks for the CPU), pads it to its shape bucket, runs the elimination there
and brings back the pivots.

The plain version is one swap-free body for all sizes (the contract of
``tci_tpu``'s ``_rrlu_while``, written after ``_rrlu_state_fused``): the
pivot column has the largest cached per-column max |a|^2, ties to the
smallest swapped position; the pivot row has the largest |a|^2 in that
column, ties likewise; the loop stops by the rule of matrixlu.jl:363. The
Schur update is written as a multiply followed by a subtract, which is how
the kernel rounds, and touches only the unpivoted rows and columns of the
true extents, as the kernel does, so the two agree bitwise.

NaN: a NaN metric ranks above every value (``jnp.argmax``'s rule, which
``tci_tpu``'s ``_rrlu_state_small`` follows), so the first NaN in the
swapped column-major order becomes the pivot and the NaN reaches the
factors, where ``rrlu``'s check raises. The pivot is then always a valid
row and column, so no swap moves a line outside the true extents.

Panels are float32, float64 or complex128. For complex128 the metric
|a|^2 = re re + im im, the magnitudes, err and the tolerances are real, and
the products and quotients are written out on the real and imaginary parts
(``_cmul``, ``_cdiv``: the kernel's formulas), not left to torch's complex
operators, whose rounding differs between devices and from the kernel's.
"""

from __future__ import annotations

from collections import Counter
from typing import Union

import numpy as np
import torch

from ..utils.device import resolve_device, to_device
from . import lu_cuda

# Calls of the plain version, by the device type of the panel. The main path
# on a GPU must leave the "cuda" count at 0.
PLAIN_CALLS: Counter = Counter()

_BIG = 1 << 30


def bucket(n: int) -> int:
    """Round `n` up to a padded extent; at most ~4 buckets per octave."""
    if n <= 8:
        return 8
    step = 1 << max(3, n.bit_length() - 3)
    return ((n + step - 1) // step) * step


def _abs2(A: torch.Tensor) -> torch.Tensor:
    """|a|^2 elementwise, real: re re + im im for a complex tensor."""
    if A.is_complex():
        return A.real * A.real + A.imag * A.imag
    return A * A


def _cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b for complex tensors (broadcast): (ac - bd) + (ad + bc) i, one
    rounding an operation, as the kernel multiplies."""
    return torch.complex(a.real * b.real - a.imag * b.imag,
                         a.real * b.imag + a.imag * b.real)


def _cdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b for complex tensors by Smith's formula, as the kernel divides:
    with r = d / c when |c| >= |d| (b = c + d i), else r = c / d."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    big = br.abs() >= bi.abs()
    r = torch.where(big, bi / br, br / bi)
    den = torch.where(big, br + bi * r, br * r + bi)
    re = torch.where(big, ar + ai * r, ar * r + ai)
    im = torch.where(big, ai - ar * r, ai * r - ar)
    return torch.complex(re / den, im / den)


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cmul(a, b) if a.is_complex() else a * b


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cdiv(a, b) if a.is_complex() else a / b


def _first(metric: torch.Tensor, top: torch.Tensor, valid: torch.Tensor,
           pos: torch.Tensor) -> int:
    """Smallest position among the valid entries that equal `top`, the
    metric's maximum; a NaN maximum is matched by the NaN entries."""
    hit = metric.isnan() if bool(top.isnan()) else metric == top
    return int(torch.where(hit & valid, pos, _BIG).min())


def rrlu_plain(A: torch.Tensor, m_true: int, n_true: int, maxrank: int,
               reltol: float, abstol: float, *, leftorthogonal: bool):
    """Plain PyTorch elimination of one zero-padded (mp, np) panel.

    Returns (A_sw, rowperm, colperm, k, mags, err) as tensors on A's device:
    the LU buffer in the swapped layout, the permutations (position ->
    original index, int64), the number of pivots, the pivot magnitudes
    (length min(mp, np), zero past k) and the magnitude of the first
    rejected pivot (NaN when maxrank is 0). Tolerances are compared in A's
    real dtype, and the sizes clamped to the panel, as the kernel does; the
    magnitudes and err are in A's real dtype.
    """
    PLAIN_CALLS[A.device.type] += 1
    mp, npd = A.shape
    dev, dt, rdt = A.device, A.dtype, A.dtype.to_real()
    m = min(max(int(m_true), 0), mp)
    n = min(max(int(n_true), 0), npd)
    maxrank = min(max(int(maxrank), 0), min(mp, npd))
    A = A.clone()
    rows = torch.arange(mp, device=dev)
    cols = torch.arange(npd, device=dev)
    rowperm, colperm = rows.clone(), cols.clone()
    rowpos, colpos = rows.clone(), cols.clone()
    rt = torch.tensor(reltol, dtype=rdt, device=dev)
    at = torch.tensor(abstol, dtype=rdt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    rzero = torch.zeros((), dtype=rdt, device=dev)
    neg1 = -torch.ones((), dtype=rdt, device=dev)
    mags = torch.zeros(min(mp, npd), dtype=rdt, device=dev)
    maxerror = rzero
    err = torch.full((), float("nan"), dtype=rdt, device=dev)
    colmax = torch.where((rows < m)[:, None], _abs2(A), neg1).amax(0)
    k = 0
    while k < maxrank:
        validc = (colpos >= k) & (cols < n)
        cm = torch.where(validc, colmax, neg1)
        M = cm.max()
        if bool(M < 0):
            # no valid column left: stop with err 0, as the TPU kernel does
            err = rzero
            break
        # the positions are clamped as tci_tpu clamps them (lu_kernel.py:95)
        bestcolpos = min(_first(cm, M, validc, colpos), npd - 1)
        pc = int(colperm[bestcolpos])

        validr = (rowpos >= k) & (rows < m)
        acol = A[:, pc]
        met = torch.where(validr, _abs2(acol), neg1)
        Mr = met.max()
        bestrowpos = min(_first(met, Mr, validr, rowpos), mp - 1)
        pr = int(rowperm[bestrowpos])
        newerr = torch.sqrt(torch.clamp(Mr, min=0))

        stop = k > 0 and (bool(newerr < rt * maxerror) or bool(newerr < at))
        stop = stop or bool(Mr < 0) or (k > 0 and bool(newerr == 0))
        err = newerr
        if stop:
            break

        # virtual swaps: position k <-> best positions
        r_at_k = int(rowperm[k])
        rowperm[bestrowpos] = r_at_k
        rowperm[k] = pr
        rowpos[r_at_k] = bestrowpos
        rowpos[pr] = k
        c_at_k = int(colperm[k])
        colperm[bestcolpos] = c_at_k
        colperm[k] = pc
        colpos[c_at_k] = bestcolpos
        colpos[pc] = k

        piv = A[pr, pc]
        safe = torch.where(piv != 0, piv, one)
        urow = (rowpos >= k + 1) & (rows < m)
        ucol = (colpos >= k + 1) & (cols < n)
        if leftorthogonal:
            x = _div(A[:, pc], safe)
            y = A[pr, :]
        else:
            x = A[:, pc]
            y = _div(A[pr, :], safe)
        Anew = torch.where(urow[:, None] & ucol[None, :],
                           A - _mul(x[:, None], y[None, :]), A)
        # the multipliers: pivot column when left-orthogonal, else pivot row
        if leftorthogonal:
            Anew[:, pc] = torch.where(urow, x, Anew[:, pc])
        else:
            Anew[pr, :] = torch.where(ucol, y, Anew[pr, :])
        A = Anew
        colmax = torch.where(urow[:, None], _abs2(A), neg1).amax(0)
        mags[k] = newerr
        maxerror = torch.maximum(maxerror, newerr)
        k += 1
    A_sw = A[rowperm][:, colperm]
    return (A_sw, rowperm, colperm,
            torch.tensor(k, dtype=torch.int64, device=dev), mags, err)


def rrlu_plain_batched(A: torch.Tensor, m_true, n_true, maxrank, reltol,
                       abstol, *, leftorthogonal: bool):
    """``rrlu_plain`` over B panels of (B, mp, np), with per-panel (B,)
    sizes, rank caps and tolerances (or scalars for all panels)."""
    B = A.shape[0]

    def per_panel(v):
        v = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
        return np.broadcast_to(v, (B,))

    m_true, n_true, maxrank, reltol, abstol = map(
        per_panel, (m_true, n_true, maxrank, reltol, abstol))
    outs = [
        rrlu_plain(A[b], int(m_true[b]), int(n_true[b]), int(maxrank[b]),
                   float(reltol[b]), float(abstol[b]),
                   leftorthogonal=leftorthogonal)
        for b in range(B)
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def rrlu_panel(A: torch.Tensor, m_true, n_true, maxrank, reltol, abstol, *,
               leftorthogonal: bool):
    """Eliminate one zero-padded panel where it lies: a CPU tensor runs the
    plain version, any other goes to the CUDA kernel (which raises for
    what it does not take). Extents that do not fit the panel raise a
    ValueError on either path. Returns the 6-tuple of ``rrlu_plain``."""
    if A.device.type != "cpu":
        return lu_cuda.rrlu_call(A, m_true, n_true, maxrank, reltol, abstol,
                                 leftorthogonal=leftorthogonal)
    lu_cuda.check_extents(*A.shape, m_true, n_true, maxrank)
    return rrlu_plain(A, m_true, n_true, maxrank, reltol, abstol,
                      leftorthogonal=leftorthogonal)


def rrlu_panel_batched(A: torch.Tensor, m_true, n_true, maxrank, reltol,
                       abstol, *, leftorthogonal: bool):
    """``rrlu_panel`` for B panels of (B, mp, np), with per-panel (B,)
    sizes, rank caps and tolerances (or scalars for all panels). Sizes and
    tolerances may be tensors on A's device; on a CUDA device nothing is
    read back to the host, and the kernel clamps sizes to the panel. Sizes
    given on the host (ints, CPU tensors) that do not fit raise a
    ValueError."""
    if A.device.type != "cpu":
        return lu_cuda.rrlu_batched(A, m_true, n_true, maxrank, reltol,
                                    abstol, leftorthogonal=leftorthogonal)
    lu_cuda.check_extents(*A.shape[1:], m_true, n_true, maxrank)
    return rrlu_plain_batched(A, m_true, n_true, maxrank, reltol, abstol,
                              leftorthogonal=leftorthogonal)


def rrlu_raw(
    A: Union[np.ndarray, torch.Tensor],
    maxrank: int,
    reltol: float,
    abstol: float,
    leftorthogonal: bool,
    device=None,
):
    """Eliminate a concrete matrix on its device.

    A numpy array is uploaded to `device` (``utils.device.resolve_device``:
    the current CUDA device by default, and a RuntimeError without one
    unless ``device="cpu"`` is given). A tensor stays where the caller put
    it, unless `device` is given. A CUDA panel runs the kernel, a CPU panel
    the plain version. A real matrix is eliminated in float64, a complex one
    in complex128 (complex64 is promoted, as ``tci_tpu`` promotes it).
    Returns (LUmat (m, n) tensor on that device, rowperm (m,), colperm (n,),
    npivot, diag (npivot,), err, nan_in_factors): the permutations, the LU
    diagonal (complex for a complex matrix) and the NaN flags of the L and U
    factors come back to the host in ONE transfer, the LU buffer stays on
    the device.
    """
    if not isinstance(A, torch.Tensor):
        A = to_device(np.asarray(A), resolve_device(device))
    elif device is not None:
        A = A.to(resolve_device(device))
    m, n = A.shape
    dt = torch.complex128 if A.is_complex() else torch.float64
    if m == 0 or n == 0:
        return (A.to(dt), np.arange(m), np.arange(n), 0,
                np.zeros((0,), dtype=np.complex128 if dt.is_complex
                         else np.float64),
                float("nan"), (False, False))
    mp, npd = bucket(m), bucket(n)
    maxrank = min(int(maxrank), m, n)
    Ap = torch.zeros((mp, npd), dtype=dt, device=A.device)
    Ap[:m, :n] = A
    return fetch_result(*rrlu_panel(Ap, m, n, maxrank, reltol, abstol,
                                    leftorthogonal=leftorthogonal), m, n)


def fetch_result(A_sw, rowperm, colperm, k, mags, err, m: int, n: int):
    """``rrlu_raw``'s result from an elimination's 6-tuple on a padded
    panel whose true extents are (m, n): the LU buffer cut to (m, n) stays
    on the device; the permutations, npivot, err, the LU diagonal and the
    NaN flags of the factors come to the host in one transfer."""
    LU = A_sw[:m, :n]
    r = min(m, n)
    # NaN in column j of tril(LU) / row i of triu(LU): the L and U factors
    # hold NaN iff one of their first k columns / rows does.
    nan = torch.isnan(LU)
    colnan = torch.tril(nan)[:, :r].any(0)
    rownan = torch.triu(nan)[:r, :].any(1)
    # a complex diagonal travels as its real and imaginary halves
    diag = torch.diagonal(LU)
    parts = (diag.real, diag.imag) if diag.is_complex() else (diag,)
    host = torch.cat([
        rowperm[:m].to(torch.float64), colperm[:n].to(torch.float64),
        k.to(torch.float64)[None], err.to(torch.float64)[None],
        colnan.to(torch.float64), rownan.to(torch.float64),
        *(p.to(torch.float64) for p in parts),
    ]).cpu().numpy()
    rp = host[:m].astype(np.int64)
    cp = host[m:m + n].astype(np.int64)
    k = int(host[m + n])
    err = float(host[m + n + 1])
    rest = host[m + n + 2:]
    flags = (bool(rest[:k].any()), bool(rest[r:r + k].any()))
    diag = rest[2 * r:2 * r + k]
    if len(parts) == 2:
        diag = diag.astype(np.complex128)
        diag.imag = rest[3 * r:3 * r + k]
    return LU, rp, cp, k, diag, err, flags


def submatrixargmax_colmajor(metric: np.ndarray):
    """First-occurrence argmax in column-major order over a 2-D metric array."""
    flat = np.asarray(metric).T.reshape(-1)
    p = int(np.argmax(flat))
    m = metric.shape[0]
    return p % m, p // m


def aligned_panel(Cm: torch.Tensor) -> torch.Tensor:
    """Cm as a panel the kernel takes: contiguous, starting on a 16-byte
    boundary and holding a multiple of 16 bytes (the resident mode's bulk
    copy; the cluster mode's too, which otherwise gives the panel to the
    grid mode). Where Cm is not, it is copied into a panel widened by zero
    columns past its true extents, which the elimination never reads."""
    Cm = Cm.contiguous()
    m, n = Cm.shape
    per = 16 // Cm.element_size()
    if Cm.data_ptr() % 16 == 0 and (m * n) % per == 0:
        return Cm
    P = torch.zeros((m, -(-n // per) * per), dtype=Cm.dtype,
                    device=Cm.device)
    P[:, :n] = Cm
    return P


def split_factors(A_sw, rowperm, colperm, kk, m: int, n: int, cap: int,
                  leftorthogonal: bool):
    """The factors of an elimination of an (m, n) panel (its 6-tuple's
    first four entries, on a panel padded past (m, n)): (left (m, cap),
    right (cap, n), kk) in the original row and column order, by the host
    ``rrlu`` left()/right() convention (ops/lu.py): with leftorthogonal, L
    has the unit diagonal and U carries the pivots; otherwise the reverse.
    Columns of L and rows of U past the rank kk (a device tensor) are
    zeroed; nothing is read back."""
    A_sw, rowperm, colperm = A_sw[:m, :n], rowperm[:m], colperm[:n]
    rmax = min(m, n)
    keep = torch.arange(rmax, device=A_sw.device) < kk
    L_all = torch.tril(A_sw[:, :rmax])
    U_all = torch.triu(A_sw[:rmax, :])
    (L_all if leftorthogonal else U_all).diagonal().fill_(1.0)
    L_all = torch.where(keep[None, :], L_all, 0.0)
    U_all = torch.where(keep[:, None], U_all, 0.0)
    # back to the original row and column order: row p of L is row
    # rowperm[p] of left, column q of U column colperm[q] of right
    left = torch.zeros_like(L_all).index_copy_(0, rowperm, L_all)[:, :cap]
    right = torch.zeros_like(U_all).index_copy_(1, colperm, U_all)[:cap, :]
    return left, right, kk
