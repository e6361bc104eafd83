"""Fused bond update: Π sampling, rank-revealing LU and CI factors on the
device, one fetch a bond.

Counterpart of ``tci_tpu/ops/fused.py`` (its non-pair parts). TCI's two-site
update (tensorci2.jl:825-930) samples the Π panel, factorizes it and extracts
the left/right CI factors. For a ``TorchBatchEvaluator`` all three run on
its device as a stream of launches: the panel never leaves the card, the
rrLU kernel factorizes it, and the factor algebra (triangular solves and
permutation scatters, matrixluci.jl:194-241) handles the dynamic rank by
masking instead of dynamic shapes. Only the pivot record comes back, in one
fetch; the factors stay on the device as site tensors. PyTorch runs
eagerly, so ``tci_tpu``'s jitted programs become plain functions here.

For an f without the private panel entry (``_tci_panel``) a panel is an
int64 index matrix of m n rows, which f reads. ``sample_panel`` forms it in
chunks of rows of at most ``INDEX_CHUNK_BYTES`` bytes and calls f on each
in turn, so that a large panel (3072² at capacity 1024 and d = 2, L = 20:
1.51 GB of indices) holds one chunk at a time; a panel that fits is one
call, as before. ``INDEX_BYTES`` counts the index matrices formed for f.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..utils import trace
from ..utils.device import fetch, resolve_device, to_device, torch_dtype
from .lu_kernel import bucket, rrlu_panel, rrlu_panel_batched

# The most bytes of index matrix formed for one call of f: 2^28, 256 MiB,
# a sixth of a 3072² panel at L = 20; every cell's panels below capacity
# 256 fit in one.
INDEX_CHUNK_BYTES = 1 << 28

# Bytes of the int64 index matrices formed for f ("formed"; "traced": those
# formed while a profiler records), counted where they are formed and, for
# a CUDA graph that formed them, at each replay: while a stream captures
# they go to "captured", and the graph's owner reports its share at each
# replay (``count_index_replay``), as ``lu_cuda`` counts the rrLU kernel.
INDEX_BYTES: Counter = Counter()
# Bonds the per-bond fused tier updated ("bonds"; "traced": while a
# profiler records)
FUSED_BONDS: Counter = Counter()


def count_index_replay(nbytes: int) -> None:
    """`nbytes` of index matrices were formed, by a launch queued now or by
    the replay of a graph that holds their forming."""
    INDEX_BYTES["formed"] += nbytes
    if trace.enabled():
        INDEX_BYTES["traced"] += nbytes


def indexed(f: Callable, idx: torch.Tensor) -> torch.Tensor:
    """f on the index matrix `idx`, whose bytes are counted in
    ``INDEX_BYTES``."""
    nbytes = idx.numel() * idx.element_size()
    if idx.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        INDEX_BYTES["captured"] += nbytes
    else:
        count_index_replay(nbytes)
    return f(idx)


def chunk_rows(rows: int, row_bytes: int) -> int:
    """How many of `rows` rows of `row_bytes` bytes of index one call of f
    takes: all that fit in ``INDEX_CHUNK_BYTES``, at least one."""
    return max(1, min(rows, INDEX_CHUNK_BYTES // max(row_bytes, 1)))


def panel_indices(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The (... m n, nl + nr) int64 index matrix of the panel of index rows
    (..., m, nl) and columns (..., n, nr): row i n + j is [rows_i, cols_j]."""
    *batch, m, nl = rows.shape
    n, nr = cols.shape[-2:]
    idx = torch.empty((*batch, m, n, nl + nr), dtype=torch.int64,
                      device=rows.device)
    idx[..., :nl] = rows.unsqueeze(-2)
    idx[..., nl:] = cols.unsqueeze(-3)
    return idx.reshape(-1, nl + nr)


def sample_panel(f: Callable, rows: torch.Tensor, cols: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The panel f([rows_i, cols_j]) for index rows (..., m, nl) and columns
    (..., n, nr), int64 on f's device, shape (..., m, n). Where f has the
    private panel entry point ``f._tci_panel(rows, cols)`` (the m n values
    in that order; only ``integrate``'s GK integrand defines it, and
    ``TorchBatchEvaluator`` passes it on) a single panel goes to it and no
    index matrix is formed; otherwise f is called on the assembled index
    matrix (``panel_indices``), once where it fits in ``INDEX_CHUNK_BYTES``
    and else once for each chunk of rows (``chunk_rows``), whose values are
    joined in the panel's order."""
    *batch, m, nl = rows.shape
    n, nr = cols.shape[-2:]
    panel = getattr(f, "_tci_panel", None)
    if panel is not None and not batch:
        return panel(rows, cols).reshape(m, n).to(dtype)
    step = chunk_rows(m, int(np.prod(batch, dtype=np.int64)) * n * (nl + nr)
                      * 8)
    if step == m:
        return indexed(f, panel_indices(rows, cols)).reshape(
            *batch, m, n).to(dtype)
    parts = [indexed(f, panel_indices(rows[..., s:s + step, :], cols))
             .reshape(*batch, -1, n) for s in range(0, m, step)]
    return torch.cat(parts, dim=-2).to(dtype)


def ci_factors(A: torch.Tensor, rowperm: torch.Tensor, colperm: torch.Tensor,
               k, leftorthogonal: bool):
    """CI factors from a padded in-place LU (device side).

    Mirrors matrixluci.jl:194-283 with the rank k (an int or a 0-d device
    tensor) handled by masking: the k x k pivot block of the triangular
    solve is padded to identity so the solve stays benign; columns/rows
    beyond k of the outputs are garbage and the caller slices them away.
    Returns (left (mp, rmax), right (rmax, np)) in ORIGINAL row/column
    order."""
    mp, npd = A.shape
    rmax = min(mp, npd)
    ridx = torch.arange(rmax, device=A.device)
    eye = torch.eye(rmax, dtype=A.dtype, device=A.device)
    inblock = (ridx[:, None] < k) & (ridx[None, :] < k)
    if leftorthogonal:
        L_all = torch.tril(A[:, :rmax])
        L_all.diagonal().fill_(1.0)
        U_all = torch.triu(A[:rmax, :])
        Lb = L_all[:rmax]
        M = torch.where(inblock, Lb, eye)
        X = torch.linalg.solve_triangular(M, L_all, upper=False, left=False)
        left = torch.zeros_like(X).index_copy_(0, rowperm, X)
        R = Lb @ U_all
        right = torch.zeros_like(R).index_copy_(1, colperm, R)
    else:
        U_all = torch.triu(A[:rmax, :])
        U_all.diagonal().fill_(1.0)
        L_all = torch.tril(A[:, :rmax])
        Ub = U_all[:, :rmax]
        M = torch.where(inblock, Ub, eye)
        X = torch.linalg.solve_triangular(M, U_all, upper=True)
        right = torch.zeros_like(X).index_copy_(1, colperm, X)
        C = L_all @ Ub
        left = torch.zeros_like(C).index_copy_(0, rowperm, C)
    return left, right


def panel_solve_pinv(Pi1: torch.Tensor, P: torch.Tensor,
                     n_ip: torch.Tensor) -> torch.Tensor:
    """T = Π₁ · P^{-1} for B panels on their device: Pi1 (B, r, n), P
    (B, n, n) padded to identity outside its true n_ip x n_ip block, n_ip
    (B,) on P's device. One complete-pivot rrLU launch factorizes all B
    P blocks (reltol = abstol = 0, maxrank = n_ip), then two batched
    triangular solves; nothing is read back to the host."""
    B, n, _ = P.shape
    A, rowperm, colperm, _, _, _ = rrlu_panel_batched(
        P, n_ip, n_ip, n_ip, 0.0, 0.0, leftorthogonal=True)
    ridx = torch.arange(n, device=P.device)
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    pad = ridx[None, :] >= n_ip[:, None]
    padm = pad[:, :, None] | pad[:, None, :]
    L = torch.tril(A)
    L.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    L = torch.where(padm, eye, L)
    U = torch.where(padm, eye, torch.triu(A))
    r = Pi1.shape[1]
    Qp = torch.gather(Pi1, 2, colperm[:, None, :].expand(B, r, n))
    Y = torch.linalg.solve_triangular(U, Qp, upper=True, left=False)
    Y = torch.linalg.solve_triangular(L, Y, upper=False, left=False)
    return torch.zeros_like(Y).scatter_(
        2, rowperm[:, None, :].expand(B, r, n), Y)


def pad_index_panels(Ic: np.ndarray, Jc: np.ndarray, mI: int = None,
                     mJ: int = None
                     ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Pad (nI, nl) / (nJ, nr) int panels to bucketed row counts, or to mI /
    mJ rows when given (zero rows; the fused update masks them out of the
    Π panel)."""
    nI, nJ = Ic.shape[0], Jc.shape[0]
    mI = bucket(nI) if mI is None else mI
    mJ = bucket(nJ) if mJ is None else mJ
    if mI != nI:
        Ic = np.vstack([Ic, np.zeros((mI - nI, Ic.shape[1]), Ic.dtype)])
    if mJ != nJ:
        Jc = np.vstack([Jc, np.zeros((mJ - nJ, Jc.shape[1]), Jc.dtype)])
    return Ic, Jc, nI, nJ


def _capacity(n: int, floor: int = 128) -> int:
    """The sampler's capacity quantum: bucket(n), at least `floor`."""
    return bucket(max(int(n), int(floor), 1))


class PanelSampler:
    """The Π panel f(Icombined x Jcombined) on the device, for the per-bond
    device rook tier (``tci_tpu``'s ``make_panel_sampler`` and
    ``PanelSampler``): one call of f, the padded rows and columns masked to
    zero, and the panel handed to the rook rrLU where it lies. The padded
    extents grow monotonically in bucket steps of at least 128, and
    ``nevals`` counts the padded panel, as ``tci_tpu`` counts it. `f` maps
    an (N, L) int64 tensor on `device` to (N,) values."""

    def __init__(self, f: Callable, dtype=torch.float64, device=None):
        self.f = f
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        self._row_cap = 0
        self._col_cap = 0
        self.nevals = 0

    def sample(self, Icombined, Jcombined):
        """(the (nI, nJ) panel on the device, max |sample| as a float)."""
        Ic, Jc = _index_rows(Icombined), _index_rows(Jcombined)
        self._row_cap = max(self._row_cap, _capacity(Ic.shape[0]))
        self._col_cap = max(self._col_cap, _capacity(Jc.shape[0]))
        Ic, Jc, nI, nJ = pad_index_panels(Ic, Jc, self._row_cap,
                                          self._col_cap)
        self.nevals += Ic.shape[0] * Jc.shape[0]
        dev = self.device
        Pi = sample_panel(self.f, to_device(Ic, dev), to_device(Jc, dev),
                          self.dtype)
        valid = ((torch.arange(Ic.shape[0], device=dev)[:, None] < nI)
                 & (torch.arange(Jc.shape[0], device=dev)[None, :] < nJ))
        Pi = torch.where(valid, Pi, 0)
        maxsample = fetch(Pi.abs().amax().to(torch.float64)[None], "rook")
        return Pi[:nI, :nJ], float(maxsample[0])


def _index_rows(indexset, width: Optional[int] = None) -> np.ndarray:
    rows = np.asarray([tuple(i) for i in indexset], dtype=np.int64)
    return rows.reshape(len(indexset), -1 if width is None else width)


class FusedSiteTensors:
    """Site tensor T = Π₁ · P^{-1} on the device (tensorci2.jl:599-629):
    both panels sampled by `f` and solved where they lie; T stays there
    (see TensorCI2.setsitetensor_from_f). `f` maps an (N, L) int64 tensor
    on `device` to (N,) values."""

    def __init__(self, f: Callable, dtype=torch.float64, device=None):
        self.f = f
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        self.nevals = 0
        self.rrlu_calls = 0

    def compute(self, Iset_b, localdim: int, Jset_b, Iset_b1):
        """T_b from Iset[b], d_b, Jset[b], Iset[b+1]: the (|Iset[b]|, d_b,
        |Iset[b+1]|) device tensor and the max |sample| as a 0-d device
        tensor (no fetch)."""
        Is = _index_rows([tuple(i) + (s,) for i in Iset_b
                          for s in range(localdim)])
        Js, Ip = _index_rows(Jset_b), _index_rows(Iset_b1)
        n_is, n_js, n_ip = Is.shape[0], Js.shape[0], Ip.shape[0]
        if n_ip != n_js:
            raise ValueError("Pivot matrix is not square!")
        Is, Js, _, _ = pad_index_panels(Is, Js)
        Ip, _, _, _ = pad_index_panels(Ip, Js)
        mI, mJ, mP = Is.shape[0], Js.shape[0], Ip.shape[0]
        self.nevals += mI * mJ + mP * mJ
        dev = self.device
        Is, Js, Ip = (to_device(a, dev) for a in (Is, Js, Ip))
        Pi1 = sample_panel(self.f, Is, Js, self.dtype)
        P = sample_panel(self.f, Ip, Js, self.dtype)
        cols = torch.arange(mJ, device=dev)[None, :] < n_js
        mask1 = (torch.arange(mI, device=dev)[:, None] < n_is) & cols
        maskP = (torch.arange(mP, device=dev)[:, None] < n_ip) & cols
        maxsample = torch.maximum(torch.where(mask1, Pi1, 0).abs().amax(),
                                  torch.where(maskP, P, 0).abs().amax())
        # pad P to identity outside the true block: the padded block passes
        # through the elimination untouched and the solves stay benign
        P = torch.where(maskP, P, torch.eye(mP, mJ, dtype=P.dtype, device=dev))
        n_ip_dev = torch.full((1,), n_ip, dtype=torch.int64, device=dev)
        T = panel_solve_pinv(Pi1[None], P[None], n_ip_dev)[0]
        self.rrlu_calls += 1
        return (T[:n_is, :n_ip].reshape(len(Iset_b), localdim, len(Iset_b1)),
                maxsample)


class FusedBondUpdater:
    """The fused bond update for one integrand (``make_fused_bond_update``'s
    program and ``tci_tpu``'s ``FusedBondUpdater`` in one).

    Attached to ``TorchBatchEvaluator``; ``TensorCI2.updatepivots`` calls
    ``update(Icombined, Jcombined, ...)``: one rrLU launch and one fetch of
    the pivot record a bond; the factors stay on the device."""

    def __init__(self, f: Callable, dtype=torch.float64, device=None):
        self.f = f
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        self.nevals = 0
        self.rrlu_calls = 0

    def _fused(self, Ic, Jc, nI: int, nJ: int, maxrank: int, reltol: float,
               abstol: float, leftorthogonal: bool, need_factors: bool):
        """Sample the padded panel, mask it to the true (nI, nJ) block,
        factorize it with the rrLU kernel and, if asked, form the CI
        factors; all on the device, nothing read back."""
        dev = self.device
        Pi = sample_panel(self.f, Ic, Jc, self.dtype)
        valid = ((torch.arange(Ic.shape[0], device=dev)[:, None] < nI)
                 & (torch.arange(Jc.shape[0], device=dev)[None, :] < nJ))
        Pi = torch.where(valid, Pi, 0)
        maxsample = Pi.abs().amax()
        A, rowperm, colperm, k, mags, err = rrlu_panel(
            Pi, nI, nJ, maxrank, reltol, abstol, leftorthogonal=leftorthogonal)
        self.rrlu_calls += 1
        factors = (ci_factors(A, rowperm, colperm, k, leftorthogonal)
                   if need_factors else None)
        return factors, rowperm, colperm, k, mags, err, maxsample

    def update(self, Icombined, Jcombined, reltol: float, abstol: float,
               maxrank: int, leftorthogonal: bool, need_factors: bool = True):
        """Run the fused bond update. Returns (left (nI, k), right (k, nJ),
        row pivots, column pivots, pivot errors, err, max |sample|): the
        factors as device tensors (None with need_factors=False, when
        non-strict-nesting sweeps discard them), the rest on the host from
        one fetch. Counted in ``FUSED_BONDS``; the span ``tci.fused.bond``
        holds it while a profiler records."""
        FUSED_BONDS["bonds"] += 1
        if trace.enabled():
            FUSED_BONDS["traced"] += 1
        with trace.span("tci.fused.bond"):
            return self._update(Icombined, Jcombined, reltol, abstol,
                                maxrank, leftorthogonal, need_factors)

    def _update(self, Icombined, Jcombined, reltol, abstol, maxrank,
                leftorthogonal, need_factors):
        Ic, Jc, nI, nJ = pad_index_panels(_index_rows(Icombined),
                                          _index_rows(Jcombined))
        mI, mJ = Ic.shape[0], Jc.shape[0]
        self.nevals += mI * mJ
        maxrank = min(maxrank, nI, nJ)
        factors, rowperm, colperm, k, mags, err, maxsample = self._fused(
            to_device(Ic, self.device), to_device(Jc, self.device), nI, nJ,
            maxrank, reltol, abstol, leftorthogonal, need_factors)
        f64 = torch.float64
        rec = fetch(torch.cat([
            rowperm.to(f64), colperm.to(f64), k.to(f64)[None], mags.to(f64),
            err.to(f64)[None], maxsample.to(f64)[None]]), "fused_bond")
        k = int(rec[mI + mJ])
        rowind = rec[:k].astype(np.int64)
        colind = rec[mI:mI + k].astype(np.int64)
        mags = rec[mI + mJ + 1:mI + mJ + 1 + k]
        err_final = 0.0 if k >= min(nI, nJ) else float(rec[-2])
        left = right = None
        if need_factors:
            left, right = factors[0][:nI, :k], factors[1][:k, :nJ]
        return (left, right, rowind, colind,
                np.concatenate([np.abs(mags), [err_final]]), err_final,
                float(rec[-1]))
