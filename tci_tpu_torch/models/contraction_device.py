"""Tensor-train contraction on the device: zip-up and naive, and the lazy
product as a batched device function.

Counterpart of ``tci_tpu/models/contraction_device.py`` (reference:
src/contraction.jl:616-637 and :751-788). Every bond split is one launch
of the rrLU kernel (``_lu_split`` -> ``ops/lu_kernel.rrlu_panel``) on the
panel's exact extents, and the contractions around it are ``torch.einsum``
/ ``torch.matmul`` on the same device. Rank is data, not shape: each bond
is padded to a static cap computed on the host from the shapes, the rank
of each split stays a device tensor, and the columns and rows past it are
zeroed, so a whole contraction is queued with no read of the device
between bonds. One fetch at the end brings back the ranks
(``utils.device.fetch``, counted in ``FETCHES["contract_zipup"]`` /
``FETCHES["contract_naive"]``); the cores stay on the device and are cut
to the ranks there.

Complex operands run natively in complex128 (``tci_tpu`` carries them as
(re, im) float64 pairs); real ones in float64. ``make_product_evaluator``
gives ``contract_TCI`` the product as a function of an (N, L) index
tensor, for a ``TorchBatchEvaluator``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops.lu_kernel import rrlu_panel
from ..utils.device import fetch
from .tensortrain import TensorTrain

_INTMAX = 2**62


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet (ROADMAP A14)")


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the device tiers compute in: complex128 for complex
    operands, float64 for real ones (the rrLU kernel's types, as
    ``tci_tpu`` computes in float64)."""
    return torch.complex128 if dtype.is_complex else torch.float64


def _operands(A: TensorTrain, B: TensorTrain):
    """The two trains' cores on A's device in the work dtype, and the
    result dtype."""
    if len(A) != len(B):
        raise ValueError("Cannot contract tensor trains with different length.")
    dev = A[0].device
    dtype = torch.promote_types(A[0].dtype, B[0].dtype)
    wdt = _work_dtype(dtype)
    return ([t.to(dev, wdt) for t in A], [t.to(dev, wdt) for t in B],
            dtype)


def _panel(Cm: torch.Tensor) -> torch.Tensor:
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


def _lu_split(Cm: torch.Tensor, m_true: int, n_true: int, reltol: float,
              abstol: float, *, cap: int, leftorthogonal: bool):
    """Split Cm ≈ left · right by one rank-revealing LU on Cm's device: the
    rrLU kernel on a CUDA tensor, its plain version on the CPU
    (``rrlu_panel``). The host ``rrlu`` left()/right() convention
    (ops/lu.py): with leftorthogonal, L has the unit diagonal and U carries
    the pivots; otherwise L carries them and U has the unit diagonal.
    Columns of L and rows of U past the rank are zeroed. Returns (left
    (m, cap), right (cap, n), k), k a 0-d int64 tensor on the device; the
    extents and tolerances are host numbers, so nothing is read back."""
    m, n = Cm.shape
    maxrank = min(m, n, cap)
    A_sw, rowperm, colperm, kk, _, _ = rrlu_panel(
        _panel(Cm), m_true, n_true, maxrank, reltol, abstol,
        leftorthogonal=leftorthogonal)
    A_sw, rowperm, colperm = A_sw[:m, :n], rowperm[:m], colperm[:n]
    rmax = min(m, n)
    keep = torch.arange(rmax, device=Cm.device) < kk
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


def _zip_step(R, a, b, reltol: float, cap: int, last: bool):
    """One zip-up bond: C = R·A[n]·B[n], then the rank-revealing LU split.

    R: (P, La, Lb) with rows past the previous rank zeroed; a: (La, i, K,
    Ra); b: (Lb, K, j, Rb). Returns (site (P, i, j, cap), newR (cap, Ra,
    Rb), rank tensor); for the last site the unsplit core. The split is
    ``_lu_split`` with leftorthogonal=False (L carries the pivots, U the
    unit diagonal), as the host zip-up's ``factorize("LU")``."""
    C = torch.einsum("pab,aikr,bkjs->pijrs", R, a, b)
    P, i, j, Ra, Rb = C.shape
    if last:
        return C.reshape(P, i, j, Ra * Rb), None, None
    m, n = P * i * j, Ra * Rb
    left, right, kk = _lu_split(C.reshape(m, n), m, n, reltol, 0.0,
                                cap=cap, leftorthogonal=False)
    return left.reshape(P, i, j, cap), right.reshape(cap, Ra, Rb), kk


def _unpad(cores: Sequence[torch.Tensor], ranks: Sequence[int],
           dtype: torch.dtype) -> List[torch.Tensor]:
    """The padded cores cut to the ranks, as cores of their own in `dtype`.
    ``ranks[b]`` is the rank of bond b (between sites b and b + 1); a rank
    of 0 keeps one (zeroed) row and column, as ``tci_tpu`` does."""
    L = len(cores)
    ranks = [max(1, r) for r in ranks]
    out = []
    for n, t in enumerate(cores):
        lo = 1 if n == 0 else ranks[n - 1]
        hi = 1 if n == L - 1 else ranks[n]
        out.append(t[:lo, ..., :hi].to(dtype, copy=True))
    return out


def _fetch_ranks(kks: Sequence[torch.Tensor], tier: str) -> List[int]:
    """The ranks of a whole chain in one device-to-host transfer."""
    return [int(k) for k in fetch(torch.stack(list(kks)), tier)]


def contract_zipup_device(
    A: TensorTrain,
    B: TensorTrain,
    tolerance: float = 1e-12,
    maxbonddim: int = _INTMAX,
    mesh=None,
) -> TensorTrain:
    """Zip-up contraction of two 4-leg tensor trains on their device.

    The host ``contract_zipup(A, B, method="LU")``'s truncation rule
    (reltol=tolerance, abstol=0, maxrank=maxbonddim) at every bond, with
    the einsum and the split of every bond queued on the device and one
    fetch of the ranks at the end. Returns a TensorTrain on A's device."""
    _no_mesh(mesh)
    ajs, bjs, dtype = _operands(A, B)
    L = len(ajs)
    caps = []
    P = 1
    for n in range(L - 1):
        m = P * ajs[n].shape[1] * bjs[n].shape[2]
        nn = ajs[n].shape[3] * bjs[n].shape[3]
        caps.append(int(min(maxbonddim, m, nn)))
        P = caps[-1]
    sites, kks = [], []
    R = torch.ones((1, 1, 1), dtype=ajs[0].dtype, device=ajs[0].device)
    for n in range(L):
        last = n == L - 1
        site, R, kk = _zip_step(R, ajs[n], bjs[n], float(tolerance),
                                cap=1 if last else caps[n], last=last)
        sites.append(site)
        if not last:
            kks.append(kk)
    ranks = _fetch_ranks(kks, "contract_zipup") if kks else []
    return TensorTrain(_unpad(sites, ranks, dtype))


def _merge_sites(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kronecker site merge (reference contraction.jl:591-602):
    (la, i, k, ra) x (lb, k, j, rb) -> (la*lb, i, j, ra*rb)."""
    la, i, _, ra = a.shape
    lb, _, j, rb = b.shape
    ab = torch.einsum("aikr,bkjs->abijrs", a, b)
    return ab.reshape(la * lb, i, j, ra * rb)


def _two_pass(cores: List[torch.Tensor], reltol: float, abstol: float,
              mbd: int):
    """L→R exact orthogonalization (reltol = abstol = 0: it stops only at an
    exactly zero pivot), then R→L truncation (reference
    tensortrain.jl:302-348), every split one ``_lu_split``. Returns the
    padded cores and the rank tensors of the truncating splits, from the
    last bond to the first."""
    L = len(cores)
    tt = list(cores)
    for ell in range(L - 1):
        sh = tt[ell].shape
        m, n = int(np.prod(sh[:-1])), int(sh[-1])
        cap = min(m, n)
        left, right, _ = _lu_split(tt[ell].reshape(m, n), m, n, 0.0, 0.0,
                                   cap=cap, leftorthogonal=True)
        tt[ell] = left.reshape(*sh[:-1], cap)
        shr = tt[ell + 1].shape
        nxt = right @ tt[ell + 1].reshape(shr[0], int(np.prod(shr[1:])))
        tt[ell + 1] = nxt.reshape(cap, *shr[1:])

    kks = []
    for ell in range(L - 1, 0, -1):
        sh = tt[ell].shape
        m, n = int(sh[0]), int(np.prod(sh[1:]))
        cap = int(min(m, n, mbd))
        left, right, kk = _lu_split(tt[ell].reshape(m, n), m, n, reltol,
                                    abstol, cap=cap, leftorthogonal=False)
        tt[ell] = right.reshape(cap, *sh[1:])
        shl = tt[ell - 1].shape
        nxt = tt[ell - 1].reshape(int(np.prod(shl[:-1])), shl[-1]) @ left
        tt[ell - 1] = nxt.reshape(*shl[:-1], cap)
        kks.append(kk)
    return tt, kks


def contract_naive_device(
    A: TensorTrain,
    B: TensorTrain,
    tolerance: float = 0.0,
    maxbonddim: int = _INTMAX,
    mesh=None,
) -> TensorTrain:
    """Naive contraction with every einsum and split on the trains' device.

    The host ``contract_naive`` (reference contraction.jl:616-637) with the
    LU truncation rule in place of SVD: the sitewise Kronecker merges, then
    (when tolerance > 0 or maxbonddim is set) the two-pass compression,
    each bond one launch of the rrLU kernel, with one fetch of the ranks at
    the end. Returns a TensorTrain on A's device."""
    _no_mesh(mesh)
    ajs, bjs, dtype = _operands(A, B)
    L = len(ajs)
    tt = [_merge_sites(ajs[n], bjs[n]) for n in range(L)]
    if not (tolerance > 0 or maxbonddim < _INTMAX):
        return TensorTrain([t.to(dtype) for t in tt])
    mbd = int(min(maxbonddim, 2**31 - 1))
    tt, kks = _two_pass(tt, float(tolerance), 0.0, mbd)
    ranks = _fetch_ranks(kks, "contract_naive")[::-1]
    return TensorTrain(_unpad(tt, ranks, dtype))


# ---------------------------------------------------------------------------
# The lazy product as a device function: contract_TCI's TorchBatchEvaluator
# ---------------------------------------------------------------------------


def make_product_evaluator(A: TensorTrain, B: TensorTrain, f=None,
                           pair=None):
    """The MPO-MPO product as a batched device function.

    Counterpart of the Contraction environment caches (reference:
    src/contraction.jl:279-406): the product at a batch of fused
    multi-indices is a loop over the L sites of (N, ra, rb) transfer
    matrices, each site's (ra × k × ra) and (rb × k × rb) slices gathered
    by index and contracted by ``torch.bmm``, as ``models/tteval.py``
    evaluates a train. It launches a fixed sequence of kernels whose
    shapes depend on N alone and reads nothing back, so the engine can
    record it into its CUDA graphs; the core stacks it closes over live as
    long as the function.

    Returns (f, localdims, dtype, pair): f maps an (N, L) int64 tensor of
    C-order fused indices (idx = i * d2 + j) on the trains' device to (N,)
    values there; `f` (optional) is a torch elementwise post-map applied to
    them (contraction.jl:131-147). `pair` is always False: complex runs in
    complex128, and ``pair=True`` (``tci_tpu``'s (re, im) representation)
    raises."""
    if pair:
        raise ValueError(
            "pair=True: the (re, im) pair representation is not ported; "
            "complex operands run natively in complex128 (leave pair unset)")
    L = len(A)
    if len(B) != L:
        raise ValueError("Cannot contract tensor trains with different length.")
    for n in range(L):
        if A[n].dim() != 4 or B[n].dim() != 4:
            raise ValueError("Contraction requires 4-leg tensor trains.")
        if A[n].shape[2] != B[n].shape[1]:
            raise ValueError(
                f"Tensor trains must share the identical index at n={n}!")
    dev = A[0].device
    dtype = torch.promote_types(A[0].dtype, B[0].dtype)
    ra = max(max(t.shape[0], t.shape[3]) for t in A)
    rb = max(max(t.shape[0], t.shape[3]) for t in B)
    kmax = max(t.shape[2] for t in A)
    d1 = max(t.shape[1] for t in A)
    d2 = max(t.shape[2] for t in B)
    # per site, the cores with the physical leg first, so that a gather by
    # index picks each sample's (ra, k, ra) / (rb, k, rb) slice
    a_stack = torch.zeros((L, d1, ra, kmax, ra), dtype=dtype, device=dev)
    b_stack = torch.zeros((L, d2, rb, kmax, rb), dtype=dtype, device=dev)
    for n in range(L):
        ta, tb = A[n], B[n].to(dev)
        a_stack[n, :ta.shape[1], :ta.shape[0], :ta.shape[2], :ta.shape[3]] = \
            ta.permute(1, 0, 2, 3)
        b_stack[n, :tb.shape[2], :tb.shape[0], :tb.shape[1], :tb.shape[3]] = \
            tb.permute(2, 0, 1, 3)
    d2s = torch.tensor([B[n].shape[2] for n in range(L)], dtype=torch.int64,
                       device=dev)
    localdims = [int(A[n].shape[1] * B[n].shape[2]) for n in range(L)]

    def product(idx: torch.Tensor) -> torch.Tensor:
        i, j = idx // d2s, idx % d2s
        N = idx.shape[0]
        # v: (N, ra, rb), the left environment of every sample
        v = torch.zeros((N, ra, rb), dtype=dtype, device=dev)
        v[:, 0, 0] = 1.0
        for n in range(L):
            Ai = a_stack[n][i[:, n]]  # (N, ra, k, ra)
            Bj = b_stack[n][j[:, n]]  # (N, rb, k, rb)
            # t[b, k, c] = Σ_a v[a, b] Ai[a, k, c]
            t = torch.bmm(v.transpose(1, 2), Ai.reshape(N, ra, kmax * ra))
            # v'[c, d] = Σ_{b, k} t[b, k, c] Bj[b, k, d]
            t = t.reshape(N, rb * kmax, ra).transpose(1, 2)
            v = torch.bmm(t, Bj.reshape(N, rb * kmax, rb))
        res = v[:, 0, 0]
        return f(res) if f is not None else res

    return product, localdims, dtype, False
