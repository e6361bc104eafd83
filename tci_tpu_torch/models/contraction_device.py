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
to the ranks there. Given a mesh (``parallel.mesh.default_mesh``), every
split's elimination is row-sharded over its ranks (``_split_for``) and the
result is the one-device tier's, bitwise.

Complex operands run natively in complex128 (``tci_tpu`` carries them as
(re, im) float64 pairs); real ones in float64. ``make_product_evaluator``
gives ``contract_TCI`` the product as a function of an (N, L) index
tensor, for a ``TorchBatchEvaluator``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops.lu_kernel import aligned_panel, rrlu_panel, split_factors
from ..ops.lu_sharded import make_lu_split_sharded
from ..utils.device import fetch
from .tensortrain import TensorTrain

_INTMAX = 2**62


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


def _lu_split(Cm: torch.Tensor, m_true: int, n_true: int, reltol: float,
              abstol: float, *, cap: int, leftorthogonal: bool):
    """Split Cm ≈ left · right by one rank-revealing LU on Cm's device: the
    rrLU kernel on a CUDA tensor, its plain version on the CPU
    (``rrlu_panel``), then ``lu_kernel.split_factors``: the host ``rrlu``
    left()/right() convention (ops/lu.py), with columns of L and rows of U
    past the rank zeroed. Returns (left (m, cap), right (cap, n), k), k a
    0-d int64 tensor on the device; the extents and tolerances are host
    numbers, so nothing is read back."""
    m, n = Cm.shape
    maxrank = min(m, n, cap)
    A_sw, rowperm, colperm, kk, _, _ = rrlu_panel(
        aligned_panel(Cm), m_true, n_true, maxrank, reltol, abstol,
        leftorthogonal=leftorthogonal)
    return split_factors(A_sw, rowperm, colperm, kk, m, n, cap,
                         leftorthogonal)


def _split_for(mesh, m: int, n: int, cap: int, leftorthogonal: bool):
    """The bond split of an (m, n) panel: ``_lu_split`` on one device, or
    given a mesh, ``ops/lu_sharded.make_lu_split_sharded`` (the elimination
    row-sharded over the mesh, its pivot order the one-device kernel's
    bitwise). Only the elimination runs sharded: the panel is replicated
    going in and the factored panel coming out, so the products around the
    split compute as on one device and the cores are the device tier's,
    bitwise (``tci_tpu``'s bit-parity rule)."""
    if mesh is None:
        def split(Cm, m_true, n_true, reltol, abstol):
            return _lu_split(Cm, m_true, n_true, reltol, abstol, cap=cap,
                             leftorthogonal=leftorthogonal)

        return split
    return make_lu_split_sharded(mesh, m, n, cap, leftorthogonal)


def _zip_step(R, a, b, reltol: float, cap: int, last: bool, mesh=None):
    """One zip-up bond: C = R·A[n]·B[n], then the rank-revealing LU split.

    R: (P, La, Lb) with rows past the previous rank zeroed; a: (La, i, K,
    Ra); b: (Lb, K, j, Rb). Returns (site (P, i, j, cap), newR (cap, Ra,
    Rb), rank tensor); for the last site the unsplit core. The split is
    ``_lu_split`` with leftorthogonal=False (L carries the pivots, U the
    unit diagonal), as the host zip-up's ``factorize("LU")``; on `mesh`
    its sharded counterpart (``_split_for``)."""
    C = torch.einsum("pab,aikr,bkjs->pijrs", R, a, b)
    P, i, j, Ra, Rb = C.shape
    if last:
        return C.reshape(P, i, j, Ra * Rb), None, None
    m, n = P * i * j, Ra * Rb
    split = _split_for(mesh, m, n, cap, leftorthogonal=False)
    left, right, kk = split(C.reshape(m, n), m, n, reltol, 0.0)
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
    fetch of the ranks at the end. With `mesh` (a ``parallel.mesh``
    DeviceMesh; every rank calls with the same trains) each split's
    elimination is row-sharded over its ranks and the result is the
    one-device tier's, bitwise. Returns a TensorTrain on A's device."""
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
                                cap=1 if last else caps[n], last=last,
                                mesh=mesh)
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
              mbd: int, mesh=None):
    """L→R exact orthogonalization (reltol = abstol = 0: it stops only at an
    exactly zero pivot), then R→L truncation (reference
    tensortrain.jl:302-348), every split one ``_split_for(mesh, ...)``.
    Returns the padded cores and the rank tensors of the truncating splits,
    from the last bond to the first."""
    L = len(cores)
    tt = list(cores)
    for ell in range(L - 1):
        sh = tt[ell].shape
        m, n = int(np.prod(sh[:-1])), int(sh[-1])
        cap = min(m, n)
        split = _split_for(mesh, m, n, cap, leftorthogonal=True)
        left, right, _ = split(tt[ell].reshape(m, n), m, n, 0.0, 0.0)
        tt[ell] = left.reshape(*sh[:-1], cap)
        shr = tt[ell + 1].shape
        nxt = right @ tt[ell + 1].reshape(shr[0], int(np.prod(shr[1:])))
        tt[ell + 1] = nxt.reshape(cap, *shr[1:])

    kks = []
    for ell in range(L - 1, 0, -1):
        sh = tt[ell].shape
        m, n = int(sh[0]), int(np.prod(sh[1:]))
        cap = int(min(m, n, mbd))
        split = _split_for(mesh, m, n, cap, leftorthogonal=False)
        left, right, kk = split(tt[ell].reshape(m, n), m, n, reltol, abstol)
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
    each bond one launch of the rrLU kernel (row-sharded over `mesh` when
    given, as in ``contract_zipup_device``), with one fetch of the ranks
    at the end. Returns a TensorTrain on A's device."""
    ajs, bjs, dtype = _operands(A, B)
    L = len(ajs)
    tt = [_merge_sites(ajs[n], bjs[n]) for n in range(L)]
    if not (tolerance > 0 or maxbonddim < _INTMAX):
        return TensorTrain([t.to(dtype) for t in tt])
    mbd = int(min(maxbonddim, 2**31 - 1))
    tt, kks = _two_pass(tt, float(tolerance), 0.0, mbd, mesh=mesh)
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
