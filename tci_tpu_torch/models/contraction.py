"""MPO x MPO / MPO x MPS contraction by the TCI, naive and zip-up algorithms.

Counterpart of ``tci_tpu/models/contraction.py`` (parity reference:
src/contraction.jl). ``Contraction`` is a lazy BatchEvaluator over the
product of two 4-leg trains with memoized left/right environments, on the
trains' device; ``contract_TCI`` re-enters ``crossinterpolate2`` with it
(or, with ``torch_native=True``, with a ``TorchBatchEvaluator`` over the
product as a batched device function, so TCI2 runs on the engine);
``contract_naive`` merges the sites by Kronecker products and recompresses
by SVD; ``contract_zipup`` streams left to right, factorizing as it goes.
With ``torch_native=True`` naive and zip-up run their device tiers
(``models/contraction_device.py``): every bond split one launch of the
rrLU kernel, one fetch a call.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.factorize import factorize
from ..parallel.batcheval import (BatchEvaluator, TorchBatchEvaluator,
                                  _infer_ncent)
from ..utils.device import numpy_dtype
from ..utils.util import optfirstpivot, projector_to_slice
from .contraction_device import (_no_mesh, contract_naive_device,
                                 contract_zipup_device,
                                 make_product_evaluator)
from .tensorci2 import crossinterpolate2
from .tensortrain import TensorTrain

MultiIndex = Tuple[int, ...]

_INTMAX = 2**62


def _common(*ts: torch.Tensor) -> List[torch.Tensor]:
    """The tensors in their common dtype (numpy's tensordot promotes,
    torch's does not)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _contract(a: torch.Tensor, b: torch.Tensor, idx_a: Tuple[int, ...],
              idx_b: Tuple[int, ...]) -> torch.Tensor:
    """General pairwise tensor contraction (contraction.jl:193-215)."""
    return torch.tensordot(*_common(a, b), dims=(list(idx_a), list(idx_b)))


class Contraction(BatchEvaluator):
    """Lazy product of two MPOs (contraction.jl:60-152), evaluated on the
    trains' device; a single evaluation returns a Python scalar, a batch
    a tensor there. `f` is an elementwise post-map, applied to tensors."""

    def __init__(self, a: TensorTrain, b: TensorTrain, f=None):
        if len(a) != len(b):
            raise ValueError("Tensor trains must have the same length.")
        for n in range(len(a)):
            if a[n].dim() != 4 or b[n].dim() != 4:
                raise ValueError("Contraction requires 4-leg tensor trains.")
            if a[n].shape[2] != b[n].shape[1]:
                raise ValueError(
                    f"Tensor trains must share the identical index at n={n}!"
                )
        tdtype = torch.promote_types(a[0].dtype, b[0].dtype)
        dev = a[0].device
        self.mpo = (TensorTrain([t.to(dev, tdtype) for t in a]),
                    TensorTrain([t.to(dev, tdtype) for t in b]))
        self.leftcache: Dict[Tuple, torch.Tensor] = {}
        self.rightcache: Dict[Tuple, torch.Tensor] = {}
        self.f = f
        self._sitedims = [
            [a[n].shape[1], b[n].shape[2]] for n in range(len(a))
        ]
        self._tdtype = tdtype
        self.device = dev
        self.dtype = numpy_dtype(tdtype).type

    def __len__(self) -> int:
        return len(self.mpo[0])

    def sitedims(self) -> List[List[int]]:
        return self._sitedims

    def __getitem__(self, i):
        return self.mpo[0][i]

    def __repr__(self):
        return (
            f"Contraction of tensor trains with ranks "
            f"{self.mpo[0].rank()} and {self.mpo[1].rank()}"
        )

    def _localdims(self, n: int) -> Tuple[int, int]:
        return (self.mpo[0][n].shape[1], self.mpo[1][n].shape[2])

    def _unfuse_idx(self, n: int, idx: int) -> Tuple[int, int]:
        # C-order fusion (last leg fastest), consistent with reshapes of
        # (chi, d1, d2, chi) site tensors throughout this package
        d2 = self._localdims(n)[1]
        return (idx // d2, idx % d2)

    def _ones(self) -> torch.Tensor:
        return torch.ones((1, 1), dtype=self._tdtype, device=self.device)

    # -- environments (contraction.jl:279-354) ------------------------------

    def evaluateleft(self, indexset: Sequence[Tuple[int, int]]
                     ) -> torch.Tensor:
        if len(indexset) >= len(self.mpo[0]):
            raise ValueError(f"Invalid indexset: {indexset}")
        a, b = self.mpo
        if len(indexset) == 0:
            return self._ones()
        ell = len(indexset)
        if ell == 1:
            i, j = indexset[0]
            return a[0][0, i, :, :].T @ b[0][0, :, j, :]
        key = tuple(indexset)
        hit = self.leftcache.get(key)
        if hit is None:
            i, j = indexset[-1]
            hit = _extend_cache(
                self.evaluateleft(key[:-1]), a[ell - 1], b[ell - 1], i, j
            )
            self.leftcache[key] = hit
        return hit

    def evaluateright(self, indexset: Sequence[Tuple[int, int]]
                      ) -> torch.Tensor:
        if len(indexset) >= len(self.mpo[0]):
            raise ValueError(f"Invalid indexset: {indexset}")
        a, b = self.mpo
        N = len(self)
        if len(indexset) == 0:
            return self._ones()
        if len(indexset) == 1:
            i, j = indexset[0]
            return a[N - 1][:, i, :, 0] @ b[N - 1][:, :, j, 0].T
        ell = N - len(indexset)
        key = tuple(indexset)
        hit = self.rightcache.get(key)
        if hit is None:
            i, j = indexset[0]
            hit = _extend_cache(
                self.evaluateright(key[1:]),
                a[ell].permute(3, 1, 2, 0),
                b[ell].permute(3, 1, 2, 0),
                i, j,
            )
            self.rightcache[key] = hit
        return hit

    # -- evaluation (contraction.jl:361-406) ---------------------------------

    def evaluate(self, indexset):
        if len(self) != len(indexset):
            raise ValueError(
                f"Length mismatch: {len(self)} != {len(indexset)}"
            )
        if len(indexset) and isinstance(indexset[0], (int, np.integer)):
            indexset = [
                self._unfuse_idx(n, int(idx)) for n, idx in enumerate(indexset)
            ]
        midpoint = len(self) // 2
        res = (self.evaluateleft(indexset[:midpoint])
               * self.evaluateright(indexset[midpoint:])).sum()
        if self.f is not None:
            res = self.f(res)
        return res.item()

    def evaluate_single(self, indexset):
        if len(indexset) and isinstance(indexset[0], (list, tuple)):
            indexset = [
                _lineari(self._sitedims[l], mi)
                for l, mi in enumerate(indexset)
            ]
        return self.evaluate(list(indexset))

    def __call__(self, *args):
        if len(args) == 1:
            return self.evaluate_single(args[0])
        return self.batch_evaluate(*args)

    def batch_evaluate(self, leftindexset, rightindexset, ncent=None,
                       projector=None) -> torch.Tensor:
        """(contraction.jl:483-575)"""
        N = len(self)
        localdims = [int(np.prod(d)) for d in self._sitedims]
        ncent = _infer_ncent(localdims, leftindexset, rightindexset, ncent)
        if len(leftindexset) * len(rightindexset) == 0:
            nl = len(leftindexset[0]) if leftindexset else 0
            return torch.zeros(
                (len(leftindexset),)
                + tuple(localdims[nl + i] for i in range(ncent))
                + (len(rightindexset),),
                dtype=self._tdtype, device=self.device,
            )
        Nr = len(rightindexset[0])
        s_ = len(leftindexset[0])  # first center site (0-based)
        e_ = N - Nr  # one-past-last center site
        a, b = self.mpo

        if projector is None:
            projector = [
                [0] * len(self._sitedims[n]) for n in range(s_, e_)
            ]
        if len(projector) != ncent:
            raise ValueError(
                f"Length mismatch: projector length must be {ncent}"
            )
        for n in range(s_, e_):
            p = projector[n - s_]
            if len(p) != 2:
                raise ValueError(f"Invalid projector at {n}: {p}")
            if not all(0 <= x <= d for x, d in zip(p, self._sitedims[n])):
                raise ValueError(f"Invalid projector: {p}")

        left_unfused = [
            [self._unfuse_idx(n, idx) for n, idx in enumerate(idxs)]
            for idxs in leftindexset
        ]
        right_unfused = [
            [self._unfuse_idx(N - Nr + n, idx) for n, idx in enumerate(idxs)]
            for idxs in rightindexset
        ]

        left_ = torch.stack([self.evaluateleft(idx) for idx in left_unfused])
        right_ = torch.stack([self.evaluateright(idx)
                              for idx in right_unfused], dim=-1)

        # sitewise contraction of the center legs
        leftobj = left_.reshape(*left_.shape, 1)  # (B, la, lb, 1)
        return_size_siteinds: List[int] = []
        for n in range(s_, e_):
            p = projector[n - s_]
            slices, _ = projector_to_slice(p)
            a_n = a[n][:, slices[0], :, :]
            if a_n.dim() == 3:
                a_n = a_n[:, None, :, :]
            b_n = b[n][:, :, slices[1], :]
            if b_n.dim() == 3:
                b_n = b_n[:, :, None, :]
            return_size_siteinds.append(a_n.shape[1] * b_n.shape[2])

            # leftobj: (B, la, lb, S); a_n: (la, i, k, ra); b_n: (lb, k, j, rb)
            tmp1 = torch.tensordot(leftobj, a_n, dims=([1], [0]))
            # tmp1: (B, lb, S, i, k, ra)
            tmp2 = torch.tensordot(tmp1, b_n, dims=([1, 4], [0, 1]))
            # tmp2: (B, S, i, ra, j, rb) -> (B, ra, rb, S, i, j)
            tmp3 = tmp2.permute(0, 3, 5, 1, 2, 4)
            leftobj = tmp3.reshape(*tmp3.shape[:3], -1)

        # (B, S, |J|)
        res = torch.tensordot(leftobj, right_, dims=([1, 2], [0, 1]))
        if self.f is not None:
            res = self.f(res)
        return res.reshape(
            len(leftindexset), *return_size_siteinds, len(rightindexset)
        )


def _extend_cache(oldcache: torch.Tensor, a_ell: torch.Tensor,
                  b_ell: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """(contraction.jl:253-259)"""
    # (la, lb) x (la, k, ra) -> (lb, k, ra)
    tmp1 = torch.tensordot(oldcache, a_ell[:, i, :, :], dims=([0], [0]))
    # (lb, k, ra) x (lb, k, rb) -> (ra, rb)
    return torch.tensordot(tmp1, b_ell[:, :, j, :], dims=([0, 1], [0, 1]))


def _lineari(dims: Sequence[int], mi: Sequence[int]) -> int:
    """Multi-index -> fused linear index in C order (last leg fastest; the
    Julia reference uses column-major, contraction.jl:413-417 — this package
    uses row-major, as its reshapes do)."""
    return int(np.ravel_multi_index(tuple(int(m) for m in mi), tuple(dims)))


def lineari(sitedims: Sequence[Sequence[int]],
            indexset: Sequence[Sequence[int]]) -> List[int]:
    return [_lineari(sitedims[l], mi) for l, mi in enumerate(indexset)]


def _contractsitetensors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(contraction.jl:591-602)"""
    # (la, s1, ra, lb, s3, rb)
    ab = torch.tensordot(*_common(a, b.to(a.device)), dims=([2], [1]))
    abp = ab.permute(0, 3, 1, 4, 2, 5)
    return abp.reshape(
        a.shape[0] * b.shape[0], a.shape[1], b.shape[2],
        a.shape[3] * b.shape[3],
    )


def contract_naive(
    a: TensorTrain, b: TensorTrain, f=None,
    tolerance: float = 0.0, maxbonddim: int = _INTMAX,
    torch_native: bool = False, mesh=None,
) -> TensorTrain:
    """(contraction.jl:616-637)

    With ``torch_native=True`` the sitewise Kronecker merges and the
    two-pass LU compression are queued on the trains' device, each bond
    split one launch of the rrLU kernel
    (``models/contraction_device.contract_naive_device``)."""
    if f is not None:
        raise ValueError(
            "Naive contraction cannot apply an elementwise function. "
            "Use algorithm='TCI' instead."
        )
    _no_mesh(mesh)
    if torch_native:
        return contract_naive_device(a, b, tolerance=tolerance,
                                     maxbonddim=maxbonddim)
    if len(a) != len(b):
        raise ValueError("Cannot contract tensor trains with different length.")
    tt = TensorTrain(
        [_contractsitetensors(a[n], b[n]) for n in range(len(a))]
    )
    if tolerance > 0 or maxbonddim < _INTMAX:
        tt.compress("SVD", tolerance=tolerance, maxbonddim=maxbonddim)
    return tt


def _findinitialpivots(f, localdims, nmaxpivots,
                       rng: Optional[np.random.Generator] = None):
    """(contraction.jl:666-677)"""
    if rng is None:
        rng = np.random.default_rng()
    pivots = []
    for _ in range(nmaxpivots):
        pivot = [int(rng.integers(0, d)) for d in localdims]
        pivot = optfirstpivot(f, localdims, pivot)
        if abs(f(pivot)) == 0.0:
            continue
        pivots.append(tuple(pivot))
    return pivots


def contract_TCI(
    A: TensorTrain, B: TensorTrain,
    initialpivots=10, f=None,
    rng: Optional[np.random.Generator] = None,
    torch_native: bool = False, mesh=None,
    **kwargs,
) -> TensorTrain:
    """Fit the product with TCI2 (contraction.jl:692-732), on the trains'
    device.

    The initial pivots are searched on the host, one ``Contraction``
    evaluation at a time (``_findinitialpivots``, drawing from `rng`). With
    ``torch_native=True`` TCI2 samples the product through a
    ``TorchBatchEvaluator`` over ``make_product_evaluator``'s batched
    device function, so it runs the whole-sweep engine (and records the
    function into the engine's CUDA graphs); `f` must then be a torch
    elementwise function (or None). Otherwise it samples the
    ``Contraction`` (host tier). Other keyword arguments go to
    ``crossinterpolate2``.
    """
    _no_mesh(mesh)
    if len(A) != len(B):
        raise ValueError("Cannot contract tensor trains with different length.")
    if not all(A[i].shape[2] == B[i].shape[1] for i in range(len(A))):
        raise ValueError(
            "Cannot contract tensor trains with non-matching site dimensions."
        )
    matrixproduct = Contraction(A, B, f=f)
    localdims = [int(np.prod(d)) for d in matrixproduct.sitedims()]
    if torch_native:
        fdev, localdims, dtype, _ = make_product_evaluator(
            matrixproduct.mpo[0], matrixproduct.mpo[1], f=f)
        evaluator = TorchBatchEvaluator(fdev, localdims, dtype=dtype,
                                        device=matrixproduct.device)
    else:
        evaluator = matrixproduct
    if isinstance(initialpivots, int):
        initialpivots = _findinitialpivots(
            matrixproduct.evaluate_single, localdims, initialpivots, rng=rng
        )
        if not initialpivots:
            raise ValueError("No initial pivots found.")

    tci, ranks, errors = crossinterpolate2(
        matrixproduct.dtype, evaluator, localdims, initialpivots,
        device=matrixproduct.device, **kwargs
    )
    legdims = [matrixproduct._localdims(i) for i in range(len(tci))]
    return TensorTrain(
        [
            t.reshape(t.shape[0], *d, t.shape[-1])
            for t, d in zip(tci.sitetensors(), legdims)
        ]
    )


def contract_zipup(
    A: TensorTrain, B: TensorTrain,
    tolerance: float = 1e-12, method: str = "SVD",
    maxbonddim: int = _INTMAX,
    torch_native: bool = False, mesh=None,
) -> TensorTrain:
    """Streaming contract+factorize (contraction.jl:751-788), on A's device.

    With ``torch_native=True`` (method="LU") the whole chain of bonds is
    queued on the device, each split one launch of the rrLU kernel, with
    one fetch at the end (``models/contraction_device.py``).
    """
    _no_mesh(mesh)
    if torch_native:
        if method != "LU":
            raise ValueError(
                "torch_native zip-up uses rrLU truncation; pass method='LU'."
            )
        return contract_zipup_device(A, B, tolerance=tolerance,
                                     maxbonddim=maxbonddim)
    if len(A) != len(B):
        raise ValueError("Cannot contract tensor trains with different length.")
    dev = A[0].device
    R = torch.ones((1, 1, 1), dtype=torch.promote_types(A[0].dtype,
                                                        B[0].dtype),
                   device=dev)
    sitetensors: List[torch.Tensor] = [None] * len(A)
    for n in range(len(A)):
        R, a, b = _common(R, A[n], B[n].to(dev))
        # R: (l, la, lb); a: (la, i, k, ra) -> RA: (l, lb, i, k, ra)
        RA = torch.tensordot(R, a, dims=([1], [0]))
        # RA x b (lb, k, j, rb) -> (l, i, ra, j, rb) -> (l, i, j, ra, rb)
        C = torch.tensordot(RA, b, dims=([1, 3], [0, 1]))
        C = C.permute(0, 1, 3, 2, 4)
        if n == len(A) - 1:
            sitetensors[n] = C.reshape(*C.shape[:3], 1)
            break
        left, right, newbond = factorize(
            C.reshape(int(np.prod(C.shape[:3])), int(np.prod(C.shape[3:]))),
            method, tolerance=tolerance, maxbonddim=maxbonddim,
        )
        sitetensors[n] = left.reshape(*C.shape[:3], newbond)
        R = right.reshape(newbond, *C.shape[3:])
    return TensorTrain(sitetensors)


def _promote_mps_to_mpo(tt, side: str) -> TensorTrain:
    """Promote a 3-leg TT to 4 legs with a singleton leg on the given side."""
    tensors = []
    for t in tt.sitetensors():
        t3 = t.reshape(t.shape[0], -1, t.shape[-1])
        tensors.append(t3[:, None, :, :] if side == "up"
                       else t3[:, :, None, :])
    return TensorTrain(tensors)


def contract(
    A, B,
    algorithm: str = "TCI",
    tolerance: float = 1e-12,
    maxbonddim: int = _INTMAX,
    f=None,
    method: str = "SVD",
    torch_native: bool = False,
    mesh=None,
    **kwargs,
) -> TensorTrain:
    """Contract two tensor trains (contraction.jl:832-891) on A's device.

    4-leg x 4-leg gives a 4-leg MPO; a 3-leg operand (MPS) is promoted with a
    singleton leg and the result squeezed back to 3 legs. ``torch_native``
    selects the device tiers (see ``contract_TCI``, ``contract_naive``,
    ``contract_zipup``); ``mesh=`` is not ported yet (ROADMAP A14).
    """
    A_is_mps = all(t.dim() == 3 for t in A.sitetensors())
    B_is_mps = all(t.dim() == 3 for t in B.sitetensors())

    if A_is_mps != B_is_mps:
        A4 = _promote_mps_to_mpo(A, "up") if A_is_mps else A
        B4 = _promote_mps_to_mpo(B, "down") if B_is_mps else B
        tt = contract(A4, B4, algorithm=algorithm, tolerance=tolerance,
                      maxbonddim=maxbonddim, f=f, method=method,
                      torch_native=torch_native, mesh=mesh, **kwargs)
        return TensorTrain(
            [t.reshape(t.shape[0], -1, t.shape[-1]) for t in tt.sitetensors()]
        )
    if A_is_mps and B_is_mps:
        raise ValueError("At least one operand must be a 4-leg tensor train.")

    if algorithm == "TCI":
        return contract_TCI(A, B, tolerance=tolerance, maxbonddim=maxbonddim,
                            f=f, torch_native=torch_native, mesh=mesh,
                            **kwargs)
    elif algorithm == "naive":
        return contract_naive(A, B, f=f, tolerance=tolerance,
                              maxbonddim=maxbonddim,
                              torch_native=torch_native, mesh=mesh)
    elif algorithm == "zipup":
        if f is not None:
            raise ValueError(
                "Zipup contraction cannot apply an elementwise function. "
                "Use algorithm='TCI' instead."
            )
        return contract_zipup(A, B, tolerance=tolerance, method=method,
                              maxbonddim=maxbonddim,
                              torch_native=torch_native, mesh=mesh)
    raise ValueError(f"Unknown algorithm {algorithm}.")
