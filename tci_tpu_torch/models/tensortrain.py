"""Tensor-train (TT/MPS) container and shared operations.

Counterpart of ``tci_tpu/models/tensortrain.py`` (parity reference:
src/abstracttensortrain.jl and src/tensortrain.jl). Site tensors are
(χ_{k-1}, d_1, ..., d_m, χ_k) tensors on one device; evaluation is a chain
of matrix products (abstracttensortrain.jl:328-342), `sum` the factorized
O(n d r^2) reduction (:428-441), addition block-diagonal core stacking
(:467-495), and compression the two-pass orthogonalize/truncate sweep
(tensortrain.jl:302-348) over LU/CI/SVD splits (``ops/factorize.py``), so a
TT on a CUDA device compresses through the rrLU kernel. Batched evaluation
goes through the padded-core ``torch.bmm`` loop of ``models/tteval.py``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops.factorize import factorize
from ..utils.device import resolve_device, to_device, torch_dtype
from .tteval import pad_cores, tt_evaluate_batched

_INTMAX = 2**62


class AbstractTensorTrain:
    """Base class: anything holding a list of site tensors and evaluable as a
    function of one index per site."""

    def sitetensors(self) -> List[torch.Tensor]:
        return self._sitetensors

    def sitetensor(self, i: int) -> torch.Tensor:
        return self.sitetensors()[i]

    def __len__(self) -> int:
        return len(self.sitetensors())

    def __iter__(self):
        return iter(self.sitetensors())

    def __getitem__(self, i):
        return self.sitetensors()[i]

    def linkdims(self) -> List[int]:
        return [t.shape[0] for t in self.sitetensors()[1:]]

    def linkdim(self, i: int) -> int:
        return self.sitetensor(i + 1).shape[0]

    def sitedims(self) -> List[List[int]]:
        return [list(t.shape[1:-1]) for t in self.sitetensors()]

    def sitedim(self, i: int) -> List[int]:
        return list(self.sitetensor(i).shape[1:-1])

    def rank(self) -> int:
        ld = self.linkdims()
        return max(ld) if ld else 1

    def evaluate(self, indexset):
        """Evaluate at one multi-index; entries may be ints (one site leg) or
        tuples (multi-leg sites). A Python scalar."""
        tensors = self.sitetensors()
        if len(indexset) != len(tensors):
            raise ValueError(
                f"To evaluate a tt of length {len(tensors)}, provide "
                f"{len(tensors)} indices, got {len(indexset)}."
            )
        v = None
        for T, i in zip(tensors, indexset):
            if isinstance(i, (int, np.integer)):
                if T.dim() != 3:
                    raise ValueError(
                        f"Tensor with {T.dim() - 2} site legs needs a tuple "
                        "index.")
                mat = T[:, int(i), :]
            else:
                if T.dim() != len(i) + 2:
                    raise ValueError(
                        f"Index {tuple(i)} has wrong length for tensor of "
                        f"shape {tuple(T.shape)}.")
                mat = T[(slice(None), *(int(x) for x in i), slice(None))]
            v = mat if v is None else v @ mat
        return v[0, 0].item()

    def __call__(self, indexset):
        return self.evaluate(indexset)

    def evaluate_batch(self, indices) -> torch.Tensor:
        """Evaluate at a whole (B, L) batch of multi-indices; a (B,) tensor
        on the cores' device. Single-leg sites only."""
        tensors = self.sitetensors()
        device = tensors[0].device
        if isinstance(indices, torch.Tensor):
            indices = indices.to(device, torch.int64)
        else:
            indices = to_device(np.asarray(indices, dtype=np.int64), device)
        if indices.dim() != 2 or indices.shape[1] != len(tensors):
            raise ValueError("indices must have shape (B, L).")
        return tt_evaluate_batched(pad_cores(tensors), indices)

    def sum(self):
        """Σ over all grid points via per-site reductions
        (abstracttensortrain.jl:428-441); a Python scalar."""
        tensors = self.sitetensors()
        t0 = tensors[0]
        v = t0.reshape(t0.shape[0], -1, t0.shape[-1]).sum(dim=(0, 1))[None, :]
        for T in tensors[1:]:
            v = v @ T.reshape(T.shape[0], -1, T.shape[-1]).sum(dim=1)
        return v[0, 0].item()

    def norm2(self) -> float:
        """Squared Frobenius norm via transfer matrices
        (abstracttensortrain.jl:625-639), on the cores' device."""
        result = None
        for t in self.sitetensors():
            t3 = t.reshape(t.shape[0], -1, t.shape[-1])
            # (lc, s, rc) x (l, s, r) -> (lc, l, rc, r) -> (lc*l, rc*r)
            tct = torch.einsum("asb,csd->acbd", t3.conj(), t3)
            mat = tct.reshape(t3.shape[0] ** 2, t3.shape[2] ** 2)
            result = mat if result is None else result @ mat
        return float(result[0, 0].real)

    def norm(self) -> float:
        return float(np.sqrt(self.norm2()))

    def __add__(self, other):
        return add(self, other)

    def __sub__(self, other):
        return subtract(self, other)

    def __repr__(self):
        return f"{type(self).__name__} with rank {self.rank()}"


class TensorTrain(AbstractTensorTrain):
    """Concrete TT with bond-consistency validation (tensortrain.jl:58-79).

    Takes tensors or numpy arrays, as ``rrlu`` does: a numpy core goes to
    `device` (``utils.device.resolve_device``: the current CUDA device by
    default, and a RuntimeError without one unless ``device="cpu"`` is
    given); a tensor stays on its device unless `device` is given."""

    def __init__(self, sitetensors: Sequence, device=None):
        if isinstance(sitetensors, AbstractTensorTrain):
            sitetensors = sitetensors.sitetensors()
        target = None if device is None else resolve_device(device)
        tensors = []
        for t in sitetensors:
            if isinstance(t, torch.Tensor):
                tensors.append(t if target is None else t.to(target))
            else:
                tensors.append(to_device(np.asarray(t),
                                         resolve_device(device)))
        for i in range(len(tensors) - 1):
            if tensors[i].shape[-1] != tensors[i + 1].shape[0]:
                raise ValueError(
                    f"The tensors at {i} and {i + 1} must have consistent "
                    "dimensions for a tensor train."
                )
        self._sitetensors = tensors

    @classmethod
    def from_tci(cls, tci) -> "TensorTrain":
        return cls(tci.sitetensors())

    def astype(self, dtype) -> "TensorTrain":
        """A copy with cores of `dtype`; a complex -> real cast discards the
        imaginary part by design (tensortrain.jl:101-174)."""
        dtype = torch_dtype(dtype)
        return TensorTrain([
            (t.real if t.is_complex() and not dtype.is_complex else t).to(
                dtype=dtype, copy=True)
            for t in self._sitetensors])

    def reshape_sites(self, localdims) -> "TensorTrain":
        """Reshape site legs: localdims[n] lists the per-site leg extents
        (tensortrain.jl:161-174)."""
        for n, t in enumerate(self._sitetensors):
            if int(np.prod(t.shape[1:-1])) != int(np.prod(localdims[n])):
                raise ValueError(f"Local dimensions at n={n} must match.")
        return TensorTrain([
            t.reshape(t.shape[0], *localdims[n], t.shape[-1])
            for n, t in enumerate(self._sitetensors)])

    def copy(self) -> "TensorTrain":
        return TensorTrain([t.clone() for t in self._sitetensors])

    def deepcopy(self) -> "TensorTrain":
        return self.copy()

    # -- compression (tensortrain.jl:302-348) ------------------------------

    def compress(
        self,
        method: str = "LU",
        tolerance: float = 1e-12,
        maxbonddim: int = _INTMAX,
        normalizeerror: bool = True,
        torch_native: bool = False,
        mesh=None,
    ) -> None:
        """In-place two-pass compression on the cores' device: L→R
        orthogonalization (no truncation), then R→L truncation; each split
        is one ``factorize`` call, so an "LU" or "CI" split of a CUDA TT is
        one launch of the rrLU kernel. With ``torch_native=True`` (and
        ``method="LU"``) the whole sweep is queued on the device with one
        fetch at its end (``models/compress_device.py``)."""
        if torch_native:
            from .compress_device import compress_device

            out = compress_device(
                self, method, tolerance=tolerance, maxbonddim=maxbonddim,
                normalizeerror=normalizeerror, mesh=mesh)
            self._sitetensors = out.sitetensors()
            return
        if mesh is not None:
            raise NotImplementedError(
                "compress(mesh=...) is not ported yet (ROADMAP A14)")
        tt = self._sitetensors
        for ell in range(len(tt) - 1):
            shapel = tt[ell].shape
            left, right, newbond = factorize(
                tt[ell].reshape(int(np.prod(shapel[:-1])), shapel[-1]),
                method, tolerance=0.0, maxbonddim=_INTMAX, leftorthogonal=True,
            )
            tt[ell] = left.reshape(*shapel[:-1], newbond)
            shaper = tt[ell + 1].shape
            nexttensor = _matmul(right, tt[ell + 1].reshape(
                shaper[0], int(np.prod(shaper[1:]))))
            tt[ell + 1] = nexttensor.reshape(newbond, *shaper[1:])

        for ell in range(len(tt) - 1, 0, -1):
            shaper = tt[ell].shape
            left, right, newbond = factorize(
                tt[ell].reshape(shaper[0], int(np.prod(shaper[1:]))),
                method, tolerance=tolerance, maxbonddim=maxbonddim,
                normalizeerror=normalizeerror, leftorthogonal=False,
            )
            tt[ell] = right.reshape(newbond, *shaper[1:])
            shapel = tt[ell - 1].shape
            nexttensor = _matmul(tt[ell - 1].reshape(
                int(np.prod(shapel[:-1])), shapel[-1]), left)
            tt[ell - 1] = nexttensor.reshape(*shapel[:-1], newbond)

    # -- scalar algebra (tensortrain.jl:355-435) ----------------------------

    def multiply(self, a) -> "TensorTrain":
        out = self.copy()
        out._sitetensors[-1] = out._sitetensors[-1] * a
        return out

    def divide(self, a) -> "TensorTrain":
        out = self.copy()
        out._sitetensors[-1] = out._sitetensors[-1] / a
        return out

    def __mul__(self, a):
        return self.multiply(a)

    def __rmul__(self, a):
        return self.multiply(a)

    def __truediv__(self, a):
        return self.divide(a)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the two factors' common dtype: an LU or CI split of a
    float32 train returns float64 factors, and torch's @ does not promote
    (numpy's does, so tci_tpu's cores become float64)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def tensortrain(tci) -> TensorTrain:
    """Convert any AbstractTensorTrain to a plain TensorTrain."""
    return TensorTrain(tci.sitetensors())


def sitedims(tt) -> List[List[int]]:
    return tt.sitedims()


def evaluate(tt, indexset, **kwargs):
    return tt.evaluate(indexset, **kwargs)


def _addtttensor(
    A: torch.Tensor,
    B: torch.Tensor,
    factorA=1,
    factorB=1,
    lefttensor=False,
    righttensor=False,
) -> torch.Tensor:
    """Stack two cores block-diagonally for TT addition
    (abstracttensortrain.jl:467-495), on A's device."""
    if A.dim() != B.dim():
        raise ValueError(
            "Elementwise addition requires the same number of indices.")
    nd = A.dim()
    offset1 = 0 if lefttensor else A.shape[0]
    offset3 = 0 if righttensor else A.shape[-1]
    fa, fb = factorA * A, factorB * B.to(A.device)
    C = torch.zeros(
        (offset1 + B.shape[0], *A.shape[1:nd - 1], offset3 + B.shape[-1]),
        dtype=torch.promote_types(fa.dtype, fb.dtype), device=A.device)
    sl = (slice(None),) * (nd - 2)
    C[(slice(0, A.shape[0]), *sl, slice(0, A.shape[-1]))] = fa
    C[(slice(offset1, None), *sl, slice(offset3, None))] = fb
    return C


def add(
    lhs,
    rhs,
    factorlhs=1,
    factorrhs=1,
    tolerance: float = 0.0,
    maxbonddim: int = _INTMAX,
) -> TensorTrain:
    """factorlhs*lhs + factorrhs*rhs with SVD recompression
    (abstracttensortrain.jl:524-553), on lhs's device."""
    if len(lhs) != len(rhs):
        raise ValueError(
            f"Two tensor trains with different length ({len(lhs)} and "
            f"{len(rhs)}) cannot be added elementwise."
        )
    L = len(lhs)
    tt = TensorTrain([
        _addtttensor(
            lhs[ell],
            rhs[ell],
            factorA=factorlhs if ell == L - 1 else 1,
            factorB=factorrhs if ell == L - 1 else 1,
            lefttensor=(ell == 0),
            righttensor=(ell == L - 1),
        )
        for ell in range(L)])
    tt.compress("SVD", tolerance=tolerance, maxbonddim=maxbonddim)
    return tt


def subtract(lhs, rhs, tolerance: float = 0.0, maxbonddim: int = _INTMAX):
    return add(lhs, rhs, factorrhs=-1, tolerance=tolerance,
               maxbonddim=maxbonddim)


def norm(tt) -> float:
    return tt.norm()


def norm2(tt) -> float:
    return tt.norm2()


def tt_reverse(tt) -> TensorTrain:
    """Reverse site order (tensortrain.jl:452-457)."""
    return TensorTrain([
        T.permute(T.dim() - 1, *range(1, T.dim() - 1), 0)
        for T in reversed(list(tt.sitetensors()))])


def fulltensor(tt) -> torch.Tensor:
    """Materialize the full tensor on the cores' device; exponential in
    length (tensortrain.jl:580-600)."""
    sitedims_ = tt.sitedims()
    localdims = [int(np.prod(d)) for d in sitedims_]
    tensors = tt.sitetensors()
    result = tensors[0].reshape(localdims[0], -1)
    leftdim = localdims[0]
    for l in range(1, len(tensors)):
        t = tensors[l]
        nextmatrix = t.reshape(t.shape[0], localdims[l] * t.shape[-1])
        leftdim *= localdims[l]
        result = (result @ nextmatrix).reshape(leftdim, t.shape[-1])
    returnsize = [d for dims in sitedims_ for d in dims]
    return result.reshape(*returnsize)


class TensorTrainFit:
    """Least-squares TT fit objective over flattened cores
    (tensortrain.jl:483-557), on the TT's device. ``loss_torch`` is the
    same objective written with torch operations, so autograd gives its
    gradient (``tci_tpu``'s ``loss_jax`` with ``jax.grad``)."""

    def __init__(self, indexsets, values, tt: TensorTrain):
        self.indexsets = [tuple(i) for i in indexsets]
        device = tt[0].device
        self.values = (values.to(device) if isinstance(values, torch.Tensor)
                       else to_device(np.asarray(values), device))
        self.tt = tt
        offsets = [0]
        for n in range(len(tt)):
            offsets.append(offsets[-1] + int(np.prod(tt[n].shape)))
        self.offsets = offsets

    def flatten(self) -> torch.Tensor:
        return torch.cat([t.reshape(-1) for t in self.tt.sitetensors()])

    def to_tensors(self, x) -> List[torch.Tensor]:
        if not isinstance(x, torch.Tensor):
            x = to_device(np.asarray(x), self.tt[0].device)
        return [x[self.offsets[n]:self.offsets[n + 1]].reshape(
            self.tt[n].shape) for n in range(len(self.tt))]

    def __call__(self, x) -> float:
        tensors = self.to_tensors(x)
        total = 0.0
        for i, indexset in enumerate(self.indexsets):
            v = None
            for T, idx in zip(tensors, indexset):
                mat = T[:, idx, :]
                v = mat if v is None else v @ mat
            total += abs((v[0, 0] - self.values[i]).item()) ** 2
        return total

    def loss_torch(self, x: torch.Tensor) -> torch.Tensor:
        """The objective as a 0-d tensor of x (a tensor on the TT's device,
        which may require grad): one gather and one batched product per
        site over all index sets."""
        tensors = self.to_tensors(x)
        idx = torch.as_tensor(np.asarray(self.indexsets, dtype=np.int64),
                              device=x.device)
        v = tensors[0][0, idx[:, 0], :]
        for n in range(1, len(tensors)):
            v = torch.einsum("bi,ibj->bj", v, tensors[n][:, idx[:, n], :])
        return ((v[:, 0] - self.values).abs() ** 2).sum()
