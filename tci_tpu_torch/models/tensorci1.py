"""TCI1: Oseledets-style ACA-based tensor cross interpolation with incremental
Π-matrix updates.

Counterpart of ``tci_tpu/models/tensorci1.py`` (parity reference:
src/tensorci1.jl). TCI1 keeps the full Π matrices and updates them as
pivots are added; pivot selection uses the ACA engine (``ops/aca.py``). The
Π matrices, the site tensors T, the pivot matrices P and the ACA factors are
tensors on one device, ``TensorCI1.device`` (the current CUDA device unless
the caller passes ``device``; ``device="cpu"`` for the CPU). An evaluator
with ``evaluate_many`` (a ``TorchBatchEvaluator``) samples each new panel,
row block or column block in one call on its device.

The index bookkeeping follows the Kronecker order and never looks up old
entries one by one: Π's row set is Iset[p] ⊗ {0..d-1} (position i·d + u) and
its column set {0..d-1} ⊗ Jset[p+1] (position u·|J| + j). Iset and Jset only
grow by ``push``, so when Iset[p] grows Π[p]'s old rows keep their places
and the new ones are appended; when Jset[p+1] grows from n to n' entries,
old column u·n + j moves to u·n' + j. ``PiIset`` / ``PiJset`` are views of
that product (``KroneckerIndexSet``) taken when Π was last extended.

Every host read of TCI1 and its matrix engines (the argmax of a pivot
search, the zero-pivot guards, the running max |sample|) is counted in
``FETCHES["tci1"]``.
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.aca import MatrixACA
from ..ops.ci import AinvtimesB, AtimesBinv, MatrixCI, host_value
from ..parallel.batcheval import evaluate_rows
from ..utils.device import numpy_dtype, resolve_device, to_device, torch_dtype
from ..utils.indexset import IndexSet
from ..utils.sweep import forwardsweep
from .tensortrain import AbstractTensorTrain

MultiIndex = Tuple[int, ...]


class KroneckerIndexSet:
    """The product of the first n entries of an IndexSet (`base`, n its
    length when the view is taken) with the d values of one site leg, as an
    index set, without building it: the leg appended (Iset ⊗ d, position
    e·d + u) or, with ``leg_first``, prepended (d ⊗ Jset, position
    u·n + e)."""

    __slots__ = ("base", "n", "d", "leg_first")

    def __init__(self, base: IndexSet, d: int, leg_first: bool):
        self.base, self.n = base, len(base)
        self.d, self.leg_first = d, leg_first

    def __len__(self) -> int:
        return self.n * self.d

    def __getitem__(self, p: int) -> MultiIndex:
        if not 0 <= p < len(self):
            raise IndexError(p)
        if self.leg_first:
            return (p // self.n,) + tuple(self.base[p % self.n])
        return tuple(self.base[p // self.d]) + (p % self.d,)

    def pos(self, x) -> int:
        """Position of a multi-index (KeyError when it is not an entry)."""
        x = tuple(x)
        u, rest = (x[0], x[1:]) if self.leg_first else (x[-1], x[:-1])
        e = self.base.toint[rest]
        if e >= self.n or not 0 <= u < self.d:
            raise KeyError(x)
        return u * self.n + e if self.leg_first else e * self.d + u

    def __contains__(self, x) -> bool:
        try:
            self.pos(x)
        except (KeyError, IndexError):
            return False
        return True

    @property
    def fromint(self) -> List[MultiIndex]:
        return [self[p] for p in range(len(self))]

    def __iter__(self):
        return iter(self.fromint)

    def isempty(self) -> bool:
        return len(self) == 0

    def __eq__(self, other) -> bool:
        if not isinstance(other, (KroneckerIndexSet, IndexSet)):
            return NotImplemented
        return self.fromint == list(other.fromint)

    def grown_from(self, old: "KroneckerIndexSet") -> bool:
        """True when this view extends `old`: the same base, no shorter."""
        return (self.base is old.base and self.d == old.d
                and self.leg_first == old.leg_first and self.n >= old.n)


class TensorCI1(AbstractTensorTrain):
    """TCI1 state (tensorci1.jl:67-131) on `device`."""

    def __init__(self, localdims: Sequence[int], dtype=np.float64,
                 device=None):
        n = len(localdims)
        self.localdims = [int(d) for d in localdims]
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        self.Iset: List[IndexSet] = [IndexSet() for _ in range(n)]
        self.Jset: List[IndexSet] = [IndexSet() for _ in range(n)]
        self.T: List[torch.Tensor] = [
            self._zeros((0, d, 0)) for d in self.localdims]
        self.P: List[torch.Tensor] = [self._zeros((0, 0)) for _ in range(n)]
        self.aca: List[MatrixACA] = [
            MatrixACA(nrows=0, ncols=0, dtype=self.dtype, device=self.device)
            for _ in range(n)]
        self.Pi: List[torch.Tensor] = [self._zeros((0, 0)) for _ in range(n)]
        self.PiIset: List[KroneckerIndexSet] = [
            self.getPiIset(p) for p in range(n)]
        self.PiJset: List[KroneckerIndexSet] = [
            self.getPiJset(p) for p in range(n)]
        self.pivoterrors = np.full(n - 1, np.inf)
        self._maxsample = 0.0
        self._maxsample_dev: Optional[torch.Tensor] = None
        # numpy matrices of the index sets' entries, extended as they grow
        self._matrices = {}

    def _zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    @classmethod
    def from_function(
        cls,
        func: Callable,
        localdims: Sequence[int],
        firstpivot: Optional[Sequence[int]] = None,
        dtype=np.float64,
        device=None,
    ) -> "TensorCI1":
        tci = cls(localdims, dtype=dtype, device=device)
        if firstpivot is None:
            firstpivot = tuple(0 for _ in localdims)
        firstpivot = tuple(int(x) for x in firstpivot)

        tci.maxsamplevalue = abs(func(firstpivot))
        if tci.maxsamplevalue == 0:
            raise ValueError("Please provide a first pivot where f(pivot) != 0.")
        if len(localdims) != len(firstpivot):
            raise ValueError("Firstpivot and localdims must have same length.")

        n = len(localdims)
        tci.Iset = [IndexSet([firstpivot[:p]]) for p in range(n)]
        tci.Jset = [IndexSet([firstpivot[p + 1:]]) for p in range(n)]
        tci.PiIset = [tci.getPiIset(p) for p in range(n)]
        tci.PiJset = [tci.getPiJset(p) for p in range(n)]
        tci.Pi = [tci.getPi(p, func) for p in range(n - 1)] + [
            tci._zeros((0, 0))]

        for p in range(n - 1):
            localpivot = (
                tci.PiIset[p].pos(tci.Iset[p + 1][0]),
                tci.PiJset[p + 1].pos(tci.Jset[p][0]),
            )
            tci.aca[p] = MatrixACA(A=tci.Pi[p], firstpivot=localpivot)
            if p == 0:
                tci.updateT(0, tci.Pi[p][:, localpivot[1]:localpivot[1] + 1])
            tci.updateT(p + 1, tci.Pi[p][localpivot[0]:localpivot[0] + 1, :])
            i, j = localpivot
            tci.P[p] = tci.Pi[p][i:i + 1, j:j + 1].clone()
        tci.P[n - 1] = torch.ones((1, 1), dtype=tci.dtype, device=tci.device)
        return tci

    # -- state ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.T)

    def lastsweeppivoterror(self) -> float:
        return float(np.max(self.pivoterrors))

    @property
    def maxsamplevalue(self) -> float:
        """max |sample| so far; a device value pending since the last read
        is fetched here."""
        if self._maxsample_dev is not None:
            pending, self._maxsample_dev = self._maxsample_dev, None
            self._maxsample = max(self._maxsample,
                                  float(host_value(pending)))
        return self._maxsample

    @maxsamplevalue.setter
    def maxsamplevalue(self, value: float) -> None:
        self._maxsample_dev = None
        self._maxsample = float(value)

    def updatemaxsample(self, samples: torch.Tensor) -> None:
        """Fold max |samples| into the running max on the device."""
        if samples.numel() == 0:
            return
        m = samples.abs().amax().to(torch.float64)
        pending = self._maxsample_dev
        self._maxsample_dev = m if pending is None else torch.maximum(
            pending, m)

    def linkdims(self) -> List[int]:
        return [t.shape[0] for t in self.T[1:]]

    def linkdim(self, i: int) -> int:
        return self.T[i + 1].shape[0]

    def sitedims(self) -> List[List[int]]:
        return [list(t.shape[1:-1]) for t in self.T]

    def sitedim(self, i: int) -> List[int]:
        return list(self.T[i].shape[1:-1])

    def rank(self) -> int:
        ld = self.linkdims()
        return max(ld) if ld else 1

    # -- site tensors (tensorci1.jl:266-306) --------------------------------

    def TtimesPinv(self, p: int) -> torch.Tensor:
        T = self.T[p]
        shape = T.shape
        TPinv = AtimesBinv(T.reshape(shape[0] * shape[1], shape[2]), self.P[p])
        return TPinv.reshape(shape)

    def PinvtimesT(self, p: int) -> torch.Tensor:
        T = self.T[p]
        shape = T.shape
        PinvT = AinvtimesB(self.P[p - 1],
                           T.reshape(shape[0], shape[1] * shape[2]))
        return PinvT.reshape(shape)

    def sitetensor(self, p: int) -> torch.Tensor:
        return self.TtimesPinv(p)

    def sitetensors(self) -> List[torch.Tensor]:
        return [self.sitetensor(p) for p in range(len(self.T))]

    def evaluate(self, indexset):
        """(tensorci1.jl:373-381); a Python scalar."""
        v = None
        for p in range(len(self)):
            mat = AtimesBinv(self.T[p][:, int(indexset[p]), :], self.P[p])
            v = mat if v is None else v @ mat
        return v[0, 0].item()

    # -- Pi matrices (tensorci1.jl:388-455) ----------------------------------

    def getPiIset(self, p: int) -> KroneckerIndexSet:
        return KroneckerIndexSet(self.Iset[p], self.localdims[p], False)

    def getPiJset(self, p: int) -> KroneckerIndexSet:
        return KroneckerIndexSet(self.Jset[p], self.localdims[p], True)

    def _entries(self, s: IndexSet) -> np.ndarray:
        """The entries of index set s as a (len(s), width) int64 matrix; the
        rows already converted are kept and only entries pushed since are
        added."""
        held = self._matrices.get(id(s))
        mat = held[1] if held is not None and held[0] is s else np.zeros(
            (0, 0), dtype=np.int64)
        if len(mat) < len(s):
            new = np.array(s.fromint[len(mat):], dtype=np.int64).reshape(
                len(s) - len(mat), -1)
            mat = np.concatenate([mat, new]) if len(mat) else new
            self._matrices[id(s)] = (s, mat)
        return mat[:len(s)]

    def _kron_rows(self, ks: KroneckerIndexSet, lo: int = 0,
                   hi: Optional[int] = None) -> np.ndarray:
        """The multi-indices of ks built from base entries lo..hi, as a
        matrix in ks's position order (for the leg-first product that is
        u-major over those entries)."""
        hi = ks.n if hi is None else hi
        B = self._entries(ks.base)[lo:hi]
        legs = np.arange(ks.d, dtype=np.int64)
        if ks.leg_first:
            return np.concatenate(
                [np.repeat(legs, len(B))[:, None], np.tile(B, (ks.d, 1))],
                axis=1)
        return np.concatenate(
            [np.repeat(B, ks.d, axis=0), np.tile(legs, len(B))[:, None]],
            axis=1)

    def _rows_eval(self, f, indices: np.ndarray) -> torch.Tensor:
        """f at every row of an (B, L) index matrix, on this TCI's device:
        one batched call when f has ``evaluate_many`` (evaluate_rows), a
        host loop otherwise. The reference samples Π per entry
        (tensorci1.jl:426-433)."""
        vals = evaluate_rows(f, indices.reshape(-1, len(self)),
                             dtype=numpy_dtype(self.dtype))
        return to_device(vals, self.device).to(self.dtype)

    def _grid_eval(self, f, rows: np.ndarray, cols: np.ndarray
                   ) -> torch.Tensor:
        """f on rows × cols (left and right parts of the multi-index), an
        (len(rows), len(cols)) tensor."""
        a, b = len(rows), len(cols)
        idx = np.concatenate([np.repeat(rows, b, axis=0),
                              np.tile(cols, (a, 1))], axis=1)
        block = self._rows_eval(f, idx).reshape(a, b)
        self.updatemaxsample(block)
        return block

    def getPi(self, p: int, f) -> torch.Tensor:
        return self._grid_eval(f, self._kron_rows(self.PiIset[p]),
                               self._kron_rows(self.PiJset[p + 1]))

    def getcross(self, p: int) -> MatrixCI:
        """(tensorci1.jl:443-455). The positions of Iset[p+1] in PiIset[p]
        and of Jset[p] in PiJset[p+1] are the ACA's pivot positions at bond
        p: both grow by the same pivot and are renumbered by the same
        permutation."""
        shape = self.T[p].shape
        Tp = self.T[p].reshape(shape[0] * shape[1], shape[2])
        shape1 = self.T[p + 1].shape
        Tp1 = self.T[p + 1].reshape(shape1[0], shape1[1] * shape1[2])
        return MatrixCI(list(self.aca[p].rowindices),
                        list(self.aca[p].colindices), Tp, Tp1)

    def updateT(self, p: int, new_T: torch.Tensor) -> None:
        self.T[p] = new_T.reshape(
            len(self.Iset[p]), self.localdims[p], len(self.Jset[p]))

    def _check_grown(self, old: KroneckerIndexSet,
                     new: KroneckerIndexSet) -> None:
        if not new.grown_from(old):
            raise ValueError(
                "Iset/Jset of a TensorCI1 grow by push only; a replaced "
                "index set cannot be merged into its Π matrix")

    def updatePirows(self, p: int, f) -> None:
        """Add the rows that Iset[p]'s new entries bring to Pi[p]
        (tensorci1.jl:496-523). They come after the old rows, which keep
        their places."""
        old, new = self.PiIset[p], self.getPiIset(p)
        self._check_grown(old, new)
        permutation = np.arange(len(old))
        if new.n > old.n:
            block = self._grid_eval(f, self._kron_rows(new, old.n, new.n),
                                    self._kron_rows(self.PiJset[p + 1]))
            self.Pi[p] = torch.cat([self.Pi[p], block])
        self.PiIset[p] = new

        Tshape = self.T[p].shape
        Tp = self.T[p].reshape(Tshape[0] * Tshape[1], Tshape[2])
        self.aca[p].setrows(Tp, permutation)

    def updatePicols(self, p: int, f) -> None:
        """(tensorci1.jl:533-555): Jset[p+1] grew from n to n' entries, so
        Pi[p]'s old column u·n + j moves to u·n' + j and the new columns
        u·n' + j (j >= n) are sampled."""
        old, new = self.PiJset[p + 1], self.getPiJset(p + 1)
        self._check_grown(old, new)
        d, n_old, n_new = new.d, old.n, new.n
        permutation = (np.arange(d)[:, None] * n_new
                       + np.arange(n_old)[None, :]).reshape(-1)
        if n_new > n_old:
            m = self.Pi[p].shape[0]
            block = self._grid_eval(f, self._kron_rows(self.PiIset[p]),
                                    self._kron_rows(new, n_old, n_new))
            self.Pi[p] = torch.cat(
                [self.Pi[p].reshape(m, d, n_old),
                 block.reshape(m, d, n_new - n_old)], dim=2).reshape(
                     m, d * n_new)
        self.PiJset[p + 1] = new

        Tshape = self.T[p + 1].shape
        Tp = self.T[p + 1].reshape(Tshape[0], Tshape[1] * Tshape[2])
        self.aca[p].setcols(Tp, permutation)

    # -- pivot insertion (tensorci1.jl:573-653) -------------------------------

    def addpivotrow(self, cross: MatrixCI, p: int, newi: int, f) -> None:
        self.aca[p].addpivotrow(self.Pi[p], newi)
        cross.addpivotrow(self.Pi[p], newi)
        self.Iset[p + 1].push(self.PiIset[p][newi])
        self.updateT(p + 1, cross.pivotrows)
        self.P[p] = cross.pivotmatrix()
        if p < len(self) - 2:
            self.updatePirows(p + 1, f)

    def addpivotcol(self, cross: MatrixCI, p: int, newj: int, f) -> None:
        self.aca[p].addpivotcol(self.Pi[p], newj)
        cross.addpivotcol(self.Pi[p], newj)
        self.Jset[p].push(self.PiJset[p + 1][newj])
        self.updateT(p, cross.pivotcols)
        self.P[p] = cross.pivotmatrix()
        if p > 0:
            self.updatePicols(p - 1, f)

    def addpivot(self, p: int, f, tolerance: float = 1e-12) -> None:
        """Add one pivot at bond p if its error exceeds tolerance
        (tensorci1.jl:626-653): two fetches (the argmax and the candidate's
        residual), and a third in the ACA's zero-pivot guard when the pivot
        is added."""
        if p < 0 or p > len(self) - 2:
            raise IndexError(
                f"Pi tensors live at bonds 0 to {len(self) - 2}."
            )
        if self.aca[p].rank() >= min(self.Pi[p].shape):
            self.pivoterrors[p] = 0.0
            return
        newpivot, newerror = self.aca[p].findnewpivot(self.Pi[p])
        self.pivoterrors[p] = newerror
        if newerror < tolerance:
            return
        # Vet the candidate's pivot value through the u-recursion BEFORE
        # mutating any state: the αuv-form local error above can sit just
        # over the tolerance while the recursion residual cancels to an
        # exact zero. A zero pivot is uninvertible — treat the bond as
        # numerically converged, the same outcome the reference's
        # zero-pivot guard enforces (tensorci1.jl:182-184).
        resid = self.aca[p].residualcol(self.Pi[p], newpivot[1])
        if host_value(resid[newpivot[0]]) == 0:
            self.pivoterrors[p] = 0.0
            return
        cross = self.getcross(p)
        self.addpivotcol(cross, p, newpivot[1], f)
        self.addpivotrow(cross, p, newpivot[0], f)

    # -- global pivots (tensorci1.jl:667-830) ---------------------------------

    def crosserror(self, f, x: MultiIndex, y: MultiIndex) -> float:
        x, y = tuple(x), tuple(y)
        if len(x) == 0 or len(y) == 0:
            return 0.0
        bondindex = len(x) - 1
        if x in self.Iset[bondindex + 1] or y in self.Jset[bondindex]:
            return 0.0
        if self.Jset[bondindex].isempty():
            return abs(f(x + y))
        fx = self._grid_eval(f, np.asarray([x], dtype=np.int64),
                             self._entries(self.Jset[bondindex]))[0]
        fy = self._grid_eval(f, self._entries(self.Iset[bondindex + 1]),
                             np.asarray([y], dtype=np.int64))[:, 0]
        approx = (AtimesBinv(fx[None, :], self.P[bondindex]) @ fy)[0]
        return abs(host_value(approx) - f(x + y))

    def _updateIproposal(self, f, newpivot, newI, newJ, abstol):
        """(tensorci1.jl:698-732)"""
        error = np.inf
        n = len(self)
        for bond in range(n - 1):
            if len(newI[bond + 1]) == 0:
                error = 0.0
                continue
            if error > abstol:
                newI[bond + 1] = tuple(newI[bond]) + (newpivot[bond],)
                error = self.crosserror(f, newI[bond + 1], newJ[bond])
            elif tuple(newpivot[: bond + 1]) in self.Iset[bond]:
                newI[bond + 1] = tuple(newpivot[: bond + 2])
                error = self.crosserror(f, newI[bond + 1], newJ[bond])
            else:
                xset = [
                    tuple(i) + (newpivot[bond],) for i in self.Iset[bond].fromint
                ]
                errors = [
                    self.crosserror(f, x, newJ[bond]) for x in xset
                ]
                maxindex = int(np.argmax(errors))
                newI[bond + 1] = xset[maxindex]
                error = errors[maxindex]
            if error < abstol:
                newI[bond + 1] = ()
        return newI

    def _updateJproposal(self, f, newpivot, newI, newJ, abstol):
        """(tensorci1.jl:739-773)"""
        error = np.inf
        n = len(self)
        for bond in range(n - 2, -1, -1):
            if len(newJ[bond]) == 0:
                error = 0.0
                continue
            if error > abstol:
                newJ[bond] = (newpivot[bond + 1],) + tuple(newJ[bond + 1])
                error = self.crosserror(f, newI[bond + 1], newJ[bond])
            elif tuple(newpivot[bond + 2:]) in self.Jset[bond + 1]:
                newJ[bond] = tuple(newpivot[bond + 1:])
                error = self.crosserror(f, newI[bond + 1], newJ[bond])
            else:
                yset = [
                    (newpivot[bond + 1],) + tuple(j)
                    for j in self.Jset[bond + 1].fromint
                ]
                errors = [self.crosserror(f, newI[bond + 1], y) for y in yset]
                maxindex = int(np.argmax(errors))
                newJ[bond] = yset[maxindex]
                error = errors[maxindex]
            if error < abstol:
                newJ[bond] = ()
        return newJ

    def addglobalpivot(self, f, newpivot: Sequence[int], abstol: float) -> None:
        """(tensorci1.jl:790-830)"""
        newpivot = tuple(int(x) for x in newpivot)
        if len(newpivot) != len(self):
            raise ValueError(
                f"New global pivot should have exactly {len(self)} entries."
            )
        n = len(self)
        newI = [newpivot[:p] for p in range(n)]
        newJ = [newpivot[p + 1:] for p in range(n)]
        newI = self._updateIproposal(f, newpivot, newI, newJ, abstol)

        for _ in range(n):
            newJ = self._updateJproposal(f, newpivot, newI, newJ, abstol)
            newI = self._updateIproposal(f, newpivot, newI, newJ, abstol)
            if [len(i) == 0 for i in newI[1:]] == [
                len(j) == 0 for j in newJ[: n - 1]
            ]:
                break

        for p in range(n - 1):
            if len(newI[p + 1]) != 0:
                self.addpivotrow(
                    self.getcross(p), p, self.PiIset[p].pos(newI[p + 1]), f
                )
        for p in range(n - 2, -1, -1):
            if len(newJ[p]) != 0:
                self.addpivotcol(
                    self.getcross(p), p, self.PiJset[p + 1].pos(newJ[p]), f
                )


def crossinterpolate1(
    valuetype,
    f,
    localdims: Sequence[int],
    firstpivot: Optional[Sequence[int]] = None,
    tolerance: float = 1e-8,
    maxiter: int = 200,
    sweepstrategy: str = "backandforth",
    pivottolerance: float = 1e-12,
    verbosity: int = 0,
    additionalpivots: Sequence[Sequence[int]] = (),
    normalizeerror: bool = True,
    device=None,
):
    """Cross-interpolate f by TCI1 (tensorci1.jl:894-952) on `device` (the
    current CUDA device by default; ``device="cpu"`` for the CPU).

    Returns (tci, ranks, errors)."""
    tci = TensorCI1.from_function(f, localdims, firstpivot, dtype=valuetype,
                                  device=device)
    n = len(tci)
    errors: List[float] = []
    ranks: List[int] = []

    for pivot in additionalpivots:
        tci.addglobalpivot(f, pivot, tolerance)

    for it in range(tci.rank() + 1, maxiter + 1):
        if forwardsweep(sweepstrategy, it):
            for bond in range(n - 1):
                tci.addpivot(bond, f, pivottolerance)
        else:
            for bond in range(n - 2, -1, -1):
                tci.addpivot(bond, f, pivottolerance)

        errornormalization = tci.maxsamplevalue if normalizeerror else 1.0
        errors.append(tci.lastsweeppivoterror())
        ranks.append(tci.rank())
        if verbosity > 0 and it % 10 == 0:
            print(
                f"iteration = {it}, rank = {ranks[-1]}, error= {errors[-1]}"
            )
        if errors[-1] < tolerance * errornormalization:
            break

    errornormalization = tci.maxsamplevalue if normalizeerror else 1.0
    return tci, ranks, [e / errornormalization for e in errors]


def crossinterpolate(*args, **kwargs):
    """Deprecated alias for crossinterpolate1 (tensorci1.jl:961-969)."""
    warnings.warn(
        "crossinterpolate is deprecated; use crossinterpolate1.",
        DeprecationWarning,
    )
    return crossinterpolate1(*args, **kwargs)
