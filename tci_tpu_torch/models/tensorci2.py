"""TCI2: two-site sweep tensor cross interpolation with rrLU pivot selection.

Counterpart of ``tci_tpu/models/tensorci2.py`` (parity reference:
src/tensorci2.jl), with full and rook pivoting. The state machine (Iset/Jset per bond as
host lists of tuples, non-strict nesting via set history, 1/2-site sweeps,
global pivot insertion, convergence criterion) is bondwise identical. A TCI
runs on one device, ``TensorCI2.device``: the current CUDA device unless
the caller passes ``device`` (``device="cpu"`` for the CPU).

Like ``tci_tpu``, it takes the device tiers an evaluator offers
(``TorchBatchEvaluator``): the whole-sweep engine (``device_sweep_engine``:
a 2-site sweep, the site-tensor fill and the 1-site sweep with one fetch
each; by default, as in ``tci_tpu``, an optimize iteration's two sweeps,
fill and global-pivot search as one program, and blocks of such iterations
on the device, ``_optimize_device_block``), else the per-bond fused update (``fused_updater``) and the fused
site tensors (``fused_site_tensors``). Without them (a plain f or a
``VectorizedBatchEvaluator``) it runs the host tier: each bond's Π panel is
sampled where the evaluator lives and moved to the TCI's device in one
place, ``filltensor``; there the rrLU kernel factorizes it and the CI
factors come from triangular solves. Per bond only the permutations,
npivot and the pivot errors come back to the host; panels, LU buffers and
site tensors stay on the device. The running max |sample| is kept on the
device too and read when the host needs it.

Indices are 0-based tuples.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.luci import MatrixLUCI
from ..parallel.batcheval import (
    _batchevaluate_dispatch,
    evaluate_rows,
    isbatchevaluable,
)
from ..parallel.mesh import mesh_rng
from ..utils.device import numpy_dtype, resolve_device, to_device, torch_dtype
from ..utils.indexset import isnested
from ..utils.sweep import forwardsweep
from ..utils.trace import begin_solve, count_rrlu, profiled, span
from ..utils.util import _host, padzero, pushunique
from .globalpivotfinder import DefaultGlobalPivotFinder, GlobalPivotSearchInput
from .tensortrain import AbstractTensorTrain, TensorTrain

_INTMAX = 2**62

MultiIndex = Tuple[int, ...]


def kronecker_is(Iset: Sequence[MultiIndex], localdim: int) -> List[MultiIndex]:
    """Product Iset ⊗ {0..d-1}, appended on the right; position p = i*d + j
    matches a C-order reshape of (|I|, d) (tensorci2.jl:512-517)."""
    return [tuple(i) + (j,) for i in Iset for j in range(localdim)]


def kronecker_sj(localdim: int, Jset: Sequence[MultiIndex]) -> List[MultiIndex]:
    """Product {0..d-1} ⊗ Jset, prepended on the left; position p = i*|J| + j
    matches a C-order reshape of (d, |J|) (tensorci2.jl:524-529)."""
    return [(i,) + tuple(j) for i in range(localdim) for j in Jset]


def kronecker(a, b) -> List[MultiIndex]:
    """The reference's two kronecker methods: kronecker(Iset, d) appends a
    site index, kronecker(d, Jset) prepends one."""
    if isinstance(a, (int, np.integer)):
        return kronecker_sj(int(a), b)
    return kronecker_is(a, int(b))


def _union(a: Sequence[MultiIndex], b: Sequence[MultiIndex]) -> List[MultiIndex]:
    """Order-preserving union (Julia's union, tensorci2.jl:842-843)."""
    return list(dict.fromkeys([tuple(x) for x in a] + [tuple(x) for x in b]))


def filltensor(
    valuetype,
    f,
    localdims: Sequence[int],
    Iset: Sequence[MultiIndex],
    Jset: Sequence[MultiIndex],
    ncent: int,
    device: torch.device,
) -> torch.Tensor:
    """Sample f on Iset x (free center legs) x Jset; shape (|I|, d..., |J|)
    (tensorci2.jl:475-497), on `device` whichever device f sampled on."""
    if len(Iset) * len(Jset) == 0:
        return torch.zeros((0,) * (ncent + 2), dtype=torch_dtype(valuetype),
                           device=device)
    N = len(localdims)
    nl = len(Iset[0])
    nr = len(Jset[0])
    if ncent != N - nl - nr:
        raise ValueError("Invalid number of central indices")
    return to_device(_batchevaluate_dispatch(valuetype, f, list(localdims),
                                             Iset, Jset, ncent), device)


class SubMatrix:
    """Lazy Π-matrix view used by the host rook tier: entries are sampled
    on demand through f (tensorci2.jl:764-804), as host arrays."""

    def __init__(self, f, rows: Sequence[MultiIndex],
                 cols: Sequence[MultiIndex], valuetype=np.float64):
        self.f = f
        self.rows = [tuple(r) for r in rows]
        self.cols = [tuple(c) for c in cols]
        self.valuetype = numpy_dtype(valuetype)
        self.maxsamplevalue = 0.0

    def __call__(self, irows: Sequence[int], icols: Sequence[int]
                 ) -> np.ndarray:
        if isbatchevaluable(self.f):
            Iset = [self.rows[i] for i in irows]
            Jset = [self.cols[j] for j in icols]
            res = _host(self.f.batch_evaluate(Iset, Jset, 0))
        else:
            res = np.array(
                [[self.f(self.rows[i] + self.cols[j]) for j in icols]
                 for i in irows],
                dtype=self.valuetype,
            ).reshape(len(irows), len(icols))
        if res.size:
            self.maxsamplevalue = max(self.maxsamplevalue,
                                      float(np.max(np.abs(res))))
        return res


class TensorCI2(AbstractTensorTrain):
    """TCI2 interpolation state (tensorci2.jl:50-93). Panels, factors and
    site tensors live on `device` (``utils.device.resolve_device``: the
    current CUDA device by default; without one the constructor raises
    unless ``device="cpu"`` is given)."""

    def __init__(self, localdims: Sequence[int], dtype=np.float64,
                 device=None):
        if len(localdims) <= 1:
            raise ValueError("localdims should have at least 2 elements!")
        n = len(localdims)
        self.localdims = [int(d) for d in localdims]
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        self.Iset: List[List[MultiIndex]] = [[] for _ in range(n)]
        self.Jset: List[List[MultiIndex]] = [[] for _ in range(n)]
        self._sitetensors: List[torch.Tensor] = [
            torch.zeros((0, d, 0), dtype=self.dtype, device=self.device)
            for d in self.localdims
        ]
        self.pivoterrors: List[float] = []
        self.bonderrors = np.zeros(n - 1)
        self._maxsample = 0.0
        self._maxsample_dev: Optional[torch.Tensor] = None
        self.Iset_history: List[List[List[MultiIndex]]] = []
        self.Jset_history: List[List[List[MultiIndex]]] = []

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_function(
        cls,
        f: Callable,
        localdims: Sequence[int],
        initialpivots: Optional[Sequence[Sequence[int]]] = None,
        dtype=np.float64,
        device=None,
    ) -> "TensorCI2":
        tci = cls(localdims, dtype=dtype, device=device)
        if initialpivots is None:
            initialpivots = [tuple(0 for _ in localdims)]
        initialpivots = [tuple(p) for p in initialpivots]
        tci.addglobalpivots(initialpivots)
        tci.maxsamplevalue = max(abs(_call_f(f, x)) for x in initialpivots)
        if not tci.maxsamplevalue > 0.0:
            raise ValueError("maxsamplevalue is zero!")
        tci.invalidatesitetensors()
        return tci

    @classmethod
    def from_ijsets(
        cls,
        f: Callable,
        localdims: Sequence[int],
        Iset: Sequence[Sequence[MultiIndex]],
        Jset: Sequence[Sequence[MultiIndex]],
        dtype=np.float64,
        device=None,
    ) -> "TensorCI2":
        tci = cls(localdims, dtype=dtype, device=device)
        tci.Iset = [[tuple(int(v) for v in i) for i in s] for s in Iset]
        tci.Jset = [[tuple(int(v) for v in j) for j in s] for s in Jset]
        pivots = reconstructglobalpivotsfromijset(
            tci.localdims, tci.Iset, tci.Jset
        )
        tci.maxsamplevalue = max(abs(_call_f(f, p)) for p in pivots)
        if not tci.maxsamplevalue > 0.0:
            raise ValueError("maxsamplevalue is zero!")
        tci.invalidatesitetensors()
        return tci

    # -- basic state -------------------------------------------------------

    def __len__(self) -> int:
        return len(self.localdims)

    def linkdims(self) -> List[int]:
        return [len(self.Iset[b + 1]) for b in range(len(self) - 1)]

    def rank(self) -> int:
        ld = self.linkdims()
        return max(ld) if ld else 1

    def invalidatesitetensors(self) -> None:
        for b in range(len(self)):
            self._sitetensors[b] = torch.zeros((0, 0, 0), dtype=self.dtype,
                                               device=self.device)

    def issitetensorsavailable(self) -> bool:
        return all(t.numel() != 0 for t in self._sitetensors)

    def printnestinginfo(self, file=None) -> None:
        """Print, bond by bond, whether Iset and Jset are nested, to `file`
        (default stdout), in ``tci_tpu``'s words line for line."""
        io = file or sys.stdout
        print("Nesting info: Iset", file=io)
        for i in range(len(self.Iset) - 1):
            if isnested(self.Iset[i], self.Iset[i + 1], "row"):
                print(f"  Nested: {i} < {i + 1}", file=io)
            else:
                print(f"  Not nested: {i} !< {i + 1}", file=io)
        print("", file=io)
        print("Nesting info: Jset", file=io)
        for i in range(len(self.Jset) - 1):
            if isnested(self.Jset[i + 1], self.Jset[i], "col"):
                print(f"  Nested: {i + 1} < {i}", file=io)
            else:
                print(f"  Not nested: ! {i + 1} < {i}", file=io)

    # -- max |sample| (read on the host only when needed) -------------------

    @property
    def maxsamplevalue(self) -> float:
        if self._maxsample_dev is not None:
            self._maxsample = max(self._maxsample,
                                  float(self._maxsample_dev.item()))
            self._maxsample_dev = None
        return self._maxsample

    @maxsamplevalue.setter
    def maxsamplevalue(self, value: float) -> None:
        self._maxsample_dev = None
        self._maxsample = float(value)

    def updatemaxsample(self, samples: Union[torch.Tensor, float]) -> None:
        """Fold max |samples| (a tensor, which stays on its device, or a
        host number) into the running max without a host sync."""
        if not isinstance(samples, torch.Tensor):
            self._maxsample = max(self._maxsample, abs(float(samples)))
            return
        if samples.numel() == 0:
            return
        m = samples.abs().amax()
        pending = self._maxsample_dev
        if pending is not None and pending.device != m.device:
            self.maxsamplevalue  # settle the other device's value first
            pending = None
        self._maxsample_dev = m if pending is None else torch.maximum(pending, m)

    # -- error bookkeeping (tensorci2.jl:231-289) ---------------------------

    def updatebonderror(self, b: int, error: float) -> None:
        self.bonderrors[b] = error

    def maxbonderror(self) -> float:
        return float(np.max(self.bonderrors))

    def updatepivoterror(self, errors: Sequence[float]) -> None:
        n = max(len(self.pivoterrors), len(errors))
        pe = padzero(self.pivoterrors)
        er = padzero(errors)
        self.pivoterrors = [max(next(pe), next(er)) for _ in range(n)]

    def flushpivoterror(self) -> None:
        self.pivoterrors = []

    def pivoterror(self) -> float:
        return self.maxbonderror()

    def updateerrors(self, b: int, errors: Sequence[float]) -> None:
        self.updatebonderror(b, float(errors[-1]))
        self.updatepivoterror(errors)

    # -- global pivots (tensorci2.jl:295-453) --------------------------------

    def addglobalpivots(self, pivots: Sequence[MultiIndex]) -> None:
        if any(len(self) != len(p) for p in pivots):
            raise ValueError(
                "Please specify a pivot as one index per leg of the MPS."
            )
        for pivot in pivots:
            pivot = tuple(int(v) for v in pivot)
            for b in range(len(self)):
                pushunique(self.Iset[b], pivot[:b])
                pushunique(self.Jset[b], pivot[b + 1 :])
        if len(pivots) > 0:
            self.invalidatesitetensors()

    def existaspivot(self, indexset: Sequence[int]) -> List[bool]:
        indexset = tuple(int(v) for v in indexset)
        return [
            indexset[:b] in self.Iset[b] and indexset[b + 1 :] in self.Jset[b]
            for b in range(len(self))
        ]

    def addglobalpivots1sitesweep(
        self,
        f,
        pivots: Sequence[MultiIndex],
        reltol: float = 1e-14,
        abstol: float = 0.0,
        maxbonddim: int = _INTMAX,
    ) -> None:
        self.addglobalpivots(pivots)
        self.makecanonical(f, reltol=reltol, abstol=abstol,
                           maxbonddim=maxbonddim)

    def addglobalpivots2sitesweep(
        self,
        f,
        pivots: Sequence[MultiIndex],
        tolerance: float = 1e-8,
        normalizeerror: bool = True,
        maxbonddim: int = _INTMAX,
        pivotsearch: str = "full",
        verbosity: int = 0,
        ntry: int = 10,
        strictlynested: bool = False,
    ) -> int:
        """Add pivots, then 2-site sweeps until each pivot is interpolated
        within the tolerance (or ntry attempts); returns the number of
        pivots still above it (tensorci2.jl:400-453). The sweeps take the
        tiers f offers, as ``optimize``'s do."""
        if any(len(self) != len(p) for p in pivots):
            raise ValueError(
                "Please specify a pivot as one index per leg of the MPS."
            )
        # every try checks all the given pivots and adds those still off
        given = [tuple(int(v) for v in p) for p in pivots]
        pivmat = np.asarray(given, dtype=np.int64).reshape(len(given),
                                                           len(self))
        pivots_ = given
        for _ in range(ntry):
            errornormalization = self.maxsamplevalue if normalizeerror else 1.0
            abstol = tolerance * errornormalization
            self.addglobalpivots(pivots_)
            self.sweep2site(
                f, 2,
                abstol=abstol, maxbonddim=maxbonddim, pivotsearch=pivotsearch,
                strictlynested=strictlynested, verbosity=verbosity,
            )
            ttvals = TensorTrain(self.sitetensors()).evaluate_batch(pivmat)
            fvals = evaluate_rows(f, pivmat, dtype=self.dtype)
            off = ((ttvals - fvals.to(ttvals.device)).abs() > abstol).tolist()
            newpivots = [p for p, o in zip(given, off) if o]
            if verbosity > 0:
                print(
                    f"Trying to add {len(pivots_)} global pivots, "
                    f"{len(newpivots)} still remain."
                )
            if len(newpivots) == 0 or set(newpivots) == set(pivots_):
                return len(newpivots)
            pivots_ = newpivots
        return len(pivots_)

    # -- site tensors --------------------------------------------------------

    def setsitetensor(self, b: int, T: torch.Tensor) -> None:
        self._sitetensors[b] = T.reshape(
            len(self.Iset[b]), self.localdims[b], len(self.Jset[b])
        )

    def setsitetensor_from_f(self, f, b: int, leftorthogonal: bool = True):
        """Compute site tensor b as Π_1 · P^{-1} (tensorci2.jl:599-629)."""
        if not leftorthogonal:
            raise ValueError("leftorthogonal=False is not supported!")
        fst = getattr(f, "fused_site_tensors", None)
        if fst is not None and b < len(self) - 1:
            # both panels sampled and solved on the evaluator's device
            T, maxsample = fst.compute(
                self.Iset[b], self.localdims[b], self.Jset[b], self.Iset[b + 1]
            )
            self.updatemaxsample(maxsample)
            self._sitetensors[b] = to_device(T, self.device)
            return self._sitetensors[b]
        Is = kronecker_is(self.Iset[b], self.localdims[b])
        Js = self.Jset[b]
        Pi1 = filltensor(
            self.dtype, f, self.localdims, self.Iset[b], self.Jset[b], 1,
            self.device,
        ).reshape(len(Is), len(Js))
        self.updatemaxsample(Pi1)

        if b == len(self) - 1:
            self.setsitetensor(b, Pi1)
            return self._sitetensors[b]

        P = filltensor(
            self.dtype, f, self.localdims, self.Iset[b + 1], self.Jset[b], 0,
            self.device,
        ).reshape(len(self.Iset[b + 1]), len(self.Jset[b]))
        if len(self.Iset[b + 1]) != len(self.Jset[b]):
            raise ValueError(f"Pivot matrix at bond {b} is not square!")
        # T = Pi1 · P^{-1}
        Tmat = torch.linalg.solve(P.T, Pi1.T).T
        self._sitetensors[b] = Tmat.reshape(
            len(self.Iset[b]), self.localdims[b], len(self.Iset[b + 1])
        )
        return self._sitetensors[b]

    def fillsitetensors(self, f) -> None:
        engine = getattr(f, "device_sweep_engine", None)
        if engine is not None and engine.fillsitetensors(self):
            return
        for b in range(len(self)):
            self.setsitetensor_from_f(f, b)

    # -- 0-site sweep (bad pivot removal, tensorci2.jl:559-586) --------------

    def sweep0site(self, f, b: int, reltol: float = 1e-14,
                   abstol: float = 0.0) -> None:
        self.invalidatesitetensors()
        P = filltensor(
            self.dtype, f, self.localdims, self.Iset[b + 1], self.Jset[b], 0,
            self.device,
        ).reshape(len(self.Iset[b + 1]), len(self.Jset[b]))
        self.updatemaxsample(P)
        F = MatrixLUCI(P, reltol=reltol, abstol=abstol, leftorthogonal=True)
        # the pivots, fetched with the permutations: diag[0] is U[0, 0]
        diag = np.abs(F.lu.diag())
        if len(diag) > 0:
            ndiag = int(np.sum((diag > abstol) & (diag / diag[0] > reltol)))
        else:
            ndiag = 0
        self.Iset[b + 1] = [
            self.Iset[b + 1][i] for i in F.rowindices()[:ndiag]
        ]
        self.Jset[b] = [self.Jset[b][j] for j in F.colindices()[:ndiag]]

    # -- 1-site sweep (tensorci2.jl:659-725) ----------------------------------

    def sweep1site(
        self,
        f,
        sweepdirection: str = "forward",
        reltol: float = 1e-14,
        abstol: float = 0.0,
        maxbonddim: int = _INTMAX,
        updatetensors: bool = True,
    ) -> None:
        self.flushpivoterror()
        self.invalidatesitetensors()
        if sweepdirection not in ("forward", "backward"):
            raise ValueError(
                f"Unknown sweep direction {sweepdirection}: "
                "choose between forward, backward."
            )
        fwd = sweepdirection == "forward"
        engine = getattr(f, "device_sweep_engine", None)
        if engine is not None and engine.sweep1site(
            self, fwd, reltol, abstol, maxbonddim, updatetensors=updatetensors
        ):
            return
        n = len(self)
        brange = range(n - 1) if fwd else range(n - 1, 0, -1)
        for b in brange:
            Is = kronecker_is(self.Iset[b], self.localdims[b]) if fwd else self.Iset[b]
            Js = self.Jset[b] if fwd else kronecker_sj(self.localdims[b], self.Jset[b])
            Pi = filltensor(
                self.dtype, f, self.localdims, self.Iset[b], self.Jset[b], 1,
                self.device,
            ).reshape(len(Is), len(Js))
            self.updatemaxsample(Pi)
            luci = MatrixLUCI(
                Pi, reltol=reltol, abstol=abstol, maxrank=maxbonddim,
                leftorthogonal=fwd,
            )
            if fwd:
                self.Iset[b + 1] = [Is[i] for i in luci.rowindices()]
                self.Jset[b] = [Js[j] for j in luci.colindices()]
            else:
                self.Iset[b] = [Is[i] for i in luci.rowindices()]
                self.Jset[b - 1] = [Js[j] for j in luci.colindices()]
            if updatetensors:
                self.setsitetensor(b, luci.left() if fwd else luci.right())
                if torch.isnan(self._sitetensors[b]).any():
                    raise ValueError(f"Error: NaN in tensor T[{b}]")
            self.updateerrors(b if fwd else b - 1, luci.pivoterrors())

        if updatetensors:
            lastindex = n - 1 if fwd else 0
            shape = (
                (len(self.Iset[-1]), self.localdims[-1])
                if fwd
                else (self.localdims[0], len(self.Jset[0]))
            )
            localtensor = filltensor(
                self.dtype, f, self.localdims,
                self.Iset[lastindex], self.Jset[lastindex], 1, self.device,
            ).reshape(shape)
            self.setsitetensor(lastindex, localtensor)

    def makecanonical(
        self,
        f,
        reltol: float = 1e-14,
        abstol: float = 0.0,
        maxbonddim: int = _INTMAX,
    ) -> None:
        """Exact forward pass, truncating backward pass, truncating forward
        pass with tensors (tensorci2.jl:738-749)."""
        self.sweep1site(f, "forward", reltol=0.0, abstol=0.0,
                        maxbonddim=_INTMAX, updatetensors=False)
        self.sweep1site(f, "backward", reltol=reltol, abstol=abstol,
                        maxbonddim=maxbonddim, updatetensors=False)
        self.sweep1site(f, "forward", reltol=reltol, abstol=abstol,
                        maxbonddim=maxbonddim, updatetensors=True)

    # -- 2-site pivot update (tensorci2.jl:825-930) ---------------------------

    def updatepivots(
        self,
        b: int,
        f,
        leftorthogonal: bool,
        reltol: float = 1e-14,
        abstol: float = 0.0,
        maxbonddim: int = _INTMAX,
        sweepdirection: str = "forward",
        pivotsearch: str = "full",
        verbosity: int = 0,
        extraIset: Sequence[MultiIndex] = (),
        extraJset: Sequence[MultiIndex] = (),
    ) -> None:
        if pivotsearch not in ("full", "rook"):
            raise ValueError(
                f"Unknown pivot search strategy {pivotsearch}. "
                "Choose from rook, full."
            )
        self.invalidatesitetensors()
        Icombined = _union(
            kronecker_is(self.Iset[b], self.localdims[b]), extraIset
        )
        Jcombined = _union(
            kronecker_sj(self.localdims[b + 1], self.Jset[b + 1]), extraJset
        )
        if pivotsearch == "rook":
            luci = self._rook_luci(b, f, Icombined, Jcombined,
                                   leftorthogonal, reltol, abstol,
                                   maxbonddim)
        elif getattr(f, "fused_updater", None) is not None:
            # Π sampling, rrLU and CI factors on the evaluator's device, one
            # fetch of the pivot record; the factors are only formed when
            # they become site tensors (non-strict-nesting sweeps discard
            # them, tensorci2.jl:923-926)
            need_factors = len(extraIset) == 0 and len(extraJset) == 0
            (left, right, rowind, colind, perrs, err, maxsample) = (
                f.fused_updater.update(
                    Icombined, Jcombined, reltol, abstol, maxbonddim,
                    leftorthogonal, need_factors=need_factors,
                )
            )
            self.updatemaxsample(maxsample)
            self.Iset[b + 1] = [Icombined[i] for i in rowind]
            self.Jset[b] = [Jcombined[j] for j in colind]
            if need_factors:
                self.setsitetensor(b, to_device(left, self.device))
                self.setsitetensor(b + 1, to_device(right, self.device))
            self.updateerrors(b, perrs)
            return
        else:
            t1 = time.time()
            Pi = filltensor(
                self.dtype, f, self.localdims, Icombined, Jcombined, 0,
                self.device,
            ).reshape(len(Icombined), len(Jcombined))
            t2 = time.time()
            self.updatemaxsample(Pi)
            luci = MatrixLUCI(
                Pi, reltol=reltol, abstol=abstol, maxrank=maxbonddim,
                leftorthogonal=leftorthogonal,
            )
            t3 = time.time()
            if verbosity > 2:
                print(
                    f"    Computing Pi ({len(Icombined)} x {len(Jcombined)}) "
                    f"at bond {b}: {t2 - t1:.3f} sec, LU: {t3 - t2:.3f} sec"
                )
        self.Iset[b + 1] = [Icombined[i] for i in luci.rowindices()]
        self.Jset[b] = [Jcombined[j] for j in luci.colindices()]
        if len(extraIset) == 0 and len(extraJset) == 0:
            self.setsitetensor(b, to_device(luci.left(), self.device))
            self.setsitetensor(b + 1, to_device(luci.right(), self.device))
        self.updateerrors(b, luci.pivoterrors())

    def _rook_luci(self, b, f, Icombined, Jcombined, leftorthogonal, reltol,
                   abstol, maxbonddim) -> MatrixLUCI:
        """One bond's rook factorization (tensorci2.jl:856-906;
        ``tci_tpu``'s rook branch of updatepivots). An evaluator with a
        ``panel_sampler`` takes the device tier: Π sampled on its device,
        then ``rrlu_rook_device_fused`` there (an f32 hunt and an f64
        completion for a real panel), with a slab width that starts near
        the continuation rank and doubles on a rank-capped result (the
        reference's widen-and-retry loop, matrixlu.jl:512-548). Otherwise
        the host tier: ``arrlu`` on a ``SubMatrix`` of f, each slab
        factorized on the TCI's device. A bond that finds no pivot falls
        back to full search (tensorci2.jl:892-906)."""
        Iset_pos = {idx: pos for pos, idx in enumerate(Icombined)}
        Jset_pos = {idx: pos for pos, idx in enumerate(Jcombined)}
        I0 = [Iset_pos[i] for i in self.Iset[b + 1] if i in Iset_pos]
        J0 = [Jset_pos[j] for j in self.Jset[b] if j in Jset_pos]
        sampler = getattr(f, "panel_sampler", None)
        if (getattr(f, "fused_updater", None) is not None
                and not getattr(self, "_rook_tier_warned", False)):
            # reached only when the whole-sweep rook program declined (a
            # rank above the engine's capacity), as in tci_tpu
            import warnings

            warnings.warn(
                "pivotsearch='rook' is running the per-bond rook tier "
                "(the whole-sweep rook program declined this "
                "configuration). For a torch-traceable integrand, "
                "pivotsearch='full' is typically far faster because "
                "the whole sweep runs as one device program.",
                RuntimeWarning,
                stacklevel=4,
            )
            self._rook_tier_warned = True
        if sampler is not None:
            from ..ops.lu_device import rrlu_rook_device_fused

            Pi_dev, maxsample = sampler.sample(Icombined, Jcombined)
            m_p, n_p = Pi_dev.shape
            cap = int(min(maxbonddim, m_p, n_p))
            mixed = Pi_dev.dtype == torch.float64
            # one deflated re-hunt when the tolerance is below one f32
            # hunt's resolution (tci_tpu's rule: ROADMAP C-ref-1, C-ref-2)
            scale = float(abs(maxsample)) if maxsample else 0.0
            deep = (0 < reltol < 1e-6) or (
                scale > 0 and 0 < abstol < 1e-6 * scale)
            width = min(cap, max(16, 2 * max(len(I0), len(J0), 1)))
            rng = getattr(self, "rng", None) or np.random.default_rng()
            wI0, wJ0 = I0, J0
            while True:
                dev = rrlu_rook_device_fused(
                    Pi_dev, maxrank=width, reltol=reltol, abstol=abstol,
                    leftorthogonal=leftorthogonal, rng=rng, I0=wI0, J0=wJ0,
                    precision="mixed" if mixed else "f64",
                    hunt_stages=2 if (mixed and deep) else 1,
                )
                if dev.npivots() < width or width >= cap:
                    break
                # rank-capped below the true cap: widen, warm-started from
                # the pivots just found
                wI0 = [int(i) for i in dev.rowindices()]
                wJ0 = [int(j) for j in dev.colindices()]
                width = min(cap, 2 * width)
            luci = MatrixLUCI(lu=dev.to_rrlu())
            self.updatemaxsample(maxsample)
        else:
            Pif = SubMatrix(f, Icombined, Jcombined, self.dtype)
            luci = MatrixLUCI(
                f=Pif, valuetype=self.dtype,
                matrixsize=(len(Icombined), len(Jcombined)), I0=I0, J0=J0,
                reltol=reltol, abstol=abstol, maxrank=maxbonddim,
                leftorthogonal=leftorthogonal, pivotsearch="rook",
                usebatcheval=True, device=self.device,
            )
            self.updatemaxsample(Pif.maxsamplevalue)
        if luci.npivots() == 0:
            # fall back to full search (tensorci2.jl:892-906)
            Pi = filltensor(
                self.dtype, f, self.localdims, Icombined, Jcombined, 0,
                self.device,
            ).reshape(len(Icombined), len(Jcombined))
            self.updatemaxsample(Pi)
            luci = MatrixLUCI(
                Pi, reltol=reltol, abstol=abstol, maxrank=maxbonddim,
                leftorthogonal=leftorthogonal,
            )
        return luci

    # -- 2-site sweep (tensorci2.jl:1195-1258) --------------------------------

    def sweep2site(
        self,
        f,
        niter: int,
        iter1: int = 1,
        abstol: float = 1e-8,
        maxbonddim: int = _INTMAX,
        sweepstrategy: str = "backandforth",
        pivotsearch: str = "full",
        verbosity: int = 0,
        strictlynested: bool = False,
        fillsitetensors: bool = True,
        _search_starts=None,
    ) -> None:
        self.invalidatesitetensors()
        n = len(self)
        engine = getattr(f, "device_sweep_engine", None)
        engine_filled = False
        self._pair_search = None
        if (niter == 2 and engine is not None and engine.use_sweep_pair
                and pivotsearch in ("full", "rook") and fillsitetensors):
            # one optimize iteration, both sweeps and the fill, as one
            # program with one fetch (DeviceSweepEngine.sweep2site_pair),
            # which keeps the history itself; with _search_starts (from
            # optimize) the global-pivot candidate search runs in it too.
            # When the engine declines, the per-sweep loop below runs.
            extraIset: List[List[MultiIndex]] = [[] for _ in range(n)]
            extraJset: List[List[MultiIndex]] = [[] for _ in range(n)]
            if not strictlynested and len(self.Iset_history) > 0:
                extraIset = self.Iset_history[-1]
                extraJset = self.Jset_history[-1]
            self.flushpivoterror()
            if engine.sweep2site_pair(
                self, forwardsweep(sweepstrategy, iter1),
                forwardsweep(sweepstrategy, iter1 + 1), 1e-14, abstol,
                maxbonddim, extraIset, extraJset, pivotsearch=pivotsearch,
                strictlynested=strictlynested, search_starts=_search_starts,
            ):
                self._pair_search = engine.last_search
                return
        for it in range(iter1, iter1 + niter):
            extraIset: List[List[MultiIndex]] = [[] for _ in range(n)]
            extraJset: List[List[MultiIndex]] = [[] for _ in range(n)]
            if not strictlynested and len(self.Iset_history) > 0:
                extraIset = self.Iset_history[-1]
                extraJset = self.Jset_history[-1]

            self.Iset_history.append([list(s) for s in self.Iset])
            self.Jset_history.append([list(s) for s in self.Jset])

            self.flushpivoterror()
            fwd = forwardsweep(sweepstrategy, it)
            if pivotsearch in ("full", "rook") and engine is not None:
                # the whole sweep on the device (rook: the slab alternation
                # of every bond in the same program), one fetch at its end; on the
                # final sweep the site-tensor fill runs on the same device
                # state before that fetch. Falls back to the per-bond path
                # when the rank exceeds the engine's capacity.
                want_fill = fillsitetensors and it == iter1 + niter - 1
                # drop what a per-bond sweep of this call may have set
                self.invalidatesitetensors()
                if engine.sweep2site(
                    self, fwd, 1e-14, abstol, maxbonddim,
                    extraIset, extraJset, pivotsearch=pivotsearch,
                    fill_sites=want_fill,
                ):
                    engine_filled = want_fill
                    continue
            if fwd:
                brange, leftorth, direction = range(n - 1), True, "forward"
            else:
                brange, leftorth, direction = (
                    range(n - 2, -1, -1), False, "backward")
            for b in brange:
                self.updatepivots(
                    b, f, leftorth,
                    abstol=abstol, maxbonddim=maxbonddim,
                    sweepdirection=direction, pivotsearch=pivotsearch,
                    verbosity=verbosity,
                    extraIset=extraIset[b + 1],
                    extraJset=extraJset[b],
                )
        if fillsitetensors and not engine_filled:
            self.fillsitetensors(f)

    def _optimize_device_block(self, engine, finder, tol, normalizeerror,
                               maxbonddim, strictlynested, sweepstrategy,
                               all_starts, it, maxiter, errors, ranks,
                               nglobalpivots, ncheckhistory,
                               checkconvglobalpivot, pivotsearch="full"):
        """Up to ``engine.loop_kmax`` optimize iterations as one block on
        the device (``DeviceSweepEngine.optimize_loop``), then the
        per-iteration bookkeeping replayed from its stacked outputs.

        Returns None when the engine declines (the caller runs this
        iteration on the per-iteration path), else (niter, stop): niter
        iterations were accounted for (0: the first one saturated the
        capacity, which grew, so try again) and stop says the convergence
        criterion held."""
        n = len(self)
        k_budget = min(maxiter - it + 1, engine.loop_kmax)
        sb = None
        if all_starts is not None:
            sb = np.asarray(all_starts[it - 1:it - 1 + k_budget],
                            dtype=np.int64)
        extraIset: List[List[MultiIndex]] = [[] for _ in range(n)]
        extraJset: List[List[MultiIndex]] = [[] for _ in range(n)]
        if not strictlynested and len(self.Iset_history) > 0:
            extraIset = self.Iset_history[-1]
            extraJset = self.Jset_history[-1]
        res = engine.optimize_loop(
            self, forwardsweep(sweepstrategy, 1),
            forwardsweep(sweepstrategy, 2), 1e-14, tol, normalizeerror,
            maxbonddim, extraIset, extraJset, strictlynested, sb,
            finder.tolmarginglobalsearch, errors, ranks, nglobalpivots,
            ncheckhistory, checkconvglobalpivot, k_budget,
            pivotsearch=pivotsearch,
        )
        if res is None:
            return None
        K_done, code = res["k"], res["code"]
        if K_done == 0:
            # the first iteration saturated the capacity: grow and retry;
            # when it cannot grow the block declines
            if code == 2 and engine._grow(maxbonddim):
                return (0, False)
            return None
        with span("tci.tci2.writeback"):
            return self._write_device_block(
                engine, finder, res, maxbonddim, all_starts, it, errors,
                ranks, nglobalpivots, ncheckhistory, checkconvglobalpivot,
                sb is not None)

    def _write_device_block(self, engine, finder, res, maxbonddim,
                            all_starts, it, errors, ranks, nglobalpivots,
                            ncheckhistory, checkconvglobalpivot, searched):
        """The per-iteration bookkeeping of a block replayed from its result
        ``res`` (``_optimize_device_block``): the index sets, histories,
        errors and stats. Each iteration's wall is its loop step's (from the
        step's run until its status is on the host); the sweeps and the
        search run inside that step, so the loop path has no wall of them
        apart (nan)."""
        n = len(self)
        K_done, code = res["k"], res["code"]
        prefix = list(range(n))
        suffix = [n - b - 1 for b in range(n)]
        with span("tci.engine.unpack"):
            for j in range(K_done):
                for h in (0, 1):
                    self.Iset_history.append(engine._unpack(
                        res["hI"][j, h], res["hIl"][j, h], prefix))
                    self.Jset_history.append(engine._unpack(
                        res["hJ"][j, h], res["hJl"][j, h], suffix))
            self.Iset = engine._unpack(res["I"], res["Il"], prefix)
            self.Jset = engine._unpack(res["J"], res["Jl"], suffix)
        self.maxsamplevalue = max(self.maxsamplevalue, float(res["ms"][0]))
        self.invalidatesitetensors()
        self.flushpivoterror()
        for b in range(n - 1):
            self.updateerrors(
                b, list(res["perrs"][b][:int(res["Il"][b + 1]) + 1]))
        engine._store_sitetensors(self, res["cores"])
        engine.last_sweep_filled = True
        # every iteration of the block ran two sweeps, a fill and, with
        # start points, the search; the rook sweeps count their slabs on
        # the device
        if "nev" in res:
            engine.nevals += int(res["nev"])
        else:
            engine._count_sweeps(2 * K_done)
        for _ in range(K_done):
            engine._count_fill()
        if searched:
            engine.nevals += (K_done * finder.nsearch * n
                              * max(self.localdims))

        abstol_exit = float(res["abstol"][0])
        for j in range(K_done):
            errors.append(float(res["oerr"][j]))
            if code == 1 and j == K_done - 1:
                with span("tci.tci2.globalpivots"):
                    pivots = finder.select_device_result(
                        all_starts[it - 1 + j], res["bflat"], res["berr"],
                        max(self.localdims), abstol_exit)
                    self.addglobalpivots(pivots)
                nglobalpivots.append(len(pivots))
                ranks.append(self.rank())
            else:
                nglobalpivots.append(0)
                ranks.append(int(res["orank"][j]))
            self.stats["sweep_walltime"].append(float("nan"))
            self.stats["globalsearch_walltime"].append(float("nan"))
            self.stats["iteration_walltime"].append(res["step_walls"][j])
            self.stats["ranks"].append(ranks[-1])
            self.stats["errors"].append(errors[-1])
            self.stats["nglobalpivots"].append(nglobalpivots[-1])
        stop = False
        if code == 0:
            stop = True
        elif code == 1:
            stop = convergencecriterion(
                ranks, errors, nglobalpivots, abstol_exit, maxbonddim,
                ncheckhistory, checkconvglobalpivot=checkconvglobalpivot)
        elif code == 2:
            # saturated after at least one whole iteration: those are
            # accounted for above; grow (if it can) and enter again
            engine._grow(maxbonddim)
        return (K_done, stop)

    # -- main optimization loop (tensorci2.jl:1018-1172) ----------------------

    def optimize(
        self,
        f,
        tolerance: Optional[float] = None,
        pivottolerance: Optional[float] = None,
        maxbonddim: int = _INTMAX,
        maxiter: int = 20,
        sweepstrategy: str = "backandforth",
        pivotsearch: str = "full",
        verbosity: int = 0,
        loginterval: int = 10,
        normalizeerror: bool = True,
        ncheckhistory: int = 3,
        globalpivotfinder=None,
        maxnglobalpivot: int = 5,
        nsearchglobalpivot: int = 5,
        tolmarginglobalsearch: float = 10.0,
        strictlynested: bool = False,
        checkbatchevaluatable: bool = False,
        checkconvglobalpivot: bool = True,
        rng: Optional[np.random.Generator] = None,
        profile_dir: Optional[str] = None,
    ):
        """Returns (ranks, errors) per iteration; `self.stats` holds the
        per-iteration wall times (seconds), ranks, errors and global pivot
        counts. On the per-iteration path ``iteration_walltime`` is each
        iteration's host wall, ``sweep_walltime`` its 2-site sweeps' and
        ``globalsearch_walltime`` its global-pivot search's. In the engine's
        blocks (``_optimize_device_block``) ``iteration_walltime`` is the
        iteration's loop step, from its run until its status is on the
        host; the sweeps and the search run inside that step, so those two
        hold nan there.

        With `profile_dir` a ``torch.profiler`` (the CPU, and CUDA where
        present) records the optimization, and its Chrome trace, with the
        port's ``tci.*`` spans (``utils/trace.py``), is written there."""
        if profile_dir is not None:
            # the same call under a profiler that writes its trace there
            args = dict(locals(), profile_dir=None)
            del args["self"]
            with profiled(profile_dir):
                return self.optimize(**args)
        import warnings

        count_rrlu(self.device)
        if checkbatchevaluatable and not isbatchevaluable(f):
            raise ValueError("Function `f` is not batch evaluatable")
        if nsearchglobalpivot > 0 and nsearchglobalpivot < maxnglobalpivot:
            raise ValueError("nsearchglobalpivot < maxnglobalpivot!")

        if pivottolerance is not None:
            if tolerance is not None and tolerance != pivottolerance:
                raise ValueError(
                    "Got different values for pivottolerance and tolerance in "
                    "optimize (TCI2). Both options have the same meaning; "
                    "please assign only `tolerance`."
                )
            warnings.warn(
                "The option `pivottolerance` of `optimize` is deprecated. "
                "Please use `tolerance` instead.",
                DeprecationWarning,
            )
            tol = pivottolerance
        elif tolerance is not None:
            tol = tolerance
        else:
            tol = 1e-8

        if maxbonddim >= _INTMAX and tol <= 0:
            raise ValueError(
                "Specify either tolerance > 0 or some maxbonddim; otherwise, "
                "the convergence criterion is not reachable!"
            )
        if rng is None:
            # on a mesh the evaluator's ranks draw from one seed (rank 0's)
            rng = mesh_rng(getattr(f, "mesh", None))
        # the per-bond device rook tier fills its start sets from it, so a
        # caller's rng makes the run repeatable
        self.rng = rng

        tstart = time.time()
        finder = globalpivotfinder or DefaultGlobalPivotFinder(
            nsearch=nsearchglobalpivot,
            maxnglobalpivot=maxnglobalpivot,
            tolmarginglobalsearch=tolmarginglobalsearch,
        )
        self.stats = {
            "iteration_walltime": [],
            "sweep_walltime": [],
            "globalsearch_walltime": [],
            "ranks": [],
            "errors": [],
            "nglobalpivots": [],
        }
        # With the stock finder all start points are drawn upfront, in the
        # finder's own per-iteration rng order, exactly as tci_tpu does, so
        # a shared seed gives both packages, and every tier (the host
        # finder, the search in the sweep pair, the optimize loop), the same
        # start points for an iteration.
        default_finder = type(finder) is DefaultGlobalPivotFinder
        with span("tci.tci2.starts"):
            all_starts = (
                [finder.draw_starts(self.localdims, rng)
                 for _ in range(maxiter)]
                if default_finder and finder.nsearch > 0 else None
            )
        engine = getattr(f, "device_sweep_engine", None)
        # iterations that add no global pivot are state transitions on the
        # device: the engine runs blocks of them and returns to the host
        # for a global pivot, a capacity growth or convergence
        fused_loop_ok = (verbosity == 0 and default_finder
                         and pivotsearch in ("full", "rook")
                         and engine is not None and engine.use_optimize_loop)

        errors: List[float] = []
        ranks: List[int] = []
        nglobalpivots: List[int] = []
        it = 1
        while it <= maxiter:
            titer = time.time()
            errornormalization = self.maxsamplevalue if normalizeerror else 1.0
            abstol = tol * errornormalization

            if fused_loop_ok:
                with span("tci.tci2.block"):
                    blk = self._optimize_device_block(
                        engine, finder, tol, normalizeerror, maxbonddim,
                        strictlynested, sweepstrategy, all_starts, it,
                        maxiter, errors, ranks, nglobalpivots, ncheckhistory,
                        checkconvglobalpivot, pivotsearch=pivotsearch)
                if blk is not None:
                    it += blk[0]
                    if blk[1]:
                        break
                    continue

            if verbosity > 1:
                print(f"  Walltime {time.time() - tstart:.3f} sec: "
                      "starting 2site sweep")
            starts = all_starts[it - 1] if all_starts is not None else None
            tsweep = time.time()
            with span("tci.tci2.sweep2site"):
                self.sweep2site(
                    f, 2, iter1=1,
                    abstol=abstol, maxbonddim=maxbonddim,
                    pivotsearch=pivotsearch, strictlynested=strictlynested,
                    verbosity=verbosity, sweepstrategy=sweepstrategy,
                    fillsitetensors=True, _search_starts=starts,
                )
            self.stats["sweep_walltime"].append(time.time() - tsweep)
            errors.append(self.pivoterror())

            tsearch = time.time()
            with span("tci.tci2.globalpivots"):
                if starts is not None and self._pair_search is not None:
                    # the search already ran inside the sweep pair's program
                    best_flat, best_err = self._pair_search
                    globalpivots = finder.select_device_result(
                        starts, best_flat, best_err, max(self.localdims),
                        abstol, verbosity=verbosity)
                else:
                    input_ = GlobalPivotSearchInput.from_tci(self)
                    points = ({} if starts is None
                              else {"initial_points": starts})
                    globalpivots = finder(input_, f, abstol,
                                          verbosity=verbosity, rng=rng,
                                          **points)
                self.addglobalpivots(globalpivots)
            nglobalpivots.append(len(globalpivots))
            self.stats["globalsearch_walltime"].append(time.time() - tsearch)

            ranks.append(self.rank())
            self.stats["iteration_walltime"].append(time.time() - titer)
            self.stats["ranks"].append(ranks[-1])
            self.stats["errors"].append(errors[-1])
            self.stats["nglobalpivots"].append(len(globalpivots))
            if verbosity > 0 and it % loginterval == 0:
                print(
                    f"iteration = {it}, rank = {ranks[-1]}, "
                    f"error= {errors[-1]}, "
                    f"maxsamplevalue= {self.maxsamplevalue}, "
                    f"nglobalpivot={len(globalpivots)}"
                )
            if convergencecriterion(
                ranks, errors, nglobalpivots, abstol, maxbonddim,
                ncheckhistory, checkconvglobalpivot=checkconvglobalpivot,
            ):
                break
            it += 1

        # Remove unnecessary pivots added by global pivot insertion and
        # compute site tensors (tensorci2.jl:1157-1167)
        errornormalization = self.maxsamplevalue if normalizeerror else 1.0
        abstol = tol * errornormalization
        with span("tci.tci2.sweep1site"):
            self.sweep1site(f, abstol=abstol, maxbonddim=maxbonddim)
            _sanitycheck(self)
        return ranks, [e / errornormalization for e in errors]


def _call_f(f, x):
    """Call f at one multi-index whether it is plain or a BatchEvaluator."""
    if isbatchevaluable(f) and hasattr(f, "evaluate_single"):
        return f.evaluate_single(tuple(x))
    return f(tuple(x))


def reconstructglobalpivotsfromijset(localdims, Isets, Jsets):
    """(tensorci2.jl:303-320)"""
    pivots: List[MultiIndex] = []
    for i in range(len(Isets)):
        for I in Isets[i]:
            for J in Jsets[i]:
                for j in range(localdims[i]):
                    pushunique(pivots, tuple(I) + (j,) + tuple(J))
    return pivots


def convergencecriterion(
    ranks: Sequence[int],
    errors: Sequence[float],
    nglobalpivots: Sequence[int],
    tolerance: float,
    maxbonddim: int,
    ncheckhistory: int,
    checkconvglobalpivot: bool = True,
) -> bool:
    """(tensorci2.jl:947-966)"""
    if len(errors) < ncheckhistory:
        return False
    lastranks = list(ranks[-ncheckhistory:])
    lastngpivots = list(nglobalpivots[-ncheckhistory:])
    converged = (
        all(e < tolerance for e in errors[-ncheckhistory:])
        and (all(g == 0 for g in lastngpivots) if checkconvglobalpivot else True)
        and min(lastranks) == lastranks[-1]
    )
    return converged or all(r >= maxbonddim for r in lastranks)


def _sanitycheck(tci: TensorCI2) -> bool:
    """(globalsearch.jl:226-233)"""
    for b in range(len(tci) - 1):
        if len(tci.Iset[b + 1]) != len(tci.Jset[b]):
            raise ValueError(f"Pivot matrix at bond {b} is not square!")
    return True


def crossinterpolate2(
    valuetype,
    f,
    localdims: Sequence[int],
    initialpivots: Optional[Sequence[Sequence[int]]] = None,
    device=None,
    profile_dir: Optional[str] = None,
    **kwargs,
):
    """Cross-interpolate f by TCI2 (tensorci2.jl:1313-1323).

    Runs on `device`: the current CUDA device by default; without one it
    raises unless ``device="cpu"`` is given. f may sample anywhere (a plain
    callable or a ``VectorizedBatchEvaluator`` on the host, a
    ``TorchBatchEvaluator`` on its device); its panels are moved to
    `device`. Returns (tci, ranks, errors). With `profile_dir` the whole
    call is recorded by a ``torch.profiler`` and its Chrome trace written
    there (``TensorCI2.optimize``). Other keyword arguments are forwarded
    to TensorCI2.optimize.
    """
    with profiled(profile_dir):
        begin_solve(resolve_device(device))
        with span("tci.tci2.init"):
            tci = TensorCI2.from_function(f, localdims, initialpivots,
                                          dtype=valuetype, device=device)
        ranks, errors = tci.optimize(f, **kwargs)
    return tci, ranks, errors


def searchglobalpivots(
    tci: TensorCI2,
    f,
    abstol: float,
    verbosity: int = 0,
    nsearch: int = 100,
    maxnglobalpivot: int = 5,
    rng: Optional[np.random.Generator] = None,
) -> List[MultiIndex]:
    """Find pivots where the interpolation error exceeds abstol
    (tensorci2.jl:1344-1384).

    All nsearch starts run in lock-step: with an evaluator that has the
    engine, the whole floating-zone search is the engine's program
    (``DeviceSweepEngine.floatingzone``); otherwise, or when the engine
    declines, the host lock-step search (``globalsearch._floatingzone_batch``,
    one batched f call and one batched TT evaluation a leg round). Results
    are taken in start order with the reference's maxnglobalpivot early
    stop."""
    from .globalsearch import _floatingzone_search

    if nsearch == 0 or maxnglobalpivot == 0:
        return []
    if not tci.issitetensorsavailable():
        tci.fillsitetensors(f)
    if rng is None:
        rng = mesh_rng(getattr(f, "mesh", None))

    initps = [
        tuple(int(rng.integers(0, d)) for d in tci.localdims)
        for _ in range(nsearch)
    ]
    results = _floatingzone_search(
        TensorTrain(tci.sitetensors()), f, initps,
        earlystoptol=10 * abstol, nsweeps=100,
    )
    pivots = {}
    for pivot, error in results:
        if error > abstol:
            pivots[error] = pivot
        if len(pivots) == maxnglobalpivot:
            break

    if len(pivots) == 0:
        if verbosity > 1:
            print("  No global pivot found")
        return []
    if verbosity > 1:
        maxerr = max(pivots.keys())
        print(f"  Found {len(pivots)} global pivots: max error {maxerr}")
    return list(pivots.values())
