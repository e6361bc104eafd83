"""TCI2: two-site sweep tensor cross interpolation with rrLU pivot selection.

Counterpart of ``tci_tpu/models/tensorci2.py`` (parity reference:
src/tensorci2.jl), full pivoting. The state machine (Iset/Jset per bond as
host lists of tuples, non-strict nesting via set history, 1/2-site sweeps,
global pivot insertion, convergence criterion) is bondwise identical. A TCI
runs on one device, ``TensorCI2.device``: the current CUDA device unless
the caller passes ``device`` (``device="cpu"`` for the CPU).

Like ``tci_tpu``, it takes the device tiers an evaluator offers
(``TorchBatchEvaluator``): the whole-sweep engine (``device_sweep_engine``:
a 2-site sweep, the site-tensor fill and the 1-site sweep with one fetch
each), else the per-bond fused update (``fused_updater``) and the fused
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

import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.luci import MatrixLUCI
from ..parallel.batcheval import _batchevaluate_dispatch, isbatchevaluable
from ..utils.device import resolve_device, to_device, torch_dtype
from ..utils.sweep import forwardsweep
from ..utils.util import padzero, pushunique
from .globalpivotfinder import DefaultGlobalPivotFinder, GlobalPivotSearchInput
from .tensortrain import AbstractTensorTrain

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
        if pivotsearch == "rook":
            raise NotImplementedError(
                "pivotsearch='rook' is not ported yet (ROADMAP A9)")
        if pivotsearch != "full":
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
        if getattr(f, "fused_updater", None) is not None:
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
            self.setsitetensor(b, luci.left())
            self.setsitetensor(b + 1, luci.right())
        self.updateerrors(b, luci.pivoterrors())

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
    ) -> None:
        self.invalidatesitetensors()
        n = len(self)
        engine = getattr(f, "device_sweep_engine", None)
        engine_filled = False
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
            if pivotsearch == "full" and engine is not None:
                # the whole sweep on the device, one fetch at its end; on the
                # final sweep the site-tensor fill runs on the same device
                # state before that fetch. Falls back to the per-bond path
                # when the rank exceeds the engine's capacity.
                want_fill = fillsitetensors and it == iter1 + niter - 1
                # drop what a per-bond sweep of this call may have set
                self.invalidatesitetensors()
                if engine.sweep2site(
                    self, fwd, 1e-14, abstol, maxbonddim,
                    extraIset, extraJset, fill_sites=want_fill,
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
    ):
        """Returns (ranks, errors) per iteration; `self.stats` holds the
        per-iteration wall times, ranks, errors and global pivot counts."""
        import warnings

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
            rng = np.random.default_rng()

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
        # a shared seed gives both packages the same start points.
        all_starts = (
            [finder.draw_starts(self.localdims, rng) for _ in range(maxiter)]
            if type(finder) is DefaultGlobalPivotFinder and finder.nsearch > 0
            else None
        )

        errors: List[float] = []
        ranks: List[int] = []
        nglobalpivots: List[int] = []
        for it in range(1, maxiter + 1):
            titer = time.time()
            errornormalization = self.maxsamplevalue if normalizeerror else 1.0
            abstol = tol * errornormalization

            if verbosity > 1:
                print(f"  Walltime {time.time() - tstart:.3f} sec: "
                      "starting 2site sweep")
            tsweep = time.time()
            self.sweep2site(
                f, 2, iter1=1,
                abstol=abstol, maxbonddim=maxbonddim, pivotsearch=pivotsearch,
                strictlynested=strictlynested, verbosity=verbosity,
                sweepstrategy=sweepstrategy, fillsitetensors=True,
            )
            self.stats["sweep_walltime"].append(time.time() - tsweep)
            errors.append(self.pivoterror())

            tsearch = time.time()
            input_ = GlobalPivotSearchInput.from_tci(self)
            if all_starts is not None:
                globalpivots = finder(input_, f, abstol, verbosity=verbosity,
                                      rng=rng, initial_points=all_starts[it - 1])
            else:
                globalpivots = finder(input_, f, abstol, verbosity=verbosity,
                                      rng=rng)
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

        # Remove unnecessary pivots added by global pivot insertion and
        # compute site tensors (tensorci2.jl:1157-1167)
        errornormalization = self.maxsamplevalue if normalizeerror else 1.0
        abstol = tol * errornormalization
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
    **kwargs,
):
    """Cross-interpolate f by TCI2 (tensorci2.jl:1313-1323).

    Runs on `device`: the current CUDA device by default; without one it
    raises unless ``device="cpu"`` is given. f may sample anywhere (a plain
    callable or a ``VectorizedBatchEvaluator`` on the host, a
    ``TorchBatchEvaluator`` on its device); its panels are moved to
    `device`. Returns (tci, ranks, errors). Other keyword arguments are
    forwarded to TensorCI2.optimize.
    """
    tci = TensorCI2.from_function(f, localdims, initialpivots, dtype=valuetype,
                                  device=device)
    ranks, errors = tci.optimize(f, **kwargs)
    return tci, ranks, errors
