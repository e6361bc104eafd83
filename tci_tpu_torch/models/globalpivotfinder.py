"""Pluggable global pivot search (parity: src/globalpivotfinder.jl).

Counterpart of ``tci_tpu/models/globalpivotfinder.py``. The default finder
does one coordinate-descent pass maximizing |f - tt| from random starting
points, keeping points whose error exceeds abstol * tolmarginglobalsearch.
The candidates are evaluated in one batched f call and one batched TT
evaluation where f and the TT live; only the errors come back to the host.
Start points come from a ``numpy.random.Generator``, the stream ``tci_tpu``
draws from, so trajectories of the two packages can match.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..parallel.batcheval import evaluate_rows
from ..parallel.mesh import mesh_rng
from .tensortrain import TensorTrain

MultiIndex = Tuple[int, ...]


class GlobalPivotSearchInput:
    """State snapshot handed to global pivot finders
    (globalpivotfinder.jl:33-68)."""

    def __init__(
        self,
        localdims: Sequence[int],
        current_tt: TensorTrain,
        maxsamplevalue: float,
        Iset: Sequence[Sequence[MultiIndex]],
        Jset: Sequence[Sequence[MultiIndex]],
    ):
        self.localdims = list(localdims)
        self.current_tt = current_tt
        self.maxsamplevalue = float(maxsamplevalue)
        self.Iset = [list(s) for s in Iset]
        self.Jset = [list(s) for s in Jset]

    @classmethod
    def from_tci(cls, tci) -> "GlobalPivotSearchInput":
        return cls(
            tci.localdims,
            TensorTrain(tci.sitetensors()),
            tci.maxsamplevalue,
            tci.Iset,
            tci.Jset,
        )


class AbstractGlobalPivotFinder:
    def __call__(
        self,
        input: GlobalPivotSearchInput,
        f,
        abstol: float,
        verbosity: int = 0,
        rng: Optional[np.random.Generator] = None,
    ) -> List[MultiIndex]:
        raise NotImplementedError(
            f"find_global_pivots not implemented for {type(self)}"
        )


class DefaultGlobalPivotFinder(AbstractGlobalPivotFinder):
    """Random starts + one coordinate-descent pass maximizing |f - tt|
    (globalpivotfinder.jl:145-265)."""

    def __init__(
        self,
        nsearch: int = 5,
        maxnglobalpivot: int = 5,
        tolmarginglobalsearch: float = 10.0,
    ):
        self.nsearch = nsearch
        self.maxnglobalpivot = maxnglobalpivot
        self.tolmarginglobalsearch = tolmarginglobalsearch

    def draw_starts(
        self, localdims: Sequence[int], rng: np.random.Generator
    ) -> List[MultiIndex]:
        """The finder's random start points (same rng stream order as
        ``tci_tpu``)."""
        L = len(localdims)
        return [
            tuple(int(rng.integers(0, localdims[p])) for p in range(L))
            for _ in range(self.nsearch)
        ]

    def select_device_result(
        self,
        starts: Sequence[MultiIndex],
        best_flat: np.ndarray,
        best_err: np.ndarray,
        dmax: int,
        abstol: float,
        verbosity: int = 0,
    ) -> List[MultiIndex]:
        """The pivots of the engine's in-program search
        (``device_sweep._tt_search_on_cores``: per start, the first maximum
        as leg * dmax + value, and its error), with the threshold and the
        cap of ``__call__``."""
        found: List[MultiIndex] = []
        for s, point in enumerate(starts):
            if float(best_err[s]) > abstol * self.tolmarginglobalsearch:
                p, v = divmod(int(best_flat[s]), dmax)
                best_point = list(point)
                best_point[p] = v
                found.append(tuple(best_point))
        if len(found) > self.maxnglobalpivot:
            found = found[: self.maxnglobalpivot]
        if verbosity > 0:
            print(f"Found {len(found)} global pivots")
        return found

    def __call__(
        self,
        input: GlobalPivotSearchInput,
        f,
        abstol: float,
        verbosity: int = 0,
        rng: Optional[np.random.Generator] = None,
        initial_points: Optional[Sequence[MultiIndex]] = None,
    ) -> List[MultiIndex]:
        if rng is None:
            rng = mesh_rng(getattr(f, "mesh", None))
        L = len(input.localdims)
        localdims = input.localdims
        tt = input.current_tt

        if initial_points is None:
            initial_points = self.draw_starts(localdims, rng)
        if not initial_points:
            return []

        # Each start point probes every single-coordinate variant
        # (globalpivotfinder.jl:217-252); the candidate set is known upfront.
        cands = []
        offsets = []  # (start_idx, p, v) per row
        for s, point in enumerate(initial_points):
            for p in range(L):
                for v in range(localdims[p]):
                    row = list(point)
                    row[p] = v
                    cands.append(row)
                    offsets.append((s, p, v))
        cands = np.asarray(cands, dtype=np.int64)
        ttvals = tt.evaluate_batch(cands)
        # f's values in the train's dtype: a complex f keeps its imaginary
        # part, and a real search is not promoted to complex
        fvals = evaluate_rows(f, cands, dtype=ttvals.dtype).to(ttvals.device)
        errors = (fvals - ttvals).abs().cpu().numpy()

        found: List[MultiIndex] = []
        r = 0
        nrows = sum(localdims)
        for s, point in enumerate(initial_points):
            errs = errors[r : r + nrows]
            # first strict maximum in (p, v) iteration order
            best = int(np.argmax(errs))
            best_error = float(errs[best])
            _, p, v = offsets[r + best]
            best_point = list(point)
            best_point[p] = v
            r += nrows
            if best_error > abstol * self.tolmarginglobalsearch:
                found.append(tuple(best_point))

        if len(found) > self.maxnglobalpivot:
            found = found[: self.maxnglobalpivot]
        if verbosity > 0:
            print(f"Found {len(found)} global pivots")
        return found
