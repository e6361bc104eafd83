"""True-error estimation by floating-zone coordinate search.

Counterpart of ``tci_tpu/models/globalsearch.py`` (parity reference:
src/globalsearch.jl: estimatetrueerror :52-83, _floatingzone :119-186).
The search runs where the TT lives: with an evaluator that has the
whole-sweep engine, as one program of the engine
(``DeviceSweepEngine.floatingzone``); otherwise as the host lock-step search
``_floatingzone_batch``, whose per-leg f and TT evaluations are batched and
whose bookkeeping (pivots, running maxima, which starts are active) is on
the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.batcheval import evaluate_rows
from ..parallel.mesh import mesh_rng
from ..utils.device import to_device
from .tensortrain import TensorTrain
from .tteval import chi_bucket, max_bond, pad_cores, tt_evaluate_batched
from .ttcache import TTCache

MultiIndex = Tuple[int, ...]


def estimatetrueerror(
    tt,
    f,
    nsearch: int = 100,
    initialpoints: Optional[Sequence[MultiIndex]] = None,
    rng: Optional[np.random.Generator] = None,
    device=None,
) -> List[Tuple[MultiIndex, float]]:
    """Floating-zone search for large-interpolation-error points; returns
    unique (pivot, error) pairs sorted by error descending.

    `tt` is a tensor train or its site tensors: numpy cores go to `device`
    (the current CUDA device by default; a RuntimeError without one unless
    ``device="cpu"`` is given), tensors stay where they are. All starts
    advance in lock-step, with identical per-start trajectories to the
    reference's sequential search (globalsearch.jl:52-83)."""
    if nsearch <= 0 and initialpoints is None:
        raise ValueError("No search is performed")
    if nsearch < 0:
        raise ValueError("nsearch must be non-negative")
    tt = TensorTrain(tt, device=device)
    if rng is None:
        rng = mesh_rng(getattr(f, "mesh", None))

    if initialpoints is None and nsearch > 0:
        dims = [d[0] for d in tt.sitedims()]
        initialpoints = [
            tuple(int(rng.integers(0, d)) for d in dims) for _ in range(nsearch)
        ]

    pivoterror = _floatingzone_search(tt, f, initialpoints)
    pivoterror.sort(key=lambda pe: -pe[1])
    seen = set()
    out = []
    for p, e in pivoterror:
        if (p, e) not in seen:
            seen.add((p, e))
            out.append((p, e))
    return out


def _floatingzone_search(
    tt: TensorTrain,
    f,
    initialpoints: Sequence[MultiIndex],
    earlystoptol: float = float("inf"),
    nsweeps: int = 2**62,
) -> List[Tuple[MultiIndex, float]]:
    """The floating-zone search from every start, as (pivot, error) in
    start order: the engine's program where f carries the whole-sweep
    engine and the engine takes this train, else (no engine, or the engine
    declines) the host lock-step search."""
    engine = getattr(f, "device_sweep_engine", None)
    if engine is not None and len(initialpoints) > 0:
        dev = engine.floatingzone(
            tt.sitetensors(),
            np.asarray([list(p) for p in initialpoints], dtype=np.int64),
            nsweeps=nsweeps, earlystoptol=earlystoptol,
        )
        if dev is not None:
            pivots, maxerr = dev
            return [(tuple(int(x) for x in pivots[s]), float(maxerr[s]))
                    for s in range(len(initialpoints))]
    return _floatingzone_batch(tt, f, initialpoints, earlystoptol, nsweeps)


def _floatingzone_batch(
    tt: TensorTrain,
    f,
    initialpoints: Sequence[MultiIndex],
    earlystoptol: float = float("inf"),
    nsweeps: int = 2**62,
) -> List[Tuple[MultiIndex, float]]:
    """Lock-step batched coordinate sweeps maximizing |f - tt|.

    Each start follows exactly the sequential _floatingzone trajectory
    (same leg order, same first-max argmax, same stop rule); batching only
    changes how the evaluations are dispatched. Per leg round, one f call
    (where f samples) and one TT evaluation (on the TT's device) over
    every active start's candidates, and one read-back of their errors."""
    S = len(initialpoints)
    if S == 0:
        return []
    localdims = [d[0] for d in tt.sitedims()]
    n = len(localdims)
    tensors = tt.sitetensors()
    dtype, device = tensors[0].dtype, tensors[0].device
    pivots = np.asarray([list(p) for p in initialpoints], dtype=np.int64)
    # padded as the engine's program pads them, so that the two searches
    # evaluate the TT alike
    cores = pad_cores(tensors, chi=chi_bucket(max_bond(tensors)))

    def abs_err(rows: np.ndarray) -> np.ndarray:
        tv = tt_evaluate_batched(cores, to_device(rows, device))
        fv = evaluate_rows(f, rows, dtype=dtype).to(device)
        return (fv - tv).abs().to(torch.float64).cpu().numpy()

    maxerr = abs_err(pivots)
    active = np.ones(S, dtype=bool)

    for _ in range(min(nsweeps, 10**9)):
        prev = maxerr.copy()
        for ipos in range(n):
            act = np.flatnonzero(active)
            if act.size == 0:
                break
            d = localdims[ipos]
            cand = np.repeat(pivots[act], d, axis=0)
            cand[:, ipos] = np.tile(np.arange(d), act.size)
            err = abs_err(cand).reshape(act.size, d)
            best = np.argmax(err, axis=1)  # first max, like np.argmax 1-D
            pivots[act, ipos] = best
            maxerr[act] = np.maximum(
                maxerr[act], err[np.arange(act.size), best])
        done = (maxerr == prev) | (maxerr > earlystoptol)
        active &= ~done
        if not active.any():
            break

    return [
        (tuple(int(x) for x in pivots[s]), float(maxerr[s])) for s in range(S)
    ]


def _floatingzone(
    ttcache: TTCache,
    f,
    earlystoptol: float = float("inf"),
    nsweeps: int = 2**62,
    initp: Optional[MultiIndex] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[MultiIndex, float]:
    """Coordinate sweep maximizing |f - tt| from one start
    (globalsearch.jl:119-186), sampling the TT through its cache."""
    from .tensorci2 import _call_f, filltensor

    if nsweeps <= 0:
        raise ValueError("nsweeps should be positive!")
    if rng is None:
        rng = np.random.default_rng()

    localdims = [d[0] for d in ttcache.sitedims()]
    n = len(ttcache)
    if initp is None:
        pivot = [int(rng.integers(0, d)) for d in localdims]
    else:
        pivot = list(initp)

    dtype = ttcache.sitetensors[0].dtype
    device = ttcache.device
    maxerror = abs(_call_f(f, pivot) - ttcache.evaluate(pivot))

    for _ in range(min(nsweeps, 10**9)):
        prev_maxerror = maxerror
        for ipos in range(n):
            sides = ([tuple(pivot[:ipos])], [tuple(pivot[ipos + 1:])], 1,
                     device)
            exactdata = filltensor(dtype, f, localdims, *sides)
            prediction = filltensor(dtype, ttcache, localdims, *sides)
            err = (exactdata - prediction).abs().reshape(-1).cpu().numpy()
            pivot[ipos] = int(np.argmax(err))
            maxerror = max(float(np.max(err)), maxerror)
        if maxerror == prev_maxerror or maxerror > earlystoptol:
            break

    return tuple(pivot), maxerror
