"""Generic helpers used across the TCI stack.

Parity reference: src/util.jl (maxabs :34-43, padzero :70-72, pushunique! :94-119,
isconstant :140-146, randomsubset :173-191, pushrandomsubset! :214-219,
optfirstpivot :260-298, replacenothing :321-327, projector_to_slice :365-369).

All indices here are 0-based.
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple, TypeVar

import numpy as np

T = TypeVar("T")

MultiIndex = Tuple[int, ...]


def maxabs(maxval: float, updates) -> float:
    """Running maximum of |x| over `updates`, seeded with `maxval`."""
    arr = np.asarray(updates)
    if arr.size == 0:
        return abs(maxval)
    return max(abs(maxval), float(np.max(np.abs(arr))))


def padzero(a: Sequence[float]) -> Iterator[float]:
    """Iterator yielding the elements of `a` followed by infinitely many zeros."""
    return itertools.chain(a, itertools.repeat(0))


def pushunique(collection: list, *items) -> None:
    """Append each item to `collection` unless already present (order-preserving)."""
    for item in items:
        if item not in collection:
            collection.append(item)


def isconstant(collection: Iterable) -> bool:
    """True if all elements compare equal (or the collection is empty)."""
    it = iter(collection)
    try:
        c = next(it)
    except StopIteration:
        return True
    return all(x == c for x in it)


def randomsubset(
    items: Sequence[T], n: int, rng: Optional[np.random.Generator] = None
) -> list:
    """Choose `n` distinct elements of `items` uniformly at random (without
    replacement); returns all of them shuffled if n >= len(items)."""
    if rng is None:
        rng = np.random.default_rng()
    items = list(items)
    n = min(n, len(items))
    if n <= 0:
        return []
    idx = rng.permutation(len(items))[:n]
    return [items[i] for i in idx]


def pushrandomsubset(
    subset: list, items: Sequence[T], n: int, rng: Optional[np.random.Generator] = None
) -> None:
    """Append `n` random elements of `items` not yet in `subset` to `subset`."""
    candidates = [x for x in items if x not in subset]
    subset.extend(randomsubset(candidates, n, rng))


def optfirstpivot(
    f: Callable[[MultiIndex], complex],
    localdims: Sequence[int],
    firstpivot: Optional[Sequence[int]] = None,
    maxsweep: int = 1000,
) -> list:
    """Coordinate-ascent search for a pivot maximizing |f| (src/util.jl:260-298).

    Starting from `firstpivot` (default all-zeros), sweeps each leg over all its
    values, keeping any change that increases |f|, until a full sweep brings no
    improvement or `maxsweep` sweeps elapse. Indices are 0-based.

    When f is batch-evaluable (the reference leaves this as a TODO at
    src/util.jl:270), each leg's full candidate column is fetched with ONE
    protocol call ``f([prefix], [suffix], 1)`` — for a Contraction this hits
    the environment caches, for a TorchBatchEvaluator it is one device
    call — and the sequential accept-if-greater scan replays on the
    fetched values, so the trajectory is identical to the scalar path.
    """
    from ..parallel.batcheval import isbatchevaluable

    n = len(localdims)
    if firstpivot is None:
        pivot = [0] * n
    else:
        pivot = list(firstpivot)
    valf = abs(f(pivot))
    batched = isbatchevaluable(f)

    for _ in range(maxsweep):
        valf_prev = valf
        for i in range(n):
            if batched:
                vals = np.abs(
                    _host(
                        f([tuple(pivot[:i])], [tuple(pivot[i + 1:])], 1)
                    ).reshape(-1)
                )
                if len(vals) != localdims[i]:
                    raise ValueError(
                        f"batch evaluator returned {len(vals)} values for "
                        f"leg {i}, but localdims[{i}] = {localdims[i]}: the "
                        "evaluator's own localdims disagree with the "
                        "localdims passed to optfirstpivot."
                    )
                for d in range(localdims[i]):
                    if vals[d] > valf:
                        valf = vals[d]
                        pivot[i] = d
            else:
                for d in range(localdims[i]):
                    bak = pivot[i]
                    pivot[i] = d
                    newval = abs(f(pivot))
                    if newval > valf:
                        valf = newval
                    else:
                        pivot[i] = bak
        if valf_prev == valf:
            break

    return pivot


def _host(values) -> np.ndarray:
    """Values returned by an evaluator, as a host array (device tensors are
    copied back)."""
    if hasattr(values, "detach"):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def replacenothing(value, default):
    """Return `default` when value is None, otherwise `value`."""
    return default if value is None else value


def projector_to_slice(p: Sequence[int]):
    """Convert a projector vector into (slice list, reshape spec).

    0 marks a free leg (full slice); a nonzero value v projects that leg to
    index v-1 (the reference is 1-based; here the projector stays 1-based so 0
    can mean "free", matching src/util.jl:365-369 and contraction.jl usage).

    Returns (slices, shape) where slices index an array (free -> slice(None),
    projected -> the 0-based index) and shape gives per-leg output extents
    (free -> None meaning "keep", projected -> 1).
    """
    slices = [slice(None) if x == 0 else x - 1 for x in p]
    shape = [None if x == 0 else 1 for x in p]
    return slices, shape
