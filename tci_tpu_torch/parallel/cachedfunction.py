"""Memoizing function wrapper keyed by mixed-radix integer encoding.

Counterpart of ``tci_tpu/parallel/cachedfunction.py`` (parity reference:
src/cachedfunction.jl). Keys are Python ints, which have arbitrary
precision: the reference's UInt32 -> UInt64 -> UInt128 -> UInt256 key-width
ladder collapses to one code path (``keytype_bits`` reports the equivalent
width), and a quantics grid of R = 64 legs or more, whose keys pass 2^63,
needs no wider type. Keys are never torch int64.

The cache lives on the host; the values a batch call returns land on
`device` (the current CUDA device by default; without one the constructor
raises unless ``device="cpu"`` is given).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device, to_device
from .batcheval import (
    BatchEvaluator,
    _assemble_indices,
    _empty_panel,
    _infer_ncent,
    _result_shape,
)


def encodecachekey(coeffs: Sequence[int], indexset) -> int:
    """Mixed-radix encoding: key = Σ_i indexset[i] * coeffs[i] (0-based)."""
    return int(sum(int(i) * int(c) for i, c in zip(indexset, coeffs)))


def decodecachekey(localdims: Sequence[int], key: int) -> tuple:
    """Inverse of encodecachekey for the given dimensions."""
    out = []
    for d in localdims:
        key, r = divmod(key, int(d))
        out.append(int(r))
    return tuple(out)


class CachedFunction(BatchEvaluator):
    def __init__(self, f: Callable, localdims: Sequence[int], dtype=np.float64,
                 device=None):
        self.f = f
        self.localdims = list(localdims)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.cache: Dict[int, complex] = {}
        coeffs: List[int] = [1]
        for d in self.localdims[:-1]:
            coeffs.append(coeffs[-1] * int(d))
        self.coeffs = coeffs

    # -- key machinery ----------------------------------------------------

    def _key(self, indexset) -> int:
        if len(indexset) != len(self.localdims):
            raise ValueError(
                f"Invalid indexset length {len(indexset)}; expected "
                f"{len(self.localdims)}."
            )
        return encodecachekey(self.coeffs, indexset)

    key = _key

    def encodecachekey(self, indexset) -> int:
        return self._key(indexset)

    def decodecachekey(self, key: int):
        return decodecachekey(self.localdims, key)

    @property
    def keytype_bits(self) -> int:
        """Equivalent fixed-width key size the reference would pick
        (cachedfunction.jl:121-138)."""
        log2space = sum(np.log2(d) for d in self.localdims)
        for bits in (32, 64, 128, 256, 512, 1024):
            if log2space < bits - 1:
                return bits
        return 0

    # -- cache access -----------------------------------------------------

    def cacheddata(self):
        """Raw cache dict keyed by encoded integer keys."""
        return self.cache

    def cachedata(self):
        """Cache contents keyed by decoded multi-indices."""
        return {
            decodecachekey(self.localdims, k): v for k, v in self.cache.items()
        }

    def ncacheddata(self) -> int:
        return len(self.cache)

    def cachedindices(self):
        return [decodecachekey(self.localdims, k) for k in self.cache]

    def haskey(self, indexset) -> bool:
        return self._key(indexset) in self.cache

    __contains__ = haskey

    def clearcache(self) -> None:
        self.cache.clear()

    # -- evaluation ---------------------------------------------------------

    def evaluate_single(self, indexset):
        k = self._key(indexset)
        v = self.cache.get(k)
        if v is None and k not in self.cache:
            v = self.f(tuple(int(i) for i in indexset))
            self.cache[k] = v
        return v

    def batch_evaluate(self, Iset, Jset, ncent=None) -> torch.Tensor:
        """f on Iset x (center legs) x Jset, one call of f per point not yet
        cached (one batched call when f has ``evaluate_many``); a tensor on
        this function's device."""
        ncent = _infer_ncent(self.localdims, Iset, Jset, ncent)
        if len(Iset) * len(Jset) == 0:
            return _empty_panel(self.localdims, Iset, Jset, ncent, self.dtype,
                                self.device)
        indices = _assemble_indices(self.localdims, Iset, Jset, ncent,
                                    torch.device("cpu")).numpy()
        B = indices.shape[0]

        # per-batch dedup: keys as Python ints (object arithmetic), only the
        # misses are evaluated
        coeffs = np.array(self.coeffs, dtype=object)
        keys = indices.astype(object) @ coeffs
        vals = np.empty(B, dtype=self.dtype)
        miss_rows = []
        for r in range(B):
            v = self.cache.get(keys[r])
            if v is None and keys[r] not in self.cache:
                miss_rows.append(r)
            else:
                vals[r] = v

        if miss_rows:
            if hasattr(self.f, "evaluate_many"):
                miss_vals = self.f.evaluate_many(indices[miss_rows])
                if isinstance(miss_vals, torch.Tensor):
                    miss_vals = miss_vals.cpu().numpy()
                for r, v in zip(miss_rows, miss_vals.tolist()):
                    self.cache[keys[r]] = v
                    vals[r] = v
            else:
                for r in miss_rows:
                    v = self.f(tuple(int(x) for x in indices[r]))
                    self.cache[keys[r]] = v
                    vals[r] = v

        return to_device(vals, self.device).reshape(
            _result_shape(self.localdims, Iset, Jset, ncent))
