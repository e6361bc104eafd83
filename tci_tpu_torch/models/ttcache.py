"""TT evaluator with left/right environment memoization.

Counterpart of ``tci_tpu/models/ttcache.py`` (parity reference:
src/cachedtensortrain.jl: TTCache :63-104, evalleft :165-193, evalright
:215-243, batch call :290-323). A TTCache is itself a BatchEvaluator, so a
TT can be re-cross-interpolated, and the sequential floating-zone search
samples the TT through it.

The cores and the cached environments are tensors on one device; the
caches are dicts keyed by index prefixes / suffixes (tuples of ints).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.batcheval import BatchEvaluator, _infer_ncent
from ..utils.util import projector_to_slice
from .tensortrain import TensorTrain


class TTCache(BatchEvaluator):
    """Takes a tensor train or its site tensors; numpy cores go to `device`
    (the current CUDA device by default; a RuntimeError without one unless
    ``device="cpu"`` is given), tensors stay on their device."""

    def __init__(self, sitetensors_or_tt, sitedims: Optional[Sequence] = None,
                 device=None):
        if hasattr(sitetensors_or_tt, "sitetensors"):
            tensors = sitetensors_or_tt.sitetensors()
            if sitedims is None:
                sitedims = sitetensors_or_tt.sitedims()
        else:
            tensors = list(sitetensors_or_tt)
            if sitedims is None:
                sitedims = [list(t.shape[1:-1]) for t in tensors]
        if len(tensors) != len(sitedims):
            raise ValueError(
                "The number of site tensors and site dimensions must match."
            )
        for n, t in enumerate(tensors):
            if int(np.prod(sitedims[n])) != int(np.prod(t.shape[1:-1])):
                raise ValueError(
                    f"Site dimensions do not match the site tensor at {n}."
                )
        tensors = TensorTrain(tensors, device=device).sitetensors()
        self.sitetensors: List[torch.Tensor] = [
            t.reshape(t.shape[0], -1, t.shape[-1]) for t in tensors
        ]
        self.device = self.sitetensors[0].device
        self._sitedims = [list(d) for d in sitedims]
        self.cacheleft: List[Dict[Tuple, torch.Tensor]] = [
            {} for _ in self.sitetensors
        ]
        self.cacheright: List[Dict[Tuple, torch.Tensor]] = [
            {} for _ in self.sitetensors
        ]

    def sitedims(self) -> List[List[int]]:
        return self._sitedims

    def __len__(self) -> int:
        return len(self.sitetensors)

    def _one(self) -> torch.Tensor:
        return torch.ones(1, dtype=self.sitetensors[0].dtype,
                          device=self.device)

    def evalleft(self, indexset) -> torch.Tensor:
        k = len(indexset)
        if k == 0:
            return self._one()
        key = tuple(int(i) for i in indexset)
        cache = self.cacheleft[k - 1]
        hit = cache.get(key)
        if hit is not None:
            return hit
        result = self.evalleft(key[:-1]) @ self.sitetensors[k - 1][:, key[-1], :]
        cache[key] = result
        return result

    def evalright(self, indexset) -> torch.Tensor:
        if len(indexset) == 0:
            return self._one()
        k = len(self) - len(indexset)  # position of the first involved tensor
        key = tuple(int(i) for i in indexset)
        cache = self.cacheright[k]
        hit = cache.get(key)
        if hit is not None:
            return hit
        result = self.sitetensors[k][:, key[0], :] @ self.evalright(key[1:])
        cache[key] = result
        return result

    def evaluate(self, indexset, usecache: bool = True):
        """The TT at one multi-index (ints, or a tuple per multi-leg site,
        fused in C order); a Python scalar."""
        if len(indexset) != len(self):
            raise ValueError("Index length mismatch.")
        if len(indexset) and isinstance(indexset[0], (list, tuple)):
            indexset = [
                int(np.ravel_multi_index(tuple(mi), tuple(self._sitedims[l])))
                for l, mi in enumerate(indexset)
            ]
        if usecache:
            return self.evalleft(tuple(indexset))[0].item()
        v = None
        for T, i in zip(self.sitetensors, indexset):
            mat = T[:, int(i), :]
            v = mat if v is None else v @ mat
        return v[0, 0].item()

    def __call__(self, *args):
        if len(args) == 1:
            return self.evaluate(args[0])
        return self.batch_evaluate(*args)

    def evaluate_single(self, indexset):
        return self.evaluate(indexset)

    def batch_evaluate(self, leftindexset, rightindexset, ncent=None,
                       projector=None) -> torch.Tensor:
        """The TT on left x center x right products, a tensor on the cores'
        device, optionally with a per-center-site projector (0 = free leg,
        v = fixed to value v-1)."""
        localdims = [int(np.prod(d)) for d in self._sitedims]
        ncent = _infer_ncent(localdims, leftindexset, rightindexset, ncent)
        nl = len(leftindexset[0]) if leftindexset else 0
        if len(leftindexset) * len(rightindexset) == 0:
            return torch.zeros(
                (len(leftindexset),)
                + tuple(localdims[nl + i] for i in range(ncent))
                + (len(rightindexset),),
                dtype=self.sitetensors[0].dtype, device=self.device)

        # left environments (|I|, chi) and right environments (chi, |J|)
        lenv = torch.stack([self.evalleft(tuple(l)) for l in leftindexset])
        renv = torch.stack([self.evalright(tuple(r)) for r in rightindexset],
                           dim=-1)

        # contract the center sites one by one: obj (|I|, d..., chi)
        obj = lenv[:, None, :]
        returndims = []
        for pos in range(ncent):
            T = self.sitetensors[nl + pos]
            if projector is not None:
                # a per-leg projector over this site's legs (1-based, 0 =
                # free) reduces the fused site leg
                sdims = self._sitedims[nl + pos]
                T = T.reshape(T.shape[0], *sdims, T.shape[-1])
                slices, _ = projector_to_slice(projector[pos])
                T = T[(slice(None), *slices, slice(None))]
                T = T.reshape(T.shape[0], -1, T.shape[-1])
            obj = torch.einsum("bca,adr->bcdr", obj, T).reshape(
                obj.shape[0], -1, T.shape[-1])
            returndims.append(T.shape[1])

        res = torch.einsum("bca,aj->bcj", obj, renv)
        return res.reshape(len(leftindexset), *returndims,
                           len(rightindexset))
