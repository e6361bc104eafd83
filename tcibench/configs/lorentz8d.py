"""The upstream quickstart as a family over a (the solver).

f_a(v) = 1 / (a + sum_i v_i^2) on {1..d}^N (0-based indices idx, v = idx +
1), interpolated by ``tci_tpu_torch.crossinterpolate2`` through a
``TorchBatchEvaluator``. With a kept closure (mix ``"closure": "kept"``) one
evaluator serves every solve and a lives in a 0-d device tensor that f closes
over and that is set in place before each solve, so the engine only replays
its graphs; with ``"fresh"`` every solve gets a new f (a baked in as a Python
float) and a new evaluator.
"""

from __future__ import annotations

import numpy as np
import torch

from tci_tpu_torch.models import tensorci2
from tci_tpu_torch.parallel.batcheval import TorchBatchEvaluator


def function(a):
    """f_a on an (B, N) int64 index tensor; a a 0-d tensor or a float."""
    def f(idx):
        return 1.0 / (a + ((idx.to(torch.float64) + 1) ** 2).sum(1))
    return f


class Solver:
    def __init__(self, cfg, mix, device, valuetype):
        self.cfg, self.device, self.valuetype = cfg, device, valuetype
        self.dims = [cfg["localdim"]] * cfg["ndim"]
        self.kept = mix["closure"] == "kept"
        self.a = torch.zeros((), dtype=torch.float64, device=device)
        self.ev = self._evaluator(function(self.a)) if self.kept else None

    def _evaluator(self, f):
        dtype = torch.from_numpy(np.zeros(0, dtype=self.valuetype)).dtype
        return TorchBatchEvaluator(f, self.dims, dtype=dtype,
                                   device=self.device)

    def solve(self, a, rng):
        """The site tensors of the TensorCI2 of f_a. Only they are kept: a
        run that held every solve's TensorCI2 (its index sets are lists of
        tuples) would grow the heap that Python's collector walks."""
        if self.kept:
            self.a.fill_(a)
        else:
            self.ev = self._evaluator(function(float(a)))
        tci, _, _ = tensorci2.crossinterpolate2(
            self.valuetype, self.ev, self.dims,
            tolerance=self.cfg["tolerance"], device=self.device, rng=rng)
        return list(tci.sitetensors())

    def evaluator(self):
        return self.ev

    @staticmethod
    def to_host(answer):
        return [t.detach().to("cpu").numpy() for t in answer]
