"""The upstream benchmark notebook's random function as a family over the
table's seed (the solver).

f(sigma) = T[sum_i sigma_i d^i] on {0 .. d-1}^L, T a table of d^L values
drawn uniformly from [-1, 1] by ``numpy.random.default_rng(table_seed)``,
interpolated by ``tci_tpu_torch.crossinterpolate2`` through a
``TorchBatchEvaluator`` at the bond cap ``maxbonddim``. f closes over the
table as a device tensor. With a kept closure (mix ``"closure": "kept"``)
one evaluator serves every solve and the table is refilled in place before
each (a draw on the host and one copy of d^L float64 to the device, inside
the solve), so the engine only replays its graphs; with ``"fresh"`` every
solve gets a new table tensor and a new evaluator.

A random table has no low-rank structure, so every solve runs until the
rank reaches the cap. The program has to carry that rank on its whole-sweep
engine: a program whose engine cannot hold a capacity of ``maxbonddim``
(``DeviceSweepEngine.capacity_limit``) is refused when the solver is made.
"""

from __future__ import annotations

import numpy as np
import torch

from tci_tpu_torch.models import tensorci2
from tci_tpu_torch.parallel.batcheval import TorchBatchEvaluator


def draw_table(table_seed: int, size: int) -> np.ndarray:
    """T, as the reference draws it."""
    return np.random.default_rng(int(table_seed)).uniform(-1.0, 1.0, size)


def function(table, L: int, d: int):
    """f on an (B, L) int64 index tensor: the table at sum_i idx_i d^i."""
    place = d ** torch.arange(L, dtype=torch.int64, device=table.device)

    def f(idx):
        return table[(idx * place).sum(1)]
    return f


class Solver:
    def __init__(self, cfg, mix, device, valuetype):
        self.cfg, self.device, self.valuetype = cfg, device, valuetype
        self.L, self.d = cfg["nsites"], cfg["localdim"]
        self.dims = [self.d] * self.L
        self.kept = mix["closure"] == "kept"
        self.table, self.ev = self._evaluator()

    def _evaluator(self):
        table = torch.zeros(self.d ** self.L, dtype=torch.float64,
                            device=self.device)
        dtype = torch.from_numpy(np.zeros(0, dtype=self.valuetype)).dtype
        ev = TorchBatchEvaluator(function(table, self.L, self.d), self.dims,
                                 dtype=dtype, device=self.device)
        limit = getattr(ev.device_sweep_engine, "capacity_limit", None)
        if limit is None or limit() < self.cfg["maxbonddim"]:
            raise RuntimeError(
                f"random_l20_d1000 needs a whole-sweep engine that holds "
                f"rank {self.cfg['maxbonddim']} at d = {self.d}; this "
                f"program's stops at "
                f"{limit() if limit else ev.device_sweep_engine.imax_cap}")
        return table, ev

    def solve(self, table_seed, rng):
        """The site tensors of the TensorCI2 of the table drawn from
        `table_seed` (its integer part), and its pivot sets as int64 arrays
        (Iset[b] (n, b), Jset[b] (n, L - b - 1)): only arrays are kept, as
        lorentz8d's solver keeps only the cores. The cores are copied out
        of the engine's padded buffer (20 x 1024 x 2 x 1024 values at rank
        1000, 335 MB), so that a window's answers hold ~22 MB a solve."""
        if not self.kept:
            self.table, self.ev = self._evaluator()
        self.table.copy_(torch.from_numpy(
            draw_table(int(table_seed), self.d ** self.L)))
        cfg = self.cfg
        tci, _, _ = tensorci2.crossinterpolate2(
            self.valuetype, self.ev, self.dims, tolerance=cfg["tolerance"],
            maxbonddim=cfg["maxbonddim"], maxiter=cfg["maxiter"],
            nsearchglobalpivot=cfg["nsearchglobalpivot"],
            ncheckhistory=cfg["ncheckhistory"], device=self.device, rng=rng)
        L = self.L
        Isets = [np.asarray(s, dtype=np.int64).reshape(len(s), b)
                 for b, s in enumerate(tci.Iset)]
        Jsets = [np.asarray(s, dtype=np.int64).reshape(len(s), L - b - 1)
                 for b, s in enumerate(tci.Jset)]
        return [t.clone() for t in tci.sitetensors()], Isets, Jsets

    def evaluator(self):
        return self.ev

    @staticmethod
    def to_host(answer):
        cores, Isets, Jsets = answer
        return [t.detach().to("cpu").numpy() for t in cores], Isets, Jsets
