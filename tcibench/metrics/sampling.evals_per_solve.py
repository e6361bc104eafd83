"""Samples of f a solve (``TorchBatchEvaluator.nevals``; the device tiers
count padded panels, so compare it within one tier)."""


def read(run):
    n = [s.counters["evals"] for s in run.solves
         if s.counters.get("evals") is not None]
    return sum(n) / len(n) if n else None
