"""BASELINE config 3 at small depths: quantics TCI of cos(100 x) exp(-x)
on a 2^R grid (benchmarks/bench_quantics.py at R = 8 and 12 instead of 40),
tolerance 1e-10, on the CPU.

So that every run sees the same sample bits, all three sample through one
numpy function: tci_tpu through a ``VectorizedBatchEvaluator`` (its host
tier), the port through a ``VectorizedBatchEvaluator`` (host tier) and
through a ``TorchBatchEvaluator`` whose f wraps the numpy function (the
whole-sweep engine, which config 3 runs on the card).

Tolerances: ranks series and pivot sets identical; errors to 1e-15 absolute
(normalized), the rounding of the Schur updates
(tests/test_torch_tensorci2.py); the spot check of bench_quantics.py:59-65
through the port's ``DiscretizedGrid`` below 1e-9.
"""

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu_torch.utils.quantics import DiscretizedGrid

torch.set_num_threads(1)

TOL = 1e-10


def _fnp(R):
    weights = np.asarray([2.0 ** -(r + 1) for r in range(R)])

    def f(bits):
        x = np.asarray(bits, dtype=np.float64) @ weights
        return np.cos(100.0 * x) * np.exp(-x)

    return f


def _solve(R, tier):
    f, dims = _fnp(R), [2] * R
    rng = np.random.default_rng(0)
    if tier == "tci_tpu":
        bf = tci_tpu.VectorizedBatchEvaluator(f, dims)
        return tci_tpu.crossinterpolate2(np.float64, bf, dims, tolerance=TOL,
                                         rng=rng), bf
    if tier == "host":
        bf = tci_tpu_torch.VectorizedBatchEvaluator(f, dims)
    else:
        bf = tci_tpu_torch.TorchBatchEvaluator(
            lambda idx: torch.from_numpy(f(idx.numpy())), dims, device="cpu")
    return tci_tpu_torch.crossinterpolate2(
        np.float64, bf, dims, tolerance=TOL, rng=rng, device="cpu"), bf


@pytest.mark.parametrize("tier", ["host", "engine"])
@pytest.mark.parametrize("R", [8, 12])
def test_quantics_tci_matches_tci_tpu(R, tier):
    (ref, rranks, rerrs), _ = _solve(R, "tci_tpu")
    (out, oranks, oerrs), bf = _solve(R, tier)
    assert oranks == rranks
    assert out.Iset == ref.Iset and out.Jset == ref.Jset
    np.testing.assert_allclose(oerrs, rerrs, rtol=0, atol=1e-15)
    assert oerrs[-1] < TOL
    if tier == "engine":
        assert bf.device_sweep_engine.rrlu_calls > 0
        assert bf._fused_updater is None
    # the spot check of bench_quantics.py through the port's grid
    grid = DiscretizedGrid(R, 0.0, 1.0)
    assert grid.localdims == [2] * R
    for x in [0.1, 0.25, 0.5, 0.75, 0.9]:
        bits = grid.grididx_to_quantics([int(x * 2**R)])
        xx = grid.quantics_to_origcoord(bits)[0]
        assert abs(out(bits) - np.cos(100 * xx) * np.exp(-xx)) < 1e-9
