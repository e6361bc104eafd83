"""Quickstart: TCI of the 8-D Lorentzian (reference README.md:21-43).

f(v) = 1 / (1 + v·v) on the grid {0..9}^8: 10^8 points, learned from a few
hundred thousand adaptively chosen samples. Two ways to supply f:

1. a plain Python callable (sampled point by point on the host; the panels
   are factorized on the device),
2. a torch function of one index vector wrapped by
   ``TorchBatchEvaluator.from_scalar``: the device path, where whole sweeps
   run on the card.
"""

import numpy as np
import torch

import tci_tpu_torch as tci
from tci_tpu_torch.examples import device_arg

localdims = [10] * 8


def f(v):
    v = np.asarray(v, dtype=float)
    return 1.0 / (1.0 + v @ v)


def fscalar(idx):  # idx: int64[8]
    v = idx.to(torch.float64)
    return 1.0 / (1.0 + torch.sum(v * v))


def main(argv=None):
    device = device_arg(__doc__.splitlines()[0], argv)

    # --- 1. host-callable f --------------------------------------------------
    tt, ranks, errors = tci.crossinterpolate2(
        np.float64, f, localdims, tolerance=1e-8, device=device
    )
    print(f"host path:   rank {tt.rank()}, final error {errors[-1]:.2e}")

    pt = (0, 1, 2, 3, 4, 3, 2, 1)
    assert abs(tt(pt) - f(pt)) < 1e-8
    print(f"  tt{pt} = {tt(pt):.12f}   f{pt} = {f(pt):.12f}")

    # factorized sum over all 10^8 grid points: O(L d r^2), no enumeration
    print(f"  sum over the full grid: {tt.sum():.10f}")

    # --- 2. device path: a scalar torch f, vmapped ---------------------------
    bf = tci.TorchBatchEvaluator.from_scalar(fscalar, localdims,
                                             device=device)
    tt2, ranks2, errors2 = tci.crossinterpolate2(
        np.float64, bf, localdims, tolerance=1e-8, device=device
    )
    print(f"device path: rank {tt2.rank()}, final error {errors2[-1]:.2e}, "
          f"{bf.nevals:,} samples")
    assert abs(tt2(pt) - f(pt)) < 1e-8
    assert abs(tt2.sum() - tt.sum()) < 1e-6 * abs(tt.sum())
    print("ok")


if __name__ == "__main__":
    main()
