"""Complex-valued TCI end to end (BASELINE config 5 pattern).

A Feynman-type complex integrand exp(i·Σv)/(1+|v|²) learned by TCI2, on
the host path and on the device path. torch on the card computes in
complex128 natively, so the device path's f returns complex values.
"""

import numpy as np
import torch

import tci_tpu_torch as tci
from tci_tpu_torch.examples import device_arg

localdims = [6] * 6


def fpy(x):
    v = np.asarray(x, dtype=float) + 1.0
    return np.exp(1j * v.sum()) / (1.0 + v @ v)


def fscalar(idx):  # one index vector to a complex128 value
    v = idx.to(torch.float64) + 1.0
    return torch.polar(1.0 / (1.0 + torch.sum(v * v)), torch.sum(v))


def main(argv=None):
    device = device_arg(__doc__.splitlines()[0], argv)

    # --- host complex path ---------------------------------------------------
    tt, ranks, errors = tci.crossinterpolate2(
        np.complex128, fpy, localdims, tolerance=1e-7, device=device
    )
    print(f"host path:   rank {tt.rank()}, final error {errors[-1]:.2e}")

    # --- device path in complex128 -------------------------------------------
    bf = tci.TorchBatchEvaluator.from_scalar(fscalar, localdims,
                                             dtype=torch.complex128,
                                             device=device)
    tt2, ranks2, errors2 = tci.crossinterpolate2(
        np.complex128, bf, localdims, tolerance=1e-7, device=device
    )
    print(f"device path: rank {tt2.rank()}, final error {errors2[-1]:.2e}, "
          f"{bf.nevals:,} samples")

    for pt in [(0, 0, 0, 0, 0, 0), (1, 2, 3, 4, 5, 0), (5, 4, 3, 2, 1, 0)]:
        assert abs(tt(pt) - fpy(pt)) < 1e-6
        assert abs(tt2(pt) - fpy(pt)) < 1e-6
    print("pointwise complex checks ok")
    print("ok")


if __name__ == "__main__":
    main()
