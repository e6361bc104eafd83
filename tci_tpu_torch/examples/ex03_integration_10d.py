"""10-D integration: Gauss-Kronrod grids x TCI2 x factorized sum.

The reference's flagship application (integration.jl; test_integration.jl
:29-38): the integral over [-1, 1]^10 of an oscillatory integrand whose
value is known. Two paths: host-sampled (``vectorized=True``), and
``torch_native=True``, where the weighted integrand samples on the device
through whole-sweep programs. ``integrate`` takes a batched f there, (B, N)
coordinates to (B,) values; a scalar g of one coordinate vector goes in as
``torch.func.vmap(g)``.
"""

import time

import numpy as np
import torch

import tci_tpu_torch as tci
from tci_tpu_torch.examples import device_arg

N = 10
REFVALUE = -5.4960415218049  # reference test_integration.jl:35


def f(X):
    # vectorized=True: f receives a (B, N) coordinate batch and returns (B,)
    # values, so each panel is ONE numpy call instead of B Python calls
    return 1000 * np.cos(10 * np.sum(X**2, axis=1)) * np.exp(
        -np.sum(X, axis=1) ** 4 / 1000
    )


def g(x):  # one coordinate vector, written with torch operations
    return 1000 * torch.cos(10 * torch.sum(x**2)) * torch.exp(
        -torch.sum(x) ** 4 / 1000
    )


def main(argv=None):
    device = device_arg(__doc__.splitlines()[0], argv)
    t0 = time.time()
    val = tci.integrate(
        np.float64, f, [-1.0] * N, [1.0] * N,
        GKorder=15, tolerance=1e-8, maxbonddim=64, vectorized=True,
        device=device,
    )
    t_host = time.time() - t0
    print(f"host path:   {val:.10f}  ({t_host:.1f} s)")
    assert abs(val - REFVALUE) < 1e-3

    t0 = time.time()
    val_dev = tci.integrate(
        np.float64, torch.func.vmap(g), [-1.0] * N, [1.0] * N,
        GKorder=15, tolerance=1e-8, maxbonddim=64, torch_native=True,
        device=device,
    )
    t_dev = time.time() - t0
    print(f"device path: {val_dev:.10f}  ({t_dev:.1f} s)")
    assert abs(val_dev - REFVALUE) < 1e-3
    print("ok")


if __name__ == "__main__":
    main()
