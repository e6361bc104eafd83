"""Plain NumPy reference of ``gk15_10d``: the exact sum over the whole
tensor-product GK15 grid, which is what TCI's integral approximates.

The grid has 15^N points (5.8e11 at N = 10), too many to sum one by one. But
f_omega depends on x only through s1 = sum x and s2 = sum x^2. Write
h(s1) = exp(-s1^4 / q) as a Fourier series on a period P that holds every
s1 the grid reaches, h(s) = sum_k c_k exp(2 pi i k s / P). Then, with
cos(omega s2) = Re exp(i omega s2) and h real,

    G(omega) = A Re sum_k c_k phi(k)^N,
    phi(k) = sum_j w_j exp(i omega x_j^2 + 2 pi i k x_j / P),

a sum over the 15 one-dimensional nodes. The c_k come from an FFT of h on
the period; h is entire and falls below 1e-35 at the period's ends, so the
series is exact to rounding. ``tcibench/tests`` holds G against the sum
point by point at N = 3 and 4.

Nothing here comes from ``tci_tpu_torch``: the GK15 nodes and weights are
QUADPACK's ``qk15`` table.
"""

from __future__ import annotations

import numpy as np

# QUADPACK qk15: the Kronrod nodes (the odd entries the 7-point Gauss
# nodes) on [0, 1), largest first, and their weights; the node 0 last
XGK = np.array([
    0.991455371120812639206854697526329, 0.949107912342758524526189684047851,
    0.864864423359769072789712788640926, 0.741531185599394439863864773280788,
    0.586087235467691130294144845693013, 0.405845151377397166906606412076961,
    0.207784955007898467600689403773245, 0.0])
WGK = np.array([
    0.022935322010529224963732008058970, 0.063092092629978553290700663189204,
    0.104790010322250183839876322541518, 0.140653259715525918745189590510238,
    0.169004726639267902826583426598550, 0.190350578064785409913256402421014,
    0.204432940075298892414161999234649, 0.209482141084727828012999174891714])
# points of the FFT over the period
FFT_POINTS = 2048


def gk15(lower: float, upper: float):
    """The 15 GK nodes and weights on [lower, upper]."""
    t = np.concatenate([-XGK[:-1], XGK[::-1]])
    w = np.concatenate([WGK[:-1], WGK[::-1]])
    half = (upper - lower) / 2
    return half * (t + 1) + lower, half * w


def grid_sum(omega: float, cfg: dict) -> float:
    """G(omega): the GK15 grid sum of f_omega, in float64."""
    n, amp, q = cfg["ndim"], cfg["amplitude"], cfg["quartic_scale"]
    x, w = gk15(cfg["lower"], cfg["upper"])
    # |s1| <= smax on the grid; past smax + 3 q^(1/4) h is below e^-81
    smax = n * max(abs(cfg["lower"]), abs(cfg["upper"]))
    half = smax + 3 * q ** 0.25
    period = 2 * half
    s = -half + period * np.arange(FFT_POINTS) / FFT_POINTS
    k = np.fft.fftfreq(FFT_POINTS, 1.0 / FFT_POINTS)
    # c_k = (1/P) int h(s) e^{-2 pi i k s / P} ds over [-half, half)
    c = np.fft.fft(np.exp(-s ** 4 / q)) / FFT_POINTS * np.cos(np.pi * k)
    phi = (w[None, :] * np.exp(1j * omega * x[None, :] ** 2
                                + 2j * np.pi * k[:, None] * x[None, :]
                                / period)).sum(axis=1)
    return float(amp * np.real(np.sum(c * phi ** n)))


def judge(cfg: dict, answers, seed: int) -> dict:
    """The largest absolute gap between a solve's integral and G(omega),
    over every (omega, integral) of the run."""
    return {"integral_abs_err": max(abs(float(val) - grid_sum(omega, cfg))
                                    for omega, val in answers)}
