"""Gauss–Kronrod quadrature nodes and weights on [-1, 1].

The port's own copy of ``tci_tpu/ops/kronrod.py``: numpy on the host (a rule
has 2n+1 nodes, 15 by default, so there is nothing for a device to do), the
same code, so the same bits. Replaces QuadGK.kronrod used by the reference's
integration layer (src/integration.jl:93). Implementation: D. P. Laurie, "Calculation of
Gauss-Kronrod quadrature rules", Math. Comp. 66 (1997) — the Jacobi-Kronrod
matrix of the extended rule is built from the Legendre three-term recurrence
coefficients, then nodes/weights follow from Golub-Welsch.

Validated by construction: a (2n+1)-point Gauss-Kronrod rule integrates
polynomials exactly up to degree 3n+1 (tests/test_torch_kronrod.py checks
this).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np


def _legendre_recurrence(N: int) -> Tuple[np.ndarray, np.ndarray]:
    """Three-term recurrence coefficients (a_k, b_k) for Legendre weight on
    [-1, 1]: a_k = 0, b_0 = 2 (the zeroth moment), b_k = k^2/(4k^2 - 1)."""
    a = np.zeros(N)
    b = np.zeros(N)
    b[0] = 2.0
    k = np.arange(1, N)
    b[1:] = k**2 / (4.0 * k**2 - 1.0)
    return a, b


def _r_kronrod(n: int, a0: np.ndarray, b0: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Laurie's algorithm: recurrence coefficients of the Jacobi-Kronrod
    matrix of size 2n+1 from ceil(3n/2)+1 coefficients of the base weight.

    Port of the OPQ routine r_kronrod.m (indices shifted to 0-based)."""
    if len(a0) < int(np.ceil(3 * n / 2)) + 1:
        raise ValueError("need ceil(3n/2)+1 recurrence coefficients")
    a = np.zeros(2 * n + 1)
    b = np.zeros(2 * n + 1)
    k = int(np.floor(3 * n / 2)) + 1
    a[:k] = a0[:k]
    k = int(np.ceil(3 * n / 2)) + 1
    b[:k] = b0[:k]

    s = np.zeros(n // 2 + 2)
    t = np.zeros(n // 2 + 2)
    t[1] = b[n + 1]
    for m in range(n - 1):
        u = 0.0
        for kk in range((m + 1) // 2, -1, -1):
            l = m - kk
            u += (a[kk + n + 1] - a[l]) * t[kk + 1] + b[kk + n + 1] * s[kk] - b[l] * s[kk + 1]
            s[kk + 1] = u
        s, t = t, s
    for j in range(n // 2, -1, -1):
        s[j + 1] = s[j]
    for m in range(n - 1, 2 * n - 2):
        u = 0.0
        j = 0
        for kk in range(m + 1 - n, (m - 1) // 2 + 1):
            l = m - kk
            j = n - 1 - l
            u = (
                u
                - (a[kk + n + 1] - a[l]) * t[j + 1]
                - b[kk + n + 1] * s[j + 1]
                + b[l] * s[j + 2]
            )
            s[j + 1] = u
        if m % 2 == 0:
            kk = m // 2
            a[kk + n + 1] = a[kk] + (s[j + 1] - b[kk + n + 1] * s[j + 2]) / t[j + 2]
        else:
            kk = (m + 1) // 2
            b[kk + n + 1] = s[j + 1] / s[j + 2]
        s, t = t, s
    a[2 * n] = a[n - 1] - b[2 * n] * s[1] / t[1]
    return a, b


@lru_cache(maxsize=None)
def kronrod(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(2n+1)-point Gauss-Kronrod rule on [-1, 1].

    Returns (nodes, kronrod_weights, gauss_weights): all 2n+1 Kronrod nodes in
    increasing order with their Kronrod weights, plus the n embedded Gauss
    weights (at the odd-position nodes), mirroring QuadGK.kronrod's content
    but over the full symmetric rule.
    """
    if n < 1:
        raise ValueError("n must be >= 1")
    ncoef = int(np.ceil(3 * n / 2)) + 1
    a0, b0 = _legendre_recurrence(max(ncoef, 2 * n + 1))
    a, b = _r_kronrod(n, a0.copy(), b0.copy())
    # Golub-Welsch on the (2n+1)-point Jacobi-Kronrod matrix
    J = np.diag(a) + np.diag(np.sqrt(b[1 : 2 * n + 1]), 1) + np.diag(
        np.sqrt(b[1 : 2 * n + 1]), -1
    )
    eigval, eigvec = np.linalg.eigh(J)
    nodes = eigval
    weights = b[0] * eigvec[0, :] ** 2
    order = np.argsort(nodes)
    nodes = nodes[order]
    weights = weights[order]

    # embedded Gauss rule weights (for error estimation parity)
    ag, bg = _legendre_recurrence(n)
    Jg = np.diag(ag) + np.diag(np.sqrt(bg[1:n]), 1) + np.diag(np.sqrt(bg[1:n]), -1)
    egval, egvec = np.linalg.eigh(Jg)
    gw = bg[0] * egvec[0, :] ** 2
    gorder = np.argsort(egval)
    gauss_weights = gw[gorder]

    return nodes, weights, gauss_weights
