"""The port's Gauss-Kronrod rules (tci_tpu_torch.ops.kronrod) against
tci_tpu's: the same numpy code on the host, so nodes and weights are
compared for equality, bit for bit; and the rule's defining property on the
port alone (a (2n+1)-point rule is exact up to degree 3n+1, tolerance 1e-11
relative as in tests/test_kronrod.py)."""

import numpy as np
import pytest

import tci_tpu
import tci_tpu_torch

ORDERS = [1, 2, 3, 7, 10, 20]


@pytest.mark.parametrize("n", ORDERS)
def test_kronrod_equals_tci_tpu(n):
    out, ref = tci_tpu_torch.kronrod(n), tci_tpu.kronrod(n)
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and np.array_equal(o, r)


@pytest.mark.parametrize("n", ORDERS)
def test_polynomial_exactness(n):
    x, w, gw = tci_tpu_torch.kronrod(n)
    assert len(x) == 2 * n + 1 and len(gw) == n
    for deg in range(3 * n + 2):
        exact = 0.0 if deg % 2 == 1 else 2.0 / (deg + 1)
        assert abs(np.sum(w * x**deg) - exact) < 1e-11 * max(1, abs(exact))
    # not exact beyond 3n+1 (the next even degree)
    deg = 3 * n + 2 if (3 * n + 2) % 2 == 0 else 3 * n + 3
    assert abs(np.sum(w * x**deg) - 2.0 / (deg + 1)) > 1e-17


def test_order_below_one_raises():
    with pytest.raises(ValueError, match="n must be >= 1"):
        tci_tpu_torch.kronrod(0)
