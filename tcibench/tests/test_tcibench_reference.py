"""The plain references hold against brute force: the GK15 table, the exact
grid sum G(omega) against the point-by-point sum, the tensor-train
contraction against a dense product."""

import itertools

import numpy as np
import pytest

from tcibench import core

GK = core.load_module(core.BENCH / "reference" / "gk15_10d.py", "ref_gk15")
LZ = core.load_module(core.BENCH / "reference" / "lorentz8d.py", "ref_lz")


def test_gk15_table_is_exact_to_degree_22_and_is_the_programs():
    x, w = GK.gk15(-1.0, 1.0)
    for deg in range(23):
        exact = 0.0 if deg % 2 else 2.0 / (deg + 1)
        assert abs((w * x ** deg).sum() - exact) < 1e-14, deg
    from tci_tpu_torch.ops.kronrod import kronrod
    nodes, weights, _ = kronrod(7)
    assert np.allclose(np.sort(nodes), np.sort(x), rtol=0, atol=1e-15)
    assert np.allclose(np.sort(weights), np.sort(w), rtol=0, atol=1e-15)


@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("omega", [9.5, 10.0, 10.5])
def test_grid_sum_is_the_sum_over_every_grid_point(ndim, omega):
    cfg = {"ndim": ndim, "amplitude": 1000.0, "quartic_scale": 1000.0,
           "lower": -1.0, "upper": 1.0}
    x, w = GK.gk15(-1.0, 1.0)
    X = np.array(list(itertools.product(x, repeat=ndim)))
    W = np.prod(np.array(list(itertools.product(w, repeat=ndim))), axis=1)
    brute = (W * 1000 * np.cos(omega * (X ** 2).sum(1))
             * np.exp(-X.sum(1) ** 4 / 1000)).sum()
    assert abs(GK.grid_sum(omega, cfg) - brute) < 1e-11 * max(1, abs(brute))


def test_grid_sum_of_the_upstream_integral():
    cfg = core.json.loads((core.BENCH / "configs" / "gk15_10d.json")
                          .read_text())
    # upstream's TCI value (test_integration.jl) is -5.4960415218049
    assert abs(GK.grid_sum(10.0, cfg) - (-5.4960415218049)) < 1e-3


def test_tt_values_contract_the_cores():
    rng = np.random.default_rng(0)
    cores = [rng.standard_normal((1, 3, 2)), rng.standard_normal((2, 3, 4)),
             rng.standard_normal((4, 3, 1))]
    dense = np.einsum("aib,bjc,ckd->ijk", *cores)
    idx = np.array(list(itertools.product(range(3), repeat=3)))
    assert np.allclose(LZ.tt_values(cores, idx),
                       dense[idx[:, 0], idx[:, 1], idx[:, 2]])
