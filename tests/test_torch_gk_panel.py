"""The GK panel entry point (``ops/gk_panel``) on the CPU, where the plain
version runs: a Π panel sampled through the evaluator that
``integrate(torch_native=True)`` builds is bitwise the panel that the
index matrix and the weighted integrand's gathers give; an evaluator
without GK tables keeps the index-matrix path; ``integrate`` is bitwise what
it was; the counters count every sample and a replayed graph's points.
The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py -k gk_panel``)."""

import numpy as np
import pytest
import torch

import tci_tpu_torch
from tci_tpu_torch.models import integration
from tci_tpu_torch.models.tensorci2 import crossinterpolate2
from tci_tpu_torch.ops import gk_panel
from tci_tpu_torch.ops.fused import panel_indices, sample_panel
from tci_tpu_torch.ops.kronrod import kronrod
from tci_tpu_torch.utils import trace

CPU = torch.device("cpu")


def _grid(N, order, seed, degenerate=()):
    """GK nodes and weights of `order` on random bounds in N dimensions
    (a_n = b_n for n in `degenerate`), as integrate builds them."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-2.0, 0.0, N)
    b = rng.uniform(0.5, 2.0, N)
    for n in degenerate:
        b[n] = a[n]
    x1, w1, _ = kronrod(order // 2)
    nodes = (b[:, None] - a[:, None]) * (x1[None, :] + 1) / 2 + a[:, None]
    weights = (b[:, None] - a[:, None]) * w1[None, :] / 2
    return nodes, weights, float(order) ** N


def _f(X):
    return torch.cos(3.0 * (X ** 2).sum(1)) * torch.exp(-X.sum(1) ** 2 / 7)


def _weighted_before(f, nodes, weights, normalization):
    """The weighted integrand as integrate built it before the entry point:
    two gathers of the tables by the index matrix and the product of the
    weight columns from left to right."""
    nodes_d = torch.from_numpy(nodes)
    weights_d = torch.from_numpy(weights)
    dims_d = torch.arange(nodes.shape[0])

    def F(idx):
        x = nodes_d[dims_d, idx]
        wn = weights_d[dims_d, idx]
        w = wn[:, 0]
        for n in range(1, wn.shape[1]):
            w = w * wn[:, n]
        return w * f(x) * normalization
    return F


def _sets(rng, K, m, nl, n, nr):
    # rows taken as a prefix of wider buffers, as the engine hands them over
    rows = torch.from_numpy(rng.integers(0, K, size=(m, nl + 2)))[:, :nl]
    cols = torch.from_numpy(rng.integers(0, K, size=(n, nr + 1)))[:, :nr]
    return rows, cols


@pytest.mark.parametrize("order", [15, 31, 61])
@pytest.mark.parametrize("N", [1, 3, 10, 24])
def test_panel_entry_is_bitwise_the_index_matrix_path(N, order):
    nodes, weights, norm = _grid(N, order, seed=N * 100 + order)
    ev = integration._torch_native_evaluator(
        _f, nodes, weights, norm, [order] * N, np.float64, CPU, True, None)
    values = ev._values
    assert callable(getattr(values, "_tci_panel", None))
    before = _weighted_before(_f, nodes, weights, norm)
    rng = np.random.default_rng(N + order)
    for nl in range(N + 1):
        rows, cols = _sets(rng, order, 7, nl, 5, N - nl)
        got = sample_panel(values, rows, cols, torch.float64)
        want = before(panel_indices(rows, cols)).reshape(7, 5)
        assert torch.equal(got, want), nl
        # the empty column set: an index matrix
        idx = panel_indices(rows, cols)
        assert torch.equal(values(idx), before(idx)), nl
        X, W = gk_panel.gk_points(rows, cols, torch.from_numpy(nodes),
                                  torch.from_numpy(weights))
        assert X.shape == (35, N) and W.shape == (35,)
        assert torch.equal(X, torch.from_numpy(nodes)[torch.arange(N), idx])


def test_degenerate_bounds_give_an_exact_zero():
    nodes, weights, norm = _grid(4, 15, seed=3, degenerate=(2,))
    ev = integration._torch_native_evaluator(
        _f, nodes, weights, norm, [15] * 4, np.float64, CPU, True, None)
    rows, cols = _sets(np.random.default_rng(0), 15, 6, 2, 4, 2)
    Pi = sample_panel(ev._values, rows, cols, torch.float64)
    assert (Pi == 0).all()
    want = _weighted_before(_f, nodes, weights, norm)(
        panel_indices(rows, cols)).reshape(6, 4)
    assert torch.equal(Pi.signbit(), want.signbit())


def test_plain_version_checks_the_tables():
    nodes, weights, _ = _grid(3, 15, seed=1)
    rows = torch.zeros((2, 1), dtype=torch.int64)
    cols = torch.zeros((2, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="GK tables"):
        gk_panel.gk_points(rows, cols, torch.from_numpy(nodes),
                           torch.from_numpy(weights))
    with pytest.raises(ValueError, match="CUDA"):
        gk_panel.gk_points_kernel(rows, torch.zeros((2, 2), dtype=torch.int64),
                                  torch.from_numpy(nodes),
                                  torch.from_numpy(weights))


def test_evaluator_without_tables_keeps_the_index_matrix():
    seen = []

    def f(idx):
        seen.append(idx.clone())
        return (idx.to(torch.float64) + 1).prod(1)

    bt = tci_tpu_torch.TorchBatchEvaluator(f, [4] * 5, device="cpu")
    assert not hasattr(bt._values, "_tci_panel")
    rng = np.random.default_rng(5)
    rows, cols = _sets(rng, 4, 6, 2, 3, 3)
    before = (gk_panel.ROWS.copy(), gk_panel.LAUNCHES.copy())
    Pi = sample_panel(bt._values, rows, cols, torch.float64)
    assert len(seen) == 1 and torch.equal(seen[0], panel_indices(rows, cols))
    assert torch.equal(Pi, f(panel_indices(rows, cols)).reshape(6, 3))
    assert (gk_panel.ROWS, gk_panel.LAUNCHES) == before


def test_a_panel_attribute_of_a_user_f_is_not_an_entry_point():
    """Only the private ``_tci_panel`` of integrate's GK integrand is a
    panel entry point: a user's f that happens to carry a ``panel``
    attribute is sampled through the index matrix, and its attribute is
    never called."""
    def f(idx):
        return (idx.to(torch.float64) + 1).sum(1)

    def panel(rows, cols):
        raise AssertionError("a user's panel attribute was called")

    f.panel = panel
    bt = tci_tpu_torch.TorchBatchEvaluator(f, [4] * 4, device="cpu")
    assert not hasattr(bt._values, "_tci_panel")
    rows, cols = _sets(np.random.default_rng(2), 4, 5, 1, 3, 3)
    Pi = sample_panel(bt._values, rows, cols, torch.float64)
    assert torch.equal(Pi, f(panel_indices(rows, cols)).reshape(5, 3))


@pytest.mark.parametrize("bad", [-16, 15])
def test_plain_version_raises_for_an_index_outside_the_table(bad):
    """On the CPU an index outside [-K, K) raises (the kernel clamps it on
    a card and raises its flag instead, ``gk_panel.clamped``)."""
    nodes, weights, _ = _grid(3, 15, seed=4)
    rows, cols = _sets(np.random.default_rng(1), 15, 4, 1, 3, 2)
    cols[1, 0] = bad
    with pytest.raises(IndexError):
        gk_panel.gk_points(rows, cols, torch.from_numpy(nodes),
                           torch.from_numpy(weights))


@pytest.mark.parametrize("N,order", [(3, 15), (2, 31)])
def test_integrate_is_bitwise_the_index_matrix_path(N, order):
    """integrate(torch_native=True) on the CPU against the same TCI2 run on
    the weighted integrand as it was built before: the same integral and
    the same cores, bit for bit; every point f saw counted by gk_panel."""
    a, b = [-1.0] * N, [1.0] * N
    kwargs = dict(tolerance=1e-8, nsearchglobalpivot=10)
    seen = [0]

    def f(X):
        seen[0] += X.shape[0]
        return torch.cos(2.0 * (X ** 2).sum(1)) * torch.exp(-X.sum(1) ** 4
                                                            / 10)

    plain = gk_panel.ROWS["plain"]
    got = integration.integrate(np.float64, f, a, b, GKorder=order,
                                torch_native=True, device="cpu",
                                rng=np.random.default_rng(0), **kwargs)
    assert gk_panel.ROWS["plain"] - plain == seen[0] > 0

    x1, w1, _ = kronrod(order // 2)
    lo, hi = np.asarray(a)[:, None], np.asarray(b)[:, None]
    nodes = (hi - lo) * (x1[None, :] + 1) / 2 + lo
    weights = (hi - lo) * w1[None, :] / 2
    norm = float(order) ** N
    old = tci_tpu_torch.TorchBatchEvaluator(
        _weighted_before(f, nodes, weights, norm), [order] * N,
        device="cpu")
    tci_old, _, _ = crossinterpolate2(np.float64, old, [order] * N,
                                      device="cpu",
                                      rng=np.random.default_rng(0), **kwargs)
    assert got == tci_old.sum() / norm

    new = integration._torch_native_evaluator(
        f, nodes, weights, norm, [order] * N, np.float64, CPU, True, None)
    tci_new, _, _ = crossinterpolate2(np.float64, new, [order] * N,
                                      device="cpu",
                                      rng=np.random.default_rng(0), **kwargs)
    cores_new, cores_old = tci_new.sitetensors(), tci_old.sitetensors()
    assert len(cores_new) == len(cores_old) == N
    for c_new, c_old in zip(cores_new, cores_old):
        assert torch.equal(c_new, c_old)


def test_replayed_graph_counts_what_its_capture_recorded():
    before = (gk_panel.LAUNCHES["gk_panel"], gk_panel.ROWS["gk_panel"],
              gk_panel.TRACED["gk_panel"])
    recorded = gk_panel.Counter(gk_panel=3, rows=4096)
    gk_panel.count_replay(recorded)
    gk_panel.count_replay(gk_panel.Counter())
    assert (gk_panel.LAUNCHES["gk_panel"], gk_panel.ROWS["gk_panel"],
            gk_panel.TRACED["gk_panel"]) == (before[0] + 3, before[1] + 4096,
                                             before[2])
    traced = trace.gk_points_traced()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.
                                            CPU]):
        gk_panel.count_replay(recorded)
    assert gk_panel.TRACED["gk_panel"] == before[2] + 4096
    assert trace.gk_points_traced() == traced + 4096
