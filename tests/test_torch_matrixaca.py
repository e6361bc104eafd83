"""MatrixACA of tci_tpu_torch against tci_tpu on the same numpy inputs: the
cases of tests/test_matrixaca.py through both packages (the port on the
CPU), and the port's one-solve updates against tci_tpu's loops.

Tolerances: pivot positions identical; u, v, α and reconstructions within
1e-12 relative to their largest entry. setcols / setrows are one
unit-triangular solve in the port and a double loop over the pivots in
tci_tpu: the same arithmetic in another order, so they agree to rounding,
held at 1e-12 relative on seeded random factors whose triangular systems
are well conditioned (ACA factors of a random matrix).
"""

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu_torch.utils.device import FETCHES

torch.set_num_threads(1)

REL = 1e-12


def host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close(a, b, rel=REL):
    a, b = host(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(initial=0.0), 1e-300)
    assert np.abs(a - b).max(initial=0.0) <= rel * scale, (
        np.abs(a - b).max(), scale)


def same_state(out, ref):
    assert out.rowindices == [int(i) for i in ref.rowindices]
    assert out.colindices == [int(j) for j in ref.colindices]
    close(out.u, ref.u)
    close(out.v, ref.v)
    close(out.alpha, np.asarray(ref.alpha))


A3 = np.array([
    [1.0, 0.1, -1.0],
    [-0.1, 2.0, -1.0],
    [0.5, 0.2, 0.3],
])
A3C = np.array([
    [0.641325 + 0.331139j, 0.63414 + 0.902753j, 0.385012 + 0.359676j],
    [0.89194 + 0.783782j, 0.236955 + 0.0828438j, 0.98353 + 0.729723j],
    [0.219505 + 0.429946j, 0.544289 + 0.378888j, 0.14397 + 0.701327j],
])


def test_3x3_real():
    aca = tci_tpu_torch.MatrixACA(A=A3, firstpivot=(0, 0), device="cpu")
    ref = tci_tpu.MatrixACA(A=A3, firstpivot=(0, 0))
    assert aca.shape == (3, 3) and aca.npivots() == 1
    assert aca.rowindices == [0] and aca.colindices == [0]
    assert aca.evaluate(0, 0) == pytest.approx(A3[0, 0])
    assert aca[0, 0] == pytest.approx(A3[0, 0])
    close(aca[0, list(range(3))], A3[0, :])
    close(aca[list(range(3)), 0], A3[:, 0])

    aca.addpivot(A3, (1, 2))
    ref.addpivot(A3, (1, 2))
    same_state(aca, ref)
    assert aca[1, 2] == pytest.approx(A3[1, 2])
    close(aca.submatrix([0, 1], [0, 2]), A3[np.ix_([0, 1], [0, 2])])

    aca.addpivot(A3)
    ref.addpivot(A3)
    same_state(aca, ref)
    assert aca.colindices == [0, 2, 1]
    close(aca.evaluate(), A3)
    close(aca.matrix(), A3)


def test_3x3_complex():
    aca = tci_tpu_torch.MatrixACA(A=A3C, firstpivot=(0, 0), device="cpu")
    ref = tci_tpu.MatrixACA(A=A3C, firstpivot=(0, 0))
    for _ in range(2):
        aca.addpivot(A3C)
        ref.addpivot(A3C)
        same_state(aca, ref)
    close(aca.evaluate(), A3C)


def random_aca(pkg, A, npiv, device=None):
    """A greedy ACA of A with npiv pivots through `pkg`."""
    kw = {} if device is None else {"device": device}
    aca = pkg.MatrixACA(A=A, firstpivot=(0, 0), **kw)
    for _ in range(npiv - 1):
        aca.addpivot(A)
    return aca


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_aca_matches(seed):
    """Greedy pivots from the last u/v on a seeded random matrix: the same
    pivots as tci_tpu; the residual column and row (one matrix-vector
    product each) agree with tci_tpu's loops."""
    A = np.random.default_rng(seed).standard_normal((17, 13))
    out = random_aca(tci_tpu_torch, A, 9, device="cpu")
    ref = random_aca(tci_tpu, A, 9)
    same_state(out, ref)
    # relative to max|A|: at a pivot column the residual is rounding noise
    scale = np.abs(A).max()
    for yk in range(A.shape[1]):
        diff = host(out.residualcol(A, yk)) - ref.residualcol(A, yk)
        assert np.abs(diff).max() <= REL * scale
    assert np.abs(host(out._vk(torch.from_numpy(A))) - ref._vk(A)).max() <= (
        REL * scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_setcols_setrows_solve_equals_loops(seed):
    """setrows / setcols as one triangular solve against tci_tpu's double
    loops: an ACA of a seeded random matrix, its row and column sets
    permuted and extended (the new pivot rows/columns drawn at random)."""
    rng = np.random.default_rng(seed)
    m, n, k = 20, 16, 8
    A = rng.standard_normal((m, n))
    out = random_aca(tci_tpu_torch, A, k, device="cpu")
    ref = random_aca(tci_tpu, A, k)
    same_state(out, ref)

    # rows: old row r moves to rowperm[r] of m + 5 rows
    rowperm = rng.permutation(m + 5)[:m]
    newcols = rng.standard_normal((m + 5, k))
    out.setrows(torch.from_numpy(newcols), rowperm)
    ref.setrows(newcols, rowperm)
    same_state(out, ref)

    # columns: old column c moves to colperm[c] of n + 4 columns
    colperm = rng.permutation(n + 4)[:n]
    newrows = rng.standard_normal((k, n + 4))
    out.setcols(torch.from_numpy(newrows), colperm)
    ref.setcols(newrows, colperm)
    same_state(out, ref)


def test_setrows_setcols_contain_no_pivot_loop():
    """The updates are a fixed number of tensor operations whatever the
    rank: no Python loop over the pivots (the source of each holds no
    `for`)."""
    import inspect

    from tci_tpu_torch.ops import aca

    for name in ("setcols", "setrows", "residualcol", "_vk"):
        src = inspect.getsource(getattr(aca.MatrixACA, name))
        assert "for " not in src and "while " not in src, name


def test_zero_pivot_guards():
    A = np.array([[0.0, 1.0], [1.0, 1.0]])
    with pytest.raises(ValueError, match="zero"):
        tci_tpu_torch.MatrixACA(A=A, firstpivot=(0, 0), device="cpu")
    B = np.array([[1.0, 2.0], [2.0, 4.0]])  # rank 1: the second pivot is 0
    aca = tci_tpu_torch.MatrixACA(A=B, firstpivot=(0, 0), device="cpu")
    aca.addpivotcol(B, 1)
    with pytest.raises(ZeroDivisionError):
        aca.addpivotrow(B, 1)


def test_guard_reads_are_counted():
    A = np.random.default_rng(5).standard_normal((6, 6))
    FETCHES.clear()
    aca = tci_tpu_torch.MatrixACA(A=A, firstpivot=(0, 0), device="cpu")
    aca.addpivot(A, (1, 1))
    # the first pivot's guard, the second's guard
    assert FETCHES["tci1"] == 2
    aca.addpivot(A)
    # two argmax reads and a guard
    assert FETCHES["tci1"] == 5
