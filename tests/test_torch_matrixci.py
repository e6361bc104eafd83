"""Matrix CI of tci_tpu_torch against tci_tpu on the same numpy inputs: the
cases of tests/test_matrixci.py through both packages, the port on the CPU.

Tolerances: pivot positions, ranks and available sets identical; products
(AtimesBinv, AinvtimesB, left/right matrices, evaluations) within 1e-12 of
tci_tpu's (the two packages' QR and solve round differently, well below
that for these well-conditioned fixtures); the closed forms of
tests/test_matrixci.py with numpy's default allclose.
"""

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu_torch.ops.ci import argmax_colmajor
from tci_tpu_torch.utils.device import FETCHES

torch.set_num_threads(1)

TOL = 1e-12

A53 = np.array([
    [0.262819, 0.740968, 0.505743],
    [0.422301, 0.831443, 0.32687],
    [0.439065, 0.426132, 0.453675],
    [0.128233, 0.0490983, 0.902257],
    [0.371653, 0.810275, 0.75838],
])
B33 = np.array([
    [0.852891, 0.945401, 0.585575],
    [0.800289, 0.478038, 0.661408],
    [0.685688, 0.619311, 0.309872],
])
C55 = np.array([
    [0.304463, 0.399473, 0.767147, 0.337228, 0.86603],
    [0.147815, 0.508933, 0.794015, 0.326105, 0.8079],
    [0.665499, 0.0571589, 0.766872, 0.167927, 0.028576],
    [0.411886, 0.397681, 0.473644, 0.527007, 0.4264],
    [0.244107, 0.0669144, 0.347337, 0.947754, 0.76624],
])
A85 = np.array([
    [0.735188, 0.718229, 0.206528, 0.89223, 0.23432],
    [0.58692, 0.383284, 0.906576, 0.3389, 0.24915],
    [0.0866507, 0.812134, 0.683979, 0.798798, 0.63418],
    [0.694491, 0.585013, 0.623725, 0.25272, 0.72730],
    [0.100076, 0.248325, 0.770408, 0.342828, 0.080717],
    [0.748823, 0.653965, 0.47961, 0.909719, 0.037413],
    [0.902325, 0.743668, 0.193464, 0.380086, 0.91558],
    [0.0614368, 0.0709293, 0.343843, 0.197515, 0.45067],
])


def host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("A,B,kind", [
    (A53, np.eye(3), "AtimesBinv"), (np.eye(5), A53, "AinvtimesB"),
    (B33, B33, "AtimesBinv"), (B33, B33, "AinvtimesB"),
    (C55, C55, "AtimesBinv"), (C55, C55, "AinvtimesB"),
    (A53, B33, "AtimesBinv"), (C55, A53, "AinvtimesB")])
def test_matrix_util(A, B, kind):
    ref = getattr(tci_tpu, kind)(A, B)
    out = host(getattr(tci_tpu_torch, kind)(A, B, device="cpu"))
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    closed = A @ np.linalg.inv(B) if kind == "AtimesBinv" else (
        np.linalg.inv(A) @ B)
    assert np.allclose(out, closed)


def test_empty_constructor():
    ci = tci_tpu_torch.MatrixCI(nrows=10, ncols=25, device="cpu")
    assert ci.rowindices == [] and ci.colindices == []
    assert tuple(ci.pivotcols.shape) == (10, 0)
    assert tuple(ci.pivotrows.shape) == (0, 25)
    assert ci.shape == (10, 25) and ci.rank() == 0
    assert np.array_equal(host(ci.submatrix()), np.zeros((10, 25)))
    assert np.array_equal(host(ci.row(3)), np.zeros(25))
    assert np.array_equal(host(ci.col(7)), np.zeros(10))


def test_full_constructor():
    rowindices, colindices = [7, 1, 2], [0, 4, 3]
    ref = tci_tpu.MatrixCI(rowindices, colindices, A85[:, colindices],
                           A85[rowindices, :])
    ci = tci_tpu_torch.MatrixCI(rowindices, colindices, A85[:, colindices],
                                A85[rowindices, :], device="cpu")
    assert ci.rowindices == rowindices and ci.colindices == colindices
    assert ci.shape == A85.shape and ci.rank() == 3
    assert np.array_equal(host(ci.pivotmatrix()), ref.pivotmatrix())
    np.testing.assert_allclose(host(ci.leftmatrix()), ref.leftmatrix(),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(host(ci.rightmatrix()), ref.rightmatrix(),
                               rtol=0, atol=TOL)
    assert ci.availablerows() == ref.availablerows() == [0, 3, 4, 5, 6]
    assert ci.availablecols() == ref.availablecols() == [1, 2]
    for i in rowindices:
        for j in colindices:
            assert ci.evaluate(i, j) == pytest.approx(A85[i, j], abs=TOL)
            assert ci[i, j] == pytest.approx(float(ref[i, j]), abs=TOL)
        np.testing.assert_allclose(host(ci[i, colindices]), A85[i, colindices],
                                   rtol=0, atol=TOL)
    np.testing.assert_allclose(host(ci.matrix()), ref.matrix(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(host(ci[:, :]), ref.submatrix(), rtol=0,
                               atol=TOL)


def test_finding_pivots_trivial():
    A = np.ones((5, 3))
    ci = tci_tpu_torch.MatrixCI(nrows=5, ncols=3, device="cpu")
    with pytest.raises(ValueError):
        ci.addpivot(np.zeros((6, 6)), (0, 0))
    with pytest.raises((IndexError, ValueError)):
        ci.addpivot(A, (5, 2))
    with pytest.raises((IndexError, ValueError)):
        ci.addpivot(A, (4, 3))
    with pytest.raises(ValueError):
        ci.findnewpivot(A, [], [1, 2])
    with pytest.raises(ValueError):
        ci.findnewpivot(A, [0, 1], [])
    ci.addpivot(A, (1, 2))
    assert ci.rowindices == [1] and ci.colindices == [2]
    assert np.array_equal(host(ci.pivotrows), np.ones((1, 3)))
    assert np.array_equal(host(ci.pivotcols), np.ones((5, 1)))
    ref = tci_tpu.MatrixCI(nrows=5, ncols=3)
    ref.addpivot(A, (1, 2))
    ci.addpivot(A)
    ref.addpivot(A)
    assert (ci.rowindices, ci.colindices) == (ref.rowindices, ref.colindices)
    ci.addpivot(A, (ci.availablerows()[0], ci.availablecols()[0]))
    assert ci.rank() == 3


def test_finding_pivots_rank1():
    A = np.outer([1.0, 2.0, 3.0], [2.0, 4.0, 8.0, 16.0])
    ci = tci_tpu_torch.MatrixCI(nrows=3, ncols=4, device="cpu")
    ref = tci_tpu.MatrixCI(nrows=3, ncols=4)
    assert np.allclose(host(ci.localerror(A)), A)
    pivot, err = ci.findnewpivot(A)
    assert (pivot, err) == ref.findnewpivot(A) == ((2, 3), 48.0)
    for npivots in (1, 2, 3):
        ci.addpivot(A)
        ref.addpivot(A)
        assert (ci.rowindices, ci.colindices) == (ref.rowindices,
                                                  ref.colindices)
        if npivots < 3:  # three pivots of a rank-1 matrix: P is singular
            np.testing.assert_allclose(host(ci.submatrix()), A, rtol=0,
                                       atol=TOL)
    ci2 = tci_tpu_torch.MatrixCI(A=A, firstpivot=(2, 3), device="cpu")
    assert np.allclose(host(ci2.pivotcols), 16.0 * np.array([[1.0], [2.0],
                                                             [3.0]]))
    with pytest.raises(ValueError):
        ci.findnewpivot(A)
    with pytest.raises(ValueError):
        ci.addpivot(A)


def test_crossinterpolate_smooth():
    grid = np.linspace(0, 1, 21)
    gauss = np.exp(-grid[:, None] ** 2 - grid[None, :] ** 2)
    ci = tci_tpu_torch.matrix_crossinterpolate(gauss, device="cpu")
    assert ci.rank() == 1 and ci.rowindices == [0] and ci.colindices == [0]

    lorentz = 1.0 / (1.0 + grid[:, None] ** 2 + grid[None, :] ** 2)
    ref = tci_tpu.matrix_crossinterpolate(lorentz, tolerance=1e-6, maxiter=10)
    out = tci_tpu_torch.matrix_crossinterpolate(lorentz, tolerance=1e-6,
                                                maxiter=10, device="cpu")
    assert out.rank() == 5
    assert (out.rowindices, out.colindices) == (ref.rowindices,
                                                ref.colindices)
    assert np.max(np.abs(host(out.matrix()) - lorentz)) < 1e-6


def test_crossinterpolate_low_rank_matches_and_counts_fetches():
    """A seeded rank-12 matrix: the same pivot order as tci_tpu, one fetch
    a pivot search (the first pivot's argmax and one each iteration)."""
    rng = np.random.default_rng(3)
    A = (rng.standard_normal((60, 12)) * np.exp(-np.arange(12) / 3.0)) @ (
        rng.standard_normal((12, 50)))
    ref = tci_tpu.matrix_crossinterpolate(A, tolerance=1e-10, maxiter=40)
    FETCHES.clear()
    out = tci_tpu_torch.matrix_crossinterpolate(
        torch.from_numpy(A), tolerance=1e-10, maxiter=40)
    assert (out.rowindices, out.colindices) == (ref.rowindices,
                                                ref.colindices)
    assert out.rank() == 12
    assert FETCHES["tci1"] == 1 + out.rank()
    np.testing.assert_allclose(host(out.matrix()), A, rtol=0,
                               atol=1e-10 * np.abs(A).max())


@pytest.mark.parametrize("seed", range(4))
def test_argmax_colmajor_matches_numpy(seed):
    """The column-major first-occurrence argmax, with ties and NaNs, equals
    tci_tpu's submatrixargmax_colmajor (np.argmax ranks a NaN first)."""
    from tci_tpu.ops.lu_kernel import submatrixargmax_colmajor

    rng = np.random.default_rng(seed)
    M = rng.integers(0, 4, (7, 5)).astype(float)
    if seed >= 2:
        M[rng.integers(0, 7), rng.integers(0, 5)] = np.nan
        M[rng.integers(0, 7), rng.integers(0, 5)] = np.nan
    r, c, v = argmax_colmajor(torch.from_numpy(M))
    assert (r, c) == submatrixargmax_colmajor(M)
    assert (np.isnan(v) and np.isnan(M[r, c])) or v == M[r, c]


def test_numpy_matrix_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tci_tpu_torch.matrix_crossinterpolate(np.eye(3))
