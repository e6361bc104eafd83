"""The port's device rook rrLU (tci_tpu_torch/ops/lu_device.py) against
tci_tpu's (tci_tpu/ops/lu_device.py), on the CPU, mirroring
tests/test_lu_device.py: ``rrlu_rook_device`` (both materialize modes),
``rrlu_serving`` = ``rrlu_rook_device_fused`` (f64, mixed, hunt_stages 1
and 2, defer), ``DeviceRRLU`` and the validation errors.

Both packages get the same numpy matrix and the same ``rng`` seed.
Tolerances: npivot, nslabs and the permutations identical; the natural
order factors L and U within 1e-12 of their max; the reconstruction
bounds of tests/test_lu_device.py. On the CPU every slab of the port runs
the kernel's plain version.
"""

import numpy as np
import pytest
import torch

from tci_tpu.ops import lu as jlu
from tci_tpu.ops import lu_device as jd
from tci_tpu_torch import DeviceRRLU, rrlu_serving
from tci_tpu_torch.ops import lu_cuda, lu_device as td, lu_kernel
from tci_tpu_torch.utils.device import FETCHES

torch.set_num_threads(1)

TOL = 1e-12


def _lowrank(rng, m, n, r, decay=None):
    U = rng.standard_normal((m, r))
    if decay is not None:
        U = U * decay
    return U @ rng.standard_normal((r, n))


def assert_same_device_lu(a, b, factors=True):
    """a: tci_tpu's DeviceRRLU (jax factors), b: the port's (tensors).
    factors=False: npivot and nslabs only (an f32 hunt that reached f32
    noise, ROADMAP C-port-12)."""
    assert isinstance(b, DeviceRRLU)
    assert a.npivots() == b.npivots()
    assert a.nslabs == b.nslabs
    if factors:
        np.testing.assert_array_equal(a.rowpermutation, b.rowpermutation)
        np.testing.assert_array_equal(a.colpermutation, b.colpermutation)
        for x, y in ((a.left(), b.left()), (a.right(), b.right())):
            x, y = np.asarray(x), y.numpy()
            assert x.shape == y.shape
            assert np.abs(x - y).max() <= TOL * np.abs(x).max()


def _recon(lu, A):
    return float(np.abs((lu.left() @ lu.right()).numpy() - A).max()
                 / np.abs(A).max())


@pytest.mark.parametrize("leftorthogonal", [True, False])
def test_rook_device_matches_host_arrlu(rng, leftorthogonal):
    """rrlu_rook_device reproduces tci_tpu's, and the host arrlu, pivot for
    pivot (tests/test_lu_device.py::test_rook_device_matches_host_arrlu)."""
    m, n, r = 120, 90, 17
    A = _lowrank(rng, m, n, r)
    lu = td.rrlu_rook_device(A, reltol=1e-10, leftorthogonal=leftorthogonal,
                             rng=np.random.default_rng(1), device="cpu")
    ref = jd.rrlu_rook_device(A, reltol=1e-10, leftorthogonal=leftorthogonal,
                              rng=np.random.default_rng(1))
    assert lu.npivots() == ref.npivots() == r
    np.testing.assert_array_equal(lu.rowpermutation, ref.rowpermutation)
    np.testing.assert_array_equal(lu.colpermutation, ref.colpermutation)
    for x, y in ((ref.L, lu.L), (ref.U, lu.U)):
        assert np.abs(x - y.numpy()).max() <= TOL * np.abs(x).max()
    assert _recon(lu, A) < 1e-9
    f = lambda rows, cols: A[np.ix_(rows, cols)]
    lu_h = jlu.arrlu(np.float64, f, (m, n), reltol=1e-10,
                     leftorthogonal=leftorthogonal, usebatcheval=True,
                     rng=np.random.default_rng(1))
    np.testing.assert_array_equal(lu.rowindices(), lu_h.rowindices())
    np.testing.assert_array_equal(lu.colindices(), lu_h.colindices())


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("transpose", [False, True])
def test_rook_device_materialize_device(rng, leftorthogonal, transpose):
    m, n, r = 120, 90, 17
    A = _lowrank(rng, m, n, r)
    if transpose:
        A = A.T
    kw = dict(reltol=1e-10, leftorthogonal=leftorthogonal,
              materialize="device")
    lu_d = td.rrlu_rook_device(A, rng=np.random.default_rng(2),
                               device="cpu", **kw)
    ref = jd.rrlu_rook_device(A, rng=np.random.default_rng(2), **kw)
    assert_same_device_lu(ref, lu_d)
    lu_h = td.rrlu_rook_device(A, reltol=1e-10,
                               leftorthogonal=leftorthogonal,
                               rng=np.random.default_rng(2), device="cpu")
    np.testing.assert_allclose(lu_d.left().numpy(), lu_h.left().numpy(),
                               atol=1e-10)
    rt = lu_d.to_rrlu()
    np.testing.assert_allclose((rt.left() @ rt.right()).numpy(), A,
                               atol=1e-9)
    with pytest.raises(ValueError, match="materialize"):
        td.rrlu_rook_device(A, materialize="disk", device="cpu")


def test_rook_device_maxrank(rng):
    A = _lowrank(rng, 60, 60, 30)
    lu = td.rrlu_rook_device(A, maxrank=8, rng=np.random.default_rng(3),
                             device="cpu")
    ref = jd.rrlu_rook_device(A, maxrank=8, rng=np.random.default_rng(3))
    assert lu.npivots() == ref.npivots() <= 8
    np.testing.assert_array_equal(lu.rowpermutation, ref.rowpermutation)


@pytest.mark.parametrize("leftorthogonal", [True, False])
def test_serving_f64_matches_tci_tpu(rng, leftorthogonal):
    """rrlu_serving at full precision: one device queue, the record fetched
    once (FETCHES["rook"]), the slab eliminations on the plain version
    here (the kernel on a card)."""
    N, rank = 96, 11
    A = _lowrank(rng, N, N, rank, decay=np.exp(-np.arange(rank) / 4.0))
    FETCHES.clear()
    plain = lu_kernel.PLAIN_CALLS["cpu"]
    launches = lu_cuda.LAUNCHES["rrlu"]
    lu = rrlu_serving(A, maxrank=32, reltol=1e-11,
                      leftorthogonal=leftorthogonal,
                      rng=np.random.default_rng(7), device="cpu")
    # numrookiter predicated steps and the final row slab, each one call
    assert lu_kernel.PLAIN_CALLS["cpu"] - plain == 5 + 1
    assert lu_cuda.LAUNCHES["rrlu"] == launches
    assert FETCHES["rook"] == 1
    ref = jd.rrlu_rook_device_fused(A, maxrank=32, reltol=1e-11,
                                    leftorthogonal=leftorthogonal,
                                    rng=np.random.default_rng(7))
    assert_same_device_lu(ref, lu)
    # the matrix has rank 11 exactly: the error is the first rejected
    # pivot, at the rounding floor on both sides
    assert max(lu.error, ref.error) < 1e-13 * np.abs(A).max()
    assert _recon(lu, A) < 1e-9
    assert sorted(lu.rowpermutation.tolist()) == list(range(N))


def test_serving_maxrank_cap(rng):
    A = rng.standard_normal((40, 60))
    lu = rrlu_serving(A, maxrank=8, reltol=1e-13,
                      rng=np.random.default_rng(1), device="cpu")
    ref = jd.rrlu_rook_device_fused(A, maxrank=8, reltol=1e-13,
                                    rng=np.random.default_rng(1))
    assert_same_device_lu(ref, lu)
    assert lu.npivots() == 8 and np.isfinite(lu.error)
    assert abs(lu.error - ref.error) <= 1e-12 * ref.error


@pytest.mark.parametrize("leftorthogonal", [True, False])
def test_serving_mixed_matches_tci_tpu(rng, leftorthogonal):
    """precision="mixed", the f32 hunt capped below the rank (no f32-noise
    pivots; ROADMAP C-port-12): the same pivot sets, factors and
    triangular blocks as tci_tpu's."""
    m, n, r, cap = 200, 160, 40, 32
    A = _lowrank(rng, m, n, r, decay=np.exp(-np.arange(r) / 8.0))
    kw = dict(maxrank=cap, reltol=1e-12, leftorthogonal=leftorthogonal,
              precision="mixed")
    lu = rrlu_serving(A, rng=np.random.default_rng(7), device="cpu", **kw)
    ref = jd.rrlu_rook_device_fused(A, rng=np.random.default_rng(7), **kw)
    assert_same_device_lu(ref, lu)
    k = lu.npivots()
    Lp = lu.left().numpy()[lu.rowpermutation[:k], :]
    Up = lu.right().numpy()[:, lu.colpermutation[:k]]
    assert np.allclose(np.triu(Lp[:k], 1), 0)
    assert np.allclose(np.tril(Up[:, :k], -1), 0)
    assert np.allclose(np.diagonal(Lp if leftorthogonal else Up), 1.0)


@pytest.mark.parametrize("scale", [1e300, 1e-250, "top"])
def test_serving_mixed_extreme_scale(rng, scale):
    """The dynamic-range guard: f64 input outside f32 range, scaled by a
    power of two before the f32 copy (tests/test_lu_device.py::
    test_rook_fused_mixed_extreme_scale)."""
    r = 24
    U = np.linalg.qr(rng.standard_normal((128, r)))[0]
    V = np.linalg.qr(rng.standard_normal((96, r)))[0]
    base = (U * np.logspace(0, -6, r)) @ V.T
    A = (base / np.abs(base).max() * 1.6e308 if scale == "top"
         else base * scale)
    kw = dict(maxrank=48, reltol=1e-10, precision="mixed")
    lu = rrlu_serving(A, rng=np.random.default_rng(5), device="cpu", **kw)
    ref = jd.rrlu_rook_device_fused(A, rng=np.random.default_rng(5), **kw)
    assert lu.npivots() >= r - 2
    assert lu.npivots() == ref.npivots()
    assert _recon(lu, A) < 1e-9


def test_serving_precision_validation(rng):
    A = rng.standard_normal((32, 32))
    with pytest.raises(ValueError, match="precision"):
        rrlu_serving(A, maxrank=8, precision="Mixed", device="cpu")
    with pytest.raises(ValueError, match="mixed"):
        rrlu_serving(A.astype(np.complex128), maxrank=8, precision="mixed",
                     device="cpu")


def test_serving_hunt_stages_validation(rng):
    A = rng.standard_normal((32, 24))
    with pytest.raises(ValueError, match="mixed"):
        rrlu_serving(A, maxrank=8, hunt_stages=2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        rrlu_serving(A, maxrank=8, hunt_stages=0, precision="mixed",
                     device="cpu")


def test_serving_mixed_f32_input_passthrough(rng):
    A = (rng.standard_normal((64, 48, 8)) @ np.ones(8)).astype(np.float32)
    a = rrlu_serving(A, maxrank=16, reltol=1e-6,
                     rng=np.random.default_rng(3), device="cpu")
    b = rrlu_serving(A, maxrank=16, reltol=1e-6,
                     rng=np.random.default_rng(3), precision="mixed",
                     device="cpu")
    assert a.left().dtype == torch.float32
    assert a.npivots() == b.npivots()
    assert torch.equal(a.left(), b.left())


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_serving_defer(rng, precision):
    """defer=True: the work is queued, nothing fetched until result(), which
    is memoized and equals tci_tpu's call (the mixed hunt of these exactly
    low-rank matrices reaches f32 noise: npivot and nslabs, C-port-12)."""
    mats = [_lowrank(rng, 80, 72, r, decay=np.exp(-np.arange(r) / 3.0))
            for r in (6, 9, 13)]
    FETCHES.clear()
    pending = [rrlu_serving(A, maxrank=24, reltol=1e-11,
                            rng=np.random.default_rng(11 + i),
                            precision=precision, defer=True, device="cpu")
               for i, A in enumerate(mats)]
    assert all(isinstance(p, td._PendingRRLU) for p in pending)
    assert FETCHES["rook"] == 0
    for i, (p, A) in enumerate(zip(pending, mats)):
        lu = p.result()
        assert lu is p.result()
        ref = jd.rrlu_rook_device_fused(
            A, maxrank=24, reltol=1e-11, rng=np.random.default_rng(11 + i),
            precision=precision)
        assert_same_device_lu(ref, lu, factors=precision == "f64")
        assert _recon(lu, A) < 1e-9
    assert FETCHES["rook"] == 3


@pytest.mark.parametrize("stages", [1, 2])
def test_serving_numrookiter2_hunt_stages(rng, stages):
    """numrookiter=2, the serving setting benchmarked at 4096^2: one column
    and one row slab an alternation (the row move's factors reused), two
    alternations with hunt_stages=2; reconstruction at the f64 floor on a
    14-decade spectrum."""
    m, n, r = 220, 180, 48
    A = _lowrank(rng, m, n, r, decay=np.exp(-np.arange(r) * 0.67))
    kw = dict(maxrank=64, reltol=1e-12, numrookiter=2,
              precision="mixed", hunt_stages=stages)
    lu = rrlu_serving(A, rng=np.random.default_rng(5), device="cpu", **kw)
    ref = jd.rrlu_rook_device_fused(A, rng=np.random.default_rng(5), **kw)
    assert lu.nslabs == ref.nslabs == 2 * stages
    assert lu.npivots() <= 64
    assert _recon(lu, A) < 5e-11
    assert sorted(lu.colpermutation.tolist()) == list(range(n))


def test_serving_hunt_stages_exact_rank(rng):
    """hunt_stages=2 on an exactly low-rank matrix: the deflated residual is
    ~0, its hunt finds only zero pivots and the final f64 walk rejects
    them."""
    A = _lowrank(rng, 150, 120, 12)
    kw = dict(maxrank=40, reltol=1e-12, numrookiter=2, precision="mixed",
              hunt_stages=2)
    lu = rrlu_serving(A, rng=np.random.default_rng(5), device="cpu", **kw)
    ref = jd.rrlu_rook_device_fused(A, rng=np.random.default_rng(5), **kw)
    assert lu.npivots() == ref.npivots() == 12
    assert _recon(lu, A) < 1e-12


def test_serving_complex128(rng):
    r = 12
    A = (rng.standard_normal((96, r)) + 1j * rng.standard_normal((96, r))) \
        @ (rng.standard_normal((r, 80)) + 1j * rng.standard_normal((r, 80)))
    for lo in (True, False):
        lu = rrlu_serving(A, maxrank=32, reltol=1e-11, leftorthogonal=lo,
                          rng=np.random.default_rng(3), device="cpu")
        ref = jd.rrlu_rook_device_fused(A, maxrank=32, reltol=1e-11,
                                        leftorthogonal=lo,
                                        rng=np.random.default_rng(3))
        assert lu.left().dtype == torch.complex128
        assert_same_device_lu(ref, lu)
