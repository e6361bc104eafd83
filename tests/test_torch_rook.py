"""Rook pivoting of the port (tci_tpu_torch/ops/lu.py: ``arrlu``,
``rrlu_from_function``, ``rrlu(pivotsearch="rook")``; ops/luci.py:
``MatrixLUCI(f=...)``) against tci_tpu's, on the CPU, and the pins of the
reference's faults C-ref-1 to C-ref-3 (ROADMAP §C).

The inputs are made from numpy seeds and go through both packages with the
same ``rng`` seed. Tolerances: pivot sets, permutations and npivot
identical; L and U within 1e-12 of max|L| and max|U|. The one exception,
pinned below and logged in ROADMAP §C (C-port-12): tci_tpu's mixed
precision hunt on the CPU rounds its float32 Schur updates as fused
multiply-adds (XLA contracts a - x*y), the port's kernel and plain version
round the product and the difference apart, so once the f32 hunt reaches
f32 noise its noise pivots, and the sets built from them, can differ.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tci_tpu
import tci_tpu_torch
from tci_tpu.ops import lu as jlu
from tci_tpu.ops import lu_device as jlu_device
from tci_tpu_torch.ops import lu as tlu
from tci_tpu_torch.ops import lu_device as tlu_device

torch.set_num_threads(1)

TOL = 1e-12


def _lowrank(rng, m, n, r, decay=None):
    U = rng.standard_normal((m, r))
    if decay is not None:
        U = U * decay
    return U @ rng.standard_normal((r, n))


def assert_same_lu(a, b):
    """a: tci_tpu's rrLU (numpy factors), b: the port's (tensors)."""
    assert a.npivot == b.npivot
    np.testing.assert_array_equal(a.rowpermutation, b.rowpermutation)
    np.testing.assert_array_equal(a.colpermutation, b.colpermutation)
    for x, y in ((a.L, b.L), (a.U, b.U)):
        y = y.cpu().numpy()
        assert np.abs(x - y).max() <= TOL * max(np.abs(x).max(), 1e-300)
    assert a.leftorthogonal == b.leftorthogonal


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("batched", [True, False])
def test_arrlu_matches_tci_tpu(rng, leftorthogonal, batched):
    m, n = (120, 90) if batched else (40, 30)
    A = _lowrank(rng, m, n, 17 if batched else 9)
    if batched:
        f = lambda rows, cols: A[np.ix_(rows, cols)]
    else:
        f = lambda i, j: A[i, j]
    kw = dict(reltol=1e-10, leftorthogonal=leftorthogonal,
              usebatcheval=batched)
    a = jlu.arrlu(np.float64, f, (m, n), rng=np.random.default_rng(1), **kw)
    b = tlu.arrlu(np.float64, f, (m, n), rng=np.random.default_rng(1),
                  device="cpu", **kw)
    assert_same_lu(a, b)
    assert b.error == a.error == 0.0
    rec = (b.left() @ b.right()).numpy()
    assert np.abs(rec - A).max() < 1e-9 * np.abs(A).max()


def test_arrlu_pivot_continuation_and_maxrank(rng):
    """A warm start (I0, J0) and a rank cap below the numerical rank: the
    rook stops at maxrank. Its last slab is then exactly maxrank wide, and
    the error it reports is 0 (the slab's own rank is full), in tci_tpu
    as in the port."""
    A = _lowrank(rng, 60, 50, 30, decay=np.exp(-np.arange(30) / 4.0))
    f = lambda rows, cols: A[np.ix_(rows, cols)]
    kw = dict(I0=[3, 7], J0=[1, 2, 40], maxrank=8, reltol=1e-12,
              usebatcheval=True)
    a = jlu.arrlu(np.float64, f, A.shape, rng=np.random.default_rng(4), **kw)
    b = tlu.arrlu(np.float64, f, A.shape, rng=np.random.default_rng(4),
                  device="cpu", **kw)
    assert_same_lu(a, b)
    assert b.npivot == 8 and a.error == b.error == 0.0


@pytest.mark.parametrize("leftorthogonal", [True, False])
def test_rrlu_rook_f64_public_api(rng, leftorthogonal):
    """tests/test_matrixlu.py TestRrluRookPublicAPI's shape: 300 x 240 of
    rank 48 with maxrank 96."""
    A = rng.standard_normal((300, 48)) @ rng.standard_normal((48, 240))
    kw = dict(maxrank=96, reltol=1e-12, pivotsearch="rook",
              leftorthogonal=leftorthogonal)
    a = tci_tpu.rrlu(A, rng=np.random.default_rng(3), **kw)
    b = tci_tpu_torch.rrlu(A, rng=np.random.default_rng(3), device="cpu",
                           **kw)
    assert_same_lu(a, b)
    assert b.npivot == 48
    rec = (b.left() @ b.right()).numpy()
    assert np.abs(rec - A).max() < 1e-9 * np.abs(A).max()


@pytest.mark.parametrize("case", ["flat", "exp8_capped", "deep_stages2"])
def test_rrlu_rook_mixed_matches_tci_tpu(rng, case):
    """precision="mixed" where the f32 hunt stays above f32 noise: a flat
    spectrum of rank 40 and a decaying one capped at 24 pivots (both below
    the rank), and the deflated two-stage hunt on a spectrum whose first
    stage is rank-capped."""
    if case == "flat":
        A, cap, stages = _lowrank(rng, 200, 160, 40), 32, 1
    elif case == "exp8_capped":
        A = _lowrank(rng, 200, 160, 40, decay=np.exp(-np.arange(40) / 8.0))
        cap, stages = 24, 1
    else:
        A = _lowrank(rng, 160, 150, 40, decay=np.exp(-np.arange(40) / 8.0))
        cap, stages = 16, 2
    kw = dict(maxrank=cap, reltol=1e-12, precision="mixed",
              hunt_stages=stages)
    a = jlu_device.rrlu_rook_device_fused(A, rng=np.random.default_rng(7),
                                          **kw)
    b = tlu_device.rrlu_rook_device_fused(A, rng=np.random.default_rng(7),
                                          device="cpu", **kw)
    assert b.npivot == a.npivot == cap
    assert b.nslabs == a.nslabs
    assert_same_lu(a.to_rrlu(), b.to_rrlu())
    assert abs(a.error - b.error) <= 1e-7 * abs(a.error)


def test_rrlu_rook_mixed_noise_pivots_diverge_c_port_12(rng):
    """C-port-12. On an exactly low-rank panel with the slab wider than the
    rank, the f32 hunt runs into f32 noise. tci_tpu's XLA rounds the f32
    Schur update a - x y once (a fused multiply-add), the port twice, so
    the noise pivots differ, and with them the sets the f64 completion
    picks from. What the completion guarantees holds on both: the rank,
    the error estimate's scale and f64-floor reconstruction."""
    a32, x32, y32 = (rng.standard_normal(4096).astype(np.float32)
                     for _ in range(3))
    xla = np.asarray(jax.jit(lambda a, x, y: a - x * y)(a32, x32, y32))
    fma = (a32.astype(np.float64)
           - x32.astype(np.float64) * y32.astype(np.float64)).astype(
               np.float32)
    port = (torch.from_numpy(a32)
            - torch.from_numpy(x32) * torch.from_numpy(y32)).numpy()
    np.testing.assert_array_equal(xla, fma)
    assert (xla != port).any()

    r = 20
    A = _lowrank(rng, 256, 200, r, decay=np.logspace(0, -9, r))
    kw = dict(maxrank=64, reltol=1e-11, pivotsearch="rook",
              precision="mixed")
    a = tci_tpu.rrlu(A, rng=np.random.default_rng(5), **kw)
    b = tci_tpu_torch.rrlu(A, rng=np.random.default_rng(5), device="cpu",
                           **kw)
    assert a.npivot == b.npivot == r
    for lu in (a.left() @ a.right(), (b.left() @ b.right()).numpy()):
        assert np.abs(lu - A).max() < 1e-9 * np.abs(A).max()


def test_rrlu_rook_complex_and_f32(rng):
    """Complex input runs at full precision (complex128 on the kernel's
    complex path; "mixed" is ignored, as in tci_tpu); float32 input with
    "mixed" runs the plain f32 path."""
    r = 12
    A = (rng.standard_normal((96, r)) + 1j * rng.standard_normal((96, r))) \
        @ (rng.standard_normal((r, 80)) + 1j * rng.standard_normal((r, 80)))
    kw = dict(maxrank=32, reltol=1e-11, pivotsearch="rook",
              precision="mixed")
    a = tci_tpu.rrlu(A, rng=np.random.default_rng(7), **kw)
    b = tci_tpu_torch.rrlu(A, rng=np.random.default_rng(7), device="cpu",
                           **kw)
    assert b.L.dtype == torch.complex128
    assert_same_lu(a, b)
    A32 = _lowrank(rng, 96, 80, 10).astype(np.float32)
    kw = dict(maxrank=32, reltol=1e-5, pivotsearch="rook",
              precision="mixed")
    a = tci_tpu.rrlu(A32, rng=np.random.default_rng(9), **kw)
    b = tci_tpu_torch.rrlu(A32, rng=np.random.default_rng(9), device="cpu",
                           **kw)
    assert a.npivot == b.npivot == 10
    rec = (b.left() @ b.right()).numpy()
    assert np.abs(rec - A32).max() < 1e-4 * np.abs(A32).max()


def test_rrlu_rook_rejects_mesh_and_unknown_search(rng):
    A = rng.standard_normal((16, 16))
    with pytest.raises(ValueError, match="single-device"):
        tci_tpu_torch.rrlu(A, pivotsearch="rook", mesh=object(),
                           device="cpu")
    with pytest.raises(ValueError, match="Unknown pivot search"):
        tci_tpu_torch.rrlu(A, pivotsearch="partial", device="cpu")


@pytest.mark.parametrize("pivotsearch", ["rook", "full"])
def test_rrlu_from_function_and_matrixluci(rng, pivotsearch):
    A = _lowrank(rng, 50, 40, 11)
    f = lambda rows, cols: A[np.ix_(rows, cols)]
    kw = dict(pivotsearch=pivotsearch, usebatcheval=True, reltol=1e-10)
    a = jlu.rrlu_from_function(np.float64, f, A.shape,
                               rng=np.random.default_rng(2), **kw)
    b = tlu.rrlu_from_function(np.float64, f, A.shape,
                               rng=np.random.default_rng(2), device="cpu",
                               **kw)
    assert_same_lu(a, b)
    ca = tci_tpu.MatrixLUCI(f=f, valuetype=np.float64, matrixsize=A.shape,
                            rng=np.random.default_rng(2), **kw)
    cb = tci_tpu_torch.MatrixLUCI(f=f, valuetype=np.float64,
                                  matrixsize=A.shape,
                                  rng=np.random.default_rng(2), device="cpu",
                                  **kw)
    np.testing.assert_array_equal(ca.rowindices(), cb.rowindices())
    np.testing.assert_array_equal(ca.colindices(), cb.colindices())
    for x, y in ((ca.left(), cb.left()), (ca.right(), cb.right())):
        assert np.abs(x - y.numpy()).max() <= TOL * np.abs(x).max()


def test_c_ref_1_default_reltol_always_deep(monkeypatch, rng):
    """C-ref-1, pinned: rrlu's deep-hunt rule `0 < reltol < 1e-6` holds at
    the default reltol 1e-14, so every mixed call takes hunt_stages=2,
    in tci_tpu and in the port; a reltol of 1e-5 with no abstol takes 1,
    an abstol below 1e-6 max|A| takes 2 again."""
    A = _lowrank(rng, 64, 48, 6)
    seen = {"tci_tpu": [], "port": []}
    for name, mod in (("tci_tpu", jlu_device), ("port", tlu_device)):
        orig = mod.rrlu_rook_device_fused

        def spy(*args, _orig=orig, _name=name, **kw):
            seen[_name].append(kw["hunt_stages"])
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, "rrlu_rook_device_fused", spy)
    for rel, ab in ((1e-14, 0.0), (1e-5, 0.0), (1e-5, 1e-9)):
        kw = dict(maxrank=16, reltol=rel, abstol=ab, pivotsearch="rook",
                  precision="mixed")
        tci_tpu.rrlu(A, rng=np.random.default_rng(0), **kw)
        tci_tpu_torch.rrlu(A, rng=np.random.default_rng(0), device="cpu",
                           **kw)
    assert seen["tci_tpu"] == seen["port"] == [2, 1, 2]
