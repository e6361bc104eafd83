"""rrlu / MatrixLUCI of tci_tpu_torch against tci_tpu's, on the same numpy
matrices (the port runs its plain PyTorch elimination on the CPU).

Tolerances: permutations and npivot identical. Factors and pivot errors to
1e-12 of max|A|: the two eliminations round the Schur update differently
(XLA on the CPU may fuse it into one multiply-add), and the CI factors add
triangular solves by different libraries; every matrix here is well
conditioned on its pivot block, so the differences stay at rounding level.
"""

import numpy as np
import pytest
import torch

import tci_tpu
import tci_tpu_torch
from tci_tpu_torch.ops import lu_cuda, lu_kernel, lu_sharded
from tci_tpu_torch.ops.lu_kernel import rrlu_raw

torch.set_num_threads(1)

_P = np.array([
    [0.284975, 0.505168, 0.570921], [0.302884, 0.475901, 0.645776],
    [0.622955, 0.361755, 0.99539], [0.748447, 0.354849, 0.431366],
    [0.28338, 0.0378148, 0.994162], [0.643177, 0.74173, 0.802733],
    [0.58113, 0.526715, 0.879048], [0.238002, 0.557812, 0.251512],
    [0.458861, 0.141355, 0.0306212], [0.490269, 0.810266, 0.7946],
])
_Q = np.array([
    [0.239552, 0.306094, 0.299063, 0.0382492, 0.185462, 0.0334971,
     0.697561, 0.389596, 0.105665, 0.0912763],
    [0.0570609, 0.56623, 0.97183, 0.994184, 0.371695, 0.284437,
     0.993251, 0.902347, 0.572944, 0.0531369],
    [0.45002, 0.461168, 0.6086, 0.613702, 0.543997, 0.759954,
     0.0959818, 0.638499, 0.407382, 0.482592],
])
_A5 = np.array([
    [0.433088, 0.956638, 0.0907974, 0.0447859, 0.0196053],
    [0.855517, 0.782503, 0.291197, 0.540828, 0.358579],
    [0.37455, 0.536457, 0.205479, 0.75896, 0.701206],
    [0.47272, 0.0172539, 0.518177, 0.242864, 0.461635],
    [0.0676373, 0.450878, 0.672335, 0.77726, 0.540691],
])


# tests/test_matrixlu.py's fixtures
_A4 = np.array([
    [0.711002, 0.724557, 0.789335, 0.382373],
    [0.910429, 0.726781, 0.719957, 0.486302],
    [0.632716, 0.39967, 0.571809, 0.0803125],
    [0.885709, 0.531645, 0.569399, 0.481214],
])
_A8x6 = np.array([
    [0.684025, 0.784249, 0.826742, 0.054321, 0.0234695, 0.467096],
    [0.73928, 0.295516, 0.877126, 0.111711, 0.103509, 0.653785],
    [0.394016, 0.753239, 0.889128, 0.291669, 0.873509, 0.0965536],
    [0.378539, 0.0123737, 0.20112, 0.758088, 0.973042, 0.308372],
    [0.235156, 0.51939, 0.788184, 0.363171, 0.230001, 0.984971],
    [0.893223, 0.220834, 0.18001, 0.258537, 0.396583, 0.142105],
    [0.0417881, 0.890706, 0.328631, 0.279332, 0.963188, 0.706944],
    [0.914298, 0.792345, 0.311083, 0.129653, 0.350062, 0.683966],
])
_SMALL = np.array([
    [0.585383, 0.124568, 0.352426, 0.573507],
    [0.865875, 0.600153, 0.727443, 0.902388],
    [0.913477, 0.954081, 0.116965, 0.817],
    [0.985918, 0.516114, 0.600366, 0.0200085],
])


def _case(name):
    rng = np.random.default_rng(42)
    # the fixtures of tests/test_matrixlu.py (TestRRLU and
    # TestEliminationEdgeCases), with its rng where it draws one
    fixture_rng = np.random.default_rng(1234)
    if name == "exact":
        return _A4, {}
    if name == "truncated":
        A = np.zeros((3, 3))
        A[0, 0] = 1.0
        return A, {}
    if name == "approximation":
        return _A8x6, {"maxrank": 4}
    if name == "approximation_reltol":
        return (np.hstack([_A8x6, _A8x6 + 1e-3 * fixture_rng.random((8, 6))]),
                {"reltol": 1e-2})
    if name == "lastpivoterror_fullrank":
        return np.eye(2), {}
    if name == "lastpivoterror_abstol":
        return _A5, {"abstol": 0.5}
    if name == "lastpivoterror_exact":
        return _A5, {"abstol": 0.0}
    if name == "small_values_fixture":
        return 1e-13 * _SMALL, {"abstol": 1e-3}
    if name == "complex":
        return (fixture_rng.random((6, 6)) + 1j * fixture_rng.random((6, 6)),
                {})
    if name == "true_rank_unpadded":  # a 64 x 8 panel has no column padding
        return (fixture_rng.standard_normal((64, 8)),
                {"maxrank": 32, "reltol": 0.0, "abstol": 0.0})
    if name == "random":
        return rng.standard_normal((20, 15)), {}
    if name == "lowrank_reltol":
        A = rng.random((8, 6))
        return np.hstack([A, A + 1e-3 * rng.random((8, 6))]), {"reltol": 1e-2}
    if name == "exact_lowrank":  # test_matrixlu.test_exact_lowrank
        return _P @ _Q, {}
    if name == "zero_pivot":  # exactly rank 1, exact pass
        return (np.outer([1.0, 2.0, 3.0, 4.0], [2.0, 1.0, 0.5, 0.25]),
                {"reltol": 0.0, "abstol": 0.0})
    if name == "maxrank":  # test_matrixlu.test_lastpivoterror_limited
        return _A5, {"maxrank": 2}
    if name == "small_values":
        return 1e-13 * _A5[:4, :4], {"abstol": 1e-3}
    # shapes that run the CUDA kernel's multi-block mode on a card
    if name == "wide_rank40":
        return (rng.standard_normal((64, 40))
                @ rng.standard_normal((40, 1000))), {"reltol": 1e-10}
    if name == "rank60":
        return (rng.standard_normal((400, 60))
                @ rng.standard_normal((60, 300))), {"reltol": 1e-10}
    raise KeyError(name)


CASES = ["random", "lowrank_reltol", "exact_lowrank", "zero_pivot",
         "maxrank", "small_values", "wide_rank40", "rank60",
         "exact", "truncated", "approximation", "approximation_reltol",
         "lastpivoterror_fullrank", "lastpivoterror_abstol",
         "lastpivoterror_exact", "small_values_fixture", "complex",
         "true_rank_unpadded"]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_rrlu_matches_tci_tpu(case, leftorthogonal):
    A, kw = _case(case)
    ref = tci_tpu.rrlu(A, leftorthogonal=leftorthogonal, **kw)
    launches = lu_cuda.LAUNCHES["rrlu"]
    out = tci_tpu_torch.rrlu(A, leftorthogonal=leftorthogonal, device="cpu",
                             **kw)
    assert lu_cuda.LAUNCHES["rrlu"] == launches  # CPU input: plain version
    assert out.L.device.type == "cpu"
    assert out.npivots() == ref.npivots()
    np.testing.assert_array_equal(out.rowpermutation, ref.rowpermutation)
    np.testing.assert_array_equal(out.colpermutation, ref.colpermutation)
    atol = 1e-12 * np.abs(A).max()
    for o, r in ((out.left(), ref.left()), (out.right(), ref.right()),
                 (out.left(permute=False), ref.left(permute=False))):
        np.testing.assert_allclose(_np(o), r, rtol=0, atol=atol)
    np.testing.assert_allclose(out.pivoterrors(), ref.pivoterrors(), rtol=0,
                               atol=atol)
    assert out.lastpivoterror() == pytest.approx(ref.lastpivoterror(),
                                                 abs=atol)


@pytest.mark.parametrize("what", ["transpose", "solve"])
def test_rrlu_transpose_and_solve_match_tci_tpu(what):
    """test_matrixlu.test_transpose and test_solve on both packages."""
    rng = np.random.default_rng(1234)
    if what == "transpose":
        A = rng.random((5, 10))
        ref = tci_tpu.rrlu(A).transpose()
        out = tci_tpu_torch.rrlu(A, device="cpu").transpose()
        np.testing.assert_array_equal(out.rowpermutation, ref.rowpermutation)
        np.testing.assert_array_equal(out.colpermutation, ref.colpermutation)
        np.testing.assert_allclose(_np(out.left() @ out.right()), A.T,
                                   rtol=0, atol=1e-12)
        for o, r in ((out.left(), ref.left()), (out.right(), ref.right())):
            np.testing.assert_allclose(_np(o), r, rtol=0, atol=1e-12)
    else:
        L = np.tril(rng.random((5, 5)))
        U = np.triu(rng.random((5, 5)))
        b = rng.random((5, 2))
        A = L @ U
        ref = tci_tpu.rrlu(A)
        out = tci_tpu_torch.rrlu(A, device="cpu")
        np.testing.assert_array_equal(out.rowpermutation, ref.rowpermutation)
        np.testing.assert_array_equal(out.colpermutation, ref.colpermutation)
        x = _np(out.solve(torch.from_numpy(b)))
        np.testing.assert_allclose(x, ref.solve(b), rtol=0, atol=1e-10)
        np.testing.assert_allclose(A @ x, b, rtol=0, atol=1e-12)


# C-port-9: panels that hold a NaN (ROADMAP §C). A NaN ranks above every
# value, as jnp.argmax ranks it in tci_tpu's _rrlu_state_small, so the NaN
# becomes a pivot and reaches the factors. The last matrix pads the first
# with 300 zero rows and columns: its 320^2 bucket takes tci_tpu's fused
# body (2^16 elements or more), which ranks NaN below every value and
# raises another message (C-port-11); it is held against tci_tpu's small
# body on the same panel, through tci_tpu's own check.
def _nan_case(name):
    nan = np.nan
    if name == "nan_upper_right":
        return np.array([[1.0, nan], [2.0, 3.0]])
    if name == "nan_upper_left":
        return np.array([[nan, 1.0], [2.0, 3.0]])
    if name == "all_nan":
        return np.full((3, 3), nan)
    A = np.zeros((302, 302))
    A[:2, :2] = _nan_case("nan_upper_right")
    return A


def _tci_tpu_small_body(A, leftorthogonal):
    """tci_tpu.rrlu's result on A through _rrlu_state_small, whatever the
    panel's size."""
    import jax.numpy as jnp
    from tci_tpu.ops import lu as ref_lu, lu_kernel as ref_kernel

    m, n = A.shape
    P = np.zeros((ref_kernel.bucket(m), ref_kernel.bucket(n)))
    P[:m, :n] = A
    out = ref_kernel._rrlu_state_small(
        jnp.asarray(P), jnp.int32(m), jnp.int32(n), jnp.int32(min(m, n)),
        jnp.float64(1e-14), jnp.float64(0.0), leftorthogonal)
    LU, rp, cp, k, _, err = (np.asarray(x) for x in out)
    return ref_lu._finalize(LU[:m, :n], rp[:m], cp[:n], int(k), float(err),
                            leftorthogonal)


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("case", ["nan_upper_right", "nan_upper_left",
                                  "all_nan", "padded_302"])
def test_rrlu_nan_raises_as_tci_tpu(case, leftorthogonal):
    A = _nan_case(case)
    if case == "padded_302":
        reference = lambda: _tci_tpu_small_body(A, leftorthogonal)  # noqa
    else:
        reference = lambda: tci_tpu.rrlu(A, leftorthogonal=leftorthogonal)  # noqa
    with pytest.raises(ValueError) as ref:
        reference()
    with pytest.raises(ValueError) as out:
        tci_tpu_torch.rrlu(A, leftorthogonal=leftorthogonal, device="cpu")
    assert str(out.value) == str(ref.value)


def test_rrlu_nan_large_panel_tci_tpu_fused_body():
    """C-port-11, pinned: tci_tpu.rrlu's fused body on the padded panel
    pivots on a padding column and raises for U, where its small body and
    the port raise for L."""
    A = _nan_case("padded_302")
    with pytest.raises(ValueError, match="lu.U contains NaNs"):
        tci_tpu.rrlu(A)
    with pytest.raises(ValueError, match="lu.L contains NaNs"):
        tci_tpu_torch.rrlu(A, device="cpu")


def test_rrlu_tensor_input_stays_on_its_device():
    A, _ = _case("random")
    out = tci_tpu_torch.rrlu(torch.from_numpy(A))
    assert out.L.device.type == "cpu" and out.L.dtype == torch.float64
    np.testing.assert_allclose(_np(out.left() @ out.right()), A, atol=1e-12)


def test_rrlu_unported_options_raise(monkeypatch):
    """Rook pivoting (A9) factorizes the identity at full rank and, as in
    tci_tpu, refuses a mesh; full pivoting with a mesh (A14) goes to the
    sharded elimination (held against tci_tpu in
    tests/test_torch_lu_sharded.py)."""
    A = np.eye(4)
    lu = tci_tpu_torch.rrlu(A, pivotsearch="rook", device="cpu",
                            rng=np.random.default_rng(0))
    assert lu.npivot == 4
    assert torch.equal(lu.left() @ lu.right(), torch.eye(4,
                                                         dtype=torch.float64))
    with pytest.raises(ValueError, match="single-device"):
        tci_tpu_torch.rrlu(A, pivotsearch="rook", mesh=object(),
                           device="cpu")
    # full pivoting with a mesh is the sharded elimination
    calls = []

    def sharded(*args, mesh=None):
        calls.append(mesh)
        return rrlu_raw(*args, device="cpu")

    mesh = object()
    monkeypatch.setattr(lu_sharded, "rrlu_sharded_raw", sharded)
    lu = tci_tpu_torch.rrlu(A, mesh=mesh, device="cpu")
    assert calls == [mesh] and lu.npivot == 4


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("case", ["luci_maxrank", "lowrank"])
def test_matrixluci_matches_tci_tpu(case, leftorthogonal):
    rng = np.random.default_rng(3)
    if case == "luci_maxrank":  # test_matrixluci.test_approximation_in_luci
        A, kw = rng.random((8, 6)), {"maxrank": 4}
    else:
        A = rng.standard_normal((30, 6)) @ rng.standard_normal((6, 20))
        kw = {"reltol": 1e-8}
    ref = tci_tpu.MatrixLUCI(A, leftorthogonal=leftorthogonal, **kw)
    out = tci_tpu_torch.MatrixLUCI(A, leftorthogonal=leftorthogonal,
                                   device="cpu", **kw)
    np.testing.assert_array_equal(out.rowindices(), ref.rowindices())
    np.testing.assert_array_equal(out.colindices(), ref.colindices())
    atol = 1e-12 * np.abs(A).max()
    for name in ("left", "right", "colstimespivotinv", "pivotinvtimesrows",
                 "colmatrix", "rowmatrix"):
        np.testing.assert_allclose(_np(getattr(out, name)()),
                                   getattr(ref, name)(), rtol=0, atol=atol,
                                   err_msg=name)
    np.testing.assert_allclose(out.pivoterrors(), ref.pivoterrors(), rtol=0,
                               atol=atol)


def _rrlu_deferred(A, m, n, maxrank, reltol, abstol, leftorthogonal, depth):
    """A model of the CUDA kernel's streamed grid regime (csrc/rrlu.cu), for
    a zero-padded (mp, np) panel: lu_kernel.rrlu_plain's elimination, except
    that the Schur update reaches the stored buffer W only every `depth`
    pivots. In between, the matrix as it stands is rebuilt from W by the
    pending updates a - x_t y_t, in order, each a rounded multiply and then
    a rounded subtract (the plain version's rounding); a pivot's column (its
    x) and its row go into W as they stand when it is chosen, and the last
    pending updates reach W when the elimination stops. Returns rrlu_plain's
    6-tuple."""
    from tci_tpu_torch.ops.lu_kernel import _abs2, _div, _first, _mul

    mp, npd = A.shape
    dt, rdt = A.dtype, A.dtype.to_real()
    W = A.clone()
    rows, cols = torch.arange(mp), torch.arange(npd)
    rowperm, colperm = rows.clone(), cols.clone()
    rowpos, colpos = rows.clone(), cols.clone()
    rt, at = torch.tensor(reltol, dtype=rdt), torch.tensor(abstol, dtype=rdt)
    one, neg1 = torch.ones((), dtype=dt), -torch.ones((), dtype=rdt)
    mags = torch.zeros(min(mp, npd), dtype=rdt)
    maxerror = torch.zeros((), dtype=rdt)
    err = torch.full((), float("nan"), dtype=rdt)
    pending = []  # (x, y) of the pivots whose update W lacks

    def live(k):
        return (((rowpos >= k) & (rows < m))[:, None]
                & ((colpos >= k) & (cols < n))[None, :])

    def current(k):
        V, mask = W.clone(), live(k)
        for x, y in pending:
            V = torch.where(mask, V - _mul(x[:, None], y[None, :]), V)
        return V

    k = 0
    while k < maxrank:
        V = current(k)
        validc = (colpos >= k) & (cols < n)
        validr = (rowpos >= k) & (rows < m)
        cm = torch.where(validc, torch.where(validr[:, None], _abs2(V),
                                             neg1).amax(0), neg1)
        M = cm.max()
        if bool(M < 0):
            err = torch.zeros((), dtype=rdt)
            break
        bestcolpos = min(_first(cm, M, validc, colpos), npd - 1)
        pc = int(colperm[bestcolpos])
        met = torch.where(validr, _abs2(V[:, pc]), neg1)
        Mr = met.max()
        bestrowpos = min(_first(met, Mr, validr, rowpos), mp - 1)
        pr = int(rowperm[bestrowpos])
        newerr = torch.sqrt(torch.clamp(Mr, min=0))
        stop = k > 0 and (bool(newerr < rt * maxerror) or bool(newerr < at))
        stop = stop or bool(Mr < 0) or (k > 0 and bool(newerr == 0))
        err = newerr
        if stop:
            break
        r_at_k, c_at_k = int(rowperm[k]), int(colperm[k])
        rowperm[bestrowpos], rowperm[k] = r_at_k, pr
        rowpos[r_at_k], rowpos[pr] = bestrowpos, k
        colperm[bestcolpos], colperm[k] = c_at_k, pc
        colpos[c_at_k], colpos[pc] = bestcolpos, k
        safe = torch.where(V[pr, pc] != 0, V[pr, pc], one)
        x = _div(V[:, pc], safe) if leftorthogonal else V[:, pc]
        y = V[pr, :] if leftorthogonal else _div(V[pr, :], safe)
        urow = (rowpos >= k + 1) & (rows < m)
        ucol = (colpos >= k + 1) & (cols < n)
        # column pc takes x, row pr its entries (left-orthogonal) or y, and
        # its pivot, as they stand now: no later pass touches them
        W[:, pc] = torch.where(urow, x, W[:, pc])
        W[pr, :] = torch.where(ucol, y, W[pr, :])
        W[pr, pc] = V[pr, pc]
        pending.append((x, y))
        mags[k] = newerr
        maxerror = torch.maximum(maxerror, newerr)
        k += 1
        if len(pending) == depth:
            W = current(k)
            pending.clear()
    if pending:
        W = current(k)
    return (W[rowperm][:, colperm], rowperm, colperm,
            torch.tensor(k, dtype=torch.int64), mags, err)


def _deferred_panel(case):
    """(A, m, n, maxrank, reltol, abstol) of a zero-padded panel."""
    rng = np.random.default_rng(17)
    if case == "complex":
        A = ((rng.standard_normal((30, 12)) + 1j * rng.standard_normal(
            (30, 12))) @ rng.standard_normal((12, 26)))
        args = (30, 26, 30, 1e-10, 0.0)
    elif case == "reltol":
        A = (rng.standard_normal((36, 20)) * 10.0 ** -np.arange(20)
             ) @ rng.standard_normal((20, 33))
        args = (36, 33, 36, 1e-6, 0.0)
    elif case == "abstol":
        A = (rng.standard_normal((40, 16)) * 2.0 ** -np.arange(16)
             ) @ rng.standard_normal((16, 40))
        args = (40, 40, 40, 0.0, 1e-3)
    elif case == "no_column_left":
        A = rng.standard_normal((37, 9))
        args = (37, 9, 37, 0.0, 0.0)
    elif case == "nan":
        A = rng.standard_normal((24, 24))
        A[5, 7] = np.nan
        args = (24, 24, 24, 0.0, 0.0)
    else:  # "maxrank": a cap that is no multiple of any depth
        A = rng.standard_normal((41, 35))
        args = (41, 35, 23, 0.0, 0.0)
    m, n = A.shape
    P = np.zeros((m + 7, n + 5), dtype=A.dtype)  # padding rows and columns
    P[:m, :n] = A
    return (torch.from_numpy(P),) + args


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("case", ["maxrank", "reltol", "abstol",
                                  "no_column_left", "complex", "nan"])
def test_deferred_write_back_matches_plain(case, leftorthogonal, depth):
    """The streamed grid regime's deferred write-back, modelled on the CPU
    (_rrlu_deferred): bit for bit lu_kernel.rrlu_plain (the pivot order, k,
    err, the magnitudes and the swapped-layout LU buffer) at depths 1, 2
    and 4 (the kernel's), through every stop rule and a NaN panel."""
    P, m, n, cap, rt, at = _deferred_panel(case)
    out = _rrlu_deferred(P, m, n, cap, rt, at, leftorthogonal, depth)
    ref = lu_kernel.rrlu_plain(P, m, n, cap, rt, at,
                               leftorthogonal=leftorthogonal)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        assert bool(((o == r) | (o.isnan() & r.isnan())).all())


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("case", ["maxrank", "reltol", "abstol",
                                  "no_column_left", "complex"])
def test_deferred_write_back_matches_tci_tpu(case, leftorthogonal):
    """The same model against tci_tpu.rrlu on the true extents: the same
    pivot order, npivot and pivot magnitudes. Not bit for bit: tci_tpu's
    elimination is not bitwise the plain version's either (XLA on the CPU
    may fuse the update into one multiply-add; this file's header), so the
    magnitudes are held to this file's 1e-12 of max|A|."""
    P, m, n, cap, rt, at = _deferred_panel(case)
    A = P[:m, :n].numpy()
    ref = tci_tpu.rrlu(A, leftorthogonal=leftorthogonal, maxrank=cap,
                       reltol=rt, abstol=at)
    _, rowperm, colperm, k, mags, _ = _rrlu_deferred(
        P, m, n, cap, rt, at, leftorthogonal, 4)
    assert int(k) == ref.npivots()
    np.testing.assert_array_equal(rowperm[:m].numpy(), ref.rowpermutation)
    np.testing.assert_array_equal(colperm[:n].numpy(), ref.colpermutation)
    np.testing.assert_allclose(mags[:int(k)].numpy(),
                               ref.pivoterrors()[:int(k)], rtol=0,
                               atol=1e-12 * np.abs(A).max())
