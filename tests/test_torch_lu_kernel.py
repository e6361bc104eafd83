"""Plain PyTorch rrLU elimination (tci_tpu_torch.ops.lu_kernel) against the
JAX package's elimination (_rrlu_while) and its Pallas kernel run in
interpret mode, on the same numpy panels.

Tolerances: pivot order and npivot must be identical (exact ties are broken
by position on both sides). LU entries, pivot magnitudes and err agree to
1e-13 of max|A| in float64 and 1e-5 in float32, multipliers to that bound
divided by their pivot's magnitude: XLA on the CPU may contract the Schur
update's multiply and subtract into one fused multiply-add, which rounds
once where the port rounds twice, so entries formed by many updates differ
in their last bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tci_tpu.ops.lu_kernel import _rrlu_while
from tci_tpu.ops.pallas_lu import pallas_rrlu_batched, pallas_rrlu_call
from tci_tpu_torch.ops import lu_cuda, lu_kernel

torch.set_num_threads(1)

ATOL = {np.float64: 1e-13, np.float32: 1e-5}


def _jax_args(A, m, n, maxrank, reltol, abstol):
    return (jnp.asarray(A), jnp.int32(m), jnp.int32(n), jnp.int32(maxrank),
            jnp.float64(reltol), jnp.float64(abstol))


def _assert_same(ref, out, m, n, dtype, scale, leftorthogonal=True):
    rA, rrp, rcp, rk, rmags, rerr = (np.asarray(x) for x in ref)
    oA, orp, ocp, ok, omags, oerr = (x.numpy() for x in out)
    k = int(rk)
    assert int(ok) == k
    np.testing.assert_array_equal(orp[:m], rrp[:m])
    np.testing.assert_array_equal(ocp[:n], rcp[:n])
    atol = ATOL[dtype] * scale
    np.testing.assert_allclose(np.float64(oerr), np.float64(rerr), rtol=0,
                               atol=atol, equal_nan=True)
    np.testing.assert_allclose(omags[:k], rmags[:k], rtol=0, atol=atol)
    # A multiplier is an entry divided by its pivot, so its rounding error
    # is the entry's divided by |pivot|.
    tol = np.full((m, n), atol)
    for j in range(k):
        if rmags[j] > 0:
            if leftorthogonal:
                tol[j + 1:, j] = atol / rmags[j]
            else:
                tol[j, j + 1:] = atol / rmags[j]
    assert np.all(np.abs(oA[:m, :n] - rA[:m, :n]) <= tol)


def _lorentzian_panel(rng, nrow_sets=12, ncol_sets=12, d=10):
    """A 120 x 120 Π panel of 1/(1 + |v|^2), v = index + 1: prefixes and
    suffixes drawn from {0..9}^3, so many entries tie exactly."""
    left = rng.integers(0, d, size=(nrow_sets, 3))
    right = rng.integers(0, d, size=(ncol_sets, 3))
    s = np.array([((p + 1.0) ** 2).sum() + (c + 1.0) ** 2
                  for p in left for c in range(d)])
    t = np.array([(c + 1.0) ** 2 + ((q + 1.0) ** 2).sum()
                  for c in range(d) for q in right])
    return 1.0 / (1.0 + s[:, None] + t[None, :])


CASES = {
    # (mp, np, m_true, n_true, maxrank, reltol, abstol): padding + rank cap
    "padded_maxrank": (16, 16, 12, 14, 10, 1e-6, 0.0),
    # reltol stop on a numerically rank-5 panel, tall padding
    "reltol_stop": (32, 24, 30, 20, 20, 1e-3, 0.0),
    # exact pass (reltol = abstol = 0) on a wide panel
    "exact_wide": (16, 40, 16, 33, 16, 0.0, 0.0),
}


def _case_matrix(rng, name, mp, npd, m, n, dtype):
    A = np.zeros((mp, npd))
    if name == "reltol_stop":
        A[:m, :n] = (rng.standard_normal((m, 5)) @ rng.standard_normal((5, n))
                     + 1e-6 * rng.standard_normal((m, n)))
    else:
        A[:m, :n] = rng.standard_normal((m, n))
    return A.astype(dtype)


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_rrlu_while_and_pallas(case, dtype, leftorthogonal, rng):
    mp, npd, m, n, maxrank, reltol, abstol = CASES[case]
    A = _case_matrix(rng, case, mp, npd, m, n, dtype)
    args = _jax_args(A, m, n, maxrank, reltol, abstol)
    out = lu_kernel.rrlu_plain(torch.from_numpy(A), m, n, maxrank, reltol,
                               abstol, leftorthogonal=leftorthogonal)
    scale = float(np.abs(A).max())
    ref = _rrlu_while(*args, leftorthogonal=leftorthogonal)
    _assert_same(ref, out, m, n, dtype, scale, leftorthogonal)
    pal = pallas_rrlu_call(*args, leftorthogonal=leftorthogonal,
                           interpret=True)
    _assert_same(pal, out, m, n, dtype, scale, leftorthogonal)


@pytest.mark.parametrize("leftorthogonal", [True, False])
def test_plain_lorentzian_ties(leftorthogonal):
    """The main path's panels: exact ties must resolve to the reference's
    column-major first maximum in the swapped layout."""
    A = np.zeros((128, 128))
    A[:120, :120] = _lorentzian_panel(np.random.default_rng(7))
    assert len(np.unique(A[:120, :120])) < 120 * 120 // 4  # many exact ties
    # reltol 1e-10 stops before the pivots reach rounding noise, where the
    # multipliers are ratios of noise
    args = (A, 120, 120, 120, 1e-10, 0.0)
    ref = _rrlu_while(*_jax_args(*args), leftorthogonal=leftorthogonal)
    out = lu_kernel.rrlu_plain(torch.from_numpy(A), *args[1:],
                               leftorthogonal=leftorthogonal)
    assert int(out[3]) >= 10
    _assert_same(ref, out, 120, 120, np.float64, float(A.max()),
                 leftorthogonal)


@pytest.mark.parametrize("leftorthogonal", [True, False])
def test_batched_matches_pallas_batched(leftorthogonal, rng):
    """rrlu_panel_batched on CPU panels (the plain version per panel) against
    pallas_rrlu_batched in interpret mode, on the inputs of
    test_pallas_lu.test_pallas_batched_matches_per_panel."""
    B, m, n = 4, 32, 24
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    mt = np.array([32, 30, 32, 17], np.int32)
    nt = np.array([24, 24, 20, 24], np.int32)
    mr = np.array([24, 8, 24, 24], np.int32)
    rt = np.array([0.0, 0.0, 1e-3, 0.0], np.float32)
    at = np.zeros(4, np.float32)
    ref = pallas_rrlu_batched(
        jnp.asarray(A), jnp.asarray(mt), jnp.asarray(nt), jnp.asarray(mr),
        jnp.asarray(rt), jnp.asarray(at), leftorthogonal=leftorthogonal,
        interpret=True,
    )
    launches = lu_cuda.LAUNCHES["rrlu"]
    out = lu_kernel.rrlu_panel_batched(
        torch.from_numpy(A), torch.from_numpy(mt), torch.from_numpy(nt),
        torch.from_numpy(mr), torch.from_numpy(rt), torch.from_numpy(at),
        leftorthogonal=leftorthogonal,
    )
    assert lu_cuda.LAUNCHES["rrlu"] == launches
    scale = float(np.abs(A).max())
    for b in range(B):
        _assert_same([np.asarray(x)[b] for x in ref], [x[b] for x in out],
                     int(mt[b]), int(nt[b]), np.float32, scale,
                     leftorthogonal)


def test_plain_edge_returns():
    """maxrank = 0 gives err NaN and no pivot; an exactly rank-1 panel stops
    on the exactly-zero second pivot; an all-zero panel takes one zero pivot
    (the stop rule only applies once k > 0), as _rrlu_while does."""
    rank1 = np.outer([1.0, 2.0, 3.0, 4.0], [2.0, 1.0, 0.5, 0.25])
    for A, maxrank in ((rank1, 0), (rank1, 4), (np.zeros((8, 8)), 8)):
        m, n = A.shape
        args = (A, m, n, maxrank, 0.0, 0.0)
        ref = _rrlu_while(*_jax_args(*args), leftorthogonal=True)
        out = lu_kernel.rrlu_plain(torch.from_numpy(A), *args[1:],
                                   leftorthogonal=True)
        _assert_same(ref, out, m, n, np.float64, 1.0)
    assert int(out[3]) == 1 and float(out[5]) == 0.0


def test_bucket_matches_reference():
    from tci_tpu.ops.lu_kernel import bucket

    for n in list(range(1, 300)) + [1000, 2000, 4096]:
        assert lu_kernel.bucket(n) == bucket(n)
