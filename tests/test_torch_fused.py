"""The port's fused bond update and fused site tensors (tci_tpu_torch.ops.fused)
against tci_tpu.ops.fused, on the CPU.

The port runs its plain PyTorch elimination here, tci_tpu its own on JAX's
CPU backend; both take the same seeded panels and index sets.

Tolerances: pivot rows and columns identical. Factors and T = Π₁ · P^{-1}
to rtol 1e-12 (atol 1e-14 for entries near zero): both come from the same
pivots through triangular solves whose rounding differs between the two
libraries; a site tensor of a converged state, whose P block is
ill-conditioned, agrees to eps · cond(P) of its largest entry, the
rounding bound of the solve. Pivot errors to 1e-15 absolute on values of order 1: they are
magnitudes of Schur-updated entries, which the two packages round
differently (XLA on the CPU may fuse multiply and subtract).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tci_tpu.ops.fused as jfused
import tci_tpu_torch
from tci_tpu_torch.ops import fused, lu_kernel

torch.set_num_threads(1)

RTOL, ATOL, ERR_ATOL = 1e-12, 1e-14, 1e-15


def lorentz_jax(idx):
    v = idx.astype(jnp.float64) + 1.0
    return 1.0 / (1.0 + jnp.sum(v * v))


def lorentz_torch(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(dim=1))


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _eliminated(seed, mp, npd, m, n, rank, leftorthogonal):
    """A seeded (mp, np) panel of rank `rank` in its (m, n) corner, and its
    complete-pivot rrLU from the port's plain version."""
    rng = np.random.default_rng(seed)
    A = np.zeros((mp, npd))
    A[:m, :n] = rng.standard_normal((m, rank)) @ rng.standard_normal((rank, n))
    out = lu_kernel.rrlu_plain(torch.from_numpy(A), m, n, min(m, n), 1e-12,
                               0.0, leftorthogonal=leftorthogonal)
    return A, out


@pytest.mark.parametrize("leftorthogonal", [True, False])
def test_ci_factors_matches_tci_tpu(leftorthogonal):
    A, (LU, rowperm, colperm, k, _, _) = _eliminated(
        7, 32, 24, 27, 19, 11, leftorthogonal)
    k = int(k)
    assert k == 11
    left, right = fused.ci_factors(LU, rowperm, colperm, k, leftorthogonal)
    jleft, jright = jfused.ci_factors(
        jnp.asarray(LU.numpy()), jnp.asarray(rowperm.numpy()),
        jnp.asarray(colperm.numpy()), k, leftorthogonal, jnp.float64)
    _close(left[:, :k], jleft[:, :k])
    _close(right[:k], jright[:k])
    # the CI reconstructs the panel it came from
    _close(left[:, :k] @ right[:k], A, rtol=0, atol=1e-12 * np.abs(A).max())


@pytest.mark.parametrize("n_ip", [12, 9])
def test_panel_solve_pinv_matches_tci_tpu(n_ip):
    """T = Π₁ · P^{-1} with P padded to identity outside its n_ip x n_ip
    block (the fill's P blocks); the port solves a batch of one."""
    rng = np.random.default_rng(n_ip)
    n, r = 12, 20
    P = np.eye(n)
    P[:n_ip, :n_ip] = rng.standard_normal((n_ip, n_ip)) + 4 * np.eye(n_ip)
    Pi1 = rng.standard_normal((r, n))
    T = fused.panel_solve_pinv(torch.from_numpy(Pi1)[None],
                               torch.from_numpy(P)[None],
                               torch.tensor([n_ip]))[0]
    jT = jfused.panel_solve_pinv(jnp.asarray(Pi1), jnp.asarray(P), n_ip,
                                 jnp.float64)
    _close(T, jT)
    _close(T[:, :n_ip] @ torch.from_numpy(P[:n_ip, :n_ip]), Pi1[:, :n_ip],
           rtol=0, atol=1e-12)


def _index_sets(rng, d, width, count):
    return list(dict.fromkeys(tuple(int(x) for x in rng.integers(0, d, width))
                              for _ in range(count)))


@pytest.mark.parametrize("leftorthogonal,maxrank", [
    (True, 2**62), (False, 2**62),
    # the truncation case of tests/test_fused.py
    (True, 2), (False, 2)])
def test_fused_bond_update_matches_tci_tpu(leftorthogonal, maxrank):
    rng = np.random.default_rng(1234)
    if maxrank == 2:
        Ic, Jc = _index_sets(rng, 4, 2, 12), _index_sets(rng, 4, 2, 12)
    else:
        Ic, Jc = _index_sets(rng, 3, 3, 7), _index_sets(rng, 3, 3, 9)
    args = (Ic, Jc, 1e-14 if maxrank == 2 else 1e-10, 0.0, maxrank,
            leftorthogonal)
    port = fused.FusedBondUpdater(lorentz_torch, device="cpu")
    ref = jfused.FusedBondUpdater(lorentz_jax)
    left, right, rowind, colind, perrs, err, maxsample = port.update(*args)
    jl, jr, jrow, jcol, jperrs, jerr, jmax = ref.update(*args)
    assert list(rowind) == list(jrow) and list(colind) == list(jcol)
    if maxrank == 2:
        assert len(rowind) == 2 and err > 0
    _close(left, jl)
    _close(right, jr)
    np.testing.assert_allclose(perrs, jperrs, rtol=0, atol=ERR_ATOL)
    assert err == pytest.approx(jerr, rel=0, abs=ERR_ATOL)
    assert maxsample == jmax
    assert port.nevals == ref.nevals and port.rrlu_calls == 1
    # without factors only the pivot record is formed
    out = port.update(*args, need_factors=False)
    assert out[0] is None and out[1] is None
    assert list(out[2]) == list(rowind) and list(out[3]) == list(colind)


def test_fused_site_tensors_match_tci_tpu():
    """T_b for every bond of a converged 5-site state."""
    dims = [4] * 5
    tci, _, _ = tci_tpu_torch.crossinterpolate2(
        np.float64, lambda x: 1.0 / (1.0 + sum((i + 1.0) ** 2 for i in x)),
        dims, tolerance=1e-6, rng=np.random.default_rng(0), device="cpu")
    port = fused.FusedSiteTensors(lorentz_torch, device="cpu")
    ref = jfused.FusedSiteTensors(lorentz_jax)
    for b in range(len(dims) - 1):
        args = (tci.Iset[b], dims[b], tci.Jset[b], tci.Iset[b + 1])
        T, maxsample = port.compute(*args)
        jT, jmax = ref.compute(*args)
        assert T.shape == jT.shape
        # the solves round differently in the two libraries: up to
        # eps · cond(P) of T's largest entry (tests/test_torch_tensorci2.py)
        P = np.array([[1.0 / (1.0 + sum((v + 1.0) ** 2 for v in i + j))
                       for j in tci.Jset[b]] for i in tci.Iset[b + 1]])
        atol = np.finfo(np.float64).eps * np.linalg.cond(P) * np.abs(jT).max()
        _close(T, jT, atol=max(ATOL, atol))
        assert float(maxsample) == jmax
    assert port.nevals == ref.nevals and port.rrlu_calls == len(dims) - 1


def test_batched_extents_from_tensors_are_clamped():
    """Per-panel extents that lie on a card are not read back: the kernel
    clamps them to the panel, and so does its plain version, the
    reference it is held to: an extent past the panel acts as the panel's
    own, a rank cap past min(m, n) as no cap."""
    rng = np.random.default_rng(5)
    A = torch.from_numpy(rng.standard_normal((3, 16, 16)))
    clamped = lu_kernel.rrlu_plain_batched(
        A, torch.tensor([99, 16, 16]), torch.tensor([16, 40, 16]),
        torch.tensor([16, 16, 500]), 0.0, 0.0, leftorthogonal=True)
    exact = lu_kernel.rrlu_panel_batched(A, 16, 16, 16, 0.0, 0.0,
                                         leftorthogonal=True)
    for c, e in zip(clamped, exact):
        assert torch.equal(c, e)
    assert clamped[3].tolist() == [16, 16, 16]


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("extents", [(17, 16, 16), (16, -1, 16),
                                     (16, 16, -2)])
def test_host_extents_that_do_not_fit_raise(extents, as_tensor, batched):
    """Extents given on the host (ints, or tensors on the CPU) are checked
    at no sync cost: one past the panel, or a negative one, raises instead
    of giving a factorization of another size."""
    A = torch.from_numpy(np.random.default_rng(6).standard_normal((16, 16)))
    if as_tensor:
        extents = [torch.tensor([v]) for v in extents]
    fn = lu_kernel.rrlu_panel_batched if batched else lu_kernel.rrlu_panel
    with pytest.raises(ValueError, match="do not fit"):
        fn(A[None] if batched else A, *extents, 0.0, 0.0,
           leftorthogonal=True)
