"""The port's row-sharded rrLU (ops/lu_sharded.py) on gloo groups of 2 and
4 spawned CPU ranks (tests/_torch_mesh.py), against tci_tpu's
``rrlu_sharded_raw`` on its virtual 8-device CPU mesh and against the
port's one-device elimination, on the same numpy matrices (the cases of
tests/test_lu_sharded.py).

Tolerances: npivot and the permutations identical everywhere. Against the
port's one-device elimination the LU buffer, the pivots and err are
bitwise: each rank computes every element with the same arithmetic, and
the collectives carry bits. Against tci_tpu the LU buffer within 1e-12 of
max|A| and the pivot magnitudes to numpy's default closeness: XLA on the
CPU may fuse the Schur update into one multiply-add.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_mesh as tm
from tci_tpu.ops.lu_sharded import rrlu_sharded_raw as tci_sharded_raw
from tci_tpu.parallel.mesh import default_mesh as tci_default_mesh
from tci_tpu_torch.ops import lu_sharded
from tci_tpu_torch.ops.lu import rrlu
from tci_tpu_torch.ops.lu_kernel import rrlu_plain, rrlu_raw
from tci_tpu_torch.parallel.mesh import default_mesh

LU = tm.lu_inputs()
PANELS = tm.panel_inputs()


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def ranks(request, tmp_path_factory):
    """Every case of this file on one gloo group of 2 or 4 ranks."""
    return tm.run_ranks(request.param,
                        tmp_path_factory.mktemp(f"lu{request.param}"), "lu")


@pytest.fixture(scope="module")
def mesh8():
    return tci_default_mesh(8)


@pytest.mark.parametrize("name", list(LU))
def test_sharded_matches_tci_tpu_and_one_device(ranks, mesh8, name):
    A, maxrank, reltol, abstol, lo = LU[name]
    tm.same_on_every_rank(ranks, name)
    LUs, rp, cp, k, diag, err = ranks[0][name]
    ref = tci_sharded_raw(A, maxrank, reltol, abstol, lo, mesh=mesh8)
    one = rrlu_raw(A, maxrank, reltol, abstol, lo, device="cpu")
    assert k == ref[3] == one[3]
    for got, want in ((rp, ref[1]), (cp, ref[2]), (rp, one[1]),
                      (cp, one[2])):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(LUs, ref[0], rtol=0,
                               atol=1e-12 * np.abs(A).max())
    np.testing.assert_array_equal(LUs, one[0].numpy())
    np.testing.assert_allclose(np.abs(diag), ref[4])
    np.testing.assert_array_equal(diag, one[4])
    assert err == one[5] or (np.isnan(err) and np.isnan(one[5]))
    if np.isfinite(ref[5]):
        assert np.isclose(err, ref[5])
    if name == "truncation":
        assert k == 6
    if name == "exact_zero":
        assert k == 1 and not np.isnan(LUs).any()


@pytest.mark.parametrize("name", list(PANELS))
def test_step_plain_matches_one_device_plain(ranks, name):
    """The step's plain version (what runs on the CPU and what the kernel
    is checked against on the card), row-sharded, against the one-device
    plain elimination on the same zero-padded panel, bit for bit, in
    float32, float64 and complex128, with a NaN and a dead tail."""
    Ap, m, n, maxrank, reltol, abstol, lo = PANELS[name]
    tm.same_on_every_rank(ranks, f"panel_{name}")
    got = ranks[0][f"panel_{name}"]
    want = rrlu_plain(torch.from_numpy(Ap), m, n, maxrank, reltol, abstol,
                      leftorthogonal=lo)
    for g, w in zip(got, want):
        w = w.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_cpu_blocks_take_the_plain_version(ranks):
    assert ranks[0]["plain_calls"] > 0
    assert ranks[0]["kernel_launches"] == 0


def test_sharded_empty_matrix_preserves_dtype(ranks):
    assert ranks[0]["empty_0x5"] == ("torch.complex128", 0)
    assert ranks[0]["empty_4x0"] == ((4, 0), 0)


def test_sharded_rrlu_object(ranks):
    """rrlu_sharded reconstructs A like the one-device rrlu object."""
    tm.same_on_every_rank(ranks, "object")
    npivot, recon, A = ranks[0]["object"]
    assert npivot == rrlu(A, reltol=1e-12, device="cpu").npivot == 9
    assert np.allclose(recon, A, atol=1e-10 * np.abs(A).max())


def test_rrlu_mesh_kwarg(ranks):
    """rrlu(mesh=...) takes the sharded elimination and returns the
    one-device rrLU."""
    tm.same_on_every_rank(ranks, "rrlu_mesh")
    npivot, rp, cp, left, A = ranks[0]["rrlu_mesh"]
    one = rrlu(A, reltol=1e-12, device="cpu")
    assert npivot == one.npivot == 7
    np.testing.assert_array_equal(rp, one.rowpermutation)
    np.testing.assert_array_equal(cp, one.colpermutation)
    np.testing.assert_array_equal(left, one.left().numpy())


def test_rrlu_mesh_rook_raises(ranks):
    assert "single-device" in ranks[0]["rook_refused"]


def test_default_mesh_refuses_more_ranks_than_the_group(ranks):
    """ROADMAP C-port-16: tci_tpu's default_mesh falls back to virtual CPU
    devices; the port raises and names torchrun."""
    assert "torchrun --nproc-per-node" in ranks[0]["too_many_ranks"]


def test_default_mesh_refuses_without_a_group():
    """C-port-16 without a process group: more than one rank raises."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        default_mesh(4, device="cpu")
    assert not dist.is_initialized()


def test_sharded_default_mesh_single_device():
    """Without a group, a one-rank mesh starts its own (gloo on the CPU);
    on it the collectives are trivial and the result is the one-device
    elimination's."""
    A = np.random.default_rng(5).standard_normal((20, 20))
    mesh = default_mesh(1, device="cpu")
    try:
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("batch",)
        s = lu_sharded.rrlu_sharded_raw(A, 20, 1e-14, 0.0, True, mesh=mesh)
        r = rrlu_raw(A, 20, 1e-14, 0.0, True, device="cpu")
        assert s[3] == r[3] == 20
        np.testing.assert_array_equal(s[1], r[1])
        assert torch.equal(s[0], r[0])
    finally:
        dist.destroy_process_group()
