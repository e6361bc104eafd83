"""The port's row-sharded rrLU (ops/lu_sharded.py) on gloo groups of 2, 3
and 4 spawned CPU ranks (tests/_torch_mesh.py), against tci_tpu's
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
from tci_tpu.ops.lu_kernel import rrlu_raw as tci_rrlu_raw
from tci_tpu.ops.lu_sharded import rrlu_sharded_raw as tci_sharded_raw
from tci_tpu.parallel.mesh import default_mesh as tci_default_mesh
from tci_tpu_torch.ops import lu_sharded
from tci_tpu_torch.ops.lu import rrlu
from tci_tpu_torch.ops.lu_kernel import rrlu_plain, rrlu_raw
from tci_tpu_torch.parallel.mesh import default_mesh

LU = tm.lu_inputs()
PANELS = tm.panel_inputs()


@pytest.fixture(scope="module", params=[2, 3, 4],
                ids=["ranks2", "ranks3", "ranks4"])
def ranks(request, tmp_path_factory):
    """Every case of this file on one gloo group of 2, 3 or 4 ranks (3: the
    rows split unevenly before padding)."""
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
    plain elimination on the same zero-padded panel (rows padded to a
    multiple of the ranks), bit for bit, in float32, float64 and
    complex128: with a NaN (one on the last rank), a dead tail, dead
    columns, and the largest |a|^2 tied across rank boundaries in one
    column, in two columns and at every step of a sign matrix. Each rank
    decides from the gathered candidates alone, so this holds the
    per-rank lexicographic rule to the one-device two-stage rule."""
    Ap, m, n, maxrank, reltol, abstol, lo = PANELS[name]
    tm.same_on_every_rank(ranks, f"panel_{name}")
    got = ranks[0][f"panel_{name}"]
    Ap = tm.pad_rows(Ap, len(ranks))
    want = rrlu_plain(torch.from_numpy(Ap), m, n, maxrank, reltol, abstol,
                      leftorthogonal=lo)
    for g, w in zip(got, want):
        w = w.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("name", tm.TIE_PANELS)
def test_tie_panels_match_tci_tpu(ranks, mesh8, name):
    """The panels where the per-rank rule could part from tci_tpu's
    (ties of the largest |a|^2 across rank boundaries, a sign matrix, a
    NaN on the last rank, dead columns), on their true extents: npivot and
    the pivot order of tci_tpu's one-device rrlu_raw and of its
    rrlu_sharded_raw on its 8-device mesh, which takes the MIN of the
    first occurrence over the devices; the pivot magnitudes to numpy's
    default closeness. tci_tpu's sharded elimination does not follow its
    one-device NaN rule (ROADMAP C-ref-7, pinned by the test below), so the
    NaN panel is held against the one-device elimination alone."""
    Ap, m, n, maxrank, reltol, abstol, lo = PANELS[name]
    _, rp, cp, k, mags, err = ranks[0][f"panel_{name}"]
    A = Ap[:m, :n]
    refs = [tci_rrlu_raw(A, maxrank, reltol, abstol, lo)]
    if not np.isnan(A).any():
        refs.append(tci_sharded_raw(A, maxrank, reltol, abstol, lo,
                                    mesh=mesh8))
    k = int(k)
    for ref in refs:
        assert k == ref[3]
        np.testing.assert_array_equal(rp[:k], np.asarray(ref[1])[:k])
        np.testing.assert_array_equal(cp[:k], np.asarray(ref[2])[:k])
        np.testing.assert_allclose(mags[:k], np.asarray(ref[4])[:k])


@pytest.mark.parametrize("name", ["nan", "nan_last_rank"])
def test_tci_sharded_breaks_its_nan_rule_c_ref_7(mesh8, name):
    """ROADMAP C-ref-7, a fault of the reference, pinned: on a panel with a
    NaN, tci_tpu's one-device rrlu_raw takes the NaN as its first pivot
    (its row and column lead the orders; the pivots and err are NaN), and
    so do the port's one-device and sharded eliminations (the test above);
    tci_tpu's rrlu_sharded_raw on its 8-device mesh does not: its column
    order is one column repeated, the last, so not a permutation, and its
    pivots and err are finite. A fix of the reference fails here."""
    Ap, m, n, maxrank, reltol, abstol, lo = PANELS[name]
    A = Ap[:m, :n]
    (r, c), = np.argwhere(np.isnan(A))
    one = tci_rrlu_raw(A, maxrank, reltol, abstol, lo)
    assert (int(one[1][0]), int(one[2][0])) == (r, c)
    assert np.isnan(np.asarray(one[4])[0]) and np.isnan(one[5])
    port = rrlu_raw(A, maxrank, reltol, abstol, lo, device="cpu")
    assert (int(port[1][0]), int(port[2][0])) == (r, c)
    sharded = tci_sharded_raw(A, maxrank, reltol, abstol, lo, mesh=mesh8)
    assert sharded[3] == one[3] == min(m, n)
    np.testing.assert_array_equal(np.asarray(sharded[2]),
                                  np.full(n, n - 1))
    assert np.isfinite(np.asarray(sharded[4])).all()
    assert np.isfinite(sharded[5])


@pytest.mark.parametrize("depth", tm.DEFER_DEPTHS)
@pytest.mark.parametrize("name", list(PANELS))
def test_deferred_write_back_matches_one_device_plain(ranks, name, depth):
    """The step's plain version with the write-back deferred over `depth`
    steps (each pass rebuilds the live entries from the buffer by the
    pending updates; the pivot's column and row go to the buffer as they
    end; the last pivot and a stop write everything back), row-sharded,
    bit for bit the one-device plain elimination on every panel."""
    Ap, m, n, maxrank, reltol, abstol, lo = PANELS[name]
    key = f"panel_{name}_defer{depth}"
    tm.same_on_every_rank(ranks, key)
    want = rrlu_plain(torch.from_numpy(tm.pad_rows(Ap, len(ranks))), m, n,
                      maxrank, reltol, abstol, leftorthogonal=lo)
    for g, w in zip(ranks[0][key], want):
        w = w.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("name", list(PANELS))
def test_one_gather_a_step(ranks, name):
    """Each elimination makes steps + 1 phase calls (the first candidate,
    then one a step) and one gather of the slots after each: one collective
    a pivot step. A call of at most CHECK_EVERY steps queues all of them;
    a longer one stops queuing at the first flag read after its stop."""
    Ap, m, n, maxrank, reltol, abstol, lo = PANELS[name]
    tm.same_on_every_rank(ranks, f"counts_{name}")
    calls, gathers = ranks[0][f"counts_{name}"]
    k = int(ranks[0][f"panel_{name}"][3])
    steps = calls - 1
    assert gathers == calls == steps + 1
    if maxrank <= lu_sharded.CHECK_EVERY:
        assert steps == maxrank
    else:
        assert k <= steps <= maxrank


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
