"""The port's mesh contraction and compression on gloo groups of 2 and 4
spawned CPU ranks (tests/_torch_mesh.py), the twins of
tests/test_contraction_mesh.py: every bond split's elimination is
row-sharded (``ops/lu_sharded.make_lu_split_sharded``) and the result must
be the one-device device tier's, bitwise, real and complex (tci_tpu
carries complex as (re, im) pairs; the port runs complex128 natively, so
its complex results are bitwise too), and the linkdims tci_tpu's.
"""

import numpy as np
import pytest
import torch

import _torch_mesh as tm
from tci_tpu.models.contraction import contract as tci_contract
from tci_tpu.models.tensortrain import TensorTrain as TciTensorTrain
from tci_tpu.parallel.mesh import default_mesh as tci_default_mesh
from tci_tpu_torch.models.contraction import contract, contract_zipup
from tci_tpu_torch.models.tensortrain import TensorTrain, fulltensor

INPUTS = tm.contraction_inputs()


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def ranks(request, tmp_path_factory):
    return tm.run_ranks(request.param,
                        tmp_path_factory.mktemp(f"cm{request.param}"),
                        "contraction")


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def slow_ranks(request, tmp_path_factory):
    return tm.run_ranks(request.param,
                        tmp_path_factory.mktemp(f"cms{request.param}"),
                        "contraction_slow")


def _trains(name):
    return tuple(TensorTrain(x, device="cpu") for x in INPUTS[name])


def _bits_equal(cores, tt):
    """The mesh result's cores are the one-device train's, bitwise."""
    ref = [t.numpy() for t in tt.sitetensors()]
    assert [c.shape for c in cores] == [r.shape for r in ref]
    for c, r in zip(cores, ref):
        np.testing.assert_array_equal(c, r)


def _linkdims(cores):
    return [c.shape[-1] for c in cores[:-1]]


def _one_zipup(name):
    A, B = _trains(name)
    return contract_zipup(A, B, tolerance=1e-10, method="LU",
                          torch_native=True)


def test_zipup_mesh_bit_identical(ranks):
    tm.same_on_every_rank(ranks, "zipup")
    _bits_equal(ranks[0]["zipup"], _one_zipup("zipup"))
    A, B = (TciTensorTrain(x) for x in INPUTS["zipup"])
    ref = tci_contract(A, B, algorithm="zipup", method="LU",
                       tolerance=1e-10, jax_native=True,
                       mesh=tci_default_mesh(8))
    assert _linkdims(ranks[0]["zipup"]) == list(ref.linkdims())


def test_naive_mesh_bit_identical(ranks):
    tm.same_on_every_rank(ranks, "naive")
    A, B = _trains("naive")
    one = contract(A, B, algorithm="naive", tolerance=1e-10,
                   torch_native=True)
    _bits_equal(ranks[0]["naive"], one)
    exact = fulltensor(contract(A, B, algorithm="naive")).numpy()
    got = fulltensor(TensorTrain(ranks[0]["naive"], device="cpu")).numpy()
    assert np.allclose(got, exact, atol=1e-9 * np.abs(exact).max())


def _one_compress(name):
    tt = TensorTrain(INPUTS[name], device="cpu")
    tt.compress("LU", tolerance=1e-10, torch_native=True)
    return tt


def test_compress_mesh_bit_identical(ranks):
    tm.same_on_every_rank(ranks, "compress")
    one = _one_compress("compress")
    assert max(one.linkdims()) <= 3 + 1  # genuinely truncated
    _bits_equal(ranks[0]["compress"], one)


def test_compress_mesh_complex_pair(ranks):
    """Complex chains: bitwise the one-device complex128 compression, and
    the host compression to rounding (tci_tpu's check)."""
    tm.same_on_every_rank(ranks, "compress_complex")
    _bits_equal(ranks[0]["compress_complex"],
                _one_compress("compress_complex"))
    host = TensorTrain(INPUTS["compress_complex"], device="cpu")
    host.compress("LU", tolerance=1e-10)
    fh = fulltensor(host).numpy()
    fm = fulltensor(TensorTrain(ranks[0]["compress_complex"],
                                device="cpu")).numpy()
    assert np.allclose(fh, fm, atol=1e-9 * np.abs(fh).max())


def test_zipup_mesh_complex_pair(ranks):
    tm.same_on_every_rank(ranks, "zipup_complex")
    _bits_equal(ranks[0]["zipup_complex"], _one_zipup("zipup_complex"))
    A, B = _trains("zipup_complex")
    host = contract_zipup(A, B, tolerance=1e-10, method="LU")
    assert _linkdims(ranks[0]["zipup_complex"]) == host.linkdims()


@pytest.mark.slow
def test_tci_mesh_matches_single_device(slow_ranks):
    """contract_TCI on the mesh: the one-device linkdims and the exact
    product; with no rng its draws come from rank 0's seed (C-ref-6), so
    the ranks agree."""
    tm.same_on_every_rank(slow_ranks, "tci")
    tm.same_on_every_rank(slow_ranks, "tci_unseeded")
    A, B = _trains("tci")
    single = contract(A, B, algorithm="TCI", tolerance=1e-10,
                      torch_native=True, rng=np.random.default_rng(3))
    exact = fulltensor(contract(A, B, algorithm="naive")).numpy()
    for key in ("tci", "tci_unseeded"):
        linkdims, full = slow_ranks[0][key]
        assert linkdims == single.linkdims()
        assert np.allclose(full, exact, atol=1e-8 * np.abs(exact).max())


def test_mesh_split_reads_the_stop_flag(ranks):
    """A mesh split that stops by its tolerance (rank 3 of a cap of 70)
    reads the stop flag after CHECK_EVERY steps and queues no step past
    that read; its factors are the one-device split's, bitwise."""
    from tci_tpu_torch.models.contraction_device import _split_for
    from tci_tpu_torch.ops.lu_sharded import CHECK_EVERY

    tm.same_on_every_rank(ranks, "split_stop")
    left, right, k, steps, reads = ranks[0]["split_stop"]
    one = _split_for(None, 90, 70, 70, True)(
        torch.from_numpy(INPUTS["split_stop"]), 90, 70, 1e-12, 0.0)
    assert k == int(one[2]) == 3
    np.testing.assert_array_equal(left, one[0].numpy())
    np.testing.assert_array_equal(right, one[1].numpy())
    assert (steps, reads) == (CHECK_EVERY, 1)


def test_mesh_requires_torch_native(ranks):
    assert ranks[0]["requires_native"] == ["mesh= requires "
                                           "torch_native=True"] * 2


def test_mesh_extent_invariance_real_and_pair(ranks):
    """The results do not depend on the mesh size: on 2 and on 4 ranks they
    are the one-device results, bit for bit, real and complex."""
    for name in ("zipup", "zipup_complex"):
        _bits_equal(ranks[0][name], _one_zipup(name))
