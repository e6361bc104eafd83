"""The port's data-parallel paths on gloo groups of 2 and 4 spawned CPU
ranks (tests/_torch_mesh.py), the twins of tests/test_multichip.py: the
sharded evaluator, ``tt_evaluate_sharded``, ``crossinterpolate2`` (full and
rook pivoting), the floating-zone search and ``integrate`` on the mesh,
against the same work on one device and against tci_tpu; the dry run and
ex06; and the rank-0 seed of the host draws that tci_tpu leaves unseeded.

Tolerances: on the mesh every rank gets the one-device result bit for bit
(each row is sampled by the same f on one rank, the values are gathered
as they are, and the rrLU runs replicated). Against tci_tpu as in
tests/test_multichip.py (1e-12 relative for the sharded TT evaluation).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_mesh as tm
import tci_tpu_torch as tci
from tci_tpu.models.jaxeval import pad_cores as tci_pad_cores
from tci_tpu.models.jaxeval import tt_evaluate_sharded as tci_tt_sharded
from tci_tpu.parallel.mesh import default_mesh as tci_default_mesh
from tci_tpu_torch.models.globalsearch import estimatetrueerror

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def ranks(request, tmp_path_factory):
    return tm.run_ranks(request.param,
                        tmp_path_factory.mktemp(f"mc{request.param}"),
                        "multichip")


@pytest.fixture(scope="module", params=[2, 4], ids=["ranks2", "ranks4"])
def slow_ranks(request, tmp_path_factory):
    return tm.run_ranks(request.param,
                        tmp_path_factory.mktemp(f"mcs{request.param}"),
                        "multichip_slow")


def _one_device(f, dims, **kw):
    bf = tci.TorchBatchEvaluator(f, dims, device="cpu")
    return bf, tm.run_tci(bf, dims, **kw)


@pytest.mark.slow
def test_crossinterpolate2_on_mesh_matches_single_device(slow_ranks):
    tm.same_on_every_rank(slow_ranks, "cross")
    _, one = _one_device(tm.lorentz, [3] * 5, tolerance=1e-8, maxiter=4,
                         rng=np.random.default_rng(7))
    ranks, errors, value, nevals = slow_ranks[0]["cross"]
    assert ranks == one[0] and errors == one[1] and value == one[2]
    assert nevals == one[3]


def test_sharded_torch_evaluator(ranks):
    """B = 37 rows on 2 and 4 ranks: padded to the mesh size, cut back;
    nevals counts the global batch."""
    tm.same_on_every_rank(ranks, "evaluator")
    vals, nevals, panel = ranks[0]["evaluator"]
    idx = np.random.default_rng(0).integers(0, 4, size=(37, 6))
    ref = np.array([1.0 / (1.0 + ((r + 1.0) ** 2).sum())
                    for r in idx.astype(float)])
    assert vals.shape == (37,) and np.allclose(vals, ref, rtol=1e-15)
    assert nevals == 37
    one = tci.TorchBatchEvaluator(tm.lorentz, [4] * 6, device="cpu")
    np.testing.assert_array_equal(vals, one.evaluate_many(idx).numpy())
    np.testing.assert_array_equal(
        panel, one.batch_evaluate([(0,), (1,)], [(2,), (3,)], 4).numpy())


def test_default_mesh_refuses_cpu_fallback():
    """tci_tpu's default_mesh(8) falls back to virtual CPU devices; the
    port's raises (C-port-16; tests/test_torch_lu_sharded.py holds the
    message), and builds its one-rank mesh only when asked for one."""
    with pytest.raises(RuntimeError, match="torchrun"):
        tci.parallel.mesh.default_mesh(8, device="cpu")


@pytest.mark.slow
def test_dryrun_and_ex06(slow_ranks):
    """The dry run on every rank of the group (tci_tpu's
    dryrun_multichip), then ex06 as a process of its own that spawns two
    gloo ranks."""
    tm.same_on_every_rank(slow_ranks, "dryrun")
    assert "ok" in slow_ranks[0]["dryrun"]
    proc = subprocess.run(
        [sys.executable, "-m", "tci_tpu_torch.examples.ex06_multichip_mesh",
         "--device", "cpu", "--ranks", "2"], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.slow
def test_rook_on_mesh_matches_single_device(slow_ranks):
    tm.same_on_every_rank(slow_ranks, "rook")
    bf = tci.TorchBatchEvaluator(tm.lorentz, [3] * 5, device="cpu")
    bf.device_sweep_engine._rng = np.random.default_rng(11)
    one = tm.run_tci(bf, [3] * 5, tolerance=1e-8, maxiter=4,
                     pivotsearch="rook", rng=np.random.default_rng(7))
    assert slow_ranks[0]["rook"] == one


@pytest.mark.slow
def test_floatingzone_on_mesh_matches_single_device(slow_ranks):
    tm.same_on_every_rank(slow_ranks, "fzone")
    bf = tci.TorchBatchEvaluator(tm.fzone_f, [4] * 5, device="cpu")
    t, _, _ = tci.crossinterpolate2(np.float64, bf, [4] * 5, tolerance=1e-2,
                                    maxbonddim=4, device="cpu",
                                    rng=np.random.default_rng(5))
    found = estimatetrueerror(tci.tensortrain(t), bf,
                              initialpoints=[tuple(map(int, s))
                                             for s in tm.FZONE_STARTS])
    pivots, errors = slow_ranks[0]["fzone"]
    assert pivots == [p for p, _ in found]
    assert errors == [e for _, e in found]


def test_tt_evaluate_sharded_matches_single_device(ranks):
    """Serving path: the sharded evaluation is the one-device evaluation
    bit for bit, and tci_tpu's sharded evaluation to 1e-12."""
    tm.same_on_every_rank(ranks, "tt_eval")
    sharded, single = ranks[0]["tt_eval"]
    np.testing.assert_array_equal(sharded, single)
    cores, idx = tm.tt_inputs()
    ref = tci_tt_sharded(jax.numpy.asarray(tci_pad_cores(cores)),
                         jax.numpy.asarray(idx.astype(np.int32)),
                         tci_default_mesh(8))
    np.testing.assert_allclose(sharded, np.asarray(ref), rtol=1e-12)
    tt = tci.TensorTrain(cores, device="cpu")
    for i in (0, 5, 36):
        assert abs(sharded[i] - tt.evaluate(tuple(idx[i]))) < 1e-10


@pytest.mark.slow
def test_integrate_on_mesh_matches_single_device(slow_ranks):
    tm.same_on_every_rank(slow_ranks, "integrate")
    one = tci.integrate(np.float64, tm.integrand, [0.0] * 4, [1.0] * 4,
                        GKorder=15, torch_native=True, tolerance=1e-10,
                        rng=np.random.default_rng(3), device="cpu")
    exact = 0.5 ** 4 + 4 / 3.0
    assert abs(one - exact) < 1e-8
    assert slow_ranks[0]["integrate"] == one


def test_integrate_mesh_requires_torch_native(ranks):
    assert "torch_native=True" in ranks[0]["integrate_requires_native"]


def test_unseeded_draws_come_from_rank_0(ranks):
    """Every rank starts from another global numpy state (the worker seeds
    it by rank). optimize's default rng, the engine's rook seeds and
    mesh_rng are drawn from rank 0's seed, so the ranks run one TCI."""
    tm.same_on_every_rank(ranks, "unseeded")
    tm.same_on_every_rank(ranks, "unseeded_draws")
    ranks_, errors, _ = ranks[0]["unseeded"]
    assert ranks_[-1] >= 1 and errors[-1] < 1e-8
