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
from tci_tpu_torch.ops import lu_cuda

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


def _case(name):
    rng = np.random.default_rng(42)
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
         "maxrank", "small_values", "wide_rank40", "rank60"]


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


def test_rrlu_tensor_input_stays_on_its_device():
    A, _ = _case("random")
    out = tci_tpu_torch.rrlu(torch.from_numpy(A))
    assert out.L.device.type == "cpu" and out.L.dtype == torch.float64
    np.testing.assert_allclose(_np(out.left() @ out.right()), A, atol=1e-12)


def test_rrlu_unported_options_raise():
    A = np.eye(4)
    with pytest.raises(NotImplementedError, match="A9"):
        tci_tpu_torch.rrlu(A, pivotsearch="rook", device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        tci_tpu_torch.rrlu(A, mesh=object(), device="cpu")


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
