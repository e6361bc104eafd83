"""The end-to-end multi-device dry run, on a DeviceMesh.

Counterpart of ``tci_tpu/parallel/dryrun.py``. ``tci_tpu`` runs it on a
virtual n-device CPU mesh in one process; here every rank of the default
process group calls ``run(n)`` (SPMD: one process a device, NCCL on the
cards, gloo on the CPU), and without a group ``run(1)`` starts a one-rank
group. It runs the same checks, each against the same work on one device:

- the Lorentzian on {1..4}^6 by ``crossinterpolate2`` with the sampling
  sharded over the mesh (``TorchBatchEvaluator(mesh=)``), against f at a
  point;
- the sharded rrLU (``rrlu_sharded_raw``) against the one-device rrLU:
  pivot order, rank and LU buffer bitwise;
- the zip-up contraction and the compression on the mesh against the
  device tier on one device, cores bitwise;
- the serving rook (one-device by design) beside the mesh;
- the GK integral on the mesh against the one-device integral.

Rank 0 prints the summary line, which ``run`` returns on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.contraction import contract
from ..models.integration import integrate
from ..models.tensorci2 import crossinterpolate2
from ..models.tensortrain import TensorTrain, fulltensor
from ..ops.lu_device import rrlu_rook_device_fused
from ..ops.lu_kernel import rrlu_raw
from ..ops.lu_sharded import rrlu_sharded_raw
from .batcheval import TorchBatchEvaluator
from .mesh import default_mesh, mesh_device, mesh_rank


def _mpo(seed, L, chi, d1, d2, device):
    g = np.random.default_rng(seed)
    bonds = [1] + [chi] * (L - 1) + [1]
    return TensorTrain([g.standard_normal((bonds[n], d1, d2, bonds[n + 1]))
                        for n in range(L)], device=device)


def _same_cores(a, b) -> bool:
    return a.linkdims() == b.linkdims() and all(
        torch.equal(x, y) for x, y in zip(a.sitetensors(), b.sitetensors()))


def run(n_devices: int, device=None) -> str:
    """The dry run on a mesh of `n_devices` ranks of `device`'s type (the
    current CUDA device by default; ``device="cpu"`` for gloo)."""
    mesh = default_mesh(n_devices, device=device)
    dev = mesh_device(mesh)
    localdims = [4] * 6

    def f(idx):
        v = idx.to(torch.float64) + 1.0
        return 1.0 / (1.0 + (v * v).sum(1))

    bf = TorchBatchEvaluator(f, localdims, device=dev, mesh=mesh)
    tci, ranks, errors = crossinterpolate2(
        np.float64, bf, localdims, tolerance=1e-8, maxiter=4, device=dev)
    pt = (1, 2, 3, 0, 2, 1)
    v = np.asarray(pt, dtype=float) + 1.0
    err = abs(tci(pt) - 1.0 / (1.0 + v @ v))
    assert np.isfinite(errors).all(), f"non-finite errors: {errors}"
    assert err < 1e-6, f"pointwise error {err} too large"

    rng = np.random.default_rng(0)
    panel = rng.standard_normal((96, 9)) @ rng.standard_normal((9, 64))
    s = rrlu_sharded_raw(panel, 32, 1e-10, 0.0, True, mesh=mesh)
    r = rrlu_raw(panel, 32, 1e-10, 0.0, True, device=dev)
    assert s[3] == r[3], f"sharded rrLU rank {s[3]} != {r[3]}"
    assert np.array_equal(s[1], r[1]) and np.array_equal(s[2], r[2]), \
        "sharded rrLU pivot order diverged from the one-device elimination"
    assert torch.equal(s[0], r[0]), "sharded rrLU buffer diverged bitwise"

    A, B = _mpo(1, 4, 3, 2, 2, dev), _mpo(2, 4, 3, 2, 2, dev)
    kw = dict(algorithm="zipup", method="LU", tolerance=1e-10,
              torch_native=True)
    c1 = contract(A, B, **kw)
    cm = contract(A, B, mesh=mesh, **kw)
    assert _same_cores(c1, cm), "mesh zip-up diverged bitwise"
    exact = fulltensor(contract(A, B, algorithm="naive"))
    assert torch.allclose(fulltensor(cm), exact,
                          atol=1e-9 * float(exact.abs().max()))
    tt1 = TensorTrain([t.clone() for t in c1.sitetensors()])
    ttm = TensorTrain([t.clone() for t in c1.sitetensors()])
    tt1.compress("LU", tolerance=1e-10, torch_native=True)
    ttm.compress("LU", tolerance=1e-10, torch_native=True, mesh=mesh)
    assert _same_cores(tt1, ttm), "mesh compression diverged bitwise"

    srv_A = rng.standard_normal((128, 12)) @ rng.standard_normal((12, 96))
    srv = rrlu_rook_device_fused(
        srv_A, maxrank=24, reltol=1e-11, rng=np.random.default_rng(3),
        precision="mixed", defer=True, device=dev).result()
    rec = (srv.left() @ srv.right()).cpu().numpy()
    srv_rel = float(np.abs(rec - srv_A).max() / np.abs(srv_A).max())
    assert srv.npivots() == 12, f"serving rook rank {srv.npivots()} != 12"
    assert srv_rel < 1e-9, f"serving rook recon {srv_rel}"

    def poly(x):
        return x.prod(1)

    kw = dict(GKorder=15, torch_native=True, tolerance=1e-10, device=dev)
    vi1 = integrate(np.float64, lambda x: poly(x), [0.0] * 3, [1.0] * 3,
                    rng=np.random.default_rng(5), **kw)
    vim = integrate(np.float64, lambda x: poly(x), [0.0] * 3, [1.0] * 3,
                    rng=np.random.default_rng(5), mesh=mesh, **kw)
    assert abs(vi1 - 0.5 ** 3) < 1e-10, f"integrate off: {vi1}"
    assert vim == vi1, f"mesh integrate diverged: {vim} vs {vi1}"

    line = (
        f"dryrun({mesh.size()}): ok, {dev.type}, rank {tci.rank()}, final "
        f"error {errors[-1]:.3e}, pointwise error {err:.3e}, nevals "
        f"{bf.nevals}, sharded rrLU rank {s[3]} (bitwise), mesh zip-up "
        f"linkdims {cm.linkdims()} (bitwise), mesh compression linkdims "
        f"{ttm.linkdims()} (bitwise), serving rook rank {srv.npivots()} "
        f"(recon {srv_rel:.1e}), mesh integral {vim:.12f} (bitwise)")
    if mesh_rank(mesh) == 0:
        print(line, flush=True)
    return line

