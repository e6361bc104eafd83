"""Multi-GPU TCI on a device mesh (examples/06_multichip_mesh.py's twin).

One process a device, every one running this script:

    torchrun --nproc-per-node N -m tci_tpu_torch.examples.ex06_multichip_mesh
    python -m tci_tpu_torch.examples.ex06_multichip_mesh --device cpu --ranks N
    python -m tci_tpu_torch.examples.ex06_multichip_mesh      (one card)

The second spawns N gloo ranks on the CPU itself; the last is a one-rank
NCCL mesh on the current card. Parallel axes (SURVEY §2.5):

1. data-parallel sampling: ``TorchBatchEvaluator(mesh=...)`` gives each
   rank its share of every Π panel's rows; ``crossinterpolate2`` on the
   mesh matches the one-device run exactly;
2. the sharded rrLU: ``rrlu_sharded`` row-shards the elimination itself
   (exact collectives, the one-device pivot order bit for bit);
3. the mesh device tiers: ``contract(..., mesh=)``,
   ``TensorTrain.compress(..., mesh=)`` and ``integrate(..., mesh=)``,
   bitwise the one-device device tier.
"""

import argparse
import gc
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

localdims = [6] * 6


def f(idx):
    v = idx.to(torch.float64) + 1.0
    return 1.0 / (1.0 + (v * v).sum(1))


def _mpo(seed, L, chi, d, device):
    from tci_tpu_torch import TensorTrain

    g = np.random.default_rng(seed)
    bonds = [1] + [chi] * (L - 1) + [1]
    return TensorTrain([g.standard_normal((bonds[i], d, d, bonds[i + 1]))
                        for i in range(L)], device=device)


def body(n_ranks: int, device) -> None:
    import tci_tpu_torch as tci
    from tci_tpu_torch.models.tensortrain import fulltensor
    from tci_tpu_torch.parallel.mesh import (default_mesh, mesh_device,
                                             mesh_rank)

    mesh = default_mesh(n_ranks, device=device)
    dev = mesh_device(mesh)
    say = print if mesh_rank(mesh) == 0 else (lambda *a, **k: None)
    say(f"mesh: {mesh.size()} ranks on {dev.type}")

    # --- 1. mesh-sharded sampling ------------------------------------------
    bf = tci.TorchBatchEvaluator(f, localdims, device=dev, mesh=mesh)
    tt, ranks, errors = tci.crossinterpolate2(
        np.float64, bf, localdims, tolerance=1e-9, device=dev,
        rng=np.random.default_rng(0))
    bf1 = tci.TorchBatchEvaluator(f, localdims, device=dev)
    tt1, ranks1, errors1 = tci.crossinterpolate2(
        np.float64, bf1, localdims, tolerance=1e-9, device=dev,
        rng=np.random.default_rng(0))
    assert ranks == ranks1 and errors == errors1
    pt = (1, 2, 3, 0, 2, 1)
    assert tt(pt) == tt1(pt)
    say(f"mesh-sharded crossinterpolate2: rank {tt.rank()}, error "
        f"{errors[-1]:.2e}, identical to one device")

    # --- 2. the sharded rrLU -------------------------------------------------
    rng = np.random.default_rng(0)
    A = rng.standard_normal((512, 12)) @ rng.standard_normal((12, 384))
    lu_tp = tci.rrlu_sharded(A, reltol=1e-10, mesh=mesh)
    lu_1d = tci.rrlu(A, reltol=1e-10, device=dev)
    assert lu_tp.npivot == lu_1d.npivot == 12
    assert np.array_equal(lu_tp.rowpermutation, lu_1d.rowpermutation)
    say(f"sharded rrLU: rank {lu_tp.npivot}, pivot order bit-identical to "
        "one device")

    # --- 3. mesh-sharded contraction / compression / integration -----------
    A4, B4 = _mpo(1, 4, 3, 2, dev), _mpo(2, 4, 3, 2, dev)
    kw = dict(algorithm="zipup", method="LU", tolerance=1e-10,
              torch_native=True)
    cm = tci.contract(A4, B4, mesh=mesh, **kw)
    c1 = tci.contract(A4, B4, **kw)
    assert all(torch.equal(a, b)
               for a, b in zip(cm.sitetensors(), c1.sitetensors()))
    say(f"mesh zip-up contraction: linkdims {cm.linkdims()}, bitwise one "
        "device's")

    ttm = tci.TensorTrain([t.clone() for t in cm.sitetensors()])
    ttm.compress("LU", tolerance=1e-10, torch_native=True, mesh=mesh)
    exact = fulltensor(tci.contract(A4, B4, algorithm="naive"))
    assert torch.allclose(fulltensor(ttm), exact,
                          atol=1e-9 * float(exact.abs().max()))
    say(f"mesh compression: linkdims {ttm.linkdims()}")

    val = tci.integrate(np.float64, lambda x: x.prod(1), [0.0] * 3,
                        [1.0] * 3, torch_native=True, mesh=mesh,
                        tolerance=1e-10, rng=np.random.default_rng(5),
                        device=dev)
    assert abs(val - 0.5 ** 3) < 1e-10
    say(f"mesh-sharded GK integration: {val:.12f} (exact 0.125)")
    say("ok")


def _spawned(rank: int, n_ranks: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n_ranks)
    try:
        body(n_ranks, "cpu")
    finally:
        gc.collect()
        dist.destroy_process_group()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help='torch device type to run on (default: the '
                        'current CUDA device; "cpu" for gloo on the CPU)')
    parser.add_argument("--ranks", type=int, default=None,
                        help="spawn this many gloo ranks on the CPU "
                        "(with --device cpu)")
    args = parser.parse_args(argv)
    if args.ranks and args.ranks > 1 and "WORLD_SIZE" not in os.environ:
        if args.device != "cpu":
            raise SystemExit("--ranks spawns gloo ranks on the CPU: pass "
                             "--device cpu, or start one process a card "
                             "with torchrun --nproc-per-node N")
        store = os.path.join(tempfile.mkdtemp(), "store")
        torch.multiprocessing.spawn(_spawned, args=(args.ranks, store),
                                    nprocs=args.ranks)
        return
    if "WORLD_SIZE" in os.environ:  # started by torchrun: one rank
        if args.device != "cpu":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    try:
        # without torchrun, default_mesh(1) starts a group of this process
        body(dist.get_world_size() if dist.is_initialized() else 1,
             args.device)
    finally:
        # the engines' CUDA graphs, which hold NCCL collectives, go first:
        # a group left to the interpreter's exit can hang it
        gc.collect()
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
