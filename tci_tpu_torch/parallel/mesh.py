"""The device mesh of multi-GPU TCI, and the collectives the port uses on it.

Counterpart of ``tci_tpu/parallel/mesh.py``. ``tci_tpu`` is one controller
over a ``jax.sharding.Mesh``; PyTorch runs one process per device (SPMD),
so the mesh here is a 1-D ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the default process group, with the dim name ``"batch"``
(``tci_tpu``'s axis name): NCCL on the cards, gloo on the CPU. Every rank
makes the same calls with the same arguments and gets the same, replicated
result.

The parallel axis is the sample batch, as in ``tci_tpu``: ``shard_rows``
gives each rank a contiguous share of a batch of index rows and gathers
the values; the sharded rrLU (``ops/lu_sharded.py``) cuts a panel's rows
the same way. A host draw that ``tci_tpu`` leaves unseeded is drawn on rank
0 and broadcast (``mesh_rng``), so the ranks cannot part.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def _init_one_rank(dev: torch.device) -> None:
    """A process group of this process alone, on a file store in a
    temporary directory: NCCL for a card, gloo for the CPU."""
    tmp = tempfile.mkdtemp(prefix="tci_tpu_torch_mesh_")
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=0, world_size=1)


def default_mesh(n_devices: Optional[int] = None, axis: str = "batch",
                 device=None):
    """A 1-D DeviceMesh over the first `n_devices` ranks of the default
    process group (all of them when None), on `device`'s type (the current
    CUDA device by default; ``device="cpu"`` for gloo on the CPU).

    Where no group is initialized and one rank is asked for, it starts a
    group of this process alone. It never falls back to devices that were
    not asked for (``tci_tpu`` falls back to virtual CPU devices): more
    ranks than the group has, or more NCCL ranks than this machine has
    cards, raise. After building the mesh it runs one collective, so that
    NCCL's communicator exists before a CUDA graph records a collective."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"default_mesh({n_devices}) needs a process group of "
                f"{n_devices} ranks: start one process per rank, e.g. "
                f"torchrun --nproc-per-node {n_devices} script.py, each "
                f"calling default_mesh({n_devices}); without a group only "
                f"a one-rank mesh is made")
        _init_one_rank(dev)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise RuntimeError(
            f"default_mesh({n_devices}): the process group has {world} "
            f"ranks; start {n_devices} with torchrun --nproc-per-node "
            f"{n_devices}")
    if dist.get_backend() == "nccl" and n > torch.cuda.device_count():
        raise RuntimeError(
            f"default_mesh({n}): NCCL takes one card a rank and this machine "
            f"has {torch.cuda.device_count()}")
    mesh = DeviceMesh(dev.type, list(range(n)), mesh_dim_names=(axis,))
    if mesh.get_coordinate() is not None:
        warm = torch.ones(1, device=mesh_device(mesh))
        dist.all_reduce(warm, group=mesh_group(mesh))
    return mesh


def mesh_group(mesh):
    """The process group of the mesh's one dimension."""
    return mesh.get_group(mesh.mesh_dim_names[0])


def mesh_rank(mesh) -> int:
    """This process's place along the mesh."""
    return mesh.get_local_rank(mesh.mesh_dim_names[0])


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: its current CUDA device, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' (B, ...) tensors stacked along the first axis in rank
    order, on every rank: ``all_gather_into_tensor`` under NCCL (a CUDA
    graph can record it), gloo's ``all_gather`` otherwise."""
    group = mesh_group(mesh)
    P = mesh.size()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((P * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(P)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def shard_rows(f: Callable[[torch.Tensor], torch.Tensor], mesh
               ) -> Callable[[torch.Tensor], torch.Tensor]:
    """f on an (N, L) batch of index rows, data-parallel over the mesh: the
    batch is padded to a multiple of the mesh size with copies of its
    first row, each rank evaluates its contiguous share, and the values are
    gathered and cut back to N on every rank (``tci_tpu``'s sharding
    constraint on the row axis). Shapes depend on N alone and nothing is
    read back, so a CUDA graph can record it."""
    P, r = mesh.size(), mesh_rank(mesh)

    def sharded(indices: torch.Tensor) -> torch.Tensor:
        N = indices.shape[0]
        if N == 0:
            return f(indices)
        Np = -(-N // P) * P
        if Np != N:
            pad = indices[:1].expand(Np - N, *indices.shape[1:])
            indices = torch.cat([indices, pad])
        share = Np // P
        return all_gather_rows(f(indices[r * share:(r + 1) * share]),
                               mesh)[:N]

    return sharded


def broadcast_seed(mesh) -> int:
    """A seed drawn on rank 0 from fresh entropy and sent to every rank."""
    seed = np.random.default_rng().integers(0, 2**62) \
        if mesh_rank(mesh) == 0 else 0
    t = torch.tensor([seed], dtype=torch.int64, device=mesh_device(mesh))
    dist.broadcast(t, group_src=0, group=mesh_group(mesh))
    return int(t.item())


def mesh_rng(mesh) -> np.random.Generator:
    """The generator an unseeded host draw takes: ``default_rng()`` without
    a mesh, as ``tci_tpu`` draws it; on a mesh one seeded from rank 0
    (``broadcast_seed``), the same on every rank."""
    if mesh is None:
        return np.random.default_rng()
    return np.random.default_rng(broadcast_seed(mesh))
