"""Batched evaluation protocol and adapters.

Counterpart of ``tci_tpu/parallel/batcheval.py`` (parity reference:
src/batcheval.jl). The protocol: an evaluator supports

- single call:  f(indexset) -> scalar
- batch call:   f.batch_evaluate(Iset, Jset, ncent) -> array of shape
                (|Iset|, d_{nl}, ..., d_{nl+ncent-1}, |Jset|)

where each entry is f at the concatenated index [left..., center..., right...].
``TorchBatchEvaluator`` takes the place of ``JaxBatchEvaluator``: the index
panel is assembled on its device by broadcasting, and the user's f maps an
(N, L) int64 tensor to (N,) values there, so the sampled panel never leaves
the device.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..utils.device import numpy_dtype, resolve_device, to_device, torch_dtype
from .mesh import mesh_device, shard_rows

MultiIndex = tuple


class BatchEvaluator:
    """Base class for batch-evaluable functions."""

    def __call__(self, *args):
        if len(args) == 1:
            return self.evaluate_single(args[0])
        if len(args) in (2, 3):
            Iset, Jset = args[0], args[1]
            ncent = args[2] if len(args) == 3 else None
            return self.batch_evaluate(Iset, Jset, ncent)
        raise TypeError("BatchEvaluator takes (indexset) or (Iset, Jset[, M])")

    def evaluate_single(self, indexset):
        raise NotImplementedError

    def batch_evaluate(self, Iset, Jset, ncent=None):
        raise NotImplementedError


def isbatchevaluable(f) -> bool:
    """True when `f` implements the batch-evaluation protocol."""
    return isinstance(f, BatchEvaluator) or hasattr(f, "batch_evaluate")


def evaluate_rows(f, indices, dtype=np.float64) -> torch.Tensor:
    """Evaluate f at every row of an (B, L) index matrix with as few calls
    as possible: one call when f exposes `evaluate_many` (the result stays
    on f's device), otherwise a host loop."""
    indices = np.asarray(indices, dtype=np.int64)
    if hasattr(f, "evaluate_many"):
        return torch.as_tensor(f.evaluate_many(indices))
    call = f.evaluate_single if hasattr(f, "evaluate_single") else f
    out = np.empty(indices.shape[0], dtype=numpy_dtype(dtype))
    for r in range(indices.shape[0]):
        out[r] = call(tuple(int(x) for x in indices[r]))
    return torch.from_numpy(out)


def _index_count(indexset) -> int:
    return len(indexset[0]) if len(indexset) else 0


def _result_shape(localdims, leftindexset, rightindexset, ncent):
    nl = _index_count(leftindexset)
    return (
        len(leftindexset),
        *[localdims[nl + i] for i in range(ncent)],
        len(rightindexset),
    )


def _infer_ncent(localdims, leftindexset, rightindexset, ncent):
    if ncent is not None:
        return ncent
    nl = _index_count(leftindexset)
    nr = _index_count(rightindexset)
    return len(localdims) - nl - nr


def _index_matrix(indexset, width: int) -> np.ndarray:
    return np.asarray([tuple(x) for x in indexset], dtype=np.int64).reshape(
        len(indexset), width
    )


def _assemble_indices(
    localdims: Sequence[int],
    leftindexset: Sequence[MultiIndex],
    rightindexset: Sequence[MultiIndex],
    ncent: int,
    device: torch.device,
) -> torch.Tensor:
    """Build the (|I|·Πd·|J|, nl+ncent+nr) int64 tensor of full multi-indices
    in C order (left slowest, right fastest) on the caller's `device`: only
    the left and right index sets are uploaded, the product is formed there
    by broadcasting (batcheval.jl:131-175)."""
    nl = _index_count(leftindexset)
    nr = _index_count(rightindexset)
    L = nl + ncent + nr
    left = to_device(_index_matrix(leftindexset, nl), device)
    right = to_device(_index_matrix(rightindexset, nr), device)
    centerdims = [localdims[nl + i] for i in range(ncent)]
    if ncent > 0:
        grids = torch.meshgrid(
            *[torch.arange(d, dtype=torch.int64, device=device)
              for d in centerdims],
            indexing="ij",
        )
        center = torch.stack(grids, dim=-1).reshape(-1, ncent)
    else:
        center = torch.zeros((1, 0), dtype=torch.int64, device=device)
    nI, nC, nJ = left.shape[0], center.shape[0], right.shape[0]
    out = torch.empty((nI, nC, nJ, L), dtype=torch.int64, device=device)
    out[:, :, :, :nl] = left[:, None, None, :]
    out[:, :, :, nl : nl + ncent] = center[None, :, None, :]
    out[:, :, :, nl + ncent :] = right[None, None, :, :]
    return out.reshape(nI * nC * nJ, L)


def _empty_panel(localdims, Iset, Jset, ncent, dtype, device):
    return torch.zeros(_result_shape(localdims, Iset, Jset, ncent),
                       dtype=torch_dtype(dtype), device=device)


def _batchevaluate_dispatch(
    valuetype,
    f,
    localdims: Sequence[int],
    leftindexset: Sequence[MultiIndex],
    rightindexset: Sequence[MultiIndex],
    ncent: Optional[int] = None,
) -> torch.Tensor:
    """Evaluate f on the product set left x (free center dims) x right.

    BatchEvaluators get one batched call (batcheval.jl:196-214) and the
    result stays where they computed it; plain callables are evaluated per
    assembled index row on the host (batcheval.jl:131-175), so their panel
    is a host tensor. The caller moves the panel to its device.
    Returns a tensor of shape (|I|, d..., |J|).
    """
    ncent = _infer_ncent(localdims, leftindexset, rightindexset, ncent)
    if len(leftindexset) * len(rightindexset) == 0:
        return _empty_panel(localdims, leftindexset, rightindexset, ncent,
                            valuetype, torch.device("cpu"))
    if isbatchevaluable(f):
        return torch.as_tensor(f.batch_evaluate(leftindexset, rightindexset,
                                                ncent))
    indices = _assemble_indices(localdims, leftindexset, rightindexset,
                                ncent, torch.device("cpu")).tolist()
    vals = torch.tensor([f(tuple(row)) for row in indices],
                        dtype=torch_dtype(valuetype))
    return vals.reshape(
        _result_shape(localdims, leftindexset, rightindexset, ncent))


class BatchEvaluatorAdapter(BatchEvaluator):
    """Wrap a plain callable of one multi-index into the batch protocol
    (batcheval.jl:32-57); its panels are host (CPU) tensors."""

    def __init__(self, f: Callable, localdims: Sequence[int], dtype=np.float64):
        self.f = f
        self.localdims = list(localdims)
        self.dtype = dtype

    def evaluate_single(self, indexset):
        return self.f(indexset)

    def _rows(self, Iset, Jset, ncent):
        """The panel's multi-indices as tuples of ints, in C order."""
        return [tuple(row) for row in _assemble_indices(
            self.localdims, Iset, Jset, ncent, torch.device("cpu")).tolist()]

    def _panel(self, vals, Iset, Jset, ncent) -> torch.Tensor:
        return torch.from_numpy(np.asarray(vals, dtype=self.dtype)).reshape(
            _result_shape(self.localdims, Iset, Jset, ncent))

    def batch_evaluate(self, Iset, Jset, ncent=None):
        ncent = _infer_ncent(self.localdims, Iset, Jset, ncent)
        if len(Iset) * len(Jset) == 0:
            return _empty_panel(self.localdims, Iset, Jset, ncent, self.dtype,
                                torch.device("cpu"))
        return self._panel([self.f(row) for row in self._rows(Iset, Jset,
                                                               ncent)],
                           Iset, Jset, ncent)


def makebatchevaluatable(valuetype, f, localdims) -> BatchEvaluatorAdapter:
    return BatchEvaluatorAdapter(f, localdims, dtype=valuetype)


class ThreadedBatchEvaluator(BatchEvaluatorAdapter):
    """Thread-pool fan-out of a plain callable over the rows of a panel
    (parity with the reference's Threads.@threads loop,
    batcheval.jl:247-308). The wrapped f must be thread-safe; threads
    overlap only where f releases the interpreter lock. Prefer
    TorchBatchEvaluator for a function written with torch operations."""

    def __init__(self, f: Callable, localdims, dtype=np.float64, nthreads=None):
        super().__init__(f, localdims, dtype=dtype)
        self.nthreads = nthreads

    def batch_evaluate(self, Iset, Jset, ncent=None):
        ncent = _infer_ncent(self.localdims, Iset, Jset, ncent)
        if len(Iset) * len(Jset) == 0:
            return _empty_panel(self.localdims, Iset, Jset, ncent, self.dtype,
                                torch.device("cpu"))
        with ThreadPoolExecutor(max_workers=self.nthreads) as pool:
            vals = list(pool.map(self.f, self._rows(Iset, Jset, ncent)))
        return self._panel(vals, Iset, Jset, ncent)


class VectorizedBatchEvaluator(BatchEvaluator):
    """Adapter for a numpy function that consumes a whole (B, L) index
    matrix at once; its panels are host (CPU) tensors, which ``TensorCI2``
    moves to its device."""

    def __init__(self, fvec: Callable[[np.ndarray], np.ndarray], localdims,
                 dtype=np.float64):
        self.fvec = fvec
        self.localdims = list(localdims)
        self.dtype = dtype

    def evaluate_single(self, indexset):
        arr = np.asarray([tuple(indexset)], dtype=np.int64)
        return self.fvec(arr)[0]

    def batch_evaluate(self, Iset, Jset, ncent=None):
        ncent = _infer_ncent(self.localdims, Iset, Jset, ncent)
        if len(Iset) * len(Jset) == 0:
            return _empty_panel(self.localdims, Iset, Jset, ncent, self.dtype,
                                torch.device("cpu"))
        indices = _assemble_indices(self.localdims, Iset, Jset, ncent,
                                    torch.device("cpu")).numpy()
        vals = np.asarray(self.fvec(indices), dtype=self.dtype)
        return torch.from_numpy(vals).reshape(
            _result_shape(self.localdims, Iset, Jset, ncent))


class TorchBatchEvaluator(BatchEvaluator):
    """Device evaluator: `f` maps an (N, L) int64 tensor of multi-indices on
    `device` to (N,) values there, written with torch operations. Panels
    are assembled and evaluated on the device and returned as device
    tensors. `device` defaults to the current CUDA device
    (``utils.device.resolve_device``); without one the constructor raises
    unless ``device="cpu"`` is given.

    Like ``tci_tpu``'s ``JaxBatchEvaluator`` it hands TensorCI2 its device
    tiers: the whole-sweep engine (``device_sweep_engine``, on unless
    ``enable_device_sweep=False``), the per-bond fused update
    (``fused_updater``) and the fused site tensors
    (``fused_site_tensors``). ``nevals`` counts the samples of all of them;
    the tiers count padded panels, as ``tci_tpu`` does.

    On a CUDA device the engine records each of its sweeps, `f` included,
    into a CUDA graph at the sweep's first use and replays it afterwards
    (unless ``cuda_graphs=False``), as ``tci_tpu`` keeps its jitted sweeps.
    The graphs belong to the engine, hence to this evaluator: reuse one
    evaluator across ``crossinterpolate2`` calls on the same function and
    the later calls only replay. For that `f` has to be a pure function of
    its index tensor: no ``.item()``, ``.cpu()`` or other read of a device
    value, no output or intermediate whose shape depends on the data, no
    new random numbers; tensors it closes over must stay alive and change
    only in place (a replay reads their current values). An `f` that cannot
    be recorded still works: the engine then runs that sweep eagerly, says
    so once on stderr, and lists the reasons in
    ``device_sweep_engine.declined``.

    With ``mesh`` (a 1-D ``parallel.mesh`` DeviceMesh; `axis`, kept for
    ``tci_tpu``'s signature, only names its one dim and is checked) the
    sampling is data-parallel, as ``JaxBatchEvaluator(mesh=)`` shards it:
    every rank makes the same calls, a batch is padded to a multiple of
    the mesh size, each rank evaluates its contiguous share of the rows
    and the values are gathered on every rank (``parallel.mesh.
    shard_rows``), in ``evaluate_many`` / ``batch_evaluate`` and in every
    f call of the engine (whose graphs then hold the gather). ``nevals``
    counts the global batch. The device defaults to the mesh's."""

    def __init__(self, f: Callable[[torch.Tensor], torch.Tensor], localdims,
                 dtype=torch.float64,
                 device: Optional[Union[str, torch.device]] = None,
                 enable_device_sweep: bool = True,
                 cuda_graphs: bool = True, mesh=None, axis: str = "batch"):
        self.f = f
        self.localdims = list(localdims)
        self.dtype = torch_dtype(dtype)
        self.mesh = mesh
        if mesh is not None:
            if device is None:
                device = mesh_device(mesh)
            if tuple(mesh.mesh_dim_names) != (axis,):
                raise ValueError(f"the mesh's dim is "
                                 f"{mesh.mesh_dim_names}, not ({axis!r},)")
        self.device = resolve_device(device)
        self.enable_device_sweep = enable_device_sweep
        self.cuda_graphs = cuda_graphs
        self._nevals = 0
        self._fused_updater = None
        self._fused_site_tensors = None
        self._device_sweep_engine = None
        self._panel_sampler = None

    @classmethod
    def from_scalar(cls, f: Callable[[torch.Tensor], torch.Tensor], localdims,
                    dtype=torch.float64,
                    device: Optional[Union[str, torch.device]] = None,
                    enable_device_sweep: bool = True,
                    cuda_graphs: bool = True, mesh=None,
                    axis: str = "batch") -> "TorchBatchEvaluator":
        """An evaluator of a scalar `f`: f maps one (L,) int64 index tensor
        to a 0-d tensor, and the evaluator calls ``torch.func.vmap(f)`` on
        (N, L) batches, as ``tci_tpu``'s ``JaxBatchEvaluator`` calls
        ``jax.vmap`` on its f. Everything else is the batched evaluator's:
        its tiers, its CUDA graphs and what a recordable f may not do. Under
        vmap f may also not branch on the values of its index (an ``if``
        on a tensor, ``.item()``): vmap raises its own error at the first
        call, as ``jax.vmap`` does for a traced ``if``."""
        return cls(torch.func.vmap(f), localdims, dtype=dtype, device=device,
                   enable_device_sweep=enable_device_sweep,
                   cuda_graphs=cuda_graphs, mesh=mesh, axis=axis)

    def _tier_dtype(self) -> torch.dtype:
        """The value type of the device tiers: the evaluator's, with
        complex64 promoted to complex128, the rrLU kernel's complex type
        (as ``tci_tpu`` promotes it)."""
        return torch.complex128 if self.dtype.is_complex else self.dtype

    @property
    def fused_updater(self):
        """Per-bond fused update on the device (Π sampling, rrLU and CI
        factors, one fetch a bond); TensorCI2.updatepivots uses it when the
        engine is off or declines."""
        if self._fused_updater is None:
            from ..ops.fused import FusedBondUpdater

            self._fused_updater = FusedBondUpdater(
                self._values, self._tier_dtype(), self.device)
        return self._fused_updater

    @property
    def device_sweep_engine(self):
        """Whole-sweep engine: every bond update of a 2-site sweep, the
        site-tensor fill and the 1-site sweep on the device, one fetch a
        sweep (models/device_sweep.py); None when disabled."""
        if not self.enable_device_sweep:
            return None
        if self._device_sweep_engine is None:
            from ..models.device_sweep import DeviceSweepEngine

            self._device_sweep_engine = DeviceSweepEngine(
                self._values, self.localdims, dtype=self._tier_dtype(),
                device=self.device, cuda_graphs=self.cuda_graphs,
                mesh=self.mesh)
        return self._device_sweep_engine

    @property
    def panel_sampler(self):
        """Π panels on the device for the per-bond device rook tier
        (``ops/fused.PanelSampler``); None for a complex f, whose rook bonds
        take the host tier, as in ``tci_tpu``."""
        if self.dtype.is_complex:
            return None
        if self._panel_sampler is None:
            from ..ops.fused import PanelSampler

            self._panel_sampler = PanelSampler(self._values, self.dtype,
                                               self.device)
        return self._panel_sampler

    @property
    def fused_site_tensors(self):
        """Site tensor T = Π₁ · P^{-1} on the device (ops/fused.py)."""
        if self._fused_site_tensors is None:
            from ..ops.fused import FusedSiteTensors

            self._fused_site_tensors = FusedSiteTensors(
                self._values, self._tier_dtype(), self.device)
        return self._fused_site_tensors

    @property
    def nevals(self) -> int:
        """Number of f evaluations through this adapter and its tiers."""
        return self._nevals + sum(
            tier.nevals for tier in (self._fused_updater,
                                     self._fused_site_tensors,
                                     self._device_sweep_engine,
                                     self._panel_sampler)
            if tier is not None)

    def reset_nevals(self) -> None:
        """Start the sample counts anew (an evaluator that is reused counts
        each call on its own)."""
        self._nevals = 0
        for tier in (self._fused_updater, self._fused_site_tensors,
                     self._device_sweep_engine, self._panel_sampler):
            if tier is not None:
                tier.nevals = 0

    @property
    def _values(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """f on an (N, L) int64 index tensor on the device, checked and
        cast; the tiers call it and count their own samples. A function
        that does not refer to this evaluator: the tiers keep it, and the
        evaluator keeps the tiers, so an evaluator that is dropped is freed
        at once, with its engine and the engine's CUDA graphs."""
        f, device, dtype = self.f, self.device, self.dtype

        def values(indices: torch.Tensor) -> torch.Tensor:
            vals = f(indices)
            if vals.shape != (indices.shape[0],) or vals.device != device:
                raise ValueError(
                    f"f must return ({indices.shape[0]},) values on {device},"
                    f" got shape {tuple(vals.shape)} on {vals.device}")
            return vals.to(dtype)

        return values

    def _eval(self, indices: torch.Tensor) -> torch.Tensor:
        self._nevals += int(indices.shape[0])
        if self.mesh is not None:
            return shard_rows(self._values, self.mesh)(indices)
        return self._values(indices)

    def evaluate_many(self, indices) -> torch.Tensor:
        if isinstance(indices, torch.Tensor):
            indices = indices.to(self.device, torch.int64)
        else:
            indices = to_device(np.asarray(indices, dtype=np.int64),
                                self.device)
        return self._eval(indices)

    def evaluate_single(self, indexset):
        arr = np.asarray([tuple(indexset)], dtype=np.int64)
        return self.evaluate_many(arr)[0].item()

    def batch_evaluate(self, Iset, Jset, ncent=None):
        ncent = _infer_ncent(self.localdims, Iset, Jset, ncent)
        if len(Iset) * len(Jset) == 0:
            return _empty_panel(self.localdims, Iset, Jset, ncent, self.dtype,
                                self.device)
        indices = _assemble_indices(self.localdims, Iset, Jset, ncent,
                                    self.device)
        return self._eval(indices).reshape(
            _result_shape(self.localdims, Iset, Jset, ncent))

    def __call__(self, *args):
        if len(args) == 1 and not (
            isinstance(args[0], (list, tuple))
            and args[0]
            and isinstance(args[0][0], (list, tuple))
        ):
            return self.evaluate_single(args[0])
        return super().__call__(*args)
