"""Host/device helpers shared by the port's layers."""

from __future__ import annotations

import gc
from collections import Counter
from typing import Optional, Union

import numpy as np
import torch

from .trace import span

# Device-to-host fetches of the device tiers, by tier ("engine",
# "fused_bond"), counted where they happen (``fetch``) and nowhere else.
FETCHES: Counter = Counter()


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    current CUDA device. There is no silent CPU fallback: without a CUDA
    device the caller has to ask for the CPU with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tci_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device=\"cpu\" to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy or torch dtype (np.float64 -> torch.float64)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch or numpy dtype (torch.float64 -> float64)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def to_device(a: Union[np.ndarray, torch.Tensor],
              device: torch.device) -> torch.Tensor:
    """Move a host array or tensor to `device`; a host upload to a CUDA
    device goes through pinned memory, so the host does not wait for work
    already queued on the device."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def fetch(t: torch.Tensor, tier: str) -> np.ndarray:
    """Bring a device tier's packed result record to the host: the one
    device-to-host transfer of a sweep or a bond update, counted in
    ``FETCHES[tier]``. On a CUDA device it is an asynchronous copy into
    pinned memory that the host then waits for on an event, so the host
    waits for the work queued before it and for nothing else. The whole
    read is the span ``tci.fetch.<tier>``, and the wait alone inside it
    ``tci.wait.<tier>`` (empty on the CPU, which queues nothing)."""
    FETCHES[tier] += 1
    with span("tci.fetch.", tier):
        if t.device.type != "cuda":
            with span("tci.wait.", tier):
                pass
            return t.detach().numpy()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        with span("tci.wait.", tier):
            done.synchronize()
        return host.numpy()


def peek(t: torch.Tensor, host: torch.Tensor, done, tier: str) -> list:
    """A few values of a device tensor, read through the preallocated
    pinned `host` buffer and the event `done` (None on the CPU), counted in
    ``FETCHES[tier]``: the host waits for the work queued before and reads
    nothing else; the spans ``tci.fetch.<tier>`` and ``tci.wait.<tier>``
    as in ``fetch``."""
    FETCHES[tier] += 1
    with span("tci.fetch.", tier):
        if t.device.type != "cuda":
            with span("tci.wait.", tier):
                pass
            return t.tolist()
        host.copy_(t, non_blocking=True)
        done.record(torch.cuda.current_stream(t.device))
        with span("tci.wait.", tier):
            done.synchronize()
        return host.tolist()


def graph_ms(fn, reps: int) -> float:
    """Device time of one fn() call on the current CUDA device: CUDA events
    around the replay of a CUDA graph that holds `reps` calls (after one
    eager call and one replay), so no host time lies between them. fn must
    be safe to record in a graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def capture_graph(body, pool, stream: "torch.cuda.Stream"):
    """Record the launches of body() into a ``torch.cuda.CUDAGraph`` whose
    memory comes from `pool` (``torch.cuda.graph_pool_handle()``). Nothing
    runs during the capture; ``graph.replay()`` then queues the whole body
    on the current stream in one call, reading and writing the same device
    addresses as recorded. Returns (graph, what body returned: tensors of
    the pool that every replay overwrites).

    The capture runs on `stream`, a side stream, in the "thread_local" error
    mode: a call that may not be captured (a synchronization, a read of a
    device value) raises here and leaves the device usable. body() must
    have done its one-time set-up (kernel builds, library handles) before.

    The garbage collector is held off meanwhile: it runs when it likes, and
    what it frees may not be freed during a capture (destroying another
    CUDA graph is "not permitted when stream is capturing" and invalidates
    this one)."""
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = body()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # an invalidated capture ends with its own error
                raise
            graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    return graph, out
