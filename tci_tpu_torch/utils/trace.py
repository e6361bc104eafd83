"""The port's spans and the rrLU kernel's work record, on one gate: a
``torch.profiler`` is recording.

``span(name)`` is a ``record_function`` while a profiler records, and one
shared no-op context otherwise, so an untraced run formats no name and
allocates nothing. The spans share the profiler's clock with the device's
intervals (CUPTI), so an idle gap of the device trace falls inside a named
step of the host. Every name starts with ``tci.``; each span carries the
number of the ``crossinterpolate2`` call it belongs to as its
``record_function`` argument (``solve=<n>``).

The rrLU kernel counts its work on the device, where under graph replay the
panels' true extents and ranks alone exist: ``lu_cuda.work_record`` holds
the panels by mode, the pivots, the operations and the bytes (on the CPU
the plain version keeps such a record, ``lu_kernel.PLAIN_WORK``). Its flag
is set, stream-ordered, at the entry of ``crossinterpolate2`` and
``TensorCI2.optimize`` whenever ``enabled()`` differs from it, so the record
counts the launches of the traced solves, replayed ones included.
``rrlu_work()`` reads it. The GK panel kernel's grid points are counted on the
host, at each launch and replay (``ops/gk_panel``); those counted while a
profiler records are ``gk_points_traced()``. So are the bytes of the index
matrices formed for f (``ops/fused.INDEX_BYTES``, replays included;
``index_bytes_traced()``) and the bonds of the per-bond fused tier, each
inside a span ``tci.fused.bond`` (``ops/fused.FUSED_BONDS``;
``fused_bonds_traced()``).
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Optional

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_NOOP = contextlib.nullcontext()
# crossinterpolate2 calls of this process; the last one's number
_SOLVES = itertools.count(1)
_solve = 0
# the last value written to each device's work-record flag
_FLAG = {}


def enabled() -> bool:
    """Whether a ``torch.profiler`` (or ``torch.autograd.profiler``) is
    recording in this process."""
    return _profiler._is_profiler_enabled


def span(name: str, suffix: Optional[str] = None):
    """A ``record_function`` named `name` (+ `suffix`) while a profiler
    records, else a shared no-op context."""
    if not enabled():
        return _NOOP
    if suffix is not None:
        name = name + suffix
    return record_function(name, f"solve={_solve}")


def begin_solve(device) -> None:
    """A ``crossinterpolate2`` call starts on `device`: number it, and set
    the work record's flag as ``count_rrlu`` does."""
    global _solve
    _solve = next(_SOLVES)
    count_rrlu(device)


def count_rrlu(device) -> None:
    """Set the flag of the rrLU work record of `device` to ``enabled()``
    where it differs from its last value. On a CUDA device the write is
    queued on its current stream, so it holds for the launches queued
    after it; on the CPU it is the plain version's record
    (``lu_kernel.PLAIN_WORK``)."""
    device = torch.device(device)
    index = "cpu" if device.type == "cpu" else (
        device.index if device.index is not None
        else torch.cuda.current_device())
    on = enabled()
    if _FLAG.get(index, False) == on:
        return
    from ..ops import lu_cuda, lu_kernel
    if index == "cpu":
        lu_kernel.PLAIN_WORK[0] = int(on)
    else:
        lu_cuda.work_record(index)[0].fill_(int(on))
    _FLAG[index] = on


def rrlu_work() -> dict:
    """The rrLU work counted while the flag was set, since the process
    started: the fields of ``lu_cuda.WORK_FIELDS`` but the flag (the
    panels by the kernel's mode, ``pivots``, ``ops`` in real operations
    and ``bytes``), summed over every CUDA device's record (one transfer
    each) and the plain version's on the CPU."""
    from ..ops import lu_cuda, lu_kernel
    total = list(lu_kernel.PLAIN_WORK)
    for rec in lu_cuda._WORK.values():
        total = [a + b for a, b in zip(total, rec.tolist())]
    return dict(zip(lu_cuda.WORK_FIELDS[1:], total[1:]))


def gk_points_traced() -> int:
    """The GK grid points ``ops/gk_panel`` wrote while a profiler recorded,
    since the process started: the kernel's, replayed launches included,
    and the plain version's."""
    from ..ops import gk_panel
    return sum(gk_panel.TRACED.values())


def index_bytes_traced() -> int:
    """The bytes of the int64 index matrices formed for f while a profiler
    recorded, since the process started, replayed graphs included."""
    from ..ops import fused
    return fused.INDEX_BYTES["traced"]


def fused_bonds_traced() -> int:
    """The bonds the per-bond fused tier updated while a profiler
    recorded, since the process started."""
    from ..ops import fused
    return fused.FUSED_BONDS["traced"]


@contextlib.contextmanager
def profiled(profile_dir: Optional[str]):
    """Record the block with a ``torch.profiler`` (the CPU, and CUDA where
    present) and write its Chrome trace into `profile_dir` (made if need
    be) as ``tci2.<pid>.<ns>.pt.trace.json``; nothing when it is None."""
    if profile_dir is None:
        yield
        return
    import os
    import time

    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"tci2.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
