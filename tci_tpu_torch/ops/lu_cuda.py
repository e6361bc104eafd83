"""Wrapper of the CUDA complete-pivot rrLU kernel (``csrc/rrlu.cu``).

Counterpart of ``tci_tpu/ops/pallas_lu.py``: ``rrlu_call`` and
``rrlu_batched`` take the arguments of ``pallas_rrlu_call`` /
``pallas_rrlu_batched`` and return the same 6-tuple (A_sw, rowperm, colperm,
k, mags, err), and with ``return_mode=True`` each panel's mode as well (0
resident, 1 cluster, 2 grid-resident, 3 streamed). A call eliminates B
panels (B = 1 for ``rrlu_call``) of float32, float64 or complex128 (mags
and err are then real float64) in the kernel's modes (``csrc/rrlu.cu``):
panels up to 128 KB (128 x 128 f64) take one thread block each, with the
panel in shared memory (it must start on a 16-byte boundary and hold a
multiple of 16 bytes, as every shape bucket does); larger ones take one
thread-block cluster each where their true rows fit its shared memory, and
otherwise the whole card in turn, in a cooperative grid launch whose global
scratch this module allocates: the true rows held in the grid's shared
memory where they fit it (grid-resident), else streamed from a work buffer.
Where the padded panel may not fit a cluster, a call launches the cluster
kernel and then the grid kernel, and each panel is eliminated by the one
its true extents choose.

This module only launches the kernel: a panel that is not a contiguous
float32, float64 or complex128 CUDA tensor raises. Which of the kernel and its plain
PyTorch version a panel takes is decided by where it lies, in
``lu_kernel.rrlu_panel`` / ``rrlu_panel_batched``.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from . import _build

# Kernel launches, counted where the kernel is launched and nowhere else: in
# ``_launch`` for a launch the host queues, in ``count_replay`` for the
# launches of a CUDA graph that is replayed.
LAUNCHES: Counter = Counter()
# Launches recorded into a CUDA graph while a stream was capturing. Nothing
# runs then, so they are not launches; whoever owns the graph reads how many
# it holds here and reports them at each replay (``count_replay``). What
# each panel of a launch cost (mode, rank, operations, bytes) exists only on
# the device; the kernels count it there (``work_record``).
CAPTURED: Counter = Counter()

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_LAUNCH_ARGTYPES = [_P] * 14 + [_I, _I, _I, _D, _D] + [_I] * 5 + [_P, _P]

# the kernel's host modes (rrlu_host_mode in csrc/rrlu.cu), and the modes it
# reports for a panel (return_mode)
HOST_MODES = ("resident", "cluster", "cluster+grid", "grid")
PANEL_MODES = ("resident", "cluster", "grid", "stream")


# the kernel's entry point for each element type it takes
_ENTRY = {torch.float32: "rrlu_launch_f32", torch.float64: "rrlu_launch_f64",
          torch.complex128: "rrlu_launch_c128"}


@functools.cache
def _lib(defines: tuple = ()) -> ctypes.CDLL:
    """The kernel's library; `defines` builds an instrumented variant
    (``("RRLU_PHASE_CLOCKS",)``: the cluster and grid kernels' phase clocks,
    read by ``rrlu_phase_cycles_read`` / ``rrlu_grid_phase_cycles_read``)."""
    lib = _build.load("rrlu", defines)
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = _LAUNCH_ARGTYPES
        fn.restype = _I
    lib.rrlu_scratch_bytes.argtypes = [_I, _I, _I, _I]
    lib.rrlu_scratch_bytes.restype = ctypes.c_longlong
    lib.rrlu_host_mode.argtypes = [_I, _I, _I, _I]
    lib.rrlu_host_mode.restype = _I
    lib.rrlu_cluster_size.argtypes = [_I]
    lib.rrlu_cluster_size.restype = _I
    lib.rrlu_grid_blocks.argtypes = [_I]
    lib.rrlu_grid_blocks.restype = _I
    lib.rrlu_grid_regime.argtypes = [_I] * 5
    lib.rrlu_grid_regime.restype = _I
    lib.rrlu_grid_barrier_launch.argtypes = [_I, _P, _P]
    lib.rrlu_grid_barrier_launch.restype = _I
    lib.rrlu_grid_threads.argtypes = []
    lib.rrlu_grid_threads.restype = _I
    if "RRLU_PHASE_CLOCKS" in defines:
        lib.rrlu_phase_cycles_read.argtypes = [_P]
        lib.rrlu_phase_cycles_read.restype = _I
        lib.rrlu_grid_phase_cycles_read.argtypes = [_P]
        lib.rrlu_grid_phase_cycles_read.restype = _I
    return lib


def _check_panel(A: torch.Tensor, ndim: int) -> None:
    if A.device.type != "cuda":
        raise ValueError(f"rrLU kernel needs a CUDA tensor, got {A.device}")
    if A.dtype not in _ENTRY:
        raise TypeError(f"rrLU kernel takes float32, float64 or complex128, "
                        f"got {A.dtype}")
    if A.dim() != ndim or 0 in A.shape:
        raise ValueError(f"rrLU kernel needs a non-empty {ndim}-D panel, "
                         f"got shape {tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError("rrLU kernel needs a contiguous panel")


def check_extents(mp: int, npd: int, m_true, n_true, maxrank) -> None:
    """Raise ValueError when extents given on the host (ints, or tensors on
    the CPU) do not fit (mp, np) panels: 0 <= m <= mp, 0 <= n <= np and
    maxrank >= 0. Reading them costs no sync. Extents on a card are not
    read: the kernel clamps them to the panel, so a caller that computed
    them there (the whole-sweep engine) queues its eliminations without a
    sync, and a bad one still cannot index outside the panel."""
    for v, hi in ((m_true, mp), (n_true, npd), (maxrank, None)):
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            continue
        v = torch.as_tensor(v)
        if v.numel() and (int(v.min()) < 0
                          or (hi is not None and int(v.max()) > hi)):
            raise ValueError(
                f"true extents ({m_true}, {n_true}) / maxrank {maxrank} do "
                f"not fit the ({mp}, {npd}) panel")


@functools.cache
def cluster_size(device_index: int, elsize: int) -> int:
    """CTAs of a cluster-mode cluster for `elsize`-byte elements on one
    device: 16 where the card can schedule such a cluster, else 8 (the rule
    lives in ``csrc/rrlu.cu``). Setting the kernels' shared-memory
    attributes comes with it, so the first call must not happen while a
    stream is capturing (``warm_up`` makes it). A card that can schedule
    neither raises."""
    with torch.cuda.device(device_index):
        C = _lib().rrlu_cluster_size(elsize)
    if C < 0:
        raise RuntimeError(f"rrLU kernel: CUDA error {-C} choosing the "
                           f"cluster size (element size {elsize})")
    return C


@functools.cache
def grid_blocks(device_index: int, elsize: int) -> int:
    """Blocks of the grid mode's cooperative launch for `elsize`-byte
    elements on one device: one an SM (the rule lives in ``csrc/rrlu.cu``;
    it sets the kernels' attributes, so not while a stream captures)."""
    with torch.cuda.device(device_index):
        G = _lib().rrlu_grid_blocks(elsize)
    if G < 0:
        raise RuntimeError(f"rrLU kernel: CUDA error {-G} sizing the grid "
                           f"(element size {elsize})")
    return G


def grid_threads() -> int:
    """Threads of a grid-mode block (``kGridThreads`` in csrc/rrlu.cu)."""
    return _lib().rrlu_grid_threads()


def grid_regime(device_index: int, m: int, mp: int, npd: int,
                dtype: torch.dtype) -> str:
    """The regime the grid kernel takes on one device for a panel of m true
    rows in (mp, np) panels of `dtype`: "grid" where each block's share of
    the rows fits its shared memory (grid-resident), else "stream"."""
    elsize = torch.empty((), dtype=dtype).element_size()
    G = grid_blocks(device_index, elsize)
    return PANEL_MODES[_lib().rrlu_grid_regime(m, mp, npd, elsize, G)]


def grid_barrier_ms(device_index: int, iters: int) -> float:
    """Device time of one grid barrier of the grid mode's launch shape
    alone: CUDA events around one launch of `iters` barriers, over `iters`
    (after a launch of one, which loads the kernel)."""
    dev = torch.device("cuda", device_index)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for n in (1, iters):
            bar = torch.zeros((1,), dtype=torch.int32, device=dev)
            start.record()
            rc = _lib().rrlu_grid_barrier_launch(n, bar.data_ptr(), stream)
            end.record()
            if rc != 0:
                raise RuntimeError(f"rrLU grid barrier launch failed with "
                                   f"CUDA error {rc}")
        end.synchronize()
    return start.elapsed_time(end) / iters


def host_mode(device_index: int, mp: int, npd: int,
              dtype: torch.dtype) -> str:
    """How a call on aligned (mp, np) panels of `dtype` runs on one device:
    "resident", "cluster", "cluster+grid" (each panel takes the mode its
    true extents choose) or "grid"."""
    elsize = torch.empty((), dtype=dtype).element_size()
    C = cluster_size(device_index, elsize)
    return HOST_MODES[_lib().rrlu_host_mode(mp, npd, elsize, C)]


@functools.cache
def _scratch_bytes(device_index: int, mp: int, npd: int, elsize: int,
                   C: int) -> int:
    """Global scratch of a call on (mp, np) panels on one device, from the
    kernel (0 unless the grid kernel runs; the rule lives in
    ``csrc/rrlu.cu`` alone). Asked once per shape, not per call."""
    with torch.cuda.device(device_index):
        nbytes = _lib().rrlu_scratch_bytes(mp, npd, elsize, C)
    if nbytes < 0:
        raise RuntimeError(f"rrLU kernel: CUDA error {-nbytes} sizing the "
                           f"grid (panel {mp}x{npd})")
    return nbytes


# The fields of a device's work record (``work_record``), in order: the
# flag, the panels by mode (PANEL_MODES), the pivots, the real operations and
# the bytes of csrc/rrlu.cu's count_work.
WORK_FIELDS = ("flag",) + PANEL_MODES + ("pivots", "ops", "bytes")
_WORK = {}


def work_record(device_index: int) -> torch.Tensor:
    """The (8,) int64 work record of one device, which every launch there
    is given: while its flag (element 0) is set, the kernels add each
    panel's mode, rank, operations and bytes to it on the device, also when
    they run from a CUDA graph (the record lives as long as the process, so
    a graph's recorded address stays valid). Allocated, zeroed, at the
    first call, which may not happen while a stream captures (``warm_up``
    makes it)."""
    rec = _WORK.get(device_index)
    if rec is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "rrLU kernel: the device's work record is allocated at the "
                "first launch; call lu_cuda.warm_up before a capture")
        rec = _WORK[device_index] = torch.zeros(
            (len(WORK_FIELDS),), dtype=torch.int64,
            device=torch.device("cuda", device_index))
    return rec


def count_replay(launches: int) -> None:
    """A CUDA graph that holds `launches` captured launches of the kernel
    was replayed: each of them ran."""
    LAUNCHES["rrlu"] += launches


# (device index, dtype, kernel) of the kernels launched so far outside any
# capture: "resident", "cluster", "grid" and "stream" (the grid kernel's
# two instantiations)
_WARM = set()


@functools.cache
def _kernels(device_index: int, mp: int, npd: int, dtype: torch.dtype,
             mode: str) -> tuple:
    """The kernels a call of host mode `mode` on (mp, np) panels launches:
    the grid kernel's grid-resident instantiation where m = 0 true rows
    fit the grid's shared memory (then some panel may), its streaming one
    where mp rows do not (csrc/rrlu.cu's launch)."""
    if mode in ("resident", "cluster"):
        return (mode,)
    grid = (("grid",) if grid_regime(device_index, 0, mp, npd, dtype)
            == "grid" else ()) + (
        ("stream",) if grid_regime(device_index, mp, mp, npd, dtype)
        == "stream" else ())
    return (("cluster",) if mode == "cluster+grid" else ()) + grid


def warm_up(device_index: int, dtype: torch.dtype) -> None:
    """Everything of a launch that happens once and may not happen while a
    stream is capturing: the build, the choice of the cluster size and the
    kernels' shared-memory attributes, the load of the four kernels' code
    onto the device. Makes one small launch of each shape below whose
    kernels this process has not all launched yet on this device in this
    dtype; call it before the first capture of a body that launches the
    kernel."""
    dev = torch.device("cuda", device_index)
    elsize = torch.empty((), dtype=dtype).element_size()
    cluster_size(device_index, elsize)
    work_record(device_index)
    # 8 x 8 is resident, 256 x 256 a cluster's; rows of 4 KB, 1024 of them,
    # fit no cluster but the grid's shared memory, so that shape launches
    # the cluster kernel and the grid-resident one; 65536 rows of 16 bytes
    # (1 MB) have positions past the grid-resident key's 16 bits, so that
    # shape launches the streaming instantiation alone
    for shape in ((8, 8), (256, 256), (1024, 4096 // elsize),
                  (65536, 16 // elsize)):
        mode = host_mode(device_index, *shape, dtype)
        if any((device_index, dtype, k) not in _WARM
               for k in _kernels(device_index, *shape, dtype, mode)):
            rrlu_call(torch.zeros(shape, dtype=dtype, device=dev), 1, 1, 1,
                      0.0, 0.0, leftorthogonal=True)


def _launch(A, B, mp, npd, leftorthogonal, scalars, arrays):
    """Allocate the outputs and launch B panels; `scalars` are
    (m, n, maxrank, reltol, abstol), `arrays` the per-panel device arrays
    (m, n, maxrank int32 (B,), tol (B, 2)) or Nones. Returns the 6-tuple
    and the (B,) int64 modes the kernels report.

    A launch can be captured into a CUDA graph: it runs on the current
    stream, the outputs and the scratch then come from the graph's memory
    pool, and the zeroing of the grid barriers' counters is a node of the
    graph that runs at every replay (a barrier counts arrivals from 0 and
    never resets its counter). The cluster launch and the cooperative
    launches of the grid mode are captured as kernel nodes like any
    other."""
    dev, dt = A.device, A.dtype
    fn = getattr(_lib(), _ENTRY[dt])
    rmax = min(mp, npd)
    # A_sw in A's dtype; (mags, err) in its real dtype, in one allocation
    # with A_sw for a real panel; (rowperm, colperm, k) in int64
    npanel = B * mp * npd
    if dt.is_complex:
        A_sw = torch.empty((B, mp, npd), dtype=dt, device=dev)
        rbuf = torch.empty((B * rmax + B,), dtype=dt.to_real(), device=dev)
    else:
        rbuf = torch.empty((npanel + B * rmax + B,), dtype=dt, device=dev)
        A_sw, rbuf = rbuf[:npanel].view(B, mp, npd), rbuf[npanel:]
    ibuf = torch.empty((B * (mp + npd + 2),), dtype=torch.int64, device=dev)
    mags = rbuf[:B * rmax].view(B, rmax)
    err = rbuf[B * rmax:]
    rowperm = ibuf[:B * mp].view(B, mp)
    colperm = ibuf[B * mp:B * (mp + npd)].view(B, npd)
    k = ibuf[B * (mp + npd):B * (mp + npd + 1)]
    modes = ibuf[B * (mp + npd + 1):]
    m, n, maxrank, reltol, abstol = scalars

    def ptr(t):
        return None if t is None else t.data_ptr()

    es = A.element_size()
    aligned = A.data_ptr() % 16 == 0 and (mp * npd * es) % 16 == 0
    # a panel the bulk copy cannot load takes the grid mode (C = 0)
    C = cluster_size(dev.index, es) if aligned else 0
    mode = HOST_MODES[_lib().rrlu_host_mode(mp, npd, es, C)]
    work = work_record(dev.index)
    with torch.cuda.device(dev):
        # where the grid kernel runs: global scratch, and the counters of
        # the grid barriers of its two instantiations, zeroed
        scratch = barrier = None
        nbytes = _scratch_bytes(dev.index, mp, npd, es, C)
        if nbytes > 0:
            scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
            barrier = torch.zeros((2,), dtype=torch.int32, device=dev)
        elif mode == "resident" and not aligned:
            # the resident mode loads the panel with the bulk-copy engine
            raise ValueError(
                f"rrLU kernel: a shared-memory resident panel must start on "
                f"a 16-byte boundary and hold a multiple of 16 bytes (shape "
                f"buckets are multiples of 8 elements); got {mp}x{npd} {dt} "
                f"at offset {A.data_ptr() % 16}")
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptr(A), ptr(scratch), ptr(barrier), ptr(A_sw), ptr(rowperm),
                ptr(colperm), ptr(mags), ptr(k), ptr(err), ptr(modes),
                *(ptr(a) for a in arrays), m, n, maxrank, reltol, abstol, B,
                mp, npd, int(bool(leftorthogonal)), C, work.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"rrLU kernel launch failed with CUDA error {rc} "
                           f"(B={B}, panel {mp}x{npd}, {dt}, {mode}, "
                           f"cluster of {C})")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED["rrlu"] += 1
    else:
        LAUNCHES["rrlu"] += 1
        _WARM.update((dev.index, dt, k)
                     for k in _kernels(dev.index, mp, npd, dt, mode))
    return A_sw, rowperm, colperm, k, mags, err, modes


def rrlu_call(A: torch.Tensor, m_true, n_true, maxrank, reltol, abstol,
              *, leftorthogonal: bool, return_mode: bool = False):
    """Eliminate one zero-padded (mp, np) panel; the contract of
    ``pallas_rrlu_call`` and of the plain ``lu_kernel.rrlu_plain``. With
    return_mode, a 0-d int64 tensor of the mode the kernel reports is
    appended."""
    _check_panel(A, 2)
    mp, npd = A.shape
    m, n, maxrank = int(m_true), int(n_true), int(maxrank)
    check_extents(mp, npd, m, n, maxrank)
    out = _launch(A, 1, mp, npd, leftorthogonal,
                  (m, n, maxrank, float(reltol), float(abstol)),
                  (None, None, None, None))
    out = tuple(t[0] for t in out)
    return out if return_mode else out[:6]


def rrlu_batched(A: torch.Tensor, m_true, n_true, maxrank, reltol, abstol,
                 *, leftorthogonal: bool, return_mode: bool = False):
    """Eliminate B panels of (B, mp, np) in one call, with per-panel (B,)
    true sizes, rank caps and tolerances (scalars apply to every panel);
    the contract of ``pallas_rrlu_batched``. With return_mode, the (B,)
    int64 modes the kernels report are appended.

    Nothing is read back from the card: sizes and tolerances may be
    tensors on A's device that the caller computed there (the whole-sweep
    engine's extents), which the kernel clamps to the panel, so a sweep can
    queue its eliminations without a sync; sizes given on the host are
    checked (``check_extents``). Scalar tolerances go to the kernel as
    arguments and int32 (B,) size tensors as they are, so such a call
    launches nothing but the kernels (and, where the grid kernel runs, its
    barrier reset)."""
    _check_panel(A, 3)
    B, mp, npd = A.shape
    check_extents(mp, npd, m_true, n_true, maxrank)
    dev = A.device

    def per_panel(v, dtype):
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=dtype).expand(B).contiguous()
        return torch.full((B,), v, dtype=dtype, device=dev)

    sizes = [per_panel(v, torch.int32) for v in (m_true, n_true, maxrank)]
    if isinstance(reltol, torch.Tensor) or isinstance(abstol, torch.Tensor):
        # the tolerances are real, in the panel's real dtype
        rdt = A.dtype.to_real()
        tol = torch.stack([per_panel(reltol, rdt),
                           per_panel(abstol, rdt)], dim=1).contiguous()
        tols = (0.0, 0.0)
    else:
        tol, tols = None, (float(reltol), float(abstol))
    out = _launch(A, B, mp, npd, leftorthogonal, (0, 0, 0) + tols,
                  (*sizes, tol))
    return out if return_mode else out[:6]
