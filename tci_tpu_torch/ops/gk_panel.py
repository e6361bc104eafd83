"""The coordinates and weights of a Gauss-Kronrod grid on a Π panel: one
CUDA kernel (``csrc/gk_panel.cu``) and its plain PyTorch version.

``integrate(torch_native=True)`` samples a weighted integrand W · f(X) on a
tensor-product grid whose point t has the coordinates X_d = nodes[d, t_d]
and the weight W = w_0 w_1 ... w_{N-1}, w_d = weights[d, t_d], the product
taken from left to right. ``gk_points(rows, cols, nodes, weights)`` gives X
(m n, N) and W (m n,) float64 for the panel of the (m, nl) row and (n, nr)
column index sets (int64, nl + nr = N), in the panel's order (point i n + j
is [rows_i, cols_j]); with ``cols=None`` ``rows`` is an (m, N) index matrix
(the empty column set). A CPU tensor takes the plain version,
``gk_points_plain``: the index matrix, two gathers and the product, as
PyTorch computes them; a CUDA tensor takes the kernel, which writes X and W
straight from the index sets, bit for bit the plain version, and raises
for what it does not take or a launch that fails. An index in [-K, 0)
counts from the end of its table row, in both. One outside [-K, K)
differs: the plain version raises for it (an IndexError on the CPU), the
kernel clamps it to the table and raises a flag on the device, which
``clamped(device)`` reads and clears.

``LAUNCHES["gk_panel"]`` counts the kernel's launches and
``ROWS["gk_panel"]`` the grid points they wrote (``ROWS["plain"]`` the
plain version's), counted where the kernel is launched and, for a CUDA graph
that is replayed, by what its capture recorded (``CAPTURED``,
``count_replay``), as ``lu_cuda`` counts the rrLU kernel. ``TRACED`` counts
the same points while a ``torch.profiler`` records (``utils.trace.enabled``),
so a traced window reads its own (``utils.trace.gk_points_traced``).
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional, Tuple

import torch

from ..utils import trace
from . import _build
from .fused import panel_indices

# Kernel launches and the grid points they wrote, counted at each launch the
# host queues and at each replay of a graph that holds launches; "plain"
# counts the plain version's points.
LAUNCHES: Counter = Counter()
ROWS: Counter = Counter()
# launches ("gk_panel") and points ("rows") recorded into CUDA graphs while a
# stream captured: nothing ran then; whoever owns the graph reports them at
# each replay (``count_replay``)
CAPTURED: Counter = Counter()
# points written while a profiler recorded, by "gk_panel" and "plain"
TRACED: Counter = Counter()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gk_panel")
    lib.gk_panel_launch.argtypes = [_P, _L, _I, _I, _P, _L, _I, _I, _P, _P,
                                    _I, _P, _P, _P]
    lib.gk_panel_launch.restype = _I
    lib.gk_panel_max_dims.argtypes = []
    lib.gk_panel_max_dims.restype = _I
    lib.gk_panel_clamped.argtypes = [ctypes.POINTER(_I)]
    lib.gk_panel_clamped.restype = _I
    return lib


def clamped(device) -> bool:
    """Whether a launch of the kernel on the CUDA `device` met an index
    outside [-K, K), which it clamped, since the last call; clears the
    flag.
    Waits for the device: not for use while a stream captures."""
    flag = _I(0)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        rc = _lib().gk_panel_clamped(ctypes.byref(flag))
    if rc != 0:
        raise RuntimeError(f"reading the GK panel kernel's clamp flag "
                           f"failed with CUDA error {rc}")
    return bool(flag.value)


def _count(kind: str, points: int) -> None:
    ROWS[kind] += points
    if trace.enabled():
        TRACED[kind] += points


def count_replay(captured: Counter) -> None:
    """A CUDA graph whose capture recorded `captured` (launches under
    "gk_panel", points under "rows", a difference of ``CAPTURED``) was
    replayed: each of its launches ran."""
    if captured["gk_panel"]:
        LAUNCHES["gk_panel"] += captured["gk_panel"]
        _count("gk_panel", captured["rows"])


def _shapes(rows: torch.Tensor, cols: Optional[torch.Tensor],
            nodes: torch.Tensor, weights: torch.Tensor):
    """(m, nl, n, nr) of a panel, checked against the (N, K) tables."""
    m, nl = rows.shape
    n, nr = (1, 0) if cols is None else cols.shape
    if nodes.shape != weights.shape or nodes.dim() != 2 or (
            nodes.shape[0] != nl + nr):
        raise ValueError(
            f"GK tables of shape (N, K) = (nl + nr, K) expected for index "
            f"sets ({m}, {nl}) and ({n}, {nr}); got {tuple(nodes.shape)} and "
            f"{tuple(weights.shape)}")
    return m, nl, n, nr


def gk_points_plain(rows: torch.Tensor, cols: Optional[torch.Tensor],
                    nodes: torch.Tensor, weights: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X (m n, N) and W (m n,) with PyTorch operations, on any device."""
    m, nl, n, nr = _shapes(rows, cols, nodes, weights)
    idx = rows if cols is None else panel_indices(rows, cols)
    dims = torch.arange(nl + nr, device=rows.device)
    X = nodes[dims, idx]
    wn = weights[dims, idx]
    # the product in a fixed left-to-right order; a zero weight (degenerate
    # bounds a_n == b_n) gives an exact zero
    W = wn[:, 0]
    for d in range(1, wn.shape[1]):
        W = W * wn[:, d]
    _count("plain", m * n)
    return X, W


def gk_points_kernel(rows: torch.Tensor, cols: Optional[torch.Tensor],
                     nodes: torch.Tensor, weights: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X (m n, N) and W (m n,) from one launch of the kernel on the current
    stream of the tensors' CUDA device; raises for anything else."""
    X, W = _launch(rows, cols, nodes, weights)
    if torch.cuda.is_current_stream_capturing():
        CAPTURED["gk_panel"] += 1
        CAPTURED["rows"] += W.shape[0]
    else:
        LAUNCHES["gk_panel"] += 1
        _count("gk_panel", W.shape[0])
    return X, W


def _launch(rows, cols, nodes, weights):
    """Allocate X and W and launch the kernel; counts nothing."""
    m, nl, n, nr = _shapes(rows, cols, nodes, weights)
    dev = rows.device
    sets = (rows,) if cols is None else (rows, cols)
    devices = [str(t.device) for t in (*sets, nodes, weights)]
    if dev.type != "cuda" or len(set(devices)) > 1:
        raise ValueError(f"the GK panel kernel needs every tensor on one "
                         f"CUDA device, got {devices}")
    if any(t.dtype != torch.int64 for t in sets) or any(
            t.dtype != torch.float64 for t in (nodes, weights)):
        raise TypeError("the GK panel kernel takes int64 index sets and "
                        "float64 tables")
    N, K = nodes.shape
    max_dims = _lib().gk_panel_max_dims()
    if N > max_dims:
        raise ValueError(f"the GK panel kernel takes at most {max_dims} "
                         f"dimensions, got {N}")
    # a set's rows may be strided (a prefix of a wider buffer); its entries
    # within a row must be adjacent
    rows, cols = (t if t is None or t.stride(1) == 1 else t.contiguous()
                  for t in (rows, cols))
    nodes, weights = nodes.contiguous(), weights.contiguous()
    X = torch.empty((m * n, N), dtype=torch.float64, device=dev)
    W = torch.empty((m * n,), dtype=torch.float64, device=dev)
    if m * n == 0:
        return X, W
    with torch.cuda.device(dev):
        rc = _lib().gk_panel_launch(
            rows.data_ptr(), rows.stride(0), m, nl,
            None if cols is None else cols.data_ptr(),
            0 if cols is None else cols.stride(0), n, nr,
            nodes.data_ptr(), weights.data_ptr(), K, X.data_ptr(),
            W.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"GK panel kernel launch failed with CUDA error "
                           f"{rc} (index sets ({m}, {nl}) x ({n}, {nr}), "
                           f"tables ({N}, {K}))")
    return X, W


def gk_points(rows: torch.Tensor, cols: Optional[torch.Tensor],
              nodes: torch.Tensor, weights: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X (m n, N) and W (m n,) of the panel rows x cols (or of the index
    matrix `rows` when cols is None): the plain version for tensors on the
    CPU, the kernel for any other. An index outside [-K, K) raises on the
    CPU; on a card the kernel clamps it and flags it (``clamped``)."""
    if rows.device.type == "cpu":
        return gk_points_plain(rows, cols, nodes, weights)
    return gk_points_kernel(rows, cols, nodes, weights)


def warm_up(nodes: torch.Tensor, weights: torch.Tensor) -> None:
    """Build and load the kernel and launch it once on a one-point matrix of
    the tables' device, outside any capture, so that a CUDA graph that
    records it finds its code loaded (a launch that samples nothing, not
    counted)."""
    idx = torch.zeros((1, nodes.shape[0]), dtype=torch.int64,
                      device=nodes.device)
    _launch(idx, None, nodes, weights)
