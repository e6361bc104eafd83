"""The batched-grid probes: six small CUDA kernels (``csrc/probe_batched.cu``)
and the probe that runs them.

Counterpart of ``benchmarks/probe_pallas_batched.py``, which bisects the
constructs that ``pallas_rrlu_batched`` adds to the single-panel kernel: a
grid with per-program scalar stores (``v1``), a data-dependent scalar read
(``v2``), a (B, 1, n) blocked output written through its row-0 view
(``v3``), a ``while`` loop in the grid body (``v4``), float32 scalars
(``v4b``) and a read-modify-write of the row inside such a loop (``v4c``).
Each is one ``__global__`` function launched with B blocks on the current
stream (``launch_shape``), designed for the card's launch floor: no shared
memory or barrier, 16-byte row stores, v4c's row in registers through its
loop (the source's head says more). ``run_probes`` runs the six and then
the two rrLU entry points at the probe's panel shape, and returns the
probe's JSON object. ``floor_ms`` times an empty kernel at a probe's launch
shape, the least a launch of that shape takes.

Beside each kernel stands its plain PyTorch version (``*_plain``), of the
same signature. ``v1`` ... ``v4c`` pick by where the input lies: a tensor on
the CPU takes the plain version, any other goes to the kernel, which raises
for what it does not take; a kernel that fails to build or launch raises
too. ``LAUNCHES[name]`` counts the launches of each kernel.

The scalar table ``s`` is a contiguous (B, >= 3) int32 tensor (``v4b``:
(B, >= 2) float32); ``probe_table`` makes the probe's own. Integer sums wrap
modulo 2^32 in the kernels and the plain versions alike. ``check_inputs``
gives the input sets (INPUT_SETS) a kernel is held against its plain
version at.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..utils.device import graph_ms, resolve_device, to_device
from . import _build, lu_kernel

# Kernel launches by probe name, counted where a kernel is launched and
# nowhere else.
LAUNCHES: Counter = Counter()

NAMES = ("v1", "v2", "v3", "v4", "v4b", "v4c")

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("probe_batched")
    for name in NAMES:
        fn = getattr(lib, f"probe_{name}_launch")
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        fn.restype = _I
    lib.probe_empty_launch.argtypes = [_I, _I, _P]
    lib.probe_empty_launch.restype = _I
    return lib


def probe_table(name: str, B: int = 4, device=None) -> torch.Tensor:
    """The scalar table the probe gives kernel `name` (v2 ... v4c) for B
    programs, on `device` (``utils.device.resolve_device``)."""
    if name in ("v2", "v3"):
        s = np.arange(B * 3, dtype=np.int32).reshape(B, 3)
    elif name in ("v4", "v4c"):
        s = (np.arange(B, dtype=np.int32)[:, None] + 2) * np.ones(
            (1, 3), np.int32)
    elif name == "v4b":
        s = np.arange(B * 2, dtype=np.float32).reshape(B, 2)
    else:
        raise ValueError(f"probe {name!r} takes no scalar table")
    return to_device(s, resolve_device(device))


# The input sets a kernel is held against its plain version at, name ->
# (B, n): the probe's own; a second with a row not a multiple of the block;
# rows of 1, 3 and 257 columns over several programs (at n = 257 three rows
# in four start off a 16-byte boundary); one program; more programs than the
# card has SMs; and loop limits that are negative, 0 and 10,000, with
# tables whose int32 sums wrap and whose float32 sums round.
INPUT_SETS = {"probe": (4, 256), "second": (7, 1000), "n1": (5, 1),
              "n3": (5, 3), "n257": (6, 257), "b1": (1, 99),
              "b300": (300, 257), "limits": (5, 130)}

# the "limits" set's column 0, by probe: v4's 70,000 trips make acc wrap
# past 2^31, v2's and v3's 2^31 - 100 wraps in 2 s and in j + s; v4b's
# 2^24 + 1 rounds back to 2^24, and 2 x 3e38 overflows to inf
_LIMITS = {"v2": [-7, 0, 10000, 2**31 - 100, -2**31],
           "v4": [-7, 0, 10000, 70000, -2**31],
           "v4c": [-7, 0, 10000, 1, -2**31],
           "v4b": [-3.5, 0.0, 10000.0, 2.0**24, 3e38]}
_LIMITS["v3"] = _LIMITS["v2"]


def check_inputs(name: str, which: str, device=None):
    """(B, n, scalar table or None) of input set `which` (a key of
    INPUT_SETS) for kernel `name`, on `device`: "probe" is the probe's own
    table; the others are seeded, with loop limits of 0 ... 39 (the second:
    3, 0, 17, 1, 6, 40, 2), and "limits" puts _LIMITS in column 0."""
    B, n = INPUT_SETS[which]
    if which == "probe":
        return B, n, None if name == "v1" else probe_table(name, B, device)
    if name == "v1":
        return B, n, None
    rng = np.random.default_rng(
        11 if which == "second" else 100 + list(INPUT_SETS).index(which))
    if name == "v4b":
        # halves: 2 t and t + 1 are exact in float32
        s = (rng.integers(-64, 64, size=(B, 2)) / 2).astype(np.float32)
    else:
        s = rng.integers(-50, 50, size=(B, 3)).astype(np.int32)
        if name in ("v4", "v4c"):
            s[:, 0] = ([3, 0, 17, 1, 6, 40, 2] if which == "second"
                       else rng.integers(0, 40, size=B))
    if which == "limits":
        s[:, 0] = _LIMITS[name]
    return B, n, to_device(s, resolve_device(device))


def launch_shape(name: str, B: int, n: int) -> Tuple[int, int]:
    """(blocks, threads) kernel `name` is launched with for B programs and
    an n-column row (``csrc/probe_batched.cu``'s launchers): B blocks; one
    warp for v1 and v2, else one thread a 16-byte group of columns,
    ceil(n / 4), rounded up to a warp, at most 1024."""
    if name in ("v1", "v2"):
        return B, 32
    return B, min(1024, -(-n // 128) * 32)


def empty_launch(B: int, threads: int, device=None) -> None:
    """Launch the empty kernel once with B blocks of `threads` on the
    current stream of `device` (a CUDA device; it raises for any other).
    Instrumentation: it counts in no probe's LAUNCHES."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"the empty kernel needs a CUDA device, got "
                         f"{device}")
    with torch.cuda.device(device):
        rc = _lib().probe_empty_launch(
            B, threads, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed with CUDA error {rc} "
                           f"({B} blocks of {threads} threads)")


def floor_ms(B: int, threads: int, device=None, reps: int = 1000) -> float:
    """The launch floor of a probe launched with B blocks of `threads`
    (``launch_shape``): the device time of one empty kernel at that shape,
    by ``utils.device.graph_ms`` over `reps` launches, as chip_smoke.py
    times the probes. Raises on the CPU."""
    device = resolve_device(device)
    empty_launch(B, threads, device)
    with torch.cuda.device(device):
        return graph_ms(lambda: empty_launch(B, threads, device), reps)


def _check_table(name: str, s: torch.Tensor, n: int) -> None:
    dtype, cols = ((torch.float32, 2) if name == "v4b"
                   else (torch.int32, 3))
    if s.dtype != dtype or s.dim() != 2 or s.shape[1] < cols or (
            s.shape[0] < 1):
        raise ValueError(
            f"probe {name} takes a (B >= 1, >= {cols}) {dtype} table, got "
            f"{tuple(s.shape)} {s.dtype}")
    if not s.is_contiguous():
        raise ValueError(f"probe {name} needs a contiguous table")
    if n < 1:
        raise ValueError(f"probe {name} needs a row of n >= 1, got {n}")


def _launch(name: str, s, B: int, n: int, device: torch.device, dtype,
            row: bool):
    """Allocate the outputs and launch kernel `name` with B blocks on the
    current stream of `device`; returns (v or None, o)."""
    if device.type != "cuda":
        raise ValueError(f"probe kernel {name} needs a CUDA tensor, got "
                         f"{device}")
    o = torch.empty((B, 2), dtype=dtype, device=device)
    v = torch.empty((B, 1, n), dtype=dtype, device=device) if row else None
    with torch.cuda.device(device):
        fn = getattr(_lib(), f"probe_{name}_launch")
        rc = fn(None if s is None else s.data_ptr(),
                None if v is None else v.data_ptr(), o.data_ptr(), B,
                0 if s is None else s.shape[1], n,
                torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe kernel {name} launch failed with CUDA "
                           f"error {rc} (B={B}, n={n})")
    LAUNCHES[name] += 1
    return v, o


def _row_probe(name: str, plain: Callable, s: torch.Tensor, n: int):
    """A probe with a row output: the plain version for a table on the CPU,
    the kernel for any other."""
    _check_table(name, s, n)
    if s.device.type == "cpu":
        return plain(s, n)
    return _launch(name, s, s.shape[0], n, s.device, s.dtype, row=True)


def _rows(B: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(B, dtype=torch.int32, device=like.device)


def _trips(lim: torch.Tensor) -> int:
    """The most trips any program's loop makes (read on the host)."""
    return max(int(lim.max()), 0)


# -- v1: program b writes o[b] = (b, b + 1) ----------------------------------

def v1_plain(B: int = 4, device=None) -> torch.Tensor:
    b = torch.arange(B, dtype=torch.int32, device=resolve_device(device))
    return torch.stack([b, b + 1], dim=1)


def v1(B: int = 4, device=None) -> torch.Tensor:
    """(B, 2) int32 with o[b] = (b, b + 1), written by B programs
    (probe_pallas_batched.py:47). Runs on `device`: the current CUDA device
    unless the caller asks for the CPU."""
    device = resolve_device(device)
    if B < 1:
        raise ValueError(f"probe v1 needs B >= 1 programs, got {B}")
    if device.type == "cpu":
        return v1_plain(B, device)
    return _launch("v1", None, B, 1, device, torch.int32, row=False)[1]


# -- v2: a scalar read at a program-dependent row ----------------------------

def v2_plain(s: torch.Tensor) -> torch.Tensor:
    return torch.stack([s[:, 0] * 2, s[:, 2]], dim=1)


def v2(s: torch.Tensor) -> torch.Tensor:
    """o[b] = (2 s[b, 0], s[b, 2]) (probe_pallas_batched.py:63)."""
    _check_table("v2", s, 1)
    if s.device.type == "cpu":
        return v2_plain(s)
    return _launch("v2", s, s.shape[0], 1, s.device, s.dtype, row=False)[1]


# -- v3: the (B, 1, n) row output through its row-0 view ---------------------

def v3_plain(s: torch.Tensor, n: int = 256):
    B = s.shape[0]
    col = torch.arange(n, dtype=torch.int32, device=s.device)
    v = (col[None, :] + s[:, :1])[:, None, :].contiguous()
    return v, torch.stack([s[:, 0], _rows(B, s)], dim=1)


def v3(s: torch.Tensor, n: int = 256):
    """v[b, 0, :] = arange(n) + s[b, 0] and o[b] = (s[b, 0], b)
    (probe_pallas_batched.py:81). Returns (v (B, 1, n), o (B, 2))."""
    return _row_probe("v3", v3_plain, s, n)


# -- v4: a while loop in the grid body ---------------------------------------

def v4_plain(s: torch.Tensor, n: int = 256):
    B, lim = s.shape[0], s[:, 0]
    k = torch.arange(_trips(lim), dtype=torch.int32, device=s.device)
    runs = k[None, :] < lim[:, None]
    acc = (k[None, :] * runs).sum(dim=1).to(torch.int32)
    v = acc[:, None, None].expand(B, 1, n).contiguous()
    return v, torch.stack([acc, runs.sum(dim=1).to(torch.int32)], dim=1)


def v4(s: torch.Tensor, n: int = 256):
    """k runs 0 ... lim - 1 with lim = s[b, 0] and acc sums k, in a loop
    inside the kernel; v[b, 0, :] = acc and o[b] = (acc, k)
    (probe_pallas_batched.py:108)."""
    return _row_probe("v4", v4_plain, s, n)


# -- v4b: float32 scalars ----------------------------------------------------

def v4b_plain(s: torch.Tensor, n: int = 256):
    B, t = s.shape[0], s[:, 0]
    v = (t * 2.0)[:, None, None].expand(B, 1, n).contiguous()
    return v, torch.stack([t + 1.0, t], dim=1)


def v4b(s: torch.Tensor, n: int = 256):
    """t = s[b, 0] in float32; v[b, 0, :] = 2 t and o[b] = (t + 1, t)
    (probe_pallas_batched.py:143)."""
    return _row_probe("v4b", v4b_plain, s, n)


# -- v4c: the row read, incremented and written inside the loop --------------

def v4c_plain(s: torch.Tensor, n: int = 256):
    B, lim = s.shape[0], s[:, 0]
    v = torch.zeros((B, 1, n), dtype=torch.int32, device=s.device)
    k = torch.zeros_like(lim)
    for trip in range(_trips(lim)):
        runs = (trip < lim).to(torch.int32)
        v = v + runs[:, None, None]
        k = k + runs
    return v, torch.stack([k, _rows(B, s)], dim=1)


def v4c(s: torch.Tensor, n: int = 256):
    """v[b, 0, :] is zeroed and then incremented lim = s[b, 0] times, each
    trip reading and writing the row; o[b] = (k, b)
    (probe_pallas_batched.py:168)."""
    return _row_probe("v4c", v4c_plain, s, n)


# name -> (the dispatching wrapper, its plain version)
PROBES: Dict[str, Tuple[Callable, Callable]] = {
    "v1": (v1, v1_plain), "v2": (v2, v2_plain), "v3": (v3, v3_plain),
    "v4": (v4, v4_plain), "v4b": (v4b, v4b_plain), "v4c": (v4c, v4c_plain),
}


def run_probes(device=None, B: int = 4, n: int = 256) -> dict:
    """Run v1 ... v4c at the probe's values and then the single-panel and
    the batched rrLU entry points on its 64 x 128 float32 panels (the
    probe's v5a and v5), on `device` (the current CUDA device by default:
    there every step launches its kernel). Returns the probe's JSON object:
    per step ``{"ok": True, "check": ...}`` with the values the probe
    prints, or ``{"ok": False, "error": ...}`` naming what was raised, so
    that the first failure names the construct at fault."""
    device = resolve_device(device)
    out = {}

    def run(name, fn):
        try:
            out[name] = {"ok": True, "check": fn()}
        except Exception as e:  # the probe reports a failing step and goes on
            out[name] = {"ok": False,
                         "error": f"{type(e).__name__}: {e}"[:200]}

    def table(name):
        return probe_table(name, B, device)

    run("v1_smem_dyn_store", lambda: v1(B, device)[:, 0].tolist())
    run("v2_smem_dyn_read", lambda: v2(table("v2"))[:, 0].tolist())
    run("v3_b1n_blocked_out",
        lambda: v3(table("v3"), n)[0][:, 0, 0].tolist())
    run("v4_while_loop", lambda: v4(table("v4"), n)[1][:, 0].tolist())
    run("v4b_f32_smem", lambda: v4b(table("v4b"), n)[1][:, 0].tolist())
    run("v4c_row0_rmw_in_loop",
        lambda: v4c(table("v4c"), n)[0][:, 0, 0].tolist())

    def v5a():
        rng = np.random.default_rng(0)
        A = to_device(rng.standard_normal((64, 128)).astype(np.float32),
                      device)
        r = lu_kernel.rrlu_panel(A, 64, 128, 32, 1e-6, 0.0,
                                 leftorthogonal=True)
        return int(r[3])

    def v5():
        rng = np.random.default_rng(0)
        A = to_device(rng.standard_normal((B, 64, 128)).astype(np.float32),
                      device)
        ones = torch.ones((B,), dtype=torch.int32, device=device)
        r = lu_kernel.rrlu_panel_batched(
            A, ones * 64, ones * 128, ones * 32,
            torch.full((B,), 1e-6, dtype=torch.float32, device=device),
            torch.zeros((B,), dtype=torch.float32, device=device),
            leftorthogonal=True)
        return r[3].tolist()

    run("v5a_single_panel_64x128", v5a)
    run("v5_batched_rrlu_small", v5)
    return out
