"""Row-sharded complete-pivot rank-revealing LU over a 1-D DeviceMesh.

Counterpart of ``tci_tpu/ops/lu_sharded.py``. A panel's rows are cut into
one contiguous block a rank (rows padded to ``bucket(m)`` rounded up to a
multiple of the mesh size, columns to ``bucket(n)``); the elimination is
``tci_tpu``'s ``_make_state_fn``: per pivot step each rank updates its
block and reduces its column maxima, and three collectives make the
decision global, each exact, so the pivot order is bitwise the one-device
elimination's:

- pick: the pivot column from the global column maxima (replicated), and
  this rank's first candidate row in it; then a MIN all-reduce of the
  candidates' swapped positions (the reference's first occurrence);
- swap: the stop test, the virtual swaps of the replicated permutations,
  the pivot row into a buffer (the owner's row, zeros on the other ranks);
  then a SUM all-reduce of the buffer's bits;
- update: the Schur update of the rank's block with the multipliers
  stored, and its column maxima for the next step; then a MAX all-reduce
  of their integer keys (``_key``: NaN above every value).

Each phase is a launch of the hand-written CUDA kernel ``csrc/lu_sharded.cu``
for a block on a card, and its plain PyTorch version (``_plain``, the
arithmetic of ``lu_kernel.rrlu_plain``) for a block on the CPU, where the
collectives run on gloo. The steps queue with no read of the device; the
stop test sets a flag in the replicated state that turns the later steps
into no-ops, and the host reads it once every ``CHECK_EVERY`` steps. The factored blocks are gathered once at the end into the swapped
layout of ``rrlu_raw``. float32, float64 and complex128 panels are taken.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import (all_gather_rows, default_mesh, mesh_device,
                             mesh_group, mesh_rank)
from ..utils.device import to_device
from . import _build
from .lu_kernel import _abs2, _div, _first, _mul, bucket, fetch_result

_INTMAX = 2**62
_BIG = 1 << 30

# Launches of the step kernel (three a pivot step, one for the first column
# maxima), counted where it is launched and nowhere else.
LAUNCHES: Counter = Counter()
# Calls of the plain version's phases, by the device type of the block. The
# main path on a card leaves the "cuda" count at 0 (CHECKS runs it there).
PLAIN_CALLS: Counter = Counter()
# Collectives of the eliminations run so far, by kind.
COLLECTIVES: Counter = Counter()
# Host reads of the stop flag.
FLAG_READS: Counter = Counter()
# When a list, every kernel launch is checked against its plain version on
# copies of its inputs (not a launch of the main path's work: the plain
# version runs beside it) and the result is appended: (phase, equal,
# largest |kernel - plain| over the block).
CHECKS: Optional[list] = None

# The host reads the stop flag once every CHECK_EVERY steps. A read waits
# for the queue to drain, so it costs about one step; a step queued after
# the stop is a dead step, three launches that return at once and three
# collectives. 32 keeps the reads below 1/32 of the steps and the dead
# steps below 32 a call; a call of at most 32 steps reads nothing.
CHECK_EVERY = 32

PHASES = ("colmax", "pick", "swap", "update")
# the integer state (ist) and the real state (rst), as csrc/lu_sharded.cu
# lays them out
_K, _DONE, _BESTCOL, _PC, _PR = range(5)
_M, _MAXERR, _ERR = range(3)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.complex128: 2}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lu_sharded")
    lib.lu_sharded_launch.argtypes = ([_I, _I] + [_P] * 12 + [_I] * 7
                                      + [_D, _D, _I, _P])
    lib.lu_sharded_launch.restype = _I
    return lib


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _int_type(rdt: torch.dtype) -> torch.dtype:
    return torch.int32 if rdt == torch.float32 else torch.int64


def _key(v: torch.Tensor) -> torch.Tensor:
    """The integer keys of metrics v (>= 0, -1 or NaN): their bits, every
    NaN the positive quiet NaN, so that an integer max is the metrics' max
    with NaN above every value (the kernel's Key)."""
    nan = torch.tensor(0x7FC00000 if v.dtype == torch.float32
                       else 0x7FF8000000000000,
                       dtype=_int_type(v.dtype), device=v.device)
    return torch.where(v.isnan(), nan, v.view(_int_type(v.dtype)))


def _bits(t: torch.Tensor) -> torch.Tensor:
    """t's bits as integers of its real type's width (a view; an integer
    tensor as it is)."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(_int_type(t.dtype)) if t.is_floating_point() else t


class _State:
    """One rank's block and the replicated state of an elimination."""

    FIELDS = ("A", "xcol", "rowbuf", "colkey", "rowperm", "rowpos",
              "colperm", "colpos", "pos", "ist", "rst", "mags")

    def __init__(self, Ablk, offset, mp, m, n, reltol, abstol,
                 leftorthogonal):
        dev, dt = Ablk.device, Ablk.dtype
        rdt = dt.to_real()
        m_blk, npd = Ablk.shape
        self.m_blk, self.npd, self.mp, self.offset = m_blk, npd, mp, offset
        self.m, self.n = m, n
        self.reltol, self.abstol = float(reltol), float(abstol)
        self.leftorthogonal = bool(leftorthogonal)
        self.A = Ablk
        self.xcol = torch.zeros(m_blk, dtype=dt, device=dev)
        self.rowbuf = torch.zeros(npd, dtype=dt, device=dev)
        self.colkey = _key(torch.full((npd,), -1.0, dtype=rdt, device=dev))
        self.rowperm = torch.arange(mp, dtype=torch.int32, device=dev)
        self.rowpos = self.rowperm.clone()
        self.colperm = torch.arange(npd, dtype=torch.int32, device=dev)
        self.colpos = self.colperm.clone()
        self.pos = torch.zeros(1, dtype=torch.int32, device=dev)
        self.ist = torch.zeros(5, dtype=torch.int32, device=dev)
        self.rst = torch.tensor([0.0, 0.0, float("nan")], dtype=rdt,
                                device=dev)
        self.mags = torch.zeros(min(mp, npd), dtype=rdt, device=dev)
        # the kernel's arguments but the phase and the stream, made at the
        # first launch (a step launches three times from the host)
        self.args = None

    def clone(self) -> "_State":
        other = object.__new__(_State)
        other.__dict__.update(self.__dict__)
        for name in self.FIELDS:
            setattr(other, name, getattr(self, name).clone())
        other.args = None
        return other


# -- the plain version: the kernel's three phases in torch operations --------


def _plain_colmax(s: _State) -> None:
    """The first column maxima of the valid block (rows < m, columns < n)."""
    rows = s.offset + torch.arange(s.m_blk, device=s.A.device)
    cols = torch.arange(s.npd, device=s.A.device)
    live = (rows < s.m)[:, None] & (cols < s.n)[None, :]
    met = torch.where(live, _abs2(s.A), -1.0).amax(0)
    s.colkey.copy_(torch.maximum(s.colkey, _key(met)))


def _plain_pick(s: _State) -> None:
    if bool(s.ist[_DONE]):
        return
    k = int(s.ist[_K])
    rdt = s.rst.dtype
    neg1 = -torch.ones((), dtype=rdt, device=s.A.device)
    cols = torch.arange(s.npd, device=s.A.device)
    validc = (s.colpos >= k) & (cols < s.n)
    cm = torch.where(validc, s.colkey.view(rdt), neg1)
    M = cm.max()
    bcp = min(_first(cm, M, validc, s.colpos), s.npd - 1)
    pc = int(s.colperm[bcp])
    acol = s.A[:, pc]
    s.xcol.copy_(acol)
    gids = s.offset + torch.arange(s.m_blk, device=s.A.device)
    rpos = s.rowpos[gids]
    validr = (gids < s.m) & (rpos >= k)
    met = torch.where(validr, _abs2(acol), neg1)
    Ml = met.max()
    same = bool(Ml == M) or bool(Ml.isnan() & M.isnan())
    s.pos[0] = _first(met, Ml, validr, rpos) if same else _BIG
    s.ist[_BESTCOL] = bcp
    s.ist[_PC] = pc
    s.rst[_M] = M


def _plain_swap(s: _State) -> None:
    if bool(s.ist[_DONE]):
        return
    k = int(s.ist[_K])
    M = s.rst[_M].clone()
    rdt = s.rst.dtype
    if bool(M < 0):
        s.rst[_ERR] = 0.0
        s.ist[_DONE] = 1
        return
    newerr = torch.sqrt(torch.clamp(M, min=0))
    maxerror = s.rst[_MAXERR].clone()
    rt = torch.tensor(s.reltol, dtype=rdt, device=M.device)
    at = torch.tensor(s.abstol, dtype=rdt, device=M.device)
    stop = k > 0 and (bool(newerr < rt * maxerror) or bool(newerr < at)
                      or bool(newerr == 0))
    s.rst[_ERR] = newerr
    if stop:
        s.ist[_DONE] = 1
        return
    brp = min(int(s.pos[0]), s.mp - 1)
    pr = int(s.rowperm[brp])
    r_at_k = int(s.rowperm[k])
    s.rowperm[brp] = r_at_k
    s.rowperm[k] = pr
    s.rowpos[r_at_k] = brp
    s.rowpos[pr] = k
    bcp, pc = int(s.ist[_BESTCOL]), int(s.ist[_PC])
    c_at_k = int(s.colperm[k])
    s.colperm[bcp] = c_at_k
    s.colperm[k] = pc
    s.colpos[c_at_k] = bcp
    s.colpos[pc] = k
    s.mags[k] = newerr
    s.rst[_MAXERR] = torch.maximum(maxerror, newerr)
    s.ist[_PR] = pr
    s.ist[_K] = k + 1
    if s.offset <= pr < s.offset + s.m_blk:
        s.rowbuf.copy_(s.A[pr - s.offset])
    else:
        s.rowbuf.zero_()
    s.colkey.copy_(_key(torch.full_like(s.rowbuf, -1.0, dtype=rdt)))


def _plain_update(s: _State) -> None:
    if bool(s.ist[_DONE]):
        return
    k, pc, pr = (int(s.ist[i]) for i in (_K, _PC, _PR))
    dev = s.A.device
    gids = s.offset + torch.arange(s.m_blk, device=dev)
    cols = torch.arange(s.npd, device=dev)
    urow = (gids < s.m) & (s.rowpos[gids] >= k)
    ucol = (s.colpos >= k) & (cols < s.n)
    piv = s.rowbuf[pc]
    safe = torch.where(piv != 0, piv, torch.ones_like(piv))
    if s.leftorthogonal:
        x, y = _div(s.xcol, safe), s.rowbuf
    else:
        x, y = s.xcol, _div(s.rowbuf, safe)
    live = urow[:, None] & ucol[None, :]
    Anew = torch.where(live, s.A - _mul(x[:, None], y[None, :]), s.A)
    if s.leftorthogonal:
        Anew[:, pc] = torch.where(urow, x, Anew[:, pc])
    elif s.offset <= pr < s.offset + s.m_blk:
        Anew[pr - s.offset] = torch.where(ucol, y, Anew[pr - s.offset])
    s.A.copy_(Anew)
    met = torch.where(live, _abs2(s.A), -1.0).amax(0)
    s.colkey.copy_(torch.maximum(s.colkey, _key(met)))


_PLAINS = (_plain_colmax, _plain_pick, _plain_swap, _plain_update)


def _plain(s: _State, phase: int) -> None:
    PLAIN_CALLS[s.A.device.type] += 1
    _PLAINS[phase](s)


# -- the kernel --------------------------------------------------------------


def _launch(s: _State, phase: int) -> None:
    """One launch of the step kernel's `phase` on s (a CUDA block)."""
    dev = s.A.device
    if s.args is None:
        if dev.type != "cuda":
            raise ValueError(f"lu_sharded kernel needs CUDA tensors, got "
                             f"{dev}")
        if s.A.dtype not in _DTYPE_CODE:
            raise TypeError(f"lu_sharded kernel takes float32, float64 or "
                            f"complex128, got {s.A.dtype}")
        if not s.A.is_contiguous():
            raise ValueError("lu_sharded kernel needs a contiguous block")
        s.args = (*(getattr(s, name).data_ptr() for name in _State.FIELDS),
                  s.m_blk, s.npd, s.mp, s.offset, s.m, s.n,
                  int(s.leftorthogonal), s.reltol, s.abstol,
                  _sms(dev.index))
    with torch.cuda.device(dev):
        rc = _lib().lu_sharded_launch(
            _DTYPE_CODE[s.A.dtype], phase, *s.args,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"lu_sharded kernel ({PHASES[phase]}) launch failed with CUDA "
            f"error {rc} (block {s.m_blk}x{s.npd}, {s.A.dtype})")
    LAUNCHES["lu_sharded_step"] += 1


def _checked_launch(s: _State, phase: int) -> None:
    """The launch, and its plain version on copies of the same inputs;
    every field must come out bitwise equal."""
    before = s.clone()
    _launch(s, phase)
    _plain(before, phase)
    equal = all(torch.equal(_bits(getattr(s, f)), _bits(getattr(before, f)))
                for f in _State.FIELDS)
    diff = (s.A - before.A).abs()
    err = float(torch.nan_to_num(diff, nan=float("inf")).max()) \
        if diff.numel() else 0.0
    CHECKS.append((PHASES[phase], equal, err))


def _phase(s: _State, phase: int) -> None:
    """Run `phase` where the block lies: the plain version on the CPU, the
    kernel on a card (which raises for what it does not take)."""
    if s.A.device.type == "cpu":
        _plain(s, phase)
    elif CHECKS is not None:
        _checked_launch(s, phase)
    else:
        _launch(s, phase)


def _all_reduce(t: torch.Tensor, op, group, kind: str) -> None:
    dist.all_reduce(t, op=op, group=group)
    COLLECTIVES[kind] += 1


def _eliminate(s: _State, maxrank: int, group) -> None:
    """Queue the elimination's steps on s (every rank with its own block),
    reading the replicated stop flag once every CHECK_EVERY steps."""
    _phase(s, 0)
    _all_reduce(s.colkey, dist.ReduceOp.MAX, group, "max")
    for step in range(1, maxrank + 1):
        _phase(s, 1)
        _all_reduce(s.pos, dist.ReduceOp.MIN, group, "min")
        _phase(s, 2)
        _all_reduce(_bits(s.rowbuf), dist.ReduceOp.SUM, group, "sum")
        _phase(s, 3)
        _all_reduce(s.colkey, dist.ReduceOp.MAX, group, "max")
        if step % CHECK_EVERY == 0 and step < maxrank:
            FLAG_READS["stop"] += 1
            if bool(s.ist[_DONE]):
                break


def rrlu_panel_sharded(Ap: torch.Tensor, m_true: int, n_true: int,
                       maxrank: int, reltol: float, abstol: float, *,
                       leftorthogonal: bool, mesh):
    """Eliminate one zero-padded (mp, np) panel, the same on every rank,
    with its rows sharded over `mesh` (mp a multiple of the mesh size).
    Returns ``lu_kernel.rrlu_plain``'s 6-tuple on every rank: (A_sw,
    rowperm, colperm, k, mags, err) on the panel's device, A_sw the
    gathered factored panel in the swapped layout."""
    P, r = mesh.size(), mesh_rank(mesh)
    mp, npd = Ap.shape
    if mp % P:
        raise ValueError(f"the panel's {mp} rows do not split over {P} "
                         f"ranks")
    m = min(max(int(m_true), 0), mp)
    n = min(max(int(n_true), 0), npd)
    # clamped as rrlu_plain clamps it; the steps past the last valid line
    # only find that none is left (err 0)
    maxrank = min(max(int(maxrank), 0), min(mp, npd))
    m_blk = mp // P
    s = _State(Ap[r * m_blk:(r + 1) * m_blk].clone(), r * m_blk, mp, m, n,
               reltol, abstol, leftorthogonal)
    group = mesh_group(mesh)
    _eliminate(s, maxrank, group)
    A_full = all_gather_rows(s.A, mesh)
    COLLECTIVES["all_gather"] += 1
    rowperm, colperm = s.rowperm.long(), s.colperm.long()
    k = s.ist[_K].long()
    return (A_full[rowperm][:, colperm], rowperm, colperm, k, s.mags,
            s.rst[_ERR])


def rrlu_sharded_raw(
    A: Union[np.ndarray, torch.Tensor],
    maxrank: int = _INTMAX,
    reltol: float = 1e-14,
    abstol: float = 0.0,
    leftorthogonal: bool = True,
    mesh=None,
):
    """``lu_kernel.rrlu_raw`` with the elimination row-sharded over `mesh`
    (``parallel.mesh.default_mesh()`` when None), called by every rank
    with the same A. A numpy array goes to the rank's device; a tensor
    must lie on a device of the mesh's type. Returns rrlu_raw's 7-tuple on
    every rank."""
    if mesh is None:
        mesh = default_mesh()
    dev = mesh_device(mesh)
    if not isinstance(A, torch.Tensor):
        A = to_device(np.asarray(A), dev)
    elif A.device.type != dev.type:
        raise ValueError(f"A lies on {A.device}; the mesh computes on "
                         f"{dev.type}")
    m, n = A.shape
    dt = torch.complex128 if A.is_complex() else torch.float64
    if m == 0 or n == 0:
        return (A.to(dt), np.arange(m), np.arange(n), 0,
                np.zeros((0,), dtype=np.complex128 if dt.is_complex
                         else np.float64),
                float("nan"), (False, False))
    P = mesh.size()
    mp = -(-bucket(m) // P) * P
    npd = bucket(n)
    Ap = torch.zeros((mp, npd), dtype=dt, device=A.device)
    Ap[:m, :n] = A
    out = rrlu_panel_sharded(Ap, m, n, min(int(maxrank), m, n), reltol,
                             abstol, leftorthogonal=leftorthogonal,
                             mesh=mesh)
    return fetch_result(*out, m, n)


def rrlu_sharded(
    A,
    maxrank: int = _INTMAX,
    reltol: float = 1e-14,
    abstol: float = 0.0,
    leftorthogonal: bool = True,
    mesh=None,
):
    """Mesh-sharded ``rrlu``: the same ``rrLU`` as ``ops.lu.rrlu`` (pivot
    order bitwise the one-device elimination's), with the elimination
    row-sharded over the mesh's ranks."""
    from .lu import _finalize

    LU, rowperm, colperm, k, diag, err, nanflags = rrlu_sharded_raw(
        A, maxrank, reltol, abstol, leftorthogonal, mesh=mesh)
    return _finalize(LU, rowperm, colperm, k, err, leftorthogonal, diag,
                     nanflags)


def make_lu_split_sharded(mesh, m: int, n: int, cap: int,
                          leftorthogonal: bool):
    """The mesh counterpart of ``models.contraction_device._lu_split`` for
    (m, n) panels: ``split(Cm, m_true, n_true, reltol, abstol) -> (left
    (m, cap), right (cap, n), k)``. Only the elimination runs sharded
    (rows padded to a multiple of the mesh size, masked by m_true as the
    one-device kernel masks padding); the panel comes in replicated and
    the factored panel goes out gathered, so the factor extraction and the
    products around it compute as on one device and the result is the
    device tier's, bitwise. Like ``rrlu_sharded_raw`` it reads the stop
    flag once every CHECK_EVERY steps, so at most CHECK_EVERY - 1 dead
    steps are queued a split."""
    from .lu_kernel import aligned_panel, split_factors

    P = mesh.size()
    mp = -(-m // P) * P
    maxrank = min(m, n, cap)

    def split(Cm, m_true, n_true, reltol, abstol):
        Cp = aligned_panel(Cm)
        if mp != m:
            Cp = torch.cat([Cp, Cp.new_zeros((mp - m, Cp.shape[1]))])
        A_sw, rowperm, colperm, kk, _, _ = rrlu_panel_sharded(
            Cp, m_true, n_true, maxrank, reltol, abstol,
            leftorthogonal=leftorthogonal, mesh=mesh)
        return split_factors(A_sw, rowperm, colperm, kk, m, n, cap,
                             leftorthogonal)

    return split
