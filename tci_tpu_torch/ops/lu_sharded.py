"""Row-sharded complete-pivot rank-revealing LU over a 1-D DeviceMesh.

Counterpart of ``tci_tpu/ops/lu_sharded.py``. A panel's rows are cut into
one contiguous block a rank (rows padded to ``bucket(m)`` rounded up to a
multiple of the mesh size, columns to ``bucket(n)``); the elimination is
``tci_tpu``'s ``_make_state_fn`` with its decision made the same way on
every rank from one gather a step, so the pivot order is bitwise the
one-device elimination's:

- first: each rank's candidate over its valid block, the largest |a|^2
  with NaN above every value, then the smallest swapped column position,
  then the smallest swapped row position, left in the rank's send slot
  with the entry and the candidate's whole row;
- step: every rank reads the P gathered slots and takes the same decision
  by the same order (the global first maximum in the swapped column-major
  order: the column with the largest maximum, then the first row in it,
  which is the reference's two-stage rule), the stop test of
  matrixlu.jl:363 and the virtual swaps of the replicated permutations;
  y comes from the winner's slot row, x from the rank's own rows; the
  Schur update of the rank's block with the multipliers stored (the
  owner stores row pr's when right-orthogonal); and the rank's next
  candidate goes to its send slot. The block's write-back is deferred
  over ``defer_depth`` steps (below), bitwise the same at every depth.

After each phase one all-gather of the slots (``all_gather_rows`` of one
contiguous integer tensor a rank: the slot's bits, so NCCL and gloo move
it exactly). A slot is ``_HEAD`` bytes of header, |a|^2 (a NaN as the
all-ones NaN, the bits torch's max gives the one-device plain version's
pivot metric), the key (swapped column position << 32 | swapped row
position; -1 for "no candidate", then |a|^2 is -1), the entry and the
candidate's original row and column, then the row, each field in its own
bits. The replicated integer state holds k, the stop flag and the row and
column at position k, so a decision reads the state and the slots and
nothing that depends on them.

Each phase is a launch of the hand-written CUDA kernel ``csrc/lu_sharded.cu``
for a block on a card, and its plain PyTorch version (``_plain``, the
arithmetic of ``lu_kernel.rrlu_plain``) for a block on the CPU, where the
gather runs on gloo. The steps queue with no read of the device; the stop
test sets a flag in the replicated state that turns the later steps into
no-ops, and the host reads it once every ``CHECK_EVERY`` steps. The
factored blocks are gathered once at the end into the swapped layout of
``rrlu_raw``. float32, float64 and complex128 panels are taken.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional, Union

import numpy as np
import torch

from ..parallel.mesh import (all_gather_rows, default_mesh, mesh_device,
                             mesh_rank)
from ..utils.device import to_device
from . import _build
from .lu_kernel import _abs2, _div, _mul, bucket, fetch_result

_INTMAX = 2**62

# Launches of the step kernel (one a pivot step, one for the first
# candidate), counted where it is launched and nowhere else.
LAUNCHES: Counter = Counter()
# Calls of the plain version's phases, by the device type of the block. The
# main path on a card leaves the "cuda" count at 0 (CHECKS runs it there).
PLAIN_CALLS: Counter = Counter()
# Collectives of the eliminations run so far, by kind: "gather" (the slots,
# one after each phase), "all_gather" (the factored blocks, one a call).
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
# the stop is a dead step, a launch that returns at once and a gather. 32
# keeps the reads below 1/32 of the steps and the dead steps below 32 a
# call; a call of at most 32 steps reads nothing.
CHECK_EVERY = 32

# The deferred write-back: a step's pass rebuilds each live entry from the
# buffer by the pending updates a - x_t y_t, in order (the same rounded
# steps), and writes the block back only every `depth`-th step and at the
# last; the lines that leave the live block (column pc, row pr) go to the
# buffer as they end. MAX_DEFER is the kernel's largest depth; DEFER, when
# set, forces a depth on every elimination (for measurement and tests).
MAX_DEFER = 4
DEFER: Optional[int] = None


@functools.cache
def _l2_bytes(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).L2_cache_size


def defer_depth(m_blk: int, npd: int, dtype: torch.dtype,
                device: torch.device) -> int:
    """The deferral depth of an elimination of an (m_blk, npd) block on
    `device`: on a card 1 while the block fits its L2 (a pass reads it from
    there and a rebuild costs more than the writes it saves), MAX_DEFER
    above, where every pass streams the block from device memory (measured
    on an H100 with tools/sharded_ab.py; PERF.md, the sharded step's
    findings); 1 on the CPU, where the plain version saves nothing by it."""
    if DEFER is not None:
        return DEFER
    if device.type != "cuda":
        return 1
    nbytes = m_blk * npd * torch.empty((), dtype=dtype).element_size()
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return MAX_DEFER if nbytes > _l2_bytes(index) else 1


PHASES = ("first", "step")
# the integer state (ist) and the real state (rst), as csrc/lu_sharded.cu
# lays them out
_K, _DONE, _ROW_AT_K, _COL_AT_K = range(4)
_MAXERR, _ERR = range(2)
# bytes of a slot's header: |a|^2 at 0, the key at 8, the entry at 16, the
# candidate's row and column (int32) at 32 and 36
_HEAD = 48
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.complex128: 2}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lu_sharded")
    lib.lu_sharded_launch.argtypes = ([_I, _I] + [_P] * 13 + [_I] * 12
                                      + [_D, _D, _I, _P])
    lib.lu_sharded_launch.restype = _I
    lib.lu_sharded_scratch_bytes.argtypes = [_I, _I, _I]
    lib.lu_sharded_scratch_bytes.restype = ctypes.c_size_t
    return lib


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _int_type(rdt: torch.dtype) -> torch.dtype:
    return torch.int32 if rdt == torch.float32 else torch.int64


def _bits(t: torch.Tensor) -> torch.Tensor:
    """t's bits as integers of its real type's width (a view; an integer
    tensor as it is)."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.view(_int_type(t.dtype)) if t.is_floating_point() else t


def _slot_words(npd: int, dtype: torch.dtype) -> int:
    """int64 words of a slot: the header and a row of npd elements, rounded
    up to 16 bytes."""
    row = npd * torch.empty((), dtype=dtype).element_size()
    return (_HEAD + -(-row // 16) * 16) // 8


class _Slots:
    """Views of slots (a (..., W) int64 tensor) as their fields."""

    def __init__(self, slots: torch.Tensor, dtype: torch.dtype, npd: int):
        es = torch.empty((), dtype=dtype).element_size()
        rdt = dtype.to_real()
        self.val = slots.view(rdt)[..., 0]
        self.valbits = slots.view(_int_type(rdt))[..., 0]
        self.key = slots[..., 1]
        self.entry = slots.view(dtype)[..., 16 // es]
        self.at = slots.view(torch.int32)[..., 8:10]
        self.row = slots.view(dtype)[..., _HEAD // es:_HEAD // es + npd]


class _State:
    """One rank's block, its slots and the replicated state of an
    elimination."""

    FIELDS = ("A", "send", "recv", "rowperm", "rowpos", "colperm", "colpos",
              "ist", "rst", "mags", "px", "py")

    def __init__(self, Ablk, offset, mp, m, n, reltol, abstol,
                 leftorthogonal, P, maxrank):
        dev, dt = Ablk.device, Ablk.dtype
        rdt = dt.to_real()
        m_blk, npd = Ablk.shape
        self.m_blk, self.npd, self.mp, self.offset = m_blk, npd, mp, offset
        self.m, self.n, self.P = m, n, P
        self.reltol, self.abstol = float(reltol), float(abstol)
        self.leftorthogonal = bool(leftorthogonal)
        self.A = Ablk
        W = _slot_words(npd, dt)
        self.send = torch.zeros((1, W), dtype=torch.int64, device=dev)
        self.recv = torch.zeros((P, W), dtype=torch.int64, device=dev)
        self.rowperm = torch.arange(mp, dtype=torch.int32, device=dev)
        self.rowpos = self.rowperm.clone()
        self.colperm = torch.arange(npd, dtype=torch.int32, device=dev)
        self.colpos = self.colperm.clone()
        self.ist = torch.zeros(4, dtype=torch.int32, device=dev)
        self.rst = torch.tensor([0.0, float("nan")], dtype=rdt, device=dev)
        self.mags = torch.zeros(min(mp, npd), dtype=rdt, device=dev)
        self.maxrank = int(maxrank)
        self.depth = defer_depth(m_blk, npd, dt, dev)
        if not 1 <= self.depth <= MAX_DEFER:
            raise ValueError(f"deferral depth {self.depth} outside [1, "
                             f"{MAX_DEFER}]")
        # the pending updates' x (by row) and y (by column), in order; the
        # steps queued so far (the host's count: a step's pending count is
        # steps % depth, fixed in each launch; so a CUDA graph of steps
        # replays right only from a state whose step count is the capture's
        # modulo the depth, and replays back to back only when it holds a
        # multiple of the depth)
        self.px = torch.zeros((self.depth, m_blk), dtype=dt, device=dev)
        self.py = torch.zeros((self.depth, npd), dtype=dt, device=dev)
        self.steps = 0
        # the kernel's scratch (its blocks' candidates and the counter the
        # last block resets) and arguments, made at the first launch
        self.scratch = None
        self.args = None

    def clone(self) -> "_State":
        other = object.__new__(_State)
        other.__dict__.update(self.__dict__)
        for name in self.FIELDS:
            setattr(other, name, getattr(self, name).clone())
        other.scratch = other.args = None
        return other


# -- the plain version: the kernel's two phases in torch operations ---------


def _live(s: _State, k: int):
    """The rows and the columns of the block live at position k: valid and
    not yet pivoted."""
    dev = s.A.device
    gids = s.offset + torch.arange(s.m_blk, device=dev)
    cols = torch.arange(s.npd, device=dev)
    return ((gids < s.m) & (s.rowpos[gids] >= k),
            (cols < s.n) & (s.colpos >= k))


def _current(s: _State, k: int, npend: int) -> torch.Tensor:
    """The block as it stands: the buffer with the npend pending updates
    a - x_t y_t applied in order to the entries live at k (each of them was
    live through every pending update)."""
    C = s.A.clone()
    if npend:
        urow, ucol = _live(s, k)
        live = urow[:, None] & ucol[None, :]
        for t in range(npend):
            C = torch.where(live, C - _mul(s.px[t][:, None],
                                           s.py[t][None, :]), C)
    return C


def _candidate(s: _State, C: torch.Tensor) -> None:
    """The rank's candidate over the live entries of its block as it stands
    (C) into its send slot: the first maximum of |a|^2 (NaN above every
    value) by swapped column position, then swapped row position, with the
    entry, its place and its whole row; none: |a|^2 -1, key -1, entry 0,
    place (-1, -1), the row left as it was."""
    k = int(s.ist[_K])
    urow, ucol = _live(s, k)
    gids = s.offset + torch.arange(s.m_blk, device=C.device)
    rpos = s.rowpos[gids].long()
    live = urow[:, None] & ucol[None, :]
    met = torch.where(live, _abs2(C), -1.0)
    nan = met.isnan()
    out = _Slots(s.send[0], C.dtype, s.npd)
    if bool(nan.any()):
        hit = nan
    else:
        top = met.max() if met.numel() else None
        if top is None or bool(top < 0):
            out.val.fill_(-1.0)
            out.key.fill_(-1)
            out.entry.zero_()
            out.at.fill_(-1)
            return
        hit = met == top
    key = (s.colpos.long() << 32)[None, :] | rpos[:, None]
    at = int(torch.where(hit, key, torch.iinfo(torch.int64).max).argmin())
    i, j = divmod(at, s.npd)
    out.val.copy_(met[i, j])
    if bool(nan.any()):
        out.valbits.fill_(-1)
    out.key.copy_(key[i, j])
    out.entry.copy_(C[i, j])
    out.at[0], out.at[1] = s.offset + i, j
    out.row.copy_(C[i])


def _plain_first(s: _State) -> None:
    _candidate(s, s.A)


def _plain_step(s: _State) -> None:
    npend = s.steps % s.depth
    s.steps += 1
    if bool(s.ist[_DONE]):
        return
    k = int(s.ist[_K])
    rdt = s.rst.dtype
    dev = s.A.device
    got = _Slots(s.recv, s.A.dtype, s.npd)
    # the decision: the largest |a|^2 (NaN above every value), then the
    # smallest key; "no candidate" (|a|^2 -1) loses to every candidate
    nan = got.val.isnan()
    hit = nan if bool(nan.any()) else got.val == got.val.max()
    q = int(torch.where(hit, got.key, torch.iinfo(torch.int64).max)
            .argmin())
    v = got.val[q]
    stop = bool(v < 0)
    if stop:
        # no valid line left: stop with err 0, as the one-device kernel does
        s.rst[_ERR] = 0.0
    else:
        newerr = torch.sqrt(torch.clamp(v, min=0))
        maxerror = s.rst[_MAXERR].clone()
        rt = torch.tensor(s.reltol, dtype=rdt, device=dev)
        at = torch.tensor(s.abstol, dtype=rdt, device=dev)
        stop = k > 0 and (bool(newerr < rt * maxerror) or bool(newerr < at)
                          or bool(newerr == 0))
        s.rst[_ERR] = newerr
    if stop:
        # the pending updates go to the buffer
        if npend:
            s.A.copy_(_current(s, k, npend))
        s.ist[_DONE] = 1
        return
    key = int(got.key[q])
    bcp, brp = key >> 32, key & 0xFFFFFFFF
    pr, pc = (int(i) for i in got.at[q])
    r_at_k, c_at_k = int(s.ist[_ROW_AT_K]), int(s.ist[_COL_AT_K])
    s.rowperm[brp] = r_at_k
    s.rowperm[k] = pr
    s.rowpos[r_at_k] = brp
    s.rowpos[pr] = k
    s.colperm[bcp] = c_at_k
    s.colperm[k] = pc
    s.colpos[c_at_k] = bcp
    s.colpos[pc] = k
    s.mags[k] = newerr
    s.rst[_MAXERR] = torch.maximum(maxerror, newerr)
    s.ist[_K] = k + 1
    s.ist[_ROW_AT_K] = s.rowperm[k + 1] if k + 1 < s.mp else 0
    s.ist[_COL_AT_K] = s.colperm[k + 1] if k + 1 < s.npd else 0
    # the block as it stands (the live entries at k are those of before the
    # swap), then the Schur update: y from the winner's row, x from this
    # rank's rows
    C = _current(s, k, npend)
    piv = got.entry[q]
    row = got.row[q]
    rows_k, _ = _live(s, k)
    urow, ucol = _live(s, k + 1)
    safe = torch.where(piv != 0, piv, torch.ones_like(piv))
    if s.leftorthogonal:
        x, y = _div(C[:, pc], safe), row
    else:
        x, y = C[:, pc], _div(row, safe)
    live = urow[:, None] & ucol[None, :]
    Cnew = torch.where(live, C - _mul(x[:, None], y[None, :]), C)
    if s.leftorthogonal:
        Cnew[:, pc] = torch.where(urow, x, Cnew[:, pc])
    owner = s.offset <= pr < s.offset + s.m_blk
    if owner and not s.leftorthogonal:
        Cnew[pr - s.offset] = torch.where(ucol, y, Cnew[pr - s.offset])
    if s.depth > 1:
        s.px[npend] = torch.where(urow, x, torch.zeros_like(x))
        s.py[npend] = torch.where(ucol, y, torch.zeros_like(y))
    if npend + 1 >= s.depth or k + 1 == s.maxrank:
        s.A.copy_(Cnew)
    else:
        # deferred: the buffer takes the lines that leave the live block as
        # they end (column pc, the owner's row pr), the live entries wait
        s.A[:, pc] = torch.where(rows_k, Cnew[:, pc], s.A[:, pc])
        if owner:
            i = pr - s.offset
            keep = ucol.clone()
            keep[pc] = True
            s.A[i] = torch.where(keep, Cnew[i], s.A[i])
    _candidate(s, Cnew)


_PLAINS = (_plain_first, _plain_step)


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
        code, sms = _DTYPE_CODE[s.A.dtype], _sms(dev.index)
        s.scratch = torch.zeros(
            int(_lib().lu_sharded_scratch_bytes(code, s.m_blk, sms)),
            dtype=torch.uint8, device=dev)
        s.args = (s.A.data_ptr(), s.send.data_ptr(),
                  *(getattr(s, name).data_ptr() for name in _State.FIELDS[3:]),
                  s.scratch.data_ptr(), s.P, s.send.shape[1], s.m_blk, s.npd,
                  s.mp, s.offset, s.m, s.n, int(s.leftorthogonal),
                  s.maxrank, s.depth)
    npend = 0
    if phase == 1:
        npend = s.steps % s.depth
        s.steps += 1
    with torch.cuda.device(dev):
        rc = _lib().lu_sharded_launch(
            _DTYPE_CODE[s.A.dtype], phase, s.args[0], s.recv.data_ptr(),
            *s.args[1:], npend, s.reltol, s.abstol, _sms(dev.index),
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


def _gather(s: _State, mesh) -> None:
    """Every rank's send slot into every rank's recv, in rank order."""
    all_gather_rows(s.send, mesh, out=s.recv)
    COLLECTIVES["gather"] += 1


def _eliminate(s: _State, maxrank: int, mesh) -> None:
    """Queue the elimination's steps on s (every rank with its own block),
    reading the replicated stop flag once every CHECK_EVERY steps."""
    _phase(s, 0)
    _gather(s, mesh)
    for step in range(1, maxrank + 1):
        _phase(s, 1)
        _gather(s, mesh)
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
               reltol, abstol, leftorthogonal, P, maxrank)
    _eliminate(s, maxrank, mesh)
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
