"""Device-resident TCI2 sweeps: a whole 2-site sweep, the site-tensor fill
and the 1-site sweep on the evaluator's device, with no host sync inside a
sweep and one fetch at its end.

Counterpart of ``tci_tpu/models/device_sweep.py`` (full and rook
pivoting, on one device or data-parallel over a mesh; no pair mode). The
reference's sweep2site! (tensorci2.jl:1195-1258) is a host loop doing, per
bond, a Π sampling, an rrLU factorization and index-set bookkeeping. Here:

- index sets live on the device as (L, Imax, L) int64 row buffers (every
  multi-index stored left-aligned) and (L,) lengths;
- per bond the candidate sets are built by broadcasting kron products, and
  the candidates from the non-strict-nesting history are appended *without
  dedup*: a duplicated row is linearly dependent, has an exactly zero Schur
  residual once its first copy is pivoted, and is never selected, so the
  union semantics of the reference (tensorci2.jl:842-843) hold;
- valid rows are moved to the front in a stable order, so the masked rrLU
  kernel sees a contiguous panel; its extents, rank cap and results stay on
  the device, and the selected pivots are gathered back into the buffers.

``tci_tpu`` traces one XLA program per sweep (a ``lax.scan`` over bonds)
and keeps it in ``DeviceSweepEngine._sweeps``. Here each body is a host
loop over bonds that queues launches: the bond index is a Python int, every
shape is fixed by the capacity Imax, nothing reads a device value until the
sweep's single fetch, and the tolerances and the rank cap are device
scalars. So a body bakes in nothing that changes between calls, and on a
CUDA device the engine records it once into a CUDA graph (``_Program``),
keeps the graph in ``_sweeps`` under the reference's keys and replays it on
every later call of that key: one copy in, one replay, one copy out. On the
CPU the same bodies run eagerly through the same holder.

As in ``tci_tpu``, ``TensorCI2.optimize`` runs by default the two larger
programs built from the same bodies: ``sweep2site_pair`` (an optimize
iteration's two sweeps, the fill and the global-pivot candidate search
against the filled cores, ``_tt_search_on_cores``, one fetch) and
``optimize_loop`` (blocks of such iterations with the convergence test on
the device; a graph holds no loop, so the host replays one step's program
an iteration and reads a few status bytes after each, and fetches the
block's stacked outputs once at its end). ``use_sweep_pair`` and
``use_optimize_loop`` switch them off.

With ``pivotsearch="rook"`` each bond runs ``tci_tpu``'s whole-sweep rook
(``_make_sweep_rook_scan``): the current pivots are located among the
candidates on the device (``_match_positions``), the start set is widened
to the capacity by random priorities (``_fill_random``, threefry draws of
``utils/prng.py`` from a seed the host draws for each sweep, as
``tci_tpu``'s ``jax.random`` draws them) and the row and column slabs of Π
are sampled and eliminated in turn (``_rook_alternate``). A graph holds no
loop, so the alternation's while loop is unrolled into its `numrookiter`
steps, predicated: once the pivot sets agree, a step keeps the state it
was given, counts no samples and eliminates its slab with a rank cap of 0.

With a mesh (``DeviceSweepEngine(mesh=)``, from the evaluator's) every f
call of the engine goes through ``parallel.mesh.shard_rows``: each rank
samples its contiguous share of the rows (the Π panels, the global
search's and the floating zone's candidates, the rook slabs, the fill) and
an all-gather gives every rank all the values, inside the CUDA graphs on
the cards. ``tci_tpu`` puts its row sharding constraint on the same rows
but the fill's; sampling them sharded too changes no value. The rrLU
stays replicated: every rank runs the one-device kernel on the same panel.

The capacity grows when a sweep saturates it (a new capacity is a new key):
in ``tci_tpu``'s quantum (powers of two to 32, then steps of 32) up to
``QUANTUM_CAP`` = 256, where ``tci_tpu``'s engine stops, and then by
doubling, no further than the rank cap needs. It stops at
``capacity_limit()``: the largest capacity whose per-bond panel edge Imax
(dmax + 1) is at most ``max_panel_edge`` (4096) and whose largest program
works in at most ``MEMORY_SHARE`` of the device's memory
(``program_bytes``), or ``imax_cap`` where one is given. Above it the
engine declines and TensorCI2 falls back to the per-bond fused tier
(``ops/fused.py``), which runs on the device too. At d = 2 the edge allows
capacity 1344, so a TCI at rank 1000 stays on the engine. Above
``QUANTUM_CAP`` a bond's candidates are the union of the kron and history
sets, and its panels are sampled only as far as its sets can hold distinct
rows (``_Layout``); a panel whose index matrix is large is sampled in
chunks of rows (``ops/fused.sample_panel``).
"""

from __future__ import annotations

import os
import sys
import time
import weakref
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import gk_panel, lu_cuda
from ..ops import fused
from ..ops.fused import (INDEX_CHUNK_BYTES, chunk_rows, ci_factors, indexed,
                         panel_solve_pinv, sample_panel)
from ..ops.lu_kernel import rrlu_panel_batched
from ..parallel.mesh import mesh_rng, shard_rows
from ..utils.device import (FETCHES, capture_graph, fetch, peek,
                            resolve_device, to_device, torch_dtype)
from ..utils.prng import fold_in, prng_key, uniform_f64
from ..utils.trace import span
from .tteval import chi_bucket, max_bond, tt_evaluate_batched

__all__ = ["DeviceSweepEngine", "FETCHES"]

# the slab steps of a rook bond: tci_tpu's numrookiter, which its engine
# leaves at the default, every one a launch of the kernel (dead or not)
ROOK_STEPS = 5
# the capacity up to which the engine grows in tci_tpu's quantum, and above
# which tci_tpu's engine declines; the port's doubles from there
QUANTUM_CAP = 256
# the share of the device's memory that the largest program of one
# capacity may plan to work in (``program_bytes``): the graphs of the
# smaller capacities and the caller keep the rest
MEMORY_SHARE = 0.5
# start points the global search's estimate in ``program_bytes`` allows for
# (the optimize default is 5)
SEARCH_STARTS = 10

MultiIndex = Tuple[int, ...]


def _imax_target(current: int, needed: int) -> int:
    """Smallest buffer capacity >= needed, never below current: powers of two
    up to 32, then multiples of 32."""
    if needed <= current:
        return current
    if needed <= 32:
        t = 1 << (needed - 1).bit_length()
    else:
        t = 32 * ((needed + 31) // 32)
    return max(current, t)


def program_bytes(localdims: Sequence[int], Imax: int, itemsize: int) -> int:
    """An estimate of the device memory that the engine's largest program
    at capacity Imax works in at once: the 2-site sweep's padded Π panel of
    edge C = Imax (dmax + 1) in up to 8 copies (the samples, the masked
    panel, the rrLU kernel's copy and scratch, the chunks' join); the
    fill's samples, P blocks, solves and site tensors, (6 dmax + 4) L Imax²
    values; the global search's cores gathered for ``SEARCH_STARTS`` start
    points, SEARCH_STARTS dmax L Imax²; and three chunks of index matrix
    for f's own intermediates."""
    L, dmax = len(localdims), max(localdims)
    C = Imax * (dmax + 1)
    per_site = 6 * dmax + 4 + SEARCH_STARTS * dmax
    return int(itemsize * (8 * C * C + per_site * L * Imax * Imax)
               + 3 * INDEX_CHUNK_BYTES)


def _device_memory(device: torch.device) -> int:
    """The bytes of memory of `device`: the card's, or the host's for the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _lt(idx: torch.Tensor, m) -> torch.Tensor:
    """idx < m, broadcast over the batch shape of m (an int or a tensor)."""
    return idx < (m[..., None] if isinstance(m, torch.Tensor) else m)


def _valid(shape, mI, mJ, device) -> torch.Tensor:
    """Mask of the true block of (..., rows, cols) panels: row < mI and
    column < mJ (ints or tensors of the panels' batch shape)."""
    rows = _lt(torch.arange(shape[-2], device=device), mI)
    cols = _lt(torch.arange(shape[-1], device=device), mJ)
    return rows[..., :, None] & cols[..., None, :]


def _panel(f, Ic, Jc, nl: int, nr: int, mI, mJ, dtype, lay=None):
    """Π panel f([Ic_i[:nl], Jc_j[:nr]]) with invalid rows/cols masked to
    zero (``tci_tpu``'s ``_panel`` and ``_panel_dyn``: the prefix length nl
    is a Python int here). With a ``cut`` layout `lay` only the rows and
    columns that can be distinct are sampled (``_Layout.edge``; the valid
    ones come first), the rest of the panel is zero."""
    ri, cj = Ic.shape[0], Jc.shape[0]
    if lay is not None:
        ri, cj = lay.edge(lay.prefixes(nl), ri), lay.edge(lay.suffixes(nr), cj)
    Pi = sample_panel(f, Ic[:ri, :nl], Jc[:cj, :nr], dtype)
    if (ri, cj) != (Ic.shape[0], Jc.shape[0]):
        Pi = torch.nn.functional.pad(
            Pi, (0, Jc.shape[0] - cj, 0, Ic.shape[0] - ri))
    return torch.where(_valid(Pi.shape, mI, mJ, Pi.device), Pi, 0)


def _kron_is(Iset_b: torch.Tensor, b: int, d: int) -> torch.Tensor:
    """kron(Iset[b], d) rows with the site index written at position b:
    row r = i*d + s."""
    Imax, L = Iset_b.shape
    kron = Iset_b[:, None, :].repeat(1, d, 1)
    kron[:, :, b] = torch.arange(d, device=Iset_b.device)
    return kron.reshape(Imax * d, L)


def _compact(valid: torch.Tensor):
    """The stable order that moves the valid entries of the last axis to the
    front, and their count (a device tensor)."""
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    return order, valid.sum(-1)


def _rrlu(Pi, m, n, maxrank, reltol, abstol, leftorthogonal):
    """The rrLU kernel (or, on the CPU, its plain version) on one panel
    whose extents and rank cap are (1,) device tensors."""
    out = rrlu_panel_batched(Pi[None], m, n, maxrank, reltol, abstol,
                             leftorthogonal=leftorthogonal)
    return tuple(x[0] for x in out)


class _Layout:
    """Index tensors of one capacity Imax that every sweep reuses, built
    once per engine and capacity so that a bond queues few launches.

    Bond b has C = Imax (dmax + 1) candidates a side: on the I side the
    rows r = i*dmax + s of kron(Iset[b], d_b), on the J side the rows
    r = s*Imax + j of kron(d_{b+1}, Jset[b+1]), each followed by the Imax
    rows of its history set. ``row`` (2, C) is a candidate's row in its own
    set, ``src`` its row in cat([set, history]), ``extra`` marks the
    history rows, ``site`` (2, R) holds the site value s of the R = Imax
    dmax kron rows, and ``pad[b]`` (2, C) marks the site values at or above
    d_b (I side) and d_{b+1} (J side). ``ar`` is arange(C) and ``keep``
    arange(Imax) as a column, for the masks, and ``dims`` the local
    dimensions. Everything uploaded from the host lives here, outside any
    body: a graph replays a body's launches, not its uploads.

    Above ``QUANTUM_CAP`` (``cut``) a panel is sampled only as far as its
    index sets can hold distinct rows: a set of prefixes of n sites holds
    at most d_0 ... d_{n-1} of them, a set of suffixes of n sites at most
    the product of the last n local dimensions (``prefixes``,
    ``suffixes``), and ``edge`` rounds such a count up to the capacity
    ladder, at most the padded extent. At capacity 1024 and L = 20, d = 2 a
    2-site sweep then samples 6.1 M points where the padded panels hold
    179 M. At or below it every panel keeps its padded extent, as
    ``tci_tpu``'s engine samples it."""

    def __init__(self, localdims: Sequence[int], Imax: int, device):
        dmax = max(localdims)
        self.localdims = tuple(localdims)
        self.cut = Imax > QUANTUM_CAP
        R = Imax * dmax
        r = torch.arange(R, device=device)
        e = torch.arange(Imax, device=device)
        self.ar = torch.arange(R + Imax, device=device)
        self.extra = self.ar >= R
        self.row = torch.stack([torch.cat([r // dmax, e]),
                                torch.cat([r % Imax, e])])
        self.src = self.row + Imax * self.extra
        self.site = torch.stack([r % dmax, r // Imax])
        self.dims = to_device(np.asarray(localdims, dtype=np.int64), device)
        site = torch.cat([self.site, torch.zeros_like(self.site[:, :Imax])],
                         dim=1)
        self.pad = torch.stack([site[0] >= self.dims[:-1, None],
                                site[1] >= self.dims[1:, None]], dim=1)
        self.keep = e[:, None]
        # the place values of the sites first .. first + w - 1, for the
        # union's test (``_candidates``) where a multi-index of them fits
        # an int64 key: (first, w) of bond b's prefixes and suffixes
        L = len(localdims)
        self.radix = {}
        if self.cut:
            for first, w in ([(0, b) for b in range(L - 1)]
                             + [(b + 2, L - b - 2) for b in range(L - 1)]):
                place = np.cumprod((1,) + self.localdims[first:first + w],
                                   dtype=object)
                if place[-1] < 2**62:
                    self.radix[first, w] = to_device(
                        np.asarray(place[:-1], dtype=np.int64), device)

    def prefixes(self, n: int) -> int:
        """The most distinct multi-indices of the first n sites."""
        return int(np.prod(self.localdims[:n], dtype=object))

    def suffixes(self, n: int) -> int:
        """The most distinct multi-indices of the last n sites."""
        return int(np.prod(self.localdims[len(self.localdims) - n:],
                           dtype=object))

    def edge(self, count: int, full: int) -> int:
        """A panel's extent for at most `count` distinct rows: `full`, the
        padded extent, unless ``cut``; then `count` on the capacity ladder,
        at most `full`."""
        return min(full, _imax_target(1, count)) if self.cut else full


def _bond_writeback(lay, Iset, Ilen, Jset, Jlen, perrs, bi: int, bj: int,
                    be: int, Ic, Jc, rowsel, colsel, k, mags,
                    err_final) -> None:
    """Write one bond's selected pivots and error series into the sweep
    state: Iset[bi] / Jset[bj] get the first k candidate rows / columns
    (zero-padded), perrs[be] the pivot magnitudes with the residual at
    position k (reference pivoterrors, matrixlu.jl:799-801)."""
    Imax = Iset.shape[1]
    keep = lay.keep < k
    for sets, lens, i, cand, sel in ((Iset, Ilen, bi, Ic, rowsel),
                                     (Jset, Jlen, bj, Jc, colsel)):
        # a panel cut to fewer candidates than the capacity fills the
        # first rows, and the rest of the buffer is zero
        n = min(Imax, cand.shape[0])
        torch.mul(cand[sel[:n]], keep[:n], out=sets[i][:n])
        if n < Imax:
            sets[i][n:] = 0
        lens[i] = k
    # the elimination leaves the magnitudes past k at zero
    row = perrs[be]
    n = min(mags.shape[0], Imax + 1)
    row[:n] = mags[:n]
    row.scatter_(0, k.view(1), err_final.to(row.dtype).view(1))


def _sweep(f, localdims, dtype, lay, Iset, Ilen, Jset, Jlen, eI, eIlen, eJ,
           eJlen, forward: bool, reltol, abstol, maxbond):
    """One 2-site sweep (``_make_sweep_scan``'s bond body). The Π panel of
    every bond is padded to Icap x Jcap = Imax (dmax + 1) square. `reltol`
    and `abstol` are (1,) tensors and `maxbond` (the rank cap, at most
    Imax) a 0-d integer tensor on the device, as ``tci_tpu``'s program
    takes them as traced arguments. Updates the index buffers in place;
    returns (pivot errors (L-1, Imax+1), max |sample|), both on the
    device."""
    L, (Imax, dev) = len(localdims), (Iset.shape[1], Iset.device)
    perrs = torch.zeros((L - 1, Imax + 1), dtype=torch.float64, device=dev)
    maxsample = torch.zeros((), dtype=dtype.to_real(), device=dev)
    # the history sets' sizes at each bond: (|extraIset[b+1]|, |extraJset[b]|)
    exlens = torch.stack([eIlen[1:], eJlen[:-1]], dim=1)[:, :, None]
    cap = maxbond.to(torch.int32)
    C = lay.ar.shape[0]
    for b in (range(L - 1) if forward else range(L - 2, -1, -1)):
        # Icombined and Jcombined, the valid ones first; their counts are
        # the panel's extents (mI, mJ). Above QUANTUM_CAP (a ``cut``
        # layout) the valid ones are the union's, and a panel holds the
        # candidates that can be distinct
        Ic, Jc, m = _candidates(lay, Iset, Ilen, Jset, Jlen, eI, eJ, exlens,
                                b, union=lay.cut)
        Ic = Ic[:lay.edge(lay.prefixes(b + 1), C)]
        Jc = Jc[:lay.edge(lay.suffixes(L - b - 1), C)]
        Pi = sample_panel(f, Ic[:, :b + 1], Jc[:, :L - b - 1], dtype)
        ok = lay.ar < m[:, None]
        Pi = torch.where(ok[0][:Ic.shape[0], None]
                         & ok[1][None, :Jc.shape[0]], Pi, 0)
        maxsample = torch.maximum(
            maxsample, torch.linalg.vector_norm(Pi, float("inf")))
        mn = m.amin()
        maxrank = torch.minimum(mn, cap)
        _, rowperm, colperm, k, mags, err = _rrlu(
            Pi, m[0:1], m[1:2], maxrank[None], reltol, abstol, forward)
        err_final = torch.where(k >= mn, 0.0, err)
        _bond_writeback(lay, Iset, Ilen, Jset, Jlen, perrs, b + 1, b, b, Ic,
                        Jc, rowperm, colperm, k, mags, err_final)
    return perrs, maxsample


def _candidates(lay, Iset, Ilen, Jset, Jlen, eI, eJ, exlens, b: int,
                union: bool = False):
    """Bond b's candidate rows Ic (kron(Iset[b], d_b), then the Iset
    history) and columns Jc (kron(d_{b+1}, Jset[b+1]), then the Jset
    history), each moved to the front in a stable order when valid, and
    their counts m (2,) int32: the panel's extents. With `union` a history
    row or column that repeats a kron candidate is not valid, so that the
    valid ones are the union the reference forms (tensorci2.jl:842-843):
    a history row repeats one of kron(Iset[b], d_b) where its first b
    entries are a row of Iset[b], a history column one of kron(d_{b+1},
    Jset[b+1]) where its entries past the first are a row of Jset[b+1].
    Without it a history candidate that repeats a kron one is valid, as in
    ``tci_tpu``'s engine: it is never selected, but it counts in the
    extents that the rank cap and the residual rule read (ROADMAP
    C-ref-8)."""
    R = lay.site.shape[1]
    lens = torch.stack((Ilen[b], Jlen[b + 1]))[:, None]
    invalid = ((lay.row >= torch.where(lay.extra, exlens[b], lens))
               | lay.pad[b])
    if union:
        L = Iset.shape[0]
        ar = lay.keep[:, 0]

        def repeats(hist, sets, slen, a: int, first: int, w: int):
            # entries a .. a + w - 1 of each history row (sites first ..)
            # against entries 0 .. w - 1 of each row of the set, compared
            # as one int64 key a row where they fit one
            radix = lay.radix.get((first, w))
            if radix is None:
                same = (hist[:, None, a:a + w] == sets[None, :, :w]).all(-1)
            else:
                same = ((hist[:, a:a + w] * radix).sum(1)[:, None]
                        == (sets[:, :w] * radix).sum(1)[None, :])
            return (same & (ar < slen)[None, :]).any(1)

        invalid = invalid | torch.cat([
            torch.zeros((2, R), dtype=torch.bool, device=invalid.device),
            torch.stack([repeats(eI[b + 1], Iset[b], Ilen[b], 0, 0, b),
                         repeats(eJ[b], Jset[b + 1], Jlen[b + 1], 1, b + 2,
                                 L - b - 2)])], dim=1)
    order = torch.argsort(invalid.to(torch.uint8), dim=1, stable=True)
    m = (~invalid).sum(1, dtype=torch.int32)
    Ic = torch.cat([Iset[b], eI[b + 1]])[lay.src[0]]
    Ic[:R, b] = lay.site[0]
    Ic = Ic[order[0]]
    Jc = torch.cat([torch.roll(Jset[b + 1], 1, 1), eJ[b]])[lay.src[1]]
    Jc[:R, 0] = lay.site[1]
    Jc = Jc[order[1]]
    return Ic, Jc, m


def _match_positions(prev, prev_len, cand, cand_count):
    """Each row of `prev` among the candidate rows `cand` (equality over all
    slots, which are zero past a row's prefix or suffix; the first match
    wins; ``tci_tpu``'s ``_match_positions``). Returns (pos, found): pos[r]
    the candidate position of prev[r] (0 when absent), found[r] whether it
    is present and r < prev_len."""
    eq = (prev[:, None, :] == cand[None, :, :]).all(-1)
    eq &= torch.arange(cand.shape[0], device=cand.device) < cand_count
    found = eq.any(1) & (torch.arange(prev.shape[0], device=prev.device)
                         < prev_len)
    return eq.to(torch.uint8).argmax(1), found


def _continuation(prev, prev_len, cand, cand_count):
    """The positions of the current pivots among the candidates, found ones
    first in their order, and their count (the start set of a rook bond
    before widening)."""
    pos, found = _match_positions(prev, prev_len, cand, cand_count)
    order = torch.argsort((~found).to(torch.uint8), stable=True)
    return pos[order], found.sum()


def _fill_random(sel, nsel, mvalid, ncand: int, key, Imax: int):
    """Extend the positions sel[:nsel] into a candidate buffer of `ncand`
    entries (the first `mvalid` valid) with a random subset of the other
    valid positions, to width min(mvalid, Imax) (``tci_tpu``'s
    ``_fill_random``: arrlu's pushrandomsubset! and widening loop,
    matrixlu.jl:492-569, in one round). The order is that of uniform
    priorities drawn from `key`; positions already chosen or past mvalid
    get priority 2, after every draw."""
    dev = sel.device
    ar = torch.arange(ncand, device=dev)
    insel = torch.zeros(ncand, dtype=torch.int64, device=dev).scatter_reduce(
        0, sel, (torch.arange(sel.shape[0], device=dev) < nsel).to(
            torch.int64), "amax") > 0
    pri = torch.where(insel | (ar >= mvalid), 2.0, uniform_f64(key, ncand))
    fill = torch.argsort(pri, stable=True)
    cand = torch.cat([sel, fill])
    validc = torch.cat([torch.arange(sel.shape[0], device=dev) < nsel,
                        ar < mvalid - nsel])
    out = cand[torch.argsort((~validc).to(torch.uint8), stable=True)][:Imax]
    return out, torch.clamp(mvalid, max=Imax).to(torch.int64)


def _rook_alternate(slab, I0, I0len, J0, J0len, Imax: int, numrookiter: int,
                    forward: bool):
    """The alternating slab eliminations of one rook bond (``tci_tpu``'s
    ``_rook_alternate``), its while loop unrolled into `numrookiter`
    predicated steps. slab(rows, st, live) samples and eliminates the row
    slab (rows=True) or the column slab of the sets st = (I0, I0len, J0,
    J0len), with a rank cap of 0 unless `live`, and returns (newI, newIlen,
    newJ, newJlen, k, mags, err, smin, maxsample, nevals). A step after the
    sets agreed keeps every carried quantity (sets, k, mags, errors, max
    |sample|, samples).

    Residual rule: once the sets self-consist, the last slab has width k
    and reports 0 (k >= smin) although the matrix need not have rank k;
    the error of the last wide slab (k < smin), its first rejected pivot,
    is kept instead, which is what the reference's wider slabs report.
    Returns (I0f, J0f, k, mags, err_final, maxsample, nevals)."""
    dev = I0.device
    idx = torch.arange(Imax, device=dev)
    f64 = torch.float64
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    nan = torch.full((), float("nan"), dtype=f64, device=dev)
    st = {"I0": I0, "I0len": I0len, "J0": J0, "J0len": J0len, "k": zero,
          "mags": torch.zeros(Imax, dtype=f64, device=dev), "err": nan,
          "errw": nan, "smin": zero,
          "done": torch.zeros((), dtype=torch.bool, device=dev),
          "ms": torch.zeros((), dtype=f64, device=dev),
          "ne": torch.zeros((), dtype=f64, device=dev)}
    for it in range(numrookiter):
        # matrixlu.jl's alternation: for leftorthogonal the first move
        # factorizes the column slab A[:, J0]
        rows = ((it + 1) % 2 == 0) == forward
        live = ~st["done"]
        nI, nIl, nJ, nJl, k2, mags2, err2, smin2, ms2, ne2 = slab(
            rows, (st["I0"], st["I0len"], st["J0"], st["J0len"]), live)
        sameI = (nIl == st["I0len"]) & ((idx >= nIl) | (nI == st["I0"])).all()
        sameJ = (nJl == st["J0len"]) & ((idx >= nJl) | (nJ == st["J0"])).all()
        new = {"I0": nI, "I0len": nIl, "J0": nJ, "J0len": nJl, "k": k2,
               "mags": mags2.to(f64), "err": err2.to(f64),
               "errw": torch.where(k2 < smin2, err2.to(f64), st["errw"]),
               "smin": smin2, "done": sameI & sameJ,
               "ms": torch.maximum(st["ms"], ms2.to(f64)),
               "ne": st["ne"] + ne2}
        st = {key: torch.where(live, new[key], st[key]) for key in st}
    err_final = torch.where(
        st["errw"].isnan(), torch.where(st["k"] >= st["smin"], 0.0,
                                        st["err"]), st["errw"])
    return (st["I0"], st["J0"], st["k"], st["mags"], err_final, st["ms"],
            st["ne"])


def _sweep_rook(f, localdims, dtype, lay, Iset, Ilen, Jset, Jlen, eI, eIlen,
                eJ, eJlen, forward: bool, reltol, abstol, maxbond, seed,
                numrookiter: int = ROOK_STEPS):
    """One 2-site sweep by rook pivoting (``_make_sweep_rook_scan``'s bond
    body): per bond, the candidates as in ``_sweep``, the current pivots
    located among them, the start set widened to the capacity from
    threefry priorities (the key of `seed`, a 0-d int64 device tensor,
    folded with the bond index) and the slab alternation, each slab an
    (Icap, Imax) or (Imax, Jcap) panel of f through the rrLU kernel at
    extents held on the device. Updates the index buffers in place; returns
    (pivot errors (L-1, Imax+1), max |sample|, samples of the slabs), on
    the device."""
    L, (Imax, dev) = len(localdims), (Iset.shape[1], Iset.device)
    perrs = torch.zeros((L - 1, Imax + 1), dtype=torch.float64, device=dev)
    maxsample = torch.zeros((), dtype=dtype.to_real(), device=dev)
    nevals = torch.zeros((), dtype=torch.float64, device=dev)
    exlens = torch.stack([eIlen[1:], eJlen[:-1]], dim=1)[:, :, None]
    base_key = prng_key(seed)
    ar = torch.arange(Imax, device=dev)
    for b in (range(L - 1) if forward else range(L - 2, -1, -1)):
        nl, nr = b + 1, L - b - 1
        Ic, Jc, m = _candidates(lay, Iset, Ilen, Jset, Jlen, eI, eJ, exlens,
                                b, union=lay.cut)
        mI, mJ = m[0].to(torch.int64), m[1].to(torch.int64)
        Icap, Jcap = Ic.shape[0], Jc.shape[0]
        I0m, nmI = _continuation(Iset[b + 1], Ilen[b + 1], Ic, mI)
        J0m, nmJ = _continuation(Jset[b], Jlen[b], Jc, mJ)
        key_b = fold_in(base_key, b)
        if forward:
            J0, J0len = _fill_random(J0m, nmJ, mJ, Jcap, key_b, Imax)
            I0, I0len = I0m, nmI
        else:
            I0, I0len = _fill_random(I0m, nmI, mI, Icap, key_b, Imax)
            J0, J0len = J0m, nmJ
        cap = torch.minimum(torch.clamp(maxbond, max=Imax),
                            torch.minimum(mI, mJ))

        def slab(rows, st, live, Ic=Ic, Jc=Jc, mI=mI, mJ=mJ, cap=cap,
                 nl=nl, nr=nr):
            I0_, I0len_, J0_, J0len_ = st
            if rows:
                # A[I0, :]: the selected rows by every candidate column
                Pi = sample_panel(f, Ic[I0_][:, :nl], Jc[:, :nr], dtype)
                ok = (ar < I0len_)[:, None] & (torch.arange(
                    Jcap, device=dev) < mJ)[None, :]
                mr, ext = torch.minimum(cap, I0len_), (I0len_, mJ)
            else:
                # A[:, J0]: every candidate row by the selected columns
                Pi = sample_panel(f, Ic[:, :nl], Jc[J0_][:, :nr], dtype)
                ok = (torch.arange(Icap, device=dev) < mI)[:, None] & (
                    ar < J0len_)[None, :]
                mr, ext = torch.minimum(cap, J0len_), (mI, J0len_)
            Pi = torch.where(ok, Pi, 0)
            _, rp, cp, k, mags, err = _rrlu(
                Pi, ext[0].view(1), ext[1].view(1),
                torch.where(live, mr, 0).view(1), reltol, abstol, forward)
            if rows:
                newI, newJ = I0_[rp[:Imax]], cp[:Imax]
            else:
                newI, newJ = rp[:Imax], J0_[cp[:Imax]]
            return (newI, k, newJ, k, k, mags[:Imax], err,
                    torch.minimum(*ext), Pi.abs().amax(),
                    float(Pi.shape[0] * Pi.shape[1]))

        I0f, J0f, k, mags, err_final, ms, ne = _rook_alternate(
            slab, I0, I0len, J0, J0len, Imax, numrookiter, forward)
        _bond_writeback(lay, Iset, Ilen, Jset, Jlen, perrs, b + 1, b, b, Ic,
                        Jc, I0f, J0f, k, mags, err_final)
        maxsample = torch.maximum(maxsample, ms.to(maxsample.dtype))
        nevals = nevals + ne
    return perrs, maxsample, nevals


def _fill(f, localdims, dtype, lay, Iset, Ilen, Jset, Jlen):
    """All L site tensors T_b = Π₁ P^{-1} (tensorci2.jl:599-629;
    ``_make_fillsitetensors_scan``). The L-1 bonds' Π₁ and P panels and the
    last site's samples come from one call of f (where their index matrix
    is larger than ``INDEX_CHUNK_BYTES``: one call for each chunk of the
    panels' rows, and one for the last site), the L-1 P blocks from one
    batched rrLU launch. Returns (tensors (L, Imax, dmax, Imax), max
    |sample| over the Π₁ panels), on the device."""
    L, dmax, (Imax, dev) = len(localdims), max(localdims), (Iset.shape[1],
                                                            Iset.device)
    B, R = L - 1, Imax * dmax
    bidx = torch.arange(B, device=dev)
    pos = torch.arange(L, device=dev)
    dims = lay.dims[:B]
    # Π₁ rows: kron(Iset[b], dmax) with the site index at position b, the
    # valid ones first; P rows: Iset[b+1]
    s = torch.arange(dmax, device=dev)
    kron = torch.where((pos == bidx[:, None])[:, None, None, :],
                       s[None, None, :, None],
                       Iset[:B, :, None, :]).reshape(B, R, L)
    rid = torch.arange(R, device=dev)
    orderI, mIs = _compact(((rid // dmax) < Ilen[:B, None])
                           & ((rid % dmax) < dims[:, None]))
    Ic = torch.gather(kron, 1, orderI[:, :, None].expand(B, R, L))
    rows = torch.cat([Ic, Iset[1:]], dim=1)
    # columns: Jset[b] rolled right by the prefix length b + 1
    shift = (pos[None, :] - bidx[:, None] - 1) % L
    Jsh = torch.gather(Jset[:B], 2, shift[:, None, :].expand(B, Imax, L))
    prefix = (pos[None, :] <= bidx[:, None])[:, None, None, :]

    def block(a: int, b: int) -> torch.Tensor:
        """The index matrix of the panels' rows a:b, (B (b - a) Imax, L)."""
        return torch.where(prefix, rows[:, a:b, None, :],
                           Jsh[:, None, :, :]).reshape(-1, L)

    # the last site: T = Π₁ reshaped (Jset[L-1] = [()])
    last, d_l = L - 1, localdims[L - 1]
    Is = _kron_is(Iset[last], last, d_l)
    n = R + Imax
    step = chunk_rows(n, B * Imax * L * 8)
    if lay.cut:
        # per bond, the Π₁ rows (distinct prefixes, the valid ones first),
        # the P rows (Iset[b+1]) and the columns (Jset[b]) that can be
        # distinct; the rest of each panel is masked below
        panels = torch.zeros((B, n, Imax), dtype=dtype, device=dev)
        for b in range(B):
            cj = lay.edge(lay.suffixes(L - b - 1), Imax)
            for a, full in ((0, R), (R, Imax)):
                ri = lay.edge(lay.prefixes(b + 1), full)
                panels[b, a:a + ri, :cj] = sample_panel(
                    f, rows[b, a:a + ri, :b + 1], Jset[b, :cj, :L - b - 1],
                    dtype)
        vals_last = indexed(f, Is).to(dtype)
    elif step == n:
        vals = indexed(f, torch.cat([block(0, n), Is])).to(dtype)
        panels = vals[:B * n * Imax].reshape(B, n, Imax)
        vals_last = vals[B * n * Imax:]
    else:
        panels = torch.cat([indexed(f, block(a, a + step)).to(dtype).reshape(
            B, -1, Imax) for a in range(0, n, step)], dim=1)
        vals_last = indexed(f, Is).to(dtype)

    Pi1 = torch.where(_valid((R, Imax), mIs, Jlen[:B], dev), panels[:, :R], 0)
    maxsample = Pi1.abs().amax()
    P = torch.where(_valid((Imax, Imax), Ilen[1:], Jlen[:B], dev),
                    panels[:, R:], torch.eye(Imax, dtype=dtype, device=dev))
    T = panel_solve_pinv(Pi1, P, Ilen[1:])
    tensors = torch.zeros((L, Imax, dmax, Imax), dtype=dtype, device=dev)
    tensors[:B] = torch.zeros_like(T).scatter_(
        1, orderI[:, :, None].expand(B, R, Imax), T).reshape(B, Imax, dmax,
                                                             Imax)
    ok = ((torch.arange(Imax * d_l, device=dev) < Ilen[last] * d_l)
          & (Jlen[last] > 0))
    vlast = torch.where(ok, vals_last, 0)
    maxsample = torch.maximum(maxsample, vlast.abs().amax())
    tensors[last, :, :d_l, 0] = vlast.reshape(Imax, d_l)
    return tensors, maxsample


def _sweep1(f, localdims, dtype, lay, Iset, Ilen, Jset, Jlen, forward: bool,
            reltol, abstol, maxbond):
    """One 1-site sweep (tensorci2.jl:659-725; ``_make_sweep1site_scan``);
    `reltol`, `abstol` and `maxbond` on the device as for ``_sweep``.
    Updates the index buffers in place; returns (tensors (L, Imax, dmax,
    Imax), pivot errors (L-1, Imax+1), max |sample|), on the device."""
    L, dmax, (Imax, dev) = len(localdims), max(localdims), (Iset.shape[1],
                                                            Iset.device)
    tensors = torch.zeros((L, Imax, dmax, Imax), dtype=dtype, device=dev)
    perrs = torch.zeros((L - 1, Imax + 1), dtype=torch.float64, device=dev)
    maxsample = torch.zeros((), dtype=dtype.to_real(), device=dev)
    R = Imax * dmax
    for b in (range(L - 1) if forward else range(L - 1, 0, -1)):
        # the kron side's valid rows first, in a stable order: on the I
        # side of the layout's bond b going forward, on the J side of its
        # bond b - 1 (kron(d_b, Jset[b])) going backward
        side, lb = (0, b) if forward else (1, b - 1)
        lens = Ilen[b] if forward else Jlen[b]
        invalid = (lay.row[side, :R] >= lens) | lay.pad[lb, side, :R]
        order = torch.argsort(invalid.to(torch.uint8), stable=True)
        m = (~invalid).sum(dtype=torch.int32)
        if forward:
            Is = Iset[b][lay.row[0, :R]]
            Is[:, b] = lay.site[0]
            Is, mIs = Is[order], m
            Js, mJs = Jset[b], Jlen[b]
            Pi = _panel(f, Is, Js, b + 1, L - b - 1, mIs, mJs, dtype, lay)
        else:
            Js = torch.roll(Jset[b], 1, 1)[lay.row[1, :R]]
            Js[:, 0] = lay.site[1]
            Js, mJs = Js[order], m
            Is, mIs = Iset[b], Ilen[b]
            Pi = _panel(f, Is, Js, b, L - b, mIs, mJs, dtype, lay)
        maxsample = torch.maximum(maxsample, Pi.abs().amax())
        mn = torch.minimum(mIs, mJs)
        maxrank = torch.minimum(mn, maxbond)
        A, rowperm, colperm, k, mags, err = _rrlu(
            Pi, mIs[None], mJs[None], maxrank[None], reltol, abstol, forward)
        left, right = ci_factors(A, rowperm, colperm, k, forward)
        err_final = torch.where(k >= mn, 0.0, err)
        if forward:
            T = torch.zeros((Imax * dmax, Imax), dtype=dtype, device=dev)
            tensors[b] = T.index_copy_(0, order, left[:, :Imax]).reshape(
                Imax, dmax, Imax)
            sets = (b + 1, b, b)
        else:
            T = torch.zeros((Imax, dmax * Imax), dtype=dtype, device=dev)
            tensors[b] = T.index_copy_(1, order, right[:Imax]).reshape(
                Imax, dmax, Imax)
            sets = (b, b - 1, b - 1)
        _bond_writeback(lay, Iset, Ilen, Jset, Jlen, perrs, *sets, Is, Js,
                        rowperm, colperm, k, mags, err_final)

    # the boundary tensor of the sweep's last site
    last = L - 1 if forward else 0
    d_l = localdims[last]
    Pi1 = _panel(f, _kron_is(Iset[last], last, d_l), Jset[last], last + 1,
                 L - last - 1, Ilen[last] * d_l, Jlen[last], dtype, lay)
    maxsample = torch.maximum(maxsample, Pi1.abs().amax())
    tensors[last, :, :d_l, :] = Pi1[:, :Imax].reshape(Imax, d_l, Imax)
    return tensors, perrs, maxsample


def _iteration(f, localdims, dtype, lay, p, eIlen, eJlen, abstol, fwd1: bool,
               fwd2: bool, seeds=None):
    """An optimize iteration's two 2-site sweeps and the fill on program p's
    record (``_get_sweep_pair``'s body): sweep `fwd1` with the history sets
    (lengths `eIlen`, `eJlen`) as extras, then sweep `fwd2` with the
    iteration's input sets as extras (times ``p.use_extra2``, 0 under
    strict nesting), then the fill. The sweeps update copies of the
    record's sets: the second sweep and the history read the inputs.
    Returns (the sets after both sweeps and after the first, each (Iset,
    Ilen, Jset, Jlen); the second sweep's pivot errors; the max |sample| of
    both sweeps and the fill; the site tensors; the slab samples of both
    sweeps), on the device. With `seeds` (two 0-d int64 tensors) both
    sweeps run by rook pivoting, each from its seed; the samples are then
    a 0-d tensor, else None."""
    I, Il, J, Jl = (t.clone() for t in (p.Iset, p.Ilen, p.Jset, p.Jlen))

    def sweep(fwd, eI, eIl, eJ, eJl, k):
        if seeds is None:
            return (*_sweep(f, localdims, dtype, lay, I, Il, J, Jl, eI, eIl,
                            eJ, eJl, fwd, p.reltol, abstol, p.maxbond), None)
        return _sweep_rook(f, localdims, dtype, lay, I, Il, J, Jl, eI, eIl,
                           eJ, eJl, fwd, p.reltol, abstol, p.maxbond,
                           seeds[k])

    _, ms1, nev1 = sweep(fwd1, p.eI, eIlen, p.eJ, eJlen, 0)
    mid = tuple(t.clone() for t in (I, Il, J, Jl))
    perrs, ms2, nev2 = sweep(fwd2, p.Iset, p.Ilen * p.use_extra2, p.Jset,
                             p.Jlen * p.use_extra2, 1)
    tensors, fill_max = _fill(f, localdims, dtype, lay, I, Il, J, Jl)
    nev = None if seeds is None else nev1 + nev2
    return ((I, Il, J, Jl), mid, perrs,
            torch.stack([ms1, ms2, fill_max]).amax(), tensors, nev)


def _tt_search_on_cores(f, dtype, lay, cores, Ilen, Jlen, starts):
    """The global-pivot candidate search against a fill's padded cores
    (``tci_tpu``'s ``_tt_search_on_cores``, globalpivotfinder.jl:217-252),
    on the device with no read-back, so that a graph can hold it.

    |f - tt| on every single-coordinate variant of each of the S start
    points (`starts` (S, L)): the variant of leg p takes every value below
    dmax, clamped to d_p - 1, and the clamped duplicates are masked to -inf.
    f is sampled once on all S L dmax rows; the tt is L batched products of
    (N, 1, Imax) by (N, Imax, Imax), the site's core gathered at each row's
    local index (the reference's one-hot contraction was a TPU workaround
    against slow gathers). Rows of a core past |Iset[b]| meet zeros of the
    carried vector, which is cut to the true right bond length after every
    site. With a ``cut`` layout (capacities above QUANTUM_CAP, where a
    gathered core is Imax² values a row) each site is instead dmax products
    of all the rows with one value's slice of the core, each kept where the
    row takes that value. Returns, per start, the first maximum in (leg,
    value) order: (best_flat (S,) = leg dmax + value, best_err (S,)
    float64)."""
    L, Imax, dmax, _ = cores.shape
    dev = cores.device
    S = starts.shape[0]
    vgrid = torch.arange(dmax, device=dev)
    vclamped = torch.minimum(vgrid[None, :], lay.dims[:, None] - 1)
    legsel = torch.eye(L, dtype=torch.bool, device=dev)[None, :, None, :]
    rows = torch.where(legsel, vclamped[None, :, :, None],
                       starts[:, None, None, :]).reshape(S * L * dmax, L)
    fv = indexed(f, rows).to(dtype)
    v = torch.zeros((rows.shape[0], 1, Imax), dtype=dtype, device=dev)
    v[:, 0, 0] = 1
    lens_r = torch.cat([Ilen[1:], Jlen[-1:]])
    col = torch.arange(Imax, device=dev)
    by_value = cores.permute(0, 2, 1, 3)
    for b in range(L):
        if lay.cut:
            v = v[:, 0]
            out = torch.zeros_like(v)
            for s in range(dmax):
                out = torch.where((rows[:, b] == s)[:, None],
                                  v @ by_value[b, s], out)
            v = out[:, None]
        else:
            v = torch.bmm(v, by_value[b][rows[:, b]])
        v = torch.where(col < lens_r[b], v, 0)
    err = (fv - v[:, 0, 0]).abs().to(torch.float64).reshape(S, L, dmax)
    valid = vgrid[None, None, :] < lay.dims[None, :, None]
    flat = torch.where(valid, err, float("-inf")).reshape(S, L * dmax)
    best = flat.argmax(1)
    return best, flat.gather(1, best[:, None])[:, 0]


def _fzone_abs_err(f, dtype, cores, rows) -> torch.Tensor:
    """|f - tt| (float64) at the (N, L) `rows`, the TT through
    ``tt_evaluate_batched`` on the floating-zone program's padded `cores`,
    as in the host lock-step search, so that both round alike."""
    fv = indexed(f, rows).to(dtype)
    return (fv - tt_evaluate_batched(cores.to(dtype), rows)).abs().to(
        torch.float64)


def _fzone_sweep(f, localdims, dtype, p) -> None:
    """One sweep of the floating-zone search (``tci_tpu``'s
    ``_make_floatingzone`` while-loop body, globalsearch.jl:119-186) for all
    S starts in lock-step, on program p's record: ``pivots`` (S, L),
    ``maxerr`` (S,), ``active`` (S,), ``k``, ``nactive`` and the
    zero-padded cores ``cores`` (L, chi, dmax, chi) (a field of the
    engine's dtype).

    Leg by leg, every start's dmax single-coordinate variants (values past
    d_leg clamped to d_leg - 1, their errors masked to -inf) go through f
    in one call and through the TT as L batched products of the cores
    gathered at each row's local index, as ``_tt_search_on_cores`` does;
    an active start takes the first maximum as its new coordinate and folds
    it into its running max. Then a start freezes when the sweep left its
    max unchanged or pushed it past ``earlystoptol``. Writes the state back
    into the record; reads no device value."""
    L, _, dmax, _ = p.cores.shape
    S = p.pivots.shape[0]
    vgrid = torch.arange(dmax, device=p.cores.device)
    pivots = p.pivots.clone()
    active = p.active > 0
    maxerr = prev = p.maxerr
    for ipos, d in enumerate(localdims):
        cand = pivots[:, None, :].repeat(1, dmax, 1)
        cand[:, :, ipos] = vgrid.clamp(max=d - 1)
        err = _fzone_abs_err(f, dtype, p.cores, cand.reshape(S * dmax, L))
        err = torch.where(vgrid < d, err.reshape(S, dmax), float("-inf"))
        best = err.argmax(1)
        pivots[:, ipos] = torch.where(active, best, pivots[:, ipos])
        maxerr = torch.where(active, torch.maximum(maxerr, err.amax(1)),
                             maxerr)
    active = active & ~((maxerr == prev) | (maxerr > p.earlystoptol))
    p.pivots.copy_(pivots)
    p.maxerr.copy_(maxerr)
    p.active.copy_(active)
    p.k.add_(1)
    p.nactive.copy_(active.sum())


def _nan_sites(tensors, Ilen, Jlen, dims) -> torch.Tensor:
    """(L,) flags: NaN in the true block of site tensor b; `dims` are the
    local dimensions on the device."""
    L, Imax, dmax, _ = tensors.shape
    dev = tensors.device
    ar = torch.arange(Imax, device=dev)
    ncols = torch.cat([Ilen[1:], Jlen[-1:]])
    valid = ((ar[None, :, None, None] < Ilen[:, None, None, None])
             & (torch.arange(dmax, device=dev)[None, None, :, None]
                < dims[:, None, None, None])
             & (ar[None, None, None, :] < ncols[:, None, None, None]))
    return (torch.isnan(tensors) & valid).flatten(1).any(1)


def _packed(*tensors):
    """The tensors as one float64 record (integers up to 2^53 are exact),
    built on the device so that a sweep ends in one fetch, and their
    shapes."""
    return (torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]),
            [tuple(t.shape) for t in tensors])


def _unpacked(rec: np.ndarray, shapes) -> List[np.ndarray]:
    """The arrays of a fetched ``_packed`` record."""
    out, o = [], 0
    for shape in shapes:
        n = int(np.prod(shape, dtype=np.int64))
        out.append(rec[o:o + n].reshape(shape))
        o += n
    return out


def _pack_into(buf: np.ndarray, lens: np.ndarray,
               sets: List[List[MultiIndex]]) -> None:
    """Pack ragged index-set lists into an (L, Imax, L) buffer (each
    multi-index stored left-aligned in row[:len]) and (L,) lengths. The
    multi-indices of one set have one length."""
    buf[...] = 0
    for b, s in enumerate(sets):
        lens[b] = len(s)
        if len(s) and len(s[0]):
            buf[b, :len(s), :len(s[0])] = np.asarray(s, dtype=np.int64)


class _Program:
    """One body of the engine at one capacity, as ``tci_tpu`` keeps a jitted
    program: the body, the input record it reads, and, once captured, its
    CUDA graph.

    The input record is one int64 device array that the program owns: the
    `sets` groups of index buffers and lengths (0: none; 1: ``Iset``,
    ``Ilen``, ``Jset``, ``Jlen``; 2: those and a 2-site sweep's history
    sets ``eI``, ``eIlen``, ``eJ``, ``eJlen``), then ``reltol`` and
    ``abstol`` (float64 bits, (1,) views), ``maxbond``, and the program's
    own `fields` ((name, shape, kind) each: "i" for int64, "f" for float64,
    one slot an element; "c" for complex128, two slots an element, the real
    part first, viewed as complex).
    A program whose host loop reads a status between runs names it as
    `status` (the first field and the count of int64 fields that follow
    it from there), and ``read_status`` reads them. ``load`` writes a
    call's values into a pinned staging array and copies it over in one
    transfer; the body reads
    only views of the record, so a graph recorded once follows every later
    call's values. A body may also write the record: the optimize loop's
    step keeps its carried state there.

    ``run`` captures the body at the key's ``engine.capture_at``-th use
    when the engine captures at all (``engine.cuda_graphs``), replays the
    graph from then on, and otherwise calls the body. A body returns
    (record, shapes, *device tensors): ``_packed`` results for the one
    fetch, and what stays on the device. Under a graph these are static
    tensors that the next replay overwrites, so ``run`` hands out copies of
    the device tensors; the record is copied by the fetch."""

    def __init__(self, engine: "DeviceSweepEngine", key, sets: int, body,
                 rrlu_launches: int, fields=(), status=None):
        # the engine owns its programs; a reference back that counted would
        # keep an engine that is dropped, and its graphs' memory, until
        # the garbage collector finds the cycle
        self.engine, self.key, self.body = weakref.proxy(engine), key, body
        # rrLU launches one run of the body makes, by the engine's count
        self.rrlu_launches = rrlu_launches
        L, Imax, dev = len(engine.localdims), engine.Imax, engine.device
        sets = [("Iset", (L, Imax, L)), ("Ilen", (L,)),
                ("Jset", (L, Imax, L)), ("Jlen", (L,)),
                ("eI", (L, Imax, L)), ("eIlen", (L,)),
                ("eJ", (L, Imax, L)), ("eJlen", (L,))][:4 * sets]
        layout = ([(name, shape, "i") for name, shape in sets]
                  + [("reltol", (1,), "f"), ("abstol", (1,), "f"),
                     ("maxbond", (), "i"), *fields])
        # int64 slots an element; a complex field starts at an even slot,
        # so that its view is 16-byte aligned
        slots = {"i": 1, "f": 1, "c": 2}
        offsets, o = [], 0
        for _, shape, kind in layout:
            o += o % slots[kind]
            offsets.append(o)
            o += int(np.prod(shape)) * slots[kind]
        self._stage = torch.zeros(o, dtype=torch.int64,
                                  pin_memory=dev.type == "cuda")
        self._record = torch.zeros(o, dtype=torch.int64, device=dev)
        host = self._stage.numpy()
        # host staging view and record offset of every field, by name
        self._host, self._offset = {}, {}
        views = {"f": (np.float64, torch.float64),
                 "c": (np.complex128, torch.complex128)}
        for (name, shape, kind), o in zip(layout, offsets):
            size = int(np.prod(shape)) * slots[kind]
            h, d = host[o:o + size], self._record[o:o + size]
            if kind in views:
                h, d = h.view(views[kind][0]), d.view(views[kind][1])
            self._host[name] = h.reshape(shape)
            self._offset[name] = o
            setattr(self, name, d.view(shape))
        self._sets = [name for name, _ in sets]
        if status is not None:
            name, n = status
            self.status = self._record[self._offset[name]:][:n]
            self._status_host = torch.zeros(n, dtype=torch.int64,
                                            pin_memory=dev.type == "cuda")
            self._status_read = (torch.cuda.Event() if dev.type == "cuda"
                                 else None)
        # the last copy out of the staging array, which must have finished
        # before the next call's values are written there
        self._copied = torch.cuda.Event() if dev.type == "cuda" else None
        self._pending = False
        self.uses = 0
        self.replays = 0
        self._replay = None
        self._outputs = None
        # filled at the capture: launches of the rrLU kernel the graph
        # holds, launches and points of the GK panel kernel, the bytes of
        # index matrix it forms for f, and the host time the capture and
        # its instantiation took
        self.captured_launches = 0
        self.captured_gk = Counter()
        self.captured_index_bytes = 0
        self.capture_seconds = None

    def read_status(self) -> list:
        """The status fields of the record, after the work queued before:
        one read through a pinned buffer, counted as ``engine_status``."""
        return peek(self.status, self._status_host, self._status_read,
                    "engine_status")

    @property
    def captured(self) -> bool:
        return self._replay is not None

    def load(self, *sets, reltol: float = 0.0, abstol: float = 0.0,
             maxbonddim: int = 0, **values) -> None:
        """A call's inputs into the record, in one transfer: the index-set
        lists (in the record's order), the tolerances, the rank cap clamped
        to the capacity, and the program's own fields by name (the span
        ``tci.engine.load``)."""
        with span("tci.engine.load"):
            if self._pending:
                with span("tci.wait.engine_stage"):
                    self._copied.synchronize()
            for i, s in enumerate(sets):
                _pack_into(self._host[self._sets[2 * i]],
                           self._host[self._sets[2 * i + 1]], s)
            values.update(reltol=reltol, abstol=abstol,
                          maxbond=min(int(maxbonddim), self.engine.Imax))
            for name, value in values.items():
                self._host[name][...] = value
            self._record.copy_(self._stage, non_blocking=True)
            if self._copied is not None:
                self._copied.record(
                    torch.cuda.current_stream(self._record.device))
                self._pending = True

    def run(self):
        """The body's results on the loaded inputs: replayed from the graph,
        or computed eagerly (the span ``tci.engine.replay`` either way; a
        capture is ``tci.engine.capture``)."""
        eng = self.engine
        self.uses += 1
        if (eng.cuda_graphs and self._replay is None
                and self.key not in eng.declined
                and self.uses >= eng.capture_at):
            before = lu_cuda.CAPTURED["rrlu"]
            before_gk = Counter(gk_panel.CAPTURED)
            before_index = fused.INDEX_BYTES["captured"]
            t0 = time.perf_counter()
            try:
                with span("tci.engine.capture"):
                    self._replay, self._outputs = eng._capture(
                        lambda: self.body(self))
            except Exception as exc:  # anything f or the capture raises
                eng._decline(self.key, exc)
            else:
                self.capture_seconds = time.perf_counter() - t0
                self.captured_launches = lu_cuda.CAPTURED["rrlu"] - before
                self.captured_gk = gk_panel.CAPTURED - before_gk
                self.captured_index_bytes = (fused.INDEX_BYTES["captured"]
                                             - before_index)
                eng.captures += 1
        with span("tci.engine.replay"):
            if not eng.cuda_graphs or self._replay is None:
                return self.body(self)
            self._replay()
            lu_cuda.count_replay(self.captured_launches)
            gk_panel.count_replay(self.captured_gk)
            fused.count_index_replay(self.captured_index_bytes)
            self.replays += 1
            eng.replays += 1
            rec, shapes, *kept = self._outputs
            return (rec, shapes, *(t.clone() for t in kept))


class DeviceSweepEngine:
    """Host wrapper: uploads TCI2 index sets into padded device buffers, runs
    a sweep on the device, and writes the results back after one fetch.
    Grows the buffer capacity when the rank saturates it.

    `f` maps an (N, L) int64 tensor on `device` to (N,) values there.

    On a CUDA device each body (2-site sweep, with and without the fill;
    the fill; the 1-site sweep; the sweep pair; the optimize loop's step)
    is recorded into a CUDA graph at the first
    use of its key (``capture_at``) and replayed from then on
    (``cuda_graphs=False``, or setting the attribute later, runs every body
    eagerly). `f` is recorded with the body, so it has to be a pure function
    of its index tensor, written with torch operations: no ``.item()`` or
    other read of a device value, no shape that depends on the data, and
    the tensors it closes over stay alive and are only updated in place.
    When the capture of a body fails, that key runs eagerly from then on,
    on the same device and through the same kernel; the engine says so once
    on stderr and keeps the reason in ``declined[key]``. ``captures`` and
    ``replays`` count what happened; ``programs()`` describes every key.

    The capacity Imax starts at `imax` and grows as the module's head says,
    up to ``capacity_limit()``: the largest capacity whose panel edge Imax
    (dmax + 1) is at most `max_panel_edge` and whose largest program
    (``program_bytes``) fits in ``MEMORY_SHARE`` of the device's memory
    (the card's total; the host's for the CPU), and at most `imax_cap`
    where that is given. Above it the engine declines and TensorCI2 runs
    the per-bond fused tier."""

    def __init__(self, f: Callable, localdims: Sequence[int], imax: int = 32,
                 imax_cap: Optional[int] = None, dtype=torch.float64,
                 device=None, max_panel_edge: int = 4096,
                 cuda_graphs: bool = True, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            f = shard_rows(f, mesh)
        self.f = f
        self.localdims = tuple(int(d) for d in localdims)
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        self.Imax = imax
        # a fixed limit on the capacity, in place of the memory's (None);
        # beyond the limit TensorCI2 falls back to the per-bond fused tier
        self.imax_cap = imax_cap
        # largest per-bond panel edge Imax * (dmax + 1) the engine takes
        self.max_panel_edge = max_panel_edge
        self._memory = None
        self.nevals = 0
        # rrLU launches this engine made (one a bond, one a fill)
        self.rrlu_calls = 0
        self._layouts = {}
        # the programs, by the keys of tci_tpu's engine: (forward, Imax) a
        # 2-site sweep, (forward, Imax, "fused_full") with the fill,
        # ("fill", Imax), ("sweep1", forward, Imax), (fwd1, fwd2, Imax,
        # "pair_full", nsearch) and ("oloop", fwd1, fwd2, Imax, nsearch,
        # nch, loop_kmax)
        self._sweeps: Dict[tuple, _Program] = {}
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        # the use of a key at which it is recorded. 1, as tci_tpu compiles a
        # sweep when it first runs it: an evaluator that is kept replays
        # from its second call on. (Measured on an H100 with a new evaluator
        # a run: recording at the first use beat the second at 39 bonds a
        # sweep and lost at 9 bonds with a capacity growth; PERF.md.)
        self.capture_at = 1
        self.captures = 0
        self.replays = 0
        # keys whose capture failed, with the reason; they run eagerly
        self.declined: Dict[tuple, str] = {}
        # all graphs of an engine share one memory pool (they never run
        # together) and are captured on one side stream
        self._pool = None
        self._stream = None
        # tci_tpu's protocol, with its names and defaults: both sweeps of an
        # optimize iteration, the fill and the global-pivot search as one
        # program (sweep2site_pair), and blocks of up to loop_kmax such
        # iterations that return to the host only for a global pivot, a
        # capacity growth, convergence or the end of the budget
        # (optimize_loop). False runs the per-sweep programs.
        self.use_sweep_pair = True
        self.use_optimize_loop = True
        self.loop_kmax = 32
        # (best_flat, best_err) of the last pair's search, and whether the
        # last pair or loop block left filled site tensors on the TCI
        self.last_search = None
        self.last_sweep_filled = False
        # optimize_loop calls that ran a block, and the steps they ran
        self.loop_blocks = 0
        self.loop_steps = 0
        # the host generator of the rook sweeps' seeds (one a sweep), as
        # tci_tpu's engine keeps one; set it to repeat a rook run. On a
        # mesh it is seeded from rank 0, so the ranks draw alike
        self._rng = mesh_rng(mesh)

    def _seed(self) -> int:
        """One rook sweep's seed, drawn as tci_tpu's engine draws it."""
        return int(self._rng.integers(0, 2**31 - 1))

    def _layout(self) -> _Layout:
        """The index layout of the current capacity (built at its first
        sweep)."""
        if self.Imax not in self._layouts:
            self._layouts[self.Imax] = _Layout(self.localdims, self.Imax,
                                               self.device)
        return self._layouts[self.Imax]

    def _capture(self, body):
        """Record body() into a CUDA graph of this engine's pool; returns
        (replay, the body's static outputs). What a launch sets up once (the
        kernel's build and load, cuBLAS's handle for the triangular solves
        and the search's products) happens before, outside the capture."""
        dev = self.device
        lu_cuda.warm_up(dev.index, self.dtype)
        eye = torch.eye(2, dtype=self.dtype, device=dev)
        torch.linalg.solve_triangular(eye, eye, upper=True)
        torch.bmm(eye[None], eye[None])
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        captured = lu_cuda.CAPTURED["rrlu"]
        captured_gk = Counter(gk_panel.CAPTURED)
        captured_index = fused.INDEX_BYTES["captured"]
        try:
            graph, outputs = capture_graph(body, self._pool, self._stream)
        except torch.OutOfMemoryError:
            # The memory may sit in the cached segments of graphs that are
            # gone (an engine that was dropped leaves its pool's segments
            # cached), which the allocator cannot give back while a stream
            # captures: give them back now and record once more, into a new
            # pool. The failed capture's launches never ran.
            lu_cuda.CAPTURED["rrlu"] = captured
            gk_panel.CAPTURED.clear()
            gk_panel.CAPTURED.update(captured_gk)
            fused.INDEX_BYTES["captured"] = captured_index
            torch.cuda.empty_cache()
            self._pool = torch.cuda.graph_pool_handle()
            graph, outputs = capture_graph(body, self._pool, self._stream)
        return graph.replay, outputs

    def _decline(self, key, exc: BaseException) -> None:
        """Note that `key` could not be captured; say so at the first."""
        if not self.declined:
            print(f"tci_tpu_torch: the whole-sweep engine could not record "
                  f"program {key} into a CUDA graph and runs it eagerly on "
                  f"{self.device} instead ({type(exc).__name__}: {exc}); see "
                  f"DeviceSweepEngine.declined", file=sys.stderr, flush=True)
        self.declined[key] = f"{type(exc).__name__}: {exc}"
        # a capture that CUDA invalidated can leave the allocator recording
        # into the pool; later captures of this engine start a new one
        self._pool = None

    def programs(self) -> List[dict]:
        """One entry per program key: whether it is a graph, how often it
        was used and replayed, the rrLU launches its graph holds and the
        host time of its capture."""
        return [{"key": key, "captured": p.captured, "uses": p.uses,
                 "replays": p.replays, "declined": self.declined.get(key),
                 "captured_launches": p.captured_launches,
                 "capture_seconds": p.capture_seconds}
                for key, p in self._sweeps.items()]

    def graph_pool_bytes(self):
        """Device memory the graphs' pool holds, from the allocator's
        snapshot; None before the first capture."""
        if self._pool is None:
            return None
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))

    def capacity_limit(self) -> int:
        """The largest capacity the engine takes: the largest step of its
        ladder (powers of two to 32, then multiples of 32) whose panel edge
        Imax (dmax + 1) is at most ``max_panel_edge`` and whose largest
        program (``program_bytes``) fits in ``MEMORY_SHARE`` of the
        device's memory; at most ``imax_cap`` where that is set."""
        if self._memory is None:
            self._memory = _device_memory(self.device)
        dmax = max(self.localdims)
        item = torch.empty((), dtype=self.dtype).element_size()
        cap = self.max_panel_edge // (dmax + 1)
        cap = 32 * (cap // 32) if cap >= 32 else 1 << (cap.bit_length() - 1)
        while cap > 1 and (program_bytes(self.localdims, cap, item)
                           > MEMORY_SHARE * self._memory):
            cap = cap - 32 if cap > 32 else cap // 2
        return cap if self.imax_cap is None else min(cap, self.imax_cap)

    def _reserve(self, needed: int) -> bool:
        """Set the capacity for sets of up to `needed` entries; False when
        that exceeds ``capacity_limit()``."""
        limit = self.capacity_limit()
        if needed > limit:
            return False
        self.Imax = _imax_target(self.Imax, needed)
        return True

    def _grow(self, maxbonddim: Optional[int] = None) -> bool:
        """Raise the capacity one step after a saturated sweep: tci_tpu's
        quantum below ``QUANTUM_CAP``; from there twice the capacity, but
        no more than a rank cap of `maxbonddim` needs, and the limit where
        twice would pass it. False at the limit."""
        limit = self.capacity_limit()
        if self.Imax < QUANTUM_CAP:
            nxt = _imax_target(self.Imax, self.Imax + 1)
        else:
            nxt = 2 * self.Imax
            if maxbonddim is not None and maxbonddim > self.Imax:
                nxt = min(nxt, _imax_target(self.Imax, maxbonddim))
            if nxt > limit > self.Imax:
                nxt = limit
        if nxt > limit:
            return False
        self.Imax = nxt
        return True

    def _get_sweep(self, forward: bool, fill: bool, rook: bool = False
                   ) -> _Program:
        """The 2-site sweep at the current capacity; with `fill`, the sweep
        and the site-tensor fill on the same device state as one program
        (``_get_sweep_fused``); with `rook`, by rook pivoting from the seed
        in the record (``_get_sweep_rook``), whose record carries the
        sweep's slab samples after the max |sample|."""
        kind = ("fused_rook" if rook else "fused_full") if fill else (
            "rook" if rook else None)
        key = (forward, self.Imax) + ((kind,) if kind else ())
        if key not in self._sweeps:
            f, dims, dtype, lay = (self.f, self.localdims, self.dtype,
                                   self._layout())

            def body(p):
                args = (f, dims, dtype, lay, p.Iset, p.Ilen, p.Jset, p.Jlen,
                        p.eI, p.eIlen, p.eJ, p.eJlen, forward, p.reltol,
                        p.abstol, p.maxbond)
                if rook:
                    perrs, maxsample, nev = _sweep_rook(*args, p.seed)
                    nev = (nev,)
                else:
                    (perrs, maxsample), nev = _sweep(*args), ()
                kept = ()
                if fill:
                    tensors, fill_max = _fill(f, dims, dtype, lay, p.Iset,
                                              p.Ilen, p.Jset, p.Jlen)
                    maxsample = torch.maximum(maxsample, fill_max)
                    kept = (tensors,)
                return (*_packed(p.Iset, p.Ilen, p.Jset, p.Jlen, perrs,
                                 maxsample, *nev), *kept)

            launches = (len(dims) - 1) * (ROOK_STEPS if rook else 1)
            self._sweeps[key] = _Program(
                self, key, 2, body, launches + int(fill),
                [("seed", (), "i")] if rook else ())
        return self._sweeps[key]

    def _get_fill(self) -> _Program:
        key = ("fill", self.Imax)
        if key not in self._sweeps:
            f, dims, dtype, lay = (self.f, self.localdims, self.dtype,
                                   self._layout())

            def body(p):
                return (None, None, *_fill(f, dims, dtype, lay, p.Iset,
                                           p.Ilen, p.Jset, p.Jlen))

            self._sweeps[key] = _Program(self, key, 1, body, 1)
        return self._sweeps[key]

    def _get_sweep1(self, forward: bool) -> _Program:
        key = ("sweep1", forward, self.Imax)
        if key not in self._sweeps:
            f, dims, dtype, lay = (self.f, self.localdims, self.dtype,
                                   self._layout())

            def body(p):
                tensors, perrs, maxsample = _sweep1(
                    f, dims, dtype, lay, p.Iset, p.Ilen, p.Jset, p.Jlen,
                    forward, p.reltol, p.abstol, p.maxbond)
                nan = _nan_sites(tensors, p.Ilen, p.Jlen, lay.dims)
                return (*_packed(p.Iset, p.Ilen, p.Jset, p.Jlen, perrs,
                                 maxsample, nan), tensors)

            self._sweeps[key] = _Program(self, key, 1, body,
                                         len(dims) - 1)
        return self._sweeps[key]

    def _get_sweep_pair(self, fwd1: bool, fwd2: bool, nsearch: int,
                        rook: bool = False) -> _Program:
        """One optimize iteration as one program (``_get_sweep_pair``):
        ``_iteration``, and with nsearch > 0 the candidate search from the
        (nsearch, L) ``starts`` against the filled cores. With `rook` both
        sweeps run by rook pivoting from the record's ``seed1`` and
        ``seed2``, and the record carries their slab samples last."""
        key = (fwd1, fwd2, self.Imax, "pair_rook" if rook else "pair_full",
               nsearch)
        if key not in self._sweeps:
            f, dims, dtype, lay = (self.f, self.localdims, self.dtype,
                                   self._layout())
            fields = [("use_extra2", (), "i")]
            if rook:
                fields += [("seed1", (), "i"), ("seed2", (), "i")]
            if nsearch:
                fields.append(("starts", (nsearch, len(dims)), "i"))

            def body(p):
                sets, mid, perrs, maxsample, tensors, nev = _iteration(
                    f, dims, dtype, lay, p, p.eIlen, p.eJlen, p.abstol, fwd1,
                    fwd2, (p.seed1, p.seed2) if rook else None)
                search = (_tt_search_on_cores(f, dtype, lay, tensors,
                                              sets[1], sets[3], p.starts)
                          if nsearch else ())
                return (*_packed(*sets, perrs, maxsample, *mid, *search,
                                 *((nev,) if rook else ())), tensors)

            launches = 2 * (len(dims) - 1) * (ROOK_STEPS if rook else 1)
            self._sweeps[key] = _Program(self, key, 2, body, launches + 1,
                                         fields)
        return self._sweeps[key]

    def _get_optimize_loop(self, fwd1: bool, fwd2: bool, nsearch: int,
                           nch: int, rook: bool = False) -> _Program:
        """One step of the optimize loop (``_get_optimize_loop``'s
        while-loop body, full pivoting) as one program: ``_iteration`` and
        the search (at ``starts[k]``), then the convergence windows of
        tensorci2.jl:947-966 over the last `nch` iterations (the
        global-pivot column from ``ngp_ok``, since iterations inside a block
        add none) and the step's outputs at position k. A CUDA graph holds
        no loop, so the host replays this step and reads ``status`` (k,
        done, code) after each.

        The carried state lives in the record: the sets (``Iset`` ...), the
        history sets (``eI`` ..., the last mid-point), ``ms``, ``abstol``,
        the windows ``werr`` / ``wrank`` / ``count`` and the status; the
        per-iteration outputs and the last committed pivot errors, cores
        and search result in the program's buffers ``out``, which need no
        upload. A step that saturates the capacity commits nothing and does
        not advance k (code 2); otherwise code 1 means a start's best
        candidate passed abstol * tolmargin, 0 convergence, and 3, the
        initial value, that the budget ran out. With `rook` the sweeps run
        by rook pivoting, step k from the seeds ``seeds[k]`` (two a step,
        drawn on the host), and the record's ``nev`` carries the slab
        samples of the committed steps."""
        Kmax = self.loop_kmax
        key = ("oloop", fwd1, fwd2, self.Imax, nsearch, nch, Kmax) + (
            ("rook",) if rook else ())
        if key not in self._sweeps:
            f, dims, dtype, lay, Imax, dev = (
                self.f, self.localdims, self.dtype, self._layout(),
                self.Imax, self.device)
            L, dmax, S = len(dims), max(dims), max(nsearch, 1)
            fields = [("use_extra2", (), "i"), ("maxbond_full", (), "i"),
                      ("use_norm", (), "i"), ("check_ngp", (), "i"),
                      ("count", (), "i"), ("starts", (Kmax, S, L), "i"),
                      ("ngp_ok", (nch,), "i"), ("wrank", (nch,), "i"),
                      ("tol", (1,), "f"), ("tolmargin", (1,), "f"),
                      ("ms", (1,), "f"), ("werr", (nch,), "f"),
                      ("seeds", (Kmax, 2), "i"), ("nev", (1,), "f"),
                      ("k", (), "i"), ("done", (), "i"), ("code", (), "i")]
            f64, i64 = torch.float64, torch.int64
            out = {"oerr": torch.zeros(Kmax, dtype=f64, device=dev),
                   "orank": torch.zeros(Kmax, dtype=i64, device=dev),
                   "hI": torch.zeros((Kmax, 2, L, Imax, L), dtype=i64,
                                     device=dev),
                   "hIl": torch.zeros((Kmax, 2, L), dtype=i64, device=dev),
                   "hJ": torch.zeros((Kmax, 2, L, Imax, L), dtype=i64,
                                     device=dev),
                   "hJl": torch.zeros((Kmax, 2, L), dtype=i64, device=dev),
                   "perrs": torch.zeros((L - 1, Imax + 1), dtype=f64,
                                        device=dev),
                   "cores": torch.zeros((L, Imax, dmax, Imax), dtype=dtype,
                                        device=dev),
                   "bflat": torch.zeros(S, dtype=i64, device=dev),
                   "berr": torch.full((S,), float("-inf"), dtype=f64,
                                      device=dev)}

            def body(p):
                o = p.out
                abstol = p.tol * torch.where(p.use_norm > 0, p.ms, 1.0)
                k1 = p.k.view(1)
                seeds = (tuple(p.seeds.index_select(0, k1)[0])
                         if rook else None)
                ((I, Il, J, Jl), (I1, Il1, J1, Jl1), perrs, maxsample, cores,
                 nev) = _iteration(f, dims, dtype, lay, p,
                                   p.eIlen * p.use_extra2,
                                   p.eJlen * p.use_extra2, abstol, fwd1,
                                   fwd2, seeds)
                ms = torch.maximum(p.ms, maxsample.to(f64))
                # the iteration's error (the bond errors of the second
                # sweep) and rank, as the host reads them off the sets
                err = perrs.gather(1, Il[1:, None]).amax()
                rank = Il[1:].amax()
                sat = ((torch.maximum(Il.amax(), Il1.amax()) >= Imax)
                       & (p.maxbond_full > Imax))
                if nsearch:
                    bflat, berr = _tt_search_on_cores(
                        f, dtype, lay, cores, Il, Jl,
                        p.starts.index_select(0, k1)[0])
                    found = (berr > abstol * p.tolmargin).any()
                else:
                    bflat, berr = o["bflat"], o["berr"]
                    found = torch.zeros((), dtype=torch.bool, device=dev)
                werr = torch.cat([p.werr[1:], err.view(1)])
                wrank = torch.cat([p.wrank[1:], rank.view(1)])
                count = p.count + 1
                full = count >= nch
                ngp_ok = p.ngp_ok.gather(0, p.k.clamp(max=nch - 1).view(1))
                conv = ((full & (werr < abstol).all()
                         & ((p.check_ngp == 0) | (ngp_ok[0] > 0))
                         & (wrank.amin() == wrank[-1]))
                        | (full & (wrank >= p.maxbond_full).all()))
                done = sat | found | conv
                code = torch.where(sat, 2, torch.where(
                    found, 1, torch.where(conv, 0, p.code)))
                # the outputs at position k, read from the inputs before
                # the commit below overwrites them (a saturated step leaves
                # k where it is, so the next step writes there again)
                o["oerr"].index_copy_(0, k1, err.view(1))
                o["orank"].index_copy_(0, k1, rank.view(1))
                for name, (a, b) in (("hI", (p.Iset, I1)),
                                     ("hIl", (p.Ilen, Il1)),
                                     ("hJ", (p.Jset, J1)),
                                     ("hJl", (p.Jlen, Jl1))):
                    o[name].index_copy_(0, k1, torch.stack([a, b])[None])
                for dst, new in ((p.Iset, I), (p.Ilen, Il), (p.Jset, J),
                                 (p.Jlen, Jl), (p.eI, I1), (p.eIlen, Il1),
                                 (p.eJ, J1), (p.eJlen, Jl1), (p.ms, ms),
                                 (p.abstol, abstol), (p.werr, werr),
                                 (p.wrank, wrank), (p.count, count),
                                 (o["perrs"], perrs), (o["cores"], cores),
                                 (o["bflat"], bflat), (o["berr"], berr),
                                 *(((p.nev, p.nev + nev),) if rook else ())):
                    dst.copy_(torch.where(sat, dst, new))
                p.k.add_((~sat).to(i64))
                p.done.copy_(done)
                p.code.copy_(code)
                return None, None

            launches = 2 * (L - 1) * (ROOK_STEPS if rook else 1)
            program = _Program(self, key, 2, body, launches + 1, fields,
                               status=("k", 3))
            program.out = out
            self._sweeps[key] = program
        return self._sweeps[key]

    def _get_floatingzone(self, S: int, chi: int) -> _Program:
        """The floating-zone search's sweep (``_fzone_sweep``) for S starts
        and cores padded to bond dimension chi, as one program whose record
        carries the search's state from one replay to the next."""
        key = ("fzone", S, chi)
        if key not in self._sweeps:
            f, dims, dtype = self.f, self.localdims, self.dtype
            L = len(dims)
            fields = [("pivots", (S, L), "i"), ("active", (S,), "i"),
                      ("k", (), "i"), ("nactive", (), "i"),
                      ("maxerr", (S,), "f"), ("earlystoptol", (1,), "f"),
                      ("cores", (L, chi, max(dims), chi),
                       "c" if dtype.is_complex else "f")]

            def body(p):
                _fzone_sweep(f, dims, dtype, p)
                return None, None

            self._sweeps[key] = _Program(self, key, 0, body, 0, fields,
                                         status=("k", 2))
        return self._sweeps[key]

    def floatingzone(self, sitetensors, starts, nsweeps: int = 10**9,
                     earlystoptol: float = float("inf")):
        """The whole floating-zone search (estimatetrueerror's and
        searchglobalpivots' engine, ``tci_tpu``'s ``floatingzone``) on the
        device, against any tensor train of this engine's local dimensions.

        The ragged (χl, d, χr) cores are zero-padded into an (L, χ_b, dmax,
        χ_b) stack, χ_b = max(8, the next power of two ≥ χ), so that one
        program serves trains of similar rank. A CUDA graph holds no loop:
        the host replays the program's sweep and reads (k, active starts)
        after each, until no start is active or k reaches `nsweeps`, then
        fetches the result once. Returns (pivots (S, L) int64, maxerr (S,)
        float64) as numpy, or None where ``tci_tpu``'s engine declines (the
        caller then runs the host lock-step search): a train of another
        length or other local dimensions, a complex train on a real engine,
        no start or no sweep. A complex engine keeps the cores in a complex
        field of the record."""
        L = len(self.localdims)
        if len(sitetensors) != L:
            return None
        for b, t in enumerate(sitetensors):
            if t.dim() != 3 or t.shape[1] != self.localdims[b]:
                return None
            if t.is_complex() and not self.dtype.is_complex:
                return None
        S = int(len(starts))
        if S == 0 or nsweeps < 1:
            return None
        program = self._get_floatingzone(S, chi_bucket(max_bond(sitetensors)))
        program.load(pivots=np.asarray(starts, dtype=np.int64), active=1,
                     k=0, nactive=S, maxerr=0.0, earlystoptol=earlystoptol)
        # the cores go from the train's device into the record's field (left
        # at zero by the upload), after the upload in stream order; then the
        # errors at the starts, once, eagerly: every sweep starts from maxerr
        for b, t in enumerate(sitetensors):
            program.cores[b, :t.shape[0], :t.shape[1], :t.shape[2]] = t
        program.maxerr.copy_(_fzone_abs_err(self.f, self.dtype,
                                            program.cores, program.pivots))
        while True:
            self._run(program)
            k, nactive = program.read_status()
            if nactive == 0 or k >= nsweeps:
                break
        with span("tci.engine.pack"):
            rec, shapes = _packed(program.pivots, program.maxerr)
        host = fetch(rec, "engine")
        with span("tci.engine.unpack"):
            pivots, maxerr = _unpacked(host, shapes)
        self.nevals += S + k * S * L * max(self.localdims)
        return pivots.astype(np.int64), maxerr

    def _run(self, program: _Program):
        """Run a loaded program: (the fetched record's arrays or None, the
        tensors that stay on the device)."""
        rec, shapes, *kept = program.run()
        self.rrlu_calls += program.rrlu_launches
        if rec is None:
            return None, kept
        host = fetch(rec, "engine")
        with span("tci.engine.unpack"):
            return _unpacked(host, shapes), kept

    def _unpack(self, buf: np.ndarray, lens: np.ndarray,
                lengths_per_site: List[int]) -> List[List[MultiIndex]]:
        return [[tuple(r) for r in buf[b, :int(lens[b]), :ll].astype(
                    np.int64).tolist()]
                for b, ll in enumerate(lengths_per_site)]

    def _store_sitetensors(self, tci, tensors: torch.Tensor) -> None:
        """The true (|I_b|, d_b, |I_{b+1}|) block of each site tensor into
        tci._sitetensors; they stay on the device, as views of `tensors`,
        which is the engine's no longer."""
        L = len(self.localdims)
        for b in range(L):
            d_b = self.localdims[b]
            ncols = len(tci.Iset[b + 1]) if b < L - 1 else len(tci.Jset[b])
            tci._sitetensors[b] = to_device(
                tensors[b, :len(tci.Iset[b]), :d_b, :ncols], tci.device)

    def _count_fill(self) -> None:
        lay, Imax, L = self._layout(), self.Imax, len(self.localdims)
        if lay.cut:
            R = Imax * max(self.localdims)
            self.nevals += Imax * self.localdims[-1] + sum(
                (lay.edge(lay.prefixes(b + 1), R)
                 + lay.edge(lay.prefixes(b + 1), Imax))
                * lay.edge(lay.suffixes(L - b - 1), Imax)
                for b in range(L - 1))
            return
        for b, d_b in enumerate(self.localdims):
            self.nevals += self.Imax * d_b * self.Imax
            if b < len(self.localdims) - 1:
                self.nevals += self.Imax * self.Imax

    def _write_sets(self, tci, Iset, Ilen, Jset, Jlen, maxsample) -> None:
        L = len(self.localdims)
        with span("tci.engine.unpack"):
            tci.Iset = self._unpack(Iset, Ilen, list(range(L)))
            tci.Jset = self._unpack(Jset, Jlen,
                                    [L - b - 1 for b in range(L)])
        tci.updatemaxsample(float(maxsample))

    def sweep2site(self, tci, forward: bool, reltol: float, abstol: float,
                   maxbonddim: int, extraIset: List[List[MultiIndex]],
                   extraJset: List[List[MultiIndex]],
                   pivotsearch: str = "full",
                   fill_sites: bool = False) -> bool:
        """Run one full 2-site sweep on the device, updating tci in place,
        with one fetch at its end. pivotsearch="rook" runs the rook sweep
        (``_sweep_rook``) from a seed drawn from ``_rng``. fill_sites=True
        also computes all site tensors on the same device state before that
        fetch (tci_tpu's fused sweep-and-fill program) and stores them on
        tci. Returns False when the required capacity exceeds
        ``capacity_limit()`` (the caller falls back to the per-bond
        tier)."""
        L = len(self.localdims)
        if not self._reserve(self._needed(tci, extraIset, extraJset)):
            return False
        rook = pivotsearch == "rook"
        program = self._get_sweep(forward, fill_sites, rook)
        program.load(tci.Iset, tci.Jset, extraIset, extraJset, reltol=reltol,
                     abstol=abstol, maxbonddim=maxbonddim,
                     **({"seed": self._seed()} if rook else {}))
        (Iset, Ilen, Jset, Jlen, perrs, maxsample, *nev), kept = self._run(
            program)
        # a bond at the cap with more rank allowed: grow and re-run this
        # sweep with larger buffers (until the limit, then hand back)
        if Ilen.max() >= self.Imax and self.Imax < maxbonddim:
            if not self._grow(maxbonddim):
                return False
            return self.sweep2site(tci, forward, reltol, abstol, maxbonddim,
                                   extraIset, extraJset, pivotsearch,
                                   fill_sites)
        self._write_sets(tci, Iset, Ilen, Jset, Jlen, maxsample)
        for b in range(L - 1):
            tci.updateerrors(b, list(perrs[b][:int(Ilen[b + 1]) + 1]))
        if rook:
            self.nevals += int(nev[0])
        else:
            self._count_sweeps(1)
        if fill_sites:
            self._store_sitetensors(tci, kept[0])
            self._count_fill()
        return True

    def fillsitetensors(self, tci) -> bool:
        """Compute all site tensors on the device from tci's index sets;
        the host knows their sizes, so nothing is fetched (the max |sample|
        is folded into tci's on the device)."""
        if not self._reserve(self._needed(tci)):
            return False
        program = self._get_fill()
        program.load(tci.Iset, tci.Jset)
        _, (tensors, maxsample) = self._run(program)
        tci.updatemaxsample(maxsample)
        self._store_sitetensors(tci, tensors)
        self._count_fill()
        return True

    def sweep1site(self, tci, forward: bool, reltol: float, abstol: float,
                   maxbonddim: int, updatetensors: bool = True) -> bool:
        """One 1-site sweep on the device, updating tci in place, with one
        fetch at its end (and one more sweep after each capacity growth)."""
        L = len(self.localdims)
        if not self._reserve(self._needed(tci)):
            return False
        while True:
            program = self._get_sweep1(forward)
            program.load(tci.Iset, tci.Jset, reltol=reltol, abstol=abstol,
                         maxbonddim=maxbonddim)
            (Iset, Ilen, Jset, Jlen, perrs, maxsample, nan), (tensors,) = (
                self._run(program))
            if (max(Ilen.max(), Jlen.max()) >= self.Imax
                    and self.Imax < maxbonddim):
                if not self._grow(maxbonddim):
                    return False
                continue
            break
        self._write_sets(tci, Iset, Ilen, Jset, Jlen, maxsample)
        if updatetensors:
            bad = np.flatnonzero(nan)
            if bad.size:
                raise ValueError(f"Error: NaN in tensor T[{int(bad[0])}]")
            self._store_sitetensors(tci, tensors)
        for b in range(L - 1):
            k = int(Ilen[b + 1]) if forward else int(Jlen[b])
            tci.updateerrors(b, list(perrs[b][:k + 1]))
        self._count_sweep1(forward)
        return True

    def _count_sweep1(self, forward: bool) -> None:
        """The Π samples of one 1-site sweep: padded, or cut (``_panel``)."""
        lay, Imax, L = self._layout(), self.Imax, len(self.localdims)
        if not lay.cut:
            for b in range(L):
                self.nevals += Imax * self.localdims[b] * Imax
            return
        R = Imax * max(self.localdims)
        # each panel's (prefix sites, rows) and (suffix sites, columns)
        if forward:
            shapes = [((b + 1, R), (L - b - 1, Imax)) for b in range(L)]
        else:
            shapes = [((b, Imax), (L - b, R)) for b in range(L - 1, 0, -1)]
            shapes.append(((1, R), (L - 1, Imax)))
        self.nevals += sum(lay.edge(lay.prefixes(a), ra)
                           * lay.edge(lay.suffixes(c), rc)
                           for (a, ra), (c, rc) in shapes)

    def _needed(self, tci, *extra) -> int:
        """The capacity tci's sets (and the history sets `extra`) need."""
        return max([len(s) for s in tci.Iset] + [len(s) for s in tci.Jset]
                   + [len(s) for sets in extra for s in sets] + [1])

    def _count_sweeps(self, n: int) -> None:
        """The Π samples of n 2-site sweeps at the capacity: the padded
        panels, or the cut ones (``_Layout.edge``)."""
        d, Imax, lay = self.localdims, self.Imax, self._layout()
        if lay.cut:
            C = lay.ar.shape[0]
            self.nevals += n * sum(
                lay.edge(lay.prefixes(b + 1), C)
                * lay.edge(lay.suffixes(len(d) - b - 1), C)
                for b in range(len(d) - 1))
            return
        self.nevals += n * sum((Imax * d[b] + Imax) * (d[b + 1] * Imax + Imax)
                               for b in range(len(d) - 1))

    def sweep2site_pair(self, tci, fwd1: bool, fwd2: bool, reltol: float,
                        abstol: float, maxbonddim: int,
                        extraIset: List[List[MultiIndex]],
                        extraJset: List[List[MultiIndex]],
                        pivotsearch: str = "full",
                        strictlynested: bool = False,
                        search_starts=None) -> bool:
        """One optimize iteration, two 2-site sweeps and the fill, as one
        program with one fetch (``tci_tpu``'s ``sweep2site_pair``, full
        pivoting). Updates tci as two sweep2site calls with the fill on the
        second do: the history gets the pair's input sets, then the
        mid-point sets; the error series is the second sweep's. With
        `search_starts` ((S, L) start points) the global-pivot candidate
        search runs in the same program against the filled cores and
        (best_flat, best_err) lands on ``last_search``. A saturated sweep
        grows the capacity and both sweeps run again; the discarded attempt
        counts no samples. pivotsearch="rook" runs both sweeps by rook
        pivoting, from two seeds drawn from ``_rng`` for each attempt, as
        tci_tpu draws them. Returns False when the capacity guards
        decline."""
        L = len(self.localdims)
        self.last_sweep_filled = False
        self.last_search = None
        if not self._reserve(self._needed(tci, extraIset, extraJset)):
            return False
        nsearch = 0 if search_starts is None else len(search_starts)
        rook = pivotsearch == "rook"
        values = {"use_extra2": 0 if strictlynested else 1}
        if nsearch:
            values["starts"] = np.asarray(search_starts, dtype=np.int64)
        while True:
            if rook:
                # two draws, as two sweep2site calls would make them
                values["seed1"] = self._seed()
                values["seed2"] = self._seed()
            program = self._get_sweep_pair(fwd1, fwd2, nsearch, rook)
            program.load(tci.Iset, tci.Jset, extraIset, extraJset,
                         reltol=reltol, abstol=abstol, maxbonddim=maxbonddim,
                         **values)
            (Iset, Ilen, Jset, Jlen, perrs, maxsample, I1, Il1, J1, Jl1,
             *search), (tensors,) = self._run(program)
            if (max(Ilen.max(), Il1.max()) < self.Imax
                    or self.Imax >= maxbonddim):
                break
            if not self._grow(maxbonddim):
                return False
        if rook:
            self.nevals += int(search.pop())
        else:
            self._count_sweeps(2)
        prefix, suffix = list(range(L)), [L - b - 1 for b in range(L)]
        tci.Iset_history.append([list(s) for s in tci.Iset])
        tci.Jset_history.append([list(s) for s in tci.Jset])
        with span("tci.engine.unpack"):
            tci.Iset_history.append(self._unpack(I1, Il1, prefix))
            tci.Jset_history.append(self._unpack(J1, Jl1, suffix))
        self._write_sets(tci, Iset, Ilen, Jset, Jlen, maxsample)
        for b in range(L - 1):
            tci.updateerrors(b, list(perrs[b][:int(Ilen[b + 1]) + 1]))
        self._store_sitetensors(tci, tensors)
        self._count_fill()
        self.last_sweep_filled = True
        if nsearch:
            self.last_search = (search[0].astype(np.int64), search[1])
            self.nevals += nsearch * L * max(self.localdims)
        return True

    def optimize_loop(self, tci, fwd1: bool, fwd2: bool, reltol: float,
                      tol: float, use_norm: bool, maxbonddim: int,
                      extraIset, extraJset, strictlynested: bool,
                      starts_block, tolmargin: float, prev_errors,
                      prev_ranks, prev_ngp, nch: int, check_ngp: bool,
                      k_budget: int, pivotsearch: str = "full"):
        """Up to min(k_budget, loop_kmax) optimize iterations on the device
        (``tci_tpu``'s ``optimize_loop``, full pivoting): one upload of the
        state, then the loop step's program once an iteration, each followed
        by a read of its status (k, done, code) through a pinned buffer,
        until the step says done or k reaches the budget; then one fetch of
        the stacked outputs. Returns the reference's result dict (numpy
        values; ``cores`` the last committed site tensors on the device;
        ``step_walls`` each step's host wall, from its run until its status
        was on the host), or None when the capacity (``capacity_limit``,
        the panel edge's included) or history guards decline, as the
        reference's do. tci is not changed:
        TensorCI2 replays the per-iteration bookkeeping from the result.
        pivotsearch="rook" runs the rook sweeps, with two seeds an
        iteration of the budget drawn from ``_rng`` before the block, in
        the order the sweep pair draws them (tci_tpu's rule: a run that one
        block covers repeats the pair's trajectory; a new block draws new
        seeds); the result's ``nev`` holds their slab samples."""
        L = len(self.localdims)
        needed = self._needed(tci, extraIset, extraJset)
        if needed > self.capacity_limit() or k_budget <= 0 or nch < 1:
            return None
        target = _imax_target(self.Imax, needed)
        # the reference's guard on its stacked history (int32 there),
        # computed the same way so that both packages decline alike
        if 2 * self.loop_kmax * 2 * L * target * L * 4 > 64 * 2**20:
            return None
        self.Imax = target
        Kmax = self.loop_kmax
        nsearch = 0 if starts_block is None else int(starts_block.shape[1])
        sb = np.zeros((Kmax, max(nsearch, 1), L), dtype=np.int64)
        if nsearch:
            kfill = min(Kmax, starts_block.shape[0])
            sb[:kfill] = starts_block[:kfill]
        # the convergence windows, seeded with the host's last nch - 1
        # entries and left-padded so that an unfilled window cannot pass
        win_err = np.full(nch, np.inf)
        win_rank = np.full(nch, 2**30, dtype=np.int64)
        if nch > 1:
            tail_e, tail_r = list(prev_errors)[1 - nch:], list(prev_ranks)[1 - nch:]
            if tail_e:
                win_err[nch - len(tail_e):] = tail_e
            if tail_r:
                win_rank[nch - len(tail_r):] = tail_r
        # ngp_ok[j]: with j + 1 iterations of the block appended (no global
        # pivots in any), is the last-nch window of pivot counts all zero?
        ngp = list(prev_ngp)
        ngp_ok = [all(g == 0 for g in (ngp[-(nch - 1 - j):]
                                       if nch - 1 - j > 0 else []))
                  for j in range(nch)]
        rook = pivotsearch == "rook"
        seeds = np.zeros((Kmax, 2), dtype=np.int64)
        if rook:
            for k in range(min(k_budget, Kmax)):
                seeds[k] = (self._seed(), self._seed())
        program = self._get_optimize_loop(fwd1, fwd2, nsearch, nch, rook)
        program.load(
            tci.Iset, tci.Jset, extraIset, extraJset, reltol=reltol,
            abstol=0.0, maxbonddim=maxbonddim,
            use_extra2=0 if strictlynested else 1,
            maxbond_full=min(int(maxbonddim), 2**62),
            use_norm=int(bool(use_norm)), check_ngp=int(bool(check_ngp)),
            count=len(prev_errors), starts=sb, ngp_ok=ngp_ok, wrank=win_rank,
            tol=tol, tolmargin=tolmargin, ms=tci.maxsamplevalue, werr=win_err,
            seeds=seeds, nev=0.0, k=0, done=0, code=3)
        budget = min(k_budget, Kmax)
        self.loop_blocks += 1
        # each step's host wall, from its run until its status is on the
        # host (the span tci.engine.step)
        walls = []
        with span("tci.engine.loop"):
            while True:
                t0 = time.perf_counter()
                with span("tci.engine.step"):
                    self._run(program)
                    k, done, code = program.read_status()
                walls.append(time.perf_counter() - t0)
                self.loop_steps += 1
                if done or k >= budget:
                    break
        res = {"k": k, "code": code, "step_walls": walls}
        if k == 0:
            return res
        o = program.out
        names = ("I", "Il", "J", "Jl", "ms", "abstol", "perrs", "hI", "hIl",
                 "hJ", "hJl", "oerr", "orank", "bflat", "berr") + (
                     ("nev",) if rook else ())
        with span("tci.engine.pack"):
            # the cores' copy first, so that the device's last work before
            # the host's write-back is the fetch
            res["cores"] = o["cores"].clone()
            rec, shapes = _packed(
                program.Iset, program.Ilen, program.Jset, program.Jlen,
                program.ms, program.abstol, o["perrs"], o["hI"][:k],
                o["hIl"][:k], o["hJ"][:k], o["hJl"][:k], o["oerr"][:k],
                o["orank"][:k], o["bflat"], o["berr"],
                *((program.nev,) if rook else ()))
        host = fetch(rec, "engine")
        with span("tci.engine.unpack"):
            res.update(zip(names, _unpacked(host, shapes)))
        if rook:
            res["nev"] = float(res["nev"][0])
        return res
