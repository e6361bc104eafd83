"""Device-resident TCI2 sweeps: a whole 2-site sweep, the site-tensor fill
and the 1-site sweep on the evaluator's device, with no host sync inside a
sweep and one fetch at its end.

Counterpart of ``tci_tpu/models/device_sweep.py`` (full pivoting, one
device; no pair mode, no mesh). The reference's sweep2site!
(tensorci2.jl:1195-1258) is a host loop doing, per bond, a Π sampling, an
rrLU factorization and index-set bookkeeping. Here:

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

``tci_tpu`` traces one XLA program per sweep (a ``lax.scan`` over bonds);
PyTorch runs eagerly, so each body is a host loop over bonds that queues
launches: the bond index is a Python int, every shape is fixed by the
capacity Imax, and nothing reads a device value until the sweep's single
fetch. The capacity grows when a sweep saturates it; above ``imax_cap`` or
``max_panel_edge`` the engine declines and TensorCI2 falls back to the
per-bond fused tier (``ops/fused.py``), which runs on the device too.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.fused import ci_factors, panel_solve_pinv, sample_panel
from ..ops.lu_kernel import rrlu_panel_batched
from ..utils.device import (FETCHES, fetch, resolve_device, to_device,
                            torch_dtype)

__all__ = ["DeviceSweepEngine", "FETCHES"]

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


def _lt(idx: torch.Tensor, m) -> torch.Tensor:
    """idx < m, broadcast over the batch shape of m (an int or a tensor)."""
    return idx < (m[..., None] if isinstance(m, torch.Tensor) else m)


def _valid(shape, mI, mJ, device) -> torch.Tensor:
    """Mask of the true block of (..., rows, cols) panels: row < mI and
    column < mJ (ints or tensors of the panels' batch shape)."""
    rows = _lt(torch.arange(shape[-2], device=device), mI)
    cols = _lt(torch.arange(shape[-1], device=device), mJ)
    return rows[..., :, None] & cols[..., None, :]


def _panel(f, Ic, Jc, nl: int, nr: int, mI, mJ, dtype):
    """Π panel f([Ic_i[:nl], Jc_j[:nr]]) with invalid rows/cols masked to
    zero (``tci_tpu``'s ``_panel`` and ``_panel_dyn``: the prefix length nl
    is a Python int here)."""
    Pi = sample_panel(f, Ic[:, :nl], Jc[:, :nr], dtype)
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
    arange(Imax) as a column, for the masks."""

    def __init__(self, localdims: Sequence[int], Imax: int, device):
        dmax = max(localdims)
        R = Imax * dmax
        r = torch.arange(R, device=device)
        e = torch.arange(Imax, device=device)
        self.ar = torch.arange(R + Imax, device=device)
        self.extra = self.ar >= R
        self.row = torch.stack([torch.cat([r // dmax, e]),
                                torch.cat([r % Imax, e])])
        self.src = self.row + Imax * self.extra
        self.site = torch.stack([r % dmax, r // Imax])
        dims = to_device(np.asarray(localdims, dtype=np.int64), device)
        site = torch.cat([self.site, torch.zeros_like(self.site[:, :Imax])],
                         dim=1)
        self.pad = torch.stack([site[0] >= dims[:-1, None],
                                site[1] >= dims[1:, None]], dim=1)
        self.keep = e[:, None]


def _bond_writeback(lay, Iset, Ilen, Jset, Jlen, perrs, bi: int, bj: int,
                    be: int, Ic, Jc, rowsel, colsel, k, mags,
                    err_final) -> None:
    """Write one bond's selected pivots and error series into the sweep
    state: Iset[bi] / Jset[bj] get the first k candidate rows / columns
    (zero-padded), perrs[be] the pivot magnitudes with the residual at
    position k (reference pivoterrors, matrixlu.jl:799-801)."""
    Imax = Iset.shape[1]
    keep = lay.keep < k
    torch.mul(Ic[rowsel[:Imax]], keep, out=Iset[bi])
    Ilen[bi] = k
    torch.mul(Jc[colsel[:Imax]], keep, out=Jset[bj])
    Jlen[bj] = k
    # the elimination leaves the magnitudes past k at zero
    row = perrs[be]
    n = min(mags.shape[0], Imax + 1)
    row[:n] = mags[:n]
    row.scatter_(0, k.view(1), err_final.to(row.dtype).view(1))


def _sweep(f, localdims, dtype, lay, Iset, Ilen, Jset, Jlen, eI, eIlen, eJ,
           eJlen, forward: bool, reltol: float, abstol: float,
           maxbonddim: int):
    """One 2-site sweep (``_make_sweep_scan``'s bond body). The Π panel of
    every bond is padded to Icap x Jcap = Imax (dmax + 1) square. Updates
    the index buffers in place; returns (pivot errors (L-1, Imax+1),
    max |sample|), both on the device."""
    L, (Imax, dev) = len(localdims), (Iset.shape[1], Iset.device)
    R = lay.site.shape[1]
    perrs = torch.zeros((L - 1, Imax + 1), dtype=torch.float64, device=dev)
    maxsample = torch.zeros((), dtype=dtype, device=dev)
    # the history sets' sizes at each bond: (|extraIset[b+1]|, |extraJset[b]|)
    exlens = torch.stack([eIlen[1:], eJlen[:-1]], dim=1)[:, :, None]
    for b in (range(L - 1) if forward else range(L - 2, -1, -1)):
        # the valid candidates of both sides, moved to the front in a
        # stable order; their counts are the panel's extents (mI, mJ)
        lens = torch.stack((Ilen[b], Jlen[b + 1]))[:, None]
        invalid = ((lay.row >= torch.where(lay.extra, exlens[b], lens))
                   | lay.pad[b])
        order = torch.argsort(invalid.to(torch.uint8), dim=1, stable=True)
        m = (~invalid).sum(1, dtype=torch.int32)
        # Icombined: kron(Iset[b], d_b), then the Iset history
        Ic = torch.cat([Iset[b], eI[b + 1]])[lay.src[0]]
        Ic[:R, b] = lay.site[0]
        Ic = Ic[order[0]]
        # Jcombined: kron(d_{b+1}, Jset[b+1]), then the Jset history
        Jc = torch.cat([torch.roll(Jset[b + 1], 1, 1), eJ[b]])[lay.src[1]]
        Jc[:R, 0] = lay.site[1]
        Jc = Jc[order[1]]

        Pi = sample_panel(f, Ic[:, :b + 1], Jc[:, :L - b - 1], dtype)
        ok = lay.ar < m[:, None]
        Pi = torch.where(ok[0][:, None] & ok[1][None, :], Pi, 0)
        maxsample = torch.maximum(
            maxsample, torch.linalg.vector_norm(Pi, float("inf")))
        mn = m.amin()
        maxrank = torch.clamp(mn, max=min(maxbonddim, Imax))
        _, rowperm, colperm, k, mags, err = _rrlu(
            Pi, m[0:1], m[1:2], maxrank[None], reltol, abstol, forward)
        err_final = torch.where(k >= mn, 0.0, err)
        _bond_writeback(lay, Iset, Ilen, Jset, Jlen, perrs, b + 1, b, b, Ic,
                        Jc, rowperm, colperm, k, mags, err_final)
    return perrs, maxsample


def _fill(f, localdims, dtype, Iset, Ilen, Jset, Jlen):
    """All L site tensors T_b = Π₁ P^{-1} (tensorci2.jl:599-629;
    ``_make_fillsitetensors_scan``). The L-1 bonds' Π₁ and P panels and the
    last site's samples come from one call of f, the L-1 P blocks from one
    batched rrLU launch. Returns (tensors (L, Imax, dmax, Imax), max
    |sample| over the Π₁ panels), on the device."""
    L, dmax, (Imax, dev) = len(localdims), max(localdims), (Iset.shape[1],
                                                            Iset.device)
    B, R = L - 1, Imax * dmax
    bidx = torch.arange(B, device=dev)
    pos = torch.arange(L, device=dev)
    dims = to_device(np.asarray(localdims[:B], dtype=np.int64), dev)
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
    idx = torch.where((pos[None, :] <= bidx[:, None])[:, None, None, :],
                      rows[:, :, None, :], Jsh[:, None, :, :])
    # the last site: T = Π₁ reshaped (Jset[L-1] = [()])
    last, d_l = L - 1, localdims[L - 1]
    Is = _kron_is(Iset[last], last, d_l)
    vals = f(torch.cat([idx.reshape(-1, L), Is])).to(dtype)
    panels = vals[:B * (R + Imax) * Imax].reshape(B, R + Imax, Imax)

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
    vlast = torch.where(ok, vals[B * (R + Imax) * Imax:], 0)
    maxsample = torch.maximum(maxsample, vlast.abs().amax())
    tensors[last, :, :d_l, 0] = vlast.reshape(Imax, d_l)
    return tensors, maxsample


def _sweep1(f, localdims, dtype, lay, Iset, Ilen, Jset, Jlen, forward: bool,
            reltol: float, abstol: float, maxbonddim: int):
    """One 1-site sweep (tensorci2.jl:659-725; ``_make_sweep1site_scan``).
    Updates the index buffers in place; returns (tensors (L, Imax, dmax,
    Imax), pivot errors (L-1, Imax+1), max |sample|), on the device."""
    L, dmax, (Imax, dev) = len(localdims), max(localdims), (Iset.shape[1],
                                                            Iset.device)
    tensors = torch.zeros((L, Imax, dmax, Imax), dtype=dtype, device=dev)
    perrs = torch.zeros((L - 1, Imax + 1), dtype=torch.float64, device=dev)
    maxsample = torch.zeros((), dtype=dtype, device=dev)
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
            Pi = _panel(f, Is, Js, b + 1, L - b - 1, mIs, mJs, dtype)
        else:
            Js = torch.roll(Jset[b], 1, 1)[lay.row[1, :R]]
            Js[:, 0] = lay.site[1]
            Js, mJs = Js[order], m
            Is, mIs = Iset[b], Ilen[b]
            Pi = _panel(f, Is, Js, b, L - b, mIs, mJs, dtype)
        maxsample = torch.maximum(maxsample, Pi.abs().amax())
        mn = torch.minimum(mIs, mJs)
        maxrank = torch.clamp(mn, max=min(maxbonddim, Imax))
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
                 L - last - 1, Ilen[last] * d_l, Jlen[last], dtype)
    maxsample = torch.maximum(maxsample, Pi1.abs().amax())
    tensors[last, :, :d_l, :] = Pi1[:, :Imax].reshape(Imax, d_l, Imax)
    return tensors, perrs, maxsample


def _nan_sites(tensors, Ilen, Jlen, localdims) -> torch.Tensor:
    """(L,) flags: NaN in the true block of site tensor b."""
    L, Imax, dmax, _ = tensors.shape
    dev = tensors.device
    ar = torch.arange(Imax, device=dev)
    dims = to_device(np.asarray(localdims, dtype=np.int64), dev)
    ncols = torch.cat([Ilen[1:], Jlen[-1:]])
    valid = ((ar[None, :, None, None] < Ilen[:, None, None, None])
             & (torch.arange(dmax, device=dev)[None, None, :, None]
                < dims[:, None, None, None])
             & (ar[None, None, None, :] < ncols[:, None, None, None]))
    return (torch.isnan(tensors) & valid).flatten(1).any(1)


class DeviceSweepEngine:
    """Host wrapper: uploads TCI2 index sets into padded device buffers, runs
    a sweep on the device, and writes the results back after one fetch.
    Grows the buffer capacity when the rank saturates it.

    `f` maps an (N, L) int64 tensor on `device` to (N,) values there."""

    def __init__(self, f: Callable, localdims: Sequence[int], imax: int = 32,
                 imax_cap: int = 256, dtype=torch.float64, device=None,
                 max_panel_edge: int = 4096):
        self.f = f
        self.localdims = tuple(int(d) for d in localdims)
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        self.Imax = imax
        # beyond this capacity the padded panels get wasteful; TensorCI2
        # then falls back to the per-bond fused tier
        self.imax_cap = imax_cap
        # largest per-bond panel edge Imax * (dmax + 1) the engine takes
        self.max_panel_edge = max_panel_edge
        self.nevals = 0
        # rrLU launches this engine made (one a bond, one a fill)
        self.rrlu_calls = 0
        self._layouts = {}

    def _layout(self) -> _Layout:
        """The index layout of the current capacity (built at its first
        sweep)."""
        if self.Imax not in self._layouts:
            self._layouts[self.Imax] = _Layout(self.localdims, self.Imax,
                                               self.device)
        return self._layouts[self.Imax]

    def _reserve(self, needed: int) -> bool:
        """Set the capacity for sets of up to `needed` entries; False when
        that exceeds imax_cap or max_panel_edge."""
        if needed > self.imax_cap:
            return False
        target = _imax_target(self.Imax, needed)
        if target * (max(self.localdims) + 1) > self.max_panel_edge:
            return False
        self.Imax = target
        return True

    def _grow(self) -> bool:
        """Raise the capacity one step after a saturated sweep."""
        nxt = _imax_target(self.Imax, self.Imax + 1)
        if nxt > self.imax_cap or (
                nxt * (max(self.localdims) + 1) > self.max_panel_edge):
            return False
        self.Imax = nxt
        return True

    def _pack(self, sets: List[List[MultiIndex]]) -> Tuple[np.ndarray, ...]:
        """Pack ragged index-set lists into an (L, Imax, L) buffer (each
        multi-index stored left-aligned in row[:len]) and (L,) lengths."""
        L = len(self.localdims)
        buf = np.zeros((L, self.Imax, L), dtype=np.int64)
        lens = np.zeros((L,), dtype=np.int64)
        for b, s in enumerate(sets):
            lens[b] = len(s)
            for r, idx in enumerate(s):
                if len(idx) > 0:
                    buf[b, r, :len(idx)] = idx
        return buf, lens

    def _unpack(self, buf: np.ndarray, lens: np.ndarray,
                lengths_per_site: List[int]) -> List[List[MultiIndex]]:
        out = []
        for b in range(buf.shape[0]):
            ll = lengths_per_site[b]
            out.append([tuple(int(x) for x in buf[b, r, :ll])
                        for r in range(int(lens[b]))])
        return out

    def _upload(self, *sets) -> List[torch.Tensor]:
        """Index sets to the device in one transfer: (buffer, lengths) per
        set list, as views of one device array."""
        parts = [a for s in sets for a in self._pack(s)]
        flat = to_device(np.concatenate([a.ravel() for a in parts]),
                         self.device)
        out, o = [], 0
        for a in parts:
            out.append(flat[o:o + a.size].view(a.shape))
            o += a.size
        return out

    def _fetch(self, *tensors) -> List[np.ndarray]:
        """The sweep's results in one fetch, as float64 arrays of the
        tensors' shapes (integers up to 2^53 are exact)."""
        rec = fetch(torch.cat([t.reshape(-1).to(torch.float64)
                               for t in tensors]), "engine")
        out, o = [], 0
        for t in tensors:
            out.append(rec[o:o + t.numel()].reshape(t.shape))
            o += t.numel()
        return out

    def _store_sitetensors(self, tci, tensors: torch.Tensor) -> None:
        """Site tensors of a fill into tci._sitetensors, each cut to its
        true (|I_b|, d_b, |I_{b+1}|) block; they stay on the device."""
        L = len(self.localdims)
        for b in range(L):
            d_b = self.localdims[b]
            ncols = len(tci.Iset[b + 1]) if b < L - 1 else len(tci.Jset[b])
            tci._sitetensors[b] = to_device(
                tensors[b, :len(tci.Iset[b]), :d_b, :ncols], tci.device)
            self.nevals += self.Imax * d_b * self.Imax
            if b < L - 1:
                self.nevals += self.Imax * self.Imax

    def _write_sets(self, tci, Iset, Ilen, Jset, Jlen, maxsample) -> None:
        L = len(self.localdims)
        tci.Iset = self._unpack(Iset, Ilen, list(range(L)))
        tci.Jset = self._unpack(Jset, Jlen, [L - b - 1 for b in range(L)])
        tci.updatemaxsample(float(maxsample))

    def sweep2site(self, tci, forward: bool, reltol: float, abstol: float,
                   maxbonddim: int, extraIset: List[List[MultiIndex]],
                   extraJset: List[List[MultiIndex]],
                   fill_sites: bool = False) -> bool:
        """Run one full 2-site sweep on the device, updating tci in place,
        with one fetch at its end. fill_sites=True also computes all site
        tensors on the same device state before that fetch (tci_tpu's
        fused sweep-and-fill program) and stores them on tci. Returns False
        when the required capacity exceeds imax_cap or max_panel_edge (the
        caller falls back to the per-bond tier)."""
        L = len(self.localdims)
        needed = max([len(s) for s in tci.Iset] + [len(s) for s in tci.Jset]
                     + [len(s) for s in extraIset]
                     + [len(s) for s in extraJset] + [1])
        if not self._reserve(needed):
            return False
        Iset, Ilen, Jset, Jlen, eI, eIlen, eJ, eJlen = self._upload(
            tci.Iset, tci.Jset, extraIset, extraJset)
        perrs, maxsample = _sweep(
            self.f, self.localdims, self.dtype, self._layout(), Iset, Ilen,
            Jset, Jlen, eI, eIlen, eJ, eJlen, forward, reltol, abstol,
            maxbonddim)
        self.rrlu_calls += L - 1
        tensors = None
        if fill_sites:
            tensors, fill_max = _fill(self.f, self.localdims, self.dtype,
                                      Iset, Ilen, Jset, Jlen)
            self.rrlu_calls += 1
            maxsample = torch.maximum(maxsample, fill_max)
        Iset, Ilen, Jset, Jlen, perrs, maxsample = self._fetch(
            Iset, Ilen, Jset, Jlen, perrs, maxsample)
        # a bond at the cap with more rank allowed: grow and re-run this
        # sweep with larger buffers (until imax_cap, then hand back)
        if Ilen.max() >= self.Imax and self.Imax < maxbonddim:
            if not self._grow():
                return False
            return self.sweep2site(tci, forward, reltol, abstol, maxbonddim,
                                   extraIset, extraJset, fill_sites)
        self._write_sets(tci, Iset, Ilen, Jset, Jlen, maxsample)
        for b in range(L - 1):
            tci.updateerrors(b, list(perrs[b][:int(Ilen[b + 1]) + 1]))
            self.nevals += ((self.Imax * self.localdims[b] + self.Imax)
                            * (self.localdims[b + 1] * self.Imax + self.Imax))
        if tensors is not None:
            self._store_sitetensors(tci, tensors)
        return True

    def fillsitetensors(self, tci) -> bool:
        """Compute all site tensors on the device from tci's index sets;
        the host knows their sizes, so nothing is fetched (the max |sample|
        is folded into tci's on the device)."""
        needed = max([len(s) for s in tci.Iset] + [len(s) for s in tci.Jset]
                     + [1])
        if not self._reserve(needed):
            return False
        Iset, Ilen, Jset, Jlen = self._upload(tci.Iset, tci.Jset)
        tensors, maxsample = _fill(self.f, self.localdims, self.dtype, Iset,
                                   Ilen, Jset, Jlen)
        self.rrlu_calls += 1
        tci.updatemaxsample(maxsample)
        self._store_sitetensors(tci, tensors)
        return True

    def sweep1site(self, tci, forward: bool, reltol: float, abstol: float,
                   maxbonddim: int, updatetensors: bool = True) -> bool:
        """One 1-site sweep on the device, updating tci in place, with one
        fetch at its end (and one more sweep after each capacity growth)."""
        L = len(self.localdims)
        needed = max([len(s) for s in tci.Iset] + [len(s) for s in tci.Jset]
                     + [1])
        if not self._reserve(needed):
            return False
        while True:
            Iset, Ilen, Jset, Jlen = self._upload(tci.Iset, tci.Jset)
            tensors, perrs, maxsample = _sweep1(
                self.f, self.localdims, self.dtype, self._layout(), Iset,
                Ilen, Jset, Jlen, forward, reltol, abstol, maxbonddim)
            self.rrlu_calls += L - 1
            nan = _nan_sites(tensors, Ilen, Jlen, self.localdims)
            Iset, Ilen, Jset, Jlen, perrs, maxsample, nan = self._fetch(
                Iset, Ilen, Jset, Jlen, perrs, maxsample, nan)
            if (max(Ilen.max(), Jlen.max()) >= self.Imax
                    and self.Imax < maxbonddim):
                if not self._grow():
                    return False
                continue
            break
        self._write_sets(tci, Iset, Ilen, Jset, Jlen, maxsample)
        if updatetensors:
            bad = np.flatnonzero(nan)
            if bad.size:
                raise ValueError(f"Error: NaN in tensor T[{int(bad[0])}]")
            for b in range(L):
                d_b = self.localdims[b]
                ncols = (len(tci.Iset[b + 1]) if b < L - 1
                         else len(tci.Jset[b]))
                tci._sitetensors[b] = to_device(
                    tensors[b, :len(tci.Iset[b]), :d_b, :ncols], tci.device)
        for b in range(L - 1):
            k = int(Ilen[b + 1]) if forward else int(Jlen[b])
            tci.updateerrors(b, list(perrs[b][:k + 1]))
        for b in range(L):
            self.nevals += self.Imax * self.localdims[b] * self.Imax
        return True
