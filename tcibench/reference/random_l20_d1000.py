"""Plain NumPy reference of ``random_l20_d1000``: the table T regenerated
from each solve's seed, and the returned tensor train contracted at pivot
crosses.

f(sigma) = T[sum_i sigma_i d^i]. The program returns the site tensors
(r_{b-1}, d, r_b) and its pivot sets: Iset[b], the prefixes of sites 0 ..
b-1, and Jset[b], the suffixes of sites b+1 .. L-1. A pivot cross of bond b
is a prefix of Iset[b+1] joined to a suffix of Jset[b], a full index at
which TCI sampled f for the pivot block of that bond. The train reproduces
f there up to rounding, whatever rank it was cut to, where the prefix is
nested down the I sets (each prefix of Iset[b+1] less its last entry is in
Iset[b]) and the suffix down the J sets (each suffix of Jset[b] less its
first entry is in Jset[b+1], to the last bond): the site tensors are
T_b P_b^{-1}, and P_b^{-1} meets its own pivot block only along such
chains. After TCI2's last 1-site sweep the I sets are nested; the J sets
of the bonds before a truncated one need not be (ranks cut by the cap,
global pivots), and there only their nested part is checked
(``nested``). The check holds the train to T at its pivots and the link
dimensions to the full ranks cut to the cap; it does not judge which
pivots were chosen. Off the crosses a random table has no low-rank truth:
at a point whose prefix and suffix at a cut bond are both outside that
bond's pivots the train misses T by O(1), so no number is judged there
(``grid_rel_err`` reports it for ``tools/high_rank_ab.py``).
The train is contracted left to right, one matrix product for each local
index a site.

Nothing here comes from ``tci_tpu_torch``.
"""

from __future__ import annotations

import numpy as np


def table(table_seed: int, size: int) -> np.ndarray:
    """T: ``size`` values uniform on [-1, 1) from default_rng(table_seed)."""
    return np.random.default_rng(int(table_seed)).uniform(-1.0, 1.0, size)


def flat(idx: np.ndarray, d: int) -> np.ndarray:
    """sum_i idx_i d^i of each row of an (n, L) index array."""
    return idx @ (d ** np.arange(idx.shape[1], dtype=np.int64))


def tt_values(cores, idx: np.ndarray) -> np.ndarray:
    """The train at the rows of an (n, L) index array."""
    v = np.ones((idx.shape[0], 1))
    for site, core in enumerate(cores):
        core = np.asarray(core, dtype=np.float64)
        out = np.empty((idx.shape[0], core.shape[2]))
        for s in range(core.shape[1]):
            rows = idx[:, site] == s
            out[rows] = v[rows] @ core[:, s, :]
        v = out
    return v[:, 0]


def nested(Isets, Jsets):
    """The nested parts of the pivot sets, as arrays: the rows of Iset[b]
    whose prefixes chain back through every I set to the empty one, and
    the rows of Jset[b] whose suffixes chain forward through every J set to
    the last."""
    L = len(Isets)
    left, right = [Isets[0]], [None] * L
    for b in range(1, L):
        prev = {tuple(r) for r in left[-1].tolist()}
        rows = Isets[b]
        left.append(rows[[tuple(r[:-1]) in prev for r in rows.tolist()]])
    right[L - 1] = Jsets[L - 1]
    for b in range(L - 2, -1, -1):
        nxt = {tuple(r) for r in right[b + 1].tolist()}
        rows = Jsets[b]
        right[b] = rows[[tuple(r[1:]) in nxt for r in rows.tolist()]]
    return left, right


def crosses(Isets, Jsets, count: int, rng) -> np.ndarray:
    """`count` pivot crosses of the nested sets: each a bond b drawn
    uniformly among those whose nested Iset[b + 1] and Jset[b] hold a row,
    then a row of each, joined."""
    L = len(Isets)
    left, right = nested(Isets, Jsets)
    bonds = [b for b in range(L - 1) if len(left[b + 1]) and len(right[b])]
    out = np.empty((count, L), dtype=np.int64)
    for n, b in enumerate(rng.choice(bonds, size=count)):
        out[n, :b + 1] = left[b + 1][rng.integers(0, len(left[b + 1]))]
        out[n, b + 1:] = right[b][rng.integers(0, len(right[b]))]
    return out


def expected_linkdims(cfg: dict) -> list:
    """min(maxbonddim, d^(b+1), d^(L-b-1)) at each bond b: the full rank of
    the unfolding, cut to the cap, which a random table reaches."""
    L, d, cap = cfg["nsites"], cfg["localdim"], cfg["maxbonddim"]
    return [min(cap, d ** (b + 1), d ** (L - b - 1)) for b in range(L - 1)]


def rel_err(cores, T: np.ndarray, idx: np.ndarray, d: int) -> float:
    """max |tt - T| at the rows of an (n, L) index array over max |T|."""
    return float(np.abs(tt_values(cores, idx) - T[flat(idx, d)]).max()
                 / np.abs(T).max())


def grid_rel_err(cores, T: np.ndarray, count: int, d: int, rng) -> float:
    """``rel_err`` at `count` grid points drawn from `rng`: how far the
    train is from T off its pivots. Reported, never judged."""
    L = len(cores)
    return rel_err(cores, T, rng.integers(0, d, size=(count, L)), d)


def judge(cfg: dict, answers, seed: int) -> dict:
    """Over every solve of the run: the largest |tt - T| at
    ``check_crosses`` pivot crosses (drawn from (seed, solve)) over max |T|,
    and the number of bonds whose dimension is not
    ``expected_linkdims``."""
    L, d = cfg["nsites"], cfg["localdim"]
    want = expected_linkdims(cfg)
    cross, off = [], []
    for i, (table_seed, (cores, Isets, Jsets)) in enumerate(answers):
        T = table(int(table_seed), d ** L)
        rng = np.random.default_rng((seed, 2, i))
        idx = crosses(Isets, Jsets, cfg["check_crosses"], rng)
        cross.append(rel_err(cores, T, idx, d))
        got = [np.asarray(c).shape[2] for c in cores[:-1]]
        off.append(sum(g != w for g, w in zip(got, want)))
    # np.max, so that a NaN anywhere is the result
    return {"pivot_cross_rel_err": float(np.max(cross)),
            "linkdims_off": int(np.max(off))}
