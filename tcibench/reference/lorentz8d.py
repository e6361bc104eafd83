"""Plain NumPy reference of ``lorentz8d``: f_a at grid points drawn from the
seed, and the returned tensor train contracted at the same points.

The tensor train is the program's answer, read here only to judge it: its
site tensors (r_{l-1}, d, r_l) are contracted left to right at each point.
Nothing here comes from ``tci_tpu_torch``.
"""

from __future__ import annotations

import numpy as np


def f(a: float, idx: np.ndarray) -> np.ndarray:
    """f_a at the rows of an (n, N) array of 0-based indices."""
    return 1.0 / (a + ((idx + 1.0) ** 2).sum(axis=1))


def tt_values(cores, idx: np.ndarray) -> np.ndarray:
    v = np.asarray(cores[0], dtype=np.float64)[0][idx[:, 0], :]
    for site, core in enumerate(cores[1:], start=1):
        c = np.asarray(core, dtype=np.float64)[:, idx[:, site], :]
        v = np.einsum("nr,rns->ns", v, c)
    return v[:, 0]


def judge(cfg: dict, answers, seed: int) -> dict:
    """The largest gap |tt(v) - f_a(v)| over f_a's largest value, 1 / (a +
    N), at ``check_points`` points of each solve (drawn from (seed, solve);
    the first is the corner v = 1 where f_a is largest)."""
    n, d = cfg["ndim"], cfg["localdim"]
    worst = 0.0
    for i, (a, cores) in enumerate(answers):
        rng = np.random.default_rng((seed, 1, i))
        idx = rng.integers(0, d, size=(cfg["check_points"], n))
        idx[0] = 0
        gap = np.abs(tt_values(cores, idx) - f(a, idx)).max()
        worst = max(worst, float(gap * (a + n)))
    return {"tt_max_rel_err": worst}
