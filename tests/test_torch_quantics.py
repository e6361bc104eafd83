"""The port's quantics grid (tci_tpu_torch.utils.quantics) against
tci_tpu's, on bit lists and grid indices made from a numpy seed.

Both are integer and float64 host code on the same inputs, so every
comparison is for equality.
"""

import numpy as np
import pytest

from tci_tpu.utils.quantics import DiscretizedGrid as RefGrid
from tci_tpu_torch.utils.quantics import DiscretizedGrid

# (R, a, b): 1-D unit interval at config 3's depth, 2-D and 3-D boxes
GRIDS = {
    "1d_r40": (40, 0.0, 1.0),
    "1d_r8": (8, -2.0, 3.0),
    "2d_r10": (10, (0.0, -1.0), (1.0, 2.5)),
    "3d_r5": (5, (0.0, 0.0, -4.0), (1.0, 2.0, 4.0)),
}


@pytest.mark.parametrize("scheme", ["interleaved", "fused"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_grid_matches_tci_tpu(grid, scheme):
    R, a, b = GRIDS[grid]
    ref = RefGrid(R, a, b, unfoldingscheme=scheme)
    out = DiscretizedGrid(R, a, b, unfoldingscheme=scheme)
    assert out.localdims == ref.localdims and out.D == ref.D
    rng = np.random.default_rng(R + out.D)
    for _ in range(20):
        bits = [int(rng.integers(0, d)) for d in ref.localdims]
        assert out.quantics_to_grididx(bits) == ref.quantics_to_grididx(bits)
        assert (out.quantics_to_origcoord(bits)
                == ref.quantics_to_origcoord(bits))
        m = [int(v) for v in rng.integers(0, 2**R, size=ref.D)]
        assert out.grididx_to_quantics(m) == ref.grididx_to_quantics(m)


@pytest.mark.parametrize("scheme", ["interleaved", "fused"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_round_trip(grid, scheme):
    R, a, b = GRIDS[grid]
    g = DiscretizedGrid(R, a, b, unfoldingscheme=scheme)
    rng = np.random.default_rng(7 * R + g.D)
    for _ in range(20):
        m = tuple(int(v) for v in rng.integers(0, 2**R, size=g.D))
        bits = g.grididx_to_quantics(m)
        assert len(bits) == len(g.localdims)
        assert all(0 <= bit < d for bit, d in zip(bits, g.localdims))
        assert g.quantics_to_grididx(bits) == m
        x = g.quantics_to_origcoord(bits)
        lo, hi = np.atleast_1d(a), np.atleast_1d(b)
        assert all(lo[d] <= x[d] < hi[d] for d in range(g.D))


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="Unknown unfolding scheme"):
        DiscretizedGrid(4, 0.0, 1.0, unfoldingscheme="zigzag")
