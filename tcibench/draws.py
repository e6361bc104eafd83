"""The one generator of the runs' solves: each a value of the scanned
parameter and the key of the solve's own generator.

Block b of ``STRATA`` solves takes one value in each of ``STRATA`` equal
parts of the configuration's range [``low``, ``high``), at places and in an
order drawn from (seed, b), and the solve with part j draws its pivot
search's start points from (seed, b, j). So every value is uniform on the
range and every seed does solves of its own, while each block covers the
whole range: the share of solves from the range's slow end cannot drift
from seed to seed.
"""

from __future__ import annotations

import numpy as np

STRATA = 8


def solves(seed: int, parameter: dict):
    """The endless sequence of (value, generator key) of a run."""
    low, high = float(parameter["low"]), float(parameter["high"])
    block = 0
    while True:
        rng = np.random.default_rng((seed, block))
        place = rng.random(STRATA)
        for j in rng.permutation(STRATA):
            yield (low + (high - low) * (j + place[j]) / STRATA,
                   (seed, block, int(j)))
        block += 1
