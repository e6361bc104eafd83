"""Sweep-direction policy (parity: src/sweepstrategies.jl:41-50)."""

from __future__ import annotations


def forwardsweep(sweepstrategy: str, iteration: int) -> bool:
    """True when iteration `iteration` (1-based) should sweep forward.

    - "forward": always forward.
    - "backandforth": forward on odd iterations, backward on even ones.
    """
    return sweepstrategy == "forward" or (
        sweepstrategy == "backandforth" and iteration % 2 == 1
    )
