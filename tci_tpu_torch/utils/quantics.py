"""Minimal quantics-grid helpers.

The port's own copy of ``tci_tpu/utils/quantics.py`` (numpy on the host; the
port imports nothing of ``tci_tpu``). Replaces the QuanticsGrids.jl dependency used by the reference's test suite
and benchmarks (test_tensorci2.jl:346, test_globalsearch.jl). A quantics
representation encodes a 1-D grid of 2^R points as R binary legs; a
D-dimensional grid interleaves the bits of each dimension.

Bits are 0-based (bit in {0, 1}).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class DiscretizedGrid:
    """Uniform grid over [a, b)^D with 2^R points per dimension, addressed by
    quantics bit lists.

    unfoldingscheme="interleaved": legs are grouped per scale, leg (r*D + d)
    of the R*D-leg tensor train is the r-th most significant bit of dimension
    d. unfoldingscheme="fused": leg r carries the D bits of scale r as one
    index of dimension 2^D, dimension d in bit d.
    """

    def __init__(self, R: int, a, b, unfoldingscheme: str = "interleaved"):
        self.R = R
        self.a = np.atleast_1d(np.asarray(a, dtype=float))
        self.b = np.atleast_1d(np.asarray(b, dtype=float))
        self.D = len(self.a)
        if unfoldingscheme not in ("interleaved", "fused"):
            raise ValueError(f"Unknown unfolding scheme {unfoldingscheme}")
        self.unfoldingscheme = unfoldingscheme

    @property
    def localdims(self):
        if self.unfoldingscheme == "interleaved":
            return [2] * (self.R * self.D)
        return [2**self.D] * self.R

    def quantics_to_grididx(self, bitlist: Sequence[int]) -> Tuple[int, ...]:
        """Per-dimension grid index m_d = Σ_r bit_{r,d} 2^{R-1-r}."""
        m = [0] * self.D
        if self.unfoldingscheme == "interleaved":
            for n, bit in enumerate(bitlist):
                r, d = divmod(n, self.D)
                m[d] += int(bit) << (self.R - 1 - r)
        else:
            for r, fused in enumerate(bitlist):
                for d in range(self.D):
                    bit = (int(fused) >> d) & 1
                    m[d] += bit << (self.R - 1 - r)
        return tuple(m)

    def quantics_to_origcoord(self, bitlist: Sequence[int]) -> Tuple[float, ...]:
        m = self.quantics_to_grididx(bitlist)
        return tuple(
            self.a[d] + (self.b[d] - self.a[d]) * m[d] / 2**self.R
            for d in range(self.D)
        )

    def grididx_to_quantics(self, m: Sequence[int]) -> list:
        bits = [0] * (self.R * self.D if self.unfoldingscheme == "interleaved"
                      else self.R)
        if self.unfoldingscheme == "interleaved":
            for d in range(self.D):
                for r in range(self.R):
                    bits[r * self.D + d] = (int(m[d]) >> (self.R - 1 - r)) & 1
        else:
            for r in range(self.R):
                fused = 0
                for d in range(self.D):
                    fused |= ((int(m[d]) >> (self.R - 1 - r)) & 1) << d
                bits[r] = fused
        return bits
