"""The upstream 10-D GK15 integral as a family over omega (the solver).

f_omega(x) = A cos(omega sum x^2) exp(-(sum x)^4 / q) on [lower, upper]^N,
integrated by ``tci_tpu_torch.integrate(torch_native=True)``. With a kept
closure (mix ``"closure": "kept"``) omega lives in a 0-d device tensor that
f closes over and that is set in place before each solve, so ``integrate``
finds its evaluator in its cache and the engine only replays its graphs.
With ``"fresh"`` every solve gets a new closure with omega baked in as a
Python float, so ``integrate`` builds a new evaluator and engine each time.
"""

from __future__ import annotations

import torch

from tci_tpu_torch.models import integration


def integrand(omega, cfg):
    """f_omega on a (B, N) coordinate tensor; omega a 0-d tensor or a float."""
    amp, q = cfg["amplitude"], cfg["quartic_scale"]

    def f(X):
        return amp * torch.cos(omega * (X ** 2).sum(dim=1)) * torch.exp(
            -X.sum(dim=1) ** 4 / q)
    return f


class Solver:
    def __init__(self, cfg, mix, device, valuetype):
        self.cfg, self.device, self.valuetype = cfg, device, valuetype
        self.kept = mix["closure"] == "kept"
        self.omega = torch.zeros((), dtype=torch.float64, device=device)
        self.f = integrand(self.omega, cfg) if self.kept else None

    def solve(self, omega, rng):
        """The integral at omega (a Python float)."""
        cfg = self.cfg
        if self.kept:
            self.omega.fill_(omega)
        else:
            self.f = integrand(float(omega), cfg)
        n = cfg["ndim"]
        return integration.integrate(
            self.valuetype, self.f, [cfg["lower"]] * n, [cfg["upper"]] * n,
            GKorder=cfg["GKorder"], torch_native=True,
            tolerance=cfg["tolerance"], maxbonddim=cfg["maxbonddim"],
            nsearchglobalpivot=cfg["nsearchglobalpivot"], device=self.device,
            rng=rng)

    def evaluator(self):
        """The evaluator that integrate keeps for the current f, or None."""
        slots = integration._GK_EVAL_CACHE.get(self.f) if self.f else None
        return next(iter(slots.values()), None) if slots else None

    @staticmethod
    def to_host(answer):
        return float(answer)
