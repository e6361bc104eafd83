"""Run a cell at a tiny size on the CPU, skipping the harness's look for a
card (the helper of the benchmark's CPU tests)."""

import time

# sizes at which a cell runs in seconds on a CPU (everything else as run)
TINY = {"gk15_10d": {"ndim": 3}, "lorentz8d": {"ndim": 4}}
SCAN_CELLS = ("gk15_10d.scan", "lorentz8d.scan")


def run_tiny(cell, seed=2**31 + 11, seconds=1.0, trace=False, **kwargs):
    from tcibench import core
    config = cell.split(".")[0]
    overrides = dict(TINY.get(config, {}), **kwargs.pop("overrides", {}))
    return core.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                         device="cpu", overrides=overrides, **kwargs)
