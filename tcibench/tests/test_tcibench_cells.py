"""Each cell end to end at a tiny size on the CPU: the result line's keys,
its metrics, and a correct run."""

import json

import pytest
from tiny import SCAN_CELLS

from tcibench import core

REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", SCAN_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_end_to_end(tiny, cell, trace):
    line, checks = tiny(cell, trace=trace)
    extra = {"checks"} | ({"breakdown"} if trace else set())
    assert set(line) == REQUIRED | extra
    # the numbers compared come last, each beside its limit
    assert list(line)[-1] == "checks"
    for name, c in line["checks"].items():
        assert c["limit"] is not None and c["value"] <= c["limit"], name
        assert any(name in text for text in checks)
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    spec = core.load_spec()
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in core.cell_metrics(spec, cell, kind)}
    if trace:
        # the device trace of a CPU run holds no kernel: those metrics are
        # left out, never reported as 0
        names -= {m["name"] for m in spec["per_layer"]
                  if m["source"] == "device_trace"}
        assert line["device"]["busy_s"] == 0.0
        assert line["breakdown"]["device_ops"] == []
    assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    json.dumps(line)


def test_each_seed_draws_its_own_solves_one_in_each_stratum():
    from tcibench import draws
    param = {"low": 9.5, "high": 10.5}
    a, b = draws.solves(3, param), draws.solves(2**31 + 5, param)
    va, vb = [next(a) for _ in range(16)], [next(b) for _ in range(16)]
    again = draws.solves(2**31 + 5, param)
    assert [next(again) for _ in range(16)] == vb
    # other values and other start points on another seed
    assert not {v for v, _ in va} & {v for v, _ in vb}
    assert not {k for _, k in va} & {k for _, k in vb}
    for vals in (va, vb):
        assert len({key for _, key in vals}) == 16
        for block in (slice(0, 8), slice(8, 16)):
            # one value in each eighth of the range, every block
            assert sorted(int((v - 9.5) * 8) for v, _ in vals[block]) == (
                list(range(8)))


def test_converged_is_tci2s_stopping_rule():
    assert core.converged([5, 5, 5], [1e-9] * 3, [0, 0, 0], 1e-8, 64)
    assert not core.converged([5, 5], [1e-9] * 2, [0, 0], 1e-8, 64)
    assert not core.converged([5, 5, 5], [1e-9, 1e-9, 2e-8], [0] * 3, 1e-8, 64)
    assert not core.converged([5, 5, 5], [1e-9] * 3, [0, 1, 0], 1e-8, 64)
    assert not core.converged([4, 6, 5], [1e-9] * 3, [0] * 3, 1e-8, 64)
    # the rank at its cap stops it whatever the error
    assert core.converged([64, 64, 64], [1e-3] * 3, [2] * 3, 1e-8, 64)
