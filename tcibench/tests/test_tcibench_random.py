"""The ``random_l20_d1000`` configuration at L = 10, D = 32 (a 2^10 table)
on the CPU: the cell runs through ``Cell`` and the harness, the program's
train passes the reference's check, and the check fails for a float32
solve, for one table entry altered and for a core scaled by 1 + 1e-6; the
``gk15_10d.fresh`` cell runs from its entry; and the per-layer metrics this
configuration adds read what they should."""

import json

import numpy as np
import pytest

from tcibench import core
from tcibench.trace import Trace

CELL = "random_l20_d1000.scan"
SMALL = {"nsites": 10, "maxbonddim": 32}
SEED = 2**31 + 24


def _reference():
    return core.load_module(core.BENCH / "reference" / "random_l20_d1000.py",
                            "tcibench_reference_random_l20_d1000")


def _answers(valuetype="valuetype", solves=2):
    """Solves of the small size through the cell's Solver, on the host."""
    import torch
    spec = core.load_spec()
    cell = core.Cell(CELL, spec, torch.device("cpu"),
                     control=valuetype != "valuetype", overrides=SMALL)
    out = []
    for i in range(solves):
        value = 1000.5 + 7 * i
        answer = cell.solver.solve(value, np.random.default_rng(i))
        out.append((value, cell.solver.to_host(answer)))
    return cell.config, out


@pytest.fixture(scope="module")
def solved():
    return _answers()


def _judged(cfg, answers):
    numbers = _reference().judge(cfg, answers, SEED)
    limits = cfg["limits"]
    assert set(numbers) == set(limits)
    return numbers, all(numbers[k] <= limits[k] for k in limits)


def test_the_port_passes_the_reference(solved):
    cfg, answers = solved
    numbers, ok = _judged(cfg, answers)
    assert ok, numbers
    assert numbers["pivot_cross_rel_err"] < 1e-13
    assert numbers["linkdims_off"] == 0
    for _, (cores, Isets, Jsets) in answers:
        assert [c.shape[2] for c in cores[:-1]] == (
            _reference().expected_linkdims(cfg))


def test_a_float32_solve_fails_the_check():
    cfg, answers = _answers("control_valuetype", solves=1)
    numbers, ok = _judged(cfg, answers)
    assert not ok
    assert numbers["pivot_cross_rel_err"] > cfg["limits"][
        "pivot_cross_rel_err"]


def test_one_table_entry_altered_fails_the_check(solved, monkeypatch):
    cfg, answers = solved
    ref = _reference()
    # an entry at a cross the judge draws for the first solve
    _, (cores, Isets, Jsets) = answers[0]
    cross = ref.crosses(Isets, Jsets, cfg["check_crosses"],
                        np.random.default_rng((SEED, 2, 0)))[0]
    entry = int(ref.flat(cross[None], cfg["localdim"])[0])
    table = ref.table

    def altered(table_seed, size):
        T = table(table_seed, size)
        T[entry] += 0.25
        return T

    monkeypatch.setattr(ref, "table", altered)
    numbers = ref.judge(cfg, answers, SEED)
    assert numbers["pivot_cross_rel_err"] > cfg["limits"][
        "pivot_cross_rel_err"]


def test_a_core_scaled_by_one_part_in_a_million_fails_the_check(solved):
    cfg, answers = solved
    value, (cores, Isets, Jsets) = answers[1]
    scaled = [c.copy() for c in cores]
    scaled[4] = scaled[4] * (1 + 1e-6)
    numbers, ok = _judged(cfg, [answers[0], (value, (scaled, Isets, Jsets))])
    assert not ok
    assert numbers["pivot_cross_rel_err"] > cfg["limits"][
        "pivot_cross_rel_err"]


def test_the_cell_runs_a_small_override_through_the_harness(tiny):
    for trace in (False, True):
        line, checks = tiny(CELL, seconds=1.0, trace=trace, overrides=SMALL)
        assert line["correct"] is True and line["failed"] == 0, checks
        assert list(line)[-1] == "checks"
        json.dumps(line)
    # the per-layer metrics of the cell that a CPU run can read: the index
    # bytes, and no bond on the per-bond tier
    metrics = line["metrics"]
    assert set(metrics) == {"sampling.index_gb_per_solve",
                            "tci2.fused_bonds_per_solve"}
    assert metrics["sampling.index_gb_per_solve"]["value"] > 0
    assert metrics["tci2.fused_bonds_per_solve"]["value"] == 0.0


def test_a_program_whose_engine_cannot_hold_the_cap_is_refused(monkeypatch):
    # as the engine before its limit followed the memory: capped at 256
    import torch
    from tci_tpu_torch.models import device_sweep
    monkeypatch.setattr(device_sweep.DeviceSweepEngine, "capacity_limit",
                        lambda self: 256)
    with pytest.raises(RuntimeError, match="rank 1000"):
        core.Cell(CELL, core.load_spec(), torch.device("cpu"))


def test_the_fresh_gk15_cell_runs_from_its_entry(tiny):
    line, checks = tiny("gk15_10d.fresh", seconds=1.0)
    assert line["correct"] is True and line["failed"] == 0, checks
    line, _ = tiny("gk15_10d.fresh", seconds=1.0, trace=True)
    # a new evaluator each solve, and the engine carries it
    assert line["metrics"]["tci2.fused_bonds_per_solve"]["value"] == 0.0


def test_every_new_metric_has_its_entry():
    spec = core.load_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    want = {"sampling.index_gb_per_solve": ("sampling", [CELL]),
            "tci2.fused_bonds_per_solve": ("TCI2 host loop",
                                           [CELL, "gk15_10d.fresh"]),
            "rrlu.roofline_share": ("rrLU", [CELL])}
    for name, (layer, cells) in want.items():
        m = entries[name]
        assert (m["layer"], m["workloads"], m["moves"]) == (
            layer, cells, "solves_per_s")
        assert (core.BENCH / "metrics" / f"{name}.py").exists()
    assert {c["name"] for c in spec["configs"]} >= {"random_l20_d1000"}


def _roofline():
    return core.load_module(core.BENCH / "metrics" / "rrlu.roofline_share.py",
                            "tcibench_metric_rrlu_roofline_share")


def _run(kernels, trace=True):
    device = [(float(a), float(b), n) for a, b, n in kernels]
    tr = Trace([], 0.0, 1e6, device) if trace else None
    return core.Run({}, {}, [object()] * 2, 1.0, 1.0, tr)


def test_the_roofline_share_of_a_synthetic_trace(monkeypatch):
    from tci_tpu_torch.utils import trace
    reader = _roofline()
    # 2 ms of rrLU kernels, 10 GFLOP and 0.2 GB: the operations bound it at
    # 10e9 / 34e12 s, 0.294 ms, so 14.7%
    kernels = [(0, 1500, "void (anonymous namespace)::rrlu_grid_kernel"
                "<double, false>(int)"),
               (2000, 2500, "void (anonymous namespace)::rrlu_cluster_kernel"
                "<double, double const*>(int)"),
               (3000, 9000, "void at::native::reduce_kernel<512, 1>()")]
    monkeypatch.setattr(trace, "rrlu_work",
                        lambda: {"ops": 10e9, "bytes": 0.2e9, "pivots": 1})
    value = reader.read(_run(kernels))
    assert 0 < value <= 100
    assert value == pytest.approx(100 * 10e9 / 34e12 / 2e-3)
    # a float32 instantiation takes the float32 peak; bytes can bound it
    f32 = [(a, b, n.replace("<double", "<float")) for a, b, n in kernels]
    assert reader.read(_run(f32)) == pytest.approx(100 * 10e9 / 67e12 / 2e-3)
    monkeypatch.setattr(trace, "rrlu_work",
                        lambda: {"ops": 1e6, "bytes": 5e9, "pivots": 1})
    assert reader.read(_run(kernels)) == pytest.approx(
        100 * 5e9 / 3.35e12 / 2e-3)
    # no rrLU kernel, or no trace: nothing
    assert reader.read(_run(kernels[2:])) is None
    assert reader.read(_run(kernels, trace=False)) is None


def test_the_roofline_share_is_absent_on_a_cpu_run(tiny):
    line, _ = tiny(CELL, seconds=0.5, trace=True, overrides=SMALL)
    assert "rrlu.roofline_share" not in line["metrics"]
    assert line["device"]["busy_s"] == 0.0
