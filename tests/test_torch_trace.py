"""The port's own spans and the rrLU work record
(``tci_tpu_torch/utils/trace.py``), on the CPU.

Under a ``torch.profiler`` a solve through the whole-sweep engine leaves
the ``tci.*`` spans, nested as the program runs them, in the exported
trace; without one no ``record_function`` is entered. The optimize loop's
iteration walls are each step's own. ``profile_dir=`` writes the trace. The
plain version's work record counts what chip_smoke.py's ``bound_parts``
counts, and only while its flag is set: while a profiler records."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import tci_tpu_torch
from tci_tpu_torch.models import device_sweep
from tci_tpu_torch.models.tensorci2 import TensorCI2
from tci_tpu_torch.ops import lu_cuda, lu_kernel
from tci_tpu_torch.utils import trace

torch.set_num_threads(1)

DIMS = [6] * 5
OUTER = "test.solve"


def _evaluator(dims=DIMS):
    return tci_tpu_torch.TorchBatchEvaluator(
        lambda idx: 1.0 / (1.0 + ((idx.to(torch.float64) + 1) ** 2).sum(1)),
        dims, device="cpu")


def _solve(bf, **kw):
    return tci_tpu_torch.crossinterpolate2(
        np.float64, bf, DIMS, tolerance=1e-8, rng=np.random.default_rng(0),
        device="cpu", **kw)


def _events(prof, tmp_path):
    """The spans of an exported trace, as (start, end, name, thread)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e.get("tid"))
            for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _named(events, name):
    return [e for e in events if e[2] == name]


def _inside(inner, outer):
    return (inner[3] == outer[3] and outer[0] <= inner[0]
            and inner[1] <= outer[1])


def _union(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def test_engine_solve_leaves_nested_spans(tmp_path):
    """A kept evaluator's second solve under the profiler: every host step
    of TCI2 and the engine is a span, nested as the program runs it, and
    together they leave at most a tenth of the call unnamed."""
    bf = _evaluator()
    _solve(bf)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(OUTER):
            tci, ranks, _ = _solve(bf)
    ev = _events(prof, tmp_path)
    names = {e[2] for e in ev}
    assert names >= {
        "tci.tci2.init", "tci.tci2.starts", "tci.tci2.block",
        "tci.tci2.writeback", "tci.tci2.sweep1site", "tci.engine.load",
        "tci.engine.loop", "tci.engine.replay", "tci.engine.step",
        "tci.engine.pack", "tci.engine.unpack", "tci.fetch.engine",
        "tci.fetch.engine_status", "tci.wait.engine",
        "tci.wait.engine_status"}
    (outer,) = _named(ev, OUTER)
    ours = [e for e in ev if e[2].startswith("tci.")]
    assert all(_inside(e, outer) for e in ours)
    blocks = _named(ev, "tci.tci2.block")
    steps = _named(ev, "tci.engine.step")
    # one step a loop iteration, each a replay and its status read, in the
    # block's loop
    assert len(steps) == len(ranks) == len(tci.stats["iteration_walltime"])
    for step in steps:
        assert any(_inside(step, b) for b in _named(ev, "tci.engine.loop"))
        inner = [e[2] for e in ours if e is not step and _inside(e, step)]
        assert sorted(inner) == ["tci.engine.replay",
                                 "tci.fetch.engine_status",
                                 "tci.wait.engine_status"]
    for tier in ("engine", "engine_status"):
        for e in _named(ev, "tci.wait." + tier):
            assert any(_inside(e, f) for f in _named(ev, "tci.fetch." + tier))
    for name in ("tci.tci2.writeback", "tci.engine.loop", "tci.engine.pack",
                 "tci.wait.engine"):
        for e in _named(ev, name):
            assert any(_inside(e, b) for b in blocks) or any(
                _inside(e, s) for s in _named(ev, "tci.tci2.sweep1site"))
    for e in _named(ev, "tci.engine.unpack"):
        assert any(_inside(e, w) for w in
                   _named(ev, "tci.tci2.writeback")
                   + _named(ev, "tci.engine.step")
                   + _named(ev, "tci.tci2.block")
                   + _named(ev, "tci.tci2.sweep1site"))
    (sweep1,) = _named(ev, "tci.tci2.sweep1site")
    assert {e[2] for e in ours if _inside(e, sweep1) and e is not sweep1} >= {
        "tci.engine.load", "tci.engine.replay", "tci.wait.engine",
        "tci.engine.unpack"}
    covered = _union([(e[0], e[1]) for e in ours])
    assert covered >= 0.9 * (outer[1] - outer[0])


def test_integrate_spans_surround_tci2(tmp_path):
    """integrate's own host steps: the grid and the evaluator before TCI2,
    the factorized sum after it."""
    def f(x):
        return torch.exp(-(x * x).sum(1))

    kw = dict(GKorder=7, torch_native=True, device="cpu", tolerance=1e-8,
              rng=np.random.default_rng(0))
    tci_tpu_torch.integrate(np.float64, f, [0.0] * 3, [1.0] * 3, **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tci_tpu_torch.integrate(np.float64, f, [0.0] * 3, [1.0] * 3, **kw)
    ev = _events(prof, tmp_path)
    (setup,) = _named(ev, "tci.integrate.setup")
    (total,) = _named(ev, "tci.integrate.sum")
    (init,) = _named(ev, "tci.tci2.init")
    (sweep1,) = _named(ev, "tci.tci2.sweep1site")
    assert setup[1] <= init[0] and sweep1[1] <= total[0]


def test_no_span_is_entered_without_a_profiler(monkeypatch):
    """Without a profiler recording, the program enters no record_function
    (one that raises would show) and every span is one shared no-op."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert not trace.enabled()
    assert trace.span("tci.a") is trace.span("tci.b", "c")
    bf = _evaluator()
    _solve(bf)
    _, ranks, errors = _solve(bf)
    assert errors[-1] < 1e-8
    tci_tpu_torch.integrate(np.float64, lambda x: torch.cos(x.sum(1)),
                            [0.0] * 2, [1.0] * 2, GKorder=7,
                            torch_native=True, device="cpu")


def test_loop_iteration_walls_are_each_steps(monkeypatch):
    """In the optimize loop each iteration's wall is its own step's: a
    status read made to take 0, 0.3, 0.6, ... s longer each time shows in
    the walls, which an even split of the block's wall would flatten; the
    loop has no sweep or search wall apart (nan)."""
    read = device_sweep._Program.read_status
    delays = []

    def slow(self):
        delays.append(0.3 * len(delays))
        time.sleep(delays[-1])
        return read(self)

    bf = _evaluator()
    _solve(bf)
    blocks = bf.device_sweep_engine.loop_blocks
    monkeypatch.setattr(device_sweep._Program, "read_status", slow)
    tci, ranks, _ = _solve(bf)
    walls = tci.stats["iteration_walltime"]
    assert bf.device_sweep_engine.loop_blocks == blocks + 1
    assert len(walls) == len(ranks) == len(delays) >= 3
    assert all(w >= d for w, d in zip(walls, delays))
    assert all(b - a > 0.15 for a, b in zip(walls, walls[1:]))
    for key in ("sweep_walltime", "globalsearch_walltime"):
        assert np.isnan(tci.stats[key]).all()
        assert len(tci.stats[key]) == len(ranks)


def test_per_iteration_path_keeps_its_walls():
    """With the optimize loop off each iteration times its sweeps and its
    search itself."""
    bf = _evaluator()
    bf.device_sweep_engine.use_optimize_loop = False
    tci, ranks, _ = _solve(bf)
    st = tci.stats
    assert len(st["iteration_walltime"]) == len(ranks)
    for s, g, w in zip(st["sweep_walltime"], st["globalsearch_walltime"],
                       st["iteration_walltime"]):
        assert 0 < s < w and 0 <= g < w


@pytest.mark.parametrize("entry", ["crossinterpolate2", "optimize"])
def test_profile_dir_writes_the_spans(tmp_path, entry):
    """profile_dir, as tci_tpu's: a Chrome trace of the call in that
    directory, with the port's spans in it."""
    bf = _evaluator()
    out = tmp_path / "profile"
    if entry == "crossinterpolate2":
        tci, ranks, errors = _solve(bf, profile_dir=str(out))
    else:
        tci = TensorCI2.from_function(bf, DIMS, device="cpu")
        ranks, errors = tci.optimize(bf, tolerance=1e-8,
                                     rng=np.random.default_rng(0),
                                     profile_dir=str(out))
    assert errors[-1] < 1e-8 and not trace.enabled()
    (path,) = list(out.glob("*.json"))
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"tci.tci2.block", "tci.engine.step", "tci.wait.engine_status",
            "tci.tci2.sweep1site"} <= names
    assert ("tci.tci2.init" in names) == (entry == "crossinterpolate2")


def _bound_parts_work(mp, npd, m, n, k, elsize):
    """chip_smoke.py's bound_parts, as counts: c sum_{j<k} (m-1-j)(n-1-j)
    real operations (c = 2 real, 8 complex) and the bytes of the panel in
    and the LU buffer, the permutations, k, mags and err out."""
    real = min(elsize, 8)
    nbytes = (2 * mp * npd * elsize + 8 * (mp + npd + 1)
              + real * (min(mp, npd) + 1))
    c = 8 if elsize == 16 else 2
    ops = sum(c * (m - 1 - j) * (n - 1 - j) for j in range(k))
    return ops, nbytes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex128])
@pytest.mark.parametrize("shape", [(16, 16, 13, 11, 5), (24, 40, 20, 33, 20),
                                   (64, 8, 50, 8, 3)])
def test_plain_record_counts_the_work(monkeypatch, dtype, shape):
    """The plain version's record: while its flag is set, each elimination
    adds its rank, the operations of its true extents and rank, and the
    bytes of its padded panel, as bound_parts counts them; with the flag
    clear it stays as it was."""
    mp, npd, m, n, rank = shape
    rng = np.random.default_rng(mp * npd + rank)
    A = np.zeros((mp, npd), dtype=np.complex128 if dtype.is_complex
                 else np.float64)
    A[:m, :n] = rng.standard_normal((m, rank)) @ rng.standard_normal(
        (rank, n))
    A = torch.from_numpy(A).to(dtype)
    monkeypatch.setattr(lu_kernel, "PLAIN_WORK",
                        [0] * len(lu_cuda.WORK_FIELDS))
    out = lu_kernel.rrlu_plain(A, m, n, min(m, n), 1e-5, 0.0,
                               leftorthogonal=True)
    assert lu_kernel.PLAIN_WORK == [0] * len(lu_cuda.WORK_FIELDS)
    lu_kernel.PLAIN_WORK[0] = 1
    again = lu_kernel.rrlu_plain(A, m, n, min(m, n), 1e-5, 0.0,
                                 leftorthogonal=True)
    for a, b in zip(out, again):
        assert torch.equal(a, b) or bool((a.isnan() & b.isnan()).all())
    k = int(out[3])
    assert k == rank
    ops, nbytes = _bound_parts_work(mp, npd, m, n, k, A.element_size())
    work = dict(zip(lu_cuda.WORK_FIELDS, lu_kernel.PLAIN_WORK))
    assert work == {"flag": 1, "resident": 0, "cluster": 0, "grid": 0,
                    "stream": 0, "pivots": k, "ops": ops, "bytes": nbytes}


def test_solve_counts_rrlu_work_only_while_traced(monkeypatch):
    """A solve sets the record's flag to whether a profiler records: the
    untraced solves before and after a traced one add nothing; the traced
    one adds its eliminations; rrlu_work reads the record."""
    monkeypatch.setattr(lu_kernel, "PLAIN_WORK",
                        [0] * len(lu_cuda.WORK_FIELDS))
    monkeypatch.setattr(trace, "_FLAG", {})
    bf = _evaluator()
    _solve(bf)
    assert trace.rrlu_work()["ops"] == 0
    with profile(activities=[ProfilerActivity.CPU]):
        tci, ranks, _ = _solve(bf)
    work = trace.rrlu_work()
    assert lu_kernel.PLAIN_WORK[0] == 1
    assert work["ops"] > 0 and work["bytes"] > 0
    assert work["pivots"] >= sum(tci.linkdims())
    assert set(work) == set(lu_cuda.WORK_FIELDS[1:])
    _solve(bf)
    assert lu_kernel.PLAIN_WORK[0] == 0
    assert trace.rrlu_work() == work
