"""The readers of the program's own spans and rrLU work record on a
synthetic trace with known spans and a stub record: the numbers they give,
and None where the program has neither (as a program without them)."""

import sys

import pytest

from tcibench import core
from tcibench.trace import Trace

NEW = ("engine.host_ms_per_solve", "engine.wait_ms_per_solve",
       "tci2.host_ms_per_solve", "rrlu.gflop_per_solve", "rrlu.gflop_per_s")


def reader(name):
    return core.load_module(core.BENCH / "metrics" / f"{name}.py",
                            f"test_metric_{name.replace('.', '_')}")


def span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


# Two solves, in microseconds. Solve 1: a block (0-1000) holding a step
# (100-600: a replay 100-150 and a status wait 150-550), a fetch wait
# (600-700), an unpack (700-760) and a write-back (760-950) that holds an
# unpack (800-840); the final 1-site sweep (1000-1300) holding a load
# (1000-1050, with a staging wait 1010-1020), a replay (1050-1070), a fetch
# wait (1070-1250) and an unpack (1250-1280). Solve 2: a capture (2000-2400)
# and a replay (2400-2500) in a block (2000-2600).
SPANS = [
    span("tcibench_window", 0, 3000),
    span("crossinterpolate2", 0, 1300),
    span("tci.tci2.block", 0, 1000),
    span("tci.engine.step", 100, 500),
    span("tci.engine.replay", 100, 50),
    span("tci.wait.engine_status", 150, 400),
    span("tci.wait.engine", 600, 100),
    span("tci.engine.unpack", 700, 60),
    span("tci.tci2.writeback", 760, 190),
    span("tci.engine.unpack", 800, 40),
    span("tci.tci2.sweep1site", 1000, 300),
    span("tci.engine.load", 1000, 50),
    span("tci.wait.engine_stage", 1010, 10),
    span("tci.engine.replay", 1050, 20),
    span("tci.wait.engine", 1070, 180),
    span("tci.engine.unpack", 1250, 30),
    span("crossinterpolate2", 2000, 600),
    span("tci.tci2.block", 2000, 600),
    span("tci.engine.capture", 2000, 400),
    span("tci.engine.replay", 2400, 100),
    # another thread's span counts, but never inside this one's spans
    span("tci.engine.unpack", 0, 3000, tid=2),
]
KERNELS = [
    kernel("void (anonymous namespace)::rrlu_cluster_kernel<double>(x)", 200,
           300),
    kernel("void (anonymous namespace)::rrlu_kernel<double>(x)", 1100, 100),
    kernel("void at::native::elementwise_kernel<128>(x)", 600, 50),
]


def run(events, solves=2):
    tr = Trace(events, 0.0, 3000.0, sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in events if e["cat"] == "kernel"))
    return core.Run({"name": "toy"}, {}, [object()] * solves, tr.window_s,
                    1.0, tr)


@pytest.fixture
def record(monkeypatch):
    """A stub of the program's rrLU work record."""
    from tci_tpu_torch.utils import trace
    work = {"resident": 3, "cluster": 2, "grid": 0, "stream": 0,
            "pivots": 40, "ops": 800_000_000, "bytes": 10_000}
    monkeypatch.setattr(trace, "rrlu_work", lambda: dict(work))
    return work


def test_span_readers_on_known_spans(record):
    r = run(SPANS + KERNELS)
    # load 50 - 10 (its staging wait), capture 400, replays 50 + 20 + 100,
    # unpacks 60 + 40 + 30 on thread 1 and 3000 on thread 2: 3740 us over
    # 2 solves
    assert reader("engine.host_ms_per_solve").read(r) == pytest.approx(1.87)
    # the fetch and status waits, not the staging one: 400 + 100 + 180
    assert reader("engine.wait_ms_per_solve").read(r) == pytest.approx(0.34)
    # blocks 1000 + 600 and the sweep 300, less the engine and wait spans
    # of the same thread inside: 500 + 100 + 60 + 40 (block 1), 280 (the
    # sweep's load to its last unpack), 400 + 100 (block 2)
    assert reader("tci2.host_ms_per_solve").read(r) == pytest.approx(
        (1900 - 1480) / 1e3 / 2)


def test_rrlu_readers_on_a_stub_record(record):
    r = run(SPANS + KERNELS)
    assert reader("rrlu.gflop_per_solve").read(r) == pytest.approx(0.4)
    # 0.8 GFLOP over the two rrLU kernels' 400 us
    assert reader("rrlu.gflop_per_s").read(r) == pytest.approx(0.8 / 4e-4)


def test_readers_give_none_without_the_program_spans(monkeypatch):
    """A program with none of the spans (the benchmark's own alone) and no
    record (its module missing): every new reader gives None."""
    monkeypatch.setitem(sys.modules, "tci_tpu_torch.utils.trace", None)
    bare = [e for e in SPANS if not e["name"].startswith("tci.")]
    r = run(bare + KERNELS)
    for name in NEW:
        assert reader(name).read(r) is None, name
    # an untraced run has no trace at all
    r.trace = None
    for name in NEW:
        assert reader(name).read(r) is None, name


def test_rrlu_rate_needs_the_kernels_time(record):
    """The rate takes the rrLU kernels' device time alone; without an
    rrLU kernel in the trace there is none."""
    others = [e for e in KERNELS if "rrlu" not in e["name"]]
    assert reader("rrlu.gflop_per_s").read(run(SPANS + others)) is None
    assert reader("rrlu.gflop_per_solve").read(run(SPANS + others)) == (
        pytest.approx(0.4))


def test_every_new_metric_has_its_entry():
    spec = core.load_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["moves"] == "solves_per_s"
        assert m["workloads"] == ["gk15_10d.scan", "lorentz8d.scan"]
        assert (core.BENCH / "metrics" / f"{name}.py").exists()
