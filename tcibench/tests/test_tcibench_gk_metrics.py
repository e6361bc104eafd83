"""The readers of the sampling layer's GK panel kernel: its points a solve
from the program's counter and its device time from a synthetic trace, and
None where the program has neither (a program without the kernel)."""

import sys

import pytest

from tcibench import core
from tcibench.trace import Trace

NEW = ("sampling.gk_rows_per_solve", "sampling.gk_device_ms_per_solve")


def reader(name):
    return core.load_module(core.BENCH / "metrics" / f"{name}.py",
                            f"test_metric_{name.replace('.', '_')}")


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


KERNELS = [
    kernel("void (anonymous namespace)::gk_panel_kernel<true>(Args)", 100,
           30),
    kernel("void (anonymous namespace)::gk_panel_kernel<false>(Args)", 300,
           50),
    kernel("void (anonymous namespace)::rrlu_cluster_kernel<double>(x)", 400,
           300),
    kernel("void at::native::index_elementwise_kernel<128, 4>(x)", 800, 40),
]


def run(events, solves=2):
    tr = Trace(events, 0.0, 3000.0, sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in events if e["cat"] == "kernel"))
    return core.Run({"name": "toy"}, {}, [object()] * solves, tr.window_s,
                    1.0, tr)


def test_gk_rows_reads_the_points_counted_while_traced(monkeypatch):
    from tci_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "gk_points_traced", lambda: 1_000_000)
    assert reader("sampling.gk_rows_per_solve").read(run(KERNELS)) == 5e5
    monkeypatch.setattr(trace, "gk_points_traced", lambda: 0)
    assert reader("sampling.gk_rows_per_solve").read(run(KERNELS)) is None


def test_gk_device_ms_reads_the_kernels_of_its_source():
    # the two instantiations' 30 + 50 us over 2 solves
    assert reader("sampling.gk_device_ms_per_solve").read(
        run(KERNELS)) == pytest.approx(0.04)
    others = [e for e in KERNELS if "gk_panel" not in e["name"]]
    assert reader("sampling.gk_device_ms_per_solve").read(run(others)) is None


def test_readers_give_none_without_the_kernel(monkeypatch):
    """A program without the counter (the function missing from its trace
    module) and without the kernel's source: both readers give None; an
    untraced run gives None too."""
    import types
    bare = types.ModuleType("tci_tpu_torch.utils.trace")
    monkeypatch.setitem(sys.modules, "tci_tpu_torch.utils.trace", bare)
    rows = reader("sampling.gk_rows_per_solve")
    assert rows.read(run(KERNELS)) is None
    device = reader("sampling.gk_device_ms_per_solve")
    monkeypatch.setattr(device, "SOURCE", core.BENCH / "no_such_source.cu")
    assert device.read(run(KERNELS)) is None
    r = run(KERNELS)
    r.trace = None
    for name in NEW:
        assert reader(name).read(r) is None, name


def test_every_new_metric_has_its_entry():
    spec = core.load_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["layer"] == "sampling" and m["moves"] == "solves_per_s"
        assert m["workloads"] == ["gk15_10d.scan"]
        assert (core.BENCH / "metrics" / f"{name}.py").exists()
