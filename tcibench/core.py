"""One run of one cell of ``BENCHMARK.json``: set-up, the measured window,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, one traffic mix or one metric
is found by its name:

- ``configs/<config>.json``: the configuration as it is run (sizes,
  tolerances, the scanned parameter, the limits of the check);
  ``configs/<config>.py``: its ``Solver`` (the function family in torch and
  the call into ``tci_tpu_torch``);
- ``reference/<config>.py``: the plain NumPy reference and its ``judge``;
- ``traffic/<mix>.json``: the mix's parameters, read by the ``Solver``
  (``closure``: ``kept``, one function whose parameter is set in place, or
  ``fresh``, a new function each solve); ``draws.py`` draws the values;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``.

A solve is one call of the entry point to its tolerance. The loop is closed:
one caller, the next solve starts when the last has returned and the device
has finished (``torch.cuda.synchronize()``).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from . import draws

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "tci_tpu")
# the TCI2 stopping rule's history length (tensorci2.jl:947-966, the
# optimize default)
NCHECKHISTORY = 3
# the traced part of a --trace 1 window: on an H100 reading the profiler's
# trace back takes ~0.35 s a lorentz8d solve, so a whole 30 s window would
# take minutes
TRACE_SECONDS = 4.0


class ForbiddenModules(RuntimeError):
    """The process imported JAX or the JAX package."""


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """Import the file `path` as a module of its own (file names may hold
    dots, so they are loaded by path, not by package)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, kind: str) -> list:
    """The entries of ``spec[kind]`` that cell `cell` reports."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_modules():
    """Raise ForbiddenModules if JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(
            "modules of JAX or the JAX package were loaded: "
            + ", ".join(found))


def entropy(seed: int) -> int:
    """A seed as numpy's generators take it (any whole number)."""
    return int(seed) % 2**64


@dataclass
class Solve:
    """One solve: its parameter, host wall, answer, what TCI2 returned, and
    the program's counters over it."""
    value: float
    wall_s: float
    answer: object = None
    error: Optional[str] = None
    ranks: list = field(default_factory=list)
    errors: list = field(default_factory=list)
    nglobalpivots: list = field(default_factory=list)
    converged: bool = False
    counters: dict = field(default_factory=dict)

    @property
    def failed(self) -> bool:
        return self.error is not None or not self.converged


@dataclass
class Run:
    """What a metric reader reads."""
    cell: dict
    config: dict
    solves: list
    window_s: float
    setup_s: float
    trace: object = None


def converged(ranks, errors, nglobalpivots, tolerance, maxbonddim) -> bool:
    """TCI2's stopping rule (tensorci2.jl:947-966) on a returned series of
    normalized errors: the last NCHECKHISTORY errors under the tolerance,
    no global pivot added and the rank not above its minimum there; or the
    rank at the cap in all of them."""
    if len(errors) < NCHECKHISTORY:
        return False
    r, e, g = (list(x[-NCHECKHISTORY:]) for x in (ranks, errors,
                                                   nglobalpivots))
    return ((all(x < tolerance for x in e) and all(x == 0 for x in g)
             and min(r) == r[-1])
            or all(x >= maxbonddim for x in r))


@contextlib.contextmanager
def tci2_results(sink: list):
    """Keep what every crossinterpolate2 call returns, through both bindings
    the program has (``integrate`` calls its own)."""
    from tci_tpu_torch.models import integration, tensorci2

    owners = (tensorci2, integration)
    saved = [mod.crossinterpolate2 for mod in owners]

    def recording(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            sink.append(out)
            return out
        return call

    for mod, fn in zip(owners, saved):
        mod.crossinterpolate2 = recording(fn)
    try:
        yield
    finally:
        for mod, fn in zip(owners, saved):
            mod.crossinterpolate2 = fn


@contextlib.contextmanager
def gc_clock(total: list):
    """Add the seconds that Python's cyclic collector runs to total[0]."""
    started = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            total[0] += time.perf_counter() - started[0]

    gc.callbacks.append(on_gc)
    try:
        yield
    finally:
        gc.callbacks.remove(on_gc)


def counters(evaluator) -> dict:
    """The program's counters that the per-layer metrics read: host waits
    of the engine, its graph captures, and the evaluator's samples."""
    from tci_tpu_torch.utils.device import FETCHES
    engine = getattr(evaluator, "_device_sweep_engine", None)
    return {
        "host_waits": FETCHES["engine"] + FETCHES["engine_status"],
        "captures": engine.captures if engine is not None else 0,
        "engine": engine,
    }


def _deltas(before: dict, after: dict, evaluator) -> dict:
    same = before["engine"] is not None and before["engine"] is after["engine"]
    return {
        "host_waits": after["host_waits"] - before["host_waits"],
        "captures": after["captures"] - (before["captures"] if same else 0),
        "evals": evaluator.nevals if evaluator is not None else None,
    }


class Cell:
    """A cell's configuration, mix, solver and reference, found by name."""

    def __init__(self, name: str, spec: dict, device, control=False,
                 overrides=None, root: Path = ROOT):
        bench = root / "tcibench"
        self.spec = next(w for w in spec["workloads"] if w["name"] == name)
        entry = next(c for c in spec["configs"]
                     if c["name"] == self.spec["config"])
        with open(root / entry["file"]) as fh:
            self.config = json.load(fh)
        self.config.update(overrides or {})
        with open(bench / "traffic" / f"{self.spec['traffic']}.json") as fh:
            self.mix = json.load(fh)
        cname = self.spec["config"]
        solver = load_module(bench / "configs" / f"{cname}.py",
                             f"tcibench_config_{cname}")
        self.reference = load_module(bench / "reference" / f"{cname}.py",
                                     f"tcibench_reference_{cname}")
        valuetype = self.config["control_valuetype" if control
                                else "valuetype"]
        self.solver = solver.Solver(self.config, self.mix, device,
                                    np.dtype(valuetype).type)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, control: bool = False,
             overrides: Optional[dict] = None, root: Path = ROOT):
    """Run one cell once; returns (result line as a dict, the lines that
    name each number compared beside its limit). `t_start` is the
    ``time.perf_counter()`` reading at the process's start. Raises
    ForbiddenModules if JAX or the JAX package was loaded by then."""
    import torch

    from .trace import SOLVE, Trace

    spec = load_spec(root)
    device = torch.device(device or "cuda")
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    cell = Cell(workload, spec, device, control, overrides, root)
    cfg, solver = cell.config, cell.solver
    sync()
    t_solver = time.perf_counter()
    seed = entropy(seed)
    results: list = []
    collected = [0.0]

    def one(value, rng, span=False):
        evaluator = solver.evaluator()
        if evaluator is not None:
            evaluator.reset_nevals()
        before = counters(evaluator)
        gc_before = collected[0]
        results.clear()
        t0 = time.perf_counter()
        try:
            if span:
                from torch.profiler import record_function
                with record_function(SOLVE):
                    answer = solver.solve(value, rng)
            else:
                answer = solver.solve(value, rng)
            sync()
            error = None
        except Exception as exc:  # a solve that raises counts as failed
            answer, error = None, f"{type(exc).__name__}: {exc}"
        wall = time.perf_counter() - t0
        s = Solve(value, wall, answer, error)
        if results:
            tci, s.ranks, s.errors = results[-1]
            s.nglobalpivots = list(tci.stats.get("nglobalpivots", []))
            s.converged = converged(
                s.ranks, s.errors, s.nglobalpivots, cfg["tolerance"],
                cfg.get("maxbonddim", float("inf")))
        evaluator = solver.evaluator()
        s.counters = _deltas(before, counters(evaluator), evaluator)
        s.counters["gc_s"] = collected[0] - gc_before
        return s

    work = draws.solves(seed, cfg["parameter"])

    def window(length, out, span=False):
        """Solves into `out` for `length` seconds; returns the seconds from
        the start to the end of the last solve."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < length:
            value, key = next(work)
            out.append(one(value, np.random.default_rng(key), span=span))
        return time.perf_counter() - t0

    solves: list = []
    with tci2_results(results), gc_clock(collected):
        # set-up: one solve at the published value, the same whatever the
        # seed, which records the cell's programs
        one(cfg["parameter"]["published"], np.random.default_rng(0))
        sync()
        setup_s = time.perf_counter() - t_start
        tr = None
        if trace:
            # the per-layer metrics come from the window's first
            # TRACE_SECONDS under the profiler; the rest runs as untraced
            traced = min(seconds, TRACE_SECONDS)
            window_s, tr = Trace.record(lambda: window(traced, solves, True))
            measured = list(solves)
            window_s += window(seconds - traced, solves)
        else:
            window_s = window(seconds, solves)
            measured = solves
    memory = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    run = Run(cell.spec, cfg, measured, tr.window_s if tr else window_s,
              setup_s, tr)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(spec, workload, kind):
        reader = load_module(root / "tcibench" / "metrics" / f"{m['name']}.py",
                             f"tcibench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the check: the answers to the host, the program's state freed, then
    # the reference over every solve that returned
    answers = [(s.value, solver.to_host(s.answer)) for s in solves
               if s.error is None]
    for s in solves:
        s.answer = None
    judge = cell.reference.judge
    results.clear()
    del cell, solver
    if cuda:
        torch.cuda.empty_cache()
    numbers = judge(cfg, answers, seed) if answers else {}
    limits = cfg.get("limits", {})
    checks = {name: {"value": numbers.get(name), "limit": limits.get(name)}
              for name in sorted(set(limits) | set(numbers))}
    correct = bool(answers) and len(answers) == len(solves) and all(
        c["value"] is not None and c["limit"] is not None
        and c["value"] <= c["limit"] for c in checks.values())
    # last, once the metric readers and the reference have been loaded too
    check_modules()

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": memory}
    line = {"correct": correct, "attempted": len(solves),
            "failed": sum(s.failed for s in solves),
            "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
    line["checks"] = checks
    lines = [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
             for name, c in checks.items()]
    errors = sorted({s.error for s in solves if s.error})
    lines = [f"error in a solve: {e}" for e in errors[:3]] + lines
    to_solver = t_solver - t_start
    lines.insert(0, f"setup: {to_solver:.3f} s to the solver (imports, CUDA "
                 f"context), {setup_s - to_solver:.3f} s the warm solve")
    return line, lines
