"""What a traced run reads: spans around the calls into each layer, and the
device's kernels, from one ``torch.profiler`` trace.

The spans are recorded from outside the program: each entry of ``SPANS``
names a function of ``tci_tpu_torch`` that is wrapped in a
``record_function`` of its own for the traced window only (the pattern of
``chip_smoke.profile_run``, rewritten here so that the yardstick does not
move with the program). The busy and idle arithmetic is the union of the
device's intervals (kernels, copies, memsets) inside the traced window.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

# (module, owner inside it or "", attribute, span name). A target that the
# program no longer has is skipped: its span, and any metric read from it,
# is then absent.
SPANS = (
    ("tci_tpu_torch.models.integration", "", "integrate", "integrate"),
    # integrate calls its own binding of crossinterpolate2
    ("tci_tpu_torch.models.integration", "", "crossinterpolate2",
     "crossinterpolate2"),
    ("tci_tpu_torch.models.tensorci2", "", "crossinterpolate2",
     "crossinterpolate2"),
    ("tci_tpu_torch.models.tensorci2", "TensorCI2", "optimize", "optimize"),
    ("tci_tpu_torch.models.tensorci2", "TensorCI2", "_optimize_device_block",
     "optimize_device_block"),
    ("tci_tpu_torch.models.tensorci2", "TensorCI2", "sweep2site",
     "sweep2site"),
    ("tci_tpu_torch.models.tensorci2", "TensorCI2", "sweep1site",
     "sweep1site"),
    ("tci_tpu_torch.models.tensorci2", "", "_batchevaluate_dispatch",
     "sample_panel"),
    ("tci_tpu_torch.models.device_sweep", "DeviceSweepEngine",
     "optimize_loop", "engine_optimize_loop"),
    ("tci_tpu_torch.models.device_sweep", "DeviceSweepEngine", "_capture",
     "engine_capture"),
    ("tci_tpu_torch.models.device_sweep", "_Program", "load",
     "engine_program_load"),
    ("tci_tpu_torch.models.device_sweep", "_Program", "run",
     "engine_program_run"),
    ("tci_tpu_torch.models.device_sweep", "", "peek", "status_read"),
    ("tci_tpu_torch.models.device_sweep", "", "fetch", "fetch"),
    ("tci_tpu_torch.models.tensortrain", "AbstractTensorTrain", "sum",
     "tt_sum"),
)


def _targets():
    for modname, owner, attr, name in SPANS:
        try:
            mod = importlib.import_module(modname)
        except ImportError:
            continue
        obj = getattr(mod, owner, None) if owner else mod
        if obj is None:
            continue
        fn = (obj.__dict__ if owner else vars(obj)).get(attr)
        if callable(fn):
            yield obj, attr, fn, name


@contextlib.contextmanager
def spans():
    """Wrap every target of ``SPANS`` in a ``record_function`` while the
    block runs, and put the originals back after it."""
    from torch.profiler import record_function

    def spanned(fn, name):
        def wrapper(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapper

    saved = list(_targets())
    for obj, attr, fn, name in saved:
        setattr(obj, attr, spanned(fn, name))
    try:
        yield
    finally:
        for obj, attr, fn, _ in saved:
            setattr(obj, attr, fn)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the spans (``record_function``) and the device's intervals; the host's
# torch operations and runtime calls are dropped
KEPT = DEVICE_CATS + ("user_annotation",)
WINDOW = "tcibench_window"
SOLVE = "tcibench_solve"


@dataclass
class Trace:
    """The X events of one traced window, in microseconds as the profiler
    writes them, and the window's bounds (its ``WINDOW`` span)."""
    events: list
    lo: float
    hi: float
    device: list = field(default_factory=list)

    @classmethod
    def record(cls, body):
        """Run body() under ``torch.profiler`` (host and device), inside a
        ``WINDOW`` span and with the layer spans on; returns (body's result,
        Trace). The trace goes through a temporary file and is deleted."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with spans(), profile(activities=activities) as prof:
            with record_function(WINDOW):
                out = body()
                if cuda:
                    torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = [e for e in json.load(fh)["traceEvents"]
                          if e.get("ph") == "X" and e.get("cat") in KEPT]
        top = next(e for e in events if e.get("cat") == "user_annotation"
                   and e["name"] == WINDOW)
        lo, hi = float(top["ts"]), float(top["ts"]) + float(top["dur"])
        device = sorted(
            (max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi),
             e["name"])
            for e in events if e.get("cat") in DEVICE_CATS)
        device = [(a, b, n) for a, b, n in device if b > a]
        return out, cls(events, lo, hi, device)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy_intervals(self):
        """The union of the device's intervals, as sorted disjoint (a, b)."""
        out = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name holds one of `names` as
        a whole identifier."""
        pat = re.compile(r"\b(?:%s)\b" % "|".join(map(re.escape, names)))
        return sum(b - a for a, b, n in self.device
                   if pat.search(n)) / 1e6

    def spans_named(self, name):
        return [e for e in self.events if e.get("cat") == "user_annotation"
                and e["name"] == name]

    def self_seconds(self, name, child) -> float:
        """Seconds of the spans `name`, less the part that their `child`
        spans on the same thread cover."""
        total = 0.0
        kids = self.spans_named(child)
        for e in self.spans_named(name):
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            inner = [(max(a, float(k["ts"])),
                      min(b, float(k["ts"]) + float(k["dur"])))
                     for k in kids if k.get("tid") == e.get("tid")]
            total += (b - a) - _union_len(inner)
        return total / 1e6

    def breakdown(self, top=10):
        """The device operations that took most time, by name, and the idle
        time of the device by the innermost span the host was in when each
        gap began; at most `top` of each, seconds as measured."""
        ops = {}
        for a, b, n in self.device:
            ops[n] = ops.get(n, 0.0) + (b - a) / 1e6
        host = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in self.events if e.get("cat") == "user_annotation"),
            key=lambda s: s[0])
        gaps, end, nxt, active = {}, self.lo, 0, []
        for a, b in self.busy_intervals() + [[self.hi, self.hi]]:
            if a > end:
                # the spans open at `end`: host is sorted by start, and the
                # gaps come in time order
                while nxt < len(host) and host[nxt][0] <= end:
                    active.append(host[nxt])
                    nxt += 1
                active = [s for s in active if s[1] >= end]
                label = "idle in " + (min(active, key=lambda s: s[1] - s[0])[2]
                                      if active else "no span")
                gaps[label] = gaps.get(label, 0.0) + (a - end) / 1e6
            end = max(end, b)
        rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def _union_len(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total
