"""Host time blocked on the device in the whole-sweep engine a solve: the
program's spans ``tci.wait.engine`` (a block's or a sweep's fetch) and
``tci.wait.engine_status`` (an optimize-loop step's status read), which
hold only the wait for the device (``done.synchronize()``), over the traced
window's solves."""

from pathlib import Path

from tcibench.core import load_module

SPANS = load_module(Path(__file__).with_name("_program_spans.py"),
                    "tcibench_program_spans")
NAMES = ("tci.wait.engine", "tci.wait.engine_status")


def read(run):
    spans = SPANS.program_spans(run.trace)
    if not run.solves or not any(n in NAMES for _, _, n, _ in spans):
        return None
    ms = SPANS.self_ms(spans, lambda n: n in NAMES, lambda n: False)
    return ms / len(run.solves)
