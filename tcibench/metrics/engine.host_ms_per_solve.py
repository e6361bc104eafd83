"""Host time of the whole-sweep engine's own steps a solve: the self time
of the program's spans ``tci.engine.load`` (packing a program's inputs and
staging them), ``.capture``, ``.replay`` (queuing a graph's replay, or the
eager body) and ``.unpack`` (the fetched record into index sets), less the
``tci.*`` spans inside them, over the traced window's solves."""

from pathlib import Path

from tcibench.core import load_module

SPANS = load_module(Path(__file__).with_name("_program_spans.py"),
                    "tcibench_program_spans")
NAMES = ("tci.engine.load", "tci.engine.capture", "tci.engine.replay",
         "tci.engine.unpack")


def read(run):
    spans = SPANS.program_spans(run.trace)
    if not run.solves or not any(n in NAMES for _, _, n, _ in spans):
        return None
    ms = SPANS.self_ms(spans, lambda n: n in NAMES,
                       lambda n: n not in NAMES)
    return ms / len(run.solves)
