"""Host time of TCI2's own loop a solve: the program's spans
``tci.tci2.*`` (the initial pivots, the start points, each block of the
optimize loop with its write-back, the global pivots, the final 1-site
sweep), less the ``tci.engine.*`` and ``tci.wait.*`` spans inside them,
over the traced window's solves."""

from pathlib import Path

from tcibench.core import load_module

SPANS = load_module(Path(__file__).with_name("_program_spans.py"),
                    "tcibench_program_spans")


def read(run):
    spans = SPANS.program_spans(run.trace)
    if not run.solves or not any(n.startswith("tci.tci2.")
                                 for _, _, n, _ in spans):
        return None
    ms = SPANS.self_ms(
        spans, lambda n: n.startswith("tci.tci2."),
        lambda n: n.startswith(("tci.engine.", "tci.wait.")))
    return ms / len(run.solves)
