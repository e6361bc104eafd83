"""CUDA graphs the engine recorded a solve (``engine.captures``). 0 once a
kept evaluator is warm: every program is then a replay."""


def read(run):
    n = [s.counters["captures"] for s in run.solves if s.counters]
    return sum(n) / len(n) if n else None
