"""Arithmetic on the program's own spans (``tci_tpu_torch/utils/trace.py``:
``record_function`` spans named ``tci.*`` that the program enters while a
profiler records), for the metrics that read them. Not a metric: no entry
of ``BENCHMARK.json`` names it."""


def program_spans(trace, prefix="tci."):
    """The traced window's spans whose name starts with `prefix`, as
    (start, end, name, thread) in microseconds."""
    if trace is None:
        return []
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e.get("tid"))
            for e in trace.events if e.get("cat") == "user_annotation"
            and e["name"].startswith(prefix)]


def union_length(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def self_ms(spans, names, exclude) -> float:
    """Milliseconds of the union of the spans whose name `names(name)`
    accepts, less the union of the spans that `exclude(name)` accepts and
    that lie inside one of them on the same thread (the spans of a thread
    nest)."""
    total = 0.0
    for tid in {t for _, _, n, t in spans if names(n)}:
        outer = [(a, b) for a, b, n, t in spans if t == tid and names(n)]
        inner = [(c, d) for c, d, n, t in spans if t == tid and exclude(n)
                 and any(a <= c and d <= b for a, b in outer)]
        total += union_length(outer) - union_length(inner)
    return total / 1e3
