"""Host time of ``integrate`` outside its ``crossinterpolate2`` child (the
GK nodes and weights, the evaluator lookup, the final sum), per solve, from
the spans of the traced window."""


def read(run):
    tr = run.trace
    n = len(tr.spans_named("integrate")) if tr else 0
    if not n:
        return None
    return tr.self_seconds("integrate", "crossinterpolate2") * 1e3 / n
