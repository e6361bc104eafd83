"""Host time of Python's cyclic garbage collector a solve (``gc.callbacks``
around each collection): the interpreter's pauses inside the solve's wall,
which grow with the objects the program keeps and makes."""


def read(run):
    n = [s.counters["gc_s"] for s in run.solves if "gc_s" in s.counters]
    return sum(n) * 1e3 / len(n) if n else None
