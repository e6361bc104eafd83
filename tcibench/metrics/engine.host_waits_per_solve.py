"""Times the host waited on the whole-sweep engine a solve: its fetches and
its status reads (``FETCHES["engine"] + FETCHES["engine_status"]``)."""


def read(run):
    n = [s.counters["host_waits"] for s in run.solves if s.counters]
    return sum(n) / len(n) if n else None
