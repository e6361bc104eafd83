"""The share of the traced window in which no kernel, copy or memset ran on
the device: 1 - (union of the profiler's device intervals / window), in %."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return (1.0 - tr.busy_s / tr.window_s) * 100.0
