"""Solves that completed (returned, converged) in the window, over the
window's length: from the window's start to the end of its last solve."""


def read(run):
    done = sum(not s.failed for s in run.solves)
    return done / run.window_s if run.window_s > 0 else None
