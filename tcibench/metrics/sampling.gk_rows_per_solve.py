"""Grid points a solve that the GK panel kernel wrote, the coordinates and
weights of the integrand's samples (``tci_tpu_torch.utils.trace.
gk_points_traced()``: counted at each launch and each replay of a graph that
holds launches, and for the plain version on the CPU, while a profiler
records), over the traced window's solves. Every sample of a GK integrand
goes through it, so it reads as ``sampling.evals_per_solve``; a program
without the kernel gives nothing."""


def read(run):
    if run.trace is None or not run.solves:
        return None
    try:
        from tci_tpu_torch.utils.trace import gk_points_traced
    except ImportError:
        return None
    points = gk_points_traced()
    return points / len(run.solves) if points > 0 else None
