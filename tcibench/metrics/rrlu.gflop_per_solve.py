"""Real operations of the rrLU kernels a solve, in GFLOP: the program's
device record of the kernels' work (``tci_tpu_torch.utils.trace.
rrlu_work()["ops"]``: c * sum_{j<k} (m-1-j)(n-1-j) a panel, from its true
extents and rank on the device, c = 2 real and 8 complex, replayed launches
included), which counts only while a profiler records, over the traced
window's solves."""


def read(run):
    if run.trace is None or not run.solves:
        return None
    try:
        from tci_tpu_torch.utils.trace import rrlu_work
    except ImportError:
        return None
    work = rrlu_work()
    if not work or work["ops"] <= 0:
        return None
    return work["ops"] / 1e9 / len(run.solves)
