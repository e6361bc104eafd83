"""Gigabytes of int64 index matrix a solve that the program formed to call
f on (``tci_tpu_torch.utils.trace.index_bytes_traced()``: the Π panels of
an f without a private panel entry, the fill's panels, the global search's
rows; counted where they are formed and at each replay of a graph that
forms them, while a profiler records), over the traced window's solves. A
program without the counter gives nothing."""


def read(run):
    if run.trace is None or not run.solves:
        return None
    try:
        from tci_tpu_torch.utils.trace import index_bytes_traced
    except ImportError:
        return None
    return index_bytes_traced() / 1e9 / len(run.solves)
