"""Bonds a solve that the per-bond fused tier updated, each inside a span
``tci.fused.bond`` (``tci_tpu_torch.utils.trace.fused_bonds_traced()``,
counted while a profiler records), over the traced window's solves: 0
where the whole-sweep engine carries every sweep. A program without the
counter gives nothing."""


def read(run):
    if run.trace is None or not run.solves:
        return None
    try:
        from tci_tpu_torch.utils.trace import fused_bonds_traced
    except ImportError:
        return None
    return fused_bonds_traced() / len(run.solves)
