"""The rrLU kernels' share of their roofline, in %: the least time one
H100 could take for the work of the program's device record
(``tci_tpu_torch.utils.trace.rrlu_work()``: each panel's real operations
c * sum_{j<k} (m-1-j)(n-1-j) from its true extents and rank, and its bytes,
the padded panel read and the LU buffer, permutations, k, magnitudes and
error written once), max(operations / peak, bytes / 3.35 TB/s), over the
profiler's device seconds of the ``__global__`` functions of ``rrlu.cu``
in the same traced window. The peak is NVIDIA's for the H100 SXM outside
the tensor cores: 34 TFLOP/s in float64, and 67 TFLOP/s in float32 where
the trace holds a float32 instantiation of a kernel (the larger peak gives
the smaller bound). The record sums the panels, so the bound is the larger
of the two sums' times, which is at most the sum of each panel's bound: a
lower bound of the kernels' time, and the share at most 100%."""

import re
from pathlib import Path

from tcibench.core import load_module

HERE = Path(__file__).resolve().parent
DEVICE_MS = load_module(HERE / "rrlu.device_ms_per_solve.py",
                        "tcibench_metric_rrlu_device_ms_per_solve")
# NVIDIA's data sheet, H100 SXM, dense, outside the tensor cores
PEAK_FLOP_PER_S = {"float64": 34e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def share(ops: float, nbytes: float, seconds: float, precision: str) -> float:
    """The roofline share, in %, of `seconds` of kernel time for `ops` real
    operations and `nbytes` bytes in `precision`."""
    bound = max(ops / PEAK_FLOP_PER_S[precision], nbytes / HBM_BYTES_PER_S)
    return 100.0 * bound / seconds


def read(run):
    if run.trace is None or not run.solves or not DEVICE_MS.SOURCE.exists():
        return None
    try:
        from tci_tpu_torch.utils.trace import rrlu_work
    except ImportError:
        return None
    work = rrlu_work()
    if not work or work.get("ops", 0) <= 0:
        return None
    names = DEVICE_MS.kernel_names()
    seconds = run.trace.kernel_seconds(names)
    if seconds <= 0:
        return None
    pat = re.compile(r"\b(?:%s)\b" % "|".join(map(re.escape, names)))
    f32 = any(pat.search(n) and re.search(r"<\s*float\b", n)
              for _, _, n in run.trace.device)
    return share(work["ops"], work["bytes"], seconds,
                 "float32" if f32 else "float64")
