"""The rate of the rrLU kernels, in GFLOP/s: the operations of the
program's device record (``rrlu.gflop_per_solve``) over the profiler's
device seconds of the same kernels in the same traced window (the
``__global__`` functions of ``rrlu.cu``, as ``rrlu.device_ms_per_solve``
reads them). A rate, not a share of a peak: the run measures no peak."""

from pathlib import Path

from tcibench.core import load_module

HERE = Path(__file__).resolve().parent
DEVICE_MS = load_module(HERE / "rrlu.device_ms_per_solve.py",
                        "tcibench_metric_rrlu_device_ms_per_solve")
WORK = load_module(HERE / "rrlu.gflop_per_solve.py",
                   "tcibench_metric_rrlu_gflop_per_solve")


def read(run):
    gflop = WORK.read(run)
    if gflop is None or not DEVICE_MS.SOURCE.exists():
        return None
    seconds = run.trace.kernel_seconds(DEVICE_MS.kernel_names())
    if seconds <= 0:
        return None
    return gflop * len(run.solves) / seconds
