"""Device time of the GK panel kernel a solve: the profiler's kernel
intervals whose name is one of the ``__global__`` functions of
``tci_tpu_torch/csrc/gk_panel.cu``, over the traced window's solves; a
program without that source gives nothing."""

import re
from pathlib import Path

SOURCE = (Path(__file__).resolve().parents[2] / "tci_tpu_torch" / "csrc"
          / "gk_panel.cu")


def kernel_names():
    text = SOURCE.read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                      r"(\w+)\s*\(", text)


def read(run):
    if run.trace is None or not run.solves or not SOURCE.exists():
        return None
    seconds = run.trace.kernel_seconds(kernel_names())
    return seconds * 1e3 / len(run.solves) if seconds > 0 else None
