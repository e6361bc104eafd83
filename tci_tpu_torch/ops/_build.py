"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries go to ``tci_tpu_torch/_build/``, named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no multiply-add contraction: the kernels round like their plain
    # PyTorch versions (a multiply, then a subtract)
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict = {}
# seconds spent compiling each library in this process (0.0 when reused)
BUILD_SECONDS: dict = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from tci_tpu_torch/csrc at first use"
    )


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library built from ``csrc/<name>.cu``."""
    if name in _LIBS:
        return _LIBS[name]
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {src.name}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[name] = lib
    return lib
