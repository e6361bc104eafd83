"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries go to ``tci_tpu_torch/_build/``, named by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused. A build with preprocessor macros (``defines``, for
instrumented variants) is a library of its own. Nothing here runs at import
time.
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
# seconds from the start of the build call that compiled a library until its
# nvcc process had been waited for, in the order given (0.0 when reused)
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


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _paths(name: str, defines=()):
    """(source, library) paths of kernel `name` built with `defines`; the
    library's name carries a hash of the source, the headers of ``csrc``
    and the flags."""
    src = _CSRC / f"{name}.cu"
    # the shared headers are part of every source
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(_flags(defines)).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def build(names, defines=()) -> None:
    """Compile the libraries of ``csrc/<name>.cu`` (with the preprocessor
    macros `defines`) that are not built yet, one nvcc process a source,
    all started together."""
    t0 = time.perf_counter()
    running = []
    for name in names:
        src, lib_path = _paths(name, defines)
        if lib_path.exists():
            BUILD_SECONDS.setdefault(name, 0.0)
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, src, lib_path, tmp, cmd, proc))
    failures = []
    for name, src, lib_path, tmp, cmd, proc in running:
        out, err = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(
                f"nvcc failed ({proc.returncode}) building {src.name}:\n"
                f"{' '.join(cmd)}\n{out}\n{err}")
        else:
            os.replace(tmp, lib_path)
    if failures:
        raise RuntimeError("\n".join(failures))


def load(name: str, defines=()) -> ctypes.CDLL:
    """Return the loaded library built from ``csrc/<name>.cu`` (with the
    preprocessor macros `defines`)."""
    key = (name, tuple(defines))
    if key not in _LIBS:
        build([name], defines)
        _LIBS[key] = ctypes.CDLL(str(_paths(name, defines)[1]))
    return _LIBS[key]
