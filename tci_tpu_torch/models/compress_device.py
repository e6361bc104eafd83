"""Tensor-train compression queued on the device as one chain.

Counterpart of ``tci_tpu/models/compress_device.py`` (reference:
src/tensortrain.jl:302-348): the two-pass ``TensorTrain.compress`` sweep,
the L→R exact orthogonalization then the R→L truncation, with every bond
split one launch of the rrLU kernel (``contraction_device._lu_split``) and
the neighbouring-core products on the same device. The caps are static,
``min(m, n, maxbonddim)`` from the shapes; the ranks stay on the device
until one fetch at the end (``FETCHES["compress"]``), after which the
cores are cut to them on the device.

Truncation follows ``ops/factorize.factorize`` (reference
src/tensortrain.jl:219-272): ``normalizeerror=True`` → reltol=tolerance,
abstol=0; ``normalizeerror=False`` → reltol=1e-14, abstol=tolerance. Only
``method="LU"`` runs on the device; CI and SVD stay with the host
``TensorTrain.compress``. Complex trains run in complex128.
"""

from __future__ import annotations

import torch

from .contraction_device import (_fetch_ranks, _two_pass, _unpad,
                                 _work_dtype)
from .tensortrain import TensorTrain

_INTMAX = 2**62


def compress_device(
    tt: TensorTrain,
    method: str = "LU",
    tolerance: float = 1e-12,
    maxbonddim: int = _INTMAX,
    normalizeerror: bool = True,
    mesh=None,
) -> TensorTrain:
    """Compress a tensor train with the whole two-pass sweep queued on its
    device and one fetch. Returns a new TensorTrain on the same device,
    with the host ``TensorTrain.compress(method="LU")``'s truncation. With
    `mesh` every split's elimination is row-sharded over the mesh's ranks
    and the cores are the one-device result's, bitwise."""
    if method != "LU":
        raise ValueError(
            "compress_device supports method='LU' only (the production "
            "default); use the host TensorTrain.compress for CI/SVD.")
    cores = tt.sitetensors()
    if len(cores) <= 1:
        return TensorTrain([t.clone() for t in cores])
    dtype = cores[0].dtype
    for t in cores[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    mbd = int(min(maxbonddim, 2**31 - 1))
    reltol, abstol = ((float(tolerance), 0.0) if normalizeerror
                      else (1e-14, float(tolerance)))
    wdt = _work_dtype(dtype)
    out, kks = _two_pass([t.to(wdt) for t in cores], reltol, abstol, mbd,
                         mesh=mesh)
    ranks = _fetch_ranks(kks, "compress")[::-1]
    return TensorTrain(_unpad(out, ranks, dtype))
