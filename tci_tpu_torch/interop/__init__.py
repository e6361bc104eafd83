"""L6 interop: conversions between tci_tpu_torch tensor trains and external
MPS/MPO ecosystems (the reference ships an ITensors extension,
ext/TCIITensorConversion/)."""

from .mps import (
    to_mps_tensors,
    from_mps_tensors,
    to_mpo_tensors,
    from_mpo_tensors,
    to_quimb_mps,
    from_quimb_mps,
    evaluate_mps,
)

__all__ = [
    "to_mps_tensors",
    "from_mps_tensors",
    "to_mpo_tensors",
    "from_mpo_tensors",
    "to_quimb_mps",
    "from_quimb_mps",
    "evaluate_mps",
]
