"""Host/device helpers shared by the port's layers."""

from __future__ import annotations

import numpy as np
import torch


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy or torch dtype (np.float64 -> torch.float64)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Upload a host array; through pinned memory for a CUDA device, so the
    host does not wait for work already queued on the device."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
