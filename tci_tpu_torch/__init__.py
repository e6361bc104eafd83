"""tci_tpu_torch: tensor cross interpolation on PyTorch and CUDA.

The port of ``tci_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. It keeps
``tci_tpu``'s layout, names, 0-based indices and float64 default. Its entry
points run on the card: ``crossinterpolate2``, ``TensorCI2``,
``TorchBatchEvaluator``, and ``rrlu`` / ``MatrixLUCI`` on a numpy array take
``device=None`` to mean the current CUDA device, and raise without one
unless the caller passes ``device="cpu"``; nothing falls back to the CPU by
itself. A tensor handed to ``rrlu`` / ``MatrixLUCI`` stays on its device.
A panel on a CUDA device is factorized by the hand-written CUDA rrLU kernel
(``csrc/rrlu.cu``), a panel on the CPU by its plain PyTorch version. This
package imports neither ``jax`` nor ``tci_tpu``.
"""

from .utils.util import (
    maxabs,
    padzero,
    pushunique,
    isconstant,
    randomsubset,
    pushrandomsubset,
    optfirstpivot,
    replacenothing,
    projector_to_slice,
)
from .utils.indexset import IndexSet, isnested
from .utils.sweep import forwardsweep
from .ops.lu import rrLU, rrlu, submatrixargmax
from .ops.luci import MatrixLUCI
from .parallel.batcheval import (
    BatchEvaluator,
    TorchBatchEvaluator,
    VectorizedBatchEvaluator,
    isbatchevaluable,
)
from .models.tensortrain import AbstractTensorTrain, TensorTrain, tensortrain
from .models.globalpivotfinder import (
    DefaultGlobalPivotFinder,
    GlobalPivotSearchInput,
)
from .models.tensorci2 import TensorCI2, crossinterpolate2

__all__ = [
    "maxabs", "padzero", "pushunique", "isconstant", "randomsubset",
    "pushrandomsubset", "optfirstpivot", "replacenothing",
    "projector_to_slice", "IndexSet", "isnested", "forwardsweep",
    "rrLU", "rrlu", "submatrixargmax", "MatrixLUCI",
    "BatchEvaluator", "TorchBatchEvaluator", "VectorizedBatchEvaluator",
    "isbatchevaluable", "AbstractTensorTrain", "TensorTrain", "tensortrain",
    "DefaultGlobalPivotFinder", "GlobalPivotSearchInput",
    "TensorCI2", "crossinterpolate2",
]
