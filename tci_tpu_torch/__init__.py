"""tci_tpu_torch: tensor cross interpolation on PyTorch and CUDA.

The port of ``tci_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. It keeps
``tci_tpu``'s layout, names, 0-based indices and float64 default. Its entry
points run on the card: ``crossinterpolate2``, ``crossinterpolate1``,
``integrate``, ``TensorCI2``, ``TensorCI1``, ``matrix_crossinterpolate``,
``TorchBatchEvaluator``, ``CachedFunction``, and ``rrlu``, ``MatrixLUCI``,
``factorize``, ``TensorTrain``, ``TTCache`` and ``estimatetrueerror`` on
numpy arrays take ``device=None`` to mean the current CUDA device, and
raise without one unless the caller passes ``device="cpu"``; nothing falls
back to the CPU by itself. A tensor handed to them stays on its device.
A panel on a CUDA device is factorized by the hand-written CUDA rrLU kernel
(``csrc/rrlu.cu``), a panel on the CPU by its plain PyTorch version. On a
``parallel.mesh.default_mesh`` (one process a rank, NCCL on the cards, gloo
on the CPU) ``rrlu_sharded`` row-shards an elimination over the ranks
through the step kernel ``csrc/lu_sharded.cu``, and the entry points that
take ``mesh=`` shard their sampling. This package imports neither ``jax``
nor ``tci_tpu``.
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
from .ops.lu import (
    rrLU,
    rrlu,
    arrlu,
    submatrixargmax,
    cols2Lmatrix,
    rows2Umatrix,
    lu_solve,
)
from .ops.lu_device import DeviceRRLU
from .ops.lu_sharded import rrlu_sharded
from .ops.lu_device import rrlu_rook_device_fused as rrlu_serving
from .ops.luci import MatrixLUCI
from .ops.ci import MatrixCI, AtimesBinv, AinvtimesB, matrix_crossinterpolate
from .ops.aca import MatrixACA
from .ops.factorize import factorize
from .ops.kronrod import kronrod
from .parallel.batcheval import (
    BatchEvaluator,
    BatchEvaluatorAdapter,
    ThreadedBatchEvaluator,
    TorchBatchEvaluator,
    VectorizedBatchEvaluator,
    makebatchevaluatable,
    isbatchevaluable,
)
from .parallel.cachedfunction import CachedFunction
from .models.tensortrain import (
    AbstractTensorTrain,
    TensorTrain,
    TensorTrainFit,
    tensortrain,
    sitedims,
    evaluate,
    add,
    subtract,
    norm,
    norm2,
    fulltensor,
    tt_reverse,
)
from .models.ttcache import TTCache
from .models.globalpivotfinder import (
    AbstractGlobalPivotFinder,
    DefaultGlobalPivotFinder,
    GlobalPivotSearchInput,
)
from .models.tensorci2 import (
    TensorCI2,
    crossinterpolate2,
    filltensor,
    kronecker,
    convergencecriterion,
    searchglobalpivots,
)
from .models.globalsearch import estimatetrueerror
from .models.tensorci1 import TensorCI1, crossinterpolate1, crossinterpolate
from .models import conversion
from .models.contraction import Contraction, contract
from .models.compress_device import compress_device
from .models.contraction_device import contract_zipup_device
from .models.integration import integrate

__all__ = [
    # L0 utils
    "maxabs", "padzero", "pushunique", "isconstant", "randomsubset",
    "pushrandomsubset", "optfirstpivot", "replacenothing",
    "projector_to_slice", "IndexSet", "isnested", "forwardsweep",
    # L1 matrix engines
    "rrLU", "rrlu", "rrlu_sharded", "rrlu_serving", "DeviceRRLU", "arrlu",
    "submatrixargmax", "cols2Lmatrix", "rows2Umatrix",
    "lu_solve", "MatrixLUCI", "factorize", "kronrod", "MatrixCI",
    "AtimesBinv", "AinvtimesB", "matrix_crossinterpolate", "MatrixACA",
    # L2 runtime
    "BatchEvaluator", "BatchEvaluatorAdapter", "ThreadedBatchEvaluator",
    "TorchBatchEvaluator", "VectorizedBatchEvaluator",
    "makebatchevaluatable", "isbatchevaluable", "CachedFunction",
    # L3 tensor train
    "AbstractTensorTrain", "TensorTrain", "TensorTrainFit", "tensortrain",
    "sitedims", "evaluate", "add", "subtract", "norm", "norm2", "fulltensor",
    "tt_reverse", "TTCache",
    # L4 TCI
    "TensorCI2", "crossinterpolate2", "filltensor", "kronecker",
    "convergencecriterion", "searchglobalpivots", "GlobalPivotSearchInput",
    "AbstractGlobalPivotFinder", "DefaultGlobalPivotFinder",
    "estimatetrueerror", "TensorCI1", "crossinterpolate1", "crossinterpolate",
    "conversion",
    # L5 applications
    "Contraction", "contract", "compress_device", "contract_zipup_device",
    "integrate",
]
