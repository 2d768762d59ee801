"""tci_tpu — a tensor cross interpolation (TCI) framework on JAX/XLA.

A from-scratch rebuild of the capabilities of the Julia reference
``TensorCrossInterpolation.jl`` (SURVEY.md), running on JAX's default
accelerator (an NVIDIA GPU) or the host CPU:

- Rank-revealing LU / ACA pivot searches run as jit-compiled fixed-shape XLA
  loops, with padding + masking instead of dynamic shapes so adaptive rank
  growth never triggers recompiles beyond a few size buckets.
- Black-box function sampling is batched: index panels are assembled host-side
  and evaluated through vmap / shard_map adapters that fan out across a device
  mesh.
- Tensor-train evaluation, summation, compression and contraction lower to
  einsums.

Public API mirrors the reference (reference file: src/TensorCrossInterpolation.jl:87-97):
``crossinterpolate1``, ``crossinterpolate2``, ``optfirstpivot``, ``tensortrain``,
``TensorTrain``, ``sitedims``, ``evaluate``, ``contract``, ``integrate`` plus the
documented unexported names accessed as ``tci_tpu.xxx``.

Indices are 0-based throughout (Python convention); the Julia reference is 1-based.
"""

import jax as _jax

# TCI convergence semantics (tolerances down to 1e-10 relative) require float64
# accumulation; enable x64 before any array is created. Individual kernels may
# still choose f32/bf16 internally where it is safe.
_jax.config.update("jax_enable_x64", True)

from .utils.util import (  # noqa: E402
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
from .utils.indexset import IndexSet, isnested  # noqa: E402
from .utils.sweep import forwardsweep  # noqa: E402
from .ops.lu import (  # noqa: E402
    rrLU,
    rrlu,
    arrlu,
    submatrixargmax,
    cols2Lmatrix,
    rows2Umatrix,
    lu_solve,
)
from .ops.ci import MatrixCI, AtimesBinv, AinvtimesB, matrix_crossinterpolate  # noqa: E402
from .ops.aca import MatrixACA  # noqa: E402
from .ops.luci import MatrixLUCI  # noqa: E402
from .ops.factorize import factorize  # noqa: E402
from .ops.lu_device import (  # noqa: E402
    DeviceRRLU,
    rrlu_rook_device_fused as rrlu_serving,
)
from .ops.lu_sharded import rrlu_sharded  # noqa: E402
from .ops.kronrod import kronrod  # noqa: E402
from .parallel.batcheval import (  # noqa: E402
    BatchEvaluator,
    BatchEvaluatorAdapter,
    ThreadedBatchEvaluator,
    VectorizedBatchEvaluator,
    JaxBatchEvaluator,
    makebatchevaluatable,
    isbatchevaluable,
    _batchevaluate_dispatch,
)
from .parallel.cachedfunction import CachedFunction  # noqa: E402
from .models.tensortrain import (  # noqa: E402
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
from .models.ttcache import TTCache  # noqa: E402
from .models.tensorci2 import (  # noqa: E402
    TensorCI2,
    crossinterpolate2,
    filltensor,
    kronecker,
    convergencecriterion,
    searchglobalpivots,
)
from .models.tensorci1 import TensorCI1, crossinterpolate1, crossinterpolate  # noqa: E402
from .models.globalpivotfinder import (  # noqa: E402
    GlobalPivotSearchInput,
    AbstractGlobalPivotFinder,
    DefaultGlobalPivotFinder,
)
from .models.globalsearch import estimatetrueerror  # noqa: E402
from .models import conversion  # noqa: E402
from .models.contraction import Contraction, contract  # noqa: E402
from .models.compress_device import compress_device  # noqa: E402
from .models.contraction_device import contract_zipup_device  # noqa: E402
from .models.integration import integrate  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    # L0 utils
    "maxabs", "padzero", "pushunique", "isconstant", "randomsubset",
    "pushrandomsubset", "optfirstpivot", "replacenothing", "projector_to_slice",
    "IndexSet", "isnested", "forwardsweep",
    # L1 matrix engines
    "rrLU", "rrlu", "rrlu_sharded", "rrlu_serving", "DeviceRRLU", "arrlu",
    "submatrixargmax",
    "cols2Lmatrix", "rows2Umatrix",
    "lu_solve", "MatrixCI", "AtimesBinv", "AinvtimesB", "matrix_crossinterpolate",
    "MatrixACA", "MatrixLUCI", "factorize", "kronrod",
    # L2 runtime
    "BatchEvaluator", "BatchEvaluatorAdapter", "ThreadedBatchEvaluator",
    "VectorizedBatchEvaluator", "JaxBatchEvaluator", "makebatchevaluatable",
    "isbatchevaluable", "CachedFunction",
    # L3 tensor train
    "AbstractTensorTrain", "TensorTrain", "TensorTrainFit", "tensortrain",
    "sitedims", "evaluate", "add", "subtract", "norm", "norm2", "fulltensor",
    "tt_reverse", "TTCache",
    # L4 TCI
    "TensorCI2", "crossinterpolate2", "filltensor", "kronecker",
    "convergencecriterion", "searchglobalpivots", "TensorCI1",
    "crossinterpolate1", "crossinterpolate", "GlobalPivotSearchInput",
    "AbstractGlobalPivotFinder", "DefaultGlobalPivotFinder", "estimatetrueerror",
    "conversion",
    # L5 applications
    "Contraction", "contract", "compress_device", "contract_zipup_device",
    "integrate",
]
