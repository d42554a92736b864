"""TCIM core of the port — the paper's contribution in PyTorch.

Port of ``src/repro/core/__init__.py`` for the main-path slice.

Public API:
    tcim_count / tcim_count_graph   end-to-end bitwise triangle counting
    build_sbf / build_worklist      sparsity-aware compression + scheduling
    plan_execution / ExecutionPlan  placement (replicated) + work stripes
    Executor / ExecutorPool         device-resident fused execute stage
"""
from repro_torch.core.bitmat import bitpack_matrix, bitunpack_matrix, popcount_u32
from repro_torch.core.executor import (
    EXECUTOR_MODES,
    CountFuture,
    Executor,
    ExecutorPool,
    sbf_content_key,
    staged_uploads,
)
from repro_torch.core.plan import (
    PLACEMENTS,
    SCHEDULES,
    DeviceTopology,
    ExecutionPlan,
    WorkStripe,
    clamp_chunk_pairs,
    plan_execution,
    pow2_ceil,
)
from repro_torch.core.sbf import (
    SlicedBitmap,
    Worklist,
    build_sbf,
    build_worklist,
    build_worklist_pairs,
    sbf_from_arrays,
    sbf_stats,
    worklist_from_arrays,
)
from repro_torch.core.tcim import (
    BACKENDS,
    BUILDS,
    TCFuture,
    TCResult,
    default_executor_pool,
    tcim_count,
    tcim_count_graph,
)

__all__ = [
    "bitpack_matrix",
    "bitunpack_matrix",
    "popcount_u32",
    "EXECUTOR_MODES",
    "CountFuture",
    "Executor",
    "ExecutorPool",
    "sbf_content_key",
    "staged_uploads",
    "PLACEMENTS",
    "SCHEDULES",
    "DeviceTopology",
    "ExecutionPlan",
    "WorkStripe",
    "clamp_chunk_pairs",
    "plan_execution",
    "pow2_ceil",
    "SlicedBitmap",
    "Worklist",
    "build_sbf",
    "build_worklist",
    "build_worklist_pairs",
    "sbf_from_arrays",
    "sbf_stats",
    "worklist_from_arrays",
    "BACKENDS",
    "BUILDS",
    "TCFuture",
    "TCResult",
    "default_executor_pool",
    "tcim_count",
    "tcim_count_graph",
]
