"""TCIM core of the port — the paper's contribution in PyTorch.

Port of ``src/repro/core/__init__.py`` for the ported slices.

Public API:
    tcim_count / tcim_count_graph   end-to-end bitwise triangle counting
    build_sbf / build_worklist      sparsity-aware compression + scheduling
    device_build*                   the same front end as torch work on the
                                    device (orient -> SBF -> work list)
    plan_execution / ExecutionPlan  placement (replicated, sharded_cols,
                                    sharded_2d) + owner-grouped stripes,
                                    stripe schedules, resume cursors
    Executor / ExecutorPool         device-resident fused execute stage
    plan_fusion / MultiGraphExecutor  cross-graph fused serving (one launch
                                    for a batch of small graphs)
    StreamingTCState / tcim_count_delta  streaming counts over an edge
                                    stream (in-place store edits)
    simulate_lru                    data reuse/exchange behavioral model
    tcim_latency_energy             MRAM latency/energy analytical model
    baselines / metrics             matmul and intersection baselines;
                                    edge support, clustering, k-truss
"""
from repro_torch.core import baselines
from repro_torch.core.bitmat import bitpack_matrix, bitunpack_matrix, popcount_u32
from repro_torch.core.build import (
    DeviceBuild,
    DeviceBuildFuture,
    DeviceWorklist,
    device_build,
    device_build_async,
    device_build_graph,
    device_build_sbf,
    device_build_worklist,
    device_delta_worklist,
)
from repro_torch.core.cachesim import CacheStats, simulate_lru
from repro_torch.core.energymodel import PAPER_TABLE5, MramConstants, tcim_latency_energy
from repro_torch.core.executor import (
    EXECUTOR_MODES,
    CountFuture,
    Executor,
    ExecutorPool,
    MultiCountFuture,
    MultiGraphExecutor,
    apply_store_lanes,
    sbf_content_key,
    staged_uploads,
)
from repro_torch.core.plan import (
    PLACEMENTS,
    SCHEDULES,
    SPLITS,
    DeviceTopology,
    ExecutionPlan,
    FusionPlan,
    StripeSchedule,
    StripeStep,
    WorkStripe,
    balance_grid_bounds,
    bottleneck_range_bounds,
    build_stripe_schedule,
    clamp_chunk_pairs,
    even_range_bounds,
    plan_execution,
    plan_fusion,
    pow2_ceil,
    range_owners,
    remaining_worklist,
    replan_fixed,
    weighted_range_bounds,
)
from repro_torch.core.sbf import (
    SBFUpdate,
    SlicedBitmap,
    UpdateLanes,
    Worklist,
    build_sbf,
    build_worklist,
    build_worklist_pairs,
    sbf_from_arrays,
    sbf_stats,
    update_sbf,
    worklist_from_arrays,
)
from repro_torch.core.streaming import (
    STREAM_BACKENDS,
    DeltaResult,
    StreamingTCState,
    tcim_count_delta,
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
    "MultiCountFuture",
    "MultiGraphExecutor",
    "apply_store_lanes",
    "sbf_content_key",
    "staged_uploads",
    "PLACEMENTS",
    "SCHEDULES",
    "SPLITS",
    "DeviceTopology",
    "ExecutionPlan",
    "FusionPlan",
    "StripeSchedule",
    "StripeStep",
    "WorkStripe",
    "balance_grid_bounds",
    "bottleneck_range_bounds",
    "build_stripe_schedule",
    "clamp_chunk_pairs",
    "even_range_bounds",
    "plan_execution",
    "plan_fusion",
    "pow2_ceil",
    "range_owners",
    "remaining_worklist",
    "replan_fixed",
    "weighted_range_bounds",
    "SBFUpdate",
    "SlicedBitmap",
    "UpdateLanes",
    "Worklist",
    "build_sbf",
    "build_worklist",
    "build_worklist_pairs",
    "sbf_from_arrays",
    "sbf_stats",
    "update_sbf",
    "worklist_from_arrays",
    "DeviceBuild",
    "DeviceBuildFuture",
    "DeviceWorklist",
    "device_build",
    "device_build_async",
    "device_build_graph",
    "device_build_sbf",
    "device_build_worklist",
    "device_delta_worklist",
    "STREAM_BACKENDS",
    "DeltaResult",
    "StreamingTCState",
    "tcim_count_delta",
    "BACKENDS",
    "BUILDS",
    "TCFuture",
    "TCResult",
    "default_executor_pool",
    "tcim_count",
    "tcim_count_graph",
    "CacheStats",
    "simulate_lru",
    "MramConstants",
    "PAPER_TABLE5",
    "tcim_latency_energy",
    "baselines",
]
