"""Distribution layer of the port: sharded and resilient triangle counts.

Port of ``src/repro/distributed/__init__.py`` for the TC engine (the
reference's fourteen names), plus the port's ``Mesh``/``make_mesh``.
``kv_quant`` (int8 KV-cache quantization) is a module of its own, as in the
reference. The LM shardings and gradient compression of the reference are
not ported.
"""
from repro_torch.distributed.mesh import Mesh, make_mesh
from repro_torch.distributed.resilient import (
    RecoveryState,
    ResilienceConfig,
    TCCheckpoint,
    resilient_tc_count,
    resume_tc_count,
)
from repro_torch.distributed.tc import (
    TC_PLACEMENTS,
    Sharded2DExecutor,
    ShardedColsExecutor,
    clear_sharded_executor_cache,
    distributed_tc_count,
    distributed_tc_count_async,
    pooled_sharded_2d_executor,
    pooled_sharded_executor,
    shard_worklist,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "RecoveryState",
    "ResilienceConfig",
    "TCCheckpoint",
    "resilient_tc_count",
    "resume_tc_count",
    "Sharded2DExecutor",
    "ShardedColsExecutor",
    "TC_PLACEMENTS",
    "clear_sharded_executor_cache",
    "distributed_tc_count",
    "distributed_tc_count_async",
    "pooled_sharded_2d_executor",
    "pooled_sharded_executor",
    "shard_worklist",
]
