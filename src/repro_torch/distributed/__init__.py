"""Distribution layer of the port: sharded and resilient triangle counts,
and the LM's sharding specs.

Port of ``src/repro/distributed/__init__.py`` for the TC engine (the
reference's fourteen names), plus the port's ``Mesh``/``make_mesh`` and its
counterparts of ``jax.sharding`` (``PartitionSpec``, ``NamedSharding``, the
placed ``ShardedTensor``). The LM's modules are imported by name, as in the
reference: ``constants`` (the production mesh sizes and the H100's
rates for the roofline), ``ctx`` (the
activation scope), ``lm_sharding`` (param/train/batch/cache/logits specs),
``compression`` (int8 gradients with error feedback) and ``kv_quant``.
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
from repro_torch.distributed.sharding import NamedSharding, P, PartitionSpec, ShardedTensor

__all__ = [
    "Mesh",
    "make_mesh",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "ShardedTensor",
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
