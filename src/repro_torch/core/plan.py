"""ExecutionPlan — placement-aware scheduling for the TCIM execute stage.

Port of ``src/repro/core/plan.py`` for the ``replicated`` placement:
``pow2_ceil``, ``clamp_chunk_pairs``, ``DeviceTopology`` (detected through
torch), ``WorkStripe``, ``ExecutionPlan`` and ``plan_execution``. The sharded
placements (``sharded_cols``, ``sharded_2d``), their range splits and stripe
schedules, and ``plan_fusion`` wait for later slices: asking for a sharded
placement raises ``NotImplementedError`` naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import sbf as sbf_mod
from repro_torch.kernels.ops import INT32_SAFE_WORDS

__all__ = [
    "PLACEMENTS",
    "SCHEDULES",
    "DeviceTopology",
    "WorkStripe",
    "ExecutionPlan",
    "plan_execution",
    "clamp_chunk_pairs",
    "pow2_ceil",
]

# "auto" resolves to one of the concrete placements at planning time.
PLACEMENTS = ("auto", "replicated", "sharded_cols", "sharded_2d")

# Stripe-scheduling policies of the sharded paths (validated by the entry
# points; a single replicated stripe is unaffected by them).
SCHEDULES = ("packed", "lockstep")

# Store size above which "auto" prefers sharding on a multi-device topology.
DEFAULT_SHARD_ABOVE_BYTES = 256 << 20

_TODO_SHARDED = "ROADMAP.md queue 1, item 9 (distributed)"


def pow2_ceil(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1) — the bucket rounding every
    layer shares (chunk tails, store rows)."""
    return 1 << max(0, (x - 1).bit_length())


def clamp_chunk_pairs(chunk_pairs: int, words_per_slice: int) -> int:
    """Largest safe pow2 chunk <= the requested chunk.

    Rounded DOWN to a power of two (never exceed the caller's memory bound),
    then clamped so one chunk's worst case provably fits the int32
    accumulator: ``chunk_pairs * words_per_slice * 32 <= 2**31 - 1``.
    Raises ``ValueError`` when ``words_per_slice`` alone busts the bound.
    """
    if chunk_pairs < 1:
        raise ValueError(f"chunk_pairs must be >= 1, got {chunk_pairs}")
    safe = INT32_SAFE_WORDS // max(words_per_slice, 1)
    if safe < 1:
        raise ValueError(
            f"words_per_slice={words_per_slice} exceeds INT32_SAFE_WORDS="
            f"{INT32_SAFE_WORDS}: a single slice pair's worst-case popcount "
            "overflows the int32 accumulator; use a smaller slice_bits"
        )
    safe_pow2 = 1 << (safe.bit_length() - 1)  # largest pow2 <= safe
    return min(1 << (chunk_pairs.bit_length() - 1), safe_pow2)


@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """What the planner knows about the machine."""

    num_devices: int
    memory_bytes: int | None = None  # per device; None = unknown
    platform: str = "cpu"

    @classmethod
    def detect(cls) -> "DeviceTopology":
        import torch

        if not torch.cuda.is_available():
            return cls(num_devices=1, platform="cpu")
        props = torch.cuda.get_device_properties(0)
        return cls(
            num_devices=torch.cuda.device_count(),
            memory_bytes=int(props.total_memory),
            platform="cuda",
        )


@dataclasses.dataclass(frozen=True)
class WorkStripe:
    """The pairs one owner shard executes; a ``replicated`` plan has exactly
    one stripe with global coordinates."""

    shard: int
    row_pos: np.ndarray  # int32 [P_s]
    col_pos: np.ndarray  # int32 [P_s]

    @property
    def num_pairs(self) -> int:
        return int(len(self.row_pos))


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    placement: str  # resolved: "replicated" in this slice
    num_shards: int
    chunk_pairs: int  # pow2, int32-safe
    words_per_slice: int
    stripes: tuple[WorkStripe, ...]
    stats: dict

    @property
    def total_pairs(self) -> int:
        return sum(s.num_pairs for s in self.stripes)

    @property
    def imbalance(self) -> float:
        """max/mean stripe length — 1.0 is a perfectly balanced sharding."""
        sizes = [s.num_pairs for s in self.stripes]
        mean = sum(sizes) / max(len(sizes), 1)
        return max(sizes) / mean if mean else 1.0


def _resolve_placement(
    placement: str,
    sb: sbf_mod.SlicedBitmap,
    topo: DeviceTopology,
) -> str:
    if placement not in PLACEMENTS:
        raise ValueError(f"placement {placement!r} not in {PLACEMENTS}")
    if placement != "auto":
        return placement
    if topo.num_devices <= 1:
        return "replicated"
    # Shard when the store crowds one device: above the static threshold, or
    # above half the known per-device memory.
    threshold = DEFAULT_SHARD_ABOVE_BYTES
    if topo.memory_bytes:
        threshold = min(threshold, topo.memory_bytes // 2)
    return "replicated" if sb.data_bytes <= threshold else "sharded_cols"


def plan_execution(
    sb: sbf_mod.SlicedBitmap,
    wl: sbf_mod.Worklist,
    topo: DeviceTopology | None = None,
    *,
    placement: str = "auto",
    chunk_pairs: int = 1 << 20,
) -> ExecutionPlan:
    """Choose placement and pick the chunk bucket.

    A ``replicated`` plan is one stripe holding the whole work list in
    global coordinates. Sharded placements raise ``NotImplementedError``.
    """
    topo = topo or DeviceTopology.detect()
    wps = int(sb.words_per_slice)
    chunk = clamp_chunk_pairs(chunk_pairs, wps)
    resolved = _resolve_placement(placement, sb, topo)
    if resolved != "replicated":
        raise NotImplementedError(
            f"placement {resolved!r} is not ported yet: {_TODO_SHARDED}"
        )
    stripes = (
        WorkStripe(
            shard=0,
            row_pos=np.asarray(wl.pair_row_pos, dtype=np.int32),
            col_pos=np.asarray(wl.pair_col_pos, dtype=np.int32),
        ),
    )
    return ExecutionPlan(
        placement=resolved,
        num_shards=1,
        chunk_pairs=chunk,
        words_per_slice=wps,
        stripes=stripes,
        stats={
            "store_bytes": sb.data_bytes,
            "num_pairs": wl.num_pairs,
            "reason": "single stripe; stores replicated",
        },
    )
