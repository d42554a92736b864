"""ExecutionPlan — placement-aware scheduling for the TCIM execute stage.

Port of ``src/repro/core/plan.py`` for the ``replicated`` placement:
``pow2_ceil``, ``clamp_chunk_pairs``, ``DeviceTopology`` (detected through
torch), ``WorkStripe``, ``ExecutionPlan``, ``plan_execution``, and the
cross-graph ``FusionPlan``/``plan_fusion`` of the serving path. The sharded
placements (``sharded_cols``, ``sharded_2d``), their range splits and stripe
schedules wait for later slices: asking for a sharded placement raises
``NotImplementedError`` naming the ROADMAP item.
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
    "FusionPlan",
    "WorkStripe",
    "ExecutionPlan",
    "plan_execution",
    "plan_fusion",
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

_TODO_SHARDED = "ROADMAP.md queue 1, item 4 (distributed)"


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
class FusionPlan:
    """Cross-graph fusion: many small graphs' worklists as ONE index block.

    ``G`` graphs' pow2-bucketed worklists are stacked into a shared
    ``[G, bucket]`` index block — each graph owns one ``bucket``-wide
    segment, sentinel-padded — and their slice stores are stacked row-wise
    with per-graph offsets baked into the indices. One
    ``popcount_and_gather_segment_totals`` dispatch then returns every
    graph's subtotal. ``G`` is padded to a power of two with all-sentinel
    segments (``padded_graphs``), and the executor pads the stacked store
    rows to powers of two, so launch shapes and memory stay in buckets.
    """

    num_graphs: int  # real graphs fused (leading segments)
    padded_graphs: int  # pow2 >= num_graphs; tail segments all-sentinel
    bucket: int  # pow2 pair width of every graph's segment
    words_per_slice: int
    row_offsets: tuple[int, ...]  # graph g's base row in the stacked row store
    col_offsets: tuple[int, ...]
    row_rows: int  # stacked row-store rows (before the executor's pow2 pad)
    col_rows: int
    row_idx: np.ndarray  # [padded_graphs * bucket] int32, store-global
    col_idx: np.ndarray
    real_pairs: tuple[int, ...]  # per-graph non-sentinel pair counts
    stats: dict

    @property
    def index_lanes(self) -> int:
        return self.padded_graphs * self.bucket

    @property
    def staged_index_bytes(self) -> int:
        """Host->device bytes of the index block (row + col int32 lanes)."""
        return self.index_lanes * 8

    @property
    def store_bytes(self) -> int:
        """Device bytes of the stacked stores after the executor's pow2 row
        pad — with ``staged_index_bytes``, the admission-control footprint."""
        w = self.words_per_slice * 4
        return (pow2_ceil(max(self.row_rows, 1))
                + pow2_ceil(max(self.col_rows, 1))) * w


def plan_fusion(
    jobs,
    *,
    max_bucket: int | None = None,
    pad_graphs_pow2: bool = True,
) -> FusionPlan:
    """Stack ``jobs`` — a sequence of host ``(SlicedBitmap, Worklist)`` —
    into a :class:`FusionPlan` for one shared dispatch.

    Every job must share ``words_per_slice`` (the stores stack row-wise into
    one ``[R, W]`` array). ``bucket`` is the pow2 ceiling of the largest
    worklist; it must satisfy the per-segment int32 bound ``bucket *
    words_per_slice <= INT32_SAFE_WORDS`` and, if given, ``max_bucket``.
    Each violation raises ``ValueError``; callers route such graphs solo.
    """
    jobs = list(jobs)
    if not jobs:
        raise ValueError("plan_fusion needs at least one (sbf, worklist) job")
    wps = int(jobs[0][0].words_per_slice)
    for i, (sb, _) in enumerate(jobs):
        if int(sb.words_per_slice) != wps:
            raise ValueError(
                f"job {i} has words_per_slice={int(sb.words_per_slice)}, "
                f"fusion group requires {wps}; group jobs by word width"
            )
    pairs = [int(wl.num_pairs) for _, wl in jobs]
    bucket = pow2_ceil(max(max(pairs), 1))
    safe = INT32_SAFE_WORDS // max(wps, 1)
    if bucket > safe:
        raise ValueError(
            f"fused bucket {bucket} x {wps} words busts the per-segment "
            f"int32 bound (max safe pairs: {safe}); count the largest "
            "graph solo"
        )
    if max_bucket is not None and bucket > max_bucket:
        raise ValueError(
            f"fused bucket {bucket} exceeds max_bucket={max_bucket}; "
            "route the largest graph solo"
        )
    g = len(jobs)
    g_pad = pow2_ceil(g) if pad_graphs_pow2 else g
    row_idx = np.full((g_pad, bucket), -1, dtype=np.int32)
    col_idx = np.full((g_pad, bucket), -1, dtype=np.int32)
    row_offsets, col_offsets = [], []
    row_base = col_base = 0
    for i, (sb, wl) in enumerate(jobs):
        row_offsets.append(row_base)
        col_offsets.append(col_base)
        n = pairs[i]
        if n:
            row_idx[i, :n] = np.asarray(wl.pair_row_pos[:n], dtype=np.int64) + row_base
            col_idx[i, :n] = np.asarray(wl.pair_col_pos[:n], dtype=np.int64) + col_base
        row_base += int(sb.row_slice_data.shape[0])
        col_base += int(sb.col_slice_data.shape[0])
    return FusionPlan(
        num_graphs=g,
        padded_graphs=g_pad,
        bucket=bucket,
        words_per_slice=wps,
        row_offsets=tuple(row_offsets),
        col_offsets=tuple(col_offsets),
        row_rows=row_base,
        col_rows=col_base,
        row_idx=row_idx.reshape(-1),
        col_idx=col_idx.reshape(-1),
        real_pairs=tuple(pairs),
        stats={
            "num_graphs": g,
            "padded_graphs": g_pad,
            "bucket": bucket,
            "real_pairs": sum(pairs),
            "sentinel_lanes": g_pad * bucket - sum(pairs),
            "reason": f"{g} graphs fused into one [{g_pad}, {bucket}] "
            "segment block; one dispatch, per-graph subtotals",
        },
    )


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


def resolve_placement(
    placement: str,
    sb: sbf_mod.SlicedBitmap,
    topo: DeviceTopology,
) -> str:
    """The concrete placement of ``placement`` for ``sb`` on ``topo``:
    ``ValueError`` for an unknown one, ``NotImplementedError`` for the
    sharded placements, which are not ported yet."""
    if placement not in PLACEMENTS:
        raise ValueError(f"placement {placement!r} not in {PLACEMENTS}")
    resolved = placement
    if placement == "auto" and topo.num_devices <= 1:
        resolved = "replicated"
    elif placement == "auto":
        # Shard when the store crowds one device: above the static
        # threshold, or above half the known per-device memory.
        threshold = DEFAULT_SHARD_ABOVE_BYTES
        if topo.memory_bytes:
            threshold = min(threshold, topo.memory_bytes // 2)
        resolved = "replicated" if sb.data_bytes <= threshold else "sharded_cols"
    if resolved != "replicated":
        raise NotImplementedError(
            f"placement {resolved!r} is not ported yet: {_TODO_SHARDED}"
        )
    return resolved


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
    resolved = resolve_placement(placement, sb, topo)
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
