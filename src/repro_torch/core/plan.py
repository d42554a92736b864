"""ExecutionPlan — placement-aware scheduling for the TCIM execute stage.

Port of ``src/repro/core/plan.py``, name for name, in NumPy: the same
placements (``replicated``, ``sharded_cols``, ``sharded_2d``), range splits
(``even``, ``weighted``, caller-``fixed``), owner-grouped stripes with
shard-local coordinates, int32-safe pow2 chunk buckets, the ``packed`` and
``lockstep`` stripe schedules with their resume cursors
(``StripeSchedule.cursor_after``, ``remaining_worklist``), the fixed-bounds
re-plan of sharded streams (``replan_fixed``) and the cross-graph
``FusionPlan`` of the serving path. Stripes, bounds, schedules and cursors
are byte-equal to the reference's on the same inputs.

``DeviceTopology.detect`` asks torch for the CUDA devices.
``balance_grid_bounds`` fills its per-row and per-column block counts with
``np.bincount`` where the reference calls ``np.add.at``: the same counts,
without ``np.add.at``'s per-element cost on large work lists.

Consumers: ``core.tcim`` routes ``tcim_count*(placement=..., mesh=...)``
through ``plan_execution``; ``distributed.tc`` turns a ``sharded_cols`` /
``sharded_2d`` plan into per-shard store blocks on the mesh's devices and
runs its stripes through ``build_stripe_schedule``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import sbf as sbf_mod
from repro_torch.kernels.ops import INT32_SAFE_WORDS

__all__ = [
    "PLACEMENTS",
    "SPLITS",
    "SCHEDULES",
    "DeviceTopology",
    "WorkStripe",
    "ExecutionPlan",
    "StripeStep",
    "StripeSchedule",
    "build_stripe_schedule",
    "sentinel_row",
    "FusionPlan",
    "plan_fusion",
    "plan_execution",
    "replan_fixed",
    "remaining_worklist",
    "clamp_chunk_pairs",
    "pow2_ceil",
    "shard_col_bounds",
    "even_range_bounds",
    "weighted_range_bounds",
    "bottleneck_range_bounds",
    "balance_grid_bounds",
    "range_owners",
]


def pow2_ceil(x: int) -> int:
    """Smallest power of two >= x (1 for x <= 1) — the bucket rounding every
    layer shares (chunk tails, store rows, sharded step lengths)."""
    return 1 << max(0, (x - 1).bit_length())

# "auto" resolves to one of the concrete placements at planning time.
PLACEMENTS = ("auto", "replicated", "sharded_cols", "sharded_2d")

# Requestable range splits for sharded placements. A plan built from
# caller-fixed bounds records split="fixed" instead (not requestable).
SPLITS = ("even", "weighted")

# Default store size above which "auto" prefers sharding when a multi-device
# topology is available. All SNAP-class graphs (Table III tops out at
# 16.8 MB) stay replicated; a store this large starts to crowd one device.
DEFAULT_SHARD_ABOVE_BYTES = 256 << 20


def clamp_chunk_pairs(chunk_pairs: int, words_per_slice: int) -> int:
    """Largest safe pow2 chunk <= the requested chunk.

    Rounded DOWN to a power of two (never exceed the caller's memory bound),
    then clamped so one chunk's worst case provably fits the int32
    accumulator: ``chunk_pairs * words_per_slice * 32 <= 2**31 - 1``.

    Raises ``ValueError`` when ``words_per_slice`` alone busts the bound —
    then even a single pair could overflow int32 and no chunking helps
    (that is a >2 Gbit slice; shrink ``slice_bits``).
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


def shard_col_bounds(num_col_slices: int, num_shards: int) -> tuple[int, int]:
    """(rows_per_shard, padded_rows) for a contiguous column-store split.

    Every shard owns the same number of rows (equal blocks, one tensor a
    shard in ``distributed.tc``); the store is zero-padded to
    ``padded_rows``. Zero
    rows are harmless: no stripe index ever points at them, and even if one
    did, popcount(0 & x) == 0.
    """
    per = -(-max(num_col_slices, 1) // num_shards)
    return per, per * num_shards


def even_range_bounds(num_records: int, num_shards: int) -> np.ndarray:
    """Contiguous equal-record-count boundaries ``[S+1]`` (the legacy split).

    ``bounds[s]`` is the first store row shard ``s`` owns; matches the
    division-based owner rule (``pos // per``) of ``shard_col_bounds``.
    """
    per, _ = shard_col_bounds(num_records, num_shards)
    return np.minimum(
        np.arange(num_shards + 1, dtype=np.int64) * per, num_records
    )


def weighted_range_bounds(weights: np.ndarray, num_shards: int) -> np.ndarray:
    """Contiguous boundaries ``[S+1]`` balanced by cumulative *weight*.

    ``weights[r]`` is the pair count referencing store row ``r``; the cuts
    land where the prefix sum crosses each ``s/S`` fraction of the total, so
    every range carries a near-equal share of the work (exact to within one
    record's weight). This is the 1-D fix for degree-ordered graphs, whose
    hot leading rows give the even split up to ~4x stripe imbalance.
    """
    w = np.asarray(weights, dtype=np.int64)
    cum = np.concatenate([np.zeros(1, np.int64), np.cumsum(w)])
    targets = (np.arange(1, num_shards, dtype=np.int64) * cum[-1]) // num_shards
    cuts = np.searchsorted(cum, targets, side="left").astype(np.int64)
    bounds = np.concatenate([[0], cuts, [len(w)]]).astype(np.int64)
    np.maximum.accumulate(bounds, out=bounds)
    return bounds


def bottleneck_range_bounds(counts: np.ndarray, num_shards: int) -> np.ndarray:
    """Contiguous split of ``counts``'s rows minimizing the worst block.

    ``counts[r, j]`` is the pair count of store row ``r`` against the
    *other* axis's shard ``j``; the returned boundaries ``[S+1]`` minimize
    ``max over (range, j)`` of the range's column-wise sums — i.e. the
    heaviest ``(row_shard, col_shard)`` block given the other axis's cuts.
    Binary search on the bottleneck with a greedy furthest-extension
    feasibility check (optimal for monotone contiguous partitions).
    """
    n = int(counts.shape[0])
    if n == 0 or counts.size == 0:
        return np.zeros(num_shards + 1, dtype=np.int64)
    pref = np.concatenate(
        [np.zeros((1, counts.shape[1]), np.int64),
         np.cumsum(counts, axis=0, dtype=np.int64)]
    )

    def feasible(limit: int) -> np.ndarray | None:
        bounds = [0]
        cur = 0
        for _ in range(num_shards):
            lo, hi = cur, n
            while lo < hi:  # furthest end keeping every column sum <= limit
                mid = (lo + hi + 1) // 2
                if (pref[mid] - pref[cur] <= limit).all():
                    lo = mid
                else:
                    hi = mid - 1
            if lo == cur and cur < n:
                return None  # a single row already exceeds the limit
            bounds.append(lo)
            cur = lo
            if cur == n:
                bounds += [n] * (num_shards + 1 - len(bounds))
                return np.array(bounds, dtype=np.int64)
        return np.array(bounds, dtype=np.int64) if cur == n else None

    lo = int(counts.max())
    hi = int(pref[-1].max())
    best = feasible(hi)
    while lo < hi:
        mid = (lo + hi) // 2
        cand = feasible(mid)
        if cand is not None:
            best, hi = cand, mid
        else:
            lo = mid + 1
    return best


def range_owners(bounds: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Owner shard of each position under contiguous ``bounds`` ``[S+1]``.

    Duplicate boundaries (empty ranges) resolve to the range that actually
    contains the position, so owners are always in ``[0, S)`` for in-range
    positions.
    """
    return (np.searchsorted(bounds, pos, side="right") - 1).astype(np.int64)


def balance_grid_bounds(
    row_pos: np.ndarray,
    col_pos: np.ndarray,
    num_row_records: int,
    num_col_records: int,
    grid: tuple[int, int],
    *,
    iters: int = 3,
) -> tuple[np.ndarray, np.ndarray]:
    """Weighted 2-D cuts: per-block pair counts near-uniform on both axes.

    Marginal balancing alone is not enough in 2-D — row/col weights are
    correlated on degree-ordered graphs, so independently balanced marginals
    can still leave >1.3x block imbalance. Instead: seed the column axis
    with marginal-weighted cuts, then alternate ``bottleneck_range_bounds``
    on each axis *against the other axis's current owners*, keeping the
    best (lowest max-block) cut pair seen. A few iterations drive the bench
    graphs' 4x2 block imbalance from ~4-5x (even split) to <1.2x.
    """
    rows, cols = grid
    rp = np.asarray(row_pos, dtype=np.int64)
    cp = np.asarray(col_pos, dtype=np.int64)
    col_bounds = weighted_range_bounds(
        np.bincount(cp, minlength=num_col_records), cols
    )
    best: tuple[int, np.ndarray, np.ndarray] | None = None
    total = max(iters, 1)
    for it in range(total):
        col_owner = range_owners(col_bounds, cp)
        by_row = np.bincount(
            rp * cols + col_owner, minlength=num_row_records * cols
        ).reshape(num_row_records, cols)
        row_bounds = bottleneck_range_bounds(by_row, rows)
        row_owner = range_owners(row_bounds, rp)
        blocks = np.bincount(row_owner * cols + col_owner, minlength=rows * cols)
        worst = int(blocks.max()) if blocks.size else 0
        if best is None or worst < best[0]:
            best = (worst, row_bounds.copy(), col_bounds.copy())
        if it == total - 1:
            break  # the col refinement below only feeds the next iteration
        by_col = np.bincount(
            cp * rows + row_owner, minlength=num_col_records * rows
        ).reshape(num_col_records, rows)
        col_bounds = bottleneck_range_bounds(by_col, cols)
    return best[1], best[2]


# Requestable stripe scheduling policies for the sharded execute paths.
SCHEDULES = ("packed", "lockstep")


@dataclasses.dataclass(frozen=True)
class StripeStep:
    """One psum step of a ``StripeSchedule``.

    The step ships a ``[num_shards, bucket]`` index window (flattened
    shard-major so the flat ``P(axis_names)`` sharding deals row ``s`` to
    mesh device ``s``): shard ``s`` contributes its stripe's pairs
    ``[starts[s], starts[s] + lens[s])`` in lanes ``[0, lens[s])`` of its
    row, with every remaining lane padded by the ``-1`` no-op sentinel.
    """

    bucket: int  # pow2 row width of this step's [S, bucket] index window
    starts: tuple[int, ...]  # per-shard stripe cursor at this step
    lens: tuple[int, ...]  # per-shard real pairs this step (each <= bucket)

    @property
    def real_pairs(self) -> int:
        """Non-sentinel pairs this step executes (the psum's work)."""
        return sum(self.lens)


@dataclasses.dataclass(frozen=True)
class StripeSchedule:
    """Per-psum-step windows over a sharded plan's owner stripes.

    ``budget`` bounds the **real** (non-sentinel) pairs per step. That is
    the quantity both per-step costs scale with: the closing sum's
    worst-case total (``real_pairs * words_per_slice * 32`` must fit int32)
    and the gathered-operand traffic (each real pair reads two slices;
    sentinel lanes are masked no-ops costing only 8 index bytes each, and
    the index window itself stays bounded by ``num_shards *
    pow2_ceil(budget)`` lanes). Buckets are pow2, so a schedule dispatches
    at most ``log2(pow2_ceil(budget)) + 1`` distinct step shapes — the
    executors' launch shapes stay in bounded buckets.

    Policies (``SCHEDULES``):

    * ``packed`` — per-shard cursors. Every step picks the widest window
      ``w`` whose real pairs ``sum_s min(w, remaining_s)`` still fit the
      budget, and every shard advances by its own ``min(w, remaining_s)``.
      As shards drain they stop consuming the budget, so the survivors'
      windows grow and the step count approaches the packing lower bound
      ``ceil(total_pairs / budget)``. Never more steps than ``lockstep``:
      the packed window is always >= the lockstep window (``budget //
      num_shards`` is always budget-feasible), so every cursor advances at
      least as fast.
    * ``lockstep`` — the legacy shared ``[start, start + window)`` walk
      with the fixed per-shard window ``budget // num_shards``; costs
      ``ceil(longest_stripe / window)`` steps, every stripe padded to the
      longest. Kept as the baseline the packed policy is compared
      against.
    """

    policy: str  # "packed" | "lockstep"
    num_shards: int
    budget: int  # max real pairs per step (int32- and memory-bounded)
    steps: tuple[StripeStep, ...]

    @property
    def num_steps(self) -> int:
        return len(self.steps)

    @property
    def total_pairs(self) -> int:
        return sum(s.real_pairs for s in self.steps)

    @property
    def max_step_pairs(self) -> int:
        """Worst per-step real-pair load (<= budget except the width-1 floor)."""
        return max((s.real_pairs for s in self.steps), default=0)

    @property
    def total_lanes(self) -> int:
        """Staged index lanes over the whole schedule, sentinels included —
        the host->device index traffic is 8 bytes per lane."""
        return sum(self.num_shards * s.bucket for s in self.steps)

    @property
    def staged_lanes(self) -> int:
        """Index lanes ``emit_compact`` actually materializes host-side.

        A shard with ``lens[s] == 0`` at a step is drained (packed) or
        idling (lockstep): its row of the ``[S, bucket]`` window is all
        sentinel, and the compact emission serves it from one shared cached
        buffer per bucket instead of re-filling and re-copying it every
        remaining step. ``total_lanes - staged_lanes`` is the budget-aware
        saving."""
        return sum(
            sum(1 for n in s.lens if n) * s.bucket for s in self.steps
        )

    def cursor_after(self, num_steps: int) -> tuple[int, ...]:
        """Per-shard consumed-pair offsets after the first ``num_steps``.

        THE serializable progress cursor: the schedule is deterministic
        given (stripe lengths, budget, policy), and both policies advance
        each shard contiguously, so ``cursor_after(k)[s]`` is exactly the
        count of shard ``s``'s stripe pairs executed by steps ``[0, k)`` —
        a resumable count checkpoints this tuple plus the committed total,
        and recovery re-executes only each stripe's ``[cursor, end)`` tail.
        """
        if not 0 <= num_steps <= len(self.steps):
            raise ValueError(
                f"num_steps must be in [0, {len(self.steps)}], got {num_steps}"
            )
        if num_steps == 0:
            return (0,) * self.num_shards
        last = self.steps[num_steps - 1]
        return tuple(s + n for s, n in zip(last.starts, last.lens))

    def emit(self, stripes: tuple["WorkStripe", ...], start_step: int = 0):
        """Yield per-step host ``(ridx, cidx)`` flat int32 arrays.

        ``stripes`` must be the same owner stripes the schedule was built
        from (one per shard, in shard order). Each yielded pair flattens
        the ``[num_shards, bucket]`` window shard-major. ``start_step``
        skips the first steps — the same-schedule resume path, bit-identical
        to slicing the full emission.
        """
        if len(stripes) != self.num_shards:
            raise ValueError(
                f"schedule built for {self.num_shards} stripes, got "
                f"{len(stripes)}"
            )
        for step in self.steps[start_step:]:
            ridx = np.full((self.num_shards, step.bucket), -1, dtype=np.int32)
            cidx = np.full((self.num_shards, step.bucket), -1, dtype=np.int32)
            for s, stripe in enumerate(stripes):
                lo, n = step.starts[s], step.lens[s]
                if n:
                    ridx[s, :n] = stripe.row_pos[lo : lo + n]
                    cidx[s, :n] = stripe.col_pos[lo : lo + n]
            yield ridx.reshape(-1), cidx.reshape(-1)

    def emit_compact(self, stripes: tuple["WorkStripe", ...], start_step: int = 0):
        """Yield per-step ``(bucket, row_rows, col_rows)`` — the budget-aware
        emission. ``row_rows``/``col_rows`` are length-``num_shards`` lists
        of ``[bucket]`` int32 rows of the step's index window; a drained or
        idle shard's all-sentinel row is the shared read-only buffer from
        ``sentinel_row(bucket)``, materialized once per bucket per process
        instead of refilled per step (see ``staged_lanes``). Assembling a
        device array from these rows is bit-identical to ``emit``'s dense
        flat window — ``distributed.tc`` does exactly that, per shard."""
        if len(stripes) != self.num_shards:
            raise ValueError(
                f"schedule built for {self.num_shards} stripes, got "
                f"{len(stripes)}"
            )
        for step in self.steps[start_step:]:
            sent = sentinel_row(step.bucket)
            row_rows: list[np.ndarray] = []
            col_rows: list[np.ndarray] = []
            for s, stripe in enumerate(stripes):
                lo, n = step.starts[s], step.lens[s]
                if n == 0:
                    row_rows.append(sent)
                    col_rows.append(sent)
                    continue
                r = np.full(step.bucket, -1, dtype=np.int32)
                c = np.full(step.bucket, -1, dtype=np.int32)
                r[:n] = stripe.row_pos[lo : lo + n]
                c[:n] = stripe.col_pos[lo : lo + n]
                row_rows.append(r)
                col_rows.append(c)
            yield step.bucket, row_rows, col_rows


_SENTINEL_ROWS: dict[int, np.ndarray] = {}


def sentinel_row(bucket: int) -> np.ndarray:
    """The shared all-``-1`` ``[bucket]`` int32 row (read-only, cached).

    ``StripeSchedule.emit_compact`` hands this one buffer out for every
    drained shard at every step, so sentinel lanes cost zero host fills and
    zero fresh allocations after the first step that needs the bucket."""
    row = _SENTINEL_ROWS.get(bucket)
    if row is None:
        row = np.full(bucket, -1, dtype=np.int32)
        row.setflags(write=False)
        _SENTINEL_ROWS[bucket] = row
    return row


def _packed_window(remaining: list[int], budget: int) -> int:
    """Widest per-shard window whose real pairs fit the step budget.

    Largest ``w >= 1`` with ``sum_s min(w, remaining_s) <= budget`` (the sum
    is monotone in ``w``, so binary search); floors at 1 so a step always
    makes progress even when more shards are active than the budget covers.
    """
    lo, hi = 1, max(budget, 1)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if sum(min(mid, r) for r in remaining) <= budget:
            lo = mid
        else:
            hi = mid - 1
    return lo


def build_stripe_schedule(
    stripe_lens, budget: int, *, policy: str = "packed"
) -> StripeSchedule:
    """Schedule per-shard stripe windows into psum steps (see StripeSchedule).

    ``stripe_lens`` is the per-shard pair count (one entry per owner stripe,
    in shard order); ``budget`` the max real pairs per step.
    """
    if policy not in SCHEDULES:
        raise ValueError(f"schedule {policy!r} not in {SCHEDULES}")
    lens = [int(x) for x in stripe_lens]
    if any(n < 0 for n in lens):
        raise ValueError(f"stripe lengths must be >= 0, got {lens}")
    num_shards = len(lens)
    budget = max(int(budget), 1)
    steps: list[StripeStep] = []
    if policy == "lockstep":
        longest = max(lens, default=0)
        window = max(budget // max(num_shards, 1), 1)
        for start in range(0, longest, window):
            need = min(window, longest - start)
            steps.append(
                StripeStep(
                    bucket=pow2_ceil(need),
                    starts=tuple(min(start, n) for n in lens),
                    lens=tuple(min(max(n - start, 0), need) for n in lens),
                )
            )
    else:  # packed
        cursors = [0] * num_shards
        remaining = lens[:]
        while any(remaining):
            w = _packed_window(remaining, budget)
            step_lens = tuple(min(w, r) for r in remaining)
            steps.append(
                StripeStep(
                    bucket=pow2_ceil(max(step_lens)),
                    starts=tuple(cursors),
                    lens=step_lens,
                )
            )
            for s, n in enumerate(step_lens):
                cursors[s] += n
                remaining[s] -= n
    return StripeSchedule(
        policy=policy, num_shards=num_shards, budget=budget, steps=tuple(steps)
    )


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    """Cross-graph fusion: many small graphs' worklists as ONE index block.

    The multi-tenant analogue of TCIM's array packing: instead of one
    dispatch (and one closing reduction) per graph, ``G`` graphs' pow2-
    bucketed worklists are stacked into a shared ``[G, bucket]`` index
    block — each graph owns one ``bucket``-wide segment, sentinel-padded —
    and their slice stores are stacked row-wise with per-graph segment
    offsets baked into the indices. One
    ``popcount_and_gather_segment_totals`` dispatch then returns every
    graph's int32 subtotal (``kernels/tc_gather_popcount.py``).

    ``G`` is itself padded to a power of two with all-sentinel segments
    (``padded_graphs``), and the executor pads the stacked store rows to
    pow2 buckets, so fused batches launch only per (bucket, padded_graphs,
    store bucket, words) combination of shapes.
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
    words_per_slice <= INT32_SAFE_WORDS`` and, if given, ``max_bucket`` —
    callers route graphs that exceed either solo (``launch.tc_serve``'s
    admission does both checks up front).
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
            row_idx[i, :n] = (
                np.asarray(wl.pair_row_pos[:n], dtype=np.int64) + row_base
            )
            col_idx[i, :n] = (
                np.asarray(wl.pair_col_pos[:n], dtype=np.int64) + col_base
            )
        row_base += int(sb.row_slice_data.shape[0])
        col_base += int(sb.col_slice_data.shape[0])
    plan = FusionPlan(
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
    return plan


@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """What the planner knows about the machine (mesh-agnostic)."""

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
    """The pairs one owner shard (or owner-grid block) executes.

    For ``sharded_cols``: ``col_pos`` is *local* to the owning shard's
    contiguous row range; ``row_pos`` stays global (the row store is
    replicated). For ``sharded_2d``: BOTH coordinates are local to the
    ``(row_shard, col_shard)`` block's ranges. For a ``replicated`` plan
    there is exactly one stripe with global coordinates.
    """

    shard: int  # flat index: row_shard * col_shards + col_shard
    row_pos: np.ndarray  # int32 [P_s]
    col_pos: np.ndarray  # int32 [P_s]
    row_shard: int = 0
    col_shard: int = 0

    @property
    def num_pairs(self) -> int:
        return int(len(self.row_pos))


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    placement: str  # resolved: "replicated" | "sharded_cols" | "sharded_2d"
    num_shards: int  # grid[0] * grid[1]
    chunk_pairs: int  # pow2, int32-safe
    words_per_slice: int
    col_shard_rows: int  # rows per col-store shard after padding (0 = replicated)
    stripes: tuple[WorkStripe, ...]
    stats: dict
    grid: tuple[int, int] = (1, 1)  # (row_shards, col_shards)
    row_shard_rows: int = 0  # rows per row-store shard (sharded_2d only)
    split: str = "even"  # "even" | "weighted" | "fixed" (caller bounds)
    # Contiguous store-row boundaries per axis, [shards+1]; None when the
    # axis is replicated. Executors verify these before trusting the
    # stripes' shard-local coordinates against their resident blocks.
    row_bounds: np.ndarray | None = None
    col_bounds: np.ndarray | None = None

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
    shard_above_bytes: int,
    grid: tuple[int, int] | None,
) -> str:
    if placement not in PLACEMENTS:
        raise ValueError(f"placement {placement!r} not in {PLACEMENTS}")
    if placement != "auto":
        return placement
    if topo.num_devices <= 1:
        return "replicated"
    # Shard when the store crowds one device: above the static threshold, or
    # above half the known per-device memory.
    threshold = shard_above_bytes
    if topo.memory_bytes:
        threshold = min(threshold, topo.memory_bytes // 2)
    if sb.data_bytes <= threshold:
        return "replicated"
    # A genuinely 2-D grid (both axes > 1) shards the row store too — the
    # only placement whose per-device footprint shrinks on BOTH stores.
    if grid is not None and min(grid) > 1:
        return "sharded_2d"
    return "sharded_cols"


def _validate_bounds(
    bounds: np.ndarray, num_shards: int, num_records: int, axis: str
) -> np.ndarray:
    b = np.asarray(bounds, dtype=np.int64)
    if (
        b.shape != (num_shards + 1,)
        or b[0] != 0
        or b[-1] != num_records
        or (np.diff(b) < 0).any()
    ):
        raise ValueError(
            f"{axis}_bounds must be monotone [0..{num_records}] with "
            f"{num_shards + 1} entries, got {b!r}"
        )
    return b


def plan_execution(
    sb: sbf_mod.SlicedBitmap,
    wl: sbf_mod.Worklist,
    topo: DeviceTopology | None = None,
    *,
    placement: str = "auto",
    chunk_pairs: int = 1 << 20,
    num_shards: int | None = None,
    shard_above_bytes: int = DEFAULT_SHARD_ABOVE_BYTES,
    grid: tuple[int, int] | None = None,
    split: str | None = None,
    row_bounds: np.ndarray | None = None,
    col_bounds: np.ndarray | None = None,
    balance_iters: int = 3,
) -> ExecutionPlan:
    """Choose placement, owner-group the work list, and pick chunk buckets.

    ``num_shards`` defaults to the topology's device count for sharded
    placement; pass it explicitly to plan for a sub-mesh. ``grid`` is the
    ``(row_shards, col_shards)`` owner grid for ``sharded_2d`` (required
    there; it also steers ``auto`` toward 2-D when both axes exceed 1).
    ``split`` picks the range partitioning for ``sharded_2d``: ``weighted``
    (default — pair-count-balanced ranges) or ``even`` (the legacy
    contiguous equal-record split, kept for comparison). Passing
    ``row_bounds``/``col_bounds`` (both or neither) pins the cuts instead —
    how executors re-plan new work lists against already-sharded stores.
    """
    topo = topo or DeviceTopology.detect()
    wps = int(sb.words_per_slice)
    chunk = clamp_chunk_pairs(chunk_pairs, wps)
    if split is not None and split not in SPLITS:
        raise ValueError(f"split {split!r} not in {SPLITS}")
    if (row_bounds is None) != (col_bounds is None):
        raise ValueError("pass row_bounds and col_bounds together or not at all")
    resolved = _resolve_placement(placement, sb, topo, shard_above_bytes, grid)

    row_pos = np.asarray(wl.pair_row_pos, dtype=np.int32)
    col_pos = np.asarray(wl.pair_col_pos, dtype=np.int32)

    if resolved == "replicated":
        stripes = (WorkStripe(shard=0, row_pos=row_pos, col_pos=col_pos),)
        return ExecutionPlan(
            placement=resolved,
            num_shards=1,
            chunk_pairs=chunk,
            words_per_slice=wps,
            col_shard_rows=0,
            stripes=stripes,
            stats={
                "store_bytes": sb.data_bytes,
                "num_pairs": wl.num_pairs,
                "reason": "single stripe; stores replicated",
            },
        )

    if resolved == "sharded_2d":
        return _plan_sharded_2d(
            sb, wl, row_pos, col_pos, chunk, wps,
            grid=grid,
            num_shards=num_shards,
            split=split,
            row_bounds=row_bounds,
            col_bounds=col_bounds,
            balance_iters=balance_iters,
        )

    # sharded_cols: the 1-D legacy placement keeps its even contiguous
    # split (its executor's store layout is worklist-independent); weighted
    # 1-D splits are sharded_2d with grid=(1, S).
    if split == "weighted":
        raise ValueError(
            "sharded_cols only supports the even split; for weighted "
            "(pair-count-balanced) ranges use placement='sharded_2d' with "
            "grid=(1, num_shards)"
        )
    shards = int(num_shards or topo.num_devices)
    if shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {shards}")
    ncol = len(sb.col_slice_idx)
    per, _padded = shard_col_bounds(ncol, shards)
    owner = col_pos // per  # contiguous ranges -> owner is a division
    stripes = []
    for s in range(shards):
        sel = owner == s
        stripes.append(
            WorkStripe(
                shard=s,
                row_pos=row_pos[sel],
                col_pos=col_pos[sel] - s * per,  # shard-local coordinates
                row_shard=0,
                col_shard=s,
            )
        )
    plan = ExecutionPlan(
        placement=resolved,
        num_shards=shards,
        chunk_pairs=chunk,
        words_per_slice=wps,
        col_shard_rows=per,
        stripes=tuple(stripes),
        grid=(1, shards),
        split="even",
        col_bounds=even_range_bounds(ncol, shards),
        stats={
            "store_bytes": sb.data_bytes,
            "num_pairs": wl.num_pairs,
            "stripe_pairs": [s.num_pairs for s in stripes],
            "reason": "col store sharded into contiguous row ranges; "
            "pairs owner-grouped so no per-step all-gather",
        },
    )
    assert plan.total_pairs == wl.num_pairs
    return plan


def replan_fixed(
    plan: ExecutionPlan,
    sb: sbf_mod.SlicedBitmap,
    wl: sbf_mod.Worklist,
    *,
    chunk_pairs: int | None = None,
) -> ExecutionPlan:
    """Re-plan a new work list against an existing plan's resident bounds.

    The streaming primitive for sharded placements: a delta batch's touched
    pairs are a fresh (small) work list, but the sharded executor's stores
    are already resident under ``plan``'s range bounds — so the delta plan
    must pin those bounds (``split='fixed'``) rather than re-balance, or
    the stripes' shard-local coordinates would not match the uploaded
    blocks. Only ``sharded_2d`` plans carry bounds on both axes.
    """
    if plan.placement != "sharded_2d":
        raise ValueError(
            f"replan_fixed needs a sharded_2d plan, got {plan.placement!r}"
        )
    return plan_execution(
        sb,
        wl,
        DeviceTopology(num_devices=plan.num_shards),
        placement="sharded_2d",
        grid=plan.grid,
        chunk_pairs=plan.chunk_pairs if chunk_pairs is None else chunk_pairs,
        row_bounds=plan.row_bounds,
        col_bounds=plan.col_bounds,
    )


def remaining_worklist(
    plan: ExecutionPlan,
    shard_cursors=None,
    *,
    m_edges: int = 0,
    n_slices: int = 0,
) -> sbf_mod.Worklist:
    """Rebuild a *global-coordinate* work list from a plan's stripe tails.

    ``shard_cursors[s]`` is the consumed-pair offset of stripe ``s``
    (``StripeSchedule.cursor_after``; ``None`` means nothing consumed —
    the full plan worklist). The stripes' shard-local coordinates are
    lifted back to store-global positions via the plan's bounds, so the
    result can be re-planned onto ANY grid — the elastic-recovery step:
    the uncounted pairs, as a fresh worklist, for a fresh mesh. Exact
    because the stripes partition the original pair multiset and the
    schedule consumes each stripe contiguously.

    ``pair_edge`` is synthesized as zeros (the planner and executors only
    read positions); pass ``m_edges``/``n_slices`` to keep the reduction
    stats meaningful when known.
    """
    if shard_cursors is None:
        cursors = [0] * len(plan.stripes)
    else:
        cursors = [int(c) for c in shard_cursors]
    if len(cursors) != len(plan.stripes):
        raise ValueError(
            f"{len(cursors)} cursors for {len(plan.stripes)} stripes"
        )
    rows, cols = [], []
    for cur, stripe in zip(cursors, plan.stripes):
        if not 0 <= cur <= stripe.num_pairs:
            raise ValueError(
                f"cursor {cur} out of range for stripe {stripe.shard} "
                f"({stripe.num_pairs} pairs)"
            )
        rp = stripe.row_pos[cur:].astype(np.int64)
        cp = stripe.col_pos[cur:].astype(np.int64)
        if plan.row_bounds is not None:
            rp = rp + int(plan.row_bounds[stripe.row_shard])
        if plan.col_bounds is not None:
            cp = cp + int(plan.col_bounds[stripe.col_shard])
        rows.append(rp)
        cols.append(cp)
    pr = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    pc = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    return sbf_mod.Worklist(
        pair_edge=np.zeros(len(pr), np.int64),
        pair_row_pos=pr,
        pair_col_pos=pc,
        m_edges=int(m_edges),
        n_slices=int(n_slices),
    )


def _plan_sharded_2d(
    sb: sbf_mod.SlicedBitmap,
    wl: sbf_mod.Worklist,
    row_pos: np.ndarray,
    col_pos: np.ndarray,
    chunk: int,
    wps: int,
    *,
    grid: tuple[int, int] | None,
    num_shards: int | None,
    split: str | None,
    row_bounds: np.ndarray | None,
    col_bounds: np.ndarray | None,
    balance_iters: int,
) -> ExecutionPlan:
    """Owner-grid planning: weighted (or even/fixed) ranges on both axes,
    every pair routed to its ``(row_shard, col_shard)`` block with
    block-local coordinates on both sides."""
    if grid is None:
        raise ValueError(
            "placement 'sharded_2d' needs grid=(row_shards, col_shards) — "
            "pass a 2-axis mesh to tcim_count*, or grid= here"
        )
    rows, cols = int(grid[0]), int(grid[1])
    if rows < 1 or cols < 1:
        raise ValueError(f"grid axes must be >= 1, got {(rows, cols)}")
    shards = rows * cols
    if num_shards is not None and int(num_shards) != shards:
        raise ValueError(
            f"num_shards={num_shards} contradicts grid {rows}x{cols}={shards}"
        )
    nrow = len(sb.row_slice_idx)
    ncol = len(sb.col_slice_idx)
    if row_bounds is not None:
        resolved_split = "fixed"
        rb = _validate_bounds(row_bounds, rows, nrow, "row")
        cb = _validate_bounds(col_bounds, cols, ncol, "col")
    elif (split or "weighted") == "weighted":
        resolved_split = "weighted"
        rb, cb = balance_grid_bounds(
            row_pos, col_pos, nrow, ncol, (rows, cols), iters=balance_iters
        )
    else:
        resolved_split = "even"
        rb = even_range_bounds(nrow, rows)
        cb = even_range_bounds(ncol, cols)
    # Equal blocks: every shard's range is padded to the pow2 bucket of the
    # longest range on its axis (pow2 so the block shape is stable across
    # work lists).
    row_block = pow2_ceil(max(int(np.diff(rb).max(initial=0)), 1))
    col_block = pow2_ceil(max(int(np.diff(cb).max(initial=0)), 1))
    row_owner = range_owners(rb, row_pos)
    col_owner = range_owners(cb, col_pos)
    stripes = []
    for r in range(rows):
        for c in range(cols):
            sel = (row_owner == r) & (col_owner == c)
            stripes.append(
                WorkStripe(
                    shard=r * cols + c,
                    row_pos=(row_pos[sel] - rb[r]).astype(np.int32),
                    col_pos=(col_pos[sel] - cb[c]).astype(np.int32),
                    row_shard=r,
                    col_shard=c,
                )
            )
    plan = ExecutionPlan(
        placement="sharded_2d",
        num_shards=shards,
        chunk_pairs=chunk,
        words_per_slice=wps,
        col_shard_rows=col_block,
        stripes=tuple(stripes),
        grid=(rows, cols),
        row_shard_rows=row_block,
        split=resolved_split,
        row_bounds=rb,
        col_bounds=cb,
        stats={
            "store_bytes": sb.data_bytes,
            "num_pairs": wl.num_pairs,
            "stripe_pairs": [s.num_pairs for s in stripes],
            "split": resolved_split,
            "reason": "both stores sharded into contiguous ranges over the "
            f"{rows}x{cols} owner grid; pairs routed to their "
            "(row_shard, col_shard) block — owner-compute, no all-gather",
        },
    )
    assert plan.total_pairs == wl.num_pairs
    return plan
