"""Distributed TCIM: shard the work list over a mesh, sum one int32 row a step.

Port of ``src/repro/distributed/tc.py``. TCIM's reduction is a commutative
monoid (integer +), so the parallelization is embarrassing at slice-pair
granularity: every shard owns a stripe of the work list, gathers its slice
words, runs the AND+BitCount kernel locally, and one exact sum closes each
step. The reference is single-controller — one process, ``shard_map`` over
the mesh, a scalar ``psum`` a step — and so is the port: one process walks
the mesh's shards (``distributed.mesh.Mesh``), no process group.

Per step, every shard launches the ``gather_total`` CUDA kernel on its own
device, with that device current, into the step's row of an int32
``[steps, 2]`` accumulator on that device (``[total, out_of_range]``).
Shards on one device share the row: the kernel adds into it. The step
budget keeps each row's worst case inside int32, as the reference's psum
does. ``CountFuture.result()`` reads each device's accumulator back once
and sums the rows exactly in Python ints; an out-of-range index anywhere
raises ``ValueError`` there. On the CPU the shards run
``gather_total_reference`` with the same contract. Nothing reads the
device between the first upload and ``result()``.

Slice data placement (chosen by ``core.plan.plan_execution``):
  * ``replicated`` — both stores on every device of the mesh; each step's
    pairs are dealt across the shards (``shard_worklist``).
  * ``sharded_cols`` — the column store split into contiguous ranges, one
    zero-padded ``[col_shard_rows, W]`` block per shard on its device; the
    row store replicated on each device. Pairs run on the shard that owns
    their column slice, with shard-local column positions.
  * ``sharded_2d`` — BOTH stores split over a 2-axis ``(row, col)`` grid:
    shard ``(i, j)`` reads row block ``i`` and column block ``j`` (one copy
    of a block per device that needs it), with block-local coordinates on
    both sides and pair-count-weighted ranges.

Where the reference repacks a store into equal blocks and shards dim 0,
the port keeps one tensor per block; the block-local coordinates are the
same, and ``Sharded2DExecutor.update_stores`` remaps a lane to
``(owner block, local row)`` where the reference computes
``owner * shard_rows + local``. Each shard's row of a step's index window
(``StripeSchedule.emit_compact``) is one pinned, non-blocking upload to its
device; a drained shard (an all-sentinel row) counts zero and is neither
uploaded nor launched, so a count launches ``step_launches(schedule)``
kernels. Each shard's ``GatherTotalLauncher`` is built once with the
executor.
"""
from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

from repro_torch.core.executor import (
    CountFuture,
    apply_store_lanes,
    sbf_content_key,
    staged_uploads,
)
from repro_torch.core.plan import (
    SCHEDULES,
    DeviceTopology,
    ExecutionPlan,
    StripeSchedule,
    build_stripe_schedule,
    even_range_bounds,
    plan_execution,
    pow2_ceil as _pow2_ceil,
    replan_fixed,
    shard_col_bounds,
)
from repro_torch.core.sbf import SlicedBitmap, UpdateLanes, Worklist
from repro_torch.distributed.mesh import Mesh
from repro_torch.kernels.ops import INT32_SAFE_WORDS
from repro_torch.kernels.tc_gather_popcount import (
    GatherTotalLauncher,
    gather_total_reference,
)
from repro_torch.runtime.contracts import no_host_sync, note_retrace
from repro_torch.runtime.fault import CountInterrupted
from repro_torch.runtime.staging import stage

__all__ = [
    "shard_worklist",
    "distributed_tc_count",
    "distributed_tc_count_async",
    "ShardedColsExecutor",
    "Sharded2DExecutor",
    "pooled_sharded_executor",
    "pooled_sharded_2d_executor",
    "clear_sharded_executor_cache",
    "remap_lanes",
    "step_launches",
    "TC_PLACEMENTS",
]

TC_PLACEMENTS = ("replicated", "sharded_cols", "sharded_2d")

# Bytes one store-edit lane uploads (core.executor.apply_store_lanes).
_LANE_BYTES = 24


def shard_worklist(wl: Worklist, num_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad the pair index arrays to a multiple of num_shards and stack.

    Padding lanes hold the ``-1`` no-op sentinel. Returns (row_pos [S, ppd],
    col_pos [S, ppd]) int32.
    """
    p = wl.num_pairs
    per = -(-max(p, 1) // num_shards)
    total = per * num_shards
    row = np.full(total, -1, dtype=np.int32)
    col = np.full(total, -1, dtype=np.int32)
    row[:p] = wl.pair_row_pos.astype(np.int32)
    col[:p] = wl.pair_col_pos.astype(np.int32)
    return row.reshape(num_shards, per), col.reshape(num_shards, per)


def step_launches(sched: StripeSchedule) -> int:
    """Kernel launches of a count under ``sched``: one per shard with real
    pairs in a step (a drained shard's all-sentinel row is skipped)."""
    return sum(1 for step in sched.steps for n in step.lens if n)


def _device_context(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _host_words(store) -> torch.Tensor:
    """A store's uint32 words as an int32 CPU tensor (no copy for host
    arrays; a device store is read back)."""
    if isinstance(store, torch.Tensor):
        return store.cpu()
    return torch.from_numpy(np.ascontiguousarray(store, dtype=np.uint32).view(np.int32))


def _place_block(words: torch.Tensor, lo: int, hi: int, rows: int,
                 device: torch.device) -> torch.Tensor:
    """Rows ``[lo, hi)`` of a store as a zero-padded ``[rows, W]`` block on
    ``device`` (zero rows are exact no-ops: nothing indexes them, and
    ``popcount(0 & x) == 0``). Always a fresh tensor, so an in-place store
    edit never touches the caller's arrays."""
    block = torch.zeros((rows, words.shape[1]), dtype=torch.int32)
    block[: hi - lo] = words[lo:hi]
    return stage(block, device, non_blocking=False)


def _upload_indices(ridx: np.ndarray, cidx: np.ndarray, device: torch.device):
    """One shard's index row to its device: a ``[2, P]`` int32 tensor, on
    the card one pinned, non-blocking copy on the current stream."""
    with _device_context(device):
        pair = stage(np.stack([ridx, cidx]).astype(np.int32, copy=False), device)
    return pair[0], pair[1]


class _Shard:
    """One shard's resident store blocks and its step on its device."""

    __slots__ = ("device", "row", "col", "launcher")

    def __init__(self, device: torch.device, row: torch.Tensor, col: torch.Tensor):
        self.device, self.row, self.col = device, row, col
        # On the card the kernel's launcher, its stores validated once: a
        # retrace event (``max_retrace``) on every device.
        note_retrace()
        self.launcher = GatherTotalLauncher(row, col) if device.type == "cuda" else None

    def step(self, out: torch.Tensor, ridx: torch.Tensor, cidx: torch.Tensor) -> None:
        """``out += [total, out_of_range]`` of the pairs (inside the
        device's context on the card)."""
        if self.launcher is None:
            out += gather_total_reference(self.row, self.col, ridx, cidx)
        else:
            self.launcher.bind(out)(ridx, cidx)


class _StripeScheduleDriver:
    """Shared sharded execute driver: schedule -> staged uploads -> close.

    Both sharded executors hold per-shard store blocks (``_shards``) and
    plan validation (``_check_plan``); this mixin owns everything
    placement-independent:

    * **Stripe scheduling.** ``count_plan*`` runs the plan's owner stripes
      through ``core.plan.build_stripe_schedule`` under the executor's
      ``schedule`` policy (``packed`` by default; ``lockstep`` is the
      shared-window baseline). The step budget is the caller's memory bound
      AND the int32 bound: ``min(plan.chunk_pairs, chunk_pairs,
      INT32_SAFE_WORDS // words_per_slice)`` real pairs per step, over all
      shards.
    * **Async close.** ``count_plan_async`` returns a ``CountFuture`` with
      every step launched (index rows staged one step ahead); the host
      readback happens at ``result()``.

    ``launches`` counts the shard launches (on the card and on the CPU),
    ``index_upload_bytes`` the index rows staged, ``store_upload_bytes`` the
    store blocks placed and ``lane_upload_bytes`` the store edits.
    """

    def _init_counters(self) -> None:
        self.launches = 0
        self.index_upload_bytes = 0
        self.store_upload_bytes = 0
        self.lane_upload_bytes = 0

    def _place(self, words: torch.Tensor, lo: int, hi: int, rows: int,
               device: torch.device) -> torch.Tensor:
        """``_place_block``, counted in ``store_upload_bytes``."""
        self.store_upload_bytes += rows * words.shape[1] * 4
        return _place_block(words, lo, hi, rows, device)

    def _validate_int32_floor(self, noun: str, remedy: str) -> None:
        """Constructor guard: the packed scheduler's width-1 progress floor
        can put one pair from EVERY shard in a step, so even that worst
        case must fit the step's int32 accumulator row."""
        safe = INT32_SAFE_WORDS // max(self.words_per_slice, 1)
        if safe // self.num_shards < 1:
            raise ValueError(
                f"words_per_slice={self.words_per_slice} x {self.num_shards} "
                f"{noun} cannot give every {noun.rstrip('s')} even one "
                f"int32-safe pair per step (INT32_SAFE_WORDS="
                f"{INT32_SAFE_WORDS}); use a smaller slice_bits or {remedy}"
            )

    def stripe_schedule(self, plan: ExecutionPlan) -> StripeSchedule:
        """The schedule ``count_plan`` would run for this plan.

        The budget honors BOTH memory bounds — the plan's and the
        executor's own ``chunk_pairs`` — plus the int32 bound.
        """
        safe = INT32_SAFE_WORDS // max(self.words_per_slice, 1)
        budget = min(max(plan.chunk_pairs, 1), max(self.chunk_pairs, 1), safe)
        return build_stripe_schedule(
            [s.num_pairs for s in plan.stripes], budget, policy=self.schedule
        )

    def _put_step(self, item) -> list:
        """One step's non-empty index rows on their shards' devices."""
        step, (_, row_rows, col_rows) = item
        window = []
        for s, n in enumerate(step.lens):
            if n:
                ridx, cidx = _upload_indices(row_rows[s], col_rows[s], self._shards[s].device)
                self.index_upload_bytes += 8 * len(row_rows[s])
                window.append((s, ridx, cidx))
        return window

    def _staged_windows(self, sched: StripeSchedule, plan: ExecutionPlan, start_step: int = 0):
        """Index windows from the *compact* emission, staged one step ahead
        of the launches (``staged_uploads``); drained shards' rows stay on
        the host."""
        emitted = zip(sched.steps[start_step:], sched.emit_compact(plan.stripes, start_step))
        return staged_uploads(emitted, self._put_step, double_buffer=self.double_buffer)

    def _new_accs(self, steps: int) -> dict:
        """A zeroed int32 ``[steps, 2]`` accumulator on each device."""
        return {
            d: torch.zeros((steps, 2), dtype=torch.int32, device=d)
            for d in self.mesh.unique_devices
        }

    def _dispatch(self, window: list, accs: dict, row: int) -> None:
        """Launch one step: each shard into its device's accumulator row."""
        for s, ridx, cidx in window:
            shard = self._shards[s]
            with _device_context(shard.device):
                shard.step(accs[shard.device][row], ridx, cidx)
            self.launches += 1

    def _sync(self) -> None:
        for d in self.mesh.unique_devices:
            if d.type == "cuda":
                # tclint: sync-ok(a monitored resumable count times each step)
                torch.cuda.synchronize(d)

    @no_host_sync()
    def count_plan_async(self, plan: ExecutionPlan) -> CountFuture:
        """Launch every scheduled step; defer the exact host sum.

        Nothing here reads the device back: the one host sync is the
        ``CountFuture`` close. Contract (``TCIM_CONTRACTS=1``):
        ``no_host_sync``.
        """
        self._check_plan(plan)
        sched = self.stripe_schedule(plan)
        if sched.num_steps == 0:
            return CountFuture([])  # empty worklist: nothing dispatched
        accs = self._new_accs(sched.num_steps)
        for k, window in enumerate(self._staged_windows(sched, plan)):
            self._dispatch(window, accs, k)
        return CountFuture(list(accs.values()))

    def count_plan(self, plan: ExecutionPlan) -> int:
        """Count an owner-grouped plan. One exact host sum at the end."""
        return self.count_plan_async(plan).result()

    def count_plan_resumable(
        self,
        plan: ExecutionPlan,
        *,
        checkpoint_every: int = 8,
        checkpointer=None,
        injector=None,
        monitor=None,
        monitor_interrupts: bool = False,
        start_step: int = 0,
        base_total: int = 0,
        attempt: int = 0,
    ) -> tuple[int, dict]:
        """The checkpointed step loop: every ``checkpoint_every`` steps the
        accumulator rows since the last commit are read back, folded into
        the exact committed total, and the ``(shard_cursors, total)`` cursor
        is saved through ``checkpointer`` (async — file I/O overlaps the
        next steps). Any failure past that point surfaces as
        ``CountInterrupted`` carrying the last committed cursor, so a resume
        replays at most ``checkpoint_every`` steps; replay is exact because
        uncommitted steps contributed nothing to the committed total.

        ``checkpointer`` is duck-typed (``distributed.resilient
        .TCCheckpoint``): ``save_snapshot`` persists the SBF stores + full
        worklist once per attempt, ``save_cursor`` the per-commit cursor.
        ``injector`` (``runtime.fault.FailureInjector``) is checked with the
        step index before each step's launches; ``monitor``
        (``StragglerMonitor``) makes the loop synchronise every step to
        time it, and with ``monitor_interrupts`` a straggler flag commits
        and raises (reason ``"straggler"``). ``start_step`` / ``base_total``
        / ``attempt`` are the same-schedule resume inputs. A ``ValueError``
        (an index past a store's end, a malformed index row) is the
        caller's fault, not a device's, and propagates as it is.

        Returns ``(total, info)``; ``info`` records steps, commits, and the
        step-time EWMA when monitored.
        """
        self._check_plan(plan)
        sched = self.stripe_schedule(plan)
        n = sched.num_steps
        if not 0 <= start_step <= n:
            raise ValueError(f"start_step must be in [0, {n}], got {start_step}")
        every = int(checkpoint_every) if checkpoint_every else 0
        if checkpointer is not None:
            checkpointer.save_snapshot(
                self._sbf, plan, attempt=attempt, base_total=base_total,
                schedule=self.schedule,
            )
        total = int(base_total)
        committed_step = start_step
        accs = self._new_accs(n - start_step) if n > start_step else {}
        info: dict = {
            "steps": n,
            "start_step": start_step,
            "attempt": attempt,
            "checkpoints": 0,
        }

        def commit(upto: int) -> None:
            nonlocal total, committed_step
            if upto > committed_step:
                lo, hi = committed_step - start_step, upto - start_step
                total += CountFuture([a[lo:hi] for a in accs.values()]).result()
            committed_step = upto
            if checkpointer is not None:
                checkpointer.save_cursor(
                    attempt, upto, sched.cursor_after(upto), total, plan
                )
                info["checkpoints"] += 1

        step_i = start_step
        try:
            for window in self._staged_windows(sched, plan, start_step):
                if injector is not None:
                    injector.check(step_i)
                if monitor is not None:
                    monitor.start_step()
                self._dispatch(window, accs, step_i - start_step)
                if monitor is not None:
                    self._sync()
                    flagged = monitor.end_step()
                    ewma = getattr(monitor, "ewma", None)
                    if ewma is not None:
                        info["step_ewma_s"] = float(ewma)
                    if flagged:
                        info["straggler_flags"] = info.get("straggler_flags", 0) + 1
                    if flagged and monitor_interrupts:
                        # The flagged step finished — commit through it so
                        # the remesh replays nothing.
                        commit(step_i + 1)
                        raise CountInterrupted(
                            f"straggler flagged at step {step_i} of {n}",
                            failed_step=step_i + 1,
                            committed_step=committed_step,
                            committed_total=total,
                            shard_cursors=sched.cursor_after(committed_step),
                            reason="straggler",
                            attempt=attempt,
                        )
                step_i += 1
                if every and step_i < n and (step_i - start_step) % every == 0:
                    commit(step_i)
            commit(n)
        except (CountInterrupted, ValueError):
            raise
        except Exception as e:
            raise CountInterrupted(
                f"sharded count failed at step {step_i} of {n}: {e}",
                failed_step=step_i,
                committed_step=committed_step,
                committed_total=total,
                shard_cursors=sched.cursor_after(committed_step),
                reason="failure",
                attempt=attempt,
            ) from e
        return total, info

    def count_resumable(self, wl: Worklist, **kwargs) -> tuple[int, dict]:
        """``count_plan_resumable`` over a work list planned against this
        executor's resident store ranges."""
        return self.count_plan_resumable(self._plan(wl), **kwargs)

    def count_async(self, wl: Worklist) -> CountFuture:
        """``count`` with the final host readback deferred to ``result()``."""
        return self.count_plan_async(self._plan(wl))

    def count(self, wl: Worklist) -> int:
        """Count a work list against the executor's resident stores."""
        return self.count_async(wl).result()

    def shard_stores(self, shard: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Shard ``shard``'s resident ``(row block, col block)`` on its device."""
        s = self._shards[shard]
        return s.row, s.col


def _check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} not in {SCHEDULES}")


class ShardedColsExecutor(_StripeScheduleDriver):
    """Device-resident ``sharded_cols`` execute stage for one mesh.

    Shard ``s`` holds its contiguous block of column slices (``col_shard_rows``
    rows, zero-padded) on mesh device ``s``, placed once; the row store is
    replicated, one copy per distinct device. ``count`` schedules any work
    list through the planner's owner-grouped stripes under the
    ``schedule`` policy (see ``_StripeScheduleDriver``).
    """

    def __init__(
        self,
        sbf: SlicedBitmap,
        mesh: Mesh,
        *,
        chunk_pairs: int = 1 << 20,
        double_buffer: bool = True,
        schedule: str = "packed",
    ):
        _check_schedule(schedule)
        self.schedule = schedule
        self.mesh = mesh
        self.axis_names = tuple(mesh.axis_names)
        self.num_shards = int(np.prod(mesh.devices.shape))
        self.words_per_slice = int(sbf.words_per_slice)
        self.chunk_pairs = chunk_pairs
        self.double_buffer = double_buffer
        self._init_counters()
        ncol = len(sbf.col_slice_idx)
        per, _padded = shard_col_bounds(ncol, self.num_shards)
        self.col_shard_rows = per
        self.col_bounds = even_range_bounds(ncol, self.num_shards)
        row_words = _host_words(sbf.row_slice_data)
        col_words = _host_words(sbf.col_slice_data)
        nrow = int(row_words.shape[0])
        rows = {d: self._place(row_words, 0, nrow, max(nrow, 1), d) for d in mesh.unique_devices}
        self._shards = []
        for s, dev in enumerate(mesh.devices.flat):
            lo, hi = int(self.col_bounds[s]), int(self.col_bounds[s + 1])
            self._shards.append(_Shard(dev, rows[dev], self._place(col_words, lo, hi, per, dev)))
        self._sbf = sbf
        self._validate_int32_floor("shards", "fewer shards")

    def _plan(self, wl: Worklist) -> ExecutionPlan:
        return plan_execution(
            self._sbf,
            wl,
            DeviceTopology(num_devices=self.num_shards, platform=self.mesh.platform),
            placement="sharded_cols",
            num_shards=self.num_shards,
            chunk_pairs=self.chunk_pairs,
        )

    def _check_plan(self, plan: ExecutionPlan) -> None:
        if plan.placement != "sharded_cols":
            raise ValueError(
                f"plan placement {plan.placement!r} is not 'sharded_cols'"
            )
        if plan.num_shards != self.num_shards:
            raise ValueError(
                f"plan has {plan.num_shards} shards, mesh has {self.num_shards}"
            )
        if plan.col_shard_rows != self.col_shard_rows or (
            plan.col_bounds is not None
            and not np.array_equal(plan.col_bounds, self.col_bounds)
        ):
            raise ValueError(
                "plan's shard-local coordinates assume different column "
                f"ranges (rows/shard {plan.col_shard_rows} vs "
                f"{self.col_shard_rows}); the plan was built for a different "
                "SBF, shard count, or split"
            )


def remap_lanes(lanes: UpdateLanes | None, bounds: np.ndarray, side: str):
    """Global-record lanes -> ``(owner block, UpdateLanes in block-local
    rows)``; ``None`` when there are no lanes.

    The owner is found by binary search over the resident range bounds.
    Raises ``ValueError`` for a position outside the resident record range
    (the SBF grew). The reference's flat row is ``owner * shard_rows +
    local``.
    """
    if lanes is None or lanes.num_lanes == 0:
        return None
    pos = lanes.pos.astype(np.int64)
    if pos.max(initial=0) >= int(bounds[-1]) or pos.min(initial=0) < 0:
        raise ValueError(
            f"{side} lane positions exceed the resident record "
            "range — the SBF grew; rebuild the sharded executor"
        )
    owner = np.searchsorted(bounds, pos, side="right") - 1
    local = UpdateLanes(
        pos=(pos - bounds[owner]).astype(np.int32),
        word=lanes.word,
        set_mask=lanes.set_mask,
        clear_mask=lanes.clear_mask,
    )
    return owner, local


class Sharded2DExecutor(_StripeScheduleDriver):
    """Device-resident ``sharded_2d`` execute stage for one 2-axis mesh.

    Both slice stores are split: shard ``(i, j)`` reads row block ``i`` and
    column block ``j``, each a zero-padded ``[shard_rows, W]`` tensor placed
    once on every device that needs it (one copy a device, shared by its
    logical shards) — the placement where NEITHER store is replicated. The
    ranges come from the constructing plan's (typically pair-count-weighted)
    bounds, or even ranges without one; ``count`` re-plans any work list
    against those fixed bounds, so the stores never move.
    """

    def __init__(
        self,
        sbf: SlicedBitmap,
        mesh: Mesh,
        plan: ExecutionPlan | None = None,
        *,
        chunk_pairs: int = 1 << 20,
        double_buffer: bool = True,
        schedule: str = "packed",
    ):
        _check_schedule(schedule)
        self.schedule = schedule
        if mesh.devices.ndim != 2:
            raise ValueError(
                f"sharded_2d needs a 2-axis mesh, got {mesh.devices.ndim} "
                f"axes {tuple(mesh.axis_names)}"
            )
        self.mesh = mesh
        self.axis_names = tuple(mesh.axis_names)
        self.grid = tuple(int(x) for x in mesh.devices.shape)
        self.num_shards = self.grid[0] * self.grid[1]
        self.words_per_slice = int(sbf.words_per_slice)
        self.chunk_pairs = chunk_pairs
        self.double_buffer = double_buffer
        self._init_counters()
        self._sbf = sbf
        nrow = len(sbf.row_slice_idx)
        ncol = len(sbf.col_slice_idx)
        if plan is None:
            # Worklist-independent fallback: even ranges on both axes. For
            # balanced (weighted) ranges construct from a sharded_2d plan.
            self.row_bounds = even_range_bounds(nrow, self.grid[0])
            self.col_bounds = even_range_bounds(ncol, self.grid[1])
        else:
            if plan.placement != "sharded_2d" or plan.grid != self.grid:
                raise ValueError(
                    f"plan is {plan.placement!r} over grid {plan.grid}, "
                    f"mesh is {self.grid[0]}x{self.grid[1]}"
                )
            self.row_bounds = np.asarray(plan.row_bounds, dtype=np.int64)
            self.col_bounds = np.asarray(plan.col_bounds, dtype=np.int64)
        # The resident bounds as a plan: every later work list is re-planned
        # against it (``replan_fixed``).
        self._resident = plan if plan is not None else plan_execution(
            sbf, _empty_worklist(sbf), DeviceTopology(num_devices=self.num_shards),
            placement="sharded_2d", grid=self.grid, chunk_pairs=chunk_pairs,
            row_bounds=self.row_bounds, col_bounds=self.col_bounds,
        )
        self.row_shard_rows = _pow2_ceil(
            max(int(np.diff(self.row_bounds).max(initial=0)), 1)
        )
        self.col_shard_rows = _pow2_ceil(
            max(int(np.diff(self.col_bounds).max(initial=0)), 1)
        )
        # (block, device) -> the block's copy on that device.
        self._row_blocks: dict = {}
        self._col_blocks: dict = {}
        row_words = _host_words(sbf.row_slice_data)
        col_words = _host_words(sbf.col_slice_data)
        self._shards = []
        for (i, j), dev in np.ndenumerate(mesh.devices):
            if (i, dev) not in self._row_blocks:
                self._row_blocks[i, dev] = self._place(
                    row_words, int(self.row_bounds[i]), int(self.row_bounds[i + 1]),
                    self.row_shard_rows, dev,
                )
            if (j, dev) not in self._col_blocks:
                self._col_blocks[j, dev] = self._place(
                    col_words, int(self.col_bounds[j]), int(self.col_bounds[j + 1]),
                    self.col_shard_rows, dev,
                )
            self._shards.append(_Shard(dev, self._row_blocks[i, dev], self._col_blocks[j, dev]))
        self._validate_int32_floor("blocks", "a smaller grid")

    def _plan(self, wl: Worklist) -> ExecutionPlan:
        """Plan a work list against this executor's FIXED store ranges."""
        return replan_fixed(self._resident, self._sbf, wl, chunk_pairs=self.chunk_pairs)

    def _check_plan(self, plan: ExecutionPlan) -> None:
        if plan.placement != "sharded_2d":
            raise ValueError(
                f"plan placement {plan.placement!r} is not 'sharded_2d'"
            )
        if plan.grid != self.grid:
            raise ValueError(
                f"plan grid {plan.grid} != mesh grid {self.grid}"
            )
        if not (
            np.array_equal(plan.row_bounds, self.row_bounds)
            and np.array_equal(plan.col_bounds, self.col_bounds)
        ):
            raise ValueError(
                "plan's block-local coordinates assume different store "
                "ranges than this executor's resident blocks; re-plan with "
                "row_bounds/col_bounds pinned to the executor's (or use "
                ".count, which does)"
            )

    def update_stores(self, sbf: SlicedBitmap, row_lanes, col_lanes) -> None:
        """Edit an ``SBFUpdate``'s lanes into the resident blocks in place.

        The streaming fast path for sharded placements: lane positions are
        *global* record coordinates (the ones ``core.sbf.update_sbf``
        emits), so each is remapped to ``(owner block, block-local row)``
        (``remap_lanes``) and edited into every device's copy of that block
        by ``core.executor.apply_store_lanes`` — on the current stream,
        after any count already launched there, so an in-flight count reads
        the old words. Only valid when the update did not grow either record
        set: growth changes record positions and hence the range bounds, so
        callers rebuild the executor instead. ``sbf`` becomes the executor's
        planning SBF.
        """
        if int(sbf.words_per_slice) != self.words_per_slice:
            raise ValueError(
                f"words_per_slice {sbf.words_per_slice} != resident "
                f"{self.words_per_slice}"
            )
        if (
            len(sbf.row_slice_idx) != int(self.row_bounds[-1])
            or len(sbf.col_slice_idx) != int(self.col_bounds[-1])
        ):
            raise ValueError(
                "record counts changed — the SBF grew; rebuild the "
                "sharded executor (bounds and block layout are stale)"
            )
        sides = (
            (row_lanes, self.row_bounds, self._row_blocks, "row"),
            (col_lanes, self.col_bounds, self._col_blocks, "col"),
        )
        remapped = [(remap_lanes(lanes, bounds, side), blocks)
                    for lanes, bounds, blocks, side in sides]
        for edit, blocks in remapped:
            if edit is None:
                continue
            owner, local = edit
            for b in np.unique(owner):
                sel = owner == b
                sub = UpdateLanes(pos=local.pos[sel], word=local.word[sel],
                                  set_mask=local.set_mask[sel], clear_mask=local.clear_mask[sel])
                for (block, _dev), store in blocks.items():
                    if block == b:
                        apply_store_lanes(store, sub)
                        self.lane_upload_bytes += _LANE_BYTES * sub.num_lanes
        self._sbf = sbf

    def _plan_matches_bounds(self, plan: ExecutionPlan | None) -> bool:
        return (
            plan is not None
            and plan.placement == "sharded_2d"
            and plan.grid == self.grid
            and np.array_equal(plan.row_bounds, self.row_bounds)
            and np.array_equal(plan.col_bounds, self.col_bounds)
        )

    def count_async(
        self, wl: Worklist, plan: ExecutionPlan | None = None
    ) -> CountFuture:
        """``count`` with the final host readback deferred to ``result()``."""
        if self._plan_matches_bounds(plan):
            return self.count_plan_async(plan)
        return self.count_plan_async(self._plan(wl))

    def count(self, wl: Worklist, plan: ExecutionPlan | None = None) -> int:
        """Count a work list against the resident sharded stores.

        A pre-built ``plan`` is used as-is when its ranges match the
        resident blocks (skips re-planning); otherwise ``wl`` is re-planned
        against the executor's FIXED bounds, keeping the placed blocks.
        """
        return self.count_async(wl, plan).result()


# Bounded cache of sharded executors for the one-shot APIs, keyed by store
# *content* (like core.executor.ExecutorPool) so repeated counts of the same
# graph reuse the placed blocks even though tcim_count* rebuilds the SBF
# object per call. Shared by the 1-D and 2-D executors (their key tuples
# cannot collide).
_SHARDED_CACHE: collections.OrderedDict = collections.OrderedDict()
_SHARDED_CACHE_MAX = 4


def _cache_put(key, ex):
    _SHARDED_CACHE[key] = ex
    _SHARDED_CACHE.move_to_end(key)
    while len(_SHARDED_CACHE) > _SHARDED_CACHE_MAX:
        _SHARDED_CACHE.popitem(last=False)
    return ex


def pooled_sharded_executor(
    sbf: SlicedBitmap,
    mesh: Mesh,
    *,
    chunk_pairs: int = 1 << 20,
    double_buffer: bool = True,
    schedule: str = "packed",
) -> ShardedColsExecutor:
    """Cached ``ShardedColsExecutor`` for (store content, mesh, config)."""
    # EVERY config knob is part of the key — a pooled hit must never hand
    # back an executor with different buffering or scheduling than requested.
    key = (sbf_content_key(sbf), mesh, chunk_pairs, double_buffer, schedule)
    entry = _SHARDED_CACHE.get(key)
    if entry is not None:
        _SHARDED_CACHE.move_to_end(key)
        return entry
    return _cache_put(key, ShardedColsExecutor(
        sbf, mesh, chunk_pairs=chunk_pairs, double_buffer=double_buffer, schedule=schedule,
    ))


def pooled_sharded_2d_executor(
    sbf: SlicedBitmap,
    mesh: Mesh,
    plan: ExecutionPlan,
    *,
    chunk_pairs: int = 1 << 20,
    double_buffer: bool = True,
    schedule: str = "packed",
) -> Sharded2DExecutor:
    """Cached ``Sharded2DExecutor`` for (store content, mesh, grid, config).

    The bounds are deliberately NOT part of the key: a hit means the graph's
    blocks are already placed under some (earlier-planned) ranges, and
    re-placing both stores to chase a new work list's slightly better
    balanced cuts costs more than it saves — ``count(wl, plan)`` falls back
    to the resident fixed bounds when the plan's ranges differ. The config
    knobs (``double_buffer``, ``schedule``) ARE keyed.
    """
    key = (
        sbf_content_key(sbf), mesh, plan.grid, chunk_pairs, double_buffer,
        schedule,
    )
    entry = _SHARDED_CACHE.get(key)
    if entry is not None:
        _SHARDED_CACHE.move_to_end(key)
        return entry
    return _cache_put(key, Sharded2DExecutor(
        sbf, mesh, plan, chunk_pairs=chunk_pairs, double_buffer=double_buffer,
        schedule=schedule,
    ))


def clear_sharded_executor_cache() -> None:
    """Release every cached sharded executor (frees their store blocks)."""
    _SHARDED_CACHE.clear()


def _count_replicated_async(sbf: SlicedBitmap, wl: Worklist, mesh: Mesh,
                            max_step_pairs: int | None) -> CountFuture:
    """Both stores on every device; each step's pairs dealt across the
    shards (``shard_worklist``), one launch a shard with real pairs."""
    devices = list(mesh.devices.flat)
    n_dev = len(devices)
    row_words = _host_words(sbf.row_slice_data)
    col_words = _host_words(sbf.col_slice_data)
    shards = {
        d: _Shard(d, *(_place_block(w, 0, w.shape[0], max(w.shape[0], 1), d)
                       for w in (row_words, col_words)))
        for d in mesh.unique_devices
    }
    max_pairs = max(INT32_SAFE_WORDS // max(sbf.words_per_slice, 1), 1)
    if max_step_pairs is not None:
        max_pairs = max(min(max_pairs, max_step_pairs), 1)
    starts = range(0, wl.num_pairs, max_pairs)
    accs = {d: torch.zeros((len(starts), 2), dtype=torch.int32, device=d) for d in shards}
    for k, start in enumerate(starts):
        sub = _slice_worklist(wl, start, start + max_pairs)
        row_idx, col_idx = shard_worklist(sub, n_dev)
        per = row_idx.shape[1]
        for s, dev in enumerate(devices):
            if sub.num_pairs - s * per <= 0:
                continue  # an all-sentinel row counts zero
            ridx, cidx = _upload_indices(row_idx[s], col_idx[s], dev)
            with _device_context(dev):
                shards[dev].step(accs[dev][k], ridx, cidx)
    return CountFuture(list(accs.values()))


def distributed_tc_count_async(
    sbf: SlicedBitmap,
    wl: Worklist,
    mesh: Mesh,
    *,
    placement: str = "replicated",
    max_step_pairs: int | None = None,
    schedule: str = "packed",
) -> CountFuture:
    """``distributed_tc_count`` with the host readback deferred.

    Every placement launches all of its steps before returning; the
    per-step int32 rows ride the returned ``CountFuture`` and are summed
    exactly (host ints) at ``result()``. ``max_step_pairs`` bounds the
    per-step work and its int32 worst case, while the staged index memory
    grows with the step count (8 bytes a lane).
    """
    if placement not in TC_PLACEMENTS:
        raise ValueError(f"placement {placement!r} not in {TC_PLACEMENTS}")
    _check_schedule(schedule)
    chunk = max_step_pairs if max_step_pairs is not None else 1 << 20
    if placement == "sharded_cols":
        return pooled_sharded_executor(
            sbf, mesh, chunk_pairs=chunk, schedule=schedule
        ).count_async(wl)
    if placement == "sharded_2d":
        grid = tuple(int(x) for x in mesh.devices.shape)
        if len(grid) != 2:
            raise ValueError(
                f"placement 'sharded_2d' needs a 2-axis mesh, got "
                f"{len(grid)} axes {tuple(mesh.axis_names)}"
            )
        plan = plan_execution(
            sbf,
            wl,
            DeviceTopology(num_devices=grid[0] * grid[1], platform=mesh.platform),
            placement="sharded_2d",
            grid=grid,
            chunk_pairs=chunk,
        )
        ex = pooled_sharded_2d_executor(
            sbf, mesh, plan, chunk_pairs=chunk, schedule=schedule
        )
        return ex.count_async(wl, plan)
    if wl.num_pairs == 0:
        # Match the sharded paths' empty-schedule guard: nothing to count,
        # so never pad, upload, or launch a step for it.
        return CountFuture([])
    return _count_replicated_async(sbf, wl, mesh, max_step_pairs)


def distributed_tc_count(
    sbf: SlicedBitmap,
    wl: Worklist,
    mesh: Mesh,
    *,
    placement: str = "replicated",
    max_step_pairs: int | None = None,
    schedule: str = "packed",
) -> int:
    """Execute the distributed count on a mesh.

    Per-shard partials and each step's row accumulate in int32, so the work
    list is split into steps whose worst case provably fits int32; the
    steps' rows are summed exactly on the host at the one readback.
    ``placement='sharded_cols'`` shards the column store over the mesh
    (``ShardedColsExecutor``); ``placement='sharded_2d'`` shards BOTH stores
    over a 2-axis mesh with pair-count-weighted ranges
    (``Sharded2DExecutor``). Long-lived callers should construct the
    executors themselves and reuse them. ``max_step_pairs`` additionally
    bounds the pairs a step (the engine's ``chunk_pairs``); ``schedule``
    picks the sharded paths' stripe policy (``packed`` / ``lockstep``).
    Every placement runs the ``gather_total`` kernel on a CUDA mesh and its
    plain version on a CPU mesh; Executor modes do not apply here.
    """
    return distributed_tc_count_async(
        sbf,
        wl,
        mesh,
        placement=placement,
        max_step_pairs=max_step_pairs,
        schedule=schedule,
    ).result()


def _empty_worklist(sbf: SlicedBitmap) -> Worklist:
    none = np.zeros(0, np.int64)
    return Worklist(pair_edge=none, pair_row_pos=none, pair_col_pos=none, m_edges=0,
                    n_slices=int(sbf.n_slices))


def _slice_worklist(wl: Worklist, start: int, stop: int) -> Worklist:
    return Worklist(
        pair_edge=wl.pair_edge[start:stop],
        pair_row_pos=wl.pair_row_pos[start:stop],
        pair_col_pos=wl.pair_col_pos[start:stop],
        m_edges=wl.m_edges,
        n_slices=wl.n_slices,
    )
