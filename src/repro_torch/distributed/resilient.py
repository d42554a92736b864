"""Resilient sharded counts: checkpointed cursors + elastic shrink-remesh.

Port of ``src/repro/distributed/resilient.py``. The count is a commutative
integer monoid over disjoint pair stripes, so

  * *progress* is a tiny serializable cursor — the committed total plus
    ``StripeSchedule.cursor_after`` per-shard pair offsets (saved every
    ``checkpoint_every`` steps through the async ``CheckpointManager``);
  * *state* is one per-attempt snapshot — the SBF stores plus the attempt's
    remaining worklist in store-global coordinates;
  * *recovery* is a re-partition — ``tc_remesh_plan`` shrinks the
    ``(rows, cols)`` owner grid to the surviving device count,
    ``plan_execution`` re-balances the uncounted pairs onto it, and the
    resumed count is exact because no pair is lost or double-counted.

Layout of a checkpoint root (the reference's, key for key, written through
the port's ``checkpoint.store``, so a root resumes across the two packages
both ways; two retention domains, so frequent cursor saves never
garbage-collect the heavy store snapshot):

    <dir>/stores/step_<attempt>/   SBF stores + worklist, once per attempt
    <dir>/cursor/step_<attempt*1e6 + step>/   cursor, every K steps

Cursor step numbers are attempt-strided: attempt 1's step 8 must not be
shadowed by attempt 0's step 16 under ``latest_step`` discovery.

``resilient_tc_count`` drives the whole loop in-process (inject failures
with ``runtime.fault.FailureInjector``, flag stragglers with
``StragglerMonitor``); a lost device leaves the device list, and the first
``rows x cols`` survivors form the next ``Mesh``. ``resume_tc_count``
restarts a killed process from nothing but the checkpoint directory and a
mesh of surviving devices.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.checkpoint.store import (
    CheckpointManager,
    list_steps,
    load_checkpoint,
)
from repro_torch.core.plan import (
    DeviceTopology,
    ExecutionPlan,
    plan_execution,
    remaining_worklist,
)
from repro_torch.core.sbf import SlicedBitmap, Worklist
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.tc import Sharded2DExecutor
from repro_torch.runtime.elastic import tc_remesh_plan
from repro_torch.runtime.fault import CountInterrupted

__all__ = [
    "ATTEMPT_STRIDE",
    "TCCheckpoint",
    "RecoveryState",
    "ResilienceConfig",
    "resilient_tc_count",
    "resume_tc_count",
]

# Cursor checkpoints are numbered attempt * ATTEMPT_STRIDE + step so that
# discovery by max-step never resolves to a *previous* attempt's deeper
# step after a remesh shortens the schedule.
ATTEMPT_STRIDE = 1_000_000


@dataclasses.dataclass(frozen=True)
class RecoveryState:
    """Everything ``load_latest`` reconstructs from disk — enough to rebuild
    the interrupted attempt's plan deterministically and slice off the
    uncounted tail of every stripe."""

    sbf: SlicedBitmap
    worklist: Worklist  # the snapshot attempt's FULL worklist (global coords)
    placement: str
    grid: tuple[int, int]
    chunk_pairs: int
    schedule: str
    row_bounds: np.ndarray | None
    col_bounds: np.ndarray | None
    attempt: int
    committed_total: int
    committed_step: int
    shard_cursors: tuple[int, ...] | None  # None: no commit this attempt yet


class TCCheckpoint:
    """Checkpoint root for a resumable count: ``stores/`` + ``cursor/``.

    Two ``CheckpointManager``s with separate retention — the heavy store
    snapshot (one per attempt, ``keep_last=1``) must survive arbitrarily
    many light cursor commits (``keep_last=keep_last``). Both saves are
    async: the host copy happens at the call, file I/O on the writer thread
    overlaps the following steps.
    """

    _SBF_KEYS = (
        "row_ptr", "row_slice_idx", "row_slice_data",
        "col_ptr", "col_slice_idx", "col_slice_data",
    )
    _SNAPSHOT_KEYS = _SBF_KEYS + (
        "wl_row_pos", "wl_col_pos", "row_bounds", "col_bounds",
    )

    def __init__(self, directory: str | Path, keep_last: int = 3):
        self.directory = Path(directory)
        self.stores = CheckpointManager(self.directory / "stores", keep_last=1)
        self.cursor = CheckpointManager(
            self.directory / "cursor", keep_last=keep_last
        )

    def save_snapshot(
        self,
        sbf: SlicedBitmap,
        plan: ExecutionPlan,
        *,
        attempt: int,
        base_total: int,
        schedule: str = "packed",
    ) -> None:
        """Persist the attempt's stores + full worklist (async), once: a
        snapshot already durable for this (or a later) attempt is a no-op,
        so repeated counts against one checkpointer pay only cursor I/O."""
        latest = self.stores.latest_step()
        if latest is not None and latest >= attempt:
            return
        wl = remaining_worklist(plan)  # plan order, store-global coords
        has_rb = plan.row_bounds is not None
        has_cb = plan.col_bounds is not None
        tree = {
            "row_ptr": np.asarray(sbf.row_ptr),
            "row_slice_idx": np.asarray(sbf.row_slice_idx),
            "row_slice_data": np.asarray(sbf.row_slice_data),
            "col_ptr": np.asarray(sbf.col_ptr),
            "col_slice_idx": np.asarray(sbf.col_slice_idx),
            "col_slice_data": np.asarray(sbf.col_slice_data),
            "wl_row_pos": np.asarray(wl.pair_row_pos),
            "wl_col_pos": np.asarray(wl.pair_col_pos),
            "row_bounds": np.asarray(
                plan.row_bounds if has_rb else np.zeros(0, np.int64)
            ),
            "col_bounds": np.asarray(
                plan.col_bounds if has_cb else np.zeros(0, np.int64)
            ),
        }
        extra = {
            "attempt": int(attempt),
            "base_total": int(base_total),
            "slice_bits": int(sbf.slice_bits),
            "n": int(sbf.n),
            "n_slices": int(sbf.n_slices),
            "placement": plan.placement,
            "grid": [int(plan.grid[0]), int(plan.grid[1])],
            "chunk_pairs": int(plan.chunk_pairs),
            "schedule": schedule,
            "has_row_bounds": bool(has_rb),
            "has_col_bounds": bool(has_cb),
        }
        self.stores.save_async(attempt, tree, extra)

    def save_cursor(
        self,
        attempt: int,
        step: int,
        shard_cursors,
        total: int,
        plan: ExecutionPlan,
    ) -> None:
        """Persist one committed cursor (async, attempt-strided step)."""
        tree = {"shard_cursors": np.asarray(shard_cursors, np.int64)}
        extra = {
            "attempt": int(attempt),
            "committed_step": int(step),
            "committed_total": int(total),
            "grid": [int(plan.grid[0]), int(plan.grid[1])],
        }
        self.cursor.save_async(attempt * ATTEMPT_STRIDE + step, tree, extra)

    def wait(self) -> None:
        """Join in-flight writes (re-raising a failed one, see
        ``CheckpointManager.wait``)."""
        self.stores.wait()
        self.cursor.wait()

    def peek(self) -> dict:
        """The latest snapshot's manifest ``extra`` — no leaf I/O. Recovery
        reads the old grid here before deciding the new mesh shape."""
        self.wait()
        step = self.stores.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no committed store snapshot under {self.stores.directory}"
            )
        manifest = json.loads(
            (self.stores.directory / f"step_{step:08d}" / "manifest.json")
            .read_text()
        )
        return manifest["extra"]

    def load_latest(self, mesh: Mesh | None = None) -> RecoveryState:
        """Reconstruct the latest attempt's state from disk.

        The stores come back as host NumPy arrays, with or without ``mesh``:
        the reference restores them replicated onto the new mesh and then
        reads them back to repack its blocks, while here the executor built
        on ``mesh`` (``_recover``) places exactly each shard's blocks on its
        device from these arrays. ``mesh`` is accepted for the reference's
        signature and must be a port ``Mesh``.
        The cursor is the deepest committed one OF THE SNAPSHOT'S ATTEMPT
        (attempt-strided numbering; a younger attempt's stray cursor with
        no matching snapshot is ignored — it only ever means the snapshot
        write lost the race to a crash, and the previous attempt's state
        is the last consistent one).
        """
        self.wait()
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a repro_torch Mesh, got {type(mesh).__name__}")
        tree_like = {k: 0 for k in self._SNAPSHOT_KEYS}
        tree, attempt, extra = load_checkpoint(self.stores.directory, tree_like)
        sbf = SlicedBitmap(
            slice_bits=int(extra["slice_bits"]),
            n=int(extra["n"]),
            n_slices=int(extra["n_slices"]),
            row_ptr=tree["row_ptr"],
            row_slice_idx=tree["row_slice_idx"],
            row_slice_data=tree["row_slice_data"],
            col_ptr=tree["col_ptr"],
            col_slice_idx=tree["col_slice_idx"],
            col_slice_data=tree["col_slice_data"],
        )
        wl_row = np.asarray(tree["wl_row_pos"])
        wl = Worklist(
            pair_edge=np.zeros(len(wl_row), np.int64),
            pair_row_pos=wl_row,
            pair_col_pos=np.asarray(tree["wl_col_pos"]),
            m_edges=0,
            n_slices=int(extra["n_slices"]),
        )
        committed_total = int(extra["base_total"])
        committed_step = 0
        cursors: tuple[int, ...] | None = None
        mine = [
            s for s in list_steps(self.cursor.directory)
            if s // ATTEMPT_STRIDE == attempt
        ]
        if mine:
            ctree, _, cextra = load_checkpoint(
                self.cursor.directory, {"shard_cursors": 0}, step=max(mine)
            )
            committed_total = int(cextra["committed_total"])
            committed_step = int(cextra["committed_step"])
            cursors = tuple(
                int(c) for c in np.asarray(ctree["shard_cursors"])
            )
        return RecoveryState(
            sbf=sbf,
            worklist=wl,
            placement=extra["placement"],
            grid=(int(extra["grid"][0]), int(extra["grid"][1])),
            chunk_pairs=int(extra["chunk_pairs"]),
            schedule=extra.get("schedule", "packed"),
            row_bounds=(
                np.asarray(tree["row_bounds"])
                if extra.get("has_row_bounds")
                else None
            ),
            col_bounds=(
                np.asarray(tree["col_bounds"])
                if extra.get("has_col_bounds")
                else None
            ),
            attempt=int(attempt),
            committed_total=committed_total,
            committed_step=committed_step,
            shard_cursors=cursors,
        )


@dataclasses.dataclass
class ResilienceConfig:
    """Policy knobs for ``resilient_tc_count`` / ``tcim_count(resilience=)``.

    ``checkpoint_every`` trades steps-replayed-on-failure against commit
    overhead (each commit is one readback of the committed steps' rows per
    device + an async cursor write).
    ``lose_devices`` is the simulated blast radius per failure (0 = the
    failed device is replaced: recover on the same-size grid). A sequence
    gives the blast radius per *successive* failure — ``(4, 2, 1)`` soaks a
    cascading 8 -> 4 -> 2 -> 1 shrink; failures past the end reuse the last
    entry.
    ``monitor`` opts into per-step timing (synchronises each step — the
    observability tradeoff) and, with ``monitor_interrupts``, routes a
    straggler flag through the same checkpoint-and-remesh path.
    """

    checkpoint_dir: str | Path
    checkpoint_every: int = 8
    keep_last: int = 3
    injector: object | None = None  # runtime.fault.FailureInjector
    monitor: object | None = None  # runtime.fault.StragglerMonitor
    monitor_interrupts: bool = True
    max_failures: int = 2
    lose_devices: int | tuple[int, ...] = 1

    def blast_radius(self, failure: int) -> int:
        """Devices lost by the ``failure``-th interrupt (1-based)."""
        lose = self.lose_devices
        if isinstance(lose, int):
            return lose
        seq = tuple(int(x) for x in lose)
        if not seq:
            return 0
        return seq[min(failure, len(seq)) - 1]

    def for_request(self, request_id: int) -> "ResilienceConfig":
        """A copy rooted at a per-request checkpoint subdirectory.

        The serving layer runs many sharded solos against one configured
        resilience policy; giving each request its own ``req_<id>`` subtree
        keeps their cursors/snapshots from clobbering each other while
        sharing every other knob (injector included — deliberately, so a
        soak's step counter spans the whole drain)."""
        return dataclasses.replace(
            self, checkpoint_dir=Path(self.checkpoint_dir) / f"req_{request_id}"
        )


def _build_executor(
    sbf: SlicedBitmap,
    wl: Worklist,
    mesh: Mesh,
    *,
    chunk_pairs: int,
    schedule: str,
) -> tuple[Sharded2DExecutor, ExecutionPlan]:
    grid = tuple(int(x) for x in mesh.devices.shape)
    plan = plan_execution(
        sbf,
        wl,
        DeviceTopology(num_devices=grid[0] * grid[1]),
        placement="sharded_2d",
        grid=grid,
        chunk_pairs=chunk_pairs,
    )
    ex = Sharded2DExecutor(
        sbf, mesh, plan, chunk_pairs=chunk_pairs, schedule=schedule
    )
    return ex, plan


def _recover(
    ckpt: TCCheckpoint, devices: list, axis_names: tuple[str, str]
) -> tuple[Sharded2DExecutor, ExecutionPlan, int, int]:
    """Rebuild an interrupted count from disk onto the surviving devices.

    Deterministic in two halves: the interrupted attempt's plan is rebuilt
    from the snapshot worklist with its bounds PINNED (split="fixed" —
    same cuts, same stripes, same pair order), so the committed cursors
    slice off exactly the uncounted tail; that tail, lifted to store-global
    coordinates, is then re-balanced as a fresh weighted plan on the
    shrunk ``tc_remesh_plan`` grid. Returns
    ``(executor, plan, base_total, attempt)`` for the next attempt.
    """
    extra = ckpt.peek()
    if extra["placement"] != "sharded_2d":
        raise ValueError(
            f"elastic recovery supports sharded_2d snapshots, got "
            f"{extra['placement']!r}"
        )
    old_grid = (int(extra["grid"][0]), int(extra["grid"][1]))
    rp = tc_remesh_plan(old_grid, len(devices), axis_names)
    if not rp.ok:
        raise RuntimeError(
            f"no viable remesh from grid {old_grid} onto {len(devices)} "
            f"devices: {'; '.join(rp.reasons)}"
        )
    rows, cols = rp.new_shape
    grid = np.empty(rows * cols, dtype=object)
    grid[:] = devices[: rows * cols]
    new_mesh = Mesh(grid.reshape(rows, cols), axis_names)
    state = ckpt.load_latest(mesh=new_mesh)
    old_plan = plan_execution(
        state.sbf,
        state.worklist,
        DeviceTopology(num_devices=old_grid[0] * old_grid[1]),
        placement="sharded_2d",
        grid=old_grid,
        chunk_pairs=state.chunk_pairs,
        row_bounds=state.row_bounds,
        col_bounds=state.col_bounds,
    )
    rem = remaining_worklist(
        old_plan, state.shard_cursors, n_slices=state.sbf.n_slices
    )
    ex, plan = _build_executor(
        state.sbf,
        rem,
        new_mesh,
        chunk_pairs=state.chunk_pairs,
        schedule=state.schedule,
    )
    return ex, plan, state.committed_total, state.attempt + 1


def resilient_tc_count(
    sbf: SlicedBitmap,
    wl: Worklist,
    mesh: Mesh,
    config: ResilienceConfig,
    *,
    chunk_pairs: int = 1 << 20,
    schedule: str = "packed",
) -> tuple[int, dict]:
    """A sharded_2d count that survives device loss, bit-identically.

    Runs ``count_plan_resumable`` with the config's checkpoint cadence;
    on ``CountInterrupted`` (injected/real failure, or straggler flag)
    drops ``config.lose_devices`` devices, shrinks the grid via
    ``tc_remesh_plan``, restores stores + cursor FROM THE CHECKPOINT (not
    in-memory state — the same code path a process restart takes), and
    resumes the uncounted pairs on the new mesh. At most
    ``config.max_failures`` recoveries; further interrupts re-raise.

    Returns ``(total, info)``: ``info`` records attempts, failures,
    remeshes (with steps replayed), checkpoint commits, recovery
    wall-clock, and the final grid.
    """
    if mesh.devices.ndim != 2:
        raise ValueError(
            f"resilient counts need a 2-axis mesh, got {mesh.devices.ndim} "
            f"axes {tuple(mesh.axis_names)}"
        )
    axis_names = tuple(mesh.axis_names)
    devices = list(mesh.devices.reshape(-1))
    ckpt = TCCheckpoint(config.checkpoint_dir, keep_last=config.keep_last)
    ex, plan = _build_executor(
        sbf, wl, mesh, chunk_pairs=chunk_pairs, schedule=schedule
    )
    attempt = 0
    base_total = 0
    info: dict = {
        "failures": 0,
        "remeshes": [],
        "steps_replayed": 0,
        "checkpoints": 0,
        "recovery_s": 0.0,
        "grid": list(ex.grid),
        "checkpoint_dir": str(ckpt.directory),
    }
    while True:
        try:
            total, cinfo = ex.count_plan_resumable(
                plan,
                checkpoint_every=config.checkpoint_every,
                checkpointer=ckpt,
                injector=config.injector,
                monitor=config.monitor,
                monitor_interrupts=config.monitor_interrupts,
                base_total=base_total,
                attempt=attempt,
            )
            info["checkpoints"] += cinfo["checkpoints"]
            info["steps"] = cinfo["steps"]
            if "step_ewma_s" in cinfo:
                info["step_ewma_s"] = cinfo["step_ewma_s"]
            info["attempts"] = attempt + 1
            ckpt.wait()
            return total, info
        except CountInterrupted as ci:
            # Join the cursor write still in flight, so that the root holds
            # every commit made before the failure when this re-raises (a
            # fresh TCCheckpoint on the root would not see it otherwise).
            ckpt.wait()
            info["failures"] += 1
            if info["failures"] > config.max_failures:
                raise
            t0 = time.perf_counter()
            lose = config.blast_radius(info["failures"])
            if lose > 0:
                devices = devices[: len(devices) - lose]
            if not devices:
                raise
            ex, plan, base_total, attempt = _recover(
                ckpt, devices, axis_names
            )
            if config.monitor is not None:
                config.monitor.reset()
            info["remeshes"].append(
                {
                    "reason": ci.reason,
                    "failed_step": ci.failed_step,
                    "committed_step": ci.committed_step,
                    "replayed": ci.steps_replayed,
                    "grid": list(ex.grid),
                }
            )
            info["steps_replayed"] += ci.steps_replayed
            info["grid"] = list(ex.grid)
            info["recovery_s"] += time.perf_counter() - t0


def resume_tc_count(
    checkpoint_dir: str | Path,
    mesh: Mesh,
    *,
    checkpoint_every: int = 8,
    keep_last: int = 3,
    injector=None,
    monitor=None,
) -> tuple[int, dict]:
    """Restart a killed count from nothing but its checkpoint directory.

    The process-crash recovery path: rebuilds stores, worklist, and the
    last committed cursor from disk, re-partitions the uncounted pairs
    onto ``mesh``'s devices (grid re-derived by ``tc_remesh_plan``; the
    mesh's own shape only contributes axis names + device set), and runs
    the remainder under the same checkpointing. A count that had already
    finished resumes into an empty schedule and simply returns its total.
    """
    ckpt = TCCheckpoint(checkpoint_dir, keep_last=keep_last)
    axis_names = tuple(mesh.axis_names)
    if len(axis_names) != 2:
        raise ValueError(
            f"resume needs a 2-axis mesh, got axes {axis_names}"
        )
    ex, plan, base_total, attempt = _recover(
        ckpt, list(mesh.devices.reshape(-1)), axis_names
    )
    total, cinfo = ex.count_plan_resumable(
        plan,
        checkpoint_every=checkpoint_every,
        checkpointer=ckpt,
        injector=injector,
        monitor=monitor,
        base_total=base_total,
        attempt=attempt,
    )
    ckpt.wait()
    return total, {
        "attempt": attempt,
        "grid": list(ex.grid),
        "steps": cinfo["steps"],
        "checkpoints": cinfo["checkpoints"],
    }
