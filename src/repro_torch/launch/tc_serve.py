"""Triangle-count-as-a-service: a durable multi-tenant batch front end.

Port of ``src/repro/launch/tc_serve.py``: one-shot requests, hosted
streams, the write-ahead log, checkpoint and restore, and the sharded and
resilient solos of ``mesh``/``resilience``. A fleet of small graphs drains through fused dispatches of
``core.executor.MultiGraphExecutor`` — stacked stores and a shared
``[G, bucket]`` segment index block a batch, and every batch of a wave in
one dispatch of the segment-totals kernel returning every graph's count —
while graphs too large to fuse go solo through the pooled replicated
``Executor``.

Pipeline per ``drain()`` wave:

  1. **Admission control** — each request's device footprint (pow2-padded
     store bytes + staged index bytes) is charged against
     ``memory_budget_bytes``. A request that can never fit is rejected
     (reported, never silently dropped); the rest are admitted FIFO until
     the wave's budget fills, and the remainder waits for the next wave.
  2. **Placement** — admitted requests small enough for fusion (pairs within
     ``max_fused_pairs``, the per-segment int32 bound) are grouped by word
     width and batched by pow2 pair bucket; everything else is planned solo
     by ``plan_execution`` — replicated on the pooled executor, or, with a
     ``mesh``, sharded through ``distributed_tc_count_async`` when the
     planner shards it (and, with ``resilience`` set, ``sharded_2d`` solos
     through ``distributed.resilient.resilient_tc_count``, so that a device
     loss mid-count remeshes instead of failing the request).
  3. **Dispatch** — the wave's fused batches, of every word width, go out
     in one ``count_fused_wave_async`` (one launch of the segment kernel on
     the card for up to ``GROUP_CAP`` batches, one readback), then the
     solos; nothing is read back before everything is dispatched, so closes
     overlap the next dispatches.

Hosted streams (``create_stream``/``submit_delta``/``close_stream``/
``stream_count``) are ``core.streaming.StreamingTCState``s with private
executors on the server's device; their deltas drain FIFO at the head of
every ``drain()``, before the one-shot waves, and each stream's resident
store footprint is a standing charge against ``memory_budget_bytes``.

Robustness layers:

* **Durability** — with ``ServeConfig.wal_dir`` set, every hosted stream
  gets a :class:`StreamWAL`: a crc-framed JSON-lines write-ahead delta log
  (``submit_delta`` logs *before* enqueueing) plus store snapshots through
  ``checkpoint.store.CheckpointManager`` every ``checkpoint_every`` applied
  batches. ``TCServer.checkpoint(dir)`` forces a synchronous full
  checkpoint (streams, pending queues, next-id); ``TCServer.restore(dir)``
  rebuilds a killed server — each stream loads its latest committed
  snapshot, replays the deltas the log marks applied since (equal counts)
  and re-enqueues the unapplied tail as pending work. The files are the
  reference's, byte for byte in the log, so a root written by either
  package restores in the other.
* **Failure isolation** — a raised future poisons only its own batch: its
  requests are retried solo with bounded backoff (``max_retries``/
  ``retry_backoff_s``) and report ``status="error"`` with a typed detail
  only when retries exhaust; a delta that keeps failing is NACKed the same
  way and logged as consumed.
* **Eviction / spill** — idle streams are LRU-spilled to their host mirror
  under memory pressure (their device stores drop, their budget charge
  returns) and transparently re-admitted on their next delta.
* **Compaction** — remove-heavy streams trigger a count-preserving rebuild
  (``StreamingTCState.compact``) when their zero-record ratio crosses
  ``compact_ratio``.
* **Daemon mode** — ``submit``/``submit_delta``/``create_stream`` are
  lock-protected and ``serve_forever()`` runs the drain loop for producer
  threads (``wait_result`` blocks a producer on its request id).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointManager, latest_step, load_checkpoint
from repro_torch.core import sbf as sbf_mod
from repro_torch.core.executor import ExecutorPool, MultiGraphExecutor
from repro_torch.core.plan import (
    DEFAULT_SHARD_ABOVE_BYTES,
    DeviceTopology,
    plan_execution,
    pow2_ceil,
)
from repro_torch.core.streaming import StreamingTCState
from repro_torch.distributed.mesh import mesh_device
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.ops import INT32_SAFE_WORDS

__all__ = ["ServeConfig", "ServeRequest", "ServeResult", "StreamWAL", "TCServer"]

# User-facing backend name -> Executor mode (``ServeConfig.mode`` speaks
# Executor modes).
_SERVE_BACKENDS = {
    "pallas_total": "fused",
    "pallas_unfused": "gather_then_kernel",
    "pallas_items": "pallas_items",
    "jnp": "jnp",
}

# ServeConfig fields persisted in the WAL root's server.json (everything
# JSON-serializable; mesh/injector/resilience and the port's device are
# process-local and must be re-supplied by the restoring process).
_MANIFEST_CONFIG_KEYS = (
    "memory_budget_bytes",
    "max_fused_pairs",
    "max_fused_graphs",
    "fuse",
    "chunk_pairs",
    "mode",
    "shard_above_bytes",
    "pool_max_graphs",
    "fused_max_batches",
    "checkpoint_every",
    "snap_keep_last",
    "max_retries",
    "retry_backoff_s",
    "compact_ratio",
)

# Leaves of one persisted pending one-shot request (SBF stores + worklist).
_REQ_LEAVES = (
    "row_ptr",
    "row_slice_idx",
    "row_slice_data",
    "col_ptr",
    "col_slice_idx",
    "col_slice_data",
    "pair_edge",
    "pair_row_pos",
    "pair_col_pos",
)


@dataclasses.dataclass
class ServeConfig:
    """Policy knobs for :class:`TCServer`.

    ``memory_budget_bytes`` bounds the device bytes one drain wave may stage
    (stores + index blocks) — the admission-control budget.
    ``max_fused_pairs`` is the largest per-graph worklist the fused path
    accepts (it bounds the shared segment bucket, and with it both padding
    waste and the per-segment int32 proof); larger graphs go solo.
    ``max_retries``/``retry_backoff_s`` bound the per-request retry loop
    after an isolated failure. ``injector`` (a ``runtime.fault
    .FailureInjector``) arms fault injection, checked with the *request id*
    before every dispatch attempt. ``device`` defaults to the card; like
    ``injector`` it is process-local and not persisted.

    Durability / degradation knobs: ``wal_dir`` roots the write-ahead logs
    and snapshots (durability off when ``None`` — ``checkpoint(dir)`` can
    still adopt a root later). ``checkpoint_every`` is the per-stream
    snapshot cadence in applied deltas — the bound on replay work after a
    kill; ``snap_keep_last`` the snapshots kept. ``compact_ratio`` is the
    zero-record fraction that triggers store compaction on a stream (<= 0
    disables).

    ``mesh`` (a ``repro_torch.distributed.Mesh`` of the server's device
    kind) enables sharded solo placements: a solo whose store exceeds
    ``shard_above_bytes`` is planned onto the mesh (``sharded_2d`` on a
    2-axis mesh, else ``sharded_cols``). ``resilience`` (a
    ``distributed.resilient.ResilienceConfig``) reroutes sharded_2d solos
    through the remesh-on-device-loss driver, each request under its own
    ``req_<id>`` checkpoint subdirectory; ``stats["resilient_solos"]``
    counts them. Without a mesh every solo is replicated.
    """

    memory_budget_bytes: int = 1 << 30
    max_fused_pairs: int = 1 << 14
    max_fused_graphs: int = 32
    fuse: bool = True
    chunk_pairs: int = 1 << 20
    mode: str = "fused"
    mesh: object | None = None
    shard_above_bytes: int = DEFAULT_SHARD_ABOVE_BYTES
    pool_max_graphs: int = 16
    fused_max_batches: int = 8
    wal_dir: str | None = None
    checkpoint_every: int = 8
    snap_keep_last: int = 2
    max_retries: int = 2
    retry_backoff_s: float = 0.005
    compact_ratio: float = 0.5
    injector: object | None = None  # runtime.fault.FailureInjector
    resilience: object | None = None  # distributed.resilient.ResilienceConfig
    device: str | torch.device | None = None


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One queued graph: its SBF stores, worklist, and submit time."""

    request_id: int
    sbf: sbf_mod.SlicedBitmap
    wl: sbf_mod.Worklist
    submitted_s: float

    @property
    def num_pairs(self) -> int:
        return int(self.wl.num_pairs)

    def footprint_bytes(self, chunk_pairs: int) -> int:
        """Device bytes this request stages: pow2-padded stores plus the
        staged index arrays (row + col int32 lanes of one chunk bucket)."""
        sb = self.sbf
        w = int(sb.words_per_slice) * 4
        store = (
            pow2_ceil(max(int(sb.row_slice_data.shape[0]), 1))
            + pow2_ceil(max(int(sb.col_slice_data.shape[0]), 1))
        ) * w
        lanes = min(pow2_ceil(max(self.num_pairs, 1)), max(chunk_pairs, 1))
        return store + lanes * 8


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """Outcome of one request after a drain.

    ``status`` is ``"ok"``, ``"rejected"`` (admission/validation refused it
    — ``count`` is None and ``detail`` says why), or ``"error"`` (the
    request kept failing after ``max_retries`` isolated retries — typed
    ``detail``, every other request in the wave unaffected). ``placement``
    records how an ok request ran: ``"fused"`` (cross-graph batch, with
    ``batch_size`` graphs sharing the dispatch), ``"replicated"``,
    ``"sharded_cols"`` or ``"sharded_2d"`` (solo) or
    ``"streaming"`` (a delta). ``latency_s`` is submit-to-result;
    ``retries`` counts recovery attempts that were needed.
    """

    request_id: int
    status: str
    count: int | None
    placement: str | None
    latency_s: float
    batch_size: int = 1
    detail: str = ""
    retries: int = 0


class _FailedFuture:
    """A future poisoned at dispatch: raises its exception at readback so
    dispatch-time and readback-time failures share one isolation path."""

    failed = True

    def __init__(self, err: BaseException):
        self._err = err

    def result(self):
        raise self._err


class _DeferredFuture:
    """A blocking callable behind the ``CountFuture.result()`` shape.

    The resilient driver is synchronous (its retry loop must own the mesh),
    so the wave defers it to readback time — everything else in the wave
    was already dispatched, preserving the async-close overlap."""

    def __init__(self, fn):
        self._fn = fn
        self._done = False
        self._val = None

    def result(self):
        if not self._done:
            self._val = self._fn()
            self._done = True
        return self._val


class StreamWAL:
    """Write-ahead delta log + snapshot cadence for one hosted stream.

    Layout under ``directory``::

        wal.jsonl   append-only, one crc-framed record per line:
                      <crc32-hex8> <json>
                    records (JSON arrays):
                      ["delta", seq, rid, added|null, removed|null]
                        logged by submit_delta BEFORE the batch enqueues
                      ["apply", seq, count]
                        logged after the batch lands (count = running total)
                      ["close", count]
                        the stream was closed; restore skips it
        snap/       CheckpointManager directory — store snapshots at step
                    ``applied_seq + 1`` (crash-mid-save leaves only an
                    invisible .tmp_step_* that restore GCs)

    A torn tail line (kill mid-append) fails the crc or the JSON parse and
    truncates the log there — everything before it is intact. Restore
    replays delta records the log marks applied since the latest committed
    snapshot (<= ``checkpoint_every`` of them) and re-enqueues the rest.
    """

    def __init__(
        self,
        directory: str | Path,
        *,
        checkpoint_every: int = 8,
        keep_last: int = 2,
    ):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.path = self.directory / "wal.jsonl"
        self.snaps = CheckpointManager(self.directory / "snap", keep_last=keep_last)
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self.next_seq = 0
        self._fh = self.path.open("a", encoding="utf-8")

    def _append(self, obj) -> None:
        payload = json.dumps(obj, separators=(",", ":"))
        crc = zlib.crc32(payload.encode("utf-8"))
        self._fh.write(f"{crc:08x} {payload}\n")
        self._fh.flush()

    @staticmethod
    def _edges_list(edges):
        if edges is None:
            return None
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        return e.tolist()

    def log_delta(self, request_id: int, added, removed) -> int:
        """Append one delta record; returns its sequence number."""
        seq = self.next_seq
        self.next_seq += 1
        self._append(
            ["delta", seq, int(request_id), self._edges_list(added),
             self._edges_list(removed)]
        )
        return seq

    def log_apply(self, seq: int, count: int) -> None:
        self._append(["apply", int(seq), int(count)])

    def log_error(self, seq: int) -> None:
        """The delta at ``seq`` exhausted its retries and was NACKed to the
        caller; restore treats it as consumed (never resurrected)."""
        self._append(["error", int(seq)])

    def log_close(self, count: int) -> None:
        self._append(["close", int(count)])

    def snapshot(self, state, applied_seq: int, *, sync: bool = False) -> None:
        """Snapshot the stream's stores at delta cursor ``applied_seq``."""
        tree, extra = state.snapshot_tree()
        extra["applied_seq"] = int(applied_seq)
        # Steps must be >= 0 and strictly ordered by progress; the seed
        # snapshot (nothing applied yet, applied_seq == -1) is step 0.
        step = int(applied_seq) + 1
        if sync:
            self.snaps.save(step, tree, extra)
        else:
            self.snaps.save_async(step, tree, extra)

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:  # pragma: no cover - double close is fine
            pass

    @staticmethod
    def read_records(path: str | Path) -> list:
        """Parse crc-framed records; a torn/corrupt tail truncates the log."""
        records: list = []
        p = Path(path)
        if not p.exists():
            return records
        for line in p.read_text(encoding="utf-8", errors="replace").splitlines():
            try:
                crc, payload = line.split(" ", 1)
                if int(crc, 16) != zlib.crc32(payload.encode("utf-8")):
                    break
                records.append(json.loads(payload))
            except ValueError:  # bad frame, bad hex, or bad JSON: torn tail
                break
        return records


@dataclasses.dataclass
class _StreamEntry:
    """Server-side bookkeeping for one hosted stream."""

    state: object  # core.streaming.StreamingTCState
    wal: StreamWAL | None = None
    charge: int = 0  # standing device-budget charge (0 while spilled)
    last_used: int = 0  # monotonic LRU tick
    applied_seq: int = -1  # WAL seq of the last applied delta
    snap_pending: int = 0  # applies since the last snapshot


class TCServer:
    """Request queue + admission control + fused dispatch (see module doc).

    Intake (``submit`` / ``submit_delta`` / ``create_stream`` /
    ``close_stream``) is lock-protected so multiple producer threads can
    feed one server; run ONE drain loop (``drain()`` calls or a single
    ``serve_forever()`` daemon thread) — the drain takes the same lock
    around queue pops and stream mutation.
    """

    def __init__(self, config: ServeConfig | None = None):
        self.config = config or ServeConfig()
        self.device = resolve_device(self.config.device)
        if self.config.mesh is not None:
            mesh_device(self.config.mesh, self.device)  # a Mesh of the server's kind
        self.pool = ExecutorPool(max_graphs=self.config.pool_max_graphs)
        self.multi = MultiGraphExecutor(
            max_batches=self.config.fused_max_batches,
            max_fused_pairs=self.config.max_fused_pairs,
            device=self.device,
        )
        self._queue: collections.deque[ServeRequest] = collections.deque()
        self._delta_queue: collections.deque = collections.deque()
        self._streams: dict[int, _StreamEntry] = {}
        self._stream_bytes = 0
        self._next_id = 0
        self.stats: dict = collections.Counter()
        self._lock = threading.RLock()
        self._result_cv = threading.Condition(self._lock)
        self._results: dict[int, ServeResult] = {}
        self._stop = threading.Event()
        self._tick = 0
        self._req_ckpt_step = 0
        self.restore_info: dict | None = None
        self._wal_root: Path | None = (
            Path(self.config.wal_dir) if self.config.wal_dir else None
        )
        if self._wal_root is not None:
            self._wal_root.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------- intake

    def submit(self, sbf: sbf_mod.SlicedBitmap, wl: sbf_mod.Worklist) -> int:
        """Enqueue one graph; returns its request id. Thread-safe."""
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._queue.append(ServeRequest(rid, sbf, wl, submitted_s=time.perf_counter()))
            self.stats["submitted"] += 1
            return rid

    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._delta_queue)

    def _bump_tick(self) -> int:
        self._tick += 1
        return self._tick

    def _maybe_inject(self, step: int) -> None:
        # Fault injection point: checked with the request id before every
        # dispatch attempt (initial and retries), so a test can target one
        # request — and, with repeats>1, keep it failing past the retries.
        inj = self.config.injector
        if inj is not None:
            inj.check(int(step))

    # ----------------------------------------------------------- streaming

    @staticmethod
    def _stream_footprint(sb: sbf_mod.SlicedBitmap) -> int:
        """Resident device bytes a stream's pow2-padded stores occupy."""
        w = int(sb.words_per_slice) * 4
        return (
            pow2_ceil(max(int(sb.row_slice_data.shape[0]), 1))
            + pow2_ceil(max(int(sb.col_slice_data.shape[0]), 1))
        ) * w

    def _stream_backend(self) -> str:
        return {v: k for k, v in _SERVE_BACKENDS.items()}.get(
            self.config.mode, "pallas_total"
        )

    def create_stream(self, edges, *, n: int | None = None,
                      slice_bits: int = 64) -> int:
        """Host a long-lived streaming graph; returns its stream id.

        The stream's resident store footprint is charged against
        ``memory_budget_bytes`` for as long as it lives (unlike one-shot
        requests, whose stores are only staged for a wave), shrinking every
        later wave's admission budget — so one server honors one memory
        bound across both request kinds. Under pressure, idle streams are
        LRU-spilled first; raises only when the stream cannot fit the
        budget even with every other stream spilled. ``close_stream``
        releases it. With ``wal_dir`` set the stream is durable from birth:
        its seed snapshot commits synchronously before this returns.
        """
        with self._lock:
            state = StreamingTCState(
                edges, n=n, slice_bits=slice_bits,
                backend=self._stream_backend(),
                chunk_pairs=self.config.chunk_pairs,
                device=self.device,
            )
            cost = self._stream_footprint(state._sbf)
            self._evict_to_fit(cost)
            budget = int(self.config.memory_budget_bytes) - self._stream_bytes
            if cost > budget:
                raise ValueError(
                    f"stream footprint {cost}B exceeds remaining budget "
                    f"{budget}B ({len(self._streams)} streams resident)"
                )
            sid = self._next_id
            self._next_id += 1
            entry = _StreamEntry(
                state=state, charge=cost, last_used=self._bump_tick()
            )
            if self._wal_root is not None:
                entry.wal = self._make_wal(sid)
                entry.wal.snapshot(state, -1, sync=True)
            self._streams[sid] = entry
            self._stream_bytes += cost
            self.stats["streams"] += 1
            self._write_manifest()
            return sid

    def close_stream(self, stream_id: int) -> int:
        """Close a stream, releasing its budget; returns its final count.

        Raises ``ValueError`` on an unknown (or already-closed) id — the
        pop-once shape below releases the budget charge exactly once even
        if a racing caller closes the same id twice.
        """
        with self._lock:
            entry = self._streams.pop(stream_id, None)
            if entry is None:
                raise ValueError(f"unknown stream id {stream_id}")
            self._stream_bytes -= entry.charge
            count = int(entry.state.triangles)
            if entry.wal is not None:
                entry.wal.log_close(count)
                entry.wal.snaps.wait()
                entry.wal.close()
                shutil.rmtree(entry.wal.directory, ignore_errors=True)
            self._write_manifest()
            return count

    def stream_count(self, stream_id: int) -> int:
        """The stream's current running triangle count (no dispatch)."""
        with self._lock:
            entry = self._streams.get(stream_id)
            if entry is None:
                raise ValueError(f"unknown stream id {stream_id}")
            return int(entry.state.triangles)

    def submit_delta(self, stream_id: int, added=None, removed=None) -> int:
        """Enqueue one edge batch against a hosted stream; returns its
        request id. Processed FIFO at the next ``drain()``; the result's
        ``count`` is the stream's running total after the batch. With a
        WAL attached the delta is logged to disk BEFORE it enqueues —
        write-ahead — so a kill between submit and drain loses nothing.
        """
        with self._lock:
            entry = self._streams.get(stream_id)
            if entry is None:
                raise ValueError(f"unknown stream id {stream_id}")
            rid = self._next_id
            self._next_id += 1
            seq = None
            if entry.wal is not None:
                seq = entry.wal.log_delta(rid, added, removed)
            self._delta_queue.append(
                (rid, stream_id, seq, added, removed, time.perf_counter())
            )
            self.stats["submitted"] += 1
            return rid

    # ----------------------------------------------------- eviction / spill

    def _evict_to_fit(self, need_bytes: int, keep: int | None = None) -> bool:
        """Spill LRU idle streams until ``need_bytes`` fits the budget.

        A spilled stream drops its device stores (the host mirror stays
        authoritative — ``StreamingTCState.spill``) and its standing charge
        returns to the admission pool; the next delta that touches it
        re-admits it transparently. Returns True when the bytes fit.
        """
        total = int(self.config.memory_budget_bytes)
        if total - self._stream_bytes >= need_bytes:
            return True
        order = sorted(
            (e.last_used, sid)
            for sid, e in self._streams.items()
            if e.state.resident and sid != keep
        )
        for _, sid in order:
            e = self._streams[sid]
            e.state.spill()
            self._stream_bytes -= e.charge
            e.charge = 0
            self.stats["spills"] += 1
            if total - self._stream_bytes >= need_bytes:
                return True
        return total - self._stream_bytes >= need_bytes

    def _readmit(self, sid: int, entry: _StreamEntry) -> None:
        """Rebuild a spilled stream's executor and restore its charge."""
        need = self._stream_footprint(entry.state._sbf)
        self._evict_to_fit(need, keep=sid)
        entry.state.ensure_resident()
        entry.charge = need
        self._stream_bytes += need
        self.stats["readmits"] += 1

    # ----------------------------------------------------------- durability

    def _make_wal(self, sid: int) -> StreamWAL:
        return StreamWAL(
            self._wal_root / f"stream_{sid:06d}",
            checkpoint_every=self.config.checkpoint_every,
            keep_last=self.config.snap_keep_last,
        )

    def _write_manifest(self) -> None:
        """Atomically publish server.json under the WAL root (no-op when
        durability is off). Called on stream create/close and checkpoint —
        the delta/apply flow is already durable via the per-stream WALs."""
        if self._wal_root is None:
            return
        m = {
            "version": 1,
            "next_id": int(self._next_id),
            "config": {
                k: getattr(self.config, k) for k in _MANIFEST_CONFIG_KEYS
            },
            "streams": {
                str(sid): {"dir": f"stream_{sid:06d}"} for sid in self._streams
            },
        }
        tmp = self._wal_root / ".server.json.tmp"
        tmp.write_text(json.dumps(m, indent=1))
        os.replace(tmp, self._wal_root / "server.json")

    def checkpoint(self, directory: str | Path | None = None) -> dict:
        """Synchronous full checkpoint: streams, pending queues, next-id.

        With ``wal_dir`` configured, ``directory`` may be omitted (or must
        match it); a server created without a WAL root adopts ``directory``
        as one — existing streams get WALs and already-queued deltas are
        logged into them. Every stream snapshots synchronously; pending
        one-shot requests persist under ``requests/``. Returns summary
        counts. Budget charges are not persisted: they are a pure function
        of each stream's stores and are recomputed exactly on restore.
        """
        with self._lock:
            root = Path(directory) if directory is not None else self._wal_root
            if root is None:
                raise ValueError(
                    "no checkpoint directory: pass one or set ServeConfig.wal_dir"
                )
            if self._wal_root is None:
                self._wal_root = root
                self._wal_root.mkdir(parents=True, exist_ok=True)
            elif root != self._wal_root:
                raise ValueError(
                    f"checkpoint dir {root} != configured wal_dir "
                    f"{self._wal_root}; one server keeps one durable root"
                )
            for sid, entry in self._streams.items():
                if entry.wal is None:
                    entry.wal = self._make_wal(sid)
            # Late-adopted WAL: queued deltas submitted before the root
            # existed get logged now (write-ahead from here on out).
            requeued = collections.deque()
            for rid, sid, seq, added, removed, t0 in self._delta_queue:
                entry = self._streams.get(sid)
                if entry is not None and entry.wal is not None and seq is None:
                    seq = entry.wal.log_delta(rid, added, removed)
                requeued.append((rid, sid, seq, added, removed, t0))
            self._delta_queue = requeued
            for entry in self._streams.values():
                entry.wal.snapshot(entry.state, entry.applied_seq, sync=True)
                entry.snap_pending = 0
            self._save_requests(root)
            self._write_manifest()
            self.stats["checkpoints"] += 1
            return {
                "streams": len(self._streams),
                "pending_deltas": len(self._delta_queue),
                "pending_requests": len(self._queue),
            }

    def _save_requests(self, root: Path) -> None:
        """Persist pending one-shot requests (stores + worklists)."""
        mgr = CheckpointManager(root / "requests", keep_last=1)
        tree: dict = {}
        meta = []
        for req in self._queue:
            sb = req.sbf.to_host()
            wl = req.wl
            tree[f"r{req.request_id}"] = {
                "row_ptr": sb.row_ptr,
                "row_slice_idx": sb.row_slice_idx,
                "row_slice_data": sb.row_slice_data,
                "col_ptr": sb.col_ptr,
                "col_slice_idx": sb.col_slice_idx,
                "col_slice_data": sb.col_slice_data,
                "pair_edge": np.asarray(wl.pair_edge),
                "pair_row_pos": np.asarray(wl.pair_row_pos),
                "pair_col_pos": np.asarray(wl.pair_col_pos),
            }
            meta.append({
                "rid": int(req.request_id),
                "slice_bits": int(sb.slice_bits),
                "n": int(sb.n),
                "n_slices": int(sb.n_slices),
                "m_edges": int(wl.m_edges),
                "wl_n_slices": int(wl.n_slices),
            })
        self._req_ckpt_step += 1
        mgr.save(self._req_ckpt_step, tree, extra={"requests": meta})

    def _load_requests(self, root: Path, info: dict) -> None:
        rdir = root / "requests"
        step = latest_step(rdir)
        if step is None:
            return
        manifest = json.loads(
            (rdir / f"step_{step:08d}" / "manifest.json").read_text()
        )
        meta = manifest["extra"]["requests"]
        if not meta:
            return
        tree_like = {
            f"r{m['rid']}": {leaf: 0 for leaf in _REQ_LEAVES} for m in meta
        }
        tree, _, _ = load_checkpoint(rdir, tree_like, step=step)
        for m in meta:
            sub = tree[f"r{m['rid']}"]
            sb = sbf_mod.SlicedBitmap(
                slice_bits=int(m["slice_bits"]),
                n=int(m["n"]),
                n_slices=int(m["n_slices"]),
                row_ptr=sub["row_ptr"],
                row_slice_idx=sub["row_slice_idx"],
                row_slice_data=sub["row_slice_data"],
                col_ptr=sub["col_ptr"],
                col_slice_idx=sub["col_slice_idx"],
                col_slice_data=sub["col_slice_data"],
            )
            wl = sbf_mod.Worklist(
                pair_edge=sub["pair_edge"],
                pair_row_pos=sub["pair_row_pos"],
                pair_col_pos=sub["pair_col_pos"],
                m_edges=int(m["m_edges"]),
                n_slices=int(m["wl_n_slices"]),
            )
            self._queue.append(
                ServeRequest(int(m["rid"]), sb, wl,
                             submitted_s=time.perf_counter())
            )
        info["requeued_requests"] = len(meta)
        self._req_ckpt_step = step

    def _restore_stream(self, sid: int, sdir: Path):
        """Rebuild one stream from its WAL dir.

        Returns ``(entry, pending_deltas, info)`` — or ``None`` when the
        stream was closed, or had no committed snapshot (killed inside
        ``create_stream``'s synchronous seed save: detected, not silently
        wrong).
        """
        wal = StreamWAL(
            sdir,
            checkpoint_every=self.config.checkpoint_every,
            keep_last=self.config.snap_keep_last,
        )
        records = StreamWAL.read_records(wal.path)
        if any(r and r[0] == "close" for r in records):
            wal.close()
            return None
        orphans = wal.snaps.gc_orphans()
        step = wal.snaps.latest_step()
        if step is None:
            wal.close()
            return None
        tree_like = {k: 0 for k in StreamingTCState._SNAP_LEAVES}
        tree, _, extra = wal.snaps.restore(tree_like, step=step)
        state = StreamingTCState.from_snapshot(
            tree, extra,
            backend=self._stream_backend(),
            chunk_pairs=self.config.chunk_pairs,
            device=self.device,
        )
        snap_seq = int(extra.get("applied_seq", -1))
        applied_set = {r[1] for r in records if r[0] == "apply"}
        error_set = {r[1] for r in records if r[0] == "error"}
        applied = max(applied_set | error_set, default=-1)
        replayed = 0
        pending = []
        for rec in records:
            if rec[0] != "delta":
                continue
            _, seq, rid, added, removed = rec
            if seq <= snap_seq:
                continue
            if seq in applied_set:
                # Marked applied pre-kill: replay to the exact pre-kill
                # count. Validation-rejected batches re-reject identically
                # (validation is deterministic and precedes any mutation).
                try:
                    state.apply_batch(added, removed)
                except ValueError:
                    pass
                replayed += 1
            elif seq in error_set:
                # Exhausted its retries pre-kill; the producer was NACKed.
                continue
            else:
                pending.append((rid, sid, seq, added, removed))
        wal.next_seq = 1 + max(
            (r[1] for r in records if r[0] == "delta"), default=-1
        )
        entry = _StreamEntry(
            state=state,
            wal=wal,
            charge=self._stream_footprint(state._sbf),
            last_used=self._bump_tick(),
            applied_seq=max(applied, snap_seq),
            snap_pending=max(applied - snap_seq, 0),
        )
        info = {
            "count": int(state.triangles),
            "replayed": replayed,
            "requeued": len(pending),
            "snapshot_step": int(step),
            "orphans_gc": int(orphans),
        }
        return entry, pending, info

    @classmethod
    def restore(cls, directory: str | Path, *, config: ServeConfig | None = None,
                mesh=None, device: str | torch.device | None = None) -> "TCServer":
        """Rebuild a killed server from its WAL root (this package's or the
        reference's).

        Streams load their latest committed snapshot and replay the <=
        ``checkpoint_every`` deltas the WAL marks applied (equal running
        counts); unapplied logged deltas re-enqueue as pending work, as do
        one-shot requests persisted by ``checkpoint()``. Budget charges and
        ``next_id`` are reconstructed; ``restore_info`` on the returned
        server reports per-stream replay and GC counts. ``config`` overrides
        the persisted knobs (the mesh, injector, resilience policy and
        device never persist — pass them anew; ``device`` here, when given,
        overrides ``config.device``, and defaults to the card).
        """
        root = Path(directory)
        manifest = {}
        mp = root / "server.json"
        if mp.exists():
            manifest = json.loads(mp.read_text())
        if config is None:
            kw = dict(manifest.get("config", {}))
            config = ServeConfig(**kw) if kw else ServeConfig()
        config.wal_dir = str(root)
        if mesh is not None:
            config.mesh = mesh
        if device is not None:
            config.device = device
        server = cls(config)
        info: dict = {"streams": {}, "requeued_deltas": 0}
        stream_dirs = {
            int(s): root / rec["dir"]
            for s, rec in manifest.get("streams", {}).items()
        }
        if not stream_dirs:
            stream_dirs = {
                int(p.name.split("_")[1]): p
                for p in sorted(root.glob("stream_*"))
            }
        pending: list = []
        for sid, sdir in sorted(stream_dirs.items()):
            if not sdir.is_dir():
                continue
            out = server._restore_stream(sid, sdir)
            if out is None:
                continue
            entry, stream_pending, sinfo = out
            server._streams[sid] = entry
            server._stream_bytes += entry.charge
            pending.extend(stream_pending)
            info["streams"][sid] = sinfo
        pending.sort(key=lambda t: t[0])  # rid order == submission order
        now = time.perf_counter()
        for rid, sid, seq, added, removed in pending:
            server._delta_queue.append((rid, sid, seq, added, removed, now))
        info["requeued_deltas"] = len(pending)
        server._load_requests(root, info)
        ids = (
            [s for s in server._streams]
            + [r[0] for r in pending]
            + [r.request_id for r in server._queue]
        )
        server._next_id = max(
            [int(manifest.get("next_id", 0))] + [i + 1 for i in ids]
        )
        # A smaller budget than the streams were checkpointed under still
        # restores: LRU-spill until the standing charges fit.
        server._evict_to_fit(0)
        server.stats["streams"] = len(server._streams)
        server.restore_info = info
        server._write_manifest()
        return server

    # --------------------------------------------------------- delta drain

    def _apply_delta(self, rid, sid, seq, added, removed, t0) -> ServeResult:
        """Apply one queued delta with isolation, WAL markers, compaction."""
        entry = self._streams.get(sid)
        if entry is None:
            return ServeResult(
                rid, status="rejected", count=None, placement="streaming",
                latency_s=time.perf_counter() - t0,
                detail=f"stream {sid} was closed",
            )
        state = entry.state
        if not state.resident:
            self._readmit(sid, entry)
        entry.last_used = self._bump_tick()
        attempts = 0
        while True:
            try:
                self._maybe_inject(rid)
                res = state.apply_batch(added, removed)
                break
            except ValueError as e:
                # Validation refused the batch before any mutation; mark it
                # consumed in the WAL (count unchanged) so restore's replay
                # treats it exactly like the live path did.
                self.stats["delta_rejected"] += 1
                if entry.wal is not None and seq is not None:
                    entry.wal.log_apply(seq, int(state.triangles))
                    entry.applied_seq = seq
                    # Rejections advance the replay cursor too, so they
                    # count toward the snapshot cadence — the <=
                    # checkpoint_every replay bound must hold even for
                    # reject-heavy logs.
                    entry.snap_pending += 1
                    if entry.snap_pending >= entry.wal.checkpoint_every:
                        entry.wal.snapshot(state, entry.applied_seq)
                        entry.snap_pending = 0
                return ServeResult(
                    rid, status="rejected", count=None, placement="streaming",
                    latency_s=time.perf_counter() - t0, detail=str(e),
                    retries=attempts,
                )
            except Exception as e:  # isolated failure: bounded retry
                attempts += 1
                self.stats["retries"] += 1
                if attempts > int(self.config.max_retries):
                    self.stats["errors"] += 1
                    # Error marker: the caller is told status='error', so
                    # restore consumes the seq instead of resurrecting a
                    # batch the producer already knows failed — restored
                    # counts stay bit-identical to the live server's.
                    if entry.wal is not None and seq is not None:
                        entry.wal.log_error(seq)
                        entry.applied_seq = seq
                        entry.snap_pending += 1
                        if entry.snap_pending >= entry.wal.checkpoint_every:
                            entry.wal.snapshot(state, entry.applied_seq)
                            entry.snap_pending = 0
                    return ServeResult(
                        rid, status="error", count=None,
                        placement="streaming",
                        latency_s=time.perf_counter() - t0,
                        detail=f"{type(e).__name__}: {e}",
                        retries=attempts - 1,
                    )
                time.sleep(float(self.config.retry_backoff_s) * attempts)
        # Growth can bump the pow2 store bucket: keep the standing
        # charge honest so admission budgets stay exact.
        after = self._stream_footprint(state._sbf)
        self._stream_bytes += after - entry.charge
        entry.charge = after
        self.stats["deltas"] += 1
        if entry.wal is not None and seq is not None:
            entry.wal.log_apply(seq, int(state.triangles))
            entry.applied_seq = seq
            entry.snap_pending += 1
            if entry.snap_pending >= entry.wal.checkpoint_every:
                entry.wal.snapshot(state, entry.applied_seq)
                entry.snap_pending = 0
        ratio = float(self.config.compact_ratio)
        if ratio > 0 and res.removed and state.zero_record_ratio() >= ratio:
            state.compact()
            self.stats["compactions"] += 1
            compacted = self._stream_footprint(state._sbf)
            self._stream_bytes += compacted - entry.charge
            entry.charge = compacted
            if entry.wal is not None:
                entry.wal.snapshot(state, entry.applied_seq)
                entry.snap_pending = 0
        return ServeResult(
            rid, status="ok", count=int(res.triangles),
            placement="streaming",
            latency_s=time.perf_counter() - t0,
            detail=f"stream {sid} delta {res.delta:+d}",
            retries=attempts,
        )

    def _drain_deltas(self) -> list[ServeResult]:
        """Apply every queued delta batch in FIFO order.

        Deltas run before the one-shot waves: they edit resident stores in
        place (O(touched pairs), no admission footprint beyond the stream's
        standing charge) and later one-shot placement decisions see the
        post-update budget. A batch that fails validation reports
        ``status='rejected'`` (stream untouched — validation precedes any
        mutation); one that keeps raising reports ``status='error'`` after
        ``max_retries`` — either way the server keeps draining.
        """
        results: list[ServeResult] = []
        while True:
            with self._lock:
                if not self._delta_queue:
                    break
                rid, sid, seq, added, removed, t0 = self._delta_queue.popleft()
                results.append(
                    self._apply_delta(rid, sid, seq, added, removed, t0)
                )
        return results

    # ---------------------------------------------------------- admission

    def _fuseable(self, req: ServeRequest) -> bool:
        if not self.config.fuse:
            return False
        if req.num_pairs > self.config.max_fused_pairs:
            return False
        wps = int(req.sbf.words_per_slice)
        # The per-segment int32 bound the fused kernel needs.
        return pow2_ceil(max(req.num_pairs, 1)) * wps <= INT32_SAFE_WORDS

    def _admit_wave(self) -> tuple[list[ServeRequest], list[ServeResult]]:
        """FIFO-admit queued requests into one budgeted wave.

        Returns ``(admitted, rejected_results)``. Under pressure the head
        request first LRU-spills idle streams; only a request whose own
        footprint exceeds even the spill-freed budget is rejected. One over
        the wave's *remaining* budget stays queued for the next wave
        (head-of-line — admission stays FIFO-fair, no starvation).
        """
        admitted: list[ServeRequest] = []
        rejected: list[ServeResult] = []
        used = 0
        while self._queue:
            req = self._queue[0]
            cost = req.footprint_bytes(self.config.chunk_pairs)
            # Resident streams hold their standing charge across waves —
            # recomputed per iteration because spills release it mid-loop.
            budget = int(self.config.memory_budget_bytes) - self._stream_bytes
            if cost > budget:
                self._evict_to_fit(cost)
                budget = int(self.config.memory_budget_bytes) - self._stream_bytes
            if cost > budget:
                self._queue.popleft()
                self.stats["rejected"] += 1
                rejected.append(
                    ServeResult(
                        req.request_id,
                        status="rejected",
                        count=None,
                        placement=None,
                        latency_s=time.perf_counter() - req.submitted_s,
                        detail=f"footprint {cost}B exceeds budget {budget}B",
                    )
                )
                continue
            if used + cost > budget and admitted:
                break  # wave full; head waits for the next wave
            self._queue.popleft()
            admitted.append(req)
            used += cost
        self.stats["admitted"] += len(admitted)
        return admitted, rejected

    # ----------------------------------------------------------- dispatch

    def _dispatch_fused(self, groups: list[list[ServeRequest]]) -> list:
        """Batch each word-width group and dispatch every batch at once.

        Batches are packed by each graph's pow2 pair bucket: a batch's
        shared bucket is the max inside it, so mixing a 256-pair tenant into
        a 16384-bucket batch would sentinel-pad it 64x. Grouping by equal
        bucket keeps staged/computed lanes at each graph's own pow2 cost,
        at most ``max_fused_graphs`` graphs a batch; the batches of every
        group then share one ``count_fused_wave_async``.

        A batch that fails injection or planning poisons only itself: the
        failure is parked in its future (and the batch stays out of the
        launch) and handled per request at readback, as is a refused launch.
        """
        cap = max(int(self.config.max_fused_graphs), 1)
        batches = []
        for group in groups:
            by_bucket: dict[int, list[ServeRequest]] = collections.defaultdict(list)
            for r in group:
                by_bucket[pow2_ceil(max(r.num_pairs, 1))].append(r)
            for bucket in sorted(by_bucket, reverse=True):
                same = by_bucket[bucket]
                batches.extend(same[i : i + cap] for i in range(0, len(same), cap))
        dispatched, ready = [], []
        for batch in batches:
            try:
                for r in batch:
                    self._maybe_inject(r.request_id)
            except Exception as e:
                dispatched.append(("fused", batch, _FailedFuture(e)))
                continue
            ready.append(len(dispatched))
            dispatched.append(("fused", batch, None))
        if not ready:
            return dispatched
        try:
            futures = self.multi.count_fused_wave_async(
                [[(r.sbf, r.wl) for r in dispatched[i][1]] for i in ready]
            )
        except Exception as e:
            futures = [_FailedFuture(e)] * len(ready)
        for i, fut in zip(ready, futures):
            batch = dispatched[i][1]
            dispatched[i] = ("fused", batch, fut)
            if not fut.failed:
                self.stats["fused_batches"] += 1
                self.stats["fused_graphs"] += len(batch)
        return dispatched

    def _dispatch_solo(self, req: ServeRequest):
        """Single-graph dispatch; failures are parked in a ``_FailedFuture``
        (uniform isolation at readback)."""
        try:
            self._maybe_inject(req.request_id)
            return self._plan_and_dispatch(req)
        except Exception as e:
            return ("solo", [req], _FailedFuture(e))

    def _plan_and_dispatch(self, req: ServeRequest):
        """Placement-aware single-graph dispatch (``plan_execution``): the
        pooled executor when replicated, else the mesh's sharded path, or
        the resilient driver for a sharded_2d solo under ``resilience``."""
        mesh = self.config.mesh
        if mesh is not None:
            grid = tuple(int(x) for x in mesh.devices.shape)
            topo = DeviceTopology(num_devices=mesh.size, platform=mesh.platform)
        else:
            grid = None
            topo = DeviceTopology(num_devices=1, platform=self.device.type)
        plan = plan_execution(
            req.sbf,
            req.wl,
            topo,
            chunk_pairs=self.config.chunk_pairs,
            shard_above_bytes=self.config.shard_above_bytes,
            grid=grid if grid is not None and len(grid) == 2 else None,
        )
        if plan.placement == "replicated" or mesh is None:
            fut = self.pool.count_async(
                req.sbf,
                req.wl,
                mode=self.config.mode,
                chunk_pairs=self.config.chunk_pairs,
                device=self.device,
            )
            placement = "replicated"
        elif self.config.resilience is not None and plan.placement == "sharded_2d":
            from repro_torch.distributed.resilient import resilient_tc_count

            cfg = self.config.resilience.for_request(req.request_id)
            fut = _DeferredFuture(
                lambda: resilient_tc_count(
                    req.sbf, req.wl, mesh, cfg, chunk_pairs=self.config.chunk_pairs,
                )[0]
            )
            placement = plan.placement
            self.stats["resilient_solos"] += 1
        else:
            from repro_torch.distributed.tc import distributed_tc_count_async

            fut = distributed_tc_count_async(
                req.sbf, req.wl, mesh, placement=plan.placement
            )
            placement = plan.placement
        self.stats[f"solo_{placement}"] += 1
        return (placement, [req], fut)

    def _retry_solo(self, req: ServeRequest, err: Exception) -> ServeResult:
        """Bounded retry-with-backoff after an isolated request failure."""
        detail = f"{type(err).__name__}: {err}"
        attempts = 0
        while attempts < int(self.config.max_retries):
            attempts += 1
            self.stats["retries"] += 1
            time.sleep(float(self.config.retry_backoff_s) * attempts)
            try:
                placement, _, fut = self._dispatch_solo(req)
                count = int(fut.result())
            except Exception as e:
                detail = f"{type(e).__name__}: {e}"
                continue
            return ServeResult(
                req.request_id, status="ok", count=count,
                placement=placement,
                latency_s=time.perf_counter() - req.submitted_s,
                detail=f"recovered after {detail}", retries=attempts,
            )
        self.stats["errors"] += 1
        return ServeResult(
            req.request_id, status="error", count=None, placement=None,
            latency_s=time.perf_counter() - req.submitted_s,
            detail=detail, retries=attempts,
        )

    def drain(self) -> list[ServeResult]:
        """Serve the whole queue in budgeted waves; return every result.

        Within a wave everything is dispatched before anything is read back,
        so graph closes overlap the remaining dispatches. A request whose
        future raises is retried solo (bounded) and reports
        ``status="error"`` with typed detail only when retries exhaust; the
        rest of the wave is unaffected. Queued deltas drain first
        (``_drain_deltas``).
        """
        results: list[ServeResult] = self._drain_deltas()
        while True:
            with self._lock:
                if not self._queue:
                    break
                admitted, rejected = self._admit_wave()
            results.extend(rejected)
            if not admitted:
                break  # everything left was rejected
            self.stats["waves"] += 1
            by_wps: dict[int, list[ServeRequest]] = collections.defaultdict(list)
            solos: list[ServeRequest] = []
            for req in admitted:
                if self._fuseable(req):
                    by_wps[int(req.sbf.words_per_slice)].append(req)
                else:
                    solos.append(req)
            dispatched = self._dispatch_fused(list(by_wps.values()))
            for req in solos:
                dispatched.append(self._dispatch_solo(req))
            for placement, batch, fut in dispatched:
                try:
                    counts = fut.result()
                except Exception as e:
                    self.stats["wave_failures"] += 1
                    for req in batch:
                        results.append(self._retry_solo(req, e))
                    continue
                if placement != "fused":
                    counts = (counts,)
                now = time.perf_counter()
                for req, count in zip(batch, counts):
                    results.append(
                        ServeResult(
                            req.request_id,
                            status="ok",
                            count=int(count),
                            placement=placement,
                            latency_s=now - req.submitted_s,
                            batch_size=len(batch),
                        )
                    )
        return results

    # -------------------------------------------------------------- daemon

    def serve_forever(self, *, on_result=None, poll_s: float = 0.002) -> int:
        """Drain loop for daemon mode; returns requests processed.

        Runs until ``stop()`` is called AND the queues are empty (a stop
        request finishes in-flight work rather than dropping it). Results
        are published to ``wait_result`` and, when given, to ``on_result`` —
        called outside the lock, so a slow callback never blocks producers.
        Run at most one ``serve_forever`` per server.
        """
        processed = 0
        while True:
            if not self.pending:
                if self._stop.is_set():
                    break
                time.sleep(float(poll_s))
                continue
            for r in self.drain():
                processed += 1
                with self._result_cv:
                    self._results[r.request_id] = r
                    self._result_cv.notify_all()
                if on_result is not None:
                    on_result(r)
        return processed

    def stop(self) -> None:
        """Ask ``serve_forever`` to exit once the queues are drained."""
        self._stop.set()

    def wait_result(self, request_id: int, timeout: float = 60.0) -> ServeResult:
        """Block a producer until the daemon publishes its result."""
        with self._result_cv:
            ok = self._result_cv.wait_for(lambda: request_id in self._results, timeout)
            if not ok:
                raise TimeoutError(
                    f"no result for request {request_id} within {timeout}s"
                )
            return self._results.pop(request_id)

    # --------------------------------------------------------------- misc

    def serve(self, jobs) -> list[ServeResult]:
        """Submit every ``(sbf, wl)`` in ``jobs`` and drain — the one-call
        batch API."""
        for sb, wl in jobs:
            self.submit(sb, wl)
        return self.drain()

    def server_stats(self) -> dict:
        """Admission/placement counters plus the two caches' stats."""
        out = dict(self.stats)
        out["pool"] = self.pool.stats()
        out["fused"] = self.multi.stats()
        out["streams_resident"] = sum(
            1 for e in self._streams.values() if e.state.resident
        )
        out["streams_spilled"] = sum(
            1 for e in self._streams.values() if not e.state.resident
        )
        out["stream_bytes"] = int(self._stream_bytes)
        return out
