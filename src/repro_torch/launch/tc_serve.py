"""Triangle-count-as-a-service: the one-shot multi-tenant batch front end.

Port of ``src/repro/launch/tc_serve.py`` for one-shot requests on one
device. A fleet of small graphs drains through fused dispatches of
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
     by ``plan_execution`` (replicated).
  3. **Dispatch** — the wave's fused batches, of every word width, go out
     in one ``count_fused_wave_async`` (one launch of the segment kernel on
     the card for up to ``GROUP_CAP`` batches, one readback), then the
     solos; nothing is read back before everything is dispatched, so closes
     overlap the next dispatches.

**Failure isolation** — a raised future poisons only its own batch: its
requests are retried solo with bounded backoff (``max_retries``/
``retry_backoff_s``) and report ``status="error"`` with a typed detail only
when retries exhaust. ``serve_forever()`` runs the drain loop for producer
threads (``wait_result`` blocks a producer on its request id).

Not ported yet, and raising ``NotImplementedError`` naming their ROADMAP.md
item: hosted streams (``create_stream``, ``submit_delta``, ``close_stream``,
``stream_count``) and their eviction and compaction, the write-ahead log
(``wal_dir``), ``checkpoint``/``restore`` (queue 1, item 3), and the
sharded and resilient solos (``mesh``, ``resilience``; queue 1, item 4).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time

import torch

from repro_torch.core import sbf as sbf_mod
from repro_torch.core.executor import ExecutorPool, MultiGraphExecutor
from repro_torch.core.plan import DeviceTopology, plan_execution, pow2_ceil
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.ops import INT32_SAFE_WORDS

__all__ = ["ServeConfig", "ServeRequest", "ServeResult", "TCServer"]

# User-facing backend name -> Executor mode (``ServeConfig.mode`` speaks
# Executor modes).
_SERVE_BACKENDS = {
    "pallas_total": "fused",
    "pallas_unfused": "gather_then_kernel",
    "pallas_items": "pallas_items",
    "jnp": "jnp",
}

_TODO_STREAMS = "ROADMAP.md queue 1, item 3 (streaming and durable serving)"
_TODO_MESH = "ROADMAP.md queue 1, item 4 (distributed)"


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
    before every dispatch attempt. ``device`` defaults to the card.

    ``mesh``, ``resilience`` and ``wal_dir`` are the reference's sharded,
    resilient and durable options; the server raises ``NotImplementedError``
    when one is set.
    """

    memory_budget_bytes: int = 1 << 30
    max_fused_pairs: int = 1 << 14
    max_fused_graphs: int = 32
    fuse: bool = True
    chunk_pairs: int = 1 << 20
    mode: str = "fused"
    pool_max_graphs: int = 16
    fused_max_batches: int = 8
    max_retries: int = 2
    retry_backoff_s: float = 0.005
    injector: object | None = None  # runtime.fault.FailureInjector
    device: str | torch.device | None = None
    mesh: object | None = None
    resilience: object | None = None
    wal_dir: str | None = None


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

    ``status`` is ``"ok"``, ``"rejected"`` (admission refused it — ``count``
    is None and ``detail`` says why), or ``"error"`` (the request kept
    failing after ``max_retries`` isolated retries — typed ``detail``, every
    other request in the wave unaffected). ``placement`` records how an ok
    request ran: ``"fused"`` (cross-graph batch, with ``batch_size`` graphs
    sharing the dispatch) or ``"replicated"`` (solo). ``latency_s`` is
    submit-to-result; ``retries`` counts recovery attempts that were needed.
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


class TCServer:
    """Request queue + admission control + fused dispatch (see module doc).

    ``submit`` is lock-protected so multiple producer threads can feed one
    server; run ONE drain loop (``drain()`` calls or a single
    ``serve_forever()`` daemon thread) — the drain takes the same lock
    around queue pops.
    """

    def __init__(self, config: ServeConfig | None = None):
        self.config = config or ServeConfig()
        if self.config.mesh is not None or self.config.resilience is not None:
            raise NotImplementedError(
                f"ServeConfig.mesh and .resilience are not ported yet: {_TODO_MESH}"
            )
        if self.config.wal_dir is not None:
            raise NotImplementedError(
                f"ServeConfig.wal_dir is not ported yet: {_TODO_STREAMS}"
            )
        self.device = resolve_device(self.config.device)
        self.pool = ExecutorPool(max_graphs=self.config.pool_max_graphs)
        self.multi = MultiGraphExecutor(
            max_batches=self.config.fused_max_batches,
            max_fused_pairs=self.config.max_fused_pairs,
            device=self.device,
        )
        self._queue: collections.deque[ServeRequest] = collections.deque()
        self._next_id = 0
        self.stats: dict = collections.Counter()
        self._lock = threading.RLock()
        self._result_cv = threading.Condition(self._lock)
        self._results: dict[int, ServeResult] = {}
        self._stop = threading.Event()

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
        return len(self._queue)

    def _maybe_inject(self, step: int) -> None:
        # Fault injection point: checked with the request id before every
        # dispatch attempt (initial and retries), so a test can target one
        # request — and, with repeats>1, keep it failing past the retries.
        inj = self.config.injector
        if inj is not None:
            inj.check(int(step))

    # ------------------------------------------------- not ported (streams)

    def create_stream(self, *args, **kwargs) -> int:
        raise NotImplementedError(f"TCServer.create_stream is not ported yet: {_TODO_STREAMS}")

    def submit_delta(self, *args, **kwargs) -> int:
        raise NotImplementedError(f"TCServer.submit_delta is not ported yet: {_TODO_STREAMS}")

    def close_stream(self, *args, **kwargs) -> int:
        raise NotImplementedError(f"TCServer.close_stream is not ported yet: {_TODO_STREAMS}")

    def stream_count(self, *args, **kwargs) -> int:
        raise NotImplementedError(f"TCServer.stream_count is not ported yet: {_TODO_STREAMS}")

    def checkpoint(self, *args, **kwargs) -> dict:
        raise NotImplementedError(f"TCServer.checkpoint is not ported yet: {_TODO_STREAMS}")

    @classmethod
    def restore(cls, *args, **kwargs) -> "TCServer":
        raise NotImplementedError(f"TCServer.restore is not ported yet: {_TODO_STREAMS}")

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

        Returns ``(admitted, rejected_results)``. A request whose own
        footprint exceeds the budget is rejected; one over the wave's
        *remaining* budget stays queued for the next wave (head-of-line —
        admission stays FIFO-fair, no starvation). No streams are hosted, so
        none holds a standing charge against the budget.
        """
        admitted: list[ServeRequest] = []
        rejected: list[ServeResult] = []
        used = 0
        budget = int(self.config.memory_budget_bytes)
        while self._queue:
            req = self._queue[0]
            cost = req.footprint_bytes(self.config.chunk_pairs)
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
        """Plan one device (replicated) and dispatch on the pooled executor."""
        plan = plan_execution(
            req.sbf, req.wl, DeviceTopology(num_devices=1, platform=self.device.type),
            chunk_pairs=self.config.chunk_pairs,
        )
        fut = self.pool.count_async(
            req.sbf,
            req.wl,
            mode=self.config.mode,
            chunk_pairs=self.config.chunk_pairs,
            device=self.device,
        )
        self.stats[f"solo_{plan.placement}"] += 1
        return (plan.placement, [req], fut)

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
        rest of the wave is unaffected.
        """
        results: list[ServeResult] = []
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

        Runs until ``stop()`` is called AND the queue is empty (a stop
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
        """Ask ``serve_forever`` to exit once the queue is drained."""
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
        """Admission/placement counters plus the two caches' stats. The
        stream counters are 0: no streams are hosted in this port yet."""
        out = dict(self.stats)
        out["pool"] = self.pool.stats()
        out["fused"] = self.multi.stats()
        out["streams_resident"] = 0
        out["streams_spilled"] = 0
        out["stream_bytes"] = 0
        return out
