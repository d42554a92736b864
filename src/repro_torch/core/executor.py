"""Executor — the schedulable execute-stage unit of the TCIM engine.

Port of ``src/repro/core/executor.py`` (``CountFuture``, ``staged_uploads``,
``Executor`` in every mode with the streaming store edits ``update_stores``/
``adopt_stores`` and ``apply_store_lanes``, ``sbf_content_key``,
``ExecutorPool``, and the cross-graph ``MultiCountFuture``/
``MultiGraphExecutor``).

  * **Fused execute.** Chunks run through ``ops.popcount_and_gather_total``:
    the slice stores are uploaded once and stay resident on the device; only
    index arrays travel per chunk, and the gather happens inside the kernel.
    A device build's stores (``core.build``) are adopted as they lie, and
    its resident ``-1``-padded index arrays run in pow2 windows of views,
    so nothing travels.
  * **Power-of-two buckets.** Stores are zero-row-padded to the next power
    of two (zero slices are exact no-ops: nothing indexes them, and
    ``popcount(0 & x) == 0``); chunks are a power-of-two number of pairs,
    ragged tails padded with the ``-1`` no-op sentinel. PyTorch runs eagerly
    and traces nothing, so the buckets here keep the launch shapes and the
    memory of one count bounded and equal to the reference's.
  * **Device-resident accumulation.** Each chunk's kernel adds into an int32
    ``[total, out_of_range]`` device tensor carried across chunks; the only
    host transfer is the final read in ``CountFuture.result``. When the
    worst-case count ``num_pairs * slice_bits`` could overflow int32, the
    executor instead keeps one such tensor per chunk and sums them exactly
    in Python ints at the close — still a single transfer.
  * **Staged uploads.** Chunk i+1's indices are copied into pinned host
    memory and their non-blocking copy to the device is enqueued before
    chunk i's kernel (``staged_uploads``). Everything runs on the current
    stream, so the copy and the kernel are ordered on the device; what
    overlaps is the host's preparation of the next chunk with the device's
    work on this one.

Execution modes (the engine maps user-facing backends onto these):

    'fused'               gather inside the kernel (default; TCIM semantics)
    'gather_then_kernel'  torch gather + the total kernel (the unfused baseline)
    'pallas_items'        torch gather + the per-pair items kernel, summed
    'jnp'                 torch gather + the byte-table oracle of kernels/ref.py

The three unfused modes gather with ``index_select`` outside any kernel, as
the reference gathers with ``jnp.take``, and count out-of-range indices in
the accumulator's second word like the fused kernel.

``MultiGraphExecutor`` retires a batch of small graphs over stacked stores
and a ``[G, bucket]`` index block planned by ``core.plan.plan_fusion``, and
a serve wave's batches together: one zeroed totals tensor, one launch of
the segment-totals kernel for every ``GROUP_CAP`` batches, one readback.

On the card the fused mode's ``Executor`` validates its resident stores
once, at upload, into a ``GatherTotalLauncher``; a count binds it to its
accumulator and the current stream once, inside the device's context, and
each chunk's launch checks only its index tensors.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import hashlib
import itertools
import weakref

import numpy as np
import torch

from repro_torch.core import sbf as sbf_mod
from repro_torch.core.plan import clamp_chunk_pairs, plan_fusion, pow2_ceil
from repro_torch.kernels import ops, ref
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.tc_gather_popcount import (
    GatherTotalLauncher,
    SegmentTable,
    gather_segment_groups_cuda,
    modeled_hbm_bytes,
)
from repro_torch.runtime.contracts import max_transfers, no_host_sync, note_retrace
from repro_torch.runtime.staging import stage

__all__ = [
    "CountFuture",
    "MultiCountFuture",
    "Executor",
    "ExecutorPool",
    "MultiGraphExecutor",
    "EXECUTOR_MODES",
    "apply_store_lanes",
    "sbf_content_key",
    "staged_uploads",
]

EXECUTOR_MODES = ("fused", "gather_then_kernel", "pallas_items", "jnp")

_INT32_MAX = 2**31 - 1

# Bytes one store-edit lane uploads: its flat word index and both masks,
# packed as one int64 [3, L] array.
LANE_BYTES = 24


class CountFuture:
    """A dispatched count whose host readback is deferred.

    Holds the int32 ``[..., 2]`` device tensors of ``[total, out_of_range]``
    rows of a count whose kernels are all enqueued (one row a chunk, or a
    sharded count's ``[steps, 2]`` accumulator on each device of its mesh);
    ``result()`` performs the host transfer — one copy per device — sums
    every row's total exactly in Python ints and caches the value. It raises
    ``ValueError`` if any pair named a store row past the end of its store
    (the kernel never reads those).
    """

    __slots__ = ("_totals", "_value", "__weakref__")

    def __init__(self, totals):
        self._totals = list(totals)
        self._value: int | None = None

    @property
    def resolved(self) -> bool:
        """True once no device tensors are still held — either ``result()``
        ran or the dispatch held nothing (empty worklist). Pools use this to
        tell in-flight work from evictable executors."""
        return not self._totals

    def result(self) -> int:
        if self._totals is not None:
            # The one host sync of a count: one transfer per device.
            by_device: dict = {}
            for t in self._totals:
                by_device.setdefault(t.device, []).append(t.reshape(-1, 2))
            # tclint: sync-ok(the CountFuture close is the count's one readback)
            host = [row for rows in by_device.values() for row in torch.cat(rows).cpu().tolist()]
            out_of_range = sum(bad for _, bad in host)
            if out_of_range:
                raise ValueError(
                    f"{out_of_range} work-list pairs index past the end of "
                    "their slice store; the count is invalid"
                )
            self._value = sum(total for total, _ in host)
            self._totals = None
        return self._value


def staged_uploads(chunks, put, *, double_buffer: bool = True):
    """Stage device uploads one chunk ahead of the consumer.

    ``chunks`` yields host-side work units; ``put`` turns one into its
    device-resident form. With ``double_buffer`` the i+1-th ``put`` is
    issued before chunk i is yielded; the serial path stages on demand.
    Both yield the same sequence.
    """
    if not double_buffer:
        for chunk in chunks:
            yield put(chunk)
        return
    ahead = None
    for chunk in chunks:
        cur = put(chunk)
        if ahead is not None:
            yield ahead  # consumer dispatches i while i+1 is staged
        ahead = cur
    if ahead is not None:
        yield ahead


def _pad_rows_pow2(a: np.ndarray) -> np.ndarray:
    """Zero-pad a store's rows to the next power of two."""
    rows = a.shape[0]
    bucket = pow2_ceil(max(rows, 1))
    if bucket == rows:
        return a
    return np.concatenate(
        [a, np.zeros((bucket - rows,) + a.shape[1:], dtype=a.dtype)]
    )


def _gather_chunk(row_data, col_data, ridx, cidx, acc):
    """The unfused modes' gather: ``[P, W]`` operands with the fused
    kernel's contract — negative indices gather zeros (no-ops), and
    out-of-range indices are never read but counted into ``acc[1]``."""
    num_rows, num_cols = row_data.shape[0], col_data.shape[0]
    bad = (ridx >= num_rows) | (cidx >= num_cols)
    valid = (ridx >= 0) & (cidx >= 0) & ~bad
    rows = row_data.index_select(0, ridx.clamp(0, num_rows - 1))
    cols = col_data.index_select(0, cidx.clamp(0, num_cols - 1))
    acc[1] += bad.sum().to(torch.int32)
    # Zeroing one side of the AND suffices: x & 0 == 0.
    return torch.where(valid[:, None], rows, 0), cols


def apply_store_lanes(store: torch.Tensor, lanes) -> torch.Tensor:
    """Edit one side's :class:`~repro_torch.core.sbf.UpdateLanes` into a
    resident store IN PLACE and return it.

    Each lane's word becomes ``(old | set_mask) & ~clear_mask``; the store
    holds int32 views of the uint32 words, so the masks travel as int32
    views and ``~`` stays bitwise (bit 31 is the sign bit). Lanes are
    deduplicated by ``update_sbf``, one per ``(pos, word)`` cell, so the
    indexed write has no duplicate index. Nothing is padded (eager torch has
    no traces to key), so no sentinel lane exists to drop. One upload of
    ``LANE_BYTES`` a lane, then a gather and an indexed copy on the current
    stream, ordered after every count already launched on it.
    """
    if lanes is None or lanes.num_lanes == 0:
        return store
    if not store.is_contiguous():
        raise ValueError("apply_store_lanes needs a contiguous store")
    flat = lanes.pos.astype(np.int64) * store.shape[1] + lanes.word
    host = np.stack([flat, lanes.set_mask.view(np.int32), lanes.clear_mask.view(np.int32)])
    dev = stage(host, store.device)
    idx, set_mask, clear_mask = dev[0], dev[1].to(torch.int32), dev[2].to(torch.int32)
    words = store.view(-1)
    words.index_copy_(0, idx, (words.index_select(0, idx) | set_mask) & ~clear_mask)
    return store


class Executor:
    """Device-resident execute stage for one pair of SBF slice stores.

    Upload the stores once, then ``count(worklist)`` (or the lower-level
    ``execute_indices``) any number of times. ``device`` defaults to the
    card; without one, only ``device="cpu"`` runs.

    A streaming state edits the stores batch by batch (``update_stores``,
    ``adopt_stores``). ``store_upload_bytes``, ``lane_upload_bytes`` and
    ``adopts`` count what those edits cost. Binding the stores
    (``_make_launcher``, at construction and in ``adopt_stores``) is a
    retrace event for ``max_retrace``; a count is not.
    """

    def __init__(
        self,
        sb: sbf_mod.SlicedBitmap,
        *,
        mode: str = "fused",
        chunk_pairs: int = 1 << 20,
        device: str | torch.device | None = None,
        double_buffer: bool = True,
    ):
        if mode not in EXECUTOR_MODES:
            raise ValueError(f"mode {mode!r} not in {EXECUTOR_MODES}")
        self.mode = mode
        self.device = resolve_device(device)
        self.words_per_slice = int(sb.row_slice_data.shape[1])
        self.slice_bits = int(sb.slice_bits)
        self.double_buffer = double_buffer
        # Round the chunk DOWN to a power of two (never exceed the caller's
        # memory bound), then clamp so one chunk's worst case provably fits
        # the int32 accumulator: chunk_pairs * words_per_slice * 32 <= 2**31-1.
        self.chunk_pairs = clamp_chunk_pairs(chunk_pairs, self.words_per_slice)
        self.store_upload_bytes = 0
        self.lane_upload_bytes = 0
        self.adopts = 0
        self.row_data = self._upload_store(sb.row_slice_data)
        self.col_data = self._upload_store(sb.col_slice_data)
        self._launcher = self._make_launcher()
        # Weakrefs to unresolved CountFutures. While any is alive the
        # executor's stores back in-flight dispatches, so pools must not free
        # them (``busy``); resolved or collected futures prune lazily.
        self._pending: list = []

    def _make_launcher(self) -> GatherTotalLauncher | None:
        """On the card, the fused kernel's launcher over the current stores
        (validated once; it holds their pointers). A retrace event on every
        device."""
        note_retrace()
        if self.mode == "fused" and self.device.type == "cuda":
            return GatherTotalLauncher(self.row_data, self.col_data)
        return None

    def _track(self, fut: CountFuture) -> CountFuture:
        self._prune()
        if not fut.resolved:
            self._pending.append(weakref.ref(fut))
        return fut

    def _prune(self) -> None:
        self._pending = [
            r for r in self._pending if (f := r()) is not None and not f.resolved
        ]

    @property
    def busy(self) -> bool:
        """True while a dispatched ``CountFuture`` still awaits ``result()``.

        ``ExecutorPool`` never evicts a busy executor: its stores back the
        pending readback."""
        self._prune()
        return bool(self._pending)

    def _upload_store(self, store) -> torch.Tensor:
        """A resident, pow2-row-padded int32 view of the store's uint32 words.

        Host words are padded and copied to the device (on the CPU as well);
        an int32 tensor (a device build's store) is adopted as it lies,
        moved only if it is on another device and padded only if its rows
        are not a power of two — so ``update_stores`` on such an executor
        edits that build's tensors too."""
        if isinstance(store, torch.Tensor):
            if store.dtype != torch.int32 or store.dim() != 2:
                raise ValueError(
                    f"a device store must be a 2-D int32 view of the uint32 "
                    f"words, got {store.dtype} of shape {tuple(store.shape)}"
                )
            if store.device != self.device:
                self.store_upload_bytes += store.numel() * store.element_size()
                store = stage(store, self.device, non_blocking=False)
            rows = store.shape[0]
            bucket = pow2_ceil(max(rows, 1))
            if bucket != rows:
                store = torch.cat([store, store.new_zeros(bucket - rows, store.shape[1])])
            return store
        store = _pad_rows_pow2(np.ascontiguousarray(store, dtype=np.uint32))
        self.store_upload_bytes += store.nbytes
        # A copy on the CPU too: ``update_stores`` edits the executor's
        # stores in place, and must never edit the caller's host arrays.
        return stage(store.view(np.int32), self.device, non_blocking=False, copy=True)

    # ---------------------------------------------------------------- public

    def _chunks(self, row_idx: np.ndarray, col_idx: np.ndarray):
        """Yield host-side (ridx, cidx) int32 chunks in pow2 buckets."""
        p = len(row_idx)
        c = self.chunk_pairs
        for start in range(0, p, c):
            r = np.asarray(row_idx[start : start + c], dtype=np.int32)
            cc = np.asarray(col_idx[start : start + c], dtype=np.int32)
            bucket = pow2_ceil(len(r))
            if bucket != len(r):  # ragged tail -> pad to its pow2 bucket
                pad = bucket - len(r)
                r = np.concatenate([r, np.full(pad, -1, np.int32)])
                cc = np.concatenate([cc, np.full(pad, -1, np.int32)])
            yield r, cc

    def _put(self, chunk) -> tuple[torch.Tensor, torch.Tensor]:
        """One chunk's indices to the device: pinned host memory, then a
        non-blocking copy on the current stream."""
        return tuple(stage(a, self.device) for a in chunk)

    def _device_chunks(self, row_idx: np.ndarray, col_idx: np.ndarray):
        """Upload chunks to the device, one ahead of the consumer."""
        return staged_uploads(
            self._chunks(row_idx, col_idx),
            self._put,
            double_buffer=self.double_buffer,
        )

    def _resident_chunks(self, row_idx: torch.Tensor, col_idx: torch.Tensor):
        """Pow2 windows of resident int32 index tensors: views (no staging);
        only a ragged tail is copied, padded with the ``-1`` sentinel."""
        p = row_idx.shape[0]
        c = self.chunk_pairs
        for start in range(0, p, c):
            r, cc = row_idx[start : start + c], col_idx[start : start + c]
            bucket = pow2_ceil(r.shape[0])
            if bucket != r.shape[0]:
                pad = r.new_full((bucket - r.shape[0],), -1)
                r, cc = torch.cat([r, pad]), torch.cat([cc, pad])
            yield r, cc

    def _step(self, ridx, cidx, acc: torch.Tensor) -> torch.Tensor:
        """Add one chunk into ``acc`` (int32 ``[total, out_of_range]``)."""
        if self.mode == "fused":
            return ops.popcount_and_gather_total(
                self.row_data, self.col_data, ridx, cidx, out=acc
            )
        rows, cols = _gather_chunk(self.row_data, self.col_data, ridx, cidx, acc)
        if self.mode == "gather_then_kernel":
            ops.popcount_and_total(rows, cols, out=acc[:1])
        elif self.mode == "pallas_items":
            acc[0] += ops.popcount_and_items(rows, cols).sum(dtype=torch.int32)
        else:  # 'jnp': the byte-table oracle
            acc[0] += ref.ref_popcount_and_total(rows, cols).to(torch.int32)
        return acc

    def _new_acc(self) -> torch.Tensor:
        return torch.zeros(2, dtype=torch.int32, device=self.device)

    def _stepper(self, acc: torch.Tensor):
        """One chunk's step into ``acc``: on the card the bound launcher
        (``acc`` checked and the stream resolved once), else ``_step``."""
        if self._launcher is not None:
            return self._launcher.bind(acc)
        return functools.partial(self._step, acc=acc)

    def _accumulate(self, device_chunks, worst_pairs: int) -> CountFuture:
        """Dispatch every chunk step; defer the host sync to the future."""
        context = (torch.cuda.device(self.device) if self._launcher is not None
                   else contextlib.nullcontext())
        with context:
            # Worst case: every bit of every referenced slice set.
            if worst_pairs * self.slice_bits <= _INT32_MAX:
                acc = self._new_acc()
                step = self._stepper(acc)
                for ridx, cidx in device_chunks:
                    step(ridx, cidx)
                return CountFuture([acc])
            # Huge work lists: the int32 carry could overflow across chunks;
            # keep per-chunk totals on the device, exact host sum at close.
            accs = []
            for ridx, cidx in device_chunks:
                accs.append(self._new_acc())
                self._stepper(accs[-1])(ridx, cidx)
            return CountFuture(accs)

    @no_host_sync()
    def execute_indices_async(self, row_idx, col_idx, *, num_real: int | None = None
                              ) -> CountFuture:
        """Dispatch a count over explicit index arrays; defer the host sync.

        Every chunk step is enqueued before this returns; the returned
        future's ``result()`` is the one host transfer. Empty work lists
        dispatch nothing. The arrays may be host arrays (staged to the
        device chunk by chunk) or int32 tensors resident on the executor's
        device (``core.build``'s work lists: windows of views, nothing
        staged). ``num_real`` tightens the int32-overflow bound for padded
        arrays whose real (non-sentinel) pair count is known. Contract
        (``TCIM_CONTRACTS=1``): ``no_host_sync``.
        """
        if len(row_idx) != len(col_idx):
            raise ValueError(
                f"index arrays differ in length: {len(row_idx)} vs {len(col_idx)}"
            )
        p = len(row_idx)
        if p == 0 or num_real == 0:
            return CountFuture([])
        worst = num_real if num_real is not None else p
        if isinstance(row_idx, torch.Tensor):
            return self._track(self._accumulate(self._resident_chunks(row_idx, col_idx), worst))
        return self._track(self._accumulate(self._device_chunks(row_idx, col_idx), worst))

    def execute_indices(self, row_idx, col_idx, *, num_real: int | None = None) -> int:
        """Count over explicit work-list index arrays. One host sync total."""
        return self.execute_indices_async(row_idx, col_idx, num_real=num_real).result()

    def count_async(self, wl) -> CountFuture:
        """``count`` with the final host readback deferred to ``result()``.

        ``wl`` is a host ``Worklist`` or a ``core.build.DeviceWorklist``,
        whose padded pair tensors run without touching the host.
        """
        return self.execute_indices_async(
            wl.pair_row_pos, wl.pair_col_pos, num_real=wl.num_pairs
        )

    def count(self, wl) -> int:
        """Triangle contribution of a work list (Eq. 5 execute+reduce)."""
        return self.count_async(wl).result()

    def update_stores(self, row_lanes, col_lanes) -> None:
        """Edit word-level updates (``sbf.UpdateLanes``) into the resident
        stores: the streaming steady state, in place of a re-upload.

        The reference's scatter returns NEW arrays so that a before-count
        still in flight keeps its buffers. Here the edit is IN PLACE
        (``apply_store_lanes``): on the card it is enqueued on the current
        stream, after the before-count's kernels, so they read the
        pre-update words; on the CPU the before-count has already run. In
        place keeps the store pointers that ``GatherTotalLauncher`` bound at
        construction valid, so the launcher needs no rebuild and a steady
        batch copies no store. Positions must be in-bounds for the resident
        (pow2-padded) stores; a grown SBF goes through :meth:`adopt_stores`.
        """
        for lanes, store in ((row_lanes, self.row_data), (col_lanes, self.col_data)):
            if lanes is not None and lanes.num_lanes and int(lanes.pos.max()) >= int(
                store.shape[0]
            ):
                raise ValueError(
                    "update lane position beyond the resident store bucket "
                    "— the SBF grew; re-adopt the stores (adopt_stores)"
                )
        for lanes, store in ((row_lanes, self.row_data), (col_lanes, self.col_data)):
            if lanes is not None and lanes.num_lanes:
                apply_store_lanes(store, lanes)
                self.lane_upload_bytes += LANE_BYTES * lanes.num_lanes

    def adopt_stores(self, sb: sbf_mod.SlicedBitmap) -> None:
        """Replace the resident stores with a (grown or compacted) SBF's —
        one upload — and rebuild the launcher over them.

        Merge-inserted records shift positions, so edits are impossible and
        the stores re-adopt wholesale. Host stores upload with a blocking
        copy, which waits for the stream, so a count already launched has
        finished before the new stores are written; the old stores go back
        to the caching allocator. The launcher must be rebuilt: the old one
        holds the old stores' pointers.
        """
        if int(sb.row_slice_data.shape[1]) != self.words_per_slice:
            raise ValueError(
                f"adopt_stores: words_per_slice {sb.row_slice_data.shape[1]} "
                f"!= executor's {self.words_per_slice}"
            )
        self.row_data = self._upload_store(sb.row_slice_data)
        self.col_data = self._upload_store(sb.col_slice_data)
        self._launcher = self._make_launcher()
        self.adopts += 1

    def modeled_hbm_bytes(self, num_pairs: int, *, fused: bool | None = None) -> int:
        """Modeled execute-stage memory traffic for this store's word width."""
        if fused is None:
            fused = self.mode == "fused"
        return modeled_hbm_bytes(num_pairs, self.words_per_slice, fused=fused)


def sbf_content_key(sb: sbf_mod.SlicedBitmap) -> str:
    """Digest of an SBF's store contents (shape + data).

    Pools key entries by *content*, not object identity, so one-shot API
    calls that rebuild the SBF for the same graph still hit the cached
    executor. blake2b over the raw store bytes, memoized on the (frozen)
    SBF so re-keying the same object pays the hash once. Device-built SBFs
    carry a ``content_key`` (a digest of the input edge list, taken before
    the upload), so keying them never reads the stores back.
    """
    if sb.content_key is not None:
        return sb.content_key
    cached = getattr(sb, "_store_digest", None)
    if cached is not None:
        return cached
    h = hashlib.blake2b(digest_size=16)
    h.update(
        repr((sb.slice_bits, sb.row_slice_data.shape, sb.col_slice_data.shape)).encode()
    )
    h.update(np.ascontiguousarray(sb.row_slice_data).tobytes())
    h.update(np.ascontiguousarray(sb.col_slice_data).tobytes())
    digest = h.hexdigest()
    object.__setattr__(sb, "_store_digest", digest)
    return digest


class ExecutorPool:
    """Executors for a fleet serving many graphs, LRU-bounded, grouped by
    trace key.

    The pool caches one Executor per (graph content, mode, chunk, device,
    options); an evicted graph's device stores are freed, but never while
    its executor is ``busy`` (a dispatched ``CountFuture`` still pending).
    Entries are keyed by store *content* (``sbf_content_key``), so repeated
    counts of the same graph hit even when the caller rebuilds the SBF
    object each time — the case the one-shot ``tcim_count*`` API produces.
    ``stats()`` groups entries by the reference's trace key ``(words, chunk
    bucket, mode, pow2 store rows, pow2 store cols)``: PyTorch traces
    nothing, but equal keys are equal launch shapes.
    """

    def __init__(self, *, max_graphs: int = 16):
        if max_graphs < 1:
            raise ValueError(f"max_graphs must be >= 1, got {max_graphs}")
        self.max_graphs = max_graphs
        # content key -> (trace_key, Executor); ordered for LRU.
        self._entries: collections.OrderedDict[tuple, tuple] = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def trace_key(
        sb: sbf_mod.SlicedBitmap, *, mode: str = "fused", chunk_pairs: int = 1 << 20
    ) -> tuple:
        """The ``(words_per_slice, chunk bucket, mode, store buckets)`` of an
        Executor for ``sb``: equal keys launch equal shapes."""
        wps = int(sb.words_per_slice)
        rows = pow2_ceil(max(int(sb.row_slice_data.shape[0]), 1))
        cols = pow2_ceil(max(int(sb.col_slice_data.shape[0]), 1))
        return (wps, clamp_chunk_pairs(chunk_pairs, wps), mode, rows, cols)

    def get(
        self,
        sb: sbf_mod.SlicedBitmap,
        *,
        mode: str = "fused",
        chunk_pairs: int = 1 << 20,
        device: str | torch.device | None = None,
        **executor_kwargs,
    ) -> Executor:
        """The pooled Executor for ``sb`` (uploading its stores on first use)."""
        dev = resolve_device(device)
        key = (
            sbf_content_key(sb),
            mode,
            clamp_chunk_pairs(chunk_pairs, sb.words_per_slice),
            str(dev),
            tuple(sorted(executor_kwargs.items())),  # config never aliases
        )
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry[1]
        self.misses += 1
        ex = Executor(sb, mode=mode, chunk_pairs=chunk_pairs, device=dev, **executor_kwargs)
        self._entries[key] = (self.trace_key(sb, mode=mode, chunk_pairs=chunk_pairs), ex)
        self._evict()
        return ex

    def _evict(self) -> None:
        """Drop LRU graphs above ``max_graphs`` — never the MRU entry, and
        never one whose executor is ``busy``. Busy executors are skipped (the
        pool may briefly hold more than ``max_graphs``) and reaped on a later
        ``get`` once their futures resolve."""
        while len(self._entries) > self.max_graphs:
            keys = list(self._entries)[:-1]
            victim = next((k for k in keys if not self._entries[k][1].busy), None)
            if victim is None:
                return  # everything in flight; retry on a later get()
            del self._entries[victim]

    def count_async(
        self,
        sb: sbf_mod.SlicedBitmap,
        wl: sbf_mod.Worklist,
        **kwargs,
    ) -> CountFuture:
        """Dispatch a count on the pooled executor for ``sb``; defer the sync."""
        return self.get(sb, **kwargs).count_async(wl)

    def count(self, sb: sbf_mod.SlicedBitmap, wl: sbf_mod.Worklist, **kwargs) -> int:
        """Blocking convenience over ``count_async`` (identical counts)."""
        return self.count_async(sb, wl, **kwargs).result()

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop every cached graph (frees their device-resident stores)."""
        self._entries.clear()

    def stats(self) -> dict:
        """Hit rate and launch-shape sharing across the cached graphs."""
        groups = collections.Counter(tkey for tkey, _ in self._entries.values())
        return {
            "graphs": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "trace_groups": len(groups),
            "max_group": max(groups.values(), default=0),
        }


class _WaveReadback:
    """The int32 ``[rows, 2]`` device totals of one fused dispatch, copied to
    the host once, by the first of its futures to ask."""

    __slots__ = ("_totals", "_host")

    def __init__(self, totals: torch.Tensor):
        self._totals = totals
        self._host: torch.Tensor | None = None

    def host(self) -> torch.Tensor:
        if self._host is None:
            self._host = self._totals.cpu()  # the one transfer of the wave
            self._totals = None
        return self._host


class MultiCountFuture:
    """A fused multi-graph dispatch whose host readback is deferred.

    Holds its batch's rows ``start .. start + rows - 1`` of a dispatch's
    int32 per-graph ``[subtotal, out_of_range]`` totals (``totals``: the
    batch's own ``[padded_graphs, 2]`` tensor, or a wave's readback shared
    by its batches). ``result()`` returns the real graphs' counts as a tuple
    of Python ints (idempotent, cached); the first future of a wave to ask
    does the wave's one device->host transfer and the others read that
    copy. It raises ``ValueError`` if this batch's segments named a store
    row past the end of the stacked stores, as ``CountFuture`` does, and
    ``error`` when the dispatch parked one here (``failed``): the batch's
    planning raised, or its launch was refused.
    """

    __slots__ = ("_wave", "_start", "_rows", "_num", "_error", "_value")

    def __init__(self, totals, num_graphs: int, *, start: int = 0, rows: int | None = None,
                 error: BaseException | None = None):
        if isinstance(totals, torch.Tensor):
            rows = totals.shape[0] if rows is None else rows
            totals = _WaveReadback(totals)
        self._wave = totals
        self._start = int(start)
        self._rows = rows
        self._num = int(num_graphs)
        self._error = error
        self._value: tuple[int, ...] | None = None

    @property
    def resolved(self) -> bool:
        """True once no device totals are still held."""
        return self._wave is None

    @property
    def failed(self) -> bool:
        return self._error is not None

    def result(self) -> tuple[int, ...]:
        if self._error is not None:
            raise self._error
        if self._wave is not None:
            host = self._wave.host()[self._start : self._start + self._rows]
            out_of_range = int(host[:, 1].sum())
            if out_of_range:
                raise ValueError(
                    f"{out_of_range} fused work-list pairs index past the end "
                    "of their stacked slice store; the counts are invalid"
                )
            self._value = tuple(host[: self._num, 0].tolist())
            self._wave = None
        return self._value


def _worklist_key(wl: sbf_mod.Worklist) -> str:
    """Digest of a worklist's pair positions (fused-batch cache keying).

    Store content alone is not enough — a caller may count a partial
    worklist against the same stores — so batch keys pair each graph's
    ``sbf_content_key`` with this digest. Memoized on the frozen worklist.
    """
    cached = getattr(wl, "_pairs_digest", None)
    if cached is not None:
        return cached
    h = hashlib.blake2b(digest_size=16)
    rp = np.ascontiguousarray(np.asarray(wl.pair_row_pos, dtype=np.int64))
    cp = np.ascontiguousarray(np.asarray(wl.pair_col_pos, dtype=np.int64))
    h.update(np.int64(len(rp)).tobytes())
    h.update(rp.tobytes())
    h.update(cp.tobytes())
    digest = h.hexdigest()
    object.__setattr__(wl, "_pairs_digest", digest)
    return digest


class _FusedBatch:
    """Device-resident state of one fused batch: stacked stores and index
    block. Re-dispatching it uploads nothing."""

    __slots__ = ("plan", "row_data", "col_data", "ridx", "cidx", "__weakref__")

    def __init__(self, plan, row_data, col_data, ridx, cidx):
        self.plan = plan
        self.row_data = row_data
        self.col_data = col_data
        self.ridx = ridx
        self.cidx = cidx

    @property
    def segments(self) -> tuple:
        """``(row_data, col_data, row_idx, col_idx, bucket)``: the batch as
        the segment kernel's entries take it."""
        return (self.row_data, self.col_data, self.ridx, self.cidx, self.plan.bucket)


class MultiGraphExecutor:
    """Fused execute stage for MANY small graphs per dispatch.

    Stacks a batch of small graphs' stores and pow2-bucketed worklists
    (``core.plan.plan_fusion``); the segment-totals kernel returns their
    per-graph subtotals. ``count_fused_wave_async`` dispatches a serve
    wave's batches at once: one zeroed totals tensor, one launch for every
    ``GROUP_CAP`` batches (their table, packed once a cached wave, is the
    kernel's parameter) and one readback shared by the batches' futures.
    Big graphs do not come here: ``max_fused_pairs`` bounds the per-graph
    segment, and ``launch.tc_serve`` routes anything larger solo.

    Batches are cached LRU by content (store digests + worklist digests), so
    a recurring tenant mix re-counts with no upload. ``upload_bytes`` counts
    the bytes staged to the device over the executor's life.

    The reference's ``trace_count`` (jit cache sizes) has no counterpart in
    eager PyTorch; ``dispatches`` counts the batches dispatched in its place
    (a wave of them shares launches of the segment kernel on the card; on
    the CPU each is one call of its plain version). ``device`` defaults to
    the card.
    """

    def __init__(
        self,
        *,
        max_batches: int = 8,
        max_fused_pairs: int = 1 << 16,
        device: str | torch.device | None = None,
    ):
        if max_batches < 1:
            raise ValueError(f"max_batches must be >= 1, got {max_batches}")
        self.max_batches = max_batches
        self.max_fused_pairs = int(max_fused_pairs)
        self.device = resolve_device(device)
        self._batches: collections.OrderedDict[tuple, _FusedBatch] = collections.OrderedDict()
        # Packed segment tables of recent waves, keyed by their batches'
        # identities (weakly held: a table is stale once a batch is gone).
        self._tables: collections.OrderedDict[tuple, tuple] = collections.OrderedDict()
        self._buckets: set[int] = set()
        self.hits = 0
        self.misses = 0
        self.dispatches = 0
        self.upload_bytes = 0

    def plan(self, jobs):
        """The ``FusionPlan`` this executor would run ``jobs`` under —
        exposed so admission control can cost a batch before committing."""
        # max_fused_pairs bounds each graph's worklist; the shared bucket is
        # its pow2 ceiling.
        return plan_fusion(jobs, max_bucket=pow2_ceil(max(self.max_fused_pairs, 1)))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        self.upload_bytes += a.nbytes
        return stage(a.view(np.int32), self.device)

    def _stack(self, stores, rows: int, wps: int) -> torch.Tensor:
        """Stack host stores row-wise, pow2-pad the rows, upload once."""
        host = (
            np.concatenate([np.asarray(s, dtype=np.uint32) for s in stores])
            if rows else np.zeros((0, wps), np.uint32)
        )
        return self._upload(_pad_rows_pow2(host))

    def _cached(self, jobs) -> tuple[tuple, _FusedBatch | None]:
        """``jobs``' cache key and its resident batch (a hit), or None."""
        key = tuple((sbf_content_key(sb), _worklist_key(wl)) for sb, wl in jobs)
        batch = self._batches.get(key)
        if batch is not None:
            self.hits += 1
            self._batches.move_to_end(key)
        return key, batch

    def prepare(self, jobs) -> _FusedBatch:
        """The resident batch for ``jobs`` (list of host ``(SlicedBitmap,
        Worklist)``): the cached one, else planned, stacked and uploaded.

        Raises ``ValueError`` (via ``plan_fusion``) when a job exceeds the
        fused segment bound or mixes word widths — admission control filters
        those out before calling.
        """
        key, batch = self._cached(jobs)
        return batch if batch is not None else self._stage(key, jobs)

    def _stage(self, key: tuple, jobs) -> _FusedBatch:
        """Plan, stack and upload a batch the cache does not hold."""
        self.misses += 1
        plan = self.plan(jobs)
        wps = plan.words_per_slice
        batch = _FusedBatch(
            plan,
            self._stack([sb.row_slice_data for sb, _ in jobs], plan.row_rows, wps),
            self._stack([sb.col_slice_data for sb, _ in jobs], plan.col_rows, wps),
            self._upload(plan.row_idx),
            self._upload(plan.col_idx),
        )
        self._buckets.add(plan.bucket)
        self._batches[key] = batch
        while len(self._batches) > self.max_batches:
            self._batches.popitem(last=False)
        return batch

    def _table(self, batches: list) -> SegmentTable:
        """The packed segment table of ``batches``, cached by identity."""
        key = tuple(map(id, batches))
        hit = self._tables.get(key)
        if hit is not None and all(ref() is b for ref, b in zip(hit[0], batches)):
            self._tables.move_to_end(key)
            return hit[1]
        table = SegmentTable([b.segments for b in batches])
        self._tables[key] = (tuple(weakref.ref(b) for b in batches), table)
        while len(self._tables) > self.max_batches:
            self._tables.popitem(last=False)
        return table

    def dispatch(self, batches) -> list[MultiCountFuture]:
        """Count prepared batches in one dispatch; one future a batch.

        On the card: one zeroed ``[sum of padded G, 2]`` tensor, one launch
        of the segment kernel for every ``GROUP_CAP`` batches, and one
        readback that the futures share. A refused launch parks its error
        in the futures of its batches. On the CPU: the plain version.
        """
        batches = list(batches)
        if not batches:
            return []
        self.dispatches += len(batches)
        errors = [None] * len(batches)
        if self.device.type == "cpu":
            totals = ops.popcount_and_gather_segment_groups([b.segments for b in batches])
            offsets = itertools.accumulate((b.plan.padded_graphs for b in batches), initial=0)
        else:
            table = self._table(batches)
            totals = torch.zeros(table.rows, 2, dtype=torch.int32, device=self.device)
            for k, group in enumerate(table.groups):
                try:
                    gather_segment_groups_cuda(table, totals, k)
                except RuntimeError as e:
                    errors[group.start : group.stop] = [e] * (group.stop - group.start)
            offsets = table.offsets
        wave = _WaveReadback(totals)
        return [
            MultiCountFuture(wave, b.plan.num_graphs, start=start, rows=b.plan.padded_graphs,
                             error=err)
            for b, start, err in zip(batches, offsets, errors)
        ]

    @no_host_sync()
    def count_fused_async(self, jobs) -> MultiCountFuture:
        """Dispatch one fused count over ``jobs`` (list of host
        ``(SlicedBitmap, Worklist)``); defer the single host readback.

        Raises ``ValueError`` as ``prepare`` does. A cached batch dispatches
        again against its resident tensors with nothing uploaded.

        Contract (``TCIM_CONTRACTS=1``): the fused dispatch never syncs, and
        a cached batch re-dispatches with zero staging calls.
        """
        key, batch = self._cached(jobs)
        if batch is not None:
            with max_transfers(0):
                return self.dispatch([batch])[0]
        return self.dispatch([self._stage(key, jobs)])[0]

    @no_host_sync()
    def count_fused_wave_async(self, job_lists) -> list[MultiCountFuture]:
        """Dispatch one fused count per job list, all at once: one future a
        batch, sharing the wave's launches and its one readback. A batch
        whose planning raises gets a future holding that error and stays
        out of the launch. Contract (``TCIM_CONTRACTS=1``):
        ``no_host_sync``."""
        futures: list = []
        batches = []
        for jobs in job_lists:
            try:
                batches.append(self.prepare(jobs))
                futures.append(None)
            except Exception as e:  # isolated to this batch, as at readback
                futures.append(MultiCountFuture(None, 0, error=e))
        launched = iter(self.dispatch(batches))
        return [f if f is not None else next(launched) for f in futures]

    def count_fused(self, jobs) -> tuple[int, ...]:
        """Blocking convenience over ``count_fused_async``."""
        return self.count_fused_async(jobs).result()

    def __len__(self) -> int:
        return len(self._batches)

    def clear(self) -> None:
        self._batches.clear()
        self._tables.clear()

    def stats(self) -> dict:
        return {
            "batches": len(self._batches),
            "hits": self.hits,
            "misses": self.misses,
            "buckets": sorted(self._buckets),
        }
