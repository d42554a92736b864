"""Executor — the schedulable execute-stage unit of the TCIM engine.

Port of ``src/repro/core/executor.py`` (``CountFuture``, ``staged_uploads``,
``Executor`` in modes ``fused`` and ``jnp``, ``sbf_content_key``,
``ExecutorPool``). ``MultiGraphExecutor`` (cross-graph serving) and
``update_stores`` (streaming) wait for later slices, as do the modes
``gather_then_kernel`` and ``pallas_items``.

  * **Fused execute.** Chunks run through ``ops.popcount_and_gather_total``:
    the slice stores are uploaded once and stay resident on the device; only
    index arrays travel per chunk, and the gather happens inside the kernel.
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
    'gather_then_kernel'  not ported yet (ROADMAP.md queue 1, item 6)
    'pallas_items'        not ported yet (ROADMAP.md queue 1, item 6)
    'jnp'                 torch gather + the byte-table oracle of kernels/ref.py
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

from repro_torch.core import sbf as sbf_mod
from repro_torch.core.plan import clamp_chunk_pairs, pow2_ceil
from repro_torch.kernels import ops, ref
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.tc_gather_popcount import modeled_hbm_bytes

__all__ = [
    "CountFuture",
    "Executor",
    "ExecutorPool",
    "EXECUTOR_MODES",
    "sbf_content_key",
    "staged_uploads",
]

EXECUTOR_MODES = ("fused", "gather_then_kernel", "pallas_items", "jnp")
_PORTED_MODES = ("fused", "jnp")

_INT32_MAX = 2**31 - 1


class CountFuture:
    """A dispatched count whose host readback is deferred.

    Holds the int32 ``[total, out_of_range]`` device tensors of a count
    whose kernels are all enqueued; ``result()`` performs the one host
    transfer (a single stacked copy), sums the totals exactly in Python
    ints and caches the value. It raises ``ValueError`` if any pair named a
    store row past the end of its store (the kernel never reads those).
    """

    __slots__ = ("_totals", "_value")

    def __init__(self, totals):
        self._totals = list(totals)
        self._value: int | None = None

    def result(self) -> int:
        if self._totals is not None:
            if self._totals:
                # The one host sync of a count: one stacked transfer.
                host = torch.stack(self._totals).cpu().tolist()
            else:
                host = []
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


def _jnp_chunk_total(row_data, col_data, ridx, cidx, acc) -> None:
    """The 'jnp' mode: torch gather + byte-table oracle, same contract as
    the kernel (negative indices no-ops, out-of-range indices counted)."""
    num_rows, num_cols = row_data.shape[0], col_data.shape[0]
    bad = (ridx >= num_rows) | (cidx >= num_cols)
    valid = (ridx >= 0) & (cidx >= 0) & ~bad
    rows = row_data.index_select(0, ridx.clamp(0, num_rows - 1))
    cols = col_data.index_select(0, cidx.clamp(0, num_cols - 1))
    # Zeroing one side of the AND suffices: x & 0 == 0.
    rows = torch.where(valid[:, None], rows, 0)
    acc[0] += ref.ref_popcount_and_total(rows, cols).to(torch.int32)
    acc[1] += bad.sum().to(torch.int32)


class Executor:
    """Device-resident execute stage for one pair of SBF slice stores.

    Upload the stores once, then ``count(worklist)`` (or the lower-level
    ``execute_indices``) any number of times. ``device`` defaults to the
    card; without one, only ``device="cpu"`` runs.
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
        if mode not in _PORTED_MODES:
            raise NotImplementedError(
                f"executor mode {mode!r} is not ported yet: ROADMAP.md "
                "queue 1, item 6 (other execute backends)"
            )
        self.mode = mode
        self.device = resolve_device(device)
        self.words_per_slice = int(sb.row_slice_data.shape[1])
        self.slice_bits = int(sb.slice_bits)
        self.double_buffer = double_buffer
        # Round the chunk DOWN to a power of two (never exceed the caller's
        # memory bound), then clamp so one chunk's worst case provably fits
        # the int32 accumulator: chunk_pairs * words_per_slice * 32 <= 2**31-1.
        self.chunk_pairs = clamp_chunk_pairs(chunk_pairs, self.words_per_slice)
        self.row_data = self._upload_store(sb.row_slice_data)
        self.col_data = self._upload_store(sb.col_slice_data)

    def _upload_store(self, store: np.ndarray) -> torch.Tensor:
        """uint32 words -> a resident, pow2-row-padded int32 view of the
        same bits."""
        store = _pad_rows_pow2(np.ascontiguousarray(store, dtype=np.uint32))
        return torch.from_numpy(store.view(np.int32)).to(self.device)

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
        if self.device.type == "cpu":
            return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in chunk)
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a))
            .pin_memory()
            .to(self.device, non_blocking=True)
            for a in chunk
        )

    def _device_chunks(self, row_idx: np.ndarray, col_idx: np.ndarray):
        """Upload chunks to the device, one ahead of the consumer."""
        return staged_uploads(
            self._chunks(row_idx, col_idx),
            self._put,
            double_buffer=self.double_buffer,
        )

    def _step(self, ridx, cidx, acc: torch.Tensor) -> torch.Tensor:
        """Add one chunk into ``acc`` (int32 ``[total, out_of_range]``)."""
        if self.mode == "fused":
            return ops.popcount_and_gather_total(
                self.row_data, self.col_data, ridx, cidx, out=acc
            )
        _jnp_chunk_total(self.row_data, self.col_data, ridx, cidx, acc)
        return acc

    def _new_acc(self) -> torch.Tensor:
        return torch.zeros(2, dtype=torch.int32, device=self.device)

    def _accumulate(self, device_chunks, worst_pairs: int) -> CountFuture:
        """Dispatch every chunk step; defer the host sync to the future."""
        # Worst case: every bit of every referenced slice set.
        if worst_pairs * self.slice_bits <= _INT32_MAX:
            acc = self._new_acc()
            for ridx, cidx in device_chunks:
                self._step(ridx, cidx, acc)
            return CountFuture([acc])
        # Huge work lists: the int32 carry could overflow across chunks;
        # keep per-chunk totals on the device, exact host sum at close.
        return CountFuture(
            [self._step(ridx, cidx, self._new_acc()) for ridx, cidx in device_chunks]
        )

    def execute_indices_async(self, row_idx, col_idx) -> CountFuture:
        """Dispatch a count over host index arrays; defer the host sync.

        Every chunk step is enqueued before this returns; the returned
        future's ``result()`` is the one host transfer. Empty work lists
        dispatch nothing.
        """
        if len(row_idx) != len(col_idx):
            raise ValueError(
                f"index arrays differ in length: {len(row_idx)} vs {len(col_idx)}"
            )
        p = len(row_idx)
        if p == 0:
            return CountFuture([])
        return self._accumulate(self._device_chunks(row_idx, col_idx), p)

    def execute_indices(self, row_idx, col_idx) -> int:
        """Count over explicit work-list index arrays. One host sync total."""
        return self.execute_indices_async(row_idx, col_idx).result()

    def count_async(self, wl: sbf_mod.Worklist) -> CountFuture:
        """``count`` with the final host readback deferred to ``result()``."""
        return self.execute_indices_async(wl.pair_row_pos, wl.pair_col_pos)

    def count(self, wl: sbf_mod.Worklist) -> int:
        """Triangle contribution of a work list (Eq. 5 execute+reduce)."""
        return self.count_async(wl).result()

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
    SBF so re-keying the same object pays the hash once.
    """
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
    """Executors for a fleet serving many graphs, LRU-bounded.

    The pool caches one Executor per (graph content, mode, chunk, device,
    options); an evicted graph's device stores are freed. Entries are keyed
    by store *content* (``sbf_content_key``), so repeated counts of the same
    graph hit even when the caller rebuilds the SBF object each time — the
    case the one-shot ``tcim_count*`` API produces. PyTorch's caching
    allocator orders frees on the stream, so evicting an executor whose
    count is still in flight is safe (the reference defers such evictions).
    """

    def __init__(self, *, max_graphs: int = 16):
        if max_graphs < 1:
            raise ValueError(f"max_graphs must be >= 1, got {max_graphs}")
        self.max_graphs = max_graphs
        self._entries: collections.OrderedDict[tuple, Executor] = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

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
        ex = self._entries.get(key)
        if ex is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return ex
        self.misses += 1
        ex = Executor(sb, mode=mode, chunk_pairs=chunk_pairs, device=dev, **executor_kwargs)
        self._entries[key] = ex
        while len(self._entries) > self.max_graphs:
            self._entries.popitem(last=False)
        return ex

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
        return {"graphs": len(self._entries), "hits": self.hits, "misses": self.misses}
