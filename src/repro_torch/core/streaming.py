"""Streaming incremental triangle counting — TCIM over an edge stream.

Port of ``src/repro/core/streaming.py`` (``STREAM_BACKENDS``,
``DeltaResult``, ``StreamingTCState`` and ``tcim_count_delta``) on one
device. A :class:`StreamingTCState` holds the current oriented edge set, the
host ``SlicedBitmap`` mirror, and a private device-resident executor whose
stores are edited in place batch after batch. Each ``apply_batch(added,
removed)`` costs O(touched pairs), not O(all pairs):

    1. **Touched set.** Let ``Vr`` be the sources and ``Vc`` the
       destinations of the batch's oriented edges. The *touched edges* are
       the current edges with ``src in Vr`` or ``dst in Vc`` (binary search
       over the sorted edge-key arrays, both orientations). For every
       untouched edge ``(i, j)`` the row record-set ``R_i`` and column
       record-set ``C_j`` are unchanged by the update, so its popcount term
       is identical before and after and cancels in the difference.
    2. **Before count.** The delta work list (valid slice pairs) of the
       touched edges of the OLD edge set against the OLD stores, dispatched
       asynchronously against the executor's resident stores.
    3. **Update.** ``core.sbf.update_sbf`` applies the batch to the host
       mirror and emits word-level :class:`~repro_torch.core.sbf.UpdateLanes`;
       ``Executor.update_stores`` edits them into the resident stores IN
       PLACE, enqueued on the stream after the before-count's kernels, so
       the before-count reads the pre-update words (the reference instead
       scatters into NEW arrays; see ``update_stores``). Only when the batch
       creates new ``(vertex, slice)`` records do positions shift and the
       stores re-adopt wholesale (``grew``), which rebuilds the executor's
       launcher. Cleared slices persist as all-zero records, so removals
       never shift positions and never grow anything.
    4. **After count.** The delta work list of the touched edges of the NEW
       edge set against the NEW stores, dispatched the same way.
    5. ``triangles += after - before`` — exact, signed, equal to a
       from-scratch count of the final edge set (``verify()``).

The reference guards steady batches with ``max_retrace(0)`` and its
scatter's trace count; eager torch compiles nothing, so neither has a
counterpart. A steady batch is held instead to uploading no store bytes and
adopting nothing (``Executor.store_upload_bytes``/``adopts``); on the card
it also builds no kernel library.

Orientation is **stable**: edges orient by raw vertex id (``src < dst``),
never by degree, so a batch can never relabel the graph. Triangle counts
are orientation-invariant, so parity against the (degree-reordered)
one-shot ``tcim_count`` still holds.

``mesh=`` (the reference's sharded stream over a ``Sharded2DExecutor``)
raises ``NotImplementedError``: ROADMAP.md queue 1, item 4.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import build as build_mod
from repro_torch.core import sbf as sbf_mod
from repro_torch.core.executor import Executor
from repro_torch.graphs.csr import build_graph
from repro_torch.kernels.common import resolve_device

__all__ = [
    "DeltaResult",
    "StreamingTCState",
    "tcim_count_delta",
    "STREAM_BACKENDS",
]

# Streaming executes through the work-list Executor modes only (the dense
# bitgemm/mxu backends have no incremental story — no resident stores).
STREAM_BACKENDS = ("pallas_total", "pallas_unfused", "pallas_items", "jnp")

_STREAM_MODE = {
    "pallas_total": "fused",
    "pallas_unfused": "gather_then_kernel",
    "pallas_items": "pallas_items",
    "jnp": "jnp",
}

_STREAM_BUILDS = ("auto", "host", "device")

_TODO_MESH = "ROADMAP.md queue 1, item 4 (distributed)"


@dataclasses.dataclass(frozen=True)
class DeltaResult:
    """One applied batch: the new running count and what it cost."""

    triangles: int  # running count AFTER this batch
    delta: int  # signed correction this batch contributed
    added: int
    removed: int
    touched_edges: int  # touched edges of the post-update edge set
    pairs_before: int  # delta-worklist pairs counted against the old stores
    pairs_after: int  # ... against the new stores
    grew: bool  # batch created new (vertex, slice) records
    timings_s: dict


def _as_edge_array(edges) -> np.ndarray:
    if edges is None:
        return np.zeros((0, 2), dtype=np.int64)
    e = np.asarray(edges, dtype=np.int64)
    if e.size == 0:
        return np.zeros((0, 2), dtype=np.int64)
    return e.reshape(-1, 2)


def _orient_batch(edges: np.ndarray, n: int, noun: str) -> np.ndarray:
    """Canonicalize a batch: orient each pair by raw id, validate range."""
    if len(edges) == 0:
        return edges
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    if (lo == hi).any():
        raise ValueError(f"{noun} contains a self-loop")
    if len(lo) and (int(lo.min()) < 0 or int(hi.max()) >= n):
        raise ValueError(
            f"{noun} references a vertex outside [0, {n}); the vertex "
            "universe is fixed at construction — pass n= with headroom "
            "for streams that introduce new vertices"
        )
    return np.stack([lo, hi], axis=1)


def _ranges_concat(arr: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Concatenate ``arr[lo[i]:hi[i]]`` for all i (vectorized)."""
    cnt = (hi - lo).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return arr[:0]
    base = np.repeat(lo.astype(np.int64), cnt)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt
    )
    return arr[base + offs]


def _member(sorted_keys: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Boolean membership of q in a sorted unique key array."""
    idx = np.searchsorted(sorted_keys, q)
    found = np.zeros(len(q), dtype=bool)
    ok = idx < len(sorted_keys)
    found[ok] = sorted_keys[idx[ok]] == q[ok]
    return found


class StreamingTCState:
    """A long-lived graph whose triangle count follows an edge stream.

    ``edges`` seeds the graph (any undirected pair list; oriented and
    deduplicated here); ``n`` fixes the vertex universe — pass headroom if
    the stream will introduce vertices beyond the seed's max id. Then
    ``apply_batch(added, removed)`` maintains ``triangles`` at O(touched
    pairs) per batch (module docstring has the protocol).

    ``backend`` picks the executor mode (``STREAM_BACKENDS``); ``build``
    picks the delta-worklist front end — ``'host'`` (NumPy
    ``build_worklist_pairs``), ``'device'`` (``core.build
    .device_delta_worklist``: the schedule step over just the touched
    edges, as torch ops on ``device``, bit-identical), or ``'auto'`` (the
    device on a CUDA device). Under ``'auto'`` the device build's
    ``ValueError`` (its int32 index space) falls back to the host work list,
    as in the reference; ``fallbacks`` counts those batches' work lists.
    Either way the counts run on ``device``, which defaults to the card.
    ``index_upload_bytes`` counts what the delta work lists uploaded.

    The executor is the stream's own, never a pool's: its stores are
    edited in place, and a pooled executor may serve another graph of equal
    content.

    Durability / degradation hooks (used by ``launch.tc_serve``):

    * ``snapshot_tree()`` / ``from_snapshot()`` — the stream as a flat tree
      of host arrays plus a metadata dict, round-trippable through
      ``checkpoint.store`` without re-running the seed count.
    * ``spill()`` / ``ensure_resident()`` — drop the device-resident
      executor (the host ``_sbf`` mirror stays authoritative) and rebuild
      it later, count-preserving, no recount.
    * ``compact()`` — rebuild the SBF from the live edge set, dropping the
      all-zero records removals leave behind (``zero_record_ratio``).

    Not thread-safe; one stream mutates one executor's stores.
    """

    _SNAP_LEAVES = (
        "keys", "row_ptr", "row_slice_idx", "row_slice_data",
        "col_ptr", "col_slice_idx", "col_slice_data",
    )

    def __init__(
        self,
        edges,
        *,
        n: int | None = None,
        slice_bits: int = 64,
        backend: str = "pallas_total",
        chunk_pairs: int = 1 << 20,
        mesh=None,
        schedule: str = "packed",
        build: str = "auto",
        device: str | torch.device | None = None,
    ):
        self._configure(backend, build, chunk_pairs, mesh, device)
        e = _as_edge_array(edges)
        if n is None:
            n = int(e.max()) + 1 if len(e) else 0
        self.n = int(n)
        self.slice_bits = int(slice_bits)
        e = _orient_batch(e, self.n, "initial edges")
        keys = np.unique(e[:, 0] * np.int64(self.n) + e[:, 1]) if len(e) else (
            np.zeros(0, dtype=np.int64)
        )
        self._keys = keys  # src-major sorted unique edge keys
        self._keys_t = np.sort(self._transpose_keys(keys))  # dst-major
        g = build_graph(self.current_edges(), n=self.n, reorder=False)
        self._sbf = sbf_mod.build_sbf(g, slice_bits)
        self.executor = self._make_executor(self._sbf)
        # Seed count: the full worklist, once — batches never recount it.
        self.triangles = int(self.executor.count(sbf_mod.build_worklist(g, self._sbf)))
        self.batches = 0

    def _configure(self, backend, build, chunk_pairs, mesh, device) -> None:
        """Validate and store the options ``__init__`` and ``from_snapshot``
        share (``schedule`` matters only to the sharded streams of ``mesh=``,
        so it is accepted and unused)."""
        if backend not in _STREAM_MODE:
            raise ValueError(f"backend {backend!r} not in {STREAM_BACKENDS}")
        if build not in _STREAM_BUILDS:
            raise ValueError(f"build {build!r} not in {_STREAM_BUILDS}")
        if mesh is not None:
            raise NotImplementedError(f"mesh= streaming is not ported yet: {_TODO_MESH}")
        self.backend = backend
        self._build = build
        self._chunk_pairs = chunk_pairs
        self.device = resolve_device(device)
        self._use_device_build = build == "device" or (
            build == "auto" and self.device.type == "cuda"
        )
        self.fallbacks = 0
        self.index_upload_bytes = 0

    # ------------------------------------------------------------ internals

    def _transpose_keys(self, keys: np.ndarray) -> np.ndarray:
        if self.n == 0:
            return keys.copy()
        return (keys % self.n) * np.int64(self.n) + keys // self.n

    def _make_executor(self, sb: sbf_mod.SlicedBitmap) -> Executor:
        return Executor(
            sb, mode=_STREAM_MODE[self.backend], chunk_pairs=self._chunk_pairs,
            device=self.device,
        )

    def _touched(
        self, keys: np.ndarray, keys_t: np.ndarray, vr: np.ndarray, vc: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Edges of the keyed edge set with src in vr or dst in vc."""
        n = np.int64(self.n)
        by_src = _ranges_concat(
            keys, np.searchsorted(keys, vr * n), np.searchsorted(keys, (vr + 1) * n)
        )
        by_dst = _ranges_concat(
            keys_t,
            np.searchsorted(keys_t, vc * n),
            np.searchsorted(keys_t, (vc + 1) * n),
        )
        k = np.unique(np.concatenate([by_src, self._transpose_keys(by_dst)]))
        return k // n, k % n

    def _delta_worklist(self, src: np.ndarray, dst: np.ndarray, sb):
        """Valid slice pairs for a touched-edge subset (host or device)."""
        if self._use_device_build and len(src):
            try:
                wl = build_mod.device_delta_worklist(src, dst, sb, device=self.device)
            except ValueError:
                if self._build == "device":
                    raise
                # auto: int32 capacity exceeded — fall back to the host.
                self.fallbacks += 1
            else:
                self.index_upload_bytes += wl.upload_bytes
                return wl
        pe, pr, pc = sbf_mod.build_worklist_pairs(src, dst, sb)
        return sbf_mod.Worklist(
            pair_edge=pe,
            pair_row_pos=pr,
            pair_col_pos=pc,
            m_edges=len(src),
            n_slices=sb.n_slices,
        )

    def _validate(self, ka: np.ndarray, kr: np.ndarray) -> None:
        for k, noun in ((ka, "added"), (kr, "removed")):
            if len(np.unique(k)) != len(k):
                raise ValueError(f"duplicate edge in {noun} batch")
        if len(ka) and len(kr) and np.intersect1d(ka, kr).size:
            raise ValueError("an edge appears in both added and removed")
        if len(ka) and _member(self._keys, ka).any():
            raise ValueError("adding an edge that is already present")
        if len(kr) and not _member(self._keys, kr).all():
            raise ValueError("removing an edge that is not present")

    # --------------------------------------------------------------- public

    @property
    def num_edges(self) -> int:
        return int(len(self._keys))

    def current_edges(self) -> np.ndarray:
        """The current oriented edge set, [m, 2] int64 sorted by (src, dst)."""
        if self.n == 0 or len(self._keys) == 0:
            return np.zeros((0, 2), dtype=np.int64)
        n = np.int64(self.n)
        return np.stack([self._keys // n, self._keys % n], axis=1)

    # ------------------------------------------------- spill / re-admission

    @property
    def resident(self) -> bool:
        """Whether a device-resident executor currently backs this stream."""
        return self.executor is not None

    def spill(self) -> None:
        """Drop the device-resident executor; host state stays authoritative.

        The host mirror (``_sbf``), the sorted edge keys, and the running
        count fully determine the stream, so a spilled stream gives its
        device store bytes back to the serving budget and a later
        ``ensure_resident()`` rebuilds the executor without a recount.
        Deltas close synchronously (``apply_batch`` resolves both futures
        before returning), so there is never an in-flight future to strand.
        """
        self.executor = None

    def ensure_resident(self) -> bool:
        """Rebuild the executor after ``spill()``; True when it had to."""
        if self.executor is not None:
            return False
        self.executor = self._make_executor(self._sbf)
        return True

    # ------------------------------------------------------------ compaction

    def zero_record_ratio(self) -> float:
        """Fraction of stored slice records whose data words are all zero.

        Removals clear slice words in place (positions never shift), so a
        remove-heavy stream accumulates dead records that pad every delta
        worklist; this ratio is the compaction trigger.
        """
        row = np.asarray(self._sbf.row_slice_data)
        col = np.asarray(self._sbf.col_slice_data)
        total = len(row) + len(col)
        if total == 0:
            return 0.0
        zeros = int((~row.any(axis=1)).sum()) + int((~col.any(axis=1)).sum())
        return zeros / total

    def compact(self) -> dict:
        """Rebuild the SBF from the live edge set, dropping zero records.

        The running count is a function of the live edge set only, so the
        rebuild is count-preserving by construction; the resident stores
        re-adopt the compacted layout wholesale (and the launcher is rebuilt
        over them). Returns ``{"records_before", "records_after"}``.
        """
        sb = self._sbf
        before = int(len(sb.row_slice_idx)) + int(len(sb.col_slice_idx))
        g = build_graph(self.current_edges(), n=self.n, reorder=False)
        self._sbf = sbf_mod.build_sbf(g, self.slice_bits)
        after = int(len(self._sbf.row_slice_idx)) + int(len(self._sbf.col_slice_idx))
        if self.executor is not None:
            self.executor.adopt_stores(self._sbf)
        return {"records_before": before, "records_after": after}

    # ---------------------------------------------------------- durability

    def snapshot_tree(self) -> tuple[dict, dict]:
        """The stream as ``(tree, extra)`` for ``checkpoint.store``.

        The tree is flat host arrays (edge keys + the six SBF arrays);
        ``extra`` carries the scalars. ``from_snapshot`` round-trips both
        without re-running the seed count — ``triangles`` is trusted, which
        is safe because snapshots are only taken from a live state whose
        count the streaming protocol maintains exactly.
        """
        sb = self._sbf
        tree = {
            "keys": self._keys,
            "row_ptr": sb.row_ptr,
            "row_slice_idx": sb.row_slice_idx,
            "row_slice_data": sb.row_slice_data,
            "col_ptr": sb.col_ptr,
            "col_slice_idx": sb.col_slice_idx,
            "col_slice_data": sb.col_slice_data,
        }
        extra = {
            "n": int(self.n),
            "slice_bits": int(self.slice_bits),
            "n_slices": int(sb.n_slices),
            "backend": self.backend,
            "triangles": int(self.triangles),
            "batches": int(self.batches),
        }
        return tree, extra

    @classmethod
    def from_snapshot(
        cls,
        tree: dict,
        extra: dict,
        *,
        backend: str | None = None,
        chunk_pairs: int = 1 << 20,
        mesh=None,
        schedule: str = "packed",
        build: str = "auto",
        device: str | torch.device | None = None,
    ) -> "StreamingTCState":
        """Rebuild a stream from ``snapshot_tree()`` output — no recount."""
        self = cls.__new__(cls)
        backend = backend or extra.get("backend", "pallas_total")
        self._configure(backend, build, chunk_pairs, mesh, device)
        self.n = int(extra["n"])
        self.slice_bits = int(extra["slice_bits"])
        self._keys = np.asarray(tree["keys"], dtype=np.int64)
        self._keys_t = np.sort(self._transpose_keys(self._keys))
        self._sbf = sbf_mod.SlicedBitmap(
            slice_bits=self.slice_bits,
            n=self.n,
            n_slices=int(extra["n_slices"]),
            row_ptr=np.asarray(tree["row_ptr"]),
            row_slice_idx=np.asarray(tree["row_slice_idx"]),
            row_slice_data=np.asarray(tree["row_slice_data"]),
            col_ptr=np.asarray(tree["col_ptr"]),
            col_slice_idx=np.asarray(tree["col_slice_idx"]),
            col_slice_data=np.asarray(tree["col_slice_data"]),
        )
        self.executor = self._make_executor(self._sbf)
        self.triangles = int(extra["triangles"])
        self.batches = int(extra["batches"])
        return self

    def apply_batch(self, added=None, removed=None) -> DeltaResult:
        """Apply one edge batch; returns the updated running count.

        ``added``/``removed`` are undirected pair lists (any orientation;
        canonicalized here). Set semantics are enforced: adds must be
        absent, removes present, no edge in both, no self-loops, vertices
        within the fixed universe. Empty batches are free no-ops. On the
        card ``timings_s``' dispatch and scatter entries are enqueue times;
        ``close`` waits for both counts.
        """
        t_start = time.perf_counter()
        timings: dict[str, float] = {}
        n = np.int64(self.n)
        a = _orient_batch(_as_edge_array(added), self.n, "added")
        r = _orient_batch(_as_edge_array(removed), self.n, "removed")
        if len(a) == 0 and len(r) == 0:
            self.batches += 1
            return DeltaResult(
                triangles=self.triangles, delta=0, added=0, removed=0,
                touched_edges=0, pairs_before=0, pairs_after=0, grew=False,
                timings_s={"total": time.perf_counter() - t_start},
            )
        ka = a[:, 0] * n + a[:, 1]
        kr = r[:, 0] * n + r[:, 1]
        self._validate(ka, kr)
        # Transparent re-admission: a spilled stream rebuilds its executor
        # from the host mirror on the first non-empty batch that touches it.
        self.ensure_resident()
        vr = np.unique(np.concatenate([a[:, 0], r[:, 0]]))
        vc = np.unique(np.concatenate([a[:, 1], r[:, 1]]))

        # Before count: touched edges of the OLD edge set vs the OLD stores.
        t0 = time.perf_counter()
        src_b, dst_b = self._touched(self._keys, self._keys_t, vr, vc)
        wl_before = self._delta_worklist(src_b, dst_b, self._sbf)
        timings["schedule_before"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fut_before = self.executor.count_async(wl_before)
        timings["dispatch_before"] = time.perf_counter() - t0

        # Update the host mirror and edit/adopt the resident stores. The
        # in-place edit is ordered after the before-count on the stream;
        # growth re-adopts the stores (and rebuilds the launcher).
        t0 = time.perf_counter()
        upd = sbf_mod.update_sbf(self._sbf, a, r)
        timings["update"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if upd.grew:
            self.executor.adopt_stores(upd.sbf)
        else:
            self.executor.update_stores(upd.row_lanes, upd.col_lanes)
        self._sbf = upd.sbf
        timings["scatter"] = time.perf_counter() - t0

        # Merge the sorted edge-key arrays (both orientations).
        t0 = time.perf_counter()
        keys = np.concatenate([self._keys, ka])
        keys.sort(kind="stable")
        if len(kr):
            keys = np.delete(keys, np.searchsorted(keys, kr))
        keys_t = np.concatenate([self._keys_t, self._transpose_keys(ka)])
        keys_t.sort(kind="stable")
        if len(kr):
            keys_t = np.delete(
                keys_t, np.searchsorted(keys_t, self._transpose_keys(kr))
            )
        self._keys, self._keys_t = keys, keys_t
        timings["merge"] = time.perf_counter() - t0

        # After count: touched edges of the NEW edge set vs the NEW stores
        # (same Vr/Vc — untouched terms cancel exactly in the difference).
        t0 = time.perf_counter()
        src_a, dst_a = self._touched(self._keys, self._keys_t, vr, vc)
        wl_after = self._delta_worklist(src_a, dst_a, self._sbf)
        timings["schedule_after"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fut_after = self.executor.count_async(wl_after)
        timings["dispatch_after"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        delta = int(fut_after.result()) - int(fut_before.result())
        timings["close"] = time.perf_counter() - t0
        self.triangles += delta
        self.batches += 1
        timings["total"] = time.perf_counter() - t_start
        return DeltaResult(
            triangles=self.triangles,
            delta=delta,
            added=int(len(a)),
            removed=int(len(r)),
            touched_edges=int(len(src_a)),
            pairs_before=int(wl_before.num_pairs),
            pairs_after=int(wl_after.num_pairs),
            grew=bool(upd.grew),
            timings_s=timings,
        )

    def verify(self) -> int:
        """From-scratch oracle check: raises on any running-count drift.

        The recount is ``tcim_count`` on the stream's device (the device
        build on the card)."""
        from repro_torch.core.tcim import tcim_count  # deferred: tcim imports us

        expect = tcim_count(
            self.current_edges(), n=self.n, slice_bits=self.slice_bits,
            collect_stats=False, device=self.device,
        ).triangles
        if expect != self.triangles:
            raise AssertionError(
                f"running count {self.triangles} != from-scratch {expect} "
                f"after {self.batches} batches"
            )
        return self.triangles


def tcim_count_delta(
    graph_state: StreamingTCState, edges_added=None, edges_removed=None
) -> DeltaResult:
    """Apply one edge batch to a streaming state; returns the running count.

    Functional alias for :meth:`StreamingTCState.apply_batch` — the entry
    point named by the streaming API: build the state once, then
    ``tcim_count_delta(state, adds, removes)`` per batch.
    """
    return graph_state.apply_batch(edges_added, edges_removed)
