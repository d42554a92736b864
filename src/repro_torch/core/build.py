"""Device build front end: orient -> SBF -> work list as torch work on the device.

Port of ``src/repro/core/build.py``. The host front end (``build_graph``,
``build_sbf``, ``build_worklist``) is NumPy; this module runs all three
stages on the device with plain torch ops, bit-identical to the host build
and to the JAX package's device build:

  * **Orient** — ``graphs.csr.device_orient``: one pinned, non-blocking
    upload of the pow2-bucket-padded edge list; degree relabel and sort on
    the device.
  * **Compress** — ``_side``: per side, one stable sort by the int64 key
    ``owner * (n_slices + 1) + slice`` (the host build's record order),
    run-start flags and a cumsum in place of ``np.unique``/``searchsorted``,
    and a scatter-add of one-hot int32 bit words in place of
    ``np.bitwise_or.at`` (each edge owns a distinct bit of its record's
    word, so add == OR; bit 31 is ``-2**31``). Sentinel lanes scatter into
    a spare slot that is sliced off.
  * **Schedule** — ``_worklist_step``: the row-slice expansion is a
    ``searchsorted`` over the per-edge candidate prefix sums; the column
    membership test is one ``searchsorted`` over the column records' int64
    key ``owner * (n_slices + 1) + slice``, which is sorted, so its lower
    bound is the lower bound inside the owner's window that the host's
    ``sbf._window_searchsorted`` finds; the hit compaction is a cumsum
    scatter. Pairs come back in the host build's order, padded to a pow2
    bucket with the executor's ``-1`` no-op sentinel.

Stores are trimmed to pow2 row buckets (the executor's layout) and the
candidate and pair arrays to their own pow2 buckets. The candidate total is
summed exactly in int64. Between the upload and the execute stage the host
reads back two small things: ``[row_nvs, col_nvs, candidates]`` and then the
pair count; the bulk arrays never leave the device, and ``SlicedBitmap``
carries the device stores straight into ``core.executor.Executor``.
``device_build_async`` defers even those readbacks to ``result()``, so a
fleet can dispatch graph i+1's sort-bound build while graph i executes.

The reference's ``device_build_trace_counts`` (jit cache sizes) has no
counterpart: eager torch traces nothing.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import sbf as sbf_mod
from repro_torch.core.plan import pow2_ceil
from repro_torch.graphs.csr import DeviceGraph, Graph, device_orient, upload_pinned
from repro_torch.kernels.common import resolve_device

__all__ = [
    "DeviceBuild",
    "DeviceBuildFuture",
    "DeviceWorklist",
    "device_build",
    "device_build_async",
    "device_build_graph",
    "device_build_graph_async",
    "device_build_sbf",
    "device_build_worklist",
    "device_delta_worklist",
]

_INT32_LIMIT = 2**31 - 1
_I32 = torch.int32

# The candidate total sizes int32 lane arrays. It is summed exactly in
# int64; the guard keeps the reference's margin below the int32 limit.
_CAND_GUARD = _INT32_LIMIT - (1 << 16)


def _lanes(k: int, device: torch.device) -> torch.Tensor:
    return torch.arange(k, dtype=_I32, device=device)


def _side(first, second, m, n: int, slice_bits: int, n_slices: int):
    """One SBF side: valid-slice CSR from (owner, bit-position) pairs.

    Matches ``sbf._build_side`` record for record: (owner, slice) order,
    per-record OR of bit words, CSR offsets over owners. Returns ``(ptr,
    slice_idx, data, nvs)`` with ``slice_idx``/``data`` one row longer than
    the bucket (the sentinel lanes' spare slot) and ``nvs`` on the device.
    """
    bucket = first.shape[0]
    dev = first.device
    wps = slice_bits // 32
    valid = _lanes(bucket, dev) < m
    k = torch.where(valid, torch.div(second, slice_bits, rounding_mode="floor"), n_slices)
    # Sentinel lanes carry owner n and slice n_slices: the largest key.
    key, order = torch.sort(first.long() * (n_slices + 1) + k, stable=True)
    bit = second.index_select(0, order) % slice_bits
    owner = torch.div(key, n_slices + 1, rounding_mode="floor")
    slice_k = (key - owner * (n_slices + 1)).to(_I32)
    newrec = valid & (key != torch.cat([key.new_full((1,), -1), key[:-1]]))
    rec = torch.cumsum(newrec, 0, dtype=_I32) - 1
    rec = torch.where(valid, rec, bucket).long()  # sentinels -> spare slot
    nvs = newrec.sum(dtype=_I32)
    shift = bit % 32
    one = torch.where(shift == 31, -(2**31), 1 << shift)
    data = torch.zeros((bucket + 1) * wps, dtype=_I32, device=dev)
    data.scatter_add_(0, rec * wps + torch.div(bit, 32, rounding_mode="floor"), one)
    slice_idx = torch.zeros(bucket + 1, dtype=_I32, device=dev).scatter_(0, rec, slice_k)
    counts = torch.zeros(n + 1, dtype=_I32, device=dev)
    counts.scatter_add_(0, owner, newrec.to(_I32))
    ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts[:n], 0, dtype=_I32)])
    return ptr, slice_idx, data.view(bucket + 1, wps), nvs


def _candidates(src, m, row_ptr) -> torch.Tensor:
    """Per-edge count of row-side valid slices (0 on sentinel lanes)."""
    n = row_ptr.shape[0] - 1
    u = src.clamp(0, n - 1)
    cnt = row_ptr.index_select(0, u + 1) - row_ptr.index_select(0, u)
    return torch.where(_lanes(src.shape[0], src.device) < m, cnt, 0)


def _sbf_step(dg: DeviceGraph, slice_bits: int):
    """Both SBF sides + the work list's int64 candidate total."""
    n_slices = (dg.n + slice_bits - 1) // slice_bits
    row = _side(dg.src, dg.dst, dg.m_dev, dg.n, slice_bits, n_slices)
    col = _side(dg.dst, dg.src, dg.m_dev, dg.n, slice_bits, n_slices)
    cand = _candidates(dg.src, dg.m_dev, row[0]).sum(dtype=torch.int64)
    return row, col, cand


def _worklist_step(src, dst, m, row_ptr, row_idx, col_ptr, col_idx, n_slices: int, cb: int):
    """Expand row slices per edge, test column membership, compact hits.

    ``cb`` is the candidate bucket (pow2 >= the candidate total). Returns
    ``(pair_edge, pair_row_pos, pair_col_pos, num_pairs)``: three int32
    arrays of ``cb + 1`` lanes (hits first, in lane order, then ``-1``; the
    last lane is the misses' spare slot) and the hit count on the device.
    """
    bucket = src.shape[0]
    dev = src.device
    n = row_ptr.shape[0] - 1
    cnt = _candidates(src, m, row_ptr)
    cum = torch.cumsum(cnt, 0, dtype=_I32)
    start = cum - cnt
    lane = _lanes(cb, dev)
    e = torch.searchsorted(cum, lane, right=True, out_int32=True).clamp_max_(bucket - 1)
    lane_valid = lane < cum[-1]
    u = src.clamp(0, n - 1).index_select(0, e)
    row_pos = row_ptr.index_select(0, u) + (lane - start.index_select(0, e))
    del lane, u, start
    ks = row_idx.index_select(0, row_pos.clamp(0, row_idx.shape[0] - 1))
    v = dst.index_select(0, e).clamp_(0, n - 1)
    hi = col_ptr.index_select(0, v + 1)
    # The lower bound of ks in col_idx[col_ptr[v]:hi]: records are sorted by
    # (owner, slice), so the global lower bound of the key v*(S+1)+ks lies
    # inside v's window and equals the window's own.
    col_cap = col_idx.shape[0]
    owner = torch.searchsorted(col_ptr, _lanes(col_cap, dev), right=True, out_int32=True) - 1
    col_key = owner.long() * (n_slices + 1) + col_idx
    pos = torch.searchsorted(col_key, v.long() * (n_slices + 1) + ks, out_int32=True)
    del owner, col_key, v
    hit = lane_valid & (pos < hi) & (col_idx.index_select(0, pos.clamp(max=col_cap - 1)) == ks)
    del ks, hi, lane_valid
    out = torch.cumsum(hit, 0, dtype=_I32)
    num_pairs = out[-1]
    tgt = torch.where(hit, out - 1, cb).long()  # misses -> spare slot cb

    def compact(x):
        return torch.full((cb + 1,), -1, dtype=_I32, device=dev).scatter_(0, tgt, x)

    return compact(e), compact(row_pos), compact(pos), num_pairs


@dataclasses.dataclass(frozen=True)
class DeviceWorklist:
    """Device-resident work list: pow2-padded int32 pair indices, ``-1`` no-ops.

    The executor consumes the padded arrays directly (negative indices are
    exact no-ops), so the pairs never bounce through the host.
    ``num_pairs`` is the real (non-sentinel) pair count, read back while
    sizing the pair bucket. ``upload_bytes`` is what a delta work list's
    build copied host->device (its edges, and a host SBF's index arrays).
    """

    pair_edge: torch.Tensor  # int32 [PB]
    pair_row_pos: torch.Tensor  # int32 [PB]
    pair_col_pos: torch.Tensor  # int32 [PB]
    num_pairs: int
    num_candidates: int
    m_edges: int
    n_slices: int
    upload_bytes: int = 0

    def compute_reduction(self) -> float:
        naive = self.m_edges * self.n_slices
        return 1.0 - (self.num_pairs / naive) if naive else 0.0

    def to_host(self) -> sbf_mod.Worklist:
        """The exact host ``Worklist`` (sync)."""
        p = self.num_pairs

        def host(t):
            return t[:p].cpu().numpy().astype(np.int64)

        return sbf_mod.Worklist(
            pair_edge=host(self.pair_edge),
            pair_row_pos=host(self.pair_row_pos),
            pair_col_pos=host(self.pair_col_pos),
            m_edges=self.m_edges,
            n_slices=self.n_slices,
        )


@dataclasses.dataclass(frozen=True)
class DeviceBuild:
    """A fully built device pipeline input: graph + SBF + work list."""

    graph: DeviceGraph
    sbf: sbf_mod.SlicedBitmap
    worklist: DeviceWorklist
    timings_s: dict

    def to_host(self) -> tuple[sbf_mod.SlicedBitmap, sbf_mod.Worklist]:
        """(sbf, worklist) on the host."""
        return self.sbf.to_host(), self.worklist.to_host()


def _finalize_sbf(dg: DeviceGraph, slice_bits: int, raw, row_nvs: int, col_nvs: int
                  ) -> sbf_mod.SlicedBitmap:
    """Trim the bucket-sized SBF pieces to pow2(nvs) store buckets.

    The rows kept beyond ``nvs`` are all-zero, so the stores match the
    executor's zero-padded pow2 layout. The trimmed pieces are copies, so
    the bucket-sized buffers are freed with ``raw``.
    """
    (rp, ri, rd, _), (cp, ci, cd, _), _ = raw
    sb_row = pow2_ceil(max(row_nvs, 1))
    sb_col = pow2_ceil(max(col_nvs, 1))
    return sbf_mod.SlicedBitmap(
        slice_bits=slice_bits,
        n=dg.n,
        n_slices=(dg.n + slice_bits - 1) // slice_bits,
        row_ptr=rp,
        row_slice_idx=ri[:sb_row].clone(),
        row_slice_data=rd[:sb_row].clone(),
        col_ptr=cp,
        col_slice_idx=ci[:sb_col].clone(),
        col_slice_data=cd[:sb_col].clone(),
        row_valid=row_nvs,
        col_valid=col_nvs,
        content_key=f"device:{dg.content_key}:{slice_bits}",
    )


def _worklist(src, dst, m, index_arrays, n_slices: int, cand: int, m_edges: int,
              refusal: str) -> DeviceWorklist:
    """Guard the candidate total, run the schedule step, read back the pair
    count and trim the pairs to their pow2 bucket (contiguous copies, so the
    candidate-sized buffers are freed)."""
    if cand >= _CAND_GUARD:
        raise ValueError(
            f"candidate total {cand} is at or past int32 device indexing; {refusal}"
        )
    cb = pow2_ceil(max(cand, 1))
    pe, pr, pc, npair = _worklist_step(src, dst, m, *index_arrays, n_slices, cb)
    num_pairs = int(npair)  # the readback that sizes the pair bucket
    pb = pow2_ceil(max(num_pairs, 1))
    return DeviceWorklist(
        pair_edge=pe[:pb].clone(),
        pair_row_pos=pr[:pb].clone(),
        pair_col_pos=pc[:pb].clone(),
        num_pairs=num_pairs,
        num_candidates=cand,
        m_edges=m_edges,
        n_slices=n_slices,
    )


def _graph_worklist(dg: DeviceGraph, sb: sbf_mod.SlicedBitmap, cand: int) -> DeviceWorklist:
    return _worklist(
        dg.src, dg.dst, dg.m_dev,
        (sb.row_ptr, sb.row_slice_idx, sb.col_ptr, sb.col_slice_idx),
        sb.n_slices, cand, dg.m,
        "build this graph on the host (build='host')",
    )


class DeviceBuildFuture:
    """An SBF build already dispatched; its sizing readback deferred to
    ``result``.

    Construction enqueues the sort-bound orient + SBF device work and
    returns with no host sync. ``result()`` performs the one readback of
    ``[row_nvs, col_nvs, candidates]``, trims the stores, runs the schedule
    step (whose pair count is the second readback) and returns the
    ``DeviceBuild``. Idempotent.
    """

    def __init__(self, dg: DeviceGraph, slice_bits: int, raw, timings: dict):
        self._dg = dg
        self._slice_bits = slice_bits
        self._raw = raw
        self.timings_s = timings
        self._build: DeviceBuild | None = None

    def result(self) -> DeviceBuild:
        if self._build is None:
            t0 = time.perf_counter()
            raw = self._raw
            (*_, row_nvs), (*_, col_nvs), cand = raw
            sizes = torch.stack([row_nvs.long(), col_nvs.long(), cand]).cpu().tolist()
            sb = _finalize_sbf(self._dg, self._slice_bits, raw, sizes[0], sizes[1])
            self._raw = raw = None
            wl = _graph_worklist(self._dg, sb, sizes[2])
            self.timings_s["schedule"] = time.perf_counter() - t0
            self._build = DeviceBuild(graph=self._dg, sbf=sb, worklist=wl, timings_s=self.timings_s)
        return self._build


def _check_slice_bits(slice_bits: int) -> None:
    if slice_bits % 32 != 0:
        raise ValueError("slice_bits must be a multiple of 32")


def _dispatch_sbf(dg: DeviceGraph, slice_bits: int, timings: dict) -> DeviceBuildFuture:
    t0 = time.perf_counter()
    raw = _sbf_step(dg, slice_bits)
    timings["compress"] = time.perf_counter() - t0
    return DeviceBuildFuture(dg, slice_bits, raw, timings)


def device_build_async(
    edges: np.ndarray,
    n: int | None = None,
    *,
    slice_bits: int = 64,
    reorder: bool = True,
    device: str | torch.device | None = None,
) -> DeviceBuildFuture:
    """Dispatch the full device build (orient -> SBF) from a raw edge list.

    One host->device transfer (the padded edge list) and no host sync: the
    sizing readback happens in ``DeviceBuildFuture.result()``. ``device``
    defaults to the card.
    """
    _check_slice_bits(slice_bits)
    timings: dict = {}
    t0 = time.perf_counter()
    dg = device_orient(edges, n, reorder=reorder, device=device)
    timings["orient"] = time.perf_counter() - t0
    return _dispatch_sbf(dg, slice_bits, timings)


def device_build(
    edges: np.ndarray,
    n: int | None = None,
    *,
    slice_bits: int = 64,
    reorder: bool = True,
    device: str | torch.device | None = None,
) -> DeviceBuild:
    """Blocking ``device_build_async`` (identical results)."""
    return device_build_async(
        edges, n, slice_bits=slice_bits, reorder=reorder, device=device
    ).result()


def device_build_graph_async(
    g: Graph, slice_bits: int = 64, *, device: str | torch.device | None = None
) -> DeviceBuildFuture:
    """Device build from a prebuilt (already oriented) host ``Graph``.

    Uploads ``g.edges`` once; the device sort of the already sorted list is
    an identity, so results match ``device_build(g.edges, reorder=False)``
    and the host ``build_sbf``/``build_worklist`` bit for bit.
    """
    _check_slice_bits(slice_bits)
    timings: dict = {}
    t0 = time.perf_counter()
    dg = device_orient(g.edges, n=g.n, reorder=False, device=device)
    timings["orient"] = time.perf_counter() - t0
    return _dispatch_sbf(dg, slice_bits, timings)


def device_build_graph(
    g: Graph, slice_bits: int = 64, *, device: str | torch.device | None = None
) -> DeviceBuild:
    """Blocking ``device_build_graph_async``."""
    return device_build_graph_async(g, slice_bits, device=device).result()


def device_build_sbf(dg: DeviceGraph, slice_bits: int = 64) -> sbf_mod.SlicedBitmap:
    """The compress stage alone over one ``DeviceGraph`` (on its device).

    Returns a device-resident ``SlicedBitmap`` (pow2-trimmed stores, valid
    counts read back here). Prefer ``device_build*`` for the whole pipeline.
    """
    _check_slice_bits(slice_bits)
    raw = _sbf_step(dg, slice_bits)
    (*_, row_nvs), (*_, col_nvs), _ = raw
    sizes = torch.stack([row_nvs, col_nvs]).cpu().tolist()
    return _finalize_sbf(dg, slice_bits, raw, sizes[0], sizes[1])


def device_build_worklist(dg: DeviceGraph, sb: sbf_mod.SlicedBitmap) -> DeviceWorklist:
    """The schedule stage alone over a device SBF (bit-identical pairs)."""
    cand = int(_candidates(dg.src, dg.m_dev, sb.row_ptr).sum(dtype=torch.int64))
    return _graph_worklist(dg, sb, cand)


def _delta_index_arrays(sb: sbf_mod.SlicedBitmap, device: torch.device):
    """Device int32 ``(row_ptr, row_idx, col_ptr, col_idx)`` for the delta
    step, and the bytes uploaded for them.

    Device-built SBFs pass through as they are; host-built ones upload
    their CSR index arrays, the slice indices zero-padded to pow2 row
    buckets as the executor pads its stores. The *stores* never travel.
    """
    if sb.is_device:
        return (sb.row_ptr, sb.row_slice_idx, sb.col_ptr, sb.col_slice_idx), 0

    def idx(a):
        a = np.asarray(a, dtype=np.int32)
        bucket = pow2_ceil(max(len(a), 1))
        return np.concatenate([a, np.zeros(bucket - len(a), np.int32)])

    host = (np.asarray(sb.row_ptr, dtype=np.int32), idx(sb.row_slice_idx),
            np.asarray(sb.col_ptr, dtype=np.int32), idx(sb.col_slice_idx))
    return tuple(upload_pinned(a, device) for a in host), sum(a.nbytes for a in host)


def device_delta_worklist(
    src: np.ndarray,
    dst: np.ndarray,
    sb: sbf_mod.SlicedBitmap,
    *,
    device: str | torch.device | None = None,
) -> DeviceWorklist:
    """Delta work list: valid slice pairs for an arbitrary oriented-edge subset.

    The streaming analogue of ``device_build_worklist``: the same schedule
    step over just the given edges. Pair positions come back in the SBF's
    global record coordinates and ``pair_edge`` indexes the given arrays,
    bit-identical to the host ``sbf.build_worklist_pairs`` on the same
    subset. Edges pad to a pow2 bucket. A host SBF's index arrays upload on
    every call (``upload_bytes`` counts them), as in the reference.
    ``device`` defaults to the card.
    """
    dev = resolve_device(device)
    m = len(src)
    bucket = pow2_ceil(max(m, 1))
    ends = np.zeros((2, bucket), dtype=np.int32)
    ends[0, :m], ends[1, :m] = src, dst
    ends_d = upload_pinned(ends, dev)
    index_arrays, index_bytes = _delta_index_arrays(sb, dev)
    cand = int(_candidates(ends_d[0], m, index_arrays[0]).sum(dtype=torch.int64))
    wl = _worklist(
        ends_d[0], ends_d[1], m, index_arrays, sb.n_slices, cand, m,
        "split the batch or build on the host",
    )
    return dataclasses.replace(wl, upload_bytes=ends.nbytes + index_bytes)
