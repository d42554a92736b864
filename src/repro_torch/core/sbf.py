"""SBF — Sliced Bitmap Format (paper §IV-B) + work-list construction.

Port of ``src/repro/core/sbf.py`` (``SlicedBitmap``, ``Worklist``,
``build_sbf``, ``build_worklist``, ``build_worklist_pairs``, ``sbf_stats``)
as host NumPy, plus ``sbf_from_arrays``/``worklist_from_arrays``, which carry
state built elsewhere (e.g. by the JAX package) into the port's objects.
A ``SlicedBitmap`` may also hold torch tensors on the device (``core.build``).
``update_sbf``/``UpdateLanes`` wait for the streaming slice.

A row (column) of the oriented adjacency matrix is partitioned into slices of
``slice_bits`` (|S|, paper default 64). A slice is *valid* iff it contains at
least one set bit. We store, per side (row / col):

    ptr        [n+1]               CSR offsets over valid slices of vertex v
    slice_idx  [NVS]   int32       slice index k of each valid slice
    slice_data [NVS, S/32] uint32  the packed bits of that slice

Its memory footprint is ``NVS * (S/8 + 4)`` bytes (4-byte index + S/8 data
bytes per valid slice).

The *work list* enumerates, for every oriented edge (i, j), the valid slice
pairs ``(R_i S_k, C_j S_k)`` — only slices valid on BOTH sides are ever loaded
or computed. The work list is the unit the executor feeds to the kernel.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.bitmat import WORD_BITS
from repro_torch.graphs.csr import Graph

__all__ = [
    "SlicedBitmap",
    "Worklist",
    "build_sbf",
    "build_worklist",
    "build_worklist_pairs",
    "sbf_from_arrays",
    "worklist_from_arrays",
    "sbf_stats",
]


@dataclasses.dataclass(frozen=True)
class SlicedBitmap:
    """The SBF arrays — host NumPy (the host build) or device torch.

    ``core.build`` produces device-resident instances: int32 pointers and
    slice indices, and stores of int32 views of the uint32 words,
    zero-padded to pow2 row buckets (the executor's layout). There
    ``row_valid``/``col_valid`` carry the real valid-slice counts and
    ``content_key`` lets executor pools key the stores without reading them
    back. Host-built instances keep exact-length arrays and leave the
    optional fields ``None``. ``to_host()`` gives the host form.
    """

    slice_bits: int
    n: int
    n_slices: int  # slices per row/column = ceil(n / slice_bits)
    # Row side (rows of upper-triangular A; neighbours j > i).
    row_ptr: np.ndarray
    row_slice_idx: np.ndarray
    row_slice_data: np.ndarray
    # Column side (columns of upper-triangular A; predecessors i < j).
    col_ptr: np.ndarray
    col_slice_idx: np.ndarray
    col_slice_data: np.ndarray
    # Device builds only: real record counts of the pow2-padded stores.
    row_valid: int | None = None
    col_valid: int | None = None
    content_key: str | None = None

    @property
    def is_device(self) -> bool:
        return isinstance(self.row_slice_data, torch.Tensor)

    def to_host(self) -> "SlicedBitmap":
        """Exact host copy — uint32 words, int32 indices, int64 pointers,
        trimmed to the valid counts (identity for host-built instances)."""
        if not self.is_device:
            return self
        row_n = self.row_valid if self.row_valid is not None else len(self.row_slice_idx)
        col_n = self.col_valid if self.col_valid is not None else len(self.col_slice_idx)

        def host(t, rows=None, dtype=None):
            a = (t if rows is None else t[:rows]).cpu().numpy()
            return a.view(np.uint32) if dtype is None else a.astype(dtype)

        return SlicedBitmap(
            slice_bits=self.slice_bits,
            n=self.n,
            n_slices=self.n_slices,
            row_ptr=host(self.row_ptr, dtype=np.int64),
            row_slice_idx=host(self.row_slice_idx, row_n, np.int32),
            row_slice_data=host(self.row_slice_data, row_n),
            col_ptr=host(self.col_ptr, dtype=np.int64),
            col_slice_idx=host(self.col_slice_idx, col_n, np.int32),
            col_slice_data=host(self.col_slice_data, col_n),
        )

    @property
    def words_per_slice(self) -> int:
        return self.slice_bits // WORD_BITS

    @property
    def nvs(self) -> int:
        """Total number of valid slices stored (row side + column side).

        Device builds pad their stores to pow2 buckets, so the real counts
        come from ``row_valid``/``col_valid`` there.
        """
        if self.row_valid is not None:
            return int(self.row_valid) + int(self.col_valid)
        return int(len(self.row_slice_idx) + len(self.col_slice_idx))

    @property
    def index_bytes(self) -> int:
        return self.nvs * 4

    @property
    def data_bytes(self) -> int:
        return self.nvs * (self.slice_bits // 8)

    @property
    def total_bytes(self) -> int:
        return self.index_bytes + self.data_bytes


def _build_side(
    first: np.ndarray, second: np.ndarray, n: int, slice_bits: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Valid slices for one side.

    ``first`` indexes the vertex owning the vector (row id or col id);
    ``second`` is the bit position within that vector (the other endpoint).
    """
    n_slices = (n + slice_bits - 1) // slice_bits
    wps = slice_bits // WORD_BITS
    k = second // slice_bits
    key = first * np.int64(n_slices) + k
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    second_s = second[order]
    uniq = np.unique(key_s)
    # Map every edge to its valid-slice record.
    vs_of_edge = np.searchsorted(uniq, key_s)
    data = np.zeros((len(uniq), wps), dtype=np.uint32)
    bit_in_slice = (second_s % slice_bits).astype(np.int64)
    word = bit_in_slice // WORD_BITS
    bit = (bit_in_slice % WORD_BITS).astype(np.uint32)
    np.bitwise_or.at(
        data, (vs_of_edge, word), (np.uint32(1) << bit).astype(np.uint32)
    )
    slice_idx = (uniq % n_slices).astype(np.int32)
    owner = (uniq // n_slices).astype(np.int64)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(owner, minlength=n), out=ptr[1:])
    return ptr, slice_idx, data


def build_sbf(g: Graph, slice_bits: int = 64) -> SlicedBitmap:
    """Compress the oriented adjacency of ``g`` into SBF (both sides)."""
    if slice_bits % WORD_BITS != 0:
        raise ValueError(f"slice_bits must be a multiple of {WORD_BITS}")
    src, dst = g.edges[:, 0], g.edges[:, 1]
    n_slices = (g.n + slice_bits - 1) // slice_bits
    row_ptr, row_idx, row_data = _build_side(src, dst, g.n, slice_bits)
    col_ptr, col_idx, col_data = _build_side(dst, src, g.n, slice_bits)
    return SlicedBitmap(
        slice_bits=slice_bits,
        n=g.n,
        n_slices=n_slices,
        row_ptr=row_ptr,
        row_slice_idx=row_idx,
        row_slice_data=row_data,
        col_ptr=col_ptr,
        col_slice_idx=col_idx,
        col_slice_data=col_data,
    )


@dataclasses.dataclass(frozen=True)
class Worklist:
    """Flat list of valid slice pairs, the schedulable unit of TCIM compute.

    pair_row_pos[p], pair_col_pos[p] index into sbf.row_slice_data /
    sbf.col_slice_data; pair_edge[p] records the owning edge.
    """

    pair_edge: np.ndarray
    pair_row_pos: np.ndarray
    pair_col_pos: np.ndarray
    m_edges: int
    n_slices: int

    @property
    def num_pairs(self) -> int:
        return int(len(self.pair_edge))

    def compute_reduction(self) -> float:
        """Fraction of naive slice-pair work eliminated (Table IV headline)."""
        naive = self.m_edges * self.n_slices
        return 1.0 - (self.num_pairs / naive) if naive else 0.0


def _window_searchsorted(
    sorted_concat: np.ndarray, lo: np.ndarray, hi: np.ndarray, keys: np.ndarray
) -> np.ndarray:
    """Vectorized binary search of keys[i] within sorted_concat[lo[i]:hi[i])."""
    lo = lo.astype(np.int64).copy()
    hi_w = hi.astype(np.int64).copy()
    if len(sorted_concat) == 0:
        # Every window is empty; the lower bound is the window start.
        return np.minimum(lo, hi_w)
    while True:
        active = lo < hi_w
        if not active.any():
            break
        mid = (lo + hi_w) >> 1
        midval = sorted_concat[np.minimum(mid, len(sorted_concat) - 1)]
        go_right = active & (midval < keys)
        lo = np.where(go_right, mid + 1, lo)
        hi_w = np.where(active & ~go_right, mid, hi_w)
    return lo


def build_worklist_pairs(
    src: np.ndarray,
    dst: np.ndarray,
    sbf: SlicedBitmap,
    block_edges: int = 1 << 18,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Valid slice pairs for an arbitrary set of oriented edges.

    Returns ``(pair_edge, pair_row_pos, pair_col_pos)`` with ``pair_edge``
    indexing into the given ``src``/``dst`` arrays. Positions are global
    record coordinates into ``sbf.row_slice_data`` / ``sbf.col_slice_data``.
    """
    if len(sbf.row_slice_idx) == 0 or len(sbf.col_slice_idx) == 0 or len(src) == 0:
        # An SBF with an empty side has no valid pairs; the expansion below
        # would index the empty side's last element (-1) and raise.
        zero = np.zeros(0, dtype=np.int64)
        return zero, zero.copy(), zero.copy()
    pe, prp, pcp = [], [], []
    for start in range(0, len(src), block_edges):
        u = src[start : start + block_edges]
        v = dst[start : start + block_edges]
        cnt = (sbf.row_ptr[u + 1] - sbf.row_ptr[u]).astype(np.int64)
        total = int(cnt.sum())
        if total == 0:
            continue
        edge_of = np.repeat(np.arange(len(u), dtype=np.int64), cnt)
        base = np.repeat(sbf.row_ptr[u], cnt)
        offs = np.arange(total, dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt
        )
        row_pos = base + offs  # candidate row-slice records
        ks = sbf.row_slice_idx[row_pos].astype(np.int64)
        vv = v[edge_of]
        lo = sbf.col_ptr[vv]
        hi = sbf.col_ptr[vv + 1]
        pos = _window_searchsorted(sbf.col_slice_idx.astype(np.int64), lo, hi, ks)
        safe = np.minimum(pos, len(sbf.col_slice_idx) - 1)
        hit = (pos < hi) & (sbf.col_slice_idx[safe].astype(np.int64) == ks)
        pe.append(edge_of[hit] + start)
        prp.append(row_pos[hit])
        pcp.append(pos[hit])
    if pe:
        return np.concatenate(pe), np.concatenate(prp), np.concatenate(pcp)
    zero = np.zeros(0, dtype=np.int64)
    return zero, zero.copy(), zero.copy()


def build_worklist(g: Graph, sbf: SlicedBitmap, block_edges: int = 1 << 18) -> Worklist:
    """Enumerate valid slice pairs for every oriented edge (vectorized).

    For each edge (i, j), expand row i's valid slice list, then keep the
    (edge, k) pairs where column j also has slice k valid — membership tested
    with a windowed binary search over the column side's sorted slice_idx.
    """
    pair_edge, pair_row, pair_col = build_worklist_pairs(
        g.edges[:, 0], g.edges[:, 1], sbf, block_edges
    )
    return Worklist(
        pair_edge=pair_edge,
        pair_row_pos=pair_row,
        pair_col_pos=pair_col,
        m_edges=g.m,
        n_slices=sbf.n_slices,
    )


def _field(src, name: str):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def sbf_from_arrays(src) -> SlicedBitmap:
    """A ``SlicedBitmap`` from any mapping or object carrying the SBF fields.

    ``src`` is read by field name (``slice_bits``, ``n``, ``n_slices``,
    ``row_ptr``, ``row_slice_idx``, ``row_slice_data`` and the ``col_*``
    trio), so a SlicedBitmap built by another package, or a dict of NumPy
    arrays, carries across without this module importing that package.
    Arrays are copied into the dtypes ``build_sbf`` produces.
    """
    out = {
        "slice_bits": int(_field(src, "slice_bits")),
        "n": int(_field(src, "n")),
        "n_slices": int(_field(src, "n_slices")),
    }
    for side in ("row", "col"):
        out[f"{side}_ptr"] = np.array(_field(src, f"{side}_ptr"), dtype=np.int64)
        out[f"{side}_slice_idx"] = np.array(
            _field(src, f"{side}_slice_idx"), dtype=np.int32
        )
        data = np.array(_field(src, f"{side}_slice_data"), dtype=np.uint32)
        if data.ndim != 2 or data.shape[1] * WORD_BITS != out["slice_bits"]:
            raise ValueError(
                f"{side}_slice_data has shape {data.shape}; expected "
                f"[records, {out['slice_bits'] // WORD_BITS}] uint32 words"
            )
        out[f"{side}_slice_data"] = data
    return SlicedBitmap(**out)


def worklist_from_arrays(src) -> Worklist:
    """A ``Worklist`` from any mapping or object carrying the worklist fields
    (``pair_edge``, ``pair_row_pos``, ``pair_col_pos``, ``m_edges``,
    ``n_slices``); the pair arrays are copied as int64."""
    arrays = {
        name: np.array(_field(src, name), dtype=np.int64)
        for name in ("pair_edge", "pair_row_pos", "pair_col_pos")
    }
    if not len(arrays["pair_edge"]) == len(arrays["pair_row_pos"]) == len(
        arrays["pair_col_pos"]
    ):
        raise ValueError("worklist pair arrays differ in length")
    return Worklist(
        **arrays,
        m_edges=int(_field(src, "m_edges")),
        n_slices=int(_field(src, "n_slices")),
    )


def sbf_stats(g: Graph, sbf: SlicedBitmap, wl: Worklist | None = None) -> dict:
    """Statistics backing Tables III & IV of the paper."""
    possible = 2 * g.n * sbf.n_slices  # row side + col side
    stats = {
        "n": g.n,
        "m": g.m,
        "slice_bits": sbf.slice_bits,
        "n_slices_per_vec": sbf.n_slices,
        "nvs": sbf.nvs,
        "valid_slice_pct": 100.0 * sbf.nvs / possible if possible else 0.0,
        "index_bytes": sbf.index_bytes,
        "data_bytes": sbf.data_bytes,
        "total_bytes": sbf.total_bytes,
        "total_mb": sbf.total_bytes / (1024 * 1024),
        "kb_per_1000_vertices": (sbf.total_bytes / 1024) / max(g.n / 1000.0, 1e-9),
    }
    if wl is not None:
        stats["num_pairs"] = wl.num_pairs
        stats["compute_reduction_pct"] = 100.0 * wl.compute_reduction()
    return stats
