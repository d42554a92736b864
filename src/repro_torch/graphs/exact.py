"""Exact triangle-counting references (oracles + the paper's baselines).

Port of ``src/repro/graphs/exact.py``: a NumPy copy,
kept here because the port imports nothing of the JAX package.

``triangles_bruteforce``   — O(n^3) dense; test oracle for tiny graphs.
``triangles_dense_trace``  — trace(A^3)/6, the paper's matmul-based family.
``triangles_intersection`` — per-edge sorted-adjacency intersection; this is
                             the paper's CPU baseline algorithm (run on
                             GraphX/E5430 in Table V). Vectorized merge-based
                             implementation so it is usable on millions of
                             edges from a single CPU core.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import Graph

__all__ = [
    "triangles_bruteforce",
    "triangles_dense_trace",
    "triangles_intersection",
]


def triangles_bruteforce(g: Graph) -> int:
    """Enumerate all vertex triples on the dense matrix. Tiny graphs only."""
    a = g.dense()
    n = g.n
    count = 0
    for i in range(n):
        for j in range(i + 1, n):
            if not a[i, j]:
                continue
            count += int(np.sum(a[i, j + 1 :] & a[j, j + 1 :]))
    return count


def triangles_dense_trace(g: Graph) -> int:
    """trace(A^3) / 6 on the dense symmetric adjacency (float64 matmul)."""
    a = g.dense().astype(np.float64)
    a3 = a @ a @ a
    return int(round(np.trace(a3) / 6.0))


def triangles_intersection(g: Graph) -> int:
    """Oriented merge-based intersection count (exact, vectorized).

    For every oriented edge (u, v), count |N+(u) ∩ N+(v)| where N+ is the
    oriented (higher-id) adjacency. Implemented as a galloping-free sorted
    merge using searchsorted over the concatenated candidate lists.
    """
    indptr, indices = g.indptr, g.indices
    total = 0
    # Process edges in blocks to bound the temporary candidate arrays.
    m = len(g.edges)
    block = 1 << 18
    for start in range(0, m, block):
        e = g.edges[start : start + block]
        u, v = e[:, 0], e[:, 1]
        du = indptr[u + 1] - indptr[u]
        # Expand u's oriented neighbours for each edge: candidates k in N+(u).
        off = np.repeat(indptr[u], du)
        local = np.arange(du.sum(), dtype=np.int64) - np.repeat(
            np.concatenate([[0], np.cumsum(du)[:-1]]), du
        )
        ks = indices[off + local]
        edge_of = np.repeat(np.arange(len(e), dtype=np.int64), du)
        vv = v[edge_of]
        # Membership test: is k in N+(v)? indices per row are sorted, so run a
        # vectorized binary search within each row's [lo, hi) window.
        lo = indptr[vv]
        hi = indptr[vv + 1]
        pos = _window_searchsorted(indices, lo, hi, ks)
        hit = (pos < hi) & (indices[np.minimum(pos, len(indices) - 1)] == ks)
        total += int(np.count_nonzero(hit & (pos < len(indices))))
    return total


def _window_searchsorted(
    sorted_concat: np.ndarray, lo: np.ndarray, hi: np.ndarray, keys: np.ndarray
) -> np.ndarray:
    """Vectorized searchsorted of keys[i] within sorted_concat[lo[i]:hi[i]].

    Binary search unrolled over the maximum window width (log2 of max degree).
    """
    lo = lo.copy()
    hi_w = hi.copy()
    # Classic vectorized binary search on [lo, hi) windows.
    while True:
        active = lo < hi_w
        if not active.any():
            break
        mid = (lo + hi_w) // 2
        midval = sorted_concat[np.minimum(mid, len(sorted_concat) - 1)]
        go_right = active & (midval < keys)
        go_left = active & ~go_right
        lo = np.where(go_right, mid + 1, lo)
        hi_w = np.where(go_left, mid, hi_w)
    return lo
