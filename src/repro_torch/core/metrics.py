"""Per-edge / per-vertex triangle analytics on the TCIM engine.

Port of ``src/repro/core/metrics.py``. The paper motivates TC as "the first
fundamental step in calculating metrics such as clustering coefficient and
transitivity ratio" (§I) and its baseline accelerators (HPEC'18 GPU/FPGA)
also do truss decomposition. These build directly on Eq. 5's per-pair
popcounts:

  edge_support       per-edge triangle counts (segment-sum of pair counts);
                     on the card through the CUDA items kernel
  clustering         per-vertex local clustering coefficient + transitivity
  ktruss             k-truss decomposition by iterative support peeling

``clustering_coefficients``, ``ktruss`` and ``max_truss`` are host NumPy,
copied from the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sbf import build_sbf, build_worklist
from repro_torch.graphs.csr import Graph
from repro_torch.kernels import ops
from repro_torch.kernels.common import resolve_device
from repro_torch.runtime.staging import stage
from repro_torch.kernels.slice_and_popcount import items_reference

__all__ = ["edge_support", "clustering_coefficients", "ktruss", "max_truss"]


def edge_support(
    g: Graph,
    slice_bits: int = 64,
    backend: str = "pallas_items",
    *,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Triangles through each oriented edge (i,j): |{k: i<k<j, ik & kj}|
    counted by Eq. 5's AND+BitCount, aggregated per edge.

    The slice stores go to ``device`` (the card unless asked), the pairs are
    gathered there with ``index_select``, and ``backend="pallas_items"``
    counts them with ``ops.popcount_and_items`` (the items kernel on the
    card); any other backend takes its plain version.

    NOTE: support here counts each triangle at ONE edge (the (min,max)
    orientation); ``_full_support`` in ktruss() symmetrizes to the standard
    per-edge triangle membership.
    """
    dev = resolve_device(device)
    sbf = build_sbf(g, slice_bits)
    wl = build_worklist(g, sbf)
    if wl.num_pairs == 0:
        return np.zeros(g.m, dtype=np.int64)

    def gather(store: np.ndarray, pos: np.ndarray) -> torch.Tensor:
        data = stage(np.ascontiguousarray(store).view(np.int32), dev, non_blocking=False)
        return data.index_select(0, stage(pos.astype(np.int64), dev, non_blocking=False))

    rows = gather(sbf.row_slice_data, wl.pair_row_pos)
    cols = gather(sbf.col_slice_data, wl.pair_col_pos)
    if backend == "pallas_items":
        counts = ops.popcount_and_items(rows, cols)
    else:
        counts = items_reference(rows, cols)
    out = np.zeros(g.m, dtype=np.int64)
    np.add.at(out, wl.pair_edge, counts.cpu().numpy().astype(np.int64))
    return out


def _triangle_list(g: Graph) -> np.ndarray:
    """Explicit (a<b<c) triangle triples — for peeling and tests. Scales to
    the tens-of-millions of triangles of the benchmark analogues."""
    indptr, indices = g.indptr, g.indices
    tris = []
    for a in range(g.n):
        nbrs = indices[indptr[a] : indptr[a + 1]]
        if len(nbrs) < 2:
            continue
        for bi in range(len(nbrs)):
            b = nbrs[bi]
            # common neighbours of a (after b) and b
            rest = nbrs[bi + 1 :]
            bn = indices[indptr[b] : indptr[b + 1]]
            common = np.intersect1d(rest, bn, assume_unique=True)
            for c in common:
                tris.append((a, b, c))
    return np.array(tris, dtype=np.int64).reshape(-1, 3)


def clustering_coefficients(g: Graph) -> tuple[np.ndarray, float]:
    """(per-vertex local clustering coefficient, global transitivity)."""
    tris = _triangle_list(g)
    tri_per_vertex = np.zeros(g.n, dtype=np.int64)
    for col in range(3):
        np.add.at(tri_per_vertex, tris[:, col], 1)
    deg = np.zeros(g.n, dtype=np.int64)
    np.add.at(deg, g.edges[:, 0], 1)
    np.add.at(deg, g.edges[:, 1], 1)
    wedges = deg * (deg - 1) // 2
    with np.errstate(divide="ignore", invalid="ignore"):
        local = np.where(wedges > 0, tri_per_vertex / np.maximum(wedges, 1), 0.0)
    total_wedges = int(wedges.sum())
    transitivity = 3.0 * len(tris) / total_wedges if total_wedges else 0.0
    return local, transitivity


def _edge_id_map(g: Graph):
    key = g.edges[:, 0] * np.int64(1 << 32) | g.edges[:, 1]
    return key


def ktruss(g: Graph, k: int) -> np.ndarray:
    """Boolean mask over g.edges: membership in the k-truss (every edge in
    >= k-2 triangles within the subgraph). Iterative peeling."""
    if k < 3:
        return np.ones(g.m, dtype=bool)
    tris = _triangle_list(g)
    keys = _edge_id_map(g)

    def eid(u, v):
        return np.searchsorted(keys, u * np.int64(1 << 32) | v)

    if len(tris) == 0:
        return np.zeros(g.m, dtype=bool)
    e1 = eid(tris[:, 0], tris[:, 1])
    e2 = eid(tris[:, 0], tris[:, 2])
    e3 = eid(tris[:, 1], tris[:, 2])
    tri_edges = np.stack([e1, e2, e3], axis=1)
    alive_edge = np.ones(g.m, dtype=bool)
    alive_tri = np.ones(len(tris), dtype=bool)
    need = k - 2
    while True:
        support = np.zeros(g.m, dtype=np.int64)
        te = tri_edges[alive_tri]
        for col in range(3):
            np.add.at(support, te[:, col], 1)
        drop = alive_edge & (support < need)
        if not drop.any():
            return alive_edge
        alive_edge &= ~drop
        alive_tri &= alive_edge[tri_edges].all(axis=1)


def max_truss(g: Graph) -> int:
    """Largest k with a non-empty k-truss."""
    k = 2
    while ktruss(g, k + 1).any():
        k += 1
    return k
