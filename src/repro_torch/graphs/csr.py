"""CSR graph container + host orientation.

Port of ``src/repro/graphs/csr.py`` (``Graph``, ``build_graph``,
``degree_order``, ``upper_triangular_edges``) as a NumPy copy. The device
orientation (``device_orient``/``DeviceGraph``) belongs to the device-build
slice and is not ported yet.

The TCIM algorithm (paper §III) operates on the *upper-triangular* adjacency
matrix: a triangle {a<b<c} is counted exactly once at edge (a,c) through
intermediate b. The paper's Fig. 2 example stores 5 non-zeros for 5 undirected
edges, i.e. the oriented matrix.

``degree_order`` additionally relabels vertices by non-decreasing degree before
orienting. This is the standard fill-reducing trick for oriented TC (it bounds
per-row work by arboricity) and, for TCIM, concentrates the valid slices.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "Graph",
    "build_graph",
    "degree_order",
    "upper_triangular_edges",
]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected graph in canonical edge-list + CSR form.

    edges:    [m, 2] int64, src < dst, unique
    indptr:   [n+1]  CSR over the *oriented* (upper-triangular) adjacency
    indices:  [m]    column indices (all > row index)
    n:        vertex count
    """

    edges: np.ndarray
    indptr: np.ndarray
    indices: np.ndarray
    n: int

    @property
    def m(self) -> int:
        return int(len(self.edges))

    def dense(self) -> np.ndarray:
        """Dense symmetric adjacency (bool). Only for small graphs/tests."""
        a = np.zeros((self.n, self.n), dtype=bool)
        a[self.edges[:, 0], self.edges[:, 1]] = True
        a[self.edges[:, 1], self.edges[:, 0]] = True
        return a

    def dense_upper(self) -> np.ndarray:
        """Dense upper-triangular (oriented) adjacency (bool)."""
        a = np.zeros((self.n, self.n), dtype=bool)
        a[self.edges[:, 0], self.edges[:, 1]] = True
        return a


def upper_triangular_edges(edges: np.ndarray) -> np.ndarray:
    """Canonical edge list already satisfies src < dst; sort by (src, dst)."""
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    return edges[order]


def degree_order(edges: np.ndarray, n: int) -> np.ndarray:
    """Relabel vertices by non-decreasing (undirected) degree.

    Returns the relabelled canonical edge list (src < dst under new ids).
    """
    deg = np.zeros(n, dtype=np.int64)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    # Stable argsort => deterministic relabelling.
    perm = np.argsort(deg, kind="stable")  # old ids in degree order
    new_id = np.empty(n, dtype=np.int64)
    new_id[perm] = np.arange(n, dtype=np.int64)
    e = new_id[edges]
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    out = np.stack([lo, hi], axis=1)
    order = np.lexsort((out[:, 1], out[:, 0]))
    return out[order]


def build_graph(edges: np.ndarray, n: int | None = None, reorder: bool = False) -> Graph:
    """Build the oriented CSR Graph from a canonical undirected edge list."""
    if len(edges) == 0:
        n = int(n or 0)
        return Graph(
            edges=np.zeros((0, 2), dtype=np.int64),
            indptr=np.zeros(n + 1, dtype=np.int64),
            indices=np.zeros(0, dtype=np.int64),
            n=n,
        )
    if n is None:
        n = int(edges.max()) + 1
    if reorder:
        edges = degree_order(edges, n)
    edges = upper_triangular_edges(edges)
    counts = np.bincount(edges[:, 0], minlength=n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return Graph(edges=edges, indptr=indptr, indices=edges[:, 1].copy(), n=n)
