"""CSR graph container + orientations (host and device).

Port of ``src/repro/graphs/csr.py``: ``Graph``, ``build_graph``,
``degree_order`` and ``upper_triangular_edges`` as a NumPy copy, and
``device_orient``/``DeviceGraph`` as torch work on the device.

The TCIM algorithm (paper §III) operates on the *upper-triangular* adjacency
matrix: a triangle {a<b<c} is counted exactly once at edge (a,c) through
intermediate b. The paper's Fig. 2 example stores 5 non-zeros for 5 undirected
edges, i.e. the oriented matrix.

``degree_order`` additionally relabels vertices by non-decreasing degree before
orienting. This is the standard fill-reducing trick for oriented TC (it bounds
per-row work by arboricity) and, for TCIM, concentrates the valid slices.

``device_orient`` is the device mirror of ``build_graph``: one pinned,
non-blocking upload of the pow2-bucket-padded edge list, then degree
relabelling, orientation and the (src, dst) sort run as torch work on the
device and produce a ``DeviceGraph`` whose arrays never come back to the
host. It is the first stage of the device build (``core.build``); its
results are bit-identical to ``build_graph`` (asserted in tests).
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.runtime.staging import stage

__all__ = [
    "Graph",
    "DeviceGraph",
    "build_graph",
    "degree_order",
    "device_orient",
    "upper_triangular_edges",
]

# Positions, vertex ids and edge counts live in int32 on the device; the
# sentinel vertex id ``n`` must also fit.
_DEVICE_MAX = 2**31 - 2


def _pow2_ceil(x: int) -> int:
    # Local copy of core.plan.pow2_ceil: core.plan imports (via core.sbf)
    # this module, so importing it here would be circular.
    return 1 << max(0, (x - 1).bit_length())


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


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Oriented CSR resident on the device — the device build's edge container.

    ``src``/``dst`` are the oriented (src < dst), (src, dst)-sorted int32
    edge endpoints, padded to the pow2 ``bucket`` with the sentinel vertex
    id ``n`` (sentinels sort last, so the first ``m`` lanes are exactly the
    real edges). ``indptr`` is the int32 oriented CSR offsets. ``m_dev`` is
    the real edge count as a device scalar; ``m`` is the same value on the
    host. ``content_key`` digests the *input* edge list, so executor pools
    can key device-built stores without reading them back.
    """

    src: torch.Tensor  # int32 [bucket]
    dst: torch.Tensor  # int32 [bucket]
    indptr: torch.Tensor  # int32 [n+1]
    m_dev: torch.Tensor  # int32 scalar
    n: int
    m: int
    bucket: int
    content_key: str

    def to_host(self) -> Graph:
        """Materialize the oriented CSR back on the host (sync)."""
        src = self.src[: self.m].cpu().numpy().astype(np.int64)
        dst = self.dst[: self.m].cpu().numpy().astype(np.int64)
        edges = np.stack([src, dst], axis=1)
        return Graph(
            edges=edges,
            indptr=self.indptr.cpu().numpy().astype(np.int64),
            indices=edges[:, 1].copy(),
            n=self.n,
        )


def _orient(ed: torch.Tensor, m: int, n: int, reorder: bool):
    """Degree-relabel (optional), orient src < dst, sort by (src, dst).

    Mirrors ``degree_order`` + ``upper_triangular_edges``: the relabel is
    the same stable argsort of undirected degree, and the (src, dst) order
    comes from one sort of the int64 key ``src * (n + 1) + dst``, which is
    the lexicographic order (real edges are distinct; the sentinel lanes
    all carry ``(n, n)``, the largest key). Scatters go into a spare slot
    ``n`` that the sentinel lanes own and that is sliced off.
    """
    bucket = ed.shape[0]
    dev = ed.device
    valid = (torch.arange(bucket, device=dev) < m).to(torch.int32)
    src, dst = ed[:, 0], ed[:, 1]
    if reorder:
        deg = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        deg.scatter_add_(0, src.long(), valid).scatter_add_(0, dst.long(), valid)
        perm = torch.argsort(deg[:n], stable=True)
        new_id = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
        new_id.scatter_(0, perm, torch.arange(n, dtype=torch.int32, device=dev))
        s, d = new_id.index_select(0, src), new_id.index_select(0, dst)
        src, dst = torch.minimum(s, d), torch.maximum(s, d)
    key, _ = torch.sort(src.long() * (n + 1) + dst.long())
    src_s = torch.div(key, n + 1, rounding_mode="floor")
    dst_s = (key - src_s * (n + 1)).to(torch.int32)
    src_s = src_s.to(torch.int32)
    counts = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, src_s.long(), valid)
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts[:n], 0, dtype=torch.int32)])
    return src_s, dst_s, indptr


def device_orient(
    edges: np.ndarray,
    n: int | None = None,
    *,
    reorder: bool = True,
    device: str | torch.device | None = None,
) -> DeviceGraph:
    """``build_graph`` on the device: one upload, no host bounce.

    Pads the canonical undirected edge list to its pow2 bucket, uploads it
    once (pinned, non-blocking) and runs the relabel + orient + sort on
    ``device`` (the card unless the caller asks for the CPU). The returned
    ``DeviceGraph`` is bit-identical to ``build_graph(edges, n, reorder)``
    (``to_host()`` for the comparison). Raises ``ValueError`` on an empty
    edge list — callers route those through the host path — and past the
    int32 index space.
    """
    dev = resolve_device(device)
    edges = np.asarray(edges)
    m = int(len(edges))
    if m == 0:
        raise ValueError("device_orient needs a non-empty edge list")
    if n is None:
        n = int(edges.max()) + 1
    n = int(n)
    if n < 1 or n > _DEVICE_MAX or m > _DEVICE_MAX:
        raise ValueError(
            f"device build needs 1 <= n <= {_DEVICE_MAX} and m <= "
            f"{_DEVICE_MAX} (int32 device indices), got n={n} m={m}"
        )
    bucket = _pow2_ceil(m)
    padded = np.full((bucket, 2), n, dtype=np.int32)
    padded[:m] = edges
    src, dst, indptr = _orient(stage(padded, dev), m, n, bool(reorder))
    return DeviceGraph(
        src=src,
        dst=dst,
        indptr=indptr,
        m_dev=torch.full((), m, dtype=torch.int32, device=dev),
        n=n,
        m=m,
        bucket=bucket,
        # Hashed while the device sorts.
        content_key=content_key(padded, m, n, reorder),
    )


def content_key(padded: np.ndarray, m: int, n: int, reorder: bool) -> str:
    """blake2b digest of a device build's input: the first ``m`` rows of the
    int32 padded edge list (the input's values, which the int32 range
    check admits exactly) with ``n``, ``m`` and ``reorder``."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((n, m, bool(reorder), "orient-v1")).encode())
    h.update(memoryview(padded[:m]))
    return h.hexdigest()


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
