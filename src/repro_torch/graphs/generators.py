"""Synthetic graph generators.

Port of ``src/repro/graphs/generators.py``: a NumPy copy,
kept here because the port imports nothing of the JAX package.

SNAP datasets (Table II of the paper) are not available offline, so benchmarks
run on synthetic analogues with matched vertex/edge statistics:

  * ``rmat``            — power-law, social-network-like (ego-facebook, com-lj, ...)
  * ``erdos_renyi``     — uniform random, email-enron-like density
  * ``grid_road``       — 2D lattice + sparse chords, road-network-like
                          (few triangles, very low valid-slice density)
  * ``barabasi_albert`` — preferential attachment, heavy-tailed degrees

All generators return a canonical undirected edge list: ``np.ndarray [m, 2]
int64`` with ``src < dst``, deduplicated, no self loops.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "erdos_renyi",
    "rmat",
    "barabasi_albert",
    "grid_road",
    "complete_graph",
    "triangle_free_bipartite",
    "GRAPH_GENERATORS",
]


def _canonicalize(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Dedup, drop self loops, enforce src < dst; returns [m,2] int64."""
    src = src.astype(np.int64)
    dst = dst.astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    key = lo * np.int64(1) << np.int64(32) | hi  # n < 2**31 always holds here
    key = np.unique(key)
    lo = (key >> np.int64(32)).astype(np.int64)
    hi = (key & np.int64(0xFFFFFFFF)).astype(np.int64)
    return np.stack([lo, hi], axis=1)


def erdos_renyi(n: int, m: int, seed: int = 0) -> np.ndarray:
    """~m undirected edges sampled uniformly at random over n vertices."""
    rng = np.random.default_rng(seed)
    # Oversample to survive dedup/self-loop losses.
    factor = 1.3
    src = rng.integers(0, n, size=int(m * factor), dtype=np.int64)
    dst = rng.integers(0, n, size=int(m * factor), dtype=np.int64)
    edges = _canonicalize(src, dst)
    if len(edges) > m:
        idx = rng.choice(len(edges), size=m, replace=False)
        edges = edges[np.sort(idx)]
    return edges


def rmat(
    n: int,
    m: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> np.ndarray:
    """R-MAT power-law generator (Chakrabarti et al.); n rounded up to 2**k."""
    rng = np.random.default_rng(seed)
    levels = max(1, int(np.ceil(np.log2(max(n, 2)))))
    n_pow = 1 << levels
    d = 1.0 - a - b - c
    probs = np.array([a, b, c, d])
    cum = np.cumsum(probs)
    m_try = int(m * 1.4)
    src = np.zeros(m_try, dtype=np.int64)
    dst = np.zeros(m_try, dtype=np.int64)
    for _ in range(levels):
        r = rng.random(m_try)
        quad = np.searchsorted(cum, r)
        src = (src << 1) | (quad >> 1)
        dst = (dst << 1) | (quad & 1)
    # Fold down into [0, n) so requested vertex count is honoured.
    src %= n
    dst %= n
    edges = _canonicalize(src, dst)
    if len(edges) > m:
        idx = rng.choice(len(edges), size=m, replace=False)
        edges = edges[np.sort(idx)]
    del n_pow
    return edges


def barabasi_albert(n: int, m_per_node: int = 4, seed: int = 0) -> np.ndarray:
    """Preferential attachment; ~n * m_per_node edges, heavy-tailed degrees."""
    rng = np.random.default_rng(seed)
    m0 = m_per_node + 1
    srcs = [np.repeat(np.arange(1, m0), 1)]
    dsts = [np.zeros(m0 - 1, dtype=np.int64)]
    # Repeated-nodes trick: sample targets from the flat endpoint list.
    endpoints = np.concatenate([np.arange(m0), np.zeros(m0 - 1, dtype=np.int64)])
    endpoint_list = list(endpoints)
    for v in range(m0, n):
        targets = rng.choice(len(endpoint_list), size=m_per_node)
        tgt = np.unique(np.array([endpoint_list[t] for t in targets], dtype=np.int64))
        srcs.append(np.full(len(tgt), v, dtype=np.int64))
        dsts.append(tgt)
        endpoint_list.extend(tgt.tolist())
        endpoint_list.extend([v] * len(tgt))
    return _canonicalize(np.concatenate(srcs), np.concatenate(dsts))


def grid_road(n: int, chord_frac: float = 0.05, seed: int = 0) -> np.ndarray:
    """Road-network-like: sqrt(n) x sqrt(n) 4-lattice + a few random chords.

    Very low triangle count and extremely sparse rows, mimicking roadNet-*.
    """
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    n_eff = side * side
    ids = np.arange(n_eff, dtype=np.int64).reshape(side, side)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1)
    # Occasional diagonal chords create the rare triangles road networks have.
    n_chords = int(chord_frac * n_eff)
    ci = rng.integers(0, side - 1, size=n_chords)
    cj = rng.integers(0, side - 1, size=n_chords)
    chords = np.stack([ids[ci, cj], ids[ci + 1, cj + 1]], axis=1)
    edges = np.concatenate([right, down, chords], axis=0)
    return _canonicalize(edges[:, 0], edges[:, 1])


def complete_graph(n: int) -> np.ndarray:
    """K_n — C(n,3) triangles; worst-case density for stress tests."""
    i, j = np.triu_indices(n, k=1)
    return np.stack([i, j], axis=1).astype(np.int64)


def triangle_free_bipartite(n: int, m: int, seed: int = 0) -> np.ndarray:
    """Bipartite random graph — exactly zero triangles by construction."""
    rng = np.random.default_rng(seed)
    half = n // 2
    src = rng.integers(0, half, size=int(m * 1.3), dtype=np.int64)
    dst = rng.integers(half, n, size=int(m * 1.3), dtype=np.int64)
    edges = _canonicalize(src, dst)
    if len(edges) > m:
        idx = rng.choice(len(edges), size=m, replace=False)
        edges = edges[np.sort(idx)]
    return edges


GRAPH_GENERATORS = {
    "erdos_renyi": erdos_renyi,
    "rmat": rmat,
    "barabasi_albert": barabasi_albert,
    "grid_road": grid_road,
    "complete": complete_graph,
    "bipartite": triangle_free_bipartite,
}
