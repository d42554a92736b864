"""Behavioral LRU cache simulator (paper §IV-A "data reuse and exchange").

Port of ``src/repro/core/cachesim.py``: a NumPy copy, kept here because the
port imports nothing of the JAX package.

TCIM keeps the current row slice streamed (each row written once, overwritten
by the next row) and caches *column* slices in the computational STT-MRAM
array under LRU replacement. The paper's Fig. 5 reports, per graph, the
percentage of column-slice loads that are hits / misses / exchanges
(evictions) for a 16 MB array; hits == avoided memory WRITEs (avg 72%).

This simulator replays the work list in row-major edge order — exactly
Algorithm 1's iteration — and reproduces that accounting. It is a *behavioral*
model (host-side, pure Python) used by benchmarks/fig5_hit_miss.py and by the
energy/latency model; the device kernels do not depend on it.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

from repro_torch.core.sbf import SlicedBitmap, Worklist

__all__ = ["CacheStats", "simulate_lru"]

DEFAULT_ARRAY_BYTES = 16 * 1024 * 1024  # the paper's 16 MB computational array


@dataclasses.dataclass(frozen=True)
class CacheStats:
    capacity_slices: int
    loads: int  # total column-slice references
    hits: int
    misses: int  # includes cold misses, per the paper's accounting
    exchanges: int  # misses that evicted a resident slice (capacity misses)
    row_writes: int  # row-slice loads (streamed; each written once)

    @property
    def hit_pct(self) -> float:
        return 100.0 * self.hits / self.loads if self.loads else 0.0

    @property
    def miss_pct(self) -> float:
        return 100.0 * self.misses / self.loads if self.loads else 0.0

    @property
    def exchange_pct(self) -> float:
        return 100.0 * self.exchanges / self.loads if self.loads else 0.0

    @property
    def write_savings_pct(self) -> float:
        """Fraction of column WRITEs avoided by reuse == hit rate."""
        return self.hit_pct


def simulate_lru(
    sbf: SlicedBitmap,
    wl: Worklist,
    array_bytes: int = DEFAULT_ARRAY_BYTES,
) -> CacheStats:
    """Replay the work list through an LRU column-slice cache.

    Capacity: each resident column slice occupies slice_bits/8 data bytes
    (the index lives in the data buffer, not the array — paper Fig. 4);
    a fraction of the array is reserved for the streamed row (one slice).
    """
    slice_bytes = sbf.slice_bits // 8
    capacity = max(1, (array_bytes - slice_bytes) // slice_bytes)
    cache: OrderedDict[int, None] = OrderedDict()
    hits = misses = exchanges = 0
    col_ids = wl.pair_col_pos  # unique per (column, k) slice record
    for cid in col_ids.tolist():
        if cid in cache:
            cache.move_to_end(cid)
            hits += 1
        else:
            misses += 1
            if len(cache) >= capacity:
                cache.popitem(last=False)
                exchanges += 1
            cache[cid] = None
    # Row side: rows are streamed; each distinct row-slice in the work list is
    # written exactly once (the row buffer is overwritten per Algorithm 1).
    row_writes = int(len(np.unique(wl.pair_row_pos)))
    return CacheStats(
        capacity_slices=int(capacity),
        loads=int(len(col_ids)),
        hits=hits,
        misses=misses,
        exchanges=exchanges,
        row_writes=row_writes,
    )
