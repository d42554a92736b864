"""Baseline TC implementations the paper compares against (§II-A, Table V).

Port of ``src/repro/core/baselines.py``.

* ``matmul_tc``        — matrix-multiplication family: trace(A^3)/6 on the
                         symmetric adjacency (blocked ``torch.matmul``, as
                         the reference leaves its product to XLA: no Pallas
                         kernel computes it there).
* ``intersection_tc``  — set-intersection family: the CPU baseline algorithm
                         (vectorized numpy merge; see graphs.exact).
"""
from __future__ import annotations

import time

import torch

from repro_torch.graphs.csr import Graph
from repro_torch.graphs.exact import triangles_intersection
from repro_torch.kernels.common import resolve_device
from repro_torch.runtime.staging import stage

__all__ = ["matmul_tc", "intersection_tc", "timed"]


def matmul_tc(g: Graph, block: int = 4096, *, device: str | torch.device | None = None) -> int:
    """trace(A^3)/6 with blocked float32 matmuls on ``device`` (the card
    unless asked).

    trace(A^3) = sum_ij A[i, j] * (A @ A)[i, j]; computed block-row-wise so
    only [block, n] panels are resident. {0,1} operands are exact in float32
    (and in TF32), and each panel entry is at most n < 2^24; each panel's
    masked sum is taken in float64, so the count is exact.
    """
    dev = resolve_device(device)
    n = g.n
    a = torch.zeros(n, n, dtype=torch.float32, device=dev)
    if g.m:
        e = stage(g.edges, dev, non_blocking=False)
        a[e[:, 0], e[:, 1]] = 1.0
        a[e[:, 1], e[:, 0]] = 1.0
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for start in range(0, n, block):
        stop = min(start + block, n)
        panel = a[start:stop] @ a  # [b, n]
        total += (panel * a[start:stop]).sum(dtype=torch.float64)
    return int(round(float(total) / 6.0))


def intersection_tc(g: Graph) -> int:
    """The paper's CPU baseline family (oriented merge-intersection)."""
    return triangles_intersection(g)


def timed(fn, *args, **kwargs):
    """(result, seconds) helper used by benchmarks."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0
