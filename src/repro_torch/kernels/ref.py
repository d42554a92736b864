"""Independent torch oracles for the port's kernels.

Port of ``src/repro/kernels/ref.py``. The reference's oracles use
``lax.population_count``, a different algorithm than its kernels' SWAR; torch
has no popcount op, so these count bits through a 256-entry byte table —
still a different algorithm than the SWAR plain versions and the kernels'
``__popc``, so agreement is evidence that both are right. ``ref_dense_tc`` sums in
int64 on the CPU and in float64 on the card (torch has no int64 matmul
there); both are exact, where the reference's float32 round is exact only
below 2^24.
"""
from __future__ import annotations

import torch

from repro_torch.runtime.staging import stage

__all__ = [
    "popcount_u32_table",
    "ref_bitgemm",
    "ref_dense_tc",
    "ref_popcount_and_items",
    "ref_popcount_and_total",
]

_POP8 = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def popcount_u32_table(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32-viewed uint32 words via the byte table."""
    x = x.contiguous()
    b = x.view(torch.uint8).reshape(*x.shape, 4).to(torch.int64)
    return stage(_POP8, x.device, non_blocking=False)[b].sum(dim=-1, dtype=torch.int32)


def ref_popcount_and_items(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[P, W] x [P, W] int32 words -> [P] int32 per-pair popcount(AND)."""
    return popcount_u32_table(rows & cols).sum(dim=-1, dtype=torch.int32)


def ref_popcount_and_total(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Total popcount(AND) over all pairs -> 0-d int64 (exact at any size)."""
    return popcount_u32_table(rows & cols).sum(dtype=torch.int64)


def ref_bitgemm(x: torch.Tensor, y: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """[I, W] x [J, W] int32 words -> [I, J] int32 popcount inner products."""
    outs = [torch.zeros(0, y.shape[0], dtype=torch.int32, device=x.device)]
    for start in range(0, x.shape[0], chunk):
        z = x[start : start + chunk, None, :] & y[None, :, :]
        outs.append(popcount_u32_table(z).sum(dim=-1, dtype=torch.int32))
    return torch.cat(outs, dim=0)


def ref_dense_tc(a: torch.Tensor) -> torch.Tensor:
    """[N, N] {0,1} upper-triangular adjacency -> 0-d int64 triangle count."""
    if a.device.type == "cpu":
        ai = a.to(torch.int64)
        return (ai * (ai @ ai)).sum()
    af = a.to(torch.float64)
    return (af * (af @ af)).sum().to(torch.int64)
