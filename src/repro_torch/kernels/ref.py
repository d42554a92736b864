"""Independent torch oracles for the port's kernels.

Port of ``src/repro/kernels/ref.py`` (the popcount-AND oracles; the bitgemm
and dense oracles come with their kernels). The reference's oracles use
``lax.population_count``, a different algorithm than its kernels' SWAR; torch
has no popcount op, so these count bits through a 256-entry byte table —
still a different algorithm than the SWAR plain versions and the kernels'
``__popc``, so agreement is evidence that both are right.
"""
from __future__ import annotations

import torch

__all__ = ["popcount_u32_table", "ref_popcount_and_items", "ref_popcount_and_total"]

_POP8 = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def popcount_u32_table(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32-viewed uint32 words via the byte table."""
    x = x.contiguous()
    b = x.view(torch.uint8).reshape(*x.shape, 4).to(torch.int64)
    return _POP8.to(x.device)[b].sum(dim=-1, dtype=torch.int32)


def ref_popcount_and_items(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """[P, W] x [P, W] int32 words -> [P] int32 per-pair popcount(AND)."""
    return popcount_u32_table(rows & cols).sum(dim=-1, dtype=torch.int32)


def ref_popcount_and_total(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Total popcount(AND) over all pairs -> 0-d int64 (exact at any size)."""
    return popcount_u32_table(rows & cols).sum(dtype=torch.int64)
