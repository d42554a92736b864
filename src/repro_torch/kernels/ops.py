"""Public wrappers for the port's TCIM kernels.

Port of ``src/repro/kernels/ops.py`` (``INT32_SAFE_WORDS``,
``popcount_and_gather_total``). The other wrappers there come with their
kernels in later slices. A wrapper picks its path from where its tensors
lie: CPU tensors take the plain torch version, CUDA tensors launch the
hand-written kernel or raise. There is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.tc_gather_popcount import (
    gather_total_cuda,
    gather_total_reference,
)

__all__ = ["INT32_SAFE_WORDS", "popcount_and_gather_total"]

# Largest number of uint32 words whose AND-popcount total provably fits the
# kernels' int32 accumulator: each word contributes at most 32 to the sum.
INT32_SAFE_WORDS = (2**31 - 1) // 32


def popcount_and_gather_total(
    row_data: torch.Tensor,
    col_data: torch.Tensor,
    row_idx: torch.Tensor,
    col_idx: torch.Tensor,
    *,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fused gather–AND–popcount over a work-list chunk -> int32 ``[2]``.

    Returns ``[total, out_of_range]``: the popcount(AND) total of the pairs
    whose indices are both non-negative (negative indices are the chunk
    padding sentinel, an exact no-op) and the number of pairs with an index
    past the end of its store (never read; callers raise on it). With
    ``out`` given, adds into it in place and returns it — the executor's
    carried accumulator.

    Stores are int32 views of the uint32 slice words, indices int32.
    """
    if row_idx.shape != col_idx.shape:
        raise ValueError(f"index shapes {row_idx.shape} and {col_idx.shape} differ")
    p = row_idx.shape[0]
    w = row_data.shape[1]
    if out is None:
        out = torch.zeros(2, dtype=torch.int32, device=row_data.device)
    if p == 0:
        return out
    if p * w > INT32_SAFE_WORDS:
        raise ValueError(
            f"chunk of {p} pairs x {w} words could overflow the int32 "
            f"accumulator (max safe words: {INT32_SAFE_WORDS}); "
            "reduce chunk_pairs"
        )
    tensors = (row_data, col_data, row_idx, col_idx, out)
    if all(t.device.type == "cpu" for t in tensors):
        out += gather_total_reference(row_data, col_data, row_idx, col_idx)
        return out
    return gather_total_cuda(row_data, col_data, row_idx, col_idx, out)
