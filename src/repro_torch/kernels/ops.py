"""Public wrappers for the port's TCIM kernels.

Port of ``src/repro/kernels/ops.py`` (``INT32_SAFE_WORDS``,
``popcount_and_items``, ``popcount_and_total``, ``popcount_and_gather_total``,
``popcount_and_gather_segment_totals``, ``bitgemm``, ``dense_mxu_tc``), and
``popcount_and_gather_segment_groups``, a serve wave's batches at once. A
wrapper picks its path from where its tensors lie: CPU tensors take the
plain torch version, CUDA tensors launch the hand-written kernel or raise.
There is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import INT32_SAFE_WORDS
from repro_torch.kernels.slice_and_popcount import (
    items_cuda,
    items_reference,
    total_cuda,
    total_reference,
)
from repro_torch.kernels.tc_bitgemm import bitgemm_cuda, bitgemm_reference
from repro_torch.kernels.tc_dense_mxu import dense_mxu_tc_cuda, dense_mxu_tc_reference
from repro_torch.kernels.tc_gather_popcount import (
    SegmentTable,
    gather_segment_groups_cuda,
    gather_segment_groups_reference,
    gather_segment_totals_cuda,
    gather_segment_totals_reference,
    gather_total_cuda,
    gather_total_reference,
)

__all__ = [
    "INT32_SAFE_WORDS",
    "bitgemm",
    "dense_mxu_tc",
    "popcount_and_gather_segment_groups",
    "popcount_and_gather_segment_totals",
    "popcount_and_gather_total",
    "popcount_and_items",
    "popcount_and_total",
]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def popcount_and_items(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Per-pair popcount(rows & cols): ``[P, W]`` x ``[P, W]`` -> ``[P]`` int32.

    Operands are int32 views of gathered uint32 slice words.
    """
    if rows.shape != cols.shape:
        raise ValueError(f"operand shapes {tuple(rows.shape)} and {tuple(cols.shape)} differ")
    if _on_cpu(rows, cols):
        return items_reference(rows, cols)
    out = torch.empty(rows.shape[0], dtype=torch.int32, device=rows.device)
    return items_cuda(rows, cols, out)


def popcount_and_total(
    rows: torch.Tensor,
    cols: torch.Tensor,
    *,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Total popcount(rows & cols) over ``[P, W]`` gathered words -> int32.

    Returns a 0-d int32 total; with ``out`` (one int32 element) given, adds
    into it in place and returns it — the executor passes the first word of
    its carried accumulator. One call is safe only while the worst case
    ``total_words * 32`` fits int32: larger streams raise ``ValueError``,
    and callers chunk them.
    """
    if rows.shape != cols.shape:
        raise ValueError(f"operand shapes {tuple(rows.shape)} and {tuple(cols.shape)} differ")
    total_words = rows.numel()
    if total_words > INT32_SAFE_WORDS:
        raise ValueError(
            f"{total_words} words could overflow the int32 accumulator "
            f"(max safe: {INT32_SAFE_WORDS} = (2**31-1)//32); "
            "chunk the stream and accumulate per-chunk totals"
        )
    if out is None:
        out = torch.zeros((), dtype=torch.int32, device=rows.device)
    if total_words == 0:
        return out
    if _on_cpu(rows, cols, out):
        out += total_reference(rows, cols)
        return out
    return total_cuda(rows, cols, out)


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
    if _on_cpu(row_data, col_data, row_idx, col_idx, out):
        out += gather_total_reference(row_data, col_data, row_idx, col_idx)
        return out
    return gather_total_cuda(row_data, col_data, row_idx, col_idx, out)


def _segment_guard(row_data, row_idx, col_idx, bucket: int) -> None:
    """The checks both segment entries make before any path: equal index
    shapes, segments that tile the pairs, and a segment's worst case within
    int32."""
    if row_idx.shape != col_idx.shape:
        raise ValueError(f"index shapes {row_idx.shape} and {col_idx.shape} differ")
    p = row_idx.shape[0]
    w = row_data.shape[1]
    if bucket < 1 or p % bucket:
        raise ValueError(
            f"{p} fused pairs do not tile into bucket={bucket} segments"
        )
    if bucket * w > INT32_SAFE_WORDS:
        raise ValueError(
            f"fused segment of {bucket} pairs x {w} words could overflow "
            f"the int32 accumulator (max safe words: {INT32_SAFE_WORDS}); "
            "route the graph solo with a smaller chunk_pairs"
        )


def popcount_and_gather_segment_totals(
    row_data: torch.Tensor,
    col_data: torch.Tensor,
    row_idx: torch.Tensor,
    col_idx: torch.Tensor,
    *,
    bucket: int,
) -> torch.Tensor:
    """Per-graph totals over a fused multi-graph index block -> int32 ``[G, 2]``.

    ``row_idx``/``col_idx`` are ``G`` back-to-back ``bucket``-wide work-list
    segments (one per fused graph, sentinel-padded, shifted into the stacked
    stores). Row ``g`` of the result is ``[subtotal, out_of_range]`` of
    segment ``g``, as ``popcount_and_gather_total`` gives for one chunk.
    Each segment accumulates alone, so the int32 bound is per segment:
    ``bucket * words_per_slice * 32`` must fit int32.
    """
    _segment_guard(row_data, row_idx, col_idx, bucket)
    if _on_cpu(row_data, col_data, row_idx, col_idx):
        return gather_segment_totals_reference(
            row_data, col_data, row_idx, col_idx, bucket=bucket
        )
    out = torch.zeros(row_idx.shape[0] // bucket, 2, dtype=torch.int32, device=row_data.device)
    return gather_segment_totals_cuda(
        row_data, col_data, row_idx, col_idx, out, bucket=bucket
    )


def popcount_and_gather_segment_groups(batches) -> torch.Tensor:
    """Per-graph totals of several fused batches at once -> int32 ``[sum of G, 2]``.

    ``batches`` are ``(row_data, col_data, row_idx, col_idx, bucket)``, each
    as ``popcount_and_gather_segment_totals`` takes it; the result holds
    each batch's ``[G, 2]`` rows in order. On the card that is one zeroed
    tensor and one launch of the segment kernel for every ``GROUP_CAP``
    batches.
    """
    batches = list(batches)
    if not batches:
        raise ValueError("popcount_and_gather_segment_groups needs at least one batch")
    for row_data, _, row_idx, col_idx, bucket in batches:
        _segment_guard(row_data, row_idx, col_idx, bucket)
    if _on_cpu(*(t for b in batches for t in b[:4])):
        return gather_segment_groups_reference(batches)
    table = SegmentTable(batches)
    out = torch.zeros(table.rows, 2, dtype=torch.int32, device=table.device)
    for group in range(len(table.groups)):
        gather_segment_groups_cuda(table, out, group)
    return out


def bitgemm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Popcount-GEMM: ``[I, W]`` x ``[J, W]`` int32-viewed words -> ``[I, J]`` int32.

    ``out[i, j] = sum_w popcount(x[i, w] & y[j, w])``. Each entry is at most
    ``32 * W``, so wider operands than ``INT32_SAFE_WORDS`` raise. An empty
    ``I`` or ``J`` gives an empty result and ``W = 0`` gives zeros: the
    reference sizes its blocks for them (``src/repro/kernels/ops.py:233-235``)
    but its Pallas call then rejects them with a ``TypeError``.
    """
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"operand shapes {tuple(x.shape)} and {tuple(y.shape)} do not match")
    if x.shape[1] > INT32_SAFE_WORDS:
        raise ValueError(
            f"{x.shape[1]} words could overflow the int32 entries "
            f"(max safe: {INT32_SAFE_WORDS})"
        )
    if _on_cpu(x, y):
        return bitgemm_reference(x, y)
    out = torch.empty(x.shape[0], y.shape[0], dtype=torch.int32, device=x.device)
    return bitgemm_cuda(x, y, out)


def dense_mxu_tc(a: torch.Tensor) -> torch.Tensor:
    """Masked A @ A triangle count: ``[N, N]`` {0,1} (any int or bool dtype)
    -> 0-d int64 ``sum(A * (A @ A))``, exact.

    On the card the operand is cast to int8 ({0,1} is exact there) and the
    tensor-core kernel runs on it as it lies when its row stride is a
    multiple of 16 bytes (``dense_mxu_operand``); the reference casts to
    bf16, pads to its block and sums in f32.
    """
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"a must be square, got {tuple(a.shape)}")
    if _on_cpu(a):
        return dense_mxu_tc_reference(a)
    out = torch.zeros(1, dtype=torch.int64, device=a.device)
    a = a.to(torch.int8)
    if a.stride(-1) != 1:
        a = a.contiguous()
    return dense_mxu_tc_cuda(a, out)[0]
