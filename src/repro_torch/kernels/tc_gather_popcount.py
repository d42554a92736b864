"""Fused gather–AND–popcount: the TCIM execute stage in one pass.

Port of ``src/repro/kernels/tc_gather_popcount.py`` (``gather_total_pallas``,
``gather_segment_totals_pallas``, their references, ``modeled_hbm_bytes``).
The slice stores stay resident on the card; only the work-list index arrays
travel, and the gather happens inside the kernel.

  * ``gather_total_cuda`` — the wrapper of the hand-written CUDA kernel
    ``csrc/tc_gather_popcount.cu`` (its header gives the design and bound).
    It adds into a caller-owned int32 ``out[2]``: ``out[0]`` the popcount
    total, ``out[1]`` the number of pairs with an index past the end of its
    store, which the kernel never reads. It launches on the current stream,
    allocates nothing, and counts its launches in ``gather_total_cuda.launches``.
  * ``gather_total_reference`` — the plain torch version with the same
    contract (negative indices are no-ops; out-of-range indices are counted,
    not read). It runs on any device and is the CPU path. It uses the SWAR
    popcount of ``kernels/common.py``, so the byte-table oracle in
    ``kernels/ref.py`` stays an independent check.
  * ``gather_segment_totals_cuda`` / ``gather_segment_totals_reference`` —
    the same per segment of ``bucket`` pairs (one fused graph each), into a
    caller-owned int32 ``out[G, 2]`` of ``[subtotal, out_of_range]`` rows:
    the cross-graph serving twin that ``MultiGraphExecutor`` dispatches.

The reference's ``jnp.take`` hands back an all-ones fill row for a positive
index past the end of the store; the port counts such indices instead, and
``CountFuture.result`` raises on them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import swar_popcount_u32

__all__ = [
    "gather_segment_totals_cuda",
    "gather_segment_totals_reference",
    "gather_total_cuda",
    "gather_total_reference",
    "modeled_hbm_bytes",
]

_WORDS = (1, 2, 4)


def gather_total_reference(
    row_data: torch.Tensor,  # [R, W] int32 view of uint32 words
    col_data: torch.Tensor,  # [C, W] int32 view of uint32 words
    row_idx: torch.Tensor,  # [P] int row positions (< 0 = no-op)
    col_idx: torch.Tensor,  # [P] int col positions (< 0 = no-op)
) -> torch.Tensor:
    """Plain version of the kernel -> int32 ``[total, out_of_range]``.

    Gathers with ``index_select`` on clamped indices, ANDs, counts with the
    SWAR popcount and sums the pairs whose indices are both in range and
    non-negative.
    """
    num_rows, num_cols = row_data.shape[0], col_data.shape[0]
    bad = (row_idx >= num_rows) | (col_idx >= num_cols)
    out = torch.zeros(2, dtype=torch.int32, device=row_data.device)
    out[1] = bad.sum()
    if row_idx.numel() == 0 or num_rows == 0 or num_cols == 0:
        return out
    valid = (row_idx >= 0) & (col_idx >= 0) & ~bad
    rows = row_data.index_select(0, row_idx.clamp(0, num_rows - 1))
    cols = col_data.index_select(0, col_idx.clamp(0, num_cols - 1))
    pc = swar_popcount_u32(rows & cols).sum(dim=1)
    out[0] = torch.where(valid, pc, 0).sum()
    return out


def gather_segment_totals_reference(
    row_data: torch.Tensor,  # [R, W] int32 view — stacked row stores
    col_data: torch.Tensor,  # [C, W] int32 view — stacked col stores
    row_idx: torch.Tensor,  # [G * bucket] store-global positions (< 0 = no-op)
    col_idx: torch.Tensor,  # [G * bucket]
    *,
    bucket: int,
) -> torch.Tensor:
    """Plain version of the segment kernel -> int32 ``[G, 2]``.

    Row ``g`` is ``[subtotal, out_of_range]`` over pairs
    ``g * bucket .. (g + 1) * bucket - 1``, with ``gather_total_reference``'s
    contract per pair.
    """
    p = row_idx.shape[0]
    if bucket < 1 or p % bucket:
        raise ValueError(f"{p} pairs do not tile into bucket={bucket} segments")
    g = p // bucket
    num_rows, num_cols = row_data.shape[0], col_data.shape[0]
    bad = (row_idx >= num_rows) | (col_idx >= num_cols)
    out = torch.zeros(g, 2, dtype=torch.int32, device=row_data.device)
    if g == 0:
        return out
    out[:, 1] = bad.reshape(g, bucket).sum(dim=1)
    if num_rows == 0 or num_cols == 0:
        return out
    valid = (row_idx >= 0) & (col_idx >= 0) & ~bad
    rows = row_data.index_select(0, row_idx.clamp(0, num_rows - 1))
    cols = col_data.index_select(0, col_idx.clamp(0, num_cols - 1))
    pc = torch.where(valid, swar_popcount_u32(rows & cols).sum(dim=1), 0)
    out[:, 0] = pc.reshape(g, bucket).sum(dim=1)
    return out


def _check(row_data, col_data, row_idx, col_idx, out, out_shape) -> int:
    """Validate the kernel's operands; returns W."""
    tensors = {
        "row_data": row_data, "col_data": col_data,
        "row_idx": row_idx, "col_idx": col_idx, "out": out,
    }
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != out.device:
            raise ValueError(f"{name} is on {t.device}, out on {out.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if row_data.dim() != 2 or col_data.dim() != 2:
        raise ValueError("stores must be [rows, W] matrices")
    w = row_data.shape[1]
    if w not in _WORDS or col_data.shape[1] != w:
        raise ValueError(
            f"store widths {row_data.shape[1]} and {col_data.shape[1]} must "
            f"match and be one of {_WORDS}"
        )
    if row_idx.dim() != 1 or row_idx.shape != col_idx.shape:
        raise ValueError(f"index shapes {row_idx.shape} and {col_idx.shape} differ")
    if tuple(out.shape) != out_shape:
        raise ValueError(f"out must have shape {out_shape}, got {tuple(out.shape)}")
    for name in ("row_data", "col_data"):
        if tensors[name].data_ptr() % (4 * w):
            raise ValueError(f"{name} is not aligned to its {4 * w}-byte rows")
        if tensors[name].shape[0] > 2**31 - 1:
            raise ValueError(f"{name} has more rows than int32 indices reach")
    return w


def _kernel(name: str = "tc_gather_total"):
    from repro_torch.kernels._build import load_library

    fn = getattr(load_library("tc_gather_popcount"), name)
    if fn.argtypes is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        extra = [i64] if name == "tc_gather_segment_totals" else []  # bucket
        fn.argtypes = [vp, i32, vp, i32, i32, vp, vp, i64, *extra, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def gather_total_cuda(
    row_data: torch.Tensor,
    col_data: torch.Tensor,
    row_idx: torch.Tensor,
    col_idx: torch.Tensor,
    out: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernel: ``out += [total, out_of_range]`` in place.

    All operands are contiguous int32 CUDA tensors on one device; raises on
    anything else, and if the launch is refused. Returns ``out``.
    """
    w = _check(row_data, col_data, row_idx, col_idx, out, (2,))
    p = row_idx.shape[0]
    if p == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(
            row_data.data_ptr(), row_data.shape[0],
            col_data.data_ptr(), col_data.shape[0], w,
            row_idx.data_ptr(), col_idx.data_ptr(), p,
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"tc_gather_total launch failed: CUDA error {err}")
    gather_total_cuda.launches += 1
    return out


gather_total_cuda.launches = 0


def gather_segment_totals_cuda(
    row_data: torch.Tensor,
    col_data: torch.Tensor,
    row_idx: torch.Tensor,
    col_idx: torch.Tensor,
    out: torch.Tensor,
    *,
    bucket: int,
) -> torch.Tensor:
    """Launch the segment kernel: ``out[g] += [subtotal, out_of_range]``.

    ``out`` is the caller's zeroed int32 ``[G, 2]`` with
    ``G = len(row_idx) // bucket``; ``bucket`` is a power of two. All
    operands are contiguous int32 CUDA tensors on one device; raises on
    anything else, and if the launch is refused. Returns ``out``.
    """
    p = row_idx.shape[0]
    if bucket < 1 or bucket & (bucket - 1) or p % bucket:
        raise ValueError(
            f"{p} pairs do not tile into power-of-two bucket={bucket} segments"
        )
    w = _check(row_data, col_data, row_idx, col_idx, out, (p // bucket, 2))
    if p == 0:
        return out
    fn = _kernel("tc_gather_segment_totals")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(
            row_data.data_ptr(), row_data.shape[0],
            col_data.data_ptr(), col_data.shape[0], w,
            row_idx.data_ptr(), col_idx.data_ptr(), p, bucket,
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"tc_gather_segment_totals launch failed: CUDA error {err}")
    gather_segment_totals_cuda.launches += 1
    return out


gather_segment_totals_cuda.launches = 0


def modeled_hbm_bytes(num_pairs: int, words_per_slice: int, *, fused: bool) -> int:
    """Analytic device-memory traffic of the execute stage for ``num_pairs``.

    fused:    indices in, each gathered slice word read once, scalar out.
    unfused:  a separate gather reads the store words *and writes* ``[P, W]``
              operand buffers, then the reduction reads them back — 3x the
              gathered-word traffic plus the same index traffic.
    """
    word_bytes = 4
    gathered = 2 * num_pairs * words_per_slice * word_bytes  # row + col sides
    index = 2 * num_pairs * 4
    out = 4
    if fused:
        return gathered + index + out
    return 3 * gathered + index + out
