"""Popcount-GEMM: ``C[i, j] = sum_w popcount(X[i, w] & Y[j, w])``.

Port of ``src/repro/kernels/tc_bitgemm.py`` (``bitgemm_pallas``): the
blocked generalisation of the paper's per-edge AND+BitCount, a whole tile of
(row, column) pairs from bit-packed operands at once. It carries the
``bitgemm`` backend of ``tcim_count``.

  * ``bitgemm_cuda`` — the wrapper of the hand-written CUDA kernel
    ``csrc/tc_bitgemm.cu`` (its header gives the design and bound). It writes
    a caller-owned int32 ``out[I, J]``, launches on the current stream,
    allocates nothing, and counts its launches in ``bitgemm_cuda.launches``.
  * ``bitgemm_reference`` — the plain torch version with the same contract:
    a broadcast AND over ``[rows, J, W]`` and the SWAR popcount of
    ``kernels/common.py``, chunked over rows (and words) so the broadcast
    stays bounded. It runs on any device and is the CPU path.

Operands are int32 views of the uint32 words. The reference pads its
operands to whole blocks; the kernel masks its ragged edges itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import swar_popcount_u32

__all__ = ["bitgemm_cuda", "bitgemm_reference"]

# Largest number of X rows one launch takes: 65535 row tiles of 64 (the
# grid's y limit). Callers chunk the rows, as tcim's bitgemm backend does.
_MAX_ROWS = 65535 * 64

# Elements of the broadcast ``[rows, J, W]`` that the plain version holds at
# once (each becomes a few int64 temporaries in the SWAR popcount).
_PLAIN_BUDGET = 1 << 22


def bitgemm_reference(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``[I, W]`` x ``[J, W]`` int32 words ->
    ``[I, J]`` int32 popcount inner products."""
    rows_i, words = x.shape
    rows_j = y.shape[0]
    out = torch.zeros(rows_i, rows_j, dtype=torch.int32, device=x.device)
    if rows_i == 0 or rows_j == 0 or words == 0:
        return out
    span_w = max(1, min(words, _PLAIN_BUDGET // rows_j))
    span_i = max(1, _PLAIN_BUDGET // (rows_j * span_w))
    for i in range(0, rows_i, span_i):
        xi = x[i : i + span_i, None, :]
        for w in range(0, words, span_w):
            z = xi[:, :, w : w + span_w] & y[None, :, w : w + span_w]
            out[i : i + span_i] += swar_popcount_u32(z).sum(dim=2, dtype=torch.int32)
    return out


def _kernel():
    from repro_torch.kernels._build import load_library

    fn = load_library("tc_bitgemm").tc_bitgemm
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, i32, i32, i32, i32, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def bitgemm_cuda(
    x: torch.Tensor, y: torch.Tensor, out: torch.Tensor, *, block_w: int = 32
) -> torch.Tensor:
    """Launch the kernel: ``out[i, j] = sum_w popc(x[i, w] & y[j, w])``.

    ``x`` ``[I, W]`` and ``y`` ``[J, W]`` int32 words, ``out`` int32
    ``[I, J]``, all contiguous on one card. ``block_w`` words are staged in
    shared memory a step; a value the card cannot hold is refused at launch
    and raises ``RuntimeError``. Returns ``out``.
    """
    for name, t in {"x": x, "y": y, "out": out}.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != out.device:
            raise ValueError(f"{name} is on {t.device}, out on {out.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    rows_i, words = x.shape
    rows_j = y.shape[0]
    if y.shape[1] != words:
        raise ValueError(f"operand widths {words} and {y.shape[1]} differ")
    if tuple(out.shape) != (rows_i, rows_j):
        raise ValueError(f"out must have shape ({rows_i}, {rows_j}), got {tuple(out.shape)}")
    if rows_i > _MAX_ROWS:
        raise ValueError(f"{rows_i} rows exceed one launch's {_MAX_ROWS}; chunk the rows")
    if block_w < 1:
        raise ValueError(f"block_w must be >= 1, got {block_w}")
    if rows_i == 0 or rows_j == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), rows_i, rows_j, words, block_w,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tc_bitgemm launch failed: CUDA error {err}")
    bitgemm_cuda.launches += 1
    return out


bitgemm_cuda.launches = 0
