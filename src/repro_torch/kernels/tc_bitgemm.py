"""Popcount-GEMM: ``C[i, j] = sum_w popcount(X[i, w] & Y[j, w])``.

Port of ``src/repro/kernels/tc_bitgemm.py`` (``bitgemm_pallas``): the
blocked generalisation of the paper's per-edge AND+BitCount, a whole tile of
(row, column) pairs from bit-packed operands at once. It carries the
``bitgemm`` backend of ``tcim_count``.

  * ``bitgemm_cuda`` — the wrapper of the hand-written CUDA kernel
    ``csrc/tc_bitgemm.cu``: single-bit AND-popcount ``wgmma`` on the tensor
    cores, fed by a TMA ring, persistent (its header gives the design and
    the bound: 2 I J 32W operations at the b1 MMA's rate, 8 times the
    int8 tensor-core rate). It writes a caller-owned int32 ``out[I, J]``,
    launches on the current stream and counts its launches in
    ``bitgemm_cuda.launches``. TMA reads each operand
    with its own row stride, which must be a multiple of 4 words (16 bytes):
    ``padded_words`` gives such a stride, and tcim's operands have it. An
    operand without it is copied once into a padded scratch the wrapper
    allocates, counted in ``bitgemm_cuda.padded_copies``.
  * ``bitgemm_reference`` — the plain torch version with the same contract:
    a broadcast AND over ``[rows, J, W]`` and the SWAR popcount of
    ``kernels/common.py``, chunked over rows (and words) so the broadcast
    stays bounded. It runs on any device and is the CPU path.

Operands are int32 views of the uint32 words. The reference pads its
operands to whole blocks; the kernel reads ragged I, J and W as they are
(TMA fills past the edges with zeros).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import report_cost, swar_popcount_u32

__all__ = ["ROW_ALIGN_WORDS", "bitgemm_cuda", "bitgemm_reference", "padded_view", "padded_words"]

# Row strides the kernel takes as they are: TMA reads rows 16 bytes apart.
ROW_ALIGN_WORDS = 4

# Elements of the broadcast ``[rows, J, W]`` that the plain version holds at
# once (each becomes a few int64 temporaries in the SWAR popcount).
_PLAIN_BUDGET = 1 << 22


def padded_words(words: int) -> int:
    """A row stride of at least ``words`` (and 1) words, a multiple of 8:
    whole 32-byte sectors, and a multiple of ROW_ALIGN_WORDS."""
    return -(-max(words, 1) // 8) * 8


def padded_view(t: torch.Tensor, fill: int | None = None) -> torch.Tensor:
    """``t`` copied into the ``[:, :W]`` view of rows ``padded_words(W)``
    words apart; the padding words hold ``fill`` (left unset if None)."""
    shape = (t.shape[0], padded_words(t.shape[1]))
    if fill is None:
        store = torch.empty(shape, dtype=t.dtype, device=t.device)
    else:
        store = torch.full(shape, fill, dtype=t.dtype, device=t.device)
    view = store[:, : t.shape[1]]
    view.copy_(t)
    return view


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
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [vp, ll, vp, ll, ci, ci, ci, vp, vp]
        fn.restype = ci
    return fn


def _taken(t: torch.Tensor) -> bool:
    """Whether the kernel reads ``t`` as it lies: rows of consecutive words,
    ROW_ALIGN_WORDS apart at least a row long, from a 16-byte address."""
    return (t.shape[1] == 0
            or (t.stride(0) % ROW_ALIGN_WORDS == 0 and t.stride(0) >= t.shape[1]
                and t.data_ptr() % 16 == 0))


def _padded_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a scratch whose row stride the kernel takes."""
    bitgemm_cuda.padded_copies += 1
    return padded_view(t)


def bitgemm_cuda(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``out[i, j] = sum_w popc(x[i, w] & y[j, w])``.

    ``x`` ``[I, W]`` and ``y`` ``[J, W]`` int32 words whose words are
    consecutive in each row (column stride 1), ``out`` contiguous int32
    ``[I, J]``, all on one card. An operand whose row stride is not a
    multiple of ROW_ALIGN_WORDS words is copied once into padded scratch;
    anything else the kernel cannot take raises. Returns ``out``.
    """
    for name, t in {"x": x, "y": y, "out": out}.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != out.device:
            raise ValueError(f"{name} is on {t.device}, out on {out.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    for name, t in {"x": x, "y": y}.items():
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name}'s words must be consecutive in each row (column stride 1), "
                             f"got strides {t.stride()}")
    rows_i, words = x.shape
    rows_j = y.shape[0]
    if y.shape[1] != words:
        raise ValueError(f"operand widths {words} and {y.shape[1]} differ")
    if tuple(out.shape) != (rows_i, rows_j) or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous ({rows_i}, {rows_j}), got {tuple(out.shape)} "
                         f"with strides {out.stride()}")
    if rows_i == 0 or rows_j == 0:
        return out
    x, y = (t if _taken(t) else _padded_copy(t) for t in (x, y))
    fn = _kernel()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(x.data_ptr(), x.stride(0), y.data_ptr(), y.stride(0), rows_i, rows_j, words,
                 out.data_ptr(), stream)
    if err != 0:
        what = f"driver error {-err} (a TMA tensor map)" if err < 0 else f"CUDA error {err}"
        raise RuntimeError(f"tc_bitgemm launch failed: {what}")
    bitgemm_cuda.launches += 1
    # An AND, a popcount and an add for each word of each (i, j) pair.
    report_cost(3.0 * rows_i * rows_j * words, 4 * words * (rows_i + rows_j) + 4 * rows_i * rows_j)
    return out


bitgemm_cuda.launches = 0
bitgemm_cuda.padded_copies = 0
