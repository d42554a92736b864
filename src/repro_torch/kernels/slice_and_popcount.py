"""AND + BitCount over pre-gathered slice-pair words: the unfused kernels.

Port of ``src/repro/kernels/slice_and_popcount.py`` (``items_pallas``,
``total_pallas``). Both consume operands that a torch ``index_select``
gathered before the call, as the reference's XLA gather does; they serve the
executor's unfused modes ``gather_then_kernel`` (total) and ``pallas_items``
(items), the comparison baselines of the fused gather kernel.

  * ``total_cuda`` / ``items_cuda`` — wrappers of the hand-written CUDA
    kernels in ``csrc/slice_and_popcount.cu`` (its header gives the design
    and bound). ``total_cuda`` adds the total into a caller-owned int32
    one-element ``out`` (the executor passes its carried accumulator's
    first word); ``items_cuda`` writes a caller-owned int32 ``[P]``. Both
    launch on the current stream, allocate nothing, and count their
    launches in ``.launches``.
  * ``total_reference`` / ``items_reference`` — the plain torch versions
    with the same contracts, using the SWAR popcount of
    ``kernels/common.py``. They are the CPU path.

The reference's ``(T, lanes)`` zero-padded layout of the total's input is a
TPU tiling; the port reads the flat ``[P, W]`` words as they are.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import report_cost, swar_popcount_u32

__all__ = ["items_cuda", "items_reference", "total_cuda", "total_reference"]

_WORDS = (1, 2, 4)


def total_reference(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain version of the total kernel: ``[P, W]`` x ``[P, W]`` int32
    words -> 0-d int32 total popcount(AND)."""
    return swar_popcount_u32(rows & cols).sum(dtype=torch.int64).to(torch.int32)


def items_reference(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain version of the items kernel: ``[P, W]`` x ``[P, W]`` int32
    words -> ``[P]`` int32 per-pair popcount(AND)."""
    return swar_popcount_u32(rows & cols).sum(dim=1, dtype=torch.int32)


def _check(rows: torch.Tensor, cols: torch.Tensor, out: torch.Tensor) -> int:
    """Validate the kernels' operands; returns W."""
    for name, t in {"rows": rows, "cols": cols, "out": out}.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != out.device:
            raise ValueError(f"{name} is on {t.device}, out on {out.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rows.dim() != 2 or rows.shape != cols.shape:
        raise ValueError(f"operand shapes {tuple(rows.shape)} and {tuple(cols.shape)} differ")
    w = rows.shape[1]
    if w not in _WORDS:
        raise ValueError(f"operand width {w} must be one of {_WORDS}")
    return w


def _kernel(name: str):
    from repro_torch.kernels._build import load_library

    fn = getattr(load_library("slice_and_popcount"), name)
    if fn.argtypes is None:
        vp, i64 = ctypes.c_void_p, ctypes.c_longlong
        if name == "tc_total":
            fn.argtypes = [vp, vp, i64, vp, vp]
        else:
            fn.argtypes = [vp, vp, i64, ctypes.c_int, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, out: torch.Tensor, *args) -> None:
    fn = _kernel(name)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(*args, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def total_cuda(rows: torch.Tensor, cols: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Launch the total kernel: ``out += popcount(rows & cols).sum()`` in
    place, ``out`` a one-element int32 tensor. Returns ``out``."""
    _check(rows, cols, out)
    if out.numel() != 1:
        raise ValueError(f"out must hold one element, got {tuple(out.shape)}")
    if rows.numel() == 0:
        return out
    _launch("tc_total", out, rows.data_ptr(), cols.data_ptr(), rows.numel())
    total_cuda.launches += 1
    # An AND, a popcount and an add a word; both operands read, one int32 out.
    report_cost(3.0 * rows.numel(), 8 * rows.numel() + 4)
    return out


total_cuda.launches = 0


def items_cuda(rows: torch.Tensor, cols: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Launch the items kernel: ``out[p] = popcount(rows[p] & cols[p])``,
    ``out`` an int32 ``[P]``. Returns ``out``."""
    w = _check(rows, cols, out)
    if tuple(out.shape) != (rows.shape[0],):
        raise ValueError(f"out must have shape ({rows.shape[0]},), got {tuple(out.shape)}")
    for name, t in (("rows", rows), ("cols", cols)):
        if t.data_ptr() % (4 * w):
            raise ValueError(f"{name} is not aligned to its {4 * w}-byte rows")
    if rows.shape[0] == 0:
        return out
    _launch("tc_items", out, rows.data_ptr(), cols.data_ptr(), rows.shape[0], w)
    items_cuda.launches += 1
    report_cost(3.0 * rows.numel(), 8 * rows.numel() + 4 * rows.shape[0])
    return out


items_cuda.launches = 0
