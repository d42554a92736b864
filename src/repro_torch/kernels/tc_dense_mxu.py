"""Masked dense A @ A triangle count: ``sum_{i,j} A[i,j] * (A @ A)[i,j]``.

Port of ``src/repro/kernels/tc_dense_mxu.py`` (``dense_mxu_tc_pallas``):
the honest accelerator comparison point the paper rejects for MRAM (integer
multiply), here on the H100's tensor cores. With A the upper-triangular
{0,1} adjacency every triangle counts once. It carries the ``mxu`` backend
of ``tcim_count``.

  * ``dense_mxu_tc_cuda`` — the wrapper of the hand-written CUDA kernel
    ``csrc/tc_dense_mxu.cu`` (its header gives the design and bound). It
    adds the count into a caller-owned int64 one-element ``out``, launches on
    the current stream, and counts its launches in
    ``dense_mxu_tc_cuda.launches``. Its one scratch allocation is ``A^T``,
    so that both MMA operands are K-contiguous.
  * ``dense_mxu_tc_reference`` — the plain torch version: float64 row-block
    products (exact: every partial sum is an integer below 2^53), summed in
    int64. It runs on any device and is the CPU path.

The reference casts to bf16 and sums in f32, so it is exact only below
2^24; the port takes int8 (half the bytes, {0,1} exact) and int64 sums.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["dense_mxu_tc_cuda", "dense_mxu_tc_reference"]

_PLAIN_BLOCK = 4096  # rows of A @ A the plain version holds at once


def dense_mxu_tc_reference(a: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``[N, N]`` {0,1} -> 0-d int64 count."""
    af = a.to(torch.float64)
    total = torch.zeros((), dtype=torch.int64, device=a.device)
    for start in range(0, a.shape[0], _PLAIN_BLOCK):
        rows = af[start : start + _PLAIN_BLOCK]
        total += ((rows @ af) * rows).sum().to(torch.int64)
    return total


def _kernel():
    from repro_torch.kernels._build import load_library

    fn = load_library("tc_dense_mxu").tc_dense_mxu
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, ctypes.c_int, vp, vp]
        fn.restype = ctypes.c_int
    return fn


def dense_mxu_tc_cuda(a: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``out += sum(a * (a @ a))`` in place.

    ``a`` a contiguous square int8 CUDA tensor of {0,1}, ``out`` a
    one-element int64 tensor on the same card. Returns ``out``.
    """
    for name, t, dtype in (("a", a, torch.int8), ("out", out, torch.int64)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if a.device != out.device:
        raise ValueError(f"a is on {a.device}, out on {out.device}")
    if a.dim() != 2 or a.shape[0] != a.shape[1] or not a.is_contiguous():
        raise ValueError(f"a must be a contiguous square matrix, got {tuple(a.shape)}")
    if out.numel() != 1:
        raise ValueError(f"out must hold one element, got {tuple(out.shape)}")
    n = a.shape[0]
    if n == 0:
        return out
    at = a.t().contiguous()
    fn = _kernel()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(a.data_ptr(), at.data_ptr(), n, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"tc_dense_mxu launch failed: CUDA error {err}")
    dense_mxu_tc_cuda.launches += 1
    return out


dense_mxu_tc_cuda.launches = 0
