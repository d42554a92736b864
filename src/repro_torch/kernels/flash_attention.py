"""Forward flash attention (online softmax) of the LM substrate.

Port of ``src/repro/kernels/flash_attention.py`` (``flash_attention_pallas``):
``[BH, Sq, hd]`` queries against ``[BH, Sk, hd]`` keys and values with
int32 absolute positions ``[BH, Sq]`` / ``[BH, Sk]``, a causal mask
``q_pos >= k_pos`` filled with ``-1e30``, scale ``1/sqrt(hd)``, f32
softmax state, ``p`` cast to ``v``'s type before the PV product, and the
output ``acc / max(l, 1e-30)`` in ``q``'s type. It carries the prefill of
``ModelConfig.attention_impl="flash"``.

  * ``flash_attention_cuda`` — the wrapper of the hand-written CUDA kernel
    ``csrc/flash_attention.cu`` (its header gives the design and bound):
    ``mma.sync`` bf16 tiles for bfloat16, scalar FMA for float32, ``hd`` in
    {16, 32, 64, 128}. It allocates the output, launches on the current
    stream and counts its launches in ``flash_attention_cuda.launches``.
  * ``flash_attention_reference`` — the plain torch version: the direct
    softmax formula in f32 with the same mask, ``p`` cast to ``v``'s type.
    It runs on any device and is the CPU path.
  * ``flash_attention`` — the reference's entry point: the plain version
    for CPU tensors, the kernel for CUDA tensors (no fallback).

The reference needs ``Sq`` and ``Sk`` to tile by its blocks and its caller
falls back to XLA attention otherwise; the kernel masks ragged tails
itself, so ``block_q``/``block_k`` are accepted for signature parity only.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = [
    "NEG_INF",
    "FLASH_HEAD_DIMS",
    "flash_attention",
    "flash_attention_cuda",
    "flash_attention_reference",
    "flash_io_bytes",
]

NEG_INF = -1e30
FLASH_HEAD_DIMS = (16, 32, 64, 128)  # the kernel's templates
_PLAIN_SCORES = 1 << 28  # score elements the plain version holds at once


def flash_attention_reference(q, k, v, q_pos, k_pos, *, causal: bool = True) -> torch.Tensor:
    """Plain version of the kernel: ``softmax(q k^T * scale) v`` row by row.

    Scores are f32; masked keys get ``-1e30``; the weights are cast to
    ``v``'s type before the product. Blocks of (bh, query rows) keep at
    most ``2**28`` scores alive, so long sequences fit on the card.
    """
    bh, sq, hd = q.shape
    sk = k.shape[1]
    scale = 1.0 / (hd ** 0.5)
    out = torch.empty(bh, sq, v.shape[-1], dtype=q.dtype, device=q.device)
    rows = max(1, min(sq, _PLAIN_SCORES // max(sk, 1)))
    heads = max(1, min(bh, _PLAIN_SCORES // max(rows * sk, 1)))
    kf, vf = k.float(), v.float()
    for h0 in range(0, bh, heads):
        hs = slice(h0, h0 + heads)
        for r0 in range(0, sq, rows):
            rs = slice(r0, r0 + rows)
            s = torch.matmul(q[hs, rs].float(), kf[hs].transpose(1, 2)) * scale
            if causal:
                s = s.masked_fill(q_pos[hs, rs, None] < k_pos[hs, None, :], NEG_INF)
            p = torch.softmax(s, dim=-1).to(v.dtype)
            out[hs, rs] = torch.matmul(p.float(), vf[hs]).to(q.dtype)
    return out


def _kernel():
    from repro_torch.kernels._build import load_library

    fn = load_library("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def _check_operands(q, k, v, q_pos, k_pos) -> None:
    """Raise on what the kernel does not take; the device is checked last,
    so every other check runs on CPU tensors too."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be [BH, S, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, hd = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (bh, sk, hd) or tuple(v.shape) != (bh, sk, hd):
        raise ValueError(f"k and v must be [{bh}, Sk, {hd}]; got {tuple(k.shape)}, {tuple(v.shape)}")
    if tuple(q_pos.shape) != (bh, sq) or tuple(k_pos.shape) != (bh, sk):
        raise ValueError(f"positions must be [{bh}, {sq}] and [{bh}, {sk}]; got "
                         f"{tuple(q_pos.shape)}, {tuple(k_pos.shape)}")
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the kernel; it takes {FLASH_HEAD_DIMS}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be bfloat16 or all float32; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError(f"positions must be int32; got {q_pos.dtype}, {k_pos.dtype}")
    if bh > 65535:
        raise ValueError(f"BH = {bh} exceeds the kernel's grid limit of 65535")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("k_pos", k_pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 and name in ("q", "k", "v"):
            raise ValueError(f"{name} must be 16-byte aligned (the kernel's vector loads)")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("k_pos", k_pos)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def flash_attention_cuda(q, k, v, q_pos, k_pos, *, causal: bool = True) -> torch.Tensor:
    """Launch the kernel on contiguous CUDA operands; returns ``[BH, Sq, hd]``
    in ``q``'s type. Raises on operands it does not take or a failed launch."""
    _check_operands(q, k, v, q_pos, k_pos)
    bh, sq, hd = q.shape
    sk = k.shape[1]
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    if sk == 0:
        return out.zero_()  # no key: acc = 0, as the reference's empty scan
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
                 out.data_ptr(), bh, sq, sk, hd, int(q.dtype == torch.bfloat16), int(causal),
                 1.0 / (hd ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """The reference's entry point: the kernel on the card, the plain
    version on the CPU. ``block_q``/``block_k`` are accepted for parity;
    the kernel's tiles are its own."""
    del block_q, block_k
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, q_pos, k_pos, causal=causal)
    return flash_attention_reference(q, k, v, q_pos, k_pos, causal=causal)


def flash_io_bytes(b, h, sq, sk, hd, vd=None, dtype_bytes=2, train=True) -> int:
    """Analytic device-memory traffic of the fused kernel: Q+K+V read, O
    written; x3 for training (fwd + bwd reading QKV/O + dO, writing dQKV)."""
    vd = hd if vd is None else vd
    fwd = b * h * (sq * hd + sk * hd + sk * vd + sq * vd) * dtype_bytes
    return int(fwd * (3 if train else 1))
