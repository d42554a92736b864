"""Forward flash attention (online softmax) of the LM substrate.

Port of ``src/repro/kernels/flash_attention.py`` (``flash_attention_pallas``):
queries against keys and values with int32 absolute positions, a causal
mask ``q_pos >= k_pos`` filled with ``-1e30``, scale ``1/sqrt(hd)``, f32
softmax state, ``p`` cast to ``v``'s type before the PV product, and the
output ``acc / max(l, 1e-30)`` in ``q``'s type. It carries the prefill of
``ModelConfig.attention_impl="flash"``.

Two layouts, one kernel (``csrc/flash_attention.cu``; its header gives the
design and bound: ``wgmma`` fed by TMA for bfloat16, scalar FMA for float32,
KV tiles that every pair of a q tile masks are skipped, ``hd`` in
{16, 32, 64, 80, 112, 128}; at 80 and 112 the bf16 body runs exact-width
panels (64 + 16, 64 + 32 + 16 columns) on a persistent grid):

  * ``flash_attention_bshd`` — the model's layout and the port's main entry:
    ``q [B, Sq, H, hd]``, ``k``/``v [B, Sk, KH, hd]`` (GQA: query head ``h``
    reads KV head ``h // (H // KH)``, nothing repeated), positions
    ``[B, Sq]``/``[B, Sk]``; any strides with ``hd`` contiguous. Returns
    ``[B, Sq, H, hd]``. ``flash_attention_bshd_cuda`` is its kernel wrapper,
    ``flash_attention_bshd_reference`` its plain version.
  * ``flash_attention`` — the reference's entry point and signature:
    ``[BH, Sq, hd]`` against ``[BH, Sk, hd]`` with positions ``[BH, S]``;
    on the card the same kernel with B = BH and H = KH = 1
    (``flash_attention_cuda``), ``flash_attention_reference`` on the CPU.

Each entry takes the plain version for CPU tensors and the kernel for CUDA
tensors (no fallback). ``flash_attention_cuda.launches`` counts the
kernel's launches from either entry. Each launch reports its cost
(``flash_launch_cost``) to an active cost counter through
``kernels.common.report_cost``; on meta tensors (a counted step, nothing
computed) an entry reports the launch it stands for and returns an empty
meta output. The launch path is lean: shapes checked once a call, strides
by arithmetic on the shape, the cost computed only under a counter, the
card's current stream read raw and the device switched in C only when it
is not the current one. ``flash_tiles_scored`` is the plain
statement of the kernel's skip rule: the number of KV tiles it scores.

The reference needs ``Sq`` and ``Sk`` to tile by its blocks and its caller
falls back to XLA attention otherwise; the kernel masks ragged tails
itself, so ``block_q``/``block_k`` are accepted for signature parity only.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from repro_torch.kernels.common import COST_SINKS, report_cost

__all__ = [
    "NEG_INF",
    "FLASH_HEAD_DIMS",
    "FLASH_TILES",
    "flash_attention",
    "flash_attention_bshd",
    "flash_attention_bshd_cuda",
    "flash_attention_bshd_reference",
    "flash_attention_cuda",
    "flash_attention_reference",
    "flash_io_bytes",
    "flash_launch_cost",
    "flash_tile_visible",
    "flash_tiles_scored",
]

NEG_INF = -1e30
FLASH_HEAD_DIMS = (16, 32, 64, 80, 112, 128)  # the kernel's templates
FLASH_TILES = {torch.bfloat16: (128, 128), torch.float32: (64, 64)}  # (q rows, keys) a tile
_GRID_LIMIT = 65535  # gridDim.y (heads) and gridDim.z (batch)
_PLAIN_SCORES = 1 << 28  # score elements the plain version holds at once
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1
_PACK_STRIDES = struct.Struct("16q").pack  # the launch's 16 element strides, as C reads them


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


def flash_attention_bshd_reference(q, k, v, q_pos, k_pos, *, causal: bool = True) -> torch.Tensor:
    """Plain version in the model's layout: each query head against its KV
    head (repeated here, as the kernel never does), through
    ``flash_attention_reference``. Returns ``[B, Sq, H, hd]``."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    rep = h // kh
    k, v = (torch.repeat_interleave(t, rep, dim=2) if rep != 1 else t for t in (k, v))
    out = flash_attention_reference(
        q.transpose(1, 2).reshape(b * h, sq, hd),
        k.transpose(1, 2).reshape(b * h, sk, hd),
        v.transpose(1, 2).reshape(b * h, sk, v.shape[-1]),
        q_pos[:, None, :].expand(b, h, sq).reshape(b * h, sq),
        k_pos[:, None, :].expand(b, h, sk).reshape(b * h, sk),
        causal=causal,
    )
    return out.reshape(b, h, sq, -1).transpose(1, 2)


def flash_tile_visible(q_pos, k_pos, block_q: int, block_k: int) -> torch.Tensor:
    """The kernel's skip rule: ``[B, q tiles, KV tiles]`` bool, True where a
    KV tile is scored, i.e. ``min(k_pos over the tile) <= max(q_pos over the
    q tile)`` (ragged tails count only their real rows and keys)."""
    b, sq = q_pos.shape
    sk = k_pos.shape[1]
    nq, nk = -(-sq // block_q), -(-sk // block_k)
    qp = torch.full((b, nq * block_q), _INT32_MIN, dtype=torch.int64, device=q_pos.device)
    kp = torch.full((b, nk * block_k), _INT32_MAX, dtype=torch.int64, device=k_pos.device)
    qp[:, :sq] = q_pos
    kp[:, :sk] = k_pos
    qmax = qp.view(b, nq, block_q).amax(dim=2)
    kmin = kp.view(b, nk, block_k).amin(dim=2)
    return kmin[:, None, :] <= qmax[:, :, None]


def flash_tiles_scored(q_pos, k_pos, heads: int, block_q: int, block_k: int, *,
                       causal: bool = True) -> int:
    """Plain count of the KV tiles the kernel scores over all heads: the
    visible tiles of ``flash_tile_visible`` (every tile when not causal),
    plus every tile again for a q tile holding a row that sees no key (the
    kernel's rescan)."""
    b, sq = q_pos.shape
    sk = k_pos.shape[1]
    nq, nk = -(-sq // block_q), -(-sk // block_k)
    if sq == 0 or sk == 0:
        return 0
    if not causal:
        return b * heads * nq * nk
    scored = flash_tile_visible(q_pos, k_pos, block_q, block_k).sum(dim=2)  # [B, nq]
    blind = q_pos.long() < k_pos.long().amin(dim=1, keepdim=True)  # rows with no visible key
    pad = torch.zeros(b, nq * block_q, dtype=torch.bool, device=q_pos.device)
    pad[:, :sq] = blind
    rescans = pad.view(b, nq, block_q).any(dim=2)
    return int(heads * (scored + nk * rescans.long()).sum())


def _kernel():
    from repro_torch.kernels._build import load_library

    fn = load_library("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_char_p, ci, ci, ci, ci, ci, ci, ci, ci,
                       ctypes.c_float, vp, ci, vp]
        fn.restype = ctypes.c_int
    return fn


def _check_types(hd, q, k, v, q_pos, k_pos) -> None:
    if hd not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported by the kernel; it takes {FLASH_HEAD_DIMS}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be bfloat16 or all float32; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError(f"positions must be int32; got {q_pos.dtype}, {k_pos.dtype}")


def _check_devices(**tensors) -> None:
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, q on {first.device}")


def _check_operands(q, k, v, q_pos, k_pos) -> None:
    """Raise on what the ``[BH, S, hd]`` entry does not take; the device is
    checked last, so every other check runs on CPU tensors too."""
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
    _check_types(hd, q, k, v, q_pos, k_pos)
    if bh > _GRID_LIMIT:
        raise ValueError(f"BH = {bh} exceeds the kernel's grid limit of {_GRID_LIMIT}")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("k_pos", k_pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_devices(q=q, k=k, v=v, q_pos=q_pos, k_pos=k_pos)


def _dense_strides(shape) -> list[int]:
    """The contiguous layout's element strides of ``shape``, as torch gives
    them (a size-0 dimension counts as 1)."""
    strides, step = [], 1
    for size in reversed(shape):
        strides.append(step)
        step *= max(size, 1)
    return strides[::-1]


def _strides(t: torch.Tensor, dims: tuple[int, ...]) -> list[int]:
    """Element strides of ``t`` along ``dims``; a dimension of size 1 gets the
    stride of the contiguous layout (any value addresses it, and TMA wants a
    16-byte multiple)."""
    shape, stride = t.shape, t.stride()
    if 1 not in shape:
        return [stride[d] for d in dims]
    dense = _dense_strides(shape)
    return [stride[d] if shape[d] != 1 else dense[d] for d in dims]


def _check_bshd_shapes(q, k, v, q_pos, k_pos) -> None:
    """Raise on shapes and types the kernel does not take in the
    ``[B, S, H, hd]`` layout: ``flash_attention_bshd`` checks these on both
    devices, so the CPU path refuses what the card would (an MLA value
    width, a head dim outside ``FLASH_HEAD_DIMS``)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, S, heads, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    kv = k.shape
    sk, kh = kv[1], kv[2]
    if v.shape[3] != hd:
        raise ValueError(f"the kernel takes equal query, key and value head dims; got "
                         f"q/k {hd}, v {v.shape[-1]}")
    if kv != (b, sk, kh, hd) or v.shape != kv:
        raise ValueError(f"k and v must be [{b}, Sk, KH, {hd}]; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if kh == 0 or h % kh:
        raise ValueError(f"query heads {h} must be a multiple of the KV heads {kh}")
    if q_pos.shape != (b, sq) or k_pos.shape != (b, sk):
        raise ValueError(f"positions must be [{b}, {sq}] and [{b}, {sk}]; got "
                         f"{tuple(q_pos.shape)}, {tuple(k_pos.shape)}")
    _check_types(hd, q, k, v, q_pos, k_pos)


def _check_bshd(q, k, v, q_pos, k_pos) -> list[int]:
    """Raise on what the ``[B, S, H, hd]`` entry does not take beyond the
    shapes and types of ``_check_bshd_shapes`` (grid limits, layout,
    alignment, devices; the device last, so every other check runs on CPU
    tensors too). Returns the element strides (batch, row, head) of q, k
    and v, the launch's first nine."""
    b, _, h, hd = q.shape
    if b > _GRID_LIMIT or h > _GRID_LIMIT:
        raise ValueError(f"batch {b} and heads {h} must each be at most {_GRID_LIMIT} "
                         "(the kernel's grid)")
    vec = 16 // q.element_size()
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        st = _strides(t, (0, 1, 2, 3))
        if st[3] != 1 and hd != 1:
            raise ValueError(f"{name} must have a contiguous head dim (stride 1)")
        if t.data_ptr() % 16 or st[0] % vec or st[1] % vec or st[2] % vec:
            raise ValueError(f"{name} must be 16-byte aligned, its base and strides "
                             "(the kernel's TMA and vector loads)")
        strides += st[:3]
    device = q.device
    if not (q.is_cuda and k.device == device and v.device == device
            and q_pos.device == device and k_pos.device == device):
        _check_devices(q=q, k=k, v=v, q_pos=q_pos, k_pos=k_pos)  # raises, naming the fault
    return strides


def _launch(q, k, v, q_pos, k_pos, causal: bool, tiles, qkv_strides: list[int]) -> torch.Tensor:
    """Launch the kernel on checked ``[B, S, H, hd]`` operands whose element
    strides (batch, row, head) of q, k and v are ``qkv_strides``."""
    b, sq, h, hd = q.shape
    _, sk, kh, _ = k.shape
    device = q.device
    out = torch.empty(b, sq, h, hd, dtype=q.dtype, device=device)
    if tiles is not None and (not tiles.is_cuda or tiles.dtype != torch.int64
                              or tiles.numel() != 1 or tiles.device != device):
        raise ValueError("tiles must be a one-element int64 tensor on q's card")
    if out.numel() == 0:
        return out
    if sk == 0:
        return out.zero_()  # no key: acc = 0, as the reference's empty scan
    row = h * hd  # out is contiguous with no size-0 dimension: its strides are these
    strides = _PACK_STRIDES(*qkv_strides, sq * row, row, hd, *_strides(q_pos, (0, 1)),
                            *_strides(k_pos, (0, 1)))
    index = device.index
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
                    out.data_ptr(), strides, b, sq, sk, h, kh, hd, q.dtype == torch.bfloat16,
                    causal, 1.0 / (hd ** 0.5), None if tiles is None else tiles.data_ptr(),
                    index, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        what = f"driver error {-err} (a TMA tensor map)" if err < 0 else f"CUDA error {err}"
        raise RuntimeError(f"flash_attention launch failed: {what}")
    flash_attention_cuda.launches += 1
    _report(q, k, causal)
    return out


def _report(q, k, causal: bool) -> None:
    """Report a launch on ``[B, S, H, hd]`` operands to a cost counter; costs
    one test when none is active."""
    if COST_SINKS:
        b, sq, h, hd = q.shape
        report_cost(*flash_launch_cost(b, h, k.shape[2], sq, k.shape[1], hd, q.element_size(),
                                       causal), matmul=True)


def _meta_launch(q, k, causal: bool) -> torch.Tensor:
    """The stand-in for a launch on meta ``[B, S, H, hd]`` operands."""
    _report(q, k, causal)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def flash_attention_bshd_cuda(q, k, v, q_pos, k_pos, *, causal: bool = True,
                              tiles: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on ``[B, S, H, hd]`` CUDA operands; returns
    ``[B, Sq, H, hd]`` in ``q``'s type. ``tiles`` (one int64 on the card), if
    given, gains the KV tiles scored. Raises on operands it does not take or
    a failed launch."""
    _check_bshd_shapes(q, k, v, q_pos, k_pos)
    return _launch(q, k, v, q_pos, k_pos, causal, tiles, _check_bshd(q, k, v, q_pos, k_pos))


def flash_attention_cuda(q, k, v, q_pos, k_pos, *, causal: bool = True,
                         tiles: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on contiguous ``[BH, S, hd]`` CUDA operands (B = BH,
    H = KH = 1); returns ``[BH, Sq, hd]`` in ``q``'s type. Raises on operands
    it does not take or a failed launch."""
    _check_operands(q, k, v, q_pos, k_pos)
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("q, k and v must be 16-byte aligned (the kernel's TMA and vector loads)")
    sq, sk, hd = q.shape[1], k.shape[1], q.shape[2]
    out = _launch(q[:, :, None], k[:, :, None], v[:, :, None], q_pos, k_pos, causal, tiles,
                  [sq * hd, hd, hd, sk * hd, hd, hd, sk * hd, hd, hd])
    return out[:, :, 0]


flash_attention_cuda.launches = 0


def _refuse_autograd(q, k, v) -> None:
    """Raise where autograd would record the call: the kernel writes its
    output through a raw pointer, so on the card the gradient would vanish
    without an error, and the reference's kernel has no backward either."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention has no backward (nor has the reference's "
            "flash_attention_pallas): train with attention_impl='xla', or call "
            "it under torch.no_grad() or on operands that do not require grad")


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool = True, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """The reference's entry point (``[BH, S, hd]``): the kernel on the card,
    the plain version on the CPU. ``block_q``/``block_k`` are accepted for
    parity; the kernel's tiles are its own. Raises ``NotImplementedError``
    under autograd (``_refuse_autograd``), on both devices."""
    del block_q, block_k
    _refuse_autograd(q, k, v)
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, q_pos, k_pos, causal=causal)
    if q.is_meta:
        return _meta_launch(q[:, :, None], k[:, :, None], causal)[:, :, 0]
    return flash_attention_reference(q, k, v, q_pos, k_pos, causal=causal)


def flash_attention_bshd(q, k, v, q_pos, k_pos, *, causal: bool = True) -> torch.Tensor:
    """The model's entry point (``[B, S, H, hd]``, GQA KV heads as they
    are): the kernel on the card, the plain version on the CPU. On both
    devices it raises ``ValueError`` on shapes the kernel lacks (a head dim
    outside ``FLASH_HEAD_DIMS``, a value width other than the query's) and
    ``NotImplementedError`` under autograd (``_refuse_autograd``)."""
    _check_bshd_shapes(q, k, v, q_pos, k_pos)
    _refuse_autograd(q, k, v)
    if q.is_cuda:  # the shapes are checked: the rest of flash_attention_bshd_cuda's checks
        return _launch(q, k, v, q_pos, k_pos, causal, None, _check_bshd(q, k, v, q_pos, k_pos))
    if q.is_meta:
        return _meta_launch(q, k, causal)
    return flash_attention_bshd_reference(q, k, v, q_pos, k_pos, causal=causal)


def flash_io_bytes(b, h, sq, sk, hd, vd=None, dtype_bytes=2, train=True) -> int:
    """Analytic device-memory traffic of the fused kernel: Q+K+V read, O
    written; x3 for training (fwd + bwd reading QKV/O + dO, writing dQKV)."""
    vd = hd if vd is None else vd
    fwd = b * h * (sq * hd + sk * hd + sk * vd + sq * vd) * dtype_bytes
    return int(fwd * (3 if train else 1))


def flash_launch_cost(b, h, kh, sq, sk, hd, dtype_bytes=2, causal=True) -> tuple[float, int]:
    """(FLOPs, bytes) of one launch: 4 B H Sq Sk hd for the two products,
    halved where causal, and ``flash_io_bytes`` with Q and O at the ``h``
    query heads, K and V at the ``kh`` KV heads (GQA reads them once)."""
    flops = 4.0 * b * h * sq * sk * hd / (2 if causal else 1)
    nbytes = (flash_io_bytes(b, h, sq, 0, hd, dtype_bytes=dtype_bytes, train=False)
              + flash_io_bytes(b, kh, 0, sk, hd, dtype_bytes=dtype_bytes, train=False))
    return flops, nbytes
