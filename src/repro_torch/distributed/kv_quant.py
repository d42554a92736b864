"""int8 KV-cache quantization (serving memory optimization).

Port of ``src/repro/distributed/kv_quant.py``. int8 halves a bf16 KV cache
(and the cache reads of a decode step, which is bound by them);
per-(position, head) symmetric scales keep the attention error at the
~1e-2 level (``tests/test_torch_kv_quant.py`` holds the reference's
bounds).

API mirrors a cache leaf: quantize ``[B, S, K, hd]`` -> (int8 values, f32
scales ``[B, S, K, 1]``); attention dequantizes. As in the reference, the
cache does not use it yet (a config-level follow-up). Rounding is
half-to-even, as ``jnp.round``'s, so float32 inputs give the reference's
values bit for bit.
"""
from __future__ import annotations

import torch

__all__ = ["kv_quantize", "kv_dequantize", "kv_cache_bytes"]


def kv_quantize(kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 [..., hd], f32 scale [..., 1]); symmetric per-row."""
    f = kv.float()
    amax = f.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    # A tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which can differ from the reference's quotient in the last bit.
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.round(f / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def kv_cache_bytes(b: int, s: int, kv_heads: int, hd: int, layers: int,
                   quantized: bool) -> int:
    """Per-cache-side byte footprint (x2 for K and V)."""
    per_tok = kv_heads * (hd * (1 if quantized else 2) + (4 if quantized else 0))
    return b * s * per_tok * layers
