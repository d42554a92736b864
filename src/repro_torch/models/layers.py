"""Transformer primitives: RMSNorm, RoPE, GQA attention, SwiGLU.

Port of the dense/GQA subset of ``src/repro/models/layers.py``. Parameters
arrive as dicts produced from the schemas declared beside each block (see
models/params.py). Attention supports:

  * GQA with optional QKV bias (qwen-style), causal or bidirectional
  * chunked query processing with full-row softmax per chunk — the
    memory-efficient path for long prefill (peak scores = [*, chunk, S])
  * ``impl="flash"``: the CUDA flash-attention kernel on the card, its
    plain version on the CPU, for any shape (the kernel masks ragged tails,
    so there is no fallback to the plain path), on the GQA heads as they are
  * decode with an externally managed KV cache (positions passed in),
    updated in place

One device: the reference's sharding constraints have no counterpart here.
MLA (latent attention) and cross attention wait for later slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import NEG_INF, flash_attention_bshd
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef

__all__ = [
    "rmsnorm",
    "rope",
    "attention_op",
    "cache_write",
    "attn_schema",
    "attn_forward",
    "attn_decode",
    "mlp_schema",
    "mlp_forward",
    "norm_schema",
]

# ---------------------------------------------------------------- primitives


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def norm_schema(dim: int) -> ParamDef:
    return ParamDef((dim,), "ones", (None,))


def _rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [B, S, H, hd]; positions: [B, S] (absolute)."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)  # [hd/2]
    angles = positions[..., None].float() * freqs  # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------- scaled dot attn


def _sdpa(q, k, v, q_pos, k_pos, causal: bool, scale: float) -> torch.Tensor:
    """q [B, Sq, H, hd], k/v [B, Sk, K, hd], positions [B, Sq]/[B, Sk]."""
    b, sq, h, _ = q.shape
    rep = h // k.shape[2]
    if rep != 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).float() * scale
    if causal:
        mask = q_pos[:, None, :, None] >= k_pos[:, None, None, :]  # [B,1,Sq,Sk]
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqs,bshv->bqhv", w, v)
    return out.reshape(b, sq, h, v.shape[-1])


def _sdpa_chunked(q, k, v, q_pos, k_pos, causal: bool, scale: float, chunk: int):
    """Query chunks one after another — peak scores [B, H, chunk, Sk]."""
    assert q.shape[1] % chunk == 0, (q.shape[1], chunk)
    return torch.cat(
        [
            _sdpa(q[:, c : c + chunk], k, v, q_pos[:, c : c + chunk], k_pos, causal, scale)
            for c in range(0, q.shape[1], chunk)
        ],
        dim=1,
    )


def attention_op(q, k, v, q_pos, k_pos, causal, chunk_threshold=8192, chunk=1024,
                 impl="xla"):
    if impl == "flash":
        return _flash(q, k, v, q_pos, k_pos, causal)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.shape[1] > chunk_threshold and q.shape[1] % chunk == 0:
        return _sdpa_chunked(q, k, v, q_pos, k_pos, causal, scale, chunk)
    return _sdpa(q, k, v, q_pos, k_pos, causal, scale)


def _flash(q, k, v, q_pos, k_pos, causal):
    """The flash-attention path for any Sq, Sk: ``[B, S, H, hd]`` queries
    against ``[B, S, KH, hd]`` keys and values and ``[B, S]`` positions, as
    the projections and RoPE hand them over (no repeated KV heads, no
    transposes or copies); returns ``[B, Sq, H, hd]``.

    The reference returns None when the shapes do not tile by its blocks and
    its caller falls back to XLA attention; the kernel masks ragged tails,
    so this never falls back.
    """
    return flash_attention_bshd(q, k, v, q_pos.to(torch.int32), k_pos.to(torch.int32),
                                causal=causal)


def cache_write(cache: torch.Tensor, new: torch.Tensor, pos: int) -> torch.Tensor:
    """Write ``new`` [B, 1, ...] into ``cache`` [B, S, ...] at seq index ``pos``.

    In place (a copy into the ``pos`` slice), where the reference builds a
    new array by a broadcast select; the contents are the same. Returns
    ``cache``.
    """
    cache.narrow(1, pos, 1).copy_(new.to(cache.dtype))
    return cache


# ------------------------------------------------------------------ GQA attn


def attn_schema(cfg: ModelConfig) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = {
        "wq": ParamDef((d, h * hd), "normal", ("fsdp", "tp")),
        "wk": ParamDef((d, k * hd), "normal", ("fsdp", "tp")),
        "wv": ParamDef((d, k * hd), "normal", ("fsdp", "tp")),
        "wo": ParamDef((h * hd, d), "scaled", ("tp", "fsdp")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamDef((h * hd,), "zeros", ("tp",))
        s["bk"] = ParamDef((k * hd,), "zeros", ("tp",))
        s["bv"] = ParamDef((k * hd,), "zeros", ("tp",))
    return s


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    h, k, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    kk = x @ p["wk"]
    vv = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        kk = kk + p["bk"]
        vv = vv + p["bv"]
    return q.reshape(b, s, h, hd), kk.reshape(b, s, k, hd), vv.reshape(b, s, k, hd)


def attn_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, *,
                 causal: bool | None = None):
    """Full-sequence self attention (train / prefill). Returns (out, (k, v))."""
    q, k, v = _project_qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    is_causal = cfg.causal if causal is None else causal
    out = attention_op(
        q, k, v, positions, positions, is_causal,
        chunk_threshold=cfg.long_context_threshold, chunk=cfg.attn_chunk,
        impl=cfg.attention_impl,
    )
    return out.reshape(*x.shape[:2], -1) @ p["wo"], (k, v)


def attn_decode(p: dict, x: torch.Tensor, pos: int, k_cache: torch.Tensor,
                v_cache: torch.Tensor, cfg: ModelConfig):
    """Single-token decode against a KV cache ``[B, Smax, K, hd]``, written
    in place at ``pos``. Returns (out, k_cache, v_cache)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    cache_write(k_cache, k, pos)
    cache_write(v_cache, v, pos)
    smax, kheads = k_cache.shape[1], k_cache.shape[2]
    rep = q.shape[2] // kheads
    kk = k_cache.to(q.dtype)
    vv = v_cache.to(q.dtype)
    # Grouped-query einsum directly against the cache: no repeated KV.
    qg = q.reshape(b, 1, kheads, rep, q.shape[-1])
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, kk).float()
    scores = scores / (q.shape[-1] ** 0.5)
    valid = torch.arange(smax, device=x.device) <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskv->bqkrv", w, vv)
    return out.reshape(b, 1, -1) @ p["wo"], k_cache, v_cache


# -------------------------------------------------------------------- SwiGLU


def mlp_schema(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    return {
        "wi_gate": ParamDef((d, f), "normal", ("fsdp", "tp")),
        "wi_up": ParamDef((d, f), "normal", ("fsdp", "tp")),
        "wo": ParamDef((f, d), "scaled", ("tp", "fsdp")),
    }


def mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = x @ p["wi_gate"]
    up = x @ p["wi_up"]
    return (gate * torch.sigmoid(gate) * up) @ p["wo"]
