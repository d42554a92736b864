"""Transformer primitives: RMSNorm, RoPE, GQA/MLA attention, SwiGLU.

Port of ``src/repro/models/layers.py``. Parameters arrive as dicts produced
from the schemas declared beside each block (see models/params.py).
Attention supports:

  * GQA with optional QKV bias (qwen-style), causal or bidirectional
  * gated cross attention (``kv_x``: keys and values from another stream,
    llama-3.2-vision's image tokens), never causal
  * chunked query processing with full-row softmax per chunk — the
    memory-efficient path for long prefill (peak scores = [*, chunk, S])
  * ``impl="flash"``: the CUDA flash-attention kernel on the card, its
    plain version on the CPU, on the GQA heads as they are; the kernel masks
    ragged tails, so there is no fallback to the plain path, and head dims
    or value widths it lacks raise ``ValueError`` on both devices
  * decode with an externally managed KV cache (positions passed in),
    updated in place
  * MLA (latent KV) in direct form for train/prefill and *absorbed* form
    for decode (scores in latent space; no per-step KV decompression)
  * decode over a cache split on its sequence (the flash-decoding layout of
    a cache placed on a mesh): ``attn_decode_qkv`` / ``mla_decode_qkv``
    project and rope the token, ``attn_partial`` / ``mla_partial`` give one
    block's float32 ``(m, l, o)`` (running max, sum of weights, unnormalised
    values; positions past ``pos`` masked with the finite ``NEG_INF``),
    ``combine_partials`` rescales the blocks by ``exp(m_j - max m)`` and
    normalises, and ``attn_decode_out`` / ``mla_decode_out`` project out.
    MLA combines in latent space, before ``wuv``. On one block this is
    ``attn_decode`` / ``mla_decode`` up to the order of float32 sums.

The reference's sharding constraints have no counterpart here: on a mesh
the tensor-parallel schedule of the decoders is written
out in ``models/model.py`` (``prefill_placed_tp``, ``decode_placed_tp``)
over ``distributed/tensor_parallel.py``, and runs these functions on a
model shard's blocks. ``attn_qkv_block`` projects a shard's query heads and
its K/V columns (of ``kv_x`` for cross attention; a column block of wk/wv
may end inside a head), ``mlp_hidden`` takes a column block of
wi_gate/wi_up, ``matmul_f32`` gives a row block of wo's partial product in
float32 (``bmm_f32`` an expert block's combine,
``models/moe.py::expert_block``), ``combined_heads`` lays a combined decode
output out by heads for the row blocks of wo, ``cross_decode_heads`` is a
shard's cross attention at decode before its rows of wo, and ``gated``
scales a cross layer's reduced output once. MLA splits into the latent part
every head shares (``mla_latents``: ``cq``, ``ckv``, the roped ``k_rope``)
and the part of a shard's heads on its head-aligned columns of
wuq/wuk/wuv: ``mla_attend`` over the prompt, ``mla_decode_query`` (the
absorbed query) and ``mla_latent_out`` (a combined latent through wuv) at
decode, each before the shard's rows of wo. The
reference's ``jax.named_scope("attn_core")``
regions are ``cost_scope("attn_core")`` (``analysis/hlo_cost.py``),
which only names ops for an active cost counter.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.hlo_cost import cost_scope
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
    "attn_decode_qkv",
    "attn_qkv_block",
    "attn_partial",
    "combined_heads",
    "attn_decode_out",
    "combine_partials",
    "cross_decode",
    "cross_decode_heads",
    "gated",
    "mla_schema",
    "mla_latents",
    "mla_query",
    "mla_attend",
    "mla_forward",
    "mla_decode",
    "mla_decode_qkv",
    "mla_decode_query",
    "mla_partial",
    "mla_latent_out",
    "mla_decode_out",
    "mlp_schema",
    "mlp_forward",
    "mlp_hidden",
    "matmul_f32",
    "bmm_f32",
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
    with cost_scope("attn_core"):
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
    so this never falls back. A head dim outside the kernel's templates, or
    a value width other than the query's (MLA), raises ``ValueError``.
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


def attn_schema(cfg: ModelConfig, cross: bool = False) -> dict:
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
    if cross:
        # Tanh-gated cross attention (llama-3.2-vision style).
        s["gate"] = ParamDef((), "zeros", ())
    return s


def _project_q(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``[B, S, heads, hd]``: as many heads as ``wq`` has columns of ``hd``
    (all of them, or a model shard's block)."""
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    return q.reshape(*x.shape[:2], -1, cfg.resolved_head_dim)


def attn_qkv_block(p: dict, x: torch.Tensor, cfg: ModelConfig, kv_x: torch.Tensor | None = None):
    """The projections on ``p``'s columns (the whole of wq/wk/wv, or a
    model shard's column blocks, biases included): ``q [B, S, heads, hd]``
    (not roped) and the K and V columns ``[B, Sk, c]`` of ``kv_x`` (default
    ``x``), which a column block may end inside a head."""
    kv_x = x if kv_x is None else kv_x
    kk = kv_x @ p["wk"]
    vv = kv_x @ p["wv"]
    if cfg.qkv_bias:
        kk = kk + p["bk"]
        vv = vv + p["bv"]
    return _project_q(p, x, cfg), kk, vv


def _project_qkv(p: dict, x: torch.Tensor, kv_x: torch.Tensor, cfg: ModelConfig):
    b, sk, _ = kv_x.shape
    k, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    q, kk, vv = attn_qkv_block(p, x, cfg, kv_x)
    return q, kk.reshape(b, sk, k, hd), vv.reshape(b, sk, k, hd)


def gated(p: dict, out: torch.Tensor) -> torch.Tensor:
    """Cross attention's output scaled by ``tanh(gate)``, taken in float32
    (on the tensor-parallel path once, after the reduction's rounding)."""
    return torch.tanh(p["gate"].float()).to(out.dtype) * out


def attn_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, *,
                 kv_x: torch.Tensor | None = None, kv_positions: torch.Tensor | None = None,
                 causal: bool | None = None):
    """Full-sequence attention (train / prefill). Returns (out, (k, v)).

    ``kv_x`` switches to cross attention (keys and values from another
    stream, e.g. image patch embeddings): no RoPE, never causal, key
    positions zeros (``kv_positions`` is accepted as the reference's and
    not used), the output gated by ``tanh(gate)``.
    """
    del kv_positions  # cross attention's key positions are zeros, as the reference's
    cross = kv_x is not None
    q, k, v = _project_qkv(p, x, kv_x if cross else x, cfg)
    if cross:
        is_causal = False
        kv_pos = torch.zeros(kv_x.shape[:2], dtype=torch.int32, device=x.device)
    else:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        is_causal = cfg.causal if causal is None else causal
        kv_pos = positions
    out = attention_op(
        q, k, v, positions, kv_pos, is_causal,
        chunk_threshold=cfg.long_context_threshold, chunk=cfg.attn_chunk,
        impl=cfg.attention_impl,
    )
    out = out.reshape(*x.shape[:2], -1) @ p["wo"]
    return (gated(p, out) if cross else out), (k, v)


def attn_decode(p: dict, x: torch.Tensor, pos: int, k_cache: torch.Tensor,
                v_cache: torch.Tensor, cfg: ModelConfig):
    """Single-token decode against a KV cache ``[B, Smax, K, hd]``, written
    in place at ``pos``. Returns (out, k_cache, v_cache)."""
    b = x.shape[0]
    q, k, v = attn_decode_qkv(p, x, pos, cfg)
    cache_write(k_cache, k, pos)
    cache_write(v_cache, v, pos)
    smax, kheads = k_cache.shape[1], k_cache.shape[2]
    rep = q.shape[2] // kheads
    kk = k_cache.to(q.dtype)
    vv = v_cache.to(q.dtype)
    # Grouped-query einsum directly against the cache: no repeated KV.
    qg = q.reshape(b, 1, kheads, rep, q.shape[-1])
    with cost_scope("attn_core"):
        scores = torch.einsum("bqkrd,bskd->bkrqs", qg, kk).float()
        scores = scores / (q.shape[-1] ** 0.5)
        valid = torch.arange(smax, device=x.device) <= pos
        scores = scores.masked_fill(~valid, NEG_INF)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskv->bqkrv", w, vv)
    return out.reshape(b, 1, -1) @ p["wo"], k_cache, v_cache


def attn_decode_qkv(p: dict, x: torch.Tensor, pos: int, cfg: ModelConfig):
    """The token's roped ``q [B, 1, H, hd]`` and ``k``, and ``v [B, 1, K, hd]``."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, x, cfg)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _partial(scores: torch.Tensor, start: int, pos: int):
    """``(m, l, p)`` of float32 ``scores [..., 1, Sb]`` against the keys at
    positions ``start .. start + Sb - 1``, those past ``pos`` masked. A block
    wholly past ``pos`` gives ``m = NEG_INF`` (finite, so no ``inf - inf``)."""
    valid = torch.arange(start, start + scores.shape[-1], device=scores.device) <= pos
    scores = scores.masked_fill(~valid, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    w = torch.exp(scores - m)
    return m, w.sum(dim=-1, keepdim=True), w


def attn_partial(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor, start: int,
                 pos: int):
    """One cache block's float32 partial for the query ``q [B, 1, H, hd]``
    against ``k_blk``/``v_blk [B, Sb, K, hd]`` (positions ``start ..``):
    ``m``, ``l [B, K, H/K, 1, 1]`` and ``o [B, K, H/K, 1, hd]``."""
    b, _, h, hd = q.shape
    kheads = k_blk.shape[2]
    qg = q.reshape(b, 1, kheads, h // kheads, hd)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k_blk.to(q.dtype)).float() / (hd ** 0.5)
    m, l, w = _partial(scores, start, pos)
    return m, l, torch.einsum("bkrqs,bskv->bkrqv", w, v_blk.float())


def combine_partials(parts) -> torch.Tensor:
    """The normalised float32 output of blocks' ``(m, l, o)`` partials:
    ``sum_j e^(m_j - m) o_j / sum_j e^(m_j - m) l_j`` with ``m = max_j m_j``
    (a block wholly past ``pos`` weighs ``e^(NEG_INF - m) = 0``)."""
    m = parts[0][0]
    for mj, _, _ in parts[1:]:
        m = torch.maximum(m, mj)
    scales = [torch.exp(mj - m) for mj, _, _ in parts]
    den = sum(s * lj for s, (_, lj, _) in zip(scales, parts))
    num = sum(s * oj for s, (_, _, oj) in zip(scales, parts))
    return num / den


def combined_heads(o: torch.Tensor, dtype) -> torch.Tensor:
    """``combine_partials``' ``o [B, K, H/K, 1, hd]`` as ``[B, 1, H hd]`` in
    ``dtype``, head by head (query head ``k H/K + r`` at ``(k, r)``): the
    rows of ``wo`` in order."""
    return o.permute(0, 3, 1, 2, 4).reshape(o.shape[0], 1, -1).to(dtype)


def attn_decode_out(p: dict, o: torch.Tensor, dtype) -> torch.Tensor:
    """``combine_partials``' ``o [B, K, H/K, 1, hd]`` projected out: ``[B, 1, D]``."""
    return combined_heads(o, dtype) @ p["wo"]


def cross_decode_heads(p: dict, x: torch.Tensor, pos: int, xk: torch.Tensor, xv: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """One token's cross attention before ``wo``, ``[B, 1, heads hd]``: the
    query heads of ``p``'s wq columns (all, or a model shard's block)
    against the image K/V ``[B, n_img, KV, hd]`` (static during decode),
    by the plain path whatever ``cfg.attention_impl``, as the reference's
    decode step runs it."""
    b = x.shape[0]
    q = _project_q(p, x, cfg)
    kx, vx = xk.to(q.dtype), xv.to(q.dtype)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    npos = torch.zeros((b, kx.shape[1]), dtype=torch.int32, device=x.device)
    return attention_op(q, kx, vx, positions, npos, False).reshape(b, 1, -1)


def cross_decode(p: dict, x: torch.Tensor, pos: int, xk: torch.Tensor, xv: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """One token's gated cross attention against the prefilled image K/V
    ``[B, n_img, K, hd]``: ``cross_decode_heads`` through ``wo``, gated."""
    return gated(p, cross_decode_heads(p, x, pos, xk, xv, cfg) @ p["wo"])


# ------------------------------------------------------------------ MLA attn


def mla_schema(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wdq": ParamDef((d, qr), "normal", ("fsdp", None)),
        "q_norm": norm_schema(qr),
        "wuq": ParamDef((qr, h * (nope + rope_d)), "normal", (None, "tp")),
        "wdkv": ParamDef((d, kvr + rope_d), "normal", ("fsdp", None)),
        "kv_norm": norm_schema(kvr),
        "wuk": ParamDef((kvr, h * nope), "normal", (None, "tp")),
        "wuv": ParamDef((kvr, h * vd), "normal", (None, "tp")),
        "wo": ParamDef((h * vd, d), "scaled", ("tp", "fsdp")),
    }


def mla_latents(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """The part every head shares: the normalised query latent ``cq [B, S,
    q_rank]``, the latent ``ckv [B, S, kv_rank]`` and the roped ``k_rope
    [B, S, rope_d]``."""
    kvr = cfg.kv_lora_rank
    cq = rmsnorm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    dkv = x @ p["wdkv"]
    ckv = rmsnorm(dkv[..., :kvr], p["kv_norm"], cfg.norm_eps)
    k_rope = rope(dkv[..., kvr:][:, :, None, :], positions, cfg.rope_theta)
    return cq, ckv, k_rope[:, :, 0, :]


def mla_query(p: dict, cq: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """``q_nope`` and the roped ``q_rope`` of as many heads as ``wuq`` has
    columns of ``nope + rope`` (all of them, or a model shard's heads)."""
    b, s, _ = cq.shape
    nope = cfg.qk_nope_dim
    q = (cq @ p["wuq"]).reshape(b, s, -1, nope + cfg.qk_rope_dim)
    return q[..., :nope], rope(q[..., nope:], positions, cfg.rope_theta)


def mla_attend(p: dict, cq: torch.Tensor, ckv: torch.Tensor, k_rope: torch.Tensor,
               positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Direct-form attention of the heads of ``p``'s wuq/wuk/wuv columns
    (all of them, or a model shard's) over the latents, before ``wo``:
    ``[B, S, heads vd]``.

    Queries and keys are ``nope + rope`` wide, values ``v_head_dim``: the
    flash kernel takes equal widths only, so ``attention_impl="flash"``
    raises here (the reference's flash path would fail too, on its output
    reshape)."""
    b, s, _ = cq.shape
    nope, vd = cfg.qk_nope_dim, cfg.v_head_dim
    q_nope, q_rope = mla_query(p, cq, positions, cfg)
    h = q_nope.shape[2]
    k_nope = (ckv @ p["wuk"]).reshape(b, s, h, nope)
    v = (ckv @ p["wuv"]).reshape(b, s, h, vd)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, cfg.qk_rope_dim)], dim=-1)
    out = attention_op(
        q, k, v, positions, positions, cfg.causal,
        chunk_threshold=cfg.long_context_threshold, chunk=cfg.attn_chunk,
        impl=cfg.attention_impl,
    )
    return out.reshape(b, s, -1)


def mla_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """Direct-form MLA for train/prefill (``mla_attend`` of every head).
    Returns (out, (ckv, k_rope))."""
    cq, ckv, k_rope = mla_latents(p, x, positions, cfg)
    return mla_attend(p, cq, ckv, k_rope, positions, cfg) @ p["wo"], (ckv, k_rope)


def mla_decode(p: dict, x: torch.Tensor, pos: int, ckv_cache: torch.Tensor,
               krope_cache: torch.Tensor, cfg: ModelConfig):
    """Absorbed-form MLA decode against ``[B, Smax, kv_rank]`` /
    ``[B, Smax, rope_d]`` caches, written in place at ``pos``:

        score = q_nope @ W_uk^T · ckv_cached + q_rope · k_rope_cached
        out   = (softmax @ ckv_cached) @ W_uv, per head.

    Returns (out, ckv_cache, krope_cache)."""
    b = x.shape[0]
    h, nope, vd, kvr = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    q_lat, q_rope, ckv, k_rope = mla_decode_qkv(p, x, pos, cfg)
    cache_write(ckv_cache, ckv, pos)
    cache_write(krope_cache, k_rope, pos)
    scores = (torch.einsum("bqhk,bsk->bhqs", q_lat, ckv_cache.to(q_lat.dtype))
              + torch.einsum("bqhr,bsr->bhqs", q_rope, krope_cache.to(q_rope.dtype))).float()
    scale = 1.0 / ((nope + cfg.qk_rope_dim) ** 0.5)
    valid = torch.arange(ckv_cache.shape[1], device=x.device) <= pos
    scores = (scores * scale).masked_fill(~valid, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    lat_out = torch.einsum("bhqs,bsk->bqhk", w, ckv_cache.to(x.dtype))
    out = torch.einsum("bqhk,khv->bqhv", lat_out, p["wuv"].reshape(kvr, h, vd))
    return out.reshape(b, 1, -1) @ p["wo"], ckv_cache, krope_cache


def mla_decode_qkv(p: dict, x: torch.Tensor, pos: int, cfg: ModelConfig):
    """The token's absorbed query ``q_lat [B, 1, H, kv_rank]`` and roped
    ``q_rope [B, 1, H, rope_d]``, and its cache entries ``ckv [B, 1,
    kv_rank]`` and ``k_rope [B, 1, rope_d]``."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    cq, ckv, k_rope = mla_latents(p, x, positions, cfg)
    return (*mla_decode_query(p, cq, pos, cfg), ckv, k_rope)


def mla_decode_query(p: dict, cq: torch.Tensor, pos: int, cfg: ModelConfig):
    """The token's absorbed query ``q_lat [B, 1, heads, kv_rank]`` (``wuk``
    folded into ``q_nope``) and roped ``q_rope [B, 1, heads, rope_d]`` of
    the heads of ``p``'s wuq/wuk columns (all, or a model shard's)."""
    nope, kvr = cfg.qk_nope_dim, cfg.kv_lora_rank
    positions = torch.full((cq.shape[0], 1), pos, dtype=torch.int32, device=cq.device)
    q_nope, q_rope = mla_query(p, cq, positions, cfg)
    wuk = p["wuk"].reshape(kvr, q_nope.shape[2], nope)
    return torch.einsum("bqhn,khn->bqhk", q_nope, wuk), q_rope


def mla_partial(q_lat: torch.Tensor, q_rope: torch.Tensor, ckv_blk: torch.Tensor,
                krope_blk: torch.Tensor, start: int, pos: int, cfg: ModelConfig):
    """One latent cache block's float32 partial (``ckv_blk [B, Sb,
    kv_rank]``, ``krope_blk [B, Sb, rope_d]``, positions ``start ..``): ``m``,
    ``l [B, H, 1, 1]`` and the latent ``o [B, H, 1, kv_rank]``."""
    scores = (torch.einsum("bqhk,bsk->bhqs", q_lat, ckv_blk.to(q_lat.dtype))
              + torch.einsum("bqhr,bsr->bhqs", q_rope, krope_blk.to(q_rope.dtype))).float()
    m, l, w = _partial(scores * (1.0 / ((cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5)), start, pos)
    return m, l, torch.einsum("bhqs,bsk->bhqk", w, ckv_blk.float())


def mla_latent_out(p: dict, lat: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    """``combine_partials``' latent ``[B, heads, 1, kv_rank]`` of the heads
    of ``p``'s wuv columns (all, or a model shard's) through ``wuv``, in
    ``dtype``, before ``wo``: ``[B, 1, heads vd]``."""
    b, h = lat.shape[:2]
    vd, kvr = cfg.v_head_dim, cfg.kv_lora_rank
    out = torch.einsum("bqhk,khv->bqhv", lat.permute(0, 2, 1, 3).to(dtype),
                       p["wuv"].reshape(kvr, h, vd))
    return out.reshape(b, 1, -1)


def mla_decode_out(p: dict, lat: torch.Tensor, cfg: ModelConfig, dtype) -> torch.Tensor:
    """``combine_partials``' latent ``[B, H, 1, kv_rank]`` through ``wuv``
    and ``wo``: ``[B, 1, D]``."""
    return mla_latent_out(p, lat, cfg, dtype) @ p["wo"]


# -------------------------------------------------------------------- SwiGLU


def mlp_schema(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    return {
        "wi_gate": ParamDef((d, f), "normal", ("fsdp", "tp")),
        "wi_up": ParamDef((d, f), "normal", ("fsdp", "tp")),
        "wo": ParamDef((f, d), "scaled", ("tp", "fsdp")),
    }


def mlp_hidden(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU's hidden activations (on a column block of wi_gate/wi_up, that
    block's columns)."""
    gate = x @ p["wi_gate"]
    up = x @ p["wi_up"]
    return gate * torch.sigmoid(gate) * up


def mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    return mlp_hidden(p, x) @ p["wo"]


def _mm_f32(flat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if flat.device.type == "cpu":
        return flat.float() @ w.float()
    return torch.mm(flat, w, out_dtype=torch.float32)


class _MatmulF32(torch.autograd.Function):
    """``_mm_f32`` with a derivative (the card's ``out_dtype`` product has
    none): the backward takes the products one device's ``x @ w`` takes, in
    the operands' dtype. The float32 gradient it receives is a row-parallel
    partial's, the widened gradient of the reduction's single rounding, so
    it holds the operands' dtype's values exactly."""

    @staticmethod
    def forward(ctx, flat, w):
        ctx.save_for_backward(flat, w)
        return _mm_f32(flat, w)

    @staticmethod
    def backward(ctx, grad):
        flat, w = ctx.saved_tensors
        grad = grad.to(flat.dtype)
        return (grad @ w.t() if ctx.needs_input_grad[0] else None,
                flat.t() @ grad if ctx.needs_input_grad[1] else None)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as a float32 result, never rounded to ``x``'s dtype: a
    row-parallel partial, which a reduction sums in float32 and rounds once.
    A bf16 product accumulates in float32 on the card and on meta tensors
    (``torch.mm``'s ``out_dtype``); on the CPU, which lacks that kernel, its
    operands are widened first. Under autograd (the tensor-parallel train
    step) the same product, differentiable (``_MatmulF32``)."""
    if x.dtype == torch.float32:
        return x @ w
    flat = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = _MatmulF32.apply(flat, w)
    else:
        out = _mm_f32(flat, w)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(x, w)`` as a float32 result: ``matmul_f32``'s batched
    form (``torch.bmm``'s ``out_dtype`` on the card and meta, widened
    operands on the CPU). Under autograd (a training step, which sums every
    expert on one device: nothing to reduce) the product is taken in ``x``'s
    dtype, as the card's ``out_dtype`` product has no derivative."""
    if x.dtype == torch.float32:
        return torch.bmm(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return torch.bmm(x, w).float()
    if x.device.type == "cpu":
        return torch.bmm(x.float(), w.float())
    return torch.bmm(x, w, out_dtype=torch.float32)
