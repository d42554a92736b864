"""The dense decoder: schema, init, train forward (logits), prefill, decode.

Port of the dense-family branches of ``src/repro/models/model.py``. The
parameters are the reference's tree of plain tensors, with every layer's
leaves stacked on a leading ``[L, ...]`` dim (so ``params_from_numpy`` is a
leaf-by-leaf copy); the reference's ``scan`` over layers is a Python loop
over views of that stack. Caches are stacked the same way and updated in
place.

``loss_fn`` is the next-token cross entropy of ``forward_train``; its
backward is autograd's, with each layer under ``torch.utils.checkpoint`` as
``cfg.remat`` asks (``_remat``). Families ``moe``, ``ssm``, ``hybrid``,
``vlm`` and ``audio`` and ``attention="mla"`` raise ``NotImplementedError``
(ROADMAP.md, queue 1, item 1, part 2).
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, init_params, stack_schema, tree_leaves, tree_map

__all__ = [
    "model_schema",
    "init_model",
    "forward_train",
    "loss_fn",
    "forward_prefill",
    "decode_step",
    "init_cache",
    "count_params_analytical",
    "check_supported",
]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; the port runs the dense "
            "family (ROADMAP.md, queue 1, item 1, part 2)")
    if cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: attention {cfg.attention!r} is not ported yet; the port runs GQA "
            "(ROADMAP.md, queue 1, item 1, part 2)")


# ------------------------------------------------------------------- schema


def _layer_schema(cfg: ModelConfig) -> dict:
    """One stackable decoder layer."""
    return {
        "ln1": L.norm_schema(cfg.d_model),
        "attn": L.attn_schema(cfg),
        "ln2": L.norm_schema(cfg.d_model),
        "mlp": L.mlp_schema(cfg),
    }


def model_schema(cfg: ModelConfig) -> dict:
    check_supported(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    s: dict[str, Any] = {
        "tok_embed": ParamDef((v, d), "embed", ("vocab", "fsdp")),
        "layers": stack_schema(_layer_schema(cfg), cfg.n_layers),
        "final_norm": L.norm_schema(d),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamDef((d, v), "normal", ("fsdp", "vocab"))
    return s


def init_model(gen: torch.Generator | int, cfg: ModelConfig, device=None):
    """Random parameters in ``cfg.dtype`` from ``gen`` (a seed or a
    ``torch.Generator``), on ``device`` (default: the card)."""
    if isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    return init_params(gen, model_schema(cfg), getattr(torch, cfg.dtype),
                       resolve_device(device))


def count_params_analytical(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of the schema, never materialised (dense: all active)."""
    del active_only
    return sum(int(np.prod(d.shape)) for d in tree_leaves(model_schema(cfg)))


# ----------------------------------------------------------- layer execution


def _layers(params: dict, cfg: ModelConfig) -> list[dict]:
    """Each layer's views of the stacked ``[L, ...]`` leaves: one ``unbind(0)``
    a leaf and forward, so that the backward is one ``stack`` a leaf (a
    ``t[i]`` a layer would zero-fill and add a full ``[L, ...]`` gradient L
    times)."""
    rows = tree_map(lambda t: t.unbind(0), params["layers"])
    return [tree_map(lambda r, i=i: r[i], rows) for i in range(cfg.n_layers)]


def _post_mlp(lp, x, cfg: ModelConfig):
    return L.mlp_forward(lp["mlp"], L.rmsnorm(x, lp["ln2"], cfg.norm_eps))


def _dense_layer(lp, x, positions, cfg: ModelConfig):
    """One layer on the full sequence; returns (x, (k, v))."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    a, kv = L.attn_forward(lp["attn"], h, positions, cfg)
    x = x + a
    return x + _post_mlp(lp, x, cfg), kv


def _train_layer(lp, x, positions, cfg: ModelConfig):
    return _dense_layer(lp, x, positions, cfg)[0]


def _save_mm(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat="dots"``: keep the 2-D weight products (``aten.mm``, which the
    ``[B, S, D] @ [D, F]`` projections lower to), recompute the rest —
    attention's batched einsums (``bmm``) included, as the reference's
    ``dots_with_no_batch_dims_saveable`` does."""
    del ctx, args, kwargs
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat``: ``"none"`` saves every activation,
    ``"full"`` only the layer's inputs (everything inside is recomputed in the
    backward), ``"dots"`` the inputs and the 2-D weight products. The layer
    draws no random numbers, so no RNG state is stashed."""
    if cfg.remat == "none":
        return fn
    kwargs = {}
    if cfg.remat != "full":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_mm)
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
                             **kwargs)


def _mask_pad_logits(logits, cfg: ModelConfig):
    """padded_vocab > vocab: pad columns get -1e30 (softmax/argmax-neutral)."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    idx = torch.arange(cfg.padded_vocab, device=logits.device)
    return logits.masked_fill(idx >= cfg.vocab, NEG_INF)


def _logits(params, x, cfg: ModelConfig):
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["tok_embed"])
    else:
        logits = x @ params["lm_head"]
    return _mask_pad_logits(logits.float(), cfg)


def _embed_tokens(params, tokens):
    flat = tokens.reshape(-1)
    return params["tok_embed"].index_select(0, flat).reshape(*tokens.shape, -1)


def _positions(bsz: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(bsz, s)


# ------------------------------------------------------------- train forward


def forward_train(params, batch: dict, cfg: ModelConfig):
    """Full forward of the dense decoder: (logits [B, S, V] f32, aux {})."""
    check_supported(cfg)
    x = _embed_tokens(params, batch["tokens"])
    positions = _positions(*x.shape[:2], x.device)
    layer = _remat(_train_layer, cfg)
    for lp in _layers(params, cfg):
        x = layer(lp, x, positions, cfg)
    return _logits(params, x, cfg), {}


def loss_fn(params, batch: dict, cfg: ModelConfig):
    """Next-token cross entropy: ``(loss, {"ce_loss": loss})``, the loss a
    float32 0-d tensor (``logsumexp`` of the logits minus the gold logit,
    averaged over batch and sequence). The reference's moe and audio
    branches raise through ``check_supported``, as ``forward_train`` does."""
    logits, aux = forward_train(params, batch, cfg)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    loss = (logz - gold).mean()
    return loss, {"ce_loss": loss, **aux}


# -------------------------------------------------------------- KV cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Stacked decode cache for the whole model, bf16 whatever ``cfg.dtype``."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        "v": torch.zeros(shape, dtype=torch.bfloat16, device=dev),
    }


# ------------------------------------------------------------------- decode


def decode_step(params, cache: dict, token: torch.Tensor, pos: int, cfg: ModelConfig):
    """One decode step. token: [B, 1] int; pos: the int position.

    Returns (logits [B, vocab] f32, cache); the cache is updated in place.
    """
    check_supported(cfg)
    x = _embed_tokens(params, token)
    for i, lp in enumerate(_layers(params, cfg)):
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = L.attn_decode(lp["attn"], h, pos, cache["k"][i], cache["v"][i], cfg)
        x = x + a
        x = x + _post_mlp(lp, x, cfg)
    return _logits(params, x, cfg)[:, 0], cache


# ------------------------------------------------------------------ prefill


def forward_prefill(params, batch: dict, cache: dict, cfg: ModelConfig):
    """Prefill: the full forward that also fills the decode cache.

    Returns (last-position logits [B, vocab] f32, cache); positions past the
    prompt are zeroed, as the reference's padded cache is.
    """
    check_supported(cfg)
    x = _fill_attention_cache(params, batch, cache, cfg)
    return _logits(params, x[:, -1:], cfg)[:, 0], cache


def _fill_attention_cache(params, batch, cache, cfg: ModelConfig):
    """Run the layers once over the prompt, writing each layer's K/V (bf16)
    into the cache in place; returns the final residual stream."""
    x = _embed_tokens(params, batch["tokens"])
    s = x.shape[1]
    positions = _positions(*x.shape[:2], x.device)
    for i, lp in enumerate(_layers(params, cfg)):
        x, (k, v) = _dense_layer(lp, x, positions, cfg)
        for name, new in (("k", k), ("v", v)):
            cache[name][i, :, :s] = new
            cache[name][i, :, s:] = 0
    return x
