"""Unified model: schema, init, train forward, prefill, decode — all families.

Port of ``src/repro/models/model.py``. The parameters are the reference's
tree of plain tensors, with every layer's leaves stacked on a leading
``[L, ...]`` dim (the VLM's self layers on ``[G, per, ...]``), so
``params_from_numpy`` is a leaf-by-leaf copy; the reference's ``scan`` over
layers is a Python loop over views of those stacks, and its heterogeneous
structures are loops too:

  * hybrid — the weight-shared attention block after every
    ``hybrid_attn_every`` mamba layers, trailing mamba layers without it
    (zamba2)
  * vlm    — groups of ``cross_attn_every - 1`` self layers, then one gated
    cross-attention layer (llama-3.2-vision)

``loss_fn`` is the next-token cross entropy of ``forward_train`` (audio:
masked prediction; moe: plus the router's aux losses); its backward is
autograd's, with each layer (the VLM: each group too) under
``torch.utils.checkpoint`` as ``cfg.remat`` asks (``_remat``). Caches are
stacked like the layers: attention caches bf16, written in place; SSM
states replaced by what each step computes (bf16 conv states promoted to a
float32 run's dtype at its first decode step, as JAX's concatenate
promotes; the SSM state float32).

On a mesh the cache's leaves are ``ShardedTensor``s placed by
``distributed/lm_sharding.py::cache_spec_tree`` (batch over the
data-parallel axes; the sequence, or the SSM's heads and channels, over
'model'). ``prefill_placed`` runs ``forward_prefill`` once a data-parallel
shard of the batch and scatters each shard's cache into the blocks it
overlaps; ``decode_placed`` runs ``decode_step``'s layers once a
data-parallel row of the cache's blocks, on that row's first device:
attention as one partial a sequence block (on the device holding the block)
and a logsumexp combine, the SSM step one head block at a time. These
layers' projections are not split: the gathered path, every parameter
gathered whole on the device.

The dense, MoE, VLM, SSM and hybrid decoders and the audio encoder on the
"tp" profile serve tensor-parallel instead (``distributed/tensor_parallel.py``
decides which and holds the blocks and the moves): ``prefill_placed_tp`` and
``decode_placed_tp`` run each data-parallel shard (or cache row) over the
'model' shards of its group, each on its head, column, expert, SSM head
and vocab blocks, in one pair of loops (``prefill_tp``, ``decode_row_tp``)
over ``_tp_walk``'s layers of five kinds: a decoder (self) layer, an MLA
decoder layer, the VLM's cross layer, a mamba layer and the hybrid's
shared block. The
row-parallel partials are reduced in float32 on the group's home, where
the residual stream, the norms, the MoE's routing (once a routing group:
its slots and drops are one device's), the cross layers' gates, the gated
norm's statistic and the cache writes live. The VLM's image tokens are
projected by column blocks once a prefill and sent whole to every shard,
whose cross layers take their K/V heads of them (not roped). Decode
keeps the flash-decoding layout above: the token's K/V heads are joined
on the home and written into the sequence block holding ``pos``, the
joined query runs one partial a sequence block, and the combined output is
split by head blocks for the rows of ``wo``. An MLA layer's latents are
computed on the home and sent to every shard, which attends with its
heads at the prefill; at decode the shards' absorbed queries are joined on
the home, each latent cache block's partial runs on the shard holding it,
and the combined latent's heads go back to their shards for wuv and wo
(``_tp_mla``, ``_tp_mla_decode``). A cross layer's shard attends
to its KV heads of the image K/V in the copy its own device holds. A
mamba layer's shard computes its channels of B and C and its heads
(``_tp_mamba``). At the prefill each shard's final states (its heads'
``ssm`` and ``conv_x``, its channels' ``conv_b``/``conv_c``) are collected
into the home's dense cache of the data shard, counted as moves, and
scattered from there into the placed cache's blocks with the attention
caches; at decode each shard reads and writes its own blocks of the
states in the copy its own mesh position holds (``_tp_state_views``), so
nothing of the state moves. The audio encoder has no cache: its
tensor-parallel forward (``forward_tp``) projects the frames by column
blocks (``_tp_frontend``) and walks its non-causal "self" layers; the
prefill takes its last frame's logits, and the train step runs it under
autograd (``loss_tp``), each layer under ``_remat``.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.analysis.hlo_cost import forward_ops
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (
    ParamDef,
    init_params,
    param_specs,
    stack_schema,
    tree_leaves,
    tree_map,
)
from repro_torch.runtime.staging import stage

__all__ = [
    "model_schema",
    "init_model",
    "forward_train",
    "loss_fn",
    "forward_prefill",
    "decode_step",
    "decode_placed",
    "decode_placed_tp",
    "prefill_placed",
    "prefill_placed_tp",
    "forward_tp",
    "loss_tp",
    "init_cache",
    "cache_zeros",
    "model_param_specs",
    "count_params_analytical",
    "vlm_counts",
    "hybrid_counts",
]

MOE_AUX_KEYS = ("moe_balance_loss", "moe_z_loss", "moe_dropped_frac")


# ------------------------------------------------------------------- schema


def _layer_schema(cfg: ModelConfig) -> dict:
    """One stackable decoder/encoder layer."""
    if cfg.family in ("ssm", "hybrid"):
        return {"ln": L.norm_schema(cfg.d_model), "ssm": SSM.ssm_schema(cfg)}
    s: dict[str, Any] = {
        "ln1": L.norm_schema(cfg.d_model),
        "attn": L.mla_schema(cfg) if cfg.attention == "mla" else L.attn_schema(cfg),
        "ln2": L.norm_schema(cfg.d_model),
    }
    if cfg.family == "moe":
        s["moe"] = MOE.moe_schema(cfg)
    else:
        s["mlp"] = L.mlp_schema(cfg)
    return s


def _cross_layer_schema(cfg: ModelConfig) -> dict:
    return {
        "ln1": L.norm_schema(cfg.d_model),
        "xattn": L.attn_schema(cfg, cross=True),
        "ln2": L.norm_schema(cfg.d_model),
        "mlp": L.mlp_schema(cfg),
    }


def _shared_block_schema(cfg: ModelConfig) -> dict:
    """zamba2's weight-shared attention+MLP block (applied at intervals)."""
    return {
        "ln1": L.norm_schema(cfg.d_model),
        "attn": L.attn_schema(cfg),
        "ln2": L.norm_schema(cfg.d_model),
        "mlp": L.mlp_schema(cfg),
    }


def vlm_counts(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, self_per_group, n_cross) for the grouped vlm layers."""
    n_groups = cfg.n_layers // cfg.cross_attn_every
    return n_groups, cfg.cross_attn_every - 1, n_groups


def hybrid_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, trailing) — zamba2: shared attn after every `every` mamba
    layers; `trailing` mamba layers close the stack without attention."""
    n_groups = cfg.n_layers // cfg.hybrid_attn_every
    return n_groups, cfg.n_layers - n_groups * cfg.hybrid_attn_every


def _hybrid_split(cfg: ModelConfig, per_layer: list) -> tuple[list[list], list]:
    """Per-layer items (params or states) as (groups of ``every``, trailing),
    the reference's ``[G, every, ...]`` / ``[T, ...]`` split."""
    n_groups, _ = hybrid_counts(cfg)
    every = cfg.hybrid_attn_every
    groups = [per_layer[i * every:(i + 1) * every] for i in range(n_groups)]
    return groups, per_layer[n_groups * every:]


def model_schema(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.padded_vocab
    s: dict[str, Any] = {}
    if cfg.family == "audio":
        s["frontend"] = ParamDef((cfg.d_frontend, d), "normal", ("fsdp", "tp"))
    else:
        s["tok_embed"] = ParamDef((v, d), "embed", ("vocab", "fsdp"))
    if cfg.family == "vlm":
        s["img_proj"] = ParamDef((cfg.d_frontend, d), "normal", ("fsdp", "tp"))
        n_groups, self_per, _ = vlm_counts(cfg)
        s["layers"] = stack_schema(stack_schema(_layer_schema(cfg), self_per), n_groups)
        s["cross_layers"] = stack_schema(_cross_layer_schema(cfg), n_groups)
    else:
        s["layers"] = stack_schema(_layer_schema(cfg), cfg.n_layers)
    if cfg.family == "hybrid":
        s["shared"] = _shared_block_schema(cfg)
    s["final_norm"] = L.norm_schema(d)
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamDef((d, v), "normal", ("fsdp", "vocab"))
    return s


def init_model(gen: torch.Generator | int, cfg: ModelConfig, device=None):
    """Random parameters in ``cfg.dtype`` (the SSM's ``a_log`` and
    ``dt_bias`` float32) from ``gen`` (a seed, drawn on the CPU, or a
    ``torch.Generator``, drawn where it lives), on ``device`` (default: the
    card)."""
    if isinstance(gen, int):
        gen = torch.Generator().manual_seed(gen)
    return init_params(gen, model_schema(cfg), getattr(torch, cfg.dtype),
                       resolve_device(device))


def model_param_specs(cfg: ModelConfig):
    """The ``PartitionSpec`` tree of the model's parameters (ZeRO-3 and TP
    axes from the schema)."""
    return param_specs(model_schema(cfg))


def _numel(schema) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_leaves(schema))


def count_params_analytical(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of the schema, never materialised; ``active_only`` (moe)
    leaves out the experts a token does not reach, as the reference does."""
    total = _numel(model_schema(cfg))
    if active_only and cfg.family == "moe":
        per_layer_experts = sum(int(np.prod(d.shape)) for d in tree_leaves(MOE.moe_schema(cfg))
                                if len(d.shape) == 3)
        total -= (per_layer_experts * cfg.n_layers * (cfg.n_experts - cfg.experts_per_token)
                  // cfg.n_experts)
    return total


# ----------------------------------------------------------- layer execution


def _unstack(tree, n: int) -> list:
    """Views of the ``n`` rows of a stacked tree: one ``unbind(0)`` a leaf,
    so that the backward is one ``stack`` a leaf (a ``t[i]`` a layer would
    zero-fill and add a full gradient n times)."""
    rows = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda r, i=i: r[i], rows) for i in range(n)]


def _layers(params: dict, cfg: ModelConfig) -> list[dict]:
    """Each layer's parameters (non-vlm families)."""
    return _unstack(params["layers"], cfg.n_layers)


def _vlm_groups(params: dict, cfg: ModelConfig) -> list[tuple[list[dict], dict]]:
    """(self layers, cross layer) of each vlm group."""
    n_groups, self_per, _ = vlm_counts(cfg)
    selfs = [_unstack(g, self_per) for g in _unstack(params["layers"], n_groups)]
    return list(zip(selfs, _unstack(params["cross_layers"], n_groups)))


def _moe_group(x: torch.Tensor) -> int:
    """The serving paths' MoE group: one token a group at decode (S == 1,
    drop-free), else the training grouping so that prefill routes (and
    drops) as ``forward_train`` does."""
    return 1 if x.shape[1] == 1 else min(1024, x.shape[0] * x.shape[1])


def _ffn(lp, x, cfg: ModelConfig, group_size: int = 1024):
    """The layer's MLP (or MoE) on ``rmsnorm(x)``: (out, aux)."""
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        return MOE.moe_forward(lp["moe"], h, cfg, group_size=group_size)
    return L.mlp_forward(lp["mlp"], h), {}


def _post_mlp(lp, x, cfg: ModelConfig):
    return _ffn(lp, x, cfg, _moe_group(x))[0]


def _dense_layer(lp, x, positions, cfg: ModelConfig, group_size: int = 1024):
    """One attention layer on the full sequence; returns (x, cache entries
    ((k, v), or MLA's (ckv, k_rope)), aux)."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if cfg.attention == "mla":
        a, kv = L.mla_forward(lp["attn"], h, positions, cfg)
    else:
        a, kv = L.attn_forward(lp["attn"], h, positions, cfg)
    x = x + a
    m, aux = _ffn(lp, x, cfg, group_size)
    return x + m, kv, aux


def _train_layer(lp, x, positions, cfg: ModelConfig):
    x, _, aux = _dense_layer(lp, x, positions, cfg)
    return x, aux


def _mamba_layer(lp, x, cfg: ModelConfig, state=None):
    """One mamba layer: (x, the block's new state)."""
    o, new_state = SSM.ssm_forward(lp["ssm"], L.rmsnorm(x, lp["ln"], cfg.norm_eps), cfg, state)
    return x + o, new_state


def _mamba_train(lp, x, cfg: ModelConfig):
    return _mamba_layer(lp, x, cfg)[0]


def _shared_block(sp, x, positions, cfg: ModelConfig):
    """The hybrid's shared attention+MLP block: (x, (k, v))."""
    a, kv = L.attn_forward(sp["attn"], L.rmsnorm(x, sp["ln1"], cfg.norm_eps), positions, cfg)
    x = x + a
    return x + L.mlp_forward(sp["mlp"], L.rmsnorm(x, sp["ln2"], cfg.norm_eps)), kv


def _shared_train(sp, x, positions, cfg: ModelConfig):
    return _shared_block(sp, x, positions, cfg)[0]


def _cross_layer(cp, x, positions, img, cfg: ModelConfig):
    """The vlm's gated cross-attention layer over the projected image
    tokens: (x, (xk, xv))."""
    a, xkv = L.attn_forward(cp["xattn"], L.rmsnorm(x, cp["ln1"], cfg.norm_eps), positions, cfg,
                            kv_x=img)
    x = x + a
    return x + L.mlp_forward(cp["mlp"], L.rmsnorm(x, cp["ln2"], cfg.norm_eps)), xkv


def _vlm_group_train(self_lps, cp, x, positions, img, cfg: ModelConfig):
    layer = _remat(_train_layer, cfg)
    for lp in self_lps:
        x, _ = layer(lp, x, positions, cfg)
    return _cross_layer(cp, x, positions, img, cfg)[0]


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
    draws no random numbers, so no RNG state is stashed. Its ops count as a
    forward's where the backward recomputes them (``forward_ops``)."""
    if cfg.remat == "none":
        return fn
    kwargs = {}
    if cfg.remat != "full":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_mm)
    return functools.partial(checkpoint, functools.partial(_forward, fn), use_reentrant=False,
                             preserve_rng_state=False, **kwargs)


def _forward(fn, *args, **kwargs):
    with forward_ops():
        return fn(*args, **kwargs)


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


def _image_tokens(params, batch, x):
    return batch["image_embeds"].to(x.dtype) @ params["img_proj"]


# ------------------------------------------------------------- train forward


def forward_train(params, batch: dict, cfg: ModelConfig):
    """Full training forward: (logits [B, S, V] f32, aux metrics dict).

    batch keys: 'tokens' (decoder) | 'frames' (audio); 'image_embeds'
    (vlm). ``aux`` is empty but for moe, whose three router metrics are
    averaged over the layers.
    """
    if cfg.family == "audio":
        x = batch["frames"].to(getattr(torch, cfg.dtype)) @ params["frontend"]
    else:
        x = _embed_tokens(params, batch["tokens"])
    positions = _positions(*x.shape[:2], x.device)
    aux: dict[str, torch.Tensor] = {}

    if cfg.family == "vlm":
        img = _image_tokens(params, batch, x)
        # Remat at group granularity, each self layer under its own
        # checkpoint inside, as the reference nests them.
        group = _remat(_vlm_group_train, cfg)
        for self_lps, cp in _vlm_groups(params, cfg):
            x = group(self_lps, cp, x, positions, img, cfg)
    elif cfg.family in ("ssm", "hybrid"):
        mamba = _remat(_mamba_train, cfg)
        lps = _layers(params, cfg)
        if cfg.family == "ssm":
            groups, tail = [], lps
        else:
            groups, tail = _hybrid_split(cfg, lps)
        shared = _remat(_shared_train, cfg)
        for grp in groups:
            for lp in grp:
                x = mamba(lp, x, cfg)
            x = shared(params["shared"], x, positions, cfg)
        for lp in tail:
            x = mamba(lp, x, cfg)
    else:  # dense / moe / audio
        layer = _remat(_train_layer, cfg)
        for lp in _layers(params, cfg):
            x, layer_aux = layer(lp, x, positions, cfg)
            aux = {k: aux[k] + v if k in aux else v for k, v in layer_aux.items()}
        if cfg.family == "moe":
            aux = {k: aux[k] / cfg.n_layers for k in MOE_AUX_KEYS}
    return _logits(params, x, cfg), aux


def _cross_entropy(logits: torch.Tensor, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """``loss_fn``'s cross entropy of ``logits`` against ``batch["labels"]``
    (the audio encoder's over ``batch["mask"]``'s frames)."""
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = logz - gold
    if cfg.family == "audio":
        mask = batch["mask"].float()
        return (ce * mask).sum() / mask.sum().clamp_min(1.0)
    return ce.mean()


def loss_fn(params, batch: dict, cfg: ModelConfig):
    """Cross entropy (``logsumexp`` of the logits minus the gold logit) as a
    float32 0-d tensor, with its metrics: decoders average it over batch and
    sequence (next-token labels), the audio encoder over ``batch["mask"]``'s
    frames (masked prediction); moe adds ``router_aux_coef`` times the
    balance loss and 1e-4 times the z-loss. Returns ``(loss, {"ce_loss": ...,
    **aux})``."""
    logits, aux = forward_train(params, batch, cfg)
    loss = _cross_entropy(logits, batch, cfg)
    metrics = {"ce_loss": loss, **aux}
    if cfg.family == "moe":
        loss = loss + cfg.router_aux_coef * aux["moe_balance_loss"]
        loss = loss + 1e-4 * aux["moe_z_loss"]
    return loss, metrics


# -------------------------------------------------------------- KV/SSM cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Stacked decode cache for the whole model: attention caches bf16
    whatever ``cfg.dtype``, SSM states as ``ssm_state_shapes`` makes them
    (bf16 conv, float32 state); the audio encoder has none."""
    return cache_zeros(cfg, batch, max_seq, resolve_device(device))


def cache_zeros(cfg: ModelConfig, batch: int, max_seq: int, dev: torch.device):
    """``init_cache``'s tree on ``dev`` as given (``"meta"`` included: the
    cache's shapes and dtypes, nothing allocated)."""
    hd, kvh = cfg.resolved_head_dim, cfg.n_kv_heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device=dev)

    if cfg.family == "audio":
        return {}
    if cfg.family in ("ssm", "hybrid"):
        one = SSM.ssm_state_shapes(cfg, batch, dev)
        cache: dict[str, Any] = {"ssm": {k: torch.zeros((cfg.n_layers, *t.shape), dtype=t.dtype,
                                                        device=dev) for k, t in one.items()}}
        if cfg.family == "hybrid" and cfg.hybrid_attn_every:
            n_apps = cfg.n_layers // cfg.hybrid_attn_every
            cache["shared_k"] = zeros(n_apps, batch, max_seq, kvh, hd)
            cache["shared_v"] = zeros(n_apps, batch, max_seq, kvh, hd)
        return cache
    if cfg.attention == "mla":
        return {"ckv": zeros(cfg.n_layers, batch, max_seq, cfg.kv_lora_rank),
                "krope": zeros(cfg.n_layers, batch, max_seq, cfg.qk_rope_dim)}
    if cfg.family == "vlm":
        n_groups, self_per, _ = vlm_counts(cfg)
        return {"k": zeros(n_groups, self_per, batch, max_seq, kvh, hd),
                "v": zeros(n_groups, self_per, batch, max_seq, kvh, hd),
                "xk": zeros(n_groups, batch, cfg.n_image_tokens, kvh, hd),
                "xv": zeros(n_groups, batch, cfg.n_image_tokens, kvh, hd)}
    return {"k": zeros(cfg.n_layers, batch, max_seq, kvh, hd),
            "v": zeros(cfg.n_layers, batch, max_seq, kvh, hd)}


def _put_states(cache: dict, i: int, new: dict) -> None:
    """Write one layer's new SSM state into the stacked states, first
    promoting a stacked leaf whose dtype the new state's outranks (a bf16
    conv state meeting a float32 run), as the reference's returned states
    are promoted."""
    states = cache["ssm"]
    for k, t in new.items():
        if states[k].dtype != t.dtype:
            states[k] = states[k].to(torch.promote_types(states[k].dtype, t.dtype))
        states[k][i].copy_(t)


def _fill_rows(dst: torch.Tensor, new: torch.Tensor) -> None:
    """``dst [B, Smax, ...]`` (bf16) <- ``new [B, S, ...]``, zeros past S,
    as the reference's padded prefill cache."""
    s = new.shape[1]
    dst[:, :s] = new
    dst[:, s:] = 0


# ------------------------------------------------------------------- decode


def decode_step(params, cache: dict, token: torch.Tensor, pos: int, cfg: ModelConfig,
                image_embeds: torch.Tensor | None = None):
    """One decode step. token: [B, 1] int; pos: the int position.

    Returns (logits [B, vocab] f32, cache); the cache is updated in place
    (SSM states replaced, see ``_put_states``). VLM cross K/V must be
    prefilled (``forward_prefill``); ``image_embeds`` is accepted for API
    symmetry, as the reference's is.
    """
    del image_embeds
    if cfg.family == "audio":
        raise ValueError("encoder-only arch has no decode step")
    x = _embed_tokens(params, token)

    if cfg.family in ("ssm", "hybrid"):
        lps = list(enumerate(_layers(params, cfg)))
        if cfg.family == "ssm":
            groups, tail = [], lps
        else:
            groups, tail = _hybrid_split(cfg, lps)
        sp = params.get("shared")

        def mamba(i, lp, x):
            st = {k: t[i] for k, t in cache["ssm"].items()}
            o, new = SSM.ssm_decode(lp["ssm"], L.rmsnorm(x, lp["ln"], cfg.norm_eps), cfg, st)
            _put_states(cache, i, new)
            return x + o

        for gi, grp in enumerate(groups):
            for i, lp in grp:
                x = mamba(i, lp, x)
            a, _, _ = L.attn_decode(sp["attn"], L.rmsnorm(x, sp["ln1"], cfg.norm_eps), pos,
                                    cache["shared_k"][gi], cache["shared_v"][gi], cfg)
            x = x + a
            x = x + L.mlp_forward(sp["mlp"], L.rmsnorm(x, sp["ln2"], cfg.norm_eps))
        for i, lp in tail:
            x = mamba(i, lp, x)
    elif cfg.family == "vlm":
        for gi, (self_lps, cp) in enumerate(_vlm_groups(params, cfg)):
            for li, lp in enumerate(self_lps):
                a, _, _ = L.attn_decode(lp["attn"], L.rmsnorm(x, lp["ln1"], cfg.norm_eps), pos,
                                        cache["k"][gi, li], cache["v"][gi, li], cfg)
                x = x + a + _post_mlp(lp, x + a, cfg)
            x = x + L.cross_decode(cp["xattn"], L.rmsnorm(x, cp["ln1"], cfg.norm_eps), pos,
                                   cache["xk"][gi], cache["xv"][gi], cfg)
            x = x + L.mlp_forward(cp["mlp"], L.rmsnorm(x, cp["ln2"], cfg.norm_eps))
    else:  # dense / moe
        for i, lp in enumerate(_layers(params, cfg)):
            h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            if cfg.attention == "mla":
                a, _, _ = L.mla_decode(lp["attn"], h, pos, cache["ckv"][i], cache["krope"][i], cfg)
            else:
                a, _, _ = L.attn_decode(lp["attn"], h, pos, cache["k"][i], cache["v"][i], cfg)
            x = x + a
            x = x + _post_mlp(lp, x, cfg)
    return _logits(params, x, cfg)[:, 0], cache


# ------------------------------------------------------------------ prefill


def forward_prefill(params, batch: dict, cache: dict, cfg: ModelConfig):
    """Prefill: the full forward that also fills the decode cache.

    Returns (last-position logits [B, vocab] f32, cache); attention caches
    are written in place and zeroed past the prompt, as the reference's
    padded caches are; SSM states are replaced by the prompt's. The audio
    encoder's "prefill" is a plain full forward with no cache.
    """
    if cfg.family == "audio":
        return forward_train(params, batch, cfg)[0][:, -1], {}
    if cfg.family in ("ssm", "hybrid"):
        x = _fill_ssm_cache(params, batch, cache, cfg)
    else:
        x = _fill_attention_cache(params, batch, cache, cfg)
    return _logits(params, x[:, -1:], cfg)[:, 0], cache


def _fill_ssm_cache(params, batch, cache, cfg: ModelConfig):
    """Run the mamba (and shared attention) layers once over the prompt:
    the SSM states replaced by the stacked final states, the hybrid's
    shared K/V written in place. Returns the final residual stream."""
    x = _embed_tokens(params, batch["tokens"])
    positions = _positions(*x.shape[:2], x.device)
    lps = _layers(params, cfg)
    if cfg.family == "ssm":
        groups, tail = [], lps
    else:
        groups, tail = _hybrid_split(cfg, lps)
    states = []
    for gi, grp in enumerate(groups):
        for lp in grp:
            x, st = _mamba_layer(lp, x, cfg)
            states.append(st)
        x, (k, v) = _shared_block(params["shared"], x, positions, cfg)
        _fill_rows(cache["shared_k"][gi], k)
        _fill_rows(cache["shared_v"][gi], v)
    for lp in tail:
        x, st = _mamba_layer(lp, x, cfg)
        states.append(st)
    cache["ssm"] = {k: torch.stack([st[k] for st in states]) for k in states[0]}
    return x


def _fill_attention_cache(params, batch, cache, cfg: ModelConfig):
    """Run the layers once over the prompt, writing each layer's K/V (MLA:
    latent ckv and k_rope; vlm: the cross K/V of the image tokens too) into
    the bf16 cache in place; returns the final residual stream."""
    x = _embed_tokens(params, batch["tokens"])
    positions = _positions(*x.shape[:2], x.device)
    group = _moe_group(x)
    if cfg.family == "vlm":
        img = _image_tokens(params, batch, x)
        for gi, (self_lps, cp) in enumerate(_vlm_groups(params, cfg)):
            for li, lp in enumerate(self_lps):
                x, (k, v), _ = _dense_layer(lp, x, positions, cfg, group)
                _fill_rows(cache["k"][gi, li], k)
                _fill_rows(cache["v"][gi, li], v)
            x, (xk, xv) = _cross_layer(cp, x, positions, img, cfg)
            cache["xk"][gi] = xk
            cache["xv"][gi] = xv
        return x
    names = ("ckv", "krope") if cfg.attention == "mla" else ("k", "v")
    for i, lp in enumerate(_layers(params, cfg)):
        x, kv, _ = _dense_layer(lp, x, positions, cfg, group)
        for name, new in zip(names, kv):
            _fill_rows(cache[name][i], new)
    return x


# ------------------------------------------------------- on a placed cache


def _batch_dim(key: str, leaf) -> int:
    """The batch dim of a cache leaf (after the stacked layer dims)."""
    return leaf.ndim - 4 if key in ("k", "v") else 1


def _flat_cache(cache: dict) -> list:
    """[(tree, key, leaf)] of a cache, the SSM states included."""
    out = [(cache, k, v) for k, v in cache.items() if k != "ssm"]
    return out + [(cache["ssm"], k, v) for k, v in cache.get("ssm", {}).items()]


def _put_placed(tree: dict, key: str, new: torch.Tensor, starts) -> None:
    """``new`` written into the placed leaf ``tree[key]`` at ``starts``, the
    leaf first promoted to ``new``'s dtype where that outranks its own (as
    ``_put_states`` promotes the one-device states)."""
    leaf = tree[key]
    dtype = torch.promote_types(leaf.dtype, new.dtype)
    if dtype != leaf.dtype:
        tree[key] = leaf = leaf.astype(dtype)
    leaf.scatter_(new, starts)


def prefill_placed(full: dict, shards: list, cache: dict, cfg: ModelConfig, home):
    """``forward_prefill`` over a placed cache. ``shards`` is ``[(row
    offset, device, batch part)]`` (the distinct data-parallel shards of the
    batch), ``full`` maps each device to the parameters gathered there.
    Each shard fills a cache of its own rows on its device, which is then
    written into every block of ``cache`` it overlaps (a shard's rows may
    span several of the cache's batch and sequence blocks). Returns (last
    logits [B, vocab] f32 on ``home``, cache). The audio encoder has no
    cache: each shard's ``forward_prefill`` runs with none."""
    if cfg.family == "audio":
        return torch.cat([stage(forward_prefill(full[dev], part, {}, cfg)[0], home)
                          for _, dev, part in shards]), cache
    seq = _cache_seq(cache)
    logits = []
    for lo, dev, part in shards:
        own = cache_zeros(cfg, _first_leaf(part).shape[0], seq, dev)
        last, own = forward_prefill(full[dev], part, own, cfg)
        _scatter_rows(cache, own, lo)
        del own
        logits.append(stage(last, home))
    return torch.cat(logits), cache


def _first_leaf(batch: dict):
    """The leaf a batch's rows are read from: ``tokens``, or the audio's
    ``frames``."""
    return batch["tokens" if "tokens" in batch else "frames"]


def _cache_seq(cache: dict) -> int:
    return next((leaf.shape[_batch_dim(k, leaf) + 1] for _, k, leaf in _flat_cache(cache)
                 if k in ("k", "ckv", "shared_k")), 1)


def _scatter_rows(cache: dict, own: dict, lo: int) -> None:
    """A shard's dense cache ``own`` (its rows from ``lo``) written into
    every block of the placed ``cache`` it overlaps."""
    for tree, key, new in _flat_cache(own):
        target = cache if tree is own else cache["ssm"]
        starts = [0] * new.dim()
        starts[_batch_dim(key, new)] = lo
        _put_placed(target, key, new, starts)


def _cache_rows(cache: dict) -> list:
    """[(row, first row, end row, device, mesh position)] of the cache's
    data-parallel rows of blocks: each row runs on the first position (in
    mesh order) holding one of its blocks, on its device."""
    _, key, leaf = _flat_cache(cache)[0]
    bdim = _batch_dim(key, leaf)
    n = leaf.sharding.blocks_per_dim(leaf.ndim)[bdim]
    at: dict = {}
    for pos, (dev, idx) in leaf.sharding.layout(leaf.ndim).items():
        at.setdefault(idx[bdim], (dev, pos))
    per = leaf.shape[bdim] // n
    return [(r, r * per, (r + 1) * per, *at[r]) for r in range(n)]


def _seq_blocks(leaf, lead: tuple, row: int) -> list:
    """[(first position, block, mesh position)] along the sequence of a
    placed attention leaf, for the layer ``lead`` of data-parallel row
    ``row``: each block as a view on the first mesh position (in mesh order)
    holding it, and that position."""
    bdim = len(lead)
    n = leaf.sharding.blocks_per_dim(leaf.ndim)[bdim + 1]
    per = leaf.shape[bdim + 1] // n
    holder: dict = {}
    for at, (dev, idx) in leaf.sharding.layout(leaf.ndim).items():
        holder.setdefault(idx, (at, leaf.blocks[(dev, idx)]))
    out = []
    for j in range(n):
        idx = [0] * leaf.ndim
        idx[bdim], idx[bdim + 1] = row, j
        at, block = holder[tuple(idx)]
        out.append((j * per, block[lead], at))
    return out


def _write_token(leaf, lead: tuple, lo: int, pos: int, new: torch.Tensor) -> None:
    """The token's ``new [rows, 1, ...]`` written at ``pos`` into the block
    holding it (each of its copies), rows from ``lo``."""
    piece = new.reshape((1,) * len(lead) + tuple(new.shape))
    leaf.scatter_(piece, (*lead, lo, pos) + (0,) * (new.dim() - 2))


def _combine_blocks(partial, row_dev, q_parts: tuple, leaves: tuple, lead: tuple, row: int,
                    group=None):
    """``partial(*q_parts, *blocks, start)`` over the row's sequence blocks
    of ``leaves`` (each on the device holding it), combined on ``row_dev``.
    With a model ``group`` (``row_dev`` its home), a block's work is that of
    the group's shard holding it, read from the block's mesh position: the
    moves go through the group, the partial runs in the shard's context."""
    if group is not None:
        from repro_torch.distributed.tensor_parallel import MODEL

        ax = leaves[0].sharding.mesh.axis_names.index(MODEL)
    parts = []
    for blocks in zip(*(_seq_blocks(leaf, lead, row) for leaf in leaves)):
        start, dev, at = blocks[0][0], blocks[0][1].device, blocks[0][2]
        kv = tuple(b for _, b, _ in blocks)
        if group is None:
            out = partial(*(stage(t, dev) for t in q_parts), *kv, start)
            parts.append(tuple(stage(t, row_dev) for t in out))
            continue
        j = at[ax]
        qd = tuple(group.send(t, j) for t in q_parts)
        with group.on(j):
            out = partial(*qd, *kv, start)
        parts.append(tuple(group.collect(t, j) for t in out))
    return L.combine_partials(parts)


def _attn_placed(p, h, pos, cache, names, lead, row, lo, cfg: ModelConfig):
    """Decode attention of the row's ``h`` against the placed leaves
    ``names`` (``k``/``v``, ``shared_k``/``shared_v``) at layer ``lead``."""
    q, k, v = L.attn_decode_qkv(p, h, pos, cfg)
    kl, vl = cache[names[0]], cache[names[1]]
    _write_token(kl, lead, lo, pos, k)
    _write_token(vl, lead, lo, pos, v)
    o = _combine_blocks(lambda q_, kb, vb, s: L.attn_partial(q_, kb, vb, s, pos), h.device,
                        (q,), (kl, vl), lead, row)
    return L.attn_decode_out(p, o, h.dtype)


def _mla_placed(p, h, pos, cache, i, row, lo, cfg: ModelConfig):
    q_lat, q_rope, ckv, k_rope = L.mla_decode_qkv(p, h, pos, cfg)
    _write_token(cache["ckv"], (i,), lo, pos, ckv)
    _write_token(cache["krope"], (i,), lo, pos, k_rope)
    lat = _combine_blocks(
        lambda ql, qr, cb, kb, s: L.mla_partial(ql, qr, cb, kb, s, pos, cfg), h.device,
        (q_lat, q_rope), (cache["ckv"], cache["krope"]), (i,), row)
    return L.mla_decode_out(p, lat, cfg, h.dtype)


def _ssm_placed(lp, x, cache, i, lo, hi, cfg: ModelConfig):
    """One mamba layer's step for rows ``lo .. hi-1`` over the placed
    states: B/C conv states read whole, the recurrence one head block (of
    the ``ssm`` leaf's split over 'model') at a time; the new states written
    back into their blocks."""
    states, dev = cache["ssm"], x.device
    hp = cfg.ssm_head_dim
    rows = (slice(i, i + 1), slice(lo, hi))
    nh = states["ssm"].sharding.blocks_per_dim(states["ssm"].ndim)[2]
    per = cfg.ssm_heads // nh
    blocks = []
    for j in range(nh):
        h0, h1 = j * per, (j + 1) * per
        blocks.append((h0, h1, states["conv_x"].read(rows + (slice(None), slice(h0 * hp, h1 * hp)),
                                                     dev)[0],
                       states["ssm"].read(rows + (slice(h0, h1),), dev)[0]))
    o, ncb, ncc, new = SSM.ssm_decode_heads(
        lp["ssm"], L.rmsnorm(x, lp["ln"], cfg.norm_eps), cfg,
        states["conv_b"].read(rows, dev)[0], states["conv_c"].read(rows, dev)[0], blocks)
    _put_placed(states, "conv_b", ncb[None], (i, lo, 0, 0))
    _put_placed(states, "conv_c", ncc[None], (i, lo, 0, 0))
    for (h0, _, _, _), (ncx, hnew) in zip(blocks, new):
        _put_placed(states, "conv_x", ncx[None], (i, lo, 0, h0 * hp))
        _put_placed(states, "ssm", hnew[None], (i, lo, h0, 0, 0))
    return x + o


def decode_placed(full: dict, cache: dict, token: torch.Tensor, pos: int, cfg: ModelConfig,
                  home):
    """``decode_step`` over a placed cache (the module docstring): ``token
    [B, 1]`` on any device, ``full`` the parameters gathered on each device.
    Returns (logits [B, vocab] f32 on ``home``, cache), the cache's blocks
    written in place (SSM leaves promoted as ``_put_states`` promotes)."""
    if cfg.family == "audio":
        raise ValueError("encoder-only arch has no decode step")
    logits = []
    for row, lo, hi, dev, _ in _cache_rows(cache):
        params = full[dev]
        x = _embed_tokens(params, stage(token[lo:hi], dev))
        if cfg.family in ("ssm", "hybrid"):
            lps = list(enumerate(_layers(params, cfg)))
            groups, tail = ([], lps) if cfg.family == "ssm" else _hybrid_split(cfg, lps)
            sp = params.get("shared")
            for gi, grp in enumerate(groups):
                for i, lp in grp:
                    x = _ssm_placed(lp, x, cache, i, lo, hi, cfg)
                x = x + _attn_placed(sp["attn"], L.rmsnorm(x, sp["ln1"], cfg.norm_eps), pos, cache,
                                     ("shared_k", "shared_v"), (gi,), row, lo, cfg)
                x = x + L.mlp_forward(sp["mlp"], L.rmsnorm(x, sp["ln2"], cfg.norm_eps))
            for i, lp in tail:
                x = _ssm_placed(lp, x, cache, i, lo, hi, cfg)
        elif cfg.family == "vlm":
            for gi, (self_lps, cp) in enumerate(_vlm_groups(params, cfg)):
                for li, lp in enumerate(self_lps):
                    a = _attn_placed(lp["attn"], L.rmsnorm(x, lp["ln1"], cfg.norm_eps), pos, cache,
                                     ("k", "v"), (gi, li), row, lo, cfg)
                    x = x + a + _post_mlp(lp, x + a, cfg)
                xk = cache["xk"].read((slice(gi, gi + 1), slice(lo, hi)), dev)[0]
                xv = cache["xv"].read((slice(gi, gi + 1), slice(lo, hi)), dev)[0]
                x = x + L.cross_decode(cp["xattn"], L.rmsnorm(x, cp["ln1"], cfg.norm_eps), pos,
                                       xk, xv, cfg)
                x = x + L.mlp_forward(cp["mlp"], L.rmsnorm(x, cp["ln2"], cfg.norm_eps))
        else:  # dense / moe
            for i, lp in enumerate(_layers(params, cfg)):
                h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
                if cfg.attention == "mla":
                    a = _mla_placed(lp["attn"], h, pos, cache, i, row, lo, cfg)
                else:
                    a = _attn_placed(lp["attn"], h, pos, cache, ("k", "v"), (i,), row, lo, cfg)
                x = x + a
                x = x + _post_mlp(lp, x, cfg)
        logits.append(stage(_logits(params, x, cfg)[:, 0], home))
    return torch.cat(logits), cache


# ------------------------------------------------------- tensor parallel


def _tp_embed(group, tokens: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel lookup of the home's ``tokens``: each shard its vocab
    block's rows (zeros for the tokens outside it), summed on the home (one
    shard contributes each row, so the sum is the lookup exactly)."""
    parts = []
    for j in range(group.m):
        emb = group.blocks[j]["tok_embed"]
        local = group.send(tokens, j)
        with group.on(j):
            local = local - j * emb.shape[0]
            hit = (local >= 0) & (local < emb.shape[0])
            rows = emb.index_select(0, local.clamp(0, emb.shape[0] - 1).reshape(-1))
            rows = rows.reshape(*local.shape, -1)
            parts.append(torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                        device=rows.device)))
    return group.reduce(parts, group.blocks[0]["tok_embed"].dtype)


def _tp_frontend(group, frames: torch.Tensor) -> torch.Tensor:
    """The audio encoder's frame projection of the home's ``frames``: each
    shard its columns of ``frames @ frontend``, joined on the home into the
    residual stream (which lives there: nothing is sent back)."""
    parts = []
    for j, fj in enumerate(group.broadcast(frames.to(group.blocks[0]["frontend"].dtype))):
        with group.on(j):
            parts.append(fj @ group.blocks[j]["frontend"])
    return group.join(parts)


def _tp_logits(group, x: torch.Tensor, cfg: ModelConfig, out) -> torch.Tensor:
    """Vocab-parallel logits of the home's ``x``: each shard its vocab
    columns (of lm_head, or tied tok_embed's rows) in float32, concatenated
    on ``out`` (the mesh's first device), the pad columns masked there."""
    hs = group.broadcast(L.rmsnorm(x, group.blocks[0]["final_norm"], cfg.norm_eps))
    parts = []
    for j, (h, b) in enumerate(zip(hs, group.blocks)):
        w = b["tok_embed"].t() if cfg.tie_embeddings else b["lm_head"]
        with group.on(j):
            part = (h @ w).float()
        group.note(part, j, 0)
        parts.append(stage(part, out))
    return _mask_pad_logits(torch.cat(parts, dim=-1), cfg)


def _tp_layers(group, cfg: ModelConfig) -> list:
    """[layer][shard] views of the group's stacked layer blocks; for the
    vlm [group] -> ([self layer][shard], [shard] cross layer), from
    ``_vlm_groups`` of each shard's blocks."""
    if cfg.family == "vlm":
        per_shard = [_vlm_groups(b, cfg) for b in group.blocks]
        return [([list(s) for s in zip(*(selfs for selfs, _ in grp))], [cp for _, cp in grp])
                for grp in zip(*per_shard)]
    per_shard = [_layers(b, cfg) for b in group.blocks]
    return [list(shards) for shards in zip(*per_shard)]


def _tp_walk(group, cfg: ModelConfig) -> list:
    """The TP loops' layers in order: ``(lead, [shard] layer, kind)``.
    ``kind``: "self" (a decoder layer; its K/V at ``lead`` of ``k``/``v``,
    ``(i,)`` or the vlm's ``(gi, li)``), "mla" (an MLA decoder layer; its
    latents at ``(i,)`` of ``ckv``/``krope``), "cross" (the vlm's cross layer,
    ``xk``/``xv`` at ``(gi,)``), "mamba" (its states at ``(i,)`` of the
    stacked ``ssm`` leaves) or "shared" (the hybrid's shared block after
    every ``hybrid_attn_every`` mamba layers, as ``_hybrid_split`` orders
    them; its K/V at ``(gi,)`` of ``shared_k``/``shared_v``)."""
    if cfg.family == "vlm":
        out = []
        for gi, (selfs, cps) in enumerate(_tp_layers(group, cfg)):
            out += [((gi, li), lps, "self") for li, lps in enumerate(selfs)]
            out.append(((gi,), cps, "cross"))
        return out
    if cfg.family not in ("ssm", "hybrid"):
        kind = "mla" if cfg.attention == "mla" else "self"
        return [((i,), lps, kind) for i, lps in enumerate(_tp_layers(group, cfg))]
    mamba = [((i,), lps, "mamba") for i, lps in enumerate(_tp_layers(group, cfg))]
    if cfg.family == "ssm":
        return mamba
    groups, tail = _hybrid_split(cfg, mamba)
    shared = [b["shared"] for b in group.blocks]
    return [item for gi, grp in enumerate(groups)
            for item in grp + [((gi,), shared, "shared")]] + tail


def _tp_mlp(group, lps: list, h: torch.Tensor) -> torch.Tensor:
    """Column-parallel wi_gate/wi_up and row-parallel wo on the home's
    ``h``, the float32 partials reduced on the home."""
    parts = []
    for j, (lp, hj) in enumerate(zip(lps, group.broadcast(h))):
        with group.on(j):
            parts.append(L.matmul_f32(L.mlp_hidden(lp["mlp"], hj), lp["mlp"]["wo"]))
    return group.reduce(parts, h.dtype)


def _tp_moe(group, lps: list, h: torch.Tensor, cfg: ModelConfig, group_size: int):
    """The MoE layer on the home's ``h`` over the group: routed once on the
    home (``moe.plan``: the routing group's slots and drops, as one
    device's), the tokens and the routing tensors (gates, experts, slots)
    sent to each shard, which builds the one-hots of its own experts
    (``expert_range``) and computes their float32 share of ``y``; the shares
    reduced on the home. Returns (y, aux) as ``moe.moe_forward``."""
    from repro_torch.distributed import tensor_parallel

    pl = MOE.plan(lps[0]["moe"], h, cfg, group_size)
    xt = h.reshape(*pl.gates.shape[:2], h.shape[-1])
    parts = []
    for j, lp in enumerate(lps):
        xj, gates, experts, slots = (group.send(t, j) for t in (xt, pl.gates, pl.experts,
                                                                pl.slots))
        e0, e1 = tensor_parallel.expert_range(cfg, j, group.m)
        with group.on(j):
            parts.append(MOE.expert_block(lp["moe"], xj, gates, experts, slots, pl.capacity,
                                          e0, e1))
    return group.reduce(parts, h.dtype).reshape(h.shape), MOE.aux_metrics(pl, cfg)


def _tp_ffn(group, lps: list, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The layer's MLP (or MoE, routed in ``_moe_group``'s groups) over the
    group on the home's ``h``."""
    if cfg.family == "moe":
        return _tp_moe(group, lps, h, cfg, _moe_group(h))[0]
    return _tp_mlp(group, lps, h)


def _tp_image_tokens(group, image_embeds: torch.Tensor, dtype) -> list:
    """The projected image tokens ``[B, n_img, d]`` on every shard's
    device, once a prefill: each shard its columns of ``image_embeds @
    img_proj``, joined on the home and sent whole to each shard (every
    cross layer's wk/wv columns need every column of them)."""
    parts = []
    for j, ej in enumerate(group.broadcast(image_embeds.to(dtype))):
        with group.on(j):
            parts.append(ej @ group.blocks[j]["img_proj"])
    return group.broadcast(group.join(parts))


def _tp_qkv(group, lps: list, h: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
            imgs: list | None = None):
    """Each shard's query heads (on its device) and the K/V heads of every
    shard's columns joined on the home: ``([q_j], k, v)``, k and v ``[B,
    Sk, K, hd]``. Self attention ropes q and k; with ``imgs`` (the image
    tokens on each shard's device) cross attention: ``xattn``'s K/V columns
    of the image tokens, nothing roped."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    name = "attn" if imgs is None else "xattn"
    qs, ks, vs = [], [], []
    for j, (lp, hj) in enumerate(zip(lps, group.broadcast(h))):
        with group.on(j):
            q, kc, vc = L.attn_qkv_block(lp[name], hj, cfg, None if imgs is None else imgs[j])
            qs.append(q if imgs is not None else
                      L.rope(q, stage(positions, hj.device), cfg.rope_theta))
        ks.append(kc)
        vs.append(vc)
    sk = ks[0].shape[1]
    k = group.join(ks).reshape(b, sk, cfg.n_kv_heads, hd)
    v = group.join(vs).reshape(b, sk, cfg.n_kv_heads, hd)
    return qs, (k if imgs is not None else L.rope(k, positions, cfg.rope_theta)), v


def _tp_kv_heads(group, j: int, cfg: ModelConfig, take):
    """The KV heads shard ``j``'s query heads use, on its device:
    ``take(k0, k1)`` gives heads ``k0 .. k1 - 1`` of (k, v) there; they are
    expanded to one a query head where the kernel's GQA cannot take them as
    they are."""
    from repro_torch.distributed.tensor_parallel import kv_block

    k0, k1, local = kv_block(cfg, j, group.m)
    kj, vj = take(k0, k1)
    if local is not None:
        idx = stage(np.asarray(local, dtype=np.int64), kj.device)
        with group.on(j):
            kj, vj = kj.index_select(2, idx), vj.index_select(2, idx)
    return kj, vj


def _tp_kv(group, k: torch.Tensor, v: torch.Tensor, j: int, cfg: ModelConfig):
    """The home's K/V heads that shard ``j``'s query heads use, sent to its
    device (``_tp_kv_heads``)."""
    return _tp_kv_heads(group, j, cfg, lambda k0, k1: (group.send(k[:, :, k0:k1], j),
                                                       group.send(v[:, :, k0:k1], j)))


def _tp_attention(group, lps: list, h: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
                  imgs: list | None = None):
    """One attention layer over the prompt: each shard attends with its
    query heads, then its rows of wo; returns (out [B, S, d] on the home,
    (k, v) [B, Sk, K, hd] on the home, for the cache). With ``imgs`` the
    gated cross attention (``attn_forward``'s cross branch): non-causal,
    key positions zero, the reduced output gated by ``tanh(gate)`` on the
    home after its single rounding."""
    cross = imgs is not None
    name = "xattn" if cross else "attn"
    qs, k, v = _tp_qkv(group, lps, h, positions, cfg, imgs)
    outs = []
    for j, (lp, q) in enumerate(zip(lps, qs)):
        kj, vj = _tp_kv(group, k, v, j, cfg)
        pos = stage(positions, q.device)
        with group.on(j):
            kpos = torch.zeros(kj.shape[:2], dtype=torch.int32, device=q.device) if cross else pos
            o = L.attention_op(q, kj, vj, pos, kpos, cfg.causal and not cross,
                               chunk_threshold=cfg.long_context_threshold, chunk=cfg.attn_chunk,
                               impl=cfg.attention_impl)
            outs.append(L.matmul_f32(o.reshape(*h.shape[:2], -1), lp[name]["wo"]))
    out = group.reduce(outs, h.dtype)
    return (L.gated(lps[0][name], out) if cross else out), (k, v)


def _tp_mla(group, lps: list, h: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig):
    """One MLA layer over the prompt: the latents every head shares (``cq``,
    ``ckv``, the roped ``k_rope``) computed on the home and sent to each
    shard, which attends with its heads (``mla_attend`` on its head-aligned
    wuq/wuk/wuv columns) and multiplies by its rows of wo in float32; the
    partials reduced on the home. Returns (out [B, S, d], (ckv, k_rope) on
    the home, for the cache)."""
    cq, ckv, k_rope = L.mla_latents(lps[0]["attn"], h, positions, cfg)
    outs = []
    for j, lp in enumerate(lps):
        cqj, ckvj, krj = (group.send(t, j) for t in (cq, ckv, k_rope))
        with group.on(j):
            o = L.mla_attend(lp["attn"], cqj, ckvj, krj, stage(positions, cqj.device), cfg)
            outs.append(L.matmul_f32(o, lp["attn"]["wo"]))
    return group.reduce(outs, h.dtype), (ckv, k_rope)


# The cache leaves of an attention kind's K/V (MLA's latents).
_KV = {"self": ("k", "v"), "shared": ("shared_k", "shared_v"), "mla": ("ckv", "krope")}


def _tp_layer(group, lps: list, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
              kind: str = "self"):
    """A decoder layer (or the hybrid's shared block) over the prompt
    (``_dense_layer``, ``_shared_block``): (x, (k, v)), MLA's (x, (ckv,
    k_rope)) for ``kind`` "mla"."""
    attend = _tp_mla if kind == "mla" else _tp_attention
    a, kv = attend(group, lps, L.rmsnorm(x, lps[0]["ln1"], cfg.norm_eps), positions, cfg)
    x = x + a
    return x + _tp_ffn(group, lps, L.rmsnorm(x, lps[0]["ln2"], cfg.norm_eps), cfg), kv


# The dim of each SSM state that the shards split: the channels, the heads.
_STATE_DIM = {"conv_x": -1, "conv_b": -1, "conv_c": -1, "ssm": 1}


def _tp_mamba(group, lps: list, x: torch.Tensor, cfg: ModelConfig, own: list | None = None):
    """A mamba layer on the home's ``x`` over the group (``_mamba_layer``):
    each shard its channel block of B and C (joined on the home, sent whole
    to every shard), its heads' SSD (``own`` None: the prefill, from zero
    states) or recurrent step (``own``: each shard's states,
    ``_tp_state_views``), its sum of squares of ``y · silu(z)`` (summed on
    the home in shard order into the ``rsqrt`` of the whole ``d_inner``'s
    mean square, sent back) and its rows of ``out`` in float32, reduced on
    the home. Returns (x, [shard] new states on its device)."""
    from repro_torch.distributed.tensor_parallel import ssm_channel_range, ssm_head_range

    hs = group.broadcast(L.rmsnorm(x, lps[0]["ln"], cfg.norm_eps))
    states = own or [{}] * group.m
    bs, cs, new = [], [], []
    for j, (lp, hj, st) in enumerate(zip(lps, hs, states)):
        with group.on(j):
            b, c, ncb, ncc = SSM.bc_block(lp["ssm"], hj, *ssm_channel_range(cfg, j, group.m),
                                          st.get("conv_b"), st.get("conv_c"))
        bs.append(b)
        cs.append(c)
        new.append({"conv_b": ncb, "conv_c": ncc})
    bb, cc = group.broadcast(group.join(bs)), group.broadcast(group.join(cs))
    heads = SSM.heads_step if own else SSM.heads_forward
    gzs, sums = [], []
    for j, (lp, hj, st) in enumerate(zip(lps, hs, states)):
        with group.on(j):
            gz, ncx, final = heads(lp["ssm"], hj, cfg, *ssm_head_range(cfg, j, group.m), bb[j],
                                   cc[j], st.get("conv_x"), st.get("ssm"))
            sums.append(SSM.gate_sumsq(gz))
        gzs.append(gz)
        new[j].update(conv_x=ncx, ssm=final)
    total = group.reduce(sums, torch.float32)
    rstds = group.broadcast(torch.rsqrt(total / cfg.d_inner + cfg.norm_eps))
    parts = []
    for j, (lp, gz, rstd) in enumerate(zip(lps, gzs, rstds)):
        with group.on(j):
            parts.append(SSM.gated_rows(lp["ssm"], gz, rstd))
    return x + group.reduce(parts, x.dtype), new


def _tp_state_index(cfg: ModelConfig, key: str, ndim: int, j: int, m: int, i: int, lo: int,
                    hi: int) -> tuple:
    """The region of model shard ``j``'s block of mamba layer ``i``'s state
    ``key`` (a stacked ``ndim``-dim leaf), rows ``lo .. hi - 1``: its heads
    of ``ssm`` and channels of ``conv_x`` (``ssm_head_range``), its channels
    of ``conv_b``/``conv_c`` (``ssm_channel_range``)."""
    from repro_torch.distributed.tensor_parallel import ssm_channel_range, ssm_head_range

    h0, h1 = ssm_head_range(cfg, j, m)
    span = {"conv_x": (h0 * cfg.ssm_head_dim, h1 * cfg.ssm_head_dim), "ssm": (h0, h1)}
    index = [slice(i, i + 1), slice(lo, hi)] + [slice(None)] * (ndim - 2)
    index[_STATE_DIM[key] % (ndim - 1) + 1] = slice(*span.get(key, ssm_channel_range(cfg, j, m)))
    return tuple(index)


def _tp_state_views(group, j: int, states: dict, i: int, lo: int, hi: int, cfg: ModelConfig):
    """Shard ``j``'s blocks of mamba layer ``i``'s placed states for rows
    ``lo .. hi - 1`` (``_tp_state_index``), each a view of the block its own
    mesh position holds (``ShardedTensor.view_at``): nothing moves."""
    return {k: leaf.view_at(group.positions[j],
                            _tp_state_index(cfg, k, leaf.ndim, j, group.m, i, lo, hi))[0]
            for k, leaf in states.items()}


def _tp_mamba_decode(group, lps: list, x: torch.Tensor, cache: dict, i: int, lo: int, hi: int,
                     cfg: ModelConfig) -> torch.Tensor:
    """One token of mamba layer ``i`` for cache rows ``lo .. hi - 1`` over
    their model group (``_tp_mamba`` on ``_tp_state_views``): each shard's
    new states written back into its own blocks (promoted as
    ``_put_placed`` promotes)."""
    states = cache["ssm"]
    own = [_tp_state_views(group, j, states, i, lo, hi, cfg) for j in range(group.m)]
    x, new = _tp_mamba(group, lps, x, cfg, own)
    for j, st in enumerate(new):
        for k, t in st.items():
            index = _tp_state_index(cfg, k, states[k].ndim, j, group.m, i, lo, hi)
            _put_placed(states, k, t[None], [sl.start or 0 for sl in index])
    return x


def _tp_cross(group, cps: list, x: torch.Tensor, positions: torch.Tensor, imgs: list,
              cfg: ModelConfig):
    """The vlm's gated cross-attention layer over the group
    (``_cross_layer``): (x, (xk, xv) joined on the home)."""
    a, xkv = _tp_attention(group, cps, L.rmsnorm(x, cps[0]["ln1"], cfg.norm_eps), positions,
                           cfg, imgs)
    x = x + a
    return x + _tp_mlp(group, cps, L.rmsnorm(x, cps[0]["ln2"], cfg.norm_eps)), xkv


def _tp_self_layer(group, lps: list, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    return _tp_layer(group, lps, x, positions, cfg)[0]


def _tp_encode(group, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """The audio encoder's residual stream after its layers, on the group's
    home: the frame projection by column blocks, then ``_tp_walk``'s "self"
    layers (non-causal attention, ``_tp_mlp``), nothing written to a cache.
    Under autograd each layer runs under ``_remat``'s policy."""
    x = _tp_frontend(group, batch["frames"])
    positions = _positions(*x.shape[:2], group.home)
    layer = _remat(_tp_self_layer, cfg) if torch.is_grad_enabled() else _tp_self_layer
    for _, lps, _ in _tp_walk(group, cfg):
        x = layer(group, lps, x, positions, cfg)
    return x


def forward_tp(group, batch: dict, cfg: ModelConfig, out) -> torch.Tensor:
    """``forward_train``'s logits [B, S, vocab] f32 on ``out``, computed by
    the model group (the module docstring): the audio encoder, whose
    tensor-parallel forward is its prefill and, under autograd, its train
    step's. The other families' tensor-parallel forwards fill a cache
    (``prefill_tp``) and train on gathered parameters."""
    if cfg.family != "audio":
        raise ValueError(f"forward_tp runs the audio encoder, not the {cfg.family} family")
    return _tp_logits(group, _tp_encode(group, batch, cfg), cfg, out)


def loss_tp(group, batch: dict, cfg: ModelConfig):
    """``loss_fn`` over a model group: ``forward_tp``'s logits on the
    group's home and the masked cross entropy there. Returns ``(loss,
    {"ce_loss": loss})``."""
    loss = _cross_entropy(forward_tp(group, batch, cfg, group.home), batch, cfg)
    return loss, {"ce_loss": loss}


def prefill_tp(group, batch: dict, cache: dict, cfg: ModelConfig, out):
    """``forward_prefill`` of one data-parallel shard over its model group
    (the module docstring): ``cache`` is the shard's dense cache on the
    group's home, filled in place (the audio encoder has none: its layers
    are ``forward_tp``'s, the logits taken at the last position alone).
    Returns the last logits [B, vocab] f32 on ``out``."""
    if cfg.family == "audio":
        return _tp_logits(group, _tp_encode(group, batch, cfg)[:, -1:], cfg, out)[:, 0]
    x = _tp_embed(group, batch["tokens"])
    positions = _positions(*x.shape[:2], group.home)
    imgs = _tp_image_tokens(group, batch["image_embeds"], x.dtype) if cfg.family == "vlm" else None
    for lead, lps, kind in _tp_walk(group, cfg):
        if kind == "mamba":
            x, new = _tp_mamba(group, lps, x, cfg)
            _put_states(cache, lead[0], {k: group.join([st[k] for st in new], dim=d)
                                         for k, d in _STATE_DIM.items()})
        elif kind == "cross":
            x, (xk, xv) = _tp_cross(group, lps, x, positions, imgs, cfg)
            cache["xk"][lead] = xk
            cache["xv"][lead] = xv
        else:
            x, kv = _tp_layer(group, lps, x, positions, cfg, kind)
            for name, new in zip(_KV[kind], kv):
                _fill_rows(cache[name][lead], new)
    return _tp_logits(group, x[:, -1:], cfg, out)[:, 0]


def prefill_placed_tp(shards: list, cache: dict, cfg: ModelConfig, home):
    """``prefill_placed`` on the tensor-parallel path: ``shards`` is ``[(row
    offset, model group, batch part)]``. Returns (last logits [B, vocab] f32
    on ``home``, cache)."""
    seq = _cache_seq(cache)
    logits = []
    for lo, group, part in shards:
        own = cache_zeros(cfg, _first_leaf(part).shape[0], seq, group.home)
        logits.append(prefill_tp(group, part, own, cfg, home))
        _scatter_rows(cache, own, lo)
        del own
    return torch.cat(logits), cache


def _tp_attn_decode(group, lps: list, h: torch.Tensor, pos: int, cache: dict, names: tuple,
                    lead: tuple, row: int, lo: int, cfg: ModelConfig) -> torch.Tensor:
    """One decode attention layer of a cache row over its model group: the
    projections by column blocks, the token's K/V written whole at the
    layer ``lead`` of the stacked cache leaves ``names`` (``k``/``v``,
    ``shared_k``/``shared_v``), the joined query's partials a sequence block
    (on the shard holding it), and the combined output's head blocks
    through each shard's rows of wo."""
    positions = torch.full((h.shape[0], 1), pos, dtype=torch.int32, device=h.device)
    qs, k, v = _tp_qkv(group, lps, h, positions, cfg)
    q = group.join(qs, dim=2)
    kl, vl = cache[names[0]], cache[names[1]]
    _write_token(kl, lead, lo, pos, k)
    _write_token(vl, lead, lo, pos, v)
    o = _combine_blocks(lambda q_, kb, vb, s: L.attn_partial(q_, kb, vb, s, pos), group.home,
                        (q,), (kl, vl), lead, row, group)
    o = L.combined_heads(o, h.dtype)
    width = o.shape[-1] // group.m
    outs = []
    for j, lp in enumerate(lps):
        oj = group.send(o[..., j * width:(j + 1) * width], j)
        with group.on(j):
            outs.append(L.matmul_f32(oj, lp["attn"]["wo"]))
    return group.reduce(outs, h.dtype)


def _tp_mla_decode(group, lps: list, h: torch.Tensor, pos: int, cache: dict, lead: tuple,
                   row: int, lo: int, cfg: ModelConfig) -> torch.Tensor:
    """One decode MLA layer of a cache row over its model group: the
    token's latents on the home, written at ``pos`` into ``ckv``/``krope``;
    ``cq`` sent to each shard, which returns the absorbed ``q_lat`` and
    roped ``q_rope`` of its heads (joined on the home); each latent cache
    block's partial on the shard holding it (``_combine_blocks``: the cache
    does not move); the combined latent's heads (``mla_head_range``) sent
    to their shard, through its wuv columns and rows of wo in float32,
    reduced on the home."""
    from repro_torch.distributed.tensor_parallel import mla_head_range

    positions = torch.full((h.shape[0], 1), pos, dtype=torch.int32, device=h.device)
    cq, ckv, k_rope = L.mla_latents(lps[0]["attn"], h, positions, cfg)
    _write_token(cache["ckv"], lead, lo, pos, ckv)
    _write_token(cache["krope"], lead, lo, pos, k_rope)
    q_lats, q_ropes = [], []
    for j, (lp, cqj) in enumerate(zip(lps, group.broadcast(cq))):
        with group.on(j):
            q_lat, q_rope = L.mla_decode_query(lp["attn"], cqj, pos, cfg)
        q_lats.append(q_lat)
        q_ropes.append(q_rope)
    lat = _combine_blocks(
        lambda ql, qr, cb, kb, s: L.mla_partial(ql, qr, cb, kb, s, pos, cfg), group.home,
        (group.join(q_lats, dim=2), group.join(q_ropes, dim=2)), (cache["ckv"], cache["krope"]),
        lead, row, group).to(h.dtype)
    outs = []
    for j, lp in enumerate(lps):
        lj = group.send(lat[:, slice(*mla_head_range(cfg, j, group.m))], j)
        with group.on(j):
            outs.append(L.matmul_f32(L.mla_latent_out(lp["attn"], lj, cfg, h.dtype),
                                     lp["attn"]["wo"]))
    return group.reduce(outs, h.dtype)


def _tp_cross_decode(group, cps: list, h: torch.Tensor, pos: int, cache: dict, gi: int, lo: int,
                     hi: int, cfg: ModelConfig) -> torch.Tensor:
    """One token's gated cross attention of cache rows ``lo .. hi - 1``
    over their model group (``cross_decode``): each shard its query heads
    from its wq columns, attending by the plain path to its KV heads of
    group ``gi``'s image K/V, read from the copy its own device holds
    (``xk``/``xv`` are replicated over 'model': nothing moves), then its
    rows of wo in float32; the partials reduced and gated on the home."""
    outs = []
    for j, (cp, hj) in enumerate(zip(cps, group.broadcast(h))):
        def own_copy(k0, k1, at=group.positions[j]):
            index = (slice(gi, gi + 1), slice(lo, hi), slice(None), slice(k0, k1))
            return cache["xk"].view_at(at, index)[0], cache["xv"].view_at(at, index)[0]

        xk, xv = _tp_kv_heads(group, j, cfg, own_copy)
        with group.on(j):
            o = L.cross_decode_heads(cp["xattn"], hj, pos, xk, xv, cfg)
            outs.append(L.matmul_f32(o, cp["xattn"]["wo"]))
    return L.gated(cps[0]["xattn"], group.reduce(outs, h.dtype))


def decode_row_tp(group, cache: dict, token: torch.Tensor, pos: int, row: int, lo: int,
                  cfg: ModelConfig, out) -> torch.Tensor:
    """``decode_step`` of cache row ``row`` (rows from ``lo``; ``token`` on
    the group's home) over its model group. Returns its logits [rows,
    vocab] f32 on ``out``."""
    x = _tp_embed(group, token)
    hi = lo + x.shape[0]
    for lead, lps, kind in _tp_walk(group, cfg):
        if kind == "mamba":
            x = _tp_mamba_decode(group, lps, x, cache, lead[0], lo, hi, cfg)
            continue
        h = L.rmsnorm(x, lps[0]["ln1"], cfg.norm_eps)
        if kind == "cross":
            x = x + _tp_cross_decode(group, lps, h, pos, cache, lead[0], lo, hi, cfg)
        elif kind == "mla":
            x = x + _tp_mla_decode(group, lps, h, pos, cache, lead, row, lo, cfg)
        else:
            x = x + _tp_attn_decode(group, lps, h, pos, cache, _KV[kind], lead, row, lo, cfg)
        x = x + _tp_ffn(group, lps, L.rmsnorm(x, lps[0]["ln2"], cfg.norm_eps), cfg)
    return _tp_logits(group, x, cfg, out)[:, 0]


def decode_placed_tp(blocks, mesh, cache: dict, token: torch.Tensor, pos: int, cfg: ModelConfig,
                     home):
    """``decode_placed`` on the tensor-parallel path: ``blocks`` the
    ``ModelBlocks`` gathered on ``mesh``. Returns (logits [B, vocab] f32 on
    ``home``, cache)."""
    from repro_torch.distributed.tensor_parallel import model_group

    logits = []
    for row, lo, hi, dev, at in _cache_rows(cache):
        group = model_group(blocks, mesh, at)
        logits.append(decode_row_tp(group, cache, stage(token[lo:hi], dev), pos, row, lo, cfg,
                                    home))
    return torch.cat(logits), cache
