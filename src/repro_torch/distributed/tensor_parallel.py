"""Tensor-parallel compute over a mesh's 'model' axis: serving the decoders
and the audio encoder, and the audio encoder's training step.

The reference gets this compute from GSPMD: on the "tp" profile
(``src/repro/distributed/ctx.py:34-52``) it places wq/wk/wv and the MLP's
wi_gate/wi_up by columns over 'model', wo by rows, tok_embed and lm_head by
vocab, the MoE's experts by their expert dim, the VLM's image projection
by columns, a Mamba2 layer's ``in_z``/``in_x``/``in_dt`` by columns,
``conv_x``, ``a_log``, ``d_skip``, ``dt_bias`` and ``gate_norm`` by channel
or head and ``out`` by rows (``src/repro/models/ssm.py:28-47``), and its
layer code pins the activations to those blocks
(``src/repro/models/layers.py:87-97``, ``:181-196``, ``:280-296``,
``:407-417``; ``src/repro/models/moe.py:69-85``; MLA's wuq/wuk/wuv by
columns and wo by rows, ``:309-322``, its latent cache by sequence,
``src/repro/models/model.py:716-717``, ``layers.py:380-381``;
``src/repro/models/model.py:123``; the SSD's heads over 'tp',
``src/repro/models/ssm.py:171-174``; the audio encoder's frame projection
by columns, ``src/repro/models/model.py:118-119``, its layers as a dense
decoder's, in its train step too, ``src/repro/launch/steps.py:28``). The
port is single-controller and eager, so it writes the schedule out: this
module holds the blocks and the moves, ``models/model.py`` the layer loops
(``prefill_placed_tp``, ``decode_placed_tp``, ``forward_tp``) and
``launch/steps.py`` the train step's gradients.

Which configs take it: ``serves_tensor_parallel(cfg, mesh)``, the one place
that decides. On the "tp" profile and a mesh with a 'model' axis: the
dense, MoE and VLM families with standard (GQA) attention when its size
divides the query heads and, for the MoE, the experts (deepseek-67b,
qwen1.5-110b, moonshot-v1-16b-a3b, dbrx-132b, llama-3.2-vision-90b); the
SSM family when it divides the SSM heads (mamba2-780m); the hybrid when it
divides the SSM heads and the shared block's query heads (zamba2-7b); a
MLA decoder when it is no larger than the heads and divides the
columns of wuq/wuk/wuv, the rows of wo and the MLP's columns, whether or not
it divides the heads (minicpm3-4b: 40 heads on 16 shards); the audio
encoder when it divides the heads (hubert-xlarge: 16 heads); a smoke config
pinned ``parallelism="tp"`` likewise. Every other config (the "dp"
profile, a 'model' axis the heads or blocks refuse) serves on the gathered
path: every parameter gathered whole on each device.
``trains_tensor_parallel(cfg, mesh)`` decides for the train step: the
audio encoder where it serves tensor-parallel. Every other family trains
on gathered parameters.

What model shard ``j`` of ``m`` holds (``gather_model_blocks``): the ``j``-th
'model' block of every leaf whose spec splits a dim over 'model', gathered
over the other axes ('data': the ZeRO-3 gather), but MLA's wuq/wuk/wuv
columns and wo rows, which it reads head-aligned (``mla_head_range``'s
heads; where ``m`` does not divide the heads that region crosses into a
neighbouring 'model' block, one ``ShardedTensor.read`` still), and every
other leaf (MLA's wdq/wdkv and its norms whole, the
norms, the MoE router, the VLM's cross gates, a Mamba2 layer's
``in_b``/``in_c``/``conv_b``/``conv_c``) whole. For the VLM that is the
image projection's columns, and the self and cross layers' blocks as a
decoder layer's (``layers`` stacked ``[G, per, ...]``, ``cross_layers``
``[G, ...]``); for the hybrid, the shared block's as a decoder layer's.
What it computes, on its device:

  * embedding: the tokens in its vocab range (zeros elsewhere); the
    audio encoder's frame projection: its columns of ``frames @
    frontend``, joined on the home into the residual stream;
  * attention: its ``H / m`` query heads (``head_range``) from its column
    blocks of wq (and bq); its column blocks of wk/wv (bk/bv) are joined on
    the group's home, roped there, and each shard takes the KV heads its
    query heads use (``kv_block``: ``q // (H / K)``; a shard's query heads
    may share one KV head with another shard's when K does not divide m);
    then its rows of wo; causal but for the audio encoder's;
  * MLA (``mla_head_range``: heads ``j H // m .. (j + 1) H // m``, 2 or 3
    of minicpm3's 40 on 16 shards): the home computes the latents every
    head shares (``cq``, ``ckv``, the roped ``k_rope``) and sends them to
    each shard, which attends with its heads (q from its wuq columns, the
    rope part roped; k and v from its wuk/wuv columns of ``ckv``, the
    shared ``k_rope`` appended to each k) and multiplies by its rows of wo;
    the home writes the latents into the cache. At decode the home sends
    ``cq``; each shard returns its heads' absorbed queries (``q_nope`` through
    its wuk columns) and roped ``q_rope``, joined on the home; each latent
    cache block's partial runs on the shard whose mesh position holds it
    (the latent cache splits its sequence over 'model': no part of it
    moves); the combined latent's heads go back to their shards, through
    their wuv columns and wo rows;
  * MLP: its columns of wi_gate/wi_up and its rows of wo;
  * MoE: its ``E / m`` experts (``expert_range``). The home routes the
    group's tokens once (router, top-k, slots and drops over the whole
    routing group, ``models/moe.py::plan``) and sends each shard the
    tokens and the small routing tensors (gates, experts, slots, ``[ng, g,
    k]`` each); the shard builds the dispatch and combine one-hots of its
    own experts and returns its float32 share of ``y``;
  * the VLM's image tokens: its columns of ``image_embeds @ img_proj``,
    once a prefill; the home joins them and sends them whole to every
    shard;
  * a VLM cross layer: its query heads (not roped) from its wq columns,
    its wk/wv columns of the image tokens, joined on the home (not roped)
    and its KV heads taken as above, non-causal attention, its rows of wo;
    the home gates the reduced output (``tanh(gate)``) and writes the
    joined image K/V into the cache. At decode a shard reads its KV heads
    of the image K/V from the copy its own device holds (the cache's
    ``xk``/``xv`` are replicated over 'model'): nothing moves;
  * a Mamba2 layer (``ssm_head_range``: its ``H / m`` SSM heads, their
    columns of ``in_z``/``in_x``/``in_dt``, channels of ``conv_x`` and
    ``a_log``/``dt_bias``/``d_skip``): its channel block
    (``ssm_channel_range``) of B and C from its columns of the replicated
    ``in_b``/``in_c``/``conv_b``/``conv_c`` and its block of their conv
    states (the conv is depthwise), joined on the home and sent whole to
    every shard; the SSD (prefill) or the recurrent step (decode) over its
    heads; ``y · silu(z)`` rounded to the run's dtype, as one device's; its
    float32 sum of squares ``[B, L, 1]`` to the home, which sums them in
    shard order, divides by the whole ``d_inner`` and sends back the
    ``rsqrt``; its channels scaled by it and its ``gate_norm`` block,
    rounded as ``rmsnorm`` rounds, then its rows of ``out`` in float32. At
    decode it reads and writes its own head block of the ``ssm`` state and
    its channel blocks of the conv states in the copy its own mesh position
    holds (the cache splits them over 'model' so): nothing of the state
    moves;
  * the hybrid's shared block: a decoder layer's attention and MLP as
    above, its K/V in ``shared_k``/``shared_v``;
  * logits: its vocab columns of lm_head (``tok_embed``'s rows when tied).

A row-parallel output (wo's rows, an expert block's share of the MoE's
``y``) is a float32 ``[B, S, d]`` partial a shard (never rounded to the
run's dtype: ``models/layers.py::matmul_f32``, ``bmm_f32``);
``ModelGroup.reduce`` sums them in float32 in shard order on the home device
and casts once, so a bf16 run rounds each sum once, as one device's product
does. The
residual stream, the norms, the routing and the cache writes live on the
home (shard 0's device). Every move between the group's shards goes through
``runtime/staging.stage`` and adds its bytes to ``ModelGroup.moved`` (bytes
into each shard): what the dry run records as the step's activation
collectives; under autograd ``ModelGroup.sent`` counts the bytes a shard
sent that take a gradient, which the backward brings back into it.

The train step (``launch/steps.py::sharded_loss_and_grads``) runs the same
forward under autograd (``models/model.py::forward_tp``) on each model
shard's blocks as leaves, and reduces each shard's gradient of its model
block into the gradient spec's blocks that lie inside that block; a leaf
every shard holds whole (a norm) takes the sum
of the shards' gradients of it, which only the home computes with. A shard's own work runs in ``ModelGroup.on(j)``: for shards
other than the home a ``cost_scope(shard_scope(j))``, whose name holds
``SHARD_SCOPE``. The dry run's counter skips those, so that it counts the
home shard's step, the one that bounds the group's where every shard
computes as much (it alone routes, reduces, joins and runs the residual
stream); where a shard computes more heads than the home (MLA), it also
counts that shard's own work alone (``step_cost(only=shard_scope(j))``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.analysis.hlo_cost import cost_scope
from repro_torch.distributed.ctx import arch_profile
from repro_torch.distributed.sharding import ShardedTensor, _entry_axes
from repro_torch.models.params import tree_leaves
from repro_torch.runtime.staging import stage

__all__ = [
    "MODEL",
    "SHARD_SCOPE",
    "shard_scope",
    "serves_tensor_parallel",
    "trains_tensor_parallel",
    "model_size",
    "model_dim",
    "block_range",
    "block_spans",
    "head_range",
    "mla_head_range",
    "expert_range",
    "ssm_head_range",
    "ssm_channel_range",
    "kv_block",
    "model_block",
    "map_named",
    "ModelBlocks",
    "gather_model_blocks",
    "first_positions",
    "ModelGroup",
    "model_group",
    "group_positions",
    "reduce_f32",
]

MODEL = "model"
SHARD_SCOPE = "tp_other_shard"  # the cost scope of a shard's own work, the home's excepted


def shard_scope(j: int) -> str:
    """The cost scope of model shard ``j``'s own work (``j`` > 0)."""
    return f"{SHARD_SCOPE}_{j}"


def model_size(mesh) -> int:
    """The size of the mesh's 'model' axis (1 without one)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get(MODEL, 1)


def serves_tensor_parallel(cfg, mesh) -> bool:
    """Whether ``cfg`` serves tensor-parallel on ``mesh`` (module
    docstring): the "tp" profile, a 'model' axis, and the dense, MoE or VLM
    family with GQA attention whose query heads (and the MoE's experts) it
    divides; the dense family with MLA when it is at most the heads and
    divides the columns of wuq/wuk/wuv, the rows of wo and ``d_ff``; the SSM
    family whose SSM heads it divides; the hybrid whose SSM heads and (GQA)
    query heads it divides; the audio encoder whose heads it divides. Every
    other config takes the gathered path."""
    if arch_profile(cfg) != "tp" or MODEL not in mesh.axis_names:
        return False
    m = model_size(mesh)
    if cfg.family == "ssm":
        return cfg.ssm_heads % m == 0
    if cfg.family == "dense" and cfg.attention == "mla":
        sizes = [cfg.n_heads * w for w in _mla_widths(cfg).values()] + [cfg.d_ff]
        return m <= cfg.n_heads and all(n % m == 0 for n in sizes)
    if cfg.family not in ("dense", "moe", "vlm", "hybrid", "audio") or cfg.attention != "gqa":
        return False
    if cfg.family == "hybrid":
        return cfg.ssm_heads % m == 0 and cfg.n_heads % m == 0
    return cfg.n_heads % m == 0 and (cfg.family != "moe" or cfg.n_experts % m == 0)


def trains_tensor_parallel(cfg, mesh) -> bool:
    """Whether ``make_train_step(mesh=)`` computes ``cfg``'s forward and
    backward tensor-parallel on ``mesh`` (each model shard on its blocks):
    the audio encoder where it serves so. Every other config trains on
    parameters gathered whole on each device."""
    return cfg.family == "audio" and serves_tensor_parallel(cfg, mesh)



def model_dim(spec, ndim: int) -> int | None:
    """The dim ``spec`` splits over 'model', or None. A dim split over
    'model' together with another axis raises ``ValueError`` (no schema
    places one so)."""
    entries = tuple(spec) + (None,) * (ndim - len(spec))
    for d, e in enumerate(entries):
        axes = _entry_axes(e)
        if MODEL in axes:
            if axes != (MODEL,):
                raise ValueError(f"spec {spec} splits dim {d} over {axes}: only 'model' alone "
                                 "has model blocks")
            return d
    return None


def block_range(size: int, j: int, m: int) -> tuple[int, int]:
    """``[lo, hi)`` of block ``j`` of a dim of ``size`` split ``m`` ways."""
    if size % m:
        raise ValueError(f"{size} does not split into {m} blocks")
    per = size // m
    return j * per, (j + 1) * per


def head_range(cfg, j: int, m: int) -> tuple[int, int]:
    """Model shard ``j``'s query heads: its columns of wq, ``hd`` each."""
    return block_range(cfg.n_heads, j, m)


def mla_head_range(cfg, j: int, m: int) -> tuple[int, int]:
    """Model shard ``j``'s MLA heads, ``j H // m .. (j + 1) H // m``: its
    head-aligned columns of wuq/wuk/wuv and rows of wo (``block_spans``).
    Where ``m`` does not divide the heads they differ by one at most."""
    return j * cfg.n_heads // m, (j + 1) * cfg.n_heads // m


def _mla_widths(cfg) -> dict:
    """The width of one MLA head along each per-head leaf's 'model' dim."""
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {"wuq": qk, "wuk": cfg.qk_nope_dim, "wuv": cfg.v_head_dim, "wo": cfg.v_head_dim}


def block_spans(cfg, j: int, m: int) -> dict:
    """Leaf name -> model shard ``j``'s ``[lo, hi)`` along the leaf's
    'model' dim where that is not its ``j``-th block: MLA's per-head leaves
    (``layers/attn/wuq`` ..), head-aligned by ``mla_head_range``. Empty for
    every other config."""
    if cfg.attention != "mla":
        return {}
    h0, h1 = mla_head_range(cfg, j, m)
    return {f"layers/attn/{k}": (h0 * w, h1 * w) for k, w in _mla_widths(cfg).items()}


def expert_range(cfg, j: int, m: int) -> tuple[int, int]:
    """Model shard ``j``'s experts: its block of w_gate/w_up/w_down."""
    return block_range(cfg.n_experts, j, m)


def ssm_head_range(cfg, j: int, m: int) -> tuple[int, int]:
    """Model shard ``j``'s SSM heads: ``ssm_head_dim`` columns each of
    ``in_z``/``in_x`` and channels of ``conv_x``, one column of ``in_dt``."""
    return block_range(cfg.ssm_heads, j, m)


def ssm_channel_range(cfg, j: int, m: int) -> tuple[int, int]:
    """Model shard ``j``'s channels of B and C (``ssm_groups · ssm_state``
    of them): the block the cache's conv states place at its mesh position
    when ``m`` divides them (else the states are whole there, and the
    blocks differ by a channel at most)."""
    n = cfg.ssm_groups * cfg.ssm_state
    return j * n // m, (j + 1) * n // m


def kv_block(cfg, j: int, m: int) -> tuple[int, int, list | None]:
    """The KV heads model shard ``j``'s query heads use: ``(k0, k1, local)``,
    heads ``k0 .. k1 - 1``. ``local`` is None when query head ``i`` of the
    shard uses KV head ``k0 + i // ((h1 - h0) / (k1 - k0))``, so the
    kernel's GQA takes the ``k1 - k0`` heads as they are; else it lists
    each query head's KV head (from ``k0``), to expand them to one a query
    head."""
    h0, h1 = head_range(cfg, j, m)
    rep = cfg.n_heads // cfg.n_kv_heads
    heads = [q // rep for q in range(h0, h1)]
    k0, k1 = heads[0], heads[-1] + 1
    local = [k - k0 for k in heads]
    n, kn = h1 - h0, k1 - k0
    if n % kn == 0 and local == [i // (n // kn) for i in range(n)]:
        return k0, k1, None
    return k0, k1, local


def model_block(leaf: ShardedTensor, j: int, device, span: tuple | None = None) -> torch.Tensor:
    """Model block ``j`` of a placed leaf on ``device`` (or the region
    ``span`` of its 'model' dim), gathered over its other axes (a view of
    the block held there when one block holds it); a leaf with no 'model'
    dim whole."""
    d = model_dim(leaf.sharding.spec, leaf.ndim)
    if d is None:
        return leaf.full(device)
    m = leaf.sharding.blocks_per_dim(leaf.ndim)[d]
    index = [slice(None)] * leaf.ndim
    index[d] = slice(*(span or block_range(leaf.shape[d], j, m)))
    return leaf.read(tuple(index), device)


def map_named(fn, tree, *rest, prefix: str = ""):
    """``fn(name, leaf, *rest_leaves)`` over nested dicts in sorted-key
    order, ``name`` the leaf's path (``layers/attn/wq``)."""
    if isinstance(tree, dict):
        return {k: map_named(fn, tree[k], *(r[k] for r in rest), prefix=f"{prefix}{k}/")
                for k in sorted(tree)}
    return fn(prefix.rstrip("/"), tree, *rest)


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


class ModelBlocks(dict):
    """``(device, j)`` -> the parameter tree of model block ``j`` gathered
    there (``gather_model_blocks``): what the tensor-parallel serving steps
    run on. ``bytes_by_position``: mesh position -> the bytes of the tree
    that position computes with."""

    bytes_by_position: dict


def _positions(mesh):
    ax = mesh.axis_names.index(MODEL)
    return [(pos, dev, pos[ax]) for pos, dev in np.ndenumerate(mesh.devices)]


def gather_model_blocks(params, mesh, cfg) -> ModelBlocks:
    """``params`` (placed by ``train_state_specs``) gathered over 'data'
    only: one tree a distinct (device, model block), ``cfg``'s per-head MLA
    leaves head-aligned (``block_spans``)."""
    out = ModelBlocks()
    m = model_size(mesh)
    for _, dev, j in _positions(mesh):
        if (dev, j) not in out:
            spans = block_spans(cfg, j, m)
            out[(dev, j)] = map_named(
                lambda name, leaf: model_block(leaf, j, dev, spans.get(name)), params)
    out.bytes_by_position = {pos: _tree_bytes(out[(dev, j)]) for pos, dev, j in _positions(mesh)}
    return out


def first_positions(leaf: ShardedTensor, dim: int) -> dict:
    """Block index along ``dim`` -> the first mesh position (row-major)
    holding a block with that index."""
    out: dict = {}
    for pos, (_, idx) in leaf.sharding.layout(leaf.ndim).items():
        out.setdefault(idx[dim], pos)
    return out


def reduce_f32(parts, device, dtype) -> torch.Tensor:
    """``sum(parts)`` on ``device``: each part staged there and added in
    float32 in the order given, the sum cast once to ``dtype``."""
    acc = None
    for p in parts:
        p = stage(p, device).float()
        acc = p if acc is None else acc + p
    return acc.to(dtype)


class ModelGroup:
    """The model shards of one data-parallel block: shard ``j``'s device,
    parameter blocks and mesh position (where its copies of the placed
    cache's blocks are read); ``home`` is shard 0's device, where the
    residual stream lives. ``moved[j]`` counts the activation bytes moved
    into shard ``j`` from another shard of the group; ``sent[j]`` the bytes
    shard ``j`` sent to another that take a gradient (the backward brings as
    many back into it)."""

    def __init__(self, devices: list, blocks: list, positions: list):
        self.devices = list(devices)
        self.blocks = list(blocks)
        self.positions = [tuple(p) for p in positions]
        self.m = len(self.devices)
        self.home = self.devices[0]
        self.moved = [0] * self.m
        self.sent = [0] * self.m

    def on(self, j: int):
        """The context of shard ``j``'s own work: ``cost_scope(shard_scope(j))``
        for a shard other than the home."""
        return cost_scope(shard_scope(j)) if j else contextlib.nullcontext()

    def note(self, t: torch.Tensor, src: int, dst: int) -> None:
        """Count ``t`` as moved from shard ``src`` into shard ``dst``."""
        if src != dst:
            self.moved[dst] += t.numel() * t.element_size()
            if t.requires_grad:
                self.sent[src] += t.numel() * t.element_size()

    def send(self, t: torch.Tensor, j: int, src: int = 0) -> torch.Tensor:
        """``t`` (on shard ``src``'s device) on shard ``j``'s device."""
        self.note(t, src, j)
        return stage(t, self.devices[j])

    def collect(self, t: torch.Tensor, j: int) -> torch.Tensor:
        """Shard ``j``'s ``t`` on the home device."""
        return self.send(t, 0, src=j)

    def broadcast(self, t: torch.Tensor) -> list:
        """The home's ``t`` on every shard's device."""
        return [self.send(t, j) for j in range(self.m)]

    def join(self, parts: list, dim: int = -1) -> torch.Tensor:
        """The shards' ``parts`` concatenated along ``dim`` on the home."""
        return torch.cat([self.collect(p, j) for j, p in enumerate(parts)], dim=dim)

    def reduce(self, parts: list, dtype) -> torch.Tensor:
        """The shards' partial sums reduced on the home (``reduce_f32``)."""
        return reduce_f32([self.collect(p, j) for j, p in enumerate(parts)], self.home, dtype)


def model_group(blocks: ModelBlocks, mesh, pos) -> ModelGroup:
    """The group of mesh position ``pos``: the positions that differ from
    it in the 'model' coordinate alone, in model order."""
    positions = group_positions(mesh, pos)
    devices = [mesh.devices[p] for p in positions]
    return ModelGroup(devices, [blocks[(dev, j)] for j, dev in enumerate(devices)], positions)


def group_positions(mesh, pos) -> list:
    """The mesh positions of ``pos``'s model group, in model order."""
    ax = mesh.axis_names.index(MODEL)
    return [tuple(j if a == ax else p for a, p in enumerate(pos)) for j in range(model_size(mesh))]
