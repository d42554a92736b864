"""Dry run of every (arch x shape) cell on the production meshes: what a
device holds and what it runs, counted on meta tensors with no device.

Port of ``src/repro/launch/dryrun.py``. The reference lowers and compiles
each cell's sharded step on 256 / 512 placeholder TPU devices and reads
XLA's memory and cost analyses. The port has no compiler to ask: for each
runnable cell of ``launch/specs.py::CellSpec`` on the duck-typed single
(data 16, model 16) and multi (pod 2, data 16, model 16) meshes, where the
port's specs equal the reference's, it records

  * the bytes a device holds of parameters, optimizer state (train), cache
    (prefill, decode) and batch as ``distributed/lm_sharding.py``'s specs
    place them, against 80 GB (``fits_80GB``). Activations are not counted,
    and neither is the parameter copy the port's sharded steps gather on
    each device (``gathered_params_bytes``, beside it: the whole tree, or on
    the tensor-parallel path the home's 'model' blocks, with
    ``gathered_params_bytes_max_shard`` the most any shard's hold: MLA's
    head-aligned blocks differ by a head);
  * ``analysis/hlo_cost.py::step_cost`` of the step a device runs. Two
    kinds of cells (``PER_DEVICE``, ``PER_DEVICE_TP``):
      - the dense, MLA, MoE, VLM, SSM and hybrid decoders' serving cells
        on the "tp" profile (deepseek-67b, qwen1.5-110b, minicpm3-4b,
        moonshot-v1-16b-a3b, dbrx-132b and llama-3.2-vision-90b at
        prefill_32k and decode_32k, mamba2-780m and zamba2-7b at those and
        long_500k,
        ``distributed/tensor_parallel.py::serves_tensor_parallel``) take the
        tensor-parallel step: one data-parallel shard's step (a row of the
        cache at decode) over its 16 model shards
        (``models/model.py::prefill_tp``, ``decode_row_tp``), run on meta,
        of which the home shard's part is counted (the other shards' work
        skipped, ``tensor_parallel.SHARD_SCOPE``): its 1/16 of the split
        products (heads, columns, experts, vocab, the VLM's image
        projection, the SSM's heads and B/C channels; MLA's heads
        head-aligned, 2 of minicpm3's 40 on the home, 3 on the shards that
        hold the most, ``max_shard_heads``, and its latent cache's
        sequence block at decode), and the MoE's routing, MLA's latent
        projections wdq/wdkv, the reductions of every shard's partials, the
        joins, norms, cross gates, the gated norm's statistic and residual
        stream, which it alone runs; the other shards run the split products
        alone. Where a shard computes more heads than the home (MLA), that
        shard's own work is counted too (``max_shard_step``: its products,
        its gather and the activations moved into it).
        ``group_step_lower_bound_s`` is the larger of the counted steps'
        roofline bounds, the group's. The audio encoder's prefill_32k
        (hubert-xlarge, no cache) takes the same step;
      - the audio encoder's train_4k (``trains_tensor_parallel``) takes the
        tensor-parallel train step: one microbatch's ``loss_tp`` and its
        backward over 16 model shards on meta, remat's recomputation
        included, of which the home shard's part is counted (a backward op
        by the scope of its autograd node), with the float32 accumulation of
        the home's gradient into its blocks, times the reference's
        microbatches, and AdamW once over the device's blocks
        (``_train_tp``);
      - every other cell (the other families' training, the "dp" profile)
        the step of one distinct data-parallel shard, run on its first
        device with every parameter gathered there: the per-device FLOPs
        and bytes are that shard's, not divided by the model axis. Training
        takes the reference's microbatch rule; a microbatch's
        ``loss_and_grads`` and its float32 accumulation into the device's
        gradient blocks are counted once and multiplied by the microbatches
        (identical shapes), AdamW once over the device's blocks;
  * the collective bytes into a device (``analysis/hlo_cost.py::split_bytes``):
    the parameter gather of a step (``all-gather``: the whole tree's, or on
    the tensor-parallel path the 'data' gather of the device's model
    blocks), the activations a tensor-parallel step moves between its model
    shards (``activations``: the most ``ModelGroup.moved`` brings into one
    shard, the home's; in the tensor-parallel train step also the gradients
    its backward brings back into the home, ``ModelGroup.sent``) and, in
    training, each microbatch's gradient reduction into the gradient spec's
    blocks (``reduce-scatter``; on the tensor-parallel path each model
    block's float32 gradient over 'data');
  * ``model_flops`` (global, and the shard's share) and ``roofline_terms``
    over the H100's constants, and the useful-FLOPs ratio.

``run_tcim`` records the sharded triangle count at com-LiveJournal scale
(the reference's 2^21 slices of 2 words, 2^26 pairs) as the port's
replicated plan places it, also without allocating.

Records are JSON files in ``results/dryrun_torch/`` (the reference writes
``results/dryrun/``), one per (arch, shape, mesh), reused unless ``--force``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --tcim
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis.hlo_cost import StepCost, collectives, split_bytes, step_cost
from repro_torch.analysis.roofline import model_flops, roofline_terms
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.shapes import Shape
from repro_torch.distributed.ctx import arch_profile
from repro_torch.distributed.lm_sharding import (
    batch_spec_tree,
    cache_spec_tree,
    dp_size,
    named_tree,
    train_state_specs,
)
from repro_torch.distributed.sharding import zeros
from repro_torch.distributed.tensor_parallel import (
    SHARD_SCOPE,
    ModelGroup,
    block_spans,
    group_positions,
    map_named,
    mla_head_range,
    model_dim,
    model_size,
    serves_tensor_parallel,
    shard_scope,
    trains_tensor_parallel,
)
from repro_torch.launch.specs import META, CellSpec, batch_struct
from repro_torch.launch.steps import MOE_GROUP, loss_and_grads, make_prefill_step, make_serve_step
from repro_torch.models.model import cache_zeros, decode_row_tp, loss_tp, prefill_tp
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_update, cosine_warmup

__all__ = ["DuckMesh", "production_mesh", "cut_depth", "run_cell", "run_tcim", "train_cost",
           "RESULTS_DIR", "DEVICE_BYTES"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
DEVICE_BYTES = 80e9  # an H100's device memory
TAGS = {"attn": "attn_core"}
PER_DEVICE = ("the step of one distinct data-parallel shard, run on its first device with "
              "every parameter gathered there (this cell takes the gathered path, so the "
              "model axis does not divide it)")
PER_DEVICE_TP = ("the home model shard's step of the tensor-parallel path (training: a "
                 "microbatch's forward, recomputation and backward, times the microbatches, "
                 "and AdamW over its blocks): its share of the data-parallel shard's products "
                 "(divided by the model axis; MLA's by its heads), and the MoE's routing, "
                 "MLA's latent projections, the reductions, joins, norms and residual stream "
                 "that it alone runs for the group; "
                 "max_shard_step: a shard that computes more heads (MLA), its own work alone; "
                 "group_step_lower_bound_s: the larger bound")


class DuckMesh:
    """A production mesh as the spec functions read it: axis names and the
    device grid's shape. Its devices are ``device`` (default None: nothing
    is placed; the tensor-parallel decode places its cache on meta ones)."""

    def __init__(self, shape, names, device=None):
        self.devices = np.empty(shape, dtype=object)
        self.devices.fill(device)
        self.axis_names = tuple(names)


def production_mesh(kind: str, device=None) -> DuckMesh:
    if kind == "multi":
        return DuckMesh((2, 16, 16), ("pod", "data", "model"), device)
    return DuckMesh((16, 16), ("data", "model"), device)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _blocks(sh, ndim: int) -> int:
    return math.prod(sh.blocks_per_dim(ndim))


def _held(tree, shardings) -> int:
    """Bytes of one device's blocks of ``tree`` placed by ``shardings``."""
    return sum(_nbytes(t) // _blocks(sh, t.ndim)
               for t, sh in zip(tree_leaves(tree), tree_leaves(shardings)))


def _block_slices(shape, blocks: tuple) -> tuple:
    """The first block's slices of a leaf of ``shape`` split ``blocks`` ways a dim."""
    return tuple(slice(0, d // n) for d, n in zip(shape, blocks))


def _blocks_of(shardings, leaves) -> tuple:
    return tuple(tuple(sh.blocks_per_dim(t.ndim)) for t, sh in zip(leaves, shardings))


def _part(batch: dict, rows: int) -> dict:
    return {k: v[:rows] for k, v in batch.items()}


def _microbatches(cfg, shape, mesh) -> int:
    """The reference's rule (``src/repro/launch/dryrun.py:97-110``)."""
    n_chips = int(np.prod(mesh.devices.shape))
    gb = shape.global_batch
    if arch_profile(cfg) == "dp" and gb % n_chips == 0:
        return 1
    return max(8, gb // dp_size(mesh))


@functools.lru_cache(maxsize=64)
def _microbatch_cost(arch: str, cfg, rows: int, seq: int, grad_blocks: tuple) -> StepCost:
    """One microbatch on a device: ``loss_and_grads`` on ``rows`` rows and
    the float32 accumulation of its gradient into the device's blocks
    (``grad_blocks``: each leaf's blocks a dim)."""
    spec = CellSpec(arch, "train_4k")
    spec.cfg = cfg
    batch = batch_struct(cfg, Shape("microbatch", "train", seq, rows), True)

    def microbatch(params, batch):
        _, _, grads = loss_and_grads(params, batch, cfg)
        for g, blocks in zip(tree_leaves(grads), grad_blocks):
            block = g[_block_slices(g.shape, blocks)].float()
            block.add_(block)  # the running sum's add

    return step_cost(microbatch, spec.params_struct(), batch, tags=TAGS)


def _optimizer_cost(params, opt_blocks: tuple, grad_blocks: tuple) -> StepCost:
    """AdamW over the device's gradient blocks (``_sharded_adamw``): float32
    gradient blocks, the parameters' matching regions, the moments' blocks."""
    def blocks_of(blocks, make):
        it = iter(blocks)
        return tree_map(lambda p: make(p[_block_slices(p.shape, next(it))]), params)

    def f32(b):
        return torch.empty(b.shape, dtype=torch.float32, device=META)

    grads, regions = blocks_of(grad_blocks, f32), blocks_of(grad_blocks, lambda b: b)
    moments = blocks_of(opt_blocks, f32)
    state = {"m": moments, "v": moments, "step": torch.empty((), dtype=torch.int32, device=META)}

    def update(grads, regions, state):
        lr = cosine_warmup(state["step"], peak_lr=AdamWConfig().lr, warmup=100, total=10000)
        adamw_update(grads, regions, state, AdamWConfig(), lr)

    return step_cost(update, grads, regions, state)


def _dp_blocks(shardings: dict, batch: dict) -> int:
    key = "tokens" if "tokens" in batch else "frames"
    return shardings[key].blocks_per_dim(batch[key].ndim)[0]


def train_cost(spec: CellSpec, mesh, microbatches: int | None = None) -> tuple[StepCost, dict]:
    """(cost, info) of a device's train step of ``spec`` on ``mesh``:
    ``microbatches`` by the reference's rule unless given; ``info`` holds
    the bytes a device holds (``held``), the microbatches, the distinct
    data-parallel shards and a microbatch's rows on a device."""
    cfg, shape = spec.cfg, spec.shape
    params, opt, batch = spec.args()
    psh, osh, gsh = (named_tree(mesh, s) for s in train_state_specs(cfg))
    bsh = named_tree(mesh, batch_spec_tree(cfg, mesh, batch))
    mb = microbatches or _microbatches(cfg, shape, mesh)
    n = _dp_blocks(bsh, batch)
    if shape.global_batch % (mb * n):
        raise ValueError(f"{shape.global_batch} rows do not split into {mb} microbatches "
                         f"of {n} data-parallel shards")
    mb_rows = shape.global_batch // mb
    if cfg.family == "moe" and (mb_rows // n * shape.seq) % min(MOE_GROUP, mb_rows * shape.seq):
        n = 1  # the shards would cut a routing group: the microbatch runs on one device
    rows = mb_rows // n
    leaves = tree_leaves(params)
    grad_blocks = _blocks_of(tree_leaves(gsh), leaves)
    cost = mb * _microbatch_cost(spec.arch, cfg, rows, shape.seq, grad_blocks)
    cost = cost + _optimizer_cost(params, _blocks_of(tree_leaves(osh["m"]), leaves), grad_blocks)
    coll = {"all-gather": split_bytes(leaves, tree_leaves(psh)),
            "reduce-scatter": mb * split_bytes(leaves, tree_leaves(gsh))}
    held = {"params": _held(params, psh), "opt_state": _held(opt, osh),
            "grads": sum(t.numel() * 4 // _blocks(sh, t.ndim)  # the float32 accumulator
                         for t, sh in zip(leaves, tree_leaves(gsh))),
            "batch": _held(batch, bsh)}
    info = {"microbatches": mb, "dp_shards": n, "rows_per_microbatch": rows}
    return cost + collectives(coll), {"held": held, **info}


def _serve(spec: CellSpec, mesh) -> tuple[StepCost, dict]:
    cfg, shape = spec.cfg, spec.shape
    params = spec.params_struct()
    cache = spec.cache_struct()
    psh = named_tree(mesh, train_state_specs(cfg)[0])
    csh = named_tree(mesh, cache_spec_tree(cfg, mesh, cache))
    if shape.kind == "prefill":
        batch = batch_struct(cfg, shape, with_labels=False)
        bsh = named_tree(mesh, batch_spec_tree(cfg, mesh, batch))
        n = _dp_blocks(bsh, batch)
        rows = shape.global_batch // n
        cost = step_cost(make_prefill_step(cfg), params, cache_zeros(cfg, rows, shape.seq, META),
                         _part(batch, rows), tags=TAGS)
        held_batch = _held(batch, bsh)
    else:
        # decode: one data-parallel row of the cache (``decode_placed``)
        dp = dp_size(mesh)
        n = dp if shape.global_batch % dp == 0 else 1
        rows = shape.global_batch // n
        token = torch.empty((rows, 1), dtype=torch.int32, device=META)
        cost = step_cost(make_serve_step(cfg), params, cache_zeros(cfg, rows, shape.seq, META),
                         token, shape.seq - 1, tags=TAGS)
        held_batch = shape.global_batch // n * 4
    coll = {"all-gather": split_bytes(tree_leaves(params), tree_leaves(psh))}
    held = {"params": _held(params, psh), "cache": _held(cache, csh), "batch": held_batch}
    return cost + collectives(coll), {"held": held, "dp_shards": n, "rows": rows}


def _block_struct(t, sh, span: tuple | None = None) -> torch.Tensor:
    """A meta leaf's model block (its 'model' dim divided, or ``span`` of
    it)."""
    shape = list(t.shape)
    d = model_dim(sh.spec, t.ndim)
    if d is not None:
        shape[d] = span[1] - span[0] if span else shape[d] // sh.blocks_per_dim(t.ndim)[d]
    return torch.empty(shape, dtype=t.dtype, device=META)


def _shard_blocks(cfg, params, psh, m: int) -> list:
    """Each model shard's meta blocks of ``params`` (its own: MLA's
    head-aligned blocks differ by a head)."""
    out = []
    for j in range(m):
        spans = block_spans(cfg, j, m)
        out.append(map_named(lambda name, t, sh: _block_struct(t, sh, spans.get(name)),
                             params, psh))
    return out


def _data_blocks(params, psh, m: int) -> list:
    """Each leaf's blocks within a model block: what a device's model block
    is split into over the other axes ('data')."""
    return [_blocks(sh, t.ndim) // (1 if model_dim(sh.spec, t.ndim) is None else m)
            for t, sh in zip(tree_leaves(params), tree_leaves(psh))]


def _gathered(blocks, others: list, itemsize: int | None = None) -> float:
    """The bytes a 'data' gather of a device's model ``blocks`` brings into
    it (each ``others`` ways split), or a reduction of their gradients
    (``itemsize`` bytes an element) takes out of it."""
    return sum((b.numel() * itemsize if itemsize else _nbytes(b)) * (k - 1) / k
               for b, k in zip(tree_leaves(blocks), others))


def _train_tp(spec: CellSpec, mesh) -> tuple[StepCost, dict]:
    """``train_cost`` on the tensor-parallel path
    (``launch/steps.py::_tp_shard_grads``): one microbatch's
    ``loss_tp`` and backward over a group of the mesh's model shards on
    meta (remat's recomputation included), of which the home shard's part
    is counted (backward ops by their autograd node's scope), with the
    float32 accumulation of the home's gradient into its blocks, times the
    microbatches; AdamW once over the device's blocks. The collectives: the
    'data' gather of the device's model blocks (once a step), each
    microbatch's reduction of their float32 gradients into the device's
    blocks, and the activations moved into the home: the forward's and the
    recomputation's (``ModelGroup.moved``) and the gradients the backward
    brings back of what it sent (``ModelGroup.sent``, read after the
    forward)."""
    cfg, shape = spec.cfg, spec.shape
    params, opt, batch = spec.args()
    psh, osh, gsh = (named_tree(mesh, s) for s in train_state_specs(cfg))
    bsh = named_tree(mesh, batch_spec_tree(cfg, mesh, batch))
    mb = _microbatches(cfg, shape, mesh)
    n = _dp_blocks(bsh, batch)
    if shape.global_batch % (mb * n):
        raise ValueError(f"{shape.global_batch} rows do not split into {mb} microbatches "
                         f"of {n} data-parallel shards")
    rows = shape.global_batch // mb // n
    m = model_size(mesh)
    shard_blocks = [tree_map(lambda t: t.requires_grad_(), b)
                    for b in _shard_blocks(cfg, params, psh, m)]
    group = ModelGroup([META] * m, shard_blocks, group_positions(mesh, (0,) * mesh.devices.ndim))
    leaves = tree_leaves(params)
    others = _data_blocks(params, psh, m)
    home_grad_blocks = [tuple(k // (m if d == model_dim(sh.spec, t.ndim) else 1)
                              for d, k in enumerate(sh.blocks_per_dim(t.ndim)))
                        for t, sh in zip(leaves, tree_leaves(gsh))]
    part = _part(batch, rows)
    sent = []

    def microbatch():
        loss, _ = loss_tp(group, part, cfg)
        sent.append(group.sent[0])
        home = tree_leaves(group.blocks[0])
        grads = torch.autograd.grad(loss, [t for b in group.blocks for t in tree_leaves(b)],
                                    allow_unused=True)
        for g, blocks in zip(grads[:len(home)], home_grad_blocks):
            if g is not None:
                block = g[_block_slices(g.shape, blocks)].float()
                block.add_(block)  # the running sum's add

    cost = mb * step_cost(microbatch, tags=TAGS, skip=SHARD_SCOPE)
    cost = cost + _optimizer_cost(params, _blocks_of(tree_leaves(osh["m"]), leaves),
                                  _blocks_of(tree_leaves(gsh), leaves))
    coll = {"all-gather": _gathered(shard_blocks[0], others),
            "reduce-scatter": mb * _gathered(shard_blocks[0], others, itemsize=4),
            "activations": mb * (group.moved[0] + sent[0])}
    held = {"params": _held(params, psh), "opt_state": _held(opt, osh),
            "grads": sum(t.numel() * 4 // _blocks(sh, t.ndim)
                         for t, sh in zip(leaves, tree_leaves(gsh))),
            "batch": _held(batch, bsh)}
    info = {"held": held, "microbatches": mb, "dp_shards": n, "model_shards": m,
            "rows_per_microbatch": rows,
            "gathered": sum(_nbytes(b) for b in tree_leaves(shard_blocks[0])),
            "gathered_max": max(sum(_nbytes(b) for b in tree_leaves(t)) for t in shard_blocks)}
    return cost + collectives(coll), info


def _serve_tp(spec: CellSpec, mesh, kind: str) -> tuple[StepCost, dict]:
    """``_serve`` on the tensor-parallel path: one data-parallel shard's
    step (a cache row's at decode) over a group of the mesh's model shards
    on meta, of which the home shard's part is counted; the collectives are
    the 'data' gather of a device's model blocks and the activations moved
    into the home, the most any shard receives."""
    cfg, shape = spec.cfg, spec.shape
    params = spec.params_struct()
    cache = spec.cache_struct()
    psh = named_tree(mesh, train_state_specs(cfg)[0])
    csh = named_tree(mesh, cache_spec_tree(cfg, mesh, cache))
    m = model_size(mesh)
    shard_blocks = _shard_blocks(cfg, params, psh, m)
    blocks = shard_blocks[0]
    group = ModelGroup([META] * m, shard_blocks, group_positions(mesh, (0,) * mesh.devices.ndim))
    if shape.kind == "prefill":
        batch = batch_struct(cfg, shape, with_labels=False)
        bsh = named_tree(mesh, batch_spec_tree(cfg, mesh, batch))
        n = _dp_blocks(bsh, batch)
        rows = shape.global_batch // n
        own = cache_zeros(cfg, rows, shape.seq, META)

        def step():
            prefill_tp(group, _part(batch, rows), own, cfg, META)

        held_batch = _held(batch, bsh)
    else:
        dp = dp_size(mesh)
        n = dp if shape.global_batch % dp == 0 else 1
        rows = shape.global_batch // n
        on_meta = production_mesh(kind, META)
        placed = tree_map(lambda t, s: zeros(t.shape, t.dtype, s), cache,
                          named_tree(on_meta, cache_spec_tree(cfg, on_meta, cache)))
        token = torch.empty((rows, 1), dtype=torch.int32, device=META)

        def step():
            decode_row_tp(group, placed, token, shape.seq - 1, 0, 0, cfg, META)

        held_batch = shape.global_batch // n * 4
    with torch.inference_mode():
        cost = step_cost(step, tags=TAGS, skip=SHARD_SCOPE)
    moved = list(group.moved)
    others = _data_blocks(params, psh, m)

    def gather(j: int) -> float:
        """The 'data' gather of shard ``j``'s model blocks into it."""
        return _gathered(shard_blocks[j], others)

    held = {"params": _held(params, psh), "cache": _held(cache, csh), "batch": held_batch}
    info = {"held": held, "dp_shards": n, "model_shards": m, "rows": rows,
            "gathered": sum(_nbytes(b) for b in tree_leaves(blocks)),
            "gathered_max": max(sum(_nbytes(b) for b in tree_leaves(t)) for t in shard_blocks)}
    if cfg.attention == "mla":  # minicpm3 on 16 shards: the home 2 of its 40 heads, others 3
        heads = [h1 - h0 for h0, h1 in (mla_head_range(cfg, j, m) for j in range(m))]
        info["max_shard_heads"] = max(heads)
        k = heads.index(max(heads))
        if k:  # that shard's own work alone, its gather and the activations moved into it
            with torch.inference_mode():
                own = step_cost(step, tags=TAGS, only=shard_scope(k))
            own = own + collectives({"all-gather": gather(k), "activations": moved[k]})
            info["max_shard_step"] = {
                "shard": k, "heads": heads[k], "flops": own.flops,
                "matmul_flops": own.matmul_flops, "bytes": own.bytes,
                "collective_bytes": own.collective_bytes,
                "roofline": roofline_terms(own.flops, own.bytes, own.collective_bytes)}
    return cost + collectives({"all-gather": gather(0), "activations": max(moved)}), info


def cut_depth(cfg, n_layers: int):
    """``cfg`` at ``n_layers`` layers, its hybrid and cross-attention groups
    cut to fit, so that every kind of block still runs."""
    return cfg.scaled(n_layers=n_layers,
                      hybrid_attn_every=min(cfg.hybrid_attn_every, n_layers),
                      cross_attn_every=min(cfg.cross_attn_every, n_layers))


def run_cell(arch: str, shape_name: str, mesh_kind: str, n_layers: int | None = None) -> dict:
    """One cell's record (``n_layers`` cuts the depth, ``cut_depth``)."""
    spec = CellSpec(arch, shape_name)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "kind": spec.shape.kind,
              "skipped": not spec.runs, "skip_reason": spec.skip_reason}
    if not spec.runs:
        return record
    if n_layers is not None:
        spec.cfg = cut_depth(spec.cfg, n_layers)
    cfg = spec.cfg
    mesh = production_mesh(mesh_kind)
    n_chips = int(np.prod(mesh.devices.shape))
    train = spec.shape.kind == "train"
    tensor_parallel = (trains_tensor_parallel if train else serves_tensor_parallel)(cfg, mesh)
    t0 = time.perf_counter()
    if tensor_parallel:
        cost, info = _train_tp(spec, mesh) if train else _serve_tp(spec, mesh, mesh_kind)
    else:
        cost, info = (train_cost if spec.shape.kind == "train" else _serve)(spec, mesh)
    count_s = time.perf_counter() - t0
    held = info.pop("held")
    gathered = info.pop("gathered", None)
    if gathered is None:
        gathered = sum(_nbytes(t) for t in tree_leaves(spec.params_struct()))
    gathered_max = info.pop("gathered_max", gathered)
    info.setdefault("model_shards", 1)
    tokens = spec.shape.global_batch * (spec.shape.seq if spec.shape.kind != "decode" else 1)
    n_active = cfg.active_param_count()
    mf = model_flops(spec.shape.kind, n_active, tokens)
    per_device = mf / (info["dp_shards"] * info["model_shards"])
    record.update({
        "n_chips": n_chips,
        "n_layers": cfg.n_layers,
        "count_s": round(count_s, 2),
        "memory": {**{f"{k}_bytes": v for k, v in held.items()},
                   "placed_bytes": sum(held.values()),
                   "gathered_params_bytes": gathered,
                   "gathered_params_bytes_max_shard": gathered_max,
                   "note": "placed state a device; activations and the step's gathered "
                           "parameter copy (the whole tree, or a tensor-parallel step's model "
                           "blocks) are not in placed_bytes"},
        "fits_80GB": sum(held.values()) <= DEVICE_BYTES,
        "per_device": PER_DEVICE_TP if tensor_parallel else PER_DEVICE,
        **info,
        "flops_per_device": cost.flops,
        "matmul_flops_per_device": cost.matmul_flops,
        "bytes_per_device": cost.bytes,
        "collectives": {"total_bytes": cost.collective_bytes, "by_op": cost.collective_by_op,
                        "unknown_trip_whiles": cost.unknown_trip_whiles,
                        "custom_calls": cost.custom_calls},
        "bytes_by_tag": cost.bytes_by_tag or {},
        "params_total": cfg.param_count(),
        "params_active": n_active,
        "tokens_per_step": tokens,
        "model_flops_global": mf,
        "model_flops_per_device": per_device,
        "roofline": roofline_terms(cost.flops, cost.bytes, cost.collective_bytes),
    })
    if cost.flops > 0:
        record["useful_flops_ratio"] = per_device / cost.flops
    if tensor_parallel:  # the group's step is the longest of its shards'
        steps = [record["roofline"], record.get("max_shard_step", {}).get("roofline", {})]
        record["group_step_lower_bound_s"] = max(r.get("step_lower_bound_s", 0.0) for r in steps)
    return record


# ------------------------------------------------------------------ TCIM

TCIM_SLICES, TCIM_WORDS, TCIM_PAIRS = 1 << 21, 2, 1 << 26  # com-LiveJournal scale


def run_tcim(mesh_kind: str, row_slices: int = TCIM_SLICES, col_slices: int = TCIM_SLICES,
             pairs: int = TCIM_PAIRS, words: int = TCIM_WORDS) -> dict:
    """The sharded count of ``pairs`` slice pairs over stores of
    ``row_slices`` and ``col_slices`` slices of ``words`` words on the mesh,
    as the port's replicated placement runs it (``distributed/tc.py``): both
    stores on every device, the pairs dealt in equal stripes
    (``shard_worklist``: ``ceil(pairs / chips)`` a device, sentinel-padded),
    one fused ``gather_total`` a stripe, one int32 pair read back from each
    device. The reference sizes both stores at 2^21 slices."""
    from repro_torch.kernels.tc_gather_popcount import modeled_hbm_bytes

    mesh = production_mesh(mesh_kind)
    n_chips = int(np.prod(mesh.devices.shape))
    per = -(-max(pairs, 1) // n_chips)
    store = (row_slices + col_slices) * words * 4  # row and column stores, int32 words
    index = 2 * per * 4  # row and column positions, int32
    flops = 3.0 * per * words  # AND, popcount and add a word
    nbytes = modeled_hbm_bytes(per, words, fused=True)
    readback = 8  # the device's [total, out_of_range] int32 pair
    return {
        "arch": "tcim-distributed",
        "shape": f"comlj_{pairs}pairs",
        "mesh": mesh_kind,
        "kind": "tc",
        "skipped": False,
        "skip_reason": "",
        "n_chips": n_chips,
        "placement": "replicated",
        "memory": {"store_bytes": store, "index_bytes": index,
                   "placed_bytes": store + index},
        "pairs_per_device": per,
        "flops_per_device": flops,
        "bytes_per_device": nbytes,
        "collectives": {"total_bytes": readback, "by_op": {"readback": readback}},
        "roofline": roofline_terms(flops, nbytes, readback),
    }


# ------------------------------------------------------------------ CLI


def _result_path(arch: str, shape: str, mesh_kind: str) -> Path:
    return RESULTS_DIR / f"{arch}__{shape}__{mesh_kind}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list(ARCHS) + ["tcim"], default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tcim", action="store_true")
    args = ap.parse_args(argv)

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.tcim or args.arch == "tcim":
        cells = [("tcim", "tc")]
    elif args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("need --all, --tcim, or both --arch and --shape")

    failures = 0
    t_start = time.perf_counter()
    for arch, shape in cells:
        for mk in meshes:
            path = (_result_path("tcim-distributed", "comlj", mk) if arch == "tcim"
                    else _result_path(arch, shape, mk))
            if path.exists() and not args.force:
                rec = json.loads(path.read_text())
                print(f"[{'skip' if rec.get('skipped') else 'cached'}] {arch} x {shape} x {mk}")
                continue
            try:
                rec = run_tcim(mk) if arch == "tcim" else run_cell(arch, shape, mk)
            except Exception:
                failures += 1
                err = traceback.format_exc()
                print(f"[FAIL] {arch} x {shape} x {mk}\n{err}")
                path.write_text(json.dumps({"arch": arch, "shape": shape, "mesh": mk,
                                            "skipped": False, "error": err.splitlines()[-1]},
                                           indent=1))
                continue
            path.write_text(json.dumps(rec, indent=1))
            if rec.get("skipped"):
                print(f"[skip] {arch} x {shape} x {mk}: {rec['skip_reason']}")
            else:
                r = rec["roofline"]
                print(f"[ok]   {arch} x {shape} x {mk} count={rec.get('count_s', 0.0)}s "
                      f"flops/dev={rec['flops_per_device']:.3e} "
                      f"bytes/dev={rec['bytes_per_device']:.3e} "
                      f"coll={rec['collectives']['total_bytes']:.3e}B "
                      f"dominant={r['dominant']}", flush=True)
    print(f"[done] {len(cells) * len(meshes)} records in {time.perf_counter() - t_start:.1f} s, "
          f"{failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
