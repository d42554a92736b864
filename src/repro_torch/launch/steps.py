"""Step builders of the LM paths: train_step / prefill_step / serve_step.

Port of ``src/repro/launch/steps.py``: plain closures over the config.
PyTorch runs eagerly, so there is no jit and no donation.
``make_train_step`` differentiates ``loss_fn`` by autograd and applies one
AdamW update; the serving steps run under ``torch.inference_mode()`` (the
cache is updated in place).

On a mesh (``make_train_step(mesh=)``) the step takes the state placed by
``train_state_specs`` and the batch by ``batch_spec_tree``
(``distributed/sharding.py``), and computes what the one-device step
computes, up to reduction order (``sharded_loss_and_grads``):

  1. the batch splits into the distinct data-parallel blocks of its spec
     (microbatches first, contiguous, each then split over dp, as the
     reference's scan over ``with_sharding_constraint``-ed slices does);
  2. each leaf's params are gathered once a device;
  3. ``loss_and_grads`` runs once a distinct dp shard, on its device, in a
     fixed order (on the "tp" profile the 'model' axis only holds blocks,
     but for the audio encoder, below);
  4. the shards' losses and gradients combine into the global loss's
     gradient (next-token CE: ``1/n`` each; the audio family's masked loss:
     each shard's mask count over the global count), reduced in float32
     into the blocks of the gradient spec. An MoE microbatch whose shards
     would cut a routing group of ``min(1024, tokens)`` runs as one shard
     on its first device instead, so its routing, drops and aux losses are
     the global ones, as the reference's GSPMD step routes them;
  5. the global norm is taken over distinct blocks (a replicated leaf
     counts once, not once a logical shard), and AdamW runs block by block.

Where ``distributed/tensor_parallel.py::trains_tensor_parallel`` says so
(the audio encoder on the "tp" profile, its heads divided by 'model') steps
2-4 are tensor-parallel (``_tp_shard_grads``): each position gathers its
'model' blocks over 'data' only (``gather_model_blocks``), taken as leaves
of their own; each distinct dp shard of step 1 runs
``models/model.py::loss_tp`` over the model group of the position holding
its rows (the frame projection's, wq/wk/wv's and the MLP's columns, wo's
rows and the vocab a shard, each layer under the config's remat) and its
backward; each shard's gradient of its model block is reduced in float32,
with the shard's weight, into the gradient spec's blocks inside that
block, on the device holding each; a leaf held whole (a norm) takes the sum
of the shards' gradients of it, the home's alone (the others do not use it).

The serving steps on a mesh (``make_prefill_step(cfg, mesh)``,
``make_serve_step(cfg, mesh)``) take the params placed by
``train_state_specs`` (or ``gather_params``' gathered copies), the cache
placed by ``cache_spec_tree`` (a dense cache is placed on the way in) and
the prompt batch by ``batch_spec_tree``, and return the logits ``[B, V]``
gathered on the mesh's first device with the placed cache. Two paths,
chosen by ``distributed/tensor_parallel.py::serves_tensor_parallel``:

  * tensor-parallel (the dense, MoE, VLM, SSM and hybrid decoders on the
    "tp" profile, MLA's too, and the audio encoder's prefill, which has no
    cache and no decode step): each position gathers over 'data' only, into
    its 'model' block of every leaf whose spec has 'model' (MLA's per-head
    leaves by its heads; the norms, the MoE's router and the VLM's cross
    gates whole; ``gather_params`` returns ``ModelBlocks``). The prefill runs each distinct data-parallel
    shard of the batch over its model group
    (``models/model.py::prefill_placed_tp``), the decode step each
    data-parallel row of the cache (``decode_placed_tp``): heads, columns,
    experts and vocab a shard, the row-parallel partials reduced in
    float32. A shard of ``_dp_shards`` carries its rows of every batch
    leaf, so a VLM shard's prefill projects its own rows of
    ``image_embeds``. The MoE's shards are ``_dp_shards``' (whole routing
    groups, or the batch as one shard), each routed once on its group's
    home, so its routing and drops are one device's;
  * gathered (every other config): every parameter gathered whole once a
    distinct device (``GatheredParams``); the prefill runs
    ``forward_prefill`` once a distinct data-parallel shard
    (``prefill_placed``; the audio encoder's with no cache, each shard
    weighing ``1 / n`` as a decoder's), the decode step once a data-parallel row of the
    cache, its attention one partial a sequence block (``decode_placed``).

Both record the bytes each mesh position computes with
(``bytes_by_position``). ``make_forward_step(cfg, mesh)`` runs the
prefill's shards through the whole forward on either path (the audio
encoder's full-frame logits: ``forward_tp``, or ``forward_train`` on the
gathered params). The reference's logits are vocab-sharded;
sampling reads them whole.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import (
    NamedSharding,
    ShardedTensor,
    _map_named,
    from_parts,
    gather_tree,
    place,
    reshard,
)
from repro_torch.distributed.tensor_parallel import (
    ModelBlocks,
    first_positions,
    gather_model_blocks,
    model_dim,
    model_group,
    serves_tensor_parallel,
    trains_tensor_parallel,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    _first_leaf,
    decode_placed,
    decode_placed_tp,
    decode_step,
    forward_prefill,
    forward_tp,
    forward_train,
    loss_fn,
    loss_tp,
    prefill_placed,
    prefill_placed_tp,
)
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_update, cosine_warmup
from repro_torch.optim.adamw import adamw_leaf, bias_corrections, clip_scale
from repro_torch.runtime.staging import stage

__all__ = [
    "loss_and_grads",
    "sharded_loss_and_grads",
    "make_train_step",
    "make_prefill_step",
    "make_forward_step",
    "make_serve_step",
    "GatheredParams",
    "gather_params",
    "place_params",
]

MOE_GROUP = 1024  # models/moe.py's routing group (min(1024, tokens))


def loss_and_grads(params, batch: dict, cfg: ModelConfig):
    """``jax.value_and_grad(loss_fn, has_aux=True)``'s counterpart:
    ``(loss, metrics, grads)``, detached, the gradients a tree shaped like
    ``params`` in the parameters' dtype. ``params`` are not changed."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_map(lambda _: next(it), params), batch, cfg)
        grads = iter(torch.autograd.grad(loss, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    schedule: dict | None = None, microbatches: int = 1, mesh=None,
                    batch_sds: dict | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    The learning rate is ``cosine_warmup`` of the optimizer's step under
    ``{"peak_lr": opt_cfg.lr, "warmup": 100, "total": 10000}`` updated by
    ``schedule``. ``microbatches > 1`` runs the batch's slices one after
    another, accumulating float32 gradients, then applies one update (what
    bounds activation memory). The step returns new tensors and leaves its
    inputs as they are; ``metrics`` (``loss``, ``ce_loss``, ``grad_norm``,
    ``lr``) are 0-d tensors on the device, and nothing is read back to the
    host.

    With ``mesh`` the step is the sharded one (the module docstring): it
    takes params and optimizer state placed by ``train_state_specs`` and the
    batch by ``batch_spec_tree`` (dense leaves are placed on the way in, as
    jit places uncommitted arrays; a leaf placed otherwise raises
    ``ValueError``), and returns the state placed the same way. The batch
    specs come from ``batch_sds`` (leaves with a ``shape``, e.g. meta
    tensors) or, without it, from each batch.
    """
    sched = {"peak_lr": opt_cfg.lr, "warmup": 100, "total": 10000}
    if schedule:
        sched.update(schedule)
    if mesh is not None:
        return _sharded_train_step(cfg, mesh, opt_cfg, sched, microbatches, batch_sds)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(params, batch, cfg)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatches:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{microbatches} microbatches")
            slices = {k: v.chunk(microbatches) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss, metrics = 0.0, {}
            for i in range(microbatches):
                mloss, mmetrics, mgrads = loss_and_grads(
                    params, {k: v[i] for k, v in slices.items()}, cfg)
                tree_map(lambda a, g: a.add_(g), grads, mgrads)
                loss = loss + mloss
                metrics = {k: metrics.get(k, 0.0) + v for k, v in mmetrics.items()}
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {k: v / microbatches for k, v in metrics.items()}
        lr = cosine_warmup(opt_state["step"], **sched)
        new_params, new_opt, om = adamw_update(grads, params, opt_state, opt_cfg, lr)
        return new_params, new_opt, {"loss": loss, **metrics, **om}

    return train_step


# ------------------------------------------------------------ on a mesh


def _state_shardings(cfg: ModelConfig, mesh):
    from repro_torch.distributed.lm_sharding import named_tree, train_state_specs

    pspecs, ospecs, gspecs = train_state_specs(cfg)
    return named_tree(mesh, pspecs), named_tree(mesh, ospecs), named_tree(mesh, gspecs)


def _batch_shardings(cfg: ModelConfig, mesh, batch: dict) -> dict:
    from repro_torch.distributed.lm_sharding import batch_spec_tree, named_tree

    return named_tree(mesh, batch_spec_tree(cfg, mesh, batch))


def _placed(x, sh: NamedSharding, name: str) -> ShardedTensor:
    """``x`` placed by ``sh``: a dense leaf is placed, a placed one checked."""
    if not isinstance(x, ShardedTensor):
        return place(x, sh, name)
    if not x.sharding.same_blocks(sh, x.ndim):
        raise ValueError(f"{name} is placed by {x.sharding.spec}; the step takes {sh.spec}")
    return x


def _placed_tree(tree, shardings, prefix: str):
    return _map_named(lambda name, x, sh: _placed(x, sh, name), tree, shardings, path=prefix)


def _dp_shards(cfg: ModelConfig, batch: dict, microbatches: int) -> list:
    """[(weight, device, rows of each batch leaf, first row)] for every
    (microbatch, distinct dp shard), microbatches first. A weight is what
    the shard's loss counts in the global loss: a float, or a 0-d tensor on
    the first shard's device (the audio family's mask counts, where the
    batch has a mask, read from it on the device: nothing is read back to
    the host). An MoE microbatch whose dp shards would cut a routing group
    is one shard on the first device, weight ``1 / microbatches``."""
    first = _first_leaf(batch)
    rows, seq = first.shape[0], first.shape[1]
    layout = first.sharding.layout(first.ndim)
    n = first.sharding.blocks_per_dim(first.ndim)[0]
    dev_of: dict = {}
    for dev, idx in layout.values():
        dev_of.setdefault(idx[0], dev)
    if rows % (microbatches * n):
        raise ValueError(f"a batch of {rows} rows does not split into {microbatches} "
                         f"microbatches of {n} data-parallel shards")
    mb_rows = rows // microbatches
    if cfg.family == "moe" and (mb_rows // n * seq) % min(MOE_GROUP, mb_rows * seq):
        n = 1  # the shards would cut a routing group: the microbatch routes whole
    shard_rows = mb_rows // n
    home = dev_of[0]
    out = []
    for j in range(microbatches):
        shards = []
        for i in range(n):
            lo = j * mb_rows + i * shard_rows
            dev = dev_of[i]
            part = {k: leaf.read((slice(lo, lo + shard_rows),), dev) for k, leaf in batch.items()}
            shards.append((dev, part, lo))
        if cfg.family == "audio" and "mask" in batch:
            counts = [stage(p["mask"].sum(dtype=torch.float32), home) for _, p, _ in shards]
            total = torch.clamp(sum(counts), min=1.0)
            weights = [c / total / microbatches for c in counts]
        else:
            weights = [1.0 / n / microbatches] * n
        out += [(w, dev, part, lo) for w, (dev, part, lo) in zip(weights, shards)]
    return out


def sharded_loss_and_grads(params, batch: dict, cfg: ModelConfig, grad_shardings,
                           microbatches: int = 1):
    """The sharded step's (loss, metrics, grads) on placed ``params`` and
    ``batch``: the global loss and its float32 gradient, reduced into
    ``ShardedTensor``s placed by ``grad_shardings`` (a tree of
    ``NamedSharding``). Metrics are 0-d tensors on the first shard's
    device. Each distinct dp shard's loss, metrics and gradient come from
    ``_gathered_shard_grads``, or ``_tp_shard_grads`` where
    ``trains_tensor_parallel`` says so; they are weighed and reduced here."""
    mesh = tree_leaves(grad_shardings)[0].mesh
    shards = _dp_shards(cfg, batch, microbatches)
    home = shards[0][1]
    p_leaves, gsh = tree_leaves(params), tree_leaves(grad_shardings)
    shapes = [p.shape for p in p_leaves]
    homes = _block_homes(gsh, shapes)
    acc: list[dict] = [{} for _ in gsh]
    loss, metrics = None, {}
    run = _tp_shard_grads if trains_tensor_parallel(cfg, mesh) else _gathered_shard_grads
    for w, s_loss, s_metrics, region_grad in run(params, batch, cfg, shards, microbatches,
                                                 mesh):
        w_home = w if isinstance(w, float) else stage(w, home)
        term = stage(s_loss, home) * w_home
        loss = term if loss is None else loss + term
        for k, v in s_metrics.items():
            t = stage(v, home) * w_home
            metrics[k] = t if k not in metrics else metrics[k] + t
        for i, (shape, sh, where, a) in enumerate(zip(shapes, gsh, homes, acc)):
            for idx, bdev in where.items():
                wb = w if isinstance(w, float) else stage(w, bdev)
                piece = stage(region_grad(i, sh.block_slices(shape, idx)), bdev).float() * wb
                a[idx] = piece if idx not in a else a[idx] + piece
    placed = iter([from_parts(shape, torch.float32, sh, a)
                   for a, shape, sh in zip(acc, shapes, gsh)])
    return loss, metrics, tree_map(lambda _: next(placed), grad_shardings)


def _gathered_shard_grads(params, batch: dict, cfg: ModelConfig, shards: list,
                          microbatches: int, mesh):
    """Each distinct dp shard's (weight, loss, metrics, region_grad): its
    ``loss_and_grads`` on the params gathered whole on its device;
    ``region_grad(i, region)`` is ``region`` of its gradient of leaf ``i``."""
    full = {}
    for _, dev, _, _ in shards:
        if dev not in full:
            full[dev] = gather_tree(params, dev)
    for w, dev, part, _ in shards:
        s_loss, s_metrics, s_grads = loss_and_grads(full[dev], part, cfg)
        g = tree_leaves(s_grads)
        yield w, s_loss, s_metrics, lambda i, region: g[i][region]
        del s_grads, g


def _block_homes(gsh: list, shapes: list) -> list:
    """Each gradient leaf's distinct blocks -> the first device holding
    each, where it is reduced."""
    return [{idx: dev for dev, idx in reversed(list(sh.layout(len(shape)).values()))}
            for sh, shape in zip(gsh, shapes)]


def _model_block_grad(grads: list, leaf: ShardedTensor, region: tuple) -> torch.Tensor:
    """The float32 gradient of ``region`` of a placed leaf from one data
    shard's model group, ``grads`` its shards' gradients of their blocks of
    the leaf (None where a shard does not use it): the one model shard's
    whose block holds the region, or for a leaf held
    whole the sum of the shards' gradients (the home's alone where only it
    uses the leaf)."""
    d = model_dim(leaf.sharding.spec, leaf.ndim)
    if d is None:
        used = [g for g in grads if g is not None]
        total = used[0].float()
        for g in used[1:]:
            total = total + stage(g, total.device).float()
        return total[region]
    per = leaf.shape[d] // leaf.sharding.blocks_per_dim(leaf.ndim)[d]
    j = region[d].start // per
    local = list(region)
    local[d] = slice(region[d].start - j * per, region[d].stop - j * per)
    if not 0 <= local[d].start < local[d].stop <= per:
        raise ValueError(f"gradient block {region} is not inside model block {j} of {per}")
    return grads[j][tuple(local)].float()


def _tp_shard_grads(params, batch: dict, cfg: ModelConfig, shards: list, microbatches: int,
                    mesh):
    """``_gathered_shard_grads`` on the tensor-parallel path (the module
    docstring): each distinct dp shard's ``loss_tp`` and backward over its
    model group, on each position's 'model' blocks gathered over 'data';
    ``region_grad`` is ``_model_block_grad``'s."""
    leaves = {key: tree_map(lambda t: t.detach().requires_grad_(), tree)
              for key, tree in gather_model_blocks(params, mesh, cfg).items()}
    p_leaves = tree_leaves(params)
    for (w, _, _, _), (_, group, part) in zip(
            shards, _tp_shards(leaves, mesh, batch, shards, microbatches)):
        own = [tree_leaves(b) for b in group.blocks]
        with torch.enable_grad():
            s_loss, s_metrics = loss_tp(group, part, cfg)
            flat = torch.autograd.grad(s_loss, [t for ls in own for t in ls], allow_unused=True)
        n = len(own[0])
        by_leaf = list(zip(*(flat[j * n:(j + 1) * n] for j in range(group.m))))
        del flat
        yield (w, s_loss.detach(), {k: v.detach() for k, v in s_metrics.items()},
               lambda i, region: _model_block_grad(by_leaf[i], p_leaves[i], region))
        del by_leaf


def _sharded_adamw(grads, params, opt_state, opt_cfg: AdamWConfig, lr, home):
    """AdamW block by block over placed state: clip by the global norm of
    the distinct gradient blocks, update each block of the moments' layout
    with the matching region of the params, place the new params as the old.
    Returns (params, opt_state, metrics)."""
    g_leaves = tree_leaves(grads)
    sq = [stage(torch.sum(b.float() ** 2), home)
          for g in g_leaves for b in g.distinct_blocks().values()]
    gnorm = torch.sqrt(sum(sq))
    scale = clip_scale(gnorm, opt_cfg.clip_norm)
    step, b1c, b2c = bias_corrections(opt_state["step"].full(home), opt_cfg)
    new_p, new_m, new_v = [], [], []
    for g, p, m, v in zip(g_leaves, tree_leaves(params), tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        sh = g.sharding
        same = p.sharding.same_blocks(sh, p.ndim)
        p_full: dict = {}
        out = {}
        for idx, gb in g.distinct_blocks().items():
            dev = gb.device
            if same:
                pb = p.held(idx, dev)
            else:
                if dev not in p_full:
                    p_full[dev] = p.full(dev)
                pb = p_full[dev][sh.block_slices(p.shape, idx)]
            out[idx] = adamw_leaf(gb * stage(scale, dev), pb, m.held(idx, dev), v.held(idx, dev),
                                  opt_cfg, stage(lr, dev), stage(b1c, dev), stage(b2c, dev))
        parts = [{idx: o[i] for idx, o in out.items()} for i in range(3)]
        new_m.append(from_parts(m.shape, torch.float32, m.sharding, parts[1]))
        new_v.append(from_parts(v.shape, torch.float32, v.sharding, parts[2]))
        new_p.append(reshard(from_parts(p.shape, p.dtype, sh, parts[0]), p.sharding))
    its = [iter(x) for x in (new_p, new_m, new_v)]
    return (tree_map(lambda _: next(its[0]), params),
            {"m": tree_map(lambda _: next(its[1]), opt_state["m"]),
             "v": tree_map(lambda _: next(its[2]), opt_state["v"]),
             "step": place(step, opt_state["step"].sharding)},
            {"grad_norm": gnorm, "lr": lr.to(torch.float32)})


def _sharded_train_step(cfg: ModelConfig, mesh, opt_cfg: AdamWConfig, sched: dict,
                        microbatches: int, batch_sds: dict | None):
    psh, osh, gsh = _state_shardings(cfg, mesh)
    bsh_fixed = None if batch_sds is None else _batch_shardings(cfg, mesh, batch_sds)

    def train_step(params, opt_state, batch):
        bsh = bsh_fixed or _batch_shardings(cfg, mesh, batch)
        params = _placed_tree(params, psh, "params")
        opt_state = _placed_tree(opt_state, osh, "opt")
        batch = _placed_tree(batch, bsh, "batch")
        loss, metrics, grads = sharded_loss_and_grads(params, batch, cfg, gsh, microbatches)
        home = loss.device
        lr = cosine_warmup(opt_state["step"].full(home), **sched)
        new_params, new_opt, om = _sharded_adamw(grads, params, opt_state, opt_cfg, lr, home)
        return new_params, new_opt, {"loss": loss, **metrics, **om}

    return train_step


class GatheredParams(dict):
    """Device -> the full parameter tree gathered there: what the gathered
    serving path runs on, built by ``gather_params`` once for many steps.
    ``bytes_by_position``: mesh position -> the bytes of the tree that
    position computes with."""

    bytes_by_position: dict


def place_params(cfg: ModelConfig, mesh, params):
    """``params`` placed by ``train_state_specs`` (dense leaves placed, placed
    ones checked), as the serving steps take them."""
    return _placed_tree(params, _state_shardings(cfg, mesh)[0], "params")


def _full_bytes(params) -> int:
    return sum(t.shape.numel() * t.dtype.itemsize for t in tree_leaves(params))


def gather_params(params, mesh, cfg: ModelConfig | None = None):
    """``params`` gathered for the serving steps. With a ``cfg`` that
    serves tensor-parallel on ``mesh``, ``ModelBlocks``: placed ``params``
    gathered over 'data' only, one tree a distinct (device, model block).
    Else ``GatheredParams``: ``params`` (placed, or dense on the mesh's
    devices) gathered whole once on each distinct device of ``mesh``; a
    replicated leaf held there is not copied."""
    if cfg is not None and serves_tensor_parallel(cfg, mesh):
        return gather_model_blocks(params, mesh, cfg)
    out = GatheredParams({dev: gather_tree(params, dev) for dev in mesh.unique_devices})
    nbytes = _full_bytes(params)
    out.bytes_by_position = {pos: nbytes for pos, _ in np.ndenumerate(mesh.devices)}
    return out


def _serve_inputs(cfg: ModelConfig, mesh, params, cache):
    """(gathered params, placed cache) of a sharded serving step: the
    ``ModelBlocks`` of the tensor-parallel path or the ``GatheredParams``
    of the gathered one (either given, or gathered here)."""
    from repro_torch.distributed.lm_sharding import cache_spec_tree, named_tree

    cache = _placed_tree(cache, named_tree(mesh, cache_spec_tree(cfg, mesh, cache)), "cache")
    want = ModelBlocks if serves_tensor_parallel(cfg, mesh) else GatheredParams
    if not isinstance(params, (GatheredParams, ModelBlocks)):
        params = gather_params(place_params(cfg, mesh, params), mesh, cfg)
    elif not isinstance(params, want):
        raise ValueError(f"{cfg.name} serves on this mesh from {want.__name__}, got "
                         f"{type(params).__name__}")
    return params, cache


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """``prefill_step(params, cache, batch) -> (last logits [B, V], cache)``;
    with ``mesh`` the sharded step of the module docstring."""
    if mesh is not None:
        return _sharded_prefill_step(cfg, mesh)

    @torch.inference_mode()
    def prefill_step(params, cache, batch):
        return forward_prefill(params, batch, cache, cfg)

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None):
    """``serve_step(params, cache, token [B, 1], pos) -> (logits [B, V],
    cache)``; with ``mesh`` the sharded step of the module docstring."""
    if mesh is not None:
        return _sharded_serve_step(cfg, mesh)

    @torch.inference_mode()
    def serve_step(params, cache, token, pos):
        return decode_step(params, cache, token, pos, cfg)

    return serve_step


def _tp_shards(blocks: ModelBlocks, mesh, batch: dict, shards: list,
               microbatches: int = 1) -> list:
    """[(row offset, model group, batch part)]: each data-parallel shard of
    ``_dp_shards`` with the model group of the first position holding the
    block of the batch whose device ``_dp_shards`` read it onto (the
    ``i``-th shard of a microbatch: the ``i``-th block's)."""
    first = _first_leaf(batch)
    at = first_positions(first, 0)
    n = len(shards) // microbatches
    rows = first.shape[0] // len(shards)
    return [(lo, model_group(blocks, mesh, at[lo // rows % n]), part)
            for _, _, part, lo in shards]


def _prefill_shards(cfg: ModelConfig, mesh, params, cache, batch: dict) -> tuple:
    """(gathered params, placed cache, shards) of a sharded prefill: the
    distinct data-parallel shards of ``_dp_shards``, as ``_tp_shards``'
    (row offset, model group, batch part) from ``ModelBlocks``, else as
    (row offset, device, batch part)."""
    full, cache = _serve_inputs(cfg, mesh, params, cache)
    batch = _placed_tree(batch, _batch_shardings(cfg, mesh, batch), "batch")
    shards = _dp_shards(cfg, batch, 1)
    if isinstance(full, ModelBlocks):
        return full, cache, _tp_shards(full, mesh, batch, shards)
    return full, cache, [(lo, dev, part) for _, dev, part, lo in shards]


def _sharded_prefill_step(cfg: ModelConfig, mesh):
    home = mesh.devices.flat[0]

    @torch.inference_mode()
    def prefill_step(params, cache, batch):
        full, cache, shards = _prefill_shards(cfg, mesh, params, cache, batch)
        if isinstance(full, ModelBlocks):
            return prefill_placed_tp(shards, cache, cfg, home)
        return prefill_placed(full, shards, cache, cfg, home)

    return prefill_step


def make_forward_step(cfg: ModelConfig, mesh=None):
    """``forward_step(params, batch) -> logits [B, S, V]``: ``forward_train``'s
    logits of every position, without a gradient. With ``mesh`` (the audio
    encoder's full-frame logits) each distinct data-parallel shard of the
    prefill step's runs over its model group (``forward_tp``) from
    ``ModelBlocks``, else ``forward_train`` on the params gathered on its
    device; the logits are joined on the mesh's first device."""
    @torch.inference_mode()
    def forward_step(params, batch):
        if mesh is None:
            return forward_train(params, batch, cfg)[0]
        home = mesh.devices.flat[0]
        full, _, shards = _prefill_shards(cfg, mesh, params, {}, batch)
        if isinstance(full, ModelBlocks):
            return torch.cat([forward_tp(group, part, cfg, home) for _, group, part in shards])
        return torch.cat([stage(forward_train(full[dev], part, cfg)[0], home)
                          for _, dev, part in shards])

    return forward_step


def _sharded_serve_step(cfg: ModelConfig, mesh):
    home = mesh.devices.flat[0]

    @torch.inference_mode()
    def serve_step(params, cache, token, pos):
        full, cache = _serve_inputs(cfg, mesh, params, cache)
        if isinstance(full, ModelBlocks):
            return decode_placed_tp(full, mesh, cache, token, pos, cfg, home)
        return decode_placed(full, cache, token, pos, cfg, home)

    return serve_step
