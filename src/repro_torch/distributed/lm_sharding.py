"""Sharding rules for the LM stack on the production mesh.

Port of ``src/repro/distributed/lm_sharding.py``, over the port's
``PartitionSpec`` and nested-dict trees. Every function reads only
``mesh.axis_names`` and ``mesh.devices.shape``.

Layout summary (mesh (pod, data, model); single-pod drops 'pod'):

  params/optimizer  ZeRO-3: one non-TP dim over 'data', TP dims over 'model'
                    (from the schema in models/*.py); replicated across pods.
  batch             batch dim over ('pod','data') when divisible, else
                    replicated (e.g. long_500k's batch=1).
  KV caches         *sequence* dim over 'model' (flash-decoding layout),
                    batch over dp.
  SSM states        heads over 'model', batch over dp.
  logits            vocab over 'model' when divisible.

``launch/steps.py`` trains and serves on these specs over logical shards
(the cache's sequence blocks through ``models/model.py::decode_placed``).
"""
from __future__ import annotations

from repro_torch.distributed.constants import DATA_AXIS_SIZE
from repro_torch.distributed.ctx import _shrink, arch_profile, rules_for
from repro_torch.distributed.sharding import P, named_tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import model_param_specs, model_schema
from repro_torch.models.params import param_specs as schema_param_specs
from repro_torch.models.params import tree_map

__all__ = [
    "dp_axes",
    "dp_size",
    "batch_spec_tree",
    "cache_spec_tree",
    "train_state_specs",
    "logits_spec",
    "named_tree",
]


def dp_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_size(mesh) -> int:
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    out = 1
    for n in dp_axes(mesh):
        out *= shape[n]
    return out


def _tp_size(mesh) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1)


def _b(mesh, batch: int):
    """Batch-dim spec entry: dp axes if divisible, else replicated."""
    return dp_axes(mesh) if batch % dp_size(mesh) == 0 else None


def batch_spec_tree(cfg: ModelConfig, mesh, batch: dict) -> dict:
    """PartitionSpecs for a train/prefill batch dict (keyed like the batch;
    leaves need a ``shape``). 'dp'-profile archs spread the batch over the
    model axis too when it divides — pure data parallelism."""
    rules = rules_for(cfg, mesh)
    out = {}
    for k, v in batch.items():
        shape = tuple(v.shape)
        out[k] = P(_shrink(mesh, rules["dp"], shape[0]), *([None] * (len(shape) - 1)))
    return out


def cache_spec_tree(cfg: ModelConfig, mesh, cache) -> dict:
    """Specs mirroring ``init_cache``'s structure. Seq over 'model', batch dp."""
    tp = _tp_size(mesh)

    def spec_for(key: str, x) -> P:
        shape = tuple(x.shape)
        if key in ("k", "v"):  # [L, B, S, K, hd] or vlm [G, sp, B, S, K, hd]
            lead = len(shape) - 4
            b, s = shape[lead], shape[lead + 1]
            return P(*([None] * lead), _b(mesh, b), "model" if s % tp == 0 else None,
                     None, None)
        if key in ("shared_k", "shared_v"):  # [A, B, S, K, hd]
            b, s = shape[1], shape[2]
            return P(None, _b(mesh, b), "model" if s % tp == 0 else None, None, None)
        if key in ("xk", "xv"):  # [G, B, n_img, K, hd]
            return P(None, _b(mesh, shape[1]), None, None, None)
        if key in ("ckv", "krope"):  # [L, B, S, r]
            b, s = shape[1], shape[2]
            return P(None, _b(mesh, b), "model" if s % tp == 0 else None, None)
        if key in ("conv_x", "conv_b", "conv_c"):  # [L, B, w-1, C]
            return P(None, _b(mesh, shape[1]), None, "model" if shape[-1] % tp == 0 else None)
        if key == "ssm":  # [L, B, H, N, Pd]
            h = shape[2]
            return P(None, _b(mesh, shape[1]), "model" if h % tp == 0 else None, None, None)
        raise KeyError(f"unknown cache leaf {key!r}")

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(tree[k], k) for k in sorted(tree)}
        return spec_for(key, tree)

    return walk(cache)


def _first_divisible_dim_spec(shape: tuple, size: int) -> P:
    """Shard the first dim divisible by ``size`` over 'data' (ZeRO-1)."""
    entries = [None] * len(shape)
    for i, d in enumerate(shape):
        if d % size == 0 and d > 0:
            entries[i] = "data"
            break
    return P(*entries)


def train_state_specs(cfg: ModelConfig):
    """(param_specs, opt_specs, grad_specs).

    tp profile: ZeRO-3 — params/moments/grads all shard ('data' x 'model');
    with ``cfg.zero3`` false the params keep only the TP axes (replicated
    over 'data') and the moments and gradients keep the ZeRO layout.
    dp profile: params fully replicated, optimizer moments and the gradient
    accumulator ZeRO-1-sharded over 'data'.
    """
    schema = model_schema(cfg)
    if arch_profile(cfg) == "tp":
        if getattr(cfg, "zero3", True):
            pspecs = model_param_specs(cfg)
            return pspecs, {"m": pspecs, "v": pspecs, "step": P()}, pspecs
        pspecs = schema_param_specs(
            schema, {"fsdp": None, "tp": "model", "vocab": "model", None: None})
        zspecs = model_param_specs(cfg)
        return pspecs, {"m": zspecs, "v": zspecs, "step": P()}, zspecs
    pspecs = tree_map(lambda d: P(*([None] * len(d.shape))), schema)
    zero1 = tree_map(lambda d: _first_divisible_dim_spec(d.shape, DATA_AXIS_SIZE), schema)
    return pspecs, {"m": zero1, "v": zero1, "step": P()}, zero1


def logits_spec(cfg: ModelConfig, mesh, batch: int) -> P:
    tp = _tp_size(mesh)
    return P(_b(mesh, batch), None, "model" if cfg.vocab % tp == 0 else None)
