"""Schema-driven parameter system.

Port of ``src/repro/models/params.py``. A module's parameters are declared
once as a nested dict of ``ParamDef`` (shape, init kind, logical partition
axes). From one schema come:

  * ``init_params``  — materialized torch tensors, drawn from an explicit
    ``torch.Generator`` (its numbers differ from ``jax.random``'s)
  * ``stack_schema`` — the stacked-over-layers form ([L, ...] leaves)
  * ``param_specs``  — the matching ``PartitionSpec`` tree
    (``distributed/sharding.py``)
  * ``params_from_numpy`` — the JAX package's parameter tree, as numpy
    arrays, turned into the port's parameters bit for bit

Logical axis names -> mesh axes (see ``distributed/lm_sharding.py``):
  'fsdp'  -> 'data'   (ZeRO-3 style parameter/optimizer sharding)
  'tp'    -> 'model'  (tensor parallel: computed by blocks when serving the dense
                       decoders, else blocks only; see ``launch/steps.py``)
  'vocab' -> 'model'
  None    -> replicated
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.runtime.staging import stage

__all__ = [
    "ParamDef",
    "init_params",
    "param_specs",
    "stack_schema",
    "tree_bytes",
    "tree_leaves",
    "tree_map",
    "params_from_numpy",
]

Schema = dict[str, Any]  # nested dicts with ParamDef leaves


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"  # normal|zeros|ones|scaled|embed|a_log|dt_bias
    axes: tuple[str | None, ...] = ()  # logical partition per dim
    scale: float = 0.02  # stddev for normal-family inits

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} vs shape {self.shape}")


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted-key order (JAX's dict order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of one or more nested dicts of equal structure,
    in sorted-key order (JAX's), which the result's dicts keep."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def _init_leaf(gen: torch.Generator, d: ParamDef, dtype: torch.dtype) -> torch.Tensor:
    dev = gen.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=dev)
    if d.init in ("normal", "scaled", "embed"):
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=dev)
        return (x * d.scale).to(dtype)
    if d.init == "a_log":
        # Mamba2: A = -exp(A_log), A_log = log(U[1, 16]); float32 whatever
        # ``dtype`` (as the reference keeps it, for stability).
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32, device=dev)
        return torch.log(1.0 + 15.0 * u)
    if d.init == "dt_bias":
        # Inverse softplus of dt ~ logU[1e-3, 1e-1]; float32 whatever ``dtype``.
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32, device=dev)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {d.init!r}")


def init_params(gen: torch.Generator, schema: Schema, dtype=torch.bfloat16,
                device: str | torch.device | None = None):
    """Materialize a schema from ``gen``, leaf by leaf in sorted-key order.

    Draws on ``gen.device`` and moves the result to ``device`` (default:
    where ``gen`` draws), so a CPU generator gives the same numbers for
    every target device.
    """
    dev = gen.device if device is None else torch.device(device)
    return tree_map(lambda d: stage(_init_leaf(gen, d, dtype), dev, non_blocking=False), schema)


_LOGICAL_TO_MESH = {"fsdp": "data", "tp": "model", "vocab": "model", None: None}


def param_specs(schema: Schema, logical_to_mesh: dict | None = None):
    """PartitionSpec tree matching the schema structure; ``logical_to_mesh``
    replaces the default table (a logical axis it lacks is replicated)."""
    from repro_torch.distributed.sharding import P

    table = _LOGICAL_TO_MESH if logical_to_mesh is None else logical_to_mesh

    def leaf(d: ParamDef):
        axes = d.axes if d.axes else (None,) * len(d.shape)
        return P(*[table.get(a, None) for a in axes])

    return tree_map(leaf, schema)


def stack_schema(schema: Schema, n: int) -> Schema:
    """Prepend a stacked-layer dim of size n to every leaf."""

    def leaf(d: ParamDef):
        axes = d.axes if d.axes else (None,) * len(d.shape)
        return ParamDef((n, *d.shape), d.init, (None, *axes), d.scale)

    return tree_map(leaf, schema)


def tree_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))


def _to_tensor(arr) -> torch.Tensor:
    arr = np.array(arr, order="C", copy=True)  # writable: JAX hands out read-only views
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own and torch.from_numpy refuses the
        # extension dtype JAX hands out: reinterpret the same 16 bits.
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(tree, cfg, device: str | torch.device | None = None):
    """The JAX package's parameter tree (numpy leaves) as the port's params.

    Bit for bit: every leaf keeps its dtype and bits. The tree must match
    ``model_schema(cfg)`` key for key and shape for shape; ``device``
    defaults to the card.
    """
    from repro_torch.kernels.common import resolve_device
    from repro_torch.models.model import model_schema

    dev = resolve_device(device)

    def check(t, s, path):
        if isinstance(s, dict) != isinstance(t, dict):
            raise ValueError(f"params tree differs from the schema at {path!r}")
        if isinstance(t, dict):
            if set(t) != set(s):
                raise ValueError(f"keys at {path!r}: {sorted(t)} != schema {sorted(s)}")
            for k in t:
                check(t[k], s[k], f"{path}/{k}")
        elif tuple(np.shape(t)) != tuple(s.shape):
            raise ValueError(f"shape at {path!r}: {np.shape(t)} != schema {s.shape}")

    check(tree, model_schema(cfg), "")
    return tree_map(lambda a: stage(_to_tensor(a), dev, non_blocking=False), tree)
