"""Activation-sharding scope: the LM's logical axes resolved on a mesh.

Port of ``src/repro/distributed/ctx.py``. Model code in the reference
calls ``constrain(x, 'dp', None, 'tp', None)`` with *logical* axis names; a
launcher activates a scope built from (cfg, mesh):

    with activation_scope(cfg, mesh):
        loop.run(steps)

Logical axes:
    'dp'  -> the batch axes (('pod','data') — plus 'model' for the pure-DP
             profile used by small/indivisible-head archs)
    'tp'  -> 'model' (None under the 'dp' profile)
    'sp'  -> 'model' (sequence parallelism of the residual stream; None
             under 'dp')

Divisibility is checked per call: a constraint that does not divide the dim
degrades to None (replicated) instead of failing — e.g. batch=1 decode.

The port is single-controller and holds dense tensors, so a layout hint
changes no result: ``constrain`` resolves its entries exactly as the
reference does (``resolve_constraint``), checks them against the tensor's
rank, and returns the tensor as it is. The model code does not call it.
Where the reference's constraints make GSPMD compute a layer split over
'model', the port writes that schedule out: serving the dense and MoE decoders
on the "tp" profile runs each model shard on its head, column, expert and
vocab blocks (``distributed/tensor_parallel.py``, ``models/model.py``'s
``prefill_placed_tp`` / ``decode_placed_tp``), and so do the other
decoders' serving and the audio encoder's prefill and train step; the
other families' training steps run on gathered parameters
(``launch/steps.py``).
"""
from __future__ import annotations

import contextlib
import math

from repro_torch.distributed.constants import MODEL_AXIS_SIZE
from repro_torch.distributed.sharding import P

__all__ = ["activation_scope", "constrain", "resolve_constraint", "arch_profile", "rules_for"]

_STACK: list[tuple] = []


def arch_profile(cfg) -> str:
    """'tp' when the head (or SSM-head) count shards over the model axis,
    else 'dp' (small archs: replicate params over 'model', spread batch).
    Configs may pin the profile (minicpm3: 40 heads do not divide 16, but
    all its MLA latent projections do)."""
    if getattr(cfg, "parallelism", "auto") in ("tp", "dp"):
        return cfg.parallelism
    if cfg.family == "ssm":
        return "tp" if cfg.ssm_heads % MODEL_AXIS_SIZE == 0 else "dp"
    if cfg.family == "hybrid":
        ok = cfg.ssm_heads % MODEL_AXIS_SIZE == 0 and cfg.n_heads % MODEL_AXIS_SIZE == 0
        return "tp" if ok else "dp"
    return "tp" if cfg.n_heads % MODEL_AXIS_SIZE == 0 else "dp"


def rules_for(cfg, mesh) -> dict:
    """Logical-axis rules of ``cfg`` on ``mesh`` (reads ``mesh.axis_names``
    only)."""
    prof = arch_profile(cfg)
    has_pod = "pod" in mesh.axis_names
    if prof == "tp":
        dp = ("pod", "data") if has_pod else ("data",)
        return {"dp": dp, "tp": "model", "sp": "model", "profile": "tp"}
    dp = ("pod", "data", "model") if has_pod else ("data", "model")
    return {"dp": dp, "tp": None, "sp": None, "profile": "dp"}


@contextlib.contextmanager
def activation_scope(cfg, mesh):
    _STACK.append((mesh, rules_for(cfg, mesh)))
    try:
        yield
    finally:
        _STACK.pop()


def _axis_size(mesh, axis) -> int:
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(shape.get(a, 1) for a in axis)
    return shape.get(axis, 1)


def _shrink(mesh, axis, dim: int):
    """Largest prefix of the (tuple) axis that divides dim, else None."""
    if axis is None:
        return None
    if not isinstance(axis, tuple):
        return axis if dim % _axis_size(mesh, axis) == 0 else None
    cur = tuple(axis)
    while cur:
        if dim % _axis_size(mesh, cur) == 0:
            return cur
        cur = cur[:-1]
    return None


def resolve_constraint(shape, *logical_axes) -> P | None:
    """The spec ``constrain`` resolves for a tensor of ``shape`` under the
    active scope (None outside one)."""
    if not _STACK:
        return None
    mesh, rules = _STACK[-1]
    assert len(logical_axes) == len(shape), (logical_axes, tuple(shape))
    return P(*(_shrink(mesh, rules.get(name) if name else None, dim)
               for dim, name in zip(shape, logical_axes, strict=True)))


def constrain(x, *logical_axes):
    """The reference's ``with_sharding_constraint`` under the active scope:
    the entries resolve and are checked against ``x``'s rank; ``x`` comes
    back as it is (identity outside a scope too)."""
    resolve_constraint(x.shape, *logical_axes)
    return x
