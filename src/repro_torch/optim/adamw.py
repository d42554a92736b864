"""AdamW with global-norm clipping, built from scratch.

Port of ``src/repro/optim/adamw.py`` on the port's parameter trees (nested
dicts of plain tensors, ``models/params.py::tree_map``): plain functions on
tensors, not ``torch.optim``, so the reference's semantics hold leaf by
leaf, ``step`` an int32 0-d tensor included. Moments are float32 whatever
the parameter dtype; the update is computed in float32 and cast back
(bf16 params + f32 moments). Weight decay applies to every leaf, norms
included, as in the reference. Nothing here reads a tensor back to the
host. The update is elementwise, so a sharded step (``launch/steps.py``)
applies ``adamw_leaf`` block by block, after ``clip_scale`` of the global
norm over the distinct blocks.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import tree_leaves, tree_map

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "adamw_leaf",
    "bias_corrections",
    "clip_by_global_norm",
    "clip_scale",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params):
    """Zero float32 moments shaped like ``params`` and an int32 step 0, on
    the parameters' device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def clip_by_global_norm(grads, max_norm: float):
    """(grads in float32 scaled to a global norm of at most ``max_norm``,
    the global norm before scaling)."""
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree_leaves(grads)))
    scale = clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


def clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm ``gn`` down to ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def bias_corrections(step: torch.Tensor, cfg: AdamWConfig):
    """(the next step, 1 - b1^step, 1 - b2^step) for the update at ``step + 1``."""
    step = step + 1
    return step, 1.0 - cfg.b1 ** step.float(), 1.0 - cfg.b2 ** step.float()


def adamw_leaf(g, p, m, v, cfg: AdamWConfig, lr, b1c, b2c):
    """One leaf's (or one block's) update: elementwise, so a block of the
    leaf gives the block of the leaf's result. (new p, new m, new v)."""
    m2 = cfg.b1 * m + (1 - cfg.b1) * g
    v2 = cfg.b2 * v + (1 - cfg.b2) * (g * g)
    mhat = m2 / b1c
    vhat = v2 / b2c
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
    p2 = p.float() - lr * delta
    return p2.to(p.dtype), m2, v2


def adamw_update(grads, params, state, cfg: AdamWConfig, lr: torch.Tensor | float):
    """Returns (new_params, new_state, metrics); the inputs are not changed."""
    grads_f32, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step, b1c, b2c = bias_corrections(state["step"], cfg)
    if not isinstance(lr, torch.Tensor):
        lr = torch.full((), lr, dtype=torch.float32, device=gnorm.device)
    out = tree_map(lambda g, p, m, v: adamw_leaf(g, p, m, v, cfg, lr, b1c, b2c),
                   grads_f32, params, state["m"], state["v"])
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr.to(torch.float32)}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
