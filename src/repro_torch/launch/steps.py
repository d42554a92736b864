"""Step builders of the LM paths: train_step / prefill_step / serve_step.

Port of ``src/repro/launch/steps.py``: plain closures over the config.
PyTorch runs eagerly, so there is no jit, and one device needs no
shardings or donation. ``make_train_step`` differentiates ``loss_fn`` by
autograd and applies one AdamW update; the serving steps run under
``torch.inference_mode()`` (the cache is updated in place).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, forward_prefill, loss_fn
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_update, cosine_warmup

__all__ = ["loss_and_grads", "make_train_step", "make_prefill_step", "make_serve_step"]


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
                    schedule: dict | None = None, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    The learning rate is ``cosine_warmup`` of the optimizer's step under
    ``{"peak_lr": opt_cfg.lr, "warmup": 100, "total": 10000}`` updated by
    ``schedule``. ``microbatches > 1`` runs the batch's slices one after
    another, accumulating float32 gradients, then applies one update (what
    bounds activation memory). The step returns new tensors and leaves its
    inputs as they are; ``metrics`` (``loss``, ``ce_loss``, ``grad_norm``,
    ``lr``) are 0-d tensors on the device, and nothing is read back to the
    host.
    """
    sched = {"peak_lr": opt_cfg.lr, "warmup": 100, "total": 10000}
    if schedule:
        sched.update(schedule)

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


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, cache, batch) -> (last logits [B, V], cache)``."""

    @torch.inference_mode()
    def prefill_step(params, cache, batch):
        return forward_prefill(params, batch, cache, cfg)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(params, cache, token [B, 1], pos) -> (logits [B, V], cache)``."""

    @torch.inference_mode()
    def serve_step(params, cache, token, pos):
        return decode_step(params, cache, token, pos, cfg)

    return serve_step
