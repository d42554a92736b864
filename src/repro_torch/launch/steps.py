"""Prefill and decode step builders of the LM serving path.

Port of ``make_prefill_step`` and ``make_serve_step`` in
``src/repro/launch/steps.py``: plain closures over the config that run
under ``torch.inference_mode()``. PyTorch runs eagerly, so there is no jit,
and one device needs no shardings or donation (the cache is updated in
place). ``make_train_step`` waits for the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, forward_prefill

__all__ = ["make_prefill_step", "make_serve_step"]


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
