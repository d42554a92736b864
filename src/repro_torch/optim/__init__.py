"""Optimizer of the port: AdamW with global-norm clipping and the cosine
warmup schedule (port of ``src/repro/optim``)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.optim.schedule import cosine_warmup

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_warmup",
]
