"""Meta-device stand-ins for every (arch x shape) cell — no allocation.

Port of ``src/repro/launch/specs.py``: tensors on the ``"meta"`` device
stand in for ``jax.ShapeDtypeStruct``. ``input_specs(arch, shape_name)``
returns everything a step takes:
    train:   (params, opt_state, batch)
    prefill: (params, cache, batch)
    decode:  (params, cache, token, pos)

Shapes come from ``configs/shapes.py``; the parameter, optimizer and cache
trees are built on the meta device straight from ``model_schema`` and the
cache's shapes, so nothing is allocated even at qwen1.5-110b x train_4k.
"""
from __future__ import annotations

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.shapes import Shape, cell_status
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import cache_zeros, model_schema
from repro_torch.models.params import tree_map
from repro_torch.optim import adamw_init

__all__ = ["input_specs", "batch_struct", "params_struct", "CellSpec"]

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def batch_struct(cfg: ModelConfig, shape: Shape, with_labels: bool) -> dict:
    b, s = shape.global_batch, shape.seq
    batch = {}
    if cfg.family == "audio":
        batch["frames"] = _sds((b, s, cfg.d_frontend), torch.bfloat16)
        if with_labels:
            batch["labels"] = _sds((b, s), torch.int32)
            batch["mask"] = _sds((b, s), torch.bool)
    else:
        batch["tokens"] = _sds((b, s), torch.int32)
        if with_labels:
            batch["labels"] = _sds((b, s), torch.int32)
    if cfg.family == "vlm":
        batch["image_embeds"] = _sds((b, cfg.n_image_tokens, cfg.d_frontend), torch.bfloat16)
    return batch


def params_struct(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` as meta tensors, in ``init_model``'s
    dtypes: ``cfg.dtype``, the SSM's ``a_log`` and ``dt_bias`` float32."""
    dtype = getattr(torch, cfg.dtype)
    return tree_map(lambda d: _sds(d.shape, torch.float32 if d.init in ("a_log", "dt_bias")
                                   else dtype), model_schema(cfg))


class CellSpec:
    """Everything a step of one (arch, shape) cell takes, on the meta device."""

    def __init__(self, arch: str, shape_name: str):
        self.arch = arch
        self.shape = SHAPES[shape_name]
        self.cfg = get_config(arch)
        self.runs, self.skip_reason = cell_status(self.cfg.family, shape_name)

    def params_struct(self):
        return params_struct(self.cfg)

    def opt_struct(self):
        return adamw_init(self.params_struct())

    def cache_struct(self):
        return cache_zeros(self.cfg, self.shape.global_batch, self.shape.seq, META)

    def args(self):
        """Positional meta-tensor args for the step function."""
        kind = self.shape.kind
        if kind == "train":
            return (self.params_struct(), self.opt_struct(),
                    batch_struct(self.cfg, self.shape, with_labels=True))
        if kind == "prefill":
            return (self.params_struct(), self.cache_struct(),
                    batch_struct(self.cfg, self.shape, with_labels=False))
        # decode: one new token against a seq-long cache
        return (self.params_struct(), self.cache_struct(),
                _sds((self.shape.global_batch, 1), torch.int32), _sds((), torch.int32))


def input_specs(arch: str, shape_name: str):
    return CellSpec(arch, shape_name).args()
