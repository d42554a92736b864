"""Config registry of the port: the 10 LM architectures + TCIM graph workloads.

Port of ``src/repro/configs/__init__.py``. ``get_config(arch_id)`` /
``get_smoke_config(arch_id)`` resolve the dashed public ids; ``ARCHS``
lists them in the brief's order. The config files are data only, copied
from the JAX package with the port's ``ModelConfig``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, Shape, all_cells, cell_status
from repro_torch.configs.tcim_graphs import GRAPHS, GraphConfig
from repro_torch.models.config import ModelConfig

__all__ = [
    "ARCHS",
    "get_config",
    "get_smoke_config",
    "arch_families",
    "SHAPES",
    "Shape",
    "all_cells",
    "cell_status",
    "GRAPHS",
    "GraphConfig",
]

_MODULES = {
    "mamba2-780m": "mamba2_780m",
    "dbrx-132b": "dbrx_132b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen1.5-110b": "qwen1_5_110b",
    "minicpm3-4b": "minicpm3_4b",
    "smollm-135m": "smollm_135m",
    "deepseek-67b": "deepseek_67b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "zamba2-7b": "zamba2_7b",
    "hubert-xlarge": "hubert_xlarge",
}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def arch_families() -> dict[str, str]:
    return {a: get_config(a).family for a in ARCHS}
