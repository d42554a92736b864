"""Production and host mesh construction for the LM launchers.

Port of ``src/repro/launch/mesh.py`` over ``distributed/mesh.py::make_mesh``
(a function: importing this module touches no device).

Single pod:  (data=16, model=16)            = 256 cards
Multi-pod:   (pod=2, data=16, model=16)     = 512 cards

The 'pod' axis is pure data parallelism across slices; 'data' is
ZeRO/FSDP + batch; 'model' is TP/EP/sequence-parallel KV (see
``distributed/lm_sharding.py``). Without ``devices=`` both take distinct
CUDA devices and raise ``RuntimeError`` when there are too few: a missing
card is never replaced by a repeated one. ``devices=[torch.device("cuda",
0)] * 4`` gives four logical shards of one card (``[torch.device("cpu")] *
4`` on the host).
"""
from __future__ import annotations

from repro_torch.distributed.mesh import make_mesh

__all__ = ["make_production_mesh", "make_host_mesh"]


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_host_mesh(data: int = 1, model: int = 1, devices=None):
    """A small (data, model) mesh (tests, the CLI's ``--data/--model``)."""
    return make_mesh((data, model), ("data", "model"), devices)
