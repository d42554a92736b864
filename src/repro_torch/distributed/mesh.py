"""The port's device mesh: a grid of torch devices with named axes.

The counterpart of ``jax.sharding.Mesh`` for the sharded counts of
``distributed.tc``. The reference is single-controller: one process holds
the mesh, runs every shard's step on its device and closes each step with
a scalar sum. The port keeps that model, so a ``Mesh`` is only a grid of
``torch.device``s: no process group, no collective. ``devices`` is an
object ``np.ndarray`` (``.shape``, ``.ndim``, ``.size``, ``.reshape``) and
``axis_names`` a tuple, so code reading ``mesh.devices.shape`` ports line
for line. Meshes are hashable and compare by devices and names (pools key
executors by them).

An entry may repeat a device: several *logical* shards then run on one
card (or on the host), each with its own store blocks, index rows and
launches. That is the port's counterpart of the reference's
``--xla_force_host_platform_device_count``: the CPU tests build meshes of
``torch.device("cpu")`` entries, and a single card runs a 2 x 2 mesh of
``cuda:0``. ``make_mesh`` repeats a device only when the caller passes
``devices=``; by default it takes distinct CUDA devices and raises if there
are too few. A mesh that mixes the CPU with CUDA raises ``ValueError``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "mesh_device"]


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported mesh device {str(dev)!r}; use 'cuda:<i>' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class Mesh:
    """A grid of torch devices with one name per axis."""

    def __init__(self, devices, axis_names):
        src = np.asarray(devices, dtype=object)
        grid = np.empty(src.shape, dtype=object)
        for idx, d in np.ndenumerate(src):
            grid[idx] = _as_device(d)
        names = tuple(str(a) for a in axis_names)
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        if len(names) != grid.ndim:
            raise ValueError(
                f"{len(names)} axis names {names} for a {grid.ndim}-axis device grid "
                f"{grid.shape}"
            )
        kinds = {d.type for d in grid.flat}
        if len(kinds) > 1:
            raise ValueError(
                f"a mesh mixes the CPU with CUDA devices: {[str(d) for d in grid.flat]}"
            )
        self.devices = grid
        self.axis_names = names
        self.platform = kinds.pop()

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def unique_devices(self) -> tuple[torch.device, ...]:
        """The distinct devices, in the mesh's (row-major) order."""
        return tuple(dict.fromkeys(self.devices.flat))

    def _key(self) -> tuple:
        return (self.devices.shape, tuple(str(d) for d in self.devices.flat), self.axis_names)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(shape, axis_names, devices=None) -> Mesh:
    """A ``Mesh`` of ``shape`` over ``devices``.

    Without ``devices`` it takes the first ``prod(shape)`` CUDA devices and
    raises ``RuntimeError`` if there are fewer: a missing card is never
    replaced by a repeated one. With ``devices`` (a sequence of torch
    devices or names, repeats allowed — logical shards) it takes the first
    ``prod(shape)`` of them.
    """
    shape = tuple(int(s) for s in shape)
    need = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            raise RuntimeError(
                f"make_mesh{shape} needs {need} CUDA devices, found {have}; pass devices= "
                "(e.g. [torch.device('cuda:0')] * n) to run logical shards on fewer"
            )
        devices = [torch.device("cuda", i) for i in range(need)]
    devices = list(devices)
    if len(devices) < need:
        raise ValueError(f"make_mesh{shape} needs {need} devices, got {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = [_as_device(d) for d in devices[:need]]
    return Mesh(grid.reshape(shape), axis_names)


def mesh_device(mesh, device=None) -> torch.device:
    """The device a count over ``mesh`` runs its single-device work on (its
    first device); ``device``, when given, must be of the mesh's kind."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.distributed.Mesh, got {type(mesh).__name__}")
    dev = mesh.devices.flat[0]
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"device {str(device)!r} is not of the mesh's kind ({mesh.platform})")
    return dev
