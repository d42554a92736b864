"""Gradient compression for the cross-pod all-reduce.

Port of ``src/repro/distributed/compression.py``. int8 quantization with a
per-tensor scale and error feedback (Seide et al.; the 1-bit Adam lineage):
the residual buffer makes the quantization error telescope instead of
accumulate. Every function rounds half to even, as ``jnp.round`` does, so
the results are bit-equal to the reference's on the same inputs.

``compressed_psum_mean`` is the mean over one mesh axis with int8 on the
wire, over the port's logical shards: entry ``i`` of a stacked leaf lives
on the device at position ``i`` along the axis. The reference's train step
does not call it, and neither does the port's.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import ShardedTensor
from repro_torch.models.params import tree_map
from repro_torch.runtime.staging import stage

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum_mean", "ef_update"]


def _q(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q, scale), the scale a float32
    0-d tensor."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    return _q(xf, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_update(grad: torch.Tensor, residual: torch.Tensor):
    """Error-feedback step: quantize (grad + residual), carry the new error.
    Returns (q, scale, new_residual)."""
    target = grad.float() + residual
    q, scale = quantize_int8(target)
    return q, scale, target - dequantize_int8(q, scale)


def _entries(leaf, mesh, axis: str) -> list[tuple[torch.device, torch.Tensor]]:
    """(device, entry) for each position along ``axis``: a placed leaf's
    block there, or row ``i`` of a dense leaf on mesh position ``i``'s
    device."""
    n = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
    if leaf.shape[0] != n:
        raise ValueError(f"a stacked leaf's leading dim {leaf.shape[0]} != axis {axis!r} size {n}")
    where = mesh.axis_names.index(axis)
    out = []
    for i in range(n):
        pos = tuple(i if d == where else 0 for d in range(mesh.devices.ndim))
        dev = mesh.devices[pos]
        if isinstance(leaf, ShardedTensor):
            block = leaf.block(pos)
            if block.shape[0] != 1:
                raise ValueError(f"a stacked leaf must split over {axis!r}, got "
                                 f"{leaf.sharding.spec}")
            out.append((dev, block[0]))
        else:
            out.append((dev, stage(leaf[i], dev)))
    return out


def compressed_psum_mean(stacked_grads, mesh, axis: str):
    """Mean over mesh axis ``axis`` with int8 on the wire.

    ``stacked_grads``: a nested dict whose leaves (dense tensors, or
    ``ShardedTensor``s placed over ``axis`` on dim 0) have a leading dim
    equal to the axis size — entry i is rank i's local gradient. Scheme: one
    shared amax first, each entry quantized against the SHARED scale, an
    exact int32 sum in a fixed order (rank 0 first), dequantize, divide by
    n. Returns the stacked tree, every entry holding the identical mean (a
    placed leaf comes back placed the same way).
    """

    def one(leaf):
        entries = _entries(leaf, mesh, axis)
        home = entries[0][0]
        xs = [(dev, x.float()) for dev, x in entries]
        amax = torch.stack([stage(x.abs().max(), home) for _, x in xs]).max()
        scale = torch.clamp(amax, min=1e-12) / 127.0
        total = None
        for dev, x in xs:
            q = stage(_q(x, stage(scale, dev)), home).to(torch.int32)  # int8 on the wire
            total = q if total is None else total + q
        mean = (total.float() * scale / float(len(xs))).to(leaf.dtype)
        if isinstance(leaf, ShardedTensor):
            blocks = {key: stage(mean, key[0])[None] for key in leaf.blocks}
            return ShardedTensor(leaf.shape, leaf.dtype, leaf.sharding, blocks)
        return mean[None].expand(leaf.shape).clone()

    return tree_map(one, stacked_grads)
