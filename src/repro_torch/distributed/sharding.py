"""Partition specs and placed tensors over the port's ``Mesh``.

The counterpart of ``jax.sharding.{PartitionSpec, NamedSharding}`` and of
``jax.device_put(x, sharding)`` for the LM's sharded training. The port is
single-controller (``distributed/mesh.py``): one process holds every block
of a placed tensor and walks the mesh itself.

  * ``PartitionSpec`` (``P``) — one entry a dim: ``None`` (not split), a
    mesh axis name, or a tuple of names (the dim split over their product,
    the first name major). Equality normalises as JAX's does: a one-name
    tuple equals the bare name, an empty tuple equals ``None``.
  * ``NamedSharding(mesh, spec)`` — a spec on a mesh: which block of a
    tensor each mesh position holds.
  * ``ShardedTensor`` — a placed leaf: its global shape and dtype, its
    sharding, and one tensor per distinct (device, block). A replicated
    leaf on four logical shards of one card is one tensor, not four.
  * ``place`` / ``place_tree`` (``jax.device_put``), ``ShardedTensor.full``
    and ``gather_tree`` (the gathered array), ``named_tree`` (a spec tree as
    shardings), ``zeros`` (a placed zero leaf, never dense).
  * A placed cache's regions: ``ShardedTensor.read`` (a region, a view of
    its block where one block holds it) and ``scatter_`` (a dense piece
    written in place into the blocks that hold its region, every copy of
    each: a decode step's token lands in the block holding ``pos``).

A spec whose axes do not divide its dim raises ``ValueError`` naming the
leaf, the dim and the axis size, as ``jax.device_put`` refuses uneven
shardings. Every copy onto a device goes through ``runtime/staging.stage``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.distributed.mesh import _as_device
from repro_torch.models.params import tree_map
from repro_torch.runtime.staging import stage

__all__ = [
    "PartitionSpec",
    "P",
    "NamedSharding",
    "ShardedTensor",
    "place",
    "place_tree",
    "zeros",
    "from_parts",
    "reshard",
    "gather_tree",
    "named_tree",
]


def _norm_entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


def _entry_axes(e) -> tuple[str, ...]:
    e = _norm_entry(e)
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


class PartitionSpec(tuple):
    """A tuple of per-dim entries, compared as JAX compares its specs."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def _normalized(self) -> tuple:
        return tuple(_norm_entry(e) for e in self)

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return NotImplemented
        return self._normalized() == tuple(_norm_entry(e) for e in other)

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self._normalized())

    def __repr__(self):
        return f"P({', '.join(repr(e) for e in self)})"


P = PartitionSpec


class NamedSharding:
    """``spec`` on ``mesh``: the block of a tensor each mesh position holds."""

    def __init__(self, mesh, spec):
        spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
        used = [a for e in spec for a in _entry_axes(e)]
        unknown = [a for a in used if a not in mesh.axis_names]
        if unknown:
            raise ValueError(f"spec {spec} names axes {unknown} not in the mesh's "
                             f"{mesh.axis_names}")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {spec} uses a mesh axis twice")
        self.mesh = mesh
        self.spec = spec
        self._sizes = dict(zip(mesh.axis_names, mesh.devices.shape))

    def _axes(self, ndim: int) -> list[tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has {len(self.spec)} entries for a "
                             f"{ndim}-dim array")
        return [_entry_axes(e) for e in self.spec] + [()] * (ndim - len(self.spec))

    def blocks_per_dim(self, ndim: int) -> tuple[int, ...]:
        return tuple(math.prod(self._sizes[a] for a in axes) for axes in self._axes(ndim))

    def check(self, shape, name: str = "") -> None:
        """Raise ``ValueError`` unless every dim divides into its blocks."""
        for dim, (n, axes) in enumerate(zip(self.blocks_per_dim(len(shape)),
                                            self._axes(len(shape)))):
            if shape[dim] % n:
                raise ValueError(
                    f"leaf {name or '<array>'!s}: dim {dim} of shape {tuple(shape)} "
                    f"({shape[dim]}) does not divide over mesh axes {axes} of size {n}")

    def block_index(self, pos: tuple, ndim: int) -> tuple[int, ...]:
        """The block (an index a dim) that mesh position ``pos`` holds."""
        at = dict(zip(self.mesh.axis_names, pos))
        idx = []
        for axes in self._axes(ndim):
            i = 0
            for a in axes:
                i = i * self._sizes[a] + at[a]
            idx.append(i)
        return tuple(idx)

    def layout(self, ndim: int) -> dict:
        """Mesh position -> (device, block index), in row-major order."""
        return {pos: (dev, self.block_index(pos, ndim))
                for pos, dev in np.ndenumerate(self.mesh.devices)}

    def block_slices(self, shape, idx: tuple) -> tuple[slice, ...]:
        out = []
        for d, n, i in zip(shape, self.blocks_per_dim(len(shape)), idx):
            step = d // n
            out.append(slice(i * step, (i + 1) * step))
        return tuple(out)

    def _key(self, ndim: int) -> tuple:
        return (self.mesh, tuple(self._axes(ndim)))

    def same_blocks(self, other: "NamedSharding", ndim: int) -> bool:
        """Whether ``other`` puts the same blocks on the same positions."""
        return self._key(ndim) == other._key(ndim)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class ShardedTensor:
    """A placed leaf: global ``shape`` and ``dtype``, its ``sharding``, and
    ``blocks``: one tensor per distinct (device, block index)."""

    def __init__(self, shape, dtype, sharding: NamedSharding, blocks: dict):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.blocks = blocks
        self._layout = sharding.layout(len(self.shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def block(self, mesh_index) -> torch.Tensor:
        """The tensor mesh position ``mesh_index`` holds."""
        return self.blocks[self._layout[tuple(mesh_index)]]

    def distinct_blocks(self) -> dict:
        """Block index -> one tensor holding it (the first in mesh order)."""
        out: dict = {}
        for (_, idx), t in self.blocks.items():
            out.setdefault(idx, t)
        return out

    def held(self, idx: tuple, device: torch.device) -> torch.Tensor:
        """Block ``idx`` on ``device``: the tensor held there, else a copy of
        one held elsewhere."""
        t = self.blocks.get((device, idx))
        return t if t is not None else stage(self.distinct_blocks()[idx], device)

    def full(self, device=None) -> torch.Tensor:
        """The gathered tensor on ``device`` (default: the first mesh
        device). A replicated leaf held there is returned as it is."""
        dev = self.sharding.mesh.devices.flat[0] if device is None else _as_device(device)
        parts = self.distinct_blocks()
        if len(parts) == 1:
            (idx,) = parts
            return self.held(idx, dev)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for idx in parts:
            out[self.sharding.block_slices(self.shape, idx)] = self.held(idx, dev)
        return out

    def _region(self, index) -> list[tuple[int, int]]:
        """[(start, stop)] a dim of ``index`` (slices for the leading dims)."""
        out = []
        for d, size in enumerate(self.shape):
            s = index[d] if d < len(index) else slice(None)
            start, stop, step = s.indices(size)
            if step != 1:
                raise ValueError(f"region {index} has a stepped slice")
            out.append((start, stop))
        return out

    def _overlaps(self, region):
        """(block index, slices into the block, slices into the region) of
        every distinct block the region overlaps."""
        for idx in self.distinct_blocks():
            inner, outer = [], []
            for (lo, hi), s in zip(region, self.sharding.block_slices(self.shape, idx)):
                a, b = max(lo, s.start), min(hi, s.stop)
                if a >= b:
                    break
                inner.append(slice(a - s.start, b - s.start))
                outer.append(slice(a - lo, b - lo))
            else:
                yield idx, tuple(inner), tuple(outer)

    def read(self, index, device) -> torch.Tensor:
        """The region ``index`` (a slice a leading dim) on ``device``: a view
        of the block held there when one block holds all of it, else a
        tensor assembled from the blocks it overlaps."""
        dev = _as_device(device)
        region = self._region(index)
        parts = list(self._overlaps(region))
        shape = [hi - lo for lo, hi in region]
        if len(parts) == 1 and all(o.stop - o.start == n for o, n in zip(parts[0][2], shape)):
            idx, inner, _ = parts[0]
            return self.held(idx, dev)[inner]
        out = torch.empty(shape, dtype=self.dtype, device=dev)
        for idx, inner, outer in parts:
            out[outer] = self.held(idx, dev)[inner]
        return out

    def view_at(self, pos, index) -> torch.Tensor:
        """The region ``index`` (a slice a leading dim) as a view of the
        block mesh position ``pos`` holds: nothing is copied or moved.
        Raises ``ValueError`` where that block does not hold all of it."""
        dev, idx = self._layout[tuple(pos)]
        inner = []
        for (lo, hi), s in zip(self._region(index), self.sharding.block_slices(self.shape, idx)):
            if lo < s.start or hi > s.stop:
                raise ValueError(f"block {idx} at {tuple(pos)} does not hold region {index}")
            inner.append(slice(lo - s.start, hi - s.start))
        return self.blocks[(dev, idx)][tuple(inner)]

    def scatter_(self, piece: torch.Tensor, starts) -> None:
        """Write ``piece`` (dense, ``ndim`` dims, cast to ``dtype``) in place
        at the global offsets ``starts``, into every (device, block) entry of
        ``blocks`` it overlaps: a block replicated on distinct devices gets
        the write on each of them."""
        if piece.dim() != self.ndim:
            raise ValueError(f"a {piece.dim()}-dim piece for a {self.ndim}-dim leaf")
        region = [(a, a + n) for a, n in zip(starts, piece.shape)]
        parts = {idx: (inner, outer) for idx, inner, outer in self._overlaps(region)}
        for (dev, idx), t in self.blocks.items():
            if idx in parts:
                inner, outer = parts[idx]
                t[inner].copy_(stage(piece[outer], dev))

    def astype(self, dtype) -> "ShardedTensor":
        """The same blocks converted to ``dtype`` (``self`` when it has it)."""
        if dtype == self.dtype:
            return self
        return ShardedTensor(self.shape, dtype, self.sharding,
                             {k: t.to(dtype) for k, t in self.blocks.items()})

    @property
    def nbytes(self) -> int:
        """Bytes of the tensors held (each distinct (device, block) once)."""
        return sum(t.numel() * t.element_size() for t in self.blocks.values())

    def __repr__(self):
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, {self.sharding.spec}, "
                f"{len(self.blocks)} blocks)")


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, ShardedTensor):
        raise TypeError("place takes a dense array; gather a ShardedTensor with .full() first")
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))


def place(x, sharding: NamedSharding, name: str = "") -> ShardedTensor:
    """``x`` (a tensor on any device, or a NumPy array) placed by
    ``sharding``: each distinct (device, block) copied there once.

    A block that is the whole of ``x`` and already on its device is ``x``
    itself; any other block owns its memory.
    """
    t = _as_tensor(x)
    sharding.check(t.shape, name)
    blocks: dict = {}
    for dev, idx in sharding.layout(t.ndim).values():
        if (dev, idx) in blocks:
            continue
        sl = sharding.block_slices(t.shape, idx)
        whole = all(s.start == 0 and s.stop == d for s, d in zip(sl, t.shape))
        part = t if whole else t[sl]
        if part.device.type == "cpu":
            part = part.contiguous()
        out = stage(part, dev)
        if not whole and out.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
            out = out.clone()
        blocks[(dev, idx)] = out
    return ShardedTensor(t.shape, t.dtype, sharding, blocks)


def zeros(shape, dtype, sharding: NamedSharding, name: str = "") -> ShardedTensor:
    """A zero leaf of ``shape`` placed by ``sharding``, each distinct
    (device, block) allocated where it lies (no dense tensor)."""
    sharding.check(shape, name)
    blocks = {}
    for dev, idx in sharding.layout(len(shape)).values():
        if (dev, idx) not in blocks:
            sl = sharding.block_slices(shape, idx)
            blocks[(dev, idx)] = torch.zeros([s.stop - s.start for s in sl], dtype=dtype,
                                             device=dev)
    return ShardedTensor(shape, dtype, sharding, blocks)


def from_parts(shape, dtype, sharding: NamedSharding, parts: dict) -> ShardedTensor:
    """A ``ShardedTensor`` from one tensor a distinct block index
    (``parts``), copied to every other device that holds the block."""
    blocks = {(dev, idx): stage(parts[idx], dev)
              for dev, idx in sharding.layout(len(shape)).values()}
    return ShardedTensor(shape, dtype, sharding, blocks)


def reshard(x: ShardedTensor, sharding: NamedSharding, name: str = "") -> ShardedTensor:
    """``x`` placed by ``sharding``: its own blocks when they are the same,
    else its gathered tensor placed anew."""
    if x.sharding.same_blocks(sharding, x.ndim):
        return ShardedTensor(x.shape, x.dtype, sharding, dict(x.blocks))
    return place(x.full(), sharding, name)


def _map_named(fn, tree, *rest, path: str = ""):
    if isinstance(tree, dict):
        return {k: _map_named(fn, tree[k], *(r[k] for r in rest), path=f"{path}/{k}")
                for k in sorted(tree)}
    return fn(path.lstrip("/"), tree, *rest)


def place_tree(tree, shardings):
    """``place`` over a nested dict and a matching tree of shardings."""
    return _map_named(lambda name, x, sh: place(x, sh, name), tree, shardings)


def gather_tree(tree, device=None):
    """Every ``ShardedTensor`` of ``tree`` gathered on ``device``."""
    return tree_map(lambda x: x.full(device) if isinstance(x, ShardedTensor) else x, tree)


def named_tree(mesh, specs):
    """A spec tree as ``NamedSharding``s on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), specs)
