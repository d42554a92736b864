"""Checkpointing of nested host and device arrays, with atomic commit.

Port of ``src/repro/checkpoint/store.py`` (``save_checkpoint``,
``load_checkpoint``, ``list_steps``, ``latest_step`` and
``CheckpointManager``) in NumPy and torch, with no JAX and no ``ml_dtypes``.
The on-disk layout is the reference's, so a directory written by either
package loads in the other:

    step_000100/
      manifest.json     leaf paths, files, shapes and dtypes; step; extra
      leaf_00000.npy    one file per leaf
      _COMMITTED        sentinel written last -> crash-safe visibility

A save stages into ``.tmp_step_*`` and renames it into place after the
sentinel, so a partial checkpoint is invisible to discovery and is
garbage-collected later (``CheckpointManager.gc_orphans``).

Trees are nested dicts, lists and tuples whose leaves are NumPy arrays,
torch tensors or scalars; ``None`` is an empty subtree, as in JAX. Leaf
paths are JAX's key paths as strings (``['r5']/['row_ptr']``, ``[0]`` for a
sequence index), with dict keys visited in sorted order. Tensors are copied
to the host, and a placed leaf (``distributed.sharding.ShardedTensor``)
is gathered whole, so a sharded state writes the files a dense one does.
Extension dtypes are stored as raw integers of the same width
under the reference's names: a torch ``bfloat16`` tensor is saved as
``uint16`` under ``"bfloat16"``, and such leaves load back as torch tensors
of their dtype (NumPy has no bfloat16 without ``ml_dtypes``).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "list_steps",
    "latest_step",
    "CheckpointManager",
]

_SENTINEL = "_COMMITTED"

# Extension dtypes: the reference's names -> (torch dtype, the integer dtype
# of the same width both torch and NumPy hold, the raw width on disk).
_EXT_DTYPES = {
    "bfloat16": (torch.bfloat16, (torch.int16, np.int16), np.uint16),
    "float8_e4m3fn": (torch.float8_e4m3fn, (torch.uint8, np.uint8), np.uint8),
    "float8_e5m2": (torch.float8_e5m2, (torch.uint8, np.uint8), np.uint8),
}
_TORCH_EXT = {dtype: name for name, (dtype, _, _) in _EXT_DTYPES.items()}


def _to_host(leaf) -> np.ndarray | torch.Tensor:
    """A leaf on the host: NumPy, or a CPU tensor of an extension dtype (a
    placed leaf gathered whole)."""
    from repro_torch.distributed.sharding import ShardedTensor

    if isinstance(leaf, ShardedTensor):
        leaf = leaf.full("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return t if t.dtype in _TORCH_EXT else t.numpy()
    return np.asarray(leaf)


def _to_disk(arr) -> tuple[np.ndarray, str]:
    if isinstance(arr, torch.Tensor):  # an extension dtype (``_to_host``)
        name = _TORCH_EXT[arr.dtype]
        _, same_width, raw = _EXT_DTYPES[name]
        return arr.contiguous().view(same_width[0]).numpy().view(raw), name
    name = str(arr.dtype)
    if name in _EXT_DTYPES:  # a NumPy extension dtype (e.g. from ml_dtypes)
        return arr.view(_EXT_DTYPES[name][2]), name
    return arr, name


def _from_disk(arr: np.ndarray, dtype_str: str):
    if dtype_str in _EXT_DTYPES:
        dtype, same_width, _ = _EXT_DTYPES[dtype_str]
        return torch.from_numpy(np.ascontiguousarray(arr).view(same_width[1])).view(dtype)
    return arr


def _flatten(tree, prefix: tuple = ()):
    """``[(key path, leaf)]`` in JAX's order: dict keys sorted, sequences in
    order, ``None`` contributing nothing."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [leaf for key, sub in items for leaf in _flatten(sub, prefix + (key,))]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in ``_flatten`` order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _flatten_with_paths(tree) -> tuple[list[str], list]:
    flat = _flatten(tree)
    return ["/".join(path) for path, _ in flat], [leaf for _, leaf in flat]


def _place(arr, sharding, path: str):
    from repro_torch.distributed.sharding import place

    return place(arr, sharding, path)


def _map_leaves(fn, tree):
    return _unflatten(tree, iter([fn(leaf) for _, leaf in _flatten(tree)]))


def save_checkpoint(directory: str | Path, step: int, tree, extra: dict | None = None):
    """Synchronous save with atomic commit. Returns the checkpoint path."""
    directory = Path(directory)
    ckpt = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    paths, leaves = _flatten_with_paths(tree)
    manifest = {
        "step": int(step),
        "time": time.time(),
        "extra": extra or {},
        "leaves": [],
    }
    for i, (path, leaf) in enumerate(zip(paths, leaves, strict=True)):
        arr = _to_host(leaf)
        disk_arr, dtype_str = _to_disk(arr)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, disk_arr)
        manifest["leaves"].append(
            {"path": path, "file": fname, "shape": list(arr.shape), "dtype": dtype_str}
        )
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    (tmp / _SENTINEL).write_text("ok")
    if ckpt.exists():
        shutil.rmtree(ckpt)
    tmp.rename(ckpt)
    return ckpt


def _is_committed(path: Path) -> bool:
    return (path / _SENTINEL).exists()


def list_steps(directory: str | Path) -> list[int]:
    """All committed checkpoint steps under ``directory``, ascending.
    Uncommitted (.tmp / sentinel-less) directories are invisible."""
    directory = Path(directory)
    if not directory.exists():
        return []
    return sorted(
        int(p.name.split("_")[1])
        for p in directory.iterdir()
        if p.name.startswith("step_") and _is_committed(p)
    )


def latest_step(directory: str | Path) -> int | None:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str | Path, tree_like, step: int | None = None,
                    shardings=None):
    """Restore into the structure of ``tree_like``; optional placement.

    Leaves come back as host NumPy arrays (extension dtypes as CPU torch
    tensors). A ``tree_like`` leaf with a ``shape`` must match the stored
    shape. ``shardings``, a matching tree of
    ``distributed.sharding.NamedSharding``, places each leaf by its
    sharding (the elastic restore onto another mesh). Returns ``(tree,
    step, extra)``.
    """
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory}")
    ckpt = directory / f"step_{step:08d}"
    manifest = json.loads((ckpt / "manifest.json").read_text())
    paths, leaves = _flatten_with_paths(tree_like)
    by_path = {rec["path"]: rec for rec in manifest["leaves"]}
    sh_leaves = ([sh for _, sh in _flatten(shardings)] if shardings is not None
                 else [None] * len(leaves))
    out = []
    for path, leaf, sh in zip(paths, leaves, sh_leaves, strict=True):
        rec = by_path.get(path)
        if rec is None:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        arr = _from_disk(np.load(ckpt / rec["file"]), rec["dtype"])
        expect = tuple(leaf.shape) if hasattr(leaf, "shape") else None
        if expect is not None and tuple(arr.shape) != expect:
            raise ValueError(f"shape mismatch for {path}: {tuple(arr.shape)} vs {expect}")
        out.append(arr if sh is None else _place(arr, sh, path))
    return _unflatten(tree_like, iter(out)), manifest["step"], manifest["extra"]


class CheckpointManager:
    """Async, retention-managed checkpointing (``keep_last`` committed steps)."""

    def __init__(self, directory: str | Path, keep_last: int = 3):
        self.directory = Path(directory)
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.directory.mkdir(parents=True, exist_ok=True)

    def save_async(self, step: int, tree, extra: dict | None = None):
        """Device->host copy now; file I/O on a background thread."""
        host_tree = _map_leaves(_to_host, tree)
        self.wait()

        def _write():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except BaseException as e:  # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def save(self, step: int, tree, extra: dict | None = None):
        self.wait()
        save_checkpoint(self.directory, step, tree, extra)
        self._gc()

    def wait(self):
        """Join the in-flight save. A failed background write re-raises here
        — a silently dropped checkpoint must never masquerade as durable."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write to {self.directory} failed") from err

    def restore(self, tree_like, step: int | None = None, shardings=None):
        self.wait()
        return load_checkpoint(self.directory, tree_like, step, shardings)

    def latest_step(self):
        return latest_step(self.directory)

    def gc_orphans(self) -> int:
        """Delete uncommitted ``.tmp_step_*`` leftovers; returns how many.

        A save killed between staging and the sentinel rename leaves a tmp
        directory that discovery already ignores; restore paths call this so
        a crash-recovered process reclaims the disk at once.
        """
        orphans = list(self.directory.glob(".tmp_step_*"))
        for p in orphans:
            shutil.rmtree(p, ignore_errors=True)
        return len(orphans)

    def _gc(self):
        steps = sorted(
            p
            for p in self.directory.iterdir()
            if p.name.startswith("step_") and _is_committed(p)
        )
        for p in steps[: -self.keep_last]:
            shutil.rmtree(p, ignore_errors=True)
        self.gc_orphans()
