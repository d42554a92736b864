"""Elastic re-meshing: resume the same logical job on a different mesh.

Port of ``src/repro/runtime/elastic.py`` (pure Python, unchanged).

Checkpoints are stored unsharded (host NumPy per leaf), so elastic scaling
is: pick the new mesh shape, then place the restored leaves on it. Two
constraints are checked for a training mesh:

  * the 'model' axis must keep its size (TP degree is baked into layouts
    that divide head counts / ffn dims — changing it is a *resharding*
    plan, supported but flagged);
  * batch axes only need global_batch % dp == 0.

For the TC engine, elasticity is cheaper still: the uncounted pairs are
re-planned over the surviving device count — the reduction is a commutative
monoid, so any re-partition of pair stripes is exact.
"""
from __future__ import annotations

import dataclasses

__all__ = ["elastic_remesh_plan", "tc_remesh_plan", "RemeshPlan"]


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    ok: bool
    reasons: tuple[str, ...]

    @property
    def new_device_count(self) -> int:
        out = 1
        for s in self.new_shape:
            out *= s
        return out


def elastic_remesh_plan(
    old_shape: tuple[int, ...],
    axis_names: tuple[str, ...],
    available_devices: int,
    global_batch: int,
    model_axis: str = "model",
) -> RemeshPlan:
    """Choose the largest valid mesh after losing/gaining devices.

    Strategy: keep the model axis fixed; shrink the data axis to the largest
    divisor that fits; drop the pod axis to 1 if necessary.
    """
    shape = dict(zip(axis_names, old_shape))
    model = shape.get(model_axis, 1)
    reasons: list[str] = []
    if available_devices < model:
        return RemeshPlan(
            old_shape, old_shape, axis_names, False,
            (f"need >= {model} devices to keep the model axis", ),
        )
    budget = available_devices // model
    new_pod = 1
    if "pod" in shape:
        new_pod = min(shape["pod"], budget)
        while budget % new_pod:
            new_pod -= 1
        budget //= new_pod
        if new_pod != shape["pod"]:
            reasons.append(f"pod axis {shape['pod']} -> {new_pod}")
    new_data = min(shape.get("data", 1), budget)
    while new_data > 1 and global_batch % (new_data * new_pod):
        new_data -= 1
    if new_pod > 1 and global_batch % (new_data * new_pod):
        # Batch can't split across pods either: collapse to one pod.
        reasons.append(f"pod axis {new_pod} -> 1 (batch divisibility)")
        new_pod = 1
    if new_data != shape.get("data", 1):
        reasons.append(f"data axis {shape.get('data', 1)} -> {new_data}")
    # Axes this policy doesn't know (e.g. expert/sequence axes) pass through
    # at their old size — shrinking them is the caller's policy, not ours.
    known = {"pod": new_pod, "data": new_data, model_axis: model}
    new_shape = tuple(known.get(n, shape[n]) for n in axis_names)
    total = 1
    for s in new_shape:
        total *= s
    if total > available_devices:
        reasons.append(
            f"pass-through axes keep {total} devices > {available_devices} "
            "available"
        )
        return RemeshPlan(old_shape, new_shape, axis_names, False, tuple(reasons))
    return RemeshPlan(old_shape, new_shape, axis_names, True, tuple(reasons))


def tc_remesh_plan(
    grid: tuple[int, int],
    available_devices: int,
    axis_names: tuple[str, str] = ("rows", "cols"),
) -> RemeshPlan:
    """Shrink a TC ``(rows, cols)`` owner grid onto the surviving devices.

    Unlike the train mesh, the TC grid has no divisibility constraints —
    the reduction is a commutative monoid over pair stripes, so ANY
    ``r x c`` factorization is exact after a re-deal. Pick the factorization
    using the most surviving devices, tie-broken toward the old aspect
    (fewest store blocks move on restore): ``(4, 2)`` with 6 survivors
    becomes ``(3, 2)``; ``(1, 4)`` with 3 becomes ``(1, 3)``.
    """
    rows, cols = int(grid[0]), int(grid[1])
    old = (rows, cols)
    if available_devices < 1:
        return RemeshPlan(
            old, old, tuple(axis_names), False, ("no surviving devices",)
        )
    best_key, best = None, old
    for c in range(1, available_devices + 1):
        r = available_devices // c
        key = (r * c, -abs(c - cols), -abs(r - rows))
        if best_key is None or key > best_key:
            best_key, best = key, (r, c)
    reasons = (
        ()
        if best == old
        else (
            f"grid {rows}x{cols} -> {best[0]}x{best[1]} "
            f"({available_devices} surviving devices)",
        )
    )
    return RemeshPlan(old, best, tuple(axis_names), True, reasons)
