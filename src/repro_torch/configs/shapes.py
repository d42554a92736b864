"""Assigned input shapes and the 40-cell (arch x shape) matrix with skips.

Shapes (LM transformers, from the brief):
    train_4k      seq 4,096   global_batch 256   -> train_step
    prefill_32k   seq 32,768  global_batch 32    -> prefill (serve)
    decode_32k    seq 32,768  global_batch 128   -> serve_step (1 new token)
    long_500k     seq 524,288 global_batch 1     -> serve_step (sub-quadratic
                                                   archs only: ssm / hybrid)

Encoder-only archs (hubert) have no decode step -> decode shapes skipped.
All skips carry machine-readable reasons and land in EXPERIMENTS.md §Dry-run.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Shape", "SHAPES", "cell_status", "all_cells"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq: int
    global_batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def cell_status(family: str, shape_name: str) -> tuple[bool, str]:
    """(runs, reason). reason non-empty only for skips."""
    shape = SHAPES[shape_name]
    if family == "audio" and shape.kind == "decode":
        return False, "encoder-only arch: no decode step"
    if shape_name == "long_500k" and family not in SUBQUADRATIC_FAMILIES:
        return False, "long_500k requires sub-quadratic attention (ssm/hybrid only)"
    return True, ""


def all_cells(arch_families: dict[str, str]):
    """Yield (arch, shape_name, runs, reason) over the full 40-cell matrix."""
    for arch, family in arch_families.items():
        for shape_name in SHAPES:
            runs, reason = cell_status(family, shape_name)
            yield arch, shape_name, runs, reason
