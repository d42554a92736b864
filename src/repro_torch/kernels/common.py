"""Shared helpers for the port's kernels and their plain versions.

Port of ``src/repro/kernels/common.py``. Slice words are uint32 in the JAX
package; the port keeps them as int32 *views* of the same bits, because torch
on the CPU has no ``>>`` for ``torch.uint32`` and ``>>`` on int32 is
arithmetic. ``swar_popcount_u32`` therefore widens to int64 and masks to the
low 32 bits before shifting. On the card the kernels use ``__popc`` instead.

``report_cost`` is the hook through which a kernel's wrapper tells an active
cost counter (``analysis/hlo_cost.py::step_cost``) what one launch does:
the counter's dispatch mode sees torch's ops, not a launch through ctypes.
"""
from __future__ import annotations

import torch

__all__ = ["INT32_SAFE_WORDS", "swar_popcount_u32", "resolve_device", "report_cost",
           "COST_SINKS"]

# Largest number of uint32 words whose AND-popcount total provably fits the
# kernels' int32 accumulator: each word contributes at most 32 to the sum.
INT32_SAFE_WORDS = (2**31 - 1) // 32

# Active cost counters, innermost last: each a callable
# ``sink(flops, nbytes, matmul)``. Empty unless a counter is running.
COST_SINKS: list = []


def report_cost(flops: float, nbytes: float, matmul: bool = False) -> None:
    """Tell the innermost active cost counter, if any, that a kernel launch
    (or its stand-in on meta tensors) does ``flops`` operations (tensor-core
    products when ``matmul``) and moves ``nbytes`` of device memory. Costs
    one list test when no counter is active."""
    if COST_SINKS:
        COST_SINKS[-1](flops, nbytes, matmul)


def swar_popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32-viewed uint32 words via SWAR.

    The same shift/mask/add ladder as the reference (no table, no
    multiply), computed in int64 on the zero-extended word so every shift
    is logical. Returns int32 counts in [0, 32].
    """
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F).to(torch.int32)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks.

    ``None`` means ``"cuda"``. A CUDA device without a card present raises
    ``RuntimeError`` — there is no silent CPU fallback; pass ``"cpu"`` to
    run the plain versions on the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev
