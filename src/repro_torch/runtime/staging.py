"""The port's one staging function: every explicit host->device copy.

``stage`` is to the port what ``jax.device_put`` is to the reference: the
sanctioned way onto a device, and the call ``max_transfers`` counts. Each
call charges the entering thread's open ``max_transfers`` regions through
``contracts.note_transfer`` on every device, the CPU included. The lint's
TCL002 (``tools.tclint_torch``) flags any other host->device copy in the
port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.runtime.contracts import note_transfer

__all__ = ["stage"]


def stage(x, device: str | torch.device, *, non_blocking: bool = True,
          copy: bool = False) -> torch.Tensor:
    """``x`` (a NumPy array or a tensor) on ``device``, counted as one
    staging call.

    To the card a host array or tensor goes through pinned memory and a
    non-blocking copy on the current stream (no host sync); with
    ``non_blocking=False`` it is a blocking copy from pageable memory, which
    waits for the stream. On the CPU a host value comes back as it lies (a
    NumPy array as a view), or as a private copy with ``copy=True``. A
    tensor on another device is copied there; read back to the CPU, that is
    a host sync, and ``no_host_sync`` trips on it. A tensor that takes a
    gradient is copied by ``Tensor.to`` alone, which keeps its graph (the
    pinned copy does not).
    """
    note_transfer()
    device = torch.device(device)
    t = x
    if isinstance(x, np.ndarray):  # ascontiguousarray makes a 0-d array 1-d
        t = torch.from_numpy(np.ascontiguousarray(x).reshape(x.shape))
    on_host = t.device.type == "cpu"
    if device.type == "cpu" and on_host:
        return t.clone() if copy else t
    if on_host and non_blocking and not (t.requires_grad and torch.is_grad_enabled()):
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
