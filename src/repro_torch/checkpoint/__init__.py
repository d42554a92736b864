"""Checkpointing of the port (port of ``src/repro/checkpoint/__init__.py``)."""
from repro_torch.checkpoint.store import (
    CheckpointManager,
    latest_step,
    list_steps,
    load_checkpoint,
    save_checkpoint,
)

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint", "list_steps", "latest_step"]
