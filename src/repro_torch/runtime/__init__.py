"""Fault-tolerance runtime of the port.

Port of ``src/repro/runtime/__init__.py`` for the serving slice: only the
failure injection that ``TCServer``'s retry path needs. ``CountInterrupted``,
``StragglerMonitor``, the elastic remesh plans and the contracts come with
the distributed slice (ROADMAP.md queue 1, item 4).
"""
from repro_torch.runtime.fault import FailureInjector, SimulatedFailure

__all__ = ["FailureInjector", "SimulatedFailure"]
