"""Fault-tolerance runtime of the port.

Port of ``src/repro/runtime/__init__.py``: failure injection, interrupted
counts, straggler detection and the elastic remesh plans. The reference's
``contracts`` (``no_host_sync`` and the retrace/transfer guards) are not
ported; the sharded count's no-sync promise is checked on the card with
``torch.cuda.set_sync_debug_mode("error")``.
"""
from repro_torch.runtime.elastic import RemeshPlan, elastic_remesh_plan, tc_remesh_plan
from repro_torch.runtime.fault import (
    CountInterrupted,
    FailureInjector,
    SimulatedFailure,
    StragglerMonitor,
)

__all__ = [
    "CountInterrupted",
    "FailureInjector",
    "SimulatedFailure",
    "StragglerMonitor",
    "RemeshPlan",
    "elastic_remesh_plan",
    "tc_remesh_plan",
]
