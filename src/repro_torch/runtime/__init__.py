"""Fault-tolerance runtime and hot-path contracts of the port.

Port of ``src/repro/runtime/__init__.py``: failure injection, interrupted
counts, straggler detection, the elastic remesh plans and the runtime
contracts (``no_host_sync``, ``max_transfers``, ``max_retrace``), enforced
where the count paths are dispatched whenever ``TCIM_CONTRACTS`` is truthy.
``staging.stage`` is the one host->device copy that ``max_transfers``
counts.
"""
from repro_torch.runtime.contracts import (
    ContractViolation,
    contracts_enabled,
    max_retrace,
    max_transfers,
    no_host_sync,
)
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
    "ContractViolation",
    "contracts_enabled",
    "max_retrace",
    "max_transfers",
    "no_host_sync",
]
