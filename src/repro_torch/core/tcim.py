"""TCIM engine — Eq. (5) of the paper as a PyTorch pipeline.

    TC(G) = sum_{A[i][j]=1} BitCount(AND(R_i, C_j))        [upper-triangular A]

Port of ``src/repro/core/tcim.py`` for the default path: ``tcim_count``,
``tcim_count_graph``, ``TCResult``, ``TCFuture`` and ``BACKENDS``, with the
host build front end and the ``replicated`` placement on one device.

Pipeline stages:
    orient      edges -> upper-triangular CSR (optional degree relabelling)
    compress    SBF: valid slices only (paper §IV-B)
    schedule    work list of valid slice pairs
    plan        core.plan.plan_execution — the replicated single stripe
    execute     core.executor.Executor (pooled, staged uploads), the CUDA
                gather–AND–popcount kernel on the card
    reduce      a single exact host readback (``CountFuture.result``)

The first three stages run on the host (NumPy). Per-stage wall-clock lands
in ``TCResult.timings_s`` (``orient``/``compress``/``schedule``/``plan``/
``execute``, plus ``close`` for async counts).

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card, the default raises ``RuntimeError``. Backends and options
that belong to later slices raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import sbf as sbf_mod
from repro_torch.core.executor import CountFuture, ExecutorPool
from repro_torch.core.plan import SCHEDULES, DeviceTopology, plan_execution
from repro_torch.graphs.csr import Graph, build_graph
from repro_torch.kernels.common import resolve_device

__all__ = [
    "TCResult",
    "TCFuture",
    "tcim_count",
    "tcim_count_graph",
    "default_executor_pool",
    "BACKENDS",
    "BUILDS",
]

# One-shot API calls route through a shared pool keyed by store *content*,
# so recounting a graph skips the store upload even though each call builds
# a fresh SBF. LRU-bounded: up to max_graphs recently-counted graphs keep
# their (pow2-padded) stores device-resident after the call returns — call
# default_executor_pool().clear() to release them, or pass pool=.
_DEFAULT_POOL = ExecutorPool(max_graphs=4)


def default_executor_pool() -> ExecutorPool:
    """The module-level pool behind ``tcim_count*(pool=None)``."""
    return _DEFAULT_POOL


# The reference's backend names, so callers see the same choices.
BACKENDS = ("pallas_total", "pallas_unfused", "pallas_items", "jnp", "bitgemm", "mxu")

BUILDS = ("auto", "host", "device")

# User-facing backend -> Executor mode for the ported work-list backends.
_EXECUTOR_MODE = {
    "pallas_total": "fused",
    "pallas_unfused": "gather_then_kernel",
    "pallas_items": "pallas_items",
    "jnp": "jnp",
}

_TODO_BACKENDS = "ROADMAP.md queue 1, item 6 (other execute backends)"
_TODO_BUILD = "ROADMAP.md queue 1, item 5 (device build)"
_TODO_MESH = "ROADMAP.md queue 1, item 9 (distributed)"


@dataclasses.dataclass
class TCResult:
    triangles: int
    backend: str
    stats: dict
    timings_s: dict

    def __repr__(self) -> str:  # compact, log-friendly
        t = ", ".join(f"{k}={v:.4f}" for k, v in self.timings_s.items())
        return f"TCResult(triangles={self.triangles}, backend={self.backend}, {t})"


class TCFuture:
    """A dispatched count whose ``TCResult`` is deferred to ``result()``.

    ``tcim_count*(async_=True)`` returns one of these with every device step
    already enqueued; ``result()`` performs the single host readback (adding
    its wall-clock as ``timings_s['close']``) and caches the ``TCResult``.
    """

    def __init__(self, future: CountFuture, backend: str, stats: dict, timings_s: dict):
        self._future = future
        self.backend = backend
        self.stats = stats
        self.timings_s = timings_s
        self._result: TCResult | None = None

    def result(self) -> TCResult:
        if self._result is None:
            t0 = time.perf_counter()
            triangles = self._future.result()
            self.timings_s["close"] = time.perf_counter() - t0
            self._result = TCResult(triangles, self.backend, self.stats, self.timings_s)
        return self._result


def _validate(backend: str, schedule: str, build: str, mesh, resilience) -> None:
    """Reject what is invalid (ValueError) or not ported (NotImplementedError)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} not in {SCHEDULES}")
    if build not in BUILDS:
        raise ValueError(f"build {build!r} not in {BUILDS}")
    if backend not in _EXECUTOR_MODE:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet: {_TODO_BACKENDS}"
        )
    if build == "device":
        raise NotImplementedError(f"build='device' is not ported yet: {_TODO_BUILD}")
    if mesh is not None or resilience is not None:
        raise NotImplementedError(
            f"mesh= and resilience= are not ported yet: {_TODO_MESH}"
        )


def _count_graph(
    g: Graph,
    *,
    slice_bits: int,
    backend: str,
    chunk_pairs: int,
    collect_stats: bool,
    placement: str,
    pool: ExecutorPool | None,
    device: torch.device,
    async_: bool,
    timings: dict,
) -> TCResult | TCFuture:
    """compress -> schedule -> plan -> execute on a validated request."""
    t0 = time.perf_counter()
    sb = sbf_mod.build_sbf(g, slice_bits)
    timings["compress"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    wl = sbf_mod.build_worklist(g, sb)
    timings["schedule"] = time.perf_counter() - t0

    # One device, no mesh: "auto" resolves to replicated.
    t0 = time.perf_counter()
    plan = plan_execution(
        sb, wl, DeviceTopology(num_devices=1, platform=device.type),
        placement=placement, chunk_pairs=chunk_pairs,
    )
    timings["plan"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # NOT `pool or ...`: an empty ExecutorPool is falsy (it has __len__).
    ex = (pool if pool is not None else _DEFAULT_POOL).get(
        sb, mode=_EXECUTOR_MODE[backend], chunk_pairs=chunk_pairs, device=device
    )
    (stripe,) = plan.stripes
    fut = ex.execute_indices_async(stripe.row_pos, stripe.col_pos)
    dispatch_s = time.perf_counter() - t0
    stats = sbf_mod.sbf_stats(g, sb, wl) if collect_stats else {"n": g.n, "m": g.m}
    stats["placement"] = plan.placement
    stats["build"] = "host"
    stats["device"] = str(device)
    if async_:
        timings["execute"] = dispatch_s
        return TCFuture(fut, backend, stats, timings)
    t0 = time.perf_counter()
    triangles = fut.result()
    timings["execute"] = dispatch_s + time.perf_counter() - t0
    return TCResult(triangles, backend, stats, timings)


def tcim_count_graph(
    g: Graph,
    *,
    slice_bits: int = 64,
    backend: str = "pallas_total",
    chunk_pairs: int = 1 << 20,
    collect_stats: bool = True,
    placement: str = "auto",
    mesh=None,
    pool: ExecutorPool | None = None,
    schedule: str = "packed",
    build: str = "auto",
    async_: bool = False,
    resilience=None,
    device: str | torch.device | None = None,
) -> TCResult | TCFuture:
    """Count triangles of a prebuilt (oriented) Graph.

    ``backend`` picks the execute stage: ``'pallas_total'`` (the fused
    gather–AND–popcount kernel; default), ``'pallas_unfused'`` (torch gather
    + the total kernel), ``'pallas_items'`` (torch gather + the per-pair
    items kernel) or ``'jnp'`` (torch gather + the byte-table oracle);
    ``'bitgemm'`` and ``'mxu'`` are not ported yet. ``build`` ``'auto'`` resolves to ``'host'`` in this
    slice (``stats['build']`` says so). ``placement`` ``'auto'`` and
    ``'replicated'`` run one device; ``schedule`` is validated and only
    matters to the sharded placements. ``pool`` overrides the module-level
    ExecutorPool. ``async_=True`` returns a ``TCFuture`` with every kernel
    enqueued and the host readback deferred to ``result()``. ``device``
    defaults to the card.
    """
    _validate(backend, schedule, build, mesh, resilience)
    dev = resolve_device(device)
    return _count_graph(
        g, slice_bits=slice_bits, backend=backend, chunk_pairs=chunk_pairs,
        collect_stats=collect_stats, placement=placement, pool=pool,
        device=dev, async_=async_, timings={},
    )


def tcim_count(
    edges: np.ndarray,
    *,
    n: int | None = None,
    slice_bits: int = 64,
    backend: str = "pallas_total",
    reorder: bool = True,
    chunk_pairs: int = 1 << 20,
    collect_stats: bool = True,
    placement: str = "auto",
    mesh=None,
    pool: ExecutorPool | None = None,
    schedule: str = "packed",
    build: str = "auto",
    async_: bool = False,
    resilience=None,
    device: str | torch.device | None = None,
) -> TCResult | TCFuture:
    """End-to-end triangle count from a canonical undirected edge list.

    Orients (with the degree relabel when ``reorder``), then runs
    ``tcim_count_graph``; see there for the remaining parameters.
    """
    _validate(backend, schedule, build, mesh, resilience)
    dev = resolve_device(device)
    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    g = build_graph(edges, n=n, reorder=reorder)
    timings["orient"] = time.perf_counter() - t0
    return _count_graph(
        g, slice_bits=slice_bits, backend=backend, chunk_pairs=chunk_pairs,
        collect_stats=collect_stats, placement=placement, pool=pool,
        device=dev, async_=async_, timings=timings,
    )
