"""TCIM engine — Eq. (5) of the paper as a PyTorch pipeline.

    TC(G) = sum_{A[i][j]=1} BitCount(AND(R_i, C_j))        [upper-triangular A]

Port of ``src/repro/core/tcim.py``: ``tcim_count``, ``tcim_count_graph``,
``TCResult``, ``TCFuture`` and ``BACKENDS``, with the host and the device
build front ends and the ``replicated`` placement on one device; it
re-exports the streaming API (``StreamingTCState``, ``tcim_count_delta``,
``DeltaResult``) as the reference does.

Pipeline stages:
    orient      edges -> upper-triangular CSR (optional degree relabelling)
    compress    SBF: valid slices only (paper §IV-B)
    schedule    work list of valid slice pairs
    plan        core.plan.plan_execution — the replicated single stripe
    execute     core.executor.Executor (pooled, staged uploads), the CUDA
                gather–AND–popcount kernel on the card
    reduce      a single exact host readback (``CountFuture.result``)

``build`` picks where the first three stages run: ``'host'`` (NumPy) or
``'device'`` (``core.build``: torch work on the device, bit-identical, one
upload of the edge list; the stores and ``-1``-padded index arrays feed
the executor without a host bounce). ``'auto'`` takes the device when the
count runs on a CUDA device, the host otherwise, and falls back to the host
only when the device build refuses the graph with ``ValueError`` (the
int32 index space). Per-stage wall-clock lands in ``TCResult.timings_s``
(``orient``/``compress``/``schedule``/``plan``/``execute``, plus ``close``
for async counts); on the device the first two are enqueue times, and the
schedule stage's sizing readbacks wait for their work.

The dense backends skip compress, schedule and plan: ``'bitgemm'`` runs the
popcount-GEMM kernel over the bit-packed rows and columns of the oriented
adjacency, ``'mxu'`` the masked int8 A @ A tensor-core kernel over its
dense form. Both close eagerly (``timings_s`` has ``orient``/``execute``).

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card, the default raises ``RuntimeError``. Options that belong to
later slices raise ``NotImplementedError`` naming the ROADMAP.md item that
ports them.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import build as build_mod
from repro_torch.core import sbf as sbf_mod
from repro_torch.core.bitmat import words_for_bits
from repro_torch.core.executor import CountFuture, ExecutorPool
from repro_torch.core.plan import SCHEDULES, DeviceTopology, plan_execution, resolve_placement
from repro_torch.core.streaming import (  # noqa: F401  (re-exported: streaming API)
    DeltaResult,
    StreamingTCState,
    tcim_count_delta,
)
from repro_torch.graphs.csr import Graph, build_graph
from repro_torch.kernels import ops
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.tc_bitgemm import padded_words
from repro_torch.kernels.tc_dense_mxu import dense_mxu_operand

__all__ = [
    "TCResult",
    "TCFuture",
    "tcim_count",
    "tcim_count_graph",
    "tcim_count_delta",
    "StreamingTCState",
    "DeltaResult",
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

_DENSE_BACKENDS = ("bitgemm", "mxu")

_TODO_MESH = "ROADMAP.md queue 1, item 4 (distributed)"


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
    if mesh is not None or resilience is not None:
        raise NotImplementedError(
            f"mesh= and resilience= are not ported yet: {_TODO_MESH}"
        )


def _resolve_build(build: str, backend: str, m: int, device: torch.device) -> str:
    """Pick the build front end (see ``BUILDS``).

    Dense backends and empty graphs have nothing to build on the device;
    they always take the host path whatever the request. ``'auto'`` is the
    device on a CUDA device (no mesh reaches here: ``_validate`` refuses
    one), the host otherwise.
    """
    if backend in _DENSE_BACKENDS or m == 0:
        return "host"
    if build == "auto":
        return "device" if device.type == "cuda" else "host"
    return build


def _try_device_build(make_build, build: str):
    """Run a device build; under ``build='auto'`` fall back to the host
    front end (``None``) when the device build refuses the graph with its
    documented ``ValueError`` (int32 index space). An explicit
    ``build='device'`` raises."""
    try:
        return make_build()
    except ValueError:
        if build != "auto":
            raise
        return None


def _pack_words(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """``[n, padded_words(W)]`` uint32 words, ``W = ceil(n/32)``: the first
    W columns have bit ``(r, c)`` set for every pair (``bitmat.bitpack_matrix``
    of the ``n x n`` matrix, packed straight from the pairs), the rest are
    zero, so each row starts on a stride the bitgemm kernel's TMA reads as
    it lies. The pairs are distinct, so the bincount's sum of bits is their
    OR (exact in float64: at most 2^32 - 1 a word)."""
    stride = padded_words(words_for_bits(n))
    flat = rows * stride + (cols >> 5)
    bits = np.left_shift(1, cols & 31).astype(np.float64)
    packed = np.bincount(flat, weights=bits, minlength=n * stride)
    return packed.astype(np.uint32).reshape(n, stride)


def _bitgemm_operands(g: Graph, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The bitgemm backend's int32-viewed words on ``device``: ``x[i]``
    packs row i of the oriented adjacency, ``y[j]`` column j, as ``[:, :W]``
    views of ``_pack_words``' zero-padded rows."""
    src, dst = g.edges[:, 0], g.edges[:, 1]
    w = words_for_bits(g.n)
    x, y = (
        torch.from_numpy(_pack_words(r, c, g.n).view(np.int32)).to(device)[:, :w]
        for r, c in ((src, dst), (dst, src))
    )
    return x, y


def _dense_upper(g: Graph, device: torch.device) -> torch.Tensor:
    """The oriented adjacency as a dense ``[n, n]`` int8 {0,1} matrix,
    scattered from the edges on ``device``."""
    a = dense_mxu_operand(g.n, device)  # row stride padded for the kernel's TMA
    if g.m:
        e = torch.from_numpy(g.edges).to(device)
        a[e[:, 0], e[:, 1]] = 1
    return a


def _execute_bitgemm(g: Graph, device: torch.device, chunk_rows: int = 2048) -> torch.Tensor:
    """Whole-matrix popcount-GEMM path (dense bit-packed operands) -> 0-d
    int64 count on ``device``.

    Chunk ``[start, stop)`` computes the ``[rows, n]`` product and sums it
    at the chunk's edges, which CSR order puts at
    ``indptr[start]:indptr[stop]``, on the device: the count is read back
    once, not the products. A chunk with no edges reads nothing of its
    product and is not computed.
    """
    x, y = _bitgemm_operands(g, device)
    edges = torch.from_numpy(g.edges).to(device)
    total = torch.zeros((), dtype=torch.int64, device=device)
    for start in range(0, g.n, chunk_rows):
        stop = min(start + chunk_rows, g.n)
        lo, hi = int(g.indptr[start]), int(g.indptr[stop])
        if lo == hi:
            continue
        b = ops.bitgemm(x[start:stop], y)
        e = edges[lo:hi]
        total += torch.take(b, (e[:, 0] - start) * g.n + e[:, 1]).sum(dtype=torch.int64)
    return total


def _count_dense(
    g: Graph, *, backend: str, device: torch.device, async_: bool, timings: dict
) -> TCResult | TCFuture:
    """The dense backends: one kernel path and one readback, closed eagerly."""
    t0 = time.perf_counter()
    if backend == "mxu":
        count = ops.dense_mxu_tc(_dense_upper(g, device))
    else:
        count = _execute_bitgemm(g, device)
    triangles = int(count)
    timings["execute"] = time.perf_counter() - t0
    res = TCResult(triangles, backend, {"n": g.n, "m": g.m}, timings)
    if async_:  # dense paths close eagerly; hand back a resolved future
        fut = TCFuture(CountFuture([]), backend, res.stats, timings)
        fut._result = res
        return fut
    return res


def _close(fut: CountFuture, backend: str, stats: dict, timings: dict, dispatch_s: float,
           async_: bool) -> TCResult | TCFuture:
    """Hand back the future, or read the count (``execute`` includes both)."""
    if async_:
        timings["execute"] = dispatch_s
        return TCFuture(fut, backend, stats, timings)
    t0 = time.perf_counter()
    triangles = fut.result()
    timings["execute"] = dispatch_s + time.perf_counter() - t0
    return TCResult(triangles, backend, stats, timings)


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
    """compress -> schedule (host) -> plan -> execute on a validated request."""
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
    return _close(fut, backend, stats, timings, dispatch_s, async_)


def _finish_device(
    db: build_mod.DeviceBuild,
    *,
    backend: str,
    chunk_pairs: int,
    collect_stats: bool,
    placement: str,
    pool: ExecutorPool | None,
    device: torch.device,
    async_: bool,
) -> TCResult | TCFuture:
    """Execute a device build, fully resident: the replicated placement is
    one stripe with nothing to owner-group, so the plan stage is trivial,
    and skipping the planner keeps the work list on the device."""
    timings = dict(db.timings_s)
    resolve_placement(placement, db.sbf, DeviceTopology(num_devices=1, platform=device.type))
    timings["plan"] = 0.0
    t0 = time.perf_counter()
    ex = (pool if pool is not None else _DEFAULT_POOL).get(
        db.sbf, mode=_EXECUTOR_MODE[backend], chunk_pairs=chunk_pairs, device=device
    )
    fut = ex.count_async(db.worklist)
    dispatch_s = time.perf_counter() - t0
    g = db.graph
    stats = sbf_mod.sbf_stats(g, db.sbf, db.worklist) if collect_stats else {"n": g.n, "m": g.m}
    stats["placement"] = "replicated"
    stats["build"] = "device"
    stats["device"] = str(device)
    return _close(fut, backend, stats, timings, dispatch_s, async_)


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
    items kernel), ``'jnp'`` (torch gather + the byte-table oracle), or the
    dense ``'bitgemm'`` (popcount-GEMM over bit-packed rows and columns, in
    chunks of 2048 rows) and ``'mxu'`` (masked int8 A @ A on the tensor
    cores), which return ``stats`` ``{"n", "m"}`` and close eagerly.
    ``build`` picks the front end (module docstring; ``stats['build']``
    says which ran): ``'device'`` uploads ``g.edges`` once and builds the
    SBF and work list on the device (``core.build.device_build_graph``),
    ``'auto'`` does so on a CUDA device; dense backends accept
    ``'device'`` and build on the host, as in the reference. ``placement``
    ``'auto'`` and
    ``'replicated'`` run one device; ``schedule`` is validated and only
    matters to the sharded placements. ``pool`` overrides the module-level
    ExecutorPool. ``async_=True`` returns a ``TCFuture`` with every kernel
    enqueued and the host readback deferred to ``result()``. ``device``
    defaults to the card.
    """
    _validate(backend, schedule, build, mesh, resilience)
    dev = resolve_device(device)
    if backend in _DENSE_BACKENDS:
        return _count_dense(g, backend=backend, device=dev, async_=async_, timings={})
    finish = dict(backend=backend, chunk_pairs=chunk_pairs, collect_stats=collect_stats,
                  placement=placement, pool=pool, device=dev, async_=async_)
    if _resolve_build(build, backend, g.m, dev) == "device":
        db = _try_device_build(
            lambda: build_mod.device_build_graph(g, slice_bits, device=dev), build
        )
        if db is not None:
            return _finish_device(db, **finish)
    return _count_graph(g, slice_bits=slice_bits, timings={}, **finish)


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

    Orients (with the degree relabel when ``reorder``), then runs the
    rest of the pipeline; see ``tcim_count_graph`` for the remaining
    parameters. With the device build (``build='device'``, or ``'auto'``
    on a CUDA device) the edge list is the one host->device transfer:
    orient, compress and schedule run on the device
    (``core.build.device_build``) and the executor adopts their arrays
    where they lie.
    """
    _validate(backend, schedule, build, mesh, resilience)
    dev = resolve_device(device)
    finish = dict(backend=backend, chunk_pairs=chunk_pairs, collect_stats=collect_stats,
                  placement=placement, pool=pool, device=dev, async_=async_)
    if _resolve_build(build, backend, len(edges), dev) == "device":
        db = _try_device_build(
            lambda: build_mod.device_build(
                edges, n=n, slice_bits=slice_bits, reorder=reorder, device=dev
            ),
            build,
        )
        if db is not None:
            return _finish_device(db, **finish)
    # The host build; under "auto" also the device build's fallback, whose
    # stage timings restart here.
    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    g = build_graph(edges, n=n, reorder=reorder)
    timings["orient"] = time.perf_counter() - t0
    if backend in _DENSE_BACKENDS:
        return _count_dense(g, backend=backend, device=dev, async_=async_, timings=timings)
    return _count_graph(g, slice_bits=slice_bits, timings=timings, **finish)
