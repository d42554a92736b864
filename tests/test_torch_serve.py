"""Port vs reference: cross-graph fused serving, the one-shot server, the
pool's eviction guard and the unfused execute backends.

The JAX package's own SBFs and worklists are carried into the port
(``sbf_from_arrays``/``worklist_from_arrays``), so both packages serve the
same jobs side by side: ``plan_fusion`` must be byte-equal,
``MultiGraphExecutor.count_fused`` and every ``TCServer`` result and counter
equal, and ``tcim_count`` with the unfused backends equal on every config.
Counts are exact integers, so every comparison is equality. The port runs
with ``device="cpu"`` (its kernels' plain versions).
"""
import functools
import threading
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (both packages in one process, JAX on the CPU)
import numpy as np  # noqa: E402

import repro.core as jx_core  # noqa: E402
import repro.core.executor as jx_executor  # noqa: E402
import repro.core.plan as jx_plan  # noqa: E402
import repro.launch.tc_serve as jx_serve  # noqa: E402
import repro.runtime.fault as jx_fault  # noqa: E402
from repro.configs.tcim_graphs import GRAPHS  # noqa: E402
from repro.data.graph_pipeline import load_graph  # noqa: E402
from repro.graphs import GRAPH_GENERATORS, build_graph, rmat  # noqa: E402
from repro.graphs.exact import triangles_intersection  # noqa: E402

import repro_torch.core as pt_core  # noqa: E402
import repro_torch.core.executor as pt_executor  # noqa: E402
import repro_torch.core.plan as pt_plan  # noqa: E402
import repro_torch.launch.tc_serve as pt_serve  # noqa: E402
import repro_torch.runtime.fault as pt_fault  # noqa: E402
from repro_torch.core.sbf import sbf_from_arrays, worklist_from_arrays  # noqa: E402

# Fields of a ServeResult both packages must agree on (latency_s is a clock).
RESULT_FIELDS = ("request_id", "status", "count", "placement", "batch_size", "retries", "detail")


def _job(n, m, seed, slice_bits=64):
    g = build_graph(rmat(n, m, seed=seed))
    sbf = jx_core.build_sbf(g, slice_bits)
    return g, sbf, jx_core.build_worklist(g, sbf)


def _carry(jobs):
    """The reference's (sbf, wl) jobs as the port's host objects."""
    return [(sbf_from_arrays(sb), worklist_from_arrays(wl)) for sb, wl in jobs]


@pytest.fixture(scope="module")
def mixed_jobs():
    """tests/test_serve.py's mix: several pow2 pair buckets + a tiny graph."""
    jobs, want = [], []
    for i, (n, m) in enumerate(
        [(16, 24), (64, 300), (100, 700), (200, 1400), (400, 2500), (64, 320)]
    ):
        g, sbf, wl = _job(n, m, seed=i + 1)
        jobs.append((sbf, wl))
        want.append(triangles_intersection(g))
    return jobs, want


def _serve_both(jobs, **config):
    """Serve ``jobs`` on both servers under the same config; return both
    servers and both result lists sorted by request id."""
    jx = jx_serve.TCServer(jx_serve.ServeConfig(**config))
    pt_config = dict(config)
    if "injector" in pt_config:  # each server gets its own injector
        inj = pt_config["injector"]
        pt_config["injector"] = pt_fault.FailureInjector(
            fail_at_steps=inj.fail_at_steps, fail_every=inj.fail_every, repeats=inj.repeats
        )
    pt = pt_serve.TCServer(pt_serve.ServeConfig(device="cpu", **pt_config))
    jx_res = sorted(jx.serve(jobs), key=lambda r: r.request_id)
    pt_res = sorted(pt.serve(_carry(jobs)), key=lambda r: r.request_id)
    return jx, pt, jx_res, pt_res


def _assert_same_serving(jx, pt, jx_res, pt_res):
    assert [tuple(getattr(r, f) for f in RESULT_FIELDS) for r in pt_res] == [
        tuple(getattr(r, f) for f in RESULT_FIELDS) for r in jx_res
    ]
    assert dict(pt.stats) == dict(jx.stats)
    assert pt.server_stats() == jx.server_stats()
    assert pt.pending == jx.pending == 0


# ---------------------------------------------------------------------------
# Fusion planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad_graphs_pow2", [True, False])
def test_plan_fusion_byte_equal(mixed_jobs, pad_graphs_pow2):
    jobs, _ = mixed_jobs
    for subset in (jobs, jobs[:3], jobs[2:3]):
        want = jx_plan.plan_fusion(subset, pad_graphs_pow2=pad_graphs_pow2)
        got = pt_plan.plan_fusion(_carry(subset), pad_graphs_pow2=pad_graphs_pow2)
        for field in ("row_idx", "col_idx"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()
        for field in (
            "num_graphs", "padded_graphs", "bucket", "words_per_slice", "row_offsets",
            "col_offsets", "row_rows", "col_rows", "real_pairs", "stats", "index_lanes",
            "staged_index_bytes", "store_bytes",
        ):
            assert getattr(got, field) == getattr(want, field), field


def test_plan_fusion_rejects_bad_groups(mixed_jobs):
    """The three ValueErrors: no jobs, a bucket over max_bucket, mixed word
    widths; and the per-segment int32 bound."""
    jobs, _ = mixed_jobs
    port = _carry(jobs)
    for plan_fusion, js in ((jx_plan.plan_fusion, jobs), (pt_plan.plan_fusion, port)):
        with pytest.raises(ValueError, match="at least one"):
            plan_fusion([])
        with pytest.raises(ValueError, match="max_bucket"):
            plan_fusion(js, max_bucket=1)
    _, sbf32, wl32 = _job(64, 300, seed=9, slice_bits=32)
    with pytest.raises(ValueError, match="words_per_slice"):
        jx_plan.plan_fusion([jobs[0], (sbf32, wl32)])
    with pytest.raises(ValueError, match="words_per_slice"):
        pt_plan.plan_fusion(_carry([jobs[0], (sbf32, wl32)]))
    # A worklist past the bound: plan_fusion reads only its length first.
    huge = types.SimpleNamespace(num_pairs=pt_plan.INT32_SAFE_WORDS // 2 + 1)
    with pytest.raises(ValueError, match="int32 bound"):
        jx_plan.plan_fusion([(jobs[-1][0], huge)])
    with pytest.raises(ValueError, match="int32 bound"):
        pt_plan.plan_fusion([(port[-1][0], huge)])


# ---------------------------------------------------------------------------
# MultiGraphExecutor
# ---------------------------------------------------------------------------


def test_count_fused_matches_reference(mixed_jobs):
    jobs, want = mixed_jobs
    jx = jx_executor.MultiGraphExecutor()
    pt = pt_executor.MultiGraphExecutor(device="cpu")
    port = _carry(jobs)
    perm = [3, 0, 5, 2]
    for batch in (list(range(len(jobs))), perm, list(range(len(jobs))), perm, [1]):
        got = pt.count_fused([port[i] for i in batch])
        assert got == jx.count_fused([jobs[i] for i in batch]) == tuple(want[i] for i in batch)
    assert pt.stats() == jx.stats()
    assert (pt.hits, pt.misses) == (2, 3)
    assert pt.dispatches == 5


def test_count_fused_cached_batch_uploads_nothing(mixed_jobs):
    """A cached batch dispatches again against its resident tensors; an
    empty graph fuses to 0; the LRU bound evicts the oldest batch."""
    jobs, want = mixed_jobs
    port = _carry(jobs)
    g_e = build_graph(np.zeros((0, 2), dtype=np.int64))
    sbf_e = jx_core.build_sbf(g_e, 64)
    empty = _carry([(sbf_e, jx_core.build_worklist(g_e, sbf_e))])[0]
    multi = pt_executor.MultiGraphExecutor(max_batches=1, device="cpu")
    assert multi.count_fused([port[0], empty, port[1]]) == (want[0], 0, want[1])
    uploaded = multi.upload_bytes
    assert uploaded > 0
    fut = multi.count_fused_async([port[0], empty, port[1]])
    assert multi.upload_bytes == uploaded and not fut.resolved
    assert fut.result() == (want[0], 0, want[1]) and fut.resolved
    multi.count_fused([port[2]])
    assert len(multi) == 1 and multi.stats()["misses"] == 2
    with pytest.raises(ValueError):
        pt_executor.MultiGraphExecutor(max_batches=0, device="cpu")


# ---------------------------------------------------------------------------
# TCServer, one-shot: the reference's cases, served side by side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GRAPHS))
def test_server_matches_loop_on_bench_configs(name):
    """Every tcim_graphs config (scaled 0.02) served by both servers."""
    g, sbf, wl = load_graph(GRAPHS[name].scaled(0.02), 64)
    want = triangles_intersection(g)
    jx, pt, jx_res, pt_res = _serve_both([(sbf, wl)], max_fused_pairs=1 << 18)
    (res,) = pt_res
    assert res.status == "ok" and res.count == want, name
    _assert_same_serving(jx, pt, jx_res, pt_res)


def test_server_mixed_placements(mixed_jobs):
    jobs, want = mixed_jobs
    cut = sorted(wl.num_pairs for _, wl in jobs)[len(jobs) // 2]
    jx, pt, jx_res, pt_res = _serve_both(jobs, max_fused_pairs=cut)
    assert {r.placement for r in pt_res} == {"fused", "replicated"}
    for r, (_, wl), c in zip(pt_res, jobs, want):
        assert r.count == c
        assert r.placement == ("fused" if wl.num_pairs <= cut else "replicated")
    _assert_same_serving(jx, pt, jx_res, pt_res)


def test_server_admission_waves_and_rejection(mixed_jobs):
    jobs, want = mixed_jobs
    foot = sorted(
        jx_serve.ServeRequest(0, sb, wl, 0.0).footprint_bytes(1 << 20) for sb, wl in jobs
    )
    jx, pt, jx_res, pt_res = _serve_both(jobs, memory_budget_bytes=foot[-2])
    rejected = [r for r in pt_res if r.status == "rejected"]
    assert len(pt_res) == len(jobs) and len(rejected) >= 1
    assert all("exceeds budget" in r.detail for r in rejected)
    assert all(r.count == want[r.request_id] for r in pt_res if r.status == "ok")
    assert pt.stats["waves"] >= 2 and pt.stats["rejected"] == len(rejected)
    _assert_same_serving(jx, pt, jx_res, pt_res)
    for sb, wl in _carry(jobs):
        assert pt_serve.ServeRequest(0, sb, wl, 0.0).footprint_bytes(1 << 10) == (
            jx_serve.ServeRequest(0, sb, wl, 0.0).footprint_bytes(1 << 10)
        )


def test_server_fuse_off_still_exact(mixed_jobs):
    jobs, want = mixed_jobs
    jx, pt, jx_res, pt_res = _serve_both(jobs, fuse=False)
    assert all(r.placement == "replicated" for r in pt_res)
    assert [r.count for r in pt_res] == want
    _assert_same_serving(jx, pt, jx_res, pt_res)


@functools.lru_cache(maxsize=None)
def _soak_jobs():
    jobs, want = [], []
    for i in range(8):
        g, sbf, wl = _job(64, 350, seed=40 + i)
        jobs.append((sbf, wl))
        want.append(triangles_intersection(g))
    return jobs, want


def test_server_fault_injected_soak():
    """A transient failure recovers through the bounded retry, a hard one
    reports status='error'; neither changes another request's count."""
    jobs, want = _soak_jobs()
    inj = jx_fault.FailureInjector(fail_at_steps=(2,))
    jx, pt, jx_res, pt_res = _serve_both(jobs, injector=inj, max_fused_pairs=1 << 12)
    assert [r.count for r in pt_res] == want
    assert pt_res[2].retries >= 1 and "recovered" in pt_res[2].detail
    assert pt.stats["wave_failures"] >= 1
    _assert_same_serving(jx, pt, jx_res, pt_res)

    inj = jx_fault.FailureInjector(fail_at_steps=(5,), repeats=99)
    jx, pt, jx_res, pt_res = _serve_both(
        jobs, injector=inj, max_fused_pairs=1 << 12, max_retries=2, retry_backoff_s=0.0
    )
    assert pt_res[5].status == "error" and "SimulatedFailure" in pt_res[5].detail
    assert pt_res[5].retries == 2 and pt.stats["errors"] == 1
    for i, r in enumerate(pt_res):
        if i != 5:
            assert r.status == "ok" and r.count == want[i], i
    _assert_same_serving(jx, pt, jx_res, pt_res)


@pytest.mark.parametrize("backend", ["pallas_unfused", "pallas_items", "jnp"])
def test_server_modes_match_reference(mixed_jobs, backend):
    """ServeConfig.mode accepts every mode of _SERVE_BACKENDS; the solos run
    in it, with results and counters equal to the reference's."""
    jobs, want = mixed_jobs
    mode = pt_serve._SERVE_BACKENDS[backend]
    assert pt_serve._SERVE_BACKENDS == jx_serve._SERVE_BACKENDS
    jx, pt, jx_res, pt_res = _serve_both(jobs, mode=mode, fuse=False, chunk_pairs=256)
    assert [r.count for r in pt_res] == want
    _assert_same_serving(jx, pt, jx_res, pt_res)


def test_server_daemon_and_unported_options(mixed_jobs):
    """serve_forever publishes every result to wait_result; the stream and
    durability entry points are ported (an unknown stream id raises
    ValueError, as in the reference), and only the mesh and resilience
    options raise naming their ROADMAP item."""
    jobs, want = mixed_jobs
    srv = pt_serve.TCServer(pt_serve.ServeConfig(device="cpu"))
    loop = threading.Thread(target=srv.serve_forever, kwargs={"poll_s": 0.001})
    loop.start()
    try:
        rids = [srv.submit(sb, wl) for sb, wl in _carry(jobs)]
        got = [srv.wait_result(rid, timeout=60).count for rid in rids]
    finally:
        srv.stop()
        loop.join(timeout=60)
    assert not loop.is_alive()
    assert got == want
    with pytest.raises(TimeoutError):
        srv.wait_result(999, timeout=0.01)
    for method in ("submit_delta", "close_stream", "stream_count"):
        with pytest.raises(ValueError, match="unknown stream id 0"):
            getattr(srv, method)(0)
    with pytest.raises(ValueError, match="no checkpoint directory"):
        srv.checkpoint()
    for kwargs in ({"mesh": object()}, {"resilience": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            pt_serve.TCServer(pt_serve.ServeConfig(device="cpu", **kwargs))


def test_server_default_device_has_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pt_serve.TCServer()


# ---------------------------------------------------------------------------
# ExecutorPool: the eviction guard and the stats, against the reference
# ---------------------------------------------------------------------------


def test_pool_eviction_defers_while_future_in_flight():
    """Evicting an executor with a pending CountFuture must not invalidate
    the result: the pool defers the eviction until the future resolves."""
    _, sbf_a, wl_a = _job(200, 1200, seed=1)
    _, sbf_b, wl_b = _job(200, 1200, seed=2)
    _, sbf_c, wl_c = _job(200, 1200, seed=3)
    want = [jx_core.Executor(sb, mode="jnp").count(wl) for sb, wl in
            ((sbf_a, wl_a), (sbf_b, wl_b), (sbf_c, wl_c))]
    (a, wa), (b, wb), (c, wc) = _carry([(sbf_a, wl_a), (sbf_b, wl_b), (sbf_c, wl_c)])
    jx = jx_executor.ExecutorPool(max_graphs=1)
    pool = pt_executor.ExecutorPool(max_graphs=1)
    fut_a = pool.count_async(a, wa, device="cpu")
    jx_a = jx.count_async(sbf_a, wl_a)
    assert not fut_a.resolved and not jx_a.resolved
    fut_b = pool.count_async(b, wb, device="cpu")
    jx_b = jx.count_async(sbf_b, wl_b)
    assert len(pool._entries) == len(jx._entries) == 2  # A is in flight: kept
    assert fut_a.result() == jx_a.result() == want[0] and fut_a.resolved
    assert fut_b.result() == jx_b.result() == want[1]
    assert pool.count(c, wc, device="cpu") == jx.count(sbf_c, wl_c) == want[2]
    assert len(pool._entries) == len(jx._entries) == 1
    assert pool.stats() == jx.stats()


def test_pool_stats_match_reference(mixed_jobs):
    """stats() has the reference's keys and values, trace groups included,
    over a mix of word widths, modes and chunk sizes."""
    jobs, _ = mixed_jobs
    _, sb32, wl32 = _job(64, 300, seed=9, slice_bits=32)
    seq = [(j, "fused", 1 << 20) for j in jobs]
    seq += [(jobs[1], "jnp", 1 << 20), (jobs[2], "fused", 512), ((sb32, wl32), "fused", 1 << 20)]
    seq += [(jobs[0], "fused", 1 << 20), (jobs[3], "fused", 1 << 20)]
    for max_graphs in (3, 16):
        jx = jx_executor.ExecutorPool(max_graphs=max_graphs)
        pt = pt_executor.ExecutorPool(max_graphs=max_graphs)
        for (sb, wl), mode, chunk in seq:
            (psb, pwl), = _carry([(sb, wl)])
            assert pt.count(psb, pwl, mode=mode, chunk_pairs=chunk, device="cpu") == jx.count(
                sb, wl, mode=mode, chunk_pairs=chunk
            )
            assert pt.stats() == jx.stats()
        for (sb, _), mode, chunk in seq:
            (psb, _), = _carry([(sb, _)])
            assert pt_executor.ExecutorPool.trace_key(psb, mode=mode, chunk_pairs=chunk) == (
                jx_executor.ExecutorPool.trace_key(sb, mode=mode, chunk_pairs=chunk)
            )


# ---------------------------------------------------------------------------
# tcim_count with the unfused backends, against the reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _edges(name: str) -> np.ndarray:
    # com-livejournal at 0.02 would cost the JAX side more than the rest of
    # the sweep together (as in tests/test_torch_tcim.py).
    cfg = GRAPHS[name].scaled(0.005 if name == "com-livejournal" else 0.02)
    gen = GRAPH_GENERATORS[cfg.generator]
    if cfg.generator == "grid_road":
        return gen(cfg.n, seed=cfg.seed)
    return gen(cfg.n, cfg.m, seed=cfg.seed)


@pytest.mark.parametrize("slice_bits", [32, 64, 128])
@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("backend", ["pallas_unfused", "pallas_items"])
def test_tcim_count_unfused_backends_match_reference(backend, name, slice_bits):
    edges = _edges(name)
    got = pt_core.tcim_count(edges, slice_bits=slice_bits, backend=backend, device="cpu")
    want = jx_core.tcim_count(edges, slice_bits=slice_bits, backend=backend, build="host")
    assert got.triangles == want.triangles
    assert got.backend == backend and got.stats["num_pairs"] == want.stats["num_pairs"]


@pytest.mark.parametrize("mode", ["gather_then_kernel", "pallas_items", "jnp"])
def test_unfused_modes_count_out_of_range(mode):
    """The unfused modes keep the fused kernel's contract: an index past a
    store is never read, and the count's close raises."""
    _, sb, wl = _job(200, 1200, seed=4)
    (psb, pwl), = _carry([(sb, wl)])
    ex = pt_core.Executor(psb, mode=mode, chunk_pairs=128, device="cpu")
    assert ex.count(pwl) == jx_core.Executor(sb, mode="jnp").count(wl)
    ridx = np.array(pwl.pair_row_pos, dtype=np.int64)
    ridx[3] = ex.row_data.shape[0]
    with pytest.raises(ValueError, match="past the end"):
        ex.execute_indices(ridx, pwl.pair_col_pos)


# ---------------------------------------------------------------------------
# A serve wave's fused batches in one dispatch
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _wave_jobs():
    """Twelve small graphs at slice_bits 32, 64 and 128 (word widths 1, 2
    and 4), so that a wave holds several batches of each width."""
    jobs, want = [], []
    for i in range(12):
        g, sbf, wl = _job(48 + 24 * (i % 4), 6 * (48 + 24 * (i % 4)), seed=60 + i,
                          slice_bits=(32, 64, 128)[i % 3])
        jobs.append((sbf, wl))
        want.append(triangles_intersection(g))
    return jobs, want


def test_server_wave_of_mixed_widths_matches_reference():
    """Batches of every word width go out in one dispatch: the results and
    server_stats() equal the reference server's, whose batches go one by
    one."""
    jobs, want = _wave_jobs()
    jx, pt, jx_res, pt_res = _serve_both(jobs, max_fused_graphs=2)
    assert [r.count for r in pt_res] == want
    assert pt.stats["fused_batches"] >= 6 and pt.stats["waves"] == 1
    assert pt.multi.dispatches == pt.stats["fused_batches"]
    _assert_same_serving(jx, pt, jx_res, pt_res)


@pytest.mark.parametrize("victim", [0, 5, 11])
def test_server_wave_injected_failure_leaves_others_exact(victim):
    """An injected failure keeps its batch out of the wave's dispatch; the
    batch's requests recover solo, every other count is exact, and results
    and counters equal the reference's."""
    jobs, want = _wave_jobs()
    inj = jx_fault.FailureInjector(fail_at_steps=(victim,))
    jx, pt, jx_res, pt_res = _serve_both(jobs, injector=inj, max_fused_graphs=2)
    assert [r.count for r in pt_res] == want
    assert pt_res[victim].retries >= 1 and "recovered" in pt_res[victim].detail
    assert pt.stats["wave_failures"] == 1
    _assert_same_serving(jx, pt, jx_res, pt_res)


def test_wave_dispatch_isolates_planning_and_range_faults():
    """count_fused_wave_async: a batch whose planning raises gets a future
    holding the error and stays out of the dispatch; an index past the
    stacked store raises at its own batch's result() only; the others share
    the wave's one readback and equal count_fused."""
    jobs, _ = _wave_jobs()
    port = _carry(jobs)
    lists = [port[0:3:3], port[1:5:3], [port[0], port[1]], port[2:9:3], port[6:12:3]]
    multi = pt_executor.MultiGraphExecutor(device="cpu")
    want = [pt_executor.MultiGraphExecutor(device="cpu").count_fused(js)
            for js in (lists[0], lists[1], lists[3], lists[4])]
    futs = multi.count_fused_wave_async(lists)
    assert multi.dispatches == 4 and futs[2].failed and futs[2].resolved
    with pytest.raises(ValueError, match="words_per_slice"):
        futs[2].result()
    assert [f.result() for k, f in enumerate(futs) if k != 2] == want
    batches = [multi.prepare(js) for k, js in enumerate(lists) if k != 2]
    batches[1].ridx[int(torch.nonzero(batches[1].ridx >= 0)[0])] = batches[1].row_data.shape[0]
    futs = multi.dispatch(batches)
    assert multi.hits == 4 and multi.dispatches == 8
    with pytest.raises(ValueError, match="past the end"):
        futs[1].result()
    assert [futs[k].result() for k in (0, 2, 3)] == [want[0], want[2], want[3]]
    assert all(f.resolved for k, f in enumerate(futs) if k != 1)
    assert multi.dispatch([]) == []
