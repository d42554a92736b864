"""Runtime contracts of the port (``repro_torch/runtime/contracts.py``).

Each test of ``tests/test_contracts.py`` has a counterpart here, in the same
order: the env flag, the three contracts in both forms (tripping, clean and
off), the patched classes restored, the hot paths clean, and the three
thread-scoping cases. Then the armed clean runs of the wired paths, each
equal to the exact oracle, and one planted violation a wired site. The
contracts are env-gated (``TCIM_CONTRACTS``); every test sets the variable
itself, so they pass whether or not the run is armed. Everything runs on
the CPU, where the stubs trip on host tensors as the reference's trip on
CPU jax arrays.
"""
import threading

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import build as build_mod  # noqa: E402
from repro_torch.core import executor as executor_mod  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DeviceTopology,
    Executor,
    MultiGraphExecutor,
    StreamingTCState,
    build_sbf,
    build_worklist,
    default_executor_pool,
    device_build_async,
    plan_execution,
    tcim_count,
    tcim_count_delta,
)
from repro_torch.distributed import (  # noqa: E402
    Sharded2DExecutor,
    ShardedColsExecutor,
    distributed_tc_count_async,
    make_mesh,
)
from repro_torch.graphs import build_graph, rmat, triangles_intersection  # noqa: E402
from repro_torch.runtime import contracts  # noqa: E402
from repro_torch.runtime.contracts import (  # noqa: E402
    ContractViolation,
    contracts_enabled,
    max_retrace,
    max_transfers,
    no_host_sync,
)
from repro_torch.runtime.staging import stage  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def contracts_on(monkeypatch):
    monkeypatch.setenv("TCIM_CONTRACTS", "1")


@pytest.fixture
def contracts_off(monkeypatch):
    monkeypatch.setenv("TCIM_CONTRACTS", "0")


def _sync_scalar():
    # Deliberate readback: int() of a tensor.
    return int(torch.arange(8).sum())


def _graph(n=128, m=400, seed=3):
    g = build_graph(rmat(n, m, seed=seed), n=n, reorder=False)
    sb = build_sbf(g, 64)
    return g, sb, build_worklist(g, sb)


def _class_state():
    """Everything the no_host_sync stubs patch, as it stands."""
    return (dict(torch.Tensor.__dict__), torch.cuda.synchronize,
            dict(torch.cuda.Stream.__dict__), dict(torch.cuda.Event.__dict__))


def test_enabled_flag_reads_env(monkeypatch):
    monkeypatch.setenv("TCIM_CONTRACTS", "1")
    assert contracts_enabled()
    monkeypatch.setenv("TCIM_CONTRACTS", "off")
    assert not contracts_enabled()
    monkeypatch.delenv("TCIM_CONTRACTS")
    assert not contracts_enabled()


# -- no_host_sync ---------------------------------------------------------


def test_no_host_sync_trips_on_syncing_function(contracts_on):
    guarded = no_host_sync()(_sync_scalar)
    with pytest.raises(ContractViolation, match="no_host_sync"):
        guarded()


def test_no_host_sync_context_manager_trips(contracts_on):
    with pytest.raises(ContractViolation, match="no_host_sync"):
        with no_host_sync():
            _sync_scalar()


def test_no_host_sync_allows_pure_dispatch(contracts_on):
    @no_host_sync()
    def dispatch(x):
        staged = stage(np.arange(4, dtype=np.int32), CPU)  # explicit staging is legal
        return (x + staged).to(torch.int64)  # a dtype cast is not a readback

    out = dispatch(torch.zeros(4, dtype=torch.int32))
    assert int(out.sum()) == 6  # readback outside the guarded region


def test_no_host_sync_noop_when_disabled(contracts_off):
    before = _class_state()
    assert no_host_sync()(_sync_scalar)() == 28
    with no_host_sync():
        assert _class_state() == before  # nothing installed
        assert _sync_scalar() == 28


# -- max_transfers --------------------------------------------------------


def test_max_transfers_trips_over_budget(contracts_on):
    with pytest.raises(ContractViolation, match="max_transfers"):
        with max_transfers(1):
            stage(np.arange(4), CPU)
            stage(np.arange(4), CPU)


def test_max_transfers_within_budget(contracts_on):
    with max_transfers(2) as ct:
        stage(np.arange(4), CPU)
        stage(torch.arange(4), CPU, copy=True)
    assert ct.count == 2


def test_max_transfers_restores_staging_apis(contracts_on):
    """After tripping regions the patched classes are the originals again
    and the staging hook charges no region."""
    before = _class_state()
    with pytest.raises(ContractViolation):
        with max_transfers(0):
            stage(np.arange(2), CPU)
    with pytest.raises(ContractViolation):
        with no_host_sync():
            with no_host_sync():  # nested: the inner exit keeps the stubs
                assert torch.Tensor.__dict__.get("item") is not None
            torch.arange(3).tolist()
    assert _class_state() == before
    assert not getattr(contracts._TLS, "transfers", [])
    stage(np.arange(2), CPU)  # outside any region: charges nothing, raises nothing


def test_max_transfers_noop_when_disabled(contracts_off):
    with max_transfers(0):
        stage(np.arange(4), CPU)  # over budget, but enforcement is off


# -- max_retrace ----------------------------------------------------------


def test_max_retrace_trips_on_bucket_violating_recount(contracts_on):
    g, sb, wl = _graph()
    ex = Executor(sb, device="cpu")
    ex.count(wl)  # warm
    with max_retrace(0):
        ex.count(wl)  # the same stores: nothing bound, nothing built
    g2 = build_graph(rmat(128, 900, seed=4), n=128, reorder=False)
    with pytest.raises(ContractViolation, match="max_retrace"):
        with max_retrace(0):
            # A grown store: the stores re-adopt and the launcher rebinds.
            ex.adopt_stores(build_sbf(g2, 64))


def test_max_retrace_decorator_counts_compiles(contracts_on):
    g, sb, wl = _graph()
    ex = Executor(sb, device="cpu")

    @max_retrace(0)
    def warm_recount():
        return ex.count(wl)

    assert warm_recount() == triangles_intersection(g)

    @max_retrace(0)
    def cold_recount():
        return Executor(sb, device="cpu").count(wl)  # a pool miss: stores bound

    with pytest.raises(ContractViolation, match="max_retrace"):
        cold_recount()


def test_max_retrace_noop_when_disabled(contracts_off):
    _, sb, wl = _graph()
    with max_retrace(0):
        Executor(sb, device="cpu").count(wl)  # binds stores, but enforcement is off


# -- hot paths stay contract-clean ----------------------------------------


def test_executor_count_clean_under_contracts(contracts_on):
    edges = rmat(128, 400, seed=3)
    default_executor_pool().clear()  # a pool miss, then a hit
    for _ in range(2):
        res = tcim_count(edges, n=128, device="cpu")
        g = build_graph(edges, n=128, reorder=False)
        assert res.triangles == triangles_intersection(g)


def test_streaming_delta_clean_under_contracts(contracts_on):
    edges = rmat(64, 240, seed=5)
    state = StreamingTCState(edges[:180], n=64, device="cpu")
    for lo in (180, 195, 210, 225):
        tcim_count_delta(state, edges_added=edges[lo : lo + 15])
    g = build_graph(edges, n=64, reorder=False)
    assert state.triangles == triangles_intersection(g)


# -- per-thread scoping ---------------------------------------------------


def test_max_retrace_scoped_to_entering_thread(contracts_on):
    """Another thread's store bindings don't count against this thread's
    max_retrace window: the counter is kept per emitting thread."""
    g, sb, wl = _graph()
    ex = Executor(sb, device="cpu")
    ex.count(wl)  # warm
    errs = []
    total_before = contracts._EVENTS.total

    def other_thread():
        try:
            Executor(sb, device="cpu")  # binds stores, on this other thread
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    with max_retrace(0) as ct:
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
        saw_other = contracts._EVENTS.total - total_before
        assert ex.count(wl) == triangles_intersection(g)  # warm: zero events HERE
    assert not errs
    assert ct.compiles == 0  # the window ignored the other thread
    assert saw_other >= 1  # ...but the binding really happened
    # Control: the same binding on the entering thread still trips.
    with pytest.raises(ContractViolation, match="max_retrace"):
        with max_retrace(0):
            Executor(sb, device="cpu")


def test_max_retrace_isolates_interleaved_stream_warmup(contracts_on):
    """Two streams on two threads: stream B warming up (fresh executors,
    grown stores) must not trip steady stream A's internal max_retrace(0)
    guard (apply_batch arms it for known signatures)."""
    g_a = build_graph(rmat(300, 1800, seed=41), reorder=False)
    hold = g_a.edges[:64]
    state_a = StreamingTCState(g_a.edges[64:], n=g_a.n, device="cpu")
    # Warm-up cycle: the add/remove signatures become steady for A.
    for _ in range(2):
        state_a.apply_batch(added=hold)
        state_a.apply_batch(removed=hold)
    errs = []
    release = threading.Event()

    def warm_b():
        try:
            release.wait(30)
            g_b = build_graph(rmat(700, 5200, seed=42), reorder=False)
            sb = StreamingTCState(g_b.edges[: g_b.m // 2], n=g_b.n, device="cpu")
            sb.apply_batch(added=g_b.edges[g_b.m // 2 :])
        except Exception as e:
            errs.append(e)

    t = threading.Thread(target=warm_b)
    t.start()
    release.set()
    for _ in range(4):
        r1 = state_a.apply_batch(added=hold)
        r2 = state_a.apply_batch(removed=hold)
        assert not r1.grew and not r2.grew
    t.join(60)
    assert not t.is_alive()
    assert not errs, errs
    assert state_a.triangles == state_a.verify()


def test_no_host_sync_ignores_other_threads_readback(contracts_on):
    """While this thread's dispatch region is armed, another thread's
    readback at its own future close passes through: the stubs arm a
    thread-local flag, not a process-global veto."""
    got = []
    errs = []
    started, read = threading.Event(), threading.Event()

    def other_thread():
        try:
            started.wait(30)
            got.append(int(torch.arange(8).sum()))  # legal: no region HERE
            got.append(torch.arange(3).tolist())
        except Exception as e:
            errs.append(e)
        finally:
            read.set()

    t = threading.Thread(target=other_thread)
    t.start()
    with no_host_sync():
        started.set()
        assert read.wait(30)  # the other thread read back while this region was open
        with pytest.raises(ContractViolation, match="no_host_sync"):
            _sync_scalar()  # still trips on the entering thread
    t.join(30)
    assert not errs, errs
    assert got == [28, [0, 1, 2]]


# -- the wired sites --------------------------------------------------------


def _contracts_of(fn) -> list:
    """The contracts along a decorated function's ``__wrapped__`` chain."""
    out = []
    while fn is not None:
        if "__tcim_contract__" in getattr(fn, "__dict__", {}):
            out.append(type(fn.__dict__["__tcim_contract__"]).__name__)
        fn = getattr(fn, "__wrapped__", None)
    return sorted(set(out))


@pytest.mark.parametrize("site, want", [
    (build_mod.device_build_async, ["max_transfers", "no_host_sync"]),
    (build_mod.device_build_graph_async, ["max_transfers", "no_host_sync"]),
    (Executor.execute_indices_async, ["no_host_sync"]),
    (MultiGraphExecutor.count_fused_async, ["no_host_sync"]),
    (MultiGraphExecutor.count_fused_wave_async, ["no_host_sync"]),
    (ShardedColsExecutor.count_plan_async, ["no_host_sync"]),
])
def test_wired_sites_carry_their_contracts(site, want):
    assert _contracts_of(site) == want


def test_device_build_clean_under_its_budget(contracts_on):
    edges = rmat(128, 400, seed=3)
    with max_transfers(1) as ct:
        fut = device_build_async(edges, 128, device="cpu")
    assert ct.count == 1  # the padded edge list, nothing else
    db = fut.result()  # the sizing readback, outside the contract
    ex = Executor(db.sbf, device="cpu")
    g = build_graph(edges, n=128, reorder=True)
    assert ex.count(db.worklist) == triangles_intersection(g)
    res = tcim_count(edges, n=128, build="device", device="cpu")
    assert res.triangles == triangles_intersection(g)


def test_fused_count_and_cached_redispatch_clean(contracts_on):
    jobs, want = [], []
    for seed in (1, 2, 3):
        g, sb, wl = _graph(96, 300, seed)
        jobs.append((sb, wl))
        want.append(triangles_intersection(g))
    multi = MultiGraphExecutor(device="cpu")
    with max_transfers(8) as ct:
        fut = multi.count_fused_async(jobs)
    assert ct.count == 4  # both stacked stores and both index blocks
    assert fut.result() == tuple(want)
    with max_transfers(0) as ct:
        again = multi.count_fused_async(jobs)  # a cache hit: nothing staged
    assert ct.count == 0 and multi.hits == 1
    assert again.result() == tuple(want)
    futs = multi.count_fused_wave_async([jobs, jobs[:2]])
    assert [f.result() for f in futs] == [tuple(want), tuple(want[:2])]


@pytest.mark.parametrize("placement", ["sharded_cols", "sharded_2d", "replicated"])
def test_sharded_counts_clean_under_contracts(contracts_on, placement):
    g, sb, wl = _graph(200, 1500, 7)
    want = triangles_intersection(g)
    if placement == "replicated":
        mesh = make_mesh((4,), ("d",), devices=[CPU] * 4)
        assert distributed_tc_count_async(sb, wl, mesh, max_step_pairs=64).result() == want
        return
    if placement == "sharded_cols":
        ex = ShardedColsExecutor(sb, make_mesh((4,), ("d",), devices=[CPU] * 4), chunk_pairs=64)
        plan = ex._plan(wl)
    else:
        plan = plan_execution(sb, wl, DeviceTopology(num_devices=4), placement="sharded_2d",
                              grid=(2, 2), chunk_pairs=64)
        ex = Sharded2DExecutor(sb, make_mesh((2, 2), ("r", "c"), devices=[CPU] * 4), plan,
                               chunk_pairs=64)
    assert ex.count_plan_async(plan).result() == want
    with max_retrace(0):
        assert ex.count_plan_async(plan).result() == want  # warm: nothing bound


# -- planted violations on the wired paths ----------------------------------


def test_planted_extra_upload_in_device_build_trips(contracts_on, monkeypatch):
    orig = build_mod.device_orient

    def orient_and_upload_again(edges, n=None, *, reorder=True, device=None):
        stage(np.zeros(4, np.int32), device)  # one staging call too many
        return orig(edges, n, reorder=reorder, device=device)

    monkeypatch.setattr(build_mod, "device_orient", orient_and_upload_again)
    with pytest.raises(ContractViolation, match=r"max_transfers\(1\)"):
        device_build_async(rmat(128, 400, seed=3), 128, device="cpu")


_READBACKS = {
    "item": lambda t: t[0].item(),
    "tolist": lambda t: t.tolist(),
    "cpu": lambda t: t.cpu(),
    "numpy": lambda t: t.numpy(),
    "to_cpu": lambda t: t.to("cpu"),
    "int": lambda t: int(t[0]),
    "float": lambda t: float(t[0]),
    "bool": lambda t: bool(t[1]),
    "index": lambda t: range(t[1]),
    "np_asarray": lambda t: np.asarray(t),
    "cuda_synchronize": lambda t: torch.cuda.synchronize(),
}


@pytest.mark.parametrize("readback", sorted(_READBACKS))
def test_planted_readback_in_execute_indices_trips(contracts_on, monkeypatch, readback):
    _, sb, wl = _graph()
    ex = Executor(sb, device="cpu")
    orig = executor_mod.ops.popcount_and_gather_total

    def step_and_read(*args, out):
        out = orig(*args, out=out)
        _READBACKS[readback](out)  # a sync inside the dispatch
        return out

    monkeypatch.setattr(executor_mod.ops, "popcount_and_gather_total", step_and_read)
    with pytest.raises(ContractViolation, match="no_host_sync"):
        ex.execute_indices_async(wl.pair_row_pos, wl.pair_col_pos)
    if readback != "cuda_synchronize" or torch.cuda.is_available():
        monkeypatch.setenv("TCIM_CONTRACTS", "0")
        ex.count(wl)  # off: the same readback passes


def test_planted_adopt_on_steady_stream_signature_trips(contracts_on, monkeypatch):
    g = build_graph(rmat(300, 1800, seed=41), reorder=False)
    hold = g.edges[:64]
    state = StreamingTCState(g.edges[64:], n=g.n, device="cpu")
    for _ in range(2):  # the add/remove signatures become steady
        state.apply_batch(added=hold)
        state.apply_batch(removed=hold)
    ex = state.executor

    def edit_by_adopting(row_lanes, col_lanes):
        ex.adopt_stores(state._sbf)  # a forced re-adopt: the stores rebind

    monkeypatch.setattr(ex, "update_stores", edit_by_adopting)
    with pytest.raises(ContractViolation, match=r"max_retrace\(0\)"):
        state.apply_batch(added=hold)
