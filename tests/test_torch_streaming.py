"""Port vs reference: streaming incremental counts.

``repro_torch.core.streaming`` on the CPU (``device="cpu"``) must follow the
JAX package's ``repro.core.streaming`` batch for batch: the same seeded
add/remove batches go through both, and every running count and every
``DeltaResult`` field but the clock (``timings_s``) must be equal, and equal
to the exact oracle. ``update_sbf``'s arrays and lanes must be byte-equal,
``apply_store_lanes`` must edit equal stores equally, and the durability
hooks (snapshot, spill, compaction) must keep the count as the reference's
do. Counts are exact integers, so every comparison is equality.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (both packages in one process, JAX on the CPU)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jx_core  # noqa: E402
import repro.core.executor as jx_executor  # noqa: E402
from repro.configs.tcim_graphs import GRAPHS  # noqa: E402
from repro.data.graph_pipeline import load_graph  # noqa: E402
from repro.graphs import build_graph, rmat  # noqa: E402
from repro.graphs.exact import triangles_intersection  # noqa: E402

import repro_torch.core as pt_core  # noqa: E402
import repro_torch.core.executor as pt_executor  # noqa: E402
import repro_torch.core.streaming as pt_streaming  # noqa: E402
import repro_torch.core.tcim as pt_tcim  # noqa: E402
from repro_torch.core.sbf import sbf_from_arrays  # noqa: E402

SBF_FIELDS = ("row_ptr", "row_slice_idx", "row_slice_data",
              "col_ptr", "col_slice_idx", "col_slice_data")
LANE_FIELDS = ("pos", "word", "set_mask", "clear_mask")
# DeltaResult fields both packages must agree on (timings_s is a clock).
DELTA_FIELDS = tuple(f.name for f in dataclasses.fields(pt_core.DeltaResult)
                     if f.name != "timings_s")

# tests/test_streaming.py's sweep: each scaled fixture capped at 20,000 edges.
_SWEEP_M_CAP = 20000


def _sweep_cfg(name):
    cfg = GRAPHS[name]
    return cfg.scaled(min(0.02, _SWEEP_M_CAP / cfg.m))


def _oracle(edges, n):
    return triangles_intersection(build_graph(edges, n=n, reorder=False))


def _pair(edges, n, slice_bits=64, **pt_kwargs):
    """The same stream in both packages (the port on the CPU)."""
    jx = jx_core.StreamingTCState(edges, n=n, slice_bits=slice_bits)
    pt = pt_core.StreamingTCState(edges, n=n, slice_bits=slice_bits, device="cpu", **pt_kwargs)
    assert pt.triangles == jx.triangles
    return jx, pt


def _apply_both(jx, pt, **batch):
    """One batch through both; every DeltaResult field but the clock equal."""
    rj, rp = jx.apply_batch(**batch), pt.apply_batch(**batch)
    for f in DELTA_FIELDS:
        assert getattr(rp, f) == getattr(rj, f), (f, getattr(rp, f), getattr(rj, f))
    assert pt.triangles == jx.triangles == rp.triangles
    return rp


def _assert_sbf_equal(got, want):
    for f in SBF_FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("slice_bits", [32, 64, 128])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_streaming_matches_reference_and_oracle_after_every_batch(name, slice_bits):
    """tests/test_streaming.py's sweep side by side: every tcim_graphs config
    x slice width, random add/remove batches from ~85 % of the fixture's
    edges, both packages' DeltaResults equal and the count equal to an
    independent recount after EVERY batch; the host mirrors equal too."""
    cfg = _sweep_cfg(name)
    g, _, _ = load_graph(cfg, 64)
    rng = np.random.default_rng(cfg.seed + slice_bits)
    order = rng.permutation(g.m)
    cut = max(int(g.m * 0.85), 1)
    jx, pt = _pair(g.edges[order[:cut]], g.n, slice_bits)
    assert pt.triangles == _oracle(pt.current_edges(), g.n)
    absent = {tuple(e) for e in g.edges[order[cut:]].tolist()}
    for _ in range(3):
        cur = pt.current_edges()
        k_rm = min(max(len(cur) // 20, 1), len(cur))
        rm = cur[rng.permutation(len(cur))[:k_rm]]
        pool = np.array(sorted(absent), dtype=np.int64).reshape(-1, 2)
        k_ad = min(max(len(pool) // 2, 1), len(pool))
        ad = pool[rng.permutation(len(pool))[:k_ad]] if len(pool) else None
        _apply_both(jx, pt, added=ad, removed=rm)
        assert pt.triangles == _oracle(pt.current_edges(), g.n)
        absent.update(map(tuple, rm.tolist()))
        if ad is not None:
            absent.difference_update(map(tuple, ad.tolist()))
    _assert_sbf_equal(pt._sbf, jx._sbf)
    assert np.array_equal(pt.current_edges(), jx.current_edges())
    assert pt.verify() == jx.verify() == pt.triangles


def _grown_and_steady_batches(g, rng):
    """A growth batch (adds new records) and a steady one (removes only)."""
    present = {tuple(e) for e in g.edges.tolist()}
    absent = np.array([(u, v) for u in range(0, g.n, 3) for v in range(u + 1, g.n, 7)
                       if (u, v) not in present][:60], dtype=np.int64)
    rm = g.edges[rng.permutation(g.m)[:40]]
    return (absent, rm[:20]), (None, rm)


@pytest.mark.parametrize("slice_bits", [32, 64, 128])
@pytest.mark.parametrize("name", ["ego-facebook", "email-enron", "roadnet-pa"])
def test_update_sbf_arrays_and_lanes_byte_equal(name, slice_bits):
    """update_sbf on equal SBFs and equal batches: the post-update arrays,
    both sides' lanes and ``grew`` byte-equal to the reference's, for a
    growth batch and a steady one."""
    g, _, _ = load_graph(_sweep_cfg(name), 64)
    g = build_graph(g.edges, n=g.n, reorder=False)
    jsb = jx_core.build_sbf(g, slice_bits)
    psb = sbf_from_arrays(jsb)
    rng = np.random.default_rng(slice_bits)
    grew = []
    for added, removed in _grown_and_steady_batches(g, rng):
        added = None if added is None else np.sort(added, axis=1)
        removed = np.sort(removed, axis=1)
        ju = jx_core.update_sbf(jsb, added, removed)
        pu = pt_core.update_sbf(psb, added, removed)
        assert pu.grew == ju.grew
        grew.append(pu.grew)
        _assert_sbf_equal(pu.sbf, ju.sbf)
        for side in ("row_lanes", "col_lanes"):
            for f in LANE_FIELDS:
                a, b = getattr(getattr(pu, side), f), getattr(getattr(ju, side), f)
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (side, f)
        jsb, psb = ju.sbf, pu.sbf
    assert grew == [True, False]


@pytest.mark.parametrize("wps", [1, 2, 4])
def test_apply_store_lanes_matches_reference(wps):
    """apply_store_lanes on equal stores and lanes (bit 31 set and cleared
    included): the port's in-place edit equals the reference's scatter, and
    no lanes (None or empty) leave the store as it was."""
    rng = np.random.default_rng(wps)
    rows = 64
    words = rng.integers(0, 2**32, size=(rows, wps), dtype=np.uint64).astype(np.uint32)
    lanes_n = 50
    cells = rng.choice(rows * wps, size=lanes_n, replace=False)
    set_mask = rng.integers(0, 2**32, size=lanes_n, dtype=np.uint64).astype(np.uint32)
    set_mask[:5] |= np.uint32(1 << 31)
    clear_mask = rng.integers(0, 2**32, size=lanes_n, dtype=np.uint64).astype(np.uint32)
    clear_mask &= ~set_mask
    clear_mask[5:10] = np.uint32(1 << 31)
    set_mask[5:10] &= ~np.uint32(1 << 31)
    kw = dict(pos=(cells // wps).astype(np.int32), word=(cells % wps).astype(np.int32),
              set_mask=set_mask, clear_mask=clear_mask)
    want = np.asarray(jx_executor.apply_store_lanes(jnp.asarray(words), jx_core.UpdateLanes(**kw)))
    store = torch.from_numpy(words.copy().view(np.int32))
    got = pt_executor.apply_store_lanes(store, pt_core.UpdateLanes(**kw))
    assert got is store  # in place
    assert np.array_equal(store.numpy().view(np.uint32), want)
    empty = pt_core.UpdateLanes(**{k: v[:0] for k, v in kw.items()})
    before = store.clone()
    for lanes in (None, empty):
        assert pt_executor.apply_store_lanes(store, lanes) is store
    assert torch.equal(store, before)


def test_tcim_count_delta_wrapper_and_reexports():
    g = build_graph(rmat(400, 2400, seed=3), reorder=False)
    jx, pt = _pair(g.edges[: g.m // 2], g.n)
    seed_count = pt.triangles
    rj = jx_core.tcim_count_delta(jx, edges_added=g.edges[g.m // 2:])
    rp = pt_core.tcim_count_delta(pt, edges_added=g.edges[g.m // 2:])
    assert rp.triangles == rj.triangles == _oracle(g.edges, g.n)
    assert seed_count + rp.delta == rp.triangles
    back = pt_core.tcim_count_delta(pt, edges_removed=g.edges[g.m // 2:])
    assert back.delta == -rp.delta and back.triangles == seed_count
    assert pt_tcim.tcim_count_delta is pt_core.tcim_count_delta
    assert pt_tcim.StreamingTCState is pt_core.StreamingTCState
    assert pt_tcim.DeltaResult is pt_core.DeltaResult
    assert pt_core.STREAM_BACKENDS == jx_core.STREAM_BACKENDS
    assert DELTA_FIELDS == tuple(f.name for f in dataclasses.fields(jx_core.DeltaResult)
                                 if f.name != "timings_s")


def test_empty_delta_is_noop():
    g = build_graph(rmat(300, 1800, seed=4), reorder=False)
    jx, pt = _pair(g.edges, g.n)
    before = pt.triangles
    res = _apply_both(jx, pt)
    assert res.delta == 0 and res.touched_edges == 0 and pt.triangles == before
    res = _apply_both(jx, pt, added=np.zeros((0, 2), np.int64), removed=[])
    assert res.delta == 0 and pt.triangles == before
    assert pt.batches == jx.batches == 2


def test_remove_only_batches_and_readd():
    g = build_graph(rmat(300, 1800, seed=5), reorder=False)
    jx, pt = _pair(g.edges, g.n)
    seed_count = pt.triangles
    rm = g.edges[np.random.default_rng(0).permutation(g.m)[: g.m // 3]]
    res = _apply_both(jx, pt, removed=rm)
    assert res.delta <= 0 and pt.triangles == _oracle(pt.current_edges(), g.n)
    # Removal keeps records as zero rows: re-adding is a pure edit.
    res2 = _apply_both(jx, pt, added=rm)
    assert not res2.grew and pt.triangles == seed_count


def test_remove_all_then_rebuild():
    g = build_graph(rmat(120, 600, seed=6), reorder=False)
    jx, pt = _pair(g.edges, g.n)
    _apply_both(jx, pt, removed=g.edges)
    assert pt.triangles == 0 and pt.num_edges == 0
    _apply_both(jx, pt, added=g.edges)
    assert pt.triangles == _oracle(g.edges, g.n) and pt.verify() == pt.triangles


def test_steady_batch_uploads_no_store_and_adopts_nothing():
    """The counterpart of the reference's zero-retrace test: after a warm
    add/remove cycle, same-bucket batches edit the stores in place — the
    executor object stays, no store byte is uploaded, adopt_stores is not
    called, and only the lanes travel."""
    g = build_graph(rmat(500, 3000, seed=7), reorder=False)
    rng = np.random.default_rng(1)
    pick = rng.permutation(g.m)[:200]
    hold = g.edges[pick]
    base = np.delete(g.edges, pick, axis=0)
    jx, pt = _pair(base, g.n)
    assert _apply_both(jx, pt, added=hold).grew  # growth: records merge-inserted
    assert pt.executor.adopts == 1
    _apply_both(jx, pt, removed=hold)  # steady: records persist as zeros
    ex = pt.executor
    stores = (ex.row_data.data_ptr(), ex.col_data.data_ptr())
    uploaded, lanes_before = ex.store_upload_bytes, ex.lane_upload_bytes
    for _ in range(3):
        r1 = _apply_both(jx, pt, added=hold)
        r2 = _apply_both(jx, pt, removed=hold)
        assert not r1.grew and not r2.grew
    assert pt.executor is ex and ex.adopts == 1
    assert ex.store_upload_bytes == uploaded
    assert (ex.row_data.data_ptr(), ex.col_data.data_ptr()) == stores
    assert ex.lane_upload_bytes > lanes_before
    assert pt.verify() == pt.triangles


def test_update_stores_refuses_growth_positions():
    g = build_graph(rmat(200, 1200, seed=15), reorder=False)
    sb = pt_core.build_sbf(g, 64)
    ex = pt_core.Executor(sb, device="cpu")
    lanes = pt_core.UpdateLanes(pos=np.array([ex.row_data.shape[0]], np.int32),
                                word=np.zeros(1, np.int32), set_mask=np.ones(1, np.uint32),
                                clear_mask=np.zeros(1, np.uint32))
    with pytest.raises(ValueError, match="grew"):
        ex.update_stores(lanes, None)
    with pytest.raises(ValueError, match="words_per_slice"):
        ex.adopt_stores(pt_core.build_sbf(g, 128))


def test_batch_validation_rejects_before_mutating():
    g = build_graph(rmat(200, 1000, seed=8), reorder=False)
    jx, pt = _pair(g.edges, g.n)
    before = (pt.triangles, pt.num_edges, pt.batches)
    present = {tuple(e) for e in g.edges.tolist()}
    miss = next([0, v] for v in range(g.n - 1, 0, -1) if (0, v) not in present)
    cases = [
        dict(added=np.array([[5, 5]])),                      # self-loop
        dict(added=np.array([[1, 2], [2, 1]])),              # dup in batch
        dict(added=g.edges[:1]),                             # already present
        dict(removed=np.array([miss])),                      # absent
        dict(added=np.array([[0, g.n + 7]])),                # out of range
        dict(added=np.array([[3, 4]]), removed=np.array([[3, 4]])),  # add ∩ remove
    ]
    for kw in cases:
        msgs = []
        for state in (jx, pt):
            with pytest.raises(ValueError) as err:
                state.apply_batch(**kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
        assert (pt.triangles, pt.num_edges, pt.batches) == before
    assert pt.executor.lane_upload_bytes == 0 and pt.executor.adopts == 0
    assert pt.verify() == pt.triangles


@pytest.mark.parametrize("name", ["ego-facebook", "email-enron", "roadnet-pa"])
def test_device_build_path_is_bit_identical_to_host(name):
    """build='device' on the CPU (the device build's torch ops) gives the
    DeltaResults of the host path and of the reference, batch by batch, and
    the torch work lists the host's pairs."""
    g, _, _ = load_graph(_sweep_cfg(name), 64)
    rng = np.random.default_rng(3)
    order = rng.permutation(g.m)
    half = g.m // 2
    jx, pt = _pair(g.edges[order[:half]], g.n)
    dev = pt_core.StreamingTCState(g.edges[order[:half]], n=g.n, build="device", device="cpu")
    assert dev._use_device_build and not pt._use_device_build
    batches = [dict(added=g.edges[order[half:]]), dict(removed=g.edges[order[:100]]),
               dict(added=g.edges[order[:50]], removed=g.edges[order[half: half + 50]])]
    for batch in batches:
        rp = _apply_both(jx, pt, **batch)
        rd = dev.apply_batch(**batch)
        assert all(getattr(rd, f) == getattr(rp, f) for f in DELTA_FIELDS)
        assert rd.triangles == _oracle(dev.current_edges(), g.n)
    assert dev.index_upload_bytes > 0 and dev.fallbacks == 0
    _assert_sbf_equal(dev._sbf, pt._sbf)


def test_auto_fallback_counts_and_device_raises(monkeypatch):
    """Under build='auto' (here forced onto the device path) the delta
    build's ValueError falls back to the host work list and is counted;
    build='device' raises it."""
    g = build_graph(rmat(300, 1800, seed=9), reorder=False)
    rm = g.edges[:30]

    def refuse(*args, **kwargs):
        raise ValueError("candidate total past int32")

    monkeypatch.setattr(pt_streaming.build_mod, "device_delta_worklist", refuse)
    auto = pt_core.StreamingTCState(g.edges, n=g.n, device="cpu")
    auto._use_device_build = True
    res = auto.apply_batch(removed=rm)
    assert auto.fallbacks == 2 and res.triangles == _oracle(auto.current_edges(), g.n)
    dev = pt_core.StreamingTCState(g.edges, n=g.n, build="device", device="cpu")
    with pytest.raises(ValueError, match="int32"):
        dev.apply_batch(removed=rm)


def test_options_validated_and_mesh_not_ported(monkeypatch):
    """Option checks; a mesh stream needs the host build and a 2-axis mesh
    (its counts are held to recounts in tests/test_torch_distributed.py)."""
    from repro_torch.distributed import make_mesh

    edges = rmat(64, 200, seed=1)
    mesh = make_mesh((2, 2), ("r", "c"), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="single-device"):
        pt_core.StreamingTCState(edges, mesh=mesh, build="device")
    with pytest.raises(ValueError, match="2-axis"):
        pt_core.StreamingTCState(edges, mesh=make_mesh((4,), ("d",), devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="kind"):
        pt_core.StreamingTCState(edges, mesh=mesh, device="cuda")
    with pytest.raises(ValueError, match="backend"):
        pt_core.StreamingTCState(edges, backend="bitgemm", device="cpu")
    with pytest.raises(ValueError, match="build"):
        pt_core.StreamingTCState(edges, build="gpu", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pt_core.StreamingTCState(edges)  # the card by default; no CPU fallback


@pytest.mark.parametrize("backend", ["pallas_unfused", "pallas_items", "jnp"])
def test_streaming_backends_match_reference(backend):
    g = build_graph(rmat(300, 1800, seed=10), reorder=False)
    rng = np.random.default_rng(4)
    order = rng.permutation(g.m)
    jx = jx_core.StreamingTCState(g.edges[order[:-200]], n=g.n, backend=backend)
    pt = pt_core.StreamingTCState(g.edges[order[:-200]], n=g.n, backend=backend, device="cpu")
    assert pt.executor.mode == jx.executor.mode
    _apply_both(jx, pt, added=g.edges[order[-200:]])
    _apply_both(jx, pt, removed=g.edges[order[:150]])
    assert pt.triangles == _oracle(pt.current_edges(), g.n)


# ---------------------------------------------------------------------------
# Durability primitives: snapshot/restore, spill/readmit, compaction
# ---------------------------------------------------------------------------


def test_stream_snapshot_roundtrip_matches_reference():
    """snapshot_tree equals the reference's leaf for leaf; from_snapshot
    round-trips a stream exactly (in the port, and across packages: each
    package rebuilds the other's snapshot), and the clones track the
    original batch for batch."""
    g = build_graph(rmat(300, 1800, seed=31), reorder=False)
    order = np.random.default_rng(2).permutation(g.m)
    jx, pt = _pair(g.edges[order[: g.m // 2]], g.n)
    _apply_both(jx, pt, added=g.edges[order[g.m // 2: 3 * g.m // 4]])
    (jt, je), (ptree, pe) = jx.snapshot_tree(), pt.snapshot_tree()
    assert pe == je and sorted(ptree) == sorted(jt) == sorted(pt_core.StreamingTCState._SNAP_LEAVES)
    for k in ptree:
        a, b = np.asarray(ptree[k]), np.asarray(jt[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    clone = pt_core.StreamingTCState.from_snapshot(ptree, pe, device="cpu")
    cross = pt_core.StreamingTCState.from_snapshot(
        {k: np.asarray(v) for k, v in jt.items()}, je, device="cpu")
    back = jx_core.StreamingTCState.from_snapshot(ptree, pe)
    for state in (clone, cross, back):
        assert state.triangles == pt.triangles and state.num_edges == pt.num_edges
    tail = g.edges[order[3 * g.m // 4:]]
    want = _apply_both(jx, pt, added=tail)
    for state in (clone, cross, back):
        got = state.apply_batch(added=tail)
        assert all(getattr(got, f) == getattr(want, f) for f in DELTA_FIELDS)
    rm = g.edges[order[:100]]
    want = _apply_both(jx, pt, removed=rm)
    assert all(s.apply_batch(removed=rm).triangles == want.triangles for s in (clone, cross, back))
    assert clone.verify() == cross.verify() == clone.triangles


def test_stream_spill_and_readmit_preserve_count_and_results():
    g = build_graph(rmat(200, 1200, seed=32), reorder=False)
    jx, pt = _pair(g.edges[: g.m // 2], g.n)
    before = pt.triangles
    assert pt.resident
    pt.spill()
    assert not pt.resident and pt.triangles == before
    assert pt.ensure_resident() and pt.resident
    assert not pt.ensure_resident()  # idempotent, reports no rebuild
    _apply_both(jx, pt, added=g.edges[g.m // 2:])
    assert pt.triangles == _oracle(pt.current_edges(), g.n)
    # Auto-readmit: apply_batch on a spilled stream rebuilds transparently.
    pt.spill()
    _apply_both(jx, pt, removed=g.edges[: g.m // 4])
    assert pt.resident and pt.triangles == _oracle(pt.current_edges(), g.n)


def test_stream_compaction_reclaims_records_and_preserves_count():
    """Heavy removal crosses the zero-record ratio; compact() rebuilds
    smaller stores (re-adopted, launcher rebuilt) with the same count and
    the same records as the reference's compaction."""
    g = build_graph(rmat(200, 1400, seed=33), reorder=False)
    jx, pt = _pair(g.edges, g.n)
    rm = g.edges[np.random.default_rng(3).permutation(g.m)[: (3 * g.m) // 4]]
    _apply_both(jx, pt, removed=rm)
    count = pt.triangles
    assert pt.zero_record_ratio() == jx.zero_record_ratio() > 0.3
    adopts = pt.executor.adopts
    stats = pt.compact()
    assert stats == jx.compact()
    assert stats["records_after"] < stats["records_before"]
    assert pt.executor.adopts == adopts + 1
    assert pt.triangles == count and pt.zero_record_ratio() == 0.0
    _assert_sbf_equal(pt._sbf, jx._sbf)
    _apply_both(jx, pt, added=rm[:50])
    assert pt.triangles == _oracle(pt.current_edges(), g.n)
    assert pt.verify() == pt.triangles


@pytest.mark.parametrize("name", ["ego-facebook", "email-enron"])
def test_spill_snapshot_compact_invariants_on_bench_configs(name):
    """At every step of a remove-heavy schedule, spill/readmit,
    snapshot/restore and compaction all keep the exact running count, in
    step with the reference."""
    cfg = _sweep_cfg(name)
    g, _, _ = load_graph(cfg, 64)
    rng = np.random.default_rng(cfg.seed)
    jx, pt = _pair(g.edges, g.n)
    for _ in range(3):
        cur = pt.current_edges()
        rm = cur[rng.permutation(len(cur))[: max(len(cur) // 3, 1)]]
        _apply_both(jx, pt, removed=rm)
        want = _oracle(pt.current_edges(), g.n)
        assert pt.triangles == want
        pt.spill()
        pt.ensure_resident()
        assert pt.triangles == want
        clone = pt_core.StreamingTCState.from_snapshot(*pt.snapshot_tree(), device="cpu")
        assert clone.triangles == want
        assert pt.zero_record_ratio() == jx.zero_record_ratio()
        if pt.zero_record_ratio() >= 0.5:
            assert pt.compact() == jx.compact()
            assert pt.triangles == want


def test_update_stores_never_edits_the_callers_host_arrays():
    """The executor's stores are its own copies, on the CPU too (an SBF
    whose record count is a power of two needs no padding, so a zero-copy
    upload would alias it): an in-place edit leaves the host SBF alone."""
    edges = np.array([[0, 1], [0, 2], [1, 2], [2, 3], [3, 4]], np.int64)
    sb = pt_core.build_sbf(build_graph(edges, reorder=False), 32)
    assert len(sb.row_slice_data) & (len(sb.row_slice_data) - 1) == 0
    before = sb.row_slice_data.copy()
    ex = pt_core.Executor(sb, device="cpu")
    upd = pt_core.update_sbf(sb, None, edges[:1])
    assert not upd.grew
    ex.update_stores(upd.row_lanes, upd.col_lanes)
    assert np.array_equal(sb.row_slice_data, before)
    assert not np.array_equal(ex.row_data[: len(before)].numpy().view(np.uint32), before)
