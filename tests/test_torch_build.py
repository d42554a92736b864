"""Port vs reference: the device build front end (orient -> SBF -> work list).

``repro_torch.core.build`` on the CPU (``device="cpu"``) must reproduce the
JAX package's ``repro.core.build`` (jit on the CPU) array for array —
pointers, slice indices, uint32 words, the pow2-padded stores and the
``-1``-padded pair arrays — and both packages' host builds, on every
``GRAPHS`` config x slice_bits {32, 64, 128}. The same edges, made from
numpy seeds, go through both. Counts and indices are exact integers, so
every comparison is equality.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (both packages in one process, JAX on the CPU)
import numpy as np  # noqa: E402

import repro.core as jx_core  # noqa: E402
from repro.configs.tcim_graphs import GRAPHS  # noqa: E402
from repro.graphs import GRAPH_GENERATORS, rmat  # noqa: E402
from repro.graphs import build_graph as jx_build_graph  # noqa: E402
from repro.graphs import device_orient as jx_device_orient  # noqa: E402
from repro.graphs.exact import triangles_intersection  # noqa: E402

import repro_torch.core as pt_core  # noqa: E402
import repro_torch.core.build as pt_build  # noqa: E402
import repro_torch.core.executor as pt_executor  # noqa: E402
import repro_torch.core.tcim as pt_tcim  # noqa: E402
from repro_torch.core import sbf as pt_sbf  # noqa: E402
from repro_torch.graphs import build_graph as pt_build_graph  # noqa: E402
from repro_torch.graphs import device_orient as pt_device_orient  # noqa: E402

SBF_FIELDS = ("row_ptr", "row_slice_idx", "row_slice_data",
              "col_ptr", "col_slice_idx", "col_slice_data")
PAIR_FIELDS = ("pair_edge", "pair_row_pos", "pair_col_pos")
BACKENDS = ("pallas_total", "pallas_unfused", "pallas_items", "jnp")


def _scaled(name: str):
    # As tests/test_torch_tcim.py scales them.
    return GRAPHS[name].scaled(0.005 if name == "com-livejournal" else 0.02)


@functools.lru_cache(maxsize=None)
def _edges(name: str) -> np.ndarray:
    cfg = _scaled(name)
    gen = GRAPH_GENERATORS[cfg.generator]
    if cfg.generator == "grid_road":
        return gen(cfg.n, seed=cfg.seed)
    return gen(cfg.n, cfg.m, seed=cfg.seed)


def _assert_arrays_equal(got, want, fields):
    for f in fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        assert np.array_equal(a, b), f


def _words(store) -> np.ndarray:
    """A store's words as uint32, whichever package built it."""
    if isinstance(store, torch.Tensor):
        return store.numpy().view(np.uint32)
    return np.asarray(store)


def _assert_device_builds_equal(pt_db, jx_db):
    """The two packages' device builds, padding included."""
    assert pt_db.sbf.is_device and jx_db.sbf.is_device
    assert (pt_db.sbf.row_valid, pt_db.sbf.col_valid) == (jx_db.sbf.row_valid, jx_db.sbf.col_valid)
    for side in ("row", "col"):
        assert np.array_equal(_words(getattr(pt_db.sbf, f"{side}_slice_data")),
                              _words(getattr(jx_db.sbf, f"{side}_slice_data"))), side
        assert np.array_equal(getattr(pt_db.sbf, f"{side}_slice_idx").numpy(),
                              np.asarray(getattr(jx_db.sbf, f"{side}_slice_idx"))), side
    for f in PAIR_FIELDS:
        got, want = getattr(pt_db.worklist, f), np.asarray(getattr(jx_db.worklist, f))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), f
    assert pt_db.worklist.num_pairs == jx_db.worklist.num_pairs
    assert pt_db.worklist.num_candidates == jx_db.worklist.num_candidates
    assert pt_db.sbf.nvs == jx_db.sbf.nvs
    sb, wl = pt_db.to_host()
    jsb, jwl = jx_db.to_host()
    _assert_arrays_equal(sb, jsb, SBF_FIELDS)
    _assert_arrays_equal(wl, jwl, PAIR_FIELDS)


@pytest.mark.parametrize("slice_bits", [32, 64, 128])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_device_build_matches_reference_and_host_builds(name, slice_bits):
    """(a) Port device build == the JAX package's device build == both host
    builds, on every config x slice_bits."""
    edges = _edges(name)
    pt_db = pt_core.device_build(edges, slice_bits=slice_bits, device="cpu")
    _assert_device_builds_equal(pt_db, jx_core.device_build(edges, slice_bits=slice_bits))
    sb, wl = pt_db.to_host()
    g = pt_build_graph(edges, reorder=True)
    host_sb = pt_core.build_sbf(g, slice_bits)
    _assert_arrays_equal(sb, host_sb, SBF_FIELDS)
    _assert_arrays_equal(wl, pt_core.build_worklist(g, host_sb), PAIR_FIELDS)
    jg = jx_build_graph(edges, reorder=True)
    jx_sb = jx_core.build_sbf(jg, slice_bits)
    _assert_arrays_equal(sb, jx_sb, SBF_FIELDS)
    _assert_arrays_equal(wl, jx_core.build_worklist(jg, jx_sb), PAIR_FIELDS)
    stats = pt_sbf.sbf_stats(pt_db.graph, pt_db.sbf, pt_db.worklist)
    assert stats == pt_sbf.sbf_stats(g, host_sb, wl)


@pytest.mark.parametrize("reorder", [False, True])
def test_device_orient_matches_both_host_orients(reorder):
    """(b) device_orient == both packages' build_graph and the JAX package's
    device_orient; a prebuilt graph's device build is its host build."""
    edges = rmat(350, 2200, seed=11)
    dg = pt_device_orient(edges, reorder=reorder, device="cpu")
    assert dg.bucket == pt_core.pow2_ceil(len(edges)) and dg.m == int(dg.m_dev) == len(edges)
    gh = dg.to_host()
    for want in (pt_build_graph(edges, reorder=reorder), jx_build_graph(edges, reorder=reorder),
                 jx_device_orient(edges, reorder=reorder).to_host()):
        assert (gh.n, gh.m) == (want.n, want.m)
        for f in ("edges", "indptr", "indices"):
            a, b = getattr(gh, f), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    # Sentinel lanes hold vertex id n and sort last.
    assert bool((dg.src[dg.m:] == dg.n).all()) and bool((dg.dst[dg.m:] == dg.n).all())
    g = pt_build_graph(edges, reorder=reorder)
    db = pt_core.device_build_graph(g, 64, device="cpu")
    sb = pt_core.build_sbf(g, 64)
    _assert_arrays_equal(db.sbf.to_host(), sb, SBF_FIELDS)
    _assert_arrays_equal(db.worklist.to_host(), pt_core.build_worklist(g, sb), PAIR_FIELDS)


def test_device_orient_refuses_what_it_cannot_index():
    with pytest.raises(ValueError, match="non-empty"):
        pt_device_orient(np.zeros((0, 2), np.int64), device="cpu")
    with pytest.raises(ValueError, match="int32"):
        pt_device_orient(np.array([[0, 1]]), n=2**31, device="cpu")
    with pytest.raises(ValueError, match="multiple of 32"):
        pt_core.device_build(np.array([[0, 1]]), slice_bits=48, device="cpu")


@pytest.mark.parametrize("slice_bits", [32, 64, 128])
def test_granular_stages_match(slice_bits):
    """(c) device_build_sbf + device_build_worklist == the JAX package's
    granular stages == the host build."""
    edges = rmat(300, 1500, seed=5)
    g = pt_build_graph(edges, reorder=True)
    dg = pt_device_orient(g.edges, n=g.n, reorder=False, device="cpu")
    dsb = pt_core.device_build_sbf(dg, slice_bits)
    dwl = pt_core.device_build_worklist(dg, dsb)
    jdg = jx_device_orient(g.edges, n=g.n, reorder=False)
    jsb = jx_core.device_build_sbf(jdg, slice_bits)
    jwl = jx_core.device_build_worklist(jdg, jsb)
    assert dsb.nvs == jsb.nvs == pt_core.build_sbf(g, slice_bits).nvs
    _assert_arrays_equal(dsb.to_host(), jsb.to_host(), SBF_FIELDS)
    _assert_arrays_equal(dwl.to_host(), jwl.to_host(), PAIR_FIELDS)
    for f in PAIR_FIELDS:
        assert np.array_equal(getattr(dwl, f).numpy(), np.asarray(getattr(jwl, f))), f
    sb = pt_core.build_sbf(g, slice_bits)
    _assert_arrays_equal(dwl.to_host(), pt_core.build_worklist(g, sb), PAIR_FIELDS)


@pytest.mark.parametrize("slice_bits", [32, 64, 128])
def test_delta_worklist_matches_reference_and_host(slice_bits):
    """(d) device_delta_worklist on a random edge subset == the JAX
    package's and both host build_worklist_pairs, over a host SBF and (the
    port's) over a device SBF."""
    edges = _edges("email-enron")
    g = pt_build_graph(edges, reorder=True)
    sb = pt_core.build_sbf(g, slice_bits)
    rng = np.random.default_rng(slice_bits)
    pick = np.sort(rng.choice(g.m, size=g.m // 5, replace=False))
    src, dst = g.edges[pick, 0], g.edges[pick, 1]
    want = pt_core.build_worklist_pairs(src, dst, sb)
    jg = jx_build_graph(edges, reorder=True)
    jsb = jx_core.build_sbf(jg, slice_bits)
    jwant = jx_core.build_worklist_pairs(src, dst, jsb)
    jdw = jx_core.device_delta_worklist(src, dst, jsb)
    db = pt_core.device_build(edges, slice_bits=slice_bits, device="cpu")
    for over in (sb, db.sbf):
        dw = pt_core.device_delta_worklist(src, dst, over, device="cpu")
        assert (dw.num_pairs, dw.num_candidates) == (jdw.num_pairs, jdw.num_candidates)
        host = dw.to_host()
        for f, a, b in zip(PAIR_FIELDS, want, jwant):
            assert np.array_equal(getattr(host, f), a) and np.array_equal(a, b), f
            assert np.array_equal(getattr(dw, f).numpy(), np.asarray(getattr(jdw, f))), f
    empty = pt_core.device_delta_worklist(src[:0], dst[:0], sb, device="cpu")
    assert empty.num_pairs == 0 and empty.pair_row_pos.tolist() == [-1]


@pytest.mark.parametrize("backend", BACKENDS)
def test_device_count_matches_oracle_and_reference(backend):
    """(e) tcim_count(build='device') == the exact oracle == the JAX
    package's device-built count, in every work-list backend."""
    edges = rmat(400, 2500, seed=1)
    want = triangles_intersection(jx_build_graph(edges, reorder=True))
    res = pt_core.tcim_count(edges, build="device", backend=backend, device="cpu")
    ref = jx_core.tcim_count(edges, build="device", backend=backend)
    assert res.triangles == ref.triangles == want
    assert res.stats["build"] == ref.stats["build"] == "device"
    assert res.stats["placement"] == "replicated"
    assert res.stats["num_pairs"] == ref.stats["num_pairs"]
    assert res.stats["nvs"] == ref.stats["nvs"]
    assert set(res.timings_s) == {"orient", "compress", "schedule", "plan", "execute"}
    assert res.timings_s["plan"] == 0.0
    g = pt_build_graph(edges, reorder=True)
    got = pt_core.tcim_count_graph(g, build="device", backend=backend, device="cpu")
    assert got.triangles == want and got.stats["build"] == "device"


@pytest.mark.parametrize(
    "edges,n,want",
    [
        (np.zeros((0, 2), dtype=np.int64), 4, 0),
        (np.array([[0, 1]], dtype=np.int64), None, 0),
        (np.array([[0, 1], [0, 2], [1, 2]], dtype=np.int64), None, 1),
    ],
    ids=["empty", "single_edge", "triangle"],
)
def test_device_build_tiny_graphs(edges, n, want):
    res = pt_core.tcim_count(edges, n=n, build="device", device="cpu")
    assert res.triangles == want == jx_core.tcim_count(edges, n=n, build="device").triangles
    # The empty graph has nothing to build on the device.
    assert res.stats["build"] == ("host" if len(edges) == 0 else "device")


def test_async_matches_sync():
    """(e) The async device build and count == the blocking ones."""
    edges = rmat(350, 2000, seed=21)
    want = triangles_intersection(jx_build_graph(edges, reorder=True))
    fut = pt_core.device_build_async(edges, device="cpu")
    assert "compress" in fut.timings_s and "schedule" not in fut.timings_s
    db = fut.result()
    assert fut.result() is db and "schedule" in db.timings_s
    _assert_device_builds_equal(db, jx_core.device_build(edges))
    assert pt_core.Executor(db.sbf, device="cpu").count(db.worklist) == want
    tf = pt_core.tcim_count(edges, build="device", async_=True, device="cpu")
    res = tf.result()
    assert res.triangles == want and "close" in res.timings_s and tf.result() is res
    futs = [pt_core.tcim_count(rmat(200, 900, seed=s), build="device", async_=True, device="cpu")
            for s in (1, 2, 3)]
    wants = [triangles_intersection(jx_build_graph(rmat(200, 900, seed=s), reorder=True))
             for s in (1, 2, 3)]
    assert [f.result().triangles for f in futs] == wants


@pytest.mark.parametrize("mode", pt_executor.EXECUTOR_MODES)
def test_executor_adopts_device_stores_and_windows(mode, monkeypatch):
    """The executor adopts pre-bucketed device stores with no copy, runs the
    resident index arrays in ceil(PB / chunk) windows with nothing staged,
    and pads a straggler store to its pow2 rows."""
    edges = rmat(800, 6000, seed=3)
    want = triangles_intersection(jx_build_graph(edges, reorder=True))
    db = pt_core.device_build(edges, device="cpu")
    monkeypatch.setattr(pt_executor.Executor, "_put", lambda self, chunk: 1 / 0)
    chunk = 1 << 10
    ex = pt_core.Executor(db.sbf, mode=mode, chunk_pairs=chunk, device="cpu")
    assert ex.row_data.data_ptr() == db.sbf.row_slice_data.data_ptr()
    assert ex.col_data.data_ptr() == db.sbf.col_slice_data.data_ptr()
    steps = []
    step = pt_executor.Executor._step
    monkeypatch.setattr(pt_executor.Executor, "_step",
                        lambda self, r, c, acc: steps.append(len(r)) or step(self, r, c, acc))
    assert ex.count(db.worklist) == want
    pb = len(db.worklist.pair_row_pos)
    assert steps == [chunk] * -(-pb // chunk)
    # A ragged resident tail pads to its pow2 bucket with -1.
    steps.clear()
    p = db.worklist.num_pairs
    assert ex.execute_indices(db.worklist.pair_row_pos[:p], db.worklist.pair_col_pos[:p]) == want
    assert all(s == pt_core.pow2_ceil(s) for s in steps) and len(steps) == -(-p // chunk)
    straggler = dataclasses.replace(db.sbf, row_slice_data=db.sbf.row_slice_data[:-1],
                                    content_key=None)
    assert pt_core.Executor(straggler, device="cpu").row_data.shape == db.sbf.row_slice_data.shape
    with pytest.raises(ValueError, match="int32"):
        pt_core.Executor(dataclasses.replace(
            db.sbf, row_slice_data=db.sbf.row_slice_data.long()), device="cpu")


def test_pool_keys_device_builds_by_content_without_readback(monkeypatch):
    """(f) Two device builds of the same edges hit one pooled executor; the
    key is the build's content_key, so no store is hashed or read back."""
    edges = rmat(250, 1200, seed=17)
    db1 = pt_core.device_build(edges, device="cpu")
    db2 = pt_core.device_build(edges, device="cpu")
    assert db1.sbf.content_key == db2.sbf.content_key
    assert db1.sbf.content_key.startswith("device:")
    db3 = pt_core.device_build(rmat(250, 1200, seed=19), device="cpu")

    def no_hash(*args, **kwargs):
        raise AssertionError("a device build's stores were hashed")

    monkeypatch.setattr(pt_executor.hashlib, "blake2b", no_hash)
    pool = pt_core.ExecutorPool()
    assert pool.get(db1.sbf, device="cpu") is pool.get(db2.sbf, device="cpu")
    assert (pool.hits, pool.misses) == (1, 1)
    assert pt_core.sbf_content_key(db1.sbf) == db1.sbf.content_key
    pool.get(db3.sbf, device="cpu")
    assert pool.misses == 2


def test_candidate_guard_and_auto_fallback(monkeypatch):
    """(g) The guard raises ValueError naming the host; build='device'
    raises it; 'auto' resolved to the device falls back to the host build."""
    edges = rmat(300, 1500, seed=29)
    want = triangles_intersection(jx_build_graph(edges, reorder=True))
    assert pt_tcim._resolve_build("auto", "pallas_total", 10, torch.device("cuda")) == "device"
    assert pt_tcim._resolve_build("auto", "pallas_total", 10, torch.device("cpu")) == "host"
    assert pt_tcim._resolve_build("device", "pallas_total", 0, torch.device("cuda")) == "host"
    assert pt_tcim._resolve_build("device", "mxu", 10, torch.device("cuda")) == "host"
    assert pt_core.tcim_count(edges, device="cpu").stats["build"] == "host"
    resolve = pt_tcim._resolve_build
    monkeypatch.setattr(pt_tcim, "_resolve_build",
                        lambda build, backend, m, device: resolve(build, backend, m,
                                                                  torch.device("cuda")))
    res = pt_core.tcim_count(edges, device="cpu")
    assert res.triangles == want and res.stats["build"] == "device"
    monkeypatch.setattr(pt_build, "_CAND_GUARD", 1)
    with pytest.raises(ValueError, match="host"):
        pt_core.device_build(edges, device="cpu")
    with pytest.raises(ValueError, match="host"):
        pt_core.device_delta_worklist(edges[:10, 0], edges[:10, 1],
                                      pt_core.build_sbf(pt_build_graph(edges), 64), device="cpu")
    for entry, arg in ((pt_core.tcim_count, edges),
                       (pt_core.tcim_count_graph, pt_build_graph(edges, reorder=True))):
        with pytest.raises(ValueError, match="host"):
            entry(arg, build="device", device="cpu")
        res = entry(arg, device="cpu")
        assert res.triangles == want and res.stats["build"] == "host"
    assert set(res.timings_s) == {"compress", "schedule", "plan", "execute"}
    res = pt_core.tcim_count(edges, device="cpu")
    assert set(res.timings_s) == {"orient", "compress", "schedule", "plan", "execute"}


def test_device_build_refuses_unported_placements():
    """The device build runs the replicated placement on one device; the
    planner's refusals hold for it as for the host build: an unknown
    placement, and a sharded one without a mesh to shard over (the
    reference's ValueErrors)."""
    edges = rmat(300, 1800, seed=3)
    with pytest.raises(ValueError, match="placement"):
        pt_core.tcim_count(edges, build="device", placement="x", device="cpu")
    for placement in ("sharded_cols", "sharded_2d"):
        with pytest.raises(ValueError, match="mesh"):
            pt_core.tcim_count(edges, build="device", placement=placement, device="cpu")
        with pytest.raises(ValueError, match="mesh"):
            jx_core.tcim_count(edges, build="host", placement=placement)
