"""Port vs reference: durable stream serving and the checkpoint store.

The reference's durable cases (``tests/test_serve.py``: unknown ids, the
torn WAL tail, kill and restore, a kill -9 child, a crash between the WAL
append and the snapshot commit, fault injection, delta failure isolation,
spill and re-admission, compaction, producer threads) run side by side on
``repro.launch.tc_serve.TCServer`` and ``repro_torch.launch.tc_serve
.TCServer`` (on the CPU, ``device="cpu"``), each in its own WAL root: every
count, every result and every ``server_stats()`` counter must be equal. The
WAL and checkpoint files are the reference's layout, so a root written by
either package must restore in the other with equal counts, and the
checkpoint store must write the reference's leaf paths and manifests.
"""
import itertools
import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (both packages in one process, JAX on the CPU)
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

import repro.checkpoint.store as jx_store  # noqa: E402
import repro.core as jx_core  # noqa: E402
import repro.launch.tc_serve as jx_serve  # noqa: E402
import repro.runtime.fault as jx_fault  # noqa: E402
from repro.graphs import build_graph, rmat  # noqa: E402
from repro.graphs.exact import triangles_intersection  # noqa: E402

import repro_torch.checkpoint as pt_store  # noqa: E402
import repro_torch.launch.tc_serve as pt_serve  # noqa: E402
import repro_torch.runtime.fault as pt_fault  # noqa: E402
from repro_torch.core.sbf import sbf_from_arrays, worklist_from_arrays  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
PACKAGES = (jx_serve, pt_serve)
# Fields of a ServeResult both packages must agree on (latency_s is a clock).
RESULT_FIELDS = ("request_id", "status", "count", "placement", "batch_size", "retries", "detail")


def _edge_pool(n, seed):
    """Every undirected edge on n vertices, shuffled — slicing it yields
    pairwise-disjoint batches (stream validation rejects re-adds)."""
    pool = np.array(list(itertools.combinations(range(n), 2)), dtype=np.int64)
    np.random.default_rng(seed).shuffle(pool)
    return pool


def _recount(edges, n):
    return triangles_intersection(build_graph(np.asarray(edges), n=n, reorder=False))


def _server(mod, **config):
    if mod is pt_serve:
        config["device"] = "cpu"
        if "injector" in config:  # each server gets its own injector
            inj = config["injector"]
            config["injector"] = pt_fault.FailureInjector(
                fail_at_steps=inj.fail_at_steps, fail_every=inj.fail_every, repeats=inj.repeats)
    return mod.TCServer(mod.ServeConfig(**config))


def _restore(mod, root, **kwargs):
    if mod is pt_serve:
        kwargs["device"] = "cpu"
    return mod.TCServer.restore(root, **kwargs)


def _results(results):
    return [tuple(getattr(r, f) for f in RESULT_FIELDS)
            for r in sorted(results, key=lambda r: r.request_id)]


def _both(scenario, tmp_path):
    """Run ``scenario(mod, root)`` for both packages in separate roots; the
    observations it returns must be equal."""
    obs = [scenario(mod, tmp_path / mod.__name__) for mod in PACKAGES]
    assert obs[1] == obs[0]
    return obs[1]


def _observe(srv):
    return {"stats": srv.server_stats(), "pending": srv.pending,
            "counts": {sid: srv.stream_count(sid) for sid in sorted(srv._streams)}}


# ---------------------------------------------------------------------------
# Streams and the WAL, side by side
# ---------------------------------------------------------------------------


def test_stream_unknown_id_errors_and_budget_released_once(tmp_path):
    """close_stream/stream_count/submit_delta on an unknown id raise naming
    the id; double-close releases the budget charge exactly once."""

    def scenario(mod, root):
        srv = _server(mod)
        pool = _edge_pool(20, 0)
        sid = srv.create_stream(pool[:40], n=20)
        charged = srv._stream_bytes
        assert charged > 0
        for bad_call in (srv.close_stream, srv.stream_count,
                         lambda i: srv.submit_delta(i, added=pool[40:42])):
            with pytest.raises(ValueError, match="999"):
                bad_call(999)
        assert srv._stream_bytes == charged
        final = srv.close_stream(sid)
        with pytest.raises(ValueError, match=str(sid)):
            srv.close_stream(sid)
        return charged, final, _observe(srv)

    charged, final, obs = _both(scenario, tmp_path)
    assert obs["stats"]["stream_bytes"] == 0 and final == _recount(_edge_pool(20, 0)[:40], 20)


def test_server_streams_next_to_one_shot_requests(tmp_path):
    """tests/test_streaming.py's server case: deltas drain FIFO next to
    one-shot requests, a rejected batch leaves the stream untouched, the
    stream's standing charge shrinks the admission budget."""
    g = build_graph(rmat(300, 1800, seed=12), reorder=False)
    order = np.random.default_rng(4).permutation(g.m)
    base, hold = g.edges[order[:-120]], g.edges[order[-120:]]
    jobs = []
    for i in range(4):
        jg = build_graph(rmat(64, 300, seed=50 + i))
        sb = jx_core.build_sbf(jg, 64)
        jobs.append((sb, jx_core.build_worklist(jg, sb)))

    def scenario(mod, root):
        srv = _server(mod, mode="jnp")
        sid = srv.create_stream(base, n=g.n)
        r_add = srv.submit_delta(sid, added=hold)
        r_bad = srv.submit_delta(sid, added=hold[:1])  # now a duplicate edge
        for sb, wl in (jobs if mod is jx_serve else
                       [(sbf_from_arrays(s), worklist_from_arrays(w)) for s, w in jobs]):
            srv.submit(sb, wl)
        out = _results(srv.drain())
        return out, _observe(srv), srv.close_stream(sid)

    out, obs, final = _both(scenario, tmp_path)
    by_id = {r[0]: r for r in out}
    assert by_id[1][1] == "ok" and by_id[2][1] == "rejected"
    assert final == _recount(g.edges, g.n)
    tiny = pt_serve.TCServer(pt_serve.ServeConfig(memory_budget_bytes=64, device="cpu"))
    with pytest.raises(ValueError, match="budget"):
        tiny.create_stream(base, n=g.n)


def test_wal_torn_tail_truncates_and_frames_match_reference(tmp_path):
    """The port's log is the reference's byte for byte; a torn tail (bad
    crc, no frame, truncated line) truncates the records in both readers."""
    logs = {}
    for mod in PACKAGES:
        wal = mod.StreamWAL(tmp_path / mod.__name__)
        wal.log_delta(0, [[0, 1]], None)
        wal.log_delta(1, np.array([[1, 2], [3, 4]]), np.array([[5, 6]]))
        wal.log_apply(0, 5)
        wal.log_error(1)
        wal.log_close(7)
        wal.close()
        logs[mod] = wal.path
    data = logs[pt_serve].read_bytes()
    assert data == logs[jx_serve].read_bytes()
    path = logs[pt_serve]
    good = pt_serve.StreamWAL.read_records(path)
    assert [r[0] for r in good] == ["delta", "delta", "apply", "error", "close"]
    with path.open("a") as fh:
        fh.write('deadbeef ["delta",2,9,[[3,4]],null]\n')  # bad crc
        fh.write("not a frame at all\n")
    assert pt_serve.StreamWAL.read_records(path) == good
    with path.open("a") as fh:
        fh.write("00aa")  # truncated frame, no newline
    assert pt_serve.StreamWAL.read_records(path) == good == jx_serve.StreamWAL.read_records(path)


@pytest.mark.parametrize("kill_after", [1, 4, 8], ids=["early", "middle", "late"])
def test_server_kill_and_restore_replays_to_exact_count(tmp_path, kill_after):
    """A server abandoned after ``kill_after`` applied deltas (plus an
    undrained tail) restores to the exact live count, replaying <=
    checkpoint_every deltas, and drains the tail to the count a never-killed
    stream reaches — in both packages, with equal restore_info, results and
    counters; and each package restores the other's root to the same."""
    n, cadence = 24, 3
    pool = _edge_pool(n, kill_after)
    batches = [pool[50 + 8 * i: 58 + 8 * i] for i in range(10)]

    def kill(mod, root):
        srv = _server(mod, wal_dir=str(root), checkpoint_every=cadence)
        sid = srv.create_stream(pool[:50], n=n)
        for b in batches[:kill_after]:
            srv.submit_delta(sid, added=b)
        drained = _results(srv.drain())
        live = srv.stream_count(sid)
        for b in batches[kill_after:]:
            srv.submit_delta(sid, added=b)  # write-ahead logged, never drained
        srv._streams[sid].wal.snaps.wait()
        return sid, live, drained

    def restore(mod, root, sid, live):
        srv = _restore(mod, root)
        info = srv.restore_info["streams"][sid]
        assert srv.stream_count(sid) == live
        assert info["replayed"] <= cadence
        assert info["requeued"] == srv.pending == len(batches) - kill_after
        out = _results(srv.drain())
        assert all(r[1] == "ok" for r in out)
        return srv.restore_info, out, _observe(srv)

    want = _recount(np.concatenate([pool[:50]] + batches), n)
    seen = []
    for writer in PACKAGES:
        root = tmp_path / writer.__name__
        sid, live, drained = kill(writer, root)
        for reader in PACKAGES:
            copy = tmp_path / f"{writer.__name__}-{reader.__name__}"
            shutil.copytree(root, copy)
            info, out, obs = restore(reader, copy, sid, live)
            assert obs["counts"][sid] == want
            seen.append((live, drained, info, out, obs))
    assert all(s == seen[0] for s in seen[1:])


def test_server_kill_minus_nine_subprocess(tmp_path):
    """A child running the port's server dies via os._exit mid-serving; the
    parent restores its WAL root with the port and with the reference and
    recovers the exact pre-kill count plus the logged-but-undrained tail."""
    code = f"""
import itertools, os
import numpy as np
from repro_torch.launch.tc_serve import ServeConfig, TCServer

pool = np.array(list(itertools.combinations(range(24), 2)), dtype=np.int64)
np.random.default_rng(7).shuffle(pool)
np.save({str(tmp_path)!r} + "/pool.npy", pool)
srv = TCServer(ServeConfig(wal_dir={str(tmp_path / "root")!r}, checkpoint_every=3, device="cpu"))
sid = srv.create_stream(pool[:60], n=24)
for i in range(5):
    srv.submit_delta(sid, added=pool[60 + 8 * i : 68 + 8 * i])
srv.drain()
print("LIVE", sid, srv.stream_count(sid), flush=True)
srv.submit_delta(sid, added=pool[100:108])  # logged, never drained
os._exit(9)  # hard kill: no destructors run
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 9, out.stderr[-3000:]
    _, sid, live = out.stdout.split()
    sid, live = int(sid), int(live)
    pool = np.load(tmp_path / "pool.npy")
    for mod in PACKAGES:
        root = tmp_path / f"restore-{mod.__name__}"
        shutil.copytree(tmp_path / "root", root)
        srv = _restore(mod, root)
        assert srv.stream_count(sid) == live and srv.pending == 1
        assert all(r.status == "ok" for r in srv.drain())
        assert srv.stream_count(sid) == _recount(pool[:108], 24)


def test_crash_between_wal_append_and_snapshot_commit(tmp_path):
    """A staged-but-uncommitted snapshot is ignored, GC'd on restore, and the
    stream replays from the last committed one to the exact live count."""
    n = 24
    pool = _edge_pool(n, 11)

    def scenario(mod, root):
        srv = _server(mod, wal_dir=str(root), checkpoint_every=2)
        sid = srv.create_stream(pool[:50], n=n)
        for i in range(5):
            srv.submit_delta(sid, added=pool[50 + 6 * i: 56 + 6 * i])
        srv.drain()
        live = srv.stream_count(sid)
        sdir = srv._streams[sid].wal.directory
        srv._streams[sid].wal.snaps.wait()
        del srv
        orphan = sdir / "snap" / ".tmp_step_00000099"
        orphan.mkdir()
        (orphan / "leaf_00000.npy").write_bytes(b"partial write")
        srv2 = _restore(mod, root)
        info = srv2.restore_info["streams"][sid]
        assert info["orphans_gc"] >= 1 and not orphan.exists()
        assert srv2.stream_count(sid) == live and info["replayed"] <= 2
        return live, srv2.restore_info, _observe(srv2)

    _both(scenario, tmp_path)


def test_server_fault_injected_soak_with_streams(tmp_path):
    """One-shot requests and stream deltas in one drain under injected
    faults: a transient failure (a delta) recovers through the retry, a
    hard one (a request) reports status='error', and neither changes any
    other result — in step with the reference."""
    jobs = []
    for i in range(8):
        jg = build_graph(rmat(64, 350, seed=40 + i))
        sb = jx_core.build_sbf(jg, 64)
        jobs.append((sb, jx_core.build_worklist(jg, sb)))
    pool = _edge_pool(22, 3)

    def scenario(mod, root):
        srv = _server(mod, injector=jx_fault.FailureInjector(fail_at_steps=(1, 6)),
                      max_fused_pairs=1 << 12, retry_backoff_s=0.0)
        carried = jobs if mod is jx_serve else [
            (sbf_from_arrays(s), worklist_from_arrays(w)) for s, w in jobs]
        sid = srv.create_stream(pool[:40], n=22)  # rid 0
        srv.submit_delta(sid, added=pool[40:48])  # rid 1: fails once
        for sb, wl in carried:
            srv.submit(sb, wl)  # rids 2-9; rid 6 fails once
        out = _results(srv.drain())
        srv.config.injector.fail_at_steps = (10, 12)
        srv.config.injector.repeats = 99  # hard from here on
        srv.submit_delta(sid, removed=pool[:10])  # rid 10: keeps failing
        srv.submit_delta(sid, removed=pool[10:14])  # rid 11
        for sb, wl in carried[:2]:
            srv.submit(sb, wl)  # rid 12 keeps failing, rid 13
        out += _results(srv.drain())
        return out, _observe(srv)

    out, obs = _both(scenario, tmp_path)
    by_id = {r[0]: r for r in out}
    assert by_id[1][1] == "ok" and by_id[1][5] == 1
    assert by_id[6][1] == "ok" and "recovered" in by_id[6][6]
    for rid in (10, 12):
        assert by_id[rid][1] == "error" and "SimulatedFailure" in by_id[rid][6]
    assert all(by_id[rid][1] == "ok" for rid in by_id if rid not in (10, 12))
    # rid 10's removal was NACKed, so only rid 11's edges left the stream.
    assert obs["counts"][0] == _recount(np.concatenate([pool[:10], pool[14:48]]), 22)


def test_stream_delta_failure_isolated_and_durable(tmp_path):
    """A hard-failing delta errors without poisoning its neighbours; the
    WAL's error marker makes restore equal to the live server."""
    n = 20
    pool = _edge_pool(n, 21)

    def scenario(mod, root):
        srv = _server(mod, wal_dir=str(root), injector=jx_fault.FailureInjector(repeats=99),
                      max_retries=1, retry_backoff_s=0.0)
        sid = srv.create_stream(pool[:40], n=n)
        srv.submit_delta(sid, added=pool[40:46])
        r_bad = srv.submit_delta(sid, added=pool[46:52])
        srv.submit_delta(sid, added=pool[52:58])
        srv.config.injector.fail_at_steps = (r_bad,)
        out = _results(srv.drain())
        live = _observe(srv)
        del srv
        srv2 = _restore(mod, root)  # no injector this time
        assert srv2.pending == 0
        return out, live, srv2.restore_info, _observe(srv2)["counts"]

    out, live, _, counts = _both(scenario, tmp_path)
    assert [r[1] for r in out] == ["ok", "error", "ok"]
    assert counts == live["counts"] == {0: _recount(
        np.concatenate([pool[:40], pool[40:46], pool[52:58]]), n)}


def test_stream_eviction_spill_readmit_count_preserving(tmp_path):
    """Under a budget that holds two of three streams, streams LRU-spill and
    re-admit transparently; counts stay exact and counters equal."""
    n = 26
    pools = [_edge_pool(n, 60 + i) for i in range(3)]
    cost = pt_serve.TCServer._stream_footprint(
        jx_core.StreamingTCState(pools[0][:48], n=n)._sbf)
    budget = int(2.5 * cost)

    def scenario(mod, root):
        srv = _server(mod, memory_budget_bytes=budget)
        sids = [srv.create_stream(p[:48], n=n) for p in pools]
        assert srv.server_stats()["streams_spilled"] >= 1
        cursors = [48] * 3
        rng = np.random.default_rng(0)
        seen = []
        for _ in range(6):
            i = int(rng.integers(0, 3))
            srv.submit_delta(sids[i], added=pools[i][cursors[i]: cursors[i] + 6])
            cursors[i] += 6
            out = srv.drain()
            assert all(r.status == "ok" for r in out)
            for j, sid in enumerate(sids):
                assert srv.stream_count(sid) == _recount(pools[j][: cursors[j]], n)
            seen.append(_observe(srv))
        assert srv._stream_bytes <= budget
        return seen

    seen = _both(scenario, tmp_path)
    assert seen[-1]["stats"]["readmits"] >= 1


def test_stream_compaction_triggers_and_preserves_counts(tmp_path):
    n = 26
    pool = _edge_pool(n, 70)

    def scenario(mod, root):
        srv = _server(mod, compact_ratio=0.3)
        sid = srv.create_stream(pool[:90], n=n)
        for i in range(0, 70, 10):
            srv.submit_delta(sid, removed=pool[i: i + 10])
        out = _results(srv.drain())
        mid = _observe(srv)
        srv.submit_delta(sid, added=pool[90:100])
        out += _results(srv.drain())
        return out, mid, _observe(srv)

    out, mid, end = _both(scenario, tmp_path)
    assert all(r[1] == "ok" for r in out)
    assert mid["stats"]["compactions"] >= 1
    assert mid["counts"][0] == _recount(pool[70:90], n)
    assert end["counts"][0] == _recount(pool[70:100], n)


def test_server_daemon_multi_producer_threads():
    """Three producer threads share one port server under serve_forever,
    each with its own stream and one-shot requests; every producer's
    results are exact and stop() drains in-flight work."""
    srv = _server(pt_serve, max_fused_pairs=1 << 12)
    daemon = threading.Thread(target=srv.serve_forever, daemon=True)
    daemon.start()
    errs = []
    pools = [_edge_pool(20, 80 + t) for t in range(3)]

    def producer(tid):
        try:
            sid = srv.create_stream(pools[tid][:30], n=20)
            for i in range(3):
                jg = build_graph(rmat(48, 220, seed=100 * tid + i))
                sb = jx_core.build_sbf(jg, 64)
                rid = srv.submit(sbf_from_arrays(sb),
                                 worklist_from_arrays(jx_core.build_worklist(jg, sb)))
                r = srv.wait_result(rid, timeout=60)
                assert r.status == "ok" and r.count == triangles_intersection(jg), r
                did = srv.submit_delta(sid, added=pools[tid][30 + 5 * i: 35 + 5 * i])
                d = srv.wait_result(did, timeout=60)
                assert d.count == _recount(pools[tid][: 35 + 5 * i], 20), d
        except Exception as e:  # surfaced to the main thread below
            errs.append(e)

    threads = [threading.Thread(target=producer, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    srv.stop()
    daemon.join(timeout=60)
    assert not daemon.is_alive() and not any(t.is_alive() for t in threads)
    assert not errs, errs


def test_checkpoint_and_restore_cross_package_with_pending_work(tmp_path):
    """A server without a WAL root adopts one at checkpoint(dir): its streams
    get logs, queued deltas are logged, pending one-shot requests persist.
    That root restores in either package to the same pending work, and
    draining it gives equal results and counters. server.json carries
    exactly the reference's config keys (the device is not written)."""
    n = 22
    pool = _edge_pool(n, 5)
    jobs = []
    for i in range(3):
        jg = build_graph(rmat(64, 300, seed=60 + i))
        sb = jx_core.build_sbf(jg, 64)
        jobs.append((sb, jx_core.build_worklist(jg, sb)))

    def write(mod, root):
        srv = _server(mod, checkpoint_every=4)
        sids = [srv.create_stream(pool[:40], n=n), srv.create_stream(pool[100:150], n=n)]
        srv.submit_delta(sids[0], added=pool[40:48])
        srv.drain()
        srv.submit_delta(sids[0], removed=pool[:5])
        srv.submit_delta(sids[1], added=pool[150:160])
        carried = jobs if mod is jx_serve else [
            (sbf_from_arrays(s), worklist_from_arrays(w)) for s, w in jobs]
        for sb, wl in carried:
            srv.submit(sb, wl)
        summary = srv.checkpoint(root)
        with pytest.raises(ValueError, match="one durable root"):
            srv.checkpoint(root / "elsewhere")
        return summary

    summaries = {mod: write(mod, tmp_path / mod.__name__) for mod in PACKAGES}
    assert summaries[pt_serve] == summaries[jx_serve] == {
        "streams": 2, "pending_deltas": 2, "pending_requests": 3}
    manifests = [json.loads((tmp_path / m.__name__ / "server.json").read_text()) for m in PACKAGES]
    assert manifests[0] == manifests[1]
    assert tuple(manifests[1]["config"]) == jx_serve._MANIFEST_CONFIG_KEYS \
        == pt_serve._MANIFEST_CONFIG_KEYS
    seen = []
    for writer in PACKAGES:
        for reader in PACKAGES:
            copy = tmp_path / f"{writer.__name__}-{reader.__name__}"
            shutil.copytree(tmp_path / writer.__name__, copy)
            srv = _restore(reader, copy)
            assert srv.pending == 5
            out = _results(srv.drain())
            seen.append((srv.restore_info, out, _observe(srv)))
    assert all(s == seen[0] for s in seen[1:])
    counts = seen[0][2]["counts"]
    assert counts[0] == _recount(np.concatenate([pool[5:40], pool[40:48]]), n)
    assert counts[1] == _recount(pool[100:160], n)


def test_server_refuses_only_mesh_and_resilience():
    """mesh and resilience are process-local (never in server.json); a mesh
    must be a port Mesh of the server's device kind."""
    from repro_torch.distributed import ResilienceConfig, make_mesh

    with pytest.raises(TypeError, match="Mesh"):
        pt_serve.TCServer(pt_serve.ServeConfig(device="cpu", mesh=object()))
    mesh = make_mesh((2, 2), ("r", "c"), devices=["cpu"] * 4)
    cfg = ResilienceConfig("unused")
    srv = pt_serve.TCServer(pt_serve.ServeConfig(device="cpu", mesh=mesh, resilience=cfg))
    assert srv.config.mesh is mesh and srv.config.resilience is cfg
    assert not {"mesh", "resilience", "injector", "device"} & set(pt_serve._MANIFEST_CONFIG_KEYS)
    with pytest.raises(ValueError, match="no checkpoint directory"):
        _server(pt_serve).checkpoint()
    assert {f for f in pt_serve._MANIFEST_CONFIG_KEYS} <= set(pt_serve.ServeConfig.__dataclass_fields__)


# ---------------------------------------------------------------------------
# The checkpoint store
# ---------------------------------------------------------------------------


def _tree(bf16):
    rng = np.random.default_rng(0)
    return {
        "r10": {"row_ptr": np.arange(5, dtype=np.int64),
                "data": rng.integers(0, 2**32, size=(3, 2), dtype=np.uint64).astype(np.uint32)},
        "r5": [np.float32(1.5) * np.ones((2, 2), np.float32), (np.int32(7),)],
        "w": bf16,
        "none": None,
    }


def test_checkpoint_store_matches_reference_and_cross_loads(tmp_path):
    """Leaf paths, files, shapes and dtypes in the manifest equal the
    reference's on the same tree (a torch bf16 tensor beside the reference's
    ml_dtypes bf16 array, stored as the same uint16 bytes), and each package
    loads the other's checkpoint."""
    vals = np.array([1.5, -2.25, 3.0e38, 0.0], np.float32)
    pt_tree = _tree(torch.from_numpy(vals).to(torch.bfloat16))
    jx_tree = _tree(vals.astype(ml_dtypes.bfloat16))
    pt_store.save_checkpoint(tmp_path / "pt", 3, pt_tree, extra={"k": [1, 2]})
    jx_store.save_checkpoint(tmp_path / "jx", 3, jx_tree, extra={"k": [1, 2]})
    man = [json.loads((tmp_path / d / "step_00000003" / "manifest.json").read_text())
           for d in ("jx", "pt")]
    for m in man:
        m.pop("time")
    assert man[0] == man[1]
    assert [leaf["path"] for leaf in man[1]["leaves"]] == [
        "['r10']/['data']", "['r10']/['row_ptr']", "['r5']/[0]", "['r5']/[1]/[0]", "['w']"]
    for leaf in man[1]["leaves"]:
        a = np.load(tmp_path / "pt" / "step_00000003" / leaf["file"])
        b = np.load(tmp_path / "jx" / "step_00000003" / leaf["file"])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), leaf["path"]
    got, step, extra = pt_store.load_checkpoint(tmp_path / "jx", pt_tree)
    assert (step, extra) == (3, {"k": [1, 2]})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], pt_tree["w"])
    assert got["none"] is None and isinstance(got["r5"][1], tuple)
    assert np.array_equal(got["r10"]["data"], jx_tree["r10"]["data"])
    back, _, _ = jx_store.load_checkpoint(tmp_path / "pt", jx_tree)
    assert back["w"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(np.asarray(back["w"]).view(np.uint16), jx_tree["w"].view(np.uint16))
    assert np.array_equal(np.asarray(back["r5"][0]), jx_tree["r5"][0])
    with pytest.raises(ValueError, match="shape mismatch"):
        pt_store.load_checkpoint(tmp_path / "pt", {**pt_tree, "w": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        pt_store.load_checkpoint(tmp_path / "pt", {"absent": 0})


def test_checkpoint_store_round_trip_device_leaves_and_ext_dtypes(tmp_path):
    """Tensors (any device) are copied to the host; float8 leaves keep their
    raw bytes; a torch tensor loads back as NumPy unless its dtype is an
    extension one."""
    tree = {"i": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "f8": torch.tensor([0.5, -1.0, 2.0]).to(torch.float8_e4m3fn),
            "e5": torch.tensor([4.0]).to(torch.float8_e5m2),
            "n": [np.uint32(2**32 - 1)]}
    pt_store.save_checkpoint(tmp_path, 0, tree)
    got, _, _ = pt_store.load_checkpoint(tmp_path, tree)
    assert np.array_equal(got["i"], tree["i"].numpy())
    for k in ("f8", "e5"):
        assert got[k].dtype == tree[k].dtype
        assert torch.equal(got[k].view(torch.uint8), tree[k].view(torch.uint8))
    assert int(got["n"][0]) == 2**32 - 1


def test_checkpoint_manager_async_retention_and_errors(tmp_path):
    """save_async writes on a thread (wait() joins it); keep_last retains the
    newest committed steps; a failed background write re-raises at wait();
    gc_orphans drops staged leftovers; restore loads the latest step."""
    mgr = pt_store.CheckpointManager(tmp_path / "c", keep_last=2)
    for step in range(4):
        mgr.save_async(step, {"x": torch.full((3,), step)}, extra={"s": step})
    mgr.wait()
    assert pt_store.list_steps(mgr.directory) == [2, 3] and mgr.latest_step() == 3
    tree, step, extra = mgr.restore({"x": 0})
    assert step == 3 and extra == {"s": 3} and tree["x"].tolist() == [3, 3, 3]
    orphan = mgr.directory / ".tmp_step_00000009"
    orphan.mkdir()
    assert mgr.gc_orphans() == 1 and not orphan.exists()
    (mgr.directory / ".tmp_step_00000005").write_text("a file where the staging dir goes")
    mgr.save_async(5, {"x": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        mgr.wait()
    mgr.wait()  # the error is raised once
    with pytest.raises(FileNotFoundError):
        pt_store.load_checkpoint(tmp_path / "empty", {"x": 0})
