"""Port vs reference: resumable, elastic sharded counts.

``repro_torch.runtime`` (``CountInterrupted``, ``StragglerMonitor``, the
remesh plans) and ``repro_torch.distributed.resilient`` against the JAX
package's: interrupted counts carry the same committed cursors, the remesh
grids are equal for every grid up to 8 devices and every survivor count,
and ``resilient_tc_count`` on meshes of logical CPU shards recovers
(1, 4) -> (1, 3) and (4, 2) -> (3, 2) at early, middle and late failures,
and through the 8 -> 4 -> 2 -> 1 cascade, with the exact count and the
reference's own info (grid, attempts, failures, steps replayed, remeshes).
The reference needs eight devices for those runs, so it runs once, in one
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(the ``_run`` pattern of ``tests/test_resilient.py``); the same run resumes
a checkpoint root the port wrote and writes one the port resumes, so a root
resumes across the two packages both ways.
"""
import functools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402,F401  (both packages in one process, JAX on the CPU)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro.core as jx_core  # noqa: E402
import repro.distributed as jx_dist  # noqa: E402
import repro.runtime as jx_runtime  # noqa: E402
from repro.graphs import build_graph, rmat  # noqa: E402
from repro.graphs.exact import triangles_intersection  # noqa: E402

import repro_torch.core as pt_core  # noqa: E402
import repro_torch.distributed as pt_dist  # noqa: E402
import repro_torch.runtime as pt_runtime  # noqa: E402
from repro_torch.core.sbf import sbf_from_arrays, worklist_from_arrays  # noqa: E402
from repro_torch.distributed.resilient import _build_executor  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
GRAPH = dict(n=400, m=2500, seed=1)
CHUNK = 256
EVERY = 2
CPU = [torch.device("cpu")] * 8
KILLS = (((1, 4), 1, (1, 3)), ((4, 2), 2, (3, 2)))
STAGES = ("early", "middle", "late")
CASCADE = dict(fail_at=(1, 3, 5), lose=(4, 2, 1))
# Info keys both packages must agree on (recovery_s is a clock).
INFO_KEYS = ("grid", "attempts", "failures", "steps_replayed", "remeshes", "steps", "checkpoints")


@functools.lru_cache(maxsize=None)
def _fixture():
    g = build_graph(rmat(**GRAPH), reorder=True)
    sb = jx_core.build_sbf(g)
    wl = jx_core.build_worklist(g, sb)
    return sb, wl, sbf_from_arrays(sb), worklist_from_arrays(wl), triangles_intersection(g)


def _mesh(grid, devices=CPU):
    return pt_dist.make_mesh(grid, ("rows", "cols"), devices=devices)


def _fail_at(stage, steps):
    return {"early": 1, "middle": steps // 2, "late": steps - 1}[stage]


def _info(info):
    return {k: info[k] for k in INFO_KEYS}


# The reference's side, in one interpreter with 8 forced host devices: the
# kill matrix, the cascade, a resume of the port's root and a root of its own.
_REFERENCE = """
import json, shutil, sys, tempfile
import numpy as np
import jax
from jax.sharding import Mesh

from repro.core import build_sbf, build_worklist
from repro.graphs import build_graph, rmat
from repro.distributed import ResilienceConfig, resilient_tc_count, resume_tc_count
from repro.distributed.resilient import _build_executor
from repro.runtime import CountInterrupted, FailureInjector

INFO_KEYS = {info_keys!r}
port_root, ref_root = sys.argv[1], sys.argv[2]
g = build_graph(rmat(n={n}, m={m}, seed={seed}), reorder=True)
sbf = build_sbf(g)
wl = build_worklist(g, sbf)
devs = jax.devices()
assert len(devs) == 8, devs

def mesh(grid):
    return Mesh(np.asarray(devs[:grid[0] * grid[1]], dtype=object).reshape(grid), ('rows', 'cols'))

def info(i):
    return {{k: i[k] for k in INFO_KEYS}}

out = {{'kills': {{}}}}
for grid, lose, _ in {kills!r}:
    ex, plan = _build_executor(sbf, wl, mesh(grid), chunk_pairs={chunk}, schedule='packed')
    steps = ex.stripe_schedule(plan).num_steps
    for stage in {stages!r}:
        fail_at = {{'early': 1, 'middle': steps // 2, 'late': steps - 1}}[stage]
        with tempfile.TemporaryDirectory() as d:
            cfg = ResilienceConfig(checkpoint_dir=d, checkpoint_every={every},
                                   injector=FailureInjector(fail_at_steps=(fail_at,)),
                                   lose_devices=lose)
            total, i = resilient_tc_count(sbf, wl, mesh(grid), cfg, chunk_pairs={chunk})
        out['kills'][f'{{grid}}-{{stage}}'] = [total, info(i)]
with tempfile.TemporaryDirectory() as d:
    cfg = ResilienceConfig(checkpoint_dir=d, checkpoint_every={every},
                           injector=FailureInjector(fail_at_steps={fail_at!r}),
                           lose_devices={lose!r}, max_failures=3)
    total, i = resilient_tc_count(sbf, wl, mesh((4, 2)), cfg, chunk_pairs={chunk})
out['cascade'] = [total, info(i)]
total, i = resume_tc_count(port_root, mesh((2, 2)), checkpoint_every={every})
out['resume_port_root'] = [total, i]
cfg = ResilienceConfig(checkpoint_dir=ref_root, checkpoint_every={every},
                       injector=FailureInjector(fail_at_steps=(5,)), lose_devices=0,
                       max_failures=0)
try:
    resilient_tc_count(sbf, wl, mesh((4, 2)), cfg, chunk_pairs={chunk})
    raise SystemExit('the reference count was not interrupted')
except CountInterrupted:
    pass
shutil.copytree(ref_root, ref_root + '-own')
total, i = resume_tc_count(ref_root + '-own', mesh((2, 2)), checkpoint_every={every})
out['resume_own_root'] = [total, i]
print('JSON', json.dumps(out))
"""


def _interrupted_port_root(root: Path) -> None:
    """A root the port wrote: a (2, 2) count killed at step 5."""
    _, _, psb, pwl, _ = _fixture()
    cfg = pt_dist.ResilienceConfig(checkpoint_dir=root, checkpoint_every=EVERY,
                                   injector=pt_runtime.FailureInjector(fail_at_steps=(5,)),
                                   lose_devices=0, max_failures=0)
    with pytest.raises(pt_runtime.CountInterrupted):
        pt_dist.resilient_tc_count(psb, pwl, _mesh((2, 2)), cfg, chunk_pairs=CHUNK)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's run (one subprocess), beside the roots it used."""
    work = tmp_path_factory.mktemp("resilient")
    port_root, ref_root = work / "port_root", work / "ref_root"
    _interrupted_port_root(port_root)
    shutil.copytree(port_root, work / "port_root-own")
    code = _REFERENCE.format(
        info_keys=INFO_KEYS, kills=KILLS, stages=STAGES, chunk=CHUNK, every=EVERY,
        fail_at=CASCADE["fail_at"], lose=CASCADE["lose"], **GRAPH,
    )
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code, str(port_root), str(ref_root)],
                         capture_output=True, text=True, env=env, timeout=560)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("JSON "))
    return json.loads(line[5:]), work


def _json(obj):
    return json.loads(json.dumps(obj))


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("kill", KILLS, ids=["1x4-lose1", "4x2-lose2"])
def test_kill_a_device_matches_reference(reference, kill, stage):
    """Lose 1 of 4 (row mesh) or 2 of 8 (4 x 2) at the given point of the
    schedule: the shrunk mesh finishes with the exact count, at most
    checkpoint_every steps replayed, and the reference's info."""
    grid, lose, want_grid = kill
    _, _, psb, pwl, want = _fixture()
    ex, plan = _build_executor(psb, pwl, _mesh(grid), chunk_pairs=CHUNK, schedule="packed")
    steps = ex.stripe_schedule(plan).num_steps
    assert steps >= 4
    cfg = pt_dist.ResilienceConfig(
        checkpoint_dir=reference[1] / f"kill-{grid}-{stage}", checkpoint_every=EVERY,
        injector=pt_runtime.FailureInjector(fail_at_steps=(_fail_at(stage, steps),)),
        lose_devices=lose)
    total, info = pt_dist.resilient_tc_count(psb, pwl, _mesh(grid), cfg, chunk_pairs=CHUNK)
    assert total == want
    assert tuple(info["grid"]) == want_grid and info["steps_replayed"] <= EVERY
    assert info["attempts"] == 2 and info["failures"] == 1
    assert [total, _json(_info(info))] == reference[0]["kills"][f"{grid}-{stage}"]


def test_multi_failure_cascade_matches_reference(reference):
    """8 -> 4 -> 2 -> 1 in one count (lose_devices=(4, 2, 1)): exact, every
    replay <= checkpoint_every, the same remeshes as the reference."""
    _, _, psb, pwl, want = _fixture()
    cfg = pt_dist.ResilienceConfig(
        checkpoint_dir=reference[1] / "cascade", checkpoint_every=EVERY,
        injector=pt_runtime.FailureInjector(fail_at_steps=CASCADE["fail_at"]),
        lose_devices=CASCADE["lose"], max_failures=3)
    total, info = pt_dist.resilient_tc_count(psb, pwl, _mesh((4, 2)), cfg, chunk_pairs=CHUNK)
    assert total == want and info["failures"] == 3 and info["attempts"] == 4
    assert [r["grid"][0] * r["grid"][1] for r in info["remeshes"]] == [4, 2, 1]
    assert all(r["replayed"] <= EVERY for r in info["remeshes"]) and info["grid"] == [1, 1]
    assert [total, _json(_info(info))] == reference[0]["cascade"]


def test_port_root_resumes_in_reference(reference):
    """A root the port wrote resumes in the reference (and in the port, on
    an equal mesh, to the same total and info)."""
    _, _, _, _, want = _fixture()
    total, info = pt_dist.resume_tc_count(reference[1] / "port_root-own", _mesh((2, 2)),
                                          checkpoint_every=EVERY)
    assert total == want
    assert [total, _json(info)] == reference[0]["resume_port_root"]


def test_reference_root_resumes_in_port(reference):
    """A root the reference wrote (a (4, 2) count killed at step 5)
    resumes in the port to the exact count, with the reference's own
    resume's info; resuming the finished root again replays nothing."""
    _, _, _, _, want = _fixture()
    root = reference[1] / "ref_root"
    total, info = pt_dist.resume_tc_count(root, _mesh((2, 2)), checkpoint_every=EVERY)
    assert total == want
    assert [total, _json(info)] == reference[0]["resume_own_root"]
    again, info2 = pt_dist.resume_tc_count(root, _mesh((2, 2)))
    assert again == want and info2["steps"] == 0


def test_count_interrupted_and_injected_failure_match_reference(tmp_path):
    """CountInterrupted's fields and steps_replayed; a failure injected at
    step 5 of a 1 x 1 count (the reference's in-process mesh) and of a
    (2, 2) count: the same committed cursor as the reference."""
    for mod in (pt_runtime, jx_runtime):
        e = mod.CountInterrupted("x", failed_step=7, committed_step=4, committed_total=11,
                                 shard_cursors=(np.int64(3), 2), reason="straggler", attempt=2)
        assert (e.failed_step, e.committed_step, e.committed_total, e.shard_cursors, e.reason,
                e.attempt, e.steps_replayed, str(e)) == (7, 4, 11, (3, 2), "straggler", 2, 3, "x")
        assert mod.CountInterrupted("y", failed_step=1, committed_step=3).steps_replayed == 0
        assert mod.CountInterrupted("z", failed_step=1).shard_cursors is None
    sb, wl, psb, pwl, _ = _fixture()
    errs = []
    for pkg, mesh, s, w, runtime in (
        (pt_dist, _mesh((1, 1)), psb, pwl, pt_runtime),
        (jx_dist, jax.make_mesh((1, 1), ("rows", "cols")), sb, wl, jx_runtime),
    ):
        ex = pkg.Sharded2DExecutor(s, mesh, chunk_pairs=CHUNK)
        ckpt = pkg.TCCheckpoint(tmp_path / pkg.__name__)
        with pytest.raises(runtime.CountInterrupted) as ei:
            ex.count_resumable(w, checkpoint_every=2, checkpointer=ckpt,
                               injector=runtime.FailureInjector(fail_at_steps=(5,)))
        errs.append(ei.value)
    got, want = errs
    assert (got.reason, got.failed_step, got.committed_step, got.steps_replayed) == (
        "failure", 5, 4, 1)
    assert (got.committed_total, got.shard_cursors) == (want.committed_total, want.shard_cursors)
    assert isinstance(got.__cause__, pt_runtime.SimulatedFailure)


def test_straggler_monitor_matches_reference():
    """The same step times through both monitors: equal flags, EWMA and
    history; reset forgets; a flagged step in a resumable count commits
    and interrupts with zero replay (observability only without
    monitor_interrupts)."""
    rng = np.random.default_rng(3)
    dts = list(rng.uniform(0.9, 1.1, 20)) + [5.0, 5.0, 5.0, 1.0, 7.0, 7.0, 7.0, 7.0]
    for kw in ({}, {"alpha": 0.3, "threshold": 1.5, "patience": 2}):
        a, b = pt_runtime.StragglerMonitor(**kw), jx_runtime.StragglerMonitor(**kw)
        assert [a.observe(dt) for dt in dts] == [b.observe(dt) for dt in dts]
        assert a.ewma == b.ewma and a.history == b.history
        a.reset()
        assert a.ewma is None and a.history == [] and a._strikes == 0
    mon = pt_runtime.StragglerMonitor()
    mon.start_step()
    assert mon.end_step() is False and mon.ewma is not None

    class FlagAt:
        def __init__(self, step):
            self.step, self.seen, self.ewma = step, 0, 0.001

        def start_step(self):
            pass

        def end_step(self):
            self.seen += 1
            return self.seen == self.step

        def reset(self):
            self.seen = 0

    _, _, psb, pwl, want = _fixture()
    ex = pt_dist.Sharded2DExecutor(psb, _mesh((2, 2)), chunk_pairs=CHUNK)
    with pytest.raises(pt_runtime.CountInterrupted) as ei:
        ex.count_resumable(pwl, checkpoint_every=4, monitor=FlagAt(3), monitor_interrupts=True)
    err = ei.value
    assert err.reason == "straggler" and err.committed_step == err.failed_step == 3
    assert err.steps_replayed == 0
    total, info = ex.count_resumable(pwl, checkpoint_every=4, monitor=FlagAt(3))
    assert total == want and info["straggler_flags"] >= 1 and "step_ewma_s" in info


def test_remesh_plans_match_reference():
    """tc_remesh_plan for every grid up to 8 devices and every survivor
    count (none, fewer, as many, more); elastic_remesh_plan on the
    reference's own cases."""
    for rows in range(1, 9):
        for cols in range(1, 9 // rows + 1):
            for alive in range(0, rows * cols + 2):
                got = pt_runtime.tc_remesh_plan((rows, cols), alive)
                want = jx_runtime.tc_remesh_plan((rows, cols), alive)
                assert got == pt_runtime.RemeshPlan(*(getattr(want, f) for f in (
                    "old_shape", "new_shape", "axis_names", "ok", "reasons")))
                assert got.new_device_count == want.new_device_count
    for args in (((4, 2), ("data", "model"), 6, 8), ((2, 4, 2), ("pod", "data", "model"), 12, 16),
                 ((2, 4, 2), ("pod", "data", "model"), 1, 16), ((8, 3), ("data", "expert"), 9, 6),
                 ((2, 4, 1), ("pod", "data", "model"), 7, 5)):
        got, want = pt_runtime.elastic_remesh_plan(*args), jx_runtime.elastic_remesh_plan(*args)
        assert (got.new_shape, got.ok, got.reasons) == (want.new_shape, want.ok, want.reasons)


def test_resume_from_disk_is_exact(tmp_path):
    """The process-died case on a (2, 2) mesh: the interrupted count's root
    resumes onto a fresh (1, 3) mesh of survivors from the disk alone, and
    resuming a finished count replays nothing."""
    _, _, psb, pwl, want = _fixture()
    cfg = pt_dist.ResilienceConfig(checkpoint_dir=tmp_path, checkpoint_every=2,
                                   injector=pt_runtime.FailureInjector(fail_at_steps=(5,)),
                                   lose_devices=0, max_failures=0)
    with pytest.raises(pt_runtime.CountInterrupted):
        pt_dist.resilient_tc_count(psb, pwl, _mesh((2, 2)), cfg, chunk_pairs=CHUNK)
    ckpt = pt_dist.TCCheckpoint(tmp_path)
    assert ckpt.peek()["grid"] == [2, 2] and ckpt.peek()["placement"] == "sharded_2d"
    state = ckpt.load_latest(mesh=_mesh((1, 3)))
    assert state.committed_step == 4 and state.shard_cursors is not None
    assert state.worklist.num_pairs == pwl.num_pairs and state.grid == (2, 2)
    total, info = pt_dist.resume_tc_count(tmp_path, _mesh((1, 3)))
    assert total == want and info["attempt"] == 1 and info["grid"] == [3, 1]
    total2, info2 = pt_dist.resume_tc_count(tmp_path, _mesh((1, 3)))
    assert total2 == want and info2["steps"] == 0
    with pytest.raises(ValueError, match="2-axis"):
        pt_dist.resume_tc_count(tmp_path, pt_dist.make_mesh((3,), ("d",), devices=CPU))
    with pytest.raises(FileNotFoundError):
        pt_dist.TCCheckpoint(tmp_path / "empty").peek()


def test_interrupted_count_leaves_its_last_commit_on_disk(tmp_path, monkeypatch):
    """With a slow writer (a loaded host) the cursor of step 4 is still on
    its thread when step 5 fails: the re-raised interrupt joins it first, so
    a fresh reader of the root finds step 4."""
    import time

    from repro_torch.checkpoint import store

    save = store.save_checkpoint

    def slow_save(*args, **kwargs):
        time.sleep(0.3)
        return save(*args, **kwargs)

    monkeypatch.setattr(store, "save_checkpoint", slow_save)
    _, _, psb, pwl, _ = _fixture()
    cfg = pt_dist.ResilienceConfig(checkpoint_dir=tmp_path, checkpoint_every=2,
                                   injector=pt_runtime.FailureInjector(fail_at_steps=(5,)),
                                   lose_devices=0, max_failures=0)
    with pytest.raises(pt_runtime.CountInterrupted):
        pt_dist.resilient_tc_count(psb, pwl, _mesh((2, 2)), cfg, chunk_pairs=CHUNK)
    assert pt_dist.TCCheckpoint(tmp_path).load_latest().committed_step == 4


def test_snapshot_and_cursor_files_match_reference(tmp_path):
    """save_snapshot / save_cursor of one plan in both packages: the same
    manifest leaves (paths, shapes, dtypes), extras and leaf bytes."""
    sb, wl, psb, pwl, _ = _fixture()
    plan = jx_core.plan_execution(sb, wl, jx_core.DeviceTopology(num_devices=4),
                                  placement="sharded_2d", grid=(2, 2), chunk_pairs=CHUNK)
    pplan = pt_core.plan_execution(psb, pwl, pt_core.DeviceTopology(num_devices=4),
                                   placement="sharded_2d", grid=(2, 2), chunk_pairs=CHUNK)
    for pkg, s, p in ((jx_dist, sb, plan), (pt_dist, psb, pplan)):
        ck = pkg.TCCheckpoint(tmp_path / pkg.__name__)
        ck.save_snapshot(s, p, attempt=0, base_total=7, schedule="lockstep")
        ck.wait()
        ck.save_snapshot(s, p, attempt=0, base_total=9)  # already durable: a no-op
        ck.save_cursor(1, 4, (1, 2, 3, 4), 99, p)
        ck.wait()
    roots = [tmp_path / pkg.__name__ for pkg in (jx_dist, pt_dist)]
    for sub in ("stores/step_00000000", "cursor/step_01000004"):
        mans = [json.loads((r / sub / "manifest.json").read_text()) for r in roots]
        assert mans[0]["extra"] == mans[1]["extra"] and mans[0]["step"] == mans[1]["step"]
        assert mans[0]["leaves"] == mans[1]["leaves"]
        for leaf in mans[0]["leaves"]:
            a, b = (np.load(r / sub / leaf["file"]) for r in roots)
            assert a.dtype == b.dtype and np.array_equal(a, b), leaf["path"]
    assert json.loads((roots[1] / "stores/step_00000000/manifest.json").read_text())["extra"][
        "base_total"] == 7


def test_resilience_config_and_tcim_routing(tmp_path):
    """blast_radius and for_request as the reference's; tcim_count_graph
    with resilience= on a (2, 2) mesh recovers and reports; the refusals."""
    for mod in (pt_dist, jx_dist):
        cfg = mod.ResilienceConfig(tmp_path, lose_devices=(4, 2, 1))
        assert [cfg.blast_radius(k) for k in (1, 2, 3, 4, 9)] == [4, 2, 1, 1, 1]
        assert mod.ResilienceConfig(tmp_path, lose_devices=2).blast_radius(5) == 2
        assert mod.ResilienceConfig(tmp_path, lose_devices=()).blast_radius(1) == 0
        assert Path(cfg.for_request(3).checkpoint_dir) == tmp_path / "req_3"
    from repro_torch.graphs import build_graph as pt_build_graph

    g = pt_build_graph(rmat(**GRAPH), reorder=True)
    _, _, _, _, want = _fixture()
    cfg = pt_dist.ResilienceConfig(checkpoint_dir=tmp_path / "count", checkpoint_every=2,
                                   injector=pt_runtime.FailureInjector(fail_at_steps=(3,)),
                                   lose_devices=1)
    res = pt_core.tcim_count_graph(g, mesh=_mesh((2, 2)), resilience=cfg, chunk_pairs=CHUNK,
                                   collect_stats=False, async_=True).result()
    assert res.triangles == want and res.stats["placement"] == "sharded_2d"
    assert res.stats["recovery"]["attempts"] == 2 and res.stats["recovery"]["grid"] == [3, 1]
    with pytest.raises(ValueError, match="2-axis mesh"):
        pt_core.tcim_count_graph(g, resilience=cfg, device="cpu")
    with pytest.raises(ValueError, match="sharded_2d"):
        pt_core.tcim_count_graph(g, mesh=_mesh((2, 2)), placement="replicated", resilience=cfg)
    with pytest.raises(ValueError, match="2-axis mesh"):
        pt_dist.resilient_tc_count(*_fixture()[2:4], pt_dist.make_mesh((4,), ("d",), devices=CPU),
                                   cfg)
