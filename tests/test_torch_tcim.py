"""Port vs reference: the executor, the planner and the entry point.

The port's ``Executor`` fed the JAX package's own SBF and worklist (carried
across with ``sbf_from_arrays``/``worklist_from_arrays``) must equal
``repro.core.Executor(...).count``; ``repro_torch.core.tcim_count(edges,
device="cpu")`` must equal ``repro.core.tcim_count(edges, build="host")``
and the exact oracle on every ``GRAPHS`` config x slice_bits {32, 64, 128}.
Counts are exact integers, so every comparison is equality. Also: the
import hygiene of the port and the absence of a silent CPU fallback.
"""
import functools
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (both packages in one process, JAX on the CPU)
import numpy as np  # noqa: E402

import repro.core as jx_core  # noqa: E402
import repro.core.plan as jx_plan  # noqa: E402
from repro.configs.tcim_graphs import GRAPHS  # noqa: E402
from repro.graphs import GRAPH_GENERATORS, build_graph, rmat  # noqa: E402
from repro.graphs.exact import triangles_intersection  # noqa: E402

import repro_torch.core as pt_core  # noqa: E402
import repro_torch.core.executor as pt_executor  # noqa: E402
import repro_torch.core.plan as pt_plan  # noqa: E402
from repro_torch.core.sbf import sbf_from_arrays, worklist_from_arrays  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def _scaled(name: str):
    # com-livejournal at 0.02 would cost the JAX side more than the rest of
    # the sweep together.
    return GRAPHS[name].scaled(0.005 if name == "com-livejournal" else 0.02)


@functools.lru_cache(maxsize=None)
def _edges(name: str) -> np.ndarray:
    cfg = _scaled(name)
    gen = GRAPH_GENERATORS[cfg.generator]
    if cfg.generator == "grid_road":
        return gen(cfg.n, seed=cfg.seed)
    return gen(cfg.n, cfg.m, seed=cfg.seed)


@functools.lru_cache(maxsize=None)
def _exact(name: str) -> int:
    return triangles_intersection(build_graph(_edges(name), reorder=True))


@functools.lru_cache(maxsize=None)
def _jax_state(slice_bits: int):
    """The JAX package's SBF + worklist of one mid-size graph, and its count."""
    g = build_graph(rmat(3000, 24000, seed=5), reorder=True)
    sb = jx_core.build_sbf(g, slice_bits)
    wl = jx_core.build_worklist(g, sb)
    return sb, wl, jx_core.Executor(sb).count(wl)


@pytest.mark.parametrize("slice_bits", [32, 64, 128])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_tcim_count_matches_reference_and_oracle(name, slice_bits):
    edges = _edges(name)
    got = pt_core.tcim_count(edges, slice_bits=slice_bits, device="cpu")
    want = jx_core.tcim_count(edges, slice_bits=slice_bits, build="host")
    assert got.triangles == want.triangles == _exact(name)
    assert got.stats["build"] == "host" and got.stats["placement"] == "replicated"
    assert got.stats["num_pairs"] == want.stats["num_pairs"]
    assert set(got.timings_s) == {"orient", "compress", "schedule", "plan", "execute"}


@pytest.mark.parametrize("reorder", [False, True])
def test_tcim_count_reorder_both_ways(reorder):
    edges = _edges("email-enron")
    got = pt_core.tcim_count(edges, reorder=reorder, device="cpu").triangles
    want = jx_core.tcim_count(edges, reorder=reorder, build="host").triangles
    assert got == want == _exact("email-enron")


@pytest.mark.parametrize(
    "chunk_pairs,mode,double_buffer",
    [
        (1 << 20, "fused", True),  # one chunk
        (256, "fused", True),  # many chunks + a ragged pow2 tail
        (1000, "fused", False),  # rounded down to 512, serial staging
        (256, "jnp", True),  # the byte-table oracle mode
        (256, "gather_then_kernel", True),  # torch gather + the total kernel
        (256, "pallas_items", True),  # torch gather + the items kernel
    ],
)
@pytest.mark.parametrize("slice_bits", [32, 128])
def test_executor_on_carried_state_matches_reference(slice_bits, chunk_pairs, mode, double_buffer):
    sb, wl, want = _jax_state(slice_bits)
    ex = pt_core.Executor(
        sbf_from_arrays(sb), mode=mode, chunk_pairs=chunk_pairs, device="cpu",
        double_buffer=double_buffer,
    )
    assert ex.chunk_pairs == jx_plan.clamp_chunk_pairs(chunk_pairs, sb.words_per_slice)
    assert wl.num_pairs % ex.chunk_pairs  # the last chunk is ragged
    carried = worklist_from_arrays(wl)
    assert ex.count(carried) == want
    fut = ex.count_async(carried)
    assert fut.result() == want and fut.result() == want
    assert ex.row_data.shape[0] == pt_plan.pow2_ceil(len(sb.row_slice_idx))
    assert ex.row_data.dtype == torch.int32


def test_executor_per_chunk_escape(monkeypatch):
    """Past the int32 worst case the executor keeps one total per chunk and
    sums them exactly on the host at the close — still one transfer."""
    sb, wl, want = _jax_state(64)
    monkeypatch.setattr(pt_executor, "_INT32_MAX", 1000)
    ex = pt_core.Executor(sbf_from_arrays(sb), chunk_pairs=512, device="cpu")
    fut = ex.count_async(worklist_from_arrays(wl))
    assert len(fut._totals) == -(-wl.num_pairs // 512)
    assert fut.result() == want


def test_executor_empty_and_mode_validation():
    sb, wl, _ = _jax_state(64)
    ex = pt_core.Executor(sbf_from_arrays(sb), device="cpu")
    assert ex.execute_indices(np.zeros(0, np.int64), np.zeros(0, np.int64)) == 0
    with pytest.raises(ValueError):
        ex.execute_indices(np.zeros(3, np.int64), np.zeros(2, np.int64))
    with pytest.raises(ValueError):
        pt_core.Executor(sbf_from_arrays(sb), mode="nope", device="cpu")
    for mode in pt_core.EXECUTOR_MODES:  # every mode is ported; empty counts 0
        unfused = pt_core.Executor(sbf_from_arrays(sb), mode=mode, device="cpu")
        assert unfused.execute_indices(np.zeros(0, np.int64), np.zeros(0, np.int64)) == 0
    assert pt_core.EXECUTOR_MODES == jx_core.EXECUTOR_MODES
    assert ex.modeled_hbm_bytes(wl.num_pairs) == jx_core.Executor(sb).modeled_hbm_bytes(
        wl.num_pairs
    )


def test_executor_pool_hits_by_content_and_evicts():
    pool = pt_core.ExecutorPool(max_graphs=2)
    sb, wl, want = _jax_state(64)
    a, b = sbf_from_arrays(sb), sbf_from_arrays(sb)  # equal content, two objects
    carried = worklist_from_arrays(wl)
    assert pool.count(a, carried, device="cpu") == want
    assert pool.count(b, carried, device="cpu") == want
    assert pool.stats() == {
        "graphs": 1, "hits": 1, "misses": 1, "trace_groups": 1, "max_group": 1,
    }
    assert pool.get(a, device="cpu") is pool.get(b, device="cpu")
    for bits in (32, 128):
        pool.get(sbf_from_arrays(_jax_state(bits)[0]), device="cpu")
    assert len(pool) == 2
    pool.clear()
    assert len(pool) == 0


def test_plan_matches_reference_for_replicated():
    sb, wl, _ = _jax_state(64)
    got = pt_plan.plan_execution(
        sbf_from_arrays(sb), worklist_from_arrays(wl), pt_plan.DeviceTopology(num_devices=1),
        chunk_pairs=3000,
    )
    want = jx_plan.plan_execution(sb, wl, jx_plan.DeviceTopology(num_devices=1), chunk_pairs=3000)
    assert (got.placement, got.num_shards, got.chunk_pairs, got.words_per_slice) == (
        want.placement, want.num_shards, want.chunk_pairs, want.words_per_slice,
    )
    (s_got,), (s_want,) = got.stripes, want.stripes
    assert np.array_equal(s_got.row_pos, s_want.row_pos)
    assert np.array_equal(s_got.col_pos, s_want.col_pos)
    assert got.total_pairs == wl.num_pairs and got.imbalance == 1.0
    # The sharded placements plan too (their parity: tests/test_torch_plan.py);
    # sharded_2d needs a grid, as in the reference.
    one = pt_plan.DeviceTopology(num_devices=1)
    cols = pt_plan.plan_execution(
        sbf_from_arrays(sb), worklist_from_arrays(wl), one, placement="sharded_cols"
    )
    assert cols.placement == "sharded_cols" and cols.total_pairs == wl.num_pairs
    for mod, sbf_, wl_ in ((pt_plan, sbf_from_arrays(sb), worklist_from_arrays(wl)),
                           (jx_plan, sb, wl)):
        with pytest.raises(ValueError, match="grid"):
            mod.plan_execution(sbf_, wl_, mod.DeviceTopology(num_devices=1),
                               placement="sharded_2d")
    with pytest.raises(ValueError):
        pt_plan.plan_execution(sbf_from_arrays(sb), worklist_from_arrays(wl), placement="x")
    assert pt_plan.DeviceTopology.detect().num_devices >= 1


def test_chunk_helpers_match_reference():
    for x in (0, 1, 2, 3, 1000, 1 << 20, (1 << 20) + 1):
        assert pt_plan.pow2_ceil(x) == jx_plan.pow2_ceil(x)
        for w in (1, 2, 4):
            if x >= 1:
                assert pt_plan.clamp_chunk_pairs(x, w) == jx_plan.clamp_chunk_pairs(x, w)
    with pytest.raises(ValueError):
        pt_plan.clamp_chunk_pairs(0, 2)
    assert pt_core.SCHEDULES == jx_core.SCHEDULES and pt_core.PLACEMENTS == jx_core.PLACEMENTS


def test_async_and_graph_entry_points():
    edges = _edges("ego-facebook")
    fut = pt_core.tcim_count(edges, device="cpu", async_=True)
    assert isinstance(fut, pt_core.TCFuture)
    res = fut.result()
    assert res.triangles == _exact("ego-facebook") and "close" in res.timings_s
    g = build_graph(edges, reorder=True)
    from repro_torch.graphs import build_graph as pt_build_graph

    got = pt_core.tcim_count_graph(pt_build_graph(edges, reorder=True), device="cpu")
    assert got.triangles == jx_core.tcim_count_graph(g, build="host").triangles
    assert pt_core.tcim_count(np.zeros((0, 2), np.int64), device="cpu").triangles == 0


def test_unported_options_raise_naming_the_roadmap():
    edges = _edges("ego-facebook")
    assert pt_core.BACKENDS == jx_core.BACKENDS
    # mesh= and resilience= are ported: a mesh must be the port's Mesh, and
    # resilience needs a 2-axis one (the reference's ValueError).
    with pytest.raises(TypeError, match="Mesh"):
        pt_core.tcim_count(edges, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="2-axis mesh"):
        pt_core.tcim_count(edges, device="cpu", resilience=object())
    for kwargs in ({"backend": "x"}, {"schedule": "x"}, {"build": "x"}, {"placement": "x"}):
        with pytest.raises(ValueError):
            pt_core.tcim_count(edges, device="cpu", **kwargs)


def test_dense_backend_with_device_build_matches_reference():
    """A dense backend takes the host path under build='device', as the
    reference does (tests/test_build.py::test_build_argument_validation)."""
    edges = np.array([[0, 1], [0, 2], [1, 2]], dtype=np.int64)
    got = pt_core.tcim_count(edges, backend="mxu", build="device", device="cpu")
    want = jx_core.tcim_count(edges, backend="mxu", build="device")
    assert got.triangles == want.triangles == 1
    assert got.stats == want.stats


def test_no_silent_cpu_fallback(monkeypatch):
    """Without a card, the default device raises instead of running on the
    host; only an explicit device='cpu' runs the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    edges = _edges("ego-facebook")
    with pytest.raises(RuntimeError, match="cuda"):
        pt_core.tcim_count(edges)
    with pytest.raises(RuntimeError, match="cuda"):
        pt_core.Executor(sbf_from_arrays(_jax_state(64)[0]))
    assert pt_core.tcim_count(edges, device="cpu").triangles == _exact("ego-facebook")


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.ops\n"
        "import repro_torch.data, repro_torch.configs\n"
        "import repro_torch.launch.tc_serve, repro_torch.runtime.fault\n"
        "import repro_torch.kernels.slice_and_popcount\n"
        "import repro_torch.kernels.tc_bitgemm, repro_torch.kernels.tc_dense_mxu\n"
        "import repro_torch.kernels.ref, repro_torch.core.metrics\n"
        "import repro_torch.core.baselines, repro_torch.core.cachesim\n"
        "import repro_torch.core.energymodel\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env={"PYTHONPATH": str(SRC), "PATH": ""},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
