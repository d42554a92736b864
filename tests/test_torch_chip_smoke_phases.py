"""A rehearsal on the CPU of chip_smoke.py's phases 18c, 20 (hubert's runs), 21b, 21d and 22.

``chip_smoke.py`` drives the port on one card. Here a copy of it runs on the
host (``"cuda"`` read as ``"cpu"``, ``.cuda()`` as ``.cpu()``, the
``torch.cuda`` sync and memory calls stubbed, ``resolve_device(None)`` the
CPU), so that the new phases' logic (what they build, count, hold to what,
and check) runs before a card does:

  * 18c, the families' training: every family's smoke widths at the full
    configs' dtype and remat (the float32 gradients at the phase's depth
    cuts, the loops at 4 layers), each ``TrainLoop`` with its counted bound
    on meta tensors (the "cpu-paths" host child's file, written here), the
    float32 gradients "card" (the CPU path again) against the CPU path
    beside the MoE resume, whose child process runs in this one (its
    ``subprocess.run`` replaced; the deterministic children of phases 18
    and 20, which share the window, are not rehearsed here);
  * 22, com-livejournal: the config scaled to 0.004 stands in for the full
    graph (and com-youtube x0.01 for phase 4's, whose exact count the host
    child makes first), the device build's limit is patched from 2**30 to
    2**19, so
    that the stand-in is refused at 64 and 128 bits as the full graph is on
    the card, and the phase's own scaled graph (x0.5: 455,806 candidates)
    fills the largest bucket; the host child runs in this process (its
    full-graph half forked from it, NumPy only),
    ``build="auto"`` is handed the card's device, and ``gather_total``
    launches are counted through a fake over its plain version;
  * 21b, bf16 serving on a mesh on the gathered path: minicpm3 at smoke
    widths and depth pinned to the "dp" profile on a 2 x 2 mesh, held by
    its bound and the planted lost cache shard;
  * 21d, tensor-parallel serving: deepseek-67b's, qwen1.5-110b's,
    moonshot-v1-16b-a3b's, dbrx-132b's, llama-3.2-vision-90b's,
    mamba2-780m's, zamba2-7b's and minicpm3-4b's (MLA, under "xla") smoke
    widths pinned to the "tp" profile
    (the MoE at the production capacity factor, so that tokens are dropped;
    the VLM at its full config's group size, 4 self and 1 cross layer;
    zamba2 at its full config's, the shared block after every 6 mamba
    layers) at the phase's depth cuts and shapes, and hubert-xlarge's
    prefill step and full-frame logits (4 x 64 frames), on a 2 x 2 mesh of
    logical CPU shards, flash launches counted through a fake over its
    plain version;
  * 20, hubert-xlarge's tensor-parallel train step: its smoke widths
    pinned "tp", the float32 gradients beside smollm's and mamba2's and
    the bf16 ``TrainLoop`` against its one-device loop.

The shapes and step counts are cut (constants of the copy), and the loss's
bar is what smoke widths reach in 12 steps. Nothing here compares with the
JAX package: the phases hold the port to itself and to the exact oracle.
"""
import contextlib
import importlib.util
import io
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.configs as pt_configs  # noqa: E402
import repro_torch.core.build as pt_build  # noqa: E402
import repro_torch.core.executor as pt_executor  # noqa: E402
import repro_torch.core.tcim as pt_tcim  # noqa: E402
import repro_torch.graphs.csr as pt_csr  # noqa: E402
import repro_torch.kernels.common as pt_common  # noqa: E402
import repro_torch.kernels.ops as pt_ops  # noqa: E402
import repro_torch.kernels.tc_gather_popcount as pt_tgp  # noqa: E402
import repro_torch.launch.train as pt_train  # noqa: E402
import repro_torch.models.model as pt_model  # noqa: E402
from repro_torch.core.sbf import (  # noqa: E402
    build_sbf,
    build_worklist,
    sbf_from_arrays,
    worklist_from_arrays,
)
from repro_torch.graphs import build_graph, rmat, triangles_intersection  # noqa: E402
from repro_torch.distributed.lm_sharding import train_state_specs  # noqa: E402
from repro_torch.distributed.sharding import named_tree  # noqa: E402
from repro_torch.distributed.tensor_parallel import model_dim  # noqa: E402
from repro_torch.kernels.tc_gather_popcount import gather_total_reference  # noqa: E402
from repro_torch.launch.specs import params_struct  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# minicpm3's smoke config at 62 layers in bf16, tensor-parallel on 2 x 2,
# against one device (decode max, relative norm; the CPU, this rehearsal's
# weights and prompts): what its rehearsal bound is set from, as the card's
# is from tools/tp_drift.py's reading.
SMOKE_MLA_BF16_DRIFT = 0.03275


def _cpu(device=None):
    return torch.device("cpu") if device is None else torch.device(device)


@pytest.fixture
def smoke(tmp_path, monkeypatch):
    """The CPU copy of chip_smoke.py, imported, with the card's calls stubbed."""
    text = (ROOT / "chip_smoke.py").read_text()
    for a, b in ((".cuda()", ".cpu()"), (".is_cuda", ".is_cpu"), ('"cuda"', '"cpu"')):
        text = text.replace(a, b)
    path = tmp_path / "chip_smoke_cpu.py"
    path.write_text(text)
    spec = importlib.util.spec_from_file_location("chip_smoke_cpu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated", "max_memory_reserved",
                 "memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(mod, "_expandable_segments", contextlib.nullcontext)  # the card's allocator
    for module in (pt_common, pt_csr, pt_model, pt_tcim, pt_executor, pt_build, pt_train):
        monkeypatch.setattr(module, "resolve_device", _cpu)
    monkeypatch.setattr(mod, "nvidia_smi_line", lambda: "CPU rehearsal, no card")
    monkeypatch.setattr(mod.os, "nice", lambda inc: 0)  # a host child's; not this process's
    monkeypatch.setattr(mod, "_background", lambda: "rehearsal")
    # Smoke widths on one torch thread: their ops are too small to share,
    # and under the suite's parallel workers many threads a process contend.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield mod
    torch.set_num_threads(threads)


def test_families_train_phase_runs_on_the_host(smoke, monkeypatch, tmp_path):
    real = pt_configs.get_config

    def narrow(arch):
        full = real(arch)
        return pt_configs.get_smoke_config(arch).scaled(
            n_layers=full.n_layers, dtype=full.dtype, remat=full.remat,
            attention_impl=full.attention_impl)

    monkeypatch.setattr(pt_configs, "get_config", narrow)
    for name, value in (("TRAIN_GRAD_SHAPE", (2, 16)), ("FAMILY_TRAIN_BATCH", 2),
                        ("FAMILY_TRAIN_SEQ", 64), ("FAMILY_TRAIN_STEPS", 12),
                        ("FAMILY_TRAIN_WARM", 2), ("TRAIN_SCHEDULE", {"warmup": 2, "total": 50}),
                        ("TRAIN_MIN_DROP", 0.05),
                        ("FAMILY_RESUME_SHAPE", (2, 16)), ("FAMILY_RESUME_STEPS", 12),
                        ("FAMILY_RESUME_EVERY", 5), ("FAMILY_RESUME_FAIL_AT", (7,)),
                        ("FAMILY_TRAIN_LOOPS", tuple((a, 4) for a, _ in smoke.FAMILY_TRAIN_LOOPS))):
        monkeypatch.setattr(smoke, name, value)
    profiled = []
    monkeypatch.setattr(smoke, "_profile_train_step",
                        lambda loop, params, opt, tag="": profiled.append(tag))
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.setattr(torch, "use_deterministic_algorithms", lambda *a, **k: None)

    def run(args, **kwargs):  # the resume child, in this process
        assert args[-1] == smoke.FAMILY_RESUME_FLAG
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = smoke._family_resume_child()
        return subprocess.CompletedProcess(args, rc, out.getvalue(), "")

    monkeypatch.setattr(smoke, "subprocess", types.SimpleNamespace(run=run))
    window = []  # phases 18's and 20's deterministic children: the window's, not rehearsed
    monkeypatch.setattr(smoke, "_train_resume", lambda: window.append("train"))
    monkeypatch.setattr(smoke, "_sharded_resume", lambda: window.append("sharded"))
    smoke._write_json(tmp_path / "costs.json", {  # what the "cpu-paths" host child leaves
        arch: smoke._family_counted(smoke._family_loop_cfg(arch, depth)[1])
        for arch, depth in smoke.FAMILY_TRAIN_LOOPS})
    logged = []
    monkeypatch.setattr(smoke, "log", logged.append)
    loops = smoke.phase_families_train((_Done(), tmp_path, 0.0), (_Done(), tmp_path, 0.0))
    assert sorted(window) == ["sharded", "train"]
    assert sum("host children have exited" in m for m in logged) == 1
    assert sorted(loops) == sorted(a for a, _ in smoke.FAMILY_TRAIN_LOOPS)
    for arch, run_ in loops.items():
        first, _, tail = run_["losses"]
        assert first - tail >= 0.05 and 0 < run_["share"] <= 1.0, (arch, run_)
    assert len(profiled) == len(loops)
    grads = [m for m in logged if "card vs CPU" in m]
    assert len(grads) == len(smoke.FAMILY_TRAIN_GRADS) + 1  # the MoE under "dots" too
    assert any("moe_dropped_frac" in m for m in grads)
    assert any("every logged (step, loss, dropped fraction)" in m for m in logged)


def _card_counts(monkeypatch):
    """Counts as on the card: "auto" takes the device build, and the fused
    path's gather_total launches are counted through a fake over its plain
    version."""
    resolve = pt_tcim._resolve_build
    monkeypatch.setattr(pt_tcim, "_resolve_build",
                        lambda build, backend, m, device: resolve(build, backend, m,
                                                                  torch.device("cuda")))
    real = pt_tgp.gather_total_cuda

    def counted(row, col, ridx, cidx, out):
        real.launches += 1
        out += gather_total_reference(row, col, ridx, cidx)
        return out

    monkeypatch.setattr(pt_ops, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(pt_ops, "gather_total_cuda", counted)
    monkeypatch.setattr(real, "launches", 0)


class _Done:
    """A child process that has already exited 0."""

    def poll(self):
        return 0

    def wait(self, timeout=None):
        return 0


def test_livejournal_phase_runs_on_the_host(smoke, monkeypatch, tmp_path):
    graphs = pt_configs.GRAPHS
    monkeypatch.setitem(graphs, "com-livejournal", graphs["com-livejournal"].scaled(0.004))
    monkeypatch.setitem(graphs, "com-youtube", graphs["com-youtube"].scaled(0.01))
    monkeypatch.setattr(pt_build, "_CAND_GUARD", 1 << 19)
    monkeypatch.setattr(smoke, "LJ_ORACLE_WORKERS", 1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert smoke._host_child("oracles", tmp_path) == 0
    (tmp_path / "child.log").write_text(out.getvalue())
    main = smoke._child_result((_Done(), tmp_path, 0.0), "main.json", 1)
    yt = graphs["com-youtube"]
    want = triangles_intersection(build_graph(rmat(yt.n, yt.m, seed=yt.seed), reorder=True))
    assert main["exact"] == want and main["m"] == len(rmat(yt.n, yt.m, seed=yt.seed))
    _card_counts(monkeypatch)
    logged = []
    monkeypatch.setattr(smoke, "log", logged.append)
    out = smoke.phase_livejournal((_Done(), tmp_path, time.perf_counter()))
    assert set(out["full"]) == {64, 128}
    assert all(v["candidates"] > 1 << 19 for v in out["full"].values())
    assert out["candidates"] == 455_806 and out["launches"] >= 1
    scaled = np.load(tmp_path / "scaled.npy")
    assert out["pairs"] > 0 and len(scaled) == 69_362
    assert sum("ValueError after" in m for m in logged) == 2
    assert sum("== triangles_intersection" in m for m in logged) == 2


def test_main_phase_takes_the_host_childrens_counts(smoke, monkeypatch, tmp_path):
    """Phase 4 with its CPU path and oracle from the two host children
    (run here, in this process, on com-youtube x0.01), as main() runs it;
    what the "cpu-paths" child leaves for phases 4b (the host build), 9
    (the dense backends' CPU paths) and 18c (the counted train steps)."""
    graphs = pt_configs.GRAPHS
    monkeypatch.setitem(graphs, "com-youtube", graphs["com-youtube"].scaled(0.01))
    monkeypatch.setitem(graphs, "ego-facebook", graphs["ego-facebook"].scaled(0.25))
    monkeypatch.setattr(smoke, "SMALL_GRAPHS", ("ego-facebook",))
    monkeypatch.setattr(smoke, "LJ_GRAPH", "ego-facebook")  # a small stand-in after the oracle
    monkeypatch.setattr(smoke, "LJ_ORACLE_WORKERS", 1)
    monkeypatch.setattr(smoke, "FAMILY_TRAIN_LOOPS", (("hubert-xlarge", 2),))
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    oracles, cpu_paths = tmp_path / "oracles", tmp_path / "cpu"
    for kind, work in (("oracles", oracles), ("cpu-paths", cpu_paths)):
        work.mkdir()
        with contextlib.redirect_stdout(io.StringIO()):
            assert smoke._host_child(kind, work) == 0
    dense = smoke._child_result((_Done(), cpu_paths, 0.0), "dense.json", 1)
    fb = graphs["ego-facebook"]
    want = triangles_intersection(build_graph(rmat(fb.n, fb.m, seed=fb.seed), reorder=True))
    assert {b: v["triangles"] for b, v in dense.items()} == {"bitgemm": want, "mxu": want}
    yt = graphs["com-youtube"]
    g = build_graph(rmat(yt.n, yt.m, seed=yt.seed), reorder=True)
    sb = build_sbf(g, smoke.MAIN_SLICE_BITS)
    wl = build_worklist(g, sb)
    with np.load(cpu_paths / "host_build.npz") as arrays:  # phase 4b's host build
        got_sb, got_wl = sbf_from_arrays(arrays), worklist_from_arrays(arrays)
    for f in smoke.HOST_SBF_FIELDS:
        assert np.array_equal(getattr(got_sb, f), getattr(sb, f)), f
    for f in smoke.HOST_WORKLIST_FIELDS:
        assert np.array_equal(getattr(got_wl, f), getattr(wl, f)), f
    costs = smoke._child_result((_Done(), cpu_paths, 0.0), "costs.json", 1)
    hubert = smoke._family_counted(smoke._family_loop_cfg("hubert-xlarge", 2)[1])
    assert costs == {"hubert-xlarge": hubert} and 0 < hubert["bound_s"]
    _card_counts(monkeypatch)
    logged = []
    monkeypatch.setattr(smoke, "log", logged.append)
    main = smoke.phase_main((_Done(), oracles, 0.0), (_Done(), cpu_paths, 0.0))
    assert main["launches"] >= 1 and main["exact"] == main["result"].triangles
    assert any("port CPU path (in the host child)" in m for m in logged)
    assert any("in the host child): " in m and "exact oracle" in m for m in logged)


def test_tensor_parallel_serve_phase_runs_on_the_host(smoke, monkeypatch):
    import repro_torch.launch.serve as pt_serve
    from repro_torch.kernels import flash_attention as pt_flash
    from repro_torch.models import layers as pt_layers

    real_config = pt_configs.get_config

    def narrow(arch):
        full = real_config(arch)
        return pt_configs.get_smoke_config(arch).scaled(
            parallelism="tp", moe_capacity_factor=full.moe_capacity_factor,
            cross_attn_every=full.cross_attn_every, hybrid_attn_every=full.hybrid_attn_every)

    def share(cfg) -> float:
        """What a position's blocks come to of the whole tree on 2 x 2:
        the leaves with a 'model' dim halved, the others whole."""
        mesh = smoke._logical_mesh(smoke.SERVE_TP_MESH)
        leaves = tree_leaves(params_struct(cfg))
        specs = tree_leaves(named_tree(mesh, train_state_specs(cfg)[0]))
        whole = sum(t.numel() for t in leaves)
        return sum(t.numel() // (1 if model_dim(sh.spec, t.ndim) is None else 2)
                   for t, sh in zip(leaves, specs)) / whole

    monkeypatch.setattr(pt_configs, "get_config", narrow)
    monkeypatch.setattr(pt_serve, "get_config", narrow)
    monkeypatch.setattr(pt_serve, "resolve_device", _cpu)
    monkeypatch.setattr(smoke, "SHARD_DEVICE", "cpu")
    # The bf16 bounds of the card's full-width runs (dbrx's near-uniform
    # router: 0.51) are wider than smoke widths need: hold the default, but
    # minicpm3's at 62 layers: 1.5 x its reading at smoke widths
    monkeypatch.setattr(smoke, "SERVE_TP_BF16_TOL", {"minicpm3-4b": 1.5 * SMOKE_MLA_BF16_DRIFT})
    # MLA's whole latent projections weigh 11 % of the smoke config's
    # parameters (4 % of the full config's): its blocks come to more of the
    # tree than the card's 0.55 (0.52 there); each run's ratio is held to
    # its config's below
    shares = {(a, n): share(narrow(a).scaled(n_layers=n)) for a, n, _ in smoke.SERVE_TP_RUNS}
    monkeypatch.setattr(smoke, "SERVE_TP_BYTES_SHARE", max(0.55, max(shares.values()) + 1e-3))
    monkeypatch.setattr(smoke, "SERVE_TP_F32_MARGIN", {})
    real = pt_layers.flash_attention_bshd

    def counted(*args, **kwargs):
        pt_flash.flash_attention_cuda.launches += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(pt_layers, "flash_attention_bshd", counted)

    def kernel(q, k, v, qp, kp, causal, tiles):  # the plain version, scoring the rule's tiles
        tiles += pt_flash.flash_tiles_scored(qp, kp, q.shape[2], *pt_flash.FLASH_TILES[q.dtype],
                                             causal=causal)
        return pt_flash.flash_attention_bshd_reference(q, k, v, qp, kp, causal=causal)

    monkeypatch.setattr(pt_flash, "flash_attention_bshd_cuda", kernel)
    monkeypatch.setattr(smoke, "AUDIO_TP_SHAPE", (4, 64))
    logged = []
    monkeypatch.setattr(smoke, "log", logged.append)
    flash = smoke.phase_tensor_parallel_serve()
    # attention layers x 2 data shards x 2 model shards a prefill: the
    # hybrid's shared block once a group, the SSM's none, MLA's none ("xla")
    attention = {"ssm": lambda n: 0, "hybrid": lambda n: n // 6}
    assert flash == {f"tensor_parallel_serve:{a}:{d}":
                     0 if narrow(a).attention == "mla"
                     else attention.get(narrow(a).family, lambda n: n)(n) * 4
                     for a, n, d in smoke.SERVE_TP_RUNS}
    assert {a for a, _, _ in smoke.SERVE_TP_RUNS} >= {"minicpm3-4b", "hubert-xlarge"}
    audio = [r for r in smoke.SERVE_TP_RUNS if narrow(r[0]).family == "audio"]
    decoders = [r for r in smoke.SERVE_TP_RUNS if r not in audio]
    # the audio encoder's runs: its prefill step and full-frame logits
    heard = [m for m in logged if "the prefill step on 4 x 64 frames" in m]
    assert len(heard) == len(audio) == 2
    for (arch, depth, dtype), m in zip(audio, heard):
        ratio = float(m.split(", ratio ")[1].split(";")[0])
        assert ratio == pytest.approx(shares[arch, depth], abs=1e-4) and ratio < 0.55, m
        assert f"flash launches prefill {depth * 4} ({depth} attention layers x 2 data shards " \
               f"x 2 model shards, each on 2 query and 2 KV heads, Sk 64, not causal" in m
        assert "self attention (B 2, Sq 64, Sk 64, not causal) max |err|" in m
        assert ("against a float32 run of the same weights" in m) == (dtype == "bfloat16")
        assert "refused by the same rule: a reduction dropping the last shard's partial" in m
        assert "a shard attending to its neighbour's K/V heads" in m
    runs = [m for m in logged if "teacher-forced on the one-device session's tokens" in m]
    assert len(runs) == len(decoders)
    for (arch, depth, dtype), m in zip(decoders, runs):
        cfg = narrow(arch)
        ssm, mla = cfg.family in ("ssm", "hybrid"), cfg.attention == "mla"
        heads = (f"each on {cfg.n_heads // 2} query and {max(cfg.n_kv_heads // 2, 1)} KV heads"
                 if cfg.n_heads else "no attention layer")
        if mla:
            heads = (f"{cfg.n_heads} MLA heads ({cfg.n_heads // 2} a shard; q/k "
                     f"{cfg.qk_nope_dim} + {cfg.qk_rope_dim}, v {cfg.v_head_dim}")
            assert "attention 'xla': MLA's values are narrower than its queries" in m
        # the SSM's replicated B/C projections and MLA's latent projections
        # stay whole
        ratio = float(m.split(", ratio ")[1].split(";")[0])
        assert heads in m and ratio == pytest.approx(shares[arch, depth], abs=1e-4), (arch, m)
        assert ssm or mla or f"{ratio:.2f}" == "0.50", (arch, m)
        assert ("from a copy of the one-device" in m) == (dtype == "float32")
        assert ("QKV biases drawn" in m) == cfg.qkv_bias
        assert "refused by the same rule: a reduction dropping the last shard's partial" in m
        assert ("self attention (B " in m and ", causal) max |err|" in m) == (
            bool(cfg.n_heads) and not mla)
        assert ("a shard receiving its neighbour's heads of the combined latent" in m) == mla
        assert ("a shard reading its neighbour's head block of the SSM state" in m) == ssm
        assert (f"{cfg.ssm_heads // 2} a shard" in m and "conv taps passing" in m) == ssm
        if cfg.family == "hybrid":  # two groups of 6 at 15 layers, one at 7
            assert f"{depth // 6} groups of 6 mamba layers and the shared block" in m
        assert ("a shard taking its neighbour's KV heads of the image K/V" in m) == (
            cfg.family == "vlm")
        if cfg.family == "vlm":  # two groups of 4 self and 1 cross layer at 10 layers, one at 5
            assert f"Sk {cfg.n_image_tokens}, not causal) max |err|" in m
            assert f"{depth // 5} groups of 4 self and 1 cross layer, cross gates 0.5" in m
        if cfg.family == "moe":
            assert "a shard running its neighbour's expert block" in m
            assert f"({cfg.n_experts // 2} a shard), capacity factor 1.25" in m
            assert "the prefill's dropped choices a layer" in m
            assert "choices routed to another expert than one device's" in m
            assert "layer 0's MoE on one" in m and "0 choices routed elsewhere" in m
            # moonshot's 8 smoke experts drop at 1.25 (dbrx's 4 need not)
            assert arch != "moonshot-v1-16b-a3b" or "dropped fraction 0.000000" not in m


def test_sharded_train_audio_runs_on_the_host(smoke, monkeypatch):
    """Phase 20's hubert runs at smoke widths pinned "tp" on a 2 x 2 mesh of
    logical CPU shards: the float32 gradients of the three archs at 2
    layers (hubert's on the tensor-parallel train step, held by 1e-5 and a
    planted neighbour's gradient refused), and the bf16 ``TrainLoop`` at
    12 layers against its one-device loop."""
    real_config = pt_configs.get_config

    def narrow(arch):
        cfg = pt_configs.get_smoke_config(arch)
        return cfg.scaled(parallelism="tp") if cfg.family == "audio" else cfg

    monkeypatch.setattr(pt_configs, "get_config", narrow)
    monkeypatch.setattr(pt_train, "get_config", narrow)
    monkeypatch.setattr(smoke, "SHARD_DEVICE", "cpu")
    monkeypatch.setattr(smoke, "SHARD_GRAD_SHAPE", (4, 32))
    monkeypatch.setattr(smoke, "SHARD_AUDIO_SHAPE", (4, 64))
    logged = []
    monkeypatch.setattr(smoke, "log", logged.append)
    smoke._sharded_audio("rehearsal")
    out = smoke._sharded_grads_f32()
    assert out["cfg"].name == "smollm-135m" and real_config("hubert-xlarge").n_heads == 16
    grads = [m for m in logged if "float32 (TF32 off)" in m]
    assert len(grads) == 3
    assert all(("tensor-parallel: each position's 'model' blocks" in m)
               == ("hubert-xlarge" in m) for m in grads)
    assert sum("reduced into its neighbour's model block, refused" in m for m in grads) == 1
    loops = [m for m in logged if "hubert-xlarge at full width (12 of 48 layers, bf16" in m]
    assert len(loops) == 2 and "(tensor-parallel train step)" in loops[1]
    assert "bytes of the 'model' blocks each position gathers and computes with" in loops[1]
    assert any("2 x 2 tensor-parallel vs one device: |loss difference|" in m for m in logged)


def test_sharded_families_serve_phase_runs_on_the_host(smoke, monkeypatch):
    """21b at minicpm3's smoke widths and depth on a 2 x 2 mesh of logical
    CPU shards, pinned to the "dp" profile, where it serves on the gathered
    path (``_mla_placed`` at decode): held by its bound, and a prefill whose
    last data shard's cache is lost refused by the same rule. It attends by
    "xla": no flash launch."""
    import repro_torch.launch.serve as pt_serve
    from repro_torch.kernels import flash_attention as pt_flash
    from repro_torch.models import layers as pt_layers

    real_config = pt_configs.get_config

    def narrow(arch):
        return pt_configs.get_smoke_config(arch).scaled(parallelism=real_config(arch).parallelism)

    monkeypatch.setattr(pt_configs, "get_config", narrow)
    monkeypatch.setattr(pt_serve, "get_config", narrow)
    monkeypatch.setattr(pt_serve, "resolve_device", _cpu)
    monkeypatch.setattr(smoke, "SHARD_DEVICE", "cpu")
    monkeypatch.setattr(smoke, "FAMILY_PROMPT", 64)
    real = pt_layers.flash_attention_bshd

    def counted(*args, **kwargs):
        pt_flash.flash_attention_cuda.launches += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(pt_layers, "flash_attention_bshd", counted)
    placed = []
    real_mla = pt_model._mla_placed

    def spy(*args, **kwargs):
        placed.append(1)
        return real_mla(*args, **kwargs)

    monkeypatch.setattr(pt_model, "_mla_placed", spy)
    logged = []
    monkeypatch.setattr(smoke, "log", logged.append)
    flash = smoke._sharded_families_serve(smoke._logical_mesh(smoke.SERVE_SHARD_MESH), "rehearsal")
    assert flash == {} and placed
    runs = [m for m in logged if "teacher-forced on the one-device session's tokens" in m]
    assert len(runs) == len(smoke.SERVE_SHARD_FAMILIES) == 1
    for (arch, _), m in zip(smoke.SERVE_SHARD_FAMILIES, runs):
        assert f"profile {smoke.SERVE_SHARD_PROFILE[arch]!r}, the gathered path" in m, arch
        assert f"(bound {smoke.SERVE_SHARD_BF16_TOL[arch]:.6f})" in m, arch
        assert "in 4 prefill shards" in m, arch  # "dp": the batch over 'data' and 'model'
        assert "last data shard's cache is lost, refused by the same rule" in m, arch


@pytest.mark.parametrize("workers", [2, 3])
def test_oracle_workers_count_the_same(workers):
    """``tools/livejournal_count.py::triangles_forked``: the edges split
    over forked processes give ``triangles_intersection``'s one-process
    count. Forked from a fresh process (as phase 22's host child and the
    tool fork, before any torch op starts a thread), not from this one."""
    g = build_graph(rmat(3000, 24000, seed=8), reorder=True)
    code = ("from tools.livejournal_count import triangles_forked; "
            "from repro_torch.graphs import build_graph, rmat; "
            "g = build_graph(rmat(3000, 24000, seed=8), reorder=True); "
            f"print(triangles_forked(g, {workers}))")
    proc = subprocess.run([sys.executable, "-W", "error::DeprecationWarning", "-c", code],
                          capture_output=True, text=True, timeout=120, check=True, cwd=ROOT)
    assert int(proc.stdout) == triangles_intersection(g)


def test_phase_modes_dispatch_before_the_card_check():
    """The host child of phase 22 runs with no card visible: its flag is
    read before main()'s CUDA check, which still refuses a run without one."""
    text = (ROOT / "chip_smoke.py").read_text()
    main = text[text.index("def main() -> int:"):]
    assert main.index("HOST_CHILD_FLAG") < main.index("torch.cuda.is_available()")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                          text=True, timeout=120, env={"PATH": "/usr/bin:/bin",
                                                       "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
