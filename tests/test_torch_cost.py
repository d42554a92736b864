"""The port's cost accounting, held to the JAX package's on the CPU.

``analysis/hlo_cost.py::step_cost`` against the reference's ``hlo_cost``
tests (a product's FLOPs exact, a loop's trips counted, bytes charged to a
scope) and against ``hlo_cost`` over ``jax.jit(jax.value_and_grad(loss_fn))``
at the smoke configs; ``analysis/roofline.py`` against the reference's with
its constants set to the H100's; the dry run's record of every runnable cell
on both duck meshes, built on meta tensors; the report's tables; hillclimb's
cells A and B at 2 layers and cell C on the CPU; ``run_tcim`` against the
port's sharded plan.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.analysis.roofline as ref_roofline  # noqa: E402
from repro_torch.analysis import hillclimb, report  # noqa: E402
from repro_torch.analysis.hlo_cost import cost_scope, step_cost  # noqa: E402
from repro_torch.analysis.roofline import model_flops, roofline_terms  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import Shape  # noqa: E402
from repro_torch.distributed import constants  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bshd,
    flash_launch_cost,
)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.specs import META, CellSpec, batch_struct  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402

# ------------------------------------------------------------ step_cost


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_step_cost_dot_flops_exact():
    c = step_cost(lambda x, y: x @ y, _meta(32, 48), _meta(48, 16))
    assert c.flops == c.matmul_flops == 2 * 32 * 48 * 16
    assert c.bytes >= (32 * 48 + 48 * 16 + 32 * 16) * 4
    assert c.unknown_trip_whiles == 0 and c.custom_calls == 0 and c.collective_bytes == 0


def test_step_cost_counts_loop_trips():
    def loop(x, w):
        for i in range(11):
            x = torch.tanh(x @ w[i])
        return x

    c = step_cost(loop, _meta(8, 64), _meta(11, 64, 64))
    dot_flops = 11 * 2 * 8 * 64 * 64
    assert c.matmul_flops == dot_flops
    assert 0.95 * dot_flops <= c.flops <= 1.3 * dot_flops, c.flops
    assert c.unknown_trip_whiles == 0


def test_step_cost_tag_attribution():
    def f(a):
        with cost_scope("attn_core"):
            b = a * 2.0
        return b + 1.0

    c = step_cost(f, _meta(256, 256), tags={"attn": "attn_core"})
    assert 0 < c.bytes_by_tag["attn"] <= c.bytes
    assert c.bytes_by_tag["attn"] == 2 * 256 * 256 * 4  # one array in, one out
    assert c.flops >= 256 * 256


def test_step_cost_skips_a_scope_and_its_launches():
    """``skip`` leaves out the ops and custom calls run inside the scope it
    names (the tensor-parallel path's other model shards), nested too."""
    b, s, h, hd = 1, 64, 2, 64
    q = _meta(b, s, h, hd, dtype=torch.bfloat16)
    pos = torch.empty(b, s, dtype=torch.int32, device=META)

    def f(a):
        c = a @ a
        with cost_scope("other"):
            with cost_scope("attn_core"):
                flash_attention_bshd(q, q, q, pos, pos)
            d = a @ a + 1.0
        return c + d

    a = _meta(32, 32)
    whole = step_cost(f, a, tags={"attn": "attn_core"})
    home = step_cost(f, a, tags={"attn": "attn_core"}, skip="other")
    assert whole.custom_calls == 1 and home.custom_calls == 0
    assert home.matmul_flops == 2 * 32 ** 3 and home.flops == 2 * 32 ** 3 + 32 * 32
    assert home.bytes == 3 * 32 * 32 * 4 + 3 * 32 * 32 * 4  # the product and the sum
    assert "attn" in whole.bytes_by_tag and not home.bytes_by_tag


def test_scope_charges_backward_and_costs_nothing_idle():
    x = _meta(64, 64).requires_grad_()

    def f(x):
        with cost_scope("attn_core"):
            y = torch.tanh(x)
        return (y * 3.0).sum()

    fwd = step_cost(f, x, tags={"attn": "attn_core"})
    both = step_cost(lambda x: torch.autograd.grad(f(x), [x]), x, tags={"attn": "attn_core"})
    # tanh's backward (tanh_backward: grad and output in, grad out) is charged too.
    assert both.bytes_by_tag["attn"] == fwd.bytes_by_tag["attn"] + 3 * 64 * 64 * 4
    with cost_scope("attn_core") as s:  # no counter running: nothing recorded
        assert s._lo is None


def test_views_and_slab_updates():
    cache = _meta(4, 100, 8)
    new = _meta(4, 1, 8)
    c = step_cost(lambda: cache.narrow(1, 7, 1).copy_(new))
    assert c.bytes == 2 * new.numel() * 4  # twice the slab, not the cache
    v = step_cost(lambda: cache.view(400, 8).t().transpose(0, 1).expand(2, 400, 8))
    assert v.bytes == 0 and v.flops == 0


def test_inference_mode_composites_are_counted():
    with torch.inference_mode():
        c = step_cost(lambda x, w: x @ w, _meta(8, 1, 576), _meta(576, 64))
    assert c.matmul_flops == 2 * 8 * 576 * 64


def test_flash_wrapper_reports_its_launch_on_meta():
    b, s, h, kh, hd = 2, 128, 4, 2, 64
    q = _meta(b, s, h, hd, dtype=torch.bfloat16)
    k = _meta(b, s, kh, hd, dtype=torch.bfloat16)
    pos = torch.empty(b, s, dtype=torch.int32, device=META)
    c = step_cost(flash_attention_bshd, q, k, k, pos, pos)
    flops, nbytes = flash_launch_cost(b, h, kh, s, s, hd, 2, True)
    assert c.custom_calls == 1 and c.matmul_flops == flops == 4 * b * h * s * s * hd / 2
    assert c.bytes == nbytes == 2 * b * (h * 2 * s * hd + kh * 2 * s * hd)
    out = flash_attention(q[:, :, 0], k[:, :, 0], k[:, :, 0], pos, pos)
    assert out.shape == (b, s, hd) and out.is_meta
    got = []
    common.COST_SINKS.append(lambda *a: got.append(a))
    try:
        common.report_cost(1.0, 2.0)
    finally:
        common.COST_SINKS.pop()
    common.report_cost(1.0, 2.0)  # no sink: nothing happens
    assert got == [(1.0, 2.0, False)]


# ------------------------------------------------------------ roofline


def test_roofline_and_model_flops_match_reference(monkeypatch):
    monkeypatch.setattr(ref_roofline, "PEAK_FLOPS_BF16", constants.PEAK_FLOPS_BF16)
    monkeypatch.setattr(ref_roofline, "HBM_BW", constants.HBM_BW)
    monkeypatch.setattr(ref_roofline, "ICI_BW_PER_LINK", constants.NVLINK_BW)
    for args in [(1e15, 1e12, 0.0), (2e12, 3e12, 4e10), (5e9, 1e6, 7e11), (0.0, 0.0, 1.0)]:
        assert roofline_terms(*args) == ref_roofline.roofline_terms(*args)
    for kind in ("train", "prefill", "decode"):
        assert model_flops(kind, 134_515_008, 16_384) == ref_roofline.model_flops(
            kind, 134_515_008, 16_384)
    assert (constants.PEAK_FLOPS_BF16, constants.HBM_BW) == (989e12, 3.35e12)


# ------------------------------------------------------------ dry run


class _DevicesSeen(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.devices = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
        return out


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_records_every_cell_on_meta(mesh):
    seen = _DevicesSeen()
    if mesh == "single":  # every op seen once: multi's train cells reuse these microbatches
        dryrun._microbatch_cost.cache_clear()
        with seen:
            recs = [dryrun.run_cell(a, s, mesh, n_layers=2) for a in ARCHS for s in SHAPES]
        assert seen.devices == {"meta"}  # nothing allocated
    else:
        recs = [dryrun.run_cell(a, s, mesh, n_layers=2) for a in ARCHS for s in SHAPES]
    runnable = [r for r in recs if not r["skipped"]]
    assert len(recs) == 40 and len(runnable) == 31
    assert all(r["skip_reason"] for r in recs if r["skipped"])
    n_chips = 256 if mesh == "single" else 512
    for r in runnable:
        name = (r["arch"], r["shape"])
        # The dense (MLA too), MoE, VLM, SSM and hybrid decoders' serving
        # cells take the tensor-parallel step; the audio encoder's prefill
        # and train cells too.
        tp = (r["arch"] in ("deepseek-67b", "qwen1.5-110b", "minicpm3-4b", "moonshot-v1-16b-a3b",
                            "dbrx-132b", "llama-3.2-vision-90b", "mamba2-780m",
                            "zamba2-7b") and r["kind"] != "train") or r["arch"] == "hubert-xlarge"
        assert r["n_chips"] == n_chips and r["n_layers"] == 2, name
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0, name
        assert 0 < r["matmul_flops_per_device"] <= r["flops_per_device"], name
        assert r["memory"]["placed_bytes"] > 0 and isinstance(r["fits_80GB"], bool), name
        ops = set(r["collectives"]["by_op"])
        assert ops == ({"all-gather", "reduce-scatter"} if r["kind"] == "train" and not tp
                       else {"all-gather", "reduce-scatter", "activations"} if r["kind"] == "train"
                       else {"all-gather", "activations"} if tp else {"all-gather"}), name
        assert r["collectives"]["unknown_trip_whiles"] == 0, name
        assert r["roofline"]["dominant"] in ("compute", "memory", "collective"), name
        assert r["model_shards"] == (16 if tp else 1), name
        assert r["model_flops_per_device"] == (
            r["model_flops_global"] / (r["dp_shards"] * r["model_shards"])), name
        assert ("divided by the model axis" if tp else "does not divide") in r["per_device"]


def test_dryrun_full_depth_smollm_train():
    r = dryrun.run_cell("smollm-135m", "train_4k", "single")
    cfg = get_config("smollm-135m")
    n = cfg.param_count()
    # profile "dp": params replicated, one row of 4,096 a device, one microbatch
    assert (r["microbatches"], r["dp_shards"], r["rows_per_microbatch"]) == (1, 256, 1)
    assert r["memory"]["params_bytes"] == r["memory"]["gathered_params_bytes"] == 2 * n
    assert r["fits_80GB"] and r["collectives"]["by_op"]["all-gather"] == 0
    assert r["collectives"]["by_op"]["reduce-scatter"] == pytest.approx(2 * n * 15 / 16)
    assert r["model_flops_global"] == 6 * n * 256 * 4096
    # Products: 6 N T with N the product weights, 12 L S^2 H hd of attention,
    # remat's second forward of every product but the MLP's output.
    t, attn = 4096, cfg.n_layers * 4096 ** 2 * cfg.n_heads * cfg.resolved_head_dim
    layers = cfg.n_layers * (2 * 576 * 576 + 2 * 576 * 192 + 3 * 576 * 1536)
    products = 6 * (49152 * 576 + layers) * t + 16 * attn + 2 * (layers - 30 * 1536 * 576) * t
    assert r["matmul_flops_per_device"] == pytest.approx(products, rel=1e-9)
    assert r["roofline"]["dominant"] == "memory"
    assert 0.3 < r["useful_flops_ratio"] < 1.0


def test_dryrun_audio_cells_take_the_tensor_parallel_steps(monkeypatch):
    """hubert-xlarge at 2 layers on the production mesh: prefill_32k and
    train_4k count the home shard's part of the tensor-parallel step. Its
    model blocks are 1/16 of the frame projection's, wq/wk/wv's, wo's, the
    MLP's and lm_head's leaves, the norms whole; its products are the
    gathered path's over 16, but the prefill's logits (the last frame's
    alone, where the gathered prefill takes every frame's and keeps the
    last) and, in training, remat's recomputation of the home's MLP output
    partial a layer (a row-parallel product's derivative is a custom
    Function, whose saved inputs are packed after its forward: the
    one-device recomputation stops before its MLP output product). Backward
    ops are charged to their shard's scope: the home's products add up to
    1/16 of the whole group's."""
    from repro_torch.distributed.tensor_parallel import model_dim

    model = {"frontend", "lm_head", "layers/attn/wq", "layers/attn/wk", "layers/attn/wv",
             "layers/attn/wo", "layers/mlp/wi_gate", "layers/mlp/wi_up", "layers/mlp/wo"}
    for shape in ("prefill_32k", "train_4k"):
        r = dryrun.run_cell("hubert-xlarge", shape, "single", n_layers=2)
        spec = CellSpec("hubert-xlarge", shape)
        spec.cfg = cfg = dryrun.cut_depth(spec.cfg, 2)
        params = spec.params_struct()
        psh = dryrun.named_tree(dryrun.production_mesh("single"),
                                dryrun.train_state_specs(cfg)[0])
        names = []
        dryrun.map_named(lambda n, t: names.append(n), params)
        leaves = [t for t in dryrun.tree_leaves(params)]
        assert {n for n, t, sh in zip(names, leaves, dryrun.tree_leaves(psh))
                if model_dim(sh.spec, t.ndim) is not None} == model
        whole = sum(t.numel() * t.element_size() for t in leaves)
        split = sum(t.numel() * t.element_size() for n, t in zip(names, leaves) if n in model)
        assert r["memory"]["gathered_params_bytes"] == whole - split + split // 16
        assert r["model_shards"] == 16 and r["collectives"]["by_op"]["activations"] > 0
        assert "divided by the model axis" in r["per_device"]
        monkeypatch.setattr(dryrun, "serves_tensor_parallel", lambda cfg, mesh: False)
        monkeypatch.setattr(dryrun, "trains_tensor_parallel", lambda cfg, mesh: False)
        g = dryrun.run_cell("hubert-xlarge", shape, "single", n_layers=2)
        monkeypatch.undo()
        assert g["memory"]["gathered_params_bytes"] == whole
        d, v, seq = cfg.d_model, cfg.padded_vocab, spec.shape.seq
        if shape == "prefill_32k":
            rows = r["rows"]
            assert rows == g["rows"] == 2
            extra = (2 * rows * d * v - 2 * rows * seq * d * v) / 16
        else:
            rows, mb = r["rows_per_microbatch"], r["microbatches"]
            assert (rows, mb) == (g["rows_per_microbatch"], g["microbatches"]) == (1, 16)
            extra = mb * cfg.n_layers * 2 * rows * seq * cfg.d_ff // 16 * d
            assert set(r["collectives"]["by_op"]) == {"all-gather", "reduce-scatter",
                                                      "activations"}
            assert r["collectives"]["by_op"]["reduce-scatter"] == pytest.approx(
                2 * mb * r["collectives"]["by_op"]["all-gather"])  # float32, each microbatch
        assert r["matmul_flops_per_device"] == pytest.approx(
            g["matmul_flops_per_device"] / 16 + extra, rel=1e-9)
        assert r["group_step_lower_bound_s"] == r["roofline"]["step_lower_bound_s"]


def test_run_tcim_matches_the_sharded_plan():
    from repro_torch.core import build_sbf, build_worklist
    from repro_torch.core.plan import DeviceTopology, plan_execution
    from repro_torch.distributed.tc import shard_worklist
    from repro_torch.graphs import build_graph, rmat

    g = build_graph(rmat(3000, 18000, seed=4), reorder=True)
    sb = build_sbf(g, slice_bits=64)
    wl = build_worklist(g, sb)
    plan = plan_execution(sb, wl, DeviceTopology(num_devices=1), placement="replicated")
    for mesh, chips in (("single", 256), ("multi", 512)):
        rec = dryrun.run_tcim(mesh, len(sb.row_slice_idx), len(sb.col_slice_idx),
                              wl.num_pairs, sb.words_per_slice)
        row, col = shard_worklist(wl, chips)
        assert rec["n_chips"] == chips and rec["placement"] == plan.placement
        assert rec["memory"]["store_bytes"] == plan.stats["store_bytes"] == (
            sb.row_slice_data.nbytes + sb.col_slice_data.nbytes)
        assert rec["memory"]["index_bytes"] == row[0].nbytes + col[0].nbytes
        assert rec["flops_per_device"] == 3 * row.shape[1] * sb.words_per_slice
    big = dryrun.run_tcim("single")
    assert big["memory"]["store_bytes"] == 2 * (1 << 21) * 2 * 4
    assert big["pairs_per_device"] == (1 << 26) // 256


# ------------------------------------------------------------ report, hillclimb


def test_report_tables(tmp_path, capsys):
    import json

    recs = [dryrun.run_cell("smollm-135m", "decode_32k", m, n_layers=2)
            for m in ("single", "multi")]
    recs += [dryrun.run_cell("hubert-xlarge", "decode_32k", "single"), dryrun.run_tcim("single"),
             {"arch": "qwen1.5-110b", "shape": "train_4k", "mesh": "single", "skipped": False,
              "error": "RuntimeError: x"}]
    for i, r in enumerate(recs):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    loaded = report.load_records(tmp_path)
    table = report.dryrun_table(loaded)
    assert "fits 80GB" in table and "| smollm-135m | decode_32k | multi | ok |" in table
    assert "SKIP: encoder-only" in table and "| ERROR |" in table and "tcim" not in table
    roof = report.roofline_table(loaded)
    assert roof.count("| smollm-135m |") == 1 and "tcim-distributed" in roof
    summary = report.summarize(loaded)
    assert summary["runnable"] == 2 and summary["skipped"] == 1 and summary["over_budget"] == []
    report.main(tmp_path)
    assert "## §Roofline" in capsys.readouterr().out


def test_hillclimb_cells_a_b_at_two_layers():
    a = hillclimb.cell_a(n_layers=2)
    b = hillclimb.cell_b(n_layers=2)
    assert len(a) == len(b) == 4
    base, flash = a[0]["after"], a[1]["after"]
    assert flash["bytes"] < base["bytes"] and flash["flops"] == base["flops"]
    cfg = get_config("minicpm3-4b").scaled(n_layers=2)
    want = 2 * 40 * (4096 * 96 * 2 + 4096 * 64 * 2) * 2 * 3 * 2 * 8  # rows 2, 2 layers, mb 8
    assert flash["flash_bytes"] == want and cfg.v_head_dim == 64
    assert a[2]["after"]["flops"] < flash["flops"]  # remat dots recomputes no product
    b16, b8 = b[0]["after"], b[1]["after"]
    assert b8["coll"] < b16["coll"] and b8["microbatches"] == 8
    assert math.isclose(b16["flops"] / b8["flops"], 1.0, rel_tol=0.05)


def test_hillclimb_cell_c_on_the_cpu():
    from repro_torch.graphs import build_graph, rmat
    from repro_torch.graphs.exact import triangles_intersection

    recs = hillclimb.cell_c("cpu", n=2000, m=12000, seed=3)
    want = triangles_intersection(build_graph(rmat(2000, 12000, seed=3), reorder=True))
    assert recs[0]["after"]["count"] == recs[1]["after"]["count"] == want
    assert set(recs[2]["after"]["sweep"]) == {str(1 << 18), str(1 << 20), str(1 << 22)}
    assert np.isclose(recs[3]["after"]["memory_s_unfused"] / recs[3]["after"]["memory_s_kernel"],
                      (3 * 16 + 8 + 4 / (1 << 26)) / (16 + 8 + 4 / (1 << 26)))


# ------------------------------------------------------------ vs hlo_cost

# (arch, layers (None: the smoke config's), seq, bounds of port/reference FLOPs)
FAMILY_CASES = [
    ("smollm-135m", None, 128, (0.95, 1.05)),
    ("qwen1.5-110b", None, 128, (0.95, 1.05)),
    # The other families: products agree (within 0.2 % at mamba2 and
    # zamba2); elementwise ops are where the two conventions part.
    ("moonshot-v1-16b-a3b", 1, 32, (0.97, 1.01)),
    ("minicpm3-4b", 1, 32, (0.96, 1.00)),
    ("mamba2-780m", 1, 32, (0.88, 0.92)),
    ("zamba2-7b", 2, 16, (0.91, 0.95)),
    ("llama-3.2-vision-90b", 2, 32, (0.95, 0.99)),
    ("hubert-xlarge", 1, 32, (0.96, 1.00)),
]


# The child's script: the reference's hlo_cost of each case's step as JSON
# (JAX only; XLA's LLVM passes do not change the optimized HLO it reads).
_REFERENCE_SCRIPT = """
import dataclasses, json, sys
import jax
from repro.analysis.hlo_cost import hlo_cost
from repro.configs import get_smoke_config
from repro.configs.shapes import Shape
from repro.launch.specs import batch_struct
from repro.models import model
fast = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
out = {}
for arch, layers, seq in json.loads(sys.argv[1]):
    cfg = get_smoke_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = jax.eval_shape(lambda k: model.init_model(k, cfg), jax.random.PRNGKey(0))
    batch = batch_struct(cfg, Shape("t", "train", seq, 2), True)
    fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss_fn(p, b, cfg), has_aux=True))
    out[arch] = hlo_cost(fn.lower(params, batch).compile(fast).as_text()).flops
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def reference_flops():
    """The reference's counts, compiled in a child process while the file's
    other tests run (the comparisons come last)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(Path(__file__).resolve().parents[1] / "src"),
                                         env.get("PYTHONPATH", "")])
    cases = json.dumps([c[:3] for c in FAMILY_CASES])
    child = subprocess.Popen([sys.executable, "-c", _REFERENCE_SCRIPT, cases],
                             stdout=subprocess.PIPE, env=env, text=True)
    _REFERENCE["child"] = child
    yield
    child.kill()
    child.communicate()
    _REFERENCE.clear()


_REFERENCE: dict = {}


def _reference(arch: str) -> float:
    if "flops" not in _REFERENCE:
        out, _ = _REFERENCE["child"].communicate(timeout=600)
        assert _REFERENCE["child"].returncode == 0, "the reference's counts failed"
        _REFERENCE["flops"] = json.loads(out.strip().splitlines()[-1])
    return _REFERENCE["flops"][arch]


@pytest.mark.parametrize("arch,layers,seq,bounds", FAMILY_CASES, ids=[c[0] for c in FAMILY_CASES])
def test_step_cost_matches_reference_hlo_cost(arch, layers, seq, bounds):
    pcfg = get_smoke_config(arch)
    if layers:
        pcfg = dataclasses.replace(pcfg, n_layers=layers)
    ref_flops = _reference(arch)
    spec = CellSpec(arch, "train_4k")
    spec.cfg = pcfg
    got = step_cost(loss_and_grads, spec.params_struct(),
                    batch_struct(pcfg, Shape("t", "train", seq, 2), True), pcfg)
    lo, hi = bounds
    assert lo <= got.flops / ref_flops <= hi, (got.flops, ref_flops)
    assert got.matmul_flops <= got.flops

