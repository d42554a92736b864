"""The port's sharded LM training on meshes of logical CPU shards.

The reference's sharded steps fail on this JAX (its Explicit-axes mesh
rejects ``constrain``: ``tests/test_distributed.py::
test_sharded_train_step_matches_single_device`` and
``::test_microbatched_grads_match_full_batch``), so the oracle here is the
port's own one-device step, which ``tests/test_torch_train.py`` holds to
``jax.value_and_grad(loss_fn)`` and ``adamw_update``. In float32 the
sharded gradients are within 1e-5 relative L2 a leaf of ``loss_and_grads``
on one device (the shards' sums only reorder the reduction), and after 3
steps the losses are within 1e-5 relative and the params within 1e-5
absolute (at lr 1e-3, against updates of up to 3e-3). The two reference
tests are ported with their own bounds (5e-3 on the loss after 5 steps;
2e-2 on the params and 1e-2 on the loss, microbatched against the full
batch). Elastic restores, checkpoints and the reference's reader of them
close the file.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.checkpoint import load_checkpoint as jx_load_checkpoint  # noqa: E402
from repro.configs import get_smoke_config as jx_get_smoke_config  # noqa: E402
from repro.models import model as jx_model  # noqa: E402
from repro_torch import optim as pt_optim  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.distributed.lm_sharding import (  # noqa: E402
    batch_spec_tree,
    named_tree,
    train_state_specs,
)
from repro_torch.distributed.mesh import make_mesh  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    NamedSharding,
    P,
    ShardedTensor,
    gather_tree,
    place,
    place_tree,
)
from repro_torch.launch import train as pt_train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.serve import ServeSession  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    loss_and_grads,
    make_train_step,
    sharded_loss_and_grads,
)
from repro_torch.models.model import init_model  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves  # noqa: E402
from repro_torch.runtime import FailureInjector, no_host_sync  # noqa: E402
from repro_torch.runtime.fault import SimulatedFailure  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")
GRAD_TOL = 1e-5  # relative L2 a leaf, float32
LOSS_TOL = 1e-5  # relative, float32, after each of 3 steps
PARAM_TOL = 1e-5  # absolute, float32, after 3 steps at lr 1e-3
OPT = pt_optim.AdamWConfig(lr=1e-3, weight_decay=0.0)


def _mesh(data, model):
    return make_host_mesh(data, model, devices=[CPU] * (data * model))


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _batch(cfg, b, s, step=0, seed=0):
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=seed,
                            family=cfg.family, d_frontend=cfg.d_frontend,
                            n_image_tokens=cfg.n_image_tokens)
    return {k: torch.from_numpy(v) for k, v in ds.batch(step).items()}


def _place_state(cfg, mesh, params):
    pspecs, ospecs, gspecs = train_state_specs(cfg)
    return (place_tree(params, named_tree(mesh, pspecs)),
            place_tree(pt_optim.adamw_init(params), named_tree(mesh, ospecs)),
            named_tree(mesh, gspecs))


def _check_grads(cfg, mesh, params, batch, microbatches=1):
    """Sharded (loss, metrics, grads) against the one-device ones."""
    pp, _, gsh = _place_state(cfg, mesh, params)
    bp = place_tree(batch, named_tree(mesh, batch_spec_tree(cfg, mesh, batch)))
    if microbatches == 1:
        loss, metrics, grads = loss_and_grads(params, batch, cfg)
        grads = tree_leaves(grads)
    else:
        runs = [loss_and_grads(params, {k: v[i] for k, v in
                                        {k: v.chunk(microbatches) for k, v in batch.items()}
                                        .items()}, cfg) for i in range(microbatches)]
        loss = sum(r[0] for r in runs) / microbatches
        metrics = {k: sum(r[1][k] for r in runs) / microbatches for k in runs[0][1]}
        grads = [sum(g.float() for g in gs) / microbatches
                 for gs in zip(*(tree_leaves(r[2]) for r in runs))]
    s_loss, s_metrics, s_grads = sharded_loss_and_grads(pp, bp, cfg, gsh, microbatches)
    assert abs(float(s_loss) - float(loss)) <= LOSS_TOL * abs(float(loss))
    assert set(s_metrics) == set(metrics)
    for k in metrics:
        assert abs(float(s_metrics[k]) - float(metrics[k])) <= LOSS_TOL * max(
            abs(float(metrics[k])), 1e-6), k
    for g, w, sh in zip(tree_leaves(s_grads), grads, tree_leaves(gsh), strict=True):
        assert isinstance(g, ShardedTensor) and g.dtype == torch.float32
        assert g.sharding is sh
        assert _rel(g.full(CPU), w) <= GRAD_TOL
    return s_grads


def _run_steps(cfg, mesh, params, batches, microbatches=1):
    """3 steps one-device and sharded: losses and params after each."""
    one = make_train_step(cfg, OPT, microbatches=microbatches)
    sharded = make_train_step(cfg, OPT, microbatches=microbatches, mesh=mesh)
    p1, o1 = params, pt_optim.adamw_init(params)
    p2, o2, _ = _place_state(cfg, mesh, params)
    for batch in batches:
        p1, o1, m1 = one(p1, o1, batch)
        p2, o2, m2 = sharded(p2, o2, batch)
        assert set(m1) == set(m2)
        assert abs(float(m2["loss"]) - float(m1["loss"])) <= LOSS_TOL * abs(float(m1["loss"]))
        assert abs(float(m2["grad_norm"]) - float(m1["grad_norm"])) <= 1e-5 * float(m1["grad_norm"])
    for a, b in zip(tree_leaves(p1), tree_leaves(gather_tree(p2, CPU))):
        assert a.dtype == b.dtype and float((a - b).abs().max()) <= PARAM_TOL
    for part in ("m", "v"):
        for a, b in zip(tree_leaves(o1[part]), tree_leaves(o2[part])):
            assert _rel(b.full(CPU), a) <= 1e-4
    assert int(o2["step"].full(CPU)) == len(batches)
    return p2, o2


# ----------------------------------------------------------- sharded steps


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_smollm_dp_profile_matches_one_device(shape):
    """The "dp" profile: params replicated (one tensor a device), moments
    ZeRO-1 over 'data', the batch over ('data', 'model')."""
    cfg = get_smoke_config("smollm-135m").scaled(dtype="float32")
    mesh = _mesh(*shape)
    params = init_model(0, cfg, "cpu")
    _check_grads(cfg, mesh, params, _batch(cfg, 8, 16))
    p2, o2 = _run_steps(cfg, mesh, params, [_batch(cfg, 8, 16, step=i) for i in range(3)])
    assert all(len(t.blocks) == 1 for t in tree_leaves(p2))
    emb = o2["m"]["tok_embed"]
    assert emb.sharding.spec == P("data", None) and len(emb.blocks) == shape[0]


def test_minicpm3_tp_profile_zero3_blocks_match_one_device():
    """minicpm3 pins "tp": ZeRO-3 (fsdp -> 'data', tp -> 'model') blocks,
    the batch over 'data' only (each of the 2 dp shards computes once)."""
    cfg = get_smoke_config("minicpm3-4b").scaled(dtype="float32")
    mesh = _mesh(2, 2)
    params = init_model(0, cfg, "cpu")
    grads = _check_grads(cfg, mesh, params, _batch(cfg, 4, 16))
    wq = grads["layers"]["attn"]["wuq"] if "wuq" in grads["layers"]["attn"] else None
    split = [t for t in tree_leaves(grads) if len(t.distinct_blocks()) == 4]
    assert split, "no leaf split over both axes"
    assert wq is None or len(wq.distinct_blocks()) >= 2
    p2, _ = _run_steps(cfg, mesh, params, [_batch(cfg, 4, 16, step=i) for i in range(3)])
    assert any(len(t.blocks) == 4 for t in tree_leaves(p2))


def test_mamba2_full_width_two_layers_tp_profile():
    """mamba2-780m at full width (d_model 1536, 48 SSM heads: "tp"), cut to
    2 layers, on a 2 x 1 mesh: the ZeRO-3 blocks' gradients."""
    cfg = get_config("mamba2-780m").scaled(n_layers=2, dtype="float32", remat="none")
    mesh = _mesh(2, 1)
    params = init_model(0, cfg, "cpu")
    grads = _check_grads(cfg, mesh, params, _batch(cfg, 2, 16))
    assert grads["tok_embed"].sharding.spec == P("model", "data")
    assert len(grads["tok_embed"].distinct_blocks()) == 2


def test_audio_masked_loss_weighs_shards_by_mask_count():
    """hubert's masked loss: shards whose mask counts differ (one of them
    masks nothing) weigh by count over the global count."""
    cfg = get_smoke_config("hubert-xlarge").scaled(dtype="float32")
    params = init_model(0, cfg, "cpu")
    batch = _batch(cfg, 4, 16)
    mask = torch.zeros(4, 16, dtype=torch.bool)
    mask[0, :13] = True
    mask[1, 2:4] = True
    mask[3, :] = True  # row 2 masks nothing
    batch["mask"] = mask
    _check_grads(cfg, _mesh(4, 1), params, batch)
    _check_grads(cfg, _mesh(2, 1), params, batch)
    _run_steps(cfg, _mesh(2, 2), params, [batch] * 3)


def test_moe_whole_groups_match_and_cut_groups_route_whole():
    """MoE aux losses are means over routing groups of min(1024, tokens):
    shards of 1,024 tokens hold whole groups and split. 4 x 32 tokens (one
    group of 128) would be cut by a split, so the batch (each microbatch,
    when there are several) runs as one shard on the mesh's first device:
    the loss, the aux losses and the float32 gradients equal the one-device
    step's and the reference's ``loss_fn`` on the whole batch, and 3 steps
    equal one device's. Rows that do not split still raise."""
    arch = "moonshot-v1-16b-a3b"
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    jcfg = jx_get_smoke_config(arch).scaled(dtype="float32")
    jp = jx_model.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    _check_grads(cfg, _mesh(2, 2), params, _batch(cfg, 8, 512))
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
    small = ds.batch(0)
    (wloss, wmetrics), wgrads = jax.value_and_grad(jx_model.loss_fn, has_aux=True)(
        jp, {k: jax.numpy.asarray(v) for k, v in small.items()}, jcfg)
    for shape in ((2, 2), (2, 1)):
        pp, _, gsh = _place_state(cfg, _mesh(*shape), params)
        bp = {k: torch.from_numpy(v) for k, v in small.items()}
        _check_grads(cfg, _mesh(*shape), params, bp)
        bp = place_tree(bp, named_tree(_mesh(*shape), batch_spec_tree(cfg, _mesh(*shape), bp)))
        loss, metrics, grads = sharded_loss_and_grads(pp, bp, cfg, gsh)
        assert abs(float(loss) - float(wloss)) <= LOSS_TOL * abs(float(wloss))
        assert sorted(metrics) == sorted(wmetrics)
        assert {"moe_balance_loss", "moe_dropped_frac"} <= set(metrics)
        for k in metrics:
            assert abs(float(metrics[k]) - float(wmetrics[k])) <= LOSS_TOL * max(
                abs(float(wmetrics[k])), 1e-6), k
        for g, w in zip(tree_leaves(grads), jax.tree.leaves(wgrads), strict=True):
            assert _rel(g.full(CPU), torch.from_numpy(np.array(w))) <= GRAD_TOL
    _check_grads(cfg, _mesh(2, 2), params, _batch(cfg, 8, 32), microbatches=2)
    _run_steps(cfg, _mesh(2, 2), params, [_batch(cfg, 4, 32, step=i) for i in range(3)])
    _check_grads(cfg, _mesh(1, 1), params, _batch(cfg, 4, 32))  # one shard: nothing is cut
    with pytest.raises(ValueError, match="does not split"):
        make_train_step(cfg, OPT, microbatches=3, mesh=_mesh(2, 2))(
            params, pt_optim.adamw_init(params), _batch(cfg, 4, 32))


@pytest.mark.parametrize("arch", ["smollm-135m", "minicpm3-4b"])
def test_microbatches_on_a_mesh_match_one_device(arch):
    """Microbatches first (contiguous), each split over dp: the one-device
    microbatched step's gradients and 3 steps."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = init_model(0, cfg, "cpu")
    mesh = _mesh(2, 2)
    _check_grads(cfg, mesh, params, _batch(cfg, 8, 16), microbatches=2)
    _run_steps(cfg, mesh, params, [_batch(cfg, 8, 16, step=i) for i in range(3)], microbatches=2)
    with pytest.raises(ValueError, match="does not split"):
        make_train_step(cfg, OPT, microbatches=3, mesh=mesh)(
            params, pt_optim.adamw_init(params), _batch(cfg, 8, 16))


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "zamba2-7b"])
def test_other_families_on_a_mesh_match_one_device(arch):
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = init_model(0, cfg, "cpu")
    _check_grads(cfg, _mesh(2, 2), params, _batch(cfg, 4, 16))


def test_sharded_step_reads_nothing_back(monkeypatch):
    monkeypatch.setenv("TCIM_CONTRACTS", "1")
    cfg = get_smoke_config("smollm-135m").scaled(remat="full")
    mesh = _mesh(2, 2)
    params = init_model(0, cfg, "cpu")
    pp, po, _ = _place_state(cfg, mesh, params)
    bp = place_tree(_batch(cfg, 4, 16),
                    named_tree(mesh, batch_spec_tree(cfg, mesh, _batch(cfg, 4, 16))))
    step = make_train_step(cfg, OPT, mesh=mesh, batch_sds=_batch(cfg, 4, 16))
    with no_host_sync():
        _, _, metrics = step(pp, po, bp)
    assert np.isfinite(float(metrics["loss"])) and metrics["loss"].ndim == 0


def test_step_refuses_state_placed_otherwise():
    cfg = get_smoke_config("smollm-135m").scaled(dtype="float32")
    mesh = _mesh(2, 2)
    params = init_model(0, cfg, "cpu")
    pp, po, _ = _place_state(cfg, mesh, params)
    pp["final_norm"] = place(params["final_norm"], NamedSharding(mesh, P("data")))
    with pytest.raises(ValueError, match="params/final_norm is placed by"):
        make_train_step(cfg, OPT, mesh=mesh)(pp, po, _batch(cfg, 4, 16))


# ------------------------------------------------ the reference's tests, ported


@pytest.mark.parametrize("baseline", ["1x1", "one device"])
def test_sharded_train_step_matches_single_device(baseline):
    """tests/test_distributed.py's case (qwen1.5-110b smoke, bf16, 4 x 32,
    5 steps): the 2 x 2 loop's last loss within 5e-3 of 1 x 1's."""
    def run(mesh, device=None):
        loop = pt_train.TrainLoop("qwen1.5-110b", smoke=True, global_batch=4, seq=32,
                                  mesh=mesh, device=device, opt=OPT)
        loop.run(5, log_every=5)
        return loop.metrics_log[-1]["loss"]

    l2 = run(_mesh(2, 2))
    l1 = run(_mesh(1, 1)) if baseline == "1x1" else run(None, "cpu")
    assert abs(l1 - l2) < 5e-3, (l1, l2)


@pytest.mark.parametrize("shape,microbatches", [((1, 1), 4), ((2, 2), 2)])
def test_microbatched_grads_match_full_batch(shape, microbatches):
    """tests/test_distributed.py's case (smollm-135m smoke, 8 x 32): one
    step microbatched against the full batch, params within 2e-2, loss
    within 1e-2."""
    cfg = get_smoke_config("smollm-135m")
    mesh = _mesh(*shape)
    params = init_model(0, cfg, "cpu")
    batch = _batch(cfg, 8, 32)
    outs = []
    for n in (1, microbatches):
        pp, po, _ = _place_state(cfg, mesh, params)
        outs.append(make_train_step(cfg, OPT, microbatches=n, mesh=mesh)(pp, po, batch))
    (p1, _, m1), (pn, _, mn) = outs
    d = max(float((a.full(CPU).float() - b.full(CPU).float()).abs().max())
            for a, b in zip(tree_leaves(p1), tree_leaves(pn)))
    assert d < 2e-2, d
    assert abs(float(m1["loss"]) - float(mn["loss"])) < 1e-2


# --------------------------------------------------------- elastic restore


def _loop(mesh, tmp=None, **kw):
    return pt_train.TrainLoop("smollm-135m", smoke=True, global_batch=8, seq=16, mesh=mesh,
                              device=None if mesh is not None else "cpu", ckpt_every=5,
                              ckpt_dir=None if tmp is None else str(tmp),
                              opt=OPT, cfg_override=get_smoke_config("smollm-135m").scaled(
                                  dtype="float32"), **kw)


@pytest.mark.parametrize("target", ["4x1", "1x4", "1x1", "one device"])
def test_elastic_restore_onto_another_mesh(tmp_path, target):
    """A 2 x 2 loop fails at step 7 (its checkpoint of step 5 committed);
    a loop on another mesh restores it with its shardings, every block
    bit-equal to the saved leaf's slice, and trains on to the uninterrupted
    2 x 2 run's losses."""
    steps = 10
    ref = _loop(_mesh(2, 2))
    ref.run(steps, log_every=1)
    want = {m["step"]: m["loss"] for m in ref.metrics_log}
    first = _loop(_mesh(2, 2), tmp_path)
    with pytest.raises(SimulatedFailure):
        first.run(steps, injector=FailureInjector(fail_at_steps=(7,)))
    mesh = None if target == "one device" else _mesh(*map(int, target.split("x")))
    second = _loop(mesh, tmp_path)
    params, opt, start = second.restore_or_init()
    assert start == 5
    saved, _, _ = load_checkpoint(tmp_path, {"params": params, "opt": opt}, step=5)
    for got, leaf in zip(tree_leaves({"params": params, "opt": opt}), tree_leaves(saved)):
        leaf = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(leaf))
        if mesh is None:
            assert torch.equal(got, leaf)
            continue
        assert isinstance(got, ShardedTensor) and got.sharding.mesh == mesh
        for pos in np.ndindex(*mesh.devices.shape):
            sl = got.sharding.block_slices(got.shape, got.sharding.block_index(pos, got.ndim))
            assert torch.equal(got.block(pos), leaf[sl])
    second.run(steps, log_every=1)
    for m in second.metrics_log:
        assert abs(m["loss"] - want[m["step"]]) <= LOSS_TOL * abs(want[m["step"]])
    assert [m["step"] for m in second.metrics_log] == list(range(6, steps + 1))


def test_same_mesh_resume_is_bit_exact(tmp_path):
    steps = 12
    ref = _loop(_mesh(2, 2))
    pa, sa, _ = ref.run(steps, log_every=1)
    want = {m["step"]: m["loss"] for m in ref.metrics_log}
    loop = _loop(_mesh(2, 2), tmp_path)
    (pb, sb, _), restarts = pt_train.run_with_auto_resume(
        loop, steps, FailureInjector(fail_at_steps=(7, 11)))
    assert restarts == 2
    assert all(m["loss"] == want[m["step"]] for m in loop.metrics_log)
    for a, b in zip(tree_leaves({"p": pa, "s": sa}), tree_leaves({"p": pb, "s": sb})):
        assert a.sharding.same_blocks(b.sharding, a.ndim)
        for idx, t in a.distinct_blocks().items():
            assert torch.equal(t, b.distinct_blocks()[idx])


def test_placed_checkpoint_is_byte_equal_and_the_reference_reads_it(tmp_path):
    """A placed state (bf16 params replicated, f32 moments ZeRO-1, minicpm3's
    ZeRO-3 blocks) saves the files its gathered state saves, and the JAX
    package's ``load_checkpoint`` reads them."""
    for arch in ("smollm-135m", "minicpm3-4b"):
        cfg = get_smoke_config(arch)
        params = init_model(0, cfg, "cpu")
        pp, po, _ = _place_state(cfg, _mesh(2, 2), params)
        placed = {"params": pp, "opt": po}
        dense = {"params": params, "opt": pt_optim.adamw_init(params)}
        a = save_checkpoint(tmp_path / arch / "placed", 3, placed)
        b = save_checkpoint(tmp_path / arch / "dense", 3, dense)
        files = sorted(p.name for p in a.iterdir())
        assert files == sorted(p.name for p in b.iterdir())
        for name in files:
            if name != "manifest.json":
                assert (a / name).read_bytes() == (b / name).read_bytes(), name
        like = jax.tree.map(lambda t: np.zeros(tuple(t.shape)), dense)
        got, step, _ = jx_load_checkpoint(tmp_path / arch / "placed", like)
        assert step == 3
        for g, w in zip(jax.tree.leaves(got), tree_leaves(dense)):
            np.testing.assert_array_equal(np.asarray(g, np.float32), w.float().numpy())


def test_load_checkpoint_places_by_shardings(tmp_path):
    params = {"a": torch.arange(24.0).reshape(8, 3), "b": {"c": torch.ones(3)}}
    save_checkpoint(tmp_path, 1, params)
    mesh = _mesh(2, 2)
    sh = {"a": NamedSharding(mesh, P(("data", "model"))), "b": {"c": NamedSharding(mesh, P())}}
    got, _, _ = load_checkpoint(tmp_path, params, shardings=sh)
    assert torch.equal(got["a"].block((1, 0)), params["a"][4:6])
    assert len(got["b"]["c"].blocks) == 1
    bad = {"a": NamedSharding(mesh, P(None, "model")), "b": {"c": sh["b"]["c"]}}
    with pytest.raises(ValueError, match=r"\['a'\]: dim 1"):
        load_checkpoint(tmp_path, params, shardings=bad)


def test_train_cli_on_a_mesh_of_logical_shards(tmp_path, capsys):
    assert pt_train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "10",
                          "--global-batch", "4", "--seq", "16", "--data", "2", "--model", "2",
                          "--ckpt-dir", str(tmp_path), "--ckpt-every", "4", "--fail-at", "6"]) == 0
    out = capsys.readouterr().out
    assert "restarts=1" in out and "loss: first=" in out


def test_serving_on_a_mesh_still_raises():
    """Serving on a mesh is ported (``tests/test_torch_sharded_serve.py``): a
    1 x 1 mesh serves the same greedy tokens as one device. What still
    raises is a mesh that is not the port's ``Mesh`` and a device that
    disagrees with the mesh's."""
    kw = dict(smoke=True, batch=2, max_seq=24, dtype="float32")
    prompts = np.random.default_rng(0).integers(0, 256, (2, 16), dtype=np.int32)
    sharded = ServeSession("smollm-135m", mesh=_mesh(1, 1), **kw)  # both init from seed 0
    one = ServeSession("smollm-135m", device="cpu", **kw)
    assert np.array_equal(sharded.generate(prompts, 4)[0], one.generate(prompts, 4)[0])
    with pytest.raises(ValueError, match="Mesh"):
        ServeSession("smollm-135m", device="cpu", mesh=object(), **kw)
    with pytest.raises(ValueError, match="disagrees"):
        ServeSession("smollm-135m", device="cuda", mesh=_mesh(1, 1), **kw)


def test_sharding_modules_import_no_jax_and_nothing_of_repro():
    code = (
        "import sys\n"
        "import repro_torch.distributed.sharding, repro_torch.distributed.ctx\n"
        "import repro_torch.distributed.lm_sharding, repro_torch.distributed.compression\n"
        "import repro_torch.distributed.constants, repro_torch.launch.mesh\n"
        "import repro_torch.launch.specs, repro_torch.launch.train\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env={"PYTHONPATH": str(SRC), "PATH": ""},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
