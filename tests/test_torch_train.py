"""Port vs reference: LM training on one device.

The port's synthetic token stream, schedule, AdamW, ``loss_fn`` and its
backward (autograd, under each ``remat`` mode), ``make_train_step`` and
``TrainLoop`` (``device="cpu"``) are held against the JAX package on the
same inputs: batches byte-equal, parameters made by the reference's
``init_model`` and converted bit for bit by ``params_from_numpy``.

The reference's ``make_train_step`` and ``TrainLoop`` build an
Explicit-axes mesh that its sharding constraints reject on this JAX, so a
whole step is held against the reference's own functions composed outside
any mesh (where its constraints are the identity): ``jax.value_and_grad``
of ``loss_fn``, ``cosine_warmup`` of the step and ``adamw_update``, as
``tests/test_models.py::test_smoke_one_train_step`` runs them. Tolerances,
float32: gradients 1e-5 in relative L2 a leaf (summation order only), the
schedule 1e-6, AdamW 1e-5; bfloat16 parameters equal after the cast, or one
ulp apart.
"""
import functools
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import load_checkpoint as jx_load_checkpoint  # noqa: E402
from repro.checkpoint import save_checkpoint as jx_save_checkpoint  # noqa: E402
from repro.configs import get_smoke_config as jx_get_smoke_config  # noqa: E402
from repro.data import tokens as jx_tokens  # noqa: E402
from repro.launch.steps import _metric_keys as jx_metric_keys  # noqa: E402
from repro.models import model as jx_model  # noqa: E402
from repro import optim as jx_optim  # noqa: E402

from repro_torch import optim as pt_optim  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticLMDataset, batch_iterator  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bshd  # noqa: E402
from repro_torch.launch import train as pt_train  # noqa: E402
from repro_torch.launch.steps import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import FailureInjector, no_host_sync  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
DENSE = ("smollm-135m", "qwen1.5-110b", "deepseek-67b")
# One small config of each other family: moe, ssm, hybrid, vlm, audio, MLA.
FAMILIES = ("moonshot-v1-16b-a3b", "mamba2-780m", "zamba2-7b", "llama-3.2-vision-90b",
            "hubert-xlarge", "minicpm3-4b")
REMATS = ("none", "full", "dots")
GRAD_TOL = 1e-5
B, S = 2, 16


def _cfgs(arch, dtype="float32", **kw):
    return (jx_get_smoke_config(arch).scaled(dtype=dtype, **kw),
            get_smoke_config(arch).scaled(dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _jx_params(arch, dtype="float32"):
    jcfg, _ = _cfgs(arch, dtype)
    params = jax.jit(jx_model.init_model, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    if "cross_layers" in params:  # init mutes the image tokens (tanh(0)); let them count
        gate = params["cross_layers"]["xattn"]["gate"]
        params["cross_layers"]["xattn"]["gate"] = jnp.full_like(gate, 0.5)
    return params


def _pt_params(arch, dtype="float32"):
    _, pcfg = _cfgs(arch, dtype)
    return params_from_numpy(jax.tree.map(np.asarray, _jx_params(arch, dtype)), pcfg, "cpu")


def _batch(cfg, step=0, b=B, s=S):
    return SyntheticLMDataset(vocab=cfg.vocab, seq_len=s, global_batch=b, seed=5,
                              family=cfg.family, d_frontend=cfg.d_frontend,
                              n_image_tokens=cfg.n_image_tokens).batch(step)


def _pt(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rel_l2(got, want) -> float:
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


@functools.lru_cache(maxsize=None)
def _jx_value_and_grad(arch, remat):
    jcfg, _ = _cfgs(arch, remat=remat)
    (loss, metrics), grads = jax.value_and_grad(jx_model.loss_fn, has_aux=True)(
        _jx_params(arch), _jx(_batch(jcfg)), jcfg)
    return float(loss), float(metrics["ce_loss"]), jax.tree.leaves(grads)


# ---------------------------------------------------------------------- data


@pytest.mark.parametrize("family", ["dense", "audio", "vlm"])
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (12345, 99)])
def test_synthetic_batches_byte_equal(family, seed, step):
    kw = dict(vocab=300, seq_len=37, global_batch=3, seed=seed, family=family,
              d_frontend=5, n_image_tokens=4)
    got = SyntheticLMDataset(**kw).batch(step)
    want = jx_tokens.SyntheticLMDataset(**kw).batch(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_batch_iterator_replays_the_reference_stream():
    kw = dict(vocab=64, seq_len=16, global_batch=2, seed=9)
    got = batch_iterator(SyntheticLMDataset(**kw), start_step=4)
    want = jx_tokens.batch_iterator(jx_tokens.SyntheticLMDataset(**kw), start_step=4)
    for _ in range(3):
        (gs, gb), (ws, wb) = next(got), next(want)
        assert gs == ws
        assert all(gb[k].tobytes() == wb[k].tobytes() for k in wb)


# ----------------------------------------------------------------- optimizer


@pytest.mark.parametrize("sched", [
    dict(peak_lr=1e-3, warmup=100, total=10000),
    dict(peak_lr=3e-3, warmup=10, total=200),
    dict(peak_lr=2.5e-4, warmup=0, total=150, floor=0.0),
])
def test_cosine_warmup_matches_reference(sched):
    steps = np.arange(301, dtype=np.int32)
    want = np.asarray([jx_optim.cosine_warmup(jnp.int32(s), **sched) for s in steps])
    by_int = np.asarray([float(pt_optim.cosine_warmup(int(s), **sched)) for s in steps])
    by_tensor = pt_optim.cosine_warmup(torch.from_numpy(steps), **sched)
    assert by_tensor.dtype == torch.float32
    np.testing.assert_allclose(by_int, want, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(by_tensor.numpy(), want, rtol=1e-6, atol=1e-12)


def _grad_trees(seed, dtype, scale):
    """Random (reference, port) gradient trees shaped like smollm's smoke params."""
    rng = np.random.default_rng(seed)
    leaves = [scale * rng.normal(size=np.shape(a)).astype(np.float32)
              for a in jax.tree.leaves(_jx_params("smollm-135m"))]
    treedef = jax.tree.structure(_jx_params("smollm-135m"))
    jg = jax.tree.unflatten(treedef, [jnp.asarray(a, dtype) for a in leaves])
    it = iter(leaves)
    pg = tree_map(lambda _: torch.from_numpy(next(it)).to(getattr(torch, dtype)),
                  _pt_params("smollm-135m"))
    return jg, pg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(dtype, max_norm):
    jg, pg = _grad_trees(1, dtype, 0.05)
    want, wnorm = jx_optim.clip_by_global_norm(jg, max_norm)
    got, gnorm = pt_optim.clip_by_global_norm(pg, max_norm)
    np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=1e-5)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32
        _close_leaf(g, w)


def _close_leaf(got: torch.Tensor, want, tol=1e-5):
    """Elementwise within ``tol``, relative, and ``tol`` of the leaf's largest
    magnitude: an element where two terms cancel keeps only the absolute
    error of its terms."""
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), w, rtol=tol, atol=tol * np.abs(w).max())


def _assert_param_close(got: torch.Tensor, want, dtype):
    if dtype == "float32":
        _close_leaf(got, want)
        return
    g = got.view(torch.int16).numpy().astype(np.int32)
    w = np.asarray(want).view(np.int16).astype(np.int32)
    assert np.abs(g - w).max() <= 1  # equal after the cast, or one ulp apart


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_matches_reference_over_three_steps(dtype, weight_decay):
    cfg_kw = dict(lr=2e-3, weight_decay=weight_decay, clip_norm=1.0)
    sched = dict(peak_lr=2e-3, warmup=1, total=50)
    jp, pp = _jx_params("smollm-135m", dtype), _pt_params("smollm-135m", dtype)
    jstate, pstate = jx_optim.adamw_init(jp), pt_optim.adamw_init(pp)
    assert pstate["step"].dtype == torch.int32 and int(pstate["step"]) == 0
    for i in range(3):
        jg, pg = _grad_trees(10 + i, dtype, 0.3)
        jlr = jx_optim.cosine_warmup(jstate["step"], **sched)
        plr = pt_optim.cosine_warmup(pstate["step"], **sched)
        jp, jstate, jm = jx_optim.adamw_update(jg, jp, jstate, jx_optim.AdamWConfig(**cfg_kw), jlr)
        pp, pstate, pm = pt_optim.adamw_update(pg, pp, pstate, pt_optim.AdamWConfig(**cfg_kw), plr)
        assert int(pstate["step"]) == int(jstate["step"]) == i + 1
        assert pstate["step"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert pm[k].dtype == torch.float32
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5)
        for g, w in zip(tree_leaves(pp), jax.tree.leaves(jp)):
            assert g.dtype == getattr(torch, dtype)
            _assert_param_close(g, w, dtype)
        for part in ("m", "v"):
            for g, w in zip(tree_leaves(pstate[part]), jax.tree.leaves(jstate[part])):
                assert g.dtype == torch.float32
                _close_leaf(g, w)


# ---------------------------------------------------------------- loss, grads


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("remat", REMATS)
def test_loss_and_grads_match_reference(arch, remat):
    jloss, jce, jgrads = _jx_value_and_grad(arch, remat)
    _, pcfg = _cfgs(arch, remat=remat)
    loss, metrics, grads = loss_and_grads(_pt_params(arch), _pt(_batch(pcfg)), pcfg)
    grads = tree_leaves(grads)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert sorted(metrics) == ["ce_loss"]
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    np.testing.assert_allclose(float(metrics["ce_loss"]), jce, rtol=1e-6)
    assert len(grads) == len(jgrads)
    for g, w in zip(grads, jgrads):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert _rel_l2(g, w) <= GRAD_TOL


def test_remat_modes_give_equal_grads():
    """Recomputation replays the same ops on the same inputs: bit-equal."""
    _, pcfg = _cfgs("qwen1.5-110b")
    params, batch = _pt_params("qwen1.5-110b"), _pt(_batch(pcfg))
    runs = [loss_and_grads(params, batch, pcfg.scaled(remat=r)) for r in REMATS]
    for loss, _, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][2])))


# ---------------------------------------------------------------- train step


def _reference_steps(arch, batches, sched, opt_kw):
    """The reference's step outside a mesh: value_and_grad(loss_fn) ->
    cosine_warmup(step) -> adamw_update, once a batch (the gradient jitted,
    as the reference's train step runs it)."""
    jcfg, _ = _cfgs(arch)
    params = _jx_params(arch)
    state = jx_optim.adamw_init(params)
    opt = jx_optim.AdamWConfig(**opt_kw)
    value_and_grad = jax.jit(jax.value_and_grad(jx_model.loss_fn, has_aux=True),
                             static_argnums=2)
    metrics = []
    for b in batches:
        (loss, m), grads = value_and_grad(params, _jx(b), jcfg)
        lr = jx_optim.cosine_warmup(state["step"], **sched)
        params, state, om = jx_optim.adamw_update(grads, params, state, opt, lr)
        metrics.append({"loss": loss, **m, **om})
    return params, state, metrics


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_train_steps_match_reference_composed_outside_a_mesh(arch):
    """Three steps: metrics within 1e-5, the moments within 1e-5 in relative
    L2 a leaf, the parameters' update (p - p0) within 1e-3. AdamW divides
    each element by its own gradient's magnitude, so an element whose
    gradient is mostly rounding moves by about lr whatever its sign: qwen's
    key bias, whose gradient softmax's shift invariance nearly cancels,
    reads 4e-4 to 7e-4 over batch seeds 5-8 (every other leaf below 1e-5).
    The families' smoke configs run the same three steps: the MoE's router
    losses and dropped fraction are metrics of the step, the audio
    encoder's loss is its masked prediction, the VLM's gates are 0.5 in
    both packages."""
    opt_kw = dict(lr=1e-3, weight_decay=0.1)
    sched = {"warmup": 1, "total": 20}
    _, pcfg = _cfgs(arch)
    batches = [_batch(pcfg, step) for step in range(3)]
    want_p, want_s, want_m = _reference_steps(
        arch, batches, {"peak_lr": opt_kw["lr"], "warmup": 1, "total": 20}, opt_kw)
    step_fn = make_train_step(pcfg, pt_optim.AdamWConfig(**opt_kw), schedule=sched)
    params = p0 = _pt_params(arch)
    state = pt_optim.adamw_init(params)
    for b, wm in zip(batches, want_m):
        params, state, metrics = step_fn(params, state, _pt(b))
        assert sorted(metrics) == sorted(jx_metric_keys(jx_get_smoke_config(arch)))
        for k, v in metrics.items():
            assert v.dim() == 0 and v.dtype == torch.float32 and not v.requires_grad, k
            np.testing.assert_allclose(float(v), float(wm[k]), rtol=1e-5, err_msg=k)
    assert int(state["step"]) == int(want_s["step"]) == 3
    for g, w, a in zip(tree_leaves(params), jax.tree.leaves(want_p), tree_leaves(p0)):
        assert _rel_l2(g - a, np.asarray(w) - a.numpy()) <= 1e-3
    for got, want in ((state["m"], want_s["m"]), (state["v"], want_s["v"])):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert _rel_l2(g, w) <= GRAD_TOL


def test_first_step_leaves_params_and_fills_moments():
    """The reference's quirk, kept: lr is 0 at step 0 under a warmup, so the
    first update only fills the moments."""
    _, pcfg = _cfgs("smollm-135m")
    params = _pt_params("smollm-135m")
    new, state, metrics = make_train_step(pcfg)(params, pt_optim.adamw_init(params),
                                                _pt(_batch(pcfg)))
    assert float(metrics["lr"]) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(params)))
    assert all(bool(m.abs().sum() > 0) for m in tree_leaves(state["m"]))


@pytest.mark.parametrize("microbatches", [2, 4])
def test_microbatches_match_full_batch(microbatches):
    """f32 gradients accumulated over slices, then one update: the moments
    (0.1 x the clipped gradient, and its square) and the metrics match one
    full batch within 1e-5."""
    _, pcfg = _cfgs("deepseek-67b")
    params, batch = _pt_params("deepseek-67b"), _pt(_batch(pcfg, b=8))
    runs = [make_train_step(pcfg, schedule={"warmup": 0}, microbatches=n)(
        params, pt_optim.adamw_init(params), batch) for n in (1, microbatches)]
    (p1, s1, m1), (pn, sn, mn) = runs
    for k in m1:
        np.testing.assert_allclose(float(mn[k]), float(m1[k]), rtol=1e-5, err_msg=k)
    for got, want in ((pn, p1), (sn["m"], s1["m"]), (sn["v"], s1["v"])):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert _rel_l2(g, w) <= GRAD_TOL
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(pcfg, microbatches=3)(params, pt_optim.adamw_init(params), batch)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_reads_nothing_back(monkeypatch, microbatches):
    monkeypatch.setenv("TCIM_CONTRACTS", "1")
    _, pcfg = _cfgs("smollm-135m", "bfloat16", remat="full")
    params = _pt_params("smollm-135m", "bfloat16")
    step_fn = make_train_step(pcfg, microbatches=microbatches)
    state = pt_optim.adamw_init(params)
    with no_host_sync():
        _, _, metrics = step_fn(params, state, _pt(_batch(pcfg)))
    assert np.isfinite(float(metrics["loss"]))


def test_flash_refuses_autograd():
    """The kernel has no backward (nor has the reference's): the entries and
    a train step through ``attention_impl="flash"`` raise, and a call that
    records no gradient still runs."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, 2, 16, generator=g) for _ in range(3))
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
    k.requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention_bshd(q, k, v, pos, pos)
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention(q[:, :, 0], k[:, :, 0], v[:, :, 0], pos, pos)
    with torch.no_grad():
        assert flash_attention_bshd(q, k, v, pos, pos).shape == q.shape
    _, pcfg = _cfgs("smollm-135m", attention_impl="flash")
    params = _pt_params("smollm-135m")
    with pytest.raises(NotImplementedError, match="no backward"):
        make_train_step(pcfg)(params, pt_optim.adamw_init(params), _pt(_batch(pcfg)))


# ---------------------------------------------------------------- TrainLoop


def test_train_loop_loss_decreases():
    """The port's counterpart of test_system::test_lm_training_loss_decreases
    (which fails on this JAX at its mesh)."""
    loop = pt_train.TrainLoop("smollm-135m", smoke=True, global_batch=4, seq=32, device="cpu",
                              opt=pt_optim.AdamWConfig(lr=3e-3, weight_decay=0.0))
    loop.run(60, log_every=20)
    losses = [m["loss"] for m in loop.metrics_log]
    assert [m["step"] for m in loop.metrics_log] == [1, 20, 40, 60]
    assert losses[-1] < losses[0] - 0.3, losses


@pytest.fixture
def one_thread():
    """Smoke configs on one torch thread: their ops are too small to share,
    and under the suite's parallel workers many threads a process contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_loop_loss_decreases(arch, one_thread):
    """Each family's smoke config trains on the synthetic stream: the mean
    of the last logged losses below the first by 0.3 (the dense bar), the
    MoE's router metrics logged beside them."""
    loop = pt_train.TrainLoop(arch, smoke=True, global_batch=4, seq=32, device="cpu",
                              opt=pt_optim.AdamWConfig(lr=3e-3, weight_decay=0.0))
    loop.run(60, log_every=10)
    losses = [m["loss"] for m in loop.metrics_log]
    assert [m["step"] for m in loop.metrics_log] == [1, 10, 20, 30, 40, 50, 60]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0] - 0.3, losses
    if loop.cfg.family == "moe":
        assert all({"moe_balance_loss", "moe_z_loss", "moe_dropped_frac"} <= set(m)
                   for m in loop.metrics_log)


@pytest.mark.parametrize("fail_at", [(17,), (13, 24)])
def test_auto_resume_is_bit_exact(tmp_path, fail_at):
    """Auto-resume after injected failures replays the uninterrupted run bit
    for bit: every logged loss and the final state."""
    common = dict(smoke=True, global_batch=2, seq=16, ckpt_every=10, device="cpu",
                  opt=pt_optim.AdamWConfig(lr=1e-3, weight_decay=0.0))
    steps = 30
    loop_a = pt_train.TrainLoop("smollm-135m", **common)
    pa, sa, _ = loop_a.run(steps, log_every=1)
    want = {m["step"]: m["loss"] for m in loop_a.metrics_log}
    loop_b = pt_train.TrainLoop("smollm-135m", ckpt_dir=str(tmp_path), **common)
    (pb, sb, _), restarts = pt_train.run_with_auto_resume(
        loop_b, steps, FailureInjector(fail_at_steps=fail_at))
    assert restarts == len(fail_at)
    # Steps 1, 10, 20, 30, and each restart's first: the step after the
    # checkpoint before its failure (a save in flight is joined first).
    restarted = [f // 10 * 10 + 1 for f in fail_at]
    assert [m["step"] for m in loop_b.metrics_log] == sorted([1, 10, 20, 30, *restarted])
    assert all(m["loss"] == want[m["step"]] for m in loop_b.metrics_log)
    for a, b in zip(tree_leaves({"p": pa, "s": sa}), tree_leaves({"p": pb, "s": sb})):
        assert torch.equal(a, b)
    assert loop_b.ckpt.latest_step() == steps


def test_moe_auto_resume_is_bit_exact(tmp_path, one_thread):
    """The MoE's routing is discrete: a resumed run replays the
    uninterrupted run's losses, router metrics and state bit for bit."""
    common = dict(smoke=True, global_batch=2, seq=16, ckpt_every=10, device="cpu",
                  opt=pt_optim.AdamWConfig(lr=1e-3, weight_decay=0.0))
    loop_a = pt_train.TrainLoop("moonshot-v1-16b-a3b", **common)
    pa, sa, _ = loop_a.run(30, log_every=1)
    want = {m["step"]: m for m in loop_a.metrics_log}
    loop_b = pt_train.TrainLoop("moonshot-v1-16b-a3b", ckpt_dir=str(tmp_path), **common)
    (pb, sb, _), restarts = pt_train.run_with_auto_resume(
        loop_b, 30, FailureInjector(fail_at_steps=(13, 24)))
    assert restarts == 2
    assert [m["step"] for m in loop_b.metrics_log] == [1, 10, 11, 20, 21, 30]
    assert all(m == want[m["step"]] for m in loop_b.metrics_log)
    assert all("moe_dropped_frac" in m for m in loop_b.metrics_log)
    for a, b in zip(tree_leaves({"p": pa, "s": sa}), tree_leaves({"p": pb, "s": sb})):
        assert torch.equal(a, b)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_train_checkpoints_load_across_packages(tmp_path, writer):
    """A train state saved by either package restores in the other, bit for
    bit (the port keeps the reference's on-disk layout)."""
    jcfg, pcfg = _cfgs("smollm-135m", "bfloat16")
    jp = _jx_params("smollm-135m", "bfloat16")
    jstate = {"params": jp, "opt": jx_optim.adamw_init(jp)}
    loop = pt_train.TrainLoop("smollm-135m", smoke=True, device="cpu", ckpt_dir=str(tmp_path))
    if writer == "reference":
        jx_save_checkpoint(tmp_path, 7, jstate)
        params, opt, step = loop.restore_or_init()
        assert step == 7 and opt["step"].dtype == torch.int32
        got = {"params": params, "opt": opt}
        for g, w in zip(tree_leaves(got), jax.tree.leaves(jstate)):
            assert g.dtype == getattr(torch, str(w.dtype))
            assert g.float().numpy().tobytes() == np.asarray(w, np.float32).tobytes()
    else:
        params = _pt_params("smollm-135m", "bfloat16")
        loop.ckpt.save(7, {"params": params, "opt": pt_optim.adamw_init(params)})
        got, step, _ = jx_load_checkpoint(tmp_path, jstate)
        assert step == 7
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(np.asarray(g, np.float32), np.asarray(w, np.float32))


@pytest.mark.parametrize("shape", [(), (1,), (2, 3)])
def test_stage_keeps_the_array_shape(shape):
    """A restored optimizer step is a 0-d array: staging keeps it 0-d
    (``np.ascontiguousarray`` alone would make it 1-d)."""
    from repro_torch.runtime.staging import stage

    a = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
    for arr in (a, a.T.copy().T):  # C and Fortran order
        t = stage(arr, "cpu")
        assert tuple(t.shape) == shape and t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), a)


def test_train_loop_refuses_a_mesh():
    """A mesh trains since the sharding slice (tests/test_torch_sharded_train.py);
    what is not the port's ``Mesh``, or a device of another kind than the
    mesh's, is refused."""
    from repro_torch.launch.mesh import make_host_mesh

    with pytest.raises(TypeError, match="repro_torch.distributed.Mesh"):
        pt_train.TrainLoop("smollm-135m", smoke=True, device="cpu", mesh=object())
    mesh = make_host_mesh(2, 1, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="not of the mesh's kind"):
        pt_train.TrainLoop("smollm-135m", smoke=True, device="cuda", mesh=mesh)
    assert pt_train.TrainLoop("smollm-135m", smoke=True, mesh=mesh).device == torch.device("cpu")


def test_train_cli_resumes_after_an_injected_failure(tmp_path, capsys):
    assert pt_train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "12",
                          "--global-batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
                          "--ckpt-every", "4", "--fail-at", "6", "--microbatches", "2"]) == 0
    out = capsys.readouterr().out
    assert "restarts=1" in out and "loss: first=" in out


def test_train_modules_import_no_jax_and_nothing_of_repro():
    code = (
        "import sys\n"
        "import repro_torch.data.tokens, repro_torch.optim, repro_torch.optim.adamw\n"
        "import repro_torch.optim.schedule, repro_torch.launch.train\n"
        "from repro_torch.models.model import loss_fn\n"
        "from repro_torch.models import moe, ssm\n"
        "from repro_torch.launch.steps import make_train_step\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env={"PYTHONPATH": str(SRC), "PATH": ""},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
