"""Tensor-parallel compute of the audio encoder (hubert-xlarge) on logical CPU meshes.

hubert-xlarge's smoke config (4 heads of 16, d_model 64, d_ff 128, vocab
64, 2 layers, non-causal) pinned ``parallelism="tp"`` runs its forward on
(1, 2), (2, 2) and (1, 4): each position gathers over 'data' only, into its
'model' block of the frame projection's, wq/wk/wv's and the MLP's columns,
wo's rows and lm_head's vocab, the norms whole
(``distributed/tensor_parallel.py``). Two entries run it:

  * the prefill step, ``launch/steps.py::make_prefill_step(cfg, mesh)``
    (``models/model.py::prefill_placed_tp``): the last frame's logits, no
    cache. A batch of ``frames`` alone serves on both paths; before, the
    step read the training loss's mask (``KeyError: 'mask'``) and then
    refused a cacheless family;
  * the train step, ``make_train_step(cfg, mesh=)``
    (``launch/steps.py::_tp_shard_grads``): ``models/model.py::loss_tp``
    under autograd on each shard's blocks as leaves, each shard's gradient
    of its model block reduced into the gradient spec's blocks.

The oracle is the reference outside a mesh (its sharded steps fail on this
JAX): ``forward_prefill`` and ``forward_train`` for the forward,
``jax.value_and_grad(loss_fn)`` for the gradients (each microbatch's, then
their mean, as its microbatched step takes them), on the same parameters,
converted bit for bit by ``params_from_numpy``. Tolerances: the prefill and
the full-frame logits 1e-5 relative norm in float32, 3e-2 in bfloat16; the
gathered path ("dp" pinned, or a 'model' axis of 3 that does not divide the
4 heads) 1e-5 of the tensor-parallel path; float32 gradients 1e-5 relative
L2 a leaf and the loss 1e-5 relative (summation order only); a whole step's
params and moments 1e-5 of the one-device step's. A position gathers at
most 0.55 of the tree on 2 x 2. A shard attending to its neighbour's heads,
a reduction that drops the last shard's partial and a shard's gradient
reduced into its neighbour's model block must each fail its rule.
"""
import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jx_get_smoke_config  # noqa: E402
from repro.models import model as jx_model  # noqa: E402
from repro_torch import optim as pt_optim  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.lm_sharding import (  # noqa: E402
    batch_spec_tree,
    named_tree,
    train_state_specs,
)
from repro_torch.distributed.sharding import gather_tree, place_tree  # noqa: E402
from repro_torch.launch import steps as pt_steps  # noqa: E402
from repro_torch.launch.dryrun import DuckMesh  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models import model as pt_model  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves  # noqa: E402

CPU = torch.device("cpu")
ARCH = "hubert-xlarge"
MESHES = ((1, 2), (2, 2), (1, 4))
B, S = 4, 16
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
PATH_TOL = 1e-5
GRAD_TOL = 1e-5
BYTES_SHARE = 0.55
OPT = pt_optim.AdamWConfig(lr=1e-3, weight_decay=0.0)
# 'model' 3 divides every leaf it splits (the frame projection's, wq/wk/wv's
# and the MLP's columns, wo's rows, the vocab) but not the 4 heads
UNEVEN = (("d_ff", 96), ("d_frontend", 24), ("d_model", 48), ("head_dim", 12), ("vocab", 48))


def _mesh(data, model):
    return make_host_mesh(data, model, devices=[CPU] * (data * model))


def _rel(a, b) -> float:
    a = torch.as_tensor(np.asarray(a, np.float32)) if not isinstance(a, torch.Tensor) else a
    b = torch.as_tensor(np.asarray(b, np.float32)) if not isinstance(b, torch.Tensor) else b
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _cfg(dtype, kw=(), **extra):
    """(reference config, port config) pinned to the "tp" profile; ``kw``
    replaces more fields (both), ``extra`` the port's alone."""
    kw = dict(kw)
    return (jx_get_smoke_config(ARCH).scaled(dtype=dtype, parallelism="tp", **kw),
            get_smoke_config(ARCH).scaled(dtype=dtype, parallelism="tp", **kw, **extra))


@functools.lru_cache(maxsize=None)
def _params(dtype, kw=()):
    """(reference params, port params): the same numbers in both packages
    (bf16: the float32 init cast to the reference's bf16 init's dtypes)."""
    jcfg, pcfg = _cfg(dtype, kw)
    if dtype == "float32":
        jp = jx_model.init_model(jax.random.PRNGKey(0), jcfg)
    else:
        shapes = jax.eval_shape(lambda: jx_model.init_model(jax.random.PRNGKey(0), jcfg))
        jp = jax.tree.map(lambda a, s: a.astype(s.dtype), _params("float32", kw)[0], shapes)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, "cpu")


def _frames(cfg):
    return np.random.default_rng(1).normal(size=(B, S, cfg.d_frontend)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(dtype, kw=()):
    """The reference's (last logits [B, V], full logits [B, S, V])."""
    jcfg, _ = _cfg(dtype, kw)
    params, _ = _params(dtype, kw)
    batch = {"frames": jnp.asarray(_frames(jcfg))}
    last, _ = jx_model.forward_prefill(params, batch, {}, jcfg)
    full, _ = jx_model.forward_train(params, batch, jcfg)
    return np.asarray(last, np.float32), np.asarray(full, np.float32)


def _prefill(cfg, params, mesh):
    """The sharded prefill step on a batch of ``frames`` alone."""
    logits, cache = pt_steps.make_prefill_step(cfg, mesh)(
        params, {}, {"frames": torch.from_numpy(_frames(cfg))})
    assert cache == {}
    return logits


def _blocks(cfg, params, mesh):
    return pt_steps.gather_params(pt_steps.place_params(cfg, mesh, params), mesh, cfg)


def _vocab(x, cfg):
    return x[..., :cfg.vocab]


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_prefill_and_full_logits_match_the_reference(mesh_shape, dtype):
    """The prefill step's last logits against the reference's
    ``forward_prefill``, ``forward_tp``'s full-frame logits against its
    ``forward_train``: each position computes with its 'model' blocks
    (``ModelBlocks``), at most 0.55 of the tree on 2 x 2."""
    _, cfg = _cfg(dtype)
    _, params = _params(dtype)
    mesh = _mesh(*mesh_shape)
    assert tp.serves_tensor_parallel(cfg, mesh) and tp.trains_tensor_parallel(cfg, mesh)
    want_last, want_full = _reference(dtype)
    got = _prefill(cfg, params, mesh)
    assert got.dtype == torch.float32 and got.shape == (B, cfg.padded_vocab)
    assert _rel(_vocab(got, cfg), want_last[:, :cfg.vocab]) <= TOL[dtype]
    blocks = _blocks(cfg, params, mesh)
    assert isinstance(blocks, tp.ModelBlocks)
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    share = max(blocks.bytes_by_position.values()) / whole
    assert share <= BYTES_SHARE or mesh_shape[1] == 1, share
    full = pt_steps.make_forward_step(cfg, mesh)(blocks,
                                                 {"frames": torch.from_numpy(_frames(cfg))})
    assert full.shape == (B, S, cfg.padded_vocab)
    assert _rel(_vocab(full, cfg), want_full[..., :cfg.vocab]) <= TOL[dtype]
    assert _rel(full[:, -1, :cfg.vocab], _vocab(got, cfg)) <= TOL[dtype]


def test_prefill_of_frames_alone_runs_on_both_paths():
    """The repaired fault: ``make_prefill_step(cfg, mesh)`` on a batch of
    ``frames`` alone, on the tensor-parallel path (2 x 2) and on the
    gathered one ("dp" pinned), each shard weighing 1 / n: both equal the
    one-device step. The parent raised ``KeyError: 'mask'`` on both."""
    _, cfg = _cfg("float32")
    _, params = _params("float32")
    frames = torch.from_numpy(_frames(cfg))
    want, _ = pt_steps.make_prefill_step(cfg)(params, {}, {"frames": frames})
    for c in (cfg, cfg.scaled(parallelism="dp")):
        mesh = _mesh(2, 2)
        got = _prefill(c, params, mesh)
        assert isinstance(_blocks(c, params, mesh), tp.ModelBlocks) == (c is cfg)
        assert _rel(got, want) <= PATH_TOL
        shards = pt_steps._dp_shards(c, place_tree({"frames": frames}, named_tree(
            mesh, batch_spec_tree(c, mesh, {"frames": frames}))), 1)
        assert [w for w, _, _, _ in shards] == [1.0 / len(shards)] * len(shards)


def test_gathered_path_matches_the_tensor_parallel_path():
    """The gathered path, on a "dp"-pinned config and on a mesh whose
    'model' size (3) does not divide the 4 heads (a config whose split
    leaves 3 divides), within 1e-5 of the tensor-parallel path's logits:
    the last ones and ``make_forward_step``'s full-frame ones (one device's
    ``forward_train`` without a mesh)."""
    _, cfg = _cfg("float32")
    _, params = _params("float32")
    tp_logits = _prefill(cfg, params, _mesh(1, 2))
    dp = cfg.scaled(parallelism="dp")
    assert not tp.serves_tensor_parallel(dp, _mesh(1, 2))
    assert _rel(_prefill(dp, params, _mesh(1, 2)), tp_logits) <= PATH_TOL
    batch = {"frames": torch.from_numpy(_frames(cfg))}
    full = {c.parallelism: pt_steps.make_forward_step(c, _mesh(1, 2))(
        _blocks(c, params, _mesh(1, 2)), batch) for c in (cfg, dp)}
    one = pt_steps.make_forward_step(cfg)(params, batch)
    assert full["tp"].shape == full["dp"].shape == one.shape == (B, S, cfg.padded_vocab)
    assert _rel(full["dp"], full["tp"]) <= PATH_TOL and _rel(one, full["tp"]) <= PATH_TOL
    _, uneven = _cfg("float32", UNEVEN)
    _, p3 = _params("float32", UNEVEN)
    three = _mesh(1, 3)
    assert not tp.serves_tensor_parallel(uneven, three)
    assert not tp.trains_tensor_parallel(uneven, three)
    assert isinstance(_blocks(uneven, p3, three), pt_steps.GatheredParams)
    gathered = _prefill(uneven, p3, three)
    assert _rel(gathered, _prefill(uneven, p3, _mesh(1, 2))) <= PATH_TOL
    want_last, _ = _reference("float32", UNEVEN)
    assert _rel(_vocab(gathered, uneven), want_last[:, :uneven.vocab]) <= TOL["float32"]


def test_flash_launches_on_each_shards_heads_not_causal(monkeypatch):
    """Under "flash" each model shard attends with its own heads, non-causal,
    at Sk = Sq: (data shards x model shards x layers) launches on 2 x 2,
    each on 2 of the 4 query and KV heads; the logits within 1e-5 of the
    "xla" path's (the plain version on the CPU)."""
    _, cfg = _cfg("float32", attention_impl="flash")
    _, params = _params("float32")
    seen = []
    real = pt_layers.flash_attention_bshd

    def spy(q, k, v, *args, **kwargs):
        seen.append((q.shape[2], k.shape[2], k.shape[1], bool(kwargs.get("causal"))))
        return real(q, k, v, *args, **kwargs)

    monkeypatch.setattr(pt_layers, "flash_attention_bshd", spy)
    got = _prefill(cfg, params, _mesh(2, 2))
    assert seen == [(2, 2, S, False)] * (2 * 2 * cfg.n_layers)
    assert _rel(got, _prefill(cfg.scaled(attention_impl="xla"), params, _mesh(2, 2))) <= PATH_TOL


@contextlib.contextmanager
def _neighbour_heads():
    """A planted fault: in ``_tp_attention`` each model shard takes its
    neighbour's K/V heads for its own queries (``head_range`` shifted)."""
    real_attention, real_range = pt_model._tp_attention, tp.head_range

    def shifted(cfg, j, m):
        return real_range(cfg, (j + 1) % m, m)

    def attention(*args, **kwargs):
        tp.head_range = shifted
        try:
            return real_attention(*args, **kwargs)
        finally:
            tp.head_range = real_range

    pt_model._tp_attention = attention
    try:
        yield
    finally:
        pt_model._tp_attention = real_attention


def test_planted_forward_faults_fail_the_rule(monkeypatch):
    """A shard attending to its neighbour's heads, and a reduction that
    drops the last shard's partial, each land outside the float32 bound."""
    _, cfg = _cfg("float32")
    _, params = _params("float32")
    want_last, _ = _reference("float32")
    with _neighbour_heads():
        bad = _prefill(cfg, params, _mesh(2, 2))
    assert _rel(_vocab(bad, cfg), want_last[:, :cfg.vocab]) > 100 * TOL["float32"]
    real = tp.reduce_f32
    monkeypatch.setattr(tp, "reduce_f32", lambda parts, dev, dt: real(parts[:-1], dev, dt))
    bad = _prefill(cfg, params, _mesh(1, 2))
    assert _rel(_vocab(bad, cfg), want_last[:, :cfg.vocab]) > 100 * TOL["float32"]


# ------------------------------------------------------------------- train


def _batch(cfg, b=B, zero_rows=()):
    batch = SyntheticLMDataset(vocab=cfg.vocab, seq_len=S, global_batch=b, seed=5, family="audio",
                               d_frontend=cfg.d_frontend).batch(0)
    for r in zero_rows:
        batch["mask"][r] = False
    return batch


@functools.lru_cache(maxsize=None)
def _jx_value_and_grad(microbatches, zero_rows=()):
    """The reference's loss and gradient leaves: ``jax.value_and_grad`` of
    ``loss_fn`` on each microbatch's rows, their mean."""
    jcfg, _ = _cfg("float32")
    params, _ = _params("float32")
    batch = _batch(jcfg, zero_rows=zero_rows)
    runs = []
    for part in np.array_split(np.arange(B), microbatches):
        (loss, _), grads = jax.value_and_grad(jx_model.loss_fn, has_aux=True)(
            params, {k: jnp.asarray(v[part]) for k, v in batch.items()}, jcfg)
        runs.append((float(loss), [np.asarray(g, np.float64) for g in jax.tree.leaves(grads)]))
    return (sum(r[0] for r in runs) / microbatches,
            [sum(gs) / microbatches for gs in zip(*(r[1] for r in runs))])


def _sharded_grads(cfg, params, mesh, batch, microbatches=1):
    pspecs, _, gspecs = train_state_specs(cfg)
    placed = place_tree(params, named_tree(mesh, pspecs))
    bp = place_tree({k: torch.from_numpy(v) for k, v in batch.items()},
                    named_tree(mesh, batch_spec_tree(cfg, mesh, batch)))
    return pt_steps.sharded_loss_and_grads(placed, bp, cfg, named_tree(mesh, gspecs),
                                           microbatches)


def _grad_errors(grads, want) -> list:
    return [_rel(g.full(CPU), w) for g, w in zip(tree_leaves(grads), want, strict=True)]


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tensor_parallel_gradients_match_jax(mesh_shape, microbatches):
    """The TP train step's loss and every float32 gradient leaf against
    ``jax.value_and_grad`` of the reference's ``loss_fn``; the norms'
    gradients are the home's alone (the other shards do not use them)."""
    jcfg, cfg = _cfg("float32")
    _, params = _params("float32")
    mesh = _mesh(*mesh_shape)
    want_loss, want = _jx_value_and_grad(microbatches)
    loss, metrics, grads = _sharded_grads(cfg, params, mesh, _batch(jcfg), microbatches)
    assert abs(float(loss) - want_loss) <= GRAD_TOL * abs(want_loss)
    assert set(metrics) == {"ce_loss"} and float(metrics["ce_loss"]) == float(loss)
    errs = _grad_errors(grads, want)
    assert max(errs) <= GRAD_TOL, errs
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))


def test_a_shard_whose_mask_is_all_zero():
    """Rows 2-3 (the second data shard on 2 x 2) mask nothing: that shard
    weighs 0 and its loss (0 / 1) adds nothing; the loss and gradients are
    the reference's on the whole batch."""
    jcfg, cfg = _cfg("float32")
    _, params = _params("float32")
    want_loss, want = _jx_value_and_grad(1, zero_rows=(2, 3))
    loss, _, grads = _sharded_grads(cfg, params, _mesh(2, 2), _batch(jcfg, zero_rows=(2, 3)))
    assert abs(float(loss) - want_loss) <= GRAD_TOL * abs(want_loss)
    assert max(_grad_errors(grads, want)) <= GRAD_TOL


def test_planted_gradient_fault_fails_the_rule(monkeypatch):
    """Each shard's gradient reduced into its neighbour's model block (the
    shards' gradients rotated before ``_model_block_grad`` picks the one
    whose block holds a region) lands far outside 1e-5."""
    jcfg, cfg = _cfg("float32")
    _, params = _params("float32")
    _, want = _jx_value_and_grad(1)
    real = pt_steps._model_block_grad
    monkeypatch.setattr(pt_steps, "_model_block_grad",
                        lambda grads, leaf, region: real(grads[1:] + grads[:1], leaf, region))
    _, _, grads = _sharded_grads(cfg, params, _mesh(2, 2), _batch(jcfg))
    assert max(_grad_errors(grads, want)) > 1e3 * GRAD_TOL


def test_whole_step_matches_the_one_device_step():
    """Two ``make_train_step(mesh=)`` steps on 2 x 2 against the one-device
    step: losses 1e-5 relative, params and moments 1e-5; the state stays
    placed as ``train_state_specs`` places it."""
    jcfg, cfg = _cfg("float32")
    _, params = _params("float32")
    mesh = _mesh(2, 2)
    pspecs, ospecs, _ = train_state_specs(cfg)
    one = pt_steps.make_train_step(cfg, OPT)
    sharded = pt_steps.make_train_step(cfg, OPT, mesh=mesh)
    p1, o1 = params, pt_optim.adamw_init(params)
    p2 = place_tree(params, named_tree(mesh, pspecs))
    o2 = place_tree(pt_optim.adamw_init(params), named_tree(mesh, ospecs))
    for step in range(2):
        batch = {k: torch.from_numpy(v) for k, v in SyntheticLMDataset(
            vocab=cfg.vocab, seq_len=S, global_batch=B, seed=5, family="audio",
            d_frontend=cfg.d_frontend).batch(step).items()}
        p1, o1, m1 = one(p1, o1, batch)
        p2, o2, m2 = sharded(p2, o2, batch)
        assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-5 * abs(float(m1["loss"]))
        assert abs(float(m2["grad_norm"]) - float(m1["grad_norm"])) <= 1e-5 * float(
            m1["grad_norm"])
    for a, b in zip(tree_leaves(p1), tree_leaves(gather_tree(p2, CPU)), strict=True):
        assert float((a - b).abs().max()) <= 1e-5
    for part in ("m", "v"):
        for a, b in zip(tree_leaves(o1[part]), tree_leaves(o2[part]), strict=True):
            assert float((a - b.full(CPU)).abs().max()) <= 1e-5
    assert all(t.sharding.same_blocks(sh, t.ndim) for t, sh in
               zip(tree_leaves(p2), tree_leaves(named_tree(mesh, pspecs))))


def test_bf16_step_runs_and_stays_near_one_device():
    """A bf16 step on 2 x 2: finite loss and gradient norm, the loss 3e-2
    of the one-device step's (the differentiable float32 partials of wo
    and the MLP, ``layers.matmul_f32``, under autograd)."""
    _, cfg = _cfg("bfloat16")
    _, params = _params("bfloat16")
    mesh = _mesh(2, 2)
    pspecs, ospecs, _ = train_state_specs(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    _, _, m1 = pt_steps.make_train_step(cfg, OPT)(params, pt_optim.adamw_init(params), batch)
    _, _, m2 = pt_steps.make_train_step(cfg, OPT, mesh=mesh)(
        place_tree(params, named_tree(mesh, pspecs)),
        place_tree(pt_optim.adamw_init(params), named_tree(mesh, ospecs)), batch)
    assert np.isfinite(float(m2["loss"])) and np.isfinite(float(m2["grad_norm"]))
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= TOL["bfloat16"] * abs(float(m1["loss"]))


def test_which_configs_train_tensor_parallel():
    """``trains_tensor_parallel``: hubert-xlarge on the production meshes
    (16 heads, one a shard) and on 2 x 2; no other family, and no
    "dp"-pinned or smoke ("auto": 4 heads -> "dp") audio config."""
    from repro_torch.configs import ARCHS

    meshes = (DuckMesh((16, 16), ("data", "model")), DuckMesh((2, 16, 16), ("pod", "data", "model")),
              DuckMesh((2, 2), ("data", "model")))
    for arch in ARCHS:
        assert all(tp.trains_tensor_parallel(get_config(arch), m) == (arch == ARCH)
                   for m in meshes), arch
    assert all(tp.serves_tensor_parallel(get_config(ARCH), m) for m in meshes)
    assert not tp.trains_tensor_parallel(get_config(ARCH).scaled(parallelism="dp"), meshes[0])
    assert not tp.trains_tensor_parallel(get_smoke_config(ARCH), meshes[2])
