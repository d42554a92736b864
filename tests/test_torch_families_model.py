"""Port vs reference: every arch's model on its smoke config.

For each of the ten archs, the port's ``forward_train``, ``loss_fn`` with its
metrics (moe: the router's aux losses; audio: the masked loss) and the
gradients of ``loss_fn`` (autograd under ``remat`` none and full, "dots"
equal to "none" on the nested and shared structures) are held against the
JAX package on parameters made by the reference's ``init_model`` and
converted bit for bit by ``params_from_numpy`` (round trip checked for the
families' trees), and ``count_params_analytical`` against the reference's
on the full configs. The reference runs outside any mesh (its sharding
constraints are then the identity), as ``tests/test_torch_lm.py`` runs it.

Tolerances: float32 1e-4 on logits (summation order only), bfloat16 3e-2;
the loss 1e-6 relative in float32, 1e-3 in bfloat16; gradients 1e-5 in
relative L2 a leaf, the bound ``tests/test_torch_train.py`` holds the dense
archs to. The modules are in ``tests/test_torch_families.py``, serving in
``tests/test_torch_families_serve.py``.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jx_get_config  # noqa: E402
from repro.configs import get_smoke_config as jx_get_smoke_config  # noqa: E402
from repro.models import model as jx_model  # noqa: E402

from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import model as pt_model  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves  # noqa: E402

DTYPES = ("float32", "bfloat16")
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
GRAD_TOL = 1e-5
B, S = 2, 16


def _cfg(arch, dtype="float32", **kw):
    return (jx_get_smoke_config(arch).scaled(dtype=dtype, **kw),
            get_smoke_config(arch).scaled(dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype="float32"):
    """(reference params, port params): the same numbers in both packages."""
    jcfg, pcfg = _cfg(arch, dtype)
    jp = jx_model.init_model(jax.random.PRNGKey(0), jcfg)
    if "cross_layers" in jp:  # init mutes the image tokens (tanh(0)); let them count
        jp["cross_layers"]["xattn"]["gate"] = jnp.full_like(jp["cross_layers"]["xattn"]["gate"], 0.5)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, "cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _rel_l2(got, want) -> float:
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _batch(cfg, b=B, s=S, seed=0):
    """tests/test_models.py's batch of a family, as numpy arrays."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(b, s, cfg.d_frontend)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
                "mask": rng.random((b, s)) < 0.3}
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(b, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)
    return batch


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# --------------------------------------------------------- model, per arch


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_train_and_loss_match_reference(arch, dtype):
    jcfg, pcfg = _cfg(arch, dtype)
    jp, pp = _params(arch, dtype)
    batch = _batch(jcfg)
    want, want_aux = jx_model.forward_train(jp, _jx(batch), jcfg)
    got, aux = pt_model.forward_train(pp, _pt(batch), pcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want, LOGIT_TOL[dtype])
    assert sorted(aux) == sorted(want_aux)
    wloss, wmetrics = jx_model.loss_fn(jp, _jx(batch), jcfg)
    loss, metrics = pt_model.loss_fn(pp, _pt(batch), pcfg)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert sorted(metrics) == sorted(wmetrics)
    rtol = 1e-6 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(float(loss), float(wloss), rtol=rtol)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(wmetrics[k]), rtol=rtol, atol=rtol, err_msg=k)
    if jcfg.family == "moe":
        assert float(metrics["moe_dropped_frac"]) == 0.0  # drop-free smoke capacity
        assert float(loss) > float(metrics["ce_loss"])


@functools.lru_cache(maxsize=None)
def _jx_value_and_grad(arch):
    jcfg, _ = _cfg(arch)
    (loss, _), grads = jax.value_and_grad(jx_model.loss_fn, has_aux=True)(
        _params(arch)[0], _jx(_batch(jcfg)), jcfg)
    return float(loss), jax.tree.leaves(grads)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_grads_match_reference(arch, remat):
    """Autograd of the port's ``loss_fn`` (each family's layers, groups and
    shared block under ``_remat``) against ``jax.value_and_grad``."""
    jloss, jgrads = _jx_value_and_grad(arch)
    _, pcfg = _cfg(arch, remat=remat)
    loss, _, grads = loss_and_grads(_params(arch)[1], _pt(_batch(pcfg)), pcfg)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    grads = tree_leaves(grads)
    assert len(grads) == len(jgrads)
    for g, w in zip(grads, jgrads):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert _rel_l2(g, w) <= GRAD_TOL


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "zamba2-7b", "moonshot-v1-16b-a3b"])
def test_remat_dots_grads_equal_none(arch):
    """``remat="dots"`` (nested in the VLM's groups) replays the same ops."""
    _, pcfg = _cfg(arch)
    params, batch = _params(arch)[1], _pt(_batch(pcfg))
    ref = loss_and_grads(params, batch, pcfg.scaled(remat="none"))
    got = loss_and_grads(params, batch, pcfg.scaled(remat="dots"))
    assert torch.equal(got[0], ref[0])
    for a, b in zip(tree_leaves(got[2]), tree_leaves(ref[2])):
        assert torch.equal(a, b)


# A leaf of each family's own subtree, cut short to check that
# params_from_numpy names where a tree departs from the schema.
BAD_LEAF = {"vlm": ("cross_layers", "xattn", "gate"), "hybrid": ("shared", "mlp", "wo"),
            "moe": ("layers", "moe", "router"), "ssm": ("layers", "ssm", "a_log"),
            "audio": ("frontend",), "dense": ("layers", "attn", "wuk")}


@pytest.mark.parametrize("arch", [a for a in ARCHS if get_config(a).family != "dense"
                                  or get_config(a).attention != "gqa"])
def test_params_from_numpy_round_trips_families(arch):
    """Bit for bit, the nested ``[G, per, ...]`` vlm stacks, the hybrid's
    shared block and the float32 SSM leaves of a bf16 tree included."""
    jp, pp = _params(arch, "bfloat16")
    jl, pl = jax.tree.leaves(jp), tree_leaves(pp)
    assert len(jl) == len(pl)
    for a, t in zip(jl, pl):
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape and str(t.dtype).split(".")[1] == str(a.dtype)
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    _, pcfg = _cfg(arch, "bfloat16")
    bad = jax.tree.map(np.asarray, jp)
    *path, leaf = BAD_LEAF[pcfg.family]
    node = bad
    for k in path:
        node = node[k]
    node[leaf] = node[leaf][..., :-1]
    with pytest.raises(ValueError, match=leaf):
        params_from_numpy(bad, pcfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_analytical_matches_reference(arch):
    """Full configs, counted from the schema (never materialised), with and
    without ``active_only``; the smoke configs' equal to their trees."""
    for active in (False, True):
        want = jx_model.count_params_analytical(jx_get_config(arch), active_only=active)
        assert pt_model.count_params_analytical(get_config(arch), active_only=active) == want
    cfg = get_config(arch)
    assert cfg.param_count() == jx_get_config(arch).param_count()
    assert cfg.active_param_count() == jx_get_config(arch).active_param_count()
    if cfg.family == "moe":
        assert cfg.active_param_count() < cfg.param_count()
    else:
        assert cfg.active_param_count() == cfg.param_count()
    smoke = get_smoke_config(arch)
    params = pt_model.init_model(0, smoke, "cpu")
    assert sum(t.numel() for t in tree_leaves(params)) == pt_model.count_params_analytical(smoke)


def test_family_counts_match_reference():
    for get, jx_get in ((get_config, jx_get_config), (get_smoke_config, jx_get_smoke_config)):
        assert pt_model.vlm_counts(get("llama-3.2-vision-90b")) == jx_model.vlm_counts(
            jx_get("llama-3.2-vision-90b"))
        assert pt_model.hybrid_counts(get("zamba2-7b")) == jx_model.hybrid_counts(
            jx_get("zamba2-7b"))
    assert pt_model.hybrid_counts(get_config("zamba2-7b")) == (13, 3)
    assert pt_model.vlm_counts(get_config("llama-3.2-vision-90b")) == (20, 4, 20)
