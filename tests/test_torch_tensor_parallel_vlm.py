"""Tensor-parallel serving of the VLM (llama-3.2-vision-90b) on logical CPU meshes.

The VLM's smoke config (4 heads, 2 KV heads, hd 16, 4 layers in 2 groups of
one self and one gated cross-attention layer, 8 image tokens) pinned
``parallelism="tp"`` serves through ``ServeSession(mesh=)`` on (1, 2), (2,
2) and (1, 4): each position gathers over 'data' only, into its 'model'
block of every leaf whose spec has 'model' (the self and cross layers'
wq/wk/wv and MLP columns, wo rows, ``img_proj``'s columns, the vocab
blocks), and computes its heads, columns and vocab block
(``models/model.py::prefill_placed_tp``, ``decode_placed_tp``). On (1, 4)
each shard holds one query head, and two shards share a KV head. The image
tokens are projected by column blocks once a prefill; a cross layer's K/V
heads are not roped, its attention is non-causal at ``n_image_tokens`` keys,
and its reduced output is gated on the home. The cross gates are 0.5 in
both packages (init leaves them at 0, where ``tanh(0)`` would mute every
cross layer and hide a fault there); the image embeddings come from a numpy
seed.

The oracle is the reference's greedy loop outside a mesh (``init_cache`` ->
``forward_prefill`` -> ``decode_step`` x n -> argmax) on the same
parameters, converted bit for bit by ``params_from_numpy``. Tolerances, as
``tests/test_torch_tensor_parallel.py``'s: float32 equal greedy tokens and
1e-4 on the logits; bfloat16 3e-2, both packages fed the reference's greedy
tokens; against the port's gathered path on the same mesh 1e-5 relative
norm (float32), each decode step run from a copy of the gathered session's
cache, whose bf16 leaves the two paths may round one bf16 step apart in at
most 0.1 % of their elements (then the step's logits are held to 1e-4).
A shard that takes its neighbour's KV heads of the image K/V in the cross
layers only, and a reduction that drops the last shard's partial, must be
seen.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_smoke_config as jx_get_smoke_config  # noqa: E402
from repro.distributed import lm_sharding as ref_lms  # noqa: E402
from repro.models import model as jx_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.sharding import ShardedTensor  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.launch import steps as pt_steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models import model as pt_model  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves  # noqa: E402

CPU = torch.device("cpu")
ARCH = "llama-3.2-vision-90b"
MESHES = ((1, 2), (2, 2), (1, 4))
B, PLEN, GEN = 4, 16, 6
MAX_SEQ = PLEN + GEN + 2  # splits over a 'model' axis of 2 or 4
GATE = 0.5
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PATH_TOL = 1e-5
MODEL_LEAVES = {"tok_embed", "lm_head", "img_proj"} | {
    f"{stack}/{block}/{w}" for stack, block, ws in (
        ("layers", "attn", ("wq", "wk", "wv", "wo")), ("layers", "mlp", ("wi_gate", "wi_up", "wo")),
        ("cross_layers", "xattn", ("wq", "wk", "wv", "wo")),
        ("cross_layers", "mlp", ("wi_gate", "wi_up", "wo")))
    for w in ws}


def _cfg(dtype, impl="flash"):
    """(reference config, port config), pinned to the "tp" profile; the
    reference attends by its XLA path."""
    return (jx_get_smoke_config(ARCH).scaled(dtype=dtype, parallelism="tp"),
            get_smoke_config(ARCH).scaled(dtype=dtype, parallelism="tp", attention_impl=impl))


@functools.lru_cache(maxsize=None)
def _params(dtype):
    """(reference params, port params): the same numbers in both packages,
    the cross gates opened to ``GATE``."""
    jcfg, pcfg = _cfg(dtype)
    if dtype == "float32":
        jp = jx_model.init_model(jax.random.PRNGKey(0), jcfg)
        gate = jp["cross_layers"]["xattn"]["gate"]
        jp["cross_layers"]["xattn"]["gate"] = jnp.full_like(gate, GATE)
    else:
        shapes = jax.eval_shape(lambda: jx_model.init_model(jax.random.PRNGKey(0), jcfg))
        jp = jax.tree.map(lambda a, s: a.astype(s.dtype), _params("float32")[0], shapes)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, "cpu")


def _prompts(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab, (B, PLEN), dtype=np.int32)


def _image(cfg):
    rng = np.random.default_rng(2)
    return rng.normal(size=(B, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference_greedy(dtype):
    """The reference's greedy loop outside a mesh: (tokens [B, GEN], logits
    [GEN, B, V]), its two steps jitted."""
    jcfg, _ = _cfg(dtype)
    params, _ = _params(dtype)
    prefill = jax.jit(jx_model.forward_prefill, static_argnums=3)
    decode = jax.jit(jx_model.decode_step, static_argnums=4)
    cache = jx_model.init_cache(jcfg, B, MAX_SEQ)
    batch = {"tokens": jnp.asarray(_prompts(jcfg)), "image_embeds": jnp.asarray(_image(jcfg))}
    logits, cache = prefill(params, batch, cache, jcfg)
    kept = [np.asarray(logits)]
    out = [jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]]
    for i in range(GEN - 1):
        logits, cache = decode(params, cache, out[-1], jnp.int32(PLEN + i), jcfg)
        kept.append(np.asarray(logits))
        out.append(jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None])
    return np.concatenate([np.asarray(t) for t in out], axis=1), np.stack(kept)


def _mesh(data, model):
    return make_host_mesh(data, model, devices=[CPU] * (data * model))


def _session(monkeypatch, dtype, mesh, impl="flash"):
    """A session of the VLM's smoke config pinned "tp" on ``mesh`` (None:
    one device)."""
    _, pcfg = _cfg(dtype, impl)
    monkeypatch.setattr(pt_serve, "get_smoke_config", lambda a: pcfg)
    return pt_serve.ServeSession(ARCH, smoke=True, mesh=mesh, device="cpu", dtype=dtype,
                                 batch=B, max_seq=MAX_SEQ, params=_params(dtype)[1])


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _clone_cache(cache):
    return {k: ShardedTensor(v.shape, v.dtype, v.sharding,
                             {i: t.clone() for i, t in v.blocks.items()})
            for k, v in cache.items()}


def _ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    return (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()


def _near_bf16(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Two bf16 leaves at most one bf16 step apart, in at most 0.1 % of
    their elements."""
    u = _ulps(got, want)
    return int(u.max()) <= 1 and float((u > 0).float().mean()) <= 1e-3


def _gathered(monkeypatch, fn, *args):
    """``fn(*args)`` with ``serves_tensor_parallel`` patched off: the
    gathered path on the same mesh."""
    real = pt_steps.serves_tensor_parallel
    monkeypatch.setattr(pt_steps, "serves_tensor_parallel", lambda cfg, mesh: False)
    try:
        return fn(*args)
    finally:
        monkeypatch.setattr(pt_steps, "serves_tensor_parallel", real)


# ------------------------------------------------------------ the reference


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tensor_parallel_vlm_float32_equals_reference_greedy(monkeypatch, mesh):
    _, pcfg = _cfg("float32")
    sess = _session(monkeypatch, "float32", _mesh(*mesh))
    assert tp.serves_tensor_parallel(sess.cfg, sess.mesh)
    prompts = _prompts(pcfg)
    tokens, stats = sess.generate(prompts, GEN, image_embeds=_image(pcfg), keep_logits=True)
    want_tokens, want_logits = _reference_greedy("float32")
    np.testing.assert_array_equal(tokens[:, :PLEN], prompts)
    np.testing.assert_array_equal(tokens[:, PLEN:], want_tokens)
    _close(stats["logits"], want_logits, LOGIT_TOL["float32"])
    assert sess._full is None  # the gathered blocks are freed after the call


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tensor_parallel_vlm_bfloat16_teacher_forced(monkeypatch, mesh):
    _, pcfg = _cfg("bfloat16")
    sess = _session(monkeypatch, "bfloat16", _mesh(*mesh))
    want_tokens, want_logits = _reference_greedy("bfloat16")
    with sess.gathered():
        logits, cache = sess.prefill(_prompts(pcfg), _image(pcfg))
        got = [logits]
        for i in range(GEN - 1):
            logits, cache = sess.decode(cache, torch.from_numpy(want_tokens[:, i:i + 1].copy()),
                                        PLEN + i)
            got.append(logits)
    _close(torch.stack(got), want_logits, LOGIT_TOL["bfloat16"])


# ------------------------------------------------------------ the gathered path


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tensor_parallel_vlm_matches_gathered_path(monkeypatch, mesh):
    """Float32, the same mesh: the prefill's logits and its caches (the
    self K/V and the image K/V), then each decode step from a copy of the
    gathered session's cache (module docstring)."""
    _, pcfg = _cfg("float32")
    mesh = _mesh(*mesh)
    sess = _session(monkeypatch, "float32", mesh)
    gathered = _session(monkeypatch, "float32", mesh)
    prompts, img = _prompts(pcfg), _image(pcfg)
    got, mine = sess.prefill(prompts, img)
    want, cache = _gathered(monkeypatch, gathered.prefill, prompts, img)
    assert _rel(got, want) <= PATH_TOL
    for k in ("k", "v", "xk", "xv"):
        assert _near_bf16(mine[k].full(CPU), cache[k].full(CPU)), k
    exact_steps = 0
    for i in range(GEN - 1):
        tok = torch.argmax(want, -1, keepdim=True).to(torch.int32)
        got, mine = sess.decode(_clone_cache(cache), tok, PLEN + i)
        want, cache = _gathered(monkeypatch, gathered.decode, cache, tok, PLEN + i)
        written = [_ulps(mine[k].full(CPU), cache[k].full(CPU)) for k in ("k", "v")]
        assert all(_near_bf16(mine[k].full(CPU), cache[k].full(CPU)) for k in ("k", "v"))
        if all(int(u.max()) == 0 for u in written):
            exact_steps += 1
            assert _rel(got, want) <= PATH_TOL, i
        else:
            _close(got, want, LOGIT_TOL["float32"])
    assert exact_steps >= 1


# ------------------------------------------------------------ blocks and moves


class DuckMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape)
        self.axis_names = tuple(names)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_each_position_gathers_its_vlm_model_blocks(monkeypatch, mesh):
    """The placed leaves' specs equal the reference's ``train_state_specs``;
    the leaves split over 'model' are ``MODEL_LEAVES`` (the self and cross
    layers' projections, the image projection, the vocab blocks); each
    position's gathered tree holds exactly their 'model' block and every
    other leaf (the norms, the cross gates) whole, under 0.55 of the whole
    tree's bytes."""
    jcfg, _ = _cfg("float32")
    shape = mesh
    sess = _session(monkeypatch, "float32", _mesh(*shape))
    want = ref_lms.train_state_specs(jcfg)[0]
    flat = jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, JP))[0]
    want = {"/".join(k.key for k in path): spec for path, spec in flat}
    placed = dict(zip(_names(sess.params), tree_leaves(sess.params)))
    assert sorted(placed) == sorted(want)
    for name, leaf in placed.items():
        assert JP(*leaf.sharding.spec) == want[name], name
    assert {n for n, leaf in placed.items()
            if tp.model_dim(leaf.sharding.spec, leaf.ndim) is not None} == MODEL_LEAVES
    m = shape[1]
    whole = sum(t.shape.numel() * t.dtype.itemsize for t in placed.values())
    with sess.gathered():
        blocks = sess._full
        assert isinstance(blocks, tp.ModelBlocks)
        assert sorted(blocks) == [(CPU, j) for j in range(m)]
        for (_, j), tree in blocks.items():
            for name, got in zip(_names(tree), tree_leaves(tree)):
                leaf = placed[name]
                d = tp.model_dim(leaf.sharding.spec, leaf.ndim)
                full = leaf.full(CPU)
                if d is None:
                    assert torch.equal(got, full), name
                    continue
                lo, hi = tp.block_range(leaf.shape[d], j, m)
                assert torch.equal(got, full.narrow(d, lo, hi - lo)), (name, j)
        assert all(v < 0.55 * whole for v in blocks.bytes_by_position.values())
        total = sum(t.numel() * t.element_size() for t in tree_leaves(blocks[(CPU, 0)]))
        assert blocks.bytes_by_position == {pos: total for pos in np.ndindex(*shape)}
    nbytes = {n: t.shape.numel() * t.dtype.itemsize for n, t in placed.items()}
    norms = sum(v for n, v in nbytes.items() if n not in MODEL_LEAVES)
    assert total == norms + (whole - norms) // m


def test_prefill_launches_flash_on_each_shard_heads_self_and_cross(monkeypatch):
    """On 2 x 2 the prefill attends once a (layer, data shard, model
    shard), self and cross layers alike, on that shard's H/m query heads
    and the KV heads they use: the self layers causal over the prompt, the
    cross layers non-causal over the ``n_image_tokens`` image keys. The
    image tokens are projected once a data shard. Decode launches
    nothing."""
    _, pcfg = _cfg("float32")
    calls = []
    real = pt_layers.flash_attention_bshd

    def spy(q, k, v, *a, causal, **kw):
        calls.append((q.shape[0], q.shape[2], k.shape[2], k.shape[1], causal))
        return real(q, k, v, *a, causal=causal, **kw)

    projected = []
    real_img = pt_model._tp_image_tokens

    def img_spy(group, *a):
        projected.append(group.m)
        return real_img(group, *a)

    monkeypatch.setattr(pt_layers, "flash_attention_bshd", spy)
    monkeypatch.setattr(pt_model, "_tp_image_tokens", img_spy)
    sess = _session(monkeypatch, "float32", _mesh(2, 2))
    logits, cache = sess.prefill(_prompts(pcfg), _image(pcfg))
    h, k = pcfg.n_heads // 2, pcfg.n_kv_heads // 2
    groups, self_per, _ = pt_model.vlm_counts(pcfg)
    layer = [(PLEN, True)] * self_per + [(pcfg.n_image_tokens, False)]
    want = [(B // 2, h, k, sk, causal) for _ in range(2) for _ in range(groups)
            for sk, causal in layer for _ in range(2)]
    assert calls == want
    assert projected == [2, 2]  # once a data shard's prefill
    calls.clear()
    sess.decode(cache, torch.argmax(logits, -1, keepdim=True), PLEN)
    assert calls == []  # self layers by sequence blocks, cross layers by the plain path


@pytest.mark.parametrize("mesh", ((1, 2), (1, 4)), ids=lambda m: f"{m[0]}x{m[1]}")
def test_cross_decode_reads_each_shard_copy_of_the_image_kv(monkeypatch, mesh):
    """A decode step's cross layer moves the token's normed ``h`` to each
    shard and each float32 partial back, and nothing of the image K/V:
    each shard reads its KV heads of them from the cache's copy its own
    mesh position holds (a view, replicated over 'model'). Its output equals
    the one-device ``cross_decode`` on the whole cache within 1e-5."""
    _, pcfg = _cfg("float32")
    sess = _session(monkeypatch, "float32", _mesh(*mesh))
    _, cache = sess.prefill(_prompts(pcfg), _image(pcfg))
    m = mesh[1]
    with sess.gathered():
        group = tp.model_group(sess._full, sess.mesh, (0, 0))
        cps = pt_model._tp_layers(group, pcfg)[1][1]  # group 1's cross layer
        h = torch.from_numpy(np.random.default_rng(3).normal(size=(B, 1, pcfg.d_model))
                             .astype(np.float32))
        held = cache["xk"].blocks[(CPU, (0, 0, 0, 0, 0))]
        view = cache["xk"].view_at(group.positions[m - 1], (slice(1, 2),))
        assert view.data_ptr() == held[1].data_ptr()
        got = pt_model._tp_cross_decode(group, cps, h, PLEN, cache, 1, 0, B, pcfg)
    partial = B * pcfg.d_model * 4
    assert group.moved == [(m - 1) * partial] + [B * pcfg.d_model * 4] * (m - 1)
    params = _params("float32")[1]
    cp = {k: v[1] for k, v in params["cross_layers"]["xattn"].items()}
    want = pt_layers.cross_decode(cp, h, PLEN, cache["xk"].full(CPU)[1], cache["xv"].full(CPU)[1],
                                  pcfg)
    assert _rel(got, want) <= PATH_TOL


def test_view_at_refuses_a_region_its_block_does_not_hold():
    """``ShardedTensor.view_at`` is a view of the block at a mesh
    position, and raises where that block does not hold all the region."""
    from repro_torch.distributed.sharding import NamedSharding, P, place

    mesh = _mesh(2, 2)
    x = torch.arange(4 * 3, dtype=torch.float32).reshape(4, 3)
    leaf = place(x, NamedSharding(mesh, P("data", None)))
    got = leaf.view_at((1, 1), (slice(2, 4), slice(1, 3)))
    assert torch.equal(got, x[2:4, 1:3]) and got.data_ptr() == leaf.block((1, 1))[:, 1].data_ptr()
    with pytest.raises(ValueError, match="does not hold"):
        leaf.view_at((0, 1), (slice(1, 3),))


# ------------------------------------------------------------ planted faults


def _neighbour_image_heads(monkeypatch):
    """A planted fault: in the cross layers only (``_tp_cross`` at the
    prefill, ``_tp_cross_decode`` at decode), each shard takes its
    neighbour's KV heads of the image K/V; the self layers keep theirs."""
    real_kv = tp.kv_block

    def neighbour(cfg, j, m):
        return real_kv(cfg, (j + 1) % m, m)

    def crossing(fn):
        def wrapped(*args, **kwargs):
            tp.kv_block = neighbour
            try:
                return fn(*args, **kwargs)
            finally:
                tp.kv_block = real_kv

        return wrapped

    for name in ("_tp_cross", "_tp_cross_decode"):
        monkeypatch.setattr(pt_model, name, crossing(getattr(pt_model, name)))


@pytest.mark.parametrize("fault", ["neighbour's image KV heads", "dropped partial"])
def test_a_planted_fault_is_seen(monkeypatch, fault):
    """On (1, 2) the prefill's logits and a decode step's, from a copy of
    the sound prefill's cache, land far from the sound run's: a shard that
    takes its neighbour's image KV heads in the cross layers only, or a
    reduction that loses the last shard's partial."""
    _, pcfg = _cfg("float32")
    sess = _session(monkeypatch, "float32", _mesh(1, 2))
    prompts, img = _prompts(pcfg), _image(pcfg)
    want, cache = sess.prefill(prompts, img)
    tok = torch.argmax(want, -1, keepdim=True).to(torch.int32)
    want_step, _ = sess.decode(_clone_cache(cache), tok, PLEN)
    if fault == "dropped partial":
        real = tp.reduce_f32
        monkeypatch.setattr(tp, "reduce_f32",
                            lambda parts, dev, dtype: real(parts[:-1], dev, dtype))
    else:
        _neighbour_image_heads(monkeypatch)
        calls = []
        real_kv_heads = pt_model._tp_kv_heads
        monkeypatch.setattr(pt_model, "_tp_kv_heads",
                            lambda group, j, cfg, take: calls.append(tp.kv_block(cfg, j, group.m))
                            or real_kv_heads(group, j, cfg, take))
    got, _ = sess.prefill(prompts, img)
    got_step, _ = sess.decode(_clone_cache(cache), tok, PLEN)
    assert _rel(got, want) > 100 * PATH_TOL
    assert _rel(got_step, want_step) > 100 * PATH_TOL
    if fault != "dropped partial":  # the self layers kept their own heads
        groups, self_per, _ = pt_model.vlm_counts(pcfg)
        own = [tp.kv_block(pcfg, j, 2) for j in range(2)]
        prefill = (own * self_per + own[::-1]) * groups  # self layers, then the cross layer
        decode = own[::-1] * groups  # the cross layers' reads (self layers read no KV block)
        assert calls == prefill + decode
