"""The port's sharded LM serving on meshes of logical CPU shards.

``ServeSession(mesh=)`` places the parameters by ``train_state_specs``, the
prompt batch by ``batch_spec_tree`` and the cache by ``cache_spec_tree``
(its sequence, or the SSM's heads, over 'model'). Decode attention runs one
float32 partial a sequence block and a logsumexp combine; the SSM step runs
by head blocks. The reference's ``ServeSession`` fails on this JAX (its
Explicit-axes mesh rejects ``constrain``), so the oracle is the reference's
greedy loop run outside any mesh (``init_cache`` -> ``forward_prefill`` ->
``decode_step`` x n -> argmax) on the same parameters, converted bit for bit
by ``params_from_numpy``, as ``tests/test_torch_families_serve.py`` runs it.

Tolerances: float32 equal greedy tokens and 1e-4 on the logits; bfloat16
3e-2 on the logits, both packages fed the reference's greedy tokens
(teacher forcing); the partials against the one-device decode functions
1e-6 (float32); each placed cache block against the matching slice of the
one-device session's cache 1e-6 in float32 runs, except that a bf16
attention leaf (bf16 whatever the run's dtype, in both packages) written by
a decode step may hold the neighbouring bf16 value in at most 0.1 % of its
elements, where the partials' reordered float32 sums round the other way.
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
from repro_torch.distributed.sharding import NamedSharding, P, ShardedTensor, place  # noqa: E402
from repro_torch.kernels.flash_attention import NEG_INF  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.launch import steps as pt_steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models import model as pt_model  # noqa: E402
from repro_torch.models import ssm as pt_ssm  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ("smollm-135m", "minicpm3-4b", "moonshot-v1-16b-a3b", "mamba2-780m", "zamba2-7b",
         "llama-3.2-vision-90b")
IMPL = {"smollm-135m": "flash", "moonshot-v1-16b-a3b": "flash", "llama-3.2-vision-90b": "flash"}
MESHES = ((1, 2), (2, 1), (2, 2))
B, PLEN, GEN = 4, 16, 6
# The MoE's prefill routes groups of min(1024, tokens): each data-parallel
# shard must hold whole groups, so its prompts are 2 x 1,024 tokens.
SHAPE = {"moonshot-v1-16b-a3b": (2, 1024, 4)}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PARTIAL_TOL = 1e-6
CACHE_TOL = 1e-6


def _shape(arch, shape=None):
    return shape or SHAPE.get(arch, (B, PLEN, GEN))


def _max_seq(arch, shape=None):
    b, plen, gen = _shape(arch, shape)
    return plen + gen + 2  # even: the sequence splits over 'model'


def _cfg(arch, dtype):
    """(reference config, port config); the reference's flash kernel does
    not run on this JAX, so the reference attends by its XLA path."""
    return (jx_get_smoke_config(arch).scaled(dtype=dtype),
            get_smoke_config(arch).scaled(dtype=dtype, attention_impl=IMPL.get(arch, "xla")))


def _mesh(data, model):
    return make_host_mesh(data, model, devices=[CPU] * (data * model))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    """(reference params, port params): the same numbers in both packages.
    The bf16 tree is the float32 init cast leaf by leaf to the dtypes of the
    reference's bf16 init (the SSM's ``a_log`` and ``dt_bias`` stay float32)."""
    jcfg, pcfg = _cfg(arch, dtype)
    if dtype == "float32":
        jp = jx_model.init_model(jax.random.PRNGKey(0), jcfg)
        if "cross_layers" in jp:  # init mutes the image tokens (tanh(0)); let them count
            gate = jp["cross_layers"]["xattn"]["gate"]
            jp["cross_layers"]["xattn"]["gate"] = jnp.full_like(gate, 0.5)
    else:
        shapes = jax.eval_shape(lambda: jx_model.init_model(jax.random.PRNGKey(0), jcfg))
        jp = jax.tree.map(lambda a, s: a.astype(s.dtype), _params(arch, "float32")[0], shapes)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, "cpu")


def _prompts(arch, cfg, shape=None):
    b, plen, _ = _shape(arch, shape)
    return np.random.default_rng(1).integers(0, cfg.vocab, (b, plen), dtype=np.int32)


def _image(arch, cfg):
    if cfg.family != "vlm":
        return None
    rng = np.random.default_rng(2)
    return rng.normal(size=(_shape(arch)[0], cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference_greedy(arch, dtype, shape=None):
    """The reference's greedy loop outside a mesh: (tokens [B, GEN], logits
    [GEN, B, V]). Its two steps are jitted, which gives the eager loop's
    tokens and logits here in a third of the time. ``shape`` (batch, prompt,
    generated) replaces the arch's own."""
    jcfg, _ = _cfg(arch, dtype)
    params, _ = _params(arch, dtype)
    b, plen, gen = _shape(arch, shape)
    batch = {"tokens": jnp.asarray(_prompts(arch, jcfg, shape))}
    if jcfg.family == "vlm":
        batch["image_embeds"] = jnp.asarray(_image(arch, jcfg))
    prefill = jax.jit(jx_model.forward_prefill, static_argnums=3)  # the eager loop's numbers
    decode = jax.jit(jx_model.decode_step, static_argnums=4)
    cache = jx_model.init_cache(jcfg, b, _max_seq(arch, shape))
    logits, cache = prefill(params, batch, cache, jcfg)
    kept = [np.asarray(logits)]
    out = [jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]]
    for i in range(gen - 1):
        logits, cache = decode(params, cache, out[-1], jnp.int32(plen + i), jcfg)
        kept.append(np.asarray(logits))
        out.append(jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None])
    return np.concatenate([np.asarray(t) for t in out], axis=1), np.stack(kept)


def _session(arch, dtype, mesh, **kw):
    _, pcfg = _cfg(arch, dtype)
    _, pp = _params(arch, dtype)
    kw.setdefault("batch", _shape(arch)[0])
    kw.setdefault("max_seq", _max_seq(arch))
    return pt_serve.ServeSession(arch, smoke=True, mesh=mesh, dtype=dtype,
                                 attention_impl=pcfg.attention_impl, params=pp, **kw)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _leaves(cache):
    out = {k: v for k, v in cache.items() if k != "ssm"}
    out.update({f"ssm/{k}": v for k, v in cache.get("ssm", {}).items()})
    return out


# ------------------------------------------------------------ partials


def _rand(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)
                            ).to(dtype)


SPLITS = ((12,), (6, 6), (4, 4, 4), (5, 1, 6), (3, 3, 3, 3))


def _blocks(cache, sizes):
    starts = np.cumsum((0,) + sizes[:-1])
    return [(int(s), cache[:, s:s + n]) for s, n in zip(starts, sizes)]


@pytest.mark.parametrize("sizes", SPLITS, ids=lambda s: "+".join(map(str, s)))
@pytest.mark.parametrize("pos", (0, 5, 11))
def test_attention_partials_match_one_block_decode(pos, sizes):
    """Every block split of a 12-long cache (blocks wholly past ``pos``, a
    block holding only ``pos`` in the 5+1+6 split at pos 5) combines to
    ``attn_decode``'s output; a block past ``pos`` weighs exactly 0."""
    cfg = get_smoke_config("smollm-135m").scaled(dtype="float32")
    p = {k: v[0] for k, v in pt_model.init_model(3, cfg, "cpu")["layers"]["attn"].items()}
    x = _rand((2, 1, cfg.d_model), 4)
    kc = _rand((2, 12, cfg.n_kv_heads, cfg.resolved_head_dim), 5, torch.bfloat16)
    vc = _rand((2, 12, cfg.n_kv_heads, cfg.resolved_head_dim), 6, torch.bfloat16)
    want, wk, wv = pt_layers.attn_decode(p, x, pos, kc.clone(), vc.clone(), cfg)
    q, k, v = pt_layers.attn_decode_qkv(p, x, pos, cfg)
    pt_layers.cache_write(kc, k, pos)
    pt_layers.cache_write(vc, v, pos)
    assert torch.equal(kc, wk) and torch.equal(vc, wv)
    parts = [pt_layers.attn_partial(q, kb, vb, s, pos)
             for (s, kb), (_, vb) in zip(_blocks(kc, sizes), _blocks(vc, sizes))]
    o = pt_layers.combine_partials(parts)
    got = pt_layers.attn_decode_out(p, o, x.dtype)
    assert torch.isfinite(got).all()
    _close(got, want, PARTIAL_TOL)
    for (s, _), (m, _, _) in zip(_blocks(kc, sizes), parts):
        if s > pos:  # wholly past pos: NEG_INF, finite, and a weight of 0
            assert torch.all(m == NEG_INF)
            top = functools.reduce(torch.maximum, [mj for mj, _, _ in parts])
            assert torch.all(torch.exp(m - top) == 0)


@pytest.mark.parametrize("sizes", SPLITS, ids=lambda s: "+".join(map(str, s)))
@pytest.mark.parametrize("pos", (0, 5, 11))
def test_mla_partials_match_one_block_decode(pos, sizes):
    """MLA's partials combine in latent space, before ``wuv``, to
    ``mla_decode``'s output."""
    cfg = get_smoke_config("minicpm3-4b").scaled(dtype="float32")
    p = {k: v[0] for k, v in pt_model.init_model(3, cfg, "cpu")["layers"]["attn"].items()}
    x = _rand((2, 1, cfg.d_model), 4)
    ckv = _rand((2, 12, cfg.kv_lora_rank), 5, torch.bfloat16)
    kr = _rand((2, 12, cfg.qk_rope_dim), 6, torch.bfloat16)
    want, wc, wr = pt_layers.mla_decode(p, x, pos, ckv.clone(), kr.clone(), cfg)
    q_lat, q_rope, c, r = pt_layers.mla_decode_qkv(p, x, pos, cfg)
    pt_layers.cache_write(ckv, c, pos)
    pt_layers.cache_write(kr, r, pos)
    assert torch.equal(ckv, wc) and torch.equal(kr, wr)
    parts = [pt_layers.mla_partial(q_lat, q_rope, cb, rb, s, pos, cfg)
             for (s, cb), (_, rb) in zip(_blocks(ckv, sizes), _blocks(kr, sizes))]
    got = pt_layers.mla_decode_out(p, pt_layers.combine_partials(parts), cfg, x.dtype)
    _close(got, want, PARTIAL_TOL)


@pytest.mark.parametrize("heads", ((8,), (4, 4), (2, 6), (1,) * 8), ids=str)
@pytest.mark.parametrize("arch", ("mamba2-780m", "zamba2-7b"))
def test_ssm_head_blocks_match_decode(arch, heads):
    """``ssm_decode_heads`` over head blocks equals ``ssm_decode`` (float32
    state, bf16 conv states promoted by the float32 step)."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    assert sum(heads) == cfg.ssm_heads
    p = {k: v[0] for k, v in pt_model.init_model(3, cfg, "cpu")["layers"]["ssm"].items()}
    u = _rand((2, 1, cfg.d_model), 4)
    state = {k: _rand(t.shape, 10 + i, t.dtype)
             for i, (k, t) in enumerate(pt_ssm.ssm_state_shapes(cfg, 2, "cpu").items())}
    want, wstate = pt_ssm.ssm_decode(p, u, cfg, state)
    hp, blocks, h0 = cfg.ssm_head_dim, [], 0
    for n in heads:
        blocks.append((h0, h0 + n, state["conv_x"][..., h0 * hp:(h0 + n) * hp],
                       state["ssm"][:, h0:h0 + n]))
        h0 += n
    got, ncb, ncc, new = pt_ssm.ssm_decode_heads(p, u, cfg, state["conv_b"], state["conv_c"],
                                                 blocks)
    _close(got, want, PARTIAL_TOL)
    assert torch.equal(ncb, wstate["conv_b"]) and torch.equal(ncc, wstate["conv_c"])
    _close(torch.cat([c for c, _ in new], dim=-1), wstate["conv_x"], PARTIAL_TOL)
    _close(torch.cat([h for _, h in new], dim=1), wstate["ssm"], PARTIAL_TOL)


# ------------------------------------------------------------ sessions


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_session_float32_equals_reference_greedy(arch, mesh):
    _, pcfg = _cfg(arch, "float32")
    sess = _session(arch, "float32", _mesh(*mesh))
    prompts = _prompts(arch, pcfg)
    tokens, stats = sess.generate(prompts, _shape(arch)[2], image_embeds=_image(arch, pcfg),
                                  keep_logits=True)
    want_tokens, want_logits = _reference_greedy(arch, "float32")
    assert np.array_equal(tokens[:, :prompts.shape[1]], prompts)
    np.testing.assert_array_equal(tokens[:, prompts.shape[1]:], want_tokens)
    _close(stats["logits"], want_logits, LOGIT_TOL["float32"])
    assert sess._full is None  # the gathered parameters are freed after the call


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_session_bfloat16_teacher_forced(arch, mesh):
    """bf16 logits of every step, both packages fed the reference's greedy
    tokens (a near tie may flip a bf16 argmax, trouble the partials' order
    of sums does not cause)."""
    _, pcfg = _cfg(arch, "bfloat16")
    sess = _session(arch, "bfloat16", _mesh(*mesh))
    want_tokens, want_logits = _reference_greedy(arch, "bfloat16")
    plen = _shape(arch)[1]
    logits, cache = sess.prefill(_prompts(arch, pcfg), _image(arch, pcfg))
    got = [logits]
    for i in range(want_tokens.shape[1] - 1):
        logits, cache = sess.decode(cache, torch.from_numpy(want_tokens[:, i:i + 1].copy()),
                                    plen + i)
        got.append(logits)
    _close(torch.stack(got), want_logits, LOGIT_TOL["bfloat16"])


class DuckMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape)
        self.axis_names = tuple(names)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_cache_specs_equal_reference(arch, mesh):
    jcfg, _ = _cfg(arch, "float32")
    sess = _session(arch, "float32", _mesh(*mesh))
    _, cache = sess.prefill(_prompts(arch, jcfg), _image(arch, jcfg))
    ref = jax.eval_shape(lambda: jx_model.init_cache(jcfg, sess.batch, sess.max_seq))
    want = ref_lms.cache_spec_tree(jcfg, DuckMesh(mesh, ("data", "model")), ref)
    flat = jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, JP))[0]
    want = {"/".join(k.key for k in path): spec for path, spec in flat}
    got = _leaves(cache)
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert isinstance(leaf, ShardedTensor) and leaf.sharding.mesh == sess.mesh
        assert JP(*leaf.sharding.spec) == want[name], (name, leaf.sharding.spec, want[name])
    seq_leaves = [n for n in got if n in ("k", "v", "shared_k", "shared_v", "ckv", "krope")]
    for name in seq_leaves:  # the flash-decoding layout: the sequence on 'model'
        assert got[name].sharding.spec[_seq_dim(name, got[name])] == "model", name


def _seq_dim(name, leaf):
    return leaf.ndim - 3 if name in ("k", "v") else 2


def _cache_close(got, want, decoded):
    """Within 1e-6; but a bf16 leaf written by a decode step may hold the
    neighbouring bf16 value (one unit in the last place) where the partials'
    float32 sums, reordered, round to the other side, in at most 0.1 % of
    its elements."""
    if decoded and want.dtype == torch.bfloat16:
        ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
        assert int(ulps.max()) <= 1 and float((ulps > 0).float().mean()) <= 1e-3
    else:
        _close(got, want, CACHE_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_blocks_equal_one_device_slices(arch, mesh):
    """Float32 runs: every block of every placed leaf (dtype included)
    against the matching slice of the one-device session's cache, after the
    prefill and after each of 3 decode steps (``_cache_close``)."""
    _, pcfg = _cfg(arch, "float32")
    one = _session(arch, "float32", None, device="cpu")
    sess = _session(arch, "float32", _mesh(*mesh))
    prompts, img = _prompts(arch, pcfg), _image(arch, pcfg)
    l1, c1 = one.prefill(prompts, img)
    l2, c2 = sess.prefill(prompts, img)
    for step in range(4):
        _close(l2, l1, LOGIT_TOL["float32"])
        want, got = _leaves(c1), _leaves(c2)
        assert sorted(want) == sorted(got)
        for name, leaf in got.items():
            assert leaf.dtype == want[name].dtype, (step, name)
            sh = leaf.sharding
            for pos in np.ndindex(*sh.mesh.devices.shape):
                block = leaf.block(pos)
                sl = sh.block_slices(leaf.shape, sh.block_index(pos, leaf.ndim))
                assert block.dtype == leaf.dtype
                _cache_close(block, want[name][sl], decoded=step > 0)
        if step < 3:
            tok = torch.argmax(l1, -1, keepdim=True).to(torch.int32)
            l1, c1 = one.decode(c1, tok, prompts.shape[1] + step)
            l2, c2 = sess.decode(c2, tok, prompts.shape[1] + step)


@pytest.mark.parametrize("arch", ("smollm-135m", "mamba2-780m", "zamba2-7b", "minicpm3-4b"))
def test_unsplit_dims_stay_replicated(arch):
    """An odd ``max_seq`` leaves the sequence whole, a batch of 3 on a
    2-way 'data' axis leaves the batch whole (and the prompt batch too):
    the results are the one-device session's."""
    _, pcfg = _cfg(arch, "float32")
    b, max_seq = 3, PLEN + GEN + 1
    one = _session(arch, "float32", None, device="cpu", batch=b, max_seq=max_seq)
    sess = _session(arch, "float32", _mesh(2, 2), batch=b, max_seq=max_seq)
    prompts = _prompts(arch, pcfg)[:b]
    _, cache = sess.prefill(prompts)
    for name, leaf in _leaves(cache).items():
        spec = tuple(leaf.sharding.spec) + (None,) * leaf.ndim
        assert spec[pt_model._batch_dim(name.split("/")[-1], leaf)] is None, name
        if name in ("k", "v", "shared_k", "shared_v", "ckv", "krope"):
            assert spec[_seq_dim(name, leaf)] is None, name
    want_tokens, want = one.generate(prompts, GEN, keep_logits=True)
    got_tokens, got = sess.generate(prompts, GEN, keep_logits=True)
    np.testing.assert_array_equal(got_tokens, want_tokens)
    _close(got["logits"], want["logits"], LOGIT_TOL["float32"])


def test_decode_reads_every_sequence_block(monkeypatch):
    """On 2 x 2 with a dividing ``max_seq`` a decode step runs one partial a
    (data-parallel row, sequence block, layer): both blocks are read, the
    one past ``pos`` too, and the SSM step runs two head blocks."""
    calls = []
    real_attn, real_ssm = pt_layers.attn_partial, pt_ssm.ssm_decode_heads

    def attn_spy(q, kb, vb, start, pos):
        calls.append(("attn", q.shape[0], start, kb.shape[1]))
        return real_attn(q, kb, vb, start, pos)

    def ssm_spy(p, u, cfg, cb, cc, blocks):
        calls.append(("ssm", u.shape[0], tuple((h0, h1) for h0, h1, _, _ in blocks)))
        return real_ssm(p, u, cfg, cb, cc, blocks)

    monkeypatch.setattr(pt_layers, "attn_partial", attn_spy)
    monkeypatch.setattr(pt_ssm, "ssm_decode_heads", ssm_spy)
    for arch in ("smollm-135m", "zamba2-7b"):
        _, pcfg = _cfg(arch, "float32")
        sess = _session(arch, "float32", _mesh(2, 2))
        logits, cache = sess.prefill(_prompts(arch, pcfg))
        calls.clear()
        sess.decode(cache, torch.argmax(logits, -1, keepdim=True), PLEN)
        half = _max_seq(arch) // 2
        attn = [c for c in calls if c[0] == "attn"]
        n_attn = pcfg.n_layers if arch == "smollm-135m" else pcfg.n_layers // pcfg.hybrid_attn_every
        assert sorted(attn) == sorted([("attn", B // 2, s, half) for s in (0, half)] * 2 * n_attn)
        ssm = [c for c in calls if c[0] == "ssm"]
        h = pcfg.ssm_heads
        assert ssm == ([("ssm", B // 2, ((0, h // 2), (h // 2, h)))] * 2 * pcfg.n_layers
                       if arch == "zamba2-7b" else [])


def test_generate_gathers_the_parameters_once(monkeypatch):
    """One gather a ``generate`` (not one a step), dropped after the call;
    a lone ``prefill``/``decode`` gathers for itself."""
    seen = []
    real = pt_steps.gather_params
    monkeypatch.setattr(pt_serve, "gather_params", lambda *a: seen.append("serve") or real(*a))
    monkeypatch.setattr(pt_steps, "gather_params", lambda *a: seen.append("step") or real(*a))
    _, pcfg = _cfg("smollm-135m", "float32")
    sess = _session("smollm-135m", "float32", _mesh(2, 2))
    sess.generate(_prompts("smollm-135m", pcfg), GEN)
    assert seen == ["serve"] and sess._full is None
    sess.prefill(_prompts("smollm-135m", pcfg))
    assert seen == ["serve", "step"]
    with sess.gathered():
        logits, cache = sess.prefill(_prompts("smollm-135m", pcfg))
        sess.decode(cache, torch.argmax(logits, -1, keepdim=True), PLEN)
    assert seen == ["serve", "step", "serve"] and sess._full is None


def test_steps_on_a_mesh_place_a_dense_cache():
    """``make_prefill_step``/``make_serve_step`` on a mesh take a dense cache
    and batch, place them, and return the logits gathered on the mesh's
    first device with the placed cache."""
    cfg = get_smoke_config("smollm-135m").scaled(dtype="float32")
    mesh = _mesh(2, 2)
    params = pt_model.init_model(0, cfg, "cpu")
    prefill = pt_steps.make_prefill_step(cfg, mesh)
    serve = pt_steps.make_serve_step(cfg, mesh)
    tokens = torch.from_numpy(_prompts("smollm-135m", cfg))
    logits, cache = prefill(params, pt_model.init_cache(cfg, B, 24, "cpu"), {"tokens": tokens})
    want, wcache = pt_steps.make_prefill_step(cfg)(params, pt_model.init_cache(cfg, B, 24, "cpu"),
                                                   {"tokens": tokens})
    assert logits.shape == (B, cfg.padded_vocab) and logits.device == mesh.devices.flat[0]
    assert all(isinstance(t, ShardedTensor) for t in cache.values())
    _close(logits, want, LOGIT_TOL["float32"])
    tok = torch.argmax(want, -1, keepdim=True)
    logits, cache = serve(params, cache, tok, PLEN)
    want, _ = pt_steps.make_serve_step(cfg)(params, wcache, tok, PLEN)
    _close(logits, want, LOGIT_TOL["float32"])
    _close(cache["k"].full(CPU), wcache["k"], CACHE_TOL)


def test_moe_prefill_routes_groups_its_shards_would_cut(monkeypatch):
    """16-token prompts route groups of 64 (4 x 16): a 2-way 'data' split
    would route each shard's 32 tokens alone, so the sharded prefill runs
    the batch as one shard on the mesh's first device (one
    ``forward_prefill``) and scatters its cache into every block: the
    generated tokens and every step's logits equal the one-device session's
    and the reference's greedy loop. Rows that do not split still raise."""
    arch, shape = "moonshot-v1-16b-a3b", (B, PLEN, GEN)
    _, pcfg = _cfg(arch, "float32")
    prompts = _prompts(arch, pcfg, shape)
    want_tokens, want_logits = _reference_greedy(arch, "float32", shape)
    calls = []
    real = pt_model.forward_prefill
    monkeypatch.setattr(pt_model, "forward_prefill",
                        lambda p, batch, *a: calls.append(batch["tokens"].shape) or real(p, batch, *a))
    runs = {}
    for name, mesh in (("2x2", _mesh(2, 2)), ("one device", None)):
        sess = _session(arch, "float32", mesh, batch=B, max_seq=_max_seq(arch, shape),
                        device="cpu")
        runs[name] = sess.generate(prompts, GEN, keep_logits=True)
        if mesh is not None:  # the placed prefill: one shard of the whole batch
            assert calls == [(B, PLEN)]
    for tokens, stats in runs.values():
        np.testing.assert_array_equal(tokens[:, PLEN:], want_tokens)
        _close(stats["logits"], want_logits, LOGIT_TOL["float32"])
    _close(runs["2x2"][1]["logits"], runs["one device"][1]["logits"], LOGIT_TOL["float32"])
    mesh = _mesh(2, 2)
    batch = {"tokens": torch.from_numpy(prompts)}
    placed = pt_steps._placed_tree(batch, pt_steps._batch_shardings(pcfg, mesh, batch), "batch")
    with pytest.raises(ValueError, match="does not split"):
        pt_steps._dp_shards(pcfg, placed, 3)


def test_mesh_and_device_guards():
    with pytest.raises(ValueError, match="Mesh"):
        pt_serve.ServeSession("smollm-135m", smoke=True, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="disagrees"):
        pt_serve.ServeSession("smollm-135m", smoke=True, device="cuda", mesh=_mesh(1, 2))
    sess = pt_serve.ServeSession("smollm-135m", smoke=True, device="cpu", mesh=_mesh(1, 2))
    assert sess.device == CPU and sess.mesh.shape == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="encoder-only"):
        pt_serve.ServeSession("hubert-xlarge", smoke=True, mesh=_mesh(1, 2))


# ------------------------------------------------------------ placed regions


def test_read_and_scatter_cover_regions_across_blocks():
    """``scatter_`` writes a dense piece into every block it overlaps and
    ``read`` assembles any region (a view of the block when one block holds
    it)."""
    mesh = _mesh(2, 2)
    dense = _rand((3, 4, 10, 2), 1)
    x = place(dense.clone(), NamedSharding(mesh, P(None, "data", "model", None)))
    piece = _rand((2, 3, 4, 2), 2)
    x.scatter_(piece, (1, 1, 3, 0))
    dense[1:3, 1:4, 3:7] = piece
    assert torch.equal(x.full(CPU), dense)
    assert torch.equal(x.read((slice(0, 3), slice(1, 4), slice(2, 9)), CPU), dense[:, 1:4, 2:9])
    inside = x.read((slice(None), slice(2, 4), slice(5, 10)), CPU)
    assert torch.equal(inside, dense[:, 2:4, 5:10])
    assert inside.untyped_storage().data_ptr() == x.block((1, 1)).untyped_storage().data_ptr()
    y = x.astype(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y.full(CPU), dense.to(torch.bfloat16))
    assert x.astype(torch.float32) is x
