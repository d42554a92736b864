"""Tensor-parallel serving of the MLA decoder (minicpm3-4b) on logical CPU meshes.

minicpm3-4b's smoke config (4 heads; q/k 8 + 8 wide, values 8; latent
ranks 32 and 16; 2 layers) pinned ``parallelism="tp"`` serves through
``ServeSession(mesh=)`` on (1, 2), (2, 2) and (1, 4), and with 6 heads on
(1, 4), whose shards hold 1, 2, 1 and 2 heads as minicpm3's 40 heads on 16
shards are 2 or 3 a shard. Each position gathers over 'data' only: its
head-aligned columns of wuq/wuk/wuv and rows of wo
(``tensor_parallel.mla_head_range``), its 'model' block of the MLP and the
vocab, and wdq/wdkv and the norms whole. At the prefill the home computes
the latents every head shares and each shard attends with its heads
(``models/model.py::_tp_mla``); at decode each shard's absorbed queries are
joined on the home, each latent cache block's partial runs on the shard
whose mesh position holds it, and the combined latent's heads go back to
their shards (``_tp_mla_decode``).

The oracle is the reference's greedy loop outside a mesh (``init_cache`` ->
``forward_prefill`` -> ``decode_step`` x n -> argmax) on the same
parameters, converted bit for bit by ``params_from_numpy``. Tolerances, as
``tests/test_torch_tensor_parallel.py``'s: float32 equal greedy tokens and
1e-4 on the logits; bfloat16 3e-2, both packages fed the reference's greedy
tokens; against the port's gathered path on the same mesh 1e-5 relative
norm (float32), each decode step run from a copy of the gathered session's
cache, whose bf16 latents the two paths may round one bf16 step apart in at
most 0.1 % of their elements (then the step's logits are held to 1e-4); one
layer's shard functions joined over the shards against the reference's
``mla_forward``/``mla_decode`` 1e-5. A decode step moves none of the latent
cache. A reduction that drops the last shard's partial, and a decode step
whose shards take their neighbour's heads of the combined latent, must be
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
from repro.models import layers as jx_layers  # noqa: E402
from repro.models import model as jx_model  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.lm_sharding import cache_spec_tree, named_tree  # noqa: E402
from repro_torch.distributed.sharding import ShardedTensor, place_tree  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.launch import steps as pt_steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import model as pt_model  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves  # noqa: E402

CPU = torch.device("cpu")
ARCH = "minicpm3-4b"
UNEVEN = {"n_heads": 6, "n_kv_heads": 6}  # heads 1, 2, 1, 2 on (1, 4)
# (mesh, config fields replaced): the three meshes, then the uneven heads
CASES = (((1, 2), ()), ((2, 2), ()), ((1, 4), ()), ((1, 4), tuple(sorted(UNEVEN.items()))))
B, PLEN, GEN = 4, 16, 6
MAX_SEQ = PLEN + GEN + 2  # splits over a 'model' axis of 2 or 4
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PATH_TOL = 1e-5
LATENT = ("ckv", "krope")
MODEL_LEAVES = {"tok_embed", "lm_head", "layers/mlp/wi_gate", "layers/mlp/wi_up",
                "layers/mlp/wo"} | {f"layers/attn/{w}" for w in ("wuq", "wuk", "wuv", "wo")}
HEAD_LEAVES = {"layers/attn/wuq": 16, "layers/attn/wuk": 8, "layers/attn/wuv": 8,
               "layers/attn/wo": 8}  # the smoke config's width of a head along 'model'


def _ids(case):
    (data, model), kw = case
    return f"{data}x{model}" + ("-heads6" if kw else "")


def _cfg(dtype, kw=()):
    """(reference config, port config), pinned to the "tp" profile (``kw``
    replaces more fields); both attend by their XLA path (MLA's values are
    narrower than its queries, which the flash kernel refuses)."""
    kw = dict(kw)
    return (jx_get_smoke_config(ARCH).scaled(dtype=dtype, parallelism="tp", **kw),
            get_smoke_config(ARCH).scaled(dtype=dtype, parallelism="tp", attention_impl="xla",
                                          **kw))


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


def _prompts(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab, (B, PLEN), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _reference_greedy(dtype, kw=()):
    """The reference's greedy loop outside a mesh: (tokens [B, GEN], logits
    [GEN, B, V]), its two steps jitted."""
    jcfg, _ = _cfg(dtype, kw)
    params, _ = _params(dtype, kw)
    prefill = jax.jit(jx_model.forward_prefill, static_argnums=3)
    decode = jax.jit(jx_model.decode_step, static_argnums=4)
    cache = jx_model.init_cache(jcfg, B, MAX_SEQ)
    logits, cache = prefill(params, {"tokens": jnp.asarray(_prompts(jcfg))}, cache, jcfg)
    kept = [np.asarray(logits)]
    out = [jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]]
    for i in range(GEN - 1):
        logits, cache = decode(params, cache, out[-1], jnp.int32(PLEN + i), jcfg)
        kept.append(np.asarray(logits))
        out.append(jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None])
    return np.concatenate([np.asarray(t) for t in out], axis=1), np.stack(kept)


def _mesh(data, model):
    return make_host_mesh(data, model, devices=[CPU] * (data * model))


def _session(monkeypatch, dtype, mesh, kw=(), params=None):
    """A session of the smoke config pinned "tp" on ``mesh`` (the shared
    parameters unless ``params`` are given)."""
    _, pcfg = _cfg(dtype, kw)
    monkeypatch.setattr(pt_serve, "get_smoke_config", lambda a: pcfg)
    return pt_serve.ServeSession(ARCH, smoke=True, mesh=mesh, device="cpu", dtype=dtype,
                                 batch=B, max_seq=MAX_SEQ,
                                 params=_params(dtype, kw)[1] if params is None else params)


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


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tensor_parallel_mla_float32_equals_reference_greedy(monkeypatch, case):
    mesh, kw = case
    _, pcfg = _cfg("float32", kw)
    sess = _session(monkeypatch, "float32", _mesh(*mesh), kw)
    assert tp.serves_tensor_parallel(sess.cfg, sess.mesh)
    prompts = _prompts(pcfg)
    tokens, stats = sess.generate(prompts, GEN, keep_logits=True)
    want_tokens, want_logits = _reference_greedy("float32", kw)
    np.testing.assert_array_equal(tokens[:, :PLEN], prompts)
    np.testing.assert_array_equal(tokens[:, PLEN:], want_tokens)
    _close(stats["logits"], want_logits, LOGIT_TOL["float32"])
    assert sess._full is None  # the gathered blocks are freed after the call


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tensor_parallel_mla_bfloat16_teacher_forced(monkeypatch, case):
    mesh, kw = case
    _, pcfg = _cfg("bfloat16", kw)
    sess = _session(monkeypatch, "bfloat16", _mesh(*mesh), kw)
    want_tokens, want_logits = _reference_greedy("bfloat16", kw)
    with sess.gathered():
        logits, cache = sess.prefill(_prompts(pcfg))
        got = [logits]
        for i in range(GEN - 1):
            logits, cache = sess.decode(cache, torch.from_numpy(want_tokens[:, i:i + 1].copy()),
                                        PLEN + i)
            got.append(logits)
    _close(torch.stack(got), want_logits, LOGIT_TOL["bfloat16"])


def _layer_inputs(m, kw=()):
    """Layer 0 of the float32 smoke config on a (1, m) mesh: (reference
    config, port config, mesh, the group, its [shard] layer blocks, the
    reference's layer params, a random h [B, PLEN, d])."""
    jcfg, pcfg = _cfg("float32", kw)
    mesh = _mesh(1, m)
    params = pt_steps.place_params(pcfg, mesh, _params("float32", kw)[1])
    blocks = pt_steps.gather_params(params, mesh, pcfg)
    group = tp.model_group(blocks, mesh, (0, 0))
    lps = pt_model._tp_layers(group, pcfg)[0]
    jp = jax.tree.map(lambda t: t[0], _params("float32", kw)[0]["layers"])
    h = np.random.default_rng(5).normal(size=(B, PLEN, pcfg.d_model)).astype(np.float32)
    return jcfg, pcfg, mesh, group, lps, jp, h


def _placed_latents(pcfg, mesh, seed: int = 6):
    """A placed bf16 latent cache of random entries (``cache_spec_tree``:
    its sequence over 'model') and its dense copy."""
    rng = np.random.default_rng(seed)
    dense = {k: torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)).to(torch.bfloat16)
             for k, t in pt_model.cache_zeros(pcfg, B, MAX_SEQ, CPU).items()}
    placed = place_tree({k: t.clone() for k, t in dense.items()},
                        named_tree(mesh, cache_spec_tree(pcfg, mesh, dense)))
    return dense, placed


@pytest.mark.parametrize("m,kw", [(2, ()), (4, ()), (4, tuple(sorted(UNEVEN.items())))],
                         ids=["1x2", "1x4", "1x4-heads6"])
def test_shard_functions_join_to_the_reference_layer(m, kw):
    """One MLA layer over a group of ``m`` shards: the prefill's
    ``_tp_mla`` (output, ``ckv``, ``k_rope``) against the reference's
    ``mla_forward``; a decode step's ``_tp_mla_decode`` over a placed latent
    cache of random entries against its ``mla_decode`` on the dense cache,
    and the token's latents written at ``pos``. Float32, 1e-5."""
    jcfg, pcfg, mesh, group, lps, jp, h = _layer_inputs(m, kw)
    positions = np.broadcast_to(np.arange(PLEN, dtype=np.int32), (B, PLEN))
    want, (ckv, krope) = jx_layers.mla_forward(jp["attn"], jnp.asarray(h), jnp.asarray(positions),
                                               jcfg)
    got, (got_ckv, got_krope) = pt_model._tp_mla(group, lps, torch.from_numpy(h),
                                                 torch.from_numpy(positions.copy()), pcfg)
    _close(got, want, PATH_TOL)
    _close(got_ckv, ckv, PATH_TOL)
    _close(got_krope, krope, PATH_TOL)
    pos = PLEN + 1
    h1 = h[:, :1]
    dense, placed = _placed_latents(pcfg, mesh)
    want, ckv_c, krope_c = jx_layers.mla_decode(
        jp["attn"], jnp.asarray(h1), jnp.int32(pos), jnp.asarray(_np(dense["ckv"][0])).astype(
            jnp.bfloat16), jnp.asarray(_np(dense["krope"][0])).astype(jnp.bfloat16), jcfg)
    got = pt_model._tp_mla_decode(group, lps, torch.from_numpy(h1), pos, placed, (0,), 0, 0, pcfg)
    _close(got, want, PATH_TOL)
    for k, written in (("ckv", ckv_c), ("krope", krope_c)):  # the token's latents at pos
        written = torch.from_numpy(np.asarray(written, np.float32)).to(torch.bfloat16)
        assert int(_ulps(placed[k].full(CPU)[0], written).max()) <= 1, k


# ------------------------------------------------------------ the gathered path


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tensor_parallel_mla_matches_gathered_path(monkeypatch, case):
    """Float32, the same mesh: the prefill's logits and latent caches, then
    each decode step from a copy of the gathered session's cache (module
    docstring)."""
    mesh, kw = case
    _, pcfg = _cfg("float32", kw)
    mesh = _mesh(*mesh)
    sess = _session(monkeypatch, "float32", mesh, kw)
    gathered = _session(monkeypatch, "float32", mesh, kw)
    prompts = _prompts(pcfg)
    got, mine = sess.prefill(prompts)
    want, cache = _gathered(monkeypatch, gathered.prefill, prompts)
    assert _rel(got, want) <= PATH_TOL
    for k in LATENT:
        u = _ulps(mine[k].full(CPU), cache[k].full(CPU))
        assert int(u.max()) <= 1 and float((u > 0).float().mean()) <= 1e-3, k
    exact_steps = 0
    for i in range(GEN - 1):
        tok = torch.argmax(want, -1, keepdim=True).to(torch.int32)
        got, mine = sess.decode(_clone_cache(cache), tok, PLEN + i)
        want, cache = _gathered(monkeypatch, gathered.decode, cache, tok, PLEN + i)
        written = [_ulps(mine[k].full(CPU), cache[k].full(CPU)) for k in LATENT]
        for u in written:
            assert int(u.max()) <= 1 and float((u > 0).float().mean()) <= 1e-3
        if all(int(u.max()) == 0 for u in written):
            exact_steps += 1
            assert _rel(got, want) <= PATH_TOL, i
        else:
            _close(got, want, LOGIT_TOL["float32"])
    assert exact_steps >= 1


# ------------------------------------------------------------ blocks and moves


def test_dp_profile_serves_mla_on_the_gathered_path(monkeypatch):
    """On 2 x 2 the MLA config pinned "dp" gathers every parameter whole
    and decodes by the latent cache's sequence blocks (``_mla_placed``),
    with the reference's greedy tokens and its logits within 1e-4."""
    _, pcfg = _cfg("float32")
    monkeypatch.setattr(pt_serve, "get_smoke_config", lambda a: pcfg.scaled(parallelism="dp"))
    mesh = _mesh(2, 2)
    sess = pt_serve.ServeSession(ARCH, smoke=True, mesh=mesh, device="cpu", dtype="float32",
                                 batch=B, max_seq=MAX_SEQ, params=_params("float32")[1])
    assert sess.cfg.parallelism == "dp" and not tp.serves_tensor_parallel(sess.cfg, mesh)
    placed = []
    real = pt_model._mla_placed

    def spy(*args, **kwargs):
        placed.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(pt_model, "_mla_placed", spy)
    with sess.gathered():
        assert isinstance(sess._full, pt_steps.GatheredParams)
    tokens, stats = sess.generate(_prompts(pcfg), GEN, keep_logits=True)
    want_tokens, want_logits = _reference_greedy("float32")
    np.testing.assert_array_equal(tokens[:, PLEN:], want_tokens)
    _close(stats["logits"], want_logits, LOGIT_TOL["float32"])
    assert placed and len(placed) % (pcfg.n_layers * (GEN - 1)) == 0


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_each_position_gathers_its_mla_heads(monkeypatch, case):
    """The placed leaves' specs equal the reference's ``train_state_specs``;
    the leaves split over 'model' are ``MODEL_LEAVES``; each position's
    gathered tree holds its head-aligned slice of the reference's wuq, wuk,
    wuv (columns) and wo (rows), the 'model' block of the MLP and vocab
    leaves, and wdq, wdkv and the norms whole; its bytes are recorded."""
    shape, kw = case
    jcfg, pcfg = _cfg("float32", kw)
    sess = _session(monkeypatch, "float32", _mesh(*shape), kw)
    want = ref_lms.train_state_specs(jcfg)[0]
    flat = jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, JP))[0]
    want = {"/".join(k.key for k in path): spec for path, spec in flat}
    placed = dict(zip(_names(sess.params), tree_leaves(sess.params)))
    assert sorted(placed) == sorted(want)
    for name, leaf in placed.items():
        assert JP(*leaf.sharding.spec) == want[name], name
    assert {n for n, leaf in placed.items()
            if tp.model_dim(leaf.sharding.spec, leaf.ndim) is not None} == MODEL_LEAVES
    ref = _params("float32", kw)[0]
    ref = {n: np.asarray(leaf) for n, leaf in zip(_names(ref), jax.tree.leaves(ref))}
    m = shape[1]
    whole = sum(t.shape.numel() * t.dtype.itemsize for t in placed.values())
    with sess.gathered():
        blocks = sess._full
        assert isinstance(blocks, tp.ModelBlocks)
        assert sorted(blocks) == [(CPU, j) for j in range(m)]
        for (_, j), tree in blocks.items():
            h0, h1 = tp.mla_head_range(pcfg, j, m)
            for name, got in zip(_names(tree), tree_leaves(tree)):
                leaf = placed[name]
                d = tp.model_dim(leaf.sharding.spec, leaf.ndim)
                want = ref[name]
                if d is not None:
                    width = HEAD_LEAVES.get(name)
                    lo, hi = ((h0 * width, h1 * width) if width
                              else tp.block_range(leaf.shape[d], j, m))
                    want = np.take(want, range(lo, hi), axis=d)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name} {j}")
        assert blocks.bytes_by_position == {
            pos: sum(t.numel() * t.element_size() for t in tree_leaves(blocks[(CPU, pos[1])]))
            for pos in np.ndindex(*shape)}
        assert all(v < 0.55 * whole for v in blocks.bytes_by_position.values())
    nbytes = {n: t.shape.numel() * t.dtype.itemsize for n, t in placed.items()}
    per_head = sum(nbytes[n] for n in HEAD_LEAVES) // pcfg.n_heads
    rest = sum(nbytes.values()) - sum(nbytes[n] for n in HEAD_LEAVES)
    whole_leaves = sum(v for n, v in nbytes.items() if n not in MODEL_LEAVES)
    for j in range(m):  # the other leaves' blocks, and its heads
        h0, h1 = tp.mla_head_range(pcfg, j, m)
        assert blocks.bytes_by_position[(0, j)] == (whole_leaves + (rest - whole_leaves) // m
                                                    + (h1 - h0) * per_head)


@pytest.mark.parametrize("m,kw", [(2, ()), (4, ()), (4, tuple(sorted(UNEVEN.items())))],
                         ids=["1x2", "1x4", "1x4-heads6"])
def test_decode_moves_none_of_the_latent_cache(monkeypatch, m, kw):
    """A decode step of one MLA layer over a group of ``m`` shards, the
    latent cache split over 'model' (shard ``j``'s mesh position holds
    sequence block ``j``): it moves into each shard other than the home
    ``cq``, the joined query (to run its block's partial) and the combined
    latent of its heads, and into the home each such shard's query heads,
    its block's float32 partial (m, l, latent) and its float32 wo partial;
    nothing the shape of a latent cache block."""
    _, pcfg, mesh, group, lps, _, h = _layer_inputs(m, kw)
    _, placed = _placed_latents(pcfg, mesh)
    shapes = []
    real = tp.ModelGroup.note

    def spy(self, t, src, dst):
        if src != dst:
            shapes.append(tuple(t.shape))
        return real(self, t, src, dst)

    monkeypatch.setattr(tp.ModelGroup, "note", spy)
    pt_model._tp_mla_decode(group, lps, torch.from_numpy(h[:, :1]), PLEN, placed, (0,), 0, 0, pcfg)
    e, heads = 4, pcfg.n_heads  # float32 bytes
    r, qr, rope = pcfg.kv_lora_rank, pcfg.q_lora_rank, pcfg.qk_rope_dim
    own = [h1 - h0 for h0, h1 in (tp.mla_head_range(pcfg, j, m) for j in range(m))]
    into_home = sum(B * own[j] * (r + rope) * e + B * heads * (2 + r) * 4 + B * pcfg.d_model * 4
                    for j in range(1, m))
    assert group.moved == [into_home] + [B * qr * e + B * heads * (r + rope) * e + B * own[j] * r * e
                                         for j in range(1, m)]
    seq = MAX_SEQ // m
    assert not {(B, seq, r), (B, seq, rope), (1, B, seq, r), (1, B, seq, rope)} & set(shapes)


def test_tp_walk_gives_mla_layers_their_own_kind(monkeypatch):
    """The smoke config's two layers walk as kind "mla" with their cache
    leads, each a [shard] list of the group's blocks."""
    sess = _session(monkeypatch, "float32", _mesh(1, 2))
    with sess.gathered():
        group = tp.model_group(sess._full, sess.mesh, (0, 0))
        walk = pt_model._tp_walk(group, sess.cfg)
    assert [(kind, lead, len(lps)) for lead, lps, kind in walk] == [("mla", (0,), 2),
                                                                    ("mla", (1,), 2)]


# ------------------------------------------------------------ planted faults


def _neighbour_latent(monkeypatch):
    """A planted fault: at decode each model shard receives its
    neighbour's heads of the combined latent (``mla_head_range`` patched
    inside ``_tp_mla_decode`` only)."""
    real_decode, real_range = pt_model._tp_mla_decode, tp.mla_head_range

    def crossing(*args, **kwargs):
        monkeypatch.setattr(tp, "mla_head_range", lambda c, j, m: real_range(c, (j + 1) % m, m))
        try:
            return real_decode(*args, **kwargs)
        finally:
            monkeypatch.setattr(tp, "mla_head_range", real_range)

    monkeypatch.setattr(pt_model, "_tp_mla_decode", crossing)


@pytest.mark.parametrize("fault", ["neighbour's latent heads", "dropped partial"])
def test_a_planted_fault_is_seen(monkeypatch, fault):
    """On (1, 2) a decode step's logits, from a copy of the sound prefill's
    cache, land far from the sound run's: a shard that receives its
    neighbour's heads of the combined latent (the prefill reads no combined
    latent, so it stays sound), or a reduction that loses the last shard's
    partial (which moves the prefill too)."""
    _, pcfg = _cfg("float32")
    sess = _session(monkeypatch, "float32", _mesh(1, 2))
    prompts = _prompts(pcfg)
    want, cache = sess.prefill(prompts)
    tok = torch.argmax(want, -1, keepdim=True).to(torch.int32)
    want_step, _ = sess.decode(_clone_cache(cache), tok, PLEN)
    if fault == "dropped partial":
        real = tp.reduce_f32
        monkeypatch.setattr(tp, "reduce_f32",
                            lambda parts, dev, dtype: real(parts[:-1], dev, dtype))
    else:
        _neighbour_latent(monkeypatch)
    got, _ = sess.prefill(prompts)
    got_step, _ = sess.decode(_clone_cache(cache), tok, PLEN)
    if fault == "dropped partial":
        assert _rel(got, want) > 100 * PATH_TOL
    else:
        assert _rel(got, want) <= PATH_TOL
    assert _rel(got_step, want_step) > 100 * PATH_TOL
