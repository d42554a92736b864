"""Tensor-parallel serving of the dense and MoE decoders on logical CPU meshes.

(The VLM's: ``tests/test_torch_tensor_parallel_vlm.py``; the SSM and hybrid
decoders': ``tests/test_torch_tensor_parallel_ssm.py``; the MLA decoder's:
``tests/test_torch_tensor_parallel_mla.py``. This file's last
tests decide which configs take the path and hold the dry run's cells of
all of them.)

deepseek-67b's, qwen1.5-110b's, moonshot-v1-16b-a3b's and dbrx-132b's smoke
configs pinned ``parallelism="tp"`` serve through ``ServeSession(mesh=)``
on (1, 2), (2, 2) and (1, 4): each position gathers over 'data' only, into
its 'model' block of every leaf whose spec has 'model', and computes its
heads, columns, experts and vocab block
(``distributed/tensor_parallel.py``, ``models/model.py::prefill_placed_tp``
and ``decode_placed_tp``). On (1, 4) dbrx's smoke config holds one expert
a shard. The MoE's prefill routes groups of ``min(1024, tokens)``: the 4 x
16 prompts are one group, so its prefill runs them as one data-parallel
shard (``launch/steps.py::_dp_shards``); ``test_torch_tensor_parallel_moe.py``
splits whole groups over 'data' and holds the drops of the production
capacity factor. The oracle is the reference's greedy loop
outside a mesh (``init_cache`` -> ``forward_prefill`` -> ``decode_step`` x n
-> argmax) on the same parameters, converted bit for bit by
``params_from_numpy``: the reference's sharded steps fail on this JAX
(``tests/test_torch_sharded_serve.py`` says why). qwen's biases are drawn
non-zero in both packages (its init makes them 0), so that the bias blocks
count. The smoke configs have 4 query and 2 KV heads: on (1, 4) K does not
divide the model axis, and two shards use each KV head.

Tolerances: float32 equal greedy tokens and 1e-4 on the logits (the
sharded serve tests' ``LOGIT_TOL``); bfloat16 3e-2, both packages fed the
reference's greedy tokens; against the port's gathered path on the same
mesh 1e-5 relative norm (float32): the prefill's logits, and each decode
step run from a copy of the gathered session's cache. A decode step writes
the token's K/V into the bf16 cache (bf16 whatever the run's dtype), where
the two paths' float32 K/V, summed in another order, may round to
neighbouring bf16 values: such a step's cache leaves are held to one bf16
step in at most 0.1 % of their elements, as the sharded serve tests hold a
decoded cache, and its logits to the 1e-4 of the reference comparison.
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
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.launch import steps as pt_steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves  # noqa: E402

CPU = torch.device("cpu")
DENSE = ("deepseek-67b", "qwen1.5-110b")
MOE = ("moonshot-v1-16b-a3b", "dbrx-132b")
ARCHS = DENSE + MOE
IMPL = {"deepseek-67b": "flash", "qwen1.5-110b": "xla", "moonshot-v1-16b-a3b": "flash",
        "dbrx-132b": "xla"}
MESHES = ((1, 2), (2, 2), (1, 4))
B, PLEN, GEN = 4, 16, 6
MAX_SEQ = PLEN + GEN + 2  # even: the sequence splits over 'model'
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PATH_TOL = 1e-5
MODEL_LEAVES = {"tok_embed", "lm_head", "layers/attn/wq", "layers/attn/wk", "layers/attn/wv",
                "layers/attn/wo", "layers/attn/bq", "layers/attn/bk", "layers/attn/bv",
                "layers/mlp/wi_gate", "layers/mlp/wi_up", "layers/mlp/wo",
                "layers/moe/w_gate", "layers/moe/w_up", "layers/moe/w_down",
                # the VLM's image projection and cross layers
                "img_proj", "cross_layers/xattn/wq", "cross_layers/xattn/wk",
                "cross_layers/xattn/wv", "cross_layers/xattn/wo", "cross_layers/mlp/wi_gate",
                "cross_layers/mlp/wi_up", "cross_layers/mlp/wo",
                # a mamba layer's heads and channels; the hybrid's shared block
                "layers/ssm/in_z", "layers/ssm/in_x", "layers/ssm/in_dt", "layers/ssm/conv_x",
                "layers/ssm/a_log", "layers/ssm/d_skip", "layers/ssm/dt_bias",
                "layers/ssm/gate_norm", "layers/ssm/out", "shared/attn/wq", "shared/attn/wk",
                "shared/attn/wv", "shared/attn/wo", "shared/mlp/wi_gate", "shared/mlp/wi_up",
                "shared/mlp/wo",
                # MLA's up-projections (by heads)
                "layers/attn/wuq", "layers/attn/wuk", "layers/attn/wuv"}
VLM = "llama-3.2-vision-90b"  # test_torch_tensor_parallel_vlm.py serves it
MLA = "minicpm3-4b"  # test_torch_tensor_parallel_mla.py serves it
SSM = ("mamba2-780m", "zamba2-7b")  # test_torch_tensor_parallel_ssm.py serves them
# A GQA layout whose query blocks straddle KV heads on 2 shards: 6 query
# heads, 3 KV heads, shard 0 holds heads 0-2 (KV heads 0, 0, 1).
STRADDLE = {"n_heads": 6, "n_kv_heads": 3}


def _cfg(arch, dtype, **kw):
    """(reference config, port config), pinned to the "tp" profile."""
    port = {"attention_impl": IMPL[arch], **kw}
    kw.pop("attention_impl", None)  # the reference attends by its XLA path
    return (jx_get_smoke_config(arch).scaled(dtype=dtype, parallelism="tp", **kw),
            get_smoke_config(arch).scaled(dtype=dtype, parallelism="tp", **port))


def _key(kw: dict) -> tuple:
    return tuple(sorted(kw.items()))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype, kw=()):
    """(reference params, port params): the same numbers in both packages;
    qwen's QKV biases drawn from a seed."""
    jcfg, pcfg = _cfg(arch, dtype, **dict(kw))
    if dtype == "float32":
        jp = jx_model.init_model(jax.random.PRNGKey(0), jcfg)
        if jcfg.qkv_bias:
            rng = np.random.default_rng(3)
            for name in ("bq", "bk", "bv"):
                leaf = jp["layers"]["attn"][name]
                jp["layers"]["attn"][name] = jnp.asarray(
                    0.5 * rng.normal(size=leaf.shape).astype(np.float32))
    else:
        shapes = jax.eval_shape(lambda: jx_model.init_model(jax.random.PRNGKey(0), jcfg))
        jp = jax.tree.map(lambda a, s: a.astype(s.dtype), _params(arch, "float32", kw)[0],
                          shapes)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, "cpu")


def _prompts(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab, (B, PLEN), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _reference_greedy(arch, dtype, kw=()):
    """The reference's greedy loop outside a mesh: (tokens [B, GEN], logits
    [GEN, B, V]), its two steps jitted."""
    jcfg, _ = _cfg(arch, dtype, **dict(kw))
    params, _ = _params(arch, dtype, kw)
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


def _session(monkeypatch, arch, dtype, mesh, kw=(), params=None):
    """A session of ``arch``'s smoke config pinned "tp" (``kw`` replaces
    more fields) on ``mesh`` (None: one device)."""
    _, pcfg = _cfg(arch, dtype, **dict(kw))
    monkeypatch.setattr(pt_serve, "get_smoke_config", lambda a: pcfg)
    return pt_serve.ServeSession(arch, smoke=True, mesh=mesh, device="cpu", dtype=dtype,
                                 batch=B, max_seq=MAX_SEQ,
                                 params=_params(arch, dtype, kw)[1] if params is None else params)


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


# ------------------------------------------------------------ the reference


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_float32_equals_reference_greedy(monkeypatch, arch, mesh):
    _, pcfg = _cfg(arch, "float32")
    sess = _session(monkeypatch, arch, "float32", _mesh(*mesh))
    assert tp.serves_tensor_parallel(sess.cfg, sess.mesh)
    prompts = _prompts(pcfg)
    tokens, stats = sess.generate(prompts, GEN, keep_logits=True)
    want_tokens, want_logits = _reference_greedy(arch, "float32")
    np.testing.assert_array_equal(tokens[:, :PLEN], prompts)
    np.testing.assert_array_equal(tokens[:, PLEN:], want_tokens)
    _close(stats["logits"], want_logits, LOGIT_TOL["float32"])
    assert sess._full is None  # the gathered blocks are freed after the call


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_bfloat16_teacher_forced(monkeypatch, arch, mesh):
    _, pcfg = _cfg(arch, "bfloat16")
    sess = _session(monkeypatch, arch, "bfloat16", _mesh(*mesh))
    want_tokens, want_logits = _reference_greedy(arch, "bfloat16")
    with sess.gathered():
        logits, cache = sess.prefill(_prompts(pcfg))
        got = [logits]
        for i in range(GEN - 1):
            logits, cache = sess.decode(cache, torch.from_numpy(want_tokens[:, i:i + 1].copy()),
                                        PLEN + i)
            got.append(logits)
    _close(torch.stack(got), want_logits, LOGIT_TOL["bfloat16"])


def test_query_blocks_straddling_kv_heads(monkeypatch):
    """6 query heads over 3 KV heads on 2 shards: shard 0's heads use KV
    heads 0, 0, 1, which the kernel's GQA cannot take as they are, so they
    are expanded to one a query head. The session equals the reference's
    greedy loop."""
    kw = _key(STRADDLE)
    _, pcfg = _cfg("deepseek-67b", "float32", **STRADDLE)
    assert tp.kv_block(pcfg, 0, 2) == (0, 2, [0, 0, 1])
    assert tp.kv_block(pcfg, 1, 2) == (1, 3, [0, 1, 1])
    sess = _session(monkeypatch, "deepseek-67b", "float32", _mesh(1, 2), kw)
    tokens, stats = sess.generate(_prompts(pcfg), GEN, keep_logits=True)
    want_tokens, want_logits = _reference_greedy("deepseek-67b", "float32", kw)
    np.testing.assert_array_equal(tokens[:, PLEN:], want_tokens)
    _close(stats["logits"], want_logits, LOGIT_TOL["float32"])


def test_kv_blocks_of_the_production_configs():
    """deepseek-67b and qwen1.5-110b at model 16: 4 query heads a shard,
    all on one KV head, two shards a KV head (K = 8 does not divide 16);
    at model 2, 32 query heads on 4 KV heads a shard, as they are."""
    from repro_torch.configs import get_config

    for arch in DENSE:
        cfg = get_config(arch)
        assert [tp.kv_block(cfg, j, 16) for j in range(16)] == [(j // 2, j // 2 + 1, None)
                                                                for j in range(16)]
        assert [tp.kv_block(cfg, j, 2) for j in range(2)] == [(0, 4, None), (4, 8, None)]
        assert tp.head_range(cfg, 3, 16) == (12, 16)


# ------------------------------------------------------------ the gathered path


def _clone_cache(cache):
    return {k: ShardedTensor(v.shape, v.dtype, v.sharding,
                             {i: t.clone() for i, t in v.blocks.items()})
            for k, v in cache.items()}


def _ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    return (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_matches_gathered_path(monkeypatch, arch, mesh):
    """Float32, the same mesh: the prefill's logits, then each decode step
    from a copy of the gathered session's cache (module docstring)."""
    _, pcfg = _cfg(arch, "float32")
    mesh = _mesh(*mesh)
    sess = _session(monkeypatch, arch, "float32", mesh)
    gathered = _session(monkeypatch, arch, "float32", mesh)
    real = pt_steps.serves_tensor_parallel

    def on_gathered(fn, *args):
        monkeypatch.setattr(pt_steps, "serves_tensor_parallel", lambda cfg, mesh: False)
        try:
            return fn(*args)
        finally:
            monkeypatch.setattr(pt_steps, "serves_tensor_parallel", real)

    prompts = _prompts(pcfg)
    got, _ = sess.prefill(prompts)
    want, cache = on_gathered(gathered.prefill, prompts)
    assert _rel(got, want) <= PATH_TOL
    exact_steps = 0
    for i in range(GEN - 1):
        tok = torch.argmax(want, -1, keepdim=True).to(torch.int32)
        got, mine = sess.decode(_clone_cache(cache), tok, PLEN + i)
        want, cache = on_gathered(gathered.decode, cache, tok, PLEN + i)
        written = [_ulps(mine[k].full(CPU), cache[k].full(CPU)) for k in ("k", "v")]
        for u in written:
            assert int(u.max()) <= 1 and float((u > 0).float().mean()) <= 1e-3
        if all(int(u.max()) == 0 for u in written):
            exact_steps += 1
            assert _rel(got, want) <= PATH_TOL, i
        else:
            _close(got, want, LOGIT_TOL["float32"])
    assert exact_steps >= 1


def test_a_dropped_partial_is_seen(monkeypatch):
    """The bound sees a reduction that loses the last shard's partial."""
    _, pcfg = _cfg("deepseek-67b", "float32")
    sess = _session(monkeypatch, "deepseek-67b", "float32", _mesh(1, 2))
    want, _ = sess.prefill(_prompts(pcfg))
    real = tp.reduce_f32
    monkeypatch.setattr(tp, "reduce_f32", lambda parts, dev, dtype: real(parts[:-1], dev, dtype))
    got, _ = sess.prefill(_prompts(pcfg))
    assert _rel(got, want) > 100 * PATH_TOL


# ------------------------------------------------------------ blocks


class DuckMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape, names):
        self.devices = np.empty(shape)
        self.axis_names = tuple(names)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_each_position_gathers_its_model_blocks(monkeypatch, arch, mesh):
    """The placed leaves' specs equal the reference's ``train_state_specs``;
    each position's gathered tree holds exactly the 'model' block of every
    leaf whose spec has 'model' (the placed leaf's region, none whole) and
    every other leaf whole; its bytes are recorded."""
    jcfg, pcfg = _cfg(arch, "float32")
    shape = mesh
    mesh = _mesh(*shape)
    sess = _session(monkeypatch, arch, "float32", mesh)
    want = ref_lms.train_state_specs(jcfg)[0]
    flat = jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, JP))[0]
    want = {"/".join(k.key for k in path): spec for path, spec in flat}
    placed = dict(zip(_names(sess.params), tree_leaves(sess.params)))
    assert sorted(placed) == sorted(want)
    for name, leaf in placed.items():
        assert JP(*leaf.sharding.spec) == want[name], name
    assert {n for n, leaf in placed.items()
            if tp.model_dim(leaf.sharding.spec, leaf.ndim) is not None} == MODEL_LEAVES & set(placed)
    assert pcfg.qkv_bias == ("layers/attn/bq" in placed)
    m = shape[1]
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
                assert got.shape[d] == leaf.shape[d] // m, name
                lo, hi = tp.block_range(leaf.shape[d], j, m)
                assert torch.equal(got, full.narrow(d, lo, hi - lo)), (name, j)
        total = sum(t.numel() * t.element_size() for t in tree_leaves(blocks[(CPU, 0)]))
        assert blocks.bytes_by_position == {pos: total for pos in np.ndindex(*shape)}
    nbytes = {n: t.shape.numel() * t.dtype.itemsize for n, t in placed.items()}
    norms = sum(v for n, v in nbytes.items() if n not in MODEL_LEAVES)
    assert total == norms + (sum(nbytes.values()) - norms) // m
    assert sess._full is None


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_launches_flash_on_each_shard_heads(monkeypatch, arch):
    """On 2 x 2 the prefill attends once a (layer, data shard, model
    shard), on that shard's H/m query heads and the KV heads they use. The
    MoE's 4 x 16 prompts are one routing group: one data shard."""
    _, pcfg = _cfg(arch, "float32", attention_impl="flash")
    calls = []
    real = pt_layers.flash_attention_bshd

    def spy(q, k, v, *a, **kw):
        calls.append((q.shape[0], q.shape[2], k.shape[2]))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(pt_layers, "flash_attention_bshd", spy)
    monkeypatch.setattr(pt_serve, "get_smoke_config", lambda a: pcfg)
    sess = pt_serve.ServeSession(arch, smoke=True, mesh=_mesh(2, 2), device="cpu",
                                 dtype="float32", batch=B, max_seq=MAX_SEQ,
                                 params=_params(arch, "float32")[1])
    logits, cache = sess.prefill(_prompts(pcfg))
    h, k = pcfg.n_heads, pcfg.n_kv_heads
    dp = 1 if pcfg.family == "moe" else 2
    assert calls == [(B // dp, h // 2, k // 2)] * (pcfg.n_layers * dp * 2)
    calls.clear()
    sess.decode(cache, torch.argmax(logits, -1, keepdim=True), PLEN)
    assert calls == []  # decode attends by sequence blocks, as on the gathered path


# ------------------------------------------------------------ the other configs


# A mesh whose 'model' axis divides every leaf's blocks but not the heads
# (mamba2 has none: its placement splits the SSM heads' own leaves)
REFUSED = {"moonshot-v1-16b-a3b": (1, 8), "minicpm3-4b": (1, 8)}


@pytest.mark.parametrize("arch", ("moonshot-v1-16b-a3b", "mamba2-780m", "minicpm3-4b"))
def test_other_families_on_tp_keep_the_gathered_path(monkeypatch, arch):
    """Pinned "tp": the MoE, SSM and MLA configs, which once gathered every
    parameter whole on 2 x 2, take the tensor-parallel path there and
    gather their ``ModelBlocks`` (the experts, the SSM heads, MLA's heads
    split over 'model'); on a 'model' axis that their heads refuse
    (``REFUSED``) they keep the gathered path and gather every parameter
    whole. All give the one-device session's results."""
    pinned = get_smoke_config(arch).scaled(parallelism="tp")
    monkeypatch.setattr(pt_serve, "get_smoke_config", lambda a: pinned)
    common = dict(smoke=True, dtype="float32", batch=B, max_seq=MAX_SEQ)
    one = pt_serve.ServeSession(arch, device="cpu", **common)
    prompts = _prompts(pinned)
    want_tokens, want = one.generate(prompts, GEN, keep_logits=True)
    total = sum(t.numel() * t.element_size() for t in tree_leaves(one.params))
    meshes = [(_mesh(2, 2), True)] + ([(_mesh(*REFUSED[arch]), False)] if arch in REFUSED else [])
    for mesh, takes_tp in meshes:
        sess = pt_serve.ServeSession(arch, mesh=mesh, params=one.params, **common)
        pcfg = sess.cfg
        assert pcfg.parallelism == "tp" and tp.serves_tensor_parallel(pcfg, mesh) == takes_tp
        with sess.gathered():
            if takes_tp:
                assert isinstance(sess._full, tp.ModelBlocks)
                assert all(v < 0.55 * total for v in sess._full.bytes_by_position.values())
            else:
                assert isinstance(sess._full, pt_steps.GatheredParams)
                assert set(sess._full.bytes_by_position.values()) == {total}
        tokens, got = sess.generate(prompts, GEN, keep_logits=True)
        np.testing.assert_array_equal(tokens, want_tokens)
        _close(got["logits"], want["logits"], LOGIT_TOL["float32"])


def test_which_configs_serve_tensor_parallel():
    """The one test that decides: the "tp" profile, and a 'model' axis
    dividing the query heads of the dense, MoE or VLM family with GQA
    attention (and the experts), the SSM heads of the SSM family, both of
    the hybrid; for the MLA decoder no larger than the heads and dividing
    the columns of wuq/wuk/wuv, the rows of wo and ``d_ff``. The production
    meshes give moonshot 4 experts a shard and dbrx 1; 2 x 2, 32 and 8. The
    VLM, mamba2-780m (48 SSM heads: 3 a shard on 16), zamba2-7b (112 SSM
    heads and 32 query heads: 7 and 2), minicpm3-4b (40 heads: 2 or 3 a
    shard on 16, 20 on 2) and the audio encoder hubert-xlarge (16 heads: 1
    a shard on 16, 8 on 2) take it on the production meshes and on 2 x 2;
    the "dp" configs do not."""
    from repro_torch.configs import get_config

    prod = DuckMesh((16, 16), ("data", "model"))
    multi = DuckMesh((2, 16, 16), ("pod", "data", "model"))
    assert {a for a in ("deepseek-67b", "qwen1.5-110b", "smollm-135m", "minicpm3-4b",
                        "moonshot-v1-16b-a3b", "dbrx-132b", "mamba2-780m", "zamba2-7b",
                        "llama-3.2-vision-90b", "hubert-xlarge")
            if tp.serves_tensor_parallel(get_config(a), prod)
            and tp.serves_tensor_parallel(get_config(a), multi)} == (set(ARCHS) | {VLM, MLA}
                                                                      | set(SSM)
                                                                      | {"hubert-xlarge"})
    two = DuckMesh((2, 2), ("data", "model"))
    assert all(tp.serves_tensor_parallel(get_config(a), two) for a in (VLM, MLA, *SSM))
    assert all(tp.serves_tensor_parallel(get_config("hubert-xlarge"), m)
               for m in (prod, multi, two))
    mla = get_config(MLA)
    heads = [tp.mla_head_range(mla, j, 16) for j in range(16)]
    assert heads[0] == (0, 2) and heads[-1] == (37, 40)
    assert [h1 - h0 for h0, h1 in heads] == [2, 3, 2, 3, 2, 3, 2, 3] * 2
    assert [tp.mla_head_range(mla, j, 2) for j in range(2)] == [(0, 20), (20, 40)]
    assert tp.block_spans(mla, 1, 16) == {"layers/attn/wuq": (192, 480),
                                          "layers/attn/wuk": (128, 320),
                                          "layers/attn/wuv": (128, 320),
                                          "layers/attn/wo": (128, 320)}
    assert tp.block_spans(get_config("deepseek-67b"), 1, 16) == {}
    assert not tp.serves_tensor_parallel(mla.scaled(parallelism="dp"), prod)
    small = get_smoke_config(MLA)  # 4 heads, pinned "tp" as the full config
    assert tp.serves_tensor_parallel(small, DuckMesh((1, 4), ("data", "model")))
    assert not tp.serves_tensor_parallel(small, DuckMesh((1, 8), ("data", "model")))
    assert not tp.serves_tensor_parallel(small.scaled(d_ff=129), two)
    assert [tp.ssm_head_range(get_config(a), 15, 16) for a in SSM] == [(45, 48), (105, 112)]
    assert [tp.ssm_channel_range(get_config(a), 1, 16) for a in SSM] == [(8, 16), (4, 8)]
    for arch in SSM:  # "auto" puts the smoke configs' 8 SSM heads on "dp"
        cfg = get_smoke_config(arch)
        assert not tp.serves_tensor_parallel(cfg, two)
        assert tp.serves_tensor_parallel(cfg.scaled(parallelism="tp"), DuckMesh((1, 4),
                                                                                ("data", "model")))
        assert not tp.serves_tensor_parallel(cfg.scaled(parallelism="tp"), DuckMesh(
            (1, 16), ("data", "model")))  # 8 SSM heads
    hybrid = get_smoke_config("zamba2-7b").scaled(parallelism="tp", n_heads=6, n_kv_heads=6)
    assert not tp.serves_tensor_parallel(hybrid, DuckMesh((1, 4), ("data", "model")))
    assert [tp.kv_block(get_config(VLM), j, m) for m, j in ((16, 15), (2, 1))] == [
        (7, 8, None), (4, 8, None)]
    for arch, per in (("moonshot-v1-16b-a3b", (4, 32)), ("dbrx-132b", (1, 8))):
        cfg = get_config(arch)
        assert tp.serves_tensor_parallel(cfg, two)
        assert [tp.expert_range(cfg, j, m)[1] - tp.expert_range(cfg, j, m)[0]
                for m, j in ((16, 15), (2, 1))] == list(per)
    moe = get_smoke_config("dbrx-132b").scaled(parallelism="tp")  # 4 heads, 4 experts
    assert tp.serves_tensor_parallel(moe, DuckMesh((1, 4), ("data", "model")))
    assert not tp.serves_tensor_parallel(moe.scaled(n_experts=6), DuckMesh((1, 4),
                                                                          ("data", "model")))
    cfg = get_smoke_config("deepseek-67b")
    assert not tp.serves_tensor_parallel(cfg, _mesh(1, 2))  # "auto": 4 heads -> "dp"
    assert tp.serves_tensor_parallel(cfg.scaled(parallelism="tp"), _mesh(1, 4))
    assert not tp.serves_tensor_parallel(cfg.scaled(parallelism="tp"), DuckMesh((1, 8),
                                                                                ("data", "model")))
    assert not tp.serves_tensor_parallel(cfg.scaled(parallelism="tp"), DuckMesh((4,), ("data",)))
    with pytest.raises(ValueError, match="ModelBlocks"):
        pcfg = cfg.scaled(parallelism="tp", dtype="float32")
        mesh = _mesh(1, 2)
        params = pt_steps.place_params(pcfg, mesh, _params("deepseek-67b", "float32")[1])
        pt_steps.make_prefill_step(pcfg, mesh)(pt_steps.gather_params(params, mesh), {
            "k": torch.zeros(2, B, MAX_SEQ, 2, 16, dtype=torch.bfloat16),
            "v": torch.zeros(2, B, MAX_SEQ, 2, 16, dtype=torch.bfloat16)},
            {"tokens": torch.from_numpy(_prompts(pcfg))})


# ------------------------------------------------------------ the dry run


@pytest.mark.parametrize("arch", ARCHS + (VLM,) + SSM + (MLA,))
def test_dryrun_serving_cells_take_the_tensor_parallel_step(monkeypatch, arch):
    """At 2 layers on the production mesh (the VLM: one self and one cross
    layer; zamba2: two mamba layers and the shared block): a device gathers
    its model blocks (1/16 of every 'model' leaf), and its matmul FLOPs are
    the gathered path's count over the model axis (the same products,
    split: the VLM's image projection and cross K/V, the SSM's B/C
    channels and heads too), but for the MoE's router product, which the
    home runs whole. MLA's home holds and computes its 2 heads of 40
    (head-aligned, where 1/16 would be 2.5; 3 on the shards that hold the
    most) and runs the latent projections wdq/wdkv whole; at decode the
    latent cache's sequence block it holds, for every head. A 3-head
    shard's own step is counted too, and the group's bound is the larger.
    The SSM and hybrid also at long_500k."""
    from repro_torch.launch.specs import CellSpec

    shapes = ("prefill_32k", "decode_32k") + (("long_500k",) if arch in SSM else ())
    for shape in shapes:
        r = dryrun.run_cell(arch, shape, "single", n_layers=2)
        spec = CellSpec(arch, shape)
        spec.cfg = dryrun.cut_depth(spec.cfg, 2)
        leaves = tree_leaves(spec.params_struct())
        names = _names(spec.params_struct())
        whole = sum(t.numel() * t.element_size() for t in leaves)
        model = sum(t.numel() * t.element_size() for n, t in zip(names, leaves)
                    if n in MODEL_LEAVES)
        mla = spec.cfg.attention == "mla"
        heads = sum(t.numel() * t.element_size() for n, t in zip(names, leaves)
                    if mla and n in {f"layers/attn/{w}" for w in ("wuq", "wuk", "wuv", "wo")})
        per_head = heads // spec.cfg.n_heads if mla else 0
        home = whole - model + (model - heads) // 16
        assert r["memory"]["gathered_params_bytes"] == home + 2 * per_head * mla
        assert r["memory"]["gathered_params_bytes_max_shard"] == home + 3 * per_head * mla
        assert r.get("max_shard_heads") == (3 if mla else None)
        assert r["model_shards"] == 16 and r["collectives"]["by_op"]["activations"] > 0
        monkeypatch.setattr(dryrun, "serves_tensor_parallel", lambda cfg, mesh: False)
        g = dryrun.run_cell(arch, shape, "single", n_layers=2)
        monkeypatch.undo()
        assert g["memory"]["gathered_params_bytes"] == whole and g["rows"] == r["rows"]
        cfg, router = spec.cfg, 0
        if cfg.family == "moe":
            tokens = r["rows"] * (spec.shape.seq if spec.shape.kind == "prefill" else 1)
            router = 2 * tokens * cfg.d_model * cfg.n_experts * cfg.n_layers
        home = 0  # what the home's MLA heads and latent projections add to its 1/16
        if mla:
            d, qr, kvr, rope = cfg.d_model, cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_rope_dim
            nope, vd, seq = cfg.qk_nope_dim, cfg.v_head_dim, spec.shape.seq
            tokens = r["rows"] * (seq if spec.shape.kind == "prefill" else 1)
            if spec.shape.kind == "prefill":  # wuq, wuk, wuv, wo and the attention core a head
                head = (2 * tokens * (qr * (nope + rope) + 2 * kvr * nope + vd * d)
                        + 2 * r["rows"] * seq * seq * (nope + rope + vd))
            else:  # wuq, the absorbed query, the latent through wuv, wo a head
                head = 2 * tokens * (qr * (nope + rope) + nope * kvr + kvr * vd + vd * d)
            whole_mm = 2 * tokens * d * (qr + kvr + rope)
            home = cfg.n_layers * (15 / 16 * whole_mm + head * (2 - cfg.n_heads / 16))
        assert r["matmul_flops_per_device"] == pytest.approx(
            (g["matmul_flops_per_device"] - router) / 16 + router + home, rel=1e-9)
        bound = r["roofline"]["step_lower_bound_s"]
        if mla:  # a 3-head shard's own step: a head more than the home, no latent projections
            own = r["max_shard_step"]
            assert own["heads"] == 3 and own["matmul_flops"] == pytest.approx(
                r["matmul_flops_per_device"] + cfg.n_layers * (head - whole_mm), rel=1e-9)
            bound = max(bound, own["roofline"]["step_lower_bound_s"])
        else:
            assert "max_shard_step" not in r
        assert r["group_step_lower_bound_s"] == bound
        # The home shard, counted, also runs the group's reductions: more
        # than a sixteenth of the step's bytes.
        assert r["bytes_per_device"] > g["bytes_per_device"] / 16
