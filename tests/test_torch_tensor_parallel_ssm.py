"""Tensor-parallel serving of the SSM and hybrid decoders on logical CPU meshes.

mamba2-780m's and zamba2-7b's smoke configs (8 SSM heads of 16 channels,
state 16, one group; zamba2's shared block 4 query and 4 KV heads of 16,
after every 2 of its 5 mamba layers) pinned ``parallelism="tp"`` (the
"auto" profile puts 8 SSM heads on "dp" at the production axis of 16)
serve through ``ServeSession(mesh=)`` on (1, 2), (2, 2) and (1, 4): each
position gathers over 'data' only, into its 'model' block of every leaf
whose spec has 'model' (a mamba layer's ``in_z``/``in_x``/``in_dt``
columns, ``conv_x`` channels, ``a_log``/``dt_bias``/``d_skip`` heads,
``gate_norm`` channels and ``out`` rows; the shared block's wq/wk/wv and
MLP columns and wo rows; the vocab blocks), and computes its SSM heads,
its channels of B and C (joined on the home, sent whole), its attention
heads and its vocab block (``models/model.py::_tp_mamba``,
``prefill_placed_tp``, ``decode_placed_tp``). On (1, 4) each zamba2 shard
holds 2 SSM heads and 1 attention head.

The oracle is the reference's greedy loop outside a mesh (``init_cache`` ->
``forward_prefill`` -> ``decode_step`` x n -> argmax) on the same
parameters, converted bit for bit by ``params_from_numpy``. Tolerances, as
``tests/test_torch_tensor_parallel.py``'s: float32 equal greedy tokens and
1e-4 on the logits; bfloat16 3e-2, both packages fed the reference's greedy
tokens; against the port's gathered path on the same mesh 1e-5 relative
norm (float32), each decode step run from a copy of the gathered session's
cache, whose bf16 leaves (zamba2's shared K/V) the two paths may round
apart in at most 0.1 % of their elements, each by one bf16 step of the
larger of its magnitude and the leaf's root mean square (then the step's
logits are held to 1e-4); one layer's shard functions joined over the shards
against the reference's ``ssm_forward``/``ssm_decode`` 1e-5. A decode step
moves nothing of the SSM state between shards. A reduction that drops the
last shard's partial, and a shard that reads its neighbour's head block of
the SSM state at decode, must be seen.
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
from repro.models import ssm as jx_ssm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as pt_sharding  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.sharding import ShardedTensor  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.launch import steps as pt_steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models import model as pt_model  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ("mamba2-780m", "zamba2-7b")
MESHES = ((1, 2), (2, 2), (1, 4))
B, PLEN, GEN = 4, 16, 6
MAX_SEQ = PLEN + GEN + 2  # splits over a 'model' axis of 2 or 4
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
PATH_TOL = 1e-5
STATES = ("conv_x", "conv_b", "conv_c", "ssm")
MODEL_LEAVES = {"tok_embed", "lm_head"} | {
    f"layers/ssm/{w}" for w in ("in_z", "in_x", "in_dt", "conv_x", "a_log", "d_skip", "dt_bias",
                                "gate_norm", "out")} | {
    f"shared/{block}/{w}" for block, ws in (("attn", ("wq", "wk", "wv", "wo")),
                                            ("mlp", ("wi_gate", "wi_up", "wo")))
    for w in ws}


def _ids(m):
    return f"{m[0]}x{m[1]}"


def _cfg(arch, dtype):
    """(reference config, port config), pinned to the "tp" profile; the
    reference attends by its XLA path, the port by flash (its plain version
    here)."""
    return (jx_get_smoke_config(arch).scaled(dtype=dtype, parallelism="tp"),
            get_smoke_config(arch).scaled(dtype=dtype, parallelism="tp", attention_impl="flash"))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    """(reference params, port params): the same numbers in both packages
    (bf16: the float32 init cast to the reference's bf16 init's dtypes, the
    SSM's ``a_log`` and ``dt_bias`` float32)."""
    jcfg, pcfg = _cfg(arch, dtype)
    if dtype == "float32":
        jp = jx_model.init_model(jax.random.PRNGKey(0), jcfg)
    else:
        shapes = jax.eval_shape(lambda: jx_model.init_model(jax.random.PRNGKey(0), jcfg))
        jp = jax.tree.map(lambda a, s: a.astype(s.dtype), _params(arch, "float32")[0], shapes)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, "cpu")


def _prompts(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab, (B, PLEN), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _reference_greedy(arch, dtype):
    """The reference's greedy loop outside a mesh: (tokens [B, GEN], logits
    [GEN, B, V]), its two steps jitted."""
    jcfg, _ = _cfg(arch, dtype)
    params, _ = _params(arch, dtype)
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


def _session(monkeypatch, arch, dtype, mesh, params=None):
    """A session of ``arch``'s smoke config pinned "tp" on ``mesh`` (the
    shared parameters unless ``params`` are given)."""
    _, pcfg = _cfg(arch, dtype)
    monkeypatch.setattr(pt_serve, "get_smoke_config", lambda a: pcfg)
    return pt_serve.ServeSession(arch, smoke=True, mesh=mesh, device="cpu", dtype=dtype,
                                 batch=B, max_seq=MAX_SEQ,
                                 params=_params(arch, dtype)[1] if params is None else params)


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
    """A copy of a placed cache, its SSM states' subtree included."""
    if isinstance(cache, dict):
        return {k: _clone_cache(v) for k, v in cache.items()}
    return ShardedTensor(cache.shape, cache.dtype, cache.sharding,
                         {i: t.clone() for i, t in cache.blocks.items()})


def _near_bf16(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Two bf16 leaves apart in at most 0.1 % of their elements, each by at
    most one bf16 step (2^-8) of the larger of its magnitude and the leaf's
    root mean square (an element near zero may part by several of its own
    steps)."""
    a, b = got.float(), want.float()
    scale = torch.maximum(b.abs(), b.pow(2).mean().sqrt())
    d = (a - b).abs()
    return bool((d <= 2.0 ** -8 * scale).all()) and float((d > 0).float().mean()) <= 1e-3


def _gathered(monkeypatch, fn, *args):
    """``fn(*args)`` with ``serves_tensor_parallel`` patched off: the
    gathered path on the same mesh."""
    real = pt_steps.serves_tensor_parallel
    monkeypatch.setattr(pt_steps, "serves_tensor_parallel", lambda cfg, mesh: False)
    try:
        return fn(*args)
    finally:
        monkeypatch.setattr(pt_steps, "serves_tensor_parallel", real)


def _states_close(mine, theirs):
    """Each placed SSM state leaf within ``PATH_TOL`` relative norm."""
    for k in STATES:
        assert _rel(mine["ssm"][k].full(CPU), theirs["ssm"][k].full(CPU)) <= PATH_TOL, k


def _passing_conv(params):
    """``params`` with each mamba layer's depthwise conv taps passing their
    input (1 added to the last tap). At the init's taps (N(0, 0.02^2)) the
    conv shrinks x, B and C about 30 x each, so the scan's recurrent term
    ``C·h`` is about 1e-4 of the skip ``D·x`` at these widths and a fault in
    the state moves the logits by about 2e-6; passed through, about 2e-3."""
    out = {k: v for k, v in params.items()}
    out["layers"] = {**params["layers"], "ssm": dict(params["layers"]["ssm"])}
    for k in ("conv_x", "conv_b", "conv_c"):
        leaf = params["layers"]["ssm"][k].clone()
        leaf[:, -1] += 1.0
        out["layers"]["ssm"][k] = leaf
    return out


# ------------------------------------------------------------ the reference


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_ssm_float32_equals_reference_greedy(monkeypatch, arch, mesh):
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


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_ssm_bfloat16_teacher_forced(monkeypatch, arch, mesh):
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


def _layer_inputs(arch, m):
    """Layer 0 of the float32 smoke config on a (1, m) mesh: (port config,
    reference layer params, the group, its [shard] layer blocks, a random
    x [B, L, d], a random state of the layer)."""
    jcfg, pcfg = _cfg(arch, "float32")
    mesh = _mesh(1, m)
    params = pt_steps.place_params(pcfg, mesh, _params(arch, "float32")[1])
    blocks = pt_steps.gather_params(params, mesh, pcfg)
    group = tp.model_group(blocks, mesh, (0, 0))
    lps = pt_model._tp_layers(group, pcfg)[0]
    jp = jax.tree.map(lambda t: t[0], _params(arch, "float32")[0]["layers"])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, PLEN, pcfg.d_model)).astype(np.float32)
    shapes = jx_ssm.ssm_state_shapes(jcfg, B)
    state = {k: (0.5 * rng.normal(size=s.shape)).astype(np.float32) for k, s in shapes.items()}
    return jcfg, pcfg, group, lps, jp, x, state


@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_functions_join_to_the_reference_layer(arch, m):
    """One mamba layer over a group of ``m`` shards (``_tp_mamba``): at the
    prefill, from zero states, the output and the states joined over the
    shards against the reference's ``ssm_forward``; at decode, from each
    shard's slice of a random state (float32 conv states), against its
    ``ssm_decode``. Float32, 1e-5."""
    jcfg, pcfg, group, lps, jp, x, state = _layer_inputs(arch, m)
    h = jx_layers.rmsnorm(jnp.asarray(x), jp["ln"], jcfg.norm_eps)
    want, want_state = jx_ssm.ssm_forward(jp["ssm"], h, jcfg)
    got, new = pt_model._tp_mamba(group, lps, torch.from_numpy(x), pcfg)
    _close(got, x + np.asarray(want), PATH_TOL)
    for k, d in pt_model._STATE_DIM.items():
        _close(torch.cat([st[k] for st in new], dim=d), want_state[k], PATH_TOL)
    x1 = x[:, :1]
    h1 = jx_layers.rmsnorm(jnp.asarray(x1), jp["ln"], jcfg.norm_eps)
    want, want_state = jx_ssm.ssm_decode(jp["ssm"], h1, jcfg,
                                         {k: jnp.asarray(v) for k, v in state.items()})
    hp = pcfg.ssm_head_dim
    own = []
    for j in range(m):
        h0, h1_ = tp.ssm_head_range(pcfg, j, m)
        c0, c1 = tp.ssm_channel_range(pcfg, j, m)
        own.append({"conv_x": torch.from_numpy(state["conv_x"][..., h0 * hp:h1_ * hp]),
                    "conv_b": torch.from_numpy(state["conv_b"][..., c0:c1]),
                    "conv_c": torch.from_numpy(state["conv_c"][..., c0:c1]),
                    "ssm": torch.from_numpy(state["ssm"][:, h0:h1_])})
    got, new = pt_model._tp_mamba(group, lps, torch.from_numpy(x1), pcfg, own)
    _close(got, x1 + np.asarray(want), PATH_TOL)
    for k, d in pt_model._STATE_DIM.items():
        _close(torch.cat([st[k] for st in new], dim=d), want_state[k], PATH_TOL)


# ------------------------------------------------------------ the gathered path


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_ssm_matches_gathered_path(monkeypatch, arch, mesh):
    """Float32, the same mesh: the prefill's logits and placed caches, then
    each decode step from a copy of the gathered session's cache (module
    docstring), its states too."""
    _, pcfg = _cfg(arch, "float32")
    mesh = _mesh(*mesh)
    sess = _session(monkeypatch, arch, "float32", mesh)
    gathered = _session(monkeypatch, arch, "float32", mesh)
    prompts = _prompts(pcfg)
    got, mine = sess.prefill(prompts)
    want, cache = _gathered(monkeypatch, gathered.prefill, prompts)
    assert _rel(got, want) <= PATH_TOL
    _states_close(mine, cache)
    attn = ("shared_k", "shared_v") if pcfg.family == "hybrid" else ()
    for k in attn:
        assert _near_bf16(mine[k].full(CPU), cache[k].full(CPU)), k
    exact_steps = 0
    for i in range(GEN - 1):
        tok = torch.argmax(want, -1, keepdim=True).to(torch.int32)
        got, mine = sess.decode(_clone_cache(cache), tok, PLEN + i)
        want, cache = _gathered(monkeypatch, gathered.decode, cache, tok, PLEN + i)
        assert all(_near_bf16(mine[k].full(CPU), cache[k].full(CPU)) for k in attn)
        if all(torch.equal(mine[k].full(CPU), cache[k].full(CPU)) for k in attn):
            exact_steps += 1
            assert _rel(got, want) <= PATH_TOL, i
            _states_close(mine, cache)
        else:
            _close(got, want, LOGIT_TOL["float32"])
    assert exact_steps >= 1


# ------------------------------------------------------------ blocks and moves


@pytest.mark.parametrize("mesh", MESHES, ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_position_gathers_its_ssm_model_blocks(monkeypatch, arch, mesh):
    """The placed leaves' specs equal the reference's ``train_state_specs``;
    the leaves split over 'model' are ``MODEL_LEAVES``; each position's
    gathered tree holds exactly their 'model' block and every other leaf
    (the norms, ``in_b``/``in_c``/``conv_b``/``conv_c``) whole, under 0.55
    of the whole tree's bytes."""
    jcfg, _ = _cfg(arch, "float32")
    shape = mesh
    sess = _session(monkeypatch, arch, "float32", _mesh(*shape))
    want = ref_lms.train_state_specs(jcfg)[0]
    flat = jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, JP))[0]
    want = {"/".join(k.key for k in path): spec for path, spec in flat}
    placed = dict(zip(_names(sess.params), tree_leaves(sess.params)))
    assert sorted(placed) == sorted(want)
    for name, leaf in placed.items():
        assert JP(*leaf.sharding.spec) == want[name], name
    assert {n for n, leaf in placed.items()
            if tp.model_dim(leaf.sharding.spec, leaf.ndim) is not None} == MODEL_LEAVES & set(placed)
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
    whole_leaves = sum(v for n, v in nbytes.items() if n not in MODEL_LEAVES)
    assert total == whole_leaves + (whole - whole_leaves) // m


@pytest.mark.parametrize("mesh", ((2, 2), (1, 4)), ids=_ids)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_moves_none_of_the_ssm_state(monkeypatch, arch, mesh):
    """A decode step reads each shard's blocks of the states as views of
    the blocks its own mesh position holds (its heads of ``ssm`` and
    channels of ``conv_x``, its channels of ``conv_b``/``conv_c``), never
    gathers a state leaf, and moves no tensor of a state block's shape
    between the group's shards; each block then holds the gathered path's
    new state."""
    _, pcfg = _cfg(arch, "float32")
    mesh = _mesh(*mesh)
    sess = _session(monkeypatch, arch, "float32", mesh)
    gathered = _session(monkeypatch, arch, "float32", mesh)
    m = mesh.devices.shape[1]
    want, cache = _gathered(monkeypatch, gathered.prefill, _prompts(pcfg))
    tok = torch.argmax(want, -1, keepdim=True).to(torch.int32)
    mine = _clone_cache(cache)
    state_ids = {id(leaf) for leaf in mine["ssm"].values()}
    views, reads, moved = [], [], []
    real_view, real_read, real_note = (ShardedTensor.view_at, ShardedTensor.read,
                                       tp.ModelGroup.note)

    def view_spy(self, pos, index):
        if id(self) in state_ids:
            views.append((pos, index))
        return real_view(self, pos, index)

    def read_spy(self, index, device):
        reads.append(id(self))
        return real_read(self, index, device)

    def note_spy(self, t, src, dst):
        if src != dst:
            moved.append(tuple(t.shape))
        return real_note(self, t, src, dst)

    monkeypatch.setattr(pt_sharding.ShardedTensor, "view_at", view_spy)
    monkeypatch.setattr(pt_sharding.ShardedTensor, "read", read_spy)
    monkeypatch.setattr(tp.ModelGroup, "note", note_spy)
    got, mine = sess.decode(mine, tok, PLEN)
    rows = B // mesh.devices.shape[0]
    hp, w = pcfg.ssm_head_dim, pcfg.ssm_conv_width - 1
    per, gn = pcfg.ssm_heads // m, pcfg.ssm_groups * pcfg.ssm_state
    blocks = {(rows, per, pcfg.ssm_state, hp), (rows, w, per * hp), (rows, w, gn // m)}
    assert moved and not blocks & set(moved)
    assert not state_ids & set(reads)
    # each (row, layer, shard) reads its own four blocks at its own position
    layers = pcfg.n_layers * mesh.devices.shape[0]
    assert len(views) == 4 * layers * m
    for pos, index in views:
        j = pos[1]
        h0, h1 = tp.ssm_head_range(pcfg, j, m)
        c0, c1 = tp.ssm_channel_range(pcfg, j, m)
        assert index[2:] in ((slice(None), slice(h0 * hp, h1 * hp)),
                             (slice(h0, h1), slice(None), slice(None)),
                             (slice(None), slice(c0, c1))), (pos, index)
    monkeypatch.undo()
    want, cache = _gathered(monkeypatch, gathered.decode, cache, tok, PLEN)
    assert _rel(got, want) <= PATH_TOL
    _states_close(mine, cache)


def test_hybrid_prefill_launches_flash_on_each_shard_heads(monkeypatch):
    """zamba2 on 2 x 2: the prefill attends once a (shared block
    application, data shard, model shard), causal over the prompt, on that
    shard's H/m query and KV heads; the mamba layers launch nothing, nor
    does decode."""
    _, pcfg = _cfg("zamba2-7b", "float32")
    calls = []
    real = pt_layers.flash_attention_bshd

    def spy(q, k, v, *a, causal, **kw):
        calls.append((q.shape[0], q.shape[2], k.shape[2], k.shape[1], causal))
        return real(q, k, v, *a, causal=causal, **kw)

    monkeypatch.setattr(pt_layers, "flash_attention_bshd", spy)
    sess = _session(monkeypatch, "zamba2-7b", "float32", _mesh(2, 2))
    logits, cache = sess.prefill(_prompts(pcfg))
    groups, _ = pt_model.hybrid_counts(pcfg)
    h, k = pcfg.n_heads // 2, pcfg.n_kv_heads // 2
    assert calls == [(B // 2, h, k, PLEN, True)] * (groups * 2 * 2)
    calls.clear()
    sess.decode(cache, torch.argmax(logits, -1, keepdim=True), PLEN)
    assert calls == []


def test_tp_walk_orders_the_hybrid_as_the_one_device_loop(monkeypatch):
    """zamba2's smoke config (5 mamba layers, the shared block after every
    2): mamba 0, 1, shared 0, mamba 2, 3, shared 1, mamba 4, each with its
    cache lead; mamba2's: its layers in order."""
    for arch, want in (("zamba2-7b", [("mamba", (0,)), ("mamba", (1,)), ("shared", (0,)),
                                      ("mamba", (2,)), ("mamba", (3,)), ("shared", (1,)),
                                      ("mamba", (4,))]),
                       ("mamba2-780m", [("mamba", (0,)), ("mamba", (1,))])):
        _, pcfg = _cfg(arch, "float32")
        sess = _session(monkeypatch, arch, "float32", _mesh(1, 2))
        with sess.gathered():
            group = tp.model_group(sess._full, sess.mesh, (0, 0))
            walk = pt_model._tp_walk(group, pcfg)
        assert [(kind, lead) for lead, _, kind in walk] == want
        for lead, lps, kind in walk:
            assert len(lps) == 2
            if kind == "shared":
                assert all(lp is b["shared"] for lp, b in zip(lps, group.blocks))


# ------------------------------------------------------------ planted faults


def _neighbour_state(monkeypatch):
    """A planted fault: at decode each shard reads its neighbour's head
    block of the ``ssm`` state (from the neighbour's mesh position); its
    conv states stay its own."""
    real = pt_model._tp_state_views

    def neighbour(group, j, *args):
        return {**real(group, j, *args), "ssm": real(group, (j + 1) % group.m, *args)["ssm"]}

    monkeypatch.setattr(pt_model, "_tp_state_views", neighbour)


@pytest.mark.parametrize("fault", ["neighbour's SSM state", "dropped partial"])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_planted_fault_is_seen(monkeypatch, arch, fault):
    """On (1, 2), the conv passing its input (``_passing_conv``, so that the
    state counts), a decode step's logits, from a copy of the sound
    prefill's cache, land far from the sound run's: a shard that reads its
    neighbour's head block of the SSM state (the heads' A differ; the state
    it writes parts too), or a reduction that loses the last shard's
    partial (which moves the prefill too)."""
    _, pcfg = _cfg(arch, "float32")
    sess = _session(monkeypatch, arch, "float32", _mesh(1, 2),
                    _passing_conv(_params(arch, "float32")[1]))
    prompts = _prompts(pcfg)
    want, cache = sess.prefill(prompts)
    tok = torch.argmax(want, -1, keepdim=True).to(torch.int32)
    want_step, sound = sess.decode(_clone_cache(cache), tok, PLEN)
    if fault == "dropped partial":
        real = tp.reduce_f32
        monkeypatch.setattr(tp, "reduce_f32",
                            lambda parts, dev, dtype: real(parts[:-1], dev, dtype))
    else:
        _neighbour_state(monkeypatch)
    got, _ = sess.prefill(prompts)
    got_step, bad = sess.decode(_clone_cache(cache), tok, PLEN)
    if fault == "dropped partial":
        assert _rel(got, want) > 100 * PATH_TOL
    else:  # the prefill reads no state; the state the step writes parts
        assert _rel(got, want) <= PATH_TOL
        assert _rel(bad["ssm"]["ssm"].full(CPU), sound["ssm"]["ssm"].full(CPU)) > 0.1
    assert _rel(got_step, want_step) > 100 * PATH_TOL
