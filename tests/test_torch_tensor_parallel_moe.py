"""The MoE layer served tensor-parallel, at the production capacity factor.

The smoke configs of moonshot-v1-16b-a3b and dbrx-132b set a drop-free
capacity factor (E / k), which hides the drops; here it is the production
1.25. The layer on a model group (``models/model.py::_tp_moe``: routed
once on the home, each shard its ``E / m`` experts from its own one-hots,
the float32 shares reduced on the home) is held to the reference's
``moe_forward`` on the same weights and tokens, at every group size the
serving paths route by: its output within 1e-5, its dropped fraction
equal. A shard that runs its neighbour's expert range with its own
weights must be seen. A session on 2 x 2 whose prompts are two whole
routing groups (2 x 1,024 tokens: the prefill splits them over 'data')
gives the reference's greedy tokens, logits within 1e-4, with one flash
launch a (layer, data shard, model shard). ``layers.bmm_f32`` (the block's
float32 combine) and its count on meta tensors are held too.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jx_get_smoke_config  # noqa: E402
from repro.models import model as jx_model  # noqa: E402
from repro.models import moe as jx_moe  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.launch import steps as pt_steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models import model as pt_model  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ("moonshot-v1-16b-a3b", "dbrx-132b")
MESHES = ((1, 2), (2, 2), (1, 4))
CF = 1.25  # the production capacity factor: tokens are dropped
Y_TOL, LOGIT_TOL = 1e-5, 1e-4
B, PLEN, GEN = 2, 1024, 4  # two routing groups of 1,024: one a data shard


def _cfg(arch):
    """(reference config, port config) at the production capacity factor,
    float32, pinned to the "tp" profile (the port attends by flash)."""
    kw = dict(dtype="float32", parallelism="tp", moe_capacity_factor=CF)
    return (jx_get_smoke_config(arch).scaled(**kw),
            get_smoke_config(arch).scaled(attention_impl="flash", **kw))


def _mesh(data, model):
    return make_host_mesh(data, model, devices=[CPU] * (data * model))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(reference params, port params): the same numbers in both packages."""
    jcfg, pcfg = _cfg(arch)
    jp = jx_model.init_model(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, "cpu")


def _group(arch, mesh_shape):
    """The model group of mesh position (0, 0) over the placed params' model
    blocks, and layer 0's blocks [shard]."""
    _, pcfg = _cfg(arch)
    mesh = _mesh(*mesh_shape)
    blocks = pt_steps.gather_params(pt_steps.place_params(pcfg, mesh, _params(arch)[1]), mesh,
                                    pcfg)
    assert isinstance(blocks, tp.ModelBlocks)
    group = tp.model_group(blocks, mesh, (0, 0))
    return group, pt_model._tp_layers(group, pcfg)[0]


def _tokens(cfg, rows, seq, seed):
    """Normal tokens around a shared direction (as a residual stream's
    mean), which skews the routing: at capacity 1.25 both configs drop."""
    rng = np.random.default_rng(seed)
    shared = 2.0 * rng.normal(size=cfg.d_model)
    return (rng.normal(size=(rows, seq, cfg.d_model)) + shared).astype(np.float32)


def _reference_layer(arch, h, group_size):
    jcfg, _ = _cfg(arch)
    jp = jax.tree.map(lambda t: t[0], _params(arch)[0]["layers"]["moe"])
    return jx_moe.moe_forward(jp, jnp.asarray(h), jcfg, group_size=group_size)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("rows,seq,group_size", [(2, 64, 64), (2, 64, 32), (4, 1, 1)],
                         ids=["prefill", "groups", "decode"])
def test_tp_moe_layer_equals_reference_moe_forward(arch, mesh, rows, seq, group_size):
    """The layer's output within 1e-5 of the reference's, its dropped
    fraction equal (and past 0 where a group holds more than one token;
    decode's groups of one token drop nothing), every shard holding its
    ``E / m`` experts."""
    _, pcfg = _cfg(arch)
    group, lps = _group(arch, mesh)
    m = mesh[1]
    assert [lp["moe"]["w_gate"].shape[0] for lp in lps] == [pcfg.n_experts // m] * m
    h = _tokens(pcfg, rows, seq, seed=rows * seq + m)
    got, aux = pt_model._tp_moe(group, lps, torch.from_numpy(h), pcfg, group_size)
    want, want_aux = _reference_layer(arch, h, group_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=Y_TOL, atol=Y_TOL)
    dropped = float(aux["moe_dropped_frac"])
    assert dropped == float(want_aux["moe_dropped_frac"])
    assert (dropped > 0) == (group_size > 1)
    for k in ("moe_balance_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]), rtol=1e-6, atol=1e-6)
    # The shards' routing tensors, not the [ng, g, E, C] one-hots, were sent.
    ng, g = rows * seq // group_size, group_size
    k = pcfg.experts_per_token
    routing = ng * g * k * (4 + 8 + 8)  # float32 gates, int64 experts and slots
    tokens = rows * seq * pcfg.d_model * 4
    assert group.moved[1:] == [tokens + routing] * (m - 1)
    assert group.moved[0] == (m - 1) * tokens  # the float32 shares reduced on the home


@pytest.mark.parametrize("arch", ARCHS)
def test_a_misplaced_expert_block_is_seen(monkeypatch, arch):
    """A shard that builds its neighbour's one-hots (its expert range) and
    runs them on its own weights lands far from the reference."""
    _, pcfg = _cfg(arch)
    group, lps = _group(arch, (1, 2))
    h = _tokens(pcfg, 2, 64, seed=5)
    want, _ = _reference_layer(arch, h, 64)
    real = tp.expert_range
    monkeypatch.setattr(tp, "expert_range", lambda cfg, j, m: real(cfg, (j + 1) % m, m))
    got, aux = pt_model._tp_moe(group, lps, torch.from_numpy(h), pcfg, 64)
    assert _rel(got.numpy(), want) > 100 * Y_TOL


@functools.lru_cache(maxsize=None)
def _reference_greedy(arch):
    """The reference's greedy loop outside a mesh: (tokens [B, GEN], logits
    [GEN, B, V])."""
    jcfg, pcfg = _cfg(arch)
    params = _params(arch)[0]
    prompts = np.random.default_rng(1).integers(0, pcfg.vocab, (B, PLEN), dtype=np.int32)
    prefill = jax.jit(jx_model.forward_prefill, static_argnums=3)
    decode = jax.jit(jx_model.decode_step, static_argnums=4)
    cache = jx_model.init_cache(jcfg, B, PLEN + GEN)
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompts)}, cache, jcfg)
    kept = [np.asarray(logits)]
    out = [jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]]
    for i in range(GEN - 1):
        logits, cache = decode(params, cache, out[-1], jnp.int32(PLEN + i), jcfg)
        kept.append(np.asarray(logits))
        out.append(jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None])
    return prompts, np.concatenate([np.asarray(t) for t in out], axis=1), np.stack(kept)


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_routing_groups_split_over_data(monkeypatch, arch):
    """2 x 1,024 prompt tokens on 2 x 2, capacity factor 1.25: each data
    shard's prefill routes its own group over its model group (flash once
    a layer, data shard and model shard, on the shard's heads), and the
    session gives the reference's greedy tokens, logits within 1e-4."""
    _, pcfg = _cfg(arch)
    calls = []
    real = pt_layers.flash_attention_bshd

    def spy(q, k, v, *a, **kw):
        calls.append((q.shape[0], q.shape[2], k.shape[2]))
        return real(q, k, v, *a, **kw)

    monkeypatch.setattr(pt_layers, "flash_attention_bshd", spy)
    monkeypatch.setattr(pt_serve, "get_smoke_config", lambda a: pcfg)
    sess = pt_serve.ServeSession(arch, smoke=True, mesh=_mesh(2, 2), device="cpu",
                                 dtype="float32", batch=B, max_seq=PLEN + GEN,
                                 params=_params(arch)[1])
    assert tp.serves_tensor_parallel(sess.cfg, sess.mesh)
    prompts, want_tokens, want_logits = _reference_greedy(arch)
    tokens, stats = sess.generate(prompts, GEN, keep_logits=True)
    h, kv = pcfg.n_heads, pcfg.n_kv_heads
    assert calls == [(B // 2, h // 2, kv // 2)] * (pcfg.n_layers * 2 * 2)
    np.testing.assert_array_equal(tokens[:, PLEN:], want_tokens)
    np.testing.assert_allclose(np.asarray(stats["logits"], np.float32), want_logits,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_bmm_f32_sums_in_float32_and_keeps_autograd():
    """An expert block's combine: bf16 operands give the float32 product of
    their widened values (nothing rounded to bf16 before the reduce); under
    autograd (a training step) the product is taken in bf16, as before,
    and differentiates."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, 40, generator=gen).to(torch.bfloat16)
    w = torch.randn(3, 40, 16, generator=gen).to(torch.bfloat16)
    got = pt_layers.bmm_f32(x, w)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.bmm(x.float(), w.float()))
    xg = x.clone().requires_grad_()
    y = pt_layers.bmm_f32(xg, w)
    assert torch.equal(y, torch.bmm(x, w).float())
    y.sum().backward()
    assert xg.grad.shape == x.shape


def test_out_dtype_products_count_as_products():
    """The cost counter takes ``bmm``'s and ``mm``'s ``out_dtype`` overloads
    (the tensor-parallel partials on meta) as their products."""
    from repro_torch.analysis.hlo_cost import step_cost

    meta = torch.device("meta")
    a = torch.empty(3, 4, 5, dtype=torch.bfloat16, device=meta)
    b = torch.empty(3, 5, 6, dtype=torch.bfloat16, device=meta)
    with torch.inference_mode():
        assert step_cost(lambda: pt_layers.bmm_f32(a, b)).matmul_flops == 2 * 3 * 4 * 5 * 6
        assert step_cost(lambda: pt_layers.matmul_f32(a[0], b[0])).matmul_flops == 2 * 4 * 5 * 6
