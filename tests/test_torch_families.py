"""Port vs reference: the LM families' modules beyond dense GQA.

The port's SSM (``ssd_chunked`` against the reference and
``tests/test_ssm.py``'s naive recurrence, the Mamba2 block and its decode
step with the reference's state dtypes), MoE (``moe_forward``: routing,
capacity drops, aux losses), MLA (direct and absorbed forms) and gated
cross attention are held against the JAX package's functions on the same
numpy inputs and parameters.

Tolerances: float32 1e-5 on the SSD and MoE outputs and 1e-6 on the aux
losses (summation order only), 1e-4 on the attention blocks; bfloat16
3e-2. Whole models are in ``tests/test_torch_families_model.py``, serving
in ``tests/test_torch_families_serve.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jx_get_smoke_config  # noqa: E402
from repro.models import layers as jx_layers  # noqa: E402
from repro.models import moe as jx_moe  # noqa: E402
from repro.models import ssm as jx_ssm  # noqa: E402
from repro.models.params import init_params as jx_init_params  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models import model as pt_model  # noqa: E402
from repro_torch.models import moe as pt_moe  # noqa: E402
from repro_torch.models import ssm as pt_ssm  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    ParamDef,
    init_params,
    tree_map,
)

DTYPES = ("float32", "bfloat16")
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S = 2, 16


def _cfg(arch, dtype="float32", **kw):
    return (jx_get_smoke_config(arch).scaled(dtype=dtype, **kw),
            get_smoke_config(arch).scaled(dtype=dtype, **kw))


def _schema_params(jx_schema, seed, dtype="float32"):
    """A module's reference params from its schema, and the port's copy."""
    jp = jx_init_params(jax.random.PRNGKey(seed), jx_schema, JX[dtype])
    return jp, tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        torch.float32 if a.dtype == np.float32 else PT[dtype]), jax.tree.map(np.asarray, jp))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------- SSD


def _naive_ssd(x, dt, a, bm, cm):
    """tests/test_ssm.py's recurrence, in float64."""
    bsz, length, h, p = x.shape
    state = np.zeros((bsz, h, bm.shape[-1], p))
    ys = []
    for t in range(length):
        decay = np.exp(np.float64(dt[:, t]) * np.float64(a)[None, :])
        state = decay[..., None, None] * state + np.einsum(
            "bh,bhn,bhp->bhnp", np.float64(dt[:, t]), np.float64(bm[:, t]), np.float64(x[:, t]))
        ys.append(np.einsum("bhn,bhnp->bhp", np.float64(cm[:, t]), state))
    return np.stack(ys, 1), state


@pytest.mark.parametrize("l,chunk", [(32, 8), (32, 32), (17, 8), (64, 16)])
def test_ssd_chunked_matches_reference_and_naive(l, chunk):
    rng = np.random.default_rng(l * 100 + chunk)
    bsz, h, p, n = 2, 3, 4, 8
    x = rng.normal(size=(bsz, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, size=(bsz, l, h)).astype(np.float32)
    a = -rng.uniform(0.3, 2.0, size=(h,)).astype(np.float32)
    bm = rng.normal(size=(bsz, l, h, n)).astype(np.float32)
    cm = rng.normal(size=(bsz, l, h, n)).astype(np.float32)
    y, hf = pt_ssm.ssd_chunked(*(torch.from_numpy(t) for t in (x, dt, a, bm, cm)), chunk)
    wy, wh = jx_ssm.ssd_chunked(*(jnp.asarray(t) for t in (x, dt, a, bm, cm)), chunk)
    assert y.dtype == hf.dtype == torch.float32 and tuple(y.shape) == wy.shape
    _close(y, wy, 1e-5)
    _close(hf, wh, 1e-5)
    ny, nh = _naive_ssd(x, dt, a, bm, cm)
    np.testing.assert_allclose(y.numpy(), ny, rtol=2e-4, atol=2e-4)  # tests/test_ssm.py's bound
    np.testing.assert_allclose(hf.numpy(), nh, rtol=2e-4, atol=2e-4)
    half = l // 2  # an initial state carries across two calls
    y1, h1 = pt_ssm.ssd_chunked(*(torch.from_numpy(t[:, :half]) for t in (x, dt)), torch.from_numpy(a),
                                *(torch.from_numpy(t[:, :half]) for t in (bm, cm)), chunk)
    y2, h2 = pt_ssm.ssd_chunked(*(torch.from_numpy(t[:, half:]) for t in (x, dt)), torch.from_numpy(a),
                                *(torch.from_numpy(t[:, half:]) for t in (bm, cm)), chunk,
                                init_state=h1)
    _close(torch.cat([y1, y2], 1), y, 1e-4)
    _close(h2, hf, 1e-4)


def test_ssd_gradient_stays_finite_at_full_width_chunk():
    """Chunk 256 with ``a`` at -16: above the diagonal ``exp(cs_i - cs_j)``
    overflows. The port masks before the exp, so its forward equals the
    reference's and its gradient stays finite (the reference's is NaN)."""
    rng = np.random.default_rng(7)
    bsz, l, h, p, n = 1, 256, 2, 4, 8
    x = torch.from_numpy(rng.normal(size=(bsz, l, h, p)).astype(np.float32)).requires_grad_()
    dt = torch.full((bsz, l, h), 0.1).requires_grad_()
    a = torch.tensor([-16.0, -8.0])
    bm, cm = (torch.from_numpy(rng.normal(size=(bsz, l, h, n)).astype(np.float32))
              for _ in range(2))
    y, _ = pt_ssm.ssd_chunked(x, dt, a, bm, cm, 256)
    want, _ = jx_ssm.ssd_chunked(*(jnp.asarray(t.detach().numpy()) for t in (x, dt, a, bm, cm)),
                                 256)
    _close(y.detach(), want, 1e-5)
    y.square().sum().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(dt.grad).all()

    def loss(dt_):
        return jnp.sum(jx_ssm.ssd_chunked(jnp.asarray(x.detach().numpy()), dt_, jnp.asarray(a),
                                          jnp.asarray(bm), jnp.asarray(cm), 256)[0] ** 2)

    assert not np.isfinite(np.asarray(jax.grad(loss)(jnp.asarray(dt.detach().numpy())))).all()


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_block_forward_and_decode_match_reference(arch, dtype):
    """The Mamba2 block over a sequence (final states too), then token by
    token from the reference's bf16 zero state, which a float32 run
    promotes at its first step."""
    jcfg, pcfg = _cfg(arch, dtype)
    jp, pp = _schema_params(jx_ssm.ssm_schema(jcfg), 3, dtype)
    assert pp["a_log"].dtype == pp["dt_bias"].dtype == torch.float32
    rng = np.random.default_rng(4)
    u = rng.normal(size=(B, 13, jcfg.d_model)).astype(np.float32)
    ju, pu = jnp.asarray(u, JX[dtype]), torch.from_numpy(u).to(PT[dtype])
    want, wst = jx_ssm.ssm_forward(jp, ju, jcfg)
    got, gst = pt_ssm.ssm_forward(pp, pu, pcfg)
    tol = LOGIT_TOL[dtype]
    assert got.dtype == PT[dtype]
    _close(got, want, tol)
    for k in ("conv_x", "conv_b", "conv_c", "ssm"):
        assert str(gst[k].dtype).split(".")[1] == str(wst[k].dtype), k
        _close(gst[k], wst[k], tol)
    jstate = jx_ssm.ssm_state_shapes(jcfg, B)
    pstate = pt_ssm.ssm_state_shapes(pcfg, B)
    assert {k: str(t.dtype).split(".")[1] for k, t in pstate.items()} == {
        k: str(t.dtype) for k, t in jstate.items()}
    for t in range(4):
        wy, jstate = jx_ssm.ssm_decode(jp, ju[:, t:t + 1], jcfg, jstate)
        gy, pstate = pt_ssm.ssm_decode(pp, pu[:, t:t + 1], pcfg, pstate)
        _close(gy, wy, tol)
        for k in jstate:
            assert str(pstate[k].dtype).split(".")[1] == str(jstate[k].dtype), (t, k)
            _close(pstate[k], jstate[k], tol)


def test_causal_conv_promotes_a_bf16_state():
    w = torch.ones(4, 3)
    y, st = pt_ssm._causal_conv(torch.ones(2, 1, 3), w, torch.zeros(2, 3, 3, dtype=torch.bfloat16))
    assert y.dtype == st.dtype == torch.float32 and tuple(st.shape) == (2, 3, 3)
    wy, wst = jx_ssm._causal_conv(jnp.ones((2, 1, 3)), jnp.ones((4, 3)),
                                  jnp.zeros((2, 3, 3), jnp.bfloat16))
    assert wst.dtype == jnp.float32
    _close(y, wy, 1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssm_inits_stay_float32_in_their_ranges(dtype):
    cfg = get_smoke_config("zamba2-7b").scaled(dtype=dtype)
    params = pt_model.init_model(0, cfg, "cpu")
    a_log, dt_bias = params["layers"]["ssm"]["a_log"], params["layers"]["ssm"]["dt_bias"]
    assert a_log.dtype == dt_bias.dtype == torch.float32
    assert params["layers"]["ssm"]["in_x"].dtype == PT[dtype]
    assert float(a_log.min()) >= 0.0 and float(a_log.max()) <= np.log(16.0) + 1e-6
    dt = torch.nn.functional.softplus(dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 0.1 * (1 + 1e-5)
    with pytest.raises(ValueError, match="unknown init"):
        init_params(torch.Generator().manual_seed(0), {"x": ParamDef((2,), "uniform")})


# ---------------------------------------------------------------------- MoE


@pytest.mark.parametrize("arch", ["dbrx-132b", "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
@pytest.mark.parametrize("group", [32, 8])
def test_moe_forward_matches_reference(arch, capacity_factor, group):
    """float32: the same routing (expert indices equal), the same drops (the
    dropped fraction equal; a capacity factor of 0.5 drops), ``y`` within
    1e-5 and the aux losses within 1e-6."""
    kw = {} if capacity_factor is None else {"moe_capacity_factor": capacity_factor}
    jcfg, pcfg = _cfg(arch, **kw)
    jp, pp = _schema_params(jx_moe.moe_schema(jcfg), 0)
    x = np.random.default_rng(group).normal(size=(2, 16, jcfg.d_model)).astype(np.float32)
    want_y, want_aux = jx_moe.moe_forward(jp, jnp.asarray(x), jcfg, group_size=group)
    got_y, got_aux = pt_moe.moe_forward(pp, torch.from_numpy(x), pcfg, group_size=group)
    _close(got_y, want_y, 1e-5)
    assert sorted(got_aux) == sorted(want_aux)
    for k, v in got_aux.items():
        assert v.dtype == torch.float32 and v.dim() == 0
        np.testing.assert_allclose(float(v), float(want_aux[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    assert float(got_aux["moe_dropped_frac"]) == float(want_aux["moe_dropped_frac"])
    assert (float(got_aux["moe_dropped_frac"]) > 0) == (capacity_factor is not None)
    xt = jnp.asarray(x).reshape(-1, group, jcfg.d_model)
    probs = jax.nn.softmax((xt @ jp["router"]).astype(jnp.float32), axis=-1)
    _, want_idx = jax.lax.top_k(probs, jcfg.experts_per_token)
    _, _, _, got_idx = pt_moe.route(pp, torch.from_numpy(x), pcfg, group)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    with pytest.raises(ValueError, match="groups of"):
        pt_moe.moe_forward(pp, torch.from_numpy(x), pcfg, group_size=24)  # 32 tokens


def test_moe_routing_properties():
    """tests/test_models.py's check on the port: drop-free at the smoke
    capacity, a balance loss of at least 1 (the Switch normalisation)."""
    cfg = get_smoke_config("dbrx-132b")
    params = init_params(torch.Generator().manual_seed(0), pt_moe.moe_schema(cfg), torch.float32)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32, cfg.d_model)).astype(np.float32))
    y, aux = pt_moe.moe_forward(params, x, cfg, group_size=32)
    assert y.shape == x.shape and float(aux["moe_dropped_frac"]) == 0.0
    assert float(aux["moe_balance_loss"]) >= 0.99


# ---------------------------------------------------------------- MLA, cross


@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_forward_and_decode_match_reference(dtype):
    jcfg, pcfg = _cfg("minicpm3-4b", dtype)
    jp, pp = _schema_params(jx_layers.mla_schema(jcfg), 5, dtype)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, 11, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (B, 11)).copy()
    want, (wc, wk) = jx_layers.mla_forward(jp, jnp.asarray(x, JX[dtype]), jnp.asarray(pos), jcfg)
    got, (gc, gk) = pt_layers.mla_forward(pp, torch.from_numpy(x).to(PT[dtype]),
                                          torch.from_numpy(pos), pcfg)
    tol = LOGIT_TOL[dtype]
    for g, w in ((got, want), (gc, wc), (gk, wk)):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == PT[dtype]
        _close(g, w, tol)
    smax = 9
    ckv = rng.normal(size=(B, smax, jcfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, smax, jcfg.qk_rope_dim)).astype(np.float32)
    xd = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    want = jx_layers.mla_decode(jp, jnp.asarray(xd, JX[dtype]), jnp.int32(5),
                                jnp.asarray(ckv, jnp.bfloat16), jnp.asarray(kr, jnp.bfloat16), jcfg)
    pc, pk = torch.from_numpy(ckv).bfloat16(), torch.from_numpy(kr).bfloat16()
    got = pt_layers.mla_decode(pp, torch.from_numpy(xd).to(PT[dtype]), 5, pc, pk, pcfg)
    assert got[1] is pc and got[2] is pk  # written in place
    _close(got[0], want[0], tol)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, 1e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_reference(dtype):
    """Gated cross attention over image tokens (never causal, key positions
    zeros, ``tanh(gate)``), both impls in the port, XLA in the reference; a
    non-zero gate so the output is not all zeros; then its decode form
    against the prefilled K/V."""
    jcfg, pcfg = _cfg("llama-3.2-vision-90b", dtype)
    jp, pp = _schema_params(jx_layers.attn_schema(jcfg, cross=True), 8, dtype)
    jp = dict(jp, gate=jnp.asarray(0.7, JX[dtype]))
    pp = dict(pp, gate=torch.tensor(0.7, dtype=PT[dtype]))
    assert tuple(pp["gate"].shape) == ()
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B, 7, jcfg.d_model)).astype(np.float32)
    img = rng.normal(size=(B, 13, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (B, 7)).copy()
    want, (wk, wv) = jx_layers.attn_forward(jp, jnp.asarray(x, JX[dtype]), jnp.asarray(pos), jcfg,
                                            kv_x=jnp.asarray(img, JX[dtype]))
    tol = LOGIT_TOL[dtype]
    for impl in ("xla", "flash"):
        got, (gk, gv) = pt_layers.attn_forward(
            pp, torch.from_numpy(x).to(PT[dtype]), torch.from_numpy(pos), pcfg.scaled(attention_impl=impl),
            kv_x=torch.from_numpy(img).to(PT[dtype]))
        for g, w in ((got, want), (gk, wk), (gv, wv)):
            assert tuple(g.shape) == tuple(w.shape) and g.dtype == PT[dtype]
            _close(g, w, tol)
    assert float(np.abs(_np(want)).max()) > 1e-3
    got = pt_layers.cross_decode(pp, torch.from_numpy(x[:, 3:4]).to(PT[dtype]), 3,
                                 gk.bfloat16(), gv.bfloat16(), pcfg)
    _close(got, _np(want)[:, 3:4], 3e-2)
