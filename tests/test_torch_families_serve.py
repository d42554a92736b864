"""Port vs reference: serving the LM families (prefill, decode, ServeSession).

For every decoder arch beyond dense GQA (MLA, the two MoE archs, the SSM,
the zamba2 hybrid, the VLM), the port's ``ServeSession`` (``device="cpu"``,
so the flash path runs the kernel's plain version) is held against the
reference's greedy loop on the same parameters — the reference's
``init_model`` tree, converted bit for bit by ``params_from_numpy`` — and
the same numpy prompts (and image embeddings): ``init_cache`` ->
``forward_prefill`` -> ``decode_step`` x n -> argmax, run outside any mesh,
as ``tests/test_torch_lm.py`` runs it (the reference's ``ServeSession`` fails
on this JAX). The prefill caches are held leaf by leaf, their dtypes
included (SSM conv states follow the activations' dtype, as JAX promotes
them); decode equals teacher forcing on the port within the reference's
2e-2 (``tests/test_models.py``); an MoE config that drops tokens drops
them as the reference does; the flash path takes hubert's head dim 80 and
zamba2's 112 as the reference's does, and refuses MLA's widths (96, values
64), on the CPU as on the card.

Tolerances: float32 equal tokens and 1e-4 on logits; bfloat16 3e-2 on
logits, teacher-forced on the port's tokens; caches 3e-2 (bf16 leaves);
flash attention at hd 80 and 112 against the reference's XLA attention,
relative norm 1e-5 in float32 and 3e-2 in bfloat16.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jx_get_smoke_config  # noqa: E402
from repro.models import layers as jx_layers  # noqa: E402
from repro.models import model as jx_model  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models import model as pt_model  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_leaves  # noqa: E402

DECODERS = ("minicpm3-4b", "dbrx-132b", "moonshot-v1-16b-a3b", "mamba2-780m", "zamba2-7b",
            "llama-3.2-vision-90b")
FLASH_OK = ("dbrx-132b", "moonshot-v1-16b-a3b", "zamba2-7b", "llama-3.2-vision-90b")
DTYPES = ("float32", "bfloat16")
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
B, PLEN, GEN = 2, 16, 6


def _cfg(arch, dtype, **kw):
    return (jx_get_smoke_config(arch).scaled(dtype=dtype, **kw),
            get_smoke_config(arch).scaled(dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _params(arch, dtype, **kw):
    """(reference params, port params): the same numbers in both packages."""
    jcfg, pcfg = _cfg(arch, dtype, **kw)
    jp = jx_model.init_model(jax.random.PRNGKey(0), jcfg)
    if "cross_layers" in jp:  # init mutes the image tokens (tanh(0)); let them count
        jp["cross_layers"]["xattn"]["gate"] = jnp.full_like(jp["cross_layers"]["xattn"]["gate"], 0.5)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, "cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _prompts(cfg, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, PLEN), dtype=np.int32)


def _image(cfg, seed=2):
    if cfg.family != "vlm":
        return None
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)


def _jx_batch(cfg, tokens):
    batch = {"tokens": jnp.asarray(tokens)}
    if cfg.family == "vlm":
        batch["image_embeds"] = jnp.asarray(_image(cfg))
    return batch


def _pt_batch(cfg, tokens):
    batch = {"tokens": torch.from_numpy(np.asarray(tokens))}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(_image(cfg))
    return batch


@functools.lru_cache(maxsize=None)
def _reference_greedy(arch, dtype, force=None, **kw):
    """The reference's serving loop outside a mesh: (tokens [B, GEN], logits
    [GEN, B, V]); ``force`` (bytes of a [B, GEN] int32 array) feeds those
    tokens instead of the argmax (teacher forcing)."""
    jcfg, _ = _cfg(arch, dtype, **kw)
    params, _ = _params(arch, dtype, **kw)
    forced = None if force is None else np.frombuffer(force, np.int32).reshape(B, GEN)
    cache = jx_model.init_cache(jcfg, B, PLEN + GEN + 1)
    logits, cache = jx_model.forward_prefill(params, _jx_batch(jcfg, _prompts(jcfg)), cache, jcfg)
    kept = [np.asarray(logits)]
    out = [jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]]
    for i in range(GEN - 1):
        tok = out[-1] if forced is None else jnp.asarray(forced[:, i : i + 1])
        logits, cache = jx_model.decode_step(params, cache, tok, jnp.int32(PLEN + i), jcfg)
        kept.append(np.asarray(logits))
        out.append(jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None])
    return np.concatenate([np.asarray(t) for t in out], axis=1), np.stack(kept)


def _leaves(cache):
    """A cache's leaves by name, the SSM states flattened in."""
    out = {k: v for k, v in cache.items() if k != "ssm"}
    out.update({f"ssm/{k}": v for k, v in cache.get("ssm", {}).items()})
    return out


def _dtype_name(t):
    return str(t.dtype).split(".")[-1]


# ------------------------------------------------------------ serving slice


@pytest.mark.parametrize("arch,impl", [(a, "xla") for a in DECODERS]
                         + [(a, "flash") for a in FLASH_OK])
@pytest.mark.parametrize("dtype", DTYPES)
def test_serve_session_matches_reference_greedy_loop(arch, impl, dtype):
    _, pcfg = _cfg(arch, dtype)
    _, pp = _params(arch, dtype)
    sess = pt_serve.ServeSession(arch, smoke=True, batch=B, max_seq=PLEN + GEN + 1, device="cpu",
                                 attention_impl=impl, dtype=dtype, params=pp)
    tokens, stats = sess.generate(_prompts(pcfg), GEN, image_embeds=_image(pcfg), keep_logits=True)
    assert tokens.shape == (B, PLEN + GEN) and np.array_equal(tokens[:, :PLEN], _prompts(pcfg))
    got = tokens[:, PLEN:]
    if dtype == "float32":
        want_tokens, want_logits = _reference_greedy(arch, dtype)
        np.testing.assert_array_equal(got, want_tokens)
    else:
        _, want_logits = _reference_greedy(arch, dtype, force=got.astype(np.int32).tobytes())
    _close(stats["logits"], want_logits, LOGIT_TOL[dtype])


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_and_decode_caches_match_reference(arch):
    """float32: ``forward_prefill``'s last logits and every cache leaf, with
    its dtype (attention caches bf16 and zero past the prompt; SSM conv
    states float32 after the prefill, the SSM state float32), then one
    decode step's logits and cache."""
    jcfg, pcfg = _cfg(arch, "float32")
    jp, pp = _params(arch, "float32")
    tokens = _prompts(jcfg)
    jcache = jx_model.init_cache(jcfg, B, PLEN + 4)
    pcache = pt_model.init_cache(pcfg, B, PLEN + 4, "cpu")
    assert {k: _dtype_name(v) for k, v in _leaves(pcache).items()} == {
        k: _dtype_name(v) for k, v in _leaves(jcache).items()}
    for t in _leaves(pcache).values():
        t.fill_(7)  # stale contents must be replaced or cleared
    want, jcache = jx_model.forward_prefill(jp, _jx_batch(jcfg, tokens), jcache, jcfg)
    got, pcache = pt_model.forward_prefill(pp, _pt_batch(pcfg, tokens), pcache, pcfg)
    _close(got, want, 1e-4)
    for step in ("prefill", "decode"):
        wl, gl = _leaves(jcache), _leaves(pcache)
        assert sorted(gl) == sorted(wl)
        for name, g in gl.items():
            assert _dtype_name(g) == _dtype_name(wl[name]), (step, name)
            _close(g, wl[name], 3e-2 if g.dtype == torch.bfloat16 else 1e-4)
        if step == "prefill":
            for name, t in gl.items():
                if t.dtype == torch.bfloat16 and name not in ("xk", "xv"):
                    seq = t.dim() - (2 if name in ("ckv", "krope") else 3)
                    assert torch.all(t.narrow(seq, PLEN, t.shape[seq] - PLEN) == 0), name
            tok = np.asarray(jnp.argmax(want, -1))[:, None].astype(np.int32)
            want, jcache = jx_model.decode_step(jp, jcache, jnp.asarray(tok), jnp.int32(PLEN), jcfg)
            got, pcache = pt_model.decode_step(pp, pcache, torch.from_numpy(tok), PLEN, pcfg)
            _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ["dbrx-132b", "moonshot-v1-16b-a3b"])
def test_moe_serving_drops_as_the_reference(arch):
    """A capacity factor of 0.5 drops tokens at prefill (the training
    grouping); decode routes one token a group and drops none. The port's
    greedy loop equals the reference's, drops and all, and its dropped
    fractions are the reference's."""
    kw = {"moe_capacity_factor": 0.5}
    jcfg, pcfg = _cfg(arch, "float32", **kw)
    jp, pp = _params(arch, "float32", **kw)
    drops = []
    real = pt_model.MOE.moe_forward

    def spy(*args, **kwargs):
        y, aux = real(*args, **kwargs)
        drops.append((args[1].shape[1], float(aux["moe_dropped_frac"])))
        return y, aux

    cache = pt_model.init_cache(pcfg, B, PLEN + GEN + 1, "cpu")
    pt_model.MOE.moe_forward = spy
    try:
        logits, cache = pt_model.forward_prefill(pp, _pt_batch(pcfg, _prompts(pcfg)), cache, pcfg)
        kept, out = [logits], [logits.argmax(-1, keepdim=True)]
        for i in range(GEN - 1):
            logits, cache = pt_model.decode_step(pp, cache, out[-1], PLEN + i, pcfg)
            kept.append(logits)
            out.append(logits.argmax(-1, keepdim=True))
    finally:
        pt_model.MOE.moe_forward = real
    want_tokens, want_logits = _reference_greedy(arch, "float32", **kw)
    np.testing.assert_array_equal(torch.cat(out, 1).numpy(), want_tokens)
    _close(torch.stack(kept), want_logits, 1e-4)
    prefill = [d for s, d in drops if s == PLEN]
    assert len(prefill) == jcfg.n_layers and max(prefill) > 0
    assert all(d == 0 for s, d in drops if s == 1)
    x = jnp.asarray(np.random.default_rng(3).normal(size=(B, PLEN, jcfg.d_model)), jnp.float32)
    lp = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    _, want_aux = jx_model.MOE.moe_forward(lp, x, jcfg, group_size=B * PLEN)
    _, got_aux = real({k: v[0] for k, v in pp["layers"]["moe"].items()},
                      torch.from_numpy(np.array(x)), pcfg, group_size=B * PLEN)
    assert float(got_aux["moe_dropped_frac"]) == float(want_aux["moe_dropped_frac"]) > 0


@pytest.mark.parametrize("arch,impl", [(a, "xla") for a in DECODERS]
                         + [(a, "flash") for a in FLASH_OK])
def test_port_decode_matches_teacher_forcing(arch, impl):
    """The reference's own check, on the port: prefill + decode steps give
    the full forward's logits (tests/test_models.py's bound, 2e-2)."""
    cfg = get_smoke_config(arch).scaled(attention_impl=impl)
    params = pt_model.init_model(1, cfg, "cpu")
    s, sp = 12, 8
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, s)))
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(
            rng.normal(size=(B, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32))
    full, _ = pt_model.forward_train(params, batch, cfg)
    cache = pt_model.init_cache(cfg, B, s, "cpu")
    last, cache = pt_model.forward_prefill(params, dict(batch, tokens=tokens[:, :sp]), cache, cfg)
    errs = [float((last - full[:, sp - 1]).abs().max())]
    for t in range(sp, s):
        logits, cache = pt_model.decode_step(params, cache, tokens[:, t : t + 1], t, cfg)
        errs.append(float((logits - full[:, t]).abs().max()))
    assert max(errs) < 2e-2, errs


def test_audio_prefill_is_a_full_forward_and_has_no_decode():
    jcfg, pcfg = _cfg("hubert-xlarge", "float32")
    jp, pp = _params("hubert-xlarge", "float32")
    frames = np.random.default_rng(5).normal(size=(B, 10, jcfg.d_frontend)).astype(np.float32)
    want, wcache = jx_model.forward_prefill(jp, {"frames": jnp.asarray(frames)}, {}, jcfg)
    got, cache = pt_model.forward_prefill(pp, {"frames": torch.from_numpy(frames)},
                                          pt_model.init_cache(pcfg, B, 10, "cpu"), pcfg)
    assert cache == wcache == {}
    _close(got, want, 1e-4)
    with pytest.raises(ValueError, match="encoder-only"):
        pt_model.decode_step(pp, {}, torch.zeros(B, 1, dtype=torch.int64), 0, pcfg)
    with pytest.raises(ValueError, match="encoder-only"):
        pt_serve.ServeSession("hubert-xlarge", smoke=True, device="cpu")


# ------------------------------------------------ flash: no quiet fallback


FLASH_REL_TOL = {"float32": 1e-5, "bfloat16": 3e-2}  # relative norm, flash vs xla


@pytest.mark.parametrize("hd", [80, 112])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_takes_head_dims_80_and_112(hd, dtype):
    """hubert's 80 and zamba2's 112 (GQA and MHA heads, causal and not):
    the port's ``attention_op(impl="flash")`` against the reference's
    ``attention_op(impl="xla")`` on the same numbers."""
    rng = np.random.default_rng(hd)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    for (h, kh), causal in (((4, 2), True), ((2, 2), False)):
        q, k, v = (np.asarray(jnp.asarray(rng.normal(size=(2, s, n, hd)), jdt), np.float32)
                   for s, n in ((9, h), (13, kh), (13, kh)))
        qp = np.broadcast_to(np.arange(4, 13, dtype=np.int32), (2, 9)).copy()
        kp = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13)).copy()
        want = jx_layers.attention_op(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(qp),
                                      jnp.asarray(kp), causal, impl="xla")
        got = pt_layers.attention_op(
            *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
            torch.from_numpy(qp), torch.from_numpy(kp), causal, impl="flash")
        assert tuple(got.shape) == (2, 9, h, hd) and got.dtype == getattr(torch, dtype)
        want = np.asarray(want, np.float32)
        rel = np.linalg.norm(_np(got) - want) / np.linalg.norm(want)
        assert rel <= FLASH_REL_TOL[dtype], (h, kh, causal, rel)


@pytest.mark.parametrize("hd,vd", [(96, 96), (96, 64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_refuses_head_dims_the_kernel_lacks(hd, vd, dtype):
    """MLA's 96 (values 64), and 96 alone: ``impl="flash"`` raises
    ``ValueError`` naming the widths, on the CPU as on the card, where the
    plain path would have taken them."""
    rng = np.random.default_rng(hd + vd)
    q = torch.from_numpy(rng.normal(size=(1, 5, 2, hd)).astype(np.float32)).to(getattr(torch, dtype))
    k = torch.from_numpy(rng.normal(size=(1, 5, 2, hd)).astype(np.float32)).to(q.dtype)
    v = torch.from_numpy(rng.normal(size=(1, 5, 2, vd)).astype(np.float32)).to(q.dtype)
    pos = torch.arange(5, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match=rf"head dim.*{hd}|{vd}"):
        pt_layers.attention_op(q, k, v, pos, pos, True, impl="flash")
    out = pt_layers.attention_op(q, k, v, pos, pos, True, impl="xla")
    assert tuple(out.shape) == (1, 5, 2, vd)


@pytest.mark.parametrize("arch,head_dim", [("hubert-xlarge", 80), ("zamba2-7b", 112)])
def test_flash_configs_at_80_and_112_match_reference(arch, head_dim):
    """hubert and zamba2 at their real head width (smoke depth and model
    width otherwise), float32: the port's ``forward_train`` under "flash"
    against the reference's under "xla" on the same weights."""
    jcfg, pcfg = _cfg(arch, "float32", head_dim=head_dim)
    jp, pp = _params(arch, "float32", head_dim=head_dim)
    rng = np.random.default_rng(0)
    if pcfg.family == "audio":
        batch = {"frames": rng.normal(size=(B, 8, pcfg.d_frontend)).astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, pcfg.vocab, (B, 8)).astype(np.int32)}
    want, _ = jx_model.forward_train(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with torch.no_grad():
        got, _ = pt_model.forward_train(pp, {k: torch.from_numpy(v) for k, v in batch.items()},
                                        pcfg.scaled(attention_impl="flash"))
    assert got.shape == want.shape and pcfg.resolved_head_dim == head_dim
    _close(got, want, LOGIT_TOL["float32"])


@pytest.mark.parametrize("arch", ["minicpm3-4b"])
def test_flash_configs_with_unsupported_heads_raise(arch):
    cfg = get_smoke_config(arch).scaled(attention_impl="flash", dtype="float32")
    params = pt_model.init_model(0, cfg, "cpu")
    rng = np.random.default_rng(0)
    if cfg.family == "audio":
        batch = {"frames": torch.from_numpy(rng.normal(size=(B, 8, cfg.d_frontend)).astype(np.float32))}
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, 8)))}
    with torch.no_grad(), pytest.raises(ValueError, match="head dim"):
        pt_model.forward_train(params, batch, cfg)
    xla, _ = pt_model.forward_train(params, batch, cfg.scaled(attention_impl="xla"))
    assert torch.isfinite(xla).all()


def test_serve_session_image_embeds_guards():
    vlm = pt_serve.ServeSession("llama-3.2-vision-90b", smoke=True, batch=B, device="cpu")
    cfg = vlm.cfg
    with pytest.raises(ValueError, match="image_embeds"):
        vlm.generate(_prompts(cfg), 2)
    tokens, _ = vlm.generate(_prompts(cfg), 2, image_embeds=_image(cfg))
    assert tokens.shape == (B, PLEN + 2)
    ssm = pt_serve.ServeSession("mamba2-780m", smoke=True, batch=B, device="cpu")
    with pytest.raises(ValueError, match="image_embeds"):
        ssm.generate(_prompts(cfg), 2, image_embeds=_image(cfg))


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "zamba2-7b", "minicpm3-4b"])
def test_serve_cli_runs_families_on_cpu(arch, capsys):
    assert pt_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "8", "--gen", "4"]) == 0
    assert "generated shape=(2, 12)" in capsys.readouterr().out


@pytest.mark.parametrize("arch,n_layers", [("llama-3.2-vision-90b", 2), ("zamba2-7b", 3),
                                           ("moonshot-v1-16b-a3b", 1)])
def test_serve_session_cuts_depth(arch, n_layers):
    """``n_layers`` replaces the config's depth (how a full-width config is
    served on one card): the session's own parameters follow the cut
    config, and it serves."""
    sess = pt_serve.ServeSession(arch, smoke=True, batch=B, max_seq=PLEN + 3, device="cpu",
                                 n_layers=n_layers)
    cfg = sess.cfg
    assert cfg.n_layers == n_layers and cfg.d_model == get_smoke_config(arch).d_model
    assert sum(t.numel() for t in tree_leaves(sess.params)) == (
        pt_model.count_params_analytical(cfg))
    tokens, _ = sess.generate(_prompts(cfg), 3, image_embeds=_image(cfg))
    assert tokens.shape == (B, PLEN + 3) and tokens.max() < cfg.vocab
