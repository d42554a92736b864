"""Port vs reference: the dense LM serving slice.

The port's layers, model and ``ServeSession`` (``device="cpu"``, so the
flash path runs the kernel's plain version) are held against the JAX
package on the same parameters — the reference's ``init_model`` tree,
converted bit for bit by ``params_from_numpy`` — and the same numpy
inputs, for the smoke configs of the three dense GQA archs (smollm-135m,
qwen1.5-110b with its QKV bias, deepseek-67b).

The reference's ``ServeSession`` builds an Explicit-axes mesh that its
sharding constraints reject on this JAX, so the whole slice is held against
the reference's own greedy loop, run outside any mesh scope (where its
constraints are the identity): ``init_cache`` -> ``forward_prefill`` ->
``decode_step`` x n -> argmax, as ``ServeSession.generate`` runs it.
Tolerances: float32 equal tokens and 1e-4 on logits (summation order
only); bfloat16 3e-2 on logits, teacher-forced on the port's tokens, as
the reference holds its flash path to its XLA path (rounding in bf16 at
other places in the two frameworks).
"""
import functools
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jx_get_config  # noqa: E402
from repro.configs import get_smoke_config as jx_get_smoke_config  # noqa: E402
from repro.models import layers as jx_layers  # noqa: E402
from repro.models import model as jx_model  # noqa: E402

from repro_torch.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models import model as pt_model  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    init_params,
    params_from_numpy,
    tree_bytes,
    tree_leaves,
)

SRC = Path(__file__).resolve().parents[1] / "src"
DENSE = ("smollm-135m", "qwen1.5-110b", "deepseek-67b")
DTYPES = ("float32", "bfloat16")
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, PLEN, GEN = 2, 16, 6


def _cfg(arch, dtype):
    return jx_get_smoke_config(arch).scaled(dtype=dtype), get_smoke_config(arch).scaled(dtype=dtype)


@functools.lru_cache(maxsize=None)
def _params(arch, dtype, seed=0):
    """(reference params, port params): the same numbers in both packages."""
    jcfg, pcfg = _cfg(arch, dtype)
    jp = jx_model.init_model(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, "cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _prompts(cfg, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, PLEN), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _reference_greedy(arch, dtype, force=None):
    """The reference's serving loop outside a mesh: (tokens [B, GEN], logits
    [GEN, B, V]); ``force`` (bytes of a [B, GEN] int32 array) feeds those
    tokens instead of the argmax (teacher forcing)."""
    jcfg, _ = _cfg(arch, dtype)
    params, _ = _params(arch, dtype)
    forced = None if force is None else np.frombuffer(force, np.int32).reshape(B, GEN)
    cache = jx_model.init_cache(jcfg, B, PLEN + GEN + 1)
    logits, cache = jx_model.forward_prefill(params, {"tokens": jnp.asarray(_prompts(jcfg))},
                                             cache, jcfg)
    kept = [np.asarray(logits)]
    out = [jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]]
    for i in range(GEN - 1):
        tok = out[-1] if forced is None else jnp.asarray(forced[:, i : i + 1])
        logits, cache = jx_model.decode_step(params, cache, tok, jnp.int32(PLEN + i), jcfg)
        kept.append(np.asarray(logits))
        out.append(jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None])
    return np.concatenate([np.asarray(t) for t in out], axis=1), np.stack(kept)


# ----------------------------------------------------------------- primitives


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_and_rope_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 12, dtype=np.int32), (2, 9)).copy()
    jx, px = jnp.asarray(x, JX[dtype]), torch.from_numpy(x).to(PT[dtype])
    got = pt_layers.rmsnorm(px, torch.from_numpy(scale).to(PT[dtype]), 1e-5)
    want = jx_layers.rmsnorm(jx, jnp.asarray(scale, JX[dtype]), 1e-5)
    assert got.dtype == PT[dtype]
    _close(got, want, 1e-6 if dtype == "float32" else 1e-2)
    for theta in (10000.0, 1000000.0):
        got = pt_layers.rope(px, torch.from_numpy(pos), theta)
        want = jx_layers.rope(jx, jnp.asarray(pos), theta)
        assert got.dtype == PT[dtype]
        _close(got, want, 1e-5 if dtype == "float32" else 1e-2)


def test_cache_write_matches_reference():
    rng = np.random.default_rng(0)
    cache = rng.normal(size=(2, 7, 3, 4)).astype(np.float32)
    new = rng.normal(size=(2, 1, 3, 4)).astype(np.float32)
    want = jx_layers.cache_write(jnp.asarray(cache, jnp.bfloat16), jnp.asarray(new), jnp.int32(5))
    got = pt_layers.cache_write(torch.from_numpy(cache).bfloat16(), torch.from_numpy(new), 5)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_and_mlp_forward_match_reference(arch, impl, dtype):
    """One layer's attention (both impls in the port, XLA in the reference)
    and SwiGLU MLP on the converted layer-0 params."""
    jcfg, pcfg = _cfg(arch, dtype)
    pcfg = pcfg.scaled(attention_impl=impl)
    jp, pp = _params(arch, dtype)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    pl = {k: {n: t[0] for n, t in v.items()} if isinstance(v, dict) else v[0]
          for k, v in pp["layers"].items()}
    x = np.random.default_rng(2).normal(size=(B, 11, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (B, 11)).copy()
    jx, px = jnp.asarray(x, JX[dtype]), torch.from_numpy(x).to(PT[dtype])
    want, (wk, wv) = jx_layers.attn_forward(jl["attn"], jx, jnp.asarray(pos), jcfg)
    got, (gk, gv) = pt_layers.attn_forward(pl["attn"], px, torch.from_numpy(pos), pcfg)
    tol = LOGIT_TOL[dtype]
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == PT[dtype]
        _close(g, w, tol)
    _close(pt_layers.mlp_forward(pl["mlp"], px), jx_layers.mlp_forward(jl["mlp"], jx), tol)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_decode_matches_reference(arch, dtype):
    jcfg, pcfg = _cfg(arch, dtype)
    jp, pp = _params(arch, dtype)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    pl = {n: t[0] for n, t in pp["layers"]["attn"].items()}
    rng = np.random.default_rng(3)
    smax, kh, hd = 9, jcfg.n_kv_heads, jcfg.resolved_head_dim
    kc = rng.normal(size=(B, smax, kh, hd)).astype(np.float32)
    vc = rng.normal(size=(B, smax, kh, hd)).astype(np.float32)
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    want = jx_layers.attn_decode(jl, jnp.asarray(x, JX[dtype]), jnp.int32(6),
                                 jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16), jcfg)
    pk, pv = torch.from_numpy(kc).bfloat16(), torch.from_numpy(vc).bfloat16()
    got = pt_layers.attn_decode(pl, torch.from_numpy(x).to(PT[dtype]), 6, pk, pv, pcfg)
    assert got[1] is pk and got[2] is pv  # written in place
    _close(got[0], want[0], LOGIT_TOL[dtype])
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, 1e-2)


# ------------------------------------------------------------------- params


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_numpy_round_trips_bit_for_bit(arch):
    jp, pp = _params(arch, "bfloat16")
    jl = jax.tree.leaves(jp)  # sorted-key order, as tree_leaves
    pleaves = tree_leaves(pp)
    assert len(jl) == len(pleaves)
    for a, t in zip(jl, pleaves):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        back = t.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(back, np.asarray(a).view(np.uint16))
    assert tree_bytes(pp) == sum(a.nbytes for a in jl)
    _, pcfg = _cfg(arch, "bfloat16")
    bad = jax.tree.map(np.asarray, jp)
    bad["final_norm"] = bad["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(bad, pcfg, "cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_count_params_analytical_matches_reference_full_configs(arch):
    """Counted from the schema, never materialised (qwen1.5-110b has 111 B)."""
    want = jx_model.count_params_analytical(jx_get_config(arch))
    got = pt_model.count_params_analytical(get_config(arch))
    assert got == want == get_config(arch).param_count()
    if arch == "smollm-135m":
        assert got == 134_515_008
    assert pt_model.count_params_analytical(get_smoke_config(arch)) == (
        jx_model.count_params_analytical(jx_get_smoke_config(arch)))


@pytest.mark.parametrize("arch", DENSE)
def test_port_init_matches_schema_and_seed(arch):
    cfg = get_smoke_config(arch)
    a = pt_model.init_model(0, cfg, "cpu")
    b = pt_model.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    jp, _ = _params(arch, "bfloat16")
    for t, u, ref in zip(tree_leaves(a), tree_leaves(b), jax.tree.leaves(jp)):
        assert torch.equal(t, u) and t.dtype == torch.bfloat16 and tuple(t.shape) == ref.shape
    assert torch.all(a["final_norm"] == 1)
    if cfg.qkv_bias:
        assert torch.all(a["layers"]["attn"]["bq"] == 0)
    assert float(a["tok_embed"].float().std()) == pytest.approx(0.02, rel=0.1)
    c = pt_model.init_model(1, cfg, "cpu")
    assert not torch.equal(a["tok_embed"], c["tok_embed"])
    f32 = init_params(torch.Generator().manual_seed(0), pt_model.model_schema(cfg), torch.float32)
    assert torch.equal(f32["tok_embed"].bfloat16(), a["tok_embed"])


# -------------------------------------------------------------------- model


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_train_logits_match_reference(arch, dtype):
    jcfg, pcfg = _cfg(arch, dtype)
    jp, pp = _params(arch, dtype)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (B, 12), dtype=np.int32)
    want, _ = jx_model.forward_train(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
    for impl in ("xla", "flash"):
        got, aux = pt_model.forward_train(pp, {"tokens": torch.from_numpy(tokens)},
                                          pcfg.scaled(attention_impl=impl))
        assert aux == {} and got.dtype == torch.float32 and tuple(got.shape) == want.shape
        _close(got, want, LOGIT_TOL[dtype])


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_port_decode_matches_teacher_forcing(arch, impl):
    """The reference's own check, on the port: prefill + decode steps give
    the full forward's logits (tests/test_models.py's bound, 2e-2)."""
    cfg = get_smoke_config(arch).scaled(attention_impl=impl)
    params = pt_model.init_model(1, cfg, "cpu")
    s, sp = 12, 8
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (B, s)))
    full, _ = pt_model.forward_train(params, {"tokens": tokens}, cfg)
    cache = pt_model.init_cache(cfg, B, s, "cpu")
    assert cache["k"].dtype == torch.bfloat16
    last, cache = pt_model.forward_prefill(params, {"tokens": tokens[:, :sp]}, cache, cfg)
    errs = [float((last - full[:, sp - 1]).abs().max())]
    for t in range(sp, s):
        logits, cache = pt_model.decode_step(params, cache, tokens[:, t : t + 1], t, cfg)
        errs.append(float((logits - full[:, t]).abs().max()))
    assert max(errs) < 2e-2, errs


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_cache_matches_reference(dtype):
    """``forward_prefill``'s last logits and every layer's bf16 K/V cache,
    padded with zeros past the prompt as the reference's is."""
    jcfg, pcfg = _cfg("qwen1.5-110b", dtype)
    jp, pp = _params("qwen1.5-110b", dtype)
    tokens = _prompts(jcfg)
    want, wcache = jx_model.forward_prefill(jp, {"tokens": jnp.asarray(tokens)},
                                            jx_model.init_cache(jcfg, B, PLEN + 4), jcfg)
    cache = pt_model.init_cache(pcfg, B, PLEN + 4, "cpu")
    cache["k"].fill_(7)  # stale contents past the prompt must be cleared
    got, gcache = pt_model.forward_prefill(pp, {"tokens": torch.from_numpy(tokens)}, cache,
                                           pcfg.scaled(attention_impl="flash"))
    _close(got, want, LOGIT_TOL[dtype])
    for name in ("k", "v"):
        assert gcache[name].dtype == torch.bfloat16
        _close(gcache[name], wcache[name], 3e-2)
        assert torch.all(gcache[name][:, :, PLEN:] == 0)


# ------------------------------------------------------------ serving slice


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_serve_session_matches_reference_greedy_loop(arch, impl, dtype):
    _, pcfg = _cfg(arch, dtype)
    _, pp = _params(arch, dtype)
    sess = pt_serve.ServeSession(arch, smoke=True, batch=B, max_seq=PLEN + GEN + 1,
                                 device="cpu", attention_impl=impl, dtype=dtype, params=pp)
    assert sess.cfg.attention_impl == impl and sess.cfg.dtype == dtype
    tokens, stats = sess.generate(_prompts(pcfg), GEN, keep_logits=True)
    assert tokens.shape == (B, PLEN + GEN) and np.array_equal(tokens[:, :PLEN], _prompts(pcfg))
    assert set(stats) == {"prefill_s", "decode_s", "decode_tok_per_s", "logits"}
    got = tokens[:, PLEN:]
    if dtype == "float32":
        want_tokens, want_logits = _reference_greedy(arch, dtype)
        np.testing.assert_array_equal(got, want_tokens)
    else:
        _, want_logits = _reference_greedy(arch, dtype, force=got.astype(np.int32).tobytes())
    _close(stats["logits"], want_logits, LOGIT_TOL[dtype])


def test_serve_session_defaults_and_guards():
    sess = pt_serve.ServeSession("smollm-135m", smoke=True, batch=B, device="cpu")
    assert sess.cfg.attention_impl == "xla" and sess.cfg.dtype == "bfloat16"  # the config's
    with pytest.raises(ValueError, match="Mesh"):  # a mesh must be the port's Mesh
        pt_serve.ServeSession("smollm-135m", smoke=True, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="attention_impl"):
        pt_serve.ServeSession("smollm-135m", smoke=True, device="cpu", attention_impl="pallas")
    with pytest.raises(ValueError, match="encoder-only"):
        pt_serve.ServeSession("hubert-xlarge", smoke=True, device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            pt_serve.ServeSession("smollm-135m", smoke=True)


def test_temperature_sampling_is_seeded():
    prompts = _prompts(get_smoke_config("smollm-135m"))
    runs = []
    for seed in (5, 5, 6):
        sess = pt_serve.ServeSession("smollm-135m", smoke=True, batch=B, max_seq=PLEN + 9,
                                     device="cpu", temperature=1.0, seed=seed)
        runs.append(sess.generate(prompts, 8)[0][:, PLEN:])
    assert np.array_equal(runs[0], runs[1]) and not np.array_equal(runs[0], runs[2])
    assert runs[0].min() >= 0 and runs[0].max() < 256


def test_step_builders_run_under_inference_mode():
    cfg = get_smoke_config("deepseek-67b").scaled(attention_impl="flash")
    params = pt_model.init_model(0, cfg, "cpu")
    tokens = torch.from_numpy(_prompts(cfg))
    cache = pt_model.init_cache(cfg, B, PLEN + 2, "cpu")
    logits, cache = make_prefill_step(cfg)(params, cache, {"tokens": tokens})
    assert logits.shape == (B, cfg.vocab) and torch.isfinite(logits).all()
    nxt = logits.argmax(-1, keepdim=True)
    logits2, _ = make_serve_step(cfg)(params, cache, nxt, PLEN)
    assert logits2.is_inference() and torch.isfinite(logits2).all()


def test_serve_cli_runs_on_cpu(capsys):
    assert pt_serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                          "--attention-impl", "flash", "--batch", "2", "--prompt-len", "8",
                          "--gen", "4"]) == 0
    assert "generated shape=(2, 12)" in capsys.readouterr().out


def test_lm_modules_import_no_jax_and_nothing_of_repro():
    code = (
        "import sys\n"
        "import repro_torch.configs, repro_torch.models.config, repro_torch.models.params\n"
        "import repro_torch.models.layers, repro_torch.models.model\n"
        "import repro_torch.models.moe, repro_torch.models.ssm\n"
        "import repro_torch.distributed.kv_quant\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.launch.steps, repro_torch.launch.serve\n"
        "from repro_torch.configs import ARCHS, get_config\n"
        "[get_config(a) for a in ARCHS]\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env={"PYTHONPATH": str(SRC), "PATH": ""},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_shape_matrix_matches_reference():
    """The port's assigned shapes and its (arch x shape) cell matrix, skips
    and reasons included, equal the JAX package's."""
    import dataclasses

    from repro.configs import SHAPES as JX_SHAPES
    from repro.configs import all_cells as jx_all_cells
    from repro.configs import arch_families as jx_arch_families
    from repro_torch.configs import SHAPES, Shape, all_cells, arch_families

    assert all(isinstance(s, Shape) for s in SHAPES.values())
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JX_SHAPES.items()}
    assert list(all_cells(arch_families())) == list(jx_all_cells(jx_arch_families()))
