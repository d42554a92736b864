"""Port vs reference: int8 KV-cache quantization.

``repro_torch.distributed.kv_quant`` against ``repro.distributed.kv_quant``
on the same numpy inputs: float32 inputs give the reference's int8 values,
scales and dequantized values bit for bit (both round half to even), bf16
inputs too; then ``tests/test_kv_quant.py``'s three bounds on the port: the
round trip within half a scale, attention against a quantized cache within
5e-2, and an int8 cache under 0.55 of a bf16 one.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import kv_quant as jx_kv  # noqa: E402

from repro_torch.distributed import kv_quant as pt_kv  # noqa: E402


def _kv(seed, shape=(2, 64, 4, 32), scale=1.0):
    rng = np.random.default_rng(seed)
    kv = (rng.normal(size=shape) * scale).astype(np.float32)
    kv[0, 0, 0] = 0.0  # an all-zero row: the scale's 1e-12 floor
    return kv


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_float32_matches_reference_bit_for_bit(scale, out_dtype):
    kv = _kv(int(scale * 10) + 1, scale=scale)
    jq, js = jx_kv.kv_quantize(jnp.asarray(kv))
    pq, ps = pt_kv.kv_quantize(torch.from_numpy(kv))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32 and tuple(ps.shape) == js.shape
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    want = jx_kv.kv_dequantize(jq, js, getattr(jnp, out_dtype))
    got = pt_kv.kv_dequantize(pq, ps, getattr(torch, out_dtype))
    if out_dtype == "bfloat16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bfloat16_input_matches_reference():
    kv = _kv(5)
    jq, js = jx_kv.kv_quantize(jnp.asarray(kv, jnp.bfloat16))
    pq, ps = pt_kv.kv_quantize(torch.from_numpy(kv).bfloat16())
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_rounding_is_half_to_even():
    scale = np.float32(1.0 / 127.0)
    q, _ = pt_kv.kv_quantize(torch.tensor([[0.5, 1.5, 2.5, -0.5, 127.0]]) * scale)
    want, _ = jx_kv.kv_quantize(jnp.asarray([[0.5, 1.5, 2.5, -0.5, 127.0]]) * scale)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want))
    assert q.tolist() == [[0, 2, 2, 0, 127]]


def test_roundtrip_error_bounded():
    """Symmetric int8: |err| <= scale / 2 elementwise (tests/test_kv_quant.py)."""
    kv = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 64, 4, 32)).astype(np.float32))
    q, scale = pt_kv.kv_quantize(kv)
    back = pt_kv.kv_dequantize(q, scale, torch.float32)
    assert bool(((back - kv).abs() <= scale / 2 + 1e-7).all())


def test_attention_logit_error_small():
    """Attention against a quantized cache stays within serving tolerance
    (tests/test_kv_quant.py's 5e-2)."""
    rng = np.random.default_rng(0)
    b, s, h, hd = 2, 128, 4, 64
    k, v = (torch.from_numpy(rng.normal(size=(b, s, h, hd)).astype(np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.normal(size=(b, 1, h, hd)).astype(np.float32))
    k2 = pt_kv.kv_dequantize(*pt_kv.kv_quantize(k), torch.float32)
    v2 = pt_kv.kv_dequantize(*pt_kv.kv_quantize(v), torch.float32)

    def attn(kk, vv):
        s_ = torch.einsum("bqhd,bshd->bhqs", q, kk) / (hd ** 0.5)
        return torch.einsum("bhqs,bshd->bqhd", torch.softmax(s_, -1), vv)

    assert float((attn(k, v) - attn(k2, v2)).abs().max()) < 5e-2


@pytest.mark.parametrize("args", [(128, 32768, 8, 128, 80), (4, 512, 8, 128, 10), (1, 1, 1, 2, 1)])
def test_cache_bytes_match_reference_and_halve(args):
    for quantized in (False, True):
        assert pt_kv.kv_cache_bytes(*args, quantized=quantized) == jx_kv.kv_cache_bytes(
            *args, quantized=quantized)
    full = pt_kv.kv_cache_bytes(128, 32768, 8, 128, 80, quantized=False)
    assert pt_kv.kv_cache_bytes(128, 32768, 8, 128, 80, quantized=True) < 0.55 * full


def test_kv_quant_imports_no_jax():
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys, repro_torch.distributed.kv_quant\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], env={"PYTHONPATH": str(src), "PATH": ""},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
