"""Port vs reference: the flash-attention kernel's plain version and the
attention paths around it.

The JAX package's Pallas kernel ``flash_attention_pallas`` does not run on
this JAX (``pl.load`` is gone), so the port's flash path is held against
the two references that do: the softmax formula of ``_ref_attn``
(tests/test_flash_and_cost.py) and the reference's XLA attention,
``repro.models.layers.attention_op(impl="xla")``, which the reference itself
requires its flash path to match. Inputs come from a seeded numpy
generator and go to both packages as the same numbers. Tolerances are the
reference's own: 2e-5 in float32, 2e-2 in bfloat16 (one bf16 rounding of
the weights and of the output). The CUDA kernel runs only on a card
(tests/test_torch_gpu.py and chip_smoke.py).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_io_bytes as jx_flash_io_bytes  # noqa: E402
from repro.models import layers as jx_layers  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
PT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _ref_attn(q, k, v, qp, kp, causal, hd):
    """tests/test_flash_and_cost.py's oracle, the direct softmax formula."""
    s = jnp.einsum("bqd,bkd->bqk", q, k).astype(jnp.float32) / (hd ** 0.5)
    if causal:
        s = jnp.where(qp[:, :, None] >= kp[:, None, :], s, -1e30)
    return jnp.einsum("bqk,bkd->bqd", jax.nn.softmax(s, -1).astype(v.dtype), v)


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(PT[dtype])


def _operands(seed, bh, sq, sk, hd, dtype, offset=True):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(bh, s, hd)).astype(np.float32) for s in (sq, sk, sk))
    # Queries sit at the end of the keys when Sq < Sk (chunked prefill).
    start = sk - sq if offset and sq < sk else 0
    qp = np.broadcast_to(np.arange(start, start + sq, dtype=np.int32), (bh, sq)).copy()
    kp = np.broadcast_to(np.arange(sk, dtype=np.int32), (bh, sk)).copy()
    # Round through the working type once, so both packages see equal inputs.
    q, k, v = (np.asarray(jnp.asarray(a, JX[dtype]), np.float32) for a in (q, k, v))
    return q, k, v, qp, kp


def _port(q, k, v, qp, kp, causal, dtype):
    out = fa.flash_attention(
        _to_torch(q, dtype), _to_torch(k, dtype), _to_torch(v, dtype),
        torch.from_numpy(qp), torch.from_numpy(kp), causal=causal,
    )
    assert out.dtype == PT[dtype]
    return out.float().numpy()


def _close(got, want, dtype):
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# The reference sweep's shapes (bh 3, hd 32), then ragged and offset ones.
SWEEP = [(128, 128), (256, 128), (64, 256)]
RAGGED = [(1, 1), (1, 37), (100, 100), (37, 91), (91, 37), (130, 300)]


@pytest.mark.parametrize("sq,sk", SWEEP + RAGGED)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_ref_attn(sq, sk, causal, dtype):
    hd = 32
    q, k, v, qp, kp = _operands(sq * 7 + sk, 3, sq, sk, hd, dtype)
    want = _ref_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(qp), jnp.asarray(kp), causal, hd)
    _close(_port(q, k, v, qp, kp, causal, dtype), want, dtype)


@pytest.mark.parametrize("hd", [16, 64, 80, 112, 128, 48])
def test_plain_version_any_head_dim(hd):
    q, k, v, qp, kp = _operands(hd, 2, 70, 70, hd, "float32")
    want = _ref_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(qp), jnp.asarray(kp), True, hd)
    _close(_port(q, k, v, qp, kp, True, "float32"), want, "float32")


def test_fully_masked_rows_average_v_as_the_reference():
    """A query that sees no key (q_pos < every k_pos) gets uniform weights
    over the -1e30 scores, in the kernel's online softmax and the formula."""
    q, k, v, _, kp = _operands(5, 2, 8, 16, 32, "float32")
    qp = np.full((2, 8), -1, np.int32)
    qp[:, 4:] = 3  # half the rows see keys 0..3
    want = _ref_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(qp), jnp.asarray(kp), True, 32)
    got = _port(q, k, v, qp, kp, True, "float32")
    _close(got, want, "float32")
    np.testing.assert_allclose(got[:, 0], v.mean(axis=1), rtol=1e-5, atol=1e-5)


def _bshd(seed, b, s, heads, hd):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, s, heads, hd)).astype(np.float32)


@pytest.mark.parametrize("sq,sk", [(64, 64), (48, 80), (1, 33), (100, 100)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_path_matches_reference_xla_attention(sq, sk, causal, dtype):
    """``attention_op(impl="flash")`` of the port (GQA heads repeated, the
    [B, S, H, hd] layout flattened for the kernel) against the reference's
    ``attention_op(impl="xla")`` on the same numbers."""
    b, h, kh, hd = 2, 4, 2, 16
    q = _bshd(sq, b, sq, h, hd)
    k, v = _bshd(sk + 1, b, sk, kh, hd), _bshd(sk + 2, b, sk, kh, hd)
    q, k, v = (np.asarray(jnp.asarray(a, JX[dtype]), np.float32) for a in (q, k, v))
    start = sk - sq if sq < sk else 0
    qp = np.broadcast_to(np.arange(start, start + sq, dtype=np.int32), (b, sq)).copy()
    kp = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    want = jx_layers.attention_op(
        *(jnp.asarray(a, JX[dtype]) for a in (q, k, v)), jnp.asarray(qp), jnp.asarray(kp),
        causal, impl="xla")
    got = pt_layers.attention_op(
        *(_to_torch(a, dtype) for a in (q, k, v)), torch.from_numpy(qp), torch.from_numpy(kp),
        causal, impl="flash")
    assert tuple(got.shape) == (b, sq, h, hd) and got.dtype == PT[dtype]
    _close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_xla_paths_match_reference_chunked_and_whole(dtype):
    """The port's plain attention (``impl="xla"``), whole and chunked above
    the threshold, against the reference's on the same numbers."""
    b, s, h, kh, hd = 2, 64, 4, 2, 16
    q, k, v = _bshd(1, b, s, h, hd), _bshd(2, b, s, kh, hd), _bshd(3, b, s, kh, hd)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    for threshold in (8192, 16):
        want = jx_layers.attention_op(
            *(jnp.asarray(a, JX[dtype]) for a in (q, k, v)), jnp.asarray(pos), jnp.asarray(pos),
            True, chunk_threshold=threshold, chunk=16, impl="xla")
        got = pt_layers.attention_op(
            *(_to_torch(a, dtype) for a in (q, k, v)), torch.from_numpy(pos),
            torch.from_numpy(pos), True, chunk_threshold=threshold, chunk=16, impl="xla")
        _close(got.float().numpy(), want, dtype)


def test_flash_path_never_falls_back(monkeypatch):
    """Shapes the reference's blocks do not tile (it returns None and runs
    XLA attention) still go through the flash entry point in the port: one
    call of the [B, S, H, hd] entry, on the GQA heads as they are."""
    calls = []
    real = fa.flash_attention_bshd_reference

    def spy(*args, **kwargs):
        calls.append((tuple(args[0].shape), tuple(args[1].shape)))
        return real(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention_bshd_reference", spy)
    b, h, kh, hd = 1, 4, 2, 16
    q = torch.from_numpy(_bshd(0, b, 517, h, hd))
    kv = torch.from_numpy(_bshd(1, b, 517, kh, hd))
    pos = torch.arange(517, dtype=torch.int32)[None]
    pt_layers.attention_op(q, kv, kv, pos, pos, True, impl="flash")
    assert calls == [((b, 517, h, hd), (b, 517, kh, hd))]


@pytest.mark.parametrize("h,kh", [(9, 3), (4, 1), (2, 2)])
@pytest.mark.parametrize("sq,sk", [(64, 64), (37, 91), (1, 1), (100, 60)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bshd_plain_version_matches_reference_xla_and_bh(h, kh, sq, sk, dtype):
    """The GQA layout's plain version against the reference's XLA attention
    on the same numbers, and head by head against the [BH, S, hd] plain
    version with each query head's KV head."""
    _bshd_plain_case(h, kh, sq, sk, dtype, hd=16)


@pytest.mark.parametrize("hd", [80, 112])
@pytest.mark.parametrize("h,kh", [(9, 3), (4, 1), (2, 2)])
@pytest.mark.parametrize("sq,sk", [(64, 64), (37, 91), (1, 1), (100, 60)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bshd_plain_version_matches_reference_xla_at_wide_heads(hd, h, kh, sq, sk, dtype):
    """The same at hubert-xlarge's and zamba2-7b's head dims, the widths of
    the kernel's exact-width plan. Head by head within float32's last place:
    the CPU's BLAS may block the two layouts' batched products differently
    at these widths (5.7e-7 at hd 112, 100 x 60)."""
    _bshd_plain_case(h, kh, sq, sk, dtype, hd=hd, head_tol=1e-6)


def _bshd_plain_case(h, kh, sq, sk, dtype, hd, head_tol=0.0):
    b = 2
    q = _bshd(sq * 3 + h, b, sq, h, hd)
    k, v = _bshd(sk + kh, b, sk, kh, hd), _bshd(sk + 7, b, sk, kh, hd)
    q, k, v = (np.asarray(jnp.asarray(a, JX[dtype]), np.float32) for a in (q, k, v))
    start = sk - sq if sq < sk else 0
    qp = np.broadcast_to(np.arange(start, start + sq, dtype=np.int32), (b, sq)).copy()
    kp = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    for causal in (True, False):
        want = jx_layers.attention_op(
            *(jnp.asarray(a, JX[dtype]) for a in (q, k, v)), jnp.asarray(qp), jnp.asarray(kp),
            causal, impl="xla")
        ops = (*(_to_torch(a, dtype) for a in (q, k, v)), torch.from_numpy(qp),
               torch.from_numpy(kp))
        got = fa.flash_attention_bshd(*ops, causal=causal)
        assert tuple(got.shape) == (b, sq, h, hd) and got.dtype == PT[dtype]
        _close(got.float().numpy(), want, dtype)
        for head in range(h):
            g = head // (h // kh)
            bh = fa.flash_attention(
                ops[0][:, :, head].contiguous(), ops[1][:, :, g].contiguous(),
                ops[2][:, :, g].contiguous(), ops[3], ops[4], causal=causal)
            torch.testing.assert_close(got[:, :, head], bh, rtol=head_tol, atol=head_tol)


def _brute_visible(qp, kp, bq, bk):
    """Whether any (query, key) pair of each tile pair is visible, by brute
    force over the pairs."""
    b, sq = qp.shape
    sk = kp.shape[1]
    nq, nk = -(-sq // bq), -(-sk // bk)
    out = np.zeros((b, nq, nk), bool)
    for bi in range(b):
        vis = qp[bi][:, None] >= kp[bi][None, :]
        for i in range(nq):
            for j in range(nk):
                out[bi, i, j] = vis[i * bq:(i + 1) * bq, j * bk:(j + 1) * bk].any()
    return out


@pytest.mark.parametrize("kind", ["arange", "offset", "reversed", "permuted", "after", "random"])
@pytest.mark.parametrize("bq,bk", [(128, 128), (64, 64), (16, 32)])
def test_skip_rule_skips_only_wholly_masked_tiles(kind, bq, bk):
    """``flash_tile_visible`` (the kernel's rule: min k_pos of the tile >
    max q_pos of the q tile) marks a tile skipped exactly when every pair
    in it is masked; ``flash_tiles_scored`` adds the rescans of q tiles
    holding a row that sees no key."""
    rng = np.random.default_rng(len(kind) * 100 + bq + bk)
    b, sq, sk = 2, 300, 260
    qp = np.broadcast_to(np.arange(sq, dtype=np.int32), (b, sq)).copy()
    kp = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    if kind == "offset":
        qp = qp[:, :100] + sk - 100
    elif kind == "reversed":
        qp, kp = qp[:, ::-1].copy(), kp[:, ::-1].copy()
    elif kind == "permuted":
        qp, kp = rng.permuted(qp, axis=1), rng.permuted(kp, axis=1)
    elif kind == "after":
        kp = kp + sq
    elif kind == "random":
        qp = rng.integers(-50, 400, qp.shape).astype(np.int32)
        kp = rng.integers(0, 300, kp.shape).astype(np.int32)
    got = fa.flash_tile_visible(torch.from_numpy(qp), torch.from_numpy(kp), bq, bk).numpy()
    assert np.array_equal(got, _brute_visible(qp, kp, bq, bk))
    blind = (qp < kp.min(axis=1, keepdims=True))  # rows that see no key
    nq, nk = got.shape[1:]
    pad = np.zeros((b, nq * bq), bool)
    pad[:, : qp.shape[1]] = blind
    want = 3 * int(got.sum() + nk * pad.reshape(b, nq, bq).any(axis=2).sum())
    assert fa.flash_tiles_scored(torch.from_numpy(qp), torch.from_numpy(kp), 3, bq, bk) == want
    assert fa.flash_tiles_scored(torch.from_numpy(qp), torch.from_numpy(kp), 3, bq, bk,
                                 causal=False) == 3 * b * nq * nk
    if kind == "arange":  # causal square: the lower triangle of tiles and the diagonal
        assert got.sum() == b * sum(min(nk, -(-((i + 1) * bq) // bk)) for i in range(nq))


def test_skip_rule_counts_about_half_at_the_prefill_shape():
    """8 x 4096 causal, 128-row / 128-key tiles: 32 * 33 / 2 of 32^2 tiles a
    head, 51.6 %."""
    pos = torch.arange(4096, dtype=torch.int32)[None].expand(8, 4096)
    assert fa.flash_tiles_scored(pos, pos, 9, 128, 128) == 8 * 9 * 528


def test_flash_io_bytes_matches_reference():
    for args in [(1, 1, 4, 4, 2), (8, 9, 4096, 4096, 64), (1, 9, 32768, 32768, 64)]:
        for train in (False, True):
            assert fa.flash_io_bytes(*args, train=train) == jx_flash_io_bytes(*args, train=train)
    assert fa.flash_io_bytes(1, 1, 4, 4, 2, train=False) == 64


def _good(hd=32, dtype=torch.bfloat16, bh=2, sq=8, sk=8):
    q = torch.zeros(bh, sq, hd, dtype=dtype)
    k = torch.zeros(bh, sk, hd, dtype=dtype)
    pos_q = torch.zeros(bh, sq, dtype=torch.int32)
    pos_k = torch.zeros(bh, sk, dtype=torch.int32)
    return q, k, k.clone(), pos_q, pos_k


@pytest.mark.parametrize("hd", [8, 48, 96, 256])
def test_kernel_wrapper_rejects_unsupported_head_dim(hd):
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(*_good(hd=hd))


def test_kernel_wrapper_rejects_bad_operands():
    q, k, v, qp, kp = _good()
    with pytest.raises(TypeError, match="bfloat16 or all float32"):
        fa.flash_attention_cuda(q.half(), k.half(), v.half(), qp, kp)
    with pytest.raises(TypeError, match="bfloat16 or all float32"):
        fa.flash_attention_cuda(q, k.float(), v, qp, kp)
    with pytest.raises(TypeError, match="int32"):
        fa.flash_attention_cuda(q, k, v, qp.long(), kp)
    with pytest.raises(ValueError, match="positions"):
        fa.flash_attention_cuda(q, k, v, qp[:, :3], kp)
    with pytest.raises(ValueError, match="k and v"):
        fa.flash_attention_cuda(q, k, v[:, :4], qp, kp)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, qp, kp)
    # Everything else in order, a CPU tensor is refused: no plain fallback.
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_cuda(q, k, v, qp, kp)


def _good_bshd(hd=32, dtype=torch.bfloat16, b=2, sq=8, sk=8, h=4, kh=2):
    q = torch.zeros(b, sq, h, hd, dtype=dtype)
    k = torch.zeros(b, sk, kh, hd, dtype=dtype)
    pos = (torch.zeros(b, n, dtype=torch.int32) for n in (sq, sk))
    return q, k, k.clone(), *pos


def test_bshd_wrapper_rejects_bad_operands():
    q, k, v, qp, kp = _good_bshd()
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_bshd_cuda(*_good_bshd(hd=48))
    with pytest.raises(ValueError, match="multiple of the KV heads"):
        fa.flash_attention_bshd_cuda(*_good_bshd(h=3, kh=2))
    with pytest.raises(ValueError, match="k and v"):
        fa.flash_attention_bshd_cuda(q, k, v[:, :4], qp, kp)
    with pytest.raises(ValueError, match="positions"):
        fa.flash_attention_bshd_cuda(q, k, v, qp[:, :3], kp)
    with pytest.raises(TypeError, match="int32"):
        fa.flash_attention_bshd_cuda(q, k, v, qp, kp.long())
    with pytest.raises(ValueError, match="contiguous head dim"):
        fa.flash_attention_bshd_cuda(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, qp, kp)
    with pytest.raises(ValueError, match="aligned"):  # a row stride of 12 bf16 values
        fa.flash_attention_bshd_cuda(
            torch.zeros(256, dtype=torch.bfloat16).as_strided((2, 8, 1, 16), (96, 12, 16, 1)),
            *_good_bshd(hd=16, h=1, kh=1)[1:])
    with pytest.raises(ValueError, match="65535"):
        fa.flash_attention_bshd_cuda(*_good_bshd(h=65536, kh=1, sq=1, sk=1, hd=16, b=1))
    # Everything else in order, a CPU tensor is refused: no plain fallback.
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_bshd_cuda(q, k, v, qp, kp)
