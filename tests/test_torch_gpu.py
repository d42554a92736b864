"""Card-only tests of the port: the CUDA kernels against their plain
versions on CUDA tensors, the main path and the server on the card.

Every test here carries the ``gpu`` marker and skips without a card (the
check runs inside the ``cuda`` fixture, never at import time, so every
pytest-xdist worker collects the same tests). This file imports torch,
numpy and the port only — no JAX — so it runs on a machine that has a card
and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    CountFuture,
    Executor,
    build_sbf,
    build_worklist,
    build_worklist_pairs,
    device_build,
    device_build_async,
    device_delta_worklist,
    pow2_ceil,
    tcim_count,
)
from repro_torch.graphs import build_graph, rmat, triangles_intersection  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import ref_dense_tc  # noqa: E402
from repro_torch.kernels.slice_and_popcount import (  # noqa: E402
    items_cuda,
    items_reference,
    total_cuda,
    total_reference,
)
from repro_torch.kernels.tc_bitgemm import (  # noqa: E402
    ROW_ALIGN_WORDS,
    bitgemm_cuda,
    bitgemm_reference,
    padded_view,
)
from repro_torch.kernels.tc_dense_mxu import (  # noqa: E402
    dense_mxu_tc_cuda,
    dense_mxu_tc_reference,
)
from repro_torch.kernels.tc_gather_popcount import (  # noqa: E402
    GROUP_CAP,
    GatherTotalLauncher,
    gather_segment_groups_reference,
    gather_segment_totals_cuda,
    gather_segment_totals_reference,
    gather_total_cuda,
    gather_total_reference,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _words(rng, rows, w, device):
    a = rng.integers(0, 2**32, size=(rows, w), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


@pytest.mark.parametrize("p", [0, 1, 1000, 1 << 16])
@pytest.mark.parametrize("w", [1, 2, 4])
def test_kernel_equals_plain_on_card(cuda, w, p):
    rng = np.random.default_rng(w * 7 + p)
    row, col = _words(rng, 5000, w, cuda), _words(rng, 3001, w, cuda)
    r = rng.integers(0, 5000, size=p).astype(np.int32)
    c = rng.integers(0, 3001, size=p).astype(np.int32)
    r[rng.random(p) < 0.1] = -1
    c[rng.random(p) < 0.1] = -1
    r[: p // 3] = 4  # hot row
    ridx, cidx = torch.from_numpy(r).to(cuda), torch.from_numpy(c).to(cuda)
    before = gather_total_cuda.launches
    got = gather_total_cuda(row, col, ridx, cidx, torch.zeros(2, dtype=torch.int32, device=cuda))
    want = gather_total_reference(row, col, ridx, cidx)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert gather_total_cuda.launches == before + (1 if p else 0)


def test_out_of_range_raises_at_result(cuda):
    rng = np.random.default_rng(3)
    row, col = _words(rng, 100, 2, cuda), _words(rng, 80, 2, cuda)
    ridx = torch.arange(50, dtype=torch.int32, device=cuda)
    cidx = torch.arange(50, dtype=torch.int32, device=cuda)
    ridx[7] = 100
    out = ops.popcount_and_gather_total(row, col, ridx, cidx)
    with pytest.raises(ValueError, match="past the end"):
        CountFuture([out]).result()


def test_wrapper_rejects_bad_operands(cuda):
    rng = np.random.default_rng(4)
    row, col = _words(rng, 64, 2, cuda), _words(rng, 64, 2, cuda)
    idx = torch.zeros(8, dtype=torch.int32, device=cuda)
    out = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        gather_total_cuda(_words(rng, 64, 3, cuda), _words(rng, 64, 3, cuda), idx, idx, out)
    with pytest.raises(TypeError):
        gather_total_cuda(row, col, idx.long(), idx.long(), out)
    with pytest.raises(ValueError):
        gather_total_cuda(row.t(), col, idx, idx, out)


def test_tcim_count_on_card_matches_cpu_and_oracle(cuda):
    edges = rmat(20000, 150000, seed=9)
    g = build_graph(edges, reorder=True)
    want = triangles_intersection(g)
    for bits in (32, 64, 128):
        for build in ("auto", "host"):
            before = gather_total_cuda.launches
            res = tcim_count(edges, slice_bits=bits, chunk_pairs=1 << 14, build=build)
            pairs = res.stats["num_pairs"]
            if build == "auto":
                # The card's default is the device build, whose work list is
                # -1-padded to its pow2 bucket and runs in windows.
                assert res.stats["build"] == "device"
                pairs = pow2_ceil(pairs)
            assert gather_total_cuda.launches - before == -(-pairs // (1 << 14))
            assert res.stats["device"].startswith("cuda")
            assert res.triangles == want
        assert want == tcim_count(edges, slice_bits=bits, device="cpu").triangles


@pytest.mark.parametrize("bits", [32, 64, 128])
@pytest.mark.parametrize("seed", [3, 4])
def test_device_build_on_card_matches_host_build(cuda, seed, bits):
    edges = rmat(30000, 200000, seed=seed)
    g = build_graph(edges, reorder=True)
    sb = build_sbf(g, bits)
    wl = build_worklist(g, sb)
    db = device_build(edges, slice_bits=bits)
    assert db.sbf.row_slice_data.device.type == "cuda" and db.worklist.pair_row_pos.is_cuda
    dsb, dwl = db.to_host()
    for f in ("row_ptr", "row_slice_idx", "row_slice_data", "col_ptr", "col_slice_idx",
              "col_slice_data"):
        assert getattr(dsb, f).dtype == getattr(sb, f).dtype
        assert np.array_equal(getattr(dsb, f), getattr(sb, f)), f
    for f in ("pair_edge", "pair_row_pos", "pair_col_pos"):
        assert np.array_equal(getattr(dwl, f), getattr(wl, f)), f
    pick = np.random.default_rng(seed).random(g.m) < 0.25
    src, dst = g.edges[pick, 0], g.edges[pick, 1]
    want = build_worklist_pairs(src, dst, sb)
    for over in (sb, db.sbf):
        dw = device_delta_worklist(src, dst, over).to_host()
        for got, w in zip((dw.pair_edge, dw.pair_row_pos, dw.pair_col_pos), want):
            assert np.array_equal(got, w)


def test_device_build_async_does_not_sync(cuda):
    edges = rmat(30000, 200000, seed=5)
    want = device_build(edges)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fut = device_build_async(edges)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    db = fut.result()
    for f in ("pair_edge", "pair_row_pos", "pair_col_pos"):
        assert torch.equal(getattr(db.worklist, f), getattr(want.worklist, f))
    assert torch.equal(db.sbf.col_slice_data, want.sbf.col_slice_data)


def test_executor_escape_on_card(cuda, monkeypatch):
    import repro_torch.core.executor as executor

    g = build_graph(rmat(4000, 30000, seed=2), reorder=True)
    sb = build_sbf(g, 64)
    wl = build_worklist(g, sb)
    want = Executor(sb, device="cpu").count(wl)
    monkeypatch.setattr(executor, "_INT32_MAX", 1000)
    assert Executor(sb, chunk_pairs=1024).count(wl) == want


@pytest.mark.parametrize("g", [1, 3, 32])
@pytest.mark.parametrize("bucket", [1, 2, 16, 32, 64, 128, 1024])
@pytest.mark.parametrize("w", [1, 2, 4])
def test_segment_kernel_equals_plain_on_card(cuda, w, bucket, g):
    rng = np.random.default_rng(100 * w + bucket + g)
    row, col = _words(rng, 4096, w, cuda), _words(rng, 2048, w, cuda)
    p = g * bucket
    r = rng.integers(0, 4096, size=p).astype(np.int32)
    c = rng.integers(0, 2048, size=p).astype(np.int32)
    r[rng.random(p) < 0.1] = -1
    c[rng.random(p) < 0.1] = -1
    if g > 1:
        r[-bucket:] = -1  # an all-sentinel trailing segment
    r[rng.random(p) < 0.02] = 4096 + 3  # out of range: counted, never read
    ridx, cidx = torch.from_numpy(r).to(cuda), torch.from_numpy(c).to(cuda)
    before = gather_segment_totals_cuda.launches
    got = gather_segment_totals_cuda(
        row, col, ridx, cidx, torch.zeros(g, 2, dtype=torch.int32, device=cuda), bucket=bucket
    )
    want = gather_segment_totals_reference(row, col, ridx, cidx, bucket=bucket)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert gather_segment_totals_cuda.launches == before + 1
    if g > 1:
        assert int(got[-1, 0]) == 0


@pytest.mark.parametrize("p", [1, 3, 1001, 1 << 16])
@pytest.mark.parametrize("w", [1, 2, 4])
def test_unfused_kernels_equal_plain_on_card(cuda, w, p):
    rng = np.random.default_rng(w * 11 + p)
    rows, cols = _words(rng, p, w, cuda), _words(rng, p, w, cuda)
    rows[: p // 3] = 0
    before = (total_cuda.launches, items_cuda.launches)
    tot = total_cuda(rows, cols, torch.zeros(1, dtype=torch.int32, device=cuda))
    items = items_cuda(rows, cols, torch.empty(p, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert int(tot) == int(total_reference(rows, cols))
    assert torch.equal(items.cpu(), items_reference(rows, cols).cpu())
    assert (total_cuda.launches, items_cuda.launches) == (before[0] + 1, before[1] + 1)
    flat = _words(rng, p * w + 1, 1, cuda).reshape(-1)[1:].reshape(p, w)  # not 16-B aligned
    assert int(total_cuda(flat, cols, torch.zeros(1, dtype=torch.int32, device=cuda))) == int(
        total_reference(flat, cols)
    )


def test_server_on_card_matches_cpu_and_oracle(cuda):
    from repro_torch.launch import ServeConfig, TCServer

    jobs, want = [], []
    for i in range(40):
        n = (64, 128, 256, 512)[i % 4]
        g = build_graph(rmat(n, 6 * n, seed=i))
        sb = build_sbf(g, (32, 64, 128)[i % 3])
        jobs.append((sb, build_worklist(g, sb)))
        want.append(triangles_intersection(g))
    g = build_graph(rmat(20000, 150000, seed=9), reorder=True)
    sb = build_sbf(g, 64)
    jobs.append((sb, build_worklist(g, sb)))
    want.append(triangles_intersection(g))
    for mode in ("fused", "gather_then_kernel", "pallas_items", "jnp"):
        seg = gather_segment_totals_cuda.launches
        # Room in the batch cache for every batch (the default keeps 8), so
        # the re-serve below must hit them all and upload nothing.
        srv = TCServer(ServeConfig(mode=mode, max_fused_pairs=1 << 12, fused_max_batches=64))
        res = sorted(srv.serve(jobs), key=lambda r: r.request_id)
        assert [r.count for r in res] == want
        # One wave: its fused batches share one launch for every GROUP_CAP.
        assert srv.stats["waves"] == 1 and srv.stats["fused_batches"] > 1
        assert gather_segment_totals_cuda.launches - seg == -(-srv.stats["fused_batches"] // GROUP_CAP)
        assert {r.placement for r in res} == {"fused", "replicated"}
        uploads = srv.multi.upload_bytes
        again = sorted(srv.serve(jobs), key=lambda r: r.request_id)
        assert [r.count for r in again] == want and srv.multi.upload_bytes == uploads
        assert srv.multi.stats()["hits"] == srv.multi.stats()["misses"] == len(srv.multi)
    cpu = TCServer(ServeConfig(device="cpu", max_fused_pairs=1 << 12)).serve(jobs)
    assert sorted(r.count for r in cpu) == sorted(want)


@pytest.mark.parametrize("layout", ["contiguous", "padded"])
@pytest.mark.parametrize("w", [0, 1, 3, 8, 9, 31, 33, 127, 255, 256, 1147])
@pytest.mark.parametrize("i,j", [(1, 1), (31, 65), (64, 64), (129, 200), (1000, 77), (130, 300)])
def test_bitgemm_kernel_equals_plain_on_card(cuda, i, j, w, layout):
    """The tensor-core kernel equals its plain version for ragged I, J and W
    (not multiples of its 128 x 256 tile or its 32-word stage): contiguous
    operands are copied once to padded scratch unless W is a multiple of 4;
    row-padded views are read as they lie."""
    rng = np.random.default_rng(i * 1000 + j + w)
    x, y = _words(rng, i, w, cuda), _words(rng, j, w, cuda)
    want = bitgemm_reference(x, y)
    if layout == "padded":
        x, y = padded_view(x, fill=-1), padded_view(y, fill=-1)
    before, copies = bitgemm_cuda.launches, bitgemm_cuda.padded_copies
    got = ops.bitgemm(x, y)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert bitgemm_cuda.launches == before + 1
    expect = 2 if layout == "contiguous" and w % ROW_ALIGN_WORDS else 0
    assert bitgemm_cuda.padded_copies == copies + expect


@pytest.mark.parametrize("i,j", [(1, 1), (129, 300), (300, 513)])
def test_bitgemm_all_ones_on_card(cuda, i, j):
    """All-ones words at W = 1,147 (the email-enron width): every entry is
    32 W = 36,704, summed exactly in int32."""
    x = torch.full((i, 1147), -1, dtype=torch.int32, device=cuda)
    y = torch.full((j, 1147), -1, dtype=torch.int32, device=cuda)
    got = ops.bitgemm(x, padded_view(y, fill=-1))
    torch.cuda.synchronize()
    assert bool((got == 32 * 1147).all())


@pytest.mark.parametrize("j", [300, 77])
def test_bitgemm_unaligned_out_on_card(cuda, j):
    """An out one int32 into its storage (not 16-byte aligned) and an odd J
    take the epilogue's 4-byte stores; the result is the same."""
    rng = np.random.default_rng(j)
    x, y = _words(rng, 300, 40, cuda), _words(rng, j, 40, cuda)
    flat = torch.full((300 * j + 1,), -7, dtype=torch.int32, device=cuda)
    out = flat[1:].view(300, j)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    bitgemm_cuda(x, y, out)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), bitgemm_reference(x, y).cpu()) and int(flat[0]) == -7


def test_bitgemm_rejects_and_refuses(cuda):
    """Refused with an error, never sent to the plain version: host tensors,
    a wrong dtype, a row whose words are not consecutive, a wrong out."""
    rng = np.random.default_rng(5)
    x = _words(rng, 70, 4, cuda)
    out = torch.empty(70, 70, dtype=torch.int32, device=cuda)
    before = bitgemm_cuda.launches
    with pytest.raises(ValueError):
        ops.bitgemm(x, x.cpu())  # a CPU/CUDA mix
    with pytest.raises(ValueError, match="CUDA tensor"):
        bitgemm_cuda(x.cpu(), x.cpu(), out)
    with pytest.raises(TypeError):
        bitgemm_cuda(x.long(), x.long(), out)
    with pytest.raises(ValueError, match="consecutive"):
        bitgemm_cuda(x.t(), x.t(), torch.empty(4, 4, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="consecutive"):
        bitgemm_cuda(x[:, ::2], x[:, ::2], out)
    with pytest.raises(ValueError, match="contiguous"):
        bitgemm_cuda(x, x, torch.empty(70, 140, dtype=torch.int32, device=cuda)[:, ::2])
    assert bitgemm_cuda.launches == before
    assert torch.equal(ops.bitgemm(x, x).cpu(), bitgemm_reference(x, x).cpu())


@pytest.mark.parametrize("density", [0.02, 0.3, 1.0])
@pytest.mark.parametrize("n", [1, 2, 17, 33, 64, 127, 128, 129, 255, 256, 257, 300, 515])
def test_dense_mxu_kernel_equals_plain_on_card(cuda, n, density):
    rng = np.random.default_rng(n + int(1000 * density))
    a = torch.from_numpy(np.triu(rng.random((n, n)) < density, 1)).to(cuda)
    before = dense_mxu_tc_cuda.launches
    got = ops.dense_mxu_tc(a)
    want = dense_mxu_tc_reference(a)
    torch.cuda.synchronize()
    assert int(got) == int(want) == int(ref_dense_tc(a))
    assert dense_mxu_tc_cuda.launches == before + 1
    full = torch.from_numpy(rng.random((n, n)) < density).to(cuda)  # not triangular
    assert int(ops.dense_mxu_tc(full)) == int(dense_mxu_tc_reference(full))


def test_dense_mxu_unaligned_and_mix(cuda):
    """A view one byte into its storage is copied to a padded operand (TMA
    needs 16-byte rows); the count is unchanged."""
    rng = np.random.default_rng(8)
    n = 96
    flat = torch.from_numpy((rng.random(n * n + 1) < 0.4).astype(np.int8)).to(cuda)
    a = flat[1:].view(n, n)
    out = torch.zeros(1, dtype=torch.int64, device=cuda)
    assert int(dense_mxu_tc_cuda(a, out)) == int(dense_mxu_tc_reference(a))
    with pytest.raises(ValueError):
        dense_mxu_tc_cuda(a, torch.zeros(1, dtype=torch.int64))  # CPU out
    with pytest.raises(TypeError):
        dense_mxu_tc_cuda(a.int(), out)


@pytest.mark.parametrize("kind", ["upper", "lower", "full", "block-sparse"])
def test_dense_mxu_skips_by_occupancy_on_card(cuda, kind):
    """The kernel's k steps equal the occupancy plan's, and the count the
    plain version's, on plans that are and are not the triangle."""
    from repro_torch.kernels.tc_dense_mxu import dense_mxu_occupancy_reference, dense_mxu_plan

    rng = np.random.default_rng(len(kind))
    n = 700
    a = rng.random((n, n)) < 0.2
    if kind == "upper":
        a = np.triu(a, 1)
    elif kind == "lower":
        a = np.tril(a, -1)
    elif kind == "block-sparse":
        keep = np.repeat(rng.random(6) < 0.5, 128)[:n]
        a = a & keep[:, None] & keep[None, :]
    a = torch.from_numpy(a).to(cuda)
    steps = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = dense_mxu_tc_cuda(a.to(torch.int8), torch.zeros(1, dtype=torch.int64, device=cuda), steps)
    assert int(got) == int(dense_mxu_tc_reference(a))
    assert int(steps) == int(dense_mxu_plan(dense_mxu_occupancy_reference(a))[1].sum())


def test_dense_backends_on_card_match_oracle(cuda):
    from repro_torch.core import baselines, metrics

    edges = rmat(3000, 24000, seed=4)
    g = build_graph(edges, reorder=True)
    want = triangles_intersection(g)
    before = (bitgemm_cuda.launches, dense_mxu_tc_cuda.launches)
    for backend in ("bitgemm", "mxu"):
        res = tcim_count(edges, backend=backend)
        assert res.triangles == want
        assert tcim_count(edges, backend=backend, device="cpu").triangles == want
        assert tcim_count(edges, backend=backend, async_=True).result().triangles == want
    assert bitgemm_cuda.launches - before[0] == 2 * 2  # two chunks of 2048 rows, twice
    assert dense_mxu_tc_cuda.launches - before[1] == 2
    items = items_cuda.launches
    support = metrics.edge_support(g)
    assert items_cuda.launches == items + 1
    assert np.array_equal(support, metrics.edge_support(g, device="cpu"))
    assert support.sum() == want
    assert baselines.matmul_tc(g, block=1000) == want


def _flash_operands(seed, bh, sq, sk, hd, dtype, device):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(bh, s, hd)).astype(np.float32)).to(device, dtype)
               for s in (sq, sk, sk))
    start = sk - sq if sq < sk else 0
    qp = torch.arange(start, start + sq, dtype=torch.int32, device=device).expand(bh, sq)
    kp = torch.arange(sk, dtype=torch.int32, device=device).expand(bh, sk)
    return q, k, v, qp.contiguous(), kp.contiguous()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 112, 128])
@pytest.mark.parametrize("sq,sk", [(1, 1), (64, 64), (100, 100), (256, 128), (64, 256), (517, 1030)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_equals_plain_on_card(cuda, dtype, hd, sq, sk, causal):
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_cuda,
        flash_attention_reference,
    )

    dt = getattr(torch, dtype)
    ops_ = _flash_operands(sq + sk + hd, 3, sq, sk, hd, dt, cuda)
    before = flash_attention_cuda.launches
    got = flash_attention(*ops_, causal=causal)
    want = flash_attention_reference(*ops_, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (3, sq, hd)
    assert flash_attention_cuda.launches == before + 1
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 112, 128])
@pytest.mark.parametrize("h,kh", [(9, 3), (4, 1)])
@pytest.mark.parametrize("positions", ["arange", "reversed", "keys after queries"])
def test_flash_bshd_kernel_equals_plain_on_card(cuda, dtype, hd, h, kh, positions):
    """The [B, S, H, hd] entry on the GQA heads as they are: equal to the
    plain version, scored tiles equal to the skip rule's."""
    from repro_torch.kernels.flash_attention import (
        FLASH_TILES,
        flash_attention_bshd,
        flash_attention_bshd_cuda,
        flash_attention_bshd_reference,
        flash_tiles_scored,
    )

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(hd + h)
    b, sq, sk = 2, 300, 260
    q = torch.from_numpy(rng.normal(size=(b, sq, h, hd)).astype(np.float32)).to(cuda, dt)
    k, v = (torch.from_numpy(rng.normal(size=(b, sk, kh, hd)).astype(np.float32)).to(cuda, dt)
            for _ in range(2))
    qp = torch.arange(sq, dtype=torch.int32, device=cuda)[None].expand(b, sq)
    kp = torch.arange(sk, dtype=torch.int32, device=cuda)[None].expand(b, sk)
    if positions == "reversed":
        qp, kp = qp.flip(1), kp.flip(1)
    elif positions == "keys after queries":
        kp = kp + sq
    tiles = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = flash_attention_bshd_cuda(q, k, v, qp, kp, tiles=tiles)
    want = flash_attention_bshd_reference(q, k, v, qp, kp)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert int(tiles) == flash_tiles_scored(qp, kp, h, *FLASH_TILES[dt])
    torch.testing.assert_close(flash_attention_bshd(q, k, v, qp, kp), got, rtol=0, atol=0)


def test_flash_wrapper_rejects_bad_operands_on_card(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q, k, v, qp, kp = _flash_operands(1, 2, 64, 64, 64, torch.bfloat16, cuda)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(*_flash_operands(1, 2, 64, 64, 48, torch.bfloat16, cuda))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, k.cpu(), v, qp, kp)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.half(), k.half(), v.half(), qp, kp)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, k, v, qp.long(), kp)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q, k.transpose(0, 1).contiguous().transpose(0, 1), v, qp, kp)
    flat = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_cuda(flat[1:].view(2, 64, 64), k, v, qp, kp)
    assert flash_attention_cuda.launches == before


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_lm_serving_on_card_matches_cpu(cuda, impl):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.serve import ServeSession

    prompts = np.random.default_rng(0).integers(0, 256, (2, 40), dtype=np.int32)
    runs = {}
    for dev in ("cuda", "cpu"):
        sess = ServeSession("qwen1.5-110b", smoke=True, batch=2, max_seq=50, device=dev,
                            attention_impl=impl, dtype="float32")
        before = flash_attention_cuda.launches
        runs[dev] = sess.generate(prompts, 6, keep_logits=True)
        if dev == "cuda":
            assert flash_attention_cuda.launches - before == (2 if impl == "flash" else 0)
    np.testing.assert_array_equal(runs["cuda"][0], runs["cpu"][0])
    np.testing.assert_allclose(runs["cuda"][1]["logits"], runs["cpu"][1]["logits"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("entry", ["bshd", "bh"])
def test_flash_refuses_autograd_on_card(cuda, entry):
    """The kernel writes through a raw pointer: under autograd the output
    would carry no gradient, so both entries raise before launching."""
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bshd,
        flash_attention_cuda,
    )

    q, k, v, qp, kp = _flash_operands(4, 2, 64, 64, 64, torch.bfloat16, cuda)
    if entry == "bshd":
        fn, (q, k, v) = flash_attention_bshd, (t[:, :, None] for t in (q, k, v))
    else:
        fn = flash_attention
    v.requires_grad_()
    before = flash_attention_cuda.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        fn(q, k, v, qp, kp)
    assert flash_attention_cuda.launches == before
    with torch.no_grad():
        out = fn(q, k, v, qp, kp)
    assert out.grad_fn is None and flash_attention_cuda.launches == before + 1


def _rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_train_step_on_card_matches_cpu(cuda, remat):
    """One f32 step of qwen's smoke config (its QKV bias included) on the
    card and on the CPU: metrics within 1e-5, the moments (the clipped
    gradient) within 1e-4 in relative L2 a leaf, the parameters' update
    within 1e-3 (AdamW moves an element whose gradient is mostly rounding by
    about lr whatever its sign: the key bias, as in
    ``tests/test_torch_train.py``); the card's step makes no host sync
    (``set_sync_debug_mode("error")``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw_init

    cfg = get_smoke_config("qwen1.5-110b").scaled(dtype="float32", remat=remat)
    batch = SyntheticLMDataset(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=1).batch(0)
    step_fn = make_train_step(cfg, schedule={"warmup": 0}, microbatches=2)
    out, start = {}, {}
    for dev in ("cuda", "cpu"):
        params = start[dev] = init_model(0, cfg, dev)
        state = adamw_init(params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error" if dev == "cuda" else 0)
        try:
            out[dev] = step_fn(params, state, b)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    (pc, sc, mc), (pg, sg, mg) = out["cpu"], out["cuda"]
    for k in mc:
        assert mg[k].is_cuda
        np.testing.assert_allclose(float(mg[k]), float(mc[k]), rtol=1e-5, err_msg=k)
    for got, want in ((sg["m"], sc["m"]), (sg["v"], sc["v"])):
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert g.is_cuda and _rel_l2(g, w) <= 1e-4
    for g, w, g0, w0 in zip(*(tree_leaves(t) for t in (pg, pc, start["cuda"], start["cpu"]))):
        assert g.is_cuda and _rel_l2(g - g0, w - w0) <= 1e-3


def test_train_loop_on_card_loss_decreases(cuda):
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import AdamWConfig

    loop = TrainLoop("smollm-135m", smoke=True, global_batch=4, seq=32,
                     opt=AdamWConfig(lr=3e-3, weight_decay=0.0))
    params, _, _ = loop.run(60, log_every=20)
    assert all(t.is_cuda for t in params.values() if isinstance(t, torch.Tensor))
    losses = [m["loss"] for m in loop.metrics_log]
    assert losses[-1] < losses[0] - 0.3, losses


def _segment_batch(rng, w, bucket, g, device):
    rows, cols = int(rng.integers(100, 3000)), int(rng.integers(100, 3000))
    row, col = _words(rng, rows, w, device), _words(rng, cols, w, device)
    p = g * bucket
    r = rng.integers(0, rows, size=p).astype(np.int32)
    c = rng.integers(0, cols, size=p).astype(np.int32)
    r[rng.random(p) < 0.1] = -1
    c[rng.random(p) < 0.1] = -1
    if g > 1:
        r[-bucket:], c[-bucket:] = -1, -1  # an all-sentinel trailing segment
    return row, col, torch.from_numpy(r).to(device), torch.from_numpy(c).to(device), bucket


@pytest.mark.parametrize("n", [1, 3, 34, "cap + 1"])
def test_grouped_segment_kernel_equals_plain_on_card(cuda, n):
    """A wave of mixed W, bucket and G: one launch for every GROUP_CAP
    batches, each batch's rows equal to its plain version's."""
    n = GROUP_CAP + 1 if n == "cap + 1" else n
    rng = np.random.default_rng(7 + n)
    batches = [_segment_batch(rng, (1, 2, 4)[k % 3], (1, 2, 16, 32, 64, 1024, 1 << 14)[k % 7],
                              (1, 3, 32)[k % 3], cuda) for k in range(n)]
    before = gather_segment_totals_cuda.launches
    got = ops.popcount_and_gather_segment_groups(batches)
    want = gather_segment_groups_reference(batches)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())
    assert gather_segment_totals_cuda.launches - before == -(-n // GROUP_CAP)


def test_wave_out_of_range_raises_at_its_batch_only_on_card(cuda):
    from repro_torch.core import MultiGraphExecutor

    job_lists = []
    for k in range(4):
        jobs = []
        for i in range(1 + 2 * k):
            g = build_graph(rmat(64 << (k % 2), 6 * (64 << (k % 2)), seed=100 * k + i))
            sb = build_sbf(g, (32, 64, 128)[k % 3])
            jobs.append((sb, build_worklist(g, sb)))
        job_lists.append(jobs)
    multi = MultiGraphExecutor()
    want = [MultiGraphExecutor(device="cpu").count_fused(jobs) for jobs in job_lists]
    batches = [multi.prepare(jobs) for jobs in job_lists]
    ridx = batches[1].ridx
    ridx[int(torch.nonzero(ridx >= 0)[0])] = batches[1].row_data.shape[0] + 3
    before = gather_segment_totals_cuda.launches
    futures = multi.dispatch(batches)
    assert gather_segment_totals_cuda.launches - before == 1
    with pytest.raises(ValueError, match="past the end"):
        futures[1].result()
    assert [futures[k].result() for k in (0, 2, 3)] == [want[0], want[2], want[3]]


@pytest.mark.parametrize("p", [1, 2, 3, 5, 1 << 20])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 2), (0, 1)])
def test_gather_total_at_index_offsets_on_card(cuda, p, offsets):
    """Index views at any element offset, the two sides alike or not, and P
    that is no multiple of four: equal to the plain version, nothing read
    past P (the arrays hold three more pairs)."""
    rng = np.random.default_rng(p + 10 * offsets[0] + offsets[1])
    row, col = _words(rng, 5000, 2, cuda), _words(rng, 3001, 2, cuda)
    r = torch.from_numpy(rng.integers(-1, 5000, size=p + 3).astype(np.int32)).to(cuda)
    c = torch.from_numpy(rng.integers(-1, 3001, size=p + 3).astype(np.int32)).to(cuda)
    ridx, cidx = r[offsets[0] : offsets[0] + p], c[offsets[1] : offsets[1] + p]
    got = gather_total_cuda(row, col, ridx, cidx, torch.zeros(2, dtype=torch.int32, device=cuda))
    want = gather_total_reference(row, col, ridx, cidx)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())


def test_bound_launcher_on_card(cuda):
    """The executor's launcher: bound once, it adds each chunk into out,
    counts each launch, and refuses index tensors the kernel cannot take."""
    rng = np.random.default_rng(5)
    row, col = _words(rng, 5000, 4, cuda), _words(rng, 3001, 4, cuda)
    out = torch.zeros(2, dtype=torch.int32, device=cuda)
    want = torch.zeros(2, dtype=torch.int32)
    before = gather_total_cuda.launches
    with torch.cuda.device(cuda):
        launch = GatherTotalLauncher(row, col).bind(out)
        for p in (1000, 0, 1 << 16):
            r = torch.from_numpy(rng.integers(-1, 5000, size=p).astype(np.int32)).to(cuda)
            c = torch.from_numpy(rng.integers(-1, 3001, size=p).astype(np.int32)).to(cuda)
            launch(r, c)
            want += gather_total_reference(row, col, r, c).cpu()
        with pytest.raises(TypeError):
            launch(r.long(), c.long())
        with pytest.raises(ValueError):
            launch(r.cpu(), c.cpu())
        with pytest.raises(ValueError):
            launch(r[::2], c[::2])
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), want)
    assert gather_total_cuda.launches - before == 2


# ---------------------------------------------------------------------------
# Streaming on the card: in-place store edits behind an unresolved count
# ---------------------------------------------------------------------------


def _stall(cycles: int = 1_000_000_000) -> None:
    """Hold the current stream for ``cycles`` clocks (a few hundred ms), so
    that what is enqueued next waits behind it."""
    torch.cuda._sleep(cycles)


def test_update_stores_behind_unresolved_before_count_on_card(cuda):
    """The in-place edit is ordered after a before-count still in flight:
    that count reads the pre-update words, the next one the post-update
    words (both equal to the CPU path's), the launcher is the one bound at
    construction, and no store byte travels."""
    from repro_torch.core import update_sbf

    g = build_graph(rmat(20000, 150000, seed=11), reorder=True)
    sb = build_sbf(g, 64)
    wl = build_worklist(g, sb)
    rm = g.edges[np.random.default_rng(0).choice(g.m, 3000, replace=False)]
    upd = update_sbf(sb, None, rm)
    assert not upd.grew
    ex, cpu = Executor(sb), Executor(sb, device="cpu")
    launcher, stores = ex._launcher, ex.store_upload_bytes
    want_before = cpu.count(wl)
    cpu.update_stores(upd.row_lanes, upd.col_lanes)
    want_after = cpu.count(wl)
    assert want_before != want_after
    # Warm: the kernel's library loads (and may build) on its first launch,
    # which must not happen while the stall below holds the stream.
    assert ex.count(wl) == want_before
    with torch.cuda.device(cuda):
        _stall()
        fut_before = ex.count_async(wl)
        done = torch.cuda.Event()
        done.record()
        ex.update_stores(upd.row_lanes, upd.col_lanes)
        pending_at_edit = not done.query()
        fut_after = ex.count_async(wl)
    assert pending_at_edit  # the edit was enqueued behind the unresolved count
    assert fut_before.result() == want_before and fut_after.result() == want_after
    assert ex._launcher is launcher and ex.adopts == 0 and ex.store_upload_bytes == stores


def test_adopt_stores_rebuilds_launcher_on_card(cuda):
    """A growth batch re-adopts the stores behind an unresolved count: the
    old count still reads the old stores, the launcher is rebuilt over the
    new ones, and the count after equals the CPU path's and the oracle's."""
    from repro_torch.core import update_sbf

    g = build_graph(rmat(20000, 150000, seed=12), reorder=True)
    order = np.random.default_rng(1).permutation(g.m)
    base, hold = g.edges[np.sort(order[2000:])], g.edges[np.sort(order[:2000])]
    gb = build_graph(base, n=g.n, reorder=False)
    sb = build_sbf(gb, 64)
    upd = update_sbf(sb, hold, None)
    assert upd.grew
    wl_old = build_worklist(gb, sb)
    wl_new = build_worklist(g, upd.sbf)
    ex = Executor(sb)
    old = ex._launcher
    assert ex.count(wl_old) == triangles_intersection(gb)  # warm, as above
    with torch.cuda.device(cuda):
        _stall()
        fut_old = ex.count_async(wl_old)
        done = torch.cuda.Event()
        done.record()
        pending_at_adopt = not done.query()
        # The stores' upload is a blocking copy: it waits for the stream,
        # so the old count has finished before the new stores are written.
        ex.adopt_stores(upd.sbf)
        fut_new = ex.count_async(wl_new)
    assert pending_at_adopt  # adopt_stores was called while the old count was queued
    assert ex._launcher is not old and ex.adopts == 1
    assert ex._launcher._prefix[0] == ex.row_data.data_ptr()
    assert ex._launcher._prefix[2] == ex.col_data.data_ptr()
    assert fut_old.result() == triangles_intersection(gb)
    assert fut_new.result() == triangles_intersection(g) == Executor(
        upd.sbf, device="cpu").count(wl_new)


def test_streaming_on_card_matches_cpu_path(cuda):
    """20 mixed add/remove batches on the card (device delta work lists, the
    fused kernel) and on the CPU path: every DeltaResult field but the clock
    equal, counts equal to the oracle, no 'auto' fallback, and steady
    batches build no kernel library and upload no store bytes."""
    import dataclasses

    from repro_torch.core import StreamingTCState
    from repro_torch.kernels import _build

    g = build_graph(rmat(20000, 150000, seed=13), reorder=True)
    rng = np.random.default_rng(2)
    order = rng.permutation(g.m)
    cut = int(0.9 * g.m)
    card = StreamingTCState(g.edges[order[:cut]], n=g.n)
    cpu = StreamingTCState(g.edges[order[:cut]], n=g.n, device="cpu")
    assert card._use_device_build and card.triangles == cpu.triangles
    fields = [f.name for f in dataclasses.fields(card.apply_batch()) if f.name != "timings_s"]
    absent = {tuple(e) for e in g.edges[order[cut:]].tolist()}
    libs = None
    for i in range(20):
        cur = card.current_edges()
        rm = cur[rng.choice(len(cur), 300, replace=False)]
        pool = np.array(sorted(absent), dtype=np.int64)
        ad = pool[rng.choice(len(pool), 300, replace=False)]
        absent.difference_update(map(tuple, ad.tolist()))
        absent.update(map(tuple, rm.tolist()))
        before = gather_total_cuda.launches
        stores = card.executor.store_upload_bytes
        rc = card.apply_batch(added=ad, removed=rm)
        rp = cpu.apply_batch(added=ad, removed=rm)
        assert [getattr(rc, f) for f in fields] == [getattr(rp, f) for f in fields], i
        assert gather_total_cuda.launches > before
        if not rc.grew:
            assert card.executor.store_upload_bytes == stores
        if i == 0:
            libs = len(_build._LIBS)
        assert len(_build._LIBS) == libs
    assert card.fallbacks == 0 and card.index_upload_bytes > 0
    assert card.triangles == triangles_intersection(
        build_graph(card.current_edges(), n=g.n, reorder=False)) == card.verify()


def test_server_restore_on_card(tmp_path, cuda):
    """A durable server on the card, abandoned with pending deltas, restores
    on the card and on the CPU to the same counts and counters, and draining
    reaches the counts of a server that was never killed."""
    import itertools
    import shutil

    from repro_torch.launch import ServeConfig, TCServer

    n = 60
    pool = np.array(list(itertools.combinations(range(n), 2)), dtype=np.int64)
    np.random.default_rng(3).shuffle(pool)
    deltas = [pool[400 + 40 * i: 440 + 40 * i] for i in range(10)]

    def fresh(root=None):
        srv = TCServer(ServeConfig(wal_dir=root, checkpoint_every=3))
        return srv, [srv.create_stream(pool[:400], n=n), srv.create_stream(pool[800:1200], n=n)]

    srv, sids = fresh(str(tmp_path / "root"))
    for i, d in enumerate(deltas):
        srv.submit_delta(sids[i % 2], added=d)
        if i == 5:
            srv.drain()
    for entry in srv._streams.values():
        entry.wal.snaps.wait()
    del srv
    twin, tsids = fresh()
    for i, d in enumerate(deltas):
        twin.submit_delta(tsids[i % 2], added=d)
    twin.drain()
    got = {}
    for device in ("cuda", "cpu"):
        root = tmp_path / device
        shutil.copytree(tmp_path / "root", root)
        srv = TCServer.restore(root, device=device)
        assert srv.pending == 4
        assert all(r.status == "ok" for r in srv.drain())
        got[device] = ({s: srv.stream_count(s) for s in sids}, srv.server_stats())
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][0] == {s: twin.stream_count(t) for s, t in zip(sids, tsids)}


@pytest.mark.parametrize("placement", ["replicated", "sharded_cols", "sharded_2d"])
def test_sharded_counts_on_card(cuda, placement):
    """Every placement on a mesh of logical shards on the card (4 x
    cuda:0), multi-step: exact, the sharded executors launching the kernel
    once per shard with real pairs a step, with no host sync before
    result()."""
    from repro_torch.core import DeviceTopology, plan_execution
    from repro_torch.distributed import (
        Sharded2DExecutor,
        ShardedColsExecutor,
        clear_sharded_executor_cache,
        distributed_tc_count,
        make_mesh,
    )
    from repro_torch.distributed.tc import step_launches

    g = build_graph(rmat(3000, 18000, seed=5), reorder=True)
    sb = build_sbf(g, 64)
    wl = build_worklist(g, sb)
    want = triangles_intersection(g)
    dev = [torch.device("cuda", 0)] * 4
    mesh = make_mesh((2, 2), ("r", "c"), devices=dev) if placement == "sharded_2d" else \
        make_mesh((4,), ("d",), devices=dev)
    for schedule in ("packed", "lockstep"):
        assert distributed_tc_count(sb, wl, mesh, placement=placement, max_step_pairs=4096,
                                    schedule=schedule) == want
    clear_sharded_executor_cache()
    if placement == "replicated":
        return
    if placement == "sharded_cols":
        ex = ShardedColsExecutor(sb, mesh, chunk_pairs=4096)
        plan = ex._plan(wl)
    else:
        plan = plan_execution(sb, wl, DeviceTopology(num_devices=4), placement="sharded_2d",
                              grid=(2, 2), chunk_pairs=4096)
        ex = Sharded2DExecutor(sb, mesh, plan, chunk_pairs=4096)
    sched = ex.stripe_schedule(plan)
    assert sched.num_steps > 1
    before = gather_total_cuda.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fut = ex.count_plan_async(plan)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fut.result() == want
    assert gather_total_cuda.launches - before == ex.launches == step_launches(sched)


def test_resilient_and_stream_on_card(tmp_path, cuda):
    """A resilient count on a 2 x 2 mesh of logical shards on the card
    losing a device, its resume, and a mesh= stream: exact."""
    from repro_torch.core import StreamingTCState
    from repro_torch.distributed import ResilienceConfig, make_mesh, resilient_tc_count, resume_tc_count
    from repro_torch.runtime import FailureInjector

    g = build_graph(rmat(3000, 18000, seed=5), reorder=True)
    sb = build_sbf(g, 64)
    wl = build_worklist(g, sb)
    want = triangles_intersection(g)
    mesh = make_mesh((2, 2), ("r", "c"), devices=[torch.device("cuda", 0)] * 4)
    cfg = ResilienceConfig(checkpoint_dir=tmp_path, checkpoint_every=2,
                           injector=FailureInjector(fail_at_steps=(3,)), lose_devices=1)
    total, info = resilient_tc_count(sb, wl, mesh, cfg, chunk_pairs=1024)
    assert total == want and info["grid"] == [3, 1] and info["steps_replayed"] <= 2
    assert resume_tc_count(tmp_path, mesh)[0] == want
    order = np.random.default_rng(0).permutation(g.m)
    base, hold = g.edges[order[200:]], g.edges[order[:200]]
    state = StreamingTCState(base, n=g.n, mesh=mesh)
    assert state.device.type == "cuda"
    for kw in ({"added": hold}, {"removed": hold[:100]}):
        assert state.apply_batch(**kw).triangles == state.verify()


# ------------------------------------------------------------ the LM families

FAMILY_ARCHS = ("minicpm3-4b", "dbrx-132b", "moonshot-v1-16b-a3b", "mamba2-780m", "zamba2-7b",
                "llama-3.2-vision-90b", "hubert-xlarge")


def _family_batch(cfg, b, s, seed, device):
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        batch = {"frames": rng.normal(size=(b, s, cfg.d_frontend)).astype(np.float32),
                 "labels": rng.integers(0, cfg.vocab, (b, s)), "mask": rng.random((b, s)) < 0.3}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)),
                 "labels": rng.integers(0, cfg.vocab, (b, s))}
        if cfg.family == "vlm":
            batch["image_embeds"] = rng.normal(
                size=(b, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _family_params(cfg, device):
    from repro_torch.models.model import init_model

    params = init_model(0, cfg, device)
    if "cross_layers" in params:  # let the image tokens count (init's gate mutes them)
        params["cross_layers"]["xattn"]["gate"].fill_(0.5)
    return params


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_loss_and_grads_on_card_match_cpu(cuda, arch):
    """float32 smoke config (TF32 off): logits within 1e-4 relative norm,
    the loss, its metrics and every gradient leaf within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.params import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = loss_and_grads(_family_params(cfg, dev), _family_batch(cfg, 2, 16, 1, dev), cfg)
    (lg, mg, gg), (lc, mc, gc) = out["cuda"], out["cpu"]
    assert lg.is_cuda and sorted(mg) == sorted(mc)
    for k in mc:
        np.testing.assert_allclose(float(mg[k]), float(mc[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for g, w in zip(tree_leaves(gg), tree_leaves(gc)):
        assert g.is_cuda and _rel_l2(g, w) <= 1e-4


@pytest.mark.parametrize("arch,impl", [(a, "xla") for a in FAMILY_ARCHS[:-1]]
                         + [(a, "flash") for a in ("dbrx-132b", "moonshot-v1-16b-a3b",
                                                    "zamba2-7b", "llama-3.2-vision-90b")])
def test_family_serving_on_card_matches_cpu(cuda, arch, impl):
    """float32 ServeSession on the card and on the CPU: equal tokens, logits
    within 1e-4; flash launches one a prefill attention layer (the vlm's
    cross layers and the hybrid's shared block applications included),
    none at decode."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models.model import hybrid_counts, vlm_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (2, 24), dtype=np.int32)
    img = None
    if cfg.family == "vlm":
        img = np.random.default_rng(3).normal(size=(2, cfg.n_image_tokens, cfg.d_frontend))
        img = img.astype(np.float32)
    if cfg.family == "vlm":
        n_groups, self_per, n_cross = vlm_counts(cfg)
        want = n_groups * self_per + n_cross
    else:
        want = hybrid_counts(cfg)[0] if cfg.family == "hybrid" else cfg.n_layers
    runs, launched = {}, {}
    for dev in ("cuda", "cpu"):
        sess = ServeSession(arch, smoke=True, batch=2, max_seq=32, device=dev, attention_impl=impl,
                            dtype="float32", params=_family_params(cfg, dev))
        before = flash_attention_cuda.launches
        runs[dev] = sess.generate(prompts, 6, image_embeds=img, keep_logits=True)
        launched[dev] = flash_attention_cuda.launches - before
    assert launched == {"cuda": want if impl == "flash" else 0, "cpu": 0}
    np.testing.assert_array_equal(runs["cuda"][0], runs["cpu"][0])
    np.testing.assert_allclose(runs["cuda"][1]["logits"], runs["cpu"][1]["logits"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_routing_on_card_matches_cpu(cuda, capacity_factor):
    """float32 (TF32 off): the same experts, the same drops, y within 1e-5."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.models.params import init_params, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("moonshot-v1-16b-a3b")
    if capacity_factor:
        cfg = cfg.scaled(moe_capacity_factor=capacity_factor)
    host = init_params(torch.Generator().manual_seed(0), moe.moe_schema(cfg), torch.float32)
    card = tree_map(lambda t: t.to(cuda), host)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 64, cfg.d_model)).astype(np.float32))
    yg, ag = moe.moe_forward(card, x.to(cuda), cfg, group_size=128)
    yc, ac = moe.moe_forward(host, x, cfg, group_size=128)
    assert torch.equal(moe.route(card, x.to(cuda), cfg, 128)[3].cpu(), moe.route(host, x, cfg, 128)[3])
    assert float(ag["moe_dropped_frac"]) == float(ac["moe_dropped_frac"])
    assert (float(ac["moe_dropped_frac"]) > 0) == bool(capacity_factor)
    np.testing.assert_allclose(yg.cpu().numpy(), yc.numpy(), rtol=1e-5, atol=1e-5)


def test_ssd_chunked_on_card_matches_cpu_at_full_chunk(cuda):
    """Chunk 256 with ``a`` down to -16 (zamba2's widths): finite and within
    1e-4 of the CPU, the gradient finite."""
    from repro_torch.models.ssm import ssd_chunked

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    b, length, h, p, n = 2, 512, 8, 64, 64
    x, bm, cm = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for shape in ((b, length, h, p), (b, length, h, n), (b, length, h, n)))
    dt = torch.from_numpy(rng.uniform(1e-3, 0.1, size=(b, length, h)).astype(np.float32))
    a = -torch.linspace(1.0, 16.0, h)
    want = ssd_chunked(x, dt, a, bm, cm, 256)
    xs = x.to(cuda).requires_grad_()
    got = ssd_chunked(xs, dt.to(cuda), a.to(cuda), bm.to(cuda), cm.to(cuda), 256)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and _rel_l2(g.detach(), w) <= 1e-4
    got[0].square().sum().backward()
    assert torch.isfinite(xs.grad).all()


@pytest.mark.parametrize("hd", [80, 112])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_takes_hubert_and_zamba2_heads_on_card(cuda, hd, causal):
    """hubert's 80 (not causal) and zamba2's 112 (causal): the model's entry
    launches the kernel once and equals the plain version."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bshd,
        flash_attention_bshd_reference,
        flash_attention_cuda,
    )

    gen = torch.Generator(device=cuda).manual_seed(hd)
    q, k, v = (torch.randn(2, 200, 4, hd, generator=gen, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    pos = torch.arange(200, dtype=torch.int32, device=cuda)[None].expand(2, 200)
    before = flash_attention_cuda.launches
    got = flash_attention_bshd(q, k, v, pos, pos, causal=causal)
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention_bshd_reference(q, k, v, pos, pos, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("hd", [80, 112])
@pytest.mark.parametrize("case", ["family", "ragged", "one", "offset", "keys_after_queries"])
def test_flash_exact_width_cases_on_card(cuda, hd, case):
    """The exact-width plan (hd 80: 64 + 16 columns, 112: 64 + 32 + 16) at
    the families' shapes (zamba2: B 4 x 512, H 32, causal; hubert: H 16,
    not causal), ragged 517 x 1030, 1 x 1, offset queries and keys after
    every query (each row blind: the rescan): one launch, within 2e-2 of
    the plain version, its scored tiles equal to the skip rule's."""
    from repro_torch.kernels.flash_attention import (
        FLASH_TILES,
        flash_attention_bshd_cuda,
        flash_attention_bshd_reference,
        flash_attention_cuda,
        flash_tiles_scored,
    )

    b, sq, sk, h, kh = {"family": (4, 512, 512, 32 if hd == 112 else 16, 32 if hd == 112 else 16),
                        "ragged": (2, 517, 1030, 4, 2), "one": (3, 1, 1, 2, 1),
                        "offset": (2, 100, 300, 4, 4), "keys_after_queries": (2, 300, 260, 9, 3)}[case]
    causal = hd == 112 or case != "family"
    gen = torch.Generator(device=cuda).manual_seed(hd + len(case))
    q = torch.randn(b, sq, h, hd, generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(b, sk, kh, hd, generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    start = sk - sq if case == "offset" else 0
    qp = torch.arange(start, start + sq, dtype=torch.int32, device=cuda)[None].expand(b, sq)
    kp = torch.arange(sk, dtype=torch.int32, device=cuda)[None].expand(b, sk)
    if case == "keys_after_queries":
        kp = kp + sq
    tiles = torch.zeros(1, dtype=torch.int64, device=cuda)
    before = flash_attention_cuda.launches
    got = flash_attention_bshd_cuda(q, k, v, qp, kp, causal=causal, tiles=tiles)
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention_bshd_reference(q, k, v, qp, kp, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert int(tiles) == flash_tiles_scored(qp, kp, h, *FLASH_TILES[torch.bfloat16], causal=causal)


@pytest.mark.parametrize("hd,vd", [(96, 96), (96, 64), (128, 64)])
def test_flash_refuses_unsupported_heads_on_card(cuda, hd, vd):
    from repro_torch.kernels.flash_attention import flash_attention_bshd, flash_attention_cuda

    q = torch.randn(1, 8, 2, hd, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(1, 8, 2, hd, device=cuda, dtype=torch.bfloat16)
    v = torch.randn(1, 8, 2, vd, device=cuda, dtype=torch.bfloat16)
    pos = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bshd(q, k, v, pos, pos)
    assert flash_attention_cuda.launches == before


def test_kv_quant_on_card_matches_cpu(cuda):
    from repro_torch.distributed.kv_quant import kv_dequantize, kv_quantize

    kv = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 64, 4, 32)).astype(np.float32))
    qc, sc = kv_quantize(kv)
    qg, sg = kv_quantize(kv.to(cuda))
    assert torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)
    assert torch.equal(kv_dequantize(qg, sg).cpu(), kv_dequantize(qc, sc))


# ------------------------------------------------------- sharded training


def _card_mesh(data, model):
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(data, model, devices=[torch.device("cuda", 0)] * (data * model))


@pytest.mark.parametrize("arch,shape", [("smollm-135m", (2, 2)), ("smollm-135m", (4, 1)),
                                        ("minicpm3-4b", (2, 2)), ("hubert-xlarge", (2, 2))])
def test_sharded_grads_on_card_match_one_device(cuda, arch, shape):
    """Float32 (TF32 off): the sharded step's reduced gradient blocks on
    logical shards of the card within 1e-5 relative L2 a leaf of
    ``loss_and_grads`` on the card, and the step makes no host sync."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.distributed.lm_sharding import batch_spec_tree, named_tree, train_state_specs
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.launch.steps import loss_and_grads, make_train_step, sharded_loss_and_grads
    from repro_torch.models.model import init_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    mesh = _card_mesh(*shape)
    params = init_model(0, cfg, "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=32, global_batch=8, seed=2, family=cfg.family,
        d_frontend=cfg.d_frontend).batch(0).items()}
    loss, _, grads = loss_and_grads(params, batch, cfg)
    pspecs, ospecs, gspecs = train_state_specs(cfg)
    pp = place_tree(params, named_tree(mesh, pspecs))
    bp = place_tree(batch, named_tree(mesh, batch_spec_tree(cfg, mesh, batch)))
    s_loss, _, s_grads = sharded_loss_and_grads(pp, bp, cfg, named_tree(mesh, gspecs))
    assert s_loss.is_cuda and abs(float(s_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    for g, w in zip(tree_leaves(s_grads), tree_leaves(grads)):
        assert all(t.is_cuda for t in g.blocks.values())
        assert _rel_l2(g.full(), w) <= 1e-5
    step = make_train_step(cfg, mesh=mesh, batch_sds=batch)
    po = place_tree(adamw_init(params), named_tree(mesh, ospecs))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, metrics = step(pp, po, bp)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert metrics["loss"].is_cuda and np.isfinite(float(metrics["loss"]))


def test_sharded_train_loop_on_card_matches_one_device(cuda):
    """The reference's sharded-vs-single case on the card: qwen1.5-110b
    smoke, bf16, 4 x 32, 5 steps, the 2 x 2 loop's last loss within 5e-3."""
    from repro_torch.launch.train import TrainLoop
    from repro_torch.optim import AdamWConfig

    last = {}
    for label, mesh in (("2x2", _card_mesh(2, 2)), ("one", None)):
        loop = TrainLoop("qwen1.5-110b", smoke=True, global_batch=4, seq=32, mesh=mesh,
                         opt=AdamWConfig(lr=1e-3, weight_decay=0.0))
        loop.run(5, log_every=5)
        last[label] = loop.metrics_log[-1]["loss"]
    assert abs(last["2x2"] - last["one"]) < 5e-3, last


def test_elastic_restore_on_card(tmp_path, cuda):
    """A 2 x 2 loop's checkpoint restored onto 4 x 1 logical shards of the
    card: every block on the card and bit-equal to the saved leaf's slice."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch.train import TrainLoop
    from repro_torch.models.params import tree_leaves

    common = dict(smoke=True, global_batch=8, seq=16, ckpt_dir=str(tmp_path), ckpt_every=4)
    TrainLoop("smollm-135m", mesh=_card_mesh(2, 2), **common).run(4, log_every=4)
    loop = TrainLoop("smollm-135m", mesh=_card_mesh(4, 1), **common)
    params, opt, start = loop.restore_or_init()
    assert start == 4
    state = {"params": params, "opt": opt}
    saved, _, _ = load_checkpoint(tmp_path, state, step=4)
    for got, leaf in zip(tree_leaves(state), tree_leaves(saved)):
        leaf = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.asarray(leaf))
        for pos in np.ndindex(4, 1):
            block = got.block(pos)
            sl = got.sharding.block_slices(got.shape, got.sharding.block_index(pos, got.ndim))
            assert block.is_cuda and torch.equal(block.cpu(), leaf[sl])


def test_compressed_psum_mean_on_card(cuda):
    """8 logical 'pod' shards of the card: every entry bit-equal to a NumPy
    emulation (shared amax, int8 half to even, int32 sum) and within 0.02 of
    the exact mean."""
    from repro_torch.distributed.compression import compressed_psum_mean
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.distributed.sharding import NamedSharding, P, place

    mesh = make_mesh((8,), ("pod",), devices=[torch.device("cuda", 0)] * 8)
    g = np.random.default_rng(0).normal(size=(8, 3, 64)).astype(np.float32)
    placed = place(torch.from_numpy(g).cuda(), NamedSharding(mesh, P("pod")))
    got = compressed_psum_mean({"w": placed}, mesh, "pod")["w"].full().cpu().numpy()
    amax = np.float32(np.abs(g).max())
    scale = np.float32(max(amax, np.float32(1e-12))) / np.float32(127.0)
    q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
    want = q.astype(np.int32).sum(0, dtype=np.int32).astype(np.float32) * scale / np.float32(8)
    assert all(got[i].tobytes() == want.tobytes() for i in range(8))
    exact = g.mean(0)
    assert np.abs(got[0] - exact).max() / np.abs(exact).max() < 0.02


@pytest.mark.parametrize("arch,impl", [("smollm-135m", "flash"), ("minicpm3-4b", "xla"),
                                       ("zamba2-7b", "flash"), ("llama-3.2-vision-90b", "flash")])
def test_sharded_serving_on_card_matches_cpu(cuda, arch, impl):
    """``ServeSession(mesh=)`` on 2 x 2 logical shards of the card (float32):
    the greedy tokens and logits of the same session on a CPU mesh, with one
    flash launch an attention layer and prefill shard, none in decode."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models.model import init_model

    cfg = get_smoke_config(arch).scaled(dtype="float32", attention_impl=impl)
    params = init_model(0, cfg, "cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (4, 16), dtype=np.int32)
    img = None
    if cfg.family == "vlm":
        img = rng.normal(size=(4, cfg.n_image_tokens, cfg.d_frontend)).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        mesh = make_mesh((2, 2), ("data", "model"), devices=[torch.device(dev)] * 4)
        sess = ServeSession(arch, smoke=True, batch=4, max_seq=24, mesh=mesh, dtype="float32",
                            attention_impl=impl, params=params)
        before = flash_attention_cuda.launches
        logits, cache = sess.prefill(prompts, img)
        flash = flash_attention_cuda.launches - before
        if dev == "cuda":
            assert cache[next(k for k in cache if k != "ssm")].blocks
            layers = {"smollm-135m": 2, "zamba2-7b": 2, "llama-3.2-vision-90b": 4}.get(arch, 0)
            assert flash == (layers * 4 if impl == "flash" else 0)  # "dp": 4 prefill shards
        before = flash_attention_cuda.launches
        runs[dev] = sess.generate(prompts, 6, image_embeds=img, keep_logits=True)
        assert flash_attention_cuda.launches - before == (flash if dev == "cuda" else 0)
    np.testing.assert_array_equal(runs["cuda"][0], runs["cpu"][0])
    np.testing.assert_allclose(runs["cuda"][1]["logits"], runs["cpu"][1]["logits"],
                               rtol=1e-4, atol=1e-4)
