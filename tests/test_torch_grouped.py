"""Port vs reference: the grouped segment-totals dispatch and the bound
gather_total launcher.

A serve wave's fused batches go to the segment kernel together: one launch
for every ``GROUP_CAP`` batches, their table (``plan_segment_groups``,
``pack_segment_table``) the kernel's parameter. Its plain version is the
per-batch plain versions concatenated; here it is held, batch by batch, to
the JAX package's ``gather_segment_totals_pallas`` in interpret mode and its
jnp mirror on the same numpy inputs, exactly. The table's layout is plain
Python and is checked here without a library or a card; the CUDA kernels
run only on a card (tests/test_torch_gpu.py and chip_smoke.py).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.kernels.tc_gather_popcount as jx_tgp  # noqa: E402
from repro_torch.core import Executor, build_sbf, build_worklist  # noqa: E402
from repro_torch.graphs import build_graph, rmat  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tc_gather_popcount as pt_tgp  # noqa: E402

THREADS = 256  # the segment kernel's block: one pair a thread


def _words(rng, rows, w):
    return rng.integers(0, 2**32, size=(rows, w), dtype=np.uint64).astype(np.uint32)


def _as_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _wave(seed: int, n: int):
    """``n`` batches of mixed W 1/2/4, buckets 1/16/1024 and G 1-3, in-range
    indices and -1 only, all-sentinel trailing segments; numpy arrays."""
    rng = np.random.default_rng(seed)
    batches = []
    for k in range(n):
        w, bucket, g = (1, 2, 4)[k % 3], (1, 16, 1024)[(k + seed) % 3], 1 + (k % 3)
        rows, cols = int(rng.integers(5, 200)), int(rng.integers(5, 120))
        row, col = _words(rng, rows, w), _words(rng, cols, w)
        p = g * bucket
        ridx = rng.integers(0, rows, size=p).astype(np.int32)
        cidx = rng.integers(0, cols, size=p).astype(np.int32)
        ridx[rng.random(p) < 0.15] = -1
        cidx[rng.random(p) < 0.15] = -1
        ridx[: p // 4] = 2  # a hot row
        if g > 1:
            ridx[-bucket:] = -1
            cidx[-bucket:] = -1
        batches.append((row, col, ridx, cidx, bucket))
    return batches


def _port(batches):
    return [(_as_torch(r), _as_torch(c), torch.from_numpy(ri), torch.from_numpy(ci), b)
            for r, c, ri, ci, b in batches]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouped_plain_matches_pallas_batch_by_batch(seed):
    """Grouped plain == ops wrapper's CPU path == per batch: Pallas kernel
    (interpret) == jnp mirror, exactly, at each batch's offset."""
    batches = _wave(seed, 7)
    port = _port(batches)
    got = pt_tgp.gather_segment_groups_reference(port)
    assert got.dtype == torch.int32
    assert torch.equal(ops.popcount_and_gather_segment_groups(port), got)
    offsets = np.cumsum([0] + [len(b[2]) // b[4] for b in batches])
    assert got.shape == (offsets[-1], 2)
    assert got[:, 1].tolist() == [0] * offsets[-1]
    for k, (row, col, ridx, cidx, bucket) in enumerate(batches):
        args = (jnp.asarray(row), jnp.asarray(col), jnp.asarray(ridx), jnp.asarray(cidx))
        kernel = np.asarray(jx_tgp.gather_segment_totals_pallas(*args, bucket=bucket,
                                                                interpret=True))
        mirror = np.asarray(jx_tgp.gather_segment_totals_reference(*args, bucket=bucket))
        rows = got[offsets[k] : offsets[k + 1], 0].numpy()
        assert np.array_equal(rows, kernel) and np.array_equal(kernel, mirror), k


def test_grouped_guards_raise():
    """The grouped entry makes each batch's checks: no batches, pairs that
    do not tile, a segment past the int32 bound."""
    with pytest.raises(ValueError, match="at least one"):
        ops.popcount_and_gather_segment_groups([])
    ok, bad = _port(_wave(3, 2))
    with pytest.raises(ValueError, match="tile"):
        ops.popcount_and_gather_segment_groups([ok, (*bad[:4], bad[4] * 2 + 1)])
    s = torch.empty(8, 4, dtype=torch.int32, device="meta")
    bucket = 1 << (ops.INT32_SAFE_WORDS // 4).bit_length()
    big = torch.empty(bucket, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="overflow"):
        ops.popcount_and_gather_segment_groups([(s, s, big, big, bucket)])


@pytest.mark.parametrize("cap", [pt_tgp.GROUP_CAP, 4])
def test_plan_segment_groups_blocks_rows_and_cap(cap):
    """First blocks (ceil(P / 256) a batch, none for an empty one), first
    output rows (G a batch, in wave order) and a wave of cap + 1 batches cut
    into two launches, the second continuing the rows."""
    rng = np.random.default_rng(cap)
    shapes = [(0, 64)]
    while len(shapes) < cap + 1:
        bucket = 1 << int(rng.integers(0, 15))
        shapes.append((bucket * int(rng.integers(0, 33)), bucket))
    groups = pt_tgp.plan_segment_groups(shapes, cap=cap)
    assert [(g.start, g.stop) for g in groups] == [(0, cap), (cap, cap + 1)]
    row = 0
    for g in groups:
        assert g.out_row[0] == row and g.first_block[0] == 0
        for k, (pairs, bucket) in enumerate(shapes[g.start : g.stop]):
            assert g.first_block[k + 1] - g.first_block[k] == -(-pairs // THREADS)
            assert g.out_row[k + 1] - g.out_row[k] == pairs // bucket
        row = g.out_row[-1]
    assert row == sum(p // b for p, b in shapes)
    assert groups[0].first_block[1] == 0  # the empty batch owns no block
    assert pt_tgp.plan_segment_groups([]) == []


def test_pack_segment_table_layout():
    """One launch's parameter: entry fields, output rows relative to the
    launch's first row, log2 of the bucket, the first-block column and the
    count; the record is the C struct's 8,712 bytes."""
    shapes = [(3 * 1024, 1024), (0, 16), (16 * 5, 16), (257, 1)]
    (first, second) = pt_tgp.plan_segment_groups(shapes, cap=2)
    entries = [(1000 + k, 2000 + k, 3000 + k, 4000 + k, pairs, 10 + k, 20 + k, (1, 2, 4, 1)[k],
                bucket) for k, (pairs, bucket) in enumerate(shapes)]
    t = pt_tgp.pack_segment_table(second, entries[2:])
    assert t.nbytes == 8712 and int(t["count"]) == 2
    assert t["first_block"][:3].tolist() == [0, 1, 3]
    assert t["first_block"][3:].tolist() == [0] * (pt_tgp.GROUP_CAP - 2)
    e = t["e"]
    assert e["out_row"][:2].tolist() == [0, 5]  # rows 3 .. of the wave, relative
    assert e["log2_bucket"][:2].tolist() == [4, 0]
    assert e["num_pairs"][:2].tolist() == [80, 257]
    assert e["row"][:2].tolist() == [1002, 1003] and e["cidx"][:2].tolist() == [4002, 4003]
    assert e["words"][:2].tolist() == [4, 1] and e["num_cols"][:2].tolist() == [22, 23]
    assert not e["num_pairs"][2:].any() and not e["row"][2:].any()  # unused entries
    assert second.out_row == (3, 8, 265)
    t0 = pt_tgp.pack_segment_table(first, entries[:2])
    assert t0["first_block"][:3].tolist() == [0, 12, 12]
    with pytest.raises(ValueError, match="entries"):
        pt_tgp.pack_segment_table(first, entries[:3])


def test_cuda_entries_refuse_host_tensors():
    """No fallback: the table, the bound launcher and the one-batch wrapper
    raise on host tensors (and on int64 stores) before any launch is
    counted."""
    (batch,) = _port(_wave(4, 1))
    before = (pt_tgp.gather_segment_totals_cuda.launches, pt_tgp.gather_total_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pt_tgp.SegmentTable([batch])
    with pytest.raises(ValueError, match="CUDA tensor"):
        pt_tgp.gather_segment_totals_cuda(*batch[:4], torch.zeros(1, 2, dtype=torch.int32),
                                          bucket=batch[4])
    row, col = batch[0], batch[1]
    for stores in ((row, col), (row.long(), col.long())):
        with pytest.raises((ValueError, TypeError)):
            pt_tgp.GatherTotalLauncher(*stores)
    assert before == (pt_tgp.gather_segment_totals_cuda.launches,
                      pt_tgp.gather_total_cuda.launches)


def test_cpu_executor_takes_the_plain_path():
    """On the host the executor builds no kernel launcher and counts through
    the plain version, in every mode, to the same total."""
    g = build_graph(rmat(300, 2000, seed=5), reorder=True)
    sb = build_sbf(g, 64)
    wl = build_worklist(g, sb)
    counts = set()
    for mode in ("fused", "gather_then_kernel", "jnp"):
        ex = Executor(sb, mode=mode, chunk_pairs=256, device="cpu")
        assert ex._launcher is None
        counts.add(ex.count(wl))
    assert len(counts) == 1
