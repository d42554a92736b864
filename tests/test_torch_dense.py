"""Port vs reference: the dense backends and the analytics on the counts.

The port's ``ops.bitgemm`` and ``ops.dense_mxu_tc`` (their plain versions
here on the CPU) are held against the JAX package's Pallas kernels
``bitgemm_pallas`` and ``dense_mxu_tc_pallas`` in interpret mode, and
against both packages' oracles, on the same numpy inputs;
``repro_torch.core.tcim_count(..., backend="bitgemm" | "mxu", device="cpu")``
against ``repro.core.tcim_count`` and the exact oracle on every
``configs/tcim_graphs.py`` config cut to at most 512 vertices (the JAX
interpreter's dense kernels stay fast there); ``metrics``, ``baselines``,
``cachesim`` and ``energymodel`` against the reference's on the same
graphs. Counts and popcounts are integers, so those comparisons are exact
equality; the clustering floats and the latency/energy model agree within
1e-12 relative, as NumPy computes them the same way in both. The CUDA
kernels themselves run only on a card (tests/test_torch_gpu.py and
chip_smoke.py).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jx_core  # noqa: E402
import repro.core.baselines as jx_baselines  # noqa: E402
import repro.core.metrics as jx_metrics  # noqa: E402
import repro.kernels.ops as jx_ops  # noqa: E402
import repro.kernels.ref as jx_ref  # noqa: E402
from repro.configs.tcim_graphs import GRAPHS  # noqa: E402
from repro.core.bitmat import bitpack_matrix  # noqa: E402
from repro.graphs import GRAPH_GENERATORS  # noqa: E402
from repro.graphs import build_graph as jx_build_graph  # noqa: E402
from repro.graphs.exact import triangles_intersection  # noqa: E402

import repro_torch.core as pt_core  # noqa: E402
from repro_torch.core import baselines as pt_baselines  # noqa: E402
from repro_torch.core import metrics as pt_metrics  # noqa: E402
from repro_torch.core.tcim import _pack_words  # noqa: E402
from repro_torch.graphs import build_graph as pt_build_graph  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import tc_bitgemm as pt_bitgemm  # noqa: E402
from repro_torch.kernels import tc_dense_mxu as pt_dense  # noqa: E402

DENSE = ("bitgemm", "mxu")
MAX_N = 480  # every config cut to at most 512 vertices (grid_road rounds up to 484)


def _words(rng, rows, w):
    return rng.integers(0, 2**32, size=(rows, w), dtype=np.uint64).astype(np.uint32)


def _as_torch(a: np.ndarray) -> torch.Tensor:
    """uint32 words -> the port's int32 view of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@functools.lru_cache(maxsize=None)
def _edges(name: str) -> np.ndarray:
    cfg = GRAPHS[name].scaled(MAX_N / GRAPHS[name].n)
    gen = GRAPH_GENERATORS[cfg.generator]
    if cfg.generator == "grid_road":
        return gen(cfg.n, seed=cfg.seed)
    return gen(cfg.n, cfg.m, seed=cfg.seed)


@functools.lru_cache(maxsize=None)
def _graphs(name: str):
    """(reference Graph, port Graph) of the reordered config graph."""
    edges = _edges(name)
    return jx_build_graph(edges, reorder=True), pt_build_graph(edges, reorder=True)


@functools.lru_cache(maxsize=None)
def _exact(name: str) -> int:
    return triangles_intersection(_graphs(name)[0])


@functools.lru_cache(maxsize=None)
def _pallas_bitgemm(i, j, w, pattern):
    """Operands of a case and the Pallas kernel's product in interpret mode."""
    rng = np.random.default_rng(i * 1000 + j * 10 + w)
    if pattern == "random":
        x, y = _words(rng, i, w), _words(rng, j, w)
    else:
        fill = 0 if pattern == "zeros" else 0xFFFFFFFF
        x = np.full((i, w), fill, np.uint32)
        y = _words(rng, j, w) if pattern == "zeros" else np.full((j, w), fill, np.uint32)
    want = np.asarray(jx_ops.bitgemm(jnp.asarray(x), jnp.asarray(y), block_i=64, block_j=64, block_w=2))
    return x, y, want


@pytest.mark.parametrize("layout", ["contiguous", "padded"])
@pytest.mark.parametrize(
    "pattern", ["random", "zeros", "ones"],
)
@pytest.mark.parametrize(
    "i,j,w", [(8, 8, 1), (100, 70, 5), (128, 128, 8), (257, 65, 3), (40, 33, 9), (65, 20, 127)]
)
def test_bitgemm_matches_pallas_kernel(i, j, w, pattern, layout):
    """Port plain == Pallas kernel (interpret) == lax.population_count
    oracle == port byte-table oracle, on contiguous operands and on the
    row-padded views the kernel takes as they lie (a padding of all-ones
    words, which must not be read)."""
    x, y, want = _pallas_bitgemm(i, j, w, pattern)
    xt, yt = _as_torch(x), _as_torch(y)
    if layout == "padded":
        xt, yt = pt_bitgemm.padded_view(xt, fill=-1), pt_bitgemm.padded_view(yt, fill=-1)
        assert xt.stride(0) == pt_bitgemm.padded_words(w)
    got = ops.bitgemm(xt, yt)
    assert got.dtype == torch.int32 and tuple(got.shape) == (i, j)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(np.asarray(jx_ref.ref_bitgemm(jnp.asarray(x), jnp.asarray(y))), want)
    assert np.array_equal(ref.ref_bitgemm(xt, yt).numpy(), want)
    if pattern == "ones":
        assert (want == 32 * w).all()


@pytest.mark.parametrize("w", [0, 1, 3, 8, 9, 127])
def test_bitgemm_operand_strides(w):
    """What the wrapper reads as it lies (rows of consecutive words, a row
    stride of whole 16-byte units at least a row long, from a 16-byte
    address) and what it copies once into padded scratch, with the same
    words."""
    rng = np.random.default_rng(w)
    x = _as_torch(_words(rng, 37, w))
    padded = pt_bitgemm.padded_view(x, fill=-1)
    assert padded.stride(0) == pt_bitgemm.padded_words(w) and padded.stride(0) % 8 == 0
    assert pt_bitgemm._taken(padded)
    assert pt_bitgemm._taken(x) == (w % pt_bitgemm.ROW_ALIGN_WORDS == 0)
    before = pt_bitgemm.bitgemm_cuda.padded_copies
    copy = pt_bitgemm._padded_copy(x)
    assert pt_bitgemm.bitgemm_cuda.padded_copies == before + 1
    assert pt_bitgemm._taken(copy) and torch.equal(copy, x)
    assert copy.stride(0) == pt_bitgemm.padded_words(w)
    if w > 1:
        assert not pt_bitgemm._taken(padded[:, 1:])  # starts 4 bytes into its row


def test_bitgemm_plain_chunks_and_empty_dims(monkeypatch):
    """The plain version's row and word chunks add up to the one-shot
    product; empty I or J gives an empty result, W = 0 zeros. The
    reference's Pallas call rejects empty dims (TypeError), so those cases
    are held against the definition, not against it."""
    rng = np.random.default_rng(7)
    x, y = _as_torch(_words(rng, 45, 9)), _as_torch(_words(rng, 33, 9))
    whole = ref.ref_bitgemm(x, y)
    monkeypatch.setattr(pt_bitgemm, "_PLAIN_BUDGET", 33 * 4)  # 1-row, 4-word chunks
    assert torch.equal(pt_bitgemm.bitgemm_reference(x, y), whole)
    assert tuple(ops.bitgemm(x[:0], y).shape) == (0, 33)
    assert tuple(ops.bitgemm(x, y[:0]).shape) == (45, 0)
    zeros = ops.bitgemm(torch.zeros(4, 0, dtype=torch.int32), torch.zeros(5, 0, dtype=torch.int32))
    assert torch.equal(zeros, torch.zeros(4, 5, dtype=torch.int32))
    with pytest.raises(TypeError):
        jx_ops.bitgemm(jnp.zeros((0, 3), jnp.uint32), jnp.zeros((5, 3), jnp.uint32))


@pytest.mark.parametrize("density", [0.02, 0.3])
@pytest.mark.parametrize("n,block", [(64, 32), (128, 64), (96, 32), (256, 128)])
def test_dense_mxu_tc_matches_pallas_kernel(n, block, density):
    """Port plain == Pallas kernel (interpret, bf16/f32) == both oracles,
    for every integer and bool input dtype."""
    rng = np.random.default_rng(n * 10 + block + int(100 * density))
    a = np.triu(rng.random((n, n)) < density, 1)
    want = int(jx_ops.dense_mxu_tc(jnp.asarray(a.astype(np.float32)), block=block))
    assert want == int(jx_ref.ref_dense_tc(jnp.asarray(a.astype(np.float32))))
    for dtype in (torch.bool, torch.int8, torch.int32, torch.int64):
        got = ops.dense_mxu_tc(torch.from_numpy(a).to(dtype))
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == want
    assert int(ref.ref_dense_tc(torch.from_numpy(a))) == want


def test_dense_mxu_tc_full_matrix_and_guards():
    """A full {0,1} matrix (not triangular) computes the same function as
    the reference; empty gives 0 (the reference divides by zero there);
    non-square operands raise."""
    rng = np.random.default_rng(11)
    a = (rng.random((100, 100)) < 0.5).astype(np.float32)
    want = int(jx_ops.dense_mxu_tc(jnp.asarray(a), block=50))
    assert int(ops.dense_mxu_tc(torch.from_numpy(a))) == want
    assert int(ref.ref_dense_tc(torch.from_numpy(a))) == want
    assert int(ops.dense_mxu_tc(torch.zeros(0, 0, dtype=torch.int8))) == 0
    with pytest.raises(ZeroDivisionError):
        jx_ops.dense_mxu_tc(jnp.zeros((0, 0), jnp.float32))
    with pytest.raises(ValueError, match="square"):
        ops.dense_mxu_tc(torch.zeros(3, 4, dtype=torch.int8))


def _plan_case(kind: str, n: int, rng) -> np.ndarray:
    a = rng.random((n, n)) < 0.3
    if kind == "upper":
        return np.triu(a, 1)
    if kind == "lower":
        return np.tril(a, -1)
    if kind == "block-sparse":  # random all-zero tile rows and columns of 16
        rows = np.repeat(rng.random(-(-n // 16)) < 0.5, 16)[:n]
        cols = np.repeat(rng.random(-(-n // 16)) < 0.5, 16)[:n]
        return a & rows[:, None] & cols[None, :]
    if kind == "empty":
        return np.zeros((n, n), bool)
    return a


@pytest.mark.parametrize("tile", [16, 32, 128])
@pytest.mark.parametrize("kind", ["upper", "lower", "full", "block-sparse", "empty"])
def test_dense_plan_sums_to_the_count(kind, tile):
    """The count summed over the occupancy plan's (i, k, j) blocks alone
    equals the plain version and the JAX package's Pallas kernel
    (interpret): every block the kernel skips is a product with a zero
    block. The plan keeps a sixth-ish of the blocks of a triangle, all of a
    full matrix, none of an empty one."""
    rng = np.random.default_rng(len(kind) * 7 + tile)
    n = 200
    a = _plan_case(kind, n, rng)
    at = torch.from_numpy(a)
    total, steps = pt_dense.dense_mxu_planned_sum(at, tile)
    want = int(jx_ops.dense_mxu_tc(jnp.asarray(a.astype(np.float32)), block=40))
    assert total == int(pt_dense.dense_mxu_tc_reference(at)) == want
    nt = -(-n // tile)
    occ = pt_dense.dense_mxu_occupancy_reference(at, tile)
    order, work, live = pt_dense.dense_mxu_plan(occ)
    assert steps == int(work.sum())
    assert sorted(order.tolist()) == list(range(nt * nt))
    assert int(live) == int((work > 0).sum()) and not bool((work[: int(live)] == 0).any())
    # Live tiles in groups of PLAN_GROUP^2, the group with the most work
    # first, the heaviest tile first inside a group.
    g = pt_dense.PLAN_GROUP
    ng = -(-nt // g)
    groups = [(t // nt // g) * ng + (t % nt) // g for t in order[: int(live)].tolist()]
    runs = [k for i, k in enumerate(groups) if i == 0 or groups[i - 1] != k]
    assert len(runs) == len(set(runs))
    gw = {k: sum(int(w) for k2, w in zip(groups, work.tolist()) if k2 == k) for k in runs}
    assert [gw[k] for k in runs] == sorted(gw.values(), reverse=True)
    for k in runs:
        ws = [int(w) for k2, w in zip(groups, work.tolist()) if k2 == k]
        assert ws == sorted(ws, reverse=True)
    # Groups of one tile: heaviest first, ties in row-major order.
    order1, work1, live1 = pt_dense.dense_mxu_plan(occ, 1)
    assert int(live1) == int(live) and int(work1.sum()) == steps
    assert bool((work1[:-1] >= work1[1:]).all())
    pairs = list(zip((-work1).tolist(), order1.tolist()))
    assert pairs == sorted(pairs)
    if kind == "full":
        assert steps == nt**3
    elif kind == "empty":
        assert steps == 0 and int(live) == 0
    elif kind in ("upper", "lower") and tile == 16:
        assert steps == nt * (nt + 1) * (nt + 2) // 6  # the blocks with i <= k <= j


def test_dense_occupancy_and_plan_by_brute_force():
    """occupancy == any non-zero in each block; the plan's work of tile
    (i, j) == #k with blocks (i, k) and (k, j) non-zero, zero unless block
    (i, j) is non-zero; live tiles first."""
    rng = np.random.default_rng(5)
    n, tile = 70, 16
    a = (rng.random((n, n)) < 0.01)
    occ = pt_dense.dense_mxu_occupancy_reference(torch.from_numpy(a), tile).numpy()
    nt = occ.shape[0]
    for i in range(nt):
        for k in range(nt):
            assert occ[i, k] == a[i * tile:(i + 1) * tile, k * tile:(k + 1) * tile].any()
    order, work, live = pt_dense.dense_mxu_plan(torch.from_numpy(occ))
    want = {i * nt + j: int(occ[i, j]) * int((occ[i] & occ[:, j]).sum())
            for i in range(nt) for j in range(nt)}
    assert dict(zip(order.tolist(), work.tolist())) == want
    assert int(live) == sum(w > 0 for w in want.values())


def test_dense_operand_padded_rows():
    """``dense_mxu_operand`` pads the row stride to 16 bytes; the plain path
    and ``ops.dense_mxu_tc`` take the padded view as any matrix."""
    a = pt_dense.dense_mxu_operand(37, "cpu")
    assert tuple(a.shape) == (37, 37) and a.stride() == (48, 1) and not bool(a.any())
    rng = np.random.default_rng(2)
    a.copy_(torch.from_numpy(np.triu(rng.random((37, 37)) < 0.4, 1)))
    assert int(ops.dense_mxu_tc(a)) == int(ref.ref_dense_tc(a.contiguous()))


def test_dense_guards_and_no_fallback():
    """The width guard of bitgemm; the CUDA wrappers refuse host tensors
    and count no launch; a tensor that is neither on the CPU nor on a card
    reaches the CUDA wrapper and raises, never the plain version."""
    wide = torch.empty(2, ops.INT32_SAFE_WORDS + 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="overflow"):
        ops.bitgemm(wide, wide)
    with pytest.raises(ValueError, match="do not match"):
        ops.bitgemm(torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2, 4, dtype=torch.int32))
    before = (pt_bitgemm.bitgemm_cuda.launches, pt_dense.dense_mxu_tc_cuda.launches)
    x = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pt_bitgemm.bitgemm_cuda(x, x, torch.zeros(4, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        pt_dense.dense_mxu_tc_cuda(torch.zeros(4, 4, dtype=torch.int8), torch.zeros(1, dtype=torch.int64))
    meta = torch.empty(4, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.bitgemm(meta, meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.dense_mxu_tc(torch.empty(4, 4, dtype=torch.int8, device="meta"))
    assert before == (pt_bitgemm.bitgemm_cuda.launches, pt_dense.dense_mxu_tc_cuda.launches)


@pytest.mark.parametrize("backend", DENSE)
@pytest.mark.parametrize("name", list(GRAPHS))
def test_dense_backends_match_reference_and_oracle(name, backend):
    edges = _edges(name)
    got = pt_core.tcim_count(edges, backend=backend, device="cpu")
    want = jx_core.tcim_count(edges, backend=backend)
    assert got.triangles == want.triangles == _exact(name)
    assert got.backend == backend and got.stats == want.stats
    assert set(got.timings_s) == set(want.timings_s) == {"orient", "execute"}
    g = _graphs(name)[1]
    graph_res = pt_core.tcim_count_graph(g, backend=backend, device="cpu")
    assert graph_res.triangles == _exact(name) and set(graph_res.timings_s) == {"execute"}


@pytest.mark.parametrize("backend", DENSE)
def test_dense_async_gives_resolved_future(backend):
    edges = _edges("ego-facebook")
    fut = pt_core.tcim_count(edges, backend=backend, device="cpu", async_=True)
    assert isinstance(fut, pt_core.TCFuture)
    want = jx_core.tcim_count(edges, backend=backend, async_=True).result()
    res = fut.result()
    assert res.triangles == want.triangles == _exact("ego-facebook")
    assert fut.result() is res and "close" not in res.timings_s


@pytest.mark.parametrize("name", list(GRAPHS))
def test_packed_operands_byte_equal(name):
    """The bitgemm operands packed from the edge list equal the reference's
    bitpack_matrix of dense_upper() and of its transpose, byte for byte;
    ``_bitgemm_operands`` hands them over as ``[:, :W]`` views of rows
    padded with zero words to a multiple of 8 words."""
    import repro_torch.core.tcim as pt_tcim

    jg, pg = _graphs(name)
    dense = jg.dense_upper()
    rows = _pack_words(pg.edges[:, 0], pg.edges[:, 1], pg.n)
    cols = _pack_words(pg.edges[:, 1], pg.edges[:, 0], pg.n)
    w = bitpack_matrix(dense).shape[1]
    assert rows.dtype == cols.dtype == np.uint32
    assert rows.shape[1] % 8 == 0 and rows.shape[1] >= w and not rows[:, w:].any()
    assert np.ascontiguousarray(rows[:, :w]).tobytes() == bitpack_matrix(dense).tobytes()
    assert np.ascontiguousarray(cols[:, :w]).tobytes() == bitpack_matrix(dense.T).tobytes()
    x, y = pt_tcim._bitgemm_operands(pg, torch.device("cpu"))
    for got, want in ((x, rows), (y, cols)):
        assert got.dtype == torch.int32 and tuple(got.shape) == (pg.n, w)
        assert got.stride(1) == 1 and got.stride(0) % 8 == 0 and got.stride(0) >= w
        assert np.array_equal(got.numpy().view(np.uint32), want[:, :w])
        store = torch.as_strided(got, (pg.n, got.stride(0)), (got.stride(0), 1))
        assert not bool(store[:, w:].any())  # the padding words are zero


def test_dense_backends_bitgemm_chunks(monkeypatch):
    """Many row chunks (and chunks with no edge, which are skipped) give the
    same count as one."""
    import repro_torch.core.tcim as pt_tcim

    g = _graphs("com-livejournal")[1]
    want = _exact("com-livejournal")
    for chunk_rows in (1, 7, 64, 4096):
        got = pt_tcim._execute_bitgemm(g, torch.device("cpu"), chunk_rows=chunk_rows)
        assert got.dtype == torch.int64 and int(got) == want


@pytest.mark.parametrize("backend", DENSE)
def test_dense_backends_accept_device_build(backend):
    """Dense backends have nothing to build on device and take the host
    path whatever `build` says, as the reference does
    (tests/test_build.py::test_build_argument_validation)."""
    edges = np.array([[0, 1], [0, 2], [1, 2]], dtype=np.int64)
    for build in ("device", "auto", "host"):
        got = pt_core.tcim_count(edges, backend=backend, build=build, device="cpu")
        want = jx_core.tcim_count(edges, backend=backend, build=build)
        assert got.triangles == want.triangles == 1
    with pytest.raises(ValueError, match="build"):
        pt_core.tcim_count(edges, backend=backend, build="gpu", device="cpu")
    # A mesh does not apply to the dense backends; the reference ignores it
    # and so does the port (it runs on the mesh's device). A mesh must be
    # the port's Mesh.
    from repro_torch.distributed import make_mesh

    mesh = make_mesh((2,), ("d",), devices=["cpu"] * 2)
    assert pt_core.tcim_count(edges, backend=backend, mesh=mesh).triangles == 1
    with pytest.raises(TypeError, match="Mesh"):
        pt_core.tcim_count(edges, backend=backend, mesh=object(), device="cpu")
    assert pt_core.tcim_count(np.zeros((0, 2), np.int64), backend=backend, device="cpu").triangles == 0


@pytest.mark.parametrize("slice_bits", [32, 64, 128])
@pytest.mark.parametrize("name", ["ego-facebook", "com-dblp", "roadnet-pa"])
def test_edge_support_matches_reference(name, slice_bits):
    jg, pg = _graphs(name)
    want = jx_metrics.edge_support(jg, slice_bits)
    assert want.sum() == _exact(name)
    for backend in ("pallas_items", "jnp"):
        got = pt_metrics.edge_support(pg, slice_bits, backend, device="cpu")
        assert got.dtype == np.int64 and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["ego-facebook", "email-enron", "roadnet-ca", "com-livejournal"])
def test_clustering_and_truss_match_reference(name):
    jg, pg = _graphs(name)
    local_got, trans_got = pt_metrics.clustering_coefficients(pg)
    local_want, trans_want = jx_metrics.clustering_coefficients(jg)
    np.testing.assert_allclose(local_got, local_want, rtol=1e-12, atol=0)
    assert trans_got == pytest.approx(trans_want, rel=1e-12)
    for k in (2, 3, 4, 5):
        assert np.array_equal(pt_metrics.ktruss(pg, k), jx_metrics.ktruss(jg, k))
    assert pt_metrics.max_truss(pg) == jx_metrics.max_truss(jg)


def test_edge_support_and_truss_small_graphs():
    """The reference's own small cases: a triangle, and two triangles with a
    pendant edge."""
    tri = pt_build_graph(np.array([[0, 1], [0, 2], [1, 2]], dtype=np.int64))
    assert pt_metrics.edge_support(tri, device="cpu").tolist() == [0, 1, 0]
    edges = np.array([[0, 1], [0, 2], [1, 2], [1, 3], [2, 3], [3, 4]], dtype=np.int64)
    g = pt_build_graph(edges)
    assert pt_metrics.ktruss(g, 3).sum() == 5 and not pt_metrics.ktruss(g, 4).any()
    assert np.array_equal(pt_metrics.ktruss(g, 3), jx_metrics.ktruss(jx_build_graph(edges), 3))
    empty = pt_build_graph(np.zeros((0, 2), np.int64), n=4)
    assert pt_metrics.edge_support(empty, device="cpu").shape == (0,)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_baselines_match_reference(name):
    jg, pg = _graphs(name)
    got = pt_baselines.matmul_tc(pg, device="cpu")
    assert got == jx_baselines.matmul_tc(jg) == _exact(name)
    assert pt_baselines.matmul_tc(pg, block=64, device="cpu") == got
    assert pt_baselines.intersection_tc(pg) == jx_baselines.intersection_tc(jg)
    out, secs = pt_baselines.timed(pt_baselines.intersection_tc, pg)
    assert out == _exact(name) and secs >= 0.0


@pytest.mark.parametrize("array_bytes", [1 << 10, 1 << 14, 16 * 1024 * 1024])
@pytest.mark.parametrize("name", ["ego-facebook", "com-dblp", "roadnet-tx"])
def test_cachesim_and_energy_match_reference(name, array_bytes):
    jg, pg = _graphs(name)
    jsb = jx_core.build_sbf(jg, 64)
    jwl = jx_core.build_worklist(jg, jsb)
    psb = pt_core.build_sbf(pg, 64)
    pwl = pt_core.build_worklist(pg, psb)
    got = pt_core.simulate_lru(psb, pwl, array_bytes=array_bytes)
    want = jx_core.simulate_lru(jsb, jwl, array_bytes=array_bytes)
    fields = ("capacity_slices", "loads", "hits", "misses", "exchanges", "row_writes")
    assert [getattr(got, f) for f in fields] == [getattr(want, f) for f in fields]
    for pct in ("hit_pct", "miss_pct", "exchange_pct", "write_savings_pct"):
        assert getattr(got, pct) == pytest.approx(getattr(want, pct), rel=1e-12)
    consts = pt_core.MramConstants(t_write=20e-9, e_ctrl=1e-8)
    jconsts = jx_core.MramConstants(t_write=20e-9, e_ctrl=1e-8)
    for c_got, c_want in ((None, None), (consts, jconsts)):
        kw_got = {} if c_got is None else {"constants": c_got}
        kw_want = {} if c_want is None else {"constants": c_want}
        lat, en = pt_core.tcim_latency_energy(pwl.num_pairs, got.misses, pg.m, **kw_got)
        lat_w, en_w = jx_core.tcim_latency_energy(jwl.num_pairs, want.misses, jg.m, **kw_want)
        assert lat == pytest.approx(lat_w, rel=1e-12) and en == pytest.approx(en_w, rel=1e-12)
        assert lat > 0 and en > 0
    assert pt_core.PAPER_TABLE5 == jx_core.PAPER_TABLE5
    from repro.core.energymodel import FPGA_POWER_W
    from repro_torch.core.energymodel import FPGA_POWER_W as PT_FPGA_POWER_W

    assert PT_FPGA_POWER_W == FPGA_POWER_W
