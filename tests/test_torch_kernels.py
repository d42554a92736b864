"""Port vs reference: the kernel layer of the main path.

The port's plain ``gather_total_reference`` and its byte-table oracle
(``kernels/ref.py``) are held against the JAX package's Pallas kernel
``gather_total_pallas`` in interpret mode (block_pairs=1, as
tests/test_executor.py:122 runs it), its jnp mirror and its
``lax.population_count`` oracle, on the same numpy inputs. Counts are
exact integers, so every comparison is equality. The CUDA kernel itself
runs only on a card (tests/test_torch_gpu.py and chip_smoke.py).

The reference's batched body (block_pairs > 1) does not run on JAX 0.9:
it names ``pltpu.TPUMemorySpace``, which JAX 0.9 no longer has, and
tests/test_executor.py::test_batched_kernel_matches_mirror fails the same
way there. It is recorded in ROADMAP.md queue 3 and not compared here.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.bitmat as jx_bitmat  # noqa: E402
import repro.kernels.ops as jx_ops  # noqa: E402
import repro.kernels.ref as jx_ref  # noqa: E402
import repro.kernels.tc_gather_popcount as jx_tgp  # noqa: E402
from repro_torch.core.executor import CountFuture  # noqa: E402
from repro_torch.kernels import common, ops, ref  # noqa: E402
from repro_torch.kernels import tc_gather_popcount as pt_tgp  # noqa: E402


def _words(rng, rows, w):
    return rng.integers(0, 2**32, size=(rows, w), dtype=np.uint64).astype(np.uint32)


def _as_torch(a: np.ndarray) -> torch.Tensor:
    """uint32 words -> the port's int32 view of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _case(rng, w, p, rows=97, cols=61):
    row = _words(rng, rows, w)
    col = _words(rng, cols, w)
    ridx = rng.integers(0, rows, size=p).astype(np.int32)
    cidx = rng.integers(0, cols, size=p).astype(np.int32)
    ridx[rng.random(p) < 0.15] = -1  # padding sentinels on either side
    cidx[rng.random(p) < 0.15] = -1
    ridx[: p // 4] = 5  # a hot row, repeated
    return row, col, ridx, cidx


def test_swar_popcount_matches_numpy(rng):
    words = np.concatenate([
        np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x55555555], np.uint32),
        _words(rng, 500, 1).ravel(),
    ])
    want = jx_bitmat.popcount_u32(words).astype(np.int32)
    got = common.swar_popcount_u32(_as_torch(words))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.popcount_u32_table(_as_torch(words)).numpy(), want)


@pytest.mark.parametrize("p", [0, 1, 37, 300])
@pytest.mark.parametrize("w", [1, 2, 4])
def test_plain_version_matches_pallas_kernel(w, p):
    """Port plain == Pallas kernel (interpret, B=1) == jnp mirror
    == lax.population_count oracle == port byte-table oracle."""
    rng = np.random.default_rng(100 * w + p)
    row, col, ridx, cidx = _case(rng, w, p)
    got = pt_tgp.gather_total_reference(
        _as_torch(row), _as_torch(col), torch.from_numpy(ridx), torch.from_numpy(cidx)
    )
    assert got.dtype == torch.int32 and got.shape == (2,)
    assert int(got[1]) == 0
    args = (jnp.asarray(row), jnp.asarray(col), jnp.asarray(ridx), jnp.asarray(cidx))
    kernel = int(jx_tgp.gather_total_pallas(*args, interpret=True, block_pairs=1))
    mirror = int(jx_tgp.gather_total_reference(*args))
    mask = (ridx >= 0) & (cidx >= 0)
    rows_g = np.where(mask[:, None], row[np.maximum(ridx, 0)], 0).astype(np.uint32)
    cols_g = col[np.maximum(cidx, 0)]
    jax_oracle = int(jx_ref.ref_popcount_and_total(jnp.asarray(rows_g), jnp.asarray(cols_g)))
    pt_oracle = int(ref.ref_popcount_and_total(_as_torch(rows_g), _as_torch(cols_g)))
    assert int(got[0]) == kernel == mirror == jax_oracle == pt_oracle
    per_pair = ref.ref_popcount_and_items(_as_torch(rows_g), _as_torch(cols_g)).numpy()
    want_items = np.asarray(
        jx_ref.ref_popcount_and_items(jnp.asarray(rows_g), jnp.asarray(cols_g))
    )
    assert np.array_equal(per_pair, want_items)


def test_ops_wrapper_cpu_path_accumulates(rng):
    row, col, ridx, cidx = _case(rng, 2, 200)
    args = (_as_torch(row), _as_torch(col), torch.from_numpy(ridx), torch.from_numpy(cidx))
    once = ops.popcount_and_gather_total(*args)
    want = int(jx_ops.popcount_and_gather_total(*(jnp.asarray(a) for a in (row, col, ridx, cidx))))
    assert int(once[0]) == want
    acc = torch.tensor([7, 0], dtype=torch.int32)
    out = ops.popcount_and_gather_total(*args, out=acc)
    assert out is acc and acc.tolist() == [7 + want, 0]
    empty = torch.zeros(0, dtype=torch.int32)
    assert ops.popcount_and_gather_total(args[0], args[1], empty, empty).tolist() == [0, 0]


def test_int32_guard_raises_in_both_packages():
    assert ops.INT32_SAFE_WORDS == jx_ops.INT32_SAFE_WORDS
    for w in (1, 2, 4):
        p = ops.INT32_SAFE_WORDS // w + 1
        with pytest.raises(ValueError, match="chunk_pairs"):
            jx_ops.popcount_and_gather_total(
                jax.ShapeDtypeStruct((8, w), jnp.uint32),
                jax.ShapeDtypeStruct((8, w), jnp.uint32),
                jax.ShapeDtypeStruct((p,), jnp.int32),
                jax.ShapeDtypeStruct((p,), jnp.int32),
            )
        idx = torch.empty(p, dtype=torch.int32, device="meta")
        store = torch.empty(8, w, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="chunk_pairs"):
            ops.popcount_and_gather_total(store, store, idx, idx)


def test_out_of_range_index_counted_and_raised(rng):
    """The port never reads past a store: the index is counted in out[1]
    and the count's close raises (the reference returns a fill row)."""
    row, col, ridx, cidx = _case(rng, 2, 50)
    ridx[10], cidx[10] = row.shape[0] + 3, 0
    cidx[20], ridx[20] = col.shape[0], 0
    out = pt_tgp.gather_total_reference(
        _as_torch(row), _as_torch(col), torch.from_numpy(ridx), torch.from_numpy(cidx)
    )
    assert int(out[1]) == 2
    with pytest.raises(ValueError, match="past the end"):
        CountFuture([out]).result()


def test_cuda_wrapper_refuses_cpu_tensors(rng):
    """No fallback: the kernel's wrapper raises on host tensors instead of
    running the plain version, and counts no launch."""
    row, col, ridx, cidx = _case(rng, 2, 10)
    before = pt_tgp.gather_total_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        pt_tgp.gather_total_cuda(
            _as_torch(row), _as_torch(col), torch.from_numpy(ridx),
            torch.from_numpy(cidx), torch.zeros(2, dtype=torch.int32),
        )
    assert pt_tgp.gather_total_cuda.launches == before


@pytest.mark.parametrize("fused", [True, False])
def test_modeled_bytes_match(fused):
    for p, w in ((0, 1), (1000, 2), (1 << 20, 4)):
        assert pt_tgp.modeled_hbm_bytes(p, w, fused=fused) == jx_tgp.modeled_hbm_bytes(
            p, w, fused=fused
        )
