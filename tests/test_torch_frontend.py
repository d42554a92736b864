"""Port vs reference: the host front end (generate -> orient -> compress ->
schedule) of ``repro_torch`` is byte-equal to the JAX package's.

Same seeds, same configs: the port's generators, ``Graph`` CSR, SBF stores
and worklist pair arrays must equal ``repro``'s array for array, dtype
included, on every ``GRAPHS`` config x slice_bits {32, 64, 128} (the sweep
of tests/test_build.py). Everything compared is an exact integer array.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (both packages in one process, JAX on the CPU)
import numpy as np  # noqa: E402

import repro.configs.tcim_graphs as jx_configs  # noqa: E402
import repro.core.bitmat as jx_bitmat  # noqa: E402
import repro.core.sbf as jx_sbf  # noqa: E402
import repro.data.graph_pipeline as jx_pipeline  # noqa: E402
import repro.graphs as jx_graphs  # noqa: E402
import repro_torch.configs as pt_configs  # noqa: E402
import repro_torch.core.bitmat as pt_bitmat  # noqa: E402
import repro_torch.core.sbf as pt_sbf  # noqa: E402
import repro_torch.data.graph_pipeline as pt_pipeline  # noqa: E402
import repro_torch.graphs as pt_graphs  # noqa: E402

SBF_ARRAYS = (
    "row_ptr", "row_slice_idx", "row_slice_data",
    "col_ptr", "col_slice_idx", "col_slice_data",
)
WL_ARRAYS = ("pair_edge", "pair_row_pos", "pair_col_pos")


def _scaled(name: str):
    # com-livejournal at 0.02 would cost the JAX side more than the rest of
    # the sweep together.
    return jx_configs.GRAPHS[name].scaled(0.005 if name == "com-livejournal" else 0.02)


def _edges(graphs_mod, cfg):
    gen = graphs_mod.GRAPH_GENERATORS[cfg.generator]
    if cfg.generator == "grid_road":
        return gen(cfg.n, seed=cfg.seed)
    return gen(cfg.n, cfg.m, seed=cfg.seed)


@functools.lru_cache(maxsize=None)
def _graphs(name: str):
    cfg = _scaled(name)
    e_jx, e_pt = _edges(jx_graphs, cfg), _edges(pt_graphs, cfg)
    return (
        e_jx, e_pt,
        jx_graphs.build_graph(e_jx, reorder=True),
        pt_graphs.build_graph(e_pt, reorder=True),
    )


def _assert_arrays_equal(got, want, names):
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


def test_graph_configs_match():
    assert list(pt_configs.GRAPHS) == list(jx_configs.GRAPHS)
    for name, cfg in jx_configs.GRAPHS.items():
        assert dataclasses.asdict(pt_configs.GRAPHS[name]) == dataclasses.asdict(cfg)
        assert dataclasses.asdict(pt_configs.GRAPHS[name].scaled(0.02)) == (
            dataclasses.asdict(cfg.scaled(0.02))
        )


@pytest.mark.parametrize(
    "name,args",
    [
        ("erdos_renyi", (300, 900, 3)),
        ("rmat", (500, 2000, 5)),
        ("barabasi_albert", (200, 3, 7)),
        ("grid_road", (400, 0.05, 2)),
        ("complete", (9,)),
        ("bipartite", (120, 400, 4)),
    ],
)
def test_generators_match(name, args):
    got = pt_graphs.GRAPH_GENERATORS[name](*args)
    want = jx_graphs.GRAPH_GENERATORS[name](*args)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("slice_bits", [32, 64, 128])
@pytest.mark.parametrize("name", list(jx_configs.GRAPHS))
def test_front_end_byte_equal_on_bench_configs(name, slice_bits):
    """Every tcim_graphs config x slice_bits: port build == JAX package build."""
    e_jx, e_pt, g_jx, g_pt = _graphs(name)
    assert np.array_equal(e_pt, e_jx)
    assert g_pt.n == g_jx.n
    _assert_arrays_equal(g_pt, g_jx, ("edges", "indptr", "indices"))
    sb_jx = jx_sbf.build_sbf(g_jx, slice_bits)
    sb_pt = pt_sbf.build_sbf(g_pt, slice_bits)
    assert (sb_pt.slice_bits, sb_pt.n, sb_pt.n_slices) == (
        sb_jx.slice_bits, sb_jx.n, sb_jx.n_slices,
    )
    _assert_arrays_equal(sb_pt, sb_jx, SBF_ARRAYS)
    wl_jx = jx_sbf.build_worklist(g_jx, sb_jx)
    wl_pt = pt_sbf.build_worklist(g_pt, sb_pt)
    _assert_arrays_equal(wl_pt, wl_jx, WL_ARRAYS)
    assert (wl_pt.m_edges, wl_pt.n_slices) == (wl_jx.m_edges, wl_jx.n_slices)
    assert pt_sbf.sbf_stats(g_pt, sb_pt, wl_pt) == jx_sbf.sbf_stats(g_jx, sb_jx, wl_jx)


@pytest.mark.parametrize("reorder", [False, True])
def test_orientation_matches(reorder):
    edges = jx_graphs.rmat(350, 2200, seed=11)
    got = pt_graphs.build_graph(edges, reorder=reorder)
    want = jx_graphs.build_graph(edges, reorder=reorder)
    _assert_arrays_equal(got, want, ("edges", "indptr", "indices"))
    assert np.array_equal(pt_graphs.degree_order(edges, 350), jx_graphs.degree_order(edges, 350))
    empty = pt_graphs.build_graph(np.zeros((0, 2), np.int64), n=5)
    assert empty.n == 5 and empty.m == 0 and np.array_equal(empty.indptr, np.zeros(6))


def test_exact_oracles_match():
    edges = jx_graphs.rmat(120, 700, seed=3)
    g_pt = pt_graphs.build_graph(edges, reorder=True)
    g_jx = jx_graphs.build_graph(edges, reorder=True)
    want = jx_graphs.triangles_bruteforce(g_jx)
    assert want > 0
    assert pt_graphs.triangles_bruteforce(g_pt) == want
    assert pt_graphs.triangles_dense_trace(g_pt) == jx_graphs.triangles_dense_trace(g_jx) == want
    assert pt_graphs.triangles_intersection(g_pt) == jx_graphs.triangles_intersection(g_jx) == want


def test_bitmat_matches(rng):
    dense = rng.random((37, 70)) < 0.3
    packed = pt_bitmat.bitpack_matrix(dense)
    assert np.array_equal(packed, jx_bitmat.bitpack_matrix(dense))
    assert np.array_equal(pt_bitmat.bitunpack_matrix(packed, 70), dense.astype(np.uint8))
    words = rng.integers(0, 2**32, size=(5, 9), dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(pt_bitmat.popcount_u32(words), jx_bitmat.popcount_u32(words))


@pytest.mark.parametrize("slice_bits", [32, 128])
def test_state_carries_across(slice_bits):
    """sbf_from_arrays / worklist_from_arrays take the JAX package's objects
    (duck-typed) or dicts and equal the port's own build."""
    _, _, g_jx, g_pt = _graphs("ego-facebook")
    sb_jx = jx_sbf.build_sbf(g_jx, slice_bits)
    wl_jx = jx_sbf.build_worklist(g_jx, sb_jx)
    sb_pt = pt_sbf.build_sbf(g_pt, slice_bits)
    wl_pt = pt_sbf.build_worklist(g_pt, sb_pt)
    carried = pt_sbf.sbf_from_arrays(sb_jx)
    assert isinstance(carried, pt_sbf.SlicedBitmap)
    _assert_arrays_equal(carried, sb_pt, SBF_ARRAYS)
    as_dict = {f.name: getattr(sb_jx, f.name) for f in dataclasses.fields(pt_sbf.SlicedBitmap)}
    _assert_arrays_equal(pt_sbf.sbf_from_arrays(as_dict), sb_pt, SBF_ARRAYS)
    wl = pt_sbf.worklist_from_arrays(wl_jx)
    _assert_arrays_equal(wl, wl_pt, WL_ARRAYS)
    assert wl.num_pairs == wl_jx.num_pairs
    bad = dict(as_dict, row_slice_data=as_dict["row_slice_data"][:, :1])
    if slice_bits != 32:
        with pytest.raises(ValueError):
            pt_sbf.sbf_from_arrays(bad)


def test_load_graph_matches():
    cfg = jx_configs.GRAPHS["email-enron"].scaled(0.02)
    got = pt_pipeline.load_graph(pt_configs.GRAPHS["email-enron"].scaled(0.02), 64)
    want = jx_pipeline.load_graph(cfg, 64)
    _assert_arrays_equal(got[0], want[0], ("edges", "indptr"))
    _assert_arrays_equal(got[1], want[1], SBF_ARRAYS)
    _assert_arrays_equal(got[2], want[2], WL_ARRAYS)
    assert pt_pipeline.load_graph(pt_configs.GRAPHS["email-enron"].scaled(0.02), 64) is got
