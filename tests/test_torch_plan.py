"""Port vs reference: the sharded planner (``core/plan.py``).

``repro_torch.core.plan`` must be byte-equal to the JAX package's
``repro.core.plan`` on the same inputs: range bounds and grid balancing,
``plan_execution``'s sharded placements (stripes with their shard-local
coordinates, bounds, block rows, split, imbalance, stats), stripe schedules
under both policies (steps, staged lanes, ``emit``/``emit_compact`` rows),
resume cursors, ``remaining_worklist`` and ``replan_fixed``, and the errors
they raise. Inputs: every ``configs/tcim_graphs.py`` config (scaled) at
``slice_bits`` 32/64/128, and ``rmat(400, 2500, seed=1)`` with
``CHUNK = 256`` pairs a step for multi-step schedules. Everything here is
NumPy, so both packages run in-process.
"""
import functools

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402,F401  (both packages in one process, JAX on the CPU)
import numpy as np  # noqa: E402

import repro.core.plan as jx_plan  # noqa: E402
from repro.configs.tcim_graphs import GRAPHS  # noqa: E402
from repro.core import build_sbf, build_worklist  # noqa: E402
from repro.data.graph_pipeline import load_graph  # noqa: E402
from repro.graphs import build_graph, rmat  # noqa: E402

import repro_torch.core.plan as pt_plan  # noqa: E402
from repro_torch.core.sbf import sbf_from_arrays, worklist_from_arrays  # noqa: E402

CHUNK = 256
GRIDS = ((1, 4), (2, 2), (4, 2))
PLAN_FIELDS = ("placement", "num_shards", "chunk_pairs", "words_per_slice", "col_shard_rows",
               "grid", "row_shard_rows", "split", "total_pairs", "imbalance", "stats")
SCHEDULE_FIELDS = ("policy", "num_shards", "budget", "num_steps", "total_pairs",
                   "max_step_pairs", "total_lanes", "staged_lanes")


@functools.lru_cache(maxsize=None)
def _config_state(name, slice_bits):
    cfg = GRAPHS[name].scaled(0.005 if name == "com-livejournal" else 0.02)
    _, sb, wl = load_graph(cfg, slice_bits)
    return sb, wl, sbf_from_arrays(sb), worklist_from_arrays(wl)


@functools.lru_cache(maxsize=None)
def _rmat_state():
    g = build_graph(rmat(400, 2500, seed=1), reorder=True)
    sb = build_sbf(g)
    wl = build_worklist(g, sb)
    return sb, wl, sbf_from_arrays(sb), worklist_from_arrays(wl)


def _same_array(got, want):
    assert got is None and want is None or (
        np.asarray(got).dtype == np.asarray(want).dtype and np.array_equal(got, want)
    ), (got, want)


def _assert_plan_equal(got, want):
    for f in PLAN_FIELDS:
        assert getattr(got, f) == getattr(want, f), (f, getattr(got, f), getattr(want, f))
    _same_array(got.row_bounds, want.row_bounds)
    _same_array(got.col_bounds, want.col_bounds)
    assert len(got.stripes) == len(want.stripes)
    for a, b in zip(got.stripes, want.stripes):
        assert (a.shard, a.row_shard, a.col_shard) == (b.shard, b.row_shard, b.col_shard)
        _same_array(a.row_pos, b.row_pos)
        _same_array(a.col_pos, b.col_pos)


def _steps(sched):
    return tuple((s.bucket, s.starts, s.lens) for s in sched.steps)


def _assert_schedule_equal(got, want):
    for f in SCHEDULE_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert _steps(got) == _steps(want)
    for k in range(got.num_steps + 1):
        assert got.cursor_after(k) == want.cursor_after(k)


def _plans(mod, sb, wl, **kwargs):
    """Every sharded plan kind of one work list under ``mod``'s planner."""
    topo = mod.DeviceTopology(num_devices=8)
    out = [mod.plan_execution(sb, wl, topo, placement="sharded_cols", num_shards=4, **kwargs)]
    for grid in GRIDS:
        for split in ("weighted", "even"):
            out.append(mod.plan_execution(sb, wl, topo, placement="sharded_2d", grid=grid,
                                          split=split, **kwargs))
    return out


@pytest.mark.parametrize("slice_bits", [32, 64, 128])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_sharded_plans_byte_equal_on_every_config(name, slice_bits):
    """sharded_cols on 4 shards and sharded_2d on (1, 4), (2, 2), (4, 2)
    (weighted and even): equal plans; each plan's schedules equal under
    both policies at a budget of about six steps; the replicated plan too."""
    sb, wl, psb, pwl = _config_state(name, slice_bits)
    for got, want in zip(_plans(pt_plan, psb, pwl), _plans(jx_plan, sb, wl)):
        _assert_plan_equal(got, want)
        assert got.total_pairs == wl.num_pairs
        lens = [s.num_pairs for s in got.stripes]
        budget = max(sum(lens) // 6, 1)
        for policy in pt_plan.SCHEDULES:
            _assert_schedule_equal(pt_plan.build_stripe_schedule(lens, budget, policy=policy),
                                   jx_plan.build_stripe_schedule(lens, budget, policy=policy))
    one = (pt_plan.DeviceTopology(num_devices=1), jx_plan.DeviceTopology(num_devices=1))
    _assert_plan_equal(pt_plan.plan_execution(psb, pwl, one[0]),
                       jx_plan.plan_execution(sb, wl, one[1]))


@pytest.mark.parametrize("grid", GRIDS)
def test_range_bounds_match_reference(grid):
    """shard_col_bounds, even/weighted/bottleneck range bounds, range owners
    and balance_grid_bounds (bincount in the port, np.add.at in the
    reference) byte-equal."""
    sb, wl, _, _ = _rmat_state()
    rows, cols = grid
    rp, cp = np.asarray(wl.pair_row_pos), np.asarray(wl.pair_col_pos)
    nrow, ncol = len(sb.row_slice_idx), len(sb.col_slice_idx)
    for records in (0, 1, 7, nrow):
        assert pt_plan.shard_col_bounds(records, cols) == jx_plan.shard_col_bounds(records, cols)
        _same_array(pt_plan.even_range_bounds(records, rows), jx_plan.even_range_bounds(records, rows))
    weights = np.bincount(cp, minlength=ncol)
    _same_array(pt_plan.weighted_range_bounds(weights, cols),
                jx_plan.weighted_range_bounds(weights, cols))
    rng = np.random.default_rng(rows * 10 + cols)
    for shape in ((0, 2), (1, 1), (50, cols), (nrow, 3)):
        counts = rng.integers(0, 20, size=shape)
        _same_array(pt_plan.bottleneck_range_bounds(counts, rows),
                    jx_plan.bottleneck_range_bounds(counts, rows))
    bounds = jx_plan.even_range_bounds(ncol, cols)
    _same_array(pt_plan.range_owners(bounds, cp), jx_plan.range_owners(bounds, cp))
    for iters in (1, 3):
        got = pt_plan.balance_grid_bounds(rp, cp, nrow, ncol, grid, iters=iters)
        want = jx_plan.balance_grid_bounds(rp, cp, nrow, ncol, grid, iters=iters)
        for a, b in zip(got, want):
            _same_array(a, b)
    empty = np.zeros(0, np.int64)
    for a, b in zip(pt_plan.balance_grid_bounds(empty, empty, nrow, ncol, grid),
                    jx_plan.balance_grid_bounds(empty, empty, nrow, ncol, grid)):
        _same_array(a, b)


@pytest.mark.parametrize("policy", ["packed", "lockstep"])
def test_stripe_schedule_emission_matches_reference(policy):
    """Multi-step schedules at CHUNK pairs a step on (2, 2) and (4, 2)
    weighted plans: steps, cursors, and every emit / emit_compact row
    (from step 0 and from a middle step) byte-equal; compact rows of a
    drained shard are the shared read-only sentinel row."""
    sb, wl, psb, pwl = _rmat_state()
    for grid in ((2, 2), (4, 2)):
        topo = (pt_plan.DeviceTopology(num_devices=8), jx_plan.DeviceTopology(num_devices=8))
        pp = pt_plan.plan_execution(psb, pwl, topo[0], placement="sharded_2d", grid=grid,
                                    chunk_pairs=CHUNK)
        jp = jx_plan.plan_execution(sb, wl, topo[1], placement="sharded_2d", grid=grid,
                                    chunk_pairs=CHUNK)
        _assert_plan_equal(pp, jp)
        lens = [s.num_pairs for s in pp.stripes]
        got = pt_plan.build_stripe_schedule(lens, CHUNK, policy=policy)
        want = jx_plan.build_stripe_schedule(lens, CHUNK, policy=policy)
        _assert_schedule_equal(got, want)
        assert got.num_steps >= 4
        for start in (0, got.num_steps // 2):
            for (r1, c1), (r2, c2) in zip(got.emit(pp.stripes, start), want.emit(jp.stripes, start),
                                          strict=True):
                _same_array(r1, r2)
                _same_array(c1, c2)
            pairs = zip(got.steps[start:], got.emit_compact(pp.stripes, start),
                        want.emit_compact(jp.stripes, start), strict=True)
            for step, (b1, rr1, cc1), (b2, rr2, cc2) in pairs:
                assert b1 == b2 == step.bucket
                for s, n in enumerate(step.lens):
                    _same_array(rr1[s], rr2[s])
                    _same_array(cc1[s], cc2[s])
                    if n == 0:
                        assert rr1[s] is pt_plan.sentinel_row(b1) and not rr1[s].flags.writeable


def test_schedule_edge_cases_and_errors_match_reference():
    for lens, budget in (([37, 5, 0, 61], 16), ([], 8), ([3, 3], 100), ([1] * 9, 4), ([0, 0], 5)):
        for policy in pt_plan.SCHEDULES:
            _assert_schedule_equal(pt_plan.build_stripe_schedule(lens, budget, policy=policy),
                                   jx_plan.build_stripe_schedule(lens, budget, policy=policy))
    for mod in (pt_plan, jx_plan):
        with pytest.raises(ValueError, match="schedule"):
            mod.build_stripe_schedule([1], 4, policy="best")
        with pytest.raises(ValueError, match=">= 0"):
            mod.build_stripe_schedule([1, -1], 4)
        sched = mod.build_stripe_schedule([5, 2], 4)
        for bad in (-1, sched.num_steps + 1):
            with pytest.raises(ValueError, match="num_steps"):
                sched.cursor_after(bad)
        with pytest.raises(ValueError, match="stripes"):
            next(sched.emit(()))
        with pytest.raises(ValueError, match="stripes"):
            next(sched.emit_compact(()))


@pytest.mark.parametrize("grid", GRIDS)
def test_remaining_worklist_and_replan_fixed_match_reference(grid):
    """remaining_worklist at every cursor of a CHUNK schedule, lifted to
    global coordinates, and replan_fixed of a new work list against the
    plan's bounds: byte-equal, with the same refusals."""
    sb, wl, psb, pwl = _rmat_state()
    pp = pt_plan.plan_execution(psb, pwl, pt_plan.DeviceTopology(num_devices=8),
                                placement="sharded_2d", grid=grid, chunk_pairs=CHUNK)
    jp = jx_plan.plan_execution(sb, wl, jx_plan.DeviceTopology(num_devices=8),
                                placement="sharded_2d", grid=grid, chunk_pairs=CHUNK)
    sched = pt_plan.build_stripe_schedule([s.num_pairs for s in pp.stripes], CHUNK)
    for k in [None, *range(sched.num_steps + 1)]:
        cur = None if k is None else sched.cursor_after(k)
        got = pt_plan.remaining_worklist(pp, cur, n_slices=wl.n_slices)
        want = jx_plan.remaining_worklist(jp, cur, n_slices=wl.n_slices)
        for f in ("pair_edge", "pair_row_pos", "pair_col_pos"):
            _same_array(getattr(got, f), getattr(want, f))
        assert (got.m_edges, got.n_slices) == (want.m_edges, want.n_slices)
    half = jx_plan.remaining_worklist(jp, sched.cursor_after(sched.num_steps // 2))
    _assert_plan_equal(pt_plan.replan_fixed(pp, psb, worklist_from_arrays(half)),
                       jx_plan.replan_fixed(jp, sb, half))
    _assert_plan_equal(pt_plan.replan_fixed(pp, psb, worklist_from_arrays(half), chunk_pairs=64),
                       jx_plan.replan_fixed(jp, sb, half, chunk_pairs=64))
    for mod, plan, s, w in ((pt_plan, pp, psb, pwl), (jx_plan, jp, sb, wl)):
        with pytest.raises(ValueError, match="cursors"):
            mod.remaining_worklist(plan, (0,) * (len(plan.stripes) + 1))
        past = [st.num_pairs for st in plan.stripes]
        past[-1] += 1
        with pytest.raises(ValueError, match="out of range"):
            mod.remaining_worklist(plan, past)
        cols = mod.plan_execution(s, w, mod.DeviceTopology(num_devices=4), placement="sharded_cols")
        with pytest.raises(ValueError, match="sharded_2d"):
            mod.replan_fixed(cols, s, w)


def test_placement_resolution_and_refusals_match_reference():
    """'auto' on big and small topologies, memory-bounded thresholds, fixed
    bounds, and every ValueError of the planner, in both packages."""
    sb, wl, psb, pwl = _rmat_state()
    cases = [
        dict(topo=dict(num_devices=1)),
        dict(topo=dict(num_devices=8)),
        dict(topo=dict(num_devices=8), shard_above_bytes=1),
        dict(topo=dict(num_devices=8), shard_above_bytes=1, grid=(4, 2)),
        dict(topo=dict(num_devices=8), shard_above_bytes=1, grid=(1, 8)),
        dict(topo=dict(num_devices=8, memory_bytes=2 * sb.data_bytes - 2)),
        dict(topo=dict(num_devices=8), placement="sharded_cols"),
        dict(topo=dict(num_devices=8), placement="sharded_cols", num_shards=3),
        dict(topo=dict(num_devices=8), placement="sharded_2d", grid=(2, 3), balance_iters=1),
        dict(topo=dict(num_devices=8), placement="sharded_2d", grid=(2, 2),
             row_bounds=np.array([0, 5, len(sb.row_slice_idx)]),
             col_bounds=np.array([0, 0, len(sb.col_slice_idx)])),
    ]
    for case in cases:
        kw = dict(case)
        topo = kw.pop("topo")
        _assert_plan_equal(
            pt_plan.plan_execution(psb, pwl, pt_plan.DeviceTopology(**topo), **kw),
            jx_plan.plan_execution(sb, wl, jx_plan.DeviceTopology(**topo), **kw),
        )
    refusals = [
        (dict(placement="x"), "placement"),
        (dict(placement="sharded_2d"), "grid"),
        (dict(placement="sharded_2d", grid=(0, 2)), ">= 1"),
        (dict(placement="sharded_2d", grid=(2, 2), num_shards=3), "contradicts"),
        (dict(placement="sharded_2d", grid=(2, 2), split="best"), "split"),
        (dict(placement="sharded_cols", split="weighted"), "even split"),
        (dict(placement="sharded_cols", num_shards=-1), ">= 1"),
        (dict(placement="sharded_2d", grid=(2, 2), row_bounds=np.array([0, 1, 2])), "together"),
        (dict(placement="sharded_2d", grid=(2, 2), row_bounds=np.array([0, 1]),
              col_bounds=np.array([0, 1, 2])), "row_bounds"),
        (dict(chunk_pairs=0), "chunk_pairs"),
    ]
    for kwargs, match in refusals:
        for mod, s, w in ((pt_plan, psb, pwl), (jx_plan, sb, wl)):
            with pytest.raises(ValueError, match=match):
                mod.plan_execution(s, w, mod.DeviceTopology(num_devices=8), **kwargs)
    assert pt_plan.sentinel_row(8) is pt_plan.sentinel_row(8)
    assert (pt_plan.PLACEMENTS, pt_plan.SPLITS, pt_plan.SCHEDULES) == (
        jx_plan.PLACEMENTS, jx_plan.SPLITS, jx_plan.SCHEDULES)
    assert set(jx_plan.__all__) <= set(pt_plan.__all__)
