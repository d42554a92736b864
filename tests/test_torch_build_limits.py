"""The device build's limit: at most 2**30 candidates, refused before any lane.

``core/build.py``'s schedule step sizes its int32 lane arrays to the
candidate bucket ``cb = pow2_ceil(candidates)`` and sends misses to the
spare slot ``cb``, so ``cb`` must be an int32 index: at most ``2**30``
candidates. A larger total raises the documented ``ValueError`` before the
step allocates anything (a bucket of ``2**31`` lanes used to reach
``torch.where`` with an index past int32 and raise ``RuntimeError``, which
``build="auto"`` does not catch). Under "auto" the count then takes the
host build; ``build="device"`` raises; a stream's delta work list falls back
and counts in ``fallbacks``. Nothing here allocates a bucket: the limit is
patched low on small graphs, or the step is replaced by a fake. The
reference has the same pattern at ``src/repro/core/build.py:193``; these
tests hold counts to its exact oracle only.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.graphs import build_graph as jx_build_graph  # noqa: E402
from repro.graphs import rmat  # noqa: E402
from repro.graphs.exact import triangles_intersection  # noqa: E402

import repro_torch.core as pt_core  # noqa: E402
import repro_torch.core.build as pt_build  # noqa: E402
import repro_torch.core.tcim as pt_tcim  # noqa: E402
from repro_torch.core import sbf as pt_sbf  # noqa: E402
from repro_torch.graphs import build_graph as pt_build_graph  # noqa: E402

OLD_GUARD = 2**31 - 1 - (1 << 16)  # the guard before the repair: cb = 2**31 got through below it


def _tiny_worklist_args():
    """Arguments of ``_worklist`` over a 2-edge graph (real tensors, tiny)."""
    i32 = torch.int32
    src, dst = torch.tensor([0, 1], dtype=i32), torch.tensor([1, 2], dtype=i32)
    ptr = torch.tensor([0, 1, 2, 2], dtype=i32)
    idx = torch.zeros(2, dtype=i32)
    return src, dst, 2, (ptr, idx, ptr, idx), 1


def _no_step(*args, **kwargs):
    raise AssertionError("the schedule step ran (and would allocate its bucket)")


@pytest.mark.parametrize("cand", [2**30 + 1, 2**30 + 65_536, OLD_GUARD - 1, OLD_GUARD, 2**31,
                                  3 * 2**30, 2**40])
def test_worklist_refuses_past_2_30_before_allocating(monkeypatch, cand):
    monkeypatch.setattr(pt_build, "_worklist_step", _no_step)
    src, dst, m, arrays, n_slices = _tiny_worklist_args()
    with pytest.raises(ValueError, match=r"at or past int32 device indexing.*build on the host"):
        pt_build._worklist(src, dst, m, arrays, n_slices, cand, m, "build on the host")


@pytest.mark.parametrize("cand,bucket", [(2**30, 2**30), (2**29 + 1, 2**30), (2**29, 2**29),
                                         (1, 1), (0, 1)])
def test_worklist_takes_up_to_2_30(monkeypatch, cand, bucket):
    """The largest accepted total sizes a bucket of 2**30 lanes, whose spare
    slot 2**30 is an int32 index."""
    seen = []

    def fake_step(src, dst, m, row_ptr, row_idx, col_ptr, col_idx, n_slices, cb):
        seen.append(cb)
        none = torch.full((2,), -1, dtype=torch.int32)
        return none, none.clone(), none.clone(), torch.zeros((), dtype=torch.int32)

    monkeypatch.setattr(pt_build, "_worklist_step", fake_step)
    src, dst, m, arrays, n_slices = _tiny_worklist_args()
    wl = pt_build._worklist(src, dst, m, arrays, n_slices, cand, m, "build on the host")
    assert seen == [bucket] and bucket <= 2**31 - 1
    assert wl.num_candidates == cand and wl.num_pairs == 0


def test_spare_slot_of_the_largest_bucket_is_an_int32_index():
    """What the schedule step does with the spare slot, on a handful of
    lanes: ``torch.where`` of int32 lanes and ``cb`` keeps int32 at the
    largest accepted bucket (2**30); at the next (2**31) it cannot."""
    out = torch.arange(4, dtype=torch.int32)
    hit = torch.tensor([True, False, True, False])
    tgt = torch.where(hit, out - 1, pt_build._CAND_GUARD)
    assert tgt.dtype == torch.int32 and tgt.tolist() == [-1, 2**30, 1, 2**30]
    with pytest.raises(RuntimeError):
        torch.where(hit, out - 1, 2 * pt_build._CAND_GUARD)


def _host_sizes(edges, slice_bits):
    g = pt_build_graph(edges, reorder=True)
    sb = pt_sbf.build_sbf(g, slice_bits)
    u = g.edges[:, 0]
    cand = int((sb.row_ptr[u + 1] - sb.row_ptr[u]).astype(np.int64).sum())
    return {"row_valid": len(sb.row_slice_idx), "col_valid": len(sb.col_slice_idx),
            "candidates": cand}


@pytest.mark.parametrize("slice_bits", [32, 64, 128])
def test_device_build_raises_and_sizes_match_host(monkeypatch, slice_bits):
    """``build="device"`` raises the documented ValueError past the limit;
    the future's ``sizes()``, read before the schedule step, equal the host
    build's candidate total and valid slices a side."""
    edges = rmat(400, 2400, seed=31)
    want = _host_sizes(edges, slice_bits)
    fut = pt_core.device_build_async(edges, slice_bits=slice_bits, device="cpu")
    assert fut.sizes() == want
    monkeypatch.setattr(pt_build, "_CAND_GUARD", want["candidates"] - 1)
    monkeypatch.setattr(pt_build, "_worklist_step", _no_step)
    with pytest.raises(ValueError, match="at or past int32 device indexing"):
        fut.result()
    with pytest.raises(ValueError, match="host"):
        pt_core.tcim_count(edges, build="device", slice_bits=slice_bits, device="cpu")
    with pytest.raises(ValueError, match="host"):
        pt_core.tcim_count_graph(pt_build_graph(edges, reorder=True), build="device",
                                 slice_bits=slice_bits, device="cpu")


@pytest.mark.parametrize("margin", [-1, 0])
def test_auto_falls_back_to_the_host_past_the_limit(monkeypatch, margin):
    """"auto" resolved to the device: at the limit the device build counts,
    one candidate past it the host build does; both exact."""
    edges = rmat(300, 1500, seed=29)
    want = triangles_intersection(jx_build_graph(edges, reorder=True))
    cand = _host_sizes(edges, 64)["candidates"]
    resolve = pt_tcim._resolve_build
    monkeypatch.setattr(pt_tcim, "_resolve_build",
                        lambda build, backend, m, device: resolve(build, backend, m,
                                                                  torch.device("cuda")))
    monkeypatch.setattr(pt_build, "_CAND_GUARD", cand + margin)
    res = pt_core.tcim_count(edges, device="cpu")
    assert res.triangles == want
    assert res.stats["build"] == ("device" if margin == 0 else "host")


@pytest.mark.parametrize("build", ["auto", "device"])
def test_stream_delta_refusal_counts_in_fallbacks(monkeypatch, build):
    """The real guard refuses a stream's delta work list: "auto" (forced
    onto the device path) falls back to the host's and counts it in
    ``state.fallbacks``; "device" raises."""
    g = pt_build_graph(rmat(300, 1800, seed=9), reorder=False)
    rm = g.edges[:30]
    monkeypatch.setattr(pt_build, "_CAND_GUARD", 1)
    state = pt_core.StreamingTCState(g.edges, n=g.n, build=build, device="cpu")
    state._use_device_build = True
    if build == "device":
        with pytest.raises(ValueError, match="at or past int32 device indexing"):
            state.apply_batch(removed=rm)
        return
    res = state.apply_batch(removed=rm)
    assert state.fallbacks == 2 and state.index_upload_bytes == 0
    keep = np.ones(g.m, dtype=bool)
    keep[:30] = False
    assert res.triangles == triangles_intersection(jx_build_graph(g.edges[keep], n=g.n))
