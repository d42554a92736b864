"""Card-only tests of the port: the CUDA kernel against its plain version on
CUDA tensors, and the main path on the card.

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

from repro_torch.core import CountFuture, Executor, build_sbf, build_worklist, tcim_count  # noqa: E402
from repro_torch.graphs import build_graph, rmat, triangles_intersection  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.tc_gather_popcount import (  # noqa: E402
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
        before = gather_total_cuda.launches
        res = tcim_count(edges, slice_bits=bits, chunk_pairs=1 << 14)
        chunks = -(-res.stats["num_pairs"] // (1 << 14))
        assert gather_total_cuda.launches - before == chunks
        assert res.stats["device"].startswith("cuda")
        assert res.triangles == want == tcim_count(edges, slice_bits=bits, device="cpu").triangles


def test_executor_escape_on_card(cuda, monkeypatch):
    import repro_torch.core.executor as executor

    g = build_graph(rmat(4000, 30000, seed=2), reorder=True)
    sb = build_sbf(g, 64)
    wl = build_worklist(g, sb)
    want = Executor(sb, device="cpu").count(wl)
    monkeypatch.setattr(executor, "_INT32_MAX", 1000)
    assert Executor(sb, chunk_pairs=1024).count(wl) == want
