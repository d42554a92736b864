"""Masked dense A @ A triangle count: ``sum_{i,j} A[i,j] * (A @ A)[i,j]``.

Port of ``src/repro/kernels/tc_dense_mxu.py`` (``dense_mxu_tc_pallas``):
the honest accelerator comparison point the paper rejects for MRAM (integer
multiply), here on the H100's tensor cores. With A the upper-triangular
{0,1} adjacency every triangle counts once. It carries the ``mxu`` backend
of ``tcim_count``.

  * ``dense_mxu_tc_cuda`` — the wrapper of the hand-written CUDA kernels
    ``csrc/tc_dense_mxu.cu`` (its header gives the design and bound): an
    occupancy pass over A, a plan of the live output tiles in plain torch
    (``dense_mxu_plan``), and the persistent ``wgmma`` kernel over them. It
    adds the count into a caller-owned int64 one-element ``out``, launches
    on the current stream, and counts its launches in
    ``dense_mxu_tc_cuda.launches``. Its one large allocation is ``A^T``
    (row stride padded to 16 bytes, as TMA needs), so that both MMA operands
    are K-major; A itself is copied only if its row stride is not a multiple
    of 16 bytes (``dense_mxu_operand`` allocates it so).
  * ``dense_mxu_tc_reference`` — the plain torch version: float64 row-block
    products (exact: every partial sum is an integer below 2^53), summed in
    int64. It runs on any device and is the CPU path.
  * ``dense_mxu_occupancy_reference``, ``dense_mxu_plan`` and
    ``dense_mxu_planned_sum`` — the plain statement of what the kernel
    skips: which 128 x 128 blocks are non-zero, the live tiles heaviest
    first with their k steps, and the count summed over the planned
    (i, k, j) blocks alone.

The reference casts to bf16 and sums in f32, so it is exact only below
2^24; the port takes int8 (half the bytes, {0,1} exact) and int64 sums.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import report_cost

__all__ = [
    "DENSE_TILE",
    "PLAN_GROUP",
    "dense_mxu_occupancy_reference",
    "dense_mxu_operand",
    "dense_mxu_plan",
    "dense_mxu_planned_sum",
    "dense_mxu_tc_cuda",
    "dense_mxu_tc_reference",
]

DENSE_TILE = 128  # the kernel's output tile and K block
PLAN_GROUP = 12  # tiles a side of the groups taken together (12^2 ~ 132 SMs) above L2
MAX_N = 131072  # the kernel's producer holds 32 x 32 k tiles of occupancy
_PLAIN_BLOCK = 4096  # rows of A @ A the plain version holds at once


def dense_mxu_tc_reference(a: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``[N, N]`` {0,1} -> 0-d int64 count."""
    af = a.to(torch.float64)
    total = torch.zeros((), dtype=torch.int64, device=a.device)
    for start in range(0, a.shape[0], _PLAIN_BLOCK):
        rows = af[start : start + _PLAIN_BLOCK]
        total += ((rows @ af) * rows).sum().to(torch.int64)
    return total


def _padded_len(n: int) -> int:
    return -(-max(n, 1) // 16) * 16


def dense_mxu_operand(n: int, device) -> torch.Tensor:
    """A zeroed ``[n, n]`` int8 matrix whose row stride is padded to 16 bytes,
    so the kernel takes it without a copy."""
    return torch.zeros(n, _padded_len(n), dtype=torch.int8, device=device)[:, :n]


def dense_mxu_occupancy_reference(a: torch.Tensor, tile: int = DENSE_TILE) -> torch.Tensor:
    """``[nt, nt]`` bool: whether block (ti, tk) of ``a`` holds a non-zero."""
    n = a.shape[0]
    nt = -(-n // tile)
    padded = torch.zeros(nt * tile, nt * tile, dtype=torch.bool, device=a.device)
    padded[:n, :n] = a != 0
    return padded.view(nt, tile, nt, tile).any(dim=3).any(dim=1)


def dense_mxu_plan(occ: torch.Tensor, group: int = PLAN_GROUP
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The live output tiles in the order the kernel takes them, from an
    ``[nt, nt]`` occupancy.

    Tile (i, j) is live when block (i, j) is non-zero and some k has blocks
    (i, k) and (k, j) non-zero; its work is the number of such k. Live tiles
    come first, in ``group`` x ``group`` groups of tiles, the group with the
    most work first and the heaviest tile first inside a group: the blocks
    running at once share rows of A and columns of A^T, which L2 then
    serves, and the heavy tiles start early, so the triangle balances. With
    ``group`` 1 the order is simply heaviest first (the wrapper's choice
    when A and A^T fit in L2 anyway). Returns ``(order, work, live)``: every
    tile ``i * nt + j`` as int32 in that order, its work in that order
    (int64), and the number of live tiles as a one-element int32 tensor, all
    on ``occ``'s device with no host round trip.
    """
    nt = occ.shape[0]
    f = occ.to(torch.float32)
    work = ((f @ f) * f).to(torch.int64)  # exact: counts at most nt <= 2^24
    if group == 1:  # heaviest first: one sort (its ops are launch-bound at small N)
        work, order = torch.sort(work.flatten(), descending=True, stable=True)
        return order.to(torch.int32), work, (work > 0).sum().to(torch.int32).reshape(1)
    ng = -(-nt // group)
    idx = torch.arange(nt, device=occ.device) // group
    group = (idx[:, None] * ng + idx[None, :]).flatten()
    group_work = torch.zeros(ng * ng, dtype=torch.int64, device=occ.device)
    group_work.index_add_(0, group, work.flatten())
    # Stable sorts from the least to the most significant key.
    order = torch.sort(work.flatten(), descending=True, stable=True)[1]
    for key, descending in ((group, False), (group_work[group], True), (work.flatten() > 0, True)):
        order = order[torch.sort(key[order], descending=descending, stable=True)[1]]
    work = work.flatten()[order]
    live = (work > 0).sum().to(torch.int32).reshape(1)
    return order.to(torch.int32), work, live


def dense_mxu_planned_sum(a: torch.Tensor, tile: int = DENSE_TILE) -> tuple[int, int]:
    """The count summed over the planned blocks alone, and the number of k
    steps planned: ``sum over live (i, j), planned k of sum(A_ij * (A_ik @
    A_kj))``. Equal to the full count for any {0,1} ``a``, as every block
    left out is a product with a zero block."""
    n = a.shape[0]
    occ = dense_mxu_occupancy_reference(a, tile)
    nt = occ.shape[0]
    order, work, live = dense_mxu_plan(occ)
    af = a.to(torch.float64)
    total, steps = 0, 0
    for t in order[: int(live)].tolist():
        i, j = divmod(t, nt)
        rows = slice(i * tile, min(n, (i + 1) * tile))
        cols = slice(j * tile, min(n, (j + 1) * tile))
        ks = torch.nonzero(occ[i] & occ[:, j]).flatten().tolist()
        steps += len(ks)
        prod = sum(af[rows, k * tile : (k + 1) * tile] @ af[k * tile : (k + 1) * tile, cols]
                   for k in ks)
        total += int((prod * af[rows, cols]).sum())
    return total, steps


def _kernels():
    from repro_torch.kernels._build import load_library

    lib = load_library("tc_dense_mxu")
    occ, mxu = lib.tc_dense_occupancy, lib.tc_dense_mxu
    if occ.argtypes is None:
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        occ.argtypes = [vp, ll, ci, vp, vp]
        occ.restype = ctypes.c_int
        mxu.argtypes = [vp, vp, ll, ci, vp, vp, vp, vp, vp, vp, ci, vp]
        mxu.restype = ctypes.c_int
    return occ, mxu


def _plan_group(n: int, dev: torch.device) -> int:
    """Group tiles for L2 reuse only when A and A^T do not fit in L2: when
    they do, grouping buys no bytes and only delays the heaviest tiles."""
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 50 << 20)
    return 1 if 2 * n * n <= l2 else PLAN_GROUP


def _aligned(t: torch.Tensor) -> bool:
    return t.stride(1) == 1 and t.stride(0) % 16 == 0 and t.data_ptr() % 16 == 0


def dense_mxu_tc_cuda(a: torch.Tensor, out: torch.Tensor,
                      steps: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernels: ``out += sum(a * (a @ a))`` in place.

    ``a`` a square int8 CUDA tensor of {0,1} with unit column stride (a row
    stride that is a multiple of 16 bytes, as ``dense_mxu_operand`` gives,
    saves a copy), ``out`` a one-element int64 tensor on the same card.
    ``steps`` (one int64 on the card), if given, gains the k steps computed.
    Returns ``out``.
    """
    for name, t, dtype in (("a", a, torch.int8), ("out", out, torch.int64)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if a.device != out.device:
        raise ValueError(f"a is on {a.device}, out on {out.device}")
    if a.dim() != 2 or a.shape[0] != a.shape[1] or (a.shape[0] > 1 and a.stride(1) != 1):
        raise ValueError(f"a must be a square row-major matrix, got {tuple(a.shape)} with "
                         f"strides {a.stride() if a.dim() == 2 else None}")
    if out.numel() != 1:
        raise ValueError(f"out must hold one element, got {tuple(out.shape)}")
    n = a.shape[0]
    if n > MAX_N:
        raise ValueError(f"N = {n} exceeds the kernel's limit of {MAX_N}")
    if steps is not None and (steps.device != out.device or steps.dtype != torch.int64
                              or steps.numel() != 1):
        raise ValueError("steps must be a one-element int64 tensor on out's card")
    if n == 0:
        return out
    dev = out.device
    if not _aligned(a):
        padded = dense_mxu_operand(n, dev)
        padded.copy_(a)
        a = padded
    lda = a.stride(0)
    at = torch.zeros(n, lda, dtype=torch.int8, device=dev)
    at[:, :n].copy_(a.t())
    nt = -(-n // DENSE_TILE)
    occ = torch.empty(nt, nt, dtype=torch.uint8, device=dev)
    occ_fn, mxu_fn = _kernels()
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = occ_fn(a.data_ptr(), lda, n, occ.data_ptr(), stream)
        if err == 0:
            order, _, live = dense_mxu_plan(occ, _plan_group(n, dev))
            nxt = torch.zeros(1, dtype=torch.int32, device=dev)
            err = mxu_fn(a.data_ptr(), at.data_ptr(), lda, n, occ.data_ptr(), order.data_ptr(),
                         live.data_ptr(), nxt.data_ptr(), out.data_ptr(),
                         None if steps is None else steps.data_ptr(), blocks, stream)
    if err != 0:
        what = f"driver error {-err} (a TMA tensor map)" if err < 0 else f"CUDA error {err}"
        raise RuntimeError(f"tc_dense_mxu launch failed: {what}")
    dense_mxu_tc_cuda.launches += 1
    # The dense product's 2 N^3 int8 MACs and the masked sum's 2 N^2 (the
    # occupancy plan that skips empty tiles stays on the card); A and its
    # transpose read once.
    report_cost(2.0 * n**3 + 2.0 * n * n, 2 * n * lda + 8, matmul=True)
    return out


dense_mxu_tc_cuda.launches = 0
