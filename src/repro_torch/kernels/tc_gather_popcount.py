"""Fused gather–AND–popcount: the TCIM execute stage in one pass.

Port of ``src/repro/kernels/tc_gather_popcount.py`` (``gather_total_pallas``,
``gather_segment_totals_pallas``, their references, ``modeled_hbm_bytes``).
The slice stores stay resident on the card; only the work-list index arrays
travel, and the gather happens inside the kernel.

  * ``gather_total_cuda`` — the wrapper of the hand-written CUDA kernel
    ``csrc/tc_gather_popcount.cu`` (its header gives the design and bound).
    It adds into a caller-owned int32 ``out[2]``: ``out[0]`` the popcount
    total, ``out[1]`` the number of pairs with an index past the end of its
    store, which the kernel never reads. It launches on the current stream,
    allocates nothing, and counts its launches in ``gather_total_cuda.launches``.
  * ``GatherTotalLauncher`` — the same kernel bound to stores validated
    once: ``Executor`` builds one at upload, binds it to a count's
    accumulator and stream once, and launches each chunk checking only its
    index tensors.
  * ``gather_total_reference`` — the plain torch version with the same
    contract (negative indices are no-ops; out-of-range indices are counted,
    not read). It runs on any device and is the CPU path. It uses the SWAR
    popcount of ``kernels/common.py``, so the byte-table oracle in
    ``kernels/ref.py`` stays an independent check.
  * ``gather_segment_totals_cuda`` / ``gather_segment_totals_reference`` —
    the same per segment of ``bucket`` pairs (one fused graph each), into a
    caller-owned int32 ``out[G, 2]`` of ``[subtotal, out_of_range]`` rows:
    the cross-graph serving twin.
  * ``SegmentTable`` / ``gather_segment_groups_cuda`` /
    ``gather_segment_groups_reference`` — many such batches (a serve wave's)
    in one launch of the segment kernel for every ``GROUP_CAP`` batches,
    their table passed as the kernel's parameter; each batch's rows lie at
    its offset in one ``[sum of G, 2]`` output. ``gather_segment_totals_cuda``
    is its one-batch case. ``plan_segment_groups`` is the table's layout in
    plain Python: which batches a launch takes, their first blocks and
    their first output rows; ``pack_segment_table`` packs one launch's.

The reference's ``jnp.take`` hands back an all-ones fill row for a positive
index past the end of the store; the port counts such indices instead, and
``CountFuture.result`` raises on them.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.kernels.common import INT32_SAFE_WORDS, report_cost, swar_popcount_u32

__all__ = [
    "GROUP_CAP",
    "GatherTotalLauncher",
    "SegmentGroup",
    "SegmentTable",
    "gather_segment_groups_cuda",
    "gather_segment_groups_reference",
    "gather_segment_totals_cuda",
    "gather_segment_totals_reference",
    "gather_total_cuda",
    "gather_total_reference",
    "modeled_hbm_bytes",
    "pack_segment_table",
    "plan_segment_groups",
]

_WORDS = (1, 2, 4)
_THREADS = 256  # threads a block of the segment kernel: one pair each
GROUP_CAP = 128  # batches one segment launch takes (csrc kGroupCap)

# The segment kernel's parameter: csrc/tc_gather_popcount.cu's SegEntry and
# SegTable, field for field (checked against the library's own layout).
_ENTRY = np.dtype([
    ("row", "<u8"), ("col", "<u8"), ("ridx", "<u8"), ("cidx", "<u8"),
    ("out_row", "<i8"), ("num_pairs", "<i8"),
    ("num_rows", "<i4"), ("num_cols", "<i4"), ("words", "<i4"), ("log2_bucket", "<i4"),
])
_TABLE = np.dtype([
    ("e", _ENTRY, (GROUP_CAP,)),
    ("first_block", "<i4", (GROUP_CAP + 1,)),
    ("count", "<i4"),
])


def gather_total_reference(
    row_data: torch.Tensor,  # [R, W] int32 view of uint32 words
    col_data: torch.Tensor,  # [C, W] int32 view of uint32 words
    row_idx: torch.Tensor,  # [P] int row positions (< 0 = no-op)
    col_idx: torch.Tensor,  # [P] int col positions (< 0 = no-op)
) -> torch.Tensor:
    """Plain version of the kernel -> int32 ``[total, out_of_range]``.

    Gathers with ``index_select`` on clamped indices, ANDs, counts with the
    SWAR popcount and sums the pairs whose indices are both in range and
    non-negative.
    """
    num_rows, num_cols = row_data.shape[0], col_data.shape[0]
    bad = (row_idx >= num_rows) | (col_idx >= num_cols)
    out = torch.zeros(2, dtype=torch.int32, device=row_data.device)
    out[1] = bad.sum()
    if row_idx.numel() == 0 or num_rows == 0 or num_cols == 0:
        return out
    valid = (row_idx >= 0) & (col_idx >= 0) & ~bad
    rows = row_data.index_select(0, row_idx.clamp(0, num_rows - 1))
    cols = col_data.index_select(0, col_idx.clamp(0, num_cols - 1))
    pc = swar_popcount_u32(rows & cols).sum(dim=1)
    out[0] = torch.where(valid, pc, 0).sum()
    return out


def gather_segment_totals_reference(
    row_data: torch.Tensor,  # [R, W] int32 view — stacked row stores
    col_data: torch.Tensor,  # [C, W] int32 view — stacked col stores
    row_idx: torch.Tensor,  # [G * bucket] store-global positions (< 0 = no-op)
    col_idx: torch.Tensor,  # [G * bucket]
    *,
    bucket: int,
) -> torch.Tensor:
    """Plain version of the segment kernel -> int32 ``[G, 2]``.

    Row ``g`` is ``[subtotal, out_of_range]`` over pairs
    ``g * bucket .. (g + 1) * bucket - 1``, with ``gather_total_reference``'s
    contract per pair.
    """
    p = row_idx.shape[0]
    if bucket < 1 or p % bucket:
        raise ValueError(f"{p} pairs do not tile into bucket={bucket} segments")
    g = p // bucket
    num_rows, num_cols = row_data.shape[0], col_data.shape[0]
    bad = (row_idx >= num_rows) | (col_idx >= num_cols)
    out = torch.zeros(g, 2, dtype=torch.int32, device=row_data.device)
    if g == 0:
        return out
    out[:, 1] = bad.reshape(g, bucket).sum(dim=1)
    if num_rows == 0 or num_cols == 0:
        return out
    valid = (row_idx >= 0) & (col_idx >= 0) & ~bad
    rows = row_data.index_select(0, row_idx.clamp(0, num_rows - 1))
    cols = col_data.index_select(0, col_idx.clamp(0, num_cols - 1))
    pc = torch.where(valid, swar_popcount_u32(rows & cols).sum(dim=1), 0)
    out[:, 0] = pc.reshape(g, bucket).sum(dim=1)
    return out


def gather_segment_groups_reference(batches) -> torch.Tensor:
    """Plain version of the grouped segment launch -> int32 ``[sum of G, 2]``.

    ``batches`` are ``(row_data, col_data, row_idx, col_idx, bucket)``; the
    result is each batch's ``gather_segment_totals_reference``, concatenated
    in order.
    """
    return torch.cat([
        gather_segment_totals_reference(row, col, ridx, cidx, bucket=bucket)
        for row, col, ridx, cidx, bucket in batches
    ])


def _cuda_operand(name: str, t: torch.Tensor, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, the stores on {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_stores(row_data: torch.Tensor, col_data: torch.Tensor) -> int:
    """Validate the resident stores; returns W."""
    _cuda_operand("row_data", row_data, None)
    _cuda_operand("col_data", col_data, row_data.device)
    if row_data.dim() != 2 or col_data.dim() != 2:
        raise ValueError("stores must be [rows, W] matrices")
    w = row_data.shape[1]
    if w not in _WORDS or col_data.shape[1] != w:
        raise ValueError(
            f"store widths {row_data.shape[1]} and {col_data.shape[1]} must "
            f"match and be one of {_WORDS}"
        )
    for name, t in (("row_data", row_data), ("col_data", col_data)):
        if t.data_ptr() % (4 * w):
            raise ValueError(f"{name} is not aligned to its {4 * w}-byte rows")
        if t.shape[0] > 2**31 - 1:
            raise ValueError(f"{name} has more rows than int32 indices reach")
    return w


def _check_indices(row_idx: torch.Tensor, col_idx: torch.Tensor, device) -> None:
    _cuda_operand("row_idx", row_idx, device)
    _cuda_operand("col_idx", col_idx, device)
    if row_idx.dim() != 1 or row_idx.shape != col_idx.shape:
        raise ValueError(f"index shapes {row_idx.shape} and {col_idx.shape} differ")


def _check_out(out: torch.Tensor, device, shape: tuple) -> None:
    _cuda_operand("out", out, device)
    if tuple(out.shape) != shape:
        raise ValueError(f"out must have shape {shape}, got {tuple(out.shape)}")


_LIB_CHECKED = False


def _kernel(name: str = "tc_gather_total"):
    from repro_torch.kernels._build import load_library

    global _LIB_CHECKED
    lib = load_library("tc_gather_popcount")
    if not _LIB_CHECKED:
        layout = (ctypes.c_longlong * 5)()
        lib.tc_segment_table_layout.argtypes = [ctypes.c_void_p]
        lib.tc_segment_table_layout.restype = None
        lib.tc_segment_table_layout(ctypes.addressof(layout))
        want = (_TABLE.itemsize, _ENTRY.itemsize, GROUP_CAP,
                _TABLE.fields["first_block"][1], _TABLE.fields["count"][1])
        if tuple(layout) != want:
            raise RuntimeError(f"segment table layout {tuple(layout)} != the packing's {want}")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tc_gather_total.argtypes = [vp, i32, vp, i32, i32, vp, vp, i64, vp, i32, vp]
        lib.tc_gather_total.restype = i32
        lib.tc_gather_segment_groups.argtypes = [vp, vp, vp]
        lib.tc_gather_segment_groups.restype = i32
        _LIB_CHECKED = True
    return getattr(lib, name)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def gather_total_cuda(
    row_data: torch.Tensor,
    col_data: torch.Tensor,
    row_idx: torch.Tensor,
    col_idx: torch.Tensor,
    out: torch.Tensor,
) -> torch.Tensor:
    """Launch the CUDA kernel: ``out += [total, out_of_range]`` in place.

    All operands are contiguous int32 CUDA tensors on one device (the index
    arrays may be views at any offset); raises on anything else, and if the
    launch is refused. Returns ``out``.
    """
    w = _check_stores(row_data, col_data)
    _check_indices(row_idx, col_idx, row_data.device)
    _check_out(out, row_data.device, (2,))
    p = row_idx.shape[0]
    if p == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(
            row_data.data_ptr(), row_data.shape[0],
            col_data.data_ptr(), col_data.shape[0], w,
            row_idx.data_ptr(), col_idx.data_ptr(), p,
            out.data_ptr(), out.device.index, stream,
        )
    _raise_on(err, "tc_gather_total")
    gather_total_cuda.launches += 1
    _report_pairs(p, w)
    return out


gather_total_cuda.launches = 0


class GatherTotalLauncher:
    """``gather_total_cuda``'s kernel bound to stores validated once.

    ``bind(out)`` checks the accumulator and resolves the device's current
    stream once; the callable it returns launches one chunk, checking only
    its index tensors (device, dtype, 1-D shape, contiguity) and the int32
    bound. Call that inside ``torch.cuda.device(out.device)``. Launches
    count in ``gather_total_cuda.launches``.
    """

    __slots__ = ("_stores", "device", "words", "_prefix")

    def __init__(self, row_data: torch.Tensor, col_data: torch.Tensor):
        self.words = _check_stores(row_data, col_data)
        self.device = row_data.device
        self._stores = (row_data, col_data)  # keeps the pointers below alive
        self._prefix = (row_data.data_ptr(), row_data.shape[0],
                        col_data.data_ptr(), col_data.shape[0], self.words)

    def bind(self, out: torch.Tensor):
        _check_out(out, self.device, (2,))
        fn, prefix, device, words = _kernel(), self._prefix, self.device, self.words
        out_ptr, index = out.data_ptr(), device.index
        stream = torch.cuda.current_stream(device).cuda_stream
        i32 = torch.int32

        def launch(row_idx: torch.Tensor, col_idx: torch.Tensor) -> None:
            if (row_idx.device != device or col_idx.device != device
                    or row_idx.dtype != i32 or col_idx.dtype != i32
                    or row_idx.dim() != 1 or row_idx.shape != col_idx.shape
                    or not (row_idx.is_contiguous() and col_idx.is_contiguous())):
                _check_indices(row_idx, col_idx, device)  # raises, naming the fault
            p = row_idx.shape[0]
            if p == 0:
                return
            if p * words > INT32_SAFE_WORDS:
                raise ValueError(f"chunk of {p} pairs x {words} words could overflow int32")
            _raise_on(fn(*prefix, row_idx.data_ptr(), col_idx.data_ptr(), p, out_ptr, index,
                         stream), "tc_gather_total")
            gather_total_cuda.launches += 1
            _report_pairs(p, words)

        return launch


@dataclasses.dataclass(frozen=True)
class SegmentGroup:
    """One launch of the segment kernel over batches ``start .. stop-1``.

    ``first_block[k]`` is batch ``start + k``'s first block and
    ``first_block[-1]`` the launch's block count; ``out_row[k]`` is its
    first row in the wave's ``[sum of G, 2]`` output and ``out_row[-1]``
    the end of the launch's rows.
    """

    start: int
    stop: int
    first_block: tuple[int, ...]
    out_row: tuple[int, ...]


def plan_segment_groups(shapes, cap: int = GROUP_CAP) -> list[SegmentGroup]:
    """Cut a wave of batches, given as ``(pairs, bucket)`` each, into
    launches of at most ``cap`` batches, with each batch's first block
    (``ceil(pairs / 256)`` blocks a batch; none for an empty one) and first
    output row (``pairs // bucket`` rows a batch, in wave order)."""
    groups = []
    row = 0
    for start in range(0, len(shapes), cap):
        stop = min(start + cap, len(shapes))
        blocks, rows = [0], [row]
        for pairs, bucket in shapes[start:stop]:
            blocks.append(blocks[-1] + -(-pairs // _THREADS))
            rows.append(rows[-1] + pairs // bucket)
        if blocks[-1] > 2**31 - 1:
            raise ValueError(f"a segment launch of {blocks[-1]} blocks exceeds the grid")
        row = rows[-1]
        groups.append(SegmentGroup(start, stop, tuple(blocks), tuple(rows)))
    return groups


def pack_segment_table(group: SegmentGroup, entries) -> np.ndarray:
    """One launch's parameter table (a ``_TABLE`` record) from its batches'
    ``(row_ptr, col_ptr, ridx_ptr, cidx_ptr, pairs, rows, cols, words,
    bucket)``, with output rows relative to the launch's first row."""
    t = np.zeros((), _TABLE)
    n = group.stop - group.start
    if len(entries) != n or n > GROUP_CAP:
        raise ValueError(f"{len(entries)} entries for a launch of {n} batches (cap {GROUP_CAP})")
    for k, (row, col, ridx, cidx, pairs, rows, cols, words, bucket) in enumerate(entries):
        t["e"][k] = (row, col, ridx, cidx, group.out_row[k] - group.out_row[0], pairs, rows,
                     cols, words, bucket.bit_length() - 1)
    t["first_block"][: n + 1] = group.first_block
    t["count"] = n
    return t


class SegmentTable:
    """A wave of fused batches, validated once and packed as the segment
    kernel's parameter tables, one for every ``GROUP_CAP`` batches.

    ``batches`` are ``(row_data, col_data, row_idx, col_idx, bucket)`` with
    contiguous int32 CUDA tensors on one device; ``bucket`` is a power of
    two that tiles ``row_idx``, and one segment's worst case must fit int32.
    The tables hold raw pointers: the caller keeps the tensors alive, and
    unchanged, while it launches them. ``rows`` is the wave output's row
    count and ``offsets[b]`` batch ``b``'s first row in it.
    """

    __slots__ = ("device", "groups", "offsets", "rows", "tables", "work")

    def __init__(self, batches):
        batches = list(batches)
        if not batches:
            raise ValueError("a segment table needs at least one batch")
        self.device = batches[0][0].device
        words = []
        for row, col, ridx, cidx, bucket in batches:
            p = ridx.shape[0] if ridx.dim() == 1 else -1
            if bucket < 1 or bucket & (bucket - 1) or p < 0 or p % bucket:
                raise ValueError(
                    f"{p} pairs do not tile into power-of-two bucket={bucket} segments"
                )
            w = _check_stores(row, col)
            if row.device != self.device:
                raise ValueError(f"a batch is on {row.device}, the first on {self.device}")
            _check_indices(ridx, cidx, self.device)
            if bucket * w > INT32_SAFE_WORDS:
                raise ValueError(f"segment of {bucket} pairs x {w} words could overflow int32")
            words.append(w)
        self.groups = plan_segment_groups([(b[2].shape[0], b[4]) for b in batches])
        self.offsets = tuple(g.out_row[k] for g in self.groups for k in range(g.stop - g.start))
        self.rows = self.groups[-1].out_row[-1]
        entries = [
            (row.data_ptr(), col.data_ptr(), ridx.data_ptr(), cidx.data_ptr(), ridx.shape[0],
             row.shape[0], col.shape[0], w, bucket)
            for (row, col, ridx, cidx, bucket), w in zip(batches, words)
        ]
        self.tables = [pack_segment_table(g, entries[g.start : g.stop]) for g in self.groups]
        # (pairs, pair-words) of each launch: what it reports to a cost counter.
        self.work = [(sum(e[4] for e in entries[g.start : g.stop]),
                      sum(e[4] * e[7] for e in entries[g.start : g.stop])) for g in self.groups]


def gather_segment_groups_cuda(table: SegmentTable, out: torch.Tensor, group: int) -> torch.Tensor:
    """Launch the segment kernel over ``table.groups[group]``:
    ``out[offset_b + g] += [subtotal, out_of_range]`` of batch ``b``'s
    segment ``g``, for the launch's batches.

    ``out`` is the caller's zeroed, contiguous int32 ``[table.rows, 2]`` on
    the table's device. Raises if the launch is refused. Launches of the
    segment kernel count in ``gather_segment_totals_cuda.launches``, from
    either entry. Returns ``out``.
    """
    _check_out(out, table.device, (table.rows, 2))
    g = table.groups[group]
    if g.first_block[-1] == 0:
        return out  # no pairs: nothing to launch
    fn = _kernel("tc_gather_segment_groups")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(table.tables[group].ctypes.data, out.data_ptr() + 8 * g.out_row[0], stream)
    _raise_on(err, "tc_gather_segment_groups")
    gather_segment_totals_cuda.launches += 1
    pairs, pair_words = table.work[group]
    # Both sides' words, two int32 indices a pair, an int32 pair a segment row.
    report_cost(3.0 * pair_words, 8 * pair_words + 8 * pairs + 8 * (g.out_row[-1] - g.out_row[0]))
    return out


def _report_pairs(pairs: int, words: int) -> None:
    """Report a fused launch over ``pairs`` pairs of ``words``-word slices:
    an AND, a popcount and an add a word; ``modeled_hbm_bytes``."""
    report_cost(3.0 * pairs * words, modeled_hbm_bytes(pairs, words, fused=True))


def gather_segment_totals_cuda(
    row_data: torch.Tensor,
    col_data: torch.Tensor,
    row_idx: torch.Tensor,
    col_idx: torch.Tensor,
    out: torch.Tensor,
    *,
    bucket: int,
) -> torch.Tensor:
    """Launch the segment kernel: ``out[g] += [subtotal, out_of_range]``.

    ``out`` is the caller's zeroed int32 ``[G, 2]`` with
    ``G = len(row_idx) // bucket``; ``bucket`` is a power of two. All
    operands are contiguous int32 CUDA tensors on one device; raises on
    anything else, and if the launch is refused. The one-batch case of
    ``gather_segment_groups_cuda``. Returns ``out``.
    """
    table = SegmentTable([(row_data, col_data, row_idx, col_idx, bucket)])
    if row_idx.shape[0] == 0:
        _check_out(out, table.device, (0, 2))
        return out
    return gather_segment_groups_cuda(table, out, 0)


gather_segment_totals_cuda.launches = 0


def modeled_hbm_bytes(num_pairs: int, words_per_slice: int, *, fused: bool) -> int:
    """Analytic device-memory traffic of the execute stage for ``num_pairs``.

    fused:    indices in, each gathered slice word read once, scalar out.
    unfused:  a separate gather reads the store words *and writes* ``[P, W]``
              operand buffers, then the reduction reads them back — 3x the
              gathered-word traffic plus the same index traffic.
    """
    word_bytes = 4
    gathered = 2 * num_pairs * words_per_slice * word_bytes  # row + col sides
    index = 2 * num_pairs * 4
    out = 4
    if fused:
        return gathered + index + out
    return 3 * gathered + index + out
