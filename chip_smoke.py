#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  1. device   require a card; print its name and power limit
  2. build    compile every CUDA kernel of the path from ``src/repro_torch/
              kernels/csrc`` (one ``nvcc`` per source, all at once) and print
              the ``ptxas -v`` registers and spills and the tensor-core MMA
              opcodes of each library's SASS (bitgemm's must AND-popcount)
  3. kernels  each kernel against its plain torch version on the card, exact
              equality, over word widths, sizes, sentinels, hot indices and
              an out-of-range index that must raise at ``result()``:
              gather_total (P 0, 1, 2, 3, 5, 1000 and 1<<20, index views at
              odd and unequal offsets), gather_segment_totals (buckets 1 ..
              1<<14, G 1 / 3 / 32, all-sentinel tail segments; grouped waves
              of 1, 3, 34 and GROUP_CAP + 1 batches of mixed W, bucket and G,
              one launch for every GROUP_CAP; an out-of-range index in one
              batch of a wave raising at that batch's result() alone), total
              and items
  4. main     ``repro_torch.core.tcim_count`` on ``com-youtube`` at full size
              (the paper's Table II graph, generated from its config and
              seed), a cold and a warm count, each through ``build="auto"``,
              which must take the device build; held against the port's CPU
              path (the host build, whose stage split is logged beside the
              device's) and the exact oracle, with the kernel's launch count
              equal to the device work list's windows (its pow2 bucket over
              the chunk); then ``ego-facebook`` and ``email-enron`` at
              slice_bits 32/64/128, device-built
  4b. build   the device build (``core.build``) bit-identical to the host
              build on the card (graph, SBF stores with their zero rows, work
              list with its ``-1`` padding): ego-facebook and email-enron at
              32/64/128, com-youtube at 64; its stages synchronised one by
              one and its peak memory; ``device_build_async`` under
              ``torch.cuda.set_sync_debug_mode("error")``; the delta work list
              over random edge subsets against the host's; ego-facebook's
              device-built counts under ``pallas_unfused`` and
              ``pallas_items`` (the total and items kernels, a launch a
              window)
  5. timing   CUDA-event times of the kernel (through the executor's bound
              launcher and through gather_total_cuda) and its plain version
              at the host build's chunks of com-youtube, the bound, per-stage
              times and peak memory; the kernel's device time alone from a
              replayed CUDA graph of 50 launches (its sum held to the plain
              version's)
  6. serve    ``repro_torch.launch.tc_serve.TCServer`` on the card over 544
              small tenants (rmat at slice_bits 32 / 64 / 128, fused) and
              ego-facebook, email-enron and com-dblp at full size (solo),
              held against the exact oracle and a CPU server, the wave's 34
              fused batches in one launch of the segment kernel; a cached
              re-serve with no upload, in one launch; the solos in the modes
              gather_then_kernel and pallas_items; a tight budget; an
              injected failure, its batch out of the wave's one launch
  7. serve timing  the segment kernel over a serve wave's cached batches in
              one grouped launch, per call, through the executor's dispatch
              and as device time alone (a CUDA graph of whole-wave
              launches), beside the wave's bound, one launch a batch (no
              grouping) and the plain version; total and items vs plain over
              com-youtube's chunks (each also as device time alone, as in
              phase 5; distinct operands in turns, so that L2 does not hold
              them), fused serving vs the per-graph pool loop in graphs per
              second, serve stages and peak memory
  8. dense kernels  bitgemm (I, J in 1 .. 4039, W 1 / 3 / 8 / 9 / 127 / 255 /
              256 / 1147; random, zero and all-ones words; contiguous
              operands, copied to padded scratch when W is not a multiple of
              4, and row-padded views, read as they lie) and dense_mxu_tc (N
              1 .. 4039, densities 0.02 / 0.3 / 1.0 upper-triangular,
              lower-triangular, full and block-sparse {0,1} matrices) against
              their plain versions, exact, with dense_mxu_tc's k steps
              computed equal to its occupancy plan's; bitgemm must refuse a
              transposed, an int64 and a host operand
  9. dense    ``tcim_count(edges, backend="bitgemm" | "mxu")`` on
              ego-facebook and email-enron at full size against the exact
              oracle (and the port's CPU path on ego-facebook), with launch
              counts (no bitgemm operand copied), stage split and peak memory
              (the mxu count's: A and its transpose); ``metrics.edge_support``
              (the items kernel) and ``baselines.matmul_tc`` on ego-facebook
 10. dense timing  bitgemm at an email-enron chunk beside its bound at the b1
              tensor-core rate (the int8 rate and the popcount unit logged
              beside it), its plain version and ``torch._int_mm`` on the bits
              as {0,1} int8 (checked equal to the kernel); dense_mxu_tc at
              ego-facebook's and email-enron's N (strictly upper-triangular,
              asserted; k steps == the plan's), beside its plain version, its
              bound (the triangular N(N-1)(N-2)/3, the dense 2 N^3 beside it)
              and ``torch._int_mm``
 11. flash cases  flash_attention against its plain version through both
              entries, bf16 (2e-2 elementwise, 1.2e-2 in relative norm per
              query row) and f32 (2e-5, 2e-5), hd 16 / 32 / 64 / 128, causal
              or not: [BH, S, hd] with BH 1 / 3 / 72 and (Sq, Sk) from (1, 1)
              to (2048, 2048), ragged and offset (Sq < Sk); [B, S, H, hd] with
              B 1 / 3, (H, KH) (9, 3) / (4, 1), ragged and offset; reversed,
              permuted and keys-after-queries positions (rows with no visible
              key equal the mean of V); the kernel's count of scored KV tiles
              equal to the skip rule's in every case; an unsupported hd must
              raise
 12. LM serve  ``repro_torch.launch.serve.ServeSession`` with smollm-135m at
              full width (30 layers, random weights from seed 0): 8 prompts of
              4096 tokens and 32 generated, with 30 flash launches in prefill
              and none in decode; held against ``attention_impl="xla"`` on
              the same weights (prefill logits, every layer's KV cache, the
              logits at every position of two prompts and teacher-forced
              decode logits within 3e-2 in relative norm, layer 0's cache
              equal, both beside a float32 run of the same weights; a kernel
              planted to drop one KV tile must exceed the bound; prefill_s
              here, its flash share in phase 13); a float32
              run (equal tokens, 1e-3 elementwise); one prefill_32k sequence
              (32,768 tokens) against xla too
 13. flash timing  the kernel at the two prefill shapes (8 x 4096 and
              1 x 32,768, H 9, KH 3, hd 64, causal) through the [B, S, H, hd]
              entry, held to its plain version row by row (a planted dropped
              KV tile must fail that check) and its scored tiles to the skip
              rule, beside its bound, its plain version and
              ``scaled_dot_product_attention`` (enable_gqa) on the same
              operands

 14. stream   ``repro_torch.core.StreamingTCState`` / ``tcim_count_delta`` on
              the card (``build="auto"``: device delta work lists, the fused
              kernel through the stream's private executor, in-place store
              edits), benchmarks/bench_streaming.py's protocol at full size:
              roadnet-pa and email-enron at batch fractions 0.1 / 1 / 5 % of
              |E|, ego-facebook at 1 %; a held-out batch, one warm add/remove
              cycle, 3 measured rounds. Every batch's running count equal to
              ``verify()`` (a device-build recount), each fraction's end to
              the exact oracle and both recounts (warm device-build
              ``tcim_count``; host build + a fresh Executor, the bench's);
              launches equal to the delta work lists' windows; steady batches
              adopt nothing, upload no store bytes and build no library; no
              "auto" fallback. On email-enron at 1 % a before-count held in
              the stream's queue by ``torch.cuda._sleep`` while the stores
              are edited in place, and while they are re-adopted after
              growth (launcher rebuilt), both equal to the CPU path's. On
              roadnet-pa a remove-heavy run to a zero-record ratio above 0.5,
              ``compact()``, then ``spill()`` and a re-admitting batch. Logs
              ms a batch, the ``timings_s`` split, pairs, edges/s, launches,
              the store edit's device time, bytes uploaded, recount times,
              seed time and peak memory
 15. stream serve  ``TCServer`` with a WAL root: roadnet-pa (95 % of its
              edges) and email-enron (99 %) under a budget that holds one, so
              streams spill and re-admit; 12 deltas drained, 8 left pending,
              the server abandoned; ``TCServer.restore`` on the card and on
              the CPU replay and drain to the counts of a never-killed
              server (and the oracle), the restored servers' ``server_stats``
              equal; a root written by ``checkpoint()`` restored too

Each path's kernel launch counts are set to 0 just before the path runs and
read just after it.

The last two lines are a ``{"kernels": [...]}`` JSON object and
``{"ok": true, "device": {...}}``. Imports ``torch``, ``numpy`` and the port
only: no JAX, nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MAIN_GRAPH = "com-youtube"
MAIN_SLICE_BITS = 64
JAX_PACKAGE_COUNT = 3_090_378  # the JAX package's count of the same graph, for the log
SMALL_GRAPHS = ("ego-facebook", "email-enron")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM non-tensor-core rate (float32 table entry)
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate
POPC_PER_CLOCK_PER_SM = 16  # __popc issue rate, compute capability 9.0 (CUDA C++ Programming Guide)
# The b1 MMA's k step is 256 one-bit products in the 32 bytes a row that
# carry 32 int8 products at the int8 rate, so its rate in bit products is 8
# times int8's; tools/kernel_levers.py's probe measures 7.98 x on an H100.
B1_TENSOR_OPS_PER_S = 8 * INT8_TENSOR_OPS_PER_S
KERNEL_SOURCES = ("tc_gather_popcount", "slice_and_popcount", "tc_bitgemm", "tc_dense_mxu",
                  "flash_attention")
MIX_N = (64, 96, 128, 192, 256, 384, 512, 768)  # benchmarks/bench_serve.py's mix
EDGE_FACTOR = 6
NUM_TENANTS = 512  # at slice_bits 64
NUM_TENANTS_SIDE = 16  # at slice_bits 32 and at 128 each
SOLO_GRAPHS = ("ego-facebook", "email-enron", "com-dblp")
SEGMENT_BUCKETS = (1, 2, 16, 32, 64, 1024, 1 << 14)
GATHER_PAIRS = (0, 1, 2, 3, 5, 1000, 1 << 20)
GATHER_OFFSETS = ((0, 0), (1, 1), (3, 3), (1, 2), (0, 3))  # index views' (row, col) element offsets
GROUP_WAVES = (1, 3, 34)  # batches in a grouped segment wave, and GROUP_CAP + 1
DENSE_GRAPHS = ("ego-facebook", "email-enron")
DENSE_BACKENDS = ("bitgemm", "mxu")
BITGEMM_SIZES = (1, 31, 64, 129, 4039)
BITGEMM_WORDS = (1, 3, 8, 9, 127, 255, 256, 1147)
MXU_SIZES = (1, 33, 255, 256, 257, 4039)
MXU_DENSITIES = (0.02, 0.3, 1.0)
BITGEMM_CHUNK_ROWS = 2048  # tcim's bitgemm backend
NO_POPCOUNT_OP = "torch has no popcount op"
GRAPH_LAUNCHES = 50  # kernel launches in one CUDA graph: device time without the wrapper's
WAVE_GRAPH_LAUNCHES = 20  # whole-wave segment launches in one CUDA graph
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
FLASH_BH = (1, 3, 72)
FLASH_SHAPES = ((1, 1), (64, 64), (100, 100), (128, 128), (256, 128), (64, 256), (517, 1030),
                (2048, 2048))
FLASH_GQA_B = (1, 3)
FLASH_GQA_HEADS = ((9, 3), (4, 1))  # (H, KH)
FLASH_GQA_SHAPES = ((1, 1), (128, 128), (100, 300), (517, 1030))  # ragged, offset queries
FLASH_POSITIONS = ("reversed", "permuted", "keys after queries")
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}  # tests/test_flash_and_cost.py's own
# Largest per-row ||got - want|| / ||want|| over query rows, ``want`` being
# the plain version's output before its last rounding. Outputs shrink as
# rows see more keys (about 0.01 at S 32,768), so an elementwise 2e-2 cannot
# see a wrong late row. The kernel's bf16 output rounding alone is up to
# 2^-8 of each element (3.9e-3 of a row); its weights are rounded at another
# scale than the plain version's. Read on an H100: at most 8.1e-3 (hd 16),
# 4.8e-3 at the prefill shapes; one KV tile dropped: at least 1.4e-2.
FLASH_ROW_TOL = {"bfloat16": 1.2e-2, "float32": 2e-5}
LM_ARCH = "smollm-135m"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 4096, 32
LM_LONG = 32768  # one prefill_32k sequence (configs/shapes.py)
LM_TOL = 3e-2  # the reference's flash-vs-xla bound (tests/test_flash_and_cost.py), here in relative norm
# The stream phases: benchmarks/bench_streaming.py's batch fractions and
# rounds at full size; roadnet-pa (no hubs, so a raw-id stream is cheap to
# seed), email-enron (the bench's gated fixture) and ego-facebook at 1 %.
STREAM_GRAPHS = (("roadnet-pa", (0.001, 0.01, 0.05)), ("email-enron", (0.001, 0.01, 0.05)),
                 ("ego-facebook", (0.01,)))
STREAM_SLICE_BITS = 64
STREAM_ROUNDS = 3  # measured add/remove cycles per fraction, after one warm cycle
STREAM_CHECK_FRACTION = 0.01  # email-enron's: the before-count checks stand in for its warm cycle
STREAM_COMPACT_GRAPH = "roadnet-pa"
STREAM_STALL_CYCLES = 1_000_000_000  # torch.cuda._sleep ahead of a checked before-count (~0.5 s)
SERVE_STREAMS = (("roadnet-pa", 0.95), ("email-enron", 0.99))  # (graph, share of edges seeded)
SERVE_DELTAS = 20  # the held-out edges in 20 deltas, alternating between the streams
SERVE_DRAINED = 12  # drained before the kill; the other 8 stay pending


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return 1e6 * float(out.splitlines()[0])


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s); card 0: {name}")
    log(f"[device] nvidia-smi: {nvidia_smi_line()}; max SM clock {sm_clock_hz() / 1e6:.0f} MHz; "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    return name


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.compile_sources(KERNEL_SOURCES)
    log(f"[build] {len(libs)} kernel source(s) built in {time.perf_counter() - t0:.2f} s")
    for name in KERNEL_SOURCES:
        for line in _build.ptxas_report(name):
            log(f"[build] {name}: {line}")
        log(f"[build] {name}: SASS MMA opcodes {_build.sass_mma_opcodes(name)}")
    bitgemm_mma = [op for op in _build.sass_mma_opcodes("tc_bitgemm") if "POPC" in op]
    check(bool(bitgemm_mma), "tc_bitgemm's SASS holds no AND-popcount tensor-core MMA")


def _words(rng, rows: int, w: int) -> torch.Tensor:
    a = rng.integers(0, 2**32, size=(rows, w), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).cuda()


def _compare(row, col, ridx, cidx) -> tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.kernels.tc_gather_popcount import (
        gather_total_cuda,
        gather_total_reference,
    )

    got = gather_total_cuda(row, col, ridx, cidx, torch.zeros(2, dtype=torch.int32, device="cuda"))
    want = gather_total_reference(row, col, ridx, cidx)
    torch.cuda.synchronize()
    return got.cpu(), want.cpu()


def phase_kernel_cases() -> int:
    """gather_total: kernel == plain version on the card; returns max |err|."""
    from repro_torch.core.executor import CountFuture

    log("[kernels] tolerance: exact equality (integer counts, any order of adds)")
    rng = np.random.default_rng(0)
    max_err = 0
    num_rows, num_cols = 50_000, 30_011
    for w in (1, 2, 4):
        row, col = _words(rng, num_rows, w), _words(rng, num_cols, w)
        for p in GATHER_PAIRS:
            r = rng.integers(0, num_rows, size=p + 3).astype(np.int32)
            c = rng.integers(0, num_cols, size=p + 3).astype(np.int32)
            r[rng.random(p + 3) < 0.1] = -1  # sentinels on either side
            c[rng.random(p + 3) < 0.1] = -1
            hot = rng.random(p + 3) < 0.25  # repeated hot indices
            r[hot], c[hot] = 7, 11
            r_all, c_all = torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda()
            # Index views at offsets 0, odd and even-not-16-byte, the same on
            # both sides (the int4 path after a scalar head) or not (the
            # scalar path); the arrays hold 3 more pairs, never to be read.
            for ro, co in GATHER_OFFSETS:
                got, want = _compare(row, col, r_all[ro : ro + p], c_all[co : co + p])
                err = int((got.long() - want.long()).abs().max())
                max_err = max(max_err, err)
                check(torch.equal(got, want),
                      f"W={w} P={p} offsets {ro, co}: kernel {got.tolist()} != plain {want.tolist()}")
            log(f"[kernels] gather_total W={w} P={p}: {got.tolist()} == plain at index offsets "
                f"{list(GATHER_OFFSETS)}")
    # One out-of-range index per side: counted, never read, raised at result().
    row, col = _words(rng, num_rows, 2), _words(rng, num_cols, 2)
    for side in ("row", "col"):
        r = rng.integers(0, num_rows, size=1000).astype(np.int32)
        c = rng.integers(0, num_cols, size=1000).astype(np.int32)
        if side == "row":
            r[500] = num_rows + 5
        else:
            c[500] = num_cols
        got, want = _compare(row, col, torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda())
        check(torch.equal(got, want) and int(got[1]) == 1, f"out-of-range {side}: {got.tolist()} vs {want.tolist()}")
        try:
            CountFuture([got.cuda()]).result()
        except ValueError as e:
            log(f"[kernels] out-of-range {side} index raised at result(): {e}")
        else:
            raise RuntimeError(f"out-of-range {side} index did not raise at result()")
    return max_err


def _edges(cfg) -> np.ndarray:
    from repro_torch.graphs import GRAPH_GENERATORS

    gen = GRAPH_GENERATORS[cfg.generator]
    if cfg.generator == "grid_road":
        return gen(cfg.n, seed=cfg.seed)
    return gen(cfg.n, cfg.m, seed=cfg.seed)


def phase_main() -> dict:
    """The main path on the card (``build="auto"``: the device build), a
    cold and a warm count, held against the CPU path (the host build, whose
    stage split is logged beside the device's) and the oracle."""
    from repro_torch.configs import GRAPHS
    from repro_torch.core import tcim_count
    from repro_torch.core.plan import clamp_chunk_pairs, pow2_ceil
    from repro_torch.graphs import build_graph, triangles_intersection
    from repro_torch.kernels.tc_gather_popcount import gather_total_cuda

    cfg = GRAPHS[MAIN_GRAPH]
    t0 = time.perf_counter()
    edges = _edges(cfg)
    log(f"[main] {cfg.name}: generated |V|={cfg.n} |E|={len(edges)} in {time.perf_counter() - t0:.2f} s")

    chunk = clamp_chunk_pairs(1 << 20, MAIN_SLICE_BITS // 32)
    runs = {}
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gather_total_cuda.launches = 0
        t0 = time.perf_counter()
        res = tcim_count(edges, slice_bits=MAIN_SLICE_BITS)
        wall = time.perf_counter() - t0
        launches = gather_total_cuda.launches
        peak = torch.cuda.max_memory_allocated()
        # The device work list is -1-padded to its pow2 bucket; the executor
        # runs it in windows of `chunk` pairs, one launch a window.
        windows = math.ceil(pow2_ceil(res.stats["num_pairs"]) / chunk)
        log(f"[main] card, {label} count: {res.triangles} triangles, build "
            f"{res.stats['build']!r}, {res.stats['num_pairs']} slice pairs, {windows} windows, "
            f"{launches} kernel launches, {wall:.6f} s wall; max_memory_allocated {peak} bytes")
        log(f"[main] card, {label} count, timings_s: {json.dumps(res.timings_s)}")
        check(res.stats["device"].startswith("cuda"), f"main path ran on {res.stats['device']}")
        check(res.stats["build"] == "device", f"build='auto' on the card took {res.stats['build']!r}")
        check(launches == windows, f"kernel launched {launches} times for {windows} windows")
        runs[label] = {"result": res, "wall": wall, "launches": launches, "peak": peak}

    t0 = time.perf_counter()
    cpu = tcim_count(edges, slice_bits=MAIN_SLICE_BITS, device="cpu")
    log(f"[main] port CPU path: {cpu.triangles} triangles, build {cpu.stats['build']!r}, "
        f"{time.perf_counter() - t0:.6f} s wall")
    log(f"[main] host build split (the CPU path's timings_s; its orient, compress and schedule "
        f"are the host front end): {json.dumps(cpu.timings_s)}")
    check(cpu.stats["build"] == "host", f"the CPU path took build {cpu.stats['build']!r}")
    t0 = time.perf_counter()
    g = build_graph(edges, reorder=True)
    exact = triangles_intersection(g)
    log(f"[main] exact oracle (triangles_intersection): {exact} in {time.perf_counter() - t0:.2f} s")
    log(f"[main] JAX package's count of this graph, for reference: {JAX_PACKAGE_COUNT}")
    for label, run in runs.items():
        got = run["result"]
        check(got.triangles == cpu.triangles == exact,
              f"card ({label}) {got.triangles}, CPU {cpu.triangles}, oracle {exact}")
        check(got.stats["num_pairs"] == cpu.stats["num_pairs"] and got.stats["nvs"] == cpu.stats["nvs"],
              f"card ({label}) stats {got.stats} != CPU path's {cpu.stats}")

    for name in SMALL_GRAPHS:
        small = _edges(GRAPHS[name])
        want = triangles_intersection(build_graph(small, reorder=True))
        for bits in (32, 64, 128):
            res = tcim_count(small, slice_bits=bits)
            check(res.triangles == want and res.stats["build"] == "device",
                  f"{name} slice_bits={bits}: card {res.triangles} ({res.stats['build']}) != oracle {want}")
            log(f"[main] {name} slice_bits={bits}: {res.triangles} == oracle (device build)")
    cold = runs["cold"]
    return {"graph": g, "edges": edges, "launches": cold["launches"], "result": cold["result"],
            "peak": cold["peak"], "warm": runs["warm"], "host_timings": cpu.timings_s}


def _check_build_identical(db, g, sb, wl, label: str) -> None:
    """A device build == the host build of the same graph, array for array
    (dtypes too), with the stores' zero rows and the pairs' -1 padding."""
    from repro_torch.core.plan import pow2_ceil

    gh = db.graph.to_host()
    for f in ("edges", "indptr", "indices"):
        check(np.array_equal(getattr(gh, f), getattr(g, f)), f"{label}: graph {f} differs")
    dsb, dwl = db.to_host()
    for f in ("row_ptr", "row_slice_idx", "row_slice_data", "col_ptr", "col_slice_idx",
              "col_slice_data"):
        a, b = getattr(dsb, f), getattr(sb, f)
        check(a.dtype == b.dtype and np.array_equal(a, b), f"{label}: sbf {f} differs")
    for f in ("pair_edge", "pair_row_pos", "pair_col_pos"):
        check(np.array_equal(getattr(dwl, f), getattr(wl, f)), f"{label}: worklist {f} differs")
    p = wl.num_pairs
    for f in ("pair_edge", "pair_row_pos", "pair_col_pos"):
        pad = getattr(db.worklist, f)
        check(len(pad) == pow2_ceil(max(p, 1)) and bool((pad[p:] == -1).all()),
              f"{label}: {f} is not -1-padded to its pow2 bucket")
    for side, valid in (("row", db.sbf.row_valid), ("col", db.sbf.col_valid)):
        store = getattr(db.sbf, f"{side}_slice_data")
        check(store.shape[0] == pow2_ceil(max(valid, 1)) and not bool(store[valid:].any()),
              f"{label}: {side} store is not zero-padded to its pow2 rows")


def _device_intervals(events) -> list[tuple[float, float]]:
    """Merged [start, end) microsecond intervals of the profiled device
    activity (kernels and copies)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    merged: list[list[float]] = []
    for start, end in spans:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(m) for m in merged]


def _profile_count(edges: np.ndarray) -> None:
    """One warm device-built count under ``torch.profiler``: the device's
    busy share of the count's wall, and its device time by torch op."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import tcim_count

    tcim_count(edges, slice_bits=MAIN_SLICE_BITS)  # warm: pool entry, lazy modules
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = tcim_count(edges, slice_bits=MAIN_SLICE_BITS)
        wall = time.perf_counter() - t0
    check(res.triangles == JAX_PACKAGE_COUNT, f"profiled count {res.triangles}")
    busy = sum(end - start for start, end in _device_intervals(prof.events()))
    if busy == 0:
        log("[device build] profiled count: the profiler recorded no device activity; the "
            "device's busy share is not measured")
        return
    # Each op's own kernels (its children's are theirs): a partition of the
    # device time by torch op.
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::") and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    log(f"[device build] profiled warm count (torch.profiler, CPU + CUDA): {wall:.6f} s wall "
        f"under the profiler, device busy {busy / 1e6:.6f} s = {100 * busy / (1e6 * wall):.2f} % "
        f"of it; timings_s {json.dumps(res.timings_s)}")
    for e in ops[:10]:
        log(f"[device build]   {e.key}: {e.self_device_time_total / 1e3:.3f} ms on the device, "
            f"{e.count} calls")


def phase_device_build(main: dict) -> None:
    """The device build on the card: bit-identical to the host build, its
    synchronised stage split and peak, no host sync inside
    ``device_build_async``, the delta work list, and the unfused backends
    over a device build. Leaves com-youtube's host SBF and work list in
    ``main`` for the timing phase."""
    from repro_torch.configs import GRAPHS
    from repro_torch.core import (
        build_sbf,
        build_worklist,
        build_worklist_pairs,
        device_build,
        device_build_async,
        device_build_sbf,
        device_build_worklist,
        device_delta_worklist,
        tcim_count,
    )
    from repro_torch.core.plan import clamp_chunk_pairs, pow2_ceil
    from repro_torch.graphs import build_graph, csr, device_orient, triangles_intersection

    cases = [(name, bits) for name in SMALL_GRAPHS for bits in (32, 64, 128)]
    for name, bits in cases + [(MAIN_GRAPH, MAIN_SLICE_BITS)]:
        if name == MAIN_GRAPH:
            edges, g = main["edges"], main["graph"]
        else:
            edges = _edges(GRAPHS[name])
            g = build_graph(edges, reorder=True)
        t0 = time.perf_counter()
        sb = build_sbf(g, bits)
        wl = build_worklist(g, sb)
        host_s = time.perf_counter() - t0
        db = device_build(edges, slice_bits=bits)
        _check_build_identical(db, g, sb, wl, f"{name} slice_bits={bits}")
        log(f"[device build] {name} slice_bits={bits}: graph, SBF ({db.sbf.row_valid} + "
            f"{db.sbf.col_valid} records) and work list ({wl.num_pairs} pairs) identical to the "
            f"host build ({host_s:.3f} s of host compress + schedule)")
        if name == MAIN_GRAPH:
            main["sbf"], main["worklist"] = sb, wl
    del db

    # The stages one by one, each synchronised, and the build's peak memory.
    edges = main["edges"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    dg = device_orient(edges)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dsb = device_build_sbf(dg, MAIN_SLICE_BITS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dwl = device_build_worklist(dg, dsb)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() - base
    padded = np.full((pow2_ceil(len(edges)), 2), main["graph"].n, dtype=np.int32)
    padded[: len(edges)] = edges
    t_hash = time.perf_counter()
    csr.content_key(padded, len(edges), main["graph"].n, True)
    t_hash = time.perf_counter() - t_hash
    check(dwl.num_pairs == main["worklist"].num_pairs, "granular stages' pair count")
    log(f"[device build] {MAIN_GRAPH}, stages synchronised one by one: orient {t1 - t0:.6f} s "
        f"(of it the host's blake2b content key over the {4 * padded[: len(edges)].size}-byte "
        f"int32 edge list, timed alone: {t_hash:.6f} s), compress {t2 - t1:.6f} s (with the [row_nvs, col_nvs] readback), "
        f"schedule {t3 - t2:.6f} s (with the candidate and pair readbacks), "
        f"{dwl.num_candidates} candidates in a bucket of {pow2_ceil(dwl.num_candidates)} lanes, "
        f"{dwl.num_pairs} pairs in {len(dwl.pair_row_pos)}; peak above the held memory "
        f"{peak} bytes (max_memory_allocated)")
    del dg, dsb, dwl

    # No host sync between the upload and result(): any raises here.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fut = device_build_async(edges, slice_bits=MAIN_SLICE_BITS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    db = fut.result()
    check(db.worklist.num_pairs == main["worklist"].num_pairs, "async build's pair count")
    log(f"[device build] device_build_async ran under torch.cuda.set_sync_debug_mode('error') "
        f"with no host sync; its result() has {db.worklist.num_pairs} pairs, as the host build")
    _profile_count(edges)

    # Delta work lists over random edge subsets, against the host's pairs.
    rng = np.random.default_rng(0)
    for name, frac in (("ego-facebook", 0.2), (MAIN_GRAPH, 0.1)):
        if name == MAIN_GRAPH:
            g, sb, dsb = main["graph"], main["sbf"], db.sbf
        else:
            g = build_graph(_edges(GRAPHS[name]), reorder=True)
            sb = build_sbf(g, MAIN_SLICE_BITS)
            dsb = device_build(_edges(GRAPHS[name]), slice_bits=MAIN_SLICE_BITS).sbf
        pick = np.sort(rng.choice(g.m, size=int(frac * g.m), replace=False))
        src, dst = g.edges[pick, 0], g.edges[pick, 1]
        want = build_worklist_pairs(src, dst, sb)
        for over, kind in ((sb, "host"), (dsb, "device")):
            dw = device_delta_worklist(src, dst, over).to_host()
            got = (dw.pair_edge, dw.pair_row_pos, dw.pair_col_pos)
            check(all(np.array_equal(a, b) for a, b in zip(got, want)),
                  f"{name}: delta work list over the {kind} SBF differs from the host's")
        log(f"[device build] {name}: delta work list of {len(src)} edges ({len(want[0])} pairs) "
            f"over the host and the device SBF == host build_worklist_pairs")
    del db

    # Kernels 3 and 4 over a device build (the unfused backends).
    edges = _edges(GRAPHS["ego-facebook"])
    want = triangles_intersection(build_graph(edges, reorder=True))
    wrappers = _wrappers()
    for backend, kernel in (("pallas_unfused", "total"), ("pallas_items", "items")):
        _reset_launches()
        res = tcim_count(edges, backend=backend)
        launches = _launches()
        windows = math.ceil(pow2_ceil(res.stats["num_pairs"])
                            / clamp_chunk_pairs(1 << 20, MAIN_SLICE_BITS // 32))
        check(res.triangles == want and res.stats["build"] == "device",
              f"ego-facebook {backend}: {res.triangles} ({res.stats['build']}) != oracle {want}")
        check(launches[kernel] == windows and wrappers[kernel].launches == windows,
              f"ego-facebook {backend}: {launches} for {windows} windows")
        log(f"[device build] ego-facebook {backend}: {res.triangles} == oracle over the device "
            f"build, {kernel} launched {launches[kernel]} times ({windows} windows)")


def _time_ms(fn, calls: list, rounds: int) -> float:
    """Mean ms per call of ``fn(*args)`` over ``rounds`` passes of ``calls``."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        for args in calls:
            fn(*args)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (rounds * len(calls))


def _graph(fn, calls: list, launches: int = GRAPH_LAUNCHES) -> torch.cuda.CUDAGraph:
    """A CUDA graph of ``launches`` launches of ``fn(*args)``, cycling
    through ``calls``: replayed, the kernels run back to back with none of
    the wrapper's host work between them. The wrapper's launch count grows
    by ``launches`` at capture and not at a replay."""
    fn(*calls[0])  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(launches):
            fn(*calls[k % len(calls)])
    return graph


def _graph_uses(k: int, n: int, launches: int = GRAPH_LAUNCHES) -> int:
    """Launches of the ``k``-th of ``n`` calls in a graph from ``_graph``."""
    return len(range(k, launches, n))


def _replay_ms(graph: torch.cuda.CUDAGraph, launches: int = GRAPH_LAUNCHES,
               replays: int = 10) -> float:
    """Device ms a launch: mean over ``replays`` replays of the graph."""
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * launches)


def phase_timing(main: dict) -> tuple:
    """Kernel vs plain at the main path's shapes (W=2, P=1<<20 chunks over
    the com-youtube stores); returns the kernel's JSON row, max |err|, and
    the chunks and resident stores for the serve timing phase."""
    from repro_torch.core import Executor
    from repro_torch.core.plan import pow2_ceil
    from repro_torch.kernels.tc_gather_popcount import (
        gather_total_cuda,
        gather_total_reference,
    )

    sb, wl = main["sbf"], main["worklist"]  # the host build of phase 4b
    ex = Executor(sb)  # the resident, pow2-padded stores the main path uses
    row, col = ex.row_data, ex.col_data
    chunks = []
    for ridx, cidx in ex._chunks(wl.pair_row_pos, wl.pair_col_pos):
        chunks.append((torch.from_numpy(ridx).cuda(), torch.from_numpy(cidx).cuda()))
    check(all(len(r) == pow2_ceil(len(r)) for r, _ in chunks), "chunks are pow2 buckets")

    max_err = 0
    totals = []
    bound_s = 0.0
    for ridx, cidx in chunks:
        got, want = _compare(row, col, ridx, cidx)
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"main-path chunk: kernel {got.tolist()} != plain {want.tolist()}")
        totals.append(int(want[0]))
        # Least bytes: both index arrays, each distinct store row named once, out.
        w = row.shape[1]
        rows_read = torch.unique(ridx[(ridx >= 0) & (cidx >= 0)]).numel()
        cols_read = torch.unique(cidx[(ridx >= 0) & (cidx >= 0)]).numel()
        nbytes = 8 * len(ridx) + 4 * w * (rows_read + cols_read) + 8
        ops = 3 * w * len(ridx)  # AND, popc, add per word
        bound_s += max(nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S)
    check(sum(totals) == main["result"].triangles, f"chunk totals {sum(totals)} != count")
    bound_ms = 1e3 * bound_s / len(chunks)

    out = torch.zeros(2, dtype=torch.int32, device="cuda")
    kernel_calls = [(row, col, r, c, out) for r, c in chunks]
    _time_ms(gather_total_cuda, kernel_calls, 1)  # warm-up
    rounds = max(2, math.ceil(20 / len(chunks)))
    wrapper_ms = _time_ms(gather_total_cuda, kernel_calls, rounds)
    # The main path's call: the executor's launcher, bound once a count.
    with torch.cuda.device(out.device):
        launch = ex._launcher.bind(out)
        _time_ms(launch, chunks, 1)
        ms = _time_ms(launch, chunks, rounds)
    graph = _graph(gather_total_cuda, kernel_calls)
    out.zero_()
    graph.replay()
    want = sum(totals[k % len(chunks)] for k in range(GRAPH_LAUNCHES))
    check(out.tolist() == [want, 0], f"graph replay: {out.tolist()} != plain [{want}, 0]")
    device_ms = _replay_ms(graph)
    del graph
    plain_calls = [(row, col, r, c) for r, c in chunks]
    _time_ms(gather_total_reference, plain_calls[:2], 1)
    plain_ms = _time_ms(gather_total_reference, plain_calls, 1)
    stores = sb.row_slice_data.nbytes + sb.col_slice_data.nbytes
    whole = (stores + 8 * wl.num_pairs) / HBM_BYTES_PER_S * 1e3
    log(f"[timing] gather_total: {ms:.6f} ms/chunk over {rounds * len(chunks)} launches "
        f"through the executor's bound launcher (P={len(chunks[0][0])}, W={row.shape[1]}); "
        f"{wrapper_ms:.6f} ms/chunk through gather_total_cuda (every check a call); bound "
        f"{bound_ms:.6f} ms/chunk (bytes), {100 * bound_ms / ms:.2f}% of bound; device time "
        f"alone {device_ms:.6f} ms/chunk ({100 * bound_ms / device_ms:.2f}% of bound; a CUDA "
        f"graph of {GRAPH_LAUNCHES} launches over the chunks, replayed; its sum == plain), so "
        f"the launcher costs {ms - device_ms:.6f} ms a call and gather_total_cuda "
        f"{wrapper_ms - device_ms:.6f}; plain version {plain_ms:.6f} ms/chunk; "
        f"library_ms null (torch has no popcount op)")
    log(f"[timing] whole count: {len(chunks)} chunks x {ms:.6f} ms = {len(chunks) * ms:.6f} ms "
        f"kernel time vs {whole:.6f} ms for stores ({stores} B) + indices read once")
    log(f"[timing] main-path timings_s: {json.dumps(main['result'].timings_s)}")
    log(f"[timing] main-path max_memory_allocated: {main['peak']} bytes")
    row_json = {
        "name": "gather_total",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tc_gather_popcount.cu",
        "replaces": "src/repro/kernels/tc_gather_popcount.py:145",
        "launches": main["launches"],
        "max_abs_err": 0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "device_ms": device_ms,
        "wrapper_ms": wrapper_ms,
    }
    return row_json, max_err, chunks, row, col


def _wrappers() -> dict:
    from repro_torch.kernels.slice_and_popcount import items_cuda, total_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.tc_bitgemm import bitgemm_cuda
    from repro_torch.kernels.tc_dense_mxu import dense_mxu_tc_cuda
    from repro_torch.kernels.tc_gather_popcount import (
        gather_segment_totals_cuda,
        gather_total_cuda,
    )

    return {
        "gather_total": gather_total_cuda,
        "gather_segment_totals": gather_segment_totals_cuda,
        "total": total_cuda,
        "items": items_cuda,
        "bitgemm": bitgemm_cuda,
        "dense_mxu_tc": dense_mxu_tc_cuda,
        "flash_attention": flash_attention_cuda,
    }


def _reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def _launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def phase_segment_cases() -> int:
    """gather_segment_totals: kernel == plain version on the card."""
    from repro_torch.core.executor import MultiCountFuture
    from repro_torch.core.plan import pow2_ceil
    from repro_torch.kernels import ops
    from repro_torch.kernels.tc_gather_popcount import (
        gather_segment_totals_cuda,
        gather_segment_totals_reference,
    )

    rng = np.random.default_rng(1)
    max_err = 0
    for w in (1, 2, 4):
        rows_real, cols_real = 20_000, 12_345
        # Stacked stores are pow2-row-padded with zero rows, as the executor
        # uploads them; indices may name the padding (in range, counts 0).
        row = torch.cat([_words(rng, rows_real, w),
                         torch.zeros(pow2_ceil(rows_real) - rows_real, w, dtype=torch.int32, device="cuda")])
        col = torch.cat([_words(rng, cols_real, w),
                         torch.zeros(pow2_ceil(cols_real) - cols_real, w, dtype=torch.int32, device="cuda")])
        for bucket in SEGMENT_BUCKETS:
            for g in (1, 3, 32):
                p = g * bucket
                r = rng.integers(0, row.shape[0], size=p).astype(np.int32)
                c = rng.integers(0, col.shape[0], size=p).astype(np.int32)
                r[rng.random(p) < 0.1] = -1
                c[rng.random(p) < 0.1] = -1
                hot = rng.random(p) < 0.2
                r[hot], c[hot] = 3, 5
                if g > 1:  # all-sentinel trailing segments (padded_graphs)
                    tail = g // 4 * bucket if g > 3 else bucket
                    r[p - tail:], c[p - tail:] = -1, -1
                ridx, cidx = torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda()
                got = gather_segment_totals_cuda(
                    row, col, ridx, cidx,
                    torch.zeros(g, 2, dtype=torch.int32, device="cuda"), bucket=bucket,
                )
                want = gather_segment_totals_reference(row, col, ridx, cidx, bucket=bucket)
                torch.cuda.synchronize()
                got, want = got.cpu(), want.cpu()
                max_err = max(max_err, int((got.long() - want.long()).abs().max()))
                check(torch.equal(got, want),
                      f"segments W={w} bucket={bucket} G={g}: kernel != plain")
                if g > 1:
                    check(int(got[-1].abs().sum()) == 0, "all-sentinel tail segment not 0")
        log(f"[kernels] gather_segment_totals W={w}: buckets {list(SEGMENT_BUCKETS)} x "
            f"G {{1, 3, 32}} == plain")
    # An out-of-range row index in segment 1 of 3: counted there, never
    # read, and raised at MultiCountFuture.result().
    row, col = _words(rng, 1024, 2), _words(rng, 512, 2)
    bucket = 64
    r = rng.integers(0, 1024, size=3 * bucket).astype(np.int32)
    c = rng.integers(0, 512, size=3 * bucket).astype(np.int32)
    r[bucket + 7] = 1024 + 9
    ridx, cidx = torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda()
    out = ops.popcount_and_gather_segment_totals(row, col, ridx, cidx, bucket=bucket)
    want = gather_segment_totals_reference(row, col, ridx, cidx, bucket=bucket)
    check(torch.equal(out.cpu(), want.cpu()) and out[:, 1].tolist() == [0, 1, 0],
          f"out-of-range segment: {out.tolist()} vs {want.tolist()}")
    try:
        MultiCountFuture(out, 3).result()
    except ValueError as e:
        log(f"[kernels] out-of-range fused index raised at MultiCountFuture.result(): {e}")
    else:
        raise RuntimeError("out-of-range fused index did not raise at result()")
    return max(max_err, _group_cases(rng), _wave_out_of_range(rng))


def _segment_batch(rng, w: int, bucket: int, g: int) -> tuple:
    """One fused batch on the card: pow2-padded stores, G segments of
    ``bucket`` pairs with sentinels, a hot pair and (G > 1) all-sentinel
    trailing segments."""
    from repro_torch.core.plan import pow2_ceil

    rows_real, cols_real = int(rng.integers(100, 3000)), int(rng.integers(100, 3000))
    row = torch.cat([_words(rng, rows_real, w), torch.zeros(pow2_ceil(rows_real) - rows_real, w,
                                                            dtype=torch.int32, device="cuda")])
    col = torch.cat([_words(rng, cols_real, w), torch.zeros(pow2_ceil(cols_real) - cols_real, w,
                                                            dtype=torch.int32, device="cuda")])
    p = g * bucket
    r = rng.integers(0, row.shape[0], size=p).astype(np.int32)
    c = rng.integers(0, col.shape[0], size=p).astype(np.int32)
    r[rng.random(p) < 0.1] = -1
    c[rng.random(p) < 0.1] = -1
    hot = rng.random(p) < 0.2
    r[hot], c[hot] = 3, 5
    if g > 1:
        tail = g // 4 * bucket if g > 3 else bucket
        r[p - tail:], c[p - tail:] = -1, -1
    return row, col, torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda(), bucket


def _group_cases(rng) -> int:
    """The grouped segment kernel == its plain version over waves of 1, 3,
    34 and GROUP_CAP + 1 batches of mixed W, bucket and G, each wave in one
    launch for every GROUP_CAP batches; returns max |err|."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.tc_gather_popcount import (
        GROUP_CAP,
        gather_segment_groups_reference,
        gather_segment_totals_cuda,
    )

    max_err = 0
    for n in (*GROUP_WAVES, GROUP_CAP + 1):
        batches = [_segment_batch(rng, (1, 2, 4)[k % 3], SEGMENT_BUCKETS[k % len(SEGMENT_BUCKETS)],
                                  (1, 3, 32)[k % 3]) for k in range(n)]
        before = gather_segment_totals_cuda.launches
        got = ops.popcount_and_gather_segment_groups(batches)
        launches = gather_segment_totals_cuda.launches - before
        want = gather_segment_groups_reference(batches)
        torch.cuda.synchronize()
        got, want = got.cpu(), want.cpu()
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"grouped wave of {n} batches: kernel != plain")
        check(launches == math.ceil(n / GROUP_CAP), f"wave of {n} batches took {launches} launches")
        log(f"[kernels] grouped segments: a wave of {n} batches (W 1/2/4, buckets "
            f"{sorted({b[4] for b in batches})}, G 1/3/32, all-sentinel tails) == plain in "
            f"{launches} launch(es)")
    return max_err


def _wave_out_of_range(rng) -> int:
    """An out-of-range index in one batch of a fused wave: counted in that
    batch's rows, raised at its future's result() and at no other's."""
    from repro_torch.core import MultiGraphExecutor, build_sbf, build_worklist
    from repro_torch.graphs import build_graph, rmat, triangles_intersection
    from repro_torch.kernels.tc_gather_popcount import gather_segment_totals_cuda

    multi = MultiGraphExecutor()
    job_lists, want = [], []
    for k in range(5):
        jobs, counts = [], []
        for i in range(1 + 3 * k):
            g = build_graph(rmat(64 << (k % 3), 6 * (64 << (k % 3)), seed=1000 * k + i))
            sb = build_sbf(g, (32, 64, 128)[k % 3])
            jobs.append((sb, build_worklist(g, sb)))
            counts.append(triangles_intersection(g))
        job_lists.append(jobs)
        want.append(tuple(counts))
    batches = [multi.prepare(jobs) for jobs in job_lists]
    victim = 2
    ridx = batches[victim].ridx
    first_real = int(torch.nonzero(ridx >= 0)[0])
    ridx[first_real] = batches[victim].row_data.shape[0] + 7
    before = gather_segment_totals_cuda.launches
    futures = multi.dispatch(batches)
    check(gather_segment_totals_cuda.launches - before == 1, "the wave was not one launch")
    for k, fut in enumerate(futures):
        if k == victim:
            try:
                fut.result()
            except ValueError as e:
                log(f"[kernels] out-of-range index in batch {k} of a wave of {len(futures)} "
                    f"raised at its result() only: {e}")
            else:
                raise RuntimeError("out-of-range index in a wave did not raise at its result()")
        else:
            check(fut.result() == want[k], f"wave batch {k}: {fut.result()} != {want[k]}")
    return 0


def phase_unfused_cases() -> int:
    """total and items: kernel == plain version on the card, up to the
    executor's chunk (1<<20 pairs), with an unaligned operand for total."""
    from repro_torch.kernels.slice_and_popcount import (
        items_cuda,
        items_reference,
        total_cuda,
        total_reference,
    )

    rng = np.random.default_rng(2)
    max_err = 0
    for w in (1, 2, 4):
        for p in (1, 3, 1001, 1 << 16, 1 << 20):
            rows, cols = _words(rng, p, w), _words(rng, p, w)
            rows[: p // 3] = 0  # masked (sentinel) pairs gather zeros
            tot = total_cuda(rows, cols, torch.zeros(1, dtype=torch.int32, device="cuda"))
            items = items_cuda(rows, cols, torch.empty(p, dtype=torch.int32, device="cuda"))
            want_tot, want_items = total_reference(rows, cols), items_reference(rows, cols)
            torch.cuda.synchronize()
            err = max(abs(int(tot) - int(want_tot)),
                      int((items.long() - want_items.long()).abs().max()))
            max_err = max(max_err, err)
            check(int(tot) == int(want_tot), f"total W={w} P={p}: {int(tot)} != {int(want_tot)}")
            check(torch.equal(items.cpu(), want_items.cpu()), f"items W={w} P={p}: kernel != plain")
        log(f"[kernels] total and items W={w}: P 1 .. 1<<20 == plain")
    flat = _words(rng, 4097, 1)  # a one-word offset: the kernel's scalar path
    a, b = flat[1:], _words(rng, 4096, 1)
    got = total_cuda(a, b, torch.zeros(1, dtype=torch.int32, device="cuda"))
    check(int(got) == int(total_reference(a, b)), "total on an unaligned operand")
    log("[kernels] total on a 4-byte-aligned (not 16-byte) operand == plain")
    return max_err


def _fleet() -> tuple[list, list]:
    """The serve phase's jobs: 512 + 16 + 16 small rmat tenants, then the
    three full-size solo graphs. Returns (jobs, exact oracle counts)."""
    from repro_torch.configs import GRAPHS
    from repro_torch.core import build_sbf, build_worklist
    from repro_torch.graphs import build_graph, rmat, triangles_intersection

    specs = [(i, 64) for i in range(NUM_TENANTS)]
    specs += [(NUM_TENANTS + i, 32) for i in range(NUM_TENANTS_SIDE)]
    specs += [(NUM_TENANTS + NUM_TENANTS_SIDE + i, 128) for i in range(NUM_TENANTS_SIDE)]
    jobs, exact = [], []
    for seed, bits in specs:
        n = MIX_N[seed % len(MIX_N)]
        g = build_graph(rmat(n, EDGE_FACTOR * n, seed=seed))
        sb = build_sbf(g, bits)
        jobs.append((sb, build_worklist(g, sb)))
        exact.append(triangles_intersection(g))
    for name in SOLO_GRAPHS:
        g = build_graph(_edges(GRAPHS[name]), reorder=True)
        sb = build_sbf(g, MAIN_SLICE_BITS)
        jobs.append((sb, build_worklist(g, sb)))
        exact.append(triangles_intersection(g))
    return jobs, exact


def _by_id(results) -> list:
    return sorted(results, key=lambda r: r.request_id)


def _check_serve(results, want, label: str) -> None:
    check(len(results) == len(want), f"{label}: {len(results)} results for {len(want)} jobs")
    for r, c in zip(results, want):
        check(r.status == "ok" and r.count == c,
              f"{label}: request {r.request_id} {r.status} {r.count} != {c} ({r.detail})")


def phase_serve() -> dict:
    """TCServer on the card over the fleet, held against the exact oracle
    and the port's CPU server; cache, modes, budget and fault runs."""
    from repro_torch.core.plan import clamp_chunk_pairs
    from repro_torch.kernels.tc_gather_popcount import GROUP_CAP
    from repro_torch.launch.tc_serve import ServeConfig, TCServer
    from repro_torch.runtime.fault import FailureInjector

    t0 = time.perf_counter()
    jobs, exact = _fleet()
    build_s = time.perf_counter() - t0
    solos = len(SOLO_GRAPHS)
    log(f"[serve] fleet: {len(jobs) - solos} tenants + {solos} full-size graphs, host build "
        f"and exact oracle {build_s:.3f} s; pairs "
        f"{min(wl.num_pairs for _, wl in jobs[:-solos])}..{max(wl.num_pairs for _, wl in jobs[:-solos])} "
        f"(tenants), {[wl.num_pairs for _, wl in jobs[-solos:]]} (solos)")
    # ServeConfig's defaults, with room in the batch cache for every batch
    # of the fleet (the default keeps 8), so the re-serve can hit them all.
    cfg = ServeConfig(fused_max_batches=64)

    srv = TCServer(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    results = _by_id(srv.serve(jobs))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    stats = srv.server_stats()
    log(f"[serve] card, cold: {len(results)} results in {cold_s:.6f} s; launches {launches}")
    log(f"[serve] server_stats: {json.dumps(stats)}")
    log(f"[serve] max_memory_allocated: {peak} bytes")
    _check_serve(results, exact, "card serve")
    # One wave (the default budget admits the fleet), whose fused batches of
    # every word width share one launch for every GROUP_CAP of them.
    wave_launches = math.ceil(stats["fused_batches"] / GROUP_CAP)
    check(stats["waves"] == 1 and stats["fused_batches"] > 0, f"serve stats {stats}")
    check(launches["gather_segment_totals"] == wave_launches,
          f"segment launches {launches['gather_segment_totals']} != {wave_launches} for a wave "
          f"of {stats['fused_batches']} fused batches")
    solo_chunks = sum(
        math.ceil(wl.num_pairs / clamp_chunk_pairs(cfg.chunk_pairs, sb.words_per_slice))
        for sb, wl in jobs if wl.num_pairs > cfg.max_fused_pairs
    )
    check(launches["gather_total"] == solo_chunks > 0,
          f"gather_total launches {launches['gather_total']} != solo chunks {solo_chunks}")
    for r, (_, wl) in zip(results, jobs):
        want = "fused" if wl.num_pairs <= cfg.max_fused_pairs else "replicated"
        check(r.placement == want, f"request {r.request_id}: {r.placement}, expected {want}")
    log(f"[serve] every count == exact oracle; {stats['fused_batches']} fused batches "
        f"({stats['fused_graphs']} graphs), {stats.get('solo_replicated', 0)} solos")

    t0 = time.perf_counter()
    cpu = _by_id(TCServer(ServeConfig(device="cpu", fused_max_batches=64)).serve(jobs))
    cpu_s = time.perf_counter() - t0
    check([r.count for r in cpu] == [r.count for r in results], "CPU server counts differ")
    log(f"[serve] port CPU server: same {len(cpu)} counts in {cpu_s:.3f} s")

    uploads = srv.multi.upload_bytes
    before = srv.server_stats()["fused"]
    _reset_launches()
    t0 = time.perf_counter()
    again = _by_id(srv.serve(jobs))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    after = srv.server_stats()["fused"]
    batches = srv.stats["fused_batches"] - stats["fused_batches"]
    again_launches = _launches()
    _check_serve(again, exact, "cached re-serve")
    check(after["hits"] - before["hits"] == batches and after["misses"] == before["misses"],
          f"re-serve: {after} after {before} for {batches} batches")
    check(srv.multi.upload_bytes == uploads, "re-serve uploaded to the device")
    check(again_launches["gather_segment_totals"] == math.ceil(batches / GROUP_CAP),
          f"re-serve: segment launches {again_launches} for {batches} batches")
    log(f"[serve] cached re-serve: {batches} batch-cache hits, 0 new upload bytes, "
        f"{warm_s:.6f} s; launches {again_launches}")

    solo = [i for i, (_, wl) in enumerate(jobs) if wl.num_pairs > cfg.max_fused_pairs]
    solo_jobs, solo_exact = [jobs[i] for i in solo], [exact[i] for i in solo]
    mode_launches = {}
    for mode, kernel in (("gather_then_kernel", "total"), ("pallas_items", "items")):
        _reset_launches()
        res = _by_id(TCServer(ServeConfig(mode=mode)).serve(solo_jobs))
        torch.cuda.synchronize()
        got = _launches()
        _check_serve(res, solo_exact, f"mode {mode}")
        check(got[kernel] == solo_chunks and got["gather_total"] == 0,
              f"mode {mode}: launches {got} for {solo_chunks} chunks")
        mode_launches[kernel] = got[kernel]
        log(f"[serve] mode {mode} on the solos: counts == oracle; launches {got}")

    foot = sorted(_footprint(sb, wl, cfg.chunk_pairs) for sb, wl in jobs)
    budget = foot[-2]  # the largest request can never fit
    tight = TCServer(ServeConfig(memory_budget_bytes=budget, fused_max_batches=64))
    res = _by_id(tight.serve(jobs))
    rejected = [r for r in res if r.status == "rejected"]
    check(len(res) == len(jobs) and len(rejected) >= 1, "tight budget rejected nothing")
    check(all("exceeds budget" in r.detail for r in rejected), "rejection detail")
    for r, c in zip(res, exact):
        check(r.status == "rejected" or (r.status == "ok" and r.count == c),
              f"tight budget: request {r.request_id} {r.status} {r.count} != {c}")
    log(f"[serve] budget {budget} B: {len(rejected)} rejected and reported, the other "
        f"{len(res) - len(rejected)} exact, {tight.stats['waves']} waves")

    victim = 37
    inj = TCServer(ServeConfig(injector=FailureInjector(fail_at_steps=(victim,)),
                               fused_max_batches=64))
    _reset_launches()
    res = _by_id(inj.serve(jobs))
    inj_launches = _launches()
    _check_serve(res, exact, "injected failure")
    check(res[victim].retries >= 1 and "recovered" in res[victim].detail,
          f"request {victim}: {res[victim]}")
    # The failed batch stays out of the wave's launch; the others share it.
    check(inj.stats["fused_batches"] == stats["fused_batches"] - 1
          and inj_launches["gather_segment_totals"] == wave_launches,
          f"injected failure: {inj.stats} and launches {inj_launches}")
    log(f"[serve] injected failure on request {victim}: {res[victim].detail}, "
        f"{inj.stats['wave_failures']} wave failure(s), the other "
        f"{inj.stats['fused_batches']} batches in {wave_launches} launch(es), every count exact")
    return {
        "jobs": jobs, "server": srv, "launches": launches, "mode_launches": mode_launches,
        "build_s": build_s, "cold_s": cold_s, "warm_s": warm_s, "cpu_s": cpu_s, "peak": peak,
    }


def _footprint(sb, wl, chunk_pairs: int) -> int:
    from repro_torch.launch.tc_serve import ServeRequest

    return ServeRequest(0, sb, wl, 0.0).footprint_bytes(chunk_pairs)


def _bound_ms(nbytes: float, ops: float, ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _row(name, source, replaces, launches, ms, plain_ms, bound, library_ms=None) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms,
    }


def phase_serve_timing(serve: dict, chunks, row, col) -> tuple[list, int]:
    """Kernel vs plain for the segment, total and items kernels at the
    paths' shapes; fused serving vs the per-graph loop; returns the JSON
    rows and the max |err|."""
    from repro_torch.core.executor import ExecutorPool, _gather_chunk
    from repro_torch.kernels.slice_and_popcount import (
        items_cuda,
        items_reference,
        total_cuda,
        total_reference,
    )
    from repro_torch.kernels.tc_gather_popcount import (
        gather_segment_groups_cuda,
        gather_segment_groups_reference,
        gather_segment_totals_cuda,
    )

    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    srv = serve["server"]
    # The fleet's wave: every cached batch, in one grouped launch (the
    # executor's cached table) into one zeroed output; beside it the same
    # batches as one-entry launches in turns ("no grouping").
    batches = list(srv.multi._batches.values())
    table = srv.multi._table(batches)
    segs = [b.segments for b in batches]
    wave_out = torch.zeros(table.rows, 2, dtype=torch.int32, device="cuda")
    wave = lambda out: [gather_segment_groups_cuda(table, out, k)  # noqa: E731
                        for k in range(len(table.groups))]
    want = gather_segment_groups_reference(segs)
    wave(wave_out)
    torch.cuda.synchronize()
    max_err = int((wave_out.cpu().long() - want.cpu().long()).abs().max())
    check(max_err == 0, "fleet wave: grouped segment kernel != plain")
    _time_ms(wave, [(wave_out,)], 1)
    seg_ms = _time_ms(wave, [(wave_out,)], 20)
    # The executor's whole wave dispatch: zeroed output, the launch, the futures.
    _time_ms(srv.multi.dispatch, [(batches,)], 1)
    dispatch_ms = _time_ms(srv.multi.dispatch, [(batches,)], 20)
    launches = WAVE_GRAPH_LAUNCHES
    graph = _graph(wave, [(wave_out,)], launches)
    wave_out.zero_()
    graph.replay()
    check(torch.equal(wave_out.long(), launches * want.long()),
          "fleet wave: the grouped kernel's graph replay != plain")
    seg_device_ms = _replay_ms(graph, launches)
    del graph
    single = [(*seg[:4], torch.zeros(b.plan.padded_graphs, 2, dtype=torch.int32, device="cuda"),
               seg[4]) for seg, b in zip(segs, batches)]
    one = lambda *a: gather_segment_totals_cuda(*a[:5], bucket=a[5])  # noqa: E731
    _time_ms(one, single, 1)
    one_ms = _time_ms(one, single, 3) * len(single)
    each = len(single) * math.ceil(GRAPH_LAUNCHES / len(single))
    graph = _graph(one, single, each)
    for a in single:
        a[4].zero_()
    graph.replay()
    check(torch.cat([a[4] for a in single]).long().equal(
        (each // len(single)) * want.long()), "fleet batches one by one: graph replay != plain")
    one_device_ms = _replay_ms(graph, each) * len(single)
    del graph
    plain = gather_segment_groups_reference
    _time_ms(plain, [(segs,)], 1)
    seg_plain_ms = _time_ms(plain, [(segs,)], 3)
    seg_ms_bound, seg_by = 0.0, "bytes"
    for b in batches:
        valid = (b.ridx >= 0) & (b.cidx >= 0)
        w = b.row_data.shape[1]
        rows_read = torch.unique(b.ridx[valid]).numel()
        cols_read = torch.unique(b.cidx[valid]).numel()
        t, seg_by = _bound_ms(8 * b.ridx.numel() + 4 * w * (rows_read + cols_read)
                              + 8 * b.plan.padded_graphs, 3 * w * int(valid.sum()))
        seg_ms_bound += t
    seg_bound = (seg_ms_bound, seg_by)
    seg_bytes = sum(8 * b.ridx.numel() + 4 * (b.row_data.numel() + b.col_data.numel())
                    for b in batches)
    shapes = sorted({(b.plan.padded_graphs, b.plan.bucket, b.plan.words_per_slice) for b in batches})
    lanes = sum(b.ridx.numel() for b in batches)
    log(f"[timing] gather_segment_totals: a serve wave of the fleet's {len(batches)} cached "
        f"batches ((G, bucket, W) in {shapes}; {lanes} index lanes, {table.groups[-1].first_block[-1]} "
        f"blocks; {seg_bytes} B of indices and stores in all, L2 "
        f"{l2} B) in {len(table.groups)} grouped launch(es): {seg_ms:.6f} ms a wave per call "
        f"(gather_segment_groups_cuda on the cached table into one zeroed output), "
        f"{dispatch_ms:.6f} ms a wave through MultiGraphExecutor.dispatch (zeroing, launch, "
        f"futures); bound {seg_bound[0]:.6f} ms a wave ({seg_bound[1]}), "
        f"{100 * seg_bound[0] / seg_ms:.2f}% of bound per call; device time alone "
        f"{seg_device_ms:.6f} ms a wave ({100 * seg_bound[0] / seg_device_ms:.2f}% of bound; a "
        f"CUDA graph of {launches} whole-wave launches, replayed; its sums == plain), so the "
        f"wrapper costs {seg_ms - seg_device_ms:.6f} ms a call; no grouping (one launch a "
        f"batch, in turns): {one_ms:.6f} ms a wave per call, {one_device_ms:.6f} ms of device "
        f"time alone ({one_device_ms / len(single):.6f} ms a batch); plain version "
        f"{seg_plain_ms:.6f} ms a wave; library_ms null ({NO_POPCOUNT_OP})")

    # total and items at the executor's chunk shape for com-youtube, over
    # every chunk in turns: their gathered words are larger than L2, so each
    # launch reads its operands from device memory, as on the path.
    acc = torch.zeros(2, dtype=torch.int32, device="cuda")
    gathered = [_gather_chunk(row, col, ridx, cidx, acc) for ridx, cidx in chunks]
    words_bytes = sum(2 * r.numel() * 4 for r, _ in gathered)
    p, w = gathered[0][0].shape
    rows_json = []
    for name, kernel, plain_fn, replaces in (
        ("total", total_cuda, total_reference, "src/repro/kernels/slice_and_popcount.py:90"),
        ("items", items_cuda, items_reference, "src/repro/kernels/slice_and_popcount.py:41"),
    ):
        calls = [(rows, cols, torch.zeros(1 if name == "total" else rows.shape[0],
                                          dtype=torch.int32, device="cuda"))
                 for rows, cols in gathered]
        wants = [plain_fn(rows, cols).long().reshape(-1) for rows, cols in gathered]
        err = 0
        for args, want in zip(calls, wants):
            got = kernel(*args)
            torch.cuda.synchronize()
            err = max(err, int((got.long().reshape(-1) - want).abs().max()))
        check(err == 0, f"{name} at the chunk shape: kernel != plain")
        max_err = max(max_err, err)
        rounds = math.ceil(50 / len(calls))
        _time_ms(kernel, calls, 1)
        ms = _time_ms(kernel, calls, rounds)
        graph = _graph(kernel, calls)
        for args in calls:
            args[2].zero_()
        graph.replay()
        # total adds into out; items overwrites it
        check(all(torch.equal(args[2].long().reshape(-1),
                              (_graph_uses(k, len(calls)) if name == "total" else 1) * want)
                  for k, (args, want) in enumerate(zip(calls, wants))),
              f"{name}: the graph replay != plain")
        device_ms = _replay_ms(graph)
        del graph
        plain_calls = [(rows, cols) for rows, cols in gathered]
        _time_ms(plain_fn, plain_calls[:1], 1)
        plain_ms = _time_ms(plain_fn, plain_calls, 1)
        each = [_bound_ms(2 * r.numel() * 4 + (4 if name == "total" else 4 * r.shape[0]),
                          3 * r.numel()) for r, _ in gathered]
        bound = (sum(t for t, _ in each) / len(each), each[0][1])
        log(f"[timing] {name}: {ms:.6f} ms/launch over the {len(calls)} com-youtube chunks in "
            f"turns (P={p}, W={w}; {words_bytes} B of gathered words in all, L2 {l2} B); "
            f"bound {bound[0]:.6f} ms a chunk ({bound[1]}), {100 * bound[0] / ms:.2f}% of bound; "
            f"device time alone {device_ms:.6f} ms ({100 * bound[0] / device_ms:.2f}% of bound; a "
            f"CUDA graph of {GRAPH_LAUNCHES} launches over the chunks, replayed; == plain), so the "
            f"wrapper costs {ms - device_ms:.6f} ms a call; plain version {plain_ms:.6f} ms; "
            f"library_ms null ({NO_POPCOUNT_OP})")
        r = _row(name, "src/repro_torch/kernels/csrc/slice_and_popcount.cu",
                 replaces, serve["mode_launches"][name], ms, plain_ms, bound)
        r["device_ms"] = device_ms
        rows_json.append(r)
    del gathered

    # Steady state: fused serve() vs the per-graph pool loop, same tenants.
    tenants = serve["jobs"][:NUM_TENANTS]
    pool = ExecutorPool(max_graphs=2 * NUM_TENANTS)

    def loop_round():
        futs = [pool.count_async(sb, wl) for sb, wl in tenants]
        return [f.result() for f in futs]

    def fused_round():
        return [r.count for r in _by_id(srv.serve(tenants))]

    check(loop_round() == fused_round(), "pool loop and fused serve differ")
    rounds = 5
    gps = {"fused": [], "loop": []}
    for kind in ("fused", "loop", "loop", "fused"):
        fn = fused_round if kind == "fused" else loop_round
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize()
        gps[kind].append(rounds * len(tenants) / (time.perf_counter() - t0))
    fused_gps, loop_gps = sum(gps["fused"]) / 2, sum(gps["loop"]) / 2
    log(f"[timing] steady state over {len(tenants)} tenants x {rounds} rounds, in turns "
        f"fused, loop, loop, fused: serve() {gps['fused']} graphs/s, pool loop {gps['loop']} "
        f"graphs/s; means {fused_gps:.3f} vs {loop_gps:.3f} ({fused_gps / loop_gps:.3f}x)")

    # Where a serve wave's time goes: its dispatch and its one readback.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futures = srv.multi.dispatch(batches)
    t1 = time.perf_counter()
    counts = [f.result() for f in futures]
    t2 = time.perf_counter()
    check(all(len(c) == b.plan.num_graphs for c, b in zip(counts, batches)), "wave readback")
    log(f"[timing] serve stages: fleet host build + oracle {serve['build_s']:.3f} s; cold "
        f"serve {serve['cold_s']:.6f} s; cached re-serve {serve['warm_s']:.6f} s; the "
        f"{len(batches)} cached batches' wave dispatched in {1e3 * (t1 - t0):.6f} ms and read back "
        f"in {1e3 * (t2 - t1):.6f} ms (host clock); CPU server {serve['cpu_s']:.3f} s; peak "
        f"memory {serve['peak']} bytes")
    seg_row = _row("gather_segment_totals", "src/repro_torch/kernels/csrc/tc_gather_popcount.cu",
                   "src/repro/kernels/tc_gather_popcount.py:239",
                   serve["launches"]["gather_segment_totals"], seg_ms, seg_plain_ms, seg_bound)
    seg_row["device_ms"] = seg_device_ms
    seg_row["per"] = "serve wave"
    seg_row["batches"] = len(batches)
    seg_row["no_grouping_ms"] = one_ms
    seg_row["no_grouping_device_ms"] = one_device_ms
    return [seg_row, *rows_json], max_err


def _dense_case(n: int, density: float, seed: int, kind: str) -> torch.Tensor:
    """An [n, n] {0,1} bool matrix on the card: strictly upper- or
    lower-triangular, full, or block-sparse (full {0,1} with random 128-row
    tile rows and columns zeroed: an occupancy plan that is not the
    triangle)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand(n, n, generator=gen, device="cuda") < density
    if kind == "upper":
        return torch.triu(a, 1)
    if kind == "lower":
        return torch.tril(a, -1)
    if kind == "block-sparse":
        nt = -(-n // 128)
        rows = (torch.rand(nt, generator=gen, device="cuda") < 0.6).repeat_interleave(128)[:n]
        cols = (torch.rand(nt, generator=gen, device="cuda") < 0.6).repeat_interleave(128)[:n]
        return a & rows[:, None] & cols[None, :]
    return a


def _planned_steps(a: torch.Tensor) -> int:
    """The k steps the occupancy plan keeps (the plain plan helper)."""
    from repro_torch.kernels.tc_dense_mxu import dense_mxu_occupancy_reference, dense_mxu_plan

    return int(dense_mxu_plan(dense_mxu_occupancy_reference(a))[1].sum())


def phase_dense_cases() -> tuple[int, int]:
    """bitgemm and dense_mxu_tc: kernel == plain version on the card.
    Returns the max |err| of each."""
    from repro_torch.kernels.tc_bitgemm import bitgemm_cuda, bitgemm_reference, padded_view
    from repro_torch.kernels.tc_dense_mxu import dense_mxu_tc_cuda, dense_mxu_tc_reference

    rng = np.random.default_rng(3)
    err_bitgemm = 0
    copies = 0
    for w in BITGEMM_WORDS:
        for i in BITGEMM_SIZES:
            for j in BITGEMM_SIZES:
                for pattern in ("random", "zeros", "ones"):
                    if pattern == "ones":
                        x = torch.full((i, w), -1, dtype=torch.int32, device="cuda")
                        y = torch.full((j, w), -1, dtype=torch.int32, device="cuda")
                    else:
                        x, y = _words(rng, i, w), _words(rng, j, w)
                        if pattern == "zeros":
                            x.zero_()
                    want = bitgemm_reference(x, y)
                    # Contiguous operands: a row stride of W words, copied to
                    # padded scratch unless W is a multiple of 4; then the
                    # row-padded views tcim hands over, read as they lie.
                    for layout in ("contiguous", "padded"):
                        if layout == "padded":
                            x, y = padded_view(x, fill=-1), padded_view(y, fill=-1)
                        before = bitgemm_cuda.padded_copies
                        got = bitgemm_cuda(x, y, torch.empty(i, j, dtype=torch.int32, device="cuda"))
                        torch.cuda.synchronize()
                        made = bitgemm_cuda.padded_copies - before
                        copies += made
                        expect = 2 if layout == "contiguous" and w % 4 else 0
                        check(made == expect, f"bitgemm I={i} J={j} W={w} {layout}: {made} padded "
                                              f"copies, expected {expect}")
                        err = int((got.long() - want.long()).abs().max())
                        err_bitgemm = max(err_bitgemm, err)
                        check(err == 0, f"bitgemm I={i} J={j} W={w} {pattern} {layout}: kernel != plain")
                        if pattern == "ones":
                            check(bool((got == 32 * w).all()), f"bitgemm all-ones I={i} J={j} W={w}")
        log(f"[dense] bitgemm W={w}: I, J in {list(BITGEMM_SIZES)} x random/zero/all-ones x "
            f"contiguous/row-padded == plain")
    log(f"[dense] bitgemm: {copies} operands copied to padded scratch, the contiguous ones whose "
        f"W is not a multiple of 4; none of the row-padded views")
    x = _words(rng, 129, 5)
    for label, args in (("a transposed operand (words not consecutive)", (x.t(), x.t())),
                        ("an int64 operand", (x.long(), x.long())),
                        ("a host operand", (x, x.cpu()))):
        n_out = args[0].shape[0]
        try:
            bitgemm_cuda(*args, torch.empty(n_out, n_out, dtype=torch.int32, device="cuda"))
        except (ValueError, TypeError) as e:
            log(f"[dense] bitgemm refused {label}: {e}")
        else:
            raise RuntimeError(f"bitgemm took {label}")

    err_mxu = 0
    cases = [(n, d, "upper") for n in MXU_SIZES for d in MXU_DENSITIES]
    cases += [(n, d, "lower") for n in MXU_SIZES for d in (0.02, 0.3)]
    cases += [(n, 0.5, kind) for n in (255, 257, 1000, 4039) for kind in ("full", "block-sparse")]
    skipped = {}
    for k, (n, density, kind) in enumerate(cases):
        a = _dense_case(n, density, seed=k, kind=kind)
        steps = torch.zeros(1, dtype=torch.int64, device="cuda")
        got = dense_mxu_tc_cuda(a.to(torch.int8), torch.zeros(1, dtype=torch.int64, device="cuda"),
                                steps)
        want = dense_mxu_tc_reference(a)
        torch.cuda.synchronize()
        err = abs(int(got) - int(want))
        err_mxu = max(err_mxu, err)
        planned = _planned_steps(a)
        check(err == 0, f"dense_mxu_tc N={n} density={density} {kind}: "
                        f"kernel {int(got)} != plain {int(want)}")
        check(int(steps) == planned, f"dense_mxu_tc N={n} {kind}: {int(steps)} k steps computed, "
                                     f"the plan keeps {planned}")
        if n == 4039:
            nt = -(-n // 128)
            skipped[kind] = f"{planned} of {nt ** 3} k steps"
    log(f"[dense] dense_mxu_tc: N in {list(MXU_SIZES)} x densities {list(MXU_DENSITIES)} "
        f"(upper-triangular), lower-triangular, full and block-sparse {{0,1}} N 255 / 257 / "
        f"1000 / 4039 == plain; k steps computed == the plan's in every case; at N 4039: "
        f"{json.dumps(skipped)}")
    return err_bitgemm, err_mxu


def _dense_operands(g, backend: str) -> float:
    """Seconds to build one dense backend's operands on the card with
    tcim's own builders (packing on the host and an upload for bitgemm, a
    scatter on the card for mxu), up to the first kernel."""
    from repro_torch.core.tcim import _bitgemm_operands, _dense_upper

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (_bitgemm_operands if backend == "bitgemm" else _dense_upper)(g, torch.device("cuda"))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_dense() -> dict:
    """The dense backends on the card at full size, held against the exact
    oracle (and, on ego-facebook, the port's CPU path); the analytics."""
    from repro_torch.configs import GRAPHS
    from repro_torch.core import baselines, metrics, tcim_count
    from repro_torch.graphs import build_graph, triangles_intersection
    from repro_torch.kernels.tc_bitgemm import bitgemm_cuda

    out = {}
    for name in DENSE_GRAPHS:
        edges = _edges(GRAPHS[name])
        g = build_graph(edges, reorder=True)
        t0 = time.perf_counter()
        exact = triangles_intersection(g)
        log(f"[dense] {name}: |V|={g.n} |E|={g.m}; exact oracle {exact} in "
            f"{time.perf_counter() - t0:.3f} s")
        chunks = sum(
            int(g.indptr[min(s + BITGEMM_CHUNK_ROWS, g.n)] > g.indptr[s])
            for s in range(0, g.n, BITGEMM_CHUNK_ROWS)
        )
        for backend in DENSE_BACKENDS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()  # what earlier phases still hold
            copies = bitgemm_cuda.padded_copies
            _reset_launches()
            t0 = time.perf_counter()
            res = tcim_count(edges, backend=backend)
            wall = time.perf_counter() - t0
            launches = _launches()
            peak = torch.cuda.max_memory_allocated() - base
            kernel = "bitgemm" if backend == "bitgemm" else "dense_mxu_tc"
            want = chunks if backend == "bitgemm" else 1
            others = {k: v for k, v in launches.items() if k != kernel and v}
            check(launches[kernel] == want and not others,
                  f"{name} {backend}: launches {launches}, expected {want} of {kernel}")
            check(bitgemm_cuda.padded_copies == copies,
                  f"{name} {backend}: tcim's row-padded operands were copied")
            check(res.triangles == exact, f"{name} {backend}: card {res.triangles} != oracle {exact}")
            build_s = _dense_operands(g, backend)
            log(f"[dense] {name} {backend}: card {res.triangles} == oracle; {launches[kernel]} "
                f"{kernel} launches; {wall:.6f} s wall; timings_s {json.dumps(res.timings_s)}; "
                f"operand build alone {build_s:.6f} s; max_memory_allocated {peak} bytes above "
                f"the {base} bytes held before")
            if name == "ego-facebook":
                t0 = time.perf_counter()
                cpu = tcim_count(edges, backend=backend, device="cpu")
                check(cpu.triangles == exact, f"{name} {backend}: CPU {cpu.triangles} != {exact}")
                log(f"[dense] {name} {backend}: port CPU path {cpu.triangles} == card, "
                    f"{time.perf_counter() - t0:.3f} s")
            else:
                work = ("a float64 A @ A of about 10^14 operations" if backend == "mxu"
                        else f"{g.n * g.n * -(-g.n // 32):.3e} SWAR popcounts")
                log(f"[dense] {name} {backend}: the port's CPU path is left out at this size "
                    f"({work} on the host)")
            out[(name, backend)] = {"launches": launches[kernel], "result": res, "peak": peak,
                                    "build_s": build_s, "wall": wall}
        out[name] = g

    g = out["ego-facebook"]
    _reset_launches()
    support = metrics.edge_support(g)
    launches = _launches()
    check(launches["items"] == 1, f"edge_support launches {launches}")
    check(np.array_equal(support, metrics.edge_support(g, device="cpu")), "edge_support card != CPU")
    check(int(support.sum()) == out[("ego-facebook", "mxu")]["result"].triangles,
          "edge support does not sum to the count")
    log(f"[dense] ego-facebook edge_support: 1 items launch; == CPU path; sums to the count")
    mm = baselines.matmul_tc(g)
    check(mm == out[("ego-facebook", "mxu")]["result"].triangles, f"matmul_tc {mm}")
    log(f"[dense] ego-facebook baselines.matmul_tc on the card: {mm} == oracle")
    return out


def _int_mm_ms(a8: torch.Tensor) -> float | None:
    """torch._int_mm (the product alone) of the int8 operand padded to a
    multiple of 8, as the library needs; None if the library refuses."""
    n = a8.shape[0]
    m = -(-n // 8) * 8
    pad = torch.zeros(m, m, dtype=torch.int8, device="cuda")
    pad[:n, :n] = a8
    try:
        torch._int_mm(pad, pad)
    except RuntimeError as e:
        log(f"[dense timing] torch._int_mm refused N={m}: {e}")
        return None
    _time_ms(torch._int_mm, [(pad, pad)], 1)
    return _time_ms(torch._int_mm, [(pad, pad)], 3)


def _bits_int8(words: torch.Tensor, rows: int, chunk: int = 4096) -> torch.Tensor:
    """``[R, W]`` int32 words -> ``[rows, 32 W]`` int8 {0,1}, bit b of word w
    at column 32 w + b, unpacked ``chunk`` rows at a time; rows past R are
    zero."""
    r, w = words.shape
    out = torch.zeros(rows, 32 * w, dtype=torch.int8, device=words.device)
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    for s in range(0, r, chunk):
        blk = words[s : s + chunk]
        out[s : s + blk.shape[0]] = ((blk[:, :, None] >> shifts) & 1).to(torch.int8).reshape(
            blk.shape[0], 32 * w)
    return out


def _int_mm_bits_ms(x: torch.Tensor, y: torch.Tensor, kernel_out: torch.Tensor
                    ) -> tuple[float | None, float]:
    """torch._int_mm (the product alone) of x's bits by y's bits transposed,
    as {0,1} int8 (J padded to a multiple of 8, as the library needs),
    checked equal to the kernel's ``kernel_out``; None if the library
    refuses. Also the seconds the unpacking took."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xb = _bits_int8(x, x.shape[0])
    yb = _bits_int8(y, -(-y.shape[0] // 8) * 8)
    torch.cuda.synchronize()
    unpack_s = time.perf_counter() - t0
    try:
        prod = torch._int_mm(xb, yb.t())
    except RuntimeError as e:
        log(f"[dense timing] torch._int_mm refused [{xb.shape[0]}, {xb.shape[1]}] x "
            f"[{yb.shape[1]}, {yb.shape[0]}]: {e}")
        return None, unpack_s
    check(torch.equal(prod[:, : y.shape[0]], kernel_out),
          "torch._int_mm on the bits != the bitgemm kernel")
    del prod
    _time_ms(torch._int_mm, [(xb, yb.t())], 1)
    return _time_ms(torch._int_mm, [(xb, yb.t())], 3), unpack_s


def phase_dense_timing(dense: dict) -> list:
    """Kernel vs plain at the dense paths' shapes; returns the JSON rows."""
    from repro_torch.core.tcim import _bitgemm_operands, _dense_upper
    from repro_torch.kernels.tc_bitgemm import bitgemm_cuda, bitgemm_reference
    from repro_torch.kernels.tc_dense_mxu import dense_mxu_tc_cuda, dense_mxu_tc_reference

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    popc_per_s = POPC_PER_CLOCK_PER_SM * sms * sm_clock_hz()
    cuda = torch.device("cuda")
    x, y = _bitgemm_operands(dense["email-enron"], cuda)
    xc = x[:BITGEMM_CHUNK_ROWS]
    i, w = xc.shape
    j = y.shape[0]
    out = torch.empty(i, j, dtype=torch.int32, device="cuda")
    copies = bitgemm_cuda.padded_copies
    _time_ms(bitgemm_cuda, [(xc, y, out)], 1)
    ms = _time_ms(bitgemm_cuda, [(xc, y, out)], 10)
    check(bitgemm_cuda.padded_copies == copies, "tcim's bitgemm operands were copied")
    t0 = time.perf_counter()
    want = bitgemm_reference(xc, y)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    check(torch.equal(out, want), "bitgemm at the email-enron chunk: kernel != plain")
    del want
    library_ms, unpack_s = _int_mm_bits_ms(xc, y, out)
    # Bound: X and Y read once, C written once; I J 32W one-bit products, two
    # operations each, at the b1 MMA's rate (8 x int8's). The int8 rate and
    # the popcount unit (the earlier CUDA-core kernel's) are logged beside.
    nbytes = 4 * (i + j) * w + 4 * i * j
    ops = 2 * i * j * 32 * w
    bound = _bound_ms(nbytes, ops, B1_TENSOR_OPS_PER_S)
    int8_bound = _bound_ms(nbytes, ops, INT8_TENSOR_OPS_PER_S)
    popc_bound = _bound_ms(nbytes, i * j * w, popc_per_s)
    log(f"[dense timing] bitgemm: {ms:.6f} ms/launch at email-enron chunk 0 (I={i}, J={j}, W={w}; "
        f"{ops:.4e} ops: {i * j * 32 * w} one-bit products); bound {bound[0]:.6f} ms ({bound[1]}: "
        f"b1 tensor-core rate {B1_TENSOR_OPS_PER_S:.4e} ops/s, 8 x int8's), "
        f"{100 * bound[0] / ms:.2f}% of it; at the int8 tensor-core rate over the bit products "
        f"{int8_bound[0]:.6f} ms ({int8_bound[1]}; {100 * int8_bound[0] / ms:.2f}%); at the "
        f"popcount unit (16 a clock a SM, {popc_per_s:.4e}/s) {popc_bound[0]:.6f} ms "
        f"({100 * popc_bound[0] / ms:.2f}%); plain version {plain_ms:.3f} ms (one call, same "
        f"shape); torch._int_mm on the bits as {{0,1}} int8 (product alone, J padded to 8) "
        f"{'refused' if library_ms is None else f'{library_ms:.6f} ms, == the kernel'}; "
        f"unpacking the bits took {unpack_s:.3f} s, outside that time")
    check(bound[0] <= ms, "bitgemm reads above its bound")
    row = _row("bitgemm", "src/repro_torch/kernels/csrc/tc_bitgemm.cu",
               "src/repro/kernels/tc_bitgemm.py:47",
               dense[("email-enron", "bitgemm")]["launches"], ms, plain_ms, bound, library_ms)
    rows = [row]
    del x, y, xc, out

    for name in ("email-enron", "ego-facebook"):
        g = dense[name]
        label = "dense_mxu_tc" if name == "email-enron" else f"dense_mxu_tc[n={g.n}]"
        a = _dense_upper(g, cuda)
        n = g.n
        check(not bool(torch.tril(a).any()), f"{name}: the timing input is not strictly upper-triangular")
        acc = torch.zeros(1, dtype=torch.int64, device="cuda")
        steps = torch.zeros(1, dtype=torch.int64, device="cuda")
        dense_mxu_tc_cuda(a, acc, steps)
        planned = _planned_steps(a)
        check(int(steps) == planned, f"{name}: {int(steps)} k steps computed, the plan keeps {planned}")
        rounds = 3
        ms = _time_ms(dense_mxu_tc_cuda, [(a, acc)], rounds)
        want = dense_mxu_tc_reference(a)
        torch.cuda.synchronize()
        check(int(acc) == (rounds + 1) * int(want), f"{name} mxu timing: kernel sum != plain")
        _time_ms(dense_mxu_tc_reference, [(a,)], 1)
        plain_ms = _time_ms(dense_mxu_tc_reference, [(a,)], 1)
        library_ms = _int_mm_ms(a)
        # The function's work on a strictly upper-triangular A: the products
        # with i < k < j, N (N - 1) (N - 2) / 3 int8 operations, a sixth of the
        # dense 2 N^3 (also logged, as the earlier kernel computed all of it).
        bound = _bound_ms(n * n + 8, n * (n - 1) * (n - 2) / 3, INT8_TENSOR_OPS_PER_S)
        dense_bound = _bound_ms(n * n + 8, 2 * n**3, INT8_TENSOR_OPS_PER_S)
        nt = -(-n // 128)
        log(f"[dense timing] {label}: {ms:.6f} ms/launch at {name} (N={n}; occupancy pass, plan, "
            f"the wrapper's transpose and the kernel); {planned} of {nt ** 3} k steps of 128^3 "
            f"(== the plan); triangular bound {bound[0]:.6f} ms ({bound[1]}: N(N-1)(N-2)/3 int8 "
            f"ops at 1,979 TOP/s), {100 * bound[0] / ms:.2f}% of it; the dense 2 N^3 would "
            f"take at least {dense_bound[0]:.6f} ms ({ms / dense_bound[0]:.4f} x this kernel's "
            f"time: the blocks it skips are part of that count); plain "
            f"version {plain_ms:.6f} ms; torch._int_mm (product alone, N padded to 8) "
            f"{'refused' if library_ms is None else f'{library_ms:.6f} ms'}")
        check(bound[0] <= ms, f"{name}: the kernel reads above its bound")
        row = _row(label, "src/repro_torch/kernels/csrc/tc_dense_mxu.cu",
                   "src/repro/kernels/tc_dense_mxu.py:60", dense[(name, "mxu")]["launches"], ms,
                   plain_ms, bound, library_ms)
        row["k_steps"] = planned
        rows.append(row)
        del a, acc
    return rows


def _flash_inputs(bh: int, sq: int, sk: int, hd: int, dtype, seed: int) -> tuple:
    """Normal q, k, v on the card and arange positions, the queries at the
    end of the keys when Sq < Sk (chunked prefill)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(bh, n, hd, generator=gen, device="cuda").to(dtype) for n in (sq, sk, sk))
    start = sk - sq if sq < sk else 0
    qp = torch.arange(start, start + sq, dtype=torch.int32, device="cuda").expand(bh, sq)
    kp = torch.arange(sk, dtype=torch.int32, device="cuda").expand(bh, sk)
    return q, k, v, qp.contiguous(), kp.contiguous()


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _close(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    return torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| over the whole tensor."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def _flash_plain_f32(plain, ops: tuple) -> torch.Tensor:
    """The plain version with q in float32: the same scores and the same
    weights rounded to v's type, its output left unrounded. Rounded to q's
    type it is the plain version's output."""
    return plain(ops[0].float(), *ops[1:])


def _row_rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a - b|| / ||b|| of each row (last axis) of [..., d] tensors."""
    a, b = a.float(), b.float()
    return (a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)


def _gqa_inputs(b: int, sq: int, sk: int, h: int, kh: int, hd: int, dtype, seed: int,
                positions: str = "arange") -> tuple:
    """Normal q [B, Sq, H, hd], k and v [B, Sk, KH, hd] on the card and int32
    positions [B, Sq] / [B, Sk]: arange (queries at the end of the keys when
    Sq < Sk), reversed, a random permutation of each, or every key after
    every query (rows with no visible key)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, sq, h, hd, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, sk, kh, hd, generator=gen, device="cuda").to(dtype) for _ in range(2))
    start = sk - sq if sq < sk else 0
    qp = torch.arange(start, start + sq, dtype=torch.int32, device="cuda").repeat(b, 1)
    kp = torch.arange(sk, dtype=torch.int32, device="cuda").repeat(b, 1)
    if positions == "reversed":
        qp, kp = qp.flip(1).contiguous(), kp.flip(1).contiguous()
    elif positions == "permuted":
        qp = torch.stack([r[torch.randperm(sq, generator=gen, device="cuda")] for r in qp])
        kp = torch.stack([r[torch.randperm(sk, generator=gen, device="cuda")] for r in kp])
    elif positions == "keys after queries":
        kp = kp + start + sq
    return q, k, v, qp, kp


def _flash_case(kernel, plain, ops: tuple, causal: bool, heads: int, label: str) -> tuple:
    """One kernel call held to the plain version (elementwise and by row) and
    its scored-tile count to the skip rule's. Returns (max |err|, max row
    error, tiles scored)."""
    from repro_torch.kernels.flash_attention import FLASH_TILES, flash_tiles_scored

    dtype = ops[0].dtype
    tiles = torch.zeros(1, dtype=torch.int64, device="cuda")
    got = kernel(*ops, causal=causal, tiles=tiles)
    exact = _flash_plain_f32(lambda *a: plain(*a, causal=causal), ops)
    want = exact.to(dtype)
    torch.cuda.synchronize()
    err, row = _err(got, want), float(_row_rel(got, exact).max()) if got.numel() else 0.0
    name = str(dtype).split(".")[-1]
    check(got.dtype == dtype and _close(got, want, FLASH_TOL[name]) and row <= FLASH_ROW_TOL[name],
          f"flash {label}: max |err| {err}, max row error {row}")
    predicted = flash_tiles_scored(ops[3], ops[4], heads, *FLASH_TILES[dtype], causal=causal)
    check(int(tiles) == predicted, f"flash {label}: {int(tiles)} tiles scored, the rule says "
                                   f"{predicted}")
    return err, row, int(tiles)


def phase_flash_cases() -> tuple[dict, dict]:
    """flash_attention: kernel == plain version on the card within the
    reference's elementwise tolerances and, row by row, within
    FLASH_ROW_TOL, through both entries; tiles scored == the skip rule's.
    Returns the max |err| and the max row error by type."""
    from repro_torch.kernels.flash_attention import (
        FLASH_HEAD_DIMS,
        flash_attention_bshd_cuda,
        flash_attention_bshd_reference,
        flash_attention_cuda,
        flash_attention_reference,
    )

    errs, row_errs = {}, {}
    seed = 0
    for dtype_name in FLASH_TOL:
        dtype = getattr(torch, dtype_name)
        errs[dtype_name], row_errs[dtype_name] = 0.0, 0.0
        for hd in FLASH_HEAD_DIMS:
            hd_row = 0.0
            for bh in FLASH_BH:
                for sq, sk in FLASH_SHAPES:
                    for causal in (True, False):
                        seed += 1
                        err, row, _ = _flash_case(
                            flash_attention_cuda, flash_attention_reference,
                            _flash_inputs(bh, sq, sk, hd, dtype, seed), causal, 1,
                            f"{dtype_name} hd={hd} BH={bh} Sq={sq} Sk={sk} causal={causal}")
                        errs[dtype_name] = max(errs[dtype_name], err)
                        hd_row = max(hd_row, row)
            log(f"[flash] {dtype_name} hd={hd}: [BH, S, hd] entry, BH {list(FLASH_BH)} x (Sq, Sk) "
                f"{list(FLASH_SHAPES)} x causal / not == plain within {FLASH_TOL[dtype_name]} and "
                f"rows within {FLASH_ROW_TOL[dtype_name]}; tiles scored == the skip rule's; max "
                f"row error {hd_row:.3e}")
            for b in FLASH_GQA_B:
                for h, kh in FLASH_GQA_HEADS:
                    for sq, sk in FLASH_GQA_SHAPES:
                        for causal in (True, False):
                            seed += 1
                            err, row, _ = _flash_case(
                                flash_attention_bshd_cuda, flash_attention_bshd_reference,
                                _gqa_inputs(b, sq, sk, h, kh, hd, dtype, seed), causal, h,
                                f"{dtype_name} hd={hd} B={b} H={h} KH={kh} Sq={sq} Sk={sk} "
                                f"causal={causal}")
                            errs[dtype_name] = max(errs[dtype_name], err)
                            hd_row = max(hd_row, row)
            scored = {}
            for positions in FLASH_POSITIONS:
                seed += 1
                ops = _gqa_inputs(2, 300, 260, 9, 3, hd, dtype, seed, positions)
                err, row, scored[positions] = _flash_case(
                    flash_attention_bshd_cuda, flash_attention_bshd_reference, ops, True, 9,
                    f"{dtype_name} hd={hd} positions {positions}")
                errs[dtype_name] = max(errs[dtype_name], err)
                hd_row = max(hd_row, row)
                if positions == "keys after queries":  # no row sees a key: the mean of V
                    got = flash_attention_bshd_cuda(*ops)
                    mean = ops[2].float().mean(dim=1).repeat_interleave(3, dim=1)  # [B, H, hd]
                    tol = FLASH_TOL[dtype_name]
                    check(_close(got, mean[:, None].expand_as(got), tol),
                          f"flash {dtype_name} hd={hd}: rows with no visible key are not the "
                          f"mean of V ({_err(got, mean[:, None].expand_as(got))})")
            row_errs[dtype_name] = max(row_errs[dtype_name], hd_row)
            log(f"[flash] {dtype_name} hd={hd}: [B, S, H, hd] entry, B {list(FLASH_GQA_B)} x (H, KH) "
                f"{list(FLASH_GQA_HEADS)} x (Sq, Sk) {list(FLASH_GQA_SHAPES)} x causal / not, and "
                f"positions {list(FLASH_POSITIONS)} == plain; rows with no visible key == the mean "
                f"of V; tiles scored == the skip rule's ({json.dumps(scored)} at B 2, H 9, Sq 300, "
                f"Sk 260); max row error at this hd {hd_row:.3e}; max |err| so far "
                f"{errs[dtype_name]:.3e}")
    for hd in (48, 256):
        try:
            flash_attention_cuda(*_flash_inputs(2, 64, 64, hd, torch.bfloat16, 0))
        except ValueError as e:
            log(f"[flash] hd={hd} raised: {e}")
        else:
            raise RuntimeError(f"flash_attention_cuda took the unsupported head dim {hd}")
    return errs, row_errs


def phase_lm_serve() -> dict:
    """smollm-135m served at full width on the card through the flash
    kernel, held against the plain attention path on the same weights."""
    from repro_torch.launch.serve import ServeSession
    from repro_torch.models import layers
    from repro_torch.models.model import count_params_analytical, forward_train
    from repro_torch.models.params import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    log("[lm] float32 matmuls in full float32 (allow_tf32 False for cuBLAS and cuDNN)")
    max_seq = LM_PROMPT + LM_GEN + 1
    t0 = time.perf_counter()
    sess = ServeSession(LM_ARCH, batch=LM_BATCH, max_seq=max_seq, attention_impl="flash")
    cfg = sess.cfg
    n_params = sum(t.numel() for t in tree_leaves(sess.params))
    check(n_params == count_params_analytical(cfg) == 134_515_008, f"{n_params} parameters")
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} KV heads, head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, tied embeddings; {n_params} parameters in {cfg.dtype}, random from seed 0, "
        f"in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT), dtype=np.int32)
    sess.generate(prompts[:, :64], 2)  # warm-up: library handles, kernel load

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_launches()
    tokens, stats = sess.generate(prompts, LM_GEN, keep_logits=True)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    gen = tokens[:, LM_PROMPT:]
    others = {k: v for k, v in launches.items() if k != "flash_attention" and v}
    check(launches["flash_attention"] == cfg.n_layers and not others,
          f"serve launches {launches}, expected {cfg.n_layers} flash_attention")
    check(tokens.shape == (LM_BATCH, LM_PROMPT + LM_GEN) and np.isfinite(stats["logits"]).all()
          and 0 <= gen.min() and gen.max() < cfg.vocab, "generated tokens or logits malformed")
    step_ms = 1e3 * stats["decode_s"] / (LM_GEN - 1)
    log(f"[lm] flash serve: {LM_BATCH} x {LM_PROMPT} prompt tokens, {LM_GEN} generated; "
        f"launches {launches}; prefill_s {stats['prefill_s']:.6f} "
        f"({LM_BATCH * LM_PROMPT / stats['prefill_s']:.1f} prompt tokens/s); decode_s "
        f"{stats['decode_s']:.6f} over {LM_GEN - 1} steps ({step_ms:.3f} ms a step, "
        f"{stats['decode_tok_per_s']:.1f} tokens/s); max_memory_allocated {peak} bytes "
        f"({peak - base} above the {base} held before)")

    logits_f, cache_f = sess.prefill(prompts)
    xla = ServeSession(LM_ARCH, batch=LM_BATCH, max_seq=max_seq, attention_impl="xla",
                       params=sess.params)
    _reset_launches()
    logits_x, cache_x = xla.prefill(prompts)
    check(_launches()["flash_attention"] == 0, "the xla path launched the flash kernel")
    # The same weights in float32 (xla path): where each bf16 path's rounding
    # takes it, layer by layer.
    ref = ServeSession(LM_ARCH, batch=LM_BATCH, max_seq=max_seq, attention_impl="xla",
                       dtype="float32", params=tree_map(lambda t: t.float(), sess.params))
    logits_t, cache_t = ref.prefill(prompts)
    del ref
    # In bf16 both paths round at every layer, so over 30 layers they agree
    # to bf16's noise elementwise; each is held to the other in relative norm,
    # and each one's distance from the float32 run is logged beside it.
    errs = {"prefill logits": _rel(logits_f, logits_x)}
    log(f"[lm] prefill logits: max |err| flash-xla {_err(logits_f, logits_x):.6f}, flash-f32 "
        f"{_err(logits_f, logits_t):.6f}, xla-f32 {_err(logits_x, logits_t):.6f}; relative norm "
        f"flash-xla {errs['prefill logits']:.6f}, flash-f32 {_rel(logits_f, logits_t):.6f}, "
        f"xla-f32 {_rel(logits_x, logits_t):.6f}")
    for name in ("k", "v"):
        f, x, t = cache_f[name], cache_x[name], cache_t[name]
        worst = {pair: max(_err(a[i], b[i]) for i in range(cfg.n_layers))
                 for pair, a, b in (("flash-xla", f, x), ("flash-f32", f, t), ("xla-f32", x, t))}
        rms = {pair: float((a.float() - b.float()).pow(2).mean().sqrt())
               for pair, a, b in (("flash-xla", f, x), ("flash-f32", f, t), ("xla-f32", x, t))}
        rel = [_rel(f[i], x[i]) for i in range(cfg.n_layers)]
        errs[f"cache {name}"] = max(rel)
        log(f"[lm] cache {name}: max |err| {json.dumps(worst)}; rms {json.dumps(rms)}; flash-xla "
            f"relative norm by layer {json.dumps([round(r, 6) for r in rel])}; max |value| "
            f"{float(t.float().abs().max()):.4f}")
        # Layer 0's K/V precede any attention: the two paths must agree exactly.
        check(torch.equal(f[0], x[0]), f"layer-0 cache {name} differs")
    del cache_t
    # Logits at every prompt position (forward_train), on two of the prompts.
    toks = torch.from_numpy(prompts[:2].copy()).cuda()
    with torch.inference_mode():
        every_f = forward_train(sess.params, {"tokens": toks}, cfg)[0][..., : cfg.vocab]
        every_x = forward_train(sess.params, {"tokens": toks}, xla.cfg)[0][..., : cfg.vocab]
    by_pos = _row_rel(every_f, every_x)
    errs["logits at every position"] = _rel(every_f, every_x)
    log(f"[lm] logits at all {2 * LM_PROMPT} positions of 2 prompts (forward_train): flash-xla "
        f"relative norm {errs['logits at every position']:.6f}; by position max "
        f"{float(by_pos.max()):.6f}, median {float(by_pos.median()):.6f}")
    del every_f, every_x, by_pos
    # A planted fault the bound must see: a kernel that loses keys 64..127
    # (one KV tile) in every layer.
    real = layers.flash_attention_bshd

    def drop_tile(q, k, v, q_pos, k_pos, *, causal):
        keep = torch.ones(k.shape[1], dtype=torch.bool, device=k.device)
        keep[64:128] = False
        return real(q, k[:, keep], v[:, keep], q_pos, k_pos[:, keep], causal=causal)

    layers.flash_attention_bshd = drop_tile
    try:
        logits_b, cache_b = sess.prefill(prompts)
    finally:
        layers.flash_attention_bshd = real
    bad = {"prefill logits": _rel(logits_b, logits_x),
           **{f"cache {n}": max(_rel(cache_b[n][i], cache_x[n][i]) for i in range(cfg.n_layers))
              for n in ("k", "v")}}
    check(max(bad.values()) > LM_TOL, f"a dropped KV tile passes the {LM_TOL} bound: {bad}")
    log(f"[lm] planted fault (keys 64..127 dropped in every layer's attention): flash-xla "
        f"relative norm {json.dumps(bad)}, {max(bad.values()) / LM_TOL:.1f} x the {LM_TOL} bound")
    del logits_b, cache_b
    _reset_launches()
    dec, dec_max = 0.0, 0.0
    for i in range(LM_GEN - 1):  # both paths teacher-forced on the flash session's tokens
        tok = torch.from_numpy(gen[:, i : i + 1].copy()).cuda()
        lf, cache_f = sess.decode(cache_f, tok, LM_PROMPT + i)
        lx, cache_x = xla.decode(cache_x, tok, LM_PROMPT + i)
        dec, dec_max = max(dec, _rel(lf, lx)), max(dec_max, _err(lf, lx))
    errs["decode logits"] = dec
    decode_launches = _launches()
    check(not any(decode_launches.values()), f"decode launched {decode_launches}")
    check(max(errs.values()) <= LM_TOL, f"flash vs xla relative norms {errs} > {LM_TOL}")
    log(f"[lm] flash vs xla on the same weights: relative norm {json.dumps(errs)} (bound "
        f"{LM_TOL}); decode logits max |err| {dec_max:.6f}; decode launches {decode_launches}")
    del cache_f, cache_x
    xtokens, xstats = xla.generate(prompts, LM_GEN)
    share = float((xtokens[:, LM_PROMPT:] == gen).mean())
    log(f"[lm] xla serve (plain attention, chunked above {cfg.long_context_threshold}): "
        f"prefill_s {xstats['prefill_s']:.6f}, decode_s {xstats['decode_s']:.6f} "
        f"({xstats['decode_tok_per_s']:.1f} tokens/s); greedy tokens equal to the flash "
        f"session's: {share:.4f} ({int((xtokens[:, LM_PROMPT:] == gen).sum())} of {gen.size}; "
        f"distinct tokens generated {len(np.unique(gen))})")
    del xla

    f32 = ServeSession(LM_ARCH, batch=2, max_seq=128 + 8 + 1, attention_impl="flash",
                       dtype="float32")
    f32x = ServeSession(LM_ARCH, batch=2, max_seq=128 + 8 + 1, attention_impl="xla",
                        dtype="float32", params=f32.params)
    _reset_launches()
    t32, s32 = f32.generate(prompts[:2, :128], 8, keep_logits=True)
    l32 = _launches()["flash_attention"]
    tx32, sx32 = f32x.generate(prompts[:2, :128], 8, keep_logits=True)
    err32 = float(np.abs(s32["logits"] - sx32["logits"]).max())
    check(l32 == cfg.n_layers, f"float32 run: {l32} flash launches")
    check(np.array_equal(t32, tx32) and np.allclose(s32["logits"], sx32["logits"], rtol=1e-3,
                                                    atol=1e-3),
          f"float32 flash vs xla: tokens equal {np.array_equal(t32, tx32)}, max |err| {err32}")
    log(f"[lm] float32 (batch 2, prompt 128, 8 generated): {l32} flash launches (the f32 "
        f"kernel); tokens equal to xla's; max |err| of logits {err32:.3e} (bound 1e-3)")
    del f32, f32x

    long = ServeSession(LM_ARCH, batch=1, max_seq=LM_LONG + 1, attention_impl="flash",
                        params=sess.params)
    long_prompt = rng.integers(0, cfg.vocab, (1, LM_LONG), dtype=np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_long = torch.cuda.memory_allocated()
    _reset_launches()
    _, lstats = long.generate(long_prompt, 1, keep_logits=True)
    long_launches = _launches()["flash_attention"]
    long_peak = torch.cuda.max_memory_allocated()
    longx = ServeSession(LM_ARCH, batch=1, max_seq=LM_LONG + 1, attention_impl="xla",
                         params=sess.params)
    _, lxstats = longx.generate(long_prompt, 1, keep_logits=True)
    lerr = float(np.abs(lstats["logits"] - lxstats["logits"]).max())
    lrel = _rel(torch.from_numpy(lstats["logits"]), torch.from_numpy(lxstats["logits"]))
    check(long_launches == cfg.n_layers, f"prefill_32k: {long_launches} flash launches")
    check(np.isfinite(lstats["logits"]).all() and lrel <= LM_TOL,
          f"prefill_32k flash vs xla logits: relative norm {lrel}, max |err| {lerr}")
    log(f"[lm] prefill_32k, one sequence of {LM_LONG} tokens: {long_launches} flash launches; "
        f"prefill_s {lstats['prefill_s']:.6f} (xla path {lxstats['prefill_s']:.6f}); last "
        f"logits vs xla: relative norm {lrel:.6f}, max |err| {lerr:.6f}; max_memory_allocated {long_peak} bytes "
        f"({long_peak - base_long} above the {base_long} held before)")
    return {"launches": launches["flash_attention"], "long_launches": long_launches,
            "stats": stats, "xstats": xstats, "long_s": lstats["prefill_s"],
            "long_xla_s": lxstats["prefill_s"], "heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads}


def _flash_bound(qp: torch.Tensor, kp: torch.Tensor, hd: int, heads: int,
                 kv_heads: int) -> tuple[tuple[float, str], int]:
    """Least time for the kernel's work on these inputs: 4 hd flops for each
    visible (query, key) pair of each head at the bf16 tensor rate, against
    Q and O (``heads``), K and V (``kv_heads``) and the positions read or
    written once. Returns (bound, visible pairs over all heads)."""
    b, sq = qp.shape
    sk = kp.shape[1]
    ks, _ = torch.sort(kp, dim=1)
    pairs = heads * int(torch.searchsorted(ks, qp, right=True).sum())
    nbytes = 2 * b * hd * (2 * sq * heads + 2 * sk * kv_heads) + 4 * b * (sq + sk)
    return _bound_ms(nbytes, 4 * hd * pairs, BF16_TENSOR_FLOPS), pairs


def phase_flash_timing(lm: dict) -> list:
    """The kernel at the LM prefill's two shapes, through the model's
    [B, S, H, hd] entry with the GQA heads as they are, beside its bound, its
    plain version and scaled_dot_product_attention on the same operands;
    returns the JSON rows."""
    from repro_torch.kernels.flash_attention import (
        FLASH_TILES,
        flash_attention_bshd_cuda,
        flash_attention_bshd_reference,
        flash_tiles_scored,
    )

    kernel = lambda *a: flash_attention_bshd_cuda(*a, causal=True)  # noqa: E731
    plain = lambda *a: flash_attention_bshd_reference(*a, causal=True)  # noqa: E731
    rows = []
    cells = (("flash_attention", LM_BATCH, LM_PROMPT, lm["launches"], lm["stats"]["prefill_s"]),
             (f"flash_attention[s={LM_LONG}]", 1, LM_LONG, lm["long_launches"], lm["long_s"]))
    for label, batch, s, launches, prefill_s in cells:
        h, kh, hd = lm["heads"], lm["kv_heads"], 64
        ops = _gqa_inputs(batch, s, s, h, kh, hd, torch.bfloat16, seed=s)
        tiles = torch.zeros(1, dtype=torch.int64, device="cuda")
        got = flash_attention_bshd_cuda(*ops, causal=True, tiles=tiles)
        exact = _flash_plain_f32(plain, ops)
        want = exact.to(torch.bfloat16)
        check(torch.equal(want, plain(*ops)), f"{label}: the plain version's output differs")
        q4, k4, v4 = (t.transpose(1, 2) for t in ops[:3])  # [B, heads, S, hd] views
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, is_causal=True, enable_gqa=True)
        lib = sdpa().transpose(1, 2)
        torch.cuda.synchronize()
        err, row_tol = _err(got, want), FLASH_ROW_TOL["bfloat16"]
        rows_rel = _row_rel(got, exact)
        row_err = float(rows_rel.max())
        check(_close(got, want, FLASH_TOL["bfloat16"]) and row_err <= row_tol,
              f"{label}: kernel vs plain max |err| {err}, max row error {row_err}")
        check(_close(lib, want, FLASH_TOL["bfloat16"]),
              f"{label}: scaled_dot_product_attention is not the same function here")
        nq, nk = -(-s // FLASH_TILES[torch.bfloat16][0]), -(-s // FLASH_TILES[torch.bfloat16][1])
        predicted = flash_tiles_scored(ops[3], ops[4], h, *FLASH_TILES[torch.bfloat16])
        check(int(tiles) == predicted, f"{label}: {int(tiles)} tiles scored, the rule says {predicted}")
        # A planted fault the row check must see: the second half of the rows
        # computed without keys 64..127 (one dropped KV tile).
        half, keep = s // 2, torch.ones(s, dtype=torch.bool, device="cuda")
        keep[64:128] = False
        bad = exact.clone()
        bad[:, half:] = _flash_plain_f32(plain, (ops[0][:, half:], ops[1][:, keep], ops[2][:, keep],
                                                 ops[3][:, half:], ops[4][:, keep]))
        bad_rows = _row_rel(bad[:, half:], exact[:, half:])
        bad = bad.to(torch.bfloat16)
        check(float(bad_rows.min()) > row_tol,
              f"{label}: a dropped KV tile passes the row check ({float(bad_rows.min())})")
        log(f"[flash timing] {label}: kernel vs plain max |err| {err:.3e} (elementwise bound "
            f"{FLASH_TOL['bfloat16']}), row error max {row_err:.3e} / median "
            f"{float(rows_rel.median()):.3e} (bound {row_tol}); |out| median "
            f"{float(want.float().abs().median()):.3e}; {int(tiles)} of {batch * h * nq * nk} KV "
            f"tiles scored (== the skip rule). Planted fault (rows {half}.. without keys "
            f"64..127): elementwise check {'passes' if _close(bad, want, FLASH_TOL['bfloat16']) else 'fails'}"
            f" it, its row errors min {float(bad_rows.min()):.3e} / median "
            f"{float(bad_rows.median()):.3e}, so the row check fails every faulty row")
        del got, want, exact, lib, bad, bad_rows, rows_rel
        _time_ms(kernel, [ops], 2)
        ms = _time_ms(kernel, [ops], 10 if s == LM_PROMPT else 3)
        _time_ms(plain, [ops], 1)
        plain_ms = _time_ms(plain, [ops], 2 if s == LM_PROMPT else 1)
        _time_ms(sdpa, [()], 2)
        library_ms = _time_ms(sdpa, [()], 10 if s == LM_PROMPT else 3)
        bound, pairs = _flash_bound(ops[3], ops[4], hd, h, kh)
        log(f"[flash timing] {label}: {ms:.6f} ms/launch (B={batch}, H={h}, KH={kh}, Sq=Sk={s}, "
            f"hd={hd}, bf16, causal; {pairs} visible pairs); bound {bound[0]:.6f} ms "
            f"({bound[1]}: {4 * hd * pairs:.4e} flops at 989 TFLOP/s vs bytes at 3.35 TB/s), "
            f"{100 * bound[0] / ms:.2f}% of bound; plain version {plain_ms:.6f} ms (score blocks "
            f"of at most 2^28 f32); scaled_dot_product_attention (enable_gqa) {library_ms:.6f} ms "
            f"({ms / library_ms:.2f}x this kernel's time against it); max |err| vs plain {err:.3e}; "
            f"{launches} launches x {ms:.6f} ms = {launches * ms:.3f} ms of the {1e3 * prefill_s:.3f} "
            f"ms prefill ({100 * launches * ms / (1e3 * prefill_s):.1f} %)")
        row = _row(label, "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:71", launches, ms, plain_ms, bound,
                   library_ms)
        row["max_abs_err"] = err
        row["max_row_rel_err"] = row_err
        row["tiles_scored"] = int(tiles)
        rows.append(row)
        del ops, q4, k4, v4
    return rows


def _stream_graph(name: str):
    """A config's edges as the stream phases take them: generated from its
    seed and oriented by ``build_graph`` (degree relabel, as
    ``data/graph_pipeline.load_graph`` and ``benchmarks/bench_streaming.py``
    take them), with ``n`` from the graph, not the config."""
    from repro_torch.configs import GRAPHS
    from repro_torch.graphs import build_graph

    return build_graph(_edges(GRAPHS[name]), reorder=True)


def _windows(pairs: int, chunk: int) -> int:
    """Kernel launches of one count over a device work list of ``pairs``
    pairs: its pow2 bucket in windows of ``chunk`` (none when empty)."""
    from repro_torch.core.plan import pow2_ceil

    return math.ceil(pow2_ceil(pairs) / chunk) if pairs else 0


class _BatchProbe:
    """Watches one ``apply_batch`` through its executor's bound methods, so
    the stream's own entry point runs unchanged: the before and after
    count futures, whether the before-count was still in flight on the card
    when the stores were edited (a CUDA event recorded behind it), and the
    launcher the count ran through. ``stall`` cycles of
    ``torch.cuda._sleep`` go ahead of the before-count, so that it is still
    queued when the host reaches the edit."""

    def __init__(self, ex, stall: int = 0):
        self.ex, self.futures, self.pending_at_edit = ex, [], None
        self.launcher = ex._launcher
        count, update, adopt = ex.count_async, ex.update_stores, ex.adopt_stores
        event = []

        def count_async(wl):
            if stall and not self.futures:
                torch.cuda._sleep(stall)
            self.futures.append(count(wl))
            if ex.device.type == "cuda" and len(self.futures) == 1:
                event.append(torch.cuda.Event())
                event[0].record()
            return self.futures[-1]

        def edit(fn):
            def run(*args):
                if event:
                    self.pending_at_edit = not event[0].query()
                return fn(*args)
            return run

        ex.count_async, ex.update_stores, ex.adopt_stores = count_async, edit(update), edit(adopt)

    def close(self) -> list[int]:
        for name in ("count_async", "update_stores", "adopt_stores"):
            del self.ex.__dict__[name]
        return [f.result() for f in self.futures]


def _check_before_count(state, label: str, **batch) -> None:
    """One batch on the card with its before-count held in the stream's
    queue by a stall, against the same batch on the port's CPU path (a twin
    from the stream's snapshot): both counts equal, and unequal to each
    other, the edit enqueued while the before-count was in flight, and the
    launcher kept (in place) or rebuilt over the new stores (growth)."""
    from repro_torch.core import StreamingTCState

    twin = StreamingTCState.from_snapshot(*state.snapshot_tree(), device="cpu")
    card_probe = _BatchProbe(state.executor, STREAM_STALL_CYCLES)
    cpu_probe = _BatchProbe(twin.executor)
    res = state.apply_batch(**batch)
    want = twin.apply_batch(**batch)
    got, plain = card_probe.close(), cpu_probe.close()
    ex = state.executor
    check(got == plain and got[0] != got[1],
          f"{label}: before/after counts on the card {got} != CPU path's {plain}, or equal")
    check(card_probe.pending_at_edit is True,
          f"{label}: the before-count had finished before the store edit")
    check(res.triangles == want.triangles == state.verify(), f"{label}: count after the batch")
    if res.grew:
        check(ex._launcher is not card_probe.launcher and ex.adopts > 0
              and ex._launcher._prefix[0] == ex.row_data.data_ptr()
              and ex._launcher._prefix[2] == ex.col_data.data_ptr(),
              f"{label}: growth did not rebuild the launcher over the new stores")
    else:
        check(ex._launcher is card_probe.launcher, f"{label}: an in-place edit replaced the launcher")
    log(f"[stream] {label}: {'growth (stores re-adopted, launcher rebuilt)' if res.grew else 'in-place edit (launcher kept)'}"
        f" behind a before-count held {STREAM_STALL_CYCLES} cycles: before {got[0]}, after "
        f"{got[1]} == the CPU path's {plain}; the edit was enqueued while the before-count was "
        f"in flight")


def _edit_device_ms(state, hold) -> tuple[float, int]:
    """Device ms of one steady batch's store edit (both sides' gather and
    indexed write, lanes already on the card) from a replayed CUDA graph of
    edits on copies of the stores; and the batch's lane count."""
    from repro_torch.core import update_sbf

    oriented = np.sort(hold, axis=1)
    upd = update_sbf(state._sbf, oriented, None)
    check(not upd.grew, "the timed edit is a steady batch")
    ex = state.executor
    calls = []
    lanes_total = 0
    for lanes, store in ((upd.row_lanes, ex.row_data), (upd.col_lanes, ex.col_data)):
        if not lanes.num_lanes:
            continue
        lanes_total += lanes.num_lanes
        flat = lanes.pos.astype(np.int64) * store.shape[1] + lanes.word
        idx = torch.from_numpy(flat).cuda()
        set_mask = torch.from_numpy(lanes.set_mask.view(np.int32)).cuda()
        clear_mask = torch.from_numpy(lanes.clear_mask.view(np.int32)).cuda()
        calls.append((store.clone().view(-1), idx, set_mask, clear_mask))

    def edit(words, idx, set_mask, clear_mask):
        words.index_copy_(0, idx, (words.index_select(0, idx) | set_mask) & ~clear_mask)

    if not calls:
        return 0.0, 0
    graph = _graph(edit, calls, launches=20 * len(calls))
    ms = _replay_ms(graph, launches=20)  # 20 whole edits (both sides) a replay
    del graph, calls
    return ms, lanes_total


def phase_stream() -> dict:
    """Streaming counts on the card through ``StreamingTCState`` /
    ``tcim_count_delta`` (``build="auto"``: device delta work lists, the
    fused kernel), benchmarks/bench_streaming.py's protocol at full size;
    every batch held to ``verify()``, each fraction's end to the exact
    oracle; the before-count against in-place edits and growth; compaction
    and spill on roadnet-pa. Returns the launches per batch for the
    kernels line."""
    from repro_torch.core import Executor, StreamingTCState, build_sbf, build_worklist, tcim_count
    from repro_torch.core import tcim_count_delta
    from repro_torch.core.plan import clamp_chunk_pairs
    from repro_torch.graphs import build_graph, triangles_intersection
    from repro_torch.kernels import _build
    from repro_torch.kernels.tc_gather_popcount import gather_total_cuda

    smi = nvidia_smi_line()
    chunk = clamp_chunk_pairs(1 << 20, STREAM_SLICE_BITS // 32)
    launches_per_batch = {}
    rng = np.random.default_rng(42)  # benchmarks/bench_streaming.py's seed
    for name, fractions in STREAM_GRAPHS:
        t0 = time.perf_counter()
        g = _stream_graph(name)
        order = rng.permutation(g.m)
        log(f"[stream] {name}: |V|={g.n} |E|={g.m} generated and oriented in "
            f"{time.perf_counter() - t0:.3f} s; card {smi}")
        for frac in fractions:
            b = max(int(g.m * frac), 1)
            hold, base = g.edges[order[:b]], g.edges[order[b:]]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = StreamingTCState(base, n=g.n, slice_bits=STREAM_SLICE_BITS, build="auto")
            seed_s = time.perf_counter() - t0
            check(state.device.type == "cuda" and state._use_device_build,
                  f"{name}: the stream runs on {state.device} (device build {state._use_device_build})")
            check(state.triangles == state.verify(), f"{name}: seed count")
            if name == "email-enron" and frac == STREAM_CHECK_FRACTION:
                _check_before_count(state, f"{name} {frac:g} growth", added=hold)
                _check_before_count(state, f"{name} {frac:g} in place", removed=hold)
            else:  # the bench's warm cycle: growth, then records kept as zeros
                for kw in ({"added": hold}, {"removed": hold}):
                    res = tcim_count_delta(state, kw.get("added"), kw.get("removed"))
                    check(res.triangles == state.verify(), f"{name}: warm batch")
            ex = state.executor
            stores, adopts, libs = ex.store_upload_bytes, ex.adopts, len(_build._LIBS)
            times, splits, pairs, launches, uploads = [], [], [], [], []
            _reset_launches()
            for _ in range(STREAM_ROUNDS):
                for kw in ({"added": hold}, {"removed": hold}):
                    before = (gather_total_cuda.launches, state.index_upload_bytes,
                              ex.lane_upload_bytes, ex.store_upload_bytes)
                    t0 = time.perf_counter()
                    res = state.apply_batch(**kw)
                    times.append(time.perf_counter() - t0)
                    after = (gather_total_cuda.launches, state.index_upload_bytes,
                             ex.lane_upload_bytes, ex.store_upload_bytes)
                    launches.append(after[0] - before[0])
                    uploads.append(tuple(a - c for a, c in zip(after[1:], before[1:])))
                    splits.append(res.timings_s)
                    pairs.append((res.pairs_before, res.pairs_after))
                    want = _windows(res.pairs_before, chunk) + _windows(res.pairs_after, chunk)
                    check(launches[-1] == want,
                          f"{name} {frac:g}: {launches[-1]} launches for {want} windows")
                    check(not res.grew, f"{name} {frac:g}: a steady batch grew")
                    check(res.triangles == state.verify(), f"{name} {frac:g}: batch count")
            check(state.executor is ex and ex.adopts == adopts and ex.store_upload_bytes == stores
                  and len(_build._LIBS) == libs,
                  f"{name} {frac:g}: steady batches re-adopted, uploaded stores or built a library")
            check(state.fallbacks == 0, f"{name} {frac:g}: the 'auto' host fallback fired")
            peak = torch.cuda.max_memory_allocated()
            edit_ms, lanes = _edit_device_ms(state, hold)
            # The two recounts of the final edge set: the warm device-build
            # tcim_count, and the bench's (host build + a fresh Executor).
            edges_now = state.current_edges()
            tcim_count(edges_now, n=g.n, slice_bits=STREAM_SLICE_BITS)
            t0 = time.perf_counter()
            recount = tcim_count(edges_now, n=g.n, slice_bits=STREAM_SLICE_BITS).triangles
            device_recount_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            gh = build_graph(edges_now, n=g.n, reorder=False)
            sb = build_sbf(gh, STREAM_SLICE_BITS)
            bench = Executor(sb).count(build_worklist(gh, sb))
            bench_recount_s = time.perf_counter() - t0
            exact = triangles_intersection(gh)
            check(state.triangles == recount == bench == exact,
                  f"{name} {frac:g}: running {state.triangles}, recounts {recount} / {bench}, "
                  f"oracle {exact}")
            ms = sorted(1e3 * t for t in times)
            per_batch = sum(launches) / len(launches)
            launches_per_batch[f"{name}@{frac:g}"] = per_batch
            split = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}
            up = [sum(u) / len(uploads) for u in zip(*uploads)]
            log(f"[stream] {name} {frac:g} (batch {b} edges, {STREAM_ROUNDS} add/remove rounds "
                f"after the warm cycle; {smi}): {float(np.median(ms)):.3f} ms/batch median, "
                f"{ms[0]:.3f} min (host clock, apply_batch ends in the counts' readback), "
                f"{b / (ms[0] / 1e3):.0f} edges/s at the min; pairs before/after "
                f"{sorted(set(pairs))}; gather_total {per_batch:g} launches/batch; running "
                f"count {state.triangles} == verify() after every batch == oracle")
            log(f"[stream] {name} {frac:g} timings_s medians (dispatch_* and scatter are enqueue "
                f"times on the card; close waits for both counts): {json.dumps(split)}")
            log(f"[stream] {name} {frac:g}: store edit {edit_ms:.6f} ms device time for {lanes} "
                f"lanes (CUDA events over a replayed CUDA graph of edits); uploaded per batch "
                f"{up[0]:.0f} B delta-work-list indices + {up[1]:.0f} B lanes + {up[2]:.0f} B "
                f"stores; recount of the final edge set: warm device-build tcim_count "
                f"{device_recount_s:.6f} s, host build + fresh Executor {bench_recount_s:.6f} s "
                f"(delta min / device recount {ms[0] / 1e3 / device_recount_s:.3f}); seed "
                f"{seed_s:.3f} s; max_memory_allocated {peak} B")
            if name == STREAM_COMPACT_GRAPH and frac == fractions[-1]:
                _stream_compact_and_spill(state, rng)
            del state, ex
    return {"launches_per_batch": launches_per_batch}


def _stream_compact_and_spill(state, rng) -> None:
    """A remove-heavy run until the zero-record ratio passes 0.5, then
    ``compact()`` (count kept, records shrink, launcher rebuilt); then
    ``spill()`` and a batch that re-admits the stream."""
    t0 = time.perf_counter()
    removed = []
    while state.zero_record_ratio() <= 0.5:
        cur = state.current_edges()
        rm = cur[rng.choice(len(cur), len(cur) // 4, replace=False)]
        res = state.apply_batch(removed=rm)
        check(res.triangles == state.verify(), "remove-heavy batch count")
        removed.append(rm)
    ratio = state.zero_record_ratio()
    launcher, count = state.executor._launcher, state.triangles
    stats = state.compact()
    check(state.triangles == count == state.verify() and stats["records_after"] < stats["records_before"]
          and state.zero_record_ratio() == 0.0, f"compaction: {stats}, count {state.triangles}")
    check(state.executor._launcher is not launcher, "compaction kept the old launcher")
    res = state.apply_batch(added=removed[0][: len(removed[0]) // 2])
    check(res.triangles == state.verify(), "batch after compaction")
    log(f"[stream] {STREAM_COMPACT_GRAPH}: {len(removed)} remove batches of a quarter of the "
        f"edges each, zero-record ratio {ratio:.4f}; compact() {stats}, count kept "
        f"({count}), launcher rebuilt; a batch after it == verify(); {time.perf_counter() - t0:.3f} s")
    old = state.executor
    state.spill()
    check(not state.resident, "spill kept the executor")
    res = state.apply_batch(added=removed[0][len(removed[0]) // 2:])
    check(state.resident and state.executor is not old and state.executor._launcher is not None
          and res.triangles == state.verify(), "spill -> batch re-admission")
    log(f"[stream] {STREAM_COMPACT_GRAPH}: spill() then a batch re-admitted the stream (new "
        f"executor and launcher), count {res.triangles} == verify()")


def phase_stream_serve() -> None:
    """Durable stream serving on the card: two streams under a budget that
    holds one, deltas drained and left pending, the server abandoned;
    ``TCServer.restore`` on the card and on the CPU against a server that
    was never killed and the exact oracle; a root written by
    ``checkpoint()`` restored too."""
    import shutil
    import tempfile

    from repro_torch.core import build_sbf
    from repro_torch.graphs import build_graph, triangles_intersection
    from repro_torch.launch.tc_serve import ServeConfig, TCServer

    smi = nvidia_smi_line()
    rng = np.random.default_rng(7)
    streams, footprints = [], []
    for name, keep in SERVE_STREAMS:
        g = _stream_graph(name)
        order = rng.permutation(g.m)
        cut = int(g.m * keep)
        base = g.edges[order[:cut]]
        chunks = np.array_split(g.edges[order[cut:]], SERVE_DELTAS // len(SERVE_STREAMS))
        streams.append((name, g, base, chunks))
        footprints.append(TCServer._stream_footprint(
            build_sbf(build_graph(base, n=g.n, reorder=False), STREAM_SLICE_BITS)))
    budget = max(footprints) + min(footprints) // 2
    check(max(footprints) < budget < sum(footprints), f"budget {budget} for {footprints}")
    cfg = dict(checkpoint_every=8, memory_budget_bytes=budget)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_wal_"))
    try:
        srv = TCServer(ServeConfig(wal_dir=str(work / "wal"), **cfg))
        twin = TCServer(ServeConfig(**cfg))
        t0 = time.perf_counter()
        sids = [srv.create_stream(base, n=g.n) for _, g, base, _ in streams]
        create_s = time.perf_counter() - t0
        tsids = [twin.create_stream(base, n=g.n) for _, g, base, _ in streams]
        deltas = [(k % len(streams), streams[k % len(streams)][3][k // len(streams)])
                  for k in range(SERVE_DELTAS)]
        t0 = time.perf_counter()
        for i, (k, d) in enumerate(deltas):
            srv.submit_delta(sids[k], added=d)
            twin.submit_delta(tsids[k], added=d)
            if i == SERVE_DRAINED - 1:
                out = srv.drain()
                check(len(out) == SERVE_DRAINED and all(r.status == "ok" for r in out),
                      "durable server drain")
        drain_s = time.perf_counter() - t0
        check(all(r.status == "ok" for r in twin.drain()), "uninterrupted server drain")
        live = [srv.stream_count(s) for s in sids]
        live_stats = srv.server_stats()
        for entry in srv._streams.values():
            entry.wal.snaps.wait()
        del srv  # abandoned: no close_stream, no checkpoint()
        want = {s: twin.stream_count(t) for s, t in zip(sids, tsids)}
        exact = {s: triangles_intersection(g) for s, (_, g, _, _) in zip(sids, streams)}
        check(want == exact, f"uninterrupted server {want} != oracle {exact}")
        restored = {}
        for device in ("cuda", "cpu"):
            shutil.copytree(work / "wal", work / device)
            t0 = time.perf_counter()
            srv = TCServer.restore(work / device, device=device)
            restore_s = time.perf_counter() - t0
            check([srv.stream_count(s) for s in sids] == live, f"restore on {device}: live counts")
            check(srv.pending == SERVE_DELTAS - SERVE_DRAINED, f"restore on {device}: pending")
            info = srv.restore_info
            out = srv.drain()
            check(all(r.status == "ok" for r in out), f"restored drain on {device}")
            restored[device] = ({s: srv.stream_count(s) for s in sids}, srv.server_stats())
            log(f"[stream serve] restore on {device}: {restore_s:.3f} s, {json.dumps(info)}; "
                f"drained the {len(out)} pending deltas")
            if device == "cuda":
                for s in sids:
                    check(srv._streams[s].state.verify() == want[s], "restored stream verify()")
            del srv
        card, cpu = restored["cuda"], restored["cpu"]
        check(card == cpu, f"restored on the card {card} != on the CPU {cpu}")
        stream_keys = ("streams", "streams_resident", "streams_spilled", "stream_bytes")
        tstats = twin.server_stats()
        check(card[0] == want and all(card[1][k] == tstats[k] for k in stream_keys),
              f"restored {card} != uninterrupted {want}, {tstats}")
        t0 = time.perf_counter()
        twin.checkpoint(work / "ckpt")
        ckpt_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = TCServer.restore(work / "ckpt")
        again_s = time.perf_counter() - t0
        check({s: again.stream_count(t) for s, t in zip(sids, tsids)} == want and again.pending == 0,
              "restore of the checkpoint() root")
        log(f"[stream serve] two streams ({', '.join(f'{n} at {k:.0%}' for n, k in SERVE_STREAMS)}), "
            f"footprints {footprints} B, budget {budget} B; created in {create_s:.3f} s; "
            f"{SERVE_DELTAS} deltas, {SERVE_DRAINED} drained in {drain_s:.3f} s (with the twin's "
            f"submits), {SERVE_DELTAS - SERVE_DRAINED} left pending at the kill; live stats "
            f"{json.dumps({k: live_stats[k] for k in live_stats if k not in ('pool', 'fused')})}; "
            f"restored on the card == on the CPU == never-killed server {want} == oracle; "
            f"checkpoint() {ckpt_s:.3f} s and its restore {again_s:.3f} s; {smi}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    name = phase_device()
    phase_build()
    err = phase_kernel_cases()
    err_seg = phase_segment_cases()
    err_unfused = phase_unfused_cases()
    main_run = phase_main()
    phase_device_build(main_run)
    row, err_main, chunks, store_row, store_col = phase_timing(main_run)
    row["max_abs_err"] = max(err, err_main)
    serve = phase_serve()
    rows, err_serve = phase_serve_timing(serve, chunks, store_row, store_col)
    rows[0]["max_abs_err"] = max(err_seg, err_serve)
    for r in rows[1:]:
        r["max_abs_err"] = max(err_unfused, err_serve)
    err_bitgemm, err_mxu = phase_dense_cases()
    dense = phase_dense()
    dense_rows = phase_dense_timing(dense)
    dense_rows[0]["max_abs_err"] = err_bitgemm
    for r in dense_rows[1:]:
        r["max_abs_err"] = err_mxu
    err_flash, row_err_flash = phase_flash_cases()
    lm = phase_lm_serve()
    flash_rows = phase_flash_timing(lm)
    for r in flash_rows:
        r["max_abs_err"] = max(r["max_abs_err"], *err_flash.values())
        r["max_row_rel_err"] = max(r["max_row_rel_err"], *row_err_flash.values())
    stream = phase_stream()
    row["stream_launches_per_batch"] = stream["launches_per_batch"]
    phase_stream_serve()
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": [row, *rows, *dense_rows, *flash_rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
