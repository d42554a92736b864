#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

  1. device   require a card; print its name and power limit
  2. build    compile every CUDA kernel of the path from ``src/repro_torch/
              kernels/csrc`` (one ``nvcc`` per source, all at once) and print
              the ``ptxas -v`` registers and spills
  3. kernels  each kernel against its plain torch version on the card, exact
              equality, over word widths, sizes, sentinels, hot indices and
              an out-of-range index that must raise at ``result()``
  4. main     ``repro_torch.core.tcim_count`` on ``com-youtube`` at full size
              (the paper's Table II graph, generated from its config and
              seed), held against the port's CPU path and the exact oracle,
              with the kernel's launch count equal to the chunk count; then
              ``ego-facebook`` and ``email-enron`` at slice_bits 32/64/128
  5. timing   CUDA-event times of the kernel and its plain version at the
              main path's shapes, the bound, per-stage times and peak memory

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
KERNEL_SOURCES = ("tc_gather_popcount",)


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


def phase_device() -> str:
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s); card 0: {name}")
    log(f"[device] nvidia-smi: {nvidia_smi_line()}")
    return name


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.compile_sources(KERNEL_SOURCES)
    log(f"[build] {len(libs)} kernel source(s) built in {time.perf_counter() - t0:.2f} s")
    for name in KERNEL_SOURCES:
        for line in _build.ptxas_report(name):
            log(f"[build] {name}: {line}")


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
        for p in (0, 1, 1000, 1 << 20):
            r = rng.integers(0, num_rows, size=p).astype(np.int32)
            c = rng.integers(0, num_cols, size=p).astype(np.int32)
            r[rng.random(p) < 0.1] = -1  # sentinels on either side
            c[rng.random(p) < 0.1] = -1
            hot = rng.random(p) < 0.25  # repeated hot indices
            r[hot], c[hot] = 7, 11
            got, want = _compare(row, col, torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda())
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got, want), f"W={w} P={p}: kernel {got.tolist()} != plain {want.tolist()}")
            log(f"[kernels] gather_total W={w} P={p}: {got.tolist()} == plain")
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
    """The main path on the card, held against the CPU path and the oracle."""
    from repro_torch.configs import GRAPHS
    from repro_torch.core import tcim_count
    from repro_torch.core.plan import clamp_chunk_pairs
    from repro_torch.graphs import build_graph, triangles_intersection
    from repro_torch.kernels.tc_gather_popcount import gather_total_cuda

    cfg = GRAPHS[MAIN_GRAPH]
    t0 = time.perf_counter()
    edges = _edges(cfg)
    log(f"[main] {cfg.name}: generated |V|={cfg.n} |E|={len(edges)} in {time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather_total_cuda.launches = 0
    t0 = time.perf_counter()
    res = tcim_count(edges, slice_bits=MAIN_SLICE_BITS)
    wall = time.perf_counter() - t0
    launches = gather_total_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    chunk = clamp_chunk_pairs(1 << 20, MAIN_SLICE_BITS // 32)
    chunks = math.ceil(res.stats["num_pairs"] / chunk)
    log(f"[main] card: {res.triangles} triangles, {res.stats['num_pairs']} slice pairs, "
        f"{chunks} chunks, {launches} kernel launches, {wall:.3f} s wall")
    log(f"[main] timings_s: {json.dumps(res.timings_s)}")
    log(f"[main] max_memory_allocated: {peak} bytes")
    check(res.stats["device"].startswith("cuda"), f"main path ran on {res.stats['device']}")
    check(launches == chunks, f"kernel launched {launches} times for {chunks} chunks")

    cpu = tcim_count(edges, slice_bits=MAIN_SLICE_BITS, device="cpu")
    log(f"[main] port CPU path: {cpu.triangles} triangles")
    t0 = time.perf_counter()
    g = build_graph(edges, reorder=True)
    exact = triangles_intersection(g)
    log(f"[main] exact oracle (triangles_intersection): {exact} in {time.perf_counter() - t0:.2f} s")
    log(f"[main] JAX package's count of this graph, for reference: {JAX_PACKAGE_COUNT}")
    check(res.triangles == cpu.triangles == exact,
          f"card {res.triangles}, CPU {cpu.triangles}, oracle {exact}")

    for name in SMALL_GRAPHS:
        small = _edges(GRAPHS[name])
        want = triangles_intersection(build_graph(small, reorder=True))
        for bits in (32, 64, 128):
            got = tcim_count(small, slice_bits=bits).triangles
            check(got == want, f"{name} slice_bits={bits}: card {got} != oracle {want}")
            log(f"[main] {name} slice_bits={bits}: {got} == oracle")
    return {"graph": g, "launches": launches, "result": res, "peak": peak}


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


def phase_timing(main: dict) -> tuple[dict, int]:
    """Kernel vs plain at the main path's shapes (W=2, P=1<<20 chunks over
    the com-youtube stores); returns the kernel's JSON row and max |err|."""
    from repro_torch.core import Executor, build_sbf, build_worklist
    from repro_torch.core.plan import pow2_ceil
    from repro_torch.kernels.tc_gather_popcount import (
        gather_total_cuda,
        gather_total_reference,
    )

    sb = build_sbf(main["graph"], MAIN_SLICE_BITS)
    wl = build_worklist(main["graph"], sb)
    ex = Executor(sb)  # the resident, pow2-padded stores the main path uses
    row, col = ex.row_data, ex.col_data
    chunks = []
    for ridx, cidx in ex._chunks(wl.pair_row_pos, wl.pair_col_pos):
        chunks.append((torch.from_numpy(ridx).cuda(), torch.from_numpy(cidx).cuda()))
    check(all(len(r) == pow2_ceil(len(r)) for r, _ in chunks), "chunks are pow2 buckets")

    max_err = 0
    total = 0
    bound_s = 0.0
    for ridx, cidx in chunks:
        got, want = _compare(row, col, ridx, cidx)
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"main-path chunk: kernel {got.tolist()} != plain {want.tolist()}")
        total += int(got[0])
        # Least bytes: both index arrays, each distinct store row named once, out.
        w = row.shape[1]
        rows_read = torch.unique(ridx[(ridx >= 0) & (cidx >= 0)]).numel()
        cols_read = torch.unique(cidx[(ridx >= 0) & (cidx >= 0)]).numel()
        nbytes = 8 * len(ridx) + 4 * w * (rows_read + cols_read) + 8
        ops = 3 * w * len(ridx)  # AND, popc, add per word
        bound_s += max(nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S)
    check(total == main["result"].triangles, f"chunk totals {total} != count")
    bound_ms = 1e3 * bound_s / len(chunks)

    out = torch.zeros(2, dtype=torch.int32, device="cuda")
    kernel_calls = [(row, col, r, c, out) for r, c in chunks]
    _time_ms(gather_total_cuda, kernel_calls, 1)  # warm-up
    rounds = max(2, math.ceil(20 / len(chunks)))
    ms = _time_ms(gather_total_cuda, kernel_calls, rounds)
    plain_calls = [(row, col, r, c) for r, c in chunks]
    _time_ms(gather_total_reference, plain_calls[:2], 1)
    plain_ms = _time_ms(gather_total_reference, plain_calls, 1)
    stores = sb.row_slice_data.nbytes + sb.col_slice_data.nbytes
    whole = (stores + 8 * wl.num_pairs) / HBM_BYTES_PER_S * 1e3
    log(f"[timing] gather_total: {ms:.6f} ms/chunk over {rounds * len(chunks)} launches "
        f"(P={len(chunks[0][0])}, W={row.shape[1]}); bound {bound_ms:.6f} ms/chunk "
        f"(bytes), {100 * bound_ms / ms:.2f}% of bound; plain version {plain_ms:.6f} ms/chunk; "
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
    }
    return row_json, max_err


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
    main_run = phase_main()
    row, err_main = phase_timing(main_run)
    row["max_abs_err"] = max(err, err_main)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
