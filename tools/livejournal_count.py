#!/usr/bin/env python3
"""Count com-livejournal at full size through ``tcim_count``'s documented path.

    PYTHONPATH=src python3 tools/livejournal_count.py [--scale 1.0] [--slice-bits 64]
        [--workers 4] [--device cuda] [--out chiprun_out/livejournal_count.json]

The paper's largest graph (|V| 3,997,962, |E| 34,681,189, ``rmat`` from the
config's seed) has more slice-pair candidates than the device build takes
(2**30), so ``tcim_count(edges, backend="pallas_total")`` under
``build="auto"`` raises the device build's refusal inside and counts on the
host build: ``build_graph``, ``build_sbf``, ``build_worklist`` (NumPy), then
the ``gather_total`` kernel through the executor on the card. The script:

  1. generates the graph (timed) and orients it on the host for the oracle;
  2. starts the exact count (``triangles_forked``: ``graphs/exact.py::
     triangles_intersection`` over ``--workers`` forked processes) in a
     forked process, beside the count;
  3. times ``build="device"`` until its ``ValueError`` (what the refused
     attempt inside "auto" costs);
  4. counts through ``build="auto"``: asserts ``stats["build"] == "host"``,
     reports the stage split, pairs, ``gather_total``'s launches, the
     execute time, the peak device memory and the wall time;
  5. asserts the count equal to the oracle's.

Prints each figure as it comes, then one JSON line (also written to
``--out``). ``--scale`` and ``--device cpu`` rehearse it on a host without a
card (``build="auto"`` on the CPU takes the host build directly). Imports
``torch``, ``numpy`` and the port only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import GRAPHS  # noqa: E402
from repro_torch.core import tcim_count  # noqa: E402
from repro_torch.graphs import GRAPH_GENERATORS, build_graph, triangles_intersection  # noqa: E402
from repro_torch.kernels.tc_gather_popcount import gather_total_cuda  # noqa: E402

GRAPH = "com-livejournal"


def triangles_forked(g, workers: int) -> int:
    """``triangles_intersection(g)`` over ``workers`` contiguous ranges of
    the oriented edges (each against the whole adjacency), each range in a
    forked process: the same exact count. Call it from a process that has
    run no torch op: a fork copies no thread, so a child of a process whose
    torch threads have started may wait on a lock that nobody holds."""
    if workers <= 1 or len(g.edges) < 2:
        return triangles_intersection(g)
    ctx = multiprocessing.get_context("fork")
    bounds = np.linspace(0, len(g.edges), min(workers, len(g.edges)) + 1).astype(np.int64)
    parts = []
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        recv, send = ctx.Pipe(duplex=False)
        part = dataclasses.replace(g, edges=g.edges[lo:hi])
        proc = ctx.Process(target=lambda part=part, send=send: send.send(
            triangles_intersection(part)))
        proc.start()
        send.close()
        parts.append((proc, recv))
    total = 0
    for proc, recv in parts:
        total += recv.recv()  # EOFError if the process died without a count
        proc.join()
        if proc.exitcode != 0:
            raise RuntimeError(f"an edge range's process exited {proc.exitcode}")
    return total


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "no card (CPU run)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--slice-bits", type=int, default=64)
    ap.add_argument("--workers", type=int, default=4, help="processes of the exact count")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "livejournal_count.json"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("livejournal_count: no card; pass --device cpu to rehearse", file=sys.stderr)
        return 1
    smi = card_line(device)
    t_start = time.perf_counter()
    cfg = GRAPHS[GRAPH].scaled(args.scale)
    rec: dict = {"graph": GRAPH, "scale": args.scale, "n": cfg.n, "slice_bits": args.slice_bits,
                 "device": str(device), "card": smi}

    t0 = time.perf_counter()
    edges = GRAPH_GENERATORS[cfg.generator](cfg.n, cfg.m, seed=cfg.seed)
    rec["m"], rec["gen_s"] = len(edges), time.perf_counter() - t0
    log(f"[lj] {GRAPH} x{args.scale}: |V|={cfg.n} |E|={rec['m']} generated in {rec['gen_s']:.2f} s")
    t0 = time.perf_counter()
    g = build_graph(edges, reorder=True)
    rec["oracle_orient_s"] = time.perf_counter() - t0
    # Forked before the count touches the card: the oracle's process (and
    # the workers it forks in turn) run NumPy only.
    ctx = multiprocessing.get_context("fork")
    recv, send = ctx.Pipe(duplex=False)

    def exact():
        t = time.perf_counter()
        send.send((triangles_forked(g, args.workers), time.perf_counter() - t))

    worker = ctx.Process(target=exact)
    worker.start()
    del g
    log(f"[lj] oracle: graph oriented in {rec['oracle_orient_s']:.2f} s; triangles_intersection "
        f"started over {args.workers} processes beside the count")

    if device.type == "cuda":
        sync(device)
        t0 = time.perf_counter()
        try:
            tcim_count(edges, backend="pallas_total", build="device", slice_bits=args.slice_bits,
                       device=device)
        except ValueError as e:
            sync(device)
            rec["refused_s"], rec["refusal"] = time.perf_counter() - t0, str(e)
        else:
            raise RuntimeError("the device build took a graph past its limit")
        log(f"[lj] build='device' raised after {rec['refused_s']:.3f} s: {rec['refusal']}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gather_total_cuda.launches = 0
    sync(device)
    t0 = time.perf_counter()
    res = tcim_count(edges, backend="pallas_total", slice_bits=args.slice_bits, device=device)
    sync(device)
    rec["wall_s"] = time.perf_counter() - t0
    rec["build"] = res.stats["build"]
    rec["timings_s"] = res.timings_s
    rec["pairs"] = res.stats["num_pairs"]
    rec["nvs"] = res.stats["nvs"]
    rec["launches"] = gather_total_cuda.launches
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    rec["triangles"] = res.triangles
    # What the wall holds beyond the host build's stages: on the card, the
    # refused device attempt (orient and SBF on the device) and the fallback.
    rec["outside_stages_s"] = rec["wall_s"] - sum(res.timings_s.values())
    log(f"[lj] build='auto': {res.triangles} triangles, build {rec['build']!r}, {rec['pairs']} "
        f"pairs, {rec['launches']} gather_total launches, {rec['wall_s']:.3f} s wall, timings_s "
        f"{json.dumps(res.timings_s)}, outside the stages {rec['outside_stages_s']:.3f} s, "
        f"max_memory_allocated {rec['peak_bytes']} bytes; {smi}")
    t0 = time.perf_counter()
    rec["exact"], rec["oracle_s"] = recv.recv()
    worker.join()
    rec["oracle_wait_s"] = time.perf_counter() - t0
    log(f"[lj] triangles_intersection: {rec['exact']} in {rec['oracle_s']:.2f} s "
        f"({rec['oracle_wait_s']:.2f} s waited after the count)")
    rec["total_s"] = time.perf_counter() - t_start
    if rec["build"] != "host" and device.type == "cuda":
        raise RuntimeError(f"build='auto' took {rec['build']!r}, not the host build")
    if rec["triangles"] != rec["exact"]:
        raise RuntimeError(f"count {rec['triangles']} != oracle {rec['exact']}")
    if device.type == "cuda" and rec["launches"] < 1:
        raise RuntimeError("the count launched no gather_total")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    log(f"[lj] all checks passed in {rec['total_s']:.1f} s; {smi}")
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
