#!/usr/bin/env python3
"""Time what each design choice of the two Hopper-redesigned kernels gives.

    PYTHONPATH=src python3 tools/kernel_levers.py

Needs one NVIDIA Hopper card and ``nvcc``; exits non-zero without them.

``flash_attention``: builds variants of ``kernels/csrc/flash_attention.cu``,
each with one lever undone by a text substitution of the source (checked
to apply), and times each through ``flash_attention_bshd_cuda`` at the LM
serving prefill's shapes (8 x 4096 and 1 x 32,768, 9 heads, 3 KV heads,
hd 64, bf16, causal), in the order variants then variants reversed, beside
``scaled_dot_product_attention``. Every variant computes the same function
and is held to the kernel's output (bf16 rounding apart):

  * ``no_skip``: every KV tile scored, also those the causal mask hides;
  * ``mask_every_tile``: the mask's selects on every tile, not only on
    tiles that cross the diagonal or Sk;
  * ``not_pipelined``: S of the next tile issued only after P V of this
    one is done, so the softmax no longer overlaps an MMA;
  * ``natural_exp``: ``expf`` on natural-log scores instead of ``ex2`` on
    scores with log2(e) folded into the scale.

``dense_mxu_tc``: the tile order of its plan at ego-facebook's and
email-enron's N (the config graphs, oriented as ``tcim_count`` does):
heaviest first, and in 12 x 12 groups, against the wrapper's choice.

Prints one line per reading, the card's name and power limit, and a JSON
object of every reading last.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "levers"
FLASH_SHAPES = ((8, 4096), (1, 32768))
HEADS, KV_HEADS, HEAD_DIM = 9, 3, 64

LEVERS = {
    "final": [],
    "no_skip": [("        if (causal && pass == 0 && kmin > qmax) continue;  // wholly masked\n", "")],
    "mask_every_tile": [(
        "        const int unmasked = n0 + kTile <= sk && (!causal || kmax <= qmin);",
        "        const int unmasked = 0;")],
    "not_pipelined": [(
        "          issue_qk<HD>(s, q_wg, s_k + stage * P::kTileBytes);\n"
        "          issue_pv<HD>(acc, pa, s_v + held * P::kTileBytes);\n"
        "          wgmma_wait<1>();",
        "          issue_pv<HD>(acc, pa, s_v + held * P::kTileBytes);\n"
        "          wgmma_wait<0>();\n"
        "          issue_qk<HD>(s, q_wg, s_k + stage * P::kTileBytes);\n"
        "          wgmma_wait<0>();")],
    "natural_exp": [
        ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "  y = expf(x);"),
        ("constexpr float kLog2e = 1.4426950408889634f;", "constexpr float kLog2e = 1.0f;"),
    ],
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, rounds: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / rounds


def build_variants() -> dict:
    """Write and compile every variant at once; returns {name: C function}."""
    from repro_torch.kernels import _build

    source = (CSRC / "flash_attention.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in LEVERS.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"lever {name}: the source no longer holds {old!r} once")
            text = text.replace(old, new)
        src = OUT / f"flash_{name}.cu"
        src.write_text(text)
        lib = OUT / f"flash_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC}", "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    fns = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for lever {name}:\n{text}")
        fn = ctypes.CDLL(str(lib)).flash_attention_fwd
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                       ctypes.c_float, vp, vp]
        fn.restype = ci
        fns[name] = fn
    return fns


def flash_levers(fns: dict) -> dict:
    from repro_torch.kernels import flash_attention as fa

    readings = {}
    for batch, s in FLASH_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(s)
        q = torch.randn(batch, s, HEADS, HEAD_DIM, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(batch, s, KV_HEADS, HEAD_DIM, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        pos = torch.arange(s, dtype=torch.int32, device="cuda")[None].expand(batch, s)
        rounds = 10 if s == 4096 else 3
        times = {name: [] for name in fns}
        want = None
        for name in [*fns, *reversed(list(fns))]:
            fa._kernel = lambda fn=fns[name]: fn
            got = fa.flash_attention_bshd_cuda(q, k, v, pos, pos)
            want = got if want is None else want
            err = float((got.float() - want.float()).abs().max())
            if err > 2e-2:
                raise RuntimeError(f"lever {name} at {batch} x {s}: output off by {err}")
            times[name].append(time_ms(lambda: fa.flash_attention_bshd_cuda(q, k, v, pos, pos),
                                       rounds))
        q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True), rounds)
        cell = f"{batch}x{s}"
        readings[cell] = {**times, "scaled_dot_product_attention": sdpa}
        for name, ts in times.items():
            log(f"[levers] flash {cell} {name}: {', '.join(f'{t:.6f}' for t in ts)} ms")
        log(f"[levers] flash {cell} scaled_dot_product_attention (enable_gqa): {sdpa:.6f} ms")
        del q, k, v, q4, k4, v4
    return readings


def dense_levers() -> dict:
    from repro_torch.configs import GRAPHS
    from repro_torch.core.tcim import _dense_upper
    from repro_torch.graphs import GRAPH_GENERATORS, build_graph
    from repro_torch.kernels import tc_dense_mxu as dm

    readings = {}
    choose = dm._plan_group
    for name in ("ego-facebook", "email-enron"):
        cfg = GRAPHS[name]
        edges = GRAPH_GENERATORS[cfg.generator](cfg.n, cfg.m, seed=cfg.seed)
        a = _dense_upper(build_graph(edges, reorder=True), torch.device("cuda"))
        out = torch.zeros(1, dtype=torch.int64, device="cuda")
        orders = {"wrapper's choice": choose, "heaviest first": lambda n, dev: 1,
                  "12 x 12 groups": lambda n, dev: dm.PLAN_GROUP}
        times = {order: [] for order in orders}
        for order in [*orders, *reversed(list(orders))]:
            dm._plan_group = orders[order]
            times[order].append(time_ms(lambda: dm.dense_mxu_tc_cuda(a, out), 3))
        dm._plan_group = choose
        readings[name] = times
        for order, ts in times.items():
            log(f"[levers] dense_mxu_tc {name} (N {a.shape[0]}) {order}: "
                f"{', '.join(f'{t:.6f}' for t in ts)} ms")
        del a
    return readings


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_levers: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    readings = {"flash_attention": flash_levers(build_variants()), "dense_mxu_tc": dense_levers()}
    print(smi.splitlines()[0])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
