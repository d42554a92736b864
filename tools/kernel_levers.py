#!/usr/bin/env python3
"""Time what each design choice of the Hopper-redesigned kernels gives.

    PYTHONPATH=src python3 tools/kernel_levers.py [probe] [bitgemm] [flash] [flash_exact] [dense] [gather]

Runs the named sections (all six when none is named). Needs one NVIDIA
Hopper card and ``nvcc``; exits non-zero without them.

``probe``: the register-only rate of each tensor-core MMA a popcount-GEMM
can use, in bit products a second on every SM (operands that never
change, no load from device memory): ``wgmma`` m64n256k256 b1 AND-popcount
and m64n256k32 s8 from shared memory, ``mma.sync`` m16n8k256 b1 and
m16n8k32 s8 from registers; with ``ptxas -v`` and the SASS MMA opcodes.

``bitgemm``: builds variants of ``kernels/csrc/tc_bitgemm.cu`` by text
substitution of the source (checked to apply) and times each through
``bitgemm_cuda`` at the email-enron chunk (I 2,048, J 36,692, W 1,147), in
the order variants then variants reversed, each held to the final
kernel's output exactly:

  * ``(b) mma.sync b1``: m16n8k256 b1 AND-popcount on fragments loaded
    with ``ldmatrix`` from the same stages, instead of ``wgmma``;
  * ``(c) s8 wgmma, bits expanded``: the bits expanded to {0,1} bytes in
    shared memory, one word at a time, and m64n256k32 s8 ``wgmma`` on them;
  * ``no grouping``: the output tiles walked row tile by row tile, so
    every row tile streams all of Y (168 MB, above L2) again;
  * ``no multicast (clusters of 1)``: every CTA loads its whole Y stage
    itself, so L2 serves each Y stage twice as often;
  * ``clusters of 4``: four row tiles share each Y stage, a quarter each;
  * ``4-byte epilogue stores``: each output int32 stored alone, not four
    adjacent ones as one 16-byte vector.

``flash``: variants of ``kernels/csrc/flash_attention.cu``, each with one
lever undone, timed through ``flash_attention_bshd_cuda`` at the LM
serving prefill's shapes (8 x 4096 and 1 x 32,768, 9 heads, 3 KV heads,
hd 64, bf16, causal), in the same turns, beside
``scaled_dot_product_attention``. Every variant computes the same function
and is held to the kernel's output (bf16 rounding apart):

  * ``no_skip``: every KV tile scored, also those the causal mask hides;
  * ``mask_every_tile``: the mask's selects on every tile, not only on
    tiles that cross the diagonal or Sk;
  * ``not_pipelined``: S of the next tile issued only after P V of this
    one is done, so the softmax no longer overlaps an MMA;
  * ``natural_exp``: ``expf`` on natural-log scores instead of ``ex2`` on
    scores with log2(e) folded into the scale.

These undo levers of the hd 16-128 body only (``flash_bf16_kernel`` on
``Plan``), not of the exact-width plan that hd 80 and 112 take.

``flash_exact``: the exact-width plan of hd 80 and 112 at the families'
shapes (zamba2-7b: B 4 x 512, H 32, hd 112, causal; hubert-xlarge: B 4 x
512, H 16, hd 80, not causal), each variant timed a call through
``flash_attention_bshd_cuda`` (CUDA events) and alone on the device (a
replayed CUDA graph of 50 launches), in turns, beside
``scaled_dot_product_attention``, each held to the kernel's output within
2e-2:

  * ``padded_panels``: the kernel these widths ran before the exact-width
    plan, hd 128's plan with its second 64-column panel zero past hd
    (``exact_plan`` false);
  * ``attribute_every_call``: ``cudaFuncSetAttribute`` on every launch,
    not once a device;
  * ``register_store``: O stored from registers, 4 bytes a store, not
    staged in shared memory and written by TMA (the Q buffer handed back
    at once);
  * ``no_overlap``: one work item a block (a grid of every item), so no
    item's loads overlap another's epilogue;
  * ``no_ping_pong``: each consumer warpgroup issues its MMAs when it is
    ready, not in turns with the other;
  * ``deepest_ring``: as many stages as shared memory holds (8 at hd 80,
    6 at hd 112), not 4;
  * ``full_tiles``: KV stages of 128 keys, S by m64n128k16, a ring of 4 at
    hd 80 and 3 at hd 112 (ptxas spills there);
  * ``old_launch_path``: the final kernel behind the launch path before
    it was made lean (shapes checked twice, strides from meta tensors, the
    cost computed with no counter, a device context and a stream object).

``dense``: the tile order of ``dense_mxu_tc``'s plan at ego-facebook's and
email-enron's N (the config graphs, oriented as ``tcim_count`` does):
heaviest first, and in 12 x 12 groups, against the wrapper's choice.

``gather``: the two sparse kernels of ``kernels/csrc/tc_gather_popcount.cu``.
``gather_total`` at com-youtube's chunks (P 1<<20, W 2, the main path's 15
chunks in turns) as device time alone (a CUDA graph of 50 launches,
replayed), in the order variants then variants reversed, each held to the
final kernel's sums exactly:

  * ``no_evict_first``: index loads through ``__ldg`` instead of ``__ldcs``;
  * ``not_pipelined``: the next round's index loads issued after this
    round's gathers are used, not before;
  * ``int4_consecutive``: four consecutive pairs a thread, their indices in
    one 16-byte load a side where aligned, instead of lane-adjacent pairs;
  * ``one_pair_a_thread``: the kernel it replaced, one pair a thread in a
    grid-stride loop of at most eight blocks an SM, its SM count queried
    every launch.

The segment kernel over the serving fleet's wave (its 34 cached batches,
the fleet of ``chip_smoke.py``'s serve phase without its solos): one grouped
launch against ``no_grouping``, the same kernel launched once a batch, each
per call and as device time alone, both held to the plain version.

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
# (B, S, H, KH, hd, causal) of zamba2-7b's and hubert-xlarge's attention.
EXACT_CELLS = {"zamba2-7b hd 112": (4, 512, 32, 32, 112, True),
               "hubert-xlarge hd 80": (4, 512, 16, 16, 80, False)}

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
# The exact-width plan's epilogue before O went through shared memory: 4-byte
# stores from registers, the Q buffer handed back at once.
REGISTER_STORE = """    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(args.o) + it.b * args.o_sb + it.h * args.o_sh;
    const int row0 = it.q0 + r_lo;
    const int row1 = row0 + 8;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      if (row0 < sq) {
        *reinterpret_cast<__nv_bfloat162*>(o + row0 * args.o_ss + c) =
            __floats2bfloat162_rn(acc[4 * j] * r0, acc[4 * j + 1] * r0);
      }
      if (row1 < sq) {
        *reinterpret_cast<__nv_bfloat162*>(o + row1 * args.o_ss + c) =
            __floats2bfloat162_rn(acc[4 * j + 2] * r1, acc[4 * j + 3] * r1);
      }
    }
    bar_sync(1 + wg, 128);  // every wgmma of the warpgroup is done with Q
    if (leader) mbar_arrive(&q_empty[qb]);
  }"""
STAGED_STORE = """    // The warpgroup's wgmmas no longer read its 64 rows of Q: O takes them.
    stage_o<HD>(acc, s_qt, r_lo, tig, r0, r1);
    fence_async_shared();
    bar_sync(1 + wg, 128);
    if (leader) {
      const int row = it.q0 + wg * 64;
      if (row < sq) {
#pragma unroll
        for (int p = 0; p < panel_count(HD); ++p) {
          tma_store_4d(&maps.o[p],
                       s_qt + panel_col0(HD, p) * 2 * kTile + wg * 64 * 2 * panel_cols(HD, p),
                       panel_col0(HD, p), it.h, row, it.b);
        }
      }
      bulk_commit();
      stored = qb;
    }
  }"""
EXACT_LEVERS = {
    "final": [],
    "padded_panels": [(
        "__host__ __device__ constexpr bool exact_plan(int hd) { return hd == 80 || hd == 112; }",
        "__host__ __device__ constexpr bool exact_plan(int hd) { return false; }")],
    "attribute_every_call": [(
        "  if (kept && done[device].load(std::memory_order_relaxed)) return 0;\n", "")],
    "register_store": [(STAGED_STORE, REGISTER_STORE)],
    "no_overlap": [("  const long long blocks = sm_count(device);  // one block an SM fits: a persistent grid",
                    "  const long long blocks = INT_MAX;")],
    "no_ping_pong": [("    mbar_wait(&turn[wg], turn_phase);\n    turn_phase ^= 1;\n", ""),
                     ("    if (leader) mbar_arrive(&turn[wg ^ 1]);\n", "")],
    "deepest_ring": [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 8;")],
    "full_tiles": [("constexpr int kStageKeys = 64;", "constexpr int kStageKeys = 128;")],
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


def build_variants(levers: dict, tag: str = "flash") -> dict:
    """Write and compile every variant at once; returns {name: C function}."""
    from repro_torch.kernels import _build

    source = (CSRC / "flash_attention.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in levers.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"lever {name}: the source no longer holds {old!r} once")
            text = text.replace(old, new)
        src = OUT / f"{tag}_{name}.cu"
        src.write_text(text)
        lib = OUT / f"{tag}_{name}.so"
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
                       ctypes.c_float, vp, ci, vp]
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


def old_launch_path(q, k, v, q_pos, k_pos, causal: bool) -> torch.Tensor:
    """The launch path before it was made lean, around today's kernel: the
    shapes checked twice, nine meta tensors for strides, the cost computed
    with no counter, a device context and a stream object a call."""
    from repro_torch.kernels import flash_attention as fa

    def strides(t, dims):
        dense = torch.empty(t.shape, device="meta").stride()
        return [t.stride(d) if t.shape[d] != 1 else dense[d] for d in dims]

    fa._check_bshd_shapes(q, k, v, q_pos, k_pos)
    fa._check_bshd_shapes(q, k, v, q_pos, k_pos)
    for t in (q, k, v):
        if t.data_ptr() % 16 or any(st % 8 for st in strides(t, (0, 1, 2))):
            raise ValueError("q, k and v must be 16-byte aligned")
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty(b, sq, h, hd, dtype=q.dtype, device=q.device)
    c_strides = (ctypes.c_longlong * 16)(
        *strides(q, (0, 1, 2)), *strides(k, (0, 1, 2)), *strides(v, (0, 1, 2)),
        *strides(out, (0, 1, 2)), *strides(q_pos, (0, 1)), *strides(k_pos, (0, 1)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fa._kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                           k_pos.data_ptr(), out.data_ptr(), c_strides, b, sq, sk, h, kh, hd, 1,
                           int(causal), 1.0 / (hd ** 0.5), None, q.device.index, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: {err}")
    fa.flash_launch_cost(b, h, kh, sq, sk, hd, q.element_size(), causal)
    return out


def flash_exact_levers(fns: dict) -> dict:
    """Each variant of the exact-width plan at zamba2's and hubert's
    attention, per call and alone on the device, in turns, beside SDPA."""
    from repro_torch.kernels import flash_attention as fa

    kernel = fa._kernel
    readings = {}
    for cell, (b, s, h, kh, hd, causal) in EXACT_CELLS.items():
        gen = torch.Generator(device="cuda").manual_seed(hd)
        q = torch.randn(b, s, h, hd, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, s, kh, hd, generator=gen, device="cuda").bfloat16() for _ in range(2))
        pos = torch.arange(s, dtype=torch.int32, device="cuda")[None].expand(b, s)
        ops = (q, k, v, pos, pos)
        names = [*fns, "old_launch_path"]
        times = {name: [] for name in names}
        want = None
        for name in [*names, *reversed(names)]:
            fa._kernel = lambda fn=fns.get(name, fns["final"]): fn
            if name == "old_launch_path":
                call = lambda: old_launch_path(*ops, causal)  # noqa: E731
            else:
                call = lambda: fa.flash_attention_bshd_cuda(*ops, causal=causal)  # noqa: E731
            got = call()
            want = got if want is None else want
            err = float((got.float() - want.float()).abs().max())
            if err > 2e-2:
                raise RuntimeError(f"lever {name} at {cell}: output off by {err}")
            times[name].append((time_ms(call, 20), graph_ms(lambda *_: call(), [()])))
        fa._kernel = kernel
        q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, is_causal=causal, enable_gqa=True)
        sdpa_ms = (time_ms(sdpa, 20), graph_ms(lambda *_: sdpa(), [()]))
        readings[cell] = {**times, "scaled_dot_product_attention": sdpa_ms}
        for name, ts in times.items():
            log(f"[levers] flash {cell} {name}: per call {', '.join(f'{p:.6f}' for p, _ in ts)} "
                f"ms; device alone {', '.join(f'{d:.6f}' for _, d in ts)} ms")
        log(f"[levers] flash {cell} scaled_dot_product_attention (enable_gqa): per call "
            f"{sdpa_ms[0]:.6f} ms; device alone {sdpa_ms[1]:.6f} ms")
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


# --------------------------------------------------------------- MMA probe

PROBE_SOURCE = r"""
// Register-only throughput of the tensor-core MMAs a popcount-GEMM can use:
// each kernel issues one MMA after another on operands that never change
// (shared memory filled once with random bits, or register fragments), so
// no load from device memory bounds it.
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

// wgmma_ss_s8_n256

constexpr int kProbeSmem = 16384 + 32768;  // two 64-row A tiles, one 256-row B tile

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ unsigned char* random_tiles(unsigned char* raw) {
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t{1023});
  uint32_t* w = reinterpret_cast<uint32_t*>(smem);
  for (int i = threadIdx.x; i < kProbeSmem / 4; i += blockDim.x) {
    w[i] = mix(i * 2654435761u + blockIdx.x);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  return smem;
}

// Two warpgroups, each 8 MMAs m64n256 a commit group, one group in flight.
template <bool kB1>
__global__ void __launch_bounds__(256, 1) probe_wgmma(int iters, int* sink) {
  extern __shared__ unsigned char raw[];
  unsigned char* smem = random_tiles(raw);
  const int wg = threadIdx.x / 128;
  const uint64_t da = make_desc(smem + wg * 8192, 128, 1024);
  const uint64_t db = make_desc(smem + 16384, 128, 1024);
  int acc[128];
#pragma unroll
  for (int e = 0; e < 128; ++e) acc[e] = 0;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const uint64_t step = 2 * (u & 3);  // + 32 bytes: the next k step of the 128-byte rows
      if constexpr (kB1) {
        wgmma_ss_b1_n256(acc, da + step, db + step, 1);
      } else {
        wgmma_ss_s8_n256(acc, da + step, db + step, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  int s = 0;
#pragma unroll
  for (int e = 0; e < 128; ++e) {
    fence_reg(acc[e]);
    s += acc[e];
  }
  if (s == 0x7fffffff) sink[0] = s;
}

// Every warp: 8 independent m16n8 accumulators, fragments in registers.
template <bool kB1>
__global__ void __launch_bounds__(256) probe_mma(int iters, int* sink) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = mix(threadIdx.x * 8 + i + blockIdx.x * 4096);
#pragma unroll
  for (int i = 0; i < 2; ++i) b[i] = mix(threadIdx.x * 8 + 4 + i + blockIdx.x * 4096);
  int acc[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if constexpr (kB1) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(acc[u][0]), "+r"(acc[u][1]), "+r"(acc[u][2]), "+r"(acc[u][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(acc[u][0]), "+r"(acc[u][1]), "+r"(acc[u][2]), "+r"(acc[u][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += acc[u][e];
  if (s == 0x7fffffff) sink[0] = s;
}

}  // namespace

// which: 0 wgmma b1, 1 wgmma s8, 2 mma.sync b1, 3 mma.sync s8.
extern "C" int probe_run(int which, int blocks, int iters, void* sink, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* out = static_cast<int*>(sink);
  const int smem = kProbeSmem + 1024;
  if (which == 0) {
    cudaFuncSetAttribute(probe_wgmma<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    probe_wgmma<true><<<blocks, 256, smem, st>>>(iters, out);
  } else if (which == 1) {
    cudaFuncSetAttribute(probe_wgmma<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    probe_wgmma<false><<<blocks, 256, smem, st>>>(iters, out);
  } else if (which == 2) {
    probe_mma<true><<<blocks, 256, 0, st>>>(iters, out);
  } else {
    probe_mma<false><<<blocks, 256, 0, st>>>(iters, out);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# name, which, blocks a SM, bit products an MMA, MMAs a block and iteration
PROBES = (
    ("wgmma m64n256k256 b1 and.popc", 0, 1, 64 * 256 * 256, 2 * 8),
    ("wgmma m64n256k32 s8", 1, 1, 64 * 256 * 32, 2 * 8),
    ("mma.sync m16n8k256 b1 and.popc", 2, 4, 16 * 8 * 256, 8 * 8),
    ("mma.sync m16n8k32 s8", 3, 4, 16 * 8 * 32, 8 * 8),
)


def s8_wrapper() -> str:
    """``wgmma_ss_s8_n256``, written from hopper.cuh's b1 wrapper: the same
    registers, the s8 instruction of the same N (k32, the same 32 bytes)."""
    text = (CSRC / "hopper.cuh").read_text()
    start = text.index("__device__ __forceinline__ void wgmma_ss_b1_n256")
    body = text[start:text.index("\n}\n", start) + 3]
    old = "m64n256k256.s32.b1.b1.and.popc"
    if body.count(old) != 1:
        raise RuntimeError("hopper.cuh's b1 wrapper no longer holds its instruction once")
    return body.replace("wgmma_ss_b1_n256", "wgmma_ss_s8_n256").replace(old, "m64n256k32.s32.s8.s8")


def compile_one(name: str, source: str):
    """Write ``source`` as build/levers/<name>.cu and start nvcc on it."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}.cu"
    src.write_text(source)
    lib = OUT / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC}", "-o", str(lib), str(src)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(name: str, lib: Path, proc) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{text}")
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[levers] {name} ptxas: {line.strip()}")
    log(f"[levers] {name} SASS MMA opcodes: {_build.sass_mma_opcodes(lib)}")
    return ctypes.CDLL(str(lib))


def mma_probe() -> dict:
    """Bit products a second of each MMA, register-only, on every SM."""
    source = PROBE_SOURCE.replace("// wgmma_ss_s8_n256\n", s8_wrapper())
    fn = finish("probe", *compile_one("probe", source)).probe_run
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, ci, ci, vp, vp]
    fn.restype = ci
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    readings = {}
    for name, which, per_sm, products, mmas in PROBES:
        blocks = per_sm * sms

        def run(iters):
            err = fn(which, blocks, iters, sink.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"probe {name}: CUDA error {err}")

        ms = time_ms(lambda: run(256), 3)
        iters = max(256, int(256 * 50 / max(ms, 1e-3)))  # about 50 ms a launch
        ms = time_ms(lambda: run(iters), 3)
        rate = blocks * iters * mmas * products / (ms * 1e-3)
        readings[name] = {"bit_products_per_s": rate, "ms": ms, "iters": iters, "blocks": blocks}
        log(f"[levers] probe {name}: {rate:.4e} products/s ({2 * rate:.4e} ops/s), "
            f"{ms:.6f} ms for {iters} iterations on {blocks} blocks")
    return readings


# --------------------------------------------------------- bitgemm levers

BITGEMM_STAGE_START = "__device__ __forceinline__ void stage_products("
BITGEMM_STAGE_END = "  wgmma_commit();\n}\n"

# (b) mma.sync m16n8k256 b1 on register fragments loaded with ldmatrix from
# the same swizzled stages: each warp owns 16 X rows by the 256 Y rows, the
# m16n8 accumulators in the same registers as the wgmma layout.
MMA_SYNC_STAGE = r"""__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const unsigned char* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_b1(int* d, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void stage_products(int (&acc)[kRowsY / 2], const unsigned char* tx,
                                               const unsigned char* ty, bool accumulate) {
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x / 32) & 3;
  const int m = lane >> 3;  // the 8 x 16-byte matrix whose row address this thread gives
  const int r = lane & 7;
  if (!accumulate) {
#pragma unroll
    for (int e = 0; e < kRowsY / 2; ++e) acc[e] = 0;
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    {
      const int row = warp * 16 + (m & 1) * 8 + r;
      const int chunk = 2 * kk + (m >> 1);
      ldsm_x4(a, tx + row * 128 + ((chunk ^ (row & 7)) << 4));
    }
#pragma unroll
    for (int nb = 0; nb < kRowsY / 16; ++nb) {
      const int row = nb * 16 + (m >> 1) * 8 + r;
      const int chunk = 2 * kk + (m & 1);
      uint32_t b[4];
      ldsm_x4(b, ty + row * 128 + ((chunk ^ (row & 7)) << 4));
      mma_b1(acc + 8 * nb, a, b[0], b[1]);
      mma_b1(acc + 8 * nb + 4, a, b[2], b[3]);
    }
  }
}
"""

# (c) s8 wgmma on the bits expanded to {0,1} bytes: each consumer warpgroup
# expands one word of its 64 X rows and of the 256 Y rows at a time (32
# bytes a row, 32-byte swizzle) into its own two buffers, and runs
# m64n256k32 on them while it expands the next word. The ring drops to 3
# stages to make room.
S8_EXPANDED_STAGE = r"""__device__ __forceinline__ void stage_products(int (&acc)[kRowsY / 2], const unsigned char* tx,
                                               const unsigned char* ty, bool accumulate) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x & 127;
  unsigned char* bufs = base + kSmemExp + wg * 2 * kExpBytes;
#pragma unroll 1
  for (int kw = 0; kw < kStageWords; ++kw) {
    unsigned char* buf = bufs + (kw & 1) * kExpBytes;
    bar_or(1 + wg, 128, false);  // the MMA that last read buf is done in every warp
    for (int e = tid; e < (64 + kRowsY) * 8; e += 128) {
      const int row = e >> 3;
      const int q = e & 7;
      const bool is_x = row < 64;
      const int r = is_x ? row : row - 64;
      const unsigned char* src = is_x ? tx : ty;
      const int chunk = kw >> 2;
      const uint32_t word = *reinterpret_cast<const uint32_t*>(
          src + r * 128 + ((chunk ^ (r & 7)) << 4) + (kw & 3) * 4);
      const uint32_t bytes = (((word >> (4 * q)) & 0xFu) * 0x00204081u) & 0x01010101u;
      unsigned char* dst = buf + (is_x ? 0 : 2048) + (r >> 3) * 256 + (r & 7) * 32 +
                           (((q >> 2) ^ ((r >> 2) & 1)) << 4) + (q & 3) * 4;
      *reinterpret_cast<uint32_t*>(dst) = bytes;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_or(1 + wg, 128, false);
    wgmma_fence();
    wgmma_ss_s8_n256(acc, make_desc(buf, 32, 256), make_desc(buf + 2048, 32, 256),
                     accumulate || kw > 0);
    wgmma_commit();
    wgmma_wait<1>();
  }
}
"""

BITGEMM_LEVERS = {
    "final (a) wgmma b1": [],
    "(b) mma.sync b1": [("STAGE", MMA_SYNC_STAGE)],
    "(c) s8 wgmma, bits expanded": [
        ("constexpr int kStages = 4;", "constexpr int kStages = 3;"),
        ("constexpr int kSmemBytes = kSmemBars + 2 * kStages * 8 + 1024;",
         "constexpr int kSmemExp = (kSmemBars + 2 * kStages * 8 + 1023) / 1024 * 1024;\n"
         "constexpr int kExpBytes = 64 * 32 + kRowsY * 32;\n"
         "constexpr int kSmemBytes = kSmemExp + 4 * kExpBytes + 1024;"),
        ("STAGE", "S8_WRAPPER" + S8_EXPANDED_STAGE),
    ],
    "no grouping": [(
        "  const long long per_group = static_cast<long long>(kGroupUnits) * tiles_j;\n",
        "  return {static_cast<int>(t / tiles_j), static_cast<int>(t % tiles_j)};\n"
        "  const long long per_group = static_cast<long long>(kGroupUnits) * tiles_j;\n")],
    "no multicast (clusters of 1)": [("constexpr int kCluster = 2;", "constexpr int kCluster = 1;")],
    "clusters of 4": [("constexpr int kCluster = 2;", "constexpr int kCluster = 4;")],
    "4-byte epilogue stores": [(
        "        if (vec && col + 3 < rows_j) {\n"
        "          *reinterpret_cast<int4*>(dst + col) = v;\n"
        "        } else {\n",
        "        {\n")],
}


def bitgemm_variant(subs: list) -> str:
    text = (CSRC / "tc_bitgemm.cu").read_text()
    for old, new in subs:
        if old == "STAGE":
            start = text.index(BITGEMM_STAGE_START)
            end = text.index(BITGEMM_STAGE_END, start) + len(BITGEMM_STAGE_END)
            text = text[:start] + new.replace("S8_WRAPPER", s8_wrapper() + "\n") + text[end:]
            continue
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def bitgemm_levers() -> dict:
    """Each variant at the email-enron chunk (I 2,048, J 36,692, W 1,147),
    in turns, held to the final kernel's output exactly."""
    from repro_torch.configs import GRAPHS
    from repro_torch.core.tcim import _bitgemm_operands
    from repro_torch.graphs import GRAPH_GENERATORS, build_graph
    from repro_torch.kernels import tc_bitgemm as tb

    started = {}
    for k, (name, subs) in enumerate(BITGEMM_LEVERS.items()):
        started[name] = compile_one(f"bitgemm_{k}", bitgemm_variant(subs))
    fns = {}
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, (lib, proc) in started.items():
        fn = finish(name, lib, proc).tc_bitgemm
        fn.argtypes = [vp, ll, vp, ll, ci, ci, ci, vp, vp]
        fn.restype = ci
        fns[name] = fn
    cfg = GRAPHS["email-enron"]
    g = build_graph(GRAPH_GENERATORS[cfg.generator](cfg.n, cfg.m, seed=cfg.seed), reorder=True)
    x, y = _bitgemm_operands(g, torch.device("cuda"))
    x = x[:2048]
    out = torch.empty(x.shape[0], y.shape[0], dtype=torch.int32, device="cuda")
    kernel = tb._kernel
    times = {name: [] for name in fns}
    want = None
    for name in [*fns, *reversed(list(fns))]:
        tb._kernel = lambda fn=fns[name]: fn
        out.fill_(-1)
        tb.bitgemm_cuda(x, y, out)
        want = out.clone() if want is None else want
        if not torch.equal(out, want):
            raise RuntimeError(f"bitgemm lever {name}: output != the final kernel's")
        times[name].append(time_ms(lambda: tb.bitgemm_cuda(x, y, out), 10))
    tb._kernel = kernel
    for name, ts in times.items():
        log(f"[levers] bitgemm email-enron chunk {name}: {', '.join(f'{t:.6f}' for t in ts)} ms")
    return times


ONE_PAIR_GATHER_TOTAL = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <int W> struct Row;
template <> struct Row<1> { using T = uint32_t; };
template <> struct Row<2> { using T = uint2; };
template <> struct Row<4> { using T = uint4; };

__device__ __forceinline__ int and_popc(uint32_t a, uint32_t b) { return __popc(a & b); }
__device__ __forceinline__ int and_popc(uint2 a, uint2 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y);
}
__device__ __forceinline__ int and_popc(uint4 a, uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) + __popc(a.w & b.w);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
gather_total_kernel(const typename Row<W>::T* __restrict__ row, int num_rows,
                    const typename Row<W>::T* __restrict__ col, int num_cols,
                    const int32_t* __restrict__ ridx, const int32_t* __restrict__ cidx,
                    long long num_pairs, int32_t* __restrict__ out) {
  int total = 0;
  int bad = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < num_pairs;
       p += stride) {
    const int r = __ldg(ridx + p);
    const int c = __ldg(cidx + p);
    const bool out_of_range = (r >= num_rows) | (c >= num_cols);
    bad += out_of_range;
    if (r >= 0 && c >= 0 && !out_of_range) total += and_popc(__ldg(row + r), __ldg(col + c));
  }
  total = warp_sum(total);
  bad = warp_sum(bad);
  __shared__ int s_total[kThreads / 32];
  __shared__ int s_bad[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_total[warp] = total;
    s_bad[warp] = bad;
  }
  __syncthreads();
  if (warp == 0) {
    total = lane < kThreads / 32 ? s_total[lane] : 0;
    bad = lane < kThreads / 32 ? s_bad[lane] : 0;
    total = warp_sum(total);
    bad = warp_sum(bad);
    if (lane == 0) {
      if (total) atomicAdd(out, total);
      if (bad) atomicAdd(out + 1, bad);
    }
  }
}

template <int W>
void launch(const void* row, int num_rows, const void* col, int num_cols, const int32_t* ridx,
            const int32_t* cidx, long long num_pairs, int32_t* out, int blocks,
            cudaStream_t stream) {
  using T = typename Row<W>::T;
  gather_total_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(row), num_rows, static_cast<const T*>(col), num_cols, ridx, cidx,
      num_pairs, out);
}

}  // namespace

// The same arguments as the final kernel's entry; `device` is not read.
extern "C" int tc_gather_total(const void* row, int num_rows, const void* col, int num_cols,
                               int words, const void* ridx, const void* cidx,
                               long long num_pairs, void* out, int device, void* stream) {
  if (num_pairs <= 0) return 0;
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed = (num_pairs + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(needed < cap ? needed : cap);
  const auto* ri = static_cast<const int32_t*>(ridx);
  const auto* ci = static_cast<const int32_t*>(cidx);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: launch<1>(row, num_rows, col, num_cols, ri, ci, num_pairs, o, blocks, s); break;
    case 2: launch<2>(row, num_rows, col, num_cols, ri, ci, num_pairs, o, blocks, s); break;
    case 4: launch<4>(row, num_rows, col, num_cols, ri, ci, num_pairs, o, blocks, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

GATHER_LOAD_ROUND = """#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long q = base + tid + k * threads;
    r[k] = q < num_pairs ? load_index(ridx + q) : -1;
    c[k] = q < num_pairs ? load_index(cidx + q) : -1;
  }"""
GATHER_INT4_ROUND = """  const long long q0 = base + 4 * tid;
  if (q0 + 3 < num_pairs && ((reinterpret_cast<uintptr_t>(ridx + q0) |
                              reinterpret_cast<uintptr_t>(cidx + q0)) & 15) == 0) {
    const int4 a = load_index(reinterpret_cast<const int4*>(ridx + q0));
    const int4 b = load_index(reinterpret_cast<const int4*>(cidx + q0));
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    c[0] = b.x; c[1] = b.y; c[2] = b.z; c[3] = b.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long q = q0 + k;
    r[k] = q < num_pairs ? load_index(ridx + q) : -1;
    c[k] = q < num_pairs ? load_index(cidx + q) : -1;
  }"""
GATHER_LEVERS = {
    "no_evict_first": [("constexpr bool kStreamingIndices = true;",
                        "constexpr bool kStreamingIndices = false;")],
    "not_pipelined": [("constexpr bool kPipelined = true;", "constexpr bool kPipelined = false;")],
    "int4_consecutive": [(GATHER_LOAD_ROUND, GATHER_INT4_ROUND)],
}
GRAPH_LAUNCHES = 50


def graph_ms(fn, calls: list, launches: int = GRAPH_LAUNCHES, replays: int = 10) -> float:
    """Device ms a launch of ``fn(*args)``, cycling ``calls``, from a
    replayed CUDA graph of ``launches`` launches."""
    fn(*calls[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(launches):
            fn(*calls[k % len(calls)])
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * launches)


def gather_total_levers() -> dict:
    """Each variant of gather_total at com-youtube's chunks, device time
    alone, in turns, held to the final kernel's sums exactly."""
    from repro_torch.configs import GRAPHS
    from repro_torch.core import Executor, build_sbf, build_worklist
    from repro_torch.graphs import GRAPH_GENERATORS, build_graph
    from repro_torch.kernels import tc_gather_popcount as tgp

    source = (CSRC / "tc_gather_popcount.cu").read_text()
    started = {}
    for k, (name, subs) in enumerate(GATHER_LEVERS.items()):
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"gather lever {name}: the source no longer holds {old!r} once")
            text = text.replace(old, new)
        started[name] = compile_one(f"gather_{k}", text)
    started["one_pair_a_thread"] = compile_one("gather_one_pair", ONE_PAIR_GATHER_TOTAL)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {"final": tgp._kernel()}
    for name, (lib, proc) in started.items():
        fn = finish(name, lib, proc).tc_gather_total
        fn.argtypes = [vp, i32, vp, i32, i32, vp, vp, i64, vp, i32, vp]
        fn.restype = i32
        fns[name] = fn
    cfg = GRAPHS["com-youtube"]
    g = build_graph(GRAPH_GENERATORS[cfg.generator](cfg.n, cfg.m, seed=cfg.seed), reorder=True)
    sb = build_sbf(g, 64)
    wl = build_worklist(g, sb)
    ex = Executor(sb)
    chunks = [(torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda())
              for r, c in ex._chunks(wl.pair_row_pos, wl.pair_col_pos)]
    out = torch.zeros(2, dtype=torch.int32, device="cuda")
    calls = [(ex.row_data, ex.col_data, r, c, out) for r, c in chunks]
    kernel = tgp._kernel
    times = {name: [] for name in fns}
    want = None
    for name in [*fns, *reversed(list(fns))]:
        tgp._kernel = lambda fn=fns[name], name="tc_gather_total": fn
        sums = []
        for args in calls:
            out.zero_()
            tgp.gather_total_cuda(*args)
            sums.append(out.tolist())
        want = sums if want is None else want
        if sums != want:
            raise RuntimeError(f"gather_total lever {name}: sums != the final kernel's")
        times[name].append(graph_ms(tgp.gather_total_cuda, calls))
    tgp._kernel = kernel
    for name, ts in times.items():
        log(f"[levers] gather_total com-youtube chunks ({len(chunks)}, P {len(chunks[0][0])}, W "
            f"{ex.row_data.shape[1]}) {name}: device {', '.join(f'{t:.6f}' for t in ts)} ms a chunk")
    return times


def segment_levers() -> dict:
    """The fleet's wave in one grouped launch against one launch a batch,
    per call and device alone, in turns, each held to the plain version."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.core import build_sbf, build_worklist
    from repro_torch.graphs import build_graph, rmat
    from repro_torch.kernels import tc_gather_popcount as tgp
    from repro_torch.launch import ServeConfig, TCServer

    specs = [(i, 64) for i in range(smoke.NUM_TENANTS)]
    specs += [(smoke.NUM_TENANTS + i, 32) for i in range(smoke.NUM_TENANTS_SIDE)]
    specs += [(smoke.NUM_TENANTS + smoke.NUM_TENANTS_SIDE + i, 128)
              for i in range(smoke.NUM_TENANTS_SIDE)]
    jobs = []
    for seed, bits in specs:
        n = smoke.MIX_N[seed % len(smoke.MIX_N)]
        gr = build_graph(rmat(n, smoke.EDGE_FACTOR * n, seed=seed))
        sb = build_sbf(gr, bits)
        jobs.append((sb, build_worklist(gr, sb)))
    srv = TCServer(ServeConfig(fused_max_batches=64))
    srv.serve(jobs)
    batches = list(srv.multi._batches.values())
    table = srv.multi._table(batches)
    segs = [b.segments for b in batches]
    want = tgp.gather_segment_groups_reference(segs)
    wave_out = torch.zeros(table.rows, 2, dtype=torch.int32, device="cuda")
    outs = [torch.zeros(b.plan.padded_graphs, 2, dtype=torch.int32, device="cuda") for b in batches]

    def grouped():
        for k in range(len(table.groups)):
            tgp.gather_segment_groups_cuda(table, wave_out, k)

    def one_by_one():
        for seg, o in zip(segs, outs):
            tgp.gather_segment_totals_cuda(*seg[:4], o, bucket=seg[4])

    readings = {"grouped": [], "no_grouping": []}
    for name in ("grouped", "no_grouping", "no_grouping", "grouped"):
        fn = grouped if name == "grouped" else one_by_one
        wave_out.zero_()
        for o in outs:
            o.zero_()
        fn()
        got = wave_out if name == "grouped" else torch.cat(outs)
        if not torch.equal(got.cpu(), want.cpu()):
            raise RuntimeError(f"segment lever {name}: output != the plain version")
        per_call = time_ms(fn, 20)
        device = graph_ms(fn, [()], launches=10)
        readings[name].append((per_call, device))
    for name, rs in readings.items():
        log(f"[levers] segments, the fleet's wave of {len(batches)} batches, {name}: per call "
            f"{', '.join(f'{p:.6f}' for p, _ in rs)} ms; device alone "
            f"{', '.join(f'{d:.6f}' for _, d in rs)} ms a wave")
    return readings


SECTIONS = ("probe", "bitgemm", "flash", "flash_exact", "dense", "gather")


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_levers: torch.cuda.is_available() is False; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sections = sys.argv[1:] or list(SECTIONS)
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        print(f"kernel_levers: unknown sections {sorted(unknown)}; choose from {SECTIONS}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    readings = {}
    if "probe" in sections:
        readings["mma_probe"] = mma_probe()
    if "bitgemm" in sections:
        readings["bitgemm"] = bitgemm_levers()
    if "flash" in sections:
        readings["flash_attention"] = flash_levers(build_variants(LEVERS))
    if "flash_exact" in sections:
        readings["flash_attention_exact"] = flash_exact_levers(
            build_variants(EXACT_LEVERS, "flash_exact"))
    if "dense" in sections:
        readings["dense_mxu_tc"] = dense_levers()
    if "gather" in sections:
        readings["gather_total"] = gather_total_levers()
        readings["gather_segment_totals"] = segment_levers()
    print(smi.splitlines()[0])
    print(json.dumps({"device": torch.cuda.get_device_name(0), "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
