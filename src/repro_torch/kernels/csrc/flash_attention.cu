// Forward flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_kernel`) of
// src/repro/kernels/flash_attention.py. For every (batch b, head h, query
// row i), with KV head kh = h / (H / KH):
//
//   s_j  = (q[b,i,h] . k[b,j,kh]) * scale           f32, scale = 1/sqrt(hd)
//   s_j  = -1e30  where causal and q_pos[b,i] < k_pos[b,j]
//   o[b,i,h] = sum_j p_j v[b,j,kh] / max(sum_j p_j, 1e-30),  p_j = exp(s_j - max s)
//
// with the running max, sum and accumulator in f32 and p cast to v's type
// before the PV product, exactly as the TPU kernel's online softmax does.
// Positions are arbitrary int32 values per (batch, row), so one kernel
// serves training, chunked prefill and offset (Sq < Sk) queries.
//
// Layout. q and o are [B, Sq, H, hd], k and v [B, Sk, KH, hd] (GQA: no
// repeated KV heads), positions [B, Sq] and [B, Sk]; strides are passed in
// and only hd must be contiguous, so the model's projections go in as they
// are. The reference's [BH, S, hd] entry is B = BH, H = KH = 1.
//
// Design. The grid is (q tiles, H, B), the last q tiles (the heaviest under
// a causal mask) first (hd 80 and 112: a persistent grid, below). A block owns 128 query rows of one head and walks
// 128-key KV tiles itself; nothing carries between blocks.
//
//   Tile skipping. A KV tile is skipped when min(k_pos over the tile) >
//   max(q_pos over the q tile): every pair in it is masked, and for a row
//   with a visible key a masked tile adds exactly nothing (its weights
//   exp(-1e30 - m) are 0 in f32 and alpha is 1). A row with no visible key
//   at all averages V over every key in the reference (all scores -1e30),
//   so a block in which such a row ends its walk with m == -1e30 walks every
//   tile again from a clean state (the rescan). At S 4,096 causal about half
//   of the tiles are scored. An optional counter adds up the tiles a block
//   scored (rescans included), one atomic a block.
//
//   bf16 at hd 16, 32, 64 and 128, warp-specialised (384 threads).
//   Warpgroup 0 is the producer: one warp reads the positions, decides the
//   skips and keeps TMA loads of K and V tiles (and their k_pos, written
//   by the warp) in flight in a ring of 3 stages with full/empty mbarriers;
//   it hands its registers to the consumers with setmaxnreg. Warpgroups 1
//   and 2 each own 64 query rows: S = Q K^T by `wgmma.m64n128k16` with Q
//   and K in shared memory, the online softmax in registers with exp2 and
//   scale * log2(e) folded in, P rounded to bf16 in registers (the
//   reference's p.astype(v.dtype)) and used as the register A operand of O += P V by `wgmma.m64nNk16`, V read
//   N-major (transposed) from shared memory. The accumulator layout of S
//   is the A-fragment layout of P: n8 columns 2j and 2j+1 form k16 step j.
//   The loop is software-pipelined: S of the next tile and P V of the
//   current one are in flight together, and the next tile's softmax runs
//   while P V finishes, so the exponentials overlap the tensor cores.
//   Tiles are stored as TMA writes them: rows of hd * 2 bytes with the 32B
//   (hd 16), 64B (hd 32) or 128B (hd 64, and two 64-column panels at hd
//   128) swizzle, and the wgmma descriptors name the same swizzle. TMA
//   zero-fills rows past Sq and Sk; keys past Sk still get s = -inf (p = 0)
//   and rows past Sq are never stored. The mask is applied by selects, with
//   no branch between an MMA in flight and its wait (ptxas serialises the
//   MMAs across such a branch). The producer warpgroup keeps 40 registers
//   a thread, the consumers 232.
//
//   bf16 at hd 80 and 112 (zamba2-7b's and hubert-xlarge's heads; B 4 x
//   512 in the model, walks of 1-4 KV tiles): the same walk, skip rule,
//   softmax and pipelining on a plan of their own (ExactPlan), where hd
//   128's plan would pad a second 64-column panel and multiply its zero
//   columns in P V:
//   - exact-width panels: 64 + 16 columns at hd 80, 64 + 32 + 16 at 112,
//     each with its own tensor map, box width and 128B, 64B or 32B
//     swizzle; Q K^T walks the hd / 16 k steps across the panels, P V
//     issues one wgmma a panel at its N (m64n64 + m64n16, m64n64 + m64n32
//     + m64n16), and the accumulator holds hd / 2 floats a thread. A Q tile
//     is 2 * 128 * hd bytes (20 or 28 KB, not 32);
//   - KV in stages of 64 keys, half a tile (S by m64n64k16: 32 floats a
//     thread, P 16 registers), so S, P and the accumulator fit the 168
//     registers a thread of one producer warp beside two consumer
//     warpgroups (288 threads: three warps on each of the SM's four
//     16K-register files) without a spill; at 128 keys hd 112 spills even
//     with setmaxnreg giving the consumers 232. The skip rule, the rescan
//     and the tiles counter stay those of 128-key tiles;
//   - a persistent grid, one block an SM over (q tile, head, batch) items
//     heaviest first, so one item's prologue and epilogue overlap the
//     next one's loads: the producer reads the next item's positions and
//     loads its Q (two Q buffers) and KV halves into a ring of 4 stages
//     (the deepest that fits, 6 at hd 112 and 8 at 80, was no faster)
//     while the consumers finish the item. It decides the rescan itself,
//     without waiting for the consumers: a q tile holding a row whose
//     q_pos is below every k_pos walks again (flash_tiles_scored's rule).
//     The test on m == -1e30 above also rescans a row whose every visible
//     score is at or below -1e30 after scaling, which no finite bf16 input
//     of a model reaches;
//   - the two consumer warpgroups take turns to issue their MMAs (through
//     two mbarriers), so one's softmax runs under the other's MMAs;
//   - the epilogue stages O, rounded to bf16, in the warpgroup's rows of
//     the item's Q buffer in the panels' swizzled layout and writes it with
//     one TMA store a panel (rows past Sq are not written); the buffer goes
//     back to the producer a stage into the next item's walk, once the
//     store has read it. O is acc times the correctly rounded 1 / max(l,
//     1e-30), within about an f32 unit in the last place of the quotient
//     before the bf16 rounding: hd / 2 IEEE divisions a thread cost more
//     than the rest of an item's epilogue.
//   f32: scalar FMA (TF32 could not hold the 2e-5 tolerance), 64-row q
//   tiles and 64-key KV tiles staged with plain loads, 4 threads a row, the
//   same skip rule and rescan.
//
// Bound. Operations: 4 hd flops a visible (query, key) pair (QK^T and PV,
// at the true hd), against 989 TFLOP/s dense bf16 on the H100; bytes: Q, K,
// V and the positions read once and O written once, against 3.35 TB/s. At
// the LM serving prefill (8 x 9 heads, S = 4096, hd 64, causal) the
// operations bind: about 0.16 ms against 0.04 ms for the bytes. The
// diagonal tiles are scored whole, so the kernel does about 3 % more work
// than the bound counts at that shape. At the hd 80 and 112 paths (B 4 x
// 512) the bytes bind (0.0063 and 0.0175 ms): there a block's walk is short
// and its latency, not the tensor cores, sets the time, which the exact
// plan's persistent grid hides behind the next item's loads.

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;  // only the f32 kernel reads q, k, v through pointers
  const void* k;
  const void* v;
  const int* qpos;
  const int* kpos;
  void* o;
  long long q_sb, q_ss, q_sh;  // element strides (batch, row, head)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long qp_sb, qp_ss, kp_sb, kp_ss;
  int sq, sk, heads, kv_heads, causal;
  float scale;
  unsigned long long* tiles;  // optional: tiles scored, summed over blocks
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = max(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------ bf16

constexpr int kTile = 128;          // query rows a block, keys a KV tile
constexpr int kThreads = 384;       // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kEmptyArrivals = 8;   // one a consumer warp

template <int HD>
struct Plan {
  static_assert(HD % 16 == 0, "the bf16 wgmma's k step is 16");
  static constexpr int kPanelCols = HD < 64 ? HD : 64;   // columns a swizzled panel
  // Rounded up: hd 80 and 112 take ExactPlan; with exact_plan() false they
  // run here, their second panel zero past column hd.
  static constexpr int kPanels = (HD + kPanelCols - 1) / kPanelCols;
  static constexpr int kSwizzle = 2 * kPanelCols;       // bytes a panel row
  static constexpr int kPanelBytes = kTile * kSwizzle;
  static constexpr int kTileBytes = kPanels * kPanelBytes;  // Q, one K or one V tile (TMA's box)
  static constexpr int kStages = 3;  // the consumers hold two: the third loads meanwhile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kKpos = kV + kStages * kTileBytes;   // int [stage][128]
  static constexpr int kMeta = kKpos + kStages * kTile * 4;  // int2 [stage]: n0 (-1: end), unmasked
  static constexpr int kBars = kMeta + kStages * 8;          // full[], empty[], q, decide
  static constexpr int kFlag = kBars + (2 * kStages + 2) * 8;
  static constexpr int kBytes = kFlag + 16 + 1024;           // + slack to align to 1024
  static_assert(kBytes <= 232448, "over the H100's shared memory a block");
};

// S[64 x 128] = Q K^T for one consumer warpgroup: Q's 64 rows at `q_wg`, a
// K tile at `k_tile`, both K-major in swizzled panels; only the hd / 16 k
// steps over real columns. Element 4j + e of s sits at row r_lo (+8 for
// e >= 2), key column 8j + 2 tig + (e & 1).
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[kTile / 2], const unsigned char* q_wg,
                                         const unsigned char* k_tile) {
  using P = Plan<HD>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int panel = kk * 16 / P::kPanelCols;
    const int col_bytes = (kk * 16 % P::kPanelCols) * 2;
    const uint64_t da =
        make_desc(q_wg + panel * P::kPanelBytes + col_bytes, P::kSwizzle, 8 * P::kSwizzle);
    const uint64_t db =
        make_desc(k_tile + panel * P::kPanelBytes + col_bytes, P::kSwizzle, 8 * P::kSwizzle);
    wgmma_ss_bf16_n128(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// acc += P V: P in registers (the A fragments of the 8 k16 steps), a V
// tile at `v_tile` read N-major (transposed) from its swizzled panels, every
// panel whole (a padded panel's zero columns give zero outputs).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[Plan<HD>::kPanels][Plan<HD>::kPanelCols / 2],
                                         const uint32_t (&pa)[kTile / 16][4],
                                         const unsigned char* v_tile) {
  using P = Plan<HD>;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) {
#pragma unroll
    for (int p = 0; p < P::kPanels; ++p) {
      const uint64_t db = make_desc(v_tile + p * P::kPanelBytes + j * 16 * P::kSwizzle,
                                    P::kSwizzle, 8 * P::kSwizzle);
      if constexpr (P::kPanelCols == 64) {
        wgmma_rs_bf16_n64(acc[p], pa[j], db, 1);
      } else if constexpr (P::kPanelCols == 32) {
        wgmma_rs_bf16_n32(acc[p], pa[j], db, 1);
      } else {
        wgmma_rs_bf16_n16(acc[p], pa[j], db, 1);
      }
    }
  }
  wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf gives 0, denormals 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile of scores, in place: scale to log2 units,
// mask (kMask), update the running max and this thread's share of the row
// sums, and leave p = exp2(x - max) in s; returns the rows' rescale
// factors. The mask is applied by selects, with no branch: a divergent path
// between an MMA in flight and its wait makes ptxas serialise them. A tile
// the producer found wholly visible and inside Sk takes kMask false: the
// max is taken on the raw scores and each p is one FFMA and one ex2. A tile
// of 2N keys: N = 64 for 128 keys, 32 for the exact plan's 64.
template <bool kMask, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], int n0, const int* kp,
                                             int sk, bool causal, int qp0, int qp1, int tig,
                                             float scale, float& m0, float& m1, float& l0,
                                             float& l1, float& a0, float& a1) {
  float mx0, mx1;
  if constexpr (kMask) {
    mx0 = m0;
    mx1 = m1;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const int col = 8 * j + 2 * tig;
      const int2 kk = *reinterpret_cast<const int2*>(kp + col);
      const bool out0 = n0 + col >= sk, out1 = n0 + col + 1 >= sk;
      const float x0 = s[4 * j + 0] * scale, x1 = s[4 * j + 1] * scale;
      const float x2 = s[4 * j + 2] * scale, x3 = s[4 * j + 3] * scale;
      s[4 * j + 0] = out0 ? -INFINITY : (causal && qp0 < kk.x ? kMasked : x0);
      s[4 * j + 1] = out1 ? -INFINITY : (causal && qp0 < kk.y ? kMasked : x1);
      s[4 * j + 2] = out0 ? -INFINITY : (causal && qp1 < kk.x ? kMasked : x2);
      s[4 * j + 3] = out1 ? -INFINITY : (causal && qp1 < kk.y ? kMasked : x3);
      mx0 = fmaxf(mx0, fmaxf(s[4 * j + 0], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
  } else {
    float r0 = -INFINITY, r1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      r0 = fmaxf(r0, fmaxf(s[4 * j + 0], s[4 * j + 1]));
      r1 = fmaxf(r1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(m0, quad_max(r0) * scale);  // scale > 0: max(s) * scale == max(s * scale)
    mx1 = fmaxf(m1, quad_max(r1) * scale);
  }
  a0 = ex2(m0 - mx0);
  a1 = ex2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    if constexpr (kMask) {
      s[4 * j + 0] = ex2(s[4 * j + 0] - mx0);
      s[4 * j + 1] = ex2(s[4 * j + 1] - mx0);
      s[4 * j + 2] = ex2(s[4 * j + 2] - mx1);
      s[4 * j + 3] = ex2(s[4 * j + 3] - mx1);
    } else {
      s[4 * j + 0] = ex2(fmaf(s[4 * j + 0], scale, -mx0));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale, -mx0));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale, -mx1));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale, -mx1));
    }
    sum0 += s[4 * j + 0] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

// P rounded to bf16 as the A fragments of the k16 steps of P V (8 for a
// tile of 128 keys): step j takes the S columns of n8 tiles 2j and 2j + 1.
template <int N>
__device__ __forceinline__ void pack_p(const float (&s)[N], uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    pa[j][0] = pack_rn(s[8 * j + 0], s[8 * j + 1]);
    pa[j][1] = pack_rn(s[8 * j + 2], s[8 * j + 3]);
    pa[j][2] = pack_rn(s[8 * j + 4], s[8 * j + 5]);
    pa[j][3] = pack_rn(s[8 * j + 6], s[8 * j + 7]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const Args args) {
  using P = Plan<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* s_q = smem + P::kQ;
  unsigned char* s_k = smem + P::kK;
  unsigned char* s_v = smem + P::kV;
  int* s_kpos = reinterpret_cast<int*>(smem + P::kKpos);
  int2* s_meta = reinterpret_cast<int2*>(smem + P::kMeta);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* empty = full + P::kStages;
  uint64_t* q_bar = empty + P::kStages;
  uint64_t* decide = q_bar + 1;
  int* s_flag = reinterpret_cast<int*>(smem + P::kFlag);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (args.heads / args.kv_heads);
  const int sq = args.sq;
  const int sk = args.sk;
  const bool causal = args.causal != 0;
  const int* qpos = args.qpos + b * args.qp_sb;
  const int* kpos = args.kpos + b * args.kp_sb;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    mbar_init(q_bar, 1);
    mbar_init(decide, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    int qmax = INT_MIN, qmin = INT_MAX;
    for (int r = lane; r < kTile; r += 32) {
      if (q0 + r < sq) {
        const int p = qpos[(q0 + r) * args.qp_ss];
        qmax = max(qmax, p);
        qmin = min(qmin, p);
      }
    }
    qmax = warp_max(qmax);
    qmin = warp_min(qmin);
    if (lane == 0) {
      prefetch_tensor_map(&qmap);
      prefetch_tensor_map(&kmap);
      prefetch_tensor_map(&vmap);
      mbar_arrive_expect_tx(q_bar, P::kTileBytes);
#pragma unroll
      for (int p = 0; p < P::kPanels; ++p) {
        tma_load_4d(s_q + p * P::kPanelBytes, &qmap, q_bar, p * P::kPanelCols, h, q0, b);
      }
    }
    const int ntiles = (sk + kTile - 1) / kTile;
    int stage = 0;
    uint32_t phase = 0;
    unsigned long long scored = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int t = 0; t < ntiles; ++t) {
        const int n0 = t * kTile;
        int kp[kTile / 32];
        int kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
        for (int e = 0; e < kTile / 32; ++e) {
          const int key = n0 + lane + 32 * e;
          kp[e] = 0;
          if (key < sk) {
            kp[e] = kpos[key * args.kp_ss];
            kmin = min(kmin, kp[e]);
            kmax = max(kmax, kp[e]);
          }
        }
        kmin = warp_min(kmin);
        kmax = warp_max(kmax);
        if (causal && pass == 0 && kmin > qmax) continue;  // wholly masked
        const int unmasked = n0 + kTile <= sk && (!causal || kmax <= qmin);
        mbar_wait(&empty[stage], phase ^ 1);
#pragma unroll
        for (int e = 0; e < kTile / 32; ++e) s_kpos[stage * kTile + lane + 32 * e] = kp[e];
        if (lane == 0) s_meta[stage] = make_int2(n0, unmasked);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], 2 * P::kTileBytes);
#pragma unroll
          for (int p = 0; p < P::kPanels; ++p) {
            const int off = stage * P::kTileBytes + p * P::kPanelBytes;
            tma_load_4d(s_k + off, &kmap, &full[stage], p * P::kPanelCols, kh, n0, b);
            tma_load_4d(s_v + off, &vmap, &full[stage], p * P::kPanelCols, kh, n0, b);
          }
        }
        ++scored;
        if (++stage == P::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // End of the walk: a stage that carries no tile.
      mbar_wait(&empty[stage], phase ^ 1);
      if (lane == 0) {
        s_meta[stage] = make_int2(-1, 0);
        mbar_arrive(&full[stage]);
      }
      if (++stage == P::kStages) {
        stage = 0;
        phase ^= 1;
      }
      if (pass == 0) {
        mbar_wait(decide, 0);
        if (*reinterpret_cast<volatile int*>(s_flag) == 0) break;
      }
    }
    if (lane == 0 && args.tiles != nullptr) atomicAdd(args.tiles, scored);
  } else {
    // --------------------------------------------------------- consumers
    // Software-pipelined over KV tiles: S of tile t + 1 is computed while
    // P V of tile t is in flight, and the softmax of tile t + 1 runs on the
    // CUDA cores while the tensor cores finish P V of tile t.
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int tig = lane & 3;
    const int r_lo = wg * 64 + warp * 16 + (lane >> 2);  // rows r_lo and r_lo + 8
    const int row0 = q0 + r_lo;
    const int row1 = row0 + 8;
    const int qp0 = row0 < sq ? qpos[row0 * args.qp_ss] : INT_MAX;
    const int qp1 = row1 < sq ? qpos[row1 * args.qp_ss] : INT_MAX;
    const float scale = args.scale * kLog2e;  // scores in log2 units
    const unsigned char* q_wg = s_q + wg * 64 * P::kSwizzle;

    float acc[P::kPanels][P::kPanelCols / 2];
    float s[kTile / 2];
    uint32_t pa[kTile / 16][4];
    float m0, m1, l0, l1;
    int stage = 0;
    uint32_t phase = 0;
    auto release = [&](int st) {
      if (lane == 0) mbar_arrive(&empty[st]);
    };
    mbar_wait(q_bar, 0);
    for (int pass = 0;; ++pass) {
      m0 = m1 = kMasked;
      l0 = l1 = 0.f;
#pragma unroll
      for (int p = 0; p < P::kPanels; ++p)
#pragma unroll
        for (int i = 0; i < P::kPanelCols / 2; ++i) acc[p][i] = 0.f;

      // Prologue: S and P of the first tile.
      mbar_wait(&full[stage], phase);
      int2 meta = s_meta[stage];
      if (meta.x >= 0) {
        float a0, a1;
        issue_qk<HD>(s, q_wg, s_k + stage * P::kTileBytes);
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kTile / 2; ++i) fence_reg(s[i]);
        softmax_tile<true>(s, meta.x, s_kpos + stage * kTile, sk, causal, qp0, qp1, tig, scale,
                           m0, m1, l0, l1, a0, a1);
        pack_p(s, pa);
        int held = stage;  // the stage whose V the pending P multiplies
        if (++stage == P::kStages) {
          stage = 0;
          phase ^= 1;
        }
        // Steady state: S of this tile and P V of the held one in flight
        // together; the softmax runs while P V finishes. Each tile takes one
        // of two straight-line bodies, chosen before its MMAs are issued.
        auto step = [&](auto mask) {
          issue_qk<HD>(s, q_wg, s_k + stage * P::kTileBytes);
          issue_pv<HD>(acc, pa, s_v + held * P::kTileBytes);
          wgmma_wait<1>();
#pragma unroll
          for (int i = 0; i < kTile / 2; ++i) fence_reg(s[i]);
          softmax_tile<decltype(mask)::value>(s, meta.x, s_kpos + stage * kTile, sk, causal, qp0,
                                              qp1, tig, scale, m0, m1, l0, l1, a0, a1);
          wgmma_wait<0>();
#pragma unroll
          for (int j = 0; j < kTile / 16; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) fence_reg(pa[j][i]);
          release(held);
#pragma unroll
          for (int p = 0; p < P::kPanels; ++p) {
#pragma unroll
            for (int i = 0; i < P::kPanelCols / 2; i += 4) {
              fence_reg(acc[p][i]);
              fence_reg(acc[p][i + 1]);
              fence_reg(acc[p][i + 2]);
              fence_reg(acc[p][i + 3]);
              acc[p][i] *= a0;
              acc[p][i + 1] *= a0;
              acc[p][i + 2] *= a1;
              acc[p][i + 3] *= a1;
            }
          }
          pack_p(s, pa);
        };
        while (true) {
          mbar_wait(&full[stage], phase);
          meta = s_meta[stage];
          if (meta.x < 0) break;
          if (meta.y) {
            step(std::false_type{});
          } else {
            step(std::true_type{});
          }
          held = stage;
          if (++stage == P::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        // Epilogue: P V of the last tile.
        issue_pv<HD>(acc, pa, s_v + held * P::kTileBytes);
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < kTile / 16; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_reg(pa[j][i]);
        release(held);
      }
#pragma unroll
      for (int p = 0; p < P::kPanels; ++p)
#pragma unroll
        for (int i = 0; i < P::kPanelCols / 2; ++i) fence_reg(acc[p][i]);
      release(stage);  // the end of the walk
      if (++stage == P::kStages) {
        stage = 0;
        phase ^= 1;
      }
      // A stored row that saw no key must average V over every key: rescan.
      const bool blind = (row0 < sq && m0 == kMasked) || (row1 < sq && m1 == kMasked);
      const bool rescan = bar_or(1, kConsumers, blind);
      if (pass > 0) break;
      if (threadIdx.x == 128) {
        *reinterpret_cast<volatile int*>(s_flag) = rescan;
        mbar_arrive(decide);
      }
      if (!rescan) break;
    }

    const float d0 = fmaxf(quad_sum(l0), 1e-30f);
    const float d1 = fmaxf(quad_sum(l1), 1e-30f);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(args.o) + b * args.o_sb + h * args.o_sh;
#pragma unroll
    for (int p = 0; p < P::kPanels; ++p) {
#pragma unroll
      for (int j = 0; j < P::kPanelCols / 8; ++j) {
        if (p * P::kPanelCols + 8 * j >= HD) continue;  // a padded panel's zero columns
        const int c = p * P::kPanelCols + 8 * j + 2 * tig;
        if (row0 < sq) {
          *reinterpret_cast<__nv_bfloat162*>(o + row0 * args.o_ss + c) =
              __floats2bfloat162_rn(acc[p][4 * j] / d0, acc[p][4 * j + 1] / d0);
        }
        if (row1 < sq) {
          *reinterpret_cast<__nv_bfloat162*>(o + row1 * args.o_ss + c) =
              __floats2bfloat162_rn(acc[p][4 * j + 2] / d1, acc[p][4 * j + 3] / d1);
        }
      }
    }
  }
}

// ------------------------------------------------------ bf16, exact width
//
// hd 80 and 112 take a plan of their own (see the file's header).
// tools/kernel_levers.py undoes its choices one at a time by substituting
// this source's text.

__host__ __device__ constexpr bool exact_plan(int hd) { return hd == 80 || hd == 112; }
constexpr int kMaxStages = 4;        // the ring's depth where shared memory allows it
constexpr int kStageKeys = 64;       // keys a stage: half a tile (at 128, hd 112 spills)

constexpr int kExactConsumers = 256;                  // two consumer warpgroups, threads 0..255
constexpr int kExactThreads = kExactConsumers + 32;  // and one producer warp

// Width of panel p when hd is cut into panels of 64, then 32, then 16
// columns (80 = 64 + 16, 112 = 64 + 32 + 16); 0 past the last panel.
__host__ __device__ constexpr int panel_cols(int hd, int p) {
  for (int w = 64; w >= 16; w /= 2) {
    for (; hd >= w; hd -= w) {
      if (p-- == 0) return w;
    }
  }
  return 0;
}

__host__ __device__ constexpr int panel_count(int hd) {
  int n = 0;
  while (panel_cols(hd, n) != 0) ++n;
  return n;
}

// First column of panel p. A tile of R rows holds its panels back to back,
// each R rows of 2 * width bytes, so panel p starts at byte 2 * R * col0.
__host__ __device__ constexpr int panel_col0(int hd, int p) {
  int c = 0;
  for (int i = 0; i < p; ++i) c += panel_cols(hd, i);
  return c;
}

template <int HD>
struct ExactPlan {
  static_assert(HD % 16 == 0, "the bf16 wgmma's k step is 16");
  static constexpr int kQBytes = 2 * kTile * HD;   // a Q tile (128 rows), no padding
  static constexpr int kKVBytes = 2 * kStageKeys * HD;  // a K or V tile of a stage
  // A stage: a K and a V tile, their k_pos, its meta and two barriers.
  // Fixed: two Q buffers and their two barriers each, the warpgroups' turns,
  // the alignment slack.
  static constexpr int kStageBytes = 2 * kKVBytes + kStageKeys * 4 + 8 + 16;
  static constexpr int kFixedBytes = 2 * kQBytes + 6 * 8 + 1024;
  static constexpr int kFit = (232448 - kFixedBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;  // 4
  static constexpr int kQ = 0;  // Q buffer n % 2 for a block's item n; its O is staged there
  static constexpr int kK = kQ + 2 * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kKpos = kV + kStages * kKVBytes;  // int [stage][kStageKeys]
  // int2 [stage]: (n0, unmasked) for a tile, (-1, rescan) at the end of a pass
  static constexpr int kMeta = kKpos + kStages * kStageKeys * 4;
  // full[], empty[], q_full[2], q_empty[2], turn[2]
  static constexpr int kBars = kMeta + kStages * 8;
  static constexpr int kBytes = kBars + (2 * kStages + 6) * 8 + 1024;
  static_assert(kStages >= 3, "the consumers hold two stages: a third must load meanwhile");
  static_assert(kBytes <= 232448, "over the H100's shared memory a block");
};

template <int HD>
struct ExactMaps {  // a tensor map a panel: Q (128 rows), K and V (kStageKeys) loads, O stores (64)
  CUtensorMap q[panel_count(HD)], k[panel_count(HD)], v[panel_count(HD)], o[panel_count(HD)];
};

struct Item {
  int q0, h, b;
};

// Work item i of a launch over (q tiles, heads, batch), heaviest first: the
// last q tiles, the longest walks under a causal mask, come first. 32-bit
// division where it suffices (a 64-bit one costs about a hundred
// instructions).
__device__ __forceinline__ Item item_at(long long i, int ntq, int heads, long long hb) {
  if (i <= INT_MAX && hb <= INT_MAX) {
    const unsigned t = static_cast<unsigned>(i) / static_cast<unsigned>(hb);
    const unsigned bh = static_cast<unsigned>(i) - t * static_cast<unsigned>(hb);
    return {(ntq - 1 - static_cast<int>(t)) * kTile, static_cast<int>(bh % heads),
            static_cast<int>(bh / heads)};
  }
  const long long t = i / hb;
  const long long bh = i - t * hb;
  return {(ntq - 1 - static_cast<int>(t)) * kTile, static_cast<int>(bh % heads),
          static_cast<int>(bh / heads)};
}

// Every panel of a tile of `rows` rows: one TMA load a panel, on `bar`.
template <int HD>
__device__ __forceinline__ void load_tile(const CUtensorMap* maps, unsigned char* tile, int rows,
                                          uint64_t* bar, int head, int row, int b) {
#pragma unroll
  for (int p = 0; p < panel_count(HD); ++p) {
    tma_load_4d(tile + panel_col0(HD, p) * 2 * rows, &maps[p], bar, panel_col0(HD, p), head, row, b);
  }
}

// One k16 step of S = Q K^T against a stage of 128 or 64 keys.
__device__ __forceinline__ void wgmma_qk(float (&s)[64], uint64_t da, uint64_t db, int scale_d) {
  wgmma_ss_bf16_n128(s, da, db, scale_d);
}

__device__ __forceinline__ void wgmma_qk(float (&s)[32], uint64_t da, uint64_t db, int scale_d) {
  wgmma_ss_bf16_n64(s, da, db, scale_d);
}

// The k16 steps of S = Q K^T (64 query rows of warpgroup `wg` against a
// stage's kStageKeys keys) in panel P and the panels after it, each at its
// panel's own width and swizzle.
template <int HD, int P = 0>
__device__ __forceinline__ void qk_steps(float (&s)[kStageKeys / 2], const unsigned char* q_tile,
                                         const unsigned char* k_tile, int wg) {
  if constexpr (P < panel_count(HD)) {
    constexpr int kN = panel_cols(HD, P);
    constexpr int kC0 = panel_col0(HD, P);
#pragma unroll
    for (int c = 0; c < kN; c += 16) {
      const uint64_t da =
          make_desc(q_tile + kC0 * 2 * kTile + wg * 64 * 2 * kN + 2 * c, 2 * kN, 16 * kN);
      const uint64_t db = make_desc(k_tile + kC0 * 2 * kStageKeys + 2 * c, 2 * kN, 16 * kN);
      wgmma_qk(s, da, db, P > 0 || c > 0);
    }
    qk_steps<HD, P + 1>(s, q_tile, k_tile, wg);
  }
}

// O += P V for k16 step j (keys 16j..16j+15 of a stage): one wgmma a
// panel at the panel's N, on the accumulator's hd / 2 floats in column order.
template <int HD, int P = 0>
__device__ __forceinline__ void pv_step(float (&acc)[HD / 2], const uint32_t (&a)[4],
                                        const unsigned char* v_tile, int j) {
  if constexpr (P < panel_count(HD)) {
    constexpr int kN = panel_cols(HD, P);
    constexpr int kC0 = panel_col0(HD, P);
    const uint64_t db = make_desc(v_tile + kC0 * 2 * kStageKeys + j * 16 * 2 * kN, 2 * kN, 16 * kN);
    float(&d)[kN / 2] = *reinterpret_cast<float(*)[kN / 2]>(&acc[kC0 / 2]);
    if constexpr (kN == 64) {
      wgmma_rs_bf16_n64(d, a, db, 1);
    } else if constexpr (kN == 32) {
      wgmma_rs_bf16_n32(d, a, db, 1);
    } else {
      wgmma_rs_bf16_n16(d, a, db, 1);
    }
    pv_step<HD, P + 1>(acc, a, v_tile, j);
  }
}

template <int HD>
__device__ __forceinline__ void issue_qk_exact(float (&s)[kStageKeys / 2], const unsigned char* q_tile,
                                               const unsigned char* k_tile, int wg) {
  wgmma_fence();
  qk_steps<HD>(s, q_tile, k_tile, wg);
  wgmma_commit();
}

template <int HD>
__device__ __forceinline__ void issue_pv_exact(float (&acc)[HD / 2],
                                               const uint32_t (&pa)[kStageKeys / 16][4],
                                               const unsigned char* v_tile) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kStageKeys / 16; ++j) pv_step<HD>(acc, pa[j], v_tile, j);
  wgmma_commit();
}

// O / l rounded to bf16 into tile rows r and r + 8 of panel P and the
// panels after it, in TMA's swizzled layout: the 16-byte chunk bits (4 and
// up) of a byte offset are XORed with its bits 7 and up, as many as a row
// of the panel has chunk bits (128B: 3, 64B: 2, 32B: 1). r0 and r1 are
// the rows' 1 / l: a multiply an element, where an IEEE division costs
// about twenty instructions.
template <int HD, int P = 0>
__device__ __forceinline__ void stage_o(const float (&acc)[HD / 2], unsigned char* tile, int r,
                                        int tig, float r0, float r1) {
  if constexpr (P < panel_count(HD)) {
    constexpr int kN = panel_cols(HD, P);
    constexpr int kC0 = panel_col0(HD, P);
    constexpr int kRow = 2 * kN;
    constexpr int kChunks = kRow / 16 - 1;
    unsigned char* panel = tile + kC0 * 2 * kTile;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int o0 = r * kRow + (8 * j + 2 * tig) * 2;
      const int o1 = o0 + 8 * kRow;
      const int a = kC0 / 2 + 4 * j;
      *reinterpret_cast<uint32_t*>(panel + (o0 ^ (((o0 >> 7) & kChunks) << 4))) =
          pack_rn(acc[a] * r0, acc[a + 1] * r0);
      *reinterpret_cast<uint32_t*>(panel + (o1 ^ (((o1 >> 7) & kChunks) << 4))) =
          pack_rn(acc[a + 2] * r1, acc[a + 3] * r1);
    }
    stage_o<HD, P + 1>(acc, tile, r, tig, r0, r1);
  }
}

template <int HD>
__global__ void __launch_bounds__(kExactThreads, 1)
flash_bf16_kernel(const __grid_constant__ ExactMaps<HD> maps, const Args args, const int batch) {
  using P = ExactPlan<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* s_q = smem + P::kQ;
  unsigned char* s_k = smem + P::kK;
  unsigned char* s_v = smem + P::kV;
  int* s_kpos = reinterpret_cast<int*>(smem + P::kKpos);
  int2* s_meta = reinterpret_cast<int2*>(smem + P::kMeta);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* empty = full + P::kStages;
  uint64_t* q_full = empty + P::kStages;
  uint64_t* q_empty = q_full + 2;
  uint64_t* turn = q_empty + 2;  // warpgroup w may issue its MMAs when turn[w] completes

  const int sq = args.sq;
  const int sk = args.sk;
  const bool causal = args.causal != 0;
  const int ntq = (sq + kTile - 1) / kTile;
  const long long hb = static_cast<long long>(args.heads) * batch;
  const long long items = ntq * hb;
  const int group = args.heads / args.kv_heads;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 2);  // one arrival a consumer warpgroup
      mbar_init(&turn[i], 1);
    }
    mbar_init_fence();
    mbar_arrive(&turn[0]);  // warpgroup 0 issues first
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  int stage = 0;
  uint32_t phase = 0;
  int n = 0;  // the block's items so far: item n uses Q buffer n % 2
  if (threadIdx.x >= kExactConsumers) {
    // ---------------------------------------------------- producer warp
    // The skip rule, the rescan and the tiles counter are those of 128-key
    // tiles (FLASH_TILES); a scored tile goes out as its stages of kStageKeys
    // inside Sk, less, in pass 0, a stage whose every pair is masked.
    if (lane == 0) {
#pragma unroll
      for (int p = 0; p < panel_count(HD); ++p) {
        prefetch_tensor_map(&maps.q[p]);
        prefetch_tensor_map(&maps.k[p]);
        prefetch_tensor_map(&maps.v[p]);
        prefetch_tensor_map(&maps.o[p]);
      }
    }
    const int ntiles = (sk + kTile - 1) / kTile;
    unsigned long long scored = 0;
    for (long long item = blockIdx.x; item < items; item += gridDim.x, ++n) {
      const Item it = item_at(item, ntq, args.heads, hb);
      const int kh = it.h / group;
      const int* qpos = args.qpos + it.b * args.qp_sb;
      const int* kpos = args.kpos + it.b * args.kp_sb;
      int qmax = INT_MIN, qmin = INT_MAX;
      for (int r = lane; r < kTile; r += 32) {
        if (it.q0 + r < sq) {
          const int p = qpos[(it.q0 + r) * args.qp_ss];
          qmax = max(qmax, p);
          qmin = min(qmin, p);
        }
      }
      qmax = warp_max(qmax);
      qmin = warp_min(qmin);
      const int qb = n & 1;
      mbar_wait(&q_empty[qb], ((n >> 1) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&q_full[qb], P::kQBytes);
        load_tile<HD>(maps.q, s_q + qb * P::kQBytes, kTile, &q_full[qb], it.h, it.q0, it.b);
      }
      int kmin_all = INT_MAX;  // over every key of the row, skipped tiles too
      for (int pass = 0; pass < 2; ++pass) {
        for (int t = 0; t < ntiles; ++t) {
          constexpr int kSub = kTile / kStageKeys;  // stages a tile
          constexpr int kE = kStageKeys / 32;       // keys a lane a stage
          const int n0 = t * kTile;
          int kp[kTile / 32];  // kp[u kE + e]: key n0 + kStageKeys u + 32 e + lane
          int umin[kSub], umax[kSub];
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            umin[u] = INT_MAX;
            umax[u] = INT_MIN;
          }
#pragma unroll
          for (int e = 0; e < kTile / 32; ++e) {
            const int key = n0 + lane + 32 * e;
            kp[e] = 0;
            if (key < sk) {
              kp[e] = kpos[key * args.kp_ss];
              umin[e / kE] = min(umin[e / kE], kp[e]);
              umax[e / kE] = max(umax[e / kE], kp[e]);
            }
          }
          bool any = false;
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            const int kmin = warp_min(umin[u]);
            const int kmax = warp_max(umax[u]);
            kmin_all = min(kmin_all, kmin);
            const int n0u = n0 + u * kStageKeys;
            if (n0u >= sk || (causal && pass == 0 && kmin > qmax)) continue;  // nothing to score
            any = true;
            const int unmasked = n0u + kStageKeys <= sk && (!causal || kmax <= qmin);
            mbar_wait(&empty[stage], phase ^ 1);
#pragma unroll
            for (int e = 0; e < kE; ++e) s_kpos[stage * kStageKeys + lane + 32 * e] = kp[u * kE + e];
            if (lane == 0) s_meta[stage] = make_int2(n0u, unmasked);
            __syncwarp();
            if (lane == 0) {
              mbar_arrive_expect_tx(&full[stage], 2 * P::kKVBytes);
              load_tile<HD>(maps.k, s_k + stage * P::kKVBytes, kStageKeys, &full[stage], kh, n0u, it.b);
              load_tile<HD>(maps.v, s_v + stage * P::kKVBytes, kStageKeys, &full[stage], kh, n0u, it.b);
            }
            if (++stage == P::kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
          scored += any;
        }
        // A row whose q_pos is below every k_pos sees no key and averages V
        // over every key (the reference's all -1e30 row): walk again.
        const int rescan = pass == 0 && causal && qmin < kmin_all;
        mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          s_meta[stage] = make_int2(-1, rescan);
          mbar_arrive(&full[stage]);
        }
        if (++stage == P::kStages) {
          stage = 0;
          phase ^= 1;
        }
        if (!rescan) break;
      }
    }
    if (lane == 0 && args.tiles != nullptr) atomicAdd(args.tiles, scored);
    return;
  }

  // ---------------------------------------------------------- consumers
  // Each item's walk is software-pipelined as in flash_bf16_kernel above,
  // a stage a step.
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3;
  const int tig = lane & 3;
  const int r_lo = wg * 64 + warp * 16 + (lane >> 2);  // tile rows r_lo and r_lo + 8
  const bool leader = (threadIdx.x & 127) == 0;        // stores its warpgroup's rows of O
  const float scale = args.scale * kLog2e;             // scores in log2 units
  auto row_pos = [&](const Item& x, int r) {
    return x.q0 + r < sq ? args.qpos[x.b * args.qp_sb + (x.q0 + r) * args.qp_ss] : INT_MAX;
  };
  auto release = [&](int st) {
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  // Ping-pong: the warpgroups take turns to issue their MMAs, so one's
  // softmax runs while the tensor cores work through the other's MMAs.
  uint32_t turn_phase = 0;
  auto take_turn = [&] {
    mbar_wait(&turn[wg], turn_phase);
    turn_phase ^= 1;
  };
  auto pass_turn = [&] {
    if (leader) mbar_arrive(&turn[wg ^ 1]);
  };
  // The leader hands an item's Q buffer back once its O store has read it,
  // a step into the next item's walk, not right after the store.
  int stored = -1;
  auto settle = [&] {
    if (leader && stored >= 0) {
      bulk_wait_read<0>();
      mbar_arrive(&q_empty[stored]);
      stored = -1;
    }
  };

  float acc[HD / 2];
  float s[kStageKeys / 2];
  uint32_t pa[kStageKeys / 16][4];
  float m0, m1, l0, l1;
  long long item = blockIdx.x;
  // The next item and its rows' positions, loaded one item ahead.
  Item next = item < items ? item_at(item, ntq, args.heads, hb) : Item{0, 0, 0};
  int next0 = item < items ? row_pos(next, r_lo) : 0;
  int next1 = item < items ? row_pos(next, r_lo + 8) : 0;
  for (; item < items; ++n) {
    const Item it = next;
    const int qp0 = next0, qp1 = next1;
    item += gridDim.x;
    if (item < items) {
      next = item_at(item, ntq, args.heads, hb);
      next0 = row_pos(next, r_lo);
      next1 = row_pos(next, r_lo + 8);
    }
    const int qb = n & 1;
    unsigned char* s_qt = s_q + qb * P::kQBytes;
    mbar_wait(&q_full[qb], (n >> 1) & 1);
    for (;;) {  // pass 0, then the rescan when the producer orders one
      m0 = m1 = kMasked;
      l0 = l1 = 0.f;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
      mbar_wait(&full[stage], phase);
      int2 meta = s_meta[stage];
      if (meta.x >= 0) {
        float a0, a1;
        take_turn();
        issue_qk_exact<HD>(s, s_qt, s_k + stage * P::kKVBytes, wg);
        pass_turn();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kStageKeys / 2; ++i) fence_reg(s[i]);
        softmax_tile<true>(s, meta.x, s_kpos + stage * kStageKeys, sk, causal, qp0, qp1, tig, scale,
                           m0, m1, l0, l1, a0, a1);
        pack_p(s, pa);
        settle();
        int held = stage;
        if (++stage == P::kStages) {
          stage = 0;
          phase ^= 1;
        }
        auto step = [&](auto mask) {
          take_turn();
          issue_qk_exact<HD>(s, s_qt, s_k + stage * P::kKVBytes, wg);
          issue_pv_exact<HD>(acc, pa, s_v + held * P::kKVBytes);
          pass_turn();
          wgmma_wait<1>();
#pragma unroll
          for (int i = 0; i < kStageKeys / 2; ++i) fence_reg(s[i]);
          softmax_tile<decltype(mask)::value>(s, meta.x, s_kpos + stage * kStageKeys, sk, causal, qp0,
                                              qp1, tig, scale, m0, m1, l0, l1, a0, a1);
          wgmma_wait<0>();
#pragma unroll
          for (int j = 0; j < kStageKeys / 16; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) fence_reg(pa[j][i]);
          release(held);
#pragma unroll
          for (int i = 0; i < HD / 2; i += 4) {
            fence_reg(acc[i]);
            fence_reg(acc[i + 1]);
            fence_reg(acc[i + 2]);
            fence_reg(acc[i + 3]);
            acc[i] *= a0;
            acc[i + 1] *= a0;
            acc[i + 2] *= a1;
            acc[i + 3] *= a1;
          }
          pack_p(s, pa);
        };
        while (true) {
          mbar_wait(&full[stage], phase);
          meta = s_meta[stage];
          if (meta.x < 0) break;
          if (meta.y) {
            step(std::false_type{});
          } else {
            step(std::true_type{});
          }
          held = stage;
          if (++stage == P::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        take_turn();
        issue_pv_exact<HD>(acc, pa, s_v + held * P::kKVBytes);
        pass_turn();
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < kStageKeys / 16; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_reg(pa[j][i]);
        release(held);
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) fence_reg(acc[i]);
      release(stage);  // the end of the pass
      if (++stage == P::kStages) {
        stage = 0;
        phase ^= 1;
      }
      settle();
      if (meta.y == 0) break;
    }

    const float r0 = __frcp_rn(fmaxf(quad_sum(l0), 1e-30f));  // 1 / max(l, 1e-30)
    const float r1 = __frcp_rn(fmaxf(quad_sum(l1), 1e-30f));
    // The warpgroup's wgmmas no longer read its 64 rows of Q: O takes them.
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
  }
  if (leader) bulk_wait<0>();  // the last stores are written before the block ends
}

// ------------------------------------------------------------------- f32

constexpr int kF32Rows = 64;       // query rows a block
constexpr int kF32Keys = 64;       // keys a KV tile
constexpr int kF32Threads = 256;   // 4 threads a row

// Rows [r0, r0 + 64) of a [rows, HD] f32 matrix with row stride `ld_src`
// into `dst` (row stride LD), zeros past `rows`.
template <int HD, int LD>
__device__ __forceinline__ void stage_f32(const float* __restrict__ src, long long ld_src, int rows,
                                          int r0, float* dst) {
  for (int e = threadIdx.x; e < kF32Rows * HD; e += kF32Threads) {
    const int r = e / HD;
    const int c = e % HD;
    dst[r * LD + c] = r0 + r < rows ? src[(r0 + r) * ld_src + c] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const Args args) {
  constexpr int LD = HD + 1;           // odd stride: the 8 rows of a warp hit distinct banks
  constexpr int LDP = kF32Keys + 1;
  constexpr int kKeys = kF32Keys / 4;  // keys a thread scores: sub, sub + 4, ...
  constexpr int kDims = HD / 4;        // dims a thread accumulates: sub, sub + 4, ...
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);
  float* s_k = s_q + kF32Rows * LD;
  float* s_v = s_k + kF32Keys * LD;
  float* s_p = s_v + kF32Keys * LD;
  __shared__ int s_kpos[kF32Keys];
  __shared__ int s_qmax, s_skip;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (args.heads / args.kv_heads);
  const int sq = args.sq;
  const int sk = args.sk;
  const bool causal = args.causal != 0;
  const float* q = static_cast<const float*>(args.q) + b * args.q_sb + h * args.q_sh;
  const float* k = static_cast<const float*>(args.k) + b * args.k_sb + kh * args.k_sh;
  const float* v = static_cast<const float*>(args.v) + b * args.v_sb + kh * args.v_sh;
  float* o = static_cast<float*>(args.o) + b * args.o_sb + h * args.o_sh;
  const int* qpos = args.qpos + b * args.qp_sb;
  const int* kpos = args.kpos + b * args.kp_sb;

  const int r = threadIdx.x >> 2;   // the thread's row in the tile
  const int sub = threadIdx.x & 3;  // its quarter: the 4 threads of a row are one quad
  const int row = q0 + r;
  const int qp = row < sq ? qpos[row * args.qp_ss] : INT_MAX;

  if (threadIdx.x == 0) s_qmax = INT_MIN;
  stage_f32<HD, LD>(q, args.q_ss, sq, q0, s_q);
  __syncthreads();
  if (row < sq && sub == 0) atomicMax(&s_qmax, qp);
  unsigned long long scored = 0;
  float m, l, acc[kDims];
  for (int pass = 0;; ++pass) {
    m = kMasked;
    l = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) acc[dd] = 0.f;
    for (int n0 = 0; n0 < sk; n0 += kF32Keys) {
      __syncthreads();  // every thread is done with the previous tile; s_qmax is final
      if (threadIdx.x < 32) {
        int kmin = INT_MAX;
        for (int e = threadIdx.x; e < kF32Keys; e += 32) {
          const int key = n0 + e;
          const int p = key < sk ? kpos[key * args.kp_ss] : 0;
          s_kpos[e] = p;
          if (key < sk) kmin = min(kmin, p);
        }
        kmin = warp_min(kmin);
        if (threadIdx.x == 0) s_skip = causal && pass == 0 && kmin > s_qmax;
      }
      __syncthreads();
      if (s_skip) continue;  // wholly masked
      ++scored;
      stage_f32<HD, LD>(k, args.k_ss, sk, n0, s_k);
      stage_f32<HD, LD>(v, args.v_ss, sk, n0, s_v);
      __syncthreads();

      float s[kKeys];
      float mx = m;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const int j = sub + 4 * i;
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(s_q[r * LD + d], s_k[j * LD + d], dot);
        float x = dot * args.scale;
        if (n0 + j >= sk) {
          x = -INFINITY;
        } else if (causal && qp < s_kpos[j]) {
          x = kMasked;
        }
        s[i] = x;
        mx = fmaxf(mx, x);
      }
      mx = quad_max(mx);
      const float alpha = expf(m - mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const float p = expf(s[i] - mx);
        s_p[r * LDP + sub + 4 * i] = p;
        sum += p;
      }
      l = l * alpha + quad_sum(sum);
      m = mx;
      __syncwarp();  // the row's p, written by its own quad, is visible to it
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) acc[dd] *= alpha;
      for (int j = 0; j < kF32Keys; ++j) {
        const float p = s_p[r * LDP + j];
#pragma unroll
        for (int dd = 0; dd < kDims; ++dd) acc[dd] = fmaf(p, s_v[j * LD + 4 * dd + sub], acc[dd]);
      }
    }
    // A stored row that saw no key must average V over every key: rescan.
    if (pass > 0 || !__syncthreads_or(row < sq && m == kMasked)) break;
  }

  if (threadIdx.x == 0 && args.tiles != nullptr) atomicAdd(args.tiles, scored);
  if (row < sq) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) o[row * args.o_ss + 4 * dd + sub] = acc[dd] / den;
  }
}

// ---------------------------------------------------------------- launch

constexpr int kMaxDevices = 64;

// cudaFuncSetAttribute(kernel, max dynamic shared memory, bytes) on card
// `device` (the current one), once: `done` keeps a flag a device for the
// kernel, since the attribute holds until the process ends.
template <typename Kernel>
int allow_smem(Kernel* kernel, int bytes, int device, std::atomic<bool> (&done)[kMaxDevices]) {
  const bool kept = device >= 0 && device < kMaxDevices;
  if (kept && done[device].load(std::memory_order_relaxed)) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && kept) done[device].store(true, std::memory_order_relaxed);
  return static_cast<int>(err);
}

// The SM count of each card, queried on its first launch only.
std::atomic<int> g_sms[kMaxDevices];

int sm_count(int device) {
  if (device < 0 || device >= kMaxDevices) return -1;
  int sms = g_sms[device].load(std::memory_order_relaxed);
  if (sms > 0) return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return -1;
  }
  g_sms[device].store(sms, std::memory_order_relaxed);
  return sms;
}

// A 4-D map (hd, heads, rows, batch) over a bf16 [B, S, heads, hd] tensor
// with element strides sb, ss, sh; box: one panel of the head dim, one head,
// 128 rows, one batch. The map is hd wide, so a box past column hd (the
// second panel at hd 80 and 112 when they run on this plan) reads zeros.
template <int HD>
int bf16_map(CUtensorMap* map, const void* base, int batch, int rows, int heads, long long sb,
             long long ss, long long sh) {
  using P = Plan<HD>;
  const uint64_t dims[4] = {HD, static_cast<uint64_t>(heads), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {static_cast<uint64_t>(sh) * 2, static_cast<uint64_t>(ss) * 2,
                               static_cast<uint64_t>(sb) * 2};
  const uint32_t box[4] = {P::kPanelCols, 1, kTile, 1};
  const CUtensorMapSwizzle swizzle = P::kSwizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : P::kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                         : CU_TENSOR_MAP_SWIZZLE_32B;
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                         swizzle);
}

// A 4-D map (hd, heads, rows, batch) over a bf16 [B, S, heads, hd] tensor
// for one exact-width panel: box `cols` wide from the column given at each
// load or store, one head, `box_rows` rows, one batch, swizzled by the
// panel's row of 2 * cols bytes.
int panel_map(CUtensorMap* map, const void* base, int hd, int cols, int box_rows, int batch,
              int rows, int heads, long long sb, long long ss, long long sh) {
  const uint64_t dims[4] = {static_cast<uint64_t>(hd), static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(rows), static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {static_cast<uint64_t>(sh) * 2, static_cast<uint64_t>(ss) * 2,
                               static_cast<uint64_t>(sb) * 2};
  const uint32_t box[4] = {static_cast<uint32_t>(cols), 1, static_cast<uint32_t>(box_rows), 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                         swizzle);
}

template <int HD>
int launch_exact(const Args& args, int batch, int device, cudaStream_t stream) {
  using P = ExactPlan<HD>;
  ExactMaps<HD> maps;
  int bad = 0;
  for (int p = 0; p < panel_count(HD) && !bad; ++p) {
    const int cols = panel_cols(HD, p);
    bad = panel_map(&maps.q[p], args.q, HD, cols, kTile, batch, args.sq, args.heads, args.q_sb,
                    args.q_ss, args.q_sh);
    if (!bad) {
      bad = panel_map(&maps.k[p], args.k, HD, cols, kStageKeys, batch, args.sk, args.kv_heads,
                      args.k_sb, args.k_ss, args.k_sh);
    }
    if (!bad) {
      bad = panel_map(&maps.v[p], args.v, HD, cols, kStageKeys, batch, args.sk, args.kv_heads,
                      args.v_sb, args.v_ss, args.v_sh);
    }
    if (!bad) {
      bad = panel_map(&maps.o[p], args.o, HD, cols, 64, batch, args.sq, args.heads, args.o_sb,
                      args.o_ss, args.o_sh);
    }
  }
  if (bad) return bad < 0 ? bad : -bad;  // a driver error: negative, apart from CUDA's
  void (*kernel)(ExactMaps<HD>, Args, int) = flash_bf16_kernel<HD>;
  static std::atomic<bool> ready[kMaxDevices];
  const int err = allow_smem(kernel, P::kBytes, device, ready);
  if (err != 0) return err;
  const long long items = static_cast<long long>((args.sq + kTile - 1) / kTile) * args.heads * batch;
  const long long blocks = sm_count(device);  // one block an SM fits: a persistent grid
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  kernel<<<static_cast<int>(items < blocks ? items : blocks), kExactThreads, P::kBytes, stream>>>(
      maps, args, batch);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const Args& args, int batch, int is_bf16, int device, cudaStream_t stream) {
  int err;
  if (is_bf16) {
    if constexpr (exact_plan(HD)) {
      return launch_exact<HD>(args, batch, device, stream);
    } else {
      using P = Plan<HD>;
      CUtensorMap qmap, kmap, vmap;
      int bad = bf16_map<HD>(&qmap, args.q, batch, args.sq, args.heads, args.q_sb, args.q_ss,
                             args.q_sh);
      if (!bad) {
        bad = bf16_map<HD>(&kmap, args.k, batch, args.sk, args.kv_heads, args.k_sb, args.k_ss,
                           args.k_sh);
      }
      if (!bad) {
        bad = bf16_map<HD>(&vmap, args.v, batch, args.sk, args.kv_heads, args.v_sb, args.v_ss,
                           args.v_sh);
      }
      if (bad) return bad < 0 ? bad : -bad;  // a driver error: negative, apart from CUDA's
      void (*kernel)(CUtensorMap, CUtensorMap, CUtensorMap, Args) = flash_bf16_kernel<HD>;
      static std::atomic<bool> ready[kMaxDevices];
      err = allow_smem(kernel, P::kBytes, device, ready);
      if (err != 0) return err;
      const dim3 grid((args.sq + kTile - 1) / kTile, args.heads, batch);
      kernel<<<grid, kThreads, P::kBytes, stream>>>(qmap, kmap, vmap, args);
    }
  } else {
    const int smem = (3 * kF32Rows * (HD + 1) + kF32Rows * (kF32Keys + 1)) *
                     static_cast<int>(sizeof(float));
    static std::atomic<bool> ready[kMaxDevices];
    err = allow_smem(flash_f32_kernel<HD>, smem, device, ready);
    if (err != 0) return err;
    const dim3 grid((args.sq + kF32Rows - 1) / kF32Rows, args.heads, batch);
    flash_f32_kernel<HD><<<grid, kF32Threads, smem, stream>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

// Run `launch<HD>` with card `device` current, restoring the caller's.
template <int HD>
int launch_on(const Args& args, int batch, int is_bf16, int device, cudaStream_t stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch<HD>(args, batch, is_bf16, device, stream);
  if (current != device) {
    err = cudaSetDevice(current);
    if (rc == 0 && err != cudaSuccess) return static_cast<int>(err);
  }
  return rc;
}

}  // namespace

// o[b, i, h] = softmax attention of q[b, i, h] over k[b, :, kh], v[b, :, kh]
// (kh = h / (heads / kv_heads)) with int32 positions qpos[b, i], kpos[b, j],
// on `stream` of card `device`. q, o: [batch, sq, heads, hd]; k, v: [batch,
// sk, kv_heads, hd]; `strides` holds the element strides (batch, row, head)
// of q, k, v and o and (batch, row) of qpos and kpos, 16 values; hd is
// contiguous. bf16 when is_bf16 (16-byte aligned bases and strides, for
// TMA), else f32. hd is 16, 32, 64, 80, 112 or 128; batch and heads <= 65535;
// sq, sk >= 1. `tiles`, if not null, gains the number of KV tiles scored.
// Returns 0 on success, a CUDA error code, or minus a driver error code if a
// tensor map was refused.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* qpos,
                                   const void* kpos, void* o, const long long* strides, int batch,
                                   int sq, int sk, int heads, int kv_heads, int hd, int is_bf16,
                                   int causal, float scale, void* tiles, int device, void* stream) {
  Args args{q, k, v, static_cast<const int*>(qpos), static_cast<const int*>(kpos), o,
            strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
            strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
            strides[12], strides[13], strides[14], strides[15],
            sq, sk, heads, kv_heads, causal, scale,
            static_cast<unsigned long long*>(tiles)};
  auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_on<16>(args, batch, is_bf16, device, s);
    case 32: return launch_on<32>(args, batch, is_bf16, device, s);
    case 64: return launch_on<64>(args, batch, is_bf16, device, s);
    case 80: return launch_on<80>(args, batch, is_bf16, device, s);
    case 112: return launch_on<112>(args, batch, is_bf16, device, s);
    case 128: return launch_on<128>(args, batch, is_bf16, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
