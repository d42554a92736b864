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
// a causal mask) first. A block owns 128 query rows of one head and walks
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
//   bf16, warp-specialised (384 threads). Warpgroup 0 is the producer: one
//   warp reads the positions, decides the skips and keeps TMA loads of K
//   and V tiles (and their k_pos, written by the warp) in flight in a ring
//   of 3 stages with full/empty mbarriers; it hands its registers to the
//   consumers with setmaxnreg. Warpgroups 1 and 2 each own 64 query rows:
//   S = Q K^T by `wgmma.m64n128k16` with Q and K in shared memory, the
//   online softmax in registers with exp2 and scale * log2(e) folded in, P
//   rounded to bf16 in registers (the reference's p.astype(v.dtype)) and
//   used as the register A operand of O += P V by `wgmma.m64nNk16`, V read
//   N-major (transposed) from shared memory. The accumulator layout of S
//   is the A-fragment layout of P: n8 columns 2j and 2j+1 form k16 step j.
//   The loop is software-pipelined: S of the next tile and P V of the
//   current one are in flight together, and the next tile's softmax runs
//   while P V finishes, so the exponentials overlap the tensor cores.
//   Tiles are stored as TMA writes them: rows of hd * 2 bytes with the 32B
//   (hd 16), 64B (hd 32) or 128B (hd 64, and two 64-column panels at hd
//   80, 112 and 128) swizzle, and the wgmma descriptors name the same
//   swizzle. TMA zero-fills rows past Sq and Sk, and at hd 80 and 112 the
//   columns hd..127 of the second panel (the tensor maps are hd wide, the
//   boxes 64): Q K^T takes only the hd / 16 real k steps, P V multiplies
//   the zero columns into output columns that are never stored, so those
//   two widths run hd 128's shared-memory plan and P V at 128 / hd of its
//   true work. Keys past Sk still get s = -inf (p = 0) and rows past Sq
//   are never stored. The mask is applied by selects, with
//   no branch between an MMA in flight and its wait (ptxas serialises the
//   MMAs across such a branch). The producer warpgroup keeps 40 registers
//   a thread, the consumers 232.
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
// 512) the bytes bind.

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
  // Rounded up: at hd 80 and 112 the second panel is zero past column hd.
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
// max is taken on the raw scores and each p is one FFMA and one ex2.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[kTile / 2], int n0, const int* kp,
                                             int sk, bool causal, int qp0, int qp1, int tig,
                                             float scale, float& m0, float& m1, float& l0,
                                             float& l1, float& a0, float& a1) {
  float mx0, mx1;
  if constexpr (kMask) {
    mx0 = m0;
    mx1 = m1;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
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
    for (int j = 0; j < kTile / 8; ++j) {
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
  for (int j = 0; j < kTile / 8; ++j) {
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

// P rounded to bf16 as the A fragments of the 8 k16 steps of P V: step j
// takes the S columns of n8 tiles 2j and 2j + 1.
__device__ __forceinline__ void pack_p(const float (&s)[kTile / 2], uint32_t (&pa)[kTile / 16][4]) {
#pragma unroll
  for (int j = 0; j < kTile / 16; ++j) {
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

// A 4-D map (hd, heads, rows, batch) over a bf16 [B, S, heads, hd] tensor
// with element strides sb, ss, sh; box: one panel of the head dim, one head,
// 128 rows, one batch. The map is hd wide, so a box past column hd (the
// second panel at hd 80 and 112) reads zeros there.
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

template <int HD>
int launch(const Args& args, int batch, int is_bf16, cudaStream_t stream) {
  cudaError_t err;
  if (is_bf16) {
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
    err = cudaFuncSetAttribute(flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               P::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((args.sq + kTile - 1) / kTile, args.heads, batch);
    flash_bf16_kernel<HD><<<grid, kThreads, P::kBytes, stream>>>(qmap, kmap, vmap, args);
  } else {
    const int smem = (3 * kF32Rows * (HD + 1) + kF32Rows * (kF32Keys + 1)) *
                     static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((args.sq + kF32Rows - 1) / kF32Rows, args.heads, batch);
    flash_f32_kernel<HD><<<grid, kF32Threads, smem, stream>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o[b, i, h] = softmax attention of q[b, i, h] over k[b, :, kh], v[b, :, kh]
// (kh = h / (heads / kv_heads)) with int32 positions qpos[b, i], kpos[b, j],
// on `stream`. q, o: [batch, sq, heads, hd]; k, v: [batch, sk, kv_heads, hd];
// `strides` holds the element strides (batch, row, head) of q, k, v and o
// and (batch, row) of qpos and kpos, 16 values; hd is contiguous. bf16 when
// is_bf16 (16-byte aligned bases and strides, for TMA), else f32. hd is 16,
// 32, 64, 80, 112 or 128; batch and heads <= 65535; sq, sk >= 1. `tiles`, if not
// null, gains the number of KV tiles scored. Returns 0 on success, a CUDA
// error code, or minus a driver error code if a tensor map was refused.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* qpos,
                                   const void* kpos, void* o, const long long* strides, int batch,
                                   int sq, int sk, int heads, int kv_heads, int hd, int is_bf16,
                                   int causal, float scale, void* tiles, void* stream) {
  Args args{q, k, v, static_cast<const int*>(qpos), static_cast<const int*>(kpos), o,
            strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
            strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
            strides[12], strides[13], strides[14], strides[15],
            sq, sk, heads, kv_heads, causal, scale,
            static_cast<unsigned long long*>(tiles)};
  auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(args, batch, is_bf16, s);
    case 32: return launch<32>(args, batch, is_bf16, s);
    case 64: return launch<64>(args, batch, is_bf16, s);
    case 80: return launch<80>(args, batch, is_bf16, s);
    case 112: return launch<112>(args, batch, is_bf16, s);
    case 128: return launch<128>(args, batch, is_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
