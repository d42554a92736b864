// Forward flash attention (online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas` (body `_kernel`) of
// src/repro/kernels/flash_attention.py. For every (bh, query row i):
//
//   s_j  = (q_i . k_j) * scale                      f32, scale = 1/sqrt(hd)
//   s_j  = -1e30  where causal and q_pos[i] < k_pos[j]
//   o_i  = sum_j p_j v_j / max(sum_j p_j, 1e-30)    p_j = exp(s_j - max s)
//
// with the running max, sum and accumulator in f32 and p cast to v's type
// before the PV product, exactly as the TPU kernel's online softmax does.
// Positions are absolute int32 per (bh, row), so one kernel serves
// training, chunked prefill and offset (Sq < Sk) queries.
//
// Design. The TPU kernel runs a (bh, q-block) grid in order and scans the
// KV blocks with a fori_loop. Here one block owns one (bh, 64-row q tile)
// and loops over 64-key KV tiles itself; nothing carries between blocks.
// Each KV tile (and its k_pos) is staged in shared memory once for all of
// the block's query rows. Ragged shapes are masked in the kernel: query
// rows past Sq are computed on zeros and never stored, key columns past Sk
// get s = -inf, so p = 0 (the running max starts at -1e30, so it is never
// -inf), and their K and V stage as zeros. Masked keys inside Sk keep the
// TPU kernel's -1e30 fill, so a row with no visible key averages V as the
// reference does.
//
//   bf16: 4 warps, each 16 query rows, in the FlashAttention-2 layout with
//   `mma.sync.m16n8k16` bf16 -> f32. Q's fragments stay in registers for
//   the whole KV loop; S = Q K^T stays in registers; the row max and sum are
//   reduced over the 4 threads that share a row by shuffles; P is rounded
//   to bf16 in registers and used directly as the A operand of P V (the
//   reference's p.astype(v.dtype)). Shared rows are padded by 16 bytes so
//   the fragment loads of a warp hit 32 distinct banks.
//   f32: scalar FMA, so the inputs are not rounded: 4 threads a query row,
//   each scoring 16 of the tile's 64 keys and accumulating a quarter of hd;
//   P goes through shared memory between the two products.
//
// Bound. Operations: 4 hd flops a visible (query, key) pair (QK^T and PV),
// against 989 TFLOP/s dense bf16 on the H100; bytes: Q, K, V and the
// positions read once and O written once, against 3.35 TB/s. At the LM
// serving prefill (BH = 72, S = 4096, hd 64, causal) the operations bind:
// about 0.16 ms against 0.05 ms for the bytes. This first kernel scores
// every KV tile, also those wholly above the causal diagonal, stages with
// plain loads into one buffer and computes exp with expf; wgmma, TMA and
// skipping masked tiles are later work.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 64;        // query rows a block
constexpr int kBlockN = 64;        // keys a KV tile
constexpr int kMmaThreads = 128;   // bf16: 4 warps x 16 rows
constexpr int kF32Threads = 256;   // f32: 4 threads a row
constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bits(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Rows [r0, r0 + 64) of the [rows, HD] bf16 matrix `src` into `dst` (row
// stride LD), zeros past `rows`; 16-byte loads (the wrapper checks the
// alignment, and HD * 2 bytes is a multiple of 16).
template <int HD, int LD, int THREADS>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ src, int rows,
                                           int r0, __nv_bfloat16* dst) {
  constexpr int kVecs = HD / 8;
  for (int e = threadIdx.x; e < kBlockM * kVecs; e += THREADS) {
    const int r = e / kVecs;
    const int c = (e % kVecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows) {
      v = *reinterpret_cast<const uint4*>(src + static_cast<long long>(r0 + r) * HD + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

template <int HD, int LD, int THREADS>
__device__ __forceinline__ void stage_f32(const float* __restrict__ src, int rows, int r0,
                                          float* dst) {
  for (int e = threadIdx.x; e < kBlockM * HD; e += THREADS) {
    const int r = e / HD;
    const int c = e % HD;
    dst[r * LD + c] = r0 + r < rows ? src[static_cast<long long>(r0 + r) * HD + c] : 0.f;
  }
}

template <int THREADS>
__device__ __forceinline__ void stage_pos(const int* __restrict__ pos, int n, int n0, int* dst) {
  for (int e = threadIdx.x; e < kBlockN; e += THREADS) dst[e] = n0 + e < n ? pos[n0 + e] : 0;
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
                  const int* __restrict__ kpos, __nv_bfloat16* __restrict__ o, int sq, int sk,
                  int causal, float scale) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_k = s_q + kBlockM * LD;
  __nv_bfloat16* s_v = s_k + kBlockN * LD;
  __shared__ int s_kpos[kBlockN];

  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  q += bh * sq * HD;
  o += bh * sq * HD;
  k += bh * sk * HD;
  v += bh * sk * HD;
  qpos += bh * sq;
  kpos += bh * sk;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // the fragments' groupID: rows g and g + 8
  const int tig = lane & 3;  // and threadID_in_group
  const int r_lo = warp * 16 + g;
  const int row0 = q0 + r_lo;
  const int row1 = row0 + 8;
  const int qp0 = row0 < sq ? qpos[row0] : 0;
  const int qp1 = row1 < sq ? qpos[row1] : 0;

  stage_bf16<HD, LD, kMmaThreads>(q, sq, q0, s_q);
  __syncthreads();
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* p = s_q + r_lo * LD + kk * 16 + 2 * tig;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LD);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LD + 8);
  }

  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  float acc[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;

  for (int n0 = 0; n0 < sk; n0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    stage_bf16<HD, LD, kMmaThreads>(k, sk, n0, s_k);
    stage_bf16<HD, LD, kMmaThreads>(v, sk, n0, s_v);
    stage_pos<kMmaThreads>(kpos, sk, n0, s_kpos);
    __syncthreads();

    // S = Q K^T: n-tile nt holds keys nt*8 .. nt*8+7; element i of it sits at
    // row g (i < 2) or g + 8, key column nt*8 + 2*tig + (i & 1).
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const __nv_bfloat16* p = s_k + (nt * 8 + g) * LD + kk * 16 + 2 * tig;
        mma_bf16(s[nt], qf[kk], ld32(p), ld32(p + 8));
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + 2 * tig + (i & 1);
        float x = s[nt][i] * scale;
        if (n0 + col >= sk) {
          x = -INFINITY;
        } else if (causal && (i < 2 ? qp0 : qp1) < s_kpos[col]) {
          x = kMasked;
        }
        s[nt][i] = x;
        if (i < 2) {
          mx0 = fmaxf(mx0, x);
        } else {
          mx1 = fmaxf(mx1, x);
        }
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float a0 = expf(m0 - mx0);
    const float a1 = expf(m1 - mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mx0);
      s[nt][1] = expf(s[nt][1] - mx0);
      s[nt][2] = expf(s[nt][2] - mx1);
      s[nt][3] = expf(s[nt][3] - mx1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * a0 + quad_sum(sum0);
    l1 = l1 * a1 + quad_sum(sum1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      acc[dt][0] *= a0;
      acc[dt][1] *= a0;
      acc[dt][2] *= a1;
      acc[dt][3] *= a1;
    }

    // O += P V. The S accumulators of n-tiles 2j and 2j+1 are exactly the
    // A fragment of the k16 step j (keys 16j .. 16j+15). B[k][n] = V[key k]
    // [dim n] is gathered from two rows of the staged V per register.
#pragma unroll
    for (int j = 0; j < kBlockN / 16; ++j) {
      const uint32_t pa[4] = {
          pack_rn(s[2 * j][0], s[2 * j][1]), pack_rn(s[2 * j][2], s[2 * j][3]),
          pack_rn(s[2 * j + 1][0], s[2 * j + 1][1]), pack_rn(s[2 * j + 1][2], s[2 * j + 1][3])};
      const __nv_bfloat16* vr = s_v + (16 * j + 2 * tig) * LD + g;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const __nv_bfloat16* p = vr + dt * 8;
        mma_bf16(acc[dt], pa, pack_bits(p[0], p[LD]), pack_bits(p[8 * LD], p[9 * LD]));
      }
    }
  }

  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int c = dt * 8 + 2 * tig;
    if (row0 < sq) {
      *reinterpret_cast<__nv_bfloat162*>(o + static_cast<long long>(row0) * HD + c) =
          __floats2bfloat162_rn(acc[dt][0] / d0, acc[dt][1] / d0);
    }
    if (row1 < sq) {
      *reinterpret_cast<__nv_bfloat162*>(o + static_cast<long long>(row1) * HD + c) =
          __floats2bfloat162_rn(acc[dt][2] / d1, acc[dt][3] / d1);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, float* __restrict__ o, int sq, int sk,
                 int causal, float scale) {
  constexpr int LD = HD + 1;           // odd stride: the 8 rows of a warp hit distinct banks
  constexpr int LDP = kBlockN + 1;
  constexpr int kKeys = kBlockN / 4;   // keys a thread scores: sub, sub + 4, ...
  constexpr int kDims = HD / 4;        // dims a thread accumulates: sub, sub + 4, ...
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);
  float* s_k = s_q + kBlockM * LD;
  float* s_v = s_k + kBlockN * LD;
  float* s_p = s_v + kBlockN * LD;
  __shared__ int s_kpos[kBlockN];

  const long long bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  q += bh * sq * HD;
  o += bh * sq * HD;
  k += bh * sk * HD;
  v += bh * sk * HD;
  qpos += bh * sq;
  kpos += bh * sk;

  const int r = threadIdx.x >> 2;  // the thread's row in the tile
  const int sub = threadIdx.x & 3;  // its quarter: the 4 threads of a row are one quad
  const int row = q0 + r;
  const int qp = row < sq ? qpos[row] : 0;

  stage_f32<HD, LD, kF32Threads>(q, sq, q0, s_q);
  float m = kMasked, l = 0.f;
  float acc[kDims];
#pragma unroll
  for (int dd = 0; dd < kDims; ++dd) acc[dd] = 0.f;

  for (int n0 = 0; n0 < sk; n0 += kBlockN) {
    __syncthreads();
    stage_f32<HD, LD, kF32Threads>(k, sk, n0, s_k);
    stage_f32<HD, LD, kF32Threads>(v, sk, n0, s_v);
    stage_pos<kF32Threads>(kpos, sk, n0, s_kpos);
    __syncthreads();

    float s[kKeys];
    float mx = m;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int j = sub + 4 * i;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot = fmaf(s_q[r * LD + d], s_k[j * LD + d], dot);
      float x = dot * scale;
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
    for (int j = 0; j < kBlockN; ++j) {
      const float p = s_p[r * LDP + j];
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) acc[dd] = fmaf(p, s_v[j * LD + 4 * dd + sub], acc[dd]);
    }
  }

  if (row < sq) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) {
      o[static_cast<long long>(row) * HD + 4 * dd + sub] = acc[dd] / den;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* qpos, const void* kpos,
           void* o, int bh, int sq, int sk, int is_bf16, int causal, float scale,
           cudaStream_t stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  cudaError_t err;
  if (is_bf16) {
    const int smem = 3 * kBlockM * (HD + 8) * static_cast<int>(sizeof(__nv_bfloat16));
    err = cudaFuncSetAttribute(flash_bf16_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bf16_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
        static_cast<const int*>(kpos), static_cast<__nv_bfloat16*>(o), sq, sk, causal, scale);
  } else {
    const int smem =
        (3 * kBlockM * (HD + 1) + kBlockM * (kBlockN + 1)) * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(flash_f32_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_f32_kernel<HD><<<grid, kF32Threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(qpos),
        static_cast<const int*>(kpos), static_cast<float*>(o), sq, sk, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o[bh, i] = softmax attention of q[bh, i] over k[bh], v[bh] (all contiguous,
// [bh, s, hd], bf16 when is_bf16 else f32, 16-byte aligned) with int32
// positions qpos [bh, sq], kpos [bh, sk], on `stream`. hd is 16, 32, 64 or
// 128; bh <= 65535; sq, sk >= 1. Returns cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for another hd. The caller validates the rest.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* qpos, const void* kpos, void* o, int bh, int sq,
                                   int sk, int hd, int is_bf16, int causal, float scale,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, qpos, kpos, o, bh, sq, sk, is_bf16, causal, scale, s);
    case 32: return launch<32>(q, k, v, qpos, kpos, o, bh, sq, sk, is_bf16, causal, scale, s);
    case 64: return launch<64>(q, k, v, qpos, kpos, o, bh, sq, sk, is_bf16, causal, scale, s);
    case 128: return launch<128>(q, k, v, qpos, kpos, o, bh, sq, sk, is_bf16, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
