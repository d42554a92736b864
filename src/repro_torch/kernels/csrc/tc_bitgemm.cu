// Popcount-GEMM for Hopper (sm_90a): C[i][j] = sum_w popc(X[i][w] & Y[j][w]).
//
// Replaces the TPU kernel `bitgemm_pallas` (body `_bitgemm_kernel`) of
// src/repro/kernels/tc_bitgemm.py: X is [I, W] and Y is [J, W] uint32 words
// (bit-packed rows of the adjacency and of its transpose), C is [I, J]
// int32. It is the `bitgemm` backend of tcim_count, Eq. 5 evaluated densely.
//
// Design. The TPU kernel walks a sequential (i, j, k) grid and carries each
// output block across the k steps in VMEM (`pl.when(k == 0)` initialises
// it). Here blocks run in parallel and in no order, so each block owns one
// 64 x 64 output tile for the whole reduction: 256 threads, each with a
// 4 x 4 register tile of int32 sums, loop over W inside the block. Each
// step stages X[i0:i0+64, w0:w0+block_w] and Y[j0:j0+64, w0:w0+block_w]
// in shared memory, transposed (word-major, rows padded to 65 words so the
// transposing store does not fall into one bank), then every thread reads
// 4 + 4 words a word step and computes 16 __popc(x & y). A thread owns rows
// ty + 16a and columns tx + 16b, so a warp's reads are 2 and 16 distinct
// words: broadcasts, no bank conflict. Ragged I, J and W are masked in the
// kernel: words outside the operands stage as 0 (popc(0 & y) = 0), and
// outputs outside [I, J] are not stored. No padding, no init pass.
//
// Exactness. Each entry is at most 32 W, so int32 holds it for any
// W < 2^26; the wrapper rejects wider operands.
//
// Bound. Operations, not bytes. Each word pair costs one LOP3 (AND), one
// POPC and one IADD; POPC issues at 16 a clock on each SM of compute
// capability 9.0 (the CUDA C++ Programming Guide's arithmetic-instruction
// throughput table), against 64 for the AND and the add, so the popcount
// unit binds: I * J * W / (16 * 132 SMs * SM clock). One email-enron chunk
// (I = 2048, J = 36692, W = 1147) is 8.6e10 popcounts, about 20.6 ms at
// 1.98 GHz, while it moves 478 MB (about 0.14 ms at 3.35 TB/s). The b1
// tensor-core MMA (`mma.sync ... .b1.and.popc`) does the same AND-popcount
// on the tensor cores and is how a later kernel can beat this bound.
//
// `block_w` words are staged a step, in 2 * block_w * 65 * 4 bytes of
// dynamic shared memory. Above the 48 KB a launch may take without an
// opt-in (block_w > 94) the launch is refused, and the C entry point
// returns the launch error for the wrapper to raise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;             // output rows and columns of a block
constexpr int kSide = 16;             // threads a side: 16 x 16
constexpr int kThreads = kSide * kSide;
constexpr int kPer = kTile / kSide;   // 4 x 4 outputs a thread
constexpr int kStride = kTile + 1;    // padded row of the staged tiles

__global__ void __launch_bounds__(kThreads)
bitgemm_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
               int rows_i, int rows_j, int words, int block_w,
               int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* xs = smem;                      // xs[c * kStride + r] = X[i0 + r][w0 + c]
  uint32_t* ys = smem + block_w * kStride;  // ys[c * kStride + r] = Y[j0 + r][w0 + c]
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tile_words = kTile * block_w;

  int acc[kPer][kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int b = 0; b < kPer; ++b) acc[a][b] = 0;

  for (int w0 = 0; w0 < words; w0 += block_w) {
    for (int e = threadIdx.x; e < tile_words; e += kThreads) {
      const int r = e / block_w;
      const int c = e - r * block_w;
      const int w = w0 + c;
      const int i = i0 + r;
      const int j = j0 + r;
      xs[c * kStride + r] =
          (i < rows_i && w < words) ? __ldg(x + (long long)i * words + w) : 0u;
      ys[c * kStride + r] =
          (j < rows_j && w < words) ? __ldg(y + (long long)j * words + w) : 0u;
    }
    __syncthreads();
    const int span = min(block_w, words - w0);
    for (int c = 0; c < span; ++c) {
      uint32_t xv[kPer];
      uint32_t yv[kPer];
#pragma unroll
      for (int a = 0; a < kPer; ++a) xv[a] = xs[c * kStride + ty + kSide * a];
#pragma unroll
      for (int b = 0; b < kPer; ++b) yv[b] = ys[c * kStride + tx + kSide * b];
#pragma unroll
      for (int a = 0; a < kPer; ++a)
#pragma unroll
        for (int b = 0; b < kPer; ++b) acc[a][b] += __popc(xv[a] & yv[b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int i = i0 + ty + kSide * a;
    if (i >= rows_i) continue;
#pragma unroll
    for (int b = 0; b < kPer; ++b) {
      const int j = j0 + tx + kSide * b;
      if (j < rows_j) out[(long long)i * rows_j + j] = acc[a][b];
    }
  }
}

}  // namespace

// out[i][j] = sum_w popc(x[i][w] & y[j][w]) for x [rows_i, words] and
// y [rows_j, words] uint32, out [rows_i, rows_j] int32, all contiguous, on
// `stream`. Returns cudaGetLastError() (0 on success). The caller validates
// shapes, types, devices, block_w >= 1 and rows_i <= 65535 * 64 (the grid's
// y limit).
extern "C" int tc_bitgemm(const void* x, const void* y, int rows_i, int rows_j,
                          int words, int block_w, void* out, void* stream) {
  if (rows_i <= 0 || rows_j <= 0) return 0;
  const dim3 grid((rows_j + kTile - 1) / kTile, (rows_i + kTile - 1) / kTile);
  const size_t smem = 2 * static_cast<size_t>(block_w) * kStride * sizeof(uint32_t);
  bitgemm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y), rows_i,
      rows_j, words, block_w, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
