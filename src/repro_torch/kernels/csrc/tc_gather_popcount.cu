// Fused gather-AND-popcount total for Hopper (sm_90a).
//
// Replaces the TPU kernel `gather_total_pallas` in
// src/repro/kernels/tc_gather_popcount.py (bodies `_gather_total_kernel`,
// B = 1, and `_gather_total_batched_kernel`, B > 1). It computes
//
//   out[0] += sum_p [r_p >= 0 && c_p >= 0] * popcount(row[r_p] & col[c_p])
//   out[1] += #{p : r_p >= R || c_p >= C}
//
// over slice stores row [R, W] and col [C, W] of uint32 words (W = 1, 2 or
// 4) that stay resident on the card; only the index arrays travel.
//
// Design. The TPU kernel walks one pair per grid step and carries the sum
// in its output block from step to step; on a GPU blocks run in parallel
// and in no order, so nothing carries over. Here each thread takes pairs
// in a grid-stride loop, loads its two indices, reads each row with one
// vector load (uint32_t / uint2 / uint4 for W = 1 / 2 / 4), ANDs, and
// counts with __popc. Negative indices (the executor's -1 padding) count
// zero. Threads reduce by warp shuffle, then across warps in shared
// memory, and each block does one int32 atomicAdd into `out`, which is the
// caller's carried accumulator: integer adds are exact in any order, so
// the result is deterministic.
//
// Out-of-range indices. The kernel never reads outside the stores: a pair
// with an index >= the store's row count is not read, and is counted in
// out[1]; the caller checks that word at its one readback and raises.
//
// Bound. The kernel must read its two index arrays (8 bytes a pair) and,
// at least once, every distinct store row the chunk names (4W bytes a
// row): it is bound by bytes over the card's 3.35 TB/s. For the com-youtube
// count at slice_bits = 64 that is about 42 MB of stores plus 120 MB of
// indices over the whole count; the gathered rows mostly hit the 50 MB L2.
// Its arithmetic (one AND, one popc and one add a word) is far below the
// card's integer rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <int W> struct Row;
template <> struct Row<1> { using T = uint32_t; };
template <> struct Row<2> { using T = uint2; };
template <> struct Row<4> { using T = uint4; };

__device__ __forceinline__ int and_popc(uint32_t a, uint32_t b) {
  return __popc(a & b);
}
__device__ __forceinline__ int and_popc(uint2 a, uint2 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y);
}
__device__ __forceinline__ int and_popc(uint4 a, uint4 b) {
  return __popc(a.x & b.x) + __popc(a.y & b.y) + __popc(a.z & b.z) +
         __popc(a.w & b.w);
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
                    const int32_t* __restrict__ ridx,
                    const int32_t* __restrict__ cidx, long long num_pairs,
                    int32_t* __restrict__ out) {
  int total = 0;
  int bad = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < num_pairs; p += stride) {
    const int r = __ldg(ridx + p);
    const int c = __ldg(cidx + p);
    const bool out_of_range = (r >= num_rows) | (c >= num_cols);
    bad += out_of_range;
    if (r >= 0 && c >= 0 && !out_of_range) {
      total += and_popc(__ldg(row + r), __ldg(col + c));
    }
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
void launch(const void* row, int num_rows, const void* col, int num_cols,
            const int32_t* ridx, const int32_t* cidx, long long num_pairs,
            int32_t* out, int blocks, cudaStream_t stream) {
  using T = typename Row<W>::T;
  gather_total_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(row), num_rows, static_cast<const T*>(col),
      num_cols, ridx, cidx, num_pairs, out);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). The caller validates shapes, types, alignment and devices.
extern "C" int tc_gather_total(const void* row, int num_rows, const void* col,
                               int num_cols, int words, const void* ridx,
                               const void* cidx, long long num_pairs, void* out,
                               void* stream) {
  if (num_pairs <= 0) return 0;
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
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
