// Fused gather-AND-popcount kernels for Hopper (sm_90a): the total of one
// work-list chunk, and the per-graph totals of a fused multi-graph batch.
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

//
// Segment totals. `tc_gather_segment_totals` replaces the TPU kernel
// `gather_segment_totals_pallas` (body `_gather_segment_kernel`) of the
// same file. The index arrays hold G back-to-back segments of `bucket`
// pairs (one graph each, `bucket` a power of two); it computes
//
//   out[g][0] += sum_{p in segment g} [r_p >= 0 && c_p >= 0] * popc(row[r_p] & col[c_p])
//   out[g][1] += #{p in segment g : r_p >= R || c_p >= C}
//
// The TPU kernel walks one pair per grid step and starts each output row on
// its segment's first step; that order does not exist on a GPU. Here each
// thread takes one pair, and the rule is that one atomic never adds pairs
// of two segments. Because `bucket` and the warp (32) are both powers of two
// and segments start at multiples of `bucket`:
//   * bucket < 32: segments tile a warp, so a shuffle reduction with
//     `width = bucket` sums each segment inside the warp and the segment's
//     first lane adds its sum;
//   * bucket >= 32: a warp lies inside one segment; warps are summed in
//     shared memory in groups of min(bucket / 32, 8) (a group lies inside
//     one segment too), and each group adds once.
// So a block does at most one atomic pair per segment it touches (one for
// bucket >= 256), and trailing all-sentinel segments add nothing. One
// thread per pair (not a grid-stride loop) keeps every pair's segment a
// function of its thread alone; a fused batch holds at most a few hundred
// thousand pairs, two waves of blocks on the card. Its bound is that of the
// total: the index arrays and the distinct rows they name, over 3.35 TB/s.

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

// Sum of v over the `width` lanes of each aligned group of a warp (width a
// power of two <= 32); lane % width == 0 holds its group's sum.
__device__ __forceinline__ int group_sum(int v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off, width);
  return v;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
gather_segment_kernel(const typename Row<W>::T* __restrict__ row, int num_rows,
                      const typename Row<W>::T* __restrict__ col, int num_cols,
                      const int32_t* __restrict__ ridx,
                      const int32_t* __restrict__ cidx, long long num_pairs,
                      long long bucket, int32_t* __restrict__ out) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  int total = 0;
  int bad = 0;
  if (p < num_pairs) {
    const int r = __ldg(ridx + p);
    const int c = __ldg(cidx + p);
    const bool out_of_range = (r >= num_rows) | (c >= num_cols);
    bad = out_of_range;
    if (r >= 0 && c >= 0 && !out_of_range) {
      total = and_popc(__ldg(row + r), __ldg(col + c));
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int width = bucket < 32 ? static_cast<int>(bucket) : 32;
  total = group_sum(total, width);
  bad = group_sum(bad, width);
  if (bucket <= 32) {
    if (lane % width == 0 && p < num_pairs && (total | bad)) {
      int32_t* o = out + 2 * (p / bucket);
      if (total) atomicAdd(o, total);
      if (bad) atomicAdd(o + 1, bad);
    }
    return;
  }
  // bucket > 32: combine the warps of each segment in shared memory.
  __shared__ int s_total[kThreads / 32];
  __shared__ int s_bad[kThreads / 32];
  if (lane == 0) {
    s_total[warp] = total;
    s_bad[warp] = bad;
  }
  __syncthreads();
  const long long seg_warps = bucket / 32;
  const int group = seg_warps < kThreads / 32 ? static_cast<int>(seg_warps) : kThreads / 32;
  const int t = threadIdx.x;
  if (t < kThreads / 32 && t % group == 0) {
    const long long first = (long long)blockIdx.x * kThreads + 32LL * t;
    if (first < num_pairs) {
      int sum_total = 0;
      int sum_bad = 0;
      for (int k = 0; k < group; ++k) {
        sum_total += s_total[t + k];
        sum_bad += s_bad[t + k];
      }
      int32_t* o = out + 2 * (first / bucket);
      if (sum_total) atomicAdd(o, sum_total);
      if (sum_bad) atomicAdd(o + 1, sum_bad);
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


namespace {

template <int W>
void launch_segments(const void* row, int num_rows, const void* col,
                     int num_cols, const int32_t* ridx, const int32_t* cidx,
                     long long num_pairs, long long bucket, int32_t* out,
                     long long blocks, cudaStream_t stream) {
  using T = typename Row<W>::T;
  gather_segment_kernel<W><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(row), num_rows, static_cast<const T*>(col),
      num_cols, ridx, cidx, num_pairs, bucket, out);
}

}  // namespace

// Launches the segment kernel on `stream`: `num_pairs` = G * `bucket` pairs,
// `out` the caller's zeroed int32 [G][2]. Returns cudaGetLastError() (0 on
// success). The caller validates shapes, types, alignment and devices.
extern "C" int tc_gather_segment_totals(const void* row, int num_rows,
                                        const void* col, int num_cols,
                                        int words, const void* ridx,
                                        const void* cidx, long long num_pairs,
                                        long long bucket, void* out,
                                        void* stream) {
  if (num_pairs <= 0) return 0;
  if (bucket < 1 || (bucket & (bucket - 1)) || num_pairs % bucket)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (num_pairs + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ri = static_cast<const int32_t*>(ridx);
  const auto* ci = static_cast<const int32_t*>(cidx);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: launch_segments<1>(row, num_rows, col, num_cols, ri, ci, num_pairs, bucket, o, blocks, s); break;
    case 2: launch_segments<2>(row, num_rows, col, num_cols, ri, ci, num_pairs, bucket, o, blocks, s); break;
    case 4: launch_segments<4>(row, num_rows, col, num_cols, ri, ci, num_pairs, bucket, o, blocks, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
