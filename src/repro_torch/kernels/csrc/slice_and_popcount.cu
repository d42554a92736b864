// AND-popcount over pre-gathered slice words for Hopper (sm_90a): the
// unfused execute modes, whose gather runs before the kernel.
//
// Replaces the TPU kernels of src/repro/kernels/slice_and_popcount.py:
//
//   tc_total  <- `total_pallas` (body `_total_kernel`):
//                out[0] += sum over all words of popc(rows[i] & cols[i])
//   tc_items  <- `items_pallas` (body `_items_kernel`):
//                out[p]  = sum_w popc(rows[p][w] & cols[p][w])
//
// over gathered operands rows, cols of P pairs x W uint32 words (W = 1, 2
// or 4), which the executor's `gather_then_kernel` and `pallas_items` modes
// produce with a torch index_select.
//
// Design. The TPU total kernel reads a zero-padded (T, lanes) tiling of the
// flattened words and carries its sum in the output block across sequential
// grid steps. Neither the tiling nor the carry exists here: the total reads
// the flat word stream in a grid-stride loop with 16-byte loads (uint4,
// when both operands are 16-byte aligned, then the ragged words one at a
// time), reduces by warp shuffle and shared memory, and does one int32
// atomicAdd per block into the caller's accumulator word. The items kernel
// gives one thread to each pair: one vector load per row (uint32_t / uint2 /
// uint4 for W = 1 / 2 / 4), __popc, and one int32 store.
//
// Bound. Both are bound by bytes over the card's 3.35 TB/s: the total reads
// 8W bytes a pair and writes 4 bytes in all; items reads 8W and writes 4
// bytes a pair. Their arithmetic (one AND, one popc, one add a word) is far
// below the card's integer rate.

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

__global__ void __launch_bounds__(kThreads)
total_kernel(const uint32_t* __restrict__ rows, const uint32_t* __restrict__ cols,
             long long num_words, long long num_vec, int32_t* __restrict__ out) {
  int total = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const auto* rows4 = reinterpret_cast<const uint4*>(rows);
  const auto* cols4 = reinterpret_cast<const uint4*>(cols);
  for (long long i = first; i < num_vec; i += stride) {
    total += and_popc(__ldg(rows4 + i), __ldg(cols4 + i));
  }
  for (long long i = 4 * num_vec + first; i < num_words; i += stride) {
    total += and_popc(__ldg(rows + i), __ldg(cols + i));
  }
  total = warp_sum(total);

  __shared__ int s_total[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) s_total[warp] = total;
  __syncthreads();
  if (warp == 0) {
    total = lane < kThreads / 32 ? s_total[lane] : 0;
    total = warp_sum(total);
    if (lane == 0 && total) atomicAdd(out, total);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
items_kernel(const typename Row<W>::T* __restrict__ rows,
             const typename Row<W>::T* __restrict__ cols, long long num_pairs,
             int32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < num_pairs; p += stride) {
    out[p] = and_popc(__ldg(rows + p), __ldg(cols + p));
  }
}

// Blocks for `work` items: one per kThreads items, at most kBlocksPerSm a SM.
cudaError_t grid_blocks(long long work, int* blocks) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long needed = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  *blocks = static_cast<int>(needed < cap ? needed : cap);
  return cudaSuccess;
}

template <int W>
void launch_items(const void* rows, const void* cols, long long num_pairs,
                  int32_t* out, int blocks, cudaStream_t stream) {
  using T = typename Row<W>::T;
  items_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(rows), static_cast<const T*>(cols), num_pairs, out);
}

}  // namespace

// out[0] += total popcount(rows & cols) over `num_words` words, on `stream`.
// Returns cudaGetLastError() (0 on success). The caller validates shapes,
// types and devices; the 16-byte path is taken only when both operands are
// 16-byte aligned.
extern "C" int tc_total(const void* rows, const void* cols, long long num_words,
                        void* out, void* stream) {
  if (num_words <= 0) return 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(rows) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(cols) % 16 == 0);
  const long long num_vec = aligned ? num_words / 4 : 0;
  const long long work = num_vec + (num_words - 4 * num_vec);
  int blocks = 0;
  cudaError_t err = grid_blocks(work, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  total_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<const uint32_t*>(cols),
      num_words, num_vec, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out[p] = popcount(rows[p] & cols[p]) over `num_pairs` rows of `words`
// words, on `stream`. Returns cudaGetLastError() (0 on success).
extern "C" int tc_items(const void* rows, const void* cols, long long num_pairs,
                        int words, void* out, void* stream) {
  if (num_pairs <= 0) return 0;
  int blocks = 0;
  cudaError_t err = grid_blocks(num_pairs, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: launch_items<1>(rows, cols, num_pairs, o, blocks, s); break;
    case 2: launch_items<2>(rows, cols, num_pairs, o, blocks, s); break;
    case 4: launch_items<4>(rows, cols, num_pairs, o, blocks, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
