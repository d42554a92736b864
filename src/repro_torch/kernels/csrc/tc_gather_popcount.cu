// Fused gather-AND-popcount kernels for Hopper (sm_90a): the total of one
// work-list chunk, and the per-graph totals of the fused multi-graph
// batches of a serve wave.
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
// and in no order, so nothing carries over. Every pair is a chain of
// dependent loads (its two indices, then its two store rows), and what
// sets the time is the gathers' traffic between L2 and the SMs: a gather
// of 4W bytes moves a 32-byte sector. The work list names each row in a
// run of neighbouring pairs, so neighbouring lanes must take neighbouring
// pairs for one warp's row gathers to share sectors. A round of the
// grid-stride loop therefore covers 4 x (grid threads) pairs, lane-adjacent
// pairs on adjacent lanes, four pairs a thread: the thread loads its eight
// indices (four coalesced warp loads a side), then issues all eight row
// gathers (one vector load a row: uint32_t / uint2 / uint4 for W = 1 / 2 /
// 4) before any of them is used; AND and __popc follow. The next round's
// indices are loaded before this round's gathers (software pipelining),
// and the grid is at most four blocks an SM, so a chunk of 1<<20 pairs is
// two rounds. The index stream is read once, so it is loaded with the
// evict-first hint (`__ldcs`) and leaves L2 to the store rows. Index views
// may start at any offset and P may be anything: every load is a scalar
// one, and nothing is read past P. (Four consecutive pairs a thread
// through one 16-byte index load a side put four pairs between
// neighbouring lanes: a fifth slower on an H100 at com-youtube's chunks,
// tools/kernel_levers.py `gather`.) Negative indices (the executor's -1
// padding) count zero. Threads reduce by warp shuffle, then across warps
// in shared memory, and each block does one int32 atomicAdd pair into
// `out`, the caller's carried accumulator: integer adds are exact in any
// order, so the result is deterministic.
//
// Out-of-range indices. The kernel never reads outside the stores: a pair
// with an index >= the store's row count is not read, and is counted in
// out[1]; the caller checks that word at its one readback and raises.
//
// Bound. The kernel must read its two index arrays (8 bytes a pair) and,
// at least once, every distinct store row the chunk names (4W bytes a
// row): it is bound by bytes over the card's 3.35 TB/s. Its arithmetic
// (one AND, one popc and one add a word) is far below the integer rate.
//
// Segment totals. `tc_gather_segment_groups` replaces the TPU kernel
// `gather_segment_totals_pallas` (body `_gather_segment_kernel`) of the
// same file. A batch's index arrays hold G back-to-back segments of
// `bucket` pairs (one graph each, `bucket` a power of two); it computes
//
//   out[g][0] += sum_{p in segment g} [r_p >= 0 && c_p >= 0] * popc(row[r_p] & col[c_p])
//   out[g][1] += #{p in segment g : r_p >= R || c_p >= C}
//
// A serve wave holds tens of such batches, each a few hundred to a few
// hundred thousand pairs: one launch a batch would spend more time
// launching than gathering. So one launch covers up to kGroupCap batches.
// Their table (stores, row counts, W, index arrays, pair count, bucket,
// first output row and first block of each) is the kernel's parameter,
// passed by value as a __grid_constant__ (up to 32,764 bytes of parameters
// from CUDA 12.1 on sm_70+): nothing is uploaded for it. Each block finds
// its batch by a binary search over the first-block column (uniform across
// the block; a batch with no pairs owns no block) and switches on the
// batch's W into the templated body. Blocks never straddle batches: each
// batch starts at its own block 0, so its segments tile its blocks as in a
// launch of its own. The TPU kernel walks one pair per grid step and
// starts each output row on its segment's first step; that order does not
// exist on a GPU. Here each thread takes one pair, and the rule is that one
// atomic never adds pairs of two segments. Because `bucket` and the warp
// (32) are both powers of two and segments start at multiples of `bucket`:
//   * bucket < 32: segments tile a warp, so a shuffle reduction with
//     `width = bucket` sums each segment inside the warp and the segment's
//     first lane adds its sum;
//   * bucket >= 32: a warp lies inside one segment; warps are summed in
//     shared memory in groups of min(bucket / 32, 8) (a group lies inside
//     one segment too), and each group adds once.
// So a block does at most one atomic pair per segment it touches (one for
// bucket >= 256), and trailing all-sentinel segments add nothing. Its bound
// is that of the total: the index arrays and the distinct rows they name,
// over 3.35 TB/s.

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;   // gather_total's grid: two rounds at 1<<20 pairs
constexpr int kMaxDevices = 64;
constexpr int kGroupCap = 128;    // batches one segment launch takes
// Design levers, each timed against its absence by tools/kernel_levers.py.
constexpr bool kStreamingIndices = true;  // index loads evict-first (__ldcs)
constexpr bool kPipelined = true;         // next round's indices before this round's gathers

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

template <typename T>
__device__ __forceinline__ T load_index(const T* p) {
  if constexpr (kStreamingIndices) return __ldcs(p);
  return __ldg(p);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Four pairs: every gather issued before any is used.
template <int W>
__device__ __forceinline__ void four_pairs(const typename Row<W>::T* __restrict__ row,
                                           int num_rows,
                                           const typename Row<W>::T* __restrict__ col,
                                           int num_cols, const int (&r)[4],
                                           const int (&c)[4], int& total, int& bad) {
  using T = typename Row<W>::T;
  T a[4], b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool out_of_range = (r[k] >= num_rows) | (c[k] >= num_cols);
    bad += out_of_range;
    a[k] = T{};
    b[k] = T{};
    if (r[k] >= 0 && c[k] >= 0 && !out_of_range) {
      a[k] = __ldg(row + r[k]);
      b[k] = __ldg(col + c[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) total += and_popc(a[k], b[k]);
}

// The indices of this thread's four pairs in the round of 4 x `threads`
// pairs from `base`: pair k is base + tid + k * threads, so lanes sit on
// neighbouring pairs.
__device__ __forceinline__ void load_round(const int32_t* __restrict__ ridx,
                                           const int32_t* __restrict__ cidx, long long base,
                                           long long num_pairs, long long tid,
                                           long long threads, int (&r)[4], int (&c)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long q = base + tid + k * threads;
    r[k] = q < num_pairs ? load_index(ridx + q) : -1;
    c[k] = q < num_pairs ? load_index(cidx + q) : -1;
  }
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
  const long long threads = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  int rn[4], cn[4];
  load_round(ridx, cidx, 0, num_pairs, tid, threads, rn, cn);
  for (long long base = 0; base < num_pairs; base += 4 * threads) {
    const int r[4] = {rn[0], rn[1], rn[2], rn[3]};
    const int c[4] = {cn[0], cn[1], cn[2], cn[3]};
    const long long next = base + 4 * threads;
    if (kPipelined && next < num_pairs)
      load_round(ridx, cidx, next, num_pairs, tid, threads, rn, cn);
    four_pairs<W>(row, num_rows, col, num_cols, r, c, total, bad);
    if (!kPipelined && next < num_pairs)
      load_round(ridx, cidx, next, num_pairs, tid, threads, rn, cn);
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

// One batch of a grouped launch. The Python packing
// (kernels/tc_gather_popcount.py::_TABLE) mirrors this layout, and
// tc_segment_table_layout reports it so that the two are checked equal.
struct SegEntry {
  const void* row;       // stacked row store [num_rows, words]
  const void* col;       // stacked col store [num_cols, words]
  const int32_t* ridx;   // [num_pairs] store-global row positions
  const int32_t* cidx;   // [num_pairs]
  long long out_row;     // first [subtotal, out_of_range] row in the launch's out
  long long num_pairs;   // G * bucket
  int num_rows;
  int num_cols;
  int words;             // 1, 2 or 4
  int log2_bucket;
};

struct SegTable {
  SegEntry e[kGroupCap];
  int first_block[kGroupCap + 1];  // entry k owns blocks first_block[k] .. first_block[k+1]-1
  int count;
};

static_assert(sizeof(SegEntry) == 64, "SegEntry layout");
static_assert(sizeof(SegTable) <= 32764, "SegTable exceeds the kernel parameter limit");

// One block of a batch: pairs block_first .. block_first + kThreads - 1.
template <int W>
__device__ __forceinline__ void segment_block(const SegEntry& e, long long block_first,
                                              int32_t* __restrict__ out) {
  using T = typename Row<W>::T;
  const T* __restrict__ row = static_cast<const T*>(e.row);
  const T* __restrict__ col = static_cast<const T*>(e.col);
  const long long num_pairs = e.num_pairs;
  const long long bucket = 1LL << e.log2_bucket;
  const long long p = block_first + threadIdx.x;
  int total = 0;
  int bad = 0;
  if (p < num_pairs) {
    const int r = __ldg(e.ridx + p);
    const int c = __ldg(e.cidx + p);
    const bool out_of_range = (r >= e.num_rows) | (c >= e.num_cols);
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
      int32_t* o = out + 2 * (p >> e.log2_bucket);
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
    const long long first = block_first + 32LL * t;
    if (first < num_pairs) {
      int sum_total = 0;
      int sum_bad = 0;
      for (int k = 0; k < group; ++k) {
        sum_total += s_total[t + k];
        sum_bad += s_bad[t + k];
      }
      int32_t* o = out + 2 * (first >> e.log2_bucket);
      if (sum_total) atomicAdd(o, sum_total);
      if (sum_bad) atomicAdd(o + 1, sum_bad);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gather_segment_groups_kernel(const __grid_constant__ SegTable t, int32_t* __restrict__ out) {
  // This block's batch: the last entry whose first block is <= blockIdx.x.
  // A batch with no pairs shares its first block with the next entry, so
  // the search passes over it.
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0;
  int hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_block[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  const SegEntry& e = t.e[lo];
  const long long block_first = static_cast<long long>(b - t.first_block[lo]) * kThreads;
  int32_t* o = out + 2 * e.out_row;
  switch (e.words) {  // uniform across the block
    case 1: segment_block<1>(e, block_first, o); break;
    case 2: segment_block<2>(e, block_first, o); break;
    case 4: segment_block<4>(e, block_first, o); break;
    default: break;  // refused by the host entry before launch
  }
}

template <int W>
void launch_total(const void* row, int num_rows, const void* col, int num_cols,
                  const int32_t* ridx, const int32_t* cidx, long long num_pairs,
                  int32_t* out, int blocks, cudaStream_t stream) {
  using T = typename Row<W>::T;
  gather_total_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(row), num_rows, static_cast<const T*>(col), num_cols, ridx, cidx,
      num_pairs, out);
}

// The SM count of each device, queried on its first launch only.
std::atomic<int> g_sms[kMaxDevices];

int sm_count(int device) {
  if (device < 0 || device >= kMaxDevices) return -1;
  int sms = g_sms[device].load(std::memory_order_relaxed);
  if (sms > 0) return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  g_sms[device].store(sms, std::memory_order_relaxed);
  return sms;
}

}  // namespace

// Launches the total kernel on `stream` of card `device` (the caller's
// current device) and returns cudaGetLastError() (0 on success). The caller
// validates shapes, types, store alignment and devices; the index arrays
// may start at any 4-byte offset.
extern "C" int tc_gather_total(const void* row, int num_rows, const void* col,
                               int num_cols, int words, const void* ridx,
                               const void* cidx, long long num_pairs, void* out,
                               int device, void* stream) {
  if (num_pairs <= 0) return 0;
  const int sms = sm_count(device);
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long needed = (num_pairs + 4 * kThreads - 1) / (4 * kThreads);
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(needed < cap ? needed : cap);
  const auto* ri = static_cast<const int32_t*>(ridx);
  const auto* ci = static_cast<const int32_t*>(cidx);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (words) {
    case 1: launch_total<1>(row, num_rows, col, num_cols, ri, ci, num_pairs, o, blocks, s); break;
    case 2: launch_total<2>(row, num_rows, col, num_cols, ri, ci, num_pairs, o, blocks, s); break;
    case 4: launch_total<4>(row, num_rows, col, num_cols, ri, ci, num_pairs, o, blocks, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the grouped segment kernel on `stream` over a packed SegTable
// (host memory; copied into the launch's parameters). `out` is the caller's
// zeroed int32 [sum of G, 2]. Refuses a table whose entries disagree with
// their first blocks, W or bucket. Returns cudaGetLastError() (0 on
// success). The caller validates tensors, types, alignment and devices.
extern "C" int tc_gather_segment_groups(const void* table, void* out, void* stream) {
  const SegTable& t = *static_cast<const SegTable*>(table);
  if (t.count < 1 || t.count > kGroupCap || t.first_block[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < t.count; ++k) {
    const SegEntry& e = t.e[k];
    const long long blocks = (e.num_pairs + kThreads - 1) / kThreads;
    if ((e.words != 1 && e.words != 2 && e.words != 4) || e.log2_bucket < 0 ||
        e.log2_bucket > 30 || e.num_pairs < 0 || e.num_pairs % (1LL << e.log2_bucket) ||
        e.out_row < 0 || t.first_block[k + 1] - static_cast<long long>(t.first_block[k]) != blocks)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = t.first_block[t.count];
  if (blocks <= 0) return 0;
  gather_segment_groups_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The SegTable layout as this compiler laid it out: {sizeof(SegTable),
// sizeof(SegEntry), kGroupCap, offsetof first_block, offsetof count}.
extern "C" void tc_segment_table_layout(long long* layout) {
  layout[0] = sizeof(SegTable);
  layout[1] = sizeof(SegEntry);
  layout[2] = kGroupCap;
  layout[3] = offsetof(SegTable, first_block);
  layout[4] = offsetof(SegTable, count);
}
