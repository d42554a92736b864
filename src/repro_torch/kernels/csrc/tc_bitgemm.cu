// Popcount-GEMM for Hopper (sm_90a) on the tensor cores:
//
//   C[i][j] = sum_w popc(X[i][w] & Y[j][w])
//
// Replaces the TPU kernel `bitgemm_pallas` (body `_bitgemm_kernel`) of
// src/repro/kernels/tc_bitgemm.py: X is [I, W] and Y is [J, W] uint32 words
// (bit-packed rows of the adjacency and of its transpose), C is [I, J]
// int32. It is the `bitgemm` backend of tcim_count, Eq. 5 evaluated densely.
//
// Design. The single-bit warpgroup MMA, `wgmma.m64n256k256.s32.b1.b1.and.popc`,
// ANDs 256 bits of each of 64 X rows with 256 bits of each of 256 Y rows and
// adds the popcounts to int32 accumulators: the whole function, on the tensor
// cores. A k step is 32 bytes of each row, as s8's k32 step, so the tiles are
// laid out as for int8 `wgmma` (tc_dense_mxu.cu): both operands K-major (X
// and Y are already), 128-byte rows swizzled by TMA.
//
//   * Persistent, in clusters of 2 CTAs, one CTA a SM. A cluster walks units
//     of 2 row tiles (128 X rows each) by one column tile (256 Y rows), unit
//     blockIdx.x / 2, then + gridDim.x / 2, ...; each CTA computes one of the
//     two output tiles. Every unit does the same work, so a static walk
//     balances. Units come in groups of 16 row tiles (2,048 X rows): inside
//     a group the units of one Y panel follow each other, so the clusters
//     running at once read about 8 Y panels and the group's X rows, which
//     stay in L2 while Y, larger than L2 at email-enron (168 MB), streams
//     from device memory once a group.
//   * One producer thread a CTA keeps TMA loads in flight on a ring of 4
//     stages of 32 words a row (48 KB) with full/empty mbarriers: its 128 X
//     rows, and half of the 256 Y rows, multicast into the same stage of
//     both CTAs, so L2 serves each Y stage once for two tiles. A stage is
//     refilled when the consumers of both CTAs have released it (remote
//     mbarrier arrivals). Its warpgroup hands its registers to the consumers
//     (setmaxnreg). TMA reads the operands as [rows, W] with their own row
//     stride (a multiple of 16 bytes) and fills the words past W, and the
//     rows past I or J, with zeros, which add nothing to a count: ragged I,
//     J and W need no padding and no masking in the main loop.
//   * Two consumer warpgroups each own 64 X rows of the tile and hold its
//     64 x 256 int32 sums in registers (128 a thread). A stage is four MMAs,
//     one group in flight; the stage before is released when it is done.
//   * The epilogue stores the sums straight from registers, masked at I and
//     J, while the producer already loads the next tile's stages. Lane pairs
//     swap halves of their accumulator fragments so that each thread stores
//     four adjacent columns as one 16-byte vector: every store fills whole
//     32-byte sectors.
//
// Exactness. Each entry is at most 32 W, so int32 holds it for any W < 2^26;
// the wrapper rejects wider operands.
//
// Bound. Operations. The function is I * J * 32W one-bit products (AND,
// popcount, add), 2 I J 32W operations. NVIDIA publishes no single-bit rate
// for H100. The b1 MMA's k step holds 256 products a row pair in the 32
// bytes that hold 32 at int8, and a register-only probe of both
// (tools/kernel_levers.py) runs b1 at 7.97 x the 1,979 TOP/s int8 table
// rate, so the bound takes 8 x that rate: one email-enron chunk (I = 2048,
// J = 36692, W = 1147: 5.52e12 operations) takes at least 0.35 ms, while it
// moves 478 MB (X, Y read once, C written once), 0.14 ms at 3.35 TB/s. At
// the int8 rate it would be 2.79 ms, which this kernel beats. The earlier
// CUDA-core kernel of this file (one __popc a word pair, 64 x 64 tiles) was
// bound by the popcount unit, 16 a clock a SM: 20.6 ms for the chunk, of
// which it reached 93 %.
//
// What the design does about the bound: the products run on the tensor
// cores at the b1 rate, so what is left is feeding them and writing C.
// tools/kernel_levers.py times each choice at the email-enron chunk on an
// H100: the b1 `wgmma` beats `mma.sync` b1 and s8 `wgmma` on expanded bits;
// walking the tiles in groups keeps Y from streaming once a row tile; the
// 16-byte epilogue stores are the largest single gain over 4-byte ones (C
// is 300 MB, 63 % of the bytes); the multicast adds a few per cent.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRowsX = 128;        // X rows of an output tile: two consumer warpgroups of 64
constexpr int kRowsY = 256;        // Y rows (output columns) of a tile: the MMA's N
constexpr int kStageWords = 32;    // words of each row a stage: 128 bytes, four 256-bit k steps
constexpr int kStages = 4;
constexpr int kCluster = 2;        // CTAs of a cluster: row tiles that share each Y stage
constexpr int kGroup = 16;         // row tiles walked together (tile_at), a multiple of kCluster
constexpr int kThreads = 384;      // producer warpgroup + 2 consumer warpgroups
constexpr int kEmptyArrivals = 8 * kCluster;  // one a consumer warp of each CTA of the cluster
constexpr int kXBytes = kRowsX * kStageWords * 4;
constexpr int kYBytes = kRowsY * kStageWords * 4;
constexpr int kYPart = kRowsY / kCluster;  // Y rows each CTA loads for the whole cluster
constexpr uint32_t kSbo = 8 * kStageWords * 4;  // bytes between 8-row groups of a stage

// Shared memory: the X and Y stages, the barriers.
constexpr int kSmemX = 0;
constexpr int kSmemY = kSmemX + kStages * kXBytes;
constexpr int kSmemBars = kSmemY + kStages * kYBytes;
constexpr int kSmemBytes = kSmemBars + 2 * kStages * 8 + 1024;  // + slack to align to 1024

struct Tile {
  int i;  // row tile: X rows i * kRowsX ..
  int j;  // column tile: Y rows j * kRowsY ..
};

// The t-th unit of the walk (kCluster row tiles, unit i, by column tile j):
// groups of kGroup row tiles, and inside a group column tile after column
// tile, each down the group's units.
__device__ __forceinline__ Tile tile_at(long long t, int units_i, int tiles_j) {
  constexpr int kGroupUnits = kGroup / kCluster;
  const long long per_group = static_cast<long long>(kGroupUnits) * tiles_j;
  const int g = static_cast<int>(t / per_group);
  const int first = g * kGroupUnits;
  const int rows = min(kGroupUnits, units_i - first);
  const long long local = t - g * per_group;
  return {first + static_cast<int>(local % rows), static_cast<int>(local / rows)};
}

// acc (+)= one stage's products: the warpgroup's 64 X rows against the 256 Y
// rows, four 256-bit k steps of AND and popcount; acc is overwritten first
// unless `accumulate`. Leaves one wgmma group in flight.
__device__ __forceinline__ void stage_products(int (&acc)[kRowsY / 2], const unsigned char* tx,
                                               const unsigned char* ty, bool accumulate) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss_b1_n256(acc, make_desc(tx + 32 * kk, 128, kSbo), make_desc(ty + 32 * kk, 128, kSbo),
                     accumulate || kk > 0);
  }
  wgmma_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
bitgemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
               int rows_i, int rows_j, int words, int32_t* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* s_x = smem + kSmemX;
  unsigned char* s_y = smem + kSmemY;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSmemBars);
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kEmptyArrivals);
    }
    mbar_init_fence();
  }
  cluster_sync();  // the barriers of every CTA are ready before any copy or arrival

  const uint32_t rank = cluster_ctarank();
  const int tiles_i = (rows_i + kRowsX - 1) / kRowsX;
  const int tiles_j = (rows_j + kRowsY - 1) / kRowsY;
  const int units_i = (tiles_i + kCluster - 1) / kCluster;
  const long long units = static_cast<long long>(units_i) * tiles_j;
  const long long clusters = gridDim.x / kCluster;
  const int ksteps = (words + kStageWords - 1) / kStageWords;  // 0 when W = 0: C is zeros
  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x != 0 || ksteps == 0) return;
    prefetch_tensor_map(&xmap);
    prefetch_tensor_map(&ymap);
    int stage = 0;
    uint32_t phase = 0;
    auto advance = [&] {
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    for (long long u = blockIdx.x / kCluster; u < units; u += clusters) {
      const Tile unit = tile_at(u, units_i, tiles_j);
      const int row_x = (unit.i * kCluster + rank) * kRowsX;
      const int row_y = unit.j * kRowsY + rank * kYPart;
      for (int k = 0; k < ksteps; ++k) {
        // Free in every CTA of the cluster: this CTA's part of Y lands in all.
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], kXBytes + kYBytes);
        tma_load_2d(s_x + stage * kXBytes, &xmap, &full[stage], k * kStageWords, row_x);
        tma_load_2d_multicast(s_y + stage * kYBytes + rank * kYPart * kStageWords * 4, &ymap,
                              &full[stage], k * kStageWords, row_y, (1u << kCluster) - 1);
        advance();
      }
    }
    // Stay until the cluster's consumers have released every stage: their
    // arrivals on this CTA's barriers land before it exits.
    for (int s = 0; s < kStages; ++s) {
      mbar_wait(&empty[stage], phase ^ 1);
      advance();
    }
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int lane = threadIdx.x & 31;
    const int r_lo = wg * 64 + warp * 16 + (lane >> 2);  // rows r_lo and r_lo + 8 of the tile
    const bool vec = rows_j % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    int stage = 0;
    uint32_t phase = 0;
    int acc[kRowsY / 2];
    auto release = [&](int s) {  // in every CTA of the cluster, one arrival a warp
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kCluster; ++c) mbar_arrive_cluster(&empty[s], c);
      }
    };
    for (long long u = blockIdx.x / kCluster; u < units; u += clusters) {
      const Tile unit = tile_at(u, units_i, tiles_j);
      const Tile tile = {static_cast<int>(unit.i * kCluster + rank), unit.j};
      int prev = -1;
      for (int k = 0; k < ksteps; ++k) {
        mbar_wait(&full[stage], phase);
        stage_products(acc, s_x + stage * kXBytes + wg * 64 * kStageWords * 4,
                       s_y + stage * kYBytes, k > 0);
        wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0) release(prev);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < kRowsY / 2; ++e) fence_reg(acc[e]);
      if (prev >= 0) release(prev);
      if (ksteps == 0) {
#pragma unroll
        for (int e = 0; e < kRowsY / 2; ++e) acc[e] = 0;
      }
      // Lane pairs swap halves: the even lane then holds four adjacent
      // columns of row r_lo, the odd lane those of row r_lo + 8, stored as
      // one 16-byte vector where C's rows allow it.
      const bool odd = lane & 1;
      const int row = tile.i * kRowsX + r_lo + (odd ? 8 : 0);
      int32_t* dst = out + static_cast<long long>(row) * rows_j;
#pragma unroll
      for (int jj = 0; jj < kRowsY / 8; ++jj) {
        const int a0 = acc[4 * jj], a1 = acc[4 * jj + 1], a2 = acc[4 * jj + 2], a3 = acc[4 * jj + 3];
        const int r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : a2, 1);
        const int r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : a3, 1);
        const int4 v = odd ? make_int4(r0, r1, a2, a3) : make_int4(a0, a1, r0, r1);
        const int col = tile.j * kRowsY + 8 * jj + 4 * ((lane & 3) >> 1);
        if (row >= rows_i) continue;
        if (vec && col + 3 < rows_j) {
          *reinterpret_cast<int4*>(dst + col) = v;
        } else {
          if (col < rows_j) dst[col] = v.x;
          if (col + 1 < rows_j) dst[col + 1] = v.y;
          if (col + 2 < rows_j) dst[col + 2] = v.z;
          if (col + 3 < rows_j) dst[col + 3] = v.w;
        }
      }
    }
  }
}

// A [rows, words] uint32 operand with row stride `ld` words, read in boxes
// of kStageWords words by `box_rows` rows, 128-byte swizzled.
int operand_map(CUtensorMap* map, const void* base, int rows, int words, long long ld,
                int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(words), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(ld) * 4};
  const uint32_t box[2] = {kStageWords, static_cast<uint32_t>(box_rows)};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, base, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// Clusters of the kernel resident at once on the current device, 0 if it
// cannot launch there; the shared-memory attribute is set once, on the
// device's first launch.
int resident_clusters(cudaLaunchConfig_t config) {
  constexpr int kMaxDevices = 64;
  static int fit_by_device[kMaxDevices] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= kMaxDevices) return 0;
  if (fit_by_device[device] > 0) return fit_by_device[device];
  if (cudaFuncSetAttribute(bitgemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes) != cudaSuccess)
    return 0;
  int fit = 0;
  if (cudaOccupancyMaxActiveClusters(&fit, bitgemm_kernel, &config) != cudaSuccess) return 0;
  fit_by_device[device] = fit;
  return fit;
}

}  // namespace

// out[i][j] = sum_w popc(x[i][w] & y[j][w]) for x [rows_i, words] and
// y [rows_j, words] uint32 with row strides ldx and ldy words (multiples of
// 4, 16-byte aligned), out [rows_i, rows_j] int32 contiguous, on `stream`,
// with as many persistent clusters as are resident at once. Returns 0, a
// CUDA error, or minus a driver error if a tensor map was refused. The
// caller validates shapes, types and devices.
extern "C" int tc_bitgemm(const void* x, long long ldx, const void* y, long long ldy, int rows_i,
                          int rows_j, int words, void* out, void* stream) {
  if (rows_i <= 0 || rows_j <= 0) return 0;
  CUtensorMap xmap{}, ymap{};  // not read when words == 0
  if (words > 0) {
    int bad = operand_map(&xmap, x, rows_i, words, ldx, kRowsX);
    if (!bad) bad = operand_map(&ymap, y, rows_j, words, ldy, kYPart);
    if (bad) return -bad;
  }
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kCluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kSmemBytes;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = cluster;
  config.numAttrs = 1;
  const int fit = resident_clusters(config);
  if (fit < 1) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  const long long units = static_cast<long long>(
      ((rows_i + kRowsX - 1) / kRowsX + kCluster - 1) / kCluster) * ((rows_j + kRowsY - 1) / kRowsY);
  const long long clusters = units < fit ? units : fit;
  config.gridDim = dim3(static_cast<unsigned>(clusters * kCluster));
  const cudaError_t err = cudaLaunchKernelEx(&config, bitgemm_kernel, xmap, ymap, rows_i, rows_j,
                                             words, static_cast<int32_t*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
