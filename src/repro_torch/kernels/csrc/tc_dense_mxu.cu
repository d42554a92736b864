// Masked dense A @ A triangle count for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel `dense_mxu_tc_pallas` (body `_dense_mxu_kernel`) of
// src/repro/kernels/tc_dense_mxu.py:
//
//   out[0] += sum_{i,j} A[i][j] * (A @ A)[i][j]
//
// for an [N, N] {0,1} matrix A in int8. With A the upper-triangular
// adjacency every triangle {a<b<c} counts once, at (a, c) through b. It is
// the `mxu` backend of tcim_count, the paper's matrix-multiplication
// comparison point.
//
// Design. The TPU kernel walks every (i, j, k) block of a grid with k
// innermost and carries the (i, j) tile of A @ A in VMEM. Here the work is
// cut to the blocks that can be non-zero, for any {0,1} input:
//
//   1. `dense_occupancy_kernel` reads A once and writes occ[ti][tk], whether
//      the 128 x 128 block A[ti-tile, tk-tile] holds a non-zero.
//   2. The wrapper (plain torch on the card, a few small ops) ranks the
//      output tiles: tile (i, j) is live when occ[i][j] and some k has
//      occ[i][k] and occ[k][j]; its work is the number of such k. Live tiles
//      are listed heaviest first.
//   3. `dense_mxu_kernel` is persistent: one block a SM takes the next live
//      tile from an atomic counter, so the triangle of tiles balances. Its
//      producer warp reads occ row i and column j, and keeps TMA loads of
//      A[i-tile, k-tile] and At[j-tile, k-tile] (At = A^T, so both operands
//      are K-major as int8 `wgmma` wants) in flight for the k with both
//      blocks non-zero, through a ring of 4 stages with full/empty
//      mbarriers, 128B-swizzled; it hands its registers to the consumers
//      with setmaxnreg. Two consumer warpgroups each own 64 rows of the
//      128 x 128 tile and run `wgmma.m64n128k32` s8 x s8 -> s32 with both
//      operands in shared memory, one group in flight. The epilogue
//      multiplies each accumulator by the mask A[i][j] (outside [N, N] it
//      reads nothing) and adds it to the thread's int64 total; at the end
//      each warp adds its total with one atomic. Integer adds commute, so
//      the result does not depend on the order of the tiles.
//
// For an upper-triangular A only the blocks with i <= k <= j survive, about
// a sixth of the dense N^3; a full {0,1} matrix still computes every block.
// An optional counter adds up the k steps computed, one atomic a block.
//
// Exactness. Each (A @ A)[i][j] is at most N in int32; sums are int64. The
// TPU kernel's f32 sum is exact only below 2^24.
//
// Bound. Operations: the products the function needs, 2 * #{(i, k, j):
// A[i][k] A[k][j] != 0} int8 operations at most; for a strictly
// upper-triangular A of full density that is N (N - 1) (N - 2) / 3, against
// the H100's 1,979 dense int8 TOP/s: 8.3 ms at N = 36,692. The bytes are N^2
// + 8 (A read once, the count written once), about 0.4 ms at 3.35 TB/s. A
// tile is computed whole, so the kernel does more operations than that
// count: 2 * 128^3 for every (i, k, j) block it keeps.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 128;           // output rows, output columns and K bytes of a block
constexpr int kStages = 4;
constexpr int kThreads = 384;        // producer warpgroup + 2 consumer warpgroups
constexpr int kEmptyArrivals = 8;    // one a consumer warp
constexpr int kOperandBytes = kTile * kTile;
constexpr int kEndTile = -1;         // stage meta: the tile's k steps are done
constexpr int kEndWork = -2;         // stage meta: no tile left
constexpr unsigned kFull = 0xffffffffu;

// Shared memory: the A and At stages, the stage metas (k or an end mark,
// and the tile's i and j), the barriers.
constexpr int kSmemA = 0;
constexpr int kSmemB = kSmemA + kStages * kOperandBytes;
constexpr int kSmemMeta = kSmemB + kStages * kOperandBytes;
constexpr int kSmemBars = kSmemMeta + kStages * 16;
constexpr int kSmemBytes = kSmemBars + 2 * kStages * 8 + 1024;  // + slack to align to 1024

// occ[ti * nt + tk] = any(A[ti-tile, tk-tile] != 0); 16-byte loads (the
// wrapper hands over a 16-byte-aligned A with a row stride `lda` a multiple
// of 16); bytes past column n are not read as data.
__global__ void __launch_bounds__(256)
dense_occupancy_kernel(const int8_t* __restrict__ a, long long lda, int n, int nt,
                       uint8_t* __restrict__ occ) {
  const int ti = blockIdx.y;
  const int tk = blockIdx.x;
  const int r = threadIdx.x >> 1;
  const int row = ti * kTile + r;
  const int c0 = tk * kTile + (threadIdx.x & 1) * 64;
  bool any = false;
  if (row < n) {
    const int8_t* p = a + row * lda + c0;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = c0 + 16 * v;
      if (c >= n) break;
      uint4 x = *reinterpret_cast<const uint4*>(p + 16 * v);
      if (c + 16 > n) {  // keep the first n - c bytes
        const int keep = n - c;
        uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int bytes = keep - 4 * i;
          w[i] = bytes >= 4 ? w[i] : (bytes <= 0 ? 0u : w[i] & ((1u << (8 * bytes)) - 1u));
        }
        x = make_uint4(w[0], w[1], w[2], w[3]);
      }
      any |= (x.x | x.y | x.z | x.w) != 0;
    }
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) occ[ti * nt + tk] = any;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
dense_mxu_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap atmap,
                 const int8_t* __restrict__ a, long long lda, int n, int nt,
                 const uint8_t* __restrict__ occ, const int* __restrict__ order,
                 const int* __restrict__ live, int* __restrict__ next,
                 unsigned long long* __restrict__ out, unsigned long long* __restrict__ steps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* s_a = smem + kSmemA;
  unsigned char* s_b = smem + kSmemB;
  int4* s_meta = reinterpret_cast<int4*>(smem + kSmemMeta);
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
  __syncthreads();

  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      prefetch_tensor_map(&amap);
      prefetch_tensor_map(&atmap);
    }
    const int n_live = *live;
    const int chunks = (nt + 31) / 32;
    int stage = 0;
    uint32_t phase = 0;
    unsigned long long done = 0;
    auto push = [&](int k, int i, int j) {
      mbar_wait(&empty[stage], phase ^ 1);
      if (lane == 0) {
        s_meta[stage] = make_int4(k, i, j, 0);
        if (k >= 0) {
          mbar_arrive_expect_tx(&full[stage], 2 * kOperandBytes);
          tma_load_2d(s_a + stage * kOperandBytes, &amap, &full[stage], k * kTile, i * kTile);
          tma_load_2d(s_b + stage * kOperandBytes, &atmap, &full[stage], k * kTile, j * kTile);
        } else {
          mbar_arrive(&full[stage]);
        }
      }
      __syncwarp();
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    while (true) {
      int t = 0;
      if (lane == 0) t = atomicAdd(next, 1);
      t = __shfl_sync(kFull, t, 0);
      if (t >= n_live) break;
      const int tile = order[t];
      const int i = tile / nt;
      const int j = tile % nt;
      // Bit c of `both`: k = 32 c + lane has A[i-tile, k-tile] and
      // A[k-tile, j-tile] non-zero (nt <= 1024, so c < 32: N <= 131,072).
      uint32_t both = 0;
#pragma unroll 4
      for (int c = 0; c < chunks; ++c) {
        const int k = 32 * c + lane;
        if (k < nt && (occ[i * nt + k] & occ[k * nt + j])) both |= 1u << c;
      }
      for (int c = 0; c < chunks; ++c) {
        uint32_t mask = __ballot_sync(kFull, (both >> c) & 1u);
        while (mask) {
          const int k = 32 * c + __ffs(mask) - 1;
          mask &= mask - 1;
          push(k, i, j);
          ++done;
        }
      }
      push(kEndTile, i, j);
    }
    push(kEndWork, 0, 0);
    if (lane == 0 && steps != nullptr) atomicAdd(steps, done);
  } else {
    // --------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) & 3;
    const int r_lo = wg * 64 + warp * 16 + (lane >> 2);  // rows r_lo and r_lo + 8 of the tile
    const int c_lo = 2 * (lane & 3);                     // columns 8 j + c_lo, + 1
    constexpr int kSbo = 8 * kTile;                      // bytes between 8-row groups
    int stage = 0;
    uint32_t phase = 0;
    long long total = 0;
    int acc[kTile / 2];
    while (true) {
      int prev = -1;
      int4 meta;
      while (true) {
        mbar_wait(&full[stage], phase);
        meta = s_meta[stage];
        if (meta.x < 0) break;
        const unsigned char* ta = s_a + stage * kOperandBytes + wg * 64 * kTile;
        const unsigned char* tb = s_b + stage * kOperandBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 32; ++kk) {
          wgmma_ss_s8_n128(acc, make_desc(ta + 32 * kk, 128, kSbo),
                           make_desc(tb + 32 * kk, 128, kSbo), prev >= 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) fence_reg(acc[i]);
      if (lane == 0) {
        if (prev >= 0) mbar_arrive(&empty[prev]);
        mbar_arrive(&empty[stage]);  // the end mark's stage
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      if (meta.x == kEndWork) break;
      if (prev < 0) continue;  // a tile with no k step (not listed by the wrapper)
      const int row0 = meta.y * kTile + r_lo;
      const int col0 = meta.z * kTile + c_lo;
#pragma unroll
      for (int jj = 0; jj < kTile / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + ((e >> 1) << 3);
          const int col = col0 + 8 * jj + (e & 1);
          if (row < n && col < n && a[row * lda + col]) total += acc[4 * jj + e];
        }
      }
    }
    total = warp_sum(total);
    if (lane == 0 && total != 0) atomicAdd(out, static_cast<unsigned long long>(total));
  }
}

int operand_map(CUtensorMap* map, const void* base, int n, long long ld) {
  const uint64_t dims[2] = {static_cast<uint64_t>(n), static_cast<uint64_t>(n)};
  const uint64_t strides[1] = {static_cast<uint64_t>(ld)};
  const uint32_t box[2] = {kTile, kTile};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// occ[ti * nt + tk] = any non-zero in the 128 x 128 block (ti, tk) of the
// [n, n] int8 `a` (row stride lda, a multiple of 16; 16-byte aligned),
// nt = ceil(n / 128). Returns cudaGetLastError().
extern "C" int tc_dense_occupancy(const void* a, long long lda, int n, void* occ, void* stream) {
  if (n <= 0) return 0;
  const int nt = (n + kTile - 1) / kTile;
  dense_occupancy_kernel<<<dim3(nt, nt), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), lda, n, nt, static_cast<uint8_t*>(occ));
  return static_cast<int>(cudaGetLastError());
}

// out[0] += sum_{i,j} a[i][j] * (a @ a)[i][j] over the live tiles:
// `order[0 .. *live)` lists tiles i * nt + j, `occ` is the occupancy of
// tc_dense_occupancy, `next` one zeroed int. a and at (its transpose) are
// [n, n] int8 with row stride lda (a multiple of 16, 16-byte aligned); out
// one int64; `steps`, if not null, gains the k steps computed. `blocks`
// persistent blocks. Returns 0, a CUDA error, or minus a driver error if a
// tensor map was refused.
extern "C" int tc_dense_mxu(const void* a, const void* at, long long lda, int n, const void* occ,
                            const void* order, const void* live, void* next, void* out,
                            void* steps, int blocks, void* stream) {
  if (n <= 0) return 0;
  CUtensorMap amap, atmap;
  int bad = operand_map(&amap, a, n, lda);
  if (!bad) bad = operand_map(&atmap, at, n, lda);
  if (bad) return -bad;
  cudaError_t err = cudaFuncSetAttribute(dense_mxu_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (n + kTile - 1) / kTile;
  dense_mxu_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      amap, atmap, static_cast<const int8_t*>(a), lda, n, nt, static_cast<const uint8_t*>(occ),
      static_cast<const int*>(order), static_cast<const int*>(live), static_cast<int*>(next),
      static_cast<unsigned long long*>(out), static_cast<unsigned long long*>(steps));
  return static_cast<int>(cudaGetLastError());
}
