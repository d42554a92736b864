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
// Design. The TPU kernel walks an (i, j, k) grid with k innermost, carries
// the (i, j) tile of A @ A in VMEM scratch, and on the last k step folds the
// masked tile sum into one f32 scalar, which it rounds. Here one block owns
// one 128 x 128 output tile for its whole K loop, so A @ A never reaches
// device memory: 8 warps, each a 64 x 32 sub-tile of 4 x 4 `mma.sync
// m16n8k32` int8 products with int32 accumulators in registers. Each step
// stages A[i0:i0+128, k0:k0+64] and At[j0:j0+128, k0:k0+64] (At = A^T, made
// by the wrapper, so both operands are K-contiguous as the MMA's row.col
// layout wants) in shared memory, with rows padded to 80 bytes so the
// fragment loads (8 rows x 4 words a warp) hit 32 distinct banks. Global
// loads are 16, 4 or 1 bytes wide, whichever N and the operands' alignment
// allow; ragged rows and K stage as 0. In the epilogue each thread
// multiplies its accumulators by the mask A[i][j] (outside [N, N] it reads
// nothing), sums in int64, the block reduces by warp shuffle and shared
// memory, and one atomicAdd on an unsigned long long adds the tile. Integer
// adds commute, so the result does not depend on the order of the blocks.
//
// Exactness. Each (A @ A)[i][j] is at most N in int32; a tile's masked sum
// can pass 2^31 (128 * 128 * N), so it is reduced in int64. The TPU
// kernel's f32 sum is exact only below 2^24.
//
// Bound. Operations: 2 N^3 int8 operations (N^3 multiply-adds) against the
// H100's 1,979 dense int8 TOP/s, about 50 ms at N = 36,692 (email-enron).
// The bytes are N^2 + 8 (A read once, the count written once), about
// 0.4 ms at 3.35 TB/s; the wrapper's transpose adds 2 N^2 more. This
// simple kernel stages with plain loads and one buffer; cp.async or TMA
// pipelining and `wgmma` are later work. It computes the function for any
// {0,1} input: it does not skip the all-zero tiles below the diagonal of an
// upper-triangular A.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 128;          // output rows of a block
constexpr int kTileN = 128;          // output columns of a block
constexpr int kBK = 64;              // K bytes staged a step (two k32 MMAs)
constexpr int kLd = kBK + 16;        // padded smem row, bytes
constexpr int kThreads = 256;        // 8 warps: 2 along M x 4 along N
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMi = kWarpM / 16;     // m16 tiles a warp
constexpr int kNi = kWarpN / 8;      // n8 tiles a warp

template <int VEC> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<1> { using T = uint8_t; };

// Copy rows [r0, r0 + 128) x bytes [k0, k0 + 64) of the [n, n] int8 `src`
// into `dst`, zero outside the matrix. VEC divides n and the pointer's
// alignment, so a vector starting inside a row lies wholly inside it.
template <int VEC>
__device__ __forceinline__ void stage(const int8_t* __restrict__ src, int n, int r0,
                                      int k0, uint8_t (*dst)[kLd]) {
  using T = typename Vec<VEC>::T;
  constexpr int kPerRow = kBK / VEC;
  constexpr int kCount = kTileM * kPerRow / kThreads;
#pragma unroll
  for (int t = 0; t < kCount; ++t) {
    const int e = threadIdx.x + t * kThreads;
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * VEC;
    const int row = r0 + r;
    const int k = k0 + c;
    T v = T();
    if (row < n && k < n) {
      v = *reinterpret_cast<const T*>(src + static_cast<long long>(row) * n + k);
    }
    *reinterpret_cast<T*>(&dst[r][c]) = v;
  }
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
dense_mxu_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ at, int n,
                 unsigned long long* __restrict__ out) {
  __shared__ __align__(16) uint8_t a_tile[kTileM][kLd];
  __shared__ __align__(16) uint8_t b_tile[kTileN][kLd];
  __shared__ long long warp_sums[kThreads / 32];

  const int i0 = blockIdx.y * kTileM;
  const int j0 = blockIdx.x * kTileN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // the MMA fragments' groupID
  const int tig = lane & 3;  // and threadID_in_group
  const int wm = (warp >> 2) * kWarpM;
  const int wn = (warp & 3) * kWarpN;

  int acc[kMi][kNi][4];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    stage<VEC>(a, n, i0, k0, a_tile);
    stage<VEC>(at, n, j0, k0, b_tile);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[kMi][4];
      uint32_t bf[kNi][2];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = ld32(&a_tile[r][ks + tig * 4]);
        af[mi][1] = ld32(&a_tile[r + 8][ks + tig * 4]);
        af[mi][2] = ld32(&a_tile[r][ks + 16 + tig * 4]);
        af[mi][3] = ld32(&a_tile[r + 8][ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) {
        const int c = wn + ni * 8 + g;
        bf[ni][0] = ld32(&b_tile[c][ks + tig * 4]);
        bf[ni][1] = ld32(&b_tile[c][ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  // Accumulator q of tile (mi, ni) sits at row g (+8 for q >= 2) and column
  // 2 * tig + (q & 1) of that 16 x 8 tile.
  long long sum = 0;
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi) {
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = i0 + wm + mi * 16 + g + ((q >> 1) << 3);
        const int col = j0 + wn + ni * 8 + tig * 2 + (q & 1);
        if (row < n && col < n) {
          sum += static_cast<long long>(acc[mi][ni][q]) *
                 a[static_cast<long long>(row) * n + col];
        }
      }
    }
  }
  sum = warp_sum(sum);
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    sum = warp_sum(lane < kThreads / 32 ? warp_sums[lane] : 0);
    if (lane == 0 && sum != 0) atomicAdd(out, static_cast<unsigned long long>(sum));
  }
}

template <int VEC>
void launch(const void* a, const void* at, int n, void* out, cudaStream_t stream) {
  const int tiles = (n + kTileM - 1) / kTileM;
  dense_mxu_kernel<VEC><<<dim3(tiles, tiles), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(at), n,
      static_cast<unsigned long long*>(out));
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// out[0] += sum_{i,j} a[i][j] * (a @ a)[i][j] for a [n, n] int8 and at its
// transpose, both contiguous; out one int64, on `stream`. Returns
// cudaGetLastError() (0 on success). The caller validates shapes, types and
// devices.
extern "C" int tc_dense_mxu(const void* a, const void* at, int n, void* out,
                            void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (n % 16 == 0 && aligned(a, 16) && aligned(at, 16)) {
    launch<16>(a, at, n, out, s);
  } else if (n % 4 == 0 && aligned(a, 4) && aligned(at, 4)) {
    launch<4>(a, at, n, out, s);
  } else {
    launch<1>(a, at, n, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}
