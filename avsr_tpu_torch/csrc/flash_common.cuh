// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile geometry, the float -> T cast, the zero-filling tile load, and
// the warp's score product A B^T.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr int BLOCK = 64;                 // rows of a query or key/value tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BLOCK / WARPS;  // 16: one wmma row tile
constexpr int HALF = BLOCK / 2;           // score columns per lane

// Shared-memory pitches and region sizes. bfloat16 tiles go through the
// tensor cores (wmma), whose results pass through one f32 scratch tile per
// warp; float32 tiles take scalar FMAs and need no scratch.
template <typename T, int D>
struct Geometry {
  static constexpr bool kWmma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int LDT = D + 8;                           // tile row pitch
  static constexpr int LDP = BLOCK + 8;                       // P / dS pitch
  static constexpr int LDS = (D > BLOCK ? D : BLOCK) + 4;     // f32 scratch
  static constexpr size_t kTile = size_t(BLOCK) * LDT * sizeof(T);
  static constexpr size_t kScratch =
      kWmma ? size_t(WARPS) * ROWS_PER_WARP * LDS * sizeof(float) : 0;
  // one [16, 64] tile of P or dS per warp, in T
  static constexpr size_t kWarpP = size_t(WARPS) * ROWS_PER_WARP * LDP * sizeof(T);
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// Copies rows [row0, row0 + 64) of one head ([T, D], contiguous) into a
// shared tile of row pitch LDT; rows at or past `nrows` are zero-filled, so
// masked rows hold zeros (0 * garbage could be NaN) and stay finite.
template <typename T, int D, int LDT>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int nrows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < BLOCK * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    const int t = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < nrows) {
      val = *reinterpret_cast<const uint4*>(src + size_t(t) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDT + c) = val;
  }
}

// out[i] = sum_d A[r, d] * B[half * 32 + i, d] for the lane's row r: the
// warp's [16, 64] tile of A B^T, A the warp's 16 rows and B a 64-row tile,
// both [rows, D] in shared memory with pitch LDT. Lane pair (2r, 2r+1) owns
// row r, each lane one half of its 64 columns.
template <typename T, int D>
__device__ __forceinline__ void warp_abt(const T* A, const T* B, float* scratch,
                                         int r, int half, float (&out)[HALF]) {
  using Gm = Geometry<T, D>;
  if constexpr (Gm::kWmma) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
    for (int n = 0; n < BLOCK / 16; ++n) {
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::load_matrix_sync(a, A + kk * 16, Gm::LDT);
        // B^T as a column-major matrix_b: element (d, j) sits at B[j*LDT + d].
        wmma::load_matrix_sync(b, B + n * 16 * Gm::LDT + kk * 16, Gm::LDT);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(scratch + n * 16, c, Gm::LDS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < HALF; ++i) out[i] = scratch[r * Gm::LDS + half * HALF + i];
    __syncwarp();  // the scratch is rewritten by the next product
  } else {
#pragma unroll
    for (int i = 0; i < HALF; ++i) out[i] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float ad = A[r * Gm::LDT + d];
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        out[i] = fmaf(ad, B[(half * HALF + i) * Gm::LDT + d], out[i]);
      }
    }
  }
}

}  // namespace flash
