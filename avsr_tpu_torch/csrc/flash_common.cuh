// Pieces shared by the float32 flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the tile geometry, the zero-filling tile load, and the
// warp's score product A B^T on the CUDA cores.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int BLOCK = 64;                 // rows of a query or key/value tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BLOCK / WARPS;  // 16
constexpr int HALF = BLOCK / 2;           // score columns per lane

// Shared-memory pitches and region sizes.
template <typename T, int D>
struct Geometry {
  static constexpr int LDT = D + 8;                           // tile row pitch
  static constexpr int LDP = BLOCK + 8;                       // P / dS pitch
  static constexpr size_t kTile = size_t(BLOCK) * LDT * sizeof(T);
  // one [16, 64] tile of P or dS per warp, in T
  static constexpr size_t kWarpP = size_t(WARPS) * ROWS_PER_WARP * LDP * sizeof(T);
};

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
__device__ __forceinline__ void warp_abt(const T* A, const T* B, int r, int half,
                                         float (&out)[HALF]) {
  using Gm = Geometry<T, D>;
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

}  // namespace flash
