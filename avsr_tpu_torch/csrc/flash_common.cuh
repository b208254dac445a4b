// Pieces shared by the float32 flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the tile geometry, the zero-filling tile load, the warp's
// score product A B^T on the CUDA cores, and the reductions over the lanes
// that share a row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// Tile geometry of head width D. A tile holds BLOCK rows of a query or
// key/value head: 64, or 32 at D = 256, where a 64-row f32 tile takes 66 KB
// and dQ's and dK/dV's four tiles would not fit in shared memory. A warp
// owns ROWS_PER_WARP rows of the CTA's tile; the LANES lanes that share a
// row hold COLS of its BLOCK score columns and DCOLS of its D output
// columns each (64-row tiles: lane pair (2r, 2r+1) owns row r, each lane
// one half; 32-row tiles: lanes 4r..4r+3 own row r, each lane a quarter).
template <typename T, int D>
struct Geometry {
  static constexpr int BLOCK = D == 256 ? 32 : 64;
  static constexpr int ROWS_PER_WARP = BLOCK / WARPS;
  static constexpr int LANES = 32 / ROWS_PER_WARP;
  static constexpr int COLS = BLOCK / LANES;
  static constexpr int DCOLS = D / LANES;
  static constexpr int LDT = D + 8;                           // tile row pitch
  static constexpr int LDP = BLOCK + 8;                       // P / dS pitch
  static constexpr size_t kTile = size_t(BLOCK) * LDT * sizeof(T);
  // one [ROWS_PER_WARP, BLOCK] tile of P or dS per warp, in T
  static constexpr size_t kWarpP = size_t(WARPS) * ROWS_PER_WARP * LDP * sizeof(T);
};

// Copies rows [row0, row0 + BLOCK) of one head ([T, D], contiguous) into a
// shared tile of row pitch LDT; rows at or past `nrows` are zero-filled, so
// masked rows hold zeros (0 * garbage could be NaN) and stay finite.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int nrows) {
  using G = Geometry<T, D>;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < G::BLOCK * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    const int t = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < nrows) {
      val = *reinterpret_cast<const uint4*>(src + size_t(t) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * G::LDT + c) = val;
  }
}

// out[i] = sum_d A[r, d] * B[part * COLS + i, d] for the lane's row r: the
// warp's [ROWS_PER_WARP, BLOCK] tile of A B^T, A the warp's rows and B a
// BLOCK-row tile, both [rows, D] in shared memory with pitch LDT; the lane
// holds part `part` of its row's columns.
template <typename T, int D>
__device__ __forceinline__ void warp_abt(const T* A, const T* B, int r, int part,
                                         float (&out)[Geometry<T, D>::COLS]) {
  using Gm = Geometry<T, D>;
#pragma unroll
  for (int i = 0; i < Gm::COLS; ++i) out[i] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float ad = A[r * Gm::LDT + d];
#pragma unroll
    for (int i = 0; i < Gm::COLS; ++i) {
      out[i] = fmaf(ad, B[(part * Gm::COLS + i) * Gm::LDT + d], out[i]);
    }
  }
}

// The max and the sum of v over the LANES neighbouring lanes of a row.
template <int LANES>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int m = 1; m < LANES; m <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}
template <int LANES>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int m = 1; m < LANES; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

}  // namespace flash
