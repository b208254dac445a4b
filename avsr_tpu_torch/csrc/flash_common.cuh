// Pieces shared by the float32 flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): the tile geometry, the zero-filling tile load, the warp's
// score product A B^T on the CUDA cores, and the reductions over the lanes
// that share a row; for heads wider than 512, the same pieces over column
// chunks and column groups (namespace panels).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// Tile geometry of head width D. A tile holds BLOCK rows of a query or
// key/value head: 64, 32 at D = 256, where a 64-row f32 tile takes 66 KB
// and dQ's and dK/dV's four tiles would not fit in shared memory, and 16 at
// D = 512. A warp owns ROWS_PER_WARP rows of the CTA's tile; the LANES
// lanes that share a row hold COLS of its BLOCK score columns and DCOLS of
// its D output columns each (64-row tiles: lane pair (2r, 2r+1) owns row r,
// each lane one half; 32-row tiles: lanes 4r..4r+3 own row r, each lane a
// quarter; 16-row tiles: 8 lanes a row, each an eighth).
template <typename T, int D>
struct Geometry {
  static constexpr int BLOCK = D == 512 ? 16 : D == 256 ? 32 : 64;
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

// Heads wider than 512 (the wide kernels): the head width D is a loop
// count, not a tile size. A CTA owns 16 rows (4 warps of 4 rows, 8 lanes a
// row, each lane 2 of a 16-column score row) and one group of at most NG
// output columns; the scores over the whole width are summed chunk by chunk,
// each chunk CW columns of both operands in shared memory, and the group's
// columns of the product's B operand come in as one tile.
namespace panels {

constexpr int BLOCK = 16;                 // rows of a tile
constexpr int RPW = BLOCK / WARPS;        // rows of a warp
constexpr int LANES = 32 / RPW;           // lanes of a row
constexpr int COLS = BLOCK / LANES;       // score columns of a lane
constexpr int CW = 64;                    // columns of a streamed chunk
constexpr int NG = 256;                   // output columns of a CTA
constexpr int DC = NG / LANES;            // output columns of a lane
constexpr int LDC = CW + 4;               // chunk tile pitch (floats)
constexpr int LDG = NG + 4;               // group tile pitch
constexpr int LDP = BLOCK + 4;            // P / dS pitch
constexpr int kChunk = BLOCK * LDC * 4;   // bytes of a chunk tile
constexpr int kGroup = BLOCK * LDG * 4;   // bytes of a group tile
constexpr int kWarpP = WARPS * RPW * LDP * 4;

// Rows [row0, row0 + BLOCK) and columns [c0, c0 + W) of one head ([T, D],
// contiguous) into a tile of pitch LD; rows at or past `nrows` and columns
// at or past c0 + `ncols` are zero-filled.
template <int W, int LD>
__device__ __forceinline__ void load_cols(float* dst, const float* __restrict__ src,
                                          int D, int row0, int nrows, int c0,
                                          int ncols) {
  constexpr int VPR = W / 4;
  for (int i = threadIdx.x; i < BLOCK * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 4;
    const int t = row0 + r;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (t < nrows && c < ncols) {
      val = *reinterpret_cast<const float4*>(src + size_t(t) * D + c0 + c);
    }
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// out[i] += sum over one chunk's CW columns of A[r, d] B[part * COLS + i, d]:
// the lane's part of row r of A B^T, A the warp's rows and B a BLOCK-row
// chunk tile (both pitch LDC).
__device__ __forceinline__ void abt_chunk(const float* A, const float* B, int r,
                                          int part, float (&out)[COLS]) {
#pragma unroll 8
  for (int d = 0; d < CW; ++d) {
    const float ad = A[r * LDC + d];
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      out[i] = fmaf(ad, B[(part * COLS + i) * LDC + d], out[i]);
    }
  }
}

// A warp's [RPW, NG] f32 accumulator of products A B, A a P or dS tile
// (pitch LDP) and B a group tile (pitch LDG): lane (r, part) holds columns
// [part * DC, (part + 1) * DC) of row r.
struct Acc {
  float v[DC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < DC; ++j) v[j] = 0.0f;
  }
  // (unrolled by 2: by 4, ptxas holds the dQ kernel at 128 registers and
  // spills)
  __device__ __forceinline__ void mma(const float* A, const float* B, int r, int part) {
#pragma unroll 2
    for (int c = 0; c < BLOCK; ++c) {
      const float a = A[r * LDP + c];
      const float* br = B + c * LDG + part * DC;
#pragma unroll
      for (int j = 0; j < DC; ++j) v[j] = fmaf(a, br[j], v[j]);
    }
  }
  // Writes scale * (the lane's part of its row) to `row` (the row's first
  // column of the group) for the group's first `ncols` columns, when
  // `write`.
  __device__ __forceinline__ void store(float* row, float scale, int ncols, int part,
                                        bool write) {
    if (!write) return;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      if (part * DC + j < ncols) row[part * DC + j] = v[j] * scale;
    }
  }
};

}  // namespace panels

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
