// Flash-attention backward for NVIDIA Hopper (sm_90a), CUDA C++ with a plain
// C interface (loaded through ctypes by avsr_tpu_torch/ops/attention.py).
//
// Two kernels, the ports of the Pallas TPU kernels that
// avsr_tpu/ops/attention.py::_flash_core_bwd launches:
//   flash_bwd_dq_kernel   <- _flash_bwd_dq_kernel  (attention.py:181)
//   flash_bwd_dkv_kernel  <- _flash_bwd_dkv_kernel (attention.py:241)
//                            (bf16: flash_bwd_dkv_bf16_kernel)
// Given the forward's q, k, v, its saved (rounded) output O and its plain
// [B, H, Tq] f32 logsumexp, and the output gradient dO, with
//   P  = exp(S * scale - lse),  S = Q K^T          (masked: P = 0)
//   dP = dO V^T,  delta = rowsum(dO * O)  (f32, from the saved O)
//   dS = P * (dP - delta)
// they compute
//   dQ = scale * dS K                    (dS cast to K's dtype first)
//   dK = (scale * dS)^T Q                (cast to Q's dtype first)
//   dV = P^T dO                          (P cast to dO's dtype first)
// with f32 accumulation, summing dK and dV over the H / Hkv query heads of
// each kv head (GQA). The mask keeps (i, j) iff i < q_len[b], j < kv_len[b]
// and, when causal, j <= i (top-left aligned; causal needs Tq == Tk). Rows
// at or past q_len and rows without a valid key carry lse = +inf from the
// forward and get P = 0, so their dQ rows are 0 (the TPU kernel leaves them
// unconstrained). The dQ kernel computes delta once per row and also writes
// it ([B, H, Tq] f32, 0 past q_len); the dK/dV kernel reads it and never
// reads O.
//
// Bound on the card, at the train step's shape (B=8, q [8,32,672,64], k/v
// [8,8,672,64] bf16 causal, 581 valid rows, 4.33e7 valid pairs): dQ does
// 6*D flops per pair (1.66e10 -> 16.8 us at 989 TFLOP/s) and reads the valid
// rows of q, k, v, dO, O and lse once and writes all of dQ and delta once
// (89.9 MB -> 26.8 us at 3.35 TB/s); dK/dV does 8*D flops per pair (2.22e10
// -> 22.4 us) and reads the valid rows of q, k, v, dO, lse and delta and
// writes all of dK and dV (59.8 MB -> 17.8 us). dQ is bound by bytes, dK/dV
// by operations (chip_smoke.py::attn_bounds).
//
// dQ (bf16 and f32) and the f32 dK/dV are the first design: 4 warps over
// 64-row tiles, a warp owning 16 rows of the CTA's own tile and lane pair
// (2r, 2r+1) owning row r, each lane one half (32 columns) of a 64-wide
// score row; bf16 products on wmma 16x16x16 through an f32 scratch tile,
// f32 products as scalar FMAs.
//   dQ:    one CTA per (b, q head, 64-row q tile); it loops over the K/V
//          tiles of kv head h / (H / Hkv).
//
// bf16 dK/dV (flash_bwd_dkv_bf16_kernel): one CTA per (b, kv head, 128-key
// tile), warp-specialised:
//   * K and V of the CTA's keys are loaded once by TMA and stay in shared
//     memory;
//   * a producer warp streams the q tiles of all H / Hkv query heads of the
//     group through a ring of three stages: Q and dO tiles by TMA (3-D
//     tensor maps over [B*H, Tq, D], 128-byte swizzle, zeros past Tq), and
//     the tile's lse (times log2 e; +inf past q_len) and delta (0 past
//     q_len) rows, copied by its lanes; "full" mbarriers count the TMA bytes
//     and the lanes, "empty" ones the consumer threads;
//   * two consumer warpgroups own 64 keys each and work in the transposed
//     orientation: S^T = K Q^T and dP^T = V dO^T by wgmma with both operands
//     in shared memory (f32 accumulators in registers), P^T = exp(S^T scale
//     - lse) with lse per column, dS^T = P^T (dP^T - delta) scale, masked
//     (kj < kv_len, kj <= qi when causal) only on tiles that cross kv_len
//     or the diagonal; then dV += P^T dO and dK += dS^T Q by wgmma with P^T
//     and dS^T rounded to bf16 as register A operands and dO, Q as MN-major
//     B operands from the ring. P and dS never touch shared memory;
//   * each dK/dV tile has one owner and no atomics (gradients are identical
//     from run to run); it leaves through a swizzled shared tile and a TMA
//     store that clips rows past Tk.
// Q tiles are 64 rows for D = 64 and 16 for D = 128 (which keeps the dK,
// dV, S and dP accumulators in registers). Key tile i visits the q tiles
// from its diagonal on, so with causal masking the first tiles carry the
// most work: the grid puts the key tile in its slowest dimension, first
// tile first, so the heaviest CTAs start first.

#include <math.h>
#include <mma.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::BLOCK;
using flash::from_float;
using flash::Geometry;
using flash::HALF;
using flash::ROWS_PER_WARP;
using flash::THREADS;
using flash::warp_abt;
using flash::WARPS;

// dQ kernel shared memory: Q, dO, K, V tiles, scratch, dS.
template <typename T, int D>
struct SmemDq : Geometry<T, D> {
  using G = Geometry<T, D>;
  static constexpr size_t kQ = 0;
  static constexpr size_t kDO = G::kTile;
  static constexpr size_t kK = 2 * G::kTile;
  static constexpr size_t kV = 3 * G::kTile;
  static constexpr size_t kS = 4 * G::kTile;
  static constexpr size_t kDS = kS + G::kScratch;
  static constexpr size_t kTotal = kDS + G::kWarpP;
};

// f32 dK/dV kernel shared memory: K, V, Q, dO tiles, P, dS, lse, delta.
template <int D>
struct SmemDkvF32 : Geometry<float, D> {
  using G = Geometry<float, D>;
  static constexpr size_t kK = 0;
  static constexpr size_t kV = G::kTile;
  static constexpr size_t kQ = 2 * G::kTile;
  static constexpr size_t kDO = 3 * G::kTile;
  static constexpr size_t kP = 4 * G::kTile;
  static constexpr size_t kDS = kP + G::kWarpP;
  static constexpr size_t kLse = kDS + G::kWarpP;
  static constexpr size_t kDelta = kLse + BLOCK * sizeof(float);
  static constexpr size_t kTotal = kDelta + BLOCK * sizeof(float);
};

// A warp's [16, D] f32 accumulator of products A[16, 64] B[64, D], with A a
// P or dS tile (pitch LDP) and B a 64-row tile (pitch LDT).
template <typename T, int D, bool kWmma = Geometry<T, D>::kWmma>
struct WarpAcc;

// Tensor-core version: D/16 accumulator fragments, kept in registers.
template <typename T, int D>
struct WarpAcc<T, D, true> {
  using Gm = Geometry<T, D>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[D / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) nvcuda::wmma::fill_fragment(c[n], 0.0f);
  }
  __device__ __forceinline__ void mma(const T* A, const T* B, int, int) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      wmma::load_matrix_sync(a, A + kk * 16, Gm::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::load_matrix_sync(b, B + kk * 16 * Gm::LDT + n * 16, Gm::LDT);
        wmma::mma_sync(c[n], a, b, c[n]);
      }
    }
  }
  // Writes scale * (the lane's half row) to `out` when `write`; every lane
  // of the warp must call it (the fragment store is warp-collective).
  __device__ __forceinline__ void store(T* out, float scale, float* scratch,
                                        int r, int half, bool write) {
    using namespace nvcuda;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::store_matrix_sync(scratch + n * 16, c[n], Gm::LDS, wmma::mem_row_major);
    }
    __syncwarp();
    if (write) {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) {
        out[j] = from_float<T>(scratch[r * Gm::LDS + half * (D / 2) + j] * scale);
      }
    }
    __syncwarp();
  }
};

// Scalar version: lane (r, half) holds columns [half*D/2, (half+1)*D/2) of
// row r.
template <typename T, int D>
struct WarpAcc<T, D, false> {
  using Gm = Geometry<T, D>;
  float v[D / 2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) v[j] = 0.0f;
  }
  __device__ __forceinline__ void mma(const T* A, const T* B, int r, int half) {
    for (int c = 0; c < BLOCK; ++c) {
      const float a = A[r * Gm::LDP + c];
      const T* br = B + c * Gm::LDT + half * (D / 2);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) v[j] = fmaf(a, br[j], v[j]);
    }
  }
  __device__ __forceinline__ void store(T* out, float scale, float*, int, int,
                                        bool write) {
    if (write) {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) out[j] = from_float<T>(v[j] * scale);
    }
  }
};

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const float* __restrict__ lse, const T* __restrict__ dout,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ kv_lens, T* __restrict__ dq,
                    float* __restrict__ delta_out, int H, int Hkv, int Tq,
                    int Tk, int causal, float scale) {
  using L = SmemDq<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sDO = reinterpret_cast<T*>(smem + L::kDO);
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BLOCK;
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1;
  const int half = lane & 1;
  const int row = warp * ROWS_PER_WARP + r;
  const int qi = q0 + row;
  float* scratch = reinterpret_cast<float*>(smem + L::kS) +
                   warp * ROWS_PER_WARP * L::LDS;
  T* dsw = reinterpret_cast<T*>(smem + L::kDS) + warp * ROWS_PER_WARP * L::LDP;

  const size_t q_head = (size_t(b) * H + h) * Tq;
  const size_t kv_head = (size_t(b) * Hkv + hk) * Tk;

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + BLOCK, q_len));
  const int n_blocks = q0 < q_len ? (kv_end + BLOCK - 1) / BLOCK : 0;

  WarpAcc<T, D> acc;
  acc.zero();
  if (n_blocks > 0) {
    flash::load_tile<T, D, L::LDT>(sQ, q + q_head * D, q0, q_len);
    flash::load_tile<T, D, L::LDT>(sDO, dout + q_head * D, q0, q_len);
  }
  __syncthreads();

  // delta = rowsum(dO * O) in f32; the lane pair shares the row. Rows past
  // q_len, and rows of a batch row without keys (O = 0), get 0.
  const bool row_ok = qi < q_len;
  float delta = 0.0f;
  if (row_ok && n_blocks > 0) {
    const T* orow = o + (q_head + qi) * D + half * (D / 2);
    const T* drow = sDO + row * L::LDT + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      delta = fmaf(float(drow[j]), float(orow[j]), delta);
    }
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  if (half == 0 && qi < Tq) delta_out[q_head + qi] = delta;
  const float lse_i = row_ok ? lse[q_head + qi] : INFINITY;

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int kv0 = blk * BLOCK;
    __syncthreads();  // every warp is done with the previous K/V tile
    flash::load_tile<T, D, L::LDT>(sK, k + kv_head * D, kv0, kv_len);
    flash::load_tile<T, D, L::LDT>(sV, v + kv_head * D, kv0, kv_len);
    __syncthreads();

    float s[HALF], dp[HALF];
    warp_abt<T, D>(sQ + warp * ROWS_PER_WARP * L::LDT, sK, scratch, r, half, s);
    warp_abt<T, D>(sDO + warp * ROWS_PER_WARP * L::LDT, sV, scratch, r, half, dp);
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const int kj = kv0 + half * HALF + i;
      const bool ok = row_ok && kj < kv_len && (!causal || kj <= qi);
      const float p = ok ? __expf(s[i] * scale - lse_i) : 0.0f;
      dsw[r * L::LDP + half * HALF + i] = from_float<T>(p * (dp[i] - delta));
    }
    __syncwarp();  // dS complete before the product
    acc.mma(dsw, sK, r, half);
    __syncwarp();  // dS is rewritten by the next block
  }

  acc.store(dq + (q_head + qi) * D + half * (D / 2), scale, scratch, r, half,
            qi < Tq);
}

// ---------------------------------------------------------------------------
// dK / dV, float32: the scalar path
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ dout,
                     const int* __restrict__ q_lens,
                     const int* __restrict__ kv_lens, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Hkv, int Tq, int Tk,
                     int causal, float scale) {
  using L = SmemDkvF32<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sDO = reinterpret_cast<float*>(smem + L::kDO);
  float* sLse = reinterpret_cast<float*>(smem + L::kLse);
  float* sDelta = reinterpret_cast<float*>(smem + L::kDelta);

  const int b = blockIdx.z;
  const int hk = blockIdx.y;
  const int group = H / Hkv;
  const int k0 = blockIdx.x * BLOCK;
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1;
  const int half = lane & 1;
  const int krow = warp * ROWS_PER_WARP + r;
  const int kj = k0 + krow;     // key position of the lane's row
  float* pw = reinterpret_cast<float*>(smem + L::kP) + warp * ROWS_PER_WARP * L::LDP;
  float* dsw = reinterpret_cast<float*>(smem + L::kDS) + warp * ROWS_PER_WARP * L::LDP;

  const size_t kv_head = (size_t(b) * Hkv + hk) * Tk;

  // q tiles that can see this K tile: none wholly above it (causal), none
  // wholly at or past q_len, none at all when the tile is past kv_len.
  const int qb_begin = causal ? k0 / BLOCK : 0;
  const int qb_end = k0 < kv_len ? (q_len + BLOCK - 1) / BLOCK : 0;

  WarpAcc<float, D> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  if (qb_begin < qb_end) {
    flash::load_tile<float, D, L::LDT>(sK, k + kv_head * D, k0, kv_len);
    flash::load_tile<float, D, L::LDT>(sV, v + kv_head * D, k0, kv_len);
  }

  for (int g = 0; g < group; ++g) {
    const size_t q_head = (size_t(b) * H + hk * group + g) * Tq;
    for (int qb = qb_begin; qb < qb_end; ++qb) {
      const int q0 = qb * BLOCK;
      __syncthreads();  // every warp is done with the previous q tile
      flash::load_tile<float, D, L::LDT>(sQ, q + q_head * D, q0, q_len);
      flash::load_tile<float, D, L::LDT>(sDO, dout + q_head * D, q0, q_len);
      if (threadIdx.x < BLOCK) {
        const int qi = q0 + threadIdx.x;
        sLse[threadIdx.x] = qi < q_len ? lse[q_head + qi] : INFINITY;
        sDelta[threadIdx.x] = qi < q_len ? delta[q_head + qi] : 0.0f;
      }
      __syncthreads();

      float s[HALF], dp[HALF];
      // transposed scores: rows are this warp's keys, columns the q rows
      warp_abt<float, D>(sK + warp * ROWS_PER_WARP * L::LDT, sQ, nullptr, r,
                         half, s);
      warp_abt<float, D>(sV + warp * ROWS_PER_WARP * L::LDT, sDO, nullptr, r,
                         half, dp);
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const int c = half * HALF + i;
        const int qi = q0 + c;
        const bool ok = kj < kv_len && qi < q_len && (!causal || kj <= qi);
        const float p = ok ? __expf(s[i] * scale - sLse[c]) : 0.0f;
        pw[r * L::LDP + c] = p;
        dsw[r * L::LDP + c] = p * (dp[i] - sDelta[c]) * scale;
      }
      __syncwarp();  // P and dS complete before the products
      dv_acc.mma(pw, sDO, r, half);
      dk_acc.mma(dsw, sQ, r, half);
      __syncwarp();
    }
  }

  dk_acc.store(dk + (kv_head + kj) * D + half * (D / 2), 1.0f, nullptr, r,
               half, kj < Tk);
  dv_acc.store(dv + (kv_head + kj) * D + half * (D / 2), 1.0f, nullptr, r,
               half, kj < Tk);
}

// ---------------------------------------------------------------------------
// dK / dV, bfloat16: wgmma on a TMA ring
// ---------------------------------------------------------------------------

constexpr int BK = 128;          // keys of a CTA
constexpr int STAGES = 3;        // q-tile ring depth
constexpr int CONSUMERS = 2;     // consumer warpgroups, 64 keys each
constexpr int THREADS_BF16 = (CONSUMERS + 1) * 128;
constexpr float LOG2E = 1.4426950408889634f;

// Dynamic shared-memory layout (byte offsets from a 1024-byte boundary).
template <int D>
struct DkvLayout {
  static constexpr int P = D / hopper::PANEL_COLS;      // 64-column panels
  static constexpr int BQ = D == 64 ? 64 : 16;           // q rows of a tile
  static constexpr int kKPanel = BK * hopper::ROW_BYTES;
  static constexpr int kQPanel = BQ * hopper::ROW_BYTES;
  static constexpr int kOutPanel = 64 * hopper::ROW_BYTES;  // one warpgroup's keys
  static constexpr int kK = 0;
  static constexpr int kV = kK + P * kKPanel;
  static constexpr int kQ = kV + P * kKPanel;
  static constexpr int kDO = kQ + STAGES * P * kQPanel;
  static constexpr int kDK = kDO + STAGES * P * kQPanel;
  static constexpr int kDV = kDK + CONSUMERS * P * kOutPanel;
  static constexpr int kLse = kDV + CONSUMERS * P * kOutPanel;
  static constexpr int kDelta = kLse + STAGES * BQ * 4;
  static constexpr int kBar = kDelta + STAGES * BQ * 4;
  static constexpr int kBytes = kBar + (1 + 2 * STAGES) * 8 + hopper::ATOM_BYTES;
};

template <int D>
__global__ void __launch_bounds__(THREADS_BF16, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_dk,
                          const __grid_constant__ CUtensorMap tm_dv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ q_lens,
                          const int* __restrict__ kv_lens, int H, int Hkv,
                          int Tq, int Tk, int causal, float scale) {
  using namespace hopper;
  using L = DkvLayout<D>;
  constexpr int P = L::P;
  constexpr int BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);
  float* s_lse = reinterpret_cast<float*>(smem + L::kLse);
  float* s_delta = reinterpret_cast<float*>(smem + L::kDelta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BK;        // first key tile (the heaviest) first
  const int group = H / Hkv;
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));
  // q tiles that can see these keys: none wholly above them (causal), none
  // wholly at or past q_len, none at all when the keys are past kv_len.
  const int qb_begin = causal ? k0 / BQ : 0;
  const int qb_end = k0 < kv_len ? (q_len + BQ - 1) / BQ : 0;
  const int n_qb = max(0, qb_end - qb_begin);
  const int n_iter = group * n_qb;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);                 // the producer warp's lanes
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: its first warp ----
    setmaxnreg_dec<40>();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < CONSUMERS * 128 + 32 && n_iter > 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * P * L::kKPanel);
        for (int p = 0; p < P; ++p) {
          tma_load_3d(smem + L::kK + p * L::kKPanel, &tm_k, kv_full,
                      p * PANEL_COLS, k0, b * Hkv + hk);
          tma_load_3d(smem + L::kV + p * L::kKPanel, &tm_v, kv_full,
                      p * PANEL_COLS, k0, b * Hkv + hk);
        }
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % STAGES;
        const int bh = b * H + hk * group + it / n_qb;
        const int q0 = (qb_begin + it % n_qb) * BQ;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        for (int c = lane; c < BQ; c += 32) {
          const int qi = q0 + c;
          const size_t row = size_t(bh) * Tq + qi;
          s_lse[s * BQ + c] = qi < q_len ? lse[row] * LOG2E : INFINITY;
          s_delta[s * BQ + c] = qi < q_len ? delta[row] : 0.0f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * P * L::kQPanel);
          for (int p = 0; p < P; ++p) {
            const int off = (s * P + p) * L::kQPanel;
            tma_load_3d(smem + L::kQ + off, &tm_q, &full[s], p * PANEL_COLS, q0, bh);
            tma_load_3d(smem + L::kDO + off, &tm_do, &full[s], p * PANEL_COLS, q0,
                        bh);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // key rows r and r + 8
    const int cq = (lane & 3) * 2;                // first q column of each pair
    const int kw0 = k0 + wg * 64;
    const int ka = kw0 + r;
    const int kb = ka + 8;
    const float scale_log2 = scale * LOG2E;
    const uint8_t* sk = smem + L::kK + wg * 64 * ROW_BYTES;
    const uint8_t* sv = smem + L::kV + wg * 64 * ROW_BYTES;

    float dk[P][32], dv[P][32];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[p][i] = dv[p][i] = 0.0f;
    }

    if (n_iter > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const int q0 = (qb_begin + it % n_qb) * BQ;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint8_t* sq = smem + L::kQ + s * P * L::kQPanel;
      const uint8_t* sdo = smem + L::kDO + s * P * L::kQPanel;

      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int p = k / 4;
        const int kbyte = (k % 4) * 32;   // a k16 step within a 128-byte row
        wgmma_ss<BQ>(st, desc_sw128(sk + p * L::kKPanel + kbyte),
                     desc_sw128(sq + p * L::kQPanel + kbyte), k > 0);
      }
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int p = k / 4;
        const int kbyte = (k % 4) * 32;
        wgmma_ss<BQ>(dpt, desc_sw128(sv + p * L::kKPanel + kbyte),
                     desc_sw128(sdo + p * L::kQPanel + kbyte), k > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      const float* ls = s_lse + s * BQ;
      const float* dl = s_delta + s * BQ;
      const bool need_mask = kw0 + 64 > kv_len || (causal && q0 < kw0 + 63);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * i + cq);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * i + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lv = (e & 1) ? l2.y : l2.x;
          const float dv_ = (e & 1) ? d2.y : d2.x;
          float p = ex2(fmaf(st[4 * i + e], scale_log2, -lv));
          if (need_mask) {
            const int kj = e < 2 ? ka : kb;
            const int qi = q0 + 8 * i + cq + (e & 1);
            if (!(kj < kv_len && (!causal || kj <= qi))) p = 0.0f;
          }
          st[4 * i + e] = p;
          dpt[4 * i + e] = p * (dpt[4 * i + e] - dv_) * scale;
        }
      }

      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
      acc_to_a<BQ>(st, pa);
      acc_to_a<BQ>(dpt, dsa);
      // the A operands complete before the products that read them
      fence_regs(pa);
      fence_regs(dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int off = p * L::kQPanel + kk * 16 * ROW_BYTES;
          wgmma_rs<64>(dv[p], pa[kk], desc_sw128(sdo + off), 1);
          wgmma_rs<64>(dk[p], dsa[kk], desc_sw128(sq + off), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < P; ++p) {
        fence_regs(dv[p]);
        fence_regs(dk[p]);
      }
      fence_regs(pa);
      fence_regs(dsa);
      mbar_arrive(&empty[s]);
    }

    // ---- epilogue: dK and dV of the warpgroup's 64 keys ----
    uint8_t* sdk = smem + L::kDK + wg * P * L::kOutPanel;
    uint8_t* sdv = smem + L::kDV + wg * P * L::kOutPanel;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t oa = p * L::kOutPanel + swizzled_offset(r, 8 * i + cq);
        const uint32_t ob = p * L::kOutPanel + swizzled_offset(r + 8, 8 * i + cq);
        *reinterpret_cast<uint32_t*>(sdk + oa) =
            pack_bf16(dk[p][4 * i], dk[p][4 * i + 1]);
        *reinterpret_cast<uint32_t*>(sdk + ob) =
            pack_bf16(dk[p][4 * i + 2], dk[p][4 * i + 3]);
        *reinterpret_cast<uint32_t*>(sdv + oa) =
            pack_bf16(dv[p][4 * i], dv[p][4 * i + 1]);
        *reinterpret_cast<uint32_t*>(sdv + ob) =
            pack_bf16(dv[p][4 * i + 2], dv[p][4 * i + 3]);
      }
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if (tid == 0 && kw0 < Tk) {
      for (int p = 0; p < P; ++p) {
        tma_store_3d(&tm_dk, sdk + p * L::kOutPanel, p * PANEL_COLS, kw0,
                     b * Hkv + hk);
        tma_store_3d(&tm_dv, sdv + p * L::kOutPanel, p * PANEL_COLS, kw0,
                     b * Hkv + hk);
      }
      tma_store_drain();
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* lse, const void* dout,
                      const void* q_lens, const void* kv_lens, void* dq,
                      void* delta, int B, int H, int Hkv, int Tq, int Tk,
                      int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  const int bytes = int(SmemDq<T, D>::kTotal);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BLOCK - 1) / BLOCK, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const int*>(q_lens), static_cast<const int*>(kv_lens),
      static_cast<T*>(dq), static_cast<float*>(delta), H, Hkv, Tq, Tk, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* lse, const void* delta, const void* dout,
                           const void* q_lens, const void* kv_lens, void* dk,
                           void* dv, int B, int H, int Hkv, int Tq, int Tk,
                           int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<D>;
  const int bytes = int(SmemDkvF32<D>::kTotal);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + BLOCK - 1) / BLOCK, Hkv, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(dout),
      static_cast<const int*>(q_lens), static_cast<const int*>(kv_lens),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, Tq, Tk, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* lse, const void* delta,
                            const void* dout, const void* q_lens,
                            const void* kv_lens, void* dk, void* dv, int B,
                            int H, int Hkv, int Tq, int Tk, int causal,
                            float scale, cudaStream_t stream) {
  using L = DkvLayout<D>;
  CUtensorMap tq, tdo, tk, tv, tdk, tdv;
  if (!hopper::make_tmap_bf16(&tq, q, B * H, Tq, D, L::BQ) ||
      !hopper::make_tmap_bf16(&tdo, dout, B * H, Tq, D, L::BQ) ||
      !hopper::make_tmap_bf16(&tk, k, B * Hkv, Tk, D, BK) ||
      !hopper::make_tmap_bf16(&tv, v, B * Hkv, Tk, D, BK) ||
      !hopper::make_tmap_bf16(&tdk, dk, B * Hkv, Tk, D, 64) ||
      !hopper::make_tmap_bf16(&tdv, dv, B * Hkv, Tk, D, 64)) {
    return cudaErrorNotSupported;
  }
  auto kernel = flash_bwd_dkv_bf16_kernel<D>;
  const int bytes = L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B, (Tk + BK - 1) / BK);
  kernel<<<grid, THREADS_BF16, bytes, stream>>>(
      tq, tdo, tk, tv, tdk, tdv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(q_lens),
      static_cast<const int*>(kv_lens), H, Hkv, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Hkv, int Tq, int Tk) {
  return B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Tq <= 0 || Tk <= 0 ||
         B > 65535 || H > 65535;
}

}  // namespace

// Both return 0 on success, else the cudaError_t of the failed call (each
// launch is checked with cudaGetLastError right after it is enqueued;
// cudaErrorNotSupported if a tensor map could not be encoded).
// is_f32: 0 for bfloat16 operands, 1 for float32. D must be 64 or 128.
// q, dout, o, dq: [B, H, Tq, D]; k, v, dk, dv: [B, Hkv, Tk, D]; lse, delta:
// [B, H, Tq] float32; q_lens, kv_lens: [B] int32. All contiguous.
extern "C" int avsr_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* o, const void* lse,
                                 const void* dout, const void* q_lens,
                                 const void* kv_lens, void* dq, void* delta,
                                 int B, int H, int Hkv, int Tq, int Tk, int D,
                                 int is_f32, int causal, float scale,
                                 void* stream) {
  if (bad_shape(B, H, Hkv, Tq, Tk)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AVSR_DQ(T, DD)                                                   \
  return int(launch_dq<T, DD>(q, k, v, o, lse, dout, q_lens, kv_lens, dq, \
                              delta, B, H, Hkv, Tq, Tk, causal, scale, s))
  if (is_f32) {
    if (D == 64) AVSR_DQ(float, 64);
    if (D == 128) AVSR_DQ(float, 128);
  } else {
    if (D == 64) AVSR_DQ(__nv_bfloat16, 64);
    if (D == 128) AVSR_DQ(__nv_bfloat16, 128);
  }
#undef AVSR_DQ
  return int(cudaErrorInvalidValue);
}

extern "C" int avsr_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* lse, const void* delta,
                                  const void* dout, const void* q_lens,
                                  const void* kv_lens, void* dk, void* dv,
                                  int B, int H, int Hkv, int Tq, int Tk, int D,
                                  int is_f32, int causal, float scale,
                                  void* stream) {
  if (bad_shape(B, H, Hkv, Tq, Tk)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AVSR_DKV(FN, DD)                                                \
  return int(FN<DD>(q, k, v, lse, delta, dout, q_lens, kv_lens, dk, dv, \
                    B, H, Hkv, Tq, Tk, causal, scale, s))
  if (is_f32) {
    if (D == 64) AVSR_DKV(launch_dkv_f32, 64);
    if (D == 128) AVSR_DKV(launch_dkv_f32, 128);
  } else {
    if (D == 64) AVSR_DKV(launch_dkv_bf16, 64);
    if (D == 128) AVSR_DKV(launch_dkv_bf16, 128);
  }
#undef AVSR_DKV
  return int(cudaErrorInvalidValue);
}
