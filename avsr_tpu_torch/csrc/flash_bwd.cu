// Flash-attention backward for NVIDIA Hopper (sm_90a), CUDA C++ with a plain
// C interface (loaded through ctypes by avsr_tpu_torch/ops/attention.py).
//
// Two kernels, the ports of the Pallas TPU kernels that
// avsr_tpu/ops/attention.py::_flash_core_bwd launches:
//   flash_bwd_dq_kernel   <- _flash_bwd_dq_kernel  (attention.py:181)
//                            (bf16: flash_bwd_dq_bf16_kernel; f32:
//                            flash_bwd_dq_f32_kernel)
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
// by operations (chip_smoke.py::attn_bounds). At the connectors' shape
// (q = k = v [8,8,500,256] bf16, non-causal, 2.0e6 pairs a head): dQ
// 2.5e10 flops -> 24.8 us, 98.6 MB -> 29.4 us (bytes); dK/dV 3.3e10 flops
// -> 33.1 us, 98.6 MB -> 29.4 us (operations). At Llama-2-7B's train shape
// (q = k = v [8,32,672,128] causal MHA, 581 rows): dQ 70.4 us, dK/dV 72.1 us
// (bytes); at its connectors' (q = k = v [8,8,500,512]): dQ 58.8 us (bytes),
// dK/dV 66.3 us (operations). Llama-2-13B's connectors [8,8,500,640]: dQ
// 73.4 us (bytes), dK/dV 82.8 us (operations); Llama-2-70B's
// [8,8,500,1024]: dQ 117.5 us (bytes), dK/dV 132.5 us (operations).
//
// D > 512 (any multiple of 64) takes the panel kernels at the end of the
// file (flash_bwd_dq_bf16_panels_kernel, flash_bwd_dkv_bf16_panels_kernel,
// and the f32 flash_bwd_dq_f32_panels_kernel, flash_bwd_dkv_f32_panels_kernel),
// which take the width at run time.
//
// float32 dQ and dK/dV are the first design (flash_bwd_dq_f32_kernel,
// flash_bwd_dkv_kernel): 4 warps over 64-row tiles, a warp owning 16 rows
// of the CTA's own tile and lane pair (2r, 2r+1) owning row r, each lane one
// half (32 columns) of a 64-wide score row, products as scalar FMAs; dQ
// takes one CTA per (b, q head, 64-row q tile) and loops over the K/V tiles
// of kv head h / (H / Hkv). At D = 256 the tiles have 32 rows (four 64-row
// f32 tiles would take 264 KB of shared memory) and 4 lanes share a row.
//
// D = 256 in bf16: one accumulator of 64 rows x 256 columns is 128 f32
// registers a thread, and ptxas gives a kernel of three warpgroups 168; so
// the D = 256 dQ runs one consumer warpgroup of 64 rows beside the producer
// (255 registers a thread; delta from O in device memory, dQ staged in Q's
// space, 32-key stages), and dK and dV run in separate CTAs of 64 keys
// (flash_bwd_dkv_bf16_wide_kernel), each with one consumer warpgroup that
// recomputes S^T. D = 512 in bf16 splits the same CTAs by columns: a dQ
// CTA owns half of its 64 rows' dQ (two CTAs per q tile, each computing S
// and dP over the whole width; 16-key stages), and a key tile has four
// dK/dV CTAs (dK and dV, each by column half; 16-row q stages), so every
// accumulator stays at 128 f32 a thread.
//
// bf16 dQ (flash_bwd_dq_bf16_kernel): one CTA per (b, q head, 128-row q
// tile), the dK/dV design turned around:
//   * a producer thread loads the tile's Q, dO and O once by TMA (they stay
//     resident) and streams the 64-key K and V tiles of kv head
//     h / (H / Hkv) through a ring of three stages (3-D tensor maps over
//     [B*Hkv, Tk, D], 128-byte swizzle, zeros past Tk; full/empty
//     mbarriers);
//   * two consumer warpgroups own 64 q rows each. Each computes delta once
//     per row from the resident dO and O tiles (kept in registers, written
//     as [B, H, Tq] f32, 0 past q_len), then per K/V tile: S = Q K^T and
//     dP = dO V^T by wgmma with both operands in shared memory,
//     P = 2^(S scale log2 e - lse log2 e) and dS = P (dP - delta) in
//     registers, masked only on tiles that cross kv_len or the diagonal,
//     and dQ += dS K by wgmma with dS rounded to bf16 as the register A
//     operand and K as the MN-major B operand. P and dS never touch shared
//     memory; under the causal mask a warpgroup skips the tiles wholly
//     above its rows;
//   * epilogue: scale * dQ into the O tile's space (swizzled) and out by a
//     TMA store that clips rows past Tq; rows past q_len hold 0 (lse there
//     is +inf, so P = 0).
// The grid puts the q tile in its slowest dimension, last tile first, so
// that the heaviest causal tiles start first, and the query heads of one kv
// head next to each other, so that they read its K/V from L2.
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

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using flash::Geometry;
using flash::THREADS;
using flash::warp_abt;

// f32 dQ kernel shared memory: Q, dO, K, V tiles, dS.
template <int D>
struct SmemDqF32 : Geometry<float, D> {
  using G = Geometry<float, D>;
  static constexpr size_t kQ = 0;
  static constexpr size_t kDO = G::kTile;
  static constexpr size_t kK = 2 * G::kTile;
  static constexpr size_t kV = 3 * G::kTile;
  static constexpr size_t kDS = 4 * G::kTile;
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
  static constexpr size_t kDelta = kLse + G::BLOCK * sizeof(float);
  static constexpr size_t kTotal = kDelta + G::BLOCK * sizeof(float);
};

// A warp's [ROWS_PER_WARP, D] f32 accumulator of products A B, with A a P
// or dS tile (pitch LDP) and B a BLOCK-row tile (pitch LDT), on the CUDA
// cores: lane (r, part) holds columns [part*DCOLS, (part+1)*DCOLS) of row r.
template <int D>
struct WarpAcc {
  using Gm = Geometry<float, D>;
  float v[Gm::DCOLS];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < Gm::DCOLS; ++j) v[j] = 0.0f;
  }
  __device__ __forceinline__ void mma(const float* A, const float* B, int r, int part) {
    for (int c = 0; c < Gm::BLOCK; ++c) {
      const float a = A[r * Gm::LDP + c];
      const float* br = B + c * Gm::LDT + part * Gm::DCOLS;
#pragma unroll
      for (int j = 0; j < Gm::DCOLS; ++j) v[j] = fmaf(a, br[j], v[j]);
    }
  }
  // Writes scale * (the lane's part of its row) to `out` when `write`.
  __device__ __forceinline__ void store(float* out, float scale, bool write) {
    if (write) {
#pragma unroll
      for (int j = 0; j < Gm::DCOLS; ++j) out[j] = v[j] * scale;
    }
  }
};

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ lse, const float* __restrict__ dout,
                        const int* __restrict__ q_lens,
                        const int* __restrict__ kv_lens, float* __restrict__ dq,
                        float* __restrict__ delta_out, int H, int Hkv, int Tq,
                        int Tk, int causal, float scale) {
  using L = SmemDqF32<D>;
  constexpr int BLOCK = L::BLOCK;
  constexpr int COLS = L::COLS;
  constexpr int RPW = L::ROWS_PER_WARP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sDO = reinterpret_cast<float*>(smem + L::kDO);
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BLOCK;
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = lane / L::LANES;
  const int part = lane % L::LANES;
  const int row = warp * RPW + r;
  const int qi = q0 + row;
  float* dsw = reinterpret_cast<float*>(smem + L::kDS) + warp * RPW * L::LDP;

  const size_t q_head = (size_t(b) * H + h) * Tq;
  const size_t kv_head = (size_t(b) * Hkv + hk) * Tk;

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + BLOCK, q_len));
  const int n_blocks = q0 < q_len ? (kv_end + BLOCK - 1) / BLOCK : 0;

  WarpAcc<D> acc;
  acc.zero();
  if (n_blocks > 0) {
    flash::load_tile<float, D>(sQ, q + q_head * D, q0, q_len);
    flash::load_tile<float, D>(sDO, dout + q_head * D, q0, q_len);
  }
  __syncthreads();

  // delta = rowsum(dO * O); the lanes of a row share it. Rows past q_len,
  // and rows of a batch row without keys (O = 0), get 0.
  const bool row_ok = qi < q_len;
  float delta = 0.0f;
  if (row_ok && n_blocks > 0) {
    const float* orow = o + (q_head + qi) * D + part * L::DCOLS;
    const float* drow = sDO + row * L::LDT + part * L::DCOLS;
#pragma unroll
    for (int j = 0; j < L::DCOLS; ++j) delta = fmaf(drow[j], orow[j], delta);
  }
  delta = flash::row_sum<L::LANES>(delta);
  if (part == 0 && qi < Tq) delta_out[q_head + qi] = delta;
  const float lse_i = row_ok ? lse[q_head + qi] : INFINITY;

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int kv0 = blk * BLOCK;
    __syncthreads();  // every warp is done with the previous K/V tile
    flash::load_tile<float, D>(sK, k + kv_head * D, kv0, kv_len);
    flash::load_tile<float, D>(sV, v + kv_head * D, kv0, kv_len);
    __syncthreads();

    float s[COLS], dp[COLS];
    warp_abt<float, D>(sQ + warp * RPW * L::LDT, sK, r, part, s);
    warp_abt<float, D>(sDO + warp * RPW * L::LDT, sV, r, part, dp);
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int kj = kv0 + part * COLS + i;
      const bool ok = row_ok && kj < kv_len && (!causal || kj <= qi);
      const float p = ok ? __expf(s[i] * scale - lse_i) : 0.0f;
      dsw[r * L::LDP + part * COLS + i] = p * (dp[i] - delta);
    }
    __syncwarp();  // dS complete before the product
    acc.mma(dsw, sK, r, part);
    __syncwarp();  // dS is rewritten by the next block
  }

  acc.store(dq + (q_head + qi) * D + part * L::DCOLS, scale, qi < Tq);
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
  constexpr int BLOCK = L::BLOCK;
  constexpr int COLS = L::COLS;
  constexpr int RPW = L::ROWS_PER_WARP;
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
  const int r = lane / L::LANES;
  const int part = lane % L::LANES;
  const int krow = warp * RPW + r;
  const int kj = k0 + krow;     // key position of the lane's row
  float* pw = reinterpret_cast<float*>(smem + L::kP) + warp * RPW * L::LDP;
  float* dsw = reinterpret_cast<float*>(smem + L::kDS) + warp * RPW * L::LDP;

  const size_t kv_head = (size_t(b) * Hkv + hk) * Tk;

  // q tiles that can see this K tile: none wholly above it (causal), none
  // wholly at or past q_len, none at all when the tile is past kv_len.
  const int qb_begin = causal ? k0 / BLOCK : 0;
  const int qb_end = k0 < kv_len ? (q_len + BLOCK - 1) / BLOCK : 0;

  WarpAcc<D> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  if (qb_begin < qb_end) {
    flash::load_tile<float, D>(sK, k + kv_head * D, k0, kv_len);
    flash::load_tile<float, D>(sV, v + kv_head * D, k0, kv_len);
  }

  for (int g = 0; g < group; ++g) {
    const size_t q_head = (size_t(b) * H + hk * group + g) * Tq;
    for (int qb = qb_begin; qb < qb_end; ++qb) {
      const int q0 = qb * BLOCK;
      __syncthreads();  // every warp is done with the previous q tile
      flash::load_tile<float, D>(sQ, q + q_head * D, q0, q_len);
      flash::load_tile<float, D>(sDO, dout + q_head * D, q0, q_len);
      if (threadIdx.x < BLOCK) {
        const int qi = q0 + threadIdx.x;
        sLse[threadIdx.x] = qi < q_len ? lse[q_head + qi] : INFINITY;
        sDelta[threadIdx.x] = qi < q_len ? delta[q_head + qi] : 0.0f;
      }
      __syncthreads();

      float s[COLS], dp[COLS];
      // transposed scores: rows are this warp's keys, columns the q rows
      warp_abt<float, D>(sK + warp * RPW * L::LDT, sQ, r, part, s);
      warp_abt<float, D>(sV + warp * RPW * L::LDT, sDO, r, part, dp);
#pragma unroll
      for (int i = 0; i < COLS; ++i) {
        const int c = part * COLS + i;
        const int qi = q0 + c;
        const bool ok = kj < kv_len && qi < q_len && (!causal || kj <= qi);
        const float p = ok ? __expf(s[i] * scale - sLse[c]) : 0.0f;
        pw[r * L::LDP + c] = p;
        dsw[r * L::LDP + c] = p * (dp[i] - sDelta[c]) * scale;
      }
      __syncwarp();  // P and dS complete before the products
      dv_acc.mma(pw, sDO, r, part);
      dk_acc.mma(dsw, sQ, r, part);
      __syncwarp();
    }
  }

  dk_acc.store(dk + (kv_head + kj) * D + part * L::DCOLS, 1.0f, kj < Tk);
  dv_acc.store(dv + (kv_head + kj) * D + part * L::DCOLS, 1.0f, kj < Tk);
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
// dK / dV, bfloat16, D = 256: dK and dV in separate CTAs
// ---------------------------------------------------------------------------

// At D = 256 one accumulator of 64 keys x 256 columns is 128 f32 registers
// a thread: a warpgroup cannot hold both dK and dV, and beside one of them
// the S^T and dP^T tiles do not fit in the 168 registers a thread that
// ptxas gives a kernel of three warpgroups. So a CTA has one consumer
// warpgroup and one producer warpgroup (255 registers a thread), takes 64
// keys, and computes either their dK (S^T and dP^T) or their dV (S^T again,
// for P^T): the two CTAs of a key tile each recompute S^T. K and V stay
// resident (32 KB each); the Q and dO tiles of 32 q rows stream through a
// ring of three stages; the result leaves through K's space.
// At D = 512 a CTA owns one half of the columns of its keys' dK or dV
// (PO = 4 of the 8 panels: still 128 registers a thread), so a key tile has
// four CTAs, each recomputing S^T (and, for dK, dP^T) over the whole width;
// K and V take 64 KB each and a ring stage holds 16 q rows.
constexpr int BK_W = 64;         // keys of a CTA
constexpr int THREADS_W = 256;   // a consumer and a producer warpgroup

template <int D_>
struct DkvWideLayout {
  static constexpr int D = D_;
  static constexpr int BQ = D == 512 ? 16 : 32;          // q rows of a ring stage
  static constexpr int P = D / hopper::PANEL_COLS;      // 4 or 8 panels
  static constexpr int HALVES = D == 512 ? 2 : 1;        // CTAs splitting the columns
  static constexpr int PO = P / HALVES;                  // output panels of a CTA
  static constexpr int kKPanel = BK_W * hopper::ROW_BYTES;
  static constexpr int kQPanel = BQ * hopper::ROW_BYTES;
  static constexpr int kK = 0;
  static constexpr int kV = kK + P * kKPanel;
  static constexpr int kQ = kV + P * kKPanel;
  static constexpr int kDO = kQ + STAGES * P * kQPanel;
  static constexpr int kLse = kDO + STAGES * P * kQPanel;
  static constexpr int kDelta = kLse + STAGES * BQ * 4;
  static constexpr int kBar = kDelta + STAGES * BQ * 4;
  static constexpr int kBytes = kBar + (1 + 2 * STAGES) * 8 + hopper::ATOM_BYTES;
};

template <int D_>
__global__ void __launch_bounds__(THREADS_W, 1)
flash_bwd_dkv_bf16_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
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
  using L = DkvWideLayout<D_>;
  constexpr int P = L::P;
  constexpr int PO = L::PO;
  constexpr int D = L::D;
  constexpr int BQ_W = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);
  float* s_lse = reinterpret_cast<float*>(smem + L::kLse);
  float* s_delta = reinterpret_cast<float*>(smem + L::kDelta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  // per key tile: dK and dV (D = 512: of each column half) in turn
  const int kind = blockIdx.z % (2 * L::HALVES);
  const bool is_dk = (kind & 1) == 0;         // the key tile's dK, else its dV
  const int p0 = (kind >> 1) * PO;            // the CTA's first output panel
  const int k0 = (blockIdx.z / (2 * L::HALVES)) * BK_W;   // first key tile (the heaviest) first
  const int group = H / Hkv;
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));
  // q tiles that can see these keys: none wholly above them (causal), none
  // wholly at or past q_len, none at all when the keys are past kv_len.
  const int qb_begin = causal ? k0 / BQ_W : 0;
  const int qb_end = k0 < kv_len ? (q_len + BQ_W - 1) / BQ_W : 0;
  const int n_qb = max(0, qb_end - qb_begin);
  const int n_iter = group * n_qb;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);                 // the producer warp's lanes
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: the first warp of the second warpgroup ----
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 128 + 32 && n_iter > 0) {
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
        const int q0 = (qb_begin + it % n_qb) * BQ_W;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        // one row of lse (times log2 e; +inf past q_len) and delta per lane
        const int qi = q0 + lane;
        const size_t row = size_t(bh) * Tq + qi;
        if (lane < BQ_W) {
          s_lse[s * BQ_W + lane] = qi < q_len ? lse[row] * LOG2E : INFINITY;
          s_delta[s * BQ_W + lane] = qi < q_len ? delta[row] : 0.0f;
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
    // ---- the consumer warpgroup: dK or dV of the 64 keys ----
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // key rows r and r + 8
    const int cq = (lane & 3) * 2;                // first q column of each pair
    const int ka = k0 + r;
    const int kb = ka + 8;
    const float scale_log2 = scale * LOG2E;
    const uint8_t* sk = smem + L::kK;
    const uint8_t* sv = smem + L::kV;

    float acc[PO][32];
#pragma unroll
    for (int p = 0; p < PO; ++p) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
    }

    if (n_iter > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % STAGES;
      const int q0 = (qb_begin + it % n_qb) * BQ_W;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const uint8_t* sq = smem + L::kQ + s * P * L::kQPanel;
      const uint8_t* sdo = smem + L::kDO + s * P * L::kQPanel;

      // S^T = K Q^T, and for dK dP^T = V dO^T
      float st[BQ_W / 2], dpt[BQ_W / 2];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int p = k / 4;
        const int kbyte = (k % 4) * 32;   // a k16 step within a 128-byte row
        wgmma_ss<BQ_W>(st, desc_sw128(sk + p * L::kKPanel + kbyte),
                       desc_sw128(sq + p * L::kQPanel + kbyte), k > 0);
      }
      if (is_dk) {
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          const int p = k / 4;
          const int kbyte = (k % 4) * 32;
          wgmma_ss<BQ_W>(dpt, desc_sw128(sv + p * L::kKPanel + kbyte),
                         desc_sw128(sdo + p * L::kQPanel + kbyte), k > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      if (is_dk) fence_regs(dpt);

      // P^T = 2^(S^T scale log2 e - lse log2 e), masked only on tiles that
      // cross kv_len or the diagonal; for dK, dS^T = P^T (dP^T - delta) scale
      const float* ls = s_lse + s * BQ_W;
      const float* dl = s_delta + s * BQ_W;
      const bool need_mask = k0 + BK_W > kv_len || (causal && q0 < k0 + BK_W - 1);
#pragma unroll
      for (int i = 0; i < BQ_W / 8; ++i) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * i + cq);
        const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * i + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lv = (e & 1) ? l2.y : l2.x;
          float p = ex2(fmaf(st[4 * i + e], scale_log2, -lv));
          if (need_mask) {
            const int kj = e < 2 ? ka : kb;
            const int qi = q0 + 8 * i + cq + (e & 1);
            if (!(kj < kv_len && (!causal || kj <= qi))) p = 0.0f;
          }
          if (is_dk) {
            const float dv_ = (e & 1) ? d2.y : d2.x;
            st[4 * i + e] = p * (dpt[4 * i + e] - dv_) * scale;
          } else {
            st[4 * i + e] = p;
          }
        }
      }

      // dK += dS^T Q, or dV += P^T dO: the bf16 A operand in registers, Q or
      // dO MN-major from the ring
      uint32_t a[BQ_W / 16][4];
      acc_to_a<BQ_W>(st, a);
      fence_regs(a);
#pragma unroll
      for (int p = 0; p < PO; ++p) fence_regs(acc[p]);
      const uint8_t* sb = is_dk ? sq : sdo;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ_W / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < PO; ++p) {
          wgmma_rs<64>(acc[p], a[kk],
                       desc_sw128(sb + (p0 + p) * L::kQPanel + kk * 16 * ROW_BYTES), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < PO; ++p) fence_regs(acc[p]);
      fence_regs(a);
      mbar_arrive(&empty[s]);
    }

    // ---- epilogue: the result through K's space (read for good) ----
    named_sync(1, 128);
    uint8_t* so = smem + L::kK;
#pragma unroll
    for (int p = 0; p < PO; ++p) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<uint32_t*>(so + p * L::kKPanel + swizzled_offset(r, 8 * i + cq)) =
            pack_bf16(acc[p][4 * i], acc[p][4 * i + 1]);
        *reinterpret_cast<uint32_t*>(so + p * L::kKPanel + swizzled_offset(r + 8, 8 * i + cq)) =
            pack_bf16(acc[p][4 * i + 2], acc[p][4 * i + 3]);
      }
    }
    fence_proxy_async();
    named_sync(1, 128);
    if (tid == 0 && k0 < Tk) {
      for (int p = 0; p < PO; ++p) {
        tma_store_3d(is_dk ? &tm_dk : &tm_dv, so + p * L::kKPanel, (p0 + p) * PANEL_COLS,
                     k0, b * Hkv + hk);
      }
      tma_store_drain();
    }
  }
}

// ---------------------------------------------------------------------------
// dQ, bfloat16: wgmma on a TMA ring
// ---------------------------------------------------------------------------

// Dynamic shared-memory layout (byte offsets from a 1024-byte boundary).
// D = 64, 128: two consumer warpgroups of 64 q rows; the O tile is read
// once for delta, and its space then stages the dQ tile. D = 256: dQ's
// accumulator is 128 f32 registers a thread, and beside it the S and dP
// tiles do not fit in the 168 registers a thread that ptxas gives a kernel
// of three warpgroups, so a CTA has one consumer warpgroup of 64 rows and
// the producer warpgroup (255 registers); delta reads O from device
// memory, dQ leaves through the Q tile's space once Q is read for good, and
// a ring stage holds 32 keys. D = 512: as D = 256, but a CTA owns half of
// dQ's columns (PO = 4 of the 8 panels, 128 registers a thread), so a q
// tile has two CTAs, each computing S and dP over the whole width; a ring
// stage holds 16 keys (Q and dO take 64 KB each).
template <int D>
struct DqLayout {
  static constexpr bool WIDE = D >= 256;
  static constexpr int CONSUMERS = WIDE ? 1 : 2;         // warpgroups of 64 rows
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  static constexpr int BQ = CONSUMERS * 64;              // q rows of a CTA
  static constexpr int P = D / hopper::PANEL_COLS;      // 64-column panels
  static constexpr int HALVES = D == 512 ? 2 : 1;        // CTAs splitting dQ's columns
  static constexpr int PO = P / HALVES;                  // dQ panels of a CTA
  static constexpr int BK = D == 512 ? 16 : D == 256 ? 32 : 64;   // keys of a ring stage
  static constexpr int STAGES = 3;
  static constexpr bool O_RESIDENT = !WIDE;
  static constexpr int kQPanel = BQ * hopper::ROW_BYTES;
  static constexpr int kKVPanel = BK * hopper::ROW_BYTES;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + P * kQPanel;
  static constexpr int kO = kDO + P * kQPanel;
  static constexpr int kK = kO + (O_RESIDENT ? P * kQPanel : 0);
  static constexpr int kV = kK + STAGES * P * kKVPanel;
  static constexpr int kBar = kV + STAGES * P * kKVPanel;
  static constexpr int kBytes = kBar + (1 + 2 * STAGES) * 8 + hopper::ATOM_BYTES;
  // where dQ is staged: the O tile, or (D >= 256) the Q tile
  static constexpr int kStage = O_RESIDENT ? kO : kQ;
};

template <int D>
__global__ void __launch_bounds__(DqLayout<D>::THREADS, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_o,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_dq,
                         const __nv_bfloat16* __restrict__ o_mem,
                         const float* __restrict__ lse,
                         float* __restrict__ delta_out,
                         const int* __restrict__ q_lens,
                         const int* __restrict__ kv_lens, int H, int Hkv,
                         int Tq, int Tk, int causal, float scale) {
  using namespace hopper;
  using L = DqLayout<D>;
  constexpr int P = L::P;
  constexpr int PO = L::PO;
  constexpr int BK = L::BK;
  constexpr int BQ = L::BQ;
  constexpr int CONSUMERS = L::CONSUMERS;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x;              // query heads of one kv head adjacent
  const int b = blockIdx.y;
  const int n_qt = (Tq + BQ - 1) / BQ;
  const int half = int(blockIdx.z) % L::HALVES;        // D = 512: the column half
  const int p0 = half * PO;                            // the CTA's first dQ panel
  const int q0 = (n_qt - 1 - int(blockIdx.z) / L::HALVES) * BQ;   // last (heaviest) first
  const int hk = h / (H / Hkv);
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));
  const bool rows_ok = q0 < q_len;
  // keys the tile needs: below kv_len and, when causal, not past its last
  // valid row
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + BQ, q_len));
  const int n_blocks = rows_ok ? (kv_end + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread ----
    if constexpr (CONSUMERS == 2) setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS * 128 && rows_ok) {
      const int bh = b * H + h;
      const int bhk = b * Hkv + hk;
      mbar_arrive_expect_tx(q_full, (L::O_RESIDENT ? 3 : 2) * P * L::kQPanel);
      for (int p = 0; p < P; ++p) {
        const int off = p * L::kQPanel;
        tma_load_3d(smem + L::kQ + off, &tm_q, q_full, p * PANEL_COLS, q0, bh);
        tma_load_3d(smem + L::kDO + off, &tm_do, q_full, p * PANEL_COLS, q0, bh);
        if constexpr (L::O_RESIDENT) {
          tma_load_3d(smem + L::kO + off, &tm_o, q_full, p * PANEL_COLS, q0, bh);
        }
      }
      for (int j = 0; j < n_blocks; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * P * L::kKVPanel);
        for (int p = 0; p < P; ++p) {
          const int off = (s * P + p) * L::kKVPanel;
          tma_load_3d(smem + L::kK + off, &tm_k, &full[s], p * PANEL_COLS,
                      j * BK, bhk);
          tma_load_3d(smem + L::kV + off, &tm_v, &full[s], p * PANEL_COLS,
                      j * BK, bhk);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    if constexpr (CONSUMERS == 2) setmaxnreg_inc<232>();
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // rows r and r + 8
    const int cq = (lane & 3) * 2;                // first key of each pair
    const int wq0 = q0 + wg * 64;
    const int qa = wq0 + r;
    const int qb = qa + 8;
    const size_t row0 = size_t(b * H + h) * Tq;
    const float scale_log2 = scale * LOG2E;
    // lse in units of log2; +inf past q_len, so that P = 0 there
    const float la = qa < q_len ? lse[row0 + qa] * LOG2E : INFINITY;
    const float lb = qb < q_len ? lse[row0 + qb] * LOG2E : INFINITY;
    // the keys this warpgroup's rows can see (causal: none past its last row)
    int wg_end = wq0 < q_len ? kv_len : 0;
    if (causal) wg_end = min(wg_end, min(wq0 + 64, q_len));
    const int n_wg = (wg_end + BK - 1) / BK;
    const uint8_t* sq = smem + L::kQ + wg * 64 * ROW_BYTES;
    const uint8_t* sdo = smem + L::kDO + wg * 64 * ROW_BYTES;
    uint8_t* so = smem + L::kStage + wg * 64 * ROW_BYTES;

    // delta = rowsum(dO * O) in f32 from the resident dO tile and the
    // resident O tile (D = 256: O's rows in device memory): a quad of
    // lanes shares rows r and r + 8, each lane every fourth 8-column chunk.
    // 0 past q_len and without keys.
    float da = 0.0f, db = 0.0f;
    if (rows_ok) mbar_wait(q_full, 0);
    if (rows_ok && kv_len > 0) {
#pragma unroll
      for (int ch = lane & 3; ch < D / 8; ch += 4) {
        const int p = ch / 8;
        const int col = (ch % 8) * 8;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t off = p * L::kQPanel + swizzled_offset(r + 8 * e, col);
          const uint4 dv4 = *reinterpret_cast<const uint4*>(sdo + off);
          uint4 ov4 = make_uint4(0u, 0u, 0u, 0u);
          if constexpr (L::O_RESIDENT) {
            ov4 = *reinterpret_cast<const uint4*>(so + off);
          } else if (qa + 8 * e < q_len) {
            ov4 = *reinterpret_cast<const uint4*>(
                o_mem + (row0 + qa + 8 * e) * D + p * PANEL_COLS + col);
          }
          const uint32_t dw[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
          const uint32_t ow[4] = {ov4.x, ov4.y, ov4.z, ov4.w};
          float acc = e == 0 ? da : db;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 d2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dw[i]));
            const float2 o2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[i]));
            acc = fmaf(d2.x, o2.x, acc);
            acc = fmaf(d2.y, o2.y, acc);
          }
          if (e == 0) da = acc; else db = acc;
        }
      }
      da += __shfl_xor_sync(0xffffffffu, da, 1);
      da += __shfl_xor_sync(0xffffffffu, da, 2);
      db += __shfl_xor_sync(0xffffffffu, db, 1);
      db += __shfl_xor_sync(0xffffffffu, db, 2);
    }
    if ((lane & 3) == 0 && half == 0) {
      if (qa < Tq) delta_out[row0 + qa] = qa < q_len ? da : 0.0f;
      if (qb < Tq) delta_out[row0 + qb] = qb < q_len ? db : 0.0f;
    }

    float dq[PO][32];
#pragma unroll
    for (int p = 0; p < PO; ++p) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[p][i] = 0.0f;
    }

    for (int j = 0; j < n_blocks; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      if (j < n_wg) {
        const uint8_t* sk = smem + L::kK + s * P * L::kKVPanel;
        const uint8_t* sv = smem + L::kV + s * P * L::kKVPanel;
        // S = Q K^T and dP = dO V^T, both operands K-major in shared memory
        float sc[BK / 2], dp[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          const int p = k / 4;
          const int kbyte = (k % 4) * 32;   // a k16 step within a 128-byte row
          wgmma_ss<BK>(sc, desc_sw128(sq + p * L::kQPanel + kbyte),
                       desc_sw128(sk + p * L::kKVPanel + kbyte), k > 0);
        }
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
          const int p = k / 4;
          const int kbyte = (k % 4) * 32;
          wgmma_ss<BK>(dp, desc_sw128(sdo + p * L::kQPanel + kbyte),
                       desc_sw128(sv + p * L::kKVPanel + kbyte), k > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // P = 2^(S scale log2 e - lse log2 e), dS = P (dP - delta), masked
        // only on tiles that cross kv_len or the diagonal
        const int kv0 = j * BK;
        const bool need_mask = kv0 + BK > kv_len || (causal && kv0 + BK - 1 > wq0);
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool upper = e < 2;
            float p = ex2(fmaf(sc[4 * i + e], scale_log2, -(upper ? la : lb)));
            if (need_mask) {
              const int kj = kv0 + 8 * i + cq + (e & 1);
              const int qi = upper ? qa : qb;
              if (!(kj < kv_len && (!causal || kj <= qi))) p = 0.0f;
            }
            dp[4 * i + e] = p * (dp[4 * i + e] - (upper ? da : db));
          }
        }

        // dQ += dS K: dS rounded to bf16 as the register A operand, K
        // MN-major (the instruction transposes it, as V in the forward's PV)
        uint32_t dsa[BK / 16][4];
        acc_to_a<BK>(dp, dsa);
        fence_regs(dsa);
#pragma unroll
        for (int p = 0; p < PO; ++p) fence_regs(dq[p]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int p = 0; p < PO; ++p) {
            wgmma_rs<64>(dq[p], dsa[kk],
                         desc_sw128(sk + (p0 + p) * L::kKVPanel + kk * 16 * ROW_BYTES), 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < PO; ++p) fence_regs(dq[p]);
        fence_regs(dsa);
      }
      mbar_arrive(&empty[s]);
    }

    // ---- epilogue: scale * dQ into the O (D >= 256: Q) tile's space, out
    // by TMA ----
    named_sync(1 + wg, 128);   // every thread of the warpgroup has read O
#pragma unroll
    for (int p = 0; p < PO; ++p) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<uint32_t*>(so + p * L::kQPanel + swizzled_offset(r, 8 * i + cq)) =
            pack_bf16(dq[p][4 * i] * scale, dq[p][4 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(so + p * L::kQPanel + swizzled_offset(r + 8, 8 * i + cq)) =
            pack_bf16(dq[p][4 * i + 2] * scale, dq[p][4 * i + 3] * scale);
      }
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);
    if (tid == 0 && wq0 < Tq) {
      for (int p = 0; p < PO; ++p) {
        tma_store_3d(&tm_dq, so + p * L::kQPanel, (p0 + p) * PANEL_COLS, wq0, b * H + h);
      }
      tma_store_drain();
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16, D > 512: the head width as a loop count
// ---------------------------------------------------------------------------

// Above 512 the resident 64-row tiles of the D = 512 kernels (Q and dO, or
// K and V) no longer fit beside a ring in 227 KB, and half of an output's
// columns is more than 128 f32 a thread. So, as in the forward's panel
// kernel, the width is a loop count: a CTA owns 64 rows of its output (dQ:
// q rows; dK or dV: keys) and one group of up to 256 of its columns
// (PANELS_GP panels, the grid's fastest dimension), and per streamed block
// of PANELS_BK rows (dQ: keys; dK/dV: q rows):
//   * sums S (and dP) over the D / 64 panels: a ring of PANELS_STAGES
//     stages, each holding the panel of the CTA's own rows (Q and dO, or K
//     and V) and of the block's rows (K and V, or Q and dO) by TMA; wgmma
//     with both operands in shared memory, a stage released once the next
//     panel's products are issued and its own are done;
//   * forms P and dS in registers (lse and delta as the D <= 512 kernels
//     use them), masked only on blocks that cross kv_len or the diagonal;
//   * adds dS K_g (dQ), dS^T Q_g (dK) or P^T dO_g (dV) with the bf16 A
//     operand in registers and the group's panels, streamed through the
//     same ring, as the MN-major B operand.
// dQ computes delta = rowsum(dO * O) over the whole width from device
// memory (group 0 writes it); a key tile has a dK and a dV CTA per group,
// each recomputing S^T (and, for dK, dP^T). Every group recomputes S and dP
// over the width (at 640: three groups, at 1024: four); one S shared
// through a thread-block cluster is the later redesign. 255 registers a
// thread: an output group 128, S and dP 16 each, dS 8.
constexpr int PANELS_GP = 4;         // 64-column panels of a column group
constexpr int PANELS_BK = 32;        // rows of a streamed block
constexpr int PANELS_STAGES = 4;     // ring depth
constexpr int THREADS_PANELS = 256;  // a consumer and a producer warpgroup

struct PanelsLayout {
  static constexpr int kA = 64 * hopper::ROW_BYTES;          // a panel of the CTA's rows
  static constexpr int kB = PANELS_BK * hopper::ROW_BYTES;   // a panel of a block's rows
  // a stage: [A0 | A1 | B0 | B1]
  static constexpr int kA1 = kA;
  static constexpr int kB0 = 2 * kA;
  static constexpr int kB1 = 2 * kA + kB;
  static constexpr int kStage = 2 * (kA + kB);
  static constexpr int kOut = PANELS_STAGES * kStage;        // the output's staging panels
  static constexpr int kBar = kOut + PANELS_GP * kA;
  static constexpr int kBytes = kBar + 2 * PANELS_STAGES * 8 + hopper::ATOM_BYTES;
};

// The grid of a panel kernel: (column group, head) in x, the group
// fastest; the batch row in y.
struct PanelsGrid {
  int P, G, g, head, pg0, np;
  __device__ __forceinline__ PanelsGrid(int D, int x) {
    P = D / hopper::PANEL_COLS;
    G = (P + PANELS_GP - 1) / PANELS_GP;
    g = x % G;
    head = x / G;
    pg0 = g * PANELS_GP;
    np = min(PANELS_GP, P - pg0);
  }
};

// Sums S (and, when `two`, a second product) over the width: P stages of
// the ring, from stage counter `it` on; a stage is released once the next
// panel's products are issued and its own have completed.
template <int N>
__device__ __forceinline__ void panels_sum(float (&s0)[N / 2], float (&s1)[N / 2],
                                           bool two, int P, uint8_t* ring,
                                           uint64_t* full, uint64_t* empty, int& it) {
  using namespace hopper;
  using L = PanelsLayout;
  int prev = 0;
  for (int p = 0; p < P; ++p, ++it) {
    const int s = it % PANELS_STAGES;
    const uint8_t* st = ring + s * L::kStage;
    mbar_wait(&full[s], (it / PANELS_STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_ss<N>(s0, desc_sw128(st + k * 32), desc_sw128(st + L::kB0 + k * 32),
                  (p | k) != 0);
    }
    if (two) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_ss<N>(s1, desc_sw128(st + L::kA1 + k * 32),
                    desc_sw128(st + L::kB1 + k * 32), (p | k) != 0);
      }
    }
    wgmma_commit();
    if (p > 0) {
      wgmma_wait<1>();
      mbar_arrive(&empty[prev]);
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs(s0);
  if (two) fence_regs(s1);
  mbar_arrive(&empty[prev]);
}

// acc[p] += A B_p for the group's np panels, each the B0 panel of the next
// ring stage (MN-major, PANELS_BK rows), A the bf16 register operand.
__device__ __forceinline__ void panels_accumulate(float (&acc)[PANELS_GP][32],
                                                  uint32_t (&a)[PANELS_BK / 16][4],
                                                  int np, uint8_t* ring,
                                                  uint64_t* full, uint64_t* empty,
                                                  int& it) {
  using namespace hopper;
  using L = PanelsLayout;
  fence_regs(a);
#pragma unroll
  for (int p = 0; p < PANELS_GP; ++p) {
    if (p < np) {
      const int s = it % PANELS_STAGES;
      mbar_wait(&full[s], (it / PANELS_STAGES) & 1);
      const uint8_t* sb = ring + s * L::kStage + L::kB0;
      fence_regs(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PANELS_BK / 16; ++kk) {
        wgmma_rs<64>(acc[p], a[kk], desc_sw128(sb + kk * 16 * ROW_BYTES), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[p]);
      mbar_arrive(&empty[s]);
      ++it;
    }
  }
  fence_regs(a);
}

// The output group (64 rows, np panels, times `scale`) through the staging
// panels and TMA stores at (pg0 + p) * 64, row0 of matrix `mat`.
__device__ __forceinline__ void panels_store(const float (&acc)[PANELS_GP][32],
                                             float scale, int np, int pg0,
                                             const CUtensorMap* map, int row0,
                                             int mat, uint8_t* so) {
  using namespace hopper;
  using L = PanelsLayout;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = (tid >> 5) * 16 + (lane >> 2);
  const int cq = (lane & 3) * 2;
#pragma unroll
  for (int p = 0; p < PANELS_GP; ++p) {
    if (p < np) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<uint32_t*>(so + p * L::kA + swizzled_offset(r, 8 * i + cq)) =
            pack_bf16(acc[p][4 * i] * scale, acc[p][4 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(so + p * L::kA + swizzled_offset(r + 8, 8 * i + cq)) =
            pack_bf16(acc[p][4 * i + 2] * scale, acc[p][4 * i + 3] * scale);
      }
    }
  }
  fence_proxy_async();
  named_sync(1, 128);
  if (tid == 0) {
    for (int p = 0; p < np; ++p) {
      tma_store_3d(map, so + p * L::kA, (pg0 + p) * PANEL_COLS, row0, mat);
    }
    tma_store_drain();
  }
}

__global__ void __launch_bounds__(THREADS_PANELS, 1)
flash_bwd_dq_bf16_panels_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_do,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_dq,
                                const __nv_bfloat16* __restrict__ o_mem,
                                const __nv_bfloat16* __restrict__ do_mem,
                                const float* __restrict__ lse,
                                float* __restrict__ delta_out,
                                const int* __restrict__ q_lens,
                                const int* __restrict__ kv_lens, int H, int Hkv,
                                int Tq, int Tk, int D, int causal, float scale) {
  using namespace hopper;
  using L = PanelsLayout;
  constexpr int BK = PANELS_BK;
  constexpr int STAGES = PANELS_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + STAGES;

  const PanelsGrid w(D, blockIdx.x);
  const int h = w.head;
  const int b = blockIdx.y;
  const int n_qt = (Tq + 63) / 64;
  const int q0 = (n_qt - 1 - int(blockIdx.z)) * 64;   // last (heaviest) first
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + 64, q_len));
  const int n_blocks = q0 < q_len ? (kv_end + BK - 1) / BK : 0;
  const int bh = b * H + h;
  const int bhk = b * Hkv + h / (H / Hkv);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: per key block P stages of (Q_p, dO_p, K_p, V_p), then
    // the group's np K panels ----
    if (threadIdx.x == 128) {
      int it = 0;
      for (int j = 0; j < n_blocks; ++j) {
        for (int p = 0; p < w.P + w.np; ++p, ++it) {
          const int s = it % STAGES;
          uint8_t* st = smem + s * L::kStage;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          if (p < w.P) {
            mbar_arrive_expect_tx(&full[s], L::kStage);
            tma_load_3d(st, &tm_q, &full[s], p * PANEL_COLS, q0, bh);
            tma_load_3d(st + L::kA1, &tm_do, &full[s], p * PANEL_COLS, q0, bh);
            tma_load_3d(st + L::kB0, &tm_k, &full[s], p * PANEL_COLS, j * BK, bhk);
            tma_load_3d(st + L::kB1, &tm_v, &full[s], p * PANEL_COLS, j * BK, bhk);
          } else {
            mbar_arrive_expect_tx(&full[s], L::kB);
            tma_load_3d(st + L::kB0, &tm_k, &full[s], (w.pg0 + p - w.P) * PANEL_COLS,
                        j * BK, bhk);
          }
        }
      }
    }
  } else {
    // ---- consumer: the tile's 64 q rows, dQ's columns of the group ----
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // rows r and r + 8
    const int cq = (lane & 3) * 2;                // first key of each pair
    const int qa = q0 + r;
    const int qb = qa + 8;
    const size_t row0 = size_t(bh) * Tq;
    const float scale_log2 = scale * LOG2E;
    // lse in units of log2; +inf past q_len, so that P = 0 there
    const float la = qa < q_len ? lse[row0 + qa] * LOG2E : INFINITY;
    const float lb = qb < q_len ? lse[row0 + qb] * LOG2E : INFINITY;

    // delta = rowsum(dO * O) in f32 over the whole width, from device
    // memory: a quad of lanes shares rows r and r + 8, each lane every
    // fourth 8-column chunk. 0 past q_len and without keys.
    float da = 0.0f, db = 0.0f;
    if (n_blocks > 0) {
      for (int ch = lane & 3; ch < D / 8; ch += 4) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = qa + 8 * e;
          if (qi >= q_len) continue;
          const size_t off = (row0 + qi) * D + ch * 8;
          const uint4 dv4 = *reinterpret_cast<const uint4*>(do_mem + off);
          const uint4 ov4 = *reinterpret_cast<const uint4*>(o_mem + off);
          const uint32_t dw[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
          const uint32_t ow[4] = {ov4.x, ov4.y, ov4.z, ov4.w};
          float acc = e == 0 ? da : db;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 d2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dw[i]));
            const float2 o2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[i]));
            acc = fmaf(d2.x, o2.x, acc);
            acc = fmaf(d2.y, o2.y, acc);
          }
          if (e == 0) da = acc; else db = acc;
        }
      }
      da += __shfl_xor_sync(0xffffffffu, da, 1);
      da += __shfl_xor_sync(0xffffffffu, da, 2);
      db += __shfl_xor_sync(0xffffffffu, db, 1);
      db += __shfl_xor_sync(0xffffffffu, db, 2);
    }
    if ((lane & 3) == 0 && w.g == 0) {
      if (qa < Tq) delta_out[row0 + qa] = qa < q_len ? da : 0.0f;
      if (qb < Tq) delta_out[row0 + qb] = qb < q_len ? db : 0.0f;
    }

    float dq[PANELS_GP][32];
#pragma unroll
    for (int p = 0; p < PANELS_GP; ++p) {
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[p][i] = 0.0f;
    }

    int it = 0;
    for (int j = 0; j < n_blocks; ++j) {
      // S = sum_p Q_p K_p^T and dP = sum_p dO_p V_p^T
      float sc[BK / 2], dp[BK / 2];
      panels_sum<BK>(sc, dp, true, w.P, smem, full, empty, it);

      // P = 2^(S scale log2 e - lse log2 e), dS = P (dP - delta), masked
      // only on blocks that cross kv_len or the diagonal
      const int kv0 = j * BK;
      const bool need_mask = kv0 + BK > kv_len || (causal && kv0 + BK - 1 > q0);
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool upper = e < 2;
          float p = ex2(fmaf(sc[4 * i + e], scale_log2, -(upper ? la : lb)));
          if (need_mask) {
            const int kj = kv0 + 8 * i + cq + (e & 1);
            const int qi = upper ? qa : qb;
            if (!(kj < kv_len && (!causal || kj <= qi))) p = 0.0f;
          }
          dp[4 * i + e] = p * (dp[4 * i + e] - (upper ? da : db));
        }
      }

      // dQ_g += dS K_g
      uint32_t dsa[BK / 16][4];
      acc_to_a<BK>(dp, dsa);
      panels_accumulate(dq, dsa, w.np, smem, full, empty, it);
    }

    // ---- epilogue: scale * dQ_g ----
    panels_store(dq, scale, w.np, w.pg0, &tm_dq, q0, bh, smem + L::kOut);
  }
}

__global__ void __launch_bounds__(THREADS_PANELS, 1)
flash_bwd_dkv_bf16_panels_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_do,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const __grid_constant__ CUtensorMap tm_dk,
                                 const __grid_constant__ CUtensorMap tm_dv,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 const int* __restrict__ q_lens,
                                 const int* __restrict__ kv_lens, int H, int Hkv,
                                 int Tq, int Tk, int D, int causal, float scale) {
  using namespace hopper;
  using L = PanelsLayout;
  constexpr int BQ = PANELS_BK;
  constexpr int STAGES = PANELS_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + STAGES;

  // x: (kv head, column group, dK or dV), dK/dV fastest, then the group
  const bool is_dk = (blockIdx.x & 1) == 0;
  const PanelsGrid w(D, blockIdx.x >> 1);
  const int hk = w.head;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * 64;        // first key tile (the heaviest) first
  const int group = H / Hkv;
  const int bhk = b * Hkv + hk;
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));
  // q blocks that can see these keys: none wholly above them (causal), none
  // wholly at or past q_len, none at all when the keys are past kv_len.
  const int qb_begin = causal ? k0 / BQ : 0;
  const int qb_end = k0 < kv_len ? (q_len + BQ - 1) / BQ : 0;
  const int n_qb = max(0, qb_end - qb_begin);
  const int n_iter = group * n_qb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: per q block P stages of (K_p, V_p, Q_p, dO_p) (dV: K_p
    // and Q_p), then the group's np Q (dV: dO) panels ----
    if (threadIdx.x == 128) {
      int it = 0;
      for (int itq = 0; itq < n_iter; ++itq) {
        const int bh = b * H + hk * group + itq / n_qb;
        const int q0 = (qb_begin + itq % n_qb) * BQ;
        for (int p = 0; p < w.P + w.np; ++p, ++it) {
          const int s = it % STAGES;
          uint8_t* st = smem + s * L::kStage;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          if (p < w.P) {
            mbar_arrive_expect_tx(&full[s], is_dk ? L::kStage : L::kA + L::kB);
            tma_load_3d(st, &tm_k, &full[s], p * PANEL_COLS, k0, bhk);
            tma_load_3d(st + L::kB0, &tm_q, &full[s], p * PANEL_COLS, q0, bh);
            if (is_dk) {
              tma_load_3d(st + L::kA1, &tm_v, &full[s], p * PANEL_COLS, k0, bhk);
              tma_load_3d(st + L::kB1, &tm_do, &full[s], p * PANEL_COLS, q0, bh);
            }
          } else {
            mbar_arrive_expect_tx(&full[s], L::kB);
            tma_load_3d(st + L::kB0, is_dk ? &tm_q : &tm_do, &full[s],
                        (w.pg0 + p - w.P) * PANEL_COLS, q0, bh);
          }
        }
      }
    }
  } else {
    // ---- consumer: the tile's 64 keys, dK's or dV's columns of the group ----
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // key rows r and r + 8
    const int cq = (lane & 3) * 2;                // first q column of each pair
    const int ka = k0 + r;
    const int kb = ka + 8;
    const float scale_log2 = scale * LOG2E;

    float acc[PANELS_GP][32];
#pragma unroll
    for (int p = 0; p < PANELS_GP; ++p) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
    }

    int it = 0;
    for (int itq = 0; itq < n_iter; ++itq) {
      const size_t rowq = size_t(b * H + hk * group + itq / n_qb) * Tq;
      const int q0 = (qb_begin + itq % n_qb) * BQ;
      // S^T = sum_p K_p Q_p^T, and for dK dP^T = sum_p V_p dO_p^T
      float st[BQ / 2], dpt[BQ / 2];
      panels_sum<BQ>(st, dpt, is_dk, w.P, smem, full, empty, it);

      // P^T = 2^(S^T scale log2 e - lse log2 e) with lse per column, masked
      // only on blocks that cross kv_len or the diagonal; for dK,
      // dS^T = P^T (dP^T - delta) scale
      const bool need_mask = k0 + 64 > kv_len || (causal && q0 < k0 + 63);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + 8 * i + cq + (e & 1);
          const float lv = qi < q_len ? lse[rowq + qi] * LOG2E : INFINITY;
          float p = ex2(fmaf(st[4 * i + e], scale_log2, -lv));
          if (need_mask) {
            const int kj = e < 2 ? ka : kb;
            if (!(kj < kv_len && (!causal || kj <= qi))) p = 0.0f;
          }
          if (is_dk) {
            const float dl = qi < q_len ? delta[rowq + qi] : 0.0f;
            st[4 * i + e] = p * (dpt[4 * i + e] - dl) * scale;
          } else {
            st[4 * i + e] = p;
          }
        }
      }

      // dK_g += dS^T Q_g, or dV_g += P^T dO_g
      uint32_t a[BQ / 16][4];
      acc_to_a<BQ>(st, a);
      panels_accumulate(acc, a, w.np, smem, full, empty, it);
    }

    // ---- epilogue ----
    panels_store(acc, 1.0f, w.np, w.pg0, is_dk ? &tm_dk : &tm_dv, k0, bhk,
                 smem + L::kOut);
  }
}

// ---------------------------------------------------------------------------
// float32, D > 512: the scalar path over column chunks
// ---------------------------------------------------------------------------

// 16-row tiles (flash_common.cuh's `panels` geometry): a CTA owns 16 rows of
// its output and a group of up to 256 of its columns, sums S and dP over
// the width chunk by chunk (64 columns of each operand in shared memory at
// a time) and adds the product with the group's columns of its B operand,
// loaded as one tile.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_panels_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ o,
                               const float* __restrict__ lse,
                               const float* __restrict__ dout,
                               const int* __restrict__ q_lens,
                               const int* __restrict__ kv_lens, float* __restrict__ dq,
                               float* __restrict__ delta_out, int H, int Hkv, int Tq,
                               int Tk, int D, int causal, float scale) {
  using namespace flash::panels;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sDO = reinterpret_cast<float*>(smem + kChunk);
  float* sK = reinterpret_cast<float*>(smem + 2 * kChunk);
  float* sV = reinterpret_cast<float*>(smem + 3 * kChunk);
  float* sKg = reinterpret_cast<float*>(smem + 4 * kChunk);
  float* sDS = reinterpret_cast<float*>(smem + 4 * kChunk + kGroup);

  const int G = (D + NG - 1) / NG;
  const int g = int(blockIdx.x) % G;
  const int h = int(blockIdx.x) / G;
  const int b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.z * BLOCK;
  const int c_g = g * NG;
  const int ng = min(NG, D - c_g);
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = lane / LANES;
  const int part = lane % LANES;
  const int qi = q0 + warp * RPW + r;
  float* dsw = sDS + warp * RPW * LDP;
  const size_t q_head = (size_t(b) * H + h) * Tq;
  const float* qh = q + q_head * D;
  const float* doh = dout + q_head * D;
  const float* kh = k + (size_t(b) * Hkv + hk) * Tk * D;
  const float* vh = v + (size_t(b) * Hkv + hk) * Tk * D;

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + BLOCK, q_len));
  const int n_blocks = q0 < q_len ? (kv_end + BLOCK - 1) / BLOCK : 0;

  // delta = rowsum(dO * O) over the width; the lanes of a row share it.
  // Rows past q_len, and rows of a batch row without keys, get 0.
  const bool row_ok = qi < q_len;
  float delta = 0.0f;
  if (row_ok && n_blocks > 0) {
    const float* orow = o + (q_head + qi) * D;
    const float* drow = doh + size_t(qi) * D;
    for (int d = part; d < D; d += LANES) delta = fmaf(drow[d], orow[d], delta);
  }
  delta = flash::row_sum<LANES>(delta);
  if (part == 0 && qi < Tq && g == 0) delta_out[q_head + qi] = delta;
  const float lse_i = row_ok ? lse[q_head + qi] : INFINITY;

  Acc acc;
  acc.zero();
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int kv0 = blk * BLOCK;
    float s[COLS], dp[COLS];
#pragma unroll
    for (int i = 0; i < COLS; ++i) s[i] = dp[i] = 0.0f;
    for (int c0 = 0; c0 < D; c0 += CW) {
      __syncthreads();  // every warp is done with the previous chunk (and K_g)
      load_cols<CW, LDC>(sQ, qh, D, q0, q_len, c0, CW);
      load_cols<CW, LDC>(sDO, doh, D, q0, q_len, c0, CW);
      load_cols<CW, LDC>(sK, kh, D, kv0, kv_len, c0, CW);
      load_cols<CW, LDC>(sV, vh, D, kv0, kv_len, c0, CW);
      __syncthreads();
      abt_chunk(sQ + warp * RPW * LDC, sK, r, part, s);
      abt_chunk(sDO + warp * RPW * LDC, sV, r, part, dp);
    }
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int kj = kv0 + part * COLS + i;
      const bool ok = row_ok && kj < kv_len && (!causal || kj <= qi);
      const float p = ok ? __expf(s[i] * scale - lse_i) : 0.0f;
      dsw[r * LDP + part * COLS + i] = p * (dp[i] - delta);
    }
    __syncthreads();  // dS complete; every warp is done with the chunks
    load_cols<NG, LDG>(sKg, kh, D, kv0, kv_len, c_g, ng);
    __syncthreads();
    acc.mma(dsw, sKg, r, part);
  }

  acc.store(dq + (q_head + qi) * D + c_g, scale, ng, part, qi < Tq);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_panels_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                const float* __restrict__ dout,
                                const int* __restrict__ q_lens,
                                const int* __restrict__ kv_lens, float* __restrict__ dk,
                                float* __restrict__ dv, int H, int Hkv, int Tq, int Tk,
                                int D, int causal, float scale) {
  using namespace flash::panels;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = reinterpret_cast<float*>(smem + kChunk);
  float* sQ = reinterpret_cast<float*>(smem + 2 * kChunk);
  float* sDO = reinterpret_cast<float*>(smem + 3 * kChunk);
  float* sQg = reinterpret_cast<float*>(smem + 4 * kChunk);
  float* sDOg = reinterpret_cast<float*>(smem + 4 * kChunk + kGroup);
  float* sP = reinterpret_cast<float*>(smem + 4 * kChunk + 2 * kGroup);
  float* sDS = reinterpret_cast<float*>(smem + 4 * kChunk + 2 * kGroup + kWarpP);
  float* sLse = reinterpret_cast<float*>(smem + 4 * kChunk + 2 * kGroup + 2 * kWarpP);
  float* sDelta = sLse + BLOCK;

  const int G = (D + NG - 1) / NG;
  const int g = int(blockIdx.x) % G;
  const int hk = int(blockIdx.x) / G;
  const int b = blockIdx.y;
  const int group = H / Hkv;
  const int k0 = blockIdx.z * BLOCK;
  const int c_g = g * NG;
  const int ng = min(NG, D - c_g);
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = lane / LANES;
  const int part = lane % LANES;
  const int kj = k0 + warp * RPW + r;     // key position of the lane's row
  float* pw = sP + warp * RPW * LDP;
  float* dsw = sDS + warp * RPW * LDP;
  const size_t kv_head = (size_t(b) * Hkv + hk) * Tk;
  const float* kh = k + kv_head * D;
  const float* vh = v + kv_head * D;

  // q blocks that can see these keys: none wholly above them (causal), none
  // wholly at or past q_len, none at all when the keys are past kv_len.
  const int qb_begin = causal ? k0 / BLOCK : 0;
  const int qb_end = k0 < kv_len ? (q_len + BLOCK - 1) / BLOCK : 0;

  Acc dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  for (int gh = 0; gh < group; ++gh) {
    const size_t q_head = (size_t(b) * H + hk * group + gh) * Tq;
    const float* qh = q + q_head * D;
    const float* doh = dout + q_head * D;
    for (int qb = qb_begin; qb < qb_end; ++qb) {
      const int q0 = qb * BLOCK;
      __syncthreads();  // every warp is done with the previous block
      if (threadIdx.x < BLOCK) {
        const int qi = q0 + threadIdx.x;
        sLse[threadIdx.x] = qi < q_len ? lse[q_head + qi] : INFINITY;
        sDelta[threadIdx.x] = qi < q_len ? delta[q_head + qi] : 0.0f;
      }
      float s[COLS], dp[COLS];
#pragma unroll
      for (int i = 0; i < COLS; ++i) s[i] = dp[i] = 0.0f;
      for (int c0 = 0; c0 < D; c0 += CW) {
        __syncthreads();
        load_cols<CW, LDC>(sK, kh, D, k0, kv_len, c0, CW);
        load_cols<CW, LDC>(sV, vh, D, k0, kv_len, c0, CW);
        load_cols<CW, LDC>(sQ, qh, D, q0, q_len, c0, CW);
        load_cols<CW, LDC>(sDO, doh, D, q0, q_len, c0, CW);
        __syncthreads();
        // transposed scores: rows are this warp's keys, columns the q rows
        abt_chunk(sK + warp * RPW * LDC, sQ, r, part, s);
        abt_chunk(sV + warp * RPW * LDC, sDO, r, part, dp);
      }
#pragma unroll
      for (int i = 0; i < COLS; ++i) {
        const int c = part * COLS + i;
        const int qi = q0 + c;
        const bool ok = kj < kv_len && qi < q_len && (!causal || kj <= qi);
        const float p = ok ? __expf(s[i] * scale - sLse[c]) : 0.0f;
        pw[r * LDP + c] = p;
        dsw[r * LDP + c] = p * (dp[i] - sDelta[c]) * scale;
      }
      __syncthreads();  // P and dS complete; every warp is done with the chunks
      load_cols<NG, LDG>(sQg, qh, D, q0, q_len, c_g, ng);
      load_cols<NG, LDG>(sDOg, doh, D, q0, q_len, c_g, ng);
      __syncthreads();
      dv_acc.mma(pw, sDOg, r, part);
      dk_acc.mma(dsw, sQg, r, part);
    }
  }

  dk_acc.store(dk + (kv_head + kj) * D + c_g, 1.0f, ng, part, kj < Tk);
  dv_acc.store(dv + (kv_head + kj) * D + c_g, 1.0f, ng, part, kj < Tk);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* o, const void* lse, const void* dout,
                          const void* q_lens, const void* kv_lens, void* dq,
                          void* delta, int B, int H, int Hkv, int Tq, int Tk,
                          int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_f32_kernel<D>;
  const int bytes = int(SmemDqF32<D>::kTotal);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  constexpr int BLOCK = SmemDqF32<D>::BLOCK;
  const dim3 grid((Tq + BLOCK - 1) / BLOCK, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<const int*>(q_lens), static_cast<const int*>(kv_lens),
      static_cast<float*>(dq), static_cast<float*>(delta), H, Hkv, Tq, Tk, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v,
                           const void* o, const void* lse, const void* dout,
                           const void* q_lens, const void* kv_lens, void* dq,
                           void* delta, int B, int H, int Hkv, int Tq, int Tk,
                           int causal, float scale, cudaStream_t stream) {
  using L = DqLayout<D>;
  CUtensorMap tq, tdo, to, tk, tv, tdq;
  if (!hopper::make_tmap_bf16(&tq, q, B * H, Tq, D, L::BQ) ||
      !hopper::make_tmap_bf16(&tdo, dout, B * H, Tq, D, L::BQ) ||
      !hopper::make_tmap_bf16(&to, o, B * H, Tq, D, L::BQ) ||
      !hopper::make_tmap_bf16(&tk, k, B * Hkv, Tk, D, DqLayout<D>::BK) ||
      !hopper::make_tmap_bf16(&tv, v, B * Hkv, Tk, D, DqLayout<D>::BK) ||
      !hopper::make_tmap_bf16(&tdq, dq, B * H, Tq, D, 64)) {
    return cudaErrorNotSupported;
  }
  auto kernel = flash_bwd_dq_bf16_kernel<D>;
  const int bytes = DqLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_qt = (Tq + L::BQ - 1) / L::BQ;
  if (n_qt * L::HALVES > 65535) return cudaErrorInvalidValue;
  const dim3 grid(H, B, n_qt * L::HALVES);
  kernel<<<grid, L::THREADS, bytes, stream>>>(
      tq, tdo, to, tk, tv, tdq, static_cast<const __nv_bfloat16*>(o),
      static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<const int*>(q_lens),
      static_cast<const int*>(kv_lens), H, Hkv, Tq, Tk, causal, scale);
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
  constexpr int BLOCK = SmemDkvF32<D>::BLOCK;
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

template <int D>
cudaError_t launch_dkv_bf16_wide(const void* q, const void* k, const void* v,
                                 const void* lse, const void* delta,
                                 const void* dout, const void* q_lens,
                                 const void* kv_lens, void* dk, void* dv, int B,
                                 int H, int Hkv, int Tq, int Tk, int causal,
                                 float scale, cudaStream_t stream) {
  using L = DkvWideLayout<D>;
  CUtensorMap tq, tdo, tk, tv, tdk, tdv;
  if (!hopper::make_tmap_bf16(&tq, q, B * H, Tq, L::D, L::BQ) ||
      !hopper::make_tmap_bf16(&tdo, dout, B * H, Tq, L::D, L::BQ) ||
      !hopper::make_tmap_bf16(&tk, k, B * Hkv, Tk, L::D, BK_W) ||
      !hopper::make_tmap_bf16(&tv, v, B * Hkv, Tk, L::D, BK_W) ||
      !hopper::make_tmap_bf16(&tdk, dk, B * Hkv, Tk, L::D, BK_W) ||
      !hopper::make_tmap_bf16(&tdv, dv, B * Hkv, Tk, L::D, BK_W)) {
    return cudaErrorNotSupported;
  }
  auto kernel = flash_bwd_dkv_bf16_wide_kernel<D>;
  const int bytes = L::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_kt = (Tk + BK_W - 1) / BK_W;
  constexpr int kinds = 2 * L::HALVES;        // dK and dV CTAs per key tile
  if (kinds * n_kt > 65535) return cudaErrorInvalidValue;
  const dim3 grid(Hkv, B, kinds * n_kt);
  kernel<<<grid, THREADS_W, bytes, stream>>>(
      tq, tdo, tk, tv, tdk, tdv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(q_lens),
      static_cast<const int*>(kv_lens), H, Hkv, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_dq_bf16_panels(const void* q, const void* k, const void* v,
                                  const void* o, const void* lse, const void* dout,
                                  const void* q_lens, const void* kv_lens, void* dq,
                                  void* delta, int B, int H, int Hkv, int Tq, int Tk,
                                  int D, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv, tdq;
  if (!hopper::make_tmap_bf16(&tq, q, B * H, Tq, D, 64) ||
      !hopper::make_tmap_bf16(&tdo, dout, B * H, Tq, D, 64) ||
      !hopper::make_tmap_bf16(&tk, k, B * Hkv, Tk, D, PANELS_BK) ||
      !hopper::make_tmap_bf16(&tv, v, B * Hkv, Tk, D, PANELS_BK) ||
      !hopper::make_tmap_bf16(&tdq, dq, B * H, Tq, D, 64)) {
    return cudaErrorNotSupported;
  }
  auto kernel = flash_bwd_dq_bf16_panels_kernel;
  const int bytes = PanelsLayout::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long G = (D / hopper::PANEL_COLS + PANELS_GP - 1) / PANELS_GP;
  const int n_qt = (Tq + 63) / 64;
  if (n_qt > 65535 || G * H >= (1ll << 31)) return cudaErrorInvalidValue;
  const dim3 grid(unsigned(G * H), B, n_qt);
  kernel<<<grid, THREADS_PANELS, bytes, stream>>>(
      tq, tdo, tk, tv, tdq, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<const int*>(q_lens),
      static_cast<const int*>(kv_lens), H, Hkv, Tq, Tk, D, causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv_bf16_panels(const void* q, const void* k, const void* v,
                                   const void* lse, const void* delta,
                                   const void* dout, const void* q_lens,
                                   const void* kv_lens, void* dk, void* dv, int B,
                                   int H, int Hkv, int Tq, int Tk, int D, int causal,
                                   float scale, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv, tdk, tdv;
  if (!hopper::make_tmap_bf16(&tq, q, B * H, Tq, D, PANELS_BK) ||
      !hopper::make_tmap_bf16(&tdo, dout, B * H, Tq, D, PANELS_BK) ||
      !hopper::make_tmap_bf16(&tk, k, B * Hkv, Tk, D, 64) ||
      !hopper::make_tmap_bf16(&tv, v, B * Hkv, Tk, D, 64) ||
      !hopper::make_tmap_bf16(&tdk, dk, B * Hkv, Tk, D, 64) ||
      !hopper::make_tmap_bf16(&tdv, dv, B * Hkv, Tk, D, 64)) {
    return cudaErrorNotSupported;
  }
  auto kernel = flash_bwd_dkv_bf16_panels_kernel;
  const int bytes = PanelsLayout::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long G = (D / hopper::PANEL_COLS + PANELS_GP - 1) / PANELS_GP;
  const int n_kt = (Tk + 63) / 64;
  if (n_kt > 65535 || 2 * G * Hkv >= (1ll << 31)) return cudaErrorInvalidValue;
  const dim3 grid(unsigned(2 * G * Hkv), B, n_kt);
  kernel<<<grid, THREADS_PANELS, bytes, stream>>>(
      tq, tdo, tk, tv, tdk, tdv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(q_lens),
      static_cast<const int*>(kv_lens), H, Hkv, Tq, Tk, D, causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_dq_f32_panels(const void* q, const void* k, const void* v,
                                 const void* o, const void* lse, const void* dout,
                                 const void* q_lens, const void* kv_lens, void* dq,
                                 void* delta, int B, int H, int Hkv, int Tq, int Tk,
                                 int D, int causal, float scale, cudaStream_t stream) {
  using namespace flash::panels;
  auto kernel = flash_bwd_dq_f32_panels_kernel;
  const int bytes = 4 * kChunk + kGroup + kWarpP;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long G = (D + NG - 1) / NG;
  const int n_qt = (Tq + BLOCK - 1) / BLOCK;
  if (n_qt > 65535 || G * H >= (1ll << 31)) return cudaErrorInvalidValue;
  const dim3 grid(unsigned(G * H), B, n_qt);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<const int*>(q_lens), static_cast<const int*>(kv_lens),
      static_cast<float*>(dq), static_cast<float*>(delta), H, Hkv, Tq, Tk, D,
      causal, scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv_f32_panels(const void* q, const void* k, const void* v,
                                  const void* lse, const void* delta,
                                  const void* dout, const void* q_lens,
                                  const void* kv_lens, void* dk, void* dv, int B,
                                  int H, int Hkv, int Tq, int Tk, int D, int causal,
                                  float scale, cudaStream_t stream) {
  using namespace flash::panels;
  auto kernel = flash_bwd_dkv_f32_panels_kernel;
  const int bytes = 4 * kChunk + 2 * kGroup + 2 * kWarpP + 2 * BLOCK * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long G = (D + NG - 1) / NG;
  const int n_kt = (Tk + BLOCK - 1) / BLOCK;
  if (n_kt > 65535 || G * Hkv >= (1ll << 31)) return cudaErrorInvalidValue;
  const dim3 grid(unsigned(G * Hkv), B, n_kt);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(dout),
      static_cast<const int*>(q_lens), static_cast<const int*>(kv_lens),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, Tq, Tk, D, causal,
      scale);
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
// is_f32: 0 for bfloat16 operands, 1 for float32. D must be 64, 128, 256 or
// 512 (ops/attention.py runs the widths between them on zero-padded
// operands) or any multiple of 64 above 512 (the panel kernels, which take
// the width at run time).
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
  if (D > 512 && D % 64 == 0) {
    return int((is_f32 ? launch_dq_f32_panels : launch_dq_bf16_panels)(
        q, k, v, o, lse, dout, q_lens, kv_lens, dq, delta, B, H, Hkv, Tq, Tk, D,
        causal, scale, s));
  }
#define AVSR_DQ(FN, DD)                                                \
  return int(FN<DD>(q, k, v, o, lse, dout, q_lens, kv_lens, dq, delta, B, \
                    H, Hkv, Tq, Tk, causal, scale, s))
  if (is_f32) {
    if (D == 64) AVSR_DQ(launch_dq_f32, 64);
    if (D == 128) AVSR_DQ(launch_dq_f32, 128);
    if (D == 256) AVSR_DQ(launch_dq_f32, 256);
    if (D == 512) AVSR_DQ(launch_dq_f32, 512);
  } else {
    if (D == 64) AVSR_DQ(launch_dq_bf16, 64);
    if (D == 128) AVSR_DQ(launch_dq_bf16, 128);
    if (D == 256) AVSR_DQ(launch_dq_bf16, 256);
    if (D == 512) AVSR_DQ(launch_dq_bf16, 512);
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
  if (D > 512 && D % 64 == 0) {
    return int((is_f32 ? launch_dkv_f32_panels : launch_dkv_bf16_panels)(
        q, k, v, lse, delta, dout, q_lens, kv_lens, dk, dv, B, H, Hkv, Tq, Tk, D,
        causal, scale, s));
  }
#define AVSR_DKV(FN, DD)                                                \
  return int(FN<DD>(q, k, v, lse, delta, dout, q_lens, kv_lens, dk, dv, \
                    B, H, Hkv, Tq, Tk, causal, scale, s))
  if (is_f32) {
    if (D == 64) AVSR_DKV(launch_dkv_f32, 64);
    if (D == 128) AVSR_DKV(launch_dkv_f32, 128);
    if (D == 256) AVSR_DKV(launch_dkv_f32, 256);
    if (D == 512) AVSR_DKV(launch_dkv_f32, 512);
  } else {
    if (D == 64) AVSR_DKV(launch_dkv_bf16, 64);
    if (D == 128) AVSR_DKV(launch_dkv_bf16, 128);
    if (D == 256) AVSR_DKV(launch_dkv_bf16_wide, 256);
    if (D == 512) AVSR_DKV(launch_dkv_bf16_wide, 512);
  }
#undef AVSR_DKV
  return int(cudaErrorInvalidValue);
}
