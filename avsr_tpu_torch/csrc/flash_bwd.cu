// Flash-attention backward for NVIDIA Hopper (sm_90a), CUDA C++ with a plain
// C interface (loaded through ctypes by avsr_tpu_torch/ops/attention.py).
//
// Two kernels, the ports of the Pallas TPU kernels that
// avsr_tpu/ops/attention.py::_flash_core_bwd launches:
//   flash_bwd_dq_kernel   <- _flash_bwd_dq_kernel  (attention.py:181)
//   flash_bwd_dkv_kernel  <- _flash_bwd_dkv_kernel (attention.py:241)
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
// unconstrained).
//
// Bound on the card, at the train step's shape (B=8, q [8,32,672,64], k/v
// [8,8,672,64] bf16 causal, 581 valid rows, 4.33e7 valid pairs): dQ does
// 6*D flops per pair (1.66e10 -> 16.8 us at 989 TFLOP/s) and reads the valid
// rows of q, k, v, dO, O and lse once and writes all of dQ once (89.3 MB ->
// 26.6 us at 3.35 TB/s); dK/dV does 8*D flops per pair (2.22e10 -> 22.4 us)
// and moves 78.3 MB with all of dK and dV (23.4 us). Both are bound by
// bytes, closely followed by operations (chip_smoke.py::attn_bounds).
// What the design does about it: S, P, dP and dS never leave the chip, each
// output tile has one owner (no atomics, so gradients are deterministic
// from run to run), all five products per tile run on the tensor cores
// (wmma 16x16x16 bf16, f32 accumulators held in registers across the
// loop), and tiles past the causal diagonal, past kv_len and past q_len are
// skipped. Like the forward, this first version uses neither wgmma nor TMA
// nor a pipelined ring, so it stays well short of the bound.
//
// Layout. Both kernels run 4 warps over 64-row tiles; a warp owns 16 rows
// of the CTA's own tile, and lane pair (2r, 2r+1) owns row r of the warp's
// 16, each lane one half (32 columns) of a 64-wide score row.
//   dQ:    one CTA per (b, q head, 64-row q tile); it loops over the K/V
//          tiles of kv head h / (H / Hkv).
//   dK/dV: one CTA per (b, kv head, 64-row K/V tile); it loops over every
//          q tile of all H / Hkv query heads of its group, computing the
//          transposed scores S^T = K Q^T so that its rows are its own keys.
// float32 inputs take the same path with scalar FMAs instead of wmma.

#include <math.h>
#include <mma.h>

#include "flash_common.cuh"

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

// dK/dV kernel shared memory: K, V, Q, dO tiles, scratch, P, dS, lse, delta.
template <typename T, int D>
struct SmemDkv : Geometry<T, D> {
  using G = Geometry<T, D>;
  static constexpr size_t kK = 0;
  static constexpr size_t kV = G::kTile;
  static constexpr size_t kQ = 2 * G::kTile;
  static constexpr size_t kDO = 3 * G::kTile;
  static constexpr size_t kS = 4 * G::kTile;
  static constexpr size_t kP = kS + G::kScratch;
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
                    const int* __restrict__ kv_lens, T* __restrict__ dq, int H,
                    int Hkv, int Tq, int Tk, int causal, float scale) {
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

  // delta = rowsum(dO * O) in f32; the lane pair shares the row.
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
// dK / dV
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const float* __restrict__ lse, const T* __restrict__ dout,
                     const int* __restrict__ q_lens,
                     const int* __restrict__ kv_lens, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Hkv, int Tq, int Tk,
                     int causal, float scale) {
  using L = SmemDkv<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sDO = reinterpret_cast<T*>(smem + L::kDO);
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
  float* scratch = reinterpret_cast<float*>(smem + L::kS) +
                   warp * ROWS_PER_WARP * L::LDS;
  T* pw = reinterpret_cast<T*>(smem + L::kP) + warp * ROWS_PER_WARP * L::LDP;
  T* dsw = reinterpret_cast<T*>(smem + L::kDS) + warp * ROWS_PER_WARP * L::LDP;

  const size_t kv_head = (size_t(b) * Hkv + hk) * Tk;

  // q tiles that can see this K tile: none wholly above it (causal), none
  // wholly at or past q_len, none at all when the tile is past kv_len.
  const int qb_begin = causal ? k0 / BLOCK : 0;
  const int qb_end = k0 < kv_len ? (q_len + BLOCK - 1) / BLOCK : 0;

  WarpAcc<T, D> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  if (qb_begin < qb_end) {
    flash::load_tile<T, D, L::LDT>(sK, k + kv_head * D, k0, kv_len);
    flash::load_tile<T, D, L::LDT>(sV, v + kv_head * D, k0, kv_len);
  }

  for (int g = 0; g < group; ++g) {
    const size_t q_head = (size_t(b) * H + hk * group + g) * Tq;
    for (int qb = qb_begin; qb < qb_end; ++qb) {
      const int q0 = qb * BLOCK;
      __syncthreads();  // every warp is done with the previous q tile
      flash::load_tile<T, D, L::LDT>(sQ, q + q_head * D, q0, q_len);
      flash::load_tile<T, D, L::LDT>(sDO, dout + q_head * D, q0, q_len);
      __syncthreads();
      {
        // lse and delta = rowsum(dO * O) of the tile's 64 rows, two
        // threads per row
        const int tr = threadIdx.x >> 1;
        const int th = threadIdx.x & 1;
        const int qi = q0 + tr;
        float delta = 0.0f;
        if (qi < q_len) {
          const T* orow = o + (q_head + qi) * D + th * (D / 2);
          const T* drow = sDO + tr * L::LDT + th * (D / 2);
#pragma unroll
          for (int j = 0; j < D / 2; ++j) {
            delta = fmaf(float(drow[j]), float(orow[j]), delta);
          }
        }
        delta += __shfl_xor_sync(0xffffffffu, delta, 1);
        if (th == 0) {
          sDelta[tr] = delta;
          sLse[tr] = qi < q_len ? lse[q_head + qi] : INFINITY;
        }
      }
      __syncthreads();

      float s[HALF], dp[HALF];
      // transposed scores: rows are this warp's keys, columns the q rows
      warp_abt<T, D>(sK + warp * ROWS_PER_WARP * L::LDT, sQ, scratch, r, half, s);
      warp_abt<T, D>(sV + warp * ROWS_PER_WARP * L::LDT, sDO, scratch, r, half, dp);
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const int c = half * HALF + i;
        const int qi = q0 + c;
        const bool ok = kj < kv_len && qi < q_len && (!causal || kj <= qi);
        const float p = ok ? __expf(s[i] * scale - sLse[c]) : 0.0f;
        pw[r * L::LDP + c] = from_float<T>(p);
        dsw[r * L::LDP + c] = from_float<T>(p * (dp[i] - sDelta[c]) * scale);
      }
      __syncwarp();  // P and dS complete before the products
      dv_acc.mma(pw, sDO, r, half);
      dk_acc.mma(dsw, sQ, r, half);
      __syncwarp();
    }
  }

  dk_acc.store(dk + (kv_head + kj) * D + half * (D / 2), 1.0f, scratch, r,
               half, kj < Tk);
  dv_acc.store(dv + (kv_head + kj) * D + half * (D / 2), 1.0f, scratch, r,
               half, kj < Tk);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* lse, const void* dout,
                      const void* q_lens, const void* kv_lens, void* dq, int B,
                      int H, int Hkv, int Tq, int Tk, int causal, float scale,
                      cudaStream_t stream) {
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
      static_cast<T*>(dq), H, Hkv, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* o, const void* lse, const void* dout,
                       const void* q_lens, const void* kv_lens, void* dk,
                       void* dv, int B, int H, int Hkv, int Tq, int Tk,
                       int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  const int bytes = int(SmemDkv<T, D>::kTotal);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tk + BLOCK - 1) / BLOCK, Hkv, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<const int*>(q_lens), static_cast<const int*>(kv_lens),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Hkv, int Tq, int Tk) {
  return B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Tq <= 0 || Tk <= 0 ||
         B > 65535 || H > 65535;
}

}  // namespace

// Both return 0 on success, else the cudaError_t of the failed call (each
// launch is checked with cudaGetLastError right after it is enqueued).
// is_f32: 0 for bfloat16 operands, 1 for float32. D must be 64 or 128.
// q, dout, o, dq: [B, H, Tq, D]; k, v, dk, dv: [B, Hkv, Tk, D]; lse:
// [B, H, Tq] float32; q_lens, kv_lens: [B] int32. All contiguous.
extern "C" int avsr_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* o, const void* lse,
                                 const void* dout, const void* q_lens,
                                 const void* kv_lens, void* dq, int B, int H,
                                 int Hkv, int Tq, int Tk, int D, int is_f32,
                                 int causal, float scale, void* stream) {
  if (bad_shape(B, H, Hkv, Tq, Tk)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AVSR_DQ(T, DD)                                                       \
  return int(launch_dq<T, DD>(q, k, v, o, lse, dout, q_lens, kv_lens, dq, B, \
                              H, Hkv, Tq, Tk, causal, scale, s))
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
                                  const void* o, const void* lse,
                                  const void* dout, const void* q_lens,
                                  const void* kv_lens, void* dk, void* dv,
                                  int B, int H, int Hkv, int Tq, int Tk, int D,
                                  int is_f32, int causal, float scale,
                                  void* stream) {
  if (bad_shape(B, H, Hkv, Tq, Tk)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AVSR_DKV(T, DD)                                                    \
  return int(launch_dkv<T, DD>(q, k, v, o, lse, dout, q_lens, kv_lens, dk, \
                               dv, B, H, Hkv, Tq, Tk, causal, scale, s))
  if (is_f32) {
    if (D == 64) AVSR_DKV(float, 64);
    if (D == 128) AVSR_DKV(float, 128);
  } else {
    if (D == 64) AVSR_DKV(__nv_bfloat16, 64);
    if (D == 128) AVSR_DKV(__nv_bfloat16, 128);
  }
#undef AVSR_DKV
  return int(cudaErrorInvalidValue);
}
