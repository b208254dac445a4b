// Flash-attention forward for NVIDIA Hopper (sm_90a), CUDA C++ with a plain
// C interface (loaded through ctypes by avsr_tpu_torch/ops/attention.py).
//
// Replaces the Pallas TPU kernel avsr_tpu/ops/attention.py::_flash_fwd_kernel
// (launched by _fwd_call, reached through flash_attention and attention()).
// It computes, per (batch row, query head):
//   O   = softmax(Q K^T * scale, masked) V        [B, H, Tq, D], input dtype
//   lse = logsumexp(Q K^T * scale, masked)         [B, H, Tq],    float32
// The mask keeps key j for query row i iff j < kv_len[b] and, when causal,
// j <= i (top-left aligned; causal needs Tq == Tk). GQA: query head h reads
// kv head h / (H / Hkv); K/V are never repeated. Rows at or past q_len[b],
// and rows with no valid key, get O = 0 and lse = +inf (the TPU kernel
// returns mean(V) for the latter; the port follows mha_reference).
//
// Bound on the card. FLOPs are 4*B*H*Tq*Tk*D (halved when causal); bytes are
// q + k + v + O + lse, each once. On the serving path (B=8, D=64, bf16):
//   Whisper  [8,16,512,64] non-causal, 500 valid rows: 8.2 GFLOP -> 8.3 us
//            at 989 TFLOP/s; 33.8 MB -> 10.1 us at 3.35 TB/s.
//   LLM      q [8,32,533,64], k/v [8,8,533,64] causal: 9.3 GFLOP -> 9.4 us;
//            44.2 MB -> 13.2 us.
// Both are bound by bytes, closely followed by operations, so the kernel
// has to stream each operand once and keep the tensor cores busy.
// What the design does about it: S and P never leave the chip (they live in
// registers and shared memory), K/V are read once per query tile instead of
// once per query row, both products run on the tensor cores (wmma
// 16x16x16 bf16 with f32 accumulators), and tiles past the causal diagonal,
// past kv_len and wholly past q_len are skipped. This first version uses
// neither wgmma nor TMA nor a pipelined K/V ring, so it stays well short of
// the bound; those are the next steps.
//
// Layout of one CTA: 64 query rows of one (b, h); 4 warps of 16 rows each.
// K/V tiles of 64 rows are staged in shared memory. Each warp computes its
// 16x64 score tile with wmma into f32 scratch; then lane pair (2r, 2r+1)
// owns row r, each lane 32 of its 64 scores, for the online softmax in f32;
// P is written to shared memory in the value dtype (as the TPU kernel casts
// p before its PV product) and PV runs on wmma again; the O accumulator of
// a row lives in its lane pair's registers (D/2 floats per lane). float32
// inputs take the same path with scalar FMAs instead of wmma.

#include <math.h>
#include <mma.h>

#include "flash_common.cuh"

namespace {

using flash::from_float;
using flash::HALF;
using flash::ROWS_PER_WARP;
using flash::THREADS;
using flash::WARPS;
constexpr int BLOCK_Q = flash::BLOCK;
constexpr int BLOCK_K = flash::BLOCK;

// Dynamic shared-memory layout (byte offsets), shared by host and device:
// Q, K, V tiles, the warps' f32 scratch, the warps' P tiles.
template <typename T, int D>
struct Smem : flash::Geometry<T, D> {
  using G = flash::Geometry<T, D>;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = G::kTile;
  static constexpr size_t kV = 2 * G::kTile;
  static constexpr size_t kS = 3 * G::kTile;
  static constexpr size_t kP = kS + G::kScratch;
  static constexpr size_t kTotal = kP + G::kWarpP;
};

// P V for the warp's 16 rows on the tensor cores, into f32 scratch [16, D].
template <int D>
__device__ __forceinline__ void pv_wmma(const __nv_bfloat16* pw,
                                        const __nv_bfloat16* sV,
                                        float* scratch) {
  using namespace nvcuda;
  constexpr int LDT = Smem<__nv_bfloat16, D>::LDT;
  constexpr int LDP = Smem<__nv_bfloat16, D>::LDP;
  constexpr int LDS = Smem<__nv_bfloat16, D>::LDS;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
      wmma::load_matrix_sync(a, pw + kk * 16, LDP);
      wmma::load_matrix_sync(b, sV + kk * 16 * LDT + n * 16, LDT);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(scratch + n * 16, c, LDS, wmma::mem_row_major);
  }
  __syncwarp();
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_lens,
                 const int* __restrict__ kv_lens, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Tq, int Tk,
                 int causal, float scale) {
  using L = Smem<T, D>;
  constexpr int DH = D / 2;          // output columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  T* sP = reinterpret_cast<T*>(smem + L::kP);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BLOCK_Q;
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1;      // row within the warp's 16
  const int half = lane & 1;    // which half of the row this lane owns
  const int row = warp * ROWS_PER_WARP + r;
  const int qi = q0 + row;      // query position
  T* pw = sP + warp * ROWS_PER_WARP * L::LDP;
  float* scratch = reinterpret_cast<float*>(smem + L::kS) +
                   warp * ROWS_PER_WARP * L::LDS;

  const size_t q_head = (size_t(b) * H + h) * Tq;     // row offsets
  const size_t kv_head = (size_t(b) * Hkv + hk) * Tk;

  // Keys this tile needs: below kv_len and, when causal, not past its last
  // valid row. A tile wholly at or past q_len runs no block at all.
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + BLOCK_Q, q_len));
  const int n_blocks = q0 < q_len ? (kv_end + BLOCK_K - 1) / BLOCK_K : 0;

  float acc[DH];
#pragma unroll
  for (int j = 0; j < DH; ++j) acc[j] = 0.0f;
  float m_i = -INFINITY;
  float l_i = 0.0f;

  if (n_blocks > 0) flash::load_tile<T, D, L::LDT>(sQ, q + q_head * D, q0, q_len);

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int kv0 = blk * BLOCK_K;
    __syncthreads();  // every warp is done with the previous K/V tile
    flash::load_tile<T, D, L::LDT>(sK, k + kv_head * D, kv0, kv_len);
    flash::load_tile<T, D, L::LDT>(sV, v + kv_head * D, kv0, kv_len);
    __syncthreads();

    float s[HALF];
    flash::warp_abt<T, D>(sQ + warp * ROWS_PER_WARP * L::LDT, sK, scratch, r,
                          half, s);

    // Online softmax in f32; the lane pair shares the row's max and sum.
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const int kj = kv0 + half * HALF + i;
      const bool ok = kj < kv_len && (!causal || kj <= qi);
      s[i] = ok ? s[i] * scale : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    // A row with no valid key so far keeps m = -inf; exponentiate against 0
    // so that exp(-inf - m) is 0 rather than NaN.
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;
    const float alpha = __expf(m_i - m_use);
    float rs = 0.0f;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float p = __expf(s[i] - m_use);
      rs += p;
      pw[r * L::LDP + half * HALF + i] = from_float<T>(p);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l_i = l_i * alpha + rs;
    m_i = m_new;
#pragma unroll
    for (int j = 0; j < DH; ++j) acc[j] *= alpha;
    __syncwarp();  // P complete (and the score scratch read) before PV

    if constexpr (L::kWmma) {
      pv_wmma<D>(pw, sV, scratch);
#pragma unroll
      for (int j = 0; j < DH; ++j) acc[j] += scratch[r * L::LDS + half * DH + j];
    } else {
      for (int c = 0; c < BLOCK_K; ++c) {
        const float p = pw[r * L::LDP + c];
        const T* vr = sV + c * L::LDT + half * DH;
#pragma unroll
        for (int j = 0; j < DH; ++j) acc[j] = fmaf(p, vr[j], acc[j]);
      }
    }
    __syncwarp();  // scratch and P are rewritten by the next block
  }

  if (qi < Tq) {
    const bool valid = qi < q_len && l_i > 0.0f;
    const float inv = valid ? 1.0f / l_i : 0.0f;
    T* orow = o + (q_head + qi) * D + half * DH;
#pragma unroll
    for (int j = 0; j < DH; ++j) orow[j] = from_float<T>(acc[j] * inv);
    if (half == 0) lse[q_head + qi] = valid ? m_i + logf(l_i) : INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* q_lens, const void* kv_lens, void* o, void* lse,
                   int B, int H, int Hkv, int Tq, int Tk, int causal,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  const int bytes = int(Smem<T, D>::kTotal);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BLOCK_Q - 1) / BLOCK_Q, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(q_lens),
      static_cast<const int*>(kv_lens), static_cast<T*>(o),
      static_cast<float*>(lse), H, Hkv, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 on success, else the cudaError_t of the failed call (the launch
// is checked with cudaGetLastError right after it is enqueued).
// is_f32: 0 for bfloat16 operands, 1 for float32. D must be 64 or 128.
extern "C" int avsr_flash_fwd(const void* q, const void* k, const void* v,
                              const void* q_lens, const void* kv_lens, void* o,
                              void* lse, int B, int H, int Hkv, int Tq, int Tk,
                              int D, int is_f32, int causal, float scale,
                              void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Tq <= 0 || Tk <= 0 ||
      B > 65535 || H > 65535) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    if (D == 64)
      return int(launch<float, 64>(q, k, v, q_lens, kv_lens, o, lse, B, H, Hkv,
                                   Tq, Tk, causal, scale, s));
    if (D == 128)
      return int(launch<float, 128>(q, k, v, q_lens, kv_lens, o, lse, B, H,
                                    Hkv, Tq, Tk, causal, scale, s));
  } else {
    if (D == 64)
      return int(launch<__nv_bfloat16, 64>(q, k, v, q_lens, kv_lens, o, lse, B,
                                           H, Hkv, Tq, Tk, causal, scale, s));
    if (D == 128)
      return int(launch<__nv_bfloat16, 128>(q, k, v, q_lens, kv_lens, o, lse,
                                            B, H, Hkv, Tq, Tk, causal, scale,
                                            s));
  }
  return int(cudaErrorInvalidValue);
}
