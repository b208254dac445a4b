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
// Bound on the card. FLOPs are 4*D per valid (row, key) pair; bytes are the
// valid rows of q, k, v read once plus all of O and lse written once
// (chip_smoke.py::attn_bounds). At the main path's shapes (B=8, D=64, bf16):
//   Whisper  [8,16,512,64] non-causal, 500 valid rows: 8.2 GFLOP -> 8.3 us
//            at 989 TFLOP/s; 33.2 MB -> 9.9 us at 3.35 TB/s.
//   LLM      q [8,32,533,64], k/v [8,8,533,64] causal: 9.3 GFLOP -> 9.4 us;
//            44.2 MB -> 13.2 us.
//   train    q [8,32,672,64] causal, 581 valid rows: 15.3 us by bytes.
//   connector q = k = v [8,8,500,256] non-causal (the attention and
//            adaptive connectors: 8 heads over the 2048-wide LLM, on the
//            500 rows Whisper returns): 16.4 GFLOP -> 16.6 us; 65.7 MB ->
//            19.6 us.
// All are bound by bytes, closely followed by operations, so the kernel has
// to stream each operand once and keep the tensor cores busy.
//
// bfloat16 design (flash_fwd_bf16_kernel). A tile is 128 query rows of one
// (b, h). The CTAs are persistent, one per SM, and walk a shared tile list
// (CTA c takes tiles c, c + #SMs, ...) whose order puts the last q tile
// first, so that the heaviest causal tiles start first, and keeps the query
// heads of one kv head next to each other, so that they read its K/V from
// L2 (at most 172 KB per kv head at the main path's shapes). A CTA has three
// warpgroups:
//   * a producer warpgroup (40 registers a thread after setmaxnreg), one
//     thread of which issues the TMA loads: each tile's Q into one buffer
//     (once the consumers have released the previous tile's), and the K
//     and V tiles (128 keys for D = 64, 64 for D = 128) into a ring of
//     three stages. "full" mbarriers count the TMA bytes, "empty" ones the
//     consumer threads that are done. The ring runs on across tiles, so the
//     next tile's loads overlap the current tile's last blocks and epilogue.
//     At D = 256 (64 keys a tile) Q is 64 KB and a stage 64 KB, and there is
//     no room for a separate O tile within the 227 KB a block may use: the
//     ring has two stages, and each consumer warpgroup stages its O in its
//     own 64 rows of the Q tile, so the next tile's Q load waits for the
//     epilogue's store (Q is released then, not after the last block).
//   * two consumer warpgroups (232 registers) of 64 query rows each. Per
//     K/V tile: S = Q K^T by wgmma m64n128k16 (m64n64k16 for D = 128) with
//     both operands in shared memory and the f32 accumulators in
//     registers; the mask (kj < kv_len, kj <= qi when causal; only on the
//     last tiles, which cross kv_len or the diagonal) before the
//     exponential, so P is exactly 0 there; online softmax in f32 in the
//     accumulator layout (a row lives in a quad of lanes, its max is
//     reduced by two shuffles, its sum once at the end) with the MUFU's
//     2^x; P rounded to bf16 in registers (as the TPU kernel casts p before
//     PV) as the register A operand of O += P V (wgmma m64n64k16 per
//     64-column panel of V, which is MN-major, so the instruction
//     transposes it). S and P never touch shared memory.
//   * Epilogue: O / l into a swizzled shared tile and out by one TMA store
//     (rows past Tq are clipped by the tensor map), lse as plain f32.
// Tensor maps are 3-D over [B*H, Tq, D] and [B*Hkv, Tk, D] with 128-byte
// swizzle, so a tile past Tq or Tk arrives as zeros and never as the next
// head's rows; keys between kv_len and Tk arrive as they are and are masked.
// Blocks past the causal diagonal and tiles wholly past q_len are never
// loaded.
//
// Registers: a consumer thread holds O (D / 2 f32: 128 at D = 256), the
// scores of a K/V tile (32) and P as bf16 (16), within the 168 registers a
// thread that ptxas gives a kernel of three warpgroups; no D spills.
//
// float32 inputs take the first design's scalar path (flash_fwd_f32_kernel):
// 64-row tiles (32 at D = 256, whose 64-row f32 tiles would take 203 KB),
// 4 warps, the lanes of a row (2, or 4 at D = 256) each owning a part of its
// scores and of its output, FMAs on the CUDA cores. avsr_flash_fwd
// dispatches on the dtype.

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16: wgmma on a TMA ring
// ---------------------------------------------------------------------------

constexpr int BM = 128;          // query rows of a CTA
constexpr int CONSUMERS = 2;     // consumer warpgroups, 64 query rows each
constexpr int THREADS_BF16 = (CONSUMERS + 1) * 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Dynamic shared-memory layout (byte offsets from a 1024-byte boundary).
template <int D>
struct Layout {
  // keys of a K/V tile: 128 for D = 64; 64 for D = 128 and 256, whose O
  // accumulators are two and four times as large, so that scores, P and O
  // stay in registers
  static constexpr int BN = D == 64 ? 128 : 64;
  // K/V ring depth: two stages at D = 256, where a stage is 64 KB
  static constexpr int STAGES = D == 256 ? 2 : 3;
  // D = 256 has no room for an O staging tile: a warpgroup stages its O in
  // its own 64 rows of the Q tile, which the next tile's Q load then waits
  // for (Q is released after the epilogue's store, not after the last
  // block)
  static constexpr bool O_IN_Q = D == 256;
  static constexpr int P = D / hopper::PANEL_COLS;      // 64-column panels
  static constexpr int kQPanel = BM * hopper::ROW_BYTES;
  static constexpr int kKVPanel = BN * hopper::ROW_BYTES;
  static constexpr int kOPanel = 64 * hopper::ROW_BYTES;  // one warpgroup's rows
  // the stride between a warpgroup's O panels
  static constexpr int kOStride = O_IN_Q ? kQPanel : kOPanel;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + P * kQPanel;
  static constexpr int kV = kK + STAGES * P * kKVPanel;
  static constexpr int kO = kV + STAGES * P * kKVPanel;
  static constexpr int kBar = kO + (O_IN_Q ? 0 : CONSUMERS * P * kOPanel);
  static constexpr int kBytes = kBar + (2 + 2 * STAGES) * 8 + hopper::ATOM_BYTES;
  // warpgroup wg's first O panel: at kOBase + wg * kOWarpgroup
  static constexpr int kOBase = O_IN_Q ? kQ : kO;
  static constexpr int kOWarpgroup = O_IN_Q ? 64 * hopper::ROW_BYTES : P * kOPanel;
};

// One tile of work: 128 query rows of one (b, h), and the K/V tiles it
// reads.
struct Tile {
  int b, h, q0, q_len, kv_len, n_blocks;
};

// Tile t of the list the persistent CTAs share: the q tile in the slowest
// position, last first (the heaviest causal tiles start first), then the
// batch row, then the head, so that the query heads of one kv head are
// neighbours and read the same K/V from L2.
template <int BN>
__device__ __forceinline__ Tile tile_at(int t, int B, int H, int Tq, int Tk,
                                        int causal,
                                        const int* __restrict__ q_lens,
                                        const int* __restrict__ kv_lens) {
  const int n_qt = (Tq + BM - 1) / BM;
  Tile w;
  w.q0 = (n_qt - 1 - t / (B * H)) * BM;
  w.b = (t % (B * H)) / H;
  w.h = t % H;
  w.q_len = max(0, min(q_lens[w.b], Tq));
  w.kv_len = max(0, min(kv_lens[w.b], Tk));
  // Keys the tile needs: below kv_len and, when causal, not past its last
  // valid row. A tile wholly at or past q_len loads nothing.
  int kv_end = w.kv_len;
  if (causal) kv_end = min(kv_end, min(w.q0 + BM, w.q_len));
  w.n_blocks = w.q0 < w.q_len ? (kv_end + BN - 1) / BN : 0;
  return w;
}

// Issues S = Q K^T of one K/V tile for a warpgroup's 64 query rows (one
// wgmma per k16 step; the caller fences, commits and waits).
template <int D, int BN>
__device__ __forceinline__ void issue_s(float (&sc)[BN / 2], const uint8_t* sq,
                                        const uint8_t* sk) {
  constexpr int kQPanel = BM * hopper::ROW_BYTES;
  constexpr int kKVPanel = BN * hopper::ROW_BYTES;
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const int p = k / 4;
    const int kb = (k % 4) * 32;   // bytes of a k16 step within a row
    hopper::wgmma_ss<BN>(sc, hopper::desc_sw128(sq + p * kQPanel + kb),
                         hopper::desc_sw128(sk + p * kKVPanel + kb), k > 0);
  }
}

// The online-softmax state of a thread's two rows: running max (in units of
// log2, already scaled), partial sums (the thread's columns only), and the
// factors that rescale O for the latest block.
struct Softmax {
  float m0, m1, l0, l1, al0, al1;
};

// Masks one block of scores (keys kv0.. of rows qa, qb) with the kernel's
// rule when MASK, updates the running max and sums, and leaves
// P = exp(S - max) in `sc` (f32).
template <int BN, bool MASK>
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], Softmax& sm,
                                               int kv0, int kv_len, int qa,
                                               int qb, int causal,
                                               float scale_log2) {
  const int cq = (threadIdx.x & 3) * 2;
  if constexpr (MASK) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = kv0 + 8 * i + cq + (e & 1);
        const int qi = e < 2 ? qa : qb;
        if (!(kj < kv_len && (!causal || kj <= qi))) sc[4 * i + e] = -INFINITY;
      }
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(sm.m0, mx0 * scale_log2);
  const float mn1 = fmaxf(sm.m1, mx1 * scale_log2);
  // A row with no valid key so far keeps m = -inf; exponentiate against 0
  // so that exp(-inf - m) is 0 rather than NaN.
  const float mu0 = mn0 == -INFINITY ? 0.0f : mn0;
  const float mu1 = mn1 == -INFINITY ? 0.0f : mn1;
  sm.al0 = hopper::ex2(sm.m0 - mu0);
  sm.al1 = hopper::ex2(sm.m1 - mu1);
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    sc[4 * i] = hopper::ex2(fmaf(sc[4 * i], scale_log2, -mu0));
    sc[4 * i + 1] = hopper::ex2(fmaf(sc[4 * i + 1], scale_log2, -mu0));
    sc[4 * i + 2] = hopper::ex2(fmaf(sc[4 * i + 2], scale_log2, -mu1));
    sc[4 * i + 3] = hopper::ex2(fmaf(sc[4 * i + 3], scale_log2, -mu1));
    rs0 += sc[4 * i] + sc[4 * i + 1];
    rs1 += sc[4 * i + 2] + sc[4 * i + 3];
  }
  sm.l0 = sm.l0 * sm.al0 + rs0;
  sm.l1 = sm.l1 * sm.al1 + rs1;
  sm.m0 = mn0;
  sm.m1 = mn1;
}

template <int D>
__global__ void __launch_bounds__(THREADS_BF16, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o,
                      const int* __restrict__ q_lens,
                      const int* __restrict__ kv_lens, float* __restrict__ lse,
                      int B, int H, int Hkv, int Tq, int Tk, int causal,
                      float scale_log2) {
  using namespace hopper;
  using L = Layout<D>;
  constexpr int P = L::P;
  constexpr int BN = L::BN;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_empty = q_full + 1;
  uint64_t* kv_full = q_full + 2;
  uint64_t* kv_empty = kv_full + STAGES;
  const int n_tiles = (Tq + BM - 1) / BM * B * H;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS * 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The CTAs are persistent: CTA c takes tiles c, c + gridDim.x, ... The
  // ring's stage and phase run on across tiles (kv_it counts the K/V tiles
  // loaded, q_it the Q tiles), so the producer loads the next tile's Q and
  // K/V while the consumers finish the current one.
  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      int kv_it = 0, q_it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile w = tile_at<BN>(t, B, H, Tq, Tk, causal, q_lens, kv_lens);
        // every consumer is done with Q: after the last block, or, when O
        // is staged in Q, after every tile's epilogue (a tile without
        // blocks writes its zeros there too)
        if constexpr (L::O_IN_Q) mbar_wait(q_empty, (q_it++ & 1) ^ 1);
        if (w.n_blocks == 0) continue;
        if constexpr (!L::O_IN_Q) mbar_wait(q_empty, (q_it++ & 1) ^ 1);
        const int bhk = w.b * Hkv + w.h / (H / Hkv);
        mbar_arrive_expect_tx(q_full, P * L::kQPanel);
        for (int p = 0; p < P; ++p) {
          tma_load_3d(smem + L::kQ + p * L::kQPanel, &tm_q, q_full, p * PANEL_COLS,
                      w.q0, w.b * H + w.h);
        }
        for (int j = 0; j < w.n_blocks; ++j, ++kv_it) {
          const int s = kv_it % STAGES;
          mbar_wait(&kv_empty[s], ((kv_it / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&kv_full[s], 2 * P * L::kKVPanel);
          for (int p = 0; p < P; ++p) {
            const int off = (s * P + p) * L::kKVPanel;
            tma_load_3d(smem + L::kK + off, &tm_k, &kv_full[s], p * PANEL_COLS,
                        j * BN, bhk);
            tma_load_3d(smem + L::kV + off, &tm_v, &kv_full[s], p * PANEL_COLS,
                        j * BN, bhk);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // rows r and r + 8
    const int cq = (lane & 3) * 2;                // first column of each pair
    const uint8_t* sq = smem + L::kQ + wg * 64 * ROW_BYTES;
    uint8_t* so = smem + L::kOBase + wg * L::kOWarpgroup;
    int kv_it = 0, q_it = 0;

    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile w = tile_at<BN>(t, B, H, Tq, Tk, causal, q_lens, kv_lens);
      const int wq0 = w.q0 + wg * 64;
      const int qa = wq0 + r;
      const int qb = qa + 8;

      float o[P][32];
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
      }
      // running max (in units of log2, already scaled) and partial sums
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

      if (w.n_blocks > 0) mbar_wait(q_full, q_it++ & 1);
      for (int j = 0; j < w.n_blocks; ++j, ++kv_it) {
        const int s = kv_it % STAGES;
        mbar_wait(&kv_full[s], (kv_it / STAGES) & 1);
        float sc[BN / 2];
        wgmma_fence();
        issue_s<D, BN>(sc, sq, smem + L::kK + s * P * L::kKVPanel);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        if (!L::O_IN_Q && j == w.n_blocks - 1) mbar_arrive(q_empty);   // Q is read for good

        // Only the last blocks, which cross kv_len or the diagonal, mask.
        Softmax sm{m0, m1, l0, l1, 1.0f, 1.0f};
        if ((j + 1) * BN > w.kv_len || (causal && (j + 1) * BN - 1 > wq0)) {
          online_softmax<BN, true>(sc, sm, j * BN, w.kv_len, qa, qb, causal,
                                   scale_log2);
        } else {
          online_softmax<BN, false>(sc, sm, j * BN, w.kv_len, qa, qb, causal,
                                    scale_log2);
        }
        m0 = sm.m0; m1 = sm.m1; l0 = sm.l0; l1 = sm.l1;
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            o[p][4 * i] *= sm.al0;
            o[p][4 * i + 1] *= sm.al0;
            o[p][4 * i + 2] *= sm.al1;
            o[p][4 * i + 3] *= sm.al1;
          }
        }

        // O += P V with P in registers as bf16; the rescaled O and P are
        // complete before the products that read them.
        uint32_t pa[BN / 16][4];
        acc_to_a<BN>(sc, pa);
        fence_regs(pa);
#pragma unroll
        for (int p = 0; p < P; ++p) fence_regs(o[p]);
        wgmma_fence();
        const uint8_t* sv = smem + L::kV + s * P * L::kKVPanel;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            wgmma_rs<64>(o[p], pa[kk],
                         desc_sw128(sv + p * L::kKVPanel + kk * 16 * ROW_BYTES), 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < P; ++p) fence_regs(o[p]);
        fence_regs(pa);
        mbar_arrive(&kv_empty[s]);
      }

      // ---- epilogue ----
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const bool ok0 = qa < w.q_len && l0 > 0.0f;
      const bool ok1 = qb < w.q_len && l1 > 0.0f;
      const float inv0 = ok0 ? 1.0f / l0 : 0.0f;
      const float inv1 = ok1 ? 1.0f / l1 : 0.0f;
      const size_t row0 = size_t(w.b * H + w.h) * Tq;
      if ((lane & 3) == 0) {
        if (qa < Tq) lse[row0 + qa] = ok0 ? m0 * LN2 + logf(l0) : INFINITY;
        if (qb < Tq) lse[row0 + qb] = ok1 ? m1 * LN2 + logf(l1) : INFINITY;
      }
      named_sync(1 + wg, 128);   // the previous tile's store has read `so`
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          *reinterpret_cast<uint32_t*>(so + p * L::kOStride +
                                       swizzled_offset(r, 8 * i + cq)) =
              pack_bf16(o[p][4 * i] * inv0, o[p][4 * i + 1] * inv0);
          *reinterpret_cast<uint32_t*>(so + p * L::kOStride +
                                       swizzled_offset(r + 8, 8 * i + cq)) =
              pack_bf16(o[p][4 * i + 2] * inv1, o[p][4 * i + 3] * inv1);
        }
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (tid == 0 && wq0 < Tq) {
        for (int p = 0; p < P; ++p) {
          tma_store_3d(&tm_o, so + p * L::kOStride, p * PANEL_COLS, wq0,
                       w.b * H + w.h);
        }
        tma_store_drain();
      }
      if constexpr (L::O_IN_Q) {
        named_sync(1 + wg, 128);   // the store has read O out of Q's rows
        mbar_arrive(q_empty);
      }
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* q_lens, const void* kv_lens, void* o,
                        void* lse, int B, int H, int Hkv, int Tq, int Tk,
                        int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!hopper::make_tmap_bf16(&tq, q, B * H, Tq, D, BM) ||
      !hopper::make_tmap_bf16(&tk, k, B * Hkv, Tk, D, Layout<D>::BN) ||
      !hopper::make_tmap_bf16(&tv, v, B * Hkv, Tk, D, Layout<D>::BN) ||
      !hopper::make_tmap_bf16(&to, o, B * H, Tq, D, 64)) {
    return cudaErrorNotSupported;
  }
  auto kernel = flash_fwd_bf16_kernel<D>;
  const int bytes = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  const long long n_tiles = (long long)((Tq + BM - 1) / BM) * B * H;
  if (n_tiles >= (1ll << 31)) return cudaErrorInvalidValue;
  const int grid = int(n_tiles < sms ? n_tiles : sms);   // one CTA per SM
  kernel<<<grid, THREADS_BF16, bytes, stream>>>(
      tq, tk, tv, to, static_cast<const int*>(q_lens),
      static_cast<const int*>(kv_lens), static_cast<float*>(lse), B, H, Hkv,
      Tq, Tk, causal, scale * LOG2E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: the scalar path
// ---------------------------------------------------------------------------

using flash::THREADS;

// Q, K, V tiles and the warps' P tiles (byte offsets).
template <int D>
struct SmemF32 : flash::Geometry<float, D> {
  using G = flash::Geometry<float, D>;
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = G::kTile;
  static constexpr size_t kV = 2 * G::kTile;
  static constexpr size_t kP = 3 * G::kTile;
  static constexpr size_t kTotal = kP + G::kWarpP;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ q_lens,
                     const int* __restrict__ kv_lens, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int Tq, int Tk,
                     int causal, float scale) {
  using L = SmemF32<D>;
  constexpr int BLOCK = L::BLOCK;
  constexpr int COLS = L::COLS;      // score columns per lane
  constexpr int DC = L::DCOLS;       // output columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::kQ);
  float* sK = reinterpret_cast<float*>(smem + L::kK);
  float* sV = reinterpret_cast<float*>(smem + L::kV);
  float* sP = reinterpret_cast<float*>(smem + L::kP);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BLOCK;
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = lane / L::LANES;     // row within the warp's rows
  const int part = lane % L::LANES;  // which part of the row this lane owns
  const int row = warp * L::ROWS_PER_WARP + r;
  const int qi = q0 + row;           // query position
  float* pw = sP + warp * L::ROWS_PER_WARP * L::LDP;

  const size_t q_head = (size_t(b) * H + h) * Tq;     // row offsets
  const size_t kv_head = (size_t(b) * Hkv + hk) * Tk;

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + BLOCK, q_len));
  const int n_blocks = q0 < q_len ? (kv_end + BLOCK - 1) / BLOCK : 0;

  float acc[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) acc[j] = 0.0f;
  float m_i = -INFINITY;
  float l_i = 0.0f;

  if (n_blocks > 0) flash::load_tile<float, D>(sQ, q + q_head * D, q0, q_len);

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int kv0 = blk * BLOCK;
    __syncthreads();  // every warp is done with the previous K/V tile
    flash::load_tile<float, D>(sK, k + kv_head * D, kv0, kv_len);
    flash::load_tile<float, D>(sV, v + kv_head * D, kv0, kv_len);
    __syncthreads();

    float s[COLS];
    flash::warp_abt<float, D>(sQ + warp * L::ROWS_PER_WARP * L::LDT, sK, r, part, s);

    // Online softmax; the lanes of a row share its max and sum.
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int kj = kv0 + part * COLS + i;
      const bool ok = kj < kv_len && (!causal || kj <= qi);
      s[i] = ok ? s[i] * scale : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = flash::row_max<L::LANES>(mx);
    const float m_new = fmaxf(m_i, mx);
    // A row with no valid key so far keeps m = -inf; exponentiate against 0
    // so that exp(-inf - m) is 0 rather than NaN.
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;
    const float alpha = __expf(m_i - m_use);
    float rs = 0.0f;
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const float p = __expf(s[i] - m_use);
      rs += p;
      pw[r * L::LDP + part * COLS + i] = p;
    }
    rs = flash::row_sum<L::LANES>(rs);
    l_i = l_i * alpha + rs;
    m_i = m_new;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[j] *= alpha;
    __syncwarp();  // P complete before PV

    // unrolled by 4: at D = 256 ptxas otherwise settles at 128 registers
    // and spills
#pragma unroll 4
    for (int c = 0; c < BLOCK; ++c) {
      const float p = pw[r * L::LDP + c];
      const float* vr = sV + c * L::LDT + part * DC;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[j] = fmaf(p, vr[j], acc[j]);
    }
    __syncwarp();  // P is rewritten by the next block
  }

  if (qi < Tq) {
    const bool valid = qi < q_len && l_i > 0.0f;
    const float inv = valid ? 1.0f / l_i : 0.0f;
    float* orow = o + (q_head + qi) * D + part * DC;
#pragma unroll
    for (int j = 0; j < DC; ++j) orow[j] = acc[j] * inv;
    if (part == 0) lse[q_head + qi] = valid ? m_i + logf(l_i) : INFINITY;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* q_lens, const void* kv_lens, void* o,
                       void* lse, int B, int H, int Hkv, int Tq, int Tk,
                       int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_kernel<D>;
  const int bytes = int(SmemF32<D>::kTotal);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  constexpr int BLOCK = SmemF32<D>::BLOCK;
  const dim3 grid((Tq + BLOCK - 1) / BLOCK, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_lens),
      static_cast<const int*>(kv_lens), static_cast<float*>(o),
      static_cast<float*>(lse), H, Hkv, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 on success, else the cudaError_t of the failed call (the launch
// is checked with cudaGetLastError right after it is enqueued;
// cudaErrorNotSupported if a tensor map could not be encoded).
// is_f32: 0 for bfloat16 operands (the wgmma kernel), 1 for float32 (the
// scalar kernel). D must be 64, 128 or 256.
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
#define AVSR_FWD(FN, DD)                                                    \
  return int(FN<DD>(q, k, v, q_lens, kv_lens, o, lse, B, H, Hkv, Tq, Tk, \
                    causal, scale, s))
  if (is_f32) {
    if (D == 64) AVSR_FWD(launch_f32, 64);
    if (D == 128) AVSR_FWD(launch_f32, 128);
    if (D == 256) AVSR_FWD(launch_f32, 256);
  } else {
    if (D == 64) AVSR_FWD(launch_bf16, 64);
    if (D == 128) AVSR_FWD(launch_bf16, 128);
    if (D == 256) AVSR_FWD(launch_bf16, 256);
  }
#undef AVSR_FWD
  return int(cudaErrorInvalidValue);
}
