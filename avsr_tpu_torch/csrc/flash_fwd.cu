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
//   Llama-2-7B (MHA, heads of 128): prefill [8,32,533,128] causal 41.9 us
//            by bytes (140 MB); train [8,32,672,128], 581 rows, 47.5 us;
//            its connectors [8,8,500,512] non-causal: 32.8 GFLOP -> 33.1 us;
//            131 MB -> 39.2 us.
//   Llama-2-13B's connectors [8,8,500,640]: 41.0 GFLOP -> 41.4 us; 164 MB
//            -> 48.9 us. Llama-2-70B's [8,8,500,1024]: 65.5 GFLOP -> 66.3
//            us; 262 MB -> 78.3 us (the panel kernel below).
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
// D = 512 (SPLIT): O of 64 rows would be 256 f32 a thread, past the cap.
// A tile is 64 query rows; both consumer warpgroups compute the same S over
// the whole width (S takes a third of the FLOPs more) and the same softmax,
// and each owns 4 of O's 8 panels (128 f32 a thread), so P V runs on its
// own 256 columns of V. K/V tiles hold 32 keys: Q is 64 KB and a stage
// 64 KB, two stages, 192 KB in all. Each warpgroup stages its O in its own
// panels of the Q tile, after a barrier of both (the other still reads
// them for its S until then); warpgroup 0 writes lse.
//
// The bf16 widths between the compiled ones (192; 320, 384, 448) run the
// next wider kernel with tensor maps at their own width: the panels past it
// load as zeros and O's columns past it are not stored, so no padded copy
// of q, k, v or O is made (launch_bf16).
//
// D > 512 (any multiple of 64) takes the kernels below that take the width
// at run time: in bf16 the clustered kernel (flash_fwd_bf16_cluster_kernel:
// one S per tile, summed across a thread-block cluster of the column
// groups) up to 2048, the per-group panel kernel (flash_fwd_bf16_panels_kernel)
// above; in f32 flash_fwd_f32_panels_kernel.
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

constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS_BF16 = (CONSUMERS + 1) * 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Dynamic shared-memory layout (byte offsets from a 1024-byte boundary).
template <int D>
struct Layout {
  // D = 512: a 64-row O accumulator of the whole width would be 256 f32
  // registers a thread. The two consumer warpgroups share a tile of 64 query
  // rows instead, each computing the same S = Q K^T over the whole width
  // and owning 256 of O's columns (PO = 4 of the 8 panels).
  static constexpr bool SPLIT = D == 512;
  static constexpr int BM = SPLIT ? 64 : 128;             // query rows of a tile
  // keys of a K/V tile: 128 for D = 64; 64 for D = 128 and 256, whose O
  // accumulators are two and four times as large, so that scores, P and O
  // stay in registers; 32 for D = 512, where a stage of 64 keys would be
  // 128 KB
  static constexpr int BN = D == 64 ? 128 : SPLIT ? 32 : 64;
  // K/V ring depth: two stages at D = 256 and 512, where a stage is 64 KB
  static constexpr int STAGES = D >= 256 ? 2 : 3;
  // D >= 256 has no room for an O staging tile: a warpgroup stages its O in
  // its own 64 rows (D = 512: its own panels) of the Q tile, which the next
  // tile's Q load then waits for (Q is released after the epilogue's store,
  // not after the last block)
  static constexpr bool O_IN_Q = D >= 256;
  static constexpr int P = D / hopper::PANEL_COLS;      // 64-column panels
  static constexpr int PO = SPLIT ? P / 2 : P;           // O panels of a warpgroup
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
  static constexpr int kOWarpgroup =
      SPLIT ? PO * kQPanel : O_IN_Q ? 64 * hopper::ROW_BYTES : P * kOPanel;
};

// One tile of work: BM query rows of one (b, h), and the K/V tiles it
// reads.
struct Tile {
  int b, h, q0, q_len, kv_len, n_blocks;
};

// Tile t of the list the persistent CTAs share: the q tile in the slowest
// position, last first (the heaviest causal tiles start first), then the
// batch row, then the head, so that the query heads of one kv head are
// neighbours and read the same K/V from L2.
template <int BM, int BN>
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
template <int D, int BM, int BN>
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
  constexpr int PO = L::PO;
  constexpr int BM = L::BM;
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
        const Tile w = tile_at<BM, BN>(t, B, H, Tq, Tk, causal, q_lens, kv_lens);
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
    // ---- consumers: 64 query rows each (D = 512: the tile's 64 rows, and
    // O's panels p0 .. p0 + PO - 1) ----
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // rows r and r + 8
    const int cq = (lane & 3) * 2;                // first column of each pair
    const int row_off = L::SPLIT ? 0 : wg * 64;   // the warpgroup's first row
    const int p0 = L::SPLIT ? wg * PO : 0;        // its first O panel
    const uint8_t* sq = smem + L::kQ + row_off * ROW_BYTES;
    uint8_t* so = smem + L::kOBase + wg * L::kOWarpgroup;
    int kv_it = 0, q_it = 0;

    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile w = tile_at<BM, BN>(t, B, H, Tq, Tk, causal, q_lens, kv_lens);
      const int wq0 = w.q0 + row_off;
      const int qa = wq0 + r;
      const int qb = qa + 8;

      float o[PO][32];
#pragma unroll
      for (int p = 0; p < PO; ++p) {
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
        issue_s<D, BM, BN>(sc, sq, smem + L::kK + s * P * L::kKVPanel);
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
        for (int p = 0; p < PO; ++p) {
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
        for (int p = 0; p < PO; ++p) fence_regs(o[p]);
        wgmma_fence();
        const uint8_t* sv = smem + L::kV + s * P * L::kKVPanel;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
          for (int p = 0; p < PO; ++p) {
            wgmma_rs<64>(o[p], pa[kk],
                         desc_sw128(sv + (p0 + p) * L::kKVPanel + kk * 16 * ROW_BYTES),
                         1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < PO; ++p) fence_regs(o[p]);
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
      // under SPLIT both warpgroups hold the same rows' statistics
      if ((lane & 3) == 0 && (!L::SPLIT || wg == 0)) {
        if (qa < Tq) lse[row0 + qa] = ok0 ? m0 * LN2 + logf(l0) : INFINITY;
        if (qb < Tq) lse[row0 + qb] = ok1 ? m1 * LN2 + logf(l1) : INFINITY;
      }
      if constexpr (L::SPLIT) {
        // O goes into Q panels the other warpgroup reads for its S: both
        // are done with Q
        named_sync(3, CONSUMERS * 128);
      } else {
        named_sync(1 + wg, 128);   // the previous tile's store has read `so`
      }
#pragma unroll
      for (int p = 0; p < PO; ++p) {
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
        for (int p = 0; p < PO; ++p) {
          tma_store_3d(&tm_o, so + p * L::kOStride, (p0 + p) * PANEL_COLS, wq0,
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

// `width` is the operands' head width, D or less (192 on the D = 256 kernel,
// 320-448 on the D = 512 one): the tensor maps are built at that width, so
// the panels past it load as zeros (a box wholly past it too, with its full
// byte count) and O's columns past it are dropped by the store. The kernel
// then sees in shared memory what zero-padded copies of the operands would
// give it, and O and lse are those of the padded route bit for bit.
template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* q_lens, const void* kv_lens, void* o,
                        void* lse, int B, int H, int Hkv, int Tq, int Tk,
                        int width, int causal, float scale, cudaStream_t stream) {
  constexpr int BM = Layout<D>::BM;
  CUtensorMap tq, tk, tv, to;
  if (!hopper::make_tmap_bf16(&tq, q, B * H, Tq, width, BM) ||
      !hopper::make_tmap_bf16(&tk, k, B * Hkv, Tk, width, Layout<D>::BN) ||
      !hopper::make_tmap_bf16(&tv, v, B * Hkv, Tk, width, Layout<D>::BN) ||
      !hopper::make_tmap_bf16(&to, o, B * H, Tq, width, 64)) {
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
// bfloat16, D > 512: the head width as a loop count
// ---------------------------------------------------------------------------

// Above 512 a 64-row Q, K and V tile of the whole width no longer fit in the
// 227 KB a block may use together (80 KB each at D = 640, 128 KB at 1024),
// and a 64-row O of half the width is 160-256 f32 a thread. So the width is
// a loop count: a CTA owns 64 query rows of one (b, h) and one group of up
// to 256 of O's columns (PANELS_GP panels; the grid's fastest dimension, so
// the groups of one tile run side by side and read its Q, K and V from L2).
// Per 64-key block:
//   * S = sum over the D / 64 panels p of Q_p K_p^T: a ring of PANELS_STAGES
//     stages, each a Q panel and a K panel by TMA, wgmma m64n64k16 with both
//     operands in shared memory; a stage is released once the next panel's
//     products are issued and its own are done (wgmma.wait_group 1);
//   * the mask and the online softmax as in flash_fwd_bf16_kernel;
//   * O_g += P V_g: the group's V panels through the same ring, P rounded to
//     bf16 as the register A operand.
// Every group recomputes S over the whole width: at 640 (three groups) the
// kernel does 2x the FLOPs of S + PV, at 1024 (four) 2.5x. Since the
// clustered kernel below shares one S between the groups, this kernel runs
// only the widths whose groups outnumber the largest cluster launched
// (CLUSTER_MAX: D > 2048). Group 0 writes lse; O leaves through a swizzled
// staging tile and TMA stores that clip rows past Tq. A CTA is a consumer
// warpgroup and a producer warpgroup, one thread of which issues the loads
// (255 registers a thread: O 128, S 32, P 16).
constexpr int PANELS_GP = 4;         // 64-column panels of a column group
constexpr int PANELS_BN = 64;        // keys of a K/V block
constexpr int PANELS_STAGES = 4;     // ring depth
constexpr int THREADS_PANELS = 256;  // a consumer and a producer warpgroup

struct PanelsLayout {
  static constexpr int kA = 64 * hopper::ROW_BYTES;        // a Q panel
  static constexpr int kB = PANELS_BN * hopper::ROW_BYTES;   // a K or V panel
  static constexpr int kStage = kA + kB;
  static constexpr int kO = PANELS_STAGES * kStage;          // O's staging panels
  static constexpr int kBar = kO + PANELS_GP * kA;
  static constexpr int kBytes = kBar + 2 * PANELS_STAGES * 8 + hopper::ATOM_BYTES;
};

__global__ void __launch_bounds__(THREADS_PANELS, 1)
flash_fwd_bf16_panels_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o,
                           const int* __restrict__ q_lens,
                           const int* __restrict__ kv_lens,
                           float* __restrict__ lse, int H, int Hkv, int Tq,
                           int Tk, int D, int causal, float scale_log2) {
  using namespace hopper;
  using L = PanelsLayout;
  constexpr int BN = PANELS_BN;
  constexpr int STAGES = PANELS_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + STAGES;

  const int P = D / PANEL_COLS;                 // panels of the width
  const int G = (P + PANELS_GP - 1) / PANELS_GP;    // column groups
  const int g = int(blockIdx.x) % G;
  const int h = int(blockIdx.x) / G;
  const int b = blockIdx.y;
  const int n_qt = (Tq + 63) / 64;
  const int q0 = (n_qt - 1 - int(blockIdx.z)) * 64;   // last (heaviest) first
  const int pg0 = g * PANELS_GP;                  // the group's first panel
  const int np = min(PANELS_GP, P - pg0);         // and its panels
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));
  // keys the tile needs: below kv_len and, when causal, not past its last
  // valid row; a tile wholly at or past q_len loads nothing
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + 64, q_len));
  const int n_blocks = q0 < q_len ? (kv_end + BN - 1) / BN : 0;
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
    // ---- producer: one thread; per block P (Q, K) panel pairs, then the
    // group's np V panels ----
    if (threadIdx.x == 128) {
      int it = 0;
      for (int j = 0; j < n_blocks; ++j) {
        for (int p = 0; p < P + np; ++p, ++it) {
          const int s = it % STAGES;
          uint8_t* st = smem + s * L::kStage;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          if (p < P) {
            mbar_arrive_expect_tx(&full[s], L::kStage);
            tma_load_3d(st, &tm_q, &full[s], p * PANEL_COLS, q0, bh);
            tma_load_3d(st + L::kA, &tm_k, &full[s], p * PANEL_COLS, j * BN, bhk);
          } else {
            mbar_arrive_expect_tx(&full[s], L::kB);
            tma_load_3d(st + L::kA, &tm_v, &full[s], (pg0 + p - P) * PANEL_COLS,
                        j * BN, bhk);
          }
        }
      }
    }
  } else {
    // ---- consumer: the tile's 64 rows, O's columns of the group ----
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int r = (tid >> 5) * 16 + (lane >> 2);  // rows r and r + 8
    const int cq = (lane & 3) * 2;                // first column of each pair
    const int qa = q0 + r;
    const int qb = qa + 8;

    float o[PANELS_GP][32];
#pragma unroll
    for (int p = 0; p < PANELS_GP; ++p) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
    }
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

    int it = 0;
    for (int j = 0; j < n_blocks; ++j) {
      // S = sum_p Q_p K_p^T; stage `prev` is released once the products of
      // the next panel are issued and its own have completed
      float sc[BN / 2];
      int prev = 0;
      for (int p = 0; p < P; ++p, ++it) {
        const int s = it % STAGES;
        const uint8_t* st = smem + s * L::kStage;
        mbar_wait(&full[s], (it / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          wgmma_ss<BN>(sc, desc_sw128(st + k * 32), desc_sw128(st + L::kA + k * 32),
                       (p | k) != 0);
        }
        wgmma_commit();
        if (p > 0) {
          wgmma_wait<1>();
          mbar_arrive(&empty[prev]);
        }
        prev = s;
      }
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(&empty[prev]);

      // Only the last blocks, which cross kv_len or the diagonal, mask.
      Softmax sm{m0, m1, l0, l1, 1.0f, 1.0f};
      if ((j + 1) * BN > kv_len || (causal && (j + 1) * BN - 1 > q0)) {
        online_softmax<BN, true>(sc, sm, j * BN, kv_len, qa, qb, causal, scale_log2);
      } else {
        online_softmax<BN, false>(sc, sm, j * BN, kv_len, qa, qb, causal, scale_log2);
      }
      m0 = sm.m0; m1 = sm.m1; l0 = sm.l0; l1 = sm.l1;
#pragma unroll
      for (int p = 0; p < PANELS_GP; ++p) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          o[p][4 * i] *= sm.al0;
          o[p][4 * i + 1] *= sm.al0;
          o[p][4 * i + 2] *= sm.al1;
          o[p][4 * i + 3] *= sm.al1;
        }
      }

      // O_g += P V_g, one V panel of the group per stage
      uint32_t pa[BN / 16][4];
      acc_to_a<BN>(sc, pa);
      fence_regs(pa);
#pragma unroll
      for (int p = 0; p < PANELS_GP; ++p) {
        if (p < np) {
          const int s = it % STAGES;
          mbar_wait(&full[s], (it / STAGES) & 1);
          const uint8_t* sv = smem + s * L::kStage + L::kA;
          fence_regs(o[p]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
            wgmma_rs<64>(o[p], pa[kk], desc_sw128(sv + kk * 16 * ROW_BYTES), 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(o[p]);
          mbar_arrive(&empty[s]);
          ++it;
        }
      }
      fence_regs(pa);
    }

    // ---- epilogue ----
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const bool ok0 = qa < q_len && l0 > 0.0f;
    const bool ok1 = qb < q_len && l1 > 0.0f;
    const float inv0 = ok0 ? 1.0f / l0 : 0.0f;
    const float inv1 = ok1 ? 1.0f / l1 : 0.0f;
    if ((lane & 3) == 0 && g == 0) {
      const size_t row0 = size_t(bh) * Tq;
      if (qa < Tq) lse[row0 + qa] = ok0 ? m0 * LN2 + logf(l0) : INFINITY;
      if (qb < Tq) lse[row0 + qb] = ok1 ? m1 * LN2 + logf(l1) : INFINITY;
    }
    uint8_t* so = smem + L::kO;
#pragma unroll
    for (int p = 0; p < PANELS_GP; ++p) {
      if (p < np) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          *reinterpret_cast<uint32_t*>(so + p * L::kA + swizzled_offset(r, 8 * i + cq)) =
              pack_bf16(o[p][4 * i] * inv0, o[p][4 * i + 1] * inv0);
          *reinterpret_cast<uint32_t*>(so + p * L::kA + swizzled_offset(r + 8, 8 * i + cq)) =
              pack_bf16(o[p][4 * i + 2] * inv1, o[p][4 * i + 3] * inv1);
        }
      }
    }
    fence_proxy_async();
    named_sync(1, 128);
    if (tid == 0) {
      for (int p = 0; p < np; ++p) {
        tma_store_3d(&tm_o, so + p * L::kA, (pg0 + p) * PANEL_COLS, q0, bh);
      }
      tma_store_drain();
    }
  }
}

cudaError_t launch_bf16_panels(const void* q, const void* k, const void* v,
                             const void* q_lens, const void* kv_lens, void* o,
                             void* lse, int B, int H, int Hkv, int Tq, int Tk,
                             int D, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!hopper::make_tmap_bf16(&tq, q, B * H, Tq, D, 64) ||
      !hopper::make_tmap_bf16(&tk, k, B * Hkv, Tk, D, PANELS_BN) ||
      !hopper::make_tmap_bf16(&tv, v, B * Hkv, Tk, D, PANELS_BN) ||
      !hopper::make_tmap_bf16(&to, o, B * H, Tq, D, 64)) {
    return cudaErrorNotSupported;
  }
  auto kernel = flash_fwd_bf16_panels_kernel;
  const int bytes = PanelsLayout::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long G = (D / hopper::PANEL_COLS + PANELS_GP - 1) / PANELS_GP;
  const int n_qt = (Tq + 63) / 64;
  if (n_qt > 65535 || G * H >= (1ll << 31)) return cudaErrorInvalidValue;
  const dim3 grid(unsigned(G * H), B, n_qt);
  kernel<<<grid, THREADS_PANELS, bytes, stream>>>(
      tq, tk, tv, to, static_cast<const int*>(q_lens),
      static_cast<const int*>(kv_lens), static_cast<float*>(lse), H, Hkv, Tq,
      Tk, D, causal, scale * LOG2E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16, D > 512: one S per tile, shared by a thread-block cluster
// ---------------------------------------------------------------------------

// O for 64 rows of the whole width does not fit one SM's registers (256 KB
// of f32 at D = 1024), so O's columns stay split into G = ceil(D / 256)
// groups of 4 panels, one CTA a group, as in the kernel above. What changes
// is S: the G CTAs of one (b, h, 128-row q tile) run as one thread-block
// cluster of G (the grid's x index is h * G + g, so clusters line up with
// tiles), and S is computed once between them. A CTA is two consumer
// warpgroups of 64 of the tile's rows each, which read the same K and V
// panels; a warpgroup's rows fall into 8 row groups of 8 (warp w holds
// groups 2w and 2w + 1), and group i belongs to CTA i % G. Per 32-key block
// and warpgroup:
//   * CTA g sums a partial S_g = sum_p Q_p K_p^T over its share of the
//     D / 64 panels only (cluster_share: 3, 3 and 4 of the 10 at 640, so
//     that with O's groups of 4, 4 and 2 no CTA does more than 7 panels'
//     products); its Q panels stay in shared memory for the whole tile and
//     only its K panels stream. So the score FLOPs of a tile over the
//     cluster are those of one S (2 * 128 * 32 * D a block), and Q is read
//     from memory once a tile;
//   * reduce-scatter: each row group of S_g (1 KB of f32) goes from the
//     registers into its owner's shared memory (st.async), where it
//     completes the owner's barrier; the owner sums a group's G partials in
//     rank order (its own from its shared memory), so every element of S is
//     summed once and the same way on every run, and runs the masked online
//     softmax of those rows alone (their m and l live in the owner);
//   * all-gather: the owner sends each of its groups' P (bf16, in the
//     register layout of the P V product's A operand) with the rows'
//     rescale factor and whole running sum to every other CTA the same way;
//     then every CTA rescales its O rows and adds P V_g, one m64nNk16
//     product a k16 step over the group's N / 64 V panels.
// So a CTA receives (G - 1) / G of a block's partial S and of its P, where
// gathering every peer's whole partial would move G - 1 partials a CTA
// through the cluster's network, on the critical path (that design ran
// slower than the kernel above at 640). The lse of a row is written by its
// owner.
// The exchange is pipelined CL_DEPTH blocks deep: iteration j issues block
// j's P V and block j + 2's partial, reduces block j + 1's partials while
// those run, and pushes block j + 2's partial at its end. Every buffer a
// peer writes has CL_DEPTH copies (a block's index mod CL_DEPTH), and a
// block's data can reach one only after its previous contents were read
// (each push follows a wait that, through the other phase, the reads
// preceded). Loads: warp 0 issues a block's K panels, warp 7 its V panels
// (a lane a panel, 4 KB each), each into one of two stage sets, a block
// before they are read, once every warp has released the set; a wait there
// depends only on loads already issued, here and in the peers, so no cycle
// can form. A third warpgroup or a producer warp would cap the kernel at
// 168 registers a thread (a ninth warp shares a quarter of the register
// file with two others). Launched with cudaLaunchKernelEx and a cluster of
// G (at most CLUSTER_MAX, the largest portable cluster: D <= 2048); a
// refused cluster launch is returned as it is. O leaves through the
// warpgroup's rows of Q's panels and TMA stores; the last step is a
// cluster-wide barrier, so no CTA exits while a peer may still write to it.
constexpr int CLUSTER_MAX = 8;       // the largest portable cluster
constexpr int CL_BM = 128;           // query rows of a tile (two warpgroups)
constexpr int CL_BN = 32;            // keys of a block
constexpr int CL_GROUPS = 8;         // row groups of 8 rows in a warpgroup
constexpr int CL_DEPTH = 2;          // partials are computed this many blocks ahead
constexpr int THREADS_CLUSTER = 2 * 128;

// Shared memory: Q's share (then O), two sets of K stages (a block's share
// panels) and two of V stages (its group panels), and per warpgroup the
// partial S of its own row groups (PS, [own group][lane][8 f32]), then per
// buffer (a block's index mod CL_DEPTH) the partials pushed to
// it (RX, [source rank other than this][own group][lane][8 f32]) and the P
// of every group (PP, [group]: [lane][4 x bf16x2], then [row][rescale
// factor, whole running sum]). The sizes depend on G, so the layout is
// computed at run time.
struct ClusterLayout {
  static constexpr int kQPanel = CL_BM * hopper::ROW_BYTES;  // 128 rows x 64 columns
  static constexpr int kPanel = CL_BN * hopper::ROW_BYTES;   // 32 keys x 64 columns
  static constexpr int kSet = PANELS_GP * kPanel;            // a block's K or V panels
  static constexpr int kGroupS = 32 * 8 * 4;                // a row group of S, f32
  static constexpr int kGroupP = 32 * 16 + 8 * 8;           // a row group of P + stats
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + PANELS_GP * kQPanel;
  static constexpr int kV = kK + 2 * kSet;
  static constexpr int kWG = kV + 2 * kSet;
  // q_full, k_full[2], k_empty[2], v_full[2], v_empty[2], then per
  // warpgroup rx[A] and pp[A]
  static constexpr int kRxBar = 9;
  static constexpr int kBars = kRxBar + 2 * 2 * CL_DEPTH;

  int own_max, ps, rx, per_buf, per_wg, bar, bytes;
  __host__ __device__ explicit ClusterLayout(int G) {
    own_max = (CL_GROUPS + G - 1) / G;                // most groups a CTA owns
    ps = own_max * kGroupS;
    rx = (G - 1) * own_max * kGroupS;
    per_buf = rx + CL_GROUPS * kGroupP;
    per_wg = ps + CL_DEPTH * per_buf;
    bar = kWG + 2 * per_wg;
    bytes = bar + kBars * 8 + hopper::ATOM_BYTES;
  }
  __host__ __device__ int ps_at(int wg) const { return kWG + wg * per_wg; }
  // warpgroup wg's received partials and P of block j, and their barriers
  __host__ __device__ int rx_at(int wg, int j) const {
    return kWG + wg * per_wg + ps + (j % CL_DEPTH) * per_buf;
  }
  __host__ __device__ int pp_at(int wg, int j) const { return rx_at(wg, j) + rx; }
  __host__ __device__ int rx_bar(int wg, int j) const {
    return bar + (kRxBar + 2 * CL_DEPTH * wg + j % CL_DEPTH) * 8;
  }
  __host__ __device__ int pp_bar(int wg, int j) const {
    return bar + (kRxBar + 2 * CL_DEPTH * wg + CL_DEPTH + j % CL_DEPTH) * 8;
  }
};

// The cluster size of the bf16 forward at head width D: the groups of 256
// columns above 512 while the largest cluster takes them, else 0 (the
// compiled kernels up to 512; the per-group panel kernel past CLUSTER_MAX
// groups).
int panel_cluster(int D) {
  if (D <= 512 || D % hopper::PANEL_COLS != 0) return 0;
  const int G = (D / hopper::PANEL_COLS + PANELS_GP - 1) / PANELS_GP;
  return G <= CLUSTER_MAX ? G : 0;
}

// The n panels (panel p0 + lane, keys j * CL_BN..) of block j into stage set
// j & 1 at `ring`, once every warp has released the set's last use: the
// lanes of one warp, one panel a lane, so that the loads are issued side by
// side; the set's full barrier expects all of their bytes.
__device__ __forceinline__ void cluster_issue(uint8_t* ring, const CUtensorMap* map,
                                              uint64_t* full, uint64_t* empty, int j, int n,
                                              int p0, int bhk, int lane) {
  using namespace hopper;
  using L = ClusterLayout;
  const int set = j & 1;
  mbar_wait_fast(&empty[set], ((j >> 1) & 1) ^ 1);
  if (lane == 0) mbar_arrive_expect_tx(&full[set], n * L::kPanel);
  __syncwarp();
  if (lane < n) {
    tma_load_3d(ring + set * L::kSet + lane * L::kPanel, map, &full[set],
                (p0 + lane) * PANEL_COLS, j * CL_BN, bhk);
  }
}

// Issues (without committing) a warpgroup's partial S of block j: its 64
// rows of Q's share panels (sq) against the block's K panels (arrived).
__device__ __forceinline__ void cluster_partial_s(float (&acc)[CL_BN / 2], uint8_t* smem,
                                                  const uint8_t* sq, int j, int ns) {
  using namespace hopper;
  using L = ClusterLayout;
  const uint8_t* ks = smem + L::kK + (j & 1) * L::kSet;
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < PANELS_GP; ++i) {
    if (i < ns) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_ss<CL_BN>(acc, desc_sw128(sq + i * L::kQPanel + k * 32),
                        desc_sw128(ks + i * L::kPanel + k * 32), (i | k) != 0);
      }
    }
  }
}

// A thread's 8 values of row half e (0: its row r, 1: r + 8) in an m64n32
// accumulator: chunk c's pair at d[4c + 2e], d[4c + 2e + 1].
__device__ __forceinline__ void cluster_half(const float (&d)[CL_BN / 2], int e,
                                             float (&v)[8]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[2 * c] = d[4 * c + 2 * e];
    v[2 * c + 1] = d[4 * c + 2 * e + 1];
  }
}

// Pushes a warp's rows of its warpgroup's partial S of block j (acc: row
// groups 2w and 2w + 1): a group another CTA owns goes straight from the
// registers into that owner's received partials of block j (st.async,
// completing the owner's rx barrier); an owned one into PS. A warp's groups
// are its own rows, so no other warp waits for it.
__device__ __forceinline__ void cluster_push_partial(const float (&acc)[CL_BN / 2],
                                                     uint8_t* smem, const ClusterLayout& L,
                                                     int wg, int j, int g, int G, int tid) {
  using namespace hopper;
  using CL = ClusterLayout;
  const int lane = tid & 31, w = tid >> 5;
  const uint32_t base = smem_u32(smem);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float v[8];
    cluster_half(acc, e, v);
    const int gid = 2 * w + e;
    const int o = gid % G;
    if (o == g) {
      float4* dst = reinterpret_cast<float4*>(smem + L.ps_at(wg) + (gid / G) * CL::kGroupS +
                                              lane * 32);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      const int slot = g < o ? g : g - 1;
      const uint32_t dst = mapa_shared(
          base + L.rx_at(wg, j) + (slot * L.own_max + gid / G) * CL::kGroupS + lane * 32, o);
      const uint32_t bar = mapa_shared(base + L.rx_bar(wg, j), o);
      st_async_v4(dst, __float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                  __float_as_uint(v[3]), bar);
      st_async_v4(dst + 16, __float_as_uint(v[4]), __float_as_uint(v[5]),
                  __float_as_uint(v[6]), __float_as_uint(v[7]), bar);
    }
  }
}

// The masked online softmax of one row half (8 scores v of row q, keys
// kv0 + 8c + cq + {0, 1} for c = 0..3) with its running max m and sum l
// (this thread's columns); returns the rescale factor and leaves P in the
// four bf16 pairs `words`.
template <bool MASK>
__device__ __forceinline__ float cluster_softmax(float (&v)[8], float& m, float& l, int kv0,
                                                 int kv_len, int q, int causal,
                                                 float scale_log2, uint32_t (&words)[4]) {
  const int cq = (threadIdx.x & 3) * 2;
  if constexpr (MASK) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int kj = kv0 + 8 * (k >> 1) + cq + (k & 1);
      if (!(kj < kv_len && (!causal || kj <= q))) v[k] = -INFINITY;
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < 8; ++k) mx = fmaxf(mx, v[k]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float mn = fmaxf(m, mx * scale_log2);
  // a row with no valid key so far keeps m = -inf: exponentiate against 0
  const float mu = mn == -INFINITY ? 0.0f : mn;
  const float al = hopper::ex2(m - mu);
  float rs = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = hopper::ex2(fmaf(v[k], scale_log2, -mu));
    rs += v[k];
  }
  l = l * al + rs;
  m = mn;
#pragma unroll
  for (int c = 0; c < 4; ++c) words[c] = hopper::pack_bf16(v[2 * c], v[2 * c + 1]);
  return al;
}

// The reduce-scatter's second half for block j, by the warps that own a row
// group (warp w holds groups 2w and 2w + 1; of two neighbouring groups at
// most one is this CTA's): waits for the group's partials, sums them in rank
// order (this CTA's own from PS), runs the rows' softmax, and writes their P
// and factors into PP of block j, here and in every other CTA. The first
// such warp, (g / 2), re-arms the rx barrier for block j + A once its wait
// has seen block j's phase.
__device__ __forceinline__ void cluster_reduce(uint8_t* smem, const ClusterLayout& L, int wg,
                                               int j, int g, int G, int tid,
                                               const bool (&own)[2], const int (&qrow)[2],
                                               float (&m)[2], float (&l)[2], int kv_len,
                                               int causal, bool mask, float scale_log2,
                                               int rx_bytes, int n_blocks) {
  using namespace hopper;
  using CL = ClusterLayout;
  const int lane = tid & 31, w = tid >> 5;
  if (!own[0] && !own[1]) return;
  const int e = own[0] ? 0 : 1;
  const int gid = 2 * w + e;
  uint64_t* rx = reinterpret_cast<uint64_t*>(smem + L.rx_bar(wg, j));
  mbar_wait_fast(rx, (j / CL_DEPTH) & 1);
  if (w == (g >> 1) && lane == 0 && j + CL_DEPTH < n_blocks) mbar_arrive_expect_tx(rx, rx_bytes);
  float v[8];
  for (int rk = 0; rk < G; ++rk) {
    const uint8_t* src =
        rk == g ? smem + L.ps_at(wg) + (gid / G) * CL::kGroupS
                : smem + L.rx_at(wg, j) +
                      ((rk < g ? rk : rk - 1) * L.own_max + gid / G) * CL::kGroupS;
    const float4 x = reinterpret_cast<const float4*>(src + lane * 32)[0];
    const float4 y = reinterpret_cast<const float4*>(src + lane * 32)[1];
    if (rk == 0) {
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
    } else {
      v[0] += x.x; v[1] += x.y; v[2] += x.z; v[3] += x.w;
      v[4] += y.x; v[5] += y.y; v[6] += y.z; v[7] += y.w;
    }
  }
  uint32_t words[4];
  const float al = mask ? cluster_softmax<true>(v, m[e], l[e], j * CL_BN, kv_len, qrow[e],
                                                causal, scale_log2, words)
                        : cluster_softmax<false>(v, m[e], l[e], j * CL_BN, kv_len, qrow[e],
                                                 causal, scale_log2, words);
  // this CTA's copy, then every other CTA's (st.async from the registers);
  // a row's factor and whole running sum once, from the first lane of its
  // quad
  float lr = l[e];
  lr += __shfl_xor_sync(0xffffffffu, lr, 1);
  lr += __shfl_xor_sync(0xffffffffu, lr, 2);
  const int off = L.pp_at(wg, j) + gid * CL::kGroupP;
  const bool row_lane = (lane & 3) == 0;
  *reinterpret_cast<uint4*>(smem + off + lane * 16) =
      make_uint4(words[0], words[1], words[2], words[3]);
  if (row_lane) {
    *reinterpret_cast<float2*>(smem + off + 512 + (lane >> 2) * 8) = make_float2(al, lr);
  }
  const uint32_t base = smem_u32(smem);
  for (int rk = 0; rk < G; ++rk) {
    if (rk == g) continue;
    const uint32_t dst = mapa_shared(base + off, rk);
    const uint32_t bar = mapa_shared(base + L.pp_bar(wg, j), rk);
    st_async_v4(dst + lane * 16, words[0], words[1], words[2], words[3], bar);
    if (row_lane) {
      st_async_v2(dst + 512 + (lane >> 2) * 8, __float_as_uint(al), __float_as_uint(lr), bar);
    }
  }
}

// CTA g's share of S's P panels: ns of them from panel sp0. The panels go
// one by one to the CTA with the least work so far, counting its group's O
// panels (PANELS_GP, the last group fewer) and its share, at most PANELS_GP
// a CTA (its Q panels stay resident): at 640 (O groups of 4, 4 and 2) the
// shares are 3, 3 and 4, so that no CTA does more than 7 panels' products
// a block, where an even split gives one 8. The cluster runs at its slowest
// CTA's pace. (Written with constant indices only, so that the arrays stay
// in registers.)
__device__ __forceinline__ void cluster_share(int P, int G, int g, int& ns, int& sp0) {
  int load[CLUSTER_MAX], share[CLUSTER_MAX];
#pragma unroll
  for (int i = 0; i < CLUSTER_MAX; ++i) {
    load[i] = i < G ? min(PANELS_GP, P - i * PANELS_GP) : 1 << 20;
    share[i] = 0;
  }
  for (int p = 0; p < P; ++p) {
    int best = 0, best_load = 1 << 20;
#pragma unroll
    for (int i = 0; i < CLUSTER_MAX; ++i) {
      if (share[i] < PANELS_GP && load[i] < best_load) {
        best = i;
        best_load = load[i];
      }
    }
#pragma unroll
    for (int i = 0; i < CLUSTER_MAX; ++i) {
      if (i == best) {
        ++share[i];
        ++load[i];
      }
    }
  }
  ns = 0;
  sp0 = 0;
#pragma unroll
  for (int i = 0; i < CLUSTER_MAX; ++i) {
    if (i < g) sp0 += share[i];
    if (i == g) ns = share[i];
  }
}

// O_g += P V_g for one block: the group's N / 64 V panels (at `vs`, a
// panel apart) as one MN-major operand, a product a k16 step; O is the
// panels' m64n64 accumulators side by side, which is the m64nN accumulator.
template <int N>
__device__ __forceinline__ void cluster_pv(float (&o)[PANELS_GP * 32],
                                           const uint32_t (&pa)[CL_BN / 16][4],
                                           const uint8_t* vs) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < CL_BN / 16; ++kk) {
    wgmma_rs<N>(*reinterpret_cast<float(*)[N / 2]>(o), pa[kk],
                desc_sw128(vs + kk * 16 * ROW_BYTES, ClusterLayout::kPanel), 1);
  }
}

__global__ void __launch_bounds__(THREADS_CLUSTER, 1)
flash_fwd_bf16_cluster_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_o,
                              const int* __restrict__ q_lens,
                              const int* __restrict__ kv_lens,
                              float* __restrict__ lse, int H, int Hkv, int Tq,
                              int Tk, int D, int causal, float scale_log2) {
  using namespace hopper;
  using CL = ClusterLayout;
  constexpr int BN = CL_BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);

  const int P = D / PANEL_COLS;                     // panels of the width
  const int G = (P + PANELS_GP - 1) / PANELS_GP;    // the cluster's CTAs
  const ClusterLayout L(G);
  constexpr int A = CL_DEPTH;                       // partials A blocks ahead
  const int g = int(cluster_ctarank());             // == blockIdx.x % G
  const int h = int(blockIdx.x) / G;
  const int b = blockIdx.y;
  const int n_qt = (Tq + CL_BM - 1) / CL_BM;
  const int q0 = (n_qt - 1 - int(blockIdx.z)) * CL_BM;  // last (heaviest) first
  const int pg0 = g * PANELS_GP;                    // O's group: panels pg0..
  const int np = min(PANELS_GP, P - pg0);
  int ns, sp0;                                      // S's share: panels sp0..
  cluster_share(P, G, g, ns, sp0);
  const int og = (CL_GROUPS - g + G - 1) / G;       // row groups this CTA owns
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + CL_BM, q_len));
  // the same for every CTA of the cluster, so all make the same exchanges
  const int n = q0 < q_len ? (kv_end + BN - 1) / BN : 0;
  const int bh = b * H + h;
  const int bhk = b * Hkv + h / (H / Hkv);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = bars + 3;
  uint64_t* v_full = bars + 5;
  uint64_t* v_empty = bars + 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      // a set is released by each warp (one arrival: 256 would serialise on
      // the barrier's word)
      mbar_init(&k_empty[s], THREADS_CLUSTER / 32);
      mbar_init(&v_empty[s], THREADS_CLUSTER / 32);
    }
    // rx and pp: this CTA's one arrival (with the bytes expected) a phase;
    // the peers' pushes complete them
    for (int i = CL::kRxBar; i < CL::kBars; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  cluster_sync();   // no peer pushes to a barrier before it is initialised

  // ---- two consumer warpgroups: 64 rows each, O's columns of the group ----
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int r = w * 16 + (lane >> 2);           // rows r and r + 8
  const int cq = (lane & 3) * 2;                // first column of each pair
  const int wq0 = q0 + wg * 64;                 // the warpgroup's first row
  const int qrow[2] = {wq0 + r, wq0 + r + 8};
  const bool own[2] = {(2 * w) % G == g, (2 * w + 1) % G == g};
  const uint8_t* sq = smem + CL::kQ + wg * 64 * ROW_BYTES;   // its rows of Q
  uint64_t* pp_bar = reinterpret_cast<uint64_t*>(smem + L.pp_bar(wg, 0));   // [j % A]
  const int rx_bytes = (G - 1) * og * CL::kGroupS;
  const int pp_bytes = (CL_GROUPS - og) * CL::kGroupP;
  auto masked = [&](int j) {   // block j crosses kv_len or the diagonal
    return (j + 1) * BN > kv_len || (causal && (j + 1) * BN - 1 > wq0);
  };

  float o[PANELS_GP * 32];   // panel p's m64n64 accumulator at 32 p
#pragma unroll
  for (int i = 0; i < PANELS_GP * 32; ++i) o[i] = 0.0f;
  // the running max and sum of an owned row half (this thread's columns),
  // and the owner's whole sum of another as last received
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float sn[BN / 2];   // this CTA's partial S of a block ahead

  // The pipeline, A blocks deep: at the top of iteration j, the partials of
  // blocks j + 1 .. j + A - 1 and the P of blocks j .. j + A - 2 are on
  // their way or in, K of block j + A and V of block j are loaded or
  // loading. Iteration j loads K of j + A + 1 and V of j + 1, receives
  // block j's P and issues its P V and block j + A's partial, receives block
  // j + A - 1's partials (its rows' softmax, P pushed) while those run, then
  // pushes block j + A's partial.
  if (n > 0) {
    if (threadIdx.x < 32) {
      if (lane == 0) {
        mbar_arrive_expect_tx(q_full, ns * CL::kQPanel);
        for (int i = 0; i < ns; ++i) {
          tma_load_3d(smem + CL::kQ + i * CL::kQPanel, &tm_q, q_full,
                      (sp0 + i) * PANEL_COLS, q0, bh);
        }
      }
      for (int j = 0; j < min(n, 2); ++j) {
        cluster_issue(smem + CL::kK, &tm_k, k_full, k_empty, j, ns, sp0, bhk, lane);
      }
      cluster_issue(smem + CL::kV, &tm_v, v_full, v_empty, 0, np, pg0, bhk, lane);
    }
    if (tid == 0) {
      for (int j = 0; j < min(n, A); ++j) {
        mbar_arrive_expect_tx(reinterpret_cast<uint64_t*>(smem + L.rx_bar(wg, j)), rx_bytes);
        mbar_arrive_expect_tx(&pp_bar[j], pp_bytes);
      }
    }
    // blocks 0 .. A - 1's partials, and the reduction of all but the last
    // (PS holds one block: each is summed before the next overwrites it)
    mbar_wait_fast(q_full, 0);
    for (int j = 0; j < min(n, A); ++j) {
      mbar_wait_fast(&k_full[j & 1], (j >> 1) & 1);
      cluster_partial_s(sn, smem, sq, j, ns);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sn);
      __syncwarp();
      if (lane == 0) mbar_arrive(&k_empty[j & 1]);
      cluster_push_partial(sn, smem, L, wg, j, g, G, tid);
      if (threadIdx.x < 32 && j + 2 <= A && j + 2 < n) {
        cluster_issue(smem + CL::kK, &tm_k, k_full, k_empty, j + 2, ns, sp0, bhk, lane);
      }
      if (j < A - 1) {
        cluster_reduce(smem, L, wg, j, g, G, tid, own, qrow, m, l, kv_len, causal, masked(j),
                       scale_log2, rx_bytes, n);
      }
    }
  }
  for (int j = 0; j < n; ++j) {
    const int set = j & 1;
    const bool ahead = j + A < n;

    // K of block j + A + 1 (warp 0) and V of block j + 1 (warp 7), issued a
    // block before they are read
    if (threadIdx.x < 32 && j + A + 1 < n) {
      cluster_issue(smem + CL::kK, &tm_k, k_full, k_empty, j + A + 1, ns, sp0, bhk, lane);
    }
    if (wg == 1 && w == 3 && j + 1 < n) {
      cluster_issue(smem + CL::kV, &tm_v, v_full, v_empty, j + 1, np, pg0, bhk, lane);
    }

    // block j's P of both row halves, as the A operand, and their factors
    mbar_wait_fast(&pp_bar[j % A], (j / A) & 1);
    if (tid == 0 && j + A < n) mbar_arrive_expect_tx(&pp_bar[j % A], pp_bytes);
    const uint8_t* pp = smem + L.pp_at(wg, j);
    uint32_t pa[BN / 16][4];
    float al[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gid = 2 * w + e;
      const uint4 pw = *reinterpret_cast<const uint4*>(pp + gid * CL::kGroupP + lane * 16);
      const float2 st = *reinterpret_cast<const float2*>(pp + gid * CL::kGroupP + 512 +
                                                         (lane >> 2) * 8);
      pa[0][e] = pw.x;
      pa[0][e + 2] = pw.y;
      pa[1][e] = pw.z;
      pa[1][e + 2] = pw.w;
      al[e] = st.x;
      if (!own[e]) l[e] = st.y;
    }
#pragma unroll
    for (int i = 0; i < PANELS_GP * 8; ++i) {
      o[4 * i] *= al[0];
      o[4 * i + 1] *= al[0];
      o[4 * i + 2] *= al[1];
      o[4 * i + 3] *= al[1];
    }

    // O_g += P V_g: one product of all the group's panels a k16 step; then
    // block j + A's partial, both running while block j + A - 1's partials
    // are reduced
    mbar_wait_fast(&v_full[set], (j >> 1) & 1);
    const uint8_t* vs = smem + CL::kV + set * CL::kSet;
    fence_regs(pa);
    fence_regs(o);
    wgmma_fence();
    switch (np) {
      case 1: cluster_pv<64>(o, pa, vs); break;
      case 2: cluster_pv<128>(o, pa, vs); break;
      case 3: cluster_pv<192>(o, pa, vs); break;
      default: cluster_pv<256>(o, pa, vs); break;
    }
    wgmma_commit();
    if (ahead) {
      mbar_wait_fast(&k_full[(j + A) & 1], ((j + A) >> 1) & 1);
      cluster_partial_s(sn, smem, sq, j + A, ns);
      wgmma_commit();
    }
    if (j + A - 1 < n) {
      cluster_reduce(smem, L, wg, j + A - 1, g, G, tid, own, qrow, m, l, kv_len, causal,
                     masked(j + A - 1), scale_log2, rx_bytes, n);
    }

    // block j's V and block j + A's K are read: release them, write and
    // push block j + A's partial
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    fence_regs(sn);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&v_empty[set]);
      if (ahead) mbar_arrive(&k_empty[(j + A) & 1]);
    }
    if (ahead) cluster_push_partial(sn, smem, L, wg, j + A, g, G, tid);
  }

  // ---- epilogue ----
  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    // an owned row's sum is this thread's columns', another's the owner's
    // whole sum
    float lf = l[e];
    lf += __shfl_xor_sync(0xffffffffu, lf, 1);
    lf += __shfl_xor_sync(0xffffffffu, lf, 2);
    if (!own[e]) lf = l[e];
    const bool ok = qrow[e] < q_len && lf > 0.0f;
    inv[e] = ok ? 1.0f / lf : 0.0f;
    // the owner of a row writes its lse
    if (own[e] && (lane & 3) == 0 && qrow[e] < Tq) {
      lse[size_t(bh) * Tq + qrow[e]] = ok ? m[e] * LN2 + logf(lf) : INFINITY;
    }
  }
  // O goes into the warpgroup's own rows of Q's panels, which only its own
  // S products read
  named_sync(1 + wg, 128);
  uint8_t* so = smem + CL::kQ + wg * 64 * ROW_BYTES;
#pragma unroll
  for (int p = 0; p < PANELS_GP; ++p) {
    if (p < np) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* op = o + 32 * p + 4 * i;
        *reinterpret_cast<uint32_t*>(so + p * CL::kQPanel + swizzled_offset(r, 8 * i + cq)) =
            pack_bf16(op[0] * inv[0], op[1] * inv[0]);
        *reinterpret_cast<uint32_t*>(so + p * CL::kQPanel + swizzled_offset(r + 8, 8 * i + cq)) =
            pack_bf16(op[2] * inv[1], op[3] * inv[1]);
      }
    }
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);
  if (tid == 0 && wq0 < Tq) {
    for (int p = 0; p < np; ++p) {
      tma_store_3d(&tm_o, so + p * CL::kQPanel, (pg0 + p) * PANEL_COLS, wq0, bh);
    }
    tma_store_drain();
  }
  cluster_sync();   // no peer still pushes to this CTA
}

cudaError_t launch_bf16_cluster(const void* q, const void* k, const void* v,
                                const void* q_lens, const void* kv_lens, void* o,
                                void* lse, int B, int H, int Hkv, int Tq, int Tk,
                                int D, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  if (!hopper::make_tmap_bf16(&tq, q, B * H, Tq, D, CL_BM) ||
      !hopper::make_tmap_bf16(&tk, k, B * Hkv, Tk, D, CL_BN) ||
      !hopper::make_tmap_bf16(&tv, v, B * Hkv, Tk, D, CL_BN) ||
      !hopper::make_tmap_bf16(&to, o, B * H, Tq, D, 64)) {
    return cudaErrorNotSupported;
  }
  const int G = panel_cluster(D);
  const int n_qt = (Tq + CL_BM - 1) / CL_BM;
  if (G == 0 || n_qt > 65535 || (long long)G * H >= (1ll << 31)) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_bf16_cluster_kernel;
  const int bytes = ClusterLayout(G).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(G * H), unsigned(B), unsigned(n_qt));
  cfg.blockDim = dim3(THREADS_CLUSTER, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(G);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, to, static_cast<const int*>(q_lens),
                           static_cast<const int*>(kv_lens), static_cast<float*>(lse), H,
                           Hkv, Tq, Tk, D, causal, scale * LOG2E);
  if (err != cudaSuccess) return err;
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


// float32, D > 512: 16-row tiles (flash_common.cuh's `panels` geometry). A
// CTA owns 16 query rows of one (b, h) and one group of up to 256 of O's
// columns; per 16-key block it sums S over the width chunk by chunk (64
// columns of Q and K in shared memory at a time), runs the online softmax,
// and adds P V_g from a tile of the group's V columns.
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_panels_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ q_lens,
                          const int* __restrict__ kv_lens, float* __restrict__ o,
                          float* __restrict__ lse, int H, int Hkv, int Tq, int Tk,
                          int D, int causal, float scale) {
  using namespace flash::panels;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = reinterpret_cast<float*>(smem + kChunk);
  float* sV = reinterpret_cast<float*>(smem + 2 * kChunk);
  float* sP = reinterpret_cast<float*>(smem + 2 * kChunk + kGroup);

  const int G = (D + NG - 1) / NG;
  const int g = int(blockIdx.x) % G;
  const int h = int(blockIdx.x) / G;
  const int b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.z * BLOCK;
  const int c_g = g * NG;                 // the group's first column
  const int ng = min(NG, D - c_g);        // and its columns
  const int q_len = max(0, min(q_lens[b], Tq));
  const int kv_len = max(0, min(kv_lens[b], Tk));

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = lane / LANES;
  const int part = lane % LANES;
  const int qi = q0 + warp * RPW + r;
  float* pw = sP + warp * RPW * LDP;
  const float* qh = q + (size_t(b) * H + h) * Tq * D;
  const float* kh = k + (size_t(b) * Hkv + hk) * Tk * D;
  const float* vh = v + (size_t(b) * Hkv + hk) * Tk * D;

  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + BLOCK, q_len));
  const int n_blocks = q0 < q_len ? (kv_end + BLOCK - 1) / BLOCK : 0;

  Acc acc;
  acc.zero();
  float m_i = -INFINITY;
  float l_i = 0.0f;

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int kv0 = blk * BLOCK;
    float s[COLS];
#pragma unroll
    for (int i = 0; i < COLS; ++i) s[i] = 0.0f;
    for (int c0 = 0; c0 < D; c0 += CW) {
      __syncthreads();  // every warp is done with the previous chunk (and V)
      load_cols<CW, LDC>(sQ, qh, D, q0, q_len, c0, CW);
      load_cols<CW, LDC>(sK, kh, D, kv0, kv_len, c0, CW);
      __syncthreads();
      abt_chunk(sQ + warp * RPW * LDC, sK, r, part, s);
    }

    // Online softmax; the lanes of a row share its max and sum.
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int kj = kv0 + part * COLS + i;
      const bool ok = kj < kv_len && (!causal || kj <= qi);
      s[i] = ok ? s[i] * scale : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = flash::row_max<LANES>(mx);
    const float m_new = fmaxf(m_i, mx);
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;
    const float alpha = __expf(m_i - m_use);
    float rs = 0.0f;
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const float p = __expf(s[i] - m_use);
      rs += p;
      pw[r * LDP + part * COLS + i] = p;
    }
    rs = flash::row_sum<LANES>(rs);
    l_i = l_i * alpha + rs;
    m_i = m_new;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc.v[j] *= alpha;

    __syncthreads();  // P complete; every warp is done with the chunks
    load_cols<NG, LDG>(sV, vh, D, kv0, kv_len, c_g, ng);
    __syncthreads();
    acc.mma(pw, sV, r, part);
  }

  if (qi < Tq) {
    const bool valid = qi < q_len && l_i > 0.0f;
    const float inv = valid ? 1.0f / l_i : 0.0f;
    acc.store(o + ((size_t(b) * H + h) * Tq + qi) * D + c_g, inv, ng, part, true);
    if (part == 0 && g == 0) {
      lse[(size_t(b) * H + h) * Tq + qi] = valid ? m_i + logf(l_i) : INFINITY;
    }
  }
}

cudaError_t launch_f32_panels(const void* q, const void* k, const void* v,
                            const void* q_lens, const void* kv_lens, void* o,
                            void* lse, int B, int H, int Hkv, int Tq, int Tk,
                            int D, int causal, float scale, cudaStream_t stream) {
  using namespace flash::panels;
  auto kernel = flash_fwd_f32_panels_kernel;
  const int bytes = 2 * kChunk + kGroup + kWarpP;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long G = (D + NG - 1) / NG;
  const int n_qt = (Tq + BLOCK - 1) / BLOCK;
  if (n_qt > 65535 || G * H >= (1ll << 31)) return cudaErrorInvalidValue;
  const dim3 grid(unsigned(G * H), B, n_qt);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(q_lens),
      static_cast<const int*>(kv_lens), static_cast<float*>(o),
      static_cast<float*>(lse), H, Hkv, Tq, Tk, D, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns 0 on success, else the cudaError_t of the failed call (the launch
// is checked with cudaGetLastError right after it is enqueued;
// cudaErrorNotSupported if a tensor map could not be encoded; a refused
// cluster launch as it is).
// is_f32: 0 for bfloat16 operands (the wgmma kernels), 1 for float32 (the
// scalar kernels). D is any multiple of 64. float32 takes 64, 128, 256 and
// 512 (ops/attention.py runs the widths between them on zero-padded
// operands: the scalar kernels read by pointer) and every width above 512
// (its panel kernel). bfloat16 runs a width between the compiled ones on
// the next wider kernel at the operands' own width (launch_bf16's
// `width`), and above 512 the clustered kernel (one S per tile) while the
// groups of 256 columns fit the largest portable cluster, CLUSTER_MAX = 8
// (D <= 2048), else the per-group panel kernel, whose groups each compute S.
extern "C" int avsr_flash_fwd(const void* q, const void* k, const void* v,
                              const void* q_lens, const void* kv_lens, void* o,
                              void* lse, int B, int H, int Hkv, int Tq, int Tk,
                              int D, int is_f32, int causal, float scale,
                              void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Tq <= 0 || Tk <= 0 ||
      B > 65535 || H > 65535 || D <= 0 || D % 64 != 0) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 512) {
    if (is_f32) {
      return int(launch_f32_panels(q, k, v, q_lens, kv_lens, o, lse, B, H, Hkv, Tq, Tk, D,
                                   causal, scale, s));
    }
    return int((panel_cluster(D) > 0 ? launch_bf16_cluster : launch_bf16_panels)(
        q, k, v, q_lens, kv_lens, o, lse, B, H, Hkv, Tq, Tk, D, causal, scale, s));
  }
#define AVSR_F32(DD)                                                       \
  return int(launch_f32<DD>(q, k, v, q_lens, kv_lens, o, lse, B, H, Hkv, Tq, \
                            Tk, causal, scale, s))
#define AVSR_BF16(DD)                                                       \
  return int(launch_bf16<DD>(q, k, v, q_lens, kv_lens, o, lse, B, H, Hkv, Tq, \
                             Tk, D, causal, scale, s))
  if (is_f32) {
    if (D == 64) AVSR_F32(64);
    if (D == 128) AVSR_F32(128);
    if (D == 256) AVSR_F32(256);
    if (D == 512) AVSR_F32(512);
  } else {
    if (D == 64) AVSR_BF16(64);
    if (D == 128) AVSR_BF16(128);
    if (D <= 256) AVSR_BF16(256);
    AVSR_BF16(512);
  }
#undef AVSR_F32
#undef AVSR_BF16
  return int(cudaErrorInvalidValue);
}

// The cluster size the bfloat16 forward launches at head width D (0: no
// cluster; is_f32: always 0).
extern "C" int avsr_flash_fwd_cluster(int D, int is_f32) {
  return is_f32 ? 0 : panel_cluster(D);
}
