// Weight-only int8 / int4 matmul at decode shapes for NVIDIA Hopper (sm_90a),
// CUDA C++ with a plain C interface (loaded through ctypes by
// avsr_tpu_torch/ops/qmatmul.py).
//
// Replaces the Pallas TPU kernels avsr_tpu/ops/qmatmul.py::_int8_kernel and
// ::_int4_kernel (launched by qmatmul, reached through ops/quant.py::qdot for
// every product of at most 64 rows: each LLM projection of a decode step and
// the int8 lm head). For x [M, K] and a weight quantized per output column:
//   y[M, N] = scale[N] * (bf16(x) @ q),   q int8 [K, N]
// int4 ("qw4h", half-split): byte row i of the packed [K/2, N] holds logical
// row i in its low nibble and row i + K/2 in its high nibble, both signed, so
// byte row i pairs with x[:, i] and x[:, K/2 + i]. x (bf16 or f32) is
// rounded to bf16 as the TPU kernel does for its matrix unit; each product
// of a bf16 value and an integer of at most 8 bits is exact in f32 and the
// sum is f32; the scale (bf16 or f32) is applied once after the K loop.
// The output is written in f32 or bf16 (the f32 sum rounded once).
//
// Bound on the card. Bytes: the packed weight, the scale, x and the output,
// each once; at M = 8 the weight is nearly all of it (flagship, int4: qkv
// 3.1 MB, o 2.1 MB, gateup 16.8 MB, down 8.4 MB; the int8 head 264 MB over
// the 129,024 padded vocab columns: 79 us at 3.35 TB/s). Operations:
// 2 M K N, 0.54 GFLOP for the int4 gateup, 4.2 GFLOP for the head, far
// below the tensor-core rate. So the kernels are bound by bytes, and they
// must stream every weight byte once, coalesced, with enough loads in
// flight, and convert the integers in fewer instructions than the bytes
// take to arrive (the head's 264 MB are 2 G values: at 8 FMAs a value on
// the CUDA cores the FMA pipe alone needs ~60 us).
//
// int8 (qmatmul_int8_kernel): the tensor cores, one launch, a TMA ring.
//   * Products: mma.sync m16n8k16 bf16 -> f32 with the operands swapped, as
//     for int4 below: the weight is A (16 output columns, 16 k), x is B (8
//     rows of x as n8). Inside one mma the order of k and of the columns is
//     free, so the fragment's k pair t is the weight rows (2t, 2t + 1) of the
//     k step and k pair t + 4 the rows (2t + 8, 2t + 9): lane (g, t) takes
//     16 bytes (columns 16g..16g+15) of each of its four rows, and one
//     column of two rows is one bf16x2 A register. No repacking: the JAX
//     "qw" leaf is the only layout.
//   * Conversion without a float instruction per value: one byte permute
//     puts the two bytes in the low bytes of the halves, two lop3s make bf16
//     128 + (low 7 bits) and 128 or 256 (the sign bit), and one bf16x2
//     subtraction of the two gives both int8 values exactly: 2 instructions
//     a byte (the CUDA-core design spent 10: a permute, a subtraction and 8
//     FMAs).
//   * Bytes in flight: a persistent grid (one CTA per SM) walks a list of
//     units (128 output columns x 8 or 16 rows of x x a range of weight
//     rows). One producer thread (of a warpgroup that gives its registers
//     to the consumers) streams each unit's rows by TMA (a 2-D map over the
//     weight, 128-byte swizzle, zeros past K) into a ring of six 128-row
//     stages, 16 KB each (96 KB in flight per SM; nine fit, and six
//     measured best over the five flagship shapes), and it runs on into the
//     next unit while the consumers end this one. The 8 consumer warps take
//     one k step of each stage each and read it with 16-byte loads,
//     conflict-free through the swizzle.
//   * x: the producer loads a unit's x (up to 2048 / NT columns) by TMA
//     before its weight, as 64-column panels in the same swizzle, from
//     which a lane's B registers are two conflict-free 32-bit loads. (Staged
//     by the consumers instead, x's loads queued behind the weight stream
//     and held the first products back, PERF.md.) f32 x, K % 64 != 0
//     or the byte-load variant below stage it by the consumers.
//   * One launch: where one wave of units leaves SMs idle, the weight rows
//     are split over up to 8 CTAs per output tile (ops/qmatmul.py::int8_plan,
//     the rule of int4_plan, each split starting on a 64-column panel of x),
//     and the tile's last CTA adds the splits' sums in split order, as int4
//     does: no second kernel, no float atomics, the same bits on every run.
//     A CTA counts itself with one acquire-release atomic after a barrier
//     (per-thread fences before a relaxed one measured slower).
//   * N % 16 != 0 (TMA's row-stride rule) or a weight that is not 16-byte
//     aligned takes the same kernel with the ring replaced by each lane's
//     own byte loads: right at every shape, fast at none.
//
// int4 (qmatmul_int4_kernel): the tensor cores, one launch.
//   * Products: mma.sync m16n8k16 bf16 -> f32 with the operands swapped: the
//     weight is A (16 output columns as its rows, 16 k as its depth), x is B
//     (8 rows of x as n8). At most 16 rows of x per CTA (two n8 tiles); more
//     rows take more CTAs, next to each other in launch order.
//   * No repacking: inside one mma the order of k and of the output columns
//     is free. The fragment's k pair (2t, 2t + 1) is the logical row pair
//     (i, i + K/2) of one packed byte row i, so one packed byte is one bf16x2
//     A register, and the B register is the pair (x[m][i], x[m][K/2 + i])
//     rounded to bf16, which each lane loads itself with the weight (x is
//     small and sits in L2; staging it in shared memory first put a barrier
//     before the first product and measured slower). A k step is 8 packed
//     rows. Lane (g, t) (g = lane / 4, t = lane % 4) of a warp loads
//     16 bytes of packed rows t and t + 4: columns 16g..16g+15 of the warp's
//     128, so the 8 lanes of one row read 128 contiguous bytes; byte j goes
//     to mma tile j / 2, fragment row g (j even) or g + 8 (j odd). The
//     accumulators then hold columns 16g..16g+15 of rows 2t, 2t + 1.
//   * Conversion without a float instruction per value: the word is XORed
//     with 0x88888888 (each nibble n -> n + 8 in 0..15), one byte permute
//     puts a byte's two nibbles in the low bits of two halves, one lop3
//     masks them and ORs in bf16 0x4300 (128 + u), and one bf16x2
//     subtraction of 136 gives the two signed values exactly.
//   * Loads: 128-bit read-only loads of the weight and the lane's x values,
//     two k steps of a warp per batch, in two sets of registers: the next
//     batch is in flight while the current one is multiplied. (A cp.async
//     ring of 8 k steps per warp, four times the bytes in flight, measured
//     slower at every flagship shape; so did 16 warps per CTA: PERF.md.)
//   * K split in one launch: a CTA's 8 warps take interleaved k steps of the
//     CTA's packed rows, and the CTAs of one output tile take consecutive
//     row ranges (up to 8 splits, as many as one wave of one CTA per SM
//     holds; ops/qmatmul.py::int4_plan). The warps' sums are added in shared
//     memory in warp order. With more than one split each CTA writes its
//     split's sums to a scratch buffer (L2-resident) and counts itself in
//     the tile's integer counter; the last CTA to arrive adds the splits'
//     sums in split order, applies the scale (read at the start) and stores,
//     and sets the counter back to 0 for the next launch. No float atomics:
//     the same bits on every run. (A thread-block cluster adding the sums
//     through distributed shared memory measured slower: PERF.md.)
//   What still holds it back (PERF.md): at the flagship's shapes a launch
//   is a few DRAM round trips long (the first batch, the split's hand-off
//   through L2, the last CTA's reads), and the weight streams at about
//   half the memory rate in 128-byte rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr int MAX_SMEM = 232448;                 // what a CTA may use on sm_90

// dtype codes (ops/qmatmul.py _KINDS): 0 bf16, 1 f32
constexpr int kF32 = 1;

__device__ __forceinline__ float load_float(const void* p, size_t i, int kind) {
  if (kind == kF32) return static_cast<const float*>(p)[i];
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_float(void* p, size_t i, float v, int kind) {
  if (kind == kF32) {
    static_cast<float*>(p)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  }
}

// ---------------------------------------------------------------------------
// int4: mma.sync on the tensor cores, one launch
// ---------------------------------------------------------------------------

constexpr int I4_WARPS = 8;
constexpr int I4_THREADS = 32 * I4_WARPS;
constexpr int I4_BN = 128;           // output columns of a CTA, and of each of its warps
constexpr int I4_KSTEP = 8;          // packed rows of one k16 mma step
constexpr int I4_UNROLL = 2;         // k steps of a warp per batch of loads
constexpr int I4_RED_PITCH = I4_BN + 8;   // floats per row of a warp's partial sums
constexpr int MAX_SPLIT = 8;

// Dynamic shared memory of a CTA with NT n8 tiles of x: the warps' partial
// sums.
constexpr size_t i4_smem_bytes(int nt) {
  return static_cast<size_t>(I4_WARPS) * (8 * nt) * I4_RED_PITCH * 4;
}
static_assert(i4_smem_bytes(2) <= MAX_SMEM, "the int4 CTA's partial sums must fit");

// 16 bytes of one packed row at a lane's 16 columns (byte j is column j).
// VEC: one 128-bit load (N % 16 == 0 and an aligned weight, so the lane's
// columns are all in range or all out); otherwise byte loads. Columns at or
// past `left`, and every column when left <= 0, give 0.
template <bool VEC>
__device__ __forceinline__ uint4 load16(const int8_t* p, int left) {
  if (VEC) return left > 0 ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    if (c < left) v[c / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + c))) << (8 * (c % 4));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// x[i] as raw bits: an f32's, or a bf16's in the low half.
__device__ __forceinline__ uint32_t x_bits(const void* x, size_t i, int kind) {
  if (kind == kF32) return __float_as_uint(__ldg(static_cast<const float*>(x) + i));
  return __ldg(static_cast<const unsigned short*>(x) + i);
}

// The bf16x2 B register (x[m][i], x[m][K/2 + i]) from x_bits of the two,
// f32 rounded to bf16 here.
__device__ __forceinline__ uint32_t x_pair(uint32_t lo, uint32_t hi, int kind) {
  if (kind == kF32) return hopper::pack_bf16(__uint_as_float(lo), __uint_as_float(hi));
  return lo | (hi << 16);
}

// One batch of a warp's k steps ks0, ks0 + I4_WARPS, ... (I4_UNROLL of
// them): per k step the lane's 16 weight bytes of packed rows t and t + 4
// (h = 0, 1) and the x values its B registers take, x[m][r] and
// x[m][K/2 + r] for those rows and the lane's row m = g of each n8 tile.
template <int NT>
struct KBatch {
  uint4 w[I4_UNROLL][2];
  uint32_t x[I4_UNROLL][NT][2][2];   // [u][nt][h][lo, hi] as x_bits
};

// Issues the loads of a batch. p points at packed row t of the CTA's first
// row, column 16g; xp is the index of x[m0 + g][r0 + t]. Rows at or past
// nrows, rows of x at or past M (n8 tile nt is valid while nt < m_tiles)
// and columns past N give 0.
template <int NT, bool VEC>
__device__ __forceinline__ void load_kbatch(KBatch<NT>& b, const int8_t* p, size_t N,
                                            const void* x, size_t xp, int K, int x_kind,
                                            int ks0, int t, int nrows, int left, int m_tiles) {
#pragma unroll
  for (int u = 0; u < I4_UNROLL; ++u) {
    const int ks = ks0 + u * I4_WARPS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ks * I4_KSTEP + 4 * h;
      const bool row_ok = r + t < nrows;
      b.w[u][h] = load16<VEC>(p + static_cast<size_t>(r) * N, row_ok ? left : 0);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bool ok = row_ok && nt < m_tiles;
        const size_t i = xp + static_cast<size_t>(nt) * 8 * K + r;
        b.x[u][nt][h][0] = ok ? x_bits(x, i, x_kind) : 0u;
        b.x[u][nt][h][1] = ok ? x_bits(x, i + K / 2, x_kind) : 0u;
      }
    }
  }
}

// Byte b of a packed word as the bf16x2 A register (low nibble, high
// nibble): `biased` is the word XOR 0x88888888 (nibble n -> n + 8), `high`
// the same shifted right by 4. The byte permute puts the two nibbles into
// the low bits of the two halves, the mask and OR make bf16 128 + u, and the
// subtraction of 136 leaves u - 8, exactly.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t biased, uint32_t high, int b) {
  const uint32_t v = (__byte_perm(biased, high, 0x4400u + 0x1111u * b) & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   __floats2bfloat162_rn(136.0f, 136.0f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// acc += the products of k step u of a batch: the lane's 16 bytes of
// packed rows t (w[0]) and t + 4 (w[1]) against its x pairs of the same
// rows (the B registers of k pairs t and t + 4). Byte j of the 16 goes to
// mma tile j / 2, fragment row g (j even) or g + 8 (j odd).
template <int NT>
__device__ __forceinline__ void kstep_mma(float (&acc)[NT][8][4], const KBatch<NT>& b, int u,
                                          int x_kind) {
  const uint4 (&w)[2] = b.w[u];
  uint32_t bx[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) bx[nt][h] = x_pair(b.x[u][nt][h][0], b.x[u][nt][h][1], x_kind);
  }
  const uint32_t lo[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
  const uint32_t hi[4] = {w[1].x, w[1].y, w[1].z, w[1].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b0 = lo[i] ^ 0x88888888u, b1 = hi[i] ^ 0x88888888u;
    const uint32_t h0 = b0 >> 4, h1 = b1 >> 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int jt = 2 * i + half;
      const uint32_t a[4] = {nibble_pair(b0, h0, 2 * half), nibble_pair(b0, h0, 2 * half + 1),
                             nibble_pair(b1, h1, 2 * half), nibble_pair(b1, h1, 2 * half + 1)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) hopper::mma_m16n8k16_bf16(acc[nt][jt], a, bx[nt][0], bx[nt][1]);
    }
  }
}

// One CTA: output columns [tile * I4_BN, +I4_BN) of x rows [m0, m0 + 8 NT)
// over packed rows [r0, r0 + rows_per_cta) of split blockIdx.x (gridDim.x
// splits). partial: [tile][split][8 NT][I4_BN] f32, counters: [tile] int,
// 0 between launches (both unused with one split).
template <int NT, bool VEC>
__global__ void __launch_bounds__(I4_THREADS, 1)
qmatmul_int4_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
                    const void* __restrict__ scale, void* __restrict__ out,
                    float4* __restrict__ partial, int* __restrict__ counters, int M, int K,
                    int N, int rows_per_cta, int x_kind, int scale_kind, int out_kind) {
  constexpr int MTI = 8 * NT;                 // rows of x of the CTA
  extern __shared__ float4 smem4[];

  const int half_k = K / 2;                   // packed rows
  const int split = blockIdx.x;
  const int tile = blockIdx.y;
  const int m0 = blockIdx.z * MTI;
  const int r0 = split * rows_per_cta;
  const int nrows = max(0, min(half_k, r0 + rows_per_cta) - r0);
  const int nks = (nrows + I4_KSTEP - 1) / I4_KSTEP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = tile * I4_BN + 16 * g;
  // n8 tiles whose row g of x exists
  const int m_tiles = M > m0 + g ? min(NT, (M - m0 - g + 7) / 8) : 0;

  float acc[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][j][e] = 0.f;
    }
  }

  // The scales of the thread's first output float4 (the epilogue's item
  // threadIdx.x), read now so that the load is not on the epilogue's path.
  constexpr int ITEMS = MTI * I4_BN / 4;      // float4s of the CTA's outputs
  float own_scale[4] = {0.f, 0.f, 0.f, 0.f};
  if (threadIdx.x < ITEMS) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gn = tile * I4_BN + 4 * (threadIdx.x % (I4_BN / 4)) + e;
      if (gn < N) own_scale[e] = load_float(scale, gn, scale_kind);
    }
  }

  const int8_t* p = w + (static_cast<size_t>(r0) + t) * N + (n0 < N ? n0 : 0);
  const int left = N - n0;
  const size_t xp = static_cast<size_t>(m0 + g) * K + r0 + t;
  const int batch = I4_WARPS * I4_UNROLL;     // k steps of the CTA per batch
  // Two batches in turn (no register copies, which would wait for the
  // loads): a is multiplied while b is in flight, then the other way round.
  KBatch<NT> a, b;
  load_kbatch<NT, VEC>(a, p, N, x, xp, K, x_kind, warp, t, nrows, left, m_tiles);
  auto multiply = [&](const KBatch<NT>& kb, int ks0) {
#pragma unroll
    for (int u = 0; u < I4_UNROLL; ++u) {
      if (ks0 + u * I4_WARPS < nks) kstep_mma<NT>(acc, kb, u, x_kind);
    }
  };
  for (int ks0 = warp; ks0 < nks; ks0 += 2 * batch) {
    const int ks1 = ks0 + batch;
    if (ks1 < nks) load_kbatch<NT, VEC>(b, p, N, x, xp, K, x_kind, ks1, t, nrows, left, m_tiles);
    multiply(a, ks0);
    if (ks1 + batch < nks) {
      load_kbatch<NT, VEC>(a, p, N, x, xp, K, x_kind, ks1 + batch, t, nrows, left, m_tiles);
    }
    if (ks1 < nks) multiply(b, ks1);
  }

  // Warp partials [warp][row of x][column] in shared memory: tile jt of n8
  // tile nt holds columns 16g + 2jt (+1 in elements 2, 3) of rows 2t
  // (elements 0, 2) and 2t + 1 (1, 3).
  float* red = reinterpret_cast<float*>(smem4);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int m = nt * 8 + 2 * t;
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      const int c = 16 * g + 2 * jt;
      *reinterpret_cast<float2*>(red + (warp * MTI + m) * I4_RED_PITCH + c) =
          make_float2(acc[nt][jt][0], acc[nt][jt][2]);
      *reinterpret_cast<float2*>(red + (warp * MTI + m + 1) * I4_RED_PITCH + c) =
          make_float2(acc[nt][jt][1], acc[nt][jt][3]);
    }
  }
  __syncthreads();

  // The CTA's sum of item i (4 columns of one row of x), in warp order.
  auto cta_sum = [&](int i) {
    const int m = i / (I4_BN / 4), c4 = i % (I4_BN / 4);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int wi = 0; wi < I4_WARPS; ++wi) {
      const float4 v = *reinterpret_cast<const float4*>(red + (wi * MTI + m) * I4_RED_PITCH + 4 * c4);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    return s;
  };
  // scale * sum of item i to the output.
  auto store = [&](int i, const float4& s) {
    const int gm = m0 + i / (I4_BN / 4);
    const int gn = tile * I4_BN + 4 * (i % (I4_BN / 4));
    if (gm >= M) return;
    const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (gn + e < N) {
        const float sc = i == static_cast<int>(threadIdx.x) ? own_scale[e] : load_float(scale, gn + e, scale_kind);
        store_float(out, static_cast<size_t>(gm) * N + gn + e, sv[e] * sc, out_kind);
      }
    }
  };

  const int splits = gridDim.x;
  if (splits == 1) {
    for (int i = threadIdx.x; i < ITEMS; i += I4_THREADS) store(i, cta_sum(i));
    return;
  }
  // Several splits: this split's sums to the scratch buffer, then the last
  // CTA of the tile to arrive adds them all in split order.
  const int tile_id = blockIdx.z * gridDim.y + blockIdx.y;
  float4* part = partial + static_cast<size_t>(tile_id) * splits * ITEMS;
  for (int i = threadIdx.x; i < ITEMS; i += I4_THREADS) part[split * ITEMS + i] = cta_sum(i);
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  if (threadIdx.x == 0) is_last = atomicAdd(&counters[tile_id], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < ITEMS; i += I4_THREADS) {
    float4 v[MAX_SPLIT];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLIT; ++sp) {
      if (sp < splits) v[sp] = __ldcg(part + sp * ITEMS + i);
    }
    float4 s = v[0];
#pragma unroll
    for (int sp = 1; sp < MAX_SPLIT; ++sp) {
      if (sp < splits) {
        s.x += v[sp].x; s.y += v[sp].y; s.z += v[sp].z; s.w += v[sp].w;
      }
    }
    store(i, s);
  }
  if (threadIdx.x == 0) counters[tile_id] = 0;   // ready for the next launch
}

template <int NT, bool VEC>
cudaError_t launch_int4_kernel(const void* x, const void* w, const void* scale, void* out,
                               void* partial, void* counters, int M, int K, int N, int splits,
                               int rows_per_cta, int x_kind, int scale_kind, int out_kind,
                               cudaStream_t stream) {
  auto kernel = qmatmul_int4_kernel<NT, VEC>;
  const size_t smem = i4_smem_bytes(NT);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(splits, (N + I4_BN - 1) / I4_BN, (M + 8 * NT - 1) / (8 * NT));
  kernel<<<grid, I4_THREADS, smem, stream>>>(
      x, static_cast<const int8_t*>(w), scale, out, static_cast<float4*>(partial),
      static_cast<int*>(counters), M, K, N, rows_per_cta, x_kind, scale_kind, out_kind);
  return cudaGetLastError();
}

int launch_int4(const void* x, const void* w, const void* scale, void* out, void* partial,
                void* counters, int M, int K, int N, int splits, int rows_per_cta,
                int n8_tiles, int x_kind, int scale_kind, int out_kind, void* stream) {
  const int rows = K / 2;
  if (M <= 0 || N <= 0 || K <= 0 || K % 2 != 0 || splits < 1 || splits > MAX_SPLIT ||
      rows_per_cta < 1 || static_cast<long long>(splits) * rows_per_cta < rows ||
      static_cast<long long>(splits - 1) * rows_per_cta >= rows ||
      (n8_tiles != 1 && n8_tiles != 2) || (M + 8 * n8_tiles - 1) / (8 * n8_tiles) > 65535 ||
      (N + I4_BN - 1) / I4_BN > 65535 ||
      (splits > 1 && (partial == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
#define AVSR_I4(NT_, VEC_)                                                             \
  return static_cast<int>(launch_int4_kernel<NT_, VEC_>(                               \
      x, w, scale, out, partial, counters, M, K, N, splits, rows_per_cta, x_kind, \
      scale_kind, out_kind, st))
  if (n8_tiles == 1) {
    if (vec) AVSR_I4(1, true);
    AVSR_I4(1, false);
  }
  if (vec) AVSR_I4(2, true);
  AVSR_I4(2, false);
#undef AVSR_I4
}

// ---------------------------------------------------------------------------
// int8: mma.sync on the tensor cores, one launch, the weight on a TMA ring
// ---------------------------------------------------------------------------

constexpr int kBF16 = 0;
constexpr int I8_WARPS = 8;                              // consumer warps
constexpr int I8_CONSUMERS = 32 * I8_WARPS;
// RING: two consumer warpgroups and a producer warpgroup, whose registers
// setmaxnreg hands to the consumers (nine warps would cap every thread at
// 168, too few for two n8 tiles of x); otherwise the consumers alone.
constexpr int i8_threads(bool ring) { return ring ? I8_CONSUMERS + 128 : I8_CONSUMERS; }
constexpr int I8_BN = 128;                               // output columns of a unit
constexpr int I8_KSTEP = 16;                             // weight rows of one k16 mma step
constexpr int I8_STAGE_ROWS = I8_WARPS * I8_KSTEP;       // 128: one k step per warp
constexpr int I8_STAGE_BYTES = I8_STAGE_ROWS * I8_BN;    // 16 KB
constexpr int I8_X_BYTES = 32 * 1024;                    // x of one chunk, staged
constexpr int I8_SPLIT_ALIGN = 64;                       // a split starts on a panel of x
constexpr int I8_RED_PITCH = I8_BN + 4;                  // floats per row of a warp's sums
constexpr int I8_SYNC = 1;                               // the consumers' named barrier

constexpr int I8_STAGES = 6;     // ring depth (96 KB): 9 fit, 6 measured best (PERF.md)

// Shared memory of a CTA with NT n8 tiles of x: the ring of weight stages
// (RING only; 1024-byte aligned for the 128-byte swizzle), x of one chunk of
// columns (x_offset's layout, also 1024-byte aligned), the warps' sums, the
// mbarriers of the ring and of x, and 1 KB of slack to align the start.
template <int NT, bool RING>
struct I8Layout {
  static constexpr int kRed = I8_WARPS * 8 * NT * I8_RED_PITCH * 4;
  static constexpr int kStages = RING ? I8_STAGES : 0;
  static constexpr int kX = kStages * I8_STAGE_BYTES;
  static constexpr int kRedOff = kX + I8_X_BYTES;
  static constexpr int kBar = kRedOff + kRed;
  static constexpr int kBytes = kBar + 16 * kStages + 16 + 1024;   // + x_full, x_empty
  // rows of x staged at a time: 2048 / NT, a whole number of stages
  static constexpr int kChunkRows = I8_X_BYTES / (NT * 32 * 8) * I8_KSTEP;
  static_assert(kBytes <= MAX_SMEM, "the int8 CTA's shared memory must fit");
  static_assert(!RING || kStages >= 3, "the int8 ring needs stages");
  static_assert(kChunkRows % I8_STAGE_ROWS == 0, "a chunk of x is whole stages");
};

// Byte b of the words lo and hi (one column of two weight rows) as the
// bf16x2 A register, lo's byte in the low half, exactly: one byte permute
// puts the two bytes in the low bytes of the halves; one lop3 keeps their
// low 7 bits u under bf16 0x4300 (128 + u), one their sign bit under it
// (128, or 256 for a set sign), and one bf16x2 subtraction of the two
// leaves u - 128 * sign, the int8 value (every step exact in bf16).
__device__ __forceinline__ uint32_t byte_pair(uint32_t lo, uint32_t hi, int b) {
  const uint32_t h = __byte_perm(lo, hi, static_cast<uint32_t>(b | ((b + 4) << 8)));
  const uint32_t u = (h & 0x007F007Fu) | 0x43004300u;
  const uint32_t s = (h & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u),
                                   *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// acc += one k16 step of a lane (g, t): w[0..3] are its 16 bytes (columns
// 16g..16g+15 of the unit) of the step's rows 2t, 2t + 1, 2t + 8 and
// 2t + 9, xb[nt] its B registers of n8 tile nt. Rows 2t, 2t + 1 are the
// fragment's k pair t and rows 2t + 8, 2t + 9 its k pair t + 4; byte j of
// the 16 goes to mma tile j / 2, fragment row g (j even) or g + 8 (j odd).
template <int NT>
__device__ __forceinline__ void kstep_int8(float (&acc)[NT][8][4], const uint4 (&w)[4],
                                           const uint2 (&xb)[NT]) {
  const uint32_t r0[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
  const uint32_t r1[4] = {w[1].x, w[1].y, w[1].z, w[1].w};
  const uint32_t r8[4] = {w[2].x, w[2].y, w[2].z, w[2].w};
  const uint32_t r9[4] = {w[3].x, w[3].y, w[3].z, w[3].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t a[4] = {byte_pair(r0[i], r1[i], 2 * half), byte_pair(r0[i], r1[i], 2 * half + 1),
                             byte_pair(r8[i], r9[i], 2 * half), byte_pair(r8[i], r9[i], 2 * half + 1)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        hopper::mma_m16n8k16_bf16(acc[nt][2 * i + half], a, xb[nt].x, xb[nt].y);
      }
    }
  }
}

// Byte offset of x[m0 + m][c0 + kk] (m < 8 NT, kk a column of the chunk) in
// the staged x: 64-column panels of the unit's 8 NT rows, each row 128
// bytes with the 128-byte swizzle (chunk c of row m at chunk c ^ (m % 8)),
// which is what a TMA box of x viewed as [K / 64][M][64] leaves. The B
// register pairs of a k step, (2t, 2t + 1) and (2t + 8, 2t + 9) of row g,
// are then 32-bit words in 8 distinct 16-byte chunks across g, so a warp's
// reads are conflict-free.
template <int NT>
__device__ __forceinline__ uint32_t x_offset(int m, int kk) {
  return ((kk >> 6) * 8 * NT + m) * hopper::ROW_BYTES + ((((kk & 63) >> 3) ^ (m & 7)) << 4) +
         (kk & 7) * 2;
}

// Stages x[m0 .. m0 + 8 NT)[c0 .. c1) in that layout, rounded to bf16, 0
// past M and past c1 up to the chunk's last k step: the consumers' way
// where the producer cannot load x by TMA (f32 x, K % 64 != 0, or no ring).
template <int NT>
__device__ void stage_x(uint8_t* xs, const void* x, int x_kind, int M, int K, int m0, int c0,
                        int c1, int tid) {
  const int half_cols = (c1 - c0 + I8_KSTEP - 1) / I8_KSTEP * (I8_KSTEP / 2);
#pragma unroll 4
  for (int i = tid; i < 8 * NT * half_cols; i += I8_CONSUMERS) {
    const int m = i / half_cols, kk = 2 * (i % half_cols);
    const bool row = m0 + m < M;
    const size_t at = static_cast<size_t>(m0 + m) * K + c0 + kk;
    const float lo = row && c0 + kk < c1 ? load_float(x, at, x_kind) : 0.f;
    const float hi = row && c0 + kk + 1 < c1 ? load_float(x, at + 1, x_kind) : 0.f;
    *reinterpret_cast<uint32_t*>(xs + x_offset<NT>(m, kk)) = hopper::pack_bf16(lo, hi);
  }
}

// The work is a list of units (m tile, output tile, split): x rows
// [8 NT mt, +8 NT), output columns [128 tile, +128), weight rows
// [split * rows_per_split, +rows_per_split). Units run in list order on a
// persistent grid (CTA c takes units c, c + gridDim.x, ...), with the m
// tiles and then the splits of one output tile next to each other. RING:
// the producer warp streams each unit's weight rows by TMA through a ring of
// 128-row stages in the same order, so the next unit's loads are in flight
// while the consumers end this one. Otherwise (N % 16 != 0, or a weight not
// 16-byte aligned) each lane loads its own bytes. partial:
// [m tile, tile][split][8 NT][128] f32 and counters: [m tile, tile] int, 0
// between launches (both unused with one split).
template <int NT, bool RING>
__global__ void __launch_bounds__(i8_threads(RING), 1)
qmatmul_int8_kernel(const __grid_constant__ CUtensorMap tm_stage,
                    const __grid_constant__ CUtensorMap tm_step,
                    const __grid_constant__ CUtensorMap tm_x, int x_tma,
                    const void* __restrict__ x,
                    const int8_t* __restrict__ w, const void* __restrict__ scale,
                    void* __restrict__ out, float4* __restrict__ partial,
                    int* __restrict__ counters, int M, int K, int N, int splits,
                    int rows_per_split, int x_kind, int scale_kind, int out_kind) {
  using L = I8Layout<NT, RING>;
  constexpr int S = L::kStages;
  constexpr int MTI = 8 * NT;                  // rows of x of a unit
  constexpr int ITEMS = MTI * I8_BN / 4;       // float4s of a unit's outputs
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_atom(smem_raw);
  uint8_t* xs = smem + L::kX;
  float* red = reinterpret_cast<float*>(smem + L::kRedOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + S;
  uint64_t* x_full = empty + S;
  uint64_t* x_empty = x_full + 1;
  __shared__ int is_last;

  const int tiles = (N + I8_BN - 1) / I8_BN;
  const int mtiles = (M + MTI - 1) / MTI;
  const int units = tiles * splits * mtiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // x's TMA box: the 64-column panels of a chunk, or of a shorter split
  const int x_box_bytes = min(L::kChunkRows, rows_per_split) * MTI * 2;

  if constexpr (RING) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&empty[s], I8_WARPS);
      }
      hopper::mbar_init(x_full, 1);
      hopper::mbar_init(x_empty, I8_WARPS);
      hopper::fence_barrier_init();
    }
  }
  __syncthreads();

  if (warp >= I8_WARPS) {
    // ---- producer: one thread issues the ring's TMA loads ----
    if constexpr (RING) {
      hopper::setmaxnreg_dec<40>();
      if (threadIdx.x == I8_CONSUMERS) {
        int it = 0;                            // stages loaded
        int xl = 0, x_c0 = -1, x_m0 = -1;      // x loads, the last one's chunk
        for (int u = blockIdx.x; u < units; u += gridDim.x) {
          const int mt = u % mtiles, rest = u / mtiles;
          const int split = rest % splits, col0 = rest / splits * I8_BN;
          const int r0 = split * rows_per_split;
          const int r1 = min(K, r0 + rows_per_split);
          for (int c0 = r0; c0 < r1; c0 += L::kChunkRows) {
            if (x_tma && (c0 != x_c0 || mt * MTI != x_m0)) {
              // the chunk's x first, once the consumers are done with the last
              hopper::mbar_wait(x_empty, (xl & 1) ^ 1);
              hopper::mbar_arrive_expect_tx(x_full, x_box_bytes);
              hopper::tma_load_3d(xs, &tm_x, x_full, 0, mt * MTI, c0 / hopper::PANEL_COLS);
              ++xl;
              x_c0 = c0;
              x_m0 = mt * MTI;
            }
            const int c1 = min(r1, c0 + L::kChunkRows);
            for (int r = c0; r < c1; r += I8_STAGE_ROWS, ++it) {
              const int s = it % S;
              hopper::mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
              uint8_t* dst = smem + s * I8_STAGE_BYTES;
              const int rows = min(I8_STAGE_ROWS, c1 - r);
              if (rows == I8_STAGE_ROWS) {
                hopper::mbar_arrive_expect_tx(&full[s], I8_STAGE_BYTES);
                hopper::tma_load_2d(dst, &tm_stage, &full[s], col0, r);
              } else {             // a unit's last rows: one 16-row box per k step
                const int steps = (rows + I8_KSTEP - 1) / I8_KSTEP;
                hopper::mbar_arrive_expect_tx(&full[s], steps * I8_KSTEP * I8_BN);
                for (int j = 0; j < steps; ++j) {
                  hopper::tma_load_2d(dst + j * I8_KSTEP * I8_BN, &tm_step, &full[s], col0,
                                      r + j * I8_KSTEP);
                }
              }
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warp w takes k step w of every stage ----
  if constexpr (RING) hopper::setmaxnreg_inc<232>();
  const int tid = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  int it = 0;                                  // stages consumed
  int xl = 0;                                  // x chunks taken
  int staged_c0 = -1, staged_m0 = -1;          // the x chunk in shared memory
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int mt = u % mtiles, rest = u / mtiles;
    const int split = rest % splits, tile = rest / splits;
    const int m0 = mt * MTI, col0 = tile * I8_BN;
    const int r0 = split * rows_per_split;
    const int r1 = min(K, r0 + rows_per_split);

    // The scales of the thread's 4 output columns (the same for each of
    // its items), read now so that the load is not on the epilogue's path.
    float sc[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gn = col0 + 4 * (tid % (I8_BN / 4)) + e;
      sc[e] = gn < N ? load_float(scale, gn, scale_kind) : 0.f;
    }
    float acc[NT][8][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][j][e] = 0.f;
      }
    }

    for (int c0 = r0; c0 < r1; c0 += L::kChunkRows) {
      const int c1 = min(r1, c0 + L::kChunkRows);
      if (c0 != staged_c0 || m0 != staged_m0) {
        if (x_tma) {
          if (xl > 0) {                       // this warp is done with the old x
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(x_empty);
          }
          hopper::mbar_wait(x_full, xl & 1);
        } else {
          hopper::named_sync(I8_SYNC, I8_CONSUMERS);   // every warp is done with the old x
          stage_x<NT>(xs, x, x_kind, M, K, m0, c0, c1, tid);
          hopper::named_sync(I8_SYNC, I8_CONSUMERS);
        }
        ++xl;
        staged_c0 = c0;
        staged_m0 = m0;
      }
      const int nsteps = (c1 - c0 + I8_KSTEP - 1) / I8_KSTEP;
      for (int i = 0; i * I8_WARPS < nsteps; ++i) {
        const int step = i * I8_WARPS + warp;          // of the chunk
        uint4 wv[4];
        int s = 0;
        if constexpr (RING) {
          s = it % S;
          hopper::mbar_wait(&full[s], (it / S) & 1);
          if (step < nsteps) {
            // rows 2t, 2t + 1, 2t + 8, 2t + 9 of the warp's 16, chunk g of
            // each as the 128-byte swizzle placed it (conflict-free: the
            // eight lanes of a quarter warp read eight distinct chunks)
            const uint8_t* sb = smem + s * I8_STAGE_BYTES;
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const int r = I8_KSTEP * warp + 2 * t + (h & 1) + 8 * (h >> 1);
              wv[h] = *reinterpret_cast<const uint4*>(sb + r * I8_BN + ((g ^ (r & 7)) << 4));
            }
          }
        } else if (step < nsteps) {
          const int left = N - (col0 + 16 * g);
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int r = c0 + I8_KSTEP * step + 2 * t + (h & 1) + 8 * (h >> 1);
            wv[h] = load16<false>(w + static_cast<size_t>(r) * N + col0 + 16 * g,
                                  r < c1 ? left : 0);
          }
        }
        if (step < nsteps) {
          uint2 xb[NT];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int kk = I8_KSTEP * step + 2 * t;
            xb[nt] = make_uint2(
                *reinterpret_cast<const uint32_t*>(xs + x_offset<NT>(8 * nt + g, kk)),
                *reinterpret_cast<const uint32_t*>(xs + x_offset<NT>(8 * nt + g, kk + 8)));
          }
          kstep_int8<NT>(acc, wv, xb);
        }
        if constexpr (RING) {
          // after the products: the stage was read through the generic
          // proxy, and its next TMA load must not overtake those reads
          // (handing it back right after the loads gave wrong sums)
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&empty[s]);
          ++it;
        }
      }
    }

    // The warps' sums [warp][row of x][column]: tile jt of n8 tile nt holds
    // columns 16g + 2jt (+1 in elements 2, 3) of rows 2t (elements 0, 2)
    // and 2t + 1 (1, 3).
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int m = nt * 8 + 2 * t;
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        const int c = 16 * g + 2 * jt;
        *reinterpret_cast<float2*>(red + (warp * MTI + m) * I8_RED_PITCH + c) =
            make_float2(acc[nt][jt][0], acc[nt][jt][2]);
        *reinterpret_cast<float2*>(red + (warp * MTI + m + 1) * I8_RED_PITCH + c) =
            make_float2(acc[nt][jt][1], acc[nt][jt][3]);
      }
    }
    hopper::named_sync(I8_SYNC, I8_CONSUMERS);

    // The unit's sum of item i (4 columns of one row of x), in warp order.
    auto unit_sum = [&](int i) {
      const int m = i / (I8_BN / 4), c4 = i % (I8_BN / 4);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int wi = 0; wi < I8_WARPS; ++wi) {
        const float4 v = *reinterpret_cast<const float4*>(red + (wi * MTI + m) * I8_RED_PITCH + 4 * c4);
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      return s;
    };
    // scale * sum of item i (one of the thread's) to the output.
    auto store = [&](int i, const float4& s) {
      const int gm = m0 + i / (I8_BN / 4);
      const int gn = col0 + 4 * (i % (I8_BN / 4));
      if (gm >= M) return;
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (gn + e < N) store_float(out, static_cast<size_t>(gm) * N + gn + e, sv[e] * sc[e], out_kind);
      }
    };

    if (splits == 1) {
      for (int i = tid; i < ITEMS; i += I8_CONSUMERS) store(i, unit_sum(i));
    } else {
      // this split's sums to the scratch buffer; the last CTA of the tile to
      // arrive adds them all in split order
      const int group = tile * mtiles + mt;
      float4* part = partial + static_cast<size_t>(group) * splits * ITEMS;
      for (int i = tid; i < ITEMS; i += I8_CONSUMERS) part[split * ITEMS + i] = unit_sum(i);
      // One release-acquire count for the CTA (the semaphore pattern): the
      // barrier orders every thread's sums before thread 0's release, and
      // thread 0's acquire, through the barrier, before the last CTA's reads.
      hopper::named_sync(I8_SYNC, I8_CONSUMERS);
      if (tid == 0) is_last = hopper::atomic_add_acq_rel(&counters[group], 1) == splits - 1;
      hopper::named_sync(I8_SYNC, I8_CONSUMERS);
      if (is_last) {
        for (int i = tid; i < ITEMS; i += I8_CONSUMERS) {
          float4 v[MAX_SPLIT];
#pragma unroll
          for (int sp = 0; sp < MAX_SPLIT; ++sp) {
            if (sp < splits) v[sp] = __ldcg(part + sp * ITEMS + i);
          }
          float4 s = v[0];
#pragma unroll
          for (int sp = 1; sp < MAX_SPLIT; ++sp) {
            if (sp < splits) {
              s.x += v[sp].x; s.y += v[sp].y; s.z += v[sp].z; s.w += v[sp].w;
            }
          }
          store(i, s);
        }
        if (tid == 0) counters[group] = 0;   // ready for the next launch
      }
    }
    hopper::named_sync(I8_SYNC, I8_CONSUMERS);   // red and is_last free again
  }
}

template <int NT, bool RING>
cudaError_t launch_int8_kernel(const void* x, const void* w, const void* scale, void* out,
                               void* partial, void* counters, int M, int K, int N, int splits,
                               int rows_per_split, int x_kind, int scale_kind, int out_kind,
                               cudaStream_t stream) {
  using L = I8Layout<NT, RING>;
  CUtensorMap tm_stage{}, tm_step{}, tm_x{};
  if (RING && (!hopper::make_tmap_u8(&tm_stage, w, K, N, I8_STAGE_ROWS) ||
               !hopper::make_tmap_u8(&tm_step, w, K, N, I8_KSTEP))) {
    return cudaErrorNotSupported;
  }
  // x by TMA, with the weight: bf16, whole 64-column panels, aligned
  const bool x_tma = RING && x_kind == kBF16 && K % hopper::PANEL_COLS == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int x_panels = (rows_per_split < L::kChunkRows ? rows_per_split : L::kChunkRows) /
                       hopper::PANEL_COLS;
  if (x_tma && !hopper::make_tmap_bf16_panels(&tm_x, x, M, K, 8 * NT, x_panels)) {
    return cudaErrorNotSupported;
  }
  auto kernel = qmatmul_int8_kernel<NT, RING>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long units = static_cast<long long>((N + I8_BN - 1) / I8_BN) * splits *
                          ((M + 8 * NT - 1) / (8 * NT));
  if (units >= (1ll << 31)) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(units < sms ? units : sms);   // one CTA per SM
  kernel<<<grid, i8_threads(RING), L::kBytes, stream>>>(
      tm_stage, tm_step, tm_x, int(x_tma), x, static_cast<const int8_t*>(w), scale, out,
      static_cast<float4*>(partial), static_cast<int*>(counters), M, K, N, splits,
      rows_per_split, x_kind, scale_kind, out_kind);
  return cudaGetLastError();
}

int launch_int8(const void* x, const void* w, const void* scale, void* out, void* partial,
                void* counters, int M, int K, int N, int splits, int rows_per_split,
                int n8_tiles, int x_kind, int scale_kind, int out_kind, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || splits > MAX_SPLIT || rows_per_split < 1 ||
      rows_per_split % I8_SPLIT_ALIGN != 0 ||
      static_cast<long long>(splits) * rows_per_split < K ||
      static_cast<long long>(splits - 1) * rows_per_split >= K ||
      (n8_tiles != 1 && n8_tiles != 2) ||
      (splits > 1 && (partial == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ring = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
#define AVSR_I8(NT_, RING_)                                                                 \
  return static_cast<int>(launch_int8_kernel<NT_, RING_>(                                   \
      x, w, scale, out, partial, counters, M, K, N, splits, rows_per_split, x_kind, scale_kind, \
      out_kind, st))
  if (n8_tiles == 1) {
    if (ring) AVSR_I8(1, true);
    AVSR_I8(1, false);
  }
  if (ring) AVSR_I8(2, true);
  AVSR_I8(2, false);
#undef AVSR_I8
}

}  // namespace

extern "C" {

// Both return 0 on success, else the cudaError_t of the failed call (each
// launch is checked right after it is enqueued).
//
// splits, rows_per_cta, n8_tiles: ops/qmatmul.py::int8_plan. With more
// than one split: partial, f32 scratch of splits x [N / 128] x [M / (8
// n8_tiles)] x 8 n8_tiles x 128 (both rounded up); counters, one int per
// output tile, 0 before the launch and left 0 after it.
int avsr_qmatmul_int8(const void* x, const void* w, const void* scale, void* out,
                      void* partial, void* counters, int M, int K, int N, int splits,
                      int rows_per_cta, int n8_tiles, int x_kind, int scale_kind,
                      int out_kind, void* stream) {
  return launch_int8(x, w, scale, out, partial, counters, M, K, N, splits, rows_per_cta,
                     n8_tiles, x_kind, scale_kind, out_kind, stream);
}

// The same for int4 (ops/qmatmul.py::int4_plan), over K / 2 packed rows.
int avsr_qmatmul_int4(const void* x, const void* w, const void* scale, void* out,
                      void* partial, void* counters, int M, int K, int N, int splits,
                      int rows_per_cta, int n8_tiles, int x_kind, int scale_kind,
                      int out_kind, void* stream) {
  return launch_int4(x, w, scale, out, partial, counters, M, K, N, splits, rows_per_cta,
                     n8_tiles, x_kind, scale_kind, out_kind, stream);
}

}  // extern "C"
