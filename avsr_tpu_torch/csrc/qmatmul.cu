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
// flight, and convert the integers cheaply.
//
// int8 (qmatmul_int8_kernel): FMAs on the CUDA cores. A CTA owns 128 output
// columns and 8 rows of x (more rows: more CTAs, placed next to each other
// in launch order so that they read the same weight bytes from L2). Its 8
// warps split the CTA's weight rows between them; lane l of every warp owns
// columns 4l..4l+3, so a warp reads 128 contiguous bytes of a row with one
// 32-bit load per lane. Each warp keeps two batches of 8 rows of loads in
// flight: the next batch is issued before the current one is multiplied,
// and the first before x is staged. The x columns of all the CTA's weight
// rows are staged once in shared memory as f32 rounded to bf16, [row][8],
// read by broadcast, so the weight stream runs with no barrier
// (ops/qmatmul.py caps the rows of a CTA to keep that under 96 KB). A weight
// byte becomes a float without a conversion instruction (0x4B0000uu is
// 2^23 + uu: one byte permute, one subtraction). The warps' partial sums are
// added in shared memory in warp order. Where the output tiles give fewer
// than two CTAs per SM, the weight rows are also split over CTAs
// (ops/qmatmul.py::splits) and a second kernel adds the splits' partial sums
// in split order and applies the scale: no float atomics, the same bits on
// every run.
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
// int8: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 4;          // output columns per lane: one 32-bit weight word a row
constexpr int BN = 32 * COLS;    // 128 output columns per CTA (ops/qmatmul.py BLOCK_N)
constexpr int MT = 8;            // rows of x per CTA (ops/qmatmul.py BLOCK_M)
constexpr int UNROLL = 8;        // weight rows of a warp per batch of loads
constexpr int RED_BYTES = WARPS * MT * BN * 4;   // the warps' partial sums

// The weight bytes of one row at a lane's 4 columns, as a word (byte c is
// column c). VEC: one aligned 32-bit load (N % 4 == 0, the lane's columns
// all in range or all clamped into range and discarded later). Otherwise
// byte loads, zero past the `left` columns that remain in the row.
template <bool VEC>
__device__ __forceinline__ uint32_t load_word(const int8_t* p, int left) {
  if (VEC) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    if (c < left) w |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + c))) << (8 * c);
  }
  return w;
}

// Byte c of a word whose int8 bytes were biased by XOR 0x80 (b -> b + 128),
// as the float b: 0x4B0000uu is 2^23 + uu exactly.
__device__ __forceinline__ float byte_value(uint32_t biased, int c) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + c)) - 8388736.0f;
}

// The words of one batch of a warp's weight rows: rows r, r + WARPS, ...
// (UNROLL of them), the first at p, each `step` bytes after the last. TAIL:
// rows at or past nrows load nothing and give 0.
template <bool VEC, bool TAIL>
__device__ __forceinline__ void load_rows(uint32_t (&wv)[UNROLL], const int8_t* p, size_t step,
                                          int r, int nrows, int left) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    wv[u] = !TAIL || r + u * WARPS < nrows ? load_word<VEC>(p + u * step, left) : 0u;
  }
}

// acc[m][c] += x[m][row] * q[row][c] over the batch of rows r, r + WARPS, ...
template <bool TAIL>
__device__ __forceinline__ void accumulate(float (&acc)[MT][COLS], const uint32_t (&wv)[UNROLL],
                                           const float4* xs, int r, int nrows) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int rr = r + u * WARPS;
    if (TAIL && rr >= nrows) break;
    const float4* xr = xs + rr * 2;
    const float4 a = xr[0], b = xr[1];
    const float xv[MT] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    const uint32_t biased = wv[u] ^ 0x80808080u;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const float q = byte_value(biased, c);
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xv[m], q, acc[m][c]);
    }
  }
}

// Bytes of dynamic shared memory for `rows` weight rows: their x columns,
// then (reusing the space) the warps' partial sums.
constexpr size_t smem_bytes(int rows) {
  return static_cast<size_t>(rows) * MT * 4 > RED_BYTES ? static_cast<size_t>(rows) * MT * 4
                                                        : RED_BYTES;
}

// One CTA: output columns [tile * BN, +BN) of x rows [m0, m0 + MT), over the
// weight rows of split blockIdx.y. With `partial` it writes the unscaled sum
// of its split to partial[split][m][n]; without, scale * sum to out.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
qmatmul_int8_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
                    const void* __restrict__ scale, void* __restrict__ out,
                    float* __restrict__ partial, int M, int K, int N, int split_rows,
                    int x_kind, int scale_kind, int out_kind) {
  extern __shared__ float4 smem[];        // x: [row][MT floats]; then the sums

  const int rows = K;
  const int ny = (M + MT - 1) / MT;
  const int m0 = (blockIdx.x % ny) * MT;
  const int tile = blockIdx.x / ny;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = tile * BN + lane * COLS;
  const int r0 = blockIdx.y * split_rows;
  const int nrows = max(0, min(rows, r0 + split_rows) - r0);
  float* xsf = reinterpret_cast<float*>(smem);

  float acc[MT][COLS];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[m][c] = 0.f;
  }

  // The lane's pointer into its first row; a VEC lane past N reads columns
  // 0..3 (in range) and its sums are never written.
  const int8_t* p = w + (static_cast<size_t>(r0) + warp) * N + (VEC && n0 >= N ? 0 : n0);
  const size_t step = static_cast<size_t>(WARPS) * N;   // bytes between a warp's rows
  const int left = N - n0;
  const int batch = WARPS * UNROLL;                     // rows of the CTA per batch
  const int nfull = nrows / batch;
  uint32_t wv[UNROLL];
  // in flight while x is staged
  if (nfull > 0) {
    load_rows<VEC, false>(wv, p, step, warp, nrows, left);
  } else {
    load_rows<VEC, true>(wv, p, step, warp, nrows, left);
  }

  // x[m][r0 + r] -> shared [r][m]; consecutive threads read consecutive
  // columns of x
  for (int i = threadIdx.x; i < nrows * MT; i += THREADS) {
    const int r = i % nrows;
    const int m = i / nrows;
    float v = 0.f;
    if (m0 + m < M) {
      v = load_float(x, static_cast<size_t>(m0 + m) * K + r0 + r, x_kind);
      v = __bfloat162float(__float2bfloat16_rn(v));
    }
    xsf[r * MT + m] = v;
  }
  __syncthreads();

  for (int b = 0; b < nfull; ++b) {
    uint32_t next[UNROLL];
    const int8_t* q = p + (b + 1) * UNROLL * step;
    if (b + 1 < nfull) {
      load_rows<VEC, false>(next, q, step, (b + 1) * batch + warp, nrows, left);
    } else {
      load_rows<VEC, true>(next, q, step, (b + 1) * batch + warp, nrows, left);
    }
    accumulate<false>(acc, wv, smem, b * batch + warp, nrows);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) wv[u] = next[u];
  }
  if (nfull * batch < nrows) accumulate<true>(acc, wv, smem, nfull * batch + warp, nrows);
  __syncthreads();  // x is read no more: its space takes the partial sums

  // The warps hold sums of the same MT x BN outputs over their own rows:
  // add them in warp order.
  float4* red = smem;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    red[(warp * MT + m) * (BN / 4) + lane] =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  const float* redf = reinterpret_cast<const float*>(red);
  for (int i = threadIdx.x; i < MT * BN; i += THREADS) {
    const int gm = m0 + i / BN;
    const int gn = tile * BN + i % BN;
    if (gm >= M || gn >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) s += redf[wi * MT * BN + i];
    if (partial != nullptr) {
      partial[(static_cast<size_t>(blockIdx.y) * M + gm) * N + gn] = s;
    } else {
      store_float(out, static_cast<size_t>(gm) * N + gn, s * load_float(scale, gn, scale_kind),
                  out_kind);
    }
  }
}

// out[m][n] = scale[n] * sum over splits, in split order.
__global__ void qmatmul_reduce_kernel(const float* __restrict__ partial,
                                      const void* __restrict__ scale, void* __restrict__ out,
                                      int splits, int M, int N, int scale_kind, int out_kind) {
  const size_t total = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[k * total + i];
  store_float(out, i, s * load_float(scale, i % N, scale_kind), out_kind);
}

int launch_int8(const void* x, const void* w, const void* scale, void* out, void* partial,
                int M, int K, int N, int splits, int split_rows, int x_kind, int scale_kind,
                int out_kind, void* stream) {
  if (M <= 0 || N <= 0 || splits < 1 || split_rows < 1 || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(split_rows);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    for (auto kernel : {qmatmul_int8_kernel<true>, qmatmul_int8_kernel<false>}) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ny = (M + MT - 1) / MT;
  const int tiles = (N + BN - 1) / BN;
  const bool vec = N % COLS == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  auto kernel = vec ? qmatmul_int8_kernel<true> : qmatmul_int8_kernel<false>;
  kernel<<<dim3(ny * tiles, splits), THREADS, smem, st>>>(
      x, static_cast<const int8_t*>(w), scale, out, part, M, K, N, split_rows, x_kind,
      scale_kind, out_kind);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(M) * N;
  qmatmul_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      part, scale, out, splits, M, N, scale_kind, out_kind);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

extern "C" {

// Both return 0 on success, else the cudaError_t of the failed call (each
// launch is checked right after it is enqueued).
int avsr_qmatmul_int8(const void* x, const void* w, const void* scale, void* out,
                      void* partial, int M, int K, int N, int splits, int split_rows,
                      int x_kind, int scale_kind, int out_kind, void* stream) {
  return launch_int8(x, w, scale, out, partial, M, K, N, splits, split_rows, x_kind, scale_kind,
                     out_kind, stream);
}

// splits, rows_per_cta, n8_tiles: ops/qmatmul.py::int4_plan. With more
// than one split: partial, f32 scratch of splits x [N / 128] x [M / (8
// n8_tiles)] x 8 n8_tiles x 128 (both rounded up); counters, one int per
// output tile, 0 before the launch and left 0 after it.
int avsr_qmatmul_int4(const void* x, const void* w, const void* scale, void* out,
                      void* partial, void* counters, int M, int K, int N, int splits,
                      int rows_per_cta, int n8_tiles, int x_kind, int scale_kind,
                      int out_kind, void* stream) {
  return launch_int4(x, w, scale, out, partial, counters, M, K, N, splits, rows_per_cta,
                     n8_tiles, x_kind, scale_kind, out_kind, stream);
}

}  // extern "C"
