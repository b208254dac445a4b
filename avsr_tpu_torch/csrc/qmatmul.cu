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
// below the tensor-core rate. So the kernel is bound by bytes, and it must
// stream every weight byte once, coalesced, with enough loads in flight.
// At M = 8 the FMAs on the CUDA cores come close to that bound too (16 per
// int8 byte, 32 per int4 byte against ~20 FLOP per byte of HBM at the f32
// rate), so the integer-to-float conversion must be cheap.
//
// What the design does about it. A CTA owns 128 output columns and 8 rows
// of x (more rows: more CTAs, placed next to each other in launch order so
// that they read the same weight bytes from L2). Its 8 warps split the
// CTA's weight rows between them; lane l of every warp owns columns
// 4l..4l+3, so a warp reads 128 contiguous bytes of a row with one 32-bit
// load per lane. Each warp keeps two batches of 8 rows of loads in flight:
// the next batch is issued before the current one is multiplied, and the
// first before x is staged. The x columns of all the CTA's weight rows are
// staged once in shared memory as f32 rounded to bf16, [row][8], read by
// broadcast, so the weight stream runs with no barrier (ops/qmatmul.py caps
// the rows of a CTA to keep that under 96 KB). A weight byte becomes a
// float without a conversion instruction (0x4B0000uu is 2^23 + uu: one byte
// permute or mask, one subtraction). The warps' partial sums are added in
// shared memory in warp order. Where the output tiles give fewer than two
// CTAs per SM (o, down, qkv, gateup), the weight rows are also split over
// CTAs (ops/qmatmul.py::splits) and a second kernel adds the splits' partial
// sums in split order and applies the scale: no float atomics, the same
// bits on every run. This first version uses neither the tensor cores nor
// cp.async/TMA pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int COLS = 4;          // output columns per lane: one 32-bit weight word a row
constexpr int BN = 32 * COLS;    // 128 output columns per CTA (ops/qmatmul.py BLOCK_N)
constexpr int MT = 8;            // rows of x per CTA (ops/qmatmul.py BLOCK_M)
constexpr int UNROLL = 8;        // weight rows of a warp per batch of loads
constexpr int RED_BYTES = WARPS * MT * BN * 4;   // the warps' partial sums
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

// The nibble at bit `shift` of a word whose int4 nibbles were biased by XOR
// 0x8 (n -> n + 8), as the float n.
__device__ __forceinline__ float nibble_value(uint32_t biased, int shift) {
  return __int_as_float(((biased >> shift) & 0xFu) | 0x4B000000u) - 8388616.0f;
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
// (int4: both nibbles, against the two K halves of x).
template <int BITS, bool TAIL>
__device__ __forceinline__ void accumulate(float (&acc)[MT][COLS], const uint32_t (&wv)[UNROLL],
                                           const float4* xs, int r, int nrows) {
  constexpr int XH = BITS == 4 ? 2 : 1;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int rr = r + u * WARPS;
    if (TAIL && rr >= nrows) break;
    const float4* xr = xs + rr * XH * 2;
    const float4 a = xr[0], b = xr[1];
    const float xv[MT] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    if (BITS == 8) {
      const uint32_t biased = wv[u] ^ 0x80808080u;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const float q = byte_value(biased, c);
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xv[m], q, acc[m][c]);
      }
    } else {
      const float4 ah = xr[2], bh = xr[3];
      const float xh[MT] = {ah.x, ah.y, ah.z, ah.w, bh.x, bh.y, bh.z, bh.w};
      const uint32_t biased = wv[u] ^ 0x88888888u;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const float lo = nibble_value(biased, 8 * c);
        const float hi = nibble_value(biased, 8 * c + 4);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          acc[m][c] = fmaf(xv[m], lo, acc[m][c]);
          acc[m][c] = fmaf(xh[m], hi, acc[m][c]);
        }
      }
    }
  }
}

// Bytes of dynamic shared memory for `rows` weight rows: their x columns,
// then (reusing the space) the warps' partial sums.
template <int BITS>
constexpr size_t smem_bytes(int rows) {
  return static_cast<size_t>(rows) * (BITS == 4 ? 2 : 1) * MT * 4 > RED_BYTES
             ? static_cast<size_t>(rows) * (BITS == 4 ? 2 : 1) * MT * 4
             : RED_BYTES;
}

// One CTA: output columns [tile * BN, +BN) of x rows [m0, m0 + MT), over the
// weight rows of split blockIdx.y. With `partial` it writes the unscaled sum
// of its split to partial[split][m][n]; without, scale * sum to out.
template <int BITS, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
qmatmul_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
               const void* __restrict__ scale, void* __restrict__ out,
               float* __restrict__ partial, int M, int K, int N, int split_rows,
               int x_kind, int scale_kind, int out_kind) {
  constexpr int XH = BITS == 4 ? 2 : 1;   // x columns per weight row (the two K halves)
  extern __shared__ float4 smem[];        // x: [row][half][MT floats]; then the sums

  const int rows = BITS == 4 ? K / 2 : K;
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

  // x[m][h * rows + r0 + r] -> shared [r][h][m]; consecutive threads read
  // consecutive columns of x
  for (int i = threadIdx.x; i < nrows * XH * MT; i += THREADS) {
    const int r = i % nrows;
    const int h = (i / nrows) % XH;
    const int m = i / (nrows * XH);
    float v = 0.f;
    if (m0 + m < M) {
      v = load_float(x, static_cast<size_t>(m0 + m) * K + h * rows + r0 + r, x_kind);
      v = __bfloat162float(__float2bfloat16_rn(v));
    }
    xsf[(r * XH + h) * MT + m] = v;
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
    accumulate<BITS, false>(acc, wv, smem, b * batch + warp, nrows);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) wv[u] = next[u];
  }
  if (nfull * batch < nrows) accumulate<BITS, true>(acc, wv, smem, nfull * batch + warp, nrows);
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

template <int BITS>
int launch(const void* x, const void* w, const void* scale, void* out, void* partial, int M,
           int K, int N, int splits, int split_rows, int x_kind, int scale_kind, int out_kind,
           void* stream) {
  if (M <= 0 || N <= 0 || splits < 1 || split_rows < 1 || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes<BITS>(split_rows);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    for (auto kernel : {qmatmul_kernel<BITS, true>, qmatmul_kernel<BITS, false>}) {
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
  auto kernel = vec ? qmatmul_kernel<BITS, true> : qmatmul_kernel<BITS, false>;
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

}  // namespace

extern "C" {

int avsr_qmatmul_int8(const void* x, const void* w, const void* scale, void* out,
                      void* partial, int M, int K, int N, int splits, int split_rows,
                      int x_kind, int scale_kind, int out_kind, void* stream) {
  return launch<8>(x, w, scale, out, partial, M, K, N, splits, split_rows, x_kind, scale_kind,
                   out_kind, stream);
}

int avsr_qmatmul_int4(const void* x, const void* w, const void* scale, void* out,
                      void* partial, int M, int K, int N, int splits, int split_rows,
                      int x_kind, int scale_kind, int out_kind, void* stream) {
  return launch<4>(x, w, scale, out, partial, M, K, N, splits, split_rows, x_kind, scale_kind,
                   out_kind, stream);
}

}  // extern "C"
