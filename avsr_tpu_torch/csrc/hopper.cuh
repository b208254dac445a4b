// Hopper (sm_90a) building blocks shared by the bf16 flash-attention
// kernels of flash_fwd.cu and flash_bwd.cu and the int8 / int4 kernels of
// qmatmul.cu, in inline PTX:
//   * mbarriers: init, arrive, arrive with an expected transaction count,
//     and the parity wait;
//   * TMA: 2-D and 3-D tiled loads into shared memory that complete on an
//     mbarrier, 3-D tiled stores from shared memory, and the host-side
//     encoding of the tensor maps they read (bf16 tiles, and the int8
//     weight; cuTensorMapEncodeTiled, looked up in the driver library at run
//     time, so the libraries link only the runtime);
//   * wgmma: the fence / commit / wait of a warpgroup, the shared-memory
//     matrix descriptor of a 128-byte swizzled tile, and m64nNk16 bf16
//     products with f32 accumulators, both operands in shared memory (SS)
//     or A in registers (RS);
//   * setmaxnreg and named barriers for warp-specialised kernels, and an
//     acquire-release atomic add (a semaphore between CTAs);
//   * for qmatmul.cu's kernels: mma.sync m16n8k16 bf16.
//
// Tile layout. Every operand tile is a stack of 64-column panels: a panel
// holds rows of 64 bf16 (128 bytes) as the TMA's 128-byte swizzle leaves
// them (the 16-byte chunk c of row r sits at chunk c ^ (r % 8)), so eight
// rows make one 1024-byte swizzle atom. Panels start on 1024-byte
// boundaries. A D = 128 head is two panels.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

constexpr int PANEL_COLS = 64;     // bf16 columns of one 128-byte swizzled row
constexpr int ROW_BYTES = 128;
constexpr int ATOM_BYTES = 1024;   // eight swizzled rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also expects `bytes` more of TMA transactions.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A barrier starts
// in phase 0, so a wait on parity 1 passes at once. A wait that lasts
// longer than about ten seconds traps: a lost arrival then ends the launch
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Copies the box at (c0, c1, c2) (innermost first) of the tensor map into
// shared memory at `dst`; the bytes complete a transaction on `bar`.
// Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// The same for a 2-D tensor map: the box at (c0, c1).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Writes the shared-memory box at `src` to (c0, c1, c2) of the tensor map;
// the parts outside the tensor are dropped.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Ends the thread's TMA stores and waits until they have read shared memory.
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's shared-memory stores before later async-proxy
// (TMA, wgmma) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of bf16 element (row, col) in one swizzled 64-column panel:
// the layout a TMA store of that panel reads.
__device__ __forceinline__ uint32_t swizzled_offset(int row, int col) {
  return row * ROW_BYTES + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// The first 1024-byte boundary at or after `p` (swizzled tiles need it).
__device__ __forceinline__ uint8_t* align_atom(uint8_t* p) {
  return p + ((ATOM_BYTES - (smem_u32(p) & (ATOM_BYTES - 1))) &
              (ATOM_BYTES - 1));
}

// ---------------------------------------------------------------------------
// Warp specialisation
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// bar.sync on named barrier `id` (1..15; 0 is __syncthreads) for `count`
// threads.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// *p += v at device scope with acquire-release order; returns the old *p.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a 128-byte swizzled operand in shared memory.
// K-major (A, or B stored [N, K]): rows of the M/N side at 128 bytes, eight
// of them per 1024-byte atom (SBO); a k16 step inside the 128-byte row
// moves the start address by 32 bytes.
// MN-major (B stored [K, N], transposed in the instruction): rows of the K
// side at 128 bytes, eight per atom (SBO); a k16 step moves the start by
// 16 rows (2048 bytes). The N side is one 64-column panel, so the leading
// byte offset (the stride between panels) is never used.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint32_t addr = smem_u32(tile);
  uint64_t d = (addr & 0x3FFFFu) >> 4;                 // start address
  d |= uint64_t(ATOM_BYTES >> 4) << 16;                // leading byte offset
  d |= uint64_t(ATOM_BYTES >> 4) << 32;                // stride byte offset
  d |= uint64_t(1) << 62;                              // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma registers across
// the wait (the hardware writes them asynchronously until then).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// 2^x (flushing subnormal results to 0; 2^-inf = 0), the one MUFU
// instruction behind every exponential of the softmax.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m64nNk16 accumulator of a warpgroup: warp w holds rows 16w..16w+15;
// lane l holds, for each 8-column chunk i, d[4i + 0, 1] at row
// 16w + l/4, columns 8i + 2(l%4) + {0, 1}, and d[4i + 2, 3] at row
// 16w + l/4 + 8. The bf16 A fragment of k16 step kk (columns 16kk..16kk+15)
// is then the pairs d[8kk + 2t], d[8kk + 2t + 1], t = 0..3, in order, so an
// accumulator of scores becomes the A operand of the next product in
// place.
template <int NCOL>
__device__ __forceinline__ void acc_to_a(const float (&d)[NCOL / 2],
                                         uint32_t (&a)[NCOL / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < NCOL / 16; ++kk) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      a[kk][t] = pack_bf16(d[8 * kk + 2 * t], d[8 * kk + 2 * t + 1]);
    }
  }
}

// D[64, N] (+)= A[64, 16] B[16, N], both operands K-major in shared memory
// (descriptors da, db); scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

// D[64, N] (+)= A[64, 16] B[16, N], A as bf16x2 registers (acc_to_a's
// layout), B MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// mma.sync (the int8 and int4 matmuls of qmatmul.cu)
// ---------------------------------------------------------------------------

// D[16, 8] += A[16, 16] B[16, 8], bf16 operands, f32 accumulators, one warp.
// Lane l = 4g + t holds A's rows g (a[0], a[2]) and g + 8 (a[1], a[3]) at k
// pairs t (a[0], a[1]) and t + 4 (a[2], a[3]); B's column g at k pairs t
// (b0) and t + 4 (b1); D's rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at
// columns 2t and 2t + 1. A k pair's first element is the low half.
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib == nullptr) return nullptr;
    return reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Tensor map over `heads` contiguous [rows, cols] bf16 matrices at `base`
// (an array [heads, rows, cols]), read and written in boxes of `box_rows`
// rows by 64 columns of one matrix, 128-byte swizzled. Rows past `rows`
// load as zeros and are not stored, so a box never reaches the next head.
inline bool make_tmap_bf16(CUtensorMap* map, const void* base, int heads,
                           int rows, int cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 2,
                                 cuuint64_t(rows) * cols * 2};
  const cuuint32_t box[3] = {cuuint32_t(PANEL_COLS), cuuint32_t(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map over a row-major [rows, cols] bf16 matrix viewed as
// [cols / 64][rows][64]: a box of `box_rows` rows by `box_panels` 64-column
// panels lands in shared memory panel after panel, each row 128 bytes,
// 128-byte swizzled. Needs cols % 64 == 0 and a 16-byte aligned base. Rows
// and panels past the matrix load as zeros.
inline bool make_tmap_bf16_panels(CUtensorMap* map, const void* base, int rows, int cols,
                                  int box_rows, int box_panels) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(PANEL_COLS), cuuint64_t(rows),
                              cuuint64_t(cols / PANEL_COLS)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 2, cuuint64_t(ROW_BYTES)};
  const cuuint32_t box[3] = {cuuint32_t(PANEL_COLS), cuuint32_t(box_rows),
                             cuuint32_t(box_panels)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map over a row-major [rows, cols] byte matrix (the int8 weight of
// qmatmul.cu), read in boxes of `box_rows` rows by 128 columns, 128-byte
// swizzled. Needs cols % 16 == 0 and a 16-byte aligned base (TMA's rule for
// the row stride). Rows and columns past the matrix load as zeros.
inline bool make_tmap_u8(CUtensorMap* map, const void* base, int rows, int cols,
                         int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols)};
  const cuuint32_t box[2] = {cuuint32_t(ROW_BYTES), cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
