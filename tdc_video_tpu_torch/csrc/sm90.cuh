// Hopper (sm_90a) building blocks of the wgmma kernels, the forward body of
// K1-K4 (flash_fwd_sm90.cuh) and the backward kernels K5 and K6: TMA
// tensor maps and loads, mbarriers, wgmma shared-memory descriptors, the
// wgmma instructions themselves and their fences, and warpgroup register
// reallocation.
//
// Shared-memory tiles. An operand tile of ROWS rows by DP head dims (DP a
// multiple of 16) is stored as DP / PW column panels of ROWS x PW bf16, each
// panel the exact image of one TMA box loaded with the swizzle of width
// 2 * PW bytes: PW = 64 (128-byte swizzle) for DP = 64 and 128, PW = 16
// (32-byte swizzle) for DP = 80. Panels start on 1024-byte boundaries, so the
// descriptors' base offset is 0. Such a tile serves wgmma both ways:
//   * K-major (the contraction runs along the head dims, S = Q K^T): rows are
//     M or N, 8-row groups 8 * 2 PW bytes apart (SBO); a 16-wide k-step is 32
//     bytes further along the panel row, or the next panel when PW = 16;
//   * MN-major (the contraction runs along the rows, dQ = dS K): the head
//     dims are N, one swizzle atom of PW dims per panel, panels ROWS * 2 PW
//     bytes apart (LBO); 8-row groups of the contraction 8 * 2 PW bytes apart
//     (SBO); a 16-row k-step is 16 * 2 PW bytes further.
// Head dims D < DP are zero in shared memory because the tensor map's
// innermost extent is D and TMA fills what lies outside it with zeros; the
// packed [B, N, H * D] tower layout puts the next head's columns right after
// column D - 1, and those are never read. Rows past the tensor map's row
// extent (T or kv_len) are zero-filled the same way.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdc {
namespace sm90 {

// PW, the head dims of one panel (one TMA box), for a padded head dim DP.
template <int DP>
constexpr int panel_width = DP == 80 ? 16 : 64;

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so that the libraries need not link libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A bf16 operand [B, L, H, D] with element strides (sb, sl, sh), the last dim
// contiguous, as a 4-D tensor map {D, H, L, B}; one box is PW head dims of
// `rows` consecutive rows of one head. The strides are used as given, for
// dims of size 1 too: the caller passes the ones ops/flash_attention.py
// tma_operand computes (positive multiples of 16 bytes); others fail to encode.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int B, int L, int H, int D,
                            long long sb, long long sl, long long sh, int pw, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)pw, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        pw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A flat f32 array of n elements as a 1-D tensor map with boxes of `box`
// elements; elements past n are zero-filled.
inline cudaError_t make_map_f32(CUtensorMap* map, const float* base, long long n, int box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};  // a 1-D map has no strides
  const cuuint32_t bx[1] = {(cuuint32_t)box}, estr[1] = {1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims,
                        strides, bx, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Device: barriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map at (d, h, row, b) into shared memory; completes
// its bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d,
                                         int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(h), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

// One box of a 1-D tensor map at element x.
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(bar)
      : "memory");
}

// A tile of ROWS rows (rows r0.. of the operand) in DP / PW panels, one box each.
template <int ROWS, int DP, int PW>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int h, int r0, int b) {
#pragma unroll
  for (int pnl = 0; pnl < DP / PW; ++pnl)
    tma_load(dst + pnl * ROWS * PW * 2, map, bar, pnl * PW, h, r0, b);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x by the special-function unit alone (ex2.approx, flushing denormals):
// a few ulp, where exp2f adds a range-reduction sequence around it.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Device: wgmma descriptors
// ---------------------------------------------------------------------------

// 64-bit shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle (1: 128 bytes, 3: 32 bytes).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int pw) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)(pw == 64 ? 1 : 3) << 62);
}

// x, hidden from the compiler: descriptors built from a tile address taken
// through this inside a loop are not hoisted out of it, where they would
// each hold two registers for the whole loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// K-major: rows r0.. (a multiple of 8) of a ROWS-row tile at `tile`, k-step kk
// (head dims 16 kk ..).
template <int ROWS, int PW>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  constexpr int KSP = PW / 16;  // k-steps per panel
  const uint32_t addr = tile + (kk / KSP) * ROWS * PW * 2 + r0 * PW * 2 + (kk % KSP) * 32;
  return make_desc(addr, 16, 8 * PW * 2, PW);
}

// MN-major: the tile's rows 16 kk .. 16 kk + 15 as the contraction, all its
// head dims as N.
template <int ROWS, int PW>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * PW * 2, ROWS * PW * 2, 8 * PW * 2, PW);
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

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
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A-operand registers that an issued wgmma still reads: keeps
// them live, unchanged, until after the wait that completes it.
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Accumulator layout of a 64 x N f32 wgmma tile: thread t of the warpgroup
// holds, for every 8-column block j, d[4 j + 2 i + c] at row
// 16 (t / 32) + (t % 32) / 4 + 8 i and column 8 j + 2 (t % 4) + c. The
// A-operand registers of a 16-deep k-step kk are the bf16 pairs
// {d[8 kk], d[8 kk + 1]}, {d[8 kk + 2], d[8 kk + 3]}, {d[8 kk + 4], d[8 kk + 5]},
// {d[8 kk + 6], d[8 kk + 7]} of an accumulator with the k-step as columns.

// d[64x32] (+)= A[64x16] B[16x32]: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64x64] (+)= A[64x16] B[16x64]: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64x128] (+)= A[64x16] B[16x128]: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A B with A and B in shared memory and N = 64 or 128 (keys per tile).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

// d[64x64] (+)= A[64x16] B[16x64]: A from registers (4 bf16 pairs a thread),
// B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64x80] (+)= A[64x16] B[16x80]: A from registers (4 bf16 pairs a thread),
// B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64x128] (+)= A[64x16] B[16x128]: A from registers (4 bf16 pairs a thread),
// B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A B with A in registers and N = DP the padded head dim.
template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (DP == 64) wgmma_rs_n64(d, a, db, scale_d);
  else if constexpr (DP == 80) wgmma_rs_n80(d, a, db, scale_d);
  else wgmma_rs_n128(d, a, db, scale_d);
}

}  // namespace sm90
}  // namespace tdc
