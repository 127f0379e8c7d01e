// Tensor-core and asynchronous-copy building blocks shared by the kernels
// that run on Hopper's tensor cores (flash_attention.cu, quant_matmul.cu):
// cp.async of 16-byte pieces into shared memory, ldmatrix, and the
// mma.sync shapes they use (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16/k32"), with
// g = lane / 4 and t = lane % 4:
//   A (16 x K, row-major), four 32-bit registers: a0 row g, a1 row g+8 of
//     the first half of K; a2 row g, a3 row g+8 of the second half; each
//     register holds the 4 bytes at K offset 4t of its half (2 bf16 or 4 s8).
//   B (K x 8, "col": K-contiguous per column), two registers: column g, the
//     4 bytes at K offset 4t of the first (b0) and second (b1) half of K.
//   C (16 x 8, 32-bit), four registers: c0, c1 row g, columns 2t and 2t+1;
//     c2, c3 the same for row g+8.
// An ldmatrix.x4 of four 8x8 b16 matrices whose rows hold consecutive K
// bytes hands lane l the 4 bytes at (row l / 4, byte 4 (l % 4)) of each: the
// A and B layouts above, for bf16 and for s8 alike.  With .trans it hands
// the two b16 values at (rows 2 (l % 4) and 2 (l % 4) + 1, column l / 4),
// which is B from a row-major (K x N) bf16 tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t npe_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; the first `bytes`
// (0 or 16) are copied and the rest zero-filled, so a masked piece reads
// nothing from global memory.  Both addresses 16-byte aligned.
__device__ __forceinline__ void npe_cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(npe_smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void npe_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void npe_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void npe_ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(npe_smem_addr(p)));
}

__device__ __forceinline__ void npe_ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(npe_smem_addr(p)));
}

// d += a (16x16 bf16) . b (16x8 bf16), f32 accumulators.
__device__ __forceinline__ void npe_mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32 s8) . b (32x8 s8), exact s32 accumulators.
__device__ __forceinline__ void npe_mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 as a bf16x2 register, `lo` in the low half, each rounded to nearest even.
__device__ __forceinline__ uint32_t npe_pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = p0 + p1 + p2 exactly, each piece a bf16 (f32 holds 24 significant
// bits, bf16 8: each residual is exact in f32 and the third fits in bf16).
__device__ __forceinline__ void npe_split3(float x, float (&p)[3]) {
  p[0] = __bfloat162float(__float2bfloat16_rn(x));
  const float r = __fsub_rn(x, p[0]);
  p[1] = __bfloat162float(__float2bfloat16_rn(r));
  p[2] = __fsub_rn(r, p[1]);
}

// Byte offset of 16-byte chunk `c` (0..3) of row `r` in a tile of 64-byte
// rows, XOR-swizzled so that the 8 rows one ldmatrix reads at one chunk fall
// in 8 distinct groups of 4 banks.
__device__ __forceinline__ int npe_sw64(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}
