// Tensor-core and asynchronous-copy building blocks shared by the kernels
// that run on Hopper's tensor cores (flash_attention.cu, quant_matmul.cu):
// cp.async of 16-byte pieces into shared memory, ldmatrix, the mma.sync
// shapes they use (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32), the warpgroup
// products (wgmma, sm_90a) with their operand layouts, and TMA loads with
// the mbarriers that count them.
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

// --- warpgroup products (wgmma) --------------------------------------------
// A warpgroup (4 warps, 128 threads) computes D (64 x N, f32) += A (64 x 16)
// . B (16 x N) asynchronously.  D's registers: thread t (warp w = t / 32,
// g = lane / 4, c = lane % 4) holds d[4j + e] = D[16w + g + 8(e >> 1)]
// [8j + 2c + (e & 1)]: mma.sync's C layout for each n8 block j.  A from
// registers (npe_wgmma_rs_*) takes mma.sync's A fragment of the warp's 16
// rows, so a D block of one product is the A operand of the next.
// Operands in shared memory use the layout without swizzle: an 8 x 8 core
// matrix of bf16 is 8 rows of 16 bytes, 128 contiguous bytes.  A tile of R
// rows of D bf16 (a q, k, v or dO tile: one token a row) keeps the 16-byte
// piece c (values 8c..8c+7) of row r at byte npe_tile_off<D>(r, c).  Read
// with the tile's rows as M or N and D as K ("K-major"), the leading byte
// offset (the next core matrix along K) is 128 and the stride byte offset
// (the next 8 rows) 16 D; read with the rows as K and D as N ("MN-major",
// transposed B), they are 16 D and 128.  A tile written by st.shared or
// cp.async (the generic proxy) is made visible to wgmma (the async proxy) by
// npe_fence_async_smem in each writing thread before the barrier.
template <int D>
__device__ __forceinline__ int npe_tile_off(int r, int c) {
  return (r >> 3) * (16 * D) + c * 128 + (r & 7) * 16;
}

// A shared-memory matrix descriptor without swizzle: start, leading and
// stride byte offsets.
__device__ __forceinline__ uint64_t npe_wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((npe_smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// The operands of a tile of D-wide rows at `tile`, from row r0 (a multiple
// of 8) and column k0 (a multiple of 16) on: K-major, or MN-major from row
// k0 on (its rows the K dimension), from column m0 on (a multiple of 8).
template <int D>
__device__ __forceinline__ uint64_t npe_kmajor(const void* tile, int r0, int k0) {
  return npe_wgmma_desc(static_cast<const char*>(tile) + (r0 >> 3) * (16 * D) + (k0 >> 3) * 128,
                        128, 16 * D);
}
template <int D>
__device__ __forceinline__ uint64_t npe_mnmajor(const void* tile, int k0, int m0 = 0) {
  return npe_wgmma_desc(static_cast<const char*>(tile) + (k0 >> 3) * (16 * D) + (m0 >> 3) * 128,
                        16 * D, 128);
}

// The same operands as a TMA load writes them with the 128-byte swizzle
// (the 64-byte one for D = 32, whose rows are 64 bytes), SW the swizzle's
// width: a tile of R rows keeps D's SW-byte column blocks one after the
// other, R x SW bytes each, row r of a block at r SW with its 16-byte
// pieces' index XORed with the address bits above the row's 128 bytes
// (r & 7 for SW = 128, (r >> 1) & 3 for 64).  A tile starts on a 1024-byte
// boundary, so those bits are the row's.  K-major: the stride byte offset
// (the next 8 rows) is 8 SW, a k16 step inside a block moves the start by
// 32 bytes (the swizzle acts on the address), and the leading offset is
// unused; MN-major (the rows as K): the next 8 rows are 8 SW on, and the
// leading byte offset (the next column block along N) is R SW.
template <int D>
__host__ __device__ constexpr int npe_sw() {
  return D >= 64 ? 128 : 64;
}
template <int D, int R>
__device__ __forceinline__ int npe_swz_off(int r, int c) {
  constexpr int SW = npe_sw<D>(), P = SW / 16;   // 16-byte pieces a block's row
  const int o = (c / P) * (R * SW) + r * SW + (c % P) * 16;
  return o ^ (((o >> 7) & (P - 1)) << 4);
}
template <int D>
__device__ __forceinline__ uint64_t npe_swz_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return npe_wgmma_desc(p, lbo, sbo) | ((uint64_t)(npe_sw<D>() == 128 ? 1 : 2) << 62);
}
template <int D, int R>
__device__ __forceinline__ uint64_t npe_kmajor_sw(const void* tile, int r0, int k0) {
  constexpr int SW = npe_sw<D>();
  return npe_swz_desc<D>(static_cast<const char*>(tile) + (2 * k0 / SW) * (R * SW) +
                             (r0 >> 3) * (8 * SW) + (2 * k0) % SW,
                         16, 8 * SW);
}
template <int D, int R>
__device__ __forceinline__ uint64_t npe_mnmajor_sw(const void* tile, int k0) {
  constexpr int SW = npe_sw<D>();
  return npe_swz_desc<D>(static_cast<const char*>(tile) + (k0 >> 3) * (8 * SW), R * SW, 8 * SW);
}

// The first 1024-byte boundary at or after p in shared memory.
__device__ __forceinline__ unsigned char* npe_align1024(unsigned char* p) {
  return p + ((1024u - (npe_smem_addr(p) & 1023u)) & 1023u);
}

// --- the tensor memory accelerator (TMA) and mbarriers -----------------------
// A TMA load copies a box of a tensor map (cuTensorMapEncodeTiled on the
// host, passed to the kernel as a __grid_constant__ parameter) into shared
// memory, writing zeros for the box's elements outside the tensor, and
// counts the box's bytes on an mbarrier in shared memory.  One thread primes
// the barrier with the bytes a phase expects (npe_mbar_expect, which is
// also the phase's one arrival) and issues the loads; every reader waits
// for the phase by its parity (npe_mbar_wait): the n-th use of a barrier
// waits with parity n & 1.
__device__ __forceinline__ void npe_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(npe_smem_addr(bar)), "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the async proxy (and the
// cluster); a barrier of the block follows before their first use.
__device__ __forceinline__ void npe_fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void npe_mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   npe_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void npe_mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nNPE_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra NPE_WAIT;\n}\n" ::"r"(npe_smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// The box at coordinates (c0, c1, c2, c3), innermost first, of a 4-D map.
__device__ __forceinline__ void npe_tma_load4(void* dst, const void* map, uint64_t* bar, int c0,
                                              int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(npe_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(npe_smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The two halves of a thread-block cluster's barrier, which every thread of
// every block of the cluster runs, split so that work can lie between them:
// arrive (release: the thread's writes, to distributed shared memory too,
// are seen by every thread past the wait) and wait (acquire).  The relaxed
// arrival orders nothing: it says only that the block is running, which a
// block must know of another before it touches that block's shared memory.
__device__ __forceinline__ void npe_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void npe_cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void npe_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void npe_fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void npe_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void npe_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of products are in flight.
template <int N = 0>
__device__ __forceinline__ void npe_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of d across a wgmma wait
// or fence: the product writes d asynchronously.
template <int R>
__device__ __forceinline__ void npe_reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N) = A . B, or += when scale_d != 0; A and B K-major in shared
// memory (npe_wgmma_ss_*; npe_wgmma_ss_ta_*: A MN-major, transposed), or A
// from registers and B MN-major (npe_wgmma_rs_*).
__device__ __forceinline__ void npe_wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void npe_wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void npe_wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void npe_wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void npe_wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void npe_wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void npe_wgmma_ss_ta_n16(float (&d)[8], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void npe_wgmma_ss_ta_n32(float (&d)[16], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
