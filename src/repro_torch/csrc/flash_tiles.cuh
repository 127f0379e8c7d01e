// The pieces that flash attention's dense mode shares between its forward
// (flash_attention.cu) and its backward (flash_attention_grad.cu): the
// warpgroup tiles' sizes, the wgmma chains over a tile, the staging of K,
// V, dO and q rows into wgmma's layout (hopper.cuh), and small helpers.
#pragma once

#include "hopper.cuh"
#include "pwl.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;
constexpr int Q_PIECES_MAX = 3;          // bf16 pieces of an f32 value (npe_split3)
constexpr int WG = 128;                  // threads of a warpgroup block
constexpr int WT = 64;                   // rows of a wgmma tile
constexpr int WK = 64;                   // keys a staged chunk

__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// 8 bf16 of a 16-byte load as f32 (exact).
__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

template <int N>
__device__ __forceinline__ void wg_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                      int scale_d) {
  if constexpr (N == 128) npe_wgmma_rs_n128(d, a, db, scale_d);
  else if constexpr (N == 64) npe_wgmma_rs_n64(d, a, db, scale_d);
  else npe_wgmma_rs_n32(d, a, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wg_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64) npe_wgmma_ss_n64(d, da, db, scale_d);
  else if constexpr (N == 32) npe_wgmma_ss_n32(d, da, db, scale_d);
  else npe_wgmma_ss_n16(d, da, db, scale_d);
}

// D (64 x N) = the sum over D's k16 steps (and q's bf16 pieces, each step in
// turn) of A . B, with `pieces` 1 or 3: each count fully unrolled, so that
// the products queue back to back (a loop of runtime length between them
// makes the compiler wait for each).  da(p, kk) and db(p, kk) are the
// operands of piece p at step kk.
template <int N, int D, typename FA, typename FB>
__device__ __forceinline__ void wg_ss_chain(float (&d)[N / 2], int pieces, FA da, FB db) {
  if (pieces == 1) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wg_ss<N>(d, da(0, kk), db(0, kk), kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int p = 0; p < Q_PIECES_MAX; ++p) wg_ss<N>(d, da(p, kk), db(p, kk), kk | p);
  }
}

// Row r of a (batch, kv head)'s tile rows, query-major: query r / group of q
// head hk * group + r % group.
struct GroupRow {
  int head, query;
};
__device__ __forceinline__ GroupRow group_row(int r, int hk, int group) {
  return GroupRow{hk * group + r % group, r / group};
}

// The tile row and the 16-byte piece that thread-slot x stages: eight
// consecutive slots take one piece of eight rows, one core matrix of 128
// contiguous bytes, so a quarter-warp's writes hit every bank once.
template <int D>
__device__ __forceinline__ void wg_slot(int x, int& r, int& c) {
  r = (x / D) * 8 + (x & 7);
  c = (x >> 3) % (D / 8);
}

// cp.async of rows r0..r0+rows-1 of a (batch, head)'s bf16 K, V or dO rows
// (stride `stride`) into a tile, zeros at and past `end`.
template <int D, int ROWS>
__device__ __forceinline__ void wg_stage_rows(const __nv_bfloat16* src, long long stride, int r0,
                                              int end, unsigned char* dst,
                                              int tid = threadIdx.x) {
#pragma unroll
  for (int j = 0; j < ROWS * (D / 8) / WG; ++j) {
    int r, c;
    wg_slot<D>(tid + j * WG, r, c);
    const bool ok = r0 + r < end;
    npe_cp_async16(dst + npe_tile_off<D>(r, c), ok ? src + (r0 + r) * stride + c * 8 : src,
                   ok ? 16 : 0);
  }
}

// q's staging into a tile's bf16 pieces, in two halves so that a kernel can
// issue its first K/V copies between them: wg_q_fetch reads the 8 values of
// thread-slot x (row rho, piece c; zeros for a padding row, row_src(rho) <
// 0), wg_q_put splits them into `pieces` bf16 pieces (npe_split3; one for
// bf16 q), each a ROWS x D tile.  row_src(rho) is the element offset of
// tile row rho in q; `vec`: q's rows are 16-byte aligned and contiguous,
// read 16 bytes a load.
template <int D, typename F>
__device__ __forceinline__ void wg_q_fetch(const void* q, long long qsd, int q_bf16, int vec, int x,
                                           F row_src, float (&f)[8], int& rho, int& c) {
  wg_slot<D>(x, rho, c);
  const long long base = row_src(rho);
  if (base < 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = 0.f;
  } else if (vec && q_bf16) {
    unpack8(__ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(q) + base) + c),
            f);
  } else if (vec) {
    const float4* p4 = reinterpret_cast<const float4*>(static_cast<const float*>(q) + base) + 2 * c;
    const float4 lo = __ldg(p4), hi = __ldg(p4 + 1);
    f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w, f[4] = hi.x, f[5] = hi.y, f[6] = hi.z;
    f[7] = hi.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = load(q, base + (c * 8 + i) * qsd, q_bf16);
  }
}

// The byte of a tile's 16-byte piece c of row r: wgmma's layout without
// swizzle, or (SWZ) the swizzled one a TMA load writes.
template <int D, int ROWS, bool SWZ>
__device__ __forceinline__ int wg_off(int r, int c) {
  if constexpr (SWZ) return npe_swz_off<D, ROWS>(r, c);
  else return npe_tile_off<D>(r, c);
}

template <int D, int ROWS, bool SWZ = false>
__device__ __forceinline__ void wg_q_put(const float (&f)[8], int rho, int c, int pieces,
                                         unsigned char* qt) {
  float p[8][3];
#pragma unroll
  for (int i = 0; i < 8; ++i) npe_split3(f[i], p[i]);
#pragma unroll
  for (int j = 0; j < Q_PIECES_MAX; ++j)
    if (j < pieces)
      *reinterpret_cast<uint4*>(qt + j * (ROWS * D * 2) + wg_off<D, ROWS, SWZ>(rho, c)) =
        make_uint4(npe_pack_bf16(p[0][j], p[1][j]), npe_pack_bf16(p[2][j], p[3][j]),
                   npe_pack_bf16(p[4][j], p[5][j]), npe_pack_bf16(p[6][j], p[7][j]));
}

// Both halves at once, every thread-slot of the tile in turn.
template <int D, int ROWS, bool SWZ = false, typename F>
__device__ __forceinline__ void wg_stage_q(const void* q, long long qsd, int q_bf16, int vec,
                                           int pieces, F row_src, unsigned char* qt) {
  for (int x = threadIdx.x; x < ROWS * (D / 8); x += blockDim.x) {
    float f[8];
    int rho, c;
    wg_q_fetch<D>(q, qsd, q_bf16, vec, x, row_src, f, rho, c);
    wg_q_put<D, ROWS, SWZ>(f, rho, c, pieces, qt);
  }
}

// TMA loads of ROWS rows from r0 of (batch b, head h) of a bf16 (B, H, S, D)
// tensor map (the backward's `rows_map`: boxes of ROWS rows and SW bytes of
// D, swizzled) into a tile, one box a column block, counted on `bar`;
// rows past the tensor's end arrive as zeros.  One thread calls it.
template <int D, int ROWS>
__device__ __forceinline__ void wg_tma_rows(unsigned char* dst, const void* map, uint64_t* bar,
                                            int r0, int h, int b) {
  constexpr int SW = npe_sw<D>();
#pragma unroll
  for (int blk = 0; blk < 2 * D / SW; ++blk)
    npe_tma_load4(dst + blk * (ROWS * SW), map, bar, blk * (SW / 2), r0, h, b);
}

// Four bf16 registers of a 16-column slice of a D block (8 values in mma's C
// layout): the A fragment of the next product.
__device__ __forceinline__ void wg_pack_a(const float* v, uint32_t (&f)[4]) {
  f[0] = npe_pack_bf16(v[0], v[1]);
  f[1] = npe_pack_bf16(v[2], v[3]);
  f[2] = npe_pack_bf16(v[4], v[5]);
  f[3] = npe_pack_bf16(v[6], v[7]);
}

// The max (or sum) of each of a thread's two rows over its quad of lanes,
// which hold the row's columns.
__device__ __forceinline__ void quad_reduce(float (&v)[2], bool is_max) {
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, v[e], o);
      v[e] = is_max ? fmaxf(v[e], y) : __fadd_rn(v[e], y);
    }
}

// Raise a kernel's dynamic shared memory limit to what this launch needs
// (static and dynamic shared memory together may pass 48 KB only so).
template <typename K>
int allow_smem(K kernel, size_t bytes, size_t& granted) {
  if (bytes <= granted) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  granted = bytes;
  return 0;
}

bool vec_ok(const void* p, long long s0, long long s1, long long s2, long long s3) {
  return s3 == 1 && s0 % 8 == 0 && s1 % 8 == 0 && s2 % 8 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
