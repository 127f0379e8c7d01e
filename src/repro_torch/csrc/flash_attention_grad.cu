// The backward of flash attention's dense mode (npe_attention_dense_grad),
// beside the forward in flash_attention.cu, whose row statistics it reads.
// It is a translation unit of its own so that the two compile in parallel.
#include <cooperative_groups.h>
#include <cuda.h>

#include <algorithm>

#include "flash_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// the dense mode's backward (npe_attention_dense_grad)
// ---------------------------------------------------------------------------
//
// jax.vjp of attention_scores (src/repro/models/common.py:205), which the
// reference's training differentiates: for each query row over its visible
// keys, with p^_j the bf16 probabilities of the forward, r its norm,
//   dp^_j = bf16(do . v_j)                      (jax rounds this cotangent)
//   dr = sum_j dp^_j e_j, dS = dr recip'(S)     (the reciprocal's slope at the
//        mantissa of max(S, 1e-30), times 2^-e twice; 1/2 where S ties 1e-30)
//   dz_j = (dp^_j r + dS) exp'(z_j)             (the exp table's slope, 1/2 where
//        the PWL ties 0, 0 past the clamp)
//   the row max's term -sum_j dz_j, split evenly among the tied maxima;
//   exact mode: jax.nn.softmax's p (dp - sum p dp);
//   the soft cap: ((dt c) tanh'(s / c)) / c, tanh' the table's slope;
//   dS_ij = dt_ij * scale; dq = dS . k, dk = sum_i dS_ij q_i and
//   dv = sum_i p^_ij do_i over the GQA group's rows, each rounded once to
//   its operand's dtype.
// Bound on this card: the CUDA cores.  The five products of a visible pair
// (S and dP again, dV, dK, dQ; 2 D each) take the bf16 tensor cores a
// fraction of the time of the chain above, some fifty f32 instructions a
// pair (a table search and its slope, the sums, dS's split), and the
// operands are read a few times from L2 at most.
// Design.  The forward wrote each row's m and norm (flash_dense_wg_kernel,
// `fstats`), so no sweep recomputes the max; the three stages of the
// forward are not undone, but the backward needs Q.K^T only three times:
// * `dense_grad_dq_kernel`, a warpgroup on the forward's 64-row tiles of a
//   (batch, kv head)'s group rows, K and V chunks of 64 keys through a
//   two-stage TMA ring, S = q.K^T and dP = dO.V^T by wgmma from shared
//   memory.  Sweep 1, the statistics: with z = s - m from the forward's m,
//   one prefix search a score gives e and its slope, and each row gathers
//   S = sum e, dr = sum dp^ e, sum dp^ w and sum w (w the slope times its
//   clip and floor factors) and its tied maxima; sum_j dz_j is linear in
//   dS, r sum dp^ w + dS sum w, so dS and the max's share follow at the
//   sweep's end with no sweep of their own (exact mode: sum p dp^).
//   Sweep 2: dS_ij, split into three exact bf16 pieces held in registers
//   as wgmma's A operand, into dQ += dS . K (K the transposed B).  It
//   writes dq and each row's (m, norm, dS, share).
// * `dense_grad_dkv_kernel`, one warpgroup a 64-key block of a (batch, kv
//   head), with K and V resident: the blocks of a thread-block cluster (its
//   rank the grid's x, up to 8, the largest divisor of the group) take the
//   group's q heads in turn, each over every 32-query tile that sees a key
//   of the block (its dO, bf16 q and row statistics through a two-stage
//   TMA ring).
//   S^T = K.q^T and dP^T = V.dO^T by wgmma give, in registers, P^T and dS^T
//   as the A operands of dV += P^T . dO and dK += dS^T . q.  At the end the
//   cluster sums its blocks' dK and dV in rank order through distributed
//   shared memory, and each block writes its share of the rows as bf16:
//   no f32 partials in device memory, no atomics, the same bits on every
//   launch.  The key blocks that see the most queries are launched first.
// Tiles.  One thread primes a stage's mbarrier with the bytes it expects
// and issues its TMA loads (a box of 64 or 32 rows of one (batch, head) and
// 128 bytes of D a load, from 4-D tensor maps of the strided (B, H, S, D)
// views that the host encodes per launch with libcuda's
// cuTensorMapEncodeTiled, reached by cudaGetDriverEntryPoint); the loads
// write wgmma's 128-byte swizzle (64-byte at D = 32), which the operand
// descriptors read (hopper.cuh, npe_kmajor_sw / npe_mnmajor_sw), and zeros
// past the tensor's rows.  The warpgroup waits on the stage's parity, and
// the block barrier that follows frees the other stage for the next
// chunk's loads.  Two tiles are not TMA boxes and keep cp.async or
// registers, written in the same swizzle: the q kernel's dO and q rows,
// whose 64 rows are (q head, query) pairs of a group, query-major, so an
// 8-row block spans several heads and queries (a group of 5 or 12 does not
// tile them into boxes), loaded once a block; and f32 q's three bf16
// pieces, which threads compute.
// The kv kernel's S^T is the dq kernel's S with A and B exchanged; both sum
// a score's D products in the same order (k16 steps in turn, q's pieces in
// turn), so z = 0 marks the same tied maxima in both.  Registers bound the
// kv kernel (two D-wide accumulators a thread): its q tiles are 32 wide.
// A table's value comes from the prefix search (the forward's bits), and
// its slope from `slope_table`'s row at the segment that search found.

constexpr int GNQ = 32;                  // queries a tile of the kv kernel
static_assert(WK == WT, "K and V share one tensor map: the q kernel's chunks are the kv kernel's blocks");

// Bytes of a stage of the kv kernel's ring: a dO tile, q's qp pieces and the
// tile's row statistics, in 1024-byte steps (the swizzle's alignment).
template <int D>
__host__ __device__ constexpr int grad_kv_stage(int qp) {
  return ((1 + qp) * GNQ * D * 2 + GNQ * 16 + 1023) / 1024 * 1024;
}

struct GradArgs {
  const void* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* fstats;                   // (B, Hq, Sq, 2): the forward's m and norm
  void* dq;                              // (B, Hq, Sq, D) in q's dtype
  __nv_bfloat16* dk;                     // (B, Hkv, Skv, D)
  __nv_bfloat16* dv;
  float* stats;                          // (B, Hq, Sq, 4): m, norm, dS, share
  long long qs[4], ks[4], vs[4], dos[4];
  int hq, hkv, sq, skv, q_bf16, q_pieces, causal, window, use_pwl, cluster;
  float scale, softcap;
  const float* exp_table;
  const float* exp_slopes;
  int exp_segs;
  float exp_lo, exp_hi;
  const float* recip_table;
  const float* recip_slopes;
  int recip_segs;
  float recip_lo, recip_hi;
  const float* tanh_table;
  const float* tanh_slopes;
  int tanh_segs;
  float tanh_lo, tanh_hi;
};

// The TMA tensor maps of a launch (`grad_maps`): K and V in boxes of WT
// rows, dO and bf16 q in boxes of GNQ rows, all with wgmma's swizzle
// (hopper.cuh, npe_swz_off); the q kernel's row statistics (B, Hq, Sq, 4)
// in boxes of GNQ rows, unswizzled.  `q` is unset for f32 q.
struct GradMaps {
  CUtensorMap k, v, dout, q, stats;
};

// The tables of a backward block: values in prefix form, slopes as rows.
struct GradTables {
  NpePrefixTable e, r, t;
  float es[2 * NPE_MAX_TABLE_COLS], rs[2 * NPE_MAX_TABLE_COLS], ts[2 * NPE_MAX_TABLE_COLS];
  int etop, rtop, ttop;
};

// Every thread of a block of WG threads calls it; ends synced.
__device__ __forceinline__ void grad_tables(GradTables& T, const GradArgs& a) {
  const NpePrefixFetch ef(a.exp_table, a.exp_segs), rf(a.recip_table, a.recip_segs);
  npe_load_slope_table(T.es, a.exp_slopes, a.exp_segs + 1);
  npe_load_slope_table(T.rs, a.recip_slopes, a.recip_segs + 1);
  if (a.softcap > 0.f && a.use_pwl) npe_load_slope_table(T.ts, a.tanh_slopes, a.tanh_segs + 1);
  npe_build_prefix_tables(T.e, ef, a.exp_segs, T.r, rf, a.recip_segs);
  if (a.softcap > 0.f && a.use_pwl) {
    const NpePrefixFetch tf(a.tanh_table, a.tanh_segs);
    npe_build_prefix_table(T.t, tf, a.tanh_segs);
  }
  T.etop = npe_prefix_top(a.exp_segs);
  T.rtop = npe_prefix_top(a.recip_segs);
  T.ttop = npe_prefix_top(a.tanh_segs);
}

__device__ __forceinline__ bool grad_masked(int col, int pos, const GradArgs& a) {
  return col >= a.skv || (a.causal && col > pos) || (a.window > 0 && col <= pos - a.window);
}

// N values of one table at once by the prefix search (npe_pwl_prefix_n's
// steps, so the walk's bits), in place, and the segment each found: the
// count of interior knots <= x, the segment whose slope is the derivative
// there.  N independent searches give the scheduler N chains to interleave.
template <int N>
__device__ __forceinline__ void grad_pwl_n(float (&v)[N], int (&seg)[N], const NpePrefixTable& t,
                                           int top) {
  const char* kb = reinterpret_cast<const char*>(t.knot);
  int k[N];   // 4 * seg
#pragma unroll
  for (int j = 0; j < N; ++j) k[j] = 0;
  if (top > 0) {
    const float k_top = t.knot[top];
#pragma unroll
    for (int j = 0; j < N; ++j) k[j] = v[j] >= k_top ? 4 * top : 0;
    int step = top >> 1;
    if (step > 0) {
      const float k_lo = t.knot[step], k_hi = t.knot[top + step];
#pragma unroll
      for (int j = 0; j < N; ++j) k[j] = v[j] >= (k[j] ? k_hi : k_lo) ? k[j] + 4 * step : k[j];
      for (step *= 2; step >= 4; step >>= 1) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int c = k[j] + step;
          k[j] = v[j] >= *reinterpret_cast<const float*>(kb + c) ? c : k[j];
        }
      }
    }
  }
  const char* sb = reinterpret_cast<const char*>(t.si);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float2 p = *reinterpret_cast<const float2*>(sb + 2 * k[j]);
    seg[j] = k[j] >> 2;
    v[j] = __fadd_rn(__fmul_rn(p.x, v[j]), p.y);
  }
}

// A fragment's 8 scores from their raw dots q . k, in place: s = dot *
// scale, then with a cap c the forward's c * tanh(s / c), keeping u = s / c,
// t = tanh(u) and, with PWL, tanh's slope at clip(u) for the backward.
struct GradCap8 {
  float u[8], t[8], slope[8];
};

template <bool PWL>
__device__ __forceinline__ void grad_scores8(float (&s)[8], GradCap8& c, const GradArgs& a,
                                             const GradTables& T) {
#pragma unroll
  for (int x = 0; x < 8; ++x) s[x] = __fmul_rn(s[x], a.scale);
  if (a.softcap <= 0.f) return;
#pragma unroll
  for (int x = 0; x < 8; ++x) c.u[x] = __fdiv_rn(s[x], a.softcap);
  if constexpr (PWL) {
    int seg[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) c.t[x] = fminf(fmaxf(c.u[x], a.tanh_lo), a.tanh_hi);
    grad_pwl_n<8>(c.t, seg, T.t, T.ttop);
#pragma unroll
    for (int x = 0; x < 8; ++x) c.slope[x] = T.ts[(a.tanh_segs + 1) + seg[x]];
  } else {
#pragma unroll
    for (int x = 0; x < 8; ++x) c.t[x] = tanhf(c.u[x]);
  }
#pragma unroll
  for (int x = 0; x < 8; ++x) s[x] = __fmul_rn(a.softcap, c.t[x]);
}

// e at N values z = s - m: the PWL exp floored at 0 (with its clipped value
// er and the slope of er's segment), or expf.
template <bool PWL, int N>
__device__ __forceinline__ void grad_exp(const float (&z)[N], float (&e)[N], float (&er)[N],
                                         float (&slope)[N], const GradArgs& a,
                                         const GradTables& T) {
  if constexpr (!PWL) {
#pragma unroll
    for (int x = 0; x < N; ++x) {
      e[x] = er[x] = expf(z[x]);
      slope[x] = 0.f;
    }
  } else {
    int seg[N];
#pragma unroll
    for (int x = 0; x < N; ++x) er[x] = fminf(fmaxf(z[x], a.exp_lo), a.exp_hi);
    grad_pwl_n<N>(er, seg, T.e, T.etop);
#pragma unroll
    for (int x = 0; x < N; ++x) {
      slope[x] = T.es[(a.exp_segs + 1) + seg[x]];
      e[x] = fmaxf(er[x], 0.f);
    }
  }
}

// Stats of one query row, as the q kernel writes them.
struct GradRow {
  float m, norm, ds, share;   // norm: 1/S (PWL) or S (exact); ds: dS (PWL) or sum p dp (exact)
};

// dz of one visible pair without the max's share (PWL), from its z, its
// exp's er and slope, its bf16 dp^ and the row's statistics.
__device__ __forceinline__ float grad_dz(float z, float er, float slope, float dph,
                                         const GradRow& r, const GradArgs& a) {
  float g = __fmul_rn(__fadd_rn(__fmul_rn(dph, r.norm), r.ds), npe_max_factor(er, 0.f));
  g = __fmul_rn(g, slope);
  return __fmul_rn(g, npe_clip_factor(z, a.exp_lo, a.exp_hi));
}

// (p^, dS_ij times scale) of 8 visible pairs: the forward's bf16
// probability; the softmax's gradient (its max's share where z = 0), then
// the cap's.  row(x) gives pair x's row statistics.
template <bool PWL, typename F>
__device__ __forceinline__ void grad_pairs8(const float (&z)[8], const float (&e)[8],
                                            const float (&er)[8], const float (&sl)[8],
                                            const float (&dph)[8], const GradCap8& c, F row,
                                            const GradArgs& a, float (&p)[8], float (&g)[8]) {
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const GradRow r = row(x);
    if constexpr (PWL) {
      p[x] = __fmul_rn(e[x], r.norm);
      const float gz = grad_dz(z[x], er[x], sl[x], dph[x], r, a);
      g[x] = z[x] == 0.f ? __fadd_rn(gz, r.share) : gz;
    } else {
      p[x] = __fdiv_rn(e[x], r.norm);
      g[x] = __fadd_rn(__fmul_rn(p[x], dph[x]), __fmul_rn(p[x], -r.ds));
    }
  }
  if (a.softcap > 0.f) {
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      float gc = __fmul_rn(g[x], a.softcap);
      if constexpr (PWL) {
        gc = __fmul_rn(gc, c.slope[x]);
        gc = __fmul_rn(gc, npe_clip_factor(c.u[x], a.tanh_lo, a.tanh_hi));
      } else {
        gc = __fmul_rn(__fadd_rn(gc, __fmul_rn(gc, c.t[x])), __fsub_rn(1.f, c.t[x]));
      }
      g[x] = __fdiv_rn(gc, a.softcap);
    }
  }
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    p[x] = __bfloat162float(__float2bfloat16_rn(p[x]));
    g[x] = __fmul_rn(g[x], a.scale);
  }
}

// Three bf16 A fragments of a 16x16 f32 C-layout tile (two n8 tiles), one a
// piece (npe_split3): their products sum to the f32 tile's exactly.
__device__ __forceinline__ void grad_split_frag(const float (&v)[8], uint32_t (&f)[3][4]) {
  float p[8][3];
#pragma unroll
  for (int x = 0; x < 8; ++x) npe_split3(v[x], p[x]);
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[j][r] = npe_pack_bf16(p[2 * r][j], p[2 * r + 1][j]);
}

// The dense backward's row statistics a thread's two rows keep through the
// statistics sweep (PWL: S, dr, sum dp^ w, sum w and the tied maxima, w_j
// the exp's slope at z_j with its clip and floor factors; exact: sum p dp^).
struct GradSums {
  float s[2], dr[2], a1[2], a2[2], ties[2], pdp[2];
};

// dq: the statistics sweep and the dQ sweep of one 64-row tile of a
// (batch, kv head)'s group rows (the forward's tiles); writes dq and each
// row's (m, norm, dS, share) for the kv kernel.
template <int D, bool PWL>
__global__ void __launch_bounds__(WG, 1)
dense_grad_dq_kernel(const GradArgs a, const __grid_constant__ GradMaps maps) {
  constexpr int CH = WK * D * 2;         // bytes of a K or V chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = npe_align1024(smem_raw);      // two stages of (K, V)
  unsigned char* dot = ring + 4 * CH;                 // dO's rows, WT x D
  unsigned char* qt = dot + WT * D * 2;               // q's pieces
  __shared__ GradTables T;
  __shared__ uint64_t arrived[2];                     // a stage's K and V are in place

  const int group = a.hq / a.hkv, R = group * a.sq;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * WT;   // the tiles that see the most keys first
  const int b = blockIdx.y / a.hkv, hk = blockIdx.y % a.hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int off = a.skv - a.sq;
  const int kv_lo = a.window > 0 ? max(0, off + r0 / group - a.window + 1) : 0;
  const int kv_hi = a.causal ? off + (min(r0 + WT, R) - 1) / group + 1 : a.skv;
  const int nc = (kv_hi - kv_lo + WK - 1) / WK, items = 2 * nc;
  // whether every row of the tile sees every key of the chunk from key0
  const int pos_lo = off + r0 / group, pos_hi = off + (min(r0 + WT, R) - 1) / group;
  auto chunk_full = [&](int key0) {
    return r0 + WT <= R && key0 + WK <= kv_hi && (!a.causal || key0 + WK - 1 <= pos_lo) &&
           (a.window == 0 || key0 > pos_hi - a.window);
  };
  // thread 0: chunk `it` of K and V by TMA into its stage (keys past Skv as
  // zeros; those from kv_hi to Skv are hidden by the mask)
  auto issue = [&](int it) {
    unsigned char* st = ring + (it & 1) * 2 * CH;
    const int k0 = kv_lo + (it % nc) * WK;
    npe_mbar_expect(&arrived[it & 1], 2 * CH);
    wg_tma_rows<D, WK>(st, &maps.k, &arrived[it & 1], k0, hk, b);
    wg_tma_rows<D, WK>(st + CH, &maps.v, &arrived[it & 1], k0, hk, b);
  };
  if (threadIdx.x == 0) {
    npe_mbar_init(&arrived[0], 1);
    npe_mbar_init(&arrived[1], 1);
    npe_fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) issue(0);
  auto row_base = [&](int rho, const long long (&st)[4]) -> long long {
    if (r0 + rho >= R) return -1;
    const GroupRow gr = group_row(r0 + rho, hk, group);
    return b * st[0] + gr.head * st[1] + gr.query * st[2];
  };
#pragma unroll
  for (int j = 0; j < WT * (D / 8) / WG; ++j) {   // dO's rows by cp.async
    int rho, c;
    wg_slot<D>(threadIdx.x + j * WG, rho, c);
    const long long base = row_base(rho, a.dos);
    npe_cp_async16(dot + npe_swz_off<D, WT>(rho, c), base >= 0 ? a.dout + base + c * 8 : a.dout,
                   base >= 0 ? 16 : 0);
  }
  npe_cp_async_commit();
  wg_stage_q<D, WT, true>(a.q, a.qs[3], a.q_bf16, 1, a.q_pieces,
                          [&](int rho) { return row_base(rho, a.qs); }, qt);
  npe_cp_async_wait<0>();
  npe_fence_async_smem();
  // this thread's rows: 16 warp + g and + 8, with the forward's m and norm
  int pos[2];
  bool valid[2];
  GroupRow gr[2];
  GradRow row[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + 16 * warp + g + 8 * e;
    valid[e] = r < R;
    gr[e] = group_row(valid[e] ? r : 0, hk, group);
    pos[e] = off + gr[e].query;
    const float2 fs = valid[e] ? __ldg(reinterpret_cast<const float2*>(a.fstats) +
                                       ((long long)b * a.hq + gr[e].head) * a.sq + gr[e].query)
                               : make_float2(NEG_BIG, 1.f);
    row[e] = GradRow{fs.x, fs.y, 0.f, 0.f};
  }
  grad_tables(T, a);                                  // ends synced
  GradSums sums = {};
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  for (int it = 0; it < items; ++it) {
    npe_mbar_wait(&arrived[it & 1], (it >> 1) & 1);
    __syncthreads();          // chunk `it` arrived; every warp is done with chunk it - 1
    if (threadIdx.x == 0 && it + 1 < items) issue(it + 1);
    const unsigned char* kt = ring + (it & 1) * 2 * CH;
    const unsigned char* vt = kt + CH;
    const int sweep = it / nc, key0 = kv_lo + (it % nc) * WK;
    // S = q . K^T and dP = dO . V^T over the chunk's keys
    float s[WK / 2], dp[WK / 2];
    npe_wgmma_fence();
    wg_ss_chain<WK, D>(
        s, a.q_pieces,
        [&](int p, int kk) { return npe_kmajor_sw<D, WT>(qt + p * (WT * D * 2), 0, 16 * kk); },
        [&](int, int kk) { return npe_kmajor_sw<D, WK>(kt, 0, 16 * kk); });
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg_ss<WK>(dp, npe_kmajor_sw<D, WT>(dot, 0, 16 * kk), npe_kmajor_sw<D, WK>(vt, 0, 16 * kk),
                kk);
    npe_wgmma_commit();
    npe_wgmma_wait();
    npe_reg_fence(s);
    npe_reg_fence(dp);
    // score x of slice u: row (x >> 1) & 1, key key0 + 16 u + 8 (x >> 2) + 2 t4 + (x & 1)
    const bool full = chunk_full(key0);
    uint32_t af[2][3][4];     // dS's pieces of two slices: one in flight, one being written
    if (sweep == 1) npe_wgmma_fence();
#pragma unroll
    for (int u = 0; u < WK / 16; ++u) {
      float sv[8], dph[8], z[8], ev[8], er[8], sl[8];
      bool vis[8];
      GradCap8 cap;
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int e = (x >> 1) & 1, col = key0 + 16 * u + 8 * (x >> 2) + 2 * t4 + (x & 1);
        vis[x] = full || (valid[e] & !grad_masked(col, pos[e], a));
        sv[x] = s[8 * u + x];
        dph[x] = __bfloat162float(__float2bfloat16_rn(dp[8 * u + x]));
      }
      grad_scores8<PWL>(sv, cap, a, T);
#pragma unroll
      for (int x = 0; x < 8; ++x) z[x] = __fsub_rn(sv[x], row[(x >> 1) & 1].m);
      grad_exp<PWL, 8>(z, ev, er, sl, a, T);
      if (sweep == 0) {       // a hidden score adds 0 to every sum
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int e = (x >> 1) & 1;
          if constexpr (PWL) {
            const float w = __fmul_rn(__fmul_rn(npe_max_factor(er[x], 0.f), sl[x]),
                                      npe_clip_factor(z[x], a.exp_lo, a.exp_hi));
            sums.s[e] = __fadd_rn(sums.s[e], vis[x] ? ev[x] : 0.f);
            sums.dr[e] = __fadd_rn(sums.dr[e], vis[x] ? __fmul_rn(dph[x], ev[x]) : 0.f);
            sums.a1[e] = __fadd_rn(sums.a1[e], vis[x] ? __fmul_rn(dph[x], w) : 0.f);
            sums.a2[e] = __fadd_rn(sums.a2[e], vis[x] ? w : 0.f);
            sums.ties[e] += vis[x] && z[x] == 0.f ? 1.f : 0.f;
          } else {
            sums.pdp[e] = __fadd_rn(sums.pdp[e],
                                    vis[x] ? __fmul_rn(__fdiv_rn(ev[x], row[e].norm), dph[x]) : 0.f);
          }
        }
      } else {                // dQ += dS . K, dS in three exact bf16 pieces
        float pr[8], ds[8];
        grad_pairs8<PWL>(z, ev, er, sl, dph, cap, [&](int x) { return row[(x >> 1) & 1]; }, a,
                         pr, ds);
#pragma unroll
        for (int x = 0; x < 8; ++x) ds[x] = vis[x] ? ds[x] : 0.f;
        if (u >= 2) npe_wgmma_wait<1>();    // slice u - 2's products have read af[u & 1]
        grad_split_frag(ds, af[u & 1]);
        npe_wgmma_fence();
#pragma unroll
        for (int j = 0; j < 3; ++j) wg_rs<D>(dq, af[u & 1][j], npe_mnmajor_sw<D, WK>(kt, 16 * u), 1);
        npe_wgmma_commit();
      }
    }
    if (sweep == 1) {
      npe_wgmma_wait();
      npe_reg_fence(dq);
    }
    if (it != nc - 1) continue;
    // the statistics sweep's end: dS, the max's share, and the rows' stats
    quad_reduce(sums.s, false);
    quad_reduce(sums.dr, false);
    quad_reduce(sums.a1, false);
    quad_reduce(sums.a2, false);
    quad_reduce(sums.ties, false);
    quad_reduce(sums.pdp, false);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (PWL) {
        // sc = mant * 2^ex with mant in [0.5, 1): 1/sc = pwl(mant) * 2^-ex
        const float sc = fmaxf(sums.s[e], 1e-30f);
        const int bits = __float_as_int(sc);
        const int ex = ((bits >> 23) & 0xff) - 126;
        const float mant = __int_as_float((bits & 0x007fffff) | (126 << 23));
        float gs = ldexpf(sums.dr[e], -ex);
        gs = __fmul_rn(gs, npe_pwl_slope(fminf(fmaxf(mant, a.recip_lo), a.recip_hi), T.rs,
                                         a.recip_segs));
        gs = __fmul_rn(gs, npe_clip_factor(mant, a.recip_lo, a.recip_hi));
        row[e].ds = __fmul_rn(ldexpf(gs, -ex), npe_max_factor(sums.s[e], 1e-30f));
        // sum_j dz_j = r sum dp^_j w_j + dS sum w_j
        const float dz = __fadd_rn(__fmul_rn(row[e].norm, sums.a1[e]),
                                   __fmul_rn(row[e].ds, sums.a2[e]));
        row[e].share = sums.ties[e] > 0.f ? __fdiv_rn(-dz, sums.ties[e]) : 0.f;
      } else {
        row[e].ds = sums.pdp[e];
        row[e].share = 0.f;
      }
      if (t4 == 0 && valid[e])
        reinterpret_cast<float4*>(a.stats)[((long long)b * a.hq + gr[e].head) * a.sq +
                                           gr[e].query] =
            make_float4(row[e].m, row[e].norm, row[e].ds, row[e].share);
    }
  }

  // dq in q's dtype, two neighbouring columns a store
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!valid[e]) continue;
    const long long base = (((long long)b * a.hq + gr[e].head) * a.sq + gr[e].query) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const long long o = base + 8 * j + 2 * t4;
      const float v0 = dq[4 * j + 2 * e], v1 = dq[4 * j + 2 * e + 1];
      if (a.q_bf16)
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.dq) + o) = npe_pack_bf16(v0, v1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(a.dq) + o) = make_float2(v0, v1);
    }
  }
}

// dK and dV of one 64-key block of a (batch, kv head): the blocks of a
// cluster (its rank the grid's x) take the group's q heads in turn, each
// over every GNQ-query tile that sees one of the block's keys; the cluster
// sums its blocks' accumulators in rank order through distributed shared
// memory and writes bf16 dK and dV once.
template <int D, bool PWL, int QP>
__global__ void __launch_bounds__(WG, 1)
dense_grad_dkv_kernel(const GradArgs a, const __grid_constant__ GradMaps maps) {
  namespace cg = cooperative_groups;
  constexpr int KT = WT * D * 2;         // bytes of the K or V block
  constexpr int QT = GNQ * D * 2;        // bytes of a dO tile or a q piece
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kt = npe_align1024(smem_raw);
  unsigned char* vt = kt + KT;
  unsigned char* ring = vt + KT;         // two stages of (dO, q's pieces, stats)
  constexpr int STAGE = grad_kv_stage<D>(QP);
  __shared__ GradTables T;
  __shared__ uint64_t arrived[3];        // a stage's tiles are in place; K and V are

  const int cs = a.cluster, rank = blockIdx.x;
  const int b = blockIdx.y / a.hkv, hk = blockIdx.y % a.hkv;
  const int k0 = blockIdx.z * WT;        // the keys that see the most queries first
  const int group = a.hq / a.hkv, off = a.skv - a.sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) npe_mbar_init(&arrived[i], 1);
    npe_fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {                // the block's K and V rows, keys past Skv as zeros
    npe_mbar_expect(&arrived[2], 2 * KT);
    wg_tma_rows<D, WT>(kt, &maps.k, &arrived[2], k0, hk, b);
    wg_tma_rows<D, WT>(vt, &maps.v, &arrived[2], k0, hk, b);
  }
  // the queries that see a key of the block: position >= k0 (causal) and
  // < the last key + window (window > 0)
  const int i_lo = a.causal ? max(0, k0 - off) : 0;
  const int i_hi = a.window > 0 ? min(a.sq - 1, k0 + WT - 2 + a.window - off) : a.sq - 1;
  const int t_lo = (i_lo / GNQ) * GNQ;
  const int ntq = i_hi >= t_lo ? (i_hi - t_lo) / GNQ + 1 : 0;
  const int items = ((group - rank + cs - 1) / cs) * ntq;   // this rank's heads x tiles
  auto head_of = [&](int it) { return hk * group + rank + (it / ntq) * cs; };
  // thread 0: tile `it`'s dO, bf16 q and row statistics by TMA into its
  // stage (queries past Sq as zeros)
  auto issue = [&](int it) {
    unsigned char* st = ring + (it & 1) * STAGE;
    const int h = head_of(it), q0 = t_lo + (it % ntq) * GNQ;
    npe_mbar_expect(&arrived[it & 1], (QP == 1 ? 2 * QT : QT) + GNQ * 16);
    wg_tma_rows<D, GNQ>(st, &maps.dout, &arrived[it & 1], q0, h, b);
    if constexpr (QP == 1) wg_tma_rows<D, GNQ>(st + QT, &maps.q, &arrived[it & 1], q0, h, b);
    npe_tma_load4(st + (1 + QP) * QT, &maps.stats, &arrived[it & 1], 0, q0, h, b);
  };
  if (threadIdx.x == 0 && items > 0) issue(0);
  grad_tables(T, a);                                  // ends synced
  npe_mbar_wait(&arrived[2], 0);
  const int kw = k0 + 16 * warp;                      // this warp's first key
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < items; ++it) {
    npe_mbar_wait(&arrived[it & 1], (it >> 1) & 1);
    __syncthreads();          // tile `it` arrived; every warp is done with tile it - 1
    if (threadIdx.x == 0 && it + 1 < items) issue(it + 1);
    const unsigned char* dot = ring + (it & 1) * STAGE;
    unsigned char* qpt = const_cast<unsigned char*>(dot) + QT;
    const float4* sst = reinterpret_cast<const float4*>(dot + (1 + QP) * QT);
    const int h = head_of(it), q0 = t_lo + (it % ntq) * GNQ;
    if constexpr (QP > 1) {   // f32 q in bf16 pieces, through registers
      wg_stage_q<D, GNQ, true>(a.q, a.qs[3], 0, 1, QP, [&](int rho) -> long long {
        return q0 + rho < a.sq ? b * a.qs[0] + h * a.qs[1] + (q0 + rho) * a.qs[2] : -1;
      }, qpt);
      npe_fence_async_smem();
      __syncthreads();
    }
    // S^T = K . q^T and dP^T = V . dO^T over the tile's queries
    float s[GNQ / 2], dp[GNQ / 2];
    npe_wgmma_fence();
    wg_ss_chain<GNQ, D>(
        s, QP, [&](int, int kk) { return npe_kmajor_sw<D, WT>(kt, 0, 16 * kk); },
        [&](int p, int kk) { return npe_kmajor_sw<D, GNQ>(qpt + p * QT, 0, 16 * kk); });
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wg_ss<GNQ>(dp, npe_kmajor_sw<D, WT>(vt, 0, 16 * kk), npe_kmajor_sw<D, GNQ>(dot, 0, 16 * kk),
                 kk);
    npe_wgmma_commit();
    npe_wgmma_wait();
    npe_reg_fence(s);
    npe_reg_fence(dp);
    uint32_t pa[GNQ / 16][4], af[GNQ / 16][3][4];
    // the tile's queries all see the block's keys: no score is hidden
    const bool full = q0 + GNQ <= a.sq && k0 + WT <= a.skv &&
                      (!a.causal || k0 + WT - 1 <= off + q0) &&
                      (a.window == 0 || k0 > off + q0 + GNQ - 1 - a.window);
#pragma unroll
    for (int u = 0; u < GNQ / 16; ++u) {
      // score x of slice u: key kw + g + 8 ((x >> 1) & 1), query q0 + qi(x)
      float sv[8], z[8], ev[8], er[8], sl[8], dph[8], p[8], ds[8];
      GradCap8 cap;
      auto qi = [&](int x) { return 16 * u + 8 * (x >> 2) + 2 * t4 + (x & 1); };
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        sv[x] = s[8 * u + x];
        dph[x] = __bfloat162float(__float2bfloat16_rn(dp[8 * u + x]));
      }
      grad_scores8<PWL>(sv, cap, a, T);
#pragma unroll
      for (int x = 0; x < 8; ++x) z[x] = __fsub_rn(sv[x], sst[qi(x)].x);
      grad_exp<PWL, 8>(z, ev, er, sl, a, T);
      grad_pairs8<PWL>(z, ev, er, sl, dph, cap, [&](int x) {
        const float4 st = sst[qi(x)];
        return GradRow{st.x, st.y, st.z, st.w};
      }, a, p, ds);
      if (!full) {
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int key = kw + g + 8 * ((x >> 1) & 1);
          const bool hide = q0 + qi(x) >= a.sq || grad_masked(key, off + q0 + qi(x), a);
          p[x] = hide ? 0.f : p[x];
          ds[x] = hide ? 0.f : ds[x];
        }
      }
      wg_pack_a(p, pa[u]);
      grad_split_frag(ds, af[u]);
    }
    // dV += P^T . dO and dK += dS^T . q, dS in three exact bf16 pieces
    npe_wgmma_fence();
#pragma unroll
    for (int u = 0; u < GNQ / 16; ++u) wg_rs<D>(dv, pa[u], npe_mnmajor_sw<D, GNQ>(dot, 16 * u), 1);
#pragma unroll
    for (int u = 0; u < GNQ / 16; ++u)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int pc = 0; pc < QP; ++pc)
          wg_rs<D>(dk, af[u][j], npe_mnmajor_sw<D, GNQ>(qpt + pc * QT, 16 * u), 1);
    npe_wgmma_commit();
    npe_wgmma_wait();
    npe_reg_fence(dk);
    npe_reg_fence(dv);
  }
  __syncthreads();            // every warp is done with the tiles: the smem holds the sums

  // the cluster's sum: each block's accumulators to its shared memory, then
  // rank c sums its share of the rows over ranks 0..cs-1 in order
  float* red = reinterpret_cast<float*>(smem_raw);   // dK then dV, WT x D each
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int o = (16 * warp + g + 8 * e) * D + 8 * j + 2 * t4 + hh;
        red[o] = dk[4 * j + 2 * e + hh];
        red[WT * D + o] = dv[4 * j + 2 * e + hh];
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = (WT + cs - 1) / cs;
  const long long base = (((long long)b * a.hkv + hk) * a.skv + k0) * D;
  for (int idx = threadIdx.x; idx < per * D; idx += WG) {
    const int r = rank * per + idx / D;
    if (r >= WT || k0 + r >= a.skv) break;
    float sk = 0.f, sv = 0.f;
    for (int c = 0; c < cs; ++c) {
      const float* rem = cluster.map_shared_rank(red, c);
      sk = __fadd_rn(sk, rem[r * D + idx % D]);
      sv = __fadd_rn(sv, rem[WT * D + r * D + idx % D]);
    }
    a.dk[base + r * D + idx % D] = __float2bfloat16_rn(sk);
    a.dv[base + r * D + idx % D] = __float2bfloat16_rn(sv);
  }
  cluster.sync();             // no block leaves while another reads its sums
}

// The largest divisor of the group at most 8: the cluster that splits a kv
// head's q heads evenly.
inline int grad_cluster(int group) {
  for (int c = 8; c > 1; --c)
    if (group % c == 0) return c;
  return 1;
}

// libcuda's cuTensorMapEncodeTiled, reached through the runtime so that the
// library needs no link to libcuda; null if the installed libcuda lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 4-D map (innermost first: d, s, h, b) of a (B, H, S, D) view with
// element strides st, whose box is `rows` rows of one (batch, head) by `cols`
// values: bf16 with wgmma's swizzle (`cols` = SW / 2), or unswizzled f32.
int rows_map(CUtensorMap* m, const void* p, bool bf16, int b, int h, int s, int d,
             const long long (&st)[4], int rows, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int es = bf16 ? 2 : 4;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h, (cuuint64_t)b};
  // bytes; a stride of 0 (a broadcast size-1 dimension) is never stepped
  const cuuint64_t strides[3] = {(cuuint64_t)std::max(st[2] * es, 16LL),
                                 (cuuint64_t)std::max(st[1] * es, 16LL),
                                 (cuuint64_t)std::max(st[0] * es, 16LL)};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1}, step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = !bf16 ? CU_TENSOR_MAP_SWIZZLE_NONE
                                 : cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                   : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUresult r = encode(m, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            4, const_cast<void*>(p), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int grad_maps(GradMaps& m, const GradArgs& a, int batch) {
  constexpr int C = npe_sw<D>() / 2;
  // cuTensorMapEncodeTiled needs the device's context current on this
  // thread, which the runtime binds only at a call that needs it: a thread
  // whose first call this is (autograd's backward runs on a worker thread
  // of its own) would get CUDA_ERROR_INVALID_CONTEXT.  cudaFree(nullptr)
  // binds it.
  if (const cudaError_t err = cudaFree(nullptr)) return (int)err;
  const long long ss[4] = {(long long)a.hq * a.sq * 4, (long long)a.sq * 4, 4, 1};   // stats
  if (int err = rows_map(&m.k, a.k, true, batch, a.hkv, a.skv, D, a.ks, WT, C)) return err;
  if (int err = rows_map(&m.v, a.v, true, batch, a.hkv, a.skv, D, a.vs, WT, C)) return err;
  if (int err = rows_map(&m.dout, a.dout, true, batch, a.hq, a.sq, D, a.dos, GNQ, C)) return err;
  if (a.q_bf16)
    if (int err = rows_map(&m.q, a.q, true, batch, a.hq, a.sq, D, a.qs, GNQ, C)) return err;
  return rows_map(&m.stats, a.stats, false, batch, a.hq, a.sq, 4, ss, GNQ, 4);
}

template <int D, bool PWL>
int launch_dense_grad_t(const GradArgs& a, int batch, cudaStream_t stream) {
  static size_t granted_q = 0, granted_kv1 = 0, granted_kv3 = 0;
  GradMaps maps = {};
  if (int err = grad_maps<D>(maps, a, batch)) return err;
  const int rows = (a.hq / a.hkv) * a.sq;
  // + 1024: the tiles start on the first 1024-byte boundary
  const size_t q_bytes = (size_t)(4 * WK + WT + a.q_pieces * WT) * D * 2 + 1024;
  if (int err = allow_smem(dense_grad_dq_kernel<D, PWL>, q_bytes, granted_q)) return err;
  dense_grad_dq_kernel<D, PWL><<<dim3((rows + WT - 1) / WT, batch * a.hkv), WG, q_bytes,
                                 stream>>>(a, maps);
  if (const cudaError_t err = cudaGetLastError()) return (int)err;
  const size_t kv_bytes = max((size_t)2 * WT * D * 2 + 2 * grad_kv_stage<D>(a.q_pieces) + 1024,
                              (size_t)2 * WT * D * 4);
  const auto kernel = a.q_pieces == 1 ? dense_grad_dkv_kernel<D, PWL, 1>
                                      : dense_grad_dkv_kernel<D, PWL, Q_PIECES_MAX>;
  if (int err = allow_smem(kernel, kv_bytes, a.q_pieces == 1 ? granted_kv1 : granted_kv3))
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, batch * a.hkv, (a.skv + WT - 1) / WT);
  cfg.blockDim = dim3(WG);
  cfg.dynamicSmemBytes = kv_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, maps))
    return (int)err;
  return (int)cudaGetLastError();
}

template <int D>
int launch_dense_grad(const GradArgs& a, int batch, cudaStream_t stream) {
  return a.use_pwl ? launch_dense_grad_t<D, true>(a, batch, stream)
                   : launch_dense_grad_t<D, false>(a, batch, stream);
}

}  // namespace

extern "C" int npe_attention_dense_grad(
    const void* q, const void* k, const void* v, const void* dout, const float* fstats, void* dq,
    void* dk, void* dv, float* stats,
    long long qsb, long long qsh, long long qss, long long qsd,
    long long ksb, long long ksh, long long kss, long long ksd,
    long long vsb, long long vsh, long long vss, long long vsd,
    long long dsb, long long dsh, long long dss, long long dsd,
    int batch, int hq, int hkv, int sq, int skv, int d, int q_bf16, int causal, int window,
    float scale, float softcap, int use_pwl,
    const float* exp_table, const float* exp_slopes, int exp_segments, float exp_lo, float exp_hi,
    const float* recip_table, const float* recip_slopes, int recip_segments, float recip_lo,
    float recip_hi, const float* tanh_table, const float* tanh_slopes, int tanh_segments,
    float tanh_lo, float tanh_hi, void* stream) {
  const auto bad_table = [](const float* t, const float* s, int segs) {
    return t == nullptr || s == nullptr || segs < 1 || segs + 1 > NPE_MAX_TABLE_COLS;
  };
  if (bad_table(exp_table, exp_slopes, exp_segments) ||
      bad_table(recip_table, recip_slopes, recip_segments) ||
      (softcap > 0.f && use_pwl && bad_table(tanh_table, tanh_slopes, tanh_segments)) ||
      hkv < 1 || hq % hkv != 0 || sq > skv || window < 0 || !(softcap >= 0.f) ||
      fstats == nullptr || stats == nullptr)
    return (int)cudaErrorInvalidValue;
  // q, K, V and dO rows are read as 16-byte vectors
  if (!(vec_ok(k, ksb, ksh, kss, ksd) && vec_ok(v, vsb, vsh, vss, vsd) &&
        vec_ok(dout, dsb, dsh, dss, dsd) && vec_ok(q, qsb, qsh, qss, qsd)))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || hq <= 0 || sq <= 0) return 0;
  GradArgs a{q, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
             static_cast<const __nv_bfloat16*>(dout), fstats, dq,
             static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), stats,
             {qsb, qsh, qss, qsd}, {ksb, ksh, kss, ksd}, {vsb, vsh, vss, vsd},
             {dsb, dsh, dss, dsd},
             hq, hkv, sq, skv, q_bf16, q_bf16 ? 1 : Q_PIECES_MAX, causal ? 1 : 0, window,
             use_pwl, grad_cluster(hq / hkv), scale, softcap,
             exp_table, exp_slopes, exp_segments, exp_lo, exp_hi,
             recip_table, recip_slopes, recip_segments, recip_lo, recip_hi,
             tanh_table, tanh_slopes, tanh_segments, tanh_lo, tanh_hi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dense_grad<32>(a, batch, s);
    case 64: return launch_dense_grad<64>(a, batch, s);
    case 128: return launch_dense_grad<128>(a, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
