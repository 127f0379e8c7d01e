// Flash attention on Hopper with the NVU's PWL exp and PWL reciprocal.
//
// Replaces: flash_attention / _flash_kernel in
// src/repro/kernels/flash_attention.py (the Pallas call at :130).
//
// What the function is.  `_flash_kernel` streams each row over KV blocks of
// `block_kv` keys with a running max m, sum l and accumulator acc, rescaled
// by exp(m_prev - m_new) at each block.  With PWL exp, pwl_exp(0) is 0.999,
// so the result depends on the blocking: every kernel here updates m, l and
// acc once per `block_kv` block, with the reference's corr, and skips a
// block for a row exactly when the TPU kernel skips it for the row's
// logical q block (`block_q` rows; `block_runs` in the wrapper).  Inside a
// block the keys may be split among warps in any way: only the order of f32
// sums changes.  The mask is end-aligned (query i at position
// kv_len - Sq + i); keys at or past kv_len are never read, so decode reads
// the (B, S, H, D) cache in place through permuted views.
//
// Bound on this card: bytes at the serving shapes.  A decode step reads the
// visible cache (2 x kv_len x D bf16 a kv head) for one query a head; a
// 128-token prefill does 128 times the products on the same bytes, which on
// the bf16 tensor cores is still below the byte time, while the exp of each
// score (a PWL table walk of some fifty operations) runs on the CUDA cores.
//
// Three instances, chosen by dtype and shape, never as a fallback:
// * bf16 K/V, at most 8 query rows a kv head (decode: Sq x group <= 8):
//   `flash_decode_kernel`.  One block of 8 warps for each (batch, kv head)
//   takes every q head of its GQA group, so K and V are read once a group.
//   The threads split each KV block's keys: D/8 lanes a key row, 16-byte
//   loads of 8 bf16 straight from the strided cache, several in flight a
//   thread, V of the first chunk fetched before the softmax.  Scores go to
//   shared memory; the block's max and sum are reduced across warps; each
//   thread keeps acc_t = corr * acc_t + P.V over its own keys, and these
//   partial accumulators are summed across threads at the end: the
//   reference's acc up to the order of f32 sums.  f32 products
//   on the CUDA cores: a decode row has one query, nothing for a tensor core.
// * bf16 K/V, more rows: `flash_mma_kernel`, FlashAttention-2 style on the
//   tensor cores.  A block of 8 warps takes 16 query rows of one head (so a
//   128-token prefill of 12 heads is 96 blocks); the warps split each
//   128-key chunk, 16 keys a warp.  K and V chunks stream through a
//   four-stage cp.async ring in shared memory, three chunks in flight (rows
//   padded by 16 bytes, so ldmatrix reads no bank twice).  S = Q.K^T by mma.sync m16n8k16 bf16
//   with f32 accumulation, K by ldmatrix; the scores stay in the
//   accumulator fragments (and a shared-memory copy in fragment order while
//   the block's max is reduced: the max over a quad of lanes, then across
//   warps); p is computed in the fragments, which are the A operand of P.V,
//   and V comes by ldmatrix.trans.  Numerics:
//   - a bf16 x bf16 product is exact in f32, so only sums change order;
//   - q*scale is rounded to f32 as in the reference and split into three
//     bf16 pieces (exact); when q is bf16 and scale a power of two
//     (D = 64: 0.125) q*scale is itself a bf16 and one piece is used;
//   - p is f32 in the reference: it is split into three bf16 pieces
//     (exact) before P.V, so P.V differs by the order of f32 sums only;
//   - rows of the 16-row tile whose logical q block skips a KV block
//     (block_q < 16) keep m, l and acc: their p is 0 and corr is 1.
// * f32 K/V (no main path hands the kernel f32 K/V): `flash_f32kv_kernel`,
//   the CUDA-core kernel of the first port, one warp for 4 of 16 query rows
//   of a head, K and V tiles staged as f32 in padded shared memory.
// After the decode path moved to the dense mode below, the blocked mode
// serves no model, as the TPU kernel serves none in the reference.
//
// The dense mode (`npe_attention_dense`) is the models' attention: the
// cache case of the reference's `attention_scores` (src/repro/models/
// common.py, with nvu_softmax and nvu_reciprocal of src/repro/core/nvu.py),
// which is no Pallas kernel.  For each query row at position pos (causal,
// end-aligned) over bf16 K/V: s = (q . k) * scale in f32, keys past pos
// masked; m = the max over every visible key, with no running rescale;
// e = nvu_exp(s - m) (npe_softmax_exp_n) or exp; p = e * pwl_recip(sum e)
// or e / sum e, rounded to bf16 as `probs.astype(v.dtype)`; out = P.V
// accumulated in f32.  The PWL exp does not rescale (pwl_exp(0) = 0.999),
// so the three stages are part of the function: m must be known before any
// e, and the sum before any p.  Two instances, chosen by shape:
// * at most 8 query rows a kv head (a decode step of a small GQA group):
//   `flash_dense_split_kernel`, instances for 1, 2, 4 and 8 rows.  A decode
//   step reads each cache row once for a few queries, so it is bound by the
//   cache's bytes, and one block a (batch, kv head) streams at one SM's
//   rate.  So a thread-block cluster of up to 8 blocks takes a (batch, kv
//   head), each block a contiguous range of its keys, enough blocks to fill
//   the card.  The PWL exp does not rescale, so the blocks cannot combine
//   partial softmaxes as flash-decoding does: the three stages stay, and
//   between them the cluster exchanges each row's max, then its sum,
//   through distributed shared memory in rank order; at the end the blocks'
//   P.V partials are summed in rank order.  One launch, no atomics, the
//   same bits every launch.  K and V come through a cp.async ring; the
//   scores are products on the tensor cores (keys on M, rows on N), kept in
//   shared memory, so K is read once and V once while a block's scores fit.
// * more rows, or any call that asks for the row statistics (the train
//   step's forward): `flash_dense_wg_kernel`, one warpgroup a block on a
//   64-row wgmma tile.  A tile's rows are (q head, query) pairs of one
//   (batch, kv head), query-major (row r: query r / group of q head
//   r % group), so the group's heads share every K and V chunk, a decode
//   step of a 12- or 16-head group fills one tile, and a tile's rows see
//   nearly the same causal key range; the tiles that see the most keys are
//   launched first.  The 64 x 1024 f32 scores of a tile do not fit in 227 KB
//   of shared memory, so the three stages are three sweeps over the tile's
//   keys, each recomputing S = q . K^T on the tensor cores (wgmma
//   m64n64k16, q in bf16 pieces, unscaled, from shared memory), which have
//   ten times the headroom of the PWL chain: the max; the sum of e with the
//   max fixed; then e again, p^ = bf16(e * norm) packed in registers as the
//   A operand of out += p^ . V (wgmma, V as the transposed B).  K and V come
//   in 64-key chunks through a four-slot cp.async ring in wgmma's layout
//   without swizzle (hopper.cuh: eight rows of a 16-byte piece a core
//   matrix), three chunks in flight.  The backward (flash_attention_grad.cu)
//   takes its tiles by TMA in the 128-byte swizzle, which shortened its
//   kernels on the H100 (PERF.md); this ring is to follow it.
//   Each warp owns 16 rows over every key of a chunk, so a row's max and
//   sum reduce over its quad of lanes, with no cross-warp reduction.  When
//   asked, the block writes each row's statistics (B, Hq, Sq, 2): m and the
//   norm its p^ was taken with (the PWL reciprocal of the sum, or the sum),
//   which the backward reads instead of recomputing them.  Bound: the PWL
//   chain on the CUDA cores at training shapes (each visible pair's exp
//   twice, its search some twenty instructions), the K/V bytes at decode.
// Its backward, which reads those statistics, is flash_attention_grad.cu;
// the pieces both use are flash_tiles.cuh.
// The dense mode also takes the rest of attention_scores' mask and its soft
// cap.  `causal` = 0 lets every row see every key below kv_len (a ring
// cache: the reference's prefix validity arange(wlen) <= pos | pos >= wlen
// is a key count, kv_len = min(pos + 1, wlen)); `window` > 0 hides the keys
// at or below pos - window; `softcap` > 0 maps each score s (after the
// scale, before the mask) to c * tanh(s / c), tanh the NVU's PWL table
// (clamped to its end knots, as nvu_tanh) or tanhf.  A block reads only the
// keys some row of it sees: from the first row's pos - window + 1 (0
// without a window) to its last row's pos (kv_len with causality off), so
// a windowed prefill tile reads about window + its queries' keys, not all
// before it.  The row max is taken over visible keys only (masked scores
// are NEG_BIG), since the PWL exp does not rescale.
#include <cooperative_groups.h>

#include <type_traits>

#include "flash_tiles.cuh"

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long qs[4], ks[4], vs[4], os[4];   // element strides of (B, H, S, D)
  int hq, hkv, sq, kv_len;
  int q_bf16, kv_bf16, out_bf16;
  int causal, window, use_pwl, block_q, block_kv;
  float scale;
  int q_pieces;                           // bf16 pieces of q*scale (mma kernel)
  const float* exp_table;
  int exp_segs;
  const float* recip_table;
  int recip_segs;
  // the dense mode's soft cap: c (0: none) and the tanh table with its end knots
  float softcap;
  const float* tanh_table;
  int tanh_segs;
  float tanh_lo, tanh_hi;
  // the dense mode's row statistics (B, Hq, Sq, 2): m and the norm, or null
  float* stats;
  int q_vec;                              // q's rows 16-byte aligned and contiguous
  // the dense mode's decode instance: blocks a cluster, keys a segment's scores
  int split, seg;
};

__device__ __forceinline__ void store(const Args& a, long long o, float y) {
  if (a.out_bf16)
    static_cast<__nv_bfloat16*>(a.out)[o] = npe_from_f32<__nv_bfloat16>(y);
  else
    static_cast<float*>(a.out)[o] = y;
}

// `_exp_fn`: clamp at -18, PWL exp floored at 0; or expf.
__device__ __forceinline__ float attn_exp(float z, const Args& a, const float* etab) {
  if (a.use_pwl) return fmaxf(npe_pwl(fmaxf(z, -18.f), etab, a.exp_segs), 0.f);
  return expf(z);
}

// attn_exp on 8 values in place; with PWL each table entry is read once for all 8.
__device__ __forceinline__ void attn_exp8(float (&z)[8], const Args& a, const float* etab) {
  if (a.use_pwl) {
#pragma unroll
    for (int i = 0; i < 8; ++i) z[i] = fmaxf(z[i], -18.f);
    npe_pwl_n<8>(z, etab, a.exp_segs);
#pragma unroll
    for (int i = 0; i < 8; ++i) z[i] = fmaxf(z[i], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) z[i] = expf(z[i]);
  }
}

// 1 / max(l, 1e-30): the PWL reciprocal or a divide.
__device__ __forceinline__ float attn_recip(float l, const Args& a, const float* rtab) {
  const float ls = fmaxf(l, 1e-30f);
  return a.use_pwl ? npe_recip_via_pwl(ls, rtab, a.recip_segs) : __fdiv_rn(1.f, ls);
}

__device__ __forceinline__ bool key_masked(int col, int pos, const Args& a) {
  return (a.causal && col > pos) || (a.window > 0 && col <= pos - a.window);
}

// Query row i (0..Sq-1): its position and the first and last position of
// its logical q block.
struct Row {
  int pos, lo, hi;
};

__device__ __forceinline__ Row row_of(int i, const Args& a) {
  const int off = a.kv_len - a.sq;
  const int qb = i / a.block_q;
  return Row{off + i, off + qb * a.block_q, off + min(qb * a.block_q + a.block_q, a.sq) - 1};
}

// `_flash_kernel`'s rule: whether a row of this logical q block computes the
// KV block at kb0.
__device__ __forceinline__ bool row_runs(const Row& r, int kb0, const Args& a) {
  if (!a.causal) return true;
  bool run = kb0 <= r.hi;
  if (a.window > 0) run = run && kb0 + a.block_kv - 1 >= r.lo - a.window + 1;
  return run;
}

__device__ __forceinline__ void load_tables(const Args& a, float* etab, float* rtab) {
  if (a.use_pwl) {
    npe_load_table(etab, a.exp_table, a.exp_segs + 1);
    npe_load_table(rtab, a.recip_table, a.recip_segs + 1);
  }
}

// ---------------------------------------------------------------------------
// f32 K/V: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 16;           // query rows a block
constexpr int WARPS = 4;
constexpr int RPW = BQ / WARPS;  // rows a warp
constexpr int TK = 64;           // keys a staged tile

template <int D>
__global__ void __launch_bounds__(32 * WARPS)
flash_f32kv_kernel(const Args a) {
  constexpr int DP = D + 1;        // padded row of a staged K or V tile
  constexpr int CPL = D / 32;      // accumulator columns a lane
  extern __shared__ float smem[];
  float* q_s = smem;               // BQ x D, scaled
  float* kv_s = q_s + BQ * D;      // TK x DP
  float* s_s = kv_s + TK * DP;     // BQ x block_kv: a block's scores, then p
  __shared__ float etab[3 * NPE_MAX_TABLE_COLS];
  __shared__ float rtab[3 * NPE_MAX_TABLE_COLS];
  load_tables(a, etab, rtab);

  const int bh = blockIdx.y;
  const int b = bh / a.hq, h = bh % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = blockIdx.x * BQ;
  const long long qbase = b * a.qs[0] + h * a.qs[1];
  const long long kbase = b * a.ks[0] + hk * a.ks[1];
  const long long vbase = b * a.vs[0] + hk * a.vs[1];

  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < a.sq) x = load(a.q, qbase + (q0 + r) * a.qs[2] + c * a.qs[3], a.q_bf16);
    q_s[i] = __fmul_rn(x, a.scale);   // q * scale before the product, as the TPU kernel
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Row row[RPW];
  bool valid[RPW];
  float m[RPW], l[RPW], corr[RPW], acc[RPW][CPL];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int i = q0 + warp * RPW + j;
    valid[j] = i < a.sq;
    row[j] = row_of(i, a);
    m[j] = NEG_BIG;
    l[j] = 0.f;
    corr[j] = 1.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[j][e] = 0.f;
  }

  for (int kb0 = 0; kb0 < a.kv_len; kb0 += a.block_kv) {
    bool run[RPW];
    int any = 0;
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      run[j] = valid[j] && row_runs(row[j], kb0, a);
      any |= run[j];
    }
    if (!__syncthreads_or(any)) continue;   // no row of the tile sees this block
    const int nk = min(kb0 + a.block_kv, a.kv_len) - kb0;

    // scores of the block, masked at NEG_BIG, into s_s
    for (int t0 = 0; t0 < nk; t0 += TK) {
      const int nt = min(TK, nk - t0);
      __syncthreads();
      for (int i = threadIdx.x; i < TK * D; i += blockDim.x) {
        const int t = i / D, c = i % D;
        kv_s[t * DP + c] = t < nt ? load(a.k, kbase + (long long)(kb0 + t0 + t) * a.ks[2] +
                                                  c * a.ks[3], 0)
                                  : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        if (!run[j]) continue;
        const float* qr = q_s + (warp * RPW + j) * D;
        float* sr = s_s + (warp * RPW + j) * a.block_kv;
        for (int t = lane; t < nt; t += 32) {
          const float* kr = kv_s + t * DP;
          float dot = 0.f;
#pragma unroll 16
          for (int c = 0; c < D; ++c) dot = fmaf(qr[c], kr[c], dot);
          const int col = kb0 + t0 + t;
          sr[t0 + t] = key_masked(col, row[j].pos, a) ? NEG_BIG : dot;
        }
      }
    }
    __syncwarp();

    // each warp: the max, the exp and the sum of its rows
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      if (!run[j]) continue;
      float* sr = s_s + (warp * RPW + j) * a.block_kv;
      float mx = NEG_BIG;
      for (int t = lane; t < nk; t += 32) mx = fmaxf(mx, sr[t]);
      const float m_new = fmaxf(m[j], npe_warp_max(mx));
      corr[j] = attn_exp(__fsub_rn(m[j], m_new), a, etab);
      float sum = 0.f;
      for (int t = lane; t < nk; t += 32) {
        const float p = key_masked(kb0 + t, row[j].pos, a)
                            ? 0.f : attn_exp(__fsub_rn(sr[t], m_new), a, etab);
        sr[t] = p;
        sum = __fadd_rn(sum, p);
      }
      l[j] = __fadd_rn(__fmul_rn(corr[j], l[j]), npe_warp_sum(sum));
      m[j] = m_new;
    }

    // P.V for the block, then acc = corr * acc + P.V
    float pv[RPW][CPL];
#pragma unroll
    for (int j = 0; j < RPW; ++j)
#pragma unroll
      for (int e = 0; e < CPL; ++e) pv[j][e] = 0.f;
    for (int t0 = 0; t0 < nk; t0 += TK) {
      const int nt = min(TK, nk - t0);
      __syncthreads();
      for (int i = threadIdx.x; i < TK * D; i += blockDim.x) {
        const int t = i / D, c = i % D;
        kv_s[t * DP + c] = t < nt ? load(a.v, vbase + (long long)(kb0 + t0 + t) * a.vs[2] +
                                                  c * a.vs[3], 0)
                                  : 0.f;
      }
      __syncthreads();
      for (int t = 0; t < nt; ++t) {
        const float* vr = kv_s + t * DP;
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          if (!run[j]) continue;
          const float p = s_s[(warp * RPW + j) * a.block_kv + t0 + t];
#pragma unroll
          for (int e = 0; e < CPL; ++e) pv[j][e] = fmaf(p, vr[lane + 32 * e], pv[j][e]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      if (!run[j]) continue;
#pragma unroll
      for (int e = 0; e < CPL; ++e)
        acc[j][e] = __fadd_rn(__fmul_rn(corr[j], acc[j][e]), pv[j][e]);
    }
  }

  // out = acc / max(l, 1e-30)
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    if (!valid[j]) continue;
    const float inv = attn_recip(l[j], a, rtab);
    const int i = q0 + warp * RPW + j;
    const long long obase = b * a.os[0] + h * a.os[1] + i * a.os[2];
#pragma unroll
    for (int e = 0; e < CPL; ++e)
      store(a, obase + (lane + 32 * e) * a.os[3], __fmul_rn(acc[j][e], inv));
  }
}

// ---------------------------------------------------------------------------
// bf16 K/V, at most DEC_ROWS query rows a kv head: decode
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_ROWS = 8;

template <int D, int ROWS>
__global__ void __launch_bounds__(DEC_THREADS, 1)
flash_decode_kernel(const Args a) {
  constexpr int LPK = D / 8;               // lanes a key row, 8 bf16 a lane
  constexpr int KPI = DEC_THREADS / LPK;   // keys a pass of the block
  constexpr int U = ROWS > 1 ? 2 : (D == 32 ? 4 : 8);  // 16-byte loads in flight a thread
  constexpr int CH = KPI * U;              // keys a chunk
  extern __shared__ float smem[];          // ROWS x block_kv scores; at the end the partials
  __shared__ float red[ROWS][DEC_WARPS];
  __shared__ float inv_s[ROWS];
  __shared__ float etab[3 * NPE_MAX_TABLE_COLS];
  __shared__ float rtab[3 * NPE_MAX_TABLE_COLS];
  load_tables(a, etab, rtab);

  const int b = blockIdx.x / a.hkv, hk = blockIdx.x % a.hkv;
  const int group = a.hq / a.hkv;
  const int nrows = group * a.sq;          // row r: q head hk*group + r / sq, query r % sq
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = tid % LPK, slot = tid / LPK;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] +
                            hk * a.ks[1] + sub * 8;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] +
                            hk * a.vs[1] + sub * 8;

  Row row[ROWS];
  float qv[ROWS][8], m[ROWS], l[ROWS], acc[ROWS][8];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = r < nrows ? r % a.sq : 0, h = hk * group + (r < nrows ? r / a.sq : 0);
    row[r] = row_of(i, a);
    const long long qb = b * a.qs[0] + h * a.qs[1] + i * a.qs[2];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      // q * scale before the product, as the TPU kernel
      qv[r][c] = r < nrows ? __fmul_rn(load(a.q, qb + (sub * 8 + c) * a.qs[3], a.q_bf16), a.scale)
                           : 0.f;
      acc[r][c] = 0.f;
    }
    m[r] = NEG_BIG;
    l[r] = 0.f;
  }

  auto load_chunk = [&](uint4 (&w)[U], const __nv_bfloat16* base, long long stride, int kb0,
                        int t0, int nk) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * KPI + slot;
      w[u] = t < nk ? __ldg(reinterpret_cast<const uint4*>(base + (long long)(kb0 + t) * stride))
                    : make_uint4(0, 0, 0, 0);
    }
  };

  for (int kb0 = 0; kb0 < a.kv_len; kb0 += a.block_kv) {
    bool run[ROWS];
    bool any = false;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      run[r] = r < nrows && row_runs(row[r], kb0, a);
      any = any || run[r];
    }
    if (!any) continue;                    // the same for every thread
    const int nk = min(kb0 + a.block_kv, a.kv_len) - kb0;
    __syncthreads();                       // the last block's readers of smem are done

    // scores, masked at NEG_BIG, into smem; each thread's max
    float mx[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) mx[r] = NEG_BIG;
    uint4 w[U];
    for (int t0 = 0; t0 < nk; t0 += CH) {
      load_chunk(w, kp, a.ks[2], kb0, t0, nk);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * KPI + slot;
        float kf[8];
        unpack8(w[u], kf);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) dot = fmaf(qv[r][c], kf[c], dot);
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (t < nk) {
            const float s = (!run[r] || key_masked(kb0 + t, row[r].pos, a)) ? NEG_BIG : dot;
            if (sub == 0) smem[r * a.block_kv + t] = s;
            mx[r] = fmaxf(mx[r], s);
          }
        }
      }
    }
    load_chunk(w, vp, a.vs[2], kb0, 0, nk);   // V of the first chunk, in flight over the softmax
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      mx[r] = npe_warp_max(mx[r]);
      if (lane == 0) red[r][warp] = mx[r];
    }
    __syncthreads();
    float m_new[ROWS], corr[ROWS], ps[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float bm = red[r][0];
#pragma unroll
      for (int j = 1; j < DEC_WARPS; ++j) bm = fmaxf(bm, red[r][j]);
      m_new[r] = fmaxf(m[r], bm);
      corr[r] = run[r] ? attn_exp(__fsub_rn(m[r], m_new[r]), a, etab) : 1.f;
      ps[r] = 0.f;
    }
    // p = exp(s - m_new), masked to 0, in place; each thread's sums
    for (int t = tid; t < nk; t += DEC_THREADS) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (!run[r]) continue;
        float* s = smem + r * a.block_kv + t;
        const float p = key_masked(kb0 + t, row[r].pos, a)
                            ? 0.f : attn_exp(__fsub_rn(*s, m_new[r]), a, etab);
        *s = p;
        ps[r] = __fadd_rn(ps[r], p);
      }
    }
    __syncthreads();                       // every thread has read the maxima
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      ps[r] = npe_warp_sum(ps[r]);
      if (lane == 0) red[r][warp] = ps[r];
    }
    __syncthreads();                       // p and the sums are in smem
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (!run[r]) continue;
      float bs = red[r][0];
#pragma unroll
      for (int j = 1; j < DEC_WARPS; ++j) bs = __fadd_rn(bs, red[r][j]);
      l[r] = __fadd_rn(__fmul_rn(corr[r], l[r]), bs);
      m[r] = m_new[r];
    }

    // P.V of this thread's keys into acc_t = corr * acc_t + p . v
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (!run[r]) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = __fmul_rn(corr[r], acc[r][c]);
    }
    for (int t0 = 0; t0 < nk; t0 += CH) {
      if (t0 > 0) load_chunk(w, vp, a.vs[2], kb0, t0, nk);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * KPI + slot;
        if (t >= nk) continue;
        float vf[8];
        unpack8(w[u], vf);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (!run[r]) continue;
          const float p = smem[r * a.block_kv + t];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(p, vf[c], acc[r][c]);
        }
      }
    }
  }

  // sum the partial accumulators: over the lanes of a warp that share `sub`,
  // then across warps in smem
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        acc[r][c] = __fadd_rn(acc[r][c], __shfl_xor_sync(0xffffffffu, acc[r][c], o));
  __syncthreads();                         // smem's scores are read
  if (lane < LPK) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) smem[(warp * ROWS + r) * D + sub * 8 + c] = acc[r][c];
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (tid == r) inv_s[r] = attn_recip(l[r], a, rtab);
  __syncthreads();
  for (int idx = tid; idx < nrows * D; idx += DEC_THREADS) {
    const int r = idx / D, c = idx % D;
    float s = smem[r * D + c];
#pragma unroll
    for (int j = 1; j < DEC_WARPS; ++j) s = __fadd_rn(s, smem[(j * ROWS + r) * D + c]);
    const int i = r % a.sq, h = hk * group + r / a.sq;
    store(a, b * a.os[0] + h * a.os[1] + i * a.os[2] + c * a.os[3], __fmul_rn(s, inv_s[r]));
  }
}

// ---------------------------------------------------------------------------
// bf16 K/V, 16-row query tiles on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 8;
constexpr int KC = 16 * MMA_WARPS;       // keys a staged chunk, 16 a warp
constexpr int RING = 4;                  // stages of the K/V ring

template <int D>
struct MmaLayout {
  static constexpr int DS = D + 8;       // bf16 a smem row: 16 bytes of padding
  static constexpr int RING_ELEMS = RING * KC * DS;
  static constexpr int QP = Q_PIECES_MAX * 16 * DS;
  static size_t bytes(int block_kv) {    // ring, q pieces, scores in fragment order
    const int chunks = (block_kv + KC - 1) / KC;
    return sizeof(__nv_bfloat16) * (RING_ELEMS + QP) + sizeof(float) * MMA_WARPS * chunks * 32 * 8;
  }
};

template <int D>
__global__ void __launch_bounds__(32 * MMA_WARPS)
flash_mma_kernel(const Args a) {
  using L = MmaLayout<D>;
  constexpr int DS = L::DS;
  constexpr int NT = D / 8;              // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qp = ring + L::RING_ELEMS;
  float* s_s = reinterpret_cast<float*>(qp + L::QP);
  __shared__ float red[MMA_WARPS][16];
  __shared__ float inv_s[16];
  __shared__ float etab[3 * NPE_MAX_TABLE_COLS];
  __shared__ float rtab[3 * NPE_MAX_TABLE_COLS];
  load_tables(a, etab, rtab);

  const int bh = blockIdx.y;
  const int b = bh / a.hq, h = bh % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = blockIdx.x * 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + hk * a.vs[1];

  // q * scale in f32, as the reference, split into bf16 pieces; staged once
  // the first K/V copies are in flight
  const long long qbase = b * a.qs[0] + h * a.qs[1];
  auto stage_q = [&]() {
    for (int idx = tid; idx < 16 * D; idx += blockDim.x) {
      const int r = idx / D, c = idx % D;
      float x = 0.f;
      if (q0 + r < a.sq)
        x = __fmul_rn(load(a.q, qbase + (q0 + r) * a.qs[2] + c * a.qs[3], a.q_bf16), a.scale);
      float p[3];
      npe_split3(x, p);
#pragma unroll
      for (int j = 0; j < Q_PIECES_MAX; ++j) qp[(j * 16 + r) * DS + c] = __float2bfloat16_rn(p[j]);
    }
    __syncthreads();                       // q pieces and tables in smem
  };
  bool q_staged = false;

  // this lane's rows of the tile: g and g + 8
  Row row[2];
  bool valid[2];
  float m[2], lw[2], acc[NT][4];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = q0 + g + 8 * e;
    valid[e] = i < a.sq;
    row[e] = row_of(i, a);
    m[e] = NEG_BIG;
    lw[e] = 0.f;                           // this warp's part of l
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kb0 = 0; kb0 < a.kv_len; kb0 += a.block_kv) {
    const int kb_end = min(kb0 + a.block_kv, a.kv_len);
    // which rows run, and the keys that some running row of the tile sees
    int lo = kb_end, hi = kb0 - 1;
    bool any = false;
    for (int r = 0; r < 16 && q0 + r < a.sq; ++r) {
      const Row rr = row_of(q0 + r, a);
      if (!row_runs(rr, kb0, a)) continue;
      any = true;
      lo = min(lo, a.window > 0 ? max(kb0, rr.pos - a.window + 1) : kb0);
      hi = max(hi, a.causal ? min(rr.pos, kb_end - 1) : kb_end - 1);
    }
    if (!any) continue;                    // the same for every thread
    bool run[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) run[e] = valid[e] && row_runs(row[e], kb0, a);
    const int c_lo = (lo - kb0) / KC;
    const int nc = hi >= lo ? (hi - kb0) / KC - c_lo + 1 : 0;   // chunks of keys to visit

    // items 0..nc-1 stage K chunks, nc..2nc-1 V chunks, through the ring
    // (RING - 1 of them in flight)
    auto issue = [&](int it) {
      const bool is_k = it < nc;
      const __nv_bfloat16* src = is_k ? kg : vg;
      const long long stride = is_k ? a.ks[2] : a.vs[2];
      const int key0 = kb0 + (c_lo + (is_k ? it : it - nc)) * KC;
      __nv_bfloat16* dst = ring + (it % RING) * KC * DS;
      for (int x = tid; x < KC * (D / 8); x += blockDim.x) {
        const int kr = x / (D / 8), piece = x % (D / 8);
        const int key = key0 + kr;
        const bool ok = key < kb_end;      // never past kv_len
        npe_cp_async16(dst + kr * DS + piece * 8, ok ? src + key * stride + piece * 8 : src,
                       ok ? 16 : 0);
      }
    };

    float mloc[2] = {NEG_BIG, NEG_BIG}, psum[2] = {0.f, 0.f}, m_new[2], corr[2];
    auto rescale = [&](float bm0, float bm1) {
      const float bm[2] = {bm0, bm1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        m_new[e] = fmaxf(m[e], bm[e]);
        corr[e] = run[e] ? attn_exp(__fsub_rn(m[e], m_new[e]), a, etab) : 1.f;
        lw[e] = __fmul_rn(corr[e], lw[e]);
        if (run[e]) m[e] = m_new[e];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = __fmul_rn(corr[e >> 1], acc[n][e]);
    };
    const int items = 2 * nc;
#pragma unroll
    for (int it = 0; it < RING - 1; ++it) {
      if (it < items) issue(it);
      npe_cp_async_commit();
    }
    if (!q_staged) {
      stage_q();
      q_staged = true;
    }
    if (nc == 0) rescale(NEG_BIG, NEG_BIG);   // every key of the block masked
    for (int it = 0; it < items; ++it) {
      npe_cp_async_wait<RING - 2>();
      __syncthreads();        // item `it` staged; every warp is done with item it-1's stage
      if (it + RING - 1 < items) issue(it + RING - 1);
      npe_cp_async_commit();
      const __nv_bfloat16* tile = ring + (it % RING) * KC * DS;
      const int j = it < nc ? it : it - nc;
      const int kc = kb0 + (c_lo + j) * KC + warp * 16;   // this warp's first key
      float* sfrag = s_s + ((warp * ((a.block_kv + KC - 1) / KC) + j) * 32 + lane) * 8;
      if (it < nc) {
        // S = (q*scale) . K^T over this warp's 16 keys
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t bk[4];
          npe_ldsm_x4(bk, tile + (warp * 16 + (lane & 7) + ((lane >> 4) << 3)) * DS + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          for (int pc = 0; pc < a.q_pieces; ++pc) {
            uint32_t aq[4];
            npe_ldsm_x4(aq, qp + (pc * 16 + (lane & 15)) * DS + kk * 16 + (lane >> 4) * 8);
            npe_mma_bf16(s[0], aq, bk[0], bk[1]);
            npe_mma_bf16(s[1], aq, bk[2], bk[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, col = kc + n * 8 + 2 * t4 + (e & 1);
            const bool msk = !run[r] || col >= kb_end || key_masked(col, row[r].pos, a);
            s[n][e] = msk ? NEG_BIG : s[n][e];
            mloc[r] = fmaxf(mloc[r], s[n][e]);
          }
        reinterpret_cast<float4*>(sfrag)[0] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
        reinterpret_cast<float4*>(sfrag)[1] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
        if (it == nc - 1) {                // the block's row max: over the quad, then the warps
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            mloc[e] = fmaxf(mloc[e], __shfl_xor_sync(0xffffffffu, mloc[e], 1));
            mloc[e] = fmaxf(mloc[e], __shfl_xor_sync(0xffffffffu, mloc[e], 2));
          }
          if (t4 == 0) {
            red[warp][g] = mloc[0];
            red[warp][g + 8] = mloc[1];
          }
        }
      } else {
        if (it == nc) {                    // red is complete: the sync above
          float bm0 = red[0][g], bm1 = red[0][g + 8];
#pragma unroll
          for (int w = 1; w < MMA_WARPS; ++w) {
            bm0 = fmaxf(bm0, red[w][g]);
            bm1 = fmaxf(bm1, red[w][g + 8]);
          }
          rescale(bm0, bm1);
        }
        // p = exp(s - m_new), masked to 0, split into three bf16 pieces: the A
        // operand of P.V straight from the accumulator layout
        const float4 f0 = reinterpret_cast<const float4*>(sfrag)[0];
        const float4 f1 = reinterpret_cast<const float4*>(sfrag)[1];
        float z[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
        for (int x = 0; x < 8; ++x) z[x] = __fsub_rn(z[x], m_new[(x >> 1) & 1]);
        attn_exp8(z, a, etab);
        float pp[3][2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, col = kc + n * 8 + 2 * t4 + (e & 1);
            const bool msk = !run[r] || col >= kb_end || key_masked(col, row[r].pos, a);
            const float p = msk ? 0.f : z[4 * n + e];
            psum[r] = __fadd_rn(psum[r], p);
            float pc[3];
            npe_split3(p, pc);
#pragma unroll
            for (int q = 0; q < 3; ++q) pp[q][n][e] = pc[q];
          }
        uint32_t ap[3][4];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          ap[q][0] = npe_pack_bf16(pp[q][0][0], pp[q][0][1]);
          ap[q][1] = npe_pack_bf16(pp[q][0][2], pp[q][0][3]);
          ap[q][2] = npe_pack_bf16(pp[q][1][0], pp[q][1][1]);
          ap[q][3] = npe_pack_bf16(pp[q][1][2], pp[q][1][3]);
        }
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t bv[4];
          npe_ldsm_x4_trans(bv, tile + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DS +
                                    dd * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            npe_mma_bf16(acc[2 * dd], ap[q], bv[0], bv[1]);
            npe_mma_bf16(acc[2 * dd + 1], ap[q], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();          // the ring is free for the next block
    // l_w = corr * l_w + this warp's sum of p
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      psum[e] = __fadd_rn(psum[e], __shfl_xor_sync(0xffffffffu, psum[e], 1));
      psum[e] = __fadd_rn(psum[e], __shfl_xor_sync(0xffffffffu, psum[e], 2));
      if (run[e]) lw[e] = __fadd_rn(lw[e], psum[e]);
    }
  }

  // acc = the warps' partial accumulators summed, l likewise; out = acc / l
  __syncthreads();
  float* comb = reinterpret_cast<float*>(smem_raw);   // MMA_WARPS x 16 x D, over the ring
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      comb[(warp * 16 + g + 8 * (e >> 1)) * D + n * 8 + 2 * t4 + (e & 1)] = acc[n][e];
  if (t4 == 0) {
    red[warp][g] = lw[0];
    red[warp][g + 8] = lw[1];
  }
  __syncthreads();
  if (tid < 16) {
    float l = red[0][tid];
#pragma unroll
    for (int w = 1; w < MMA_WARPS; ++w) l = __fadd_rn(l, red[w][tid]);
    inv_s[tid] = attn_recip(l, a, rtab);
  }
  __syncthreads();
  const long long obase = b * a.os[0] + h * a.os[1];
  for (int idx = tid; idx < 16 * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D;
    if (q0 + r >= a.sq) continue;
    float s = comb[r * D + c];
#pragma unroll
    for (int w = 1; w < MMA_WARPS; ++w) s = __fadd_rn(s, comb[(w * 16 + r) * D + c]);
    store(a, obase + (q0 + r) * a.os[2] + c * a.os[3], __fmul_rn(s, inv_s[r]));
  }
}


// ---------------------------------------------------------------------------
// the dense mode: one softmax over every visible key (attention_scores)
// ---------------------------------------------------------------------------

// exp of N values z = s - m: the NVU's (npe_softmax_exp_n) or expf.
template <int N>
__device__ __forceinline__ void dense_exp_n(float (&z)[N], const Args& a,
                                            const NpePrefixTable& t, int top) {
  if (a.use_pwl) {
    npe_softmax_exp_n<N>(z, t, top);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) z[i] = expf(z[i]);
  }
}

// What normalizes a row with sum l: its PWL reciprocal (NPE), or l, which p
// divides by (exact; l >= 1 for any row that sees a key, the clamp only keeps
// a row that sees none finite).
__device__ __forceinline__ float dense_norm(float l, const Args& a, const NpePrefixTable& rt,
                                            int rtop) {
  return a.use_pwl ? npe_softmax_inv(l, rt, rtop) : fmaxf(l, 1e-30f);
}

// The soft cap of N scores in place: c * tanh(s / c), tanh the PWL table
// (clamped to its end knots, as nvu_tanh) or tanhf; nothing when c = 0.
template <int N>
__device__ __forceinline__ void dense_cap_n(float (&s)[N], const Args& a,
                                            const NpePrefixTable& t, int top) {
  if (a.softcap <= 0.f) return;
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = __fdiv_rn(s[i], a.softcap);
  if (a.use_pwl) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = fminf(fmaxf(s[i], a.tanh_lo), a.tanh_hi);
    npe_pwl_prefix_n<N>(s, t, top);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = tanhf(s[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = __fmul_rn(a.softcap, s[i]);
}

// The tanh table's prefix form, when the soft cap takes it; every thread
// of the block calls it.
__device__ __forceinline__ void dense_cap_table(NpePrefixTable& t, const Args& a) {
  if (a.softcap > 0.f && a.use_pwl) {
    const NpePrefixFetch f(a.tanh_table, a.tanh_segs);
    npe_build_prefix_table(t, f, a.tanh_segs);
  }
}

// The first key some row of a block sees, its first row at position pos0.
__device__ __forceinline__ int dense_kv_lo(int pos0, const Args& a) {
  return a.window > 0 ? max(0, pos0 - a.window + 1) : 0;
}

// p = e * (1/l) or e / l, rounded to bf16 (returned as the exact f32 value).
__device__ __forceinline__ float dense_p(float e, float norm, const Args& a) {
  const float p = a.use_pwl ? __fmul_rn(e, norm) : __fdiv_rn(e, norm);
  return __bfloat162float(__float2bfloat16_rn(p));
}

// ---------------------------------------------------------------------------
// the dense mode's decode instance: a (batch, kv head) split across a cluster
// ---------------------------------------------------------------------------

constexpr int SPL_THREADS = 128;                 // four warps
constexpr int SPL_WARPS = SPL_THREADS / 32;
constexpr int SPL_CK = 16 * SPL_WARPS;           // keys a staged chunk, 16 a warp
constexpr int SPL_RING = 4;                      // stages of the K/V ring
constexpr int SPL_SCORES = 8192;                 // scores (rows x keys) a block keeps at once
constexpr int SPL_MAX_CLUSTER = 8;               // the portable cluster size

// A staged K or V row: D bf16 and 16 bytes of padding, so that the eight
// rows one ldmatrix reads at one column fall in eight distinct bank groups.
template <int D>
__host__ __device__ constexpr int spl_row_bytes() { return 2 * D + 16; }
template <int D>
__host__ __device__ constexpr int spl_stage_bytes() { return SPL_CK * spl_row_bytes<D>(); }

// Dynamic shared memory of a block: the ring, then a segment's f32 scores
// (RI x seg) and its bf16 probabilities (RI rows of seg + 8, so that the
// eight rows of a B fragment fall in distinct banks).  The P.V partials of
// the warps and the block's sum reuse the ring at the end.
template <int D, int RI>
size_t spl_smem(int seg) {
  return (size_t)SPL_RING * spl_stage_bytes<D>() + (size_t)RI * seg * 4 +
         (size_t)RI * (seg + 8) * 2;
}

// At most 8 rows a kv head (RI of them: the rows rounded up to 1, 2, 4 or
// 8), no statistics.  The CS blocks of a cluster take one (batch, kv head)
// (blockIdx.y), block `rank` a contiguous range of the visible keys in whole
// SPL_CK-key chunks.  A block's chunks, K's and then V's, stream through one
// SPL_RING-stage cp.async ring (three chunks in flight) from the kernel's
// first instruction, so that V's first chunks arrive while the scores are
// reduced.  The scores are computed once on the tensor cores (mma m16n8k16:
// 16 keys of a warp on M, the rows on N = 8, q's bf16 pieces as B fragments
// from shared memory) and kept in shared memory; a score is owned by one
// thread, which applies the scale, the soft cap and the mask once.  The
// softmax is the reference's function in three stages, each finished by an
// exchange across the cluster: the rows' max; e = exp(s - m) and the rows'
// sum; p^ = bf16(e * norm), then P.V on the tensor cores (V^T by
// ldmatrix.trans on M, p^ on N), the warps' partials summed in warp order.
// Each exchange writes a block's values into every block's shared memory
// (its slot, the block's rank), then one cluster barrier, then each block
// reads its own slots in rank order: the same sums in every block, no remote
// read, no atomics.  The output's rows are shared out, rank c summing its
// share of every block's partial.  A block whose keys' scores do not fit
// SPL_SCORES takes them in segments: K is read again in the second stage and
// the third, which recompute the segment's scores.
template <int D, int RI>
__global__ void __launch_bounds__(SPL_THREADS, 3)
flash_dense_split_kernel(const Args a) {
  namespace cg = cooperative_groups;
  constexpr int RB = spl_row_bytes<D>();
  constexpr int QB = D + 8;                      // a staged q row, in bf16 (distinct banks)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  float* sc = reinterpret_cast<float*>(smem_raw + SPL_RING * spl_stage_bytes<D>());
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(sc + RI * a.seg);
  const int pst = a.seg + 8;                     // p's row stride, in values
  __shared__ __align__(16) __nv_bfloat16 qsm[Q_PIECES_MAX][8][QB];   // q's pieces, 8 rows
  __shared__ NpePrefixTable etab, rtab, ttab;
  __shared__ float red[RI][SPL_WARPS];
  __shared__ float xmax[SPL_MAX_CLUSTER][RI], xsum[SPL_MAX_CLUSTER][RI];   // a slot a block
  __shared__ float xout[RI * D + SPL_MAX_CLUSTER];                        // the output's share
  __shared__ float mrow[RI], nrow[RI];           // the cluster's max and norm
  const NpePrefixFetch efetch(a.exp_table, a.exp_segs), rfetch(a.recip_table, a.recip_segs);

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = a.split, rank = (int)cluster.block_rank();
  if (cs > 1) npe_cluster_arrive_relaxed();      // this block runs (waited before the first push)
  // the cluster's barrier; a cluster of one block needs only the block's
  auto cluster_sync = [&]() {
    if (cs > 1) {
      npe_cluster_arrive();
      npe_cluster_wait();
    } else {
      __syncthreads();
    }
  };
  const int b = blockIdx.y / a.hkv, hk = blockIdx.y % a.hkv;
  const int group = a.hq / a.hkv;
  const int nrows = group * a.sq;                // row r: q head hk*group + r / sq, query r % sq
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + hk * a.vs[1];

  // this block's keys: whole chunks of the visible range kv_lo..kv_len-1,
  // nch chunks in segments of sch
  const int kv_lo = dense_kv_lo(a.kv_len - a.sq, a);
  const int chunks = (a.kv_len - kv_lo + SPL_CK - 1) / SPL_CK;
  const int s_lo = min(a.kv_len, kv_lo + chunks * rank / cs * SPL_CK);
  const int s_hi = min(a.kv_len, kv_lo + chunks * (rank + 1) / cs * SPL_CK);
  const int nch = (s_hi - s_lo + SPL_CK - 1) / SPL_CK, sch = a.seg / SPL_CK;
  const int nseg = max(1, (nch + sch - 1) / sch);
  // the chunks in the order they are used: one segment, K then V; else K
  // (stage 1), K (stage 2), then each segment's K and V (stage 3)
  const int njobs = nseg == 1 ? 2 * nch : 4 * nch;
  auto job = [&](int i, bool& is_v) {
    if (nseg == 1) {
      is_v = i >= nch;
      return is_v ? i - nch : i;
    }
    if (i < 2 * nch) {
      is_v = false;
      return i % nch;
    }
    const int j = i - 2 * nch, s = j / (2 * sch), r = j - s * 2 * sch;
    const int cnt = min(sch, nch - s * sch);
    is_v = r >= cnt;
    return s * sch + (is_v ? r - cnt : r);
  };
  // cp.async of job i's chunk into its stage, zeros at and past s_hi; then
  // its group (empty past the last job)
  auto fetch = [&](int i) {
    if (i < njobs) {
      bool is_v;
      const int k0 = s_lo + job(i, is_v) * SPL_CK;
      const __nv_bfloat16* src = is_v ? vp : kp;
      const long long stride = is_v ? a.vs[2] : a.ks[2];
      unsigned char* dst = ring + (i % SPL_RING) * spl_stage_bytes<D>();
#pragma unroll
      for (int j = 0; j < SPL_CK * (D / 8) / SPL_THREADS; ++j) {
        const int x = tid + j * SPL_THREADS, r = x / (D / 8), c = x % (D / 8);
        const bool ok = k0 + r < s_hi;
        npe_cp_async16(dst + r * RB + c * 16,
                       ok ? src + (long long)(k0 + r) * stride + c * 8 : src, ok ? 16 : 0);
      }
    }
    npe_cp_async_commit();
  };
  int cursor = 0;
  // the next job's stage, once it has arrived and every thread is done with
  // the stage the next fetch refills
  auto next = [&]() {
    npe_cp_async_wait<SPL_RING - 2>();
    __syncthreads();
    fetch(cursor + SPL_RING - 1);
    return ring + (cursor++ % SPL_RING) * spl_stage_bytes<D>();
  };
  // q's values, loaded ahead of the ring's first chunks, which they would
  // otherwise queue behind
  constexpr int QN = 8 * D / SPL_THREADS;
  float qv[QN];
#pragma unroll
  for (int j = 0; j < QN; ++j) {
    const int x = tid + j * SPL_THREADS, r = x / D, d = x % D;
    const bool real = r < RI && r < nrows;
    const int i = real ? r % a.sq : 0, h = hk * group + (real ? r / a.sq : 0);
    qv[j] = real ? load(a.q, b * a.qs[0] + h * a.qs[1] + i * a.qs[2] + d * a.qs[3], a.q_bf16)
                 : 0.f;
  }
#pragma unroll
  for (int i = 0; i < SPL_RING - 1; ++i) fetch(i);   // in flight during the set-up

  // positions: pos[r] of each row (-1: a padding row), prow[e] of the rows
  // 2 t4 + e whose scores this thread owns
  int pos[RI], prow[2];
#pragma unroll
  for (int r = 0; r < RI; ++r) pos[r] = r < nrows ? a.kv_len - a.sq + r % a.sq : -1;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 2 * t4 + e;
    prow[e] = r < nrows ? a.kv_len - a.sq + r % a.sq : -1;
  }
  // q's bf16 pieces (npe_split3; one for bf16 q), 8 rows, zeros past the
  // rows
#pragma unroll
  for (int j = 0; j < QN; ++j) {
    const int x = tid + j * SPL_THREADS;
    float p[3];
    npe_split3(qv[j], p);
#pragma unroll
    for (int pc = 0; pc < Q_PIECES_MAX; ++pc) qsm[pc][x / D][x % D] = __float2bfloat16_rn(p[pc]);
  }
  npe_build_prefix_tables(etab, efetch, a.exp_segs, rtab, rfetch, a.recip_segs);   // syncs
  dense_cap_table(ttab, a);
  const int top = npe_prefix_top(a.exp_segs), rtop = npe_prefix_top(a.recip_segs);
  const int ttop = npe_prefix_top(a.tanh_segs);

  // the scores of the chunk at key k0 (stage st): (q . k) * scale, capped,
  // NEG_BIG where masked; into sc (keys from seg0) when `keep`; each
  // thread's max of its two rows into mx
  auto scores = [&](const unsigned char* st, int k0, int seg0, bool keep, float (&mx)[2]) {
    const unsigned char* kt = st + 16 * warp * RB;
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(&qsm[0][g][0]) + t4;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t af[4];
      npe_ldsm_x4(af, kt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RB +
                          (ks * 16 + 8 * (lane >> 4)) * 2);
      npe_mma_bf16(c, af, qw[ks * 8], qw[ks * 8 + 4]);
      if (a.q_pieces > 1) {
#pragma unroll
        for (int pc = 1; pc < Q_PIECES_MAX; ++pc)
          npe_mma_bf16(c, af, qw[pc * 4 * QB + ks * 8], qw[pc * 4 * QB + ks * 8 + 4]);
      }
    }
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = __fmul_rn(c[e], a.scale);
    dense_cap_n<4>(s, a, ttab, ttop);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 16 * warp + g + 8 * (e >> 1), r = 2 * t4 + (e & 1);
      if (r < RI && key < s_hi) {
        const float v = key_masked(key, prow[e & 1], a) ? NEG_BIG : s[e];
        if (keep) sc[r * a.seg + key - seg0] = v;
        mx[e & 1] = fmaxf(mx[e & 1], v);
      }
    }
  };
  // keys 0..nk-1 of sc (from key s0), scores to e in place, each row's sum
  // into part
  auto exps = [&](int s0, int nk, const float (&m)[RI], float (&part)[RI]) {
    for (int t = tid; t < nk; t += SPL_THREADS) {
      float z[RI];
#pragma unroll
      for (int r = 0; r < RI; ++r) z[r] = __fsub_rn(sc[r * a.seg + t], m[r]);
      dense_exp_n<RI>(z, a, etab, top);
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        z[r] = key_masked(s0 + t, pos[r], a) ? 0.f : z[r];
        sc[r * a.seg + t] = z[r];
        part[r] = __fadd_rn(part[r], z[r]);
      }
    }
  };
  // e of keys 0..nk-1 of sc to p^ = bf16(e * norm) in pb, zeros up to the
  // chunk's end (its V rows are zeros, and 0 * 0 must not meet a NaN)
  auto probs = [&](int nk, const float (&norm)[RI]) {
    const int nk_up = (nk + SPL_CK - 1) / SPL_CK * SPL_CK;
    for (int t = tid; t < nk_up; t += SPL_THREADS)
#pragma unroll
      for (int r = 0; r < RI; ++r)
        pb[r * pst + t] =
            __float2bfloat16_rn(t < nk ? dense_p(sc[r * a.seg + t], norm[r], a) : 0.f);
  };
  // out^T (D x rows) += V^T . P^T over the chunk at key offset off of the
  // segment (stage st): a warp its 16 keys, V^T by ldmatrix.trans, p^ from
  // pb (rows past RI zero)
  float acc[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
  auto pv = [&](const unsigned char* st, int off) {
    const int kc = off + 16 * warp;
    uint32_t b0 = 0u, b1 = 0u;
    if (g < RI) {
      b0 = *reinterpret_cast<const uint32_t*>(pb + g * pst + kc + 2 * t4);
      b1 = *reinterpret_cast<const uint32_t*>(pb + g * pst + kc + 8 + 2 * t4);
    }
    const unsigned char* vt = st + (16 * warp + (lane & 7) + 8 * (lane >> 4)) * RB +
                              16 * ((lane >> 3) & 1);
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      uint32_t af[4];
      npe_ldsm_x4_trans(af, vt + mt * 32);
      npe_mma_bf16(acc[mt], af, b0, b1);
    }
  };

  // each row's max (or sum) over the block in warp order, written into
  // every block's slot `rank` of x; after the cluster's barrier, the slots
  // combined in rank order into out[].  v: for the max, the thread's rows
  // 2 t4 and 2 t4 + 1 (the scores it owns); for the sum, all RI rows.
  auto exchange = [&](const float* v, bool is_max, float (*x)[RI], float* out) {
    if (is_max) {
      float w[2] = {v[0], v[1]};
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) w[e] = fmaxf(w[e], __shfl_xor_sync(0xffffffffu, w[e], o));
      if (g == 0)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (2 * t4 + e < RI) red[2 * t4 + e][warp] = w[e];
    } else {
      // a transposed butterfly: at each of the first log2(RI) steps a lane
      // keeps half its rows and adds its partner's copy of them, then the
      // usual butterfly over the lanes that share a row; lane l ends with
      // the sum of row l >> (5 - log2(RI))
      constexpr int L = RI == 1 ? 0 : RI == 2 ? 1 : RI == 4 ? 2 : 3;
      float w[RI];
#pragma unroll
      for (int r = 0; r < RI; ++r) w[r] = v[r];
#pragma unroll
      for (int step = 0, n = RI; step < L; ++step, n >>= 1) {
        const int o = 16 >> step;
        const bool upper = lane & o;
#pragma unroll
        for (int j = 0; j < n / 2; ++j) {
          const float keep = upper ? w[n / 2 + j] : w[j], give = upper ? w[j] : w[n / 2 + j];
          w[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, give, o));
        }
      }
#pragma unroll
      for (int o = 16 >> L; o > 0; o >>= 1)
        w[0] = __fadd_rn(w[0], __shfl_xor_sync(0xffffffffu, w[0], o));
      if ((lane & ((32 >> L) - 1)) == 0) red[lane >> (5 - L)][warp] = w[0];
    }
    __syncthreads();
    if (tid < RI * cs) {
      const int r = tid % RI;
      float y = red[r][0];
#pragma unroll
      for (int j = 1; j < SPL_WARPS; ++j)
        y = is_max ? fmaxf(y, red[r][j]) : __fadd_rn(y, red[r][j]);
      *cluster.map_shared_rank(&x[rank][r], tid / RI) = y;
    }
    cluster_sync();                              // every block's slot is in
    if (tid < RI) {
      float y = x[0][tid];
      for (int c = 1; c < cs; ++c) y = is_max ? fmaxf(y, x[c][tid]) : __fadd_rn(y, x[c][tid]);
      out[tid] = y;
    }
    __syncthreads();
  };

  // stage 1: the max over every visible key
  float mx[2] = {NEG_BIG, NEG_BIG};
  for (int c = 0; c < nch; ++c) scores(next(), s_lo + c * SPL_CK, s_lo, nseg == 1, mx);
  if (cs > 1) npe_cluster_wait();                // every block runs: slots may be written
  exchange(mx, true, xmax, mrow);
  float m[RI], part[RI], norm[RI];
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    m[r] = mrow[r];
    part[r] = 0.f;
  }
  // stage 2: the sum with the max fixed
  for (int seg = 0; seg < nseg; ++seg) {
    const int s0 = s_lo + seg * a.seg, nk = min(a.seg, s_hi - s0);
    if (nseg > 1) {
      float unused[2] = {NEG_BIG, NEG_BIG};
      for (int c = 0; c < (nk + SPL_CK - 1) / SPL_CK; ++c)
        scores(next(), s0 + c * SPL_CK, s0, true, unused);
      __syncthreads();
    }
    exps(s0, nk, m, part);
    __syncthreads();
  }
  exchange(part, false, xsum, nrow);
#pragma unroll
  for (int r = 0; r < RI; ++r) norm[r] = dense_norm(nrow[r], a, rtab, rtop);
  // stage 3: P.V with the normalized, rounded p
  for (int seg = 0; seg < nseg; ++seg) {
    const int s0 = s_lo + seg * a.seg, nk = min(a.seg, s_hi - s0);
    const int n = (nk + SPL_CK - 1) / SPL_CK;
    if (nseg > 1) {
      float unused[2] = {NEG_BIG, NEG_BIG}, zero[RI];
#pragma unroll
      for (int r = 0; r < RI; ++r) zero[r] = 0.f;
      for (int c = 0; c < n; ++c) scores(next(), s0 + c * SPL_CK, s0, true, unused);
      __syncthreads();
      exps(s0, nk, m, zero);
      __syncthreads();
    }
    probs(nk, norm);
    for (int c = 0; c < n; ++c) pv(next(), c * SPL_CK);   // next() syncs: p^ is in pb
  }
  npe_cp_async_wait<0>();
  __syncthreads();                               // the ring is free

  // the output: the warps' partials (in the ring) summed in warp order; of
  // each rank's share of the rows' values, this block's sum written into
  // that rank's slot `rank`; after the barrier, rank c sums its share's
  // slots in rank order
  float* wpart = reinterpret_cast<float*>(ring);            // [warp][row][d]
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 2 * t4 + (e & 1), d = mt * 16 + g + 8 * (e >> 1);
      if (r < RI) wpart[(warp * RI + r) * D + d] = acc[mt][e];
    }
  __syncthreads();
  const int total = min(nrows, RI) * D, per = (total + cs - 1) / cs;
  for (int idx = tid; idx < total; idx += SPL_THREADS) {
    float y = wpart[idx];
#pragma unroll
    for (int j = 1; j < SPL_WARPS; ++j) y = __fadd_rn(y, wpart[j * RI * D + idx]);
    const int owner = idx / per;
    *cluster.map_shared_rank(&xout[rank * per + idx - owner * per], owner) = y;
  }
  cluster_sync();                                // every block's share is in; none is read again
  for (int j = tid; j < per && rank * per + j < total; j += SPL_THREADS) {
    float y = xout[j];
    for (int c = 1; c < cs; ++c) y = __fadd_rn(y, xout[c * per + j]);
    const int idx = rank * per + j, r = idx / D, d = idx % D, i = r % a.sq;
    const int h = hk * group + r / a.sq;
    store(a, b * a.os[0] + h * a.os[1] + i * a.os[2] + d * a.os[3], y);
  }
}

// ---------------------------------------------------------------------------
// the dense mode's tensor-core instance: a GQA group's rows in warpgroup tiles
// ---------------------------------------------------------------------------

constexpr int WRING = 4;                 // slots of the forward's K/V ring

// A MN-major (transposed) from shared memory.
template <int N>
__device__ __forceinline__ void wg_ss_ta(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 32) npe_wgmma_ss_ta_n32(d, da, db, scale_d);
  else npe_wgmma_ss_ta_n16(d, da, db, scale_d);
}

// The dense mode's steps of a score with PWL as a template argument, so
// that no score branches on it: exp of N values z = s - m; the soft cap
// (nothing when c = 0); p^; the norm of a row with sum l.
template <bool PWL, int N>
__device__ __forceinline__ void wg_exp(float (&z)[N], const NpePrefixTable& t, int top) {
  if constexpr (PWL) {
    npe_softmax_exp_n<N>(z, t, top);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) z[i] = expf(z[i]);
  }
}

template <bool PWL, int N>
__device__ __forceinline__ void wg_cap(float (&s)[N], const Args& a, const NpePrefixTable& t,
                                       int top) {
  if (a.softcap <= 0.f) return;
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = __fdiv_rn(s[i], a.softcap);
  if constexpr (PWL) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = fminf(fmaxf(s[i], a.tanh_lo), a.tanh_hi);
    npe_pwl_prefix_n<N>(s, t, top);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = tanhf(s[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = __fmul_rn(a.softcap, s[i]);
}

template <bool PWL>
__device__ __forceinline__ float wg_p(float e, float norm) {
  float p;
  if constexpr (PWL) p = __fmul_rn(e, norm);
  else p = __fdiv_rn(e, norm);
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <bool PWL>
__device__ __forceinline__ float wg_norm(float l, const NpePrefixTable& rt, int rtop) {
  if constexpr (PWL) return npe_softmax_inv(l, rt, rtop);
  else return fmaxf(l, 1e-30f);
}

// Whether key col is hidden from a row at position pos (-1: a padding row)
// of a block whose keys end at kv_hi, without branches.
__device__ __forceinline__ bool wg_hidden(int col, int pos, int kv_hi, const Args& a) {
  return (pos < 0) | (col >= kv_hi) | ((a.causal != 0) & (col > pos)) |
         ((a.window > 0) & (col <= pos - a.window));
}

// A block's output rows from shared memory (f32, `stride` floats a row;
// `parts` partial outputs `part_stride` floats apart, summed in order) to
// out, 16 bytes a store: row rho of `rows` is GroupRow `at(rho)`, or
// skipped when at(rho).head < 0.
template <int D, typename F>
__device__ __forceinline__ void wg_write_out(const Args& a, int b, const float* ost, int stride,
                                             int rows, F at, int parts = 1, int part_stride = 0) {
  for (int x = threadIdx.x; x < rows * (D / 8); x += blockDim.x) {
    const int rho = x / (D / 8), c = x % (D / 8);
    const GroupRow gr = at(rho);
    if (gr.head < 0) continue;
    const long long o = b * a.os[0] + gr.head * a.os[1] + gr.query * a.os[2] + 8 * c;
    float4 lo = *reinterpret_cast<const float4*>(ost + rho * stride + 8 * c);
    float4 hi = *reinterpret_cast<const float4*>(ost + rho * stride + 8 * c + 4);
    for (int k = 1; k < parts; ++k) {
      const float4 l2 = *reinterpret_cast<const float4*>(ost + k * part_stride + rho * stride + 8 * c);
      const float4 h2 = *reinterpret_cast<const float4*>(ost + k * part_stride + rho * stride + 8 * c + 4);
      lo = make_float4(__fadd_rn(lo.x, l2.x), __fadd_rn(lo.y, l2.y), __fadd_rn(lo.z, l2.z),
                       __fadd_rn(lo.w, l2.w));
      hi = make_float4(__fadd_rn(hi.x, h2.x), __fadd_rn(hi.y, h2.y), __fadd_rn(hi.z, h2.z),
                       __fadd_rn(hi.w, h2.w));
    }
    if (a.out_bf16) {
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.out) + o) =
          make_uint4(npe_pack_bf16(lo.x, lo.y), npe_pack_bf16(lo.z, lo.w),
                     npe_pack_bf16(hi.x, hi.y), npe_pack_bf16(hi.z, hi.w));
    } else {
      float4* d4 = reinterpret_cast<float4*>(static_cast<float*>(a.out) + o);
      d4[0] = lo;
      d4[1] = hi;
    }
  }
}

// The row-major instance: 64 group rows a warpgroup, 32 scores a thread a
// chunk.
template <int D, bool PWL>
__global__ void __launch_bounds__(WG)
flash_dense_wg_kernel(const Args a) {
  constexpr int SLOT = WK * D * 2;       // bytes of a K or V chunk
  constexpr int NS = WK / 2;             // scores a thread a chunk
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;                     // WRING slots
  unsigned char* qt = smem_raw + WRING * SLOT;        // q's pieces, WT x D each
  __shared__ NpePrefixTable etab, rtab, ttab;
  const NpePrefixFetch efetch(a.exp_table, a.exp_segs), rfetch(a.recip_table, a.recip_segs);

  const int group = a.hq / a.hkv, R = group * a.sq;
  const int tile = gridDim.x - 1 - blockIdx.x;        // the tiles that see the most keys first
  const int b = blockIdx.y / a.hkv, hk = blockIdx.y % a.hkv;
  const int r0 = tile * WT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const int off = a.kv_len - a.sq;
  // the keys some row of the tile sees: from its first query's window on,
  // below its last query's position + 1 (kv_len with causality off)
  const int pos_lo = off + r0 / group, pos_hi = off + (min(r0 + WT, R) - 1) / group;
  const int kv_lo = dense_kv_lo(pos_lo, a);
  const int kv_hi = a.causal ? pos_hi + 1 : a.kv_len;
  const int nc = (kv_hi - kv_lo + WK - 1) / WK;
  // whether every row of the tile sees every key of the chunk from key0:
  // then no score is masked
  auto chunk_full = [&](int key0) {
    return r0 + WT <= R && key0 + WK <= kv_hi && (!a.causal || key0 + WK - 1 <= pos_lo) &&
           (a.window == 0 || key0 > pos_hi - a.window);
  };
  // items 0..nc-1: K chunks of the max sweep; nc..2nc-1: of the sum sweep;
  // then K and V of each chunk in turn for P.V
  const int items = 4 * nc;
  auto chunk_of = [&](int it, bool& is_v) {
    is_v = it >= 2 * nc && ((it - 2 * nc) & 1);
    return it < 2 * nc ? it % nc : (it - 2 * nc) >> 1;
  };
  auto issue = [&](int it) {
    bool is_v;
    const int c = chunk_of(it, is_v);
    wg_stage_rows<D, WK>(is_v ? vg : kg, is_v ? a.vs[2] : a.ks[2], kv_lo + c * WK, kv_hi,
                         ring + (it % WRING) * SLOT);
  };
  // q's slots of this thread first, so that their loads do not queue behind
  // the ring's; then the ring's first copies; then q's pieces
  constexpr int QS = WT * (D / 8) / WG;   // q slots a thread
  auto row_src = [&](int rho) -> long long {
    if (r0 + rho >= R) return -1;
    const GroupRow gr = group_row(r0 + rho, hk, group);
    return b * a.qs[0] + gr.head * a.qs[1] + gr.query * a.qs[2];
  };
  float qf[QS][8];
  int qrho[QS], qc[QS];
#pragma unroll
  for (int j = 0; j < QS; ++j)
    wg_q_fetch<D>(a.q, a.qs[3], a.q_bf16, a.q_vec, threadIdx.x + j * WG, row_src, qf[j], qrho[j],
                  qc[j]);
#pragma unroll
  for (int it = 0; it < WRING - 1; ++it) {
    if (it < items) issue(it);
    npe_cp_async_commit();
  }
#pragma unroll
  for (int j = 0; j < QS; ++j) wg_q_put<D, WT>(qf[j], qrho[j], qc[j], a.q_pieces, qt);
  npe_fence_async_smem();
  npe_build_prefix_tables(etab, efetch, a.exp_segs, rtab, rfetch, a.recip_segs);  // ends synced
  dense_cap_table(ttab, a);
  const int top = npe_prefix_top(a.exp_segs), rtop = npe_prefix_top(a.recip_segs);
  const int ttop = npe_prefix_top(a.tanh_segs);

  // this thread's rows of the tile: 16 warp + g and + 8 (pos -1: padding)
  int pos[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = r0 + 16 * warp + g + 8 * e;
    pos[e] = r < R ? off + r / group : -1;
  }
  const bool live = r0 + 16 * warp < R;   // some row of the warp is a real one
  float m[2] = {NEG_BIG, NEG_BIG}, part[2] = {0.f, 0.f}, norm[2] = {1.f, 1.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t pa[WK / 16][4];                // p^ of the last K chunk: P.V's A operand

  for (int it = 0; it < items; ++it) {
    npe_cp_async_wait<WRING - 2>();
    npe_fence_async_smem();
    __syncthreads();          // item `it` staged; every warp is done with item it - 1's slot
    if (it + WRING - 1 < items) issue(it + WRING - 1);
    npe_cp_async_commit();
    const unsigned char* slot = ring + (it % WRING) * SLOT;
    bool is_v;
    const int key0 = kv_lo + chunk_of(it, is_v) * WK;
    const int sweep = it < nc ? 0 : it < 2 * nc ? 1 : 2;
    if (is_v) {               // out += p^ . V, p^ straight from the registers
      npe_wgmma_fence();
#pragma unroll
      for (int u = 0; u < WK / 16; ++u) wg_rs<D>(o, pa[u], npe_mnmajor<D>(slot, 16 * u), 1);
      npe_wgmma_commit();
      npe_wgmma_wait();
      npe_reg_fence(o);
      continue;
    }
    // S = q . K^T over the chunk's keys
    float s[NS];
    npe_wgmma_fence();
    wg_ss_chain<WK, D>(s, a.q_pieces,
                       [&](int p, int kk) { return npe_kmajor<D>(qt + p * (WT * D * 2), 0, 16 * kk); },
                       [&](int, int kk) { return npe_kmajor<D>(slot, 0, 16 * kk); });
    npe_wgmma_commit();
    npe_wgmma_wait();
    npe_reg_fence(s);
    if (!live) continue;      // the same for the warp's lanes
    // score i: row (i >> 1) & 1, key key0 + 8 (i >> 2) + 2 t4 + (i & 1)
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = __fmul_rn(s[i], a.scale);
    wg_cap<PWL, NS>(s, a, ttab, ttop);
    const bool full = chunk_full(key0);
    uint32_t hid = 0;
    if (!full) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = key0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        hid |= (uint32_t)wg_hidden(col, pos[(i >> 1) & 1], kv_hi, a) << i;
        s[i] = (hid >> i) & 1u ? NEG_BIG : s[i];
      }
    }
    if (sweep == 0) {
#pragma unroll
      for (int i = 0; i < NS; ++i) m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = __fsub_rn(s[i], m[(i >> 1) & 1]);
      wg_exp<PWL, NS>(s, etab, top);
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = (hid >> i) & 1u ? 0.f : s[i];
      if (sweep == 1) {
#pragma unroll
        for (int i = 0; i < NS; ++i) part[(i >> 1) & 1] = __fadd_rn(part[(i >> 1) & 1], s[i]);
      } else {
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] = wg_p<PWL>(s[i], norm[(i >> 1) & 1]);
#pragma unroll
        for (int u = 0; u < WK / 16; ++u) wg_pack_a(s + 8 * u, pa[u]);
      }
    }
    if (it == nc - 1) quad_reduce(m, true);          // the max sweep's end
    if (it == 2 * nc - 1) {                          // the sum sweep's end
      quad_reduce(part, false);
#pragma unroll
      for (int e = 0; e < 2; ++e) norm[e] = wg_norm<PWL>(part[e], rtab, rtop);
    }
  }
  npe_cp_async_wait<0>();
  __syncthreads();            // the ring is free: the output goes through it

  // each row's statistics (m, and the norm p^ was taken with) for the
  // backward, when asked; out = the accumulators (p^ was normalized)
  constexpr int OS = D + 4;
  float* ost = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int rho = 16 * warp + g + 8 * e;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(ost + rho * OS + 8 * j + 2 * t4) =
          make_float2(o[4 * j + 2 * e], o[4 * j + 2 * e + 1]);
    if (a.stats && t4 == 0 && pos[e] >= 0) {
      const GroupRow gr = group_row(r0 + rho, hk, group);
      reinterpret_cast<float2*>(a.stats)[((long long)b * a.hq + gr.head) * a.sq + gr.query] =
          make_float2(m[e], norm[e]);
    }
  }
  __syncthreads();
  wg_write_out<D>(a, b, ost, OS, WT, [&](int rho) {
    return r0 + rho < R ? group_row(r0 + rho, hk, group) : GroupRow{-1, 0};
  });
}

// The transposed instance, for a tile of NR (16 or 32) group rows: a decode
// step of a GQA group of 9 to 32 heads, or a prefill whose 64-row tiles
// would leave most SMs idle.  S^T = K . q^T puts 64 keys on wgmma's rows and
// the tile's rows on its columns, NR / 2 scores a thread a chunk and no
// padding rows at decode; p^T goes through shared memory to
// out^T += V^T . p^T (V the transposed A).  Such a block has an SM to
// itself, so WGT_GROUPS warpgroups split the chunks in turn, each with a
// ring of its own and a named barrier; a row's max and sum are reduced
// across lanes, warps and warpgroups once a sweep, and the warpgroups'
// partial outputs are summed in order at the end.  A launch takes as many
// warpgroups as its tiles have chunks, two to WGT_GROUPS.
constexpr int WGT_GROUPS = 4;

// Slots of a warpgroup's ring in the transposed instance: three, or two
// where three would not fit beside f32 q's three pieces.
template <int D, int NR>
__host__ __device__ __forceinline__ int wgt_ring(int q_pieces) {
  return D == 128 && NR == 32 && q_pieces > 1 ? 2 : 3;
}

template <int D, bool PWL, int NR>
__global__ void __launch_bounds__(WGT_GROUPS * WG, 1)
flash_dense_wgt_kernel(const Args a) {
  constexpr int SLOT = WK * D * 2;       // bytes of a K or V chunk
  constexpr int NS = NR / 2;             // scores a thread a chunk
  constexpr int NCOL = NR / 4;           // rows (wgmma's columns) a thread holds
  constexpr int DB = (D + 63) / 64;      // 64-row blocks of D (D = 32: half of one used)
  constexpr int PT = NR * WK * 2;        // bytes of p^T: NR rows of 64 keys
  constexpr int QSLOTS = NR * (D / 8);   // q's 16-byte slots, at most two a thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int wrt = wgt_ring<D, NR>(a.q_pieces);
  const int ng = blockDim.x >> 7;        // warpgroups: 2 to WGT_GROUPS
  const int wg = threadIdx.x >> 7, tw = threadIdx.x & (WG - 1);
  unsigned char* ring = smem_raw + wg * (wrt * SLOT + PT);     // this warpgroup's ring
  unsigned char* pt = ring + wrt * SLOT;                       // and its p^T
  unsigned char* qt = smem_raw + ng * (wrt * SLOT + PT);       // q's pieces, NR x D each
  __shared__ float red[WGT_GROUPS * 4][NR];
  __shared__ NpePrefixTable etab, rtab, ttab;
  const NpePrefixFetch efetch(a.exp_table, a.exp_segs), rfetch(a.recip_table, a.recip_segs);

  const int group = a.hq / a.hkv, R = group * a.sq;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * NR;   // the tiles that see the most keys first
  const int b = blockIdx.y / a.hkv, hk = blockIdx.y % a.hkv;
  const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const int off = a.kv_len - a.sq;
  // the keys some row of the tile sees, as in the row-major instance
  const int kv_lo = dense_kv_lo(off + r0 / group, a);
  const int kv_hi = a.causal ? off + (min(r0 + NR, R) - 1) / group + 1 : a.kv_len;
  const int nc = (kv_hi - kv_lo + WK - 1) / WK;
  // this warpgroup's chunks: wg, wg + ng, ...  The first one's
  // scores, then its e, stay in registers (sc), so it is staged and
  // multiplied once; the others three times.  Its loads, in order: K of
  // each chunk (the max sweep), K of each but the first (the sum sweep),
  // then V of the first and K and V of each other (P.V).
  const int mine = nc > wg ? (nc - wg + ng - 1) / ng : 0;
  const int nloads = mine > 0 ? 4 * mine - 2 : 0;
  auto issue = [&](int u) {
    int j;
    bool is_v = false;
    if (u < mine) {
      j = u;
    } else if (u < 2 * mine - 1) {
      j = u - mine + 1;
    } else {
      const int w = u - (2 * mine - 1);
      j = (w + 1) >> 1;
      is_v = (w & 1) == 0;
    }
    wg_stage_rows<D, WK>(is_v ? vg : kg, is_v ? a.vs[2] : a.ks[2],
                         kv_lo + (wg + ng * j) * WK, kv_hi, ring + (u % wrt) * SLOT, tw);
  };
  // q's slot of this thread first, so that its loads do not queue behind
  // the ring's; then the ring's first copies; then q's pieces
  auto row_src = [&](int rho) -> long long {
    if (r0 + rho >= R) return -1;
    const GroupRow gr = group_row(r0 + rho, hk, group);
    return b * a.qs[0] + gr.head * a.qs[1] + gr.query * a.qs[2];
  };
  float qf[2][8];
  int qrho[2] = {0, 0}, qc[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (threadIdx.x + k * blockDim.x < QSLOTS)
      wg_q_fetch<D>(a.q, a.qs[3], a.q_bf16, a.q_vec, threadIdx.x + k * blockDim.x, row_src, qf[k],
                    qrho[k], qc[k]);
  if (nloads > 0) issue(0);              // the first chunk now, the ring's other copies
  npe_cp_async_commit();                  // once q and the tables are in place
#pragma unroll
  for (int k = 0; k < 2; ++k)
    if (threadIdx.x + k * blockDim.x < QSLOTS)
      wg_q_put<D, NR>(qf[k], qrho[k], qc[k], a.q_pieces, qt);
  npe_fence_async_smem();
  npe_build_prefix_tables(etab, efetch, a.exp_segs, rtab, rfetch, a.recip_segs);  // ends synced
  dense_cap_table(ttab, a);
  for (int u = 1; u < wrt - 1; ++u) {
    if (u < nloads) issue(u);
    npe_cp_async_commit();
  }
  const int top = npe_prefix_top(a.exp_segs), rtop = npe_prefix_top(a.recip_segs);
  const int ttop = npe_prefix_top(a.tanh_segs);

  // this thread's rows: column c of its NCOL is row 8 (c >> 1) + 2 t4 + (c & 1)
  int pos[NCOL];
#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const int n = r0 + 8 * (c >> 1) + 2 * t4 + (c & 1);
    pos[c] = n < R ? off + n / group : -1;
  }
  float m[NCOL], part[NCOL], norm[NCOL];
#pragma unroll
  for (int c = 0; c < NCOL; ++c) m[c] = NEG_BIG, part[c] = 0.f, norm[c] = 1.f;
  float ot[DB][NS];                       // out^T: 64 values of D a wgmma, NR rows
#pragma unroll
  for (int db = 0; db < DB; ++db)
#pragma unroll
    for (int i = 0; i < NS; ++i) ot[db][i] = 0.f;
  float sc[NS];                           // the first chunk's scores, then its e
  uint32_t hidc = 0;                      // and its hidden scores
  // each row's max (or sum) over the block: the 8 lanes of a column, then
  // the warps of every warpgroup in order
  auto cols_reduce = [&](float (&v)[NCOL], bool is_max) {
#pragma unroll
    for (int c = 0; c < NCOL; ++c)
#pragma unroll
      for (int o = 4; o <= 16; o <<= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, v[c], o);
        v[c] = is_max ? fmaxf(v[c], y) : __fadd_rn(v[c], y);
      }
    if (g == 0) {
#pragma unroll
      for (int c = 0; c < NCOL; ++c) red[4 * wg + warp][8 * (c >> 1) + 2 * t4 + (c & 1)] = v[c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int n = 8 * (c >> 1) + 2 * t4 + (c & 1);
      float x = red[0][n];
      for (int w = 1; w < ng * 4; ++w)
        x = is_max ? fmaxf(x, red[w][n]) : __fadd_rn(x, red[w][n]);
      v[c] = x;
    }
    __syncthreads();                      // red is free again
  };

  // steps: every warpgroup's chunks of a sweep in turn (the P.V sweep a K
  // step and a V step a chunk; a warpgroup with fewer chunks waits out the
  // last steps), the sweeps' ends block-wide
  const int mmax = (nc + ng - 1) / ng;
  int u = 0;                              // the next load of the ring
  for (int t = 0; t < 4 * mmax; ++t) {
    const int sweep = t < mmax ? 0 : t < 2 * mmax ? 1 : 2;
    const int j = sweep < 2 ? t % mmax : (t - 2 * mmax) >> 1;
    const bool vstep = sweep == 2 && ((t - 2 * mmax) & 1);
    const bool cached = j == 0 && sweep > 0 && !vstep;
    if (j < mine) do {
    const unsigned char* slot = ring;
    if (!cached) {            // the step reads the ring's next chunk
      if (wrt == 3) npe_cp_async_wait<1>();
      else npe_cp_async_wait<0>();
      npe_fence_async_smem();
      // load u staged (and p^T written); every warp of the warpgroup is
      // done with load u - 1's slot
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(WG) : "memory");
      if (u + wrt - 1 < nloads) issue(u + wrt - 1);
      npe_cp_async_commit();
      slot = ring + (u % wrt) * SLOT;
      ++u;
    }
    if (vstep) {              // out^T += V^T . p^T, a 64-row block of D at a time
      npe_wgmma_fence();
#pragma unroll
      for (int db = 0; db < DB; ++db)
#pragma unroll
        for (int kk = 0; kk < WK / 16; ++kk)
          wg_ss_ta<NR>(ot[db], npe_mnmajor<D>(slot, 16 * kk, 64 * db),
                       npe_kmajor<WK>(pt, 0, 16 * kk), 1);
      npe_wgmma_commit();
      npe_wgmma_wait();
#pragma unroll
      for (int db = 0; db < DB; ++db) npe_reg_fence(ot[db]);
      break;
    }
    const int key0 = kv_lo + (wg + ng * j) * WK;
    float s[NS];
    uint32_t hid = 0;
    if (cached) {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = sc[i];
      hid = hidc;
    } else {
      // S^T = K . q^T: the chunk's 64 keys by the NR rows
      npe_wgmma_fence();
      wg_ss_chain<NR, D>(s, a.q_pieces, [&](int, int kk) { return npe_kmajor<D>(slot, 0, 16 * kk); },
                         [&](int p, int kk) { return npe_kmajor<D>(qt + p * (NR * D * 2), 0, 16 * kk); });
      npe_wgmma_commit();
      npe_wgmma_wait();
      npe_reg_fence(s);
      // score i: key key0 + 16 warp + g + 8 ((i >> 1) & 1), row column
      // c(i) = 2 (i >> 2) + (i & 1)
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = __fmul_rn(s[i], a.scale);
      wg_cap<PWL, NS>(s, a, ttab, ttop);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int key = key0 + 16 * warp + g + 8 * ((i >> 1) & 1);
        hid |= (uint32_t)wg_hidden(key, pos[2 * (i >> 2) + (i & 1)], kv_hi, a) << i;
        s[i] = (hid >> i) & 1u ? NEG_BIG : s[i];
      }
      if (j == 0) {           // the max sweep's first chunk: keep its scores
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] = s[i];
        hidc = hid;
      }
    }
    if (sweep == 0) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 2 * (i >> 2) + (i & 1);
        m[c] = fmaxf(m[c], s[i]);
      }
      break;
    }
    // e, from the scores; the first chunk's e of the sum sweep is kept
    if (!(cached && sweep == 2)) {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = __fsub_rn(s[i], m[2 * (i >> 2) + (i & 1)]);
      wg_exp<PWL, NS>(s, etab, top);
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = (hid >> i) & 1u ? 0.f : s[i];
    }
    if (sweep == 1) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int c = 2 * (i >> 2) + (i & 1);
        part[c] = __fadd_rn(part[c], s[i]);
      }
      if (cached) {
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] = s[i];
      }
      break;
    }
    // p^T to shared memory, the B operand of the V step
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kl = 16 * warp + g + 8 * ((i >> 1) & 1);
      const int n = 8 * (i >> 2) + 2 * t4 + (i & 1);
      *reinterpret_cast<__nv_bfloat16*>(pt + npe_tile_off<WK>(n, kl >> 3) + (kl & 7) * 2) =
          __float2bfloat16_rn(wg_p<PWL>(s[i], norm[2 * (i >> 2) + (i & 1)]));
    }
    } while (false);
    if (t == mmax - 1) cols_reduce(m, true);            // the max
    if (t == 2 * mmax - 1) {                            // the sum with the max fixed
      cols_reduce(part, false);
#pragma unroll
      for (int c = 0; c < NCOL; ++c) norm[c] = wg_norm<PWL>(part[c], rtab, rtop);
    }
  }
  npe_cp_async_wait<0>();
  __syncthreads();            // the rings are free: the partial outputs go through them

  constexpr int OS = D + 4;
  float* ost = reinterpret_cast<float*>(smem_raw);    // a warpgroup's NR rows of D
#pragma unroll
  for (int db = 0; db < DB; ++db)
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int d = 64 * db + 16 * warp + g + 8 * ((i >> 1) & 1);
      if (d < D) ost[wg * NR * OS + (8 * (i >> 2) + 2 * t4 + (i & 1)) * OS + d] = ot[db][i];
    }
  if (a.stats && threadIdx.x < 32 && g == 0) {
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      const int n = r0 + 8 * (c >> 1) + 2 * t4 + (c & 1);
      if (n >= R) continue;
      const GroupRow gr = group_row(n, hk, group);
      reinterpret_cast<float2*>(a.stats)[((long long)b * a.hq + gr.head) * a.sq + gr.query] =
          make_float2(m[c], norm[c]);
    }
  }
  __syncthreads();
  wg_write_out<D>(a, b, ost, OS, NR, [&](int rho) {
    return r0 + rho < R ? group_row(r0 + rho, hk, group) : GroupRow{-1, 0};
  }, ng, NR * OS);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  if (!a.kv_bf16) {
    const size_t smem = sizeof(float) * (BQ * D + TK * (D + 1) + (size_t)BQ * a.block_kv);
    static size_t granted = 0;
    if (int err = allow_smem(flash_f32kv_kernel<D>, smem, granted)) return err;
    const dim3 grid((a.sq + BQ - 1) / BQ, batch * a.hq);
    flash_f32kv_kernel<D><<<grid, 32 * WARPS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int rows = (a.hq / a.hkv) * a.sq;
  if (rows <= DEC_ROWS) {
    const int rmax = rows == 1 ? 1 : DEC_ROWS;
    const size_t smem = sizeof(float) * max((size_t)rmax * a.block_kv,
                                            (size_t)DEC_WARPS * rmax * D);
    static size_t granted1 = 0, granted8 = 0;
    if (rows == 1) {
      if (int err = allow_smem(flash_decode_kernel<D, 1>, smem, granted1)) return err;
      flash_decode_kernel<D, 1><<<batch * a.hkv, DEC_THREADS, smem, stream>>>(a);
    } else {
      if (int err = allow_smem(flash_decode_kernel<D, DEC_ROWS>, smem, granted8)) return err;
      flash_decode_kernel<D, DEC_ROWS><<<batch * a.hkv, DEC_THREADS, smem, stream>>>(a);
    }
    return (int)cudaGetLastError();
  }
  const size_t smem = MmaLayout<D>::bytes(a.block_kv);
  static size_t granted = 0;
  if (int err = allow_smem(flash_mma_kernel<D>, smem, granted)) return err;
  const dim3 grid((a.sq + 15) / 16, batch * a.hq);
  flash_mma_kernel<D><<<grid, 32 * MMA_WARPS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, bool PWL, int NR>
int launch_dense_wgt(const Args& a, int batch, int tiles, cudaStream_t stream) {
  // warpgroups: one a chunk of the keys a tile may see, two to WGT_GROUPS
  const int ng = min(WGT_GROUPS, max(2, (a.kv_len + WK - 1) / WK));
  const size_t smem = ng * ((size_t)wgt_ring<D, NR>(a.q_pieces) * WK * D * 2 + NR * WK * 2) +
                      (size_t)a.q_pieces * NR * D * 2;
  static size_t granted = 0;
  if (int err = allow_smem(flash_dense_wgt_kernel<D, PWL, NR>, smem, granted)) return err;
  flash_dense_wgt_kernel<D, PWL, NR><<<dim3(tiles, batch * a.hkv), ng * WG, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D, bool PWL>
int launch_dense_wg(const Args& a, int batch, cudaStream_t stream) {
  const int rows = (a.hq / a.hkv) * a.sq;
  // the row-major grid, and whether it fills two waves of the SMs
  const int tiles64 = (rows + WT - 1) / WT;
  const bool fills = (long long)tiles64 * batch * a.hkv >= 2 * npe_sm_count();
  if (rows > 16 && rows <= 32) return launch_dense_wgt<D, PWL, 32>(a, batch, 1, stream);
  if (rows <= 16 || !fills)
    return launch_dense_wgt<D, PWL, 16>(a, batch, (rows + 15) / 16, stream);
  const size_t smem = (size_t)WRING * WK * D * 2 + (size_t)a.q_pieces * WT * D * 2;
  static size_t granted = 0;
  if (int err = allow_smem(flash_dense_wg_kernel<D, PWL>, smem, granted)) return err;
  flash_dense_wg_kernel<D, PWL><<<dim3(tiles64, batch * a.hkv), WG, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Clusters of c blocks of the decode instance that the card holds at once
// with `seg` keys a block's scores, by the occupancy calculator (a cluster's
// blocks share a GPC, so this is not the SMs times the blocks an SM holds
// over c), once for each (c, seg).
template <int D, int RI>
int spl_clusters(int c, int seg) {
  static int known[SPL_MAX_CLUSTER + 1][SPL_SCORES / SPL_CK + 1] = {};
  int& n = known[c][seg / SPL_CK];
  if (n == 0) {
    static size_t granted = 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(SPL_THREADS);
    cfg.dynamicSmemBytes = spl_smem<D, RI>(seg);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (allow_smem(flash_dense_split_kernel<D, RI>, spl_smem<D, RI>(SPL_SCORES / RI), granted) ||
        cudaOccupancyMaxActiveClusters(&n, flash_dense_split_kernel<D, RI>, &cfg) != cudaSuccess ||
        n < 1)
      n = 1;
  }
  return n;
}

// The decode instance's split of a call: the largest cluster (at most
// SPL_MAX_CLUSTER blocks, at least four chunks a block) of which the card
// holds one for each (batch, kv head) at once, one block a (batch, kv
// head) if none, since a block's
// fixed work (its set-up, three exchanges) is paid once a wave; but a cache
// that would leave a block more than SPL_LONG chunks takes the largest
// cluster, whose shorter streams balance the SMs over several waves.  `seg`:
// the keys of a block's largest slice, at most what SPL_SCORES holds of RI
// rows.
constexpr int SPL_LONG = 16;
template <int D, int RI>
void spl_split(Args& a, int batch) {
  const int kv_lo = a.window > 0 ? max(0, a.kv_len - a.sq - a.window + 1) : 0;
  const int chunks = (a.kv_len - kv_lo + SPL_CK - 1) / SPL_CK;
  const long long heads = (long long)batch * a.hkv;
  const int most = max(1, min(SPL_MAX_CLUSTER, chunks / 4));
  a.split = 1;
  for (int c = most; c > 1; --c) {
    const int seg = min((chunks + c - 1) / c * SPL_CK, SPL_SCORES / RI);
    if (heads <= spl_clusters<D, RI>(c, seg)) {
      a.split = c;
      break;
    }
  }
  if ((chunks + a.split - 1) / a.split > SPL_LONG) a.split = most;
  a.seg = min((chunks + a.split - 1) / a.split * SPL_CK, SPL_SCORES / RI);
}

// One cluster launch of the decode instance with RI rows.
template <int D, int RI>
int launch_dense_split(Args a, int batch, cudaStream_t stream) {
  spl_split<D, RI>(a, batch);
  const size_t smem = spl_smem<D, RI>(a.seg);
  static size_t granted = 0;   // the most any call takes, as spl_clusters asks
  if (int err = allow_smem(flash_dense_split_kernel<D, RI>, spl_smem<D, RI>(SPL_SCORES / RI),
                           granted))
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.split, batch * a.hkv);
  cfg.blockDim = dim3(SPL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (const cudaError_t err = cudaLaunchKernelEx(&cfg, flash_dense_split_kernel<D, RI>, a))
    return (int)err;
  return (int)cudaGetLastError();
}

// At most 8 rows a kv head and no statistics asked: the decode instance,
// its rows rounded up to 1, 2, 4 or 8; up to 32, the transposed
// tensor-core instance on one tile; more, whose 64-row tiles would not fill
// two waves of the SMs, the transposed one in 16-row tiles; else the
// row-major one.
template <int D>
int launch_dense(const Args& a, int batch, cudaStream_t stream) {
  const int rows = (a.hq / a.hkv) * a.sq;
  if (rows <= DEC_ROWS && a.stats == nullptr) {
    if (rows == 1) return launch_dense_split<D, 1>(a, batch, stream);
    if (rows == 2) return launch_dense_split<D, 2>(a, batch, stream);
    if (rows <= 4) return launch_dense_split<D, 4>(a, batch, stream);
    return launch_dense_split<D, 8>(a, batch, stream);
  }
  return a.use_pwl ? launch_dense_wg<D, true>(a, batch, stream)
                   : launch_dense_wg<D, false>(a, batch, stream);
}

}  // namespace

extern "C" int npe_flash_attention(
    const void* q, const void* k, const void* v, void* out,
    long long qsb, long long qsh, long long qss, long long qsd,
    long long ksb, long long ksh, long long kss, long long ksd,
    long long vsb, long long vsh, long long vss, long long vsd,
    long long osb, long long osh, long long oss, long long osd,
    int batch, int hq, int hkv, int sq, int skv, int d, int kv_len,
    int q_bf16, int kv_bf16, int out_bf16, int causal, int window, float scale,
    int use_pwl, int block_q, int block_kv, const float* exp_table,
    int exp_segments, const float* recip_table, int recip_segments, void* stream) {
  if (exp_segments < 1 || exp_segments + 1 > NPE_MAX_TABLE_COLS ||
      recip_segments < 1 || recip_segments + 1 > NPE_MAX_TABLE_COLS ||
      hkv < 1 || hq % hkv != 0 || kv_len < sq || kv_len > skv || block_q < 1 ||
      block_kv < 1 || block_kv > 1024)
    return (int)cudaErrorInvalidValue;
  // the bf16 kernels read K and V rows as 16-byte vectors
  if (kv_bf16 && !(vec_ok(k, ksb, ksh, kss, ksd) && vec_ok(v, vsb, vsh, vss, vsd)))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || hq <= 0 || sq <= 0) return 0;
  // one bf16 piece holds q*scale when q is bf16 and scale a power of two
  int e2 = 0;
  const int q_pieces = (q_bf16 && frexpf(scale, &e2) == 0.5f) ? 1 : Q_PIECES_MAX;
  Args a{q, k, v, out,
         {qsb, qsh, qss, qsd}, {ksb, ksh, kss, ksd}, {vsb, vsh, vss, vsd},
         {osb, osh, oss, osd},
         hq, hkv, sq, kv_len, q_bf16, kv_bf16, out_bf16,
         causal, window, use_pwl, block_q, block_kv, scale, q_pieces,
         exp_table, exp_segments, recip_table, recip_segments};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(a, batch, s);
    case 64: return launch<64>(a, batch, s);
    case 128: return launch<128>(a, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int npe_attention_dense(
    const void* q, const void* k, const void* v, void* out,
    long long qsb, long long qsh, long long qss, long long qsd,
    long long ksb, long long ksh, long long kss, long long ksd,
    long long vsb, long long vsh, long long vss, long long vsd,
    long long osb, long long osh, long long oss, long long osd,
    int batch, int hq, int hkv, int sq, int skv, int d, int kv_len, int q_bf16,
    int out_bf16, int causal, int window, float scale, float softcap, int use_pwl,
    const float* exp_table, int exp_segments, const float* recip_table, int recip_segments,
    const float* tanh_table, int tanh_segments, float tanh_lo, float tanh_hi, float* stats,
    void* stream) {
  if (exp_segments < 1 || exp_segments + 1 > NPE_MAX_TABLE_COLS ||
      recip_segments < 1 || recip_segments + 1 > NPE_MAX_TABLE_COLS ||
      hkv < 1 || hq % hkv != 0 || kv_len < sq || kv_len > skv || window < 0 ||
      !(softcap >= 0.f) ||
      (softcap > 0.f && use_pwl &&
       (tanh_table == nullptr || tanh_segments < 1 || tanh_segments + 1 > NPE_MAX_TABLE_COLS)))
    return (int)cudaErrorInvalidValue;
  // K and V are the bf16 cache, read as 16-byte vectors, and the output is
  // written so (the wrapper allocates it)
  if (!(vec_ok(k, ksb, ksh, kss, ksd) && vec_ok(v, vsb, vsh, vss, vsd) &&
        vec_ok(out, osb, osh, oss, osd)))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || hq <= 0 || sq <= 0) return 0;
  Args a{q, k, v, out,
         {qsb, qsh, qss, qsd}, {ksb, ksh, kss, ksd}, {vsb, vsh, vss, vsd},
         {osb, osh, oss, osd},
         hq, hkv, sq, kv_len, q_bf16, /*kv_bf16=*/1, out_bf16,
         causal ? 1 : 0, window, use_pwl, /*block_q=*/sq, /*block_kv=*/WK, scale,
         /*q_pieces=*/q_bf16 ? 1 : Q_PIECES_MAX,
         exp_table, exp_segments, recip_table, recip_segments,
         softcap, tanh_table, tanh_segments, tanh_lo, tanh_hi, stats,
         vec_ok(q, qsb, qsh, qss, qsd) ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dense<32>(a, batch, s);
    case 64: return launch_dense<64>(a, batch, s);
    case 128: return launch_dense<128>(a, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The blocks a cluster of the dense mode's decode instance would take a
// (batch, kv head) for a call of npe_attention_dense with these shapes (1
// to 8; the launch's own rule, for reports), or 0 for a call that takes a
// tensor-core instance or that the mode refuses.
extern "C" int npe_attention_dense_split(int batch, int hq, int hkv, int sq, int kv_len,
                                         int window, int d) {
  if (batch < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || kv_len < sq || window < 0) return 0;
  const int rows = (hq / hkv) * sq;
  if (rows > DEC_ROWS) return 0;
  Args a = {};
  a.hq = hq, a.hkv = hkv, a.sq = sq, a.kv_len = kv_len, a.window = window;
  auto split = [&](auto d_tag) {
    constexpr int D = decltype(d_tag)::value;
    if (rows == 1) spl_split<D, 1>(a, batch);
    else if (rows == 2) spl_split<D, 2>(a, batch);
    else if (rows <= 4) spl_split<D, 4>(a, batch);
    else spl_split<D, 8>(a, batch);
    return a.split;
  };
  switch (d) {
    case 32: return split(std::integral_constant<int, 32>());
    case 64: return split(std::integral_constant<int, 64>());
    case 128: return split(std::integral_constant<int, 128>());
    default: return 0;
  }
}
