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
// The dense mode (`npe_attention_dense`) is what the decode path runs: the
// cache case of the reference's `attention_scores` (src/repro/models/
// common.py, with nvu_softmax and nvu_reciprocal of src/repro/core/nvu.py),
// which is no Pallas kernel.  For each query row at position pos (causal,
// end-aligned) over bf16 K/V: s = (q . k) * scale in f32, keys past pos
// masked; m = the max over every visible key, with no running rescale;
// e = nvu_exp(s - m) (npe_softmax_exp_n) or exp; p = e * pwl_recip(sum e)
// or e / sum e, rounded to bf16 as `probs.astype(v.dtype)`; out = P.V
// accumulated in f32.  A pass keeps its keys' scores in shared memory
// (8192 keys of one query row, or 1024 of 8 rows or of a 16-row tile):
// when the visible keys fit, one pass of Q.K^T gives the max, the sum and p;
// past that the kernel makes three passes over the keys (the max, then the
// sum with that max fixed, then P.V with the normalized, rounded p), so
// every cache length is served in one launch.  Two instances, chosen by
// shape as in the blocked mode:
// * at most 8 query rows a kv head: `flash_dense_decode_kernel`, the decode
//   instance's layout (a block of 8 warps a (batch, kv head), 16-byte loads
//   of the cache, keys split across threads, f32 products on the CUDA
//   cores, partial accumulators summed at the end).
// * more rows: `flash_dense_mma_kernel`, the tensor-core instance's layout
//   (16 query rows a block, 128-key chunks through the cp.async ring,
//   mma.sync for Q.K^T and P.V).  q is split into bf16 pieces unscaled (one
//   piece for bf16 q) and the scale multiplies the f32 product, as in
//   attention_scores; p is one bf16 operand by definition, so it needs no
//   split.
// The dense mode also takes the rest of attention_scores' mask and its soft
// cap.  `causal` = 0 lets every row see every key below kv_len (a ring
// cache: the reference's prefix validity arange(wlen) <= pos | pos >= wlen
// is a key count, kv_len = min(pos + 1, wlen)); `window` > 0 hides the keys
// at or below pos - window; `softcap` > 0 maps each score s (after the
// scale, before the mask) to c * tanh(s / c), tanh the NVU's PWL table
// (clamped to its end knots, as nvu_tanh) or tanhf.  A block reads only the
// keys some row of it sees: from the first row's pos - window + 1 (0
// without a window) to its last row's pos (kv_len with causality off), so
// a windowed prefill tile reads about window + 16 keys, not all before it.
// The row max is taken over visible keys only (masked scores are NEG_BIG),
// since the PWL exp does not rescale.  With causal = 1, window = 0 and
// softcap = 0 every key range, mask and sum is the one before these
// arguments existed, so those launches give the same bits.
#include "hopper.cuh"
#include "pwl.cuh"

namespace {

constexpr float NEG_BIG = -1e30f;

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
};

__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

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

// 8 bf16 of a 16-byte load as f32 (exact).
__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
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
constexpr int Q_PIECES_MAX = 3;

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

constexpr int DENSE_SCORES = 8192;       // scores a decode block keeps in shared memory (32 KB)
constexpr int DENSE_SEG = 1024;          // keys a pass of the tensor-core instance keeps, 16 rows each

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

template <int D, int ROWS>
__global__ void __launch_bounds__(DEC_THREADS, 1)
flash_dense_decode_kernel(const Args a) {
  constexpr int LPK = D / 8;               // lanes a key row, 8 bf16 a lane
  constexpr int KPI = DEC_THREADS / LPK;   // keys a pass of the block
  constexpr int U = ROWS > 1 ? 2 : (D == 32 ? 4 : 8);  // 16-byte loads in flight a thread
  constexpr int CH = KPI * U;              // keys a chunk
  constexpr int SEG = DENSE_SCORES / ROWS; // keys a pass keeps
  extern __shared__ float smem[];          // ROWS x SEG: scores, e, p; at the end the partials
  __shared__ float red[ROWS][DEC_WARPS];
  __shared__ NpePrefixTable etab, rtab, ttab;
  const NpePrefixFetch efetch(a.exp_table, a.exp_segs), rfetch(a.recip_table, a.recip_segs);

  const int b = blockIdx.x / a.hkv, hk = blockIdx.x % a.hkv;
  const int group = a.hq / a.hkv;
  const int nrows = group * a.sq;          // row r: q head hk*group + r / sq, query r % sq
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = tid % LPK, slot = tid / LPK;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] +
                            hk * a.ks[1] + sub * 8;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] +
                            hk * a.vs[1] + sub * 8;

  int pos[ROWS];                           // -1: a padding row, every key masked
  float qv[ROWS][8], acc[ROWS][8];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = r < nrows ? r % a.sq : 0, h = hk * group + (r < nrows ? r / a.sq : 0);
    pos[r] = r < nrows ? a.kv_len - a.sq + i : -1;
    const long long qb = b * a.qs[0] + h * a.qs[1] + i * a.qs[2];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      qv[r][c] = r < nrows ? load(a.q, qb + (sub * 8 + c) * a.qs[3], a.q_bf16) : 0.f;
      acc[r][c] = 0.f;
    }
  }
  npe_build_prefix_tables(etab, efetch, a.exp_segs, rtab, rfetch, a.recip_segs);
  dense_cap_table(ttab, a);
  const int top = npe_prefix_top(a.exp_segs), rtop = npe_prefix_top(a.recip_segs);
  const int ttop = npe_prefix_top(a.tanh_segs);
  // the keys some row sees: kv_lo.. past the first row's window, up to kv_len
  const int kv_lo = dense_kv_lo(a.kv_len - a.sq, a);
  const int nseg = (a.kv_len - kv_lo + SEG - 1) / SEG;

  auto load_chunk = [&](uint4 (&w)[U], const __nv_bfloat16* base, long long stride, int s0,
                        int t0, int nk) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * KPI + slot;
      w[u] = t < nk ? __ldg(reinterpret_cast<const uint4*>(base + (long long)(s0 + t) * stride))
                    : make_uint4(0, 0, 0, 0);
    }
  };
  // the scores (q . k) * scale of keys s0..s0+nk-1, masked at NEG_BIG, into
  // smem; each thread's max into mx
  auto scores = [&](int s0, int nk, float (&mx)[ROWS]) {
    uint4 w[U];
    for (int t0 = 0; t0 < nk; t0 += CH) {
      load_chunk(w, kp, a.ks[2], s0, t0, nk);
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
            float s[1] = {__fmul_rn(dot, a.scale)};
            dense_cap_n<1>(s, a, ttab, ttop);
            s[0] = key_masked(s0 + t, pos[r], a) ? NEG_BIG : s[0];
            if (sub == 0) smem[r * SEG + t] = s[0];
            mx[r] = fmaxf(mx[r], s[0]);
          }
        }
      }
    }
  };
  // the block's max (or sum, in the order of the warps) of each row
  auto block_reduce = [&](float (&v)[ROWS], bool is_max) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float x = is_max ? npe_warp_max(v[r]) : npe_warp_sum(v[r]);
      if (lane == 0) red[r][warp] = x;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float x = red[r][0];
#pragma unroll
      for (int j = 1; j < DEC_WARPS; ++j) x = is_max ? fmaxf(x, red[r][j]) : __fadd_rn(x, red[r][j]);
      v[r] = x;
    }
    __syncthreads();                       // red is free again
  };

  float m[ROWS], norm[ROWS], part[ROWS];
  // keys s0..s0+nk-1 of smem, in place: scores to e (summed into part),
  // scores to p, or (from_e) e to p
  auto softmax = [&](int s0, int nk, bool to_p, bool from_e) {
    for (int t = tid; t < nk; t += DEC_THREADS) {
      float z[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) z[r] = smem[r * SEG + t];
      if (!from_e) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) z[r] = __fsub_rn(z[r], m[r]);
        dense_exp_n<ROWS>(z, a, etab, top);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) z[r] = key_masked(s0 + t, pos[r], a) ? 0.f : z[r];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (to_p) {
          smem[r * SEG + t] = dense_p(z[r], norm[r], a);
        } else {
          smem[r * SEG + t] = z[r];
          part[r] = __fadd_rn(part[r], z[r]);
        }
      }
    }
  };

  // pass 1: the max over every visible key
#pragma unroll
  for (int r = 0; r < ROWS; ++r) m[r] = NEG_BIG;
  for (int seg = 0; seg < nseg; ++seg)
    scores(kv_lo + seg * SEG, min(SEG, a.kv_len - kv_lo - seg * SEG), m);
  block_reduce(m, true);                   // also: one segment's scores are in smem
  // pass 2: the sum with the max fixed
#pragma unroll
  for (int r = 0; r < ROWS; ++r) part[r] = 0.f;
  for (int seg = 0; seg < nseg; ++seg) {
    const int s0 = kv_lo + seg * SEG, nk = min(SEG, a.kv_len - s0);
    if (nseg > 1) {
      float unused[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) unused[r] = NEG_BIG;
      __syncthreads();                     // the last segment's readers are done
      scores(s0, nk, unused);
      __syncthreads();
    }
    softmax(s0, nk, false, false);
  }
  block_reduce(part, false);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) norm[r] = dense_norm(part[r], a, rtab, rtop);
  // pass 3: P.V with the normalized, rounded p
  for (int seg = 0; seg < nseg; ++seg) {
    const int s0 = kv_lo + seg * SEG, nk = min(SEG, a.kv_len - s0);
    uint4 w[U];
    if (nseg > 1) {
      float unused[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) unused[r] = NEG_BIG;
      __syncthreads();
      scores(s0, nk, unused);
      __syncthreads();
    }
    load_chunk(w, vp, a.vs[2], s0, 0, nk);   // V of the first chunk, in flight over the softmax
    softmax(s0, nk, true, nseg == 1);
    __syncthreads();                       // p is in smem
    for (int t0 = 0; t0 < nk; t0 += CH) {
      if (t0 > 0) load_chunk(w, vp, a.vs[2], s0, t0, nk);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * KPI + slot;
        if (t >= nk) continue;
        float vf[8];
        unpack8(w[u], vf);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r >= nrows) continue;
          const float p = smem[r * SEG + t];
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(p, vf[c], acc[r][c]);
        }
      }
    }
  }

  // sum the partial accumulators: over the lanes of a warp that share `sub`,
  // then across warps in smem; p was normalized, so the sum is the output
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1)
        acc[r][c] = __fadd_rn(acc[r][c], __shfl_xor_sync(0xffffffffu, acc[r][c], o));
  __syncthreads();                         // smem's p is read
  if (lane < LPK) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) smem[(warp * ROWS + r) * D + sub * 8 + c] = acc[r][c];
  }
  __syncthreads();
  for (int idx = tid; idx < nrows * D; idx += DEC_THREADS) {
    const int r = idx / D, c = idx % D;
    float s = smem[r * D + c];
#pragma unroll
    for (int j = 1; j < DEC_WARPS; ++j) s = __fadd_rn(s, smem[(j * ROWS + r) * D + c]);
    const int i = r % a.sq, h = hk * group + r / a.sq;
    store(a, b * a.os[0] + h * a.os[1] + i * a.os[2] + c * a.os[3], s);
  }
}

template <int D>
__global__ void __launch_bounds__(32 * MMA_WARPS)
flash_dense_mma_kernel(const Args a) {
  using L = MmaLayout<D>;
  constexpr int DS = L::DS;
  constexpr int NT = D / 8;              // n8 tiles of the output
  constexpr int CHUNKS = DENSE_SEG / KC; // chunks of a segment
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* qp = ring + L::RING_ELEMS;
  float* s_s = reinterpret_cast<float*>(qp + L::QP);   // a segment's scores or e, fragment order
  __shared__ float red[MMA_WARPS][16];
  __shared__ NpePrefixTable etab, rtab, ttab;
  const NpePrefixFetch efetch(a.exp_table, a.exp_segs), rfetch(a.recip_table, a.recip_segs);

  const int bh = blockIdx.y;
  const int b = bh / a.hq, h = bh % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = blockIdx.x * 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + hk * a.vs[1];

  // q (unscaled: the scale multiplies the product) in bf16 pieces
  const long long qbase = b * a.qs[0] + h * a.qs[1];
  for (int idx = tid; idx < 16 * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D;
    const float x = q0 + r < a.sq ? load(a.q, qbase + (q0 + r) * a.qs[2] + c * a.qs[3], a.q_bf16)
                                  : 0.f;
    float p[3];
    npe_split3(x, p);
#pragma unroll
    for (int j = 0; j < Q_PIECES_MAX; ++j) qp[(j * 16 + r) * DS + c] = __float2bfloat16_rn(p[j]);
  }
  // ends synced: q pieces staged too
  npe_build_prefix_tables(etab, efetch, a.exp_segs, rtab, rfetch, a.recip_segs);
  dense_cap_table(ttab, a);
  const int top = npe_prefix_top(a.exp_segs), rtop = npe_prefix_top(a.recip_segs);
  const int ttop = npe_prefix_top(a.tanh_segs);

  // this lane's rows of the tile: g and g + 8 (-1: past Sq, every key masked)
  int pos[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = q0 + g + 8 * e;
    pos[e] = i < a.sq ? a.kv_len - a.sq + i : -1;
  }
  // the keys some row of the tile sees: kv_lo.. past its first row's window,
  // below kv_hi (its last row's position + 1, or kv_len with causality off)
  const int kv_lo = dense_kv_lo(a.kv_len - a.sq + q0, a);
  const int kv_hi = a.causal ? a.kv_len - a.sq + min(q0 + 16, a.sq) : a.kv_len;
  const int nseg = (kv_hi - kv_lo + DENSE_SEG - 1) / DENSE_SEG;
  float m[2] = {NEG_BIG, NEG_BIG}, norm[2] = {1.f, 1.f}, part[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // each row's max (or sum, in the order of the warps) over the block: the
  // quad of lanes that hold it, then the warps
  auto rows_reduce = [&](float (&v)[2], bool is_max) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, v[e], o);
        v[e] = is_max ? fmaxf(v[e], y) : __fadd_rn(v[e], y);
      }
    if (t4 == 0) {
      red[warp][g] = v[0];
      red[warp][g + 8] = v[1];
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = red[0][g + 8 * e];
#pragma unroll
      for (int w = 1; w < MMA_WARPS; ++w)
        x = is_max ? fmaxf(x, red[w][g + 8 * e]) : __fadd_rn(x, red[w][g + 8 * e]);
      v[e] = x;
    }
    __syncthreads();                       // red is free again
  };
  // e of a fragment's 8 scores (keys from kc), masked to 0; summed into part
  auto frag_exp = [&](float (&z)[8], int kc) {
#pragma unroll
    for (int x = 0; x < 8; ++x) z[x] = __fsub_rn(z[x], m[(x >> 1) & 1]);
    dense_exp_n<8>(z, a, etab, top);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int col = kc + (x >> 2) * 8 + 2 * t4 + (x & 1);
      z[x] = key_masked(col, pos[(x >> 1) & 1], a) ? 0.f : z[x];
      part[(x >> 1) & 1] = __fadd_rn(part[(x >> 1) & 1], z[x]);
    }
  };

  // One sweep over the keys s0.. of a segment: its K chunks and, in phase 2,
  // its V chunks, through the ring (RING - 1 of them in flight).  Phase 0:
  // the max of the scores; phase 1: the sum of e; phase 2: e into s_s
  // (with one segment: the scores, then at the first V chunk the max, e and
  // the sum), then P.V with p = e normalized and rounded to bf16.
  auto sweep = [&](int phase, int s0) {
    const int s_end = min(s0 + DENSE_SEG, kv_hi);
    const int nc = (s_end - s0 + KC - 1) / KC;
    const int items = phase == 2 ? 2 * nc : nc;
    auto issue = [&](int it) {
      const bool is_k = it < nc;
      const __nv_bfloat16* src = is_k ? kg : vg;
      const long long stride = is_k ? a.ks[2] : a.vs[2];
      const int key0 = s0 + (is_k ? it : it - nc) * KC;
      __nv_bfloat16* dst = ring + (it % RING) * KC * DS;
      for (int x = tid; x < KC * (D / 8); x += blockDim.x) {
        const int kr = x / (D / 8), piece = x % (D / 8);
        const int key = key0 + kr;
        const bool ok = key < s_end;       // never past the keys the tile sees
        npe_cp_async16(dst + kr * DS + piece * 8, ok ? src + key * stride + piece * 8 : src,
                       ok ? 16 : 0);
      }
    };
#pragma unroll
    for (int it = 0; it < RING - 1; ++it) {
      if (it < items) issue(it);
      npe_cp_async_commit();
    }
    for (int it = 0; it < items; ++it) {
      npe_cp_async_wait<RING - 2>();
      __syncthreads();        // item `it` staged; every warp is done with item it-1's stage
      if (it + RING - 1 < items) issue(it + RING - 1);
      npe_cp_async_commit();
      const __nv_bfloat16* tile = ring + (it % RING) * KC * DS;
      const int j = it < nc ? it : it - nc;
      const int kc = s0 + j * KC + warp * 16;   // this warp's first key
      float* sfrag = s_s + ((warp * CHUNKS + j) * 32 + lane) * 8;
      if (it < nc) {
        // S = (q . K^T) * scale over this warp's 16 keys, masked at NEG_BIG
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
        float z[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) z[x] = __fmul_rn(s[x >> 2][x & 3], a.scale);
        dense_cap_n<8>(z, a, ttab, ttop);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int col = kc + (x >> 2) * 8 + 2 * t4 + (x & 1);
          z[x] = key_masked(col, pos[(x >> 1) & 1], a) ? NEG_BIG : z[x];
        }
        if (phase == 0 || (phase == 2 && nseg == 1)) {
#pragma unroll
          for (int x = 0; x < 8; ++x) m[(x >> 1) & 1] = fmaxf(m[(x >> 1) & 1], z[x]);
        } else {
          frag_exp(z, kc);                 // phase 1, or phase 2 of several segments
        }
        if (phase == 2) {
          reinterpret_cast<float4*>(sfrag)[0] = make_float4(z[0], z[1], z[2], z[3]);
          reinterpret_cast<float4*>(sfrag)[1] = make_float4(z[4], z[5], z[6], z[7]);
        }
      } else {
        if (it == nc && nseg == 1) {       // every K chunk is done: the sync above
          rows_reduce(m, true);
          for (int jj = 0; jj < nc; ++jj) {
            float* f = s_s + ((warp * CHUNKS + jj) * 32 + lane) * 8;
            float z[8];
#pragma unroll
            for (int x = 0; x < 8; ++x) z[x] = f[x];
            frag_exp(z, s0 + jj * KC + warp * 16);
#pragma unroll
            for (int x = 0; x < 8; ++x) f[x] = z[x];
          }
          rows_reduce(part, false);
#pragma unroll
          for (int e = 0; e < 2; ++e) norm[e] = dense_norm(part[e], a, rtab, rtop);
        }
        // p = e normalized, one bf16 operand straight from the accumulator layout
        const float4 f0 = reinterpret_cast<const float4*>(sfrag)[0];
        const float4 f1 = reinterpret_cast<const float4*>(sfrag)[1];
        const float z[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
        float p[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) p[x] = dense_p(z[x], norm[(x >> 1) & 1], a);
        const uint32_t ap[4] = {npe_pack_bf16(p[0], p[1]), npe_pack_bf16(p[2], p[3]),
                                npe_pack_bf16(p[4], p[5]), npe_pack_bf16(p[6], p[7])};
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t bv[4];
          npe_ldsm_x4_trans(bv, tile + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DS +
                                    dd * 16 + (lane >> 4) * 8);
          npe_mma_bf16(acc[2 * dd], ap, bv[0], bv[1]);
          npe_mma_bf16(acc[2 * dd + 1], ap, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();          // the ring is free for the next sweep
  };

  if (nseg > 1) {
    for (int seg = 0; seg < nseg; ++seg) sweep(0, kv_lo + seg * DENSE_SEG);
    rows_reduce(m, true);
    for (int seg = 0; seg < nseg; ++seg) sweep(1, kv_lo + seg * DENSE_SEG);
    rows_reduce(part, false);
#pragma unroll
    for (int e = 0; e < 2; ++e) norm[e] = dense_norm(part[e], a, rtab, rtop);
  }
  for (int seg = 0; seg < nseg; ++seg) sweep(2, kv_lo + seg * DENSE_SEG);

  // out = the warps' partial accumulators summed (p was normalized)
  float* comb = reinterpret_cast<float*>(smem_raw);   // MMA_WARPS x 16 x D, over the ring
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      comb[(warp * 16 + g + 8 * (e >> 1)) * D + n * 8 + 2 * t4 + (e & 1)] = acc[n][e];
  __syncthreads();
  const long long obase = b * a.os[0] + h * a.os[1];
  for (int idx = tid; idx < 16 * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D;
    if (q0 + r >= a.sq) continue;
    float s = comb[r * D + c];
#pragma unroll
    for (int w = 1; w < MMA_WARPS; ++w) s = __fadd_rn(s, comb[(w * 16 + r) * D + c]);
    store(a, obase + (q0 + r) * a.os[2] + c * a.os[3], s);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

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

template <int D>
int launch_dense(const Args& a, int batch, cudaStream_t stream) {
  const int rows = (a.hq / a.hkv) * a.sq;
  if (rows <= DEC_ROWS) {
    const int rmax = rows == 1 ? 1 : DEC_ROWS;
    const size_t smem = sizeof(float) * max((size_t)DENSE_SCORES, (size_t)DEC_WARPS * rmax * D);
    if (rows == 1)
      flash_dense_decode_kernel<D, 1><<<batch * a.hkv, DEC_THREADS, smem, stream>>>(a);
    else
      flash_dense_decode_kernel<D, DEC_ROWS><<<batch * a.hkv, DEC_THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t smem = MmaLayout<D>::bytes(DENSE_SEG);
  static size_t granted = 0;
  if (int err = allow_smem(flash_dense_mma_kernel<D>, smem, granted)) return err;
  const dim3 grid((a.sq + 15) / 16, batch * a.hq);
  flash_dense_mma_kernel<D><<<grid, 32 * MMA_WARPS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool vec_ok(const void* p, long long s0, long long s1, long long s2, long long s3) {
  return s3 == 1 && s0 % 8 == 0 && s1 % 8 == 0 && s2 % 8 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}


// ---------------------------------------------------------------------------
// the dense mode's backward (npe_attention_dense_grad)
// ---------------------------------------------------------------------------
//
// jax.vjp of attention_scores (src/repro/models/common.py:205), which the
// reference's training differentiates: for each query row over its visible
// keys, with p^_j the bf16 probabilities of the forward,
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
// Bound on this card: operations.  The five products of a visible pair
// (S and dP again, dV, dK, dQ; 2 D each) on the bf16 tensor cores, and some
// fifty f32 operations a pair on the CUDA cores (two table searches, the
// chain above), against q, k, v and the cotangent read once.
// Design (FlashAttention-2's, written to be right first): the forward is
// recomputed, never stored.  `dense_grad_q_kernel`, a block of 4 warps for
// 64 query rows of one head, each warp 16 rows over every key of a 64-key
// chunk (so a row's reductions stay in its quad of lanes, and the block
// syncs only for the chunks: K and V through a two-stage cp.async ring;
// S = Q.K^T and dP = dO.V^T by mma.sync on bf16 with f32 accumulation, q
// split into bf16 pieces when it is f32), makes four sweeps over the
// visible keys: the max; the sum S, dr and the tied maxima; the sum of dz;
// then dS into dQ (each f32 dS split into three bf16 pieces, so every
// product is exact and only sums change order).  It writes each
// row's m, 1/S (S in exact mode), dS (sum p dp) and the max's share to a
// workspace.  `dense_grad_kv_kernel`, a block a 64-key block of one q head,
// takes those and every 16-query tile that sees one of its keys (the next
// tile's q, cotangent and statistics loaded while this one computes),
// recomputes S^T = K.Q^T and dP^T = V.dO^T, whose fragments are the A
// operands of dV += P^T.dO and dK += dS^T.Q, and writes f32 partials a q
// head; the wrapper sums them over the group and rounds them (a torch sum).
// A table's value comes from the prefix search (the forward's bits), and
// its slope from `slope_table`'s row at the segment that search found.

constexpr int GW = 4;                    // warps a backward block
constexpr int GT = 32 * GW;              // threads a backward block
constexpr int GKC = 16 * GW;             // keys a staged chunk (the kv kernel: 16 a warp)
constexpr int GQ = 16 * GW;              // query rows a block of the q kernel, 16 a warp

struct GradArgs {
  const void* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  void* dq;
  float* dk;                             // (B, Hq, Skv, D) f32 partials a q head
  float* dv;
  float* stats;                          // (B, Hq, Sq, 4): m, norm, dS, share
  long long qs[4], ks[4], vs[4], dos[4];
  int hq, hkv, sq, skv, q_bf16, q_pieces, causal, window, use_pwl;
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

// The tables of a backward block: values in prefix form, slopes as rows.
struct GradTables {
  NpePrefixTable e, r, t;
  float es[2 * NPE_MAX_TABLE_COLS], rs[2 * NPE_MAX_TABLE_COLS], ts[2 * NPE_MAX_TABLE_COLS];
  int etop, rtop, ttop;
};

// Every thread of a block of GT threads calls it; ends synced.
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

__device__ __forceinline__ void grad_scores8(float (&s)[8], GradCap8& c, const GradArgs& a,
                                             const GradTables& T) {
#pragma unroll
  for (int x = 0; x < 8; ++x) s[x] = __fmul_rn(s[x], a.scale);
  if (a.softcap <= 0.f) return;
#pragma unroll
  for (int x = 0; x < 8; ++x) c.u[x] = __fdiv_rn(s[x], a.softcap);
  if (a.use_pwl) {
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

// e at 8 values z = s - m: the PWL exp floored at 0 (with its clipped value
// er and the slope of er's segment), or expf.
__device__ __forceinline__ void grad_exp8(const float (&z)[8], float (&e)[8], float (&er)[8],
                                          float (&slope)[8], const GradArgs& a,
                                          const GradTables& T) {
  if (!a.use_pwl) {
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      e[x] = er[x] = expf(z[x]);
      slope[x] = 0.f;
    }
    return;
  }
  int seg[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) er[x] = fminf(fmaxf(z[x], a.exp_lo), a.exp_hi);
  grad_pwl_n<8>(er, seg, T.e, T.etop);
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    slope[x] = T.es[(a.exp_segs + 1) + seg[x]];
    e[x] = fmaxf(er[x], 0.f);
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

// (p^, dS_ij times scale) of one visible pair: the forward's bf16
// probability; the softmax's gradient (its max's share where z = 0), then
// the cap's (fragment element x of `c`).
__device__ __forceinline__ float2 grad_pair(float z, float e, float er, float slope, float dph,
                                            const GradCap8& c, int x, const GradRow& r,
                                            const GradArgs& a) {
  float g, p;
  if (a.use_pwl) {
    p = __fmul_rn(e, r.norm);
    g = grad_dz(z, er, slope, dph, r, a);
    if (z == 0.f) g = __fadd_rn(g, r.share);
  } else {
    p = __fdiv_rn(e, r.norm);
    g = __fadd_rn(__fmul_rn(p, dph), __fmul_rn(p, -r.ds));
  }
  if (a.softcap > 0.f) {
    g = __fmul_rn(g, a.softcap);
    if (a.use_pwl) {
      g = __fmul_rn(g, c.slope[x]);
      g = __fmul_rn(g, npe_clip_factor(c.u[x], a.tanh_lo, a.tanh_hi));
    } else {
      g = __fmul_rn(__fadd_rn(g, __fmul_rn(g, c.t[x])), __fsub_rn(1.f, c.t[x]));
    }
    g = __fdiv_rn(g, a.softcap);
  }
  return make_float2(__bfloat162float(__float2bfloat16_rn(p)), __fmul_rn(g, a.scale));
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

// Rows q0..q0+15 of q and of dO in registers, 16-byte pieces (rows of D
// contiguous values at 16-byte aligned addresses: the wrapper sees to it),
// zeros past Sq; `grad_put_q` writes them to shared memory, q in bf16
// pieces.  QV pieces of q a thread (f32 q: 4 values a piece), DV of dO.
template <int D>
struct GradQRegs {
  static constexpr int QV = (16 * D / 4 + GT - 1) / GT;
  static constexpr int DV = (16 * D / 8 + GT - 1) / GT;
  uint4 q[QV], d[DV];
  float4 st;
};

template <int D>
__device__ __forceinline__ void grad_fetch_q(const GradArgs& a, int b, int h, int q0,
                                             GradQRegs<D>& r, bool stats) {
  const int per_row = a.q_bf16 ? D / 8 : D / 4;
  const char* qb = static_cast<const char*>(a.q) +
                   (b * a.qs[0] + h * a.qs[1]) * (a.q_bf16 ? 2 : 4);
#pragma unroll
  for (int j = 0; j < GradQRegs<D>::QV; ++j) {
    const int x = threadIdx.x + j * GT, row = x / per_row, piece = x % per_row;
    const bool ok = row < 16 && q0 + row < a.sq;
    r.q[j] = ok ? __ldg(reinterpret_cast<const uint4*>(qb + ((q0 + row) * a.qs[2]) * (a.q_bf16 ? 2 : 4)) + piece)
                : make_uint4(0, 0, 0, 0);
  }
  const __nv_bfloat16* db = a.dout + b * a.dos[0] + h * a.dos[1];
#pragma unroll
  for (int j = 0; j < GradQRegs<D>::DV; ++j) {
    const int x = threadIdx.x + j * GT, row = x / (D / 8), piece = x % (D / 8);
    const bool ok = row < 16 && q0 + row < a.sq;
    r.d[j] = ok ? __ldg(reinterpret_cast<const uint4*>(db + (q0 + row) * a.dos[2]) + piece)
                : make_uint4(0, 0, 0, 0);
  }
  if (stats && threadIdx.x < 16 && q0 + (int)threadIdx.x < a.sq)
    r.st = __ldg(reinterpret_cast<const float4*>(a.stats) +
                 ((long long)(b * a.hq + h) * a.sq + q0 + threadIdx.x));
}

template <int D>
__device__ __forceinline__ void grad_put_q(const GradArgs& a, const GradQRegs<D>& r,
                                           __nv_bfloat16* qp, __nv_bfloat16* dop) {
  constexpr int DS = D + 8;
  const int per_row = a.q_bf16 ? D / 8 : D / 4;
#pragma unroll
  for (int j = 0; j < GradQRegs<D>::QV; ++j) {
    const int x = threadIdx.x + j * GT, row = x / per_row, piece = x % per_row;
    if (row >= 16) continue;
    if (a.q_bf16) {                        // one piece (q_pieces = 1)
      *reinterpret_cast<uint4*>(qp + row * DS + piece * 8) = r.q[j];
    } else {
      const float f[4] = {__uint_as_float(r.q[j].x), __uint_as_float(r.q[j].y),
                          __uint_as_float(r.q[j].z), __uint_as_float(r.q[j].w)};
      float p[4][3];
#pragma unroll
      for (int c = 0; c < 4; ++c) npe_split3(f[c], p[c]);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
        uint2 w = make_uint2(npe_pack_bf16(p[0][pc], p[1][pc]), npe_pack_bf16(p[2][pc], p[3][pc]));
        *reinterpret_cast<uint2*>(qp + (pc * 16 + row) * DS + piece * 4) = w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < GradQRegs<D>::DV; ++j) {
    const int x = threadIdx.x + j * GT, row = x / (D / 8), piece = x % (D / 8);
    if (row < 16) *reinterpret_cast<uint4*>(dop + row * DS + piece * 8) = r.d[j];
  }
}

// cp.async of keys k0..k0+GKC-1 of a (batch, kv head)'s K or V rows into
// shared memory, zeros at and past `end`.
template <int D>
__device__ __forceinline__ void grad_async_keys(const __nv_bfloat16* src, long long stride,
                                                int k0, int end, __nv_bfloat16* dst) {
  constexpr int DS = D + 8;
#pragma unroll
  for (int j = 0; j < GKC * (D / 8) / GT; ++j) {
    const int x = threadIdx.x + j * GT, kr = x / (D / 8), piece = x % (D / 8), key = k0 + kr;
    const bool ok = key < end;
    npe_cp_async16(dst + kr * DS + piece * 8, ok ? src + key * stride + piece * 8 : src,
                   ok ? 16 : 0);
  }
}

// c[2][4] += A (16 rows at `arow`, D wide, `pieces` bf16 pieces 16 rows
// apart) . B^T (16 rows at `brow`): the forward's S = Q.K^T fragments.
template <int D>
__device__ __forceinline__ void grad_mma_nt(float (&c)[2][4], const __nv_bfloat16* arow,
                                            int pieces, const __nv_bfloat16* brow, int lane) {
  constexpr int DS = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t bk[4];
    npe_ldsm_x4(bk, brow + ((lane & 7) + ((lane >> 4) << 3)) * DS + kk * 16 + ((lane >> 3) & 1) * 8);
    for (int pc = 0; pc < pieces; ++pc) {
      uint32_t aq[4];
      npe_ldsm_x4(aq, arow + (pc * 16 + (lane & 15)) * DS + kk * 16 + (lane >> 4) * 8);
      npe_mma_bf16(c[0], aq, bk[0], bk[1]);
      npe_mma_bf16(c[1], aq, bk[2], bk[3]);
    }
  }
}

// The same product with the roles turned: c[2][4] += B . A^T, fragments of
// S^T (rows: the 16 of `brow`; columns: the 16 of `arow`).  Each element
// sums the same products in the same order as grad_mma_nt's.
template <int D>
__device__ __forceinline__ void grad_mma_tn(float (&c)[2][4], const __nv_bfloat16* arow,
                                            int pieces, const __nv_bfloat16* brow, int lane) {
  constexpr int DS = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t ak[4];
    npe_ldsm_x4(ak, brow + (lane & 15) * DS + kk * 16 + (lane >> 4) * 8);
    for (int pc = 0; pc < pieces; ++pc) {
      uint32_t bq[4];
      npe_ldsm_x4(bq, arow + (pc * 16 + (lane & 7) + ((lane >> 4) << 3)) * DS + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      npe_mma_bf16(c[0], ak, bq[0], bq[1]);
      npe_mma_bf16(c[1], ak, bq[2], bq[3]);
    }
  }
}

// acc[NT][4] += A (16 x 16, a fragment) . Y (16 rows at `yrow`, D wide).
template <int D>
__device__ __forceinline__ void grad_mma_acc(float (&acc)[D / 8][4], const uint32_t (&af)[4],
                                             const __nv_bfloat16* yrow, int lane) {
  constexpr int DS = D + 8;
#pragma unroll
  for (int dd = 0; dd < D / 16; ++dd) {
    uint32_t bv[4];
    npe_ldsm_x4_trans(bv, yrow + ((lane & 7) + ((lane >> 3) & 1) * 8) * DS + dd * 16 +
                              (lane >> 4) * 8);
    npe_mma_bf16(acc[2 * dd], af, bv[0], bv[1]);
    npe_mma_bf16(acc[2 * dd + 1], af, bv[2], bv[3]);
  }
}

template <int D>
struct GradLayout {
  static constexpr int DS = D + 8;
  static constexpr int CHUNK = GKC * DS;             // a K or V chunk
  static constexpr int QP = Q_PIECES_MAX * 16 * DS;  // q pieces
  static constexpr int DO = 16 * DS;
  // the q kernel: a two-stage ring of (K, V) chunks and GW tiles of q's
  // pieces and dO (one piece for bf16 q: two blocks an SM); the kv kernel:
  // one K and one V chunk, one tile
  static size_t q_bytes(int pieces) {
    return sizeof(__nv_bfloat16) * (4 * CHUNK + GW * (pieces * 16 * DS + DO));
  }
  static constexpr size_t kv_bytes = sizeof(__nv_bfloat16) * (2 * CHUNK + QP + DO);
};

template <int D>
__global__ void __launch_bounds__(GT)
dense_grad_q_kernel(const GradArgs a) {
  using L = GradLayout<D>;
  constexpr int DS = L::DS;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // K0 V0 K1 V1
  const int qtile = a.q_pieces * 16 * DS;                              // a tile's q pieces
  __nv_bfloat16* qp = ring + 4 * L::CHUNK;                            // GW tiles of them
  __nv_bfloat16* dop = qp + GW * qtile;
  __shared__ GradTables T;

  const int b = blockIdx.y / a.hq, h = blockIdx.y % a.hq, hk = h / (a.hq / a.hkv);
  const int q0 = blockIdx.x * GQ;                          // the block's first row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int w0 = q0 + 16 * warp;                           // the warp's first row
  const __nv_bfloat16* kg = a.k + b * a.ks[0] + hk * a.ks[1];
  const __nv_bfloat16* vg = a.v + b * a.vs[0] + hk * a.vs[1];
  const int off = a.skv - a.sq;
  // the keys some row of the block sees
  const int kv_lo = a.window > 0 ? max(0, off + q0 - a.window + 1) : 0;
  const int kv_hi = a.causal ? off + min(q0 + GQ, a.sq) : a.skv;
  const int nc = (kv_hi - kv_lo + GKC - 1) / GKC, items = 4 * nc;
  // ... and those the warp's rows see
  const int wlo = a.window > 0 ? max(0, off + w0 - a.window + 1) : 0;
  const int whi = a.causal ? off + min(w0 + 16, a.sq) : a.skv;

  // item it: phase it / nc, chunk it % nc; K always, V from phase 1 on
  auto issue = [&](int it) {
    __nv_bfloat16* kd = ring + (it & 1) * 2 * L::CHUNK;
    const int c0 = kv_lo + (it % nc) * GKC;
    grad_async_keys<D>(kg, a.ks[2], c0, kv_hi, kd);
    if (it >= nc) grad_async_keys<D>(vg, a.vs[2], c0, kv_hi, kd + L::CHUNK);
  };
  issue(0);
  npe_cp_async_commit();
  __nv_bfloat16* wq = qp + warp * qtile;
  __nv_bfloat16* wdo = dop + warp * L::DO;
  for (int t = 0; t < GW; ++t) {           // the block's tiles, all threads staging each
    GradQRegs<D> qr;
    grad_fetch_q<D>(a, b, h, q0 + 16 * t, qr, false);
    grad_put_q<D>(a, qr, qp + t * qtile, dop + t * L::DO);
  }
  grad_tables(T, a);                       // ends synced: q and dO staged too

  int pos[2];
  bool valid[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = w0 + g + 8 * e;
    valid[e] = i < a.sq;
    pos[e] = off + i;
  }
  float m[2] = {NEG_BIG, NEG_BIG}, sum[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f}, ties[2] = {0.f, 0.f};
  float gsum[2] = {0.f, 0.f};
  GradRow row[2];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // a row's sum (or max) over its quad of lanes, which hold its keys
  auto quad_reduce = [&](float (&v)[2], bool is_max) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float y = __shfl_xor_sync(0xffffffffu, v[e], o);
        v[e] = is_max ? fmaxf(v[e], y) : __fadd_rn(v[e], y);
      }
  };

  // phase 0: the max; 1: S, dr, ties; 2: the sum of dz (PWL) or of p dp;
  // 3: dS into dQ.  Each warp takes its 16 rows over all of a chunk's keys.
  for (int it = 0; it < items; ++it) {
    const int phase = it / nc, c0 = kv_lo + (it % nc) * GKC;
    __syncthreads();                       // every warp is done with item it - 1's stage
    if (it + 1 < items) issue(it + 1);
    npe_cp_async_commit();
    npe_cp_async_wait<1>();
    __syncthreads();                       // item it is staged
    const __nv_bfloat16* ks_ = ring + (it & 1) * 2 * L::CHUNK;
    const __nv_bfloat16* vs_ = ks_ + L::CHUNK;
    if (c0 < whi && c0 + GKC > wlo) {
#pragma unroll
      for (int k16 = 0; k16 < GKC / 16; ++k16) {
        const int kc = c0 + 16 * k16;
        if (kc >= whi || kc + 16 <= wlo) continue;
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        grad_mma_nt<D>(s, wq, a.q_pieces, ks_ + k16 * 16 * DS, lane);
        if (phase > 0) grad_mma_nt<D>(dp, wdo, 1, vs_ + k16 * 16 * DS, lane);
        float sv[8], dph[8], ds[8];
        bool vis[8];
        GradCap8 cap;
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int e = (x >> 1) & 1;
          const int col = kc + (x >> 2) * 8 + 2 * t4 + (x & 1);
          vis[x] = valid[e] && !grad_masked(col, pos[e], a);
          sv[x] = s[x >> 2][x & 3];
          dph[x] = __bfloat162float(__float2bfloat16_rn(dp[x >> 2][x & 3]));
          ds[x] = 0.f;
        }
        grad_scores8(sv, cap, a, T);
        if (phase == 0) {
#pragma unroll
          for (int x = 0; x < 8; ++x) m[(x >> 1) & 1] = fmaxf(m[(x >> 1) & 1], vis[x] ? sv[x] : NEG_BIG);
        } else {
          float z[8], ev[8], er[8], sl[8];
#pragma unroll
          for (int x = 0; x < 8; ++x) z[x] = __fsub_rn(sv[x], row[(x >> 1) & 1].m);
          grad_exp8(z, ev, er, sl, a, T);
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int e = (x >> 1) & 1;
            if (!vis[x]) continue;
            if (phase == 1) {
              sum[e] = __fadd_rn(sum[e], ev[x]);
              dr[e] = __fadd_rn(dr[e], __fmul_rn(dph[x], ev[x]));
              ties[e] += z[x] == 0.f ? 1.f : 0.f;
            } else if (phase == 2) {
              gsum[e] = __fadd_rn(gsum[e], a.use_pwl
                  ? grad_dz(z[x], er[x], sl[x], dph[x], row[e], a)
                  : __fmul_rn(__fdiv_rn(ev[x], row[e].norm), dph[x]));
            } else {
              ds[x] = grad_pair(z[x], ev[x], er[x], sl[x], dph[x], cap, x, row[e], a).y;
            }
          }
        }
        if (phase == 3) {
          uint32_t af[3][4];
          grad_split_frag(ds, af);
#pragma unroll
          for (int j = 0; j < 3; ++j) grad_mma_acc<D>(acc, af[j], ks_ + k16 * 16 * DS, lane);
        }
      }
    }
    if (it % nc != nc - 1) continue;
    // the phase's last chunk: each warp finishes its own rows
    if (phase == 0) {
      quad_reduce(m, true);
#pragma unroll
      for (int e = 0; e < 2; ++e) row[e].m = m[e];
    } else if (phase == 1) {
      quad_reduce(sum, false);
      quad_reduce(dr, false);
      quad_reduce(ties, false);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sc = fmaxf(sum[e], 1e-30f);
        if (!a.use_pwl) {
          row[e].norm = sc;
          continue;
        }
        row[e].norm = npe_recip_via_prefix(sc, T.r, T.rtop);
        // sc = mant * 2^ex with mant in [0.5, 1): 1/sc = pwl(mant) * 2^-ex
        const int bits = __float_as_int(sc);
        const int ex = ((bits >> 23) & 0xff) - 126;
        const float mant = __int_as_float((bits & 0x007fffff) | (126 << 23));
        float gs = ldexpf(dr[e], -ex);
        gs = __fmul_rn(gs, npe_pwl_slope(fminf(fmaxf(mant, a.recip_lo), a.recip_hi), T.rs,
                                         a.recip_segs));
        gs = __fmul_rn(gs, npe_clip_factor(mant, a.recip_lo, a.recip_hi));
        row[e].ds = __fmul_rn(ldexpf(gs, -ex), npe_max_factor(sum[e], 1e-30f));
      }
    } else if (phase == 2) {
      quad_reduce(gsum, false);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (a.use_pwl) {
          row[e].share = ties[e] > 0.f ? __fdiv_rn(-gsum[e], ties[e]) : 0.f;
        } else {
          row[e].ds = gsum[e];
          row[e].share = 0.f;
        }
        if (t4 == 0 && valid[e]) {
          float4* st = reinterpret_cast<float4*>(a.stats) +
                       ((long long)blockIdx.y * a.sq + w0 + g + 8 * e);
          *st = make_float4(row[e].m, row[e].norm, row[e].ds, row[e].share);
        }
      }
    }
  }

  // dq: the warp's accumulators, in q's dtype
  const long long qbase = (long long)blockIdx.y * a.sq * D;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = w0 + g + 8 * (e >> 1);
      if (i >= a.sq) continue;
      const long long o = qbase + (long long)i * D + n * 8 + 2 * t4 + (e & 1);
      if (a.q_bf16)
        static_cast<__nv_bfloat16*>(a.dq)[o] = __float2bfloat16_rn(acc[n][e]);
      else
        static_cast<float*>(a.dq)[o] = acc[n][e];
    }
  npe_cp_async_wait<0>();
}

template <int D>
__global__ void __launch_bounds__(GT)
dense_grad_kv_kernel(const GradArgs a) {
  using L = GradLayout<D>;
  constexpr int DS = L::DS;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks_ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs_ = ks_ + L::CHUNK;
  __nv_bfloat16* qp = ks_ + 2 * L::CHUNK;
  __nv_bfloat16* dop = qp + L::QP;
  __shared__ GradRow st[16];
  __shared__ GradTables T;

  const int b = blockIdx.y / a.hq, h = blockIdx.y % a.hq, hk = h / (a.hq / a.hkv);
  const int k0 = blockIdx.x * GKC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int off = a.skv - a.sq;
  grad_async_keys<D>(a.k + b * a.ks[0] + hk * a.ks[1], a.ks[2], k0, a.skv, ks_);
  grad_async_keys<D>(a.v + b * a.vs[0] + hk * a.vs[1], a.vs[2], k0, a.skv, vs_);
  npe_cp_async_commit();

  // the queries that see a key of this block: position >= k0 (causal) and
  // < the last key + window (window > 0)
  const int i_lo = a.causal ? max(0, k0 - off) : 0;
  const int i_hi = a.window > 0 ? min(a.sq - 1, k0 + GKC - 2 + a.window - off) : a.sq - 1;
  const int t_lo = (i_lo / 16) * 16;
  GradQRegs<D> qr;
  if (t_lo <= i_hi) grad_fetch_q<D>(a, b, h, t_lo, qr, true);
  grad_tables(T, a);
  npe_cp_async_wait<0>();
  const int kw = k0 + warp * 16;
  float acc_v[NT][4], acc_k[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[n][e] = acc_k[n][e] = 0.f;

  for (int q0 = t_lo; q0 <= i_hi; q0 += 16) {
    __syncthreads();                       // every warp is done with the last tile
    grad_put_q<D>(a, qr, qp, dop);
    if (threadIdx.x < 16) st[threadIdx.x] = GradRow{qr.st.x, qr.st.y, qr.st.z, qr.st.w};
    __syncthreads();
    if (q0 + 16 <= i_hi) grad_fetch_q<D>(a, b, h, q0 + 16, qr, true);   // in flight meanwhile
    if (kw >= a.skv) continue;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    grad_mma_tn<D>(s, qp, a.q_pieces, ks_ + warp * 16 * DS, lane);
    grad_mma_tn<D>(dp, dop, 1, vs_ + warp * 16 * DS, lane);
    // fragment x: key kw + g + 8 ((x >> 1) & 1), query q0 + 8 (x >> 2) + 2 t4 + (x & 1)
    float sv[8], z[8], ev[8], er[8], sl[8], p[8], ds[8];
    GradCap8 cap;
#pragma unroll
    for (int x = 0; x < 8; ++x) sv[x] = s[x >> 2][x & 3];
    grad_scores8(sv, cap, a, T);
#pragma unroll
    for (int x = 0; x < 8; ++x) z[x] = __fsub_rn(sv[x], st[8 * (x >> 2) + 2 * t4 + (x & 1)].m);
    grad_exp8(z, ev, er, sl, a, T);
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int key = kw + g + 8 * ((x >> 1) & 1);
      const int qi = 8 * (x >> 2) + 2 * t4 + (x & 1);
      p[x] = ds[x] = 0.f;
      if (q0 + qi >= a.sq || grad_masked(key, off + q0 + qi, a)) continue;
      const float dph = __bfloat162float(__float2bfloat16_rn(dp[x >> 2][x & 3]));
      const float2 pd = grad_pair(z[x], ev[x], er[x], sl[x], dph, cap, x, st[qi], a);
      p[x] = pd.x;
      ds[x] = pd.y;
    }
    const uint32_t ap[4] = {npe_pack_bf16(p[0], p[1]), npe_pack_bf16(p[2], p[3]),
                            npe_pack_bf16(p[4], p[5]), npe_pack_bf16(p[6], p[7])};
    grad_mma_acc<D>(acc_v, ap, dop, lane);
    uint32_t af[3][4];
    grad_split_frag(ds, af);
    for (int pc = 0; pc < a.q_pieces; ++pc)
#pragma unroll
      for (int j = 0; j < 3; ++j) grad_mma_acc<D>(acc_k, af[j], qp + pc * 16 * DS, lane);
  }

  const long long base = (long long)blockIdx.y * a.skv * D;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kw + g + 8 * (e >> 1);
      if (key >= a.skv) continue;
      const long long o = base + (long long)key * D + n * 8 + 2 * t4 + (e & 1);
      a.dv[o] = acc_v[n][e];
      a.dk[o] = acc_k[n][e];
    }
}

template <int D>
int launch_dense_grad(const GradArgs& a, int batch, cudaStream_t stream) {
  using L = GradLayout<D>;
  static size_t granted_q = 0, granted_kv = 0;
  const size_t q_bytes = L::q_bytes(a.q_pieces);
  if (int err = allow_smem(dense_grad_q_kernel<D>, q_bytes, granted_q)) return err;
  if (int err = allow_smem(dense_grad_kv_kernel<D>, L::kv_bytes, granted_kv)) return err;
  dense_grad_q_kernel<D><<<dim3((a.sq + GQ - 1) / GQ, batch * a.hq), GT, q_bytes, stream>>>(a);
  if (const cudaError_t err = cudaGetLastError()) return (int)err;
  dense_grad_kv_kernel<D><<<dim3((a.skv + GKC - 1) / GKC, batch * a.hq), GT, L::kv_bytes,
                            stream>>>(a);
  return (int)cudaGetLastError();
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
    const float* tanh_table, int tanh_segments, float tanh_lo, float tanh_hi, void* stream) {
  if (exp_segments < 1 || exp_segments + 1 > NPE_MAX_TABLE_COLS ||
      recip_segments < 1 || recip_segments + 1 > NPE_MAX_TABLE_COLS ||
      hkv < 1 || hq % hkv != 0 || kv_len < sq || kv_len > skv || window < 0 ||
      !(softcap >= 0.f) ||
      (softcap > 0.f && use_pwl &&
       (tanh_table == nullptr || tanh_segments < 1 || tanh_segments + 1 > NPE_MAX_TABLE_COLS)))
    return (int)cudaErrorInvalidValue;
  // K and V are the bf16 cache, read as 16-byte vectors
  if (!(vec_ok(k, ksb, ksh, kss, ksd) && vec_ok(v, vsb, vsh, vss, vsd)))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || hq <= 0 || sq <= 0) return 0;
  Args a{q, k, v, out,
         {qsb, qsh, qss, qsd}, {ksb, ksh, kss, ksd}, {vsb, vsh, vss, vsd},
         {osb, osh, oss, osd},
         hq, hkv, sq, kv_len, q_bf16, /*kv_bf16=*/1, out_bf16,
         causal ? 1 : 0, window, use_pwl, /*block_q=*/sq, /*block_kv=*/DENSE_SEG, scale,
         /*q_pieces=*/q_bf16 ? 1 : Q_PIECES_MAX,
         exp_table, exp_segments, recip_table, recip_segments,
         softcap, tanh_table, tanh_segments, tanh_lo, tanh_hi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_dense<32>(a, batch, s);
    case 64: return launch_dense<64>(a, batch, s);
    case 128: return launch_dense<128>(a, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int npe_attention_dense_grad(
    const void* q, const void* k, const void* v, const void* dout, void* dq, float* dk_part,
    float* dv_part, float* stats,
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
      hkv < 1 || hq % hkv != 0 || sq > skv || window < 0 || !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  // q, K, V and dO rows are read as 16-byte vectors
  if (!(vec_ok(k, ksb, ksh, kss, ksd) && vec_ok(v, vsb, vsh, vss, vsd) &&
        vec_ok(dout, dsb, dsh, dss, dsd) && vec_ok(q, qsb, qsh, qss, qsd)))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || hq <= 0 || sq <= 0) return 0;
  GradArgs a{q, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
             static_cast<const __nv_bfloat16*>(dout), dq, dk_part, dv_part, stats,
             {qsb, qsh, qss, qsd}, {ksb, ksh, kss, ksd}, {vsb, vsh, vss, vsd},
             {dsb, dsh, dss, dsd},
             hq, hkv, sq, skv, q_bf16, q_bf16 ? 1 : Q_PIECES_MAX, causal ? 1 : 0, window,
             use_pwl, scale, softcap,
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
