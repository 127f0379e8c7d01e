// Flash attention on Hopper with the NVU's PWL exp and PWL reciprocal.
//
// Replaces: flash_attention / _flash_kernel in
// src/repro/kernels/flash_attention.py (the Pallas call at :130).
// Bound on this card: bytes at the serving shapes.  A decode step reads the
// whole visible cache (2 x kv_len x D values a head) for one query, one
// multiply-add per value; a 128-token prefill does 128 times the work on
// the same bytes and is still below the f32 rate's line with PWL exp (some
// fifty operations a score).
// Design, simple and right first: one block of 128 threads for each
// (batch x q-head, tile of 16 query rows); each warp owns 4 rows and keeps
// their running max, sum and accumulator in registers (every lane the
// same max and sum, D/32 accumulator columns a lane).  Keys are taken one
// KV block of `block_kv` at a time, exactly as the TPU kernel blocks them:
// with PWL exp the online rescale by pwl_exp(m_prev - m_new) makes the
// result depend on the blocking, so the kernel never re-blocks.  In a
// block, K tiles of 64 keys are staged in shared memory as f32 (rows padded
// to D+1 floats, so the lanes of a warp, one key each, hit distinct banks),
// the block's scores go to shared memory, each warp takes the max, the
// exp and the sum of its rows, and V tiles are staged the same way for the
// P.V product.  A block that a row's logical q block (`block_q` rows) does
// not see is skipped for that row, by the TPU kernel's rule, so the
// arithmetic is the reference's row for row.  The mask is end-aligned (query
// i at position kv_len - Sq + i) and keys at or past kv_len are never read,
// so decode reads the cache in place; q, k, v and out are addressed through
// element strides, so the caller hands permuted views without a copy.
// CUDA cores only: the tensor cores (wgmma) are later work.
#include "pwl.cuh"

namespace {

constexpr int BQ = 16;           // query rows a block
constexpr int WARPS = 4;
constexpr int RPW = BQ / WARPS;  // rows a warp
constexpr int TK = 64;           // keys a staged tile
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
  const float* exp_table;
  int exp_segs;
  const float* recip_table;
  int recip_segs;
};

__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// `_exp_fn`: clamp at -18, PWL exp floored at 0; or expf.
__device__ __forceinline__ float attn_exp(float z, const Args& a, const float* etab) {
  if (a.use_pwl) return fmaxf(npe_pwl(fmaxf(z, -18.f), etab, a.exp_segs), 0.f);
  return expf(z);
}

template <int D>
__global__ void __launch_bounds__(32 * WARPS)
flash_attention_kernel(const Args a) {
  constexpr int DP = D + 1;        // padded row of a staged K or V tile
  constexpr int CPL = D / 32;      // accumulator columns a lane
  extern __shared__ float smem[];
  float* q_s = smem;               // BQ x D, scaled
  float* kv_s = q_s + BQ * D;      // TK x DP
  float* s_s = kv_s + TK * DP;     // BQ x block_kv: a block's scores, then p
  __shared__ float etab[3 * NPE_MAX_TABLE_COLS];
  __shared__ float rtab[3 * NPE_MAX_TABLE_COLS];
  if (a.use_pwl) {
    npe_load_table(etab, a.exp_table, a.exp_segs + 1);
    npe_load_table(rtab, a.recip_table, a.recip_segs + 1);
  }

  const int bh = blockIdx.y;
  const int b = bh / a.hq, h = bh % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = blockIdx.x * BQ;
  const int off = a.kv_len - a.sq;  // position of query 0
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
  int pos[RPW], q_lo[RPW], q_hi[RPW];
  bool valid[RPW];
  float m[RPW], l[RPW], corr[RPW], acc[RPW][CPL];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int i = q0 + warp * RPW + j;
    valid[j] = i < a.sq;
    pos[j] = off + i;
    const int qb = i / a.block_q;      // the row's logical q block
    q_lo[j] = off + qb * a.block_q;
    q_hi[j] = off + min(qb * a.block_q + a.block_q, a.sq) - 1;
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
      bool r = valid[j];
      if (a.causal) {
        r = r && kb0 <= q_hi[j];
        if (a.window > 0) r = r && kb0 + a.block_kv - 1 >= q_lo[j] - a.window + 1;
      }
      run[j] = r;
      any |= r;
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
                                                  c * a.ks[3], a.kv_bf16)
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
          const bool masked = (a.causal && col > pos[j]) ||
                              (a.window > 0 && col <= pos[j] - a.window);
          sr[t0 + t] = masked ? NEG_BIG : dot;
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
        const int col = kb0 + t;
        const bool masked = (a.causal && col > pos[j]) ||
                            (a.window > 0 && col <= pos[j] - a.window);
        const float p = masked ? 0.f : attn_exp(__fsub_rn(sr[t], m_new), a, etab);
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
                                                  c * a.vs[3], a.kv_bf16)
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

  // out = acc / max(l, 1e-30), by the PWL reciprocal or a divide
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    if (!valid[j]) continue;
    const float ls = fmaxf(l[j], 1e-30f);
    const float inv = a.use_pwl ? npe_recip_via_pwl(ls, rtab, a.recip_segs)
                                : __fdiv_rn(1.f, ls);
    const int i = q0 + warp * RPW + j;
    const long long obase = b * a.os[0] + h * a.os[1] + i * a.os[2];
#pragma unroll
    for (int e = 0; e < CPL; ++e) {
      const float y = __fmul_rn(acc[j][e], inv);
      const long long o = obase + (lane + 32 * e) * a.os[3];
      if (a.out_bf16)
        static_cast<__nv_bfloat16*>(a.out)[o] = npe_from_f32<__nv_bfloat16>(y);
      else
        static_cast<float*>(a.out)[o] = y;
    }
  }
}

template <int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + TK * (D + 1) + (size_t)BQ * a.block_kv);
  static size_t granted = 48 * 1024;   // dynamic shared memory allowed so far
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  const dim3 grid((a.sq + BQ - 1) / BQ, batch * a.hq);
  flash_attention_kernel<D><<<grid, 32 * WARPS, smem, stream>>>(a);
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
  if (batch <= 0 || hq <= 0 || sq <= 0) return 0;
  Args a{q, k, v, out,
         {qsb, qsh, qss, qsd}, {ksb, ksh, kss, ksd}, {vsb, vsh, vss, vsd},
         {osb, osh, oss, osd},
         hq, hkv, sq, kv_len, q_bf16, kv_bf16, out_bf16,
         causal, window, use_pwl, block_q, block_kv, scale,
         exp_table, exp_segments, recip_table, recip_segments};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(a, batch, s);
    case 64: return launch<64>(a, batch, s);
    case 128: return launch<128>(a, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
