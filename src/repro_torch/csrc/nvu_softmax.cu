// NVU row softmax on Hopper: scale, max, PWL exp, sum, PWL reciprocal.
//
// Replaces: nvu_softmax_rows / _softmax_kernel (and recip_via_pwl) in
// src/repro/kernels/nvu_softmax.py.
// Bound on this card: bytes.  Each score is read once and each probability
// written once (8 bytes an element f32 -> f32, 6 f32 -> bf16) against some
// twenty operations.
// Design: a warp owns whole rows, several at once.  Lane l holds columns
// l + 32j of each row in registers, loaded once (coalesced 128-byte
// transactions) and never read again; the max and the sum are warp-shuffle
// reductions, with no shared memory and no __syncthreads after the tables
// are staged.  A warp takes R rows together (R * VPT loads in flight a lane),
// so an SM holds enough independent loads to cover the memory latency that
// one row's dependent chain (load, max, exp, sum, reciprocal, store) leaves
// open.  Blocks of 256 threads loop over their rows; the grid is the blocks
// the card holds at once, or fewer, so the tables are staged once a block.
// The exp is the prefix-table PWL (npe_softmax_exp_n: a binary search over
// the knots, bit-identical to the delta walk); 1/sum is the PWL reciprocal of
// the mantissa, by a search of the recip table's prefix form, with the
// exponent handled by integer bit operations (npe_softmax_inv), so the
// kernel has no divide.  Lane i takes the reciprocal of the warp's row i
// and hands it on by a shuffle: one search a lane, not one a row a lane.
// The two tables are built while the first rows' loads are in flight.
// Order of addition: lane l adds its values in ascending j, then the
// npe_warp_sum butterfly, so the f32 result is bit for bit that of the
// first port's kernel (a warp per row, the walk).
// Options: x is multiplied by `scale` (one f32 multiply, before the max) and
// the result is f32 or bf16 (the f32 probability rounded to nearest even),
// which fold the encoder's `* d**-0.5` and `.to(bf16)` into this launch.  The
// causal option masks column c of row r when c > r % q + (n - q): the last
// query of each (q, n) matrix sees the last key, as the reference oracle
// (kernels/ref.py) has it.  The limit option is the masked softmax of the
// npec executor (core/nvu.nvu_softmax with `where`): row r sees columns
// c < limit[r / limit_rows] (limit_rows 1: a value a row; q: a value a (q, n)
// matrix).  A masked column takes no part in the max, its exp is 0 before
// the sum, and it is written as 0; a row with no visible column is all 0.
#include "pwl.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
static_assert(THREADS >= NPE_PREFIX_KNOTS, "a thread fetches each knot slot and column");

template <int VPT, int R, typename TO, bool FULL>
__global__ void __launch_bounds__(THREADS)
nvu_softmax_kernel(const float* __restrict__ x, TO* __restrict__ y, int rows, int n,
                   int causal_rows, const int* __restrict__ limit, int limit_rows, float scale,
                   const float* __restrict__ exp_table, int exp_segs,
                   const float* __restrict__ recip_table, int recip_segs) {
  __shared__ NpePrefixTable etab, rtab;
  const NpePrefixFetch efetch(exp_table, exp_segs), rfetch(recip_table, recip_segs);
  const int lane = threadIdx.x & 31;
  const int step = gridDim.x * WARPS * R;
  int r0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * R;

  // x of rows r0..r0+R-1 as loaded (a row past the last reads the last)
  float v[R * VPT];
  auto load = [&]() {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float* xr = x + (size_t)min(r0 + i, rows - 1) * n;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int c = lane + 32 * j;
        v[i * VPT + j] = FULL || c < n ? xr[c] : 0.f;
      }
    }
  };
  load();                                          // in flight during the build
  npe_build_prefix_tables(etab, efetch, exp_segs, rtab, rfetch, recip_segs);
  const int etop = npe_prefix_top(exp_segs), rtop = npe_prefix_top(recip_segs);

  const float neg_inf = __int_as_float(0xff800000);
  while (r0 < rows) {
    float m[R];
    int vis[R];          // limit mode: columns c < vis[i] of row r0 + i are visible
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int visible = n;   // columns c < visible are unmasked
      if (!FULL && causal_rows > 0) visible = (r0 + i) % causal_rows + (n - causal_rows) + 1;
      vis[i] = n;
      if (!FULL && limit != nullptr)
        vis[i] = limit[min(r0 + i, rows - 1) / limit_rows];
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int c = lane + 32 * j;
        float& t = v[i * VPT + j];
        t = FULL ? __fmul_rn(t, scale)
                 : (c < n && c < vis[i] ? (c < visible ? __fmul_rn(t, scale) : -1e30f)
                                         : neg_inf);
      }
      m[i] = v[i * VPT];
#pragma unroll
      for (int j = 1; j < VPT; ++j) m[i] = fmaxf(m[i], v[i * VPT + j]);
      m[i] = npe_warp_max(m[i]);
      if (!FULL && limit != nullptr && m[i] == neg_inf) m[i] = 0.f;   // no visible column
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < VPT; ++j) v[i * VPT + j] = __fsub_rn(v[i * VPT + j], m[i]);
    npe_softmax_exp_n<R * VPT>(v, etab, etop);   // one search per value, all rows at once
    // each row's sum: lane l adds columns l + 32j in ascending j, then the
    // butterfly; lane i then takes the reciprocal of row i's sum for the warp
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (!FULL && (lane + 32 * j >= n || lane + 32 * j >= vis[i])) v[i * VPT + j] = 0.f;
        s = __fadd_rn(s, v[i * VPT + j]);
      }
      s = npe_warp_sum(s);
      mine = lane % R == i ? s : mine;
    }
    const float inv_mine = npe_softmax_inv(mine, rtab, rtop);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = r0 + i;
      const float inv = __shfl_sync(0xffffffffu, inv_mine, i);
      if (row >= rows) break;
      TO* yr = y + (size_t)row * n;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int c = lane + 32 * j;
        if (FULL || c < n) yr[c] = npe_from_f32<TO>(__fmul_rn(v[i * VPT + j], inv));
      }
    }
    r0 += step;
    if (r0 < rows) load();
  }
}

// Blocks for `rows`: enough for every warp to take R rows once, at most the
// blocks the card holds at once (the rest by the loop).
template <int VPT, int R, typename TO, bool FULL>
int launch_softmax(const float* x, void* y, int rows, int n, int causal_rows, const int* limit,
                   int limit_rows, float scale, const float* et, int es, const float* rt,
                   int rs, cudaStream_t stream) {
  static int resident = 0;
  if (resident == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &resident, nvu_softmax_kernel<VPT, R, TO, FULL>, THREADS, 0) != cudaSuccess ||
        resident < 1)
      resident = 1;
  }
  const long long need = ((long long)rows + WARPS * R - 1) / (WARPS * R);
  const long long cap = (long long)npe_sm_count() * resident;
  const int blocks = (int)(need < cap ? need : cap);
  nvu_softmax_kernel<VPT, R, TO, FULL><<<blocks, THREADS, 0, stream>>>(
      x, static_cast<TO*>(y), rows, n, causal_rows, limit, limit_rows, scale, et, es, rt, rs);
  return (int)cudaGetLastError();
}

// FULL: rows of exactly 32 * VPT columns and no mask, so no column test.
template <int VPT, int R, typename TO>
int launch_full_or_not(const float* x, void* y, int rows, int n, int causal_rows,
                       const int* limit, int limit_rows, float scale, const float* et, int es,
                       const float* rt, int rs, cudaStream_t s) {
  if (n == 32 * VPT && causal_rows == 0 && limit == nullptr)
    return launch_softmax<VPT, R, TO, true>(x, y, rows, n, 0, nullptr, 1, scale, et, es, rt,
                                            rs, s);
  return launch_softmax<VPT, R, TO, false>(x, y, rows, n, causal_rows, limit, limit_rows, scale,
                                           et, es, rt, rs, s);
}

// R rows a warp: R * VPT values in flight a lane, about 16.
template <typename TO>
int launch_n(const float* x, void* y, int rows, int n, int causal_rows, const int* limit,
             int limit_rows, float scale, const float* et, int es, const float* rt, int rs,
             cudaStream_t s) {
#define NPE_SOFTMAX_ARGS x, y, rows, n, causal_rows, limit, limit_rows, scale, et, es, rt, rs, s
  if (n <= 32) return launch_full_or_not<1, 8, TO>(NPE_SOFTMAX_ARGS);
  if (n <= 64) return launch_full_or_not<2, 8, TO>(NPE_SOFTMAX_ARGS);
  if (n <= 128) return launch_full_or_not<4, 4, TO>(NPE_SOFTMAX_ARGS);
  if (n <= 256) return launch_full_or_not<8, 2, TO>(NPE_SOFTMAX_ARGS);
  if (n <= 512) return launch_full_or_not<16, 1, TO>(NPE_SOFTMAX_ARGS);
  return launch_full_or_not<32, 1, TO>(NPE_SOFTMAX_ARGS);
#undef NPE_SOFTMAX_ARGS
}

// --- the backward: d(loss)/d(x) of the reference's nvu_softmax -------------
// jax.grad of core/nvu.py's nvu_softmax of x * scale, chain rule for chain
// rule: the reciprocal's slope at the mantissa of max(sum, 1e-30), times
// 2^-e twice (ldexp and frexp), 1/2 where the sum ties 1e-30; the exp's
// segment slope, 1/2 where the PWL ties 0 (jnp.maximum) and at an end of
// its clip; the term through the row max, split evenly among tied maxima
// and not cancelled (the PWL exp's slopes are not the exp).  Masked columns
// (causal or limit) get 0, and a row with no visible column is all 0.
// Design: the forward's.  Blocks of 256 threads loop over their rows (the
// grid is the blocks the card holds at once, or fewer), each staging the
// exp and recip tables once in prefix form, with their segments' slopes.  A
// warp takes R rows together, lane l holding columns l + 32j of each (NPL a
// lane), x and dy loaded once into registers.  One search a score gives the
// exp's value and its slope at the same segment (npe_pwl_prefix_slope_n:
// the walk's value and npe_pwl_slope's slope bit for bit); lane i takes row
// i's reciprocal and its slope, handed on by shuffles.  Order of addition: lane-ascending j,
// then the npe_warp_sum butterfly, for the sum, the tie count, sum dy * e
// and the max's share, so dx is bit for bit that of the first backward
// kernel (a warp a row, the walks).
// Bound on this card: bytes (x and dy read once, dx written once).
template <typename TD, int NPL, int R>
__global__ void __launch_bounds__(THREADS)
nvu_softmax_grad_kernel(const float* __restrict__ x, const TD* __restrict__ dy,
                        float* __restrict__ dx, int rows, int n, int causal_rows,
                        const int* __restrict__ limit, int limit_rows, float scale,
                        const float* __restrict__ exp_table, const float* __restrict__ exp_slopes,
                        int exp_segs, float exp_lo, float exp_hi,
                        const float* __restrict__ recip_table,
                        const float* __restrict__ recip_slopes, int recip_segs, float recip_lo,
                        float recip_hi) {
  __shared__ NpePrefixTable etab, rtab;
  __shared__ float eslope[NPE_MAX_TABLE_COLS], rslope[NPE_MAX_TABLE_COLS];
  const NpePrefixFetch efetch(exp_table, exp_segs), rfetch(recip_table, recip_segs);
  const int lane = threadIdx.x & 31;
  const int step = gridDim.x * WARPS * R;
  int r0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * R;
  constexpr int V = R * NPL;

  // x and dy of rows r0..r0+R-1 as loaded (a row past the last reads the last)
  float z[V], g[V];
  auto load = [&]() {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const size_t base = (size_t)min(r0 + i, rows - 1) * n;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int c = lane + 32 * j;
        z[i * NPL + j] = c < n ? x[base + c] : 0.f;
        g[i * NPL + j] = c < n ? npe_to_f32(dy[base + c]) : 0.f;
      }
    }
  };
  load();                                          // in flight during the build
  // the slope tables' row 1: the reference's S slopes
  if ((int)threadIdx.x < exp_segs) eslope[threadIdx.x] = exp_slopes[exp_segs + 1 + threadIdx.x];
  if ((int)threadIdx.x < recip_segs)
    rslope[threadIdx.x] = recip_slopes[recip_segs + 1 + threadIdx.x];
  npe_build_prefix_tables(etab, efetch, exp_segs, rtab, rfetch, recip_segs);
  const int etop = npe_prefix_top(exp_segs), rtop = npe_prefix_top(recip_segs);

  const float neg_inf = __int_as_float(0xff800000);
  while (r0 < rows) {
    int vis[R];                                    // columns c < vis[i] take part
    float m[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = min(r0 + i, rows - 1);
      vis[i] = n;
      if (causal_rows) vis[i] = min(n, row % causal_rows + (n - causal_rows) + 1);
      if (limit != nullptr) vis[i] = min(n, max(limit[row / limit_rows], 0));
      m[i] = neg_inf;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        float& t = z[i * NPL + j];
        t = lane + 32 * j < vis[i] ? __fmul_rn(t, scale) : neg_inf;
        m[i] = fmaxf(m[i], t);
      }
      m[i] = npe_warp_max(m[i]);
    }
    // the tied maxima, z - m, and e (er) of each visible column with its
    // slope, one search a score
    float er[V], sl[V], ties[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      ties[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int v = i * NPL + j;
        if (lane + 32 * j < vis[i]) {
          ties[i] += z[v] == m[i] ? 1.f : 0.f;
          z[v] = __fsub_rn(z[v], m[i]);
        }
        er[v] = fminf(fmaxf(z[v], exp_lo), exp_hi);
      }
    }
    npe_pwl_prefix_slope_n<V>(er, sl, etab, eslope, etop);
    // each row's sum and sum of dy * e; lane i takes row i's reciprocal and
    // the recip's slope at its mantissa
    float sum[R], g_inv[R], mine = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      sum[i] = 0.f, g_inv[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int v = i * NPL + j;
        if (lane + 32 * j < vis[i]) {
          sum[i] = __fadd_rn(sum[i], fmaxf(er[v], 0.f));
        } else {
          er[v] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int v = i * NPL + j;
        if (lane + 32 * j < vis[i])
          g_inv[i] = __fadd_rn(g_inv[i], __fmul_rn(g[v], fmaxf(er[v], 0.f)));
      }
      ties[i] = npe_warp_sum(ties[i]);
      sum[i] = npe_warp_sum(sum[i]);
      g_inv[i] = npe_warp_sum(g_inv[i]);
      mine = lane % R == i ? sum[i] : mine;
    }
    const float s_mine = fmaxf(mine, 1e-30f);
    const float inv_mine = npe_recip_via_prefix(s_mine, rtab, rtop);
    // s = mant * 2^e with mant in [0.5, 1): 1/s = pwl(mant) * 2^-e
    float mc[1] = {fminf(fmaxf(__int_as_float((__float_as_int(s_mine) & 0x007fffff) | (126 << 23)),
                               recip_lo), recip_hi)};
    float rsl_mine[1];
    npe_pwl_prefix_slope_n<1>(mc, rsl_mine, rtab, rslope, rtop);
    float share[R], inv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      inv[i] = __shfl_sync(0xffffffffu, inv_mine, i);
      const float rsl = __shfl_sync(0xffffffffu, rsl_mine[0], i);
      const float s = fmaxf(sum[i], 1e-30f);
      const int bits = __float_as_int(s);
      const int e = ((bits >> 23) & 0xff) - 126;
      const float mant = __int_as_float((bits & 0x007fffff) | (126 << 23));
      float g_s = ldexpf(g_inv[i], -e);
      g_s = __fmul_rn(g_s, rsl);
      g_s = __fmul_rn(g_s, npe_clip_factor(mant, recip_lo, recip_hi));
      g_s = __fmul_rn(ldexpf(g_s, -e), npe_max_factor(sum[i], 1e-30f));
      float g_m = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int v = i * NPL + j;
        if (lane + 32 * j < vis[i]) {
          const float g_e = __fadd_rn(__fmul_rn(g[v], inv[i]), g_s);
          float d = __fmul_rn(g_e, npe_max_factor(er[v], 0.f));
          d = __fmul_rn(d, sl[v]);
          d = __fmul_rn(d, npe_clip_factor(z[v], exp_lo, exp_hi));
          er[v] = d;                               // from here on d/dz
          g_m = __fadd_rn(g_m, d);
        }
      }
      share[i] = __fdiv_rn(-npe_warp_sum(g_m), ties[i]);
    }
    // dx, then the next rows' loads; a row with no visible column (or whose
    // max is -inf) is all 0
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = r0 + i;
      if (row >= rows) break;
      float* dxr = dx + (size_t)row * n;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const int c = lane + 32 * j, v = i * NPL + j;
        if (c < n)
          dxr[c] = c < vis[i] && m[i] != neg_inf
                       ? __fmul_rn(z[v] == 0.f ? __fadd_rn(er[v], share[i]) : er[v], scale)
                       : 0.f;
      }
    }
    r0 += step;
    if (r0 < rows) load();
  }
}

// Blocks for `rows`: enough for every warp to take R rows once, at most the
// blocks the card holds at once (the rest by the loop).
template <typename TD, int NPL, int R>
int launch_grad(const float* x, const void* dy, float* dx, int rows, int n, int causal_rows,
                const int* limit, int limit_rows, float scale, const float* et,
                const float* es, int esegs, float elo, float ehi, const float* rt,
                const float* rs, int rsegs, float rlo, float rhi, cudaStream_t stream) {
  static int resident = 0;
  if (resident == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &resident, nvu_softmax_grad_kernel<TD, NPL, R>, THREADS, 0) != cudaSuccess ||
        resident < 1)
      resident = 1;
  }
  const long long need = ((long long)rows + WARPS * R - 1) / (WARPS * R);
  const long long cap = (long long)npe_sm_count() * resident;
  const int blocks = (int)(need < cap ? need : cap);
  nvu_softmax_grad_kernel<TD, NPL, R><<<blocks, THREADS, 0, stream>>>(
      x, static_cast<const TD*>(dy), dx, rows, n, causal_rows, limit, limit_rows, scale, et, es,
      esegs, elo, ehi, rt, rs, rsegs, rlo, rhi);
  return (int)cudaGetLastError();
}

#define NPE_SOFTMAX_GRAD_ARGS \
  x, dy, dx, rows, n, causal_rows, limit, limit_rows, scale, et, es, esegs, elo, ehi, rt, rs, \
      rsegs, rlo, rhi, s
// R rows a warp: R * NPL values in flight a lane, at most 8 up to 256
// columns.  Each value holds x, dy, e and the slope in registers, so the
// forward's 16 would leave one block an SM; rows of up to 32 columns keep
// two rows a warp, so that a few thousand rows still fill the card.
template <typename TD>
int launch_grad_n(const float* x, const void* dy, float* dx, int rows, int n, int causal_rows,
                  const int* limit, int limit_rows, float scale, const float* et,
                  const float* es, int esegs, float elo, float ehi, const float* rt,
                  const float* rs, int rsegs, float rlo, float rhi, cudaStream_t s) {
  if (n <= 32) return launch_grad<TD, 1, 2>(NPE_SOFTMAX_GRAD_ARGS);
  if (n <= 64) return launch_grad<TD, 2, 2>(NPE_SOFTMAX_GRAD_ARGS);
  if (n <= 128) return launch_grad<TD, 4, 2>(NPE_SOFTMAX_GRAD_ARGS);
  if (n <= 256) return launch_grad<TD, 8, 1>(NPE_SOFTMAX_GRAD_ARGS);
  if (n <= 512) return launch_grad<TD, 16, 1>(NPE_SOFTMAX_GRAD_ARGS);
  return launch_grad<TD, 32, 1>(NPE_SOFTMAX_GRAD_ARGS);
}
#undef NPE_SOFTMAX_GRAD_ARGS

}  // namespace

// limit: null, or int32 visible-column counts, one for each limit_rows rows.
extern "C" int npe_nvu_softmax(const float* x, void* y, int rows, int n, int causal_rows,
                               const int* limit, int limit_rows, float scale, int y_bf16,
                               const float* exp_table, int exp_segments,
                               const float* recip_table, int recip_segments, void* stream) {
  if (exp_segments < 1 || exp_segments + 1 > NPE_MAX_TABLE_COLS ||
      recip_segments < 1 || recip_segments + 1 > NPE_MAX_TABLE_COLS ||
      n > 1024 || causal_rows < 0 || (limit != nullptr && limit_rows < 1))
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_bf16)
    return launch_n<__nv_bfloat16>(x, y, rows, n, causal_rows, limit, limit_rows, scale,
                                   exp_table, exp_segments, recip_table, recip_segments, s);
  return launch_n<float>(x, y, rows, n, causal_rows, limit, limit_rows, scale, exp_table,
                         exp_segments, recip_table, recip_segments, s);
}

// The backward of npe_nvu_softmax on the same x and options: dx (f32) from
// dy (f32 or bf16, the output's dtype); the slope tables are `slope_table`'s.
extern "C" int npe_nvu_softmax_grad(const float* x, const void* dy, float* dx, int rows, int n,
                                    int causal_rows, const int* limit, int limit_rows,
                                    float scale, int dy_bf16, const float* exp_table,
                                    const float* exp_slopes, int exp_segments, float exp_lo,
                                    float exp_hi, const float* recip_table,
                                    const float* recip_slopes, int recip_segments,
                                    float recip_lo, float recip_hi, void* stream) {
  if (exp_segments < 1 || exp_segments + 1 > NPE_MAX_TABLE_COLS ||
      recip_segments < 1 || recip_segments + 1 > NPE_MAX_TABLE_COLS ||
      n > 1024 || causal_rows < 0 || (limit != nullptr && limit_rows < 1))
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dy_bf16)
    return launch_grad_n<__nv_bfloat16>(x, dy, dx, rows, n, causal_rows, limit, limit_rows,
                                        scale, exp_table, exp_slopes, exp_segments, exp_lo,
                                        exp_hi, recip_table, recip_slopes, recip_segments,
                                        recip_lo, recip_hi, s);
  return launch_grad_n<float>(x, dy, dx, rows, n, causal_rows, limit, limit_rows, scale,
                              exp_table, exp_slopes, exp_segments, exp_lo, exp_hi, recip_table,
                              recip_slopes, recip_segments, recip_lo, recip_hi, s);
}
