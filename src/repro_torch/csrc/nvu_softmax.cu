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
// Design: written to be right.  A warp a row, lane l holding columns
// l + 32j (NPL a lane), the forward recomputed from x (the value of each
// exp by the delta walk, the same bits as the forward's search), the four
// tables (exp and recip, values and slopes) in shared memory, and five
// warp reductions (max, tie count, sum, sum of dy * e, the max's share).
constexpr int GRAD_WARPS = 4;

template <typename TD, int NPL>
__global__ void __launch_bounds__(GRAD_WARPS * 32)
nvu_softmax_grad_kernel(const float* __restrict__ x, const TD* __restrict__ dy,
                        float* __restrict__ dx, int rows, int n, int causal_rows,
                        const int* __restrict__ limit, int limit_rows, float scale,
                        const float* __restrict__ exp_table, const float* __restrict__ exp_slopes,
                        int exp_segs, float exp_lo, float exp_hi,
                        const float* __restrict__ recip_table,
                        const float* __restrict__ recip_slopes, int recip_segs, float recip_lo,
                        float recip_hi) {
  __shared__ float etab[3 * NPE_MAX_TABLE_COLS], eslope[2 * NPE_MAX_TABLE_COLS];
  __shared__ float rtab[3 * NPE_MAX_TABLE_COLS], rslope[2 * NPE_MAX_TABLE_COLS];
  npe_load_table(etab, exp_table, exp_segs + 1);
  npe_load_slope_table(eslope, exp_slopes, exp_segs + 1);
  npe_load_table(rtab, recip_table, recip_segs + 1);
  npe_load_slope_table(rslope, recip_slopes, recip_segs + 1);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * GRAD_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long base = (long long)row * n;
  int visible = n;                        // columns c < visible take part
  if (causal_rows) visible = min(n, row % causal_rows + (n - causal_rows) + 1);
  if (limit != nullptr) visible = min(n, max(limit[row / limit_rows], 0));
  const float neg_inf = __int_as_float(0xff800000);
  float z[NPL], er[NPL];
  float m = neg_inf;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + 32 * j;
    z[j] = c < visible ? __fmul_rn(x[base + c], scale) : neg_inf;
    m = fmaxf(m, z[j]);
  }
  m = npe_warp_max(m);
  if (m == neg_inf) {                   // nothing visible: a row of zeros
    for (int c = lane; c < n; c += 32) dx[base + c] = 0.f;
    return;
  }
  float ties = 0.f, sum = 0.f;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    er[j] = 0.f;
    if (lane + 32 * j < visible) {
      ties += z[j] == m ? 1.f : 0.f;
      z[j] = __fsub_rn(z[j], m);
      er[j] = npe_pwl(fminf(fmaxf(z[j], exp_lo), exp_hi), etab, exp_segs);
      sum = __fadd_rn(sum, fmaxf(er[j], 0.f));
    }
  }
  ties = npe_warp_sum(ties);
  sum = npe_warp_sum(sum);
  const float s = fmaxf(sum, 1e-30f);
  const float inv = npe_recip_via_pwl(s, rtab, recip_segs);
  float g_inv = 0.f;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + 32 * j;
    if (c < visible)
      g_inv = __fadd_rn(g_inv, __fmul_rn(npe_to_f32(dy[base + c]), fmaxf(er[j], 0.f)));
  }
  g_inv = npe_warp_sum(g_inv);
  // s = mant * 2^e with mant in [0.5, 1): 1/s = pwl(mant) * 2^-e
  const int bits = __float_as_int(s);
  const int e = ((bits >> 23) & 0xff) - 126;
  const float mant = __int_as_float((bits & 0x007fffff) | (126 << 23));
  float g_s = ldexpf(g_inv, -e);
  g_s = __fmul_rn(g_s, npe_pwl_slope(fminf(fmaxf(mant, recip_lo), recip_hi), rslope, recip_segs));
  g_s = __fmul_rn(g_s, npe_clip_factor(mant, recip_lo, recip_hi));
  g_s = __fmul_rn(ldexpf(g_s, -e), npe_max_factor(sum, 1e-30f));
  float g_m = 0.f;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + 32 * j;
    if (c < visible) {
      const float g_e = __fadd_rn(__fmul_rn(npe_to_f32(dy[base + c]), inv), g_s);
      float g = __fmul_rn(g_e, npe_max_factor(er[j], 0.f));
      g = __fmul_rn(g, npe_pwl_slope(fminf(fmaxf(z[j], exp_lo), exp_hi), eslope, exp_segs));
      g = __fmul_rn(g, npe_clip_factor(z[j], exp_lo, exp_hi));
      er[j] = g;                          // from here on d/dz
      g_m = __fadd_rn(g_m, g);
    }
  }
  const float share = __fdiv_rn(-npe_warp_sum(g_m), ties);
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + 32 * j;
    if (c < n)
      dx[base + c] =
          c < visible ? __fmul_rn(z[j] == 0.f ? __fadd_rn(er[j], share) : er[j], scale) : 0.f;
  }
}

template <typename TD, int NPL>
int launch_grad(const float* x, const void* dy, float* dx, int rows, int n, int causal_rows,
                const int* limit, int limit_rows, float scale, const float* et,
                const float* es, int esegs, float elo, float ehi, const float* rt,
                const float* rs, int rsegs, float rlo, float rhi, cudaStream_t stream) {
  const int blocks = (rows + GRAD_WARPS - 1) / GRAD_WARPS;
  nvu_softmax_grad_kernel<TD, NPL><<<blocks, GRAD_WARPS * 32, 0, stream>>>(
      x, static_cast<const TD*>(dy), dx, rows, n, causal_rows, limit, limit_rows, scale, et, es,
      esegs, elo, ehi, rt, rs, rsegs, rlo, rhi);
  return (int)cudaGetLastError();
}

#define NPE_SOFTMAX_GRAD_ARGS \
  x, dy, dx, rows, n, causal_rows, limit, limit_rows, scale, et, es, esegs, elo, ehi, rt, rs, \
      rsegs, rlo, rhi, s
template <typename TD>
int launch_grad_n(const float* x, const void* dy, float* dx, int rows, int n, int causal_rows,
                  const int* limit, int limit_rows, float scale, const float* et,
                  const float* es, int esegs, float elo, float ehi, const float* rt,
                  const float* rs, int rsegs, float rlo, float rhi, cudaStream_t s) {
  if (n <= 128) return launch_grad<TD, 4>(NPE_SOFTMAX_GRAD_ARGS);
  if (n <= 256) return launch_grad<TD, 8>(NPE_SOFTMAX_GRAD_ARGS);
  if (n <= 512) return launch_grad<TD, 16>(NPE_SOFTMAX_GRAD_ARGS);
  return launch_grad<TD, 32>(NPE_SOFTMAX_GRAD_ARGS);
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
