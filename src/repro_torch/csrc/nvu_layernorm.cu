// NVU layernorm / rmsnorm on Hopper with a PWL 1/sqrt.
//
// Replaces: nvu_layernorm_rows / _layernorm_kernel (and rsqrt_via_pwl) in
// src/repro/kernels/nvu_layernorm.py.
// Bound on this card: bytes.  Each element is read once and written once
// (2+2 bytes in bf16 on the BERT path, 4+4 in f32), plus gamma and beta,
// against a handful of operations.
// Design: two instances, chosen by the C entry.
// - Warp per row (rows of up to 2048 columns, 16-byte aligned, tables of
//   up to 32 columns): up to eight rows a block, one warp each (fewer when
//   the rows do not fill the SMs, so a decode step's rows spread out).  A row lives in
//   the warp's registers, VPL 16-byte vectors a lane; the mean and the
//   variance (two passes, not E[x^2] - E[x]^2) are __shfl_xor reductions,
//   so there is no barrier and no shared memory.  Each lane reads one
//   column of the rsqrt table through the read-only path at the start and
//   the warp forms its prefix sums while the row is in flight; the one PWL
//   a row then counts the knots it passes by a ballot and takes two
//   prefixes by shuffles.  gamma and
//   beta are read as float4, at the start beside the row where a lane holds
//   at most 24 of its values (every row of up to 768 columns), else after
//   the reductions.
// - Block per row (any other row, up to 8192 columns): 256 threads, the row
//   staged as f32 in shared memory, block-wide reductions.
// 1/sqrt(var + eps) is the PWL of the mantissa normalized to [0.25, 1) by
// powers of four, with the exponent handled by integer bit operations and
// the odd-exponent case folded into the mantissa, so there is no sqrt or
// divide besides the two means.  Both instances round as the plain version
// does (_rn intrinsics); only the order of the sums differs, and it is the
// same in both instances, so they agree bit for bit.
#include <algorithm>

#include "pwl.cuh"

namespace {

constexpr int THREADS = 256;      // block instance: threads a row
constexpr int WARP_ROWS = 8;      // warp instance: rows (warps) a block at most
constexpr int WARP_MAX_COLS = 2048;

// 1/sqrt(v) for v > 0: v = m * 4^p with m in [0.25, 1) => pwl(m) * 2^-p,
// pwl(m) the walk of npe_pwl over the rsqrt table.
template <class Pwl>
__device__ __forceinline__ float rsqrt_via_pwl(float v, const Pwl& pwl) {
  const int bits = __float_as_int(v);
  const int e = ((bits >> 23) & 0xff) - 126;          // v = m * 2^e, m in [0.5, 1)
  const int odd = e & 1;
  const int e_even = e + odd;
  float m = __int_as_float((bits & 0x007fffff) | (126 << 23));
  if (odd) m = __fmul_rn(m, 0.5f);                    // [0.25, 0.5)
  const float r = pwl(m);
  const int p = e_even >> 1;
  const int pow_field = min(max(127 - p, 1), 254);
  return __fmul_rn(r, __int_as_float(pow_field << 23));
}

// The walk of npe_pwl over a table in shared memory.
struct SharedPwl {
  const float* tab;
  int segs;
  __device__ __forceinline__ float operator()(float m) const { return npe_pwl(m, tab, segs); }
};

// d_0 + d_1 + ... + d_lane, one add at a time in that order, each d_j
// taken from lane j by a shuffle: the prefix the walk of npe_pwl reaches
// once it has passed knot `lane`.  The shuffles do not wait on the sum, so
// they go out back to back.
__device__ __forceinline__ float npe_warp_prefix(float d, int lane) {
  float acc = __shfl_sync(0xffffffffu, d, 0);
#pragma unroll
  for (int j = 1; j < 32; ++j) {
    const float dj = __shfl_sync(0xffffffffu, d, j);
    if (j <= lane) acc = __fadd_rn(acc, dj);
  }
  return acc;
}

// The same PWL, for an m the whole warp shares, from a table of at most 32
// columns that the warp holds one column a lane: lane i has knot_i (NaN
// past the interior knots, which m never reaches) and the prefixes
// P_slope[i], P_icept[i] (npe_warp_prefix: the sums the walk of npe_pwl has
// reached once past knot i).  The knots ascend, so the walk for m ends at
// P[k], k the count of lanes whose knot m reaches (one ballot): npe_pwl's
// result bit for bit.  The prefixes are formed when the warp's loads are in
// flight, so a row waits only for the ballot and two shuffles.
struct WarpPwl {
  float knot, pslope, picept;
  __device__ __forceinline__ WarpPwl(float kn, float ds, float di, int lane)
      : knot(kn), pslope(npe_warp_prefix(ds, lane)), picept(npe_warp_prefix(di, lane)) {}
  __device__ __forceinline__ float operator()(float m) const {
    const int k = __popc(__ballot_sync(0xffffffffu, m >= knot));
    return __fadd_rn(__fmul_rn(__shfl_sync(0xffffffffu, pslope, k), m),
                     __shfl_sync(0xffffffffu, picept, k));
  }
};

// Sum over the block; every thread gets the same value.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = npe_warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();   // earlier readers of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
  return npe_warp_sum(t);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
nvu_layernorm_kernel(const T* __restrict__ x, T* __restrict__ y,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, int n, float eps,
                     int rms_only, const float* __restrict__ table, int segs) {
  extern __shared__ float row_buf[];   // n floats
  __shared__ float tab[3 * NPE_MAX_TABLE_COLS];
  __shared__ float red[32];
  npe_load_table(tab, table, segs + 1);

  const size_t base = (size_t)blockIdx.x * n;
  float s = 0.f;
  for (int c = threadIdx.x; c < n; c += THREADS) {
    const float v = npe_to_f32(x[base + c]);
    row_buf[c] = v;
    s = __fadd_rn(s, v);
  }
  s = block_sum(s, red);   // also syncs row_buf and tab
  const float mu = rms_only ? 0.f : __fdiv_rn(s, (float)n);

  float s2 = 0.f;
  for (int c = threadIdx.x; c < n; c += THREADS) {
    const float d = __fsub_rn(row_buf[c], mu);
    s2 = __fadd_rn(s2, __fmul_rn(d, d));
  }
  s2 = block_sum(s2, red);
  const float var = __fdiv_rn(s2, (float)n);
  const float inv = rsqrt_via_pwl(__fadd_rn(var, eps), SharedPwl{tab, segs});

  for (int c = threadIdx.x; c < n; c += THREADS) {
    float o = __fmul_rn(__fmul_rn(__fsub_rn(row_buf[c], mu), inv), gamma[c]);
    if (beta != nullptr) o = __fadd_rn(o, beta[c]);
    y[base + c] = npe_from_f32<T>(o);
  }
}

// The sum of term(x) over a row in the block instance's order, from the row
// as a warp holds it (E values a 16-byte vector, vector v at lane v % 32,
// slot v / 32).  The block instance's thread t adds the terms of columns t,
// t + THREADS, ... in turn, from 0; block_sum then adds its threads by a
// butterfly in each warp (offsets 16 .. 1), and the warps' sums by one more
// over 32 lanes of which the first 8 hold them.  Column c = E * (lane + 32 i)
// + p, at slot i and position p, is thread c % THREADS's (c / THREADS)-th
// term, so a lane holds whole threads: H = THREADS / (32 E) groups of E,
// slot i in group i % H.  Each butterfly offset that crosses lanes becomes a
// shuffle, the others adds within the lane.  Every add is the block
// instance's, in its order: the two instances' sums are bit-identical.
template <int E, int VPL, class Term>
__device__ __forceinline__ float block_order_sum(const float (&f)[VPL][E], int lane, int nvec,
                                                 Term term) {
  constexpr int H = THREADS / (32 * E);
  static_assert(H * 32 * E == THREADS, "a slot holds whole block threads");
  float t[H][E];   // the lane's block threads: thread E * lane + p + 32 * E * h
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int p = 0; p < E; ++p) t[h][p] = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
    if (lane + 32 * i < nvec)
#pragma unroll
      for (int p = 0; p < E; ++p) t[i % H][p] = __fadd_rn(t[i % H][p], term(f[i][p]));
  // each block warp's butterfly: thread bits below log2(E) are p, the rest
  // the lane's low bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float u[E];
#pragma unroll
      for (int p = 0; p < E; ++p)
        u[p] = o >= E ? __shfl_xor_sync(0xffffffffu, t[h][p], o / E) : t[h][p ^ (o % E)];
#pragma unroll
      for (int p = 0; p < E; ++p) t[h][p] = __fadd_rn(t[h][p], u[p]);
    }
  }
  // the sum over the 8 block warps, warp w = lane / (32 / E) + E * h: the
  // butterfly over [w_0 .. w_7, 0, ..., 0] adds 0 twice, then offsets 4, 2, 1
  float w[H];
#pragma unroll
  for (int h = 0; h < H; ++h) w[h] = __fadd_rn(__fadd_rn(t[h][0], 0.f), 0.f);
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    float u[H];
#pragma unroll
    for (int h = 0; h < H; ++h)
      u[h] = o >= E ? w[h ^ (o / E)] : __shfl_xor_sync(0xffffffffu, w[h], o * (32 / E));
#pragma unroll
    for (int h = 0; h < H; ++h) w[h] = __fadd_rn(w[h], u[h]);
  }
  return w[0];
}

// One warp per row; VPL 16-byte vectors of the row a lane, vector v of the
// row at lane v % 32, slot v / 32.  Its sums are the block instance's
// (block_order_sum), so its results are too, bit for bit.
template <typename T, int VPL>
__global__ void __launch_bounds__(WARP_ROWS * 32)
nvu_layernorm_warp_kernel(const T* __restrict__ x, T* __restrict__ y,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta, int rows, int n, float eps,
                          int rms_only, const float* __restrict__ table, int segs) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;   // the whole warp
  const int cols = segs + 1;   // column `lane` of the rsqrt table, read first
  const float kn = lane >= 1 && lane < segs ? __ldg(table + lane) : __int_as_float(0x7fffffff);
  const float ds = lane < segs ? __ldg(table + cols + lane) : 0.f;
  const float di = lane < segs ? __ldg(table + 2 * cols + lane) : 0.f;
  const int nvec = n / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * n);
  uint4 raw[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
    raw[i] = lane + 32 * i < nvec ? xr[lane + 32 * i] : make_uint4(0, 0, 0, 0);
  // gamma and beta of the lane's columns, E / 4 float4 a vector
  constexpr bool EARLY = VPL * E <= 24;
  constexpr int GV = EARLY ? VPL * E / 4 : 1;
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
  float4 ge[GV], be[GV];
  if constexpr (EARLY) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        ge[i * (E / 4) + q] = v < nvec ? g4[v * (E / 4) + q] : make_float4(0, 0, 0, 0);
        be[i * (E / 4) + q] = v < nvec && beta != nullptr ? b4[v * (E / 4) + q]
                                                          : make_float4(0, 0, 0, 0);
      }
    }
  }

  const WarpPwl pwl(kn, ds, di, lane);
  float f[VPL][E];
#pragma unroll
  for (int i = 0; i < VPL; ++i) npe_unpack16<T>(raw[i], f[i]);
  const float sum = block_order_sum<E, VPL>(f, lane, nvec, [](float v) { return v; });
  const float mu = rms_only ? 0.f : __fdiv_rn(sum, (float)n);
  const float s2 = block_order_sum<E, VPL>(f, lane, nvec, [mu](float v) {
    const float d = __fsub_rn(v, mu);
    return __fmul_rn(d, d);
  });
  const float var = __fdiv_rn(s2, (float)n);
  const float inv = rsqrt_via_pwl(__fadd_rn(var, eps), pwl);

  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * n);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    if (v >= nvec) break;
    float g[E], b[E];
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      float4 gq, bq = make_float4(0, 0, 0, 0);
      if constexpr (EARLY) {
        gq = ge[i * (E / 4) + q];
        bq = be[i * (E / 4) + q];
      } else {
        gq = g4[v * (E / 4) + q];
        if (beta != nullptr) bq = b4[v * (E / 4) + q];
      }
      g[4 * q] = gq.x, g[4 * q + 1] = gq.y, g[4 * q + 2] = gq.z, g[4 * q + 3] = gq.w;
      b[4 * q] = bq.x, b[4 * q + 1] = bq.y, b[4 * q + 2] = bq.z, b[4 * q + 3] = bq.w;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      f[i][e] = __fmul_rn(__fmul_rn(__fsub_rn(f[i][e], mu), inv), g[e]);
      if (beta != nullptr) f[i][e] = __fadd_rn(f[i][e], b[e]);
    }
    yr[v] = npe_pack16<T>(f[i]);
  }
}

template <typename T, int VPL>
int launch_warp(const T* x, T* y, const float* gamma, const float* beta, int rows, int n,
                float eps, int rms_only, const float* table, int segs, cudaStream_t s) {
  const int per_block = std::min(WARP_ROWS, (rows + npe_sm_count() - 1) / npe_sm_count());
  nvu_layernorm_warp_kernel<T, VPL><<<(rows + per_block - 1) / per_block, per_block * 32, 0, s>>>(
      x, y, gamma, beta, rows, n, eps, rms_only, table, segs);
  return (int)cudaGetLastError();
}

// The smallest instance whose lanes hold the row: VPL in 1, 2, 3, 4, 6, 8,
// and for f32 also 12, 16 (2048 columns are 256 bf16 or 512 f32 vectors).
template <typename T>
int launch_warp_rows(const T* x, T* y, const float* gamma, const float* beta, int rows,
                     int n, float eps, int rms_only, const float* table, int segs,
                     cudaStream_t s) {
  const int vpl = (n / (16 / (int)sizeof(T)) + 31) / 32;
#define NPE_LN_WARP(V) \
  if (vpl <= V) return launch_warp<T, V>(x, y, gamma, beta, rows, n, eps, rms_only, table, segs, s)
  NPE_LN_WARP(1); NPE_LN_WARP(2); NPE_LN_WARP(3); NPE_LN_WARP(4); NPE_LN_WARP(6); NPE_LN_WARP(8);
  if constexpr (sizeof(T) == 4) {
    NPE_LN_WARP(12); NPE_LN_WARP(16);
  }
#undef NPE_LN_WARP
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// --- the backward: jax.grad of the reference's nvu_layernorm ---------------
// For y = (x - mu) * inv * gamma + beta, inv = rsqrt_via_pwl(var + eps):
// d/d(inv) = sum dy gamma (x - mu); through the PWL 1/sqrt, 2^-p times
// the rsqrt table's slope at the power-of-4 mantissa, 1/2 where it ties
// the clip at 0.25 (a power-of-4 variance), 1/2 more for an odd exponent
// (the fold), and 2^-e from frexp; then the variance's 2 (x - mu) / n and
// the mean's -sum / n.  rms_only drops the mean.  dx is rounded to x's
// dtype; dgamma_rows[r, c] = dy * (x - mu) * inv, the row's part of
// dgamma, which the caller sums over the rows (dbeta is the sum of dy).
// Design: written to be right.  A warp a row, eight rows a block, five
// passes over the row (the mean, the variance, d/d(inv), the sum of
// d/d(x - mu), the results), each a coalesced read that L1 serves after
// the first; the tables in shared memory.
constexpr int GRAD_WARPS = 8;

template <typename T>
__global__ void __launch_bounds__(GRAD_WARPS * 32)
nvu_layernorm_grad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ gamma, T* __restrict__ dx,
                          float* __restrict__ dgamma_rows, int rows, int n, float eps,
                          int rms_only, const float* __restrict__ table,
                          const float* __restrict__ slopes, int segs, float lo, float hi) {
  __shared__ float tab[3 * NPE_MAX_TABLE_COLS], stab[2 * NPE_MAX_TABLE_COLS];
  npe_load_table(tab, table, segs + 1);
  npe_load_slope_table(stab, slopes, segs + 1);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * GRAD_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t base = (size_t)row * n;
  const float fn = (float)n;
  float mu = 0.f;
  if (!rms_only) {
    float s = 0.f;
    for (int c = lane; c < n; c += 32) s = __fadd_rn(s, npe_to_f32(x[base + c]));
    mu = __fdiv_rn(npe_warp_sum(s), fn);
  }
  float sq = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float d = __fsub_rn(npe_to_f32(x[base + c]), mu);
    sq = __fadd_rn(sq, __fmul_rn(d, d));
  }
  const float v = __fadd_rn(__fdiv_rn(npe_warp_sum(sq), fn), eps);
  // v = mant * 2^e, mant in [0.5, 1); an odd e folds into m = mant / 2
  const int bits = __float_as_int(v);
  const int e = ((bits >> 23) & 0xff) - 126;
  const int odd = e & 1;
  const float mant = __int_as_float((bits & 0x007fffff) | (126 << 23));
  const float m = odd ? __fmul_rn(mant, 0.5f) : mant;
  const int p = (e + odd) >> 1;
  const float mc = fminf(fmaxf(m, lo), hi);
  const float inv = ldexpf(npe_pwl(mc, tab, segs), -p);
  float g_inv = 0.f;
  for (int c = lane; c < n; c += 32) {
    const float d = __fsub_rn(npe_to_f32(x[base + c]), mu);
    g_inv = __fadd_rn(g_inv, __fmul_rn(__fmul_rn(npe_to_f32(dy[base + c]), gamma[c]), d));
  }
  g_inv = npe_warp_sum(g_inv);
  float g_v = __fmul_rn(ldexpf(g_inv, -p), npe_pwl_slope(mc, stab, segs));
  g_v = __fmul_rn(g_v, npe_clip_factor(m, lo, hi));
  if (odd) g_v = __fmul_rn(g_v, 0.5f);
  const float g_sq = __fdiv_rn(ldexpf(g_v, -e), fn);   // d/d(d^2) of each element
  float g_mu = 0.f;
  if (!rms_only) {
    for (int c = lane; c < n; c += 32) {
      const float d = __fsub_rn(npe_to_f32(x[base + c]), mu);
      const float g_y = __fmul_rn(npe_to_f32(dy[base + c]), gamma[c]);
      g_mu = __fadd_rn(g_mu, __fadd_rn(__fmul_rn(g_y, inv), __fmul_rn(g_sq, __fmul_rn(2.f, d))));
    }
    g_mu = __fdiv_rn(-npe_warp_sum(g_mu), fn);
  }
  for (int c = lane; c < n; c += 32) {
    const float d = __fsub_rn(npe_to_f32(x[base + c]), mu);
    const float dyc = npe_to_f32(dy[base + c]);
    const float g_d = __fadd_rn(__fmul_rn(__fmul_rn(dyc, gamma[c]), inv),
                                __fmul_rn(g_sq, __fmul_rn(2.f, d)));
    dx[base + c] = npe_from_f32<T>(rms_only ? g_d : __fadd_rn(g_d, g_mu));
    dgamma_rows[base + c] = __fmul_rn(dyc, __fmul_rn(d, inv));
  }
}

}  // namespace

extern "C" int npe_nvu_layernorm(const void* x, void* y, const float* gamma,
                                 const float* beta, int rows, int n, int bf16,
                                 float eps, int rms_only, const float* table,
                                 int segments, void* stream) {
  if (segments < 1 || segments + 1 > NPE_MAX_TABLE_COLS || n > 8192)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = bf16 ? 2 : 4;
  const bool warp = n <= WARP_MAX_COLS && (n * elem) % 16 == 0 && segments + 1 <= 32 &&
                    aligned16(x) && aligned16(y) && aligned16(gamma) &&
                    (beta == nullptr || aligned16(beta));
  using bf = __nv_bfloat16;
  if (warp) {
    if (bf16)
      return launch_warp_rows<bf>(static_cast<const bf*>(x), static_cast<bf*>(y), gamma, beta,
                                  rows, n, eps, rms_only, table, segments, s);
    return launch_warp_rows<float>(static_cast<const float*>(x), static_cast<float*>(y), gamma,
                                   beta, rows, n, eps, rms_only, table, segments, s);
  }
  const size_t smem = (size_t)n * sizeof(float);
  if (bf16)
    nvu_layernorm_kernel<bf><<<rows, THREADS, smem, s>>>(
        static_cast<const bf*>(x), static_cast<bf*>(y), gamma, beta, n, eps, rms_only,
        table, segments);
  else
    nvu_layernorm_kernel<float><<<rows, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), gamma, beta, n, eps,
        rms_only, table, segments);
  return (int)cudaGetLastError();
}

// The backward of npe_nvu_layernorm on the same x, gamma and options: dx in
// x's dtype from dy in the same dtype, and dgamma_rows (rows, n) f32.
extern "C" int npe_nvu_layernorm_grad(const void* x, const void* dy, const float* gamma,
                                      void* dx, float* dgamma_rows, int rows, int n, int bf16,
                                      float eps, int rms_only, const float* table,
                                      const float* slopes, int segments, float lo, float hi,
                                      void* stream) {
  if (segments < 1 || segments + 1 > NPE_MAX_TABLE_COLS) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (rows + GRAD_WARPS - 1) / GRAD_WARPS;
  using bf = __nv_bfloat16;
  if (bf16)
    nvu_layernorm_grad_kernel<bf><<<blocks, GRAD_WARPS * 32, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(dy), gamma, static_cast<bf*>(dx),
        dgamma_rows, rows, n, eps, rms_only, table, slopes, segments, lo, hi);
  else
    nvu_layernorm_grad_kernel<float><<<blocks, GRAD_WARPS * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), gamma,
        static_cast<float*>(dx), dgamma_rows, rows, n, eps, rms_only, table, slopes, segments,
        lo, hi);
  return (int)cudaGetLastError();
}
