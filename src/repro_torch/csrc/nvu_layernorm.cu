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
  // the count of interior knots <= m
  __device__ __forceinline__ int seg(float m) const {
    return __popc(__ballot_sync(0xffffffffu, m >= knot));
  }
  // the PWL at m, whose segment is k
  __device__ __forceinline__ float at(float m, int k) const {
    return __fadd_rn(__fmul_rn(__shfl_sync(0xffffffffu, pslope, k), m),
                     __shfl_sync(0xffffffffu, picept, k));
  }
  __device__ __forceinline__ float operator()(float m) const { return at(m, seg(m)); }
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
// block_order_reduce takes the lane's block threads' sums t[h][p] (thread E
// * lane + p + 32 * E * h) and does the rest; block_order_sum forms them
// first, from term(i, p), the term of the value at slot i, position p.
template <int E>
__host__ __device__ constexpr int block_order_groups() {
  static_assert((THREADS / (32 * E)) * 32 * E == THREADS, "a slot holds whole block threads");
  return THREADS / (32 * E);
}

template <int E, int H = block_order_groups<E>()>
__device__ __forceinline__ float block_order_reduce(float (&t)[H][E]) {
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

template <int E, int VPL, class Term>
__device__ __forceinline__ float block_order_sum(int lane, int nvec, Term term) {
  constexpr int H = block_order_groups<E>();
  float t[H][E] = {};
#pragma unroll
  for (int i = 0; i < VPL; ++i)
    if (lane + 32 * i < nvec)
#pragma unroll
      for (int p = 0; p < E; ++p) t[i % H][p] = __fadd_rn(t[i % H][p], term(i, p));
  return block_order_reduce<E>(t);
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
  const float sum = block_order_sum<E, VPL>(lane, nvec, [&](int i, int p) { return f[i][p]; });
  const float mu = rms_only ? 0.f : __fdiv_rn(sum, (float)n);
  const float s2 = block_order_sum<E, VPL>(lane, nvec, [&](int i, int p) {
    const float d = __fsub_rn(f[i][p], mu);
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
// dtype; dgamma = sum over the rows of dy * (x - mu) * inv, dbeta = sum of
// dy, both f32 (no dbeta with rms_only).
// Bound on this card: bytes (x and dy read once, dx written once, gamma,
// dgamma and dbeta).
// Design: two launches, the row pass and the column sums' reduction.  The
// row pass has two instances, chosen by the C entry as the forward's are.
// - Warp per row (16-byte aligned rows of up to 2048 f32 or 4096 bf16
//   columns, tables of up to 32 columns): x and dy of a row live in the
//   warp's registers as 16-byte vectors, VPL of each a lane, one read each;
//   the mean and the variance are summed in block_order_sum's order, so
//   they and inv are the forward's bit for bit; the variance and d/d(inv)
//   take one pass, the sum of d/d(x - mu) another, each E sums a lane and
//   a butterfly; dx is written 16 bytes a lane.  The PWL at the mantissa
//   and its slope come from one ballot over the table's columns, which the
//   lanes hold (WarpPwl).  gamma is staged in shared memory once a block.
//   Each warp adds its rows' dy (x - mu) inv and dy into column sums of its
//   own in shared memory, row after row; the warps a block are those (8,
//   4 or 2) that keep the most warps an SM.
//   Its limit (PERF.md): the arithmetic of four passes over registers a
//   row, bf16 values unpacked in each, not the bytes.
// - Block per row (any other row): 256 threads, the row staged as f32 in
//   shared memory up to GRAD_STAGE_COLS columns and read again from global
//   memory past that; block-wide sums in the forward block instance's
//   order; each thread adds its own columns' terms into the block's column
//   sums in global memory.
// The row pass's grid is persistent (at most the blocks resident at once),
// so `parts` is small: each block writes its column sums (its warps' summed
// in warp order) to its row of `parts`, (rms_only ? 1 : 2) * n floats.  The
// second launch (nvu_layernorm_grad_reduce_kernel) sums each column over
// the rows of `parts` in a fixed order.  No float atomics and no (rows, n)
// array: dgamma and dbeta have the same bits on every launch.
constexpr int GRAD_MAX_WARPS = 8;            // warp instance: warps a block at most
constexpr int GRAD_STAGE_COLS = 8192;        // block instance: rows staged up to this
constexpr size_t GRAD_ACC_BYTES = 192 << 10; // warp instance: its warps' column sums a block, at most
constexpr int GRAD_MIN_ROWS = 4;              // block instance: rows a block at least
constexpr int RED_COLS = 32, RED_SLICES = 8; // the reduction: columns and slices a block

// dgamma and dbeta from the row pass's column sums, parts[g * cols + col]
// (col < n: dgamma's, else dbeta's), g = 0 .. G - 1.  A block takes
// RED_COLS columns, a warp a slice of the rows: thread (c, s) sums the rows
// s, s + RED_SLICES, ... of its column in turn, 16 loads in flight, then
// thread (c, 0) the RED_SLICES sums in order.  The order depends on G
// alone.
__global__ void __launch_bounds__(RED_COLS * RED_SLICES)
nvu_layernorm_grad_reduce_kernel(const float* __restrict__ parts, int G, int cols, int n,
                                 float* __restrict__ dgamma, float* __restrict__ dbeta) {
  constexpr int BATCH = 16;
  __shared__ float red[RED_SLICES][RED_COLS];
  const int c = threadIdx.x % RED_COLS, s = threadIdx.x / RED_COLS;
  const int col = blockIdx.x * RED_COLS + c;
  float acc = 0.f;
  if (col < cols) {
    for (int g0 = s; g0 < G; g0 += BATCH * RED_SLICES) {
      float v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        v[u] = g0 + u * RED_SLICES < G ? parts[(size_t)(g0 + u * RED_SLICES) * cols + col] : 0.f;
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (g0 + u * RED_SLICES < G) acc = __fadd_rn(acc, v[u]);
    }
  }
  red[s][c] = acc;
  __syncthreads();
  if (s == 0 && col < cols) {
    float t = red[0][c];
#pragma unroll
    for (int q = 1; q < RED_SLICES; ++q) t = __fadd_rn(t, red[q][c]);
    if (col < n)
      dgamma[col] = t;
    else
      dbeta[col - n] = t;
  }
}

struct LnGradArgs {
  const void* x;
  const void* dy;
  const float* gamma;
  void* dx;
  float* parts;          // gridDim.x * (rms_only ? 1 : 2) * n floats
  int rows, n;
  float eps;
  int rms_only;
  const float* table;    // the packed rsqrt table
  const float* slopes;   // its slope table
  int segs;
  float lo, hi;          // the table's ends: the clip of the mantissa
};

// Element p of a 16-byte vector of T, as f32 (npe_unpack16's p-th value).
template <typename T>
__device__ __forceinline__ float elem16(const uint4& r, int p) {
  constexpr int E = 16 / sizeof(T);
  const int q = p / (E / 4);
  const uint32_t w = q == 0 ? r.x : (q == 1 ? r.y : (q == 2 ? r.z : r.w));
  if constexpr (sizeof(T) == 2) return __uint_as_float(p % 2 ? w & 0xffff0000u : w << 16);
  return __uint_as_float(w);
}

__device__ __forceinline__ float& at4(float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// The row's scalars of the backward, from its variance sum s2: the
// power-of-4 mantissa m of var + eps and its clip mc to the table, the
// exponent e, p = e / 2 rounded up, and whether e is odd (the fold).
struct RowScalars {
  float m, mc;
  int e, p, odd;
};

__device__ __forceinline__ RowScalars row_scalars(float s2, float fn, float eps, float lo,
                                                  float hi) {
  RowScalars r;
  const float v = __fadd_rn(__fdiv_rn(s2, fn), eps);
  // v = mant * 2^e, mant in [0.5, 1); an odd e folds into m = mant / 2
  const int bits = __float_as_int(v);
  r.e = ((bits >> 23) & 0xff) - 126;
  r.odd = r.e & 1;
  const float mant = __int_as_float((bits & 0x007fffff) | (126 << 23));
  r.m = r.odd ? __fmul_rn(mant, 0.5f) : mant;
  r.p = (r.e + r.odd) >> 1;
  r.mc = fminf(fmaxf(r.m, lo), hi);
  return r;
}

// d/d(d^2) of each element from d/d(inv) and the slope at the mantissa.
__device__ __forceinline__ float grad_sq(const RowScalars& r, float g_inv, float slope, float fn,
                                         float lo, float hi) {
  float g_v = __fmul_rn(ldexpf(g_inv, -r.p), slope);
  g_v = __fmul_rn(g_v, npe_clip_factor(r.m, lo, hi));
  if (r.odd) g_v = __fmul_rn(g_v, 0.5f);
  return __fdiv_rn(ldexpf(g_v, -r.e), fn);
}

// d/d(x - mu) of one element, g_sq2 = 2 g_sq: g_sq * (2 d) and (2 g_sq) * d
// are the same product, both doublings exact, so one rounding of the same
// value.
__device__ __forceinline__ float grad_d(float dyc, float gc, float d, float inv, float g_sq2) {
  return __fadd_rn(__fmul_rn(__fmul_rn(dyc, gc), inv), __fmul_rn(g_sq2, d));
}

// One warp a row, VPL 16-byte vectors of x and of dy a lane (vector v of
// the row at lane v % 32, slot v / 32).  Dynamic shared memory: gamma as
// [E / 4][nvec] float4, then each warp's column sums (K = 1 or 2 planes:
// dgamma's, dbeta's) as [K E / 4][32 VPL] float4, so a lane's accesses are
// 16 bytes apart from its neighbours'.
template <typename T, int VPL>
__global__ void __launch_bounds__(GRAD_MAX_WARPS * 32)
nvu_layernorm_grad_warp_kernel(LnGradArgs a) {
  constexpr int E = 16 / sizeof(T), Q = E / 4, H = block_order_groups<E>(), NV = 32 * VPL;
  extern __shared__ float4 lds4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int n = a.n, nvec = n / E, K = a.rms_only ? 1 : 2, segs = a.segs, cols = segs + 1;
  // column `lane` of the rsqrt table and of its slopes, read first
  const float kn = lane >= 1 && lane < segs ? __ldg(a.table + lane) : __int_as_float(0x7fffffff);
  const float ds = lane < segs ? __ldg(a.table + cols + lane) : 0.f;
  const float di = lane < segs ? __ldg(a.table + 2 * cols + lane) : 0.f;
  const float sl = lane < segs ? __ldg(a.slopes + cols + lane) : 0.f;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const int step = gridDim.x * W;
  int row = blockIdx.x * W + warp;
  uint4 rx[VPL], rd[VPL];
  auto load = [&](int r) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)r * n);
    const uint4* dr = reinterpret_cast<const uint4*>(dy + (size_t)r * n);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      rx[i] = v < nvec ? xr[v] : make_uint4(0, 0, 0, 0);
      rd[i] = v < nvec ? dr[v] : make_uint4(0, 0, 0, 0);
    }
  };
  if (row < a.rows) load(row);                     // in flight during the set-up
  float4* __restrict__ gam = lds4;
  float4* __restrict__ acc = lds4 + (size_t)Q * nvec + (size_t)K * Q * NV * warp;
  const float4* g4 = reinterpret_cast<const float4*>(a.gamma);
  for (int f = threadIdx.x; f < Q * nvec; f += blockDim.x) {
    const int q = f / nvec, v = f - q * nvec;
    gam[f] = g4[Q * v + q];
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int q = 0; q < 2 * Q; ++q)
      if (q < K * Q) acc[q * NV + lane + 32 * i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const WarpPwl pwl(kn, ds, di, lane);
  __syncthreads();

  const float fn = (float)n;
  for (; row < a.rows; row += step) {
    auto xv = [&](int i, int p) { return elem16<T>(rx[i], p); };
    auto dyv = [&](int i, int p) { return elem16<T>(rd[i], p); };
    float mu = 0.f;
    if (!a.rms_only) mu = __fdiv_rn(block_order_sum<E, VPL>(lane, nvec, xv), fn);
    // one pass: the variance's block threads (the forward's order) and
    // d/d(inv), E sums a lane, one a position
    float t2[H][E] = {}, gi[E] = {};
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          float4 gq = gam[q * nvec + v];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int pp = 4 * q + j;
            const float d = __fsub_rn(xv(i, pp), mu);
            t2[i % H][pp] = __fadd_rn(t2[i % H][pp], __fmul_rn(d, d));
            gi[pp] = __fadd_rn(gi[pp], __fmul_rn(__fmul_rn(dyv(i, pp), at4(gq, j)), d));
          }
        }
      }
    }
    const RowScalars r = row_scalars(block_order_reduce<E>(t2), fn, a.eps, a.lo, a.hi);
    const int k = pwl.seg(r.mc);
    const float inv = ldexpf(pwl.at(r.mc, k), -r.p);
    float g_inv = gi[0];
#pragma unroll
    for (int pp = 1; pp < E; ++pp) g_inv = __fadd_rn(g_inv, gi[pp]);
    const float g_sq2 = __fmul_rn(2.f, grad_sq(r, npe_warp_sum(g_inv),
                                               __shfl_sync(0xffffffffu, sl, k), fn, a.lo, a.hi));
    // the sum of d/d(x - mu), E sums a lane
    float g_mu = 0.f;
    if (!a.rms_only) {
      float gm[E] = {};
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int v = lane + 32 * i;
        if (v < nvec) {
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            float4 gq = gam[q * nvec + v];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int pp = 4 * q + j;
              gm[pp] = __fadd_rn(gm[pp], grad_d(dyv(i, pp), at4(gq, j),
                                                __fsub_rn(xv(i, pp), mu), inv, g_sq2));
            }
          }
        }
      }
      g_mu = gm[0];
#pragma unroll
      for (int pp = 1; pp < E; ++pp) g_mu = __fadd_rn(g_mu, gm[pp]);
      g_mu = __fdiv_rn(-npe_warp_sum(g_mu), fn);
    }
    // dx, and the row's terms of the warp's column sums
    uint4* dxr = reinterpret_cast<uint4*>(static_cast<T*>(a.dx) + (size_t)row * n);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec) {
        float o[E];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          float4 gq = gam[q * nvec + v];
          float4 ag = acc[q * NV + v];
          float4 ab = K > 1 ? acc[(Q + q) * NV + v] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float d = __fsub_rn(xv(i, 4 * q + j), mu);
            const float dyc = dyv(i, 4 * q + j);
            const float gd = grad_d(dyc, at4(gq, j), d, inv, g_sq2);
            o[4 * q + j] = a.rms_only ? gd : __fadd_rn(gd, g_mu);
            at4(ag, j) = __fadd_rn(at4(ag, j), __fmul_rn(dyc, __fmul_rn(d, inv)));
            at4(ab, j) = __fadd_rn(at4(ab, j), dyc);
          }
          acc[q * NV + v] = ag;
          if (K > 1) acc[(Q + q) * NV + v] = ab;
        }
        dxr[v] = npe_pack16<T>(o);
      }
    }
    if (row + step < a.rows) load(row + step);
  }

  // the block's column sums, its warps' in warp order, to its row of parts
  __syncthreads();
  float* part = a.parts + (size_t)blockIdx.x * K * n;
  const float4* acc0 = lds4 + (size_t)Q * nvec;
  const size_t wsize = (size_t)K * Q * NV;   // float4 of a warp's column sums
  for (int f = threadIdx.x; f < K * Q * nvec; f += blockDim.x) {
    const int kq = f / nvec, v = f - kq * nvec, kk = kq / Q, q = kq - kk * Q;
    const float4* src = acc0 + (size_t)kq * NV + v;
    float4 t = src[0];
    for (int w = 1; w < W; ++w) {
      const float4 u = src[w * wsize];
      t = make_float4(__fadd_rn(t.x, u.x), __fadd_rn(t.y, u.y), __fadd_rn(t.z, u.z),
                      __fadd_rn(t.w, u.w));
    }
    reinterpret_cast<float4*>(part + (size_t)kk * n)[Q * v + q] = t;
  }
}

// One block a row, 256 threads; thread t takes the columns t, t + 256, ...
// in each pass, as the forward's block instance does.  STAGED: the row's x
// and dy are kept as f32 in shared memory (each thread reads back only what
// it wrote), else read again from global memory in each pass.
template <typename T, bool STAGED>
__global__ void __launch_bounds__(THREADS)
nvu_layernorm_grad_block_kernel(LnGradArgs a) {
  extern __shared__ float row_buf[];   // STAGED: x then dy, n floats each
  __shared__ float tab[3 * NPE_MAX_TABLE_COLS], stab[2 * NPE_MAX_TABLE_COLS];
  __shared__ float red[32];
  npe_load_table(tab, a.table, a.segs + 1);
  npe_load_slope_table(stab, a.slopes, a.segs + 1);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  const int n = a.n, K = a.rms_only ? 1 : 2;
  float* part = a.parts + (size_t)blockIdx.x * K * n;   // a thread's own columns only
  for (int c = threadIdx.x; c < n; c += THREADS) {
    part[c] = 0.f;
    if (K > 1) part[n + c] = 0.f;
  }
  const float fn = (float)n;
  for (int row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const size_t base = (size_t)row * n;
    auto X = [&](int c) { return STAGED ? row_buf[c] : npe_to_f32(x[base + c]); };
    auto DY = [&](int c) { return STAGED ? row_buf[n + c] : npe_to_f32(dy[base + c]); };
    float s = 0.f;
    for (int c = threadIdx.x; c < n; c += THREADS) {
      const float xc = npe_to_f32(x[base + c]);
      if (STAGED) {
        row_buf[c] = xc;
        row_buf[n + c] = npe_to_f32(dy[base + c]);
      }
      s = __fadd_rn(s, xc);
    }
    const float mu = a.rms_only ? 0.f : __fdiv_rn(block_sum(s, red), fn);
    float s2 = 0.f;
    for (int c = threadIdx.x; c < n; c += THREADS) {
      const float d = __fsub_rn(X(c), mu);
      s2 = __fadd_rn(s2, __fmul_rn(d, d));
    }
    const RowScalars r = row_scalars(block_sum(s2, red), fn, a.eps, a.lo, a.hi);  // syncs tab
    const float inv = ldexpf(npe_pwl(r.mc, tab, a.segs), -r.p);
    float g_inv = 0.f;
    for (int c = threadIdx.x; c < n; c += THREADS)
      g_inv = __fadd_rn(g_inv, __fmul_rn(__fmul_rn(DY(c), __ldg(a.gamma + c)), __fsub_rn(X(c), mu)));
    const float g_sq2 = __fmul_rn(
        2.f, grad_sq(r, block_sum(g_inv, red), npe_pwl_slope(r.mc, stab, a.segs), fn, a.lo, a.hi));
    float g_mu = 0.f;
    if (!a.rms_only) {
      for (int c = threadIdx.x; c < n; c += THREADS)
        g_mu = __fadd_rn(g_mu, grad_d(DY(c), __ldg(a.gamma + c), __fsub_rn(X(c), mu), inv, g_sq2));
      g_mu = __fdiv_rn(-block_sum(g_mu, red), fn);
    }
    for (int c = threadIdx.x; c < n; c += THREADS) {
      const float d = __fsub_rn(X(c), mu), dyc = DY(c);
      const float gd = grad_d(dyc, __ldg(a.gamma + c), d, inv, g_sq2);
      dx[base + c] = npe_from_f32<T>(a.rms_only ? gd : __fadd_rn(gd, g_mu));
      part[c] = __fadd_rn(part[c], __fmul_rn(dyc, __fmul_rn(d, inv)));
      if (K > 1) part[n + c] = __fadd_rn(part[n + c], dyc);
    }
  }
}

using LnGradKernel = void (*)(LnGradArgs);

// The warp instance for `vpl` vectors a lane: the smallest of 1, 2, 3, 4,
// 6, 8, 12, 16 that holds them; `held` its VPL.
template <typename T>
LnGradKernel grad_warp_instance(int vpl, int& held) {
#define NPE_LN_GRAD_WARP(V)                      \
  if (vpl <= V) {                                 \
    held = V;                                     \
    return nvu_layernorm_grad_warp_kernel<T, V>;  \
  }
  NPE_LN_GRAD_WARP(1); NPE_LN_GRAD_WARP(2); NPE_LN_GRAD_WARP(3); NPE_LN_GRAD_WARP(4);
  NPE_LN_GRAD_WARP(6); NPE_LN_GRAD_WARP(8); NPE_LN_GRAD_WARP(12); NPE_LN_GRAD_WARP(16);
#undef NPE_LN_GRAD_WARP
  return nullptr;
}

// The instance, block size, shared memory and grid of a backward call.
struct LnGradPlan {
  LnGradKernel kernel;
  int threads, blocks;
  size_t smem;
};

// Blocks of `kernel` an SM holds at once with `smem` bytes of dynamic
// shared memory, cached by (kernel, threads, smem).  A kernel's limit of
// dynamic shared memory is only ever raised (to the largest asked of it).
int resident_blocks(const void* kernel, int threads, size_t smem, int& resident) {
  struct Entry { const void* kernel; int threads; size_t smem; int resident; };
  struct Limit { const void* kernel; size_t granted; };
  static Entry seen[64];
  static Limit limits[64];
  static int count = 0, kernels = 0;
  for (int i = 0; i < count; ++i)
    if (seen[i].kernel == kernel && seen[i].threads == threads && seen[i].smem == smem) {
      resident = seen[i].resident;
      return 0;
    }
  int li = 0;
  while (li < kernels && limits[li].kernel != kernel) ++li;
  if (li == kernels) {
    if (kernels == 64) return (int)cudaErrorInvalidValue;
    limits[kernels++] = Limit{kernel, 0};
  }
  if (smem > limits[li].granted) {
    if (const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
      return (int)err;
    limits[li].granted = smem;
  }
  if (const cudaError_t err =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, smem))
    return (int)err;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  if (count < 64) seen[count++] = Entry{kernel, threads, smem, resident};
  return 0;
}

// Warp per row: 16-byte aligned rows of up to 2048 f32 or 4096 bf16 columns
// and tables of up to 32 columns; block per row: the rest.  The grid: a row
// a warp or at least GRAD_MIN_ROWS a block (fewer blocks' column sums to
// add), at most the blocks resident at once.
int plan_grad(const void* x, const void* dy, const float* gamma, const void* dx, int rows, int n,
              int bf16, int rms_only, int segs, LnGradPlan& pl) {
  using bf = __nv_bfloat16;
  const int elem = bf16 ? 2 : 4, E = 16 / elem, K = rms_only ? 1 : 2;
  const bool warp = segs + 1 <= 32 && (n * elem) % 16 == 0 && n <= (bf16 ? 4096 : 2048) &&
                    aligned16(x) && aligned16(dy) && aligned16(dx) && aligned16(gamma);
  int rows_a_block = GRAD_MIN_ROWS;
  if (warp) {
    int held = 0;
    const int vpl = (n / E + 31) / 32;
    pl.kernel = bf16 ? grad_warp_instance<bf>(vpl, held) : grad_warp_instance<float>(vpl, held);
    // warps a block: of 8, 4, 2, the one that keeps the most warps an SM
    // (the warps' column sums in shared memory bound it as the registers do)
    const size_t acc = (size_t)K * (E / 4) * 32 * held * 16;   // a warp's column sums
    int best = 0;
    for (int w = GRAD_MAX_WARPS; w >= 2; w >>= 1) {
      if (w * acc > GRAD_ACC_BYTES) continue;
      const size_t smem = (size_t)n * sizeof(float) + w * acc;
      int resident = 0;
      if (int err = resident_blocks(reinterpret_cast<const void*>(pl.kernel), 32 * w, smem,
                                    resident))
        return err;
      if (resident * w > best) {
        best = resident * w;
        pl.threads = 32 * w;
        pl.smem = smem;
      }
    }
    if (best == 0) return (int)cudaErrorInvalidConfiguration;
    rows_a_block = pl.threads / 32;
  } else {
    const bool staged = n <= GRAD_STAGE_COLS;
    if (bf16)
      pl.kernel = staged ? nvu_layernorm_grad_block_kernel<bf, true>
                         : nvu_layernorm_grad_block_kernel<bf, false>;
    else
      pl.kernel = staged ? nvu_layernorm_grad_block_kernel<float, true>
                         : nvu_layernorm_grad_block_kernel<float, false>;
    pl.threads = THREADS;
    pl.smem = staged ? 2 * (size_t)n * sizeof(float) : 0;
  }
  int resident = 0;
  if (int err = resident_blocks(reinterpret_cast<const void*>(pl.kernel), pl.threads, pl.smem,
                                resident))
    return err;
  const long long need = ((long long)rows + rows_a_block - 1) / rows_a_block;
  const long long cap = (long long)npe_sm_count() * resident;
  pl.blocks = (int)(need < cap ? need : cap);
  return 0;
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

// The row pass's grid in npe_nvu_layernorm_grad for these operands: the
// blocks whose column sums `parts` must hold (blocks * (rms_only ? 1 : 2) *
// n floats), or minus a cudaError_t.
extern "C" int npe_nvu_layernorm_grad_blocks(const void* x, const void* dy, const float* gamma,
                                             const void* dx, int rows, int n, int bf16,
                                             int rms_only, int segments) {
  if (segments < 1 || segments + 1 > NPE_MAX_TABLE_COLS) return -(int)cudaErrorInvalidValue;
  if (rows <= 0 || n <= 0) return 0;
  LnGradPlan pl;
  if (int err = plan_grad(x, dy, gamma, dx, rows, n, bf16, rms_only, segments, pl)) return -err;
  return pl.blocks;
}

// The backward of npe_nvu_layernorm on the same x, gamma and options: dx in
// x's dtype from dy in the same dtype, dgamma and (without rms_only) dbeta
// f32.  `parts` holds `parts_blocks` blocks' column sums
// (npe_nvu_layernorm_grad_blocks).  Two launches: the row pass, then the
// reduction of its column sums.
extern "C" int npe_nvu_layernorm_grad(const void* x, const void* dy, const float* gamma,
                                      void* dx, float* dgamma, float* dbeta, float* parts,
                                      int parts_blocks, int rows, int n, int bf16,
                                      float eps, int rms_only, const float* table,
                                      const float* slopes, int segments, float lo, float hi,
                                      void* stream) {
  if (segments < 1 || segments + 1 > NPE_MAX_TABLE_COLS || (!rms_only && dbeta == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n <= 0) return 0;
  LnGradPlan pl;
  if (int err = plan_grad(x, dy, gamma, dx, rows, n, bf16, rms_only, segments, pl)) return err;
  if (pl.blocks > parts_blocks) return (int)cudaErrorInvalidValue;
  const LnGradArgs a{x, dy, gamma, dx, parts, rows, n, eps, rms_only, table, slopes,
                     segments, lo, hi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pl.kernel<<<pl.blocks, pl.threads, pl.smem, s>>>(a);
  if (const cudaError_t err = cudaGetLastError()) return (int)err;
  const int cols = (rms_only ? 1 : 2) * n;
  nvu_layernorm_grad_reduce_kernel<<<(cols + RED_COLS - 1) / RED_COLS, RED_COLS * RED_SLICES, 0,
                                     s>>>(parts, pl.blocks, cols, n, dgamma, dbeta);
  return (int)cudaGetLastError();
}
