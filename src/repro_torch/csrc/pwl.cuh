// Shared device code of the NPE kernels: the prefix-delta PWL evaluator
// (the counterpart of `pwl_tile` in src/repro/kernels/pwl_eval.py), the
// prefix-table evaluator that gives its results by a search, and the
// f32/bf16 conversions.
//
// A packed table is (3, S+1) float32, row-major, as `pack_table` builds it:
//   row 0: [0, knot_1 .. knot_{S-1}, 0]   (the interior knots)
//   row 1: [slope_0, slope_1 - slope_0, ..., 0]
//   row 2: [icept_0, icept_1 - icept_0, ..., 0]
// so slope(x) = slope_0 + sum_i dslope_i * [x >= knot_i], and likewise the
// intercept.  Guard knots at +-65536 live inside the table, so evaluation
// is branch-free over the whole f32 range; S comes from the table.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Largest S+1 a kernel takes: the table sits in shared memory.
#define NPE_MAX_TABLE_COLS 128

// Copy a packed table into shared memory; the caller syncs after it.
__device__ __forceinline__ void npe_load_table(float* dst, const float* src,
                                               int cols) {
  for (int i = threadIdx.x; i < 3 * cols; i += blockDim.x) dst[i] = src[i];
}

// v(x) = slope(x) * x + icept(x).  The _rn intrinsics keep nvcc from
// contracting the last step into an FMA, so the kernel rounds where the
// reference does.
__device__ __forceinline__ float npe_pwl(float x, const float* tab, int s) {
  const float* knots = tab;
  const float* dslope = tab + (s + 1);
  const float* dicept = tab + 2 * (s + 1);
  float slope = dslope[0];
  float icept = dicept[0];
  for (int i = 1; i < s; ++i) {
    if (x >= knots[i]) {
      slope = __fadd_rn(slope, dslope[i]);
      icept = __fadd_rn(icept, dicept[i]);
    }
  }
  return __fadd_rn(__fmul_rn(slope, x), icept);
}

// npe_pwl on N values at once, in place: each table entry is read from
// shared memory once for all N, which is what bounds a one-value loop (three
// shared loads for each knot of each value).  The arithmetic of each value
// is that of npe_pwl.
template <int N>
__device__ __forceinline__ void npe_pwl_n(float (&v)[N], const float* tab, int s) {
  const float* knots = tab;
  const float* dslope = tab + (s + 1);
  const float* dicept = tab + 2 * (s + 1);
  float slope[N], icept[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    slope[j] = dslope[0];
    icept[j] = dicept[0];
  }
  for (int i = 1; i < s; ++i) {
    const float k = knots[i], ds = dslope[i], di = dicept[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (v[j] >= k) {
        slope[j] = __fadd_rn(slope[j], ds);
        icept[j] = __fadd_rn(icept[j], di);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = __fadd_rn(__fmul_rn(slope[j], v[j]), icept[j]);
}

// --- the prefix-table evaluator -------------------------------------------
// The knots of every table ascend, so an x that passes interior knots 1..k
// leaves the walk of npe_pwl at exactly slope = P_slope[k] and icept =
// P_icept[k], the in-order round-to-nearest sums d_0 + d_1 + ... + d_k.  So
// P_slope[seg] * x + P_icept[seg], with seg the count of interior knots <= x,
// is npe_pwl bit for bit: a binary search over the knots and two gathers in
// place of a compare and two adds for every knot.

// Knot slots of a prefix table: the search reads up to index 2*top - 1,
// top the largest power of two <= S-1 (at most 64 when S+1 <= 128).
#define NPE_PREFIX_KNOTS 128

struct NpePrefixTable {
  float knot[NPE_PREFIX_KNOTS];   // [1..S-1] the interior knots, the rest NaN
  float2 si[NPE_MAX_TABLE_COLS];  // [k] = (P_slope[k], P_icept[k]), k in 0..S-1
};

// What one thread of a block of at least NPE_PREFIX_KNOTS threads reads of
// a packed table for npe_build_prefix_table: the knot of its slot and the
// deltas of column threadIdx.x.  A kernel fetches it before its own loads,
// so the table's few hundred bytes do not queue behind them.
struct NpePrefixFetch {
  float knot, dslope, dicept;
  __device__ __forceinline__ NpePrefixFetch(const float* __restrict__ src, int segs) {
    const int i = threadIdx.x, cols = segs + 1;
    knot = i >= 1 && i < segs ? __ldg(src + i) : __int_as_float(0x7fffffff);
    dslope = i < segs ? __ldg(src + cols + i) : 0.f;
    dicept = i < segs ? __ldg(src + 2 * cols + i) : 0.f;
  }
};

// The block's part of a prefix table's build: each thread writes what it
// fetched, the knot of its slot and the deltas to the prefix rows' slots.
__device__ __forceinline__ void npe_fill_prefix_table(NpePrefixTable& t, const NpePrefixFetch& f,
                                                      int segs) {
  if (threadIdx.x < NPE_PREFIX_KNOTS) t.knot[threadIdx.x] = f.knot;
  if ((int)threadIdx.x < segs) t.si[threadIdx.x] = make_float2(f.dslope, f.dicept);
}

// After the fill and a sync: threads `lead` (slopes) and lead + 1
// (intercepts) turn each row into its in-order sums in place, S-1
// __fadd_rn one after another, the sums the walk reaches.
__device__ __forceinline__ void npe_sum_prefix_rows(NpePrefixTable& t, int segs, int lead) {
  const int r = (int)threadIdx.x - lead;
  if (r == 0 || r == 1) {
    float* row = reinterpret_cast<float*>(t.si) + r;
    float acc = row[0];
    for (int i = 1; i < segs; ++i) {
      acc = __fadd_rn(acc, row[2 * i]);
      row[2 * i] = acc;
    }
  }
}

// Write a prefix table from what the threads fetched; ends with the block
// synced.  A padded knot is NaN, which no x is >=, so the search never
// passes it.
__device__ __forceinline__ void npe_build_prefix_table(NpePrefixTable& t, const NpePrefixFetch& f,
                                                       int segs) {
  npe_fill_prefix_table(t, f, segs);
  __syncthreads();
  npe_sum_prefix_rows(t, segs, 0);
  __syncthreads();
}

// Two prefix tables with one pair of syncs: the second's sums run on
// threads 32 and 33, a warp of their own, beside the first's.
__device__ __forceinline__ void npe_build_prefix_tables(NpePrefixTable& t0, const NpePrefixFetch& f0,
                                                        int segs0, NpePrefixTable& t1,
                                                        const NpePrefixFetch& f1, int segs1) {
  npe_fill_prefix_table(t0, f0, segs0);
  npe_fill_prefix_table(t1, f1, segs1);
  __syncthreads();
  npe_sum_prefix_rows(t0, segs0, 0);
  npe_sum_prefix_rows(t1, segs1, 32);
  __syncthreads();
}

// The largest power of two <= segs - 1 (0 for one segment): the first step
// of the search.
__device__ __forceinline__ int npe_prefix_top(int segs) {
  return segs > 1 ? 1 << (31 - __clz(segs - 1)) : 0;
}

// The segment of each of N values over NPE_PREFIX_KNOTS knot slots in
// shared memory (a prefix table's `knot` row: [1..S-1] the interior knots,
// the rest NaN): k = 4 * seg, seg the count of interior knots <= x, found by
// binary lifting over the ascending knots: the first two steps read knots
// every thread shares (kept in registers), the rest one knot each.  Offsets
// are kept in bytes, so each step is an add, a load, a compare and a select.
template <int N>
__device__ __forceinline__ void npe_knot_seg_n(const float (&v)[N], int (&k)[N],
                                               const float* knot, int top) {
  const char* kb = reinterpret_cast<const char*>(knot);
#pragma unroll
  for (int j = 0; j < N; ++j) k[j] = 0;
  if (top > 0) {
    const float k_top = knot[top];
#pragma unroll
    for (int j = 0; j < N; ++j) k[j] = v[j] >= k_top ? 4 * top : 0;
    int step = top >> 1;
    if (step > 0) {
      const float k_lo = knot[step], k_hi = knot[top + step];
#pragma unroll
      for (int j = 0; j < N; ++j)
        k[j] = v[j] >= (k[j] ? k_hi : k_lo) ? k[j] + 4 * step : k[j];
      for (step *= 2; step >= 4; step >>= 1) {   // step in bytes: 4 * (step / 2)
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int c = k[j] + step;
          k[j] = v[j] >= *reinterpret_cast<const float*>(kb + c) ? c : k[j];
        }
      }
    }
  }
}

// The same search over a prefix table's knots.
template <int N>
__device__ __forceinline__ void npe_prefix_seg_n(const float (&v)[N], int (&k)[N],
                                                 const NpePrefixTable& t, int top) {
  npe_knot_seg_n<N>(v, k, t.knot, top);
}

// npe_pwl on N values at once, in place, from a prefix table: the segment
// by npe_prefix_seg_n, then its two prefixes, one 8-byte load.
template <int N>
__device__ __forceinline__ void npe_pwl_prefix_n(float (&v)[N], const NpePrefixTable& t,
                                                 int top) {
  int k[N];
  npe_prefix_seg_n<N>(v, k, t, top);
  const char* sb = reinterpret_cast<const char*>(t.si);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float2 p = *reinterpret_cast<const float2*>(sb + 2 * k[j]);
    v[j] = __fadd_rn(__fmul_rn(p.x, v[j]), p.y);
  }
}

// npe_pwl_prefix_n that also gives each value's derivative from the same
// search: d[j] = slope[seg], `slope` the reference table's S slopes (row 1
// of a slope table, below).  The walk's rule and the search count the same
// knots, so the pair is npe_pwl and npe_pwl_slope bit for bit.
template <int N>
__device__ __forceinline__ void npe_pwl_prefix_slope_n(float (&v)[N], float (&d)[N],
                                                       const NpePrefixTable& t,
                                                       const float* slope, int top) {
  int k[N];
  npe_prefix_seg_n<N>(v, k, t, top);
  const char* sb = reinterpret_cast<const char*>(t.si);
  const char* db = reinterpret_cast<const char*>(slope);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float2 p = *reinterpret_cast<const float2*>(sb + 2 * k[j]);
    d[j] = *reinterpret_cast<const float*>(db + k[j]);
    v[j] = __fadd_rn(__fmul_rn(p.x, v[j]), p.y);
  }
}

// The slope of each of N values' segments alone, by the same search:
// d[j] = slope[seg], `knot` as npe_knot_seg_n takes it and `slope` the
// reference table's S slopes (row 1 of a slope table, below).  The search
// counts the knots the walk's rule counts, so d[j] is npe_pwl_slope's value
// bit for bit.
template <int N>
__device__ __forceinline__ void npe_pwl_slope_n(const float (&v)[N], float (&d)[N],
                                                const float* knot, const float* slope, int top) {
  int k[N];
  npe_knot_seg_n<N>(v, k, knot, top);
  const char* db = reinterpret_cast<const char*>(slope);
#pragma unroll
  for (int j = 0; j < N; ++j) d[j] = *reinterpret_cast<const float*>(db + k[j]);
}

// --- the NVU softmax's pieces ---------------------------------------------
// Shared by the row softmax (nvu_softmax.cu) and the dense mode of flash
// attention (flash_attention.cu): the reference's nvu_exp of scores already
// less their row max, and the PWL reciprocal of the row's sum.

// exp of N values z = s - max, in place: range-limited at -18 (the exp
// table's left edge), the PWL from the prefix table, floored at 0.
template <int N>
__device__ __forceinline__ void npe_softmax_exp_n(float (&z)[N], const NpePrefixTable& t,
                                                  int top) {
#pragma unroll
  for (int j = 0; j < N; ++j) z[j] = fmaxf(z[j], -18.f);
  npe_pwl_prefix_n<N>(z, t, top);
#pragma unroll
  for (int j = 0; j < N; ++j) z[j] = fmaxf(z[j], 0.f);
}

// The SM count of the current device (132 on an H100 SXM if it cannot be read).
static inline int npe_sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

// 1/s for s > 0 without a divide (recip_via_pwl in
// src/repro/kernels/nvu_softmax.py): s = m * 2^e with m in [0.5, 1), so
// 1/s = pwl_recip(m) * 2^-e, the exponent taken and put back by integer
// bit operations.
__device__ __forceinline__ float npe_recip_via_pwl(float s, const float* tab, int segs) {
  const int bits = __float_as_int(s);
  const int e_biased = (bits >> 23) & 0xff;          // e_biased - 126 = e
  const float m = __int_as_float((bits & 0x007fffff) | (126 << 23));
  const float r = npe_pwl(m, tab, segs);
  const int pow_field = min(max(253 - e_biased, 1), 254);
  return __fmul_rn(r, __int_as_float(pow_field << 23));
}

// npe_recip_via_pwl with the mantissa's PWL from a prefix table: the same
// bits by a search in place of the walk.
__device__ __forceinline__ float npe_recip_via_prefix(float s, const NpePrefixTable& t, int top) {
  const int bits = __float_as_int(s);
  const int e_biased = (bits >> 23) & 0xff;
  float m[1] = {__int_as_float((bits & 0x007fffff) | (126 << 23))};
  npe_pwl_prefix_n<1>(m, t, top);
  const int pow_field = min(max(253 - e_biased, 1), 254);
  return __fmul_rn(m[0], __int_as_float(pow_field << 23));
}

// 1 / max(l, 1e-30): the softmax's reciprocal of its sum, from the recip
// table's prefix form (`top` = npe_prefix_top of its segments).
__device__ __forceinline__ float npe_softmax_inv(float l, const NpePrefixTable& t, int top) {
  return npe_recip_via_prefix(fmaxf(l, 1e-30f), t, top);
}

// --- derivatives ------------------------------------------------------------
// The backward kernels differentiate the reference's jnp code as jax.grad
// does.  A PWL's derivative at x is the slope of x's segment, the segment
// found by the walk's rule (the count of interior knots <= x, as the
// reference's `sum(x >= knots[1:-1])`).  A slope table is (2, S+1) float32,
// as `slope_table` builds it: row 0 the packed table's knot row, row 1 the
// reference table's S slopes themselves (not their deltas), then a 0.

// Copy a slope table into shared memory; the caller syncs after it.
__device__ __forceinline__ void npe_load_slope_table(float* dst, const float* src, int cols) {
  for (int i = threadIdx.x; i < 2 * cols; i += blockDim.x) dst[i] = src[i];
}

// The slope of x's segment.
__device__ __forceinline__ float npe_pwl_slope(float x, const float* stab, int s) {
  int seg = 0;
  for (int i = 1; i < s; ++i) seg += x >= stab[i];
  return stab[(s + 1) + seg];
}

// What a gradient is multiplied by through jnp.clip(x, lo, hi) and through
// jnp.maximum(v, floor): 1 on the passing side, 1/2 at a tie (jax splits
// the gradient of a tied max or min evenly), 0 on the other side.
__device__ __forceinline__ float npe_clip_factor(float x, float lo, float hi) {
  return (x < lo || x > hi) ? 0.f : ((x == lo || x == hi) ? 0.5f : 1.f);
}
__device__ __forceinline__ float npe_max_factor(float v, float floor) {
  return v > floor ? 1.f : (v == floor ? 0.5f : 0.f);
}

__device__ __forceinline__ float npe_to_f32(float v) { return v; }
__device__ __forceinline__ float npe_to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T npe_from_f32(float v);
template <>
__device__ __forceinline__ float npe_from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 npe_from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch's cast
}

// The 16 / sizeof(T) values of T in one 16-byte vector, as f32 (exact).
template <typename T>
__device__ __forceinline__ void npe_unpack16(const uint4& r, float* f) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (sizeof(T) == 2) {
      f[2 * q] = __uint_as_float(w[q] << 16);
      f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    } else {
      f[q] = __uint_as_float(w[q]);
    }
  }
}

// 16 / sizeof(T) f32 values as T in one 16-byte vector, rounded to nearest even.
template <typename T>
__device__ __forceinline__ uint4 npe_pack16(const float* f) {
  if constexpr (sizeof(T) == 2) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
      w[q] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
}

__device__ __forceinline__ float npe_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float npe_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
