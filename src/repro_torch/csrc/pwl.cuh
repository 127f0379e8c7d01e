// Shared device code of the NPE kernels: the prefix-delta PWL evaluator
// (the counterpart of `pwl_tile` in src/repro/kernels/pwl_eval.py) and the
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
