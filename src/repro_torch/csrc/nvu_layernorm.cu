// NVU layernorm / rmsnorm on Hopper with a PWL 1/sqrt.
//
// Replaces: nvu_layernorm_rows / _layernorm_kernel (and rsqrt_via_pwl) in
// src/repro/kernels/nvu_layernorm.py.
// Bound on this card: bytes.  Each element is read once and written once
// (2+2 bytes in bf16 on the BERT path, 4+4 in f32), plus gamma and beta,
// against a handful of operations.
// Design: one block of 256 threads per row.  The row is read from device
// memory once, converted to f32 and kept in shared memory; the mean and the
// variance are two passes over that copy (two-pass, not E[x^2] - E[x]^2),
// each a warp-shuffle reduction followed by one across the block's warps.
// 1/sqrt(var + eps) is the PWL of the mantissa normalized to [0.25, 1) by
// powers of four, with the exponent handled by integer bit operations and
// the odd-exponent case folded into the mantissa, so there is no sqrt or
// divide besides the two means.
#include "pwl.cuh"

namespace {

constexpr int THREADS = 256;

// 1/sqrt(v) for v > 0: v = m * 4^p with m in [0.25, 1) => pwl(m) * 2^-p.
__device__ __forceinline__ float rsqrt_via_pwl(float v, const float* tab, int segs) {
  const int bits = __float_as_int(v);
  const int e = ((bits >> 23) & 0xff) - 126;          // v = m * 2^e, m in [0.5, 1)
  const int odd = e & 1;
  const int e_even = e + odd;
  float m = __int_as_float((bits & 0x007fffff) | (126 << 23));
  if (odd) m = __fmul_rn(m, 0.5f);                    // [0.25, 0.5)
  const float r = npe_pwl(m, tab, segs);
  const int p = e_even >> 1;
  const int pow_field = min(max(127 - p, 1), 254);
  return __fmul_rn(r, __int_as_float(pow_field << 23));
}

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
  const float inv = rsqrt_via_pwl(__fadd_rn(var, eps), tab, segs);

  for (int c = threadIdx.x; c < n; c += THREADS) {
    float o = __fmul_rn(__fmul_rn(__fsub_rn(row_buf[c], mu), inv), gamma[c]);
    if (beta != nullptr) o = __fadd_rn(o, beta[c]);
    y[base + c] = npe_from_f32<T>(o);
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
  const size_t smem = (size_t)n * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    nvu_layernorm_kernel<__nv_bfloat16><<<rows, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        gamma, beta, n, eps, rms_only, table, segments);
  else
    nvu_layernorm_kernel<float><<<rows, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), gamma, beta, n,
        eps, rms_only, table, segments);
  return (int)cudaGetLastError();
}
