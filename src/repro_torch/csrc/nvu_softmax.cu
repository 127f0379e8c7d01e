// NVU row softmax on Hopper: max, PWL exp, sum, PWL reciprocal.
//
// Replaces: nvu_softmax_rows / _softmax_kernel (and recip_via_pwl) in
// src/repro/kernels/nvu_softmax.py.
// Bound on this card: bytes.  Each score is read once and each probability
// written once (8 bytes an element in f32) against some forty operations.
// Design: one warp per row.  The row (128 scores on the BERT path) is loaded
// once into registers, VPT values per lane, and never read again: the max
// and the sum are warp-shuffle reductions, with no shared memory and no
// __syncthreads after the tables are staged.  The PWL exp walks the table
// once for all of a lane's values, so each shared-memory read of the table
// serves VPT of them.  1/sum is the PWL reciprocal of the mantissa with the
// exponent handled by integer bit operations, as on the TPU
// (npe_recip_via_pwl in pwl.cuh), so the kernel has no divide.  The causal
// option masks column c of row r when c > r % q + (n - q): the last query
// of each (q, n) matrix sees the last key, as the reference oracle
// (kernels/ref.py) has it.
#include "pwl.cuh"

namespace {

constexpr int WARPS = 4;   // rows per block

template <int VPT>
__global__ void __launch_bounds__(32 * WARPS)
nvu_softmax_kernel(const float* __restrict__ x, float* __restrict__ y, int rows,
                   int n, int causal_rows, const float* __restrict__ exp_table,
                   int exp_segs, const float* __restrict__ recip_table,
                   int recip_segs) {
  __shared__ float etab[3 * NPE_MAX_TABLE_COLS];
  __shared__ float rtab[3 * NPE_MAX_TABLE_COLS];
  npe_load_table(etab, exp_table, exp_segs + 1);
  npe_load_table(rtab, recip_table, recip_segs + 1);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + (size_t)row * n;
  int visible = n;   // columns c < visible are unmasked
  if (causal_rows > 0) visible = row % causal_rows + (n - causal_rows) + 1;

  const float neg_inf = __int_as_float(0xff800000);
  float v[VPT];
  float m = neg_inf;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    float t = neg_inf;
    if (c < n) t = c < visible ? xr[c] : -1e30f;
    v[j] = t;
    m = fmaxf(m, t);
  }
  m = npe_warp_max(m);

#pragma unroll
  for (int j = 0; j < VPT; ++j)
    v[j] = lane + 32 * j < n ? fmaxf(__fsub_rn(v[j], m), -18.f) : 0.f;   // range limiting
  npe_pwl_n<VPT>(v, etab, exp_segs);   // one pass over the table for the lane's values
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    v[j] = lane + 32 * j < n ? fmaxf(v[j], 0.f) : 0.f;
    s = __fadd_rn(s, v[j]);
  }
  s = npe_warp_sum(s);
  const float inv = npe_recip_via_pwl(fmaxf(s, 1e-30f), rtab, recip_segs);

  float* yr = y + (size_t)row * n;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    if (c < n) yr[c] = __fmul_rn(v[j], inv);
  }
}

template <int VPT>
void launch_softmax(const float* x, float* y, int rows, int n, int causal_rows,
                    const float* et, int es, const float* rt, int rs,
                    cudaStream_t stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  nvu_softmax_kernel<VPT><<<blocks, 32 * WARPS, 0, stream>>>(
      x, y, rows, n, causal_rows, et, es, rt, rs);
}

}  // namespace

extern "C" int npe_nvu_softmax(const float* x, float* y, int rows, int n,
                               int causal_rows, const float* exp_table,
                               int exp_segments, const float* recip_table,
                               int recip_segments, void* stream) {
  if (exp_segments < 1 || exp_segments + 1 > NPE_MAX_TABLE_COLS ||
      recip_segments < 1 || recip_segments + 1 > NPE_MAX_TABLE_COLS ||
      n > 1024 || causal_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 32) launch_softmax<1>(x, y, rows, n, causal_rows, exp_table, exp_segments, recip_table, recip_segments, s);
  else if (n <= 64) launch_softmax<2>(x, y, rows, n, causal_rows, exp_table, exp_segments, recip_table, recip_segments, s);
  else if (n <= 128) launch_softmax<4>(x, y, rows, n, causal_rows, exp_table, exp_segments, recip_table, recip_segments, s);
  else if (n <= 256) launch_softmax<8>(x, y, rows, n, causal_rows, exp_table, exp_segments, recip_table, recip_segments, s);
  else if (n <= 512) launch_softmax<16>(x, y, rows, n, causal_rows, exp_table, exp_segments, recip_table, recip_segments, s);
  else launch_softmax<32>(x, y, rows, n, causal_rows, exp_table, exp_segments, recip_table, recip_segments, s);
  return (int)cudaGetLastError();
}
