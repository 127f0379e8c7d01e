// Elementwise PWL evaluation on Hopper.
//
// Replaces: pwl_eval_2d / _pwl_kernel in src/repro/kernels/pwl_eval.py.
// Bound on this card: bytes.  Each element is read once and written once
// (4+4 bytes in f32, 2+2 in bf16) against S-1 compares and two adds from a
// table of a few hundred bytes, far below the 295 operations per byte where
// the card stops being memory-bound.
// Design: the table is copied once per block into shared memory, where
// every thread of a warp reads the same word (a broadcast).  Each thread
// takes four consecutive elements per step of a grid-stride loop, so each
// table entry read from shared memory serves four evaluations (with one
// element per thread those reads, not device memory, set the pace); the
// ragged end is masked, so nothing is padded to block multiples.
#include "pwl.cuh"

constexpr int VALUES = 4;   // elements per thread per step, sharing table reads

template <typename TI, typename TO>
__global__ void __launch_bounds__(256)
pwl_eval_kernel(const TI* __restrict__ x, TO* __restrict__ y, long long n,
                const float* __restrict__ table, int segs) {
  __shared__ float tab[3 * NPE_MAX_TABLE_COLS];
  npe_load_table(tab, table, segs + 1);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x * VALUES;
  for (long long base = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VALUES;
       base < n; base += stride) {
    float v[VALUES];
#pragma unroll
    for (int j = 0; j < VALUES; ++j)
      v[j] = base + j < n ? npe_to_f32(x[base + j]) : 0.f;
    npe_pwl_n<VALUES>(v, tab, segs);
#pragma unroll
    for (int j = 0; j < VALUES; ++j)
      if (base + j < n) y[base + j] = npe_from_f32<TO>(v[j]);
  }
}

template <typename TI, typename TO>
static void launch(const void* x, void* y, long long n, const float* table,
                   int segs, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n + threads * VALUES - 1) / (threads * VALUES);
  if (blocks > 132 * 16) blocks = 132 * 16;
  pwl_eval_kernel<TI, TO><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<TO*>(y), n, table, segs);
}

extern "C" int npe_pwl_eval(const void* x, void* y, long long n, int x_bf16,
                            int y_bf16, const float* table, int segments,
                            void* stream) {
  if (segments < 1 || segments + 1 > NPE_MAX_TABLE_COLS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && y_bf16) launch<__nv_bfloat16, __nv_bfloat16>(x, y, n, table, segments, s);
  else if (x_bf16) launch<__nv_bfloat16, float>(x, y, n, table, segments, s);
  else if (y_bf16) launch<float, __nv_bfloat16>(x, y, n, table, segments, s);
  else launch<float, float>(x, y, n, table, segments, s);
  return (int)cudaGetLastError();
}
