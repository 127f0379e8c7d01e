// The MMU on Hopper: int8 x int8 -> exact int32, dequantized in the epilogue.
//
// Replaces: quant_matmul / _quant_matmul_kernel in
// src/repro/kernels/quant_matmul.py.
// Bound on this card: at BERT-base 8x128 (M=1024) the two bounds lie within
// about 1.3x of each other: bytes (the f32 or bf16 output outweighs the int8
// operands) for the q/k/v/o, FFN1 and logits products, operations at the
// int8 tensor-core peak for FFN2 (K=3072).  This kernel does
// not reach either: it runs its products on the CUDA cores with __dp4a
// (four int8 products and an add per instruction), a right first version
// before a tensor-core (mma/wgmma) one.
// Design: one 64x64 output tile per block of 256 threads, each thread 4x4
// outputs in registers.  Each step stages a 64x32 slice of A and a 32x64
// slice of B in shared memory, packed four k-values to a 32-bit word (B is
// transposed on the way in so that a word holds four consecutive k), and
// every word a thread reads from shared memory feeds four __dp4a.  M, N and
// K are masked in the loads and the epilogue, so nothing is padded.  The
// epilogue computes acc * (x_scale * w_scale[col]) in f32 exactly as the
// reference's quant_dense does, optionally applies a PWL function (the
// fused GELU of the TPU kernel), and writes f32 or bf16.
#include "pwl.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;       // k-values per step
constexpr int KW = BK / 4;   // packed 32-bit words per step
constexpr int THREADS = 256;

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (b0 & 0xff) | ((b1 & 0xff) << 8) | ((b2 & 0xff) << 16) |
         ((b3 & 0xff) << 24);
}

template <typename TO>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                    const float* __restrict__ x_scale,
                    const float* __restrict__ w_scale, TO* __restrict__ out,
                    int M, int N, int K, const float* __restrict__ table,
                    int segs) {
  __shared__ int As[BM][KW];
  __shared__ int Bs[KW][BN];
  __shared__ float tab[3 * NPE_MAX_TABLE_COLS];
  if (segs > 0) npe_load_table(tab, table, segs + 1);
  __syncthreads();

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A: row r, word q holds A[m0+r, k0+4q .. k0+4q+3]
    for (int w = threadIdx.x; w < BM * KW; w += THREADS) {
      const int r = w / KW, q = w % KW;
      const int gm = m0 + r, gk = k0 + 4 * q;
      int v[4] = {0, 0, 0, 0};
      if (gm < M) {
        const int8_t* row = A + (size_t)gm * K;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (gk + t < K) v[t] = row[gk + t];
      }
      As[r][q] = pack4(v[0], v[1], v[2], v[3]);
    }
    // B: word q, column c holds B[k0+4q .. k0+4q+3, n0+c]
    for (int w = threadIdx.x; w < KW * BN; w += THREADS) {
      const int q = w / BN, c = w % BN;
      const int gk = k0 + 4 * q, gn = n0 + c;
      int v[4] = {0, 0, 0, 0};
      if (gn < N) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (gk + t < K) v[t] = B[(size_t)(gk + t) * N + gn];
      }
      Bs[q][c] = pack4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KW; ++q) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[q][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float xs = *x_scale;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      float v = __fmul_rn(__int2float_rn(acc[i][j]), __fmul_rn(xs, w_scale[gn]));
      if (segs > 0) v = npe_pwl(v, tab, segs);
      out[(size_t)gm * N + gn] = npe_from_f32<TO>(v);
    }
  }
}

}  // namespace

extern "C" int npe_quant_matmul(const int8_t* xq, const int8_t* wq,
                                const float* x_scale, const float* w_scale,
                                void* out, int m, int n, int k, int out_bf16,
                                const float* table, int segments, void* stream) {
  if (segments < 0 || segments + 1 > NPE_MAX_TABLE_COLS) return (int)cudaErrorInvalidValue;
  if (segments > 0 && table == nullptr) return (int)cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    quant_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        xq, wq, x_scale, w_scale, static_cast<__nv_bfloat16*>(out), m, n, k,
        table, segments);
  else
    quant_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        xq, wq, x_scale, w_scale, static_cast<float*>(out), m, n, k, table,
        segments);
  return (int)cudaGetLastError();
}
