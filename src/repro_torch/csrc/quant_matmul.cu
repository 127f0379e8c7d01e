// The MMU on Hopper: int8 x int8 -> exact int32 on the tensor cores,
// dequantized in the epilogue.
//
// Replaces: quant_matmul / _quant_matmul_kernel in
// src/repro/kernels/quant_matmul.py (the Pallas call at :73).
//
// Bound on this card: at BERT-base 8x128 (M=1024) the two bounds lie within
// about 1.3x of each other: bytes (the bf16 or f32 output outweighs the
// int8 operands) for the q/k/v/o, FFN1 and logits products, operations at
// the int8 tensor-core peak for FFN2 (K=3072).  At the 8 rows of a decode
// step every shape is bound by the bytes of the weight.
//
// Design.  Products run on the int8 tensor cores, mma.sync m16n8k32 s8 with
// s32 accumulation: integer sums are exact in any order, so every tiling and
// every split of K gives the same bits as the float64 plain version.
// Operand tiles of 64 k-bytes stream through a multi-stage cp.async ring in
// shared memory, 16-byte pieces, XOR-swizzled so that ldmatrix reads no bank
// twice; ragged M, N and K are zero-filled by the copy (a copy of 0 bytes
// reads nothing).  Shapes whose rows are not 16-byte aligned (K or N not a
// multiple of 16) are staged by byte loads into the same layout instead.
// The layout problem: s8 mma takes B K-contiguous per column, and ldmatrix
// transposes 16-bit elements only, while the weights are (K, N) row-major.
// Each k-tile of the weight is therefore transposed in shared memory, 4x4
// bytes at a time with byte permutes (prmt), into an (N, 64) tile that
// ldmatrix reads; it costs one shared-memory pass over the weight tile per
// k-tile, nothing in device memory and nothing on the host.
// * M > 16 (the encoder's 1,024 rows): `qmm_kernel`, 128x128 tiles of 8
//   warps (64x32 a warp), or 64x64 tiles of 4 warps where 128x128 tiles
//   would leave SMs idle, three stages.
// * M <= 16 (decode): `qmm_rows_kernel`, the roles swapped: out^T = W^T X^T,
//   so N fills the 16-row side of the mma and the (at most 16) rows of X
//   are its two 8-column tiles.  A block of 4 warps takes 64 columns and a
//   slice of K; K is split across blocks until the grid covers every SM, and
//   the int32 partial sums meet by atomicAdd in a zeroed workspace that the
//   wrapper keeps for its stream.  The last block of a column tile to
//   finish (counted by an atomic ticket) runs the epilogue and sets the
//   workspace and the ticket back to zero for the next launch on the
//   stream.  Exact: integer atomics.
// Epilogue: acc * (x_scale[row * xs_stride] * w_scale[col]) in f32 as the
// reference's quant_dense orders it, the optional PWL (the fused GELU of the
// TPU kernel), then f32 or bf16.  xs_stride 0 is one activation scale for
// the tensor (the same bits as before per-row scales existed); 1 is one a
// row, the executor's per-row quantization of merged decode tiles.
#include "hopper.cuh"
#include "pwl.cuh"

namespace {

constexpr int BK = 64;          // k-bytes a staged tile
constexpr int STAGES = 3;       // encoder kernel ring
constexpr int ROW_STAGES = 5;   // decode kernel ring: a 256-byte slice of K in flight at once
constexpr int DN = 64;          // columns a decode block
constexpr int DTHREADS = 128;

// Byte offset of 16-byte chunk c of row r (a k row) of a raw weight tile of
// BN bytes a row: chunks XOR-swizzled by the row's group of 4, so that the
// transposing threads, 8 groups of 4 rows at one chunk, read 32 banks.
template <int BN>
__device__ __forceinline__ int sw_w(int r, int c) {
  return r * BN + ((c ^ ((r >> 2) & (BN / 16 - 1))) << 4);
}

// 16 bytes from global to shared memory, the first `valid` of them from
// src and the rest zeros: cp.async when rows are 16-byte aligned (valid is
// then 0 or 16, and a masked piece reads from `base`, nothing at all), else
// byte loads.
template <bool VEC>
__device__ __forceinline__ void stage16(unsigned char* dst, const int8_t* src,
                                        const int8_t* base, int valid) {
  if (VEC) {
    npe_cp_async16(dst, valid > 0 ? src : base, valid > 0 ? 16 : 0);
  } else {
    uint32_t w[4] = {0, 0, 0, 0};
    for (int b = 0; b < valid; ++b)
      w[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b])) << (8 * (b & 3));
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ int clamp16(int n) { return n < 0 ? 0 : (n > 16 ? 16 : n); }

// Transpose a raw (64 k, BN n) weight tile into (BN n, 64 k) rows (npe_sw64
// layout): each 4x4 byte block by 8 byte permutes.  Threads of a warp take
// 8 k-groups x 4 n-groups.
template <int BN, int THREADS>
__device__ __forceinline__ void transpose_w(const unsigned char* raw, unsigned char* wt) {
  for (int blk = threadIdx.x; blk < (BK / 4) * (BN / 4); blk += THREADS) {
    const int hb = blk >> 5;
    const int kb = (blk & 7) + 8 * (hb & 1);          // 4-byte group of k
    const int nb = ((blk >> 3) & 3) + 4 * (hb >> 1);  // 4-byte group of n
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = *reinterpret_cast<const uint32_t*>(raw + sw_w<BN>(4 * kb + j, nb >> 2) + 4 * (nb & 3));
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
    const uint32_t c[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                           __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(wt + npe_sw64(4 * nb + i, kb >> 2) + 4 * (kb & 3)) = c[i];
  }
}

__device__ __forceinline__ float dequant(int acc, float xs, const float* w_scale, int col,
                                         const float* tab, int segs) {
  float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(xs, w_scale[col]));
  if (segs > 0) v = npe_pwl(v, tab, segs);
  return v;
}

// ---------------------------------------------------------------------------
// M > 16
// ---------------------------------------------------------------------------

template <int BM, int BN, int WARPS_M, int WARPS_N>
struct Tiles {
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;   // a warp's tile
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr size_t SMEM = (size_t)STAGES * (BM * BK + BK * BN) + (size_t)BN * BK;
};

template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC, typename TO>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
qmm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
           const float* __restrict__ x_scale, int xs_stride, const float* __restrict__ w_scale,
           TO* __restrict__ out, int M, int N, int K, const float* __restrict__ table,
           int segs) {
  using T = Tiles<BM, BN, WARPS_M, WARPS_N>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xs = smem;                         // STAGES x (BM, 64), npe_sw64
  unsigned char* ws = xs + STAGES * BM * BK;        // STAGES x (64, BN), sw_w
  unsigned char* wt = ws + STAGES * BK * BN;        // (BN, 64), npe_sw64
  __shared__ float tab[3 * NPE_MAX_TABLE_COLS];
  if (segs > 0) npe_load_table(tab, table, segs + 1);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int ktiles = (K + BK - 1) / BK;

  auto load = [&](int kt, int stage) {
    const int k0 = kt * BK;
    unsigned char* xd = xs + stage * BM * BK;
    for (int x = threadIdx.x; x < BM * 4; x += T::THREADS) {
      const int r = x >> 2, c = x & 3, gm = m0 + r, gk = k0 + 16 * c;
      stage16<VEC>(xd + npe_sw64(r, c), A + (size_t)gm * K + gk, A, gm < M ? clamp16(K - gk) : 0);
    }
    unsigned char* wd = ws + stage * BK * BN;
    for (int x = threadIdx.x; x < BK * (BN / 16); x += T::THREADS) {
      const int r = x / (BN / 16), c = x % (BN / 16), gk = k0 + r, gn = n0 + 16 * c;
      stage16<VEC>(wd + sw_w<BN>(r, c), B + (size_t)gk * N + gn, B, gk < K ? clamp16(N - gn) : 0);
    }
  };

  int acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    npe_cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    npe_cp_async_wait<STAGES - 2>();
    __syncthreads();          // tile kt staged; iteration kt-1 done with its stage and wt
    if (kt + STAGES - 1 < ktiles) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    npe_cp_async_commit();
    transpose_w<BN, T::THREADS>(ws + (kt % STAGES) * BK * BN, wt);
    __syncthreads();
    const unsigned char* xt = xs + (kt % STAGES) * BM * BK;
#pragma unroll
    for (int s = 0; s < 2; ++s) {            // two k32 steps a tile
      uint32_t af[T::MT][4], bf[T::NT][2];
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
        npe_ldsm_x4(af[i], xt + npe_sw64(wm * T::WM + i * 16 + (lane & 15), 2 * s + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < T::NT / 2; ++j) {
        uint32_t r[4];
        npe_ldsm_x4(r, wt + npe_sw64(wn * T::WN + j * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     2 * s + ((lane >> 3) & 1)));
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j) npe_mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  if (ktiles == 0) __syncthreads();          // the table, when K is 0

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * T::WM + i * 16 + g + 8 * h;
        const int col = n0 + wn * T::WN + j * 8 + 2 * t4;
        if (row >= M) continue;
        const float xsc = x_scale[(size_t)row * xs_stride];
        TO* o = out + (size_t)row * N + col;
        const float v0 = col < N ? dequant(acc[i][j][2 * h], xsc, w_scale, col, tab, segs) : 0.f;
        if (col + 1 < N && N % 2 == 0) {
          const float v1 = dequant(acc[i][j][2 * h + 1], xsc, w_scale, col + 1, tab, segs);
          if constexpr (sizeof(TO) == 4) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<uint32_t*>(o) = npe_pack_bf16(v0, v1);
          }
        } else {
          if (col < N) o[0] = npe_from_f32<TO>(v0);
          if (col + 1 < N)
            o[1] = npe_from_f32<TO>(dequant(acc[i][j][2 * h + 1], xsc, w_scale, col + 1, tab, segs));
        }
      }
}

// ---------------------------------------------------------------------------
// M <= 16: out^T = W^T X^T, K split across blocks
// ---------------------------------------------------------------------------

constexpr size_t ROW_SMEM = (size_t)ROW_STAGES * (16 * BK + BK * DN) + (size_t)DN * BK;

template <bool VEC, typename TO>
__global__ void __launch_bounds__(DTHREADS)
qmm_rows_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                const float* __restrict__ x_scale, int xs_stride,
                const float* __restrict__ w_scale, TO* __restrict__ out, int M, int N, int K,
                int slice, int* __restrict__ work,
                const float* __restrict__ table, int segs) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xs = smem;                          // ROW_STAGES x (16, 64), npe_sw64
  unsigned char* ws = xs + ROW_STAGES * 16 * BK;     // ROW_STAGES x (64, DN), sw_w
  unsigned char* wt = ws + ROW_STAGES * BK * DN;     // (DN, 64), npe_sw64
  __shared__ float tab[3 * NPE_MAX_TABLE_COLS];
  __shared__ int last;
  if (segs > 0) npe_load_table(tab, table, segs + 1);

  const int n0 = blockIdx.x * DN;
  const int kbeg = blockIdx.y * slice, kend = min(K, kbeg + slice);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ktiles = (kend - kbeg + BK - 1) / BK;

  auto load = [&](int kt, int stage) {
    const int k0 = kbeg + kt * BK;
    unsigned char* xd = xs + stage * 16 * BK;
    for (int x = threadIdx.x; x < 16 * 4; x += DTHREADS) {
      const int r = x >> 2, c = x & 3, gk = k0 + 16 * c;
      stage16<VEC>(xd + npe_sw64(r, c), A + (size_t)r * K + gk, A, r < M ? clamp16(kend - gk) : 0);
    }
    unsigned char* wd = ws + stage * BK * DN;
    for (int x = threadIdx.x; x < BK * (DN / 16); x += DTHREADS) {
      const int r = x / (DN / 16), c = x % (DN / 16), gk = k0 + r, gn = n0 + 16 * c;
      stage16<VEC>(wd + sw_w<DN>(r, c), B + (size_t)gk * N + gn, B, gk < kend ? clamp16(N - gn) : 0);
    }
  };

  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};   // (16 columns of this warp) x (rows 0-7, 8-15)
#pragma unroll
  for (int s = 0; s < ROW_STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    npe_cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    npe_cp_async_wait<ROW_STAGES - 2>();
    __syncthreads();
    if (kt + ROW_STAGES - 1 < ktiles) load(kt + ROW_STAGES - 1, (kt + ROW_STAGES - 1) % ROW_STAGES);
    npe_cp_async_commit();
    transpose_w<DN, DTHREADS>(ws + (kt % ROW_STAGES) * BK * DN, wt);
    __syncthreads();
    const unsigned char* xt = xs + (kt % ROW_STAGES) * 16 * BK;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t af[4], bx[4];
      npe_ldsm_x4(af, wt + npe_sw64(warp * 16 + (lane & 15), 2 * s + (lane >> 4)));
      npe_ldsm_x4(bx, xt + npe_sw64((lane & 7) + ((lane >> 4) << 3), 2 * s + ((lane >> 3) & 1)));
      npe_mma_s8(acc[0], af, bx[0], bx[1]);
      npe_mma_s8(acc[1], af, bx[2], bx[3]);
    }
  }
  __syncthreads();                               // the table, when there is no k-tile

  // acc[mt][e]: column n0 + 16 warp + g + 8 (e / 2), row 8 mt + 2 t + e % 2
  const int g = lane >> 2, t4 = lane & 3;
  if (gridDim.y == 1) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + warp * 16 + g + 8 * (e >> 1), row = 8 * mt + 2 * t4 + (e & 1);
        if (row < M && col < N)
          out[(size_t)row * N + col] = npe_from_f32<TO>(
              dequant(acc[mt][e], x_scale[(size_t)row * xs_stride], w_scale, col, tab, segs));
      }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n0 + warp * 16 + g + 8 * (e >> 1), row = 8 * mt + 2 * t4 + (e & 1);
      if (row < M && col < N) atomicAdd(work + (size_t)row * N + col, acc[mt][e]);
    }
  __threadfence();
  __syncthreads();
  int* ticket = work + (size_t)M * N + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int x = threadIdx.x; x < M * DN; x += DTHREADS) {
    const int row = x / DN, col = n0 + x % DN;
    if (col >= N) continue;
    int* w = work + (size_t)row * N + col;
    const int sum = __ldcg(w);
    __stcg(w, 0);
    out[(size_t)row * N + col] = npe_from_f32<TO>(
        dequant(sum, x_scale[(size_t)row * xs_stride], w_scale, col, tab, segs));
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Decode grid: column tiles of DN, and K cut into slices (multiples of BK)
// until the grid has at least one block an SM.
struct RowGrid {
  int tiles, splits, slice;
};

RowGrid row_grid(int n, int k) {
  const int tiles = (n + DN - 1) / DN;
  const int want = (npe_sm_count() + tiles - 1) / tiles;
  const int slice = max(BK, (k / want) / BK * BK);
  return RowGrid{tiles, max(1, (k + slice - 1) / slice), slice};
}

template <typename KernelT>
int allow_smem(KernelT kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

template <int BM, int BN, int WM_, int WN_, bool VEC, typename TO>
int launch_tiles(const int8_t* xq, const int8_t* wq, const float* xs, int xs_stride,
                 const float* ws, TO* out, int m, int n, int k, const float* table, int segs,
                 cudaStream_t s) {
  using T = Tiles<BM, BN, WM_, WN_>;
  static bool done = false;
  if (int err = allow_smem(qmm_kernel<BM, BN, WM_, WN_, VEC, TO>, T::SMEM, done)) return err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  qmm_kernel<BM, BN, WM_, WN_, VEC, TO><<<grid, T::THREADS, T::SMEM, s>>>(
      xq, wq, xs, xs_stride, ws, out, m, n, k, table, segs);
  return (int)cudaGetLastError();
}

template <bool VEC, typename TO>
int launch(const int8_t* xq, const int8_t* wq, const float* xs, int xs_stride, const float* ws,
           TO* out, int m, int n, int k, const float* table, int segs, int* work,
           cudaStream_t s) {
  if (m <= 16) {
    const RowGrid rg = row_grid(n, k);
    if (rg.splits > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
    static bool done = false;
    if (int err = allow_smem(qmm_rows_kernel<VEC, TO>, ROW_SMEM, done)) return err;
    qmm_rows_kernel<VEC, TO><<<dim3(rg.tiles, rg.splits), DTHREADS, ROW_SMEM, s>>>(
        xq, wq, xs, xs_stride, ws, out, m, n, k, rg.slice, work, table, segs);
    return (int)cudaGetLastError();
  }
  const long long big = (long long)((m + 127) / 128) * ((n + 127) / 128);
  if (big >= npe_sm_count())
    return launch_tiles<128, 128, 2, 4, VEC, TO>(xq, wq, xs, xs_stride, ws, out, m, n, k, table,
                                                  segs, s);
  return launch_tiles<64, 64, 2, 2, VEC, TO>(xq, wq, xs, xs_stride, ws, out, m, n, k, table,
                                              segs, s);
}

}  // namespace

// int32 values of the zeroed workspace that npe_quant_matmul needs for an
// (m, k) @ (k, n) product: 0 unless the decode kernel splits K.  The kernel
// leaves the workspace zeroed, so one buffer serves every launch on a stream.
extern "C" int npe_quant_matmul_workspace(int m, int n, int k) {
  if (m <= 0 || n <= 0 || m > 16) return 0;
  const RowGrid rg = row_grid(n, k);
  return rg.splits > 1 ? m * n + rg.tiles : 0;
}

// x_scale: one value (x_scale_stride 0) or one a row (x_scale_stride 1, or
// the stride between rows' values).
extern "C" int npe_quant_matmul(const int8_t* xq, const int8_t* wq,
                                const float* x_scale, int x_scale_stride, const float* w_scale,
                                void* out, int m, int n, int k, int out_bf16,
                                const float* table, int segments, int* workspace,
                                void* stream) {
  if (segments < 0 || segments + 1 > NPE_MAX_TABLE_COLS) return (int)cudaErrorInvalidValue;
  if (x_scale_stride < 0) return (int)cudaErrorInvalidValue;
  if (segments > 0 && table == nullptr) return (int)cudaErrorInvalidValue;
  if (m <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = k % 16 == 0 && n % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  if (out_bf16) {
    auto* o = static_cast<__nv_bfloat16*>(out);
    return vec ? launch<true>(xq, wq, x_scale, x_scale_stride, w_scale, o, m, n, k, table,
                              segments, workspace, s)
               : launch<false>(xq, wq, x_scale, x_scale_stride, w_scale, o, m, n, k, table,
                               segments, workspace, s);
  }
  auto* o = static_cast<float*>(out);
  return vec ? launch<true>(xq, wq, x_scale, x_scale_stride, w_scale, o, m, n, k, table,
                            segments, workspace, s)
             : launch<false>(xq, wq, x_scale, x_scale_stride, w_scale, o, m, n, k, table,
                             segments, workspace, s);
}
