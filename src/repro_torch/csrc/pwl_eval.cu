// Elementwise PWL evaluation on Hopper.
//
// Replaces: pwl_eval_2d / _pwl_kernel in src/repro/kernels/pwl_eval.py.
// Bound on this card: bytes.  Each element is read once and written once
// (4+4 bytes in f32, 2+2 in bf16) against a few dozen operations from a
// table of a few hundred bytes, far below the 295 operations per byte where
// the card stops being memory-bound.
// Design: a stream of 16-byte accesses.  Each thread takes one 16-byte
// vector of x (8 bf16 or 4 f32) per step of a grid-stride loop while the
// load of its next vector is in flight.  It reads its piece of the PWL
// table first (a few hundred bytes, which would otherwise queue behind the
// stream), then starts its first two loads of x, then the block builds its
// prefix table in shared memory while they are in flight.  Each value is then
// evaluated by a binary search over the knots and two gathers from the
// prefix rows (npe_pwl_prefix_n), bit-identical to the prefix-delta walk.
// The grid is a vector a thread, in whole waves of the SMs, capped at the
// blocks resident at once (six of 256 threads an SM at most 40 registers a
// thread), so the loop gives every thread the same count of vectors, give
// or take one.  A second instance, for an x or y whose address is
// not 16-byte aligned or whose length is not a multiple of 8 elements,
// moves the same units with scalar, masked accesses.
#include <initializer_list>
#include <type_traits>

#include "pwl.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 6;   // resident blocks an SM, for the register budget
static_assert(THREADS >= NPE_PREFIX_KNOTS, "a thread fetches each knot slot and column");

// E elements of type T held as loaded: one 16-byte vector (VEC) or E
// scalars, masked at n.
template <typename T, bool VEC>
struct Unit {
  static constexpr int E = 16 / sizeof(T);
  uint4 vec;
  T val[E];

  __device__ __forceinline__ void load(const T* __restrict__ x, long long u, long long n) {
    if constexpr (VEC) {
      vec = u * E < n ? *reinterpret_cast<const uint4*>(x + u * E) : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) val[e] = u * E + e < n ? x[u * E + e] : npe_from_f32<T>(0.f);
    }
  }

  __device__ __forceinline__ void to_f32(float* f) const {
    if constexpr (VEC) {
      npe_unpack16<T>(vec, f);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = npe_to_f32(val[e]);
    }
  }
};

// Store E values as TO at unit u: 8, 16 or 32 bytes of vector stores
// (VEC), or masked scalar stores.
template <typename TO, bool VEC, int E>
__device__ __forceinline__ void store_unit(TO* __restrict__ y, long long u, long long n,
                                           const float* f) {
  if constexpr (VEC) {
    if (u * E >= n) return;
    if constexpr (E * sizeof(TO) == 16) {
      *reinterpret_cast<uint4*>(y + u * E) = npe_pack16<TO>(f);
    } else if constexpr (sizeof(TO) == 2) {   // 4 f32 in: 8 bytes out
      const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
      *reinterpret_cast<uint2*>(y + u * E) = make_uint2(
          *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    } else {                                  // 8 bf16 in: 32 bytes out
      reinterpret_cast<uint4*>(y + u * E)[0] = npe_pack16<TO>(f);
      reinterpret_cast<uint4*>(y + u * E)[1] = npe_pack16<TO>(f + 4);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (u * E + e < n) y[u * E + e] = npe_from_f32<TO>(f[e]);
  }
}

template <typename TI, typename TO, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
pwl_stream_kernel(const TI* __restrict__ x, TO* __restrict__ y, long long n,
                  const float* __restrict__ table, int segs) {
  using U = Unit<TI, VEC>;
  constexpr int E = U::E;
  __shared__ NpePrefixTable tab;
  const long long units = (n + E - 1) / E;
  const long long stride = (long long)gridDim.x * THREADS;
  long long u = (long long)blockIdx.x * THREADS + threadIdx.x;
  const NpePrefixFetch fetch(table, segs);
  U cur, next;
  cur.load(x, u, n);                                // in flight ...
  next.load(x, u + stride, n);
  npe_build_prefix_table(tab, fetch, segs);         // ... during this
  const int top = npe_prefix_top(segs);
  for (;;) {
    float v[E];
    cur.to_f32(v);
    npe_pwl_prefix_n<E>(v, tab, top);
    store_unit<TO, VEC, E>(y, u, n, v);
    u += stride;
    if (u >= units) break;
    cur = next;
    next.load(x, u + stride, n);
  }
}

// Launches a stream kernel over n values, E a unit: a unit a thread, in
// whole waves of the SMs, capped at the blocks of the kernel an SM holds at
// once (the rest by its grid-stride loop).  `resident` keeps that cap, asked
// of the runtime on the instance's first launch.
template <int E, typename... P, typename... A>
int launch_stream(void (*kernel)(P...), int& resident, long long n, cudaStream_t stream,
                  A... args) {
  if (resident == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, THREADS, 0) !=
            cudaSuccess ||
        resident < 1)
      resident = 1;
  }
  const long long sms = npe_sm_count();
  const long long units = (n + E - 1) / E;
  long long blocks = (units + THREADS - 1) / THREADS;
  if (blocks > sms) {
    blocks = (blocks + sms - 1) / sms * sms;                // whole waves
    if (blocks > sms * resident) blocks = sms * resident;   // the rest by the loop
  }
  kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

// launch(std::true_type) where every operand is 16-byte aligned and n a
// multiple of 8 (the vector instance), else launch(std::false_type).
template <class Launch>
int aligned_or_not(long long n, std::initializer_list<const void*> operands, Launch launch) {
  bool vec = n % 8 == 0;
  for (const void* p : operands) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  return vec ? launch(std::true_type{}) : launch(std::false_type{});
}

template <typename TI, typename TO>
int launch(const void* x, void* y, long long n, const float* table, int segs, cudaStream_t s) {
  return aligned_or_not(n, {x, y}, [&](auto vec) {
    static int resident = 0;   // one for each instance: the body is a template
    return launch_stream<16 / sizeof(TI)>(pwl_stream_kernel<TI, TO, decltype(vec)::value>,
                                          resident, n, s, static_cast<const TI*>(x),
                                          static_cast<TO*>(y), n, table, segs);
  });
}

// The derivative mode: dx = dy * slope(seg(x)) (a table used clamped: the
// slope at clip(x, lo, hi), times 1/2 at an end and 0 past it), in f32, as
// jax.grad of `slope[seg] * x + icept[seg]` gives it, rounded to T: the
// same three roundings on the same slope as the plain version, so dx is its
// result bit for bit.
// Bound on this card: bytes (x and dy read once, dx written once).
// Design: the forward's stream.  Each thread takes one 16-byte vector of x
// and one of dy per step of the grid-stride loop while the loads of its
// next pair are in flight.  It reads its piece of the slope table first,
// then starts its first two pairs of loads, then the block writes the knots
// (NaN-padded, as a prefix table's) and the S slopes to shared memory while
// they are in flight.  Each value's slope is then gathered at the segment
// that a binary search over the knots finds (npe_pwl_slope_n), the count of
// knots the walk's rule counts.  The grid is the forward's: a vector a
// thread in whole waves of the SMs, capped at the blocks resident at once.
// The scalar instance (VEC = false) serves an x, dy or dx that is not
// 16-byte aligned or a length that is not a multiple of 8.
constexpr int GRAD_MIN_BLOCKS = 4;   // two pairs of vectors in flight: 64 registers a thread

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, GRAD_MIN_BLOCKS)
pwl_grad_stream_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                       long long n, const float* __restrict__ stable, int segs, int clamped,
                       float lo, float hi) {
  using U = Unit<T, VEC>;
  constexpr int E = U::E;
  __shared__ float knot[NPE_PREFIX_KNOTS];
  __shared__ float slope[NPE_MAX_TABLE_COLS];
  const long long units = (n + E - 1) / E;
  const long long stride = (long long)gridDim.x * THREADS;
  long long u = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int t = threadIdx.x;
  const float kn = t >= 1 && t < segs ? __ldg(stable + t) : __int_as_float(0x7fffffff);
  const float sl = t < segs ? __ldg(stable + segs + 1 + t) : 0.f;
  U cx, cd, nx, nd;
  cx.load(x, u, n);                                 // in flight ...
  cd.load(dy, u, n);
  nx.load(x, u + stride, n);
  nd.load(dy, u + stride, n);
  if (t < NPE_PREFIX_KNOTS) knot[t] = kn;           // ... during this
  if (t < NPE_MAX_TABLE_COLS) slope[t] = sl;
  __syncthreads();
  const int top = npe_prefix_top(segs);
  for (;;) {
    float v[E], g[E], d[E], f[E];
    cx.to_f32(v);
    cd.to_f32(g);
    if (clamped) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        f[e] = npe_clip_factor(v[e], lo, hi);
        v[e] = fminf(fmaxf(v[e], lo), hi);
      }
    }
    npe_pwl_slope_n<E>(v, d, knot, slope, top);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      d[e] = __fmul_rn(g[e], d[e]);
      if (clamped) d[e] = __fmul_rn(d[e], f[e]);
    }
    store_unit<T, VEC, E>(dx, u, n, d);
    u += stride;
    if (u >= units) break;
    cx = nx;
    cd = nd;
    nx.load(x, u + stride, n);
    nd.load(dy, u + stride, n);
  }
}

template <typename T>
int launch_grad(const void* x, const void* dy, void* dx, long long n, const float* stable,
                int segs, int clamped, float lo, float hi, cudaStream_t s) {
  return aligned_or_not(n, {x, dy, dx}, [&](auto vec) {
    static int resident = 0;
    return launch_stream<16 / sizeof(T)>(pwl_grad_stream_kernel<T, decltype(vec)::value>,
                                         resident, n, s, static_cast<const T*>(x),
                                         static_cast<const T*>(dy), static_cast<T*>(dx), n,
                                         stable, segs, clamped, lo, hi);
  });
}

}  // namespace

extern "C" int npe_pwl_eval_grad(const void* x, const void* dy, void* dx, long long n,
                                 int bf16, const float* slope_table, int segments, int clamped,
                                 float lo, float hi, void* stream) {
  if (segments < 1 || segments + 1 > NPE_MAX_TABLE_COLS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_grad<__nv_bfloat16>(x, dy, dx, n, slope_table, segments, clamped, lo, hi, s);
  return launch_grad<float>(x, dy, dx, n, slope_table, segments, clamped, lo, hi, s);
}

extern "C" int npe_pwl_eval(const void* x, void* y, long long n, int x_bf16,
                            int y_bf16, const float* table, int segments,
                            void* stream) {
  if (segments < 1 || segments + 1 > NPE_MAX_TABLE_COLS) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_bf16 && y_bf16) return launch<bf16, bf16>(x, y, n, table, segments, s);
  if (x_bf16) return launch<bf16, float>(x, y, n, table, segments, s);
  if (y_bf16) return launch<float, bf16>(x, y, n, table, segments, s);
  return launch<float, float>(x, y, n, table, segments, s);
}
