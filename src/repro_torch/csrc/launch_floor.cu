// An empty kernel of one 256-thread block: the least time a launch of the
// port's kernels can show on the card, timed beside them by chip_smoke.py.
// It replaces no TPU kernel and no path launches it.
#include <cuda_runtime.h>

namespace {
__global__ void __launch_bounds__(256) empty_kernel() {}
}  // namespace

extern "C" int npe_launch_floor(void* stream) {
  empty_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
