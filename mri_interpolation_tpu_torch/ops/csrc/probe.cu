// Toolchain probe on Hopper: y = 2 * x.
//
// Replaces the Pallas TPU kernel `trivial` of scripts/bench_pallas_exec.py
// (its pallas_call at :76), which checked that the TPU toolchain compiles and
// runs a kernel at all. Here it is the port's build check: the launcher runs
// it once on a (256, 128) fp32 array before a run on the card and holds the
// result exactly to 2 * x (a doubling is exact in fp32).
//
// What bounds it: bytes (one read and one write per element); at 128 KB it
// is a launch.
//
// Interface: plain C, raw pointers, the caller's stream; returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
probe_double_kernel(const float* __restrict__ x, float* __restrict__ y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) y[i] = 2.f * x[i];
}

}  // namespace

extern "C" {

// y[i] = 2 * x[i] for i < n (device pointers); n == 0 launches nothing.
int probe_double(const float* x, float* y, int64_t n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  probe_double_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

const char* probe_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
