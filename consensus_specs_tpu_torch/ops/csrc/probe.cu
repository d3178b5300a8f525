// Liveness probe for the card: out = x + 1 over int32.
//
// Replaces the Pallas probe kernel tools/pallas_probe.py `kern` (an x + 1
// on an (8, 128) int32 array that told whether Mosaic compiled at all). On
// Hopper the same question is whether nvcc's sm_90a code loads and runs:
// the smallest kernel that reads device memory, computes and writes back.
// Bound by bytes (4 read and 4 written per element), at the probe's 1,024
// elements by the launch; one thread per element.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void add_one_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = x[i] + 1;
}

}  // namespace

extern "C" {

int add_one_launch(const void* x, void* out, int64_t n, void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  add_one_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>((const int32_t*)x, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

const char* probe_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
