// K9 fq_inv: the inverse in the BLS12-381 base field for Hopper (sm_90a),
// one launch for a batch, on the port's tensor layout: (N, 32) int32
// canonical 12-bit limbs in Montgomery form (a R mod p, R = 2^384) in, the
// Montgomery form of a^-1 out; 0 maps to 0, as Fermat's a^(p-2) does.
//
// It replaces consensus_specs_tpu/ops/fq.py:201 `inv`, a^(p-2) by a
// lax.scan over the exponent's bits, which the port had run on K5 fq_pow:
// 610 Montgomery products in series, whose latency set K5's time at a
// flush's 130-260 elements (a few warps on an idle card). An inversion
// needs no exponentiation: fq.cuh's fq::inv runs a binary extended GCD
// (Bernstein-Yang divsteps in libsecp256k1's modinv32 layout, 37 rounds of
// 30 branch-free steps on 32-bit words, then the 2x2 matrix of each round
// applied to 13 signed 30-bit limbs), a few thousand dependent 32-bit
// operations. The inverse is unique and both sides write canonical limbs,
// so the result equals Fermat's bit for bit.
//
// What bounds it on this card: latency at a flush's sizes (one thread an
// element, the steps of a round dependent), integer throughput at a
// decode's 16,385 elements. Bytes are no bound (256 bytes an element
// against ~10^5 instructions).
//
// The design: one thread an element, every value in registers from the
// load to the store (f, g, d, e: 52 limbs), so the warp's lanes never
// exchange and never diverge (the count of steps is fixed). The start
// value s = R^2 mod p of the GCD's coefficient e (which makes the result
// a^-1 R directly) comes from the wrapper, computed and checked there in
// Python integers.

#include <cstdint>
#include <cuda_runtime.h>

#include "fq.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) fq_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                                                          int64_t n, fq::InvStart s) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[fq::kLimbs], r[fq::kLimbs];
  const int4* src = reinterpret_cast<const int4*>(a + i * fq::kLimbs);
#pragma unroll
  for (int q = 0; q < fq::kLimbs / 4; ++q) {
    const int4 w = src[q];
    x[4 * q] = (uint32_t)w.x;
    x[4 * q + 1] = (uint32_t)w.y;
    x[4 * q + 2] = (uint32_t)w.z;
    x[4 * q + 3] = (uint32_t)w.w;
  }
  fq::inv(r, x, s);
  int4* dst = reinterpret_cast<int4*>(out + i * fq::kLimbs);
#pragma unroll
  for (int q = 0; q < fq::kLimbs / 4; ++q)
    dst[q] = make_int4((int)r[4 * q], (int)r[4 * q + 1], (int)r[4 * q + 2], (int)r[4 * q + 3]);
}

}  // namespace

extern "C" {

// K9: out = s / a mod p for n elements (contiguous, 16-byte aligned); s is
// 13 signed 30-bit limbs (fq::InvStart), passed by value.
int fq_inv_launch(const void* a, void* out, int64_t n, const int32_t* s, void* stream) {
  fq::InvStart start;
  for (int j = 0; j < fq::kInvLimbs; ++j) start.v[j] = s[j];
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fq_inv_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const int32_t*)a, (int32_t*)out, n, start);
  return (int)cudaGetLastError();
}

const char* fq_inv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
