// BLS12-381 base-field kernels for Hopper (sm_90a), on the port's tensor
// layout: (N, 32) int32 canonical 12-bit limbs, Montgomery radix 2^384.
//
// K3 fq_mul replaces consensus_specs_tpu/ops/fq.py `mul` (`_poly_mul`, a
// 32 x 32 schoolbook limb convolution, then `_mont_reduce`, a 32-round
// word-serial Montgomery reduction, then `_cond_sub_p`). It is the multiply
// under every tower, curve, hash-to-curve and pairing op of the BLS stack.
//
// K4 fq_addsub replaces fq.py `add`, `sub` and `neg`: a 32-step carry
// ripple (`_carry_norm`'s lax.scan) followed by `_geq` / `_cond_sub_p`. In
// eager PyTorch that ripple alone is about a hundred launches; here it is
// one. The op code picks (a + b), (a - b) or (-b) mod p.
//
// What bounds them: at the shapes of the BLS path (a few hundred to a few
// ten thousand elements a call) the launch itself, and past that integer
// issue. A product is 144 32 x 32 -> 64-bit multiply-adds for the operand
// rows and 144 for the reduction rows, each a wide multiply plus carry
// adds, against 384 bytes of device memory (two 128-byte inputs, one
// output), so K3 is bound by operations. K4 is about 70 integer
// instructions against the same 384 bytes: bound by bytes. The design: one
// thread per element, operands repacked from 12-bit limbs into twelve
// 32-bit words in registers (fq.cuh), the whole CIOS loop unrolled with the
// prime folded into immediates, no shared memory, no synchronisation. A
// broadcast operand (one element for the whole batch) is read with stride 0
// instead of being materialised.

#include <cstdint>
#include <cuda_runtime.h>

#include "fq.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load_words(uint32_t w[fq::kWords], const int32_t* src) {
  const int4* v = reinterpret_cast<const int4*>(src);
  uint32_t l[fq::kLimbs];
#pragma unroll
  for (int k = 0; k < fq::kLimbs / 4; ++k) {
    const int4 q = v[k];
    l[4 * k] = (uint32_t)q.x;
    l[4 * k + 1] = (uint32_t)q.y;
    l[4 * k + 2] = (uint32_t)q.z;
    l[4 * k + 3] = (uint32_t)q.w;
  }
  fq::pack(w, l);
}

__device__ __forceinline__ void store_words(int32_t* dst, const uint32_t w[fq::kWords]) {
  uint32_t l[fq::kLimbs];
  fq::unpack(l, w);
  int4* v = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int k = 0; k < fq::kLimbs / 4; ++k) {
    v[k] = make_int4((int)l[4 * k], (int)l[4 * k + 1], (int)l[4 * k + 2], (int)l[4 * k + 3]);
  }
}

__global__ void __launch_bounds__(kThreads) fq_mul_kernel(const int32_t* __restrict__ a, int64_t a_stride,
                                                         const int32_t* __restrict__ b, int64_t b_stride,
                                                         int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t x[fq::kWords], y[fq::kWords], r[fq::kWords];
  load_words(x, a + i * a_stride);
  load_words(y, b + i * b_stride);
  fq::mont_mul(r, x, y);
  store_words(out + i * fq::kLimbs, r);
}

__global__ void __launch_bounds__(kThreads) fq_addsub_kernel(const int32_t* __restrict__ a, int64_t a_stride,
                                                            const int32_t* __restrict__ b, int64_t b_stride,
                                                            int32_t* __restrict__ out, int64_t n, int op) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t x[fq::kWords], y[fq::kWords], r[fq::kWords];
  load_words(y, b + i * b_stride);
  if (op == 2) {  // neg: 0 - b
#pragma unroll
    for (int j = 0; j < fq::kWords; ++j) x[j] = 0;
  } else {
    load_words(x, a + i * a_stride);
  }
  if (op == 0) {
    fq::add_mod(r, x, y);
  } else {
    fq::sub_mod(r, x, y);
  }
  store_words(out + i * fq::kLimbs, r);
}

}  // namespace

extern "C" {

// a_stride / b_stride: int32 elements between consecutive operands, 32 or 0
int fq_mul_launch(const void* a, int64_t a_stride, const void* b, int64_t b_stride, void* out, int64_t n,
                  void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  fq_mul_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, a_stride, (const int32_t*)b, b_stride, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

// op: 0 add, 1 sub, 2 neg (of b)
int fq_addsub_launch(const void* a, int64_t a_stride, const void* b, int64_t b_stride, void* out, int64_t n,
                     int op, void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  fq_addsub_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, a_stride, (const int32_t*)b, b_stride, (int32_t*)out, n, op);
  return (int)cudaGetLastError();
}

const char* fq_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
