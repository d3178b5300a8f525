// K11 fr_fft and K12 fr_mul: the BLS12-381 scalar-field (Fr) transform and
// pointwise product for Hopper (sm_90a), on the port's tensor layout:
// (N, 22) int32 canonical 12-bit limbs in Montgomery form, x 2^264 mod r
// (fr.cuh).
//
// They replace XLA code of the JAX package, not Pallas:
// - K12 fr_mul replaces consensus_specs_tpu/ops/fft_jax.py:136 `mul` (the
//   Montgomery product a b 2^-264 mod r that to_mont/from_mont call); op 1
//   and 2 give :93 `add` and :97 `sub`, the butterfly's sums, for the seam.
//   One thread an element: the limbs packed into 8 words, a CIOS product
//   (divides by 2^256), one 8-bit Montgomery step to 2^-264, unpacked.
// - K11 fr_fft replaces fft_jax.py:196 `fft_jit` (the radix-2 DIT of
//   _fft_body) and, through two transforms, :201 `das_extension_jit`. One
//   launch a stage (log2 n launches a transform), one thread a butterfly:
//   the first stage gathers the input rows in bit-reversed order and packs
//   them into 8-word rows of a scratch buffer (32 bytes a row where the
//   limbs take 88), the stages between read and write that buffer in
//   place, the last scales by n^-1 on the inverse and unpacks into the
//   output. The twiddles (n/2 rows of w^k 2^256 mod r) and n^-1 are the
//   kernel's own constants from the wrapper, in the 2^256 form, so a
//   butterfly is one CIOS product, an add and a sub with no correction.
//
// What bounds them on this card: K12 moves 264 bytes an element against a
// few hundred integer instructions, so bytes at large n and the launch
// floor at the main path's sizes. K11 does log2 n stages of n/2 products;
// at the main path's 16,384 and 32,768 elements its integer work (counted
// from its SASS) and its bytes (each row read and written once, 88 bytes
// each way) each take a few microseconds, as does each of its log2 n
// launches: a simple kernel of one launch a stage, the shape the port
// starts from (PERF.md has its times).

#include <cstdint>
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

constexpr int kThreads = 128;

template <int kOp>
__global__ void __launch_bounds__(kThreads) fr_mul_kernel(const int32_t* __restrict__ a, int64_t sa,
                                                          const int32_t* __restrict__ b, int64_t sb,
                                                          int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fr::pointwise<kOp>(out + i * fr::kLimbs, a + i * sa, b + i * sb);
}

template <bool kFirst, bool kLast, bool kInverse>
__global__ void __launch_bounds__(kThreads) fr_fft_stage_kernel(const int32_t* __restrict__ in, uint32_t* words,
                                                                int32_t* __restrict__ out,
                                                                const uint32_t* __restrict__ twiddles, int64_t n,
                                                                int log_n, int stage, fr::Scale n_inv) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n / 2) return;
  fr::butterfly<kFirst, kLast, kInverse>(j, in, words, out, twiddles, log_n, stage, n_inv);
}

// one stage's launch: the kernel of its place in the transform
template <bool kFirst, bool kLast, bool kInverse>
void stage_launch(unsigned blocks, cudaStream_t s, const int32_t* x, uint32_t* w, int32_t* y, const uint32_t* tw,
                  int64_t n, int log_n, int stage, const fr::Scale& scale) {
  fr_fft_stage_kernel<kFirst, kLast, kInverse><<<blocks, kThreads, 0, s>>>(x, w, y, tw, n, log_n, stage, scale);
}

template <int kOp>
cudaError_t mul_launch(const void* a, int64_t sa, const void* b, int64_t sb, void* out, int64_t n,
                       cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  fr_mul_kernel<kOp><<<blocks, kThreads, 0, stream>>>((const int32_t*)a, sa, (const int32_t*)b, sb,
                                                     (int32_t*)out, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K12: out = a b 2^-264 (op 0), a + b (op 1) or a - b (op 2) mod r for n
// elements; sa and sb are the operands' strides in int32 elements (22, or
// 0 for one element read by every thread).
int fr_mul_launch(const void* a, int64_t sa, const void* b, int64_t sb, void* out, int64_t n, int op,
                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (op == fr::kMul) return (int)mul_launch<fr::kMul>(a, sa, b, sb, out, n, s);
  if (op == fr::kAdd) return (int)mul_launch<fr::kAdd>(a, sa, b, sb, out, n, s);
  if (op == fr::kSub) return (int)mul_launch<fr::kSub>(a, sa, b, sb, out, n, s);
  return (int)cudaErrorInvalidValue;
}

// K11: the transform of n = 2^log_n >= 2 rows of `in` into `out` (both
// (n, 22) limbs, contiguous), through `words` ((n, 8) scratch);
// `twiddles` (n/2, 8) words; `n_inv` 8 words (read on the inverse only).
// log2 n launches on `stream`; the first refused one's error is returned.
int fr_fft_launch(const void* in, void* words, void* out, const void* twiddles, int64_t n, int log_n,
                  const uint32_t* n_inv, int inverse, void* stream) {
  if (log_n < 1 || n != ((int64_t)1 << log_n)) return (int)cudaErrorInvalidValue;
  fr::Scale scale;
  for (int j = 0; j < fr::kWords; ++j) scale.v[j] = n_inv[j];
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((n / 2 + kThreads - 1) / kThreads);
  const int32_t* x = (const int32_t*)in;
  uint32_t* w = (uint32_t*)words;
  int32_t* y = (int32_t*)out;
  const uint32_t* tw = (const uint32_t*)twiddles;
  for (int stage = 0; stage < log_n; ++stage) {
    const bool first = stage == 0, last = stage == log_n - 1;
    if (first && last && inverse)
      stage_launch<true, true, true>(blocks, s, x, w, y, tw, n, log_n, stage, scale);
    else if (first && last)
      stage_launch<true, true, false>(blocks, s, x, w, y, tw, n, log_n, stage, scale);
    else if (first)
      stage_launch<true, false, false>(blocks, s, x, w, y, tw, n, log_n, stage, scale);
    else if (last && inverse)
      stage_launch<false, true, true>(blocks, s, x, w, y, tw, n, log_n, stage, scale);
    else if (last)
      stage_launch<false, true, false>(blocks, s, x, w, y, tw, n, log_n, stage, scale);
    else
      stage_launch<false, false, false>(blocks, s, x, w, y, tw, n, log_n, stage, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* fr_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
