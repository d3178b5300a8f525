// K11 fr_fft and K12 fr_mul: the BLS12-381 scalar-field (Fr) transform and
// pointwise product for Hopper (sm_90a), on the port's tensor layout:
// (N, 22) int32 canonical 12-bit limbs in Montgomery form, x 2^264 mod r
// (fr.cuh).
//
// They replace XLA code of the JAX package, not Pallas:
// - K12 fr_mul replaces consensus_specs_tpu/ops/fft_jax.py:136 `mul` (the
//   Montgomery product a b 2^-264 mod r that to_mont/from_mont call); op 1
//   and 2 give :93 `add` and :97 `sub`, the butterfly's sums, for the seam.
//   A block a tile of 128 elements (fr.cuh pointwise_tile): the operands'
//   rows staged through shared memory in 16-byte pieces, a warp's access
//   512 contiguous bytes (8-byte pieces where a tensor is only 8-byte
//   aligned), then one thread an element: the limbs packed into 8 words, a
//   product (divides by 2^256), one 8-bit Montgomery step to 2^-264,
//   unpacked, and stored back through shared memory.
// - K11 fr_fft replaces fft_jax.py:196 `fft_jit` (the radix-2 DIT of
//   _fft_body) and, through two transforms, :201 `das_extension_jit`. A
//   launch a pass of up to 8 stages (fr.cuh fft_pass): a block runs them on
//   a tile of up to 256 rows in shared memory, one thread a butterfly, a
//   __syncthreads() between stages. The first pass gathers the input rows
//   in bit-reversed order and packs them into 8-word rows, the passes
//   between read and write those rows in a scratch buffer (32 bytes a row
//   where the limbs take 88), the last scales by n^-1 on the inverse and
//   unpacks into the output. The twiddles (n/2 rows of w^k 2^256 mod r) and
//   n^-1 are the kernel's own constants from the wrapper, in the 2^256
//   form, so a butterfly is one product, an add and a sub with no
//   correction; every stage's twiddles are fetched into shared memory with
//   the tile, so the stages touch device memory not at all.
//
// What bounds them on this card: K12 moves 264 bytes an element against a
// few hundred integer instructions, so bytes at large n and, at the main
// path's sizes, latency: a launch, a round trip through device memory and
// one thread's chain of about a thousand instructions. K11 does log2 n
// stages of n/2 products: at the main path's 16,384 and 32,768 elements its
// work (counted from its SASS) and its bytes each take a few microseconds,
// but a stage has only n/2 butterflies (two to four warps an SM, one a
// sub-partition), so a stage takes about one butterfly's time on one
// sub-partition, most of it the product, and a pass costs a launch and a
// round trip through device memory. Passes of 7 or 8 stages pay that twice
// a transform where a launch a stage paid it 14 or 15 times. Splitting a
// butterfly's product over two lanes (two warps, a shared-memory exchange
// and two more barriers a stage) was slower than one thread a butterfly at
// 1,024 to 32,768 points, and so was moving the product's additions onto
// the multiply-add pipe (PERF.md has the times).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "fr.cuh"

namespace {

// a block of the card: each step on all threads, then a barrier (host and
// device so that fr.cuh's host-and-device bodies may call it; it runs on
// the card only)
struct DeviceBlock {
  template <class F>
  __host__ __device__ __forceinline__ void each(F&& step) {
#if defined(__CUDA_ARCH__)
    step((int)threadIdx.x);
    __syncthreads();
#endif
  }
};

template <int kOp, bool kWide>
__global__ void __launch_bounds__(fr::kTileRows) fr_mul_kernel(const int32_t* __restrict__ a, int64_t sa,
                                                               const int32_t* __restrict__ b, int64_t sb,
                                                               int32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) int32_t ta[fr::kTileRows * fr::kLimbs];
  __shared__ __align__(16) int32_t tb[fr::kTileRows * fr::kLimbs];
  __shared__ __align__(16) int32_t one[2 * fr::kLimbs];
  DeviceBlock blk;
  fr::pointwise_tile<kOp, kWide>(blk, blockIdx.x, n, a, sa, b, sb, out, ta, tb, one);
}

template <bool kFirst, bool kLast, bool kInverse>
__global__ void __launch_bounds__(fr::kPassThreads) fr_fft_pass_kernel(const int32_t* __restrict__ in, uint32_t* words,
                                                                       int32_t* __restrict__ out,
                                                                       const uint32_t* __restrict__ twiddles,
                                                                       fr::Pass ps, fr::Scale n_inv) {
  extern __shared__ __align__(16) uint32_t smem[];
  DeviceBlock blk;
  fr::fft_pass<kFirst, kLast, kInverse>(blk, ps, blockIdx.x, in, words, out, twiddles, n_inv, smem);
}

// one pass's launch: the kernel of its place in the transform, with the
// shared memory of its tile (up to fr::kPassSmemBytes, above the 48 KB a
// kernel gets without asking: asked for once a kernel and device, at its
// first launch there, and the answer kept)
template <bool kFirst, bool kLast, bool kInverse>
cudaError_t pass_launch(cudaStream_t s, const int32_t* x, uint32_t* w, int32_t* y, const uint32_t* tw,
                        const fr::Pass& ps, const fr::Scale& scale) {
  constexpr int kDevices = 64;
  static std::atomic<int> asked[kDevices];  // 0 not yet, else 1 + the answer
  int dev = 0;
  cudaError_t opted = cudaGetDevice(&dev);
  if (opted != cudaSuccess) return opted;
  const int known = dev < kDevices ? asked[dev].load(std::memory_order_relaxed) : 0;
  if (known) {
    opted = (cudaError_t)(known - 1);
  } else {
    opted = cudaFuncSetAttribute(fr_fft_pass_kernel<kFirst, kLast, kInverse>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, fr::kPassSmemBytes);
    if (dev < kDevices) asked[dev].store(1 + (int)opted, std::memory_order_relaxed);
  }
  if (opted != cudaSuccess) return opted;
  const size_t bytes = 4 * (size_t)fr::pass_smem_words(ps, kFirst || kLast);
  fr_fft_pass_kernel<kFirst, kLast, kInverse><<<(unsigned)ps.blocks(), ps.threads(), bytes, s>>>(x, w, y, tw, ps,
                                                                                                  scale);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t to) { return ((uintptr_t)p & (to - 1)) == 0; }

// 16-byte pieces where every span a tile copies is 16-byte aligned (an
// operand of stride 0 is copied in 8-byte pieces either way)
template <int kOp>
cudaError_t mul_launch(const void* a, int64_t sa, const void* b, int64_t sb, void* out, int64_t n,
                       cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + fr::kTileRows - 1) / fr::kTileRows);
  const bool wide = aligned(out, 16) && (!sa || aligned(a, 16)) && (!sb || aligned(b, 16));
  const int32_t *x = (const int32_t*)a, *y = (const int32_t*)b;
  if (wide)
    fr_mul_kernel<kOp, true><<<blocks, fr::kTileRows, 0, stream>>>(x, sa, y, sb, (int32_t*)out, n);
  else
    fr_mul_kernel<kOp, false><<<blocks, fr::kTileRows, 0, stream>>>(x, sa, y, sb, (int32_t*)out, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K12: out = a b 2^-264 (op 0), a + b (op 1) or a - b (op 2) mod r for n
// elements; sa and sb are the operands' strides in int32 elements (22, or
// 0 for one element read by every thread).
int fr_mul_launch(const void* a, int64_t sa, const void* b, int64_t sb, void* out, int64_t n, int op,
                  void* stream) {
  if ((sa != 0 && sa != fr::kLimbs) || (sb != 0 && sb != fr::kLimbs)) return (int)cudaErrorInvalidValue;
  if (!aligned(a, 8) || !aligned(b, 8) || !aligned(out, 8)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  if (op == fr::kMul) return (int)mul_launch<fr::kMul>(a, sa, b, sb, out, n, s);
  if (op == fr::kAdd) return (int)mul_launch<fr::kAdd>(a, sa, b, sb, out, n, s);
  if (op == fr::kSub) return (int)mul_launch<fr::kSub>(a, sa, b, sb, out, n, s);
  return (int)cudaErrorInvalidValue;
}

// K11: the transform of n = 2^log_n >= 2 rows of `in` into `out` (both
// (n, 22) limbs, contiguous), through `words` ((n, 8) scratch);
// `twiddles` (n/2, 8) words; `n_inv` 8 words (read on the inverse only).
// fr::pass_count(log_n, fr::kPassStages) launches on `stream`; the first
// refused one's error is returned.
int fr_fft_launch(const void* in, void* words, void* out, const void* twiddles, int64_t n, int log_n,
                  const uint32_t* n_inv, int inverse, void* stream) {
  if (log_n < 1 || log_n > 31 || n != ((int64_t)1 << log_n)) return (int)cudaErrorInvalidValue;
  if (!aligned(in, 8) || !aligned(out, 8) || !aligned(words, 16) || !aligned(twiddles, 16))
    return (int)cudaErrorMisalignedAddress;
  fr::Scale scale;
  for (int j = 0; j < fr::kWords; ++j) scale.v[j] = n_inv[j];
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* x = (const int32_t*)in;
  uint32_t* w = (uint32_t*)words;
  int32_t* y = (int32_t*)out;
  const uint32_t* tw = (const uint32_t*)twiddles;
  const int passes = fr::pass_count(log_n, fr::kPassStages);
  for (int p = 0; p < passes; ++p) {
    const fr::Pass ps = fr::pass_plan(log_n, fr::kPassStages, p);
    const bool first = p == 0, last = p == passes - 1;
    cudaError_t err;
    if (first && last && inverse)
      err = pass_launch<true, true, true>(s, x, w, y, tw, ps, scale);
    else if (first && last)
      err = pass_launch<true, true, false>(s, x, w, y, tw, ps, scale);
    else if (first)
      err = pass_launch<true, false, false>(s, x, w, y, tw, ps, scale);
    else if (last && inverse)
      err = pass_launch<false, true, true>(s, x, w, y, tw, ps, scale);
    else if (last)
      err = pass_launch<false, true, false>(s, x, w, y, tw, ps, scale);
    else
      err = pass_launch<false, false, false>(s, x, w, y, tw, ps, scale);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* fr_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
