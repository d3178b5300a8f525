// Static-exponent pow chains of the BLS12-381 base field and its quadratic
// extension for Hopper (sm_90a), one launch a chain, on the port's tensor
// layout: (N, 32) (Fq) or (N, 2, 32) (Fq2) int32 canonical 12-bit limbs,
// Montgomery radix 2^384.
//
// K5 fq_pow replaces consensus_specs_tpu/ops/curve_jax.py:282 `fq_pow_bits`
// and consensus_specs_tpu/ops/fq.py:201 `inv` (a^(p-2)); K6 fq2_pow replaces
// curve_jax.py:294 `fq2_pow_bits`. Each is a lax.scan over the exponent's
// ~380 bits, one device loop inside its jit. Eager PyTorch had issued every
// step as its own K3/K4 launch: about 610 launches an Fq chain, 1,820 an
// Fq2 chain, each costing the host tens of microseconds. The exponents are
// public constants ((p+1)/4, (p-1)/2, (p-3)/4, p-2), so the wrapper passes
// the exponent by value in the launch's parameters.
//
// What bounds them on this card:
// - at a BLS flush's sizes (130-260 elements a chain) latency: a few warps
//   on a few SMs, the rest of the card idle, so a chain takes the time of
//   its longest dependent sequence. K5's is ~610 Montgomery products, each
//   K3's 16-row chain of two dependent exchanges a row on a group of 4
//   lanes (1.1 us). K6's bit-serial walk ran a step's 2 or 3 independent
//   Fq products one after another: 1,447 in series at (p - 1) / 2;
// - at a pubkey decode's 16,385 elements, integer throughput: ~610 products
//   of ~1,900 instructions an element (fq.cu's count) over all 132 SMs.
// Bytes are no bound: an element is read once and written once (256 or
// 512 bytes), against ~10^6 instructions of work.
//
// The design: each element's accumulator and base stay in a lane group's
// registers from the first bit to the last, as fq.cuh's fq::lanes digits
// (G = 4 lanes an element, K3's group), so a chain is one launch and
// touches device memory only at its ends. The branch on a bit is uniform
// (the exponent is the same for every thread). Lanes past the last element
// run the group code on zeros and store nothing. K5 walks the bits with
// K3's mont_mul. K6 is built for latency: the walk takes a fixed 4-bit
// window, and every Fq2 square or product is one batch of independent Fq
// products (fq.cuh fq2_products: a square's 2, a product's 4, their rows
// interleaved, the sums that feed only products lazy), split over two
// groups of 8 lanes that hold the same element, so that a warp issues
// half of each batch. At (p - 1) / 2 the chain is 480 batched rounds deep
// (14 table products, 376 squares, 90 window products) in place of 1,447
// products one after another. The window's table (a^0 .. a^15) lies in
// shared memory, 256 bytes a lane, each lane reading only the words it
// wrote.

#include <cstdint>
#include <cuda_runtime.h>

#include "fq.cuh"

namespace {

constexpr int kPowLanes = 4;   // K5's group, K3's size
constexpr int kFq2Lanes = 8;   // K6's group: 2 digits a lane (faster than 4, PERF.md)
constexpr int kFq2Subgroups = 2;  // K6's element on 2 groups of a warp, each running half of a step's products
constexpr int kThreads = 128;  // a block; faster than 32 at 260 and 16,385 elements (PERF.md)

template <int G>
using Digits = fq::lanes::Lanes<uint32_t, G>;

__global__ void __launch_bounds__(kThreads) fq_pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                                                          int64_t n, fq::lanes::Exponent e) {
  constexpr int G = kPowLanes, D = fq::lanes::kDigits / G;
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int l = (int)(threadIdx.x % G);
  Digits<G> x[D] = {}, r[D];
  if (i < n) fq::lanes::load_digits<G>(x, a + i * fq::kLimbs, l);
  fq::lanes::pow<G>(r, x, e);
  if (i < n) fq::lanes::store_digits<G>(out + i * fq::kLimbs, r, l);
}

// K6's table: a^0 .. a^15 for each lane of a block, in shared memory
// (32 KB a block)
using Fq2Table = fq::lanes::Fq2Table<kFq2Lanes, fq::lanes::kWindowEntries>;

__global__ void __launch_bounds__(kThreads) fq2_pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                                                           int64_t n, fq::lanes::Exponent e) {
  constexpr int G = kFq2Lanes, S = kFq2Subgroups, D = fq::lanes::kDigits / G;
  __shared__ uint32_t table_words[Fq2Table::kWordsPerThread * kThreads];
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / (G * S);
  const int l = (int)(threadIdx.x % G);
  const bool first = (threadIdx.x / G) % S == 0;  // each subgroup loads the element, the first stores it
  Digits<G> x[2][D] = {}, r[2][D];
  if (i < n) {
    fq::lanes::load_digits<G>(x[0], a + i * 2 * fq::kLimbs, l);
    fq::lanes::load_digits<G>(x[1], a + i * 2 * fq::kLimbs + fq::kLimbs, l);
  }
  Fq2Table table{table_words};
  fq::lanes::fq2_pow<G, S>(r, x, e, table);
  if (i < n && first) {
    fq::lanes::store_digits<G>(out + i * 2 * fq::kLimbs, r[0], l);
    fq::lanes::store_digits<G>(out + i * 2 * fq::kLimbs + fq::kLimbs, r[1], l);
  }
}

// words: the exponent's 12 little-endian 32-bit words; bits: its length
fq::lanes::Exponent exponent(const uint32_t* words, int bits) {
  fq::lanes::Exponent e;
  for (int j = 0; j < fq::kWords; ++j) e.words[j] = words[j];
  e.bits = bits;
  return e;
}

}  // namespace

extern "C" {

// K5 and K6: out = a^e for n elements (contiguous, 16-byte aligned).
int fq_pow_launch(const void* a, void* out, int64_t n, const uint32_t* words, int bits, void* stream) {
  const unsigned blocks = (unsigned)((n * kPowLanes + kThreads - 1) / kThreads);
  fq_pow_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const int32_t*)a, (int32_t*)out, n,
                                                               exponent(words, bits));
  return (int)cudaGetLastError();
}

int fq2_pow_launch(const void* a, void* out, int64_t n, const uint32_t* words, int bits, void* stream) {
  const unsigned blocks = (unsigned)((n * kFq2Lanes * kFq2Subgroups + kThreads - 1) / kThreads);
  fq2_pow_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const int32_t*)a, (int32_t*)out, n,
                                                                exponent(words, bits));
  return (int)cudaGetLastError();
}

const char* fq_pow_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
