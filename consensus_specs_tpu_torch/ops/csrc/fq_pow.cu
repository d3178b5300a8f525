// Static-exponent pow chains of the BLS12-381 base field and its quadratic
// extension for Hopper (sm_90a), one launch a chain, on the port's tensor
// layout: (N, 32) (Fq) or (N, 2, 32) (Fq2) int32 canonical 12-bit limbs,
// Montgomery radix 2^384.
//
// K5 fq_pow replaces consensus_specs_tpu/ops/curve_jax.py:282 `fq_pow_bits`
// (and served ops/fq.py:201 `inv`, a^(p-2), until K9 fq_inv of fq_inv.cu
// took it); K6 fq2_pow replaces curve_jax.py:294 `fq2_pow_bits`. Each is a
// lax.scan over the exponent's ~380 bits, one device loop inside its jit.
// Eager PyTorch had issued every step as its own K3/K4 launch: about 610
// launches an Fq chain, 1,820 an Fq2 chain, each costing the host tens of
// microseconds. The exponents are public constants ((p+1)/4, (p-1)/2,
// (p-3)/4, p-2), so the wrapper passes the exponent by value in the
// launch's parameters.
//
// What bounds them on this card:
// - at a BLS flush's sizes (130-260 elements a chain) latency: a few warps
//   on a few SMs, the rest of the card idle, so a chain takes the time of
//   its longest dependent sequence of products;
// - at a pubkey decode's 16,385 elements, integer throughput: ~480
//   products of ~1,800 instructions an element over all 132 SMs.
// Bytes are no bound: an element is read once and written once (256 or
// 512 bytes), against ~10^6 instructions of work.
//
// The design: each element's accumulator and base stay in a lane group's
// registers from the first bit to the last, as fq.cuh's fq::lanes digits,
// so a chain is one launch and touches device memory only at its ends.
// Both walk a fixed 4-bit window, the table (a^0 .. a^15) in shared memory,
// each lane reading only the words it wrote: at (p - 1) / 2 the chain is
// 480 rounds deep (14 table products, 376 squares, 90 window products)
// against 609 products on the bit-serial walk. The branch on a nibble and
// the table index are uniform (the exponent is the same for every thread).
// Lanes past the last element run the group code on zeros and store
// nothing.
// - K5 has no independent products in a step, so each round is one lone
//   Montgomery product, and its latency is the kernel's time. K5 takes
//   mont_mul_n<G, 1> with its option for a chain: rows fully unrolled
//   (each broadcast of b's digits issued ahead of its row) and the result
//   left below 2p (no carry-lookahead and conditional subtraction between
//   products, once at the end), on 8 lanes an element up to a few
//   thousand elements and on 4 from there (kPow* below).
// - K6 runs every Fq2 square or product as one batch of independent Fq
//   products (fq.cuh fq2_products: a square's 2, a product's 4, their rows
//   interleaved, the sums that feed only products lazy), split over two
//   groups of 8 lanes that hold the same element, so that a warp issues
//   half of each batch: at (p - 1) / 2, 480 batched rounds in place of
//   1,447 products one after another.

#include <cstdint>
#include <cuda_runtime.h>

#include "fq.cuh"

namespace {

// K5's lanes an element, the measured best at each size. While the
// chain's latency sets the time, 8 lanes shorten each product (PERF.md,
// run 10a: (p - 1) / 2 at 130 elements in turns, 337.5 us against 388.7 on
// 4; 335 us flat up to 2,080 elements, 4 lanes 389 up to 4,160); once
// 8-lane groups give a scheduler more than one warp (past 132 x 4 x 32 / 8
// = 2,112 elements) the card's issue rate takes over, and 4 lanes spend
// fewer instructions an element (run 10c: 4 lanes won from 3,120
// elements, 373.1 against 382.6 us, and took 927.4 against 1,212.4 at
// 16,385).
constexpr int kPowLatencyLanes = 8;
constexpr int kPowThroughputLanes = 4;
constexpr int64_t kPowThroughputFrom = 3072;  // elements

constexpr int kFq2Lanes = 8;   // K6's group: 2 digits a lane (faster than 4, PERF.md)
constexpr int kFq2Subgroups = 2;  // K6's element on 2 groups of a warp, each running half of a step's products
constexpr int kThreads = 128;  // a block; faster than 32 at 260 and 16,385 elements (PERF.md)

template <int G>
using Digits = fq::lanes::Lanes<uint32_t, G>;

// K5 on groups of G lanes; its table (a^0 .. a^15 for each lane of a
// block) in shared memory, 16 KB a block on 8 lanes, 32 KB on 4
template <int G>
__global__ void __launch_bounds__(kThreads) fq_pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                                                          int64_t n, fq::lanes::Exponent e) {
  using Table = fq::lanes::FqTable<G, fq::lanes::kWindowEntries>;
  constexpr int D = fq::lanes::kDigits / G;
  __shared__ uint32_t table_words[Table::kWordsPerThread * kThreads];
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int l = (int)(threadIdx.x % G);
  Digits<G> x[D] = {}, r[D];
  if (i < n) fq::lanes::load_digits<G>(x, a + i * fq::kLimbs, l);
  Table table{table_words};
  fq::lanes::pow<G>(r, x, e, table);
  if (i < n) fq::lanes::store_digits<G>(out + i * fq::kLimbs, r, l);
}

template <int G>
int launch_pow(const void* a, void* out, int64_t n, const fq::lanes::Exponent& e, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n * G + kThreads - 1) / kThreads);
  fq_pow_kernel<G><<<blocks, kThreads, 0, stream>>>((const int32_t*)a, (int32_t*)out, n, e);
  return (int)cudaGetLastError();
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
  const fq::lanes::Exponent e = exponent(words, bits);
  return n < kPowThroughputFrom ? launch_pow<kPowLatencyLanes>(a, out, n, e, (cudaStream_t)stream)
                                : launch_pow<kPowThroughputLanes>(a, out, n, e, (cudaStream_t)stream);
}

int fq2_pow_launch(const void* a, void* out, int64_t n, const uint32_t* words, int bits, void* stream) {
  const unsigned blocks = (unsigned)((n * kFq2Lanes * kFq2Subgroups + kThreads - 1) / kThreads);
  fq2_pow_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const int32_t*)a, (int32_t*)out, n,
                                                                exponent(words, bits));
  return (int)cudaGetLastError();
}

const char* fq_pow_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
