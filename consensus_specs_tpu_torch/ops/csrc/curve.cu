// Static scalar ladders on BLS12-381 for Hopper (sm_90a), one launch a
// ladder, on the port's tensor layout: Jacobian (X, Y, Z), each (N, 32)
// (G1, coordinates in Fq) or (N, 2, 32) (G2, in Fq2) int32 canonical 12-bit
// limbs, Montgomery radix 2^384.
//
// K7 g1_mul_static and K8 g2_mul_static replace
// consensus_specs_tpu/ops/curve_jax.py:219 `scalar_mul_static`: [k] P for a
// public k, one lax.scan over k's bits inside its jit. Eager PyTorch had
// issued every field operation of every doubling and addition as its own
// K3/K4 launch: for k = |x| = 0xd201000000010000 (63 doublings, 5
// additions) 1,578 launches a G1 ladder and 2,690 a G2 ladder, each costing
// the host tens of microseconds. A BLS flush runs 5 such ladders (the G1
// and G2 subgroup checks, hash-to-G2's cofactor clearing).
//
// What bounds them on this card:
// - at a flush's G2 sizes (130-260 elements) latency: a ladder is one
//   dependent sequence of Montgomery products on one lane group (G1:
//   63 x 7 + 5 x 23 = 556; G2: 63 x 16 + 5 x 59 = 1,303, an Fq2 square
//   being 2 products and an Fq2 product 3, run one after another), each a
//   16-row chain of shuffles and multiply-adds: a few warps on a few SMs,
//   the rest of the card idle;
// - at a pubkey decode's 16,385 G1 elements, integer throughput: 556
//   products and 1,022 sums an element over all 132 SMs.
// Bytes are no bound: an element is read once and written once (768 or
// 1,536 bytes), against ~10^6 instructions of work.
//
// The design: each element's base point and accumulator stay in a lane
// group's registers from the first bit to the last, as fq.cuh's fq::lanes
// digits (the mont_mul, addsub, fq2_mul and fq2_square of the pow chains),
// so a ladder is one launch and touches device memory only at its ends.
// K7 runs on groups of 4 lanes (K3's, 128 registers, no spills). K8 holds
// twice the digits, and on 4 lanes it needed all 255 registers and
// spilled; on groups of 8 it took 1.28 ms a ladder at 130 points on an
// H100 against 2.68 ms on 4, timed in turns (PERF.md), so K8 runs on 8.
// curve.cuh holds the point arithmetic; the special cases of the addition are selects on masks that
// are the same on every lane of a group, and the branch on a bit of k is
// uniform. Lanes past the last element run the group code on zeros (the
// point at infinity) and store nothing.

#include <cstdint>
#include <cuda_runtime.h>

#include "curve.cuh"

namespace {

constexpr int kG1Lanes = 4;    // K7's group
constexpr int kG2Lanes = 8;    // K8's group
constexpr int kThreads = 128;  // a block, as K5/K6

// one coordinate: N halves of 32 limbs
template <int G, int N>
__device__ __forceinline__ void load(typename curve::Field<G, N>::E& r, const int32_t* src, int l) {
#pragma unroll
  for (int n = 0; n < N; ++n) fq::lanes::load_digits<G>(r.c[n], src + n * fq::kLimbs, l);
}

template <int G, int N>
__device__ __forceinline__ void store(int32_t* dst, const typename curve::Field<G, N>::E& r, int l) {
#pragma unroll
  for (int n = 0; n < N; ++n) fq::lanes::store_digits<G>(dst + n * fq::kLimbs, r.c[n], l);
}

// the ladder of the element of this thread's group of G lanes
template <int G, int N>
__device__ __forceinline__ void ladder(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                                       const int32_t* __restrict__ z, int32_t* __restrict__ ox,
                                       int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t n,
                                       const fq::lanes::Exponent& k) {
  using F = curve::Field<G, N>;
  constexpr int64_t kStride = N * fq::kLimbs;
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int l = (int)(threadIdx.x % G);
  curve::Jac<F> p = {}, r;
  if (i < n) {
    load<G, N>(p.x, x + i * kStride, l);
    load<G, N>(p.y, y + i * kStride, l);
    load<G, N>(p.z, z + i * kStride, l);
  }
  curve::mul_static<F>(r, p, k);
  if (i < n) {
    store<G, N>(ox + i * kStride, r.x, l);
    store<G, N>(oy + i * kStride, r.y, l);
    store<G, N>(oz + i * kStride, r.z, l);
  }
}

#define CURVE_KERNEL(name, G, N)                                                                                  \
  __global__ void __launch_bounds__(kThreads)                                                                     \
      name(const int32_t* __restrict__ x, const int32_t* __restrict__ y, const int32_t* __restrict__ z,          \
           int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t n,              \
           fq::lanes::Exponent k) {                                                                               \
    ladder<G, N>(x, y, z, ox, oy, oz, n, k);                                                                      \
  }

CURVE_KERNEL(g1_mul_static_kernel, kG1Lanes, 1)
CURVE_KERNEL(g2_mul_static_kernel, kG2Lanes, 2)

using Kernel = void (*)(const int32_t*, const int32_t*, const int32_t*, int32_t*, int32_t*, int32_t*, int64_t,
                        fq::lanes::Exponent);

int launch(Kernel kernel, int lanes, const void* x, const void* y, const void* z, void* ox, void* oy, void* oz,
           int64_t n, const uint32_t* words, int bits, void* stream) {
  fq::lanes::Exponent k;
  for (int j = 0; j < fq::kWords; ++j) k.words[j] = words[j];
  k.bits = bits;
  const unsigned blocks = (unsigned)((n * lanes + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const int32_t*)x, (const int32_t*)y, (const int32_t*)z,
                                                       (int32_t*)ox, (int32_t*)oy, (int32_t*)oz, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K7 and K8: (ox, oy, oz) = [k] (x, y, z) for n points (each coordinate
// contiguous, 16-byte aligned); k as its 12 little-endian 32-bit words and
// its bit length.
int g1_mul_static_launch(const void* x, const void* y, const void* z, void* ox, void* oy, void* oz, int64_t n,
                         const uint32_t* words, int bits, void* stream) {
  return launch(g1_mul_static_kernel, kG1Lanes, x, y, z, ox, oy, oz, n, words, bits, stream);
}

int g2_mul_static_launch(const void* x, const void* y, const void* z, void* ox, void* oy, void* oz, int64_t n,
                         const uint32_t* words, int bits, void* stream) {
  return launch(g2_mul_static_kernel, kG2Lanes, x, y, z, ox, oy, oz, n, words, bits, stream);
}

const char* curve_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
