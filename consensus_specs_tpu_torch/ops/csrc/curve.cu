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
// - at a flush's G2 sizes (130-260 elements) latency: a few warps on a few
//   SMs, the rest of the card idle, so a ladder takes the time of its
//   longest dependent sequence of Montgomery products, each a 16-row chain
//   of two dependent exchanges a row. Run one after another, as the first
//   form of these ladders did, that was 556 products on G1 and 1,303 on G2
//   (an Fq2 square 2 products and an Fq2 product 3);
// - at a pubkey decode's 16,385 G1 elements, integer throughput: 556
//   products and 1,022 sums an element over all 132 SMs.
// Bytes are no bound: an element is read once and written once (768 or
// 1,536 bytes), against ~10^6 instructions of work.
//
// The design: each element's base point and accumulator stay in a lane
// group's registers from the first bit to the last, as fq.cuh's fq::lanes
// digits, so a ladder is one launch and touches device memory only at its
// ends. curve.cuh runs the doubling and the addition as level schedules:
// each level's independent field products are one batch (fq.cuh
// mont_mul_n, their rows interleaved), each level's independent sums one
// batch of carry rounds, the sums that feed only products lazy. A doubling
// is 3 batched rounds, an addition 5 (the base point's Z^2, 2 Z^3 and 2 Y
// made once a ladder), so by |x| a ladder is 216 rounds deep on either
// curve. At a flush's 130 points one warp's issue rate bounds a batch, so
// K8 spreads a point over a whole warp: groups of 16 lanes (one digit a
// lane), two of them holding the same point, each running half of every
// batch's products (mont_mul_split). K7, at a decode's 16,385 points, is
// bound by the card's integer rate and stays on groups of 4 lanes (K3's).
// The special cases of the addition are selects on masks that are the
// same on every lane of a group, and the branch on a bit of k is uniform.
// Lanes past the last element run the group code on zeros (the point at
// infinity) and store nothing.

#include <cstdint>
#include <cuda_runtime.h>

#include "curve.cuh"

namespace {

constexpr int kG1Lanes = 4;    // K7's group
constexpr int kG2Lanes = 16;   // K8's group: one digit a lane
constexpr int kG2Subgroups = 2;  // K8's point on 2 groups of a warp, each running half of a batch's products
constexpr int kThreads = 128;  // a block, as K5/K6

// one coordinate: N halves of 32 limbs
template <int G, int N, class E>
__device__ __forceinline__ void load(E& r, const int32_t* src, int l) {
#pragma unroll
  for (int n = 0; n < N; ++n) fq::lanes::load_digits<G>(r.c[n], src + n * fq::kLimbs, l);
}

template <int G, int N, class E>
__device__ __forceinline__ void store(int32_t* dst, const E& r, int l) {
#pragma unroll
  for (int n = 0; n < N; ++n) fq::lanes::store_digits<G>(dst + n * fq::kLimbs, r.c[n], l);
}

// the ladder of the element of this thread's S groups of G lanes (each
// loads the point; the first stores the result)
template <int G, int N, int S>
__device__ __forceinline__ void ladder(const int32_t* __restrict__ x, const int32_t* __restrict__ y,
                                       const int32_t* __restrict__ z, int32_t* __restrict__ ox,
                                       int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t n,
                                       const fq::lanes::Exponent& k) {
  using F = curve::Field<G, N, S>;
  constexpr int64_t kStride = N * fq::kLimbs;
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / (G * S);
  const int l = (int)(threadIdx.x % G);
  const bool first = (threadIdx.x / G) % S == 0;
  curve::Jac<F> p = {}, r;
  if (i < n) {
    load<G, N>(p.x, x + i * kStride, l);
    load<G, N>(p.y, y + i * kStride, l);
    load<G, N>(p.z, z + i * kStride, l);
  }
  curve::mul_static<F>(r, p, k);
  if (i < n && first) {
    store<G, N>(ox + i * kStride, r.x, l);
    store<G, N>(oy + i * kStride, r.y, l);
    store<G, N>(oz + i * kStride, r.z, l);
  }
}

#define CURVE_KERNEL(name, G, N, S)                                                                               \
  __global__ void __launch_bounds__(kThreads)                                                                     \
      name(const int32_t* __restrict__ x, const int32_t* __restrict__ y, const int32_t* __restrict__ z,          \
           int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t n,              \
           fq::lanes::Exponent k) {                                                                               \
    ladder<G, N, S>(x, y, z, ox, oy, oz, n, k);                                                                   \
  }

CURVE_KERNEL(g1_mul_static_kernel, kG1Lanes, 1, 1)
CURVE_KERNEL(g2_mul_static_kernel, kG2Lanes, 2, kG2Subgroups)

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
  return launch(g2_mul_static_kernel, kG2Lanes * kG2Subgroups, x, y, z, ox, oy, oz, n, words, bits, stream);
}

const char* curve_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
