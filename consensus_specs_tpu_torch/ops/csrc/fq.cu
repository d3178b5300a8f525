// BLS12-381 base-field kernels for Hopper (sm_90a), on the port's tensor
// layout: (N, 32) int32 canonical 12-bit limbs, Montgomery radix 2^384.
//
// K3 fq_mul replaces consensus_specs_tpu/ops/fq.py:175 `mul` (`_poly_mul`, a
// 32 x 32 schoolbook limb convolution, then `_mont_reduce`, a 32-round
// word-serial Montgomery reduction, then `_cond_sub_p`). It is the multiply
// under every tower, curve, hash-to-curve and pairing op of the BLS stack.
//
// K4 fq_addsub replaces fq.py:115 `add`, :120 `sub` and :127 `neg`: a 32-step
// carry ripple (`_carry_norm`'s lax.scan) followed by `_geq` / `_cond_sub_p`.
// In eager PyTorch that ripple alone is about a hundred launches; here it is
// one. The op code picks (a + b), (a - b) or (-b) mod p.
//
// What bounds them on this card at the sizes of a BLS flush (130 to 18,720
// elements a launch, most of them 130-520: a block's 130 rows times a few
// products): first latency and occupancy, then bytes. Each element moves 384 bytes (two 128-byte
// operands in, one out); at 4,608 elements that is 0.53 us of device memory
// time, below the card's floor for one launch (about 1 us). The first port
// gave each element one thread in blocks of 256: 4,608 elements filled 18 of
// the 132 SMs, and each thread ran its element as one dependent chain (about
// 1,900 instructions for a product, 200 for a sum, most of the sum's the
// repacking between 12-bit limbs and 32-bit words) with one or two warps a
// scheduler to hide it. Its loads were uncoalesced: each thread read its own
// 128-byte line, so one warp-wide load touched 32 lines.
//
// The lane-group design (fq.cuh, namespace fq::lanes): a group of G lanes
// per element, each lane holding D = 16 / G of its 24-bit digits, which are
// 2 D of its limbs, so no repacking crosses lanes and the group loads and
// stores its element's 128-byte line together. Blocks are 128 threads, so
// 4,608 elements make 144 (K3, G = 4) or 288 (K4, G = 8) blocks over the
// 132 SMs. Each G is the faster of 4 and 8 over a flush's launch sizes,
// timed in turns on the card (PERF.md); fq.cuh takes either.
// - K4 (G = 8: one int4 of 4 limbs a lane): each lane adds or subtracts its
//   2 digits; the carry or borrow between lanes is one carry-lookahead over
//   the group's generate/propagate bits, taken with two ballots; the
//   conditional subtraction of p (add) or add-back of p (sub, neg) is a
//   second step of the same kind, each lane taking its digits of p from a
//   constant table (fq::lanes::kPDigits). A lane's chain is a few dozen
//   instructions.
// - K3 (G = 4: two int4s of 8 limbs a lane): operand scanning over b's 16
//   digits; each lane keeps its digits of the running sum in 64-bit
//   accumulators that are not carried in the loop, so a row is D
//   multiply-adds for a b_i and D for m p on each lane, with b_i, m and the
//   divide-by-2^24 shift passed by shuffles. The carries are resolved once
//   at the end, then one conditional subtraction of p as in K4.
// A broadcast operand (one element for the whole batch) is read with
// stride 0 instead of being materialised.
//
// The one-thread kernels of the first port stay below, with their own
// launch functions, for measurement only: nothing on the main path
// launches them.

#include <cstdint>
#include <cuda_runtime.h>

#include "fq.cuh"

namespace {

constexpr int kThreads = 256;       // one-thread kernels
constexpr int kGroupThreads = 128;  // lane-group kernels
constexpr int kAddSubLanes = 8;
constexpr int kMulLanes = 4;

// ---------------------------------------------------------------------------
// Lane-group kernels (the main path)

template <int G>
using Digits = fq::lanes::Lanes<uint32_t, G>;

using fq::lanes::load_digits;
using fq::lanes::store_digits;

// Lanes past the last element still run the group code (every lane of a
// warp takes part in its shuffles and ballots), on zeros, and store nothing.
template <int G>
__device__ __forceinline__ void mul_lanes(const int32_t* __restrict__ a, int64_t a_stride,
                                          const int32_t* __restrict__ b, int64_t b_stride,
                                          int32_t* __restrict__ out, int64_t n) {
  constexpr int D = fq::lanes::kDigits / G;
  const int64_t i = ((int64_t)blockIdx.x * kGroupThreads + threadIdx.x) / G;
  const int l = (int)(threadIdx.x % G);
  Digits<G> x[D] = {}, y[D] = {}, r[D];
  if (i < n) {
    load_digits<G>(x, a + i * a_stride, l);
    load_digits<G>(y, b + i * b_stride, l);
  }
  fq::lanes::mont_mul<G>(r, x, y);
  if (i < n) store_digits<G>(out + i * fq::kLimbs, r, l);
}

template <int G>
__device__ __forceinline__ void addsub_lanes(const int32_t* __restrict__ a, int64_t a_stride,
                                             const int32_t* __restrict__ b, int64_t b_stride,
                                             int32_t* __restrict__ out, int64_t n, int op) {
  constexpr int D = fq::lanes::kDigits / G;
  const int64_t i = ((int64_t)blockIdx.x * kGroupThreads + threadIdx.x) / G;
  const int l = (int)(threadIdx.x % G);
  Digits<G> x[D] = {}, y[D] = {}, r[D];
  if (i < n) {
    if (op != 2) load_digits<G>(x, a + i * a_stride, l);
    load_digits<G>(y, b + i * b_stride, l);
  }
  fq::lanes::addsub<G>(r, x, y, op);
  if (i < n) store_digits<G>(out + i * fq::kLimbs, r, l);
}

__global__ void __launch_bounds__(kGroupThreads) fq_mul_lanes_kernel(const int32_t* __restrict__ a, int64_t a_stride,
                                                                   const int32_t* __restrict__ b, int64_t b_stride,
                                                                   int32_t* __restrict__ out, int64_t n) {
  mul_lanes<kMulLanes>(a, a_stride, b, b_stride, out, n);
}

__global__ void __launch_bounds__(kGroupThreads) fq_addsub_lanes_kernel(const int32_t* __restrict__ a, int64_t a_stride,
                                                                      const int32_t* __restrict__ b, int64_t b_stride,
                                                                      int32_t* __restrict__ out, int64_t n, int op) {
  addsub_lanes<kAddSubLanes>(a, a_stride, b, b_stride, out, n, op);
}

unsigned group_blocks(int64_t n, int lanes) {
  return (unsigned)((n * lanes + kGroupThreads - 1) / kGroupThreads);
}

// ---------------------------------------------------------------------------
// One-thread kernels of the first port (measurement only)

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

__global__ void __launch_bounds__(kThreads) fq_mul_thread_kernel(const int32_t* __restrict__ a, int64_t a_stride,
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

__global__ void __launch_bounds__(kThreads) fq_addsub_thread_kernel(const int32_t* __restrict__ a, int64_t a_stride,
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

// K3 and K4 as the main path launches them. a_stride / b_stride: int32
// elements between consecutive operands, 32 or 0.
int fq_mul_launch(const void* a, int64_t a_stride, const void* b, int64_t b_stride, void* out, int64_t n,
                  void* stream) {
  fq_mul_lanes_kernel<<<group_blocks(n, kMulLanes), kGroupThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, a_stride, (const int32_t*)b, b_stride, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

// op: 0 add, 1 sub, 2 neg (of b)
int fq_addsub_launch(const void* a, int64_t a_stride, const void* b, int64_t b_stride, void* out, int64_t n,
                     int op, void* stream) {
  fq_addsub_lanes_kernel<<<group_blocks(n, kAddSubLanes), kGroupThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, a_stride, (const int32_t*)b, b_stride, (int32_t*)out, n, op);
  return (int)cudaGetLastError();
}

// the one-thread kernels of the first port, for measurement
int fq_mul_thread_launch(const void* a, int64_t a_stride, const void* b, int64_t b_stride, void* out, int64_t n,
                         void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  fq_mul_thread_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, a_stride, (const int32_t*)b, b_stride, (int32_t*)out, n);
  return (int)cudaGetLastError();
}

int fq_addsub_thread_launch(const void* a, int64_t a_stride, const void* b, int64_t b_stride, void* out, int64_t n,
                            int op, void* stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  fq_addsub_thread_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, a_stride, (const int32_t*)b, b_stride, (int32_t*)out, n, op);
  return (int)cudaGetLastError();
}

const char* fq_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
