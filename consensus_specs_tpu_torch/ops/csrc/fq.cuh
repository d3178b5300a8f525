// BLS12-381 base-field arithmetic: the device functions of the K3 (fq_mul)
// and K4 (fq_addsub) kernels of fq.cu and of the pow chains K5 (fq_pow) and
// K6 (fq2_pow) of fq_pow.cu, kept in a header so that later fused kernels
// (the Miller loop, the final exponentiation) can build on the same code.
// Two forms:
//
// - one thread per element (namespace fq): the kernels of the first port,
//   kept for measurement and for fused kernels that hold a whole element
//   in one thread;
// - a group of G lanes of a warp per element (namespace fq::lanes, below):
//   the kernels on the main path.
//
// Layouts:
// - the port's tensor layout: 32 canonical 12-bit limbs in int32 lanes,
//   little-endian (the JAX package's ops/fq.py layout, kept so that limb
//   tensors compare directly with it);
// - the one-thread arithmetic layout: 12 little-endian 32-bit words;
// - the lane-group layout: 16 little-endian 24-bit digits, two limbs each.
// R = 2^384 in all three (32 x 12 = 12 x 32 = 16 x 24 bits), so a value's
// Montgomery form is the same integer in every layout, and repacking at the
// boundary is exact.
//
// Every function takes and returns values below p. The header compiles as
// plain C++ too (without nvcc the qualifiers fall away, and a group's lanes
// run in lockstep over arrays), so its arithmetic can be checked by a host
// compiler against the plain PyTorch version.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define FQ_HD __host__ __device__ __forceinline__
#else
#define FQ_HD inline
#endif

namespace fq {

constexpr int kWords = 12;
constexpr int kLimbs = 32;
constexpr uint32_t kN0 = 0xfffcfffdu;  // -p^-1 mod 2^32

// p in 32-bit words, little-endian; a constexpr function so that unrolled
// loops fold each word into an immediate operand
FQ_HD constexpr uint32_t p_word(int i) {
  return i == 0 ? 0xffffaaabu : i == 1 ? 0xb9feffffu : i == 2 ? 0xb153ffffu : i == 3 ? 0x1eabfffeu
       : i == 4 ? 0xf6b0f624u : i == 5 ? 0x6730d2a0u : i == 6 ? 0xf38512bfu : i == 7 ? 0x64774b84u
       : i == 8 ? 0x434bacd7u : i == 9 ? 0x4b1ba7b6u : i == 10 ? 0x397fe69au : 0x1a0111eau;
}

// 32 limbs -> 12 words: each 8 limbs (96 bits) fill 3 words
FQ_HD void pack(uint32_t w[kWords], const uint32_t l[kLimbs]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const uint32_t* s = l + 8 * g;
    w[3 * g] = s[0] | (s[1] << 12) | (s[2] << 24);
    w[3 * g + 1] = (s[2] >> 8) | (s[3] << 4) | (s[4] << 16) | (s[5] << 28);
    w[3 * g + 2] = (s[5] >> 4) | (s[6] << 8) | (s[7] << 20);
  }
}

// 12 words -> 32 limbs
FQ_HD void unpack(uint32_t l[kLimbs], const uint32_t w[kWords]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    uint32_t* d = l + 8 * g;
    const uint32_t w0 = w[3 * g], w1 = w[3 * g + 1], w2 = w[3 * g + 2];
    d[0] = w0 & 0xfffu;
    d[1] = (w0 >> 12) & 0xfffu;
    d[2] = (w0 >> 24) | ((w1 & 0xfu) << 8);
    d[3] = (w1 >> 4) & 0xfffu;
    d[4] = (w1 >> 16) & 0xfffu;
    d[5] = (w1 >> 28) | ((w2 & 0xffu) << 4);
    d[6] = (w2 >> 8) & 0xfffu;
    d[7] = w2 >> 20;
  }
}

// r = t - p if t >= p, else t (t < 2p)
FQ_HD void cond_sub_p(uint32_t r[kWords], const uint32_t t[kWords]) {
  uint32_t d[kWords];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t s = (uint64_t)t[j] - p_word(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) r[j] = borrow ? t[j] : d[j];
}

// Montgomery product r = a b / 2^384 mod p, coarsely integrated operand
// scanning (CIOS): per word of b, one multiply-accumulate row and one
// reduction row, 64-bit accumulators. The running value stays below 2p, so
// one conditional subtraction ends it.
FQ_HD void mont_mul(uint32_t r[kWords], const uint32_t a[kWords], const uint32_t b[kWords]) {
  uint32_t t[kWords + 2];
#pragma unroll
  for (int j = 0; j < kWords + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[kWords];
    t[kWords] = (uint32_t)c;
    t[kWords + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * kN0;
    c = ((uint64_t)m * p_word(0) + t[0]) >> 32;  // the low word cancels
#pragma unroll
    for (int j = 1; j < kWords; ++j) {
      c += (uint64_t)m * p_word(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[kWords];
    t[kWords - 1] = (uint32_t)c;
    t[kWords] = t[kWords + 1] + (uint32_t)(c >> 32);
  }
  cond_sub_p(r, t);
}

// r = a + b mod p
FQ_HD void add_mod(uint32_t r[kWords], const uint32_t a[kWords], const uint32_t b[kWords]) {
  uint32_t s[kWords];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  cond_sub_p(r, s);  // a + b < 2p < 2^382: no carry out
}

// r = a - b mod p
FQ_HD void sub_mod(uint32_t r[kWords], const uint32_t a[kWords], const uint32_t b[kWords]) {
  uint32_t d[kWords];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  // where a < b, add p back; the carry out of the top word cancels the wrap
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)d[j] + (p_word(j) & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

// ---------------------------------------------------------------------------
// Lane groups. An element is spread over G lanes (G = 4 or 8; G divides
// 32, so a warp holds 32 / G elements): lane l holds the D = 16 / G digits
// D l .. D l + D - 1, which are the limbs 2 D l .. 2 D l + 2 D - 1 of the
// tensor layout, so each lane loads and stores its own 8 D bytes and the
// group moves its element's 128-byte line together, with no repacking
// across lanes.
//
// Code for a group is written once, for every lane: a lane-local value is a
// Lanes<T, G>, read and written as v[l] inside FQ_LANES(l, G) { ... }, and
// the lanes meet only in the two exchanges, group_ballot and group_shfl.
// With nvcc a Lanes holds the one value of the running lane, FQ_LANES runs
// its body once with l = the lane's index in its group, and the exchanges
// are the warp intrinsics. Without nvcc a Lanes holds all G values,
// FQ_LANES loops over the lanes, and the exchanges read the arrays: the
// lanes run in lockstep, one step for all of them before the next. A body
// must therefore read only its own lane's entries ([l]) and uniform values:
// on the card x[k] is the running lane's value whatever k. The host build
// holds code to that rule: an index other than the running step's lane, or
// an index outside a step, counts in lane_faults (and reads lane 0), which
// the host test requires to stay 0.
namespace lanes {

constexpr int kDigits = 16;
constexpr int kDigitBits = 24;
constexpr uint32_t kDigitMask = 0xffffffu;
constexpr uint32_t kN0Digit = kN0 & kDigitMask;  // -p^-1 mod 2^24

// p in 24-bit digits, little-endian: a table, since a lane reads the digits
// of its own place (in constant memory on the card)
#if defined(__CUDACC__)
__constant__
#else
constexpr
#endif
    uint32_t kPDigits[kDigits] = {0xffaaabu, 0xffffffu, 0xffb9feu, 0xb153ffu, 0xabfffeu, 0xf6241eu,
                                  0xa0f6b0u, 0x6730d2u, 0x8512bfu, 0x4b84f3u, 0xd76477u, 0x434bacu,
                                  0x1ba7b6u, 0xe69a4bu, 0xea397fu, 0x1a0111u};

// a b + c, a 32 x 32 -> 64-bit multiply-add (one instruction on the card)
FQ_HD uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t c) {
#if defined(__CUDA_ARCH__)
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(c));
  return r;
#else
  return (uint64_t)a * b + c;
#endif
}

#if defined(__CUDACC__)
#define FQ_GD __device__ __forceinline__
template <class T, int G>
struct Lanes {
  T v;
  FQ_GD T& operator[](int) { return v; }
  FQ_GD const T& operator[](int) const { return v; }
};
#define FQ_LANES(l, G) for (int l = (int)(threadIdx.x % (G)), l##_once = 1; l##_once; l##_once = 0)

// bit l of the result: pred of the group's lane l (the same word on every lane)
template <int G>
FQ_GD uint32_t group_ballot(const Lanes<bool, G>& pred) {
  const uint32_t warp = __ballot_sync(0xffffffffu, pred.v);
  return (warp >> ((threadIdx.x & 31u) & ~(uint32_t)(G - 1))) & ((1u << G) - 1u);
}

// lane l receives v of the group's lane src[l] (0 <= src[l] < G)
template <int G>
FQ_GD Lanes<uint32_t, G> group_shfl(const Lanes<uint32_t, G>& v, const Lanes<int, G>& src) {
  return {__shfl_sync(0xffffffffu, v.v, src.v, G)};
}
#else
#define FQ_GD inline
inline thread_local int running_lane = -1;  // the lane of the running FQ_LANES step, -1 between steps
inline thread_local long lane_faults = 0;

// starts lane l's step of a group of g lanes; false (and no lane) past the last
inline bool enter_lane(int l, int g) {
  running_lane = l < g ? l : -1;
  return l < g;
}

template <class T, int G>
struct Lanes {
  T v[G];
  T& operator[](int l) { return v[own(l)]; }
  const T& operator[](int l) const { return v[own(l)]; }
  static int own(int l) {
    if (l == running_lane) return l;
    ++lane_faults;
    return 0;
  }
};
#define FQ_LANES(l, G) for (int l = 0; ::fq::lanes::enter_lane(l, (G)); ++l)

template <int G>
FQ_GD uint32_t group_ballot(const Lanes<bool, G>& pred) {
  uint32_t bits = 0;
  for (int l = 0; l < G; ++l) bits |= (uint32_t)pred.v[l] << l;
  return bits;
}

template <int G>
FQ_GD Lanes<uint32_t, G> group_shfl(const Lanes<uint32_t, G>& v, const Lanes<int, G>& src) {
  Lanes<uint32_t, G> out;
  for (int l = 0; l < G; ++l) out.v[l] = v.v[src.v[l]];
  return out;
}
#endif

// v of lane `from` on every lane
template <int G>
FQ_GD Lanes<uint32_t, G> broadcast(const Lanes<uint32_t, G>& v, int from) {
  Lanes<int, G> src;
  FQ_LANES(l, G) src[l] = from;
  return group_shfl<G>(v, src);
}

// lane l receives v of lane l + 1; the top lane receives 0
template <int G>
FQ_GD Lanes<uint32_t, G> from_next(const Lanes<uint32_t, G>& v) {
  Lanes<int, G> src;
  FQ_LANES(l, G) src[l] = l + 1 < G ? l + 1 : l;
  Lanes<uint32_t, G> out = group_shfl<G>(v, src);
  FQ_LANES(l, G) out[l] = l + 1 < G ? out[l] : 0u;
  return out;
}

// lane l receives v of lane l - 1; lane 0 receives 0
template <int G>
FQ_GD Lanes<uint32_t, G> from_prev(const Lanes<uint32_t, G>& v) {
  Lanes<int, G> src;
  FQ_LANES(l, G) src[l] = l > 0 ? l - 1 : 0;
  Lanes<uint32_t, G> out = group_shfl<G>(v, src);
  FQ_LANES(l, G) out[l] = l > 0 ? out[l] : 0u;
  return out;
}

// Carry-lookahead over a group: from each lane's generate bit (a carry out
// of the lane whatever comes in) and propagate bit (a carry out exactly
// when one comes in), the carry into every lane at once, as bit l of
// ((G|P) + G) ^ (G|P) ^ G; bit G is the carry out of the top lane. This is
// fq_plain's packed generate/propagate addition, over lanes instead of limbs.
FQ_HD uint32_t lookahead(uint32_t gen, uint32_t prop) {
  const uint32_t x = gen | prop;
  return (x + gen) ^ x ^ gen;
}

// Carry the digits d into canonical 24-bit digits of the same value mod
// 2^384; returns the carry out of the top. Each digit must be at most
// 2^25 - 2 and each lane's digits together below 2^(24 D + 1) - 1, so that
// a digit carries at most 1 and a lane that generates a carry does not
// also propagate one.
template <int G>
FQ_GD uint32_t settle(Lanes<uint32_t, G> d[kDigits / G]) {
  constexpr int D = kDigits / G;
  Lanes<bool, G> gen, prop;
  FQ_LANES(l, G) {
    uint32_t c = 0;
    bool ones = true;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const uint32_t v = d[k][l] + c;
      d[k][l] = v & kDigitMask;
      c = v >> kDigitBits;
      ones = ones && d[k][l] == kDigitMask;
    }
    gen[l] = c != 0;
    prop[l] = ones;
  }
  const uint32_t carries = lookahead(group_ballot<G>(gen), group_ballot<G>(prop));
  FQ_LANES(l, G) {
    uint32_t c = (carries >> l) & 1u;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const uint32_t v = d[k][l] + c;
      d[k][l] = v & kDigitMask;
      c = v >> kDigitBits;
    }
  }
  return (carries >> G) & 1u;
}

// r = x - y mod 2^384 over canonical digits; returns the borrow out of the
// top (1 where x < y). r may not alias x or y.
template <int G>
FQ_GD uint32_t sub_digits(Lanes<uint32_t, G> r[kDigits / G], const Lanes<uint32_t, G> x[kDigits / G],
                          const Lanes<uint32_t, G> y[kDigits / G]) {
  constexpr int D = kDigits / G;
  Lanes<bool, G> gen, prop;
  FQ_LANES(l, G) {
    uint32_t b = 0;
    bool zero = true;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const uint32_t v = x[k][l] - y[k][l] - b;
      b = v >> 31;
      zero = zero && (v & kDigitMask) == 0;
    }
    gen[l] = b != 0;
    prop[l] = zero;  // the lane's x equals its y: a borrow in passes through
  }
  const uint32_t borrows = lookahead(group_ballot<G>(gen), group_ballot<G>(prop));
  FQ_LANES(l, G) {
    uint32_t b = (borrows >> l) & 1u;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const uint32_t v = x[k][l] - y[k][l] - b;
      r[k][l] = v & kDigitMask;
      b = v >> 31;
    }
  }
  return (borrows >> G) & 1u;
}

template <int G>
FQ_GD void load_p(Lanes<uint32_t, G> p[kDigits / G]) {
  constexpr int D = kDigits / G;
  FQ_LANES(l, G) {
#pragma unroll
    for (int k = 0; k < D; ++k) p[k][l] = kPDigits[D * l + k];
  }
}

// r = x - p if x >= p, else x (x canonical, below 2p)
template <int G>
FQ_GD void cond_sub_p(Lanes<uint32_t, G> r[kDigits / G], const Lanes<uint32_t, G> x[kDigits / G]) {
  constexpr int D = kDigits / G;
  Lanes<uint32_t, G> p[D], d[D];
  load_p<G>(p);
  const uint32_t below = sub_digits<G>(d, x, p);
  FQ_LANES(l, G) {
#pragma unroll
    for (int k = 0; k < D; ++k) r[k][l] = below ? x[k][l] : d[k][l];
  }
}

// K4's body: r = (a + b), (a - b) or (-b) mod p for op 0, 1, 2. op must be
// the same on every lane of the warp.
template <int G>
FQ_GD void addsub(Lanes<uint32_t, G> r[kDigits / G], const Lanes<uint32_t, G> a[kDigits / G],
                  const Lanes<uint32_t, G> b[kDigits / G], int op) {
  constexpr int D = kDigits / G;
  Lanes<uint32_t, G> s[D], p[D];
  if (op == 0) {
    FQ_LANES(l, G) {
#pragma unroll
      for (int k = 0; k < D; ++k) s[k][l] = a[k][l] + b[k][l];
    }
    settle<G>(s);  // a + b < 2p < 2^382: no carry out
    cond_sub_p<G>(r, s);
    return;
  }
  Lanes<uint32_t, G> x[D];
  FQ_LANES(l, G) {
#pragma unroll
    for (int k = 0; k < D; ++k) x[k][l] = op == 2 ? 0u : a[k][l];
  }
  // where x < y add p back; the carry out of the top cancels the wrap
  const uint32_t borrow = sub_digits<G>(s, x, b);
  load_p<G>(p);
  FQ_LANES(l, G) {
#pragma unroll
    for (int k = 0; k < D; ++k) r[k][l] = s[k][l] + (borrow ? p[k][l] : 0u);
  }
  settle<G>(r);
}

// K3's body: the Montgomery product r = a b / 2^384 mod p, operand-scanning
// over the 16 digits of b. Each lane keeps its D digits of the running sum
// as 64-bit accumulators, not carried: a row adds a b_i and m p (each
// product below 2^48) to every digit, and a digit takes at most 16 rows of
// them and a 30-bit carry, so it stays below 2^54. Per row the group
// exchanges b_i (from its lane) and m = t_0 (-p^-1) mod 2^24 (from lane 0,
// whose lowest digit no carry reaches); then, to divide by 2^24, every
// digit moves one place down: a lane's lowest digit keeps its bits above 24
// as the carry into its next digit and passes its low 24 bits to the lane
// below (lane 0's are zero). The carries are resolved once, after the last
// row: two passes of carry words to the next lane, then one carry-lookahead
// (settle). The sum stays below 2p, so one conditional subtraction ends it.
template <int G>
FQ_GD void mont_mul(Lanes<uint32_t, G> r[kDigits / G], const Lanes<uint32_t, G> a[kDigits / G],
                    const Lanes<uint32_t, G> b[kDigits / G]) {
  constexpr int D = kDigits / G;
  Lanes<uint32_t, G> p[D];
  Lanes<uint64_t, G> t[D];
  load_p<G>(p);
  FQ_LANES(l, G) {
#pragma unroll
    for (int k = 0; k < D; ++k) t[k][l] = 0;
  }
#pragma unroll
  for (int i = 0; i < kDigits; ++i) {
    const Lanes<uint32_t, G> bi = broadcast<G>(b[i % D], i / D);
    Lanes<uint32_t, G> m0;
    FQ_LANES(l, G) {
#pragma unroll
      for (int k = 0; k < D; ++k) t[k][l] = mad_wide(a[k][l], bi[l], t[k][l]);
      m0[l] = ((uint32_t)t[0][l] * kN0Digit) & kDigitMask;
    }
    const Lanes<uint32_t, G> m = broadcast<G>(m0, 0);
    Lanes<uint32_t, G> down;
    FQ_LANES(l, G) {
#pragma unroll
      for (int k = 0; k < D; ++k) t[k][l] = mad_wide(m[l], p[k][l], t[k][l]);
      down[l] = (uint32_t)t[0][l] & kDigitMask;  // 0 on lane 0: t_0 + m p_0 is a multiple of 2^24
    }
    down = from_next<G>(down);
    FQ_LANES(l, G) {
      const uint64_t carry = t[0][l] >> kDigitBits;
#pragma unroll
      for (int k = 0; k + 1 < D; ++k) t[k][l] = t[k + 1][l];
      t[D - 1][l] = down[l];
      t[0][l] += carry;
    }
  }
  // carry: each digit keeps 24 bits and passes the rest (< 2^30) one digit up
  Lanes<uint32_t, G> d[D], c;
  FQ_LANES(l, G) {
#pragma unroll
    for (int k = 0; k < D; ++k) d[k][l] = (uint32_t)t[k][l] & kDigitMask;
#pragma unroll
    for (int k = 1; k < D; ++k) d[k][l] += (uint32_t)(t[k - 1][l] >> kDigitBits);
    c[l] = (uint32_t)(t[D - 1][l] >> kDigitBits);
  }
  c = from_prev<G>(c);  // the top lane's carry is 0: the sum is below 2p < 2^382
  // each digit is now below 2^31: ripple inside the lane, pass the carry (< 2^8) up
  FQ_LANES(l, G) {
    uint32_t carry = c[l];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const uint32_t v = d[k][l] + carry;
      d[k][l] = v & kDigitMask;
      carry = v >> kDigitBits;
    }
    c[l] = carry;
  }
  c = from_prev<G>(c);
  FQ_LANES(l, G) d[0][l] += c[l];  // below 2^24 + 2^8: one carry-lookahead settles it
  settle<G>(d);
  cond_sub_p<G>(r, d);
}

// Every function below writes its result only after its last read of an
// operand, so r may alias a or b.

// The exponent of a pow chain, public and the same for every thread: bit i
// of the integer is bit i % 32 of words[i / 32]; bits is its length,
// leading zeros included (each costs a squaring of 1).
struct Exponent {
  uint32_t words[kWords];
  int bits;
};

// R mod p (1 in Montgomery form) in 24-bit digits
#if defined(__CUDACC__)
__constant__
#else
constexpr
#endif
    uint32_t kOneDigits[kDigits] = {0x02fffdu, 0x000000u, 0x027609u, 0xc40c00u, 0xf4000bu, 0x58baebu,
                                    0x5753c7u, 0x5f4898u, 0x525745u, 0x585370u, 0x6d77ceu, 0xa256ecu,
                                    0x071a97u, 0xe4935cu, 0xc3fa80u, 0x15f65eu};

template <int G>
FQ_GD void load_one(Lanes<uint32_t, G> r[kDigits / G]) {
  constexpr int D = kDigits / G;
  FQ_LANES(l, G) {
#pragma unroll
    for (int k = 0; k < D; ++k) r[k][l] = kOneDigits[D * l + k];
  }
}

FQ_HD bool exponent_bit(const Exponent& e, int i) { return (e.words[i / 32] >> (i % 32)) & 1u; }

// K5's body: r = a^e in Montgomery form, square-and-multiply over e's bits
// from the most significant, the product with a only at a set bit. The
// exponent is uniform, so the branch is too (the JAX package selected with
// jnp.where; both give the canonical residue). 0 maps to 0.
template <int G>
FQ_GD void pow(Lanes<uint32_t, G> r[kDigits / G], const Lanes<uint32_t, G> a[kDigits / G], const Exponent& e) {
  load_one<G>(r);
  for (int i = e.bits - 1; i >= 0; --i) {
    mont_mul<G>(r, r, r);
    if (exponent_bit(e, i)) mont_mul<G>(r, r, a);
  }
}

// Fq2 = Fq[u] / (u^2 + 1) on one group: x[0] + x[1] u, each half on the
// same G lanes, the products run one after another.

// (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u: 2 products, 3 sums
template <int G>
FQ_GD void fq2_square(Lanes<uint32_t, G> r[2][kDigits / G], const Lanes<uint32_t, G> a[2][kDigits / G]) {
  constexpr int D = kDigits / G;
  Lanes<uint32_t, G> s[D], d[D], t[D];
  addsub<G>(s, a[0], a[1], 0);
  addsub<G>(d, a[0], a[1], 1);
  addsub<G>(t, a[0], a[0], 0);
  mont_mul<G>(r[1], t, a[1]);
  mont_mul<G>(r[0], s, d);
}

// Karatsuba: a0 b0 - a1 b1 + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) u: 3
// products, 5 sums
template <int G>
FQ_GD void fq2_mul(Lanes<uint32_t, G> r[2][kDigits / G], const Lanes<uint32_t, G> a[2][kDigits / G],
                   const Lanes<uint32_t, G> b[2][kDigits / G]) {
  constexpr int D = kDigits / G;
  Lanes<uint32_t, G> t0[D], t1[D], sa[D], sb[D], t2[D];
  mont_mul<G>(t0, a[0], b[0]);
  mont_mul<G>(t1, a[1], b[1]);
  addsub<G>(sa, a[0], a[1], 0);
  addsub<G>(sb, b[0], b[1], 0);
  mont_mul<G>(t2, sa, sb);
  addsub<G>(r[0], t0, t1, 1);
  addsub<G>(t2, t2, t0, 1);
  addsub<G>(r[1], t2, t1, 1);
}

// K6's body: r = a^e in Fq2, the walk of pow from (1, 0)
template <int G>
FQ_GD void fq2_pow(Lanes<uint32_t, G> r[2][kDigits / G], const Lanes<uint32_t, G> a[2][kDigits / G],
                   const Exponent& e) {
  constexpr int D = kDigits / G;
  load_one<G>(r[0]);
  FQ_LANES(l, G) {
#pragma unroll
    for (int k = 0; k < D; ++k) r[1][k][l] = 0u;
  }
  for (int i = e.bits - 1; i >= 0; --i) {
    fq2_square<G>(r, r);
    if (exponent_bit(e, i)) fq2_mul<G>(r, r, a);
  }
}

#if defined(__CUDACC__)
// lane l's digits D l .. D l + D - 1 of the element at src (the tensor
// layout's limbs 2 D l .. 2 D l + 2 D - 1): its D / 2 int4s
template <int G>
__device__ __forceinline__ void load_digits(Lanes<uint32_t, G> d[kDigits / G], const int32_t* src, int l) {
  constexpr int D = kDigits / G;
  const int4* v = reinterpret_cast<const int4*>(src + 2 * D * l);
#pragma unroll
  for (int q = 0; q < D / 2; ++q) {
    const int4 w = v[q];
    d[2 * q].v = (uint32_t)w.x | ((uint32_t)w.y << 12);
    d[2 * q + 1].v = (uint32_t)w.z | ((uint32_t)w.w << 12);
  }
}

template <int G>
__device__ __forceinline__ void store_digits(int32_t* dst, const Lanes<uint32_t, G> d[kDigits / G], int l) {
  constexpr int D = kDigits / G;
  int4* v = reinterpret_cast<int4*>(dst + 2 * D * l);
#pragma unroll
  for (int q = 0; q < D / 2; ++q) {
    const uint32_t lo = d[2 * q].v, hi = d[2 * q + 1].v;
    v[q] = make_int4((int)(lo & 0xfffu), (int)(lo >> 12), (int)(hi & 0xfffu), (int)(hi >> 12));
  }
}
#endif

}  // namespace lanes

}  // namespace fq
