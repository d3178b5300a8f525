// BLS12-381 base-field arithmetic: the device functions of the K3 (fq_mul)
// and K4 (fq_addsub) kernels of fq.cu and of the pow chains K5 (fq_pow) and
// K6 (fq2_pow) of fq_pow.cu and the ladders of curve.cuh, kept in a header
// so that later fused kernels (the Miller loop, the final exponentiation)
// can build on the same code: the batches (sums, mont_mul_n, fq2_products)
// are what a fused tower kernel needs.
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
// Every function takes and returns values below p, but for the lazy sums
// (kLazyAdd, below 2p), which only Montgomery products take. The header
// compiles as plain C++ too (without nvcc the qualifiers fall away, and a
// group's lanes run in lockstep over arrays), so its arithmetic can be
// checked by a host compiler against the plain PyTorch version.
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
// Inversion by binary GCD (K9's body): Bernstein and Yang's divsteps
// ("Fast constant-time gcd computation and modular inversion", IACR ePrint
// 2019/266), in the layout of libsecp256k1's modinv32: signed 30-bit limbs,
// 30 divsteps a round on the low words of f and g alone, collected in a 2x2
// transition matrix t with (f', g') = t (f, g) / 2^30, then applied to the
// whole of f and g and, modulo p, to the coefficients d and e. Each round
// divides d and e by 2^30 modulo p (the matrix's low bits choose the
// multiple of p that clears them), so the invariants f s = d x and
// g s = e x (mod p) hold from the start (f = p, g = x, d = 0, e = s) to the
// end, where g = 0 and f = +-1: d = +-s / x. The iteration count is fixed
// and every step is branch-free, so the threads of a warp never diverge.
//
// The count: BY's Theorem 11.2 (their `iterations(d)`) bounds the divsteps
// that take g to 0 by floor((49 d + 57) / 17) for d-bit inputs, d >= 46:
// here f = p and g = x < p, d = 381, so 1,101. kInvRounds rounds of 30
// run 1,110. A divstep past that leaves g = 0, f unchanged and d the same
// modulo p, so running past the bound is harmless.
constexpr int kInvLimbs = 13;  // 13 x 30 = 390 bits; the top limb is signed
constexpr int kInvRounds = 37;
constexpr int32_t kM30 = 0x3fffffff;

// bits 30 i .. 30 i + 29 of p (the top limb takes the rest)
FQ_HD constexpr int32_t p_limb30(int i) {
  return (int32_t)((((uint64_t)(30 * i / 32 + 1 < kWords ? p_word(30 * i / 32 + 1) : 0u) << 32 |
                     p_word(30 * i / 32)) >> (30 * i % 32)) & (i + 1 < kInvLimbs ? (uint64_t)kM30 : ~0ull));
}

// x^-1 mod 2^32 for odd x (Newton's iteration: each step doubles the bits)
FQ_HD constexpr uint32_t inv_mod_2_32(uint32_t x) {
  uint32_t y = x;  // right mod 2^3: x x = 1 mod 8 for odd x
  for (int k = 0; k < 4; ++k) y *= 2u - x * y;
  return y;
}

constexpr uint32_t kPInv30 = inv_mod_2_32(0xffffaaabu) & (uint32_t)kM30;  // p^-1 mod 2^30

// s in 30-bit limbs: K9's start value of e, passed by the wrapper
struct InvStart {
  int32_t v[kInvLimbs];
};

// the divsteps' 2x2 matrix, entries times 2^30: |u| + |v|, |q| + |r| <= 2^30
struct Trans {
  int32_t u, v, q, r;
};

// 30 divsteps on the low 32 bits of f and g (exact for 30 steps: each
// step looks only at g's lowest bit, then halves g). zeta = -delta. A step:
// if delta > 0 and g is odd, (delta, f, g) <- (1 - delta, g, (g - f) / 2);
// else (delta, f, g) <- (1 + delta, f, (g + (g mod 2) f) / 2).
FQ_HD int32_t divsteps30(int32_t zeta, uint32_t f, uint32_t g, Trans& t) {
  int32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
  for (int i = 0; i < 30; ++i) {
    const int32_t c1 = zeta >> 31;             // all ones where delta > 0
    const int32_t c2 = -(int32_t)(g & 1u);     // all ones where g is odd
    const uint32_t x = (f ^ (uint32_t)c1) - (uint32_t)c1;  // -f or f
    const int32_t y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & (uint32_t)c2;
    q += y & c2;
    r += z & c2;
    const int32_t c = c1 & c2;                 // the swap: f takes the old g
    zeta = (zeta ^ c) - 1 - c;
    f += g & (uint32_t)c;
    u += q & c;
    v += r & c;
    g >>= 1;
    u *= 2;
    v *= 2;
  }
  t = {u, v, q, r};
  return zeta;
}

// (f, g) <- t (f, g) / 2^30, exact (the low 30 bits of both sums are 0)
FQ_HD void update_fg30(int32_t f[kInvLimbs], int32_t g[kInvLimbs], const Trans& t) {
  int64_t cf = (int64_t)t.u * f[0] + (int64_t)t.v * g[0];
  int64_t cg = (int64_t)t.q * f[0] + (int64_t)t.r * g[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < kInvLimbs; ++i) {
    cf += (int64_t)t.u * f[i] + (int64_t)t.v * g[i];
    cg += (int64_t)t.q * f[i] + (int64_t)t.r * g[i];
    f[i - 1] = (int32_t)cf & kM30;
    g[i - 1] = (int32_t)cg & kM30;
    cf >>= 30;
    cg >>= 30;
  }
  f[kInvLimbs - 1] = (int32_t)cf;
  g[kInvLimbs - 1] = (int32_t)cg;
}

// (d, e) <- (t (d, e) + p (md, me)) / 2^30, md and me chosen to clear the
// low 30 bits; d and e stay in (-2p, p) (libsecp256k1 modinv32's
// update_de_30: md and me start at the column sums of t where d or e is
// negative)
FQ_HD void update_de30(int32_t d[kInvLimbs], int32_t e[kInvLimbs], const Trans& t) {
  const int32_t sd = d[kInvLimbs - 1] >> 31, se = e[kInvLimbs - 1] >> 31;
  int32_t md = (t.u & sd) + (t.v & se), me = (t.q & sd) + (t.r & se);
  int64_t cd = (int64_t)t.u * d[0] + (int64_t)t.v * e[0];
  int64_t ce = (int64_t)t.q * d[0] + (int64_t)t.r * e[0];
  md -= (int32_t)((kPInv30 * (uint32_t)cd + (uint32_t)md) & (uint32_t)kM30);
  me -= (int32_t)((kPInv30 * (uint32_t)ce + (uint32_t)me) & (uint32_t)kM30);
  cd += (int64_t)p_limb30(0) * md;
  ce += (int64_t)p_limb30(0) * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < kInvLimbs; ++i) {
    cd += (int64_t)t.u * d[i] + (int64_t)t.v * e[i] + (int64_t)p_limb30(i) * md;
    ce += (int64_t)t.q * d[i] + (int64_t)t.r * e[i] + (int64_t)p_limb30(i) * me;
    d[i - 1] = (int32_t)cd & kM30;
    e[i - 1] = (int32_t)ce & kM30;
    cd >>= 30;
    ce >>= 30;
  }
  d[kInvLimbs - 1] = (int32_t)cd;
  e[kInvLimbs - 1] = (int32_t)ce;
}

// carry every limb's bits above 30 into the next (limbs in (-2^31, 2^31))
FQ_HD void carry30(int32_t r[kInvLimbs]) {
#pragma unroll
  for (int i = 0; i + 1 < kInvLimbs; ++i) {
    r[i + 1] += r[i] >> 30;
    r[i] &= kM30;
  }
}

// r in (-2p, p) -> sign r mod p in [0, p), sign the top limb of +-1
// (libsecp256k1 modinv32's normalize_30)
FQ_HD void normalize30(int32_t r[kInvLimbs], int32_t sign) {
  int32_t add = r[kInvLimbs - 1] >> 31;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < kInvLimbs; ++i) r[i] = ((r[i] + (p_limb30(i) & add)) ^ neg) - neg;  // (-p, p)
  carry30(r);
  add = r[kInvLimbs - 1] >> 31;
#pragma unroll
  for (int i = 0; i < kInvLimbs; ++i) r[i] += p_limb30(i) & add;  // [0, p)
  carry30(r);
}

// K9's body: out = s / x mod p (0 for x = 0) on the port's limb layout,
// 32 canonical 12-bit limbs in and out; every 5 limbs (60 bits) are two
// 30-bit limbs. With x = a R (Montgomery form) and s = R^2 mod p, out is
// a^-1 R, the Montgomery form of the inverse: the Montgomery product by
// R^3 mod p that would correct s = 1's result rides in e's start value.
FQ_HD void inv(uint32_t out[kLimbs], const uint32_t x[kLimbs], const InvStart& s) {
  int32_t f[kInvLimbs], g[kInvLimbs], d[kInvLimbs], e[kInvLimbs];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const uint32_t* l = x + 5 * k;
    g[2 * k] = (int32_t)(l[0] | l[1] << 12 | (l[2] & 0x3fu) << 24);
    g[2 * k + 1] = (int32_t)(l[2] >> 6 | l[3] << 6 | l[4] << 18);
  }
  g[12] = (int32_t)(x[30] | x[31] << 12);
#pragma unroll
  for (int i = 0; i < kInvLimbs; ++i) {
    f[i] = p_limb30(i);
    d[i] = 0;
    e[i] = s.v[i];
  }
  int32_t zeta = -1;  // delta = 1
#pragma unroll 1
  for (int round = 0; round < kInvRounds; ++round) {
    Trans t;
    zeta = divsteps30(zeta, (uint32_t)f[0] | (uint32_t)f[1] << 30, (uint32_t)g[0] | (uint32_t)g[1] << 30, t);
    update_fg30(f, g, t);
    update_de30(d, e, t);
  }
  normalize30(d, f[kInvLimbs - 1]);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    uint32_t* l = out + 5 * k;
    const uint32_t lo = (uint32_t)d[2 * k], hi = (uint32_t)d[2 * k + 1];
    l[0] = lo & 0xfffu;
    l[1] = (lo >> 12) & 0xfffu;
    l[2] = lo >> 24 | (hi & 0x3fu) << 6;
    l[3] = (hi >> 6) & 0xfffu;
    l[4] = hi >> 18;
  }
  out[30] = (uint32_t)d[12] & 0xfffu;
  out[31] = (uint32_t)d[12] >> 12;
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

// ---------------------------------------------------------------------------
// Batches: M independent Fq values on one group, each step of their chains
// issued for all M before the next step of any. A warp issues in order, so
// one value's chain alone leaves it waiting on every exchange; with M
// values the other chains' arithmetic issues while an exchange is in
// flight. At a flush's sizes (130-260 elements, a few warps on the card)
// the card is idle but for those warps: a small batch costs little more
// than one of its values, a large one as much as its warp can issue (see
// mont_mul_split). x[j][k] below is digit k (of the running lane) of
// value j.

// A batch's slot kinds (a Carry or a Sum, below) as one template
// argument, 2 bits a slot, slot j at bits 2 j: in the unrolled code each
// slot's kind is then a constant, and its branches fold away.
using Kinds = unsigned long long;

FQ_HD constexpr unsigned kind(Kinds k, int j) { return (unsigned)(k >> (2 * j)) & 3u; }

// the kinds t... of slots 0, 1, ...
template <class... T>
FQ_HD constexpr Kinds kinds(T... t) {
  Kinds k = 0;
  int j = 0;
  ((k |= (Kinds)(unsigned)t << (2 * j++)), ...);
  return k;
}

// the kind v in each of m slots
FQ_HD constexpr Kinds uniform(unsigned v, int m) {
  Kinds k = 0;
  for (int j = 0; j < m; ++j) k |= (Kinds)v << (2 * j);
  return k;
}

// One carry round over M values: slot j gets x_j + y_j (kind kCarryAdd;
// each digit sum at most 2^25 - 2) or x_j - y_j (kCarrySub) mod 2^384 in
// canonical digits, and out[j] the carry (the borrow) out of the top; a
// kCarryNone slot is skipped. All slots share one round of ballots.
enum Carry : unsigned { kCarryAdd, kCarrySub, kCarryNone };

template <int G, int M, Kinds Modes>
FQ_GD void carry_round(Lanes<uint32_t, G> r[M][kDigits / G], const Lanes<uint32_t, G> x[M][kDigits / G],
                       const Lanes<uint32_t, G> y[M][kDigits / G], uint32_t (&out)[M]) {
  constexpr int D = kDigits / G;
  Lanes<bool, G> gen[M], prop[M];
  FQ_LANES(l, G) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (kind(Modes, j) == kCarryNone) continue;
      const bool sub = kind(Modes, j) == kCarrySub;
      uint32_t c = 0;
      bool same = true;  // the lane passes a carry (borrow) in through: all ones (x == y)
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const uint32_t v = sub ? x[j][k][l] - y[j][k][l] - c : x[j][k][l] + y[j][k][l] + c;
        c = sub ? v >> 31 : v >> kDigitBits;
        same = same && (v & kDigitMask) == (sub ? 0u : kDigitMask);
      }
      gen[j][l] = c != 0;
      prop[j][l] = same;
    }
  }
  uint32_t carries[M];
#pragma unroll
  for (int j = 0; j < M; ++j)
    carries[j] = kind(Modes, j) == kCarryNone ? 0u : lookahead(group_ballot<G>(gen[j]), group_ballot<G>(prop[j]));
  FQ_LANES(l, G) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (kind(Modes, j) == kCarryNone) continue;
      const bool sub = kind(Modes, j) == kCarrySub;
      uint32_t c = (carries[j] >> l) & 1u;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const uint32_t v = sub ? x[j][k][l] - y[j][k][l] - c : x[j][k][l] + y[j][k][l] + c;
        r[j][k][l] = v & kDigitMask;
        c = sub ? v >> 31 : v >> kDigitBits;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) out[j] = (carries[j] >> G) & 1u;
}

// The sum of a batch slot, on canonical operands (below p):
// - kAdd: (a + b) mod p and kSub: (a - b) mod p, canonical; two carry
//   rounds (the sum or difference, then the subtraction or addition of p);
// - kLazyAdd: a + b unreduced, below 2p, in canonical digits; one carry
//   round. Only for a value whose every consumer is a Montgomery product
//   (mont_mul_n): with both factors below 2p the product's running sum
//   stays below (a b + m p) / R < 4 p^2 / R + p < 2p, since 4p < R = 2^384,
//   so its one conditional subtraction still ends it canonical. Nothing
//   masked, selected, stored or summed again takes it.
// A lazy a - b = a + (p - b) would take the same two carry rounds as kSub
// here (p - b borrows across lanes), so a difference is always kSub.
enum Sum : unsigned { kAdd, kSub, kLazyAdd };

// The carry rounds of a sums() batch: the sum or difference, then the
// subtraction of p (kAdd), its addition (kSub) or nothing (kLazyAdd)
FQ_HD constexpr Kinds first_round(Kinds ops, int m) {
  Kinds k = 0;
  for (int j = 0; j < m; ++j) k |= (Kinds)(kind(ops, j) == kSub ? kCarrySub : kCarryAdd) << (2 * j);
  return k;
}

FQ_HD constexpr Kinds second_round(Kinds ops, int m) {
  Kinds k = 0;
  for (int j = 0; j < m; ++j)
    k |= (Kinds)(kind(ops, j) == kAdd ? kCarrySub : kind(ops, j) == kSub ? kCarryAdd : kCarryNone) << (2 * j);
  return k;
}

// r_j = a_j op_j b_j for the M slots (Ops: their Sum kinds), every slot's
// carry rounds together; r may alias a or b.
template <int G, int M, Kinds Ops>
FQ_GD void sums(Lanes<uint32_t, G> r[M][kDigits / G], const Lanes<uint32_t, G> a[M][kDigits / G],
                const Lanes<uint32_t, G> b[M][kDigits / G]) {
  constexpr int D = kDigits / G;
  Lanes<uint32_t, G> p[D], s[M][D], y[M][D], t[M][D];
  uint32_t c1[M], c2[M];
  carry_round<G, M, first_round(Ops, M)>(s, a, b, c1);  // a + b < 2p < 2^382: no carry out
  // kAdd: s - p, kept where it does not borrow; kSub: s + p where a < b
  // (the carry out of the top cancels the wrap)
  load_p<G>(p);
  FQ_LANES(l, G) {
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int k = 0; k < D; ++k) y[j][k][l] = kind(Ops, j) == kAdd || c1[j] ? p[k][l] : 0u;
  }
  carry_round<G, M, second_round(Ops, M)>(t, s, y, c2);
  FQ_LANES(l, G) {
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int k = 0; k < D; ++k)
        r[j][k][l] = kind(Ops, j) == kLazyAdd || (kind(Ops, j) == kAdd && c2[j]) ? s[j][k][l] : t[j][k][l];
  }
}

// M independent Montgomery products r_j = a_j b_j / 2^384 mod p, mont_mul's
// algorithm with the rows of all M interleaved: row i of every product
// issues before row i + 1 of any, so each row's two dependent exchanges (m
// from lane 0, the shift from the next lane) overlap the other products'
// multiply-adds. Each product keeps mont_mul's digit bounds and its final
// carries and conditional subtraction, so with a_j b_j < p R (both below
// 2p, see kLazyAdd) each r_j is canonical. r may alias a or b.
//
// One option, Chain, for a lone product in a dependent chain (K5's):
// - the G lanes' turns of rows are unrolled too, so that the compiler
//   issues every broadcast of b's digits ahead of the row that takes it;
// - the result is left below 2p, after the two passes of carries
//   between lanes, without the carry-lookahead (settle) and the conditional
//   subtraction: its digits are canonical but for each lane's lowest, below
//   2^24 + 2^8. Only a product takes such a value: with digits below
//   2^24 + 2^8 a row adds below 2^49 to a digit, so the running sum's
//   digits stay below 2^54 as with canonical operands, and the value bound
//   above holds. The chain settles and subtracts once, at its end.
template <int G, int M, bool Chain = false>
FQ_GD void mont_mul_n(Lanes<uint32_t, G> r[M][kDigits / G], const Lanes<uint32_t, G> a[M][kDigits / G],
                      const Lanes<uint32_t, G> b[M][kDigits / G]) {
  constexpr int D = kDigits / G;
  Lanes<uint32_t, G> p[D];
  Lanes<uint64_t, G> t[M][D];
  load_p<G>(p);
  FQ_LANES(l, G) {
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int k = 0; k < D; ++k) t[j][k][l] = 0;
  }
  // row i of lane `from`'s digits of b
  auto row = [&](int from, int i) {
    Lanes<uint32_t, G> bi[M], m0[M], m[M], down[M];
#pragma unroll
    for (int j = 0; j < M; ++j) bi[j] = broadcast<G>(b[j][i], from);
    FQ_LANES(l, G) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
#pragma unroll
        for (int k = 0; k < D; ++k) t[j][k][l] = mad_wide(a[j][k][l], bi[j][l], t[j][k][l]);
        m0[j][l] = ((uint32_t)t[j][0][l] * kN0Digit) & kDigitMask;
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) m[j] = broadcast<G>(m0[j], 0);
    FQ_LANES(l, G) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
#pragma unroll
        for (int k = 0; k < D; ++k) t[j][k][l] = mad_wide(m[j][l], p[k][l], t[j][k][l]);
        down[j][l] = (uint32_t)t[j][0][l] & kDigitMask;  // 0 on lane 0
      }
    }
#pragma unroll
    for (int j = 0; j < M; ++j) down[j] = from_next<G>(down[j]);
    FQ_LANES(l, G) {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const uint64_t carry = t[j][0][l] >> kDigitBits;
#pragma unroll
        for (int k = 0; k + 1 < D; ++k) t[j][k][l] = t[j][k + 1][l];
        t[j][D - 1][l] = down[j][l];
        t[j][0][l] += carry;
      }
    }
  };
  if constexpr (Chain) {
#pragma unroll
    for (int from = 0; from < G; ++from)
#pragma unroll
      for (int i = 0; i < D; ++i) row(from, i);
  } else {
    // the rows of a lane's D digits of b unrolled, the G lanes' turns not:
    // the code of a batch stays small enough for the instruction cache
#pragma unroll 1
    for (int from = 0; from < G; ++from)
#pragma unroll
      for (int i = 0; i < D; ++i) row(from, i);
  }
  // the carries as in mont_mul, every product's step together
  Lanes<uint32_t, G> d[M][D], c[M], q[M][D], zero[M][D], pp[M][D];
  FQ_LANES(l, G) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
#pragma unroll
      for (int k = 0; k < D; ++k) d[j][k][l] = (uint32_t)t[j][k][l] & kDigitMask;
#pragma unroll
      for (int k = 1; k < D; ++k) d[j][k][l] += (uint32_t)(t[j][k - 1][l] >> kDigitBits);
      c[j][l] = (uint32_t)(t[j][D - 1][l] >> kDigitBits);
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) c[j] = from_prev<G>(c[j]);
  FQ_LANES(l, G) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      uint32_t carry = c[j][l];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const uint32_t v = d[j][k][l] + carry;
        d[j][k][l] = v & kDigitMask;
        carry = v >> kDigitBits;
      }
      c[j][l] = carry;
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) c[j] = from_prev<G>(c[j]);
  uint32_t top[M], below[M];
  FQ_LANES(l, G) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      d[j][0][l] += c[j][l];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        zero[j][k][l] = 0u;
        pp[j][k][l] = p[k][l];
      }
    }
  }
  if constexpr (Chain) {
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int k = 0; k < D; ++k) r[j][k] = d[j][k];
    return;
  }
  carry_round<G, M, uniform(kCarryAdd, M)>(d, d, zero, top);  // settle: the sum is below 2p, top is 0
  carry_round<G, M, uniform(kCarrySub, M)>(q, d, pp, below);  // the conditional subtraction of p
  FQ_LANES(l, G) {
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int k = 0; k < D; ++k) r[j][k][l] = below[j] ? d[j][k][l] : q[j][k][l];
  }
}

// Where a split batch (mont_mul_split) lies, for the lane of a block with
// index `lane`: its subgroup; whether subgroup s runs slot t H + j as its
// j-th product (t > 0: subgroup 0 runs slot j, and so does a subgroup with
// no slot t H + j, a product computed and not read); and the lane of the S
// G lanes from which the lane at `place` in its group takes subgroup t's
// results. The slot is chosen by comparing s with each constant t, so that
// on the card every operand is indexed by a constant and stays in
// registers: an index the compiler can equate with s puts the operands on
// the stack (ptxas then reports a stack frame for K6 and K8).
template <int G, int S>
FQ_HD constexpr int split_group(unsigned lane) { return (int)(lane / G % S); }

template <int M, int S>
FQ_HD constexpr bool split_runs(int s, int t, int j) { return t * ((M + S - 1) / S) + j < M && s == t; }

template <int G>
FQ_HD constexpr int split_source(int place, int t) { return place + t * G; }

// A batch of M products split over S subgroups of G lanes of a warp that
// hold the same values (an element on S G lanes): subgroup s runs products
// s H .. s H + H - 1 (H = ceil(M / S)) as one mont_mul_n, then every lane
// takes the others' results from the lane of its place in their subgroups
// by a shuffle. The warp issues the work of H products, not M: at a
// flush's sizes, a few warps on an idle card, a large batch on one group
// waits on its warp's issue (K8's 7-11-product batches ran 1.4x faster
// split in two, PERF.md). The host build runs the subgroups one after
// another, then hands each lane of an element's S G lanes (those of a
// block's second element, where the subgroup index wraps) what the
// shuffle hands it, through the same split_* arithmetic; a lane whose
// results differ from those of its place in subgroup 0 counts in
// lane_faults. r may alias a or b.
template <int G, int S, int M>
FQ_GD void mont_mul_split(Lanes<uint32_t, G> r[M][kDigits / G], const Lanes<uint32_t, G> a[M][kDigits / G],
                          const Lanes<uint32_t, G> b[M][kDigits / G]) {
  constexpr int D = kDigits / G, H = (M + S - 1) / S;
  if constexpr (S == 1) {
    mont_mul_n<G, M>(r, a, b);
  } else {
#if defined(__CUDACC__)
    Lanes<uint32_t, G> x[H][D], y[H][D], z[H][D];
    const int s = split_group<G, S>(threadIdx.x);
#pragma unroll
    for (int j = 0; j < H; ++j)
#pragma unroll
      for (int k = 0; k < D; ++k) {
        x[j][k] = a[j][k];
        y[j][k] = b[j][k];
#pragma unroll
        for (int t = 1; t < S; ++t)
          if (split_runs<M, S>(s, t, j)) x[j][k] = a[t * H + j][k], y[j][k] = b[t * H + j][k];
      }
    mont_mul_n<G, H>(z, x, y);
    const int place = (int)(threadIdx.x % G);
#pragma unroll
    for (int t = 0; t < S; ++t)
#pragma unroll
      for (int j = 0; j < H; ++j)
        if (t * H + j < M)
#pragma unroll
          for (int k = 0; k < D; ++k)
            r[t * H + j][k].v = __shfl_sync(0xffffffffu, z[j][k].v, split_source<G>(place, t), G * S);
#else
    Lanes<uint32_t, G> x[H][D], y[H][D], z[S][H][D];
    for (int s = 0; s < S; ++s) {
      for (int j = 0; j < H; ++j)
        for (int k = 0; k < D; ++k) {
          x[j][k] = a[j][k];
          y[j][k] = b[j][k];
          for (int t = 1; t < S; ++t)
            if (split_runs<M, S>(s, t, j)) x[j][k] = a[t * H + j][k], y[j][k] = b[t * H + j][k];
        }
      mont_mul_n<G, H>(z[s], x, y);
    }
    const int first = G * S;  // the block's second element
    for (int w = 0; w < G * S; ++w) {
      const int place = (first + w) % G;
      for (int t = 0; t < S; ++t)
        for (int j = 0; j < H; ++j) {
          if (t * H + j >= M) continue;
          const int src = first + split_source<G>(place, t) % (G * S);  // __shfl_sync's lane in its G S lanes
          const int from = split_group<G, S>((unsigned)src);
          for (int k = 0; k < D; ++k) {
            const uint32_t v = from >= 0 && from < S ? z[from][j][k].v[src % G] : ~0u;
            if (w < G)
              r[t * H + j][k].v[place] = v;
            else if (r[t * H + j][k].v[place] != v)
              ++lane_faults;
          }
        }
    }
#endif
  }
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

FQ_HD constexpr int count_bits(unsigned x) {
  int n = 0;
  for (; x; x >>= 1) n += (int)(x & 1u);
  return n;
}

// the leading sums of fq2_products' squares: a0 + a1, a0 - a1, 2 a0 each
FQ_HD constexpr Kinds fq2_square_sums(int squares) {
  Kinds k = 0;
  for (int s = 0; s < squares; ++s)
    k |= (Kinds)kLazyAdd << (6 * s) | (Kinds)kSub << (6 * s + 2) | (Kinds)kLazyAdd << (6 * s + 4);
  return k;
}

// the trailing sums of its products: a0 b0 - a1 b1, a0 b1 + a1 b0 each
FQ_HD constexpr Kinds fq2_product_sums(int products) {
  Kinds k = 0;
  for (int s = 0; s < products; ++s) k |= (Kinds)kSub << (4 * s) | (Kinds)kAdd << (4 * s + 2);
  return k;
}

// Fq2 = Fq[u] / (u^2 + 1) on one group: x[0] + x[1] u, each half on the
// same G lanes. M independent Fq2 products r_j = a_j b_j run as one batch;
// slot j is a square where bit j of Squares is set (b_j is then not read):
//   (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + (2 a0) a1 u: 2 Fq products after
//   one batch of leading sums (a0 + a1 and 2 a0 lazy: they feed only
//   products);
//   (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u: 4 Fq
//   products, then one batch of trailing sums. Karatsuba's 3 products
//   would take 3 more carry rounds (a leading batch and a second trailing
//   one), and with the products split over 2 subgroups a fourth costs no
//   more than a third.
// Every slot's sums of one kind run as one sums() batch, every slot's Fq
// products as one batch split over S subgroups (mont_mul_split). Operands
// canonical, results canonical; r may alias a or b.
template <int G, int M, unsigned Squares, int S>
FQ_GD void fq2_products(Lanes<uint32_t, G> r[M][2][kDigits / G], const Lanes<uint32_t, G> a[M][2][kDigits / G],
                        const Lanes<uint32_t, G> b[M][2][kDigits / G]) {
  constexpr int D = kDigits / G;
  constexpr int kSquares = count_bits(Squares & ((1u << M) - 1u)), kMuls = M - kSquares;
  constexpr int kPre = kSquares > 0 ? 3 * kSquares : 1, kPost = kMuls > 0 ? 2 * kMuls : 1;
  constexpr int kProducts = 2 * kSquares + 4 * kMuls;
  // a square's a0 + a1, a0 - a1, 2 a0
  Lanes<uint32_t, G> pa[kPre][D], pb[kPre][D], ps[kPre][D];
  if constexpr (kSquares > 0) {
    int s = 0;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if (!((Squares >> j) & 1u)) continue;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        pa[s][k] = pa[s + 1][k] = pa[s + 2][k] = pb[s + 2][k] = a[j][0][k];
        pb[s][k] = pb[s + 1][k] = a[j][1][k];
      }
      s += 3;
    }
    sums<G, 3 * kSquares, fq2_square_sums(kSquares)>(ps, pa, pb);
  }
  // the products: a square's (2 a0) a1, (a0 + a1)(a0 - a1); a product's
  // a0 b0, a1 b1, a0 b1, a1 b0
  Lanes<uint32_t, G> ma[kProducts][D], mb[kProducts][D], mr[kProducts][D];
  int s = 0, q = 0;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const bool square = (Squares >> j) & 1u;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (square) {
        ma[q][k] = ps[s + 2][k];
        mb[q][k] = a[j][1][k];
        ma[q + 1][k] = ps[s][k];
        mb[q + 1][k] = ps[s + 1][k];
      } else {
        ma[q][k] = ma[q + 2][k] = a[j][0][k];
        ma[q + 1][k] = ma[q + 3][k] = a[j][1][k];
        mb[q][k] = mb[q + 3][k] = b[j][0][k];
        mb[q + 1][k] = mb[q + 2][k] = b[j][1][k];
      }
    }
    s += square ? 3 : 0;
    q += square ? 2 : 4;
  }
  mont_mul_split<G, S, kProducts>(mr, ma, mb);
  // a product's a0 b0 - a1 b1 and a0 b1 + a1 b0
  Lanes<uint32_t, G> xa[kPost][D], xb[kPost][D], xs[kPost][D];
  if constexpr (kMuls > 0) {
    int u = 0;
    q = 0;
#pragma unroll
    for (int j = 0; j < M; ++j) {
      if ((Squares >> j) & 1u) {
        q += 2;
        continue;
      }
#pragma unroll
      for (int k = 0; k < D; ++k) {
        xa[u][k] = mr[q][k];
        xb[u][k] = mr[q + 1][k];
        xa[u + 1][k] = mr[q + 2][k];
        xb[u + 1][k] = mr[q + 3][k];
      }
      u += 2;
      q += 4;
    }
    sums<G, 2 * kMuls, fq2_product_sums(kMuls)>(xs, xa, xb);
  }
  int u = 0;
  q = 0;
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const bool square = (Squares >> j) & 1u;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      r[j][0][k] = square ? mr[q + 1][k] : xs[u][k];
      r[j][1][k] = square ? mr[q][k] : xs[u + 1][k];
    }
    u += square ? 0 : 2;
    q += square ? 2 : 4;
  }
}

// bits 4 i .. 4 i + 3 of e
FQ_HD uint32_t exponent_nibble(const Exponent& e, int i) { return (e.words[i / 8] >> (4 * (i % 8))) & 0xfu; }

// A table of Entries values for each lane of a block, each Parts Fq
// elements (1: Fq, K5's; 2: Fq2, K6's), indexed by a value that is the
// same on every lane of the warp. On the card it lies in shared memory as
// rows of blockDim.x words, word (entry, part, digit) of a thread in its
// column threadIdx.x: a lane reads only the words it wrote itself (no
// exchange, no barrier) and a warp's 32 lanes hit 32 banks. Without nvcc
// it is an array of Lanes, which the host build holds to the same rule (a
// read of another lane's entry counts in lane_faults).
template <int G, int Entries, int Parts>
struct LaneTable {
  static constexpr int D = kDigits / G;
#if defined(__CUDACC__)
  static constexpr int kWordsPerThread = Entries * Parts * D;
  uint32_t* words;  // kWordsPerThread rows of blockDim.x words

  FQ_GD void store(int e, const Lanes<uint32_t, G> x[Parts][D]) {
#pragma unroll
    for (int h = 0; h < Parts; ++h)
#pragma unroll
      for (int k = 0; k < D; ++k) words[((e * Parts + h) * D + k) * blockDim.x + threadIdx.x] = x[h][k].v;
  }

  FQ_GD void load(Lanes<uint32_t, G> x[Parts][D], int e) const {
#pragma unroll
    for (int h = 0; h < Parts; ++h)
#pragma unroll
      for (int k = 0; k < D; ++k) x[h][k].v = words[((e * Parts + h) * D + k) * blockDim.x + threadIdx.x];
  }
#else
  Lanes<uint32_t, G> v[Entries][Parts][D];

  void store(int e, const Lanes<uint32_t, G> x[Parts][D]) {
    FQ_LANES(l, G) {
      for (int h = 0; h < Parts; ++h)
        for (int k = 0; k < D; ++k) v[e][h][k][l] = x[h][k][l];
    }
  }

  void load(Lanes<uint32_t, G> x[Parts][D], int e) const {
    FQ_LANES(l, G) {
      for (int h = 0; h < Parts; ++h)
        for (int k = 0; k < D; ++k) x[h][k][l] = v[e][h][k][l];
    }
  }
#endif
};

template <int G, int Entries>
using FqTable = LaneTable<G, Entries, 1>;
template <int G, int Entries>
using Fq2Table = LaneTable<G, Entries, 2>;

// K5's and K6's window: 4 bits, a table of a^0 .. a^15
constexpr int kWindowBits = 4;
constexpr int kWindowEntries = 1 << kWindowBits;

// K5's body: r = a^e in Montgomery form with a fixed 4-bit window, the
// table in `table` (an FqTable of kWindowEntries). The table takes a^0 ..
// a^15 (14 products); then from the top nibble of e down, 4 squares and,
// at a nonzero nibble, one product with its table entry. For e = (p - 1) / 2
// the chain is 14 + 376 + 90 = 480 products deep, against 609 on the
// bit-serial walk (square at every bit, product at every set bit). The
// exponent is uniform, so the branch and the table index are too. Every
// product is a lone mont_mul_n for a chain (lazy and unrolled): the chain's
// values stay below 2p and are made canonical once at the end. 0 maps to 0.
template <int G, class Table>
FQ_GD void pow(Lanes<uint32_t, G> r[kDigits / G], const Lanes<uint32_t, G> a[kDigits / G], const Exponent& e,
               Table& table) {
  constexpr int D = kDigits / G;
  Lanes<uint32_t, G> acc[1][D], base[1][D];
  load_one<G>(acc[0]);
  table.store(0, acc);
#pragma unroll
  for (int k = 0; k < D; ++k) base[0][k] = acc[0][k] = a[k];
  table.store(1, acc);
#pragma unroll 1
  for (int w = 2; w < kWindowEntries; ++w) {
    mont_mul_n<G, 1, true>(acc, acc, base);
    table.store(w, acc);
  }
  const int nibbles = (e.bits + kWindowBits - 1) / kWindowBits;
  table.load(acc, nibbles > 0 ? (int)exponent_nibble(e, nibbles - 1) : 0);
  for (int i = nibbles - 2; i >= 0; --i) {
#pragma unroll 1
    for (int s = 0; s < kWindowBits; ++s) mont_mul_n<G, 1, true>(acc, acc, acc);
    const int w = (int)exponent_nibble(e, i);
    if (w) {
      table.load(base, w);
      mont_mul_n<G, 1, true>(acc, acc, base);
    }
  }
  settle<G>(acc[0]);  // below 2p, each lane's lowest digit below 2^24 + 2^8
  cond_sub_p<G>(r, acc[0]);
}

// K6's body: r = a^e in Fq2 with a fixed 4-bit window, on S subgroups of
// G lanes holding the same values (fq2_products' split). The table takes
// a^0 .. a^15 (14 products); then from the top nibble of e down, 4 squares
// and, at a nonzero nibble, one product with its table entry. The exponent
// is uniform, so the branch and the table index are too. Each square and
// product is one fq2_products batch, so the chain is as deep as its Fq2
// operations: for e = (p - 1) / 2, 14 + 376 + 90 = 480 batched rounds,
// against 1,447 Fq products one after another on the bit-serial walk.
template <int G, int S, class Table>
FQ_GD void fq2_pow(Lanes<uint32_t, G> r[2][kDigits / G], const Lanes<uint32_t, G> a[2][kDigits / G],
                   const Exponent& e, Table& table) {
  constexpr int D = kDigits / G;
  Lanes<uint32_t, G> acc[1][2][D], base[1][2][D];
  load_one<G>(acc[0][0]);
  FQ_LANES(l, G) {
#pragma unroll
    for (int k = 0; k < D; ++k) acc[0][1][k][l] = 0u;
  }
  table.store(0, acc[0]);
#pragma unroll
  for (int k = 0; k < D; ++k) base[0][0][k] = acc[0][0][k] = a[0][k], base[0][1][k] = acc[0][1][k] = a[1][k];
  table.store(1, acc[0]);
#pragma unroll 1
  for (int w = 2; w < kWindowEntries; ++w) {
    fq2_products<G, 1, 0u, S>(acc, acc, base);
    table.store(w, acc[0]);
  }
  const int nibbles = (e.bits + kWindowBits - 1) / kWindowBits;
  table.load(acc[0], nibbles > 0 ? (int)exponent_nibble(e, nibbles - 1) : 0);
  for (int i = nibbles - 2; i >= 0; --i) {
#pragma unroll 1
    for (int s = 0; s < kWindowBits; ++s) fq2_products<G, 1, 1u, S>(acc, acc, acc);
    const int w = (int)exponent_nibble(e, i);
    if (w) {
      table.load(base[0], w);
      fq2_products<G, 1, 0u, S>(acc, acc, base);
    }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) r[0][k] = acc[0][0][k], r[1][k] = acc[0][1][k];
}

// pred of any lane of the warp, on every lane: lets a warp skip work that
// none of its groups needs (pred is the same on a group's lanes). Without
// nvcc a warp is the one group the host runs.
FQ_GD bool warp_any(bool pred) {
#if defined(__CUDACC__)
  return __any_sync(0xffffffffu, pred);
#else
  return pred;
#endif
}

#if defined(__CUDACC__)
// lane l's digits D l .. D l + D - 1 of the element at src (the tensor
// layout's limbs 2 D l .. 2 D l + 2 D - 1): its D / 2 int4s
// (an int2 where a lane holds one digit, G = 16)
template <int G>
__device__ __forceinline__ void load_digits(Lanes<uint32_t, G> d[kDigits / G], const int32_t* src, int l) {
  constexpr int D = kDigits / G;
  if constexpr (D == 1) {
    const int2 w = reinterpret_cast<const int2*>(src)[l];
    d[0].v = (uint32_t)w.x | ((uint32_t)w.y << 12);
  } else {
    const int4* v = reinterpret_cast<const int4*>(src + 2 * D * l);
#pragma unroll
    for (int q = 0; q < D / 2; ++q) {
      const int4 w = v[q];
      d[2 * q].v = (uint32_t)w.x | ((uint32_t)w.y << 12);
      d[2 * q + 1].v = (uint32_t)w.z | ((uint32_t)w.w << 12);
    }
  }
}

template <int G>
__device__ __forceinline__ void store_digits(int32_t* dst, const Lanes<uint32_t, G> d[kDigits / G], int l) {
  constexpr int D = kDigits / G;
  if constexpr (D == 1) {
    reinterpret_cast<int2*>(dst)[l] = make_int2((int)(d[0].v & 0xfffu), (int)(d[0].v >> 12));
  } else {
    int4* v = reinterpret_cast<int4*>(dst + 2 * D * l);
#pragma unroll
    for (int q = 0; q < D / 2; ++q) {
      const uint32_t lo = d[2 * q].v, hi = d[2 * q + 1].v;
      v[q] = make_int4((int)(lo & 0xfffu), (int)(lo >> 12), (int)(hi & 0xfffu), (int)(hi >> 12));
    }
  }
}
#endif

}  // namespace lanes

}  // namespace fq
