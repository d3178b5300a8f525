// BLS12-381 scalar-field (Fr) arithmetic: the device functions of the K11
// (fr_fft) and K12 (fr_mul) kernels of fr_fft.cu.
//
// Layouts:
// - the port's tensor layout (the JAX package's ops/fft_jax.py layout, kept
//   so that limb tensors compare directly with it): 22 canonical 12-bit
//   limbs in int32 lanes, little-endian, in Montgomery form with radix
//   2^264 (the "boundary form", x 2^264 mod r);
// - the arithmetic layout: 8 little-endian 32-bit words (r < 2^255, so a
//   canonical value fits 256 bits and packing is exact).
//
// A product on 8 words (CIOS) divides by 2^256, not 2^264. Two ways keep
// the boundary form exact:
// - K12's product of two boundary values, a b 2^-256, is one Montgomery
//   step of 8 bits short of a b 2^-264: div_2_8 takes that step;
// - K11 holds its constants (the twiddles, n^-1) in the 2^256 form, so a
//   product of a boundary value by one of them stays in the boundary form
//   with one CIOS product a butterfly.
// Every result is the canonical residue, so any exact route gives the plain
// version's limbs.
//
// The header compiles as plain C++ too (without nvcc the qualifiers fall
// away), so the tests hold its arithmetic and the transform's index math
// against the plain PyTorch version with a host compiler.
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define FR_HD __host__ __device__ __forceinline__
#else
#define FR_HD inline
#endif

namespace fr {

constexpr int kWords = 8;
constexpr int kLimbs = 22;
constexpr uint32_t kN0 = 0xffffffffu;  // -r^-1 mod 2^32 (r = 1 mod 2^32)

// K12's op codes
constexpr int kMul = 0, kAdd = 1, kSub = 2;

// r in 32-bit words, little-endian
FR_HD constexpr uint32_t r_word(int i) {
  return i == 0 ? 0x00000001u : i == 1 ? 0xffffffffu : i == 2 ? 0xfffe5bfeu : i == 3 ? 0x53bda402u
       : i == 4 ? 0x09a1d805u : i == 5 ? 0x3339d808u : i == 6 ? 0x299d7d48u : 0x73eda753u;
}

// 22 canonical limbs -> 8 words (limb k holds bits 12k .. 12k + 11)
FR_HD void pack(uint32_t w[kWords], const uint32_t l[kLimbs]) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) w[j] = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    const int j = 12 * k / 32, s = 12 * k % 32;
    w[j] |= l[k] << s;
    if (s > 20 && j + 1 < kWords) w[j + 1] |= l[k] >> (32 - s);
  }
}

// 8 words -> 22 canonical limbs
FR_HD void unpack(uint32_t l[kLimbs], const uint32_t w[kWords]) {
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    const int j = 12 * k / 32, s = 12 * k % 32;
    uint32_t v = w[j] >> s;
    if (s > 20 && j + 1 < kWords) v |= w[j + 1] << (32 - s);
    l[k] = v & 0xfffu;
  }
}

// r = t - r if t >= r, else t (t < 2r < 2^256)
FR_HD void cond_sub_r(uint32_t out[kWords], const uint32_t t[kWords]) {
  uint32_t d[kWords];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t s = (uint64_t)t[j] - r_word(j) - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) out[j] = borrow ? t[j] : d[j];
}

// Montgomery product out = a b / 2^256 mod r (a, b < r), coarsely
// integrated operand scanning: per word of b, one multiply-accumulate row
// and one reduction row, 64-bit accumulators, the running value below 2r.
// out may alias a or b (written only at the end).
FR_HD void mont_mul(uint32_t out[kWords], const uint32_t a[kWords], const uint32_t b[kWords]) {
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
    c = ((uint64_t)m * r_word(0) + t[0]) >> 32;  // the low word cancels
#pragma unroll
    for (int j = 1; j < kWords; ++j) {
      c += (uint64_t)m * r_word(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[kWords];
    t[kWords - 1] = (uint32_t)c;
    t[kWords] = t[kWords + 1] + (uint32_t)(c >> 32);
  }
  cond_sub_r(out, t);
}

// out = t / 2^8 mod r (t < r): one Montgomery step of 8 bits. m = -t mod
// 2^8 (r = 1 mod 2^8) makes t + m r a multiple of 2^8, below 257 r < 2^264
// (9 words); the quotient is below 2r.
FR_HD void div_2_8(uint32_t out[kWords], const uint32_t t[kWords]) {
  const uint32_t m = (0u - t[0]) & 0xffu;
  uint32_t u[kWords + 1];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)m * r_word(j) + t[j];
    u[j] = (uint32_t)c;
    c >>= 32;
  }
  u[kWords] = (uint32_t)c;
  uint32_t s[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) s[j] = (u[j] >> 8) | (u[j + 1] << 24);
  cond_sub_r(out, s);
}

// out = a + b mod r
FR_HD void add_mod(uint32_t out[kWords], const uint32_t a[kWords], const uint32_t b[kWords]) {
  uint32_t s[kWords];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  cond_sub_r(out, s);  // a + b < 2r < 2^256: no carry out
}

// out = a - b mod r
FR_HD void sub_mod(uint32_t out[kWords], const uint32_t a[kWords], const uint32_t b[kWords]) {
  uint32_t d[kWords];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)s;
    borrow = (uint32_t)(s >> 63);
  }
  // where a < b, add r back; the carry out of the top word cancels the wrap
  const uint32_t mask = 0u - borrow;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    c += (uint64_t)d[j] + (r_word(j) & mask);
    out[j] = (uint32_t)c;
    c >>= 32;
  }
}

FR_HD void load_limbs(uint32_t w[kWords], const int32_t* src) {
  uint32_t l[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) l[k] = (uint32_t)src[k];
  pack(w, l);
}

FR_HD void store_limbs(int32_t* dst, const uint32_t w[kWords]) {
  uint32_t l[kLimbs];
  unpack(l, w);
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) dst[k] = (int32_t)l[k];
}

FR_HD void load_words(uint32_t w[kWords], const uint32_t* src) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) w[j] = src[j];
}

FR_HD void store_words(uint32_t* dst, const uint32_t w[kWords]) {
#pragma unroll
  for (int j = 0; j < kWords; ++j) dst[j] = w[j];
}

// K12's element: a b 2^-264, a + b or a - b mod r on boundary-form limbs
template <int kOp>
FR_HD void pointwise(int32_t* out, const int32_t* a, const int32_t* b) {
  uint32_t x[kWords], y[kWords], z[kWords];
  load_limbs(x, a);
  load_limbs(y, b);
  if (kOp == kMul) {
    mont_mul(z, x, y);
    div_2_8(z, z);
  } else if (kOp == kAdd) {
    add_mod(z, x, y);
  } else {
    sub_mod(z, x, y);
  }
  store_limbs(out, z);
}

// the low `bits` bits of x reversed
FR_HD uint32_t reverse_bits(uint32_t x, int bits) {
#if defined(__CUDA_ARCH__)
  return bits ? __brev(x) >> (32 - bits) : 0u;
#else
  uint32_t v = 0;
  for (int i = 0; i < bits; ++i) v |= ((x >> i) & 1u) << (bits - 1 - i);
  return v;
#endif
}

// The constants of one transform, in the 2^256 form: n^-1 (inverse only).
struct Scale {
  uint32_t v[kWords];
};

// Butterfly j (0 <= j < n/2) of stage `stage` (half = 2^stage) of the
// radix-2 DIT on n = 2^log_n elements, as fft_jax._fft_body orders it: the
// pair (i0, i1 = i0 + half), i0 = (j / half) 2 half + j % half, twiddle
// w^(j % half * n / (2 half)) from `twiddles` ((n/2) x 8 words, w^k 2^256
// mod r). The first stage reads the input limbs at the bit-reversed rows
// (the gather of _rbo_perm) and packs them; the stages between read and
// write `words` ((n, 8) in place: each butterfly owns its pair); the last
// scales by n^-1 on the inverse (kInverse) and unpacks into `out`. Stage 0
// of a 2-element transform is first and last.
template <bool kFirst, bool kLast, bool kInverse>
FR_HD void butterfly(int64_t j, const int32_t* in, uint32_t* words, int32_t* out, const uint32_t* twiddles,
                     int log_n, int stage, const Scale& n_inv) {
  const int64_t half = (int64_t)1 << stage;
  const int64_t pos = j & (half - 1);
  const int64_t i0 = ((j >> stage) << (stage + 1)) | pos, i1 = i0 + half;
  uint32_t x0[kWords], x1[kWords], w[kWords], t[kWords], y0[kWords], y1[kWords];
  if (kFirst) {
    load_limbs(x0, in + (int64_t)reverse_bits((uint32_t)i0, log_n) * kLimbs);
    load_limbs(x1, in + (int64_t)reverse_bits((uint32_t)i1, log_n) * kLimbs);
  } else {
    load_words(x0, words + i0 * kWords);
    load_words(x1, words + i1 * kWords);
  }
  load_words(w, twiddles + (pos << (log_n - 1 - stage)) * kWords);
  mont_mul(t, x1, w);
  add_mod(y0, x0, t);
  sub_mod(y1, x0, t);
  if (kLast) {
    if (kInverse) {
      mont_mul(y0, y0, n_inv.v);
      mont_mul(y1, y1, n_inv.v);
    }
    store_limbs(out + i0 * kLimbs, y0);
    store_limbs(out + i1 * kLimbs, y1);
  } else {
    store_words(words + i0 * kWords, y0);
    store_words(words + i1 * kWords, y1);
  }
}

}  // namespace fr
