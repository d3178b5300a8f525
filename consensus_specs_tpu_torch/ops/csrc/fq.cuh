// BLS12-381 base-field arithmetic for one thread: the device functions of
// the K3 (fq_mul) and K4 (fq_addsub) kernels of fq.cu, kept in a header so
// that later fused kernels (the Miller loop, the final exponentiation, the
// pow chains of fq_inv and fq2_sqrt) can build on the same code.
//
// Two layouts meet here:
// - the port's tensor layout: 32 canonical 12-bit limbs in int32 lanes,
//   little-endian (the JAX package's ops/fq.py layout, kept so that limb
//   tensors compare directly with it);
// - the arithmetic layout: 12 little-endian 32-bit words.
// R = 2^384 in both (32 x 12 = 12 x 32 bits), so a value's Montgomery form
// is the same integer in either layout, and repacking at the boundary
// (pack/unpack below) is exact.
//
// Every function takes and returns values below p. The header compiles as
// plain C++ too (without nvcc the qualifiers fall away), so its arithmetic
// can be checked by a host compiler against the plain PyTorch version.
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

}  // namespace fq
