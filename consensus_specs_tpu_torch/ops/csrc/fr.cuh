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

// a b + c, one 32 x 32 -> 64-bit multiply-add (IMAD.WIDE.U32) on the card
FR_HD uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t c) {
#if defined(__CUDA_ARCH__)
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(c));
  return r;
#else
  return (uint64_t)a * b + c;
#endif
}

// Montgomery product out = a b / 2^256 mod r (a, b < r), coarsely
// integrated operand scanning with no carry chain: a position k of the
// running value holds a word t[k] and a pending carry h[k] (both below
// 2^32), so a word product plus both, a b + t + h < 2^64, is one
// multiply-add and a multiply-add by 1, which ptxas makes two ALU adds
// (written as a plain 64-bit sum, some become IMAD.X on the multiply-add
// pipe; PERF.md times the two forms), and leaves the new word and the
// carry into k + 1. The 8 products of a row (and of a reduction step, m =
// -t_i since -r^-1 = -1 mod 2^32) are then independent of each other, and
// a step's chain is a few instructions where a scan with carries through
// every word is a chain of them all. A row's carry out of its top position
// parks in that position's word, still free. One carry pass over the top 8
// positions at the end.
// out may alias a or b (written only at the end).
FR_HD void mont_mul(uint32_t out[kWords], const uint32_t a[kWords], const uint32_t b[kWords]) {
  uint32_t t[2 * kWords], h[2 * kWords];
#pragma unroll
  for (int k = 0; k < 2 * kWords; ++k) t[k] = 0, h[k] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    // row i of a b: positions i .. i + 7 (high to low: each reads the old
    // carry of its position and writes the one above)
#pragma unroll
    for (int j = kWords - 1; j >= 0; --j) {
      const uint64_t p = mad_wide(h[i + j], 1u, mad_wide(a[j], b[i], t[i + j]));
      t[i + j] = (uint32_t)p;
      if (j == kWords - 1) t[i + kWords] = (uint32_t)(p >> 32);
      else h[i + j + 1] = (uint32_t)(p >> 32);
    }
    // reduction step i: + m r 2^(32 i) clears position i (r_0 = 1: t_i + m
    // is 0 or 2^32)
    const uint32_t m = 0u - t[i];
    const uint32_t carry = t[i] != 0u;
#pragma unroll
    for (int j = kWords - 1; j >= 1; --j) {
      const uint64_t p = mad_wide(h[i + j], 1u, mad_wide(m, r_word(j), t[i + j]));
      t[i + j] = (uint32_t)p;
      h[i + j + 1] = (uint32_t)(p >> 32);
    }
    h[i + 1] = carry;
  }
  // (a b + m r) / 2^256 < 2r < 2^256: positions 8 .. 15, carried
  uint32_t v[kWords];
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    c += (uint64_t)t[kWords + k] + h[kWords + k];
    v[k] = (uint32_t)c;
    c >>= 32;
  }
  cond_sub_r(out, v);
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

// a row of 8 words; on the card two 16-byte accesses (rows are 32-byte
// aligned in the scratch buffer, the twiddle table and shared memory)
FR_HD void load_words(uint32_t w[kWords], const uint32_t* src) {
#if defined(__CUDA_ARCH__)
  const uint4 lo = reinterpret_cast<const uint4*>(src)[0], hi = reinterpret_cast<const uint4*>(src)[1];
  w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w, w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
#else
  for (int j = 0; j < kWords; ++j) w[j] = src[j];
#endif
}

FR_HD void store_words(uint32_t* dst, const uint32_t w[kWords]) {
#if defined(__CUDA_ARCH__)
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
#else
  for (int j = 0; j < kWords; ++j) dst[j] = w[j];
#endif
}

// The copies of the tiles' cooperative loads and stores: 8 bytes (a limb
// row of 88 bytes is 11 of them, and 8-byte aligned) and 16 bytes (half a
// word row, or a piece of a 16-byte aligned span of limb rows).
FR_HD void copy8(int32_t* dst, const int32_t* src) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src);
#else
  dst[0] = src[0], dst[1] = src[1];
#endif
}

template <class T>  // a 32-bit integer
FR_HD void copy16(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  for (int j = 0; j < 4; ++j) dst[j] = src[j];
#endif
}

constexpr int kPieces = kLimbs / 2;  // 8-byte pieces of a limb row

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

// The host build's block: a step runs for each of the block's threads in
// turn, and the next step starts after the last thread's (the card runs a
// step on all threads together, then __syncthreads()). A step reads and
// writes only shared-memory entries no other thread of the same step
// touches, so the two orders give the same result.
#if !defined(__CUDA_ARCH__)
struct HostBlock {
  int threads;
  template <class F>
  void each(F&& step) {
    for (int t = 0; t < threads; ++t) step(t);
  }
};
#endif

// ---------------------------------------------------------------------------
// K12: one tile of kTileRows elements a block, a thread an element. The
// operands' rows of a tile are one contiguous span (kTileRows x 88 bytes),
// copied into shared memory by all threads together (copy_span), so a
// warp's access is contiguous; each thread then packs its row from there,
// and the result goes back through shared memory the same way. An operand
// of stride 0 (one element for every thread: to_mont's R^2, from_mont's 1)
// is copied once into `one` (2 x 22 limbs), so every thread packs from
// shared memory. The last tile may be short.
constexpr int kTileRows = 128;

// Thread t's share of copying a span of `rows` limb rows (rows x 88
// bytes): with kWide, 16-byte pieces t, t + kTileRows, ... (5.5 a row,
// a warp's access 512 contiguous bytes) and, for an odd count of rows,
// the last 8 bytes on thread 0; both ends must then be 16-byte aligned,
// as a tile of a 16-byte aligned tensor is (kTileRows x 88 bytes is a
// multiple of 16). Without, 8-byte pieces (11 a row, 256 bytes a warp's
// access), for spans that are only 8-byte aligned.
template <bool kWide>
FR_HD void copy_span(int32_t* dst, const int32_t* src, int rows, int t) {
  if (kWide) {
    constexpr int kWidePieces = (kTileRows * kLimbs / 4 + kTileRows - 1) / kTileRows;  // a thread's, at most
    const int pieces = rows * kLimbs / 4;
#pragma unroll
    for (int q = 0; q < kWidePieces; ++q) {
      const int i = t + q * kTileRows;
      if (i < pieces) copy16(dst + 4 * i, src + 4 * i);
    }
    if ((rows & 1) && t == 0) copy8(dst + 4 * pieces, src + 4 * pieces);
  } else {
    const int pieces = rows * kPieces;
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      const int i = t + q * kTileRows;
      if (i < pieces) copy8(dst + 2 * i, src + 2 * i);
    }
  }
}

template <int kOp, bool kWide, class Block>
FR_HD void pointwise_tile(Block& blk, int64_t tile, int64_t n, const int32_t* a, int64_t sa, const int32_t* b,
                          int64_t sb, int32_t* out, int32_t* ta, int32_t* tb, int32_t* one) {
  const int64_t first = tile * kTileRows;
  const int rows = n - first < kTileRows ? (int)(n - first) : kTileRows;
  const int64_t base = first * kLimbs;
  blk.each([&](int t) {
    if (sa) copy_span<kWide>(ta, a + base, rows, t);
    if (sb) copy_span<kWide>(tb, b + base, rows, t);
    if (!sa && t < kPieces) copy8(one + 2 * t, a + 2 * t);
    if (!sb && t < kPieces) copy8(one + kLimbs + 2 * t, b + 2 * t);
  });
  blk.each([&](int t) {
    if (t < rows) pointwise<kOp>(ta + t * kLimbs, sa ? ta + t * kLimbs : one, sb ? tb + t * kLimbs : one + kLimbs);
  });
  blk.each([&](int t) { copy_span<kWide>(out + base, ta, rows, t); });
}

// ---------------------------------------------------------------------------
// K11: the radix-2 DIT of fft_jax._fft_body (stage s pairs the rows i and
// i + 2^s that differ in bit s, with the twiddle w^((i mod 2^s) n / 2^(s+1))
// on the second) in passes of consecutive stages, each pass one launch.
//
// Stages s0 .. s0 + T - 1 pair only rows that differ in bits s0 .. s0 + T
// - 1, so the 2^T rows that agree in every other bit (a group) go through
// them alone: a block holds a tile of 2^per rows in shared memory and runs
// the pass's stages there, a __syncthreads() between stages, one thread a
// butterfly (per: the stages of a full pass). A short pass (T < per) puts
// 2^(per - T) groups of adjacent rows (the bits below s0) in a tile. The
// first pass gathers the input rows in bit-reversed order (_rbo_perm) and
// packs them into 8-word rows; the last scales by n^-1 on the inverse and
// unpacks into the output; between passes the rows live in the (n, 8)
// word scratch buffer. A transform of 2^log_n rows takes
// ceil(log_n / kPassStages) passes of as equal a size as can be.
constexpr int kPassStages = 8;  // the most stages a pass: 2^8 rows, 128 threads a block
constexpr int kPassRows = 1 << kPassStages;
constexpr int kPassThreads = kPassRows / 2;

// The constants of one transform, in the 2^256 form: n^-1 (inverse only).
struct Scale {
  uint32_t v[kWords];
};

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

FR_HD int pass_count(int log_n, int max_stages) { return (log_n + max_stages - 1) / max_stages; }

// One pass of a transform: stages s0 .. s0 + stages - 1 on tiles of
// 2^lg_rows rows, 2^lg_lo adjacent groups a tile.
struct Pass {
  int log_n, s0, stages, lg_rows, lg_lo;

  FR_HD int rows() const { return 1 << lg_rows; }
  FR_HD int threads() const { return 1 << (lg_rows - 1); }
  FR_HD int64_t blocks() const { return (int64_t)1 << (log_n - lg_rows); }

  // the transform's row of row l of block b's tile: l holds the group's
  // low bits (below s0; lg_lo of them vary in the tile), then its k bits
  // (s0 .. s0 + stages - 1); b the rest
  FR_HD int64_t row(int64_t b, int l) const {
    const int lg_low_blocks = s0 - lg_lo;
    const int64_t high = b >> lg_low_blocks;
    const int64_t low = ((b & (((int64_t)1 << lg_low_blocks) - 1)) << lg_lo) | (l & ((1 << lg_lo) - 1));
    return (high << (s0 + stages)) | ((int64_t)(l >> lg_lo) << s0) | low;
  }

  // the tile rows of butterfly j at the pass's stage t: bit lg_lo + t of l
  // is 0 and 1
  FR_HD int pair_low(int j, int t) const {
    const int bit = lg_lo + t;
    return ((j >> bit) << (bit + 1)) | (j & ((1 << bit) - 1));
  }
  FR_HD int pair_bit(int t) const { return 1 << (lg_lo + t); }

  // the row of the twiddle table (w^k, k < n/2) of butterfly j at stage t
  FR_HD int64_t twiddle(int64_t b, int j, int t) const {
    const int s = s0 + t;
    return (row(b, pair_low(j, t)) & (((int64_t)1 << s) - 1)) << (log_n - 1 - s);
  }
};

// pass p of a transform of 2^log_n rows in passes of at most max_stages
FR_HD Pass pass_plan(int log_n, int max_stages, int p) {
  const int passes = pass_count(log_n, max_stages);
  const int per = (log_n + passes - 1) / passes;
  const int s0 = p * per;
  const int stages = log_n - s0 < per ? log_n - s0 : per;
  return Pass{log_n, s0, stages, per, per - stages};
}

// The shared memory of a pass, in 32-bit words: the tile (rows() x 8
// words), each stage's twiddles (stages x threads() x 8 words), and for
// the first and last passes the limb rows (rows() x 22).
FR_HD int pass_smem_words(const Pass& ps, bool limbs) {
  return ps.rows() * kWords + ps.stages * ps.threads() * kWords + (limbs ? ps.rows() * kLimbs : 0);
}
constexpr int kPassSmemBytes = 4 * (kPassRows * kWords + kPassStages * kPassThreads * kWords + kPassRows * kLimbs);

// Block b's share of pass `ps`: the pass body. `smem` holds
// pass_smem_words(ps, kFirst || kLast) words: the tile of rows() rows of 8
// words, then every stage's twiddle rows (a slot of threads() rows a
// stage, all fetched with the tile, so that the stages touch only shared
// memory), then the limb rows (first and last passes).
template <bool kFirst, bool kLast, bool kInverse, class Block>
FR_HD void fft_pass(Block& blk, const Pass& ps, int64_t b, const int32_t* in, uint32_t* words, int32_t* out,
                    const uint32_t* twiddles, const Scale& n_inv, uint32_t* smem) {
  const int threads = ps.threads();
  uint32_t* tile = smem;
  uint32_t* tw = tile + ps.rows() * kWords;
  int32_t* limbs = reinterpret_cast<int32_t*>(tw + ps.stages * threads * kWords);
  blk.each([&](int t) {
    if (kFirst) {
#pragma unroll
      for (int q = 0; q < 2 * kPieces; ++q) {  // 2 rows of 11 pieces a thread
        const int i = t + q * threads, l = i / kPieces, piece = i % kPieces;
        const int64_t src = reverse_bits((uint32_t)ps.row(b, l), ps.log_n);
        copy8(limbs + l * kLimbs + 2 * piece, in + src * kLimbs + 2 * piece);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // 2 rows of 2 halves a thread
        const int i = t + q * threads, l = i >> 1, half = i & 1;
        copy16(tile + l * kWords + 4 * half, words + ps.row(b, l) * kWords + 4 * half);
      }
    }
#pragma unroll
    for (int s = 0; s < kPassStages; ++s) {
      if (s < ps.stages) {
        const uint32_t* w = twiddles + ps.twiddle(b, t, s) * kWords;
        copy16(tw + (s * threads + t) * kWords, w);
        copy16(tw + (s * threads + t) * kWords + 4, w + 4);
      }
    }
  });
  if (kFirst) {
    blk.each([&](int t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t x[kWords];
        load_limbs(x, limbs + (t + h * threads) * kLimbs);
        store_words(tile + (t + h * threads) * kWords, x);
      }
    });
  }
#pragma unroll 1
  for (int s = 0; s < ps.stages; ++s) {
    blk.each([&](int t) {
      uint32_t w[kWords], x0[kWords], x1[kWords], y[kWords];
      const int l0 = ps.pair_low(t, s), l1 = l0 + ps.pair_bit(s);
      load_words(w, tw + (s * threads + t) * kWords);
      load_words(x0, tile + l0 * kWords);
      load_words(x1, tile + l1 * kWords);
      mont_mul(x1, x1, w);
      add_mod(y, x0, x1);
      sub_mod(x1, x0, x1);
      store_words(tile + l0 * kWords, y);
      store_words(tile + l1 * kWords, x1);
    });
  }
  if (kLast) {
    blk.each([&](int t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t x[kWords];
        load_words(x, tile + (t + h * threads) * kWords);
        if (kInverse) mont_mul(x, x, n_inv.v);
        store_limbs(limbs + (t + h * threads) * kLimbs, x);
      }
    });
    blk.each([&](int t) {
#pragma unroll
      for (int q = 0; q < 2 * kPieces; ++q) {
        const int i = t + q * threads, l = i / kPieces, piece = i % kPieces;
        copy8(out + ps.row(b, l) * kLimbs + 2 * piece, limbs + l * kLimbs + 2 * piece);
      }
    });
  } else {
    blk.each([&](int t) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = t + q * threads, l = i >> 1, half = i & 1;
        copy16(words + ps.row(b, l) * kWords + 4 * half, tile + l * kWords + 4 * half);
      }
    });
  }
}

}  // namespace fr
