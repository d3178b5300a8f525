// SHA-256 kernels for Hopper (sm_90a): the Merkle-node hash of SSZ
// Merkleization and the one-block hash of short padded messages.
//
// K1 sha256_blocks replaces the Pallas kernel
// consensus_specs_tpu/ops/sha256_pallas.py `_kernel` (launched by
// `_pallas_rows`) and the XLA graph `sha256_of_block` / `sha256_blocks_jit`
// (consensus_specs_tpu/ops/sha256.py). Each 64-byte message is one Merkle
// node (left || right); the digest is compress(compress(IV, data), PAD)
// where PAD is the constant padding block of a 64-byte message, so its
// message schedule plus the round constants fold into one table (KPAD).
//
// K2 sha256_raw_blocks replaces `sha256_raw_blocks_jit` (same file): one
// compression from the IV over blocks the host already padded (messages of
// at most 55 bytes, such as the committee shuffle's seeds).
//
// Layout: messages cross as the raw bytes, read as little-endian uint32
// words, and are byte-swapped in registers; digests are written back as
// bytes. The host never reorders a byte. Any N works: no padding of the
// batch to a tile or a power of two.
//
// What bounds it: integer issue. A node costs about 2,300 32-bit integer
// instructions (rotates as funnel shifts, three-input XOR/choose/majority
// as LOP3, three-input adds) against 96 bytes of device memory traffic, so
// the 64 INT32 lanes of each SM are the limit long before the bandwidth.
// The design keeps everything in registers: one thread per message, the
// 16-word schedule window rolling in registers, the 8 state words
// renamed by the unrolled rounds, and the padding block's schedule reduced
// to constants. No shared memory, no synchronisation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint32_t K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
    0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u,
    0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u, 0x06ca6351u, 0x14292967u,
    0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu, 0x682e6ff3u,
    0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u, 0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

// KPAD[t] = K[t] + W[t] mod 2^32, W the message schedule of the padding
// block of a 64-byte message (0x80, zeros, bit length 512); computed by
// `_pad_block_schedule` in the port's ops/sha256_plain.py.
__constant__ uint32_t KPAD[64] = {
    0xc28a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u,
    0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf374u,
    0x649b69c1u, 0xf0fe4786u, 0x0fe1edc6u, 0x240cf254u, 0x4fe9346fu, 0x6cc984beu, 0x61b9411eu, 0x16f988fau,
    0xf2c65152u, 0xa88e5a6du, 0xb019fc65u, 0xb9d99ec7u, 0x9a1231c3u, 0xe70eeaa0u, 0xfdb1232bu, 0xc7353eb0u,
    0x3069bad5u, 0xcb976d5fu, 0x5a0f118fu, 0xdc1eeefdu, 0x0a35b689u, 0xde0b7a04u, 0x58f4ca9du, 0xe15d5b16u,
    0x007f3e86u, 0x37088980u, 0xa507ea32u, 0x6fab9537u, 0x17406110u, 0x0d8cd6f1u, 0xcdaa3b6du, 0xc0bbbe37u,
    0x83613bdau, 0xdb48a363u, 0x0b02e931u, 0x6fd15ca7u, 0x521afacau, 0x31338431u, 0x6ed41a95u, 0x6d437890u,
    0xc39c91f2u, 0x9eccabbdu, 0xb5c9a0e6u, 0x532fb63cu, 0xd2c741c6u, 0x07237ea3u, 0xa4954b68u, 0x4c191d76u,
};

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// One round; the caller renames the eight state words, so no moves remain
// after unrolling.
__device__ __forceinline__ void sha_round(uint32_t a, uint32_t b, uint32_t c, uint32_t& d,
                                      uint32_t e, uint32_t f, uint32_t g, uint32_t& h,
                                      uint32_t kw) {
    uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) + kw;
    uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) | (c & (a | b)));
    d += t1;
    h = t1 + t2;
}

// Eight rounds starting at round t, state words renamed in place.
#define EIGHT_ROUNDS(KW)                              \
    sha_round(a, b, c, d, e, f, g, h, KW(0));             \
    sha_round(h, a, b, c, d, e, f, g, KW(1));             \
    sha_round(g, h, a, b, c, d, e, f, KW(2));             \
    sha_round(f, g, h, a, b, c, d, e, KW(3));             \
    sha_round(e, f, g, h, a, b, c, d, KW(4));             \
    sha_round(d, e, f, g, h, a, b, c, KW(5));             \
    sha_round(c, d, e, f, g, h, a, b, KW(6));             \
    sha_round(b, c, d, e, f, g, h, a, KW(7));

// Compress the 16 big-endian words `w` (consumed: the window rolls in
// place) into `s`.
__device__ __forceinline__ void compress_data(uint32_t s[8], uint32_t w[16]) {
    uint32_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
    for (int t = 0; t < 64; t += 8) {
        if (t >= 16) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                int i = (t + j) & 15;
                uint32_t x = w[(i + 1) & 15], y = w[(i + 14) & 15];
                uint32_t s0 = rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
                uint32_t s1 = rotr(y, 17) ^ rotr(y, 19) ^ (y >> 10);
                w[i] += s0 + w[(i + 9) & 15] + s1;
            }
        }
#define KW_DATA(j) (w[(t + (j)) & 15] + K[t + (j)])
        EIGHT_ROUNDS(KW_DATA)
#undef KW_DATA
    }
    s[0] += a; s[1] += b; s[2] += c; s[3] += d; s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

// Compress the constant padding block of a 64-byte message into `s`.
__device__ __forceinline__ void compress_pad(uint32_t s[8]) {
    uint32_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
    for (int t = 0; t < 64; t += 8) {
#define KW_PAD(j) (KPAD[t + (j)])
        EIGHT_ROUNDS(KW_PAD)
#undef KW_PAD
    }
    s[0] += a; s[1] += b; s[2] += c; s[3] += d; s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

__device__ __forceinline__ void load_block(const uint4* in, int64_t i, uint32_t w[16]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        uint4 v = __ldg(in + 4 * i + q);
        w[4 * q + 0] = bswap(v.x);
        w[4 * q + 1] = bswap(v.y);
        w[4 * q + 2] = bswap(v.z);
        w[4 * q + 3] = bswap(v.w);
    }
}

__device__ __forceinline__ void store_digest(uint4* out, int64_t i, const uint32_t s[8]) {
    out[2 * i + 0] = make_uint4(bswap(s[0]), bswap(s[1]), bswap(s[2]), bswap(s[3]));
    out[2 * i + 1] = make_uint4(bswap(s[4]), bswap(s[5]), bswap(s[6]), bswap(s[7]));
}

template <bool kPadBlock>
__global__ void __launch_bounds__(kThreads) sha256_kernel(const uint4* __restrict__ in,
                                                          uint4* __restrict__ out, int64_t n) {
    int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= n) return;
    uint32_t w[16];
    load_block(in, i, w);
    uint32_t s[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                     0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};  // IV
    compress_data(s, w);
    if constexpr (kPadBlock) compress_pad(s);
    store_digest(out, i, s);
}

template <bool kPadBlock>
int launch(const void* in, void* out, int64_t n, void* stream) {
    if (n <= 0) return 0;
    int64_t blocks = (n + kThreads - 1) / kThreads;
    sha256_kernel<kPadBlock><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1: `n` 64-byte messages at `in` -> `n` 32-byte SHA-256 digests at `out`.
// Both buffers are device memory, 16-byte aligned. Returns the launch's
// cudaError_t (0 on success); the kernel runs on `stream` asynchronously.
int sha256_blocks_launch(const void* in, void* out, int64_t n, void* stream) {
    return launch<true>(in, out, n, stream);
}

// K2: one compression from the IV over `n` host-padded 64-byte blocks.
int sha256_raw_blocks_launch(const void* in, void* out, int64_t n, void* stream) {
    return launch<false>(in, out, n, stream);
}

const char* sha256_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
