"""Plain PyTorch versions of the SHA-256 kernels K1 and K2.

They compute what `csrc/sha256.cu` computes, on the same tensor layout, in
ordinary tensor operations: the CPU path of the hashing wrappers, and the
yardstick the kernels are held against on the card.

Layout (shared with the kernels): an int32 tensor of shape ``(N, 16)``
whose memory is the N 64-byte messages, byte for byte; the digests come
back as an int32 tensor of shape ``(N, 8)`` whose memory is the N 32-byte
digests. SHA-256 reads its words big-endian, so the byte swap happens in
here, not on the host.

torch has no uint32 ``+``, ``>>``, ``<<`` or ``~`` on the CPU, so the words
live in int64 lanes and every sum is masked back to 32 bits.
"""
from __future__ import annotations

import torch

_M = 0xFFFFFFFF

K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)


def _rotr_int(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M


def _pad_block_schedule() -> tuple:
    """Message schedule of the constant second block of a 64-byte message:
    0x80, zeros, 64-bit bit length (512)."""
    w = [0x80000000] + [0] * 14 + [512]
    for t in range(16, 64):
        s0 = _rotr_int(w[t - 15], 7) ^ _rotr_int(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr_int(w[t - 2], 17) ^ _rotr_int(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M)
    return tuple(w)


# K[t] + W_pad[t]: the padding block's whole schedule folds into constants
# (the KPAD table of csrc/sha256.cu).
KPAD = tuple((k + w) & _M for k, w in zip(K, _pad_block_schedule()))


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M


def _words_be(blocks: torch.Tensor) -> list:
    """(N, 16) int32 message bytes -> 16 int64 (N,) big-endian words."""
    b = blocks.contiguous().view(torch.uint8).reshape(-1, 16, 4).to(torch.int64)
    w = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    return list(w.unbind(1))


def _digest_bytes(state: list) -> torch.Tensor:
    """8 int64 (N,) words -> (N, 8) int32 whose memory is the digest bytes."""
    w = torch.stack(state, dim=1)
    b = torch.stack([(w >> 24) & 0xFF, (w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF], dim=2)
    return b.to(torch.uint8).reshape(-1, 32).view(torch.int32)


def _compress(state: list, kw) -> list:
    """One compression; ``kw(t)`` gives K[t] + W[t] (a tensor or an int)."""
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _M) & g)
        t1 = (h + s1 + ch + kw(t)) & _M
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = (t1 + s0 + maj) & _M, a, b, c, (d + t1) & _M, e, f, g
    return [(x + y) & _M for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def _compress_data(state: list, w: list) -> list:
    w = list(w)
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M)
    return _compress(state, lambda t: w[t] + K[t])


def _iv(n: int, device) -> list:
    return [torch.full((n,), v, dtype=torch.int64, device=device) for v in IV]


def sha256_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """K1's plain version: SHA-256 of each 64-byte message."""
    mid = _compress_data(_iv(blocks.shape[0], blocks.device), _words_be(blocks))
    return _digest_bytes(_compress(mid, lambda t: KPAD[t]))


def sha256_raw_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """K2's plain version: one compression from the IV over padded blocks."""
    return _digest_bytes(_compress_data(_iv(blocks.shape[0], blocks.device), _words_be(blocks)))
