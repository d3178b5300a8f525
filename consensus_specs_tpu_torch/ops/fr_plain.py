"""Plain PyTorch versions of the Fr kernels K12 (``fr_mul``) and K11
(``fr_fft``): the port of the JAX package's ``ops/fft_jax.py`` field and
transform, on its layout.

An element of Fr (the BLS12-381 scalar field, modulus r < 2^255) is a
``(..., 22)`` int32 tensor of canonical 12-bit limbs, little-endian, in
Montgomery form with radix R = 2^264 (22 x 12 bits; not Fq's 2^384).
Every result is the canonical residue, so the limbs equal the JAX
package's and the kernels' bit for bit.

The arithmetic is the JAX package's: a schoolbook convolution of the limbs,
a word-serial Montgomery reduction of 22 rounds of one limb, carries
resolved by a ripple over the limbs, a conditional subtraction of r. The
limbs are held in int64 between the steps (PyTorch has no unsigned 32-bit
arithmetic on the CPU), which leaves every intermediate far from overflow.

They are the CPU path of ``ops/fft_torch.py`` and the yardstick the
kernels are held against on the card.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..crypto import fr as host_fr

R_INT_MODULUS = host_fr.MODULUS
P_INT = R_INT_MODULUS
LIMB_BITS = 12
N_LIMBS = 22  # 264 bits >= 255
LIMB_MASK = (1 << LIMB_BITS) - 1
R_INT = 1 << (LIMB_BITS * N_LIMBS)
NPRIME = (-pow(P_INT, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)  # -r^-1 mod 2^12


# -- host <-> limbs -------------------------------------------------------------
# 22 limbs of 12 bits are 33 bytes: each 3 bytes little-endian hold 2 limbs

def to_limbs(values) -> np.ndarray:
    """ints (any nesting) -> (..., 22) int32 canonical limbs of each value
    mod r (plain form)."""
    arr = np.asarray(values, dtype=object)
    flat = [int(v) % P_INT for v in arr.reshape(-1)]
    raw = np.frombuffer(b"".join(v.to_bytes(33, "little") for v in flat), dtype=np.uint8)
    b = raw.reshape(len(flat), 11, 3).astype(np.int32)
    lo = b[..., 0] | ((b[..., 1] & 0xF) << 8)
    hi = (b[..., 1] >> 4) | (b[..., 2] << 4)
    return np.stack([lo, hi], axis=-1).reshape(arr.shape + (N_LIMBS,))


def from_limbs(limbs) -> np.ndarray:
    """(..., 22) limbs (array or tensor) -> object array of ints mod r."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.detach().cpu().numpy()
    arr = np.asarray(limbs, dtype=np.int64)
    pairs = arr.reshape(-1, 11, 2)
    lo, hi = pairs[..., 0], pairs[..., 1]
    b = np.stack([lo & 0xFF, (lo >> 8) | ((hi & 0xF) << 4), hi >> 4], axis=-1).astype(np.uint8)
    out = np.empty(len(b), dtype=object)
    for i, row in enumerate(b):
        out[i] = int.from_bytes(row.tobytes(), "little") % P_INT
    return out.reshape(arr.shape[:-1])


def limbs_of(v: int) -> np.ndarray:
    return to_limbs([v])[0]


P_LIMBS = np.array([(P_INT >> (LIMB_BITS * i)) & LIMB_MASK for i in range(N_LIMBS)], dtype=np.int32)
R2_LIMBS = limbs_of(R_INT * R_INT % P_INT)
ONE_MONT = limbs_of(R_INT % P_INT)
ONE_PLAIN = limbs_of(1)


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    return {"p": torch.tensor(P_LIMBS, dtype=torch.int64, device=device)}


# -- limb primitives ------------------------------------------------------------------

def _carry_norm(x: torch.Tensor):
    """Exact carry propagation to canonical 12-bit limbs, lowest first (an
    arithmetic shift, so negative limbs borrow). Returns the limbs and the
    carry out of the top limb (-1 where the value was negative)."""
    x = x.clone()
    carry = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        v = x[..., i] + carry
        x[..., i] = v & LIMB_MASK
        carry = v >> LIMB_BITS
    return x, carry


def _cond_sub_p(x: torch.Tensor) -> torch.Tensor:
    """x - r where x >= r, else x (x canonical limbs, below 2r)."""
    d, borrow = _carry_norm(x - _consts(x.device)["p"])
    return torch.where((borrow < 0).unsqueeze(-1), x, d)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod r, both below r."""
    a, b = torch.broadcast_tensors(a.long(), b.long())
    return _cond_sub_p(_carry_norm(a + b)[0]).int()


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod r, both below r."""
    a, b = torch.broadcast_tensors(a.long(), b.long())
    return _cond_sub_p(_carry_norm(a + _consts(a.device)["p"] - b)[0]).int()


def _poly_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 22) x (..., 22) -> (..., 44) schoolbook convolution, one spare
    limb on top for the reduction's carries."""
    out = torch.zeros(a.shape[:-1] + (2 * N_LIMBS,), dtype=torch.int64, device=a.device)
    for k in range(N_LIMBS):
        out[..., k : k + N_LIMBS] += a[..., k : k + 1] * b
    return out


def _mont_reduce(t: torch.Tensor) -> torch.Tensor:
    """t / R mod r for the (..., 44) convolution t of two values below r:
    22 rounds, each adding the multiple m r that clears limb i and moving
    that limb's carry up."""
    p = _consts(t.device)["p"]
    for i in range(N_LIMBS):
        m = ((t[..., i] & LIMB_MASK) * NPRIME) & LIMB_MASK
        t[..., i : i + N_LIMBS] += m.unsqueeze(-1) * p
        t[..., i + 1] += t[..., i] >> LIMB_BITS
        t[..., i] = 0
    hi, _ = _carry_norm(t[..., N_LIMBS:])  # below 2r < 2^264: no carry out
    return _cond_sub_p(hi)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K12's plain version: the Montgomery product a b / 2^264 mod r."""
    a, b = torch.broadcast_tensors(a.long(), b.long())
    return _mont_reduce(_poly_mul(a, b)).int()


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """plain -> Montgomery form (a R mod r)."""
    return mul(a, torch.from_numpy(R2_LIMBS).to(a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery -> plain form: the product with plain 1."""
    return mul(a, torch.from_numpy(ONE_PLAIN).to(a.device))


# -- the transform ------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def twiddle_ints(n: int, inverse: bool) -> tuple:
    """w^k mod r for k < n/2, w the canonical n-th root of unity (its
    inverse for the inverse transform). Stage s's twiddle j is
    w^(j n / 2^(s+1))."""
    w = host_fr.root_of_unity(n)
    if inverse:
        w = pow(w, P_INT - 2, P_INT)
    out, acc = [], 1
    for _ in range(n // 2):
        out.append(acc)
        acc = acc * w % P_INT
    return tuple(out)


@functools.lru_cache(maxsize=16)
def _twiddle_tables(n: int, inverse: bool) -> tuple:
    """Per-stage twiddle factors in Montgomery form, (half, 22) int32 each."""
    powers = twiddle_ints(n, inverse)
    tables, half = [], 1
    while half < n:
        step = n // (2 * half)
        tables.append(to_limbs([powers[j * step] * R_INT % P_INT for j in range(half)]))
        half *= 2
    return tuple(tables)


@functools.lru_cache(maxsize=16)
def rbo_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    i = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def fft(vals: torch.Tensor, n: int, inverse: bool = False) -> torch.Tensor:
    """K11's plain version (``fft_jax._fft_body``): the radix-2 DIT of
    ``vals`` (n, 22) in Montgomery form, the bit-reversal gather then log2 n
    butterfly stages, each a product by the stage's twiddles, an add and a
    sub; on the inverse, the product by n^-1."""
    assert n & (n - 1) == 0 and tuple(vals.shape) == (n, N_LIMBS), (n, tuple(vals.shape))
    dev = vals.device
    vals = vals[torch.from_numpy(rbo_perm(n)).to(dev)]
    for s, tw in enumerate(_twiddle_tables(n, inverse)):
        half = 1 << s
        v = vals.reshape(n // (2 * half), 2, half, N_LIMBS)
        even, odd = v[:, 0], v[:, 1]
        t = mul(odd, torch.from_numpy(tw).to(dev))
        vals = torch.stack([add(even, t), sub(even, t)], dim=1).reshape(n, N_LIMBS)
    if inverse:
        n_inv = limbs_of(pow(n, P_INT - 2, P_INT) * R_INT % P_INT)
        vals = mul(vals, torch.from_numpy(n_inv).to(dev))
    return vals


def das_extension(data: torch.Tensor, n: int) -> torch.Tensor:
    """``fft_jax.das_extension_jit``'s plain version: the inverse transform
    at n, a zero pad to 2n, the forward transform, the odd outputs."""
    poly = fft(data, n, inverse=True)
    full = fft(torch.cat([poly, torch.zeros_like(poly)]), 2 * n)
    return full[1::2]
