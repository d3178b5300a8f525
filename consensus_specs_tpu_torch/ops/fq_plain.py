"""Plain PyTorch versions of the base-field kernels K3 (``fq_mul``), K4
(``fq_addsub``), K5 (``fq_pow``) and K6 (``fq2_pow``).

They compute what ``csrc/fq.cu`` and ``csrc/fq_pow.cu`` compute, on the
same layout: BLS12-381 base-field elements as ``(..., 32)`` int32 tensors
of canonical 12-bit limbs (little-endian; an Fq2 element is ``(..., 2,
32)``), Montgomery radix R = 2^384, inputs and outputs below p. Every
result is the canonical residue, so the limbs are equal bit for bit to
the JAX package's ``ops/fq.py`` and to the kernels.

They are the CPU path of the field wrappers and the yardstick the kernels
are held against on the card. They are written for few tensor operations
a call, not for the JAX package's shape:

- a product is one outer product of 24-bit limb pairs summed along its
  anti-diagonals (a skew of the 16 x 16 partial products), not 32
  shifted adds;
- the Montgomery reduction is done for all 32 limbs at once,
  m = (T mod R)(-p^-1) mod R and (T + m p) / R, with the two constant
  products as float64 matrix products (every partial sum is an integer
  below 2^53, so they are exact), not 32 word-serial rounds;
- a carry ripple is resolved in one integer addition: the generate and
  propagate bits of the 32 limbs are packed into two int64 bit masks G and
  P, and the carries into each limb are the bits of ((G|P) + G) ^ (G|P) ^ G
  (a carry-lookahead done by the CPU's adder), not a 32-step scan.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

P_INT = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
LIMB_BITS = 12
N_LIMBS = 32
LIMB_MASK = (1 << LIMB_BITS) - 1
R_INT = 1 << (LIMB_BITS * N_LIMBS)
NP_INT = (-pow(P_INT, -1, R_INT)) % R_INT  # -p^-1 mod R

OP_ADD, OP_SUB, OP_NEG = 0, 1, 2


def limbs_of(v: int, n: int = N_LIMBS) -> np.ndarray:
    return np.array([(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    p = limbs_of(P_INT)
    np_ = limbs_of(NP_INT)
    # (T mod R) * NP mod R as a matrix: row i holds NP shifted up by i limbs
    np_mat = np.zeros((N_LIMBS, N_LIMBS))
    p_mat = np.zeros((N_LIMBS, 2 * N_LIMBS))
    for i in range(N_LIMBS):
        np_mat[i, i:] = np_[: N_LIMBS - i]
        p_mat[i, i : i + N_LIMBS] = p
    return {
        "p": torch.tensor(p, dtype=torch.int32, device=device),
        "one": torch.tensor(limbs_of(R_INT % P_INT), dtype=torch.int32, device=device),  # 1 in Montgomery form
        "np_mat": torch.tensor(np_mat, dtype=torch.float64, device=device),
        "p_mat": torch.tensor(p_mat, dtype=torch.float64, device=device),
        "bits": torch.tensor([1 << i for i in range(N_LIMBS)], dtype=torch.int64, device=device),
        "shifts": torch.arange(N_LIMBS, dtype=torch.int64, device=device),
        "pieces": torch.arange(0, 60, LIMB_BITS, dtype=torch.int64, device=device),
    }


def _chain(g: torch.Tensor, p: torch.Tensor, c: dict):
    """Carries of a 32-limb ripple in one addition. ``g`` (generate) and
    ``p`` (propagate) are disjoint 0/1 (or bool) tensors (..., 32).
    Returns the carry into each limb (..., 32) and the int64 word whose
    bit 32 is the carry out of the top."""
    gm = (g * c["bits"]).sum(-1)
    x = gm | (p * c["bits"]).sum(-1)
    s = x + gm
    return (((s ^ x ^ gm).unsqueeze(-1) >> c["shifts"]) & 1), s


def _settle(x: torch.Tensor, c: dict) -> torch.Tensor:
    """Limbs in [0, 4096] -> canonical limbs of the same value mod R."""
    s = x & LIMB_MASK
    cin, _ = _chain(x >> LIMB_BITS, s == LIMB_MASK, c)
    return (s + cin) & LIMB_MASK


def _passes(x: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` parallel carry passes over non-negative limbs; a carry out of
    the top limb is dropped (a multiple of R)."""
    for _ in range(n):
        carry = x >> LIMB_BITS
        x = x & LIMB_MASK
        x[..., 1:] += carry[..., :-1]
    return x


def _cond_sub_p(x: torch.Tensor, c: dict) -> torch.Tensor:
    """x - p where x >= p, else x (x canonical, below 2p)."""
    d = x - c["p"]
    bin_, s = _chain(d < 0, d == 0, c)
    borrowed = (s >> N_LIMBS).bool().unsqueeze(-1)
    return torch.where(borrowed, x, (d - bin_) & LIMB_MASK)


def _poly(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The product a b as 64 non-negative limbs (..., 64) int64 of 12-bit
    positions (not yet carried), from (..., 32) limbs.

    Pairs of 12-bit limbs are joined into 16 limbs of 24 bits; their outer
    product (float64: each product is below 2^48 and each sum of 16 below
    2^52, so exact), read against b padded to 32 limbs as rows of 31, puts
    row i i places up, and the rows sum to the 31 coefficients of the
    product in base 2^24. Each coefficient is cut back into five 12-bit
    pieces; a position's pieces sum to less than 2^15."""
    lead = a.shape[:-1]
    a24 = (a[..., 0::2] + (a[..., 1::2] << LIMB_BITS)).double()
    b24 = (b[..., 0::2] + (b[..., 1::2] << LIMB_BITS)).double()
    outer = a24.unsqueeze(-1) * torch.nn.functional.pad(b24, (0, 16)).unsqueeze(-2)  # (..., 16, 32)
    coeff = outer.reshape(lead + (512,))[..., : 16 * 31].unflatten(-1, (16, 31)).sum(-2).long()
    d = (coeff.unsqueeze(-1) >> _consts(a.device)["pieces"]) & LIMB_MASK  # (..., 31, 5)
    pad = torch.nn.functional.pad
    # coefficient k, piece j lands at 12-bit position 2k + j
    even = pad(d[..., 0], (0, 2)) + pad(d[..., 2], (1, 1)) + pad(d[..., 4], (2, 0))  # positions 2e
    odd = pad(d[..., 1], (0, 2)) + pad(d[..., 3], (1, 1))  # positions 2e + 1
    return torch.stack([even, odd], dim=-1).flatten(-2)[..., : 2 * N_LIMBS]


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3's plain version: the Montgomery product a b / R mod p."""
    c = _consts(a.device)
    a, b = torch.broadcast_tensors(a.int(), b.int())
    t = _poly(a, b)  # T = a b, limbs < 2^15
    # m = (T mod R) * NP mod R: products < 2^27, sums < 2^32, exact in float64
    m = (t[..., :N_LIMBS].double() @ c["np_mat"]).long()
    m = _settle(_passes(m, 3), c)
    u = t + (m.double() @ c["p_mat"]).long()  # T + m p: low 384 bits are 0, limbs < 2^30
    # the carry out of the low half is the integer (sum_{i<32} u_i 2^(12 i)) / R;
    # the limbs below 30 add less than 2^-5 to it, so it is a ceiling of the top two
    low = (u[..., 31] << LIMB_BITS) + u[..., 30]
    carry = (low + (1 << 2 * LIMB_BITS) - 1) >> (2 * LIMB_BITS)
    hi = u[..., N_LIMBS:].clone()
    hi[..., 0] += carry
    hi = _settle(_passes(hi, 3), c)  # (T + m p) / R < 2p
    return _cond_sub_p(hi, c).int()


def addsub(a: torch.Tensor, b: torch.Tensor, op: int) -> torch.Tensor:
    """K4's plain version: (a + b), (a - b) or (-b) mod p, by ``op``."""
    c = _consts(a.device)
    if op == OP_ADD:
        s = a + b
        low = s & LIMB_MASK
        cin, _ = _chain(s >> LIMB_BITS, low == LIMB_MASK, c)
        return _cond_sub_p((low + cin) & LIMB_MASK, c).int()
    if op == OP_SUB:
        d = a - b
    elif op == OP_NEG:
        d = torch.zeros_like(a) - b
    else:
        raise ValueError(f"fq addsub: unknown op {op}")
    bin_, s = _chain(d < 0, d == 0, c)
    # a - b + p where it borrowed; the carry out of the top cancels the wrap
    r = ((d - bin_) & LIMB_MASK) + ((s >> N_LIMBS) & 1).unsqueeze(-1) * c["p"]
    low = r & LIMB_MASK
    cin, _ = _chain(r >> LIMB_BITS, low == LIMB_MASK, c)
    return ((low + cin) & LIMB_MASK).int()


def pow_bits(a: torch.Tensor, bits) -> torch.Tensor:
    """K5's plain version: a^e in Montgomery form, e given as its bits from
    the most significant, by square-and-multiply (the product with a only
    at a set bit). 0 maps to 0."""
    r = _consts(a.device)["one"].expand(a.shape)
    for bit in bits:
        r = mul(r, r)
        if bit:
            r = mul(r, a)
    return r


def fq2_square(a: torch.Tensor) -> torch.Tensor:
    """(a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u, as K6 computes it."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    s = addsub(torch.stack([a0, a0]), torch.stack([a1, a0]), OP_ADD)  # a0 + a1, 2 a0
    d = addsub(a0, a1, OP_SUB)
    return mul(s, torch.stack([d, a1])).movedim(0, -2)


def fq2_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Karatsuba, as K6 computes it: t0 = a0 b0, t1 = a1 b1,
    t2 = (a0 + a1)(b0 + b1); c0 = t0 - t1, c1 = t2 - t0 - t1."""
    a0, a1, b0, b1 = a[..., 0, :], a[..., 1, :], b[..., 0, :], b[..., 1, :]
    s = addsub(torch.stack([a0, b0]), torch.stack([a1, b1]), OP_ADD)
    t = mul(torch.stack([a0, a1, s[0]]), torch.stack([b0, b1, s[1]]))
    u = addsub(torch.stack([t[0], t[2]]), torch.stack([t[1], t[0]]), OP_SUB)
    return torch.stack([u[0], addsub(u[1], t[1], OP_SUB)], dim=-2)


def fq2_pow_bits(a: torch.Tensor, bits) -> torch.Tensor:
    """K6's plain version: a^e in Fq2 (``(..., 2, 32)``, u^2 = -1), the walk
    of ``pow_bits`` from (1, 0)."""
    c = _consts(a.device)
    r = torch.stack([c["one"], torch.zeros_like(c["one"])]).expand(a.shape)
    for bit in bits:
        r = fq2_square(r)
        if bit:
            r = fq2_mul(r, a)
    return r


# What K5/K6 are checked with, by the tests and by chip_smoke.py: the
# exponents of the port's pow chains (square root, Legendre symbol, the Fq2
# square root's a^((p-3)/4), inverse), the edge values, and the power on
# Python integers.
R_MONT = R_INT % P_INT  # 1 in Montgomery form
EXPONENTS = {"sqrt": (P_INT + 1) // 4, "legendre": (P_INT - 1) // 2, "sqrt_a1": (P_INT - 3) // 4, "inv": P_INT - 2}
# as limb values 0, 1, p-1 and R mod p; in Fq2 (1, 0), (0, 1) and (p-1, p-1),
# as limb values and in Montgomery form, and 0
POW_EDGES = {1: [0, 1, P_INT - 1, R_MONT],
             2: [(1, 0), (0, 1), (P_INT - 1, P_INT - 1), (R_MONT, 0), (0, R_MONT),
                 ((P_INT - 1) * R_MONT % P_INT, (P_INT - 1) * R_MONT % P_INT), (0, 0)]}


def bits_msb(e: int) -> list:
    return [int(c) for c in bin(e)[2:]]


def pow_int(x, e: int, degree: int):
    """x^e on Montgomery-form integers (a limb value v stands for v / R):
    an int in Fq (degree 1), a pair (x0, x1) for x0 + x1 u in Fq2."""
    rinv = pow(R_INT, -1, P_INT)
    if degree == 1:
        return pow(x * rinv % P_INT, e, P_INT) * R_MONT % P_INT
    x0, x1 = x[0] * rinv % P_INT, x[1] * rinv % P_INT
    r = (1, 0)
    for c in bin(e)[2:]:
        r = ((r[0] * r[0] - r[1] * r[1]) % P_INT, 2 * r[0] * r[1] % P_INT)
        if c == "1":
            r = ((r[0] * x0 - r[1] * x1) % P_INT, (r[0] * x1 + r[1] * x0) % P_INT)
    return (r[0] * R_MONT % P_INT, r[1] * R_MONT % P_INT)


def pow_values(n: int, degree: int, rng: np.random.Generator, edges: bool = True) -> list:
    """n random elements of Fq (ints, degree 1) or Fq2 (pairs), with the
    edge values as the last ones where n has room (16 or more)."""
    tail = POW_EDGES[degree] if edges and n >= 16 else []
    rand = [int.from_bytes(rng.bytes(48), "big") % P_INT for _ in range((n - len(tail)) * degree)]
    return (rand if degree == 1 else list(zip(rand[0::2], rand[1::2]))) + tail


if __name__ == "__main__":
    # Per-call CPU time of the plain versions at the shape of a stacked Fq12
    # multiply of 8 two-pair rows, (8, 2, 18, 32), and of one element:
    #     python -m consensus_specs_tpu_torch.ops.fq_plain
    import time

    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    for shape in ((8, 2, 18), (1,)):
        n = int(np.prod(shape))
        limbs = [limbs_of(int.from_bytes(rng.bytes(48), "big") % P_INT) for _ in range(2 * n)]
        x, y = (torch.tensor(np.stack(limbs[k * n:(k + 1) * n]), dtype=torch.int32).view(shape + (N_LIMBS,))
                for k in (0, 1))
        for name, fn in (("mul", lambda: mul(x, y)), ("add", lambda: addsub(x, y, OP_ADD)),
                         ("sub", lambda: addsub(x, y, OP_SUB))):
            fn()
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            print(f"{name} {shape + (N_LIMBS,)}: {(time.perf_counter() - t0) * 10:.3f} ms a call")
