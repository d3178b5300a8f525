"""Batched BLS12-381 extension-field tower on limb tensors: the port of the
JAX package's ``ops/tower.py`` (the device analog of ``crypto/bls/fields.py``).

Representation (Montgomery-form int32 limb tensors, see ``ops/fq.py``):
  Fq2  : (..., 2, 32)       c0 + c1*u,           u^2 = -1
  Fq6  : (..., 3, 2, 32)    c0 + c1*v + c2*v^2,  v^3 = u + 1
  Fq12 : (..., 2, 3, 2, 32) c0 + c1*w,           w^2 = v

Linear ops (add/sub/neg/double) are component-wise base-field ops and
broadcast for free. Multiplications stack every independent base-field
product of a tower op into ONE ``fq.mul`` call (one K3 launch on the
card): an Fq12 multiply is one base-field multiply over a 24x batch.
Independent additions of one tower op are stacked the same way into one
``fq.add``/``fq.sub`` call (one K4 launch); every result is the canonical
residue, so the limbs equal the JAX package's whatever the grouping.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fq

add = fq.add
sub = fq.sub
neg = fq.neg


def double(a):
    return fq.add(a, a)


def muln(a, n: int):
    """a * n for a small static positive int n, via a binary add chain
    (every intermediate stays canonical mod p)."""
    assert n > 0
    result = None
    addend = a
    while n:
        if n & 1:
            result = addend if result is None else fq.add(result, addend)
        n >>= 1
        if n:
            addend = fq.add(addend, addend)
    return result


def _stack(*xs):
    return torch.stack(torch.broadcast_tensors(*xs), dim=0)


def add_many(pairs):
    """[(x, y), ...] -> [x + y, ...] in one ``fq.add`` call."""
    out = fq.add(_stack(*(x for x, _ in pairs)), _stack(*(y for _, y in pairs)))
    return list(out.unbind(0))


def sub_many(pairs):
    """[(x, y), ...] -> [x - y, ...] in one ``fq.sub`` call."""
    out = fq.sub(_stack(*(x for x, _ in pairs)), _stack(*(y for _, y in pairs)))
    return list(out.unbind(0))


# -- Fq2 ---------------------------------------------------------------------

def fq2_mul(a, b):
    """Schoolbook: the 4 base products a_i b_j in ONE batched mul, then
    c0 = a0 b0 - a1 b1 and c1 = a0 b1 + a1 b0. (The JAX package's
    Karatsuba saves a product and spends two more additions; every
    addition is a launch, a product in the same batch is not.)"""
    a, b = torch.broadcast_tensors(a, b)
    t = fq.mul(torch.stack([a, a]), torch.stack([b, b.flip(-2)]))
    c0 = fq.sub(t[0, ..., 0, :], t[0, ..., 1, :])
    c1 = fq.add(t[1, ..., 0, :], t[1, ..., 1, :])
    return torch.stack([c0, c1], dim=-2)


def fq2_square(a):
    """(a0+a1)(a0-a1), 2*a0*a1 — 2 base products stacked."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    s, d2 = add_many([(a0, a1), (a1, a1)])
    t = fq.mul(_stack(s, a0), _stack(fq.sub(a0, a1), d2))
    return torch.stack([t[0], t[1]], dim=-2)


def fq2_mul_fq(a, s):
    """Fq2 element times base-field scalar s (..., 32)."""
    return fq.mul(a, s.unsqueeze(-2))


def fq2_conj(a):
    return torch.stack([a[..., 0, :], fq.neg(a[..., 1, :])], dim=-2)


def fq2_mul_nonresidue(a):
    """* (u + 1): (a0 - a1, a0 + a1)."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    return torch.stack([fq.sub(a0, a1), fq.add(a0, a1)], dim=-2)


# a^e in Fq2 for a static exponent, in one call (K6 ``fq2_pow`` on the card)
fq2_pow_bits = fq.fq2_pow_bits


def fq2_inv(a):
    a0, a1 = a[..., 0, :], a[..., 1, :]
    t = fq.mul(a, a)
    norm_inv = fq.inv(fq.add(t[..., 0, :], t[..., 1, :]))
    prod = fq.mul(a, norm_inv.unsqueeze(-2))
    return torch.stack([prod[..., 0, :], fq.neg(prod[..., 1, :])], dim=-2)


# -- Fq6 ---------------------------------------------------------------------

def fq6_mul(a, b):
    """Toom/Karatsuba-style: 6 fq2 products in one stacked fq2_mul."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    b0, b1, b2 = b[..., 0, :, :], b[..., 1, :, :], b[..., 2, :, :]
    s = add_many([(a1, a2), (a0, a1), (a0, a2), (b1, b2), (b0, b1), (b0, b2)])
    t = fq2_mul(_stack(a0, a1, a2, s[0], s[1], s[2]), _stack(b0, b1, b2, s[3], s[4], s[5]))
    t0, t1, t2, s12, s01, s02 = t.unbind(0)
    u12, u01, u02 = add_many([(t1, t2), (t0, t1), (t0, t2)])
    d12, d01, d02 = sub_many([(s12, u12), (s01, u01), (s02, u02)])
    nr12, nr2 = fq2_mul_nonresidue(torch.stack([d12, t2])).unbind(0)
    c0, c1, c2 = add_many([(nr12, t0), (d01, nr2), (d02, t1)])
    return torch.stack([c0, c1, c2], dim=-3)


def fq6_mul_nonresidue(a):
    """* v: (xi*c2, c0, c1)."""
    return torch.stack([fq2_mul_nonresidue(a[..., 2, :, :]), a[..., 0, :, :], a[..., 1, :, :]], dim=-3)


def fq6_inv(a):
    a0, a1, a2 = a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]
    t = fq2_mul(_stack(a0, a2, a1, a1, a0, a0), _stack(a0, a2, a1, a2, a1, a2))
    sq, cross = t[:3], t[3:]
    t0, t1, t2 = sub_many([
        (sq[0], fq2_mul_nonresidue(cross[0])),
        (fq2_mul_nonresidue(sq[1]), cross[1]),
        (sq[2], cross[2]),
    ])
    parts = fq2_mul(_stack(a0, a2, a1), _stack(t0, t1, t2))
    norm = fq.add(parts[0], fq.add(fq2_mul_nonresidue(parts[1]), fq2_mul_nonresidue(parts[2])))
    factor = fq2_inv(norm)
    out = fq2_mul(_stack(t0, t1, t2), factor)
    return torch.movedim(out, 0, -3)


# -- Fq12 --------------------------------------------------------------------

def fq12_mul(a, b):
    """Karatsuba over Fq6: 3 fq6 products in one stacked fq6_mul (which
    is itself one stacked base mul — an Fq12 multiply costs one batched
    fq.mul over a 24x batch)."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    b0, b1 = b[..., 0, :, :, :], b[..., 1, :, :, :]
    sa, sb = add_many([(a0, a1), (b0, b1)])
    t = fq6_mul(_stack(a0, a1, sa), _stack(b0, b1, sb))
    c0, u = add_many([(t[0], fq6_mul_nonresidue(t[1])), (t[0], t[1])])
    c1 = fq.sub(t[2], u)
    return torch.stack([c0, c1], dim=-4)


def fq12_square(a):
    return fq12_mul(a, a)


def fq12_conjugate(a):
    return torch.stack([a[..., 0, :, :, :], fq.neg(a[..., 1, :, :, :])], dim=-4)


def fq12_inv(a):
    a0, a1 = a[..., 0, :, :, :], a[..., 1, :, :, :]
    sq = fq6_mul(_stack(a0, a1), _stack(a0, a1))
    factor = fq6_inv(fq.sub(sq[0], fq6_mul_nonresidue(sq[1])))
    out = fq6_mul(_stack(a0, fq.neg(a1)), factor)
    return torch.movedim(out, 0, -4)


# -- constants & host conversion ---------------------------------------------

def _mont_int(v: int) -> int:
    return (v * fq.R_INT) % fq.P_INT


def fq_to_limbs_mont(v: int) -> np.ndarray:
    return fq._to_limbs_int(_mont_int(v))


def fq2_to_limbs_mont(x) -> np.ndarray:
    """Host crypto.bls.fields.Fq2 (or (c0, c1) ints) -> (2, 32)."""
    return np.stack([fq_to_limbs_mont(int(x[0])), fq_to_limbs_mont(int(x[1]))])


def fq12_to_limbs_mont(f) -> np.ndarray:
    """Host crypto.bls.fields.Fq12 -> (2, 3, 2, 32)."""
    return np.stack([np.stack([fq2_to_limbs_mont(f[j][i]) for i in range(3)]) for j in range(2)])


_R_INV = pow(fq.R_INT, -1, fq.P_INT)


def limbs_to_int(arr) -> int:
    """(32,) Montgomery limbs (array or tensor) -> plain int."""
    return (int(fq.from_limbs(arr)) * _R_INV) % fq.P_INT


def limbs_to_fq12(arr):
    """(2, 3, 2, 32) Montgomery limbs -> host Fq12."""
    from ..crypto.bls import fields as hf

    a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    sixes = []
    for j in range(2):
        coeffs = [hf.Fq2(limbs_to_int(a[j, i, 0]), limbs_to_int(a[j, i, 1])) for i in range(3)]
        sixes.append(hf.Fq6(*coeffs))
    return hf.Fq12(*sixes)


def _np_one12() -> np.ndarray:
    out = np.zeros((2, 3, 2, fq.N_LIMBS), dtype=np.int32)
    out[0, 0, 0] = fq.ONE_MONT
    return out


ONE12 = _np_one12()
ONE2 = np.zeros((2, fq.N_LIMBS), dtype=np.int32)
ONE2[0] = fq.ONE_MONT


def fq12_one(shape=(), device=None) -> torch.Tensor:
    return fq.const(ONE12, device).expand(tuple(shape) + (2, 3, 2, fq.N_LIMBS))


def fq12_is_one(a):
    """Canonical-form equality with 1 (valid on canonical limb tensors)."""
    return (a == fq.const(ONE12, a.device)).flatten(-4).all(-1)


def _compute_frob_p2_consts() -> np.ndarray:
    """The p^2-Frobenius coefficients: for each basis monomial v^i w^j,
    (v^i w^j)^(p^2) = gamma * v^i w^j with gamma in Fq2. Returns
    (2, 3, 2, 32) Montgomery constants."""
    from ..crypto.bls import fields as hf

    out = np.zeros((2, 3, 2, fq.N_LIMBS), dtype=np.int32)
    for j in range(2):
        for i in range(3):
            six = [hf.FQ2_ZERO, hf.FQ2_ZERO, hf.FQ2_ZERO]
            six[i] = hf.FQ2_ONE
            mono = hf.Fq12(hf.Fq6(*six) if j == 0 else hf.FQ6_ZERO, hf.Fq6(*six) if j == 1 else hf.FQ6_ZERO)
            img = mono.frobenius(2)
            gamma = img[j][i]
            for jj in range(2):
                for ii in range(3):
                    expect = gamma if (jj, ii) == (j, i) else hf.FQ2_ZERO
                    assert img[jj][ii] == expect
            out[j, i] = fq2_to_limbs_mont(gamma)
    return out


FROB_P2 = _compute_frob_p2_consts()


def fq12_frobenius_p2(a):
    """a^(p^2) via precomputed per-component Fq2 constants."""
    return fq2_mul(a, fq.const(FROB_P2, a.device))


def fq12_pow_bits(a, bits):
    """a^e with e given as a static MSB-first bit sequence:
    square-and-multiply, the multiply only where the bit is set."""
    r = fq12_one(a.shape[:-4], a.device)
    for bit in np.asarray(bits).tolist():
        r = fq12_square(r)
        if bit:
            r = fq12_mul(r, a)
    return r
