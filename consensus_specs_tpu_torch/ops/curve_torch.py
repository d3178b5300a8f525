"""Batched BLS12-381 group arithmetic on limb tensors: the port of the JAX
package's ``ops/curve_jax.py``. Branch-free Jacobian point ops generic over
the coordinate field (Fq for G1, Fq2 for G2), static-scalar ladders, the
GLV/untwist endomorphisms and the fast subgroup tests, decompression.
A static-scalar ladder is one kernel launch on the card (K7
``g1_mul_static``, K8 ``g2_mul_static``); every other op here is torch
code on the field kernels.

Representation: Montgomery-form int32 limb tensors (``ops/fq.py``).
  G1 point: (X, Y, Z) each (..., 32)      — Jacobian, Z == 0 <=> infinity
  G2 point: (X, Y, Z) each (..., 2, 32)
All functions broadcast over leading batch dims; special cases (infinity,
doubling, inverses) are resolved with lane masks, never data-dependent
Python control flow. A static scalar's bits (a Python int) do steer the
loops: the ladder adds only at set bits, where the JAX package masked.

Subgroup tests (M. Scott, "A note on group membership tests for G1, G2
and GT on BLS pairing-friendly curves", 2021):
  G1: phi(P) == [lambda]P   with phi(x, y) = (beta x, y); lambda = -x^2.
  G2: psi(Q) == [x]Q        with psi the twist-Frobenius endomorphism.
Both identities are asserted against the host oracle at import time.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..crypto.bls import fields as hf
from ..crypto.bls.curve import g1_generator, g2_generator
from . import fq, fq_cuda, fq_plain, tower

X_PARAM = 0xD201000000010000  # |x|; BLS parameter x = -X_PARAM
R_ORDER = hf.R
P_INT = fq.P_INT


# -- field adapters ----------------------------------------------------------

class FQ:
    naxes = 1  # trailing field axes

    mul = staticmethod(fq.mul)
    square = staticmethod(fq.square)
    add = staticmethod(fq.add)
    sub = staticmethod(fq.sub)
    neg = staticmethod(fq.neg)
    inv = staticmethod(fq.inv)

    @staticmethod
    def double(a):
        return fq.add(a, a)

    @staticmethod
    def muln(a, n):
        return tower.muln(a, n)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1)

    @staticmethod
    def one(shape=(), device=None):
        return fq.const(fq.ONE_MONT, device).expand(tuple(shape) + (fq.N_LIMBS,))

    @staticmethod
    def zero(shape=(), device=None):
        return torch.zeros(tuple(shape) + (fq.N_LIMBS,), dtype=torch.int32, device=device)

    @staticmethod
    def where(mask, a, b):
        return torch.where(mask.unsqueeze(-1), a, b)


class FQ2:
    naxes = 2

    mul = staticmethod(tower.fq2_mul)
    square = staticmethod(tower.fq2_square)
    add = staticmethod(fq.add)
    sub = staticmethod(fq.sub)
    neg = staticmethod(fq.neg)
    inv = staticmethod(tower.fq2_inv)

    @staticmethod
    def double(a):
        return fq.add(a, a)

    @staticmethod
    def muln(a, n):
        return tower.muln(a, n)

    @staticmethod
    def is_zero(a):
        return (a == 0).flatten(-2).all(-1)

    @staticmethod
    def one(shape=(), device=None):
        return fq.const(tower.ONE2, device).expand(tuple(shape) + (2, fq.N_LIMBS))

    @staticmethod
    def zero(shape=(), device=None):
        return torch.zeros(tuple(shape) + (2, fq.N_LIMBS), dtype=torch.int32, device=device)

    @staticmethod
    def where(mask, a, b):
        return torch.where(mask.unsqueeze(-1).unsqueeze(-1), a, b)


def _plain_add(a, b):
    return fq_plain.addsub(a, b, fq_plain.OP_ADD)


def _plain_muln(a, n: int):
    """a * n by doubling and adding over n's bits; the residues are
    canonical, so this gives ``tower.muln``'s limbs."""
    r = a
    for bit in bin(n)[3:]:
        r = _plain_add(r, r)
        if bit == "1":
            r = _plain_add(r, a)
    return r


class FQ_PLAIN(FQ):
    """``FQ`` on the plain versions of K3/K4 (``fq_plain``), on any device:
    the adapter of the ladders' plain version, which launches no kernel."""

    mul = staticmethod(fq_plain.mul)
    square = staticmethod(lambda a: fq_plain.mul(a, a))
    add = staticmethod(_plain_add)
    sub = staticmethod(lambda a, b: fq_plain.addsub(a, b, fq_plain.OP_SUB))
    neg = staticmethod(lambda a: fq_plain.addsub(a, a, fq_plain.OP_NEG))
    double = staticmethod(lambda a: _plain_add(a, a))
    muln = staticmethod(_plain_muln)


class FQ2_PLAIN(FQ2):
    """``FQ2`` on the plain versions (``fq_plain``'s Fq2 square and
    product, as K6 and K8 compute them)."""

    mul = staticmethod(fq_plain.fq2_mul)
    square = staticmethod(fq_plain.fq2_square)
    add, sub, neg, double, muln = FQ_PLAIN.add, FQ_PLAIN.sub, FQ_PLAIN.neg, FQ_PLAIN.double, FQ_PLAIN.muln


# -- Jacobian point ops (branch-free) ----------------------------------------

def jac_infinity(F, shape=(), device=None):
    return (F.one(shape, device), F.one(shape, device), F.zero(shape, device))


def jac_is_infinity(F, pt):
    return F.is_zero(pt[2])


def jac_neg(F, pt):
    x, y, z = pt
    return (x, F.neg(y), z)


def jac_double(F, pt):
    """dbl-2009-l (the host oracle's shape, curve.py:57-71). Z == 0
    propagates: Z3 = 2YZ = 0, so infinity stays infinity."""
    x, y, z = pt
    a = F.square(x)
    b = F.square(y)
    c = F.square(b)
    d = F.double(F.sub(F.sub(F.square(F.add(x, b)), a), c))
    e = F.muln(a, 3)
    f = F.square(e)
    x3 = F.sub(f, F.double(d))
    y3 = F.sub(F.mul(e, F.sub(d, x3)), F.muln(c, 8))
    z3 = F.double(F.mul(y, z))
    return (x3, y3, z3)


def jac_add(F, p1, p2):
    """Complete addition via masked specials: either-infinity, P == Q
    (doubling), P == -Q (infinity). Mirrors curve.py:72-96 lane-wise."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    inf1 = F.is_zero(z1)
    inf2 = F.is_zero(z2)

    z1z1 = F.square(z1)
    z2z2 = F.square(z2)
    u1 = F.mul(x1, z2z2)
    u2 = F.mul(x2, z1z1)
    s1 = F.mul(y1, F.mul(z2z2, z2))
    s2 = F.mul(y2, F.mul(z1z1, z1))
    h = F.sub(u2, u1)
    r = F.double(F.sub(s2, s1))
    same_x = F.is_zero(h)
    same_y = F.is_zero(F.sub(s2, s1))

    i = F.square(F.double(h))
    j = F.mul(h, i)
    v = F.mul(u1, i)
    x3 = F.sub(F.square(r), F.add(j, F.double(v)))
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.double(F.mul(s1, j)))
    z3 = F.mul(F.sub(F.sub(F.square(F.add(z1, z2)), z1z1), z2z2), h)

    dx, dy, dz = jac_double(F, p1)
    dbl = same_x & same_y
    x3 = F.where(dbl, dx, x3)
    y3 = F.where(dbl, dy, y3)
    z3 = F.where(dbl, dz, z3)
    z3 = F.where(same_x & ~same_y, torch.zeros_like(z3), z3)
    x3 = F.where(inf1, x2, F.where(inf2, x1, x3))
    y3 = F.where(inf1, y2, F.where(inf2, y1, y3))
    z3 = F.where(inf1, z2, F.where(inf2, z1, z3))
    return (x3, y3, z3)


def jac_eq(F, p1, p2):
    """Point equality across Jacobian representatives (curve.py:112-122)."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    inf1 = F.is_zero(z1)
    inf2 = F.is_zero(z2)
    z1z1 = F.square(z1)
    z2z2 = F.square(z2)
    ex = F.is_zero(F.sub(F.mul(x1, z2z2), F.mul(x2, z1z1)))
    ey = F.is_zero(F.sub(F.mul(y1, F.mul(z2z2, z2)), F.mul(y2, F.mul(z1z1, z1))))
    return torch.where(inf1 | inf2, inf1 & inf2, ex & ey)


def jac_to_affine(F, pt):
    """(x, y, infinity_mask); infinity lanes read (0, 0)."""
    x, y, z = pt
    inf = F.is_zero(z)
    zinv = F.inv(z)  # 0 -> 0
    zinv2 = F.square(zinv)
    ax = F.mul(x, zinv2)
    ay = F.mul(y, F.mul(zinv2, zinv))
    return (F.where(~inf, ax, torch.zeros_like(ax)), F.where(~inf, ay, torch.zeros_like(ay)), inf)


def ladder(F, pt, k: int):
    """[k]pt for a static positive scalar on the adapter F: double-and-add
    over the bits MSB-first after the leading 1; the addition runs at set
    bits only. On ``FQ``/``FQ2`` and a CUDA tensor every field op is a
    K3/K4 launch (the composition K7/K8 replaced)."""
    assert k > 0
    acc = pt
    for c in bin(k)[3:]:
        acc = jac_double(F, acc)
        if c == "1":
            acc = jac_add(F, acc, pt)
    return acc


def scalar_mul_static_plain(F, pt, k: int):
    """K7/K8's plain version: the ladder on the plain field versions, on
    any device, with no kernel launch."""
    return ladder(FQ_PLAIN if F.naxes == 1 else FQ2_PLAIN, pt, k)


def scalar_mul_static(F, pt, k: int):
    """[k]pt for a static positive scalar, ``F`` naming the group (``FQ``:
    G1, ``FQ2``: G2). On a CUDA tensor one K7 ``g1_mul_static`` or K8
    ``g2_mul_static`` launch; on a CPU tensor the plain version. Both give
    the limbs of ``ladder``."""
    device = pt[0].device
    if device.type == "cpu":
        return scalar_mul_static_plain(F, pt, k)
    if device.type == "cuda":
        return (fq_cuda.g1_mul_static if F.naxes == 1 else fq_cuda.g2_mul_static)(pt, k)
    raise ValueError(f"curve: no kernel for device {device}")


def jac_tree_sum(F, pts, active):
    """Sum of K points per batch row: pts = (X, Y, Z) with a K axis at
    position -1-naxes, active (..., K) masks lanes (inactive == identity).
    Log-depth pairwise reduction."""
    x, y, z = pts
    k_ax = x.dim() - F.naxes - 1
    z = F.where(active, z, torch.zeros_like(z))
    while x.shape[k_ax] > 1:
        if x.shape[k_ax] % 2:
            pad = jac_infinity(F, x.shape[:k_ax] + (1,), x.device)
            x = torch.cat([x, pad[0]], dim=k_ax)
            y = torch.cat([y, pad[1]], dim=k_ax)
            z = torch.cat([z, pad[2]], dim=k_ax)
        ev = [t.unflatten(k_ax, (-1, 2)) for t in (x, y, z)]
        x, y, z = jac_add(F, tuple(t.select(k_ax + 1, 0) for t in ev), tuple(t.select(k_ax + 1, 1) for t in ev))
    return (x.select(k_ax, 0), y.select(k_ax, 0), z.select(k_ax, 0))


# -- square roots & parity (decompression primitives) ------------------------

def _bits_msb(e: int) -> list:
    return [(e >> i) & 1 for i in range(e.bit_length() - 1, -1, -1)]


_FQ_SQRT_BITS = _bits_msb((P_INT + 1) // 4)
_FQ_LEGENDRE_BITS = _bits_msb((P_INT - 1) // 2)
_FQ2_SQRT_A1_BITS = _bits_msb((P_INT - 3) // 4)


def fq_pow_bits(a, bits):
    """a^e over base-field lanes, e as static MSB-first bits."""
    return fq.pow_bits(a, bits)


def fq2_pow_bits(a, bits):
    return tower.fq2_pow_bits(a, bits)


def fq_sqrt(a):
    """(root, is_square): candidate a^((p+1)/4) (p = 3 mod 4); 0 -> (0, True)."""
    cand = fq_pow_bits(a, _FQ_SQRT_BITS)
    ok = FQ.is_zero(fq.sub(fq.mul(cand, cand), a))
    return cand, ok


def fq_legendre_is_square(a):
    """True where a is 0 or a QR in Fq (a^((p-1)/2) != p-1)."""
    s = fq_pow_bits(a, _FQ_LEGENDRE_BITS)
    return FQ.is_zero(a) | FQ.is_zero(fq.sub(s, FQ.one(s.shape[:-1], s.device)))


def fq2_is_square(a):
    """QR test via the norm map: a square iff Norm(a) = c0^2 + c1^2 is a
    QR in Fq (crypto/bls/hash_to_curve.py:69-72)."""
    sq = fq.mul(a, a)
    return fq_legendre_is_square(fq.add(sq[..., 0, :], sq[..., 1, :]))


_FQ2_U = np.stack([np.zeros(fq.N_LIMBS, dtype=np.int32), fq.ONE_MONT])  # u


def fq2_sqrt(a):
    """(root, is_square) in Fq2 — the host oracle's p = 3 mod 4 chain
    (crypto/bls/fields.py:147-171), branch-free:
      a1 = a^((p-3)/4); x0 = a1*a; alpha = a1*x0
      x  = u*x0           if alpha == -1
         = (1+alpha)^((p-1)/2) * x0   otherwise
    """
    a1 = fq2_pow_bits(a, _FQ2_SQRT_A1_BITS)
    x0 = tower.fq2_mul(a1, a)
    alpha = tower.fq2_mul(a1, x0)
    one2 = FQ2.one(a.shape[:-2], a.device)
    is_m1 = FQ2.is_zero(fq.add(alpha, one2))
    x_m1 = tower.fq2_mul(fq.const(_FQ2_U, a.device), x0)
    b = fq2_pow_bits(fq.add(one2, alpha), _FQ_LEGENDRE_BITS)
    x_gen = tower.fq2_mul(b, x0)
    x = FQ2.where(is_m1, x_m1, x_gen)
    ok = FQ2.is_zero(fq.sub(tower.fq2_square(x), a))
    zero_in = FQ2.is_zero(a)
    x = FQ2.where(zero_in, torch.zeros_like(x), x)
    return x, ok | zero_in


_HALF_P_PLUS1_LIMBS = fq._to_limbs_int((P_INT - 1) // 2 + 1)


def fq_lex_gt_half(a_mont):
    """a > (p-1)/2 on Montgomery lanes (converted to plain form first) —
    the compressed-serialization sign bit (curve.py:168-173)."""
    return fq.geq(fq.from_mont(a_mont), fq.const(_HALF_P_PLUS1_LIMBS, a_mont.device))


def fq2_lex_gt_half(a_mont):
    """Sign for G2 y: c1 unless zero, then c0 (curve.py:169-173)."""
    gt = fq_lex_gt_half(a_mont)  # both components in one call
    c1_zero = FQ.is_zero(a_mont[..., 1, :])
    return torch.where(c1_zero, gt[..., 0], gt[..., 1])


def fq2_sgn0(a_mont):
    """RFC 9380 sgn0 for Fq2 (crypto/bls/fields.py:130-135)."""
    plain = fq.from_mont(a_mont)
    c0, c1 = plain[..., 0, :], plain[..., 1, :]
    s0 = (c0[..., 0] & 1).bool()
    z0 = (c0 == 0).all(-1)
    s1 = (c1[..., 0] & 1).bool()
    return s0 | (z0 & s1)


# -- endomorphisms & fast subgroup checks ------------------------------------

def _host_psi(gx, gy, cx, cy):
    from ..crypto.bls.curve import g2_point

    return g2_point(gx.conjugate() * cx, gy.conjugate() * cy)


def _compute_endo_constants():
    """Pin beta (G1 GLV) and the psi constants (G2) numerically against
    the host oracle: refuse to import if phi(P) == [lambda]P and
    psi(Q) == [x]Q fail on the generators."""
    beta = pow(2, (P_INT - 1) // 3, P_INT)
    assert beta != 1 and pow(beta, 3, P_INT) == 1
    lam = (-(X_PARAM * X_PARAM)) % R_ORDER
    g1 = g1_generator()
    phi_g = g1._make(hf.Fq(beta) * g1.x, g1.y, g1.z)
    if phi_g != g1.mul(lam):
        beta = pow(beta, 2, P_INT)
        phi_g = g1._make(hf.Fq(beta) * g1.x, g1.y, g1.z)
        assert phi_g == g1.mul(lam), "G1 endomorphism eigenvalue mismatch"
    base = hf.Fq2(1, 1)
    cx = base.pow((P_INT - 1) // 3).inv()
    cy = base.pow((P_INT - 1) // 2).inv()
    g2 = g2_generator()
    gx, gy = g2.affine()
    assert _host_psi(gx, gy, cx, cy) == g2.mul((-X_PARAM) % R_ORDER), "psi(Q) != [x]Q on the G2 generator"
    return beta, lam, cx, cy


_BETA_INT, _LAMBDA_INT, _PSI_CX, _PSI_CY = _compute_endo_constants()
_BETA_MONT = tower.fq_to_limbs_mont(_BETA_INT)
_PSI_CX_MONT = tower.fq2_to_limbs_mont(_PSI_CX)
_PSI_CY_MONT = tower.fq2_to_limbs_mont(_PSI_CY)
_PSI2_CX_MONT = tower.fq2_to_limbs_mont(_PSI_CX.conjugate() * _PSI_CX)
_PSI2_CY_MONT = tower.fq2_to_limbs_mont(_PSI_CY.conjugate() * _PSI_CY)


def psi(pt):
    """Twist-Frobenius endomorphism on G2 Jacobian lanes:
    (X, Y, Z) -> (conj(X)*cx, conj(Y)*cy, conj(Z))."""
    x, y, z = pt
    dev = x.device
    xo = tower.fq2_mul(tower.fq2_conj(x), fq.const(_PSI_CX_MONT, dev))
    yo = tower.fq2_mul(tower.fq2_conj(y), fq.const(_PSI_CY_MONT, dev))
    return (xo, yo, tower.fq2_conj(z))


def psi2(pt):
    """psi applied twice: conjugations cancel; constants fold."""
    x, y, z = pt
    dev = x.device
    return (tower.fq2_mul(x, fq.const(_PSI2_CX_MONT, dev)), tower.fq2_mul(y, fq.const(_PSI2_CY_MONT, dev)), z)


def g1_subgroup_mask(pt):
    """Scott G1 test: phi(P) + [x^2]P == infinity (lambda = -x^2).
    Infinity is accepted; callers reject infinity pubkeys separately."""
    x, y, z = pt
    phi_pt = (fq.mul(x, fq.const(_BETA_MONT, x.device)), y, z)
    x2p = scalar_mul_static(FQ, scalar_mul_static(FQ, pt, X_PARAM), X_PARAM)
    s = jac_add(FQ, phi_pt, x2p)
    return jac_is_infinity(FQ, s) | jac_is_infinity(FQ, pt)


def g2_subgroup_mask(pt):
    """Scott G2 test: psi(Q) == [x]Q = -[|x|]Q. Infinity accepted."""
    xq = jac_neg(FQ2, scalar_mul_static(FQ2, pt, X_PARAM))
    return jac_eq(FQ2, psi(pt), xq) | jac_is_infinity(FQ2, pt)


# -- batched decompression ---------------------------------------------------

_B2_MONT = tower.fq2_to_limbs_mont(hf.Fq2(4, 4))
_B1_MONT = tower.fq_to_limbs_mont(4)


def g2_decompress(x_limbs_mont, s_flags):
    """Batched G2 decompression from field-valid x coordinates:
    x (..., 2, 32) Montgomery, s_flags (...,) bool (the S sign bit).
    Returns (qx, qy, on_curve_mask, subgroup_mask) with qy sign-selected
    per the ZCash rule (curve.py:221-243). Host callers pre-parse bytes
    and pre-reject C/I flag violations and x >= p."""
    x = x_limbs_mont
    y2 = fq.add(tower.fq2_mul(x, tower.fq2_square(x)), fq.const(_B2_MONT, x.device))
    y, on_curve = fq2_sqrt(y2)
    flip = fq2_lex_gt_half(y) != s_flags
    y = FQ2.where(flip, fq.neg(y), y)
    in_subgroup = g2_subgroup_mask((x, y, FQ2.one(y.shape[:-2], y.device)))
    return x, y, on_curve, in_subgroup


def g1_decompress(x_limbs_mont, s_flags):
    """Batched G1 decompression: x (..., 32) Montgomery, s_flags (...,)
    bool. Returns (px, py, on_curve_mask, subgroup_mask)."""
    x = x_limbs_mont
    y2 = fq.add(fq.mul(x, fq.mul(x, x)), fq.const(_B1_MONT, x.device))
    y, on_curve = fq_sqrt(y2)
    flip = fq_lex_gt_half(y) != s_flags
    y = FQ.where(flip, fq.neg(y), y)
    in_subgroup = g1_subgroup_mask((x, y, FQ.one(y.shape[:-1], y.device)))
    return x, y, on_curve, in_subgroup


# -- host conversion helpers -------------------------------------------------

def host_point_to_jac_limbs(pt) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host Point -> Montgomery Jacobian limb triple (G1 or G2 inferred
    from the coordinate field: Fq is an int, Fq2 a pair)."""
    is_g2 = not isinstance(pt.x, int)
    conv = tower.fq2_to_limbs_mont if is_g2 else (lambda v: tower.fq_to_limbs_mont(int(v)))
    one = conv(hf.Fq2(1, 0)) if is_g2 else conv(1)
    if pt.is_infinity:
        return one, one.copy(), np.zeros_like(one)
    x, y = pt.affine()
    return conv(x), conv(y), one


def jac_limbs_to_host_point(x, y, z, g2: bool):
    """Montgomery Jacobian limbs (arrays or tensors) -> host Point."""
    from ..crypto.bls.curve import g1_infinity, g1_point, g2_infinity, g2_point

    xa, ya, za = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in (x, y, z))
    if g2:
        if not za.any():
            return g2_infinity()
        pt = g2_point(*(hf.Fq2(tower.limbs_to_int(v[0]), tower.limbs_to_int(v[1])) for v in (xa, ya)))
        pt.z = hf.Fq2(tower.limbs_to_int(za[0]), tower.limbs_to_int(za[1]))
        return pt
    if not za.any():
        return g1_infinity()
    pt = g1_point(hf.Fq(tower.limbs_to_int(xa)), hf.Fq(tower.limbs_to_int(ya)))
    pt.z = hf.Fq(tower.limbs_to_int(za))
    return pt

