"""Batched optimal ate pairing on BLS12-381 limb tensors: the port of the
JAX package's ``ops/pairing_jax.py`` (the device analog of
``crypto/bls/pairing.py``).

- The Miller loop runs on the TWIST: T stays in Jacobian coordinates over
  Fq2, Q is affine on the twist, and P is a G1 affine point. Line values
  come out in the sparse form  l0 + l2*w^2 + l3*w^3  (l_i in Fq2):
    doubling, T=(X,Y,Z), at P=(px,py):
      l = (3X^3 - 2Y^2) - (3X^2 Z^2 px) w^2 + (2YZ^3 py) w^3
    mixed addition T+Q, Q=(qx,qy):
      l = (rr*qx - Z3*qy) - (rr*px) w^2 + (Z3*py) w^3,
      rr = 2(S2 - Y), Z3 = 2ZH
  Every scale factor is (Fq2 element) * w^k, which the final
  exponentiation kills, so the scaled Miller value final-exponentiates to
  the exact GT element of the host oracle.
- The loop walks the 63 bits of |x| (x = -0xd201000000010000; the
  trailing conjugation accounts for the sign). The doubling runs every
  bit, the mixed addition at the 5 set bits only (the bits are static;
  the JAX package ran both and masked).
- ``final_exponentiation``: the easy part, then the exact 1150-bit hard
  part, bit-identical GT values with the host oracle.
- ``final_exponentiation_fast``: the same ==1 decision from
  3*(p^4-p^2+1)/r = (x-1)^2 (x+p) (x^2+p^2-1) + 3, with every ^|x| done
  by Granger-Scott cyclotomic squarings.

The JAX package split these into staged jits only to bound XLA compile
time (pairing_jax.py:333-347, :367-373); here they are plain calls.
All functions broadcast over leading batch dims.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fq, tower

X_PARAM = 0xD201000000010000  # |x|; the BLS parameter is negative
_X_BITS = [int(b) for b in bin(X_PARAM)[3:]]

R_ORDER = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
_HARD_EXP = (fq.P_INT**4 - fq.P_INT**2 + 1) // R_ORDER
_HARD_BITS = [(_HARD_EXP >> i) & 1 for i in range(_HARD_EXP.bit_length() - 1, -1, -1)]


def _line_fq12(l0, l2, l3):
    """Sparse line (l0 + l2 w^2 + l3 w^3) -> full Fq12 limbs: w^2 = v lands
    l2 in the v-slot of the even Fq6; w^3 = v*w lands l3 in the v-slot of
    the odd Fq6."""
    zero = torch.zeros_like(l0)
    return torch.stack([torch.stack([l0, l2, zero], dim=-3), torch.stack([zero, l3, zero], dim=-3)], dim=-4)


def _fq2_stack_mul(pairs):
    """One batched fq2 multiply over a list of pairs; returns a list."""
    xs = torch.stack(torch.broadcast_tensors(*(x for x, _ in pairs)))
    ys = torch.stack(torch.broadcast_tensors(*(y for _, y in pairs)))
    return list(tower.fq2_mul(xs, ys).unbind(0))


def _doubling_step(f, X, Y, Z, px_s, py_s):
    """T -> 2T and f -> f * l_{T,T}(P)."""
    A, B, YZ, ZZ = _fq2_stack_mul([(X, X), (Y, Y), (Y, Z), (Z, Z)])
    E = tower.muln(A, 3)
    XB = fq.add(X, B)
    C, T1, F, EZZ, EX = _fq2_stack_mul([(B, B), (XB, XB), (E, E), (E, ZZ), (E, X)])
    D = tower.double(fq.sub(T1, fq.add(A, C)))
    X2t = fq.sub(F, tower.double(D))
    Z2t = tower.double(YZ)
    EDX, Z3ZZ = _fq2_stack_mul([(E, fq.sub(D, X2t)), (Z2t, ZZ)])
    Y2t = fq.sub(EDX, tower.muln(C, 8))
    l0 = fq.sub(EX, tower.double(B))
    sc = fq.mul(torch.stack([EZZ, Z3ZZ]), torch.stack(torch.broadcast_tensors(px_s, py_s)))
    f = tower.fq12_mul(f, _line_fq12(l0, fq.neg(sc[0]), sc[1]))
    return f, X2t, Y2t, Z2t


def _addition_step(f, X, Y, Z, qx, qy, px_s, py_s):
    """T -> T + Q (Q affine) and f -> f * l_{T,Q}(P)."""
    (Z1Z1,) = _fq2_stack_mul([(Z, Z)])
    U2, ZZZ = _fq2_stack_mul([(qx, Z1Z1), (Z1Z1, Z)])
    H = fq.sub(U2, X)
    HH, S2, ZH = _fq2_stack_mul([(H, H), (qy, ZZZ), (Z, H)])
    rr = tower.double(fq.sub(S2, Y))
    I = tower.muln(HH, 4)
    Z3 = tower.double(ZH)
    J, V, rr2 = _fq2_stack_mul([(H, I), (X, I), (rr, rr)])
    X3 = fq.sub(rr2, fq.add(J, tower.double(V)))
    rVX, YJ, rqx, Zqy = _fq2_stack_mul([(rr, fq.sub(V, X3)), (Y, J), (rr, qx), (Z3, qy)])
    Y3 = fq.sub(rVX, tower.double(YJ))
    l0 = fq.sub(rqx, Zqy)
    sc = fq.mul(torch.stack([rr, Z3]), torch.stack(torch.broadcast_tensors(px_s, py_s)))
    f = tower.fq12_mul(f, _line_fq12(l0, fq.neg(sc[0]), sc[1]))
    return f, X3, Y3, Z3


def miller_loop(px, py, qx, qy, active):
    """f_{x,Q}(P) for batches: px/py (..., 32) Montgomery G1 affine,
    qx/qy (..., 2, 32) Montgomery twist-affine G2, active (...,) bool.
    Inactive lanes (either point at infinity) return 1, matching the host
    oracle (crypto/bls/pairing.py:62-63)."""
    dev = px.device
    one12 = tower.fq12_one(px.shape[:-1], dev)
    px_s = px.unsqueeze(-2)  # broadcast as fq2-component scalar
    py_s = py.unsqueeze(-2)
    f, X, Y, Z = one12, qx, qy, fq.const(tower.ONE2, dev).expand(qx.shape)
    for bit in _X_BITS:
        f = tower.fq12_square(f)
        f, X, Y, Z = _doubling_step(f, X, Y, Z, px_s, py_s)
        if bit:
            f, X, Y, Z = _addition_step(f, X, Y, Z, qx, qy, px_s, py_s)
    f = tower.fq12_conjugate(f)  # x < 0 (crypto/bls/pairing.py:89-90)
    return torch.where(active[..., None, None, None, None], f, one12)


def _tree_product(f):
    """Product over the pair axis (-5) by a log-depth tree (odd levels
    padded with 1)."""
    while f.shape[-5] > 1:
        if f.shape[-5] % 2:
            f = torch.cat([f, tower.fq12_one(f.shape[:-5] + (1,), f.device)], dim=-5)
        f = tower.fq12_mul(f[..., 0::2, :, :, :, :], f[..., 1::2, :, :, :, :])
    return f[..., 0, :, :, :, :]


def final_exponentiation(f):
    """f^((p^12-1)/r), exact-match with the host oracle
    (crypto/bls/pairing.py:96-102)."""
    f = tower.fq12_mul(tower.fq12_conjugate(f), tower.fq12_inv(f))
    f = tower.fq12_mul(tower.fq12_frobenius_p2(f), f)
    return tower.fq12_pow_bits(f, _HARD_BITS)


def pairing_product(px, py, qx, qy, active):
    """prod_k e_miller(P_k, Q_k) over the LAST leading axis, one shared
    final exponentiation: px/py (..., K, 32); qx/qy (..., K, 2, 32);
    active (..., K). Returns GT limbs (..., 2, 3, 2, 32)."""
    return final_exponentiation(_tree_product(miller_loop(px, py, qx, qy, active)))


# -- fast final exponentiation (boolean-check path) ---------------------------

def _compute_frob_p1_consts() -> np.ndarray:
    """Frobenius^1 coefficients: coeff of v^i w^j maps to conj * gamma^(2i+j),
    gamma = (u+1)^((p-1)/6) (host fields.py:287-313)."""
    from ..crypto.bls import fields as hf

    g1 = hf.Fq2(1, 1).pow((fq.P_INT - 1) // 6)
    gam = [hf.FQ2_ONE]
    for _ in range(5):
        gam.append(gam[-1] * g1)
    out = np.zeros((2, 3, 2, fq.N_LIMBS), dtype=np.int32)
    for j in range(2):
        for i in range(3):
            out[j, i] = tower.fq2_to_limbs_mont(gam[2 * i + j])
    return out


FROB_P1 = _compute_frob_p1_consts()


def fq12_frobenius_p1(a):
    """a^p: conjugate every Fq2 coefficient, then per-component gamma."""
    return tower.fq2_mul(tower.fq2_conj(a), fq.const(FROB_P1, a.device))


def cyclotomic_square(a):
    """Granger-Scott squaring for elements of the cyclotomic subgroup
    (anything after the easy part): 9 Fq2 squarings in one stacked call.
    Layout: a = (a0 + a1 v + a2 v^2) + (b0 + b1 v + b2 v^2) w."""
    a0, a1, a2 = a[..., 0, 0, :, :], a[..., 0, 1, :, :], a[..., 0, 2, :, :]
    b0, b1, b2 = a[..., 1, 0, :, :], a[..., 1, 1, :, :], a[..., 1, 2, :, :]
    s1, s2, s3 = tower.add_many([(b1, a0), (a2, b0), (b2, a1)])
    sq = tower.fq2_square(torch.stack([b1, a0, s1, a2, b0, s2, b2, a1, s3]))
    t0, t1, t2, t3, t4, t5 = sq[0], sq[1], sq[3], sq[4], sq[6], sq[7]
    u01, u23, u45 = tower.add_many([(t0, t1), (t2, t3), (t4, t5)])
    t6, t7, t8n = tower.sub_many([(sq[2], u01), (sq[5], u23), (sq[8], u45)])  # 2 a0 b1, 2 a2 b0, 2 a1 b2
    t8 = tower.fq2_mul_nonresidue(t8n)
    nr = tower.fq2_mul_nonresidue(torch.stack([t0, t2, t4]))
    e0, e2, e4 = tower.add_many([(nr[0], t1), (nr[1], t3), (nr[2], t5)])  # b1^2 xi + a0^2, ...
    d = tower.sub_many([(e0, a0), (e2, a1), (e4, a2)])
    s = tower.add_many([(t8, b0), (t6, b1), (t7, b2)])
    dd = tower.double(torch.stack(d + s))
    z = tower.add_many([(dd[0], e0), (dd[1], e2), (dd[2], e4), (dd[3], t8), (dd[4], t6), (dd[5], t7)])
    even = torch.stack(z[:3], dim=-3)
    odd = torch.stack(z[3:], dim=-3)
    return torch.stack([even, odd], dim=-4)


def _x_runs() -> list:
    """|x| MSB-first zero-run structure between set bits (Hamming weight 6:
    63 cyclotomic squarings + 5 multiplies)."""
    runs, cur = [], 0
    for ch in bin(X_PARAM)[3:]:
        if ch == "0":
            cur += 1
        else:
            runs.append(cur)
            cur = 0
    runs.append(cur)
    return runs


_X_RUNS = _x_runs()


def cyclotomic_exp_x_abs(f):
    """f^|x| for cyclotomic f: runs of Granger-Scott squarings with the 5
    set-bit multiplies between them."""
    acc = f
    for run in _X_RUNS[:-1]:
        for _ in range(run):
            acc = cyclotomic_square(acc)
        acc = tower.fq12_mul(cyclotomic_square(acc), f)
    for _ in range(_X_RUNS[-1]):
        acc = cyclotomic_square(acc)
    return acc


def _fe_easy_part(f):
    """f^((p^6-1)(p^2+1)) — lands in the cyclotomic subgroup."""
    f = tower.fq12_mul(tower.fq12_conjugate(f), tower.fq12_inv(f))
    return tower.fq12_mul(tower.fq12_frobenius_p2(f), f)


def _fe_conj_mul(e, t):
    """conj(e * t) — the f^(x-1) combiner (x < 0)."""
    return tower.fq12_conjugate(tower.fq12_mul(e, t))


def _fe_x_plus_p(e, t):
    """t^(x+p) given e = t^|x|: conj(e) * t^p."""
    return tower.fq12_mul(tower.fq12_conjugate(e), fq12_frobenius_p1(t))


def _fe_combine(t3, m1, f):
    """t3 * m1^(p^2) * conj(m1) * f^3 — the closing glue."""
    out = tower.fq12_mul(t3, tower.fq12_mul(tower.fq12_frobenius_p2(m1), tower.fq12_conjugate(m1)))
    f3 = tower.fq12_mul(cyclotomic_square(f), f)
    return tower.fq12_mul(out, f3)


def final_exponentiation_fast(f):
    """f^(3*(p^12-1)/r) — the same ==1 decision as the exact exponent:
      3*(p^4-p^2+1)/r = (x-1)^2 (x+p) (x^2+p^2-1) + 3,  x < 0
    with f^(x-1) = conj(f^|x| * f) for cyclotomic f."""
    f = _fe_easy_part(f)
    t0 = _fe_conj_mul(cyclotomic_exp_x_abs(f), f)
    t1 = _fe_conj_mul(cyclotomic_exp_x_abs(t0), t0)
    m1 = _fe_x_plus_p(cyclotomic_exp_x_abs(t1), t1)
    t3 = cyclotomic_exp_x_abs(cyclotomic_exp_x_abs(m1))
    return _fe_combine(t3, m1, f)


def miller_reduce(px, py, qx, qy, active):
    """Miller loops plus the tree product over the pair axis, no final
    exponentiation."""
    return _tree_product(miller_loop(px, py, qx, qy, active))


def pairing_check_fast(px, py, qx, qy, active):
    """Batched product-of-pairings == 1 via the fast exponent — the
    decision path of the BLS backend."""
    return tower.fq12_is_one(final_exponentiation_fast(miller_reduce(px, py, qx, qy, active)))
