"""Batched hash-to-G2 on limb tensors: BLS12381G2_XMD:SHA-256_SSWU_RO_
(RFC 9380), the port of the JAX package's ``ops/h2c_jax.py``.

  host:   expand_message_xmd (a handful of SHA-256 calls per message, with
          hashlib) -> 2 x Fq2 field elements -> Montgomery limbs
  device: simplified SWU on E2' (branch-free, is-square select)
          -> 3-isogeny to E2 (Horner in Fq2, Jacobian output)
          -> pairwise add of the two mapped points
          -> cofactor clearing by the psi decomposition
             [x^2-x-1]Q + [x-1]psi(Q) + psi2(2Q)  (Budroni-Pintore),
             two 64-bit ladders instead of a 636-bit h_eff ladder
          -> batched affine conversion
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..crypto.bls import fields as hf
from ..crypto.bls.hash_to_curve import DST_G2_POP, _XDEN, _XNUM, _YDEN, _YNUM, expand_message_xmd
from . import curve_torch as cj, fq, tower

P_INT = fq.P_INT

# -- SSWU constants (E2': y^2 = x^3 + A x + B, Z = -(2 + u)) -----------------

_A_HOST = hf.Fq2(0, 240)
_B_HOST = hf.Fq2(1012, 1012)
_Z_HOST = hf.Fq2(-2, -1)

_A = tower.fq2_to_limbs_mont(_A_HOST)
_B = tower.fq2_to_limbs_mont(_B_HOST)
_Z = tower.fq2_to_limbs_mont(_Z_HOST)
# x1 branch constants: C1 = -B/A (generic), C2 = B/(Z*A) (tv2 == 0)
_C1 = tower.fq2_to_limbs_mont((-_B_HOST) * _A_HOST.inv())
_C2 = tower.fq2_to_limbs_mont(_B_HOST * (_Z_HOST * _A_HOST).inv())

_XNUM_L = [tower.fq2_to_limbs_mont(c) for c in _XNUM]
_XDEN_L = [tower.fq2_to_limbs_mont(c) for c in _XDEN]
_YNUM_L = [tower.fq2_to_limbs_mont(c) for c in _YNUM]
_YDEN_L = [tower.fq2_to_limbs_mont(c) for c in _YDEN]


def map_to_curve_sswu(u):
    """Simplified SWU, branch-free over (..., 2, 32) Montgomery Fq2 lanes;
    returns an affine point on E2' (never infinity) and the is-square mask
    of its y. Mirrors crypto/bls/hash_to_curve.py:75-95 lane-wise."""
    dev = u.device
    a, b = fq.const(_A, dev), fq.const(_B, dev)
    tv1 = tower.fq2_mul(fq.const(_Z, dev), tower.fq2_square(u))
    tv2 = fq.add(tower.fq2_square(tv1), tv1)
    tv2_zero = cj.FQ2.is_zero(tv2)
    one = cj.FQ2.one(u.shape[:-2], dev)
    inv_tv2 = tower.fq2_inv(tv2)  # 0 -> 0; masked below
    x1 = tower.fq2_mul(fq.const(_C1, dev), fq.add(one, inv_tv2))
    x1 = cj.FQ2.where(tv2_zero, fq.const(_C2, dev).expand(x1.shape), x1)
    x2 = tower.fq2_mul(tv1, x1)
    # g(x) = x^3 + A x + B for both candidates in one stack
    xs = torch.stack([x1, x2])
    gxs = fq.add(tower.fq2_mul(xs, tower.fq2_square(xs)), fq.add(tower.fq2_mul(a, xs), b))
    gx1, gx2 = gxs[0], gxs[1]
    sq1 = cj.fq2_is_square(gx1)
    x = cj.FQ2.where(sq1, x1, x2)
    gx = cj.FQ2.where(sq1, gx1, gx2)
    y, ok = cj.fq2_sqrt(gx)
    flip = cj.fq2_sgn0(u) != cj.fq2_sgn0(y)
    y = cj.FQ2.where(flip, fq.neg(y), y)
    return x, y, ok


def _horner(coeffs, x):
    acc = fq.const(coeffs[-1], x.device).expand(x.shape)
    for c in coeffs[-2::-1]:
        acc = fq.add(tower.fq2_mul(acc, x), fq.const(c, x.device))
    return acc


def iso_map_g2(x, y):
    """3-isogeny E2' -> E2 (hash_to_curve.py:147-154) emitting Jacobian
    coordinates directly — Z = xd*yd, X = xn*xd*yd^2, Y = y*yn*xd^3*yd^2
    — so no field inversion is needed."""
    xn = _horner(_XNUM_L, x)
    xd = _horner(_XDEN_L, x)
    yn = _horner(_YNUM_L, x)
    yd = _horner(_YDEN_L, x)
    z = tower.fq2_mul(xd, yd)
    yd2 = tower.fq2_square(yd)
    xd2 = tower.fq2_square(xd)
    X = tower.fq2_mul(xn, tower.fq2_mul(xd, yd2))
    Y = tower.fq2_mul(tower.fq2_mul(y, yn), tower.fq2_mul(tower.fq2_mul(xd2, xd), yd2))
    return (X, Y, z)


def _sswu_iso(u_pairs):
    """Stage 1: SSWU + isogeny on the flattened (2N,) u batch, then the
    per-message pair add -> Jacobian points (N,)."""
    n = u_pairs.shape[0]
    x, y, _ = map_to_curve_sswu(u_pairs.reshape(2 * n, 2, fq.N_LIMBS))
    X, Y, Z = (t.reshape(n, 2, 2, fq.N_LIMBS) for t in iso_map_g2(x, y))
    return cj.jac_add(cj.FQ2, (X[:, 0], Y[:, 0], Z[:, 0]), (X[:, 1], Y[:, 1], Z[:, 1]))


def _mul_by_x(p):
    """[x]P = -[|x|]P (negative BLS parameter)."""
    return cj.jac_neg(cj.FQ2, cj.scalar_mul_static(cj.FQ2, p, cj.X_PARAM))


def _cofactor_stage_a(qx, qy, qz):
    """t1 = [x]Q, t2 = psi(Q), s = psi2([2]Q) — one ladder."""
    q = (qx, qy, qz)
    return _mul_by_x(q), cj.psi(q), cj.psi2(cj.jac_double(cj.FQ2, q))


def _cofactor_stage_b(t1, t2):
    """m = [x](t1 + t2) — the second ladder."""
    return _mul_by_x(cj.jac_add(cj.FQ2, t1, t2))


def _cofactor_stage_c(q, t1, t2, s, m):
    """s + m - t1 - t2 - Q, then affine."""
    acc = cj.jac_add(cj.FQ2, s, m)
    acc = cj.jac_add(cj.FQ2, acc, cj.jac_neg(cj.FQ2, t1))
    acc = cj.jac_add(cj.FQ2, acc, cj.jac_neg(cj.FQ2, t2))
    acc = cj.jac_add(cj.FQ2, acc, cj.jac_neg(cj.FQ2, q))
    ax, ay, _inf = cj.jac_to_affine(cj.FQ2, acc)
    return ax, ay


def _cofactor_affine(qx, qy, qz):
    """Cofactor clearing + affine conversion."""
    t1, t2, s = _cofactor_stage_a(qx, qy, qz)
    m = _cofactor_stage_b(t1, t2)
    return _cofactor_stage_c((qx, qy, qz), t1, t2, s, m)


def hash_to_g2_affine(u_pairs):
    """(N, 2, 2, 32) u pairs -> affine (qx, qy), each (N, 2, 32). The
    hash of the eth2 DST is never infinity, so no mask is returned."""
    return _cofactor_affine(*_sswu_iso(u_pairs))


# -- host-side field derivation (a few SHA-256 per message) -------------------

_L = 64


def messages_to_field_limbs(messages: Sequence[bytes], dst: bytes = DST_G2_POP) -> np.ndarray:
    """(N,) messages -> (N, 2, 2, 32) Montgomery u-pair limb array
    (hash_to_field with count=2, RFC 9380 §5.2 / hash_to_curve.py:50-59)."""
    out = np.zeros((len(messages), 2, 2, fq.N_LIMBS), dtype=np.int32)
    for n, msg in enumerate(messages):
        uniform = expand_message_xmd(bytes(msg), dst, 2 * 2 * _L)
        for i in range(2):
            for j in range(2):
                off = _L * (j + i * 2)
                v = int.from_bytes(uniform[off : off + _L], "big") % P_INT
                out[n, i, j] = tower.fq_to_limbs_mont(v)
    return out


def hash_to_g2_batch(messages: Sequence[bytes], dst: bytes = DST_G2_POP, device=None):
    """Batched hash-to-G2: affine Montgomery limb tensors (qx, qy) of shape
    (N, 2, 32) on ``device`` (the card unless the CPU is asked for).
    The batch replacement for per-message host hash_to_g2
    (crypto/bls/hash_to_curve.py:219)."""
    u = torch.from_numpy(messages_to_field_limbs(messages, dst)).to(resolve_device(device))
    return hash_to_g2_affine(u)
