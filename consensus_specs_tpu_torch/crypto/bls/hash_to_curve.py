"""Hash-to-curve for BLS signatures: BLS12381G2_XMD:SHA-256_SSWU_RO (RFC 9380).

Pipeline: expand_message_xmd (SHA-256) → hash_to_field (two Fq2 elements)
→ simplified SWU on the 3-isogenous curve E2' → isogeny map to E2 →
cofactor clearing with h_eff. The isogeny coefficients are validated by
tests/test_bls.py::test_hash_to_curve_on_curve (a wrong constant throws
points off the curve with overwhelming probability).
"""
from __future__ import annotations

import hashlib
from typing import List, Tuple

from .curve import Point, g2_point
from .fields import FQ2_ONE, Fq2, P

# eth2 ciphersuite DST (proof-of-possession scheme)
DST_G2_POP = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# --- expand_message_xmd (RFC 9380 §5.3.1) ----------------------------------

_B_IN_BYTES = 32  # SHA-256 output
_S_IN_BYTES = 64  # SHA-256 block


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (len_in_bytes + _B_IN_BYTES - 1) // _B_IN_BYTES
    if ell > 255:
        raise ValueError("expand_message_xmd: requested length too large")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * _S_IN_BYTES
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [b1]
    for i in range(2, ell + 1):
        prev = out[-1]
        xored = bytes(a ^ b for a, b in zip(b0, prev))
        out.append(hashlib.sha256(xored + i.to_bytes(1, "big") + dst_prime).digest())
    return b"".join(out)[:len_in_bytes]


# --- hash_to_field (RFC 9380 §5.2): m=2 (Fq2), L=64 ------------------------

_L = 64


def hash_to_field_fq2(msg: bytes, count: int, dst: bytes = DST_G2_POP) -> List[Fq2]:
    uniform = expand_message_xmd(msg, dst, count * 2 * _L)
    out = []
    for i in range(count):
        coeffs = []
        for j in range(2):
            off = _L * (j + i * 2)
            coeffs.append(int.from_bytes(uniform[off : off + _L], "big") % P)
        out.append(Fq2(coeffs[0], coeffs[1]))
    return out


# --- simplified SWU on E2': y^2 = x^3 + A'x + B' ---------------------------

_A = Fq2(0, 240)
_B = Fq2(1012, 1012)
_Z = Fq2(-2, -1)  # -(2 + u)


def _is_square(a: Fq2) -> bool:
    # a is a QR in Fq2 iff its norm a*conj(a) = c0^2 + c1^2 is a QR in Fq
    norm = (a.c0 * a.c0 + a.c1 * a.c1) % P
    return norm == 0 or pow(norm, (P - 1) // 2, P) == 1


def map_to_curve_simple_swu(u: Fq2) -> Tuple[Fq2, Fq2]:
    """RFC 9380 §6.6.2 (non-constant-time variant); returns a point on E2'."""
    u2 = u.square()
    tv1 = _Z * u2
    tv2 = tv1.square() + tv1
    if tv2.is_zero():
        x1 = _B * (_Z * _A).inv()  # x = B / (Z * A)
    else:
        x1 = (-_B) * _A.inv() * (FQ2_ONE + tv2.inv())
    gx1 = x1 * x1.square() + _A * x1 + _B
    if _is_square(gx1):
        x, y = x1, gx1.sqrt()
    else:
        x2 = tv1 * x1
        gx2 = x2 * x2.square() + _A * x2 + _B
        x, y = x2, gx2.sqrt()
    if y is None:  # cannot happen for consistent constants
        raise ArithmeticError("SSWU: no square root found")
    if u.sgn0() != y.sgn0():
        y = -y
    return x, y


# --- 3-isogeny E2' -> E2 (RFC 9380 Appendix E.3) ---------------------------

_XNUM = [
    Fq2(
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
        0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
    ),
    Fq2(0, 0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A),
    Fq2(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D,
    ),
    Fq2(0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1, 0),
]
_XDEN = [
    Fq2(0, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63),
    Fq2(0xC, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F),
    Fq2(1, 0),
]
_YNUM = [
    Fq2(
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
        0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
    ),
    Fq2(0, 0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE),
    Fq2(
        0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
        0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F,
    ),
    Fq2(0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10, 0),
]
_YDEN = [
    Fq2(
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
        0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
    ),
    Fq2(0, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3),
    Fq2(0x12, 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99),
    Fq2(1, 0),
]


def _horner(coeffs: List[Fq2], x: Fq2) -> Fq2:
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def iso_map_g2(x: Fq2, y: Fq2) -> Tuple[Fq2, Fq2]:
    x_num = _horner(_XNUM, x)
    x_den = _horner(_XDEN, x)
    y_num = _horner(_YNUM, x)
    y_den = _horner(_YDEN, x)
    xo = x_num * x_den.inv()
    yo = y * y_num * y_den.inv()
    return xo, yo


# --- cofactor clearing -----------------------------------------------------

# RFC 9380 §8.8.2 h_eff for G2
H_EFF = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551

# psi-endomorphism decomposition (Budroni–Pintore): on E'(Fq2),
#   [h_eff]Q == [x^2-x-1]Q + [x-1]psi(Q) + psi2([2]Q)
# with the (negative) BLS parameter x = -X_ABS. Two 64-bit ladders
# instead of one 636-bit ladder (~4x fewer point ops); the exact
# equality with the RFC h_eff ladder is pinned by
# tests/test_bls.py::test_clear_cofactor_psi_equals_h_eff and by the
# RFC 9380 G2 suite known-answer vectors.
X_ABS = 0xD201000000010000

# psi(x, y) = (conj(x)*PSI_CX, conj(y)*PSI_CY) with the twist constants
# (u+1)^-((p-1)/3), (u+1)^-((p-1)/2).
_PSI_CX = Fq2(1, 1).pow((P - 1) // 3).inv()
_PSI_CY = Fq2(1, 1).pow((P - 1) // 2).inv()
_PSI2_CX = _PSI_CX.conjugate() * _PSI_CX
_PSI2_CY = _PSI_CY.conjugate() * _PSI_CY


def psi(p: Point) -> Point:
    """Twist-Frobenius endomorphism on Jacobian coords: conjugation
    commutes with the Jacobian scaling, so conjugate all three
    coordinates and apply the affine constants to X and Y."""
    return p._make(
        p.x.conjugate() * _PSI_CX,
        p.y.conjugate() * _PSI_CY,
        p.z.conjugate(),
    )


def psi2(p: Point) -> Point:
    """psi twice: the conjugations cancel, the constants fold."""
    return p._make(p.x * _PSI2_CX, p.y * _PSI2_CY, p.z)


def _mul_by_x(p: Point) -> Point:
    """[x]P for the negative BLS parameter: -[|x|]P."""
    return p.mul(X_ABS).neg()


def clear_cofactor(p: Point) -> Point:
    # [x^2-x-1]Q + [x-1]psi(Q) + psi2(2Q)
    #   = psi2(2Q) + [x](t1 + t2) - t1 - t2 - Q,  t1 = [x]Q, t2 = psi(Q)
    t1 = _mul_by_x(p)
    t2 = psi(p)
    acc = psi2(p.double()).add(_mul_by_x(t1.add(t2)))
    acc = acc.add(t1.neg()).add(t2.neg())
    return acc.add(p.neg())


# --- top level --------------------------------------------------------------


def map_to_curve_g2(u: Fq2) -> Point:
    x, y = map_to_curve_simple_swu(u)
    xo, yo = iso_map_g2(x, y)
    return g2_point(xo, yo)


def hash_to_g2(msg: bytes, dst: bytes = DST_G2_POP) -> Point:
    u0, u1 = hash_to_field_fq2(msg, 2, dst)
    q = map_to_curve_g2(u0).add(map_to_curve_g2(u1))
    return clear_cofactor(q)
