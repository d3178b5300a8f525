"""BLS12-381 group arithmetic: G1 (over Fq), G2 (over Fq2).

Jacobian coordinates; generic over the coordinate field (Fq / Fq2 share an
operator interface). Compressed serialization follows the ZCash/IETF format
used by eth2 (48-byte G1 pubkeys, 96-byte G2 signatures) with the
C/I/S flag bits in the top three bits of the first byte.
"""
from __future__ import annotations

from typing import Tuple

from .fields import FQ2_ONE, FQ2_ZERO, FQ_ONE, FQ_ZERO, Fq, Fq2, P, R

# Curve: y^2 = x^3 + 4   /   y^2 = x^3 + 4(u+1)
B1 = Fq(4)
B2 = Fq2(4, 4)

G1_X = Fq(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB)
G1_Y = Fq(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1)

G2_X = Fq2(
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_Y = Fq2(
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)


class Point:
    """Jacobian (X, Y, Z); Z=0 is the point at infinity."""

    __slots__ = ("x", "y", "z", "b", "one", "zero")

    def __init__(self, x, y, z, b, one, zero):
        self.x, self.y, self.z = x, y, z
        self.b, self.one, self.zero = b, one, zero

    @property
    def is_infinity(self) -> bool:
        return self.z.is_zero()

    def _make(self, x, y, z) -> "Point":
        return Point(x, y, z, self.b, self.one, self.zero)

    def infinity(self) -> "Point":
        return self._make(self.one, self.one, self.zero)

    def affine(self) -> Tuple:
        if self.is_infinity:
            return None
        zinv = self.z.inv()
        zinv2 = zinv.square()
        return (self.x * zinv2, self.y * (zinv2 * zinv))

    def double(self) -> "Point":
        if self.is_infinity:
            return self
        x, y, z = self.x, self.y, self.z
        a = x.square()
        b = y.square()
        c = b.square()
        d = ((x + b).square() - a - c) * 2
        e = a * 3
        f = e.square()
        x3 = f - d - d
        y3 = e * (d - x3) - c * 8
        z3 = (y * z) * 2
        return self._make(x3, y3, z3)

    def add(self, other: "Point") -> "Point":
        if self.is_infinity:
            return other
        if other.is_infinity:
            return self
        z1z1 = self.z.square()
        z2z2 = other.z.square()
        u1 = self.x * z2z2
        u2 = other.x * z1z1
        s1 = self.y * (z2z2 * other.z)
        s2 = other.y * (z1z1 * self.z)
        if u1 == u2:
            if s1 == s2:
                return self.double()
            return self.infinity()
        h = u2 - u1
        i = (h + h).square()
        j = h * i
        r = (s2 - s1) * 2
        v = u1 * i
        x3 = r.square() - j - v - v
        y3 = r * (v - x3) - (s1 * j) * 2
        z3 = ((self.z + other.z).square() - z1z1 - z2z2) * h
        return self._make(x3, y3, z3)

    def neg(self) -> "Point":
        return self._make(self.x, -self.y, self.z)

    def mul(self, k: int) -> "Point":
        if k < 0:
            return self.neg().mul(-k)
        acc = self.infinity()
        add = self
        while k:
            if k & 1:
                acc = acc.add(add)
            add = add.double()
            k >>= 1
        return acc

    def __eq__(self, other):
        if not isinstance(other, Point):
            return NotImplemented
        if self.is_infinity or other.is_infinity:
            return self.is_infinity and other.is_infinity
        z1z1 = self.z.square()
        z2z2 = other.z.square()
        return (
            self.x * z2z2 == other.x * z1z1
            and self.y * (z2z2 * other.z) == other.y * (z1z1 * self.z)
        )

    def __hash__(self):
        aff = self.affine()
        return hash(aff if aff is None else (aff[0], aff[1]))

    def on_curve(self) -> bool:
        if self.is_infinity:
            return True
        x, y = self.affine()
        return y.square() == x * x.square() + self.b

    def in_subgroup(self) -> bool:
        return self.mul(R).is_infinity


def g1_point(x: Fq, y: Fq) -> Point:
    return Point(x, y, FQ_ONE, B1, FQ_ONE, FQ_ZERO)


def g2_point(x: Fq2, y: Fq2) -> Point:
    return Point(x, y, FQ2_ONE, B2, FQ2_ONE, FQ2_ZERO)


def g1_generator() -> Point:
    return g1_point(G1_X, G1_Y)


def g2_generator() -> Point:
    return g2_point(G2_X, G2_Y)


def g1_infinity() -> Point:
    return g1_point(G1_X, G1_Y).infinity()


def g2_infinity() -> Point:
    return g2_point(G2_X, G2_Y).infinity()


# --- compressed serialization (ZCash format) --------------------------------

_C_FLAG = 0x80
_I_FLAG = 0x40
_S_FLAG = 0x20
_HALF_P = (P - 1) // 2


def _fq2_lex_gt_half(y: Fq2) -> bool:
    """Sign for G2: use c1 unless zero, then c0 (lexicographic on (c1, c0))."""
    if y.c1 != 0:
        return y.c1 > _HALF_P
    return y.c0 > _HALF_P


def g1_to_bytes(pt: Point) -> bytes:
    if pt.is_infinity:
        return bytes([_C_FLAG | _I_FLAG]) + b"\x00" * 47
    x, y = pt.affine()
    flags = _C_FLAG | (_S_FLAG if int(y) > _HALF_P else 0)
    out = bytearray(int(x).to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g2_to_bytes(pt: Point) -> bytes:
    if pt.is_infinity:
        return bytes([_C_FLAG | _I_FLAG]) + b"\x00" * 95
    x, y = pt.affine()
    flags = _C_FLAG | (_S_FLAG if _fq2_lex_gt_half(y) else 0)
    out = bytearray(x.c1.to_bytes(48, "big") + x.c0.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


class DeserializationError(ValueError):
    pass


def g1_from_bytes(data: bytes) -> Point:
    if len(data) != 48:
        raise DeserializationError(f"G1 compressed must be 48 bytes, got {len(data)}")
    flags = data[0]
    if not flags & _C_FLAG:
        raise DeserializationError("uncompressed G1 not supported")
    if flags & _I_FLAG:
        if any(data[1:]) or (flags & ~( _C_FLAG | _I_FLAG)):
            raise DeserializationError("malformed G1 infinity encoding")
        return g1_infinity()
    x_int = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x_int >= P:
        raise DeserializationError("G1 x not in field")
    x = Fq(x_int)
    y = (x * x.square() + B1).sqrt()
    if y is None:
        raise DeserializationError("G1 x not on curve")
    if (int(y) > _HALF_P) != bool(flags & _S_FLAG):
        y = -y
    return g1_point(x, y)


def g2_from_bytes(data: bytes) -> Point:
    if len(data) != 96:
        raise DeserializationError(f"G2 compressed must be 96 bytes, got {len(data)}")
    flags = data[0]
    if not flags & _C_FLAG:
        raise DeserializationError("uncompressed G2 not supported")
    if flags & _I_FLAG:
        if any(data[1:]) or (flags & ~(_C_FLAG | _I_FLAG)):
            raise DeserializationError("malformed G2 infinity encoding")
        return g2_infinity()
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise DeserializationError("G2 x not in field")
    x = Fq2(x0, x1)
    y = (x * x.square() + B2).sqrt()
    if y is None:
        raise DeserializationError("G2 x not on curve")
    if _fq2_lex_gt_half(y) != bool(flags & _S_FLAG):
        y = -y
    return g2_point(x, y)
