"""BLS12-381 field tower: Fq, Fq2, Fq6, Fq12 (host reference implementation).

Replaces the reference's py_ecc dependency (utils/bls.py:8-9) — py_ecc is
not vendored here; this is an independent implementation from the curve
parameters. Serves as the correctness oracle and as the host BLS path.

Tower construction (standard BLS12-381):
  Fq2  = Fq[u]  / (u^2 + 1)
  Fq6  = Fq2[v] / (v^3 - (u + 1))
  Fq12 = Fq6[w] / (w^2 - v)
"""
from __future__ import annotations

# Base field modulus
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Subgroup order
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (the curve is parameterized by x; x is negative: value below is |x|)
X = 0xD201000000010000  # |x|; x = -0xd201000000010000


def fq_inv(a: int) -> int:
    return pow(a, P - 2, P)


class Fq(int):
    """Base-field element with the same operator interface as Fq2 (so the
    curve layer is generic over the coordinate field)."""

    def __new__(cls, v: int):
        return super().__new__(cls, v % P)

    def __add__(self, o):
        return Fq(int(self) + int(o))

    def __sub__(self, o):
        return Fq(int(self) - int(o))

    def __neg__(self):
        return Fq(-int(self))

    def __mul__(self, o):
        return Fq(int(self) * int(o))

    __rmul__ = __mul__

    def square(self):
        return Fq(int(self) * int(self))

    def inv(self):
        return Fq(fq_inv(int(self)))

    def conjugate(self):
        return self

    def is_zero(self):
        return int(self) == 0

    def sgn0(self) -> int:
        return int(self) % 2

    def pow(self, e: int) -> "Fq":
        return Fq(pow(int(self), e, P))

    def sqrt(self):
        """p ≡ 3 (mod 4): candidate a^((p+1)/4)."""
        c = Fq(pow(int(self), (P + 1) // 4, P))
        return c if c.square() == self else None


FQ_ZERO = Fq(0)
FQ_ONE = Fq(1)


class Fq2(tuple):
    """a + b*u with u^2 = -1; stored as (a, b)."""

    def __new__(cls, a: int, b: int):
        return super().__new__(cls, (a % P, b % P))

    @property
    def c0(self):
        return self[0]

    @property
    def c1(self):
        return self[1]

    def __add__(self, o):
        return Fq2(self[0] + o[0], self[1] + o[1])

    def __sub__(self, o):
        return Fq2(self[0] - o[0], self[1] - o[1])

    def __neg__(self):
        return Fq2(-self[0], -self[1])

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self[0] * o, self[1] * o)
        a0, a1 = self
        b0, b1 = o
        t0 = a0 * b0
        t1 = a1 * b1
        return Fq2(t0 - t1, (a0 + a1) * (b0 + b1) - t0 - t1)

    __rmul__ = __mul__

    def square(self):
        a0, a1 = self
        return Fq2((a0 + a1) * (a0 - a1), 2 * a0 * a1)

    def inv(self):
        a0, a1 = self
        t = fq_inv((a0 * a0 + a1 * a1) % P)
        return Fq2(a0 * t, -a1 * t)

    def conjugate(self):
        return Fq2(self[0], -self[1])

    def mul_by_nonresidue(self):
        """* (u + 1), the Fq6 nonresidue."""
        a0, a1 = self
        return Fq2(a0 - a1, a0 + a1)

    def is_zero(self):
        return self[0] == 0 and self[1] == 0

    def sgn0(self) -> int:
        """RFC 9380 sign: sign of the least coefficient that is nonzero."""
        s0 = self[0] % 2
        z0 = self[0] == 0
        s1 = self[1] % 2
        return s0 | (z0 & s1)

    def pow(self, e: int) -> "Fq2":
        result = FQ2_ONE
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def sqrt(self):
        """Square root via p^2 = 9 (mod 16) addition chain (standard for Fq2);
        returns None if not a QR."""
        # For Fq2 with p = 3 mod 4: candidate = a^((p^2+7)/16) won't apply;
        # use the simple approach: a^((p^2+7)/16)*c trick is complex — use
        # the generic Tonelli-Shanks over Fq2 via the norm map instead.
        a = self
        if a.is_zero():
            return a
        # alpha = a^((p-3)/4-ish) method (Adj-Rodriguez): works for p = 3 mod 4
        # candidate x = a^((p+1)/4) in Fq2 computed via exponent (p^2+7)/16? —
        # Instead use: sqrt in Fq2 for p ≡ 3 (mod 4):
        #   a1 = a^((p-3)/4); x0 = a1*a; alpha = a1*x0
        #   if alpha == -1: x = i*x0 ; else x = (1+alpha)^((p-1)/2) * x0
        a1 = a.pow((P - 3) // 4)
        x0 = a1 * a
        alpha = a1 * x0
        if alpha == Fq2(P - 1, 0):
            x = Fq2(0, 1) * x0
        else:
            b = (FQ2_ONE + alpha).pow((P - 1) // 2)
            x = b * x0
        if x.square() == a:
            return x
        return None


FQ2_ZERO = Fq2(0, 0)
FQ2_ONE = Fq2(1, 0)


class Fq6(tuple):
    """c0 + c1*v + c2*v^2 over Fq2 with v^3 = u + 1."""

    def __new__(cls, c0: Fq2, c1: Fq2, c2: Fq2):
        return super().__new__(cls, (c0, c1, c2))

    def __add__(self, o):
        return Fq6(self[0] + o[0], self[1] + o[1], self[2] + o[2])

    def __sub__(self, o):
        return Fq6(self[0] - o[0], self[1] - o[1], self[2] - o[2])

    def __neg__(self):
        return Fq6(-self[0], -self[1], -self[2])

    def __mul__(self, o):
        a0, a1, a2 = self
        b0, b1, b2 = o
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def square(self):
        return self * self

    def mul_by_nonresidue(self):
        """* v."""
        return Fq6(self[2].mul_by_nonresidue(), self[0], self[1])

    def inv(self):
        a0, a1, a2 = self
        t0 = a0.square() - (a1 * a2).mul_by_nonresidue()
        t1 = (a2.square()).mul_by_nonresidue() - a0 * a1
        t2 = a1.square() - a0 * a2
        factor = (a0 * t0 + (a2 * t1).mul_by_nonresidue() + (a1 * t2).mul_by_nonresidue()).inv()
        return Fq6(t0 * factor, t1 * factor, t2 * factor)

    def is_zero(self):
        return all(c.is_zero() for c in self)


FQ6_ZERO = Fq6(FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = Fq6(FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


class Fq12(tuple):
    """c0 + c1*w over Fq6 with w^2 = v."""

    def __new__(cls, c0: Fq6, c1: Fq6):
        return super().__new__(cls, (c0, c1))

    def __add__(self, o):
        return Fq12(self[0] + o[0], self[1] + o[1])

    def __sub__(self, o):
        return Fq12(self[0] - o[0], self[1] - o[1])

    def __mul__(self, o):
        a0, a1 = self
        b0, b1 = o
        t0 = a0 * b0
        t1 = a1 * b1
        return Fq12(t0 + t1.mul_by_nonresidue(), (a0 + a1) * (b0 + b1) - t0 - t1)

    def square(self):
        a0, a1 = self
        t0 = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_nonresidue()) - t0 - t0.mul_by_nonresidue()
        return Fq12(c0, t0 + t0)

    def inv(self):
        a0, a1 = self
        factor = (a0.square() - a1.square().mul_by_nonresidue()).inv()
        return Fq12(a0 * factor, -(a1 * factor))

    def conjugate(self):
        return Fq12(self[0], -self[1])

    def pow(self, e: int) -> "Fq12":
        result = FQ12_ONE
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius(self, power: int) -> "Fq12":
        """x -> x^(p^power) via precomputed coefficients."""
        f = self
        for _ in range(power % 12):
            f = _frobenius_once(f)
        return f

    def is_one(self):
        return self == FQ12_ONE


FQ12_ZERO = Fq12(FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = Fq12(FQ6_ONE, FQ6_ZERO)


# Frobenius: component-wise conjugation in Fq2 plus multiplication by
# gamma coefficients gamma_i = (u+1)^((p-1)*i/6).
def _compute_frob_coeffs():
    # (u+1)^((p-1)/6) in Fq2
    e = (P - 1) // 6
    base = Fq2(1, 1)
    g1 = base.pow(e)
    gammas = [FQ2_ONE]
    for _ in range(5):
        gammas.append(gammas[-1] * g1)
    return gammas


_GAMMAS = _compute_frob_coeffs()  # gamma^0..gamma^5


def _frobenius_once(f: Fq12) -> Fq12:
    c0, c1 = f
    # Fq6 components: (a0 + a1 v + a2 v^2) + (b0 + b1 v + b2 v^2) w
    a0, a1, a2 = c0
    b0, b1, b2 = c1
    # x^p: conjugate each Fq2 coeff, multiply coefficient of v^i w^j by gamma^(2i+j)
    a0 = a0.conjugate()
    a1 = a1.conjugate() * _GAMMAS[2]
    a2 = a2.conjugate() * _GAMMAS[4]
    b0 = b0.conjugate() * _GAMMAS[1]
    b1 = b1.conjugate() * _GAMMAS[3]
    b2 = b2.conjugate() * _GAMMAS[5]
    return Fq12(Fq6(a0, a1, a2), Fq6(b0, b1, b2))
