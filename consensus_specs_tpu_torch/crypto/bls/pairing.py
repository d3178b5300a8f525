"""Optimal ate pairing on BLS12-381 (host reference implementation).

e(P, Q) for P in G1, Q in G2. Miller loop over |x| = 0xd201000000010000
(x negative → conjugate at the end), final exponentiation split into the
easy part and a naive hard-part pow (the oracle favors obvious correctness).

Multi-pairing (`pairing_product`) shares one final exponentiation across
all pairs — the shape both `Verify` (2 pairs) and `AggregateVerify`
(n+1 pairs) reduce to.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from .curve import Point
from .fields import FQ12_ONE, Fq2, Fq6, Fq12, FQ2_ONE, FQ2_ZERO, FQ6_ZERO, P, R, X

# |x|, bits MSB-first (skip leading 1)
_X_BITS = [int(b) for b in bin(X)[3:]]


def _fq2_to_fq12(a: Fq2) -> Fq12:
    return Fq12(Fq6(a, FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


# w ∈ Fq12 with w^2 = v, w^6 = (u+1). Embedding of G2 (on the twist
# E': y^2 = x^3 + 4(u+1)) into E(Fq12): (x, y) -> (x / w^2, y / w^3).
_W2 = Fq12(Fq6(FQ2_ZERO, FQ2_ONE, FQ2_ZERO), FQ6_ZERO)  # w^2 = v
_W3 = Fq12(FQ6_ZERO, Fq6(FQ2_ZERO, FQ2_ONE, FQ2_ZERO))  # w^3 = v*w
_W2_INV = _W2.inv()
_W3_INV = _W3.inv()


def _g2_to_fq12(q: Point) -> Tuple[Fq12, Fq12]:
    x, y = q.affine()
    return _fq2_to_fq12(x) * _W2_INV, _fq2_to_fq12(y) * _W3_INV


def _line(t_x: Fq12, t_y: Fq12, q_x: Fq12, q_y: Fq12, p_x: int, p_y: int) -> Fq12:
    """Evaluate the line through embedded points T and Q at the G1 point
    (p_x, p_y). T == Q → tangent line. Works in Fq12 affine coordinates —
    clear but slow; fine for the oracle."""
    one = FQ12_ONE
    px12 = Fq12(Fq6(Fq2(p_x, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)
    py12 = Fq12(Fq6(Fq2(p_y, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)
    if t_x == q_x and t_y == q_y:
        # tangent: slope = 3x^2 / 2y
        m = (t_x.square() * Fq12(Fq6(Fq2(3, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)) * (
            (t_y + t_y).inv()
        )
        return py12 - t_y - m * (px12 - t_x)
    if t_x == q_x:
        # vertical line
        return px12 - t_x
    m = (q_y - t_y) * ((q_x - t_x).inv())
    return py12 - t_y - m * (px12 - t_x)


def miller_loop(p: Point, q: Point) -> Fq12:
    """Miller loop f_{|x|,Q}(P); the caller conjugates for x < 0."""
    if p.is_infinity or q.is_infinity:
        return FQ12_ONE
    px, py = p.affine()
    px, py = int(px), int(py)
    qx, qy = _g2_to_fq12(q)
    # R tracked in embedded affine coordinates (group law in E(Fq12))
    rx, ry = qx, qy
    f = FQ12_ONE
    for bit in _X_BITS:
        f = f.square() * _line(rx, ry, rx, ry, px, py)
        # R = 2R (affine doubling in Fq12)
        m = (rx.square() * Fq12(Fq6(Fq2(3, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)) * ((ry + ry).inv())
        nx = m.square() - rx - rx
        ny = m * (rx - nx) - ry
        rx, ry = nx, ny
        if bit:
            f = f * _line(rx, ry, qx, qy, px, py)
            if rx == qx and ry == qy:
                m2 = (rx.square() * Fq12(Fq6(Fq2(3, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)) * ((ry + ry).inv())
            elif rx == qx:
                # R + Q = infinity can't occur mid-loop for subgroup points
                raise ArithmeticError("unexpected vertical addition in Miller loop")
            else:
                m2 = (qy - ry) * ((qx - rx).inv())
            nx = m2.square() - rx - qx
            ny = m2 * (rx - nx) - ry
            rx, ry = nx, ny
    # x < 0: f_{x,Q} = conjugate(f_{|x|,Q})  (since f^{p^6} inverts the loop sign)
    return f.conjugate()


_FINAL_EXP_HARD = (P**4 - P**2 + 1) // R


def final_exponentiation(f: Fq12) -> Fq12:
    """f^((p^12-1)/r): easy part by frobenius/conjugation, hard part naive."""
    # easy: f^(p^6 - 1) = conj(f) * f^-1 ; then ^(p^2 + 1)
    f = f.conjugate() * f.inv()
    f = f.frobenius(2) * f
    # hard: ^((p^4 - p^2 + 1)/r)
    return f.pow(_FINAL_EXP_HARD)


def pairing(p: Point, q: Point) -> Fq12:
    """Full pairing e(P, Q), P ∈ G1, Q ∈ G2."""
    return final_exponentiation(miller_loop(p, q))


def pairing_product(pairs: Sequence[Tuple[Point, Point]]) -> Fq12:
    """∏ e(P_i, Q_i) with a single shared final exponentiation."""
    f = FQ12_ONE
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f)


def pairings_equal(p1: Point, q1: Point, p2: Point, q2: Point) -> bool:
    """e(P1, Q1) == e(P2, Q2), via product with one negation."""
    return pairing_product([(p1.neg(), q1), (p2, q2)]).is_one()
