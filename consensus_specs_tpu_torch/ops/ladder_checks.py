"""The inputs that the static scalar ladders (K7 ``g1_mul_static``, K8
``g2_mul_static``, behind ``curve_torch.scalar_mul_static``) are checked
with, and how their outputs are compared with the host oracle. The card
tests, the CPU tests and ``chip_smoke.py`` share them; nothing on the main
path imports this module."""
from __future__ import annotations

import numpy as np
import torch

from ..crypto.bls import fields as hf
from ..crypto.bls.curve import g1_generator, g1_point, g2_generator, g2_point
from . import curve_torch as cj
from . import fq, fq_plain


def off_subgroup_point(g2: bool):
    """A host point of the curve outside the r-torsion: almost any x on it."""
    for v in range(1, 100):
        x = hf.Fq2(v, 1) if g2 else hf.Fq(v)
        y = (x * x.square() + (hf.Fq2(4, 4) if g2 else hf.Fq(4))).sqrt()
        if y is not None:
            pt = g2_point(x, y) if g2 else g1_point(x, y)
            if not pt.in_subgroup():
                return pt
    raise AssertionError("no point outside the subgroup among the first x")


def ladder_edges(g2: bool) -> list:
    """The host points that meet every special case of a ladder's addition:
    infinity, a point outside the r-torsion and, on G1, the 3-torsion
    points (0, 2) and (0, -2)."""
    gen = g2_generator() if g2 else g1_generator()
    edges = [gen.infinity(), off_subgroup_point(g2)]
    return edges if g2 else edges + [g1_point(hf.Fq(0), hf.Fq(2)), g1_point(hf.Fq(0), -hf.Fq(2))]


def ladder_points(n: int, g2: bool, rng: np.random.Generator, device=None, distinct: int = 64) -> tuple:
    """n Jacobian points on ``device`` and the host point of each row:
    ``distinct`` random multiples of the generator, each row a random
    representative (l^2 X, l^3 Y, l Z) of its point, with the edge points
    (``ladder_edges``) as the last rows where n has room (16 or more)."""
    gen = g2_generator() if g2 else g1_generator()
    tail = ladder_edges(g2) if n >= 16 else []
    base = [gen.mul(int(s)) for s in rng.integers(2, 1 << 62, size=min(distinct, n - len(tail)))]
    hosts = [base[i % len(base)] for i in range(n - len(tail))] + tail
    rows = {id(p): cj.host_point_to_jac_limbs(p) for p in base + tail}
    x, y, z = (torch.from_numpy(np.stack([rows[id(p)][c] for p in hosts])).to(device) for c in range(3))
    lam = torch.from_numpy(fq.to_limbs([int.from_bytes(rng.bytes(48), "big") % (fq.P_INT - 1) + 1
                                        for _ in range(n)])).to(device)
    lam2 = fq_plain.mul(lam, lam)
    lam3 = fq_plain.mul(lam2, lam)
    if g2:
        lam, lam2, lam3 = lam.unsqueeze(-2), lam2.unsqueeze(-2), lam3.unsqueeze(-2)
    return (fq_plain.mul(x, lam2), fq_plain.mul(y, lam3), fq_plain.mul(z, lam)), hosts


def point_ints(pt):
    """A host point as plain ints (None for infinity), to compare points of
    either host oracle."""
    if pt.is_infinity:
        return None
    return tuple(int(c) for v in pt.affine() for c in ((v,) if isinstance(v, int) else v))


def limbs_to_ints(pt, g2: bool, rows) -> list:
    """``point_ints`` of the given rows of a Jacobian limb batch."""
    return [point_ints(cj.jac_limbs_to_host_point(pt[0][i], pt[1][i], pt[2][i], g2)) for i in rows]
