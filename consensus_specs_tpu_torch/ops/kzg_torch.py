"""Batched KZG proof verification on the card: the port of the JAX
package's ``ops/kzg_jax.py`` — the eip4844/DAS/sharding hot path (ref
surface: specs/eip4844/beacon-chain.md:105-133 blob commitment checks;
specs/das/das-core.md:131 check_multi_kzg_proof;
specs/sharding/beacon-chain.md:675-766 shard-header commitment checks).

Fixed-G2 rearrangement. The host oracle checks (crypto/kzg.py)

    e(C - [y]G1, G2) * e(-W, [s-x]G2) == 1

whose second G2 point varies per proof. Bilinearity moves the variable
part across to the G1 side:

    e(-W, [s-x]G2) = e(-W, [s]G2) * e([x]W, G2)

so the check becomes

    e(C - [y]G1 + [x]W, G2) * e(-W, [s]G2) == 1

where BOTH G2 points (the generator and [s]G2 = setup.g2_powers[1]) are
the same for every (commitment, x, y, proof) row: a batch of N checks is N
rows of 2 pairs for ``bls_torch.run_checks``, one Miller loop and final
exponentiation call on the card for up to 256 rows, whatever the rows.
Per-row host work is three G1 operations.

The same trick covers the DAS sample check (a coset multi-proof): a size-m
coset {x0 w^j} has vanishing polynomial Z(X) = X^m - x0^m, so

    e(C - [I(s)]G1 + [x0^m]W, G2) * e(-W, [s^m]G2) == 1

with per-m FIXED G2 points. Per-row host work is the size-m interpolation
commitment (an m-term G1 MSM) plus one G1 scalar multiplication.

Subgroup discipline: rows whose commitment or proof decodes to a point
outside the r-torsion are answered False without touching the device —
the rearrangement relies on bilinearity of the reduced pairing, which only
holds on the proper subgroups. The host oracle ``verify_single`` accepts
such points; feeding it one is a caller bug, not a conformance surface.

The JAX package's mesh-sharded variants (``*_sharded``) are not ported:
they wait for the port's multi-card path.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..crypto import fr
from ..crypto.bls.curve import (
    DeserializationError,
    Point,
    g1_from_bytes,
    g1_generator,
    g2_from_bytes,
    g2_generator,
    g2_to_bytes,
)
from ..crypto.kzg import TrustedSetup, commit_point
from . import tower
from .bls_torch import run_checks

__all__ = [
    "verify_kzg_proof_batch",
    "check_multi_kzg_proof_batch",
    "pairing_product_is_one_batch",
    "clear_caches",
]


@functools.lru_cache(maxsize=16384)
def _g1_checked(data: bytes) -> Optional[Point]:
    """Compressed G1 -> validated Point (curve + r-torsion), or None.
    Infinity decodes to the infinity Point (legal, handled per row)."""
    try:
        pt = g1_from_bytes(data)
    except DeserializationError:
        return None
    if not pt.is_infinity and not pt.in_subgroup():
        return None
    return pt


@functools.lru_cache(maxsize=64)
def _g2_limbs_cached(g2_bytes: bytes):
    """Fixed-Q limb form, keyed by the canonical compressed encoding so
    distinct TrustedSetup instances with equal points share an entry."""
    pt = g2_from_bytes(g2_bytes)
    x, y = pt.affine()
    return tower.fq2_to_limbs_mont(x), tower.fq2_to_limbs_mont(y)


def _g1_limbs(pt: Point):
    x, y = pt.affine()
    return tower.fq_to_limbs_mont(int(x)), tower.fq_to_limbs_mont(int(y))


def clear_caches() -> None:
    _g1_checked.cache_clear()
    _g2_limbs_cached.cache_clear()


_Check = Optional[List[Tuple[object, object]]]


def _fixed_q_row(lhs: Point, w_pt: Point, s_g2_limbs, forced: dict, idx: int,
                 rows: List[_Check]) -> None:
    """Append the row [(lhs, G2), (-W, [s^k]G2)] — or resolve it on the
    host when a point at infinity degenerates a pair (nondegeneracy of
    the reduced pairing on the subgroups makes both cases exact):

    - W infinite: the second pair contributes 1, so the check holds iff
      lhs is infinite (e(lhs, G2) == 1 iff lhs == inf for subgroup lhs).
    - lhs infinite, W not: e(-W, [s^k]G2) != 1 always (s^k != 0), False.
    """
    if w_pt.is_infinity:
        forced[idx] = lhs.is_infinity
        rows.append(None)
        return
    if lhs.is_infinity:
        forced[idx] = False
        rows.append(None)
        return
    g2x, g2y = _g2_limbs_cached(g2_to_bytes(g2_generator()))
    rows.append([
        (_g1_limbs(lhs), (g2x, g2y)),
        (_g1_limbs(w_pt.neg()), s_g2_limbs),
    ])


def _single_rows(commitments: Sequence[bytes], proofs: Sequence[bytes],
                 xs: Sequence[int], ys: Sequence[int],
                 setup: TrustedSetup) -> Tuple[List[_Check], dict]:
    assert len(commitments) == len(proofs) == len(xs) == len(ys)
    s_g2 = _g2_limbs_cached(g2_to_bytes(setup.g2_powers[1]))
    g1 = g1_generator()
    rows: List[_Check] = []
    forced: dict = {}
    for i, (c_b, w_b, x, y) in enumerate(zip(commitments, proofs, xs, ys)):
        c_pt = _g1_checked(bytes(c_b))
        w_pt = _g1_checked(bytes(w_b))
        if c_pt is None or w_pt is None:
            rows.append(None)  # malformed/off-curve/out-of-subgroup
            continue
        x, y = x % fr.MODULUS, y % fr.MODULUS
        lhs = c_pt.add(g1.mul((fr.MODULUS - y) % fr.MODULUS)).add(w_pt.mul(x))
        _fixed_q_row(lhs, w_pt, s_g2, forced, i, rows)
    return rows, forced


def _coset_rows(commitments: Sequence[bytes], proofs: Sequence[bytes],
                x0s: Sequence[int], yss: Sequence[Sequence[int]],
                setup: TrustedSetup) -> Tuple[List[_Check], dict]:
    assert len(commitments) == len(proofs) == len(x0s) == len(yss)
    if not yss:
        return [], {}
    m = len(yss[0])
    assert m and m & (m - 1) == 0, "coset size must be a power of two"
    assert all(len(ys) == m for ys in yss), "one coset size per call"
    s_m_g2 = _g2_limbs_cached(g2_to_bytes(setup.g2_powers[m]))
    w = fr.root_of_unity(m)
    rows: List[_Check] = []
    forced: dict = {}
    for i, (c_b, w_b, x0, ys) in enumerate(zip(commitments, proofs, x0s, yss)):
        c_pt = _g1_checked(bytes(c_b))
        w_pt = _g1_checked(bytes(w_b))
        if c_pt is None or w_pt is None:
            rows.append(None)
            continue
        x0 = x0 % fr.MODULUS
        xs, acc = [], x0
        for _ in range(m):
            xs.append(acc)
            acc = acc * w % fr.MODULUS
        i_poly = fr.interpolate_on_domain(xs, [y % fr.MODULUS for y in ys])
        lhs = c_pt.add(commit_point(i_poly, setup).neg()).add(w_pt.mul(pow(x0, m, fr.MODULUS)))
        _fixed_q_row(lhs, w_pt, s_m_g2, forced, i, rows)
    return rows, forced


def _apply_forced(out: np.ndarray, forced: dict) -> np.ndarray:
    for i, v in forced.items():
        out[i] = v
    return out


def verify_kzg_proof_batch(commitments: Sequence[bytes], proofs: Sequence[bytes],
                           xs: Sequence[int], ys: Sequence[int],
                           setup: TrustedSetup) -> np.ndarray:
    """Batched `crypto.kzg.verify_single`: one bool per (C, W, x, y)
    row, all pairing work in the device pipeline's calls."""
    rows, forced = _single_rows(commitments, proofs, xs, ys, setup)
    return _apply_forced(run_checks(rows), forced)


def check_multi_kzg_proof_batch(commitments: Sequence[bytes], proofs: Sequence[bytes],
                                x0s: Sequence[int], yss: Sequence[Sequence[int]],
                                setup: TrustedSetup) -> np.ndarray:
    """Batched `crypto.kzg.check_multi_kzg_proof` (the DAS sample check):
    every row verifies a size-m coset opening; all rows of a call must
    share m (DAS fixes m per config, das-core.md:131)."""
    rows, forced = _coset_rows(commitments, proofs, x0s, yss, setup)
    return _apply_forced(run_checks(rows), forced)


def pairing_product_is_one_batch(checks: Sequence[Sequence[Tuple[Point, Point]]]) -> np.ndarray:
    """Generic batched `pairing_product(pairs).is_one()` (the host form,
    crypto/bls/pairing.py): one bool per check, each check a list of
    (G1 Point, G2 Point) pairs. Pairs with an infinity member contribute 1
    (exactly like the host pairing's infinity short-circuit); a check whose
    every pair degenerates is True. Used by the sharding degree-proof batch
    (specs/sharding.py verify_degree_proofs); callers own subgroup
    validation of their inputs, as with the host pairing."""
    rows: List[_Check] = []
    forced: dict = {}
    for i, pairs in enumerate(checks):
        row = []
        for p, q in pairs:
            if p.is_infinity or q.is_infinity:
                continue  # contributes the identity
            row.append((_g1_limbs(p), _g2_limbs_cached(g2_to_bytes(q))))
        if not row:
            forced[i] = True  # empty product == 1
            rows.append(None)
        else:
            rows.append(row)
    return _apply_forced(run_checks(rows), forced)
