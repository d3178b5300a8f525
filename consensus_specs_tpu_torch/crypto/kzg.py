"""KZG10 polynomial commitments over BLS12-381 — the crypto core of the
sharding/DAS/EIP-4844 forks (ref: specs/sharding/beacon-chain.md:170-173
G1_SETUP/G2_SETUP, :675-766 process_shard_header's degree/commitment
checks; specs/das/das-core.md:131 check_multi_kzg_proof;
specs/eip4844/beacon-chain.md:105-133 blob_to_kzg).

The reference marks the trusted setups "TBD" and ships no KZG
implementation; this module provides working commitments against a
deterministic INSECURE development setup (secret derived from a fixed
seed — usable for conformance vectors, never for production, exactly
like the deterministic validator keys in test_framework/keys.py).

Host/pure-int implementation = the correctness oracle; the batched
device paths (polynomial FFTs) live in ops/fft_torch.py.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

from . import fr
from .bls.curve import (
    Point,
    g1_from_bytes,
    g1_generator,
    g1_infinity,
    g1_to_bytes,
    g2_generator,
    g2_infinity,
)
from .bls.pairing import pairing_product

# Size of the development setup: bounds committable polynomial degree.
# 2**12 covers FIELD_ELEMENTS_PER_BLOB=4096 (eip4844/beacon-chain.md:54).
SETUP_SIZE = 4096
_INSECURE_SECRET = int.from_bytes(b"consensus-specs-tpu insecure kzg", "big") % fr.MODULUS


class TrustedSetup:
    """[G1*s^i], [G2*s^i] powers plus the Lagrange-basis G1 points for a
    given evaluation domain size (eip4844's KZG_SETUP_LAGRANGE)."""

    def __init__(self, g1_powers: List[Point], g2_powers: List[Point]):
        self.g1_powers = g1_powers
        self.g2_powers = g2_powers

    @functools.lru_cache(maxsize=8)
    def lagrange_g1(self, domain_size: int) -> Tuple[Point, ...]:
        """G1 points committing to the Lagrange basis of the canonical
        size-`domain_size` domain: the group IFFT of the power basis."""
        assert domain_size & (domain_size - 1) == 0
        assert domain_size <= len(self.g1_powers)
        pts = list(self.g1_powers[:domain_size])
        out = _group_fft(pts, domain_size, inverse=True)
        return tuple(out)


def _group_fft(points: List[Point], n: int, inverse: bool) -> List[Point]:
    """Radix-2 FFT in the group (points as coefficients, scalars as
    twiddles) — same butterflies as fr.fft with point add/mul."""
    vals = [points[fr.reverse_bit_order(i, n)] for i in range(n)]
    w_n = fr.root_of_unity(n)
    if inverse:
        w_n = pow(w_n, fr.MODULUS - 2, fr.MODULUS)
    stage = 2
    while stage <= n:
        w_m = pow(w_n, n // stage, fr.MODULUS)
        half = stage // 2
        for start in range(0, n, stage):
            w = 1
            for j in range(half):
                t = vals[start + j + half].mul(w)
                u = vals[start + j]
                vals[start + j] = u.add(t)
                vals[start + j + half] = u.add(t.neg())
                w = w * w_m % fr.MODULUS
        stage *= 2
    if inverse:
        n_inv = pow(n, fr.MODULUS - 2, fr.MODULUS)
        vals = [v.mul(n_inv) for v in vals]
    return vals


@functools.lru_cache(maxsize=8)  # several forks use distinct setup sizes
def insecure_setup(size: int = SETUP_SIZE) -> TrustedSetup:
    """The deterministic development setup (INSECURE: secret is public)."""
    s = _INSECURE_SECRET
    g1, g2 = g1_generator(), g2_generator()
    g1_powers, g2_powers = [], []
    acc = 1
    for _ in range(size):
        g1_powers.append(g1.mul(acc))
        g2_powers.append(g2.mul(acc))
        acc = acc * s % fr.MODULUS
    return TrustedSetup(g1_powers, g2_powers)


# -- commitments (coefficient form) ------------------------------------------


def commit_point(coeffs: Sequence[int], setup: TrustedSetup) -> Point:
    """C = sum coeffs[i] * G1*s^i as a Point (ops/kzg_torch builds pairing
    rows from this without a bytes round-trip)."""
    assert len(coeffs) <= len(setup.g1_powers)
    acc = g1_infinity()
    for c, p in zip(coeffs, setup.g1_powers):
        if c % fr.MODULUS:
            acc = acc.add(p.mul(c % fr.MODULUS))
    return acc


def commit(coeffs: Sequence[int], setup: TrustedSetup) -> bytes:
    """C = sum coeffs[i] * G1*s^i (the MSM; specs/sharding degree check
    pairs this with G2_SETUP entries)."""
    return g1_to_bytes(commit_point(coeffs, setup))


def commit_to_evaluations(evals: Sequence[int], setup: TrustedSetup) -> bytes:
    """Commit to the polynomial given by its canonical-domain evaluations
    via the Lagrange setup — eip4844's blob_to_kzg shape
    (eip4844/beacon-chain.md:111-123): sum evals[i] * L_i(s)·G1."""
    lag = setup.lagrange_g1(len(evals))
    acc = g1_infinity()
    for v, p in zip(evals, lag):
        if v % fr.MODULUS:
            acc = acc.add(p.mul(v % fr.MODULUS))
    return g1_to_bytes(acc)


def open_single(coeffs: Sequence[int], x: int, setup: TrustedSetup) -> Tuple[int, bytes]:
    """(y, proof): y = p(x), proof = commit((p(X)-y)/(X-x))."""
    y = fr.poly_eval(coeffs, x)
    num = fr.poly_sub(list(coeffs), [y])
    q = fr.poly_divide(num, [(-x) % fr.MODULUS, 1])
    return y, commit(q, setup)


def verify_single(commitment: bytes, proof: bytes, x: int, y: int, setup: TrustedSetup) -> bool:
    """e(C - [y]G1, G2) == e(proof, [s-x]G2)."""
    try:
        c_pt = g1_from_bytes(commitment)
        w_pt = g1_from_bytes(proof)
    except ValueError:
        return False
    g2 = g2_generator()
    s_minus_x = setup.g2_powers[1].add(g2.mul(x % fr.MODULUS).neg())
    lhs = c_pt.add(g1_generator().mul(y % fr.MODULUS).neg())
    # e(lhs, G2) * e(-proof, [s-x]G2) == 1
    return pairing_product([(lhs, g2), (w_pt.neg(), s_minus_x)]).is_one()


def open_multi(coeffs: Sequence[int], xs: Sequence[int], setup: TrustedSetup) -> Tuple[List[int], bytes]:
    """(ys, proof) opening p at every x in xs at once:
    proof = commit((p - I)/Z) with I interpolating (xs, ys) and Z the
    vanishing polynomial of xs (ssz-of-thought of das-core.md:131)."""
    ys = [fr.poly_eval(coeffs, x) for x in xs]
    i_poly = fr.interpolate_on_domain(list(xs), ys)
    z_poly = [1]
    for x in xs:
        z_poly = fr.poly_mul(z_poly, [(-x) % fr.MODULUS, 1])
    q = fr.poly_divide(fr.poly_sub(list(coeffs), i_poly), z_poly)
    return ys, commit(q, setup)


def verify_multi(commitment: bytes, proof: bytes, xs: Sequence[int], ys: Sequence[int],
                 setup: TrustedSetup) -> bool:
    """e(C - [I(s)]G1, G2) == e(proof, [Z(s)]G2) — the multi-proof check
    behind das-core.md:131 check_multi_kzg_proof."""
    try:
        c_pt = g1_from_bytes(commitment)
        w_pt = g1_from_bytes(proof)
    except ValueError:
        return False
    i_poly = fr.interpolate_on_domain(list(xs), list(ys))
    z_poly = [1]
    for x in xs:
        z_poly = fr.poly_mul(z_poly, [(-x) % fr.MODULUS, 1])
    i_commit = g1_from_bytes(commit(i_poly, setup))
    z_g2 = _commit_g2(z_poly, setup)
    lhs = c_pt.add(i_commit.neg())
    return pairing_product([(lhs, g2_generator()), (w_pt.neg(), z_g2)]).is_one()


def _commit_g2(coeffs: Sequence[int], setup: TrustedSetup) -> Point:
    assert len(coeffs) <= len(setup.g2_powers)
    acc = g2_infinity()
    for c, p in zip(coeffs, setup.g2_powers):
        if c % fr.MODULUS:
            acc = acc.add(p.mul(c % fr.MODULUS))
    return acc


def check_multi_kzg_proof(commitment: bytes, proof: bytes, x: int, ys: Sequence[int],
                          setup: TrustedSetup) -> bool:
    """das-core.md:131: verify that the subgroup starting at `x` (size
    len(ys), a power of two) evaluates to `ys` under `commitment`."""
    n = len(ys)
    w = fr.root_of_unity(n)
    xs = []
    acc = x % fr.MODULUS
    for _ in range(n):
        xs.append(acc)
        acc = acc * w % fr.MODULUS
    return verify_multi(commitment, proof, xs, list(ys), setup)
