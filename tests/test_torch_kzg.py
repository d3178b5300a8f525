"""The port's batched KZG verifiers (``consensus_specs_tpu_torch.ops.kzg_torch``
on ``bls_torch.run_checks``, the pairing pipeline's plain versions on the
CPU) against the JAX package's ``ops/kzg_jax.py`` row building and the host
oracle ``crypto/kzg.py``, and the harness's KZG fixtures against the
oracle's commitments and proofs.

The rows each verifier packs (its limbs and the rows it resolves on the
host) equal the JAX package's exactly; building them compiles no pairing.
Each verifier's verdicts on one small batch (valid rows, a wrong y, a
swapped proof, an infinity proof, malformed bytes, a point outside the
r-torsion) equal the host oracle's, row by row; each batch is one call of
the pipeline."""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto import kzg as jkzg
from consensus_specs_tpu.ops import kzg_jax
from consensus_specs_tpu_torch import harness
from consensus_specs_tpu_torch.crypto import fr, kzg
from consensus_specs_tpu_torch.crypto.bls.curve import g1_point, g1_to_bytes
from consensus_specs_tpu_torch.crypto.bls.fields import Fq
from consensus_specs_tpu_torch.crypto.bls.pairing import pairing_product
from consensus_specs_tpu_torch.ops import bls_torch, kzg_torch

RNG = np.random.default_rng(0x4E6)
M = 8  # coset size: the das POINTS_PER_SAMPLE


@pytest.fixture(scope="module", autouse=True)
def _cpu_pipeline():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = bls_torch._device
    bls_torch.use_device("cpu")
    yield
    bls_torch._device = prev
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setups():
    """The minimal preset's 64-power development setup, in both packages."""
    return kzg.insecure_setup(64), jkzg.insecure_setup(64)


def _off_subgroup_bytes() -> bytes:
    """An on-curve G1 point outside the r-torsion, compressed."""
    x = 1
    while True:
        xf = Fq(x)
        y = (xf * xf.square() + Fq(4)).sqrt()
        if y is not None:
            pt = g1_point(xf, y)
            if not pt.in_subgroup():
                return g1_to_bytes(pt)
        x += 1


def _rand():
    return int.from_bytes(RNG.bytes(32), "big") % fr.MODULUS


@pytest.fixture(scope="module")
def single_rows():
    """(commitments, proofs, xs, ys) and the expected verdicts: a valid row,
    a proof of another row, a wrong y, a constant polynomial's infinity
    proof with its right and a wrong y, malformed bytes, and a commitment
    outside the subgroup."""
    polys = [harness.random_polynomial(RNG, 16) for _ in range(3)] + [[_rand()]]
    rows = []
    for coeffs in polys + [polys[3], polys[0], polys[1]]:
        x = _rand()
        y, proof = harness.kzg_single_proof(coeffs, x)
        rows.append([harness.kzg_commitment(coeffs), proof, x, y])
    rows[1][1] = rows[0][1]  # a proof of another row
    rows[2][3] = (rows[2][3] + 1) % fr.MODULUS  # wrong y
    rows[4][3] = (rows[4][3] + 1) % fr.MODULUS  # the constant's wrong y
    rows[5][0] = b"\x00" * 48  # no compression flag
    rows[6][0] = _off_subgroup_bytes()
    return [list(c) for c in zip(*rows)], [True, False, False, True, False, False, False]


@pytest.fixture(scope="module")
def coset_rows():
    """(commitments, proofs, x0s, yss): two valid rows, a tampered y, a
    proof of another row, malformed bytes, a proof outside the subgroup."""
    w = fr.root_of_unity(M)
    rows = []
    for _ in range(6):
        coeffs = harness.random_polynomial(RNG, 16)
        x0 = _rand()
        ys, proof = harness.kzg_coset_proof(coeffs, [x0 * pow(w, j, fr.MODULUS) % fr.MODULUS for j in range(M)])
        rows.append([harness.kzg_commitment(coeffs), proof, x0, ys])
    rows[2][3][5] = (rows[2][3][5] + 1) % fr.MODULUS
    rows[3][1] = rows[0][1]
    rows[4][1] = b"\xc0" + b"\x11" * 47  # infinity flag with body bits set
    rows[5][1] = _off_subgroup_bytes()
    return [list(c) for c in zip(*rows)], [True, True, False, False, False, False]


def _same_rows(ours, theirs):
    assert len(ours[0]) == len(theirs[0]) and ours[1] == theirs[1]  # the rows, and those resolved on the host
    for a, b in zip(ours[0], theirs[0]):
        assert (a is None) == (b is None)
        if a is not None:
            assert len(a) == len(b)
            for (pa, qa), (pb, qb) in zip(a, b):
                for x, y in zip((*pa, *qa), (*pb, *qb)):
                    np.testing.assert_array_equal(x, y)


def test_single_rows_equal_the_jax_packages(setups, single_rows):
    (cs, ws, xs, ys), _ = single_rows
    _same_rows(kzg_torch._single_rows(cs, ws, xs, ys, setups[0]), kzg_jax._single_rows(cs, ws, xs, ys, setups[1]))


def test_coset_rows_equal_the_jax_packages(setups, coset_rows):
    (cs, ws, x0s, yss), _ = coset_rows
    _same_rows(kzg_torch._coset_rows(cs, ws, x0s, yss, setups[0]), kzg_jax._coset_rows(cs, ws, x0s, yss, setups[1]))


def test_single_batch_matches_the_host_oracle(setups, single_rows):
    (cs, ws, xs, ys), want = single_rows
    got = kzg_torch.verify_kzg_proof_batch(cs, ws, xs, ys, setups[0])
    assert got.tolist() == want
    assert want == [kzg.verify_single(c, w, x, y, setups[0]) for c, w, x, y in zip(cs, ws, xs, ys)]


def test_coset_batch_matches_the_host_oracle(setups, coset_rows):
    (cs, ws, x0s, yss), want = coset_rows
    got = kzg_torch.check_multi_kzg_proof_batch(cs, ws, x0s, yss, setups[0])
    assert got.tolist() == want
    assert want == [kzg.check_multi_kzg_proof(c, w, x0, ys, setups[0]) for c, w, x0, ys in zip(cs, ws, x0s, yss)]


def test_pair_product_batch_matches_the_host_pairing(setups):
    """Degree-proof checks as the sharding spec builds them, e(proof, G2) *
    e(-C, [s^(64 - points)]G2) == 1: a valid one, a proof made for a larger
    count, one with an infinity pair, and one whose pairs all degenerate."""
    from consensus_specs_tpu_torch.crypto.bls.curve import g1_from_bytes, g1_infinity

    setup = setups[0]
    coeffs = harness.random_polynomial(RNG, 16)
    c = g1_from_bytes(harness.kzg_commitment(coeffs))
    good = g1_from_bytes(harness.degree_proof(coeffs, 16, 64))
    bad = g1_from_bytes(harness.degree_proof(coeffs, 24, 64))
    q = setup.g2_powers[64 - 16]
    checks = [
        [(good, setup.g2_powers[0]), (c.neg(), q)],
        [(bad, setup.g2_powers[0]), (c.neg(), q)],
        [(g1_infinity(), setup.g2_powers[0]), (c.neg(), q)],
        [(g1_infinity(), q)],
    ]
    got = kzg_torch.pairing_product_is_one_batch(checks)
    assert got.tolist() == [pairing_product(pairs).is_one() for pairs in checks] == [True, False, False, True]


@pytest.mark.parametrize("degree", [1, 8, 16])
def test_harness_fixtures_equal_the_oracles_msm(setups, degree):
    """The harness's commitments and proofs from the public secret equal
    crypto/kzg's commit / open_single / open_multi over the setup's
    powers, and a degree proof equals the commitment of B(X) shifted up."""
    setup = setups[0]
    coeffs = harness.random_polynomial(RNG, degree)
    assert harness.kzg_commitment(coeffs) == kzg.commit(coeffs, setup)
    x = _rand()
    assert harness.kzg_single_proof(coeffs, x) == kzg.open_single(coeffs, x, setup)
    w = fr.root_of_unity(M)
    xs = [x * pow(w, j, fr.MODULUS) % fr.MODULUS for j in range(M)]
    assert harness.kzg_coset_proof(coeffs, xs) == kzg.open_multi(coeffs, xs, setup)
    points = 16
    assert harness.degree_proof(coeffs, points, 64) == kzg.commit([0] * (64 - points) + coeffs, setup)
    with pytest.raises(AssertionError, match="secret"):
        harness.kzg_single_proof(coeffs, harness.kzg_secret())
