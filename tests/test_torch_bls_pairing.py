"""The port's pairing (``ops/pairing_torch.py``, on the plain versions of
K3/K4) against the JAX package's host oracle
(``consensus_specs_tpu.crypto.bls.pairing``): one exact GT value of the
Miller loop plus the exact final exponentiation, equal field element for
field element; a 2-row batch of product-of-pairings checks through the fast
final exponentiation (the backend's decision path), one row good and one
bad; and the Miller loop's inactive lanes, which must read 1."""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto.bls import curve as hc
from consensus_specs_tpu.crypto.bls import fields as hf
from consensus_specs_tpu.crypto.bls import pairing as hp
from consensus_specs_tpu_torch.ops import pairing_torch, tower

RNG = np.random.default_rng(0xE1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _g1(pt):
    x, y = pt.affine()
    return tower.fq_to_limbs_mont(int(x)), tower.fq_to_limbs_mont(int(y))


def _g2(pt):
    x, y = pt.affine()
    return tower.fq2_to_limbs_mont(x), tower.fq2_to_limbs_mont(y)


def _pack(rows):
    """Rows of (G1, G2) pairs -> (B, K) limb tensors."""
    px = np.stack([[_g1(p)[0] for p, _ in r] for r in rows])
    py = np.stack([[_g1(p)[1] for p, _ in r] for r in rows])
    qx = np.stack([[_g2(q)[0] for _, q in r] for r in rows])
    qy = np.stack([[_g2(q)[1] for _, q in r] for r in rows])
    return tuple(torch.from_numpy(a) for a in (px, py, qx, qy))


def _gt_fields(f):
    """A GT element of either package as nested ints."""
    return [[[int(c) for c in f[j][i]] for i in range(3)] for j in range(2)]


def test_exact_gt_value_matches_host_pairing():
    a, b = (int(v) for v in RNG.integers(2, 1 << 62, size=2))
    P, Q = hc.g1_generator().mul(a), hc.g2_generator().mul(b)
    px, py, qx, qy = _pack([[(P, Q)]])
    gt = pairing_torch.pairing_product(px, py, qx, qy, torch.ones((1, 1), dtype=torch.bool))
    assert _gt_fields(tower.limbs_to_fq12(gt[0])) == _gt_fields(hp.pairing(P, Q))


def test_fast_check_decides_a_good_and_a_bad_row():
    a, b = 77, 3571
    g1, g2 = hc.g1_generator(), hc.g2_generator()
    good = [(g1.mul(a), g2.mul(b)), (g1.mul(a * b).neg(), g2)]
    bad = [(g1.mul(a), g2.mul(b)), (g1.mul(a * b + 1).neg(), g2)]
    px, py, qx, qy = _pack([good, bad])
    ok = pairing_torch.pairing_check_fast(px, py, qx, qy, torch.ones((2, 2), dtype=torch.bool))
    assert ok.tolist() == [True, False]


def test_miller_loop_inactive_lane_is_one():
    px, py, qx, qy = _pack([[(hc.g1_generator(), hc.g2_generator())] * 2])
    f = pairing_torch.miller_loop(px[0], py[0], qx[0], qy[0], torch.tensor([True, False]))
    assert tower.fq12_is_one(f).tolist() == [False, True]


def test_fast_exponent_identity():
    """3 (p^4 - p^2 + 1) / r = (x - 1)^2 (x + p) (x^2 + p^2 - 1) + 3 with
    x = -|x|: the integer identity the fast final exponentiation rests on."""
    p, x = hf.P, -pairing_torch.X_PARAM
    assert 3 * (p**4 - p**2 + 1) // pairing_torch.R_ORDER == (x - 1) ** 2 * (x + p) * (x * x + p * p - 1) + 3
    assert (p**4 - p**2 + 1) % pairing_torch.R_ORDER == 0
