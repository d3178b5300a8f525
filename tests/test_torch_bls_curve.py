"""The port's curve and hash-to-curve ops (``ops/curve_torch.py``,
``ops/h2c_torch.py``, on the plain versions of K3/K4) against the JAX
package's host oracle (``consensus_specs_tpu.crypto.bls.curve`` and
``hash_to_curve``), mirroring ``tests/test_curve_device.py`` and
``tests/test_h2c_device.py``: Jacobian arithmetic with its special cases,
square roots, batched decompression with on-curve and subgroup masks
(valid, off-curve and out-of-subgroup encodings in one batch), the
endomorphism, and hash-to-G2. Exact: points compare as group elements."""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto.bls import curve as hc
from consensus_specs_tpu.crypto.bls import fields as hf
from consensus_specs_tpu.crypto.bls import hash_to_curve as hh
from consensus_specs_tpu_torch.ops import curve_torch as cj
from consensus_specs_tpu_torch.ops import h2c_torch as h2
from consensus_specs_tpu_torch.ops import tower

RNG = np.random.default_rng(0xC0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jac(points):
    """Host points -> a batch of Jacobian limb tensors."""
    triples = [cj.host_point_to_jac_limbs(p) for p in points]
    return tuple(torch.from_numpy(np.stack([t[i] for t in triples])) for i in range(3))


def _ints(pt):
    """A host point of either package as plain ints (None for infinity)."""
    if pt.is_infinity:
        return None
    return tuple(int(c) for v in pt.affine() for c in ((v,) if isinstance(v, int) else v))


def _host(pt, k, g2):
    return _ints(cj.jac_limbs_to_host_point(pt[0][k], pt[1][k], pt[2][k], g2))


@pytest.mark.parametrize("g2", [False, True])
def test_jacobian_ops_match_host_oracle(g2):
    F = cj.FQ2 if g2 else cj.FQ
    gen = hc.g2_generator() if g2 else hc.g1_generator()
    a, b = (int(v) for v in RNG.integers(2, 1 << 40, size=2))
    P, Q = gen.mul(a), gen.mul(b)
    inf = gen.infinity()
    lhs = _jac([P, P, P, inf, P])
    rhs = _jac([Q, P, P.neg(), Q, inf])
    s = cj.jac_add(F, lhs, rhs)
    want = [P.add(Q), P.double(), inf, Q, P]
    assert [_host(s, k, g2) for k in range(5)] == [_ints(w) for w in want]
    assert cj.jac_is_infinity(F, s).tolist() == [False, False, True, False, False]
    d = cj.jac_double(F, lhs)
    assert _host(d, 0, g2) == _ints(P.double()) and bool(cj.jac_is_infinity(F, d)[3])
    k = int(RNG.integers(2, 1 << 20))
    assert _host(cj.scalar_mul_static(F, lhs, k), 0, g2) == _ints(P.mul(k))
    assert cj.jac_eq(F, s, _jac([P.add(Q), P.double(), inf, Q, P])).all()
    x, y, inf_mask = cj.jac_to_affine(F, s)
    assert inf_mask.tolist() == [False, False, True, False, False]
    got = [tower.limbs_to_int(c) for c in (x[0], y[0]) for c in (c if g2 else [c])]
    assert tuple(got) == _ints(P.add(Q))


def test_tree_sum_masks_inactive_lanes():
    g = hc.g1_generator()
    pts = [g.mul(k) for k in (3, 5, 7, 11, 13)]
    x, y, z = _jac(pts)
    active = torch.tensor([[True, True, False, True, True]])
    s = cj.jac_tree_sum(cj.FQ, (x[None], y[None], z[None]), active)
    assert _host(s, 0, False) == _ints(g.mul(3 + 5 + 11 + 13))


def _off_subgroup_g1():
    """A point of E(Fq) outside the r-torsion: almost any x on the curve."""
    x = 3
    while True:
        y = hf.Fq(x * x * x + 4).sqrt()
        if y is not None:
            pt = hc.g1_point(hf.Fq(x), y)
            if not pt.in_subgroup():
                return pt
        x += 1


def _off_subgroup_g2():
    x = 1
    while True:
        X = hf.Fq2(x, 1)
        y = (X * X.square() + hf.Fq2(4, 4)).sqrt()
        if y is not None:
            pt = hc.g2_point(X, y)
            if not pt.in_subgroup():
                return pt
        x += 1


def test_g1_decompress_masks_match_host_decode():
    valid = [hc.g1_generator().mul(k) for k in (1, 2, 0xDEADBEEF)]
    off_sub = _off_subgroup_g1()
    x_off = next(v for v in range(5, 100) if hf.Fq(v * v * v + 4).sqrt() is None)  # not on the curve
    xs = [int(p.affine()[0]) for p in valid + [off_sub]] + [x_off]
    flags = [hc.g1_to_bytes(p)[0] & 0x20 != 0 for p in valid + [off_sub]] + [False]
    x = torch.from_numpy(np.stack([tower.fq_to_limbs_mont(v) for v in xs]))
    _, y, on_curve, in_subgroup = cj.g1_decompress(x, torch.tensor(flags))
    assert on_curve.tolist() == [True] * 4 + [False]
    assert in_subgroup[:4].tolist() == [True] * 3 + [False]
    for k, p in enumerate(valid):
        assert tower.limbs_to_int(y[k]) == int(p.affine()[1])


def test_g2_decompress_masks_match_host_decode():
    valid = [hc.g2_generator().mul(k) for k in (1, 0xC0FFEE)]
    off_sub = _off_subgroup_g2()
    x_off = next(hf.Fq2(v, 1) for v in range(1, 100)
                 if (hf.Fq2(v, 1) * hf.Fq2(v, 1).square() + hf.Fq2(4, 4)).sqrt() is None)
    pts = valid + [off_sub]
    xs = [p.affine()[0] for p in pts] + [x_off]
    flags = [hc.g2_to_bytes(p)[0] & 0x20 != 0 for p in pts] + [False]
    x = torch.from_numpy(np.stack([tower.fq2_to_limbs_mont(v) for v in xs]))
    _, y, on_curve, in_subgroup = cj.g2_decompress(x, torch.tensor(flags))
    assert on_curve.tolist() == [True, True, True, False]
    assert in_subgroup[:3].tolist() == [True, True, False]
    for k, p in enumerate(valid):
        want = p.affine()[1]
        assert (tower.limbs_to_int(y[k][0]), tower.limbs_to_int(y[k][1])) == (int(want[0]), int(want[1]))


def test_square_roots_and_signs():
    vals = [4, 9, 5, 0]  # 5 is a non-residue mod p
    a = torch.from_numpy(np.stack([tower.fq_to_limbs_mont(v) for v in vals]))
    root, ok = cj.fq_sqrt(a)
    assert ok.tolist() == [hf.Fq(v).sqrt() is not None for v in vals]
    for k, v in enumerate(vals):
        if ok[k]:
            assert pow(tower.limbs_to_int(root[k]), 2, hf.P) == v
    plain = [1, (hf.P - 1) // 2, (hf.P + 1) // 2, hf.P - 1]
    gt = cj.fq_lex_gt_half(torch.from_numpy(np.stack([tower.fq_to_limbs_mont(v) for v in plain])))
    assert gt.tolist() == [False, False, True, True]


def test_psi_is_the_x_endomorphism_on_g2():
    q = hc.g2_generator().mul(0x1234567)
    pt = _jac([q])
    lhs = cj.psi(pt)
    rhs = cj.jac_neg(cj.FQ2, cj.scalar_mul_static(cj.FQ2, pt, cj.X_PARAM))
    assert bool(cj.jac_eq(cj.FQ2, lhs, rhs)[0])
    assert bool(cj.g2_subgroup_mask(pt)[0])


def test_hash_to_g2_matches_host_oracle():
    msgs = [b"", b"\xab" * 32]
    qx, qy = h2.hash_to_g2_batch(msgs, device="cpu")
    for k, m in enumerate(msgs):
        wx, wy = hh.hash_to_g2(m).affine()
        assert (tower.limbs_to_int(qx[k][0]), tower.limbs_to_int(qx[k][1])) == (int(wx[0]), int(wx[1]))
        assert (tower.limbs_to_int(qy[k][0]), tower.limbs_to_int(qy[k][1])) == (int(wy[0]), int(wy[1]))
