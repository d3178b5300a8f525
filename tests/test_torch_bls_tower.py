"""The port's extension-field tower (``consensus_specs_tpu_torch.ops.tower``,
on the plain versions of K3/K4) against the JAX package's host oracle
(``consensus_specs_tpu.crypto.bls.fields``), case for case as
``tests/test_bls_device.py`` holds the JAX tower. Exact field values
(the limbs are canonical, so equal values are equal limbs). Inputs are
drawn from a seeded numpy generator."""
import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto.bls import fields as hf
from consensus_specs_tpu_torch.ops import fq, tower

RNG = np.random.default_rng(0xB7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rfq():
    return int.from_bytes(RNG.bytes(48), "big") % hf.P


def _rfq2():
    return hf.Fq2(_rfq(), _rfq())


def _rfq12():
    return hf.Fq12(hf.Fq6(*(_rfq2() for _ in range(3))), hf.Fq6(*(_rfq2() for _ in range(3))))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _fq2_of(limbs):
    return hf.Fq2(tower.limbs_to_int(limbs[0]), tower.limbs_to_int(limbs[1]))


def test_fq2_ops_match_host_oracle():
    a, b = _rfq2(), _rfq2()
    A, B = _t(tower.fq2_to_limbs_mont(a)), _t(tower.fq2_to_limbs_mont(b))
    for got, want in [
        (tower.fq2_mul(A, B), a * b),
        (tower.fq2_square(A), a.square()),
        (tower.fq2_inv(A), a.inv()),
        (tower.fq2_conj(A), a.conjugate()),
        (tower.fq2_mul_nonresidue(A), a.mul_by_nonresidue()),
        (tower.fq2_mul_fq(A, _t(tower.fq_to_limbs_mont(7))), a * hf.Fq2(7, 0)),
        (tower.muln(A, 8), a * hf.Fq2(8, 0)),
    ]:
        assert _fq2_of(got) == want


def test_fq12_ops_match_host_oracle():
    a, b = _rfq12(), _rfq12()
    A, B = _t(tower.fq12_to_limbs_mont(a)), _t(tower.fq12_to_limbs_mont(b))
    assert tower.limbs_to_fq12(tower.fq12_mul(A, B)) == a * b
    assert tower.limbs_to_fq12(tower.fq12_square(A)) == a * a
    assert tower.limbs_to_fq12(tower.fq12_inv(A)) == a.inv()
    assert tower.limbs_to_fq12(tower.fq12_conjugate(A)) == a.conjugate()
    assert tower.limbs_to_fq12(tower.fq12_frobenius_p2(A)) == a.frobenius(2)
    e = 0x1234DEADBEEF77
    bits = [(e >> i) & 1 for i in range(e.bit_length() - 1, -1, -1)]
    assert tower.limbs_to_fq12(tower.fq12_pow_bits(A, bits)) == a.pow(e)
    assert bool(tower.fq12_is_one(_t(tower.ONE12))) and not bool(tower.fq12_is_one(A))


def test_fq6_ops_match_host_oracle():
    sixes = [hf.Fq6(*(_rfq2() for _ in range(3))) for _ in range(3)]
    limbs = [_t(tower.fq12_to_limbs_mont(hf.Fq12(s, hf.FQ6_ZERO))[0]) for s in sixes]
    a, b = torch.stack(limbs[:2]), torch.stack(limbs[1:])  # a batch of two products

    def six_of(t):
        return hf.Fq6(*(_fq2_of(t[i]) for i in range(3)))

    prod, inv = tower.fq6_mul(a, b), tower.fq6_inv(a)
    for k in range(2):
        assert six_of(prod[k]) == sixes[k] * sixes[k + 1]
        assert six_of(inv[k]) == sixes[k].inv()
    assert six_of(tower.fq6_mul_nonresidue(a)[0]) == sixes[0].mul_by_nonresidue()


def test_batched_shapes_broadcast():
    a, b = _rfq2(), _rfq2()
    A = np.broadcast_to(tower.fq2_to_limbs_mont(a), (4, 3, 2, fq.N_LIMBS))
    got = tower.fq2_mul(_t(A.copy()), _t(tower.fq2_to_limbs_mont(b)))
    assert got.shape == (4, 3, 2, fq.N_LIMBS)
    assert all(_fq2_of(got[i, j]) == a * b for i in range(4) for j in range(3))
