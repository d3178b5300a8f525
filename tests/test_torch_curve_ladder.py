"""The port's static scalar ladders (``curve_torch.scalar_mul_static``, on
the card K7 ``g1_mul_static`` and K8 ``g2_mul_static``) against the JAX
package's ``ops/curve_jax.scalar_mul_static`` under ``jax.jit`` and the
host oracle, on G1 and G2 at k = |x| = 0xd201000000010000.

The inputs are seeded multiples of the generators, the point at infinity,
the G1 3-torsion points (0, 2) and (0, -2), and a point of each curve
outside the r-torsion; the ladder meets every special case of the
addition on them (P + P, P + (-P), infinity on either side). The
comparison with the JAX package is bit-exact on the X, Y and Z limbs: the
same formulas give the same Jacobian representative.

The kernels' point arithmetic (``csrc/curve.cuh``) also compiles as plain
C++; where a host C++ compiler is present it is built here, a group's
lanes run in lockstep over arrays, and held bit-exact against the plain
version and the host oracle, with no read of another lane's entry.

Each ladder's JIT is built once for the module (about 20 s of compile
each on a CPU)."""
import ctypes

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.crypto.bls import fields as hf
from consensus_specs_tpu.ops import curve_jax as jcurve
from consensus_specs_tpu_torch.crypto.bls import curve as hc
from consensus_specs_tpu_torch.ops import curve_torch as cj
from consensus_specs_tpu_torch.ops import fq_plain, tower
from consensus_specs_tpu_torch.ops import ladder_checks as lc
from tests.test_torch_fq import HOST_DIGITS_SRC, build_host_lib

RNG = np.random.default_rng(0x1AD)
K = cj.X_PARAM
K_RANDOM = int(RNG.integers(1 << 40, 1 << 62)) | 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _points(g2: bool) -> list:
    """Seeded multiples of the generator, then the edge points."""
    gen = hc.g2_generator() if g2 else hc.g1_generator()
    return [gen.mul(int(s)) for s in RNG.integers(2, 1 << 62, size=3)] + lc.ladder_edges(g2)


POINTS = {g2: _points(g2) for g2 in (False, True)}


def _jac(points):
    """Host points -> a batch of Jacobian limb arrays."""
    triples = [cj.host_point_to_jac_limbs(p) for p in points]
    return tuple(np.ascontiguousarray(np.stack([t[i] for t in triples])) for i in range(3))


def _affine(pt, g2: bool) -> list:
    return lc.limbs_to_ints(pt, g2, range(len(pt[0])))


def _field(g2: bool):
    return cj.FQ2 if g2 else cj.FQ


_PLAIN: dict = {}


def _plain(g2: bool, k: int) -> tuple:
    """The port's ladder on the CPU (its plain version), made once."""
    if (g2, k) not in _PLAIN:
        pt = tuple(torch.from_numpy(a) for a in _jac(POINTS[g2]))
        _PLAIN[g2, k] = tuple(t.numpy() for t in cj.scalar_mul_static(_field(g2), pt, k))
    return _PLAIN[g2, k]


_JIT: dict = {}


def _jax_ladder(g2: bool):
    if g2 not in _JIT:
        F = jcurve.FQ2 if g2 else jcurve.FQ
        _JIT[g2] = jax.jit(lambda x, y, z: jcurve.scalar_mul_static(F, (x, y, z), K))
    return _JIT[g2]


@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_ladder_matches_jax_and_the_host_oracle(g2):
    got = _plain(g2, K)
    want = _jax_ladder(g2)(*_jac(POINTS[g2]))
    for name, a, b in zip("XYZ", got, want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{name} limbs differ from the JAX package's")
    assert _affine(got, g2) == [lc.point_ints(p.mul(K)) for p in POINTS[g2]]


def test_ladder_dispatches_cpu_tensors_to_the_plain_version():
    pt = tuple(torch.from_numpy(a) for a in _jac(POINTS[False][:2]))
    got = cj.scalar_mul_static(cj.FQ, pt, 5)
    want = cj.scalar_mul_static_plain(cj.FQ, pt, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _affine(got, False) == [lc.point_ints(p.mul(5)) for p in POINTS[False][:2]]
    for F, shape in ((cj.FQ, (2, 32)), (cj.FQ2, (2, 2, 32))):
        meta = tuple(torch.zeros(shape, dtype=torch.int32, device="meta") for _ in range(3))
        with pytest.raises(ValueError, match="no kernel"):
            cj.scalar_mul_static(F, meta, K)


_HOST_SRC = r"""
#include "curve.cuh"
""" + HOST_DIGITS_SRC + r"""

// K7 (N = 1, G = 4) or K8 (N = 2, G = 16, its batches split over 2
// subgroups) as curve.cu builds them, one element at a time
template <int G, int N, int S>
void ladders(const int32_t* const in[3], int32_t* const out[3], long n, const fq::lanes::Exponent& k) {
  using F = curve::Field<G, N, S>;
  for (long i = 0; i < n; ++i) {
    curve::Jac<F> p, r;
    typename F::E* pc[3] = {&p.x, &p.y, &p.z};
    typename F::E* rc[3] = {&r.x, &r.y, &r.z};
    for (int c = 0; c < 3; ++c)
      for (int h = 0; h < N; ++h) host_load<G>(pc[c]->c[h], in[c] + 32 * (N * i + h));
    curve::mul_static<F>(r, p, k);
    for (int c = 0; c < 3; ++c)
      for (int h = 0; h < N; ++h) host_store<G>(out[c] + 32 * (N * i + h), rc[c]->c[h]);
  }
}

// returns the reads of another lane's entry (fq::lanes::lane_faults): 0
// where the bodies keep to the rule that makes the lockstep run the card's
extern "C" long host_mul_static_lanes(const int32_t* x, const int32_t* y, const int32_t* z, int32_t* ox,
                                      int32_t* oy, int32_t* oz, long n, int degree, const uint32_t* words,
                                      int bits) {
  fq::lanes::Exponent k;
  for (int j = 0; j < fq::kWords; ++j) k.words[j] = words[j];
  k.bits = bits;
  const int32_t* in[3] = {x, y, z};
  int32_t* out[3] = {ox, oy, oz};
  fq::lanes::lane_faults = 0;
  if (degree == 1) ladders<4, 1, 1>(in, out, n, k);
  else ladders<16, 2, 2>(in, out, n, k);
  return fq::lanes::lane_faults;
}
"""


@pytest.fixture(scope="module")
def host_curve_lib(tmp_path_factory):
    handle = build_host_lib(tmp_path_factory, "host_curve", _HOST_SRC)
    handle.host_mul_static_lanes.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
                                                                     ctypes.c_int]
    handle.host_mul_static_lanes.restype = ctypes.c_long
    return handle


@pytest.mark.parametrize("k", [K, K_RANDOM], ids=["x", "random"])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_kernel_ladder_matches_plain_version_and_host_oracle(host_curve_lib, g2, k):
    """K7 (G1, groups of 4 lanes) and K8 (G2, groups of 8): curve.cuh's
    mul_static on its level schedules, bit-exact against the plain version,
    the points equal to the host oracle's, with no read of another lane's
    entry. The edge points take every special case of the addition: on G1
    the 3-torsion points reach P1 == P2 (the doubling) and P1 == -P2."""
    ins = _jac(POINTS[g2])
    outs = tuple(np.zeros_like(a) for a in ins)
    words = np.array([(k >> (32 * j)) & 0xFFFFFFFF for j in range(12)], dtype=np.uint32)
    faults = host_curve_lib.host_mul_static_lanes(*(a.ctypes.data for a in ins + outs), len(ins[0]), 2 if g2 else 1,
                                                  words.ctypes.data, k.bit_length())
    assert faults == 0, f"{faults} reads of another lane's entry: the card would read its own"
    for name, a, b in zip("XYZ", outs, _plain(g2, k)):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} limbs differ from the plain version")
    assert _affine(outs, g2) == [lc.point_ints(p.mul(k)) for p in POINTS[g2]]


def test_plain_adapters_compute_the_field_ops():
    """The plain adapters give the limbs of the dispatching ones (on the
    CPU, fq's plain versions and the tower's schoolbook Fq2 product)."""
    a, b = (torch.from_numpy(np.stack([tower.fq2_to_limbs_mont(hf.Fq2(*(int(v) for v in RNG.integers(1, 1 << 62, 2))))
                                       for _ in range(4)])) for _ in range(2))
    for plain, ref in ((cj.FQ2_PLAIN, cj.FQ2), (cj.FQ_PLAIN, cj.FQ)):
        x, y = (a, b) if plain is cj.FQ2_PLAIN else (a[:, 0], b[:, 1])
        for op in ("mul", "add", "sub"):
            assert torch.equal(getattr(plain, op)(x, y), getattr(ref, op)(x, y)), (plain.__name__, op)
        for op in ("square", "neg", "double"):
            assert torch.equal(getattr(plain, op)(x), getattr(ref, op)(x)), (plain.__name__, op)
        assert torch.equal(plain.muln(x, 8), ref.muln(x, 8))
    assert torch.equal(fq_plain.fq2_square(a), tower.fq2_square(a))
