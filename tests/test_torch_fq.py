"""The port's base field (``consensus_specs_tpu_torch.ops.fq``: the plain
PyTorch versions of K3 ``fq_mul``, K4 ``fq_addsub`` and the pow chains K5
``fq_pow``/K6 ``fq2_pow``) against the JAX package's ``ops/fq.py`` and
``ops/curve_jax.py`` under ``jax.jit`` and Python integers. Every
comparison is bit-exact on the limbs: both packages return canonical
residues. Inputs are seeded numpy limb arrays handed to both.

The kernels' own arithmetic (``csrc/fq.cuh``: the one-thread bodies with
the 12-bit to 32-bit repacking at their boundary, and the lane-group bodies
of K3/K4 and of the K5/K6 chains with a group's lanes run in lockstep over
arrays) also compiles as plain C++; where a host C++ compiler is present it
is built here and held against the plain versions and Python integers on
the same inputs."""
import ctypes
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import curve_jax as jcurve
from consensus_specs_tpu.ops import fq as jfq
from consensus_specs_tpu_torch.ops import cuda_build, fq, fq_plain, tower

P = fq.P_INT
RINV = pow(1 << 384, -1, P)
RNG = np.random.default_rng(0xF0)
EDGE = [0, 1, 2, P - 1, P - 2, (P - 1) // 2, (1 << 380) % P, int("FFF" * 31, 16) % P, (1 << 371) - 1, 1 << 370]
# sums just below, at and just above p; carries and borrows through every
# limb and every lane of a group (2^380 - 1 is all ones below p's top bit)
PAIRS = [(x, (P + d - x) % P) for x in (1, 5, P // 2, (1 << 380) - 1) for d in (-1, 0, 1)] + [
    ((1 << 380) - 1, 1), (1 << 380, 1), (1, 1 << 380), ((1 << 380) - 1, (1 << 380) - 1), (0, P - 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(n):
    return [int.from_bytes(RNG.bytes(48), "big") % P for _ in range(n)]


def _operands():
    """Random values, then every pair of edge values (carry and borrow
    ripples through runs of 0xFFF and 0x000 limbs, 0, 1, p-1), then PAIRS."""
    a = _rand(96) + EDGE * len(EDGE) + [x for x, _ in PAIRS]
    b = _rand(96) + [v for v in EDGE for _ in EDGE] + [y for _, y in PAIRS]
    return fq.to_limbs(a), fq.to_limbs(b), a, b


A, B, AI, BI = _operands()
_JIT = {name: jax.jit(getattr(jfq, name)) for name in ("add", "sub", "neg", "mul", "inv")}


def _jax(name, *args):
    return np.asarray(_JIT[name](*args))


def _port(name, *args):
    return getattr(fq, name)(*(torch.from_numpy(np.asarray(a)) for a in args)).numpy()


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_binary_ops_match_jax(name):
    got = _port(name, A, B)
    np.testing.assert_array_equal(got, _jax(name, A, B))
    op = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P, "mul": lambda x, y: x * y * RINV % P}
    assert list(fq.from_limbs(got)) == [op[name](x, y) for x, y in zip(AI, BI)]


def test_neg_matches_jax_and_maps_zero_to_zero():
    got = _port("neg", A)
    np.testing.assert_array_equal(got, _jax("neg", A))
    assert list(fq.from_limbs(got)) == [(-x) % P for x in AI]
    assert int(fq.from_limbs(_port("neg", fq.to_limbs([0])))[0]) == 0


def test_mont_round_trip_and_inverse():
    a = np.stack([A[:8], fq.to_limbs([0, 1, P - 1] + [0] * 5)])
    m = fq.to_mont(torch.from_numpy(a))
    np.testing.assert_array_equal(fq.from_mont(m).numpy(), a)
    inv = fq.inv(m)
    np.testing.assert_array_equal(inv.numpy(), _jax("inv", m.numpy()))
    want = [pow(int(v), P - 2, P) for v in fq.from_limbs(a).ravel()]  # 0 -> 0
    assert list(fq.from_limbs(fq.from_mont(inv)).ravel()) == want
    # the pow chains' seams against the JAX package's, on seeded elements
    x, x2 = m[0, :3], m[0, 4:8].reshape(2, 2, 32)
    sqrt_bits, a1_bits = jcurve._FQ_SQRT_BITS, jcurve._FQ2_SQRT_A1_BITS
    np.testing.assert_array_equal(fq.pow_bits(x, sqrt_bits.tolist()).numpy(),
                                  np.asarray(jax.jit(lambda v: jcurve.fq_pow_bits(v, sqrt_bits))(x.numpy())))
    np.testing.assert_array_equal(tower.fq2_pow_bits(x2, a1_bits.tolist()).numpy(),
                                  np.asarray(jax.jit(lambda v: jcurve.fq2_pow_bits(v, a1_bits))(x2.numpy())))


def test_broadcasting_and_shapes():
    a = torch.from_numpy(A[:6]).reshape(3, 2, 32)
    b = torch.from_numpy(B[0])
    got = fq.mul(a, b)
    assert got.shape == (3, 2, 32) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax("mul", A[:6].reshape(3, 2, 32), B[0]))


def test_geq_is_lexicographic():
    x = torch.from_numpy(fq.to_limbs([5, 1 << 300, P - 1, 7, 0]))
    y = torch.from_numpy(fq.to_limbs([5, (1 << 300) + 1, P - 2, 8, 0]))
    assert fq.geq(x, y).tolist() == [True, False, True, False, True]


def test_wrappers_dispatch_cpu_tensors_to_the_plain_versions():
    a, b = torch.from_numpy(A[:4]), torch.from_numpy(B[:4])
    assert torch.equal(fq.mul(a, b), fq_plain.mul(a, b))
    assert torch.equal(fq.sub(a, b), fq_plain.addsub(a, b, fq_plain.OP_SUB))
    with pytest.raises(ValueError, match="no kernel"):
        fq.add(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fq.pow_bits(a.to("meta"), [1, 1])
    with pytest.raises(ValueError, match="no kernel"):
        tower.fq2_pow_bits(a.view(2, 2, 32).to("meta"), [1, 1])


# the lane-group bodies' loads and stores, G lanes an element; lane l's
# digits D l + k are limbs 2 (D l + k) and 2 (D l + k) + 1, as fq.cuh's
# load_digits and store_digits move them (shared with the ladder test)
HOST_DIGITS_SRC = r"""
template <int G>
void host_load(fq::lanes::Lanes<uint32_t, G> x[fq::lanes::kDigits / G], const int32_t* src) {
  constexpr int D = fq::lanes::kDigits / G;
  for (int l = 0; l < G; ++l)
    for (int k = 0; k < D; ++k) {
      const int j = 2 * (D * l + k);
      x[k].v[l] = (uint32_t)src[j] | ((uint32_t)src[j + 1] << 12);
    }
}

template <int G>
void host_store(int32_t* dst, const fq::lanes::Lanes<uint32_t, G> r[fq::lanes::kDigits / G]) {
  constexpr int D = fq::lanes::kDigits / G;
  for (int l = 0; l < G; ++l)
    for (int k = 0; k < D; ++k) {
      const int j = 2 * (D * l + k);
      dst[j] = (int32_t)(r[k].v[l] & 0xfffu);
      dst[j + 1] = (int32_t)(r[k].v[l] >> 12);
    }
}
"""

_HOST_SRC = r"""
#include "fq.cuh"
extern "C" void host_fq(const int32_t* a, const int32_t* b, int32_t* out, long n, int op) {
  for (long i = 0; i < n; ++i) {
    uint32_t la[32], lb[32], x[12], y[12], r[12], lo[32];
    for (int k = 0; k < 32; ++k) { la[k] = (uint32_t)a[32 * i + k]; lb[k] = (uint32_t)b[32 * i + k]; }
    fq::pack(x, la);
    fq::pack(y, lb);
    if (op == 3) fq::mont_mul(r, x, y);
    else if (op == 4) for (int k = 0; k < 12; ++k) r[k] = x[k];  // repack round trip
    else if (op == 0) fq::add_mod(r, x, y);
    else { uint32_t z[12] = {0}; fq::sub_mod(r, op == 2 ? z : x, y); }
    fq::unpack(lo, r);
    for (int k = 0; k < 32; ++k) out[32 * i + k] = (int32_t)lo[k];
  }
}
""" + HOST_DIGITS_SRC + r"""
template <int G>
void host_lanes(const int32_t* a, const int32_t* b, int32_t* out, long n, int op) {
  constexpr int D = fq::lanes::kDigits / G;
  for (long i = 0; i < n; ++i) {
    fq::lanes::Lanes<uint32_t, G> x[D], y[D], r[D];
    host_load<G>(x, a + 32 * i);
    host_load<G>(y, b + 32 * i);
    if (op == 3) fq::lanes::mont_mul<G>(r, x, y);
    else fq::lanes::addsub<G>(r, x, y, op);
    host_store<G>(out + 32 * i, r);
  }
}

// returns the reads of another lane's entry (fq::lanes::lane_faults): 0
// where the bodies keep to the rule that makes the lockstep run the card's
extern "C" long host_fq_lanes(const int32_t* a, const int32_t* b, int32_t* out, long n, int op, int lanes) {
  fq::lanes::lane_faults = 0;
  if (lanes == 4) host_lanes<4>(a, b, out, n, op);
  else host_lanes<8>(a, b, out, n, op);
  return fq::lanes::lane_faults;
}

// the pow chains of fq_pow.cu on groups of 4 lanes: K5 (degree 1, elements
// of 32 limbs) or K6 (degree 2, of 2 x 32), the exponent as its 12 words
// and bit length; returns the reads of another lane's entry
extern "C" long host_fq_pow_lanes(const int32_t* a, int32_t* out, long n, int degree, const uint32_t* words,
                                  int bits) {
  constexpr int G = 4, D = fq::lanes::kDigits / G;
  fq::lanes::Exponent e;
  for (int j = 0; j < fq::kWords; ++j) e.words[j] = words[j];
  e.bits = bits;
  fq::lanes::lane_faults = 0;
  for (long i = 0; i < n; ++i) {
    fq::lanes::Lanes<uint32_t, G> x[2][D], r[2][D];
    for (int c = 0; c < degree; ++c) host_load<G>(x[c], a + 32 * (degree * i + c));
    if (degree == 1) fq::lanes::pow<G>(r[0], x[0], e);
    else fq::lanes::fq2_pow<G>(r, x, e);
    for (int c = 0; c < degree; ++c) host_store<G>(out + 32 * (degree * i + c), r[c]);
  }
  return fq::lanes::lane_faults;
}
"""


def build_host_lib(tmp_path_factory, name: str, src: str):
    """``src`` built with the host C++ compiler against csrc/ and loaded;
    skips where there is no compiler."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip(f"no host C++ compiler to build {name} with")
    d = tmp_path_factory.mktemp(name)
    (d / f"{name}.cpp").write_text(src)
    lib = d / f"lib{name}.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    f"-I{cuda_build.CSRC}", "-o", str(lib), str(d / f"{name}.cpp")], check=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_kernel_lib(tmp_path_factory):
    handle = build_host_lib(tmp_path_factory, "host_fq", _HOST_SRC)
    handle.host_fq.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long, ctypes.c_int]
    handle.host_fq_lanes.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long, ctypes.c_int, ctypes.c_int]
    handle.host_fq_lanes.restype = ctypes.c_long
    handle.host_fq_pow_lanes.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
                                                                 ctypes.c_int]
    handle.host_fq_pow_lanes.restype = ctypes.c_long
    return handle


# op 0/1/2 add/sub/neg (K4), 3 the product (K3), 4 the one-thread repacking
# alone; lanes 0 is the one-thread arithmetic, 4 and 8 the lane-group bodies
# (fq.cu builds K3 with 4 lanes and K4 with 8; fq.cuh takes either)
_CASES = [pytest.param(op, 0, id=str(op)) for op in range(5)] + [
    pytest.param(op, g, id=f"lanes{g}-{op}") for g in (4, 8) for op in range(4)]


@pytest.mark.parametrize("op, lanes", _CASES)
def test_kernel_arithmetic_matches_plain_versions(host_kernel_lib, op, lanes):
    a, b = np.ascontiguousarray(A), np.ascontiguousarray(B)
    out = np.zeros_like(a)
    if lanes:
        faults = host_kernel_lib.host_fq_lanes(a.ctypes.data, b.ctypes.data, out.ctypes.data, len(a), op, lanes)
        assert faults == 0, f"{faults} reads of another lane's entry: the card would read its own"
    else:
        host_kernel_lib.host_fq(a.ctypes.data, b.ctypes.data, out.ctypes.data, len(a), op)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if op == 4:
        want = ta  # 12-bit limbs -> 32-bit words -> 12-bit limbs
    elif op == 3:
        want = fq_plain.mul(ta, tb)
    else:
        want = fq_plain.addsub(ta, tb, op)
    np.testing.assert_array_equal(out, want.numpy())


# random values and the edge values
POW_FQ = _rand(6) + fq_plain.POW_EDGES[1]
POW_FQ2 = [tuple(_rand(2)) for _ in range(3)] + fq_plain.POW_EDGES[2]


@pytest.mark.parametrize("exponent", list(fq_plain.EXPONENTS))
@pytest.mark.parametrize("degree", [1, 2])
def test_pow_chain_arithmetic_matches_integers_and_plain_versions(host_kernel_lib, degree, exponent):
    """K5 (degree 1) and K6 (degree 2): fq.cuh's pow / fq2_pow on groups of
    4 lanes, bit-exact against Python integers and the plain versions, with
    no read of another lane's entry."""
    e = fq_plain.EXPONENTS[exponent]
    words = np.array([(e >> (32 * j)) & 0xFFFFFFFF for j in range(12)], dtype=np.uint32)
    ints = POW_FQ if degree == 1 else POW_FQ2
    a = np.ascontiguousarray(fq.to_limbs(ints))
    out = np.zeros_like(a)
    faults = host_kernel_lib.host_fq_pow_lanes(a.ctypes.data, out.ctypes.data, len(ints), degree, words.ctypes.data,
                                               e.bit_length())
    assert faults == 0, f"{faults} reads of another lane's entry: the card would read its own"
    plain = fq_plain.pow_bits if degree == 1 else fq_plain.fq2_pow_bits
    np.testing.assert_array_equal(out, plain(torch.from_numpy(a), fq_plain.bits_msb(e)).numpy())
    values = fq.from_limbs(out)
    want = [fq_plain.pow_int(x, e, degree) for x in ints]
    assert (list(values) if degree == 1 else [tuple(v) for v in values]) == want
