"""The port's base field (``consensus_specs_tpu_torch.ops.fq``: the plain
PyTorch versions of K3 ``fq_mul``, K4 ``fq_addsub`` and the pow chains K5
``fq_pow``/K6 ``fq2_pow``) against the JAX package's ``ops/fq.py`` and
``ops/curve_jax.py`` under ``jax.jit`` and Python integers. Every
comparison is bit-exact on the limbs: both packages return canonical
residues. Inputs are seeded numpy limb arrays handed to both.

The kernels' own arithmetic (``csrc/fq.cuh``: the one-thread bodies with
the 12-bit to 32-bit repacking at their boundary, the lane-group bodies of
K3/K4 and of the K5/K6 chains, the batches that K6 and the ladders are
built on, ``mont_mul_n`` and ``sums`` with its lazy sums, with a group's
lanes run in lockstep over arrays, and K9's binary GCD) also compiles as
plain C++; where a host C++ compiler is present it is built here and held
against the plain versions and Python integers on the same inputs."""
import ctypes
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import curve_jax as jcurve
from consensus_specs_tpu.ops import fq as jfq
from consensus_specs_tpu_torch.ops import cuda_build, fq, fq_cuda, fq_plain, tower

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

# K5's lane counts: fq_pow.cu builds it on 8 lanes an element below 3,072
# elements and on 4 from there
K5_LANES = [4, 8]

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

// the pow chains of fq_pow.cu as it builds them: K5 (degree 1, elements of
// 32 limbs) on groups of either of its lane counts, 4 or 8, or K6 (degree
// 2, of 2 x 32) on 2 subgroups of 8, each with its window's table; the
// exponent as its 12 words and bit length
template <int G, int S>
void host_pow(const int32_t* a, int32_t* out, long n, int degree, const fq::lanes::Exponent& e) {
  constexpr int D = fq::lanes::kDigits / G;
  for (long i = 0; i < n; ++i) {
    fq::lanes::Lanes<uint32_t, G> x[2][D], r[2][D];
    fq::lanes::FqTable<G, fq::lanes::kWindowEntries> table1;
    fq::lanes::Fq2Table<G, fq::lanes::kWindowEntries> table2;
    for (int c = 0; c < degree; ++c) host_load<G>(x[c], a + 32 * (degree * i + c));
    if (degree == 1) fq::lanes::pow<G>(r[0], x[0], e, table1);
    else fq::lanes::fq2_pow<G, S>(r, x, e, table2);
    for (int c = 0; c < degree; ++c) host_store<G>(out + 32 * (degree * i + c), r[c]);
  }
}

// returns the reads of another lane's entry
extern "C" long host_fq_pow_lanes(const int32_t* a, int32_t* out, long n, int degree, const uint32_t* words,
                                  int bits, int lanes) {
  fq::lanes::Exponent e;
  for (int j = 0; j < fq::kWords; ++j) e.words[j] = words[j];
  e.bits = bits;
  fq::lanes::lane_faults = 0;
  if (degree == 1 && lanes == 8) host_pow<8, 1>(a, out, n, degree, e);
  else if (degree == 1) host_pow<4, 1>(a, out, n, degree, e);
  else host_pow<8, 2>(a, out, n, degree, e);
  return fq::lanes::lane_faults;
}

// fq.cuh's batch of Montgomery products for M of 2, 3 or 7 on groups of G
// lanes, as mont_mul_n (S = 1) or split over S = 2 subgroups
// (mont_mul_split): out_j = a_j b_j / R for n = a multiple of M operand
// pairs, each below 2p (a lazy sum's range)
template <int G, int M, int S>
void host_batch(const int32_t* a, const int32_t* b, int32_t* out, long n) {
  constexpr int D = fq::lanes::kDigits / G;
  for (long i = 0; i < n; i += M) {
    fq::lanes::Lanes<uint32_t, G> x[M][D], y[M][D], r[M][D];
    for (int j = 0; j < M; ++j) {
      host_load<G>(x[j], a + 32 * (i + j));
      host_load<G>(y[j], b + 32 * (i + j));
    }
    fq::lanes::mont_mul_split<G, S, M>(r, x, y);
    for (int j = 0; j < M; ++j) host_store<G>(out + 32 * (i + j), r[j]);
  }
}

template <int G, int S>
void host_batch_m(const int32_t* a, const int32_t* b, int32_t* out, long n, int m) {
  if (m == 2) host_batch<G, 2, S>(a, b, out, n);
  else if (m == 3) host_batch<G, 3, S>(a, b, out, n);
  else host_batch<G, 7, S>(a, b, out, n);
}

// returns the reads of another lane's entry, and (split) the lanes handed
// results other than their subgroup 0's
extern "C" long host_mont_mul_n(const int32_t* a, const int32_t* b, int32_t* out, long n, int m, int lanes,
                                int split) {
  fq::lanes::lane_faults = 0;
  if (lanes == 4 && split == 1) host_batch_m<4, 1>(a, b, out, n, m);
  else if (lanes == 4) host_batch_m<4, 2>(a, b, out, n, m);
  else if (split == 1) host_batch_m<8, 1>(a, b, out, n, m);
  else host_batch_m<8, 2>(a, b, out, n, m);
  return fq::lanes::lane_faults;
}

// fq.cuh's sums batch on canonical a, b: the slots kAdd, kSub and kLazyAdd
// together, then the lazy sum s into mont_mul_n as s c and s s; out holds 5
// values an element: (a + b) mod p, (a - b) mod p, s = a + b, s c / R, s s / R
template <int G>
void host_sums(const int32_t* a, const int32_t* b, const int32_t* c, int32_t* out, long n) {
  constexpr int D = fq::lanes::kDigits / G;
  constexpr fq::lanes::Kinds kOps = fq::lanes::kinds(fq::lanes::kAdd, fq::lanes::kSub, fq::lanes::kLazyAdd);
  for (long i = 0; i < n; ++i) {
    fq::lanes::Lanes<uint32_t, G> x[3][D], y[3][D], s[3][D], u[2][D], v[2][D], m[2][D];
    for (int j = 0; j < 3; ++j) {
      host_load<G>(x[j], a + 32 * i);
      host_load<G>(y[j], b + 32 * i);
    }
    fq::lanes::sums<G, 3, kOps>(s, x, y);
    host_load<G>(v[0], c + 32 * i);
    for (int k = 0; k < D; ++k) u[0][k] = u[1][k] = v[1][k] = s[2][k];
    fq::lanes::mont_mul_n<G, 2>(m, u, v);
    for (int j = 0; j < 3; ++j) host_store<G>(out + 32 * (5 * i + j), s[j]);
    for (int j = 0; j < 2; ++j) host_store<G>(out + 32 * (5 * i + 3 + j), m[j]);
  }
}

// K9's body: out = s / x mod p, one thread an element
extern "C" void host_fq_inv(const int32_t* a, int32_t* out, long n, const int32_t* s) {
  fq::InvStart start;
  for (int j = 0; j < fq::kInvLimbs; ++j) start.v[j] = s[j];
  for (long i = 0; i < n; ++i) {
    uint32_t x[32], r[32];
    for (int k = 0; k < 32; ++k) x[k] = (uint32_t)a[32 * i + k];
    fq::inv(r, x, start);
    for (int k = 0; k < 32; ++k) out[32 * i + k] = (int32_t)r[k];
  }
}

extern "C" long host_sums_lanes(const int32_t* a, const int32_t* b, const int32_t* c, int32_t* out, long n,
                                int lanes) {
  fq::lanes::lane_faults = 0;
  if (lanes == 4) host_sums<4>(a, b, c, out, n);
  else host_sums<8>(a, b, c, out, n);
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
                                                                 ctypes.c_int, ctypes.c_int]
    handle.host_fq_pow_lanes.restype = ctypes.c_long
    handle.host_mont_mul_n.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long] + [ctypes.c_int] * 3
    handle.host_mont_mul_n.restype = ctypes.c_long
    handle.host_sums_lanes.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_long, ctypes.c_int]
    handle.host_sums_lanes.restype = ctypes.c_long
    handle.host_fq_inv.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_long, ctypes.c_void_p]
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
    """K5 (degree 1, on each of fq_pow.cu's lane counts)
    and K6 (degree 2, groups of 8): fq.cuh's pow / fq2_pow (their 4-bit
    window, the table in the host's stand-in for shared memory), bit-exact
    against Python integers and the plain versions, with no read of another
    lane's entry."""
    e = fq_plain.EXPONENTS[exponent]
    words = np.array([(e >> (32 * j)) & 0xFFFFFFFF for j in range(12)], dtype=np.uint32)
    ints = POW_FQ if degree == 1 else POW_FQ2
    a = np.ascontiguousarray(fq.to_limbs(ints))
    plain = fq_plain.pow_bits if degree == 1 else fq_plain.fq2_pow_bits
    want_limbs = plain(torch.from_numpy(a), fq_plain.bits_msb(e)).numpy()
    want = [fq_plain.pow_int(x, e, degree) for x in ints]
    for lanes in K5_LANES if degree == 1 else [8]:
        out = np.zeros_like(a)
        faults = host_kernel_lib.host_fq_pow_lanes(a.ctypes.data, out.ctypes.data, len(ints), degree,
                                                   words.ctypes.data, e.bit_length(), lanes)
        assert faults == 0, f"{faults} reads of another lane's entry: the card would read its own ({lanes} lanes)"
        np.testing.assert_array_equal(out, want_limbs)
        values = fq.from_limbs(out)
        assert (list(values) if degree == 1 else [tuple(v) for v in values]) == want, lanes


# K9's inputs: POW_FQ (random values, 0, 1, p - 1, R mod p), powers of 2
# (across the 30-bit limbs' and the 12-bit limbs' edges) and values near
# 2^380 and p
INV_FQ = POW_FQ + [1 << k for k in (1, 11, 12, 29, 30, 31, 32, 59, 60, 61, 62, 191, 359, 360, 361, 379, 380)] + [
    (1 << 380) - 1, (1 << 380) + 1, (1 << 380) % P, P - 2, P // 2, int("FFF" * 31, 16) % P]


def test_inverse_kernel_arithmetic_matches_fermat(host_kernel_lib):
    """K9 (fq.cuh's fq::inv: the binary GCD, one thread an element, the
    wrapper's start value), bit-exact against Fermat's a^(p-2) in Montgomery
    form on Python integers and against its plain version,
    fq_plain.pow_bits(a, p - 2); 0 maps to 0."""
    a = np.ascontiguousarray(fq.to_limbs(INV_FQ))
    out = np.zeros_like(a)
    host_kernel_lib.host_fq_inv(a.ctypes.data, out.ctypes.data, len(INV_FQ), ctypes.addressof(fq_cuda.INV_START))
    assert list(fq.from_limbs(out)) == [fq_plain.pow_int(x, P - 2, 1) for x in INV_FQ]
    np.testing.assert_array_equal(out, fq_plain.pow_bits(torch.from_numpy(a), fq_plain.bits_msb(P - 2)).numpy())


def test_inv_takes_fermat_on_the_cpu_and_no_other_device():
    """fq.inv: the plain version (a^(p-2), fq_plain.pow_bits) for a CPU
    tensor; no kernel for any device but the card."""
    a = torch.from_numpy(A[:4])
    assert torch.equal(fq.inv(a), fq_plain.pow_bits(a, fq_plain.bits_msb(P - 2)))
    with pytest.raises(ValueError, match="no kernel"):
        fq.inv(a.to("meta"))


# a lazy sum's range: canonical values, p, and up to 2p - 1
BATCH_EDGE = [0, 1, P - 1, P, 2 * P - 1]


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("m", [2, 3, 7])
def test_batched_products_match_integers(host_kernel_lib, m, lanes, split):
    """fq.cuh's mont_mul_n (split 1: M products interleaved on one group)
    and mont_mul_split (split 2: the batch over two subgroups, each lane
    handed the other's results as the card's shuffle hands them), each
    product canonical and equal to a b / R mod p for operands below 2p
    (every pair of 0, 1, p - 1, p and 2p - 1, and random values), with no
    read of another lane's entry and every subgroup handed the same
    results."""
    pairs = [(x, y) for x in BATCH_EDGE for y in BATCH_EDGE]
    pairs += [(x, y) for x, y in zip(_rand(2 * m), (v + P for v in _rand(2 * m)))]
    pairs += [(0, 0)] * (-len(pairs) % m)
    a = np.ascontiguousarray(fq.to_limbs([x for x, _ in pairs]))
    b = np.ascontiguousarray(fq.to_limbs([y for _, y in pairs]))
    out = np.zeros_like(a)
    faults = host_kernel_lib.host_mont_mul_n(a.ctypes.data, b.ctypes.data, out.ctypes.data, len(pairs), m, lanes,
                                             split)
    assert faults == 0, f"{faults} lane faults: a read of another lane's entry, or subgroups handed different results"
    assert list(fq.from_limbs(out)) == [x * y * RINV % P for x, y in pairs]


@pytest.mark.parametrize("lanes", [4, 8])
def test_batched_sums_and_lazy_sums_into_products(host_kernel_lib, lanes):
    """fq.cuh's sums batch: kAdd and kSub canonical, kLazyAdd the exact
    unreduced a + b (up to 2p - 2); the lazy sum fed into mont_mul_n (times a
    canonical value and squared) comes out canonical."""
    a, b, ai, bi = A, B, AI, BI
    ci = _rand(len(ai) - 1) + [P - 1]
    c = np.ascontiguousarray(fq.to_limbs(ci))
    out = np.zeros((len(ai), 5, 32), dtype=np.int32)
    faults = host_kernel_lib.host_sums_lanes(np.ascontiguousarray(a).ctypes.data, np.ascontiguousarray(b).ctypes.data,
                                             c.ctypes.data, out.ctypes.data, len(ai), lanes)
    assert faults == 0, f"{faults} reads of another lane's entry: the card would read its own"
    got = fq.from_limbs(out)
    assert max(x + y for x, y in zip(ai, bi)) == 2 * P - 2  # the extreme lazy sum is among them
    for i, (x, y, z) in enumerate(zip(ai, bi, ci)):
        s = x + y
        assert list(got[i]) == [s % P, (x - y) % P, s, s * z * RINV % P, s * s * RINV % P], i
