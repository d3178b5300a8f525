"""The port's base field (``consensus_specs_tpu_torch.ops.fq``: the plain
PyTorch versions of K3 ``fq_mul`` and K4 ``fq_addsub``) against the JAX
package's ``ops/fq.py`` under ``jax.jit`` and Python integers. Every
comparison is bit-exact on the limbs: both packages return canonical
residues. Inputs are seeded numpy limb arrays handed to both.

The kernels' own arithmetic (``csrc/fq.cuh``: the one-thread bodies with
the 12-bit to 32-bit repacking at their boundary, and the lane-group bodies
of K3/K4 with a group's lanes run in lockstep over arrays) also compiles as
plain C++; where a host C++ compiler is present it is built here and held
against the plain versions on the same inputs."""
import ctypes
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import fq as jfq
from consensus_specs_tpu_torch.ops import cuda_build, fq, fq_plain

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

// the lane-group bodies, G lanes an element; lane l's digits D l + k are
// limbs 2 (D l + k) and 2 (D l + k) + 1, as fq.cu loads and stores them
template <int G>
void host_lanes(const int32_t* a, const int32_t* b, int32_t* out, long n, int op) {
  constexpr int D = fq::lanes::kDigits / G;
  for (long i = 0; i < n; ++i) {
    fq::lanes::Lanes<uint32_t, G> x[D], y[D], r[D];
    for (int l = 0; l < G; ++l)
      for (int k = 0; k < D; ++k) {
        const long j = 32 * i + 2 * (D * l + k);
        x[k].v[l] = (uint32_t)a[j] | ((uint32_t)a[j + 1] << 12);
        y[k].v[l] = (uint32_t)b[j] | ((uint32_t)b[j + 1] << 12);
      }
    if (op == 3) fq::lanes::mont_mul<G>(r, x, y);
    else fq::lanes::addsub<G>(r, x, y, op);
    for (int l = 0; l < G; ++l)
      for (int k = 0; k < D; ++k) {
        const long j = 32 * i + 2 * (D * l + k);
        out[j] = (int32_t)(r[k].v[l] & 0xfffu);
        out[j + 1] = (int32_t)(r[k].v[l] >> 12);
      }
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
"""


@pytest.fixture(scope="module")
def host_kernel_lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/fq.cuh with")
    d = tmp_path_factory.mktemp("fq_host")
    (d / "host_fq.cpp").write_text(_HOST_SRC)
    lib = d / "libhostfq.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
                    f"-I{cuda_build.CSRC}", "-o", str(lib), str(d / "host_fq.cpp")], check=True)
    handle = ctypes.CDLL(str(lib))
    handle.host_fq.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long, ctypes.c_int]
    handle.host_fq_lanes.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long, ctypes.c_int, ctypes.c_int]
    handle.host_fq_lanes.restype = ctypes.c_long
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
