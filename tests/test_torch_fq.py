"""The port's base field (``consensus_specs_tpu_torch.ops.fq``: the plain
PyTorch versions of K3 ``fq_mul`` and K4 ``fq_addsub``) against the JAX
package's ``ops/fq.py`` under ``jax.jit`` and Python integers. Every
comparison is bit-exact on the limbs: both packages return canonical
residues. Inputs are seeded numpy limb arrays handed to both.

The kernels' own arithmetic (``csrc/fq.cuh``, including the 12-bit to
32-bit repacking at K3's boundary) also compiles as plain C++; where a host
C++ compiler is present it is built here and held against the plain
versions on the same inputs."""
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
    ripples through runs of 0xFFF and 0x000 limbs, 0, 1, p-1)."""
    a = _rand(96) + EDGE * len(EDGE)
    b = _rand(96) + [v for v in EDGE for _ in EDGE]
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
    return handle


@pytest.mark.parametrize("op", [0, 1, 2, 3, 4])
def test_kernel_arithmetic_matches_plain_versions(host_kernel_lib, op):
    a, b = np.ascontiguousarray(A), np.ascontiguousarray(B)
    out = np.zeros_like(a)
    host_kernel_lib.host_fq(a.ctypes.data, b.ctypes.data, out.ctypes.data, len(a), op)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if op == 4:
        want = ta  # 12-bit limbs -> 32-bit words -> 12-bit limbs
    elif op == 3:
        want = fq_plain.mul(ta, tb)
    else:
        want = fq_plain.addsub(ta, tb, op)
    np.testing.assert_array_equal(out, want.numpy())
