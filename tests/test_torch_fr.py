"""The port's Fr field and FFT (``consensus_specs_tpu_torch.ops.fr_plain``,
``fft_torch``: the plain PyTorch versions of K12 ``fr_mul`` and K11
``fr_fft``) against the JAX package's ``ops/fft_jax.py`` under ``jax.jit``,
the host oracle ``crypto/fr.py`` and Python integers. Every comparison is
bit-exact on the limbs: both packages return canonical residues. Inputs
are seeded numpy limb arrays or ints handed to both.

The kernels' own arithmetic (``csrc/fr.cuh``: the 12-bit to 32-bit
packing, the CIOS product and its 8-bit step to 2^-264, the sums, and the
butterfly with its bit-reversed gather, twiddle index and n^-1 scale) also
compiles as plain C++; where a host C++ compiler is present it is built
here and a whole transform is run through it, stage by stage as the card
launches them, against the plain version."""
import ctypes
import re

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import fft_jax as jfft
from consensus_specs_tpu_torch.crypto import fr as host_fr
from consensus_specs_tpu_torch.ops import cuda_build, fft_torch, fr_cuda, fr_plain

from tests.test_torch_fq import build_host_lib

P = fr_plain.P_INT
RINV = pow(fr_plain.R_INT, -1, P)
RNG = np.random.default_rng(0xF7)
# 0, 1, r - 1, values near 2^255 and 2^254, runs of all-ones limbs, and
# R mod r, R^2 mod r (the Montgomery constants)
EDGE = [0, 1, 2, P - 1, P - 2, (P - 1) // 2, (1 << 254) - 1, 1 << 254, int("FFF" * 21, 16) % P,
        fr_plain.R_INT % P, fr_plain.R_INT ** 2 % P]


def _rand(n):
    return [int.from_bytes(RNG.bytes(32), "big") % P for _ in range(n)]


A_INTS = _rand(64) + EDGE + [x for x in EDGE for _ in EDGE]
B_INTS = _rand(64) + EDGE[::-1] + EDGE * len(EDGE)
A, B = fr_plain.to_limbs(A_INTS), fr_plain.to_limbs(B_INTS)
INT_REF = {"mul": lambda x, y: x * y * RINV % P, "add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P}


@pytest.fixture(scope="module")
def jax_ops():
    """The JAX package's field ops, jitted once for the module."""
    return {name: jax.jit(getattr(jfft, name)) for name in ("mul", "add", "sub", "to_mont", "from_mont")}


def test_limb_conversion_round_trips():
    assert np.array_equal(fr_plain.to_limbs(A_INTS), jfft.to_limbs(A_INTS))
    assert list(fr_plain.from_limbs(A)) == A_INTS
    assert list(fr_plain.from_limbs(torch.from_numpy(B))) == B_INTS


@pytest.mark.parametrize("name", ["mul", "add", "sub"])
def test_binary_ops_match_jax_and_integers(jax_ops, name):
    got = getattr(fr_plain, name)(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ops[name](A, B)))
    assert list(fr_plain.from_limbs(got)) == [INT_REF[name](x, y) for x, y in zip(A_INTS, B_INTS)]


@pytest.mark.parametrize("name", ["to_mont", "from_mont"])
def test_montgomery_conversions_match_jax(jax_ops, name):
    got = getattr(fr_plain, name)(torch.from_numpy(A)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ops[name](A)))
    factor = fr_plain.R_INT % P if name == "to_mont" else RINV
    assert list(fr_plain.from_limbs(got)) == [x * factor % P for x in A_INTS]


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_fft_device_matches_jax_at_8(inverse):
    values = _rand(8)
    assert fft_torch.fft_device(values, inverse, device="cpu") == jfft.fft_device(values, inverse)


def test_das_extension_matches_jax_at_8():
    data = _rand(8)
    assert fft_torch.das_fft_extension_device(data, device="cpu") == jfft.das_fft_extension_device(data)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_fft_matches_the_host_oracle_at_1024(inverse):
    values = _rand(1024)
    assert fft_torch.fft_device(values, inverse, device="cpu") == host_fr.fft(values, inverse)


def test_das_extension_matches_the_host_oracle_at_512():
    data = _rand(512)
    assert fft_torch.das_fft_extension_device(data, device="cpu") == host_fr.das_fft_extension(data)


def test_seam_dispatch():
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    assert torch.equal(fft_torch.mul(a, b), fr_plain.mul(a, b))
    assert torch.equal(fft_torch.add(a[:1], b), fr_plain.add(a[:1], b))  # one operand broadcast
    assert torch.equal(fft_torch.sub(a, b[:1]), fr_plain.sub(a, b[:1]))
    one = torch.from_numpy(fr_plain.to_limbs([5]))
    assert torch.equal(fft_torch.fft(one, 1), one)  # a transform of one element is that element
    before = dict(fr_cuda.launches)
    with pytest.raises(ValueError, match="no kernel"):
        fft_torch.mul(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fft_torch.fft(a[:64].to("meta"), 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fr_cuda.fr_mul(a, b)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fr_cuda.fr_fft(a[:64], 64)
    assert fr_cuda.launches == before


# -- the kernels' arithmetic, built as plain C++ ----------------------------------

_HOST_SRC = r"""
#include "fr.cuh"
extern "C" void host_fr_pointwise(const int32_t* a, const int32_t* b, int32_t* out, long n, int op) {
  for (long i = 0; i < n; ++i) {
    if (op == fr::kMul) fr::pointwise<fr::kMul>(out + fr::kLimbs * i, a + fr::kLimbs * i, b + fr::kLimbs * i);
    else if (op == fr::kAdd) fr::pointwise<fr::kAdd>(out + fr::kLimbs * i, a + fr::kLimbs * i, b + fr::kLimbs * i);
    else fr::pointwise<fr::kSub>(out + fr::kLimbs * i, a + fr::kLimbs * i, b + fr::kLimbs * i);
  }
}
// the transform as fr_fft_launch runs it: log2 n stages, each of n/2
// butterflies, the card's threads run one after another
extern "C" void host_fr_fft(const int32_t* in, uint32_t* words, int32_t* out, const uint32_t* twiddles, long n,
                            int log_n, const uint32_t* n_inv, int inverse) {
  fr::Scale scale;
  for (int j = 0; j < fr::kWords; ++j) scale.v[j] = n_inv[j];
  for (int stage = 0; stage < log_n; ++stage) {
    const bool first = stage == 0, last = stage == log_n - 1;
    for (long j = 0; j < n / 2; ++j) {
      if (first && last && inverse) fr::butterfly<true, true, true>(j, in, words, out, twiddles, log_n, stage, scale);
      else if (first && last) fr::butterfly<true, true, false>(j, in, words, out, twiddles, log_n, stage, scale);
      else if (first) fr::butterfly<true, false, false>(j, in, words, out, twiddles, log_n, stage, scale);
      else if (last && inverse) fr::butterfly<false, true, true>(j, in, words, out, twiddles, log_n, stage, scale);
      else if (last) fr::butterfly<false, true, false>(j, in, words, out, twiddles, log_n, stage, scale);
      else fr::butterfly<false, false, false>(j, in, words, out, twiddles, log_n, stage, scale);
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_fr_lib(tmp_path_factory):
    handle = build_host_lib(tmp_path_factory, "host_fr", _HOST_SRC)
    handle.host_fr_pointwise.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long, ctypes.c_int]
    handle.host_fr_fft.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_long, ctypes.c_int, ctypes.c_void_p,
                                                           ctypes.c_int]
    return handle


@pytest.mark.parametrize("op, name", [(0, "mul"), (1, "add"), (2, "sub")])
def test_kernel_pointwise_arithmetic_matches_plain_version(host_fr_lib, op, name):
    """K12's element (fr.cuh pointwise: pack, CIOS product and div_2_8, or
    the sums, unpack) against its plain version and Python integers."""
    a, b = np.ascontiguousarray(A), np.ascontiguousarray(B)
    out = np.zeros_like(a)
    host_fr_lib.host_fr_pointwise(a.ctypes.data, b.ctypes.data, out.ctypes.data, len(a), op)
    np.testing.assert_array_equal(out, getattr(fr_plain, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy())
    assert list(fr_plain.from_limbs(out)) == [INT_REF[name](x, y) for x, y in zip(A_INTS, B_INTS)]


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", [2, 4, 256])
def test_kernel_transform_matches_plain_version(host_fr_lib, n, inverse):
    """K11's stages (fr.cuh butterfly: the bit-reversed gather and packing
    of the first stage, the twiddle index, the in-place stages, n^-1 and
    the unpacking of the last) with the wrapper's own twiddle and scale
    words, against the plain transform."""
    vals = fr_plain.to_mont(torch.from_numpy(fr_plain.to_limbs(_rand(n - 2) + [0, P - 1])))
    x = np.ascontiguousarray(vals.numpy())
    words = np.zeros((n, fr_cuda.N_WORDS), dtype=np.uint32)
    out = np.zeros_like(x)
    tw = np.ascontiguousarray(fr_cuda.twiddle_words(n, inverse))
    scale = fr_cuda.words_of([pow(n, P - 2, P) * fr_cuda.WORD_R % P])[0].copy()
    host_fr_lib.host_fr_fft(x.ctypes.data, words.ctypes.data, out.ctypes.data, tw.ctypes.data, n,
                            n.bit_length() - 1, scale.ctypes.data, int(inverse))
    np.testing.assert_array_equal(out, fr_plain.fft(vals, n, inverse).numpy())


def test_ctypes_signatures_match_the_c_launchers():
    """Every function of fr_fft.cu's ``extern "C"`` block is bound with one
    ctypes type per declared parameter (a pointer or the stream as
    c_void_p, int64_t as c_int64, int as c_int, a word array as a pointer
    to c_uint32): a mismatch would pass a cut pointer or a wrong width."""
    text = (cuda_build.CSRC / "fr_fft.cu").read_text()
    block = text[text.index('extern "C" {'):]
    declared = dict(re.findall(r"^int (\w+)\(([^)]*)\)", block, re.M))
    assert set(declared) == {"fr_mul_launch", "fr_fft_launch"}
    kinds = {"int64_t": ctypes.c_int64, "int": ctypes.c_int, "const uint32_t*": ctypes.POINTER(ctypes.c_uint32)}
    bound = {"fr_mul_launch": fr_cuda.MUL_ARGTYPES, "fr_fft_launch": fr_cuda.FFT_ARGTYPES}
    for name, params in declared.items():
        types = [" ".join(p.split()[:-1]) for p in " ".join(params.split()).split(", ")]
        want = [kinds.get(t, ctypes.c_void_p) if not t.endswith("void*") else ctypes.c_void_p for t in types]
        assert bound[name] == want, name
