"""The port's Fr field and FFT (``consensus_specs_tpu_torch.ops.fr_plain``,
``fft_torch``: the plain PyTorch versions of K12 ``fr_mul`` and K11
``fr_fft``) against the JAX package's ``ops/fft_jax.py`` under ``jax.jit``,
the host oracle ``crypto/fr.py`` and Python integers. Every comparison is
bit-exact on the limbs: both packages return canonical residues. Inputs
are seeded numpy limb arrays or ints handed to both.

The kernels' own code (``csrc/fr.cuh``: the 12-bit to 32-bit packing, the
product and its 8-bit step to 2^-264, the sums, K12's tile and K11's pass
body with its bit-reversed gather, tile geometry, twiddle index and n^-1
scale) also compiles as plain C++; where a host C++ compiler is present it
is built here and run with a block's threads one after another, a step at
a time (``fr::HostBlock``): K12 tile by tile, a whole transform pass by
pass as the card launches them, against the plain version."""
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
#include <vector>
#include "fr.cuh"
extern "C" void host_fr_pointwise(const int32_t* a, const int32_t* b, int32_t* out, long n, int op) {
  for (long i = 0; i < n; ++i) {
    if (op == fr::kMul) fr::pointwise<fr::kMul>(out + fr::kLimbs * i, a + fr::kLimbs * i, b + fr::kLimbs * i);
    else if (op == fr::kAdd) fr::pointwise<fr::kAdd>(out + fr::kLimbs * i, a + fr::kLimbs * i, b + fr::kLimbs * i);
    else fr::pointwise<fr::kSub>(out + fr::kLimbs * i, a + fr::kLimbs * i, b + fr::kLimbs * i);
  }
}
// K12 as fr_mul_launch runs it: a block a tile, its steps on each thread in
// turn; the tile's spans copied in 16-byte pieces (wide) or 8-byte ones
template <bool kWide>
void tiles(const int32_t* a, long sa, const int32_t* b, long sb, int32_t* out, long n, int op) {
  std::vector<int32_t> ta(fr::kTileRows * fr::kLimbs), tb(fr::kTileRows * fr::kLimbs), one(2 * fr::kLimbs);
  fr::HostBlock blk{fr::kTileRows};
  for (long tile = 0; tile * fr::kTileRows < n; ++tile) {
    auto run = [&](auto k) { k(blk, tile, n, a, sa, b, sb, out, ta.data(), tb.data(), one.data()); };
    if (op == fr::kMul) run(fr::pointwise_tile<fr::kMul, kWide, fr::HostBlock>);
    else if (op == fr::kAdd) run(fr::pointwise_tile<fr::kAdd, kWide, fr::HostBlock>);
    else run(fr::pointwise_tile<fr::kSub, kWide, fr::HostBlock>);
  }
}
extern "C" void host_fr_tiles(const int32_t* a, long sa, const int32_t* b, long sb, int32_t* out, long n, int op,
                              int wide) {
  if (wide) tiles<true>(a, sa, b, sb, out, n, op);
  else tiles<false>(a, sa, b, sb, out, n, op);
}
// K11 as fr_fft_launch runs it, in passes of at most max_stages stages
// (the card's kPassStages, or fewer to force more passes): each pass's
// blocks one after another, each block's steps on each thread in turn
extern "C" int host_fr_fft(const int32_t* in, uint32_t* words, int32_t* out, const uint32_t* twiddles, int log_n,
                           const uint32_t* n_inv, int inverse, int max_stages) {
  fr::Scale scale;
  for (int j = 0; j < fr::kWords; ++j) scale.v[j] = n_inv[j];
  const int passes = fr::pass_count(log_n, max_stages);
  for (int p = 0; p < passes; ++p) {
    const fr::Pass ps = fr::pass_plan(log_n, max_stages, p);
    const bool first = p == 0, last = p == passes - 1;
    std::vector<uint32_t> smem(fr::pass_smem_words(ps, first || last));
    fr::HostBlock blk{ps.threads()};
    for (int64_t b = 0; b < ps.blocks(); ++b) {
      auto run = [&](auto pass) { pass(blk, ps, b, in, words, out, twiddles, scale, smem.data()); };
      if (first && last && inverse) run(fr::fft_pass<true, true, true, fr::HostBlock>);
      else if (first && last) run(fr::fft_pass<true, true, false, fr::HostBlock>);
      else if (first) run(fr::fft_pass<true, false, false, fr::HostBlock>);
      else if (last && inverse) run(fr::fft_pass<false, true, true, fr::HostBlock>);
      else if (last) run(fr::fft_pass<false, true, false, fr::HostBlock>);
      else run(fr::fft_pass<false, false, false, fr::HostBlock>);
    }
  }
  return passes;
}
extern "C" int host_fr_pass_stages() { return fr::kPassStages; }
extern "C" int host_fr_tile_rows() { return fr::kTileRows; }
// pass p's first stage, stages, tile rows (log2) and adjacent groups (log2)
extern "C" void host_fr_pass_plan(int log_n, int max_stages, int p, int* plan) {
  const fr::Pass ps = fr::pass_plan(log_n, max_stages, p);
  plan[0] = ps.s0, plan[1] = ps.stages, plan[2] = ps.lg_rows, plan[3] = ps.lg_lo;
}
"""


@pytest.fixture(scope="module")
def host_fr_lib(tmp_path_factory):
    handle = build_host_lib(tmp_path_factory, "host_fr", _HOST_SRC)
    handle.host_fr_pointwise.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long, ctypes.c_int]
    handle.host_fr_tiles.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                                     ctypes.c_long, ctypes.c_int, ctypes.c_int]
    handle.host_fr_fft.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    handle.host_fr_pass_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return handle


@pytest.mark.parametrize("op, name", [(0, "mul"), (1, "add"), (2, "sub")])
def test_kernel_pointwise_arithmetic_matches_plain_version(host_fr_lib, op, name):
    """K12's element (fr.cuh pointwise: pack, product and div_2_8, or the
    sums, unpack) against its plain version and Python integers."""
    a, b = np.ascontiguousarray(A), np.ascontiguousarray(B)
    out = np.zeros_like(a)
    host_fr_lib.host_fr_pointwise(a.ctypes.data, b.ctypes.data, out.ctypes.data, len(a), op)
    np.testing.assert_array_equal(out, getattr(fr_plain, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy())
    assert list(fr_plain.from_limbs(out)) == [INT_REF[name](x, y) for x, y in zip(A_INTS, B_INTS)]


def _host_tiles(lib, op, name, one, wide):
    n = lib.host_fr_tile_rows() + 73  # a full tile and a short last one of an odd count of rows
    ai, bi = (A_INTS + B_INTS)[:n], (B_INTS + A_INTS)[:n]
    if one == "a":
        ai = ai[:1]
    if one == "b":
        bi = bi[:1]
    a, b = np.ascontiguousarray(fr_plain.to_limbs(ai)), np.ascontiguousarray(fr_plain.to_limbs(bi))
    out = np.full((n, fr_plain.N_LIMBS), -1, dtype=np.int32)
    lib.host_fr_tiles(a.ctypes.data, 0 if one == "a" else fr_plain.N_LIMBS, b.ctypes.data,
                      0 if one == "b" else fr_plain.N_LIMBS, out.ctypes.data, n, op, wide)
    want = getattr(fr_plain, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert want.shape[0] == n
    np.testing.assert_array_equal(out, want)
    ai, bi = ai * (n if one == "a" else 1), bi * (n if one == "b" else 1)
    assert list(fr_plain.from_limbs(out)) == [INT_REF[name](x, y) for x, y in zip(ai, bi)]


@pytest.mark.parametrize("op, name", [(0, "mul"), (1, "add"), (2, "sub")])
@pytest.mark.parametrize("one", ["none", "a", "b"], ids=["rows", "a-stride0", "b-stride0"])
def test_kernel_tiles_match_plain_version(host_fr_lib, op, name, one):
    """K12's tiles as the card runs them on 16-byte aligned tensors (fr.cuh
    pointwise_tile: the spans staged in 16-byte pieces and the last 8 bytes
    of an odd count of rows, each thread's row packed from shared memory,
    the op, the staged store) over one full tile and a short last one,
    with either operand one element read at stride 0, against the plain
    version and Python integers."""
    _host_tiles(host_fr_lib, op, name, one, wide=1)


@pytest.mark.parametrize("op, name", [(0, "mul"), (1, "add"), (2, "sub")])
@pytest.mark.parametrize("one", ["none", "a", "b"], ids=["rows", "a-stride0", "b-stride0"])
def test_kernel_tiles_in_8_byte_pieces_match_plain_version(host_fr_lib, op, name, one):
    """K12's tiles as the card runs them on tensors only 8-byte aligned:
    the spans staged in 8-byte pieces; otherwise as above."""
    _host_tiles(host_fr_lib, op, name, one, wide=0)


def _host_transform(lib, n, inverse, max_stages):
    vals = fr_plain.to_mont(torch.from_numpy(fr_plain.to_limbs(_rand(n - 2) + [0, P - 1])))
    x = np.ascontiguousarray(vals.numpy())
    words = np.zeros((n, fr_cuda.N_WORDS), dtype=np.uint32)
    out = np.zeros_like(x)
    tw = np.ascontiguousarray(fr_cuda.twiddle_words(n, inverse))
    scale = fr_cuda.words_of([pow(n, P - 2, P) * fr_cuda.WORD_R % P])[0].copy()
    passes = lib.host_fr_fft(x.ctypes.data, words.ctypes.data, out.ctypes.data, tw.ctypes.data, n.bit_length() - 1,
                             scale.ctypes.data, int(inverse), max_stages)
    np.testing.assert_array_equal(out, fr_plain.fft(vals, n, inverse).numpy())
    return passes


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", [2, 4, 256])
def test_kernel_transform_matches_plain_version(host_fr_lib, n, inverse):
    """K11's pass body (fr.cuh fft_pass: the bit-reversed gather and packing
    of the first pass, the tile geometry and twiddle index, the stages in
    shared memory, n^-1 and the unpacking of the last) at the card's own
    kPassStages, with the wrapper's own twiddle and scale words, against
    the plain transform: one pass at each of these sizes."""
    assert _host_transform(host_fr_lib, n, inverse, fr_cuda.FFT_PASS_STAGES) == fr_cuda.fft_passes(n) == 1


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n, max_stages, plan", [
    (256, 3, [(0, 3, 3, 0), (3, 3, 3, 0), (6, 2, 3, 1)]),  # a pass mid-transform, a short last pass
    (128, 3, [(0, 3, 3, 0), (3, 3, 3, 0), (6, 1, 3, 2)]),  # a last pass of one stage, 4 groups a tile
    (2048, 8, [(0, 6, 6, 0), (6, 5, 6, 1)]),  # the card's own: two passes, the last short
], ids=["256-T3", "128-T3", "2048-T8"])
def test_kernel_transform_in_passes_matches_plain_version(host_fr_lib, n, max_stages, plan, inverse):
    """K11's pass body over several passes: passes that start mid-transform
    (read and write the word rows), short last passes with several groups
    of adjacent rows a tile, and the plan (first stage, stages, log2 tile
    rows, log2 groups a tile) each pass is launched with."""
    log_n = n.bit_length() - 1
    got = []
    for p in range(len(plan)):
        cell = (ctypes.c_int * 4)()
        host_fr_lib.host_fr_pass_plan(log_n, max_stages, p, cell)
        got.append(tuple(cell))
    assert got == plan
    assert _host_transform(host_fr_lib, n, inverse, max_stages) == len(plan)


def test_pass_count_matches_the_launcher(host_fr_lib):
    """The wrapper's plan and count of K11 launches (``fr_cuda.fft_plan``,
    ``fft_passes``: what ``launches`` adds) are fr_fft_launch's:
    ceil(log2 n / kPassStages) passes of fr.cuh's kPassStages, at most 3 up
    to 2^24 rows, 2 at the main path's 16,384 and 32,768."""
    assert host_fr_lib.host_fr_pass_stages() == fr_cuda.FFT_PASS_STAGES
    for log_n in range(1, 25):
        cell = (ctypes.c_int * 4)()
        count = -(-log_n // host_fr_lib.host_fr_pass_stages())
        assert fr_cuda.fft_passes(1 << log_n) == count <= 3
        for p, want in enumerate(fr_cuda.fft_plan(1 << log_n)):
            host_fr_lib.host_fr_pass_plan(log_n, fr_cuda.FFT_PASS_STAGES, p, cell)
            assert (cell[0], cell[1]) == want
            assert cell[3] <= cell[0]  # a tile's groups differ only below its first stage
        assert cell[0] + cell[1] == log_n  # the passes end at the last stage
    assert fr_cuda.fft_passes(16384) == fr_cuda.fft_passes(32768) == 2


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
