"""The port's SHA-256 (plain PyTorch versions of K1/K2, the multi-level
reductions and the five ``ssz.hashing`` seams on ``device="cpu"``) against
the JAX package's XLA graphs and seams, and hashlib. SHA-256 has no
tolerance: every comparison is bit-exact. Inputs are seeded numpy arrays
handed to both packages."""
import hashlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_specs_tpu.ops import sha256 as jdev
from consensus_specs_tpu_torch.interop import words_from_numpy, words_to_numpy
from consensus_specs_tpu_torch.ops import sha256 as tdev
from consensus_specs_tpu_torch.ops import sha256_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread, so that test workers running in
    parallel are not crowded out by torch's thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, size=(n, 16), dtype=np.uint32)


def _hashlib_rows(raw: bytes) -> bytes:
    return b"".join(hashlib.sha256(raw[64 * i : 64 * i + 64]).digest() for i in range(len(raw) // 64))


@pytest.mark.parametrize("n", [1, 3, 1000, 4096])
def test_sha256_blocks_matches_jax_and_hashlib(n):
    words = _words(n, n)
    got = tdev.sha256_blocks(words_from_numpy(words))
    assert np.array_equal(words_to_numpy(got), np.asarray(jdev.sha256_blocks_jit(jnp.asarray(words))))
    assert got.numpy().tobytes() == _hashlib_rows(words.astype(">u4").tobytes())


@pytest.mark.parametrize("n", [1, 3, 1000, 4096])
def test_sha256_raw_blocks_matches_jax_and_hashlib(n):
    rng = np.random.default_rng(100 + n)
    msgs = [rng.bytes(int(k)) for k in rng.integers(0, 56, size=n)]
    buf = bytearray(64 * n)
    for i, m in enumerate(msgs):  # the standard one-block padding
        buf[64 * i : 64 * i + len(m)] = m
        buf[64 * i + len(m)] = 0x80
        buf[64 * i + 56 : 64 * i + 64] = (8 * len(m)).to_bytes(8, "big")
    words = np.frombuffer(bytes(buf), dtype=">u4").astype(np.uint32).reshape(n, 16)
    got = tdev.sha256_raw_blocks(words_from_numpy(words))
    assert np.array_equal(words_to_numpy(got), np.asarray(jdev.sha256_raw_blocks_jit(jnp.asarray(words))))
    assert got.numpy().tobytes() == b"".join(hashlib.sha256(m).digest() for m in msgs)


def test_wrapper_on_cpu_is_the_plain_version():
    x = words_from_numpy(_words(5, 9))
    assert tdev.sha256_blocks(x).numpy().tobytes() == sha256_plain.sha256_blocks(x).numpy().tobytes()


def test_merkle_reductions_match_jax():
    chunks = np.random.default_rng(3).integers(0, 2**32, size=(64, 8), dtype=np.uint32)
    t = words_from_numpy(chunks)
    assert np.array_equal(words_to_numpy(tdev.merkle_reduce(t, 6)),
                          np.asarray(jdev.merkle_reduce_jit(jnp.asarray(chunks), 6)))
    want = jdev.merkle_levels_jit(jnp.asarray(chunks), 6)
    got = tdev.merkle_levels(t, 6)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert np.array_equal(words_to_numpy(g), np.asarray(w))
    assert np.array_equal(words_to_numpy(tdev.item_roots(t, 3)),
                          np.asarray(jdev.item_roots_jit(jnp.asarray(chunks), 3)))


def test_seams_match_jax():
    rng = np.random.default_rng(11)
    data = rng.bytes(64 * 37)
    assert tdev.hash_many_device(data, device="cpu") == jdev.hash_many_device(data)

    msgs = [rng.bytes(k) for k in (0, 1, 32, 37, 55)]
    assert tdev.hash_small_device(msgs, device="cpu") == jdev.hash_small_device(msgs)
    with pytest.raises(ValueError):
        tdev.hash_small_device([b"\x00" * 56], device="cpu")

    for n, limit in [(0, 16), (1, 1), (5, 2**32), (8, 8), (13, 16)]:
        chunks = rng.bytes(32 * n)
        assert tdev.merkle_root_device(chunks, limit, device="cpu") == jdev.merkle_root_device(chunks, limit), (n, limit)

    leaves = rng.bytes(32 * 24)
    assert tdev.tree_levels_device(leaves, device="cpu") == jdev.tree_levels_device(leaves)

    packed = rng.bytes(32 * 8 * 10)
    assert tdev.item_roots_device(packed, 8, device="cpu") == jdev.item_roots_device(packed, 8)


def test_kpad_folds_the_padding_schedule():
    # K + W_pad of a 64-byte message, the constant table the kernel carries
    assert sha256_plain.KPAD[0] == (sha256_plain.K[0] + 0x80000000) & 0xFFFFFFFF
    assert sha256_plain.KPAD[15] == (sha256_plain.K[15] + 512) & 0xFFFFFFFF
    assert sha256_plain.KPAD == tuple(
        (int(k) + int(w)) & 0xFFFFFFFF for k, w in zip(jdev._K, jdev._PAD_W)
    )


def test_kernel_source_carries_the_same_constants():
    src = (Path(tdev.__file__).parent / "csrc" / "sha256.cu").read_text()

    def table(name):
        body = re.search(rf"__constant__ uint32_t {name}\[64\] = \{{(.*?)\}};", src, re.S).group(1)
        return tuple(int(x, 16) for x in re.findall(r"0x([0-9a-f]{8})u", body))

    assert table("K") == sha256_plain.K
    assert table("KPAD") == sha256_plain.KPAD
