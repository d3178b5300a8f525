"""The port's SHA-256 kernels on the card, held against their plain
PyTorch versions and hashlib. These need a CUDA card and skip without one;
on the card run them with

    python3 -m pytest --noconftest -p no:randomly tests/test_torch_cuda.py
"""
import hashlib

import pytest
import torch

from consensus_specs_tpu_torch.ops import sha256 as tdev
from consensus_specs_tpu_torch.ops import sha256_cuda, sha256_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["sha256_blocks", "sha256_raw_blocks"])
@pytest.mark.parametrize("n", [1, 255, 257, 4099])
def test_kernel_matches_plain_version(card, name, n):
    g = torch.Generator().manual_seed(n)
    blocks = torch.randint(-(2**31), 2**31, (n, 16), dtype=torch.int32, generator=g)
    before = sha256_cuda.launches[name]
    got = getattr(sha256_cuda, name)(blocks.to(card))
    torch.cuda.synchronize()
    assert sha256_cuda.launches[name] == before + 1
    assert torch.equal(got.cpu(), getattr(sha256_plain, name)(blocks))


def test_seams_on_the_card_match_hashlib(card):
    data = bytes(range(256)) * 64
    want = b"".join(hashlib.sha256(data[64 * i : 64 * i + 64]).digest() for i in range(len(data) // 64))
    assert tdev.hash_many_device(data) == want
    msgs = [data[:k] for k in range(56)]
    assert tdev.hash_small_device(msgs) == [hashlib.sha256(m).digest() for m in msgs]
    chunks = data[: 32 * 100]
    assert tdev.merkle_root_device(chunks, 128) == tdev.merkle_root_device(chunks, 128, device="cpu")
    assert tdev.tree_levels_device(chunks) == tdev.tree_levels_device(chunks, device="cpu")
    assert tdev.item_roots_device(data[: 32 * 64], 8) == tdev.item_roots_device(data[: 32 * 64], 8, device="cpu")
