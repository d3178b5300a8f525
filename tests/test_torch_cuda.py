"""The port's kernels on the card — SHA-256 (K1/K2), the base field
(K3 fq_mul, K4 fq_addsub) and the liveness probe — held against their
plain PyTorch versions, hashlib and Python integers, and the Verify
family on the card (scalar and batched) against the host oracle. These need
a CUDA card and skip without one; on the card run them with

    python3 -m pytest --noconftest -p no:randomly tests/test_torch_cuda.py
"""
import hashlib

import numpy as np
import pytest
import torch

from consensus_specs_tpu_torch import probe
from consensus_specs_tpu_torch.crypto.bls import ciphersuite as host
from consensus_specs_tpu_torch.ops import bls_torch, fq, fq_cuda, fq_plain
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


def _field(n, seed):
    rng = np.random.default_rng(seed)
    p = fq.P_INT
    vals = [int.from_bytes(rng.bytes(48), "big") % p for _ in range(n)] + [0, 1, p - 1, p - 2]
    return torch.from_numpy(fq.to_limbs(vals)), vals


@pytest.mark.parametrize("n", [1, 255, 4609])
@pytest.mark.parametrize("op", ["mul", "add", "sub", "neg"])
def test_field_kernels_match_plain_versions(card, n, op):
    a, av = _field(n, n)
    b, bv = _field(n, n + 1)
    b = b.flip(0).contiguous()
    bv = bv[::-1]
    name = "fq_mul" if op == "mul" else "fq_addsub"
    code = {"add": 0, "sub": 1, "neg": 2}.get(op)
    before = fq_cuda.launches[name]
    if op == "mul":
        got, want = fq_cuda.fq_mul(a.to(card), b.to(card)), fq_plain.mul(a, b)
    else:
        got, want = fq_cuda.fq_addsub(a.to(card), b.to(card), code), fq_plain.addsub(a, b, code)
    torch.cuda.synchronize()
    assert fq_cuda.launches[name] == before + 1
    assert torch.equal(got.cpu(), want)
    p, rinv = fq.P_INT, pow(1 << 384, -1, fq.P_INT)
    ref = {"mul": lambda x, y: x * y * rinv % p, "add": lambda x, y: (x + y) % p,
           "sub": lambda x, y: (x - y) % p, "neg": lambda x, y: (-y) % p}[op]
    assert list(fq.from_limbs(got.cpu())) == [ref(x, y) for x, y in zip(av, bv)]


def test_field_kernels_broadcast_a_single_operand(card):
    a, _ = _field(60, 7)
    c = a[:1]
    got = fq_cuda.fq_mul(a.view(8, 8, 32).to(card), c.to(card))
    assert torch.equal(got.cpu(), fq_plain.mul(a.view(8, 8, 32), c))


def test_probe_kernel(card):
    before = probe.launches["add_one"]
    assert probe.probe()["ok"]
    assert probe.launches["add_one"] == before + 1


def test_cold_fast_aggregate_verify_on_the_card(card):
    sks = list(range(1, 9))
    pks = [host.SkToPk(k) for k in sks]
    msgs = [bytes([9, i]) * 16 for i in range(4)]
    sigs = [host.Aggregate([host.Sign(k, m) for k in sks[i : i + 4]]) for i, m in enumerate(msgs)]
    pklists = [pks[i : i + 4] for i in range(4)]
    msgs[1] = b"\x99" * 32  # wrong message
    sigs[2] = b"\x00" * 96  # malformed signature
    bls_torch.use_device(card)
    before = dict(fq_cuda.launches)
    got = bls_torch.fast_aggregate_verify_batch_cold(pklists, msgs, sigs)
    want = [host.FastAggregateVerify(pk, m, s) for pk, m, s in zip(pklists, msgs, sigs)]
    assert got.tolist() == want == [True, False, False, True]
    assert all(fq_cuda.launches[k] > before[k] for k in fq_cuda.KERNELS)


def test_scalar_and_batched_verify_family_on_the_card(card):
    sks = list(range(1, 7))
    pks = [host.SkToPk(k) for k in sks]
    msgs = [bytes([5, i]) * 16 for i in range(3)]
    sig = host.Sign(sks[0], msgs[0])
    fav = host.Aggregate([host.Sign(k, msgs[1]) for k in sks[:3]])
    av = host.Aggregate([host.Sign(k, m) for k, m in zip(sks[3:], msgs)])
    bls_torch.use_device(card)
    for name, args in (
        ("Verify", (pks[0], msgs[0], sig)),
        ("Verify", (pks[1], msgs[0], sig)),
        ("FastAggregateVerify", (pks[:3], msgs[1], fav)),
        ("FastAggregateVerify", (pks[:3], msgs[0], fav)),
        ("AggregateVerify", (pks[3:], msgs, av)),
        ("AggregateVerify", (pks[3:], msgs[::-1], av)),
        ("AggregateVerify", (pks[3:], msgs[:2], av)),
    ):
        assert getattr(bls_torch, name)(*args) == getattr(host, name)(*args), (name, args)
    rows = [(pks[0], msgs[0], sig), (pks[2], msgs[0], sig), (pks[0], msgs[0], b"\x00" * 96)]
    assert bls_torch.verify_batch(*zip(*rows)).tolist() == [host.Verify(*r) for r in rows] == [True, False, False]
    rows = [(pks[3:], msgs, av), (pks[3:], msgs[::-1], av), ([], [], av)]
    assert bls_torch.aggregate_verify_batch(*zip(*rows)).tolist() == [host.AggregateVerify(*r) for r in rows]
