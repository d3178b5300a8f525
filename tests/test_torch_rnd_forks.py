"""The R&D forks in the port (sharding, custody_game, das, eip4844: spec
sources copied from the JAX package, built by the port's ``specs.build``
on bellatrix) against the JAX package's builds at the minimal preset: the
same default roots, the same blob commitments and transaction checks, the
same data extension and recovery, the same custody helpers."""
import struct

import numpy as np
import pytest

from consensus_specs_tpu.specs import build as jbuild
from consensus_specs_tpu_torch.specs import build

RNG = np.random.default_rng(0x4D5)
RND = ["sharding", "custody_game", "das", "eip4844"]


@pytest.fixture(scope="module")
def specs():
    return {f: (build.build_spec(f, "minimal"), jbuild.build_spec(f, "minimal")) for f in RND}


def test_the_rnd_forks_build_in_the_port(specs):
    assert build.available_rnd_forks() == RND
    assert build.available_forks() == build.FORK_ORDER == ["phase0", "altair", "bellatrix", "capella"]
    assert {f: build.PREVIOUS_FORK[f] for f in RND} == {f: jbuild.PREVIOUS_FORK[f] for f in RND}
    assert build.RND_FORK_CHAINS == jbuild.RND_FORK_CHAINS
    for fork, (ours, _) in specs.items():
        assert ours.__name__ == f"consensus_specs_tpu_torch.specs.{fork}_minimal"
        assert ours.fork == fork
    with pytest.raises(ValueError, match="unknown fork"):
        build.build_spec("nosuchfork", "minimal")


@pytest.mark.parametrize("fork", RND)
@pytest.mark.parametrize("container", ["BeaconState", "BeaconBlockBody"])
def test_default_roots_equal_the_jax_packages(specs, fork, container):
    ours, theirs = specs[fork]
    assert ours.hash_tree_root(getattr(ours, container)()) == theirs.hash_tree_root(getattr(theirs, container)())


def _blob_tx(spec, versioned_hashes):
    """A minimal SignedBlobTransaction encoding for tx_peek_blob_versioned_hashes."""
    message = b"\x00" * 156 + struct.pack("<I", 160) + b"".join(bytes(h) for h in versioned_hashes)
    return bytes([spec.BLOB_TX_TYPE]) + struct.pack("<I", 4) + message


def test_eip4844_commitments_and_transaction_checks_equal_the_jax_packages(specs):
    ours, theirs = specs["eip4844"]
    values = [int.from_bytes(RNG.bytes(32), "big") % int(ours.BLS_MODULUS) for _ in range(4)]
    mine, other = ours.blob_to_kzg(ours.Blob(values)), theirs.blob_to_kzg(theirs.Blob(values))
    assert bytes(mine) == bytes(other)
    assert bytes(ours.kzg_to_versioned_hash(mine)) == bytes(theirs.kzg_to_versioned_hash(other))
    wrong = ours.blob_to_kzg(ours.Blob([1, 1, 1, 1]))
    for spec, c, w in ((ours, mine, wrong), (theirs, other, theirs.blob_to_kzg(theirs.Blob([1, 1, 1, 1])))):
        tx = _blob_tx(spec, [spec.kzg_to_versioned_hash(c)])
        assert [spec.verify_kzgs_against_transactions(*args) for args in
                (([tx], [c]), ([tx], [w]), ([tx], []), ([b"\x02abc"], []))] == [True, False, False, True]


def test_das_extension_and_recovery_equal_the_jax_packages(specs):
    ours, theirs = specs["das"]
    data = [int.from_bytes(RNG.bytes(32), "big") % int(ours.MODULUS) for _ in range(16)]
    extended = ours.extend_data(data)
    assert extended == theirs.extend_data(data) and extended[:16] == data
    pps = int(ours.POINTS_PER_SAMPLE)
    groups = [ours.reverse_bit_order_list(extended[i : i + pps]) for i in range(0, len(extended), pps)]
    damaged = [None, groups[1], None, groups[3]]
    assert ours.recover_data(damaged) == theirs.recover_data(damaged)
    assert [int(v) for v in ours.reconstruct_extended_data([None] + [
        ours.DASSample(index=i, data=extended[i * pps : (i + 1) * pps]) for i in range(1, 4)])] == extended


def test_custody_helpers_equal_the_jax_packages(specs):
    ours, theirs = specs["custody_game"]
    q = 2**255 - 19
    for a in [0, 1, 2, 3, q - 1, q + 5] + [int.from_bytes(RNG.bytes(32), "big") for _ in range(8)]:
        assert ours.legendre_bit(a, q) == theirs.legendre_bit(a, q), a
    for data in (b"", b"\x05" * 33, RNG.bytes(100)):
        assert [bytes(x) for x in ours.get_custody_atoms(data)] == [bytes(x) for x in theirs.get_custody_atoms(data)]
