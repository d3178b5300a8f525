"""SSZ: types, serialization, Merkleization (ref: ssz/simple-serialize.md,
eth2spec/utils/ssz/{ssz_impl,ssz_typing}.py)."""
from .types import (
    BYTES_PER_CHUNK,
    Bit,
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Bytes1,
    Bytes4,
    Bytes8,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    List,
    SSZType,
    Union,
    Vector,
    boolean,
    byte,
    get_generalized_index,
    get_generalized_index_length,
    uint,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)
from .merkle import (
    ZERO_HASHES,
    calc_merkle_tree_from_leaves,
    compute_merkle_proof_root,
    get_merkle_proof,
    get_merkle_root,
    merkleize_chunks,
    mix_in_length,
    mix_in_selector,
    next_pow2,
)
from . import hashing


def serialize(obj) -> bytes:
    """ssz_impl.serialize (eth2spec/utils/ssz/ssz_impl.py:8)."""
    return obj.encode_bytes()


def hash_tree_root(obj) -> Bytes32:
    """ssz_impl.hash_tree_root (eth2spec/utils/ssz/ssz_impl.py:11-13)."""
    return Bytes32(obj.hash_tree_root())


def uint_to_bytes(n: uint) -> bytes:
    """ssz_impl.uint_to_bytes (eth2spec/utils/ssz/ssz_impl.py:17-18)."""
    return n.encode_bytes()


def copy(obj):
    return obj.copy()
