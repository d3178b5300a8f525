"""Merkleization primitives (ref: ssz/simple-serialize.md:210-249,
eth2spec/utils/merkle_minimal.py:7-89).

All level reductions go through `hashing.hash_many`, so one call hashes an
entire Merkle level — the batching boundary the device backend exploits.
Virtual zero-padding via the precomputed zero-hash table means a
`List[..., 2**40]` limit costs 40 extra hashes, not 2**40 chunks.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .hashing import fused_root, hash_many

ZERO_CHUNK = b"\x00" * 32

# zerohashes[i] = root of a depth-i tree of zero chunks (merkle_minimal.py:7-9)
ZERO_HASHES: List[bytes] = [ZERO_CHUNK]
for _ in range(64):
    ZERO_HASHES.append(hash_many(ZERO_HASHES[-1] + ZERO_HASHES[-1]))


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def ceil_log2(x: int) -> int:
    return 0 if x <= 1 else (x - 1).bit_length()


def _reduce_level(nodes: List[bytes], zero: bytes) -> List[bytes]:
    if len(nodes) % 2:
        nodes = nodes + [zero]
    digests = hash_many(b"".join(nodes))
    return [digests[32 * i : 32 * i + 32] for i in range(len(nodes) // 2)]


def merkleize_chunks(chunks, limit: Optional[int] = None) -> bytes:
    """Root of the Merkle tree over `chunks`, zero-padded to `limit` leaves.

    `chunks` is either packed bytes (length a multiple of 32 — the fast,
    contiguous path) or a sequence of 32-byte chunk objects. `limit=None`
    pads to next_pow2(count) (simple-serialize.md merkleize with no limit).
    Matches merkle_minimal.merkleize_chunks:47-89 semantics.
    """
    if isinstance(chunks, (bytes, bytearray, memoryview)):
        data = bytes(chunks)
    else:
        data = b"".join(chunks)
    count = len(data) // 32
    if limit is None:
        limit = max(count, 1)
    if count > limit:
        raise ValueError(f"merkleize: {count} chunks exceeds limit {limit}")
    depth = ceil_log2(limit)
    if count == 0:
        return ZERO_HASHES[depth]
    if count >= 2:
        # large trees: whole-tree device reduce in one dispatch (chunk
        # data crosses to HBM once; only the 32-byte root returns)
        root = fused_root(data, limit)
        if root is not None:
            return root
    nodes = data
    level = 0
    while len(nodes) > 32:
        if (len(nodes) // 32) % 2:
            nodes = nodes + ZERO_HASHES[level]
        nodes = hash_many(nodes)
        level += 1
    root = nodes
    while level < depth:
        root = hash_many(root + ZERO_HASHES[level])
        level += 1
    return root


def mix_in_length(root: bytes, length: int) -> bytes:
    return hash_many(root + length.to_bytes(32, "little"))


def mix_in_selector(root: bytes, selector: int) -> bytes:
    return hash_many(root + selector.to_bytes(32, "little"))


# -- Full-tree helpers for proofs (merkle_minimal.py:12-45) ------------------


def calc_merkle_tree_from_leaves(values: Sequence[bytes], layer_count: int = 32) -> List[List[bytes]]:
    """All layers bottom-up; layer i has the nodes at depth (layer_count - i)."""
    values = list(values)
    tree: List[List[bytes]] = [values[:]]
    for h in range(layer_count):
        if len(values) % 2:
            values.append(ZERO_HASHES[h])
        values = _reduce_level(values, ZERO_HASHES[h])
        tree.append(values[:])
    return tree


def get_merkle_root(values: Sequence[bytes], pad_to: int = 1) -> bytes:
    return merkleize_chunks(values, limit=max(pad_to, 1))


def get_merkle_proof(tree: List[List[bytes]], item_index: int, tree_len: Optional[int] = None) -> List[bytes]:
    proof = []
    for i in range(tree_len if tree_len is not None else len(tree) - 1):
        subindex = (item_index // (1 << i)) ^ 1
        layer = tree[i]
        proof.append(layer[subindex] if subindex < len(layer) else ZERO_HASHES[i])
    return proof


def compute_merkle_proof_root(leaf: bytes, proof: Sequence[bytes], index: int) -> bytes:
    """Fold a branch upward; `index` is the generalized index of the leaf."""
    node = leaf
    for i, sibling in enumerate(proof):
        if (index >> i) & 1:
            node = hash_many(sibling + node)
        else:
            node = hash_many(node + sibling)
    return node
