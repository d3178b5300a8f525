"""Pluggable SHA-256 hashing backend for SSZ Merkleization.

The reference delegates hashing to pycryptodome via a 9-line shim
(eth2spec/utils/hash_function.py:8) and remerkleable's per-node
`merkle_root()`. Here the hasher is an explicit, swappable backend whose
unit of work is a *batch* of 64-byte blocks — the natural shape for a
device kernel (one Merkle level = one batched call), while the default host
backend just loops hashlib.

Backend contract: ``fn(data: bytes) -> bytes`` where ``len(data) % 64 == 0``
and the result is the concatenation of the 32-byte SHA-256 digests of each
64-byte block.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Optional

HashManyFn = Callable[[bytes], bytes]


def _hashlib_hash_many(data: bytes) -> bytes:
    n = len(data) // 64
    out = bytearray(32 * n)
    sha = hashlib.sha256
    for i in range(n):
        out[32 * i : 32 * i + 32] = sha(data[64 * i : 64 * i + 64]).digest()
    return bytes(out)


# Bytes hashed on the host since the last ``reset_host_bytes()``: the
# counterpart of the device hasher's kernel byte counts, so a run can show
# what share of its hashing went through the kernels.
host_bytes = 0


def reset_host_bytes() -> None:
    global host_bytes
    host_bytes = 0


def _host_hash_many(data: bytes) -> bytes:
    global host_bytes
    host_bytes += len(data)
    return _hashlib_hash_many(data)


_backend: HashManyFn = _host_hash_many
_backend_name: str = "hashlib"

_DEFAULT_DEVICE_MIN_BLOCKS = 64
_DEFAULT_FUSED_ROOT_MIN_CHUNKS = 128


def set_backend(fn: Optional[HashManyFn], name: str = "custom") -> None:
    """Install a batched hasher; ``None`` restores the hashlib host backend."""
    global _backend, _backend_name, DEVICE_MIN_BLOCKS, FUSED_ROOT_MIN_CHUNKS
    if fn is None:
        _backend, _backend_name = _host_hash_many, "hashlib"
        DEVICE_MIN_BLOCKS = _DEFAULT_DEVICE_MIN_BLOCKS
        FUSED_ROOT_MIN_CHUNKS = _DEFAULT_FUSED_ROOT_MIN_CHUNKS
    else:
        _backend, _backend_name = fn, name


def backend_name() -> str:
    return _backend_name


DEVICE_MIN_BLOCKS = 64  # below this, host hashlib beats the dispatch overhead


def hash_many(data: bytes) -> bytes:
    """SHA-256 of each consecutive 64-byte block of ``data``, concatenated.

    Small batches always run on host even when a device backend is
    installed: a device dispatch costs ~100µs while hashlib does a 64-byte
    block in ~1µs, so sub-``DEVICE_MIN_BLOCKS`` batches never win on device.
    Device backends are called directly: a kernel fault raises to the
    caller, and nothing falls back to the host.
    """
    if len(data) % 64:
        raise ValueError(f"hash_many input must be a multiple of 64 bytes, got {len(data)}")
    if not data:
        return b""
    if _backend is not _host_hash_many:
        if len(data) < 64 * DEVICE_MIN_BLOCKS:
            return _host_hash_many(data)
        return _backend(data)
    return _backend(data)


_fused_root_backend: Optional[Callable] = None
FUSED_ROOT_MIN_CHUNKS = 128  # below this, dispatch overhead beats the device


def set_fused_root_backend(fn: Optional[Callable]) -> None:
    """Install a whole-tree root backend: ``fn(chunks: bytes, limit: int)
    -> bytes`` computes the Merkle root of packed 32-byte chunks with
    zero-padding to ``limit`` leaves in ONE device dispatch (no per-level
    host round-trips — see ops.sha256.merkle_root_device)."""
    global _fused_root_backend
    _fused_root_backend = fn


def fused_root(chunks: bytes, limit: int) -> Optional[bytes]:
    """The fused whole-tree root, or None when no backend is installed or
    the tree is too small to be worth a device dispatch (callers then
    reduce level by level through ``hash_many``)."""
    if _fused_root_backend is None or len(chunks) < 32 * FUSED_ROOT_MIN_CHUNKS:
        return None
    return _fused_root_backend(chunks, limit)


_tree_backend: Optional[Callable] = None
TREE_DEVICE_MIN_CHUNKS = 1 << 15


def set_tree_backend(fn: Optional[Callable]) -> None:
    """Install a whole-tree interior-level builder: ``fn(leaves: bytes) ->
    [level_bytes]`` returns every interior Merkle level (height 1 upward,
    pow2-padded) in ONE device dispatch — used by ChunkTree when
    materializing levels for incremental updates."""
    global _tree_backend
    _tree_backend = fn


def tree_levels(leaves: bytes) -> Optional[list]:
    """Fused interior-level build, or None when no backend is installed or
    the tree is too small for a dispatch to win."""
    if _tree_backend is None or len(leaves) < 32 * TREE_DEVICE_MIN_CHUNKS:
        return None
    return _tree_backend(leaves)


_item_roots_backend: Optional[Callable] = None
ITEM_ROOTS_MIN_ITEMS = 1 << 14


def set_item_roots_backend(fn: Optional[Callable]) -> None:
    """Install a per-item subtree-root kernel: ``fn(packed: bytes,
    chunks_per_item: int) -> bytes`` reduces N independent pow2-chunk
    subtrees (item-major layout) to N 32-byte roots in one dispatch."""
    global _item_roots_backend
    _item_roots_backend = fn


def item_roots(packed: bytes, chunks_per_item: int) -> bytes:
    """Batched independent-subtree roots; host fallback reduces level by
    level through `hash_many` (item-major layout keeps items disjoint)."""
    n_items = len(packed) // (32 * chunks_per_item)
    if _item_roots_backend is not None and n_items >= ITEM_ROOTS_MIN_ITEMS:
        return _item_roots_backend(packed, chunks_per_item)
    nodes = packed
    while len(nodes) > 32 * n_items:
        nodes = hash_many(nodes)
    return nodes


_small_backend: Optional[Callable] = None


def set_small_backend(fn: Optional[Callable]) -> None:
    """Install a batched short-message hasher: ``fn(messages) -> [digest]``
    for messages of <=55 bytes (one compression block after padding)."""
    global _small_backend
    _small_backend = fn


def sha256_many_small(messages) -> list:
    """Batched SHA-256 of many short (<=55 byte) messages. Each fits a
    single compression block after standard padding, so a device backend
    (ops.sha256.hash_small_device) does the whole batch in one raw-block
    kernel launch. Used by the shuffle's per-round source hashes
    (beacon-chain.md:760-785) and proposer sampling; host default loops
    hashlib."""
    global host_bytes
    if _small_backend is not None:
        return _small_backend(messages)
    host_bytes += 64 * len(messages)  # one padded compression block each
    sha = hashlib.sha256
    return [sha(m).digest() for m in messages]


def sha256(data: bytes) -> bytes:
    """Plain one-shot SHA-256 (arbitrary length) — always on host.

    Spec-level `hash()` (eth2spec/utils/hash_function.py:8). Used for seeds,
    shuffling, randao mixes; the batched path is `hash_many`.
    """
    global host_bytes
    host_bytes += len(data)
    return hashlib.sha256(data).digest()


def hash_pair(a: bytes, b: bytes) -> bytes:
    """SHA-256(a || b) for two 32-byte nodes, through the batched backend."""
    return hash_many(a + b)
