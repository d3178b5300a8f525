"""Contiguous, dirty-tracked Merkle backing for SSZ sequences.

The reference gets incremental `hash_tree_root` from remerkleable's
persistent binary trees with per-node root caching
(eth2spec/utils/ssz/ssz_impl.py:11-13 — `get_backing().merkle_root()`).
That design is pointer-chasing-heavy and hostile to batched hashing.

This is the batched-hashing equivalent: a sequence's chunk leaves live in ONE
contiguous bytearray; mutations mark dirty leaf indices; a root request
re-hashes only the dirty paths, with every Merkle level's dirty nodes
hashed in a single batched `hash_many` call. The first root of a large
un-mutated tree takes the fused whole-tree device path (one dispatch,
only 32 bytes return); interior levels are materialized lazily on the
first mutated root, after which updates cost O(dirty · log n) hashes.

Virtual zero-padding to the type's limit (e.g. `List[..., 2**40]`) is a
fold through the precomputed zero-hash table — never allocated.
"""
from __future__ import annotations

from typing import Optional

from . import hashing
from .merkle import ZERO_HASHES, ceil_log2, merkleize_chunks


class ChunkTree:
    """Merkle tree over 32-byte leaf chunks with dirty-index tracking.

    Leaves are stored packed in ``self.leaves`` (``count * 32`` bytes).
    ``set_leaf``/``truncate`` are the only mutators; ``root()`` folds the
    tree up to ``depth = ceil_log2(limit)`` with zero-subtree padding.
    """

    __slots__ = ("leaves", "limit", "_levels", "_dirty", "_root")

    def __init__(self, leaves: bytearray, limit: int):
        self.leaves = leaves
        self.limit = max(int(limit), 1)
        self._levels: Optional[list] = None  # _levels[k-1] = packed nodes at height k
        self._dirty: set = set()
        self._root: Optional[bytes] = None

    @property
    def count(self) -> int:
        return len(self.leaves) // 32

    def copy(self) -> "ChunkTree":
        t = ChunkTree(bytearray(self.leaves), self.limit)
        if self._levels is not None:
            t._levels = [bytearray(level) for level in self._levels]
        t._dirty = set(self._dirty)
        t._root = self._root
        return t

    def get_leaf(self, i: int) -> bytes:
        return bytes(self.leaves[32 * i : 32 * i + 32])

    def set_leaf(self, i: int, chunk: bytes) -> None:
        """Write leaf ``i``; ``i == count`` appends a new leaf."""
        n = self.count
        if i == n:
            if n + 1 > self.limit:
                raise ValueError(f"ChunkTree: leaf {i} exceeds limit {self.limit}")
            self.leaves += chunk
        elif i < n:
            self.leaves[32 * i : 32 * i + 32] = chunk
        else:
            raise IndexError(f"ChunkTree: leaf {i} out of range (count {n})")
        self._dirty.add(i)
        self._root = None

    def truncate(self, n: int) -> None:
        """Drop leaves past ``n``. Ancestors of the new last leaf are the
        only surviving nodes whose children change (the last surviving node
        at height k is (n-1)>>k — exactly the last leaf's ancestor), so
        marking leaf n-1 dirty plus truncating each level is sufficient."""
        old = self.count
        if n >= old:
            return
        del self.leaves[32 * n :]
        if self._levels is not None:
            size = n
            for k, level in enumerate(self._levels, start=1):
                size = (size + 1) // 2
                del level[32 * size :]
        self._dirty = {i for i in self._dirty if i < n}
        if n > 0:
            self._dirty.add(n - 1)
        self._root = None

    # -- root computation ---------------------------------------------------

    def _full_build(self) -> None:
        """Materialize all interior levels. Large trees: ONE fused device
        dispatch returning every level (hashing.tree_levels); otherwise
        level-by-level, each level one batched hash_many call."""
        fused = hashing.tree_levels(bytes(self.leaves))
        if fused is not None:
            # fused levels are pow2-padded; trim each to the real node count
            size = self.count
            levels = []
            for lv in fused:
                size = (size + 1) // 2
                levels.append(bytearray(lv[: 32 * size]))
                if size == 1:
                    break
            self._levels = levels
            self._dirty.clear()
            return
        levels = []
        nodes = bytes(self.leaves)
        k = 0
        while len(nodes) > 32:
            if (len(nodes) // 32) % 2:
                nodes += ZERO_HASHES[k]
            nodes = hashing.hash_many(nodes)
            levels.append(bytearray(nodes))
            k += 1
        self._levels = levels
        self._dirty.clear()

    def _incremental_update(self) -> None:
        levels = self._levels
        size = self.count
        idxs = self._dirty
        nodes = self.leaves
        k = 0
        while size > 1:
            parent_size = (size + 1) // 2
            parents = sorted({i >> 1 for i in idxs if i < size})
            level = levels[k] if k < len(levels) else None
            if level is None:
                level = bytearray()
                levels.append(level)
            if len(level) < 32 * parent_size:
                level += b"\x00" * (32 * parent_size - len(level))
            if parents:
                buf = bytearray()
                for p in parents:
                    li, ri = 2 * p, 2 * p + 1
                    buf += nodes[32 * li : 32 * li + 32]
                    if ri < size:
                        buf += nodes[32 * ri : 32 * ri + 32]
                    else:
                        buf += ZERO_HASHES[k]
                digests = hashing.hash_many(bytes(buf))
                for j, p in enumerate(parents):
                    level[32 * p : 32 * p + 32] = digests[32 * j : 32 * j + 32]
            idxs = set(parents)
            nodes = level
            size = parent_size
            k += 1
        del levels[k:]
        self._dirty.clear()

    def root(self) -> bytes:
        if self._root is not None:
            return self._root
        count = self.count
        depth = ceil_log2(self.limit)
        if count == 0:
            self._root = ZERO_HASHES[depth]
            return self._root
        if self._levels is None:
            if not self._dirty and count >= 2:
                # first root of a clean tree: fused one-dispatch device path
                # (or host merkleize); interior levels stay unmaterialized
                self._root = merkleize_chunks(bytes(self.leaves), limit=self.limit)
                return self._root
            self._full_build()
        elif self._dirty:
            self._incremental_update()
        top = self._levels[-1] if self._levels else self.leaves
        node = bytes(top[:32]) if len(top) >= 32 else ZERO_HASHES[0]
        level = len(self._levels) if self._levels else 0
        while level < depth:
            node = hashing.hash_many(node + ZERO_HASHES[level])
            level += 1
        self._root = node
        return node
