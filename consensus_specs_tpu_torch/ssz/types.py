"""SSZ type system: value-backed, mutable views with on-demand Merkleization.

Feature parity with the reference's remerkleable-based typing surface
(eth2spec/utils/ssz/ssz_typing.py:4-12; normative rules ssz/simple-serialize.md):
uintN, boolean, Container, Vector, List, ByteVector, ByteList, Bitvector,
Bitlist, Union, plus generalized indices (ssz/merkle-proofs.md:58-189).

Design differences from remerkleable: objects are plain Python values (ints,
bytes, lists) rather than persistent binary trees. Roots are computed on
demand by flattening to chunk lists and reducing level-by-level through the
batched hasher (`hashing.hash_many`) — the shape a device kernel wants.

Assignment semantics: mutable composites (Containers, sequences, bit
types, Unions) pass through an ownership barrier on their way into any
parent slot (`_adopt`): a fresh value is adopted in place, while a value
already owned by some parent is snapshotted first. Two parents therefore
never share one mutable child — remerkleable's assignment-captures-the-
current-backing semantics, enforced structurally (regression:
tests/test_ssz_basic.py::test_no_aliasing_between_parents).
"""
from __future__ import annotations

import sys
import weakref
from array import array
from typing import Any, Dict, Optional, Sequence, Tuple

from . import hashing
from .backing import ChunkTree
from .merkle import (
    merkleize_chunks,
    mix_in_length,
    mix_in_selector,
    next_pow2,
)

BYTES_PER_CHUNK = 32
OFFSET_BYTE_LENGTH = 4


def _pad_to_chunks(data: bytes) -> bytes:
    if len(data) % BYTES_PER_CHUNK:
        return data + b"\x00" * (BYTES_PER_CHUNK - len(data) % BYTES_PER_CHUNK)
    return data


class _Cached:
    """Incremental-root machinery shared by all mutable composites.

    The remerkleable capability (ssz_impl.py:11-13 — per-node root caching
    with structural sharing) rebuilt for a value-backed object model:

    - every composite caches its `hash_tree_root` (`_ht_cache`);
    - children keep weakrefs to their parents + the slot they occupy, so an
      in-place mutation anywhere invalidates exactly the ancestor chain
      (O(depth), not O(state));
    - sequences additionally record WHICH slots went dirty, so a root
      recompute re-hashes only dirty subtrees (see `ChunkTree`).

    Invariant: whenever a composite's `_ht_cache` is None, every parent has
    already been notified (its cache is cleared and, for sequences, the
    child's slot is in its dirty set). Established at mutation time by
    `_mark_self_dirty`/`_receive_dirty` and at link time because linking
    happens during root computation (which fills the cache).
    """

    _ht_cache: Optional[bytes] = None
    _parents: Optional[list] = None
    _owned: bool = False

    def _set_cache(self, v: Optional[bytes]) -> None:
        object.__setattr__(self, "_ht_cache", v)

    def _link_child(self, child, slot) -> None:
        """Record that `child` occupies `slot` of self (idempotent)."""
        if not isinstance(child, _Cached):
            return
        ps = child._parents
        if ps is None:
            ps = []
            object.__setattr__(child, "_parents", ps)
        for r, s in ps:
            if s == slot and r() is self:
                return
        ps.append((weakref.ref(self), slot))

    def _receive_dirty(self, slot) -> bool:
        """A child at `slot` changed. Returns True if this node was clean
        (so its own parents need notifying in turn)."""
        if self._ht_cache is None:
            return False
        self._set_cache(None)
        return True

    def _bubble(self) -> None:
        """Propagate invalidation to all (live) ancestors."""
        stack: list = [self]
        while stack:
            obj = stack.pop()
            ps = obj._parents
            if not ps:
                continue
            dead = False
            for ref, slot in ps:
                p = ref()
                if p is None:
                    dead = True
                    continue
                if p._receive_dirty(slot):
                    stack.append(p)
            if dead:
                object.__setattr__(obj, "_parents", [(r, s) for r, s in ps if r() is not None])

    def _mark_self_dirty(self) -> None:
        """Call after any in-place mutation of this value."""
        if self._ht_cache is not None:
            self._set_cache(None)
            self._bubble()
        # cache already None ⇒ ancestors were notified when it was cleared


def _adopt(value):
    """Ownership barrier for mutable composites entering a parent slot.

    A freshly-built value is adopted in place (no copy); adopting a value
    that some parent already owns snapshots it first, so two parents can
    never share one mutable child. This is remerkleable's assignment
    semantics (a view assignment captures the value's current backing,
    ssz_impl.py:11-13) enforced on the value-backed model — the
    one-forgotten-`.copy()` root-corruption footgun cannot occur.
    Immutable leaves (uints, ByteVector/ByteList bytes) are shared freely.
    """
    if isinstance(value, _Cached):
        if value._owned:
            value = value.copy()
        object.__setattr__(value, "_owned", True)
    return value


class SSZType:
    """Shared classmethod protocol; every SSZ class also implements
    encode_bytes()/hash_tree_root() on instances."""

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        raise NotImplementedError

    @classmethod
    def type_byte_length(cls) -> int:
        raise NotImplementedError  # fixed-size types only

    @classmethod
    def decode_bytes(cls, data: bytes):
        raise NotImplementedError

    @classmethod
    def default(cls):
        raise NotImplementedError

    @classmethod
    def coerce(cls, value):
        if isinstance(value, cls):
            return value
        return cls(value)

    def encode_bytes(self) -> bytes:
        raise NotImplementedError

    def hash_tree_root(self) -> bytes:
        raise NotImplementedError

    def copy(self):
        return type(self).decode_bytes(self.encode_bytes())


# ---------------------------------------------------------------------------
# Basic types
# ---------------------------------------------------------------------------


class uint(int, SSZType):
    byte_len: int = 0

    def __new__(cls, value: Any = 0):
        if isinstance(value, (float,)) or (isinstance(value, bool) and cls.byte_len != 1):
            value = int(value)
        v = int(value)
        if v < 0 or v >> (cls.byte_len * 8):
            raise ValueError(f"{cls.__name__} out of range: {v}")
        return super().__new__(cls, v)

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return cls.byte_len

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) != cls.byte_len:
            raise ValueError(f"{cls.__name__}: expected {cls.byte_len} bytes, got {len(data)}")
        return cls(int.from_bytes(data, "little"))

    @classmethod
    def default(cls):
        return cls(0)

    def encode_bytes(self) -> bytes:
        return int(self).to_bytes(self.byte_len, "little")

    def hash_tree_root(self) -> bytes:
        return self.encode_bytes() + b"\x00" * (32 - self.byte_len)

    def copy(self):
        return self


class uint8(uint):
    byte_len = 1


class uint16(uint):
    byte_len = 2


class uint32(uint):
    byte_len = 4


class uint64(uint):
    byte_len = 8


class uint128(uint):
    byte_len = 16


class uint256(uint):
    byte_len = 32


byte = uint8


class boolean(uint):
    byte_len = 1

    def __new__(cls, value: Any = 0):
        v = int(value)
        if v not in (0, 1):
            raise ValueError(f"boolean out of range: {v}")
        return super().__new__(cls, v)

    def __bool__(self):
        return int(self) == 1

    def __repr__(self):
        return f"boolean({int(self)})"


class Bit(boolean):
    pass


# ---------------------------------------------------------------------------
# Parameterized-type machinery
# ---------------------------------------------------------------------------

_param_cache: Dict[Tuple, type] = {}


def _parameterize(base: type, key: Tuple, name: str, ns: Dict[str, Any]) -> type:
    cache_key = (base, key)
    if cache_key not in _param_cache:
        _param_cache[cache_key] = type(name, (base,), ns)
    return _param_cache[cache_key]


# ---------------------------------------------------------------------------
# ByteVector / ByteList
# ---------------------------------------------------------------------------


class ByteVector(bytes, SSZType):
    length: int = 0

    def __class_getitem__(cls, length: int) -> type:
        return _parameterize(ByteVector, (length,), f"ByteVector[{length}]", {"length": length})

    def __new__(cls, *args):
        if cls.length == 0 and cls is ByteVector:
            raise TypeError("ByteVector must be parameterized: ByteVector[N]")
        if len(args) == 0:
            data = b"\x00" * cls.length
        elif len(args) == 1:
            v = args[0]
            if isinstance(v, str):
                data = bytes.fromhex(v[2:] if v.startswith("0x") else v)
            elif isinstance(v, (bytes, bytearray, memoryview)):
                data = bytes(v)
            else:
                data = bytes(v)
        else:
            data = bytes(args)
        if len(data) != cls.length:
            raise ValueError(f"{cls.__name__}: expected {cls.length} bytes, got {len(data)}")
        return super().__new__(cls, data)

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return cls.length

    @classmethod
    def decode_bytes(cls, data: bytes):
        return cls(data)

    @classmethod
    def default(cls):
        return cls()

    def encode_bytes(self) -> bytes:
        return bytes(self)

    def hash_tree_root(self) -> bytes:
        # immutable: root cached per instance, computed lazily
        try:
            return self._htr
        except AttributeError:
            root = merkleize_chunks(_pad_to_chunks(bytes(self)), limit=(self.length + 31) // 32)
            self._htr = root
            return root

    def copy(self):
        return self

    def __repr__(self):
        return f"{type(self).__name__}(0x{bytes(self).hex()})"


Bytes1 = ByteVector[1]
Bytes4 = ByteVector[4]
Bytes8 = ByteVector[8]
Bytes20 = ByteVector[20]
Bytes32 = ByteVector[32]
Bytes48 = ByteVector[48]
Bytes96 = ByteVector[96]


class ByteList(bytes, SSZType):
    limit: int = 0

    def __class_getitem__(cls, limit: int) -> type:
        return _parameterize(ByteList, (limit,), f"ByteList[{limit}]", {"limit": limit})

    def __new__(cls, *args):
        if len(args) == 0:
            data = b""
        elif len(args) == 1:
            v = args[0]
            if isinstance(v, str):
                data = bytes.fromhex(v[2:] if v.startswith("0x") else v)
            else:
                data = bytes(v)
        else:
            data = bytes(args)
        if len(data) > cls.limit:
            raise ValueError(f"{cls.__name__}: {len(data)} bytes exceeds limit {cls.limit}")
        return super().__new__(cls, data)

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return False

    @classmethod
    def decode_bytes(cls, data: bytes):
        return cls(data)

    @classmethod
    def default(cls):
        return cls()

    def encode_bytes(self) -> bytes:
        return bytes(self)

    def hash_tree_root(self) -> bytes:
        try:
            return self._htr
        except AttributeError:
            root = mix_in_length(
                merkleize_chunks(_pad_to_chunks(bytes(self)), limit=(self.limit + 31) // 32),
                len(self),
            )
            self._htr = root
            return root

    def copy(self):
        return self

    def __repr__(self):
        return f"{type(self).__name__}(0x{bytes(self).hex()})"


# ---------------------------------------------------------------------------
# Bitvector / Bitlist
# ---------------------------------------------------------------------------


def _bits_to_bytes(bits: Sequence[bool]) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


class _BitsBase(_Cached, SSZType):
    def __init__(self, *args):
        if len(args) == 1 and isinstance(args[0], (list, tuple, _BitsBase)):
            bits = [bool(b) for b in args[0]]
        elif len(args) == 1 and isinstance(args[0], (bytes, bytearray)):
            raise TypeError("use decode_bytes for serialized bit data")
        else:
            bits = [bool(b) for b in args]
        self._check_len(len(bits))
        self._bits = bits

    def _check_len(self, n: int) -> None:
        raise NotImplementedError

    def __len__(self):
        return len(self._bits)

    def __iter__(self):
        return iter(self._bits)

    def __getitem__(self, i):
        return self._bits[i]

    def __setitem__(self, i, v):
        if isinstance(i, slice):
            # Validate the post-assignment length BEFORE committing so a
            # failed check can't leave the value corrupted.
            new_bits = list(self._bits)
            new_bits[i] = [bool(x) for x in v]
            self._check_len(len(new_bits))
            self._bits = new_bits
        else:
            self._bits[i] = bool(v)
        self._mark_self_dirty()

    def _type_key(self):
        bound = self.length if isinstance(self, Bitvector) else self.limit
        return (isinstance(self, Bitvector), int(bound))

    def __eq__(self, other):
        if isinstance(other, _BitsBase):
            # Same kind + same bound + equal bits; cross-module parameterized
            # classes compare by value (see _SequenceBase), and __hash__ uses
            # the same key so the eq/hash contract holds.
            if self._type_key() != other._type_key():
                return NotImplemented
            return self._bits == other._bits
        if isinstance(other, (list, tuple)):
            return self._bits == [bool(b) for b in other]
        return NotImplemented

    def __hash__(self):
        return hash((self._type_key(), tuple(self._bits)))

    def __repr__(self):
        return f"{type(self).__name__}({''.join('1' if b else '0' for b in self._bits)})"

    def copy(self):
        new = type(self)(self._bits)
        new._set_cache(self._ht_cache)
        return new


class Bitvector(_BitsBase):
    length: int = 0

    def __class_getitem__(cls, length: int) -> type:
        return _parameterize(Bitvector, (length,), f"Bitvector[{length}]", {"length": length})

    def __init__(self, *args):
        if len(args) == 0:
            args = ([False] * self.length,)
        super().__init__(*args)

    def _check_len(self, n: int) -> None:
        if n != self.length:
            raise ValueError(f"{type(self).__name__}: expected {self.length} bits, got {n}")

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return True

    @classmethod
    def type_byte_length(cls) -> int:
        return (cls.length + 7) // 8

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) != (cls.length + 7) // 8:
            raise ValueError(f"{cls.__name__}: bad byte length {len(data)}")
        bits = [bool((data[i // 8] >> (i % 8)) & 1) for i in range(cls.length)]
        # Padding bits past `length` must be zero.
        for i in range(cls.length, len(data) * 8):
            if (data[i // 8] >> (i % 8)) & 1:
                raise ValueError(f"{cls.__name__}: nonzero padding bit")
        return cls(bits)

    @classmethod
    def default(cls):
        return cls()

    def encode_bytes(self) -> bytes:
        return _bits_to_bytes(self._bits)

    def hash_tree_root(self) -> bytes:
        c = self._ht_cache
        if c is None:
            c = merkleize_chunks(
                _pad_to_chunks(self.encode_bytes()), limit=(self.length + 255) // 256
            )
            self._set_cache(c)
        return c


class Bitlist(_BitsBase):
    limit: int = 0

    def __class_getitem__(cls, limit: int) -> type:
        return _parameterize(Bitlist, (limit,), f"Bitlist[{limit}]", {"limit": limit})

    def _check_len(self, n: int) -> None:
        if n > self.limit:
            raise ValueError(f"{type(self).__name__}: {n} bits exceeds limit {self.limit}")

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return False

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) == 0:
            raise ValueError(f"{cls.__name__}: empty serialization (missing delimiter)")
        if data[-1] == 0:
            raise ValueError(f"{cls.__name__}: last byte must contain delimiter bit")
        total_bits = (len(data) - 1) * 8 + data[-1].bit_length() - 1
        if total_bits > cls.limit:
            raise ValueError(f"{cls.__name__}: {total_bits} bits exceeds limit {cls.limit}")
        bits = [bool((data[i // 8] >> (i % 8)) & 1) for i in range(total_bits)]
        return cls(bits)

    @classmethod
    def default(cls):
        return cls([])

    def encode_bytes(self) -> bytes:
        n = len(self._bits)
        out = bytearray((n // 8) + 1)
        for i, b in enumerate(self._bits):
            if b:
                out[i // 8] |= 1 << (i % 8)
        out[n // 8] |= 1 << (n % 8)  # delimiter bit
        return bytes(out)

    def hash_tree_root(self) -> bytes:
        c = self._ht_cache
        if c is None:
            root = merkleize_chunks(
                _pad_to_chunks(_bits_to_bytes(self._bits)), limit=(self.limit + 255) // 256
            )
            c = mix_in_length(root, len(self._bits))
            self._set_cache(c)
        return c


# ---------------------------------------------------------------------------
# Composite serialization helpers (simple-serialize.md:105-187)
# ---------------------------------------------------------------------------


def _serialize_parts(values: Sequence[Any]) -> bytes:
    fixed_parts = []
    variable_parts = []
    for v in values:
        if type(v).is_fixed_byte_length():
            fixed_parts.append(v.encode_bytes())
            variable_parts.append(b"")
        else:
            fixed_parts.append(None)
            variable_parts.append(v.encode_bytes())
    fixed_len = sum(OFFSET_BYTE_LENGTH if p is None else len(p) for p in fixed_parts)
    out = []
    offset = fixed_len
    for p, v in zip(fixed_parts, variable_parts):
        if p is None:
            out.append(offset.to_bytes(OFFSET_BYTE_LENGTH, "little"))
            offset += len(v)
        else:
            out.append(p)
    out.extend(v for v in variable_parts if v)
    return b"".join(out)


def _decode_parts(data: bytes, types: Sequence[type]) -> list:
    """Split a composite serialization into per-element byte ranges and decode."""
    n = len(types)
    fixed_lens = [t.type_byte_length() if t.is_fixed_byte_length() else None for t in types]
    fixed_total = sum(OFFSET_BYTE_LENGTH if fl is None else fl for fl in fixed_lens)
    if len(data) < fixed_total:
        raise ValueError(f"composite: {len(data)} bytes < fixed size {fixed_total}")
    offsets = []
    pos = 0
    for fl in fixed_lens:
        if fl is None:
            offsets.append(int.from_bytes(data[pos : pos + OFFSET_BYTE_LENGTH], "little"))
            pos += OFFSET_BYTE_LENGTH
        else:
            pos += fl
    if offsets:
        if offsets[0] != fixed_total:
            raise ValueError(f"composite: first offset {offsets[0]} != fixed size {fixed_total}")
        for a, b in zip(offsets, offsets[1:]):
            if b < a:
                raise ValueError("composite: offsets not monotonic")
        if offsets[-1] > len(data):
            raise ValueError("composite: offset past end")
    elif len(data) != fixed_total:
        raise ValueError(f"composite: trailing bytes ({len(data)} != {fixed_total})")
    values = []
    pos = 0
    oi = 0
    for t, fl in zip(types, fixed_lens):
        if fl is None:
            start = offsets[oi]
            end = offsets[oi + 1] if oi + 1 < len(offsets) else len(data)
            oi += 1
            values.append(t.decode_bytes(data[start:end]))
            pos += OFFSET_BYTE_LENGTH
        else:
            values.append(t.decode_bytes(data[pos : pos + fl]))
            pos += fl
    return values


# ---------------------------------------------------------------------------
# Vector / List
# ---------------------------------------------------------------------------


def _is_basic(t: type) -> bool:
    return issubclass(t, uint)


_ARRAY_CODES = {1: "B", 2: "H", 4: "I", 8: "Q"}


def _pack_basic_items(items, elem_type) -> bytearray:
    """Pack basic elements into chunk-padded contiguous bytes. uintN with a
    native array code takes the C fast path (little-endian platforms)."""
    size = elem_type.type_byte_length()
    code = _ARRAY_CODES.get(size)
    if code is not None and sys.byteorder == "little":
        buf = bytearray(array(code, items).tobytes())
    else:
        buf = bytearray(b"".join(v.encode_bytes() for v in items))
    if len(buf) % BYTES_PER_CHUNK:
        buf += b"\x00" * (BYTES_PER_CHUNK - len(buf) % BYTES_PER_CHUNK)
    return buf


def _container_flat_plan(cls) -> Optional[list]:
    """For fixed-size containers whose fields are all immutable scalars
    (uintN / boolean / ByteVector<=64), the per-field root recipe enabling
    batched whole-sequence leaf computation (the Validator case — the hot
    leaf type of the registry). Entries are (name, kind, nbytes). None when
    the container has mutable or large fields (falls back to per-item roots)."""
    plan = cls.__dict__.get("_flat_plan", False)
    if plan is not False:
        return plan
    plan = []
    for name, t in cls._fields.items():
        if issubclass(t, uint):
            plan.append((name, "uint", t.byte_len))
        elif issubclass(t, ByteVector):
            if t.length <= 32:
                plan.append((name, "bytes", t.length))
            elif t.length <= 64:
                plan.append((name, "hash2", t.length))
            else:
                plan = None
                break
        else:
            plan = None
            break
    cls._flat_plan = plan
    return plan


def _batched_container_roots(items, plan) -> bytes:
    """Roots of N same-type flat containers, column-at-a-time: each field's
    values are gathered once (numpy scatter into the (N, F'·32) chunk
    matrix), >32-byte fields get ONE batched hash over all items, then one
    hash_many per tree level reduces every item's root simultaneously
    (field counts pad to the same power of two, so a flat level-reduce
    never mixes chunks across items)."""
    import numpy as np
    from operator import attrgetter

    n = len(items)
    fp = next_pow2(len(plan))
    buf = np.zeros((n, fp * 32), dtype=np.uint8)
    for j, (name, kind, nbytes) in enumerate(plan):
        get = attrgetter(name)
        col = buf[:, 32 * j : 32 * j + 32]
        if kind == "uint" and nbytes in (1, 2, 4, 8):
            arr = np.fromiter(map(get, items), dtype=f"<u{nbytes}", count=n)
            col[:, :nbytes] = arr.view(np.uint8).reshape(n, nbytes)
        elif kind == "uint":
            raw = b"".join(v.encode_bytes() for v in map(get, items))
            col[:, :nbytes] = np.frombuffer(raw, dtype=np.uint8).reshape(n, nbytes)
        elif kind == "bytes":
            raw = b"".join(map(get, items))
            col[:, :nbytes] = np.frombuffer(raw, dtype=np.uint8).reshape(n, nbytes)
        else:  # hash2: two chunks -> one batched hash per field
            raw = b"".join(map(get, items))
            padded = np.zeros((n, 64), dtype=np.uint8)
            padded[:, :nbytes] = np.frombuffer(raw, dtype=np.uint8).reshape(n, nbytes)
            digests = hashing.hash_many(padded.tobytes())
            col[:] = np.frombuffer(digests, dtype=np.uint8).reshape(n, 32)
    return hashing.item_roots(buf.tobytes(), fp)


class _SequenceBase(_Cached, SSZType):
    element_type: type = None  # type: ignore

    def __init__(self, *args):
        if len(args) == 1 and isinstance(args[0], (list, tuple)) and not isinstance(args[0], (bytes,)):
            raw = list(args[0])
        elif len(args) == 1 and isinstance(args[0], _SequenceBase):
            raw = list(args[0])
        else:
            raw = list(args)
        self._items = [_adopt(self.element_type.coerce(v)) for v in raw]
        self._check_len(len(self._items))
        self._tree: Optional[ChunkTree] = None
        self._dirty: set = set()

    def _check_len(self, n: int) -> None:
        raise NotImplementedError

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __setitem__(self, i, v):
        if isinstance(i, slice):
            raise TypeError("slice assignment not supported on SSZ sequences")
        n = len(self._items)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(f"{type(self).__name__}: index {i} out of range")
        val = _adopt(self.element_type.coerce(v))
        self._items[i] = val
        self._link_child(val, i)
        self._mark_item_dirty(i)

    def _receive_dirty(self, slot) -> bool:
        self._dirty.add(slot)
        if self._ht_cache is None:
            return False
        self._set_cache(None)
        return True

    def _mark_item_dirty(self, i: int) -> None:
        self._dirty.add(i)
        self._mark_self_dirty()

    # -- incremental Merkleization (ChunkTree backing) -----------------------

    def _bound(self) -> int:
        raise NotImplementedError

    def _build_leaves(self) -> bytearray:
        items = self._items
        et = self.element_type
        if _is_basic(et):
            return _pack_basic_items(items, et)
        plan = _container_flat_plan(et) if issubclass(et, Container) else None
        # bulk-link: one shared weakref + direct __dict__ writes (the
        # per-item _link_child call costs more than the leaf hash at scale)
        ref = weakref.ref(self)
        if plan and len(items) >= 64:
            packed = _batched_container_roots(items, plan)
            for i, it in enumerate(items):
                d = it.__dict__
                ps = d.get("_parents")
                if ps is None:
                    d["_parents"] = [(ref, i)]
                else:
                    ps.append((ref, i))
                # plan admits only immutable fields, so caching the batched
                # root needs no child links inside the item
                d["_ht_cache"] = packed[32 * i : 32 * i + 32]
            return bytearray(packed)
        leaves = bytearray()
        for i, it in enumerate(items):
            self._link_child(it, i)
            leaves += it.hash_tree_root()
        return leaves

    def _pack_chunk(self, ci: int) -> bytes:
        """Re-pack the 32-byte chunk `ci` from current basic items."""
        et = self.element_type
        per = BYTES_PER_CHUNK // et.type_byte_length()
        start = ci * per
        end = min(len(self._items), start + per)
        b = b"".join(self._items[j].encode_bytes() for j in range(start, end))
        return b.ljust(BYTES_PER_CHUNK, b"\x00")

    def _sync_tree(self) -> ChunkTree:
        items = self._items
        et = self.element_type
        basic = _is_basic(et)
        if self._tree is None:
            self._tree = ChunkTree(self._build_leaves(), self._chunk_limit(self._bound()))
            self._dirty.clear()
            return self._tree
        tree = self._tree
        if basic:
            per = BYTES_PER_CHUNK // et.type_byte_length()
            need = (len(items) + per - 1) // per
        else:
            need = len(items)
        if tree.count > need:
            tree.truncate(need)
        if self._dirty:
            if basic:
                for ci in sorted({i // per for i in self._dirty}):
                    if ci < need:
                        tree.set_leaf(ci, self._pack_chunk(ci))
            else:
                for i in sorted(self._dirty):
                    if i < need:
                        it = items[i]
                        self._link_child(it, i)
                        tree.set_leaf(i, it.hash_tree_root())
            self._dirty.clear()
        return tree

    def copy(self):
        cls = type(self)
        new = cls.__new__(cls)
        new._items = [v.copy() for v in self._items]
        for i, v in enumerate(new._items):
            if isinstance(v, _Cached):
                object.__setattr__(v, "_owned", True)
            new._link_child(v, i)
        new._tree = self._tree.copy() if self._tree is not None else None
        new._dirty = set(self._dirty)
        new._set_cache(self._ht_cache)
        return new

    def index(self, v):
        return self._items.index(v)

    def count(self, v):
        return self._items.count(v)

    def __contains__(self, v):
        return v in self._items

    def _type_key(self):
        # (kind, bound, element-type name): what must match for two
        # parameterized classes from different spec modules to be "the same
        # type" — keeps __eq__ consistent with __hash__ (which hashes the
        # limit-padded tree root).
        bound = self.length if isinstance(self, Vector) else self.limit
        return (isinstance(self, Vector), int(bound), self.element_type.__name__)

    def __eq__(self, other):
        if isinstance(other, _SequenceBase):
            if self._type_key() != other._type_key():
                return NotImplemented
            return self._items == other._items
        if isinstance(other, (list, tuple)):
            return self._items == list(other)
        return NotImplemented

    def __hash__(self):
        return hash((type(self).__name__, self.hash_tree_root()))

    def __repr__(self):
        return f"{type(self).__name__}({self._items!r})"

    @classmethod
    def _chunk_limit(cls, bound: int) -> int:
        if _is_basic(cls.element_type):
            return (bound * cls.element_type.type_byte_length() + 31) // 32
        return bound


class Vector(_SequenceBase):
    length: int = 0

    def __class_getitem__(cls, params: Tuple[type, int]) -> type:
        elem, length = params
        return _parameterize(
            Vector, (elem, length), f"Vector[{elem.__name__}, {length}]",
            {"element_type": elem, "length": length},
        )

    def __init__(self, *args):
        if len(args) == 0:
            args = ([self.element_type.default() for _ in range(self.length)],)
        super().__init__(*args)

    def _check_len(self, n: int) -> None:
        if n != self.length:
            raise ValueError(f"{type(self).__name__}: expected {self.length} elements, got {n}")

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return cls.element_type.is_fixed_byte_length()

    @classmethod
    def type_byte_length(cls) -> int:
        return cls.element_type.type_byte_length() * cls.length

    @classmethod
    def decode_bytes(cls, data: bytes):
        if cls.element_type.is_fixed_byte_length():
            el = cls.element_type.type_byte_length()
            if len(data) != el * cls.length:
                raise ValueError(f"{cls.__name__}: bad byte length {len(data)}")
            return cls([cls.element_type.decode_bytes(data[i * el : (i + 1) * el]) for i in range(cls.length)])
        return cls(_decode_parts(data, [cls.element_type] * cls.length))

    @classmethod
    def default(cls):
        return cls()

    def encode_bytes(self) -> bytes:
        if self.element_type.is_fixed_byte_length():
            return b"".join(v.encode_bytes() for v in self._items)
        return _serialize_parts(self._items)

    def _bound(self) -> int:
        return self.length

    def hash_tree_root(self) -> bytes:
        c = self._ht_cache
        if c is None:
            c = self._sync_tree().root()
            self._set_cache(c)
        return c


class List(_SequenceBase):
    limit: int = 0

    def __class_getitem__(cls, params: Tuple[type, int]) -> type:
        elem, limit = params
        return _parameterize(
            List, (elem, limit), f"List[{elem.__name__}, {limit}]",
            {"element_type": elem, "limit": limit},
        )

    def _check_len(self, n: int) -> None:
        if n > self.limit:
            raise ValueError(f"{type(self).__name__}: {n} elements exceeds limit {self.limit}")

    def append(self, v):
        if len(self._items) + 1 > self.limit:
            raise ValueError(f"{type(self).__name__}: append exceeds limit {self.limit}")
        val = _adopt(self.element_type.coerce(v))
        self._items.append(val)
        n = len(self._items) - 1
        self._link_child(val, n)
        self._mark_item_dirty(n)

    def pop(self):
        v = self._items.pop()
        # mark the vacated index: a shared trailing chunk gets re-packed at
        # sync time; fully-removed leaves are handled by ChunkTree.truncate
        self._mark_item_dirty(len(self._items))
        return v

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return False

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) == 0:
            return cls([])
        if cls.element_type.is_fixed_byte_length():
            el = cls.element_type.type_byte_length()
            if len(data) % el:
                raise ValueError(f"{cls.__name__}: byte length {len(data)} not multiple of {el}")
            n = len(data) // el
            if n > cls.limit:
                raise ValueError(f"{cls.__name__}: {n} elements exceeds limit {cls.limit}")
            return cls([cls.element_type.decode_bytes(data[i * el : (i + 1) * el]) for i in range(n)])
        # variable-size elements: element count = first_offset / 4
        first = int.from_bytes(data[:OFFSET_BYTE_LENGTH], "little")
        if first % OFFSET_BYTE_LENGTH:
            raise ValueError(f"{cls.__name__}: misaligned first offset")
        n = first // OFFSET_BYTE_LENGTH
        if n > cls.limit:
            raise ValueError(f"{cls.__name__}: {n} elements exceeds limit {cls.limit}")
        return cls(_decode_parts(data, [cls.element_type] * n))

    @classmethod
    def default(cls):
        return cls([])

    def encode_bytes(self) -> bytes:
        if self.element_type.is_fixed_byte_length():
            return b"".join(v.encode_bytes() for v in self._items)
        return _serialize_parts(self._items)

    def _bound(self) -> int:
        return self.limit

    def hash_tree_root(self) -> bytes:
        c = self._ht_cache
        if c is None:
            c = mix_in_length(self._sync_tree().root(), len(self._items))
            self._set_cache(c)
        return c


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------


class Container(_Cached, SSZType):
    _fields: Dict[str, type] = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields: Dict[str, type] = {}
        for klass in reversed(cls.__mro__):
            anns = klass.__dict__.get("__annotations__", {})
            for name, typ in anns.items():
                if isinstance(typ, type):
                    fields[name] = typ
        cls._fields = fields

    def __init__(self, **kwargs):
        for name, typ in self._fields.items():
            if name in kwargs:
                object.__setattr__(self, name, _adopt(typ.coerce(kwargs.pop(name))))
            else:
                # fresh defaults must pass the same ownership barrier as
                # provided values: an unowned child assigned into a second
                # parent would alias instead of snapshotting (_adopt on a
                # brand-new object is a marking, not a copy)
                object.__setattr__(self, name, _adopt(typ.default()))
        if kwargs:
            raise TypeError(f"{type(self).__name__}: unknown fields {sorted(kwargs)}")

    @classmethod
    def fields(cls) -> Dict[str, type]:
        return cls._fields

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        typ = self._fields.get(name)
        if typ is None:
            raise AttributeError(f"{type(self).__name__} has no SSZ field {name!r}")
        v = _adopt(typ.coerce(value))
        object.__setattr__(self, name, v)
        self._link_child(v, name)
        self._mark_self_dirty()

    @classmethod
    def coerce(cls, value):
        if isinstance(value, cls):
            return value
        if isinstance(value, Container):
            # Cross-class coercion (e.g. the same container type from another
            # (fork, preset) spec module, or a fork upgrade reusing unchanged
            # sub-containers): copy field-wise, coercing recursively.
            if set(cls._fields) != set(value._fields):
                raise TypeError(
                    f"cannot coerce {type(value).__name__} to {cls.__name__}: field mismatch"
                )
            return cls(**{n: getattr(value, n) for n in cls._fields})
        if isinstance(value, dict):
            return cls(**value)
        return cls(value)

    def __eq__(self, other):
        # Same field names + equal field values; class *identity* is not
        # required so values from differently-built spec modules compare equal.
        if not isinstance(other, Container):
            return NotImplemented
        if type(self) is not type(other):
            if type(self).__name__ != type(other).__name__ or set(self._fields) != set(other._fields):
                return NotImplemented
        return all(getattr(self, n) == getattr(other, n) for n in self._fields)

    def __hash__(self):
        return hash((type(self).__name__, self.hash_tree_root()))

    def __repr__(self):
        inner = ", ".join(f"{n}={getattr(self, n)!r}" for n in self._fields)
        return f"{type(self).__name__}({inner})"

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return all(t.is_fixed_byte_length() for t in cls._fields.values())

    @classmethod
    def type_byte_length(cls) -> int:
        return sum(t.type_byte_length() for t in cls._fields.values())

    @classmethod
    def decode_bytes(cls, data: bytes):
        values = _decode_parts(data, list(cls._fields.values()))
        return cls(**dict(zip(cls._fields.keys(), values)))

    @classmethod
    def default(cls):
        return cls()

    def encode_bytes(self) -> bytes:
        return _serialize_parts([getattr(self, n) for n in self._fields])

    def hash_tree_root(self) -> bytes:
        c = self._ht_cache
        if c is not None:
            return c
        roots = []
        for n in self._fields:
            v = getattr(self, n)
            self._link_child(v, n)  # links established here keep the cache honest
            roots.append(v.hash_tree_root())
        c = merkleize_chunks(b"".join(roots))
        self._set_cache(c)
        return c

    def copy(self):
        cls = type(self)
        new = cls.__new__(cls)
        for n in self._fields:
            cv = getattr(self, n).copy()
            if isinstance(cv, _Cached):
                object.__setattr__(cv, "_owned", True)
            object.__setattr__(new, n, cv)
            new._link_child(cv, n)
        new._set_cache(self._ht_cache)
        return new


# ---------------------------------------------------------------------------
# Union
# ---------------------------------------------------------------------------


class Union(_Cached, SSZType):
    options: Tuple[Optional[type], ...] = ()

    def __class_getitem__(cls, params) -> type:
        if not isinstance(params, tuple):
            params = (params,)
        names = ", ".join("None" if p is None else p.__name__ for p in params)
        return _parameterize(Union, params, f"Union[{names}]", {"options": params})

    def __init__(self, selector: int, value: Any = None):
        self.change(selector, value)

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name in ("value", "selector"):
            if name == "value":
                self._link_child(value, 0)
            self._mark_self_dirty()

    def change(self, selector: int, value: Any = None) -> None:
        """Re-point the union in place (remerkleable's `.change` API the
        sharding spec mutates ShardWork.status with,
        specs/sharding/beacon-chain.md:659-671)."""
        if not (0 <= selector < len(self.options)):
            raise ValueError(f"{type(self).__name__}: bad selector {selector}")
        opt = self.options[selector]
        if opt is None:
            if value is not None:
                raise ValueError("Union: selector 0 (None) takes no value")
            self.value = None
        else:
            self.value = _adopt(opt.coerce(value))
        self.selector = selector

    @classmethod
    def is_fixed_byte_length(cls) -> bool:
        return False

    @classmethod
    def decode_bytes(cls, data: bytes):
        if len(data) == 0:
            raise ValueError("Union: empty data")
        selector = data[0]
        if selector >= len(cls.options):
            raise ValueError(f"Union: bad selector {selector}")
        opt = cls.options[selector]
        if opt is None:
            if len(data) != 1:
                raise ValueError("Union: trailing bytes after None selector")
            return cls(0, None)
        return cls(selector, opt.decode_bytes(data[1:]))

    @classmethod
    def default(cls):
        return cls(0, None if cls.options[0] is None else cls.options[0].default())

    def encode_bytes(self) -> bytes:
        body = b"" if self.value is None else self.value.encode_bytes()
        return bytes([self.selector]) + body

    def hash_tree_root(self) -> bytes:
        c = self._ht_cache
        if c is None:
            root = b"\x00" * 32 if self.value is None else self.value.hash_tree_root()
            c = mix_in_selector(root, self.selector)
            self._set_cache(c)
        return c

    def __eq__(self, other):
        if not isinstance(other, Union):
            return NotImplemented
        return type(self) is type(other) and self.selector == other.selector and self.value == other.value

    def __hash__(self):
        return hash((type(self).__name__, self.selector, self.hash_tree_root()))

    def __repr__(self):
        return f"{type(self).__name__}(selector={self.selector}, value={self.value!r})"


# ---------------------------------------------------------------------------
# Generalized indices (ssz/merkle-proofs.md:58-189)
# ---------------------------------------------------------------------------


def get_generalized_index(typ: type, *path) -> int:
    """Navigate `path` (field names / indices / '__len__') from `typ`'s root."""
    root = 1
    for p in path:
        if p == "__len__":
            if not (issubclass(typ, (List, Bitlist, ByteList))):
                raise TypeError(f"__len__ only valid on lists, not {typ}")
            root = root * 2 + 1
            typ = uint64
            continue
        if issubclass(typ, Container):
            fields = list(typ.fields().items())
            names = [n for n, _ in fields]
            idx = names.index(p)
            base = next_pow2(len(fields))
            root = root * base + idx
            typ = fields[idx][1]
        elif issubclass(typ, (List, Bitlist, ByteList)):
            root *= 2  # mix_in_length: data subtree is the left child
            if issubclass(typ, List):
                limit = typ._chunk_limit(typ.limit)
                elem = typ.element_type
            elif issubclass(typ, Bitlist):
                limit = (typ.limit + 255) // 256
                elem = None
            else:
                limit = (typ.limit + 31) // 32
                elem = None
            base = next_pow2(limit)
            if elem is not None and not _is_basic(elem):
                root = root * base + int(p)
                typ = elem
            else:
                per_chunk = 32 // elem.type_byte_length() if elem is not None else 256 if issubclass(typ, Bitlist) else 32
                root = root * base + int(p) // per_chunk
                typ = Bytes32
        elif issubclass(typ, (Vector, Bitvector, ByteVector)):
            if issubclass(typ, Vector):
                limit = typ._chunk_limit(typ.length)
                elem = typ.element_type
            elif issubclass(typ, Bitvector):
                limit = (typ.length + 255) // 256
                elem = None
            else:
                limit = (typ.length + 31) // 32
                elem = None
            base = next_pow2(limit)
            if elem is not None and not _is_basic(elem):
                root = root * base + int(p)
                typ = elem
            else:
                per_chunk = 32 // elem.type_byte_length() if elem is not None else 256 if issubclass(typ, Bitvector) else 32
                root = root * base + int(p) // per_chunk
                typ = Bytes32
        else:
            raise TypeError(f"cannot navigate into {typ}")
    return root


def get_generalized_index_length(index: int) -> int:
    """Depth of a generalized index (merkle-proofs.md:46)."""
    return index.bit_length() - 1
