"""Seeded random SSZ object generation with modes + chaos — drives the
ssz_static fuzz vectors (ref: eth2spec/debug/random_value.py)."""
from __future__ import annotations

from enum import Enum
from random import Random

from consensus_specs_tpu_torch.ssz.types import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    List,
    Union,
    Vector,
    boolean,
    uint,
)

# in case the RNG returns a heavy list length, cap it (same spirit as
# random_value.py:12)
MAX_LIST_LENGTH = 10


class RandomizationMode(Enum):
    mode_random = 0
    mode_zero = 1
    mode_max = 2
    mode_nil_count = 3
    mode_one_count = 4
    mode_max_count = 5

    def to_name(self) -> str:
        return {
            RandomizationMode.mode_random: "random",
            RandomizationMode.mode_zero: "zero",
            RandomizationMode.mode_max: "max",
            RandomizationMode.mode_nil_count: "nil",
            RandomizationMode.mode_one_count: "one",
            RandomizationMode.mode_max_count: "max_count",
        }[self]

    def is_changing(self) -> bool:
        return self.value in (0, 4, 5)


def get_random_ssz_object(rng: Random, typ, max_bytes_length: int, max_list_length: int,
                          mode: RandomizationMode, chaos: bool):
    """Random value of the given SSZ type (ref random_value.py:38-160).
    With ``chaos`` the mode itself is randomized per element."""
    if chaos:
        mode = rng.choice(list(RandomizationMode))

    if issubclass(typ, ByteList):
        if mode == RandomizationMode.mode_nil_count:
            length = 0
        elif mode == RandomizationMode.mode_max_count:
            length = min(typ.limit, max_bytes_length)
        elif mode == RandomizationMode.mode_one_count:
            length = 1
        elif mode == RandomizationMode.mode_zero:
            length = 0
        else:
            length = rng.randint(0, min(typ.limit, max_bytes_length))
        return typ(get_random_bytes_list(rng, length))

    if issubclass(typ, ByteVector):
        if mode == RandomizationMode.mode_zero:
            return typ(b"\x00" * typ.length)
        if mode == RandomizationMode.mode_max:
            return typ(b"\xff" * typ.length)
        return typ(get_random_bytes_list(rng, typ.length))

    if issubclass(typ, boolean):
        if mode == RandomizationMode.mode_zero:
            return typ(False)
        if mode == RandomizationMode.mode_max:
            return typ(True)
        return typ(rng.choice((True, False)))

    if issubclass(typ, uint):
        if mode == RandomizationMode.mode_zero:
            return typ(0)
        if mode == RandomizationMode.mode_max:
            return typ(2 ** (typ.byte_len * 8) - 1)
        return typ(rng.randint(0, 2 ** (typ.byte_len * 8) - 1))

    if issubclass(typ, Bitvector):
        if mode == RandomizationMode.mode_zero:
            return typ([False] * typ.length)
        if mode == RandomizationMode.mode_max:
            return typ([True] * typ.length)
        return typ([rng.choice((True, False)) for _ in range(typ.length)])

    if issubclass(typ, Bitlist):
        if mode == RandomizationMode.mode_nil_count or mode == RandomizationMode.mode_zero:
            length = 0
        elif mode == RandomizationMode.mode_one_count:
            length = min(1, typ.limit)
        elif mode == RandomizationMode.mode_max_count:
            length = min(typ.limit, max_list_length)
        else:
            length = rng.randint(0, min(typ.limit, max_list_length))
        return typ([rng.choice((True, False)) for _ in range(length)])

    if issubclass(typ, Vector):
        return typ([
            get_random_ssz_object(rng, typ.element_type, max_bytes_length, max_list_length, mode, chaos)
            for _ in range(typ.length)
        ])

    if issubclass(typ, List):
        if mode == RandomizationMode.mode_nil_count or mode == RandomizationMode.mode_zero:
            length = 0
        elif mode == RandomizationMode.mode_one_count:
            length = min(1, typ.limit)
        elif mode == RandomizationMode.mode_max_count:
            length = min(typ.limit, max_list_length)
        else:
            length = rng.randint(0, min(typ.limit, max_list_length))
        return typ([
            get_random_ssz_object(rng, typ.element_type, max_bytes_length, max_list_length, mode, chaos)
            for _ in range(length)
        ])

    if issubclass(typ, Container):
        return typ(**{
            name: get_random_ssz_object(rng, field_typ, max_bytes_length, max_list_length, mode, chaos)
            for name, field_typ in typ.fields().items()
        })

    if issubclass(typ, Union):
        selector = rng.randrange(len(typ.options)) if mode == RandomizationMode.mode_random else 0
        opt = typ.options[selector]
        value = None if opt is None else get_random_ssz_object(
            rng, opt, max_bytes_length, max_list_length, mode, chaos
        )
        return typ(selector, value)

    raise TypeError(f"can't generate random value for {typ}")


def get_random_bytes_list(rng: Random, length: int) -> bytes:
    return bytes(rng.getrandbits(8) for _ in range(length))
