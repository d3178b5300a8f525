"""SSZ value → jsonable/yamlable structure (ref: eth2spec/debug/encode.py)."""
from __future__ import annotations

from consensus_specs_tpu_torch.ssz.types import (
    ByteList,
    ByteVector,
    Container,
    Union,
    boolean,
    uint,
    _BitsBase,
    _SequenceBase,
)


def encode(value):
    if isinstance(value, boolean):
        return bool(value)
    if isinstance(value, uint):
        # wider-than-64-bit uints go to strings (yaml precision), matching
        # the reference vector format (debug/encode.py: > 8 byte length)
        return int(value) if value.type_byte_length() <= 8 else str(int(value))
    if isinstance(value, (ByteVector, ByteList)):
        return "0x" + bytes(value).hex()
    if isinstance(value, _BitsBase):
        return "0x" + value.encode_bytes().hex()
    if isinstance(value, _SequenceBase):
        return [encode(element) for element in value]
    if isinstance(value, Container):
        return {name: encode(getattr(value, name)) for name in value.fields()}
    if isinstance(value, Union):
        return {"selector": int(value.selector), "value": None if value.value is None else encode(value.value)}
    if isinstance(value, (bytes, bytearray)):
        return "0x" + bytes(value).hex()
    raise TypeError(f"can't encode {value!r} of type {type(value)}")
