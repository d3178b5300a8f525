"""jsonable structure → SSZ value (ref: eth2spec/debug/decode.py)."""
from __future__ import annotations

from consensus_specs_tpu_torch.ssz.types import (
    ByteList,
    ByteVector,
    Container,
    Union,
    _BitsBase,
    _SequenceBase,
    boolean,
    uint,
)


def decode(data, typ):
    if issubclass(typ, boolean):
        return typ(data)
    if issubclass(typ, uint):
        return typ(int(data))
    if issubclass(typ, (ByteVector, ByteList)):
        return typ(bytes.fromhex(data[2:] if isinstance(data, str) and data.startswith("0x") else data))
    if issubclass(typ, _BitsBase):
        raw = bytes.fromhex(data[2:]) if isinstance(data, str) else bytes(data)
        return typ.decode_bytes(raw)
    if issubclass(typ, _SequenceBase):
        return typ([decode(element, typ.element_type) for element in data])
    if issubclass(typ, Container):
        return typ(**{
            name: decode(data[name], field_typ)
            for name, field_typ in typ.fields().items()
        })
    if issubclass(typ, Union):
        selector = int(data["selector"])
        opt = typ.options[selector]
        value = None if opt is None else decode(data["value"], opt)
        return typ(selector, value)
    raise TypeError(f"can't decode into {typ}")
