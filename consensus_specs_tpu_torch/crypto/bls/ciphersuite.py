"""BLS signature scheme (IETF BLS draft v4 semantics, G2 signatures /
G1 pubkeys, proof-of-possession ciphersuite) — the primitive set the
reference gets from py_ecc / milagro (utils/bls.py:47-111).

All functions take/return the wire formats eth2 uses: 48-byte compressed
G1 pubkeys, 96-byte compressed G2 signatures, 32-byte big-endian secret
keys.
"""
from __future__ import annotations

from typing import Sequence

from .curve import (
    DeserializationError,
    Point,
    g1_from_bytes,
    g1_generator,
    g1_infinity,
    g1_to_bytes,
    g2_from_bytes,
    g2_infinity,
    g2_to_bytes,
)
from .fields import R
from .hash_to_curve import hash_to_g2
from .pairing import FQ12_ONE, miller_loop, final_exponentiation

G2_POINT_AT_INFINITY = b"\xc0" + b"\x00" * 95


class InvalidSignature(Exception):
    pass


def _sk_to_int(privkey) -> int:
    if isinstance(privkey, (bytes, bytearray)):
        sk = int.from_bytes(privkey, "big")
    else:
        sk = int(privkey)
    if not 0 < sk < R:
        raise ValueError("secret key out of range")
    return sk


def SkToPk(privkey) -> bytes:
    return g1_to_bytes(g1_generator().mul(_sk_to_int(privkey)))


def Sign(privkey, message: bytes) -> bytes:
    return g2_to_bytes(hash_to_g2(message).mul(_sk_to_int(privkey)))


def KeyValidate(pubkey: bytes) -> bool:
    try:
        pt = g1_from_bytes(pubkey)
    except DeserializationError:
        return False
    if pt.is_infinity:
        return False
    return pt.in_subgroup()


def _pubkey_point(pubkey: bytes) -> Point:
    pt = g1_from_bytes(pubkey)
    if pt.is_infinity or not pt.in_subgroup():
        raise InvalidSignature("invalid pubkey")
    return pt


def _signature_point(signature: bytes) -> Point:
    pt = g2_from_bytes(signature)
    if not pt.is_infinity and not pt.in_subgroup():
        raise InvalidSignature("signature not in subgroup")
    return pt


def _core_verify(pairs: Sequence) -> bool:
    """∏ e(P_i, Q_i) == 1, single shared final exponentiation."""
    f = FQ12_ONE
    for p, q in pairs:
        f = f * miller_loop(p, q)
    return final_exponentiation(f).is_one()


def Verify(pubkey: bytes, message: bytes, signature: bytes) -> bool:
    """e(PK, H(m)) == e(g1, sig) ⟺ e(-g1, sig) * e(PK, H(m)) == 1."""
    try:
        pk = _pubkey_point(pubkey)
        sig = _signature_point(signature)
    except (InvalidSignature, DeserializationError):
        return False
    return _core_verify([(g1_generator().neg(), sig), (pk, hash_to_g2(message))])


def Aggregate(signatures: Sequence[bytes]) -> bytes:
    if len(signatures) == 0:
        raise InvalidSignature("Aggregate requires at least one signature")
    acc = g2_infinity()
    for s in signatures:
        acc = acc.add(g2_from_bytes(s))
    return g2_to_bytes(acc)


def AggregatePKs(pubkeys: Sequence[bytes]) -> bytes:
    if len(pubkeys) == 0:
        raise InvalidSignature("AggregatePKs requires at least one pubkey")
    acc = g1_infinity()
    for p in pubkeys:
        pt = g1_from_bytes(p)
        if pt.is_infinity or not pt.in_subgroup():
            raise InvalidSignature("invalid pubkey in aggregate")
        acc = acc.add(pt)
    return g1_to_bytes(acc)


def AggregateVerify(pubkeys: Sequence[bytes], messages: Sequence[bytes], signature: bytes) -> bool:
    if len(pubkeys) == 0 or len(pubkeys) != len(messages):
        return False
    try:
        sig = _signature_point(signature)
        pairs = [(g1_generator().neg(), sig)]
        for pk, msg in zip(pubkeys, messages):
            pairs.append((_pubkey_point(pk), hash_to_g2(msg)))
    except (InvalidSignature, DeserializationError):
        return False
    return _core_verify(pairs)


def FastAggregateVerify(pubkeys: Sequence[bytes], message: bytes, signature: bytes) -> bool:
    """All signers signed the same message: aggregate pubkeys first —
    one pubkey point-add per signer, then a single 2-pairing check."""
    if len(pubkeys) == 0:
        return False
    try:
        sig = _signature_point(signature)
        acc = g1_infinity()
        for pk in pubkeys:
            acc = acc.add(_pubkey_point(pk))
    except (InvalidSignature, DeserializationError):
        return False
    return _core_verify([(g1_generator().neg(), sig), (acc, hash_to_g2(message))])


def signature_to_G2(signature: bytes) -> Point:
    """Raw decode (no subgroup check) — mirrors utils/bls.py:108-111."""
    return g2_from_bytes(signature)
