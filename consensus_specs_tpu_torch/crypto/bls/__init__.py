"""BLS facade (ref: eth2spec/utils/bls.py:6-44), on the pure-Python host
implementation in this package — the correctness oracle, like the
reference's py_ecc default. A device BLS backend comes with a later slice.

`bls_active` kill-switch + `only_with_bls` decorator mirror the
reference's test-speed escape hatch (utils/bls.py:33-44): signature
checks are skipped wholesale when off.
"""
from __future__ import annotations

from typing import Sequence

from . import ciphersuite as _reference

G2_POINT_AT_INFINITY = _reference.G2_POINT_AT_INFINITY

bls_active = True


def only_with_bls(alt_return=None):
    """Decorator: skip the wrapped check (returning `alt_return`) when
    bls_active is False (utils/bls.py:37-44)."""

    def decorator(fn):
        def wrapper(*args, **kwargs):
            if not bls_active:
                return alt_return
            return fn(*args, **kwargs)

        wrapper.__name__ = fn.__name__
        return wrapper

    return decorator


@only_with_bls(alt_return=True)
def Verify(pubkey: bytes, message: bytes, signature: bytes) -> bool:
    # the oracle raises on malformed points: the spec reads that as invalid
    try:
        return _reference.Verify(pubkey, message, signature)
    except Exception:
        return False


@only_with_bls(alt_return=True)
def FastAggregateVerify(pubkeys: Sequence[bytes], message: bytes, signature: bytes) -> bool:
    try:
        return _reference.FastAggregateVerify(pubkeys, message, signature)
    except Exception:
        return False


@only_with_bls(alt_return=G2_POINT_AT_INFINITY)
def Aggregate(signatures: Sequence[bytes]) -> bytes:
    return _reference.Aggregate(signatures)


@only_with_bls(alt_return=b"\x00" * 96)
def Sign(privkey, message: bytes) -> bytes:
    return _reference.Sign(privkey, message)


def SkToPk(privkey) -> bytes:
    return _reference.SkToPk(privkey)
