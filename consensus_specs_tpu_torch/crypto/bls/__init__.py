"""BLS facade with switchable backends (ref: eth2spec/utils/bls.py:6-44).

Backends:
  - "reference": the pure-Python host implementation of this package —
    the correctness oracle, like the reference's py_ecc default;
  - "torch": the batched backend on the card (``ops/bls_torch``), selected
    by ``use_backend("torch", device=None)``: the CUDA card, raising
    without one, unless ``device="cpu"`` asks for the kernels' plain
    versions.

`bls_active` kill-switch + `only_with_bls` decorator mirror the
reference's test-speed escape hatch (utils/bls.py:33-44): signature checks
are skipped wholesale when off.

Deferred verification: the boolean Verify family runs in three modes —
  - normal: a synchronous backend call;
  - deferring: the check is RECORDED and answered optimistically (True),
    so a whole workload's checks flush later as batched device calls
    (DeferredVerifier.flush);
  - replaying: checks are answered from a flushed truth table, so a
    consumer that must re-run an item whose optimistic answer was wrong
    replays it with the true answers at no crypto cost.

There is no fallback: the reference backend's exceptions on malformed
points are the spec's invalid-input surface and read as False; any
failure of the torch backend raises.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

from . import ciphersuite as _reference

G2_POINT_AT_INFINITY = _reference.G2_POINT_AT_INFINITY

bls_active = True
_backend = _reference
_backend_name = "reference"


def use_backend(name: str, device=None) -> str:
    """Select the BLS backend; ``device`` is the torch backend's (None:
    the CUDA card, raising without one). Returns the backend's name."""
    global _backend, _backend_name
    if name == "reference":
        _backend = _reference
    elif name == "torch":
        from ...ops import bls_torch

        bls_torch.use_device(device)
        _backend = bls_torch
    else:
        raise ValueError(f"unknown BLS backend {name!r}")
    _backend_name = name
    return _backend_name


def use_reference() -> None:
    use_backend("reference")


def backend_name() -> str:
    return _backend_name


def _verify_dispatch(op: str, *args) -> bool:
    """A Verify-family call on the active backend. The reference oracle
    raises on malformed points, which the spec reads as invalid."""
    if _backend is _reference:
        try:
            return bool(getattr(_reference, op)(*args))
        except Exception:
            return False
    return bool(getattr(_backend, op)(*args))


_defer: Optional["DeferredVerifier"] = None
_replay: Optional[Dict[tuple, bool]] = None


class DeferredVerifier:
    """Records Verify-family checks while installed (see `deferring`),
    then resolves them all in `flush()` — through the active backend's
    batch pipelines when it has them, one call per check otherwise. After
    flush, `table()` maps each recorded check key to its true result for
    use with `replaying`."""

    def __init__(self) -> None:
        self.entries: List[tuple] = []
        self.results: List[bool] = []  # grows at flush; aligned with entries

    def record(self, key: tuple) -> bool:
        self.entries.append(key)
        return True

    def mark(self) -> int:
        """Current queue position — bracket a workload item with two marks
        to later ask `all_true(m0, m1)`."""
        return len(self.entries)

    def all_true(self, start: int, end: int) -> bool:
        assert end <= len(self.results), "flush() the queue first"
        return all(self.results[start:end])

    def table(self) -> Dict[tuple, bool]:
        return dict(zip(self.entries, self.results))

    def flush(self) -> None:
        """Resolve every pending check. Duplicate keys resolve once, and a
        key an earlier flush of this verifier resolved is not sent again; the
        Verify/FastAggregateVerify rows are planned into shape buckets
        (sched.bucketing, with the backend's floors) and each bucket goes
        through the backend's cold pipeline; the AggregateVerify rows go
        through its batched AggregateVerify in one call."""
        todo = self.entries[len(self.results):]
        if not todo:
            return
        known = self.table()  # keys resolved by an earlier flush
        unique: Dict[tuple, Optional[bool]] = {k: known.get(k) for k in todo}
        batch_rows = []  # (key, pubkey_list, message, signature)
        av_rows = []
        for key in (k for k, v in unique.items() if v is None):
            if key[0] == "v":
                _, pk, msg, sig = key
                batch_rows.append((key, [pk], msg, sig))
            elif key[0] == "fav":
                _, pks, msg, sig = key
                batch_rows.append((key, list(pks), msg, sig))
            else:
                av_rows.append(key)

        cold = getattr(_backend, "fast_aggregate_verify_batch_cold", None)
        if batch_rows and cold is not None:
            self._flush_bucketed(cold, batch_rows, unique)
        else:
            for key, pks, msg, sig in batch_rows:
                unique[key] = _verify_dispatch("FastAggregateVerify", pks, msg, sig)
        av_batch = getattr(_backend, "aggregate_verify_batch", None)
        if av_rows and av_batch is not None:
            ok = av_batch([list(k[1]) for k in av_rows], [list(k[2]) for k in av_rows], [k[3] for k in av_rows])
            for key, o in zip(av_rows, ok):
                unique[key] = bool(o)
        else:
            for key in av_rows:
                unique[key] = _verify_dispatch("AggregateVerify", list(key[1]), list(key[2]), key[3])

        out = [unique[key] for key in todo]
        assert all(o is not None for o in out)
        self.results.extend(out)  # type: ignore[arg-type]

    @staticmethod
    def _flush_bucketed(cold, batch_rows, unique) -> None:
        from ...sched import plan_flush

        max_rows, min_keys = _backend.cold_shape_floors()
        for call in plan_flush([len(r[1]) for r in batch_rows], max_rows=max_rows, min_keys=min_keys):
            sub = [batch_rows[i] for i in call]
            ok = cold([r[1] for r in sub], [r[2] for r in sub], [r[3] for r in sub])
            for (key, _, _, _), o in zip(sub, ok):
                unique[key] = bool(o)


@contextlib.contextmanager
def deferring(verifier: DeferredVerifier):
    """Install `verifier`: Verify-family calls record + return True."""
    global _defer
    prev, _defer = _defer, verifier
    try:
        yield verifier
    finally:
        _defer = prev


@contextlib.contextmanager
def replaying(table: Dict[tuple, bool]):
    """Answer Verify-family calls from a flushed truth table; checks not in
    the table (control flow diverged from the deferred run) fall through
    to the synchronous backend."""
    global _replay
    prev, _replay = _replay, table
    try:
        yield
    finally:
        _replay = prev


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


def _check(key: tuple, op: str, *args) -> bool:
    if _defer is not None:
        return _defer.record(key)
    if _replay is not None and key in _replay:
        return _replay[key]
    return _verify_dispatch(op, *args)


@only_with_bls(alt_return=True)
def Verify(pubkey: bytes, message: bytes, signature: bytes) -> bool:
    key = ("v", bytes(pubkey), bytes(message), bytes(signature))
    return _check(key, "Verify", pubkey, message, signature)


@only_with_bls(alt_return=True)
def AggregateVerify(pubkeys: Sequence[bytes], messages: Sequence[bytes], signature: bytes) -> bool:
    key = ("av", tuple(bytes(p) for p in pubkeys), tuple(bytes(m) for m in messages), bytes(signature))
    return _check(key, "AggregateVerify", pubkeys, messages, signature)


@only_with_bls(alt_return=True)
def FastAggregateVerify(pubkeys: Sequence[bytes], message: bytes, signature: bytes) -> bool:
    key = ("fav", tuple(bytes(p) for p in pubkeys), bytes(message), bytes(signature))
    return _check(key, "FastAggregateVerify", pubkeys, message, signature)


@only_with_bls(alt_return=G2_POINT_AT_INFINITY)
def Aggregate(signatures: Sequence[bytes]) -> bytes:
    return _backend.Aggregate(signatures)


@only_with_bls(alt_return=b"\x00" * 96)
def Sign(privkey, message: bytes) -> bytes:
    return _backend.Sign(privkey, message)


def AggregatePKs(pubkeys: Sequence[bytes]) -> bytes:
    return _backend.AggregatePKs(pubkeys)


def SkToPk(privkey) -> bytes:
    return _backend.SkToPk(privkey)


def KeyValidate(pubkey: bytes) -> bool:
    return _backend.KeyValidate(pubkey)


def signature_to_G2(signature: bytes):
    return _reference.signature_to_G2(signature)
